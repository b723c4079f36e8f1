"""Weights for the port: the bridge from the JAX package's flax variables, a
seeded random initialisation, and the "doctoring" that makes a random model's
streaming policy write.

The bridge takes the flax ``{"params", "batch_stats"}`` tree as NumPy arrays
(for example ``jax.tree.map(np.asarray, variables)``) and never imports jax.
The port's module and parameter names mirror the flax tree, so each leaf maps
by name, with these layout changes:

- Dense ``kernel [in, out]`` → ``weight [out, in]``;
- LayerNorm / BatchNorm ``scale`` → ``weight``; BatchNorm ``mean``/``var`` →
  ``running_mean``/``running_var``; Embed ``embedding`` → ``weight``;
- chunk-causal conv ``weight [K, Cin, Cout]`` → ``[Cout, Cin, K]``, depthwise
  ``[K, C]`` → ``[C, 1, K]``;
- vocoder conv ``*_w [K, Cin, Cout]`` → ``[Cout, Cin, K]``; transpose-conv
  ``ups_*_w [K, Cin, Cout]`` → ``[Cin, Cout, K]`` with no flip.

Loading is strict: a flax leaf with no home, a torch parameter or buffer left
unset, or a shape mismatch raises ``ValueError``. ``flax_variables`` is the
inverse: the module's tree in the flax layout, which the fairseq exporters of
``train/checkpoint.py`` take.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from streamspeech_tpu_torch.models.layers import BatchNorm, ChunkCausalConv

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def _convert(path: Tuple[str, ...], x: np.ndarray, collection: str
             ) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    if collection == "batch_stats":
        return ".".join(mods + [_STAT_NAMES[leaf]]), x
    if leaf == "kernel":
        return ".".join(mods + ["weight"]), x.T
    if leaf in ("scale", "embedding"):
        return ".".join(mods + ["weight"]), x
    if leaf == "weight" and x.ndim == 3:      # chunk-causal conv [K, Cin, Cout]
        return ".".join(path), x.transpose(2, 1, 0)
    if leaf == "weight" and x.ndim == 2:      # depthwise chunk-causal conv [K, C]
        return ".".join(path), x.T[:, None, :]
    if leaf.endswith("_w") and x.ndim == 3:
        perm = (1, 2, 0) if leaf.startswith("ups_") else (2, 1, 0)
        return ".".join(path), x.transpose(perm)
    return ".".join(path), x


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy a flax variables tree (NumPy leaves) into ``module`` in place, with
    the conversions of the module docstring. Works for the model, the vocoder
    and any submodule whose names mirror a flax module."""
    converted: Dict[str, np.ndarray] = {}
    for collection in ("params", "batch_stats"):
        for path, x in _flatten(variables.get(collection, {})):
            name, arr = _convert(path, x, collection)
            if name in converted:
                raise ValueError(f"two flax leaves map to {name}")
            converted[name] = arr
    targets = dict(module.named_parameters())
    targets.update((n, b) for n, b in module.named_buffers()
                   if n.rsplit(".", 1)[-1] in _STAT_NAMES.values())
    unused = sorted(set(converted) - set(targets))
    unset = sorted(set(targets) - set(converted))
    if unused or unset:
        raise ValueError(f"flax leaves without a torch home: {unused}; "
                         f"torch tensors left unset: {unset}")
    with torch.no_grad():
        for name, t in targets.items():
            arr = converted[name]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{name}: flax {arr.shape} vs torch "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(arr)).to(t.dtype))
    return module


# The vocoder's conversions (``*_w``, ``ups_*_w``, ``dict.embedding``) are
# handled by the same name rules.
load_flax_vocoder = load_flax_variables


def _to_flax(module: nn.Module, leaf: str, x: np.ndarray) -> Tuple[str, np.ndarray]:
    """The flax leaf name and layout of parameter ``leaf`` of ``module``: the
    inverse of ``_convert``, decided by the module's type."""
    if isinstance(module, nn.Linear) and leaf == "weight":
        return "kernel", x.T
    if isinstance(module, (nn.LayerNorm, BatchNorm)) and leaf == "weight":
        return "scale", x
    if isinstance(module, nn.Embedding):
        return "embedding", x
    if isinstance(module, ChunkCausalConv) and leaf == "weight":
        return leaf, x[:, 0, :].T if module.depthwise else x.transpose(2, 1, 0)
    if leaf.endswith("_w") and x.ndim == 3:
        return leaf, x.transpose((2, 0, 1) if leaf.startswith("ups_") else (2, 1, 0))
    return leaf, x


def flax_tree(module: nn.Module, tensors: Mapping[str, torch.Tensor],
              collection: str = "params") -> Dict[str, Dict]:
    """Tensors keyed by ``module``'s parameter names (``collection="params"``:
    the parameters, their gradients or optimizer moments) or BatchNorm
    buffer names (``"batch_stats"``) → one flax collection tree of NumPy
    arrays in the flax layout, of the tensors' own dtype (exact copies)."""
    out: Dict[str, Dict] = {}
    modules = dict(module.named_modules())
    stat_of = {v: k for k, v in _STAT_NAMES.items()}
    with torch.no_grad():
        for name, t in tensors.items():
            path, _, leaf = name.rpartition(".")
            x = t.detach().cpu().numpy().copy()
            if collection == "batch_stats":
                leaf = stat_of[leaf]
            else:
                leaf, x = _to_flax(modules[path], leaf, x)
            node = out
            for part in path.split(".") if path else []:
                node = node.setdefault(part, {})
            node[leaf] = np.ascontiguousarray(x)
    return out


def named_from_flax(tree: Mapping, collection: str = "params") -> Dict[str, np.ndarray]:
    """The inverse of ``flax_tree``: a flax collection tree (NumPy or CPU
    tensor leaves) → arrays keyed by the port's names, in the port's layout."""
    out: Dict[str, np.ndarray] = {}
    for path, x in _flatten(tree):
        name, arr = _convert(path, x, collection)
        out[name] = np.ascontiguousarray(arr)
    return out


def flax_variables(module: nn.Module) -> Dict[str, Dict]:
    """The module's weights as a flax variables tree of float32 NumPy arrays
    ({"params": ..., "batch_stats": ...}), the inverse of
    ``load_flax_variables``: loading the tree back gives the same tensors."""
    params = {n: t.float() for n, t in module.named_parameters()}
    stats = {n: t.float() for n, t in module.named_buffers()
             if n.rsplit(".", 1)[-1] in _STAT_NAMES.values()}
    out = {"params": flax_tree(module, params)}
    if stats:
        out["batch_stats"] = flax_tree(module, stats, "batch_stats")
    return out


_RESIDUAL_OUTPUTS = ("out_proj", "w_2", "fc2", "pointwise_conv2")


def _residual_scales(module: nn.Module) -> Dict[str, float]:
    """1/sqrt(n) for the output projection of each of the n residual branches
    of a top-level stack (the GPT-2 init, per branch rather than per layer)."""
    scales: Dict[str, float] = {}
    for stack, child in module.named_children():
        names = [f"{stack}.{n}" for n, _ in child.named_parameters()
                 if n.endswith(".weight") and n.split(".")[-2] in _RESIDUAL_OUTPUTS]
        scales.update((n, len(names) ** -0.5) for n in names)
    return scales


def random_init_(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights (``torch.Generator`` on the CPU, then copied to the
    module's device): LayerNorm / BatchNorm weight 1, biases 0, token tables
    N(0, 1/d) with the PAD row 0, every other weight N(0, 1/fan_in) (fan_in =
    the product of all but the first axis), so activations and the vocoder's
    waveform stay of order one through every layer. Residual-branch outputs
    are further scaled by ``_residual_scales``: without that the 12 random
    conformer layers of ``full_config`` map every frame to nearly the same
    state, the CTC hypotheses never grow, and the agent only writes once the
    source has ended."""
    gen = torch.Generator().manual_seed(seed)
    norm_weights = {f"{n}.weight" for n, m in module.named_modules()
                    if isinstance(m, (nn.LayerNorm, BatchNorm))}
    residual = _residual_scales(module)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in norm_weights:
                val = torch.ones(p.shape)
            elif leaf == "bias" or leaf.endswith("_b"):
                val = torch.zeros(p.shape)
            elif leaf == "embed_tokens":
                val = torch.randn(p.shape, generator=gen) * p.shape[1] ** -0.5
                val[1] = 0.0  # PAD
            else:
                fan_in = p[0].numel() if p.dim() > 1 else p.numel()
                val = torch.randn(p.shape, generator=gen) * fan_in ** -0.5
                val = val * residual.get(name, 1.0)
            p.copy_(val.to(p.dtype))
        for name, b in module.named_buffers():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "running_mean":
                b.zero_()
            elif leaf == "running_var":
                b.fill_(1.0)
    return module


def doctor_params(model: nn.Module) -> nn.Module:
    """Bias a random StreamSpeech model so the streaming policy writes (the
    port of `tests/test_batched_eval.py:34-48`): suppress the aux-CTC blank
    (hypotheses grow every chunk) and zero the special-token rows of the MT and
    unit tables (EOS/PAD and the unit blank rarely win the argmax). A random
    model without this never writes, and the unit path never runs."""
    with torch.no_grad():
        model.source_unigram_head.proj.bias[0] -= 8.0
        model.ctc_target_unigram_head.proj.bias[0] -= 8.0
        model.mt_decoder.embed_tokens[:4] = 0.0
        model.unit_decoder.embed_tokens[:4] = 0.0
        model.unit_decoder.embed_tokens[-1] = 0.0
    return model
