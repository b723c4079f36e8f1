"""The fairseq side of checkpointing (``streamspeech_tpu/train/checkpoint.py``):
a released StreamSpeech ``.pt`` and a CodeHiFiGAN vocoder ``.pt`` → the flax
variables tree (NumPy leaves) that ``weights.load_flax_variables`` loads into
the port's model and vocoder, and back.

- fairseq model ``.pt`` (``{"model": state_dict, "cfg": ...}``,
  `checkpoint_utils.py:288`): torch linear ``[out, in]`` → flax ``kernel [in,
  out]``; conv ``[out, in, k]`` → ``[k, in, out]``; BatchNorm running stats →
  the ``batch_stats`` collection; tower names per `researches/ctc_unity/models/
  streamspeech_model.py:183-268`.
- CodeHiFiGAN ``.pt`` (``{"generator": state_dict}``, `agent/tts/vocoder.py:
  38-41`): weight-norm ``weight_g`` / ``weight_v`` folded into plain weights,
  as the reference's remove_weight_norm after loading.

NumPy and ``torch.load`` only.

The native checkpoints (the second half of this module) keep the JAX
package's directory layout and rotation: ``checkpoint_<step>/``,
``checkpoint.best_<repr(metric)>_<step>/`` as hard-link trees, ``config.json``
and ``--keep-last``. The file inside is the port's own: the card machine has
no orbax, so it cannot read JAX's. ``checkpoint_<step>/state.pt`` holds the
parameters, the BatchNorm statistics, Adam's ``mu`` / ``nu``, ``count``,
``mini_step``, the MultiSteps accumulator and ``step``, as CPU tensors under
the flax names and layout (``weights.flax_tree``), loaded with
``torch.load(..., weights_only=True)``; a port checkpoint compares with a JAX
one by name, and ``weights.load_flax_variables`` restores its weights."""

from __future__ import annotations

import json
import math
import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from streamspeech_tpu_torch.config import StreamSpeechConfig


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def _linear(sd, name, out: Dict[str, Any], bias=True):
    out["kernel"] = _t(sd[f"{name}.weight"]).T
    if bias and f"{name}.bias" in sd:
        out["bias"] = _t(sd[f"{name}.bias"])
    return out


def _ln(sd, name):
    return {"scale": _t(sd[f"{name}.weight"]), "bias": _t(sd[f"{name}.bias"])}


def _mha(sd, name):
    """fairseq MultiheadAttention {q,k,v,out}_proj."""
    return {p: _linear(sd, f"{name}.{p}", {}) for p in ("q_proj", "k_proj", "v_proj", "out_proj")}


def _espnet_relpos_attn(sd, name):
    """espnet RelPositionMultiHeadedAttention linear_{q,k,v,out,pos} and biases."""
    return {
        "q_proj": _linear(sd, f"{name}.linear_q", {}),
        "k_proj": _linear(sd, f"{name}.linear_k", {}),
        "v_proj": _linear(sd, f"{name}.linear_v", {}),
        "out_proj": _linear(sd, f"{name}.linear_out", {}),
        "linear_pos": {"kernel": _t(sd[f"{name}.linear_pos.weight"]).T},
        "pos_bias_u": _t(sd[f"{name}.pos_bias_u"]),
        "pos_bias_v": _t(sd[f"{name}.pos_bias_v"]),
    }


def _ffn_conformer(sd, name):
    return {"layer_norm": _ln(sd, f"{name}.layer_norm"),
            "w_1": _linear(sd, f"{name}.w_1", {}), "w_2": _linear(sd, f"{name}.w_2", {})}


def _decoder_layer(sd, name):
    return {
        "self_attn": _mha(sd, f"{name}.self_attn"),
        "self_attn_layer_norm": _ln(sd, f"{name}.self_attn_layer_norm"),
        "encoder_attn": _mha(sd, f"{name}.encoder_attn"),
        "encoder_attn_layer_norm": _ln(sd, f"{name}.encoder_attn_layer_norm"),
        "ffn": {"fc1": _linear(sd, f"{name}.fc1", {}), "fc2": _linear(sd, f"{name}.fc2", {})},
        "final_layer_norm": _ln(sd, f"{name}.final_layer_norm"),
    }


def _encoder_layer_t2u(sd, name):
    return {
        "self_attn": _mha(sd, f"{name}.self_attn"),
        "self_attn_layer_norm": _ln(sd, f"{name}.self_attn_layer_norm"),
        "ffn": {"fc1": _linear(sd, f"{name}.fc1", {}), "fc2": _linear(sd, f"{name}.fc2", {})},
        "final_layer_norm": _ln(sd, f"{name}.final_layer_norm"),
    }


def _count_layers(sd, prefix: str) -> int:
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.")
    idx = {int(m.group(1)) for k in sd for m in [pat.match(k)] if m}
    return max(idx) + 1 if idx else 0


def _load(path: str):
    # a released checkpoint pickles its fairseq config beside the tensors
    return torch.load(path, map_location="cpu", weights_only=False)


def import_fairseq_streamspeech(path: str) -> Tuple[Dict, Dict, Dict]:
    """A StreamSpeech ``.pt`` → (params, batch_stats, the embedded cfg)."""
    state = _load(path)
    sd = state["model"] if "model" in state else state
    cfg = state.get("cfg", {})
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}

    enc: Dict[str, Any] = {"subsample": {}, "linear": _linear(sd, "encoder.linear", {})}
    enc_bs: Dict[str, Any] = {}
    for i in range(_count_layers(sd, "encoder.subsample.conv_layers")):
        w = _t(sd[f"encoder.subsample.conv_layers.{i}.weight"])     # [out, in, k]
        enc["subsample"][f"conv_{i}"] = {
            "weight": w.transpose(2, 1, 0),
            "bias": _t(sd[f"encoder.subsample.conv_layers.{i}.bias"])}
    for i in range(_count_layers(sd, "encoder.conformer_layers")):
        p = f"encoder.conformer_layers.{i}"
        dw = _t(sd[f"{p}.conv_module.depthwise_conv.weight"])           # [C, 1, k]
        enc[f"layers_{i}"] = {
            "ffn1": _ffn_conformer(sd, f"{p}.ffn1"),
            "self_attn_layer_norm": _ln(sd, f"{p}.self_attn_layer_norm"),
            "self_attn": _espnet_relpos_attn(sd, f"{p}.self_attn"),
            "conv_module": {
                "layer_norm": _ln(sd, f"{p}.conv_module.layer_norm"),
                "pointwise_conv1": {
                    "kernel": _t(sd[f"{p}.conv_module.pointwise_conv1.weight"])[:, :, 0].T},
                "depthwise_conv": {"weight": dw[:, 0, :].T},
                "batch_norm": {"scale": _t(sd[f"{p}.conv_module.batch_norm.weight"]),
                               "bias": _t(sd[f"{p}.conv_module.batch_norm.bias"])},
                "pointwise_conv2": {
                    "kernel": _t(sd[f"{p}.conv_module.pointwise_conv2.weight"])[:, :, 0].T},
            },
            "ffn2": _ffn_conformer(sd, f"{p}.ffn2"),
            "final_layer_norm": _ln(sd, f"{p}.final_layer_norm"),
        }
        enc_bs[f"layers_{i}"] = {"conv_module": {"batch_norm": {
            "mean": _t(sd[f"{p}.conv_module.batch_norm.running_mean"]),
            "var": _t(sd[f"{p}.conv_module.batch_norm.running_var"])}}}
    params["encoder"] = enc
    batch_stats["encoder"] = enc_bs

    for ours, theirs in [("source_unigram_head", "source_unigram_decoder"),
                         ("ctc_target_unigram_head", "ctc_target_unigram_decoder")]:
        if f"{theirs}.proj.weight" in sd:
            params[ours] = {"proj": _linear(sd, f"{theirs}.proj", {})}

    mt = {"embed_tokens": _t(sd["target_unigram_decoder.embed_tokens.weight"])}
    for i in range(_count_layers(sd, "target_unigram_decoder.layers")):
        mt[f"layers_{i}"] = _decoder_layer(sd, f"target_unigram_decoder.layers.{i}")
    if "target_unigram_decoder.layer_norm.weight" in sd:
        mt["layer_norm"] = _ln(sd, "target_unigram_decoder.layer_norm")
    params["mt_decoder"] = mt

    if "synthesizer_encoder.layer_norm.weight" in sd:
        t2u = {"layer_norm": _ln(sd, "synthesizer_encoder.layer_norm")}
        for i in range(_count_layers(sd, "synthesizer_encoder.layers")):
            t2u[f"layers_{i}"] = _encoder_layer_t2u(sd, f"synthesizer_encoder.layers.{i}")
        params["synthesizer_encoder"] = t2u

    ud = {"embed_tokens": _t(sd["decoder.embed_tokens.weight"])}
    for i in range(_count_layers(sd, "decoder.layers")):
        ud[f"layers_{i}"] = _decoder_layer(sd, f"decoder.layers.{i}")
    if "decoder.layer_norm.weight" in sd:
        ud["layer_norm"] = _ln(sd, "decoder.layer_norm")
    params["unit_decoder"] = ud
    return params, batch_stats, cfg


def _n_layers(tree: Dict) -> int:
    return sum(1 for k in tree if k.startswith("layers_"))


def infer_config_from_params(params: Dict, batch_stats: Dict) -> StreamSpeechConfig:
    """A ``StreamSpeechConfig`` from the imported shapes (`checkpoint.py:432`):
    the released checkpoints' omegaconf blob needs fairseq to read, and the
    shapes hold what the modules need; the rest keeps ``simul_s2st``'s
    values (the decoders' heads and the unit upsampling among them)."""
    cfg = StreamSpeechConfig.simul_s2st()
    enc = params["encoder"]
    cfg.encoder.layers = _n_layers(enc)
    cfg.encoder.embed_dim = enc["linear"]["kernel"].shape[1]
    l0 = enc["layers_0"]
    cfg.encoder.ffn_embed_dim = l0["ffn1"]["w_1"]["kernel"].shape[1]
    cfg.encoder.attention_heads = l0["self_attn"]["pos_bias_u"].shape[0]
    cfg.encoder.depthwise_conv_kernel_size = l0["conv_module"]["depthwise_conv"]["weight"].shape[0]
    sub = enc["subsample"]
    cfg.encoder.conv_kernel_sizes = [sub[f"conv_{i}"]["weight"].shape[0] for i in range(len(sub))]
    cfg.encoder.conv_channels = sub["conv_0"]["weight"].shape[2]

    mt = params["mt_decoder"]
    cfg.mt_decoder.vocab_size, cfg.mt_decoder.embed_dim = mt["embed_tokens"].shape
    cfg.mt_decoder.layers = _n_layers(mt)
    cfg.mt_decoder.ffn_embed_dim = mt["layers_0"]["ffn"]["fc1"]["kernel"].shape[1]
    cfg.mt_decoder.normalize_before = "layer_norm" in mt
    cfg.translation_decoder_layers = cfg.mt_decoder.layers

    ud = params["unit_decoder"]
    cfg.unit_decoder.vocab_size, cfg.unit_decoder.embed_dim = ud["embed_tokens"].shape
    cfg.unit_decoder.layers = _n_layers(ud)
    cfg.unit_decoder.ffn_embed_dim = ud["layers_0"]["ffn"]["fc1"]["kernel"].shape[1]
    cfg.target_code_size = cfg.unit_decoder.vocab_size - 5     # 4 specials + blank

    cfg.synthesizer_encoder_layers = (_n_layers(params["synthesizer_encoder"])
                                      if "synthesizer_encoder" in params else 0)
    if "source_unigram_head" in params:
        cfg.source_unigram_vocab = params["source_unigram_head"]["proj"]["kernel"].shape[1]
    if "ctc_target_unigram_head" in params:
        cfg.ctc_target_unigram_vocab = \
            params["ctc_target_unigram_head"]["proj"]["kernel"].shape[1]
    return cfg


def export_fairseq_streamspeech(params: Dict, batch_stats: Dict) -> Dict[str, np.ndarray]:
    """The inverse of ``import_fairseq_streamspeech`` (`checkpoint.py:483`):
    a flax variables tree → fairseq state-dict names and layouts. Save it as
    ``torch.save({"model": sd, "cfg": {}}, path)``."""
    sd: Dict[str, np.ndarray] = {}

    def put_linear(name, p):
        sd[f"{name}.weight"] = np.asarray(p["kernel"]).T
        if "bias" in p:
            sd[f"{name}.bias"] = np.asarray(p["bias"])

    def put_ln(name, p):
        sd[f"{name}.weight"] = np.asarray(p["scale"])
        sd[f"{name}.bias"] = np.asarray(p["bias"])

    enc = params["encoder"]
    for key, sub in enc["subsample"].items():
        i = key.split("_")[-1]
        sd[f"encoder.subsample.conv_layers.{i}.weight"] = np.asarray(sub["weight"]).transpose(2, 1, 0)
        sd[f"encoder.subsample.conv_layers.{i}.bias"] = np.asarray(sub["bias"])
    put_linear("encoder.linear", enc["linear"])
    for key, layer in enc.items():
        if not key.startswith("layers_"):
            continue
        p = f"encoder.conformer_layers.{key.split('_')[-1]}"
        for ffn in ("ffn1", "ffn2"):
            put_ln(f"{p}.{ffn}.layer_norm", layer[ffn]["layer_norm"])
            put_linear(f"{p}.{ffn}.w_1", layer[ffn]["w_1"])
            put_linear(f"{p}.{ffn}.w_2", layer[ffn]["w_2"])
        put_ln(f"{p}.self_attn_layer_norm", layer["self_attn_layer_norm"])
        a = layer["self_attn"]
        for ours, theirs in [("q_proj", "linear_q"), ("k_proj", "linear_k"),
                             ("v_proj", "linear_v"), ("out_proj", "linear_out")]:
            put_linear(f"{p}.self_attn.{theirs}", a[ours])
        sd[f"{p}.self_attn.linear_pos.weight"] = np.asarray(a["linear_pos"]["kernel"]).T
        sd[f"{p}.self_attn.pos_bias_u"] = np.asarray(a["pos_bias_u"])
        sd[f"{p}.self_attn.pos_bias_v"] = np.asarray(a["pos_bias_v"])
        cm = layer["conv_module"]
        put_ln(f"{p}.conv_module.layer_norm", cm["layer_norm"])
        sd[f"{p}.conv_module.pointwise_conv1.weight"] = \
            np.asarray(cm["pointwise_conv1"]["kernel"]).T[:, :, None]
        sd[f"{p}.conv_module.depthwise_conv.weight"] = \
            np.asarray(cm["depthwise_conv"]["weight"]).T[:, None, :]
        sd[f"{p}.conv_module.batch_norm.weight"] = np.asarray(cm["batch_norm"]["scale"])
        sd[f"{p}.conv_module.batch_norm.bias"] = np.asarray(cm["batch_norm"]["bias"])
        bs = batch_stats["encoder"][key]["conv_module"]["batch_norm"]
        sd[f"{p}.conv_module.batch_norm.running_mean"] = np.asarray(bs["mean"])
        sd[f"{p}.conv_module.batch_norm.running_var"] = np.asarray(bs["var"])
        sd[f"{p}.conv_module.pointwise_conv2.weight"] = \
            np.asarray(cm["pointwise_conv2"]["kernel"]).T[:, :, None]
        put_ln(f"{p}.final_layer_norm", layer["final_layer_norm"])

    for ours, theirs in [("source_unigram_head", "source_unigram_decoder"),
                         ("ctc_target_unigram_head", "ctc_target_unigram_decoder")]:
        if ours in params:
            put_linear(f"{theirs}.proj", params[ours]["proj"])

    def put_stack(tree, prefix, layer_fn):
        if "embed_tokens" in tree:
            sd[f"{prefix}.embed_tokens.weight"] = np.asarray(tree["embed_tokens"])
        for key, layer in tree.items():
            if key.startswith("layers_"):
                layer_fn(layer, f"{prefix}.layers.{key.split('_')[-1]}")
        if "layer_norm" in tree:
            put_ln(f"{prefix}.layer_norm", tree["layer_norm"])

    def put_attn_ffn(layer, p, attns):
        for attn in attns:
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                put_linear(f"{p}.{attn}.{proj}", layer[attn][proj])
            put_ln(f"{p}.{attn}_layer_norm", layer[f"{attn}_layer_norm"])
        put_linear(f"{p}.fc1", layer["ffn"]["fc1"])
        put_linear(f"{p}.fc2", layer["ffn"]["fc2"])
        put_ln(f"{p}.final_layer_norm", layer["final_layer_norm"])

    def dec_layer(layer, p):
        put_attn_ffn(layer, p, ("self_attn", "encoder_attn"))

    def enc_layer(layer, p):
        put_attn_ffn(layer, p, ("self_attn",))

    put_stack(params["mt_decoder"], "target_unigram_decoder", dec_layer)
    if "synthesizer_encoder" in params:
        put_stack(params["synthesizer_encoder"], "synthesizer_encoder", enc_layer)
    put_stack(params["unit_decoder"], "decoder", dec_layer)
    return sd


# ---------------------------------------------------------------------------
# CodeHiFiGAN vocoder
# ---------------------------------------------------------------------------


def _fold_weight_norm(sd, name) -> np.ndarray:
    """weight = g · v / ||v||, the norm over every axis but the first (torch's
    ``weight_norm`` default, dim 0); a plain ``weight`` as it is."""
    if f"{name}.weight" in sd:
        return _t(sd[f"{name}.weight"])
    g = _t(sd[f"{name}.weight_g"])
    v = _t(sd[f"{name}.weight_v"])
    norm = np.sqrt((v ** 2).reshape(v.shape[0], -1).sum(1)).reshape((-1,) + (1,) * (v.ndim - 1))
    return g * v / np.maximum(norm, 1e-12)


def _resblock_names(cfg: Dict):
    """(flax key, fairseq prefix) of every ResBlock conv of the generator."""
    n_kernels = len(cfg["resblock_kernel_sizes"])
    for r in range(len(cfg["upsample_rates"]) * n_kernels):
        for j in range(len(cfg["resblock_dilation_sizes"][r % n_kernels])):
            for br in ("convs1", "convs2"):
                yield r, f"{br}_{j}", f"resblocks.{r}.{br}.{j}"


def import_hifigan_vocoder(checkpoint_path: str, config_path: str) -> Tuple[Dict, Dict]:
    """A CodeHiFiGAN ``.pt`` and its JSON config (`checkpoint.py:640`) →
    ({"params": vocoder params}, config dict), for
    ``weights.load_flax_vocoder`` and ``models.vocoder.CodeGenerator``."""
    cfg = json.loads(Path(config_path).read_text())
    sd = _load(checkpoint_path)["generator"]
    gen: Dict[str, Any] = {
        "conv_pre_w": _fold_weight_norm(sd, "conv_pre").transpose(2, 1, 0),
        "conv_pre_b": _t(sd["conv_pre.bias"])}
    for i in range(len(cfg["upsample_rates"])):
        # ConvTranspose1d [Cin, Cout, K] → [K, Cin, Cout]
        gen[f"ups_{i}_w"] = _fold_weight_norm(sd, f"ups.{i}").transpose(2, 0, 1)
        gen[f"ups_{i}_b"] = _t(sd[f"ups.{i}.bias"])
    for r, key, name in _resblock_names(cfg):
        rb = gen.setdefault(f"resblocks_{r}", {})
        rb[f"{key}_w"] = _fold_weight_norm(sd, name).transpose(2, 1, 0)
        rb[f"{key}_b"] = _t(sd[f"{name}.bias"])
    gen["conv_post_w"] = _fold_weight_norm(sd, "conv_post").transpose(2, 1, 0)
    gen["conv_post_b"] = _t(sd["conv_post.bias"])
    params: Dict[str, Any] = {"generator": gen, "dict": {"embedding": _t(sd["dict.weight"])}}
    if "dur_predictor.conv1.0.weight" in sd:
        params["dur_predictor"] = {
            "conv1_w": _t(sd["dur_predictor.conv1.0.weight"]).transpose(2, 1, 0),
            "conv1_b": _t(sd["dur_predictor.conv1.0.bias"]),
            "ln1": _ln(sd, "dur_predictor.ln1"),
            "conv2_w": _t(sd["dur_predictor.conv2.0.weight"]).transpose(2, 1, 0),
            "conv2_b": _t(sd["dur_predictor.conv2.0.bias"]),
            "ln2": _ln(sd, "dur_predictor.ln2"),
            "proj": {"kernel": _t(sd["dur_predictor.proj.weight"]).T,
                     "bias": _t(sd["dur_predictor.proj.bias"])}}
    return {"params": params}, cfg


def export_hifigan_vocoder(variables: Dict, cfg: Dict) -> Dict[str, np.ndarray]:
    """The inverse of ``import_hifigan_vocoder``: vocoder variables (flax
    layout, e.g. ``weights.flax_variables(vocoder)``) → the reference's
    generator state dict, each generator conv weight-normed (``weight_g`` =
    ||w|| over every axis but the first, ``weight_v`` = w). Save it as
    ``torch.save({"generator": sd}, path)``; folding it back gives w to
    rounding."""
    p = variables["params"]
    gen = p["generator"]
    sd: Dict[str, np.ndarray] = {}

    def put_wn(name, w):
        w = np.asarray(w, np.float32)
        sd[f"{name}.weight_g"] = np.sqrt((w ** 2).reshape(w.shape[0], -1).sum(1)).reshape(
            (-1,) + (1,) * (w.ndim - 1))
        sd[f"{name}.weight_v"] = w

    put_wn("conv_pre", np.asarray(gen["conv_pre_w"]).transpose(2, 1, 0))
    sd["conv_pre.bias"] = np.asarray(gen["conv_pre_b"])
    for i in range(len(cfg["upsample_rates"])):
        put_wn(f"ups.{i}", np.asarray(gen[f"ups_{i}_w"]).transpose(1, 2, 0))
        sd[f"ups.{i}.bias"] = np.asarray(gen[f"ups_{i}_b"])
    for r, key, name in _resblock_names(cfg):
        rb = gen[f"resblocks_{r}"]
        put_wn(name, np.asarray(rb[f"{key}_w"]).transpose(2, 1, 0))
        sd[f"{name}.bias"] = np.asarray(rb[f"{key}_b"])
    put_wn("conv_post", np.asarray(gen["conv_post_w"]).transpose(2, 1, 0))
    sd["conv_post.bias"] = np.asarray(gen["conv_post_b"])
    sd["dict.weight"] = np.asarray(p["dict"]["embedding"])
    if "dur_predictor" in p:
        dp = p["dur_predictor"]
        for c in ("conv1", "conv2"):
            sd[f"dur_predictor.{c}.0.weight"] = np.asarray(dp[f"{c}_w"]).transpose(2, 1, 0)
            sd[f"dur_predictor.{c}.0.bias"] = np.asarray(dp[f"{c}_b"])
        for ln in ("ln1", "ln2"):
            sd[f"dur_predictor.{ln}.weight"] = np.asarray(dp[ln]["scale"])
            sd[f"dur_predictor.{ln}.bias"] = np.asarray(dp[ln]["bias"])
        sd["dur_predictor.proj.weight"] = np.asarray(dp["proj"]["kernel"]).T
        sd["dur_predictor.proj.bias"] = np.asarray(dp["proj"]["bias"])
    return sd


# ---------------------------------------------------------------------------
# native checkpoints
# ---------------------------------------------------------------------------

STATE_FILE = "state.pt"


def tensor_tree(tree):
    """A tree of NumPy arrays → the same tree of CPU tensors (a payload for
    ``save_payload``)."""
    if isinstance(tree, Mapping):
        return {k: tensor_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def state_payload(state) -> Dict[str, Any]:
    """A port ``TrainState`` → the checkpoint's tree of CPU tensors under
    the flax names: ``params``, ``batch_stats``, ``opt_state`` (``count``,
    ``mini_step``, ``mu``, ``nu`` and, with update_freq > 1, ``acc_grads``)
    and ``step``."""
    from streamspeech_tpu_torch.weights import flax_tree

    if state.model is None:
        raise ValueError("the TrainState has no model (make it with TrainState.create)")
    names = list(state.params)
    opt = state.opt_state

    def tree(tensors, collection="params"):
        return tensor_tree(flax_tree(state.model, tensors, collection))

    payload_opt = {"count": torch.tensor(opt.count, dtype=torch.int32),
                   "mini_step": torch.tensor(opt.mini_step, dtype=torch.int32),
                   "mu": tree(dict(zip(names, opt.mu))),
                   "nu": tree(dict(zip(names, opt.nu)))}
    if opt.acc_grads is not None:
        payload_opt["acc_grads"] = tree(dict(zip(names, opt.acc_grads)))
    return {"params": tree(state.params),
            "batch_stats": tree(state.batch_stats, "batch_stats"),
            "opt_state": payload_opt,
            "step": torch.tensor(state.step, dtype=torch.int32)}


def restore_state(state, payload: Mapping[str, Any]):
    """Copy a checkpoint's payload into ``state`` in place (the model's
    parameters and statistics, the optimizer state, the step); returns it."""
    from streamspeech_tpu_torch.weights import load_flax_variables, named_from_flax

    load_flax_variables(state.model, {"params": payload["params"],
                                      "batch_stats": payload["batch_stats"]})
    names = list(state.params)
    opt = payload["opt_state"]

    def as_list(tree):
        named = named_from_flax(tree)
        return [torch.from_numpy(named[n]).to(state.params[n].device) for n in names]

    state.opt_state.count = int(opt["count"])
    state.opt_state.mini_step = int(opt["mini_step"])
    state.opt_state.mu = as_list(opt["mu"])
    state.opt_state.nu = as_list(opt["nu"])
    if "acc_grads" in opt:
        state.opt_state.acc_grads = as_list(opt["acc_grads"])
    state.step = int(payload["step"])
    return state


def _by_step(d: Path) -> List[Path]:
    return sorted(d.glob("checkpoint_*"), key=lambda p: int(p.name.split("_")[-1]))


def save_checkpoint(save_dir: str, step: int, state, config: Optional[dict] = None,
                    keep_last: int = 10, keep_best: int = 0,
                    val_metric: Optional[float] = None,
                    maximize: bool = False) -> str:
    """Write ``checkpoint_<step>/state.pt`` (and ``config.json``), enter the
    best set when ``keep_best`` and a metric are given, then keep the newest
    ``keep_last`` ``checkpoint_*`` (`streamspeech_tpu/train/checkpoint.py:33-64`)."""
    d = Path(save_dir).absolute()
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"checkpoint_{step}"
    if path.exists():
        shutil.rmtree(path)
    save_payload(str(path), state_payload(state))
    if config is not None:
        (d / "config.json").write_text(json.dumps(config, indent=2))
    if keep_best > 0 and val_metric is not None:
        _rotate_best(d, path, step, float(val_metric), keep_best, maximize)
    for old in _by_step(d)[:-keep_last]:
        shutil.rmtree(old, ignore_errors=True)
    return str(path)


_BEST_RE = re.compile(r"checkpoint\.best_(-?[0-9.]+(?:e[+-]?\d+)?)_(\d+)$")


def _scan_best(d: Path):
    """[(metric, step, path)] of the kept best checkpoints in `d`."""
    best = []
    for p in d.glob("checkpoint.best_*"):
        m = _BEST_RE.match(p.name)
        if m:
            best.append((float(m.group(1)), int(m.group(2)), p))
    return best


def would_enter_best(save_dir: str, val: Optional[float], keep_best: int,
                     maximize: bool = False) -> bool:
    """True iff a checkpoint with validation metric `val` would be admitted
    to the --keep-best-checkpoints rotation right now; the train loop asks
    before it writes a checkpoint that would be pruned at once."""
    if keep_best <= 0 or val is None or not math.isfinite(float(val)):
        return False
    best = _scan_best(Path(save_dir)) if Path(save_dir).exists() else []
    if len(best) < keep_best:
        return True
    worst = (min if maximize else max)(b[0] for b in best)
    return val >= worst if maximize else val <= worst


def _rotate_best(d: Path, src: Path, step: int, val: float, keep_best: int,
                 maximize: bool) -> None:
    """`--keep-best-checkpoints` (fairseq `checkpoint_utils.py:83-127`): the
    new checkpoint is linked to checkpoint.best_<repr(metric)>_<step> when it
    beats the worst kept best (or fewer than N are kept), then all but the N
    best are removed; ties keep the newer step. A non-finite metric never
    enters (its name would not parse back)."""
    if not math.isfinite(val):
        return
    best = _scan_best(d)

    def better(a: float, b: float) -> bool:
        return a >= b if maximize else a <= b

    if best:
        worst = (min if maximize else max)(b[0] for b in best)
        if len(best) >= keep_best and not better(val, worst):
            return
    dst = d / f"checkpoint.best_{val!r}_{step}"
    if not dst.exists():
        shutil.copytree(src, dst, copy_function=os.link)
        best.append((val, step, dst))
    best.sort(key=lambda t: (-t[0] if maximize else t[0], -t[1]))
    for _, _, p in best[keep_best:]:
        shutil.rmtree(p, ignore_errors=True)


def best_checkpoint(save_dir: str, maximize: bool = False) -> Optional[str]:
    """Path of the best kept checkpoint of the --keep-best-checkpoints
    rotation (fairseq's checkpoint_best.pt), or None."""
    d = Path(save_dir)
    if not d.exists():
        return None
    best = _scan_best(d)
    if not best:
        return None
    best.sort(key=lambda t: (-t[0] if maximize else t[0], -t[1]))
    return str(best[0][2])


def latest_checkpoint(save_dir: str) -> Optional[str]:
    d = Path(save_dir)
    if not d.exists():
        return None
    ckpts = _by_step(d)
    return str(ckpts[-1]) if ckpts else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint directory (or its ``state.pt``) → its payload: nested
    dicts of CPU tensors (``state_payload``'s tree)."""
    p = Path(path)
    if p.is_dir():
        p = p / STATE_FILE
    return torch.load(p, map_location="cpu", weights_only=True)


def load_model_ensemble(paths) -> list:
    """N native checkpoints as ensemble members (fairseq
    `checkpoint_utils.py:288`): a ``{"params", "batch_stats"}`` tree each."""
    out = []
    for p in paths:
        r = load_checkpoint(str(p))
        out.append({"params": r["params"], "batch_stats": r.get("batch_stats", {})})
    return out


def _map_leaves(fn, *trees):
    first = trees[0]
    if isinstance(first, Mapping):
        if any(not isinstance(t, Mapping) or set(t) != set(first) for t in trees[1:]):
            raise KeyError("checkpoints have mismatched param trees "
                           "(average_checkpoints.py:50 raises KeyError too)")
        return {k: _map_leaves(fn, *(t[k] for t in trees)) for k in first}
    if any(isinstance(t, Mapping) for t in trees[1:]):
        raise KeyError("checkpoints have mismatched param trees")
    return fn(*trees)


def average_checkpoints(paths) -> Dict[str, Any]:
    """Average the params across checkpoints (`fairseq/scripts/
    average_checkpoints.py:17-65`): float params are the element-wise mean
    (summed in float64), everything else (non-float leaves, batch_stats,
    opt_state, step) is the FIRST checkpoint's."""
    assert len(paths) >= 1
    payloads = [load_checkpoint(str(p)) for p in paths]
    n = len(payloads)

    def avg(*leaves):
        x0 = leaves[0]
        if torch.is_floating_point(x0):
            acc = torch.zeros(x0.shape, dtype=torch.float64)
            for leaf in leaves:
                acc += leaf.to(torch.float64)
            return (acc / n).to(x0.dtype)
        return x0

    params = _map_leaves(avg, *[p["params"] for p in payloads])
    return {**payloads[0], "params": params}


def save_payload(path: str, payload: Mapping[str, Any]) -> str:
    """Write a payload (``state_payload``'s or ``average_checkpoints``'s) as a
    checkpoint directory, its file replaced at once."""
    d = Path(path).absolute()
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f"{STATE_FILE}.tmp"
    torch.save(dict(payload), tmp)
    os.replace(tmp, d / STATE_FILE)
    return str(d)


def _key_paths(tree) -> set:
    """The key paths of a tree: what JAX's treedef comparison sees (names and
    nesting, not leaf shapes)."""
    if isinstance(tree, Mapping):
        return {(k,) + rest for k, v in tree.items() for rest in _key_paths(v)}
    return {()}


def load_pretrained_component(variables: Dict[str, Any], checkpoint_path: str,
                              component: str, strict: bool = True) -> Dict[str, Any]:
    """Graft one tower (e.g. "encoder", "mt_decoder", "unit_decoder") of a
    saved checkpoint into a flax variables tree (fairseq's
    `load_pretrained_component_from_model`, `checkpoint_utils.py:821-851`).
    Takes a native checkpoint or a fairseq ``.pt``. ``strict`` raises unless
    the component's tree (its names and nesting) is the one it replaces."""
    if Path(checkpoint_path).is_file():  # reference .pt
        params_src, bs_src, _ = import_fairseq_streamspeech(checkpoint_path)
        payload = {"params": params_src, "batch_stats": bs_src}
    else:
        payload = load_checkpoint(checkpoint_path)
    if component not in payload["params"]:
        raise KeyError(f"checkpoint has no component {component!r}")
    sub = payload["params"][component]
    if strict:
        want = _key_paths(variables["params"][component])
        have = _key_paths(sub)
        if want != have:
            raise ValueError(f"component {component!r} structure mismatch: "
                             f"{sorted(want ^ have)}")
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in variables.items()}
    out["params"] = dict(variables["params"])
    out["params"][component] = sub
    bs = payload.get("batch_stats") or {}
    if component in bs and "batch_stats" in variables:
        out["batch_stats"] = dict(variables.get("batch_stats", {}))
        out["batch_stats"][component] = bs[component]
    return out

