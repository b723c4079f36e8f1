"""The train step (``streamspeech_tpu/train/trainer.py``): the optimizer with
the semantics of ``make_optimizer``'s optax chain, the train state and
``make_train_step``.

Optax's semantics, not torch's defaults:
- ``clip_by_global_norm``: g / norm · max_norm where norm >= max_norm, no
  ``+1e-6`` (``torch.nn.utils.clip_grad_norm_`` differs);
- Adam: mu_hat / (sqrt(nu_hat) + eps), betas (0.9, 0.98) by default;
- ``add_decayed_weights``: decoupled, wd · param added to the Adam update,
  then scaled by the lr with it;
- ``scale_by_schedule`` reads the count before the increment, so the first
  update uses schedule(0) = schedule(1);
- ``optax.MultiSteps`` (update_freq > 1) averages the gradients of
  ``update_freq`` calls; the inner count and the params move only on the k-th
  call, while ``TrainState.step`` counts every call.

The NaN/Inf guard zeroes non-finite gradients and still runs the optimizer
(`trainer.py:146-152`): the moments decay and the params move by the old
momentum. Unlike the JAX package the port updates the model's parameters and
BatchNorm buffers in place: the state is a view on the model's tensors.
``make_train_step_scan`` and the mesh helpers (``create_sharded_state``,
``batch_spec``) are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from streamspeech_tpu_torch.config import OptimizationConfig
from streamspeech_tpu_torch.models.layers import set_kernel_train
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.ops.specaugment import specaugment_apply, specaugment_draws
from streamspeech_tpu_torch.train.criterion import CriterionWeights, streamspeech_loss
from streamspeech_tpu_torch.train.lr import inverse_sqrt

Tensors = Dict[str, torch.Tensor]
_STAT_NAMES = ("running_mean", "running_var")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: g / norm · max_norm where norm >= max_norm,
    with no ``+1e-6`` in the denominator (unlike ``clip_grad_norm_``)."""
    norm = global_norm(grads)
    trigger = norm < max_norm
    return [torch.where(trigger, g, g / norm * max_norm) for g in grads]


def guard_nonfinite(grads: List[torch.Tensor]
                    ) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """The fairseq overflow-skip analogue (`trainer.py:146-150`): (grads, their
    global norm, whether it is finite), the grads zeroed where it is not. The
    optimizer still runs on the zeroed grads."""
    gnorm = global_norm(grads)
    finite = torch.isfinite(gnorm)
    return [torch.where(finite, g, torch.zeros_like(g)) for g in grads], gnorm, finite


@dataclasses.dataclass
class OptState:
    """Adam's moments and the count shared by Adam's bias correction and the
    schedule; with update_freq > 1 also MultiSteps' mini-step and running
    mean of the gradients."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None


class Optimizer:
    """``make_optimizer`` (`trainer.py:57-71`) as plain functions on lists of
    tensors, in the parameters' order: ``init(params)`` and
    ``update(grads, state, params) -> (updates or None, state)``."""

    def __init__(self, opt: OptimizationConfig):
        if opt.lr_scheduler != "inverse_sqrt":
            raise NotImplementedError(f"lr_scheduler {opt.lr_scheduler!r}: only "
                                      "'inverse_sqrt' is wired, as in make_optimizer")
        self.cfg = opt
        self.schedule = inverse_sqrt(opt.lr, opt.warmup_updates, opt.warmup_init_lr)
        self.every_k = max(int(opt.update_freq), 1)

    def init(self, params: List[torch.Tensor]) -> OptState:
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        return OptState(count=0, mu=zeros(), nu=zeros(),
                        acc_grads=zeros() if self.every_k > 1 else None)

    def update(self, grads: List[torch.Tensor], state: OptState,
               params: List[torch.Tensor]
               ) -> Tuple[Optional[List[torch.Tensor]], OptState]:
        """The chain's updates (None: MultiSteps' zero update) and new state."""
        if self.every_k == 1:
            return self._inner(grads, state, params)
        n = state.mini_step
        acc = [a + (g - a) / (n + 1) for g, a in zip(grads, state.acc_grads)]
        if n < self.every_k - 1:
            return None, dataclasses.replace(state, mini_step=n + 1, acc_grads=acc)
        updates, state = self._inner(acc, state, params)
        return updates, dataclasses.replace(
            state, mini_step=0, acc_grads=[torch.zeros_like(a) for a in acc])

    def _inner(self, g: List[torch.Tensor], state: OptState,
               params: List[torch.Tensor]) -> Tuple[List[torch.Tensor], OptState]:
        c = self.cfg
        if c.clip_norm > 0:
            g = clip_by_global_norm(g, c.clip_norm)
        b1, b2 = c.adam_betas
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul(state.mu, b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                                torch._foreach_mul(state.nu, b2))
        count = state.count + 1
        one = torch.ones((), dtype=torch.float32)
        bc1 = float(1 - (one * b1) ** count)       # float32, as optax computes it
        bc2 = float(1 - (one * b2) ** count)
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)),
                                   c.adam_eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        if c.weight_decay > 0:
            u = torch._foreach_add(u, torch._foreach_mul(params, c.weight_decay))
        u = torch._foreach_mul(torch._foreach_mul(u, self.schedule(state.count)), -1.0)
        return u, dataclasses.replace(state, count=count, mu=mu, nu=nu)


def make_optimizer(opt: OptimizationConfig) -> Optimizer:
    return Optimizer(opt)


@dataclasses.dataclass
class TrainState:
    """The counterpart of ``TrainState`` (`trainer.py:40-54`): the model's
    parameters and BatchNorm running statistics by name (the model's own
    tensors, updated in place), the optimizer state and the count of train
    step calls."""

    params: Tensors
    batch_stats: Tensors
    opt_state: OptState
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, tx: Optimizer) -> "TrainState":
        params = dict(model.named_parameters())
        stats = {n: b for n, b in model.named_buffers() if n.endswith(_STAT_NAMES)}
        return cls(params=params, batch_stats=stats,
                   opt_state=tx.init(list(params.values())), step=0)


def rdrop_kl(logits1: torch.Tensor, logits2: torch.Tensor,
             mt_targets: torch.Tensor) -> torch.Tensor:
    """R-Drop's symmetric KL over the MT logits of two dropout passes, summed
    over non-PAD targets (`trainer.py:122-126`)."""
    p = torch.log_softmax(logits1.to(torch.float32), dim=-1)
    q = torch.log_softmax(logits2.to(torch.float32), dim=-1)
    valid = (mt_targets != 1)[..., None]
    return 0.5 * torch.sum((torch.exp(p) * (p - q) + torch.exp(q) * (q - p)) * valid)


def make_train_step(model: StreamSpeechModel, tx: Optimizer, unit_blank: int,
                    weights: CriterionWeights = CriterionWeights(),
                    rdrop_alpha: float = 0.0,
                    specaugment_cfg: Optional[Dict[str, Any]] = None,
                    kernel_attention: bool = False) -> Callable:
    """Returns ``train_step(state, batch, generator, chunk_size,
    conv_chunk_size) -> (state, metrics)`` (`trainer.py:74-162`) for a state
    made by ``TrainState.create(model, tx)``.

    ``batch`` holds tensors on the model's device (``synthetic.batch_to_tensors``)
    and the int ``n2``; ``generator`` is a ``torch.Generator`` on that device,
    the counterpart of the dropout rng, required when dropout or SpecAugment
    is on. The forward runs with ``deterministic=False`` and
    ``use_running_stats=False`` (k1=0, n1=1, k2=0, streaming). ``rdrop_alpha
    > 0`` adds R-Drop: a second dropout pass and the symmetric KL on the MT
    logits; the BatchNorm statistics of the first pass are kept. After the
    step each parameter's ``.grad`` holds its guarded gradient. Metrics: the
    criterion's, ``grad_norm``, ``overflow`` and ``loss_mean`` (0-dim tensors
    on the device; nothing waits for the device).

    ``kernel_attention=True`` is the counterpart of the JAX package's
    ``STREAMSPEECH_PALLAS_TRAIN=1``: training's attention takes the kernel
    routes (rel-pos, causal and bias attention, forward and backward, the
    attention-probability dropout drawn inside the kernels) wherever their
    gates admit the shape. It is set on the model's attention modules here
    (``set_kernel_train``), on or off; off, the step is the plain route's.

    The step computes in the model's dtype: a bf16 model
    (``StreamSpeechModel(cfg, dtype=torch.bfloat16)``) is the counterpart of
    the JAX step over ``build_full_model(dtype=jnp.bfloat16)``, the trainer's
    design point (`trainer.py:8`: bf16 compute, fp32 params and optimizer, no
    loss scaler). Its ``Dense`` layers cast their fp32 parameters at every
    call, so each gradient reaches its fp32 parameter through that cast, as
    with flax; the losses widen the logits to fp32 (`criterion.py:35`,
    `ops/ctc.py:60-66`); the guard, the clip and Adam run in fp32 on the fp32
    parameters. A model whose weights ``layers.cast_compute_weights_`` cast
    for serving is refused."""
    if model.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"make_train_step on a {model.dtype} model: the step "
                                  "computes in float32 or bfloat16")
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise ValueError("make_train_step needs float32 parameters: this model's were "
                         "cast for serving (layers.cast_compute_weights_)")
    set_kernel_train(model, kernel_attention)

    def forward(batch, generator, chunk_size, conv_chunk_size):
        src = batch["src_tokens"]
        if specaugment_cfg is not None:
            if generator is None:
                raise ValueError("SpecAugment needs a torch.Generator")
            draws = specaugment_draws(
                generator, batch["src_lengths"], src.shape[-1],
                freq_mask_n=specaugment_cfg.get("freq_mask_N", 1),
                freq_mask_f=specaugment_cfg.get("freq_mask_F", 27),
                time_mask_n=specaugment_cfg.get("time_mask_N", 1),
                time_mask_t=specaugment_cfg.get("time_mask_T", 100),
                time_mask_p=specaugment_cfg.get("time_mask_p", 1.0))
            src = specaugment_apply(src, draws)
        return model(src, batch["src_lengths"], batch["prev_output_tokens_mt"],
                     chunk_size=chunk_size, conv_chunk_size=conv_chunk_size, k1=0,
                     n1=1, k2=0, n2=int(batch["n2"]), streaming=True,
                     deterministic=False, use_running_stats=False, generator=generator)

    def loss_fn(state, batch, generator, chunk_size, conv_chunk_size):
        out = forward(batch, generator, chunk_size, conv_chunk_size)
        metrics = streamspeech_loss(out, batch, unit_blank, weights)
        if rdrop_alpha > 0:
            first_stats = {n: b.clone() for n, b in state.batch_stats.items()}
            out2 = forward(batch, generator, chunk_size, conv_chunk_size)
            with torch.no_grad():
                for n, b in state.batch_stats.items():
                    b.copy_(first_stats[n])
            kl = rdrop_kl(out["mt_logits"], out2["mt_logits"], batch["mt_targets"])
            metrics = dict(metrics, rdrop_kl=kl,
                           loss=metrics["loss"] + rdrop_alpha * kl)
        return metrics["loss"] / metrics["sample_size"].to(torch.float32), metrics

    def train_step(state: TrainState, batch, generator: Optional[torch.Generator],
                   chunk_size: Optional[int], conv_chunk_size: Optional[int]):
        params = list(state.params.values())
        for p in params:
            p.grad = None
        loss, metrics = loss_fn(state, batch, generator, chunk_size, conv_chunk_size)
        loss.backward()
        grads, gnorm, finite = guard_nonfinite(
            [torch.zeros_like(p) if p.grad is None else p.grad for p in params])
        updates, state.opt_state = tx.update(grads, state.opt_state, params)
        with torch.no_grad():
            if updates is not None:
                torch._foreach_add_(params, updates)
            for p, g in zip(params, grads):
                p.grad = g
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(grad_norm=gnorm.detach(), overflow=~finite,
                       loss_mean=loss.detach())
        return state, metrics

    return train_step
