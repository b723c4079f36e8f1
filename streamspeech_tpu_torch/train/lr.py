"""LR schedules (``streamspeech_tpu/train/lr.py``). ``inverse_sqrt`` matches
`fairseq/fairseq/optim/lr_scheduler/inverse_square_root_schedule.py`: linear
warmup from warmup_init_lr to lr over warmup_updates, then
lr * sqrt(warmup_updates) / sqrt(step). Each schedule maps an update count to
the float32 learning rate that JAX computes, as a Python float."""

from __future__ import annotations

from typing import Callable

import torch

Schedule = Callable[[int], float]


def inverse_sqrt(lr: float, warmup_updates: int, warmup_init_lr: float = 1e-7
                 ) -> Schedule:
    decay_factor = lr * warmup_updates ** 0.5

    def schedule(step: int) -> float:
        step = max(int(step), 1)
        s = torch.tensor(step, dtype=torch.float32)
        if step < warmup_updates:
            return float(warmup_init_lr + s * (lr - warmup_init_lr) / warmup_updates)
        return float(decay_factor * s ** -0.5)

    return schedule


def fixed(lr: float, *_args, **_kw) -> Schedule:
    value = float(torch.tensor(lr, dtype=torch.float32))
    return lambda step: value
