"""Training metrics aggregation + progress logging (the port of
``streamspeech_tpu/utils/metrics.py``).

Lightweight equivalent of fairseq's logging stack (`fairseq/fairseq/logging/
{meters.py,metrics.py,progress_bar.py}`): named aggregation contexts with
average/sum meters, json-line progress output, and optional tensorboard
event files (JSONL is the durable format here).
"""

from __future__ import annotations

import json
import math
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0.0

    def update(self, val: float, n: float = 1.0):
        if val == val:  # skip NaN
            self.sum += val * n
            self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else math.nan


class TimeMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.start = time.perf_counter()
        self.n = 0.0

    def update(self, n: float = 1.0):
        self.n += n

    @property
    def rate(self) -> float:
        dt = time.perf_counter() - self.start
        return self.n / dt if dt > 0 else 0.0


class MetricsAggregator:
    def __init__(self):
        self._scopes: Dict[str, Dict[str, AverageMeter]] = defaultdict(
            lambda: defaultdict(AverageMeter))
        self._active = ["default"]

    @contextmanager
    def aggregate(self, name: str):
        self._active.append(name)
        try:
            yield self._scopes[name]
        finally:
            self._active.pop()

    def log_scalar(self, key: str, value: float, weight: float = 1.0):
        for scope in self._active:
            self._scopes[scope][key].update(float(value), weight)

    def get_smoothed_values(self, name: str) -> Dict[str, float]:
        return {k: m.avg for k, m in self._scopes[name].items()}

    def reset_scope(self, name: str):
        self._scopes[name].clear()


metrics = MetricsAggregator()


class JsonProgress:
    """fairseq --log-format json equivalent: one JSON line per log_interval."""

    def __init__(self, log_file: Optional[str] = None, stream=None,
                 tensorboard_logdir: Optional[str] = None):
        self.stream = stream or sys.stdout
        self.log_file = open(log_file, "a") if log_file else None
        self.tb = None
        if tensorboard_logdir:
            # fairseq TensorboardProgressBarWrapper analogue
            # (`fairseq/fairseq/logging/progress_bar.py:282-299`)
            from streamspeech_tpu_torch.utils.tensorboard import TensorboardWriter

            self.tb = TensorboardWriter(tensorboard_logdir)

    def log(self, stats: Dict[str, float], tag: str = "train",
            step: Optional[int] = None):
        payload = {"tag": tag, "step": step}
        payload.update({k: (round(v, 4) if isinstance(v, float) else v)
                        for k, v in stats.items()})
        line = json.dumps(payload)
        print(line, file=self.stream, flush=True)
        if self.log_file:
            self.log_file.write(line + "\n")
            self.log_file.flush()
        if self.tb is not None and step is not None:
            self.tb.add_scalars(tag, {k: v for k, v in stats.items()
                                      if isinstance(v, (int, float))}, step)
            self.tb.flush()
