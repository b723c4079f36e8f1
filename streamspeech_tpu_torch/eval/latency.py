"""Latency scorers: AL, LAAL, AP, DAL, ATD, NumChunks, Discontinuity*, Start/End
Offset, RTF, each with a computation-aware (_CA) twin that reads the
wall-clock-adjusted timestamps (``streamspeech_tpu/eval/latency.py``; the
formulas of `SimulEval/simuleval/evaluator/scorers/latency_scorer.py:32-588`).
They register in the port's own ``registry.LATENCY_SCORERS``.
"""

from __future__ import annotations

from statistics import mean
from typing import Dict, List

from streamspeech_tpu_torch.eval.instance import Instance, SpeechOutputInstance
from streamspeech_tpu_torch.registry import LATENCY_SCORERS


class LatencyScorer:
    def __init__(self, computation_aware: bool = False, use_ref_len: bool = True):
        self.computation_aware = computation_aware
        self.use_ref_len = use_ref_len

    @property
    def timestamp_type(self):
        return "elapsed" if self.computation_aware else "delays"

    def get_delays_lengths(self, ins: Instance):
        delays = getattr(ins, self.timestamp_type)
        if not self.use_ref_len or ins.reference is None:
            tgt_len = len(delays)
        else:
            tgt_len = ins.reference_length
        return delays, ins.source_length, tgt_len

    def compute(self, ins: Instance) -> float:
        raise NotImplementedError

    def __call__(self, instances: Dict[int, Instance]) -> float:
        scores = []
        for _, ins in instances.items():
            delays = getattr(ins, self.timestamp_type, None)
            if not delays:
                continue
            scores.append(self.compute(ins))
        return mean(scores) if scores else float("nan")


@LATENCY_SCORERS.register("AL")
class ALScorer(LatencyScorer):
    """Average Lagging (`latency_scorer.py:114-164`)."""

    def compute(self, ins: Instance) -> float:
        delays, src_len, tgt_len = self.get_delays_lengths(ins)
        if delays[0] > src_len:
            return delays[0]
        gamma = tgt_len / src_len
        total, tau = 0.0, 0
        for t_minus_1, d in enumerate(delays):
            total += d - t_minus_1 / gamma
            tau = t_minus_1 + 1
            if d >= src_len:
                break
        return total / tau


@LATENCY_SCORERS.register("LAAL")
class LAALScorer(LatencyScorer):
    """Length-Adaptive Average Lagging (`latency_scorer.py:166-223`)."""

    def compute(self, ins: Instance) -> float:
        delays, src_len, tgt_len = self.get_delays_lengths(ins)
        if delays[0] > src_len:
            return delays[0]
        gamma = max(len(delays), tgt_len) / src_len
        total, tau = 0.0, 0
        for t_minus_1, d in enumerate(delays):
            total += d - t_minus_1 / gamma
            tau = t_minus_1 + 1
            if d >= src_len:
                break
        return total / tau


@LATENCY_SCORERS.register("AP")
class APScorer(LatencyScorer):
    """Average Proportion (`latency_scorer.py:225-254`)."""

    def compute(self, ins: Instance) -> float:
        delays, src_len, tgt_len = self.get_delays_lengths(ins)
        return sum(delays) / (src_len * tgt_len)


@LATENCY_SCORERS.register("DAL")
class DALScorer(LatencyScorer):
    """Differentiable Average Lagging (`latency_scorer.py:256-294`)."""

    def compute(self, ins: Instance) -> float:
        delays, src_len, _ = self.get_delays_lengths(ins)
        tgt_len = len(delays)
        gamma = tgt_len / src_len
        total, g_prime_last = 0.0, 0.0
        for i_minus_1, g in enumerate(delays):
            g_prime = g if i_minus_1 == 0 else max(g, g_prime_last + 1 / gamma)
            total += g_prime - i_minus_1 / gamma
            g_prime_last = g_prime
        return total / tgt_len


@LATENCY_SCORERS.register("ATD")
class ATDScorer(LatencyScorer):
    """Average Token Delay (`latency_scorer.py:296-482`). Tokens are carved from
    chunks: 300 ms per speech token; text output tokens have zero length."""

    SRC_TOKEN_LEN = 300

    def __call__(self, instances: Dict[int, Instance]) -> float:
        scores = []
        for _, ins in instances.items():
            if not getattr(ins, "delays", None):
                continue
            scores.append(self._compute_one(ins))
        return mean(scores) if scores else float("nan")

    def _compute_one(self, ins: Instance) -> float:
        speech_out = isinstance(ins, SpeechOutputInstance)
        tgt_token_len = 300 if speech_out else 0
        delays = list(ins.delays)

        if self.computation_aware and ins.elapsed and \
                ins.elapsed != [0] * len(delays):
            compute_elapsed = [e - d for e, d in zip(ins.elapsed, delays)]
            compute_times = [b - a for a, b in
                             zip([0] + compute_elapsed[:-1], compute_elapsed)]
        else:
            compute_times = [0] * len(delays)

        chunk_sizes = {"src": [0], "tgt": [0]}
        token_to_chunk = {"src": [0], "tgt": [0]}
        token_to_time = {"src": [0], "tgt": [0]}
        tgt_token_lens: List[float] = []
        delays_no_dup = sorted(set(delays), key=delays.index)

        if not speech_out:
            prev = None
            for d in delays:
                if d != prev:
                    chunk_sizes["tgt"].append(1)
                else:
                    chunk_sizes["tgt"][-1] += 1
                prev = d
            for i, cs in enumerate(chunk_sizes["tgt"][1:], 1):
                token_to_chunk["tgt"] += [i] * cs
            tgt_token_lens = [tgt_token_len] * len(delays)
        else:
            chunk_durations, chunk_ct = [], []
            prev = None
            for d, ct, dur in zip(delays, compute_times, ins.durations):
                if d != prev:
                    chunk_durations.append(dur)
                    chunk_ct.append(ct)
                else:
                    chunk_durations[-1] += dur
                    chunk_ct[-1] += ct
                prev = d
            s2s_delays, s2s_ct = [], []
            for i, cd in enumerate(chunk_durations, 1):
                n, rest = divmod(cd, tgt_token_len)
                token_lens = int(n) * [tgt_token_len] + ([rest] if rest else [])
                tgt_token_lens += token_lens
                chunk_sizes["tgt"] += [len(token_lens)]
                token_to_chunk["tgt"] += [i] * len(token_lens)
                s2s_delays += [delays_no_dup[i - 1]] * len(token_lens)
                s2s_ct += [chunk_ct[i - 1] / len(token_lens)] * len(token_lens)
            delays, compute_times = s2s_delays, s2s_ct

        src_chunk_durations = [b - a for a, b in
                               zip([0] + delays_no_dup[:-1], delays_no_dup)]
        for i, cd in enumerate(src_chunk_durations, 1):
            n, rest = divmod(cd, self.SRC_TOKEN_LEN)
            token_lens = int(n) * [self.SRC_TOKEN_LEN] + ([rest] if rest else [])
            chunk_sizes["src"] += [len(token_lens)]
            for tl in token_lens:
                token_to_time["src"].append(token_to_time["src"][-1] + tl)
                token_to_chunk["src"].append(i)

        for d, ct, tl in zip(delays, compute_times, tgt_token_lens):
            start = max(d, token_to_time["tgt"][-1])
            token_to_time["tgt"].append(start + tl + ct)

        tgt_to_src = []
        for t in range(1, len(token_to_chunk["tgt"])):
            chunk_id = token_to_chunk["tgt"][t]
            acc_x = sum(chunk_sizes["src"][:chunk_id])
            acc_y = sum(chunk_sizes["tgt"][:chunk_id])
            s = t - max(0, acc_y - acc_x)
            cur_src = sum(chunk_sizes["src"][: chunk_id + 1])
            tgt_to_src.append((t, min(s, cur_src)))

        atd = [token_to_time["tgt"][t] - token_to_time["src"][s]
               for t, s in tgt_to_src]
        return float(mean(atd)) if atd else 0.0


@LATENCY_SCORERS.register("NumChunks")
class NumChunksScorer(LatencyScorer):
    def compute(self, ins: Instance) -> float:
        return len(getattr(ins, self.timestamp_type))


@LATENCY_SCORERS.register("DiscontinuitySum")
class DiscontinuitySumScorer(LatencyScorer):
    def compute(self, ins: Instance) -> float:
        return sum(ins.silences)


@LATENCY_SCORERS.register("DiscontinuityAve")
class DiscontinuityAveScorer(LatencyScorer):
    def compute(self, ins: Instance) -> float:
        return sum(ins.silences) / len(ins.silences) if ins.silences else 0


@LATENCY_SCORERS.register("DiscontinuityNum")
class DiscontinuityNumScorer(LatencyScorer):
    def compute(self, ins: Instance) -> float:
        return len(ins.silences)


@LATENCY_SCORERS.register("StartOffset")
class StartOffsetScorer(LatencyScorer):
    def compute(self, ins: Instance) -> float:
        return getattr(ins, self.timestamp_type)[0]


@LATENCY_SCORERS.register("EndOffset")
class EndOffsetScorer(LatencyScorer):
    def compute(self, ins: Instance) -> float:
        delays, src_len, _ = self.get_delays_lengths(ins)
        if isinstance(ins, SpeechOutputInstance) and ins.intervals:
            delays = [start + dur for start, dur in ins.intervals]
        return delays[-1] - src_len


@LATENCY_SCORERS.register("RTF")
class RTFScorer(LatencyScorer):
    def compute(self, ins: Instance) -> float:
        delays, src_len, _ = self.get_delays_lengths(ins)
        if isinstance(ins, SpeechOutputInstance) and ins.intervals:
            delays = [start + dur for start, dur in ins.intervals]
        return delays[-1] / src_len


def build_scorers(names: List[str]):
    """names like ["AL", "AP", ...] → {name: scorer, name_CA: scorer}."""
    out = {}
    for name in names:
        cls = LATENCY_SCORERS.get(name)
        out[name] = cls(computation_aware=False)
        out[name + "_CA"] = cls(computation_aware=True)
    return out
