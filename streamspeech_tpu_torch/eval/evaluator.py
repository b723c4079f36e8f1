"""Sentence-level streaming evaluator (``streamspeech_tpu/eval/evaluator.py``;
reference `SimulEval/simuleval/evaluator/evaluator.py:28-262`): for each
instance, send_source(segment_size) → agent.pushpop → receive_prediction until
the target finishes; write ``instances.log`` (JSONL) and ``scores.tsv``; resume
by skipping the indices already in the log (``continue_unfinished``).

The port has no quality scorer yet (BLEU, ASR_BLEU, WER: ROADMAP §A item 7):
naming one raises a ``ValueError``, and ``quality_metrics=[]`` scores latency
alone. Text-source agents (``TextToTextInstance``) come with the text agents.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from streamspeech_tpu_torch.agents.base import GenericAgent
from streamspeech_tpu_torch.eval.instance import (
    Instance,
    SpeechOutputInstance,
    TextOutputInstance,
)
from streamspeech_tpu_torch.eval.latency import build_scorers
from streamspeech_tpu_torch.registry import QUALITY_SCORERS

DEFAULT_LATENCY = ["AL", "LAAL", "AP", "DAL", "ATD", "NumChunks", "StartOffset",
                   "EndOffset", "RTF"]
SPEECH_ONLY = ["DiscontinuitySum", "DiscontinuityAve", "DiscontinuityNum"]


def build_quality_scorers(names: List[str]) -> dict:
    """{name: scorer} of the port's quality scorers; a name it lacks raises."""
    missing = [n for n in names if n not in QUALITY_SCORERS]
    if missing:
        raise ValueError(f"quality scorer(s) {missing} are not ported yet "
                         "(ROADMAP §A item 7); pass quality_metrics=[] to score "
                         "latency alone")
    return {n: QUALITY_SCORERS.get(n)() for n in names}


class SentenceLevelEvaluator:
    """Scores every latency metric of ``DEFAULT_LATENCY`` (and ``SPEECH_ONLY``
    for a speech-output agent) and the named quality metrics."""

    MAX_TURNS = 10000       # segments an instance at most

    def __init__(
        self,
        agent: GenericAgent,
        source_segment_size: int = 320,     # ms
        quality_metrics: Optional[List[str]] = None,
        output_dir: Optional[str] = None,
    ):
        if getattr(agent, "source_type", "speech") == "text":
            raise NotImplementedError("text-source agents (TextToTextInstance) are "
                                      "not ported yet")
        self.agent = agent
        self.source_segment_size = source_segment_size
        self.output_dir = output_dir
        self.speech_output = agent.target_type == "speech"
        self.latency_scorers = build_scorers(
            DEFAULT_LATENCY + (SPEECH_ONLY if self.speech_output else []))
        qnames = quality_metrics if quality_metrics is not None else (
            ["ASR_BLEU"] if self.speech_output else ["BLEU"])
        self.quality_scorers = build_quality_scorers(qnames)
        self.instances: Dict[int, Instance] = {}
        if output_dir:
            Path(output_dir).mkdir(parents=True, exist_ok=True)

    def _make_instance(self, index, source, reference, sample_rate) -> Instance:
        cls = SpeechOutputInstance if self.speech_output else TextOutputInstance
        return cls(index, source, reference, sample_rate=sample_rate,
                   output_dir=self.output_dir)

    def _done_indices(self) -> set:
        if not self.output_dir:
            return set()
        log = Path(self.output_dir) / "instances.log"
        if not log.exists():
            return set()
        done = set()
        for line in log.read_text().splitlines():
            try:
                done.add(json.loads(line)["index"])
            except (ValueError, KeyError, TypeError):
                pass        # a line cut short by an interrupted run
        return done

    def _open_log(self, continue_unfinished: bool):
        if not self.output_dir:
            return None
        return open(Path(self.output_dir) / "instances.log",
                    "a" if continue_unfinished else "w")

    def run_instance(self, instance: Instance) -> dict:
        self.agent.reset()
        turns = 0
        while not instance.finish_prediction and turns < self.MAX_TURNS:
            segment = instance.send_source(self.source_segment_size)
            out = self.agent.pushpop(segment)
            instance.receive_prediction(out)
            turns += 1
            if instance.source_finished_reading and out.finished:
                break
        return instance.summarize()

    def __call__(self, sources: Sequence, references: Sequence[str],
                 sample_rate: int = 16000, continue_unfinished: bool = False
                 ) -> Dict[str, float]:
        done = self._done_indices() if continue_unfinished else set()
        log_f = self._open_log(continue_unfinished)
        for i, (src, ref) in enumerate(zip(sources, references)):
            if i in done:
                continue
            ins = self._make_instance(i, src, ref, sample_rate)
            summary = self.run_instance(ins)
            self.instances[i] = ins
            if log_f:
                log_f.write(json.dumps(summary) + "\n")
                log_f.flush()
        if log_f:
            log_f.close()
        return self.scores()

    def score_only(self) -> Dict[str, float]:
        """Score a previous run's ``instances.log`` without running the agent
        (the reference's --score-only, `evaluator.py:145-160`). The rebuilt
        source is used for its length alone (16 samples a ms at 16 kHz)."""
        if not self.output_dir:
            raise ValueError("score_only needs output_dir with an instances.log")
        log = Path(self.output_dir) / "instances.log"
        self.instances = {}
        for line in log.read_text().splitlines():
            d = json.loads(line)
            cls = SpeechOutputInstance if "durations" in d else TextOutputInstance
            src_samples = [0.0] * int(d["source_length"] * 16)
            ins = cls(d["index"], src_samples, d.get("reference"),
                      output_dir=self.output_dir)
            ins.delays = d.get("delays", [])
            ins.elapsed = d.get("elapsed", [])
            ins.finish_prediction = True
            if isinstance(ins, SpeechOutputInstance):
                ins.durations = d.get("durations", [])
                ins.intervals = d.get("intervals", [])
                ins.silences = [max(b0 - (a0 + a1), 0.0) for (a0, a1), (b0, _)
                                in zip(ins.intervals, ins.intervals[1:]) if b0 > a0 + a1]
                ins.target_sample_rate = 16000
            else:
                ins.prediction_list = str(d.get("prediction", "")).split()
            self.instances[d["index"]] = ins
        return self.scores()

    def scores(self) -> Dict[str, float]:
        """Every scorer over the instances; a scorer that cannot score them
        (no delays, a zero-length source) gives nan, as in SimulEval."""
        results: Dict[str, float] = {}
        for name, scorer in {**self.quality_scorers, **self.latency_scorers}.items():
            try:
                results[name] = scorer(self.instances)
            except (ArithmeticError, IndexError, ValueError):
                results[name] = float("nan")
        if self.output_dir:
            with open(Path(self.output_dir) / "scores.tsv", "w") as f:
                f.write("\t".join(results.keys()) + "\n")
                f.write("\t".join(f"{v:.3f}" if v == v else "nan"
                                  for v in results.values()) + "\n")
        return results
