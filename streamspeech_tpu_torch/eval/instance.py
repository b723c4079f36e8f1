"""Per-sentence streaming-evaluation state (``streamspeech_tpu/eval/instance.py``;
reference `SimulEval/simuleval/evaluator/instance.py:26-419`):
- delays: the source position (ms) at each emission;
- elapsed: computation-aware timestamps, source ms plus the wall clock since the
  first read (`instance.py:318-319` step_to_elapsed), read by every ``_CA``
  latency twin;
- speech output: per-emission durations, the waveform stitched on the source
  timeline with silence at discontinuities (`instance.py:344-371`), intervals,
  and a wav file;
- text input (``TextToTextInstance``): one source token a read, delays in
  tokens.
"""

from __future__ import annotations

import time
import wave
from pathlib import Path
from typing import List, Optional

import numpy as np

from streamspeech_tpu_torch.agents.base import (
    EmptySegment,
    Segment,
    SpeechSegment,
    TextSegment,
)


def write_wav(path, samples: np.ndarray, sample_rate: int):
    """16-bit PCM mono wav through the standard library's ``wave``."""
    x = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


class Instance:
    def __init__(self, index: int, source, reference: Optional[str],
                 sample_rate: int = 16000, latency_unit: str = "word",
                 output_dir: Optional[str] = None):
        self.index = index
        self.samples = source          # speech: a list of floats
        self.reference = reference
        self.sample_rate = sample_rate
        self.latency_unit = latency_unit
        self.output_dir = output_dir
        self.step = 0                  # samples sent so far
        self.start_time: Optional[float] = None
        self.delays: List[float] = []
        self.elapsed: List[float] = []
        self.prediction_list: List = []
        self.finish_prediction = False
        self.source_finished_reading = False
        self.metrics = {}

    # -- source side ---------------------------------------------------

    @property
    def source_length(self) -> float:
        return self.len_sample_to_ms(len(self.samples))

    @property
    def reference_length(self) -> int:
        if self.latency_unit == "char":
            return len(self.reference or "")
        return len((self.reference or "").split())

    def len_sample_to_ms(self, n) -> float:
        return n * 1000.0 / self.sample_rate

    def send_source(self, segment_size_ms: int) -> Segment:
        if self.step == 0:
            self.start_time = time.time()
        num = int(segment_size_ms * self.sample_rate / 1000)
        if self.step < len(self.samples):
            samples = self.samples[self.step: self.step + num]
            finished = self.step + num >= len(self.samples)
            self.step = min(self.step + num, len(self.samples))
            self.source_finished_reading = finished
            return SpeechSegment(index=self.index, content=samples,
                                 sample_rate=self.sample_rate, finished=finished)
        self.source_finished_reading = True
        return EmptySegment(index=self.index, finished=True)

    def step_to_delay(self) -> float:
        return self.len_sample_to_ms(self.step)

    def step_to_elapsed(self, current_time: float) -> float:
        return self.len_sample_to_ms(self.step) + (current_time - self.start_time) * 1000.0

    # -- target side ---------------------------------------------------

    def receive_prediction(self, segment: Segment):
        raise NotImplementedError

    def summarize(self) -> dict:
        raise NotImplementedError


def _decision_ms(segment: Segment, instance: Instance) -> float:
    """The delay of a write: the segment's own decision position where it
    carries one, else the source sent so far."""
    ms = getattr(segment, "decision_ms", None)
    return ms if ms is not None else instance.step_to_delay()


class TextOutputInstance(Instance):
    @property
    def prediction(self) -> str:
        joined = " ".join(str(p) for p in self.prediction_list)
        if self.latency_unit == "word":
            return joined.replace("▁", " ").replace("  ", " ").strip()
        return joined

    def receive_prediction(self, segment: Segment):
        if self.start_time is None:
            self.start_time = time.time()
        if self.finish_prediction and self.source_finished_reading:
            return
        self.finish_prediction = segment.finished
        if segment.is_empty or not segment.content:
            return
        now = time.time()
        if self.latency_unit == "word":
            parts = str(segment.content).split()
        else:
            parts = list(str(segment.content).replace(" ", ""))
        delay = _decision_ms(segment, self)
        self.prediction_list += parts
        self.delays += [delay] * len(parts)
        self.elapsed += [self.step_to_elapsed(now)] * len(parts)

    def summarize(self) -> dict:
        return {
            "index": self.index,
            "prediction": self.prediction,
            "delays": self.delays,
            "elapsed": self.elapsed,
            "prediction_length": len(self.prediction_list),
            "source_length": self.source_length,
            "reference": self.reference,
        }


class TextToTextInstance(TextOutputInstance):
    """Text-input instance (`instance.py:141-175`; reference
    `SimulEval/simuleval/evaluator/instance.py:149-175` TextInputInstance +
    `:426` TextToTextInstance): the source is a token list, one token is sent
    per ``send_source`` call, delays are measured in tokens and the elapsed
    (computation-aware) axis is 0 by the reference's convention."""

    def __init__(self, index: int, source, reference: Optional[str],
                 sample_rate: int = 16000, latency_unit: str = "word",
                 output_dir: Optional[str] = None):
        if isinstance(source, str):
            source = source.split()
        super().__init__(index, list(source), reference, sample_rate=sample_rate,
                         latency_unit=latency_unit, output_dir=output_dir)

    @property
    def source_length(self) -> float:
        return float(len(self.samples))

    def step_to_delay(self) -> float:
        return float(self.step)

    def step_to_elapsed(self, current_time: float) -> float:
        return 0.0  # instance.py:157-158

    def send_source(self, segment_size_ms: int = 0) -> Segment:
        if self.start_time is None:
            self.start_time = time.time()
        if self.step >= len(self.samples):
            self.source_finished_reading = True
            return EmptySegment(index=self.index, finished=True)
        word = self.samples[self.step]
        self.step += 1
        finished = self.step >= len(self.samples)
        self.source_finished_reading = finished
        return TextSegment(index=self.index, content=word, finished=finished)


class SpeechOutputInstance(Instance):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.durations: List[float] = []
        self.intervals: List[List[float]] = []
        self.silences: List[float] = []
        self.target_sample_rate = -1
        self.stitched: Optional[np.ndarray] = None

    @property
    def wav_path(self) -> Optional[str]:
        if self.output_dir is None:
            return None
        d = Path(self.output_dir) / "wavs"
        d.mkdir(parents=True, exist_ok=True)
        return str((d / f"{self.index}_pred.wav").absolute())

    @property
    def prediction(self):
        return self.wav_path

    def receive_prediction(self, segment: Segment):
        if self.start_time is None:
            self.start_time = time.time()
        if self.finish_prediction and self.source_finished_reading:
            return
        self.finish_prediction = segment.finished
        if segment.is_empty or len(segment.content) == 0:
            return
        now = time.time()
        if self.target_sample_rate < 0:
            self.target_sample_rate = segment.sample_rate
        self.durations.append(1000.0 * len(segment.content) / segment.sample_rate)
        self.prediction_list.append(segment.content)
        self.elapsed.append(self.step_to_elapsed(now))
        self.delays.append(_decision_ms(segment, self))

    def summarize(self) -> dict:
        """Stitch the segments on the source timeline, with silence where a
        segment starts after the previous one ended (`instance.py:344-371`)."""
        samples: List[float] = []
        self.intervals = []
        self.silences = []
        if len(self.prediction_list) > 0:
            start = prev_end = prediction_offset = self.delays[0]
            for i, delay in enumerate(self.delays):
                start = max(prev_end, delay)
                if start > prev_end:
                    samples += [0.0] * int(self.target_sample_rate * (start - prev_end) / 1000)
                    self.silences.append(start - prev_end)
                samples += list(self.prediction_list[i])
                duration = self.durations[i]
                prev_end = start + duration
                self.intervals.append([start, duration])
            self.stitched = np.asarray(samples, np.float32)
            if self.wav_path is not None:
                write_wav(self.wav_path, self.stitched, self.target_sample_rate)
        else:
            prediction_offset = self.source_length
        return {
            "index": self.index,
            "prediction": self.wav_path,
            "delays": self.delays,
            "durations": self.durations,
            "prediction_offset": prediction_offset,
            "elapsed": self.elapsed,
            "intervals": self.intervals,
            "prediction_length": len(samples) / max(self.target_sample_rate, 1),
            "source_length": self.source_length,
            "reference": self.reference,
        }
