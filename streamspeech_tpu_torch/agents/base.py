"""SimulEval-style agent surface: segments, actions, states, and a generic agent
with ``push``/``pop``/``pushpop`` (`SimulEval/simuleval/agents/agent.py:18-216`,
`simuleval/data/segments.py:11-52`). The same protocol as
``streamspeech_tpu/agents/base.py``, kept here so the port imports nothing of
the JAX package."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class Segment:
    index: int = 0
    content: Any = None
    sample_rate: int = -1
    finished: bool = False
    is_empty: bool = False
    data_type: str = ""
    # the source position (ms) at which the write was decided: the overlapped
    # (pipelined) agent sees a chunk's write a few calls after it was
    # decided, so its delays name the decision, as the synchronous path's
    # do; None = the evaluator's current position
    decision_ms: Any = None

    def json(self) -> str:
        """The segment as JSON, the wire form of ``eval/service.py`` (numpy
        samples as floats). Unlike JAX's (`agents/base.py:37-42`) it carries
        ``decision_ms``, so a remote overlapped agent's delays name its
        decisions."""
        return json.dumps({
            "index": self.index, "content": self.content,
            "sample_rate": self.sample_rate, "finished": self.finished,
            "is_empty": self.is_empty, "data_type": self.data_type,
            "decision_ms": self.decision_ms,
        }, default=float)

    @classmethod
    def from_json(cls, s: str) -> "Segment":
        d = json.loads(s)
        klass = {"text": TextSegment, "speech": SpeechSegment}.get(d.get("data_type", ""), cls)
        if d.get("is_empty"):
            klass = EmptySegment
        return klass(**{k: v for k, v in d.items() if k in klass.__dataclass_fields__})


@dataclass
class EmptySegment(Segment):
    is_empty: bool = True


@dataclass
class TextSegment(Segment):
    content: str = ""
    data_type: str = "text"


@dataclass
class SpeechSegment(Segment):
    content: List[float] = field(default_factory=list)
    sample_rate: int = 16000
    data_type: str = "speech"


class Action:
    def is_read(self) -> bool:
        raise NotImplementedError


class ReadAction(Action):
    def is_read(self) -> bool:
        return True


class WriteAction(Action):
    def __init__(self, content: Any, finished: bool = False):
        self.content = content
        self.finished = finished

    def is_read(self) -> bool:
        return False


class AgentStates:
    """Incremental source/target bookkeeping (`simuleval/agents/states.py`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.source: List[Any] = []
        self.target: List[Any] = []
        self.source_sample_rate = 0
        self.target_sample_rate = 0
        self.source_finished = False
        self.target_finished = False

    def update_source(self, segment: Segment):
        self.source_finished = segment.finished
        if segment.is_empty:
            return
        if segment.data_type == "speech":
            self.source_sample_rate = segment.sample_rate
            self.source += segment.content
        else:
            self.source.append(segment.content)

    def update_target(self, segment: Segment):
        self.target_finished = segment.finished
        if segment.is_empty:
            return
        if segment.data_type == "speech":
            self.target_sample_rate = segment.sample_rate
            self.target += segment.content
        else:
            self.target.append(segment.content)


class GenericAgent:
    source_type: Optional[str] = None
    target_type: Optional[str] = None

    def __init__(self):
        self.states = AgentStates()
        self.reset()

    def reset(self) -> None:
        self.states.reset()

    def policy(self) -> Action:
        raise NotImplementedError

    def push(self, source_segment: Segment) -> None:
        """Receive a new source segment (no output)."""
        self.states.update_source(source_segment)

    def pop(self) -> Segment:
        """Run the policy once; return a (possibly empty) target segment."""
        action = self.policy()
        if action.is_read():
            return EmptySegment(finished=self.states.target_finished)
        segment = action.content
        segment.finished = segment.finished or action.finished
        self.states.update_target(segment)
        return segment

    def pushpop(self, segment: Segment) -> Segment:
        self.push(segment)
        return self.pop()


class SpeechToSpeechAgent(GenericAgent):
    source_type = "speech"
    target_type = "speech"


class SpeechToTextAgent(GenericAgent):
    source_type = "speech"
    target_type = "text"


def stream_utterance(agent: GenericAgent, samples, segment_size_ms: int = 320,
                     sample_rate: int = 16000, max_turns: int = 100000):
    """Drive ``agent`` over one utterance the way SimulEval's sentence-level
    evaluator does: reset, then push fixed-size source segments (the last one
    finished, then empty finished segments) and pop after each, until the agent
    writes a finished segment. Yields each popped segment."""
    agent.reset()
    num = int(segment_size_ms * sample_rate / 1000)
    step = 0
    for _ in range(max_turns):
        if step < len(samples):
            chunk = list(samples[step:step + num])
            step = min(step + num, len(samples))
            segment = SpeechSegment(content=chunk, sample_rate=sample_rate,
                                    finished=step >= len(samples))
        else:
            segment = EmptySegment(finished=True)
        out = agent.pushpop(segment)
        yield out
        if step >= len(samples) and out.finished:
            return
    raise RuntimeError(f"agent did not finish within {max_turns} turns")
