"""Registries of the streaming agents and the evaluation scorers, by name (the
counterpart of ``streamspeech_tpu/registry.py:17`` ``Registry``, kept here so
that the port imports nothing of the JAX package). The port's agents,
latency scorers and quality scorers register under the JAX package's names."""

from __future__ import annotations

from typing import Callable, Dict, Generic, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            if name in self._items:
                raise ValueError(f"{self.kind} '{name}' already registered")
            self._items[name] = obj
            return obj

        return deco

    def get(self, name: str) -> T:
        if name not in self._items:
            raise KeyError(f"unknown {self.kind} '{name}'; available: {sorted(self._items)}")
        return self._items[name]

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def names(self):
        return sorted(self._items)


AGENTS: Registry = Registry("agent")
LATENCY_SCORERS: Registry = Registry("latency_scorer")
QUALITY_SCORERS: Registry = Registry("quality_scorer")
