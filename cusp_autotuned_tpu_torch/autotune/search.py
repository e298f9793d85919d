"""Searchers and stop conditions (counterpart of
cusp_autotuned_tpu/autotune/search.py; parity: KTT's DeterministicSearcher /
RandomSearcher and StopCondition, testing/ktt.cu:46-81).  The JAX package's
ModelGuidedSearcher waits for the port's cost model."""

from __future__ import annotations

import random
import time
from typing import Dict, List


class Searcher:
    def order(self, configurations: List[Dict]) -> List[Dict]:
        raise NotImplementedError


class DeterministicSearcher(Searcher):
    def order(self, configurations):
        return list(configurations)


class RandomSearcher(Searcher):
    def __init__(self, seed: int = 0):
        self.seed = seed

    def order(self, configurations):
        out = list(configurations)
        random.Random(self.seed).shuffle(out)
        return out


class StopCondition:
    """Override initialize/update/fulfilled; tuning stops when fulfilled."""

    def initialize(self, num_configurations: int) -> None:
        pass

    def update(self, result) -> None:
        pass

    def fulfilled(self) -> bool:
        return False


class ConfigurationCount(StopCondition):
    def __init__(self, count: int):
        self.count = count
        self._seen = 0

    def initialize(self, num_configurations):
        self._seen = 0

    def update(self, result):
        self._seen += 1

    def fulfilled(self):
        return self._seen >= self.count


class ConfigurationFraction(StopCondition):
    def __init__(self, fraction: float):
        self.fraction = fraction
        self._seen = 0
        self._total = 0

    def initialize(self, num_configurations):
        self._total = num_configurations
        self._seen = 0

    def update(self, result):
        self._seen += 1

    def fulfilled(self):
        return self._total > 0 and self._seen / self._total >= self.fraction


class TuningDuration(StopCondition):
    def __init__(self, seconds: float):
        self.seconds = seconds
        self._start = None

    def initialize(self, num_configurations):
        self._start = time.perf_counter()

    def fulfilled(self):
        return (self._start is not None
                and time.perf_counter() - self._start >= self.seconds)
