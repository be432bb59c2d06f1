"""What a run records: its requests, their times, and a seeded sample of
their outputs for the comparison."""

from __future__ import annotations

import dataclasses
import random
import time

clock = time.perf_counter


@dataclasses.dataclass
class Request:
    index: int            # the traffic generator's request number
    t_sent: float         # the first enqueue
    t_done: float = 0.0   # the return of the last call of the request
    ok: bool = False
    images: int = 1
    match_s: float | None = None


@dataclasses.dataclass
class Window:
    t0: float
    t1: float = 0.0       # when the window closed: no request sent after
    requests: list = dataclasses.field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def done_in_window(self) -> list:
        return [r for r in self.requests if r.ok and r.t_done <= self.t1]


class Reservoir:
    """A uniform sample of ``k`` of the outputs offered, drawn from the
    seed (reservoir sampling), so that a run keeps only ``k`` outputs."""

    def __init__(self, k: int, seed: int) -> None:
        self.k = k
        self.rng = random.Random(seed)
        self.seen = 0
        self.items: list = []

    def offer(self, index: int, output) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((index, output))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = (index, output)
