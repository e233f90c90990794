"""The general generator of pod traffic: plain data from a configuration's
pod mix, a traffic file's parameters and the run's seed. It imports
nothing of the program; the loops turn its demands into the program's
objects and hand the same demands to the reference.

The pod mix is upstream's generic pods (scheduling_benchmark_test.go
`makeGenericPods`): each pod one label `my-label` (`randomLabels`), a cpu
request (`randomCPU`) and a memory request (`randomMemory`), each drawn
uniformly from the configuration's lists. A population of such pods is
drawn once with `RandomState(shape_seed)`; a run's seed permutes it, so
every seed brings the same multiset of pods in another order.
"""

from __future__ import annotations

import itertools
import zlib
from collections import namedtuple

import numpy as np

# one pending pod: its uid, creation time and shape (an index into the shapes)
Demand = namedtuple("Demand", "uid ts shape")


def shape_draws(mix: dict):
    """[(labels, cpu, memory)], every combination of the mix's lists, and
    the population's picks: per pod a label value, a cpu and a memory,
    each uniform, drawn with RandomState(mix["shape_seed"])."""
    key, values = mix["label"]["key"], mix["label"]["values"]
    cpus, mems = mix["cpus"], mix["mems"]
    shapes = [({key: v}, c, m) for v, c, m in itertools.product(values, cpus, mems)]
    rng = np.random.RandomState(mix["shape_seed"])
    n = mix["population"]
    label, cpu, mem = (rng.randint(len(x), size=n) for x in (values, cpus, mems))
    return shapes, (label * len(cpus) + cpu) * len(mems) + mem


class PodTraffic:
    """The demands of one run. `sequence` is the population's picks in the
    order of the run's seed; the backlog is its first `backlog` pods, a
    batch its first `arrivals.pods`; single-shape arrivals draw their shape
    at the population's frequencies from a second stream of the seed."""

    def __init__(self, mix: dict, traffic: dict, seed: int):
        self.shapes, picks = shape_draws(mix)
        rng = np.random.default_rng([seed, 0])
        self.sequence = picks[rng.permutation(picks.size)]
        self.freq = np.bincount(picks, minlength=len(self.shapes)) / picks.size
        self.arrival_rng = np.random.default_rng([seed, 1])
        self.traffic = traffic

    def backlog(self) -> list:
        """The standing backlog, oldest first: created before any arrival."""
        n = self.traffic["backlog"]
        return [Demand(f"q{i:06d}", float(i % 13) - 13.0, int(self.sequence[i])) for i in range(n)]

    def arrivals(self, k: int) -> list:
        """Pass k's arrivals, created at time k (after the backlog)."""
        spec = self.traffic["arrivals"]
        n = spec["pods"]
        if spec["kind"] == "batch":
            # the run's batch, as new pods: uids carry the pass, and sort as
            # the batch's own do
            return [Demand(f"b{k:05d}-{i:06d}", float(i % 13), int(self.sequence[i])) for i in range(n)]
        if spec["kind"] == "one_shape":
            s = int(self.arrival_rng.choice(len(self.shapes), p=self.freq))
            return [Demand(f"a{k:06d}-{j:03d}", float(k), s) for j in range(n)]
        raise ValueError(f"unknown arrival kind {spec['kind']!r}")

    def departures(self, pending: list) -> int:
        """How many of the oldest pending pods leave after a pass."""
        d = self.traffic["departures"]
        return len(pending) if d == "all" else int(d)


def compared(traffic: dict, seed: int, k: int, drawn: int) -> bool:
    """Whether measured pass k's decisions are judged, `drawn` passes
    having been: the first and passes drawn from the seed (one in
    `one_in`), at most `max` in all."""
    how = traffic["compare"]
    return drawn < how["max"] and (drawn == 0 or zlib.crc32(f"{seed}:{k}".encode()) % how["one_in"] == 0)


def canonical_uid(uid: str) -> str:
    """A batch pod's uid without its pass: `b00012-000345` -> `000345`."""
    return uid.split("-", 1)[1] if uid.startswith("b") else uid
