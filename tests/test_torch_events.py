"""The event recorder in the port against the JAX package's.

The port's `Recorder` prunes its dedupe map once the map has doubled since
the last prune, where the reference copies the whole map on every publish
past 4096 entries: a 50k-pod batch's `Nominated` events made that
quadratic (minutes inside one reconcile). Both must publish exactly the
same events on the same sequence — duplicates inside the TTL dropped,
expired keys published again, rate limits applied — and the port must
prune a logarithmic number of times.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

J, T = "karpenter_tpu", "karpenter_tpu_torch"


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class _Obj:
    def __init__(self, name):
        self.metadata = type("Meta", (), {"name": name})()


def published(pkg: str, seed: int, n: int) -> list:
    """A seeded stream of `n` events — distinct keys, repeats inside and
    past the TTL, a rate-limited reason — through one recorder."""
    rec_mod = _m(pkg, "events.recorder")
    clock = _m(pkg, "utils.clock").FakeClock()
    recorder = rec_mod.Recorder(clock=clock)
    recorder.rate_limit("Limited", rate=2.0, burst=5)
    rng = np.random.RandomState(seed)
    for i in range(n):
        roll = rng.rand()
        if roll < 0.6:
            ev = rec_mod.Event(_Obj(f"pod-{i}"), "Normal", "Nominated", f"nominated {i}")
        elif roll < 0.9:
            j = int(rng.randint(max(1, i)))
            ev = rec_mod.Event(_Obj(f"pod-{j}"), "Normal", "Nominated", f"nominated {j}")
        else:
            ev = rec_mod.Event(None, "Warning", "Limited", "limited",
                               dedupe_values=(str(rng.randint(50)),))
        recorder.publish(ev)
        clock.step(float(rng.exponential(0.04)))
    return [
        (getattr(e.involved_object, "metadata", None) and e.involved_object.metadata.name,
         e.reason, e.message, e.timestamp)
        for e in recorder.events
    ]


@pytest.mark.parametrize("seed", [0, 1])
def test_recorder_publishes_as_the_reference(seed):
    # 6,000 events over ~240 s of virtual time: past 4096 keys in the map,
    # and keys expiring out of the 120 s window
    want = published(J, seed, 6_000)
    assert len(want) > 4096
    assert published(T, seed, 6_000) == want


def test_recorder_prunes_a_logarithmic_number_of_times():
    counts = {}
    for pkg in (J, T):
        rec_mod = _m(pkg, "events.recorder")
        prunes = [0]

        class Counting(rec_mod.Recorder):
            def __setattr__(self, name, value):
                if name == "_seen" and hasattr(self, "_seen"):
                    prunes[0] += 1
                super().__setattr__(name, value)

        recorder = Counting(clock=_m(pkg, "utils.clock").FakeClock())
        for i in range(6_000):  # one batch: every key live
            recorder.publish(rec_mod.Event(_Obj(f"pod-{i}"), "Normal", "Nominated", "n"))
        assert len(recorder.events) == 6_000
        counts[pkg] = prunes[0]
    assert counts[J] == 6_000 - 4096  # the reference: a copy on every publish past 4096
    assert counts[T] == 1  # at 4096 keys; the next at 8192
