"""The comparison that decides `correct`: what the timed path decided,
held against the plain reference on the same inputs.

The number compared is the decision mismatch of a compared unit: how many
of the program's NodeClaims (pods, instance-type options, requirements),
pod errors (by uid) and existing-node joins the reference does not make,
plus how many of the reference's the program does not make. Its limit is
0: an exact comparison. The largest mismatch over the compared units is
reported.
"""

from __future__ import annotations

import time
from collections import Counter

from benchmark.harness.traffic import canonical_uid
from benchmark.reference import catalog as refcat
from benchmark.reference import provisioning as refprov
from benchmark.reference import OutOfScope, quantity

LIMITS = {"decision_mismatch": 0}


def _diff(got, want) -> int:
    """Items of either list that the other lacks, counted with repeats."""
    a, b = Counter(got), Counter(want)
    return sum(((a - b) + (b - a)).values())


def mismatch(got: dict, want: dict) -> int:
    return sum(_diff(got[key], want[key]) for key in ("claims", "errors", "joins"))


def reference_pods(shapes, demands) -> list:
    parsed = [(quantity.parse(cpu), quantity.parse(mem)) for _labels, cpu, mem in shapes]
    return [refprov.Pod(canonical_uid(d.uid), d.ts, *parsed[d.shape]) for d in demands]


def provisioning_reference(config: dict, ignore_pod_slots: bool = False):
    if len(config["nodepools"]) != 1 or config.get("nodes"):
        raise OutOfScope("the provisioning reference takes one NodePool and an empty cluster")
    pool = config["nodepools"][0]
    cat = refcat.kwok_catalog(config["catalog"])
    return refprov.Provisioning(cat, {config["catalog"]["nodepool_label"]: pool["name"]},
                                ignore_pod_slots=ignore_pod_slots)


def judge_provisioning(config: dict, shapes, kept: list) -> dict:
    """kept: [(demands, decisions)] -> the checks and what was compared."""
    t0 = time.perf_counter()
    ref = provisioning_reference(config)
    cache: dict = {}
    worst = 0
    for demands, got in kept:
        pods = reference_pods(shapes, demands)
        key = tuple(p.uid for p in pods)
        want = cache.get(key)
        if want is None:
            want = cache[key] = ref.solve(pods)
        worst = max(worst, mismatch(got, want))
    return {
        "checks": {"decision_mismatch": {"value": worst, "limit": LIMITS["decision_mismatch"]}},
        "compared": len(kept),
        "reference_solves": len(cache),
        "reference_s": time.perf_counter() - t0,
    }
