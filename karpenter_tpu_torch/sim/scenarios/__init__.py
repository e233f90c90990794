"""Scenario library: named, seeded, replayable simulation setups.

A scenario is a name bound to a trace generator (sim/trace.py). Resolving a
scenario with a seed materializes the versioned JSON trace; running it is
`python -m karpenter_tpu_torch.sim --scenario <name> --seed <n>`. Identical seeds
yield byte-identical event-log digests, so a scenario+seed pair is a
regression fixture: diff the digest, then diff the logs.
"""

from __future__ import annotations

from random import Random
from typing import Callable

from karpenter_tpu_torch.sim import trace as tracemod

Generator = Callable[[Random], dict]

_REGISTRY: dict[str, tuple[Generator, str]] = {}


def register(name: str, generator: Generator, description: str) -> None:
    _REGISTRY[name] = (generator, description)


def names() -> list[str]:
    return sorted(_REGISTRY)


def describe() -> dict[str, str]:
    return {name: desc for name, (_, desc) in sorted(_REGISTRY.items())}


def resolve(name: str, seed: int) -> dict:
    """Materialize the scenario's trace for a seed."""
    if name not in _REGISTRY:
        known = ", ".join(names())
        raise KeyError(f"unknown scenario {name!r} (known: {known})")
    generator, _ = _REGISTRY[name]
    trace = generator(Random(f"scenario:{name}:{seed}"))
    return tracemod.validate(trace)


register(
    "steady-state",
    tracemod.steady_state,
    "constant service footprint, no faults — the baseline digest",
)
register(
    "spot-interruption",
    tracemod.spot_interruption,
    "spot-pinned pods under graceful interruption + hard capacity reclaim",
)
register(
    "diurnal",
    tracemod.diurnal,
    "sinusoidal web traffic: scale-up waves then consolidation",
)
register(
    "batch-waves",
    tracemod.batch_waves,
    "short-lived batch-job bursts; churn through provision/complete/consolidate",
)
register(
    "tpu-training",
    tracemod.tpu_training,
    "TPU-slice training gangs: zone topology-spread, arm64-pinned, long-running",
)
register(
    "capacity-pressure",
    tracemod.capacity_pressure,
    "limits-capped pool under overload + two exactly-unsatisfiable pods; the "
    "/debug/explain provenance fixture",
)
register(
    "flaky-cloud",
    tracemod.flaky_cloud,
    "launch failures, capacity errors, API latency, solver rejection storm",
)
register(
    "solverd-restart",
    tracemod.solverd_restart,
    "solver daemon restarts mid-trace; warm-starts from the AOT cache when configured",
)
register(
    "fleet-replica-kill",
    tracemod.fleet_replica_kill,
    "3 tenant clusters on a 2-replica solverd pool; one replica SIGKILLed mid-run",
)
register(
    "mesh-sweep",
    tracemod.mesh_sweep,
    "shape-diverse waves wide enough to engage the device sweep; the mesh-smoke "
    "scenario (digests match across --shard-devices sizes)",
)
register(
    "crash-churn",
    tracemod.crash_churn,
    "operator killed at every journal barrier class mid-churn; cold restarts "
    "recover from the write-ahead journal with zero double-launches",
)
register(
    "sustained-churn",
    tracemod.sustained_churn,
    "shape-stable ~1% replace-churn under a diurnal envelope; the incremental "
    "delta-solve scenario (decisions byte-identical with --delta-solve on/off)",
)
register(
    "consolidation-churn",
    tracemod.consolidation_churn,
    "fan-out waves drain into underutilized fleets; multi-node frontier consolidation folds them",
)
