"""Versioned trace format + synthetic workload generators.

A trace is a plain JSON-serializable dict — a first-class, replayable
artifact. Version 1 shape:

    {
      "version": 1,
      "name": "steady-state",
      "duration": 300.0,            # virtual seconds simulated
      "tick": 1.0,                  # controller pass interval (virtual s)
      "nodepools": [
        {"name": "workers", "consolidate_after": 15.0,
         "requirements": [...], "limits": {...}}        # optional extras
      ],
      "faults": {                   # probabilistic per-call fault rates
        "launch_failure_rate": 0.0,        # CreateError (retryable)
        "insufficient_capacity_rate": 0.0, # ICE (claim deleted, re-solved)
        "ack_then_raise_rate": 0.0,        # create LANDS, response lost —
                                           #   retry must converge by key
        "api_latency": 0.0,                # virtual s added per cloud call
        "api_jitter": 0.0,                 # + uniform[0, jitter)
        "solver_rejection_rate": 0.0,      # QueueFullError per solve
        "outages": [                       # scheduled FULL cloud-API
          {"at": 150.0, "duration": 50.0}  #   outages: every create/delete
        ]                                  #   raises (untyped, retryable)
      },
      "events": [                   # sorted by "at" (virtual s from start)
        {"at": 5.0, "kind": "submit", "group": "web", "count": 6,
         "pod": {"cpu": "1", "memory": "1Gi",
                 "capacity_type": "spot",     # optional nodeSelector pins
                 "zone": "...", "arch": "...",
                 "labels": {...},
                 "spread": "zone"},           # topology-spread on zone
         "until": 200.0,            # group completes (pods deleted); omit
                                    #   to run to end of trace
         "replace": true},          # ReplicaSet stand-in: deleted pods are
                                    #   resubmitted until "until"
        {"at": 90.0, "kind": "interrupt", "count": 1,
         "mode": "graceful",        # delete NodeClaim (interruption notice)
         "capacity_type": "spot"},  # victim filter
        {"at": 150.0, "kind": "interrupt", "count": 1, "mode": "reclaim"},
        {"at": 180.0, "kind": "operator-crash",  # arm a one-shot kill at a
         "barrier": "post-intent-pre-effect",    #   journal barrier: also
                                                 #   pre-intent /
                                                 #   post-effect-pre-done
         "action": "nodeclaim.launch"}           # optional: fire only on
                                                 #   this intent type
      ]
    }

Generators are pure functions of a seeded ``random.Random`` — the same seed
always yields the same trace, which (with the harness's seeded uid source)
makes whole runs byte-reproducible.
"""

from __future__ import annotations

import json
import math
from random import Random

TRACE_VERSION = 1


def validate(trace: dict) -> dict:
    """Cheap structural validation; returns the trace for chaining."""
    if trace.get("version") != TRACE_VERSION:
        raise ValueError(
            f"unsupported trace version {trace.get('version')!r} "
            f"(this build reads version {TRACE_VERSION})"
        )
    for key in ("name", "duration", "events"):
        if key not in trace:
            raise ValueError(f"trace missing required key {key!r}")
    last = -math.inf
    for ev in trace["events"]:
        if "at" not in ev or "kind" not in ev:
            raise ValueError(f"trace event missing at/kind: {ev!r}")
        if ev["at"] < last:
            raise ValueError("trace events must be sorted by 'at'")
        last = ev["at"]
    if "fleet" in trace:
        fleet = trace["fleet"]
        if int(fleet.get("replicas", 0)) < 1:
            raise ValueError("fleet trace needs fleet.replicas >= 1")
        tenants = trace.get("tenants")
        if not tenants:
            raise ValueError("fleet trace needs a non-empty 'tenants' list")
        names = set()
        for tenant in tenants:
            if "name" not in tenant or "trace" not in tenant:
                raise ValueError(f"fleet tenant missing name/trace: {tenant!r}")
            if tenant["name"] in names:
                raise ValueError(f"duplicate fleet tenant {tenant['name']!r}")
            names.add(tenant["name"])
            validate(tenant["trace"])
        last = -math.inf
        for kill in fleet.get("kills", []):
            if "at" not in kill or "replica" not in kill:
                raise ValueError(f"fleet kill missing at/replica: {kill!r}")
            if not 0 <= int(kill["replica"]) < int(fleet["replicas"]):
                raise ValueError(f"fleet kill names unknown replica: {kill!r}")
            if kill["at"] < last:
                raise ValueError("fleet kills must be sorted by 'at'")
            last = kill["at"]
    return trace


def loads(text: str) -> dict:
    return validate(json.loads(text))


def dumps(trace: dict) -> str:
    return json.dumps(trace, sort_keys=True, indent=2)


def _base(name: str, duration: float, tick: float = 1.0) -> dict:
    return {
        "version": TRACE_VERSION,
        "name": name,
        "duration": duration,
        "tick": tick,
        "nodepools": [{"name": "workers", "consolidate_after": 15.0}],
        "faults": {},
        "events": [],
    }


# -- generators ---------------------------------------------------------------


def steady_state(rng: Random) -> dict:
    """A constant web-service footprint: one burst of service pods that run
    for the whole trace, plus a small mid-run scale-up. No faults — this is
    the baseline whose digest should never move."""
    trace = _base("steady-state", duration=240.0)
    trace["events"] = [
        {
            "at": 4.0,
            "kind": "submit",
            "group": "web",
            "count": 5 + rng.randrange(3),
            "pod": {"cpu": str(1 + rng.randrange(2)), "memory": "1Gi"},
            "replace": True,
        },
        {
            "at": 120.0,
            "kind": "submit",
            "group": "web-scaleup",
            "count": 2 + rng.randrange(2),
            "pod": {"cpu": "1", "memory": "1Gi"},
            "replace": True,
        },
    ]
    return trace


def spot_interruption(rng: Random) -> dict:
    """Spot-pinned service pods under repeated capacity interruptions: one
    graceful (interruption-notice → NodeClaim delete → drain → replacement)
    and one hard reclaim (instance vanishes out-of-band → GC reaps the
    claim → replacement). Exercises the NodeClaim retry/replacement path."""
    trace = _base("spot-interruption", duration=420.0)
    trace["events"] = [
        {
            "at": 4.0,
            "kind": "submit",
            "group": "spotty",
            "count": 4 + rng.randrange(3),
            "pod": {"cpu": "2", "memory": "2Gi", "capacity_type": "spot"},
            "replace": True,
        },
        {"at": 60.0, "kind": "interrupt", "count": 1, "mode": "graceful",
         "capacity_type": "spot"},
        {"at": 140.0, "kind": "interrupt", "count": 1, "mode": "reclaim",
         "capacity_type": "spot"},
    ]
    return trace


def diurnal(rng: Random) -> dict:
    """Diurnal web traffic, a day compressed into the trace: pod arrivals
    follow a sinusoid — waves submitted on the upswing, completing on the
    downswing — so the autoscaler rides scale-up AND consolidation."""
    duration, waves = 600.0, 6
    trace = _base("diurnal", duration=duration, tick=2.0)
    events = [
        {
            "at": 4.0,
            "kind": "submit",
            "group": "base",
            "count": 2,
            "pod": {"cpu": "1", "memory": "1Gi"},
            "replace": True,
        }
    ]
    for i in range(waves):
        at = 20.0 + i * (duration - 80.0) / waves
        # sinusoidal demand: peak mid-trace
        level = math.sin(math.pi * (i + 1) / (waves + 1))
        count = max(1, round(level * (4 + rng.randrange(3))))
        events.append(
            {
                "at": round(at, 3),
                "kind": "submit",
                "group": f"wave-{i}",
                "count": count,
                "pod": {"cpu": str(rng.choice([1, 1, 2])), "memory": "2Gi"},
                "until": round(min(at + 120.0 + rng.randrange(60), duration - 30.0), 3),
                "replace": True,
            }
        )
    trace["events"] = sorted(events, key=lambda e: e["at"])
    return trace


def batch_waves(rng: Random) -> dict:
    """Batch-job waves: bursts of short-lived jobs arriving every ~90s,
    each wave finishing before the next two land — steady churn through
    provisioning, completion, and empty-node consolidation."""
    duration = 480.0
    trace = _base("batch-waves", duration=duration, tick=2.0)
    events = []
    at = 6.0
    i = 0
    while at < duration - 120.0:
        runtime = 60.0 + rng.randrange(40)
        events.append(
            {
                "at": round(at, 3),
                "kind": "submit",
                "group": f"job-{i}",
                "count": 3 + rng.randrange(4),
                "pod": {"cpu": "4", "memory": "8Gi"},
                "until": round(at + runtime, 3),
                "replace": False,  # batch pods that die stay dead
            }
        )
        at += 80.0 + rng.randrange(30)
        i += 1
    trace["events"] = events
    return trace


def tpu_training(rng: Random) -> dict:
    """TPU-slice-shaped training jobs: gangs of large workers spread across
    zones (one slice per failure domain, the topology-spread discipline
    multislice training uses), pinned to arm64 hosts, long-running."""
    trace = _base("tpu-training", duration=360.0, tick=2.0)
    trace["events"] = [
        {
            "at": 4.0,
            "kind": "submit",
            "group": "trainer",
            "count": 4,
            "pod": {
                "cpu": "16",
                "memory": "64Gi",
                "arch": "arm64",
                "spread": "zone",
                "labels": {"app": "trainer"},
            },
            "replace": True,
        },
        {
            "at": 90.0,
            "kind": "submit",
            "group": "eval",
            "count": 2 + rng.randrange(2),
            "pod": {"cpu": "8", "memory": "16Gi", "arch": "arm64"},
            "until": 250.0,
            "replace": True,
        },
    ]
    return trace


def mesh_sweep(rng: Random) -> dict:
    """A shape-diverse fleet wide enough to engage the DEVICE feasibility
    sweep under the sim's pinned routing: each wave submits dozens of
    distinct (zone, arch, capacity-type, size) combinations in ONE batch,
    so the joint-mask priming sweep crosses the device-RTT threshold
    instead of taking the host twin (every other scenario's one-or-two-
    shape batches stay host-side). The second wave lands NEW shapes in the
    SAME padded bucket — post-seal device dispatches that must not
    recompile. This is the mesh-smoke scenario: sharded dispatches pad to
    mesh-size-invariant global shapes, so runs at --shard-devices 1 and 8
    must produce byte-identical event AND kernel digests."""
    trace = _base("mesh-sweep", duration=240.0)
    zones = ["kwok-zone-1", "kwok-zone-2", "kwok-zone-3", "kwok-zone-4"]
    cpus = ["500m", "1", "2", "4"]
    mems = ["1Gi", "2Gi", "4Gi"]
    # the full selector cross product: 5 zone options x 3 arch x 2 capacity
    # = 30 distinct requirement ROW-SETS in one batch — wide enough that the
    # joint-mask priming sweep (P2=32, R2~16 against the 144x1152 kwok
    # catalog) clears the pinned-RTT device threshold
    combos = [
        (z, a, c)
        for z in [None, *zones]
        for a in (None, "amd64", "arm64")
        for c in (None, "spot")
    ]

    def wave(salt: int, at: float, until=None) -> list[dict]:
        events = []
        for i, (zone, arch, ct) in enumerate(combos):
            pod = {"cpu": cpus[(i + salt) % 4], "memory": mems[(i + salt) % 3]}
            if zone:
                pod["zone"] = zone
            if arch:
                pod["arch"] = arch
            if ct:
                pod["capacity_type"] = ct
            ev = {
                "at": at,
                "kind": "submit",
                "group": f"sweep-{salt}-{i}",
                # 3-4 pods per combo: the wave lands ~100 pods in ONE
                # provisioner batch, clearing ffd.DEVICE_MIN_PODS so the
                # solve takes the device fast path (every other scenario's
                # batches fall back to the host scan)
                "count": 3 + rng.randrange(2),
                "pod": pod,
                "replace": True,
            }
            if until is not None:
                ev["until"] = until
            events.append(ev)
        return events

    trace["events"] = wave(0, 4.0) + wave(1, 120.0, until=200.0)
    return trace


def consolidation_churn(rng: Random) -> dict:
    """The consolidation-heavy shape the frontier search exists for: waves
    of large short-lived pods fan the cluster out to many nodes, each
    wave leaving behind a residue of small long-running pods — so after a
    wave drains, the fleet is many barely-utilized (non-empty) nodes that
    only MULTI-node consolidation can fold together. Two full
    fan-out/drain/consolidate cycles, no faults: the event digest is a pure
    function of the frontier search's decisions."""
    duration = 540.0
    trace = _base("consolidation-churn", duration=duration, tick=2.0)
    # pin the pool to 4-cpu boxes: a 3-cpu fanout pod then owns a node, so
    # a drained wave strands its residue across MANY small nodes — the
    # multi-node shape. (On the default catalog the packer would fold the
    # whole wave onto a couple of 16x machines and consolidation would
    # never see a multi-node fleet.)
    trace["nodepools"][0]["requirements"] = [
        {
            "key": "karpenter.kwok.sh/instance-size",
            "operator": "In",
            "values": ["4x"],
        }
    ]
    # let consolidation act on the whole drained fleet at once — the
    # default 10% budget admits one node on a fleet this size, which would
    # push everything through the single-node path
    trace["nodepools"][0]["budgets"] = [{"nodes": "100%"}]
    events = []
    for cycle in range(2):
        start = 6.0 + cycle * 240.0
        spreaders = 8 + rng.randrange(4)
        # the fan-out: one fat pod per node, gone after ~100s
        events.append(
            {
                "at": round(start, 3),
                "kind": "submit",
                "group": f"fanout-{cycle}",
                "count": spreaders,
                "pod": {"cpu": "3", "memory": "4Gi"},
                "until": round(start + 90.0 + rng.randrange(20), 3),
                "replace": False,
            }
        )
        # the residue: small long-running pods left stranded one-per-node,
        # keeping the drained nodes non-empty (underutilized, not empty)
        events.append(
            {
                "at": round(start + 2.0, 3),
                "kind": "submit",
                "group": f"residue-{cycle}",
                "count": spreaders,
                "pod": {"cpu": "200m", "memory": "256Mi"},
                "replace": True,
            }
        )
    trace["events"] = sorted(events, key=lambda e: e["at"])
    return trace


def solverd_restart(rng: Random) -> dict:
    """Service load with the solver daemon restarting mid-trace — the
    rolling-upgrade path: steady demand establishes a warm solver, the
    restart drops every engine and executable, and a scale-up lands right
    after it so the very next solve pays the restart's cold path. With the
    AOT compile service configured (--compile-cache-dir), that cold path
    warm-starts from the persistent executable cache; either way the run
    must complete deterministically with every pod bound (no SLO breach)."""
    trace = _base("solverd-restart", duration=300.0)
    trace["events"] = [
        {
            "at": 4.0,
            "kind": "submit",
            "group": "svc",
            "count": 4 + rng.randrange(3),
            "pod": {"cpu": "2", "memory": "2Gi"},
            "replace": True,
        },
        {
            "at": 60.0,
            "kind": "submit",
            "group": "batch",
            "count": 2 + rng.randrange(2),
            "pod": {"cpu": "1", "memory": "1Gi"},
            "until": 220.0,
            "replace": True,
        },
        # the daemon restarts mid-stream (rolling upgrade) ...
        {"at": 150.0, "kind": "solverd-restart"},
        # ... and demand arrives immediately after, forcing the first
        # post-restart solve through the rebuilt (warm-started) engine
        {
            "at": 160.0,
            "kind": "submit",
            "group": "post-restart",
            "count": 3 + rng.randrange(2),
            "pod": {"cpu": "1", "memory": "2Gi"},
            "replace": True,
        },
    ]
    return trace


def fleet_replica_kill(rng: Random) -> dict:
    """The solverd-fleet availability gauntlet: three tenant clusters with
    distinct workload shapes share a 2-replica solver pool, and one replica
    is killed (SIGKILL — no drain, no goodbye) mid-trace. The survivors'
    client-side breakers must open, affinity routing must converge on the
    surviving replica, and every tenant's demand — including a post-kill
    scale-up landing right on the failover path — must still bind with no
    pod left unschedulable and zero double-executed solves."""
    duration = 240.0
    trace = {
        "version": TRACE_VERSION,
        "name": "fleet-replica-kill",
        "duration": duration,
        "tick": 2.0,
        "fleet": {
            "replicas": 2,
            # a modest per-tenant quota: big enough that well-behaved
            # tenants never trip it, live so the quota metrics are
            # exercised end to end
            "tenant_quota": 32,
            "kills": [{"at": 120.0, "replica": 0}],
        },
        "tenants": [],
        "events": [],
    }

    def tenant(name: str, weight: float, events: list) -> dict:
        return {
            "name": name,
            "weight": weight,
            "trace": {
                "version": TRACE_VERSION,
                "name": f"{name}-stream",
                "duration": duration,
                "tick": 2.0,
                "nodepools": [{"name": "workers", "consolidate_after": 15.0}],
                "faults": {},
                "events": sorted(events, key=lambda e: e["at"]),
            },
        }

    # tenant-web: steady service footprint, weighted heaviest
    trace["tenants"].append(
        tenant(
            "tenant-web",
            2.0,
            [
                {
                    "at": 4.0,
                    "kind": "submit",
                    "group": "web",
                    "count": 4 + rng.randrange(3),
                    "pod": {"cpu": "2", "memory": "2Gi"},
                    "replace": True,
                },
                # a scale-up right after the kill, sized so it cannot bind
                # onto existing headroom: the very next solves MUST ride the
                # failover path onto the surviving replica
                {
                    "at": 130.0,
                    "kind": "submit",
                    "group": "web-scaleup",
                    "count": 2 + rng.randrange(2),
                    "pod": {"cpu": "16", "memory": "32Gi"},
                    "replace": True,
                },
                {
                    "at": 170.0,
                    "kind": "submit",
                    "group": "web-burst",
                    "count": 2,
                    "pod": {"cpu": "16", "memory": "32Gi"},
                    "until": 220.0,
                    "replace": True,
                },
            ],
        )
    )
    # tenant-batch: short-lived job waves, churning before and after the kill
    batch_events = []
    at = 6.0
    i = 0
    while at < duration - 60.0:
        batch_events.append(
            {
                "at": round(at, 3),
                "kind": "submit",
                "group": f"job-{i}",
                "count": 2 + rng.randrange(3),
                "pod": {"cpu": "2", "memory": "4Gi"},
                "until": round(at + 50.0 + rng.randrange(20), 3),
                "replace": False,
            }
        )
        at += 55.0 + rng.randrange(15)
        i += 1
    trace["tenants"].append(tenant("tenant-batch", 1.0, batch_events))
    # tenant-ml: a small long-running training footprint
    trace["tenants"].append(
        tenant(
            "tenant-ml",
            1.0,
            [
                {
                    "at": 8.0,
                    "kind": "submit",
                    "group": "trainer",
                    "count": 2,
                    "pod": {"cpu": "8", "memory": "16Gi"},
                    "replace": True,
                },
                # post-kill evaluation burst: this tenant's affinity also
                # pointed at the doomed replica, so its first post-kill
                # provisioning solve exercises failover from a second tenant
                {
                    "at": 140.0,
                    "kind": "submit",
                    "group": "eval",
                    "count": 2,
                    "pod": {"cpu": "8", "memory": "32Gi"},
                    "until": 210.0,
                    "replace": True,
                },
            ],
        )
    )
    return trace


def crash_churn(rng: Random) -> dict:
    """The crash-consistency gauntlet: service + wave churn (launches,
    binds, consolidation, an interruption) with the OPERATOR killed at all
    three journal barrier classes mid-run, against an ambiguous cloud
    (creates that land but whose acks are lost). Each kill cold-restarts
    the operator from the on-disk journal: the replacement waits out the
    dead incumbent's lease, replays pending intents — adopting
    acknowledged launches by idempotency key, rolling back in-flight
    disruption — and the run must end with zero double-launched NodeClaims
    and zero leaked instances. Each crash is armed shortly BEFORE a demand
    wave so the kill lands on that wave's intent flow; the last crash
    lands well over 200s before the end so GC's 2-minute sweep reaps
    anything recovery orphaned."""
    duration = 600.0
    trace = _base("crash-churn", duration=duration)
    trace["faults"] = {
        # the ambiguous failure the idempotency key exists for: the create
        # LANDS but the response is lost; the journaled retry must converge
        # on the instance already launched, never a second one
        "ack_then_raise_rate": 0.15,
        "launch_failure_rate": 0.1,
    }

    def wave(i: int, at: float, until: float) -> dict:
        return {
            "at": at,
            "kind": "submit",
            "group": f"wave-{i}",
            "count": 3 + rng.randrange(2),
            # big enough that a wave can't bind onto existing headroom:
            # every wave forces fresh launch intents for the kill to land on
            "pod": {"cpu": "3", "memory": "4Gi"},
            "until": until,
            "replace": True,
        }

    trace["events"] = [
        {
            "at": 4.0,
            "kind": "submit",
            "group": "svc",
            "count": 3 + rng.randrange(3),
            "pod": {"cpu": "2", "memory": "2Gi"},
            "replace": True,
        },
        # killed after an intent is durable but before its effect reaches
        # the cloud: recovery finds no instance, the claim relaunches
        {"at": 38.0, "kind": "operator-crash",
         "barrier": "post-intent-pre-effect"},
        wave(0, 40.0, 160.0),
        # killed after the cloud acked a launch but before the done record:
        # the adoption path — recovery finds the instance by idempotency key
        {"at": 118.0, "kind": "operator-crash",
         "barrier": "post-effect-pre-done", "action": "nodeclaim.launch"},
        wave(1, 120.0, 260.0),
        {"at": 200.0, "kind": "interrupt", "count": 1, "mode": "graceful"},
        # killed before the intent is even written: nothing journaled for
        # that action; everything else pending still recovers
        {"at": 208.0, "kind": "operator-crash", "barrier": "pre-intent"},
        wave(2, 210.0, 330.0),
    ]
    return trace


def sustained_churn(rng: Random) -> dict:
    """The steady-state the incremental delta solver exists for: a large,
    SHAPE-STABLE service footprint with continuous ~1% replace-churn and a
    diurnal arrival envelope. Every churn pod is the same shape and size as
    the base fleet — the delta encode re-encodes nothing after the first
    pass (all arrivals content-hit the row cache), and because the fused
    FFD scan sorts by size, uniform arrivals always extend the previous pod
    order as an exact suffix, keeping the warm scan-resume path engaged
    pass after pass. Churn arrives as small short-lived groups at a steady
    cadence (sinusoidally modulated: day peak, night trough) so every tick
    has a perturbed frontier but the cluster-scale state never rebuilds.
    No faults: with --delta-solve on the decisions must stay byte-identical
    to --delta-solve off, and the CI churn-smoke job diffs exactly that."""
    duration = 480.0
    trace = _base("sustained-churn", duration=duration, tick=2.0)
    # one uniform pod shape for base AND churn: shape-stability is the
    # point — warm resume requires arrivals that don't re-sort the stream
    pod = {"cpu": "1", "memory": "2Gi"}
    events = [
        {
            "at": 4.0,
            "kind": "submit",
            "group": "base",
            "count": 40 + rng.randrange(9),
            "pod": dict(pod),
            "replace": True,
        }
    ]
    # continuous churn: a short-lived group every ~12s, 1-2 pods each —
    # about 1% of the base footprint in flight per tick, modulated by a
    # full diurnal cycle across the trace
    at, i = 20.0, 0
    while at < duration - 90.0:
        phase = 2.0 * math.pi * (at / duration)
        level = 0.5 * (1.0 - math.cos(phase))  # 0 at edges, 1 mid-trace
        count = 1 + (1 if rng.random() < level else 0)
        events.append(
            {
                "at": round(at, 3),
                "kind": "submit",
                "group": f"churn-{i}",
                "count": count,
                "pod": dict(pod),
                "until": round(at + 50.0 + rng.randrange(25), 3),
                "replace": True,
            }
        )
        at += 10.0 + rng.randrange(5)
        i += 1
    trace["events"] = sorted(events, key=lambda e: e["at"])
    return trace


def capacity_pressure(rng: Random) -> dict:
    """The /debug/explain fixture: a limits-capped single pool under more
    demand than it may hold, plus two deliberately unsatisfiable pods whose
    eliminating stage is exact and distinct — a giant pod no instance type
    can fit (resources) and a pod pinned to a zone no offering serves
    (offerings). Fillers saturate the cpu limit so their overflow pends on
    limits, then drain at t=60 — headroom returns, and the unsatisfiable
    pods re-solve to their TRUE stages for the rest of the run (an
    exhausted pool eliminates everything at the limits stage, which would
    mask them). No faults: the triage table, the per-stage elimination
    counters, and the ledger digest are pure functions of the seed."""
    trace = _base("capacity-pressure", duration=180.0)
    # pin the pool to 4-cpu boxes and cap it at 12 cpu (3 nodes): a 3-cpu
    # filler owns a node, so any filler past the third pends on limits
    trace["nodepools"][0]["requirements"] = [
        {
            "key": "karpenter.kwok.sh/instance-size",
            "operator": "In",
            "values": ["4x"],
        }
    ]
    trace["nodepools"][0]["limits"] = {"cpu": "12"}
    trace["events"] = [
        {
            "at": 4.0,
            "kind": "submit",
            "group": "filler",
            "count": 5 + rng.randrange(2),
            "pod": {"cpu": "3", "memory": "2Gi"},
            "until": 60.0,
            "replace": True,
        },
        # no 4x instance type holds 64 cpu: every nodepool eliminates this
        # pod at the resources stage, forever
        {
            "at": 8.0,
            "kind": "submit",
            "group": "giant",
            "count": 1,
            "pod": {"cpu": "64", "memory": "4Gi"},
            "replace": True,
        },
        # no offering serves this zone: eliminated at the offerings stage
        {
            "at": 8.0,
            "kind": "submit",
            "group": "lost-zone",
            "count": 1,
            "pod": {"cpu": "1", "memory": "1Gi", "zone": "kwok-zone-9"},
            "replace": True,
        },
    ]
    return trace


def flaky_cloud(rng: Random) -> dict:
    """Steady demand against a misbehaving cloud: probabilistic launch
    failures, occasional capacity errors, API latency, a solver shedding
    part of its load, and a scheduled FULL cloud-API outage — the
    graceful-degradation gauntlet. The outage (with an interruption inside
    it forcing cloud deletes) drives the operator's circuit breaker through
    closed → open → half-open → closed and exercises per-item reconcile
    backoff, all in virtual time."""
    trace = _base("flaky-cloud", duration=360.0)
    trace["faults"] = {
        "launch_failure_rate": 0.3,
        "insufficient_capacity_rate": 0.1,
        "api_latency": 0.2,
        "api_jitter": 0.3,
        "solver_rejection_rate": 0.25,
        # long enough that the first half-open probe (default 30s cooldown)
        # fails and re-opens the breaker before recovery closes it
        "outages": [{"at": 150.0, "duration": 50.0}],
    }
    trace["events"] = [
        {
            "at": 4.0,
            "kind": "submit",
            "group": "svc",
            "count": 4 + rng.randrange(3),
            "pod": {"cpu": "2", "memory": "2Gi"},
            "replace": True,
        },
        # a graceful interruption mid-outage: its finalizer needs a cloud
        # delete, which fails until the breaker recovers — the per-item
        # backoff path for deletes
        {"at": 160.0, "kind": "interrupt", "count": 1, "mode": "graceful"},
    ]
    return trace
