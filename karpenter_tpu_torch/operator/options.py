"""Operator configuration: flags with env fallbacks and feature gates.

Mirrors the reference's pkg/operator/options/options.go:56-206 — the same
option set (batch windows, feature gates, batch sizing) exposed as a
dataclass, parseable from argv/env, with the context-injection pattern
replaced by explicit passing (Python has no ctx plumbing to avoid).
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field, fields
from typing import Optional


@dataclass
class FeatureGates:
    """options.go:56-63; defaults match ParseFeatureGates (options.go:170-193)."""

    node_repair: bool = False
    reserved_capacity: bool = True
    spot_to_spot_consolidation: bool = False
    node_overlay: bool = False

    @classmethod
    def parse(cls, raw: str) -> "FeatureGates":
        gates = cls()
        mapping = {
            "NodeRepair": "node_repair",
            "ReservedCapacity": "reserved_capacity",
            "SpotToSpotConsolidation": "spot_to_spot_consolidation",
            "NodeOverlay": "node_overlay",
        }
        for part in filter(None, (p.strip() for p in raw.split(","))):
            key, _, value = part.partition("=")
            attr = mapping.get(key)
            if attr is not None:
                setattr(gates, attr, value.lower() == "true")
        return gates


@dataclass
class Options:
    """options.go:66-127. Durations are seconds."""

    service_name: str = ""
    metrics_port: int = 8080
    health_probe_port: int = 8081
    enable_profiling: bool = False
    disable_leader_election: bool = False
    # MiB; bounds solver caches (ops/ffd.py). -1 = unset (leave the
    # process-global caps untouched); 0 = explicitly unbounded
    memory_limit: int = -1
    log_level: str = "info"
    batch_max_duration: float = 10.0
    batch_idle_duration: float = 1.0
    preferences_policy: str = "Respect"  # "Respect" | "Ignore"
    min_values_policy: str = "Strict"  # "Strict" | "BestEffort"
    cluster_name: str = ""
    feature_gates: FeatureGates = field(default_factory=FeatureGates)

    # TPU-solver knobs (ours, not the reference's)
    solver_backend: str = "tpu"  # "tpu" | "host" (port: "tpu" is the CUDA engine)
    # --shard-devices / --mesh: devices to put the pod axis on. 0 (default)
    # = no mesh, single-device dispatch; N >= 1 builds an N-device
    # jax.sharding.Mesh over the local devices and routes every feasibility
    # x packing sweep through the `_sharded` kernels (a 1-device mesh is
    # bit-identical to the unsharded path — it exists so digests compare
    # across mesh sizes). 8-device CPU dryrun:
    # XLA_FLAGS=--xla_force_host_platform_device_count=8 when no TPU.
    solver_pod_shard_axis: int = 0
    # solverd: the batched solver service fronting every solve/simulation
    # (karpenter_tpu_torch/solverd). "inprocess" runs the service inside the
    # operator; "socket" forwards solves to a sidecar daemon
    # (python -m karpenter_tpu_torch.solverd) at solver_daemon_address.
    solver_transport: str = "inprocess"  # "inprocess" | "socket"
    # one address ("host:port" or unix socket path) talks to a single
    # daemon; a comma-separated list is a REPLICA POOL — the client routes
    # by catalog content-hash affinity and fails over on replica loss
    # (solverd/fleet.py)
    solver_daemon_address: str = ""
    solverd_queue_depth: int = 256  # admission queue depth (shed past it)
    solverd_coalesce_window: float = 0.0  # seconds the batch leader waits
    # multi-tenant admission (solverd/queue.py): tenant_quota caps any one
    # tenant's share of the queue (0 = off); tenant_weights ("gold=4,free=1")
    # orders mixed drained batches by weighted fair queuing
    solverd_tenant_quota: int = 0
    solverd_tenant_weights: str = ""
    # per-replica circuit breakers in the fleet client: consecutive
    # transport failures before a replica drops out of rotation, and
    # seconds before a half-open probe re-admits it
    solverd_replica_breaker_threshold: int = 3
    solverd_replica_breaker_cooldown: float = 5.0
    # fused one-dispatch solve (ops/fused.py): "off" never fuses, "on"
    # fuses every eligible batch, "auto" (default) fuses only on non-CPU
    # backends where dispatch round-trips dominate. env: KARPENTER_TPU_FUSED
    fused_solve: str = ""
    # incremental delta solves (ops/delta.py): "off"/"" solves every pass
    # from scratch (default), "on" keeps per-engine solver state resident
    # on device between passes (encode row cache, group-solve residency,
    # donated warm scan resumes). resolve_full_every is the self-check
    # cadence: every Nth warm pass ALSO re-solves from scratch and asserts
    # decision identity (divergence fires a typed event and drops the
    # residency); 0 disables the check. env: KARPENTER_TPU_DELTA /
    # KARPENTER_TPU_RESOLVE_FULL_EVERY
    delta_solve: str = ""
    resolve_full_every: int = 16
    # decision provenance ledger (observability/explain.py): "off"/"" no
    # capture (default — nothing on the solve path changes), "on" every
    # unschedulable pod commits an elimination ledger entry, "sampled" a
    # deterministic ~25% (hash of the seeded pod uid). explain_capacity
    # bounds the ledger ring. env: KARPENTER_TPU_EXPLAIN
    explain: str = ""
    explain_capacity: int = 256
    # consolidation frontier search (controllers/disruption + ops/frontier):
    # how many levels of the binary-search decision tree one coalesced
    # simulate batch evaluates speculatively. 1 = the sequential probe
    # order (still batched per round of one); higher trades speculative
    # simulations for fewer rounds — decisions are identical at any depth.
    consolidation_frontier_depth: int = 2

    # AOT compile service (karpenter_tpu_torch/aot): compile_cache_dir points at
    # the persistent on-disk executable cache (restarts warm-start from it);
    # aot_ladder selects the shape-bucket ladder — "off"/"" disables,
    # "default" is the built-in ladder, anything else a JSON ladder file.
    # A cache dir with no explicit ladder implies the default ladder.
    compile_cache_dir: str = ""
    aot_ladder: str = ""

    # tracing (karpenter_tpu_torch/tracing): safe-on-by-default — sample every
    # trace into a BOUNDED in-memory ring buffer (spans; /debug/traces
    # reads it). Rate 0 disables span export entirely; the simulator always
    # runs at 1.0 so journeys and span digests are complete.
    tracing_sample_rate: float = 1.0
    trace_buffer_size: int = 4096

    # SLO burn-rate engine (observability/slo.py): which objective set the
    # engine evaluates — "default"/"" = the built-in serving-path specs,
    # "off" = disabled, anything else = a JSON spec file. The flight
    # recorder (observability/flight.py) keeps the last flight_capacity
    # per-pass snapshots and dumps breach bundles under flight_dir
    # (empty = in-memory bundles only, still served at /debug/flight).
    slo_specs: str = "default"
    flight_dir: str = ""
    flight_capacity: int = 64

    # triggered device profiling (observability/efficiency.py): profile_dir
    # arms jax.profiler trace capture — on demand via
    # /debug/profile/device?seconds= and automatically on SLO breach (the
    # breach's flight bundle records the capture path). Empty = disabled
    # (the endpoint 404s, breaches dump bundles without captures).
    profile_dir: str = ""

    # write-ahead intent journal (runtime/journal.py): journal_dir holds the
    # fsync'd intent log replayed by Operator.recover() after a crash.
    # Empty = in-memory journal (no crash durability; recovery still resolves
    # intents from the same process, which is what the sim's in-process
    # restart exercises when it shares a dir).
    journal_dir: str = ""

    # reconciler harness (operator/harness.py): per-item exponential
    # backoff bounds for failing reconciles, and the cloud-provider circuit
    # breaker (consecutive retryable create/delete failures before opening;
    # seconds open before a half-open probe). threshold 0 disables.
    requeue_base_delay: float = 1.0
    requeue_max_delay: float = 120.0
    cloud_breaker_threshold: int = 5
    cloud_breaker_cooldown: float = 30.0

    @classmethod
    def parse(cls, argv: Optional[list[str]] = None, env: Optional[dict] = None) -> "Options":
        import sys

        if argv is None:
            argv = sys.argv[1:]
        env = dict(os.environ if env is None else env)
        parser = argparse.ArgumentParser(prog="karpenter-tpu", add_help=True)
        parser.add_argument("--karpenter-service", dest="service_name")
        parser.add_argument("--metrics-port", type=int)
        parser.add_argument("--health-probe-port", type=int)
        # accepted-and-ignored for drop-in CLI compatibility: the reference
        # throttles its rest.Config with these (options.go:73-74); this
        # build's store is in-process, so there is no client to throttle
        parser.add_argument(
            "--kube-client-qps", type=float, dest="_ignored_qps",
            help="ignored (no kube client in this build)",
        )
        parser.add_argument(
            "--kube-client-burst", type=int, dest="_ignored_burst",
            help="ignored (no kube client in this build)",
        )
        parser.add_argument("--enable-profiling", action="store_true", default=None)
        parser.add_argument("--disable-leader-election", action="store_true", default=None)
        parser.add_argument("--memory-limit", type=int)
        parser.add_argument("--log-level")
        parser.add_argument("--batch-max-duration", type=float)
        parser.add_argument("--batch-idle-duration", type=float)
        parser.add_argument("--preferences-policy")
        parser.add_argument("--min-values-policy")
        parser.add_argument("--cluster-name")
        parser.add_argument("--feature-gates", dest="feature_gates_raw")
        parser.add_argument("--solver-backend")
        parser.add_argument(
            "--shard-devices", "--mesh", "--solver-pod-shard-axis",
            type=int, dest="solver_pod_shard_axis",
            help="devices to shard the solver's pod axis over (0 = no "
            "mesh; 1 = 1-device mesh, decision-identical to unsharded)",
        )
        parser.add_argument("--solver-transport")
        parser.add_argument("--solver-daemon-address")
        parser.add_argument("--solverd-queue-depth", type=int)
        parser.add_argument("--solverd-coalesce-window", type=float)
        parser.add_argument("--solverd-tenant-quota", type=int)
        parser.add_argument("--solverd-tenant-weights")
        parser.add_argument("--solverd-replica-breaker-threshold", type=int)
        parser.add_argument("--solverd-replica-breaker-cooldown", type=float)
        parser.add_argument("--consolidation-frontier-depth", type=int)
        parser.add_argument(
            "--fused-solve", choices=["off", "auto", "on"],
            help="one-dispatch fused FFD scan (default auto: fuse on "
            "non-CPU backends; env KARPENTER_TPU_FUSED)",
        )
        parser.add_argument(
            "--delta-solve", choices=["off", "on"],
            help="incremental delta solves (ops/delta.py): persistent "
            "device-resident solver state with donated warm resumes "
            "(default off; env KARPENTER_TPU_DELTA)",
        )
        parser.add_argument(
            "--resolve-full-every", type=int,
            help="self-check cadence for delta solves: every Nth warm "
            "pass re-solves from scratch and asserts decision identity "
            "(default 16; 0 disables; env KARPENTER_TPU_RESOLVE_FULL_EVERY)",
        )
        parser.add_argument(
            "--explain", choices=["off", "sampled", "on"],
            help="decision provenance ledger (observability/explain.py): "
            "per-pod elimination funnels served at /debug/explain "
            "(default off; env KARPENTER_TPU_EXPLAIN)",
        )
        parser.add_argument("--explain-capacity", type=int)
        parser.add_argument("--compile-cache-dir")
        parser.add_argument("--aot-ladder")
        parser.add_argument("--slo-specs")
        parser.add_argument("--flight-dir")
        parser.add_argument("--flight-capacity", type=int)
        parser.add_argument("--profile-dir")
        parser.add_argument("--journal-dir")
        parser.add_argument("--tracing-sample-rate", type=float)
        parser.add_argument("--trace-buffer-size", type=int)
        parser.add_argument("--requeue-base-delay", type=float)
        parser.add_argument("--requeue-max-delay", type=float)
        parser.add_argument("--cloud-breaker-threshold", type=int)
        parser.add_argument("--cloud-breaker-cooldown", type=float)
        ns = parser.parse_args(argv)

        opts = cls()
        env_map = {
            "service_name": "KARPENTER_SERVICE",
            "metrics_port": "METRICS_PORT",
            "health_probe_port": "HEALTH_PROBE_PORT",
            "log_level": "LOG_LEVEL",
            "batch_max_duration": "BATCH_MAX_DURATION",
            "batch_idle_duration": "BATCH_IDLE_DURATION",
            "preferences_policy": "PREFERENCES_POLICY",
            "min_values_policy": "MIN_VALUES_POLICY",
            "cluster_name": "CLUSTER_NAME",
            "solver_backend": "SOLVER_BACKEND",
            "solver_pod_shard_axis": "SHARD_DEVICES",
            "solver_transport": "SOLVER_TRANSPORT",
            "solver_daemon_address": "SOLVER_DAEMON_ADDRESS",
            "solverd_tenant_quota": "SOLVERD_TENANT_QUOTA",
            "solverd_tenant_weights": "SOLVERD_TENANT_WEIGHTS",
            "explain": "KARPENTER_TPU_EXPLAIN",
            "delta_solve": "KARPENTER_TPU_DELTA",
            "resolve_full_every": "KARPENTER_TPU_RESOLVE_FULL_EVERY",
            "compile_cache_dir": "COMPILE_CACHE_DIR",
            "aot_ladder": "AOT_LADDER",
            "slo_specs": "SLO_SPECS",
            "flight_dir": "FLIGHT_DIR",
            "profile_dir": "PROFILE_DIR",
            "journal_dir": "JOURNAL_DIR",
        }
        for f in fields(cls):
            if f.name == "feature_gates":
                continue
            env_key = env_map.get(f.name)
            if env_key and env_key in env:
                raw = env[env_key]
                current = getattr(opts, f.name)
                if isinstance(current, bool):
                    setattr(opts, f.name, raw.lower() == "true")
                elif isinstance(current, int):
                    setattr(opts, f.name, int(raw))
                elif isinstance(current, float):
                    setattr(opts, f.name, float(raw))
                else:
                    setattr(opts, f.name, raw)
            flag_val = getattr(ns, f.name, None)
            if flag_val is not None:
                setattr(opts, f.name, flag_val)
        raw_gates = ns.feature_gates_raw or env.get("FEATURE_GATES", "")
        if raw_gates:
            opts.feature_gates = FeatureGates.parse(raw_gates)
        return opts
