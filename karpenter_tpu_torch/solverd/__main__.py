"""Standalone solver daemon: `python -m karpenter_tpu_torch.solverd`.

Runs a SolverDaemon on --listen (host:port or a unix socket path), owning
the accelerator for every operator replica pointed at it via
`--solver-transport socket --solver-daemon-address <addr>`. The daemon is
stateless between requests — each request carries its full solve state —
so it can restart freely; clients reconnect on the next call. Run several
(one --replica-id each) and list every address in the operators'
--solver-daemon-address to form a fleet with client-side failover.

Shutdown is graceful on SIGTERM/SIGINT: in-flight batches finish, new
requests are answered with a typed `Draining` rejection (shed, never
block — a pool client fails over on it), and the process exits once the
queue quiesces or --drain-grace expires.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from karpenter_tpu_torch.operator import logging as klog
from karpenter_tpu_torch.solverd.queue import parse_tenant_weights
from karpenter_tpu_torch.solverd.service import SolverService
from karpenter_tpu_torch.solverd.transport import SolverDaemon
from karpenter_tpu_torch.solverd.transport import _default_engine_factory
from karpenter_tpu_torch.utils.clock import Clock


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="karpenter-solverd")
    parser.add_argument(
        "--listen",
        default="127.0.0.1:9901",
        help="host:port or unix socket path to serve on",
    )
    parser.add_argument(
        "--replica-id", default="",
        help="identity this replica answers as in replies/metrics/spans "
        "(default: the bound listen address)",
    )
    parser.add_argument(
        "--queue-depth", type=int, default=256,
        help="admission queue depth; excess requests are rejected",
    )
    parser.add_argument(
        "--coalesce-window", type=float, default=0.005,
        help="seconds the batch leader waits for concurrent requests",
    )
    parser.add_argument(
        "--tenant-quota", type=int, default=0,
        help="per-tenant cap on queued solves (0 = off): a noisy tenant is "
        "shed with a typed TenantQuotaExceeded, quiet tenants keep headroom",
    )
    parser.add_argument(
        "--tenant-weights", default="",
        help="weighted fair drain order for mixed batches, e.g. 'gold=4,free=1'",
    )
    parser.add_argument(
        "--drain-grace", type=float, default=10.0,
        help="seconds SIGTERM waits for in-flight batches before exiting",
    )
    parser.add_argument(
        "--shard-devices", "--mesh", type=int, default=0, dest="shard_devices",
        help="devices to shard the solver's pod axis over: every engine "
        "this daemon rebuilds carries an N-device jax Mesh and routes its "
        "feasibility x packing sweeps through the sharded kernels (0 = "
        "single device; 1 = 1-device mesh, decision-identical; CPU dryrun: "
        "XLA_FLAGS=--xla_force_host_platform_device_count=8)",
    )
    parser.add_argument(
        "--compile-cache-dir", default="",
        help="persistent AOT executable cache directory; restarts "
        "warm-start their engines from it instead of re-compiling",
    )
    parser.add_argument(
        "--aot-ladder", default="",
        help="AOT shape-bucket ladder: 'default', a JSON ladder file, or "
        "'off' (a --compile-cache-dir implies 'default')",
    )
    parser.add_argument(
        "--fused-solve", choices=["off", "auto", "on"], default="",
        help="one-dispatch fused FFD scan (default auto: fuse on non-CPU "
        "backends; env KARPENTER_TPU_FUSED)",
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="port: the device the daemon's engines run on; cpu runs the "
        "plain versions of the kernels (no fallback when the card is missing)",
    )
    parser.add_argument("--log-level", default="info")
    ns = parser.parse_args(argv)
    from karpenter_tpu_torch.device import resolve_device

    try:
        # port: the daemon owns the device it was given, or it does not start
        resolve_device(ns.device)
    except RuntimeError as e:
        parser.exit(2, f"karpenter-solverd: {e}\n")
    if ns.fused_solve:
        from karpenter_tpu_torch.ops import fused as _fused_mod

        _fused_mod.FUSED_MODE = ns.fused_solve
    klog.configure(ns.log_level)
    log = klog.logger("solverd")

    # AOT compile service: engines the daemon rebuilds from shipped catalogs
    # warm-start against the ladder + persistent cache (transport.py's
    # engine factory calls aot.warm_start when the runtime is enabled)
    from types import SimpleNamespace

    from karpenter_tpu_torch.aot import runtime as aotrt

    aotrt.configure_from_options(
        SimpleNamespace(
            aot_ladder=ns.aot_ladder, compile_cache_dir=ns.compile_cache_dir
        )
    )

    service = SolverService(
        clock=Clock(),
        max_queue_depth=ns.queue_depth,
        coalesce_window=ns.coalesce_window,
        tenant_quota=ns.tenant_quota,
        tenant_weights=parse_tenant_weights(ns.tenant_weights),
    )
    daemon = SolverDaemon(
        service, address=ns.listen, replica_id=ns.replica_id,
        # port: the engines are built on --device
        engine_factory=_default_engine_factory(ns.shard_devices, device=ns.device),
        shard_devices=ns.shard_devices,
    ).start()
    log.info(
        "solver daemon listening",
        address=daemon.address,
        replica=daemon.replica_id,
        queue_depth=ns.queue_depth,
        coalesce_window=ns.coalesce_window,
        tenant_quota=ns.tenant_quota,
        shard_devices=ns.shard_devices or None,
        aot=aotrt.enabled(),
        compile_cache_dir=ns.compile_cache_dir or None,
    )

    # Graceful drain on SIGTERM (and ctrl-C): the handler only sets an
    # event — all teardown runs on the main thread, outside signal context.
    stop = threading.Event()

    def _request_shutdown(signum, frame) -> None:  # noqa: ARG001
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _request_shutdown)
        except (ValueError, OSError):
            pass  # non-main thread / unsupported platform: rely on finally
    try:
        stop.wait()
        log.info(
            "shutdown requested: draining",
            in_flight=service.queue.depth(),
            grace=ns.drain_grace,
        )
        quiesced = daemon.drain_and_stop(grace=ns.drain_grace)
        log.info("drained" if quiesced else "drain grace expired", clean=quiesced)
    finally:
        daemon.stop()
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
