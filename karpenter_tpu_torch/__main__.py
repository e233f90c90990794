"""Binary entry point: `python -m karpenter_tpu_torch`.

Mirrors the reference's kwok binary (kwok/main.go:28-47): build the
operator with the in-tree kwok provider, wire controllers, serve
metrics/health, run the reconcile loop until signalled. The in-memory
Store stands in for the API server (SURVEY.md §5: the store is the durable
substrate; all state rebuilds from it on restart).
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

from karpenter_tpu_torch.cloudprovider.kwok.provider import KwokCloudProvider
from karpenter_tpu_torch.controllers.provisioning.provisioner import default_engine_factory
from karpenter_tpu_torch.device import KernelError, resolve_device
from karpenter_tpu_torch.operator import logging as klog
from karpenter_tpu_torch.operator.operator import Operator
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.operator.serving import Server, ServingConfig
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.utils.clock import Clock


def _port_args(argv):
    """port: `--device {cuda,cpu}` (default cuda), the device the
    operator's engines run on; the rest of argv is the reference's
    options."""
    parser = argparse.ArgumentParser(prog="karpenter-tpu", add_help=False)
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="the device the solver's engines run on; cpu runs the plain "
        "versions of the kernels (no fallback when the card is missing)",
    )
    ns, rest = parser.parse_known_args(sys.argv[1:] if argv is None else argv)
    if "-h" in rest or "--help" in rest:
        parser.print_help()
    return ns.device, rest


def main(argv=None, max_passes: int | None = None, pass_interval: float = 1.0) -> int:
    device, argv = _port_args(argv)
    options = Options.parse(argv)
    try:
        # port: the operator runs on the device it was given, or not at all
        resolve_device(device)
    except RuntimeError as e:
        print(f"karpenter-tpu: {e}", file=sys.stderr)
        return 2
    base = {"cluster": options.cluster_name} if options.cluster_name else {}
    klog.configure(options.log_level, **base)
    log = klog.logger("operator")

    clock = Clock()
    store = Store(clock=clock)
    provider = KwokCloudProvider(store, clock)
    # port: the engines are built on --device, the mesh (--shard-devices)
    # by mesh.build_solver_mesh
    engine_factory = (
        default_engine_factory(
            shard_devices=options.solver_pod_shard_axis, device=device
        )
        if options.solver_backend == "tpu"
        else None
    )
    operator = Operator(
        store, provider, clock=clock, options=options, engine_factory=engine_factory
    )

    servers = []
    try:
        serving = ServingConfig(
            metrics_text=operator.metrics_text,
            healthy=operator.healthy,
            ready=operator.ready,
            enable_profiling=options.enable_profiling,
            solverd_stats=operator.solver_stats,
            health_snapshot=operator.health_snapshot,
            trace_snapshot=operator.trace_snapshot,
            heap_stats=operator.heap_stats,
            kernel_snapshot=operator.kernel_snapshot,
            slo_snapshot=operator.slo_snapshot,
            flight_snapshot=operator.flight_snapshot,
            device_profile=operator.device_profile_snapshot,
            journal_snapshot=operator.journal_snapshot,
            explain_snapshot=operator.explain_snapshot,
        )
        if options.metrics_port > 0:
            servers.append(Server(options.metrics_port, serving).start())
        if options.health_probe_port > 0 and options.health_probe_port != options.metrics_port:
            servers.append(Server(options.health_probe_port, serving).start())
    except OSError as e:
        log.error("failed to bind serving ports", error=str(e))
        for server in servers:
            server.stop()
        return 1

    stop = {"requested": False}

    def _signal(signum, frame):
        log.info("shutdown requested", signal=signum)
        stop["requested"] = True

    def _sigquit(signum, frame):
        # the blackbox hotkey: dump the flight ring as a postmortem bundle
        # without stopping the operator (kill -QUIT <pid>), like a JVM
        # thread dump — the recorder's cooldown keeps repeats cheap.
        # lock_timeout: the handler runs ON the main thread, which may be
        # suspended inside record() holding the recorder lock — a blocking
        # acquire would deadlock the whole operator; bounded, the dump is
        # simply skipped and the loop resumes
        bundle = operator.flight.dump("sigquit", cooldown=0.0, lock_timeout=1.0)
        if bundle is not None:
            log.info(
                "flight bundle dumped",
                bundle=bundle["name"],
                path=bundle.get("path"),
                frames=bundle["frames"],
            )

    try:
        signal.signal(signal.SIGINT, _signal)
        signal.signal(signal.SIGTERM, _signal)
        if hasattr(signal, "SIGQUIT"):
            signal.signal(signal.SIGQUIT, _sigquit)
    except ValueError:
        pass  # not the main thread (tests)

    log.info(
        "starting operator",
        provider="kwok",
        metrics_port=options.metrics_port,
        health_port=options.health_probe_port,
        feature_gates=vars(options.feature_gates),
    )
    passes = 0
    code = 0
    while not stop["requested"]:
        started = time.monotonic()
        try:
            operator.run_once()
        except KernelError:
            # port: a device fault stops the loop: the card's state is
            # unknown, so retrying the pass would hide the fault. Dump the
            # flight ring, shut down, exit nonzero.
            log.error("reconcile pass failed on a device fault; stopping", exc_info=True)
            try:
                bundle = operator.flight.dump("operator-device-fault", cooldown=0.0)
            except Exception:  # noqa: BLE001 — the dump must not hide the fault
                bundle = None
            if bundle is not None:
                log.error(
                    "flight bundle dumped",
                    bundle=bundle["name"],
                    path=bundle.get("path"),
                    frames=bundle["frames"],
                )
            code = 1
            passes += 1
            break
        except Exception:  # noqa: BLE001 — the loop must survive
            log.error("reconcile pass failed", exc_info=True)
            # preserve the evidence: the last N passes of system state at
            # the moment the loop blew up, before retrying clobbers it
            try:
                operator.flight.dump("operator-crash")
            except Exception:  # noqa: BLE001 — the dump must not re-crash the loop
                pass
        passes += 1
        if max_passes is not None and passes >= max_passes:
            break
        delay = pass_interval - (time.monotonic() - started)
        if delay > 0 and not stop["requested"]:
            time.sleep(delay)
    operator.shutdown()
    log.info("operator stopped", passes=passes)
    for server in servers:
        server.stop()
    return code


if __name__ == "__main__":
    sys.exit(main())
