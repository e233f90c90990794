"""CLI: run a named scenario (or a trace file) under a seed.

    python -m karpenter_tpu_torch.sim --scenario steady-state --seed 7
    python -m karpenter_tpu_torch.sim --scenario spot-interruption --seed 3 \
        --report report.json --events events.jsonl
    python -m karpenter_tpu_torch.sim --trace my-trace.json --seed 1
    python -m karpenter_tpu_torch.sim --list
    python -m karpenter_tpu_torch.sim -s steady-state --seed 7 --device cpu

The run's engines are built on the card (`--device cuda`, the default) or
on the CPU (`--device cpu`: the plain versions of the kernels). Without a
card, `--device cuda` exits 2; it never falls back to the CPU.

Identical (scenario, seed) pairs produce identical event-log digests; the
digest is printed on stderr-free stdout as part of the JSON report, so

    diff <(python -m karpenter_tpu_torch.sim -s steady-state --seed 7) \
         <(python -m karpenter_tpu_torch.sim -s steady-state --seed 7)

is empty by construction.
"""

from __future__ import annotations

import argparse
import json
import sys

from karpenter_tpu_torch.device import KernelError, resolve_device
from karpenter_tpu_torch.sim import scenarios
from karpenter_tpu_torch.sim import trace as tracemod
from karpenter_tpu_torch.sim.harness import run_scenario


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.sim",
        description="deterministic trace-driven cluster simulator",
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="the device the run's engines are built on; cpu runs the plain "
        "versions of the kernels (no fallback when the card is missing)",
    )
    parser.add_argument("-s", "--scenario", help="named scenario to run")
    parser.add_argument("--trace", help="path to a version-1 JSON trace file")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--report", help="write the JSON report here (default stdout)")
    parser.add_argument("--events", help="write the event log (JSONL) here")
    parser.add_argument("--dump-trace", help="write the materialized trace here")
    parser.add_argument(
        "--trace-export",
        help="write the span log (JSONL, one canonical span per line) here; "
        "same-seed runs write byte-identical files",
    )
    parser.add_argument(
        "--compile-cache-dir",
        default="",
        help="persistent AOT executable cache directory: the run's engines "
        "warm-start from it (and fill it), so a second run against the "
        "same dir boots with zero fresh ladder compiles",
    )
    parser.add_argument(
        "--aot-ladder",
        default="",
        help="AOT shape-bucket ladder: 'default', a JSON ladder file, or "
        "'off' (a --compile-cache-dir implies 'default')",
    )
    parser.add_argument(
        "--shard-devices", type=int, default=0, dest="shard_devices",
        help="devices to shard the solver's pod axis over: the run's "
        "engines carry an N-card mesh (mesh.build_solver_mesh; cuda:0 "
        "repeated when fewer cards exist) and route sweeps through the "
        "sharded kernels (0 = single device; 1 = 1-device mesh, "
        "decision-identical — event digests match across mesh sizes)",
    )
    parser.add_argument(
        "--fused-solve", choices=["off", "auto", "on"], default="",
        help="one-dispatch fused FFD scan (ops/fused.py): on = every "
        "eligible batch is ONE device dispatch; default auto fuses only "
        "on non-CPU backends (env KARPENTER_TPU_FUSED)",
    )
    parser.add_argument(
        "--delta-solve", choices=["off", "on"], default="",
        help="incremental delta solves (ops/delta.py): persistent "
        "device-resident solver state between passes with donated warm "
        "scan resumes; default leaves the process setting alone "
        "(env KARPENTER_TPU_DELTA)",
    )
    parser.add_argument(
        "--resolve-full-every", type=int, default=0,
        help="delta self-check cadence: every Nth warm pass re-solves "
        "from scratch and asserts decision identity (default: keep the "
        "process setting, 16)",
    )
    parser.add_argument(
        "--explain", choices=["off", "sampled", "on"], default="",
        help="decision provenance ledger (observability/explain.py): "
        "capture per-pod elimination funnels and fold them into "
        "report['explain'] with a determinism digest; sampled keeps a "
        "seeded ~25%% of pods; default leaves the process setting alone "
        "(env KARPENTER_TPU_EXPLAIN)",
    )
    parser.add_argument(
        "--flight-dir",
        default="",
        help="flight-recorder bundle directory: SLO breaches during the "
        "run dump postmortem bundles (JSONL + sha256) here; same-seed "
        "runs dump byte-identical bundles",
    )
    parser.add_argument(
        "--profile-dir",
        default="",
        help="device profile capture directory: arms torch.profiler trace "
        "capture — SLO breaches during the run arm a capture whose path "
        "is recorded in the breach's flight bundle (empty = disabled)",
    )
    parser.add_argument(
        "--journal-dir",
        default="",
        help="write-ahead intent journal directory: every externally-"
        "visible mutation is journaled here and injected operator crashes "
        "recover from it (crash scenarios default to a run-scoped tempdir "
        "when unset)",
    )
    parser.add_argument(
        "--list", action="store_true", help="list scenarios and exit"
    )
    parser.add_argument(
        "--log-level",
        default="error",
        help="operator log level during the run (default: error, so stdout "
        "stays a clean JSON report)",
    )
    args = parser.parse_args(argv)
    from karpenter_tpu_torch.operator import logging as klog

    klog.configure(args.log_level)

    if args.list:
        for name, desc in scenarios.describe().items():
            print(f"{name:20s} {desc}")
        return 0
    try:
        # port: the run's engines are built on the device it was given, or
        # the run does not start
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"karpenter-tpu sim: {e}", file=sys.stderr)
        return 2
    if bool(args.scenario) == bool(args.trace):
        parser.error("exactly one of --scenario or --trace is required")
    if args.scenario:
        trace = scenarios.resolve(args.scenario, args.seed)
    else:
        with open(args.trace, encoding="utf-8") as f:
            trace = tracemod.loads(f.read())
    if args.dump_trace:
        with open(args.dump_trace, "w", encoding="utf-8") as f:
            f.write(tracemod.dumps(trace) + "\n")

    if args.fused_solve:
        from karpenter_tpu_torch.ops import fused as fused_mod

        fused_mod.FUSED_MODE = args.fused_solve
    if args.delta_solve or args.resolve_full_every:
        from karpenter_tpu_torch.ops import delta as delta_mod

        delta_mod.configure(
            mode=args.delta_solve or None,
            resolve_full_every=args.resolve_full_every or None,
        )
    if args.explain:
        from karpenter_tpu_torch.observability import explain as explain_mod

        explain_mod.configure(mode=args.explain)
    options = None
    if (
        args.compile_cache_dir
        or args.aot_ladder
        or args.shard_devices
        or args.flight_dir
        or args.profile_dir
        or args.journal_dir
    ):
        from karpenter_tpu_torch.operator.options import Options

        options = Options(
            compile_cache_dir=args.compile_cache_dir,
            aot_ladder=args.aot_ladder,
            solver_pod_shard_axis=args.shard_devices,
            flight_dir=args.flight_dir,
            profile_dir=args.profile_dir,
            journal_dir=args.journal_dir,
        )

    try:
        if trace.get("fleet"):
            # multi-tenant fleet trace: N operator cells over a shared solverd
            # replica pool (sim/fleet.py) — same CLI surface, combined report
            from karpenter_tpu_torch.sim.fleet import run_fleet_scenario

            result = run_fleet_scenario(
                trace, args.seed, options=options,
                trace_export=args.trace_export, device=args.device,
            )
        else:
            result = run_scenario(
                trace, args.seed, options=options,
                trace_export=args.trace_export, device=args.device,
            )
    except KernelError:
        # port: a device fault ends the run: dump the flight ring and exit
        # nonzero, as `python -m karpenter_tpu_torch` does
        log = klog.logger("sim")
        log.error("simulation failed on a device fault", exc_info=True)
        from karpenter_tpu_torch.observability import flight as flightmod

        try:
            bundle = flightmod.recorder().dump("sim-device-fault", cooldown=0.0)
        except Exception:  # noqa: BLE001 — the dump must not hide the fault
            bundle = None
        if bundle is not None:
            log.error(
                "flight bundle dumped",
                bundle=bundle["name"],
                path=bundle.get("path"),
                frames=bundle["frames"],
            )
        return 1

    if args.events:
        with open(args.events, "w", encoding="utf-8") as f:
            f.write(result.log.to_jsonl())
    text = json.dumps(result.report, sort_keys=True, indent=2)
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    else:
        print(text)
    print(f"event-log digest: {result.digest}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
