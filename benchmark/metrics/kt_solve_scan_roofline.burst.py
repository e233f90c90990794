"""kt_solve_scan_roofline.burst: the least time the card could take for
the scans of the window (per scan the larger of its bytes at 3.35 TB/s and
its operations at 16.73 T/s, both at the solve's real sizes and the
kernel's own step count) over their device time in the profiler's trace,
in %."""

from benchmark.harness import peaks, probes

SPANS = {"scan_call": "karpenter_tpu_torch.ops.packer:solve_scan"}
record_scan_call = probes.scan_call


def read(run):
    dt = run.tracer.device
    calls = run.tracer.records.get("scan_call")
    if dt is None or not calls:
        return None
    device_s = dt.op_seconds(lambda n: "solve_scan" in n)
    if device_s <= 0:
        return None
    bound = 0.0
    for c in calls:
        c = probes.resolve(c)
        bound += peaks.scan_bound_s(c["steps"], c["G"], c["U"], c["D"], c["N"], c["bytes"])
    run.tracer.notes.append(
        f"kt_solve_scan_roofline.burst: the last scan G={c['G']} U={c['U']} D={c['D']} N={c['N']} "
        f"steps={c['steps']} bytes={c['bytes']}; bound {bound * 1e3:.6f} ms over device "
        f"{device_s * 1e3:.4f} ms ({len(calls)} scans)")
    return 100.0 * bound / device_s
