"""scan_device_ms.burst: device ms per solve of kt_solve_scan's kernels,
from the profiler's trace. CUDA events around each `packer.solve_scan`
call are read beside it, on standard error, since the profiler has been
seen to drop launches."""

from benchmark.harness import probes

SPANS = {"scan_call": "karpenter_tpu_torch.ops.packer:solve_scan"}
CUDA_EVENTS = ("scan_call",)
record_scan_call = probes.scan_call


def read(run):
    dt = run.tracer.device
    if dt is None:
        return None
    s = dt.op_seconds(lambda n: "solve_scan" in n)
    ev = run.tracer.event_seconds("scan_call")
    run.tracer.notes.append(
        f"scan_device_ms.burst: profiler {s * 1e3 / len(run.units):.4f} ms a solve; CUDA events "
        f"around solve_scan {sum(ev) * 1e3 / len(run.units):.4f} ms a solve over {len(ev)} calls")
    return s / len(run.units) * 1e3 if s > 0 else None
