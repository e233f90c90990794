"""scan_steps_per_pass.churn: loop iterations of the fused scan's launches
(full, resumed and classic) per pass, each launch's own count."""

from benchmark.harness import probes

SPANS = {
    "scan_full": "karpenter_tpu_torch.ops.packer:solve_scan_full",
    "scan_resume": "karpenter_tpu_torch.ops.packer:solve_scan_resume",
    "scan_call": "karpenter_tpu_torch.ops.packer:solve_scan",
}
record_scan_full = record_scan_resume = probes.scan_steps
record_scan_call = probes.scan_call


def read(run):
    rec = run.tracer.records
    steps = sum(rec.get("scan_full", [])) + sum(rec.get("scan_resume", []))
    steps += sum(int(c["steps"]) for c in rec.get("scan_call", []))
    return steps / len(run.units) if steps else None
