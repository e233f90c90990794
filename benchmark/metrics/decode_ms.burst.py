"""decode_ms.burst: host ms per solve in the fused solve's decode
(`_FusedSolve._decode`: the scan's outputs back into NodeClaims)."""

SPANS = {"fused_decode": "karpenter_tpu_torch.ops.fused:_FusedSolve._decode"}


def read(run):
    spans = run.tracer.spans.get("fused_decode")
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(run.units) * 1e3
