"""tracing: end-to-end scheduling traces over the injected-Clock substrate.

The observability layer PRs 1–3 lacked: a span API whose ids come from the
seeded uid source and whose timestamps come from the injected Clock, so
same-seed simulator runs emit byte-identical span logs (the digest is
asserted in CI next to the event-log digest). Instrumented hops: every
harness-wrapped reconcile, the provisioner's per-batch trace (child spans
per pod), solverd admission/coalescing/solve on both transports (trace
context rides the request envelope; daemon-side spans ship back in the
reply frame), cloud-provider create/delete with breaker state, nodeclaim
launch/registration, and binding. ``journey.JourneyRecorder`` assembles
the per-pod scheduling journey; ``/debug/traces`` serves it.

Controllers reach the tracer through the module-global accessor — the same
pattern as ``metrics.global_registry`` — because threading a tracer through
~25 constructor signatures would be plumbing for its own sake. The operator
(and the simulator, and the solverd daemon) call ``configure()`` once at
startup with their clock and options.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.tracing.core import (  # noqa: F401
    CURRENT,
    Span,
    SpanContext,
    Tracer,
    current,
)
from karpenter_tpu_torch.tracing.export import (  # noqa: F401
    DigestExporter,
    JSONLExporter,
    RingBufferExporter,
    canonical,
)
from karpenter_tpu_torch.tracing.journey import JourneyRecorder  # noqa: F401

_tracer: Optional[Tracer] = None


def configure(
    clock=None,
    sample_rate: float = 1.0,
    buffer_size: int = 4096,
    deterministic: bool = False,
    jsonl_path: Optional[str] = None,
) -> Tracer:
    """Install the process-global tracer (closing any previous one's file
    exporters) and return it. The standard exporter set is always wired:
    ring buffer (``/debug/traces``), rolling digest, journey recorder —
    plus a JSONL file when ``jsonl_path`` is given."""
    global _tracer
    if _tracer is not None:
        _tracer.close()
    tr = Tracer(
        clock=clock,
        sample_rate=sample_rate,
        deterministic=deterministic,
        buffer_size=buffer_size,
    )
    if jsonl_path:
        tr.exporters.append(JSONLExporter(jsonl_path))
    _tracer = tr
    return tr


def tracer() -> Tracer:
    """The process-global tracer (lazily constructed with defaults)."""
    global _tracer
    if _tracer is None:
        configure()
    return _tracer
