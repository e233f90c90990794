"""Span primitives: contexts, spans, and the Tracer.

A Dapper-style span layer (Sigelman et al., 2010) over the repo's injected
infrastructure: timestamps come from the injected ``Clock`` and trace/span
ids from the seeded uid source in ``apis/core`` — so a simulation run under
``FakeClock`` + ``set_uid_source`` emits byte-identical spans for identical
seeds. That makes traces *deterministically replayable*: the span-log
digest is a regression fingerprint exactly like the sim's event-log digest.

Two attribute classes keep that contract honest:

- regular attrs (``set_attr``) must be pure functions of the scenario —
  names, counts, outcomes — and are always exported;
- volatile attrs (``set_volatile``) are wall-clock measurements and
  process-history counters (kernel compile/execute split, cache-hit
  deltas) that legitimately differ between replays; a ``deterministic``
  tracer drops them at export so the digest never sees them.

Context propagation is explicit where it must be (a carrier dict rides the
solverd request envelope across BOTH transports) and ambient where it can
be (a contextvar tracks the active span within a thread of control, so
nested instrumentation links up without plumbing).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Iterator, Optional

from karpenter_tpu_torch.utils.clock import Clock

# sentinel: "parent not specified — fall back to the ambient current span".
# Passing parent=None explicitly means "root: start a new trace" (the
# provisioner's per-batch traces), which a plain default could not express.
CURRENT = object()

import contextvars

_ACTIVE: contextvars.ContextVar[Optional["SpanContext"]] = contextvars.ContextVar(
    "karpenter_active_span", default=None
)


@dataclass(frozen=True)
class SpanContext:
    trace_id: str
    span_id: str
    sampled: bool = True


class Span:
    __slots__ = ("name", "context", "parent_id", "start", "end", "status",
                 "attrs", "vattrs")

    def __init__(
        self,
        name: str,
        context: SpanContext,
        parent_id: Optional[str],
        start: float,
        **attrs: Any,
    ):
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.start = start
        self.end: Optional[float] = None
        self.status = "ok"
        self.attrs: dict[str, Any] = dict(attrs)
        self.vattrs: dict[str, Any] = {}

    @property
    def sampled(self) -> bool:
        return self.context.sampled

    def set_attr(self, **kv: Any) -> None:
        self.attrs.update(kv)

    def set_volatile(self, **kv: Any) -> None:
        """Wall-clock / process-history attributes: excluded from
        deterministic export (they differ between same-seed replays)."""
        self.vattrs.update(kv)

    def fail(self, err: BaseException) -> None:
        self.status = "error"
        self.attrs["error"] = f"{type(err).__name__}: {err}"

    def to_dict(self, deterministic: bool = False) -> dict:
        attrs = dict(self.attrs)
        if not deterministic:
            attrs.update(self.vattrs)
        d: dict[str, Any] = {
            "trace": self.context.trace_id,
            "span": self.context.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "start": round(self.start, 6),
            "end": round(self.end if self.end is not None else self.start, 6),
            "status": self.status,
            "attrs": attrs,
        }
        return d


class _NullSpan:
    """Stand-in for an unsampled span: carries an unsampled context so
    children skip too; every mutator is a no-op."""

    __slots__ = ("context",)

    def __init__(self, context: SpanContext):
        self.context = context

    sampled = False

    def set_attr(self, **kv: Any) -> None:
        pass

    def set_volatile(self, **kv: Any) -> None:
        pass

    def fail(self, err: BaseException) -> None:
        pass


def current() -> Optional[SpanContext]:
    """The ambient active span context (None outside any span)."""
    return _ACTIVE.get()


class Tracer:
    """Creates, contextualizes, and exports spans.

    ``exporters`` consume finished spans as plain dicts (``Span.to_dict``
    with the tracer's determinism applied), so every exporter — ring
    buffer, digest, JSONL file, journey assembler — sees one canonical
    shape. The tracer also keeps the *journey link table*: a bounded map
    from (kind, name) — e.g. ``("pod", "train-3")`` or ``("nodeclaim",
    "workers-ab12cd34")`` — to the span context later hops (lifecycle
    launch/registration, binding) re-join, which is what stitches a pod's
    multi-pass journey into ONE trace.
    """

    def __init__(
        self,
        clock: Optional[Clock] = None,
        sample_rate: float = 1.0,
        deterministic: bool = False,
        buffer_size: int = 4096,
        link_capacity: int = 8192,
    ):
        from karpenter_tpu_torch.tracing.export import DigestExporter, RingBufferExporter
        from karpenter_tpu_torch.tracing.journey import JourneyRecorder

        self.clock = clock or Clock()
        self.sample_rate = sample_rate
        self.deterministic = deterministic
        self.ring = RingBufferExporter(buffer_size)
        self.digest = DigestExporter()
        self.journeys = JourneyRecorder()
        self.exporters: list = [self.ring, self.digest, self.journeys]
        self._links: OrderedDict[tuple[str, str], SpanContext] = OrderedDict()
        self._link_capacity = link_capacity
        self._lock = threading.Lock()

    # -- ids -----------------------------------------------------------------

    @staticmethod
    def _new_trace_id() -> str:
        from karpenter_tpu_torch.apis.core import new_uid

        return new_uid()

    @staticmethod
    def _new_span_id() -> str:
        from karpenter_tpu_torch.apis.core import new_uid

        return new_uid()[:16]

    def _sample(self, trace_id: str) -> bool:
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        # stable per-trace decision: a trace is wholly kept or wholly
        # dropped, and the draw is a pure function of the (seeded) trace id
        return int(trace_id[:8], 16) / float(1 << 32) < self.sample_rate

    # -- span lifecycle ------------------------------------------------------

    def start(
        self,
        name: str,
        parent: Any = CURRENT,
        start: Optional[float] = None,
        **attrs: Any,
    ):
        parent_ctx: Optional[SpanContext]
        if parent is CURRENT:
            parent_ctx = current()
        else:
            parent_ctx = parent  # SpanContext or None (explicit root)
        if parent_ctx is not None:
            if not parent_ctx.sampled:
                return _NullSpan(SpanContext(parent_ctx.trace_id, "", False))
            trace_id = parent_ctx.trace_id
            parent_id: Optional[str] = parent_ctx.span_id
        else:
            trace_id = self._new_trace_id()
            parent_id = None
            if not self._sample(trace_id):
                return _NullSpan(SpanContext(trace_id, "", False))
        ctx = SpanContext(trace_id, self._new_span_id(), True)
        return Span(
            name, ctx, parent_id,
            self.clock.now() if start is None else start, **attrs,
        )

    def finish(self, span, end: Optional[float] = None) -> None:
        if isinstance(span, _NullSpan):
            return
        if span.end is None:
            span.end = self.clock.now() if end is None else end
        d = span.to_dict(self.deterministic)
        for exporter in self.exporters:
            exporter.export(d)

    @contextmanager
    def span(
        self,
        name: str,
        parent: Any = CURRENT,
        start: Optional[float] = None,
        **attrs: Any,
    ) -> Iterator[Any]:
        """Open a span, make it the ambient context, export on exit. An
        exception propagating through marks the span failed and re-raises."""
        sp = self.start(name, parent=parent, start=start, **attrs)
        token = _ACTIVE.set(sp.context)
        try:
            yield sp
        except BaseException as e:
            sp.fail(e)
            raise
        finally:
            _ACTIVE.reset(token)
            self.finish(sp)

    def event(
        self,
        name: str,
        parent: Any = CURRENT,
        start: Optional[float] = None,
        error: Optional[BaseException] = None,
        **attrs: Any,
    ):
        """A span opened and finished in one call (instant, or with an
        explicit earlier ``start`` to record a wait that just ended).
        Returns the span so callers can link its context."""
        sp = self.start(name, parent=parent, start=start, **attrs)
        if error is not None:
            sp.fail(error)
        self.finish(sp)
        return sp

    # -- propagation ---------------------------------------------------------

    def carrier(self) -> Optional[dict]:
        """The ambient context as wire-safe carrier fields, or None when
        there is no sampled active span."""
        ctx = current()
        if ctx is None or not ctx.sampled:
            return None
        return {"trace_id": ctx.trace_id, "span_id": ctx.span_id}

    @staticmethod
    def context_from(carrier: Optional[dict]) -> Optional[SpanContext]:
        if not carrier or not carrier.get("trace_id"):
            return None
        return SpanContext(carrier["trace_id"], carrier.get("span_id", ""), True)

    def import_spans(self, dicts) -> int:
        """Re-export span dicts produced elsewhere (the solverd daemon ships
        its spans back in the reply frame so they re-join the caller's
        trace in the caller's exporters)."""
        n = 0
        for d in dicts or ():
            if not isinstance(d, dict) or "trace" not in d:
                continue
            for exporter in self.exporters:
                exporter.export(d)
            n += 1
        return n

    # -- journey links -------------------------------------------------------

    def link(self, kind: str, name: str, ctx) -> None:
        """Remember the span context later hops re-join for this object."""
        if ctx is None or not ctx.sampled:
            return
        with self._lock:
            self._links[(kind, name)] = ctx
            self._links.move_to_end((kind, name))
            while len(self._links) > self._link_capacity:
                self._links.popitem(last=False)

    def linked(self, kind: str, name: str) -> Optional[SpanContext]:
        with self._lock:
            return self._links.get((kind, name))

    def close(self) -> None:
        for exporter in self.exporters:
            close = getattr(exporter, "close", None)
            if close is not None:
                close()
