"""Per-pod scheduling-journey assembly.

A pod's journey is the causally-ordered hop sequence
first-seen-pending → batcher flush → solverd admit → solve →
NodeClaim create → cloud launch → registration → bind, reconstructed
STREAMING from finished spans (the recorder is just another exporter) so
it works identically for the live operator's ring-buffered traces and the
simulator's full span log.

Span → stage mapping:

    pod.pending              pending       (first trigger → batch flush)
    solverd.queue            admit         (admission → batch drain), per trace
    solverd.solve            solve         (batch execution), per trace
    nodeclaim.create         create        per claim
    nodeclaim.launch (ok)    launch        per claim (cloud create)
    nodeclaim.registration   registration  per claim (launch → node joined)
    pod.bind                 bind          (previous stage end → bind)

Claim-level stages fan out to every pod scheduled onto that claim; a pod
that bound straight to existing capacity legitimately has a bind-only
journey. Completed journeys feed the per-stage histograms
``karpenter_pod_scheduling_duration_seconds{stage=}`` and the sim report's
per-stage p50/p99.
"""

from __future__ import annotations

import threading
from bisect import insort
from collections import OrderedDict, deque

from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.utils.stats import percentile

STAGES = ("pending", "admit", "solve", "create", "launch", "registration", "bind")

_STAGE_HIST = global_registry.histogram(
    "karpenter_pod_scheduling_duration_seconds",
    "per-stage pod scheduling journey duration",
    labels=["stage"],
    buckets=(0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0),
)


def _bounded(d: OrderedDict, cap: int) -> None:
    while len(d) > cap:
        d.popitem(last=False)


def _pod_key(attrs: dict) -> str:
    # uid when the span carries one (names collide across namespaces and
    # across a recreated pod's lifetimes; uids never do), name as fallback
    # for hand-rolled spans
    return attrs.get("pod_uid") or attrs.get("pod", "")


class JourneyRecorder:
    """Exporter that folds spans into per-pod journeys."""

    def __init__(self, max_completed: int = 1024, max_in_flight: int = 8192):
        self._lock = threading.Lock()
        # pod name -> {"trace", "claim", "node", "stages": {stage: (s, e)}}
        self._pods: OrderedDict[str, dict] = OrderedDict()
        # claim name -> {stage: (s, e)}
        self._claims: OrderedDict[str, dict] = OrderedDict()
        # trace id -> {"admit": (s, e), "solve": (s, e)}
        self._trace_stages: OrderedDict[str, dict] = OrderedDict()
        self._completed: deque = deque(maxlen=max_completed)
        self._max_in_flight = max_in_flight
        self._durations: dict[str, list[float]] = {s: [] for s in STAGES}
        self._durations["total"] = []
        self.completed_count = 0

    # -- exporter interface --------------------------------------------------

    def export(self, d: dict) -> None:
        name = d.get("name", "")
        attrs = d.get("attrs") or {}
        with self._lock:
            if name == "pod.pending":
                rec = self._pod(_pod_key(attrs))
                rec["pod"] = attrs.get("pod", "")
                rec["trace"] = d.get("trace")
                rec["stages"]["pending"] = (d["start"], d["end"])
            elif name == "pod.schedule":
                rec = self._pod(_pod_key(attrs))
                rec["pod"] = attrs.get("pod", "")
                rec["trace"] = d.get("trace")
                if attrs.get("nodeclaim"):
                    rec["claim"] = attrs["nodeclaim"]
                if attrs.get("node"):
                    rec["node"] = attrs["node"]
            elif name == "solverd.queue":
                self._trace(d.get("trace")).setdefault(
                    "admit", (d["start"], d["end"])
                )
            elif name == "solverd.solve":
                self._trace(d.get("trace")).setdefault(
                    "solve", (d["start"], d["end"])
                )
            elif name == "nodeclaim.create":
                claim = self._claim(attrs.get("nodeclaim", ""))
                claim["create"] = (d["start"], d["end"])
            elif name == "nodeclaim.launch" and d.get("status") == "ok":
                self._claim(attrs.get("nodeclaim", "")).setdefault(
                    "launch", (d["start"], d["end"])
                )
            elif name == "nodeclaim.registration":
                self._claim(attrs.get("nodeclaim", "")).setdefault(
                    "registration", (d["start"], d["end"])
                )
            elif name == "pod.bind":
                self._finalize(attrs, d)

    # -- state ---------------------------------------------------------------

    def _pod(self, key: str) -> dict:
        rec = self._pods.get(key)
        if rec is None:
            rec = self._pods[key] = {
                "pod": "", "trace": None, "claim": None, "node": None,
                "stages": {},
            }
        _bounded(self._pods, self._max_in_flight)
        return rec

    def _claim(self, claim: str) -> dict:
        stages = self._claims.get(claim)
        if stages is None:
            stages = self._claims[claim] = {}
        _bounded(self._claims, self._max_in_flight)
        return stages

    def _trace(self, trace_id: str) -> dict:
        stages = self._trace_stages.get(trace_id)
        if stages is None:
            stages = self._trace_stages[trace_id] = {}
        _bounded(self._trace_stages, self._max_in_flight)
        return stages

    def _finalize(self, attrs: dict, bind_span: dict) -> None:
        pod = attrs.get("pod", "")
        rec = self._pods.pop(_pod_key(attrs), None) or {
            "pod": pod, "trace": None, "claim": None, "node": None,
            "stages": {},
        }
        stages: dict[str, tuple] = dict(rec["stages"])
        trace_id = rec["trace"] or bind_span.get("trace")
        if rec["trace"] in self._trace_stages:
            for stage, window in self._trace_stages[rec["trace"]].items():
                stages.setdefault(stage, window)
        claim = rec["claim"] or attrs.get("nodeclaim") or None
        if claim and claim in self._claims:
            for stage, window in self._claims[claim].items():
                stages.setdefault(stage, window)
        bind_t = bind_span["end"]
        prev_end = max((e for _, e in stages.values()), default=bind_span["start"])
        stages["bind"] = (min(prev_end, bind_t), bind_t)
        first_start = min(s for s, _ in stages.values())
        journey = {
            "pod": pod,
            "trace": trace_id,
            "nodeclaim": claim,
            "node": rec["node"] or attrs.get("node"),
            "bound_at": bind_t,
            "total": round(bind_t - first_start, 6),
            "stages": {
                stage: {
                    "start": round(s, 6),
                    "end": round(e, 6),
                    "duration": round(e - s, 6),
                }
                for stage, (s, e) in sorted(
                    stages.items(), key=lambda kv: (kv[1][0], kv[1][1])
                )
            },
        }
        self._completed.append(journey)
        self.completed_count += 1
        for stage, (s, e) in stages.items():
            self._observe(stage, e - s)
        self._observe("total", journey["total"])
        # SLO feed: the solverd hops of the journey — admission wait plus
        # batch execution — classified against the solve-latency objective.
        # This is exactly the karpenter_pod_scheduling_duration_seconds
        # stage data, re-read as a burn-rate series.
        from karpenter_tpu_torch.observability import slo

        for stage in ("admit", "solve"):
            window = stages.get(stage)
            if window is not None:
                slo.engine().observe(
                    "solve-latency", max(0.0, window[1] - window[0])
                )

    def _observe(self, stage: str, duration: float) -> None:
        _STAGE_HIST.observe(max(0.0, duration), {"stage": stage})
        values = self._durations.setdefault(stage, [])
        if len(values) < 200_000:  # sim-scale bound; stats stay exact below it
            # keep the list sorted as it grows: stats() reads percentiles
            # under the same lock the span hot path exports through, so it
            # must not re-sort the whole history per /debug/traces hit
            insort(values, max(0.0, duration))

    # -- queries -------------------------------------------------------------

    def stats(self) -> dict:
        """Per-stage duration distribution over completed journeys."""
        with self._lock:
            out: dict = {
                "completed": self.completed_count,
                "in_flight": len(self._pods),
                "stages": {},
            }
            for stage, values in self._durations.items():
                if not values:
                    continue
                # values is maintained sorted by _observe
                out["stages"][stage] = {
                    "count": len(values),
                    "p50": percentile(values, 50),
                    "p99": percentile(values, 99),
                    "max": values[-1],
                }
            return out

    def completed(self) -> list[dict]:
        with self._lock:
            return list(self._completed)

    def slowest(self, limit: int = 10) -> list[dict]:
        with self._lock:
            ranked = sorted(
                self._completed, key=lambda j: j["total"], reverse=True
            )
        return ranked[:limit]

    def for_trace(self, trace_id: str) -> list[dict]:
        with self._lock:
            return [j for j in self._completed if j["trace"] == trace_id]
