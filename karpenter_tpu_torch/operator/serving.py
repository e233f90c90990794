"""HTTP serving: /metrics, /healthz, /readyz, and profiling endpoints.

Mirrors the reference's operator serving surface
(pkg/operator/operator.go:169-208): a metrics server exposing the
Prometheus registry, health/readiness probes, and — behind
--enable-profiling — pprof-style introspection (/debug/stacks dumps all
thread stacks; /debug/profile?seconds=N runs a cProfile sample and returns
the stats text). Runs on daemon threads; never blocks the operator loop.
"""

from __future__ import annotations

import io
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse


class ServingConfig:
    def __init__(
        self,
        metrics_text: Callable[[], str],
        healthy: Callable[[], bool],
        ready: Callable[[], bool],
        enable_profiling: bool = False,
        solverd_stats: Optional[Callable[[], dict]] = None,
        health_snapshot: Optional[Callable[[], dict]] = None,
        trace_snapshot: Optional[Callable[..., Optional[dict]]] = None,
        heap_stats: Optional[Callable[[], dict]] = None,
        kernel_snapshot: Optional[Callable[..., Optional[dict]]] = None,
        slo_snapshot: Optional[Callable[..., Optional[dict]]] = None,
        flight_snapshot: Optional[Callable[..., Optional[dict]]] = None,
        device_profile: Optional[Callable[[float], Optional[dict]]] = None,
        journal_snapshot: Optional[Callable[[], Optional[dict]]] = None,
        explain_snapshot: Optional[Callable[..., Optional[dict]]] = None,
    ):
        self.metrics_text = metrics_text
        self.healthy = healthy
        self.ready = ready
        self.enable_profiling = enable_profiling
        # interning-cache sizes (operator.heap_stats): folded into
        # /debug/heap so allocation hotspots and the solver's unbounded-by-
        # default caches show up in one place
        self.heap_stats = heap_stats
        # solverd introspection (queue depth, batches, coalesce stats);
        # served at /debug/solverd when wired (operator.solver_stats)
        self.solverd_stats = solverd_stats
        # structured health (operator.health_snapshot): when wired, /healthz
        # serves the snapshot as JSON (503 when degraded, with the reasons
        # in the body) and /debug/health always returns the full document
        self.health_snapshot = health_snapshot
        # scheduling traces (operator.trace_snapshot): /debug/traces serves
        # the last-N traces, ?trace_id= drill-down (404 when unknown), and
        # ?view=slowest for the slowest pod journeys
        self.trace_snapshot = trace_snapshot
        # kernel observatory (operator.kernel_snapshot): /debug/kernels
        # serves the per-kernel compile/execute table, ?kernel= drill-down
        # into per-shape-bucket stats (404 when unknown); unwired => 404
        self.kernel_snapshot = kernel_snapshot
        # SLO engine (operator.slo_snapshot): /debug/slo serves the
        # objective table with burn rates and budget remaining,
        # ?objective= drill-down (404 when unknown); unwired => 404
        self.slo_snapshot = slo_snapshot
        # flight recorder (operator.flight_snapshot): /debug/flight serves
        # the ring summary + bundle listing, ?bundle= drill-down into one
        # bundle's frames (404 when unknown); unwired => 404
        self.flight_snapshot = flight_snapshot
        # write-ahead intent journal (operator.journal_snapshot):
        # /debug/journal serves mode/depth/append counters plus every
        # pending intent — what recovery would replay on a crash right now;
        # unwired => 404
        self.journal_snapshot = journal_snapshot
        # decision provenance (operator.explain_snapshot): /debug/explain
        # serves the unschedulable-pod triage table, ?pod= drill-down into
        # one pod's stage-by-stage elimination funnel (404 when unknown),
        # and ?pod=X&what_if=drop:<key> counterfactual probes (400 on
        # malformed what_if); ledger disabled or unwired => 404
        self.explain_snapshot = explain_snapshot
        # triggered device profiling (operator.device_profile_snapshot):
        # /debug/profile/device?seconds=N runs a synchronous jax.profiler
        # capture into --profile-dir. Returns None when profiling is off
        # (404); bad/out-of-range seconds are rejected here (400)
        self.device_profile = device_profile


def _profile_sample(seconds: float, interval: float = 0.01) -> str:
    """Statistical CPU sampler across ALL threads (cProfile is thread-local
    and would only see this handler sleeping): sample sys._current_frames
    every `interval`, aggregate leaf and whole-stack counts — the pprof-style
    view of where the operator loop and solver actually spend time."""
    import collections
    import time

    deadline = time.monotonic() + min(seconds, 30.0)
    me = threading.get_ident()
    leaf_counts: collections.Counter = collections.Counter()
    stack_counts: collections.Counter = collections.Counter()
    samples = 0
    while time.monotonic() < deadline:
        for thread_id, frame in sys._current_frames().items():
            if thread_id == me:
                continue
            stack = []
            f = frame
            while f is not None and len(stack) < 40:
                code = f.f_code
                stack.append(f"{code.co_filename}:{f.f_lineno}:{code.co_name}")
                f = f.f_back
            if not stack:
                continue
            leaf_counts[stack[0]] += 1
            stack_counts[";".join(reversed(stack))] += 1
        samples += 1
        time.sleep(interval)
    out = [f"# {samples} samples over {seconds}s at {interval * 1000:.0f}ms"]
    out.append("\n== hottest frames ==")
    for loc, n in leaf_counts.most_common(40):
        out.append(f"{n:6d} {loc}")
    out.append("\n== hottest stacks ==")
    for stack, n in stack_counts.most_common(15):
        out.append(f"{n:6d} {stack}")
    return "\n".join(out)


def _heap_snapshot(cfg: "ServingConfig", top: int = 15, stop: bool = False) -> dict:
    """tracemalloc-backed heap introspection (profiling surface, like
    /debug/profile). The first request arms tracemalloc and returns only
    the interning-cache sizes; subsequent requests add the top allocation
    sites recorded since. Arming on demand keeps the steady-state operator
    free of tracemalloc's overhead unless someone is actually looking —
    and `?stop=1` disarms it again (the final snapshot is returned), so an
    investigation's tracing cost ends with the investigation instead of
    persisting until restart."""
    import tracemalloc

    was_tracing = tracemalloc.is_tracing()
    if stop:
        payload = {"tracing": False, "armed_now": False, "stopped_now": was_tracing}
        if was_tracing:
            current, peak = tracemalloc.get_traced_memory()
            payload["traced_current_bytes"] = current
            payload["traced_peak_bytes"] = peak
            stats = tracemalloc.take_snapshot().statistics("lineno")[: max(top, 1)]
            payload["top_allocations"] = [
                {
                    "site": (
                        f"{s.traceback[0].filename}:{s.traceback[0].lineno}"
                        if len(s.traceback) else "?"
                    ),
                    "size_bytes": s.size,
                    "count": s.count,
                }
                for s in stats
            ]
            tracemalloc.stop()
        if cfg.heap_stats is not None:
            payload["interning_caches"] = cfg.heap_stats()
        return payload
    if not was_tracing:
        tracemalloc.start()
    payload = {"tracing": True, "armed_now": not was_tracing}
    if was_tracing:
        current, peak = tracemalloc.get_traced_memory()
        payload["traced_current_bytes"] = current
        payload["traced_peak_bytes"] = peak
        stats = tracemalloc.take_snapshot().statistics("lineno")[: max(top, 1)]
        payload["top_allocations"] = [
            {
                "site": (
                    f"{s.traceback[0].filename}:{s.traceback[0].lineno}"
                    if len(s.traceback) else "?"
                ),
                "size_bytes": s.size,
                "count": s.count,
            }
            for s in stats
        ]
    else:
        payload["note"] = (
            "tracemalloc armed; re-query to see allocations recorded since"
        )
    if cfg.heap_stats is not None:
        payload["interning_caches"] = cfg.heap_stats()
    return payload


def _stacks() -> str:
    out = []
    for thread_id, frame in sys._current_frames().items():
        out.append(f"--- thread {thread_id} ---")
        out.extend(traceback.format_stack(frame))
    return "\n".join(out)


class _Handler(BaseHTTPRequestHandler):
    config: ServingConfig  # set on the subclass per server

    def log_message(self, *args) -> None:  # quiet: operator logs are JSON
        pass

    def _respond(self, code: int, body: str, content_type: str = "text/plain") -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        cfg = self.config
        url = urlparse(self.path)
        try:
            if url.path == "/metrics":
                self._respond(200, cfg.metrics_text(), "text/plain; version=0.0.4")
            elif url.path == "/healthz":
                if cfg.health_snapshot is not None:
                    import json

                    snap = cfg.health_snapshot()
                    self._respond(
                        200 if snap.get("healthy") else 503,
                        json.dumps(snap),
                        "application/json",
                    )
                else:
                    ok = cfg.healthy()
                    self._respond(200 if ok else 500, "ok" if ok else "unhealthy")
            elif url.path == "/readyz":
                ok = cfg.ready()
                self._respond(200 if ok else 500, "ok" if ok else "not ready")
            elif url.path == "/debug/health" and cfg.health_snapshot is not None:
                import json

                # the full health document, always 200: this is the operator
                # debugging surface, not the probe — a degraded operator must
                # still explain itself
                self._respond(
                    200, json.dumps(cfg.health_snapshot()), "application/json"
                )
            elif url.path == "/debug/traces" and cfg.trace_snapshot is not None:
                import json

                q = parse_qs(url.query)
                snap = cfg.trace_snapshot(
                    trace_id=q.get("trace_id", [None])[0],
                    view=q.get("view", [None])[0],
                    limit=int(q.get("limit", ["20"])[0]),
                )
                if snap is None:
                    self._respond(
                        404, json.dumps({"error": "unknown trace_id"}),
                        "application/json",
                    )
                else:
                    self._respond(200, json.dumps(snap), "application/json")
            elif url.path == "/debug/kernels" and cfg.kernel_snapshot is not None:
                import json

                q = parse_qs(url.query)
                snap = cfg.kernel_snapshot(
                    kernel=q.get("kernel", [None])[0],
                    view=q.get("view", [None])[0],
                )
                if snap is None:
                    self._respond(
                        404, json.dumps({"error": "unknown kernel"}),
                        "application/json",
                    )
                else:
                    self._respond(200, json.dumps(snap), "application/json")
            elif url.path == "/debug/slo" and cfg.slo_snapshot is not None:
                import json

                q = parse_qs(url.query)
                snap = cfg.slo_snapshot(
                    objective=q.get("objective", [None])[0],
                    tenant=q.get("tenant", [None])[0],
                )
                if snap is None:
                    self._respond(
                        404, json.dumps({"error": "unknown objective"}),
                        "application/json",
                    )
                else:
                    self._respond(200, json.dumps(snap), "application/json")
            elif url.path == "/debug/flight" and cfg.flight_snapshot is not None:
                import json

                q = parse_qs(url.query)
                snap = cfg.flight_snapshot(bundle=q.get("bundle", [None])[0])
                if snap is None:
                    self._respond(
                        404, json.dumps({"error": "unknown bundle"}),
                        "application/json",
                    )
                else:
                    self._respond(200, json.dumps(snap), "application/json")
            elif url.path == "/debug/explain" and cfg.explain_snapshot is not None:
                import json

                q = parse_qs(url.query)
                pod = q.get("pod", [None])[0]
                what_if = q.get("what_if", [None])[0]
                if what_if is not None and (
                    pod is None
                    or not what_if.startswith("drop:")
                    or not what_if.split(":", 1)[1]
                ):
                    self._respond(
                        400,
                        json.dumps(
                            {
                                "error": "what_if requires ?pod= and the "
                                "form drop:<requirement-key>"
                            }
                        ),
                        "application/json",
                    )
                else:
                    snap = cfg.explain_snapshot(pod=pod, what_if=what_if)
                    if snap is None:
                        self._respond(
                            404,
                            json.dumps(
                                {"error": "explain ledger disabled or unknown pod"}
                            ),
                            "application/json",
                        )
                    else:
                        self._respond(200, json.dumps(snap), "application/json")
            elif url.path == "/debug/journal" and cfg.journal_snapshot is not None:
                import json

                snap = cfg.journal_snapshot()
                if snap is None:
                    self._respond(
                        404, json.dumps({"error": "journal unavailable"}),
                        "application/json",
                    )
                else:
                    self._respond(200, json.dumps(snap), "application/json")
            elif (
                url.path == "/debug/profile/device"
                and cfg.device_profile is not None
            ):
                import json

                raw = parse_qs(url.query).get("seconds", ["1.0"])[0]
                try:
                    seconds = float(raw)
                except ValueError:
                    seconds = None
                if seconds is None or not (0.0 <= seconds <= 30.0):
                    self._respond(
                        400,
                        json.dumps(
                            {"error": "seconds must be a number in [0, 30]"}
                        ),
                        "application/json",
                    )
                else:
                    snap = cfg.device_profile(seconds)
                    if snap is None:
                        self._respond(
                            404,
                            json.dumps(
                                {
                                    "error": "device profiling disabled "
                                    "(--profile-dir not set or jax.profiler "
                                    "unavailable)"
                                }
                            ),
                            "application/json",
                        )
                    else:
                        self._respond(
                            200, json.dumps(snap), "application/json"
                        )
            elif url.path == "/debug/solverd" and cfg.solverd_stats is not None:
                import json

                self._respond(
                    200, json.dumps(cfg.solverd_stats()), "application/json"
                )
            elif url.path == "/debug/heap" and cfg.enable_profiling:
                import json

                q = parse_qs(url.query)
                self._respond(
                    200,
                    json.dumps(
                        _heap_snapshot(
                            cfg,
                            top=int(q.get("top", ["15"])[0]),
                            stop=q.get("stop", ["0"])[0] == "1",
                        )
                    ),
                    "application/json",
                )
            elif url.path == "/debug/stacks" and cfg.enable_profiling:
                self._respond(200, _stacks())
            elif url.path == "/debug/profile" and cfg.enable_profiling:
                seconds = float(
                    parse_qs(url.query).get("seconds", ["1.0"])[0]
                )
                self._respond(200, _profile_sample(seconds))
            else:
                self._respond(404, "not found")
        except Exception as e:  # noqa: BLE001 — serving must not die
            try:
                self._respond(500, f"error: {e}")
            except OSError:
                pass


class Server:
    """One ThreadingHTTPServer on a daemon thread."""

    def __init__(self, port: int, config: ServingConfig, host: str = ""):
        handler = type("BoundHandler", (_Handler,), {"config": config})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "Server":
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, name="karpenter-serving", daemon=True
        )
        self.thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
