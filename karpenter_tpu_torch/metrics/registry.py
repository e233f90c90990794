"""Prometheus-style metrics: counters, gauges, histograms, and the gauge
lifecycle Store.

Mirrors the reference's pkg/metrics/metrics.go (namespaced constructors,
Measure() duration helper) and pkg/metrics/store.go:108 (Store: replace a
family of gauges atomically per reconcile so stale series disappear).
Exposition is a text dump — there is no HTTP scrape path in-process; the
operator exposes it (operator.py).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterable, Optional

NAMESPACE = "karpenter"

DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _label_key(labels: dict[str, str]) -> tuple:
    return tuple(sorted(labels.items()))


# One lock for all series mutation/exposition: the serving thread scrapes
# while the operator loop records; dict iteration during insert would
# otherwise race. Metric ops are rare enough that one lock is fine.
_LOCK = threading.Lock()


class Metric:
    def __init__(self, name: str, help: str, label_names: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)


class Counter(Metric):
    def __init__(self, name: str, help: str, label_names: Iterable[str] = ()):
        super().__init__(name, help, label_names)
        self._values: dict[tuple, float] = {}

    def inc(self, labels: Optional[dict[str, str]] = None, value: float = 1.0) -> None:
        with _LOCK:
            self._inc(labels, value)

    def _inc(self, labels: Optional[dict[str, str]], value: float) -> None:
        key = _label_key(labels or {})
        self._values[key] = self._values.get(key, 0.0) + value

    def value(self, labels: Optional[dict[str, str]] = None) -> float:
        return self._values.get(_label_key(labels or {}), 0.0)

    def total(self) -> float:
        return sum(self._values.values())


class Gauge(Metric):
    def __init__(self, name: str, help: str, label_names: Iterable[str] = ()):
        super().__init__(name, help, label_names)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, labels: Optional[dict[str, str]] = None) -> None:
        with _LOCK:
            self._values[_label_key(labels or {})] = value

    def add(self, value: float, labels: Optional[dict[str, str]] = None) -> None:
        with _LOCK:
            self._add(value, labels)

    def _add(self, value: float, labels: Optional[dict[str, str]]) -> None:
        key = _label_key(labels or {})
        self._values[key] = self._values.get(key, 0.0) + value

    def delete(self, labels: Optional[dict[str, str]] = None) -> None:
        self._values.pop(_label_key(labels or {}), None)

    def clear(self) -> None:
        """Drop every series of this gauge family atomically — the reset
        path for families whose label sets describe evicted objects (e.g.
        per-device memory after an engine rebuild)."""
        with _LOCK:
            self._values.clear()

    def value(self, labels: Optional[dict[str, str]] = None) -> float:
        return self._values.get(_label_key(labels or {}), 0.0)

    def series(self) -> dict[tuple, float]:
        return dict(self._values)


class Histogram(Metric):
    def __init__(
        self,
        name: str,
        help: str,
        label_names: Iterable[str] = (),
        buckets: tuple = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, label_names)
        self.buckets = buckets
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}

    def observe(self, value: float, labels: Optional[dict[str, str]] = None) -> None:
        with _LOCK:
            self._observe(value, labels)

    def _observe(self, value: float, labels: Optional[dict[str, str]]) -> None:
        key = _label_key(labels or {})
        counts = self._counts.setdefault(key, [0] * len(self.buckets))
        for i, b in enumerate(self.buckets):
            if value <= b:
                counts[i] += 1
        self._sums[key] = self._sums.get(key, 0.0) + value
        self._totals[key] = self._totals.get(key, 0) + 1

    def count(self, labels: Optional[dict[str, str]] = None) -> int:
        return self._totals.get(_label_key(labels or {}), 0)

    def sum(self, labels: Optional[dict[str, str]] = None) -> float:
        return self._sums.get(_label_key(labels or {}), 0.0)


class Registry:
    def __init__(self):
        self._metrics: dict[str, Metric] = {}

    def counter(self, name: str, help: str = "", labels: Iterable[str] = ()) -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help, labels), Counter)

    def gauge(self, name: str, help: str = "", labels: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help, labels), Gauge)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Iterable[str] = (),
        buckets: tuple = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, help, labels, buckets), Histogram
        )

    def _get_or_create(self, name, factory, cls):
        # registration happens at import time — including LAZY imports mid-run
        # (the first device solve pulls in ops/ffd) — so it must not race a
        # concurrent scrape iterating the metric dict
        with _LOCK:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name} already registered as {type(m).__name__}"
                )
            return m

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def expose(self) -> str:
        """Prometheus text-format dump (atomic vs concurrent recording)."""
        with _LOCK:
            return self._expose()

    def _expose(self) -> str:
        lines = []
        for m in self._metrics.values():
            lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {m.name} counter")
                for key, v in m._values.items():
                    lines.append(f"{m.name}{_fmt_labels(key)} {v}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {m.name} gauge")
                for key, v in m._values.items():
                    lines.append(f"{m.name}{_fmt_labels(key)} {v}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {m.name} histogram")
                for key, total in m._totals.items():
                    # bucket counts are stored cumulatively; the mandatory
                    # +Inf bucket equals _count (text exposition format)
                    counts = m._counts.get(key, [0] * len(m.buckets))
                    for bound, cumulative in zip(m.buckets, counts):
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_fmt_labels(key, le=_fmt_bound(bound))} "
                            f"{cumulative}"
                        )
                    lines.append(
                        f'{m.name}_bucket{_fmt_labels(key, le="+Inf")} {total}'
                    )
                    lines.append(f"{m.name}_sum{_fmt_labels(key)} {m._sums[key]}")
                    lines.append(f"{m.name}_count{_fmt_labels(key)} {total}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        self._metrics.clear()


def _escape_help(text: str) -> str:
    # HELP lines escape backslash and newline (not quotes)
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(value) -> str:
    # label values escape backslash, double-quote, and newline — in that
    # order, so the escaping backslashes are not themselves re-escaped
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_bound(bound: float) -> str:
    # integral bounds print without the trailing .0 (Prometheus convention:
    # le="1" and le="1.0" are DIFFERENT series to a scraper)
    return repr(float(bound)).removesuffix(".0")


def _fmt_labels(key: tuple, le: Optional[str] = None) -> str:
    pairs = list(key)
    if le is not None:
        pairs.append(("le", le))
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs)
    return "{" + inner + "}"


global_registry = Registry()


@contextmanager
def measure(histogram: Histogram, labels: Optional[dict[str, str]] = None):
    """Duration helper (pkg/metrics Measure())."""
    start = time.perf_counter()
    try:
        yield
    finally:
        histogram.observe(time.perf_counter() - start, labels)


class Store:
    """Gauge-family lifecycle manager (pkg/metrics/store.go:108): each
    Update replaces the full series set produced for an owner key, so series
    for deleted objects are removed on the next reconcile."""

    def __init__(self):
        self._owned: dict[str, list[tuple[Gauge, tuple]]] = {}

    def update(self, key: str, series: list[tuple[Gauge, dict[str, str], float]]) -> None:
        self.delete(key)
        owned = []
        for gauge, labels, value in series:
            gauge.set(value, labels)
            owned.append((gauge, _label_key(labels)))
        self._owned[key] = owned

    def delete(self, key: str) -> None:
        with _LOCK:
            for gauge, label_key in self._owned.pop(key, []):
                gauge._values.pop(label_key, None)

    def reset(self) -> None:
        for key in list(self._owned):
            self.delete(key)
