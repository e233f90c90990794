"""CloudProvider metrics decorator.

Mirrors the reference's pkg/cloudprovider/metrics/cloudprovider.go: wraps
any provider so every interface method records a duration histogram and an
error counter (labeled by method, provider, and error type). The operator
wraps the provider by default, so provider latency/fault visibility needs
no provider cooperation.
"""

from __future__ import annotations

import time

from karpenter_tpu_torch.cloudprovider.types import is_retryable_error
from karpenter_tpu_torch.metrics import global_registry

_DURATION = global_registry.histogram(
    "karpenter_cloudprovider_duration_seconds",
    "duration of cloud provider method calls",
    labels=("controller", "method", "provider"),
)
_ERRORS = global_registry.counter(
    "karpenter_cloudprovider_errors_total",
    "total errors returned from cloud provider methods",
    labels=("controller", "method", "provider", "error", "retryable"),
)

class MetricsCloudProvider:
    """Duration/error instrumentation around every provider method; all
    other attributes delegate to the wrapped provider."""

    def __init__(self, inner, controller: str = ""):
        self._inner = inner
        self._controller = controller
        try:
            self._provider = inner.name()
        except Exception:  # noqa: BLE001 — name() must not break wrapping
            self._provider = type(inner).__name__

    def _call(self, method: str, *args, **kwargs):
        labels = {
            "controller": self._controller,
            "method": method,
            "provider": self._provider,
        }
        start = time.perf_counter()
        try:
            return getattr(self._inner, method)(*args, **kwargs)
        except Exception as e:
            # retryable distinguishes infrastructure failures (what the
            # circuit breaker counts) from typed domain answers like
            # not-found — an alert on retryable=true is an outage signal
            _ERRORS.inc(
                {
                    **labels,
                    "error": type(e).__name__,
                    "retryable": "true" if is_retryable_error(e) else "false",
                }
            )
            raise
        finally:
            _DURATION.observe(time.perf_counter() - start, labels)

    def create(self, node_claim):
        return self._call("create", node_claim)

    def delete(self, node_claim):
        return self._call("delete", node_claim)

    def get(self, provider_id):
        return self._call("get", provider_id)

    def list(self):
        return self._call("list")

    def get_instance_types(self, node_pool):
        return self._call("get_instance_types", node_pool)

    def is_drifted(self, node_claim):
        return self._call("is_drifted", node_claim)

    def repair_policies(self):
        return self._call("repair_policies")

    def name(self):
        return self._inner.name()

    def __getattr__(self, attr):
        # guard the delegate attribute itself: during unpickling __getattr__
        # runs before __dict__ is restored, and delegating a missing _inner
        # to itself recurses forever
        if attr == "_inner":
            raise AttributeError(attr)
        return getattr(self._inner, attr)
