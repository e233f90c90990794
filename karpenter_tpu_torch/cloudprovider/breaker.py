"""Cloud-provider circuit breaker decorator.

Wraps any CloudProvider so ``create``/``delete`` flow through one
CircuitBreaker (operator/harness.py): after N consecutive retryable
failures the breaker opens and both methods fast-fail with the typed
``CircuitBreakerOpenError`` instead of hammering a broken cloud every
reconcile pass; after the cooldown one half-open probe is let through, and
its outcome closes or re-opens the breaker.

Layering (operator.py): Breaker(Metrics(provider)) — the metrics decorator
sits INSIDE so fast-fails are never miscounted as provider errors or
latency; only calls that actually reach the cloud are metered.

Read-side methods (get/list/get_instance_types/is_drifted) bypass the
breaker: they are cheap, their staleness is tolerable, and blocking them
would blind the very controllers that drain a broken cloud's state.
"""

from __future__ import annotations

from karpenter_tpu_torch import tracing
from karpenter_tpu_torch.cloudprovider.types import (
    CircuitBreakerOpenError,
    is_retryable_error,
)
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.operator import logging as klog
from karpenter_tpu_torch.operator.harness import CircuitBreaker
from karpenter_tpu_torch.utils.clock import Clock

_log = klog.logger("cloudprovider.breaker")

_STATE_VALUES = {
    CircuitBreaker.CLOSED: 0.0,
    CircuitBreaker.HALF_OPEN: 1.0,
    CircuitBreaker.OPEN: 2.0,
}
_STATE = global_registry.gauge(
    "karpenter_cloudprovider_circuit_breaker_state",
    "circuit breaker state (0 closed, 1 half-open, 2 open)",
    labels=["provider"],
)
_TRANSITIONS = global_registry.counter(
    "karpenter_cloudprovider_circuit_breaker_transitions_total",
    "circuit breaker state transitions",
    labels=["provider", "to"],
)


class BreakerCloudProvider:
    """CircuitBreaker around create/delete; everything else delegates."""

    def __init__(
        self,
        inner,
        clock: Clock,
        threshold: int = 5,
        cooldown: float = 30.0,
    ):
        self._inner = inner
        try:
            provider = inner.name()
        except Exception:  # noqa: BLE001 — name() must not break wrapping
            provider = type(inner).__name__
        self.breaker = CircuitBreaker(
            clock, threshold=threshold, cooldown=cooldown, name=provider
        )
        self.breaker.subscribe(self._on_transition)
        _STATE.set(0.0, {"provider": provider})

    def _on_transition(self, old: str, new: str) -> None:
        _STATE.set(_STATE_VALUES[new], {"provider": self.breaker.name})
        _TRANSITIONS.inc({"provider": self.breaker.name, "to": new})
        _log.warning(
            "cloud provider circuit breaker transition",
            provider=self.breaker.name,
            **{"from": old, "to": new},
        )

    def _guarded(self, method: str, *args):
        # every guarded call is a span carrying breaker state — nested under
        # whatever journey hop invoked it (nodeclaim.launch, finalization),
        # so a fast-fail shows up in the pod's trace as exactly that
        with tracing.tracer().span(
            f"cloudprovider.{method}", breaker_state=self.breaker.state
        ) as span:
            if not self.breaker.allow():
                retry_after = self.breaker.retry_after()
                span.set_attr(fast_fail=True)
                raise CircuitBreakerOpenError(
                    f"cloud provider circuit breaker open for {method!r} "
                    f"(retry in {retry_after:.1f}s)",
                    retry_after=retry_after,
                )
            # allow() may have transitioned open -> half-open: record the
            # state the call actually ran under
            span.set_attr(breaker_state=self.breaker.state)
            try:
                result = getattr(self._inner, method)(*args)
            except Exception as e:
                if is_retryable_error(e):
                    self.breaker.record_failure()
                    span.set_attr(retryable=True)
                else:
                    # a typed domain answer: the cloud is alive and responding
                    self.breaker.record_success()
                    span.set_attr(retryable=False)
                raise
            self.breaker.record_success()
            return result

    def create(self, node_claim):
        return self._guarded("create", node_claim)

    def delete(self, node_claim):
        return self._guarded("delete", node_claim)

    def get(self, provider_id):
        return self._inner.get(provider_id)

    def list(self):
        return self._inner.list()

    def get_instance_types(self, node_pool):
        return self._inner.get_instance_types(node_pool)

    def is_drifted(self, node_claim):
        return self._inner.is_drifted(node_claim)

    def repair_policies(self):
        return self._inner.repair_policies()

    def name(self):
        return self._inner.name()

    def __getattr__(self, attr):
        # guard the delegate attribute itself: during unpickling __getattr__
        # runs before __dict__ is restored, and delegating a missing _inner
        # to itself recurses forever
        if attr == "_inner":
            raise AttributeError(attr)
        return getattr(self._inner, attr)
