"""solverd request/response vocabulary: solve kinds, the request envelope,
and the typed admission rejections.

The solver service fronts every scheduling solve in the process — the
provisioner's batch solves and the disruption controllers' consolidation
simulations — behind one request shape, so both coalesce into the same
device batches and shed load through the same admission queue.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

KIND_SOLVE = "solve"
KIND_SIMULATE = "simulate"


class SolverRejection(Exception):
    """Base for typed admission-control rejections: the service refused the
    request WITHOUT running it. Callers distinguish these from solve errors
    — a rejection is retryable load-shedding, not a scheduling outcome."""

    retryable = True


class QueueFullError(SolverRejection):
    """The admission queue is at depth; the request was shed, not queued."""


class DeadlineExceededError(SolverRejection):
    """The request's deadline passed before execution started (on offer or
    while waiting in the queue)."""


class SolverClosedError(SolverRejection):
    """The service is shutting down and admits nothing.

    ``failover = True``: a closed replica is *gone*, not overloaded — a
    pool client should re-route the request to a healthy sibling instead
    of surfacing the rejection."""

    failover = True


class DrainingError(SolverRejection):
    """The service is draining (SIGTERM): in-flight batches finish, new
    requests are refused with this typed answer — shed, never block — so a
    pool client fails over to a replica that is not about to exit."""

    failover = True


class TenantQuotaExceededError(SolverRejection):
    """The tenant's share of the admission queue is exhausted; the request
    was shed WITHOUT touching other tenants' headroom. Deliberately not a
    failover trigger: the quota is per-tenant policy, and hopping replicas
    to escape it would let a noisy tenant multiply its share by the pool
    size."""


class TransportError(Exception):
    """Socket-transport failure (framing, connection, codec) — distinct from
    rejections: the daemon may never have seen the request. Retryable: the
    client has already exhausted its reconnect-with-backoff budget, but the
    controller loop may safely re-submit on a later pass."""

    retryable = True


@dataclass
class SolveRequest:
    """One scheduling solve to run through the service.

    `scheduler` is a fully built Scheduler (the caller owns construction —
    provisioning and simulation build different cluster views); `pods` is
    the queue the solve processes. `timeout` bounds the solve itself;
    `deadline` is an absolute clock time bounding ADMISSION — a request
    still queued past it is rejected, never run.

    `trace_context` is the caller's span carrier ({"trace_id", "span_id"}
    or None): it rides the request itself so service-side spans (queue
    wait, coalesce, solve) parent to the ORIGINATING trace on both
    transports — the in-process path passes it through, the socket path
    puts the same fields in the JSON frame. Context must live on the
    request, not ambient state: a coalesced batch executes many callers'
    requests on one leader thread.

    `request_id` identifies the solve across retries: a transport that
    replays an in-flight frame (reconnect, pool failover) reuses the id, and
    the service dedupes on it — a replayed solve attaches to the original
    admission instead of admitting (and executing) twice. `tenant` names the
    requesting cluster for per-tenant admission quotas and weighted
    fairness; empty string is the single-tenant default.

    `group` tags requests submitted together as one structured batch — the
    consolidation frontier search tags each round's probes with one group
    id. `group_nested` declares the group's pod sets are nested prefixes
    (multi-node frontier rounds): the coalescer then primes the group's
    joint masks from its LARGEST member only, whose row-sets cover the
    whole group. Disjoint groups (single-node rounds) leave it False and
    collect per member — largest-member priming would skip the siblings'
    row-sets entirely."""

    kind: str
    scheduler: object
    pods: Sequence = field(default_factory=list)
    timeout: Optional[float] = None
    deadline: Optional[float] = None
    client: str = ""
    trace_context: Optional[dict] = None
    group: Optional[str] = None
    group_nested: bool = False
    request_id: str = ""
    tenant: str = ""


def new_request_id() -> str:
    """A fresh request id. Rides the seeded uid source when one is
    installed (apis/core) so simulated runs stay byte-deterministic."""
    from karpenter_tpu_torch.apis.core import new_uid

    return f"req-{new_uid()}"


def should_failover(err: Exception) -> bool:
    """Whether a pool client should replay this failure on another replica:
    transport loss (the daemon may never have seen the frame) and
    going-away rejections (draining / closed) — never backpressure answers
    (queue full, deadline, tenant quota) and never solve outcomes."""
    if isinstance(err, TransportError):
        return True
    return isinstance(err, SolverRejection) and getattr(err, "failover", False)
