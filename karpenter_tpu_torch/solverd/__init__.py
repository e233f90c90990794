"""solverd: the batched solver service.

The subsystem that lifts the two in-process solvers — provisioning solves
and consolidation simulations — behind one service with request coalescing
(concurrent solves sharing a catalog merge their device sweeps into one
batch), admission control (bounded queue, per-request deadlines, per-tenant
quotas and weighted fairness, typed rejections instead of stalls), and two
transports behind one client interface: in-process (default, zero-copy) and
a length-prefixed JSON-over-socket daemon for sidecar deployment where the
daemon owns the accelerator. Multiple daemons form a fleet (fleet.py):
client-side failover over per-replica circuit breakers, catalog
content-hash affinity routing, request-id-deduped replay, and a
double-buffered admission pipeline. See docs/ARCHITECTURE.md.
"""

from karpenter_tpu_torch.solverd.api import (  # noqa: F401
    KIND_SIMULATE,
    KIND_SOLVE,
    DeadlineExceededError,
    DrainingError,
    QueueFullError,
    SolveRequest,
    SolverClosedError,
    SolverRejection,
    TenantQuotaExceededError,
    TransportError,
    new_request_id,
    should_failover,
)
from karpenter_tpu_torch.solverd.coalescer import Coalescer  # noqa: F401
from karpenter_tpu_torch.solverd.fleet import (  # noqa: F401
    AdmissionPipeline,
    FleetClient,
)
from karpenter_tpu_torch.solverd.queue import (  # noqa: F401
    AdmissionQueue,
    parse_tenant_weights,
)
from karpenter_tpu_torch.solverd.service import SolverService  # noqa: F401
from karpenter_tpu_torch.solverd.transport import (  # noqa: F401
    InProcessClient,
    SocketClient,
    SolverClient,
    SolverDaemon,
)


def build_solver(options, clock) -> SolverClient:
    """The operator's transport selector (operator/options.py): socket mode
    forwards to the daemon at --solver-daemon-address — a comma-separated
    address list builds a FleetClient with client-side failover over one
    SocketClient per replica — else an in-process service tuned by the
    solverd options. The operator's --cluster-name is its tenant identity
    toward the pool."""
    tenant = getattr(options, "cluster_name", "") or ""
    if getattr(options, "solver_transport", "inprocess") == "socket":
        address = getattr(options, "solver_daemon_address", "")
        addresses = [a.strip() for a in address.split(",") if a.strip()]
        if not addresses:
            # never fall back silently: in-process mode would initialize the
            # device locally and contend with the sidecar the operator was
            # meant to defer to
            raise ValueError(
                "--solver-transport socket requires --solver-daemon-address"
            )
        if len(addresses) == 1:
            return SocketClient(addresses[0], tenant=tenant)
        return FleetClient(
            [(addr, SocketClient(addr, tenant=tenant)) for addr in addresses],
            clock=clock,
            tenant=tenant,
            breaker_threshold=getattr(
                options, "solverd_replica_breaker_threshold", 3
            ),
            breaker_cooldown=getattr(
                options, "solverd_replica_breaker_cooldown", 5.0
            ),
        )
    return InProcessClient(
        SolverService(
            clock=clock,
            max_queue_depth=getattr(options, "solverd_queue_depth", 256),
            coalesce_window=getattr(options, "solverd_coalesce_window", 0.0),
            tenant_quota=getattr(options, "solverd_tenant_quota", 0),
            tenant_weights=parse_tenant_weights(
                getattr(options, "solverd_tenant_weights", "")
            ),
        ),
        tenant=tenant,
    )
