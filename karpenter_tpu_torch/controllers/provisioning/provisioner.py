"""Provisioner: the singleton loop turning pending pods into NodeClaims.

Mirrors the reference's provisioning/provisioner.go:100-515 — batch pending
pods, gate on cluster sync, build a scheduler over ready nodepools, solve,
truncate, create claims with a limits re-check.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import Affinity, NodeAffinity, ObjectMeta, Pod, new_uid
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim as APINodeClaim
from karpenter_tpu_torch.controllers.provisioning.batcher import Batcher
from karpenter_tpu_torch.device import KernelError
from karpenter_tpu_torch.events.recorder import Event, Recorder
from karpenter_tpu_torch.mesh import Mesh, build_solver_mesh
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.cloudprovider.types import CloudProvider
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.scheduler.nodeclaim import NodeClaim as SchedNodeClaim
from karpenter_tpu_torch.scheduler.scheduler import Results, Scheduler
from karpenter_tpu_torch.scheduler.topology import Topology
from karpenter_tpu_torch.scheduler.volumetopology import VolumeTopology
from karpenter_tpu_torch.scheduling.requirements import Operator, pod_requirements
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.statenode import StateNode, active, deleting
from karpenter_tpu_torch.utils import nodepool as nodepoolutil
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch import tracing
from karpenter_tpu_torch.operator import logging as klog
from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch.utils.pdb import Limits

_log = klog.logger("provisioner")

PROVISIONED_REASON = "provisioned"

_NODECLAIMS_CREATED = global_registry.counter(
    "karpenter_nodeclaims_created_total",
    "nodeclaims created",
    labels=["reason", "nodepool", "min_values_relaxed"],
)
_IGNORED_PODS = global_registry.gauge(
    "karpenter_scheduler_ignored_pod_count", "pods ignored by validation"
)

SOLVE_TIMEOUT = 60.0  # provisioner.go:343-345


class NoNodePoolsError(Exception):
    pass


_ENGINE_CONTENT_CACHE: dict[tuple, object] = {}


def _type_fingerprint(it) -> tuple:
    return (
        it.name,
        tuple(
            (r.key, r.complement, tuple(sorted(r.values)), r.greater_than, r.less_than)
            for r in it.requirements
        ),
        tuple(
            (o.zone, o.capacity_type, o.price, o.available, o.reservation_id)
            for o in it.offerings
        ),
        tuple(sorted(it.capacity.items())),
        tuple(sorted(it.overhead.total().items())),
    )


# port: the solver mesh is karpenter_tpu_torch.mesh's, over the CUDA devices
# (None, with a warning, when there are fewer cards than asked for)
_build_solver_mesh = build_solver_mesh


def _engine_mesh(shard_devices: int, device):
    """port: the mesh of an engine on `device`: over the cards
    (`_build_solver_mesh`) for the card's engine; for a CPU engine the CPU
    repeated `shard_devices` times (the per-shard plain path, as the
    reference's CPU dryrun shards over virtual devices), never the cards."""
    if device is not None and torch.device(device).type == "cpu":
        return Mesh([torch.device("cpu")] * shard_devices) if shard_devices >= 1 else None
    return _build_solver_mesh(shard_devices)


def default_engine_factory(shard_devices: int = 0, device=None):
    """CatalogEngine per distinct instance-type union. Two cache levels: an
    id-keyed fast path (providers return stable InstanceType objects, so the
    steady-state lookup is free) backed by a process-wide content-keyed cache
    so equal catalogs built by different provider instances share one encode
    + compile.

    port: `device` is the engines' torch device — None is the card, and
    building an engine without one raises; "cpu" runs the plain versions
    of the kernels (the tests)."""
    from karpenter_tpu_torch.ops.catalog import CatalogEngine

    id_cache: dict[tuple, object] = {}

    def factory(instance_types: dict):
        seen: set[int] = set()
        all_types = []
        for its in instance_types.values():
            for it in its:
                if id(it) not in seen:
                    seen.add(id(it))
                    all_types.append(it)
        if not all_types:
            return None
        id_key = tuple(sorted(seen))
        engine = id_cache.get(id_key)
        if engine is None:
            # shard_devices is part of the key: an engine carries its mesh
            # (port: and so is its device — a CPU and a CUDA engine never
            # share an entry)
            content_key = (
                shard_devices,
                device,
                tuple(_type_fingerprint(it) for it in all_types),
            )
            engine = _ENGINE_CONTENT_CACHE.get(content_key)
            if engine is None:
                # fresh engine build = prior per-device gauge samples are
                # stale (they describe evicted engines); clear the family
                # so /metrics never serves dead allocations — the first
                # solve batch (and the daemon rebuild path) resamples
                from karpenter_tpu_torch.observability import kernels as kobs

                kobs.reset_device_memory()
                engine = CatalogEngine(
                    all_types, device=device, mesh=_engine_mesh(shard_devices, device),
                )
                _ENGINE_CONTENT_CACHE[content_key] = engine
            # hold type refs so ids stay unique for the cache key's lifetime
            id_cache[id_key] = engine
        return engine

    return factory


class Provisioner:
    def __init__(
        self,
        store: Store,
        cloud_provider: CloudProvider,
        cluster: Cluster,
        recorder: Recorder,
        clock: Clock,
        options: Optional[Options] = None,
        engine_factory=None,
        solver=None,
    ):
        self.store = store
        self.cloud_provider = cloud_provider
        self.cluster = cluster
        self.recorder = recorder
        self.clock = clock
        self.options = options or Options()
        self.batcher: Batcher[str] = Batcher(
            clock,
            idle_duration=self.options.batch_idle_duration,
            max_duration=self.options.batch_max_duration,
        )
        self.volume_topology = VolumeTopology(store)
        # CatalogEngine factory for the device-backed solver path. Defaults
        # ON (options.solver_backend == "tpu"): the fast path IS the real
        # path; pass solver_backend="host" or engine_factory=False to opt out.
        if engine_factory is None and self.options.solver_backend == "tpu":
            engine_factory = default_engine_factory(
                shard_devices=self.options.solver_pod_shard_axis
            )
        self.engine_factory = engine_factory or None
        # Every solve — provisioning batches here and the disruption
        # controllers' simulations (disruption/helpers.py) — goes through
        # the solverd client so concurrent requests coalesce into shared
        # device batches and overload sheds with typed rejections.
        if solver is None:
            from karpenter_tpu_torch.solverd import build_solver

            solver = build_solver(self.options, clock)
        self.solver = solver

    def trigger(self, uid: str) -> None:
        self.batcher.trigger(uid)

    # -- reconcile loop (provisioner.go:116-142) ----------------------------

    def reconcile(self) -> Optional[Results]:
        if not self.batcher.ready():
            return None
        # Gate BEFORE consuming: an unsynced cluster keeps the batch pending
        # so the next loop pass retries it instead of dropping it.
        if not self.cluster.synced():
            return None
        pending_since = self.batcher.consume() or {}
        from karpenter_tpu_torch.solverd import SolverRejection, TransportError

        # One trace per batch (parent=None: the batch is the request, not a
        # detail of whichever reconcile pass flushed it); every hop of every
        # pod's journey — solverd spans on either transport, nodeclaim
        # create/launch/registration, the eventual bind — joins this trace.
        with tracing.tracer().span(
            "provisioner.batch", parent=None, triggered=len(pending_since)
        ) as batch_span:
            from karpenter_tpu_torch.observability import slo

            try:
                results = self.schedule(pending_since=pending_since)
                # SLO feed: the solve was executed, not shed — one good
                # event on the operator-visible availability objective
                slo.engine().record(
                    "solverd-availability", good=1,
                    tenant=self.options.cluster_name,
                )
                if results is not None and not getattr(
                    self, "_kernels_sealed", False
                ):
                    # the first EXECUTED solve closes the warmup window: its
                    # residual shape-keyed compiles are the known cold start
                    # (prewarm cannot prepay them — executables are keyed by
                    # the batch's padded cube shape); any compile after this
                    # is a steady-state recompile and trips the contract
                    self._kernels_sealed = True
                    from karpenter_tpu_torch.observability import kernels as kobs

                    kobs.registry().seal()
            except (SolverRejection, TransportError) as e:
                # Shed/unreachable solver: degrade, don't crash the loop. The
                # operator re-triggers every provisionable pod each pass, so
                # the batch re-forms and retries on its own.
                slo.engine().record(
                    "solverd-availability", bad=1,
                    tenant=self.options.cluster_name,
                )
                batch_span.fail(e)
                # NOTE: `message=` would collide with the logger's own
                # positional message parameter and raise TypeError out of
                # the except block — turning graceful degradation into a
                # harness-counted reconcile failure
                _log.warning(
                    "solve shed; will retry next batch",
                    error=f"{type(e).__name__}: {e}",
                )
                return None
            if results is None or not results.new_node_claims:
                batch_span.set_attr(nodeclaims=0)
                return results
            batch_span.set_attr(
                nodeclaims=len(results.new_node_claims),
                pods=sum(len(nc.pods) for nc in results.new_node_claims),
                failed=len(results.pod_errors),
            )
            _log.info(
                "computed new nodeclaim(s) to fit pod(s)",
                nodeclaims=len(results.new_node_claims),
                pods=sum(len(nc.pods) for nc in results.new_node_claims),
                failed=len(results.pod_errors),
            )
            self.create_node_claims(
                results.new_node_claims, reason=PROVISIONED_REASON,
                record_pod_nomination=True,
            )
            return results

    # -- scheduling ---------------------------------------------------------

    def get_pending_pods(self) -> list[Pod]:
        """Provisionable pods passing validation (provisioner.go:161-183)."""
        pods = self.store.list("Pod", predicate=podutil.is_provisionable)
        accepted = []
        rejected = 0
        for pod in pods:
            err = self.validate(pod)
            if err is not None:
                self.cluster.mark_pod_scheduling_decisions(
                    {pod: ValueError(f"ignoring pod, {err}")}, {}, {}
                )
                rejected += 1
                continue
            accepted.append(pod)
        _IGNORED_PODS.set(float(rejected))
        return accepted

    def validate(self, pod: Pod) -> Optional[str]:
        """provisioner.go:482-515."""
        for req in pod_requirements(pod):
            if req.key == wk.NODEPOOL_LABEL_KEY and req.operator == Operator.DOES_NOT_EXIST:
                return "configured to not run on a Karpenter provisioned node"
        err = _validate_requirement_terms(pod)
        if err is not None:
            return err
        return self.volume_topology.validate_persistent_volume_claims(pod)

    def get_daemonset_pods(self) -> list[Pod]:
        """Template pods for daemon overhead (provisioner.go:399-420),
        preferring a live pod cached in cluster state."""
        out = []
        for ds in self.store.list("DaemonSet"):
            pod = self.cluster.get_daemonset_pod(ds)
            if pod is None:
                pod = Pod(
                    metadata=ObjectMeta(
                        name=f"{ds.metadata.name}-template",
                        namespace=ds.metadata.namespace,
                    ),
                    spec=copy.deepcopy(ds.spec.template_spec),
                )
            else:
                pod = copy.deepcopy(pod)
            template_aff = ds.spec.template_spec.affinity
            if template_aff is not None and template_aff.node_affinity is not None and template_aff.node_affinity.required:
                if pod.spec.affinity is None:
                    pod.spec.affinity = Affinity()
                if pod.spec.affinity.node_affinity is None:
                    pod.spec.affinity.node_affinity = NodeAffinity()
                pod.spec.affinity.node_affinity.required = copy.deepcopy(
                    template_aff.node_affinity.required
                )
            out.append(pod)
        return out

    def new_scheduler(
        self,
        pods: list[Pod],
        state_nodes: Sequence[StateNode],
        reserved_offering_mode: str = "Strict",
        ready_only: bool = True,
    ) -> Scheduler:
        """provisioner.go:220-279."""
        node_pools = nodepoolutil.order_by_weight(
            nodepoolutil.list_managed(self.store, ready_only=ready_only)
        )
        if not node_pools:
            raise NoNodePoolsError("no nodepools found")
        # NodeOverlay application happens at the provider boundary (operator
        # wraps the provider with OverlayedCloudProvider when the gate is on)
        # so every consumer prices instance types identically
        instance_types = self._gather_instance_types(node_pools)
        for pod in pods:
            self.volume_topology.inject(pod)
        topology = Topology(
            self.store,
            self.cluster,
            state_nodes,
            node_pools,
            instance_types,
            pods,
            preference_policy=self.options.preferences_policy,
        )
        engine = self.engine_factory(instance_types) if self.engine_factory else None
        if engine is not None:
            self._alert_native_fallback()
        return Scheduler(
            self.store,
            node_pools,
            self.cluster,
            state_nodes,
            topology,
            instance_types,
            self.get_daemonset_pods(),
            self.recorder,
            self.clock,
            preference_policy=self.options.preferences_policy,
            min_values_policy=self.options.min_values_policy,
            reserved_offering_mode=reserved_offering_mode,
            reserved_capacity_enabled=self.options.feature_gates.reserved_capacity,
            engine=engine,
        )

    def _alert_native_fallback(self) -> None:
        """Warning event when the native FFD kernel failed to build and the
        ~100x slower pure-Python steady-state loop is serving solves
        (ops/native.py logs the line; this surfaces it in the event stream
        — an alert, not just a counter). Once per process: the failure is
        permanent for the process lifetime."""
        if getattr(self, "_native_alerted", False):
            return
        from karpenter_tpu_torch.ops import native

        reason = native.build_failure()
        if reason is None:
            # loaded, still unbuilt (first solve builds lazily), or
            # deliberately disabled — nothing to alert on yet
            if native._tried and native._lib is not None:
                self._native_alerted = True
            return
        self._native_alerted = True
        self.recorder.publish(
            Event(
                None,
                "Warning",
                "NativeKernelUnavailable",
                "native FFD kernel failed to build; scheduling runs the "
                f"pure-Python steady-state loop (~100x slower): {reason}",
                dedupe_values=("native-kernel",),
            )
        )

    def _gather_instance_types(self, node_pools) -> dict:
        """NodePool name -> instance types, the exact catalog the scheduler
        sees — shared by new_scheduler and prewarm so the warmed engine's
        cache key always matches the scheduled engine's."""
        instance_types = {}
        for np in node_pools:
            its = self.cloud_provider.get_instance_types(np)
            if its:
                instance_types[np.metadata.name] = its
        return instance_types

    def prewarm(self) -> None:
        """Build + warm the solver engine while the operator is idle: the
        catalog is known as soon as nodepools exist, so the backend-init /
        encode cold cost (the multi-second part — see CatalogEngine.warmup)
        is paid before the first batch instead of inside the first
        scheduling pass. Idempotent and cheap once warm (engines are
        content-cached; warmup is a flag check).

        Observability: the FIRST prewarm that obtains an engine runs under
        a `solverd.prewarm` root span — its ~seconds of compiles used to be
        invisible in /debug/traces — and registers the KernelRecompiled
        event publisher on the kernel observatory. The span is emitted once
        per Provisioner regardless of whether the content-cached engine was
        already warm, so deterministic-mode span logs are a pure function
        of the scenario, not of process history. The observatory SEAL
        (reconcile) closes after the first executed solve, because warmup
        deliberately does not prepay shape-keyed compiles — the first batch
        pays the residual (see CatalogEngine.warmup); everything after it
        is steady state and must not compile."""
        if self.engine_factory is None:
            return
        instance_types = self._gather_instance_types(
            nodepoolutil.list_managed(self.store, ready_only=True)
        )
        if not instance_types:
            return
        engine = self.engine_factory(instance_types)
        if engine is None:
            return
        from karpenter_tpu_torch.aot import runtime as aotrt
        from karpenter_tpu_torch.observability import kernels as kobs
        from karpenter_tpu_torch.tracing import kernel as ktime

        if not getattr(self, "_prewarm_traced", False):
            self._prewarm_traced = True
            tracer = tracing.tracer()
            with tracer.span(
                "solverd.prewarm",
                parent=None,
                catalog_instances=engine.num_instances,
            ) as span:
                with ktime.measure() as kernels:
                    aot_summary = self._warm_engine(engine)
                span.set_volatile(
                    wall_compile_s=round(kernels["compile_s"], 6),
                    wall_execute_s=round(kernels["execute_s"], 6),
                    kernel_dispatches=kernels["dispatches"],
                    kernel_compiles=kernels["compiles"],
                    **(
                        {
                            "aot_buckets": aot_summary["buckets"],
                            "aot_cache_hits": aot_summary["cache_hits"],
                            "aot_fresh_compiles": aot_summary["fresh_compiles"],
                        }
                        if aot_summary
                        else {}
                    ),
                )
        else:
            self._warm_engine(engine)
        kobs.registry().on_recompile(self._on_kernel_recompiled, key="recorder")
        aotrt.on_off_ladder(self._on_off_ladder_dispatch, key="recorder")
        from karpenter_tpu_torch.ops import delta as delta_mod

        delta_mod.on_divergence(self._on_delta_divergence, key="recorder")

    def _warm_engine(self, engine) -> Optional[dict]:
        """Warm one engine: the AOT compile service when a ladder is
        configured (walks the bucket ladder against the persistent
        executable cache — aot/compiler.warm_start), the lazy
        CatalogEngine.warmup() otherwise. Returns the AOT walk summary, or
        None on the lazy path."""
        from karpenter_tpu_torch.aot import runtime as aotrt

        if aotrt.enabled():
            from karpenter_tpu_torch import aot

            try:
                return aot.warm_start(engine)
            except KernelError:
                # port: a kernel that fails to build or to launch fails the
                # boot — the lazy warmup would hide it
                raise
            except Exception as e:  # noqa: BLE001 — AOT must never block boot
                _log.warning(
                    "AOT warm start failed; falling back to lazy warmup",
                    error=f"{type(e).__name__}: {e}",
                )
        engine.warmup()
        return None

    def _on_off_ladder_dispatch(self, kernel: str, shape: str) -> None:
        """A device dispatch missed the AOT bucket ladder: it jit-compiles
        a shape the warm start never prepaid. The event is the tuning
        signal; /debug/kernels?view=ladder is the drill-down."""
        self.recorder.publish(
            Event(
                None,
                "Warning",
                "AOTOffLadderDispatch",
                f"kernel {kernel} dispatched shape [{shape}] outside the "
                "configured AOT bucket ladder — it jit-compiled instead of "
                "warm-starting; tune the ladder "
                "(/debug/kernels?view=ladder)",
                dedupe_values=("aot-off-ladder", kernel, shape),
            )
        )

    def _on_kernel_recompiled(self, kernel: str, shape: str) -> None:
        """The zero-recompile steady-state contract tripping: a kernel
        compiled after the observatory was sealed post-prewarm."""
        self.recorder.publish(
            Event(
                None,
                "Warning",
                "KernelRecompiled",
                f"kernel {kernel} recompiled in steady state for shape "
                f"bucket [{shape}] — the zero-recompile contract is "
                "violated; check /debug/kernels for the bucket ladder",
                dedupe_values=("kernel-recompile", kernel, shape),
            )
        )

    def _on_delta_divergence(self, kernel: str, detail: str) -> None:
        """A delta-solve self-check caught the warm result disagreeing with
        the from-scratch re-solve (ops/delta.py): the residency was dropped
        and the cold result won — correctness held, but the incremental
        path has a soundness bug worth a bug report."""
        self.recorder.publish(
            Event(
                None,
                "Warning",
                "DeltaSelfCheckDivergence",
                f"incremental delta solve for {kernel} diverged from its "
                f"from-scratch re-solve ({detail}); residency dropped, "
                "full result used — see /debug/kernels?view=delta",
                dedupe_values=("delta-divergence", kernel),
            )
        )

    def schedule(self, pending_since: Optional[dict] = None) -> Optional[Results]:
        """provisioner.go:281-383."""
        nodes = self.cluster.state_nodes()
        pending = self.get_pending_pods()
        pdbs = Limits.from_pdbs(self.store.list("PodDisruptionBudget"))
        deleting_node_pods = [
            p
            for n in deleting(nodes)
            for p in n.currently_reschedulable_pods(self.store, pdbs)
        ]
        pods = pending + deleting_node_pods
        if not pods:
            return None
        # child span per pod: the pending wait, from the pod's first batcher
        # trigger (first-seen-pending) to this flush
        tracer = tracing.tracer()
        flush = self.clock.now()
        for p in pods:
            first = (pending_since or {}).get(p.metadata.uid, flush)
            tracer.event(
                "pod.pending", start=min(first, flush),
                pod=p.metadata.name, pod_uid=p.metadata.uid,
            )
        try:
            scheduler = self.new_scheduler(pods, active(nodes))
        except NoNodePoolsError:
            self.cluster.mark_pod_scheduling_decisions(
                {p: NoNodePoolsError("no nodepools found") for p in pods}, {}, {}
            )
            return None
        from karpenter_tpu_torch.solverd import KIND_SOLVE

        results = self.solver.solve(
            KIND_SOLVE, scheduler, pods, timeout=SOLVE_TIMEOUT
        )
        results.truncate_instance_types()
        # pods placed on EXISTING capacity complete their journey without a
        # nodeclaim: record the decision and link the pod so the eventual
        # bind joins this trace
        for en in results.existing_nodes:
            for p in en.pods:
                sp = tracer.event(
                    "pod.schedule", pod=p.metadata.name,
                    pod_uid=p.metadata.uid, node=en.name(), existing=True,
                )
                # link by uid: names collide across namespaces and across a
                # recreated pod's lifetimes; uids never do
                tracer.link("pod", p.metadata.uid, sp.context)
        self.cluster.mark_pod_scheduling_decisions(
            results.pod_errors,
            results.nodepool_to_pod_mapping(),
            results.existing_node_to_pod_mapping(),
        )
        results.record(self.recorder, self.cluster)
        return results

    # -- claim creation (provisioner.go:146-158, 385-438) -------------------

    def create_node_claims(
        self,
        node_claims: Sequence[SchedNodeClaim],
        reason: str = PROVISIONED_REASON,
        record_pod_nomination: bool = False,
    ) -> list[str]:
        names = []
        errs = []
        for nc in node_claims:
            try:
                names.append(self.create(nc, reason, record_pod_nomination))
            except Exception as e:  # noqa: BLE001
                errs.append(e)
        if errs:
            raise RuntimeError("; ".join(str(e) for e in errs))
        return names

    def create(
        self,
        n: SchedNodeClaim,
        reason: str = PROVISIONED_REASON,
        record_pod_nomination: bool = False,
    ) -> str:
        latest = self.store.try_get("NodePool", n.nodepool_name)
        if latest is None:
            raise ValueError(f"nodepool {n.nodepool_name} not found")
        # Limits re-check at create: state may have moved since the solve
        # (provisioner.go:396-399).
        err = nodepoolutil.limits_exceeded_by(
            latest.spec.limits, self.cluster.nodepool_resources_for(n.nodepool_name)
        )
        if err is not None:
            raise ValueError(err)
        claim = n.to_api_nodeclaim()
        claim.metadata.name = f"{n.nodepool_name}-{new_uid()[:8]}"
        self.store.create(claim)
        # journey hop: the claim exists. Link the claim (lifecycle's
        # launch/registration spans re-join here) and each pod (binding's
        # pod.bind span re-joins here) into the current trace.
        tracer = tracing.tracer()
        create_span = tracer.event(
            "nodeclaim.create",
            nodeclaim=claim.metadata.name,
            nodepool=n.nodepool_name,
            reason=reason,
            pods=len(n.pods),
        )
        tracer.link("nodeclaim", claim.metadata.name, create_span.context)
        for pod in n.pods:
            pod_span = tracer.event(
                "pod.schedule",
                pod=pod.metadata.name,
                pod_uid=pod.metadata.uid,
                nodeclaim=claim.metadata.name,
            )
            tracer.link("pod", pod.metadata.uid, pod_span.context)
        self.cluster.pod_to_node_claim.update(
            {
                (p.metadata.namespace, p.metadata.name): claim.metadata.name
                for p in n.pods
            }
        )
        _NODECLAIMS_CREATED.inc(
            {
                "reason": reason,
                "nodepool": claim.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, ""),
                "min_values_relaxed": claim.metadata.annotations.get(
                    wk.NODECLAIM_MIN_VALUES_RELAXED_ANNOTATION_KEY, "false"
                ),
            }
        )
        self.cluster.update_node_claim(claim)
        if record_pod_nomination:
            for pod in n.pods:
                self.recorder.publish(
                    Event(
                        pod,
                        "Normal",
                        "Nominated",
                        f"Pod should schedule on nodeclaim {claim.metadata.name}",
                    )
                )
        return claim.metadata.name


def _validate_requirement_terms(pod: Pod) -> Optional[str]:
    """Restricted-label validation of nodeSelector + required affinity terms
    (provisioner.go:441-480)."""
    exprs = [
        {"key": k, "operator": "In", "values": [v]}
        for k, v in pod.spec.node_selector.items()
    ]
    aff = pod.spec.affinity
    if aff is not None and aff.node_affinity is not None:
        # Only REQUIRED terms are validated — a bad preference is relaxed
        # away by the scheduler, not grounds for ignoring the pod
        # (provisioner.go:535-547).
        for term in aff.node_affinity.required:
            exprs.extend(term.match_expressions)
    for expr in exprs:
        err = wk.is_restricted_label(expr["key"])
        if err is not None:
            return err
        try:
            Operator(expr["operator"])
        except ValueError:
            return f"unknown operator {expr['operator']}"
    return None
