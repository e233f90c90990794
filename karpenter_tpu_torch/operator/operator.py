"""Operator: wires every controller into one cooperative event loop.

Mirrors the reference's pkg/operator/operator.go:106-278 +
pkg/controllers/controllers.go:62-129. Where the reference runs ~27
controller-runtime goroutine loops with leader election, the TPU build runs
one single-threaded event loop (SURVEY.md §2 "TPU-native equivalent"):
watch events dispatch to object controllers; singleton loops (provisioner,
disruption, GC, kwok fake-kubelet, metrics) tick every pass. Determinism is
a feature — the solver parallelism lives on-device, not in host threads.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.cloudprovider.types import CloudProvider
from karpenter_tpu_torch.controllers.binding import BindingController
from karpenter_tpu_torch.controllers.disruption import Controller as DisruptionController
from karpenter_tpu_torch.controllers.disruption import Queue as DisruptionQueue
from karpenter_tpu_torch.controllers.metrics_controllers import (
    NodeMetricsController,
    NodePoolMetricsController,
    PodMetricsController,
    StatusConditionMetricsController,
)
from karpenter_tpu_torch.controllers.node.health import HealthController
from karpenter_tpu_torch.controllers.node.termination import (
    EvictionQueue,
    TerminationController,
    Terminator,
)
from karpenter_tpu_torch.controllers.nodeclaim.disruption import DisruptionController as NCDisruption
from karpenter_tpu_torch.controllers.nodeclaim.gc import (
    ConsistencyController,
    ExpirationController,
    GarbageCollectionController,
    HydrationController,
    PodEventsController,
)
from karpenter_tpu_torch.controllers.nodeclaim.lifecycle import LifecycleController
from karpenter_tpu_torch.controllers.nodepool_controllers import (
    CounterController,
    HashController,
    ReadinessController,
    RegistrationHealthController,
    ValidationController,
)
from karpenter_tpu_torch.controllers.provisioning import Provisioner
from karpenter_tpu_torch.events.recorder import Recorder
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.operator.harness import ReconcilerHarness
from karpenter_tpu_torch.operator.leaderelection import LeaderElector
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.runtime.journal import Journal
from karpenter_tpu_torch.runtime.store import DELETED, Store
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.informer import StateInformer
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils.clock import Clock


class Operator:
    def __init__(
        self,
        store: Store,
        cloud_provider: CloudProvider,
        clock: Optional[Clock] = None,
        options: Optional[Options] = None,
        engine_factory=None,
        journal: Optional[Journal] = None,
    ):
        self.clock = clock or Clock()
        self.store = store
        self.options = options or Options()
        # write-ahead intent journal (runtime/journal.py): every externally
        # visible mutation records intent before the side effect. A caller
        # may inject a journal (the sim shares one dir across a crash
        # restart); by default it opens --journal-dir, or degrades to
        # in-memory when unset/unwritable.
        self.journal = (
            journal
            if journal is not None
            else Journal(self.options.journal_dir, clock=self.clock)
        )
        # recovery runs once, on the first leader pass; the sim's crash
        # restart hook observes the stats through on_recover
        self._recovered = False
        self.on_recover = None
        # the process-global tracer follows the operator's clock and tracing
        # options (same pattern as the metrics registry); the simulator
        # reconfigures it in deterministic mode before running
        from karpenter_tpu_torch import tracing

        self.tracer = tracing.configure(
            clock=self.clock,
            sample_rate=self.options.tracing_sample_rate,
            buffer_size=self.options.trace_buffer_size,
        )
        # AOT compile service config (same process-global pattern as the
        # tracer): --compile-cache-dir / --aot-ladder select the ladder and
        # persistent executable cache; provisioner.prewarm() walks it
        from karpenter_tpu_torch import aot

        aot.configure_from_options(self.options)
        # fused one-dispatch solve mode (ops/fused.py): the option wins
        # over the KARPENTER_TPU_FUSED env default when set
        if getattr(self.options, "fused_solve", ""):
            from karpenter_tpu_torch.ops import fused as fused_mod

            fused_mod.FUSED_MODE = self.options.fused_solve
        # incremental delta solves (ops/delta.py): only an EXPLICIT
        # --delta-solve mutates the process-global mode (the fused_solve
        # discipline); the self-check cadence rides along with it
        if getattr(self.options, "delta_solve", ""):
            from karpenter_tpu_torch.ops import delta as delta_mod

            delta_mod.configure(
                mode=self.options.delta_solve,
                resolve_full_every=self.options.resolve_full_every,
            )
        # SLO engine + flight recorder (observability/slo.py, flight.py):
        # the process-global burn-rate evaluator follows this operator's
        # clock and objective set; the blackbox follows its clock and
        # --flight-dir. Breaches publish a typed SLOBreach Warning event
        # and ask the recorder for a postmortem bundle. Sources and
        # subscribers use keyed-replace semantics, so rebuilding an
        # Operator (tests, sims, HA standbys) swaps slots cleanly.
        from karpenter_tpu_torch.observability import flight as flightmod
        from karpenter_tpu_torch.observability import slo as slomod

        self.slo = slomod.configure(
            clock=self.clock, specs=slomod.load_specs(self.options.slo_specs)
        )
        self.flight = flightmod.configure(
            clock=self.clock,
            capacity=self.options.flight_capacity,
            flight_dir=self.options.flight_dir,
        )
        self._flight_cell = f"cell:{self.options.cluster_name or 'operator'}"
        self.slo.subscribe(
            self._on_slo_breach, key=f"operator:{self.options.cluster_name}"
        )
        # triggered device profiling (observability/efficiency.py): the
        # process-global jax.profiler capture service follows this
        # operator's clock and --profile-dir. Disabled (no dir) it answers
        # None everywhere; the breach path below arms captures through it.
        from karpenter_tpu_torch.observability import efficiency as effmod

        self.profiler = effmod.configure_profiler(
            clock=self.clock, profile_dir=self.options.profile_dir
        )
        # decision provenance ledger (observability/explain.py): follows
        # this operator's clock and ring capacity; the capture mode is
        # process-global, so only an EXPLICIT --explain setting mutates it
        # (a default-constructed Operator must not disable a sim-enabled
        # ledger — the fused_solve discipline).
        from karpenter_tpu_torch.observability import explain as explainmod

        self.explain = explainmod.configure(
            clock=self.clock,
            mode=self.options.explain or None,
            capacity=self.options.explain_capacity,
        )
        # reference: --memory-limit feeds GOMEMLIMIT (operator.go:115-118);
        # here it bounds the solver's interning/memo caches. The caps are
        # process-global, so only an EXPLICIT setting mutates them: -1 (the
        # unset default) touches nothing — a second Operator constructed
        # with defaults (tests, HA standbys) must not clobber a configured
        # budget — while 0 explicitly restores the unbounded defaults.
        if self.options.memory_limit >= 0:
            from karpenter_tpu_torch.ops.ffd import set_memory_budget

            set_memory_budget(self.options.memory_limit)
        if self.options.feature_gates.node_overlay:
            from karpenter_tpu_torch.cloudprovider.overlay import OverlayedCloudProvider

            # launch-side application is the provider's own half of the gate
            if hasattr(cloud_provider, "honor_overlays"):
                cloud_provider.honor_overlays = True
            # one wrap at the operator boundary: every instance-type consumer
            # (provisioning, disruption, drift, counters) sees adjusted types
            cloud_provider = OverlayedCloudProvider(cloud_provider, store)
        # per-method duration/error instrumentation, decorated by default
        # (reference pkg/cloudprovider/metrics/cloudprovider.go)
        from karpenter_tpu_torch.cloudprovider.metrics import MetricsCloudProvider

        cloud_provider = MetricsCloudProvider(cloud_provider)
        # circuit breaker OUTSIDE metrics: fast-fails never reach the inner
        # provider, so they are not miscounted as provider errors/latency
        from karpenter_tpu_torch.cloudprovider.breaker import BreakerCloudProvider

        cloud_provider = BreakerCloudProvider(
            cloud_provider,
            clock=self.clock,
            threshold=self.options.cloud_breaker_threshold,
            cooldown=self.options.cloud_breaker_cooldown,
        )
        self.breaker = cloud_provider.breaker
        self.cloud_provider = cloud_provider
        self.recorder = Recorder(clock=self.clock)
        self.cluster = Cluster(
            self.clock, store, cloud_provider,
            nomination_window=2 * self.options.batch_max_duration,
        )
        self.informer = StateInformer(store, self.cluster)

        self.provisioner = Provisioner(
            store, cloud_provider, self.cluster, self.recorder, self.clock,
            self.options, engine_factory=engine_factory,
        )
        self.disruption_queue = DisruptionQueue(
            store, self.recorder, self.cluster, self.clock, self.provisioner,
            journal=self.journal,
        )
        self.disruption = DisruptionController(
            self.clock, store, self.provisioner, cloud_provider, self.recorder,
            self.cluster, self.disruption_queue,
        )
        self.lifecycle = LifecycleController(
            store, cloud_provider, self.recorder, self.clock,
            journal=self.journal,
        )
        self.nc_disruption = NCDisruption(store, cloud_provider, self.clock)
        self.expiration = ExpirationController(store, self.clock, self.recorder)
        self.gc = GarbageCollectionController(
            store, cloud_provider, self.clock, recorder=self.recorder
        )
        self.consistency = ConsistencyController(store, self.recorder, self.clock)
        self.podevents = PodEventsController(store, self.clock)
        self.hydration = HydrationController(store)
        self.eviction_queue = EvictionQueue(store, self.recorder, self.clock)
        self.terminator = Terminator(self.clock, store, self.eviction_queue, self.recorder)
        self.termination = TerminationController(
            store, cloud_provider, self.terminator, self.recorder, self.clock
        )
        self.health = HealthController(
            store, cloud_provider, self.recorder, self.clock,
            enabled=self.options.feature_gates.node_repair,
        )
        self.np_hash = HashController(store)
        self.np_counter = CounterController(store, self.cluster)
        self.np_readiness = ReadinessController(store, self.clock)
        self.np_registration_health = RegistrationHealthController(store, self.clock)
        self.np_validation = ValidationController(store, self.clock)
        self.binding = BindingController(
            store, self.cluster, self.clock, self.recorder,
            tenant=self.options.cluster_name, journal=self.journal,
        )
        self.overlay_validation = None
        if self.options.feature_gates.node_overlay:
            from karpenter_tpu_torch.controllers.nodeoverlay import (
                NodeOverlayValidationController,
            )

            self.overlay_validation = NodeOverlayValidationController(
                store, self.clock
            )
        self.pod_metrics = PodMetricsController(store, self.cluster, self.clock)
        self.node_metrics = NodeMetricsController(
            self.cluster, store=store, clock=self.clock
        )
        self.nodepool_metrics = NodePoolMetricsController(store, self.cluster)
        self.condition_metrics = StatusConditionMetricsController(store)

        self._dispatch_watch = store.watch(
            ["Pod", "Node", "NodeClaim", "NodePool"]
        )
        # identity prefix = --karpenter-service, the name identifying this
        # deployment (the reference uses it the same way for its lock id)
        self.elector = LeaderElector(
            store,
            self.clock,
            identity_prefix=self.options.service_name or "karpenter",
            enabled=not self.options.disable_leader_election,
        )

        # -- reconciler harness (operator/harness.py): every controller call
        # in run_once/_dispatch/_resync goes through a named Reconciler so
        # one failure is isolated, counted, and backed off per-item instead
        # of aborting the pass (the reference gets this from
        # controller-runtime's workqueue; SURVEY.md §2).
        self.harness = ReconcilerHarness(
            self.clock,
            base_delay=self.options.requeue_base_delay,
            max_delay=self.options.requeue_max_delay,
        )
        # refreshed once per pass; probes read the cache (see _solver_health)
        self._solver_health_cache: Optional[dict] = None
        reg = self.harness.register
        self.r_lifecycle = reg("nodeclaim.lifecycle", self.lifecycle.reconcile)
        self.r_nc_disruption = reg("nodeclaim.disruption", self.nc_disruption.reconcile)
        self.r_expiration = reg("nodeclaim.expiration", self.expiration.reconcile)
        self.r_consistency = reg("nodeclaim.consistency", self.consistency.reconcile)
        self.r_hydration_claim = reg("nodeclaim.hydration", self.hydration.reconcile_claim)
        self.r_podevents = reg("nodeclaim.podevents", self.podevents.on_pod_event)
        self.r_gc = reg("nodeclaim.garbagecollection", self.gc.reconcile)
        self.r_termination = reg("node.termination", self.termination.reconcile)
        self.r_eviction_queue = reg("node.termination.eviction", self.eviction_queue.reconcile)
        self.r_node_health = reg("node.health", self.health.reconcile)
        self.r_hydration_node = reg("node.hydration", self.hydration.reconcile_node)
        self.r_np_hash = reg("nodepool.hash", self.np_hash.reconcile)
        self.r_np_validation = reg("nodepool.validation", self.np_validation.reconcile)
        self.r_np_readiness = reg("nodepool.readiness", self.np_readiness.reconcile)
        self.r_np_registration_health = reg(
            "nodepool.registrationhealth", self.np_registration_health.reconcile
        )
        self.r_np_counter = reg("nodepool.counter", self.np_counter.reconcile)
        self.r_binding = reg("binding", self.binding.reconcile)
        self.r_provisioner = reg("provisioning", self._provision)
        self.r_disruption = reg("disruption", self.disruption.reconcile)
        self.r_disruption_queue = reg("disruption.queue", self.disruption_queue.reconcile)
        self.r_kwok_tick = reg(
            "kwok.fakekubelet", lambda: self.cloud_provider.tick()
        )
        self.r_overlay_validation = None
        if self.overlay_validation is not None:
            self.r_overlay_validation = reg(
                "nodeoverlay.validation", self.overlay_validation.reconcile_all
            )
        self.r_pod_metrics = reg("metrics.pod", self.pod_metrics.reconcile)
        # distinct name: a successful on_delete must not reset the
        # reconcile path's consecutive-failure health accounting
        self.r_pod_metrics_delete = reg("metrics.pod.delete", self.pod_metrics.on_delete)
        self.r_node_metrics = reg("metrics.node", self.node_metrics.reconcile)
        self.r_nodepool_metrics = reg("metrics.nodepool", self.nodepool_metrics.reconcile)
        self.r_condition_metrics = reg("metrics.status", self.condition_metrics.reconcile)

        # flight-recorder sources: this cell's health/queue/breaker/SLO
        # view, the process-wide kernel-registry deltas, and the active
        # span summaries — every pass snapshots them all into one frame
        from karpenter_tpu_torch.observability import kernels as kobs

        self.flight.register_source(self._flight_cell, self._flight_source)
        # journal depth/appends per pass: a growing depth means intents are
        # opening without closing — the frame that explains a stuck mutation
        self._flight_journal = f"journal:{self.options.cluster_name or 'operator'}"
        self.flight.register_source(self._flight_journal, self.journal.frame)
        self.flight.register_source("kernels", _kernel_delta_source())
        self.flight.register_source(
            "spans",
            lambda: {"recent_traces": _span_summaries()},
        )
        # the steady-recompile SLO feed: every post-seal compile is one bad
        # event on the zero-tolerance objective (keyed alongside the
        # provisioner's KernelRecompiled event callback). The closure
        # captures the ENGINE, not this operator — the registry slot must
        # not pin a retired Operator's object graph alive.
        slo_engine = self.slo
        kobs.registry().on_recompile(
            lambda kernel, shape: slo_engine.record("steady-recompiles", bad=1),
            key="slo",
        )

    # -- the loop -----------------------------------------------------------

    def run_once(self) -> dict:
        """One cooperative pass: ingest watches, dispatch object events,
        tick singletons. Controllers re-emit store writes which the next
        pass ingests — level-triggered, idempotent, resumable (SURVEY.md §5
        'Checkpoint / resume'). Only the leader writes: a standby replica
        keeps its informer warm and otherwise no-ops until the incumbent's
        lease goes stale (reference operator.go:144-151).

        Returns a small activity summary (pods bound, nodes fabricated,
        nodeclaims provisioned this pass) — the simulator's event log and
        operators' debugging hooks consume it; other callers ignore it."""
        summary = {"bound": 0, "fabricated": 0, "provisioned": 0}
        self.journal.set_pass(self.harness.passes + 1)
        if not self.elector.try_acquire_or_renew():
            self._was_leader = False
            self.informer.flush()
            # keep local metric series hygiene; dropped events are replayed
            # by the full resync on the first leader pass
            for event in self._dispatch_watch.drain():
                if event.kind == "Pod" and event.type == DELETED:
                    self.r_pod_metrics_delete(
                        event.obj.metadata.namespace,
                        event.obj.metadata.name,
                        item=_obj_item(event.obj),
                    )
            # a warm standby is a healthy replica: its pass did everything
            # a standby pass is supposed to do
            self.harness.note_pass()
            self._refresh_solver_health()
            self._observe_pass()
            return summary
        if not getattr(self, "_was_leader", False):
            # just took over (or first pass): events dropped while standing
            # by are gone, and several controllers are event-driven only —
            # reconcile everything once, like the reference's informer
            # resync on leader start
            self._was_leader = True
            if not self._recovered:
                self._recovered = True
                # the watch subscription only carries events since THIS
                # process constructed it: booted onto a populated store
                # (crash restart), the cluster state must replay what
                # already exists or the scheduler plans against nothing
                self.informer.bootstrap()
                # journal replay next: adoptions/rollbacks must land before
                # any controller acts on the half-finished state they resolve
                self.recover()
            self._resync()
        self.informer.flush()
        self._dispatch()
        # kwok fake kubelet fabricates due nodes before controllers run
        if hasattr(self.cloud_provider, "tick"):
            summary["fabricated"] = self.r_kwok_tick() or 0
        self.informer.flush()
        # Periodic sweeps stand in for the reference's RequeueAfter timers:
        # registration waits on node appearance, liveness/expiration on the
        # clock, termination on drain progress — all time-, not event-driven.
        for claim in self.store.list("NodeClaim"):
            item = _obj_item(claim)
            self.r_lifecycle(claim, item=item)
            if self.store.try_get("NodeClaim", claim.metadata.name) is None:
                continue
            self.r_nc_disruption(claim, item=item)
            self.r_expiration(claim, item=item)
        for node in self.store.list(
            "Node", predicate=lambda n: n.metadata.deletion_timestamp is not None
        ):
            self.r_termination(node, item=_obj_item(node))
        self.informer.flush()
        # Fake kube-scheduler: bind placeable pods before provisioning so the
        # solver only sees genuinely unsatisfiable demand.
        summary["bound"] = self.r_binding() or 0
        self.informer.flush()
        if self.r_overlay_validation is not None:
            self.r_overlay_validation()
        results = self.r_provisioner()
        if results is not None:
            summary["provisioned"] = len(results.new_node_claims)
        self.r_disruption()
        self.r_disruption_queue()
        self.r_eviction_queue()
        self.r_gc()
        self.informer.flush()
        self.r_pod_metrics()
        self.r_node_metrics()
        self.r_nodepool_metrics()
        self.r_condition_metrics()
        self.harness.note_pass()
        self._refresh_solver_health()
        self._observe_pass()
        return summary

    # -- crash recovery ------------------------------------------------------

    def recover(self) -> dict:
        """Replay the journal against observed cluster/cloud state.

        For every pending intent (written, never closed — the previous
        incarnation died mid-mutation):

        - ``nodeclaim.launch``: probe the cloud by idempotency key. An
          acknowledged instance with a surviving claim is ADOPTED (details +
          Launched stamped from the instance, no second create); an
          instance with no claim is ORPHANED for gc.py's sweep to reap
          (expedited); no instance means the effect never happened and
          lifecycle simply relaunches under the same key.
        - ``nodeclaim.delete``: instance still present => the delete never
          landed, finalize retries; gone => the intent's outcome holds.
        - ``pod.bind``: the store is the effect — bound pod => done,
          otherwise the binding sweep re-places it.
        - ``disruption.command``: the in-memory command died with the
          process; roll the marks back (untaint, clear the Disrupted
          condition, unmark deletion) so budget headroom never leaks. The
          already-created replacements are ordinary claims consolidation
          folds later.

        Same journal => same decisions: the pending list is ordered by
        sequence number and every probe reads deterministic state."""
        from karpenter_tpu_torch.apis.nodeclaim import CONDITION_LAUNCHED
        from karpenter_tpu_torch.controllers.nodeclaim.lifecycle import (
            _populate_node_claim_details,
        )
        from karpenter_tpu_torch.runtime.journal import IDEMPOTENCY_ANNOTATION

        stats = {"replayed": 0, "adoptions": 0, "orphans": 0, "rolled_back": 0}
        # a crash restart resolves half-finished mutations out-of-band of
        # the solve stream: any solver residency carried across the restart
        # (engine factories outlive Operator rebuilds) describes the
        # pre-crash world and must not seed a warm resume
        from karpenter_tpu_torch.ops import delta as delta_mod

        delta_mod.invalidate_all("restart-recovery")
        pending = self.journal.pending()
        if not pending:
            self.journal.mark_recovered()
            return stats
        self.informer.flush()
        try:
            instances = self.cloud_provider.list()
        except Exception:  # noqa: BLE001 — recovery degrades, never crashes boot
            instances = []
        pids = set()
        by_key = {}
        for inst in instances:
            pids.add(inst.status.provider_id)
            key = inst.metadata.annotations.get(IDEMPOTENCY_ANNOTATION, "")
            if key:
                by_key[key] = inst
        for rec in pending:
            stats["replayed"] += 1
            self.journal.note_replay()
            action = rec.get("action", "")
            seq = rec.get("seq", 0)
            if action == "nodeclaim.launch":
                inst = by_key.get(rec.get("key", ""))
                if inst is None:
                    # never acknowledged: lifecycle relaunches this claim
                    # under the same key next pass
                    self.journal.failed(seq, error="unacknowledged at recovery")
                    continue
                claim = self.store.try_get("NodeClaim", rec.get("nodeclaim", ""))
                if claim is None or (
                    rec.get("uid") and claim.metadata.uid != rec.get("uid")
                ):
                    # acknowledged instance, no surviving claim: orphan —
                    # gc's two-way sweep reaps it on the next (expedited) run
                    self.journal.note_orphan()
                    stats["orphans"] += 1
                    self.gc.expedite()
                    self.journal.failed(seq, error="orphaned at recovery")
                    continue
                if not claim.condition_is_true(CONDITION_LAUNCHED):
                    _populate_node_claim_details(claim, inst)
                    claim.set_condition(
                        CONDITION_LAUNCHED, "True", now=self.clock.now()
                    )
                    self.store.apply(claim)
                    self.journal.note_adoption()
                    stats["adoptions"] += 1
                self.journal.done(seq, barrier=False, recovered=True)
            elif action == "nodeclaim.delete":
                if rec.get("provider_id", "") in pids:
                    self.journal.failed(seq, error="unacknowledged at recovery")
                else:
                    self.journal.done(seq, barrier=False, recovered=True)
            elif action == "pod.bind":
                uid = rec.get("uid", "")
                bound = self.store.list(
                    "Pod",
                    predicate=lambda p: p.metadata.uid == uid and p.spec.node_name != "",
                )
                if bound:
                    self.journal.done(seq, barrier=False, recovered=True)
                else:
                    self.journal.failed(seq, error="unacknowledged at recovery")
            elif action == "disruption.command":
                self._rollback_disruption(rec)
                self.journal.note_rollback()
                stats["rolled_back"] += 1
                self.journal.failed(seq, error="rolled back at recovery")
            else:
                self.journal.failed(seq, error=f"unknown action {action!r}")
        self.journal.mark_recovered()
        self.journal.compact()
        # the crash bundle: what recovery found and decided, dumped while
        # the flight ring still shows the boot-time state
        try:
            self.flight.dump("recovery", context={"recovery": dict(stats)})
        except Exception:  # noqa: BLE001 — observability never breaks recovery
            pass
        if self.on_recover is not None:
            self.on_recover(dict(stats))
        return stats

    def _rollback_disruption(self, rec: dict) -> None:
        """Undo a crashed disruption command's marks: the queue's own
        timeout rollback (disruption/queue.py), replayed from the journal
        because the in-memory command died with the process."""
        from karpenter_tpu_torch.apis.nodeclaim import CONDITION_DISRUPTION_REASON
        from karpenter_tpu_torch.state.statenode import require_no_schedule_taint

        candidates = set(rec.get("candidates", []) or [])
        targets = [
            sn
            for sn in self.cluster.nodes.values()
            if sn.node_claim is not None
            and sn.node_claim.metadata.name in candidates
        ]
        require_no_schedule_taint(self.store, False, *targets)
        for name in sorted(candidates):
            claim = self.store.try_get("NodeClaim", name)
            if (
                claim is not None
                and claim.get_condition(CONDITION_DISRUPTION_REASON) is not None
            ):
                claim.clear_condition(CONDITION_DISRUPTION_REASON)
                self.store.update(claim)
        self.cluster.unmark_for_deletion(*(rec.get("provider_ids", []) or []))

    def _observe_pass(self) -> None:
        """Per-pass observability epilogue: evaluate every SLO objective's
        burn rates at the pass boundary (edge-triggered breaches fire their
        subscribers here) and capture one flight-recorder frame — the
        always-on blackbox. Both are clock-driven and deterministic under
        FakeClock; neither may fail the pass."""
        try:
            self.slo.evaluate()
            self.flight.record(f"pass:{self.options.cluster_name or 'operator'}")
        except Exception:  # noqa: BLE001 — observability never breaks the loop
            pass

    def _provision(self):
        """One provisioning reconcile: re-trigger every provisionable pod
        (the reference requeues them every 10s — provisioning/controller.go
        RequeueAfter — so pods left pending after a batch re-enter the next
        window instead of being stranded once their watch event is
        consumed), then batch-solve."""
        # pay the solver's encode/compile cold cost at idle, not inside the
        # first batch (no-op once the engine for the current catalog is warm)
        self.provisioner.prewarm()
        for pending in self.store.list("Pod", predicate=podutil.is_provisionable):
            self.provisioner.trigger(pending.metadata.uid)
        return self.provisioner.reconcile()

    def run(self, passes: int = 1) -> None:
        for _ in range(passes):
            self.run_once()

    def _resync(self) -> None:
        """Reconcile every object whose controllers are event-driven only —
        run on leadership acquisition, when watch events may have been
        dropped while standing by."""
        self.informer.flush()
        for pool in self.store.list("NodePool"):
            item = _obj_item(pool)
            self.r_np_hash(pool, item=item)
            self.r_np_validation(pool, item=item)
            self.r_np_readiness(pool, item=item)
            self.r_np_registration_health(pool, item=item)
            self.r_np_counter(pool, item=item)
        for node in self.store.list("Node"):
            if node.metadata.deletion_timestamp is None:
                item = _obj_item(node)
                self.r_node_health(node, item=item)
                self.r_hydration_node(node, item=item)
        for claim in self.store.list("NodeClaim"):
            item = _obj_item(claim)
            self.r_consistency(claim, item=item)
            self.r_hydration_claim(claim, item=item)
        # podevents deliberately NOT resynced: stamping lastPodEventTime
        # for every existing pod would reset consolidateAfter windows; a
        # missed event only delays consolidation, which is the safe side.

    def _dispatch(self) -> None:
        for event in self._dispatch_watch.drain():
            obj = event.obj
            item = _obj_item(obj)
            if event.kind == "Pod":
                if event.type != DELETED and podutil.is_provisionable(obj):
                    self.provisioner.trigger(obj.metadata.uid)
                self.r_podevents(obj, item=item)
                if event.type == DELETED:
                    self.r_pod_metrics_delete(
                        obj.metadata.namespace, obj.metadata.name, item=item
                    )
            elif event.kind == "NodeClaim":
                if event.type == DELETED:
                    continue
                live = self.store.try_get("NodeClaim", obj.metadata.name)
                if live is None:
                    continue
                self.r_lifecycle(live, item=item)
                if self.store.try_get("NodeClaim", obj.metadata.name) is None:
                    continue
                self.r_nc_disruption(live, item=item)
                self.r_expiration(live, item=item)
                self.r_consistency(live, item=item)
                self.r_hydration_claim(live, item=item)
            elif event.kind == "Node":
                if event.type == DELETED:
                    continue
                live = self.store.try_get("Node", obj.metadata.name)
                if live is None:
                    continue
                self.r_termination(live, item=item)
                if self.store.try_get("Node", obj.metadata.name) is None:
                    continue
                self.r_node_health(live, item=item)
                self.r_hydration_node(live, item=item)
            elif event.kind == "NodePool":
                if event.type == DELETED:
                    continue
                live = self.store.try_get("NodePool", obj.metadata.name)
                if live is None:
                    continue
                self.r_np_hash(live, item=item)
                self.r_np_validation(live, item=item)
                self.r_np_readiness(live, item=item)
                self.r_np_registration_health(live, item=item)
                self.r_np_counter(live, item=item)

    def shutdown(self) -> None:
        """Clean shutdown: release the leader lease so a standby replica
        takes over immediately instead of waiting out the lease duration,
        close the solver client (fails queued solves with typed rejections
        instead of stranding their waiters), and release this operator's
        slots in the process-global SLO engine and flight recorder — keyed
        replace only covers a successor with the SAME name, so a
        differently-named operator later in the process must not keep
        snapshotting this retired cell into its frames (the "kernels" and
        "spans" sources are operator-independent closures and stay)."""
        self.elector.release()
        self.provisioner.solver.close()
        self.flight.unregister_source(self._flight_cell)
        self.flight.unregister_source(self._flight_journal)
        self.slo.unsubscribe(f"operator:{self.options.cluster_name}")
        self.journal.close()

    # -- observability ------------------------------------------------------

    def metrics_text(self) -> str:
        return global_registry.expose()

    def solver_stats(self) -> dict:
        """solverd introspection for /debug/solverd (operator/serving.py)."""
        return self.provisioner.solver.stats()

    def kernel_snapshot(
        self, kernel: Optional[str] = None, view: Optional[str] = None
    ) -> Optional[dict]:
        """/debug/kernels (operator/serving.py): the kernel observatory's
        per-kernel table (compile/execute split, shapes seen, phase counts,
        recompiles, last device-memory sample), a single kernel's
        per-shape-bucket drill-down, or — with ?view=ladder — the AOT
        bucket ladder next to the observed shape buckets with off-ladder
        dispatches flagged. None => unknown kernel (404)."""
        from karpenter_tpu_torch.observability import kernels as kobs

        return kobs.registry().debug_snapshot(kernel, view=view)

    def trace_snapshot(
        self,
        trace_id: Optional[str] = None,
        view: Optional[str] = None,
        limit: int = 20,
    ) -> Optional[dict]:
        """/debug/traces (operator/serving.py): recent traces, a trace_id
        drill-down (the spans plus any completed pod journeys they carry),
        or the slowest-journeys view. None => unknown trace_id (404)."""
        if trace_id:
            spans = self.tracer.ring.trace(trace_id)
            if not spans:
                return None
            return {
                "trace_id": trace_id,
                "spans": spans,
                "journeys": self.tracer.journeys.for_trace(trace_id),
            }
        if view == "slowest":
            return {"slowest_journeys": self.tracer.journeys.slowest(limit)}
        return {
            "traces": self.tracer.ring.summaries(limit),
            "journeys": self.tracer.journeys.stats(),
        }

    def _on_slo_breach(self, breach) -> None:
        """SLO breach subscriber: publish the typed Warning event and dump
        a flight bundle (the recorder's per-trigger cooldown keeps a
        burning objective from shedding one bundle per pass). Breaches for
        other tenants' series are theirs to handle — aggregate ("") and
        own-tenant breaches are this operator's."""
        if breach.tenant and breach.tenant != self.options.cluster_name:
            return
        from karpenter_tpu_torch.events.recorder import Event

        self.recorder.publish(
            Event(
                None,
                "Warning",
                "SLOBreach",
                f"objective {breach.objective} burning at "
                f"{breach.burn_rate:.1f}x in its {breach.window} window "
                f"(budget remaining {breach.budget_remaining:.3f}"
                + (f", tenant {breach.tenant}" if breach.tenant else "")
                + ")",
                dedupe_values=(
                    "slo-breach", breach.objective, breach.tenant, breach.window,
                ),
            )
        )
        # arm a device profile capture for the breach (no-op unless
        # --profile-dir is set; per-trigger cooldown; the capture itself
        # finishes on a timer thread) and record its path in the flight
        # bundle's context — the postmortem names its own evidence
        context = breach.to_dict()
        capture = self.profiler.arm(f"slo:{breach.objective}")
        if capture is not None:
            context["device_profile"] = capture
        self.flight.dump(f"slo:{breach.objective}", context=context)

    def _flight_source(self) -> dict:
        """This cell's per-pass flight frame: harness health ledger,
        breaker state, solverd reachability (cached — a frame must never
        RPC a daemon), in-process admission-queue/tenant-quota state, the
        fleet replica view when the pool client is wired, and the SLO burn
        summary."""
        out = {
            "harness": self.harness.snapshot(),
            "breaker": self.breaker.snapshot(),
            "solverd": self._solver_health(),
            "slo": {
                "burning": self.slo.burning(),
                "worst": self.slo.worst_burning(),
                "hard_breached": self.slo.hard_breached(),
            },
        }
        solver = self.provisioner.solver
        service = getattr(solver, "service", None)
        if service is not None and hasattr(service, "queue"):
            out["admission_queue"] = {
                "depth": service.queue.depth(),
                "cap": service.queue.max_depth,
                "tenant_quota": service.queue.tenant_quota,
                "tenant_depths": service.queue.tenant_depths(),
                "draining": service.draining,
            }
        if getattr(solver, "_replicas", None) is not None:
            # fleet client: the client-side pool view is RPC-free by design
            stats = solver.stats()
            out["fleet"] = {
                "replicas": stats.get("replicas", []),
                "healthy_replicas": stats.get("healthy_replicas"),
                "failovers": stats.get("failovers"),
                "replays": stats.get("replays"),
            }
        return out

    def slo_snapshot(
        self, objective: Optional[str] = None, tenant: Optional[str] = None
    ) -> Optional[dict]:
        """/debug/slo (operator/serving.py): the objective table with
        per-window burn rates and budget remaining, or one objective's
        per-tenant drill-down. None => unknown objective (404)."""
        return self.slo.snapshot(objective=objective, tenant=tenant)

    def flight_snapshot(self, bundle: Optional[str] = None) -> Optional[dict]:
        """/debug/flight (operator/serving.py): ring summary + bundle
        listing, or one bundle's frames. None => unknown bundle (404)."""
        return self.flight.snapshot(bundle=bundle)

    def journal_snapshot(self) -> Optional[dict]:
        """/debug/journal (operator/serving.py): journal mode/depth/append
        counters plus every pending intent — the mutations that have opened
        but not closed, i.e. what recovery would replay if the operator
        died right now."""
        return self.journal.snapshot()

    def explain_snapshot(
        self, pod: Optional[str] = None, what_if: Optional[str] = None
    ) -> Optional[dict]:
        """/debug/explain (operator/serving.py): the unschedulable-pod
        triage table, a ``?pod=`` stage-by-stage drill-down, or a
        ``?what_if=drop:<key>`` counterfactual probe — a single-pod
        simulate-kind re-solve through the solverd coalescer against the
        relaxed constraints, deadline-bounded and never on the serving hot
        path. None => ledger disabled or unknown pod (404); the serving
        layer validates the what_if syntax (400 on garbage)."""
        if not self.explain.enabled:
            return None
        snap = self.explain.snapshot(pod=pod)
        if snap is None or what_if is None:
            return snap
        snap["what_if"] = self._explain_probe(snap, what_if)
        return snap

    def _explain_probe(self, entry: dict, what_if: str) -> dict:
        """Run one counterfactual: deep-copy the pod, drop the named
        requirement, re-solve it alone (KIND_SIMULATE — the probe never
        commits ledger entries or scheduling decisions)."""
        import copy as _copy

        from karpenter_tpu_torch.observability import explain as explainmod
        from karpenter_tpu_torch.solverd import KIND_SIMULATE
        from karpenter_tpu_torch.state.statenode import active

        key = what_if.split(":", 1)[1]
        target = next(
            (
                p
                for p in self.store.list("Pod")
                if p.metadata.uid == entry["uid"]
                or p.metadata.name == entry["pod"]
            ),
            None,
        )
        if target is None:
            self.explain.note_probe("pod-gone")
            return {"drop": key, "error": "pod no longer present in the store"}
        probe = _copy.deepcopy(target)
        if not explainmod.drop_requirement(probe, key):
            self.explain.note_probe("no-op")
            return {
                "drop": key,
                "error": f"pod carries no requirement on {key!r}",
            }
        try:
            scheduler = self.provisioner.new_scheduler(
                [probe], active(self.cluster.state_nodes())
            )
            results = self.provisioner.solver.solve(
                KIND_SIMULATE, scheduler, [probe], timeout=2.0
            )
        except Exception as e:  # noqa: BLE001 — a probe failure is an answer
            self.explain.note_probe("error")
            return {"drop": key, "error": f"{type(e).__name__}: {e}"}
        err = next(iter(results.pod_errors.values()), None)
        if err is None:
            placed = [nc.nodepool_name for nc in results.new_node_claims] + [
                en.name() for en in results.existing_nodes if en.pods
            ]
            self.explain.note_probe("schedulable")
            return {"drop": key, "schedulable": True, "placement": placed}
        self.explain.note_probe("unschedulable")
        return {
            "drop": key,
            "schedulable": False,
            "error": str(err),
            "stages": list(explainmod.classify(err)),
        }

    def device_profile_snapshot(self, seconds: float) -> Optional[dict]:
        """/debug/profile/device (operator/serving.py): a synchronous
        jax.profiler capture of the next `seconds` of device activity into
        --profile-dir. None => profiling disabled (404); the serving layer
        validates `seconds` (400 on garbage) before calling."""
        if not self.profiler.enabled:
            return None
        return self.profiler.capture(seconds, trigger="debug")

    def healthy(self) -> bool:
        """Real liveness: degraded when any controller is failing
        consecutively, the cloud-provider circuit breaker is open, solverd
        is unreachable, or a leader stopped completing passes."""
        return not self._degraded_reasons(self._solver_health())

    def ready(self) -> bool:
        """Readiness: at least one pass (leader or warm standby) completed."""
        return self.harness.passes > 0

    def _solver_health(self) -> dict:
        """Solverd reachability, CACHED per reconcile pass: /healthz is a
        probe path, and the socket transport's stats() RPC serializes
        behind the same lock as an in-flight solve — a probe must never
        block on (or hammer) the daemon. run_once refreshes the cache; a
        probe before the first pass computes it once lazily."""
        if self._solver_health_cache is None:
            self._refresh_solver_health()
        return self._solver_health_cache

    def _refresh_solver_health(self) -> None:
        try:
            stats = self.provisioner.solver.stats()
        except Exception as e:  # noqa: BLE001 — health must not raise
            self._solver_health_cache = {
                "reachable": False,
                "error": f"{type(e).__name__}: {e}",
            }
            return
        out = {
            "transport": stats.get("transport", "unknown"),
            "reachable": "error" not in stats,
        }
        if "error" in stats:
            out["error"] = stats["error"]
        if "reconnects" in stats:
            out["reconnects"] = stats["reconnects"]
        # fleet transport (solverd/fleet.py): the pool view — per-replica
        # breaker states, failover counters — rides into /healthz and
        # /debug/health; "reachable" already degrades when every replica's
        # breaker is open (the fleet stats carry an error then)
        for key in ("healthy_replicas", "replicas", "failovers", "replays"):
            if key in stats:
                out[key] = stats[key]
        self._solver_health_cache = out

    def _degraded_reasons(self, solver_health: dict) -> list[str]:
        reasons = []
        for name in self.harness.degraded_controllers():
            reasons.append(f"controller {name} failing consecutively")
        if self.breaker.state != self.breaker.CLOSED:
            reasons.append(
                f"cloud provider circuit breaker {self.breaker.state}"
            )
        if not solver_health["reachable"]:
            reasons.append("solverd unreachable")
        if self.harness.stale():
            reasons.append("no successful reconcile pass recently")
        if self.journal.recovering():
            reasons.append("journal recovery in progress")
        for objective in self.slo.hard_breached():
            reasons.append(
                f"SLO availability objective {objective} in hard breach"
            )
        return reasons

    def heap_stats(self) -> dict:
        """Sizes of the process's interning/memo caches — the operator's
        only unbounded-by-default memory consumers (see
        ffd.set_memory_budget). Served inside /debug/heap so a memory
        investigation sees tracemalloc's allocation sites and the cache
        populations in one response."""
        from karpenter_tpu_torch.controllers.provisioning import provisioner as provmod
        from karpenter_tpu_torch.ops import ffd, ffd_topo
        from karpenter_tpu_torch.scheduler import topology as topomod

        out = {
            "ffd_shape_sigs": len(ffd._SIG_IDS),
            "ffd_topo_shape_sigs": len(ffd_topo._TSIG_IDS),
            "topology_domain_groups_memo": len(topomod._domain_groups_cache),
            "engine_content_cache": len(provmod._ENGINE_CONTENT_CACHE),
        }
        joint = fam = 0
        for engine in provmod._ENGINE_CONTENT_CACHE.values():
            joint += len(getattr(engine, "solver_joint_cache", ()))
            fam += len(getattr(engine, "solver_fam_trans", ()))
        out["engine_joint_mask_cache"] = joint
        out["engine_fam_transition_cache"] = fam
        return out

    def health_snapshot(self) -> dict:
        """Structured health for /healthz and /debug/health: pass liveness,
        per-controller consecutive-failure counts, breaker state, and
        solverd reachability, plus the reasons for any degradation. One
        solver-health read feeds both the verdict and the body, so they
        can never disagree."""
        solver_health = self._solver_health()
        reasons = self._degraded_reasons(solver_health)
        snap = self.harness.snapshot()
        return {
            "healthy": not reasons,
            "status": "ok" if not reasons else "degraded",
            "degraded_reasons": reasons,
            "leader": getattr(self, "_was_leader", False),
            "cloud_provider_breaker": self.breaker.snapshot(),
            "solverd": solver_health,
            # the SLO fold: worst-burning objective + its error budget, and
            # any availability objective in hard breach (those also appear
            # in degraded_reasons, turning the probe 503)
            "slo": {
                "worst_burning": self.slo.worst_burning(),
                "hard_breached": self.slo.hard_breached(),
            },
            **snap,
        }


def _kernel_delta_source():
    """Flight source: per-kernel dispatch-count deltas by phase since the
    PREVIOUS frame — the kernel-registry movement each pass, not process
    history (so same-seed sim runs record identical frames even when the
    registry carries counts from earlier runs in the process)."""
    from karpenter_tpu_torch.observability import kernels as kobs

    state = {"base": kobs.registry().counts_snapshot()}

    def source() -> dict:
        now = kobs.registry().counts_snapshot()
        base = state["base"]
        state["base"] = now
        deltas: dict = {}
        recompiles = 0
        for name in sorted(now):
            shapes = now[name]["shapes"]
            base_shapes = base.get(name, {}).get("shapes", {})
            totals: dict[str, int] = {}
            for shape, phases in shapes.items():
                b = base_shapes.get(shape, {})
                for phase, count in phases.items():
                    d = count - b.get(phase, 0)
                    if d:
                        totals[phase] = totals.get(phase, 0) + d
            if totals:
                deltas[name] = totals
            recompiles += now[name]["recompiles"] - base.get(name, {}).get(
                "recompiles", 0
            )
        return {"dispatch_deltas": deltas, "recompiles": recompiles}

    return source


def _span_summaries(limit: int = 5) -> list[dict]:
    """Flight source: the most recent trace summaries from the CURRENT
    process-global tracer (resolved per frame — a sim reconfigures the
    tracer after the operator is built)."""
    from karpenter_tpu_torch import tracing

    return tracing.tracer().ring.summaries(limit)


def _obj_item(obj) -> str:
    """Backoff item key for an object: kind/name (namespaces are single
    in this build; pods include it for uniqueness)."""
    meta = obj.metadata
    ns = getattr(meta, "namespace", "") or ""
    return f"{obj.KIND}/{ns}/{meta.name}" if ns else f"{obj.KIND}/{meta.name}"
