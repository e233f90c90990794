"""Disruption orchestration queue: taint → launch replacements → wait
Initialized → delete candidates, with timeout rollback.

Mirrors the reference's disruption/queue.go:84-392 — the channel-driven
reconciler becomes a pending-command list the cooperative loop drains.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclaim import (
    CONDITION_DISRUPTION_REASON,
    CONDITION_INITIALIZED,
)
from karpenter_tpu_torch.controllers.disruption.types import Command
from karpenter_tpu_torch.events.recorder import Event, Recorder
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.runtime.store import NotFound, Store
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.statenode import (
    clear_node_claims_condition,
    require_no_schedule_taint,
)
from karpenter_tpu_torch.operator import logging as klog
from karpenter_tpu_torch.utils.clock import Clock

_log = klog.logger("disruption")

if TYPE_CHECKING:
    from karpenter_tpu_torch.controllers.provisioning.provisioner import Provisioner

MAX_RETRY_DURATION = 600.0  # queue.go:63

_DISRUPTED_TOTAL = global_registry.counter(
    "karpenter_nodeclaims_disrupted_total",
    "nodeclaims disrupted",
    labels=["reason", "nodepool", "capacity_type"],
)
_QUEUE_FAILURES = global_registry.counter(
    "karpenter_voluntary_disruption_queue_failures_total",
    "disruption commands that failed",
    labels=["decision", "reason", "consolidation_type"],
)
_DECISIONS_TOTAL = global_registry.counter(
    "karpenter_voluntary_disruption_decisions_total",
    "disruption decisions performed",
    labels=["decision", "reason", "consolidation_type"],
)


class UnrecoverableError(Exception):
    pass


class Queue:
    def __init__(
        self,
        store: Store,
        recorder: Recorder,
        cluster: Cluster,
        clock: Clock,
        provisioner: "Provisioner",
        journal=None,
    ):
        self.store = store
        self.recorder = recorder
        self.cluster = cluster
        self.clock = clock
        self.provisioner = provisioner
        self.journal = journal
        self._commands: dict[str, Command] = {}  # provider id -> command

    def has_any(self, *provider_ids: str) -> bool:
        return any(pid in self._commands for pid in provider_ids)

    def is_empty(self) -> bool:
        return not self._commands

    def get_commands(self) -> list[Command]:
        seen = []
        for cmd in self._commands.values():
            if cmd not in seen:
                seen.append(cmd)
        return seen

    # -- launch (queue.go:286-350) ------------------------------------------

    def start_command(self, cmd: Command) -> None:
        provider_ids = [c.provider_id() for c in cmd.candidates]
        if self.has_any(*provider_ids):
            raise ValueError("candidate is being disrupted")
        # intent BEFORE the first effect (taints/conditions): a crash
        # anywhere in this command leaves a pending journal record carrying
        # the candidates, and Operator.recover() rolls the marks back so
        # disruption-budget headroom never leaks
        seq = None
        if self.journal is not None:
            names = sorted(c.name() for c in cmd.candidates)
            seq = self.journal.intent(
                "disruption.command",
                uid=names[0] if names else "",
                key=f"disrupt/{'+'.join(names)}",
                candidates=names,
                provider_ids=sorted(provider_ids),
                reason=cmd.reason,
            )
            cmd.journal_seq = seq
        try:
            marked = self._mark_disrupted(cmd)
            if len(marked) != len(cmd.candidates) and (cmd.replacements or not marked):
                raise ValueError("marking disrupted failed")
        except Exception as e:  # noqa: BLE001 — close the intent, then surface
            if seq is not None:
                self.journal.failed(seq, error=str(e))
            raise
        cmd.candidates = marked
        _log.info(
            "disrupting nodeclaim(s)",
            reason=cmd.reason,
            candidates=[c.name() for c in cmd.candidates],
            replacements=len(cmd.replacements),
        )
        try:
            self._create_replacements(cmd)
        except Exception as e:  # noqa: BLE001 — close the intent, then surface
            if seq is not None:
                self.journal.failed(seq, error=str(e))
            raise
        if cmd.results is not None:
            cmd.results.record(self.recorder, self.cluster)
        for c in cmd.candidates:
            self._commands[c.provider_id()] = cmd
        self.cluster.mark_for_deletion(*[c.provider_id() for c in cmd.candidates])
        _DECISIONS_TOTAL.inc(
            {
                "decision": cmd.decision(),
                "reason": cmd.reason.lower(),
                "consolidation_type": (
                    cmd.method.consolidation_type() if cmd.method else ""
                ),
            }
        )

    def _mark_disrupted(self, cmd: Command) -> list:
        """Taint + Disrupted condition on every candidate (queue.go:235-265)."""
        marked = []
        for candidate in cmd.candidates:
            try:
                require_no_schedule_taint(self.store, True, candidate.state_node)
                claim = self.store.get("NodeClaim", candidate.node_claim.metadata.name)
                claim.set_condition(
                    CONDITION_DISRUPTION_REASON,
                    "True",
                    reason=cmd.reason,
                    message=cmd.reason,
                    now=self.clock.now(),
                )
                self.store.apply(claim)
            except NotFound:
                continue
            marked.append(candidate)
        return marked

    def _create_replacements(self, cmd: Command) -> None:
        names = self.provisioner.create_node_claims(
            [r.node_claim for r in cmd.replacements],
            reason=cmd.reason.lower(),
        )
        if len(names) != len(cmd.replacements):
            raise ValueError("expected replacement count did not equal actual")
        for replacement, name in zip(cmd.replacements, names):
            replacement.name = name

    # -- drain (queue.go:123-233) -------------------------------------------

    def reconcile(self) -> None:
        """Progress every in-flight command: wait for replacements, then
        delete candidates; roll back on unrecoverable failure."""
        for cmd in self.get_commands():
            try:
                done = self._wait_or_terminate(cmd)
            except UnrecoverableError:
                failed_launches = [r for r in cmd.replacements if not r.initialized]
                _QUEUE_FAILURES.inc(
                    {
                        "decision": cmd.decision(),
                        "reason": cmd.reason.lower(),
                        "consolidation_type": (
                            cmd.method.consolidation_type() if cmd.method else ""
                        ),
                    },
                    value=float(max(1, len(failed_launches))),
                )
                state_nodes = [c.state_node for c in cmd.candidates]
                require_no_schedule_taint(self.store, False, *state_nodes)
                clear_node_claims_condition(
                    self.store, CONDITION_DISRUPTION_REASON, *state_nodes
                )
                self._complete(cmd)
                continue
            if done:
                cmd.succeeded = True
                self._complete(cmd)

    def _wait_or_terminate(self, cmd: Command) -> bool:
        """True when the command finished; raises UnrecoverableError on
        timeout or deleted replacement (queue.go:159-233). The timeout is
        checked only on the waiting path: the reference's defer runs after
        candidate deletion, so a command completing on the pass it crosses
        MAX_RETRY_DURATION still deletes its candidates instead of rolling
        back with replacements already launched."""
        waiting = False
        for replacement in cmd.replacements:
            if replacement.initialized:
                continue
            claim = self.store.try_get("NodeClaim", replacement.name)
            if claim is None:
                if not self.cluster.node_claim_exists(replacement.name):
                    raise UnrecoverableError("replacement was deleted")
                waiting = True
                continue
            self.recorder.publish(
                Event(claim, "Normal", "DisruptionLaunching", f"Launching NodeClaim: {cmd.reason}")
            )
            if not claim.condition_is_true(CONDITION_INITIALIZED):
                self.recorder.publish(
                    Event(
                        claim,
                        "Normal",
                        "DisruptionWaitingReadiness",
                        "Waiting on readiness to continue disruption",
                    )
                )
                waiting = True
                continue
            replacement.initialized = True
        if waiting:
            if self.clock.since(cmd.creation_timestamp) > MAX_RETRY_DURATION:
                raise UnrecoverableError("command reached timeout")
            return False
        # all replacements initialized: delete the candidates
        for candidate in cmd.candidates:
            claim = self.store.try_get("NodeClaim", candidate.node_claim.metadata.name)
            if claim is not None:
                self.store.delete(claim)
            self.recorder.publish(
                Event(
                    candidate.node_claim,
                    "Normal",
                    "DisruptionTerminating",
                    f"Disrupting NodeClaim: {cmd.reason}",
                )
            )
            _DISRUPTED_TOTAL.inc(
                {
                    "reason": cmd.reason.lower(),
                    "nodepool": candidate.labels().get(wk.NODEPOOL_LABEL_KEY, ""),
                    "capacity_type": candidate.capacity_type,
                }
            )
        return True

    def _complete(self, cmd: Command) -> None:
        if not cmd.succeeded:
            self.cluster.unmark_for_deletion(
                *[c.provider_id() for c in cmd.candidates]
            )
        seq = getattr(cmd, "journal_seq", None)
        if seq is not None and self.journal is not None:
            if cmd.succeeded:
                self.journal.done(seq)
            else:
                self.journal.failed(seq, error="rolled back")
        for c in cmd.candidates:
            self._commands.pop(c.provider_id(), None)
