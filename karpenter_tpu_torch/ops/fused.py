"""The one-dispatch solve: host builders + decode around packer.solve_scan.

The monotone FFD scan runs as ONE kernel launch on the card
(ops/packer.solve_scan, csrc/scan.cu): the host side precomputes the
*monotone verdict tables* the scan branches on — requirement-family
transition closures, claim-opening candidates, existing-node compatibility,
nodepool limit budgets — all of it from engine caches that stay warm across
passes, moves them to the engine's device, launches once and decodes the
placement back into the standard `_DeviceSolve` claim/node structures,
whose inherited `emit()` finishes the solve exactly like the host walk.

A copy of the reference's dispatch (karpenter_tpu/ops/fused.py), the
classic one and, with delta solves on, the scan residency's
(`_delta_dispatch`, ops/delta.py), each with its mesh twin (an engine with
a mesh launches the scan replicated on every shard,
packer.sharded_solve_scan*), without the AOT ladder. Each scan launch
goes through the kernel observatory's choke point (tracing/kernel.dispatch)
under the reference's names — `packer.solve_scan`, `packer.solve_scan_full`,
`packer.solve_scan_resume` — with the reference's `aot_scope` on a mesh,
where one dispatch covers every replica's launch; the famu_ok build (B6)
has no named dispatch, as in the reference. The host
walk (ffd._DeviceSolve / the native C++ driver) remains the semantics
oracle and the path for shapes the scan does not cover; those decline with
a metered taxonomy reason (`karpenter_scheduler_fused_declines_total{reason=}`):

    topo           topology/preferences/strict-reserved routed solves
    min            minValues templates (host diversity gates)
    reserved       reserved-capacity bookkeeping (host can_add cycle)
    templates      no/too many nodeclaim templates
    size           pod/group/node/fam axes past the scan buckets
    nodes          existing-node requirement state that later joins could
                   narrow (non-single-valued rows on a group-constrained
                   key) — static node compatibility would be unsound
    closure        the family closure outgrew its bucket
    claim-overflow / queue-overflow
                   post-dispatch aborts (the scan ran out of claim slots
                   or requeue capacity; the host walk re-solves)

Every decline depends on the batch's shape alone. The reference's
`divergence` decline (the decode's host-side error recomputation opening a
claim the scan did not) is a fault here: it means the kernel disagrees with
the host semantics, so it raises KernelError and fails the solve.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch import convert
from karpenter_tpu_torch.device import KernelError, device_work
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.ops import delta as delta_mod
from karpenter_tpu_torch.ops import ffd
from karpenter_tpu_torch.ops import feasibility as feas
from karpenter_tpu_torch.ops import packer
from karpenter_tpu_torch.scheduling.taints import Taints
from karpenter_tpu_torch.tracing import kernel as ktime
from karpenter_tpu_torch.utils import resources as res

# -- mode + metering ----------------------------------------------------------

# off: never fuse. on: fuse every eligible batch. auto (default): fuse on a
# CUDA engine only — on a device="cpu" engine the native walk out-runs the
# plain scan, as it out-runs an XLA while_loop in the reference on a CPU
# backend. Tests opt in explicitly (KARPENTER_TPU_FUSED=on).
FUSED_MODE = os.environ.get("KARPENTER_TPU_FUSED", "auto").strip().lower() or "auto"

FUSED_SOLVES = 0
FUSED_DECLINES: dict[str, int] = {}
_FUSED_SOLVES_CTR = global_registry.counter(
    "karpenter_scheduler_fused_solves_total",
    "scheduling solves executed as one fused device dispatch",
)
_FUSED_DECLINES_CTR = global_registry.counter(
    "karpenter_scheduler_fused_declines_total",
    "fused-solve declines back to the host walk, by taxonomy reason",
    labels=["reason"],
)

# scan bucket caps: past these the host walk is the designed slow path
FUSED_MAX_PODS = 1 << 17
FUSED_MAX_GROUPS = 4096
FUSED_MAX_NODES = 4096
FUSED_MAX_FAMS = 1024
FUSED_MAX_TEMPLATES = 8
# with limits active the per-step transition evaluation carries full
# instance-axis masks (exact, but heavier) — cap the batch size it runs at
FUSED_LIMITS_MAX_PODS = 8192


def note_decline(reason: str) -> None:
    FUSED_DECLINES[reason] = FUSED_DECLINES.get(reason, 0) + 1
    _FUSED_DECLINES_CTR.inc({"reason": reason})
    # fold the decline taxonomy into the provenance ledger (`fused:<reason>`
    # stages): a decline reroutes the batch to the host walk, whose per-pod
    # errors stage normally, so per-pod explanations stay path-identical
    from karpenter_tpu_torch.observability import explain as explmod

    explmod.recorder().note_fused_decline(reason)


def fused_counters() -> dict:
    out = {"fused_solves": FUSED_SOLVES}
    for reason, n in sorted(FUSED_DECLINES.items()):
        out[f"fused_decline_{reason}"] = n
    return out


def fused_enabled(engine) -> bool:
    mode = FUSED_MODE
    if mode in ("on", "1", "true"):
        return True
    if mode in ("off", "0", "false", ""):
        return False
    # auto: the scan runs where the engine's device is the card
    return engine is not None and engine.device.type == "cuda"


class _FusedDecline(ffd._Fallback):
    """Internal: this batch isn't scan-shaped — run the host walk."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason
        note_decline(reason)


def _pow2(n: int, floor: int) -> int:
    return max(floor, 1 << max(0, (int(n) - 1).bit_length()))


class _FusedSolve(ffd._DeviceSolve):
    """One-dispatch variant of the device solve: same encode, same emit,
    the queue walk replaced by the device-resident scan."""

    def run(self, timeout: Optional[float]) -> None:
        gi_arr = self._group_pods()
        if gi_arr is None:
            raise ffd._IneligibleShape("ineligible pod shape")
        if self.res_active:
            raise _FusedDecline("reserved")
        T = len(self.s.nodeclaim_templates)
        if not (0 < T <= FUSED_MAX_TEMPLATES):
            raise _FusedDecline("templates")
        self._prepare_templates()
        if self.min_active:
            raise _FusedDecline("min")
        order = self._order(gi_arr)
        self._fused_solve(gi_arr, order)
        self.timed_out = False

    # -- builders ------------------------------------------------------------

    def _group_reps(self, gi_arr: np.ndarray, order: np.ndarray) -> list:
        """One representative pod per group (tolerations/taints are part of
        the shape signature, so any member answers for the group)."""
        reps: list = [None] * len(self.groups)
        remaining = len(self.groups)
        for i in order:
            gi = int(gi_arr[i])
            if reps[gi] is None:
                reps[gi] = self.pods[int(i)]
                remaining -= 1
                if not remaining:
                    break
        return reps

    def _node_tensors(self, reps: list):
        """Static per-(node, group) admissibility + headroom vectors. Sound
        only when no group join can change a node's requirement VALUES —
        every group-constrained key must already be a single-valued In row
        on the node, making the host's joint-narrowing a value-no-op."""
        ens = self.s.existing_nodes
        N = len(ens)
        if N == 0:
            return None, None
        if N > FUSED_MAX_NODES:
            raise _FusedDecline("size")
        group_keys = sorted({r.key for g in self.groups for r in g.reqs})
        G = len(self.groups)
        node_ok = np.zeros((N, G), dtype=bool)
        node_rem = np.zeros((N, self.D), dtype=np.float64)
        for j, en in enumerate(ens):
            reqs = en.requirements
            for key in group_keys:
                if not reqs.has(key):
                    raise _FusedDecline("nodes")
                r = reqs.get(key)
                if (
                    r.complement
                    or r.greater_than is not None
                    or r.less_than is not None
                    or len(r.values) != 1
                ):
                    raise _FusedDecline("nodes")
            taints = Taints(en.cached_taints)
            for gi, g in enumerate(self.groups):
                node_ok[j, gi] = (
                    taints.tolerates_pod(reps[gi]) is None
                    and reqs.compatible(g.reqs) is None
                )
            for name, v in en.remaining_resources.items():
                d = self.dims.get(name)
                if d is not None:
                    node_rem[j, d] = v
        return node_ok, node_rem

    def _closure(self):
        """Transitive closure of the requirement-family transition graph
        from every opening family over every group — the scan's verdict
        tables. All requirement algebra rides the engine-level caches
        (solver_fam_trans, solver_joint_cache), so steady-state passes
        rebuild this from warm dictionaries without a single sweep."""
        G = len(self.groups)
        kinds: list[np.ndarray] = []
        fams: list[np.ndarray] = []
        done = 0
        while done < len(self.fam_rows):
            if len(self.fam_rows) > FUSED_MAX_FAMS:
                raise _FusedDecline("closure")
            f = done
            done += 1
            krow = np.zeros(G, dtype=np.int8)
            frow = np.zeros(G, dtype=np.int32)
            for gi in range(G):
                ent = self.fam_join.get((f, gi))
                if ent is None:
                    ent = self._build_fam_join(f, gi)
                kind = ent[0]
                if kind == self._REJECT:
                    krow[gi] = packer._KIND_REJECT
                elif kind == self._SAME:
                    krow[gi] = packer._KIND_SAME
                    frow[gi] = f
                else:
                    krow[gi] = packer._KIND_NARROW
                    frow[gi] = ent[1]
            kinds.append(krow)
            fams.append(frow)
        F = len(self.fam_rows)
        trans_kind = np.stack(kinds) if kinds else np.zeros((0, G), np.int8)
        trans_fam = np.stack(fams) if fams else np.zeros((0, G), np.int32)
        fam_mask = np.zeros((F, self.I), dtype=bool)
        for f in range(F):
            compat_v, offer_v = self._joint_masks(
                self.fam_rows[f], self.fam_reqs[f]
            )
            fam_mask[f] = compat_v & offer_v
        return trans_kind, trans_fam, fam_mask

    def _open_tensors(self):
        """Per-(template, group) opening verdicts from the memoized
        limitless open entries (the exact tables _new_claim consults)."""
        T = len(self.s.nodeclaim_templates)
        G = len(self.groups)
        open_ok = np.zeros((T, G), dtype=bool)
        open_fam = np.zeros((T, G), dtype=np.int32)
        open_uok = np.zeros((T, G, self.U), dtype=bool)
        open_cand = np.zeros((T, G, self.I), dtype=bool)
        tol = np.zeros((T, G), dtype=bool)
        for ti in range(T):
            for gi in range(G):
                if self._tg(ti, gi) is None:
                    continue
                entry = self._ensure_open_entry(ti, gi)
                if entry[0] < 0:
                    continue
                fam, candidate0, u_ids0, _rem, _specs, _relaxed = entry
                open_ok[ti, gi] = True
                open_fam[ti, gi] = fam
                open_uok[ti, gi, u_ids0] = True
                open_cand[ti, gi] = candidate0
        return open_ok, open_fam, open_uok, open_cand, tol

    def _fill_tol(self, tol: np.ndarray, reps: list) -> None:
        for ti, nct in enumerate(self.s.nodeclaim_templates):
            taints = Taints(nct.spec.taints)
            for gi in range(len(self.groups)):
                got = self.tg_tol.get((ti, gi))
                if got is None:
                    got = taints.tolerates_pod(reps[gi]) is None
                    self.tg_tol[(ti, gi)] = got
                tol[ti, gi] = got

    def _limit_tensors(self):
        """Nodepool limit budgets as dense dim vectors + presence masks.
        Non-dim limit entries never move (subtract_max only touches dims):
        a negative one permanently empties the pool's mask (pool_bad)."""
        _EPS = ffd._EPS
        pools: list[str] = []
        pool_idx: dict[str, int] = {}
        T = len(self.s.nodeclaim_templates)
        pool_of_t = np.full(T, -1, dtype=np.int32)
        for ti, nct in enumerate(self.s.nodeclaim_templates):
            remaining = self.remaining_resources.get(nct.nodepool_name)
            if not remaining:
                continue
            li = pool_idx.get(nct.nodepool_name)
            if li is None:
                li = pool_idx[nct.nodepool_name] = len(pools)
                pools.append(nct.nodepool_name)
            pool_of_t[ti] = li
        L = len(pools)
        if L == 0:
            return None
        pool_rem = np.zeros((L, self.D), dtype=np.float64)
        pool_has = np.zeros((L, self.D), dtype=bool)
        pool_bad = np.zeros(L, dtype=bool)
        for li, name in enumerate(pools):
            for key, limit in self.remaining_resources[name].items():
                d = self.dims.get(key)
                if d is None:
                    if 0.0 > limit + _EPS:
                        pool_bad[li] = True
                else:
                    pool_rem[li, d] = limit
                    pool_has[li, d] = True
        return pools, pool_of_t, pool_rem, pool_has, pool_bad

    def _claim_estimate(self, open_ok, open_fam, gi_arr) -> int:
        """Rough upper estimate of how many claims this batch opens: per
        group, pods over the best single-group claim capacity. Not a proof
        (mixed-group packing can open more) — the scan aborts with
        SCAN_CLAIM_OVERFLOW past the bucket and the host walk re-solves, so
        a low estimate costs a metered decline, never a wrong answer."""
        counts = np.bincount(gi_arr, minlength=len(self.groups))
        est = 1
        for gi, g in enumerate(self.groups):
            n = int(counts[gi])
            if n == 0:
                continue
            best = 1
            for ti in range(open_ok.shape[0]):
                if not open_ok[ti, gi]:
                    continue
                entry = self.open_cache.get((ti, gi))
                if entry is None or entry[0] < 0:
                    continue
                rem0 = entry[3]
                per_dim = np.full_like(rem0, np.inf)
                pos = g.req_f > 0
                if pos.any():
                    per_dim[:, pos] = rem0[:, pos] // g.req_f[pos] + 1
                    best = max(best, int(per_dim.min(axis=1).max()))
                else:
                    best = n
            est += -(-n // max(1, best))
        return est

    # -- dispatch ------------------------------------------------------------

    def _fused_solve(self, gi_arr: np.ndarray, order: np.ndarray) -> None:
        P_real = len(self.pods)
        G_real = len(self.groups)
        T = len(self.s.nodeclaim_templates)
        if P_real > FUSED_MAX_PODS or G_real > FUSED_MAX_GROUPS:
            raise _FusedDecline("size")
        reps = self._group_reps(gi_arr, order)
        node_ok, node_rem0 = self._node_tensors(reps)
        has_nodes = node_ok is not None
        limits = self._limit_tensors()
        has_limits = limits is not None
        if has_limits and P_real > FUSED_LIMITS_MAX_PODS:
            raise _FusedDecline("size")
        open_ok, open_fam, open_uok, open_cand, tol = self._open_tensors()
        self._fill_tol(tol, reps)
        trans_kind, trans_fam, fam_mask = self._closure()
        F_real = trans_kind.shape[0]
        N_real = len(self.s.existing_nodes) if has_nodes else 0

        # bucket the variable axes (pow2 floors). The claim axis is sized
        # from an estimate, NOT the pod count — the loop-carried claim state
        # is what every iteration updates in place, so its footprint sets
        # the per-step cost; overflow aborts to the host walk, metered.
        C_est = 2 * self._claim_estimate(open_ok, open_fam, gi_arr) + 64
        Pb = _pow2(P_real, 512)
        Gb = _pow2(G_real, 32)
        Cb = min(_pow2(C_est, 256), _pow2(P_real, 256))
        Nb = _pow2(N_real, 64) if has_nodes else 0
        Fb = _pow2(F_real, 64)

        D, U, I = self.D, self.U, self.I
        pod_gi = np.full(Pb, -1, dtype=np.int32)
        pod_gi[:P_real] = gi_arr[order]
        g_req = np.zeros((Gb, D), dtype=np.float64)
        g_floor = np.full((Gb, D), -1e-9, dtype=np.float64)
        for gi, g in enumerate(self.groups):
            g_req[gi] = g.req_f
            g_floor[gi] = g.fit_floor

        def padG(a, fill=0):
            out = np.zeros((a.shape[0], Gb) + a.shape[2:], dtype=a.dtype)
            if fill:
                out[:] = fill
            out[:, :G_real] = a
            return out

        tolP = padG(tol)
        open_okP = padG(open_ok)
        open_famP = padG(open_fam)
        open_uokP = padG(open_uok)
        tkP = np.full((Fb, Gb), packer._KIND_REJECT, dtype=np.int8)
        tkP[:F_real, :G_real] = trans_kind
        tfP = np.zeros((Fb, Gb), dtype=np.int32)
        tfP[:F_real, :G_real] = trans_fam
        # the three [*, I] masks the card needs, in one host array for one
        # copy: the uid one-hot (slot 20), fam_mask (slot 17) and tmpl_mask
        # (famu_ok's first factor; slot 18 with limits); host views of it
        # serve the host side
        masks = np.zeros((U + Fb + T, I), dtype=bool)
        masks[self.uid_of_type, np.arange(I)] = True  # feas.uid_onehot_matrix
        masks[U:U + F_real] = fam_mask
        masks[U + Fb:] = self.tmpl_mask
        uid_onehot, fam_maskP = masks[:U], masks[U:U + Fb]

        dummy2 = np.zeros((1, 1), dtype=np.float64)
        dummyb = np.zeros((1, 1), dtype=bool)
        if has_nodes:
            node_okP = np.zeros((Nb, Gb), dtype=bool)
            node_okP[:N_real, :G_real] = node_ok
            node_remP = np.zeros((Nb, D), dtype=np.float64)
            node_remP[:N_real] = node_rem0
        else:
            node_okP, node_remP = dummyb, dummy2
        if has_limits:
            pools, pool_of_t, pool_rem0, pool_has, pool_bad = limits
            open_candP = padG(open_cand)
            tmpl_maskP = self.tmpl_mask
            cap_fP = self.cap_f.astype(np.float64)
            uid_of_typeP = self.uid_of_type.astype(np.int32)
        else:
            pools, pool_of_t = [], np.full(T, -1, dtype=np.int32)
            pool_rem0, pool_has = dummy2, dummyb
            pool_bad = np.zeros(1, dtype=bool)
            open_candP, tmpl_maskP = dummyb[None], dummyb
            cap_fP = dummy2
            uid_of_typeP = np.zeros(1, dtype=np.int32)

        dev = self.engine.device
        mesh = self.engine.mesh
        scope = feas.mesh_scope(mesh) if mesh is not None else ""
        cfg = (T, has_nodes, has_limits)
        # the operands as host arrays, in the reference's layout; famu_ok
        # (slot 12) is built on the card below (B6) from tmpl_mask, fam_mask
        # (slot 17) and uid_onehot (slot 20), uploaded together
        host_ops = [
            pod_gi, np.zeros(Cb, dtype=np.int32), g_req, g_floor,
            self.uniq_alloc, self.usage0_f,
            tolP, open_okP, open_famP, open_uokP,
            tkP, tfP, None,
            np.int32(P_real), np.int32(N_real),
            node_okP, node_remP,
            fam_maskP, tmpl_maskP, open_candP,
            uid_onehot, uid_of_typeP, cap_fP,
            pool_of_t, pool_rem0, pool_has, pool_bad,
        ]
        with device_work("fused scan"):
            famu_ok, uid_onehot_d, fam_mask_d, tmpl_mask_d = self._famu_ok(masks, U, Fb, dev)
            dev_ops = list(host_ops)
            dev_ops[12], dev_ops[17], dev_ops[20] = famu_ok, fam_mask_d, uid_onehot_d
            if has_limits:
                dev_ops[18] = tmpl_mask_d
            args = convert.scan_operands_from_numpy(dev_ops, dev)
            if delta_mod.delta_enabled():
                # the delta fingerprint hashes what the scan consumes, as
                # the reference does: famu_ok itself ([T, F, U] bools), not
                # the template mask it was built from
                host_ops[12] = famu_ok.cpu().numpy()
                out = self._delta_dispatch(args, host_ops, cfg, scope, P_real)
            else:
                if mesh is not None:
                    fn = lambda *a: packer.sharded_solve_scan(mesh)(cfg, a)  # noqa: E731
                else:
                    fn = lambda *a: packer.solve_scan(cfg, a)  # noqa: E731
                out = ktime.dispatch(
                    fn, *args, kernel="packer.solve_scan", aot_scope=scope
                )[: packer.SCAN_N_OUT]
            (
                abort, nclaims, pod_claim, pod_node, pod_seq,
                claim_ti, claim_fam, u_valid, tm_st, pool_rem,
            ) = (t.cpu().numpy() for t in out)
        abort = int(abort)
        if abort == packer.SCAN_CLAIM_OVERFLOW:
            raise _FusedDecline("claim-overflow")
        if abort == packer.SCAN_QUEUE_OVERFLOW:
            raise _FusedDecline("queue-overflow")
        self._decode(
            order, gi_arr, int(nclaims),
            pod_claim[:P_real], pod_node[:P_real], pod_seq[:P_real],
            claim_ti, claim_fam, u_valid, fam_maskP,
            tm_st if has_limits else None,
            (pools, pool_rem) if has_limits else None,
        )
        global_fused_solved()

    @staticmethod
    def _famu_ok(masks: np.ndarray, U: int, Fb: int, dev) -> tuple:
        """famu_ok on `dev` from the [U + Fb + T, I] host masks (uid
        one-hot, fam_mask, tmpl_mask): one copy, then one kernel (B6) — uid
        survival per (template, fam): does any instance type in tmpl_mask ∧
        fam_mask map onto the unique-alloc row. Returns famu_ok and the
        three masks on `dev` (views of the one upload)."""
        masks_d = torch.from_numpy(masks).to(dev)
        uid_onehot_d, fam_mask_d, tmpl_mask_d = masks_d[:U], masks_d[U:U + Fb], masks_d[U + Fb:]
        famu_ok = feas.uid_project_factored(uid_onehot_d, tmpl_mask_d, fam_mask_d)
        return famu_ok, uid_onehot_d, fam_mask_d, tmpl_mask_d

    # -- delta residency dispatch --------------------------------------------

    def _delta_dispatch(self, args, host_ops, cfg, scope, p_real):
        """Residency-aware scan dispatch (ops/delta.py): a cold pass runs
        the full-state scan and commits its final state as the engine's
        residency; an eligible follow-up pass RESUMES the scan against the
        resident state, written in place (the suffix pods are the only new
        work). Every N warm passes the warm result is also re-solved from
        scratch and compared bit-for-bit — divergence fires a typed event,
        drops the residency, and the cold result wins. On a mesh engine
        every launch is replicated and each shard's state stays resident.
        Returns the classic 10-output decode subset."""
        res = delta_mod.scan_residency(self.engine)
        shape_key = tuple(tuple(a.shape) for a in args)
        ops_fp = delta_mod.operand_fingerprint(host_ops, skip=(0, 13))
        pod_gi = host_ops[0]
        miss = res.eligibility(cfg, shape_key, ops_fp, pod_gi, p_real)
        # both launches return one state per replica: one without a mesh,
        # one per shard with it (the residency keeps them all)
        mesh = self.engine.mesh

        def full():
            def call(*a):
                if mesh is None:
                    return (packer.solve_scan_full(cfg, a)[:-1],)
                return tuple(r[:-1] for r in packer.sharded_solve_scan_full(mesh)(cfg, a))

            return ktime.dispatch(
                call, *args, kernel="packer.solve_scan_full", aot_scope=scope
            )

        def resume(states, p_lo):
            # the operands, shard 0's state and p_lo are the dispatch's
            # arguments (its shape signature, as the reference's)
            def call(*_):
                if mesh is None:
                    return (packer.solve_scan_resume(cfg, args, states[0], p_lo)[:-1],)
                return tuple(r[:-1] for r in packer.sharded_solve_scan_resume(mesh)(cfg, args, states, p_lo))

            return ktime.dispatch(
                call, *args, *states[0], np.int32(p_lo),
                kernel="packer.solve_scan_resume", aot_scope=scope,
            )

        mode = "cold"
        if miss == "":
            check_due = (
                delta_mod.RESOLVE_FULL_EVERY > 0
                and (res.warm_passes + 1) % delta_mod.RESOLVE_FULL_EVERY == 0
            )
            # the resident tensors are written in place by this launch —
            # clear the residency first so a failed launch can never leave
            # half-written state installed
            prev_states, prev_lo = res.replica_states(), res.p_real
            res.state, res.replicas = None, ()
            delta_mod.note_scan("warm")
            states = resume(prev_states, prev_lo)
            res.warm_passes += 1
            res.last_outcome = mode = "warm"
            if check_due:
                cold = full()
                identical = all(
                    torch.equal(packer.scan_component(states[0], i), packer.scan_component(cold[0], i))
                    for i in packer._SCAN_OUT_IDX
                )
                if identical:
                    delta_mod.note_selfcheck("identical")
                    delta_mod.note_pass("warm-check")
                else:
                    delta_mod._emit_divergence(
                        "packer.solve_scan",
                        f"warm resume diverged from the from-scratch "
                        f"re-solve (P={p_real}, warm_pass={res.warm_passes})",
                    )
                    res.invalidate("selfcheck-divergence")
                    states = cold
                    mode = "cold"
        else:
            delta_mod.note_scan(miss)
            res.last_outcome = miss
            states = full()
        delta_mod.note_pass(mode)
        # shard 0's state is the result (every replica agrees); one 8-int
        # copy: head, tail, stop, abort, seqc, done, nclaims, steps
        state = states[0]
        scal = state[0].cpu()
        head, tail, stop, abort = (int(v) for v in scal[:4])
        extendable = (
            abort == packer.SCAN_OK
            and not stop
            and head == tail
            and tail == p_real
        )
        res.commit(state, cfg, shape_key, ops_fp, pod_gi, p_real, extendable,
                   replicas=states if mesh is not None else ())
        return (scal[3], scal[6]) + packer._scan_finals(state)[2:]

    # -- decode --------------------------------------------------------------

    def _decode(
        self, order, gi_arr, nclaims, pod_claim, pod_node, pod_seq,
        claim_ti, claim_fam, u_valid, fam_maskP, tm_st, pool_final,
    ) -> None:
        sorted_pods = [self.pods[int(i)] for i in order]
        gi_sorted = gi_arr[order]
        # claims, in device open order (placeholder hostnames drawn in the
        # same order the host walk would)
        for ci in range(nclaims):
            ti = int(claim_ti[ci])
            fam = int(claim_fam[ci])
            type_mask = self.tmpl_mask[ti] & fam_maskP[fam]
            if tm_st is not None:
                type_mask = type_mask & tm_st[ci]
            c = ffd._Claim(
                ti, fam,
                f"device-placeholder-{next(ffd._placeholder_counter):04d}",
                type_mask,
                np.nonzero(u_valid[ci])[0].astype(np.int64),
                np.zeros((0, self.D)),
                0,
            )
            c.min_specs = self.tmpl_min[ti]
            self.claims.append(c)
        # membership + node joins, in placement order
        placed = np.nonzero(pod_seq >= 0)[0]
        placed = placed[np.argsort(pod_seq[placed], kind="stable")]
        node_joins: dict[int, list[int]] = {}
        for s in placed.tolist():
            pod = sorted_pods[s]
            gi = int(gi_sorted[s])
            ci = int(pod_claim[s])
            if ci >= 0:
                c = self.claims[ci]
                c.count += 1
                c.members.append(pod)
                c.group_counts[gi] = c.group_counts.get(gi, 0) + 1
            else:
                node_joins.setdefault(int(pod_node[s]), []).append(s)
        # node commits: replay the host's per-join dict subtraction so the
        # emitted remaining_resources are bit-identical (incl. non-dim keys)
        for j, joins in node_joins.items():
            nd = self.nodes[j]
            for s in joins:
                pod = sorted_pods[s]
                g = self.groups[int(gi_sorted[s])]
                nd.joined.append(pod)
                nd.remaining = res.subtract(nd.remaining, g.requests)
        # nodepool budgets: device-final dim values, untouched non-dims
        if pool_final is not None:
            pools, pool_rem = pool_final
            for li, name in enumerate(pools):
                remaining = self.remaining_resources[name]
                # float(): keep plain Python floats in the dict (bit-equal
                # values; np scalars would leak into downstream surfaces)
                self.remaining_resources[name] = {
                    k: (float(pool_rem[li, self.dims[k]]) if k in self.dims else v)
                    for k, v in remaining.items()
                }
                # invalidate the limit-mask/open caches the error
                # reconstruction below consults
                self.limits_version += 1
                self.pool_limits_ver[name] = (
                    self.pool_limits_ver.get(name, 0) + 1
                )
        # failures: recompute the host's exact last-attempt errors at final
        # state through the REAL _new_claim. A successful open here means
        # the kernel and the host semantics disagree: a fault, not a decline.
        for s in np.nonzero(pod_seq < 0)[0].tolist():
            pod = sorted_pods[s]
            gi = int(gi_sorted[s])
            if not self.s.nodeclaim_templates:
                self.pod_errors[pod] = ValueError(
                    "nodepool requirements filtered out all available "
                    "instance types"
                )
                continue
            err = self._new_claim(pod, self.groups[gi], gi)
            if err is None:
                raise KernelError(
                    f"fused scan diverged from the host semantics: pod "
                    f"{pod.metadata.name} failed on the card but opens a claim "
                    f"on the host"
                )
            self.pod_errors[pod] = err


def global_fused_solved() -> None:
    global FUSED_SOLVES
    FUSED_SOLVES += 1
    _FUSED_SOLVES_CTR.inc()


def maybe_attempts(scheduler) -> Sequence:
    """The attempt list prefix for fused-eligible routing; [] when the
    fused path is off (topology-routed solves meter their decline in
    ffd.solve_device)."""
    if not fused_enabled(scheduler.engine):
        return []
    return [_FusedSolve]
