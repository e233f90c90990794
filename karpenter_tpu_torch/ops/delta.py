"""Incremental delta solves: persistent card-resident solver state.

Production traffic is churn, not cold batches. Every provisioning pass used
to re-encode the whole cluster and re-solve the full pending set even at 1%
pod churn; this module makes solver state a persistent, generation-stamped
DEVICE RESIDENCY that passes update in place instead of rebuilding:

1. **Delta encode** (`EncodeCache`): a content/identity row cache for
   `packer.encode_pods_for_packer` — a pass re-encodes only requirement
   shapes it has never seen; everything else reuses interned row ids,
   membership rows, and key-presence rows. Bytes re-encoded are metered per
   pass, so the steady-state encode cost scales with churn, not cluster
   size.

2. **Warm group solves** (`GroupResidency`): per-group solve_block results
   (choice, feasibility, pods-per-node — the count-INDEPENDENT outputs)
   stay resident on the engine's device, keyed by group content
   fingerprint. A pass solves only the perturbed frontier (new/changed
   groups) and writes their core rows into the resident [cap, 3] int32
   tensor IN PLACE, in one launch (`packer.solve_block_scatter`:
   kt_group_solve's scatter mode; its rows and slots go up in one staged
   upload), and finalizes nodes/unschedulable from this pass's counts.
   Group count changes — the dominant churn signal — cost zero solve work.

3. **Warm scan residency** (`ScanResidency`): the fused one-dispatch FFD
   scan's loop-carried state (claim headroom matrices, count tensors, the
   claim heap key vector, nodepool budgets) survives between passes as the
   full final state of `packer.solve_scan_full` (the reference's 23
   components: the seven scalars in one int32 `scal` vector, then 16
   tensors). An eligible follow-up pass — byte-identical verdict-table
   operands, a pod stream that extends the previous order as an exact
   prefix, and a previous pass that drained without a single requeue —
   resumes the scan against the resident state through
   `packer.solve_scan_resume`, which writes the resident tensors in place
   (the reference donates them to XLA) and enqueues only the new suffix
   pods. Resumption is bit-identical to a cold solve of the full list by
   construction: the resident state IS the cold scan's mid-state after the
   prefix (zero requeues ⇒ identical queue prefix, head, tail, and per-claim
   state).

Self-check: every N warm passes (`--resolve-full-every`, default 16) the
warm result is compared against a from-scratch re-solve; any divergence
fires a typed event, drops the residency, and falls back to the full result
— the delta path can be slower than designed, never wrong.

Invalidation: generation stamps (engine `_computed_rows`, operand content
fingerprints) guard every residency; `invalidate_all(reason)` drops
everything (engine rebuild, crash-recovery restart, topology
rollback/restore), metered by reason.

The fingerprint hashes the host copies of the operands the scan consumes,
`famu_ok` (the B6 output, copied back: [T, F, U] bools) among them, as the
reference does.

A copy of the reference's module (karpenter_tpu/ops/delta.py) with its
state in torch tensors. On an engine with a mesh the scan residency holds
the replicated state, one tensor set per shard, and the group solver
bypasses its residency (GroupSolver.solve). `_bucket_groups` takes the
engine's AOT ladder rung for `packer.solve_block` when one is attached, as
the reference does.
"""

from __future__ import annotations

import hashlib
import os
import threading
import weakref
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch.metrics import global_registry

# -- mode + cadence -----------------------------------------------------------

# off (default): no residency — every solve is the cold path. on: keep
# solver state resident on the card between passes. Tests and chip_smoke.py
# opt in explicitly (KARPENTER_TPU_DELTA=on / configure(mode="on")).
DELTA_MODE = os.environ.get("KARPENTER_TPU_DELTA", "off").strip().lower() or "off"

# Self-check cadence: every Nth warm pass ALSO runs a from-scratch re-solve
# and asserts decision identity (--resolve-full-every; 0 = check never).
RESOLVE_FULL_EVERY = int(
    os.environ.get("KARPENTER_TPU_RESOLVE_FULL_EVERY", "16") or 16
)


def delta_enabled() -> bool:
    return DELTA_MODE in ("on", "1", "true")


def configure(
    mode: Optional[str] = None, resolve_full_every: Optional[int] = None
) -> None:
    """Option wiring (operator/sim CLIs): the flag wins over the env."""
    global DELTA_MODE, RESOLVE_FULL_EVERY
    if mode:
        DELTA_MODE = mode.strip().lower()
    if resolve_full_every is not None and resolve_full_every >= 0:
        RESOLVE_FULL_EVERY = int(resolve_full_every)


# -- metering -----------------------------------------------------------------

_PASSES_CTR = global_registry.counter(
    "karpenter_solver_delta_passes_total",
    "delta-solve passes by mode (cold seeds residency, warm resumes it, "
    "warm-check additionally ran the from-scratch self-check)",
    labels=["mode"],
)
_BYTES_CTR = global_registry.counter(
    "karpenter_solver_delta_bytes_reencoded_total",
    "bytes of requirement/membership rows re-encoded (cache misses); a "
    "steady churn pass re-encodes O(churn), not O(cluster)",
)
_ROWS_CTR = global_registry.counter(
    "karpenter_solver_delta_rows_total",
    "encode-cache row lookups by outcome",
    labels=["outcome"],
)
_GROUPS_CTR = global_registry.counter(
    "karpenter_solver_delta_groups_total",
    "resident group-solve slots by outcome (reused vs frontier-solved)",
    labels=["outcome"],
)
_SCAN_CTR = global_registry.counter(
    "karpenter_solver_delta_scan_total",
    "fused-scan residency dispatch outcomes (warm resume vs miss reason)",
    labels=["outcome"],
)
_SELFCHECK_CTR = global_registry.counter(
    "karpenter_solver_delta_selfchecks_total",
    "periodic warm-vs-full identity checks by verdict",
    labels=["outcome"],
)
_INVALIDATE_CTR = global_registry.counter(
    "karpenter_solver_delta_invalidations_total",
    "residency drops by reason",
    labels=["reason"],
)
_RESIDENT_GAUGE = global_registry.gauge(
    "karpenter_solver_delta_resident_bytes",
    "bytes of device-resident solver state held between passes",
)

# plain-dict mirror for report surfaces (chip_smoke.py, solver counters):
# snapshot-and-delta friendly, no label plumbing
COUNTERS: dict[str, int] = {
    "delta_passes_cold": 0,
    "delta_passes_warm": 0,
    "delta_passes_warm_check": 0,
    "delta_bytes_reencoded": 0,
    "delta_rows_reused": 0,
    "delta_rows_encoded": 0,
    "delta_groups_reused": 0,
    "delta_groups_solved": 0,
    "delta_scan_warm": 0,
    "delta_scan_miss": 0,
    "delta_selfchecks_identical": 0,
    "delta_selfchecks_divergent": 0,
    "delta_invalidations": 0,
}
_LOCK = threading.Lock()


def _count(key: str, n: int = 1) -> None:
    with _LOCK:
        COUNTERS[key] = COUNTERS.get(key, 0) + n


def delta_counters() -> dict:
    with _LOCK:
        return dict(COUNTERS)


def note_pass(mode: str) -> None:
    _PASSES_CTR.inc({"mode": mode})
    _count(f"delta_passes_{mode.replace('-', '_')}")


def note_bytes_reencoded(n: int) -> None:
    if n:
        _BYTES_CTR.inc(value=float(n))
        _count("delta_bytes_reencoded", n)


def note_rows(outcome: str, n: int = 1) -> None:
    if n:
        _ROWS_CTR.inc({"outcome": outcome}, value=float(n))
        _count(f"delta_rows_{outcome}", n)


def note_groups(outcome: str, n: int = 1) -> None:
    if n:
        _GROUPS_CTR.inc({"outcome": outcome}, value=float(n))
        _count(f"delta_groups_{outcome}", n)


def note_scan(outcome: str) -> None:
    _SCAN_CTR.inc({"outcome": outcome})
    _count("delta_scan_warm" if outcome == "warm" else "delta_scan_miss")


def note_selfcheck(outcome: str) -> None:
    _SELFCHECK_CTR.inc({"outcome": outcome})
    _count(f"delta_selfchecks_{outcome}")


# -- divergence events --------------------------------------------------------

_DIVERGENCE_SINKS: dict[str, Callable[[str, str], None]] = {}


def on_divergence(fn: Callable[[str, str], None], key: str = "default") -> None:
    """Register a (kernel, detail) sink for self-check divergences — the
    provisioner publishes a typed Warning event through this."""
    _DIVERGENCE_SINKS[key] = fn


def _emit_divergence(kernel: str, detail: str) -> None:
    note_selfcheck("divergent")
    for fn in list(_DIVERGENCE_SINKS.values()):
        try:
            fn(kernel, detail)
        except Exception:  # noqa: BLE001 — telemetry must not fail solves
            pass


# -- residency registry -------------------------------------------------------

# Engine id -> residency. Weak finalizers clean up when an engine is
# collected; invalidate_all drops everything explicitly (engine rebuild,
# crash-recovery restart, rollback/restore pathologies).
_SCAN_RESIDENCIES: dict[int, "ScanResidency"] = {}
_GROUP_RESIDENCIES: dict[int, "GroupResidency"] = {}
_ENCODE_CACHES: dict[int, "EncodeCache"] = {}


def scan_residency(engine) -> "ScanResidency":
    key = id(engine)
    res = _SCAN_RESIDENCIES.get(key)
    if res is None:
        res = ScanResidency()
        _SCAN_RESIDENCIES[key] = res
        weakref.finalize(engine, _SCAN_RESIDENCIES.pop, key, None)
    return res


def group_residency(solver) -> "GroupResidency":
    key = id(solver)
    res = _GROUP_RESIDENCIES.get(key)
    if res is None:
        res = GroupResidency()
        _GROUP_RESIDENCIES[key] = res
        weakref.finalize(solver, _GROUP_RESIDENCIES.pop, key, None)
    return res


def encode_cache(engine) -> Optional["EncodeCache"]:
    """The per-engine cross-pass encode cache (None with delta off).
    `packer.encode_pods_for_packer` picks this up automatically when the
    caller doesn't thread an explicit cache."""
    if not delta_enabled():
        return None
    key = id(engine)
    c = _ENCODE_CACHES.get(key)
    if c is None:
        c = EncodeCache()
        _ENCODE_CACHES[key] = c
        weakref.finalize(engine, _ENCODE_CACHES.pop, key, None)
    return c


def invalidate_all(reason: str) -> None:
    """Drop every residency (engine rebuild, restart recovery, rollback)."""
    dropped = 0
    for res in list(_SCAN_RESIDENCIES.values()):
        dropped += res.invalidate(reason, _registry_sweep=True)
    for res in list(_GROUP_RESIDENCIES.values()):
        dropped += res.invalidate(reason, _registry_sweep=True)
    for c in list(_ENCODE_CACHES.values()):
        c.clear()
    if dropped:
        _INVALIDATE_CTR.inc({"reason": reason}, value=float(dropped))
        _count("delta_invalidations", dropped)
    _update_resident_gauge()


def note_invalidation(reason: str, n: int = 1) -> None:
    _INVALIDATE_CTR.inc({"reason": reason}, value=float(n))
    _count("delta_invalidations", n)


def _update_resident_gauge() -> None:
    total = 0
    for res in _SCAN_RESIDENCIES.values():
        total += res.resident_bytes()
    for res in _GROUP_RESIDENCIES.values():
        total += res.resident_bytes()
    _RESIDENT_GAUGE.set(float(total))


def operand_fingerprint(arrays: Sequence, skip: Sequence[int] = ()) -> str:
    """Content hash over the dispatch operands that must be byte-identical
    for a warm resume to be sound (everything except the pod stream). Takes
    HOST arrays: the caller hashes what it uploads, before the upload, so a
    warm pass copies nothing back from the card."""
    h = hashlib.blake2b(digest_size=16)
    skipset = set(skip)
    for i, a in enumerate(arrays):
        if i in skipset:
            continue
        arr = np.asarray(a)
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


# -- delta encode: the content/identity row cache -----------------------------


class EncodeCache:
    """Cross-pass cache for `packer.encode_pods_for_packer`: requirement
    shapes map to their interned row ids, membership row, and key-presence
    row. Object identity is the fast path (one Requirements per workload
    shape, the dedup contract the one-pass encode already relies on); the
    canonical content fingerprint (encoding.requirements_fingerprint) is
    the second level, so churn that rebuilds value-identical shapes every
    pass still reuses rows. Weak references keep the identity level from
    pinning dead workload shapes.

    `begin_pass`/`last_pass` meter bytes re-encoded per pass."""

    # content-map cap: past this the workload-shape universe is churning
    # faster than caching helps — reset and reseed
    MAX_SHAPES = 1 << 16

    def __init__(self):
        self._shapes: dict[int, tuple] = {}  # id -> (wref, rows, mrow, kp)
        # second level: canonical content fingerprint -> (rows, mrow, kp).
        # Identity misses land here, so churn that rebuilds value-identical
        # Requirements objects every pass (watch re-decodes) still reuses
        # the interned rows (encoding.requirements_fingerprint).
        self._by_content: dict[bytes, tuple] = {}
        self._pass_bytes = 0
        self._pass_hits = 0
        self._pass_misses = 0
        self.passes = 0

    def begin_pass(self) -> None:
        self.passes += 1
        self._pass_bytes = 0
        self._pass_hits = 0
        self._pass_misses = 0

    def end_pass(self) -> None:
        note_bytes_reencoded(self._pass_bytes)
        note_rows("reused", self._pass_hits)
        note_rows("encoded", self._pass_misses)

    @property
    def last_pass_bytes(self) -> int:
        return self._pass_bytes

    @property
    def last_pass_hits(self) -> int:
        return self._pass_hits

    @property
    def last_pass_misses(self) -> int:
        return self._pass_misses

    def lookup(self, engine, reqs, num_rows: int):
        """(row_ids, membership_row, kp_row) for one requirement shape.
        Two levels: object identity (free), then canonical content
        fingerprint — value-identical shapes rebuilt by watch churn reuse
        the same interned rows. Membership rows pad forward when the
        engine interns more rows — an old shape can never reference a row
        added after it encoded."""
        ent = self._shapes.get(id(reqs))
        if ent is not None and ent[0]() is reqs:
            rows, mrow, kp = ent[1], ent[2], ent[3]
            if mrow.shape[0] < num_rows:
                mrow = np.pad(mrow, (0, num_rows - mrow.shape[0]))
                self._shapes[id(reqs)] = (ent[0], rows, mrow, kp)
            self._pass_hits += 1
            return rows, mrow, kp
        from karpenter_tpu_torch.ops import encoding

        fp = encoding.requirements_fingerprint(reqs)
        cent = self._by_content.get(fp)
        if cent is not None:
            rows, mrow, kp = cent
            if mrow.shape[0] < num_rows:
                mrow = np.pad(mrow, (0, num_rows - mrow.shape[0]))
                self._by_content[fp] = (rows, mrow, kp)
            self._alias(reqs, rows, mrow, kp)
            self._pass_hits += 1
            return rows, mrow, kp
        rows = tuple(engine.rows_for(reqs))
        kp = engine.key_presence([reqs])[0]
        num_rows = max(num_rows, engine.num_rows)
        mrow = np.zeros(max(1, num_rows), dtype=bool)
        for rid in rows:
            mrow[rid] = True
        if len(self._by_content) >= self.MAX_SHAPES:
            self._by_content.clear()
            note_invalidation("encode-capacity")
        self._by_content[fp] = (rows, mrow, kp)
        self._alias(reqs, rows, mrow, kp)
        self._pass_misses += 1
        self._pass_bytes += mrow.nbytes + kp.nbytes + 8 * len(rows)
        return rows, mrow, kp

    def _alias(self, reqs, rows, mrow, kp) -> None:
        """Register the identity fast path for a shape object (weakly, so
        the cache never pins dead workload shapes)."""
        if len(self._shapes) >= self.MAX_SHAPES:
            dead = [k for k, e in self._shapes.items() if e[0]() is None]
            for k in dead:
                del self._shapes[k]
            if len(self._shapes) >= self.MAX_SHAPES:
                self._shapes.clear()
        try:
            wref = weakref.ref(reqs)
        except TypeError:  # plain objects without weakref support
            wref = lambda r=reqs: r  # noqa: E731 — strong fallback
        self._shapes[id(reqs)] = (wref, rows, mrow, kp)

    def clear(self) -> None:
        self._shapes.clear()
        self._by_content.clear()

    def stats(self) -> dict:
        return {
            "shapes_cached": len(self._by_content),
            "passes": self.passes,
            "last_pass_bytes": self._pass_bytes,
            "last_pass_hits": self._pass_hits,
            "last_pass_misses": self._pass_misses,
        }


# -- warm group solves: resident solve_block core results ---------------------

# Slot cap: past this the fingerprint universe is churning shapes faster
# than residency helps — reset and reseed (metered).
MAX_GROUP_SLOTS = 1 << 14


class GroupResidency:
    """Card-resident per-group core results for GroupSolver, keyed by
    group content fingerprint and stamped by the engine row generation.
    The resident matrix holds ONLY count-independent outputs (choice,
    feasible, pods-per-node): group count changes — pods joining/leaving
    an existing shape, the dominant churn — touch no resident slot."""

    def __init__(self):
        self.core: Optional[torch.Tensor] = None  # [cap, 3] int32 on the engine's device
        # one int32 on the same device: the block count of this residency's
        # one-launch passes (packer.delta_pass), never shared with another
        self.counter: Optional[torch.Tensor] = None
        self.cap = 0
        self.slot_of: dict[bytes, int] = {}
        self.gen = None
        self.passes = 0
        self.warm_passes = 0
        self.last_mode = ""

    def resident_bytes(self) -> int:
        return 0 if self.core is None else int(self.cap * 3 * 4)

    def invalidate(self, reason: str, _registry_sweep: bool = False) -> int:
        had = 1 if self.core is not None else 0
        self.core = None
        self.counter = None
        self.cap = 0
        self.slot_of.clear()
        self.gen = None
        self.warm_passes = 0
        if had and not _registry_sweep:
            note_invalidation(reason)
            _update_resident_gauge()
        return had

    @staticmethod
    def fingerprints(grouped) -> list[bytes]:
        """Each group's content key: blake2b over its membership, requests_q
        and key_present bytes, hashed as one row of their concatenation
        (the same digest as three updates; one call a group, on a slice of
        one buffer)."""
        rows = np.concatenate([
            np.ascontiguousarray(a).view(np.uint8)
            for a in (grouped.membership, grouped.requests_q, grouped.key_present)
        ], axis=1)
        G, w = rows.shape
        buf = memoryview(rows.tobytes())
        return [hashlib.blake2b(buf[g * w:(g + 1) * w], digest_size=16).digest() for g in range(G)]

    def solve(self, solver, grouped):
        """The delta group solve: frontier-only core solves scattered in
        place into residency and the pass's counts finalize, one launch
        (packer.delta_pass) after one upload; a pass without a frontier is
        the finalize alone (packer.delta_finalize). Bit-identical to
        solver._solve_full by construction (same math on the same inputs;
        the periodic self-check enforces it anyway). Each launch is a named
        dispatch (tracing/kernel.dispatch): the pass as `packer.delta_pass`,
        one dispatch where the reference makes three
        (`packer.solve_block_core`, `packer.delta_scatter`,
        `packer.delta_finalize`), the finalize alone as
        `packer.delta_finalize`."""
        from karpenter_tpu_torch.device import device_work
        from karpenter_tpu_torch.ops import packer
        from karpenter_tpu_torch.tracing import kernel as ktime

        e = solver.engine
        dev = e.device
        e._ensure_rows()
        gen = (e._computed_rows, e.num_instances, e.num_offerings)
        if self.gen is not None and self.gen != gen:
            self.invalidate("generation")
        self.gen = gen
        self.passes += 1

        fps = self.fingerprints(grouped)
        G = len(fps)
        missing = [g for g, fp in enumerate(fps) if fp not in self.slot_of]
        if len(self.slot_of) + len(missing) > MAX_GROUP_SLOTS:
            self.invalidate("capacity")
            self.gen = gen
            missing = list(range(G))

        with device_work("delta group solve"):
            # grow the resident matrix (pow2) before any scatter targets it
            need = len(self.slot_of) + len(missing)
            if need > self.cap:
                new_cap = max(64, 1 << max(0, (need - 1).bit_length()))
                grown = torch.zeros((new_cap, 3), dtype=torch.int32, device=dev)
                if self.core is not None and self.cap:
                    grown[: self.cap] = self.core
                self.core = grown
                self.cap = new_cap
            if self.counter is None:
                self.counter = torch.zeros(1, dtype=torch.int32, device=dev)

            mode = "warm" if len(missing) < G else "cold"
            if missing:
                # distinct group IDENTITIES can carry identical content (the
                # encode dedupes Requirements by object identity) — assign one
                # slot per content fingerprint and solve each fingerprint once
                frontier = []
                for g in missing:
                    if fps[g] not in self.slot_of:
                        self.slot_of[fps[g]] = len(self.slot_of)
                        frontier.append(g)
                missing = frontier
            # this pass's group order and counts, padded to the solve_block
            # rung
            order = np.array([self.slot_of[fp] for fp in fps], np.int32)
            counts = grouped.counts.astype(np.int32)
            Gb = _bucket_groups(e, G)
            if Gb > G:
                order = np.pad(order, (0, Gb - G), mode="edge")
                counts = np.pad(counts, (0, Gb - G))
            if missing:
                slots = np.array([self.slot_of[fps[g]] for g in missing], np.int32)
                group_bools, group_ints = packer._pack_groups(grouped)
                sub_bools = group_bools[missing]
                sub_ints = group_ints[missing]
                # pad the frontier to the solve_block geometry (pow2, floor 8)
                Gf = len(missing)
                Gfb = _bucket_groups(e, Gf)
                if Gfb > Gf:
                    pad = Gfb - Gf
                    # EDGE padding on inputs AND slots: the pad rows solve to
                    # the exact values of the last real group, so the
                    # scatter's duplicate writes to its slot are same-value
                    # collisions — well-defined no-ops
                    sub_bools = np.pad(sub_bools, ((0, pad), (0, 0)), mode="edge")
                    sub_ints = np.pad(sub_ints, ((0, pad), (0, 0)), mode="edge")
                    slots = np.pad(slots, (0, pad), mode="edge")
                # one upload; one launch solves the frontier's core rows into
                # their slots and finalizes the pass (B10 + B11 + B12)
                sl, gi, od, ct, gb = _upload_pass((slots, sub_ints, order, counts), sub_bools, dev)
                counter = self.counter
                out = ktime.dispatch(
                    lambda *a: packer.delta_pass(*a, counter=counter),
                    self.core, sl, gb, gi, od, ct, *solver._catalog_args(),
                    kernel="packer.delta_pass",
                )
            else:
                # no frontier: the gather and finalize alone (B12)
                od, ct = _upload_pass((order, counts), None, dev)
                out = ktime.dispatch(
                    packer.delta_finalize, self.core, od, ct,
                    kernel="packer.delta_finalize",
                )
            note_groups("solved", len(missing))
            note_groups("reused", G - len(missing))
            out = _download(out)[:G]
        self.last_mode = mode
        if mode == "warm":
            self.warm_passes += 1
        note_pass(mode)
        _update_resident_gauge()
        result = (out[:, 0], out[:, 1].astype(bool), out[:, 2], out[:, 3])

        # periodic from-scratch self-check: decision identity or drop
        if (
            RESOLVE_FULL_EVERY > 0
            and mode == "warm"
            and self.warm_passes % RESOLVE_FULL_EVERY == 0
        ):
            note_pass("warm-check")
            full = solver._solve_full(grouped)
            if all(np.array_equal(a, b) for a, b in zip(result, full)):
                note_selfcheck("identical")
            else:
                _emit_divergence(
                    "packer.solve_block",
                    f"delta group solve diverged from full re-solve at "
                    f"pass {self.passes} (G={G})",
                )
                self.invalidate("selfcheck-divergence")
                return full
        return result

    def stats(self) -> dict:
        return {
            "slots": len(self.slot_of),
            "capacity": self.cap,
            "passes": self.passes,
            "warm_passes": self.warm_passes,
            "last_mode": self.last_mode,
            "resident_bytes": self.resident_bytes(),
        }


def _upload_pass(ints: Sequence[np.ndarray], bools: Optional[np.ndarray], dev) -> tuple:
    """A group pass's operands on `dev` in one plain copy: the int32 arrays
    `ints` one after the other in one buffer, then the bool rows `bools`
    (None: none); returned as views of the upload, in that order, each in
    its own shape."""
    ints = [np.asarray(a, dtype=np.int32) for a in ints]
    n_int = sum(a.size for a in ints)
    n_bool = 0 if bools is None else bools.size
    host = np.empty(4 * n_int + n_bool, dtype=np.uint8)
    flat = host[: 4 * n_int].view(np.int32)
    at = 0
    for a in ints:
        flat[at:at + a.size] = a.ravel()
        at += a.size
    if bools is not None:
        host[4 * n_int:] = bools.reshape(-1).view(np.uint8)
    buf = torch.from_numpy(host).to(dev)
    words = buf[: 4 * n_int].view(torch.int32)
    out, at = [], 0
    for a in ints:
        out.append(words[at:at + a.size].view(a.shape))
        at += a.size
    if bools is not None:
        out.append(buf[4 * n_int:].view(torch.bool).view(bools.shape))
    return tuple(out)


def _download(t: torch.Tensor) -> np.ndarray:
    """A pass's [Gb, 4] result to the host (the pass's one copy back)."""
    return t.cpu().numpy()


def _bucket_groups(engine, g: int) -> int:
    """Pad a group axis to the solve_block ladder rung (pow2 floor 8 when
    no ladder is attached) — delta kernels share solve_block's geometry so
    the steady-state executable universe stays sealed."""
    ladder = getattr(engine, "aot_ladder", None)
    if ladder is not None:
        bucket = ladder.bucket_for("packer.solve_block", (g,))
        if bucket is not None:
            return int(bucket[0])
    return max(8, 1 << max(0, (int(g) - 1).bit_length()))


# -- warm scan residency: the fused one-dispatch state ------------------------


class ScanResidency:
    """Per-engine residency of the fused FFD scan's full loop-carried
    state. `eligibility` enforces the strict resume contract (see the
    module docstring); `commit` records the post-dispatch state as the
    next pass's warm start. The state tuple (packer.SCAN_STATE_FIELDS:
    `scal` and 16 tensors) is what `packer.solve_scan_resume` writes in
    place — after a warm dispatch the same tensors hold the new state."""

    def __init__(self):
        self.state = None  # packer.SCAN_STATE_FIELDS tensors on the engine's device
        # with a mesh: every shard's state, in shard order (state is the
        # first); empty without one
        self.replicas: tuple = ()
        self.cfg = None  # (T, has_nodes, has_limits)
        self.shape_key = None  # tuple of operand shapes
        self.ops_fp = None  # operand content hash (pods excluded)
        self.pod_gi = None  # np [Pb] — previous pass's padded pod stream
        self.p_real = 0
        self.extendable = False
        self.warm_passes = 0
        self.passes = 0
        self.last_outcome = ""

    def replica_states(self) -> tuple:
        """The resident state of every replica: one without a mesh."""
        if self.state is None:
            return ()
        return self.replicas or (self.state,)

    def resident_bytes(self) -> int:
        return sum(
            int(t.numel()) * int(t.element_size()) for st in self.replica_states() for t in st
        )

    def invalidate(self, reason: str, _registry_sweep: bool = False) -> int:
        had = 1 if self.state is not None else 0
        self.state = None
        self.replicas = ()
        self.cfg = None
        self.shape_key = None
        self.ops_fp = None
        self.pod_gi = None
        self.p_real = 0
        self.extendable = False
        self.warm_passes = 0
        if had and not _registry_sweep:
            note_invalidation(reason)
            _update_resident_gauge()
        return had

    def eligibility(self, cfg, shape_key, ops_fp, pod_gi, p_real) -> str:
        """"" when a warm resume is sound; else the miss reason."""
        if self.state is None:
            return "cold"
        if self.cfg != cfg or self.shape_key != shape_key:
            return "rung"
        if not self.extendable:
            return "failures"
        if self.ops_fp != ops_fp:
            return "operands"
        if p_real < self.p_real:
            return "prefix"
        if not np.array_equal(pod_gi[: self.p_real], self.pod_gi[: self.p_real]):
            return "prefix"
        return ""

    def commit(
        self, state, cfg, shape_key, ops_fp, pod_gi, p_real, extendable, replicas=()
    ) -> None:
        self.state = tuple(state)
        self.replicas = tuple(tuple(r) for r in replicas)
        self.cfg = cfg
        self.shape_key = shape_key
        self.ops_fp = ops_fp
        self.pod_gi = np.array(pod_gi, copy=True)
        self.p_real = int(p_real)
        self.extendable = bool(extendable)
        self.passes += 1
        _update_resident_gauge()

    def stats(self) -> dict:
        return {
            "resident": self.state is not None,
            "p_real": self.p_real,
            "extendable": self.extendable,
            "passes": self.passes,
            "warm_passes": self.warm_passes,
            "last_outcome": self.last_outcome,
            "resident_bytes": self.resident_bytes(),
        }


# -- debug surface ------------------------------------------------------------


def debug_view() -> dict:
    """Config, counters, and per-residency state — the steady-state
    drill-down for 'why is my pass still slow'."""
    return {
        "mode": DELTA_MODE,
        "enabled": delta_enabled(),
        "resolve_full_every": RESOLVE_FULL_EVERY,
        "counters": delta_counters(),
        "scan_residencies": [r.stats() for r in _SCAN_RESIDENCIES.values()],
        "group_residencies": [r.stats() for r in _GROUP_RESIDENCIES.values()],
        "resident_bytes": sum(
            r.resident_bytes() for r in _SCAN_RESIDENCIES.values()
        )
        + sum(r.resident_bytes() for r in _GROUP_RESIDENCIES.values()),
    }
