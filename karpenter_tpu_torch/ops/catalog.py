"""CatalogEngine: the card-resident instance-type catalog and the lazily
grown requirement-compatibility matrices.

This is the batched execution backend for the reference's
`filterInstanceTypesByRequirements` (scheduling/nodeclaim.go:373-441): a
NodeClaim's instance-type filter becomes

    feasible[p, i] = compat[p, i] & fits[p, i] & has_offering[p, i]

where `compat` is an AND over the pod/nodeclaim's distinct Requirement rows
(computed once per row via `req_rows_vs_sets` and cached), `fits` is a
resource-vector comparison against allocatable, and `has_offering` reduces
offering-level compatibility over each instance type's offerings.

The engine lives on one torch device. On a CUDA engine every row batch and
every sweep launches the hand-written kernels (ops/feasibility.py) unless a
pin below routes it; on a `device="cpu"` engine the same calls run their
plain torch versions, or the host twins where the cost model below sends
them. All are exact, so the
results are identical. The per-row compat matrices stay resident on the
device, where each sweep reads the rows it uses in place, by index
(`feasibility.cube_rows`); a host copy serves the per-set `masks_for_rows`
and the host twins. On the card a row batch is one upload (its row table),
one kt_row_compat launch against the types and the offerings, two appends
and one copy back; a sweep is two uploads (the entity rows, the row ids),
one kt_cube launch and one copy back. The resource `fits` test stays
host-side in numpy (float64). A failure of the device work is a
KernelError (device.device_work).

Every launch goes through the kernel observatory's choke point
(tracing/kernel.dispatch) under the reference's names: a row batch as
`catalog.row_compat` (one dispatch for the types and the offerings; the
reference dispatches its kernel once for each), a sweep as
`feasibility.cube`, a mesh sweep as `feasibility.cube_sharded` and a
catalog without offerings as `feasibility.membership`.

The reference's host route is ported with its decisions: `_use_device`
weighs a batch's host cost (cells over the reference's host rates)
against the engine device's measured round trip (`device_rtt_s`, one
probe per torch device), before any padding. A row batch under
`DEVICE_MIN_ROW_BATCH` rows, or too small to pay the trip, runs the numpy
twin `feasibility.req_rows_vs_sets_np`; a sweep too small runs
`membership_all_np` and `offering_reduce_np`. Each host run is counted
with `record_host` under the kernel's name and the shape the reference
records. A host row batch's rows still reach the resident device
matrices, by one upload and an append (no launch). The model routes a
CPU engine, and a CUDA engine only under a pin: `FORCE_BACKEND` pins the
route, `PINNED_RTT` the round trip (the simulator pins 100 us, so that
both packages route every batch alike). Unpinned, a CUDA engine keeps
every batch on the card (`_card_keeps_work`). A probe that fails is a
KernelError, never a reason to take the host route.

With an AOT ladder attached (`aot_ladder`, set by aot/compiler.warm_start)
a row batch pads to its `catalog.row_compat` rung and a sweep's (P, R) to
its `feasibility.cube` (`_sharded`, `membership`) rung, as the reference's
device dispatches do; past the largest rung it keeps the power-of-two
padding and counts the dispatch off-ladder (aot/runtime.note_off_ladder).
A dispatch's shape signature is its bucket's and the catalog's: the sweep
passes its used row ids and the resident row matrices it reads by index as
one tuple (`_cube`), which the signature leaves out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch import mesh as mesh_mod
from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.aot import runtime as aotrt
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.device import device_work, resolve_device
from karpenter_tpu_torch.observability import kernels as kobs
from karpenter_tpu_torch.ops import delta as delta_mod
from karpenter_tpu_torch.ops import encoding as enc
from karpenter_tpu_torch.ops import feasibility as feas
from karpenter_tpu_torch.tracing import kernel as ktime
from karpenter_tpu_torch.scheduling.requirements import Operator, Requirement, Requirements

DEFAULT_RESOURCE_DIMS = (
    wk.RESOURCE_CPU,
    wk.RESOURCE_MEMORY,
    wk.RESOURCE_EPHEMERAL_STORAGE,
    wk.RESOURCE_PODS,
)


def _row_compat(rows, slot_key, value_int, *sets):
    """`catalog.row_compat`'s dispatch: a row table against the target sets
    (six operands a set: the types', then the offerings'), one launch."""
    targets = [sets[i:i + 6] for i in range(0, len(sets), 6)]
    return feas.req_rows_vs_targets(rows, targets, slot_key, value_int)


def _cube(membership, key_present, rows, custom_need, available, owner):
    """`feasibility.cube`'s dispatch: `rows` is (the used row ids, the
    resident req and offer compat matrices), read by index."""
    ids, req_compat, offer_compat = rows
    return feas.cube_rows(
        membership, key_present, ids, req_compat, offer_compat, custom_need, available, owner
    )


def _req_cache_key(r: Requirement) -> tuple:
    # min_values never affects compat masks, but interned rows feed the
    # solver's canonical requirement families (ops/ffd.py fam_reqs) and the
    # emitted claim requirements — conflating rows that differ only in
    # minValues would stamp one template's minValues onto another's claims.
    return (r.key, r.complement, r.greater_than, r.less_than, frozenset(r.values), r.min_values)


# port: keyed by the engine's torch device, not a process-wide backend: a CPU
# engine and a CUDA engine can share one process
_RTT_CACHE: dict[torch.device, float] = {}

# Deterministic-routing override: when set, device_rtt_s returns this value
# instead of measuring, so the host-vs-device dispatch decision becomes a
# pure function of cube sizes. The simulator pins it (sim/harness.py) so
# same-seed runs — and CI runs on different machines — route identically
# and report["kernels"] dispatch counts stay byte-deterministic.
PINNED_RTT: Optional[float] = None


def device_rtt_s(device) -> float:
    """Measured round-trip latency of one tiny dispatch+fetch on `device`,
    cached per device and process.

    port: the probe is the port's own dispatch pattern in miniature: eight
    floats uploaded, one op on the device, the result copied back; once to
    warm, then timed. Its failure is a KernelError (device.device_work) and
    is not cached: a broken device fails the batch, it never sends the work
    to the host twins. The card's measured figure is in PERF.md (phase 4h
    of chip_smoke.py).
    """
    if PINNED_RTT is not None:
        return PINNED_RTT
    device = torch.device(device)
    rtt = _RTT_CACHE.get(device)
    if rtt is None:
        import time as _time

        with device_work("rtt probe"):
            host = torch.ones((8,), dtype=torch.float32)
            (host.to(device) + 1).cpu()  # warm
            host = torch.full((8,), 2.0, dtype=torch.float32)
            t0 = _time.perf_counter()
            (host.to(device) + 1).cpu()
            rtt = _time.perf_counter() - t0
        _RTT_CACHE[device] = rtt
    return rtt


# Host-twin throughput estimates (cells/second), deliberately conservative so
# the device keeps the large cubes. Calibrated on one x86 core with float32
# BLAS for the membership matmuls.
_HOST_MATMUL_CELLS_PER_S = 2.0e9
_HOST_ROW_CELLS_PER_S = 0.5e9

# "device" / "host" pin the dispatch for tests and benchmarks; None = adaptive.
FORCE_BACKEND: Optional[str] = None

# Row batches below this stay on the exact numpy twin REGARDLESS of the RTT
# cost model. The row kernel's inputs are unpadded — the row count and the
# set tables' word capacity vary — so small steady-state dispatches (joint
# requirement rows interned a few per claim family) would compile a fresh
# executable per novel shape, violating the kernel observatory's
# zero-recompile steady-state contract for a ~ms win. Only bulk encodes
# (catalog bootstrap) amortize a compile.
DEVICE_MIN_ROW_BATCH = 32


def _card_keeps_work(device) -> bool:
    """port: an unpinned CUDA engine keeps every row batch and every sweep
    on the card, whatever their size. DEVICE_MIN_ROW_BATCH's reason, a
    compile per novel shape, is the reference's: the port's kernels are
    built once, not per shape, and the card beats the twins at the main
    path's shapes (PERF.md, phase 4h of chip_smoke.py). The cost model, the
    row gate included, routes a CPU engine, and a CUDA one under
    FORCE_BACKEND or PINNED_RTT (the simulator's pin)."""
    return FORCE_BACKEND is None and PINNED_RTT is None and torch.device(device).type == "cuda"


def _use_device(host_cells: float, cells_per_s: float, device) -> bool:
    # port: `device`, the engine's, whose round trip is weighed
    if FORCE_BACKEND == "device" or _card_keeps_work(device):
        return True
    if FORCE_BACKEND == "host":
        return False
    return host_cells / cells_per_s > device_rtt_s(device)


@dataclass
class Feasibility:
    """Per-(entity, instance-type) feasibility triple plus diagnostics."""

    compat: np.ndarray  # [P, I] bool — requirements intersect
    fits: np.ndarray  # [P, I] bool — resources fit allocatable
    has_offering: np.ndarray  # [P, I] bool — an available offering is compatible

    @property
    def feasible(self) -> np.ndarray:
        return self.compat & self.fits & self.has_offering


class CatalogEngine:
    """Encodes an instance-type catalog onto the device and evaluates batched
    feasibility queries against it.

    Requirement rows are deduplicated: each distinct Requirement is one row
    of the cached `ReqCompat[R, I]` / `OfferCompat[R, O]` matrices, computed
    on first use. Queries supply sets of row ids (per pod / nodeclaim), and
    compatibility is an AND-reduce over rows.

    `device=None` is the current CUDA device and raises when CUDA is absent;
    `device="cpu"` runs the plain torch versions of the kernels.

    With a `mesh` (karpenter_tpu_torch.mesh), the production sweep, the
    group solver and the fused scan run sharded over its devices
    (feasibility.sharded_cube, packer.sharded_solve_block,
    packer.sharded_solve_scan*); row batches and the rest stay on
    `device`, which must be of the mesh's device type.
    """

    def __init__(
        self,
        instance_types: Sequence[InstanceType],
        extra_resources: Sequence[str] = (),
        vocab: Optional[enc.Vocab] = None,
        device=None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        if mesh is not None and mesh.devices[0].type != self.device.type:
            raise ValueError(f"a mesh of {mesh.devices[0].type} devices for an engine on {self.device}")
        self.mesh = mesh
        self.instance_types = list(instance_types)
        self.vocab = vocab or enc.Vocab()

        names = list(DEFAULT_RESOURCE_DIMS)
        for it in self.instance_types:
            for k in it.capacity:
                if k not in names:
                    names.append(k)
        for k in extra_resources:
            if k not in names:
                names.append(k)
        self.resource_dims = {n: i for i, n in enumerate(names)}

        # Flatten offerings with owner pointers — owner-major, which the
        # cube's offering kernel relies on (offerings of one type contiguous)
        self._offerings = []
        owners = []
        for i, it in enumerate(self.instance_types):
            for o in it.offerings:
                self._offerings.append(o)
                owners.append(i)
        self.num_instances = len(self.instance_types)
        self.num_offerings = len(self._offerings)

        # Pre-intern all catalog vocab before sizing arrays
        for it in self.instance_types:
            self.vocab.observe(it.requirements)
        for o in self._offerings:
            self.vocab.observe(o.requirements)

        self._encode_catalog(owners)

        # Requirement-row cache
        self._row_ids: dict[tuple, int] = {}
        self._rows: list[Requirement] = []
        self._computed_rows = 0
        self._req_compat = np.zeros((0, self.num_instances), dtype=bool)
        self._offer_compat = np.zeros((0, self.num_offerings), dtype=bool)
        # the same matrices resident on the device, for the sweeps
        self._req_compat_d = torch.zeros((0, self.num_instances), dtype=torch.bool, device=self.device)
        self._offer_compat_d = torch.zeros((0, self.num_offerings), dtype=torch.bool, device=self.device)
        self._row_trivial = np.zeros(0, dtype=bool)
        # Cross-solve caches for the FFD driver (ops/ffd.py): steady-state
        # provisioner passes re-solve near-identical batches, and these are
        # pure functions of requirement CONTENT (row-id frozensets are
        # interned per engine). joint-mask cache: rowset -> (compat, offer)
        # masks; family-transition cache: (claim rowset, group rowset) ->
        # (kind, joint rowset, canonical joint Requirements). The joint
        # Requirements are shared read-only — driver callers always copy.
        self.solver_joint_cache: dict[frozenset, Optional[tuple]] = {}
        self.solver_fam_trans: dict[tuple, tuple] = {}
        # AOT bucket ladder (aot/ladder.py), attached by aot.warm_start:
        # when set, device dispatches pad their variable axes to ladder
        # buckets so they hit the prepaid executables; None = plain
        # power-of-two padding (the pre-AOT behavior)
        self.aot_ladder = None

    # -- catalog encoding ---------------------------------------------------

    def _encode_catalog(self, owners: list[int]) -> None:
        v = self.vocab
        self._key_capacity = v.key_capacity
        self._word_capacity = v.word_capacity
        self._inst_sets = enc.encode_requirement_sets(
            v,
            [it.requirements for it in self.instance_types],
            key_capacity=self._key_capacity,
            word_capacity=self._word_capacity,
        )
        self._offer_sets = enc.encode_requirement_sets(
            v,
            [o.requirements for o in self._offerings],
            key_capacity=self._key_capacity,
            word_capacity=self._word_capacity,
        )
        self._tables = v.tables()
        self._tables_version = v.version
        # device copies of catalog state, uploaded once per (re)encode
        self._device_cache: dict[str, torch.Tensor] = {}

        # float64 so byte-scale memory comparisons match the host oracle
        # exactly (float32 loses ~512B at 8GiB).
        self.allocatable = enc.encode_resource_lists(
            self.resource_dims, [it.allocatable() for it in self.instance_types]
        )
        # Raw capacity for nodepool-limit filtering and pessimistic
        # subtract-max tracking (scheduler.go:670-686 uses it.capacity).
        self.capacity = enc.encode_resource_lists(
            self.resource_dims, [it.capacity for it in self.instance_types]
        )
        self.offering_available = np.array(
            [o.available for o in self._offerings], dtype=bool
        )
        self.offering_price = np.array(
            [o.price for o in self._offerings], dtype=np.float32
        )
        self.offering_owner = np.array(owners, dtype=np.int32)
        if np.any(np.diff(self.offering_owner) < 0):
            raise ValueError("offerings must be stored owner-major")

        # Offering custom-key needs for the Compatible() undefined-label rule
        # (requirements.go:175-191): a non-well-known offering key with an
        # In/Exists-class operator requires the querying set to define it.
        K = self._key_capacity
        self.offering_custom_need = np.zeros((self.num_offerings, K), dtype=bool)
        for j, o in enumerate(self._offerings):
            for r in o.requirements:
                if r.key in wk.WELL_KNOWN_LABELS:
                    continue
                if r.operator in (Operator.NOT_IN, Operator.DOES_NOT_EXIST):
                    continue
                self.offering_custom_need[j, v.key_id(r.key)] = True

    # -- requirement rows ---------------------------------------------------

    def row_id(self, req: Requirement) -> int:
        key = _req_cache_key(req)
        rid = self._row_ids.get(key)
        if rid is None:
            rid = len(self._rows)
            self._row_ids[key] = rid
            self._rows.append(req)
        return rid

    def rows_for(self, reqs: Requirements) -> list[int]:
        return [self.row_id(r) for r in reqs]

    @property
    def num_rows(self) -> int:
        return len(self._rows)

    def value_matrix(self, key: str) -> np.ndarray:
        """[n_values, I] bool — value-membership of each instance type's own
        declared requirement for `key` (types not defining the key contribute
        no values). Feeds the solver's minValues distinct-value counting
        (types.go:190-224: counts union the type-DECLARED values, not the
        query-narrowed ones). Cached per key for the engine's lifetime — the
        catalog is immutable."""
        cache = getattr(self, "_value_matrices", None)
        if cache is None:
            cache = self._value_matrices = {}
        M = cache.get(key)
        if M is None:
            vals: dict[str, int] = {}
            cols: list[tuple[int, int]] = []
            for i, it in enumerate(self.instance_types):
                row = it.requirements.get(key)
                for v in row.values:
                    vi = vals.setdefault(v, len(vals))
                    cols.append((vi, i))
            M = np.zeros((len(vals), self.num_instances), dtype=bool)
            for vi, i in cols:
                M[vi, i] = True
            cache[key] = M
        return M

    def _maybe_reencode(self) -> None:
        """Re-encode the catalog if the vocabulary outgrew the padded
        capacities (rare — capacities grow pow2). Previously computed compat
        matrices remain valid: compatibility depends only on requirement
        semantics, not slot numbering."""
        if (
            self.vocab.key_capacity > self._key_capacity
            or self.vocab.word_capacity > self._word_capacity
        ):
            self._encode_catalog(list(self.offering_owner))

    def _dev(self, name: str, host_array: np.ndarray) -> torch.Tensor:
        """Device-resident copy of a catalog array, uploaded once per
        (re)encode instead of on every query. uint32 mask words travel as
        int32 with the same bits."""
        t = self._device_cache.get(name)
        if t is None:
            t = self._to_device(host_array)
            self._device_cache[name] = t
        return t

    def _mesh_dev(self, name: str, host_array: np.ndarray) -> tuple:
        """One copy of a catalog array per mesh shard (the same tensor for
        shards on a repeated device), uploaded once per (re)encode like
        `_dev`."""
        key = f"mesh:{name}"
        copies = self._device_cache.get(key)
        if copies is None:
            copies = mesh_mod.replicate(torch.from_numpy(self._host_words(host_array)), self.mesh)
            self._device_cache[key] = copies
        return copies

    @staticmethod
    def _host_words(host_array: np.ndarray) -> np.ndarray:
        host_array = np.ascontiguousarray(host_array)
        if host_array.dtype == np.uint32:
            host_array = host_array.view(np.int32)  # same bits
        return host_array

    def _to_device(self, host_array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(self._host_words(host_array)).to(self.device)

    def _set_args(self, prefix: str, sets: enc.EncodedReqSets) -> tuple:
        return tuple(
            self._dev(f"{prefix}.{field}", getattr(sets, field))
            for field in ("present", "complement", "has_values", "gt", "lt", "mask")
        )

    def _ensure_rows(self) -> None:
        """Compute compat matrices for any rows added since the last call.
        Batches whose estimated host cost exceeds the measured device RTT run
        on device; incremental joint rows use the exact numpy twin.

        port: on the device the batch's row table is uploaded in one copy,
        one row_compat launch runs against the types and the offerings
        together, its two column ranges are appended to the resident
        matrices and copied back once. On the host the twin runs for each
        target set, and its rows are uploaded in one copy and appended to
        the resident matrices, which every sweep on the device reads. An
        unpinned CUDA engine runs every batch on the device
        (`_card_keeps_work`)."""
        if self._computed_rows == len(self._rows):
            return
        new_rows = self._rows[self._computed_rows :]
        # Interning new rows may grow the vocabulary past the encoded
        # capacities; encode_requirement_rows interns first, then we re-size.
        er = enc.encode_requirement_rows(self.vocab, new_rows, None)
        self._maybe_reencode()
        # New slots may have been interned without outgrowing the padded
        # capacities; the per-slot tables must still reflect them.
        if self.vocab.version != self._tables_version:
            self._tables = self.vocab.tables()
            self._tables_version = self.vocab.version
            self._device_cache.pop("slot_key", None)
            self._device_cache.pop("value_int", None)
        if er.mask.shape[1] < self._word_capacity:
            pad = self._word_capacity - er.mask.shape[1]
            er.mask = np.pad(er.mask, ((0, 0), (0, pad)))

        # row kernel work ~ R * (I + O) * G slot-cells on host
        slots = self._word_capacity * 32  # G = word_capacity * WORD value slots
        host_cells = (
            len(new_rows) * (self.num_instances + self.num_offerings) * max(slots, 1)
        )
        # FORCE_BACKEND="device" (the test/bench pin) must still reach the
        # device row kernel for small batches — only adaptive routing gates
        # on the batch size.
        #
        # The reference's delta-warm exception: with delta solves on and a
        # device copy of the compat matrices resident, a small batch takes
        # the device kernel so that its rows can be appended there.
        # port: the same question of the same cache. The reference's cache
        # gains "req_compat" only inside this exception, so it never holds
        # it and the exception never fires; the port's never holds it
        # either (its resident matrices are `_req_compat_d` /
        # `_offer_compat_d`, appended on every batch), so both route alike.
        delta_warm = (
            delta_mod.delta_enabled()
            and FORCE_BACKEND != "host"
            and self.mesh is None
            and "req_compat" in self._device_cache
        )
        on_device = (
            (len(new_rows) >= DEVICE_MIN_ROW_BATCH or FORCE_BACKEND == "device"
             or _card_keeps_work(self.device))  # port: the unpinned card
            and _use_device(host_cells, _HOST_ROW_CELLS_PER_S, self.device)
        ) or delta_warm
        if on_device:
            new = self._row_compat_device(er, len(new_rows))
        else:
            kobs.registry().record_host(
                "catalog.row_compat",
                f"{len(new_rows)}r,{self.num_instances}i,{self.num_offerings}o",
            )
            new = self._row_compat_host(er)
        I = self.num_instances
        new_inst, new_off = new[:, :I], new[:, I:]
        if delta_warm:
            delta_mod.note_rows("device_appended", len(new_rows))
        self._req_compat = np.concatenate([self._req_compat, new_inst], axis=0)
        self._offer_compat = np.concatenate([self._offer_compat, new_off], axis=0)
        # Rows that constrain NO catalog entry (all-True columns) are
        # identity elements of the AND-reduce; queries prune them so the
        # sweep's row axis stays tiny.
        self._row_trivial = np.concatenate(
            [self._row_trivial, new_inst.all(axis=1) & new_off.all(axis=1)]
        )
        self._computed_rows = len(self._rows)

    def _row_compat_device(self, er: enc.EncodedReqs, n: int) -> np.ndarray:
        """A row batch on the device: [n, I + O] bool, its rows appended to
        the resident matrices."""
        I = self.num_instances
        # the batch as one int32 row table, built on the host: one upload
        rows = feas.row_table(er.key, er.complement, er.has_values, er.gt, er.lt, er.mask)
        # pad the row batch up to its AOT ladder bucket (results for the
        # padding rows are sliced off below): bulk encodes then dispatch
        # the warm-started executable
        if self.aot_ladder is not None:
            bucket = self.aot_ladder.bucket_for("catalog.row_compat", (n,))
            if bucket is None:
                # pow2-normalized shape key: bounded warning/event
                # cardinality when many distinct batch sizes overflow
                # the ladder
                aotrt.note_off_ladder(
                    "catalog.row_compat", str(1 << max(0, (n - 1).bit_length()))
                )
            elif bucket[0] > n:
                # edge-replicate the last row: a valid row whose
                # (discarded) results cost nothing extra semantically
                rows = np.pad(rows, ((0, bucket[0] - n), (0, 0)), mode="edge")
        with device_work("row_compat"):
            sets = self._set_args("inst", self._inst_sets)
            if self.num_offerings:
                sets += self._set_args("offer", self._offer_sets)
            new_d = ktime.dispatch(
                _row_compat,
                self._to_device(rows),
                self._dev("slot_key", self._tables.slot_key),
                self._dev("value_int", self._tables.value_int),
                *sets,
                kernel="catalog.row_compat",
            )[:n]
            # the fresh rows are appended to the resident device matrices —
            # an O(churn) row batch per pass, never a re-upload of the
            # catalog
            self._append_resident(new_d)
            return new_d.cpu().numpy()

    def _row_compat_host(self, er: enc.EncodedReqs) -> np.ndarray:
        """A row batch through the numpy twin, once for each target set as
        the reference runs it: [n, I + O] bool, uploaded in one copy and
        appended to the resident matrices (no launch, no named dispatch)."""
        row_args = (er.key, er.complement, er.has_values, er.gt, er.lt, er.mask)
        tables = (self._tables.slot_key, self._tables.value_int)
        parts = []
        for sets in (self._inst_sets, self._offer_sets) if self.num_offerings else (self._inst_sets,):
            parts.append(feas.req_rows_vs_sets_np(
                *row_args, sets.present, sets.complement, sets.has_values, sets.gt, sets.lt,
                sets.mask, *tables,
            ))
        if not self.num_offerings:
            parts.append(np.zeros((len(er), 0), dtype=bool))
        new = np.concatenate(parts, axis=1)
        with device_work("row_compat"):
            self._append_resident(self._to_device(new))
        return new

    def _append_resident(self, new_d: torch.Tensor) -> None:
        I = self.num_instances
        self._req_compat_d = torch.cat([self._req_compat_d, new_d[:, :I]])
        self._offer_compat_d = torch.cat([self._offer_compat_d, new_d[:, I:]])

    # -- queries ------------------------------------------------------------

    def key_presence(self, reqs_list: Sequence[Requirements]) -> np.ndarray:
        """[P, K] key-defined matrix for the undefined-label offering rule."""
        for reqs in reqs_list:
            for r in reqs:
                self.vocab.key_id(r.key)
        self._maybe_reencode()
        out = np.zeros((len(reqs_list), self._key_capacity), dtype=bool)
        for i, reqs in enumerate(reqs_list):
            for r in reqs:
                out[i, self.vocab.key_ids[r.key]] = True
        return out

    def masks_for_rows(
        self, rows: Sequence[int], keys: Sequence[str]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact (compat[I], has_offering[I]) for ONE requirement set given
        its interned row ids and constrained keys, evaluated host-side from
        the cached per-row matrices.

        Because set compatibility is a per-requirement AND (Intersects:
        every row must intersect independently, requirements.go:248-268),
        AND-ing the cached row vectors of the JOINT requirement set — whose
        rows are the true per-key intersections produced by Requirements.add
        — is bit-identical to the host filter, including the per-offering
        cross-key conjunction. Hostname rows may be excluded by callers
        (they cannot constrain catalog entries)."""
        rows = list(rows)
        self._ensure_rows()
        if rows:
            compat = self._req_compat[rows].all(axis=0)
        else:
            compat = np.ones(self.num_instances, dtype=bool)
        if self.num_offerings == 0:
            return compat, np.zeros(self.num_instances, dtype=bool)
        if rows:
            offer_rows_ok = self._offer_compat[rows].all(axis=0)
        else:
            offer_rows_ok = np.ones(self.num_offerings, dtype=bool)
        key_present = np.zeros(self._key_capacity, dtype=bool)
        for k in keys:
            kid = self.vocab.key_ids.get(k)
            if kid is not None:
                key_present[kid] = True
        undef_ok = ~np.any(self.offering_custom_need & ~key_present[None, :], axis=1)
        offer_ok = offer_rows_ok & undef_ok & self.offering_available
        has_offering = np.zeros(self.num_instances, dtype=bool)
        np.logical_or.at(has_offering, self.offering_owner[offer_ok], True)
        return compat, has_offering

    def host_masks(self, reqs: Requirements) -> tuple[np.ndarray, np.ndarray]:
        return self.masks_for_rows(self.rows_for(reqs), [r.key for r in reqs])

    def warmup(self) -> "CatalogEngine":
        """Pay the cold costs before the first real batch: the device's
        round-trip probe (`device_rtt_s`, which initializes the device), the
        kernel build (on a CUDA engine) and the catalog's row/compat
        bootstrap. Idempotent."""
        if getattr(self, "_warmed", False):
            return self
        device_rtt_s(self.device)  # device init + the routing probe
        probe = Requirements(
            Requirement(wk.LABEL_OS, Operator.EXISTS),
            Requirement(wk.LABEL_ARCH, Operator.EXISTS),
        )
        rows = self.rows_for(probe)
        self._ensure_rows()
        self.feasibility(
            [rows], np.zeros((1, len(self.resource_dims)), dtype=np.float64)
        )
        self._warmed = True
        return self

    def state_arrays(self) -> dict[str, np.ndarray]:
        """The encoded catalog state as host arrays, under the names
        convert.engine_state_from_numpy takes."""
        self._ensure_rows()
        return {
            "req_compat": self._req_compat,
            "offer_compat": self._offer_compat,
            "offering_custom_need": self.offering_custom_need,
            "offering_available": self.offering_available,
            "offering_owner": self.offering_owner,
            "allocatable": self.allocatable,
            "slot_key": self._tables.slot_key,
            "value_int": self._tables.value_int,
        }

    def feasibility(
        self,
        row_sets: Sequence[Sequence[int]],
        requests: np.ndarray,  # [P, D] float32 in self.resource_dims order
        key_present: Optional[np.ndarray] = None,  # [P, K]
    ) -> Feasibility:
        """Batched feasibility of P requirement-sets against the catalog.

        The row axis is restricted to the NON-TRIVIAL rows actually used by
        this query, and both axes are padded to power-of-two buckets (the
        shapes the reference pads to). Padded membership rows are all-False,
        so they read compatible and are sliced off; the membership columns
        past the used rows are padding, which cube_rows skips by count.
        Dispatch is latency-aware (see device_rtt_s): cubes too small to
        amortize the measured device round-trip run through the exact numpy
        twins (port: on a CPU engine or a pinned one; an unpinned CUDA
        engine sweeps on the card, `_card_keeps_work`)."""
        self._ensure_rows()
        P = len(row_sets)
        used = sorted(
            {rid for rows in row_sets for rid in rows if not self._row_trivial[rid]}
        ) if self._computed_rows else []
        colmap = {rid: i for i, rid in enumerate(used)}
        R = max(1, len(used))
        P2 = 1 << max(0, (P - 1).bit_length())
        R2 = 1 << max(0, (R - 1).bit_length())
        # Routing is decided on the PLAIN pow2 dims (identical to pre-AOT
        # behavior); only a sweep that actually goes to the device pads up
        # to its AOT ladder bucket — the host twin must not compute over
        # ladder-inflated matrices, and bucket inflation must not skew the
        # host-vs-device decision.
        host_cells = P2 * R2 * (self.num_instances + self.num_offerings)
        on_device = _use_device(host_cells, _HOST_MATMUL_CELLS_PER_S, self.device)
        # the mesh serves the production cube (offerings present); a
        # membership-only engine is a degenerate catalog, left unsharded
        mesh_n = self.mesh.size if self.mesh is not None and self.num_offerings else 0
        ladder_kernel = (
            "feasibility.cube_sharded"
            if mesh_n
            else (
                "feasibility.cube"
                if self.num_offerings
                else "feasibility.membership"
            )
        )
        if on_device and mesh_n:
            # mesh-size-INVARIANT global entity axis: the pow2 bucket
            # aligned to lcm(n, MESH_ALIGN), the reference's padded shape
            align = mesh_mod.mesh_multiple(mesh_n)
            P2 = -(-max(P2, align) // align) * align
        if on_device and self.aot_ladder is not None:
            # look up by the RAW dims, not the pow2-inflated ones: a tuned
            # ladder may carry non-power-of-two buckets, and (P2, R2) would
            # make them unreachable. A mesh constrains the entity axis to
            # buckets its devices split evenly.
            bucket = self.aot_ladder.bucket_for(
                ladder_kernel, (P, R), multiple_of=mesh_n or 1
            )
            if bucket is None:
                # past the largest bucket (or a ladder with no rung this
                # mesh divides): keep pow2 padding and flag it. The mesh
                # rides the label so the warning names the device layout
                # that missed.
                aotrt.note_off_ladder(
                    ladder_kernel,
                    f"{P2}x{R2}",
                    mesh=feas.mesh_scope(self.mesh) if mesh_n else "",
                )
            else:
                P2, R2 = bucket
        # membership [P2, R2] and key_present [P2, K] side by side in one
        # array: the card's sweep uploads it in one copy
        K = self._key_capacity if key_present is None else key_present.shape[1]
        entities = np.zeros((P2, R2 + K), dtype=bool)
        membership = entities[:, :R2]
        for p, rows in enumerate(row_sets):
            for rid in rows:
                i = colmap.get(rid)
                if i is not None:
                    membership[p, i] = True

        # fits stays host-side in float64: exact parity with resources.fits
        # at byte magnitudes; it's an O(P*I*D) elementwise op.
        fits = np.all(
            requests.astype(np.float64)[:, None, :]
            <= self.allocatable[None, :, :] + 1e-9,
            axis=-1,
        )
        if key_present is not None:
            entities[:P, R2:] = key_present
        if not on_device:
            return self._host_sweep(P, used, membership, entities[:, R2:], fits)

        with device_work("sweep"):
            if self.num_offerings == 0:
                idx = self._to_device(np.asarray(used, dtype=np.int64))
                req_compat = self._gather_rows(self._req_compat_d, idx, R2)
                compat = ktime.dispatch(
                    feas.membership_all, self._to_device(membership.copy()), req_compat,
                    kernel="feasibility.membership",
                )
                return Feasibility(
                    compat.cpu().numpy()[:P],
                    fits,
                    np.zeros((P, self.num_instances), dtype=bool),
                )
            if mesh_n:
                # entity slabs go from the host to their shards, the
                # gathered rows are replicated, the catalog's own arrays
                # come from the per-shard cache
                idx = self._to_device(np.asarray(used, dtype=np.int64))
                compat_d, offering_d = ktime.dispatch(
                    feas.sharded_cube(self.mesh),
                    torch.from_numpy(membership.copy()),
                    self._gather_rows(self._req_compat_d, idx, R2),
                    self._gather_rows(self._offer_compat_d, idx, R2),
                    self._mesh_dev("custom_need", self.offering_custom_need),
                    torch.from_numpy(entities[:, R2:].copy()),
                    self._mesh_dev("available", self.offering_available),
                    self._mesh_dev("owner", self.offering_owner),
                    kernel="feasibility.cube_sharded",
                    aot_scope=feas.mesh_scope(self.mesh),
                )
                return Feasibility(
                    compat_d.cpu().numpy()[:P], fits, offering_d.cpu().numpy()[:P]
                )
            # the entity rows in one upload, the row ids beside them; the
            # kernel reads the resident rows by index and writes both
            # planes into one buffer, copied back once
            entities_d = self._to_device(entities)
            planes = ktime.dispatch(
                _cube,
                entities_d[:, :R2],
                entities_d[:, R2:],
                (
                    self._to_device(np.asarray(used, dtype=np.int32)),
                    self._req_compat_d,
                    self._offer_compat_d,
                ),
                self._dev("custom_need", self.offering_custom_need),
                self._dev("available", self.offering_available),
                self._dev("owner", self.offering_owner),
                kernel="feasibility.cube",
            ).cpu().numpy()
            return Feasibility(planes[0, :P], fits, planes[1, :P])

    def _host_sweep(self, P, used, membership, key_present_p, fits) -> Feasibility:
        """A sweep through the numpy twins, on the plain pow2 dims, from the
        host copies of the row matrices. Host-twin records mirror the device
        kernel they stand in for, with the SAME bucket key the reference's
        device dispatch would produce (its operand tuple: the [O, I] owner
        one-hot it dispatches enters by shape), so the /debug/kernels
        drill-down shows both sides of the routing decision under one shape
        bucket."""
        I, O = self.num_instances, self.num_offerings
        R2 = membership.shape[1]
        req_compat_h = np.zeros((R2, I), dtype=bool)
        if used:
            req_compat_h[: len(used)] = self._req_compat[used]
        compat = feas.membership_all_np(membership, req_compat_h)[:P]
        if O == 0:
            kobs.registry().record_host(
                "feasibility.membership",
                kobs.shape_signature((membership, req_compat_h)),
            )
            return Feasibility(compat, fits, np.zeros((P, I), dtype=bool))
        offer_compat_h = np.zeros((R2, O), dtype=bool)
        if used:
            offer_compat_h[: len(used)] = self._offer_compat[used]
        kobs.registry().record_host(
            "feasibility.cube",
            kobs.shape_signature(
                (
                    membership,
                    req_compat_h,
                    offer_compat_h,
                    self.offering_custom_need,
                    key_present_p,
                    self.offering_available,
                    np.broadcast_to(False, (O, I)),
                )
            ),
        )
        has_offering = feas.offering_reduce_np(
            membership,
            offer_compat_h,
            self.offering_custom_need,
            key_present_p,
            self.offering_available,
            self.offering_owner,
            I,
        )[:P]
        return Feasibility(compat, fits, has_offering)

    def _gather_rows(self, matrix: torch.Tensor, idx: torch.Tensor, R2: int) -> torch.Tensor:
        """Rows `idx` of a device-resident compat matrix, padded with
        all-False rows to R2 (padding rows meet only all-False membership
        columns, so they never decide a result): the operand of the mesh's
        sharded cube and of a catalog without offerings."""
        out = torch.zeros((R2, matrix.shape[1]), dtype=torch.bool, device=self.device)
        out[: idx.numel()] = matrix.index_select(0, idx)
        return out
