"""The shape-bucket ladder: a fixed, versioned set of padded shape buckets
per kernel.

jit executables are keyed by their input shapes, so the set of shapes a
kernel is dispatched with IS the set of executables the process must
compile. The observatory (observability/kernels.py) measures that set per
kernel; the ladder pins it: every device dispatch of a laddered kernel pads
its variable axes up to the smallest bucket that fits, so the universe of
executables is finite, known at boot, and AOT-compilable
(aot/compiler.warm_start). A dispatch that exceeds the largest bucket is an
*off-ladder* dispatch — it still runs (padded to the plain power-of-two
bucket, exactly the pre-ladder behavior) but fires a warning event and a
counter (aot/runtime.note_off_ladder), because it will jit-compile a shape
the AOT walk never prepaid.

Bucket dims are the per-kernel VARIABLE axes only — catalog-determined dims
(instance count, offering count, key/word capacity) come from the engine at
compile time and are part of the cache key, not the ladder:

    feasibility.cube / feasibility.membership : (P, R)  entity x row buckets
    catalog.row_compat                        : (R,)    row-batch bucket
    packer.solve_block                        : (G,)    group bucket

The ladder is versioned (`version` participates in the executable cache
key) and serializable, so a tuned ladder — derived from a production run's
shape-bucket telemetry via `from_observatory` — ships as a JSON artifact
(`--aot-ladder /path/to/ladder.json`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional, Sequence

LADDER_VERSION = 1

# Kernels the ladder governs, with the number of variable axes each buckets.
# The `_sharded` twins run the same math shard_mapped over a device mesh;
# their buckets are GLOBAL (pre-split) shapes, constrained at lookup time to
# be divisible by the mesh size (bucket_for(multiple_of=)).
LADDER_KERNELS = {
    "feasibility.cube": 2,
    "feasibility.membership": 2,
    "catalog.row_compat": 1,
    "packer.solve_block": 1,
    "feasibility.cube_sharded": 2,
    "packer.solve_block_sharded": 1,
    # the fused FFD scan: (pods, groups, claims, nodes, fams, templates,
    # limited-pools). Its first dispatch arg is the pod axis alone, so the
    # generic first-shape heuristic can't see the other six axes —
    # from_observatory parses its full 27-segment signature instead
    # (_scan_signature_dims), so observed scan telemetry derives trimmed
    # rungs like every other laddered kernel.
    "packer.solve_scan": 7,
}

# Sharded dispatches align their entity axis to a multiple of lcm(mesh size,
# MESH_ALIGN) so the padded GLOBAL shape — the executable key, the
# observatory bucket, the AOT cache identity — is the same for every mesh
# size dividing MESH_ALIGN. That is what lets the mesh-smoke CI job demand
# byte-identical kernel digests at mesh sizes 1 and 8: the mesh changes how
# a shape splits across chips, never which shape dispatches.
MESH_ALIGN = 8


def mesh_multiple(n: int) -> int:
    """The entity-axis alignment for an n-device mesh: lcm(n, MESH_ALIGN)."""
    import math

    return (n * MESH_ALIGN) // math.gcd(max(1, n), MESH_ALIGN)


def _pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


@dataclass(frozen=True)
class Ladder:
    """An immutable bucket ladder: kernel name -> sorted bucket tuples."""

    version: int = LADDER_VERSION
    kernels: dict = field(default_factory=dict)  # name -> tuple[tuple[int,...]]

    def bucket_for(
        self, kernel: str, dims: Sequence[int], multiple_of: int = 1
    ) -> Optional[tuple]:
        """The smallest bucket (by cell count) that fits `dims` on every
        axis, or None when the request is off-ladder (no bucket fits, or the
        kernel has no ladder). `multiple_of` constrains the FIRST axis (the
        sharded entity axis) to buckets divisible by it, so a mesh dispatch
        can split the bucket evenly across its devices."""
        buckets = self.kernels.get(kernel)
        if not buckets:
            return None
        best = None
        best_cells = None
        for b in buckets:
            if len(b) != len(dims):
                continue
            if multiple_of > 1 and b[0] % multiple_of:
                continue
            if all(bd >= d for bd, d in zip(b, dims)):
                cells = 1
                for bd in b:
                    # zero axes (a variant selector like the fused scan's
                    # node/pool dims) must not zero the product, or every
                    # zero-bearing rung would tie at 0 cells and selection
                    # would silently degrade to authoring order
                    cells *= max(bd, 1)
                if best_cells is None or cells < best_cells:
                    best, best_cells = b, cells
        return best

    def buckets(self, kernel: str) -> tuple:
        return self.kernels.get(kernel, ())

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "kernels": {
                name: [list(b) for b in buckets]
                for name, buckets in sorted(self.kernels.items())
            },
        }

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=2)


def _normalize(kernels: dict) -> dict:
    out = {}
    for name, buckets in kernels.items():
        norm = sorted({tuple(int(d) for d in b) for b in buckets})
        out[name] = tuple(norm)
    return out


def make(kernels: dict, version: int = LADDER_VERSION) -> Ladder:
    return Ladder(version=version, kernels=_normalize(kernels))


# The default ladder, sized from the shape-bucket telemetry the kernel
# observatory collected across the sim scenarios and bench legs (PR 6):
# steady-state cube sweeps run at single-digit (P, R); coalesced joint-mask
# sweeps (solverd priming, bench scale) reach hundreds of row-sets over a
# few dozen distinct rows. Row-batch device dispatches only occur for bulk
# encodes (catalog.DEVICE_MIN_ROW_BATCH = 32 and up).
#
# The 128/256/1024 P rungs are the FRONTIER buckets: a consolidation
# frontier round primes the whole round's joint row-sets from its largest
# prefix in ONE sweep, so the union lands between the single-solve bucket
# (64) and the old top rung — without the intermediate rungs every frontier
# compute either 8x-overpadded to 512 or, past 512, jit-compiled a shape
# the AOT walk never prepaid (a steady-state recompile, which the
# observatory seal treats as a bug).
#
# The `_sharded` rungs are GLOBAL (pre-split) shapes for mesh dispatches.
# Every entity rung is a multiple of MESH_ALIGN (8), so one rung serves
# every mesh size dividing 8 with an even shard split and a mesh-size-
# invariant executable key; the 4096 packer rung is the hyperscale ceiling
# (a 1M-pod batch of diverse shapes collapses to low-thousands of groups).
DEFAULT = make(
    {
        "feasibility.cube": [
            (p, r) for p in (1, 8, 64, 128, 256, 512, 1024) for r in (4, 16, 64)
        ],
        "feasibility.membership": [
            (p, r) for p in (1, 8, 64, 128, 256, 512, 1024) for r in (4, 16, 64)
        ],
        "catalog.row_compat": [(32,), (64,), (128,)],
        "packer.solve_block": [(8,), (64,), (512,)],
        "feasibility.cube_sharded": [
            (p, r) for p in (8, 64, 128, 256, 512, 1024) for r in (4, 16, 64)
        ],
        "packer.solve_block_sharded": [(8,), (64,), (512,), (4096,)],
        # fused one-dispatch scan rungs (pods, groups, claims, nodes, fams,
        # templates, limited-pools): the small rungs cover coalesced
        # serving batches and consolidation probe sims (with and without
        # existing nodes), the large one the bulk cold-batch shape. These
        # are padding targets for every fused dispatch; the AOT walk only
        # compiles them when the fused path is enabled (aot/compiler).
        "packer.solve_scan": [
            (512, 64, 256, 0, 64, 1, 0),
            (512, 64, 256, 64, 64, 1, 0),
            (8192, 256, 1024, 0, 128, 1, 0),
        ],
    }
)


def from_dict(data: dict) -> Ladder:
    version = int(data.get("version", LADDER_VERSION))
    return make(dict(data.get("kernels", {})), version=version)


def load(path: str) -> Ladder:
    with open(path, encoding="utf-8") as f:
        return from_dict(json.load(f))


def resolve(spec: str) -> Optional[Ladder]:
    """CLI/option resolution: "" or "off" disables, "default" is the
    built-in ladder, anything else is a JSON ladder file path."""
    if not spec or spec == "off":
        return None
    if spec == "default":
        return DEFAULT
    return load(spec)


def _scan_signature_dims(shape: str):
    """Parse a fused-scan shape signature (27 comma-joined operand
    segments, observability/kernels.shape_signature format) back into its
    7 ladder axes (P, G, C, N, F, T, L), each rounded up to a power of
    two. The variant selectors encode "absent" as 1x1 dummy operands
    (fused.solve_scan_abstract_args), which map back to axis 0 — a rung
    derived from a no-nodes dispatch stays a no-nodes rung."""
    segs = shape.split(",")
    if len(segs) < 27:
        return None
    try:
        P = int(segs[0].split("x")[0])
        C = int(segs[1].split("x")[0])
        G = int(segs[2].split("x")[0])
        T = int(segs[5].split("x")[0])
        F = int(segs[10].split("x")[0])
        n = [int(d) for d in segs[15].split("x")]
        pool = [int(d) for d in segs[24].split("x")]
    except ValueError:
        return None
    N = 0 if n == [1, 1] else n[0]
    L = 0 if pool == [1, 1] else pool[0]
    return tuple(_pow2(d) if d else 0 for d in (P, G, C, N, F, T, L))


def from_observatory(counts_snapshot: dict, headroom: int = 1) -> Ladder:
    """Derive a ladder from observed shape-bucket telemetry — the
    drill-down loop /debug/kernels?view=ladder exists to feed. Each
    observed device bucket of a laddered kernel contributes its variable
    axes rounded up to powers of two; `headroom` extra doublings of the
    largest bucket absorb growth between tuning runs."""
    kernels: dict[str, set] = {name: set() for name in LADDER_KERNELS}
    for name, rec in counts_snapshot.items():
        arity = LADDER_KERNELS.get(name)
        if arity is None:
            continue
        for shape, phases in rec.get("shapes", {}).items():
            # host-twin buckets (their own signature format) never select
            # executables; only device dispatches shape the ladder
            if not (phases.get("warmup") or phases.get("steady")
                    or phases.get("aot-warm")):
                continue
            if name == "packer.solve_scan":
                dims = _scan_signature_dims(shape)
                if dims is not None:
                    kernels[name].add(dims)
                continue
            first = shape.split(",", 1)[0]
            try:
                dims = tuple(_pow2(d) for d in first.split("x"))
            except ValueError:
                continue
            if len(dims) < arity:
                continue
            kernels[name].add(dims[:arity])
    for name, buckets in kernels.items():
        if not buckets:
            continue
        # headroom doubles the PER-AXIS maxima (not the lexicographic top
        # bucket): growth on any observed axis stays on-ladder
        top = tuple(
            max(b[axis] for b in buckets)
            for axis in range(len(next(iter(buckets))))
        )
        for i in range(1, headroom + 1):
            kernels[name].add(tuple(d * (2**i) for d in top))
    return make({k: v for k, v in kernels.items() if v})
