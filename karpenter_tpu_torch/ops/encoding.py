"""Host↔device encoding: intern label keys/values, flatten Requirement sets
into fixed-shape arrays.

The vocabulary assigns every (key, value) pair a slot in a single global
bit-space so a requirement's explicit value set is one packed uint32 bitmask.
Per-key metadata (present / complement / bounds) lives in dense [N, K] arrays.
Shapes are padded to power-of-two capacities so XLA compile caches hit as the
vocabulary grows (SURVEY.md §7 "bucketing/padding discipline").

Semantic source: reference pkg/scheduling/requirement.go:33-350 (complement
sets, integer bounds, open-world NotIn/Exists).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

import numpy as np

from karpenter_tpu_torch.scheduling.requirements import Requirement, Requirements

WORD = 32
INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1
# Sentinels for "no bound": gt=INT32_MIN means no lower bound, lt=INT32_MAX none.
NO_GT = INT32_MIN
NO_LT = INT32_MAX
# value_int sentinel for non-integer values
NOT_INT = INT32_MIN


def _next_pow2(n: int, floor: int = 8) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


@dataclass
class Vocab:
    """Interning table for label keys and per-key values.

    Every value of every key occupies one slot in a global bit-space
    [0, num_slots). Slots for one key are NOT necessarily contiguous (values
    are appended as discovered); per-key membership is tracked by
    `slot_key[slot] = key_id`, and masks for different keys never overlap,
    so whole-bitmask AND/OR ops are safe without per-key segmenting.
    """

    key_ids: dict[str, int] = field(default_factory=dict)
    keys: list[str] = field(default_factory=list)
    # (key_id, value) -> global slot
    slot_ids: dict[tuple[int, str], int] = field(default_factory=dict)
    slot_key: list[int] = field(default_factory=list)
    slot_value_int: list[int] = field(default_factory=list)
    _version: int = 0

    @property
    def num_keys(self) -> int:
        return len(self.keys)

    @property
    def num_slots(self) -> int:
        return len(self.slot_key)

    @property
    def version(self) -> int:
        """Bumped whenever the vocabulary grows (invalidates device tables)."""
        return self._version

    def key_id(self, key: str) -> int:
        kid = self.key_ids.get(key)
        if kid is None:
            kid = len(self.keys)
            self.key_ids[key] = kid
            self.keys.append(key)
            self._version += 1
        return kid

    def slot(self, key: str, value: str) -> int:
        kid = self.key_id(key)
        sid = self.slot_ids.get((kid, value))
        if sid is None:
            sid = len(self.slot_key)
            self.slot_ids[(kid, value)] = sid
            self.slot_key.append(kid)
            try:
                iv = int(value)
                if not (INT32_MIN < iv < INT32_MAX):
                    iv = NOT_INT
            except ValueError:
                iv = NOT_INT
            self.slot_value_int.append(iv)
            self._version += 1
        return sid

    def observe(self, reqs: Requirements) -> None:
        """Intern every key/value in a requirement set."""
        for r in reqs:
            kid = self.key_id(r.key)
            for v in r.values:
                self.slot(r.key, v)

    # -- capacities (padded for stable compiled shapes) ---------------------

    @property
    def key_capacity(self) -> int:
        return _next_pow2(self.num_keys, 8)

    @property
    def word_capacity(self) -> int:
        return _next_pow2((self.num_slots + WORD - 1) // WORD, 2)

    def tables(self) -> "VocabTables":
        """Dense numpy tables for device-side per-slot metadata."""
        w = self.word_capacity
        g = w * WORD
        slot_key = np.full((g,), -1, dtype=np.int32)
        slot_key[: self.num_slots] = np.asarray(self.slot_key, dtype=np.int32)
        value_int = np.full((g,), NOT_INT, dtype=np.int32)
        value_int[: self.num_slots] = np.asarray(self.slot_value_int, dtype=np.int32)
        return VocabTables(slot_key=slot_key, value_int=value_int, num_slots=self.num_slots)


@dataclass
class VocabTables:
    slot_key: np.ndarray  # [G] int32: owning key id per slot (-1 = unused)
    value_int: np.ndarray  # [G] int32: integer value or NOT_INT
    num_slots: int


@dataclass
class EncodedReqs:
    """N requirement rows as arrays.

    A row is one `Requirement` (single key). Requirement *sets* are
    represented as groups of rows via external membership indices.
    """

    key: np.ndarray  # [N] int32 key id
    complement: np.ndarray  # [N] bool
    has_values: np.ndarray  # [N] bool (len(values) > 0)
    gt: np.ndarray  # [N] int32 (NO_GT when unset)
    lt: np.ndarray  # [N] int32 (NO_LT when unset)
    mask: np.ndarray  # [N, W] uint32 packed explicit-value bitmask

    def __len__(self) -> int:
        return self.key.shape[0]


def requirements_fingerprint(reqs: Requirements) -> bytes:
    """Canonical content fingerprint of a requirement set: two sets with
    the same semantics — same keys, complement flags, value sets, integer
    bounds, min_values — hash identically regardless of object identity or
    construction order. The incremental encode cache (ops/delta.py) keys
    its cross-pass row cache on this, so churn that REBUILDS a workload's
    Requirements every pass (watch events re-decode pod specs into fresh
    objects) still reuses the interned rows instead of re-encoding."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for r in sorted(reqs, key=lambda r: r.key):
        h.update(r.key.encode())
        h.update(b"\x01" if r.complement else b"\x00")
        for v in sorted(r.values):
            h.update(b"\x1f")
            h.update(v.encode())
        h.update(b"\x1e")
        h.update(str(getattr(r, "greater_than", None)).encode())
        h.update(str(getattr(r, "less_than", None)).encode())
        h.update(str(getattr(r, "min_values", None)).encode())
    return h.digest()


def encode_requirement_rows(
    vocab: Vocab, rows: Sequence[Requirement], word_capacity: Optional[int] = None
) -> EncodedReqs:
    """Encode individual requirements as rows.

    Interns every key/value first so the word capacity is final before the
    mask array is sized; raises if a caller-pinned capacity is outgrown.
    """
    n = len(rows)
    for row in rows:
        vocab.key_id(row.key)
        for v in row.values:
            vocab.slot(row.key, v)
    if word_capacity is not None and word_capacity < vocab.word_capacity:
        raise ValueError("vocabulary grew past the provided word capacity")
    w = word_capacity or vocab.word_capacity
    key = np.zeros((n,), dtype=np.int32)
    complement = np.zeros((n,), dtype=bool)
    has_values = np.zeros((n,), dtype=bool)
    gt = np.full((n,), NO_GT, dtype=np.int32)
    lt = np.full((n,), NO_LT, dtype=np.int32)
    mask = np.zeros((n, w), dtype=np.uint32)
    for i, r in enumerate(rows):
        key[i] = vocab.key_id(r.key)
        complement[i] = r.complement
        has_values[i] = bool(r.values)
        if r.greater_than is not None:
            gt[i] = r.greater_than
        if r.less_than is not None:
            lt[i] = r.less_than
        for v in r.values:
            s = vocab.slot(r.key, v)
            mask[i, s // WORD] |= np.uint32(1 << (s % WORD))
    return EncodedReqs(key, complement, has_values, gt, lt, mask)


@dataclass
class EncodedReqSets:
    """N requirement *sets*, each a per-key row in dense [N, K] layout.

    Used for entities whose full key map matters (instance types, offerings):
    per key we store whether the set constrains it and how.
    """

    present: np.ndarray  # [N, K] bool
    complement: np.ndarray  # [N, K] bool
    has_values: np.ndarray  # [N, K] bool
    gt: np.ndarray  # [N, K] int32
    lt: np.ndarray  # [N, K] int32
    mask: np.ndarray  # [N, W] uint32 — union over keys; keys don't share slots

    def __len__(self) -> int:
        return self.present.shape[0]


def encode_requirement_sets(
    vocab: Vocab,
    sets: Sequence[Requirements],
    key_capacity: Optional[int] = None,
    word_capacity: Optional[int] = None,
) -> EncodedReqSets:
    """Encode requirement sets into dense per-key arrays. Interns first so
    capacities are final before allocation."""
    for rs in sets:
        vocab.observe(rs)
    n = len(sets)
    k = key_capacity or vocab.key_capacity
    w = word_capacity or vocab.word_capacity
    if k < vocab.key_capacity or w < vocab.word_capacity:
        raise ValueError("provided capacities too small for vocabulary")
    present = np.zeros((n, k), dtype=bool)
    complement = np.zeros((n, k), dtype=bool)
    has_values = np.zeros((n, k), dtype=bool)
    gt = np.full((n, k), NO_GT, dtype=np.int32)
    lt = np.full((n, k), NO_LT, dtype=np.int32)
    mask = np.zeros((n, w), dtype=np.uint32)
    for i, rs in enumerate(sets):
        for r in rs:
            kid = vocab.key_id(r.key)
            present[i, kid] = True
            complement[i, kid] = r.complement
            has_values[i, kid] = bool(r.values)
            if r.greater_than is not None:
                gt[i, kid] = r.greater_than
            if r.less_than is not None:
                lt[i, kid] = r.less_than
            for v in r.values:
                s = vocab.slot(r.key, v)
                mask[i, s // WORD] |= np.uint32(1 << (s % WORD))
    return EncodedReqSets(present, complement, has_values, gt, lt, mask)


@dataclass
class DomainVocab:
    """Interning table for topology DOMAIN strings (zone names, hostnames,
    custom-key values): one dense id-space per topology group, so the
    group's occupancy lives in a count vector indexed by domain id instead
    of a str-keyed dict (ops/topo_counts.py). Ids are append-only — a
    domain keeps its slot for the vocabulary's lifetime, so count tensors
    survive re-syncs without re-indexing."""

    ids: dict[str, int] = field(default_factory=dict)
    domains: list[str] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.domains)

    def id(self, domain: str) -> int:
        """Interned id for `domain`, assigning the next slot on first use."""
        did = self.ids.get(domain)
        if did is None:
            did = len(self.domains)
            self.ids[domain] = did
            self.domains.append(domain)
        return did

    def lookup(self, domain: str) -> Optional[int]:
        """Id for `domain` without interning (None when never seen)."""
        return self.ids.get(domain)


def encode_resource_dims(resource_names: Sequence[str]) -> dict[str, int]:
    return {name: i for i, name in enumerate(resource_names)}


def encode_resource_lists(
    dims: dict[str, int], items: Sequence[dict], missing: float = 0.0
) -> np.ndarray:
    """[N, R] float64 resource matrix; unknown resource names must be
    registered in `dims` by the caller beforehand. float64 so byte-scale
    memory values stay exact — the device packer quantizes separately
    (feasibility.quantize_resources)."""
    out = np.full((len(items), len(dims)), missing, dtype=np.float64)
    for i, rl in enumerate(items):
        for name, v in rl.items():
            out[i, dims[name]] = v
    return out
