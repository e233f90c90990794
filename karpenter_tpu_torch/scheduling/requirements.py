"""Node-selector requirement set algebra.

Semantics mirror the reference's pkg/scheduling/requirement.go:33-350 and
requirements.go:36-298: a `Requirement` is a (possibly complemented) value
set per label key with optional integer bounds; a `Requirements` is a
key→Requirement map where adding intersects. `NotIn`/`Exists` are open-world
complement sets (infinite), which is why intersections of two complements are
always non-empty.
"""

from __future__ import annotations

from enum import Enum
from typing import Iterable, Iterator, Mapping, Optional

from karpenter_tpu_torch.apis import labels as well_known

# Sentinel cardinality for complement (infinite) sets, mirroring the
# reference's math.MaxInt64-based Len (requirement.go:277-282).
INFINITE = 1 << 62


class Operator(str, Enum):
    IN = "In"
    NOT_IN = "NotIn"
    EXISTS = "Exists"
    DOES_NOT_EXIST = "DoesNotExist"
    GT = "Gt"
    LT = "Lt"


def _as_int(value: str) -> Optional[int]:
    try:
        return int(value)
    except ValueError:
        return None


def _within(value: str, greater_than: Optional[int], less_than: Optional[int]) -> bool:
    """Bounds check; non-integer values are invalid when bounds are set
    (reference requirement.go:308-324)."""
    if greater_than is None and less_than is None:
        return True
    iv = _as_int(value)
    if iv is None:
        return False
    if greater_than is not None and greater_than >= iv:
        return False
    if less_than is not None and less_than <= iv:
        return False
    return True


def _max_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


def _min_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


class Requirement:
    """A single-key requirement: value set or its complement, with bounds.

    Construction normalizes aliased label keys (requirement.go:44-84).
    """

    __slots__ = ("key", "values", "complement", "greater_than", "less_than", "min_values")

    def __init__(
        self,
        key: str,
        operator: Operator | str,
        values: Iterable[str] = (),
        min_values: Optional[int] = None,
    ):
        operator = Operator(operator)
        key = well_known.NORMALIZED_LABELS.get(key, key)
        self.key = key
        self.min_values = min_values
        self.greater_than: Optional[int] = None
        self.less_than: Optional[int] = None
        values = list(values)
        if operator == Operator.IN:
            self.values = frozenset(values)
            self.complement = False
        elif operator == Operator.DOES_NOT_EXIST:
            self.values = frozenset()
            self.complement = False
        elif operator == Operator.NOT_IN:
            self.values = frozenset(values)
            self.complement = True
        elif operator == Operator.EXISTS:
            self.values = frozenset()
            self.complement = True
        elif operator == Operator.GT:
            self.values = frozenset()
            self.complement = True
            self.greater_than = int(values[0])
        elif operator == Operator.LT:
            self.values = frozenset()
            self.complement = True
            self.less_than = int(values[0])
        else:  # pragma: no cover
            raise ValueError(f"unknown operator {operator}")

    @classmethod
    def _raw(
        cls,
        key: str,
        values: frozenset[str],
        complement: bool,
        greater_than: Optional[int] = None,
        less_than: Optional[int] = None,
        min_values: Optional[int] = None,
    ) -> "Requirement":
        r = cls.__new__(cls)
        r.key = key
        r.values = values
        r.complement = complement
        r.greater_than = greater_than
        r.less_than = less_than
        r.min_values = min_values
        return r

    # -- algebra -----------------------------------------------------------

    def intersection(self, other: "Requirement") -> "Requirement":
        """Set intersection, mirroring requirement.go:155-188."""
        complement = self.complement and other.complement
        greater_than = _max_opt(self.greater_than, other.greater_than)
        less_than = _min_opt(self.less_than, other.less_than)
        min_values = _max_opt(self.min_values, other.min_values)
        if greater_than is not None and less_than is not None and greater_than >= less_than:
            return Requirement(self.key, Operator.DOES_NOT_EXIST, min_values=min_values)

        if self.complement and other.complement:
            values = self.values | other.values
        elif self.complement and not other.complement:
            values = other.values - self.values
        elif not self.complement and other.complement:
            values = self.values - other.values
        else:
            values = self.values & other.values
        values = frozenset(v for v in values if _within(v, greater_than, less_than))
        if not complement:
            greater_than, less_than = None, None
        return Requirement._raw(self.key, values, complement, greater_than, less_than, min_values)

    def has_intersection(self, other: "Requirement") -> bool:
        """Allocation-free intersection test (requirement.go:194-228)."""
        greater_than = _max_opt(self.greater_than, other.greater_than)
        less_than = _min_opt(self.less_than, other.less_than)
        if greater_than is not None and less_than is not None and greater_than >= less_than:
            return False
        if self.complement and other.complement:
            return True
        if self.complement:
            return any(
                v not in self.values and _within(v, greater_than, less_than)
                for v in other.values
            )
        if other.complement:
            return any(
                v not in other.values and _within(v, greater_than, less_than)
                for v in self.values
            )
        return any(
            v in other.values and _within(v, greater_than, less_than) for v in self.values
        )

    def has(self, value: str) -> bool:
        """True if the requirement allows the value (requirement.go:249-254)."""
        if self.complement:
            return value not in self.values and _within(
                value, self.greater_than, self.less_than
            )
        return value in self.values and _within(value, self.greater_than, self.less_than)

    def any(self) -> str:
        """A representative allowed value (requirement.go:230-246).

        Deterministic (unlike the reference's rand) — smallest allowed value —
        so decision-identity tests are reproducible.
        """
        op = self.operator
        if op == Operator.IN:
            return min(self.values)
        if op in (Operator.NOT_IN, Operator.EXISTS):
            lo = 0 if self.greater_than is None else self.greater_than + 1
            hi = INFINITE if self.less_than is None else self.less_than
            v = lo
            while v < hi and str(v) in self.values:
                v += 1
            if v >= hi:
                return ""  # every value in (greater_than, less_than) is excluded
            return str(v)
        return ""

    @property
    def operator(self) -> Operator:
        if self.complement:
            return Operator.NOT_IN if self.values else Operator.EXISTS
        return Operator.IN if self.values else Operator.DOES_NOT_EXIST

    def __len__(self) -> int:
        if self.complement:
            return INFINITE - len(self.values)
        return len(self.values)

    def values_list(self) -> list[str]:
        return sorted(self.values)

    def insert(self, *items: str) -> None:
        self.values = frozenset(self.values | set(items))

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Requirement):
            return NotImplemented
        return (
            self.key == other.key
            and self.values == other.values
            and self.complement == other.complement
            and self.greater_than == other.greater_than
            and self.less_than == other.less_than
            and self.min_values == other.min_values
        )

    def __hash__(self) -> int:
        return hash(
            (self.key, self.values, self.complement, self.greater_than, self.less_than)
        )

    def __repr__(self) -> str:
        op = self.operator
        if op in (Operator.EXISTS, Operator.DOES_NOT_EXIST):
            s = f"{self.key} {op.value}"
        else:
            vals = self.values_list()
            if len(vals) > 5:
                vals = vals[:5] + [f"and {len(self.values) - 5} others"]
            s = f"{self.key} {op.value} {vals}"
        if self.greater_than is not None:
            s += f" >{self.greater_than}"
        if self.less_than is not None:
            s += f" <{self.less_than}"
        if self.min_values is not None:
            s += f" minValues {self.min_values}"
        return s


_LABEL_REQ_CACHE: dict = {}
_LABEL_REQ_CAP = 100_000


class Requirements:
    """A key→Requirement map where `add` intersects same-key requirements.

    Mirrors reference requirements.go:36-298.
    """

    __slots__ = ("_map",)

    def __init__(self, *requirements: Requirement):
        self._map: dict[str, Requirement] = {}
        self.add(*requirements)

    @classmethod
    def from_labels(cls, labels: Mapping[str, str]) -> "Requirements":
        # Single-value label requirements are interned process-wide: node
        # re-ingestion and consolidation simulations rebuild the same
        # (key, value) rows thousands of times per pass. Shared objects are
        # safe — nothing mutates label-derived requirements (mutation sites
        # are template minValues write-downs and topology DOES_NOT_EXIST
        # options, both operating on their own objects).
        reqs = []
        for k, v in labels.items():
            ck = (k, v)
            r = _LABEL_REQ_CACHE.get(ck)
            if r is None:
                if len(_LABEL_REQ_CACHE) >= _LABEL_REQ_CAP:
                    _LABEL_REQ_CACHE.clear()
                r = Requirement(k, Operator.IN, [v])
                _LABEL_REQ_CACHE[ck] = r
            reqs.append(r)
        return cls(*reqs)

    def copy(self) -> "Requirements":
        out = Requirements()
        out._map = dict(self._map)
        return out

    def add(self, *requirements: Requirement) -> None:
        for requirement in requirements:
            existing = self._map.get(requirement.key)
            if existing is not None:
                requirement = requirement.intersection(existing)
            self._map[requirement.key] = requirement

    def keys(self) -> set[str]:
        return set(self._map.keys())

    def values(self) -> list[Requirement]:
        return list(self._map.values())

    def __iter__(self) -> Iterator[Requirement]:
        return iter(self._map.values())

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def has(self, key: str) -> bool:
        return key in self._map

    def get(self, key: str) -> Requirement:
        """Missing keys behave as Exists — allow anything (requirements.go:154-160)."""
        req = self._map.get(key)
        if req is None:
            return Requirement(key, Operator.EXISTS)
        return req

    # -- compatibility -----------------------------------------------------

    def compatible(
        self, incoming: "Requirements", allow_undefined: frozenset[str] = frozenset()
    ) -> Optional[str]:
        """None if `incoming` can loosely be met, else an error string.

        Custom labels must intersect but are denied when undefined on self;
        labels in `allow_undefined` (well-known) are allowed when undefined.
        Mirrors requirements.go:175-191.
        """
        for key in incoming._map:
            if key in allow_undefined:
                continue
            op = incoming.get(key).operator
            if key in self._map or op in (Operator.NOT_IN, Operator.DOES_NOT_EXIST):
                continue
            return f"label {key!r} does not have known values"
        return self.intersects(incoming)

    def is_compatible(
        self, incoming: "Requirements", allow_undefined: frozenset[str] = frozenset()
    ) -> bool:
        """Boolean twin of compatible(): same gates, no error formatting —
        this runs in per-(pod, offering) loops."""
        for key in incoming._map:
            if key in allow_undefined:
                continue
            op = incoming.get(key).operator
            if key in self._map or op in (Operator.NOT_IN, Operator.DOES_NOT_EXIST):
                continue
            return False
        return self.intersects_ok(incoming)

    def _conflicting_pairs(self, incoming: "Requirements"):
        """Shared core of intersects()/intersects_ok(): yields each
        (key, incoming row, existing row) whose value sets don't intersect,
        honoring the NotIn/DoesNotExist double-negative carve-out
        (requirements.go:248-268)."""
        small, large = self._map, incoming._map
        if len(small) > len(large):
            small, large = large, small
        for key in small:
            if key not in large:
                continue
            existing = self.get(key)
            inc = incoming.get(key)
            if not existing.has_intersection(inc):
                if inc.operator in (Operator.NOT_IN, Operator.DOES_NOT_EXIST) and (
                    existing.operator in (Operator.NOT_IN, Operator.DOES_NOT_EXIST)
                ):
                    continue
                yield key, inc, existing

    def intersects(self, incoming: "Requirements") -> Optional[str]:
        """None if all shared keys have overlapping values, else an error
        string naming every conflict."""
        errs = [
            f"key {key}, {inc!r} not in {existing!r}"
            for key, inc, existing in self._conflicting_pairs(incoming)
        ]
        return "; ".join(errs) if errs else None

    def intersects_ok(self, incoming: "Requirements") -> bool:
        """Early-exit boolean twin of intersects()."""
        return next(iter(self._conflicting_pairs(incoming)), None) is None

    def labels(self) -> dict[str, str]:
        """Concretize to node labels, skipping restricted keys (requirements.go:270-280)."""
        out: dict[str, str] = {}
        for key, req in self._map.items():
            if not well_known.is_restricted_node_label(key):
                value = req.any()
                if value:
                    out[key] = value
        return out

    def has_min_values(self) -> bool:
        return any(r.min_values is not None for r in self._map.values())

    def node_selector_requirements(self) -> list[dict]:
        """Serialize back to NodeSelectorRequirement-shaped dicts."""
        out = []
        for r in self._map.values():
            op = r.operator
            if r.greater_than is not None:
                entry = {"key": r.key, "operator": "Gt", "values": [str(r.greater_than)]}
            elif r.less_than is not None:
                entry = {"key": r.key, "operator": "Lt", "values": [str(r.less_than)]}
            elif op in (Operator.IN, Operator.NOT_IN):
                entry = {"key": r.key, "operator": op.value, "values": r.values_list()}
            else:
                entry = {"key": r.key, "operator": op.value, "values": []}
            if r.min_values is not None:
                entry["minValues"] = r.min_values
            out.append(entry)
        return sorted(out, key=lambda e: e["key"])

    def __repr__(self) -> str:
        reqs = [
            repr(r)
            for r in self._map.values()
            if r.key not in well_known.RESTRICTED_LABELS
        ]
        return ", ".join(sorted(reqs))


ALLOW_UNDEFINED_WELL_KNOWN_LABELS = well_known.WELL_KNOWN_LABELS


def pod_requirements(pod) -> Requirements:
    """Pod requirements with the heaviest preference treated as required
    (reference requirements.go:74-76, 90-110)."""
    return _pod_requirements(pod, include_preferred=True)


def strict_pod_requirements(pod) -> Requirements:
    """Only true requirements, no preferences (requirements.go:79-81)."""
    return _pod_requirements(pod, include_preferred=False)


def _pod_requirements(pod, include_preferred: bool) -> Requirements:
    reqs = Requirements.from_labels(pod.spec.node_selector)
    affinity = pod.spec.affinity
    if affinity is None or affinity.node_affinity is None:
        return reqs
    node_affinity = affinity.node_affinity
    if include_preferred and node_affinity.preferred:
        heaviest = max(node_affinity.preferred, key=lambda p: p.weight)
        reqs.add(*requirements_from_dicts(heaviest.preference.match_expressions).values())
    # Only the first OR term is honored; the relaxation ladder removes terms
    # when unsatisfiable (requirements.go:104-108).
    if node_affinity.required:
        reqs.add(
            *requirements_from_dicts(node_affinity.required[0].match_expressions).values()
        )
    return reqs


def has_preferred_node_affinity(pod) -> bool:
    a = pod.spec.affinity
    return bool(a and a.node_affinity and a.node_affinity.preferred)


def requirements_from_dicts(raw: Iterable[Mapping]) -> Requirements:
    """Build Requirements from NodeSelectorRequirement-shaped dicts."""
    out = Requirements()
    for item in raw:
        out.add(
            Requirement(
                item["key"],
                item["operator"],
                item.get("values", ()),
                min_values=item.get("minValues"),
            )
        )
    return out
