"""Frontier reductions for the device-resident consolidation search.

The multi-node consolidation search probes prefix sizes of a cost-sorted
candidate list. The sequential reference walks a binary search — one full
scheduling simulation per probe, each bound waiting on the last verdict
(multinodeconsolidation.go:117-170). The frontier search instead evaluates
whole *levels* of that binary decision tree speculatively: every probe the
sequential search *could* reach within the next `depth` verdicts is
simulated as one coalesced solverd batch, then the tree is walked host-side
using the batch's verdicts. Because the probe set of a round is exactly the
top `depth` levels of the sequential search's decision tree rooted at the
current (lo, hi), the walk reproduces the sequential search's probe
sequence — and therefore its decision — *bit for bit*, with no monotonicity
assumption required: rounds shrink from log2(N) sequential simulations to
ceil(log2(N)/depth) batched ones, and the speculative probes it evaluates
are a superset of the probes the sequential search visits.

This module also hosts the prefix-structured price reductions that feed the
per-probe verdicts. The sequential search recomputes candidate prices and
the same-type price floors from scratch for every probe (O(probes x prefix x
offerings)); a frontier evaluates many prefixes of the SAME candidate
order, so both collapse to one pass over the candidates: a sequential
left-fold cumulative sum for prefix prices (np.add.accumulate is an exact
left fold over float64 — bit-identical to the reference's running Python
sum) and a running per-type minimum for the replace-cheaper-than-cheapest
gate (min is exact; order-independent). The k scheduling simulations are
the device batch; these reductions are the O(N) host vector work that turns
their results into per-prefix verdicts without re-walking the prefix.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

# Speculation depth: how many levels of the binary decision tree one
# coalesced batch evaluates. A round of depth d simulates at most 2^d - 1
# prefixes and consumes d sequential verdicts, so the ~7-level search over
# the <=100-candidate window runs in ceil(7/d) rounds. The default is
# deliberately modest: each speculative probe is a real scheduling
# simulation, and only about d of the 2^d - 1 land on the walked path —
# depth 2 triples the per-round batch the coalescer can fuse while keeping
# the speculation waste bounded (~2x the sequential probe count).
DEFAULT_DEPTH = 2


def speculative_probes(lo: int, hi: int, depth: int) -> list[int]:
    """The prefix indices (binary-search mids) in the top `depth` levels of
    the sequential search's decision tree over [lo, hi]. Every interval in
    the tree is disjoint from its siblings, so the mids are distinct; they
    are returned in deterministic preorder."""
    probes: list[int] = []

    def rec(lo: int, hi: int, d: int) -> None:
        if d <= 0 or lo > hi:
            return
        mid = (lo + hi) // 2
        probes.append(mid)
        rec(lo, mid - 1, d - 1)
        rec(mid + 1, hi, d - 1)

    rec(lo, hi, depth)
    return probes


class PrefixPrices:
    """Per-prefix current prices of a fixed candidate order, computed once.

    `get_candidate_prices` (consolidation.go:304-329) scans the candidates
    in order: the first candidate with no compatible current offering
    decides the whole answer — 0.0 when it is reserved capacity, None
    (abort) otherwise; if every candidate is compatible the answer is the
    running sum of the cheapest compatible prices. For a prefix of length m
    that is a pure function of (first bad index, cumulative sum), both of
    which one pass over the candidates yields for ALL prefixes at once."""

    def __init__(self, candidates: Sequence) -> None:
        from karpenter_tpu_torch.apis import labels as wk
        from karpenter_tpu_torch.cloudprovider.types import Offerings
        from karpenter_tpu_torch.scheduling.requirements import Requirements

        n = len(candidates)
        prices = np.zeros(n, dtype=np.float64)
        # index of the first candidate with no compatible offering, and
        # whether that candidate was reserved (-> price 0.0) or not (-> None)
        self._bad_index = n
        self._bad_reserved = False
        for i, c in enumerate(candidates):
            reqs = Requirements.from_labels(c.state_node.labels())
            compatible = Offerings(c.instance_type.offerings).compatible(reqs)
            if not compatible:
                self._bad_index = i
                self._bad_reserved = reqs.get(wk.CAPACITY_TYPE_LABEL_KEY).has(
                    wk.CAPACITY_TYPE_RESERVED
                )
                break
            prices[i] = compatible.cheapest().price
        # exact left fold: np.add.accumulate computes r[i] = r[i-1] + p[i]
        # in candidate order, the same float64 addition sequence as the
        # reference's running `price += ...`
        self._cumulative = np.add.accumulate(prices)

    def for_prefix(self, m: int) -> Optional[float]:
        """The `get_candidate_prices` answer for candidates[:m]."""
        if m <= 0:
            return 0.0
        if self._bad_index < m:
            return 0.0 if self._bad_reserved else None
        return float(self._cumulative[m - 1])


class PrefixTypeFloors:
    """Per-prefix inputs of the replace-cheaper-than-cheapest gate.

    `_filter_out_same_type` (multinodeconsolidation.go:188-226) needs, per
    prefix: the set of instance types the prefix currently runs, and the
    cheapest CURRENT price each of those types runs at. Both are running
    reductions over the candidate order (set union / per-type min), so one
    pass yields every prefix's view; the per-candidate compatible-offering
    scan — the expensive part the sequential search repeats per probe —
    happens exactly once per candidate."""

    def __init__(self, candidates: Sequence) -> None:
        from karpenter_tpu_torch.cloudprovider.types import Offerings
        from karpenter_tpu_torch.scheduling.requirements import Requirements

        # snapshots[m-1] = (existing type names, per-type price floor) for
        # candidates[:m]; the dicts/sets are frozen copies per prefix (a
        # candidate window is <=100, so the copies are trivially small and
        # callers can mutate nothing shared)
        self._snapshots: list[tuple[frozenset, dict]] = []
        types: set[str] = set()
        floors: dict[str, float] = {}
        for c in candidates:
            types.add(c.instance_type.name)
            compatible = Offerings(c.instance_type.offerings).compatible(
                Requirements.from_labels(c.state_node.labels())
            )
            if compatible:
                p = compatible.cheapest().price
                if p < floors.get(c.instance_type.name, math.inf):
                    floors[c.instance_type.name] = p
            self._snapshots.append((frozenset(types), dict(floors)))

    def max_price(self, m: int, option_names: Sequence[str]) -> float:
        """The price cap `_filter_out_same_type` derives for a replacement
        whose instance-type options are `option_names`, against the prefix
        candidates[:m]: the cheapest current price among shared types."""
        if m <= 0 or not self._snapshots:
            return math.inf
        types, floors = self._snapshots[min(m, len(self._snapshots)) - 1]
        max_price = math.inf
        for name in option_names:
            if name in types:
                max_price = min(max_price, floors.get(name, math.inf))
        return max_price
