"""Capacity-counted reservation of reserved offerings per simulated host.

Mirrors the reference's scheduling/reservationmanager.go:29-107.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.cloudprovider.types import InstanceType, Offering


class ReservationManager:
    def __init__(self, instance_types: Mapping[str, Sequence[InstanceType]]):
        self._reservations: dict[str, set[str]] = {}  # hostname -> reservation ids
        self._capacity: dict[str, int] = {}
        for its in instance_types.values():
            for it in its:
                for o in it.offerings:
                    if o.capacity_type != wk.CAPACITY_TYPE_RESERVED:
                        continue
                    rid = o.reservation_id
                    current = self._capacity.get(rid)
                    # Conservative: keep the smallest advertised capacity for
                    # a reservation seen across types (reservationmanager.go:36-41).
                    if current is None or current > o.reservation_capacity:
                        self._capacity[rid] = o.reservation_capacity

    def can_reserve(self, hostname: str, offering: Offering) -> bool:
        rid = offering.reservation_id
        if rid in self._reservations.get(hostname, ()):
            return True
        capacity = self._capacity.get(rid)
        if capacity is None:
            raise KeyError(f"unknown reservation id {rid!r}")
        return capacity > 0

    def reserve(self, hostname: str, *offerings: Offering) -> None:
        for o in offerings:
            rid = o.reservation_id
            held = self._reservations.setdefault(hostname, set())
            if rid in held:
                continue
            self._capacity[rid] -= 1
            if self._capacity[rid] < 0:
                raise RuntimeError(f"over-reserved reservation id {rid!r}")
            held.add(rid)

    def release(self, hostname: str, *offerings: Offering) -> None:
        for o in offerings:
            rid = o.reservation_id
            held = self._reservations.get(hostname)
            if held is not None and rid in held:
                held.discard(rid)
                self._capacity[rid] += 1

    def has_reservation(self, hostname: str, offering: Offering) -> bool:
        return offering.reservation_id in self._reservations.get(hostname, ())

    def remaining_capacity(self, offering: Offering) -> int:
        return self._capacity.get(offering.reservation_id, 0)
