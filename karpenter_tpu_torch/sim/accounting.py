"""Cost / SLO / churn accounting over a simulation's event log.

Everything derives from the event log plus the instance-type catalog — not
from process-global metrics — so two sims in one process can't contaminate
each other and reports are as reproducible as the log itself.

Prices are $/hour (kwok catalog convention); cost integrates price over
each node's registered lifetime in virtual time.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.sim.events import EventLog
from karpenter_tpu_torch.utils.stats import percentile  # noqa: F401 — re-export

REPORT_VERSION = 1


class Accountant:
    """Folds event-log entries into the end-of-run report."""

    def __init__(self, instance_types: list, start: float):
        self._price: dict[tuple[str, str, str], float] = {}
        for it in instance_types:
            for o in it.offerings:
                self._price[(it.name, o.capacity_type, o.zone)] = o.price
        self.start = start

    def node_price(self, instance_type: str, capacity_type: str, zone: str) -> float:
        return self._price.get((instance_type, capacity_type, zone), 0.0)

    def report(
        self,
        log: EventLog,
        end: float,
        scenario: str,
        seed: int,
        solver_stats: Optional[dict] = None,
    ) -> dict:
        # log entries carry RELATIVE virtual time; convert the absolute
        # horizon once so every charge works in one time base
        end = end - self.start
        node_added: dict[str, dict] = {}  # name -> add entry (still running)
        cost_total = 0.0
        node_hours = 0.0
        cost_by_ct: dict[str, float] = {}
        submitted: dict[str, float] = {}  # pod -> submit t
        latencies: list[float] = []
        unbound: set[str] = set()
        counts = {
            "nodes_created": 0,
            "nodes_deleted": 0,
            "nodeclaims_created": 0,
            "nodeclaims_deleted": 0,
        }
        faults = {
            "spot_interruptions": 0,
            "capacity_reclaims": 0,
            "launch_failures": 0,
            "capacity_errors": 0,
            "cloud_outage_failures": 0,
            "solver_rejections": 0,
            "solverd_restarts": 0,
            "pods_lost": 0,
        }
        breaker = {
            "opens": 0,
            "half_opens": 0,
            "closes": 0,
            "state_at_end": "closed",
        }
        max_nodes = 0

        def _charge(entry: dict, until: float) -> None:
            nonlocal cost_total, node_hours
            hours = max(0.0, until - entry["t"]) / 3600.0
            node_hours += hours
            price = self.node_price(
                entry.get("instance_type", ""),
                entry.get("capacity_type", ""),
                entry.get("zone", ""),
            )
            cost_total += price * hours
            ct = entry.get("capacity_type", "")
            cost_by_ct[ct] = cost_by_ct.get(ct, 0.0) + price * hours

        for e in log:
            ev = e["ev"]
            if ev == "node-added":
                node_added[e["node"]] = e
                counts["nodes_created"] += 1
                max_nodes = max(max_nodes, len(node_added))
            elif ev == "node-deleted":
                entry = node_added.pop(e["node"], None)
                counts["nodes_deleted"] += 1
                if entry is not None:
                    _charge(entry, e["t"])
            elif ev == "nodeclaim-added":
                counts["nodeclaims_created"] += 1
            elif ev == "nodeclaim-deleted":
                counts["nodeclaims_deleted"] += 1
            elif ev == "pod-submitted":
                submitted[e["pod"]] = e["t"]
                unbound.add(e["pod"])
            elif ev == "pod-bound":
                t0 = submitted.get(e["pod"])
                if t0 is not None and e["pod"] in unbound:
                    latencies.append(e["t"] - t0)
                    unbound.discard(e["pod"])
            elif ev == "pod-lost":
                faults["pods_lost"] += 1
            elif ev == "fault-interrupt":
                faults["spot_interruptions"] += 1
            elif ev == "fault-reclaim":
                faults["capacity_reclaims"] += 1
            elif ev == "fault-launch":
                faults["launch_failures"] += 1
            elif ev == "fault-ice":
                faults["capacity_errors"] += 1
            elif ev == "fault-outage":
                faults["cloud_outage_failures"] += 1
            elif ev == "fault-solver-reject":
                faults["solver_rejections"] += 1
            elif ev == "solverd-restart":
                faults["solverd_restarts"] += 1
            elif ev == "breaker":
                to = e["to"]
                if to == "open":
                    breaker["opens"] += 1
                elif to == "half-open":
                    breaker["half_opens"] += 1
                elif to == "closed":
                    breaker["closes"] += 1
                breaker["state_at_end"] = to

        # nodes still up at the end of the run accrue cost to the horizon
        for entry in node_added.values():
            _charge(entry, end)

        latencies.sort()
        report = {
            "report_version": REPORT_VERSION,
            "scenario": scenario,
            "seed": seed,
            "virtual_duration_s": round(end, 6),
            "events": len(log),
            "event_log_digest": log.digest(),
            "cost": {
                "total_usd": round(cost_total, 6),
                "by_capacity_type": {
                    k: round(v, 6) for k, v in sorted(cost_by_ct.items())
                },
                "node_hours": round(node_hours, 6),
            },
            "slo": {
                "pods_submitted": len(submitted),
                "pods_bound": len(latencies),
                "pods_never_bound": len(unbound),
                "time_to_schedule_s": {
                    "p50": percentile(latencies, 50),
                    "p90": percentile(latencies, 90),
                    "p99": percentile(latencies, 99),
                    "max": latencies[-1] if latencies else None,
                },
            },
            "churn": {
                **counts,
                "max_concurrent_nodes": max_nodes,
                "nodes_at_end": len(node_added),
            },
            "faults": faults,
            "breaker": breaker,
        }
        if solver_stats is not None:
            report["solver"] = solver_stats
        return report


def node_facts(node) -> dict:
    """The accounting-relevant labels of a Node, for log entries."""
    labels = node.metadata.labels
    return {
        "instance_type": labels.get(wk.LABEL_INSTANCE_TYPE, ""),
        "capacity_type": labels.get(wk.CAPACITY_TYPE_LABEL_KEY, ""),
        "zone": labels.get(wk.LABEL_TOPOLOGY_ZONE, ""),
    }
