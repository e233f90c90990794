"""Plain first-fit-decreasing provisioning: the reference for the cells that
time `Scheduler.solve`.

The semantics of upstream karpenter's provisioning scheduler
(pkg/controllers/provisioning/scheduling: queue.go, scheduler.go,
nodeclaim.go) for the deployments this benchmark states: pods with cpu
and memory requests and no selector, affinity or spread (their own
labels place nothing), one NodePool without requirements, taints, limits
or daemonsets, an empty cluster.

- Pods are taken largest first: cpu, then memory, descending; ties by
  creation time, then uid.
- A pod goes to the first in-flight NodeClaim that holds it, the claims
  tried fewest pods first (a stable sort before every pod); else to a new
  NodeClaim of the NodePool, if some instance type holds the pod alone;
  else it is an error.
- A claim holds a pod when some instance type with an available offering
  holds the claim's requests plus the pod's (cpu, memory and one pod
  slot) within its allocatable, to 1e-9.
- A claim's instance-type options are the types with an available
  offering that hold its final requests; its requirements are the pool's
  labels, each an In set.

`ignore_pod_slots=True` is the control: it packs without counting the
pod slots, and so breaks the guarantee that a node's pods fit what the
node can give them, one slot each.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

EPS = 1e-9
Pod = namedtuple("Pod", "uid ts cpu mem")


def _fits(need: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """need [n, 3] -> [n] bool: some row holds it."""
    ok = (need[:, None, :] <= rows[None, :, :] + EPS) | (need[:, None, :] <= 0)
    return ok.all(2).any(1)


class Provisioning:
    def __init__(self, catalog, pool_labels: dict, ignore_pod_slots: bool = False):
        self.catalog = catalog
        self.pool_labels = dict(pool_labels)
        offered = np.array([any(o[2] for o in offs) for offs in catalog.offerings], dtype=bool)
        self.res = np.where(offered[:, None], catalog.allocatable, -np.inf)
        if ignore_pod_slots:
            self.res[offered, 2] = np.inf
        # the types' resources less those another type dominates: a need
        # fits some type iff it fits one of these rows
        rows = np.unique(self.res[offered], axis=0)
        self.frontier = rows[[i for i, r in enumerate(rows)
                              if not ((rows >= r).all(1) & (rows > r).any(1)).any()]]

    def solve(self, pods: list) -> dict:
        """pods: [Pod] -> {"claims": [(uids, type names, requirements)],
        "errors": [uid], "joins": []}, each list sorted."""
        order = sorted(pods, key=lambda p: (-p.cpu, -p.mem, p.ts, p.uid))
        n = len(order)
        need = np.zeros((n, 3), dtype=np.float64)
        members: list = []
        claim_order = np.zeros(0, dtype=np.int64)
        errors = []
        REQ = np.array([(p.cpu, p.mem, 1.0) for p in order], dtype=np.float64).reshape(n, 3)
        for i, p in enumerate(order):
            req = REQ[i]
            if members:
                claim_order = claim_order[np.argsort(need[claim_order, 2], kind="stable")]
                hit = np.flatnonzero(_fits(need[claim_order] + req, self.frontier))
                if hit.size:
                    c = int(claim_order[hit[0]])
                    need[c] += req
                    members[c].append(p.uid)
                    continue
            if _fits(req[None, :], self.frontier)[0]:
                c = len(members)
                need[c] = req
                members.append([p.uid])
                claim_order = np.append(claim_order, c)
            else:
                errors.append(p.uid)
        reqs = tuple(sorted((k, False, (v,), None, None, None) for k, v in self.pool_labels.items()))
        claims = []
        for c, uids in enumerate(members):
            ok = ((need[c] <= self.res + EPS) | (need[c] <= 0)).all(1)
            names = tuple(sorted(self.catalog.names[t] for t in np.flatnonzero(ok)))
            claims.append((tuple(sorted(uids)), names, reqs))
        return {"claims": sorted(claims), "errors": sorted(errors), "joins": []}
