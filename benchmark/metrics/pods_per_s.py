"""pods_per_s: pods given a decision (a NodeClaim, an existing node or an
error) over the whole window: every timed solve's pods over the sum of the
timed solves' seconds (upstream's MinPodsPerSec)."""

from benchmark.harness.stats import rate


def read(run):
    return rate(sum(u[1] for u in run.units), sum(u[0] for u in run.units))
