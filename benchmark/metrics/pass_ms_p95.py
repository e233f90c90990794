"""pass_ms_p95: the 95th percentile, in ms, of every timed pass's seconds
from its arrivals to its decisions."""

from benchmark.harness.stats import percentile


def read(run):
    return percentile([u[0] for u in run.units], 95) * 1e3
