"""pass_ms_p50.churn: the median, in ms, of the traced run's passes, from
arrivals to decisions (beside pass_ms_p95's tail)."""

from benchmark.harness.stats import percentile


def read(run):
    return percentile([u[0] for u in run.units], 50) * 1e3
