"""dispatches_per_solve.burst: named device dispatches per solve, as the
program's KernelRegistry.batch_scope counts them around each timed solve."""


def read(run):
    counts = run.tracer.records.get("dispatches")
    return sum(counts) / len(counts) if counts else None
