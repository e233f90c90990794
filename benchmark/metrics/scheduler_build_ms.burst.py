"""scheduler_build_ms.burst: ms per solve building the Topology and the
Scheduler over the batch (the loop's span `scheduler_build`)."""


def read(run):
    spans = run.tracer.spans.get("scheduler_build")
    return sum(b - a for a, b in spans) / len(spans) * 1e3 if spans else None
