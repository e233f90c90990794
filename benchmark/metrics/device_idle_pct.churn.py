"""Share of the timed units' time, with the collections they pay for
between them, with no kernel, copy or set on the card, from the
profiler's trace, in %."""


def read(run):
    dt = run.tracer.device
    if dt is None or dt.window_s <= 0 or not dt.ops:
        return None
    return 100.0 * (1.0 - dt.busy_s / dt.window_s)
