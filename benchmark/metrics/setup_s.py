"""setup_s: seconds from the process's start to the first timed unit:
imports, the catalog and engine, the kernels' load (or build, in a
checkout's first run), the workload and the warm-up units."""


def read(run):
    return run.setup_s
