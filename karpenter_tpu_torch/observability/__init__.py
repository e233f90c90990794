"""Observability: the decision provenance ledger (explain.py), the kernel
observatory (kernels.py), the SLO burn-rate engine (slo.py), the flight
recorder (flight.py) and the efficiency observatory (efficiency.py) — the
reference's modules, the device parts read from CUDA (see each module)."""
