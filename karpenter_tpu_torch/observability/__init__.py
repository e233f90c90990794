"""Observability: the decision provenance ledger (explain.py)."""
