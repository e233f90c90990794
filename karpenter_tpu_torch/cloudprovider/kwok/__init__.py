"""kwok-equivalent provider: fabricates Nodes directly (no kubelet), the
in-tree correctness and benchmark harness (reference kwok/)."""
