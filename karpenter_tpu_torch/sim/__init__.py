"""karpenter_tpu_torch.sim — deterministic trace-driven cluster simulator.

Replays a workload trace through the REAL control loop (provisioner →
solverd → kwok create → binding → disruption → termination) on virtual
time, with fault injection and cost/SLO accounting. See
docs/ARCHITECTURE.md ("Simulator") and `python -m karpenter_tpu_torch.sim --list`.
"""

from karpenter_tpu_torch.sim.events import EventLog
from karpenter_tpu_torch.sim.faults import (
    FaultyCloudProvider,
    FlakySolverClient,
    interrupt,
)
from karpenter_tpu_torch.sim.harness import SimResult, Simulation, build_pod, run_scenario

__all__ = [
    "EventLog",
    "FaultyCloudProvider",
    "FlakySolverClient",
    "SimResult",
    "Simulation",
    "build_pod",
    "interrupt",
    "run_scenario",
]
