"""Discrete-event cluster simulation for the IGTCache evaluation (§5).

Replaces the paper's physical testbed with a virtual-clock model calibrated
to its measured constants (150 ms S3 latency, 1 Gbps remote link, 4 MB
blocks).  Jobs, datasets and arrival process follow Table 3 (scaled ~10×
down, as the paper itself does for the allocation study).

Counterpart of ``repro.sim``, line for line: the simulator runs on the host,
drives the port's own cache kernel (``repro_torch.core``) and, seeded alike,
gives the reference's ``SimResult`` to the bit."""
from .chaos import ChaosMonkey, ChaosSchedule, ChaosStrike, plan_strikes
from .cluster import ClusterSim, LinkExecutor, SimResult
from .link import SharedLink
from .workloads import (Job, WorkloadSuite, make_paper_suite, make_datasets)

__all__ = ["ChaosMonkey", "ChaosSchedule", "ChaosStrike", "ClusterSim",
           "Job", "LinkExecutor", "SharedLink", "SimResult",
           "WorkloadSuite", "make_datasets", "make_paper_suite",
           "plan_strikes"]
