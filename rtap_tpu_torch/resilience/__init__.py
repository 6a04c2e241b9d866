"""rtap_tpu_torch.resilience — the port of the JAX package's one-process
resilience layer: retry/circuit-breaker policies for the serve stack's IO
edges (policies.py), the load-shedding ladder (degrade.py), seeded fault
injection at the loop's seams (chaos.py, ``serve --chaos-spec``), the
per-tick write-ahead journal (journal.py) and the restart supervisor
(supervisor.py, ``serve --supervise``). Group quarantine and restore live
in service/loop.py. Replication, leases and the control plane are not
ported yet (ROADMAP M5)."""

from rtap_tpu_torch.resilience.chaos import (
    FAULT_KINDS,
    GENERATED_KINDS,
    PROC_EXIT_CODE,
    ChaosEngine,
    ChaosError,
    ChaosSpec,
    Fault,
)
from rtap_tpu_torch.resilience.degrade import LADDER, DegradationController
from rtap_tpu_torch.resilience.journal import TickJournal, parse_fsync
from rtap_tpu_torch.resilience.policies import CircuitBreaker, Retry
from rtap_tpu_torch.resilience.supervisor import (
    BUDGET_EXHAUSTED_RC,
    Supervisor,
    strip_supervise_flags,
)

__all__ = [
    "BUDGET_EXHAUSTED_RC",
    "FAULT_KINDS",
    "GENERATED_KINDS",
    "LADDER",
    "PROC_EXIT_CODE",
    "ChaosEngine",
    "ChaosError",
    "ChaosSpec",
    "CircuitBreaker",
    "DegradationController",
    "Fault",
    "Retry",
    "Supervisor",
    "TickJournal",
    "parse_fsync",
    "strip_supervise_flags",
]
