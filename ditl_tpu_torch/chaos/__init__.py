"""The fault plane (``plane.py``): deterministic, seed-driven fault
injection consulted at instrumented seams. Stdlib only."""

from ditl_tpu_torch.chaos.plane import (
    ACTIONS,
    CORRUPT_SITES,
    SITES,
    STEP_SITES,
    Fault,
    FaultPlane,
    FaultRule,
    InjectedFault,
    arm,
    arm_chaos,
    disarm,
    get_plane,
    injected_summary,
    maybe_inject,
    parse_rules,
)

__all__ = [
    "ACTIONS",
    "CORRUPT_SITES",
    "SITES",
    "STEP_SITES",
    "Fault",
    "FaultPlane",
    "FaultRule",
    "InjectedFault",
    "arm",
    "arm_chaos",
    "disarm",
    "get_plane",
    "injected_summary",
    "maybe_inject",
    "parse_rules",
]
