"""Which process leads: the counterpart of the JAX package's
``runtime/distributed.py::is_coordinator``, over ``torch.distributed``."""

from __future__ import annotations

from ditl_tpu_torch.utils.logging import _process_index

__all__ = ["is_coordinator"]


def is_coordinator() -> bool:
    """True on rank 0 of the ``torch.distributed`` process group, and in a
    process with no group up (one process is its own coordinator)."""
    return _process_index() == 0
