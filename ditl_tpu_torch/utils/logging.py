"""Rank-gated logging: processes other than rank 0 log only WARNING and above
unless ``all_processes=True``. The rank comes from ``torch.distributed`` when
a process group is up, else 0."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s - %(levelname)s - [p%(process_index)s] %(name)s - %(message)s"
_handler: logging.Handler | None = None


class _ProcessIndexFilter(logging.Filter):
    """Stamps the rank on every record (read at emit time: the process group
    may come up after logging is configured)."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.process_index = _process_index()
        return True


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def setup_logging(level: str = "INFO", all_processes: bool = False) -> None:
    """Configure root logging; re-entrant (replaces only its own handler)."""
    global _handler
    effective = level.upper()
    if not all_processes and _process_index() != 0:
        effective = "WARNING"
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    handler.addFilter(_ProcessIndexFilter())
    root = logging.getLogger()
    if _handler is not None and _handler in root.handlers:
        root.removeHandler(_handler)
    root.addHandler(handler)
    root.setLevel(effective)
    _handler = handler


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)
