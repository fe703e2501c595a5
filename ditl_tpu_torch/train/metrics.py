"""Step metrics: the log line and the run summary.

Counterpart of the JAX package's ``train/metrics.py`` (``MetricsLogger``).
The step's metrics stay on the device until a ``log_every`` boundary; the
flush copies every pending step's metrics to the host in one transfer, logs
the newest (loss, grad_norm, step time, tokens/s per chip), optionally
writes one JSONL row per step, and raises on a non-finite loss or gradient
norm. The summary gives ``step_time_p50_s`` and
``tokens_per_sec_per_chip_p50`` over the steps after the first (its time
includes the first call's set-up).

Step time. PyTorch issues the step's work asynchronously, like JAX; a step's
wall time here runs from ``start_step`` to the end of ``end_step``, which
includes the flush when the step is on a ``log_every`` boundary. With
``log_every=1`` every step waits for its device work, so the times are the
device-inclusive step times; with a larger interval the flushing step
absorbs the backlog, as in the reference.
"""

from __future__ import annotations

import json
import math
import statistics
import time
from typing import Any

import torch

from ditl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["MetricsLogger", "NonFiniteMetricError"]


class NonFiniteMetricError(FloatingPointError):
    """A flushed step's loss or gradient norm is NaN or infinite."""


class MetricsLogger:
    def __init__(self, log_every: int = 10, metrics_file: str = ""):
        self.log_every = max(1, log_every)
        self.step_times: list[float] = []
        self.tokens_per_sec_chip: list[float] = []
        self.history: list[dict[str, float]] = []  # every flushed step, on the host
        self._t0: float | None = None
        self._pending: list[tuple[int, dict]] = []
        self._dts: dict[int, float] = {}
        self._fh = open(metrics_file, "a", buffering=1) if metrics_file else None

    def start_step(self) -> None:
        self._t0 = time.perf_counter()

    def end_step(self, step: int, device_metrics: dict[str, Any]) -> None:
        """Stash the step's device metrics and take its time; on a
        ``log_every`` boundary the copy to the host comes first, so the
        time includes it."""
        self._pending.append((step, device_metrics))
        rows = self._sync() if step % self.log_every == 0 else None
        if self._t0 is not None:
            self._dts[step] = time.perf_counter() - self._t0
            self.step_times.append(self._dts[step])
            self._t0 = None
        if rows is not None:
            self._emit(rows)

    def flush(self) -> None:
        self._emit(self._sync())

    def _sync(self) -> list[tuple[int, dict[str, float]]]:
        """One device-to-host copy for every pending step's metrics."""
        if not self._pending:
            return []
        keys = ("loss", "n_tokens", "grad_norm")
        values = torch.stack([
            torch.stack([m[k].detach().float().reshape(()) for k in keys])
            for _, m in self._pending]).cpu().tolist()
        rows = [(step, dict(zip(keys, v))) for (step, _), v in zip(self._pending, values)]
        self._pending.clear()
        return rows

    def _emit(self, rows: list[tuple[int, dict[str, float]]]) -> None:
        for step, host in rows:
            dt = self._dts.pop(step, None)
            tps = host["n_tokens"] / dt if dt else float("nan")  # one chip
            if dt:
                self.tokens_per_sec_chip.append(tps)
            self.history.append({"step": step, **host})
            if self._fh is not None:
                row = {"step": step, **{k: round(v, 6) for k, v in host.items()}}
                if dt:
                    row.update(step_time_s=round(dt, 6), tokens_per_sec_per_chip=round(tps, 2))
                self._fh.write(json.dumps(row, sort_keys=True) + "\n")
        if rows:
            step, host = rows[-1]
            dt = self.step_times[-1] if self.step_times else float("nan")
            logger.info(
                "step %d: loss=%.4f grad_norm=%.3f step_time=%.3fs tokens/sec/chip=%.1f",
                step, host["loss"], host["grad_norm"], dt,
                host["n_tokens"] / dt if dt > 0 else float("nan"))
        for step, host in rows:
            if not (math.isfinite(host["loss"]) and math.isfinite(host["grad_norm"])):
                raise NonFiniteMetricError(
                    f"non-finite training metric at step {step}: "
                    f"loss={host['loss']} grad_norm={host['grad_norm']}")

    def close(self) -> None:
        try:
            self.flush()
        finally:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def summary(self) -> dict[str, float]:
        """p50 over the steps after the first."""
        times = self.step_times[1:] if len(self.step_times) > 1 else self.step_times
        tps = (self.tokens_per_sec_chip[1:] if len(self.tokens_per_sec_chip) > 1
               else self.tokens_per_sec_chip)
        out: dict[str, float] = {}
        if times:
            out["step_time_p50_s"] = statistics.median(times)
        if tps:
            out["tokens_per_sec_per_chip_p50"] = statistics.median(tps)
        return out
