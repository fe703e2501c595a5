"""Checkpoint and exact resume, with the reference's crash-consistency layer.

Counterpart of the JAX package's ``train/checkpoint.py``, with torch's
serialization in place of Orbax. A step is a directory ``<dir>/<step>/``
holding ``params.pt`` (the masters), ``opt_state.pt`` (the optimizer
state), ``meta.json`` (the step and the data position, ``DataIterState``)
and, written last, ``ditl_manifest.json``: size and crc32 of every other
file. Serving reads ``params.pt`` alone, so the optimizer state is never
read off storage for it.

- ``save`` copies the state to the host at the step boundary, before it
  returns (the optimizer updates the masters in place, so the next step
  must not start before the copy is done), and writes the files on a
  thread: into ``<step>.ditl-checkpoint-tmp-*``, each file flushed to
  storage, manifest last, then one rename into place. Saves run one at a
  time; ``keep_checkpoints`` prunes the oldest steps after each.
- ``restore_latest`` / ``restore_latest_params`` verify the newest step
  against its manifest first. A corrupt step (a file missing, resized or
  with another checksum) is moved whole into ``<dir>/quarantine/``, never
  deleted, as are leftover temporary directories of a save that died; then
  the newest step that verifies is restored. A step whose bytes verify but
  whose load fails (another model config) raises: falling back would
  silently restore an older state than asked for. A step without a
  manifest is "legacy": it restores if it loads, else it is quarantined.

The reference's fault-drill hooks (``chaos``) and event journal are not
ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any

import torch

from ditl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["CheckpointManager", "DataIterState", "MANIFEST_NAME"]

MANIFEST_NAME = "ditl_manifest.json"
_TMP_MARK = ".ditl-checkpoint-tmp-"


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _write_durable(path: str, write) -> None:
    """``write(file)`` into a new file at ``path``, flushed to storage."""
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    """Make the renames inside directory ``path`` durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@dataclasses.dataclass
class DataIterState:
    epoch: int = 0
    step_in_epoch: int = 0
    global_step: int = 0


def _tree_paths(tree, path: str = "") -> dict[str, tuple[int, ...]]:
    """``{path: shape}`` of every tensor in a nested dict."""
    if isinstance(tree, dict):
        out: dict = {}
        for k, v in tree.items():
            out.update(_tree_paths(v, f"{path}/{k}"))
        return out
    return {path: tuple(tree.shape)}


class CheckpointManager:
    """Save, prune, verify and restore training checkpoints under
    ``directory`` (module docstring)."""

    def __init__(self, directory: str, max_to_keep: int = 3, save_every: int = 0):
        self.directory = str(directory)
        self.max_to_keep = max_to_keep
        self.save_every = save_every
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def should_save(self, step: int, n_advanced: int = 1) -> bool:
        """True if the last ``n_advanced`` steps ending at ``step`` crossed a
        save boundary."""
        return (self.save_every > 0 and step > 0
                and (step // self.save_every) > ((step - n_advanced) // self.save_every))

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _list_steps(self) -> list[int]:
        """Committed step directories, newest first, read from disk."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted((int(n) for n in names if n.isdigit()), reverse=True)

    # -- save ----------------------------------------------------------------

    def save(self, step: int, state, data_iter: DataIterState) -> None:
        """Copy ``state`` (a ``TrainState``) to the host now and write it as
        step ``step`` on a thread."""
        from ditl_tpu_torch.train.state import tree_to

        self.wait()
        host = tree_to(state.state_dict(), "cpu")  # blocks until copied
        meta = {"step": int(state.step), "data_iter": dataclasses.asdict(data_iter)}
        self._thread = threading.Thread(target=self._write, args=(step, host, meta),
                                        name="ckpt-save", daemon=True)
        self._thread.start()
        logger.info("checkpoint save queued at step %d", step)

    def _write(self, step: int, host: dict, meta: dict) -> None:
        try:
            os.makedirs(self.directory, exist_ok=True)
            tmp = os.path.join(self.directory,
                               f"{step}{_TMP_MARK}{os.getpid()}-{time.time_ns()}")
            os.makedirs(tmp)
            _write_durable(os.path.join(tmp, "params.pt"),
                           lambda f: torch.save(host["params"], f))
            _write_durable(os.path.join(tmp, "opt_state.pt"),
                           lambda f: torch.save(host["opt_state"], f))
            _write_durable(os.path.join(tmp, "meta.json"),
                           lambda f: f.write(json.dumps(meta, sort_keys=True).encode()))
            self._write_manifest(tmp, step)
            final = self._step_path(step)
            old = None
            if os.path.exists(final):  # a re-save of the same step replaces it
                old = f"{final}{_TMP_MARK}old-{time.time_ns()}"
                os.rename(final, old)
            os.rename(tmp, final)
            _fsync_dir(self.directory)
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
            self._prune()
            logger.info("checkpoint committed at step %d", step)
        except BaseException as e:  # surfaced by the next wait()
            self._error = e

    def _write_manifest(self, d: str, step: int) -> None:
        files = {}
        for root, _dirs, names in os.walk(d):
            for name in names:
                path = os.path.join(root, name)
                files[os.path.relpath(path, d)] = {"size": os.path.getsize(path),
                                                   "crc32": _file_crc32(path)}
        tmp = os.path.join(d, f"{MANIFEST_NAME}.tmp")
        manifest = json.dumps({"step": step, "files": files}, sort_keys=True).encode()
        _write_durable(tmp, lambda f: f.write(manifest))
        os.replace(tmp, os.path.join(d, MANIFEST_NAME))
        _fsync_dir(d)

    def _prune(self) -> None:
        if self.max_to_keep and self.max_to_keep > 0:
            for step in self._list_steps()[self.max_to_keep:]:
                shutil.rmtree(self._step_path(step), ignore_errors=True)

    def wait(self) -> None:
        """Block until the last save is on disk; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def close(self) -> None:
        """Wait for the last save; its error is logged, not raised (close
        runs on the way out of a failing run too; ``wait`` raises)."""
        try:
            self.wait()
        except RuntimeError:
            logger.exception("checkpoint save failed during close")

    # -- crash consistency -----------------------------------------------------

    def verify_step(self, step: int) -> str:
        """``"verified"`` (manifest matches), ``"corrupt"`` (a file missing,
        resized or with another checksum, or an unreadable manifest) or
        ``"legacy"`` (no manifest)."""
        d = self._step_path(step)
        mpath = os.path.join(d, MANIFEST_NAME)
        if not os.path.exists(mpath):
            return "legacy"
        try:
            with open(mpath) as f:
                files = json.load(f)["files"]
        except (OSError, ValueError, KeyError, TypeError):
            return "corrupt"
        for rel, m in files.items():
            path = os.path.join(d, rel)
            try:
                if os.path.getsize(path) != m["size"] or _file_crc32(path) != m["crc32"]:
                    return "corrupt"
            except OSError:
                return "corrupt"
        return "verified"

    def quarantine_step(self, step: int, reason: str) -> str | None:
        """Move a torn or corrupt step whole into ``<dir>/quarantine/``."""
        return self._quarantine_path(self._step_path(step), reason)

    def _quarantine_path(self, src: str, reason: str) -> str | None:
        qdir = os.path.join(self.directory, "quarantine")
        dest = os.path.join(qdir, os.path.basename(src.rstrip(os.sep)))
        if os.path.exists(dest):
            dest = f"{dest}.{time.time_ns()}"
        try:
            os.makedirs(qdir, exist_ok=True)
            os.rename(src, dest)
        except OSError:
            return None
        logger.warning("checkpoint quarantined: %s -> %s (%s)", src, dest, reason)
        return dest

    def _sweep_tmp_dirs(self) -> None:
        """Quarantine the temporary directories of saves that died."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            if _TMP_MARK in name:
                self._quarantine_path(os.path.join(self.directory, name),
                                      "torn save (process died mid-write)")

    def _restore_newest_verified(self, restore_fn):
        """Newest to oldest: quarantine corrupt steps, try ``restore_fn(step)``,
        re-raise when verified bytes fail to restore, quarantine legacy
        steps that fail. ``(step, result, fell_back)`` or None."""
        self.wait()
        self._sweep_tmp_dirs()
        fell_back = False
        for step in self._list_steps():
            status = self.verify_step(step)
            if status == "corrupt":
                self.quarantine_step(step, "integrity manifest mismatch")
                fell_back = True
                continue
            try:
                out = restore_fn(step)
            except Exception as e:
                if status == "verified":
                    raise
                self.quarantine_step(step, f"restore failed: {type(e).__name__}: {e}")
                fell_back = True
                continue
            return step, out, fell_back
        return None

    def _load(self, step: int, name: str):
        return torch.load(os.path.join(self._step_path(step), name), map_location="cpu",
                          weights_only=True)

    # -- restore ---------------------------------------------------------------

    def restore_latest(self, state) -> tuple[Any, DataIterState] | None:
        """Load the newest verified step into ``state`` (a fresh
        ``TrainState`` of the same config) in place: masters, optimizer
        state and step, bit for bit. Returns ``(state, data position)``, or
        None when no step restores."""

        def load(step: int):
            with open(os.path.join(self._step_path(step), "meta.json")) as f:
                meta = json.load(f)
            state.load_state_dict({"step": meta["step"],
                                   "params": self._load(step, "params.pt"),
                                   "opt_state": self._load(step, "opt_state.pt")})
            return DataIterState(**meta["data_iter"])

        hit = self._restore_newest_verified(load)
        if hit is None:
            return None
        step, data_iter, fell_back = hit
        logger.info("restored checkpoint at step %d%s", step,
                    " (fell back past quarantined step(s))" if fell_back else "")
        return state, data_iter

    def restore_latest_params(self, cfg, abstract_params: dict | None = None,
                              device: str | torch.device = "cpu",
                              quantize: bool = False) -> dict | None:
        """The newest verified step's masters as the serving tree
        (``models/llama.py::serving_params`` for ``cfg``) on ``device``, read
        from ``params.pt`` alone. ``abstract_params`` (a serving tree, or
        one on the ``meta`` device) is checked against it leaf for leaf, so
        a preset and checkpoint that do not match fail here, loudly.

        ``quantize``: weight-only int8 (``ops/quant.py``) from the masters
        in their own dtype, before the serving cast, as the JAX server
        quantizes its f32 masters: the masters stay on the host and are
        quantized one leaf (and one layer) at a time on ``device``, so the
        card never holds an f32 copy of the model."""
        from ditl_tpu_torch.models.llama import serving_params

        def load(step: int):
            masters = self._load(step, "params.pt")
            if abstract_params is not None:
                expect = _tree_paths(abstract_params)
                got = _tree_paths(serving_params(masters, cfg, "meta"))
                if expect != got:
                    missing = sorted(set(expect) - set(got))
                    extra = sorted(set(got) - set(expect))
                    diff = sorted(k for k in expect.keys() & got.keys()
                                  if expect[k] != got[k])
                    raise ValueError(
                        f"checkpoint at step {step} does not match the model config: "
                        f"missing={missing[:3]} extra={extra[:3]} shape_mismatch="
                        f"{[(k, expect[k], got[k]) for k in diff[:3]]}")
            if quantize:
                from ditl_tpu_torch.ops.quant import quantize_weights

                masters = quantize_weights(masters, tie_embeddings=cfg.tie_embeddings,
                                           device=device)
            return serving_params(masters, cfg, device)

        hit = self._restore_newest_verified(load)
        if hit is None:
            return None
        step, params, _ = hit
        logger.info("restored params (only) from checkpoint at step %d", step)
        return params
