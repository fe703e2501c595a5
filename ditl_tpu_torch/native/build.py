"""Build-on-first-use scaffold for the port's C++ host components.

The port's copy of the JAX package's ``native/build.py``: one ``g++ -O3
-shared -fPIC`` call per component, an atomic replace, and a
double-checked-locking loader. Two things differ: the shared object goes into
the git-ignored ``ditl_tpu_torch/_build/`` beside the CUDA builds, named by a
hash of the source, the flags and the compiler (as ``ops/cuda_build.py`` keys
its builds), so a changed source always rebuilds; and the source is the
port's own ``ditl_tpu_torch/csrc/<name>.cpp``. No pip or pybind11 (plain
``ctypes``); every caller keeps a pure-Python/numpy fallback, so a machine
without a toolchain still runs."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

from ditl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["NativeLib", "BUILD_DIR", "CXX_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


class NativeLib:
    """Lazily builds ``csrc/<name>.cpp`` into ``_build/lib<name>-<hash>.so``
    and loads it, registering ctypes signatures via ``register``. ``get()``
    returns the CDLL or None (build/toolchain failure — caller falls back);
    the outcome is cached either way."""

    def __init__(self, name: str, register: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.src = CSRC / f"{name}.cpp"
        self._register = register
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._tried = False

    def _so_path(self, cxx: str) -> Path:
        key = hashlib.sha256(self.src.read_bytes())
        key.update(" ".join(CXX_FLAGS).encode())
        key.update(cxx.encode())
        return BUILD_DIR / f"lib{self.name}-{key.hexdigest()[:16]}.so"

    def _build_and_load(self) -> ctypes.CDLL | None:
        if not self.src.is_file():
            logger.warning("native %s source missing at %s", self.name, self.src)
            return None
        cxx = shutil.which("g++")
        if cxx is None:
            logger.warning("native %s: no g++ on PATH; using Python path", self.name)
            return None
        so = self._so_path(cxx)
        if not so.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(so.name + f".tmp.{os.getpid()}")
            cmd = [cxx, *CXX_FLAGS, str(self.src), "-o", str(tmp)]
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)  # atomic: concurrent builders don't corrupt
                logger.info("built native %s: %s", self.name, so)
            except (subprocess.SubprocessError, OSError) as e:
                logger.warning(
                    "native %s build failed (%s); using Python path", self.name, e
                )
                if tmp.exists():
                    tmp.unlink()
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            logger.warning(
                "native %s load failed (%s); using Python path", self.name, e
            )
            return None
        self._register(lib)
        return lib

    def get(self) -> ctypes.CDLL | None:
        if self._lib is None and not self._tried:
            with self._lock:
                if self._lib is None and not self._tried:
                    self._lib = self._build_and_load()
                    self._tried = True
        return self._lib

    def available(self) -> bool:
        return self.get() is not None
