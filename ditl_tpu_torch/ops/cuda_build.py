"""Build the port's CUDA sources into shared libraries and load them.

Each library is one ``nvcc`` call for ``sm_90a`` into a shared object with a
plain C interface, loaded with ``ctypes``. Builds land in
``ditl_tpu_torch/_build/`` (git-ignored), keyed by a hash of the source, the
shared headers (``csrc/*.cuh``), the flags and the compiler, and are re-used
while that hash is unchanged. A
failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build_library",
           "build_libraries", "load_library"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the log
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def build_library(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a build with the same hash exists;
    returns the shared object's path. The compiler's log is kept beside it
    (``.log``)."""
    src = CSRC / source
    nvcc = find_nvcc()
    key = hashlib.sha256()
    key.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    key.update(nvcc.encode())
    out = BUILD_DIR / f"{src.stem}-{key.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a temporary name and rename: a concurrent builder (another
    # process of the same checkout) never loads a half-written file.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True, timeout=600,
        )
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src} (exit {proc.returncode}):\n{log}"
            )
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_libraries(sources: list[str] | None = None) -> dict[str, Path]:
    """Build several sources at once (default: every ``csrc/*.cu``), one
    ``nvcc`` process each, all started together; raises on the first
    failure after every build has ended."""
    from concurrent.futures import ThreadPoolExecutor

    names = sources or sorted(p.name for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(build_library, name) for name in names}
    return {name: fut.result() for name, fut in futures.items()}


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``, once per process."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(source)))
            _loaded[source] = lib
        return lib
