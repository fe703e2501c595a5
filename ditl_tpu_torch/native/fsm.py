"""ctypes bridge to the C++ grammar-table builder (csrc/fsm.cpp).

Build-on-first-use via native/build.NativeLib; falls back to the numpy walk
in infer/grammar.py when no toolchain is available. The walk is
O(states x vocab x token_len); on a 32k-vocab tokenizer the C++ path keeps
grammar registration interactive (tens of ms instead of seconds).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ditl_tpu_torch.native.build import NativeLib

__all__ = ["available", "token_table_native"]

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _register(lib: ctypes.CDLL) -> None:
    lib.fsm_token_table.restype = None
    lib.fsm_token_table.argtypes = [
        _i32p, ctypes.c_int64, _u8p, _i64p, ctypes.c_int64, _i32p,
    ]


_LIB = NativeLib("fsm", _register)


def available() -> bool:
    return _LIB.available()


def token_table_native(
    byte_next: np.ndarray, toks: list[bytes]
) -> np.ndarray | None:
    """(S, 256) byte DFA + per-token byte strings -> (S, V) token table,
    or None when the native library is unavailable (caller falls back to
    the vectorized numpy walk). Zero-byte tokens come back -1 (disallowed)."""
    lib = _LIB.get()
    if lib is None:
        return None
    byte_next = np.ascontiguousarray(byte_next, np.int32)
    n_states = byte_next.shape[0]
    offsets = np.zeros(len(toks) + 1, np.int64)
    np.cumsum([len(t) for t in toks], out=offsets[1:])
    blob = np.frombuffer(b"".join(toks), np.uint8)
    if blob.size == 0:
        blob = np.zeros(1, np.uint8)  # ctypes needs a real pointer
    out = np.empty((n_states, len(toks)), np.int32)
    lib.fsm_token_table(
        byte_next, n_states, np.ascontiguousarray(blob), offsets, len(toks), out
    )
    return out
