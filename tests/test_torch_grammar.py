"""Port parity: the grammar compiler (``infer/grammar.py``) and the native
token-table builder (``csrc/fsm.cpp`` through ``native/fsm.py``).

The port keeps its own copies of these jax-free modules: their text must be
the JAX package's but for the line that names the native bridge, and the
tables they compile must be the reference's exactly (``token_next``,
``accept`` and the byte-level DFA) for regexes, JSON at depths 1-3 and JSON
schemas, over the byte tokenizer and over a seeded multi-byte vocabulary.
The native builder must give the numpy walk's table (its plain version)
bit for bit.
"""

import ctypes
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer import grammar as JG  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer import grammar as G  # noqa: E402
from ditl_tpu_torch.native import build as native_build  # noqa: E402
from ditl_tpu_torch.native import fsm as native_fsm  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

REGEXES = [r"[0-9]{3}-[0-9]{4}", r"(yes|no)", r"[a-z ]{1,30}", r"-?[0-9]{1,6}",
           r"(foo|bar){1,4}", r"\d+\.\d{2}", r"(a|b)*c", r"é+", r"[^,]{2,5},?",
           r"\w{2,5}@\w{3}\.(com|org)"]
SCHEMAS = [
    {"enum": ["red", "green", "blue"]},
    {"type": "integer", "minimum": -5, "maximum": 120},
    {"type": "string", "pattern": "^[a-z]{2,4}$"},
    {"type": "string", "minLength": 1, "maxLength": 6},
    {"type": "array", "items": {"type": "boolean"}, "minItems": 1, "maxItems": 3},
    {"type": "object", "properties": {
        "n": {"type": "integer", "minimum": 0, "maximum": 99},
        "u": {"anyOf": [{"const": "a"}, {"const": "b"}]}},
     "required": ["n", "u"], "additionalProperties": False},
    {"type": "object", "properties": {
        "name": {"type": "string", "maxLength": 4}, "ok": {"type": "boolean"},
        "tag": {"enum": ["x", "y"]}},
     "required": ["name"], "additionalProperties": False},
]


class SeededVocab:
    """A subword-style tokenizer: specials 0-2, then ``n`` byte strings of 1-4
    bytes drawn from a seed (every single printable byte among them, so
    grammars stay completable), exposed through ``decode`` only, as an HF
    tokenizer without a byte alphabet is."""

    pad_id, bos_id, eos_id = 0, 1, 2

    def __init__(self, seed: int, n: int = 300):
        rng = np.random.default_rng(seed)
        pieces = [bytes([b]) for b in range(0x20, 0x7f)]
        alphabet = np.frombuffer(b"0123456789abcdefxyz -.,:{}[]\"", np.uint8)
        while len(pieces) < n:
            pieces.append(bytes(rng.choice(alphabet, rng.integers(2, 5))))
        self.pieces = [b"", b"", b""] + pieces
        self.vocab_size = len(self.pieces)

    def decode(self, ids):
        return b"".join(self.pieces[i] for i in ids).decode("utf-8", "replace")


@pytest.mark.parametrize("port,ref,changed", [
    ("ditl_tpu_torch/infer/grammar.py", "ditl_tpu/infer/grammar.py",
     ("    from ditl_tpu.native.fsm import token_table_native",
      "    from ditl_tpu_torch.native.fsm import token_table_native")),
    ("ditl_tpu_torch/native/fsm.py", "ditl_tpu/native/fsm.py",
     ("from ditl_tpu.native.build import NativeLib",
      "from ditl_tpu_torch.native.build import NativeLib")),
    ("ditl_tpu_torch/csrc/fsm.cpp", "csrc/fsm.cpp",
     ("// Plain C ABI for ctypes (ditl_tpu/native/fsm.py) — no pybind11 by design.",
      "// Plain C ABI for ctypes (ditl_tpu_torch/native/fsm.py) — no pybind11 by design.")),
])
def test_copies_equal_the_reference_but_one_line(port, ref, changed):
    ours = (ROOT / port).read_text().splitlines()
    theirs = (ROOT / ref).read_text().splitlines()
    assert len(ours) == len(theirs)
    diff = [(a, b) for a, b in zip(theirs, ours) if a != b]
    assert diff == [changed]


def _tables_equal(ours, ref):
    assert ours.token_next.dtype == ref.token_next.dtype == np.int32
    np.testing.assert_array_equal(ours.token_next, ref.token_next)
    np.testing.assert_array_equal(ours.accept, ref.accept)
    np.testing.assert_array_equal(ours.byte_next, ref.byte_next)
    assert ours.source == ref.source


@pytest.mark.parametrize("pattern", REGEXES)
def test_regex_tables_equal_the_reference(pattern):
    _tables_equal(G.compile_regex(pattern, ByteTokenizer()),
                  JG.compile_regex(pattern, JaxByteTokenizer()))


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("top", ["object", "value"])
def test_json_tables_equal_the_reference(depth, top):
    _tables_equal(G.compile_json(ByteTokenizer(), max_depth=depth, top=top),
                  JG.compile_json(JaxByteTokenizer(), max_depth=depth, top=top))


@pytest.mark.parametrize("schema", SCHEMAS, ids=lambda s: str(s)[:40])
def test_schema_tables_equal_the_reference(schema):
    _tables_equal(G.compile_json_schema(schema, ByteTokenizer()),
                  JG.compile_json_schema(schema, JaxByteTokenizer()))


@pytest.mark.parametrize("seed", [0, 1])
def test_multibyte_vocab_tables_equal_the_reference(seed):
    """Tokens of several bytes walk the byte DFA (the native builder's inner
    loop); the token strings come from ``decode``, the reference's
    fallback."""
    tok = SeededVocab(seed)
    assert G.token_strings(tok) == JG.token_strings(tok)
    for pattern in (r"[0-9]{2,8}", r"(abc|xyz)+ ?-?[0-9]{1,3}"):
        _tables_equal(G.compile_regex(pattern, tok), JG.compile_regex(pattern, tok))
    _tables_equal(G.compile_json(tok, max_depth=2), JG.compile_json(tok, max_depth=2))


def _numpy_walk(monkeypatch, build):
    """``build()`` with the native builder switched off: ``_token_table``'s
    numpy walk."""
    with monkeypatch.context() as m:
        m.setattr(native_fsm, "token_table_native", lambda byte_next, toks: None)
        return build()


@pytest.mark.parametrize("case", ["regex", "json", "schema", "multibyte"])
def test_native_builder_equals_the_numpy_walk(monkeypatch, case):
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native builder cannot be built here")
    assert native_fsm.available()
    tok = SeededVocab(3) if case == "multibyte" else ByteTokenizer()
    build = {
        "regex": lambda: G.compile_regex(r"\w{2,5}@\w{3}\.(com|org)", tok),
        "json": lambda: G.compile_json(tok, max_depth=3),
        "schema": lambda: G.compile_json_schema(SCHEMAS[5], tok),
        "multibyte": lambda: G.compile_regex(r"(abc|xyz)+ ?-?[0-9]{1,3}", tok),
    }[case]
    _tables_equal(build(), _numpy_walk(monkeypatch, build))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_token_table_on_a_random_dfa(seed):
    """``token_table_native`` on a seeded random byte DFA (dead edges
    included) and random tokens (empty ones included) against a direct
    walk: each (state, token) pair's end state, -1 once a byte is dead and
    for empty tokens."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native builder cannot be built here")
    rng = np.random.default_rng(seed)
    n_states = 17
    byte_next = rng.integers(-1, n_states, size=(n_states, 256)).astype(np.int32)
    byte_next[rng.random((n_states, 256)) < 0.5] = -1
    toks = [bytes(rng.integers(0, 256, rng.integers(0, 5)).astype(np.uint8))
            for _ in range(200)]
    got = native_fsm.token_table_native(byte_next, toks)
    want = np.full((n_states, len(toks)), -1, np.int32)
    for s in range(n_states):
        for v, t in enumerate(toks):
            st = s
            for b in t:
                st = int(byte_next[st, b])
                if st < 0:
                    break
            want[s, v] = st if t else -1
    np.testing.assert_array_equal(got, want)


def test_native_build_is_keyed_by_source_in_the_ignored_build_dir():
    """The shared object lands in ``ditl_tpu_torch/_build/`` (git-ignored),
    named by a hash of the source, flags and compiler; a second library
    object of the same source names and loads the same file."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++: the native builder cannot be built here")
    lib = native_build.NativeLib("fsm", lambda cdll: None)
    assert lib.src == ROOT / "ditl_tpu_torch" / "csrc" / "fsm.cpp"
    so = lib._so_path(cxx)
    assert so.parent == ROOT / "ditl_tpu_torch" / "_build"
    assert re.fullmatch(r"libfsm-[0-9a-f]{16}\.so", so.name)
    assert isinstance(lib.get(), ctypes.CDLL) and so.is_file()
    again = native_build.NativeLib("fsm", lambda cdll: None)
    assert again._so_path(cxx) == so and again.available()
    assert "ditl_tpu_torch/_build/" in (ROOT / ".gitignore").read_text().splitlines()


def test_missing_source_falls_back(tmp_path, monkeypatch):
    """No source (or no toolchain): ``get()`` is None, once, and the caller
    takes the numpy walk."""
    monkeypatch.setattr(native_build, "CSRC", tmp_path)
    lib = native_build.NativeLib("nothing", lambda cdll: None)
    assert lib.get() is None and not lib.available()
