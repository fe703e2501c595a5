"""Tokenizers: the byte-level tokenizer (vocab 256 + 3 specials), with the
same ids and the same surface as the JAX package's ``data/tokenizer.py``
(``vocab_size``, ``encode``, ``decode``, ``pad_id``, ``bos_id``,
``eos_id``). Hugging Face tokenizers wait for the HF checkpoint import."""

from __future__ import annotations

from typing import Protocol, Sequence

from ditl_tpu_torch.utils.logging import get_logger

__all__ = ["Tokenizer", "ByteTokenizer", "check_vocab", "get_tokenizer"]


class Tokenizer(Protocol):
    vocab_size: int
    pad_id: int
    bos_id: int
    eos_id: int

    def encode(self, text: str) -> list[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes shifted by the number of special tokens."""

    def __init__(self):
        self.pad_id = 0
        self.bos_id = 1
        self.eos_id = 2
        self.byte_offset = 3  # id of byte b is b + byte_offset
        self.vocab_size = 256 + self.byte_offset

    def encode(self, text: str) -> list[int]:
        return [b + self.byte_offset for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        # Specials and ids past the byte table (a head wider than the
        # tokenizer) decode to nothing.
        data = bytes(
            i - self.byte_offset
            for i in ids
            if self.byte_offset <= i < self.byte_offset + 256
        )
        return data.decode("utf-8", errors="replace")


def check_vocab(tokenizer: Tokenizer, model_vocab: int, where: str) -> None:
    """A tokenizer wider than the model head is an error (ids the embedding
    cannot hold); a head wider than the tokenizer is padding and only logs."""
    tv = tokenizer.vocab_size
    if tv > model_vocab:
        raise ValueError(
            f"{where}: tokenizer vocab {tv} exceeds the model's "
            f"{model_vocab} — prompts could contain ids the embedding "
            f"table does not have"
        )
    if tv < model_vocab:
        get_logger(__name__).info(
            "%s: model head (%d) wider than tokenizer (%d): padded/"
            "reserved rows; out-of-table ids are skipped on decode",
            where, model_vocab, tv,
        )


def get_tokenizer(name: str = "byte") -> Tokenizer:
    if name == "byte":
        return ByteTokenizer()
    raise NotImplementedError(
        f"tokenizer {name!r}: Hugging Face tokenizers come with the HF checkpoint "
        "import, not ported to PyTorch yet (see ROADMAP.md)"
    )
