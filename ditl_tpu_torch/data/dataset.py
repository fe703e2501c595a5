"""Datasets: a copy of the JAX package's ``data/dataset.py``.

``TextDataset`` is a map-style dataset over parallel ``texts``/``labels``
lists whose items are ``{"text": ..., "label": ...}`` dicts.
``load_text_dataset`` calls ``datasets.load_dataset`` and degrades to the
same deterministic synthetic corpus when the hub is unreachable or
``DataConfig.synthetic`` is set.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ditl_tpu_torch.config import DataConfig
from ditl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["TextDataset", "load_text_dataset", "synthetic_dataset"]

_WORDS = (
    "the a this that movie film plot acting director scene story truly utterly "
    "remarkably painfully good bad great terrible brilliant dull vivid flat "
    "masterpiece disaster delight bore triumph mess loved hated enjoyed endured "
    "recommend avoid rewatch forget".split()
)


class TextDataset:
    """Map-style dataset over parallel text/label sequences."""

    def __init__(self, texts: Sequence[str], labels: Sequence[int]):
        if len(texts) != len(labels):
            raise ValueError(
                f"texts ({len(texts)}) and labels ({len(labels)}) must be parallel"
            )
        self.texts = list(texts)
        self.labels = list(labels)

    def __len__(self) -> int:
        return len(self.texts)

    def __getitem__(self, idx: int) -> dict:
        return {"text": self.texts[idx], "label": self.labels[idx]}


def synthetic_dataset(n_examples: int = 256, seed: int = 0) -> TextDataset:
    """Deterministic IMDB-shaped sentiment corpus (text + binary label)."""
    rng = np.random.default_rng(seed)
    texts, labels = [], []
    for _ in range(n_examples):
        label = int(rng.integers(0, 2))
        n_words = int(rng.integers(16, 96))
        words = rng.choice(_WORDS, size=n_words).tolist()
        sentiment = "I loved it." if label else "I hated it."
        texts.append(" ".join(words) + " " + sentiment)
        labels.append(label)
    return TextDataset(texts, labels)


def load_text_dataset(config: DataConfig) -> TextDataset:
    """HF-hub ingestion with a hermetic fallback."""
    if config.synthetic:
        return synthetic_dataset(config.synthetic_examples, config.seed)
    try:
        from datasets import load_dataset

        ds = load_dataset(config.dataset_name, split=config.dataset_split)
        return TextDataset(ds[config.text_column], ds[config.label_column])
    except Exception as e:  # hub unreachable / dataset missing
        logger.warning(
            "load_dataset(%r, %r) failed (%s); using synthetic corpus",
            config.dataset_name,
            config.dataset_split,
            e,
        )
        return synthetic_dataset(config.synthetic_examples, config.seed)
