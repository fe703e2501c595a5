"""Host batches and their prefetch onto the device.

Counterpart of the JAX package's ``data/loader.py`` on one card (rank 0 of
1): shard the dataset with ``ShardedSampler``, tokenize and pad (or pack)
into fixed ``(batch, seq_len)`` arrays, and hand them to the step loop as
``torch`` tensors on the device, a producer thread keeping ``prefetch``
batches ready. The host batches are the JAX pipeline's, array for array.

The JAX package packs and pads the byte tokenizer's stream in a C++ library
with a numpy fallback of the same semantics (``native/dataprep.py``); the
port keeps the numpy versions (``_pack_stream``, ``_segments_positions``,
``_tokenize_padded``): the library is host code, not a TPU kernel. The port
has only the byte tokenizer (``data/tokenizer.py``), so only its path is
copied; the chaos seam and the data-wait timeout are not ported.
"""

from __future__ import annotations

import collections
import threading
from typing import Iterator

import numpy as np
import torch

from ditl_tpu_torch.config import DataConfig
from ditl_tpu_torch.data.dataset import TextDataset
from ditl_tpu_torch.data.sampler import ShardedSampler
from ditl_tpu_torch.data.tokenizer import ByteTokenizer
from ditl_tpu_torch.utils.device import resolve_device

__all__ = ["DataPipeline"]


def _pack_stream(texts: list[str], *, bos: int, eos: int, byte_offset: int
                 ) -> np.ndarray:
    """[bos] + utf8-bytes+offset + [eos] per doc, concatenated. int32."""
    out: list[int] = []
    for t in texts:
        out.append(bos)
        out.extend(b + byte_offset for b in t.encode("utf-8"))
        out.append(eos)
    return np.asarray(out, dtype=np.int32)


def _segments_positions(rows: np.ndarray, *, bos: int
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Per-row packed-document segment ids (1-based) and positions restarting
    at each bos."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    is_bos = rows == bos
    segments = np.cumsum(is_bos, axis=1).astype(np.int32) + 1
    col = np.broadcast_to(np.arange(rows.shape[1]), rows.shape)
    last_bos = np.maximum.accumulate(np.where(is_bos, col, 0), axis=1)
    return segments, (col - last_bos).astype(np.int32)


def _tokenize_padded(text: str, seq_len: int, *, bos: int, eos: int, pad: int,
                     byte_offset: int) -> tuple[np.ndarray, np.ndarray]:
    """One padded row + loss mask (the non-packed byte path)."""
    if seq_len < 2:
        raise ValueError(f"seq_len must be >= 2 (bos+eos), got {seq_len}")
    data = np.frombuffer(text.encode("utf-8"), dtype=np.uint8)
    ids = [bos] + [int(b) + byte_offset for b in data[: seq_len - 2]] + [eos]
    row = np.full(seq_len, pad, dtype=np.int32)
    row[: len(ids)] = ids
    mask = np.zeros(seq_len, dtype=np.float32)
    mask[: len(ids)] = 1.0
    return row, mask


class DataPipeline:
    """Shard -> tokenize -> batch -> device tensors, with epoch reseeding and
    background prefetch."""

    def __init__(self, dataset: TextDataset, tokenizer: ByteTokenizer,
                 config: DataConfig, device: str | torch.device = "cuda"):
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.config = config
        self.device = resolve_device(device)
        self.host_batch_size = config.batch_size
        self.sampler = ShardedSampler(
            dataset_size=len(dataset), num_replicas=1, rank=0,
            shuffle=config.shuffle, seed=config.seed, drop_last=config.drop_last,
        )

    @property
    def steps_per_epoch(self) -> int:
        return len(self.sampler) // self.host_batch_size

    def _host_batches(self, epoch: int, start_step: int = 0
                      ) -> Iterator[dict[str, np.ndarray]]:
        """Numpy batches for one epoch; ``start_step`` skips the first N."""
        self.sampler.set_epoch(epoch)
        indices = self.sampler.local_indices()
        seq_len = self.config.seq_len
        if self.config.pack_sequences:
            yield from self._packed_batches(indices, start_step)
            return
        tok = self.tokenizer
        n_full = len(indices) // self.host_batch_size
        for b in range(start_step, n_full):
            chunk = indices[b * self.host_batch_size: (b + 1) * self.host_batch_size]
            ids = np.empty((len(chunk), seq_len), dtype=np.int32)
            mask = np.empty((len(chunk), seq_len), dtype=np.float32)
            labels = np.empty((len(chunk),), dtype=np.int32)
            for i, idx in enumerate(chunk):
                item = self.dataset[int(idx)]
                ids[i], mask[i] = _tokenize_padded(
                    item["text"], seq_len, bos=tok.bos_id, eos=tok.eos_id,
                    pad=tok.pad_id, byte_offset=tok.byte_offset)
                labels[i] = item["label"]
            # Segment ids isolate real tokens (1) from padding (0) in attention.
            yield {
                "input_ids": ids,
                "loss_mask": mask,
                "labels": labels,
                "segment_ids": mask.astype(np.int32),
                "positions": np.broadcast_to(
                    np.arange(seq_len, dtype=np.int32), ids.shape).copy(),
            }

    def _packed_batches(self, indices: np.ndarray, start_step: int = 0
                        ) -> Iterator[dict[str, np.ndarray]]:
        """Sequence packing: concatenate [bos]doc[eos] streams and slice
        fixed rows, segments and positions restarting at each bos."""
        tok, seq_len = self.tokenizer, self.config.seq_len
        texts = [self.dataset[int(idx)]["text"] for idx in indices]
        stream = _pack_stream(texts, bos=tok.bos_id, eos=tok.eos_id,
                              byte_offset=tok.byte_offset)
        rows_total = len(stream) // seq_len
        n_batches = rows_total // self.host_batch_size
        arr = stream[: rows_total * seq_len].reshape(rows_total, seq_len)
        segments, positions = _segments_positions(arr, bos=tok.bos_id)
        for b in range(start_step, n_batches):
            sl = slice(b * self.host_batch_size, (b + 1) * self.host_batch_size)
            yield {
                "input_ids": arr[sl],
                "loss_mask": np.ones_like(arr[sl], dtype=np.float32),
                "labels": np.zeros((arr[sl].shape[0],), dtype=np.int32),
                "segment_ids": segments[sl],
                "positions": positions[sl],
            }

    def _to_device(self, host: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in host.items()}

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[dict]:
        """Device batches for one epoch, prefetched by a producer thread."""
        yield from _prefetch(
            (self._to_device(hb) for hb in self._host_batches(epoch, start_step)),
            self.config.prefetch,
        )

    def __iter__(self) -> Iterator[dict]:
        """Infinite stream across epochs (epoch-seeded reshuffle each pass)."""
        epoch = 0
        while True:
            yield from self.epoch(epoch)
            epoch += 1


def _prefetch(it: Iterator, depth: int) -> Iterator:
    """Background-thread prefetch of up to ``depth`` items. Producer
    exceptions reach the consumer; abandoning the generator stops the
    thread."""
    if depth <= 0:
        yield from it
        return
    queue: collections.deque = collections.deque()
    lock = threading.Condition()
    done = object()
    failed = object()
    stop = False

    def worker():
        try:
            for item in it:
                with lock:
                    while len(queue) >= depth and not stop:
                        lock.wait()
                    if stop:
                        return
                    queue.append(item)
                    lock.notify_all()
        except BaseException as e:  # surface producer errors to the consumer
            with lock:
                queue.append((failed, e))
                lock.notify_all()
            return
        with lock:
            queue.append(done)
            lock.notify_all()

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            with lock:
                while not queue:
                    lock.wait()
                item = queue.popleft()
                lock.notify_all()
            if item is done:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is failed:
                raise item[1]
            yield item
    finally:
        with lock:
            stop = True
            lock.notify_all()
