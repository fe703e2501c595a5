"""Continuous batching over the paged KV cache.

Counterpart of the JAX package's ``infer/continuous.py``, in its plain paged
configuration: ``cache_mode="paged"``, ``admission="reserve"``, whole-prompt
prefill, plain decode ticks, float or int8 pools, one device, and automatic
prefix reuse (which paged mode always does). Requests join and leave between
decode ticks:

- **Slots.** ``n_slots`` sequences decode together, each at its own
  position; every tick runs all slots, live or not (fixed shapes).
- **Page pool.** KV lives in one pool of pages per K and V, (L, P, K, ps, D);
  a per-slot page table maps logical block -> physical page
  (``infer/paged_cache.py``). Admission reserves a request's worst-case
  pages (prompt + max_new) or leaves it queued; every FULL prompt page is
  published and reused by later prompts that share the prefix. With
  ``kv_cache_dtype="int8"`` the pools hold int8 values plus f32 scales
  ``ks``/``vs`` of shape (L, P, K, 1, ps), one per (page, KV head,
  position), quantized as the contiguous cache quantizes (absmax over D);
  shared prefix pages share their scales.
- **Prefill into a slot.** A cold prompt runs the causal prefill over its
  bucket (the flash kernel, K1, with ``attention_impl="flash"``); a prompt
  whose leading pages matched runs the masked cached forward over its
  gathered context pages plus the suffix. The chunk's whole pages are
  scattered into the pool.
- **Decode tick.** ``decode_chunk`` steps with ``starts = pos``; each step's
  K/V go into a small per-tick tail buffer, attention reads the pages plus
  the tail (the CUDA kernel K3, ``ops/paged_attention.py``), and after the
  last step one in-place scatter flushes the valid tail columns into their
  pages (int8 pools: the bf16 tail is quantized there, once per tick, so a
  token attends at full precision within its own tick). No host sync inside a tick: one device-to-host copy of the emitted
  tokens per tick, which the host harvests (EOS/pad-delimited).

PyTorch runs eagerly, so the reference's compiled-program caches go away
and its decode ``scan`` is a Python loop in the same step order. The pools,
tails and slot state are updated in place where that saves a copy.

Sampling: rows with temperature <= 0 are greedy; the others draw from their
own ``torch.Generator``, seeded from the request's seed at admission, so a
request's draws do not depend on which requests share its ticks. The draws
are PyTorch's, not the reference's, so sampled tokens match it in
distribution only; greedy tokens match exactly.

Everything else of the reference engine raises ``NotImplementedError`` and
is queued in ``ROADMAP.md``: the contiguous cache, chunked prefill, token
budgets, optimistic admission with preemption, speculative ticks and draft
models, logprobs, grammar masks, multi-LoRA stacks, the host-RAM tier and KV
handoff, ``register_prefix``, deadlines, pipelined ticks, meshes, and the
telemetry planes.
"""

from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ditl_tpu_torch.config import ModelConfig
from ditl_tpu_torch.data.tokenizer import Tokenizer, check_vocab
from ditl_tpu_torch.infer.engine import GenerateConfig, _next_pow2
from ditl_tpu_torch.infer.paged_cache import PageAllocator
from ditl_tpu_torch.infer.sampling import row_uniforms, sample_logits
from ditl_tpu_torch.models import llama
from ditl_tpu_torch.utils.device import resolve_device
from ditl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["BadRequestError", "ContinuousEngine", "QueueFullError", "Request",
           "SLO_CLASSES", "ThreadedEngine"]

# SLO class -> scheduling rank (lower = served first): admission orders the
# queue by (rank, arrival).
SLO_CLASSES: dict[str, int] = {"interactive": 0, "batch": 1, "best_effort": 2}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (see ROADMAP.md)"
    )


class BadRequestError(ValueError):
    """Request validation failed: the client's fault (the HTTP server maps
    exactly this class to 400)."""


class QueueFullError(RuntimeError):
    """``submit`` found the admission queue at its ``max_queue`` cap (the
    HTTP server answers 429)."""


@dataclass
class Request:
    """One in-flight generation request (host bookkeeping)."""

    req_id: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float
    top_p: float
    seed: int
    tokens: list[int] = field(default_factory=list)
    finished: bool = False
    slo_class: str = "interactive"

    @property
    def slo_rank(self) -> tuple[int, int]:
        """Scheduling order key: class rank, then arrival."""
        return (SLO_CLASSES[self.slo_class], self.req_id)


def _quantize_pages(chunk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, n, K, ps, D) float -> int8 values + (L, n, K, 1, ps) f32 scales:
    the contiguous cache's recipe (``infer/cache._quantize``, absmax per
    position over D)."""
    from ditl_tpu_torch.infer.cache import _quantize

    q, scale = _quantize(chunk)
    return q, scale[:, :, :, None, :]


def _flush_tail_into_pools(pools: dict, tk: torch.Tensor, tv: torch.Tensor,
                           starts: torch.Tensor, pos: torch.Tensor,
                           table: torch.Tensor, ps: int) -> None:
    """Scatter the tick's tail columns into their pages, in place: one
    scatter per pool per tick. Valid columns are j < pos - starts (the
    tokens the tick committed); invalid ones aim at sentinel page 0 with
    row-distinct offsets, whose content is never read unmasked. int8 pools:
    the tail is quantized here and its scales scattered beside the values.
    All on the device: no host sync."""
    n_l, n_b, n_k, tail_len, d = tk.shape
    dev = tk.device
    j = torch.arange(tail_len, device=dev)
    gpos = starts.long()[:, None] + j[None, :]  # (B, T)
    valid = j[None, :] < (pos - starts).long()[:, None]
    pidx = table.long().gather(1, (gpos // ps).clamp(0, table.shape[1] - 1))
    pid = torch.where(valid, pidx, 0).reshape(-1)
    rows = torch.arange(n_b, device=dev)[:, None] * tail_len + j[None, :]
    off = torch.where(valid, gpos % ps, rows % ps).reshape(-1)
    quant = "ks" in pools
    for name, tail in (("k", tk), ("v", tv)):
        pool = pools[f"{name}p"]
        if quant:
            from ditl_tpu_torch.infer.cache import _quantize

            tail, scale = _quantize(tail)  # scale (L, B, K, T)
            # (L, P, K, ps) view of the (L, P, K, 1, ps) scales
            pools[f"{name}s"][:, :, :, 0][:, pid, :, off] = scale.permute(1, 3, 0, 2).reshape(
                n_b * tail_len, n_l, n_k)
        # tail (L, B, K, T, D) -> (B*T, L, K, D): the advanced indices on
        # pool dims 1 and 3 put the scatter dim first.
        pool[:, pid, :, off] = tail.permute(1, 3, 0, 2, 4).reshape(
            n_b * tail_len, n_l, n_k, d)


class ContinuousEngine:
    """Slot-based continuous-batching text generation over a page pool."""

    def __init__(
        self,
        params: llama.Params,
        model_cfg: ModelConfig,
        tokenizer: Tokenizer,
        *,
        n_slots: int = 8,
        decode_chunk: int = 16,
        gen: GenerateConfig | None = None,
        seed: int = 0,
        max_cache_len: int | None = None,
        prefill_chunk: int = 0,
        cache_mode: str = "contiguous",
        page_size: int = 256,
        n_pages: int | None = None,
        max_queue: int | None = None,
        mesh=None,
        speculative: bool = False,
        logprobs_k: int = 0,
        fsm_capacity: int = 0,
        draft_params: llama.Params | None = None,
        draft_cfg: ModelConfig | None = None,
        pipeline_ticks: bool = False,
        admission: str = "reserve",
        token_budget: int = 0,
        host_tier_mb: float = 0,
        metrics=None,
        tracer=None,
        flight=None,
        usage=None,
        device: str | torch.device = "cuda",
    ):
        """``max_cache_len`` caps the per-slot context below the model's
        ``max_seq_len``. ``n_pages`` sizes the pool (default: the contiguous
        equivalent, ``n_slots x ceil(max context / page_size)`` plus the
        sentinel page 0). ``max_queue`` caps how many requests may wait for
        a slot; ``submit`` raises ``QueueFullError`` beyond it."""
        check_vocab(tokenizer, model_cfg.vocab_size, "ContinuousEngine")
        llama.check_supported(model_cfg)
        unported = {
            "cache_mode='contiguous'": cache_mode == "contiguous",
            "prefill_chunk (chunked prefill)": prefill_chunk != 0,
            "token_budget": token_budget != 0,
            "admission='optimistic' (preemption and resume)": admission == "optimistic",
            "speculative decoding": speculative,
            "draft models": draft_params is not None or draft_cfg is not None,
            "logprobs_k": logprobs_k != 0,
            "fsm_capacity (grammar-constrained decoding)": fsm_capacity != 0,
            "host_tier_mb (the host-RAM prefix tier)": host_tier_mb != 0,
            "pipeline_ticks": pipeline_ticks,
            "mesh (sharded serving)": mesh is not None,
            "metrics/tracer/flight/usage (serving telemetry)": any(
                x is not None for x in (metrics, tracer, flight, usage)),
            "multi-LoRA adapter stacks": bool(params.get("layers", {}).get("lora")),
        }
        for what, asked in unported.items():
            if asked:
                raise _not_ported(what)
        if cache_mode != "paged":
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        if admission != "reserve":
            raise ValueError(f"admission must be 'reserve' or 'optimistic', "
                             f"got {admission!r}")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        if page_size < 16 or page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two >= 16, got {page_size}")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = model_cfg
        self.tokenizer = tokenizer
        self.n_slots = n_slots
        self.decode_chunk = decode_chunk
        self.max_queue = max_queue
        self.gen = gen or GenerateConfig()
        self.smax = min(model_cfg.max_seq_len, max_cache_len or model_cfg.max_seq_len)
        self.cache_mode = cache_mode
        self.admission = admission
        self.page_size = page_size
        self.maxp = -(-self.smax // page_size)
        self.n_pages = n_pages or (n_slots * self.maxp + 1)  # page 0: sentinel
        dev = self.device
        dtype = llama.torch_dtype(model_cfg.dtype)
        shape = (model_cfg.num_layers, self.n_pages, model_cfg.num_kv_heads,
                 page_size, model_cfg.head_dim)
        if model_cfg.kv_cache_dtype == "int8":
            scale_shape = shape[:3] + (1, page_size)
            self.cache = {"kp": torch.zeros(shape, dtype=torch.int8, device=dev),
                          "vp": torch.zeros(shape, dtype=torch.int8, device=dev),
                          "ks": torch.ones(scale_shape, dtype=torch.float32, device=dev),
                          "vs": torch.ones(scale_shape, dtype=torch.float32, device=dev)}
        else:
            self.cache = {"kp": torch.zeros(shape, dtype=dtype, device=dev),
                          "vp": torch.zeros(shape, dtype=dtype, device=dev)}
        # Bytes of one page across layers, K and V (int8: scales included).
        self.page_bytes = sum(t.numel() * t.element_size()
                              for t in self.cache.values()) // self.n_pages
        self.allocator = PageAllocator(self.n_pages)
        self._table = np.zeros((n_slots, self.maxp), np.int32)
        # Device mirror, re-uploaded only when the host table changes.
        self._table_dirty = True
        self._table_dev: torch.Tensor | None = None
        self._slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
        # Slot state on the device, written in place at admission.
        self.cur = torch.full((n_slots,), tokenizer.pad_id, dtype=torch.long, device=dev)
        self.pos = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self.limits = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self.temps = torch.zeros((n_slots,), dtype=torch.float32, device=dev)
        self.top_ps = torch.ones((n_slots,), dtype=torch.float32, device=dev)
        # One generator per slot, seeded from its request's seed.
        self._gens: list[torch.Generator | None] = [None] * n_slots
        self._base_seed = seed
        self._slots: list[Request | None] = [None] * n_slots
        # Admission queue, sorted by (SLO class rank, req_id). Submitters
        # (HTTP threads, through ThreadedEngine) insert while the driver
        # thread admits and cancels: the lock makes each insert and removal
        # atomic against the other.
        self._queue: list[Request] = []
        self._queue_lock = threading.Lock()
        self._completed: dict[int, Request] = {}
        self._next_id = 0
        # Host counters for stats().
        self.decode_ticks = 0
        self.decode_steps = 0
        self.decode_seconds = 0.0
        self.prefills_cold = 0
        self.prefills_prefix_hit = 0
        self.prefix_hit_tokens = 0
        self.prefix_miss_tokens = 0

    # -- left out of the port -------------------------------------------------

    def register_prefix(self, prefix_tokens: list[int]) -> None:
        raise _not_ported("register_prefix (page warming)")

    def export_kv(self, *args, **kwargs):
        raise _not_ported("KV handoff (export_kv)")

    def import_kv(self, *args, **kwargs):
        raise _not_ported("KV handoff (import_kv)")

    # -- scheduler ------------------------------------------------------------

    def submit(
        self,
        prompt_tokens: list[int],
        *,
        max_new_tokens: int | None = None,
        temperature: float | None = None,
        top_p: float | None = None,
        seed: int | None = None,
        slo_class: str | None = None,
        stream: Any = None,
        logprobs: int | None = None,
        adapter_id: int | None = None,
        grammar: Any = None,
        deadline_s: float | None = None,
        trace: Any = None,
        tenant: str | None = None,
    ) -> int:
        """Queue a request; returns its id (see ``take_result``/``run``).
        ``slo_class`` (``interactive`` | ``batch`` | ``best_effort``) orders
        admission; it never changes a request's result."""
        unported = {
            "streaming": stream is not None,
            "logprobs": logprobs is not None,
            "multi-LoRA adapters": bool(adapter_id),
            "grammar-constrained decoding": grammar is not None,
            "request deadlines": deadline_s is not None,
            "request tracing": trace is not None,
            "per-tenant usage metering": tenant is not None,
        }
        for what, asked in unported.items():
            if asked:
                raise _not_ported(what)
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            raise QueueFullError(
                f"admission queue full ({self.max_queue} waiting requests)"
            )
        if seed is not None and not (-2**31 <= int(seed) < 2**31):
            raise BadRequestError("seed must fit in int32")
        if slo_class is None:
            slo_class = "interactive"
        elif slo_class not in SLO_CLASSES:
            raise BadRequestError(
                f"unknown slo_class {slo_class!r} (one of {sorted(SLO_CLASSES)})"
            )
        gen = self.gen
        max_new = max_new_tokens if max_new_tokens is not None else gen.max_new_tokens
        prompt = prompt_tokens or [self.tokenizer.bos_id]
        self.validate_request(prompt, max_new)
        req = Request(
            req_id=self._next_id,
            prompt=list(prompt),
            max_new_tokens=max_new,
            temperature=gen.temperature if temperature is None else temperature,
            top_p=gen.top_p if top_p is None else top_p,
            seed=(self._base_seed + self._next_id) if seed is None else int(seed),
            slo_class=slo_class,
        )
        self._next_id += 1
        self._enqueue(req)
        return req.req_id

    def _enqueue(self, req: Request) -> None:
        """Insert by (class rank, req_id): FIFO within a class, classes in
        priority order."""
        with self._queue_lock:
            keys = [r.slo_rank for r in self._queue]
            self._queue.insert(bisect.bisect_right(keys, req.slo_rank), req)

    def validate_request(self, prompt: list[int], max_new: int) -> None:
        """Reject requests that could never run."""
        if len(prompt) + max_new > self.smax:
            raise BadRequestError(
                f"prompt {len(prompt)} + max_new {max_new} exceeds max_seq_len "
                f"/ cache cap {self.smax}"
            )
        need = -(-(len(prompt) + max_new) // self.page_size)
        if need > self.n_pages - 1:  # page 0 is the reserved sentinel
            raise BadRequestError(
                f"request needs {need} pages but the pool only has "
                f"{self.n_pages - 1} (n_pages={self.n_pages}, "
                f"page_size={self.page_size})"
            )

    # -- paged admission / prefill --------------------------------------------

    def _free_slot_pages(self, slot: int) -> None:
        for pid in self._slot_pages[slot]:
            self.allocator.release(pid)
        self._slot_pages[slot] = []
        self._table[slot, :] = 0
        self._table_dirty = True
        self._gens[slot] = None

    def _publish_tokens(self, tokens: list[int], slot: int) -> None:
        """Make the full pages of ``tokens`` (held by ``slot``)
        content-addressable; full pages are immutable, so sharing is
        read-only by construction."""
        ps = self.page_size
        n_full = len(tokens) // ps
        self.allocator.publish_chain(
            tokens[: n_full * ps], ps, [int(p) for p in self._table[slot, :n_full]]
        )

    def _publish_prompt_pages(self, req: Request, slot: int) -> None:
        self._publish_tokens(req.prompt, slot)

    def _publish_generated_pages(self, req: Request, slot: int) -> None:
        """On completion, publish the pages covering prompt AND generated
        tokens, so a follow-up turn whose prompt embeds this one reuses the
        whole conversation's KV."""
        self._publish_tokens(req.prompt + req.tokens, slot)

    def _ctx_pages_bucket(self, d: int) -> int:
        """Gather bucket (in pages) covering a context of ``d`` tokens."""
        if d <= 0:
            return 0
        need = -(-d // self.page_size)
        return min(_next_pow2(need, floor=1), self.maxp)

    def _paged_prefill_chunk(self, req: Request, slot: int, d: int, s: int,
                             generator: torch.Generator | None) -> torch.Tensor:
        """Prefill ``req.prompt[d:d+s]`` into ``slot``'s pages and sample the
        first token (a device scalar, no host sync).

        The bucket is a power of two of at least one page. With no context
        (``d == 0``) the prefill is causal over the bucket with pad validity
        in segment ids (the flash kernel's path). With a context, the
        context's pages are gathered into a transient contiguous row (a
        power-of-two bucket of pages) and the masked cached forward runs
        over it. Either way the chunk's whole pages are then written to
        ``write_pids`` in place; bucket columns past ``s`` hold garbage that
        stays masked until decode overwrites it."""
        cfg, dev, ps = self.cfg, self.device, self.page_size
        ctx_row, write_pids = self._table[slot], self._table[slot, d // ps:]
        s_bucket = min(_next_pow2(s, floor=ps), self.maxp * ps)
        ctx = self._ctx_pages_bucket(d)
        n_wp = s_bucket // ps
        n_l, n_k, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        dtype = llama.torch_dtype(cfg.dtype)
        ids = torch.full((1, s_bucket), self.tokenizer.pad_id, dtype=torch.long)
        ids[0, :s] = torch.tensor(req.prompt[d: d + s], dtype=torch.long)
        ids = ids.to(dev)
        pids = np.zeros((n_wp,), np.int64)
        pids[: min(len(write_pids), n_wp)] = write_pids[:n_wp]
        q_pos = torch.arange(d, d + s_bucket, device=dev)[None]
        kp, vp = self.cache["kp"], self.cache["vp"]
        ks, vs = self.cache.get("ks"), self.cache.get("vs")
        if ctx == 0:
            row = {"k": torch.empty((n_l, 1, s_bucket, n_k, hd), dtype=dtype, device=dev),
                   "v": torch.empty((n_l, 1, s_bucket, n_k, hd), dtype=dtype, device=dev)}
            seg = (torch.arange(s_bucket, device=dev) < s).to(torch.int32)[None]
            hidden = llama.forward(self.params, ids, cfg, positions=q_pos,
                                   segment_ids=seg, cache=row, cache_index=0,
                                   prefill_causal=True, return_hidden=True)
            self.prefills_cold += 1
        else:
            ctx_ids = torch.tensor(np.asarray(ctx_row[:ctx], np.int64), device=dev)

            def to_row(pool, scales):
                # (L, ctx, K, ps, D) -> (L, 1, ctx*ps + s_bucket, K, D); int8
                # pages dequantized (f32 value times scale, then the compute
                # dtype)
                g = pool[:, ctx_ids]
                if scales is not None:
                    g = (g.float() * scales[:, ctx_ids][:, :, :, 0, :, None]).to(dtype)
                g = g.transpose(2, 3).reshape(n_l, 1, ctx * ps, n_k, hd)
                pad = torch.zeros((n_l, 1, s_bucket, n_k, hd), dtype=dtype, device=dev)
                return torch.cat([g, pad], dim=2)

            row = {"k": to_row(kp, ks), "v": to_row(vp, vs)}
            buf = torch.arange(ctx * ps + s_bucket, device=dev)
            mask = buf[None, None, :] <= q_pos[:, :, None]
            hidden = llama.forward(self.params, ids, cfg, positions=q_pos,
                                   cache=row, cache_index=d, attn_mask=mask,
                                   return_hidden=True)
            self.prefills_prefix_hit += 1
        pid_t = torch.from_numpy(pids).to(dev)
        for pool, spool, name in ((kp, ks, "k"), (vp, vs, "v")):
            # (L, 1, s_bucket, K, D) at offset d -> (L, n_wp, K, ps, D)
            chunk = row[name][:, 0, d:d + s_bucket].reshape(n_l, n_wp, ps, n_k, hd)
            chunk = chunk.transpose(2, 3)
            if spool is not None:  # int8 pools: quantized pages and their scales
                chunk, scale = _quantize_pages(chunk)
                spool[:, pid_t] = scale
            pool[:, pid_t] = chunk
        last = llama.logits_from_hidden(self.params, hidden[:, s - 1])  # (1, V)
        # Scalar mode: the same draws as the tick's per-row mode from this
        # generator; temperature <= 0 is greedy there, so it is 0 here.
        return sample_logits(last, generator, temperature=max(req.temperature, 0.0),
                             top_k=self.gen.top_k, top_p=req.top_p)[0]

    def _admit_paged_slot(self, slot: int) -> bool:
        """Admit the queue head into ``slot``: match its prefix, reserve its
        worst-case pages (prompt + max_new) or leave it queued (False)."""
        req = self._queue[0]
        ps = self.page_size
        matched = self.allocator.match_prefix(req.prompt, ps)  # retained
        worst = -(-(len(req.prompt) + req.max_new_tokens) // ps)
        try:
            fresh = self.allocator.alloc(worst - len(matched))
        except MemoryError:
            for pid in matched:
                self.allocator.release(pid)
            return False
        with self._queue_lock:  # by identity: a submit may have inserted ahead
            self._queue.remove(req)
        d0 = len(matched) * ps
        self.prefix_hit_tokens += d0
        self.prefix_miss_tokens += len(req.prompt) - d0
        pages = matched + fresh
        self._slot_pages[slot] = pages
        self._table[slot, :] = 0
        self._table[slot, : len(pages)] = pages
        self._table_dirty = True
        gen = None
        if req.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(req.seed)
        self._gens[slot] = gen
        self._slots[slot] = req
        s = len(req.prompt) - d0
        first = self._paged_prefill_chunk(req, slot, d0, s, gen)
        self._publish_prompt_pages(req, slot)
        # In-place writes of this slot's row: no copy of the slot state.
        self.cur[slot] = first
        self.pos[slot] = len(req.prompt)
        self.temps[slot] = req.temperature
        self.top_ps[slot] = req.top_p
        self.limits[slot] = len(req.prompt) + req.max_new_tokens
        return True

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self._slots[slot] is not None or not self._queue:
                continue
            if not self._admit_paged_slot(slot):
                # Priority FIFO: the head request does not fit the pool right
                # now; smaller or lower-class requests must not starve it.
                break

    # -- decode ----------------------------------------------------------------

    def _table_device(self) -> torch.Tensor:
        if self._table_dirty or self._table_dev is None:
            self._table_dev = torch.tensor(self._table, device=self.device)
            self._table_dirty = False
        return self._table_dev

    def _decode_tick(self, occupied: list[bool]) -> np.ndarray:
        """One decode tick of ``decode_chunk`` steps over every slot, in the
        reference's step order; returns the emitted tokens (B, chunk)."""
        cfg, dev = self.cfg, self.device
        n_b, chunk = self.n_slots, self.decode_chunk
        pad, eos = self.tokenizer.pad_id, self.tokenizer.eos_id
        active = [r for r in self._slots if r is not None]
        sampled = any(r.temperature > 0.0 for r in active)
        # top_p matters only when something samples.
        topp = sampled and any(r.top_p < 1.0 for r in active)
        table = self._table_device()
        # starts = pos: dead rows then have pos - starts == 0 live tail
        # columns, so the flush writes nothing for them.
        starts = self.pos
        tail_shape = (cfg.num_layers, n_b, cfg.num_kv_heads, chunk, cfg.head_dim)
        dtype = llama.torch_dtype(cfg.dtype)
        cache = {**self.cache,
                 "tk": torch.zeros(tail_shape, dtype=dtype, device=dev),
                 "tv": torch.zeros(tail_shape, dtype=dtype, device=dev)}
        uniforms = None
        if sampled:
            gens = [g if r is not None and r.temperature > 0.0 else None
                    for g, r in zip(self._gens, self._slots)]
            uniforms = row_uniforms(gens, (chunk, cfg.vocab_size), dev)
        cur, pos = self.cur, self.pos
        done = ~torch.tensor(occupied, device=dev)
        emitted = []
        for t in range(chunk):
            done = done | (pos >= self.limits)
            step_alive = ~done
            lengths = torch.where(step_alive, pos + 1, 0).to(torch.int32)
            step_logits = llama.forward(
                self.params, cur[:, None], cfg, positions=pos[:, None], cache=cache,
                paged={"table": table, "lengths": lengths, "starts": starts, "t": t},
            )[:, 0]
            if sampled:
                nxt = sample_logits(
                    step_logits, None, temperature=self.temps, top_k=self.gen.top_k,
                    top_p=self.top_ps if topp else 1.0, uniforms=uniforms[:, t],
                )
            else:
                nxt = torch.argmax(step_logits, dim=-1)
            emitted.append(torch.where(step_alive, cur, pad))
            done = done | (cur == eos)
            pos = torch.where(step_alive, pos + 1, pos)
            cur = torch.where(done, pad, nxt)
            self.decode_steps += 1
        _flush_tail_into_pools(self.cache, cache["tk"], cache["tv"], starts, pos,
                               table, self.page_size)
        self.cur, self.pos = cur, pos
        return torch.stack(emitted, dim=1).cpu().numpy()  # the tick's one copy

    def _harvest(self, emitted: np.ndarray) -> None:
        """Append each live slot's tokens up to EOS/pad or its budget;
        finished requests publish their pages and free their slot."""
        eos, pad = self.tokenizer.eos_id, self.tokenizer.pad_id
        for slot, req in enumerate(list(self._slots)):
            if req is None:
                continue
            for tok in emitted[slot]:
                tok = int(tok)
                if tok in (eos, pad) or len(req.tokens) >= req.max_new_tokens:
                    req.finished = True
                    break
                req.tokens.append(tok)
            if len(req.tokens) >= req.max_new_tokens:
                req.finished = True
            if req.finished:
                self._completed[req.req_id] = req
                self._slots[slot] = None
                # Publish before releasing: the content cache's own
                # reference keeps the conversation's pages resident.
                self._publish_generated_pages(req, slot)
                self._free_slot_pages(slot)

    def step(self) -> None:
        """One scheduler tick: admit queued requests, then decode one chunk
        of every occupied slot and harvest it."""
        self._admit()
        occupied = [r is not None for r in self._slots]
        if any(occupied):  # host-side check: no device work on idle ticks
            t0 = time.perf_counter()
            emitted = self._decode_tick(occupied)
            self.decode_seconds += time.perf_counter() - t0
            self.decode_ticks += 1
            self._harvest(emitted)

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(r is not None for r in self._slots)

    def stats(self) -> dict:
        """Operational snapshot, host state only (no device sync)."""
        hit, miss = self.prefix_hit_tokens, self.prefix_miss_tokens
        prefix = {"hit_tokens": hit, "miss_tokens": miss,
                  "evictions": self.allocator.evictions}
        if hit + miss:
            prefix["hit_ratio"] = round(hit / (hit + miss), 4)
        return {
            "engine": "continuous",
            "cache_mode": self.cache_mode,
            "n_slots": self.n_slots,
            "slots_busy": sum(r is not None for r in self._slots),
            "queue_depth": len(self._queue),
            "max_queue": self.max_queue,
            "decode_chunk": self.decode_chunk,
            "max_context": self.smax,
            "queue_by_class": {cls: sum(1 for r in self._queue if r.slo_class == cls)
                               for cls in SLO_CLASSES},
            "prefix_cache": prefix,
            "page_size": self.page_size,
            "pages_total": self.n_pages - 1,  # page 0 is the sentinel
            "pages_free": self.allocator.n_free,
            "pages_cached_evictable": self.allocator.n_evictable,
            "admission": self.admission,
            "kv_bytes_per_token": round(self.page_bytes / self.page_size, 2),
            "decode_ticks": self.decode_ticks,
            "decode_steps": self.decode_steps,
            "decode_seconds": round(self.decode_seconds, 6),
            "prefills_cold": self.prefills_cold,
            "prefills_prefix_hit": self.prefills_prefix_hit,
        }

    def run(self) -> dict[int, list[int]]:
        """Drive until all submitted requests complete; pops and returns the
        finished requests' token lists by id."""
        while self.pending:
            self.step()
        out = {rid: req.tokens for rid, req in sorted(self._completed.items())}
        self._completed.clear()
        return out

    def generate(self, prompts: list[str], **submit_kw) -> list[str]:
        """Text in, text out."""
        ids = [
            self.submit([self.tokenizer.bos_id] + self.tokenizer.encode(p), **submit_kw)
            for p in prompts
        ]
        results = self.run()
        return [self.tokenizer.decode(results[i]) for i in ids]

    def cancel(self, req_id: int) -> bool:
        """Abandon a queued or in-flight request; its slot and private pages
        free at once. Returns True if the request was found."""
        with self._queue_lock:
            for req in self._queue:
                if req.req_id == req_id:
                    self._queue.remove(req)
                    return True
        for slot, req in enumerate(self._slots):
            if req is not None and req.req_id == req_id:
                self._slots[slot] = None
                self._free_slot_pages(slot)
                return True
        return self._completed.pop(req_id, None) is not None

    def take_result(self, req_id: int) -> list[int] | None:
        """Pop a finished request's tokens, or None if still in flight."""
        req = self._completed.pop(req_id, None)
        return None if req is None else req.tokens

    def take_finished(self) -> list[Request]:
        """Pop and return all finished requests."""
        out = list(self._completed.values())
        self._completed.clear()
        return out


class ThreadedEngine:
    """Thread-safe front for ``ContinuousEngine``: HTTP handler threads
    submit and block on their own request while one driver thread ticks the
    engine, so concurrent requests share decode ticks."""

    def __init__(self, engine: ContinuousEngine):
        self._engine = engine
        self._cond = threading.Condition()
        self._results: dict[int, Request] = {}  # guarded by _cond
        self._cancels: set[int] = set()  # guarded by _cond
        self._error: BaseException | None = None  # guarded by _cond
        self._stop = False  # guarded by _cond
        self._thread = threading.Thread(target=self._drive, daemon=True)
        self._thread.start()

    @property
    def tokenizer(self) -> Tokenizer:
        return self._engine.tokenizer

    def stats(self) -> dict:
        return self._engine.stats()

    @property
    def queue_full(self) -> bool:
        """Best-effort admission-queue check."""
        eng = self._engine
        return eng.max_queue is not None and len(eng._queue) >= eng.max_queue

    def _drive(self) -> None:
        while True:
            with self._cond:
                while not self._stop and self._engine.pending == 0 and not self._cancels:
                    self._cond.wait(timeout=0.05)
                if self._stop:
                    self._cond.notify_all()
                    return
                cancels, self._cancels = self._cancels, set()
            # Device work runs outside the lock: submissions land while a
            # chunk decodes and are admitted on the next tick. Cancels are
            # applied here because only this thread touches engine state.
            try:
                for rid in cancels:
                    self._engine.cancel(rid)
                if self._engine.pending:
                    self._engine.step()
            except Exception as e:  # fail every waiter loudly and stop
                logger.exception("continuous engine driver died")
                with self._cond:
                    self._error = e
                    self._stop = True
                    self._cond.notify_all()
                return
            with self._cond:
                for req in self._engine.take_finished():
                    self._results[req.req_id] = req
                self._cond.notify_all()

    def generate_one(
        self,
        prompt_tokens: list[int],
        *,
        max_new_tokens: int | None = None,
        temperature: float | None = None,
        top_p: float | None = None,
        seed: int | None = None,
        slo_class: str | None = None,
    ) -> list[int]:
        """Submit one request and block until it completes. Raises if the
        driver has stopped (shutdown or device error)."""
        with self._cond:
            if self._stop:
                raise RuntimeError("continuous engine is stopped") from self._error
            rid = self._engine.submit(
                prompt_tokens, max_new_tokens=max_new_tokens,
                temperature=temperature, top_p=top_p, seed=seed,
                slo_class=slo_class,
            )
            self._cond.notify_all()
            while rid not in self._results:
                if self._stop:
                    raise RuntimeError(
                        "continuous engine stopped mid-request") from self._error
                self._cond.wait()
            return self._results.pop(rid).tokens

    def cancel(self, req_id: int) -> None:
        """Request cancellation; the driver thread applies it before its
        next tick (only it touches engine state)."""
        with self._cond:
            self._cancels.add(req_id)
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=30)
