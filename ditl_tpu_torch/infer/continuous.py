"""Continuous batching over the contiguous or the paged KV cache.

Counterpart of the JAX package's ``infer/continuous.py`` on one device:
both cache modes (``cache_mode="contiguous"``, the default, and
``"paged"``), reserve or optimistic admission (pages only),
whole-prompt or chunked prefill under an optional per-tick token budget,
plain and speculative decode ticks (drafts by prompt lookup or by a draft
model), per-token logprobs, request deadlines, float or int8 caches,
registered prefixes (contiguous) and automatic prefix reuse (paged).
Requests join and leave between decode ticks:

- **Slots.** ``n_slots`` sequences decode together, each at its own
  position; every tick runs all slots, live or not (fixed shapes).
- **Contiguous cache** (``cache_mode="contiguous"``): one (L, n_slots,
  smax, K, D) K/V pair (``infer/cache.init_cache``; int8 adds per-position
  scales), a row per slot. A cold prompt is prefilled causally over its
  bucket (``next_pow2``, at least 16) into a view of its row (K1 where the
  bucket tiles); a prompt that starts with a ``register_prefix``-ed prefix
  (the longest wins) gets the prefix's stored row copied in and prefills
  only the rest, by the masked plain path (a prompt equal to the prefix
  samples the stored last logits, no forward). Chunked prompts (any
  positive ``prefill_chunk``) park the row at ``pos = smax - 1`` and run
  every chunk as such a suffix prefill, tail chunks near the row's end in
  a smaller window. A decode step is a (B, 1) forward over every row at
  its own ``pos`` (a per-row write, then attention over slots <= pos, the
  plain masked path, as the reference computes it outside any kernel);
  dead, free and parked rows write at their ``pos`` too, which nothing
  attends before it is overwritten. Positions stop at ``smax - 1``. A
  speculative round's (B, k+1) verify writes each row's window at its depth
  the same way; rejected positions stay masked until the next window.
  Optimistic admission and the host tier need pages and are refused.
- **Page pool** (``cache_mode="paged"``). KV lives in one pool of pages
  per K and V, (L, P, K, ps, D); a per-slot page table maps logical block -> physical page
  (``infer/paged_cache.py``). ``admission="reserve"`` reserves a request's
  worst-case pages (prompt + max_new) or leaves it queued; every FULL prompt
  page is published and reused by later prompts that share the prefix. With
  ``kv_cache_dtype="int8"`` the pools hold int8 values plus f32 scales
  ``ks``/``vs`` of shape (L, P, K, 1, ps), one per (page, KV head,
  position), quantized as the contiguous cache quantizes (absmax over D);
  shared prefix pages share their scales.
- **Paged prefill into a slot.** A cold prompt runs the causal prefill over its
  bucket (the flash kernel, K1, with ``attention_impl="flash"``); a prompt
  whose leading pages matched runs the masked cached forward over its
  gathered context pages plus the suffix. The chunk's whole pages are
  scattered into the pool.
- **Paged chunked prefill** (``prefill_chunk``, a multiple of
  ``page_size``): a
  prompt whose unmatched part is longer than one chunk parks its slot
  (``cur = pad``, ``pos = 0``; decode ticks leave it out) and prefills one
  chunk per tick at a page-aligned offset, the first over no context (K1),
  the later ones over the gathered pages of the earlier ones. Only the last
  chunk samples: it seeds the slot's generator from the request's seed and
  draws the first token as an unchunked admission would, publishes the
  prompt pages and makes the row live.
- **Token budget** (``token_budget``): each tick's prefill spend is capped
  at ``budget - decode_ready x decode_chunk`` tokens, the tick's first
  prefill always passing; in-flight chunks draw the allowance before
  admission does, then newly admitted chunked prompts (the reference's
  order, decode > ongoing prefill > new work).
- **Paged decode tick.** ``decode_chunk`` steps with ``starts = pos``; each step's
  K/V go into a small per-tick tail buffer, attention reads the pages plus
  the tail (the CUDA kernel K3, ``ops/paged_attention.py``), and after the
  last step one in-place scatter flushes the valid tail columns into their
  pages (int8 pools: the bf16 tail is quantized there, once per tick, so a
  token attends at full precision within its own tick). No host sync inside a tick: one device-to-host copy of the emitted
  tokens per tick, which the host harvests (EOS/pad-delimited).
- **Speculative ticks** (``speculative=True``): a tick can run as
  ``spec_rounds`` verify rounds instead of ``decode_chunk`` steps, following
  the reference's ``_build_spec_paged_decode`` (``_build_spec_decode`` on
  the contiguous cache). Each round drafts ``spec_k``
  tokens per slot by prompt lookup over the slot's token history ``hist``
  (``infer/speculative.device_lookup_draft``; written at admission, extended
  by plain ticks too while speculation is armed) or, with
  ``draft_params``/``draft_cfg``, by k greedy steps of a small draft model
  over its own contiguous per-slot cache (``_draft_scan``: k + 1 feeds, the
  pending token first, the last output discarded; rejected drafts' KV stays
  masked by position, so nothing rolls back; every tick speculates), verifies them with one
  (B, k+1) forward whose K/V land in the tick's tail at per-row offsets and
  whose attention is K3's multi-query verify, and emits the accepted prefix
  plus the verify's own next token (greedy rows: exact match; sampled rows:
  rejection sampling, ``spec_sample_tokens``), capped by each slot's budget
  and by EOS/pad. The tick ends with the same flush as a plain tick. Greedy
  speculative output equals the plain tick's (exact arithmetic). Each tick
  decides from the acceptance it predicts for the current slots (each
  request's measured tokens per verify forward, else the engine's EMA,
  re-probed every ``spec_probe_every`` ticks) against ``spec_threshold``,
  by default the measured ratio of a verify round's cost to a plain step's
  (a prior of 2.5 until both are timed; the first timed tick of each kind
  is left out, as the reference leaves out compile calls).
- **Optimistic admission** (``admission="optimistic"``): admission
  reserves the prompt plus one tick of headroom (``_tick_advance_bound``:
  ``decode_chunk``, or a speculative tick's ``spec_rounds x (k+1) + k+1``
  written positions); before each dispatch ``_topup_pages`` grows every
  decoding slot's table to cover its next tick. On an empty pool it
  preempts the slot whose (SLO class, req_id) is strictly worse than the
  needy one's (``_pick_victim``; prefilling slots too), or the needy slot
  itself when none is: the victim's whole pages of prompt + tokens are
  published, its pages released, and it is requeued at its old id. A
  resume (``_resume_paged_slot``) re-prefills prompt + tokens against the
  published pages (in ``prefill_chunk`` pieces, the whole unmatched part
  charged to the tick's budget) and restores the pending token, ``pos``,
  the request's own ``torch.Generator`` in the state it had, and the
  pending logprob stats, so the request continues as if never stopped; a
  mid-prefill victim is requeued fresh. The anti-thrash guard counts
  re-prefilled against generated tokens over ``thrash_window`` ticks: past
  0.5 new admissions reserve worst-case pages, released below 0.1 with an
  empty queue.
- **Logprobs** (``logprobs_k``, ``submit(logprobs=N)``): every prefill and
  decode step also scores the token it chose (``_lp_stats``: the raw
  logits' log-softmax, the chosen token, the top ``logprobs_k``), the
  pending token's stats riding the slot like the token; speculative rounds
  score each draft from the verify's logits (``_spec_lp_round``). Plain
  PyTorch: the reference computes them outside any Pallas kernel. They
  never change a token.
- **Deadlines** (``submit(deadline_s=...)``): each ``step()`` first evicts
  every queued or slotted request past its deadline (``_expire_deadlines``);
  its pages free, its stream ends, and ``ThreadedEngine`` waiters raise
  ``DeadlineExceededError``.
- **Grammar-constrained decoding** (``fsm_capacity``, ``submit(grammar=...)``
  with an ``infer/grammar.CompiledGrammar`` or a start state from
  ``register_grammar``): a (capacity, vocab) int32 transition table holds
  every registered grammar's token-level DFA (row 0 FREE, all allowed,
  staying in 0; row 1 DEAD, all allowed, trapping in 1; a grammar's rows
  appended once, deduplicated by content) and each slot one int32 state in
  ``fstates``. Every sample site masks the logits it samples from by the
  row of the slot's state (``_fsm_mask``): a prefill's first token at the
  request's start state, each decode step at the slot's state, and a
  speculative verify at each position's state along the draft's path
  (``_fsm_spec_path``; drafts stay unmasked, so an illegal draft is
  rejected at its own position); the sampled token then moves the state
  (``_fsm_next``, a gather clamping to DEAD). Unconstrained rows ride the
  FREE row, whose mask is the identity. Logprobs score the raw logits. A
  preempted request's state is restored at its resume. Plain PyTorch, as
  the reference computes it outside any Pallas kernel; all on the
  device.

PyTorch runs eagerly, so the reference's compiled-program caches go away
and its decode ``scan`` is a Python loop in the same step order. The pools,
tails and slot state are updated in place where that saves a copy.

Sampling: rows with temperature <= 0 are greedy; the others draw from their
own ``torch.Generator``, seeded from the request's seed at admission, so a
request's draws do not depend on which requests share its ticks. The draws
are PyTorch's, not the reference's, so sampled tokens match it in
distribution only; greedy tokens match exactly.

Streaming: ``submit(stream=q)`` puts each harvest's new tokens on ``q`` as
one list (a plain tick's chunk, a speculative tick's accepted tokens, a
chunked prompt's first token with its tick), or, for a logprob request, as
a (tokens, stats) pair, and ``None`` when the request finishes, expires or
is cancelled; ``ThreadedEngine.stream_one`` and ``stream_one_with_logprobs``
iterate them, and end every open stream if the driver thread dies. The
concatenated chunks are the tokens the request returns without a stream.

Paged ``register_prefix`` is a warm (``_warm_pages``): the prefix's full
pages are prefilled with no slot, published, and held by the content cache
alone; its synchronised rate is ``stats()["prefill_tok_per_s"]``.

Telemetry (``telemetry/``, copies of the reference's modules), all from host
values the scheduler already holds, so no tick gains a device sync:

- **Metrics** (``metrics``, a ``ServingMetrics`` bundle): requests,
  admissions, completions, 429s, deadline evictions, preemptions, degrade
  windows, prefix-cache hit/miss tokens and evictions, tokens generated and
  grammar-masked, drafts accepted and rejected; queue-wait, TTFT (split by
  prefix hit/miss and SLO class), per-token TPOT, end-to-end and
  interference histograms. The clocks are ``time.monotonic()`` stamps on the
  ``Request``; a prefill's time is its host dispatch wall, as in the
  reference.
- **Tracing** (``tracer``, ``submit(trace=...)``): with an armed tracer each
  request writes ``engine.request`` (under the caller's span) with
  ``engine.queue``, one ``engine.prefill`` a dispatch (``kind`` prompt,
  chunk or resume) and one ``engine.decode`` a harvested chunk, and each
  tick an ``engine.tick`` instant; every terminal path closes the spans.
- **Interference**: the slots decode-ready before a tick's prefills absorb
  their wall time (``stats()``' ``interference_max_s`` and its split by
  class), each victim's next decode span naming the tick's longest prefill.
- **Flight recorder** (``flight``): one ``TICK_RING`` row a tick.

Everything else of the reference engine raises ``NotImplementedError`` and
is queued in ``ROADMAP.md``: multi-LoRA stacks, the host-RAM tier and KV
handoff (``export_kv``/``import_kv``), pipelined ticks, meshes, the anomaly
monitor and per-tenant usage metering.
"""

from __future__ import annotations

import bisect
import collections
import queue
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ditl_tpu_torch.config import ModelConfig
from ditl_tpu_torch.data.tokenizer import Tokenizer, check_vocab
from ditl_tpu_torch.infer.cache import init_cache
from ditl_tpu_torch.infer.engine import GenerateConfig, _next_pow2
from ditl_tpu_torch.infer.paged_cache import PageAllocator
from ditl_tpu_torch.infer.sampling import row_uniforms, sample_logits
from ditl_tpu_torch.infer.speculative import (
    _emit_rows,
    device_lookup_draft,
    spec_sample_tokens,
)
from ditl_tpu_torch.models import llama
from ditl_tpu_torch.telemetry.flight import TICK_RING, FlightRecorder
from ditl_tpu_torch.telemetry.serving import ServingMetrics
from ditl_tpu_torch.telemetry.tracing import NULL_TRACER
from ditl_tpu_torch.utils.device import resolve_device
from ditl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["BadRequestError", "ContinuousEngine", "DeadlineExceededError",
           "QueueFullError", "Request", "SLO_CLASSES", "ThreadedEngine", "TokenStream",
           "derive_copy_seed"]

# SLO class -> scheduling rank (lower = served first): admission orders the
# queue by (rank, arrival), and preemption evicts the worst (rank, req_id).
SLO_CLASSES: dict[str, int] = {"interactive": 0, "batch": 1, "best_effort": 2}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (see ROADMAP.md)"
    )


def _lp_stats(logits: torch.Tensor, tok: torch.Tensor, k: int):
    """The chosen token's logprob and the top-``k`` alternatives of the raw
    (B, V) logits, before any temperature or top-p shaping (the lock-step
    Generator's semantics): (B,) f32, (B, k) int64 ids, (B, k) f32."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    top = torch.topk(lp, k, dim=-1)
    return lp.gather(1, tok.long()[:, None])[:, 0], top.indices, top.values


def _fsm_mask(ftab: torch.Tensor, fstate: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Grammar mask: tokens whose table entry in the row of ``fstate`` is
    negative go to -inf. One row gather a state; FREE and DEAD rows allow
    everything, so unconstrained rows pass through unchanged."""
    return torch.where(ftab[fstate.long()] >= 0, logits, float("-inf"))


def _fsm_next(ftab: torch.Tensor, fstate: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """The state(s) after sampling ``tok`` in ``fstate``; a disallowed
    transition (reached only on discarded speculative positions and
    finished rows) clamps to the DEAD trap row 1."""
    nxt = ftab[fstate.long(), tok.long()]
    return torch.where(nxt >= 0, nxt, 1)


def derive_copy_seed(base: int, i: int) -> int:
    """Seed of copy ``i`` of an ``n``/``best_of`` fan-out: copy 0 keeps the
    caller's seed (so ``n=2, seed=s`` reproduces ``n=1, seed=s`` as its
    first candidate); later copies stride by a prime, wrapped into int31."""
    return base if i == 0 else (base + 7919 * i) & 0x7FFFFFFF


def _to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Tensors whose first dim is the slot batch -> numpy arrays of the same
    shapes and dtypes, by one device-to-host copy (packed as float64, which
    holds token ids and f32 values exactly)."""
    flat = torch.cat([t.reshape(t.shape[0], -1).double() for t in tensors], dim=1)
    host = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = int(np.prod(t.shape[1:], dtype=np.int64))
        dt = np.int64 if not t.is_floating_point() else np.float32
        out.append(host[:, at:at + n].reshape(t.shape).astype(dt))
        at += n
    return out


class BadRequestError(ValueError):
    """Request validation failed: the client's fault (the HTTP server maps
    exactly this class to 400)."""


class QueueFullError(RuntimeError):
    """``submit`` found the admission queue at its ``max_queue`` cap (the
    HTTP server answers 429)."""


class DeadlineExceededError(RuntimeError):
    """A request's deadline passed before it completed: the engine evicted
    it from the queue or its slot (the HTTP server answers 504)."""


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
    slot: int | None = None
    finished: bool = False
    slo_class: str = "interactive"
    # Chunked prefill: the next prompt offset to prefill; the request joins
    # decode ticks only once the whole prompt is in the pages.
    prefill_pos: int = 0
    prefilling: bool = False
    # Measured speculative acceptance of this request: tokens emitted over
    # its speculative rounds, and the verify forwards it took part in.
    spec_tokens: int = 0
    spec_forwards: int = 0
    # Streaming: a queue that gets each harvest's fresh tokens as one list
    # (with logprobs, a (tokens, stats) pair), then None when the request
    # ends (finished, expired, cancelled, or the driver died).
    stream: Any = None
    # Logprobs: None = not asked; N >= 0 = the chosen token's logprob and
    # the top N alternatives of every generated token.
    logprobs: int | None = None
    lp_token: list[float] = field(default_factory=list)
    lp_top_ids: list[list[int]] = field(default_factory=list)
    lp_top: list[list[float]] = field(default_factory=list)
    # Optimistic admission: set while a preempted request waits in the
    # queue, with what its exact resume restores: the pending token (a
    # device scalar), its own generator in the state it had (None for a
    # greedy request) and the pending logprob stats.
    preempted: bool = False
    preempt_cur: Any = None
    preempt_gen: Any = None
    preempt_lp: Any = None
    preempt_fst: Any = None  # the slot's grammar state (a device scalar)
    preempt_count: int = 0
    resume_tokens: int = 0  # tokens re-prefilled by its resumes
    # Prompt tokens reused from, and missed by, the prefix cache at its
    # first admission (a mid-prefill victim's re-admission counts nothing).
    cache_hit_tokens: int = 0
    cache_miss_tokens: int = 0
    # Deadline (time.monotonic; None = none), and whether it evicted the
    # request.
    deadline: float | None = None
    expired: bool = False
    # Grammar-constrained decoding: the start state of the request's grammar
    # in the engine's table (0: FREE, unconstrained).
    fsm_start: int = 0
    # Telemetry stamps (time.monotonic; 0.0 = not yet): submit, slot
    # admission, the last prefill dispatch's end, the first and the last
    # harvest. Host clocks only: the latency histograms come from these.
    t_submit: float = 0.0
    t_admitted: float = 0.0
    t_prefill_done: float = 0.0
    t_first: float = 0.0
    t_last_emit: float = 0.0
    # Request tracing: ``trace`` is the upstream span context (the server's
    # request span) the engine's spans chain under; ``request_span`` and
    # ``queue_span`` are the engine's own open spans (None while the tracer
    # is unarmed).
    trace: Any = None
    request_span: Any = None
    queue_span: Any = None
    # Interference: wall seconds of other requests' prefills that shared
    # this request's decode ticks; ``interference_pending`` holds
    # (culprit req_id, culprit prefill tokens, seconds) per tick since the
    # last harvest, drained into the next decode span.
    interference_pending: list = field(default_factory=list)
    interference_s: float = 0.0
    # Estimated device seconds: prefill dispatch walls plus a share of each
    # decode tick the request rode.
    device_time_est_s: float = 0.0

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
    """Slot-based continuous-batching text generation over a contiguous
    cache or a page pool."""

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
        spec_k: int = 8,
        spec_ngram: int = 3,
        spec_min_ngram: int = 1,
        spec_rounds: int | None = None,
        spec_threshold: float | None = None,
        spec_probe_every: int = 32,
        spec_ema: float = 0.7,
        logprobs_k: int = 0,
        fsm_capacity: int = 0,
        draft_params: llama.Params | None = None,
        draft_cfg: ModelConfig | None = None,
        pipeline_ticks: bool = False,
        admission: str = "reserve",
        token_budget: int = 0,
        thrash_window: int = 32,
        host_tier_mb: float = 0,
        metrics: ServingMetrics | None = None,
        tracer=None,
        flight: FlightRecorder | None = None,
        anomaly=None,
        usage=None,
        usage_ledger=None,
        device: str | torch.device = "cuda",
    ):
        """``max_cache_len`` caps the per-slot context below the model's
        ``max_seq_len``. ``cache_mode``: ``"contiguous"`` (one row of that
        context per slot) or ``"paged"``. ``n_pages`` sizes the pool
        (default: the contiguous equivalent, ``n_slots x ceil(max context /
        page_size)`` plus the sentinel page 0). ``max_queue`` caps how many requests may wait for
        a slot; ``submit`` raises ``QueueFullError`` beyond it.

        ``speculative=True`` arms speculative ticks (module note): ``spec_k``
        drafted tokens a round by prompt lookup with n-gram backoff
        ``spec_ngram`` -> ``spec_min_ngram``, ``spec_rounds`` verify rounds a
        tick (default ``decode_chunk / 2.5``), speculating when the predicted
        acceptance (EMA ``spec_ema``, re-probed every ``spec_probe_every``
        ticks) clears ``spec_threshold`` (None: the measured verify/decode
        cost ratio; 0.0 speculates every tick). ``draft_params`` with
        ``draft_cfg`` (same vocabulary, ``max_seq_len`` at least the context
        cap, weights on ``device``) drafts by a small model instead, and then
        every tick speculates.

        ``prefill_chunk`` (0: whole prompts; paged: a multiple of
        ``page_size``) prefills longer prompts one chunk a tick;
        ``token_budget`` (0: none; else at least ``n_slots x decode_chunk``)
        caps each tick's prefill tokens at what its decode steps leave.

        ``admission``: ``"reserve"`` books a request's worst-case pages at
        admission; ``"optimistic"`` books the prompt and one tick, feeds
        pages each tick and preempts on an empty pool (module note), with
        the anti-thrash guard over windows of ``thrash_window`` ticks.
        ``logprobs_k`` (0: off) arms per-token logprobs with up to that many
        alternatives a token. ``fsm_capacity`` (0: off; else at least 2, the
        FREE and DEAD rows) arms grammar-constrained decoding with a table of
        that many rows (module note).

        Telemetry (module note): ``metrics`` (a ``ServingMetrics`` bundle;
        pass one to aggregate across engines, default a bundle of its own),
        ``tracer`` (``telemetry/tracing.Tracer``; default unarmed) and
        ``flight`` (a ``FlightRecorder``; default one of its own). The
        anomaly monitor and usage metering (``anomaly``, ``usage``,
        ``usage_ledger``) are not ported and raise."""
        check_vocab(tokenizer, model_cfg.vocab_size, "ContinuousEngine")
        llama.check_supported(model_cfg)
        if cache_mode not in ("contiguous", "paged"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        if cache_mode == "contiguous":
            if admission != "reserve":
                raise ValueError(
                    "admission='optimistic' requires cache_mode='paged' "
                    "(the contiguous cache has no pages to reclaim)")
            if host_tier_mb:
                raise ValueError(
                    "host_tier_mb requires cache_mode='paged' (the host "
                    "tier spills and swaps KV pages)")
        unported = {
            "host_tier_mb (the host-RAM prefix tier)": host_tier_mb != 0,
            "pipeline_ticks": pipeline_ticks,
            "mesh (sharded serving)": mesh is not None,
            "anomaly (the serving anomaly monitor)": anomaly is not None,
            "usage/usage_ledger (per-tenant usage metering)": (
                usage is not None or usage_ledger is not None),
            "multi-LoRA adapter stacks": bool(params.get("layers", {}).get("lora")),
        }
        for what, asked in unported.items():
            if asked:
                raise _not_ported(what)
        if admission not in ("reserve", "optimistic"):
            raise ValueError(f"admission must be 'reserve' or 'optimistic', "
                             f"got {admission!r}")
        if thrash_window < 1:
            raise ValueError(f"thrash_window must be >= 1, got {thrash_window}")
        if logprobs_k < 0:
            raise ValueError(f"logprobs_k must be >= 0, got {logprobs_k}")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got {prefill_chunk}")
        if cache_mode == "paged":
            if page_size < 16 or page_size & (page_size - 1):
                raise ValueError(f"page_size must be a power of two >= 16, got {page_size}")
            if prefill_chunk % page_size:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} must be a multiple of page_size "
                    f"{page_size} (chunk starts must be page-aligned)")
        # The budget must cover a full decode tick, so the prefill allowance
        # is at least decode_chunk whenever a slot is prefilling or free.
        if token_budget < 0:
            raise ValueError(f"token_budget must be >= 0, got {token_budget}")
        if token_budget and token_budget < n_slots * decode_chunk:
            raise ValueError(
                f"token_budget {token_budget} must cover a full decode tick "
                f"(n_slots {n_slots} x decode_chunk {decode_chunk} = "
                f"{n_slots * decode_chunk}); smaller budgets would zero the "
                f"prefill allowance forever and starve admission")
        self.prefill_chunk = prefill_chunk
        self.token_budget = token_budget
        self._tick_prefill_left: int | None = None  # None: an unbudgeted tick
        self._tick_prefill_spent = 0
        # The largest prefill spend (tokens) of any one tick, and the largest
        # interference one tick's prefills caused (wall seconds), overall
        # and by the victim's SLO class.
        self.max_tick_prefill_tokens = 0
        self.interference_max_s = 0.0
        self.interference_max_by_class: dict[str, float] = {}
        # Serving telemetry, fed from host values the scheduler already
        # holds (no device sync): the latency histograms and counters, the
        # request spans (skipped while the tracer is unarmed) and one
        # flight-ring row a tick.
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.flight = flight if flight is not None else FlightRecorder()
        # This tick's prefill dispatches [(req_id, tokens, wall s)]: the
        # interference attribution's input (step()).
        self._tick_prefills: list[tuple[int, int, float]] = []
        self.tick_count = 0  # scheduler ticks (step() calls)
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
        self._paged = cache_mode == "paged"
        self.admission = admission
        self.preemptions = 0
        # The anti-thrash guard (module note): per window of ticks, tokens
        # re-prefilled by resumes against tokens generated; past the engage
        # ratio new admissions reserve worst-case pages, released after a
        # window under the release ratio with an empty queue.
        self._thrash_window = int(thrash_window)
        self._thrash_engage = 0.5
        self._thrash_release = 0.1
        self._win_ticks = 0
        self._win_resume_tokens = 0
        self._win_gen_tokens = 0
        self._degraded = False
        self.admission_degrades = 0  # windows that engaged the guard
        self.resume_prefill_tokens = 0
        self.page_size = page_size
        dev = self.device
        if cache_mode == "paged":
            self.maxp = -(-self.smax // page_size)
            self.n_pages = n_pages or (n_slots * self.maxp + 1)  # page 0: sentinel
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
            # Evictions are counted, their pages never collected.
            self.allocator = PageAllocator(self.n_pages, on_evict=self._on_pages_evicted,
                                           group_payload=lambda: False)
            self._table = np.zeros((n_slots, self.maxp), np.int32)
            # Device mirror, re-uploaded only when the host table changes.
            self._table_dirty = True
            self._table_dev: torch.Tensor | None = None
            self._slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
        else:
            # One (L, n_slots, smax, K, D) row per slot (int8: plus scales).
            self.cache = init_cache(model_cfg, n_slots, self.smax, dev)
        # Registered prefixes (contiguous cache): prompt-prefix tokens ->
        # (one-row KV of the prefix's bucket, last-token logits, length).
        self._prefixes: dict[tuple[int, ...], tuple[dict, torch.Tensor, int]] = {}
        # Page-warming prefills (register_prefix on pages), synchronised:
        # the measured prefill rate that stats() reports.
        self.prefill_tokens_total = 0
        self.prefill_seconds_total = 0.0
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
        # -- speculative decode ticks (the reference's validation) ----------
        self.speculative = speculative
        if speculative:
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            if not (1 <= spec_min_ngram <= spec_ngram):
                raise ValueError(
                    f"spec_min_ngram must be in [1, spec_ngram], got {spec_min_ngram}")
            self.spec_k = spec_k
            self.spec_ngram = spec_ngram
            self.spec_min_ngram = spec_min_ngram
            # Rounds a tick: a verify round costs about 2.5 decode steps (the
            # threshold's prior), so decode_chunk / 2.5 rounds keep a tick's
            # cost near a plain tick's.
            self.spec_rounds = spec_rounds or max(1, round(decode_chunk / 2.5))
            if self.spec_rounds < 1:
                raise ValueError(f"spec_rounds must be >= 1, got {spec_rounds}")
            self._spec_threshold_cfg = spec_threshold
            self._plain_step_ms: float | None = None
            self._spec_round_ms: float | None = None
            self._timed_plain_keys: set = set()
            self._timed_spec = False
            self.spec_probe_every = spec_probe_every
            self._spec_ema_w = spec_ema
            self.spec_acceptance_ema: float | None = None
            self.spec_ticks = 0
            self.spec_verify_rounds = 0
            # tokens emitted by speculative rounds and the verify forwards
            # rows took part in, over every request
            self.spec_emitted = 0
            self.spec_row_forwards = 0
            self.spec_seconds = 0.0
            self._tick_no = 0
        # -- model drafting (draft_params + draft_cfg) ------------------------
        # A small draft model drafts in place of prompt lookup, over its own
        # contiguous per-slot cache; the target's verify decides every token.
        self.spec_draft = "lookup"
        if draft_params is not None or draft_cfg is not None:
            if draft_params is None or draft_cfg is None:
                raise ValueError("draft_params and draft_cfg must be given together")
            if not speculative:
                raise ValueError("a draft model needs speculative=True (it drafts for "
                                 "speculative ticks)")
            if draft_cfg.vocab_size != model_cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} must match the target's "
                    f"{model_cfg.vocab_size} (same token space)")
            if draft_cfg.max_seq_len < self.smax:
                raise ValueError(
                    f"draft max_seq_len {draft_cfg.max_seq_len} is below the serving "
                    f"context cap {self.smax}")
            llama.check_supported(draft_cfg)
            self.spec_draft = "model"
            self.draft_params = draft_params
            self.draft_cfg = draft_cfg
            self.draft_cache = init_cache(draft_cfg, n_slots, self.smax, dev)
            self.draft_steps = 0  # draft-model decode forwards (k + 1 a round)
        # Per-slot token history (prompt + generated, the pending ``cur`` at
        # column pos): the draft source of prompt-lookup ticks, written at
        # admission and carried through every tick while lookup speculation
        # is armed; one column otherwise.
        self._track_hist = speculative and self.spec_draft == "lookup"
        self.hist = torch.zeros((n_slots, self.smax if self._track_hist else 1),
                                dtype=torch.long, device=dev)
        # The pending token's logprob stats per slot (chosen, top ids, top
        # logprobs), carried between ticks like ``cur``.
        self.logprobs_k = logprobs_k
        if logprobs_k:
            self.lp_chosen = torch.zeros((n_slots,), dtype=torch.float32, device=dev)
            self.lp_ids = torch.zeros((n_slots, logprobs_k), dtype=torch.long, device=dev)
            self.lp_top = torch.zeros((n_slots, logprobs_k), dtype=torch.float32, device=dev)
        # -- grammar-constrained decoding (infer/grammar.py) ------------------
        # Row conventions: table[s, t] >= 0 allows token t in state s and is
        # the next state; -1 masks it. Row 0 FREE (all allowed, parks), row 1
        # DEAD (all allowed, traps; reached only by finished rows and
        # discarded speculative positions, and all-allowed so that a masked
        # row is never all -inf).
        if fsm_capacity < 0:
            raise ValueError(f"fsm_capacity must be >= 0, got {fsm_capacity}")
        self.fsm_capacity = fsm_capacity
        self.guided = fsm_capacity > 0
        if self.guided:
            if fsm_capacity < 2:
                raise ValueError("fsm_capacity must be >= 2 (FREE + DEAD rows)")
            v = model_cfg.vocab_size
            self._fsm_host = np.full((fsm_capacity, v), -1, np.int32)
            self._fsm_host[0, :] = 0  # FREE
            self._fsm_host[1, :] = 1  # DEAD
            self._fsm_used = 2
            self._grammars: dict[str, int] = {}
            # The device table, of the full capacity; rows past
            # _fsm_dev_rows are uploaded by _fsm_device before a tick uses
            # them. Registrations come from HTTP threads while the driver
            # ticks: the lock pairs each host append with the upload, so a
            # tick never sees a half-installed grammar.
            self._fsm_dev = torch.full((fsm_capacity, v), -1, dtype=torch.int32, device=dev)
            self._fsm_dev_rows = 0
            self._fsm_lock = threading.Lock()
            self.fstates = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        # Prefill forwards by attention path: causal over an empty bucket
        # (K1 where it tiles), and masked over cached context (matched or
        # seeded prefixes, earlier chunks; paged warms count here too).
        self.prefills_cold = 0
        self.prefills_prefix_hit = 0

    # -- prefix caching --------------------------------------------------------

    def register_prefix(self, prefix_tokens: list[int]) -> None:
        """Prefill ``prefix_tokens`` once for every later prompt that starts
        with them (a shared system prompt). Contiguous cache: the prefix's
        KV row and last logits are kept on the device until
        ``clear_prefixes``, and an admission whose prompt starts with a
        registered prefix (the longest wins) copies the row into its slot
        and prefills only the rest. Paged cache: prefix reuse is automatic,
        so this only warms the page cache (``_warm_pages``)."""
        if not prefix_tokens:
            raise ValueError("prefix must be non-empty")
        if len(prefix_tokens) + 1 > self.smax:
            raise ValueError(
                f"prefix {len(prefix_tokens)} leaves no room in cache {self.smax}")
        if self._paged:
            self._warm_pages(prefix_tokens)
            return
        key = tuple(prefix_tokens)
        if key in self._prefixes:
            return
        n, cfg, dev = len(prefix_tokens), self.cfg, self.device
        p_bucket = min(_next_pow2(n, floor=16), self.smax)
        row = init_cache(cfg, 1, p_bucket, dev)
        ids = torch.full((1, p_bucket), self.tokenizer.pad_id, dtype=torch.long)
        ids[0, :n] = torch.tensor(prefix_tokens, dtype=torch.long)
        q_pos = torch.arange(p_bucket, device=dev)
        mask = (q_pos[None, None, :] <= q_pos[None, :, None]) & (q_pos[None, None, :] < n)
        hidden = llama.forward(self.params, ids.to(dev), cfg, positions=q_pos[None],
                               cache=row, cache_index=0, attn_mask=mask,
                               return_hidden=True)
        last = llama.logits_from_hidden(self.params, hidden[:, n - 1])[0]
        self._prefixes[key] = (row, last, n)
        logger.info("registered prefix of %d tokens (bucket %d)", n, p_bucket)

    def _warm_pages(self, tokens: list[int]) -> None:
        """Paged ``register_prefix``: prefill and publish the full pages of
        ``tokens`` with no slot, so later prompts match them. Pages already
        published are reused; the pages end up held by the content cache
        alone (evictable). A pool that cannot hold the fresh pages makes
        this a logged no-op: a warm is a hint and never raises or leaks."""
        ps = self.page_size
        n_full = len(tokens) // ps
        if n_full == 0:
            return
        matched: list[int] = []
        parent = 0
        for i in range(n_full):
            pid = self.allocator.lookup((parent, tuple(tokens[i * ps:(i + 1) * ps])))
            if pid is None:
                break
            self.allocator.retain(pid)
            matched.append(pid)
            parent = pid
        n_fresh = n_full - len(matched)
        if n_fresh == 0:
            for pid in matched:
                self.allocator.release(pid)
            return
        try:
            fresh = self.allocator.alloc(n_fresh)
        except MemoryError:
            for pid in matched:
                self.allocator.release(pid)
            logger.warning("register_prefix: pool cannot hold %d fresh pages; "
                           "skipping warm-up", n_fresh)
            return
        pages = matched + fresh
        row = np.zeros((self.maxp,), np.int32)
        row[:n_full] = pages
        d = len(matched) * ps
        s = n_full * ps - d
        t0 = time.monotonic()
        self._run_paged_prefill(tokens, d, s, s, row)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prefill_tokens_total += s
        self.prefill_seconds_total += time.monotonic() - t0
        self.allocator.publish_chain(tokens[: n_full * ps], ps, pages)
        for pid in pages:
            self.allocator.release(pid)
        logger.info("warmed %d pages (%d reused) for a %d-token prefix",
                    n_fresh, len(matched), len(tokens))

    def clear_prefixes(self) -> None:
        """Drop every registered prefix (frees their device memory)."""
        self._prefixes.clear()

    def _match_prefix(self, prompt: list[int]):
        """The longest registered prefix of ``prompt`` as (row, last
        logits, length), or None."""
        best = None
        for key, entry in self._prefixes.items():
            d = entry[2]
            if d <= len(prompt) and tuple(prompt[:d]) == key and (
                    best is None or d > best[2]):
                best = entry
        return best

    # -- left out of the port -------------------------------------------------

    def export_kv(self, *args, **kwargs):
        raise _not_ported("KV handoff (export_kv)")

    def import_kv(self, *args, **kwargs):
        raise _not_ported("KV handoff (import_kv)")

    # -- guided decoding --------------------------------------------------------

    def register_grammar(self, g) -> int:
        """Install a compiled grammar (``infer/grammar.CompiledGrammar``) into
        the engine's transition table; returns the grammar's start state, to
        pass (or the CompiledGrammar itself) as ``submit``'s ``grammar=``.
        Registration is deduplicated by the table's content, so serving
        layers can call this per request; ``fsm_capacity`` is a hard cap:
        registration raises when a new grammar would not fit. Columns past
        the grammar's vocabulary stay -1 (masked)."""
        import hashlib

        if not self.guided:
            raise ValueError(
                "engine built with fsm_capacity=0; construct with "
                "fsm_capacity >= grammar states + 2 to serve guided requests")
        tn = np.ascontiguousarray(g.token_next, np.int32)
        digest = hashlib.sha1(tn.tobytes()).hexdigest()
        with self._fsm_lock:
            if digest in self._grammars:
                return self._grammars[digest]
            s, vt = tn.shape
            v = self._fsm_host.shape[1]
            if vt > v:
                raise ValueError(
                    f"grammar table vocab {vt} exceeds the model head width {v}")
            if self._fsm_used + s > self.fsm_capacity:
                raise ValueError(
                    f"fsm_capacity exhausted: {self._fsm_used} rows used + "
                    f"{s} needed > {self.fsm_capacity}")
            base = self._fsm_used
            # rows past _fsm_used are all -1 already: write the grammar's
            # columns, relocated by the row offset
            self._fsm_host[base: base + s, :vt] = np.where(tn >= 0, tn + base, -1)
            self._fsm_used += s
            self._grammars[digest] = base
        logger.info("registered grammar %s: %d states at rows [%d, %d)",
                    getattr(g, "source", "?"), s, base, base + s)
        return base

    def _fsm_device(self) -> torch.Tensor:
        """The device table, after uploading the rows registered since the
        last upload (only appended rows: no slot points past ``_fsm_used``
        before ``register_grammar`` returns), under the lock and on the
        stream the ticks use."""
        with self._fsm_lock:
            a, b = self._fsm_dev_rows, self._fsm_used
            if a < b:
                self._fsm_dev[a:b].copy_(torch.from_numpy(self._fsm_host[a:b]))
                self._fsm_dev_rows = b
            return self._fsm_dev

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
        admission and picks preemption victims; it never changes a request's
        result. ``stream`` (any object with ``put``, e.g. a ``queue.Queue``)
        receives each harvest's new tokens as one list (a (tokens, stats)
        pair with ``logprobs``) and a terminal ``None``. ``logprobs``: the
        top-N alternatives of every generated token (0: the chosen token's
        logprob alone), N at most ``logprobs_k``. ``deadline_s``: seconds
        from now after which the request is evicted instead of finished.
        ``grammar``: constrains the completion (not the prompt) to a
        compiled grammar, an ``infer/grammar.CompiledGrammar`` (registered
        here) or an int start state from ``register_grammar``; needs
        ``fsm_capacity > 0``. Registration comes after every other check,
        since table rows are never evicted. ``trace``: the upstream span or
        ``SpanContext`` (``telemetry/tracing.py``) the request's engine
        spans chain under while the engine's tracer is armed; ignored
        otherwise."""
        unported = {
            "multi-LoRA adapters": bool(adapter_id),
            "per-tenant usage metering": tenant is not None,
        }
        for what, asked in unported.items():
            if asked:
                raise _not_ported(what)
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self.metrics.queue_full.inc()
            raise QueueFullError(
                f"admission queue full ({self.max_queue} waiting requests)"
            )
        if logprobs is not None:
            if self.logprobs_k == 0:
                raise BadRequestError(
                    "logprobs requested but the engine was built with logprobs_k=0")
            if not 0 <= logprobs <= self.logprobs_k:
                raise BadRequestError(
                    f"logprobs={logprobs} out of range [0, {self.logprobs_k}]")
        if seed is not None and not (-2**31 <= int(seed) < 2**31):
            raise BadRequestError("seed must fit in int32")
        if deadline_s is not None and not (
                isinstance(deadline_s, (int, float)) and deadline_s == deadline_s):
            raise BadRequestError("deadline_s must be a number")  # NaN too
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
        fsm_start = 0
        if grammar is not None:
            if not self.guided:
                raise BadRequestError(
                    "grammar requested but the engine was built with fsm_capacity=0")
            if isinstance(grammar, int):
                with self._fsm_lock:  # register_grammar appends from HTTP threads
                    used = self._fsm_used
                if not 0 <= grammar < used:
                    raise BadRequestError(
                        f"grammar start state {grammar} not in the installed table "
                        f"(rows [0, {used}))")
                fsm_start = grammar
            else:
                fsm_start = self.register_grammar(grammar)
        req = Request(
            req_id=self._next_id,
            prompt=list(prompt),
            max_new_tokens=max_new,
            temperature=gen.temperature if temperature is None else temperature,
            top_p=gen.top_p if top_p is None else top_p,
            seed=(self._base_seed + self._next_id) if seed is None else int(seed),
            slo_class=slo_class,
            stream=stream,
            logprobs=logprobs,
            deadline=None if deadline_s is None else time.monotonic() + float(deadline_s),
            fsm_start=fsm_start,
            t_submit=time.monotonic(),
        )
        self._next_id += 1
        if self.tracer.armed:
            # The request span stays open until the request ends; the queue
            # span closes at its admission.
            req.trace = trace
            req.request_span = self.tracer.start_span(
                "engine.request", parent=trace, req=req.req_id,
                prompt_tokens=len(req.prompt), max_new_tokens=req.max_new_tokens)
            req.queue_span = self.tracer.start_span(
                "engine.queue", parent=req.request_span, req=req.req_id)
        self.metrics.requests.inc()
        self._enqueue(req)
        return req.req_id

    def _enqueue(self, req: Request) -> None:
        """Insert by (class rank, req_id): FIFO within a class, classes in
        priority order; a preempted request's old id puts it ahead of every
        newer request of its class. Submitters and the driver's preemptions
        both insert, under the lock."""
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
        if not self._paged:
            return
        need = -(-(len(prompt) + max_new) // self.page_size)
        if need > self.n_pages - 1:  # page 0 is the reserved sentinel
            raise BadRequestError(
                f"request needs {need} pages but the pool only has "
                f"{self.n_pages - 1} (n_pages={self.n_pages}, "
                f"page_size={self.page_size})"
            )

    # -- paged admission / prefill --------------------------------------------

    def _free_slot_pages(self, slot: int) -> None:
        """Release ``slot``'s generator and, on pages, its pages (a
        contiguous row needs no freeing: its next prefill overwrites it)."""
        self._gens[slot] = None
        if not self._paged:
            return
        for pid in self._slot_pages[slot]:
            self.allocator.release(pid)
        self._slot_pages[slot] = []
        self._table[slot, :] = 0
        self._table_dirty = True

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
                             generator: torch.Generator | None, *,
                             s_bucket: int | None = None,
                             sample: bool = True,
                             tokens: list[int] | None = None) -> torch.Tensor | None:
        """Prefill ``tokens[d:d+s]`` (default ``req.prompt``; a resume
        passes prompt + generated tokens) into ``slot``'s pages
        (``_run_paged_prefill``) and, with ``sample``, sample the first
        token (``_sample_first``); a chunked prompt's earlier chunks sample
        nothing (None)."""
        src = req.prompt if tokens is None else tokens
        hidden = self._run_paged_prefill(src, d, s, s_bucket or s, self._table[slot])
        if not sample:
            return None
        last = llama.logits_from_hidden(self.params, hidden[:, s - 1])  # (1, V)
        return self._sample_first(req, slot, last, generator)

    def _run_paged_prefill(self, src: list[int], d: int, s: int, s_bucket: int,
                           row_pages: np.ndarray) -> torch.Tensor:
        """Prefill ``src[d:d+s]`` into the pages of ``row_pages`` (a page
        table row: the context's pages first, then those the chunk writes
        from page ``d // page_size``); returns the final-normed hidden
        states (1, bucket, D). A slot's prefill passes its table row, page
        warming a row of its own.

        The bucket is ``s_bucket`` rounded up to a power of two of at least
        one page. With no context (``d == 0``) the prefill is causal over
        the bucket with pad validity in segment ids (the flash kernel's
        path). With a context, the context's pages are gathered into a
        transient contiguous row (a power-of-two bucket of pages) and the
        masked cached forward runs over it. Either way the chunk's whole
        pages are then written in place; bucket columns past ``s`` hold
        garbage that stays masked until a later chunk or decode overwrites
        it."""
        cfg, dev, ps = self.cfg, self.device, self.page_size
        write_pids = row_pages[d // ps:]
        s_bucket = min(_next_pow2(max(s_bucket, ps), floor=ps), self.maxp * ps)
        ctx = self._ctx_pages_bucket(d)
        n_wp = s_bucket // ps
        n_l, n_k, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        dtype = llama.torch_dtype(cfg.dtype)
        ids = torch.full((1, s_bucket), self.tokenizer.pad_id, dtype=torch.long)
        ids[0, :s] = torch.tensor(src[d: d + s], dtype=torch.long)
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
            ctx_ids = torch.tensor(np.asarray(row_pages[:ctx], np.int64), device=dev)

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
        return hidden

    def _sample_first(self, req: Request, slot: int, last: torch.Tensor,
                      generator: torch.Generator | None) -> torch.Tensor:
        """A prefill's first token from its last prompt position's (1, V)
        logits, a device scalar (no host sync): masked at the request's
        grammar start state (the slot's state becomes the one after it),
        and with logprobs armed, its stats stored as the slot's pending
        ones."""
        dev = self.device
        masked = last
        if self.guided:
            ftab = self._fsm_device()
            start = torch.full((1,), req.fsm_start, dtype=torch.int32, device=dev)
            masked = _fsm_mask(ftab, start, last)
        # Scalar mode: the same draws as the tick's per-row mode from this
        # generator; temperature <= 0 is greedy there, so it is 0 here.
        first = sample_logits(masked, generator, temperature=max(req.temperature, 0.0),
                              top_k=self.gen.top_k, top_p=req.top_p)
        if self.guided:
            self.fstates[slot] = _fsm_next(ftab, start, first)[0]
        if self.logprobs_k:
            self._store_lp(slot, *(x[0] for x in _lp_stats(last, first, self.logprobs_k)))
        return first[0]

    def _store_lp(self, slot: int, chosen, ids, top) -> None:
        """Set ``slot``'s pending logprob stats (in place)."""
        self.lp_chosen[slot] = chosen
        self.lp_ids[slot] = ids
        self.lp_top[slot] = top

    def _optimistic(self) -> bool:
        """Does admission book one tick of headroom (not worst-case pages)
        now? Optimistic admission, unless the anti-thrash guard holds."""
        return self.admission == "optimistic" and not self._degraded

    def _take_pages(self, slot: int, req: Request, matched: list[int],
                    n_total: int) -> bool:
        """Allocate ``n_total - len(matched)`` fresh pages and give ``slot``
        ``matched`` + them for the queue head ``req`` (removed from the
        queue); on an empty pool release ``matched`` and return False."""
        try:
            fresh = self.allocator.alloc(n_total - len(matched))
        except MemoryError:
            for pid in matched:
                self.allocator.release(pid)
            return False
        with self._queue_lock:  # by identity: a submit may have inserted ahead
            self._queue.remove(req)
        pages = matched + fresh
        self._slot_pages[slot] = pages
        self._table[slot, :] = 0
        self._table[slot, : len(pages)] = pages
        self._table_dirty = True
        req.slot = slot
        self._slots[slot] = req
        return True

    def _admit_paged_slot(self, slot: int) -> bool:
        """Admit the queue head into ``slot`` (a preempted one resumes,
        ``_resume_paged_slot``): match its prefix, reserve its worst-case
        pages (prompt + max_new; optimistic admission: the prompt and one
        tick) or leave it queued (False). An unchunked admission prefills
        its whole unmatched prompt now, so it also waits while that would
        bust the tick's prefill allowance; a chunked one parks the slot and
        costs nothing until its chunks run."""
        req = self._queue[0]
        if req.preempted:
            return self._resume_paged_slot(slot, req)
        ps = self.page_size
        matched = self.allocator.match_prefix(req.prompt, ps)  # retained
        d0 = len(matched) * ps
        s = len(req.prompt) - d0
        chunked = bool(self.prefill_chunk) and s > self.prefill_chunk
        if not self._budget_allows(0 if chunked else s):
            for pid in matched:
                self.allocator.release(pid)
            return False
        worst = -(-(len(req.prompt) + req.max_new_tokens) // ps)
        n_total = worst
        if self._optimistic():
            want = -(-(len(req.prompt) + self._tick_advance_bound()) // ps)
            n_total = min(max(want, len(matched)), worst)
        if not self._take_pages(slot, req, matched, n_total):
            return False
        self._note_admitted(req)
        self._note_prefix_cache(req, d0)
        # In-place writes of this slot's row: no copy of the slot state.
        if chunked:
            # Parked until its last chunk lands: a dead row of every tick.
            req.prefill_pos = d0
            req.prefilling = True
            self._gens[slot] = None
            self.cur[slot] = self.tokenizer.pad_id
            self.pos[slot] = 0
        else:
            w0, m0 = time.time(), time.monotonic()
            first = self._paged_prefill_chunk(req, slot, d0, s, self._slot_generator(req))
            self._record_prefill(req, s, d0, w0, time.monotonic() - m0, "prompt")
            self._go_live(req, first)
        self.temps[slot] = req.temperature
        self.top_ps[slot] = req.top_p
        self.limits[slot] = len(req.prompt) + req.max_new_tokens
        return True

    def _slot_generator(self, req: Request) -> torch.Generator | None:
        """The generator of ``req``'s slot, seeded from the request's seed
        (None for a greedy request); it draws the first token, then every
        decode tick's."""
        gen = None
        if req.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(req.seed)
        self._gens[req.slot] = gen
        return gen

    def _go_live(self, req: Request, first: torch.Tensor) -> None:
        """The whole prompt is in the cache: publish its pages (paged) and
        make the row decode from ``first`` at position len(prompt)."""
        slot = req.slot
        req.prefilling = False
        if self._paged:
            self._publish_prompt_pages(req, slot)
        self.cur[slot] = first
        self.pos[slot] = len(req.prompt)
        self._set_hist(slot, req.prompt, first)
        self._draft_prefill(req, slot)

    def _chunk_bucket(self, d: int, s: int) -> int:
        """Write-window bucket of a chunk of ``s`` tokens at offset ``d``:
        ``prefill_chunk``, except near the cache end, where the window must
        still fit."""
        if d + self.prefill_chunk <= self.smax:
            return self.prefill_chunk
        return min(_next_pow2(s, floor=16), self.smax - d)

    def _advance_prefill(self, req: Request) -> None:
        """One chunk of a chunked prefill, at the page-aligned offset
        ``prefill_pos``. Only the last chunk samples: the slot's generator is
        seeded there, from the request's seed, so the first token and every
        later draw are those of an unchunked admission whatever the number
        of ticks the slot was parked."""
        d = req.prefill_pos
        s = min(self.prefill_chunk, len(req.prompt) - d)
        last = d + s >= len(req.prompt)
        gen = self._slot_generator(req) if last else None
        if self._paged:
            first = self._paged_prefill_chunk(req, req.slot, d, s, gen,
                                              s_bucket=self.prefill_chunk, sample=last)
        else:
            # a chunk is a suffix continuation at its offset: the masked path
            logits = self._suffix_prefill(req.prompt, req.slot, d, s,
                                          self._chunk_bucket(d, s))
            first = self._sample_first(req, req.slot, logits, gen) if last else None
        req.prefill_pos += s
        if last:
            self._go_live(req, first)

    # -- contiguous admission / prefill -----------------------------------------

    def _slot_row(self, slot: int) -> dict:
        """``slot``'s row of the contiguous cache as (L, 1, smax, ...) views:
        a forward's writes land in place."""
        return {name: c[:, slot:slot + 1] for name, c in self.cache.items()}

    def _admit_contiguous_slot(self, slot: int) -> bool:
        """Admit the queue head into ``slot`` of the contiguous cache, or
        leave it queued (False) while its unchunked prefill would bust the
        tick's allowance. The longest registered prefix of its prompt is
        matched once; the prefill charges the rest of the prompt, a chunked
        admission nothing until its chunks run. A chunked prompt's row is
        parked at ``pos = smax - 1`` (``cur = pad``): every decode tick
        writes each row at its ``pos``, and the last slot is never attended
        before it is legitimately written."""
        req = self._queue[0]
        prefix = self._match_prefix(req.prompt)
        d0 = 0 if prefix is None else prefix[2]
        s = len(req.prompt) - d0
        chunked = bool(self.prefill_chunk) and s > self.prefill_chunk
        if not self._budget_allows(0 if chunked else s):
            return False
        with self._queue_lock:  # by identity: a submit may have inserted ahead
            self._queue.remove(req)
        self._note_admitted(req)
        req.slot = slot
        self._slots[slot] = req
        self._note_prefix_cache(req, d0)
        if prefix is not None:
            self._seed_prefix(slot, prefix[0])
        if chunked:
            req.prefill_pos = d0
            req.prefilling = True
            self._gens[slot] = None
            self.cur[slot] = self.tokenizer.pad_id
            self.pos[slot] = self.smax - 1
        else:
            w0, m0 = time.time(), time.monotonic()
            gen = self._slot_generator(req)
            if prefix is None:
                logits = self._cold_prefill(req.prompt, slot)
            elif s == 0:  # the prompt is the prefix: its stored logits
                logits = prefix[1][None]
            else:
                logits = self._suffix_prefill(req.prompt, slot, d0, s,
                                              min(_next_pow2(s, floor=16), self.smax - d0))
            first = self._sample_first(req, slot, logits, gen)
            self._record_prefill(req, s, d0, w0, time.monotonic() - m0, "prompt")
            self._go_live(req, first)
        self.temps[slot] = req.temperature
        self.top_ps[slot] = req.top_p
        self.limits[slot] = len(req.prompt) + req.max_new_tokens
        return True

    def _seed_prefix(self, slot: int, row: dict) -> None:
        """Copy a registered prefix's KV row (int8: values and scales) into
        the first bucket of ``slot``'s row."""
        for name, c in self.cache.items():
            p_bucket = row[name].shape[2]
            c[:, slot:slot + 1, :p_bucket] = row[name].to(c.dtype)

    def _cold_prefill(self, prompt: list[int], slot: int) -> torch.Tensor:
        """A whole prompt into ``slot``'s empty row: causal over its bucket
        (``next_pow2``, at least 16, at most ``smax``) with pad validity in
        segment ids, the flash kernel's path (K1) where it tiles; returns
        the last prompt position's (1, V) logits."""
        n, dev = len(prompt), self.device
        p_bucket = min(_next_pow2(n, floor=16), self.smax)
        ids = torch.full((1, p_bucket), self.tokenizer.pad_id, dtype=torch.long)
        ids[0, :n] = torch.tensor(prompt, dtype=torch.long)
        q_pos = torch.arange(p_bucket, device=dev)
        seg = (q_pos < n).to(torch.int32)[None]
        hidden = llama.forward(self.params, ids.to(dev), self.cfg, positions=q_pos[None],
                               segment_ids=seg, cache=self._slot_row(slot), cache_index=0,
                               prefill_causal=True, return_hidden=True)
        self.prefills_cold += 1
        return llama.logits_from_hidden(self.params, hidden[:, n - 1])

    def _suffix_prefill(self, prompt: list[int], slot: int, d: int, s: int,
                        s_bucket: int) -> torch.Tensor:
        """``prompt[d:d+s]`` into ``slot``'s row after the ``d`` positions
        already there (a seeded prefix, earlier chunks), over a window of
        ``s_bucket`` positions (at most ``smax - d``: a window is never
        shifted); attention is the masked plain path over the whole row
        (``slot_index <= position``). Returns the last real position's
        (1, V) logits."""
        dev = self.device
        ids = torch.full((1, s_bucket), self.tokenizer.pad_id, dtype=torch.long)
        ids[0, :s] = torch.tensor(prompt[d:d + s], dtype=torch.long)
        q_pos = torch.arange(d, d + s_bucket, device=dev)
        mask = torch.arange(self.smax, device=dev)[None, None, :] <= q_pos[None, :, None]
        hidden = llama.forward(self.params, ids.to(dev), self.cfg, positions=q_pos[None],
                               cache=self._slot_row(slot), cache_index=d, attn_mask=mask,
                               return_hidden=True)
        self.prefills_prefix_hit += 1
        return llama.logits_from_hidden(self.params, hidden[:, s - 1])

    # -- optimistic admission: preemption and exact resume --------------------

    def _tick_advance_bound(self) -> int:
        """The most KV positions one decode tick of a slot writes, which the
        per-tick page feed must cover: ``decode_chunk``, or a speculative
        tick's ``spec_rounds x (k+1)`` emissions plus the ``k + 1`` verify
        window that every round writes, however little it accepts."""
        if self.speculative:
            return self.spec_rounds * (self.spec_k + 1) + self.spec_k + 1
        return self.decode_chunk

    def _resume_paged_slot(self, slot: int, req: Request) -> bool:
        """Re-admit the preempted queue head ``req`` into ``slot``: match
        prompt + tokens against the published pages, book pages as
        admission does (or leave it queued: False), re-prefill the unmatched
        part in ``prefill_chunk`` pieces within this admission (the whole of
        it charged to the tick's budget; nothing sampled), then restore the
        pending token at ``pos = len(prompt + tokens)``, the request's own
        generator, the pending logprob stats, the lookup history and the
        drafter's cache over the whole context."""
        ps = self.page_size
        ctx = req.prompt + req.tokens
        pos = len(ctx)  # the pending token's write position
        cap = len(req.prompt) + req.max_new_tokens
        matched = self.allocator.match_prefix(ctx, ps)  # retained
        if not self._budget_allows(pos - len(matched) * ps):
            for pid in matched:
                self.allocator.release(pid)
            return False
        worst = -(-cap // ps)
        n_total = worst
        if self._optimistic():
            n_total = min(-(-(pos + self._tick_advance_bound()) // ps), worst)
        if not self._take_pages(slot, req, matched, max(n_total, len(matched))):
            return False
        self._note_admitted(req)  # a no-op: a resume is not a second admission
        d0 = len(matched) * ps
        self._win_resume_tokens += pos - d0  # the anti-thrash guard's count
        self.resume_prefill_tokens += pos - d0
        req.resume_tokens += pos - d0
        step, d = self.prefill_chunk or pos - d0, d0
        w0, m0 = time.time(), time.monotonic()
        while d < pos:
            n = min(step, pos - d)
            self._paged_prefill_chunk(req, slot, d, n, None, sample=False, tokens=ctx)
            d += n
        if pos > d0:
            # a resume's prefill stalls the tick as a fresh one does
            self._record_prefill(req, pos - d0, d0, w0, time.monotonic() - m0, "resume")
        self.cur[slot] = req.preempt_cur
        self.pos[slot] = pos
        self._gens[slot] = req.preempt_gen
        if self.logprobs_k:
            self._store_lp(slot, *req.preempt_lp)
        if self.guided and req.preempt_fst is not None:
            self.fstates[slot] = req.preempt_fst
        self._set_hist(slot, ctx, req.preempt_cur)
        self._draft_prefill(req, slot, ctx)
        self.temps[slot] = req.temperature
        self.top_ps[slot] = req.top_p
        self.limits[slot] = cap
        req.preempted = False
        req.preempt_cur = req.preempt_gen = req.preempt_lp = req.preempt_fst = None
        return True

    def _pick_victim(self, needy: Request) -> int | None:
        """The slot whose request ranks worst in (SLO class, req_id) order,
        if strictly worse than ``needy``'s (None otherwise): best-effort
        work goes first, then batch, and within a class the youngest, so the
        best-ranked request always progresses and a class never evicts a
        better one. Prefilling slots are eligible victims."""
        best: int | None = None
        for slot, req in enumerate(self._slots):
            if req is None or req.finished or req.slo_rank <= needy.slo_rank:
                continue
            if best is None or req.slo_rank > self._slots[best].slo_rank:
                best = slot
        return best

    def _preempt_slot(self, slot: int) -> None:
        """Reclaim ``slot``'s pages mid-flight and requeue its request at its
        old id. The whole pages of prompt + tokens are published first, so
        they stay resident (evictable under pressure) and the resume is a
        near-full prefix match. A mid-prefill victim has sampled nothing:
        its written chunks' whole pages are published and it is requeued
        fresh."""
        req = self._slots[slot]
        if req.prefilling:
            self._publish_tokens(req.prompt[: req.prefill_pos], slot)
            req.prefilling = False
            req.prefill_pos = 0
        else:
            req.preempted = True
            req.preempt_cur = self.cur[slot].clone()
            req.preempt_gen = self._gens[slot]
            if self.logprobs_k:
                req.preempt_lp = (self.lp_chosen[slot].clone(), self.lp_ids[slot].clone(),
                                  self.lp_top[slot].clone())
            if self.guided:
                req.preempt_fst = self.fstates[slot].clone()
            self._publish_tokens(req.prompt + req.tokens, slot)
        self._slots[slot] = None
        self._free_slot_pages(slot)
        self._enqueue(req)
        self.preemptions += 1
        self.metrics.preemptions.inc()
        req.preempt_count += 1
        logger.info("preempted request %d (%s)", req.req_id,
                    "requeued fresh" if not req.preempted else f"{len(req.tokens)} tokens in")

    def _topup_pages(self) -> None:
        """Optimistic admission's per-tick page feed, before dispatch: every
        decoding slot's table must cover prompt + tokens + one tick
        (``_tick_advance_bound``, capped at its worst case). On an empty pool
        the worse-ranked victim is preempted and the feed retried, or, with
        none, the needy slot itself. Also closes the anti-thrash guard's
        window every ``thrash_window`` ticks."""
        if self.admission != "optimistic":
            return
        self._win_ticks += 1
        if self._win_ticks >= self._thrash_window:
            ratio = self._win_resume_tokens / max(1, self._win_gen_tokens)
            # Release needs the backlog drained too: while degraded,
            # worst-case reservations stop the preemptions the ratio counts.
            if not self._degraded and ratio > self._thrash_engage:
                self._degraded = True
                self.admission_degrades += 1
                self.metrics.admission_degrades.inc()
                logger.info("optimistic admission degraded to worst-case reservations "
                            "(re-prefilled / generated = %.2f over %d ticks)",
                            ratio, self._thrash_window)
            elif self._degraded and ratio < self._thrash_release and not self._queue:
                self._degraded = False
                logger.info("optimistic admission re-engaged (ratio %.2f)", ratio)
            self._win_ticks = self._win_resume_tokens = self._win_gen_tokens = 0
        ps, adv = self.page_size, self._tick_advance_bound()
        for slot in range(self.n_slots):
            req = self._slots[slot]
            if req is None or req.prefilling or req.finished:
                continue
            cap = len(req.prompt) + req.max_new_tokens
            # the harvested frontier, not an accumulated bound: speculative
            # ticks write more than they keep
            need = -(-min(len(req.prompt) + len(req.tokens) + adv, cap) // ps)
            while need > len(self._slot_pages[slot]):
                have = len(self._slot_pages[slot])
                try:
                    fresh = self.allocator.alloc(need - have)
                except MemoryError:
                    victim = self._pick_victim(req)
                    self._preempt_slot(slot if victim is None else victim)
                    if victim is None:
                        break
                    continue
                self._table[slot, have: have + len(fresh)] = fresh
                self._slot_pages[slot].extend(fresh)
                self._table_dirty = True

    # -- deadlines ---------------------------------------------------------------

    def _expire(self, req: Request) -> None:
        """A deadline eviction ends ``req`` with the tokens it has: waiters
        see ``expired``, a stream its terminal None; counted apart from
        completion and cancellation."""
        req.expired = req.finished = True
        self.metrics.deadline_expired.inc()
        self._close_spans(req, expired=True)
        if req.stream is not None:
            req.stream.put(None)
        self._completed[req.req_id] = req

    def _expire_deadlines(self) -> None:
        """Evict every queued or slotted request past its deadline, once a
        tick before admission and dispatch, so expired work costs no
        further prefill or decode. A queued preempted request holds no
        pages; a slotted one's are released."""
        now = time.monotonic()
        with self._queue_lock:
            gone = [r for r in self._queue if r.deadline is not None and now >= r.deadline]
            for req in gone:
                self._queue.remove(req)
        for req in gone:
            self._expire(req)
        for slot, req in enumerate(self._slots):
            if req is not None and req.deadline is not None and now >= req.deadline:
                self._slots[slot] = None
                self._free_slot_pages(slot)
                self._expire(req)

    # -- the per-tick token budget --------------------------------------------

    def _budget_allows(self, cost: int) -> bool:
        """Does this tick's prefill allowance cover ``cost`` more tokens? The
        tick's first prefill always passes (a tight budget bounds the stall
        and must not starve admission), so the per-tick bound is
        ``max(one chunk, budget - decode_ready x decode_chunk)``."""
        if self._tick_prefill_left is None or cost <= 0:
            return True
        return self._tick_prefill_spent == 0 or cost <= self._tick_prefill_left

    def _record_prefill(self, req: Request, tokens: int, offset: int, w0: float,
                        dt: float, kind: str) -> None:
        """Register one prefill dispatch of ``tokens`` at ``offset``, which
        began at wall time ``w0`` and took ``dt`` seconds: this tick's
        interference attribution (``step()``), a debit of the tick's
        allowance, the request's device-time estimate and, with the tracer
        armed, an ``engine.prefill`` span of ``kind`` (``prompt``,
        ``chunk`` or ``resume``) under the request's span. ``dt`` is the
        host's dispatch wall, as in the reference, whose dispatch is
        asynchronous too: kernels may still run after it, and nothing
        synchronises the device to measure them."""
        self._tick_prefills.append((req.req_id, tokens, dt))
        self._tick_prefill_spent += tokens
        if self._tick_prefill_left is not None:
            self._tick_prefill_left = max(0, self._tick_prefill_left - tokens)
        self.max_tick_prefill_tokens = max(self.max_tick_prefill_tokens,
                                           self._tick_prefill_spent)
        req.device_time_est_s += dt
        req.t_prefill_done = time.monotonic()
        if req.request_span is not None:
            self.tracer.start_span(
                "engine.prefill", parent=req.request_span, t0=w0, req=req.req_id,
                offset=offset, tokens=tokens, kind=kind,
            ).end(t_end=w0 + dt)

    # -- telemetry -------------------------------------------------------------

    def _note_admitted(self, req: Request) -> None:
        """Queue -> slot: the admission counter, the queue wait and the
        queue span's end, once a request (a resume is not an admission)."""
        if req.t_admitted:
            return
        req.t_admitted = time.monotonic()
        self.metrics.admitted.inc()
        if req.t_submit:  # a Request built by hand carries no stamp
            self.metrics.queue_wait.observe(req.t_admitted - req.t_submit)
        if req.queue_span is not None:
            req.queue_span.end(queue_wait_s=round(req.t_admitted - req.t_submit, 6)
                               if req.t_submit else 0.0)
            req.queue_span = None

    def _note_prefix_cache(self, req: Request, hit_tokens: int) -> None:
        """A first admission's prompt split into tokens reused from the
        prefix cache and tokens prefilled, into the request and the metrics'
        counters. Once a request: a mid-prefill victim's re-admission would
        count its prompt again, its own published pages as hits."""
        if req.cache_hit_tokens or req.cache_miss_tokens:
            return
        req.cache_hit_tokens = hit_tokens
        req.cache_miss_tokens = len(req.prompt) - hit_tokens
        self.metrics.note_prefix_cache(req.cache_hit_tokens, req.cache_miss_tokens)

    def _on_pages_evicted(self, group) -> None:
        """The allocator's eviction hook: count the reclaim."""
        self.metrics.prefix_cache_evictions.inc()

    def _close_spans(self, req: Request, **attrs) -> None:
        """End the request's open spans (idempotent): completion, deadline
        expiry and cancellation all come here, so no span stays open."""
        if req.queue_span is not None:
            req.queue_span.end(**attrs)
            req.queue_span = None
        if req.request_span is not None:
            req.request_span.end(tokens=len(req.tokens), **attrs)
            req.request_span = None

    def _advance_prefill_chunks(self, reqs: list[Request]) -> None:
        """One chunk for each prefilling request, in SLO order (class rank,
        then age); a chunk that would bust the allowance waits for a later
        tick."""
        for req in sorted(reqs, key=lambda r: r.slo_rank):
            if not req.prefilling:
                continue
            cost = min(self.prefill_chunk, len(req.prompt) - req.prefill_pos)
            if not self._budget_allows(cost):
                continue
            d_before = req.prefill_pos
            w0, m0 = time.time(), time.monotonic()
            self._advance_prefill(req)
            self._record_prefill(req, req.prefill_pos - d_before, d_before, w0,
                                 time.monotonic() - m0, "chunk")

    # -- the draft model -------------------------------------------------------

    def _draft_prefill(self, req: Request, slot: int, ctx: list[int] | None = None) -> None:
        """Admission hook of model drafting: ``ctx`` (default the prompt; a
        resume's prompt + tokens, since the drafter's cache keeps no
        frontier and the slot's row may hold another request's KV) into
        ``slot``'s row of the draft cache, always whole (prefix reuse and the
        target's chunks do not apply to the drafter's private cache). No
        sampling: the drafter's first prediction comes in the spec tick,
        from the pending ``cur``. A prompt longer than ``prefill_chunk`` is
        fed in chunks at their offsets under the causal mask (the bucket
        tail past a chunk's tokens is written with garbage the draft scan
        overwrites before it attends it)."""
        if self.spec_draft != "model":
            return
        dcfg, dev, pad = self.draft_cfg, self.device, self.tokenizer.pad_id
        ctx = req.prompt if ctx is None else ctx
        # the slot's row of the draft cache, as views: the writes land in place
        row = {name: c[:, slot:slot + 1] for name, c in self.draft_cache.items()}
        if self.prefill_chunk and len(ctx) > self.prefill_chunk:
            iota = torch.arange(self.smax, device=dev)
            d = 0
            while d < len(ctx):
                s = min(self.prefill_chunk, len(ctx) - d)
                s_bucket = self._chunk_bucket(d, s)
                ids = torch.full((1, s_bucket), pad, dtype=torch.long)
                ids[0, :s] = torch.tensor(ctx[d:d + s], dtype=torch.long)
                q_pos = torch.arange(d, d + s_bucket, device=dev)[None]
                llama.forward(self.draft_params, ids.to(dev), dcfg, positions=q_pos,
                              cache=row, cache_index=d,
                              attn_mask=iota[None, None, :] <= q_pos[:, :, None],
                              return_hidden=True)
                d += s
            return
        p_bucket = min(_next_pow2(len(ctx), floor=16), self.smax)
        ids = torch.full((1, p_bucket), pad, dtype=torch.long)
        ids[0, :len(ctx)] = torch.tensor(ctx, dtype=torch.long)
        seg = (torch.arange(p_bucket, device=dev) < len(ctx)).to(torch.int32)[None]
        llama.forward(self.draft_params, ids.to(dev), dcfg,
                      positions=torch.arange(p_bucket, device=dev)[None], segment_ids=seg,
                      cache=row, cache_index=0, prefill_causal=True, return_hidden=True)

    def _draft_scan(self, cur: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """k greedy draft-model decode steps from the pending ``cur``: (B, k)
        drafts. The scan feeds k + 1 tokens, ``cur`` then all k drafts, so
        every draft's KV is written (a full-accept round would otherwise
        leave the last draft's position a hole the next scan attends); the
        (k + 1)-th output is discarded. Feeding ``cur`` at ``pos`` also
        writes the KV the previous round's bonus token never got, and stale
        KV past a row's position stays masked until it is fed again."""
        dcfg, smax = self.draft_cfg, self.smax
        iota = torch.arange(smax, device=self.device)
        tok, p, drafts = cur, pos.long(), []
        for _ in range(self.spec_k + 1):
            logits = llama.forward(self.draft_params, tok[:, None], dcfg,
                                   positions=p[:, None], cache=self.draft_cache,
                                   cache_index=p, attn_mask=(iota[None, :] <= p[:, None])[:, None])
            tok = torch.argmax(logits[:, 0], dim=-1)
            drafts.append(tok)
            p = torch.clamp(p + 1, max=smax - 1)
            self.draft_steps += 1
        return torch.stack(drafts[:-1], dim=1)

    def _set_hist(self, slot: int, prompt: list[int], first: torch.Tensor) -> None:
        """Seed the slot's draft history: the prompt, then the pending first
        token at column len(prompt) (``hist[pos] == cur`` between ticks).
        ``first`` stays a device scalar: no host sync at admission."""
        if not self._track_hist:
            return
        n = min(len(prompt), self.smax - 1)
        row = torch.zeros((self.smax,), dtype=torch.long)
        row[:n] = torch.tensor(prompt[:n], dtype=torch.long)
        self.hist[slot] = row.to(self.device)
        self.hist[slot, n] = first

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self._slots[slot] is not None or not self._queue:
                continue
            admit = self._admit_paged_slot if self._paged else self._admit_contiguous_slot
            if not admit(slot):
                # Priority FIFO: the head request does not fit the pool right
                # now; smaller or lower-class requests must not starve it.
                break

    # -- decode ----------------------------------------------------------------

    def _table_device(self) -> torch.Tensor:
        if self._table_dirty or self._table_dev is None:
            self._table_dev = torch.tensor(self._table, device=self.device)
            self._table_dirty = False
        return self._table_dev

    def _tick_tails(self, tail_len: int) -> dict:
        """The pools plus a fresh (L, B, K, ``tail_len``, D) K/V tail pair
        in the compute dtype: a paged tick's cache."""
        cfg = self.cfg
        shape = (cfg.num_layers, self.n_slots, cfg.num_kv_heads, tail_len, cfg.head_dim)
        dtype = llama.torch_dtype(cfg.dtype)
        return {**self.cache,
                "tk": torch.zeros(shape, dtype=dtype, device=self.device),
                "tv": torch.zeros(shape, dtype=dtype, device=self.device)}

    def _decode_tick(self, occupied: list[bool]) -> tuple[np.ndarray, tuple | None]:
        """One decode tick of ``decode_chunk`` steps over every slot, in the
        reference's step order; returns the emitted tokens (B, chunk) and,
        with logprobs armed, their stats (chosen (B, chunk), top ids and top
        logprobs (B, chunk, k); each emitted token's are the pending ones
        when it was fed, and the pending ones then become the stats of the
        step's new token). With speculation armed, each step's pending token
        also goes into the slot's history (the reference's ``track``)."""
        cfg, dev = self.cfg, self.device
        chunk = self.decode_chunk
        pad, eos = self.tokenizer.pad_id, self.tokenizer.eos_id
        active = [r for r, live in zip(self._slots, occupied) if live]
        sampled = any(r.temperature > 0.0 for r in active)
        # top_p matters only when something samples.
        topp = sampled and any(r.top_p < 1.0 for r in active)
        paged = self._paged
        if paged:
            table = self._table_device()
            # starts = pos: dead rows then have pos - starts == 0 live tail
            # columns, so the flush writes nothing for them.
            starts = self.pos
            cache = self._tick_tails(chunk)
        else:
            iota = torch.arange(self.smax, device=dev)
        uniforms = None
        if sampled:
            gens = [g if live and r.temperature > 0.0 else None
                    for g, r, live in zip(self._gens, self._slots, occupied)]
            uniforms = row_uniforms(gens, (chunk, cfg.vocab_size), dev)
        cur, pos, hist = self.cur, self.pos, self.hist
        n_lp = self.logprobs_k
        lp = (self.lp_chosen, self.lp_ids, self.lp_top) if n_lp else None
        guided = self.guided
        if guided:
            ftab, fst = self._fsm_device(), self.fstates
        done = ~torch.tensor(occupied, device=dev)
        emitted, lp_emitted = [], []
        for t in range(chunk):
            if paged:
                done = done | (pos >= self.limits)
            step_alive = ~done
            if paged:
                lengths = torch.where(step_alive, pos + 1, 0).to(torch.int32)
                step_logits = llama.forward(
                    self.params, cur[:, None], cfg, positions=pos[:, None], cache=cache,
                    paged={"table": table, "lengths": lengths, "starts": starts, "t": t},
                )[:, 0]
            else:
                # every row writes at its own pos (dead and parked rows too:
                # the write-then-unmask invariant) and attends slots <= pos
                step_logits = llama.forward(
                    self.params, cur[:, None], cfg, positions=pos[:, None],
                    cache=self.cache, cache_index=pos,
                    attn_mask=(iota[None, :] <= pos[:, None])[:, None],
                )[:, 0]
            masked = _fsm_mask(ftab, fst, step_logits) if guided else step_logits
            if sampled:
                nxt = sample_logits(
                    masked, None, temperature=self.temps, top_k=self.gen.top_k,
                    top_p=self.top_ps if topp else 1.0, uniforms=uniforms[:, t],
                )
            else:
                nxt = torch.argmax(masked, dim=-1)
            emitted.append(torch.where(step_alive, cur, pad))
            if n_lp:
                lp_emitted.append(lp)
                lp = _lp_stats(step_logits, nxt, n_lp)
            done = done | (cur == eos)
            if guided:
                fst = torch.where(done, fst, _fsm_next(ftab, fst, nxt))
            # the contiguous row's last slot bounds a position
            pos = torch.where(step_alive, pos + 1 if paged
                              else torch.clamp(pos + 1, max=self.smax - 1), pos)
            cur = torch.where(done, pad, nxt)
            if self._track_hist:
                hist = _emit_rows(hist, cur[:, None], pos, (~done).long())
            self.decode_steps += 1
        if paged:
            _flush_tail_into_pools(self.cache, cache["tk"], cache["tv"], starts, pos,
                                   table, self.page_size)
        self.cur, self.pos, self.hist = cur, pos, hist
        if guided:
            self.fstates = fst
        stats = ()
        if n_lp:
            self.lp_chosen, self.lp_ids, self.lp_top = lp
            stats = tuple(torch.stack([e[i] for e in lp_emitted], dim=1) for i in range(3))
        toks, *stats = _to_host(torch.stack(emitted, dim=1), *stats)  # the tick's one copy
        return toks, tuple(stats) or None

    def _spec_accept(self, logits: torch.Tensor, tokens_in: torch.Tensor,
                     gens: list, sampled: bool) -> tuple[torch.Tensor, torch.Tensor]:
        """(n_acc, next token) of a verify round: the exact-match rule when
        every row is greedy, else rejection sampling (``spec_sample_tokens``,
        whose greedy rows take the same exact-match rule)."""
        k = self.spec_k
        if sampled:
            return spec_sample_tokens(logits, tokens_in[:, 1:], gens, self.temps,
                                      self.top_ps, top_k=self.gen.top_k)
        cand = torch.argmax(logits, dim=-1)  # (B, k+1)
        eq = tokens_in[:, 1:] == cand[:, :k]
        n_acc = torch.cumprod(eq.long(), dim=-1).sum(-1)
        return n_acc, cand.gather(1, n_acc[:, None])[:, 0]

    @staticmethod
    def _fsm_spec_path(ftab: torch.Tensor, fst: torch.Tensor, draft: torch.Tensor) -> torch.Tensor:
        """(B, k+1) grammar states along the draft path: column 0 the row's
        state, column j+1 the state after ``draft[:, j]``. An illegal draft
        clamps to DEAD: its own position is masked under the state before
        it, so acceptance rejects there and the positions after it are
        discarded. k gathers, on the device."""
        states = [fst]
        for j in range(draft.shape[1]):
            states.append(_fsm_next(ftab, states[-1], draft[:, j]))
        return torch.stack(states, dim=1)

    def _spec_lp_round(self, logits: torch.Tensor, draft: torch.Tensor,
                       n_acc: torch.Tensor, nxt: torch.Tensor, lp: tuple, bufs: tuple,
                       n_out: torch.Tensor, e: torch.Tensor) -> tuple[tuple, tuple]:
        """A speculative round's logprob stats (``logprobs_k > 0``): emission
        j's are the pending ones for j = 0 (``cur``'s, scored when it was
        chosen) and, for j >= 1, ``draft[j-1]`` scored by the verify's logits
        at position j - 1 (the raw distribution, as a plain step scores);
        written into ``bufs`` at each row's ``n_out`` as the tokens are. The
        new pending stats score ``nxt`` under the logits that chose it
        (position ``n_acc``)."""
        n_lp = self.logprobs_k
        k = logits.shape[1] - 1
        lp_all = torch.log_softmax(logits[:, :k].float(), dim=-1)
        top = torch.topk(lp_all, n_lp, dim=-1)  # (B, k, N)
        seqs = (torch.cat([lp[0][:, None], lp_all.gather(2, draft[..., None].long())[..., 0]], 1),
                torch.cat([lp[1][:, None], top.indices], 1),
                torch.cat([lp[2][:, None], top.values], 1))
        bufs = tuple(_emit_rows(b, q, n_out, e) for b, q in zip(bufs, seqs))
        sel = logits.gather(1, n_acc[:, None, None].expand(-1, 1, logits.shape[2]))[:, 0]
        return _lp_stats(sel, nxt, n_lp), bufs

    def _spec_tick(self, occupied: list[bool], sampled: bool
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray, tuple | None]:
        """One speculative tick of ``spec_rounds`` rounds over every slot, the
        reference's ``_build_spec_paged_decode`` step for step: draft by
        prompt lookup or by the draft model, one (B, k+1) verify forward (its K/V into the tail at
        ``off = pos - starts``, attention through K3's verify), accept, emit
        (capped by ``limits`` and by EOS/pad before the span), extend the
        history; then the plain tick's flush. Returns the emitted tokens
        (B, rounds * (k+1)), their per-row counts, the rounds each row was
        live and, with logprobs armed, the emitted tokens' stats
        (``_spec_lp_round``), from one device-to-host copy."""
        cfg, dev = self.cfg, self.device
        n_b, k, rounds = self.n_slots, self.spec_k, self.spec_rounds
        pad, eos, smax = self.tokenizer.pad_id, self.tokenizer.eos_id, self.smax
        out_len = rounds * (k + 1)
        paged = self._paged
        if paged:
            table = self._table_device()
            starts = self.pos
            cache = self._tick_tails(max(rounds * (k + 1), 8))
        else:
            iota = torch.arange(smax, device=dev)
        gens = [g if live and r.temperature > 0.0 else None
                for g, r, live in zip(self._gens, self._slots, occupied)]
        q_idx = torch.arange(k + 1, device=dev)
        out = torch.full((n_b, out_len), pad, dtype=torch.long, device=dev)
        n_out = torch.zeros((n_b,), dtype=torch.long, device=dev)
        rr = torch.zeros((n_b,), dtype=torch.long, device=dev)
        zeros = torch.zeros((n_b, 1), dtype=torch.long, device=dev)
        cur, pos, hist = self.cur, self.pos, self.hist
        guided = self.guided
        if guided:
            ftab, fst = self._fsm_device(), self.fstates
        n_lp = self.logprobs_k
        if n_lp:
            lp = (self.lp_chosen, self.lp_ids, self.lp_top)
            lp_bufs = (torch.zeros((n_b, out_len), dtype=torch.float32, device=dev),
                    torch.zeros((n_b, out_len, n_lp), dtype=torch.long, device=dev),
                    torch.zeros((n_b, out_len, n_lp), dtype=torch.float32, device=dev))
        done = ~torch.tensor(occupied, device=dev)
        for _ in range(rounds):
            if paged:
                done = done | (pos >= self.limits)
            live = ~done
            if self.spec_draft == "model":
                draft = self._draft_scan(cur, pos)
            else:
                # hist[pos] holds the pending cur: the context is pos + 1 tokens.
                draft = device_lookup_draft(hist, torch.clamp(pos + 1, max=smax), k=k,
                                            ngram=self.spec_ngram,
                                            min_ngram=self.spec_min_ngram)
            tokens_in = torch.cat([cur[:, None], draft], dim=1)
            positions = pos[:, None] + q_idx[None, :]
            if paged:
                lengths = torch.where(live, pos + 1, 0).to(torch.int32)
                logits = llama.forward(
                    self.params, tokens_in, cfg, positions=positions, cache=cache,
                    paged={"table": table, "lengths": lengths, "starts": starts,
                           "off": pos - starts},
                )
            else:
                # per-row writes at each slot's depth; stale KV past a
                # rejected draft stays masked until the next window rewrites it
                logits = llama.forward(
                    self.params, tokens_in, cfg, positions=positions, cache=self.cache,
                    cache_index=pos,
                    attn_mask=iota[None, None, :] <= positions[:, :, None],
                )
            if guided:
                # each position masked at its state along the draft's path
                path = self._fsm_spec_path(ftab, fst, draft)
                ver_logits = _fsm_mask(ftab, path, logits)
            else:
                ver_logits = logits
            n_acc, nxt = self._spec_accept(ver_logits, tokens_in, gens, sampled)
            in_span = q_idx[None, :] <= n_acc[:, None]
            is_term = (tokens_in == eos) | (tokens_in == pad)
            term_before = (torch.cumsum(is_term.long(), dim=1) - is_term.long()) > 0
            emit = in_span & ~term_before & live[:, None]
            if paged:  # a page-budget cap; the contiguous tick has none
                emit = emit & (positions < self.limits[:, None])
            e = emit.long().sum(1)
            hit_term = (emit & is_term).any(1)
            out = _emit_rows(out, tokens_in, n_out, e)
            if n_lp:
                lp, lp_bufs = self._spec_lp_round(logits, draft, n_acc, nxt, lp, lp_bufs,
                                                  n_out, e)
            n_out = n_out + e
            append_seq = torch.where(q_idx[None, :] == n_acc[:, None], nxt[:, None],
                                     torch.cat([draft, zeros], dim=1))
            grow = torch.where(hit_term, 0, e)
            if self._track_hist:
                hist = _emit_rows(hist, append_seq, torch.clamp(pos + 1, max=smax), grow)
            adv = pos + e.to(pos.dtype)
            pos = torch.where(live, adv if paged else torch.clamp(adv, max=smax - 1), pos)
            done = done | hit_term
            if guided:
                s_at = path.gather(1, n_acc[:, None])[:, 0]
                fst = torch.where(done, fst, _fsm_next(ftab, s_at, nxt))
            cur = torch.where(done, pad, nxt)
            rr = rr + live.long()
        self.spec_verify_rounds += rounds
        if paged:
            _flush_tail_into_pools(self.cache, cache["tk"], cache["tv"], starts, pos,
                                   table, self.page_size)
        self.cur, self.pos, self.hist = cur, pos, hist
        if guided:
            self.fstates = fst
        bufs = ()
        if n_lp:
            self.lp_chosen, self.lp_ids, self.lp_top = lp
            bufs = lp_bufs
        toks, n_out, rr, *stats = _to_host(out, n_out, rr, *bufs)  # the tick's one copy
        return toks, n_out, rr, tuple(stats) or None

    def _harvest(self, emitted: np.ndarray, counts: np.ndarray | None = None,
                 lp: tuple | None = None) -> None:
        """Append each live slot's tokens up to EOS/pad or its budget;
        finished requests publish their pages and free their slot.
        ``counts`` (speculative ticks): each row's valid emissions, since a
        round emits 1..k+1 tokens and a live row's output need not end in
        pad filler. ``lp`` (chosen, top ids, top logprobs, column-aligned
        with ``emitted``): the stats, kept by requests that asked. A
        streamed request gets its new tokens as one list (with logprobs, a
        (tokens, stats) pair sliced to its N), and ``None`` once it
        finishes.

        Telemetry, from one host clock read: tokens generated (and those
        decoded under a grammar), the first chunk's TTFT (split by prefix
        hit or miss and by SLO class), later chunks' per-token TPOT (the
        chunk's interval over its tokens, one observation a token), one
        ``engine.decode`` span a chunk carrying the interference absorbed
        since the last harvest, and at the finish the completion count, the
        end-to-end latency and the request's spans closed."""
        eos, pad = self.tokenizer.eos_id, self.tokenizer.pad_id
        t_now = time.monotonic()
        # the live decode rows of this tick share its device time
        n_share = sum(1 for r in self._slots if r is not None and not r.prefilling)
        for slot, req in enumerate(list(self._slots)):
            if req is None or req.prefilling:
                # a parked slot's row is pad filler, not an empty generation
                continue
            row = emitted[slot] if counts is None else emitted[slot][: counts[slot]]
            keep_lp = lp is not None and req.logprobs is not None
            fresh = []
            for j, tok in enumerate(row):
                tok = int(tok)
                if tok in (eos, pad) or len(req.tokens) >= req.max_new_tokens:
                    req.finished = True
                    break
                req.tokens.append(tok)
                fresh.append(tok)
                if keep_lp:
                    req.lp_token.append(float(lp[0][slot, j]))
                    req.lp_top_ids.append([int(x) for x in lp[1][slot, j]])
                    req.lp_top.append([float(x) for x in lp[2][slot, j]])
            if len(req.tokens) >= req.max_new_tokens:
                req.finished = True
            self._win_gen_tokens += len(fresh)  # the anti-thrash guard's count
            if fresh:
                self._note_harvest(req, fresh, t_now, n_share)
            if req.stream is not None and fresh:
                if keep_lp:
                    n, m = req.logprobs, len(fresh)
                    req.stream.put((fresh, {
                        "token_logprobs": req.lp_token[-m:],
                        "top_ids": [r[:n] for r in req.lp_top_ids[-m:]],
                        "top_logprobs": [r[:n] for r in req.lp_top[-m:]]}))
                else:
                    req.stream.put(fresh)
            if req.finished:
                self.metrics.completed.inc()
                if req.t_submit:
                    self.metrics.e2e.observe(t_now - req.t_submit)
                self._close_spans(req, interference_total_s=round(req.interference_s, 6))
                if req.stream is not None:
                    req.stream.put(None)
                self._completed[req.req_id] = req
                self._slots[slot] = None
                # Publish before releasing: the content cache's own
                # reference keeps the conversation's pages resident.
                if self._paged:
                    self._publish_generated_pages(req, slot)
                self._free_slot_pages(slot)

    def _note_harvest(self, req: Request, fresh: list[int], t_now: float,
                      n_share: int) -> None:
        """One harvested chunk's telemetry (``_harvest``): counters,
        TTFT or TPOT, the device-time share, and the decode span."""
        m = self.metrics
        m.tokens_generated.inc(len(fresh))
        if req.fsm_start > 0:
            m.grammar_masked.inc(len(fresh))  # every one decoded under the mask
        first_chunk = req.t_first == 0.0
        if first_chunk:
            req.t_first = t_now
            if req.t_submit:
                ttft = t_now - req.t_submit
                m.ttft.observe(ttft)
                (m.ttft_cache_hit if req.cache_hit_tokens > 0
                 else m.ttft_cache_miss).observe(ttft)
                cls_hist = m.ttft_by_class.get(req.slo_class)
                if cls_hist is not None:
                    cls_hist.observe(ttft)
        elif req.t_last_emit:
            # the first chunk's interval is the prefill's: TTFT's, not TPOT's
            m.decode_token.observe((t_now - req.t_last_emit) / len(fresh), n=len(fresh))
        prev_emit = req.t_last_emit or req.t_prefill_done or req.t_admitted or req.t_submit
        if prev_emit and n_share:
            req.device_time_est_s += max(0.0, t_now - prev_emit) / n_share
        if req.request_span is not None:
            # the interval the client waited for this chunk; the largest
            # prefill since the last harvest names the culprit
            prev = req.t_last_emit or req.t_admitted or req.t_submit
            dur = max(0.0, t_now - prev) if prev else 0.0
            attrs = {"req": req.req_id, "tokens": len(fresh), "first": first_chunk}
            if req.interference_pending:
                cid, ctok, _ = max(req.interference_pending, key=lambda e: e[2])
                attrs.update(
                    interference_s=round(sum(x for *_, x in req.interference_pending), 6),
                    interference_culprit=cid, culprit_prefill_tokens=ctok)
            w_now = time.time()
            self.tracer.start_span("engine.decode", parent=req.request_span,
                                   t0=w_now - dur, **attrs).end(t_end=w_now)
        req.interference_pending.clear()
        req.t_last_emit = t_now

    def step(self) -> None:
        """One scheduler tick: evict requests past their deadlines, advance
        the chunks of prefills in flight, admit queued requests, advance the
        newly admitted chunked prompts' first chunks, feed optimistic
        admission's pages (which may preempt), then decode one chunk of
        every decode-ready slot (speculatively when armed and predicted to
        win, ``_use_spec_tick``) and harvest it. With a token budget, the
        prefills draw what the decode-ready slots' ``decode_chunk`` steps
        leave of it.

        Telemetry: the slots decode-ready before the tick's prefills are
        their victims, each observing the tick's prefill wall as
        interference; an armed tracer records an ``engine.tick`` instant;
        and the flight recorder's tick ring gets one row, all from host
        state (no device sync)."""
        self.tick_count += 1
        self._expire_deadlines()
        decode_ready = [r for r in self._slots if r is not None and not r.prefilling]
        self._tick_prefills = []
        self._tick_prefill_spent = 0
        self._tick_prefill_left = (
            max(0, self.token_budget - len(decode_ready) * self.decode_chunk)
            if self.token_budget else None)
        # In-flight chunks before admission: admission must not spend each
        # tick's first-prefill pass and park an older prefill behind it.
        inflight = [r for r in self._slots if r is not None and r.prefilling]
        self._advance_prefill_chunks(inflight)
        self._admit()
        seen = {id(r) for r in inflight}
        self._advance_prefill_chunks([r for r in self._slots if r is not None
                                      and r.prefilling and id(r) not in seen])
        prefill_s = sum(dt for _, _, dt in self._tick_prefills)
        if self._tick_prefills and prefill_s > 0 and decode_ready:
            self._attribute_interference(decode_ready, prefill_s)
        if self.tracer.armed:
            self.tracer.instant(
                "engine.tick", tick=self.tick_count,
                slots_busy=sum(r is not None for r in self._slots),
                prefilling=sum(1 for r in self._slots if r is not None and r.prefilling),
                queue_depth=len(self._queue), prefill_s=round(prefill_s, 6))
        self._topup_pages()
        self._decode_and_harvest()
        m = self.metrics
        by_class = collections.Counter(r.slo_class for r in self._queue)
        self.flight.ring(TICK_RING).record(
            tick=self.tick_count,
            queue_depth=len(self._queue),
            queue_by_class={cls: by_class.get(cls, 0) for cls in SLO_CLASSES},
            slots_busy=sum(r is not None for r in self._slots),
            prefilling=sum(1 for r in self._slots if r is not None and r.prefilling),
            prefill_tokens=self._tick_prefill_spent,
            budget_left=self._tick_prefill_left,
            preemptions=self.preemptions,
            # the registry's counters are host numbers
            deadline_expired=int(m.deadline_expired.value),
            queue_full=int(m.queue_full.value),
            completed=int(m.completed.value),
        )

    def _attribute_interference(self, victims: list[Request], prefill_s: float) -> None:
        """This tick's prefills delayed every decode-ready request's next
        chunk by ``prefill_s``: one ``tpot_interference`` observation a
        victim (and its class's), the largest stalls, and a pending culprit
        entry (the tick's longest prefill) for the victim's next decode
        span."""
        culprit_id, culprit_tokens, _ = max(self._tick_prefills, key=lambda e: e[2])
        self.interference_max_s = max(self.interference_max_s, prefill_s)
        for victim in victims:
            if victim.finished:
                continue
            self.metrics.tpot_interference.observe(prefill_s)
            cls_hist = self.metrics.interference_by_class.get(victim.slo_class)
            if cls_hist is not None:
                cls_hist.observe(prefill_s)
            self.interference_max_by_class[victim.slo_class] = max(
                self.interference_max_by_class.get(victim.slo_class, 0.0), prefill_s)
            victim.interference_s += prefill_s
            victim.interference_pending.append((culprit_id, culprit_tokens, prefill_s))

    def _decode_and_harvest(self) -> None:
        """One decode tick of every decode-ready slot (speculative when
        ``_use_spec_tick`` says so), then its harvest; nothing on an idle
        tick."""
        occupied = [r is not None and not r.prefilling for r in self._slots]
        if not any(occupied):  # host-side check: no device work on idle ticks
            return
        active = [r for r, live in zip(self._slots, occupied) if live]
        sampled = any(r.temperature > 0.0 for r in active)
        t0 = time.perf_counter()
        if self._use_spec_tick(active):
            emitted, counts, rr, lp = self._spec_tick(occupied, sampled)
            dt = time.perf_counter() - t0
            self.spec_seconds += dt
            self._record_tick_time("spec", dt * 1e3)
            self._account_spec(counts, rr)
            self.spec_ticks += 1
            self.decode_ticks += 1
            self._harvest(emitted, counts, lp)
            return
        emitted, lp = self._decode_tick(occupied)
        dt = time.perf_counter() - t0
        self.decode_seconds += dt
        self.decode_ticks += 1
        if self.speculative:
            # the plain tick's key, as the reference's compiled programs
            self._record_tick_time((sampled, sampled and any(r.top_p < 1.0 for r in active)),
                                   dt * 1e3)
        self._harvest(emitted, lp=lp)

    # -- speculation's decision ------------------------------------------------

    @property
    def spec_threshold(self) -> float:
        """Break-even tokens per verify forward for a speculative tick: the
        configured value, else the measured ratio of a verify round's cost to
        a plain step's, with a prior of 2.5 until both have been timed."""
        if self._spec_threshold_cfg is not None:
            return self._spec_threshold_cfg
        if self._plain_step_ms and self._spec_round_ms:
            return self._spec_round_ms / self._plain_step_ms
        return 2.5

    def _record_tick_time(self, kind, dt_ms: float) -> None:
        """EMA of the cost per round (``kind == "spec"``) or per plain step
        (``kind``: the plain tick's (sampled, top-p) key), leaving out the
        first timed tick of each kind, as the reference leaves out each
        program's compile call. Host clock; each tick ends in its one
        device-to-host copy."""
        if kind == "spec":
            if not self._timed_spec:
                self._timed_spec = True
                return
            per = dt_ms / self.spec_rounds
            self._spec_round_ms = (per if self._spec_round_ms is None
                                   else 0.5 * self._spec_round_ms + 0.5 * per)
            return
        if kind not in self._timed_plain_keys:
            self._timed_plain_keys.add(kind)
            return
        per = dt_ms / self.decode_chunk
        self._plain_step_ms = (per if self._plain_step_ms is None
                               else 0.5 * self._plain_step_ms + 0.5 * per)

    def _use_spec_tick(self, active: list[Request]) -> bool:
        """Speculate this tick? The acceptance predicted for the current
        slots (each request's measured tokens per forward, else the engine's
        EMA) against ``spec_threshold``; a probe when nothing is measured
        yet and every ``spec_probe_every`` ticks."""
        if not self.speculative:
            return False
        self._tick_no += 1
        if self.spec_draft == "model":
            # Every tick: the draft cache stays in step with the target's
            # positions only while speculative ticks run, and a drafter is
            # configured because it pays. The acceptance EMA still reports.
            return True
        preds = []
        for r in active:
            if r.spec_forwards > 0:
                preds.append(r.spec_tokens / r.spec_forwards)
            elif self.spec_acceptance_ema is not None:
                preds.append(self.spec_acceptance_ema)
            else:
                return True  # nothing measured anywhere yet: probe
        if self._tick_no % self.spec_probe_every == 0:
            return True
        return sum(preds) / len(preds) >= self.spec_threshold

    def _account_spec(self, counts: np.ndarray, rr: np.ndarray) -> None:
        """Per-request acceptance (tokens emitted, verify forwards taken part
        in), the drafted tokens accepted and rejected (a round emits its
        accepted drafts plus one token of its own, so accepted = emitted -
        rounds, clamped where a budget cut a round), and the engine's EMA of
        the tick's mean tokens per forward."""
        accs = []
        for slot, req in enumerate(self._slots):
            if req is None or req.prefilling:
                continue
            req.spec_tokens += int(counts[slot])
            req.spec_forwards += int(rr[slot])
            self.spec_emitted += int(counts[slot])
            self.spec_row_forwards += int(rr[slot])
            if rr[slot] > 0:
                accepted = max(0, int(counts[slot]) - int(rr[slot]))
                self.metrics.spec_accepted.inc(accepted)
                self.metrics.spec_rejected.inc(max(0, int(rr[slot]) * self.spec_k - accepted))
                accs.append(counts[slot] / rr[slot])
        if accs:
            mean = float(np.mean(accs))
            self.spec_acceptance_ema = (
                mean if self.spec_acceptance_ema is None
                else self._spec_ema_w * self.spec_acceptance_ema
                + (1.0 - self._spec_ema_w) * mean
            )

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(r is not None for r in self._slots)

    def _prefix_cache_stats(self) -> dict:
        """Prompt tokens reused from the prefix cache and prefilled, their
        ratio, and the pool's LRU evictions. Read from the metrics'
        counters, so a shared bundle aggregates across engines."""
        m = self.metrics
        hit = int(m.prefix_cache_hit_tokens.value)
        miss = int(m.prefix_cache_miss_tokens.value)
        out = {"hit_tokens": hit, "miss_tokens": miss,
               "evictions": self.allocator.evictions if self._paged else 0}
        if hit + miss:
            out["hit_ratio"] = round(hit / (hit + miss), 4)
        return out

    def stats(self) -> dict:
        """Operational snapshot, host state only (no device sync); the page
        pool's fields on pages only, as the reference. Deadline evictions
        are the metrics' ``deadline_expired`` counter."""
        out = {
            "engine": "continuous",
            "cache_mode": self.cache_mode,
            "n_slots": self.n_slots,
            "slots_busy": sum(r is not None for r in self._slots),
            "slots_prefilling": sum(r is not None and r.prefilling for r in self._slots),
            "queue_depth": len(self._queue),
            "max_queue": self.max_queue,
            "decode_chunk": self.decode_chunk,
            "max_context": self.smax,
            "token_budget": self.token_budget,
            "max_tick_prefill_tokens": self.max_tick_prefill_tokens,
            "interference_max_s": round(self.interference_max_s, 6),
            "interference_max_by_class": {
                cls: round(v, 6) for cls, v in sorted(self.interference_max_by_class.items())},
            "queue_by_class": {cls: sum(1 for r in self._queue if r.slo_class == cls)
                               for cls in SLO_CLASSES},
            "prefix_cache": self._prefix_cache_stats(),
        }
        if self.prefill_seconds_total > 0:
            # page-warming prefills only, synchronised (absent until one ran)
            out["prefill_tok_per_s"] = round(
                self.prefill_tokens_total / self.prefill_seconds_total, 1)
        if self._paged:
            out.update({
                "page_size": self.page_size,
                "pages_total": self.n_pages - 1,  # page 0 is the sentinel
                "pages_free": self.allocator.n_free,
                "pages_cached_evictable": self.allocator.n_evictable,
                "admission": self.admission,
                "preemptions": self.preemptions,
                **({"admission_degraded": self._degraded,
                    "admission_degrades": self.admission_degrades,
                    "resume_prefill_tokens": self.resume_prefill_tokens}
                   if self.admission == "optimistic" else {}),
                "kv_bytes_per_token": round(self.page_bytes / self.page_size, 2),
            })
        out.update({
            "ticks": self.tick_count,
            "decode_ticks": self.decode_ticks,
            "decode_steps": self.decode_steps,
            "decode_seconds": round(self.decode_seconds, 6),
            "prefills_cold": self.prefills_cold,
            "prefills_prefix_hit": self.prefills_prefix_hit,
            **({"guided": {"fsm_capacity": self.fsm_capacity,
                           "fsm_rows_used": self._fsm_used,
                           "grammars_registered": len(self._grammars)}}
               if self.guided else {}),
            **({"speculative": self._spec_stats()} if self.speculative else {}),
        })
        return out

    def _spec_stats(self) -> dict:
        out = {
            "drafter": self.spec_draft,
            "k": self.spec_k,
            "rounds_per_tick": self.spec_rounds,
            "threshold": self.spec_threshold,
            "threshold_source": (
                "configured" if self._spec_threshold_cfg is not None
                else "measured" if (self._plain_step_ms and self._spec_round_ms)
                else "prior"
            ),
            "plain_step_ms": self._plain_step_ms,
            "spec_round_ms": self._spec_round_ms,
            "acceptance_ema": self.spec_acceptance_ema,
            "spec_ticks": self.spec_ticks,
            "ticks": self._tick_no,
            "verify_rounds": self.spec_verify_rounds,
            "spec_seconds": round(self.spec_seconds, 6),
            # tokens per verify forward per row, over every request so far
            "tokens_per_row_forward": (self.spec_emitted / self.spec_row_forwards
                                       if self.spec_row_forwards else None),
        }
        if self.spec_draft == "model":
            out["draft_steps"] = self.draft_steps
        return out

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
        free at once (a queued one holds none, a preempted one's went at its
        preemption), and a streamed request gets its terminal ``None``.
        Returns True if the request was found."""
        with self._queue_lock:
            for req in self._queue:
                if req.req_id == req_id:
                    self._queue.remove(req)
                    self._close_spans(req, cancelled=True)
                    if req.stream is not None:
                        req.stream.put(None)
                    return True
        for slot, req in enumerate(self._slots):
            if req is not None and req.req_id == req_id:
                self._slots[slot] = None
                self._close_spans(req, cancelled=True)
                self._free_slot_pages(slot)
                if req.stream is not None:
                    req.stream.put(None)
                return True
        return self._completed.pop(req_id, None) is not None

    def end_streams(self) -> set[int]:
        """Put the terminal ``None`` on the stream of every queued and
        in-flight streamed request (the driver is going away); returns
        their ids."""
        with self._queue_lock:
            live = list(self._queue)
        live += [r for r in self._slots if r is not None]
        ended = set()
        for req in live:
            if req.stream is not None:
                req.stream.put(None)
                ended.add(req.req_id)
        return ended

    def take_result(self, req_id: int) -> list[int] | None:
        """Pop a finished request's tokens, or None if still in flight."""
        req = self._completed.pop(req_id, None)
        return None if req is None else req.tokens

    def take_finished(self) -> list[Request]:
        """Pop and return all finished requests."""
        out = list(self._completed.values())
        self._completed.clear()
        return out


class TokenStream:
    """What ``ThreadedEngine.stream_one`` returns: an iterator of token-id
    lists as they are harvested (``stream_one_with_logprobs``: (token ids,
    stats) pairs). ``close()`` cancels the request whether or not iteration
    began (closing a generator that never started runs none of its
    code)."""

    def __init__(self, chunks, cancel):
        self._chunks = chunks
        self._cancel = cancel

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._chunks)

    def close(self) -> None:
        self._chunks.close()
        self._cancel()


class ThreadedEngine:
    """Thread-safe front for ``ContinuousEngine``: HTTP handler threads
    submit and block on their own request while one driver thread ticks the
    engine, so concurrent requests share decode ticks."""

    # The server asks these before passing scheduling fields through.
    supports_deadlines = True
    supports_slo_classes = True

    def __init__(self, engine: ContinuousEngine):
        self._engine = engine
        self._cond = threading.Condition()
        self._results: dict[int, Request] = {}  # guarded by _cond
        self._cancels: set[int] = set()  # guarded by _cond
        # Streamed requests whose stream the driver ended by dying.
        self._aborted: set[int] = set()  # guarded by _cond
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
    def metrics(self) -> ServingMetrics:
        """The engine's telemetry bundle (what ``/metrics`` renders)."""
        return self._engine.metrics

    @property
    def tracer(self):
        """The engine's span tracer: the HTTP server takes it as its own, so
        arming the engine arms the whole replica."""
        return self._engine.tracer

    @property
    def flight(self) -> FlightRecorder:
        """The engine's flight recorder (its tick ring)."""
        return self._engine.flight

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
                    self._aborted = self._engine.end_streams()
                    self._cond.notify_all()
                return
            with self._cond:
                for req in self._engine.take_finished():
                    # A streamed request delivers through its stream (its
                    # None went out in _harvest); kept here, nobody would
                    # pop it.
                    if req.stream is None:
                        self._results[req.req_id] = req
                self._cond.notify_all()

    @property
    def logprobs_k(self) -> int:
        """The most logprob alternatives the engine serves (0: none)."""
        return self._engine.logprobs_k

    @property
    def guided(self) -> bool:
        """Can the engine serve grammar-constrained requests?"""
        return self._engine.guided

    def _submit_locked(self, prompt_tokens: list[int], **kw) -> int:
        if self._stop:
            raise RuntimeError("continuous engine is stopped") from self._error
        rid = self._engine.submit(prompt_tokens, **kw)
        self._cond.notify_all()
        return rid

    def _wait_locked(self, rid: int, deadline_s: float | None = None) -> Request:
        """Block (holding the condition) until ``rid`` completes; raises if
        the driver stopped, ``DeadlineExceededError`` if its deadline
        evicted it."""
        while rid not in self._results:
            if self._stop:
                raise RuntimeError("continuous engine stopped mid-request") from self._error
            self._cond.wait()
        req = self._results.pop(rid)
        if req.expired:
            raise DeadlineExceededError(
                f"request exceeded its {deadline_s}s deadline ({len(req.tokens)} tokens "
                f"generated before eviction)")
        return req

    def generate_one(
        self,
        prompt_tokens: list[int],
        *,
        max_new_tokens: int | None = None,
        temperature: float | None = None,
        top_p: float | None = None,
        seed: int | None = None,
        slo_class: str | None = None,
        deadline_s: float | None = None,
        grammar: Any = None,
        trace: Any = None,
    ) -> list[int]:
        """Submit one request and block until it completes. Raises if the
        driver has stopped (shutdown or device error), and
        ``DeadlineExceededError`` when ``deadline_s`` evicted it first.
        ``grammar`` (``submit``'s) is registered here, in the caller's
        thread: an exhausted table raises before the request queues."""
        with self._cond:
            rid = self._submit_locked(
                prompt_tokens, max_new_tokens=max_new_tokens, temperature=temperature,
                top_p=top_p, seed=seed, slo_class=slo_class, deadline_s=deadline_s,
                grammar=grammar, trace=trace)
            return self._wait_locked(rid, deadline_s).tokens

    def generate_one_with_logprobs(
        self,
        prompt_tokens: list[int],
        n_top: int,
        *,
        max_new_tokens: int | None = None,
        temperature: float | None = None,
        top_p: float | None = None,
        seed: int | None = None,
        slo_class: str | None = None,
        deadline_s: float | None = None,
        grammar: Any = None,
        trace: Any = None,
    ) -> tuple[list[int], dict]:
        """``generate_one`` plus each token's logprob stats, in the lock-step
        Generator's layout (``token_logprobs``, ``top_ids``,
        ``top_logprobs``, sliced to ``n_top``); the request rides the
        ordinary decode ticks."""
        with self._cond:
            rid = self._submit_locked(
                prompt_tokens, max_new_tokens=max_new_tokens, temperature=temperature,
                top_p=top_p, seed=seed, slo_class=slo_class, deadline_s=deadline_s,
                logprobs=n_top, grammar=grammar, trace=trace)
            req = self._wait_locked(rid, deadline_s)
        return req.tokens, {"token_logprobs": req.lp_token,
                            "top_ids": [r[:n_top] for r in req.lp_top_ids],
                            "top_logprobs": [r[:n_top] for r in req.lp_top]}

    def generate_many(
        self,
        prompt_tokens: list[int],
        n: int,
        *,
        max_new_tokens: int | None = None,
        temperature: float | None = None,
        top_p: float | None = None,
        seed: int | None = None,
        logprobs: int | None = None,
        slo_class: str | None = None,
        grammar: Any = None,
        trace: Any = None,
    ) -> list[Request]:
        """Submit ``n`` copies of one prompt, copy i seeded
        ``derive_copy_seed(seed, i)`` (an unseeded call draws its base), and
        block until all complete: the finished requests in submission
        order. The copies share decode ticks. A failed submit cancels the
        copies already queued."""
        if seed is None:
            seed = random.getrandbits(31)
        with self._cond:
            rids: list[int] = []
            try:
                for i in range(n):
                    rids.append(self._submit_locked(
                        prompt_tokens, max_new_tokens=max_new_tokens,
                        temperature=temperature, top_p=top_p,
                        seed=derive_copy_seed(seed, i), logprobs=logprobs,
                        slo_class=slo_class, grammar=grammar, trace=trace))
            except BaseException:
                self._cancels.update(rids)
                self._cond.notify_all()
                raise
            return [self._wait_locked(rid) for rid in rids]

    def _stream(self, **submit_kw):
        """Submit one streamed request (eagerly: ``QueueFullError`` and
        ``BadRequestError`` raise here) and return its ``TokenStream``."""
        stream: queue.Queue = queue.Queue()
        with self._cond:
            rid = self._submit_locked(stream=stream, **submit_kw)

        def chunks():
            try:
                while True:
                    try:
                        chunk = stream.get(timeout=1.0)
                    except queue.Empty:
                        # _stop and _error as one pair under the condition,
                        # once per idle second.
                        with self._cond:
                            stopped, err = self._stop, self._error
                        if stopped:
                            raise RuntimeError(
                                "continuous engine stopped mid-stream") from err
                        continue
                    if chunk is None:
                        with self._cond:
                            aborted, err = rid in self._aborted, self._error
                        if aborted:
                            raise RuntimeError(
                                "continuous engine driver died mid-stream") from err
                        return
                    yield chunk
            finally:
                # An early stop must not decode the abandoned budget.
                self.cancel(rid)

        return TokenStream(chunks(), lambda: self.cancel(rid))

    def stream_one(
        self,
        prompt_tokens: list[int],
        *,
        max_new_tokens: int | None = None,
        temperature: float | None = None,
        top_p: float | None = None,
        seed: int | None = None,
        slo_class: str | None = None,
        deadline_s: float | None = None,
        grammar: Any = None,
        trace: Any = None,
    ):
        """Submit one request and return an iterator of its token-id lists
        as they are harvested (SSE streaming). The submit is eager:
        ``QueueFullError`` and ``BadRequestError`` raise here, while the
        HTTP layer can still answer 429 or 400. Closing the iterator early
        (a stop sequence, a client gone) cancels the request, which frees
        its slot; a deadline eviction ends it. Raises if the driver stops
        mid-stream."""
        return self._stream(prompt_tokens=prompt_tokens, max_new_tokens=max_new_tokens,
                            temperature=temperature, top_p=top_p, seed=seed,
                            slo_class=slo_class, deadline_s=deadline_s, grammar=grammar,
                            trace=trace)

    def stream_one_with_logprobs(
        self,
        prompt_tokens: list[int],
        n_top: int,
        *,
        max_new_tokens: int | None = None,
        temperature: float | None = None,
        top_p: float | None = None,
        seed: int | None = None,
        slo_class: str | None = None,
        deadline_s: float | None = None,
        grammar: Any = None,
        trace: Any = None,
    ):
        """``stream_one`` with each chunk's logprob stats: yields (token ids,
        stats) pairs, the stats in ``generate_one_with_logprobs``' layout."""
        return self._stream(prompt_tokens=prompt_tokens, max_new_tokens=max_new_tokens,
                            temperature=temperature, top_p=top_p, seed=seed,
                            slo_class=slo_class, deadline_s=deadline_s, logprobs=n_top,
                            grammar=grammar, trace=trace)

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
