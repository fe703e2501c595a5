"""Prompt-lookup speculative decoding: verify K drafted tokens per forward.

Counterpart of the JAX package's ``infer/speculative.py``, with its names.
Sequential decode reads every weight byte per generated token; a K+1-token
verify forward reads them once for up to K+1 tokens. Drafts come from
**prompt lookup**: the most recent earlier occurrence of the trailing
``ngram`` tokens proposes the K tokens that followed it (no second model),
backing off to shorter n-grams down to ``min_ngram``.

- ``lookup_draft`` is the host reference of the lookup (a copy);
  ``device_lookup_draft`` the same on tensors, vectorised over rows.
- ``spec_sample_tokens`` is the acceptance rule for point-mass drafts at
  temperature > 0 (rejection sampling); greedy rows take the exact-match
  rule. Its uniforms come from each row's own ``torch.Generator``
  (``infer/sampling.row_uniforms``), so a request's draws never depend on
  the rows beside it; they are PyTorch's, so sampled tokens match the JAX
  package in distribution, not draw for draw.
- ``SpeculativeGenerator`` is the lock-step greedy loop: a causal prefill
  (the flash kernel, K1, with ``attention_impl="flash"``), then rounds of
  draft -> one (B, k+1) verify forward over the contiguous cache -> accept
  -> emit, in the reference's order. PyTorch runs eagerly, so the
  reference's on-device ``while_loop`` is a Python loop that checks after
  every round whether all rows are done (one device-to-host read a round).
  The reference's ``rounds_per_check`` (rounds scanned between two such
  checks, which saves an XLA program's dispatches) has no counterpart.
- ``AutoSpeculativeGenerator`` speculates while the measured acceptance
  clears a threshold, else serves with the plain ``Generator``, re-probing
  every ``probe_every`` requests.

Exactness: greedy speculative output is the lock-step greedy output in exact
arithmetic (the verify accepts the longest draft prefix the model itself
would have produced, then emits its own argmax). Tested token for token in
float32; in bf16 the chunked and one-token schedules can flip near-ties.
Rejected draft positions leave stale KV behind; they stay masked (slot <=
pos + qi) and the next round's write overwrites them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ditl_tpu_torch.config import ModelConfig
from ditl_tpu_torch.data.tokenizer import Tokenizer, check_vocab
from ditl_tpu_torch.infer.cache import init_cache
from ditl_tpu_torch.infer.engine import _next_pow2
from ditl_tpu_torch.infer.sampling import _gumbel_argmax, row_uniforms, shaped_logits
from ditl_tpu_torch.models import llama
from ditl_tpu_torch.utils.device import resolve_device
from ditl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["AutoSpeculativeGenerator", "SpeculativeGenerator", "lookup_draft",
           "device_lookup_draft", "spec_sample_tokens"]


def spec_sample_tokens(
    logits: torch.Tensor,
    draft: torch.Tensor,
    generators: Sequence[torch.Generator | None],
    temps: torch.Tensor,
    top_ps: float | torch.Tensor,
    *,
    top_k: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rejection-sampling acceptance for point-mass (prompt-lookup) drafts.

    ``logits`` (B, K+1, V) are the verify's raw logits at positions
    pos..pos+K, ``draft`` (B, K) the drafted tokens for pos+1..pos+K. The
    acceptance probability of a drafted token is its shaped probability
    ``p[draft]``; on rejection the pending token is drawn from ``p`` with the
    draft's entry removed, renormalised; with every draft accepted, from
    position K's distribution. The emitted sequence is distributed as
    ancestral sampling under the same temperature/top-k/top-p shaping.
    Row b draws K + V uniforms from ``generators[b]`` (None for a greedy
    row). Greedy rows (``temps <= 0``) take the exact-match rule: accept
    while ``draft == argmax``, pending token the argmax at the first
    mismatch.

    Returns ``(n_acc, next_tok)``: accepted drafts per row and the pending
    token for position ``pos + n_acc + 1``."""
    b, k1, v = logits.shape
    k = k1 - 1
    greedy_row = temps <= 0.0
    cand = torch.argmax(logits, dim=-1)  # (B, K+1)
    top_p = top_ps.repeat_interleave(k1) if isinstance(top_ps, torch.Tensor) else top_ps
    flat = shaped_logits(logits.reshape(b * k1, v), temps.repeat_interleave(k1),
                         top_k=top_k, top_p=top_p)
    probs = torch.softmax(flat, dim=-1).reshape(b, k1, v)
    noise = row_uniforms(generators, (k + v,), logits.device)
    u, gumbel_u = noise[:, :k], noise[:, k:]
    p_draft = probs[:, :k].gather(2, draft[..., None].long())[..., 0]  # (B, K)
    acc = torch.where(greedy_row[:, None], draft == cand[:, :k], u < p_draft)
    n_acc = torch.cumprod(acc.long(), dim=-1).sum(-1)
    # The pending token's distribution: position n_acc's shaped probs, with
    # the rejected draft's entry removed when a rejection happened.
    p_sel = probs.gather(1, n_acc[:, None, None].expand(b, 1, v))[:, 0]
    rejected = n_acc < k
    d_sel = draft.long().gather(1, n_acc.clamp(0, k - 1)[:, None])[:, 0]
    vocab = torch.arange(v, device=logits.device)
    residual = torch.where(rejected[:, None] & (vocab[None, :] == d_sel[:, None]), 0.0, p_sel)
    # Degenerate guard (p[draft] == 1 implies acceptance almost surely):
    # the unadjusted distribution rather than NaNs.
    z = residual.sum(-1, keepdim=True)
    residual = torch.where(z > 0.0, residual / z.clamp_min(1e-30), p_sel)
    next_sampled = _gumbel_argmax(torch.log(residual + 1e-38), gumbel_u)
    next_greedy = cand.gather(1, n_acc[:, None])[:, 0]
    return n_acc, torch.where(greedy_row, next_greedy, next_sampled)


def _emit_rows(buf: torch.Tensor, chunk: torch.Tensor, idx: torch.Tensor,
               count: torch.Tensor) -> torch.Tensor:
    """``buf`` (B, T, ...) with the first ``count[b]`` entries of ``chunk``
    (B, S, ...) written at per-row offsets ``idx`` (B,), as a new tensor:
    the reference's gather and select (entries past T are dropped)."""
    s = chunk.shape[1]
    tail = (1,) * (buf.dim() - 2)
    rel = torch.arange(buf.shape[1], device=buf.device)[None, :] - idx.long()[:, None]
    in_chunk = (rel >= 0) & (rel < torch.clamp(count.long(), max=s)[:, None])
    src = rel.clamp(0, s - 1).reshape(rel.shape + tail).expand(-1, -1, *chunk.shape[2:])
    gathered = chunk.to(buf.dtype).gather(1, src)
    return torch.where(in_chunk.reshape(in_chunk.shape + tail), gathered, buf)


def lookup_draft(context: list[int], k: int, ngram: int,
                 min_ngram: int | None = None) -> list[int]:
    """Host reference of prompt-lookup drafting (``device_lookup_draft``
    must match it): the ``k`` tokens that followed the most recent earlier
    occurrence of the trailing ``ngram`` of ``context``, 0-padded when there
    is no match or the history runs out; a match whose full continuation
    fits is preferred. With ``min_ngram < ngram`` it backs off to shorter
    n-grams when the longer one has no earlier occurrence."""
    min_n = ngram if min_ngram is None else min_ngram
    n = len(context)
    for level in range(ngram, min_n - 1, -1):
        draft: list[int] = []
        if n > level:
            tail = context[n - level:]
            fallback: list[int] | None = None
            for start in range(n - level - 1, -1, -1):
                if context[start:start + level] == tail:
                    follow = list(context[start + level: start + level + k])
                    if len(follow) == k:  # prefer a full continuation
                        draft = follow
                        break
                    if fallback is None:
                        fallback = follow
            if not draft and fallback is not None:
                draft = fallback
        if draft:
            return (draft + [0] * (k - len(draft)))[:k]
    return [0] * k


def _device_lookup_level(tokens: torch.Tensor, ctx_len: torch.Tensor, *, k: int,
                         ngram: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One n-gram level of the device lookup: ((B, k) draft, (B,) found)."""
    b, t = tokens.shape
    dev = tokens.device
    ctx_len = ctx_len.long()
    w = t - ngram
    if w <= 0:
        return (torch.zeros((b, k), dtype=tokens.dtype, device=dev),
                torch.zeros((b,), dtype=torch.bool, device=dev))
    # The trailing n-gram of each row: tokens[ctx_len - ngram : ctx_len].
    tail_idx = ctx_len[:, None] - ngram + torch.arange(ngram, device=dev)
    tail = tokens.gather(1, tail_idx.clamp(0, t - 1))
    # Window starts i with tokens[i : i + ngram] == tail, before the trailing
    # occurrence itself: ngram shifted compares.
    starts = torch.arange(w, device=dev)
    eq = torch.ones((b, w), dtype=torch.bool, device=dev)
    for j in range(ngram):
        eq &= tokens[:, j:j + w] == tail[:, j:j + 1]
    valid = (starts[None, :] < (ctx_len - ngram)[:, None]) & (ctx_len[:, None] > ngram)
    hit = eq & valid
    # Prefer the most recent match whose k-token continuation fits inside the
    # context; fall back to the most recent.
    hit_full = hit & ((starts[None, :] + ngram + k) <= ctx_len[:, None])
    best_any = torch.where(hit, starts[None, :], -1).amax(-1)
    best_full = torch.where(hit_full, starts[None, :], -1).amax(-1)
    best = torch.where(best_full >= 0, best_full, best_any)
    found = best >= 0
    src = (best + ngram)[:, None] + torch.arange(k, device=dev)[None, :]
    draft = tokens.gather(1, src.clamp(0, t - 1))
    in_ctx = src < ctx_len[:, None]
    return torch.where(found[:, None] & in_ctx, draft, 0), found


def device_lookup_draft(tokens: torch.Tensor, ctx_len: torch.Tensor, *, k: int,
                        ngram: int, min_ngram: int | None = None) -> torch.Tensor:
    """Prompt lookup with n-gram backoff on tensors: per row of ``tokens``
    (B, T), whose first ``ctx_len`` (B,) entries are its history, the
    longest level (``ngram`` down to ``min_ngram``) with an earlier
    occurrence supplies the (B, k) draft. Matches ``lookup_draft``; no host
    sync."""
    min_n = ngram if min_ngram is None else min_ngram
    draft = torch.zeros((tokens.shape[0], k), dtype=tokens.dtype, device=tokens.device)
    taken = torch.zeros((tokens.shape[0],), dtype=torch.bool, device=tokens.device)
    for level in range(ngram, min_n - 1, -1):
        d, f = _device_lookup_level(tokens, ctx_len, k=k, ngram=level)
        draft = torch.where((f & ~taken)[:, None], d, draft)
        taken = taken | f
    return draft


class SpeculativeGenerator:
    """Greedy batch generation with prompt-lookup speculation: a drop-in
    for ``engine.Generator`` at temperature 0."""

    def __init__(self, params: llama.Params, model_cfg: ModelConfig,
                 tokenizer: Tokenizer, *, k: int = 8, ngram: int = 3,
                 min_ngram: int = 1, device: str | torch.device = "cuda"):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        if not (1 <= min_ngram <= ngram):
            raise ValueError(f"min_ngram must be in [1, ngram], got {min_ngram}")
        check_vocab(tokenizer, model_cfg.vocab_size, "SpeculativeGenerator")
        llama.check_supported(model_cfg)
        self.device = resolve_device(device)
        self.params = params
        self.cfg = model_cfg
        self.tokenizer = tokenizer
        self.k = k
        self.ngram = ngram
        self.min_ngram = min_ngram
        # Tokens per verify forward per row of the latest call (None before
        # the first), and the rounds in which some row was live.
        self.last_acceptance: float | None = None
        self.last_rounds: int = 0

    def generate_tokens(self, token_lists: list[list[int]],
                        max_new_tokens: int = 64) -> list[list[int]]:
        """Greedy speculative decode: token-id prompts in, EOS-trimmed
        generated ids out, the lock-step ``Generator``'s tokens at
        temperature 0 (exact arithmetic)."""
        n = len(token_lists)
        if n == 0:
            return []
        cfg, tok, dev = self.cfg, self.tokenizer, self.device
        k, max_new = self.k, max_new_tokens
        token_lists = [t if t else [tok.bos_id] for t in token_lists]
        batch = _next_pow2(n, floor=1)
        prompt_len = _next_pow2(max(len(t) for t in token_lists))
        max_len = prompt_len + max_new + k + 1  # KV slots incl. overshoot slack
        if max_len > cfg.max_seq_len:
            raise ValueError(
                f"prompt {prompt_len} + max_new {max_new} + k {k} exceeds "
                f"model max_seq_len {cfg.max_seq_len}"
            )
        t_buf = prompt_len + max_new + 1  # token history: prompt + first + out
        ids = np.full((batch, prompt_len), tok.pad_id, np.int64)
        lengths_np = np.ones((batch,), np.int64)
        for i, toks in enumerate(token_lists):
            ids[i, : len(toks)] = toks
            lengths_np[i] = len(toks)
        input_ids = torch.from_numpy(ids).to(dev)
        lengths = torch.from_numpy(lengths_np).to(dev)
        pad, eos = tok.pad_id, tok.eos_id
        rows = torch.arange(batch, device=dev)

        # ---- prefill: causal over the bucket, the flash kernel's path ----
        cache = init_cache(cfg, batch, max_len, dev)
        p_pos = torch.arange(prompt_len, device=dev)
        seg = (p_pos[None, :] < lengths[:, None]).to(torch.int32)
        hidden = llama.forward(self.params, input_ids, cfg,
                               positions=p_pos.expand(batch, prompt_len), segment_ids=seg,
                               cache=cache, cache_index=0, prefill_causal=True,
                               return_hidden=True)
        last = hidden[rows, lengths - 1][:, None]
        first = torch.argmax(llama.logits_from_hidden(self.params, last)[:, 0], dim=-1)
        # Pad rows (batch bucketing) start done: they would otherwise decode
        # to the full budget and count rounds.
        done0 = (first == eos) | (rows >= n)
        tokens = torch.zeros((batch, t_buf), dtype=torch.long, device=dev)
        tokens[:, :prompt_len] = input_ids
        tokens[rows, lengths] = torch.where(done0, 0, first)
        out = torch.full((batch, max_new), pad, dtype=torch.long, device=dev)
        out[:, 0] = torch.where(done0, pad, first)
        n_out = torch.where(done0, 0, 1)
        ctx_len = lengths + n_out
        cur = torch.where(done0, pad, first)
        pos = lengths.clone()  # KV depth; cur's KV is written next round
        done = done0 | (n_out >= max_new)
        rounds = 0

        # ---- speculative rounds ----
        slots = torch.arange(max_len, device=dev)
        q_idx = torch.arange(k + 1, device=dev)
        while not bool(done.all()):  # one device-to-host read a round
            draft = device_lookup_draft(tokens, ctx_len, k=k, ngram=self.ngram,
                                        min_ngram=self.min_ngram)
            tokens_in = torch.cat([cur[:, None], draft], dim=1)
            positions = pos[:, None] + q_idx[None, :]
            mask = slots[None, None, :] <= positions[:, :, None]
            logits = llama.forward(self.params, tokens_in, cfg, positions=positions,
                                   cache=cache, cache_index=pos, attn_mask=mask)
            cand = torch.argmax(logits, dim=-1)  # (B, K+1)
            eq = tokens_in[:, 1:] == cand[:, :k]
            n_acc = torch.cumprod(eq.long(), dim=-1).sum(-1)
            # Emit the accepted prefix + bonus, cut at EOS and the budget.
            in_span = q_idx[None, :] <= n_acc[:, None]
            is_eos = cand == eos
            eos_before = (torch.cumsum(is_eos.long(), dim=1) - is_eos.long()) > 0
            budget_ok = (n_out[:, None] + q_idx[None, :]) < max_new
            emit = in_span & ~is_eos & ~eos_before & budget_ok & ~done[:, None]
            e = emit.long().sum(1)
            hit_eos = (in_span & is_eos & ~eos_before).any(1)
            out = _emit_rows(out, cand, n_out, e)
            tokens = _emit_rows(tokens, cand, ctx_len, e)
            n_out = n_out + e
            new_done = done | hit_eos | (n_out >= max_new)
            pos = torch.where(done, pos, torch.clamp(pos + n_acc + 1, max=max_len - k - 2))
            cur = torch.where(new_done, pad, cand.gather(1, n_acc[:, None])[:, 0])
            ctx_len = ctx_len + e
            rounds += 1  # some row was live (the loop condition)
            done = new_done

        out_np = out.cpu().numpy()
        self.last_rounds = rounds
        self.last_acceptance = None
        if rounds:
            total = int(n_out[:n].sum())
            self.last_acceptance = total / rounds / n
            logger.info("speculative decode: %d tokens, %d rows, %d rounds "
                        "(%.2f tokens/forward/row)", total, n, rounds,
                        self.last_acceptance)
        results = []
        for i in range(n):
            trimmed = []
            for t in out_np[i].tolist():
                if t == eos or t == pad:
                    break
                trimmed.append(t)
            results.append(trimmed)
        return results

    def generate(self, prompts: list[str], max_new_tokens: int = 64) -> list[str]:
        return _generate_text(self, prompts, max_new_tokens)


def _generate_text(gen, prompts: list[str], max_new_tokens: int) -> list[str]:
    """BOS + encode -> generate_tokens -> decode."""
    encoded = [[gen.tokenizer.bos_id] + gen.tokenizer.encode(p) for p in prompts]
    return [gen.tokenizer.decode(t) for t in gen.generate_tokens(encoded, max_new_tokens)]


class AutoSpeculativeGenerator:
    """Per-request speculation driven by measured acceptance: speculates
    while the exponentially averaged tokens per verify forward per row clears
    ``threshold``, else serves with the plain lock-step ``Generator``, and
    re-probes speculatively every ``probe_every`` requests. Greedy only."""

    def __init__(self, params: llama.Params, model_cfg: ModelConfig,
                 tokenizer: Tokenizer, *, threshold: float = 2.5, probe_every: int = 16,
                 ema: float = 0.7, plain=None, device: str | torch.device = "cuda",
                 **spec_kw):
        from ditl_tpu_torch.infer.engine import Generator

        if probe_every < 1:
            raise ValueError(f"probe_every must be >= 1, got {probe_every}")
        if not (0.0 <= ema < 1.0):
            raise ValueError(f"ema must be in [0, 1), got {ema}")
        self.spec = SpeculativeGenerator(params, model_cfg, tokenizer, device=device,
                                         **spec_kw)
        # The caller's Generator when given (the server already holds one).
        self.plain = plain if plain is not None else Generator(
            params, model_cfg, tokenizer, device=device)
        self.tokenizer = tokenizer
        self.threshold = threshold
        self.probe_every = probe_every
        self._ema_w = ema
        self.acceptance_ema: float | None = None
        self._n_requests = 0

    @property
    def speculating(self) -> bool:
        """Would the next (non-probe) request take the speculative path?"""
        return self.acceptance_ema is None or self.acceptance_ema >= self.threshold

    def generate_tokens(self, token_lists: list[list[int]],
                        max_new_tokens: int = 64) -> list[list[int]]:
        probe = self._n_requests % self.probe_every == 0
        self._n_requests += 1
        if self.speculating or probe:
            out = self.spec.generate_tokens(token_lists, max_new_tokens)
            acc = self.spec.last_acceptance
            if acc is not None:
                self.acceptance_ema = (
                    acc if self.acceptance_ema is None
                    else self._ema_w * self.acceptance_ema + (1.0 - self._ema_w) * acc
                )
            return out
        from ditl_tpu_torch.infer.engine import GenerateConfig

        return self.plain.generate_tokens(token_lists,
                                          GenerateConfig(max_new_tokens=max_new_tokens))

    def generate(self, prompts: list[str], max_new_tokens: int = 64) -> list[str]:
        return _generate_text(self, prompts, max_new_tokens)
