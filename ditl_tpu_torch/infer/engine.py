"""Lock-step KV-cache generation engine.

Counterpart of the JAX package's ``infer/engine.py`` (``GenerateConfig`` and
``Generator``), with its bucketing and masking rules so that greedy tokens
match it exactly:
- prompts are right-padded to a power-of-two bucket (floor 16) and the batch
  to a power of two, dummy rows at length 1;
- the prefill is causal over the bucket with pad validity in segment ids
  (real tokens segment 1, pads segment 0 — pads attend pads), from an empty
  cache: with ``attention_impl="flash"`` it runs the CUDA flash kernel;
- decode step t writes slot ``prompt_len + t`` at RoPE position
  ``lengths + t`` and attends to ``slot < lengths`` or
  ``prompt_len <= slot <= prompt_len + t``;
- after EOS a row emits ``pad_id``;
- with ``kv_cache_dtype="int8"`` the cache is int8 with f32 scales
  (``infer/cache.py``): the prefill still runs the flash kernel over the
  chunk's own K/V and writes them quantized, and each decode step attends
  the raw int8 cache with its scales.

PyTorch runs eagerly, so the reference's compiled-program cache goes away and
its decode ``scan`` is a Python loop. Two steps of the reference's program
are skipped because nothing they compute is returned: the forward after the
last emitted token, and every step once all real rows have finished. Only
the prefill's last-position hidden states go through the lm head.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ditl_tpu_torch.config import ModelConfig
from ditl_tpu_torch.data.tokenizer import Tokenizer, check_vocab
from ditl_tpu_torch.infer.cache import init_cache
from ditl_tpu_torch.infer.sampling import sample_logits
from ditl_tpu_torch.models import llama
from ditl_tpu_torch.utils.device import resolve_device

__all__ = ["GenerateConfig", "Generator"]


@dataclass(frozen=True)
class GenerateConfig:
    """Per-request sampling parameters."""

    max_new_tokens: int = 64
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1.0 => disabled
    seed: int = 0
    # >0 => also return the chosen token's logprob and the top-N
    # alternatives per step (of the raw distribution, before shaping).
    logprobs: int = 0


def _next_pow2(n: int, floor: int = 16) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


class Generator:
    """Batch text generation over a Llama-family model on one device."""

    def __init__(self, params: llama.Params, model_cfg: ModelConfig,
                 tokenizer: Tokenizer, *, device: str | torch.device = "cuda"):
        check_vocab(tokenizer, model_cfg.vocab_size, "Generator")
        llama.check_supported(model_cfg)
        self.device = resolve_device(device)
        self.params = params
        self.cfg = model_cfg
        self.tokenizer = tokenizer

    # -- public surface -----------------------------------------------------

    def generate_tokens(self, token_lists: list[list[int]],
                        gen: GenerateConfig | None = None) -> list[list[int]]:
        """Token-id prompts in, generated token ids out (EOS-trimmed)."""
        return self._generate(token_lists, gen)[0]

    def generate_tokens_with_logprobs(
        self, token_lists: list[list[int]], gen: GenerateConfig,
    ) -> tuple[list[list[int]], list[dict]]:
        """Like ``generate_tokens``, plus per prompt a dict of
        ``token_logprobs`` and aligned ``top_ids``/``top_logprobs``."""
        if gen.logprobs < 1:
            raise ValueError("generate_tokens_with_logprobs needs gen.logprobs >= 1")
        return self._generate(token_lists, gen)

    # -- generation -----------------------------------------------------------

    def _lp_stats(self, logits: torch.Tensor, tok: torch.Tensor, n: int):
        lp = torch.log_softmax(logits.float(), dim=-1)
        chosen = lp.gather(1, tok[:, None])[:, 0]
        top = torch.topk(lp, n, dim=-1)
        return chosen, top.indices, top.values

    def _generate(self, token_lists: list[list[int]],
                  gen: GenerateConfig | None) -> tuple[list[list[int]], list[dict]]:
        gen = gen or GenerateConfig()
        cfg, tok, dev = self.cfg, self.tokenizer, self.device
        n = len(token_lists)
        if n == 0:
            return [], []
        token_lists = [t if t else [tok.bos_id] for t in token_lists]
        batch = _next_pow2(n, floor=1)
        prompt_len = _next_pow2(max(len(t) for t in token_lists))
        max_len = prompt_len + gen.max_new_tokens
        if max_len > cfg.max_seq_len:
            raise ValueError(
                f"prompt {prompt_len} + max_new {gen.max_new_tokens} exceeds "
                f"model max_seq_len {cfg.max_seq_len}"
            )
        ids = np.full((batch, prompt_len), tok.pad_id, np.int64)
        lengths_np = np.ones((batch,), np.int64)  # dummy rows attend to slot 0
        for i, toks in enumerate(token_lists):
            ids[i, : len(toks)] = toks
            lengths_np[i] = len(toks)
        input_ids = torch.from_numpy(ids).to(dev)
        lengths = torch.from_numpy(lengths_np).to(dev)
        rng = torch.Generator(device=dev).manual_seed(gen.seed)

        def sample(logits):
            return sample_logits(logits, rng, temperature=gen.temperature,
                                 top_k=gen.top_k, top_p=gen.top_p)

        cache = init_cache(cfg, batch, max_len, dev)
        q_pos = torch.arange(prompt_len, device=dev)
        seg = (q_pos[None, :] < lengths[:, None]).to(torch.int32)
        hidden = llama.forward(
            self.params, input_ids, cfg, positions=q_pos.expand(batch, prompt_len),
            segment_ids=seg, cache=cache, cache_index=0, prefill_causal=True,
            return_hidden=True,
        )
        last = hidden[torch.arange(batch, device=dev), lengths - 1][:, None]
        step_logits = llama.logits_from_hidden(self.params, last)[:, 0]
        cur = sample(step_logits)
        cur_stats = self._lp_stats(step_logits, cur, gen.logprobs) if gen.logprobs else None
        done = cur == tok.eos_id
        slots = torch.arange(max_len, device=dev)
        tokens, stats = [], []
        for t in range(gen.max_new_tokens):
            tokens.append(cur)
            stats.append(cur_stats)
            # The reference's step t also decodes the next token; after the
            # last emitted token, or once every real row has finished (all
            # later tokens are pads), nothing it computes is returned.
            new_done = done | (cur == tok.eos_id)
            if t == gen.max_new_tokens - 1 or bool(new_done[:n].all()):
                break
            write_idx = prompt_len + t
            mask = ((slots[None, :] < lengths[:, None])
                    | ((slots[None, :] >= prompt_len)
                       & (slots[None, :] <= write_idx)))[:, None, :]
            step_logits = llama.forward(
                self.params, cur[:, None], cfg, positions=(lengths + t)[:, None],
                cache=cache, cache_index=write_idx, attn_mask=mask,
            )[:, 0]
            nxt = sample(step_logits)
            cur_stats = self._lp_stats(step_logits, nxt, gen.logprobs) if gen.logprobs else None
            done = new_done
            cur = torch.where(done, torch.full_like(nxt, tok.pad_id), nxt)

        out = torch.stack(tokens, dim=1).cpu().numpy()  # (B, steps)
        results, keep = [], []
        for i in range(n):
            trimmed = []
            for t_id in out[i].tolist():
                if t_id == tok.eos_id or t_id == tok.pad_id:
                    break
                trimmed.append(t_id)
            results.append(trimmed)
            keep.append(len(trimmed))
        lps: list[dict] = []
        if gen.logprobs:
            chosen = torch.stack([s[0] for s in stats], 1).cpu().numpy()
            top_ids = torch.stack([s[1] for s in stats], 1).cpu().numpy()
            top_lp = torch.stack([s[2] for s in stats], 1).cpu().numpy()
            lps = [
                {
                    "token_logprobs": chosen[i, : keep[i]].tolist(),
                    "top_ids": top_ids[i, : keep[i]].tolist(),
                    "top_logprobs": top_lp[i, : keep[i]].tolist(),
                }
                for i in range(n)
            ]
        return results, lps
