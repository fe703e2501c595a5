"""Token sampling: greedy, temperature, top-k and nucleus (top-p).

Counterpart of the JAX package's ``infer/sampling.py`` with the same
threshold rules. Draws come from an explicit ``torch.Generator``; the Gumbel
noise is PyTorch's, so sampled tokens match the JAX package's in
distribution, not draw for draw.
"""

from __future__ import annotations

import torch

__all__ = ["sample_logits", "apply_top_k", "apply_top_p"]


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit of each row."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def apply_top_p(logits: torch.Tensor, p: float | torch.Tensor) -> torch.Tensor:
    """Keep the smallest prefix of the sorted distribution whose cumulative
    probability exceeds ``p`` (the top token always stays). ``p`` is a float
    or a per-row (B,) tensor, where rows with p >= 1 keep everything."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    if isinstance(p, torch.Tensor):
        p = p.float()[..., None]
        p = torch.where(p >= 1.0, torch.full_like(p, float("inf")), p)
    # Token i is kept if the cumulative mass before it is still < p.
    keep_sorted = (cum - probs) < p
    threshold = torch.where(keep_sorted, sorted_logits,
                            torch.full_like(sorted_logits, float("inf")))
    threshold = threshold.amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < threshold, float("-inf"))


def sample_logits(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 token ids. ``temperature == 0`` is greedy
    argmax; otherwise a Gumbel-max draw from the shaped distribution."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        logits = apply_top_k(logits, min(top_k, logits.shape[-1]))
    if top_p < 1.0:
        logits = apply_top_p(logits, top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
