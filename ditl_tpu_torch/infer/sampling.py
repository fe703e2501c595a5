"""Token sampling: greedy, temperature, top-k and nucleus (top-p).

Counterpart of the JAX package's ``infer/sampling.py`` with the same
threshold rules. Draws come from an explicit ``torch.Generator``; the Gumbel
noise is PyTorch's, so sampled tokens match the JAX package's in
distribution, not draw for draw.

Two forms, as in the reference:
- a scalar ``temperature`` (the lock-step engine): ``0`` is greedy argmax;
- a (B,) ``temperature`` tensor (the continuous engine): rows with
  temperature <= 0 are greedy, the others draw from ``shaped_logits``. Each
  row then draws from its own uniforms (``row_uniforms``, one generator per
  row), so a request's draws never depend on which requests share the tick.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["sample_logits", "shaped_logits", "row_uniforms", "apply_top_k",
           "apply_top_p"]


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


def shaped_logits(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    *,
    top_k: int = 0,
    top_p: float | torch.Tensor = 1.0,
) -> torch.Tensor:
    """(B, V) raw logits -> the per-row distribution the (B,)-temperature
    path draws from: divided by the row's temperature (clamped to 1e-6),
    then top-k, then top-p (always applied for a per-row ``top_p``)."""
    logits = logits.float()
    scaled = logits / temperature.float().clamp_min(1e-6)[..., None]
    if top_k > 0:
        scaled = apply_top_k(scaled, min(top_k, logits.shape[-1]))
    if isinstance(top_p, torch.Tensor) or top_p < 1.0:
        scaled = apply_top_p(scaled, top_p)
    return scaled


def row_uniforms(generators: Sequence[torch.Generator | None], shape: tuple,
                 device: torch.device | str) -> torch.Tensor:
    """(B, *shape) uniforms in (0, 1): row b from ``generators[b]``; a row
    whose generator is None gets 0.5 (a greedy row, whose draw is unused)."""
    out = torch.full((len(generators), *shape), 0.5, device=device)
    for b, g in enumerate(generators):
        if g is not None:
            out[b] = torch.rand(shape, generator=g, device=device)
    return out


def _gumbel_argmax(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_logits(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    *,
    temperature: float | torch.Tensor = 0.0,
    top_k: int = 0,
    top_p: float | torch.Tensor = 1.0,
    uniforms: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 token ids.

    A float ``temperature``: ``0`` is greedy argmax, otherwise a Gumbel-max
    draw from the shaped distribution with noise from ``generator``.

    A (B,) ``temperature`` tensor: rows with temperature <= 0 take the
    argmax, the others a Gumbel-max draw from ``shaped_logits`` with the
    (B, V) ``uniforms`` given (``row_uniforms``; ``generator`` is not
    used)."""
    logits = logits.float()
    if isinstance(temperature, torch.Tensor):
        if uniforms is None:
            raise ValueError("a per-row temperature needs per-row uniforms")
        greedy = torch.argmax(logits, dim=-1)
        scaled = shaped_logits(logits, temperature, top_k=top_k, top_p=top_p)
        sampled = _gumbel_argmax(scaled, uniforms)
        return torch.where(temperature <= 0.0, greedy, sampled)
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        logits = apply_top_k(logits, min(top_k, logits.shape[-1]))
    if top_p < 1.0:
        logits = apply_top_p(logits, top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return _gumbel_argmax(logits, u)
