"""Train state and the optimizers: parameters, optimizer state, step count.

Counterpart of the JAX package's ``train/state.py``. ``make_optimizer``
builds what the reference builds with optax, in optax's order of operations
and with the dtype optax gives every statistic:

- ``clip_by_global_norm(grad_clip_norm)`` first;
- ``"adamw"``: ``optax.adamw(schedule, b1, b2, weight_decay, mu_dtype)``
  (``scale_by_adam`` -> ``add_decayed_weights`` -> ``scale_by_learning_rate``);
- ``"adafactor"``: ``optax.adafactor(learning_rate=schedule,
  weight_decay_rate=weight_decay or None)`` with its defaults
  (``scale_by_factored_rms`` with min_dim_size_to_factor 128, decay_rate 0.8,
  eps 1e-30 -> ``clip_by_block_rms(1.0)`` -> ``scale_by_learning_rate`` ->
  ``scale_by_param_block_rms(1e-3)`` -> ``add_decayed_weights`` ->
  ``scale(-1)``; no momentum);
- the schedule is ``warmup_cosine_decay_schedule(0, learning_rate,
  warmup_steps, max(total_steps, warmup_steps + 1), 0.1 * learning_rate)``,
  computed in f32.

``"lion"``, ``"sgd"`` and LoRA masking raise (not ported). No ``torch.optim``
class stands in: their order of operations differs from optax's.

Stacked leaves. The tree keeps each ``layers`` leaf stacked on axis 0, as the
JAX tree does, but autograd differentiates each layer's slice of it as a
tensor of its own (``Leaf.parts``, views of the master): the backward then
writes one layer's gradient into that layer's tensor, where indexing the
stack would zero-fill a copy of the whole stack for every layer. The
optimizer works slice by slice (an 8B leaf's f32 temporaries stay one
layer's size) but keeps every statistic that optax reduces over a leaf
reduced over the whole stacked leaf: the global norm, adafactor's block RMS
of the update and its parameter-scale RMS. Adafactor's factored row and
column statistics are per layer anyway (optax factors the two largest dims).
Updates are applied in place: ``p + u.astype(p.dtype)`` into the master.

``TrainState.state_dict`` and ``load_state_dict`` carry the step, every
master and every optimizer statistic (Adam's moments, adafactor's factored
rows and columns or full second moments, the update count) to and from a
checkpoint (``train/checkpoint.py``) to the bit: the load copies each saved
tensor into the live one of the same place, shape and dtype, and raises on
any difference of structure.

Scalars follow JAX's promotion: a Python constant meeting a bf16 array is
rounded to bf16 first (``_w``), and an f32 scalar array meeting a bf16 array
promotes it to f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch

from ditl_tpu_torch.config import TrainConfig

__all__ = ["Leaf", "TrainState", "make_leaves", "make_optimizer", "make_schedule",
           "global_norm", "tree_to"]

f32 = np.float32


@dataclass
class Leaf:
    """One leaf of the parameter tree: its path, the master as the tree
    stores it, and the tensors autograd differentiates (each layer's slice
    of a stacked ``layers`` leaf, else the master itself)."""

    path: tuple[str, ...]
    master: torch.Tensor
    parts: list[torch.Tensor]

    @property
    def stacked(self) -> bool:
        return self.path[0] == "layers"

    @property
    def numel(self) -> int:
        return self.master.numel()


def make_leaves(params: Mapping) -> list[Leaf]:
    """Leaves of ``params`` in tree order, their parts requiring grad."""
    out: list[Leaf] = []

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        if path[0] == "layers":
            parts = [node[i].detach().requires_grad_(True) for i in range(node.shape[0])]
        else:
            parts = [node.requires_grad_(True)]
        out.append(Leaf(path, node, parts))

    walk(params, ())
    return out


@dataclass
class TrainState:
    """Masters (``params``, the JAX tree layout), their autograd leaves, the
    optimizer state and the number of steps taken."""

    params: dict
    leaves: list[Leaf]
    opt_state: Any = None
    step: int = 0

    @classmethod
    def create(cls, params: dict, optimizer) -> "TrainState":
        leaves = make_leaves(params)
        return cls(params, leaves, optimizer.init(leaves), 0)

    def state_dict(self) -> dict:
        """``{"step", "params", "opt_state"}``: the live tensors, not copies
        (``tree_to`` copies them)."""
        return {"step": self.step, "params": self.params, "opt_state": self.opt_state}

    @torch.no_grad()
    def load_state_dict(self, saved: Mapping) -> None:
        """Copy a ``state_dict`` into this state in place, bit for bit; a
        leaf of another shape or dtype, or another tree, raises
        ``ValueError`` before anything is copied."""
        pairs: list[tuple[torch.Tensor, torch.Tensor]] = []
        _match(self.params, saved["params"], "params", pairs)
        counts: list[tuple[dict, str, Any]] = []
        _match(self.opt_state, saved["opt_state"], "opt_state", pairs, counts)
        for dst, src in pairs:
            dst.copy_(src)
        for node, key, value in counts:
            node[key] = value
        self.step = int(saved["step"])

    def model_views(self, cast=None) -> tuple[list[dict], dict]:
        """(per-layer weight dicts, top-level dict) for ``train_forward``;
        ``cast(path, tensor)`` maps every part first."""
        n_layers = max((len(leaf.parts) for leaf in self.leaves if leaf.stacked),
                       default=0)
        layers: list[dict] = [{} for _ in range(n_layers)]
        top: dict = {}
        for leaf in self.leaves:
            parts = [cast(leaf.path, p) if cast else p for p in leaf.parts]
            if leaf.stacked:
                group, key = leaf.path[1], leaf.path[2]
                for i, part in enumerate(parts):
                    layers[i].setdefault(group, {})[key] = part
            else:
                top.setdefault(leaf.path[0], {})[leaf.path[1]] = parts[0]
        return layers, top


def _match(live, saved, path: str, pairs: list, scalars: list | None = None) -> None:
    """Pair each live tensor with the saved one at the same place (into
    ``pairs``) and each Python scalar with its saved value (into ``scalars``
    as ``(dict, key, value)``), raising ``ValueError`` on a difference."""
    if isinstance(live, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or (
                saved.shape, saved.dtype) != (live.shape, live.dtype):
            got = (tuple(saved.shape), saved.dtype) if isinstance(saved, torch.Tensor) \
                else type(saved).__name__
            raise ValueError(f"checkpoint leaf {path}: {got} where the state holds "
                             f"{(tuple(live.shape), live.dtype)}")
        pairs.append((live, saved))
    elif isinstance(live, Mapping):
        if not isinstance(saved, Mapping) or set(saved) != set(live):
            raise ValueError(f"checkpoint node {path}: keys "
                             f"{sorted(saved) if isinstance(saved, Mapping) else saved!r}"
                             f" where the state holds {sorted(live)}")
        for k, v in live.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                if scalars is None or not isinstance(saved[k], (int, float)):
                    raise ValueError(f"checkpoint leaf {path}/{k}: {saved[k]!r}")
                scalars.append((live, k, saved[k]))
            else:
                _match(v, saved[k], f"{path}/{k}", pairs, scalars)
    elif isinstance(live, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(live):
            raise ValueError(f"checkpoint node {path}: a sequence of another length")
        for i, (a, b) in enumerate(zip(live, saved)):
            _match(a, b, f"{path}/{i}", pairs, scalars)
    elif live is None:
        if saved is not None:
            raise ValueError(f"checkpoint node {path}: {type(saved).__name__} where "
                             "the state holds None")
    else:
        raise ValueError(f"checkpoint node {path}: unexpected {type(live).__name__}")


def tree_to(tree, device: str | torch.device):
    """A copy of ``tree`` (dicts, lists, tensors, scalars, None) with every
    tensor detached and copied to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, Mapping):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree


def _w(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as JAX applies it to an array: rounded to the
    array's dtype (a weak-typed scalar)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _sq_sum(parts: list[torch.Tensor]) -> torch.Tensor:
    """``jnp.sum(x * x)`` over the whole leaf: squares in the leaf's dtype,
    summed in f32 (JAX upcasts low-precision sums), as an f32 0-d tensor."""
    return sum((p * p).float().sum() for p in parts)


def global_norm(leaves: list[Leaf]) -> torch.Tensor:
    """f32 global norm of the parts' gradients (the step's ``grad_norm``)."""
    return torch.sqrt(sum(
        sum(p.grad.float().square().sum() for p in leaf.parts) for leaf in leaves))


def make_schedule(cfg: TrainConfig):
    """``optax.warmup_cosine_decay_schedule`` as the reference configures
    it, evaluated in f32: count -> learning rate."""
    init, peak = 0.0, cfg.learning_rate
    warmup = cfg.warmup_steps
    decay_steps = max(cfg.total_steps, cfg.warmup_steps + 1)
    end = cfg.learning_rate * 0.1
    alpha = 0.0 if peak == 0.0 else end / peak
    cos_steps = decay_steps - warmup

    def schedule(count: int) -> float:
        if count < warmup:  # linear_schedule(init, peak, warmup)
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float(f32(init - peak) * frac + f32(peak))
        c = min(f32(count - warmup), f32(cos_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(cos_steps)))
        return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def _factored_dims(shape: tuple[int, ...], min_dim: int = 128):
    """optax's choice: the two largest axes, if the smaller is >= min_dim."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class _Optimizer:
    """``clip_by_global_norm`` then the optimizer's own chain, applied in
    place to the masters from the parts' ``.grad``."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)

    def clip(self, leaves: list[Leaf]) -> None:
        """``optax.clip_by_global_norm``: per-leaf sums in the leaf's dtype,
        added across leaves with JAX's promotion, the clip selected on the
        device (no host sync)."""
        total = 0
        for leaf in leaves:
            total = total + _sq_sum([p.grad for p in leaf.parts]).to(leaf.master.dtype)
        g_norm = torch.sqrt(total)
        keep = g_norm < self.cfg.grad_clip_norm
        for leaf in leaves:
            for p in leaf.parts:
                g = p.grad
                clipped = (g / g_norm.to(g.dtype)) * _w(self.cfg.grad_clip_norm, g)
                g.copy_(torch.where(keep, g, clipped))

    @torch.no_grad()
    def step(self, leaves: list[Leaf], state: dict) -> None:
        self.clip(leaves)
        self._update(leaves, state)
        state["count"] += 1


class _AdamW(_Optimizer):
    def init(self, leaves: list[Leaf]) -> dict:
        mu_dtype = getattr(torch, self.cfg.adam_mu_dtype)
        return {
            "count": 0,
            "mu": [[torch.zeros_like(p, dtype=mu_dtype) for p in leaf.parts]
                   for leaf in leaves],
            "nu": [[torch.zeros_like(p) for p in leaf.parts] for leaf in leaves],
        }

    def _update(self, leaves: list[Leaf], state: dict) -> None:
        cfg, count = self.cfg, state["count"]
        b1, b2, eps, wd = cfg.beta1, cfg.beta2, 1e-8, cfg.weight_decay
        mu_dtype = getattr(torch, cfg.adam_mu_dtype)
        n = count + 1
        bc1 = float(f32(1) - f32(b1) ** f32(n))
        bc2 = float(f32(1) - f32(b2) ** f32(n))
        lr = -self.schedule(count)
        for li, leaf in enumerate(leaves):
            for pi, p in enumerate(leaf.parts):
                g = p.grad
                mu, nu = state["mu"][li][pi], state["nu"][li][pi]
                mu_new = _w(1 - b1, g) * g + _w(b1, mu) * mu
                nu_new = _w(1 - b2, g) * (g * g) + _w(b2, nu) * nu
                mu_hat = mu_new / _w(bc1, mu_new)
                nu_hat = nu_new / _w(bc2, nu_new)
                u = mu_hat / (torch.sqrt(nu_hat) + _w(eps, nu_hat))
                if wd:
                    u = u + _w(wd, p) * p
                u = _w(lr, u) * u
                mu.copy_(mu_new.to(mu_dtype))
                nu.copy_(nu_new)
                p.add_(u.to(p.dtype))


class _Adafactor(_Optimizer):
    min_dim, decay_rate, eps, clip_threshold, min_scale = 128, 0.8, 1e-30, 1.0, 1e-3

    def _axes(self, leaf: Leaf):
        """The factored axes of each part (the leaf's, less the layer axis
        for a stacked leaf), or None."""
        dims = _factored_dims(tuple(leaf.master.shape), self.min_dim)
        if dims is None or not leaf.stacked:
            return dims
        if 0 in dims:
            raise NotImplementedError(
                f"adafactor factoring the layer axis of {'/'.join(leaf.path)} "
                f"{tuple(leaf.master.shape)} is not ported (see ROADMAP.md)")
        return dims[0] - 1, dims[1] - 1

    def init(self, leaves: list[Leaf]) -> dict:
        v_row, v_col, v = [], [], []
        for leaf in leaves:
            axes = self._axes(leaf)
            if axes is None:
                v_row.append(None)
                v_col.append(None)
                v.append([torch.zeros_like(p) for p in leaf.parts])
                continue
            d1, d0 = axes
            v_row.append([torch.zeros_like(p.select(d0, 0)) for p in leaf.parts])
            v_col.append([torch.zeros_like(p.select(d1, 0)) for p in leaf.parts])
            v.append(None)
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    def _update(self, leaves: list[Leaf], state: dict) -> None:
        cfg, count = self.cfg, state["count"]
        # decay_rate_t = 1 - (count + 1) ** -0.8, an f32 array in optax.
        decay = f32(1) - f32(count + 1) ** f32(-self.decay_rate)
        keep = float(f32(1) - decay)
        decay = float(decay)
        lr = self.schedule(count)
        wd = cfg.weight_decay or None
        for li, leaf in enumerate(leaves):
            dtype = leaf.master.dtype
            axes = self._axes(leaf)
            # Pass 1, per part: the factored (or full) second-moment scaling,
            # written over the gradient; the update's square sum.
            u_sq = 0
            for pi, p in enumerate(leaf.parts):
                g = p.grad
                g_sq = g * g + _w(self.eps, g)
                if axes is not None:
                    d1, d0 = axes
                    vr, vc = state["v_row"][li][pi], state["v_col"][li][pi]
                    vr.copy_((decay * vr.float() + keep * g_sq.mean(d0).float()).to(dtype))
                    vc.copy_((decay * vc.float() + keep * g_sq.mean(d1).float()).to(dtype))
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_factor = (vr / vr.mean(reduced_d1, keepdim=True)) ** -0.5
                    col_factor = vc ** -0.5
                    u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                else:
                    v = state["v"][li][pi]
                    v.copy_((decay * v.float() + keep * g_sq.float()).to(dtype))
                    u = g * v ** -0.5
                g.copy_(u)
                u_sq = u_sq + (u * u).float().sum()
            # clip_by_block_rms and scale_by_param_block_rms: whole-leaf RMS.
            clip_denom = torch.clamp(
                torch.sqrt((u_sq / leaf.numel).to(dtype)) / _w(self.clip_threshold, leaf.master),
                min=1.0)
            p_rms = torch.sqrt((_sq_sum(leaf.parts) / leaf.numel).to(dtype))
            p_rms = torch.where(p_rms <= self.min_scale, _w(self.min_scale, p_rms), p_rms)
            # Pass 2, per part: the rest of the chain, then p + u.
            for p in leaf.parts:
                u = p.grad / clip_denom
                u = _w(lr, u) * u
                u = u * p_rms
                if wd is not None:
                    u = u + _w(wd, p) * p
                u = -u
                p.add_(u.to(p.dtype))


def make_optimizer(cfg: TrainConfig, params: Mapping):
    """The reference's optimizer for ``cfg`` (see the module doc)."""

    def has_lora(node) -> bool:
        return isinstance(node, Mapping) and any(
            k == "lora" or has_lora(v) for k, v in node.items())

    if has_lora(params):
        raise NotImplementedError("LoRA training (frozen base leaves) is not "
                                  "ported to PyTorch yet (see ROADMAP.md)")
    if cfg.optimizer == "adamw":
        return _AdamW(cfg)
    if cfg.optimizer == "adafactor":
        return _Adafactor(cfg)
    if cfg.optimizer in ("lion", "sgd"):
        raise NotImplementedError(f"optimizer {cfg.optimizer!r} is not ported to "
                                  "PyTorch yet (see ROADMAP.md)")
    raise ValueError(f"unknown optimizer {cfg.optimizer!r} (adamw|adafactor|lion|sgd)")
