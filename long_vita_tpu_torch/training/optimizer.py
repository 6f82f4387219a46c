"""AdamW with a ViT lr multiplier, per-layer lr decay and stage freezing.

Counterpart of long_vita_tpu/training/optimizer.py, whose optimizer is an
optax chain; this module applies the same chain, in optax's order and with
optax's arithmetic, to a module's parameters in place:

  1. clip_by_global_norm(grad_clip): g * max_norm / ||g|| when ||g|| is not
     below max_norm (the norm over every gradient, frozen leaves' included);
  2. scale_by_adam(b1, b2, eps): m = (1 - b1) g + b1 m, v = (1 - b2) g^2 +
     b2 v, u = m_hat / (sqrt(v_hat) + eps) with bias corrections 1 - b^t;
     the moments live in the parameter's dtype, except m in bfloat16 when
     moment_dtype="bfloat16" (optax's mu_dtype: m is rounded only when
     stored);
  3. add_decayed_weights(weight_decay): u + wd * p, when wd != 0;
  4. the per-leaf scale: 0 for a frozen leaf, the ViT's lr multiplier times
     its layer decay, else 1;
  5. scale_by_learning_rate(warmup_cosine_decay_schedule): u * -lr(t), with
     decay steps that include the warmup;
  6. apply_updates: p + u in the parameter's dtype.

Leaves are keyed by the JAX parameter paths ("vision/...", "projector/...",
"text/embed", "text/lm_head", ...), which a module's parameter name gives
with "." read as "/". A parameter with requires_grad=False has no gradient
(the JAX stop_gradient: its gradient is identically zero), so its moments
would stay zero and its Adam update is 0: it gets no state and is never
touched. That differs from optax only for a leaf that is stop-gradient'd yet
trainable in the mask with weight decay on, which the Trainer never builds
(both come from the same freeze flags).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 5e-6
    weight_decay: float = 0.0
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 0
    total_steps: int = 1000
    min_lr_ratio: float = 0.0
    vit_lr_mult: float = 1.0
    vit_layer_decay: float = 1.0  # <1.0: deeper ViT layers get higher lr
    freeze_vision: bool = False
    freeze_projector: bool = False
    freeze_text: bool = False
    freeze_embed: bool = False
    lora_only: bool = False  # train ONLY adapter (lora) leaves
    moment_dtype: str = "float32"  # "bfloat16" halves Adam m-state memory


def path_str(name: str) -> str:
    """A parameter's module name as the JAX package's path string."""
    return name.replace(".", "/")


def trainable_mask(params: nn.Module, cfg: OptimizerConfig) -> dict[str, bool]:
    """True = trainable, per parameter name (optimizer.py:52)."""

    def rule(p: str) -> bool:
        if cfg.lora_only:
            return "/lora/" in p
        if p.startswith("vision"):
            return not cfg.freeze_vision
        if p.startswith("projector"):
            return not cfg.freeze_projector
        if p.startswith("text/embed") or p.startswith("text/lm_head"):
            return not (cfg.freeze_text or cfg.freeze_embed)
        if p.startswith("text"):
            return not cfg.freeze_text
        return True

    return {name: rule(path_str(name)) for name, _ in params.named_parameters()}


_VIT_LAYER = re.compile(r"^vision/layers/(\d+)/")


def lr_scale_tree(
    params: nn.Module, cfg: OptimizerConfig, num_vit_layers: int
) -> dict[str, float]:
    """Per-parameter lr multipliers (optimizer.py:74): the ViT's lr_mult,
    times vit_layer_decay ** (L - 1 - l) for a leaf of ViT layer l."""

    def rule(p: str) -> float:
        if not p.startswith("vision"):
            return 1.0
        mult = cfg.vit_lr_mult
        layer = _VIT_LAYER.match(p)
        if cfg.vit_layer_decay != 1.0 and layer:
            return mult * cfg.vit_layer_decay ** (num_vit_layers - 1 - int(layer[1]))
        return mult

    return {name: rule(path_str(name)) for name, _ in params.named_parameters()}


def warmup_cosine_schedule(cfg: OptimizerConfig):
    """step -> lr: optax.warmup_cosine_decay_schedule as make_optimizer
    builds it (linear 0 -> lr over warmup_steps, then cosine to
    lr * min_lr_ratio by decay_steps = max(total_steps, warmup + 1)), in
    float32 like the JAX schedule."""
    peak, warm = cfg.lr, cfg.warmup_steps
    decay = max(cfg.total_steps, warm + 1) - warm
    end = cfg.lr * cfg.min_lr_ratio
    alpha = 0.0 if peak == 0.0 else end / peak
    f32 = torch.float32

    def schedule(step: int) -> float:
        if warm and step < warm:
            frac = 1 - torch.tensor(min(max(step, 0), warm), dtype=f32) / warm
            return float((0.0 - peak) * frac + peak)
        count = torch.tensor(min(step - warm, decay), dtype=f32)
        cosine = 0.5 * (1 + torch.cos(math.pi * count / decay))
        return float(peak * ((1 - alpha) * cosine + alpha))

    return schedule


@dataclasses.dataclass
class AdamState:
    """Adam moments per trainable-by-gradient parameter, and the step count
    (optax's ScaleByAdamState.count and ScaleByScheduleState.count, which
    advance together)."""

    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    count: int = 0


class AdamW:
    """The optax chain of make_optimizer over a module's parameters: ``init``
    builds the state, ``step`` applies one update in place."""

    def __init__(self, params: nn.Module, cfg: OptimizerConfig, num_vit_layers: int = 24):
        self.cfg = cfg
        mask = trainable_mask(params, cfg)
        scales = lr_scale_tree(params, cfg, num_vit_layers)
        self.scales = {n: (s if mask[n] else 0.0) for n, s in scales.items()}
        self.schedule = warmup_cosine_schedule(cfg)
        self.mu_dtype = {"float32": None, "bfloat16": torch.bfloat16}[cfg.moment_dtype]

    def init(self, params: nn.Module) -> AdamState:
        mu, nu = {}, {}
        for name, p in params.named_parameters():
            if p.requires_grad:
                mu[name] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                nu[name] = torch.zeros_like(p)
        return AdamState(mu, nu, 0)

    @torch.no_grad()
    def step(
        self, params: nn.Module, grads: dict[str, Optional[torch.Tensor]], state: AdamState
    ) -> AdamState:
        """One update of ``params`` from ``grads`` (name -> gradient in the
        parameter's dtype, or None where there is none), in place; the
        moments in ``state`` are updated in place too."""
        cfg = self.cfg
        b1, b2 = cfg.betas
        named = dict(params.named_parameters())
        live = {n: g for n, g in grads.items() if g is not None}
        for n in live:
            if n not in state.mu:  # a leaf that started to take gradients
                state.mu[n] = torch.zeros_like(named[n], dtype=self.mu_dtype or named[n].dtype)
                state.nu[n] = torch.zeros_like(named[n])
        g_norm = global_norm(live.values())
        clip = not bool(g_norm < cfg.grad_clip)
        count = state.count + 1
        lr = -self.schedule(state.count)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
        for n, g in live.items():
            p, m, v = named[n], state.mu[n], state.nu[n]
            if clip:
                g = g / g_norm.to(g.dtype) * _weak(cfg.grad_clip, g)
            mu = _weak(1 - b1, g) * g + _weak(b1, m) * m
            nu = _weak(1 - b2, g) * g**2 + _weak(b2, v) * v
            u = (mu / bc1.to(mu.dtype)) / (torch.sqrt(nu / bc2.to(nu.dtype)) + _weak(cfg.eps, nu))
            m.copy_(mu)
            v.copy_(nu)
            if cfg.weight_decay:
                u = u + _weak(cfg.weight_decay, p) * p
            u = u * _weak(self.scales[n], u)
            u = _weak(lr, u) * u
            p.copy_((p + u).to(p.dtype))
        state.count = count
        return state


def _weak(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar in ``like``'s dtype, as a JAX weak-typed scalar meets
    an array: rounded to that dtype first (0.9 is 0.8984375 against a bf16
    moment), where PyTorch would multiply in f32 and round only the result."""
    return torch.tensor(x, dtype=like.dtype)


def make_optimizer(
    params: nn.Module, cfg: OptimizerConfig, num_vit_layers: int = 24
) -> AdamW:
    """The optimizer for ``params`` (optimizer.py:106)."""
    return AdamW(params, cfg, num_vit_layers)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax.global_norm)."""
    total = None
    for t in tensors:
        sq = t.float().square().sum()
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return total.sqrt()
