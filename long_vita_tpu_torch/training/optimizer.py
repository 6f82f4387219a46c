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

A leaf frozen by the mask alone (``frozen``: lora_only's base weights,
freeze_projector, freeze_embed) has a gradient that optax counts in the
global norm of step 1, and an update of 0 whatever its moments: it gets no
moments here, and its gradient counts in the norm only. The train step folds
such a gradient into an f32 sum of squares as soon as autograd has
accumulated it and drops it (``frozen_sq``), so a LoRA run over a 14B model
never holds the base weights' gradients, nor moments for them.

Over tensor parallelism the parameters are a rank's shards (parallel/
sharding.py) and AdamW stays elementwise on them; the global norm that
clipping and the grad_norm metric read is ``tp_global_norm``: a sharded
leaf's squares summed over tp (a slice that several ranks share counted
once), a replicated leaf's counted once, as optax.global_norm counts the
global arrays. Under FSDP a rank's parameters, gradients and moments are
its 1/dp shards (the moments take the parameters' shapes), and the norm
sums an FSDP leaf's squares over dp as well. Over pp a rank holds its
stage's layers: their squares are summed over the stages, and a leaf
every stage holds is counted once. Under 2-D tp a leaf cut over tq has
its squares summed over tq, and one that tq leaves whole is counted on tq
rank 0 alone.
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
    advance together); ``config``: the OptimizerConfig of the chain it
    belongs to (AdamW.init sets it; a checkpoint keys the state by it)."""

    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    count: int = 0
    config: Optional[OptimizerConfig] = None


def optax_chain_slots(cfg: OptimizerConfig) -> tuple[str, str, tuple[str, ...]]:
    """Where make_optimizer's optax chain (optimizer.py:106-138) keeps its
    state, as orbax keys it: (scale_by_adam's index, with count, mu and nu;
    scale_by_learning_rate's, with its count; the empty states':
    clip_by_global_norm, add_decayed_weights when weight_decay is set,
    _scale_by_tree). JAX holds mu and nu for every leaf, mu in bfloat16
    under moment_dtype "bfloat16", else each in its parameter's dtype."""
    if cfg.weight_decay:
        return "1", "4", ("0", "2", "3")
    return "1", "3", ("0", "2")


class AdamW:
    """The optax chain of make_optimizer over a module's parameters: ``init``
    builds the state, ``step`` applies one update in place."""

    def __init__(self, params: nn.Module, cfg: OptimizerConfig, num_vit_layers: int = 24):
        self.cfg = cfg
        mask = trainable_mask(params, cfg)
        scales = lr_scale_tree(params, cfg, num_vit_layers)
        self.scales = {n: (s if mask[n] else 0.0) for n, s in scales.items()}
        self.frozen = frozenset(n for n, m in mask.items() if not m)
        self.schedule = warmup_cosine_schedule(cfg)
        self.mu_dtype = {"float32": None, "bfloat16": torch.bfloat16}[cfg.moment_dtype]

    def init(self, params: nn.Module) -> AdamState:
        """Moments for every parameter that takes gradients and is not
        frozen by the mask."""
        mu, nu = {}, {}
        for name, p in params.named_parameters():
            if p.requires_grad and name not in self.frozen:
                mu[name] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                nu[name] = torch.zeros_like(p)
        return AdamState(mu, nu, 0, self.cfg)

    @torch.no_grad()
    def step(
        self, params: nn.Module, grads: dict[str, Optional[torch.Tensor]], state: AdamState,
        frozen_sq: Optional[torch.Tensor] = None, g_norm: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """One update of ``params`` from ``grads`` (name -> gradient in the
        parameter's dtype, or None where there is none), in place; the
        moments in ``state`` are updated in place too. ``frozen_sq``: the f32
        sum of squares of mask-frozen gradients that were folded away; it
        and any mask-frozen gradient in ``grads`` count in the global norm
        only. ``g_norm``: that global norm when the caller has it (over tp
        shards, tp_global_norm), else it is computed here. -> the global
        norm (the unclipped grad_norm)."""
        cfg = self.cfg
        b1, b2 = cfg.betas
        named = dict(params.named_parameters())
        live = {n: g for n, g in grads.items() if g is not None}
        if g_norm is None:
            g_norm = global_norm(live.values(), frozen_sq)
        live = {n: g for n, g in live.items() if n not in self.frozen}
        for n in live:
            if n not in state.mu:  # a leaf that started to take gradients
                state.mu[n] = torch.zeros_like(named[n], dtype=self.mu_dtype or named[n].dtype)
                state.nu[n] = torch.zeros_like(named[n])
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
        return g_norm


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


def square_sum(t: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of a tensor's elements: the square of its f32
    2-norm, which reads a bf16 tensor without an f32 copy of it (the
    embedding's and the head's gradients are 1.6 GB each at 14B)."""
    return torch.linalg.vector_norm(t, dtype=torch.float32).square()


def global_norm(tensors, extra_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax.global_norm),
    plus ``extra_sq`` (squares summed already) when given."""
    total = extra_sq
    for t in tensors:
        sq = square_sum(t)
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return total.sqrt()


def leaf_class(leaf, experts_as_replicated: bool = False) -> int:
    """A Leaf's (parallel/sharding.py) class in the global norm: 0
    replicated, 1 cut over tp, 2 over dp (FSDP, or an expert stack under
    expert parallelism: a piece per owner), 3 over both; 4 more for a layer
    of a pipeline stage (cut over pp). experts_as_replicated: the gates'
    fault (train_step._NORM_EXPERTS_ONCE_OVER_DP)."""
    over_dp = leaf.fsdp or (leaf.expert and not experts_as_replicated)
    return (1 if leaf.sharded else 0) + (2 if over_dp else 0) + (4 if leaf.staged else 0)


def counted(leaf, tp_comm, tq_comm) -> bool:
    """Whether this rank counts a Leaf's squares in the global norm: of a
    slice that ``share`` tp ranks hold, the first; of a leaf that tq does
    not cut, tq rank 0."""
    if leaf.sharded and tp_comm.rank % leaf.share:
        return False
    return leaf.cut_tq or tq_comm.rank == 0


def tp_global_norm(grads: dict, layout: dict, tp_comm, folded: Optional[tuple] = None,
                   dp_comm=None, pp_comm=None, tq_comm=None,
                   experts_as_replicated: bool = False) -> torch.Tensor:
    """The global norm over a rank's shards (optax.global_norm of the whole
    arrays): ``layout`` (parallel/sharding.leaf_layout) tells a leaf cut
    over tp, whose squares are summed over ``tp_comm`` (of a slice that
    ``share`` ranks hold, only the first rank's), or over dp by FSDP,
    summed over ``dp_comm`` (an expert stack under expert parallelism too:
    one piece per owner), from a replicated one, counted once (its
    summed gradient is the same on every rank); a tp-cut leaf's summed
    gradient is the same on every dp rank and an FSDP-cut replicated one's
    on every tp rank, so each counts once there. A pipeline stage's layers
    are summed over ``pp_comm`` too, a leaf every stage holds counted once.
    Under 2-D tp every class is summed over ``tq_comm``, each leaf counted
    as ``counted`` says. ``folded``: f32 sums of squares of gradients folded away already, by
    leaf_class (this rank's shares). -> f32 scalar, the same bits on every
    rank."""
    sums = list(folded) if folded is not None else [None] * 8
    sums += [None] * (8 - len(sums))
    from long_vita_tpu_torch.parallel.comm import LocalComm

    tq_comm = tq_comm if tq_comm is not None else LocalComm()
    for name, g in grads.items():
        leaf = layout[name]
        if not counted(leaf, tp_comm, tq_comm):
            continue
        k = leaf_class(leaf, experts_as_replicated)
        sq = square_sum(g)
        sums[k] = sq if sums[k] is None else sums[k] + sq
    like = next(iter(grads.values()), None)
    dev = like.device if like is not None else None
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sums = torch.stack([s if s is not None else zero for s in sums]).view(2, 4)

    def once(first: bool) -> torch.Tensor:
        return torch.tensor(1.0 if first else 0.0, device=dev)

    cut = sums[:, 1:]  # [every stage's, a stage's] x [tp, dp, both]
    if dp_comm is not None and dp_comm.size > 1:
        cut = dp_comm.all_reduce_sum(cut * torch.stack([once(dp_comm.rank == 0), once(True),
                                                        once(True)]))
    cut = tp_comm.all_reduce_sum(cut * torch.stack([once(True), once(tp_comm.rank == 0),
                                                    once(True)]))
    total = cut.sum(1) + sums[:, 0]
    if tq_comm.size > 1:
        total = tq_comm.all_reduce_sum(total)
    staged = total[1]
    if pp_comm is not None and pp_comm.size > 1:
        staged = pp_comm.all_reduce_sum(staged)
    return (total[0] + staged).sqrt()
