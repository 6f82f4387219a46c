"""The training step on one device.

Counterpart of long_vita_tpu/training/train_step.py without the mesh: the
loss of the logits-masked head over the VLM forward, its gradients by
autograd (through the flash kernels' backward on CUDA), and the optimizer's
update, applied to the parameters in place (the JAX step returns new arrays
and donates the old ones; one copy of a 14B model is what fits here).

Batch contract (torch tensors on the parameters' device; the JAX step's,
cp = 1): tokens, positions, segment_ids [B, S]; logit_positions, labels
[B, M]; images [N, H, W, 3] and image_indices [2, N, T], or None.

Freezing mirrors the JAX step: freeze_text stops the gradient at the text
weights (requires_grad off: no dW is formed, activation gradients still flow
through the decoder to the projector), freeze_vision runs the tower under
no_grad; leaves frozen only by the optimizer's mask (lora_only's base
weights, freeze_projector, freeze_embed) take their gradients, which the
global norm (clipping and the grad_norm metric) counts: the step folds each
into an f32 sum of squares as soon as autograd has accumulated it and drops
it (``_backward``'s ``fold``), so that it is never held.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from long_vita_tpu_torch.config import LongVITAConfig
from long_vita_tpu_torch.models.long_vita import LongVITAParams, long_vita_forward
from long_vita_tpu_torch.training.loss import cross_entropy
from long_vita_tpu_torch.training.optimizer import AdamState, AdamW, global_norm, square_sum
from long_vita_tpu_torch.utils.convert import set_requires_grad


@dataclasses.dataclass
class TrainState:
    params: LongVITAParams
    opt_state: AdamState
    step: int = 0


def loss_fn(
    params: LongVITAParams,
    batch: dict,
    cfg: LongVITAConfig,
    remat: Union[bool, str],
    vision_chunk: int = 0,
    freeze_vision: bool = False,
    attn_impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (mean loss over the supervised rows, their count) (train_step.py:50).
    freeze_text acts through the text weights' requires_grad (set_requires_grad);
    attn_impl "xla" runs the same loss on the plain attention."""
    logits, _, aux = long_vita_forward(
        params, batch["tokens"], batch["positions"], cfg,
        images=batch.get("images"), image_indices=batch.get("image_indices"),
        segment_ids=batch.get("segment_ids"),
        logit_positions=batch["logit_positions"], vision_chunk=vision_chunk,
        attn_impl=attn_impl, remat=remat, return_aux=True,
        freeze_vision=freeze_vision,
    )
    loss_sum, count = cross_entropy(logits, batch["labels"])
    loss = loss_sum / count.clamp_min(1.0)
    if cfg.text.num_experts > 0:
        loss = loss + cfg.text.moe_aux_loss_coef * aux
    return loss, count


def _single_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "training on a mesh is not ported; the port trains on one GPU "
            "(ROADMAP: port queue, multi-GPU)"
        )


def gradients(params: LongVITAParams, exclude=frozenset()) -> dict[str, torch.Tensor]:
    """The gradient of every parameter that takes one (requires_grad) and is
    not in ``exclude``, zeros where the loss did not reach it (JAX returns
    zeros there too)."""
    return {
        n: (p.grad if p.grad is not None else torch.zeros_like(p))
        for n, p in params.named_parameters()
        if p.requires_grad and n not in exclude
    }


def _backward(params, batch, cfg, remat, vision_chunk, freeze_vision, freeze_text, *,
              fold=frozenset(), attn_impl="auto"):
    """One forward and backward. -> (gradients of the parameters that take
    them, loss, supervised count, folded): the parameters named in ``fold``
    give no gradient; each of theirs is added into ``folded``, an f32 sum
    of squares (None without ``fold``), once autograd has accumulated it,
    and dropped at once."""
    set_requires_grad(params, freeze_text=freeze_text, freeze_vision=freeze_vision)
    params.zero_grad(set_to_none=True)
    folded, hooks = None, []
    if fold:
        folded = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)

        def fold_grad(p):
            folded.add_(square_sum(p.grad))
            p.grad = None

        hooks = [p.register_post_accumulate_grad_hook(fold_grad)
                 for n, p in params.named_parameters() if n in fold and p.requires_grad]
    try:
        loss, count = loss_fn(params, batch, cfg, remat, vision_chunk, freeze_vision,
                              attn_impl=attn_impl)
        loss.backward()
    finally:
        for h in hooks:
            h.remove()
    grads = gradients(params, exclude=fold)
    params.zero_grad(set_to_none=True)
    return grads, loss.detach(), count, folded


def make_train_step(
    cfg: LongVITAConfig,
    tx: AdamW,
    mesh=None,
    *,
    remat: Union[bool, str] = True,
    vision_chunk: int = 0,
    freeze_vision: bool = False,
    freeze_text: bool = False,
):
    """-> train_step(state, batch) -> (state, metrics), updating the state's
    parameters and moments in place (train_step.py:144). metrics: loss,
    tokens (the supervised count) and grad_norm (the unclipped global norm,
    the mask-frozen gradients' folded squares included)."""
    _single_device(mesh)

    def train_step(state: TrainState, batch: dict):
        grads, loss, count, folded = _backward(
            state.params, batch, cfg, remat, vision_chunk, freeze_vision, freeze_text,
            fold=tx.frozen,
        )
        grad_norm = tx.step(state.params, grads, state.opt_state, folded)
        state.step += 1
        return state, {"loss": loss, "tokens": count, "grad_norm": grad_norm}

    return train_step


def make_grad_accum_steps(
    cfg: LongVITAConfig,
    tx: AdamW,
    mesh=None,
    *,
    remat: Union[bool, str] = True,
    vision_chunk: int = 0,
    freeze_vision: bool = False,
    freeze_text: bool = False,
):
    """Gradient accumulation (train_step.py:197): -> (grad_fn, accum_fn,
    apply_fn). grad_fn(params, batch) -> (f32 grads, loss, count);
    accum_fn(acc, grads) adds in place; apply_fn(state, grads, loss_sum,
    count_sum, n_micro) applies the mean gradient cast to each parameter's
    dtype. The reported loss is the mean of the micro-batch mean losses and
    grad_norm the norm of the f32 mean gradient. Mask-frozen leaves keep their
    f32 sums here: the norm of a mean cannot be folded micro-batch by
    micro-batch."""
    _single_device(mesh)

    def grad_fn(params: LongVITAParams, batch: dict):
        grads, loss, count, _ = _backward(
            params, batch, cfg, remat, vision_chunk, freeze_vision, freeze_text
        )
        return {n: g.float() for n, g in grads.items()}, loss, count

    def accum_fn(acc: dict, grads: dict) -> dict:
        for n, g in grads.items():
            acc[n].add_(g)
        return acc

    def apply_fn(state: TrainState, grads: dict, loss_sum, count_sum, n_micro):
        grads = {n: g / n_micro for n, g in grads.items()}
        grad_norm = global_norm(grads.values())
        named = dict(state.params.named_parameters())
        tx.step(state.params, {n: g.to(named[n].dtype) for n, g in grads.items()},
                state.opt_state)
        state.step += 1
        return state, {"loss": loss_sum / n_micro, "tokens": count_sum,
                       "grad_norm": grad_norm}

    return grad_fn, accum_fn, apply_fn


def init_train_state(
    params: LongVITAParams, tx: AdamW, mesh=None
) -> TrainState:
    """The optimizer state for ``params`` at step 0 (train_step.py:267):
    moments for every parameter that takes gradients and is not frozen by
    the optimizer's mask (set requires_grad first,
    utils/convert.set_requires_grad)."""
    _single_device(mesh)
    return TrainState(params, tx.init(params), 0)
