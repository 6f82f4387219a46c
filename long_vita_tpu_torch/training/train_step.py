"""The training step, on one device or on a dp x pp x cp x tp x tq mesh of ranks.

Counterpart of long_vita_tpu/training/train_step.py: the loss of the
logits-masked head over the VLM forward, its gradients by autograd (through
the flash kernels' backward on CUDA), and the optimizer's update, applied to
the parameters in place (the JAX step returns new arrays and donates the old
ones; one copy of a 14B model is what fits here).

Batch contract (torch tensors on the parameters' device): tokens,
positions, segment_ids [B, S]; logit_positions, labels [B, M]; images
[N, H, W, 3] and image_indices [2, N, T], or None. On a mesh (``mesh``, a
parallel.mesh.Mesh; each rank holds its own copy of the parameters, over
tp its shard of them, parallel/sharding.shard_params) each rank passes its
shard of the batch (training/distributed.make_global_batch): its dp rows,
the sequence keys cut to its cp shard of the zigzag-permuted sequence, the
rest whole; every tp rank of a (dp, cp) index the same. The loss is then
the global sum over the dp x cp ranks of each one's supervised rows over
the global count (JAX :4-11: the arrays stay logically global there; the
tp ranks of a cp shard agree on its rows' loss), each rank backpropagates
its share, and the gradients are all-reduced before the clip, so grad_norm
is the global one. Over tp (JAX :75-84 picks the vocab-parallel CE there)
the forward runs sequence parallel and the loss is training/loss.
vocab_parallel_ce; the reduction reads parallel/sharding.leaf_layout: a
tp-sharded leaf is summed over dp x cp (``Mesh.dp_cp_comm``), a kv slice
shared by tp // Hkv ranks over those ranks too (``Mesh.shared_comm``), and
a replicated leaf over the whole world: under sequence parallelism every
replicated leaf (the norms, final_norm, the tower, the projector) has a
partial gradient on each rank, covering its slice of the sequence. No
replicated leaf's gradient is the same on every tp rank, so none is summed
over tp twice. grad_norm is optimizer.tp_global_norm. A mask-frozen
gradient is folded once it is summed over its ranks (a square of a sum is
not a sum of squares): a decoder layer's, in its hook during the backward;
the rest after it, with the other gradients.

Under FSDP (the tree cut over dp too, ``Qwen2Params.fsdp``) a rank's
parameters, gradients and moments are its 1/dp shards. Each unit's
gradient is reduce-scattered over dp in the backward of the gather that
made its whole weights (parallel/fsdp.py), in the decoder's order on every
rank, and lands in the shard's .grad; the reduction then sums an FSDP leaf
over the ranks that hold the same shard: cp (``Mesh.cp_comm``), the kv
slice's sharers of the rank's dp index (``Mesh.shared_comm(share,
over_dp=False)``), and for a norm, replicated over tp and partial under
sequence parallelism, cp x tp (``Mesh.replica_comm``). Biases, the tower
and the projector are summed after the backward as before (their graph
differs between dp rows), and grad_norm sums the FSDP leaves' squares over
dp. ``_NORM_UNSUMMED_OVER_DP`` is the norm's fault for the gates, as
_UNSUMMED_OVER_TP is the reduction's. Over pp too (FSDP inside pipeline
stages, JAX's text_param_specs(fsdp=True, pp=True)) a stage's layer is
reduce-scattered over the dp ranks of its stage and summed as above within
the stage, and the embedding's and the head's shards, reduce-scattered on
the stage that used them (zeros on the others), are summed over pp as
well; grad_norm sums the stages' shards over dp, then over pp, and counts
the embedding's and the head's once.

Over pp (pipeline stages, parallel/pipeline.py; a rank's tree holds its
stage's layers, ``Qwen2Params.pp``) the loss follows JAX's rule (the
plain head and CE, train_step.py:75-85): the last stage computes it, and
a stage before the last returns the pipeline's anchor with a count of 0,
so that its backward runs the schedule in reverse; the loss and count are
summed over dp x pp x cp (``Mesh.dp_pp_cp_comm``). A stage's layer is
summed over the ranks of its stage that hold its slice (``Mesh.dp_cp_comm``,
``stage_comm`` for one replicated over tp); a leaf every stage holds (the
embedding, the head, final_norm, the tower, the projector) over pp too,
where the first stage alone has the embedding's, tower's and projector's
gradient and the last alone the head's: each counts once, and every stage
applies the same update to the same bits. grad_norm sums the stages'
layers' squares over pp and counts a shared leaf once (leaf_class's
stage classes). ``_UNSUMMED_OVER_PP`` and ``_NORM_UNSUMMED_OVER_PP`` are
the gates' faults.

On CUDA, thread-ranks (parallel/comm.ThreadComm) cannot train: autograd
runs every backward on a CUDA device on one worker thread of that device,
so a rank's ring backward that waits for another rank's blocks the other
(chip_smoke.py's 2-rank probe times out there); such a step raises. Over NCCL
processes, over gloo processes sharing a card through host-staged
collectives (parallel/comm.init_process_group(..., staged_device="cuda")),
or on the CPU, it runs.

Under 2-D tp (the tq axis, ``Qwen2Params.tq_comm``; JAX keeps the plain
head there, :75-84) the forward runs in the [B@dp, S@(cp, tp), H@tq]
layout and the loss is vocab_parallel_ce over tp of the logits summed
over tq, the same on every tp and tq rank of a (dp, cp) index. Who sums
what over tq (JAX's GSPMD gives these sums implicitly): a leaf cut over tq
(the kernels, the embedding, the head) has its own gradient on each tq
rank and is summed over dp x cp as a tp shard is; a leaf with a tp spec
that tq leaves whole (the q/k/v biases, LoRA's factors cut over tp) is
used after the sum over tq, the same on every tq rank, so its gradient is
too and is summed over dp x cp alone (``Leaf.tq_same``), counted once in
grad_norm; every other leaf (the norms, final_norm, the tower, the
projector, LoRA's replicated factors) is used on the rank's hidden slice,
or feeds a row that is cut to it, and is summed over the world, tq
included (``Leaf.partial``). ``_UNSUMMED_OVER_TQ`` is the gates' fault.

A MoE decoder over the mesh (models/qwen2.py, ops/moe.py) adds the
Switch aux loss as JAX does (:110-113, loss + moe_aux_loss_coef * aux),
where JAX's aux is the mean over dp of each dp shard's aux (pmean inside
its EP shard_map), summed over the layers and, over pp, averaged over the
microbatches. Each rank's aux is its dp shard's, the same on the shard's
cp and tp ranks, its gradient flowing into the rank's own tokens alone
(ops/moe.py), so each rank backpropagates moe_aux_loss_coef * aux / dp and
the reported loss adds the mean over dp. Who sums what (sharding.Leaf):
an expert stack cut over dp (expert parallelism) is summed over cp alone,
since the exchange's backward brought every dp rank's rows to its owner,
and counts once per owner in grad_norm (summed over dp and tp there, as an
FSDP piece); at dp 1 it is a tp shard (or replicated) as any other; the
router is replicated and summed over the world. ``_EXPERTS_SUMMED_OVER_DP``
(the expert gradients summed over dp x cp as if replicated),
``_NORM_EXPERTS_ONCE_OVER_DP`` (grad_norm counting them as a leaf
replicated over dp: one rank's experts for all) and ``_AUX_SUMMED_OVER_DP``
(the aux summed over dp, not averaged) are the gates' faults.

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
from typing import Optional, Union

import torch

from long_vita_tpu_torch.config import LongVITAConfig
from long_vita_tpu_torch.models.long_vita import LongVITAParams, cp_logit_rows, long_vita_forward
from long_vita_tpu_torch.models.qwen2 import ParallelConfig
from long_vita_tpu_torch.parallel.comm import ThreadComm
from long_vita_tpu_torch.parallel.fsdp import head_weight, streaming
from long_vita_tpu_torch.parallel.sharding import rank_layout
from long_vita_tpu_torch.training.loss import cross_entropy, vocab_parallel_ce
from long_vita_tpu_torch.training.optimizer import (
    AdamState,
    AdamW,
    counted,
    global_norm,
    leaf_class,
    square_sum,
    tp_global_norm,
)
from long_vita_tpu_torch.utils.convert import set_requires_grad

GRAD_BUCKET_BYTES = 256 * 2**20  # gradients all-reduced in buckets of this size

# A fault for the gates that must catch it (tests, chip_smoke.py), never set
# in training: parameter names ending in one of these suffixes have their
# replicated gradient summed over dp x cp only, not over tp, as if the
# sequence-parallel norms' tp sum were missing.
_UNSUMMED_OVER_TP: tuple = ()
# A fault for the same gates, never set in training: grad_norm counts each
# rank's own FSDP shards only (their squares not summed over dp).
_NORM_UNSUMMED_OVER_DP = False
# Faults for the pipeline's gates, never set in training: a leaf every stage
# holds (the embedding, the head, final_norm, the tower, the projector) has
# its gradient summed within its stage only, not over pp; grad_norm counts
# each stage's own layers only (their squares not summed over pp).
_UNSUMMED_OVER_PP = False
_NORM_UNSUMMED_OVER_PP = False
# A fault for the 2-D tp gates, never set in training: parameter names ending
# in one of these suffixes have their replicated gradient summed over the
# ranks of this rank's tq index only (each rank's norm gradient covers its
# hidden slice alone).
_UNSUMMED_OVER_TQ: tuple = ()
# Faults for the expert-parallel gates, never set in training: the expert
# stacks' gradients summed over dp x cp as if they were replicated over dp;
# grad_norm counting them as a leaf replicated over dp (one rank's for all);
# the aux summed over dp instead of averaged (in the objective and the
# reported loss).
_EXPERTS_SUMMED_OVER_DP = False
_NORM_EXPERTS_ONCE_OVER_DP = False
_AUX_SUMMED_OVER_DP = False


@dataclasses.dataclass
class TrainState:
    params: LongVITAParams
    opt_state: AdamState
    step: int = 0


def loss_terms(
    params: LongVITAParams,
    batch: dict,
    cfg: LongVITAConfig,
    remat: Union[bool, str],
    vision_chunk: int = 0,
    freeze_vision: bool = False,
    attn_impl: str = "auto",
    parallel: Optional[ParallelConfig] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (summed loss over the supervised rows, their count, MoE aux). With
    ``parallel`` (cp > 1): over the rows of this rank's shard. With tp > 1
    (the parameters a tp shard): the vocab-parallel CE of those rows (JAX
    :75-84's rule: tp > 1 without pp or tq, the budget dividing over cp;
    where it does not, JAX's plain head and CE give the same loss, and the
    port keeps this CE over each cp shard's rows), the same on every tp
    rank. With tq > 1 (a 2-D tp shard), where JAX takes its plain head:
    the same CE of the logits summed over tq, the same on every tp and tq
    rank. Over pp (JAX's rule: the plain head and CE there): the last
    stage's rows; a stage before the last returns the pipeline's anchor (a
    zero tied to its backward, parallel/pipeline.py) and a count of 0, and
    the last stage adds the anchor to its sum."""
    tp = parallel.mesh.shape["tp"] * parallel.mesh.shape["tq"] if parallel is not None else 1
    pp = parallel.pp if parallel is not None else 1
    vp = tp > 1 and pp == 1
    out, _, aux, anchor = long_vita_forward(
        params, batch["tokens"], batch["positions"], cfg,
        images=batch.get("images"), image_indices=batch.get("image_indices"),
        segment_ids=batch.get("segment_ids"),
        logit_positions=batch["logit_positions"], vision_chunk=vision_chunk,
        attn_impl=attn_impl, remat=remat, return_aux=True,
        freeze_vision=freeze_vision, parallel=parallel, head=not vp, return_anchor=True,
    )
    if out is None:  # a pipeline stage before the last
        return anchor, torch.zeros((), dtype=torch.float32, device=anchor.device), aux
    labels = batch["labels"]
    if parallel is not None and (parallel.cp > 1 or tp > 1):
        mask, _ = cp_logit_rows(batch["logit_positions"], batch["tokens"].shape[1],
                                parallel.comm.rank)
        labels = labels[mask][None]
    if vp:
        with streaming(params.text):  # an FSDP head is gathered, and again in the backward
            loss_sum, count = vocab_parallel_ce(head_weight(params.text), out, labels,
                                                params.text.tp_comm, params.text.tq_comm)
    else:
        loss_sum, count = cross_entropy(out, labels)
    return loss_sum + anchor, count, aux


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
    loss_sum, count, aux = loss_terms(params, batch, cfg, remat, vision_chunk, freeze_vision,
                                      attn_impl)
    loss = loss_sum / count.clamp_min(1.0)
    if cfg.text.num_experts > 0:
        loss = loss + cfg.text.moe_aux_loss_coef * aux
    return loss, count


def make_parallel_config(mesh, *, cp_algo: str = "ring", cp_inner: int = 1,
                         cp_window: int = 0) -> Optional[ParallelConfig]:
    """The model's mesh context (JAX :116), or None without a mesh."""
    if mesh is None or mesh.size <= 1:
        return None
    return ParallelConfig(mesh, cp_algo=cp_algo, cp_inner=cp_inner, cp_window=cp_window)


def _check_mesh(mesh, device=None) -> None:
    """A mesh must be a parallel.mesh.Mesh (dp x pp x cp x tp x tq);
    thread-ranks train only on the CPU (see the module docstring)."""
    if mesh is None:
        return
    from long_vita_tpu_torch.parallel.mesh import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a long_vita_tpu_torch.parallel.mesh.Mesh, got {mesh!r}")
    if (isinstance(mesh.world, ThreadComm) and mesh.size > 1 and device is not None
            and torch.device(device).type == "cuda"):
        raise RuntimeError(
            "training over thread-ranks (ThreadComm) on CUDA would hang: PyTorch's autograd "
            "engine runs all backward work of a CUDA device on that device's one worker "
            "thread, so one rank's ring backward waiting for another rank blocks the other "
            "rank's backward. Train over NCCL processes (one GPU each) or on the CPU."
        )


def _all_reduce_grads(grads: dict, comm_of) -> dict:
    """Sum every gradient over its communicator (``comm_of(name)``) in
    place, in buckets of GRAD_BUCKET_BYTES flattened per dtype and
    communicator (one bucket is the only copy held). -> ``grads``."""
    bucket, size, comm = [], 0, None

    def flush():
        nonlocal bucket, size
        if not bucket:
            return
        flat = comm.all_reduce_sum(torch.cat([g.reshape(-1) for g in bucket]))
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))
        bucket, size = [], 0

    for name, g in grads.items():
        c = comm_of(name)
        if bucket and (bucket[0].dtype != g.dtype or c is not comm
                       or size + g.nbytes > GRAD_BUCKET_BYTES):
            flush()
        comm = c
        bucket.append(g)
        size += g.nbytes
    flush()
    return grads


class _Reduction:
    """Which ranks a leaf's gradient is summed over, and how it counts in
    the global norm (see the module docstring): without tp or FSDP, every
    leaf over the world; else by parallel/sharding.rank_layout."""

    def __init__(self, params, cfg, mesh):
        self.mesh, self.world = mesh, mesh.world
        self.layout = rank_layout(params, cfg, mesh)
        self.fsdp = params.text.fsdp is not None
        self.ep = params.text.ep_comm is not None

    def comm(self, name: str):
        """The ranks the gradient is summed over (an FSDP leaf's after its
        reduce-scatter over dp): the ranks that hold the same slice, a
        pipeline stage's layer over its stage's ranks only."""
        if self.layout is None:
            return self.world
        leaf, mesh = self.layout[name], self.mesh
        if leaf.expert:
            return mesh.dp_cp_comm if _EXPERTS_SUMMED_OVER_DP else mesh.cp_comm
        unsummed = name.endswith(_UNSUMMED_OVER_TP)
        if leaf.partial and not unsummed and name.endswith(_UNSUMMED_OVER_TQ):
            return mesh.over("dp", "pp", "cp", "tp")
        if leaf.fsdp:
            if leaf.sharded and leaf.share > 1:
                return mesh.shared_comm(leaf.share, over_dp=False)
            axes = ["cp"] if leaf.sharded or unsummed else ["cp", "tp", "tq"]
            if not leaf.staged and mesh.shape["pp"] > 1 and not _UNSUMMED_OVER_PP:
                axes.append("pp")  # the embedding's or the head's shard, one stage's gradient
            return mesh.over(*axes)
        if leaf.sharded and leaf.share > 1:
            return mesh.shared_comm(leaf.share)
        one_stage = leaf.staged or _UNSUMMED_OVER_PP
        if leaf.partial and not unsummed:
            return mesh.stage_comm if one_stage else self.world
        return mesh.dp_cp_comm if one_stage else mesh.dp_pp_cp_comm

    def counts(self, name: str) -> bool:
        """Whether this rank counts the leaf's squares in the norm (of a
        slice several tp ranks share, only the first; of a leaf that tq
        does not cut, tq rank 0)."""
        if self.layout is None:
            return True
        return counted(self.layout[name], self.mesh.tp_comm, self.mesh.tq_comm)

    def klass(self, name: str) -> int:
        """The leaf's optimizer.leaf_class (0 without a layout)."""
        return 0 if self.layout is None else leaf_class(self.layout[name],
                                                        _NORM_EXPERTS_ONCE_OVER_DP)

    def norm(self, grads: dict, folded=None) -> torch.Tensor:
        """The global norm of the summed ``grads`` (and of ``folded``: the
        squares folded already, by leaf_class)."""
        if self.layout is None:
            extra = None if folded is None else folded[0]
            return global_norm(grads.values(), extra)
        dp_comm = self.mesh.dp_comm if (self.fsdp or self.ep) and not _NORM_UNSUMMED_OVER_DP \
            else None
        pp_comm = self.mesh.pp_comm if not _NORM_UNSUMMED_OVER_PP else None
        return tp_global_norm(grads, self.layout, self.mesh.tp_comm, folded, dp_comm, pp_comm,
                              self.mesh.tq_comm, _NORM_EXPERTS_ONCE_OVER_DP)


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
              fold=frozenset(), attn_impl="auto", mesh=None, parallel=None):
    """One forward and backward. -> (gradients of the parameters that take
    them, loss, supervised count, folded): the parameters named in ``fold``
    give no gradient; each of theirs is added into ``folded``, an f32 sum
    of squares (None without ``fold``), once autograd has accumulated it,
    and dropped at once. On a mesh: the global loss and count, the
    gradients summed over the ranks, ``folded`` from the summed ones."""
    if mesh is not None and mesh.size > 1:
        return _backward_mesh(params, batch, cfg, remat, vision_chunk, freeze_vision,
                              freeze_text, attn_impl, mesh, parallel, fold)
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


def _backward_mesh(params, batch, cfg, remat, vision_chunk, freeze_vision, freeze_text,
                   attn_impl, mesh, parallel, fold):
    """_backward over a mesh. A decoder layer's ``fold`` leaf is summed over
    its ranks in its post-accumulate hook, folded and dropped, so that at
    most one such gradient is held (lora_only's base weights are most of a
    model); every rank runs the same decoder graph, so the hooks fire in the
    same order on each (an FSDP leaf's gradient is the shard's, already
    reduce-scattered over dp). The rest (whose graph can differ between dp
    rows: the tower and projector reach only a rank with images) are summed
    after the backward, the ``fold`` ones among them folded then. -> folded
    as eight sums of squares by optimizer.leaf_class (this rank's shares),
    or None without ``fold``; the loss and count summed over dp x pp x cp
    (the tp ranks of a cp shard hold the same rows; of a pipeline's stages
    the last alone counts them), the loss with a MoE decoder's aux term
    (the mean over dp of each dp shard's)."""
    set_requires_grad(params, freeze_text=freeze_text, freeze_vision=freeze_vision)
    params.zero_grad(set_to_none=True)
    red = _Reduction(params, cfg, mesh)
    folded, hooks, in_hook = None, [], set()

    def fold_in(name, g):
        if red.counts(name):
            folded[red.klass(name)].add_(square_sum(g))

    if fold:
        dev = batch["tokens"].device
        folded = tuple(torch.zeros((), dtype=torch.float32, device=dev) for _ in range(8))

        def fold_grad(name, p):
            fold_in(name, red.comm(name).all_reduce_sum(p.grad))
            p.grad = None

        in_hook = {n for n, p in params.named_parameters()
                   if n in fold and p.requires_grad and n.startswith("text.layers.")}
        hooks = [p.register_post_accumulate_grad_hook(lambda p, n=n: fold_grad(n, p))
                 for n, p in params.named_parameters() if n in in_hook]
    try:
        objective, loss, count = mesh_loss(
            *loss_terms(params, batch, cfg, remat, vision_chunk, freeze_vision, attn_impl,
                        parallel), cfg, mesh)
        objective.backward()
    finally:
        for h in hooks:
            h.remove()
    grads = _all_reduce_grads(gradients(params, exclude=in_hook), red.comm)
    params.zero_grad(set_to_none=True)
    for name in [n for n in grads if n in fold]:  # the same order on every rank
        fold_in(name, grads.pop(name))
    return grads, loss, count, folded


def mesh_loss(loss_sum, count, aux, cfg: LongVITAConfig, mesh):
    """A mesh rank's loss terms (loss_terms) -> (the objective it
    backpropagates, the reported loss, the supervised count): the loss and
    count summed over dp x pp x cp, and with a MoE decoder the aux term,
    moe_aux_loss_coef x the mean over dp of each dp shard's aux (a rank's
    aux is its dp shard's, the same on the shard's cp ranks), of which each
    rank backpropagates its aux / dp."""
    dp, cp = mesh.shape["dp"], mesh.shape["cp"]
    over = 1 if _AUX_SUMMED_OVER_DP else dp
    # the sum over dp x pp x cp of aux / (dp x cp) is the mean over dp
    total = mesh.dp_pp_cp_comm.all_reduce_sum(
        torch.stack([loss_sum.detach().float(), count.float(), aux.detach().float() / (over * cp)]))
    n = total[1].clamp_min(1.0)
    objective, loss = loss_sum / n, total[0] / n
    if cfg.text.num_experts > 0:
        objective = objective + cfg.text.moe_aux_loss_coef * aux / over
        loss = loss + cfg.text.moe_aux_loss_coef * total[2]
    return objective, loss, total[1]


def make_train_step(
    cfg: LongVITAConfig,
    tx: AdamW,
    mesh=None,
    *,
    remat: Union[bool, str] = True,
    vision_chunk: int = 0,
    freeze_vision: bool = False,
    freeze_text: bool = False,
    cp_algo: str = "ring",
    cp_inner: int = 1,
    cp_window: int = 0,
):
    """-> train_step(state, batch) -> (state, metrics), updating the state's
    parameters and moments in place (train_step.py:144). metrics: loss,
    tokens (the supervised count) and grad_norm (the unclipped global norm,
    the mask-frozen gradients' folded squares included). On a mesh: the
    global ones, cp_algo / cp_inner / cp_window choosing the attention."""
    _check_mesh(mesh)
    parallel = make_parallel_config(mesh, cp_algo=cp_algo, cp_inner=cp_inner,
                                    cp_window=cp_window)

    def train_step(state: TrainState, batch: dict):
        _check_mesh(mesh, batch["tokens"].device)
        grads, loss, count, folded = _backward(
            state.params, batch, cfg, remat, vision_chunk, freeze_vision, freeze_text,
            fold=tx.frozen, mesh=mesh, parallel=parallel,
        )
        if mesh is not None and mesh.size > 1:
            g_norm = _Reduction(state.params, cfg, mesh).norm(grads, folded)
            grad_norm = tx.step(state.params, grads, state.opt_state, g_norm=g_norm)
        else:
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
    cp_algo: str = "ring",
    cp_inner: int = 1,
    cp_window: int = 0,
):
    """Gradient accumulation (train_step.py:197): -> (grad_fn, accum_fn,
    apply_fn). grad_fn(params, batch) -> (f32 grads, loss, count);
    accum_fn(acc, grads) adds in place; apply_fn(state, grads, loss_sum,
    count_sum, n_micro) applies the mean gradient cast to each parameter's
    dtype. The reported loss is the mean of the micro-batch mean losses and
    grad_norm the norm of the f32 mean gradient. Mask-frozen leaves keep their
    f32 sums here: the norm of a mean cannot be folded micro-batch by
    micro-batch. On a mesh each micro-batch's loss and gradients are the
    global ones."""
    _check_mesh(mesh)
    parallel = make_parallel_config(mesh, cp_algo=cp_algo, cp_inner=cp_inner,
                                    cp_window=cp_window)

    def grad_fn(params: LongVITAParams, batch: dict):
        _check_mesh(mesh, batch["tokens"].device)
        grads, loss, count, _ = _backward(
            params, batch, cfg, remat, vision_chunk, freeze_vision, freeze_text,
            mesh=mesh, parallel=parallel,
        )
        return {n: g.float() for n, g in grads.items()}, loss, count

    def accum_fn(acc: dict, grads: dict) -> dict:
        for n, g in grads.items():
            acc[n].add_(g)
        return acc

    def apply_fn(state: TrainState, grads: dict, loss_sum, count_sum, n_micro):
        grads = {n: g / n_micro for n, g in grads.items()}
        named = dict(state.params.named_parameters())
        cast = {n: g.to(named[n].dtype) for n, g in grads.items()}
        red = _Reduction(state.params, cfg, mesh) if mesh is not None and mesh.size > 1 else None
        if red is not None and red.layout is not None:
            grad_norm = red.norm(grads)
            tx.step(state.params, cast, state.opt_state, g_norm=red.norm(cast))
        else:
            grad_norm = global_norm(grads.values())
            tx.step(state.params, cast, state.opt_state)
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
    utils/convert.set_requires_grad). On a mesh every rank holds the whole
    parameters, or over tp and under FSDP its shard of them (the moments
    take the shard's shapes)."""
    _check_mesh(mesh)
    return TrainState(params, tx.init(params), 0)
