"""FSDP: ZeRO-3 weight streaming over dp, written out.

Counterpart of what GSPMD inserts for long_vita_tpu/parallel/sharding.py's
``fsdp=True`` layout (:39-79): each rank holds 1/dp of every FSDP leaf
(parallel/sharding.fsdp_dim), its gradient and its Adam moments; a layer's
whole weights exist only while that layer runs, forward or backward. JAX's
scan all-gathers one layer's weights inside the loop body and
reduce-scatters dW; here a unit (one decoder layer's FSDP leaves, the
embedding, or the head) is gathered by ``_Gather``, a torch.autograd.Function:

  - forward: an all-gather over ``Fsdp.comm`` (the mesh's dp_comm) of the
    unit's shards, flattened in buckets of at most BUCKET_BYTES of whole
    tensors (a 72B layer: its attention weights and norms, then gate, up
    and down alone), cut back into the whole tensors (with tp, the rank's
    tp slices: tp's collectives then run as before);
  - backward: a reduce-scatter a bucket of the whole tensors' gradients
    back to the shards (summed in rank order), which accumulate into the
    shard parameters' ``.grad``.

A MoE layer's unit is its norms and attention weights: its router is
replicated and its expert stacks are cut over dp for expert parallelism
(JAX's specs, sharding.py:88-97), so they are the shard's own and never
gathered (ops/moe.py exchanges the rows instead).

The whole tensors are freed once the unit's forward ends. Under remat the
gather runs inside the checkpointed layer, so the backward's recompute
gathers again. Without remat a product would save its gathered weight for
the backward (``F.linear`` saves it, as does the head's GEMM) and every
layer's whole weights would stay alive until the backward reached them:
``streaming()`` installs saved_tensors_hooks whose pack replaces a saved
tensor that lies in a gathered unit's storage by a token (the unit, the
leaf, the view's geometry), and whose unpack gathers the unit again, once,
at its first use in the backward; that copy is dropped when the unit's
``_Gather`` backward runs or another unit of the tree regathers (the
backward walks the units in reverse, one at a time, on every rank in the
same order). ``Fsdp.live_units()`` and ``Fsdp.stats`` count the units
whose gathered tensors are alive (the tests hold the peak to one unit),
the gathers, regathers and scatters, and the bytes gathered.

Inside pipeline stages (JAX's text_param_specs(fsdp=True, pp=True)) a
stage's tree holds 1/dp of each of its layers, and ``Fsdp.comm`` joins the
dp ranks of the stage. The units are the stage's own layers, each gathered
in every tick that runs it: one unit a (microbatch, layer) pass, under
GPipe (M microbatches through each layer, forward, then the backward) and
under the interleaved schedule (chunk-major ticks) alike; the first stage
gathers the embedding and the last the head, once a step. Every dp rank
of a stage runs the same ticks in the same order, so the regather rule
holds there too. With Ls layers a stage, M microbatches and remat off, a
step on one rank makes Ls M + e + h gathers, Ls M + h regathers (the
saved-tensor hooks; the embedding's lookup saves no weight) and Ls M + e
+ h scatters, where e is 1 on the first stage and h 1 on the last (0
elsewhere); with remat the recompute gathers each unit again (2 Ls M + e
+ h gathers) and only the head is regathered (``step_counts``; the head
when its product saves the gathered weight). pp and
virtual_pp enter only through e and h: the interleaved schedule runs each
of its M v units through Ls / v layers.

``_LOCAL_SLICE_NOT_SCATTERED`` is a fault for the gates that must catch it
(tests, chip_smoke.py), never set in training: the backward keeps the
rank's own slice of its own gradient instead of the reduce-scatter.
"""
from __future__ import annotations

import contextlib
import copy
import weakref
from typing import Optional

import torch

from long_vita_tpu_torch.parallel.sharding import COLUMN, ROW

# A fault for the gates (see the module docstring), never set in training.
_LOCAL_SLICE_NOT_SCATTERED = False
# whole-tensor bytes a unit's collective moves at most (one larger leaf alone)
BUCKET_BYTES = 512 * 2**20

class Fsdp:
    """What a tree's decoder needs to stream its FSDP leaves
    (``Qwen2Params.fsdp``, bound by sharding.shard_params): ``comm``, the
    mesh's dp communicator, and the rank's own accounting (``stats``,
    ``live_units``), gathered tensors and regathered unit."""

    def __init__(self, comm):
        self.comm = comm
        self.stats = dict.fromkeys(("gathers", "regathers", "scatters", "gathered_bytes",
                                    "peak_live"), 0)
        self._live: list = []  # (unit id, weakref to a gathered tensor)
        # data_ptr of a gathered tensor's storage -> (its unit, its leaf
        # index, a weakref to it): what ``streaming``'s pack hook recognises
        self._gathered: dict = {}
        self._current: Optional[weakref.ref] = None  # the unit holding a regathered copy

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = 0

    def live_units(self) -> int:
        """The units whose gathered (or regathered) tensors are alive now."""
        self._live[:] = [(uid, r) for uid, r in self._live if r() is not None]
        return len({uid for uid, _ in self._live})


class _Unit:
    """One unit's shards (parameters) and their FSDP dims, of the tree whose
    Fsdp is ``fs``; ``regathered``: the whole tensors gathered again for
    the backward."""

    def __init__(self, shards: list, dims: list, fs: Fsdp):
        self.shards, self.dims, self.fs, self.comm = shards, dims, fs, fs.comm
        self.regathered: Optional[list] = None

    def buckets(self) -> list:
        """The unit's leaves in the groups that move together: consecutive
        leaves of one dtype up to BUCKET_BYTES of whole tensors (a larger
        leaf alone), so that a collective's buffers stay near one such
        group beside the unit's whole tensors."""
        out, size = [], 0
        for i, s in enumerate(self.shards):
            whole = s.nbytes * self.comm.size
            same = out and s.dtype == self.shards[out[-1][-1]].dtype
            if same and size + whole <= BUCKET_BYTES:
                out[-1].append(i)
                size += whole
            else:
                out.append([i])
                size = whole
        return out

    def gather(self, register: bool) -> list:
        """All-gather the shards over ``comm``: one collective a bucket of
        the flattened shards, each leaf's whole tensor cut out of the rows
        and concatenated along its dim (a bucket of one leaf gathered along
        its dim straight into its whole tensor)."""
        n = self.comm.size
        wholes: list = [None] * len(self.shards)
        for idx in self.buckets():
            if len(idx) == 1:  # one leaf: gathered along its dim, into its whole tensor
                i = idx[0]
                wholes[i] = self.comm.all_gather(self.shards[i].detach(), self.dims[i])
                continue
            flat = torch.cat([self.shards[i].detach().reshape(-1) for i in idx])
            rows = self.comm.all_gather(flat[None], 0)  # [n, numel]
            del flat
            off = 0
            for i in idx:
                shard = self.shards[i]
                k = shard.numel()
                wholes[i] = torch.cat([rows[r, off:off + k].view(shard.shape) for r in range(n)],
                                      self.dims[i])
                off += k
            del rows
        fs = self.fs
        fs.stats["gathered_bytes"] += sum(w.nbytes for w in wholes)
        for i, w in enumerate(wholes):
            # a view's storage lives as long as its base (autograd may hand the
            # caller another tensor object over the same view)
            ref = weakref.ref(w if w._base is None else w._base)
            fs._live.append((id(self), ref))
            if register:
                fs._gathered[w.untyped_storage().data_ptr()] = (self, i, ref)
        fs.stats["peak_live"] = max(fs.stats["peak_live"], fs.live_units())
        return wholes

    def scatter(self, grads) -> list:
        """The whole tensors' gradients -> each shard's, reduce-scattered over
        ``comm`` (one collective a bucket; summed in rank order)."""
        n, rank = self.comm.size, self.comm.rank
        out: list = [None] * len(self.shards)
        for idx in self.buckets():
            dtype = self.shards[idx[0]].dtype
            # row r: piece r of every leaf's gradient, flattened (autograd
            # materialises an unused output's gradient as zeros); one leaf cut
            # along dim 0 is that already
            if len(idx) == 1 and self.dims[idx[0]] == 0:
                stacked = grads[idx[0]].reshape(n, -1)
                grads[idx[0]] = None
            else:
                stacked = torch.empty((n, sum(self.shards[i].numel() for i in idx)),
                                      dtype=dtype, device=grads[idx[0]].device)
                off = 0
                for i in idx:
                    shard = self.shards[i]
                    for r, p in enumerate(torch.chunk(grads[i], n, self.dims[i])):
                        stacked[r, off:off + shard.numel()].view(shard.shape).copy_(p)
                    off += shard.numel()
            if _LOCAL_SLICE_NOT_SCATTERED:
                mine = stacked[rank]
            else:
                mine = self.comm.reduce_scatter(stacked, 0)[0]
            off = 0
            for i in idx:
                k = self.shards[i].numel()
                out[i] = mine[off:off + k].view(self.shards[i].shape)
                off += k
        self.fs.stats["scatters"] += 1
        return out

    def whole(self, i: int) -> torch.Tensor:
        """Leaf i's whole tensor for the backward: the unit gathered again
        at its first use (the unit regathered before it dropped)."""
        fs = self.fs
        if self.regathered is None:
            prev = fs._current() if fs._current is not None else None
            if prev is not None and prev is not self:
                prev.regathered = None
            self.regathered = self.gather(register=False)
            fs.stats["regathers"] += 1
            fs._current = weakref.ref(self)
        return self.regathered[i]


class _Gather(torch.autograd.Function):
    """shards -> the whole tensors (all-gather over dp); the backward
    reduce-scatters their gradients back to the shards."""

    @staticmethod
    def forward(ctx, unit, *shards):
        ctx.unit = unit
        unit.fs.stats["gathers"] += 1
        return tuple(unit.gather(register=True))

    @staticmethod
    def backward(ctx, *grads):
        unit = ctx.unit
        unit.regathered = None  # the unit's backward is done
        return (None, *unit.scatter(list(grads)))


def step_counts(layers: int, m: int, first: bool, last: bool, remat: bool,
                head_saved: bool = True) -> dict:
    """``Fsdp.stats``' gathers, regathers and scatters of one training step
    on a rank of a pipeline stage (see the module docstring): ``layers``
    the stage's layers, ``m`` the microbatches, ``first`` / ``last`` the
    stage that gathers the embedding / the head. Without pp: the whole
    decoder's layers, m 1, first and last both True. head_saved: the head's
    product saves its gathered weight for the backward (so it is gathered
    again there): the f32 head of a bf16 weight does on CUDA (one GEMM into
    f32), not on the CPU, whose product widens the weight to f32 first and
    saves that copy."""
    e, h, units = int(first), int(last), layers * m
    return dict(gathers=(2 if remat else 1) * units + e + h,
                regathers=(h if head_saved else 0) + (0 if remat else units),
                scatters=units + e + h)


def _gather(shards: list, dims: list, fs: Fsdp) -> list:
    return list(_Gather.apply(_Unit(shards, dims, fs), *shards))


def embed_table(params) -> torch.Tensor:
    """The embedding table a lookup reads: ``params.embed``, or on an FSDP
    shard the rank's tp slice gathered over dp."""
    fs = params.fsdp
    return params.embed if fs is None else _gather([params.embed], [0], fs)[0]


def head_weight(params) -> torch.Tensor:
    """The head's [V(/tp), H] weight, gathered over dp on an FSDP shard."""
    fs, w = params.fsdp, params.lm_head.weight
    return w if fs is None else _gather([w], [0], fs)[0]


def _with(module, params: dict, modules: Optional[dict] = None):
    """A shallow copy of ``module`` whose parameters in ``params`` (and
    submodules in ``modules``) are replaced; tensors are set as they are,
    without wrapping them in nn.Parameter, so that they keep their
    autograd history."""
    new = copy.copy(module)
    new._parameters = {**module._parameters, **params}
    if modules:
        new._modules = {**module._modules, **modules}
    return new


def gathered_layer(layer, fs: Fsdp):
    """A view of decoder ``layer`` (an FSDP shard) whose norms and
    projection weights are the whole tensors (the rank's tp slices),
    gathered in one unit; biases and LoRA adapters are the shard's own."""
    names = ["input_norm", "post_attn_norm"] + [n for n in COLUMN + ROW
                                                if getattr(layer, n, None) is not None]
    shards = [getattr(layer, n) if "norm" in n else getattr(layer, n).weight for n in names]
    dims = [0 if "norm" in n or n in ROW else 1 for n in names]
    wholes = _gather(shards, dims, fs)
    norms = {n: w for n, w in zip(names, wholes) if "norm" in n}
    projs = {n: _with(getattr(layer, n), {"weight": w}) for n, w in zip(names, wholes)
             if "norm" not in n}
    return _with(layer, norms, projs)


def _packer(fs: Fsdp):
    def pack(t: torch.Tensor):
        try:
            key = t.untyped_storage().data_ptr()
        except (RuntimeError, NotImplementedError):
            return t
        hit = fs._gathered.get(key)
        if hit is None:
            return t
        unit, i, ref = hit
        if ref() is None:
            del fs._gathered[key]  # a freed tensor's address, reused
            return t
        return (unit, i, tuple(t.shape), t.stride(), t.storage_offset())

    return pack


def _unpack(x):
    if isinstance(x, tuple):
        unit, i, size, stride, offset = x
        return unit.whole(i).as_strided(size, stride, offset)
    return x


@contextlib.contextmanager
def streaming(params):
    """Around a forward that uses gathered units of ``params`` (a
    Qwen2Params; nothing when it is not FSDP-sharded): a saved gathered
    tensor is kept as a token and gathered again in the backward (see the
    module docstring)."""
    fs = params.fsdp
    if fs is None:
        yield
        return
    for key in [k for k, (_, _, r) in fs._gathered.items() if r() is None]:
        del fs._gathered[key]
    with torch.autograd.graph.saved_tensors_hooks(_packer(fs), _unpack):
        yield
