"""The (dp, pp, cp, tp, tq) mesh of ranks.

Counterpart of long_vita_tpu/parallel/mesh.py: ``MeshConfig`` (:41),
``make_mesh`` (:60) and ``validate_geometry`` (:84). Where JAX names the
axes of one device array and shard_map (or GSPMD) hands a body its axis,
the port's mesh is a grid of ranks over a world communicator with one
communicator per axis. A rank's coordinates follow JAX's ``np.reshape(
devices, (dp, pp, cp, tp, tq))`` (:78-80): rank = (((d * pp + p) * cp + c)
* tp + t) * tq + q, dp outermost and tq innermost. The dp, cp and tp axes
run for serving and for training (FSDP over dp too, inside pipeline stages
as well); tq (2-D tensor parallelism, the second factor of tp) runs for
both, and pp for training alone, as in the JAX package, whose engine
serves no pipeline.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from long_vita_tpu_torch.parallel.comm import Comm, LocalComm

AXIS_DP, AXIS_PP, AXIS_CP, AXIS_TP, AXIS_TQ = "dp", "pp", "cp", "tp", "tq"
AXES = (AXIS_DP, AXIS_PP, AXIS_CP, AXIS_TP, AXIS_TQ)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    pp: int = 1
    cp: int = 1
    tp: int = 1
    tq: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.cp * self.tp * self.tq


class Mesh:
    """Ranks of ``comm`` (the world) as a dp x pp x cp x tp x tq grid, with
    one communicator per axis: ``tp_comm`` joins the ranks of one (dp, pp,
    cp, tq) index, ``tq_comm`` those of one (dp, pp, cp, tp) index (2-D
    tp's contractions over the hidden dim), ``cp_comm`` those of one (dp,
    pp, tp, tq) index, ``dp_comm`` those of one (pp, cp, tp, tq) index,
    ``pp_comm`` those of one (dp, cp, tp, tq) index (the stages a
    microbatch passes through), ``replica_comm`` the cp x tp x tq ranks of
    one (dp, pp) index (the ranks that hold the same requests or batch rows
    and the same layers), ``dp_cp_comm`` the dp x cp ranks of one (pp, tp,
    tq) index (the ranks that hold the same tp (and tq) shard of a stage's
    layers: a sharded layer's gradient is summed over them), ``stage_comm``
    the dp x cp x tp x tq ranks of one pp index (the world without pp) and
    ``dp_pp_cp_comm`` the dp x pp x cp ranks of one (tp, tq) index (the
    ranks that hold the same shard of a leaf replicated over pp, the
    embedding's and the head's, and share the loss). An axis of size 1
    gets a LocalComm, and a group of every rank the world itself; at tq 1
    every group has the members it had before the tq axis. ``shape`` maps
    each axis name to its size, as a JAX mesh's does."""

    def __init__(self, cfg: MeshConfig, comm: Comm):
        if cfg.size != comm.size:
            raise ValueError(f"mesh {cfg} needs {cfg.size} ranks, the communicator has {comm.size}")
        self.cfg, self.world = cfg, comm
        dp, pp, cp, tp, tq = cfg.dp, cfg.pp, cfg.cp, cfg.tp, cfg.tq

        def rank(d, p, c, t, q):
            return (((d * pp + p) * cp + c) * tp + t) * tq + q

        self._coords = list(itertools.product(range(dp), range(pp), range(cp), range(tp),
                                              range(tq)))
        self.dp_index, rest = divmod(comm.rank, pp * cp * tp * tq)
        self.pp_index, rest = divmod(rest, cp * tp * tq)
        self.cp_index, rest = divmod(rest, tp * tq)
        self.tp_index, self.tq_index = divmod(rest, tq)
        self._rank = rank
        self._over: dict = {}
        self.tp_comm = self.over(AXIS_TP)
        self.tq_comm = self.over(AXIS_TQ)
        self.cp_comm = self.over(AXIS_CP)
        self.dp_comm = self.over(AXIS_DP)
        self.pp_comm = self.over(AXIS_PP)
        self.replica_comm = self.over(AXIS_CP, AXIS_TP, AXIS_TQ)
        self.dp_cp_comm = self.over(AXIS_DP, AXIS_CP)
        self.stage_comm = self.over(AXIS_DP, AXIS_CP, AXIS_TP, AXIS_TQ)
        self.dp_pp_cp_comm = self.dp_cp_comm if pp == 1 else self.over(AXIS_DP, AXIS_PP, AXIS_CP)
        self.shape = {AXIS_DP: dp, AXIS_PP: pp, AXIS_CP: cp, AXIS_TP: tp, AXIS_TQ: tq}
        self._shared: dict = {}

    def over(self, *axes: str) -> Comm:
        """The communicator of the ranks that differ only in ``axes`` (one
        group, in rank order, for each index of the other axes). The axes'
        communicators above are made with the mesh; another set of axes on
        its first call (every rank calls it at the same point)."""
        key = tuple(sorted(AXES.index(a) for a in axes))
        if key not in self._over:
            out: dict = {}
            for c in self._coords:
                out.setdefault(tuple(v for i, v in enumerate(c) if i not in key), []).append(
                    self._rank(*c))
            self._over[key] = self._axis(list(out.values()))
        return self._over[key]

    def shared_comm(self, share: int, over_dp: bool = True) -> Comm:
        """The ranks that hold the same slice when ``share`` consecutive tp
        ranks share it (a kv head replicated over tp // Hkv ranks): tp
        indices t with the same t // share, over every dp and cp index of
        one (pp, tq) index (of this rank's dp index alone with over_dp
        False: an FSDP shard, whose gradient is reduce-scattered over dp
        first). A gradient of such a slice is summed over them. Made on the
        first call (every rank calls it at the same point)."""
        key = (share, over_dp)
        if key not in self._shared:
            dp, pp, cp, tp, tq = (self.cfg.dp, self.cfg.pp, self.cfg.cp, self.cfg.tp,
                                  self.cfg.tq)
            dps = [[d] for d in range(dp)] if not over_dp else [list(range(dp))]
            self._shared[key] = self._axis([
                [self._rank(d, p, c, t, q) for d in ds for c in range(cp)
                 for t in range(j * share, (j + 1) * share)]
                for p in range(pp) for ds in dps for j in range(tp // share) for q in range(tq)])
        return self._shared[key]

    def _axis(self, groups: list) -> Comm:
        if len(groups[0]) == 1:
            return LocalComm()
        if len(groups) == 1:
            return self.world
        return self.world.split(groups)

    @property
    def size(self) -> int:
        return self.cfg.size


def make_mesh(cfg: Optional[MeshConfig] = None, comm: Optional[Comm] = None) -> Mesh:
    """The mesh of ``cfg`` over ``comm`` (one LocalComm rank by default).
    With no config every rank becomes cp, the long-context default."""
    comm = comm if comm is not None else LocalComm()
    if cfg is None:
        cfg = MeshConfig(cp=comm.size)
    return Mesh(cfg, comm)


def validate_geometry(text_cfg, mesh_cfg: MeshConfig, seq_len: int = 0,
                      virtual_pp: int = 1, fsdp: bool = False) -> None:
    """Fail fast when a model geometry cannot shard over a mesh (JAX :84,
    the same checks and messages). A sequence that does not split into cp
    x tp equal slices is no refusal: JAX's GSPMD pads its [B@dp, S@(cp,
    tp), H] layout (long_vita.py:268-301), and the port's sequence-parallel
    layout pads the last tp slices with zero rows (models/qwen2.py); at the
    tiny configuration's 2 kv heads over tp 4 JAX raises for any sequence,
    its attention cutting the kv heads over tp. A logit budget that does
    not divide over cp is no refusal: JAX takes its plain head and CE there
    (train_step.py:75-84), the port its vocab-parallel CE over each cp
    shard's budget rows, however many (the same loss and gradients).
    fsdp (over dp > 1): every dim FSDP cuts splits into dp equal pieces,
    the hidden dim (the column kernels' input, the row kernels' output,
    the norms) and the vocabulary into tp x dp pieces (the embedding and
    the head); JAX's device_put of such a dim raises too ("should be
    divisible by"; sharding.shard_params). tq > 1
    (2-D tp): the hidden dim splits over tq, and neither pp, MoE nor FSDP
    composes with it (JAX :122-130 and sharding.py:62-63, their words). A
    MoE model at dp > 1 cuts its experts over dp (expert parallelism):
    dp divides the expert count (JAX's device_put fails otherwise)."""
    errs = []
    tp, pp, cp = mesh_cfg.tp, mesh_cfg.pp, mesh_cfg.cp
    if text_cfg.num_attention_heads % tp:
        errs.append(f"attention heads {text_cfg.num_attention_heads} % tp {tp} != 0")
    if text_cfg.num_key_value_heads % tp and tp % text_cfg.num_key_value_heads:
        errs.append(
            f"kv heads {text_cfg.num_key_value_heads} incompatible with tp "
            f"{tp} (need kv%tp==0 or tp%kv==0)"
        )
    if text_cfg.vocab_size % tp:
        errs.append(f"vocab {text_cfg.vocab_size} % tp {tp} != 0")
    if text_cfg.intermediate_size % tp:
        errs.append(f"intermediate {text_cfg.intermediate_size} % tp {tp} != 0")
    if text_cfg.num_hidden_layers % (pp * max(virtual_pp, 1)):
        errs.append(
            f"layers {text_cfg.num_hidden_layers} % (pp {pp} * virtual_pp {virtual_pp}) != 0"
        )
    if pp > 1 and cp > 1:
        errs.append("pp and cp are mutually exclusive (pipeline runs cp=1)")
    if seq_len and cp > 1 and seq_len % (2 * cp):
        errs.append(f"seq_len {seq_len} % 2*cp {2 * cp} != 0 (zigzag needs 2cp equal chunks)")
    dp = mesh_cfg.dp
    experts = getattr(text_cfg, "num_experts", 0)
    if experts > 0 and dp > 1 and experts % dp:
        errs.append(f"experts {experts} % dp {dp} != 0 (expert parallelism cuts the expert "
                    "dim over dp)")
    if fsdp and dp > 1:
        if text_cfg.hidden_size % dp:
            errs.append(f"hidden {text_cfg.hidden_size} % dp {dp} != 0 (FSDP cuts the hidden "
                        "dim over dp: the column kernels' input, the row kernels' output, the "
                        "norms)")
        if text_cfg.vocab_size % (tp * dp):
            errs.append(f"vocab {text_cfg.vocab_size} % tp*dp {tp * dp} != 0 (FSDP cuts the "
                        "embedding's and the head's vocabulary into tp x dp pieces)")
    if mesh_cfg.tq > 1:
        if text_cfg.hidden_size % mesh_cfg.tq:
            errs.append(f"hidden {text_cfg.hidden_size} % tq {mesh_cfg.tq} != 0")
        if pp > 1:
            errs.append("2-D TP (tq > 1) does not compose with pp")
        if getattr(text_cfg, "num_experts", 0) > 0:
            errs.append("2-D TP (tq > 1) does not compose with MoE/EP")
        if fsdp:  # JAX's text_param_specs (sharding.py:62-63)
            errs.append("tp2d composes with neither fsdp nor MoE")
    if errs:
        raise ValueError(f"model geometry cannot shard over mesh {mesh_cfg}: " + "; ".join(errs))
