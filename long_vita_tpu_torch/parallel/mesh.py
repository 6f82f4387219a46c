"""The (dp, cp, tp) mesh of ranks.

Counterpart of long_vita_tpu/parallel/mesh.py: ``MeshConfig`` (:41),
``make_mesh`` (:60) and ``validate_geometry`` (:84). Where JAX names the
axes of one device array and shard_map hands a body its axis, the port's
mesh is a grid of ranks over a world communicator with one communicator per
axis: rank = ((d * pp + p) * cp + c) * tp * tq + ..., dp outermost, as JAX
reshapes its device list. The dp and cp axes run; tp > 1, pp > 1 and tq > 1
raise, naming the ROADMAP items that port them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from long_vita_tpu_torch.parallel.comm import Comm, LocalComm

AXIS_DP, AXIS_PP, AXIS_CP, AXIS_TP, AXIS_TQ = "dp", "pp", "cp", "tp", "tq"
AXES = (AXIS_DP, AXIS_PP, AXIS_CP, AXIS_TP, AXIS_TQ)

NEXT_SLICE = ("is not ported yet (ROADMAP §1: tensor parallelism, FSDP, and pipeline "
              "stages with expert parallelism, the multi-GPU items after context "
              "parallelism)")


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
    """Ranks of ``comm`` (the world) as a dp x cp grid: ``dp_comm`` joins the
    ranks of one cp index across replicas, ``cp_comm`` the ranks of one
    replica (dp index). ``shape`` maps each axis name to its size, as a JAX
    mesh's does."""

    def __init__(self, cfg: MeshConfig, comm: Comm):
        for name, n in (("tp", cfg.tp), ("pp", cfg.pp), ("tq", cfg.tq)):
            if n > 1:
                raise NotImplementedError(f"mesh axis {name} = {n} {NEXT_SLICE}")
        if cfg.size != comm.size:
            raise ValueError(f"mesh {cfg} needs {cfg.size} ranks, the communicator has {comm.size}")
        self.cfg, self.world = cfg, comm
        dp, cp = cfg.dp, cfg.cp
        self.dp_index, self.cp_index = divmod(comm.rank, cp)
        self.cp_comm = (comm.split([[d * cp + c for c in range(cp)] for d in range(dp)])
                        if cp > 1 else LocalComm())
        self.dp_comm = (comm.split([[d * cp + c for d in range(dp)] for c in range(cp)])
                        if dp > 1 else LocalComm())
        self.shape = {AXIS_DP: dp, AXIS_PP: 1, AXIS_CP: cp, AXIS_TP: 1, AXIS_TQ: 1}

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
                      virtual_pp: int = 1) -> None:
    """Fail fast when a model geometry cannot shard over a mesh (JAX :84,
    the same checks and messages)."""
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
    if mesh_cfg.tq > 1:
        if text_cfg.hidden_size % mesh_cfg.tq:
            errs.append(f"hidden {text_cfg.hidden_size} % tq {mesh_cfg.tq} != 0")
        if pp > 1:
            errs.append("2-D TP (tq > 1) does not compose with pp")
        if getattr(text_cfg, "num_experts", 0) > 0:
            errs.append("2-D TP (tq > 1) does not compose with MoE/EP")
    if errs:
        raise ValueError(f"model geometry cannot shard over mesh {mesh_cfg}: " + "; ".join(errs))
