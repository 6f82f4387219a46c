"""Training loop: data pipeline -> train step -> checkpoints, on one GPU or
over a dp x pp x cp x tp x tq mesh of ranks.

Counterpart of long_vita_tpu/training/trainer.py. Kept from the JAX trainer: gradient accumulation over micro-batches,
the NaN tripwire (pretrain_long_vita.py:822-827), the straggler log, save
intervals, the final save, auto-resume from save_dir, LoRA training
(optim.lora_only: the base weights take gradients, which the global norm
counts, and a zero update), the remat levels, and the run's output_dir:
metrics.jsonl (a record per step), print_batch.log (the first batch decoded,
given a tokenizer), the torch.profiler trace over profile_steps, and, from
make_data_pipeline, data_report.json / data_samples.json / data_error.log.
make_data_pipeline is the JAX one: corpus YAML -> ChatML supervision ->
greedy packs -> batches -> a prefetch thread.

A mesh (``tcfg.mesh`` of dp x pp x cp x tp x tq ranks over ``comm``, a
parallel.comm communicator, or the torch.distributed group that
training/distributed.maybe_initialize starts): every rank builds the Trainer
with its own copy of the parameters (over tp > 1 the Trainer cuts its
shard, parallel/sharding.shard_params(own=True), unless it is handed one
already: train.build_from_recipe loads each rank's slices) and trains on
the same stream of whole batches, zigzag-permuted by batch_iterator for
ring attention (over the ring groups for hybrid, unpermuted for Ulysses,
JAX :83-116); each rank keeps its dp rows and cp sequence shard
(training/distributed.py; the tp ranks of one the same, the sequence-
parallel split happens inside the model), the loss and the gradients are
global (train_step.py), and world rank 0 writes the checkpoints (the JAX
package's orbax stores, training/checkpoint.py; over tp the gathered tree,
in the tp-1 format: a checkpoint resumes at any tp) and metrics.jsonl. With ``tcfg.fsdp`` over dp > 1 (ZeRO-3 weight streaming,
JAX trainer.py:74,144) each rank holds 1/dp of every decoder weight, its
gradient and its moments (shard_params(..., fsdp=True), or the slices
train.build_from_recipe loaded); checkpoints are gathered over dp and tp
into the same one-device format; at dp 1 FSDP is the plain step, as JAX's
mesh is None there. Over pp (JAX trainer.py:136-152) each rank holds its
stage's layers (shard_params(..., virtual_pp=), or the layers
train.build_from_recipe loaded), ``tcfg.virtual_pp`` chunks of them
chunk-major for the interleaved schedule, and every leaf outside the layer
stack whole; the pp ranks of one dp index take the same rows, the batch
splits into pp microbatches (JAX's ParallelConfig default), and checkpoints
gather the stages' layers back under their global names (the interleaved
schedule's stores are written chunk-major with (pp, virtual_pp) recorded, as
JAX writes them; where JAX refuses another (pp, virtual_pp) on restore, a
port run resumes a store at any pp and virtual_pp). Over tq (2-D tp, JAX's
tp2d layout) each rank holds its (tp, tq) block of every decoder weight
(shard_params, or the blocks train.build_from_recipe loaded); the tq ranks
of a (dp, cp) index take the same rows, and checkpoints gather over tq
too, into the same one-device format. A MoE model trains over every axis
but tq (JAX's rule): at dp > 1 its experts are cut over dp (expert
parallelism, shard_params) and its checkpoints gather them back into the
one-device format, so a run saved under EP resumes at dp 1 and the other
way round. FSDP composes with pp (JAX's text_param_specs(fsdp=True,
pp=True)): each rank holds 1/dp of its stage's layers and of the
embedding and the head, and its dp ranks stream them in the schedule's
order. Raising, with JAX's words: tq with pp, MoE or FSDP, a MoE model
whose experts dp does not divide; thread-ranks on CUDA
(train_step._check_mesh). The data modules, the metrics and the profiler
are imported inside the functions that use them, so a run that is handed
batches needs neither yaml nor PIL.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Iterator, Optional, Union

import numpy as np
import torch

from long_vita_tpu_torch.config import LongVITAConfig
from long_vita_tpu_torch.models.long_vita import LongVITAParams
from long_vita_tpu_torch.models.qwen2 import check_moe_mesh, check_remat
from long_vita_tpu_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    make_mesh,
    validate_geometry,
)
from long_vita_tpu_torch.parallel.sharding import shard_params
from long_vita_tpu_torch.parallel.zigzag import inverse_zigzag_permutation, zigzag_permute
from long_vita_tpu_torch.training.distributed import local_rows, make_global_batch
from long_vita_tpu_torch.training.loss import collate_packs, to_device
from long_vita_tpu_torch.training.optimizer import OptimizerConfig, make_optimizer
from long_vita_tpu_torch.training.train_step import (
    init_train_state,
    loss_terms,
    make_grad_accum_steps,
    make_parallel_config,
    make_train_step,
)
from long_vita_tpu_torch.utils.convert import set_requires_grad

logger = logging.getLogger(__name__)

__all__ = ["MeshConfig", "TrainerConfig", "Trainer", "batch_iterator", "make_data_pipeline"]


@dataclasses.dataclass
class TrainerConfig:
    seq_len: int = 16384
    logit_budget: int = 4096
    global_batch: int = 1
    micro_batch: int = 0  # rows per step; 0 = global_batch (no accumulation)
    steps: int = 100
    log_interval: int = 1
    save_interval: int = 0
    save_dir: Optional[str] = None
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    optim: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    remat: Union[bool, str] = True  # True/"full" | "dots" | "flash" | "vit" | False
    vision_chunk: int = 64  # ViT tile batch
    seed: int = 42  # corpus shuffle (make_data_pipeline); LoRA init (train.py)
    cp_algo: str = "ring"  # "ring" | "ulysses" | "hybrid"
    cp_inner: int = 1  # hybrid: ulysses lanes per ring group
    cp_window: int = 0  # double-ring window size (reference --cp-window-size)
    virtual_pp: int = 1  # interleaved-pipeline chunks per pp stage
    fsdp: bool = False  # ZeRO-3: decoder weights, gradients and moments cut over dp
    resume: bool = True  # auto-resume from save_dir's latest checkpoint
    straggler_threshold: float = 2.0  # warn when a step takes > thr x median
    output_dir: Optional[str] = None  # metrics.jsonl / print_batch.log / trace / data report
    profile_steps: Optional[tuple[int, int]] = None  # (start, stop) trace window
    allow_logit_drop: bool = False  # True: warn (not fail) when the logit
    # budget drops supervised rows — only for deliberately-sparse recipes


def batch_iterator(
    packs: Iterator, batch_size: int, logit_budget: int, cp: int = 1,
    cp_algo: str = "ring", cp_inner: int = 1, on_drop: str = "error",
) -> Iterator[dict]:
    """Group packs into collated numpy batches; zigzag-permute them for ring
    context parallelism (trainer.py:83): tokens, positions and segment ids
    permuted, logit positions and tile scatter rows mapped into the
    permuted sequence. Ulysses keeps contiguous shards; hybrid zigzags over
    the ring groups (cp // cp_inner)."""
    if cp_algo == "ulysses":
        cp = 1
    elif cp_algo == "hybrid":
        cp = cp // cp_inner
    buf = []
    inv = None
    for pack in packs:
        buf.append(pack)
        if len(buf) < batch_size:
            continue
        batch = collate_packs(buf, logit_budget, on_drop=on_drop)
        buf = []
        if cp > 1:
            if inv is None:
                inv = inverse_zigzag_permutation(batch["tokens"].shape[1], cp)
            for key in ("tokens", "positions", "segment_ids"):
                batch[key] = zigzag_permute(np.asarray(batch[key]), cp)
            batch["logit_positions"] = inv[batch["logit_positions"]]
            if batch.get("image_indices") is not None:
                idx = np.array(batch["image_indices"], copy=True)
                idx[1] = inv[idx[1]]
                batch["image_indices"] = idx
        yield batch


class Trainer:
    def __init__(self, params: LongVITAParams, cfg: LongVITAConfig, tcfg: TrainerConfig,
                 comm=None):
        """comm: the world communicator of a mesh of more than one rank
        (default: the initialized torch.distributed group), or the
        parallel.mesh.Mesh of tcfg.mesh over it. Over tp, tq or pp,
        ``params`` is the whole tree (this rank's shard is cut from it and
        the caller may drop it) or this rank's shard (its tp_comm set, over
        tq its tq_comm too; under FSDP cut over dp too, its fsdp set; over
        pp a stage's, its pp set)."""
        check_remat(tcfg.remat)
        check_moe_mesh(cfg.text, dp=tcfg.mesh.dp, cp=tcfg.mesh.cp, tp=tcfg.mesh.tp,
                       pp=tcfg.mesh.pp, tq=tcfg.mesh.tq)
        validate_geometry(cfg.text, tcfg.mesh, seq_len=tcfg.seq_len, virtual_pp=tcfg.virtual_pp,
                          fsdp=tcfg.fsdp)
        self.mesh = None
        if isinstance(comm, Mesh):
            if comm.cfg != tcfg.mesh:
                raise ValueError(f"the mesh {comm.cfg} is not the recipe's {tcfg.mesh}")
            self.mesh = comm
        elif tcfg.mesh.size > 1:
            if comm is None:
                import torch.distributed as dist

                from long_vita_tpu_torch.parallel.comm import DistComm

                if not (dist.is_available() and dist.is_initialized()):
                    raise ValueError(
                        f"a mesh of {tcfg.mesh.size} ranks needs comm= or an initialized "
                        "torch.distributed group (training/distributed.maybe_initialize)"
                    )
                comm = DistComm()
            self.mesh = make_mesh(tcfg.mesh, comm)
        fsdp = tcfg.fsdp and tcfg.mesh.dp > 1
        staged = tcfg.mesh.pp > 1
        ep = cfg.text.num_experts > 0 and tcfg.mesh.dp > 1
        if (tcfg.mesh.tp > 1 and params.text.tp_comm is None) or (
                tcfg.mesh.tq > 1 and params.text.tq_comm is None) or (
                fsdp and params.text.fsdp is None) or (staged and params.text.pp is None) or (
                ep and params.text.ep_comm is None):
            if params.text.tp_comm is not None:
                raise ValueError("FSDP and pp cut a whole tree (or load its slices, "
                                 "train.build_from_recipe); this one is a tp shard")
            params = shard_params(params, self.mesh, cfg, own=True, fsdp=fsdp,
                                  virtual_pp=tcfg.virtual_pp)
        if staged and params.text.pp.virtual != tcfg.virtual_pp:
            raise ValueError(f"the stage's tree holds {params.text.pp.virtual} chunks, the "
                             f"recipe's virtual_pp is {tcfg.virtual_pp}")
        self.cfg, self.tcfg = cfg, tcfg
        self.checkpoint_bytes: Optional[int] = None  # train.build_from_recipe's loader count
        self.tx = make_optimizer(
            params, tcfg.optim,
            num_vit_layers=cfg.vision.num_hidden_layers if cfg.vision else 0,
        )
        # lora_only freezes the base weights through the optimizer's mask, not
        # by stopping their gradient: the adapters inside the text tree must
        # take theirs (the JAX trainer's freeze_text rule, :186-194)
        self.freeze = dict(
            freeze_vision=tcfg.optim.freeze_vision,
            freeze_text=tcfg.optim.freeze_text and not tcfg.optim.lora_only,
        )
        set_requires_grad(params, **self.freeze)
        self.state = init_train_state(params, self.tx)
        self.device = next(params.parameters()).device
        self.start_step = 0
        if tcfg.resume and tcfg.save_dir:
            from long_vita_tpu_torch.training.checkpoint import latest_step, load_checkpoint

            step = latest_step(tcfg.save_dir)
            if step is not None:
                logger.info("resuming from %s step %d", tcfg.save_dir, step)
                self.state = load_checkpoint(tcfg.save_dir, self.state,
                                             layout=self._layout())
                self.start_step = step
        self.accum = 1
        if tcfg.micro_batch and tcfg.micro_batch < tcfg.global_batch:
            if tcfg.global_batch % tcfg.micro_batch:
                raise ValueError(
                    f"global_batch {tcfg.global_batch} % micro_batch {tcfg.micro_batch} != 0"
                )
            self.accum = tcfg.global_batch // tcfg.micro_batch
        self.cp_kw = dict(cp_algo=tcfg.cp_algo, cp_inner=tcfg.cp_inner, cp_window=tcfg.cp_window)
        step_kw = dict(remat=tcfg.remat, vision_chunk=tcfg.vision_chunk, **self.freeze,
                       **self.cp_kw)
        if self.accum > 1:
            self.grad_fn, self.accum_fn, self.apply_fn = make_grad_accum_steps(
                cfg, self.tx, self.mesh, **step_kw
            )
            self.step_fn = None
        else:
            self.step_fn = make_train_step(cfg, self.tx, self.mesh, **step_kw)

    def _device_batch(self, batch: dict) -> dict:
        """A whole numpy batch -> this rank's tensors (its dp rows and cp
        sequence shard on a mesh)."""
        if self.mesh is None:
            return to_device(batch, self.device)
        rows = np.asarray(batch["tokens"]).shape[0]
        return make_global_batch(local_rows(batch, self.mesh, rows), self.mesh, self.device)

    def _layout(self):
        """The tp, FSDP and pp layout of this rank's parameters, or None for
        a whole tree."""
        if self.mesh is None:
            return None
        from long_vita_tpu_torch.parallel.sharding import rank_layout

        return rank_layout(self.state.params, self.cfg, self.mesh)

    def _save(self, save_checkpoint) -> None:
        """World rank 0 writes (every rank holds the same parameters; over
        tp and tq, under FSDP or expert parallelism and over pp the ranks of
        its cp index (and dp index without FSDP or EP) gather the tree and
        its moments for it first)."""
        if self.mesh is None:
            save_checkpoint(self.tcfg.save_dir, self.state)
            return
        layout, mesh = self._layout(), self.mesh
        text = self.state.params.text
        over_dp = text.fsdp is not None or text.ep_comm is not None
        # cp index 0 gathers: over tp the tp group of world rank 0, under
        # FSDP and expert parallelism its dp groups too
        if mesh.world.rank == 0 or (layout is not None and mesh.cp_index == 0
                                    and (over_dp or mesh.dp_index == 0)):
            save_checkpoint(self.tcfg.save_dir, self.state, layout=layout,
                            tp_comm=mesh.tp_comm, dp_comm=mesh.dp_comm if over_dp else None,
                            write=mesh.world.rank == 0, tq_comm=mesh.tq_comm)
        mesh.world.barrier()

    @torch.no_grad()
    def evaluate(self, batches: Iterator[dict], max_steps: int = 0) -> dict:
        """Mean loss over a validation stream, weighted by supervised rows
        (no remat, the tower's default attention, as the JAX evaluate)."""
        parallel = make_parallel_config(self.mesh, **self.cp_kw)
        total, count = 0.0, 0.0
        for step, batch in enumerate(batches):
            if max_steps and step >= max_steps:
                break
            loss_sum, tokens, _ = loss_terms(
                self.state.params, self._device_batch(batch), self.cfg, False,
                self.tcfg.vision_chunk, parallel=parallel,
            )
            if self.mesh is not None:  # the tp ranks of a cp shard agree on its rows;
                # of a pipeline's stages the last alone counts them
                loss_sum, tokens = self.mesh.dp_pp_cp_comm.all_reduce_sum(
                    torch.stack([loss_sum.float(), tokens.float()]))
            total += float(loss_sum)
            count += float(tokens)
        return {"loss": total / max(count, 1.0), "tokens": count}

    def train(self, batches: Iterator[dict], tokenizer=None) -> dict:
        """Run steps start_step .. tcfg.steps - 1 over ``batches`` (numpy
        batch dicts). With output_dir: a metrics.jsonl record per step
        (loss, grad_norm, supervised_tokens, step_time_s), the first batch
        decoded into print_batch.log when a tokenizer is given, and the
        profiler's trace over profile_steps. -> {"losses": [the loss of
        every step run]}."""
        from long_vita_tpu_torch.training.checkpoint import save_checkpoint

        tcfg = self.tcfg
        history: list[float] = []
        step_times: list[float] = []
        metrics_log = profiler = None
        # on a mesh, world rank 0 writes the run's output directory
        writes = tcfg.output_dir and (self.mesh is None or self.mesh.world.rank == 0)
        first_batch_dumped = not writes
        with contextlib.ExitStack() as closing:  # the metrics file and the trace, also on a raise
            if writes:
                from long_vita_tpu_torch.utils.metrics import MetricsLogger, Profiler

                metrics_log = MetricsLogger(tcfg.output_dir)
                closing.callback(metrics_log.close)
                if tcfg.profile_steps:
                    profiler = Profiler(tcfg.output_dir, *tcfg.profile_steps)
                    closing.callback(profiler.close)
            t_last = time.time()
            batches = iter(batches)
            for step in range(self.start_step, tcfg.steps):
                micros = []
                for _ in range(self.accum):
                    nxt = next(batches, None)
                    if nxt is None:
                        break
                    micros.append(nxt)
                if len(micros) < self.accum:
                    break  # stream exhausted mid-accumulation window
                if profiler:
                    profiler.step(step)
                if not first_batch_dumped and tcfg.output_dir and tokenizer:
                    from long_vita_tpu_torch.data.observability import dump_first_batch

                    dump_first_batch(tcfg.output_dir, micros[0], tokenizer)
                    first_batch_dumped = True
                if self.accum == 1:
                    self.state, metrics = self.step_fn(self.state, self._device_batch(micros[0]))
                else:
                    grads = loss_sum = count_sum = None
                    for mb in micros:
                        g, loss_mb, count_mb = self.grad_fn(self.state.params,
                                                            self._device_batch(mb))
                        if grads is None:
                            grads, loss_sum, count_sum = g, loss_mb, count_mb
                        else:
                            grads = self.accum_fn(grads, g)
                            loss_sum = loss_sum + loss_mb
                            count_sum = count_sum + count_mb
                    self.state, metrics = self.apply_fn(
                        self.state, grads, loss_sum, count_sum, float(self.accum)
                    )
                loss = float(metrics["loss"])
                if not np.isfinite(loss):  # reference NaN tripwire
                    raise FloatingPointError(f"non-finite loss at step {step}")
                dt = time.time() - t_last
                t_last = time.time()
                step_times.append(dt)
                if len(step_times) > 4:
                    recent = sorted(step_times[-64:])
                    median = recent[len(recent) // 2]
                    if dt > tcfg.straggler_threshold * median:
                        logger.warning("straggler step %d: %.2fs (median %.2fs)", step, dt, median)
                if step % tcfg.log_interval == 0:
                    logger.info(
                        "step %d | loss %.4f | grad_norm %.3f | %.1f supervised tok | %.2fs/step",
                        step, loss, float(metrics["grad_norm"]), float(metrics["tokens"]), dt,
                    )
                if metrics_log:
                    metrics_log.log(
                        step, loss=loss, grad_norm=float(metrics["grad_norm"]),
                        supervised_tokens=float(metrics["tokens"]), step_time_s=round(dt, 4),
                    )
                history.append(loss)
                if tcfg.save_interval and tcfg.save_dir and (step + 1) % tcfg.save_interval == 0:
                    self._save(save_checkpoint)
            if tcfg.save_dir:
                self._save(save_checkpoint)
        return {"losses": history}


def make_data_pipeline(
    corpus_yaml: str,
    mm,
    tcfg: TrainerConfig,
    pad_token_id: int,
    default_system_message: Optional[str] = None,
    cross_dataset_joint: bool = False,
) -> Iterator[dict]:
    """Corpus YAML -> ChatML supervision (``mm``, a data.multimodal
    MultimodalTokenizer) -> greedy packs of seq_len -> batches of
    micro_batch (or global_batch) rows with the logit budget -> a prefetch
    thread two batches ahead (trainer.py:354). With output_dir, a
    DataReport records what was packed and skipped."""
    from long_vita_tpu_torch.data.dataset import ChatMLSupervision, PackedDataset, load_corpus
    from long_vita_tpu_torch.data.prefetch import prefetch

    samples = load_corpus(corpus_yaml, seed=tcfg.seed)
    supervision = ChatMLSupervision(mm, default_system_message)
    report = None
    if tcfg.output_dir:
        from long_vita_tpu_torch.data.observability import DataReport

        report = DataReport(tcfg.output_dir, tokenizer=mm.tokenizer)
    packs = PackedDataset(
        samples, supervision, tcfg.seq_len, pad_token_id,
        cross_dataset_joint=cross_dataset_joint, report=report,
    )
    rows = tcfg.micro_batch or tcfg.global_batch
    it = batch_iterator(
        iter(packs), rows, tcfg.logit_budget, tcfg.mesh.cp, tcfg.cp_algo, tcfg.cp_inner,
        on_drop="warn" if tcfg.allow_logit_drop else "error",
    )
    return prefetch(it, depth=2)
