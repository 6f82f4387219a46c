"""Training loop on one GPU: data pipeline -> train step -> checkpoints.

Counterpart of long_vita_tpu/training/trainer.py for a single device (cp = 1,
no mesh). Kept from the JAX trainer: gradient accumulation over micro-batches,
the NaN tripwire (pretrain_long_vita.py:822-827), the straggler log, save
intervals, the final save, auto-resume from save_dir, LoRA training
(optim.lora_only: the base weights take gradients, which the global norm
counts, and a zero update), the remat levels, and the run's output_dir:
metrics.jsonl (a record per step), print_batch.log (the first batch decoded,
given a tokenizer), the torch.profiler trace over profile_steps, and, from
make_data_pipeline, data_report.json / data_samples.json / data_error.log.
make_data_pipeline is the JAX one: corpus YAML -> ChatML supervision ->
greedy packs -> batches -> a prefetch thread.

Raising, with their ROADMAP item (port queue, multi-GPU): a mesh of more
than one device (context parallelism included: the JAX recipe's cp_algo,
cp_inner and cp_window act only there, and the port does not take them),
virtual pipeline stages and FSDP. The data modules, the metrics and
the profiler are imported inside the functions that use them, so a run that
is handed batches needs neither yaml nor PIL.
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
from long_vita_tpu_torch.models.qwen2 import check_remat
from long_vita_tpu_torch.training.loss import collate_packs, to_device
from long_vita_tpu_torch.training.optimizer import OptimizerConfig, make_optimizer
from long_vita_tpu_torch.training.train_step import (
    init_train_state,
    loss_fn,
    make_grad_accum_steps,
    make_train_step,
)
from long_vita_tpu_torch.utils.convert import set_requires_grad

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class MeshConfig:
    """The JAX package's mesh geometry (parallel/mesh.py:41); the port runs
    the one-device geometry only."""

    dp: int = 1
    pp: int = 1
    cp: int = 1
    tp: int = 1
    tq: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.cp * self.tp * self.tq


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
    virtual_pp: int = 1  # interleaved-pipeline chunks per pp stage (multi-GPU)
    fsdp: bool = False  # shard layer stacks over dp (multi-GPU)
    resume: bool = True  # auto-resume from save_dir's latest checkpoint
    straggler_threshold: float = 2.0  # warn when a step takes > thr x median
    output_dir: Optional[str] = None  # metrics.jsonl / print_batch.log / trace / data report
    profile_steps: Optional[tuple[int, int]] = None  # (start, stop) trace window
    allow_logit_drop: bool = False  # True: warn (not fail) when the logit
    # budget drops supervised rows — only for deliberately-sparse recipes


def batch_iterator(
    packs: Iterator, batch_size: int, logit_budget: int, cp: int = 1,
    on_drop: str = "error",
) -> Iterator[dict]:
    """Group packs into collated numpy batches (trainer.py:83, cp = 1)."""
    if cp > 1:
        raise NotImplementedError(
            "context parallelism (zigzag batches) is not ported "
            "(ROADMAP: port queue, multi-GPU)"
        )
    buf = []
    for pack in packs:
        buf.append(pack)
        if len(buf) == batch_size:
            yield collate_packs(buf, logit_budget, on_drop=on_drop)
            buf = []


class Trainer:
    def __init__(self, params: LongVITAParams, cfg: LongVITAConfig, tcfg: TrainerConfig):
        unported = {
            f"a {tcfg.mesh.size}-device mesh": tcfg.mesh.size > 1,
            f"{tcfg.virtual_pp} virtual pipeline stages": tcfg.virtual_pp > 1,
            "FSDP": tcfg.fsdp,
        }
        for what, asked in unported.items():
            if asked:
                raise NotImplementedError(
                    f"{what}: the port trains on one GPU (ROADMAP: port queue, multi-GPU)"
                )
        check_remat(tcfg.remat)
        self.cfg, self.tcfg = cfg, tcfg
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
                self.state = load_checkpoint(tcfg.save_dir, self.state)
                self.start_step = step
        self.accum = 1
        if tcfg.micro_batch and tcfg.micro_batch < tcfg.global_batch:
            if tcfg.global_batch % tcfg.micro_batch:
                raise ValueError(
                    f"global_batch {tcfg.global_batch} % micro_batch {tcfg.micro_batch} != 0"
                )
            self.accum = tcfg.global_batch // tcfg.micro_batch
        step_kw = dict(remat=tcfg.remat, vision_chunk=tcfg.vision_chunk, **self.freeze)
        if self.accum > 1:
            self.grad_fn, self.accum_fn, self.apply_fn = make_grad_accum_steps(
                cfg, self.tx, **step_kw
            )
            self.step_fn = None
        else:
            self.step_fn = make_train_step(cfg, self.tx, **step_kw)

    @torch.no_grad()
    def evaluate(self, batches: Iterator[dict], max_steps: int = 0) -> dict:
        """Mean loss over a validation stream, weighted by supervised rows
        (no remat, the tower's default attention, as the JAX evaluate)."""
        total, count = 0.0, 0.0
        for step, batch in enumerate(batches):
            if max_steps and step >= max_steps:
                break
            loss, tokens = loss_fn(
                self.state.params, to_device(batch, self.device), self.cfg, False,
                self.tcfg.vision_chunk,
            )
            total += float(loss) * float(tokens)
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
        first_batch_dumped = False
        with contextlib.ExitStack() as closing:  # the metrics file and the trace, also on a raise
            if tcfg.output_dir:
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
                    self.state, metrics = self.step_fn(
                        self.state, to_device(micros[0], self.device)
                    )
                else:
                    grads = loss_sum = count_sum = None
                    for mb in micros:
                        g, loss_mb, count_mb = self.grad_fn(
                            self.state.params, to_device(mb, self.device)
                        )
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
                    save_checkpoint(tcfg.save_dir, self.state)
            if tcfg.save_dir:
                save_checkpoint(tcfg.save_dir, self.state)
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
        iter(packs), rows, tcfg.logit_budget, tcfg.mesh.cp,
        on_drop="warn" if tcfg.allow_logit_drop else "error",
    )
    return prefetch(it, depth=2)
