"""Training loop on one GPU: packed batches -> train step -> checkpoints.

Counterpart of long_vita_tpu/training/trainer.py for a single device (cp = 1,
no mesh). Kept from the JAX trainer: gradient accumulation over micro-batches,
the NaN tripwire (pretrain_long_vita.py:822-827), the straggler log, save
intervals, the final save and auto-resume from save_dir. Raising, each with
its ROADMAP item: a mesh of more than one device (multi-GPU), output_dir
(metrics file, first-batch dump and profiler), LoRA (lora_only), and the
YAML recipe entry of training/train.py, which needs released weights and a
tokenizer the repository does not hold.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Iterator, Optional, Union

import numpy as np
import torch

from long_vita_tpu_torch.config import LongVITAConfig
from long_vita_tpu_torch.models.long_vita import LongVITAParams
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
    remat: Union[bool, str] = True  # True/"full" | False
    vision_chunk: int = 64  # ViT tile batch
    resume: bool = True  # auto-resume from save_dir's latest checkpoint
    straggler_threshold: float = 2.0  # warn when a step takes > thr x median
    output_dir: Optional[str] = None  # not ported: raises


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
        if tcfg.mesh.size > 1:
            raise NotImplementedError(
                f"a {tcfg.mesh.size}-device mesh: the port trains on one GPU "
                "(ROADMAP: port queue, multi-GPU)"
            )
        if tcfg.output_dir:
            raise NotImplementedError(
                "output_dir (metrics file, first-batch dump, profiler) is not "
                "ported (ROADMAP: port queue, training: trainer output)"
            )
        if tcfg.optim.lora_only:
            raise NotImplementedError(
                "LoRA training is not ported (ROADMAP: port queue, training: lora.py)"
            )
        self.cfg, self.tcfg = cfg, tcfg
        self.tx = make_optimizer(
            params, tcfg.optim,
            num_vit_layers=cfg.vision.num_hidden_layers if cfg.vision else 0,
        )
        self.freeze = dict(
            freeze_vision=tcfg.optim.freeze_vision, freeze_text=tcfg.optim.freeze_text
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

    def train(self, batches: Iterator[dict]) -> dict:
        """Run steps start_step .. tcfg.steps - 1 over ``batches`` (numpy
        batch dicts). -> {"losses": [the loss of every step run]}."""
        from long_vita_tpu_torch.training.checkpoint import save_checkpoint

        tcfg = self.tcfg
        history: list[float] = []
        step_times: list[float] = []
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
            history.append(loss)
            if tcfg.save_interval and tcfg.save_dir and (step + 1) % tcfg.save_interval == 0:
                save_checkpoint(tcfg.save_dir, self.state)
        if tcfg.save_dir:
            save_checkpoint(tcfg.save_dir, self.state)
        return {"losses": history}
