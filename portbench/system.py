"""The system under test: the one module of the benchmark that imports the
PyTorch port (``long_vita_tpu_torch``). It builds the port's parameters and
copies the benchmark's weights into them by name, and builds the serving
scheduler and the trainer the way the port's own entry points do; the rest
of the benchmark only drives what these return."""
from __future__ import annotations

import dataclasses

import torch

from portbench import weights as W


def config(cfg: dict):
    """The port's configuration object for a configuration file."""
    from long_vita_tpu_torch.config import LongVITAConfig

    base = LongVITAConfig.from_hf_config(cfg)
    return dataclasses.replace(base, vision_downsample_ratio=cfg["vision_downsample_ratio"],
                               image_token_length=cfg["image_token_length"])


@torch.no_grad()
def params(cfg: dict, seed: int, device):
    """The port's LongVITAParams holding the benchmark's weights of ``seed``
    (made a stack at a time, so that one stack at most lies beside them)."""
    from long_vita_tpu_torch.models.long_vita import init_long_vita_params

    tree = init_long_vita_params(torch.Generator().manual_seed(0), config(cfg),
                                 dtype=torch.bfloat16, device="meta").to_empty(device=device)
    named = dict(tree.named_parameters())
    by_stack: dict = {}
    for name in named:
        by_stack.setdefault(W.stack_name(name)[0], []).append(name)
    made = W.stacks(cfg)
    missing = set(by_stack) - {s.name for s in made}
    if missing:
        raise ValueError(
            f"the port holds parameters the benchmark does not make: {sorted(missing)}")
    for stack in made:
        values = W.make(stack, seed, device)
        for name in by_stack.pop(stack.name, ()):
            layer = W.stack_name(name)[1]
            named[name].copy_(values if layer < 0 else values[layer])
        del values
    return tree


def multimodal(tokdir: str, cfg: dict):
    """The front end as build_engine makes it, at the configuration's tile
    size and tokens a tile."""
    from long_vita_tpu_torch.data.image_processor import ImageProcessor
    from long_vita_tpu_torch.data.multimodal import MultimodalTokenizer
    from long_vita_tpu_torch.tokenizer import load_tokenizer

    return MultimodalTokenizer(load_tokenizer(tokdir),
                               ImageProcessor(image_size=cfg["visual"]["image_size"]),
                               image_token_length=cfg["image_token_length"])


def serving(tree, cfg: dict, mm, server: dict):
    """The engine and the continuous scheduler of ``--serve --continuous``
    (inference/server.py's ContinuousBatcher), without its thread: the
    benchmark calls ``iteration()`` itself."""
    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.inference.server import ContinuousBatcher

    engine = InferenceEngine(
        tree, config(cfg), mm, max_seq_len=server["max_seq_len"], chunk=server["chunk"],
        vision_chunk=server["vision_chunk"], cache_dtype=torch.bfloat16,
    )
    return engine, ContinuousBatcher(engine, max_slots=server["max_slots"], tick=server["tick"],
                                     start_thread=False)


def trainer(tree, cfg: dict, run: dict):
    """The port's Trainer for one device, configured as the stage's recipe."""
    from long_vita_tpu_torch.training.optimizer import OptimizerConfig
    from long_vita_tpu_torch.training.trainer import Trainer, TrainerConfig

    o = run["optim"]
    tcfg = TrainerConfig(
        seq_len=run["seq_len"], logit_budget=run["logit_budget"], global_batch=run["rows"],
        steps=10**9, remat=run["remat"], vision_chunk=run["vision_chunk"], resume=False,
        optim=OptimizerConfig(
            lr=o["lr"], betas=tuple(o["betas"]), eps=o["eps"], grad_clip=o["grad_clip"],
            weight_decay=o["weight_decay"], warmup_steps=o["warmup_steps"],
            total_steps=o["total_steps"], min_lr_ratio=o["min_lr_ratio"],
            freeze_vision=o["freeze_vision"], freeze_text=o["freeze_text"]),
    )
    return Trainer(tree, config(cfg), tcfg)


def batches(samples, mm, run: dict):
    """The port's data path from packing on: greedy packs, collated batches
    with the logit budget, and the prefetch thread two batches ahead."""
    from long_vita_tpu_torch.data.dataset import ChatMLSupervision, PackedDataset
    from long_vita_tpu_torch.data.prefetch import prefetch
    from long_vita_tpu_torch.training.trainer import batch_iterator

    packs = PackedDataset(samples, ChatMLSupervision(mm), run["seq_len"],
                          mm.tokenizer.pad_token_id)
    return prefetch(batch_iterator(iter(packs), run["rows"], run["logit_budget"]), depth=2)


def kernel_launches() -> dict:
    """The port's kernel launch counters."""
    from long_vita_tpu_torch.ops import flash_attention as fa

    return {"k1": fa.flash_attention.launches, "k3": fa.short_attention.launches,
            "k4": fa.flash_bwd_fused.launches, "k5": fa.flash_bwd_dkv.launches}


def _half_batch(setattr_) -> None:
    """Half of the batch left out, the mean taken over the rest: the loss
    keeps the first half of each batch's supervised targets."""
    from long_vita_tpu_torch.constants import IGNORE_INDEX
    from long_vita_tpu_torch.training import train_step

    ce = train_step.cross_entropy

    def half(logits, labels):
        keep = labels != IGNORE_INDEX
        rank = keep.flatten().cumsum(0).reshape(keep.shape)
        return ce(logits, torch.where(keep & (rank > (keep.sum() + 1) // 2), IGNORE_INDEX, labels))

    setattr_(train_step, "cross_entropy", half)


def _cache_unwritten(setattr_) -> None:
    """A step that returns its state unchanged: an admitted prompt's keys
    and values never reach the slot pool, so its decode ticks read a stale
    cache."""
    from long_vita_tpu_torch.inference.continuous import ContinuousEngine

    setattr_(ContinuousEngine, "_insert", lambda self, staged, slot, true_len: None)


def _token_altered(setattr_) -> None:
    """A token altered where it is produced: the head's sampled token plus
    one."""
    from long_vita_tpu_torch.inference.engine import InferenceEngine

    sample = InferenceEngine._head_sample

    def wrong(self, hidden, generator, sp):
        token, lp = sample(self, hidden, generator, sp)
        return (token + 1) % self.cfg.text.vocab_size, lp

    setattr_(InferenceEngine, "_head_sample", wrong)


# faults planted in the program, which the comparison has to catch
# (portbench/control.py --fault, portbench/tests)
FAULTS = {"half_batch": _half_batch, "cache_unwritten": _cache_unwritten,
          "token_altered": _token_altered}
