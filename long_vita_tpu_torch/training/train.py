"""Training entry point: ``python -m long_vita_tpu_torch.training.train --config recipe.yaml``.

Counterpart of long_vita_tpu/training/train.py (the reference's
pretrain_long_vita.py __main__ and per-stage bash scripts): one YAML recipe
names the model, the data, the optimizer and the run (configs/stage*.yaml
for the released stages):

    model: {checkpoint: <*_HF dir>} or {graft: {llm: <dir>, vit: <dir>}},
           load_stage: <a previous stage's save_dir>, dtype: bfloat16,
           lora: {r, alpha, targets, lora_only}
    data:  {corpus: <corpus.yaml>, seq_len, logit_budget, max_patch_grid,
            max_num_frame, max_fps, system_message, cross_dataset_joint, ...}
    mesh:  {dp, pp, cp, tp, tq}        # dp x pp x cp x tp x tq over processes
    optim: {lr, warmup_steps, total_steps, freeze_vision, ...}
    run:   {steps, global_batch, micro_batch, remat, save_dir, output_dir,
            profile_steps, seed, virtual_pp, fsdp, ...}

The model is built on the card (``device="cuda"``) unless the caller asks
for another device; without a card the default raises. As the JAX main,
``main`` first calls ``maybe_initialize`` (training/distributed.py): under
torchrun (or the LVT_* variables) every process joins one NCCL group, takes
the GPU of its rank and trains its dp rows and cp shard of the mesh, and
over tp its shard of the weights (Megatron's tensor and sequence
parallelism, models/qwen2.py): each rank reads only its slices of the
checkpoint's tensors (utils/checkpoint_io.py), and a checkpoint the run
writes is gathered into the tp-1 format (training/checkpoint.py);
run.cp_algo, cp_inner and cp_window_size shape the attention. With
run.fsdp (ZeRO-3 weight streaming over dp, models/qwen2.py and
parallel/fsdp.py) each rank reads only its (tp, dp) piece of every FSDP
leaf and holds 1/dp of it, its gradient and its moments. Over pp
(pipeline stages, parallel/pipeline.py; run.virtual_pp > 1 the interleaved
schedule) each rank reads only its stage's layers (and of them its tp
slices, and with run.fsdp its dp slices: FSDP inside pipeline stages).
Over tq (2-D tp: every decoder weight cut over both matrix dims,
the hidden dim of the activations over tq) each rank reads only its (tp,
tq) block of every decoder weight, the embedding and the head:

    torchrun --nproc-per-node 8 -m long_vita_tpu_torch.training.train \
        --config recipe.yaml      # mesh: {dp: 1, cp: 1, tp: 8}
    torchrun --nnodes 8 --nproc-per-node 8 ... \
        --config configs/stage2_72b_tp8fsdp8.yaml   # mesh {dp: 8, tp: 8}, run.fsdp
    torchrun --nnodes 8 --nproc-per-node 8 ... \
        --config configs/stage1_72b_tp8pp8.yaml     # mesh {dp: 1, pp: 8, tp: 8}
    torchrun --nnodes 8 --nproc-per-node 8 ... \
        --config recipe.yaml      # mesh: {dp: 4, pp: 2, tp: 8}, run.fsdp
    torchrun --nproc-per-node 8 -m long_vita_tpu_torch.training.train \
        --config recipe.yaml      # mesh: {dp: 2, tp: 2, tq: 2}
 The JAX main
also enables JAX's persistent compile cache, which has no counterpart: the
port compiles nothing at run time but its kernels, which ops/_build.py
keeps built under build/kernels/.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging

import torch

from long_vita_tpu_torch.training.optimizer import OptimizerConfig
from long_vita_tpu_torch.training.trainer import (
    MeshConfig,
    Trainer,
    TrainerConfig,
    make_data_pipeline,
)
from long_vita_tpu_torch.utils.convert import _target

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_recipe(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def trainer_config(recipe: dict) -> TrainerConfig:
    """The recipe's data, mesh, optim and run sections as a TrainerConfig,
    with the JAX package's defaults (run.cp_algo, cp_inner and
    cp_window_size shape context parallelism)."""
    data_cfg = recipe.get("data", {})
    run = recipe.get("run", {})
    optim_cfg = OptimizerConfig(**{
        k: (tuple(v) if k == "betas" else v) for k, v in recipe.get("optim", {}).items()
    })
    return TrainerConfig(
        seq_len=data_cfg.get("seq_len", 16384),
        logit_budget=data_cfg.get("logit_budget", 4096),
        global_batch=run.get("global_batch", 1),
        micro_batch=run.get("micro_batch", 0),
        steps=run.get("steps", 100),
        log_interval=run.get("log_interval", 1),
        save_interval=run.get("save_interval", 0),
        save_dir=run.get("save_dir"),
        mesh=MeshConfig(**recipe.get("mesh", {})),
        optim=optim_cfg,
        remat=run.get("remat", True),
        vision_chunk=data_cfg.get("vision_chunk", 256),
        seed=run.get("seed", 42),
        cp_algo=run.get("cp_algo", "ring"),
        cp_inner=run.get("cp_inner", 1),
        cp_window=run.get("cp_window_size", 0),
        virtual_pp=run.get("virtual_pp", 1),
        output_dir=run.get("output_dir"),
        fsdp=run.get("fsdp", False),
        profile_steps=tuple(run["profile_steps"]) if run.get("profile_steps") else None,
        allow_logit_drop=data_cfg.get("allow_logit_drop", False),
    )


def build_from_recipe(recipe: dict, *, device="cuda", comm=None):
    """-> (Trainer, the batch stream, the tokenizer) for ``recipe``, the
    model on ``device``: the weights from ``model.checkpoint`` (a *_HF
    directory, utils/checkpoint_io) or grafted from stock checkpoints
    (``model.graft``, utils/graft), a previous stage's parameters over them
    (``model.load_stage``), LoRA adapters (``model.lora``, drawn from a
    generator seeded with run.seed; lora_only unless it says otherwise),
    the tokenizer of the model's directory and the data pipeline. The
    tiles and their token runs take the tower's own sizes (its image_size,
    and the tokens a tile leaves after the projector's pixel shuffle),
    where the JAX function takes the 14B model's (448 px, 256 tokens)
    whatever the checkpoint; the two agree on every released model.
    comm: the world communicator of a mesh of more than one rank (default:
    the initialized torch.distributed group). Over tp > 1, tq > 1, pp > 1,
    or dp > 1 with run.fsdp, the mesh is made here and each rank loads only
    its slices of the decoder, over pp its stage's layers (from
    ``model.checkpoint`` or ``model.graft``; a ``load_stage`` checkpoint is
    cut the same way), and LoRA's adapters are drawn whole and cut over tp
    (replicated over dp, the stage's kept over pp), so that every
    geometry starts from the same model. ``load_stage`` names a previous
    stage's save_dir, written by this package or by the JAX package (an
    orbax store: training/checkpoint.py). The Trainer's
    ``checkpoint_bytes``: the bytes this rank copied out of the checkpoint's
    files and the load_stage store's (a zstd chunk counts its stored bytes;
    None for a graft without load_stage)."""
    from long_vita_tpu_torch.data.image_processor import ImageProcessor
    from long_vita_tpu_torch.data.multimodal import MultimodalTokenizer
    from long_vita_tpu_torch.tokenizer import load_tokenizer

    device = _target(device)
    model_cfg = recipe.get("model", {})
    data_cfg = recipe.get("data", {})
    tcfg = trainer_config(recipe)
    dtype = _DTYPES[model_cfg.get("dtype", "bfloat16")]
    mesh, stats = None, {}
    fsdp = tcfg.fsdp and tcfg.mesh.dp > 1
    if tcfg.mesh.tp > 1 or tcfg.mesh.tq > 1 or tcfg.mesh.pp > 1 or fsdp:
        mesh = _recipe_mesh(tcfg, comm)
    if model_cfg.get("graft"):
        # stage-1 bootstrap: stock Qwen2 + stock InternViT (reference
        # finetune_long_vita.py:480-530 grafting)
        from long_vita_tpu_torch.utils.graft import graft_checkpoints

        g = model_cfg["graft"]
        params, cfg = graft_checkpoints(g["llm"], g["vit"], dtype=dtype, device=device,
                                        mesh=mesh, fsdp=fsdp, virtual_pp=tcfg.virtual_pp)
        tokenizer = load_tokenizer(g["llm"])
    else:
        from long_vita_tpu_torch.utils.checkpoint_io import load_long_vita_checkpoint

        ckpt = model_cfg["checkpoint"]
        params, cfg = load_long_vita_checkpoint(ckpt, dtype=dtype, device=device, mesh=mesh,
                                                stats=stats, fsdp=fsdp,
                                                virtual_pp=tcfg.virtual_pp)
        tokenizer = load_tokenizer(ckpt)

    if model_cfg.get("load_stage"):  # stage handoff: the previous stage's parameters
        from long_vita_tpu_torch.training.checkpoint import restore_params_only

        layout = None
        if mesh is not None:
            from long_vita_tpu_torch.parallel.sharding import rank_layout

            layout = rank_layout(params, cfg, mesh)
        stage_stats: dict = {}
        params = restore_params_only(model_cfg["load_stage"], params, layout=layout,
                                     stats=stage_stats)
        stats["bytes_read"] = stats.get("bytes_read", 0) + stage_stats["bytes_read"]

    if model_cfg.get("lora"):
        # parameter-efficient finetuning (reference --lora-r/-alpha/
        # -target-modules); the base weights freeze through optim.lora_only
        from long_vita_tpu_torch.training.lora import LoraConfig, add_lora_params

        lspec = model_cfg["lora"]
        lcfg = LoraConfig(
            r=lspec.get("r", 16),
            alpha=lspec.get("alpha", 32),
            targets=tuple(lspec.get("targets", ("q_proj", "k_proj", "v_proj", "o_proj"))),
        )
        gen = torch.Generator(device=device).manual_seed(tcfg.seed)
        params, text_cfg = add_lora_params(params, cfg.text, lcfg, gen, dtype=dtype)
        cfg = dataclasses.replace(cfg, text=text_cfg)
        if lspec.get("lora_only", True):
            tcfg = dataclasses.replace(tcfg, optim=dataclasses.replace(tcfg.optim, lora_only=True))

    vision = cfg.vision
    mm = MultimodalTokenizer(
        tokenizer,
        image_processor=ImageProcessor(
            image_size=vision.image_size if vision else 448,
            min_patch_grid=data_cfg.get("min_patch_grid", 1),
            max_patch_grid=data_cfg.get("max_patch_grid", 12),
        ),
        image_token_length=(int((vision.grid * cfg.vision_downsample_ratio) ** 2) if vision
                            else cfg.image_token_length),
        max_num_frame=data_cfg.get("max_num_frame", 4096),
        max_fps=data_cfg.get("max_fps", 1.0),
    )

    trainer = Trainer(params, cfg, tcfg, comm=mesh if mesh is not None else comm)
    trainer.checkpoint_bytes = stats.get("bytes_read")
    batches = make_data_pipeline(
        data_cfg["corpus"], mm, tcfg,
        pad_token_id=tokenizer.pad_token_id or 151643,
        default_system_message=data_cfg.get("system_message"),
        cross_dataset_joint=data_cfg.get("cross_dataset_joint", False),
    )
    return trainer, batches, tokenizer


def _recipe_mesh(tcfg, comm):
    """The recipe's mesh over ``comm`` or the initialized torch.distributed
    group (the ranks load their tp and FSDP slices before the Trainer is
    made)."""
    from long_vita_tpu_torch.parallel.mesh import make_mesh

    if comm is None:
        import torch.distributed as dist

        from long_vita_tpu_torch.parallel.comm import DistComm

        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(f"a mesh of {tcfg.mesh.size} ranks needs comm= or an initialized "
                             "torch.distributed group (training/distributed.maybe_initialize)")
        comm = DistComm()
    return make_mesh(tcfg.mesh, comm)


def main(argv=None, *, device="cuda"):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    args = parser.parse_args(argv)
    from long_vita_tpu_torch.training.distributed import maybe_initialize

    comm = maybe_initialize()  # torchrun / LVT_* multi-process jobs
    trainer, batches, tokenizer = build_from_recipe(load_recipe(args.config), device=device,
                                                    comm=comm)
    return trainer.train(batches, tokenizer=tokenizer)


if __name__ == "__main__":
    main()
