"""Inference CLI — the tools/inference_long_vita.py equivalent.

Counterpart of long_vita_tpu/inference/cli.py, with the same flags:
    python -m long_vita_tpu_torch.inference.cli <checkpoint_dir> \
        --prompt "<image>\\nDescribe this image." --image path.jpg
    python -m long_vita_tpu_torch.inference.cli <checkpoint_dir> --serve --port 5001

The checkpoint dir is a released Long-VITA-*_HF directory (config.json +
safetensors + tokenizer assets); see utils/checkpoint_io.py. The model goes
to the card unless ``build_engine`` is given another device. There is no
counterpart of the JAX package's compile cache (PyTorch runs eagerly).

``--tp N`` serves the model sharded over N ranks (Megatron-style tensor
parallelism, parallel/sharding.py), ``--cp M`` from a KV cache sharded over
M ranks by slot, and both together over tp x cp ranks, one process a GPU:

    torchrun --nproc-per-node 4 -m long_vita_tpu_torch.inference.cli \
        <checkpoint_dir> --serve --continuous --tp 4
    torchrun --nproc-per-node 4 -m long_vita_tpu_torch.inference.cli \
        <checkpoint_dir> --serve --continuous --tp 2 --cp 2

Each rank loads the whole checkpoint onto its own card (rank %
device_count) and keeps its shard. With ``--serve`` rank 0 answers HTTP
and the other ranks replay its actions (inference/server.py,
inference/multihost.py); ``--prompt`` runs the same generate on every rank
and prints on rank 0. ``--chat`` over more than one rank raises (the REPL
has no lockstep).
"""
from __future__ import annotations

import argparse
import sys


def build_engine(
    model_path: str,
    *,
    max_seq_len: int = 16384,
    chunk: int = 2048,
    max_num_frame: int = 4096,
    dtype_name: str = "bfloat16",
    tp: int = 1,
    cp: int = 1,
    kv_quant: bool = False,
    prefix_cache: int = 0,
    speculative: int = 0,
    weight_quant=None,
    device="cuda",
):
    import torch

    from long_vita_tpu_torch.data.multimodal import MultimodalTokenizer
    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.tokenizer import load_tokenizer
    from long_vita_tpu_torch.utils.checkpoint_io import load_long_vita_checkpoint

    mesh = None
    if cp * tp > 1:
        mesh = _mesh(cp, tp)
        if torch.device(device).type == "cuda":
            # init_process_group gave this rank its card
            device = torch.device("cuda", torch.cuda.current_device())
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype_name]
    params, cfg = load_long_vita_checkpoint(model_path, dtype=dtype, device=device)
    tokenizer = load_tokenizer(model_path)
    mm = MultimodalTokenizer(tokenizer, max_num_frame=max_num_frame)
    return InferenceEngine(
        params, cfg, mm, max_seq_len=max_seq_len, chunk=chunk,
        cache_dtype=dtype, kv_quant=kv_quant, mesh=mesh,
        prefix_cache_entries=prefix_cache, speculative_k=speculative,
        weight_quant=weight_quant,
    )


def _mesh(cp: int, tp: int):
    """The (cp, tp) mesh of this job's ranks: torch.distributed from
    torchrun's variables (or LVT_COORDINATOR / LVT_NUM_PROCESSES /
    LVT_PROCESS_ID), which must name exactly cp x tp processes."""
    from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from long_vita_tpu_torch.training.distributed import maybe_initialize

    comm = maybe_initialize()
    world, n = (comm.size if comm is not None else 1), cp * tp
    flags = " ".join(f"--{name} {k}" for name, k in (("tp", tp), ("cp", cp)) if k > 1)
    if world != n:
        raise ValueError(
            f"{flags} serves from {n} processes, one a GPU, and this job has {world}: "
            f"launch it with torchrun --nproc-per-node {n} -m "
            f"long_vita_tpu_torch.inference.cli <checkpoint_dir> ... {flags}"
        )
    return make_mesh(MeshConfig(cp=cp, tp=tp), comm)


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Long-VITA inference (PyTorch/CUDA)")
    parser.add_argument("model_path")
    parser.add_argument("--prompt", default=None)
    parser.add_argument("--image", action="append", default=[])
    parser.add_argument("--video", action="append", default=[])
    parser.add_argument("--max-new-tokens", type=int, default=256)
    parser.add_argument("--beam-size", type=int, default=0,
                        help="use beam search with this width")
    parser.add_argument("--max-seq-len", type=int, default=16384)
    parser.add_argument("--chunk", type=int, default=2048)
    parser.add_argument("--max-num-frame", type=int, default=4096)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--top-k", type=int, default=0)
    parser.add_argument("--top-p", type=float, default=0.0)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel ways: the weights and the KV "
                             "cache's heads sharded over N ranks, one process "
                             "a GPU (launch with torchrun --nproc-per-node "
                             "N x cp); rank 0 serves")
    parser.add_argument("--cp", type=int, default=1,
                        help="context-parallel ways: a KV cache sharded over "
                             "N ranks, one process a GPU (launch with "
                             "torchrun --nproc-per-node N x tp); rank 0 serves")
    parser.add_argument("--weight-quant", default=None,
                        choices=["int8", "int4"],
                        help="weight-only quantized serving: int8 (w8a16) or "
                             "int4 (w4a16 grouped, the CUDA kernel K6) "
                             "(models/quantize.py)")
    parser.add_argument("--kv-quant", action="store_true",
                        help="int8 KV cache (half the memory/bandwidth)")
    parser.add_argument("--speculative", type=int, default=0,
                        help="prompt-lookup speculative decoding: verify K "
                             "n-gram draft tokens per step (greedy only; "
                             "lossless — outputs are bit-identical)")
    parser.add_argument("--prefix-cache", type=int, default=0,
                        help="keep N prompt KV snapshots and resume prefill "
                             "after the longest matching prefix (each entry "
                             "holds a full cache allocation)")
    parser.add_argument("--serve", action="store_true")
    parser.add_argument("--continuous", action="store_true",
                        help="serve with continuous (slot-pool) batching")
    parser.add_argument("--chat", action="store_true",
                        help="interactive multi-turn chat REPL")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5001)
    return parser


def _sampling(args):
    from long_vita_tpu_torch.inference.sampler import SamplingParams

    return SamplingParams(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        greedy=(args.top_k == 0 and args.top_p == 0.0),
        max_new_tokens=args.max_new_tokens,
    )


def main(argv=None):
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.chat and args.cp * args.tp > 1:
        parser.error("--chat runs on one rank: the REPL has no lockstep for --cp or --tp")

    engine = build_engine(
        args.model_path, max_seq_len=args.max_seq_len, chunk=args.chunk,
        max_num_frame=args.max_num_frame, dtype_name=args.dtype, tp=args.tp,
        cp=args.cp, kv_quant=args.kv_quant, prefix_cache=args.prefix_cache,
        speculative=args.speculative, weight_quant=args.weight_quant,
    )

    try:
        _run(args, parser, engine)
    finally:
        if engine.parallel is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args, parser, engine) -> None:
    # every rank makes the same engine calls; rank 0 prints
    primary = engine.parallel is None or engine.parallel.mesh.world.rank == 0
    if args.serve:
        from long_vita_tpu_torch.inference.server import run_server

        run_server(engine, args.host, args.port, continuous=args.continuous)
        return

    if args.chat:
        sampling = _sampling(args)
        # multi-turn chat (reference tasks/inference/infer_base.py chat task);
        # media attach once via --image/--video, referenced by tags in any turn
        history: list[dict] = []
        images, videos = list(args.image), list(args.video)
        print("chat mode — empty line or 'exit' to quit, 'clear' to reset")
        while True:
            try:
                user = input("user> ").strip()
            except (EOFError, KeyboardInterrupt):
                break
            if not user or user == "exit":
                break
            if user == "clear":
                history = []
                continue
            history.append({"role": "user", "content": user})
            result = engine.generate(history, images=images, videos=videos, sampling=sampling)
            print(f"assistant> {result.text}")
            history.append({"role": "assistant", "content": result.text})
        return

    if args.prompt is None:
        parser.error("--prompt required unless --serve/--chat")

    messages = [{"role": "user", "content": args.prompt}]
    if args.beam_size > 0:
        from long_vita_tpu_torch.inference.beam_search import beam_search

        ids = engine.mm.encode_chat(messages)
        expanded = engine.mm.expand(ids, images=args.image, videos=args.video)
        hyps = beam_search(
            engine, expanded.input_ids,
            images=expanded.images, image_indices=expanded.image_indices,
            beam_size=args.beam_size, max_new_tokens=args.max_new_tokens,
        )
        if primary:
            print(engine.mm.tokenizer.decode(hyps[0].token_ids, skip_special_tokens=True))
        return

    result = engine.generate(
        messages, images=args.image, videos=args.video, sampling=_sampling(args),
    )
    if primary:
        print(result.text)


if __name__ == "__main__":
    main(sys.argv[1:])
