"""A miniature of the benchmark for tests on the CPU: the port's
tiny_test_config geometry (its vocabulary widened to hold the tokenizer
fixture's 4096 BPE ids and its 39 added ones), with small cells of every
entry and a manifest that names them."""
from __future__ import annotations

import copy

from portbench import harness

CONFIG = {
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "max_position_embeddings": 2048, "tie_word_embeddings": False, "attention_bias": True,
    "hidden_act": "silu", "bos_token_id": 4096, "eos_token_id": 4098, "vocab_size": 4160,
    "visual": {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
               "num_attention_heads": 2, "image_size": 56, "patch_size": 14, "num_channels": 3,
               "layer_norm_eps": 1e-6},
    "vision_downsample_ratio": 0.5, "image_token_length": 4, "torch_dtype": "bfloat16",
}
SERVER = {"max_slots": 4, "tick": 4, "chunk": 32, "max_seq_len": 256, "vision_chunk": 4}
CELLS = {
    "tiny-video": ({"config": "tiny", "traffic": "tiny-video", "entry": "serve", "server": SERVER,
                    "load": {"loop": "closed", "clients": 2},
                    # logprob_gap: 1.3e-3-2.2e-3 sound, 9.7e-3-1.1e-2 the control (seeds 7-9)
                    "check": {"requests": 3, "min_tokens": 3, "max_gap": 0.05,
                              "logprob_gap": 0.005},
                    "trace": {"start_frac": 0.2, "seconds": 0.5}},
                   {"generator": "media_qa", "frames": [1, 3], "question_ids": [3, 12],
                    "max_new_tokens": 6, "block": 4, "requests": 16, "pool": 8}),
    "tiny-doc": ({"config": "tiny", "traffic": "tiny-doc", "entry": "serve", "server": SERVER,
                  "load": {"loop": "open", "grace_s": 30.0},
                  "check": {"requests": 3, "min_tokens": 3, "max_gap": 0.05, "logprob_gap": 0.05},
                  "trace": {"start_frac": 0.2, "seconds": 0.5}},
                 {"generator": "doc_qa", "prompt_ids": [20, 120], "block": 4, "requests": 64,
                  "rate": 8.0}),
    "tiny-train": ({"config": "tiny", "traffic": "tiny-captions", "entry": "train",
                    "run": {"seq_len": 256, "logit_budget": 256, "rows": 1, "remat": True,
                            "vision_chunk": 4,
                            "optim": {"lr": 1e-3, "betas": [0.9, 0.95], "eps": 1e-8,
                                      "grad_clip": 1.0, "weight_decay": 0.0, "warmup_steps": 2,
                                      "total_steps": 100, "min_lr_ratio": 0.01,
                                      "freeze_vision": True, "freeze_text": True}},
                    "setup_steps": 1,
                    "check": {"steps": 3, "limits": {"change_norm_gap": 0.2,
                                                     "supervised_gap": 0}},
                    "trace": {"step": 1, "steps": 1}},
                   {"generator": "caption_packs", "caption_ids": [8, 40], "block": 8,
                    "samples": 3000, "pool": 6}),
}


TWIN = {"tiny-video": "vita14b-video-qa", "tiny-train": "vita72b-stage1-train"}
E2E = {"tiny-video": "prompt_tokens_per_s", "tiny-doc": "ttft_p90_ms",
       "tiny-train": "train_tokens_per_s"}


def manifest() -> dict:
    """BENCHMARK.json's per-layer metrics, each also read in the tiny twins
    of its cells, and each tiny cell's end-to-end metric."""
    man = copy.deepcopy(harness.manifest())
    for m in man["per_layer"]:
        m["workloads"] += [t for t, w in TWIN.items() if w in m["workloads"]]
    man["end_to_end"] = [{"name": "setup_s", "unit": "s"}] + [
        {"name": name, "unit": "u", "workloads": [cell]} for cell, name in E2E.items()]
    man["workloads"] += [{"name": t, "chips": 1} for t in CELLS]
    return man


def environment(cell: str, seed: int = 7, seconds: float = 2.0, trace: bool = False):
    from portbench.run import environment as env

    c, mix = CELLS[cell]
    return env(cell, seed, seconds, trace, "cpu", __import__("time").perf_counter(),
               man=manifest(), cell=c, cfg=CONFIG, mix=mix)


def run(cell: str, **kw):
    import importlib

    env = environment(cell, **kw)
    return importlib.import_module(f"portbench.{env.cell['entry']}").run(env)

