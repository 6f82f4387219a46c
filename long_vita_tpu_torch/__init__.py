"""long-vita-tpu-torch: the PyTorch/CUDA port of long_vita_tpu for NVIDIA Hopper.

Module paths and public function names mirror the JAX package
(``long_vita_tpu``), which stays the reference the port is tested against.
The port imports torch and never jax; its hand-written CUDA kernels build
from ``ops/csrc/`` at first use.

Quick API (the JAX package's, on the card unless ``device="cpu"``):
    from long_vita_tpu_torch import (
        LongVITAConfig, load_checkpoint, build_engine, SamplingParams,
    )
    engine = build_engine("/path/to/Long-VITA-16K_HF")
    out = engine.generate([{"role": "user", "content": "<image>\\nWhat?"}],
                          images=["photo.jpg"])

``build_engine`` is inference/cli.build_engine: the safetensors reader, the
port's own Qwen2 tokenizer (tokenizer.load_tokenizer) and the multimodal
front end. Below it:
    # the REST server and CLI: python -m long_vita_tpu_torch.inference.cli <dir> --serve
    # training from a YAML recipe: python -m long_vita_tpu_torch.training.train --config r.yaml
    # weights from the JAX package: utils.convert.long_vita_params_from_jax
    # training from a script: training.trainer.Trainer(params, cfg, TrainerConfig(...))
"""
__version__ = "0.1.0"

from long_vita_tpu_torch.config import LongVITAConfig, TextConfig, VisionConfig

__all__ = ["LongVITAConfig", "TextConfig", "VisionConfig", "load_checkpoint", "build_engine",
           "SamplingParams", "InferenceEngine"]


def load_checkpoint(path, **kw):
    from long_vita_tpu_torch.utils.checkpoint_io import load_long_vita_checkpoint

    return load_long_vita_checkpoint(path, **kw)


def build_engine(path, **kw):
    from long_vita_tpu_torch.inference.cli import build_engine as _build

    return _build(path, **kw)


def __getattr__(name):
    if name == "SamplingParams":
        from long_vita_tpu_torch.inference.sampler import SamplingParams

        return SamplingParams
    if name == "InferenceEngine":
        from long_vita_tpu_torch.inference.engine import InferenceEngine

        return InferenceEngine
    raise AttributeError(name)
