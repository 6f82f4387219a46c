"""long-vita-tpu-torch: the PyTorch/CUDA port of long_vita_tpu for NVIDIA Hopper.

Module paths and public function names mirror the JAX package
(``long_vita_tpu``), which stays the reference the port is tested against.
The port imports torch and never jax; its hand-written CUDA kernels build
from ``ops/csrc/`` at first use.

Quick API (image, video and text serving; training on one GPU):
    from long_vita_tpu_torch.config import long_vita_14b
    from long_vita_tpu_torch.models.long_vita import init_long_vita_params
    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.training.trainer import Trainer, TrainerConfig
    # weights from the JAX package: utils.convert.long_vita_params_from_jax
"""
__version__ = "0.1.0"

from long_vita_tpu_torch.config import LongVITAConfig, TextConfig

__all__ = ["LongVITAConfig", "TextConfig"]
