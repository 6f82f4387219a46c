"""Model configuration: the JAX package's dataclasses, shared as they are.

``long_vita_tpu.config`` imports no JAX (``long_vita_tpu/__init__.py``
imports only ``config``), so the port reuses its geometry rather than
copying it.
"""
from long_vita_tpu.config import (  # noqa: F401
    LongVITAConfig,
    TextConfig,
    VisionConfig,
    long_vita_14b,
    tiny_test_config,
)

__all__ = [
    "LongVITAConfig", "TextConfig", "VisionConfig", "long_vita_14b",
    "tiny_test_config",
]
