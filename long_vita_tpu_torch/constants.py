"""Constants the port uses, copied from long_vita_tpu/constants.py.

The port imports nothing of the JAX package; tests/test_torch_config.py
holds the values equal to the JAX package's.
"""

# Loss masking sentinel (reference constants.py:97).
IGNORE_INDEX = -100
