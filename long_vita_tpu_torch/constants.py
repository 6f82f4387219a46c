"""Constants the port uses, copied from long_vita_tpu/constants.py.

The port imports nothing of the JAX package; tests/test_torch_config.py
holds the values equal to the JAX package's.
"""

# Placeholder tags that users put in prompts; the multimodal front end
# (data/multimodal.py) expands them into start/context/end runs.
IMG_TAG_TOKEN = "<image>"
VID_TAG_TOKEN = "<video>"

IMG_CONTEXT_TOKEN = "<IMG_CONTEXT>"
IMG_START_TOKEN = "<img>"
IMG_END_TOKEN = "</img>"

VID_CONTEXT_TOKEN = "<VID_CONTEXT>"
VID_START_TOKEN = "<vid>"
VID_END_TOKEN = "</vid>"

PATCH_CONTEXT_TOKEN = "<PATCH_CONTEXT>"
PATCH_START_TOKEN = "<patch>"
PATCH_END_TOKEN = "</patch>"

QUAD_START_TOKEN = "<quad>"
QUAD_END_TOKEN = "</quad>"
REF_START_TOKEN = "<ref>"
REF_END_TOKEN = "</ref>"
BOX_START_TOKEN = "<box>"
BOX_END_TOKEN = "</box>"

# Image normalization statistics (reference constants.py:87-92).
IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)

# Loss masking sentinel (reference constants.py:97).
IGNORE_INDEX = -100

# LM tokens one 448x448 tile expands to after the projector's pixel shuffle
# of the 32x32 ViT patch grid (reference resampler_projector.py:13-14).
IMAGE_TOKEN_LENGTH = 256
