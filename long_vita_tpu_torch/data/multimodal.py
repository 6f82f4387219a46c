"""Tag expansion: turn <image>/<video> placeholders into context-token runs
and build the (images, image_indices) scatter inputs.

Counterpart of long_vita_tpu/data/multimodal.py (reference
get_external_inputs, tools/inference_long_vita.py:568-775, same logic as
long_vita_megatron/tasks/inference/module.py:493):

  <image>  ->  <img> IMG_CONTEXT*256 </img>
               [if >1 tile: per grid row: "\\n", then per tile:
                <patch> PATCH_CONTEXT*256 </patch>]
  <video>  ->  per frame: <vid> VID_CONTEXT*256 </vid>

The tile stack order is [thumbnail, row-major grid tiles] (thumbnail feeds
the <img> block); image_indices is [2, N_tiles, 256] of (batch, seq)
positions aimed at the context-token runs. Images are expanded first, then
videos, matching the reference's two passes. The output is host numpy, as
the JAX package's: the engine moves it to the card.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np

from long_vita_tpu_torch import constants as C
from long_vita_tpu_torch.data.image_processor import ImageProcessor
from long_vita_tpu_torch.tokenizer import update_tokenizer


@dataclasses.dataclass
class ExpandedInputs:
    input_ids: list[int]
    images: Optional[np.ndarray]  # [N, 448, 448, 3] f32 or None
    image_indices: Optional[np.ndarray]  # [2, N, T] int64 or None
    labels: Optional[list[int]] = None  # training targets (IGNORE on inserts)


class MultimodalTokenizer:
    """HF tokenizer + ImageProcessor + tag expansion."""

    def __init__(
        self,
        tokenizer,
        image_processor: Optional[ImageProcessor] = None,
        image_token_length: int = C.IMAGE_TOKEN_LENGTH,
        max_num_frame: int = 4096,
        max_fps: float = 1.0,
    ):
        self.tokenizer = update_tokenizer(tokenizer)
        self.processor = image_processor or ImageProcessor()
        self.image_token_length = image_token_length
        self.max_num_frame = max_num_frame
        self.max_fps = max_fps

        def one_id(tok: str) -> int:
            ids = self.tokenizer(tok, add_special_tokens=False).input_ids
            if len(ids) != 1:
                raise ValueError(f"{tok!r} is not one token of the tokenizer: {ids}")
            return ids[0]

        self.img_tag = one_id(C.IMG_TAG_TOKEN)
        self.vid_tag = one_id(C.VID_TAG_TOKEN)
        self.img_start = one_id(C.IMG_START_TOKEN)
        self.img_end = one_id(C.IMG_END_TOKEN)
        self.img_ctx = one_id(C.IMG_CONTEXT_TOKEN)
        self.vid_start = one_id(C.VID_START_TOKEN)
        self.vid_end = one_id(C.VID_END_TOKEN)
        self.vid_ctx = one_id(C.VID_CONTEXT_TOKEN)
        self.patch_start = one_id(C.PATCH_START_TOKEN)
        self.patch_end = one_id(C.PATCH_END_TOKEN)
        self.patch_ctx = one_id(C.PATCH_CONTEXT_TOKEN)
        self.nl_tokens = self.tokenizer("\n", add_special_tokens=False).input_ids

    # -- block builders -------------------------------------------------

    def _block(self, ids: list[int], start: int, ctx: int, end: int,
               indices: list[np.ndarray], labels=None) -> None:
        t = self.image_token_length
        ids.append(start)
        seq = np.arange(len(ids), len(ids) + t, dtype=np.int64)
        indices.append(np.stack([np.zeros(t, np.int64), seq]))
        ids.extend([ctx] * t)
        ids.append(end)
        if labels is not None:
            labels.extend([C.IGNORE_INDEX] * (t + 2))

    def _expand_image(self, ids, image, indices, images, labels=None) -> None:
        tiles, (grid_w, grid_h) = self.processor.process_dynamic(image)
        images.append(tiles)
        self._block(ids, self.img_start, self.img_ctx, self.img_end, indices, labels)
        if len(tiles) > 1:
            for _row in range(0, grid_h, self.processor.patch_size):
                ids.extend(self.nl_tokens)
                if labels is not None:
                    labels.extend([C.IGNORE_INDEX] * len(self.nl_tokens))
                for _col in range(0, grid_w, self.processor.patch_size):
                    self._block(
                        ids, self.patch_start, self.patch_ctx, self.patch_end,
                        indices, labels,
                    )

    def _expand_video(self, ids, video, indices, images, labels=None,
                      max_num_frame: Optional[int] = None) -> None:
        if isinstance(video, str):
            frames = self.processor.process_video(
                video, max_num_frame or self.max_num_frame, self.max_fps
            )
        else:  # pre-extracted frame list
            frames = self.processor.process_images(video)
        images.append(frames)
        for _ in range(len(frames)):
            self._block(ids, self.vid_start, self.vid_ctx, self.vid_end, indices, labels)

    # -- public API ------------------------------------------------------

    def expand(
        self,
        input_ids: Sequence[int],
        images: Sequence = (),
        videos: Sequence = (),
        labels: Optional[Sequence[int]] = None,
        max_num_frame: Optional[int] = None,
    ) -> ExpandedInputs:
        """Expand tags in a tokenized prompt.

        images: list of paths / PIL images / arrays, one per <image> tag.
        videos: list of video paths (or frame lists), one per <video> tag.
        labels: optional training targets aligned with input_ids; inserted
        multimodal tokens get IGNORE_INDEX (training path, reference
        dataset_qwen2.py:540-565).
        max_num_frame: per-call frame-budget override (the server passes the
        request's value here instead of mutating shared state).
        """
        ids = list(input_ids)
        labs = list(labels) if labels is not None else None
        tile_stacks: list[np.ndarray] = []
        indices: list[np.ndarray] = []

        def _pass(ids, labs, tag, expander, media_list):
            positions = [i for i, x in enumerate(ids) if x == tag]
            if len(positions) != len(media_list):
                raise ValueError(
                    f"{len(positions)} tags at {positions} for {len(media_list)} media"
                )
            if not positions:
                return ids, labs
            new_ids: list[int] = []
            new_labs = [] if labs is not None else None
            cursor = 0
            for tag_pos, media in zip(positions, media_list):
                new_ids.extend(ids[cursor:tag_pos])
                if new_labs is not None:
                    new_labs.extend(labs[cursor:tag_pos])
                expander(new_ids, media, indices, tile_stacks, new_labs)
                cursor = tag_pos + 1
            new_ids.extend(ids[cursor:])
            if new_labs is not None:
                new_labs.extend(labs[cursor:])
            return new_ids, new_labs

        ids, labs = _pass(ids, labs, self.img_tag, self._expand_image, list(images))
        expand_video = functools.partial(self._expand_video, max_num_frame=max_num_frame)
        ids, labs = _pass(ids, labs, self.vid_tag, expand_video, list(videos))

        if not tile_stacks:
            return ExpandedInputs(ids, None, None, labs)
        return ExpandedInputs(
            ids,
            np.concatenate(tile_stacks, axis=0),
            np.stack(indices, axis=1),  # [2, N_tiles, T]
            labs,
        )

    def encode_chat(self, messages: list[dict], add_generation_prompt: bool = True) -> list[int]:
        """ChatML render via the HF chat template (Qwen2.5 format)."""
        return self.tokenizer.apply_chat_template(
            messages, add_generation_prompt=add_generation_prompt, tokenize=True
        )
