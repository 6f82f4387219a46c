"""Image / video preprocessing front end (host-side, CPU).

Counterpart of long_vita_tpu/data/image_processor.py (reference
ImageProcessor, long_vita/data/processor/image_processor.py):
  - process_images (:180): expand2square-pad with the dataset mean color,
    bicubic resize to 448x448, scale to [0,1], normalize by mean/std
  - process_dynamic (:263) -> dynamic_preprocess (:404): InternVL-style
    aspect-ratio tiling — pick the (i, j) grid in [min..max] tiles whose
    aspect ratio is closest to the image's, resize to (448*i, 448*j), crop
    448 tiles row-major, and prepend a full-image thumbnail when >1 tile
  - process_video (:136): directory-of-frames (natural sort, fps-based
    subsampling) or video file (uniform frame sampling at <= max_fps,
    <= max_num_frame) — decord replaced by OpenCV

Output layout is NHWC float32, as the JAX package's. A uniform uint8
[N, H, W, 3] batch (decoded video frames) takes the native feedworker
(data/native.py) and needs neither PIL nor OpenCV; PIL is imported only by
the functions that open or resize an image with it, OpenCV only by the
video-file reader.
"""
from __future__ import annotations

import os
import re
from typing import Iterable, Sequence

import numpy as np

from long_vita_tpu_torch.constants import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def _to_pil(x):
    """A path, PIL image or [H, W, 3] array -> an RGB PIL image."""
    from PIL import Image

    if isinstance(x, str):
        return Image.open(x).convert("RGB")
    if isinstance(x, Image.Image):
        return x.convert("RGB")
    return Image.fromarray(np.asarray(x)).convert("RGB")


class ImageProcessor:
    """448x448 tiling preprocessor for InternViT-300M."""

    def __init__(
        self,
        image_size: int = 448,
        mean: Sequence[float] = IMAGENET_DEFAULT_MEAN,
        std: Sequence[float] = IMAGENET_DEFAULT_STD,
        min_patch_grid: int = 1,
        max_patch_grid: int = 12,
        process_type: str = "dynamic",  # "dynamic" | "anyres"
    ):
        self.image_size = image_size
        self.patch_size = image_size  # tile side, reference naming
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.min_patch_grid = min_patch_grid
        self.max_patch_grid = max_patch_grid
        self.process_type = process_type
        # anyres candidate canvases (reference image_processor.py:33-57
        # builds possible_resolutions from the patch grid range)
        self.possible_resolutions = [
            (image_size * i, image_size * j)
            for i in range(1, max_patch_grid + 1)
            for j in range(1, max_patch_grid + 1)
            if min_patch_grid <= i * j <= max_patch_grid
        ]

    # -- single-tile path ---------------------------------------------------

    def _expand2square(self, img):
        from PIL import Image

        w, h = img.size
        if w == h:
            return img
        bg = tuple(int(x * 255) for x in self.mean)
        side = max(w, h)
        out = Image.new(img.mode, (side, side), bg)
        out.paste(img, ((side - w) // 2, (side - h) // 2))
        return out

    def process_images(self, images: Iterable) -> np.ndarray:
        """-> [N, 448, 448, 3] float32 normalized (square-pad + resize).

        Uniform uint8 ndarray batches (decoded video frames) take the native
        C++ feedworker (data/native.py): thread-pooled pad+resize+normalize,
        bit for bit PIL's uint8 pipeline."""
        images = list(images) if not isinstance(images, np.ndarray) else images
        batch = self._as_uniform_batch(images)
        if batch is not None:
            from long_vita_tpu_torch.data import native

            return native.preprocess_frames(batch, self.image_size, self.mean, self.std)
        from PIL import Image

        out = []
        for x in images:
            img = self._expand2square(_to_pil(x))
            img = img.resize((self.image_size, self.image_size), Image.Resampling.BICUBIC)
            arr = np.asarray(img, np.float32) / 255.0
            out.append((arr - self.mean) / self.std)
        return np.stack(out) if out else np.zeros(
            (0, self.image_size, self.image_size, 3), np.float32
        )

    @staticmethod
    def _as_uniform_batch(images) -> "np.ndarray | None":
        """[N,H,W,3] uint8 batch if all inputs are same-shape uint8 arrays."""
        if isinstance(images, np.ndarray):
            if images.ndim == 4 and images.dtype == np.uint8:
                return images
            return None
        if not images or not all(
            isinstance(x, np.ndarray) and x.dtype == np.uint8 and x.ndim == 3
            and x.shape == images[0].shape and x.shape[-1] == 3
            for x in images
        ):
            return None
        return np.stack(images)

    # -- dynamic tiling -----------------------------------------------------

    def _best_grid(self, width: int, height: int) -> tuple[int, int]:
        """Closest (cols, rows) tile grid to the image aspect ratio
        (reference find_closest_aspect_ratio:383-397)."""
        aspect = width / height
        candidates = sorted(
            {
                (i, j)
                for n in range(self.min_patch_grid, self.max_patch_grid + 1)
                for i in range(1, n + 1)
                for j in range(1, n + 1)
                if self.min_patch_grid <= i * j <= self.max_patch_grid
            },
            key=lambda r: r[0] * r[1],
        )
        best, best_diff = (1, 1), float("inf")
        area = width * height
        for i, j in candidates:
            diff = abs(aspect - i / j)
            if diff < best_diff:
                best, best_diff = (i, j), diff
            elif diff == best_diff:
                if area > 0.5 * self.image_size**2 * i * j:
                    best = (i, j)
        return best

    def process_dynamic(self, img):
        """-> (tiles [N,448,448,3], (grid_w_px, grid_h_px)).

        Tiles: [thumbnail?, row-major 448 crops]; thumbnail prepended when
        the grid has more than one tile (reference dynamic_preprocess:458-463).
        """
        image = _to_pil(img)
        cols, rows = self._best_grid(*image.size)
        tw, th = self.image_size * cols, self.image_size * rows
        resized = image.resize((tw, th))
        crops = []
        for idx in range(cols * rows):
            x0 = (idx % cols) * self.image_size
            y0 = (idx // cols) * self.image_size
            crops.append(resized.crop((x0, y0, x0 + self.image_size, y0 + self.image_size)))
        if len(crops) > 1:
            crops = [image.resize((self.image_size, self.image_size))] + crops
        return self.process_images(crops), (tw, th)

    # -- anyres tiling (reference process_anyres:239-261) -------------------

    @staticmethod
    def _select_best_resolution(original_size, possible_resolutions):
        """Best canvas by max effective then min wasted resolution
        (reference select_best_resolution:286-313)."""
        ow, oh = original_size
        best, best_eff, best_waste = None, 0, float("inf")
        for w, h in possible_resolutions:
            scale = min(w / ow, h / oh)
            eff = min(int(ow * scale) * int(oh * scale), ow * oh)
            waste = w * h - eff
            if eff > best_eff or (eff == best_eff and waste < best_waste):
                best, best_eff, best_waste = (w, h), eff, waste
        return best

    def process_anyres(self, img):
        """-> (tiles [N,448,448,3], (canvas_w, canvas_h)).

        Tiles: [full image, row-major crops of the aspect-preserving
        resize-and-pad canvas] (reference :252-257 keeps the whole image
        FIRST, then the canvas patches)."""
        from PIL import Image

        image = _to_pil(img)
        best = self._select_best_resolution(image.size, self.possible_resolutions)
        tw, th = best
        # resize preserving aspect, centered on a black canvas (:301-330)
        scale = min(tw / image.size[0], th / image.size[1])
        nw = min(int(np.ceil(image.size[0] * scale)), tw)
        nh = min(int(np.ceil(image.size[1] * scale)), th)
        canvas = Image.new("RGB", (tw, th), (0, 0, 0))
        canvas.paste(image.resize((nw, nh)), ((tw - nw) // 2, (th - nh) // 2))
        crops = []
        for y0 in range(0, th, self.image_size):
            for x0 in range(0, tw, self.image_size):
                crops.append(canvas.crop((x0, y0, x0 + self.image_size, y0 + self.image_size)))
        if best == (self.image_size, self.image_size):
            tiles = [image]
        else:
            tiles = [image] + crops
        return self.process_images(tiles), best

    # dispatch kept for reference-API parity
    def process_images_with_subpatch(self, img):
        if self.process_type == "anyres":
            return self.process_anyres(img)
        return self.process_dynamic(img)

    # -- video --------------------------------------------------------------

    def _video_file_frames(self, path: str, max_num_frame: int, max_fps: float) -> list:
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            fps = cap.get(cv2.CAP_PROP_FPS) or 1.0
            # reference get_video_frames:118-127: uniform stride, capped by fps
            step = max(total / (max_num_frame + 1), fps / max_fps)
            indices = [int(i * step) for i in range(max_num_frame)]
            indices = [i for i in indices if i < total]
            frames = []
            for idx in indices:
                cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
                ok, frame = cap.read()
                if not ok:
                    break
                # raw uint8 RGB -> native batch fast path in process_images
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            return frames
        finally:
            cap.release()

    def _frame_dir_paths(self, d: str, max_num_frame: int, max_fps: float) -> list[str]:
        paths = []
        for root, _, files in os.walk(d):
            for f in files:
                if f.lower().endswith(("png", "jpg", "jpeg")):
                    paths.append(os.path.join(root, f))
        paths.sort(key=_natural_key)
        if not paths:
            return []
        fps = 2 if "ShareGPTVideo" in d else 1  # reference :155-158
        target = int(min(len(paths) / fps * max_fps, max_num_frame))
        target = max(target, 1)
        stride = int(len(paths) / target)
        return [paths[min(i * stride, len(paths) - 1)] for i in range(target)]

    def process_video(
        self, video: str, max_num_frame: int = 4096, max_fps: float = 1.0
    ) -> np.ndarray:
        """-> frames [F, 448, 448, 3] float32 normalized."""
        if os.path.isdir(video):
            frames = self._frame_dir_paths(video, max_num_frame, max_fps)
        elif os.path.isfile(video):
            frames = self._video_file_frames(video, max_num_frame, max_fps)
        else:
            raise FileNotFoundError(video)
        return self.process_images(frames)
