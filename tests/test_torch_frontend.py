"""PyTorch port: the multimodal host front end — tokenizer.py,
data/image_processor.py, data/native.py and data/multimodal.py — against the
JAX package's, on synthetic images of several aspect ratios.

Tolerance: none. Tile stacks, token ids, scatter indices and labels must be
identical arrays; the port's native feedworker (its own copy of the C++
source, built into build/native/) must give the JAX package's library's
bits, and its uint8 path PIL's own pixels. One ByteTokenizer object serves
both packages' MultimodalTokenizer.
"""
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from long_vita_tpu import constants as jax_constants
from long_vita_tpu import tokenizer as jax_tokenizer
from long_vita_tpu.data import native as jax_native
from long_vita_tpu.data.image_processor import ImageProcessor as JaxIP
from long_vita_tpu.data.multimodal import MultimodalTokenizer as JaxMM
from long_vita_tpu_torch import constants
from long_vita_tpu_torch import tokenizer as port_tokenizer
from long_vita_tpu_torch.data import native
from long_vita_tpu_torch.data.image_processor import ImageProcessor
from long_vita_tpu_torch.data.multimodal import MultimodalTokenizer
from long_vita_tpu_torch.tokenizer import ByteTokenizer

MEAN, STD = constants.IMAGENET_DEFAULT_MEAN, constants.IMAGENET_DEFAULT_STD
SIZES = [(100, 50), (1000, 450), (450, 1000), (900, 440), (64, 64), (3000, 500), (333, 777)]


def _image(w, h, seed=0):
    rng = np.random.default_rng(seed + w * 7 + h)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---- constants and the tokenizer extension ---------------------------------

def test_token_constants_and_templates_identical():
    for name in dir(jax_constants):
        if name.isupper() and hasattr(constants, name):
            assert getattr(constants, name) == getattr(jax_constants, name), name
    assert port_tokenizer.SPECIAL_TOKENS == jax_tokenizer.SPECIAL_TOKENS
    assert len(port_tokenizer.SPECIAL_TOKENS) == 17
    assert port_tokenizer.QWEN_CHATML_TEMPLATE == jax_tokenizer.QWEN_CHATML_TEMPLATE
    assert port_tokenizer.LONG_VITA_CHAT_TEMPLATE == jax_tokenizer.LONG_VITA_CHAT_TEMPLATE


def _hf_tokenizer_dir(path):
    """A tiny Qwen2 byte-level BPE directory written to ``path``: the
    committed fixture (tests/data/qwen2_tokenizer_tiny) cut to 300 BPE
    entries, its 22 added tokens after them. The port's load_tokenizer
    reads Qwen2 tokenizer directories; no released assets are needed."""
    import chip_smoke

    return chip_smoke.tokenizer_dir(str(path), 300)


@pytest.mark.parametrize("template", ["long_vita", "qwen"])
def test_load_tokenizer_matches_jax(tmp_path, template):
    path = _hf_tokenizer_dir(tmp_path)
    got = port_tokenizer.load_tokenizer(path, template=template)
    want = jax_tokenizer.load_tokenizer(path, template=template)
    assert got.chat_template == want.chat_template
    assert len(got) == len(want)
    for tok in port_tokenizer.SPECIAL_TOKENS:
        assert got.convert_tokens_to_ids(tok) == want.convert_tokens_to_ids(tok)
    msgs = [{"role": "user", "content": "hello <image>"}]
    assert got.apply_chat_template(msgs, add_generation_prompt=True, tokenize=True) == \
        want.apply_chat_template(msgs, add_generation_prompt=True, tokenize=True)


def test_byte_tokenizer():
    tok = ByteTokenizer()
    assert port_tokenizer.update_tokenizer(tok) is tok
    ids = {t: tok(t, add_special_tokens=False).input_ids for t in port_tokenizer.SPECIAL_TOKENS}
    assert [v[0] for v in ids.values()] == list(range(151665, 151682))
    assert all(len(v) == 1 for v in ids.values())
    assert tok.add_tokens(port_tokenizer.SPECIAL_TOKENS, special_tokens=True) == 0  # idempotent
    assert len(tok) == 151682
    text = "héllo <image>\nwörld"
    enc = tok(text).input_ids
    assert ids["<image>"][0] in enc and tok.decode(enc) == text
    assert tok.decode(enc, skip_special_tokens=True) == "héllo \nwörld"
    assert tok.decode([0xC3]) == "�" and tok.decode([1000]) == "<|1000|>"
    chat = tok.apply_chat_template([{"role": "user", "content": "hi"}])
    assert chat == tok.encode("<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n")
    assert chat[0] == 151644 and tok("\n").input_ids == [10]


# ---- the image processor ---------------------------------------------------

@pytest.mark.parametrize("w,h", SIZES)
def test_expand2square_and_process_images(w, h):
    img = _image(w, h)
    port, ref = ImageProcessor(), JaxIP()
    _equal(np.asarray(port._expand2square(img)), np.asarray(ref._expand2square(img)))
    _equal(port.process_images([img, img.convert("L")]), ref.process_images([img, img.convert("L")]))


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("mode", ["dynamic", "anyres"])
def test_tiling_identical(w, h, mode):
    img = _image(w, h, seed=1)
    port, ref = ImageProcessor(image_size=56), JaxIP(image_size=56)
    assert port._best_grid(w, h) == ref._best_grid(w, h)
    assert port._select_best_resolution((w, h), port.possible_resolutions) == \
        ref._select_best_resolution((w, h), ref.possible_resolutions)
    port.process_type = ref.process_type = mode
    (tiles, grid), (want, want_grid) = (port.process_images_with_subpatch(img),
                                        ref.process_images_with_subpatch(img))
    assert grid == want_grid
    _equal(tiles, want)


def test_tiling_of_a_wide_image():
    tiles, (gw, gh) = ImageProcessor().process_dynamic(_image(1000, 450))
    cols, rows = gw // 448, gh // 448
    assert cols > rows and tiles.shape == (cols * rows + 1, 448, 448, 3)
    assert ImageProcessor().process_dynamic(_image(100, 100))[0].shape[0] == 1


def test_video_frames_from_a_directory_and_a_file(tmp_path):
    """A directory of frames (natural sort, fps subsampling) and a video
    file (OpenCV, uniform frame selection), each under a frame budget."""
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i in range(12):
        _image(80, 60, seed=i).save(frames_dir / f"frame_{i}.png")
    video = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 4.0, (80, 60))
    for i in range(12):
        writer.write(np.asarray(_image(80, 60, seed=i)))
    writer.release()
    port, ref = ImageProcessor(image_size=56), JaxIP(image_size=56)
    for src in (str(frames_dir), video):
        for budget, fps in ((5, 1.0), (64, 4.0)):
            got = port.process_video(src, max_num_frame=budget, max_fps=fps)
            _equal(got, ref.process_video(src, max_num_frame=budget, max_fps=fps))
            assert 1 <= got.shape[0] <= budget
    with pytest.raises(FileNotFoundError):
        port.process_video(str(tmp_path / "missing.mp4"))


# ---- the native feedworker -------------------------------------------------

@pytest.mark.parametrize("h,w", [(448, 448), (720, 1280), (100, 80), (360, 640)])
@pytest.mark.parametrize("precision", ["u8", "float"])
def test_native_matches_jax_library(h, w, precision):
    frames = np.random.default_rng(h + w).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    got = native.preprocess_frames(frames, 448, MEAN, STD, precision=precision)
    _equal(got, jax_native.preprocess_frames(frames, 448, MEAN, STD, precision=precision))


@pytest.mark.parametrize("h,w", [(448, 448), (720, 1280), (100, 80)])
def test_native_u8_gives_pils_pixels(h, w):
    """With mean 0 and std 1 the u8 path's output is pixel / 255: the
    pixels are PIL's uint8 expand2square (black border, the mean colour)
    and bicubic resize, exactly."""
    frames = np.random.default_rng(1).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    got = native.preprocess_frames(frames, 448, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    proc = ImageProcessor(mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0))
    for i in range(2):
        pil = proc._expand2square(Image.fromarray(frames[i])).resize(
            (448, 448), Image.Resampling.BICUBIC
        )
        _equal(np.rint(got[i] * 255).astype(np.uint8), np.asarray(pil))


def test_native_float_matches_float_pil():
    img = np.random.default_rng(3).integers(0, 256, (100, 100, 3), dtype=np.uint8)
    got = native.preprocess_frames(img[None], 448, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                   precision="float")[0]
    want = np.stack([
        np.asarray(Image.fromarray(img[:, :, c].astype(np.float32)).resize(
            (448, 448), Image.Resampling.BICUBIC), np.float32)
        for c in range(3)
    ], axis=-1) / 255.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_native_crop_tiles_and_build():
    img = np.random.default_rng(4).integers(0, 256, (2 * 56, 3 * 56, 3), dtype=np.uint8)
    _equal(native.crop_tiles(img, 2, 3, 56, MEAN, STD),
           jax_native.crop_tiles(img, 2, 3, 56, MEAN, STD))
    lib = native.build()
    assert lib == native.library_path() and lib.is_file()
    assert lib.parent.name == "native" and lib.parent.parent.name == "build"


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed build raises with g++'s message (no PIL fallback)."""
    bad = tmp_path / "preprocess.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building the native preprocessing library failed"):
        native.build()
    assert not any((tmp_path / "build").glob("*.so"))


def test_uniform_frames_take_the_native_path(monkeypatch):
    frames = np.random.default_rng(5).integers(0, 256, (3, 60, 80, 3), dtype=np.uint8)
    want = JaxIP().process_images(list(frames))
    calls = []
    real = native.preprocess_frames
    monkeypatch.setattr(native, "preprocess_frames",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    _equal(ImageProcessor().process_images(list(frames)), want)
    _equal(ImageProcessor().process_images(frames), want)
    assert calls == [(3, 60, 80, 3)] * 2


# ---- tag expansion ---------------------------------------------------------

@pytest.fixture(scope="module")
def mms():
    tok = ByteTokenizer(endoftext=256, im_start=257, im_end=258, first_added=259)
    port = MultimodalTokenizer(tok, image_processor=ImageProcessor(image_size=56),
                               image_token_length=4, max_num_frame=6)
    ref = JaxMM(tok, image_processor=JaxIP(image_size=56), image_token_length=4,
                max_num_frame=6)
    return port, ref


def _same_expansion(got, want):
    assert got.input_ids == want.input_ids
    assert got.labels == want.labels
    if want.images is None:
        assert got.images is None and got.image_indices is None
        return
    _equal(got.images, want.images)
    _equal(got.image_indices, want.image_indices)


def test_special_token_ids_identical(mms):
    port, ref = mms
    for name in ("img_tag", "vid_tag", "img_start", "img_end", "img_ctx", "vid_start",
                 "vid_end", "vid_ctx", "patch_start", "patch_end", "patch_ctx", "nl_tokens"):
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("w,h", SIZES)
def test_expand_images_identical(mms, w, h):
    port, ref = mms
    ids = port.tokenizer("describe <image> and <image> please", add_special_tokens=False).input_ids
    images = [_image(w, h, seed=2), _image(h, w, seed=3)]
    got = port.expand(ids, images=images)
    _same_expansion(got, ref.expand(ids, images=images))
    n_tiles = got.images.shape[0]
    assert got.image_indices.shape == (2, n_tiles, 4)
    assert (np.asarray(got.input_ids)[got.image_indices[1]] != port.img_tag).all()


def test_expand_video_and_labels_identical(mms, tmp_path):
    """A frame list (native path), a frame directory under the request's
    frame budget, an image before them, and training labels."""
    port, ref = mms
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i in range(9):
        _image(72, 40, seed=i).save(frames_dir / f"{i}.jpg")
    frame_list = [np.asarray(_image(80, 60, seed=20 + i)) for i in range(3)]
    text = "<video> then <image> and <video> end"
    ids = port.tokenizer(text, add_special_tokens=False).input_ids
    labels = list(range(len(ids)))
    kw = dict(images=[_image(300, 120, seed=4)], videos=[frame_list, str(frames_dir)],
              labels=labels, max_num_frame=4)
    got = port.expand(ids, **kw)
    _same_expansion(got, ref.expand(ids, **kw))
    assert constants.IGNORE_INDEX in got.labels and len(got.labels) == len(got.input_ids)
    no_budget = dict(kw, max_num_frame=None)
    _same_expansion(port.expand(ids, **no_budget), ref.expand(ids, **no_budget))


def test_expand_text_only_and_chat(mms):
    port, ref = mms
    ids = port.tokenizer("no media here", add_special_tokens=False).input_ids
    _same_expansion(port.expand(ids), ref.expand(ids))
    msgs = [{"role": "user", "content": "<image>\nwhat is it?"}]
    assert port.encode_chat(msgs) == ref.encode_chat(msgs)
    assert port.encode_chat(msgs, add_generation_prompt=False) == \
        ref.encode_chat(msgs, add_generation_prompt=False)
    with pytest.raises(ValueError, match="tags"):
        port.expand(port.encode_chat(msgs))  # a tag without its image


def test_frontend_needs_no_pil_for_frames(tmp_path):
    """Decoded uint8 frames expand through the native path; the module
    imports PIL only in the functions that open or resize with it."""
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['PIL'] = None; sys.modules['cv2'] = None\n"
        "import numpy as np\n"
        "from long_vita_tpu_torch.data.image_processor import ImageProcessor\n"
        "from long_vita_tpu_torch.data.multimodal import MultimodalTokenizer\n"
        "from long_vita_tpu_torch.tokenizer import ByteTokenizer\n"
        "mm = MultimodalTokenizer(ByteTokenizer(), image_processor=ImageProcessor(image_size=56),"
        " image_token_length=4)\n"
        "f = np.zeros((2, 36, 64, 3), np.uint8)\n"
        "e = mm.expand(mm.encode_chat([{'role': 'user', 'content': '<video>'}]), videos=[f])\n"
        "assert e.images.shape == (2, 56, 56, 3), e.images.shape\n"
        "print('OK')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": root})
    assert res.returncode == 0 and res.stdout.strip() == "OK", res.stderr
