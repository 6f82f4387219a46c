"""The operation and byte counts against values worked by hand at the
published widths."""
from __future__ import annotations

import pytest

from portbench import harness, roofline
from portbench.weights import dims

N14 = dims(harness.named("configs", "long-vita-14b"))
N72 = dims(harness.named("configs", "long-vita-72b-stage"))


def test_widths():
    assert (N14["h"], N14["hq"], N14["hkv"], N14["d"], N14["i"], N14["l"]) == \
        (5120, 40, 8, 128, 13824, 48)
    assert (N72["h"], N72["hq"], N72["hkv"], N72["d"], N72["i"], N72["l"]) == \
        (8192, 64, 8, 128, 29568, 10)
    assert (N14["vh"], N14["vheads"], N14["vd"], N14["grid"], N14["shuffle"]) == \
        (1024, 16, 64, 32, 4)


def test_causal_attention_chunk():
    # rows 2048..4095 against keys 0..row: 2048 * 2048 + 2048 * 2049 / 2 pairs
    pairs = 2048 * 2048 + 2048 * 2049 // 2
    assert roofline.pairs_causal(2048, 4096) == pairs
    flops, nbytes = roofline.attn_fwd(N14, 2048, 4096)
    assert flops == 4 * 40 * 128 * pairs
    assert nbytes == 2 * 128 * (2 * 2048 * 40 + 2 * 4096 * 8)
    assert roofline.bound_s(flops, nbytes) == pytest.approx(flops / 989e12)


def test_backward_and_tower():
    flops, nbytes = roofline.attn_bwd(N72, 500)
    assert flops == 8 * 64 * 128 * (500 * 501 // 2)
    assert nbytes == 2 * 128 * 500 * (4 * 64 + 4 * 8)
    flops, nbytes = roofline.vit_attn(N14, 3)
    assert flops == 4 * 16 * 64 * 1025 * 1025 * 3 * 24
    assert nbytes == 2 * 4 * 1025 * 1024 * 3 * 24


def test_weight_counts():
    # Qwen2.5-14B: 48 layers of 5120*5120*2 + 2*5120*1024 + 3*5120*13824 = 13.21 B
    assert roofline.layer_weights(N14) * 48 == 13_212_057_600
    assert roofline.layer_weights(N72) == 877_658_112
    # InternViT-300M: 24 * (4 * 1024^2 + 2 * 1024 * 4096) + 1024 * 588
    assert roofline.vit_weights(N14) == 24 * (4 * 1024**2 + 2 * 1024 * 4096) + 1024 * 588
    assert roofline.projector_weights(N14) == 4096 * 1024 + 1024 * 5120


def test_serve_and_train_flops():
    # a text prompt of 1000 ids, one answer token: 2 a weight a token, causal
    # attention over the prompt, the head once
    want = 2 * 48 * roofline.layer_weights(N14) * 1000 + 48 * 4 * 40 * 128 * (1000 * 1001 // 2) \
        + 2 * 5120 * 152064
    assert roofline.serve_flops(N14, 1000, 0, 1) == want
    segs = [(0, 300), (300, 800)]
    got = roofline.train_flops(N72, segs, 400, 2)
    attn = sum(roofline.attn_fwd(N72, 0, n)[0] + roofline.attn_bwd(N72, n)[0] for n in (300, 500))
    want = (roofline.tower_flops(N72, 2) - 2 * roofline.projector_weights(N72) * 256 * 2
            + 6 * roofline.projector_weights(N72) * 256 * 2
            + 4 * 10 * roofline.layer_weights(N72) * 800 + 10 * attn + 4 * 8192 * 152064 * 400)
    assert got == pytest.approx(want, rel=1e-12)
