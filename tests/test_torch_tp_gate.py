"""PyTorch port: chip_smoke.phase_tp_serve rehearsed on the CPU at
tiny_test_config() in bf16 (the phase's gates at a size that runs here):
the tp-4 engine of thread-ranks against the one-device engine,
teacher-forced under §2's logit gate, with bf16, int8 (into an int8
cache) and int4 weights and a 4-tile image; the same over 2-D tp (tp 2 x
tq 2, and tp 2 alone on the prompt), cp 2 x tq 2, and RMSNorm without its
tq sum (a planted fault) failing the logit gate; the lockstep server on tp 4
thread-ranks with gates (a) and (b); cp 2 x tp 2 on one layer; every
launch count (zero here: the kernels' plain versions run on the CPU, and
the count of K6's dequantise route is checked exactly). torch.cuda's
synchronize and memory calls are stubbed; the kernel checks at the shard
shapes need the card and are not part of the rehearsal."""
import dataclasses
import re

import pytest
import torch

from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.models.qwen2 import init_qwen2_params
from long_vita_tpu_torch.tokenizer import ByteTokenizer
from test_torch_cp_gate import chip_smoke  # noqa: F401 (a fixture)
from test_torch_quantize import one_torch_thread  # noqa: F401


@pytest.fixture()
def no_cuda_calls(monkeypatch):
    for name, value in (("synchronize", None), ("reset_peak_memory_stats", None),
                        ("empty_cache", None), ("max_memory_allocated", 0),
                        ("memory_allocated", 0)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _v=value, **k: _v)


def test_tp_serve_phase_rehearsal(chip_smoke, no_cuda_calls, one_torch_thread, capsys,
                                  monkeypatch):
    checked = []  # (launches, expected): the CPU launches no kernel, so only K6's
    # dequantise route (a torch.matmul) is counted here
    monkeypatch.setattr(chip_smoke, "_check_launches", lambda c, e: checked.append((c, e)))
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, eos_token_id=256))
    params = init_qwen2_params(torch.Generator().manual_seed(0), cfg.text, torch.bfloat16)
    for p in params.parameters():
        p.data.mul_(4)  # wider weights: greedy runs do not fall into loops
    counts = chip_smoke.phase_tp_serve(
        params, cfg, torch.device("cpu"), chunk=64, n_prompt=150, seq=512, new_tokens=6,
        short_tokens=3, vision_chunk=2, server_chars=(150, 90), server_image=(168, 56),
        server_tokens=5, cpxtp_layers=1, cpxtp_prompt=200, cpxtp_seq=512,
        tokenizer=ByteTokenizer(endoftext=256, im_start=257, im_end=258, first_added=259))
    out = capsys.readouterr().out
    assert "FAIL" not in out
    for tag in ("tp-serve bf16", "tp-serve int8 weights, int8 cache", "tp-serve int4 weights",
                "tp-serve image", "tp-serve cp 2 x tp 2", "tq-serve tp 2 (for the time)",
                "tq-serve tp 2 x tq 2 bf16", "tq-serve tp 2 x tq 2 int8 weights, int8 cache",
                "tq-serve tp 2 x tq 2 int4 weights", "tq-serve tp 2 x tq 2 image",
                "tq-serve cp 2 x tq 2"):
        assert re.search(rf"\[{re.escape(tag)}\] \d+ steps, the one-device engine fed the mesh "
                         r"engine's tokens", out), tag
    # K1 4 ranks x 2 layers x 3 chunks; K2 likewise; the K3 batches of a
    # rank's tile (4 tiles over 4 ranks); the server's and the replay's K1
    expected = [e for _, e in checked]
    assert expected[0] == {"flash_fwd": 24} and expected[1] == {"flash_fwd_quant": 24}
    assert expected[3]["short_attn"] == 4 * cfg.vision.num_hidden_layers
    # int4: the tiny geometry's products all take K6's dequantise route (its
    # 64-wide inputs tile no 128-row group), so the route counts the phase's
    # K6 launches too: 4 ranks x (7 x 2 projections x 3 prefill chunks, then
    # 15 products a pass for the last row and 2 decode steps)
    c4, e4 = checked[2]
    assert e4["w4_dequant"] == 4 * 7 * 2 * 3 and e4["w4_matmul"] == 4 * 15 * 3
    assert c4["w4_dequant"] == e4["w4_dequant"] + e4["w4_matmul"]
    # 2-D tp: tp 2 (2 ranks) and tp 2 x tq 2 (4) on the prompt, int8, int4
    # (every projection K6 or its dequantise route on each of the 4 ranks),
    # the image (5 tiles over 4 ranks: 2 a rank, one K3 batch of 2), cp 2 x
    # tq 2; the planted fault's run stops at the logit gate
    assert expected[4:7] == [{"flash_fwd": 12}, {"flash_fwd": 24}, {"flash_fwd_quant": 24}]
    c7, e7 = checked[7]
    assert e7["w4_dequant"] == 4 * 7 * 2 * 3 and e7["w4_matmul"] == 4 * 15 * 3
    assert c7["w4_dequant"] == e7["w4_dequant"] + e7["w4_matmul"]
    assert expected[8]["short_attn"] == 4 * cfg.vision.num_hidden_layers
    assert expected[9] == {"flash_fwd": 24}
    assert re.search(r"\[tq-serve\] the logit gate with RMSNorm's tq sum of squares removed \(a "
                     r"planted fault\) must fail: .*disagree.*: ok", out)
    assert [c["w4_dequant"] for i, (c, _) in enumerate(checked) if i not in (2, 7)] == [0] * 10
    assert "[tp-server] (a) lockstep: each of 3 followers replayed rank 0's 3 pool" in out
    assert "(b) each HTTP answer equals the in-process pool's row of the same admission" in out
    assert counts["w4_dequant"] == c4["w4_dequant"] + c7["w4_dequant"]
    assert all(counts[k] == 0 for k in chip_smoke.SOURCES)


def test_tp_train_phase_rehearsal(chip_smoke, capsys):
    """chip_smoke.phase_tp_train rehearsed on the CPU (bf16 weights, the
    tiny configuration's two layers, 511 tokens, which do not split over tp
    as the full run's 16383 do not): the tp-1 reference in a process of
    its own, then tp 2 in two gloo processes through
    train.build_from_recipe and Trainer.train, each rank reading its slices
    of the checkpoint directory the phase writes. Every gate must hold,
    the planted fault (the norms' tp sum removed) must fail the gradient
    gate, and the tp-2 ranks must read less than the whole checkpoint."""
    out = chip_smoke.phase_tp_train(
        backend="gloo", device="cpu", cfg=tiny_test_config(), layers=2, seq=512, budget=128,
        fault_seq=256, steps=2, answer=8, text_sup=8, kernels=False,
        first_special=256)
    text = capsys.readouterr().out
    assert "FAIL" not in text
    for gate in ("both tp ranks report the same loss bits: ok",
                 "must fail: final_norm", "leaves every leaf's bits on every rank (stage 2 "
                 "freezes no leaf): ok"):
        assert gate in text, gate
    assert re.search(r"tp 2 losses .* of tp 1's .*: ok", text)
    assert re.search(r"cosine by group \(>= 0.99\): .*: ok", text)
    read = [float(x) for x in re.findall(r"read (\d+\.\d+) MB of the checkpoint", text)]
    whole = float(re.search(r"the checkpoint's (\d+\.\d+) MB", text)[1])
    assert len(read) == 2 and all(0 < r < whole for r in read)
    assert all(v == 0 for v in out["counts"].values())
