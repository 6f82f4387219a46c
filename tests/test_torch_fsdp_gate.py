"""PyTorch port: chip_smoke.phase_fsdp_train rehearsed on the CPU at
tiny_test_config() (bf16 weights, two decoder layers, 512-token rows): the
reference without FSDP in a process of its own, then dp 2 with FSDP in two
gloo processes through train.build_from_recipe and Trainer.train, each rank
reading its pieces of the checkpoint directory the phase writes (and dp 2 x
tp 2 in four). Every gate
must hold, and both planted faults (grad_norm without its dp sum of
squares; the reduce-scatter replaced by the rank's own slice) must fail
theirs."""
import re

import pytest

from long_vita_tpu_torch.config import tiny_test_config
from test_torch_cp_gate import chip_smoke  # noqa: F401 (a fixture)


@pytest.mark.parametrize("tp", [1, 2])
def test_fsdp_train_phase_rehearsal(chip_smoke, capsys, tp):
    """tp 1: two processes (the phase on one card); tp 2: four, dp 2 x tp 2
    (the phase's four-card NCCL geometry)."""
    out = chip_smoke.phase_fsdp_train(
        backend="gloo", device="cpu", tp=tp, cfg=tiny_test_config(), layers=2, seq=512,
        budget=128,
        fault_seq=256, steps=2, answer=8, text_sup=8, kernels=False,
        first_special=256)
    text = capsys.readouterr().out
    assert "FAIL" not in text
    for gate in ("every rank reports the same loss bits: ok",
                 "the decoder's grad_norm gate with the norm's dp sum of squares removed (a planted "
                 "fault) must fail",
                 "replaced by each rank's slice of its own gradient",
                 "leaves every leaf's bits on every rank (stage 2 freezes no leaf): ok",
                 "each rank's resident parameters, gradients and Adam moments are its shards' "
                 "bytes exactly",
                 "each rank read its pieces of the decoder and the tower and projector whole"):
        assert gate in text, gate
    geom = "dp 2 x tp 2" if tp > 1 else "dp 2"
    assert re.search(rf"{geom} FSDP losses .* of the reference's .*: ok", text)
    assert re.search(r"cosine by group \(>= 0.99\): .*: ok", text)
    assert re.search(r"at most 1 unit\(s\) of whole weights alive", text)
    assert all(v == 0 for v in out["counts"].values())
