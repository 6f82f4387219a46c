"""PyTorch port: chip_smoke.phase_pp_train rehearsed on the CPU at
tiny_test_config() (bf16 weights, four decoder layers, 512-token rows): the
reference without pp in a process of its own, then pp 2 in two gloo
processes (and pp 2 x tp 2 in four) through train.build_from_recipe and
Trainer.train, GPipe and then the interleaved schedule, each stage reading
its layers of the checkpoint directory the phase writes. Every gate must
hold, and the three planted faults (the shift's backward sending zeros
upstream; grad_norm without its pp sum of squares; the shared leaves'
gradients summed within a stage only) must fail theirs."""
import re

import pytest

from long_vita_tpu_torch.config import tiny_test_config
from test_torch_cp_gate import chip_smoke  # noqa: F401 (a fixture)


@pytest.mark.parametrize("tp", [1, 2])
def test_pp_train_phase_rehearsal(chip_smoke, capsys, tp):
    """tp 1: two processes (the phase on one card); tp 2: four, pp 2 x tp 2
    (the phase's four-card NCCL geometry)."""
    out = chip_smoke.phase_pp_train(
        backend="gloo", device="cpu", tp=tp, cfg=tiny_test_config(), layers=4, seq=512,
        budget=128, fault_seq=256, steps=2, answer=8, text_sup=8, kernels=False,
        first_special=256)
    text = capsys.readouterr().out
    assert "FAIL" not in text
    for name in ("GPipe", "interleaved (virtual_pp 2)"):
        for gate in ("every rank reports the same loss and grad_norm bits: ok",
                     "holds the same bits on every stage (of a tp index: its tp slice): ok",
                     "leaves every leaf's bits on every rank: ok",
                     "the projector alone moved, every frozen leaf keeps its bits",
                     "sending zeros upstream (a planted fault"):
            assert re.search(rf"{re.escape(name)}: .*{re.escape(gate)}", text), (name, gate)
        geom = "pp 2 x tp 2" if tp > 1 else "pp 2"
        assert re.search(rf"{re.escape(name)} {geom} losses .* of the reference's .*: ok", text)
        assert re.search(rf"{re.escape(name)}: the first step's projector gradient .*: ok", text)
        assert len(re.findall(rf"{re.escape(name)}: rank .* holds and read its stage's share "
                              r"exactly.*: ok", text)) == 2 * tp
    assert "with the norm's pp sum of squares removed (a planted fault) must fail" in text
    assert "summed within a stage only (a planted fault) must fail: ok" in text
    assert all(v == 0 for v in out["counts"].values())
