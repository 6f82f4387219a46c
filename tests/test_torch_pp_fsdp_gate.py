"""PyTorch port: chip_smoke.phase_pp_fsdp_train rehearsed on the CPU at
tiny_test_config() (bf16 weights, four decoder layers, 512-token rows): the
reference without pp or FSDP in a process of its own, then dp 2 x pp 2 with
FSDP in four gloo processes through train.build_from_recipe and
Trainer.train, GPipe and then the interleaved schedule, each rank reading
its stage's layers and of them its dp pieces of the checkpoint directory
the phase writes. Every gate must hold (the gather, regather and scatter
counts of parallel/fsdp.step_counts, one unit alive, the bytes held and
read), and the two planted faults (the reduce-scatter replaced by each
rank's own slice inside a stage; grad_norm without its dp sum of squares)
must fail theirs."""
import re

from long_vita_tpu_torch.config import tiny_test_config
from test_torch_cp_gate import chip_smoke  # noqa: F401 (a fixture)


def test_pp_fsdp_train_phase_rehearsal(chip_smoke, capsys):
    out = chip_smoke.phase_pp_fsdp_train(
        backend="gloo", device="cpu", cfg=tiny_test_config(), layers=4, seq=512, budget=128,
        steps=1, answer=8, text_sup=8,
        first_special=256)
    text = capsys.readouterr().out
    assert "FAIL" not in text
    for name in ("GPipe", "interleaved (virtual_pp 2)"):
        for gate in ("every rank reports the same loss and grad_norm bits: ok",
                     "holds the same bits on every rank that holds it",
                     "leaves every leaf's bits on every rank: ok"):
            assert re.search(rf"{re.escape(name)}: .*{re.escape(gate)}", text), (name, gate)
        assert re.search(rf"{re.escape(name)} dp 2 x pp 2 FSDP losses .* of the reference's "
                         r".*: ok", text)
        assert re.search(rf"{re.escape(name)}: the first step's gradients of the stages' dp "
                         r"shards vs the reference's, cosine by group .*: ok", text)
        assert len(re.findall(rf"{re.escape(name)}: rank .* holds and read its stage's 1/dp "
                              r"share exactly.*: ok", text)) == 4
        assert len(re.findall(rf"{re.escape(name)}: rank .* gathers, regathers and "
                              r"reduce-scatters a step .*: ok", text)) == 4
    assert re.search(r"reduce-scatter replaced by each rank's slice of its own gradient inside "
                     r"a stage \(a planted fault\) must fail: .*: ok", text)
    assert "dp sum of squares removed (a planted fault) must fail on every rank" in text
    assert all(v == 0 for v in out["counts"].values())
    assert out["gathered_gb"] > 0
