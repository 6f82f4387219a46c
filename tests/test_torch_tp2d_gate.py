"""PyTorch port: chip_smoke.phase_tp_train's 2-D tp geometry rehearsed on
the CPU at tiny_test_config() (bf16 weights, two decoder layers, 512
tokens): the tp-1 reference in a process of its own, tp 2 in two gloo
processes, then tp 2 x tq 2 in four from the same checkpoint directory
against the same reference, one step each (the full run's), through train.build_from_recipe and
Trainer.train, each rank reading only its blocks of the directory. Every
gate must hold, and the planted faults (the norms' tp sum removed; over tq
their tq sum) must fail the gradient gate."""
import re

from long_vita_tpu_torch.config import tiny_test_config
from test_torch_cp_gate import chip_smoke  # noqa: F401 (a fixture)


def test_tp2d_train_phase_rehearsal(chip_smoke, capsys):
    out = chip_smoke.phase_tp_train(
        backend="gloo", device="cpu", cfg=tiny_test_config(), layers=2, seq=512, budget=128,
        fault_seq=256, steps=1, answer=8, text_sup=8, kernels=False, tq=2,
        first_special=256)
    text = capsys.readouterr().out
    assert "FAIL" not in text
    for gate in ("both tp ranks report the same loss bits: ok",
                 "all 4 ranks of tp 2 x tq 2 report the same loss bits: ok",
                 "the norms' tp sum removed (a planted fault; a 256-token row) must fail: "
                 "final_norm",
                 "the norms' tq sum removed (a planted fault; a 256-token row) must fail: "
                 "final_norm"):
        assert gate in text, gate
    assert len(re.findall(r"leaves every leaf's bits on every rank \(stage 2 freezes no "
                          r"leaf\): ok", text)) == 2
    for geom in ("tp 2", "tp 2 x tq 2"):
        assert re.search(rf"\] {geom} losses .* of tp 1's .*: ok", text), geom
        assert re.search(rf"of the {geom} shards vs tp 1's, cosine by group \(>= 0.99\): .*: ok",
                         text), geom
    # a tq rank reads a quarter of the decoder's weights (and the tower
    # whole): less than a tp-2 rank, which reads less than the whole
    read = [float(x) for x in re.findall(r"read (\d+\.\d+) MB of the checkpoint", text)]
    whole = float(re.search(r"the checkpoint's (\d+\.\d+) MB", text)[1])
    assert len(read) == 6 and all(0 < r < whole for r in read)
    assert max(read[2:]) < min(read[:2])
    assert all(v == 0 for v in out["counts"].values())
