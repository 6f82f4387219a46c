"""PyTorch port: chip_smoke.phase_ep_train rehearsed on the CPU at
tiny_test_config() (bf16 weights, 8 experts top-2 with nothing dropped, two
decoder layers, 512-token rows): the dp-1 reference in a process of its
own, then expert parallelism at dp 2 in two gloo processes (and dp 2 x tp 2
in four) through the Trainer, each rank routed as the reference routed its
row, two steps (the warm-up's lr-0 step, then one at lr 1e-5). Every gate
must hold, and the three planted faults (the expert gradients summed over
dp as if replicated; grad_norm counting them as if replicated over dp; the
aux summed over dp in the reported loss) must fail theirs."""
import re

import pytest

from long_vita_tpu_torch.config import tiny_test_config
from test_torch_cp_gate import chip_smoke  # noqa: F401 (a fixture)


@pytest.mark.parametrize("tp", [1, 2])
def test_ep_train_phase_rehearsal(chip_smoke, capsys, tp):
    """tp 1: two processes (the phase on one card); tp 2: four, dp 2 x tp 2
    (the phase's four-card NCCL geometry)."""
    out = chip_smoke.phase_ep_train(backend="gloo", device="cpu", tp=tp, base=tiny_test_config(),
                                    seq=512, budget=128, answer=8, text_sup=8)
    text = capsys.readouterr().out
    assert "FAIL" not in text
    for gate in ("in the reference or on any EP rank: ok",
                 "every EP rank reports the same loss bits: ok",
                 "summed over dp as if replicated (a planted fault; layer 0's gate stack) must "
                 "fail",
                 "counted as if replicated over dp (a planted fault) must fail",
                 "the experts' part of grad_norm",
                 "leaves every leaf's bits on every rank: ok",
                 "the aux summed over dp, not averaged (a planted fault) must fail",
                 "each rank holds exactly its share of the expert bytes"):
        assert gate in text, gate
    geom = "EP dp 2 x tp 2" if tp > 1 else "EP dp 2"
    assert re.search(rf"{geom} losses .* of the dp-1 reference's .*: ok", text)
    assert re.search(r"cosine by group \(>= 0.99\): .*experts .*router .*: ok", text)
    assert re.search(r"the EP aux .* of the rows' own Switch losses .*: ok", text)
    assert re.search(r"no copy dropped \(capacity factor E / k in the reference; [0-9.]+ on the "
                     r"EP ranks", text)
    assert re.search(r"the aux term of the EP loss, .* x the rows' own mean, .*: ok", text)
    assert re.search(r"every expert stack and router moved on every rank .*: ok", text)
    assert all(v == 0 for v in out["counts"].values())
