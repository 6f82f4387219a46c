"""PyTorch port: chip_smoke.py's gate on a cp attention's forward, and its
NCCL phase rehearsed over gloo on the CPU.

chip_smoke.cp_forward_check holds o elementwise to CP_O_RMS_FRAC (0.1) x
RMS(ref) + O_RTOL (1e-2) x |ref| and the merged lse to LSE_ATOL (1e-3). At
64K causal tokens |o| is ~0.01 over most rows, where the bound the NCCL
phase used before, O_ATOL + O_RTOL x max|ref| (~1e-2 absolute), passes an
output that is off by half its own RMS: the test builds such an output and
shows the old bound passing it and the gate rejecting it. Then
phase_cp_nccl(force=True, device="cpu") runs its two workers over gloo at a
tiny size (ring attention forward and backward against the whole-sequence
attention, with each rank's shard of o and merged lse through the gate, two
Trainer steps at cp 2 against cp 1, and the lockstep server: rank 0 answers
HTTP, rank 1 replays it, and both ranks' in-process pools give the HTTP
answers' bits).
"""
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    if str(ROOT) not in sys.path:  # the gloo workers import chip_smoke by name
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def _long_row_output(seed=0):
    """o of a long causal row: ~N(0, 0.01^2) entries, as K1 gives at 64K."""
    gen = torch.Generator().manual_seed(seed)
    ref = 0.01 * torch.randn(1, 4096, 8, 64, generator=gen)
    lse = 10.0 + torch.randn(1, 8, 4096, generator=gen)
    return ref, lse


def test_gate_rejects_an_output_off_by_half_its_rms(chip_smoke):
    ref, lse = _long_row_output()
    rms = ref.square().mean().sqrt()
    wrong = ref + 0.5 * rms
    old_bound = chip_smoke.O_ATOL + chip_smoke.O_RTOL * ref.abs().max()
    assert (wrong - ref).abs().max() <= old_bound  # the old NCCL bound passed it
    c = chip_smoke.cp_forward_check(wrong, ref, lse, lse)
    assert not c["ok"] and c["worst"] > 1
    assert c["atol"] == pytest.approx(chip_smoke.CP_O_RMS_FRAC * rms.item())


def test_gate_passes_rounding_and_holds_the_lse(chip_smoke):
    ref, lse = _long_row_output(1)
    rounded = ref.to(torch.bfloat16)  # a bf16 rounding of the right answer
    c = chip_smoke.cp_forward_check(rounded, ref, lse + 5e-4, lse)
    assert c["ok"] and c["worst"] < 0.1 and c["lse_err"] == pytest.approx(5e-4, rel=1e-3)
    assert not chip_smoke.cp_forward_check(rounded, ref, lse + 2e-3, lse)["ok"]
    nan = rounded.clone()
    nan[0, 0, 0, 0] = float("nan")
    assert not chip_smoke.cp_forward_check(nan, ref, lse, lse)["ok"]
    # one rank's shard is held with the whole reference's RMS
    half = chip_smoke.cp_forward_check(rounded[:, :2048], ref[:, :2048], lse[..., :2048],
                                       lse[..., :2048], rms=1.0)
    assert half["atol"] == pytest.approx(chip_smoke.CP_O_RMS_FRAC)


def test_nccl_phase_rehearsal_over_gloo(chip_smoke, capsys):
    chip_smoke.phase_cp_nccl(force=True, device="cpu", seq=512, heads=(4, 2), d=16, layers=1,
                             train_seq=256, budget=256, answer=20, server_seq=512,
                             server_chunk=64, server_chars=(150, 90), server_image=(168, 56),
                             server_tokens=5, server_tok=dict(endoftext=256, im_start=257,
                                                              im_end=258, first_added=259),
                             ttft_prompt=300, ttft_seq=512)
    out = capsys.readouterr().out
    assert out.count("merged lse max|err|") == 2 and "FAIL" not in out
    # the lockstep server at cp 2 over the two processes: gates (a) and (b)
    assert "[cp-nccl server] (a) lockstep: each of 1 followers replayed rank 0's 3 pool" in out
    assert "(b) each HTTP answer equals the in-process pool's row" in out
    # and with the engine over tp 2, then the tp TTFT against one process
    assert "[tp-nccl server] (a) lockstep: each of 1 followers replayed rank 0's 3 pool" in out
    assert "[tp-nccl] 300-id prompt on the 1-layer model at full width: TTFT tp 2" in out
    assert '"phase": "cp_nccl", "ran": true' in out
