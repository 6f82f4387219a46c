"""PyTorch port: chip_smoke.phase_orbax rehearsed on the CPU at
tiny_test_config() (bf16 weights, 256-token packs with images): the
training entry point, reading the Qwen2 tokenizer fixture from the
checkpoint directory (cut to 400 BPE entries so that its ids fit the
512-entry vocabulary), writes an orbax store a step, a second
build_from_recipe resumes step 1's store bit for bit (and its step-2 loss
the uninterrupted run's), restore_params_only
into tp rank 0's tree reads exactly its slices, and the JAX-written
fixture decodes; every gate holds."""
from long_vita_tpu_torch.config import tiny_test_config
from test_torch_cp_gate import chip_smoke  # noqa: F401 (a fixture)


def test_orbax_phase_rehearsal(chip_smoke, capsys):
    counts = chip_smoke.phase_orbax(
        device="cpu", cfg=tiny_test_config(), seq_len=256, budget=128, vision_chunk=2,
        first_special=400, n_docs=4, doc_ids=300, n_captions=4, n_chat=4, chat_ids=60)
    text = capsys.readouterr().out
    assert "FAIL" not in text
    for gate in ("the resumed state equals step 1's bit for bit on the cpu",
                 "the tp-2 shard holds step 1's slices bit for bit",
                 "the JAX-written fixture (OCDBT, zstd) decodes bit for bit",
                 "the resumed run's step-2 loss equals the uninterrupted run's bits",
                 "3 stores written (2 saves of a step already held skipped), one resume"):
        assert f"{gate}" in text and text.split(gate, 1)[1].split("\n", 1)[0].endswith(": ok"), gate
    assert "(the same bits: True)" in text
    assert all(v == 0 for v in counts.values())
