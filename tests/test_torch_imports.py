"""PyTorch port: it imports and serves text, media and int4 weights with JAX,
the JAX package and PIL unavailable, and chip_smoke.py refuses to run
without a GPU."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "long_vita_tpu_torch"

_NO_JAX_GENERATE = """
import dataclasses, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["long_vita_tpu"] = None  # nor may anything of the JAX package load
sys.modules["PIL"] = None  # nor may the media path need PIL
import numpy as np, torch
import long_vita_tpu_torch
from long_vita_tpu_torch import constants
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.inference import prefix_cache, speculative
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.models import intern_vit, long_vita, projector, quantize
from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.models.qwen2 import QuantDense4, init_qwen2_params
from long_vita_tpu_torch.ops import _build, _target, attention, flash_attention, quant_matmul, rope
from long_vita_tpu_torch.training import loss, optimizer, train_step, trainer
from long_vita_tpu_torch.utils import convert

class Tok:
    def decode(self, ids, skip_special_tokens=True):
        return ",".join(map(str, ids))

class MM:
    tokenizer = Tok()
    def expand(self, input_ids, images=(), videos=(), max_num_frame=None):
        class E:
            pass
        e = E()
        e.input_ids, e.images, e.image_indices = list(input_ids), None, None
        if len(videos):  # one 4-token frame block per frame, after the prompt
            frames = np.asarray(videos[0])
            n, t = len(frames), 4
            e.image_indices = np.stack([
                np.zeros((n, t), np.int64),
                len(e.input_ids) + np.arange(n * t).reshape(n, t),
            ])
            e.input_ids += [7] * (n * t) + [8, 9]
            e.images = frames
        return e

cfg = tiny_test_config()
params = init_qwen2_params(torch.Generator().manual_seed(0), cfg.text)
eng = InferenceEngine(params, cfg, MM(), max_seq_len=128, chunk=32)
out = eng.generate(input_ids=list(range(45)), sampling=SamplingParams(max_new_tokens=5))
assert len(out.token_ids) == 5, out
vlm = init_long_vita_params(torch.Generator().manual_seed(1), cfg)
eng = InferenceEngine(vlm, cfg, MM(), max_seq_len=128, chunk=32, kv_quant=True)
frames = np.random.default_rng(0).standard_normal((3, 56, 56, 3)).astype(np.float32)
media = eng.generate(input_ids=list(range(30)), videos=[frames], sampling=SamplingParams(max_new_tokens=5))
assert len(media.token_ids) == 5 and media.prompt_tokens == 44, media
# int4 weights at 128-row groups (K6's route, its plain version on the CPU)
# with prompt-lookup speculative decoding
g128 = dataclasses.replace(cfg, text=dataclasses.replace(
    cfg.text, hidden_size=256, intermediate_size=512, vocab_size=512))
p4 = init_qwen2_params(torch.Generator().manual_seed(2), g128.text)
eng = InferenceEngine(p4, g128, MM(), max_seq_len=128, chunk=32, weight_quant="int4",
                      speculative_k=4)
assert isinstance(eng.text.layers[0].q_proj, QuantDense4)
spec = eng.generate(input_ids=list(range(20)) * 2, sampling=SamplingParams(max_new_tokens=6))
assert len(spec.token_ids) == 6 and eng._spec_steps > 0, spec
loaded = [m for m, v in sys.modules.items() if v is not None]
assert not any(m == "jax" or m.startswith("jax.") for m in loaded)
assert not any(m == "long_vita_tpu" or m.startswith("long_vita_tpu.") for m in loaded)
assert not any(m.startswith(("PIL", "long_vita_tpu.data")) for m in loaded)
print("OK", out.text, media.text)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return env


def test_port_imports_and_generates_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX_GENERATE], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK ")


def test_no_jax_import_in_the_port():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert len(files) > 10 and not offenders, offenders


def test_no_jax_package_import_in_the_port():
    """No module of the port and not chip_smoke.py imports the JAX package
    (`long_vita_tpu`, any submodule): only `long_vita_tpu_torch`."""
    pat = re.compile(r"^\s*(import|from)\s+long_vita_tpu\b(?!_torch)", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert len(files) > 10 and not offenders, offenders
    assert pat.search("from long_vita_tpu.config import TextConfig")
    assert pat.search("import long_vita_tpu")
    assert not pat.search("from long_vita_tpu_torch.config import TextConfig")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    """With no CUDA device (this machine), or copied away from the repo,
    chip_smoke.py exits non-zero and prints no result line."""
    import torch

    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    env = _env()
    if alone:
        cwd = tmp_path
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
        env.pop("PYTHONPATH")
    res = subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
