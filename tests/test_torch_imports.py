"""PyTorch port: it imports and serves text, media and int4 weights with JAX,
the JAX package and PIL unavailable; its serving entry points (checkpoint
I/O, front end, server, client, CLI) need none of JAX, PIL, OpenCV,
transformers, safetensors or requests; its training entry point (the YAML
recipe, the data modules, LoRA, metrics) needs none of JAX, optax, PIL,
OpenCV, transformers or safetensors; the generic towers and their loaders,
local MoE, the forward-kernel lab and eval/ need none of JAX, PIL,
transformers, safetensors or requests; and chip_smoke.py refuses to run
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


_NO_JAX_SERVE = """
import sys, tempfile, threading
for name in ("jax", "long_vita_tpu", "PIL", "cv2", "transformers", "safetensors", "requests"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np, torch
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.data import image_processor, multimodal, native
from long_vita_tpu_torch.inference import beam_search, cli, client, continuous, server
from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.tokenizer import ByteTokenizer
from long_vita_tpu_torch.utils import checkpoint_io, export_hf, graft

cfg = tiny_test_config()
ckpt = tempfile.mkdtemp()
export_hf.save_hf_checkpoint(init_long_vita_params(torch.Generator().manual_seed(0), cfg), cfg, ckpt)
params, _ = checkpoint_io.load_long_vita_checkpoint(ckpt, cfg, dtype=torch.float32, device="cpu")
mm = multimodal.MultimodalTokenizer(
    ByteTokenizer(endoftext=256, im_start=257, im_end=258, first_added=259),
    image_processor=image_processor.ImageProcessor(image_size=56), image_token_length=4)
from long_vita_tpu_torch.inference.engine import InferenceEngine
eng = InferenceEngine(params, cfg, mm, max_seq_len=256, chunk=32, cache_dtype=torch.float32)
frames = np.zeros((2, 36, 64, 3), np.uint8)  # decoded video frames: the native path
ids = mm.encode_chat([{"role": "user", "content": "<video> what?"}])
from long_vita_tpu_torch.inference.sampler import SamplingParams
media = eng.generate(input_ids=ids, videos=[frames], sampling=SamplingParams(max_new_tokens=3))
assert media.prompt_tokens == len(ids) - 1 + 2 * 6, media
srv = server.make_server(eng, "127.0.0.1", 0, continuous=True, max_batch=2, tick=4)
t = threading.Thread(target=srv.serve_forever, daemon=True)
t.start()
url = f"http://127.0.0.1:{srv.server_address[1]}/api"
text = client.generate("hello", url=url, tokens_to_generate=4, timeout=120)
assert "".join(client.generate_stream("hello", url=url, tokens_to_generate=4, timeout=120)) == text
hyps = beam_search.beam_search(eng, ids[:8], beam_size=2, max_new_tokens=3, num_return=2)
assert len(hyps) == 2, hyps
srv.shutdown(); t.join(120); srv.batcher.stop(120); srv.server_close()
loaded = [m for m, v in sys.modules.items() if v is not None]
for name in ("jax", "long_vita_tpu", "PIL", "cv2", "transformers", "safetensors", "requests"):
    assert not any(m == name or m.startswith(name + ".") for m in loaded), name
print("OK", repr(text))
"""

_NO_JAX_RECIPE = """
import json, sys, tempfile
for name in ("jax", "long_vita_tpu", "PIL", "cv2", "transformers", "safetensors", "optax"):
    sys.modules[name] = None  # any import of these now raises ImportError
import torch, yaml
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.data import dataset, observability, prefetch, templates
from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.tokenizer import ByteTokenizer
from long_vita_tpu_torch.training import lora, train
from long_vita_tpu_torch.utils import export_hf, metrics
import long_vita_tpu_torch.tokenizer as port_tokenizer

tok = ByteTokenizer(endoftext=256, im_start=257, im_end=258, first_added=259)
port_tokenizer.load_tokenizer = lambda path, template="long_vita": tok
root = tempfile.mkdtemp()
cfg = tiny_test_config()
export_hf.save_hf_checkpoint(init_long_vita_params(torch.Generator().manual_seed(0), cfg), cfg,
                             root + "/ckpt")
rows = [{"messages": [{"role": "user", "content": "q" * (5 + i)},
                      {"role": "assistant", "content": "a" * (9 + i)}]} for i in range(12)]
open(root + "/a.jsonl", "w").write("\\n".join(json.dumps(r) for r in rows))
yaml.safe_dump({"dataset": {"A": {"data_paths": [root + "/a.jsonl"]}}}, open(root + "/c.yaml", "w"))
yaml.safe_dump({
    "model": {"checkpoint": root + "/ckpt", "dtype": "float32", "lora": {"r": 2, "alpha": 4}},
    "data": {"corpus": root + "/c.yaml", "seq_len": 96, "logit_budget": 96},
    "optim": {"lr": 1e-2, "freeze_vision": True},
    "run": {"steps": 2, "remat": "flash", "output_dir": root + "/out"},
}, open(root + "/r.yaml", "w"))
out = train.main(["--config", root + "/r.yaml"], device="cpu")
assert len(out["losses"]) == 2, out
assert templates.render("chatml", [{"role": "user", "content": "x"}]).endswith("assistant\\n")
loaded = [m for m, v in sys.modules.items() if v is not None]
for name in ("jax", "long_vita_tpu", "PIL", "cv2", "transformers", "safetensors", "optax"):
    assert not any(m == name or m.startswith(name + ".") for m in loaded), name
print("OK", out["losses"])
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


def test_serving_entry_points_without_jax_pil_or_hf_packages():
    """Checkpoint I/O, the front end on decoded frames, the server and its
    client, beam search and the CLI module import and run with JAX, the JAX
    package, PIL, OpenCV, transformers, safetensors and requests blocked."""
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SERVE], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK ")


def test_training_entry_point_without_jax_pil_or_hf_packages():
    """The recipe entry (LoRA, remat "flash", output_dir) and the data,
    templates, prefetch, observability and metrics modules import and run
    with JAX, the JAX package, optax, PIL, OpenCV, transformers and
    safetensors blocked."""
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RECIPE], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK ")


_NO_HF_ENTRY_POINTS = """
import json, shutil, sys, tempfile
BLOCKED = ("jax", "long_vita_tpu", "transformers", "tokenizers", "regex", "PIL", "safetensors")
for name in BLOCKED:
    sys.modules[name] = None  # any import of these now raises ImportError
import torch, yaml
import long_vita_tpu_torch
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.training import train
from long_vita_tpu_torch.utils import export_hf

root = tempfile.mkdtemp()
cfg = tiny_test_config(vocab_size=4224)  # the fixture's 4135 ids
export_hf.save_hf_checkpoint(init_long_vita_params(torch.Generator().manual_seed(0), cfg), cfg,
                             root + "/ckpt")
for name in ("tokenizer.json", "tokenizer_config.json"):
    shutil.copy("tests/data/qwen2_tokenizer_tiny/" + name, root + "/ckpt")
eng = long_vita_tpu_torch.build_engine(root + "/ckpt", device="cpu", dtype_name="float32",
                                       max_seq_len=256, chunk=64)
msgs = [{"role": "user", "content": "What does the tokenizer read?"}]
out = eng.generate(msgs, sampling=long_vita_tpu_torch.SamplingParams(max_new_tokens=4))
ids = eng.mm.encode_chat(msgs)
assert len(out.token_ids) == 4 and out.prompt_tokens == len(ids) < 20, (out, ids)
rows = [{"messages": [{"role": "user", "content": "question " * (3 + i)},
                      {"role": "assistant", "content": "answer " * (5 + i)}]} for i in range(8)]
open(root + "/a.jsonl", "w").write("\\n".join(json.dumps(r) for r in rows))
yaml.safe_dump({"dataset": {"A": {"data_paths": [root + "/a.jsonl"]}}}, open(root + "/c.yaml", "w"))
yaml.safe_dump({
    "model": {"checkpoint": root + "/ckpt", "dtype": "float32"},
    "data": {"corpus": root + "/c.yaml", "seq_len": 64, "logit_budget": 64},
    "optim": {"lr": 1e-3, "freeze_vision": True},
    "run": {"steps": 1},
}, open(root + "/r.yaml", "w"))
res = train.main(["--config", root + "/r.yaml"], device="cpu")
assert len(res["losses"]) == 1, res
loaded = [m for m, v in sys.modules.items() if v is not None]
for name in BLOCKED:
    assert not any(m == name or m.startswith(name + ".") for m in loaded), name
print("OK", repr(out.text), res["losses"])
"""


def test_entry_points_read_the_tokenizer_without_hf_packages():
    """long_vita_tpu_torch.build_engine on an exported checkpoint directory
    with the committed Qwen2 tokenizer fixture generates, and the recipe
    entry trains a step from the same directory, each reading the
    tokenizer files with the port's own BPE, with JAX, the JAX package,
    transformers, tokenizers, regex, PIL and safetensors blocked."""
    res = subprocess.run(
        [sys.executable, "-c", _NO_HF_ENTRY_POINTS], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0 and res.stdout.startswith("OK"), res.stderr[-3000:]


def test_tokenizer_imports_no_hf_package():
    """tokenizer.py imports neither transformers, tokenizers nor regex."""
    pat = re.compile(r"^\s*(import|from)\s+(transformers|tokenizers|regex)\b", re.M)
    assert not pat.search((PKG / "tokenizer.py").read_text())
    assert pat.search("from tokenizers import Tokenizer") and pat.search("import regex")


_NO_JAX_CP = """
import copy, sys
sys.modules["jax"] = None
sys.modules["long_vita_tpu"] = None
import numpy as np, torch
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.ops import attention_pair, cp_cache_attention, hybrid_cp, ring_attention, ulysses
from long_vita_tpu_torch.parallel import comm, mesh, sharding, zigzag
from long_vita_tpu_torch.training import distributed
from long_vita_tpu_torch.training.loss import Pack
from long_vita_tpu_torch.training.optimizer import OptimizerConfig
from long_vita_tpu_torch.training.trainer import MeshConfig, Trainer, TrainerConfig, batch_iterator

class MM:
    class tokenizer:
        @staticmethod
        def decode(ids, skip_special_tokens=True):
            return ",".join(map(str, ids))
    def expand(self, input_ids, images=(), videos=(), max_num_frame=None):
        class E:
            pass
        e = E()
        e.input_ids, e.images, e.image_indices = list(input_ids), None, None
        return e

torch.set_num_threads(1)
cfg = tiny_test_config()
vlm = init_long_vita_params(torch.Generator().manual_seed(1), cfg)
sp = SamplingParams(max_new_tokens=4)
want = InferenceEngine(vlm, cfg, MM(), max_seq_len=128, chunk=32).generate(
    input_ids=list(range(45)), sampling=sp).token_ids
got = comm.run_thread_ranks(lambda c: InferenceEngine(
    vlm, cfg, MM(), max_seq_len=128, chunk=32, mesh=mesh.make_mesh(MeshConfig(cp=2), c)
).generate(input_ids=list(range(45)), sampling=sp).token_ids, 2, timeout=60)
assert got == [want, want], (got, want)

rng = np.random.default_rng(0)
packs = [Pack(tokens=rng.integers(0, 400, 32).astype(np.int32),
              labels=rng.integers(0, 400, 32).astype(np.int32),
              position_ids=np.arange(32, dtype=np.int32), segment_ids=np.zeros(32, np.int32),
              images=None, image_indices=None, actual_seq_len=[]) for _ in range(2)]
def train(c, cp):
    tcfg = TrainerConfig(seq_len=32, logit_budget=32, global_batch=1, steps=2, remat=False,
                         mesh=MeshConfig(cp=cp), optim=OptimizerConfig(lr=1e-3, warmup_steps=1))
    tr = Trainer(copy.deepcopy(vlm), cfg, tcfg, comm=c)
    return tr.train(batch_iterator(iter(packs), 1, 32, cp))["losses"]
one = train(None, 1)
two = comm.run_thread_ranks(lambda c: train(c, 2), 2, timeout=60)
assert np.allclose(two, [one, one], rtol=1e-5), (two, one)
print("ok")
"""


def test_context_parallel_without_jax():
    """The cp modules import, serve over two thread-ranks and train over
    two thread-ranks with neither JAX nor the JAX package loadable."""
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX_CP], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


_NO_JAX_TP = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["long_vita_tpu"] = None
import torch
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.inference import cli, server
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.models.quantize import quantized_param_specs
from long_vita_tpu_torch.parallel import comm, mesh, sharding

class MM:
    class tokenizer:
        @staticmethod
        def decode(ids, skip_special_tokens=True):
            return ",".join(map(str, ids))
    def expand(self, input_ids, images=(), videos=(), max_num_frame=None):
        class E:
            pass
        e = E()
        e.input_ids, e.images, e.image_indices = list(input_ids), None, None
        return e

torch.set_num_threads(1)
cfg = tiny_test_config()
vlm = init_long_vita_params(torch.Generator().manual_seed(1), cfg)
sp = SamplingParams(max_new_tokens=4)
for quant in (None, "int4"):
    want = InferenceEngine(vlm, cfg, MM(), max_seq_len=128, chunk=32, weight_quant=quant).generate(
        input_ids=list(range(45)), sampling=sp).token_ids
    for dims, n in ((dict(tp=2), 2), (dict(cp=2, tp=2), 4)):
        got = comm.run_thread_ranks(lambda c: InferenceEngine(
            vlm, cfg, MM(), max_seq_len=128, chunk=32, weight_quant=quant,
            mesh=mesh.make_mesh(mesh.MeshConfig(**dims), c)
        ).generate(input_ids=list(range(45)), sampling=sp).token_ids, n, timeout=60)
        assert got == [want] * n, (dims, quant, got, want)
print("ok")
"""


def test_tensor_parallel_without_jax():
    """The tp modules (parallel/sharding, quantized_param_specs, the tp
    decoder) import and serve over tp 2 and cp 2 x tp 2 thread-ranks, bf16
    layout and int4 weights, with neither JAX nor the JAX package
    loadable."""
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX_TP], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


_NO_JAX_SLICE11 = """
import json, sys, tempfile
for name in ("jax", "long_vita_tpu", "PIL", "transformers", "safetensors", "requests", "vlmeval"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np, torch
from long_vita_tpu_torch.benchmarks import fwd_kernel_lab
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.eval import simple_eval, vlmeval_adapter
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.models import generic_vit, intern_vit
from long_vita_tpu_torch.models.qwen2 import init_qwen2_params
from long_vita_tpu_torch.ops import moe
from long_vita_tpu_torch.utils import checkpoint_io, vision_loaders

torch.manual_seed(0)
# a SigLIP-like tower with a ragged head dim (2 heads of 24), written as HF
# safetensors and loaded back
cfg = generic_vit.GenericViTConfig(48, 96, 2, 2, 28, add_class_token=False,
                                   hidden_act="gelu_tanh")
root = tempfile.mkdtemp()
h, p = 48, "vision_model."
sd = {p + "embeddings.patch_embedding.weight": torch.randn(h, 3, 14, 14),
      p + "embeddings.patch_embedding.bias": torch.randn(h),
      p + "embeddings.position_embedding.weight": torch.randn(4, h)}
for i in range(2):
    q = f"{p}encoder.layers.{i}."
    for n, shape in (("self_attn.q_proj", (h, h)), ("self_attn.k_proj", (h, h)),
                     ("self_attn.v_proj", (h, h)), ("self_attn.out_proj", (h, h)),
                     ("mlp.fc1", (96, h)), ("mlp.fc2", (h, 96))):
        sd[q + n + ".weight"] = torch.randn(shape) * 0.1
        sd[q + n + ".bias"] = torch.randn(shape[0]) * 0.1
    for n in ("layer_norm1", "layer_norm2"):
        sd[q + n + ".weight"], sd[q + n + ".bias"] = torch.ones(h), torch.zeros(h)
checkpoint_io.save_safetensors(sd, root + "/model.safetensors")
json.dump({"hidden_size": 48, "intermediate_size": 96, "num_hidden_layers": 2,
           "num_attention_heads": 2, "image_size": 28, "patch_size": 14}, open(root + "/config.json", "w"))
vcfg = vision_loaders.vit_config_from_hf(root, "siglip")
tower = vision_loaders.load_siglip_vit_params(root, vcfg, dtype=torch.float32, device="cpu")
feats = generic_vit.generic_vit(tower, torch.randn(2, 28, 28, 3), vcfg)
assert feats.shape == (2, 4, 48) and torch.isfinite(feats).all()
assert intern_vit._interp_pos_embed(torch.randn(16, 8), 4, (3, 5)).shape == (15, 8)
# a MoE decoder through the engine
class MM:
    class tokenizer:
        @staticmethod
        def decode(ids, skip_special_tokens=True):
            return ",".join(map(str, ids))
    def expand(self, input_ids, images=(), videos=(), max_num_frame=None):
        class E:
            pass
        e = E()
        e.input_ids, e.images, e.image_indices = list(input_ids), None, None
        return e

tc = tiny_test_config(num_experts=4)
eng = InferenceEngine(init_qwen2_params(torch.Generator().manual_seed(0), tc.text), tc, MM(),
                      max_seq_len=128, chunk=32)
out = eng.generate(input_ids=list(range(40)), sampling=SamplingParams(max_new_tokens=3))
assert len(out.token_ids) == 3, out
x = torch.randn(1, 5, 8)
y, aux = moe.moe_mlp(moe.init_moe_params(torch.Generator(), 2, 8, 16), x)
assert y.shape == x.shape and aux.item() > 0
o = fwd_kernel_lab.variant_flash(torch.randn(1, 4, 64, 64), torch.randn(1, 2, 64, 64),
                                 torch.randn(1, 2, 64, 64))
assert o.shape == (1, 4, 64, 64)
assert simple_eval.score("Answer: Paris", "paris") == {"exact": True, "contains": True}
assert vlmeval_adapter.LongVITAAPI is vlmeval_adapter._ServerModel
loaded = [m for m, v in sys.modules.items() if v is not None]
for name in ("jax", "long_vita_tpu", "PIL", "transformers", "safetensors", "requests"):
    assert not any(m == name or m.startswith(name + ".") for m in loaded), name
print("OK")
"""


def test_eleventh_slice_without_jax_or_hf_packages():
    """The generic towers and their loaders, the position-embedding resize,
    local MoE through the engine, the forward-kernel lab's plain version and
    eval/ import and run with JAX, the JAX package, PIL, transformers,
    safetensors, requests and VLMEvalKit blocked."""
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SLICE11], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0 and res.stdout.startswith("OK"), res.stderr[-3000:]


def test_no_jax_import_in_the_port():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert len(files) > 10 and not offenders, offenders
    covered = {f.relative_to(PKG).as_posix() for f in files if f.is_relative_to(PKG)}
    assert {"models/generic_vit.py", "utils/vision_loaders.py", "ops/moe.py",
            "eval/simple_eval.py", "eval/vlmeval_adapter.py",
            "benchmarks/fwd_kernel_lab.py"} <= covered


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


def test_no_orbax_or_tensorstore_import_in_the_port():
    """The port reads and writes the JAX package's orbax stores itself
    (utils/ocdbt.py, utils/zarr.py, utils/zstd.py, utils/orbax_store.py):
    no module of it and not chip_smoke.py imports orbax, tensorstore or
    zarr."""
    pat = re.compile(r"^\s*(import|from)\s+(orbax|tensorstore|zarr)\b", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert len(files) > 10 and not offenders, offenders
    covered = {f.relative_to(PKG).as_posix() for f in files if f.is_relative_to(PKG)}
    assert {"utils/ocdbt.py", "utils/zarr.py", "utils/zstd.py", "utils/orbax_store.py",
            "training/checkpoint.py"} <= covered
    assert pat.search("import orbax.checkpoint as ocp") and pat.search("import tensorstore")
    assert not pat.search("from long_vita_tpu_torch.utils.zarr import ZarrArray")


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


_NO_JAX_TP_TRAIN = """
import copy, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["long_vita_tpu"] = None
import numpy as np, torch
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.parallel import comm, mesh, sharding
from long_vita_tpu_torch.training import checkpoint, loss, lora, optimizer, train, train_step
from long_vita_tpu_torch.training.trainer import Trainer, TrainerConfig
from long_vita_tpu_torch.utils import checkpoint_io

torch.set_num_threads(1)
cfg = tiny_test_config()
vlm = init_long_vita_params(torch.Generator().manual_seed(1), cfg)
rng = np.random.default_rng(0)
s, m = 64, 16
batch = {"tokens": rng.integers(0, 500, (2, s)).astype(np.int32),
         "positions": np.tile(np.arange(s, dtype=np.int32), (2, 1)),
         "segment_ids": np.zeros((2, s), np.int32),
         "logit_positions": np.tile(np.arange(0, s, s // m, dtype=np.int32), (2, 1)),
         "labels": rng.integers(0, 500, (2, m)).astype(np.int32),
         "images": None, "image_indices": None}

def run(c, dims):
    tcfg = TrainerConfig(seq_len=s, logit_budget=m, global_batch=2, steps=2, remat=True,
                         mesh=mesh.MeshConfig(**dims),
                         optim=optimizer.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    b = dict(batch)
    cp = dims.get("cp", 1)
    if cp > 1:  # ring attention takes the zigzag-permuted sequence
        from long_vita_tpu_torch.parallel.zigzag import inverse_zigzag_permutation, zigzag_permute
        for k in ("tokens", "positions", "segment_ids"):
            b[k] = zigzag_permute(b[k], cp)
        b["logit_positions"] = inverse_zigzag_permutation(s, cp)[b["logit_positions"]]
    return Trainer(copy.deepcopy(vlm), cfg, tcfg, comm=c).train(iter([b, b]))["losses"]

want = run(None, {})
for dims, n in ((dict(tp=2), 2), (dict(dp=2, tp=2), 4), (dict(cp=2, tp=2), 4)):
    got = comm.run_thread_ranks(lambda c: run(c, dims), n, timeout=120)
    for g in got:
        np.testing.assert_allclose(g, want, rtol=1e-5, err_msg=str(dims))
print("ok")
"""


def test_tp_training_without_jax():
    """Training over tp (the sequence-parallel decoder, the vocab-parallel
    lookup and CE, the sharded gradient reduction and norm, the slice
    loader, gathered checkpoints and LoRA) imports and trains over tp 2,
    dp 2 x tp 2 and cp 2 x tp 2 thread-ranks to the one-device losses, with
    neither JAX nor the JAX package loadable."""
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX_TP_TRAIN], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


_NO_JAX_PP_TRAIN = """
import copy, dataclasses, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["long_vita_tpu"] = None
import numpy as np, torch
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.parallel import comm, mesh, pipeline, sharding
from long_vita_tpu_torch.training import optimizer
from long_vita_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)
base = tiny_test_config()
cfg = dataclasses.replace(base, text=dataclasses.replace(base.text, num_hidden_layers=4))
vlm = init_long_vita_params(torch.Generator().manual_seed(1), cfg)
rng = np.random.default_rng(0)
s, m = 64, 16
batch = {"tokens": rng.integers(0, 500, (2, s)).astype(np.int32),
         "positions": np.tile(np.arange(s, dtype=np.int32), (2, 1)),
         "segment_ids": np.zeros((2, s), np.int32),
         "logit_positions": np.tile(np.arange(0, s, s // m, dtype=np.int32), (2, 1)),
         "labels": rng.integers(0, 500, (2, m)).astype(np.int32),
         "images": None, "image_indices": None}

def run(c, dims, v=1):
    tcfg = TrainerConfig(seq_len=s, logit_budget=m, global_batch=2, steps=2, remat=True,
                         mesh=mesh.MeshConfig(**dims), virtual_pp=v,
                         optim=optimizer.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    return Trainer(copy.deepcopy(vlm), cfg, tcfg, comm=c).train(iter([batch, batch]))["losses"]

want = run(None, {})
for dims, v, n in ((dict(pp=2), 1, 2), (dict(pp=2), 2, 2), (dict(pp=2, tp=2), 1, 4)):
    got = comm.run_thread_ranks(lambda c: run(c, dims, v), n, timeout=120)
    for g in got:
        np.testing.assert_allclose(g, want, rtol=1e-5, err_msg=str(dims))
print("ok")
"""


def test_pp_training_without_jax():
    """Training over pipeline stages (parallel/pipeline.py: GPipe and the
    interleaved schedule, the stages' shards, the reduction over pp)
    imports and trains over pp 2, pp 2 x v 2 and pp 2 x tp 2 thread-ranks
    to the one-device losses, with neither JAX nor the JAX package
    loadable."""
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX_PP_TRAIN], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
