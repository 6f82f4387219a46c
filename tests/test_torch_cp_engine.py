"""The port's InferenceEngine over a cp mesh of thread-ranks (a KV cache
sharded over cp by slot) against the JAX engine on a CPU mesh of the same
cp, at tiny_test_config() in f32: greedy generate of a 150-id prompt
(three chunks of 64 and the last-row recompute), with a bf16-layout and an
int8 cache, and with int4 weights (quantised on every rank); a video whose tiles are encoded 1/cp a rank (media within the
prompt's last chunk: the JAX engine's per-chunk scatter wraps rows of an
earlier chunk into a later one, ROADMAP §3); and a ragged generate_batch.
Tokens must be equal and logprobs within TOL on every rank (each rank
samples the same tokens)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.inference.engine import InferenceEngine as JaxEngine
from long_vita_tpu.inference.sampler import SamplingParams as JaxSP
from long_vita_tpu.models.long_vita import init_long_vita_params
from long_vita_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.parallel.comm import LocalComm, run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_engine import VID_TAG, _MM
from test_torch_quantize import one_torch_thread  # noqa: F401

TOL = dict(rtol=0, atol=1e-4)
QUANT_TOL = dict(rtol=0, atol=1e-3)
KW = dict(max_seq_len=512, chunk=64, decode_segment=8)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config()
    p = init_long_vita_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)

    def fill(path, a):  # randomise norms and biases; widen the kernels
        name, a = jax.tree_util.keystr(path), np.asarray(a)
        if "norm" in name:
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if "bias" in name:
            return (0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a * 4 if name.startswith("['text']") else a

    p = jax.tree_util.tree_map_with_path(fill, p)
    return p, long_vita_params_from_jax(p, device="cpu"), cfg


def _requests(cfg):
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((3, 56, 56, 3)).astype(np.float32)
    # 130 ids, the video's 3 x 6 rows at 131..148, then 5 ids: 154 tokens,
    # chunks at 0, 64, 128: every media row in the last chunk
    video = rng.integers(0, 400, 130).tolist() + [VID_TAG] + rng.integers(0, 400, 5).tolist()
    return dict(
        text=rng.integers(0, cfg.text.vocab_size, 150).tolist(),
        video=(video, frames),
        batch=[{"input_ids": rng.integers(0, 400, n).tolist()} for n in (40, 150, 100)],
    )


def _run(engine, reqs, sp, parts):
    out = {}
    if "text" in parts:
        out["text"] = engine.generate(input_ids=reqs["text"], sampling=sp)
    if "video" in parts:
        ids, frames = reqs["video"]
        out["video"] = engine.generate(input_ids=ids, videos=[frames], sampling=sp)
    if "batch" in parts:
        out["batch"] = engine.generate_batch(reqs["batch"], sampling=sp)
    return out


def _compare(got, want, tol):
    for key, w in want.items():
        g = got[key]
        if key == "batch":
            assert [r.token_ids for r in g] == [r.token_ids for r in w], key
            for a, b in zip(g, w):
                np.testing.assert_allclose(a.logprobs, b.logprobs, err_msg=key, **tol)
        else:
            assert g.token_ids == w.token_ids, key
            assert len(set(g.token_ids)) > 2, g.token_ids  # not a degenerate loop
            np.testing.assert_allclose(g.logprobs, w.logprobs, err_msg=key, **tol)


CASES = {
    "cp2": dict(cp=2, kv_quant=False, parts=("text", "video", "batch")),
    "cp4": dict(cp=4, kv_quant=False, parts=("text", "video", "batch")),
    "cp2_int8_cache": dict(cp=2, kv_quant=True, parts=("text", "batch")),
    # int4 weights on every rank (w4_matmul, K6's route on the card)
    "cp2_int4_weights": dict(cp=2, kv_quant=False, parts=("text",), weight_quant="int4"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cp_engine_matches_jax_mesh_engine(model, case, one_torch_thread):
    jp, tp_, cfg = model
    cp, kv_quant, parts = CASES[case]["cp"], CASES[case]["kv_quant"], CASES[case]["parts"]
    wq = CASES[case].get("weight_quant")
    reqs = _requests(cfg)
    jmesh = j_make_mesh(JMeshConfig(cp=cp), devices=jax.devices()[:cp])
    jeng = JaxEngine(jp, cfg, _MM(), cache_dtype=jnp.float32, kv_quant=kv_quant, mesh=jmesh,
                     weight_quant=wq, **KW)
    want = _run(jeng, reqs, JaxSP(max_new_tokens=10, return_logprobs=True), parts)

    def rank(comm):
        eng = InferenceEngine(tp_, cfg, _MM(), cache_dtype=torch.float32, kv_quant=kv_quant,
                              mesh=make_mesh(MeshConfig(cp=cp), comm), weight_quant=wq, **KW)
        assert eng._make_cache(1, 512).k.shape[2] == 512 // cp  # this rank's slots
        return _run(eng, reqs, SamplingParams(max_new_tokens=10, return_logprobs=True), parts)

    for got in run_thread_ranks(rank, cp, timeout=120):
        _compare(got, want, QUANT_TOL if kv_quant else TOL)


def test_cp_engine_checks_the_chunk_against_the_shard(model):
    """The JAX engine's check (:222-230), with its message: a prefill chunk
    must fit one rank's cache shard."""
    _, tp_, cfg = model

    def rank(comm):
        InferenceEngine(tp_, cfg, _MM(), mesh=make_mesh(MeshConfig(cp=4), comm),
                        max_seq_len=128, chunk=64)

    with pytest.raises(ValueError, match="exceeds one cp rank's cache shard"):
        run_thread_ranks(rank, 4, timeout=30)


def test_engine_mesh_without_cp_is_one_device(model):
    """A mesh of one rank (cp 1) serves as the one-device engine does."""
    _, tp_, cfg = model
    reqs = _requests(cfg)
    sp = SamplingParams(max_new_tokens=6)
    plain = InferenceEngine(tp_, cfg, _MM(), cache_dtype=torch.float32, **KW)
    meshed = InferenceEngine(tp_, cfg, _MM(), cache_dtype=torch.float32,
                             mesh=make_mesh(MeshConfig(), LocalComm()), **KW)
    assert meshed.parallel is None
    assert (meshed.generate(input_ids=reqs["text"], sampling=sp).token_ids
            == plain.generate(input_ids=reqs["text"], sampling=sp).token_ids)
