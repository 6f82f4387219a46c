"""The cp-sharded KV cache of the port (ops/cp_cache_attention.py) against
the JAX package's under shard_map on the CPU mesh: cp_cache_update_attend
(the shard-local write, then the lse-merged attention) with a bf16-layout
f32 cache and an int8 cache with scales, for a prefill chunk that rides in
sequence-sharded (q_sharded), a chunk that does not divide by cp, and a
ragged decode step with per-row frontiers; and cp_cached_attention with a
frontier that ends mid-shard, so that some ranks hold no valid slot. The
same numpy inputs from a seed on both sides; f32; tolerance TOL (the int8
path casts to bf16 at the same points on both sides)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from long_vita_tpu.models.qwen2 import quantize_kv as j_quantize_kv
from long_vita_tpu.ops import cp_cache_attention as jcc
from long_vita_tpu_torch.models.qwen2 import quantize_kv
from long_vita_tpu_torch.ops import cp_cache_attention as tcc
from long_vita_tpu_torch.parallel.comm import run_thread_ranks

TOL = dict(rtol=1e-5, atol=2e-5)
CP, L, SMAX, HQ, HKV, D = 4, 2, 64, 8, 2, 16
C = SMAX // CP

CASES = {
    # 16 rows written at slots 24..39 (shards 1 and 2), q sharded 4 rows a rank
    "chunk_q_sharded": dict(b=1, s=16, cache_len=24),
    # 6 rows (not a multiple of cp) across the shard 2 / 3 boundary
    "chunk_replicated": dict(b=1, s=6, cache_len=45),
    # one token a row at its own frontier
    "ragged_decode": dict(b=3, s=1, cache_len=[10, 33, 50]),
}


def _inputs(case, quant, seed):
    rng = np.random.default_rng(seed)
    b, s = CASES[case]["b"], CASES[case]["s"]
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    out = dict(q=f(b, s, HQ, D), ck=f(L, b, SMAX, HKV, D), cv=f(L, b, SMAX, HKV, D),
               kn=f(b, s, HKV, D), vn=f(b, s, HKV, D))
    if quant:
        for name in ("ck", "cv", "kn", "vn"):
            codes, scale = (np.array(x) for x in j_quantize_kv(jnp.asarray(out[name])))
            out[name], out[name + "_s"] = codes, scale
    return out


def _jax(x, case, quant):
    cl = CASES[case]["cache_len"]
    cache_len = q_offset = jnp.asarray(cl, jnp.int32)
    s = x["q"].shape[1]
    q_sharded = s > 1 and s % CP == 0
    qspec = P(None, "cp" if q_sharded else None, None, None)
    cspec, uspec = P(None, None, "cp", None, None), P(None, None, None, None)
    keys = ["q", "ck", "cv", "kn", "vn"] + (["ck_s", "cv_s", "kn_s", "vn_s"] if quant else [])

    def body(q_, ck_, cv_, kn_, vn_, *sc):
        ks, vs, ksc, vsc = sc if quant else (None,) * 4
        out, ck2, cv2, ks2, vs2 = jcc.cp_cache_update_attend(
            q_, ck_, cv_, kn_, vn_, ks, vs, ksc, vsc, jnp.asarray(1), cache_len, q_offset,
            "cp", q_sharded=q_sharded)
        return (out, ck2, cv2) + ((ks2, vs2) if quant else ())

    in_specs = (qspec, cspec, cspec, uspec, uspec) + ((cspec, cspec, uspec, uspec) if quant else ())
    out_specs = (qspec, cspec, cspec) + ((cspec, cspec) if quant else ())
    fn = shard_map(body, mesh=Mesh(np.asarray(jax.devices()[:CP]), ("cp",)),
                   in_specs=in_specs, out_specs=out_specs)
    return [np.asarray(y) for y in jax.jit(fn)(*(jnp.asarray(x[k]) for k in keys))]


def _port(x, case, quant):
    cl = CASES[case]["cache_len"]
    cache_len = torch.as_tensor(cl) if isinstance(cl, list) else cl
    s = x["q"].shape[1]
    q_sharded = s > 1 and s % CP == 0
    t = {k: torch.as_tensor(v) for k, v in x.items()}

    def rank(comm):
        r = comm.rank
        shard = lambda a: a[:, :, r * C:(r + 1) * C].clone()  # noqa: E731
        ck, cv = shard(t["ck"]), shard(t["cv"])
        ks = vs = None
        if quant:
            ks, vs = shard(t["ck_s"]), shard(t["cv_s"])
        q = t["q"][:, r * (s // CP):(r + 1) * (s // CP)] if q_sharded else t["q"]
        q_offset = cache_len
        out = tcc.cp_cache_update_attend(
            q, ck, cv, t["kn"], t["vn"], ks, vs, t.get("kn_s"), t.get("vn_s"), 1, cache_len,
            q_offset, comm, q_sharded=q_sharded)
        return (out, ck, cv) + ((ks, vs) if quant else ())

    res = run_thread_ranks(rank, CP, timeout=60)
    out = torch.cat([r[0] for r in res], 1) if q_sharded else res[0][0]
    for r in res[1:]:
        if not q_sharded:
            assert torch.equal(r[0], res[0][0])  # every rank holds the merged rows
    caches = [torch.cat([r[i] for r in res], 2) for i in range(1, len(res[0]))]
    return [out.numpy()] + [c.numpy() for c in caches]


@pytest.mark.parametrize("quant", [False, True], ids=["f32_cache", "int8_cache"])
@pytest.mark.parametrize("case", list(CASES))
def test_cp_cache_update_attend_matches_jax(case, quant):
    x = _inputs(case, quant, seed=len(case) + quant)
    got, want = _port(x, case, quant), _jax(x, case, quant)
    np.testing.assert_allclose(got[0], want[0], err_msg="out", **TOL)
    for a, b_, name in zip(got[1:], want[1:], ("k", "v", "k_scale", "v_scale")):
        np.testing.assert_array_equal(a, b_, err_msg=f"cache {name}")


@pytest.mark.parametrize("quant", [False, True], ids=["f32_cache", "int8_cache"])
@pytest.mark.parametrize("cache_len", [21, 64])
def test_cp_cached_attention_matches_jax(quant, cache_len):
    """A 4-row chunk at positions cache_len - 4 .. cache_len - 1: with
    cache_len 21 the frontier ends mid-shard 1 and shards 2 and 3 hold no
    valid slot (merge weight 0, no NaN)."""
    rng = np.random.default_rng(cache_len)
    q = rng.standard_normal((1, 4, HQ, D)).astype(np.float32)
    k = rng.standard_normal((1, SMAX, HKV, D)).astype(np.float32)
    v = rng.standard_normal((1, SMAX, HKV, D)).astype(np.float32)
    q_offset = cache_len - 4
    sc = {}
    if quant:
        k, sc["k"] = (np.asarray(a) for a in j_quantize_kv(jnp.asarray(k)))
        v, sc["v"] = (np.asarray(a) for a in j_quantize_kv(jnp.asarray(v)))
    qspec, cspec = P(None, None, None, None), P(None, "cp", None, None)
    if quant:
        fn = shard_map(lambda q_, k_, v_, ks_, vs_: jcc.cp_cached_attention(
            q_, k_, v_, q_offset, cache_len, "cp", ks_, vs_),
            mesh=Mesh(np.asarray(jax.devices()[:CP]), ("cp",)),
            in_specs=(qspec, cspec, cspec, cspec, cspec), out_specs=qspec)
        want = fn(*(jnp.asarray(a) for a in (q, k, v, sc["k"], sc["v"])))
    else:
        fn = shard_map(lambda q_, k_, v_: jcc.cp_cached_attention(
            q_, k_, v_, q_offset, cache_len, "cp"),
            mesh=Mesh(np.asarray(jax.devices()[:CP]), ("cp",)),
            in_specs=(qspec, cspec, cspec), out_specs=qspec)
        want = fn(*(jnp.asarray(a) for a in (q, k, v)))

    def rank(comm):
        sl = slice(comm.rank * C, (comm.rank + 1) * C)
        args = [torch.as_tensor(q), torch.as_tensor(k[:, sl]), torch.as_tensor(v[:, sl]),
                q_offset, cache_len, comm]
        if quant:
            args += [torch.as_tensor(sc["k"][:, sl]), torch.as_tensor(sc["v"][:, sl])]
        return tcc.cp_cached_attention(*args)

    got = run_thread_ranks(rank, CP, timeout=60)
    assert all(torch.isfinite(g).all() for g in got)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TOL)


def test_quantize_kv_matches_jax_bit_for_bit():
    x = np.random.default_rng(9).standard_normal((2, 5, 3, D)).astype(np.float32)
    codes, scale = quantize_kv(torch.as_tensor(x))
    jcodes, jscale = j_quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
