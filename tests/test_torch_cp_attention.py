"""Context-parallel attention of the port against the JAX package, on the CPU.

The zigzag permutation, the chunk-pair forward / backward and the merge,
then ring (plain and double-ring windows), Ulysses and hybrid attention over
thread-ranks (parallel/comm.ThreadComm): forward outputs and the gradients
of sum(o * w) w.r.t. q, k and v, held against the JAX functions under
shard_map on the 8-device CPU mesh (tests/conftest.py), or against JAX's
full attention over the unpermuted sequence. Same numpy inputs from a seed,
f32, tolerance TOL (f32 sums in other orders over a 64-token sequence)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from long_vita_tpu.ops import attention_pair as jpair
from long_vita_tpu.ops.attention import xla_attention
from long_vita_tpu.ops.hybrid_cp import hybrid_attention as j_hybrid
from long_vita_tpu.ops.ring_attention import ring_attention as j_ring
from long_vita_tpu.ops.ulysses import ulysses_attention as j_ulysses
from long_vita_tpu.parallel import zigzag as jzz
from long_vita_tpu_torch.ops import attention_pair as tpair
from long_vita_tpu_torch.ops.flash_attention import NEG_INF
from long_vita_tpu_torch.ops.hybrid_cp import hybrid_attention
from long_vita_tpu_torch.ops.ring_attention import ring_attention
from long_vita_tpu_torch.ops.ulysses import ulysses_attention
from long_vita_tpu_torch.parallel import zigzag as tzz
from long_vita_tpu_torch.parallel.comm import run_thread_ranks

TOL = dict(rtol=1e-5, atol=2e-5)
B, S, HQ, HKV, D = 2, 64, 8, 2, 16


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    seg = np.zeros((B, S), np.int32)
    seg[0, 20:] = 1
    seg[1, 5:] = 1
    seg[1, 41:] = 2
    return dict(
        q=rng.standard_normal((B, S, HQ, D)).astype(np.float32),
        k=rng.standard_normal((B, S, HKV, D)).astype(np.float32),
        v=rng.standard_normal((B, S, HKV, D)).astype(np.float32),
        w=rng.standard_normal((B, S, HQ, D)).astype(np.float32),
        seg=seg,
    )


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what, **TOL)


# ---------------------------------------------------------------------------
# zigzag, pairs, merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cp", [1, 2, 4])
def test_zigzag_matches_jax(cp):
    np.testing.assert_array_equal(tzz.zigzag_order(cp), jzz.zigzag_order(cp))
    np.testing.assert_array_equal(tzz.zigzag_permutation(64, cp), jzz.zigzag_permutation(64, cp))
    np.testing.assert_array_equal(tzz.inverse_zigzag_permutation(64, cp),
                                  jzz.inverse_zigzag_permutation(64, cp))
    np.testing.assert_array_equal(tzz.zigzag_positions(64, cp), jzz.zigzag_positions(64, cp))
    x = np.arange(3 * 64 * 2).reshape(3, 64, 2)
    want = np.array(jzz.zigzag_permute(jnp.asarray(x), cp))
    np.testing.assert_array_equal(tzz.zigzag_permute(x, cp), want)
    np.testing.assert_array_equal(tzz.zigzag_permute(torch.as_tensor(x), cp).numpy(), want)
    np.testing.assert_array_equal(tzz.zigzag_unpermute(torch.as_tensor(want), cp).numpy(), x)
    with pytest.raises(ValueError):
        tzz.zigzag_permutation(60, 4)


PAIRS = {
    "diag": dict(causal=True, segs=False),
    "full": dict(causal=False, segs=False),
    "diag_segs": dict(causal=True, segs=True),
    "full_segs": dict(causal=False, segs=True),
    "disjoint_segs": dict(causal=False, segs="disjoint"),
}


@pytest.mark.parametrize("case", list(PAIRS))
def test_pair_fwd_bwd_match_jax(data, case):
    """One (q chunk, kv chunk) pair: (o, lse), then the backward given an
    lse and delta as the ring passes them (global: finite for every row).

    A row that sees no key of the pair (before the diagonal's first shared
    segment, or "disjoint_segs": no shared segment at all) is the merge
    identity in the port, o = 0 and lse = -2^30 (the value of JAX's skipped
    pair, _guarded_pair_fwd). JAX's plain pair averages V there with lse =
    -2^30 + log(C), whose weight in any merge is 0 all the same; those rows
    are held to that, the others to JAX's values."""
    causal, segs = PAIRS[case]["causal"], PAIRS[case]["segs"]
    c = 16
    q, k, v, g = data["q"][:, :c], data["k"][:, c:2 * c], data["v"][:, c:2 * c], data["w"][:, :c]
    qs = ks = None
    visible = np.ones((B, c, c), bool)
    if causal:
        visible &= np.tril(np.ones((c, c), bool))[None]
    if segs:
        qs, ks = data["seg"][:, :c], data["seg"][:, c:2 * c]
        if segs == "disjoint":
            qs = np.full_like(qs, 7)
        visible &= qs[:, :, None] == ks[:, None, :]
    empty = ~visible.any(-1)  # [B, C]
    if segs:
        assert empty.any()
    jkw = dict(q_segment_ids=None if qs is None else jnp.asarray(qs),
               kv_segment_ids=None if ks is None else jnp.asarray(ks))
    tkw = dict(q_segment_ids=None if qs is None else torch.as_tensor(qs),
               kv_segment_ids=None if ks is None else torch.as_tensor(ks))
    jo, jl = jpair.pair_attn_fwd(*(jnp.asarray(x) for x in (q, k, v)), causal=causal, **jkw)
    to, tl = tpair.pair_attn_fwd(*(torch.as_tensor(x) for x in (q, k, v)), causal=causal, **tkw)
    jo, jl, to, tl = np.asarray(jo), np.asarray(jl), to.numpy(), tl.numpy()
    rows = ~empty
    _close(to[rows], jo[rows], "o")
    _close(tl.transpose(0, 2, 1)[rows], jl.transpose(0, 2, 1)[rows], "lse")
    assert (to[empty] == 0).all() and (tl.transpose(0, 2, 1)[empty] == NEG_INF).all()
    assert (jl.transpose(0, 2, 1)[empty] < NEG_INF / 2).all()
    # the backward from statistics of the whole row (as the ring's): an
    # empty row's lse is that of keys in other chunks
    lse = np.where(empty[:, None, :], 0.0, jl).astype(np.float32)
    delta = (g * to).sum(-1).transpose(0, 2, 1)
    jg = jpair.pair_attn_bwd(*(jnp.asarray(x) for x in (q, k, v, g, lse, delta)),
                             causal=causal, **jkw)
    tg = tpair.pair_attn_bwd(*(torch.as_tensor(x) for x in (q, k, v, g, lse, delta)),
                             causal=causal, **tkw)
    for a, b_, name in zip(tg, jg, ("dq", "dk", "dv")):
        _close(a, b_, name)


def test_merge_partials_matches_jax(data):
    rng = np.random.default_rng(3)
    o1, o2 = data["q"][:, :8], data["w"][:, :8]
    l1 = rng.standard_normal((B, HQ, 8)).astype(np.float32)
    l2 = rng.standard_normal((B, HQ, 8)).astype(np.float32)
    l2[0, 0] = NEG_INF  # an empty partial
    jo, jl = jpair.merge_partials(*(jnp.asarray(x) for x in (o1, l1, o2, l2)))
    to, tl = tpair.merge_partials(*(torch.as_tensor(x) for x in (o1, l1, o2, l2)))
    _close(to, jo, "o")
    _close(tl, jl, "lse")


# ---------------------------------------------------------------------------
# ring, Ulysses, hybrid
# ---------------------------------------------------------------------------


def _zig(algo: str, cp: int, inner: int) -> int:
    """The zigzag factor of a layout: cp (ring), none (ulysses), the ring
    groups (hybrid)."""
    return {"ring": cp, "ulysses": 1, "hybrid": cp // inner}[algo]


def _port(data, algo, cp, *, window=0, inner=2, segs=False):
    """The port over cp thread-ranks: -> (o, dq, dk, dv) over the whole
    unpermuted sequence."""
    z = _zig(algo, cp, inner)
    q, k, v, w = (tzz.zigzag_permute(torch.as_tensor(data[x]), z) for x in "qkvw")
    seg = tzz.zigzag_permute(torch.as_tensor(data["seg"]), z) if segs else None
    n = S // cp

    def rank(comm):
        sl = slice(comm.rank * n, (comm.rank + 1) * n)
        ql, kl, vl = (x[:, sl].clone().requires_grad_() for x in (q, k, v))
        sg = seg[:, sl] if segs else None
        if algo == "ring":
            o = ring_attention(ql, kl, vl, comm, sg, sg, window)
        elif algo == "ulysses":
            o = ulysses_attention(ql, kl, vl, comm, sg, sg)
        else:
            o = hybrid_attention(ql, kl, vl, comm, inner, sg, sg, window)
        (o * w[:, sl]).sum().backward()
        return o.detach(), ql.grad, kl.grad, vl.grad

    res = run_thread_ranks(rank, cp, timeout=60)
    return [tzz.zigzag_unpermute(torch.cat([r[i] for r in res], 1), z).numpy() for i in range(4)]


def _jax_full(data, segs):
    """JAX's full causal attention over the unpermuted sequence: (o, dq, dk, dv)."""
    q, k, v, w = (jnp.asarray(data[x]) for x in "qkvw")
    kw = {}
    if segs:
        kw = dict(q_segment_ids=jnp.asarray(data["seg"]), kv_segment_ids=jnp.asarray(data["seg"]))

    def loss(q, k, v):
        o = xla_attention(q, k, v, causal=True, **kw)
        return jnp.sum(o * w), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    return [np.asarray(x) for x in (o, *grads)]


def _jax_sharded(data, algo, cp, *, window=0, inner=2):
    """The JAX function under shard_map over cp CPU devices, with segment
    ids: (o, dq, dk, dv) over the whole unpermuted sequence."""
    z = _zig(algo, cp, inner)
    q, k, v, w, seg = (jzz.zigzag_permute(jnp.asarray(data[x]), z) for x in ("q", "k", "v", "w",
                                                                               "seg"))
    body = {
        "ring": lambda q_, k_, v_, s_: j_ring(q_, k_, v_, "cp", True, 1, s_, s_, window),
        "ulysses": lambda q_, k_, v_, s_: j_ulysses(q_, k_, v_, "cp", s_, s_),
        "hybrid": lambda q_, k_, v_, s_: j_hybrid(q_, k_, v_, "cp", inner, s_, s_, window),
    }[algo]
    spec, sspec = P(None, "cp", None, None), P(None, "cp")
    fn = shard_map(body, mesh=Mesh(np.asarray(jax.devices()[:cp]), ("cp",)),
                   in_specs=(spec, spec, spec, sspec), out_specs=spec)

    def loss(q, k, v):
        o = fn(q, k, v, seg)
        return jnp.sum(o * w), o

    (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(jzz.zigzag_unpermute(x, z)) for x in (o, *grads)]


def _check(got, want):
    for a, b_, name in zip(got, want, ("o", "dq", "dk", "dv")):
        _close(a, b_, name)


SHARDED = {
    "ring": dict(algo="ring", cp=4),
    "ring_window2": dict(algo="ring", cp=4, window=2),
    "ulysses": dict(algo="ulysses", cp=4),
    "hybrid": dict(algo="hybrid", cp=4, inner=2),
}


@pytest.mark.parametrize("case", list(SHARDED))
def test_cp_attention_with_segments_matches_jax_shard_map(data, case):
    kw = SHARDED[case]
    _check(_port(data, segs=True, **kw), _jax_sharded(data, **kw))


FULL = {
    "ring_cp2": dict(algo="ring", cp=2),
    "ring_cp8": dict(algo="ring", cp=8),
    "ring_cp8_window2": dict(algo="ring", cp=8, window=2),
    "ring_cp8_window4": dict(algo="ring", cp=8, window=4),
    "ulysses_cp2": dict(algo="ulysses", cp=2),
    "ulysses_cp4": dict(algo="ulysses", cp=4),
    "hybrid_cp8_inner2_window2": dict(algo="hybrid", cp=8, inner=2, window=2),
    "hybrid_cp8_inner4": dict(algo="hybrid", cp=8, inner=4),
}


@pytest.mark.parametrize("segs", [False, True])
@pytest.mark.parametrize("case", list(FULL))
def test_cp_attention_matches_jax_full_attention(data, case, segs):
    """Every layout, with and without segments, against JAX's full causal
    attention over the unpermuted sequence (the sharded functions'
    reference in the JAX tests)."""
    _check(_port(data, segs=segs, **FULL[case]), _jax_full(data, segs))


def _held_tensors(node, seen=None) -> list:
    """Tensors a graph's custom Function contexts keep as attributes (not
    through save_for_backward, where saved-tensor hooks see them)."""
    seen = set() if seen is None else seen
    if node is None or node in seen:
        return []
    seen.add(node)
    held = []
    for val in getattr(node, "__dict__", {}).values():
        vals = val if isinstance(val, (tuple, list)) else (val,)
        held += [v for v in vals if isinstance(v, torch.Tensor)]
    for nxt, _ in node.next_functions:
        held += _held_tensors(nxt, seen)
    return held


@pytest.mark.parametrize("algo", ["ring", "ulysses", "hybrid"])
def test_checkpointed_cp_attention_saves_through_hooks(data, algo):
    """Under torch.utils.checkpoint (the decoder's remat), every residual of
    the cp attention goes through saved-tensor hooks, so the checkpoint frees
    the full-sequence head groups after the forward and recomputes them: no
    Function context holds a tensor, the hooks see the residuals, and the
    gradients still match JAX's full attention."""
    from torch.utils.checkpoint import checkpoint

    cp, inner = 4, 2
    z = _zig(algo, cp, inner)
    q, k, v, w = (tzz.zigzag_permute(torch.as_tensor(data[x]), z) for x in "qkvw")
    n = S // cp
    fn = {"ring": lambda ql, kl, vl, comm: ring_attention(ql, kl, vl, comm),
          "ulysses": lambda ql, kl, vl, comm: ulysses_attention(ql, kl, vl, comm),
          "hybrid": lambda ql, kl, vl, comm: hybrid_attention(ql, kl, vl, comm, inner)}[algo]

    def rank(comm):
        sl = slice(comm.rank * n, (comm.rank + 1) * n)
        ql, kl, vl = (x[:, sl].clone().requires_grad_() for x in (q, k, v))
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn(ql.detach(), kl.detach(), vl.detach().requires_grad_(), comm)
        o = checkpoint(fn, ql, kl, vl, comm, use_reentrant=False)
        held = _held_tensors(o.grad_fn)
        (o * w[:, sl]).sum().backward()
        return o.detach(), ql.grad, kl.grad, vl.grad, held, shapes

    res = run_thread_ranks(rank, cp, timeout=60)
    for r in res:
        assert r[4] == [], [t.shape for t in r[4]]
    if algo != "ring":  # the lanes' head groups of the whole (ring group's) sequence
        lanes = cp if algo == "ulysses" else inner
        assert (B, n * lanes, HQ // lanes, D) in res[0][5], res[0][5]
    got = [tzz.zigzag_unpermute(torch.cat([r[i] for r in res], 1), z).numpy() for i in range(4)]
    _check(got, _jax_full(data, False))


def test_ulysses_head_divisibility_raises():
    """6 q heads do not split over cp 4."""
    q, k = torch.zeros(1, 8, 6, D), torch.zeros(1, 8, 2, D)
    with pytest.raises(ValueError, match="not divisible"):
        run_thread_ranks(lambda comm: ulysses_attention(q, k, k, comm), 4, timeout=30)
