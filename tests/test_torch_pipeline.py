"""PyTorch port: pipeline parallelism (parallel/pipeline.py, the pp axis
of parallel/mesh.py, the pipelined decoder of models/qwen2.py) against the
JAX package, on the CPU in f32. JAX runs on the conftest's 8 virtual CPU
devices under shard_map, the port on thread-ranks (parallel.comm.
ThreadComm), one a stage:

  - pipeline_apply (GPipe) at pp 2 and 4 and pipeline_apply_interleaved at
    JAX's own cases (pp, v, M) = (4, 2, 8), (2, 4, 2), (2, 2, 6) against
    JAX's functions on a tanh stack: the last stage's outputs and the
    gradients of the whole stack and of the microbatches at 2e-5;
  - interleave_permutation, permute_layer_stack (and its inverse) and
    stage_layers against JAX's permutation: equal;
  - the pipelined decoder (pp 2, pp 2 x v 2, pp 2 x tp 2) at
    tiny_test_config() with 4 layers against JAX's _pipelined_decoder
    through qwen2_decoder on the same mesh: the hidden states at 2e-5, the
    gradients of the layers and of the embeddings at 1e-4 relative + 1e-6;
  - the mesh: every rank's (dp, pp, cp, tp) coordinates and every axis
    group against JAX make_mesh's device array; validate_geometry's pp
    checks against JAX's, message for message.

Training over pp is in tests/test_torch_pp_training.py, the checkpoints
and the slice loader in tests/test_torch_pp_checkpoint.py, the chip
phase's gates in tests/test_torch_pp_gate.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.models import qwen2 as jq
from long_vita_tpu.parallel import pipeline as jpl
from long_vita_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
from long_vita_tpu_torch.models import qwen2 as tq
from long_vita_tpu_torch.parallel import pipeline as tpl
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.parallel.sharding import gather_named, leaf_layout, shard_params
from long_vita_tpu_torch.utils.convert import params_from_jax
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_training import _jax_params

TIMEOUT = 120.0
TOL = 2e-5


# ---- the schedules ---------------------------------------------------------------


def _stack(seed, n_layers=8, h=16, m=6, b=2):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_layers, h, h)) * 0.3).astype(np.float32)
    x = rng.standard_normal((m, b, h)).astype(np.float32)
    return w, x


def _jbody(stage_w, xx):
    def layer(carry, w):
        return jnp.tanh(carry @ w), None

    out, _ = jax.lax.scan(layer, xx, stage_w)
    return out


def _tbody(stage_w, xx):
    for w in stage_w:
        xx = torch.tanh(xx @ w)
    return xx


CASES = [(2, 1, 4), (4, 1, 6), (4, 2, 8), (2, 4, 2), (2, 2, 6)]


@pytest.mark.parametrize("pp,v,m", CASES, ids=[f"pp{p}_v{v}_m{m}" for p, v, m in CASES])
def test_schedules_match_jax(pp, v, m):
    """GPipe (v 1, JAX's pipeline_apply) and the interleaved schedule (JAX's
    pipeline_apply_interleaved on the chunk-major stack): outputs and the
    gradients of sum(out ** 2) w.r.t. the whole stack (canonical order) and
    the microbatches."""
    w, x = _stack(pp * 10 + v, m=m)
    perm = jpl.interleave_permutation(w.shape[0], pp, v)
    jmesh = JMesh(np.asarray(jax.devices()[:pp]), ("pp",))
    if v == 1:
        inner = lambda ww, xx: jpl.pipeline_apply(ww, xx, _jbody, "pp")  # noqa: E731
    else:
        inner = lambda ww, xx: jpl.pipeline_apply_interleaved(  # noqa: E731
            ww, xx, _jbody, "pp", virtual=v)
    fn = jax.jit(shard_map(inner, mesh=jmesh, in_specs=(P("pp", None, None), P()),
                           out_specs=P(), check_vma=False))
    jperm = jnp.asarray(perm)
    want = np.asarray(fn(jnp.take(jnp.asarray(w), jperm, 0), jnp.asarray(x)))
    gw_want, gx_want = jax.grad(lambda ww, xx: jnp.sum(fn(jnp.take(ww, jperm, 0), xx) ** 2),
                                (0, 1))(jnp.asarray(w), jnp.asarray(x))
    per = w.shape[0] // pp

    def rank(comm):
        d = comm.rank
        ws = torch.as_tensor(w[perm][d * per:(d + 1) * per]).clone().requires_grad_()
        xs = torch.as_tensor(x).clone().requires_grad_()
        fn_t = tpl.pipeline_apply if v == 1 else tpl.pipeline_apply_interleaved
        out, anchor = (fn_t(ws, xs, _tbody, comm) if v == 1
                       else fn_t(ws, xs, _tbody, comm, virtual=v))
        loss = (out ** 2).sum() if out is not None else torch.zeros(())
        (loss + anchor).backward()
        return out, ws.grad, xs.grad

    res = run_thread_ranks(rank, pp, timeout=TIMEOUT)
    assert all(r[0] is None for r in res[:-1])
    np.testing.assert_allclose(res[-1][0].detach().numpy(), want, rtol=TOL, atol=TOL)
    gw = torch.cat([r[1] for r in res]).numpy()
    np.testing.assert_allclose(gw[np.argsort(perm)], np.asarray(gw_want), rtol=TOL, atol=TOL)
    # the microbatches enter on stage 0 alone
    np.testing.assert_allclose(res[0][2].numpy(), np.asarray(gx_want), rtol=TOL, atol=TOL)
    assert all(r[2] is None for r in res[1:])


@pytest.mark.parametrize("n,pp,v", [(8, 2, 2), (8, 4, 2), (8, 2, 4), (16, 4, 2), (8, 4, 1)])
def test_interleave_permutation_matches_jax(n, pp, v):
    """The permutation, the stack laid out chunk-major and back (a tensor
    and a list of layers), each stage's layers, and the stage counts."""
    perm = tpl.interleave_permutation(n, pp, v)
    assert perm == jpl.interleave_permutation(n, pp, v)
    rng = np.random.default_rng(n + pp + v)
    stack = rng.standard_normal((n, 3)).astype(np.float32)
    want = np.asarray(jpl.permute_layer_stack({"w": jnp.asarray(stack)}, pp, v)["w"])
    got = tpl.permute_layer_stack(torch.as_tensor(stack), pp, v)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tpl.permute_layer_stack(got, pp, v, inverse=True)
    np.testing.assert_array_equal(back.numpy(), stack)
    jback = jpl.permute_layer_stack({"w": jnp.asarray(want)}, pp, v, inverse=True)["w"]
    np.testing.assert_array_equal(np.asarray(jback), stack)
    layers = list(range(n))
    assert tpl.permute_layer_stack(layers, pp, v) == perm
    assert tpl.permute_layer_stack(perm, pp, v, inverse=True) == layers
    assert sum((tpl.stage_layers(n, pp, v, d) for d in range(pp)), []) == perm
    if v == 1:
        assert tpl.permute_layer_stack(layers, pp, 1) is layers
    assert tpl.ticks(pp * 2, pp, v) == (pp * 2) * v + pp - 1
    with pytest.raises(ValueError, match="not divisible"):
        tpl.split_stages(torch.zeros(n + 1, 2), pp)


# ---- the pipelined decoder ---------------------------------------------------------


def _text_cfg():
    return dataclasses.replace(tiny_test_config().text, num_hidden_layers=4)


def _jtext_params(cfg, seed=0):
    """JAX's decoder with non-trivial norms and biases (f32)."""
    base = tiny_test_config()
    return _jax_params(seed, dataclasses.replace(base, text=cfg))["text"]


DECODER_CASES = {"pp2": dict(pp=2, v=1, tp=1, m=2), "pp2_v2": dict(pp=2, v=2, tp=1, m=4),
                 "pp2_tp2": dict(pp=2, v=1, tp=2, m=2)}


@pytest.mark.parametrize("case", list(DECODER_CASES))
def test_pipelined_decoder_matches_jax(case, one_torch_thread):
    """qwen2_decoder over pp (JAX's _pipelined_decoder under jit, the stack
    pre-permuted for v 2; the port's stage trees cut by shard_params) on 4
    rows of 16 tokens with two segments: the final-normed hidden states of
    the last stage at 2e-5, and the gradients of sum(hidden * r) (r a fixed
    random tensor) w.r.t. every decoder leaf the layers hold and w.r.t. the
    embeddings at 1e-4 relative + 1e-6. Under tp the last stage's ranks
    hold their sequence slices and each backpropagates its own part."""
    kw = DECODER_CASES[case]
    pp, v, tp, m = kw["pp"], kw["v"], kw["tp"], kw["m"]
    cfg = _text_cfg()
    jparams = _jtext_params(cfg)
    rng = np.random.default_rng(1)
    b, s, h = 4, 16, cfg.hidden_size
    embeds = rng.standard_normal((b, s, h)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32).copy()
    pos[:, 10:] -= 10
    seg = np.zeros((b, s), np.int32)
    seg[:, 10:] = 1
    r = rng.standard_normal((b, s, h)).astype(np.float32)
    jmesh = j_make_mesh(JMeshConfig(pp=pp, tp=tp), devices=jax.devices()[:pp * tp])
    jpar = jq.ParallelConfig(jmesh, microbatches=m, virtual_pp=v)
    layers_perm = jpl.permute_layer_stack(jparams["layers"], pp, v)

    def jloss(layers, e):
        p = {**jparams, "layers": layers}
        out, _ = jq.qwen2_decoder(p, e, jnp.asarray(pos), cfg, segment_ids=jnp.asarray(seg),
                                  attn_impl="xla", parallel=jpar)
        return jnp.sum(out * jnp.asarray(r)), out

    (_, want), (g_layers, g_embeds) = jax.jit(jax.value_and_grad(jloss, (0, 1), has_aux=True))(
        layers_perm, jnp.asarray(embeds))
    g_layers = jpl.permute_layer_stack(g_layers, pp, v, inverse=True)
    # the JAX gradients by the port's parameter names
    want_grads = {n: t for n, t in params_from_jax(
        {**jax.tree.map(jnp.zeros_like, jparams), "layers": g_layers},
        device="cpu").named_parameters() if n.startswith("layers.")}
    whole = params_from_jax(jparams, device="cpu")

    def rank(comm):
        mesh = make_mesh(MeshConfig(pp=pp, tp=tp), comm)
        local = shard_params(whole, mesh, cfg, own=True, virtual_pp=v)
        for p in local.parameters():
            p.requires_grad_(True)
        par = tq.ParallelConfig(mesh, microbatches=m)
        n = s // tp
        sl = slice(mesh.tp_index * n, (mesh.tp_index + 1) * n)
        e = torch.as_tensor(embeds[:, sl]).clone().requires_grad_()
        hidden, _, anchor = tq.qwen2_decoder(
            local, e if local.pp.first else None, torch.as_tensor(pos), cfg,
            segment_ids=torch.as_tensor(seg), attn_impl="xla", parallel=par,
            return_anchor=True)
        loss = anchor
        if hidden is not None:
            loss = loss + (hidden * torch.as_tensor(r[:, sl])).sum()
        loss.backward()
        grads = {nm: p.grad for nm, p in local.named_parameters() if nm.startswith("layers.")}
        layout = leaf_layout(local, cfg, mesh.tp_index, tp, stage=local.pp)
        # a replicated leaf's gradient is partial on each tp rank (its slice)
        grads = {nm: g if layout[nm].sharded else mesh.tp_comm.all_reduce_sum(g)
                 for nm, g in grads.items()}
        whole_grads = gather_named(grads, layout, mesh.tp_comm, stage=local.pp)
        return (mesh.pp_index, mesh.tp_index, hidden, e.grad if local.pp.first else None,
                whole_grads)

    res = run_thread_ranks(rank, pp * tp, timeout=TIMEOUT)
    last = [x for x in res if x[0] == pp - 1]
    got = np.concatenate([x[2].detach().numpy() for x in sorted(last, key=lambda x: x[1])], 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    assert all(x[2] is None for x in res if x[0] != pp - 1)
    first = sorted([x for x in res if x[0] == 0], key=lambda x: x[1])
    ge = np.concatenate([x[3].numpy() for x in first], 1)
    np.testing.assert_allclose(ge, np.asarray(g_embeds), rtol=1e-4, atol=1e-6)
    grads = res[0][4]
    assert set(grads) == set(want_grads)
    for nm, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[nm].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=nm)


def test_decoder_refuses_a_whole_tree_on_a_pp_mesh():
    """A pp mesh runs a stage's tree (shard_params cuts it); a MoE decoder
    over pp is accepted (tests/test_torch_ep_pipeline.py trains it), unless
    dp does not divide its experts."""
    cfg = _text_cfg()
    whole = params_from_jax(_jtext_params(cfg), device="cpu")

    def rank(comm):
        mesh = make_mesh(MeshConfig(pp=2), comm)
        with pytest.raises(ValueError, match="stage's tree"):
            tq.qwen2_decoder(whole, torch.zeros(2, 4, cfg.hidden_size),
                             torch.zeros(2, 4, dtype=torch.long), cfg, attn_impl="xla",
                             parallel=tq.ParallelConfig(mesh))
        return True

    assert all(run_thread_ranks(rank, 2, timeout=TIMEOUT))
    tq.check_moe_mesh(dataclasses.replace(cfg, num_experts=4), dp=2, pp=2)
    with pytest.raises(ValueError, match="3 experts do not divide over dp 2"):
        tq.check_moe_mesh(dataclasses.replace(cfg, num_experts=3), dp=2, pp=2)


# ---- the mesh --------------------------------------------------------------------


MESHES = [dict(pp=2), dict(pp=4, tp=2), dict(dp=2, pp=2, tp=2), dict(dp=2, pp=2, cp=2)]


@pytest.mark.parametrize("dims", MESHES, ids=["_".join(f"{k}{v}" for k, v in d.items())
                                              for d in MESHES])
def test_mesh_ranks_follow_jax_device_array(dims):
    """Rank r's (dp, pp, cp, tp) coordinates are where device r sits in
    JAX's device array [dp, pp, cp, tp, tq], and each axis communicator
    joins the ranks JAX's mesh puts on that axis: tp, cp, dp and pp; the
    replica (cp x tp of a (dp, pp) index), dp x cp of a (pp, tp) index,
    the stage (dp x cp x tp of a pp index) and dp x pp x cp of a tp index."""
    cfg = MeshConfig(**dims)
    arr = np.vectorize(lambda d: d.id)(
        j_make_mesh(JMeshConfig(**dims), devices=jax.devices()[:cfg.size]).devices)[..., 0]

    def rank(comm):
        mesh = make_mesh(cfg, comm)
        me = torch.tensor([comm.rank])
        groups = {name: getattr(mesh, name).all_gather(me).tolist() for name in (
            "tp_comm", "cp_comm", "dp_comm", "pp_comm", "replica_comm", "dp_cp_comm",
            "stage_comm", "dp_pp_cp_comm")}
        return (mesh.dp_index, mesh.pp_index, mesh.cp_index, mesh.tp_index), groups

    for r, ((d, p, c, t), groups) in enumerate(run_thread_ranks(rank, cfg.size,
                                                                timeout=TIMEOUT)):
        assert arr[d, p, c, t] == r
        assert groups["tp_comm"] == arr[d, p, c, :].tolist()
        assert groups["cp_comm"] == arr[d, p, :, t].tolist()
        assert groups["dp_comm"] == arr[:, p, c, t].tolist()
        assert groups["pp_comm"] == arr[d, :, c, t].tolist()
        assert groups["replica_comm"] == arr[d, p].reshape(-1).tolist()
        assert groups["dp_cp_comm"] == arr[:, p, :, t].reshape(-1).tolist()
        assert groups["stage_comm"] == arr[:, p].reshape(-1).tolist()
        assert groups["dp_pp_cp_comm"] == arr[..., t].reshape(-1).tolist()


GEOMETRIES = [dict(mesh=dict(pp=3)), dict(mesh=dict(pp=2, cp=2)),
              dict(mesh=dict(pp=8, tp=8), virtual_pp=3), dict(mesh=dict(pp=2, tp=2, tq=2)),
              dict(mesh=dict(dp=1, pp=8, tp=8), seq_len=32768)]


@pytest.mark.parametrize("geom", GEOMETRIES, ids=["pp3", "pp2_cp2", "pp8_tp8_v3", "pp2_tq2",
                                                  "72b_tp8pp8"])
def test_validate_geometry_over_pp_matches_jax(geom):
    """validate_geometry's pp checks (layers % (pp x virtual_pp), pp and cp
    exclusive, tq with pp) at the 72B's geometry: the port raises where
    JAX raises, with JAX's message, and passes the tp8 x pp8 recipe's
    geometry (tests/test_guardrails.py holds JAX's)."""
    from long_vita_tpu.config import long_vita_72b as j72b
    from long_vita_tpu.parallel.mesh import validate_geometry as jvalidate
    from long_vita_tpu_torch.config import long_vita_72b
    from long_vita_tpu_torch.parallel.mesh import validate_geometry

    kw = {k: v for k, v in geom.items() if k != "mesh"}
    try:
        jvalidate(j72b().text, JMeshConfig(**geom["mesh"]), **kw)
        want = None
    except ValueError as e:
        want = str(e)
    try:
        validate_geometry(long_vita_72b().text, MeshConfig(**geom["mesh"]), **kw)
        got = None
    except ValueError as e:
        got = str(e)
    assert got == want
    assert (want is None) == (geom.get("seq_len") == 32768)
