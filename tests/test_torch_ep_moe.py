"""PyTorch port: the mixture of experts over ranks (ops/moe.py) against the
JAX package's moe_mlp, on the CPU (f32; 4 experts, top-2, capacity factor
0.5, so that copies drop: every case asserts the port dropped some):

  - expert parallelism: moe_mlp over an expert communicator of 2 and 4
    thread-ranks (each its rows and E / ep experts) against JAX's
    moe_mlp(axis_name=...) under shard_map (its aux pmean over the axis):
    the output, the aux and the gradients of the input rows, the router and
    the expert shards by jax.grad, to 1e-5;
  - one routing batch spread over ranks (cp's sequence shards, global slot
    ids and capacity): 2 and 4 thread-ranks, each a slice of every row's
    sequence, against JAX's moe_mlp on the whole batch (one call), output,
    aux and gradients to 1e-5; with aux_share (the tp ranks that route the
    same gathered tokens) the summed gradient is counted once;
  - the expert exchange (the tiled all_to_all there and back, and its
    backward) on 2 and 3 thread-ranks and 3 gloo processes, against every
    expert run on every rank's slots in one place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from long_vita_tpu.ops import moe as jmoe
from long_vita_tpu_torch.models import qwen2 as tq
from long_vita_tpu_torch.ops import moe as tmoe
from long_vita_tpu_torch.parallel.comm import init_process_group, run_thread_ranks
from test_torch_comm import run_gloo
from test_torch_quantize import one_torch_thread  # noqa: F401

E, TOP_K, CAP, H, I = 4, 2, 0.5, 16, 24
COEF = 0.37  # the aux's weight in the tests' objective
TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT = 120


def _weights(seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"router": n(H, E, scale=1.0), "gate": n(E, H, I), "up": n(E, H, I),
            "down": n(E, I, H)}


def _inputs(b, s, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, H)).astype(np.float32),
            rng.standard_normal((b, s, H)).astype(np.float32))


def _jax_params(router, gate, up, down):
    return {"router": {"kernel": router}, "experts": {"gate": gate, "up": up, "down": down}}


def _port_params(w, experts=slice(None)):
    """A MoEParams of the numpy weights (the experts ``experts`` of them),
    every leaf requiring its gradient."""
    p = tmoe.MoEParams(tq.Dense(torch.from_numpy(w["router"].T.copy())),
                       tmoe.Experts(*(torch.from_numpy(w[k][experts].copy())
                                      for k in ("gate", "up", "down"))))
    for t in p.parameters():
        t.requires_grad_()
    return p


def _port_grads(p):
    return (p.router.weight.grad.numpy().T, p.experts.gate.grad.numpy(),
            p.experts.up.grad.numpy(), p.experts.down.grad.numpy())


def _jax_ep(w, x, dout, ep):
    """JAX's moe_mlp over an ``ep`` axis inside shard_map (JAX's
    _moe_mlp_block's EP body): -> out, aux, grads of (router, gate, up,
    down, x) of sum(out * dout) + COEF * aux."""
    mesh = JMesh(np.array(jax.devices()[:ep]), ("ep",))

    def body(router, gate, up, down, x_):
        out, aux = jmoe.moe_mlp(_jax_params(router, gate, up, down), x_, top_k=TOP_K,
                                capacity_factor=CAP, axis_name="ep")
        return out, jax.lax.pmean(aux, "ep")

    fn = jax.shard_map(body, mesh=mesh, in_specs=(P(), P("ep"), P("ep"), P("ep"), P("ep")),
                       out_specs=(P("ep"), P()))

    def objective(*a):
        out, aux = fn(*a)
        return jnp.sum(out * dout) + COEF * aux, (out, aux)

    args = tuple(jnp.asarray(w[k]) for k in ("router", "gate", "up", "down")) + (jnp.asarray(x),)
    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(objective, range(5), has_aux=True))(*args)
    return np.asarray(out), float(aux), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("ep", [2, 4])
def test_expert_parallel_moe_mlp_matches_jax(ep, one_torch_thread):
    """Each thread-rank routes its 2 rows with its own capacity and holds E /
    ep experts; rows go to their owner and back. The aux is each rank's
    own, averaged over ep (JAX's pmean); the router's gradient is summed
    over the ranks, each expert's is its owner's."""
    w = _weights(ep)
    x, dout = _inputs(2 * ep, 8)
    want_out, want_aux, want_g = _jax_ep(w, x, dout, ep)
    rows, e_local = x.shape[0] // ep, E // ep
    tmoe.reset_stats()

    def rank(comm):
        r = comm.rank
        p = _port_params(w, slice(r * e_local, (r + 1) * e_local))
        xr = torch.from_numpy(x[r * rows:(r + 1) * rows].copy()).requires_grad_()
        out, aux = tmoe.moe_mlp(p, xr, top_k=TOP_K, capacity_factor=CAP, axis_name=comm)
        obj = (out * torch.from_numpy(dout[r * rows:(r + 1) * rows])).sum() + COEF * aux / ep
        obj.backward()
        mean_aux = comm.all_reduce_sum(aux.detach()) / ep
        g_router = comm.all_reduce_sum(p.router.weight.grad)
        return (out.detach().numpy(), mean_aux.item(), xr.grad.numpy(),
                g_router.numpy().T, _port_grads(p)[1:])

    got = run_thread_ranks(rank, ep, timeout=TIMEOUT)
    assert tmoe.stats()["dropped"] > 0
    np.testing.assert_allclose(np.concatenate([g[0] for g in got]), want_out, **TOL)
    for g in got:
        np.testing.assert_allclose(g[1], want_aux, **TOL)
        np.testing.assert_allclose(g[3], want_g[0], **TOL)
    np.testing.assert_allclose(np.concatenate([g[2] for g in got]), want_g[4], **TOL)
    for k in range(3):  # gate, up, down: each rank its own experts' whole gradient
        np.testing.assert_allclose(np.concatenate([g[4][k] for g in got]), want_g[k + 1], **TOL)


@pytest.mark.parametrize("ranks,share", [(2, 1), (4, 1), (2, 2)])
def test_routing_batch_over_ranks_matches_one_jax_call(ranks, share, one_torch_thread):
    """A routing batch whose rows' sequence is cut over ``ranks`` ranks (cp's
    shards, in rank order) routes as JAX's moe_mlp on the whole batch: the
    global slots (the copies of the rows, and of the ranks before, first)
    and capacity, the aux from the summed statistics. With share 2 every
    sequence rank is doubled (two ranks routing the same tokens, as the tp
    ranks after sequence parallelism's gather), the experts' intermediate
    dim is cut between the two and their outputs summed: the aux's
    gradient scaled by 1/2 on each, the router's gradient summed over all
    ranks, is the whole one."""
    w = _weights(10 + ranks)
    x, dout = _inputs(3, 8 * ranks, seed=ranks)

    def objective(router, gate, up, down, x_):
        out, aux = jmoe.moe_mlp(_jax_params(router, gate, up, down), x_, top_k=TOP_K,
                                capacity_factor=CAP)
        return jnp.sum(out * dout) + COEF * aux, (out, aux)

    args = tuple(jnp.asarray(w[k]) for k in ("router", "gate", "up", "down")) + (jnp.asarray(x),)
    (_, (want_out, want_aux)), want_g = jax.jit(jax.value_and_grad(
        objective, range(5), has_aux=True))(*args)
    s = x.shape[1] // ranks
    tmoe.reset_stats()

    def rank(comm):
        c, t = divmod(comm.rank, share)
        seq = comm.split([[q * share + u for q in range(ranks)] for u in range(share)])
        tp = comm.split([[q * share + u for u in range(share)] for q in range(ranks)])
        cols = slice(t * I // share, (t + 1) * I // share)
        p = _port_params({"router": w["router"], "gate": w["gate"][:, :, cols],
                          "up": w["up"][:, :, cols], "down": w["down"][:, cols]})
        xr = torch.from_numpy(x[:, c * s:(c + 1) * s].copy()).requires_grad_()
        out, aux = tmoe.moe_mlp(p, xr, top_k=TOP_K, capacity_factor=CAP, seq_comm=seq,
                                aux_share=share)
        # each rank's part of the output: the objective's sum over the ranks
        obj = (out * torch.from_numpy(dout[:, c * s:(c + 1) * s])).sum() + COEF * aux
        obj.backward()
        out = tp.all_reduce_sum(out.detach()) if share > 1 else out
        g_x = tp.all_reduce_sum(xr.grad) if share > 1 else xr.grad
        g_router = comm.all_reduce_sum(p.router.weight.grad)
        g_exp = [seq.all_reduce_sum(g) for g in (p.experts.gate.grad, p.experts.up.grad,
                                                  p.experts.down.grad)]
        return out.detach().numpy(), aux.item(), g_x.numpy(), g_router.numpy().T, g_exp, t

    got = run_thread_ranks(rank, ranks * share, timeout=TIMEOUT)
    assert tmoe.stats()["dropped"] > 0
    mine = [g for g in got if g[5] == 0]
    np.testing.assert_allclose(np.concatenate([g[0] for g in mine], 1), want_out, **TOL)
    np.testing.assert_allclose(np.concatenate([g[2] for g in mine], 1), want_g[4], **TOL)
    for g in got:
        np.testing.assert_allclose(g[1], float(want_aux), **TOL)
        np.testing.assert_allclose(g[3], want_g[0], **TOL)
        t = g[5]
        cols = slice(t * I // share, (t + 1) * I // share)
        np.testing.assert_allclose(g[4][0].numpy(), np.asarray(want_g[1])[:, :, cols], **TOL)
        np.testing.assert_allclose(g[4][1].numpy(), np.asarray(want_g[2])[:, :, cols], **TOL)
        np.testing.assert_allclose(g[4][2].numpy(), np.asarray(want_g[3])[:, cols], **TOL)


def _expert_exchange(comm):
    """Each rank's [E, C, H] slots (E = 2 * ranks) through the experts over
    ``comm`` (each rank 2 of them): the output and the gradients of the
    slots and of the rank's experts, against every expert run here on every
    rank's slots."""
    n, r = comm.size, comm.rank
    e, c = 2 * n, 3
    g = torch.Generator().manual_seed(7)
    full = tmoe.Experts(*(0.3 * torch.randn(shape, generator=g)
                          for shape in ((e, H, I), (e, H, I), (e, I, H))))
    slots = [torch.randn((e, c, H), generator=g) for _ in range(n)]
    douts = [torch.randn((e, c, H), generator=g) for _ in range(n)]
    mine = tmoe.Experts(*(t[2 * r:2 * r + 2].clone() for t in (full.gate, full.up, full.down)))
    for t in (*mine.parameters(), *full.parameters()):
        t.requires_grad_()
    x = slots[r].clone().requires_grad_()
    out = tmoe._expert_parallel(mine, x, comm)
    (out * douts[r]).sum().backward()
    xs = [t.clone().requires_grad_() for t in slots]
    want = [tmoe._expert_mlp(full, t) for t in xs]
    sum((w * d).sum() for w, d in zip(want, douts)).backward()
    close = lambda a, b: bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5))  # noqa: E731
    return (close(out, want[r]) and close(x.grad, xs[r].grad)
            and all(close(m.grad, f.grad[2 * r:2 * r + 2])
                    for m, f in zip((mine.gate, mine.up, mine.down),
                                    (full.gate, full.up, full.down))))


@pytest.mark.parametrize("n", [2, 3])
def test_expert_exchange_on_thread_ranks(n, one_torch_thread):
    assert all(run_thread_ranks(_expert_exchange, n, timeout=TIMEOUT))


def _gloo_worker(rank, world, init, out):
    torch.set_num_threads(1)
    try:
        comm = init_process_group(rank, world, init, backend="gloo", timeout=30.0)
        out.put((rank, _expert_exchange(comm)))
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        out.put((rank, f"raised {type(e).__name__}: {e}"))


def test_expert_exchange_over_gloo():
    got = run_gloo(_gloo_worker, 3)
    assert got == {0: True, 1: True, 2: True}, got
