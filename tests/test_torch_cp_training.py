"""Training over a dp x cp mesh in the port against the JAX package, on the
CPU: the zigzag batches of batch_iterator (ring, Ulysses, hybrid) against
the JAX trainer's; then the Trainer over thread-ranks (ring, the double
ring, Ulysses, hybrid; dp x cp) and over two gloo processes, held to the JAX
train step on the same whole batches on one device (the loss and the
gradients are global sums, so the mesh must not change them): losses,
grad_norm and the parameters after two steps, f32, rtol 1e-5 as the
one-device parity tests (tests/test_torch_training.py)."""
import copy

import jax
import numpy as np
import pytest
import torch

from long_vita_tpu.data import dataset as jdata
from long_vita_tpu.training import optimizer as jopt
from long_vita_tpu.training import train_step as jts
from long_vita_tpu.training import trainer as jtrainer
from long_vita_tpu_torch.parallel.comm import ThreadComm, init_process_group, run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import make_mesh
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training import train_step as tts
from long_vita_tpu_torch.training.distributed import local_rows, make_global_batch
from long_vita_tpu_torch.training.trainer import MeshConfig, Trainer, TrainerConfig, batch_iterator
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_comm import run_gloo
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_training import CFG, S, _jax_params, _jnp, _named, _pack

RTOL = 1e-5
PACK_SPECS = [dict(seed=1, n_img=2, cuts=(40,)), dict(seed=2, n_img=1, cuts=(20, 50)),
              dict(seed=3, n_img=0, cuts=(30,)), dict(seed=4, n_img=2, cuts=(12, 44))]
OPTIM = dict(lr=1e-3, warmup_steps=1, total_steps=6)


def _packs(cls):
    return [_pack(**spec, pack_cls=cls) for spec in PACK_SPECS]


ZIGZAG = {
    "ring_cp4": dict(cp=4, cp_algo="ring", cp_inner=1),
    "ulysses_cp4": dict(cp=4, cp_algo="ulysses", cp_inner=1),
    "hybrid_cp4_inner2": dict(cp=4, cp_algo="hybrid", cp_inner=2),
}


@pytest.mark.parametrize("case", list(ZIGZAG))
def test_zigzag_batches_match_jax(case):
    kw = ZIGZAG[case]
    want = list(jtrainer.batch_iterator(iter(_packs(jdata.Pack)), 2, S, kw["cp"],
                                        kw["cp_algo"], kw["cp_inner"]))
    got = list(batch_iterator(iter(_packs(tloss.Pack)), 2, S, kw["cp"], kw["cp_algo"],
                              kw["cp_inner"]))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if w[key] is None:
                assert g[key] is None, key
            else:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_rank_batches_cut_rows_and_sequence():
    """local_rows keeps a dp index's rows and their tiles (scatter rows
    rebased); make_global_batch cuts the sequence keys to the cp shard and
    keeps the positions-indexed keys whole."""
    batch = next(batch_iterator(iter(_packs(tloss.Pack)), 4, S, 2))
    comms = ThreadComm.group(4)
    mesh = make_mesh(MeshConfig(dp=2, cp=2), comms[3])  # dp index 1, cp index 1
    rows = local_rows(batch, mesh, 4)
    np.testing.assert_array_equal(rows["tokens"], batch["tokens"][2:])
    keep = batch["image_indices"][0, :, 0] >= 2
    np.testing.assert_array_equal(rows["images"], batch["images"][keep])
    np.testing.assert_array_equal(rows["image_indices"][0], batch["image_indices"][0][keep] - 2)
    dev = make_global_batch(rows, mesh, "cpu")
    np.testing.assert_array_equal(dev["tokens"].numpy(), batch["tokens"][2:, S // 2:])
    np.testing.assert_array_equal(dev["labels"].numpy(), batch["labels"][2:])
    np.testing.assert_array_equal(dev["logit_positions"].numpy(), batch["logit_positions"][2:])


def test_rank_slices_match_jax_batch_and_activation_specs():
    """parallel/sharding's rows and sequence slice of each rank of a dp 2 x
    cp 2 mesh are the shards JAX lays out for batch_spec (P(dp, cp)) and
    activation_spec (P(dp, cp, None)) on a 2 x 2 device mesh."""
    from jax.sharding import Mesh as JMesh, NamedSharding

    from long_vita_tpu.parallel.sharding import activation_spec, batch_spec
    from long_vita_tpu_torch.parallel.sharding import rank_rows, rank_seq

    jmesh = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "cp"))
    x = np.arange(4 * 16 * 3).reshape(4, 16, 3)
    for spec, arr in ((batch_spec(), x[..., 0]), (activation_spec(), x)):
        placed = jax.device_put(arr, NamedSharding(jmesh, spec))
        comms = ThreadComm.group(4)
        for shard in placed.addressable_shards:
            d, c = (int(i) for i in np.argwhere(jmesh.devices == shard.device)[0])
            mesh = make_mesh(MeshConfig(dp=2, cp=2), comms[d * 2 + c])
            want = np.asarray(shard.data)
            np.testing.assert_array_equal(arr[rank_rows(mesh, 4), rank_seq(mesh, 16)], want)


@pytest.fixture(scope="module")
def reference():
    """The JAX train step on the whole, unpermuted batches, one device,
    for each freeze setting: -> {freeze_vision: (params, [metrics])}."""
    out = {}
    batches = list(jtrainer.batch_iterator(iter(_packs(jdata.Pack)), 2, S, 1))
    for fv in (False, True):
        flags = dict(freeze_vision=fv, freeze_text=False)
        jparams = _jax_params(0)
        jtx = jopt.make_optimizer(jparams, jopt.OptimizerConfig(**OPTIM, freeze_vision=fv), 2)
        step = jts.make_train_step(CFG, jtx, None, remat=False, vision_chunk=2, **flags)
        state = jts.init_train_state(jparams, jtx)
        metrics = []
        for b in batches:
            state, m = step(state, _jnp(b))
            metrics.append({k: float(v) for k, v in m.items()})
        out[fv] = (_named(state.params), metrics)
    return out


def _tcfg(mesh, algo, inner, window, fv, lora_only=False):
    return TrainerConfig(
        seq_len=S, logit_budget=S, global_batch=2, steps=2, mesh=mesh, remat=False,
        vision_chunk=2, cp_algo=algo, cp_inner=inner, cp_window=window,
        optim=topt.OptimizerConfig(**OPTIM, freeze_vision=fv, lora_only=lora_only),
    )


def _train(params, mesh, algo, inner, window, fv, comm, cfg=CFG, lora_only=False):
    """One rank: a Trainer over ``comm`` on the zigzag stream; -> (losses,
    grad norms, named parameters)."""
    tr = Trainer(params, cfg, _tcfg(mesh, algo, inner, window, fv, lora_only), comm=comm)
    norms = []
    step_fn = tr.step_fn

    def logged(state, batch):
        state, m = step_fn(state, batch)
        norms.append(float(m["grad_norm"]))
        return state, m

    tr.step_fn = logged
    it = batch_iterator(iter(_packs(tloss.Pack)), 2, S, mesh.cp, algo, inner)
    losses = tr.train(it)["losses"]
    return losses, norms, {n: p.detach().clone() for n, p in tr.state.params.named_parameters()}


def _check(got, want):
    losses, norms, params = got
    wparams, wmetrics = want
    np.testing.assert_allclose(losses, [m["loss"] for m in wmetrics], rtol=RTOL)
    np.testing.assert_allclose(norms, [m["grad_norm"] for m in wmetrics], rtol=RTOL)
    for n, p in params.items():
        np.testing.assert_allclose(p.numpy(), wparams[n].numpy(), rtol=RTOL, atol=1e-6, err_msg=n)


MESHES = {
    "dp2_cp2_ring": dict(mesh=MeshConfig(dp=2, cp=2), algo="ring", inner=1, window=0, fv=True),
    "cp4_ring_window2": dict(mesh=MeshConfig(cp=4), algo="ring", inner=1, window=2, fv=True),
    "cp4_ulysses": dict(mesh=MeshConfig(cp=4), algo="ulysses", inner=1, window=0, fv=False),
    "cp4_hybrid_inner2": dict(mesh=MeshConfig(cp=4), algo="hybrid", inner=2, window=0,
                              fv=False),
}


@pytest.mark.parametrize("case", list(MESHES))
def test_trainer_over_thread_ranks_matches_jax(case, reference, one_torch_thread):
    """Every rank trains its own copy of the weights; all must end equal to
    the JAX step's. fv: a frozen tower (encoded 1/cp a rank, K3's path on
    the card); else the tower trains on every rank."""
    kw = MESHES[case]
    base = long_vita_params_from_jax(_jax_params(0), device="cpu")
    res = run_thread_ranks(
        lambda comm: _train(copy.deepcopy(base), kw["mesh"], kw["algo"], kw["inner"],
                            kw["window"], kw["fv"], comm),
        kw["mesh"].size, timeout=120)
    for got in res:
        _check(got, reference[kw["fv"]])


def test_lora_only_over_a_mesh_folds_summed_frozen_gradients(one_torch_thread):
    """lora_only over dp 2 x cp 2 (ring, thread-ranks): a mask-frozen base
    gradient is summed over the ranks before it is folded into the norm, so
    losses, grad_norm and every parameter after two steps match the JAX
    lora_only step on the whole batches (rtol 1e-5); a decoder layer's is
    folded in its hook, so at every all-reduce over the world at most one
    decoder base gradient is held. In the second step dp rank 0's row has no
    image: the projector's frozen gradient reaches one dp rank only."""
    from test_torch_lora import _adapted

    jparams, jcfg, params, cfg = _adapted(("q_proj", "v_proj", "o_proj", "down_proj"))
    optim = dict(**OPTIM, lora_only=True, freeze_vision=True)
    jtx = jopt.make_optimizer(jparams, jopt.OptimizerConfig(**optim), 2)
    jstep = jts.make_train_step(jcfg, jtx, None, remat=False, vision_chunk=2,
                                freeze_vision=True, freeze_text=False)
    state, metrics = jts.init_train_state(jparams, jtx), []
    for b in jtrainer.batch_iterator(iter(_packs(jdata.Pack)), 2, S, 1):
        state, m = jstep(state, _jnp(b))
        metrics.append({k: float(v) for k, v in m.items()})
    base = [n for n, _ in params.named_parameters()
            if n.startswith("text.layers.") and ".lora." not in n]

    def rank(comm):
        mine = copy.deepcopy(params)
        named, held, reduce = dict(mine.named_parameters()), [], comm.all_reduce_sum

        def watched(x):
            held.append(sum(named[n].grad is not None for n in base))
            return reduce(x)

        comm.all_reduce_sum = watched
        got = _train(mine, MeshConfig(dp=2, cp=2), "ring", 1, 0, True, comm, cfg, True)
        return got, held

    for got, held in run_thread_ranks(rank, 4, timeout=120):
        _check(got, (_named(state.params), metrics))
        assert max(held) == 1, held  # a hook's own gradient, and no other


def _gloo_train_worker(rank, world, init, tree, out):
    torch.set_num_threads(1)
    try:
        comm = init_process_group(rank, world, init, backend="gloo", timeout=60.0)
        params = long_vita_params_from_jax(tree, device="cpu")
        got = _train(params, MeshConfig(cp=2), "ring", 1, 0, True, comm)
        out.put((rank, (got[0], got[1], {n: p.numpy() for n, p in got[2].items()})))
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        out.put((rank, f"raised {type(e).__name__}: {e}"))


def test_trainer_over_gloo_processes_matches_jax(reference):
    """cp 2 ring training over a gloo process group of two processes (the
    DistComm the card's NCCL run takes)."""
    tree = jax.tree.map(np.asarray, _jax_params(0))
    got = run_gloo(_gloo_train_worker, 2, tree, join_timeout=180)
    assert sorted(got) == [0, 1], got
    for rank, res in got.items():
        assert not isinstance(res, str), res
        losses, norms, params = res
        _check((losses, norms, {n: torch.as_tensor(p) for n, p in params.items()}),
               reference[True])


def test_thread_ranks_do_not_train_on_cuda():
    """On CUDA, autograd's one device thread would deadlock thread-ranks
    whose backward passes wait for each other: the step raises, naming it."""
    comms = ThreadComm.group(2)
    mesh = make_mesh(MeshConfig(cp=2), comms[0])
    tts._check_mesh(mesh, "cpu")
    with pytest.raises(RuntimeError, match="autograd engine"):
        tts._check_mesh(mesh, torch.device("cuda"))
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        tts.make_train_step(CFG, None, mesh=object())
