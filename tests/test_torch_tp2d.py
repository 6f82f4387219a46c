"""PyTorch port: 2-D tensor parallelism (the tq axis: every decoder weight
cut over both matrix dims, the activations' hidden dim over tq) in
training, against the JAX package on conftest's 8-device CPU mesh, at the
tiny configuration in f32 (4/2 heads, hidden 64), the port on ThreadComm
thread-ranks:

  - the mesh: every rank's (dp, cp, tp, tq) coordinates and the members of
    its tp, tq, cp, dp, replica and dp x cp communicators equal JAX
    make_mesh's device array, dp 2 x tp 2 x tq 2 and cp 2 x tp 2 x tq 2;
  - the shards: each rank's tensors equal the matching addressable shards
    of JAX's shard_params on a tq mesh (tp2d), bit for bit; at tp 4 x tq 2
    the whole kv head of the rank's q heads, cut over tq, where GSPMD cuts
    half-heads;
  - comm.py's conjugate pair over a tq communicator (reduce_from_tp after
    a column product, copy_to_tp before a row one, both for RMSNorm's sum
    of squares): each product's gradients, gathered over the ranks, are the
    one-device product's;
  - the lookup on the 2-D table (ids past the table: JAX's plain lookup),
    the CE of the tq-summed logits against JAX's plain head, and the
    forward's plain head (head=True) against JAX's forward;
  - the training loss and every gradient, summed as the step sums them and
    gathered leaf by leaf, against JAX's loss_fn on the same mesh and the
    unsharded run: loss rtol 1e-6, gradients atol 2e-4 (JAX's own
    test_tp2d_grads_match_unsharded): dp 2 x tp 2 x tq 2 (JAX's test's
    rows), tp 1 x tq 2, cp 2 x tp 2 x tq 2 with the ring, cp 2 x tq 2
    Ulysses, and images in the rows with the tower trainable, also on
    63-token rows that do not split over tp (grad_norm too, at 1e-5);
  - the Trainer over 3 steps against JAX's make_train_step on one device
    (1e-5 relative): dp 2 x tp 2 x tq 2, tp 2 x tq 2 with remat "flash"
    and gradient accumulation, lora_only over dp 2 x tp 2 x tq 2;
  - a planted fault, the norms' gradients not summed over tq, must fail;
  - JAX's rejections: hidden % tq, tq x pp, tq x MoE, tq x FSDP.

Checkpoints and the recipe entry over tq are in
tests/test_torch_tp2d_checkpoint.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.data import dataset as jdata
from long_vita_tpu.models import qwen2 as jq
from long_vita_tpu.models.qwen2 import ParallelConfig as JParallel
from long_vita_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
from long_vita_tpu.parallel.sharding import shard_params as j_shard_params
from long_vita_tpu.training import loss as jloss
from long_vita_tpu.training import train_step as jts
from long_vita_tpu.training import trainer as jtrainer
from long_vita_tpu_torch.constants import IGNORE_INDEX
from long_vita_tpu_torch.models import qwen2 as tq2
from long_vita_tpu_torch.parallel import comm as tcomm
from long_vita_tpu_torch.parallel.comm import ThreadComm, run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh, validate_geometry
from long_vita_tpu_torch.parallel.sharding import gather_named, rank_layout, shard_params
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training import train_step as tts
from long_vita_tpu_torch.training.distributed import local_rows, make_global_batch
from long_vita_tpu_torch.training.trainer import Trainer, TrainerConfig, batch_iterator
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_tp_sharding import _as_port, _jax_leaf, _shard_of
from test_torch_tp_training import OPTIM, STEPS, _check, _packs, _reference
from test_torch_training import CFG, S, _jax_params, _jnp, _named

TIMEOUT = 120
LOSS_RTOL = 1e-6  # JAX's test_tp2d_grads_match_unsharded
GRAD_ATOL = 2e-4


def _jmesh(cfg: JMeshConfig):
    return j_make_mesh(cfg, devices=jax.devices()[:cfg.size])


def _dims(mc: MeshConfig) -> dict:
    return {k: v for k, v in dataclasses.asdict(mc).items() if v > 1}


# ---- the mesh -------------------------------------------------------------------


@pytest.mark.parametrize("mc", [MeshConfig(dp=2, tp=2, tq=2), MeshConfig(cp=2, tp=2, tq=2)],
                         ids=["dp2xtp2xtq2", "cp2xtp2xtq2"])
def test_mesh_ranks_follow_jax_device_array(mc):
    arr = np.vectorize(lambda d: d.id)(_jmesh(JMeshConfig(**_dims(mc))).devices)

    def rank(comm):
        mesh = make_mesh(mc, comm)
        me = torch.tensor([comm.rank])
        groups = {k: getattr(mesh, k).all_gather(me).tolist()
                  for k in ("tp_comm", "tq_comm", "cp_comm", "dp_comm", "replica_comm",
                            "dp_cp_comm", "dp_pp_cp_comm")}
        return (mesh.dp_index, mesh.cp_index, mesh.tp_index, mesh.tq_index), groups

    for r, ((d, c, t, q), groups) in enumerate(run_thread_ranks(rank, mc.size, timeout=TIMEOUT)):
        assert arr[d, 0, c, t, q] == r
        assert groups["tp_comm"] == arr[d, 0, c, :, q].tolist()
        assert groups["tq_comm"] == arr[d, 0, c, t, :].tolist()
        assert groups["cp_comm"] == arr[d, 0, :, t, q].tolist()
        assert groups["dp_comm"] == arr[:, 0, c, t, q].tolist()
        assert groups["replica_comm"] == arr[d, 0].reshape(-1).tolist()
        assert groups["dp_cp_comm"] == arr[:, 0, :, t, q].reshape(-1).tolist()
        assert groups["dp_pp_cp_comm"] == groups["dp_cp_comm"]


# ---- the shards -------------------------------------------------------------------


@pytest.mark.parametrize("mc", [MeshConfig(tp=2, tq=2), MeshConfig(tq=2),
                                MeshConfig(tp=4, tq=2)], ids=["tp2xtq2", "tq2", "tp4xtq2"])
def test_shards_equal_jax_shard_params(mc):
    """Each rank's decoder tensors against JAX's shard_params on the same
    tq mesh (its tp2d specs): column kernels [in@tq, out@tp], row kernels
    [in@tp, out@tq], the embedding [V@tp, H@tq], the head [H@tq, V@tp],
    biases [out@tp], norms replicated. The tower and projector are the
    whole tree's tensors."""
    jparams = _jax_params(0)
    port = long_vita_params_from_jax(jparams, device="cpu")
    jmesh = _jmesh(JMeshConfig(**_dims(mc)))
    jsharded = j_shard_params(jparams, jmesh)
    assert tuple(jsharded["text"]["layers"]["q_proj"]["kernel"].sharding.spec) == (
        None, "tq", "tp")
    devices = jmesh.devices.reshape(-1)
    hkv, d, h = CFG.text.num_key_value_heads, CFG.text.head_dim, CFG.text.hidden_size
    comms = ThreadComm.group(mc.size)  # a mesh over them needs no collective
    for r in range(mc.size):
        mesh = make_mesh(mc, comms[r])
        local = shard_params(port, mesh, CFG)
        assert local.text.tq_comm is mesh.tq_comm and local.text.tp_comm is mesh.tp_comm
        assert [p.data_ptr() for p in local.vision.parameters()] == [
            p.data_ptr() for p in port.vision.parameters()]
        for name, got in local.text.named_parameters():
            arr, layer, transpose = _jax_leaf(jsharded, name)
            if mc.tp > hkv and (".k_proj." in name or ".v_proj." in name):
                whole = _as_port(np.asarray(arr), layer, transpose)
                head = mesh.tp_index // (mc.tp // hkv)
                want = whole[head * d:(head + 1) * d]
                if name.endswith(".weight"):  # [out, in@tq]
                    n = h // mc.tq
                    want = want[:, mesh.tq_index * n:(mesh.tq_index + 1) * n]
            else:
                want = _as_port(_shard_of(arr, devices[r]), layer, transpose)
            got = got.detach().numpy()
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r} {name}")


# ---- the conjugate Functions --------------------------------------------------------


@pytest.mark.parametrize("fn", ["column", "row", "rms"])
def test_tq_functions_are_transposes(fn):
    """Each Function inside the product it serves, over 2 thread-ranks,
    against the one-device product: the forward, and every rank's input
    and weight gradients gathered over the ranks, against autograd's."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((3, 5, 8)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((6, 8)).astype(np.float32))
    g = torch.as_tensor(rng.standard_normal((3, 5, 6)).astype(np.float32))

    gx8 = torch.as_tensor(rng.standard_normal((3, 5, 8)).astype(np.float32))

    def whole(x, w):  # the one-device function's output y and <g, y>
        if fn == "rms":  # RMSNorm's scale: the squares over the cut dim
            y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6)
            return y, (y * gx8).sum()
        y = x @ w.t()  # a column kernel (in cut over the ranks) or a row one (out cut)
        return y, (y * g).sum()

    xw, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
    y_ref, loss = whole(xw, ww)
    loss.backward()

    def rank(comm):
        q, n = comm.rank, comm.size
        if fn == "column":
            xl = x[..., q * 4:(q + 1) * 4].clone().requires_grad_()
            wl = w[:, q * 4:(q + 1) * 4].clone().requires_grad_()
            y = tcomm.reduce_from_tp(xl @ wl.t(), comm)
            (y * g).sum().backward()
            return y, comm.all_gather(xl.grad, -1), comm.all_gather(wl.grad, 1)
        if fn == "row":
            xl = x.clone().requires_grad_()
            wl = w[q * 3:(q + 1) * 3].clone().requires_grad_()
            y = tcomm.copy_to_tp(xl, comm) @ wl.t()
            (y * g[..., q * 3:(q + 1) * 3]).sum().backward()
            return comm.all_gather(y, -1), xl.grad, comm.all_gather(wl.grad, 0)
        xl = x[..., q * 4:(q + 1) * 4].clone().requires_grad_()
        sq = tcomm.copy_to_tp(tcomm.reduce_from_tp(xl.square().sum(-1, keepdim=True), comm),
                              comm)
        var = sq / (4 * n)
        y = xl * torch.rsqrt(var + 1e-6)
        (y * gx8[..., q * 4:(q + 1) * 4]).sum().backward()
        return comm.all_gather(y, -1), comm.all_gather(xl.grad, -1), None

    for y, gx, gw in run_thread_ranks(rank, 2, timeout=TIMEOUT):
        torch.testing.assert_close(y, y_ref.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(gx, xw.grad, rtol=1e-6, atol=1e-6)
        if gw is not None:
            torch.testing.assert_close(gw, ww.grad, rtol=1e-6, atol=1e-6)


# ---- the lookup and the head -----------------------------------------------------------


def test_lookup_on_the_2d_table_matches_jax():
    """The sequence-parallel lookup on a tp 2 x tq 2 shard: every rank's
    [B, S/tp, H/tq] block, put back together, equals JAX's plain lookup
    (the one JAX's forward takes under tq, long_vita.py:294-300), ids past
    the table included (the last row), bit for bit."""
    jparams = _jax_params(0)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, CFG.text.vocab_size, (2, 16)).astype(np.int32)
    ids[0, 3] = CFG.text.vocab_size + 5  # past the table
    ids[1, 9] = CFG.text.vocab_size - 1
    want = np.asarray(jq.embed_tokens(jparams["text"], jnp.asarray(ids)))
    np.testing.assert_array_equal(want[0, 3], want[1, 9])
    whole = long_vita_params_from_jax(jparams, device="cpu")
    mc = MeshConfig(tp=2, tq=2)

    def rank(comm):
        mesh = make_mesh(mc, comm)
        return mesh.tp_index, mesh.tq_index, tq2.embed_tokens_vp(
            shard_params(whole, mesh, CFG).text, torch.as_tensor(ids))

    got = np.zeros_like(want)
    for t, q, rows in run_thread_ranks(rank, mc.size, timeout=TIMEOUT):
        got[:, t * 8:(t + 1) * 8, q * 32:(q + 1) * 32] = rows.numpy()
    np.testing.assert_array_equal(got, want)


def test_vocab_parallel_ce_of_tq_summed_logits_matches_jax_plain_head(one_torch_thread):
    """The CE over tp of the logits summed over tq (each rank's [V/tp,
    H/tq] head block and the rows' hidden slice) against JAX's plain head
    and cross_entropy (its loss under tq): the loss at rtol 1e-6, the head's
    and the rows' gradients, gathered, at atol 2e-5."""
    rng = np.random.default_rng(2)
    h, v = CFG.text.hidden_size, CFG.text.vocab_size
    kernel = (0.3 * rng.standard_normal((h, v))).astype(np.float32)  # JAX [H, V]
    hidden = rng.standard_normal((2, 12, h)).astype(np.float32)
    labels = rng.integers(0, v, (2, 12)).astype(np.int32)
    labels[0, ::5] = IGNORE_INDEX

    def jloss_fn(k, hd):
        logits = jnp.einsum("bmh,hv->bmv", hd, k, preferred_element_type=jnp.float32)
        return jloss.cross_entropy(logits, jnp.asarray(labels))[0]

    jl, (jgk, jgh) = jax.jit(jax.value_and_grad(jloss_fn, (0, 1)))(
        jnp.asarray(kernel), jnp.asarray(hidden))
    mc = MeshConfig(tp=2, tq=2)

    def rank(comm):
        mesh = make_mesh(mc, comm)
        t, q = mesh.tp_index, mesh.tq_index
        w = torch.as_tensor(kernel.T[t * v // 2:(t + 1) * v // 2, q * h // 2:(q + 1) * h // 2]
                            .copy()).requires_grad_()
        hd = torch.as_tensor(hidden[..., q * h // 2:(q + 1) * h // 2].copy()).requires_grad_()
        loss, _ = tloss.vocab_parallel_ce(w, hd, torch.as_tensor(labels), mesh.tp_comm,
                                          mesh.tq_comm)
        loss.backward()
        gw = mesh.tp_comm.all_gather(mesh.tq_comm.all_gather(w.grad, 1), 0)
        return loss.detach(), gw, mesh.tq_comm.all_gather(hd.grad, -1)

    for loss, gw, gh in run_thread_ranks(rank, mc.size, timeout=TIMEOUT):
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
        np.testing.assert_allclose(gw.numpy(), np.asarray(jgk).T, rtol=0, atol=2e-5)
        np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), rtol=0, atol=2e-5)


def test_forward_logits_match_jax():
    """The whole forward with the plain head (head=True: the partial logits
    of the rank's hidden slice summed over tq in f32, then gathered over
    tp) on a tp 2 x tq 2 shard, text rows and images, against JAX's
    long_vita_forward on one device at the budget rows, atol 2e-5."""
    from long_vita_tpu.models.long_vita import long_vita_forward as jax_forward
    from long_vita_tpu_torch.models.long_vita import long_vita_forward

    jparams = _jax_params(1)
    batch = next(batch_iterator(iter(_packs(tloss.Pack)[:2]), 2, S))
    want = np.asarray(jax_forward(
        jparams, jnp.asarray(batch["tokens"]), jnp.asarray(batch["positions"]), CFG,
        images=jnp.asarray(batch["images"]), image_indices=jnp.asarray(batch["image_indices"]),
        segment_ids=jnp.asarray(batch["segment_ids"]),
        logit_positions=jnp.asarray(batch["logit_positions"]))[0])
    whole = long_vita_params_from_jax(jparams, device="cpu")
    mc = MeshConfig(tp=2, tq=2)

    def rank(comm):
        mesh = make_mesh(mc, comm)
        t = {k: torch.as_tensor(v) for k, v in batch.items() if v is not None}
        with torch.no_grad():
            return long_vita_forward(
                shard_params(whole, mesh, CFG), t["tokens"], t["positions"], CFG,
                images=t["images"], image_indices=t["image_indices"],
                segment_ids=t["segment_ids"], logit_positions=t["logit_positions"],
                parallel=tts.make_parallel_config(mesh))[0]

    for got in run_thread_ranks(rank, mc.size, timeout=TIMEOUT):
        np.testing.assert_allclose(got.numpy()[0], want.reshape(-1, want.shape[-1]), rtol=0,
                                   atol=2e-5)


# ---- the loss's gradients on a mesh ---------------------------------------------------


def _text_batch():
    """JAX's test_tp2d_grads_match_unsharded rows: 2 x 128 tokens of one
    segment, 32 budget rows each, no images."""
    rng = np.random.default_rng(3)
    seq, budget = 128, 32
    tokens = rng.integers(0, CFG.text.vocab_size, size=(2, seq)).astype(np.int32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (2, seq)).copy()
    lp = np.broadcast_to(np.linspace(4, seq - 2, budget).astype(np.int32), (2, budget)).copy()
    return {"tokens": tokens, "positions": pos, "segment_ids": np.zeros((2, seq), np.int32),
            "logit_positions": lp,
            "labels": np.take_along_axis(tokens, lp + 1, axis=1).astype(np.int32),
            "images": None, "image_indices": None}


_UNSHARDED: dict = {}


def _jax_grads(jparams, batch, mc: JMeshConfig, cp_algo="ring", chunk=0, key=None):
    """JAX's loss and gradients on ``mc``'s mesh (None: one device; kept
    under ``key``)."""
    if key in _UNSHARDED:
        return _UNSHARDED[key]
    par = None
    params = jparams
    if mc is not None:
        mesh = _jmesh(mc)
        par = JParallel(mesh, cp_algo=cp_algo)
        params = j_shard_params(jparams, mesh)
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, b: jts.loss_fn(p, b, CFG, par, True, chunk)[0]))(params, _jnp(batch))
    out = float(loss), _named(g)
    if key is not None:
        _UNSHARDED[key] = out
    return out


GRAD_CASES = {
    # JAX's test: its rows on its mesh
    "dp2_tp2_tq2": dict(mesh=MeshConfig(dp=2, tp=2, tq=2), rows="text"),
    "tq2": dict(mesh=MeshConfig(tq=2), rows="text"),
    "cp2_tp2_tq2_ring": dict(mesh=MeshConfig(cp=2, tp=2, tq=2), rows="text"),
    "cp2_tq2_ulysses": dict(mesh=MeshConfig(cp=2, tq=2), rows="text", cp_algo="ulysses"),
    # packed rows with images, the tower trainable
    "tp2_tq2_images": dict(mesh=MeshConfig(tp=2, tq=2), rows="images"),
    # rows of 63 tokens, which do not split over tp: rank 1's slice ends in
    # a pad row (zero in every tq slice through the residual adds)
    "tp2_tq2_images_s63": dict(mesh=MeshConfig(tp=2, tq=2), rows="images", seq=63),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_loss_gradients_match_jax(case, one_torch_thread):
    """The loss and every gradient of one step, summed over the ranks as the
    step sums them and gathered over tp and tq leaf by leaf, against jax.grad
    of JAX's loss_fn on the same mesh (GSPMD's 2-D layout) and on one
    device: loss rtol 1e-6, gradients atol 2e-4."""
    spec = GRAD_CASES[case]
    mc, algo = spec["mesh"], spec.get("cp_algo", "ring")
    jparams = _jax_params(1)
    if spec["rows"] == "text":
        batch = _text_batch()
        if mc.cp > 1 and algo == "ring":
            from long_vita_tpu.parallel.zigzag import inverse_zigzag_permutation, zigzag_permute

            inv = inverse_zigzag_permutation(batch["tokens"].shape[1], mc.cp)
            jbatch = dict(batch)
            for k in ("tokens", "positions", "segment_ids"):
                jbatch[k] = np.asarray(zigzag_permute(batch[k], mc.cp))
            jbatch["logit_positions"] = inv[batch["logit_positions"]]
        else:
            jbatch = batch
        port_batch, chunk = jbatch, 0
    else:
        seq = spec.get("seq", S)
        jbatch = next(jtrainer.batch_iterator(iter(_packs(jdata.Pack, seq)[:2]), 2, seq, mc.cp))
        port_batch = next(batch_iterator(iter(_packs(tloss.Pack, seq)[:2]), 2, seq, mc.cp))
        chunk = 2
    ref_loss, ref = _jax_grads(jparams, batch if spec["rows"] == "text" else jbatch, None,
                               chunk=chunk, key=(spec["rows"], spec.get("seq", S)))
    jl, want = _jax_grads(jparams, jbatch, JMeshConfig(**_dims(mc)), algo, chunk)
    np.testing.assert_allclose(jl, ref_loss, rtol=LOSS_RTOL)
    whole = long_vita_params_from_jax(jparams, device="cpu")

    def rank(comm):
        mesh = make_mesh(mc, comm)
        local = shard_params(whole, mesh, CFG, own=True)
        rows = port_batch["tokens"].shape[0]
        grads, loss, _, _ = tts._backward(
            local, make_global_batch(local_rows(port_batch, mesh, rows), mesh, "cpu"), CFG,
            True, chunk, False, False, mesh=mesh,
            parallel=tts.make_parallel_config(mesh, cp_algo=algo))
        return loss, gather_named(grads, rank_layout(local, CFG, mesh), mesh.tp_comm,
                                  tq_comm=mesh.tq_comm)

    for loss, grads in run_thread_ranks(rank, mc.size, timeout=TIMEOUT):
        np.testing.assert_allclose(loss.item(), jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(loss.item(), ref_loss, rtol=LOSS_RTOL)
        assert set(grads) == set(want)
        if "seq" in spec:  # grad_norm too, at the train step's 1e-5
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
            for w in (want, ref):
                wnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in w.values()))
                np.testing.assert_allclose(norm.item(), wnorm.item(), rtol=1e-5)
        for n, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=0, atol=GRAD_ATOL,
                                       err_msg=n)
            np.testing.assert_allclose(g.numpy(), ref[n].numpy(), rtol=0, atol=GRAD_ATOL,
                                       err_msg=n)


# ---- the Trainer over thread-ranks -----------------------------------------------------


def _train(params, mesh, comm, *, fv, remat=False, accum=False, cfg=CFG, lora_only=False):
    """One rank: a Trainer over ``comm`` on the zigzag stream (the whole tree
    handed in; the Trainer cuts the rank's 2-D shard), -> (losses, grad
    norms, the parameters gathered over tp and tq)."""
    tcfg = TrainerConfig(
        seq_len=S, logit_budget=S, global_batch=2, micro_batch=1 if accum else 0, steps=STEPS,
        mesh=mesh, remat=remat, vision_chunk=2,
        optim=topt.OptimizerConfig(**OPTIM, freeze_vision=fv, lora_only=lora_only))
    tr = Trainer(params, cfg, tcfg, comm=comm)
    norms = []
    attr = "apply_fn" if accum else "step_fn"
    inner = getattr(tr, attr)

    def logged(*a):
        state, m = inner(*a)
        norms.append(float(m["grad_norm"]))
        return state, m

    setattr(tr, attr, logged)
    it = batch_iterator(iter(_packs(tloss.Pack)), 1 if accum else 2, S, mesh.cp)
    losses = tr.train(it)["losses"]
    params = gather_named(dict(tr.state.params.named_parameters()),
                          rank_layout(tr.state.params, cfg, tr.mesh), tr.mesh.tp_comm,
                          tq_comm=tr.mesh.tq_comm)
    return losses, norms, params


TRAIN_CASES = {  # the tower trains in test_loss_gradients_match_jax[tp2_tq2_images]
    "dp2_tp2_tq2": dict(mesh=MeshConfig(dp=2, tp=2, tq=2), fv=True),
    "tp2_tq2_remat_flash_grad_accum": dict(mesh=MeshConfig(tp=2, tq=2), fv=True, remat="flash",
                                           accum=True),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_trainer_over_tq_thread_ranks_matches_jax(case, one_torch_thread):
    kw = dict(TRAIN_CASES[case])
    mesh = kw.pop("mesh")
    whole = long_vita_params_from_jax(_jax_params(0), device="cpu")
    want = _reference(kw["fv"], kw.get("accum", False))
    for got in run_thread_ranks(lambda comm: _train(whole, mesh, comm, **kw), mesh.size,
                                timeout=TIMEOUT):
        _check(got, want)


def test_planted_fault_in_the_norms_tq_sum_fails(monkeypatch, one_torch_thread):
    """The same comparison with the norms' gradients summed over the ranks
    of one tq index only: each rank's covers its hidden slice alone, and
    the gate must see it."""
    monkeypatch.setattr(tts, "_UNSUMMED_OVER_TQ", ("norm",))
    whole = long_vita_params_from_jax(_jax_params(0), device="cpu")
    got = run_thread_ranks(lambda comm: _train(whole, MeshConfig(tq=2), comm, fv=True), 2,
                           timeout=TIMEOUT)
    with pytest.raises(AssertionError):
        _check(got[0], _reference(True))


def test_lora_only_over_dp2_tp2_tq2_matches_jax(one_torch_thread):
    """lora_only over dp 2 x tp 2 x tq 2: the adapters of the rank's tp
    index, replicated over tq, take the rows or columns of its hidden slice;
    the base weights' mask-frozen gradients are summed over their ranks and
    folded into grad_norm. Losses, grad_norm and every parameter after 3
    steps against the JAX lora_only step (the JAX adapters copied in)."""
    from long_vita_tpu.training import optimizer as jopt
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
    mesh = MeshConfig(dp=2, tp=2, tq=2)
    for got in run_thread_ranks(
            lambda comm: _train(params, mesh, comm, fv=True, cfg=cfg, lora_only=True), 8,
            timeout=TIMEOUT):
        _check(got, (_named(state.params), metrics))


# ---- the rejections -------------------------------------------------------------------


def _jax_words(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value).split(": ", 1)[-1]


def test_rejections_raise_with_jax_words():
    """hidden % tq, tq x pp and tq x MoE raise in validate_geometry, tq x
    FSDP too, each with the words of JAX's check; the Trainer and
    shard_params refuse such a mesh before anything is cut."""
    from long_vita_tpu.parallel.mesh import validate_geometry as j_validate
    from long_vita_tpu.parallel.sharding import text_param_specs as j_specs

    text = CFG.text
    moe = dataclasses.replace(text, num_experts=4)
    cases = [
        (text, MeshConfig(tq=3), dict(), lambda: j_validate(text, JMeshConfig(tq=3))),
        (text, MeshConfig(pp=2, tq=2), dict(),
         lambda: j_validate(text, JMeshConfig(pp=2, tq=2))),
        (moe, MeshConfig(tq=2), dict(), lambda: j_validate(moe, JMeshConfig(tq=2))),
        (text, MeshConfig(dp=2, tq=2), dict(fsdp=True),
         lambda: j_specs(fsdp=True, tp2d=True)),
    ]
    for cfg, mc, kw, jfn in cases:
        words = _jax_words(jfn)
        with pytest.raises(ValueError, match=words.replace("(", r"\(").replace(")", r"\)")):
            validate_geometry(cfg, mc, **kw)
    with pytest.raises(ValueError, match="does not compose with MoE/EP"):
        tq2.check_moe_mesh(moe, tq=2)
    whole = long_vita_params_from_jax(_jax_params(0), device="cpu")
    for mc, kw in ((MeshConfig(pp=2, tq=2), {}), (MeshConfig(dp=2, tq=2), dict(fsdp=True))):
        with pytest.raises(ValueError, match="compose"):
            shard_params(whole, make_mesh(mc, ThreadComm.group(4)[0]), CFG, **kw)
        tcfg = TrainerConfig(seq_len=S, logit_budget=S, mesh=mc, fsdp=bool(kw))
        with pytest.raises(ValueError, match="compose"):
            Trainer(whole, CFG, tcfg, comm=ThreadComm.group(4)[0])
