"""PyTorch port: the tensor-parallel layout (parallel/mesh.py's tp axis,
parallel/sharding.py, models/quantize.quantized_param_specs) and the tp
forward of models/qwen2.py, against the JAX package on conftest's 8-device
CPU mesh, at tiny_test_config() in f32.

  - the mesh: every rank's (dp, cp, tp) coordinates and the ranks its tp,
    cp and replica communicators join equal the position of that device in
    JAX make_mesh's device array, for dp 1 x cp 2 x tp 2 and for tp 4;
  - the shards: each rank's tensors of the f32, int8 and int4 trees equal
    the matching ``addressable_shards`` of JAX's shard_params at tp 2 and
    tp 4, transposed to [out, in], bit for bit. At tp 4 the tiny config's 2
    kv heads are fewer than the ranks: GSPMD cuts k_proj and v_proj into
    half-heads, the port gives each rank the whole kv head its q heads read,
    and those two are held to that head of JAX's whole tree;
  - the forward: the tp 2 and tp 4 forward over ThreadComm equals JAX's
    sharded long_vita_forward (as tests/test_quantize.py holds it) for the
    three trees within 2e-5;
  - exact collectives: the vocab-parallel lookup equals the one-device
    embed_tokens bit for bit (ids past the table included), the gathered
    head equals the whole head bit for bit, and every rank's result of each
    all-reduce holds the same bits, over ThreadComm and over two gloo
    processes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.models.long_vita import (
    init_long_vita_params,
    long_vita_forward as jax_forward,
)
from long_vita_tpu.models.quantize import quantize_weights_int4_host, quantize_weights_int8_host
from long_vita_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
from long_vita_tpu.parallel.sharding import shard_params as j_shard_params
from long_vita_tpu_torch.models import qwen2 as tq
from long_vita_tpu_torch.models.long_vita import long_vita_forward
from long_vita_tpu_torch.models.quantize import quantize_weights_int4, quantize_weights_int8
from long_vita_tpu_torch.parallel.comm import ThreadComm, run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.parallel.sharding import long_vita_param_specs, shard_params
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_quantize import one_torch_thread  # noqa: F401

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
RANK_TIMEOUT = 60.0
TREES = ("f32", "int8", "int4")


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config()
    p = init_long_vita_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)

    def fill(path, a):  # random norms and biases, wider kernels
        name, a = jax.tree_util.keystr(path), np.asarray(a)
        if "norm" in name:
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if "bias" in name:
            return (0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a * 4 if name.startswith("['text']") else a

    p = jax.tree_util.tree_map_with_path(fill, p)
    port = long_vita_params_from_jax(p, device="cpu")
    jax_trees = {"f32": p, "int8": quantize_weights_int8_host(p),
                 "int4": quantize_weights_int4_host(p)}
    port_trees = {"f32": port, "int8": quantize_weights_int8(port),
                  "int4": quantize_weights_int4(port)}
    return cfg, jax_trees, port_trees


def _jmesh(cfg: JMeshConfig):
    return j_make_mesh(cfg, devices=jax.devices()[:cfg.size])


# ---- the mesh ----------------------------------------------------------------

@pytest.mark.parametrize("dims", [dict(cp=2, tp=2), dict(tp=4)], ids=["cp2xtp2", "tp4"])
def test_mesh_ranks_follow_jax_device_array(dims):
    jmesh = _jmesh(JMeshConfig(**dims))
    arr = np.vectorize(lambda d: d.id)(jmesh.devices)  # [dp, pp, cp, tp, tq]
    n = arr.size

    def rank(comm):
        mesh = make_mesh(MeshConfig(**dims), comm)
        me = torch.tensor([comm.rank])
        return ((mesh.dp_index, mesh.cp_index, mesh.tp_index),
                mesh.tp_comm.all_gather(me).tolist(), mesh.cp_comm.all_gather(me).tolist(),
                mesh.replica_comm.all_gather(me).tolist())

    for r, (coords, tp_group, cp_group, replica) in enumerate(
            run_thread_ranks(rank, n, timeout=RANK_TIMEOUT)):
        d, c, t = coords
        assert arr[d, 0, c, t, 0] == r
        assert tp_group == arr[d, 0, c, :, 0].tolist()
        assert cp_group == arr[d, 0, :, t, 0].tolist()
        assert replica == arr[d, 0].reshape(-1).tolist()


def test_mesh_raises_for_pp_and_tq(model):
    """The mesh builds with tq (2-D tp; its rank order:
    tests/test_torch_tp2d.py) and with pp (since the pipeline slice:
    tests/test_torch_pipeline.py). The engine serves on a tq mesh since the
    tq serving slice (tests/test_torch_tq_serving.py): it binds the mesh's
    tp and tq communicators and each tq rank's cache keeps num_kv_heads /
    tp heads; it still raises on a pp mesh, as JAX's engine serves no
    pipeline."""
    from long_vita_tpu_torch.inference.engine import InferenceEngine

    cfg, _, port_trees = model

    def rank(comm):
        mesh = make_mesh(MeshConfig(tp=2, tq=2), comm)
        eng = InferenceEngine(port_trees["f32"], cfg, None, mesh=mesh, max_seq_len=128,
                              chunk=64)
        assert mesh.tq_comm.size == 2 and mesh.tq_index == comm.rank % 2
        assert eng.text.tq_comm is mesh.tq_comm and eng.text.tp_comm is mesh.tp_comm
        return eng._make_cache(1, 128).k.shape[3]

    assert run_thread_ranks(rank, 4, timeout=RANK_TIMEOUT) == [
        cfg.text.num_key_value_heads // 2] * 4
    mesh = make_mesh(MeshConfig(pp=2), ThreadComm.group(2)[1])
    assert mesh.shape["pp"] == 2 and mesh.pp_index == 1 and mesh.pp_comm.size == 2
    with pytest.raises(NotImplementedError, match="pipeline stages run in training only"):
        InferenceEngine(port_trees["f32"], cfg, None, mesh=mesh)


# ---- the shards ----------------------------------------------------------------

def _jax_leaf(jtree, name: str):
    """The JAX leaf of a port parameter name of the text tree, as (array,
    layer index or None, transpose to [out, in])."""
    t = jtree["text"]
    parts = name.split(".")
    if parts[0] == "embed":
        return t["embed"]["embedding"], None, False
    if parts[0] == "final_norm":
        return t["final_norm"], None, False
    layer = None
    if parts[0] == "layers":
        layer, parts = int(parts[1]), parts[2:]
        t = t["layers"]
    if parts[0] in ("input_norm", "post_attn_norm"):
        return t[parts[0]], layer, False
    entry = t[parts[0]]
    leaf = {"weight": "kernel", "weight_q": "kernel_q", "scale": "scale",
            "packed": "kernel_p4", "scales": "scale4", "bias": "bias"}[parts[1]]
    return entry[leaf], layer, parts[1] in ("weight", "weight_q")


def _shard_of(arr, device) -> np.ndarray:
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == device)


def _as_port(a: np.ndarray, layer, transpose: bool) -> np.ndarray:
    if layer is not None:
        a = a[layer]
    return a.T if transpose else a


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("tp", [2, 4])
def test_shards_equal_jax_shard_params(model, tree, tp):
    cfg, jax_trees, port_trees = model
    jmesh = _jmesh(JMeshConfig(tp=tp))
    jsharded = j_shard_params(jax.tree.map(jnp.asarray, jax_trees[tree]), jmesh)
    devices = jmesh.devices.reshape(-1)
    hkv, d = cfg.text.num_key_value_heads, cfg.text.head_dim
    comms = ThreadComm.group(tp)  # a mesh over them needs no collective
    checked = 0
    for r in range(tp):
        local = shard_params(port_trees[tree], make_mesh(MeshConfig(tp=tp), comms[r]), cfg)
        assert local.text.tp_comm is comms[r] and port_trees[tree].text.tp_comm is None
        # the tower and projector are replicated: the same tensors
        assert [p.data_ptr() for p in local.vision.parameters()] == [
            p.data_ptr() for p in port_trees[tree].vision.parameters()]
        for name, got in local.text.named_parameters():
            arr, layer, transpose = _jax_leaf(jsharded, name)
            got = got.detach().numpy()
            if tp > hkv and (".k_proj." in name or ".v_proj." in name):
                # the whole kv head of this rank's q heads (GSPMD: half-heads)
                whole = _as_port(np.asarray(arr), layer, transpose)
                head = r // (tp // hkv)
                if name.endswith((".packed", ".scales")):  # int4: [rows, out]
                    want = whole[:, head * d:(head + 1) * d]
                else:
                    want = whole[head * d:(head + 1) * d]
            else:
                want = _as_port(_shard_of(arr, devices[r]), layer, transpose)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r} {name}")
            checked += 1
    assert checked == tp * len(list(port_trees[tree].text.parameters()))


def test_specs_name_every_tensor(model):
    """Every parameter of each tree has a spec; the int4 row-parallel
    projections are replicated, the int8 ones split their input dim."""
    _, _, port_trees = model
    for tree in TREES:
        specs = long_vita_param_specs(port_trees[tree])
        assert set(specs) == {n for n, _ in port_trees[tree].named_parameters()}
    int4 = long_vita_param_specs(port_trees["int4"])
    assert int4["text.layers.0.o_proj.packed"] is None
    assert int4["text.layers.0.q_proj.packed"] == 1 and int4["text.lm_head.scales"] == 1
    int8 = long_vita_param_specs(port_trees["int8"])
    assert int8["text.layers.0.down_proj.weight_q"] == 1
    assert int8["text.layers.0.down_proj.scale"] is None and int8["text.layers.0.up_proj.scale"] == 0


# ---- the forward -----------------------------------------------------------

def _ids(seed):
    ids = np.random.default_rng(seed).integers(0, 500, size=(1, 32))
    return ids, np.arange(32)[None]


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("tp", [2, 4])
def test_forward_matches_jax_sharded_forward(model, tree, tp, one_torch_thread):
    cfg, jax_trees, port_trees = model
    ids, pos = _ids(3)
    jmesh = _jmesh(JMeshConfig(tp=tp))
    sharded = j_shard_params(jax.tree.map(jnp.asarray, jax_trees[tree]), jmesh)
    want, _ = jax.jit(lambda p, i, po: jax_forward(p, i, po, cfg, attn_impl="xla"))(
        sharded, jnp.asarray(ids, jnp.int32), jnp.asarray(pos, jnp.int32))
    want = np.asarray(want)

    def rank(comm):
        local = shard_params(port_trees[tree], make_mesh(MeshConfig(tp=tp), comm), cfg)
        got, _ = long_vita_forward(local, torch.as_tensor(ids), torch.as_tensor(pos), cfg)
        return got

    outs = run_thread_ranks(rank, tp, timeout=RANK_TIMEOUT)
    for got in outs:
        assert torch.equal(got, outs[0])  # the gathered logits: the same bits on every rank
        np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


# ---- exact collectives -------------------------------------------------------

IDS_PAST = torch.tensor([[0, 1, 255, 256, 511, 512, 600, 10_000]])  # 512 ids in the table


@pytest.mark.parametrize("tp", [2, 4])
def test_vocab_parallel_lookup_and_gathered_head_are_exact(model, tp):
    cfg, _, port_trees = model
    whole = port_trees["f32"].text
    hidden = torch.randn((2, 5, cfg.text.hidden_size), generator=torch.Generator().manual_seed(1))

    def rank(comm):
        local = shard_params(port_trees["f32"], make_mesh(MeshConfig(tp=tp), comm), cfg).text
        return tq.embed_tokens(local, IDS_PAST), tq.lm_head(local, hidden)

    for rows, logits in run_thread_ranks(rank, tp, timeout=RANK_TIMEOUT):
        assert torch.equal(rows, tq.embed_tokens(whole, IDS_PAST))
        assert torch.equal(logits, tq.lm_head(whole, hidden))


class _Recording:
    """A communicator that records each all_reduce_sum's result."""

    def __init__(self, comm):
        self.comm, self.sums = comm, []
        self.rank, self.size = comm.rank, comm.size

    def all_reduce_sum(self, x):
        out = self.comm.all_reduce_sum(x)
        self.sums.append(out.clone())
        return out

    def all_gather(self, x, dim=0):
        return self.comm.all_gather(x, dim)


def _recorded_sums(cfg, params, comm, tp):
    """Every all-reduce result of one tp forward (embedding, o_proj and
    down_proj of each layer) on this rank, as numpy arrays."""
    local = shard_params(params, make_mesh(MeshConfig(tp=tp), comm), cfg)
    rec = _Recording(local.text.tp_comm)
    local.text.tp_comm = rec
    ids, pos = _ids(5)
    long_vita_forward(local, torch.as_tensor(ids), torch.as_tensor(pos), cfg)
    return [s.numpy() for s in rec.sums]


def test_every_rank_holds_the_same_bits_after_each_all_reduce(model):
    cfg, _, port_trees = model
    res = run_thread_ranks(lambda c: _recorded_sums(cfg, port_trees["f32"], c, 4), 4,
                           timeout=RANK_TIMEOUT)
    assert len(res[0]) == 1 + 2 * cfg.text.num_hidden_layers
    for sums in res[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(sums, res[0]))


def _gloo_sums_worker(rank, world, init, out):
    torch.set_num_threads(1)
    try:
        from long_vita_tpu_torch.config import tiny_test_config as port_tiny
        from long_vita_tpu_torch.models.long_vita import init_long_vita_params as port_init
        from long_vita_tpu_torch.parallel.comm import init_process_group

        comm = init_process_group(rank, world, init, backend="gloo", timeout=60.0)
        cfg = port_tiny()
        params = port_init(torch.Generator().manual_seed(0), cfg)
        out.put((rank, _recorded_sums(cfg, params, comm, world)))
        torch.distributed.destroy_process_group()
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        out.put((rank, f"raised {type(e).__name__}: {e}"))


def test_every_gloo_rank_holds_the_same_bits_after_each_all_reduce():
    from test_torch_comm import run_gloo

    got = run_gloo(_gloo_sums_worker, 2)
    assert all(isinstance(got.get(r), list) for r in (0, 1)), got
    assert len(got[0]) == 1 + 2 * tiny_test_config().text.num_hidden_layers
    assert all(np.array_equal(a, b) for a, b in zip(got[0], got[1]))
