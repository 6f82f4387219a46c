"""PyTorch port: the tile plan of the Hopper flash backward (K4 and K5's bf16
bodies, long_vita_tpu_torch/ops/csrc/flash_bwd_sm90.cuh) against the dense
mask, and the operands the wrapper prepares for it, on the CPU.

The kernels skip (q tile, kv tile) pairs by the causal frontier,
kv_valid_len and the (min, max) segment id of each tile, and drop the mask
on "interior" pairs. ``bwd_dkv_plan`` and ``bwd_dq_plan`` spell that rule out
in Python with the kernels' tile sizes; here hypothesis draws segment layouts
(packed and interleaved ids), q/kv offsets, kv_valid_len, ragged Sq/Skv and
GQA groups, builds the tiles' id ranges through the wrapper
(``bwd_operands``), and holds the plans to the plain mask: every pair that
holds an unmasked (i, j) is visited, and an interior pair holds no masked
element. Exact: integer masks, no tolerance. Last, chip_smoke.py's plain
backward of a packed row, a segment at a time, against the whole row's.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from long_vita_tpu_torch.ops import flash_attention as tfa

ROOT = Path(__file__).resolve().parents[1]
TQ, BQ, BKV, WG = tfa.SM90_BWD_TILE_Q, tfa.SM90_BWD_BLOCK_Q, tfa.SM90_BWD_BLOCK_KV, 64


def _ids(draw, n, kind):
    if kind == "packed":  # monotone: samples packed one after another
        cuts = draw(st.lists(st.integers(1, max(1, n - 1)), max_size=5))
        ids = np.zeros(n, np.int32)
        for c in cuts:
            ids[c:] += 1
        return ids
    width = draw(st.integers(1, 90))  # interleaved: ids repeat, not sorted
    period = draw(st.integers(2, 4))
    shift = draw(st.integers(0, 3))
    return ((np.arange(n) // width + shift) % period).astype(np.int32)


@st.composite
def layouts(draw):
    sq, skv = draw(st.integers(1, 520)), draw(st.integers(1, 520))
    kind = draw(st.sampled_from(["none", "packed", "interleaved"]))
    return dict(
        sq=sq, skv=skv, kv_len=draw(st.integers(0, skv)), causal=draw(st.booleans()),
        q_off=draw(st.integers(0, 600)), k_off=draw(st.integers(0, 600)),
        group=draw(st.sampled_from([1, 5, 8])),
        qseg=None if kind == "none" else _ids(draw, sq, kind),
        kseg=None if kind == "none" else _ids(draw, skv, kind),
    )


def _dense_mask(lay):
    i = np.arange(lay["sq"])[:, None]
    j = np.arange(lay["skv"])[None, :]
    m = j < lay["kv_len"]
    if lay["causal"]:
        m = m & (lay["k_off"] + j <= lay["q_off"] + i)
    if lay["qseg"] is not None:
        m = m & (lay["qseg"][:, None] == lay["kseg"][None, :])
    return np.broadcast_to(m, (lay["sq"], lay["skv"]))


def _tile_any(m, rows, cols):
    """[Sq, Skv] -> [ceil(Sq / rows), ceil(Skv / cols)]: does the tile hold a True."""
    r, c = -(-m.shape[0] // rows) * rows, -(-m.shape[1] // cols) * cols
    pad = np.zeros((r, c), bool)
    pad[:m.shape[0], :m.shape[1]] = m
    return pad.reshape(r // rows, rows, c // cols, cols).any(axis=(1, 3))


def _ranges(lay, with_order=False):
    """The tiles' (min, max) ids as the wrapper prepares them for the kernels
    (bwd_operands on CPU tensors at a GQA group of lay["group"]), and with
    with_order the kv-major grid's tile order."""
    if lay["qseg"] is None:
        return (None, None) if with_order else None
    b, hkv, d = 1, 2, 64
    q = torch.zeros((b, lay["sq"], hkv * lay["group"], d), dtype=torch.bfloat16)
    k = torch.zeros((b, lay["skv"], hkv, d), dtype=torch.bfloat16)
    lse = torch.zeros((b, q.shape[2], lay["sq"]))
    a = tfa.bwd_operands(q, k, k, q, lse, q, lay["causal"], lay["q_off"], lay["k_off"],
                         lay["kv_len"], torch.from_numpy(lay["qseg"])[None],
                         torch.from_numpy(lay["kseg"])[None], True)
    ranges = [tuple(r) for r in a["seg_ranges"][0].tolist()]
    if not with_order:
        return ranges
    return ranges, None if a["tile_order"] is None else a["tile_order"][0].tolist()


def _plan_kw(lay):
    return dict(sq=lay["sq"], kv_len=lay["kv_len"], causal=lay["causal"],
                q_offset=lay["q_off"], kv_offset=lay["k_off"])


@settings(max_examples=120, deadline=None, derandomize=True)
@given(layouts())
def test_dkv_plan_visits_every_unmasked_pair_and_only_unmasked_interiors(lay):
    """The kv-major blocks (K5's dkv pass, K4): kv tiles of 128 rows walk q
    tiles of 64."""
    m = _dense_mask(lay)
    need = _tile_any(m, TQ, BKV)
    ranges, order = _ranges(lay, with_order=True)
    n_qt, n_qb, n_kt = -(-lay["sq"] // TQ), -(-lay["sq"] // BQ), -(-lay["skv"] // BKV)
    work = []
    for kt in range(n_kt):
        seg = {} if ranges is None else dict(
            q_ranges=ranges[:n_qt], kv_range=ranges[n_qt + n_qb + kt])
        plan = tfa.bwd_dkv_plan(kt, **_plan_kw(lay), **seg)
        visited = [qt for qt, _ in plan]
        work.append(len(visited))
        assert visited == sorted(set(visited))
        assert set(np.flatnonzero(need[:, kt])) <= set(visited), (kt, visited)
        for qt, interior in plan:
            for w, inner in enumerate(interior):
                if inner:
                    j0 = kt * BKV + w * WG
                    assert j0 + WG <= lay["kv_len"]
                    assert m[qt * TQ:(qt + 1) * TQ, j0:j0 + WG].all(), (kt, qt, w)
    # with segments under a causal mask the grid takes the kv tiles heaviest
    # first: a permutation by the blocks' q-tile counts
    assert (order is not None) == (ranges is not None and lay["causal"])
    if order is not None:
        assert sorted(order) == list(range(n_kt))
        assert [work[kt] for kt in order] == sorted(work, reverse=True)


@settings(max_examples=120, deadline=None, derandomize=True)
@given(layouts())
def test_dq_plan_visits_every_unmasked_pair_and_only_unmasked_interiors(lay):
    """The q-major blocks of K5's dq pass: q blocks of 128 rows (two
    warpgroups of 64) walk kv tiles of 128."""
    m = _dense_mask(lay)
    need = _tile_any(m, BQ, BKV)
    ranges = _ranges(lay)
    n_qt, n_qb = -(-lay["sq"] // TQ), -(-lay["sq"] // BQ)
    for qb in range(n_qb):
        seg = {} if ranges is None else dict(
            q_range=ranges[n_qt + qb], kv_ranges=ranges[n_qt + n_qb:])
        plan = tfa.bwd_dq_plan(qb, **_plan_kw(lay), **seg)
        visited = [j for j, _ in plan]
        assert visited == sorted(set(visited))
        assert set(np.flatnonzero(need[qb])) <= set(visited), (qb, visited)
        for j, interior in plan:
            assert j * BKV < lay["kv_len"]
            for w, inner in enumerate(interior):
                if inner:
                    r0 = qb * BQ + w * WG
                    assert (j + 1) * BKV <= lay["kv_len"]
                    assert m[r0:r0 + WG, j * BKV:(j + 1) * BKV].all(), (qb, j, w)


@pytest.mark.parametrize("causal", [True, False])
def test_plans_without_segments_follow_the_causal_frontier(causal):
    """A 1000-row self-attention without segments: the kv tile at 512 is
    first seen by q tile 8, the q block 0 needs only kv tile 0, and nothing
    past kv_len (700) is visited."""
    kw = dict(sq=1000, kv_len=700, causal=causal)
    dkv = tfa.bwd_dkv_plan(4, **kw)
    assert [qt for qt, _ in dkv] == list(range(8 if causal else 0, 16))
    assert tfa.bwd_dkv_plan(6, **kw) == []  # rows 768.. lie past kv_len
    dq = tfa.bwd_dq_plan(0, **kw)
    assert [j for j, _ in dq] == ([0] if causal else list(range(6)))
    # a q block far down sees every kv tile up to kv_len; the last is partial
    assert [j for j, _ in tfa.bwd_dq_plan(7, **kw)] == list(range(6))
    assert tfa.bwd_dq_plan(7, **kw)[-1][1] == (False, False)


def test_bwd_operands_prepare_the_tensor_map_inputs():
    """Segment ranges [B, n_qt + n_qb + n_kt, 2] at the backward's tiles,
    kv ids padded to rows of a multiple of 4 (zeros past Skv, the ids kept),
    and the launch arguments carrying the padded row stride."""
    b, sq, skv, hkv, g, d = 2, 300, 333, 2, 5, 128
    q = torch.randn(b, sq, hkv * g, d).to(torch.bfloat16)
    k = torch.randn(b, skv, hkv, d).to(torch.bfloat16)
    lse = torch.zeros(b, hkv * g, sq)
    qseg = torch.arange(sq).div(100, rounding_mode="floor").expand(b, sq).to(torch.int64)
    kseg = torch.arange(skv).div(111, rounding_mode="floor").expand(b, skv).to(torch.int64)
    a = tfa.bwd_operands(q, k, k, q, lse, q, True, 0, 0, skv, qseg, kseg, False)
    n_qt, n_qb, n_kt = -(-sq // 64), -(-sq // 128), -(-skv // 128)
    assert a["seg_ranges"].shape == (b, n_qt + n_qb + n_kt, 2)
    assert a["seg_ranges"].dtype == torch.int32 and a["seg_ranges"].is_contiguous()
    r = a["seg_ranges"][0].tolist()
    assert r[0] == [0, 0] and r[1] == [0, 1] and r[n_qt - 1] == [2, 2]   # q tiles of 64
    assert r[n_qt] == [0, 1] and r[n_qt + n_qb - 1] == [2, 2]           # q blocks of 128
    assert r[n_qt + n_qb] == [0, 1] and r[-1] == [2, 2]                 # kv tiles of 128
    assert a["kseg"].shape == (b, 336) and a["kseg"].dtype == torch.int32
    assert torch.equal(a["kseg"][:, :skv], kseg.int()) and bool((a["kseg"][:, skv:] == 0).all())
    assert a["qseg"].dtype == torch.int32 and a["qseg"].is_contiguous()
    args = tfa.bwd_launch_args(a)
    assert len(args) == len(tfa._BWD_ARGS) and args[22:24] == (sq, 336)
    assert a["dq"].dtype == torch.bfloat16
    a4 = tfa.bwd_operands(q, k, k, q, lse, q, True, 0, 0, skv, None, None, True)
    assert a4["seg_ranges"] is None and a4["tile_order"] is None
    assert a4["dq"].dtype == torch.float32
    assert bool((a4["dq"] == 0).all())


@pytest.mark.parametrize("group", [1, 5])
def test_chip_smoke_plain_backward_by_segment_is_the_whole_rows(group):
    """chip_smoke.py holds K4 and K5 on the training rows to the plain
    backward computed a segment and a GQA group at a time (the whole row's
    logits do not fit on the card): on a small packed causal row that equals
    the plain backward of the whole row."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    gen = torch.Generator().manual_seed(3)
    s, hkv, d = 200, 2, 64
    q, do = (torch.randn(1, s, hkv * group, d, generator=gen) for _ in range(2))
    k, v = (torch.randn(1, s, hkv, d, generator=gen) for _ in range(2))
    seg = torch.tensor([0] * 37 + [1] * 90 + [2] * 1 + [3] * 72, dtype=torch.int32)[None]
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    o, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    want = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    got = cs._plain_bwd_by_segment(q, k, v, o, lse, do, seg)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        cs._plain_bwd_by_segment(q, k, v, o, lse, do, seg.flip(1).remainder(2))


def test_bwd_operands_reject_what_the_tensor_maps_and_grids_do_not_take():
    """At most 65535 batch rows and kv tiles of 128 rows a launch (the
    grid's y and z), checked before anything is allocated."""
    x = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16)
    q = x.expand(65536, 64, 1, 64)
    lse = torch.zeros(1, 1, 1).expand(65536, 1, 64)
    with pytest.raises(ValueError, match="batch rows"):
        tfa.bwd_operands(q, q, q, q, lse, q, True, 0, 0, 64, None, None, True)
    k = x.expand(1, 65536 * 128 + 1, 1, 64)
    q1 = x.expand(1, 64, 1, 64)
    with pytest.raises(ValueError, match="tiles"):
        tfa.bwd_operands(q1, k, k, q1, torch.zeros(1, 1, 64), q1, False, 0, 0, k.shape[1],
                         None, None, True)
