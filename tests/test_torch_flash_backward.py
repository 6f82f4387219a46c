"""PyTorch port: the flash backward (K4 one pass, K5 two passes) and the
differentiable flash_attention / short_attention, against the JAX package.

On the CPU the port's autograd Functions run the plain forward and the plain
backward (flash_attention_bwd_reference); JAX differentiates its Pallas
kernels in interpret mode, as tests/test_flash_attention.py runs them: the
one-pass `_bwd_fused_kernel` (K4) by default and, with
``long_vita_tpu.ops.flash_attention._FUSED_BWD`` set to False, the two-pass
`_bwd_dkv_kernel` / `_bwd_dq_kernel` (K5). Inputs come from a numpy seed;
the loss is sum(o * w) for a seeded w.

Tolerances: f32, 5e-6 absolute + 5e-6 relative (same algorithm, sums in
another order; the gradients are O(1) and agree to 1e-6); bf16, 1e-2
absolute + 1e-2 relative (both round p and dS to bf16 before the products
and the gradients to bf16 at the end, where a one-ulp difference in the f32
logits can flip a rounding; measured within 3e-3, two bf16 roundings are
2^-7).

The CUDA kernels themselves are held against the plain backward on a GPU by
tests/test_torch_flash_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_vita_tpu.ops import flash_attention as jfa
from long_vita_tpu_torch.ops import flash_attention as tfa

TOL = {"float32": dict(rtol=5e-6, atol=5e-6), "bfloat16": dict(rtol=1e-2, atol=1e-2)}


def _inputs(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, hq, d))
    ]


def _segments(b, s, cuts):
    seg = np.zeros((b, s), np.int32)
    for i, row in enumerate(cuts):
        for c in row:
            seg[i, c:] += 1
    return seg


def _jax_grads(q, k, v, w, dtype, **kw):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]

    def f(q, k, v):
        o = jfa.flash_attention(q, k, v, **kw)
        return jnp.sum(o.astype(jnp.float32) * w)

    args = [jnp.asarray(x, jdt) for x in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32)) for g in jax.grad(f, argnums=(0, 1, 2))(*args)]


def _torch_grads(q, k, v, w, dtype, **kw):
    tdt = getattr(torch, dtype)
    args = [torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v)]
    kw = {n: (torch.as_tensor(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    before = (tfa.flash_bwd_fused.launches, tfa.flash_bwd_dkv.launches, tfa.flash_bwd_dq.launches)
    o = tfa.flash_attention(*args, **kw)
    (o.float() * torch.as_tensor(w)).sum().backward()
    # CPU tensors take the plain versions: no kernel launch
    assert (tfa.flash_bwd_fused.launches, tfa.flash_bwd_dkv.launches,
            tfa.flash_bwd_dq.launches) == before
    return [a.grad.float().numpy() for a in args]


CASES = {
    # causal GQA over packed segments (the training decoder's shape, small)
    "causal_gqa_segments": dict(
        shape=(2, 160, 160, 4, 2, 128),
        kw=lambda: dict(causal=True, q_segment_ids=_segments(2, 160, [[50, 100], [70]]),
                        kv_segment_ids=_segments(2, 160, [[50, 100], [70]])),
    ),
    # a chunk at q offset 100 against 200 kv slots of which 150 are valid
    "offsets_kv_valid_len": dict(
        shape=(1, 96, 200, 4, 2, 64),
        kw=lambda: dict(causal=True, q_offset=100, kv_offset=0, kv_valid_len=150),
    ),
    # non-causal, D 64, ragged length (the ViT's attention, small)
    "noncausal_d64_ragged": dict(
        shape=(3, 65, 65, 2, 2, 64), kw=lambda: dict(causal=False),
    ),
}


@pytest.mark.parametrize("fused", [True, False], ids=["K4_fused", "K5_two_pass"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_backward_matches_jax(monkeypatch, case, dtype, fused):
    monkeypatch.setattr(jfa, "_FUSED_BWD", fused)
    b, sq, skv, hq, hkv, d = CASES[case]["shape"]
    kw = CASES[case]["kw"]()
    q, k, v, w = _inputs(sum(map(ord, case)), b, sq, skv, hq, hkv, d)
    want = _jax_grads(q, k, v, w, dtype, **kw)
    got = _torch_grads(q, k, v, w, dtype, **kw)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, err_msg=name, **TOL[dtype])


@pytest.mark.parametrize("fused", [True, False], ids=["K4_fused", "K5_two_pass"])
@pytest.mark.parametrize("b,s,hq,hkv", [(2, 65, 4, 2), (1, 130, 2, 2)], ids=["gqa_65", "mha_130"])
def test_short_attention_grad_matches_jax(monkeypatch, fused, b, s, hq, hkv):
    """short_attention's backward: K3's own (o, lse) fed to the flash
    backward with causal off (the JAX _short_attention_bwd), f32."""
    monkeypatch.setattr(jfa, "_FUSED_BWD", fused)
    q, k, v, w = _inputs(5 + s, b, s, s, hq, hkv, 64)

    def f(q, k, v):
        return jnp.sum(jfa.short_attention(q, k, v) * w)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    args = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
    (tfa.short_attention(*args) * torch.as_tensor(w)).sum().backward()
    for name, a, r in zip(("dq", "dk", "dv"), args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), err_msg=name, **TOL["float32"])


def test_backward_reference_is_the_gradient_of_the_forward():
    """The plain backward equals autograd through the plain forward, on a
    case with every mask at once (segments, offsets, kv_valid_len, GQA)."""
    q, k, v, w = (torch.tensor(x) for x in _inputs(3, 2, 48, 80, 4, 2, 64))
    seg = torch.as_tensor(_segments(2, 80, [[30], [10, 60]]))
    kw = dict(causal=True, q_offset=32, kv_offset=0, kv_valid_len=70,
              q_segment_ids=seg[:, 32:], kv_segment_ids=seg)
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    o, lse = tfa.flash_attention_reference(qa, ka, va, **kw)
    (o * w).sum().backward()
    got = tfa.flash_attention_bwd_reference(q, k, v, o.detach(), lse.detach(), w, **kw)
    for name, g, a in zip(("dq", "dk", "dv"), got, (qa, ka, va)):
        torch.testing.assert_close(g, a.grad, rtol=1e-5, atol=1e-5, msg=name)
    assert bool((got[1][:, 70:] == 0).all()) and bool((got[2][:, 70:] == 0).all())


def _jax_backward_kernels(b, s, hq, hkv, d, *, causal, segments, short):
    """Pallas calls in JAX's traced gradient of flash_attention (or
    short_attention) at a shape: the forward plus one for the one-pass
    backward, plus two for the two-pass one. Traced only, never run."""
    sds = jax.ShapeDtypeStruct

    def f(q, k, v, seg):
        if short:
            o = jfa.short_attention(q, k, v)
        else:
            sg = seg if segments else None
            o = jfa.flash_attention(q, k, v, causal=causal, q_segment_ids=sg, kv_segment_ids=sg)
        return jnp.sum(o.astype(jnp.float32))

    jaxpr = jax.make_jaxpr(jax.grad(f, argnums=(0, 1, 2)))(
        sds((b, s, hq, d), jnp.bfloat16), sds((b, s, hkv, d), jnp.bfloat16),
        sds((b, s, hkv, d), jnp.bfloat16), sds((b, s), jnp.int32),
    )
    n = str(jaxpr).count("pallas_call[")
    assert n in (2, 3), n
    return n == 2


@pytest.mark.parametrize(
    "b,s,hq,hkv,d,causal,segments,short,fused",
    [
        (1, 16384, 40, 8, 128, True, True, False, True),    # T2's decoder: K4
        (1, 32768, 40, 8, 128, True, True, False, False),   # T1's decoder: K5
        (1, 4096, 40, 8, 128, True, True, False, True),     # chip_smoke's kernel case
        (64, 1025, 16, 16, 64, False, False, False, True),  # T2's trainable ViT: K4
        (300, 1025, 16, 16, 64, False, False, False, True),
        (64, 1025, 16, 16, 64, False, False, True, True),   # short_attention's backward
        (300, 1025, 16, 16, 64, False, False, True, False),
    ],
    ids=["dec16k", "dec32k", "dec4k", "vit64", "vit300", "short64", "short300"],
)
def test_backward_kernel_choice_matches_jax(b, s, hq, hkv, d, causal, segments, short, fused):
    """bwd_uses_fused picks the kernel JAX picks on the shapes chip_smoke.py
    drives (16K -> K4, 32K -> K5, the ViT -> K4)."""
    assert tfa.bwd_uses_fused(b, s, s, hq, d, 2, short=short) is fused
    assert _jax_backward_kernels(b, s, hq, hkv, d, causal=causal, segments=segments,
                                 short=short) is fused


def test_lse_is_not_differentiable():
    q, k, v, _ = (torch.tensor(x) for x in _inputs(1, 1, 32, 32, 2, 1, 64))
    q.requires_grad_()
    o, lse = tfa.flash_attention(q, k, v, return_lse=True)
    assert o.requires_grad and not lse.requires_grad
    o, lse = tfa.short_attention(q, k, v, return_lse=True)
    assert o.requires_grad and not lse.requires_grad
