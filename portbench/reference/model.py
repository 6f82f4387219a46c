"""Long-VITA's forward pass in plain PyTorch float32: InternViT-300M, the
pixel-shuffle projector and the Qwen2.5 decoder, from their published
descriptions, with no kernel, cache or batching of the port.

- InternViT (InternVL's modeling_intern_vit.py): 14 x 14 patches embedded by
  one matrix over each patch's (row, column, channel) values, a CLS token,
  learned positions at the native 32 x 32 grid; pre-norm layers (LayerNorm,
  eps 1e-6) of full attention over the 1025 tokens with a qkv bias, exact
  GELU MLP, and layer scales on both branches.
- The projector (InternVL's mlp1 at Long-VITA's widths): the CLS dropped, a
  pixel shuffle at 0.5 (InternVL's reshape and transpose order), LayerNorm
  (eps 1e-5), a matrix to the tower's width, exact GELU, a matrix to the
  decoder's width, no biases.
- The Qwen2.5 decoder (HF Qwen2): RMSNorm (eps 1e-6), q/k/v with biases,
  rotary embeddings in the rotate-half layout with base 1e6 on positions
  that restart in every packed segment, grouped-query causal attention
  inside each segment, a SwiGLU MLP, a final RMSNorm and an untied head.

Matrix products run in float32 with TF32 off. Weights arrive as the
benchmark made them (bfloat16, ``portbench.weights``) and are widened here.
``lower`` rounds every matrix to fp8 (e4m3, a scale per output row) before
widening it: the control that computes in the precision below the
configuration's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_rows(w: torch.Tensor) -> torch.Tensor:
    """w rounded to float8 e4m3 with one scale per output row, widened."""
    w = w.float()
    scale = w.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


class Widen:
    """float32 views of the benchmark's weights; with ``lower`` every matrix
    (2-D weight) other than a lookup table passes through fp8 first."""

    LOOKUPS = ("text.embed", "vision.embeddings.pos_embed", "vision.embeddings.cls_token")

    def __init__(self, weights, lower: bool = False):
        self.w, self.lower = weights, lower

    def __call__(self, name: str, layer: int = -1) -> torch.Tensor:
        t = self.w(name, layer)
        if self.lower and t.dim() == 2 and name not in self.LOOKUPS:
            return fp8_rows(t)
        return t.float()


def pixels(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [N, H, W, 3] at the tower's size -> normalised float32 tiles
    (a 448 x 448 image needs no resize or padding)."""
    mean = torch.tensor(IMAGENET_MEAN, device=frames_u8.device)
    std = torch.tensor(IMAGENET_STD, device=frames_u8.device)
    return (frames_u8.float() / 255.0 - mean) / std


def layer_norm(x, scale, bias, eps):
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


def vit(w: Widen, tiles: torch.Tensor, n: dict) -> torch.Tensor:
    """[N, H, W, 3] float32 -> patch features [N, grid^2, vh] (CLS dropped)."""
    b, hh, ww, c = tiles.shape
    p, vh, heads, vd = n["patch"], n["vh"], n["vheads"], n["vd"]
    x = tiles.reshape(b, hh // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, -1, p * p * c)
    x = x @ w("vision.embeddings.patch_embed.weight").T + w("vision.embeddings.patch_embed.bias")
    cls = w("vision.embeddings.cls_token").expand(b, 1, vh)
    x = torch.cat([cls, x], 1) + w("vision.embeddings.pos_embed")[None]
    for i in range(n["vl"]):
        def g(name):
            return w(f"vision.layers.*.{name}", i)

        y = layer_norm(x, g("norm1.scale"), g("norm1.bias"), 1e-6)
        qkv = (y @ g("qkv.weight").T + g("qkv.bias")).reshape(b, -1, 3, heads, vd)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))  # [b, heads, s, vd]
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(vd), dim=-1) @ v
        att = att.transpose(1, 2).reshape(b, -1, vh)
        x = x + (att @ g("proj.weight").T + g("proj.bias")) * g("ls1")
        y = layer_norm(x, g("norm2.scale"), g("norm2.bias"), 1e-6)
        y = F.gelu(y @ g("fc1.weight").T + g("fc1.bias")) @ g("fc2.weight").T + g("fc2.bias")
        x = x + y * g("ls2")
    return x[:, 1:]


def pixel_shuffle(x: torch.Tensor, scale: float = 0.5) -> torch.Tensor:
    """InternVL's pixel_shuffle: [N, W, H, C] -> [N, W*s, H*s, C/s^2]."""
    n, w, h, c = x.shape
    x = x.reshape(n, w, int(h * scale), int(c / scale)).permute(0, 2, 1, 3)
    x = x.reshape(n, int(h * scale), int(w * scale), int(c / (scale * scale)))
    return x.permute(0, 2, 1, 3)


def projector(pw: dict, feats: torch.Tensor, n: dict) -> torch.Tensor:
    """Patch features [N, grid^2, vh] -> [N, tokens, h]. ``pw``: the four
    projector tensors in float32 (a trained side passes leaves that take
    gradients)."""
    b, s, c = feats.shape
    g = int(round(math.sqrt(s)))
    x = pixel_shuffle(feats.reshape(b, g, g, c), 1 / math.sqrt(n["shuffle"]))
    x = x.reshape(b, -1, x.shape[-1])
    x = layer_norm(x, pw["pre_norm.scale"], pw["pre_norm.bias"], 1e-5)
    return F.gelu(x @ pw["fc1.weight"].T) @ pw["fc2.weight"].T


def projector_weights(w: Widen) -> dict:
    return {k: w(f"projector.{k}") for k in ("pre_norm.scale", "pre_norm.bias", "fc1.weight",
                                              "fc2.weight")}


def rms_norm(x, weight, eps=1e-6):
    return weight * (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps))


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, d], pos [S] -> rotated (rotate-half layout)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float64) / d))
    ang = pos.double()[:, None] * inv[None]
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def causal_attention(q, k, v, block: int = 1024) -> torch.Tensor:
    """q [S, hq, d], k/v [S, hkv, d] of one sequence -> [S, hq, d]; causal,
    in blocks of query rows (each against the keys up to its last row)."""
    s, hq, d = q.shape
    hkv = k.shape[1]
    rep = hq // hkv
    out = torch.empty_like(q)
    kk, vv = k.permute(1, 0, 2), v.permute(1, 0, 2)  # [hkv, S, d]
    for r0 in range(0, s, block):
        r1 = min(r0 + block, s)
        qb = q[r0:r1].reshape(r1 - r0, hkv, rep, d).permute(1, 2, 0, 3)  # [hkv, rep, b, d]
        sc = (qb @ kk[:, None, :r1].transpose(-1, -2)) / math.sqrt(d)  # [hkv, rep, b, r1]
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        mask = torch.arange(r1, device=q.device)[None] > rows
        sc.masked_fill_(mask, float("-inf"))
        o = torch.softmax(sc, -1) @ vv[:, None, :r1]  # [hkv, rep, b, d]
        out[r0:r1] = o.permute(2, 0, 1, 3).reshape(r1 - r0, hq, d)
    return out


def decoder_layer(w: Widen, i: int, x: torch.Tensor, pos: torch.Tensor, n: dict, theta: float,
                  segments: list | None = None, rows: int = 8192) -> torch.Tensor:
    """One layer over one sequence x [S, h]. ``segments``: (start, end)
    pairs of a packed row, attention kept inside each (positions restart in
    each segment, as ``pos`` gives them); None: one causal sequence."""
    def g(name):
        return w(f"text.layers.*.{name}", i)

    s = x.shape[0]
    hq, hkv, d = n["hq"], n["hkv"], n["d"]
    y = rms_norm(x, g("input_norm"))
    q = (y @ g("q_proj.weight").T + g("q_proj.bias")).reshape(s, hq, d)
    k = (y @ g("k_proj.weight").T + g("k_proj.bias")).reshape(s, hkv, d)
    v = (y @ g("v_proj.weight").T + g("v_proj.bias")).reshape(s, hkv, d)
    del y
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    if segments is None:
        att = causal_attention(q, k, v)
    else:
        att = torch.cat([causal_attention(q[a:b], k[a:b], v[a:b]) for a, b in segments])
    x = x + att.reshape(s, hq * d) @ g("o_proj.weight").T
    del q, k, v, att
    gate, up, down = g("gate_proj.weight"), g("up_proj.weight"), g("down_proj.weight")
    post = g("post_attn_norm")
    parts = []
    for r0 in range(0, s, rows):
        y = rms_norm(x[r0 : r0 + rows], post)
        parts.append(x[r0 : r0 + rows] + (F.silu(y @ gate.T) * (y @ up.T)) @ down.T)
    return torch.cat(parts)


def head(w: Widen, hidden: torch.Tensor, rows: int = 4096) -> torch.Tensor:
    """Final norm and untied head: [N, h] -> float32 logits [N, vocab]."""
    norm, lm = w("text.final_norm"), w("text.lm_head.weight")
    return torch.cat([rms_norm(hidden[r : r + rows], norm) @ lm.T
                      for r in range(0, hidden.shape[0], rows)])
