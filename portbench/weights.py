"""The benchmark's weights: every tensor of a configuration, made on the
device from the run's seed.

One normal draw per stack of like tensors (a layer stack is [L, *shape]), in
the type the model is served in, with a generator seeded from the run's seed
and the stack's name. The program gets these values copied into its own
parameters; the plain reference makes them again from the same seed. Both
sides therefore hold the same bits without either reading the other's.

Names are the program's parameter names with the layer index as ``*``
("text.layers.*.q_proj.weight"). Scales: matrices and embeddings 0.02 (the
JAX package's initialiser), biases 0.02, norm weights 1 + 0.02 n, the tower's
layer scales 0.1 + 0.02 n. The projector's last matrix is drawn at 7e-4 so
that its rows come out near the embedding table's scale (0.02): a random
projector at 0.02 gives rows ~28 x the table's scale, and a video's 16K such
rows would swamp the prompt.
"""
from __future__ import annotations

import dataclasses
import hashlib
import re

import torch

LAYER = re.compile(r"\.layers\.(\d+)\.")


@dataclasses.dataclass(frozen=True)
class Stack:
    name: str  # "text.layers.*.q_proj.weight" or "text.embed"
    shape: tuple  # of one tensor
    layers: int  # 0: not a layer stack
    std: float
    mean: float = 0.0


def dims(cfg: dict) -> dict:
    """The widths the stacks need, from a configuration file (the Long-VITA
    HF config.json layout: the decoder's keys at the top, the tower's under
    "visual")."""
    v = cfg["visual"]
    h, hq, hkv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    vh = v["hidden_size"]
    return dict(
        h=h, i=cfg["intermediate_size"], l=cfg["num_hidden_layers"], hq=hq, hkv=hkv,
        d=h // hq, v=cfg["vocab_size"], vh=vh, vi=v["intermediate_size"],
        vl=v["num_hidden_layers"], vheads=v["num_attention_heads"],
        vd=vh // v["num_attention_heads"],
        patch=v["patch_size"], grid=v["image_size"] // v["patch_size"], image=v["image_size"],
        shuffle=int(round(1 / cfg["vision_downsample_ratio"])) ** 2,
        tokens=cfg["image_token_length"],
    )


def stacks(cfg: dict) -> list[Stack]:
    """Every stack of the configuration, in a fixed order."""
    n = dims(cfg)
    h, i, hq, hkv, d, vh, vi = n["h"], n["i"], n["hq"], n["hkv"], n["d"], n["vh"], n["vi"]
    L, VL = n["l"], n["vl"]

    def layer(prefix, suffix, shape, layers, std, mean=0.0):
        return Stack(f"{prefix}.layers.*.{suffix}", tuple(shape), layers, std, mean)

    out = [
        Stack("text.embed", (n["v"], h), 0, 0.02),
        Stack("text.final_norm", (h,), 0, 0.02, 1.0),
        Stack("text.lm_head.weight", (n["v"], h), 0, 0.02),
    ]
    out += [
        layer("text", "input_norm", (h,), L, 0.02, 1.0),
        layer("text", "post_attn_norm", (h,), L, 0.02, 1.0),
        layer("text", "q_proj.weight", (hq * d, h), L, 0.02),
        layer("text", "q_proj.bias", (hq * d,), L, 0.02),
        layer("text", "k_proj.weight", (hkv * d, h), L, 0.02),
        layer("text", "k_proj.bias", (hkv * d,), L, 0.02),
        layer("text", "v_proj.weight", (hkv * d, h), L, 0.02),
        layer("text", "v_proj.bias", (hkv * d,), L, 0.02),
        layer("text", "o_proj.weight", (h, hq * d), L, 0.02),
        layer("text", "gate_proj.weight", (i, h), L, 0.02),
        layer("text", "up_proj.weight", (i, h), L, 0.02),
        layer("text", "down_proj.weight", (h, i), L, 0.02),
    ]
    out += [
        Stack("vision.embeddings.cls_token", (1, 1, vh), 0, 0.02),
        Stack("vision.embeddings.pos_embed", (n["grid"] ** 2 + 1, vh), 0, 0.02),
        Stack("vision.embeddings.patch_embed.weight", (vh, n["patch"] ** 2 * 3), 0, 0.02),
        Stack("vision.embeddings.patch_embed.bias", (vh,), 0, 0.02),
    ]
    for norm in ("norm1", "norm2"):
        out += [layer("vision", f"{norm}.scale", (vh,), VL, 0.02, 1.0),
                layer("vision", f"{norm}.bias", (vh,), VL, 0.02)]
    for name, shape in (("qkv", (3 * vh, vh)), ("proj", (vh, vh)), ("fc1", (vi, vh)),
                        ("fc2", (vh, vi))):
        out += [layer("vision", f"{name}.weight", shape, VL, 0.02),
                layer("vision", f"{name}.bias", shape[:1], VL, 0.02)]
    out += [layer("vision", "ls1", (vh,), VL, 0.02, 0.1),
            layer("vision", "ls2", (vh,), VL, 0.02, 0.1)]
    pin = vh * n["shuffle"]
    out += [
        Stack("projector.pre_norm.scale", (pin,), 0, 0.02, 1.0),
        Stack("projector.pre_norm.bias", (pin,), 0, 0.02),
        Stack("projector.fc1.weight", (vh, pin), 0, 0.02),
        Stack("projector.fc2.weight", (h, vh), 0, 7e-4),
    ]
    return out


def stack_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for one stack of one run."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def make(stack: Stack, seed: int, device, dtype=torch.bfloat16) -> torch.Tensor:
    """The stack's values: [layers, *shape], or [*shape] when not a layer
    stack. One draw in ``dtype`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(stack_seed(seed, stack.name))
    shape = ((stack.layers,) if stack.layers else ()) + stack.shape
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    t.mul_(stack.std)
    if stack.mean:
        t.add_(stack.mean)
    return t


def stack_name(param_name: str) -> tuple[str, int]:
    """"text.layers.3.q_proj.weight" -> ("text.layers.*.q_proj.weight", 3);
    a name outside a layer stack -> (name, -1)."""
    m = LAYER.search(param_name)
    if m is None:
        return param_name, -1
    return param_name[: m.start()] + ".layers.*." + param_name[m.end():], int(m.group(1))


class Weights:
    """Lazily made stacks of one seed, kept once made (the reference's side)."""

    def __init__(self, cfg: dict, seed: int, device, dtype=torch.bfloat16):
        self.seed, self.device, self.dtype = seed, device, dtype
        self.by_name = {s.name: s for s in stacks(cfg)}
        self._made: dict[str, torch.Tensor] = {}

    def stack(self, name: str) -> torch.Tensor:
        if name not in self._made:
            self._made[name] = make(self.by_name[name], self.seed, self.device, self.dtype)
        return self._made[name]

    def __call__(self, name: str, layer: int = -1) -> torch.Tensor:
        """One tensor: get("text.embed"), get("text.layers.*.q_proj.weight", 3)."""
        t = self.stack(name)
        return t if layer < 0 else t[layer]
