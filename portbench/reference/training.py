"""Stage-1 training steps worked out again in plain float32.

From the benchmark's samples alone: each sample rendered as the ChatML
conversation (a user turn holding the image's block of ``tokens`` context
ids, the assistant's caption supervised with its <|im_end|> and newline),
greedily packed into rows of ``seq_len`` (a sample that does not fit closes
the row), the next-token targets kept inside each sample. A step is the
frozen tower, the trained projector, the frozen decoder over the packed row
(attention and positions inside each sample), the mean cross-entropy of the
supervised targets, the projector's gradients, and AdamW as the stage
states it: clipping at a global norm of 1, betas (0.9, 0.95), eps 1e-8, the
learning rate warmed up linearly from 0 over ``warmup_steps`` then cosine
decayed, the parameters and moments held in the model's bfloat16. The
decoder keeps each layer's input and runs the layer again in the backward
pass, so that a 32K row fits on the card in float32.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.model import Widen, decoder_layer, head, pixels, projector, \
    projector_weights, strict_f32, vit
from portbench.weights import Weights, dims


def render(ids, caption_ids: list, tokens: int) -> tuple[list, int, int]:
    """-> (sample ids, the first image row, the first supervised id)."""
    user = ids.piece("user_head") + [ids.special["<img>"]]
    first_row = len(user)
    user += [ids.special["<IMG_CONTEXT>"]] * tokens + [ids.special["</img>"]]
    user += ids.piece("turn_end")
    head_ids = ids.piece("assistant_head")
    out = user + head_ids + list(caption_ids) + ids.piece("turn_end")
    return out, first_row, len(user) + len(head_ids)


def pack(lengths: list, seq_len: int, count: int) -> list:
    """Greedy packs of sample indices, the first ``count`` of them."""
    packs, cur, used = [], [], 0
    for i, n in enumerate(lengths):
        if n > seq_len:
            continue
        if used + n > seq_len:
            packs.append(cur)
            if len(packs) == count:
                return packs
            cur, used = [], 0
        cur.append(i)
        used += n
    raise ValueError(f"{len(packs)} packs from {len(lengths)} samples, {count} wanted")


def layout(plan: dict, ids, cfg: dict, seq_len: int, count: int) -> list:
    """The first ``count`` packed rows: tokens, positions, segments, image
    rows (with their pool images) and supervised (position, target)
    pairs; the padding after the last sample is left out (no target and no
    sample sees it)."""
    t = cfg["image_token_length"]
    rendered = [render(ids, s["caption_ids"], t) for s in plan["samples"]]
    rows = []
    for members in pack([len(r[0]) for r in rendered], seq_len, count):
        toks, pos, segs, feat, images, sup_pos, sup_tgt = [], [], [], [], [], [], []
        for i in members:
            sample, first_row, first_sup = rendered[i]
            off = len(toks)
            toks += sample
            pos += list(range(len(sample)))
            segs.append((off, off + len(sample)))
            feat += list(range(off + first_row, off + first_row + t))
            images.append(plan["samples"][i]["image"])
            sup_pos += list(range(off + first_sup - 1, off + len(sample) - 1))
            sup_tgt += sample[first_sup:]
        rows.append(dict(tokens=toks, positions=pos, segments=segs, feat=feat, images=images,
                         sup_pos=sup_pos, sup_tgt=sup_tgt, samples=members))
    return rows


def schedule(step: int, optim: dict) -> float:
    peak, warm = optim["lr"], optim["warmup_steps"]
    if warm and step < warm:
        return peak * step / warm
    decay = max(optim["total_steps"], warm + 1) - warm
    alpha = optim["min_lr_ratio"]
    c = 0.5 * (1 + math.cos(math.pi * min(step - warm, decay) / decay))
    return peak * ((1 - alpha) * c + alpha)


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


class Reference:
    """The float32 model and the optimizer's state for a run's seed."""

    def __init__(self, cfg: dict, seed: int, plan: dict, device, lower: bool = False):
        strict_f32()
        self.cfg, self.n, self.device = cfg, dims(cfg), device
        self.weights = Weights(cfg, seed, device)
        self.w = Widen(self.weights, lower=lower)
        self.params = {k: bf16(v) for k, v in projector_weights(Widen(self.weights)).items()}
        if lower:  # the control's trained matrices start from their fp8 values too
            self.params = {k: self.w(f"projector.{k}") if v.dim() == 2 else v
                           for k, v in self.params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.pool = plan["pool"]
        self._feats: dict[int, torch.Tensor] = {}

    def features(self, images: list) -> torch.Tensor:
        """Frozen tower features of pool images, each encoded once."""
        todo = sorted(set(images) - set(self._feats))
        with torch.no_grad():
            for i in range(0, len(todo), 16):
                part = todo[i : i + 16]
                tiles = pixels(torch.as_tensor(self.pool[part], device=self.device))
                for k, f in zip(part, vit(self.w, tiles, self.n)):
                    self._feats[k] = f
        return torch.stack([self._feats[i] for i in images])

    def loss_and_grads(self, row: dict) -> tuple[float, dict]:
        n, dev = self.n, self.device
        leaves = {k: v.clone().requires_grad_(True) for k, v in self.params.items()}
        img = projector(leaves, self.features(row["images"]), n).reshape(-1, n["h"])
        with torch.no_grad():
            x = self.w("text.embed")[torch.as_tensor(row["tokens"], device=dev)]
        x = x.index_put((torch.as_tensor(row["feat"], device=dev),), img)
        pos = torch.as_tensor(row["positions"], device=dev)
        for i in range(n["l"]):
            x = checkpoint(decoder_layer, self.w, i, x, pos, n, self.cfg["rope_theta"],
                           row["segments"], use_reentrant=False)
        sup = torch.as_tensor(row["sup_pos"], device=dev)
        tgt = torch.as_tensor(row["sup_tgt"], device=dev)

        def nll(hid, t):
            lg = head(self.w, hid)
            return (torch.logsumexp(lg, -1) - lg.gather(1, t[:, None])[:, 0]).sum()

        total = sum(checkpoint(nll, x[sup[r : r + 4096]], tgt[r : r + 4096], use_reentrant=False)
                    for r in range(0, len(sup), 4096))
        loss = total / len(sup)
        loss.backward()
        return float(loss.detach()), {k: v.grad.detach() for k, v in leaves.items()}

    def step(self, grads: dict, optim: dict) -> None:
        """AdamW on the projector, as the stage states it (see the module)."""
        b1, b2 = optim["betas"]
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        clip = bool(norm >= optim["grad_clip"])
        lr = schedule(self.count, optim)
        self.count += 1
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for k, g in grads.items():
            if clip:
                g = g / norm * optim["grad_clip"]
            self.m[k] = bf16((1 - b1) * g + b1 * self.m[k])
            self.v[k] = bf16((1 - b2) * g * g + b2 * self.v[k])
            u = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + optim["eps"])
            self.params[k] = bf16(self.params[k] - lr * u)
