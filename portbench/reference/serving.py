"""The served tokens judged against the plain reference.

For each judged request the reference builds the prompt's ids itself (the
chat template's ids, each frame a <vid> block of ``tokens`` context ids and
</vid>), encodes the frames with the float32 tower and projector, places the
features on the context ids, and runs the float32 decoder over the prompt
and the served tokens (teacher-forced). At each served token it reads the
gap by which the token's logit lies below the reference's best logit there
(0 when the program picked the reference's argmax), and the reference's
log-probability of the token. The numbers compared are the widest gap
(``max_gap``) and the widest distance between the program's log-probability
of a served token and the reference's (``logprob_gap``).

With ``lower`` the same pass runs a second time with every matrix in fp8
(the control): at each position the gap is read of the token that the
control puts first, and the control's log-probability of the served token.
"""
from __future__ import annotations

import torch

from portbench.reference.model import Widen, decoder_layer, head, pixels, projector, \
    projector_weights, strict_f32, vit
from portbench.weights import Weights, dims


def prompt(ids, content_ids: list, n_frames: int, tokens: int) -> tuple[list, list]:
    """-> (prompt ids, the positions the frame features take, frame-major)."""
    out, feat = [], []
    for t in ids.chat(content_ids):
        if t == ids.special["<video>"]:
            for _ in range(n_frames):
                out.append(ids.special["<vid>"])
                feat.extend(range(len(out), len(out) + tokens))
                out.extend([ids.special["<VID_CONTEXT>"]] * tokens)
                out.append(ids.special["</vid>"])
        else:
            out.append(t)
    return out, feat


@torch.no_grad()
def _logits(w: Widen, cfg: dict, items: list, device) -> list:
    """float32 logits at each item's served positions."""
    n = dims(cfg)
    proj = projector_weights(w)
    hidden, spans = [], []
    for it in items:
        x = w("text.embed")[torch.as_tensor(it["ids"], device=device)]
        if it["frames"] is not None:
            feats = []
            for f0 in range(0, len(it["frames"]), 16):
                tiles = pixels(torch.as_tensor(it["frames"][f0 : f0 + 16], device=device))
                feats.append(projector(proj, vit(w, tiles, n), n))
            feats = torch.cat(feats).reshape(-1, n["h"])
            x[torch.as_tensor(it["feat"], device=device)] = feats
        hidden.append(x)
        spans.append(it["judge"])
    for i in range(n["l"]):
        hidden = [decoder_layer(w, i, x, torch.arange(x.shape[0], device=device), n,
                                cfg["rope_theta"]) for x in hidden]
    return [head(w, x[a:b]) for x, (a, b) in zip(hidden, spans)]


def judge(cfg: dict, seed: int, items: list, ids, device, lower: bool = False) -> dict:
    """items: dicts of content_ids, frames (uint8 [F, H, W, 3] or None) and
    served (the program's token ids). -> {"gaps": per item, per served token,
    "control_gaps" with ``lower``, "prompt_tokens": per item}."""
    strict_f32()
    n = dims(cfg)
    prepared = []
    for it in items:
        nf = 0 if it["frames"] is None else len(it["frames"])
        p, feat = prompt(ids, it["content_ids"], nf, n["tokens"])
        served = list(it["served"])
        seq = p + served[:-1]
        prepared.append({"ids": seq, "feat": feat, "frames": it["frames"],
                         "judge": (len(p) - 1, len(p) - 1 + len(served)), "served": served,
                         "prompt_tokens": len(p)})
    weights = Weights(cfg, seed, device)
    ref = _logits(Widen(weights), cfg, prepared, device)
    out = {"prompt_tokens": [p["prompt_tokens"] for p in prepared], "gaps": [],
           "logprobs": []}
    for lg, p in zip(ref, prepared):
        tok = torch.as_tensor(p["served"], device=device)[:, None]
        out["gaps"].append((lg.max(-1).values - lg.gather(1, tok)[:, 0]).tolist())
        out["logprobs"].append(torch.log_softmax(lg, -1).gather(1, tok)[:, 0].tolist())
    if lower:
        low = _logits(Widen(weights, lower=True), cfg, prepared, device)
        out["control_gaps"] = [
            (lg.max(-1).values - lg.gather(1, lo.argmax(-1)[:, None])[:, 0]).tolist()
            for lg, lo in zip(ref, low)]
        out["control_logprobs"] = [
            torch.log_softmax(lo, -1).gather(
                1, torch.as_tensor(p["served"], device=device)[:, None])[:, 0].tolist()
            for lo, p in zip(low, prepared)]
    del weights
    return out
