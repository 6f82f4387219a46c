"""Training cells: the port's Trainer fed through its own data path.

Set-up builds one Trainer and one feed (the port's greedy packer, collated
batches with the logit budget, the prefetch thread) over the samples the
traffic generator made from the seed, and runs the first ``setup_steps``
steps through ``Trainer.train``, one call a step. The window then hands the
same Trainer and the same feed to ``Trainer.train``, and stamps each step's
end on the host clock as the loop asks for the next batch (the loop reads
every step's loss, which waits for the device). Steps run back to back
until ``--seconds`` have passed; the rate counts the packed tokens of the
whole steps over the time they took.

Every step of the run, in set-up and in the window alike, goes through one
recording step function, installed before the first: it keeps each step's
supervised count as the step reported it, and the projector after each of
the first ``check.steps`` steps, of which the last lie inside the window.
The optimizer's first moments after step 1 give the gradient as the
optimizer got it (m / (1 - b1)). Once the window has closed and the peak
memory has been read, the program's state is freed and the plain reference
follows those first ``check.steps`` steps from the seed on the same samples
(portbench/reference/training.py).
"""
from __future__ import annotations

import gc
import itertools
import os
import sys
import time
import types

import torch

from portbench import harness, system, vocab
from portbench.reference import training as ref_training
from portbench.trace import Trace, note
from portbench.weights import dims

LEAF = "projector."


def snapshot(tree) -> dict:
    return {k[len(LEAF):]: p.detach().float().clone() for k, p in tree.named_parameters()
            if k.startswith(LEAF)}


def run(env):
    dev = torch.device("cuda", 0) if env.device == "cuda" else torch.device(env.device)
    cfg, cell, mix = env.cfg, env.cell, env.mix
    n = dims(cfg)
    ids = vocab.Ids(cfg["vocab_size"])
    gen = harness.module("traffic", mix["generator"])
    plan = gen.generate(mix, env.seed, ids, n["image"])
    run_cfg = cell["run"]
    tree = system.params(cfg, env.seed, dev)
    tokdir = vocab.tokenizer_dir(os.path.join(harness.WORK, f"tokenizer-{ids.base}"),
                                 cfg["vocab_size"])
    mm = system.multimodal(tokdir, cfg)
    trainer = system.trainer(tree, cfg, run_cfg)
    feed = system.batches([gen.conversation(plan, s) for s in plan["samples"]], mm, run_cfg)

    b1 = run_cfg["optim"]["betas"][0]
    k = cell["check"]["steps"]
    if k <= cell["setup_steps"]:
        raise ValueError("the check has to follow at least one of the window's steps")
    before = snapshot(trainer.state.params)
    states, counts = [before], []
    step_fn = trainer.step_fn

    def recorded(state, batch):
        """The step of every call this run makes: the step's supervised
        count, and the projector after each of the first k steps."""
        state, out = step_fn(state, batch)
        counts.append(out["tokens"])
        if len(counts) <= k:
            states.append(snapshot(state.params))
        return state, out

    trainer.step_fn = recorded
    losses, first_grads = [], None
    for step in range(cell["setup_steps"]):
        losses += trainer.train(itertools.islice(feed, 1))["losses"]
        if step == 0:
            first_grads = {k_[len(LEAF):]: m.detach().float() / (1 - b1)
                           for k_, m in trainer.state.opt_state.mu.items() if k_.startswith(LEAF)}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches0 = system.kernel_launches()
    setup_s = time.perf_counter() - env.t0

    # ---- the window -------------------------------------------------------
    stamps, traces = [], []
    p0, pn = cell.get("trace", {}).get("step", 2), cell.get("trace", {}).get("steps", 1)
    prof = None

    def timed():
        """The window's feed: stamps the end of each step as the loop asks
        for the next batch, and traces steps p0 .. p0 + pn - 1."""
        nonlocal prof
        while True:
            stamps.append(time.perf_counter())
            k = len(stamps) - 1  # steps the window has finished
            if prof is not None and k == p0 + pn:
                prof.stop()
                traces.append((prof, (p0, k)))
                prof = None
            if stamps[-1] >= stamps[0] + env.seconds:
                return
            if env.trace and k == p0 and not traces:
                prof = Trace()
                prof.start()
            with note("next_batch"):
                batch = next(feed, None)
            if batch is None:
                raise RuntimeError("the traffic's samples ran out inside the window")
            yield batch

    with note("train"):
        losses += trainer.train(timed())["losses"]
    if prof is not None:
        prof.stop()
        traces.append((prof, (p0, len(stamps) - 1)))
    steps = len(stamps) - 1
    launches = {k: v - launches0[k] for k, v in system.kernel_launches().items()}
    device = harness.device_record(torch, 1) if dev.type == "cuda" else {"platform": "cpu"}
    row_tokens = run_cfg["seq_len"] * run_cfg["rows"]
    e2e = {"train_tokens_per_s": steps * row_tokens / (stamps[-1] - stamps[0]), "setup_s": setup_s}
    print(f"[train] setup {setup_s:.2f} s ({cell['setup_steps']} steps); window {steps} steps in "
          f"{stamps[-1] - stamps[0]:.2f} s ({[round(b - a, 3) for a, b in zip(stamps, stamps[1:])]}"
          f"); {e2e}; launches {launches}", file=sys.stderr)
    if len(states) <= k:
        raise RuntimeError(f"the run made {len(counts)} steps, the check follows {k}")
    counts = [float(c) for c in counts[:k]]
    layout = ref_training.layout(plan, ids, cfg, run_cfg["seq_len"],
                                 cell["setup_steps"] + steps)
    ctx = types.SimpleNamespace(
        cell=env.cell_name, n=n, stamps=stamps, traced=traces[0][1] if traces else None,
        trace=traces[0][0] if traces else None,
        rows=layout[cell["setup_steps"]:])
    metrics = env.report(e2e, ctx)

    # ---- correctness: the first steps against the plain reference -----------
    del trainer, tree, feed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = ref_training.Reference(cfg, env.seed, plan, dev)
    start = dict(ref.params)
    ref_losses, ref_first = [], None
    for s, row in enumerate(layout[:k]):
        loss, grads = ref.loss_and_grads(row)
        ref.step(grads, run_cfg["optim"])
        ref_losses.append(loss)
        if s == 0:
            ref_first = {name: m / (1 - b1) for name, m in ref.m.items()}
    readings = compare(losses[:k], ref_losses, first_grads, ref_first,
                       {key: states[k][key] - before[key] for key in before},
                       {key: ref.params[key] - start[key] for key in start})
    ref_counts = [len(row["sup_pos"]) for row in layout[:k]]
    readings["supervised_gap"] = sum(abs(a - b) for a, b in zip(counts, ref_counts))
    print(f"[check] reference followed {k} steps ({cell['setup_steps']} of set-up, "
          f"{k - cell['setup_steps']} of the window) in {time.perf_counter() - t:.1f} s: losses "
          f"{losses[:k]} vs {ref_losses}; supervised {counts} vs {ref_counts}; {readings}",
          file=sys.stderr)
    lim = cell["check"]["limits"]
    checks = {name: {"value": readings[name], "limit": lim[name]} for name in lim}
    correct = harness.within(checks)
    result = {"correct": correct, "attempted": steps, "failed": 0, "metrics": metrics,
              "device": device}
    if getattr(env, "control", False):
        ref_params = dict(ref.params)
        del ref
        gc.collect()
        low = ref_training.Reference(cfg, env.seed, plan, dev, lower=True)
        low_start = dict(low.params)
        low_losses, low_first = [], None
        for s, row in enumerate(layout[:k]):
            loss, grads = low.loss_and_grads(row)
            low.step(grads, run_cfg["optim"])
            low_losses.append(loss)
            if s == 0:
                low_first = {name: m / (1 - b1) for name, m in low.m.items()}
        control = compare(low_losses, ref_losses, low_first, ref_first,
                          {key: low.params[key] - low_start[key] for key in low_start},
                          {key: ref_params[key] - start[key] for key in start})
        control["supervised_gap"] = 0.0  # the control packs the reference's own rows
        print(f"[control] losses {low_losses}; {control}", file=sys.stderr)
        low_checks = {name: {"value": control[name], "limit": lim[name]} for name in lim}
        result["control_correct"] = harness.within(low_checks)
        checks.update({f"control_{name}": c for name, c in low_checks.items()})
    if env.trace and ctx.trace is not None:
        ctx.trace.add_to(result)
    return result, checks


def worst_leaf(got: dict, ref: dict, leaves) -> float:
    """max over ``leaves`` of | |got| - |ref| | / max(|ref|, the median
    leaf's |ref|)."""
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in ref.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return max((abs(float(torch.linalg.vector_norm(got[k])) - norms[k]) / max(norms[k], med)
                for k in leaves), default=0.0)


def compare(losses, ref_losses, grads, ref_grads, change, ref_change) -> dict:
    """The readings: the worst relative gap of the steps' losses, and the
    worst leaf's gap of the first gradient's and of the change's norms. The
    cell compares those its ``check.limits`` name; the others are printed
    (at the stage's size neither the fp8 control nor half a batch left out
    moves the loss or the first gradient's norm past what bf16 rounding
    does). A leaf whose reference gradient is under a thousandth of the
    median leaf's moves by round-off alone and is left out of the
    change."""
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in ref_grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    moving = [k for k, v in norms.items() if v >= 1e-3 * med]
    return {
        "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "grad_norm_gap": worst_leaf(grads, ref_grads, list(ref_grads)),
        "change_norm_gap": worst_leaf(change, ref_change, moving),
    }
