"""Training traffic: the port's cloud training step at full width and depth.

Set-up makes the weights from the seed on the device, builds the training
state (bf16 params, the port's f32 AdamW master and moments) and the step
function ``make_cloud_step`` returns, fed by the benchmark's own token
stream; it runs the first check steps through that same function (they warm
up every shape) and records what ``correct`` compares: their losses, the
first gradient as the optimizer got it (from its first moment) and each
leaf's change over them, of the f32 master and of the bf16 params.  The
window then dispatches further steps until ``--seconds`` have passed,
``dispatch_ahead_steps`` ahead of the one it waits for and with the losses
read after it, so that the card stays fed while the host stalls; it sends
nothing more once the time is up, waits for all it sent and reads the clock
after that wait.  ``train_tokens_per_s`` is all tokens of those steps over
all of that time.  Before the window the objects set-up made are frozen out
of the garbage collector's full passes, whose cost would otherwise grow with
what the harness holds rather than with what the step makes.  After the
window the state is freed and the reference runs the same steps from the
same weights and batches.

Traffic parameters (``traffic/<mix>.json``): ``seq_len``,
``microbatches``, ``microbatch_size``, ``zipf_a``, ``adamw`` (the
optimizer's hyperparameters, given to both sides), ``check_steps``,
``dispatch_ahead_steps``, ``trace_timed_steps`` and
``trace_profiled_steps``.
"""
from __future__ import annotations

import gc
import time

import numpy as np

from harness import checks, program, weights
from harness.feed import TokenFeed
from yardstick import flops


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def leaf_names(spec) -> list:
    return [".".join(str(k) for k in leaf.path) for leaf in spec]


def _norms(tensors) -> np.ndarray:
    import torch
    return torch.stack([t.float().norm() for t in tensors]).cpu().double() \
        .numpy()


def change_norms(tree, spec, seed, dev) -> np.ndarray:
    """Each leaf's ``|tree leaf - its initial value|``, the initial values
    made again chunk by chunk from the seed."""
    import torch
    plan = weights.chunks(spec)
    out = [None] * len(spec)
    for k in range(len(plan)):
        init = weights.chunk_leaves(spec, plan, k, seed, dev)
        for i, t0 in init.items():
            out[i] = (weights.get(tree, spec[i].path).float()
                      - t0.float()).norm()
        del init
    return torch.stack(out).cpu().double().numpy()


def _shape(tr, microbatches=None):
    from repro_torch.configs.base import ShapeConfig
    n = tr["microbatches"] if microbatches is None else microbatches
    return ShapeConfig("bench", tr["seq_len"], n * tr["microbatch_size"],
                       "train", microbatches=n)


class _Half:
    """A feed of the first half of each batch (the half-batch fault)."""

    def __init__(self, feed, rows):
        self.feed, self.rows = feed, rows

    def __iter__(self):
        return self

    def __next__(self):
        from harness.feed import Batch
        b = next(self.feed)
        return Batch(b.tokens[: self.rows], b.targets[: self.rows],
                     b.mask[: self.rows])


def _restoring(step, part):
    """A fault: ``step`` with ``part(state)`` put back as it was before
    each call.  The whole state: a step that returns its state unchanged;
    the params: a step that never refreshes them from the f32 master."""
    import torch

    def broken(state):
        keep = _clone(part(state))
        state, m = step(state)
        with torch.no_grad():
            _copy_into(part(state), keep)
        return state, m
    return broken


_RESTORED = {"unchanged": lambda state: state,
             "stale_params": lambda state: state["params"]}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _copy_into(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, list):
        for a, b in zip(dst, src):
            _copy_into(a, b)
    else:
        dst.copy_(src)


def prepare(r):
    """Set-up: the state, the step function and the program's readings of
    the check steps."""
    import torch
    from repro_torch.launch.train import make_cloud_step
    from repro_torch.optim.optimizers import AdamWConfig, adamw_init

    c, tr, dev, arch = r.cell.config, r.cell.traffic, r.device, r.cell.model
    cfg = program.model_config(c, arch.FIELDS)
    spec = arch.leaves(c)
    params = weights.nest(spec, weights.make_all(spec, r.seed, dev))
    program.check_tree(params, cfg)
    state = {"params": params, "opt": adamw_init(params)}
    feed = TokenFeed(r.seed, c["vocab_size"], tr["seq_len"],
                     tr["microbatches"] * tr["microbatch_size"],
                     a=tr["zipf_a"])
    shape = _shape(tr)
    if r.fault == "half_batch":
        shape = _shape(tr, tr["microbatches"] // 2)
        feed = _Half(feed, shape.global_batch)
    step = make_cloud_step(cfg, shape, feed,
                           opt_cfg=AdamWConfig(**tr["adamw"]), device=dev)
    if r.fault in _RESTORED:
        step = _restoring(step, _RESTORED[r.fault])
    prog = {"losses": []}
    for i in range(tr["check_steps"]):
        state, m = step(state)
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["grad_norms"] = _norms(
                [weights.get(state["opt"]["m"], leaf.path) for leaf in spec]
            ) / (1.0 - tr["adamw"]["b1"])
    prog["change_norms"] = change_norms(state["opt"]["master"], spec,
                                        r.seed, dev)
    prog["work_change_norms"] = change_norms(state["params"], spec, r.seed,
                                             dev)
    _sync(dev)
    return state, step, prog, spec


def _timed_steps(step, state, dev, count):
    """``count`` steps, each waited for: their walls time the traced run's
    unprofiled steps."""
    walls, losses = [], []
    for _ in range(count):
        w0 = time.perf_counter()
        state, m = step(state)
        losses.append(float(m["loss"]))
        _sync(dev)
        walls.append(time.perf_counter() - w0)
    return state, walls, losses


def _window(step, state, dev, seconds, ahead):
    """The measured window: ``(state, steps, wall_s, losses, log)``.  Each
    step is waited for only once ``ahead`` more have been dispatched; the
    losses are read after the closing wait."""
    import torch
    losses, done = [], []
    gen2 = {"n": 0, "s": 0.0}

    def on_gc(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                gen2["t"] = time.perf_counter()
            else:
                gen2["n"] += 1
                gen2["s"] += time.perf_counter() - gen2["t"]
    gc.callbacks.append(on_gc)
    t_start = time.perf_counter()
    try:
        while time.perf_counter() - t_start < seconds:
            state, m = step(state)
            losses.append(m["loss"].detach())
            if dev.type == "cuda":
                done.append(torch.cuda.Event(enable_timing=True))
                done[-1].record()
                if len(done) > ahead:
                    done[-1 - ahead].synchronize()
        _sync(dev)
        wall = time.perf_counter() - t_start
    finally:
        gc.callbacks.remove(on_gc)
    gaps = [a.elapsed_time(b) / 1e3 for a, b in zip(done, done[1:])]
    log = (f"device s between step ends {gaps}; full garbage collections "
           f"{gen2['n']} in {gen2['s']:.3f} s")
    return state, len(losses), wall, \
        torch.stack(losses).double().cpu().tolist(), log


def reference(cell, seed, dev, spec, matmul) -> dict:
    """The reference's check steps (the cell's architecture's ``loss``)
    from the same weights and batches, in the configuration's state: an f32
    master that AdamW updates and, before each step, a working copy rounded
    from it to each leaf's dtype (bf16 or f32), through which the loss and
    its gradients are computed in f32 (TF32 off).  Returns the losses, the
    first-step gradient norms (post-clipping, as the optimizer takes them)
    and each leaf's change, of the master and of the working copy."""
    import torch
    from reference.adamw import AdamW

    c, tr, model = cell.config, cell.traffic, cell.model
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        master = [t.float() for t in weights.make_all(spec, seed, dev)]
        init = [t.clone() for t in master]
        dtypes = [weights.torch_dtype(leaf.dtype) for leaf in spec]

        def working():
            return [m.to(d).float() for m, d in zip(master, dtypes)]
        opt = AdamW(master, tr["adamw"])
        feed = TokenFeed(seed, c["vocab_size"], tr["seq_len"],
                         tr["microbatches"] * tr["microbatch_size"],
                         a=tr["zipf_a"])
        n, mb = tr["microbatches"], tr["microbatch_size"]
        out = {"losses": []}
        for s in range(tr["check_steps"]):
            batch = next(feed)
            work = [t.requires_grad_(True) for t in working()]
            tree = weights.nest(spec, work)
            total = 0.0
            for i in range(n):
                rows = slice(i * mb, (i + 1) * mb)
                tok = torch.from_numpy(batch.tokens[rows]).to(dev)
                tgt = torch.from_numpy(batch.targets[rows]).to(dev)
                loss = model.loss(tree, tok, tgt, c, matmul)
                loss.backward()
                total += float(loss.detach())
            out["losses"].append(total / n)
            grads = [t.grad.div_(n) for t in work]
            del work, tree
            opt.update(grads)
            del grads
            if s == 0:
                out["grad_norms"] = _norms(opt.m) / (1.0 - tr["adamw"]["b1"])
        with torch.no_grad():
            out["change_norms"] = _norms(
                [(m - i).norm() for m, i in zip(master, init)])
            out["work_change_norms"] = _norms(
                [(m.to(d).float() - i).norm()
                 for m, d, i in zip(master, dtypes, init)])
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]


def free(dev) -> None:
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(r) -> dict:
    import torch
    from harness.cli import TraceData
    from reference.matmul import plain_matmul

    c, tr, dev, arch = r.cell.config, r.cell.traffic, r.device, r.cell.model
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state, step, prog, spec = prepare(r)
    setup_s = time.perf_counter() - r.t0
    r.log(f"set-up {setup_s:.3f} s; check steps' losses {prog['losses']}")
    tokens = tr["seq_len"] * tr["microbatches"] * tr["microbatch_size"]
    out = {"trace": None, "e2e": {}}
    if r.trace:
        from harness.trace import profiled
        state, walls, losses = _timed_steps(
            step, state, dev, tr["trace_timed_steps"])
        before = program.counters()
        k = tr["trace_profiled_steps"]
        holder = {"state": state}

        def window():
            for _ in range(k):
                holder["state"], m = step(holder["state"])
                losses.append(float(m["loss"]))
        win = profiled(window)
        state = holder.pop("state")
        out["trace"] = TraceData(
            window=win, units=k, unit_wall_s=sum(walls) / len(walls),
            model_flops_per_unit=flops.model_flops(
                arch, c, tr["microbatches"] * tr["microbatch_size"],
                tr["seq_len"], "train"),
            shapes={key: [(s, n * tr["microbatches"]) for s, n in v]
                    for key, v in arch.kernel_shapes(
                        c, tr["microbatch_size"], tr["seq_len"],
                        "train").items()},
            counters=program.counter_delta(before, program.counters()),
            peaks=None)
        attempted = len(walls) + k
        r.log(f"timed step walls s {walls}; profiled {k} in "
              f"{win.wall_s:.3f} s")
    else:
        gc.collect()
        gc.freeze()
        state, attempted, wall, losses, log = _window(
            step, state, dev, r.seconds, tr["dispatch_ahead_steps"])
        gc.unfreeze()
        out["e2e"] = {"setup_s": setup_s,
                      "train_tokens_per_s": tokens * attempted / wall}
        r.log(f"window: {attempted} steps in {wall:.6f} s; {log}")
    failed = sum(not np.isfinite(x) for x in losses)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
    del state, step
    free(dev)
    t_ref = time.perf_counter()
    ref = reference(r.cell, r.seed, dev, spec, plain_matmul)
    free(dev)
    numbers = checks.training(prog, ref, leaf_names(spec))
    r.log(f"reference {time.perf_counter() - t_ref:.1f} s; program losses "
          f"{prog['losses']}, reference {ref['losses']}; worst leaves "
          f"{numbers['worst']}")
    correct, judged = checks.judge(numbers, r.cell.cell["limits"])
    out.update(correct=correct and failed == 0, checks=judged,
               attempted=attempted, failed=failed, numbers=numbers,
               prog=prog, ref=ref)
    return out
