"""Serving traffic: the port's fixed-batch server (``BatchedServer``,
fused greedy decode) driven through its delivery callback as ``DeviceFlow``
drives it, in an open loop.

Request ``i`` of the window is due at ``i / rate`` seconds (the rate is the
cell's ``rate_per_s``, fixed below the server's measured capacity); the
loop delivers each request when it is due (late when the server was busy)
and a batch is served the moment it fills.  Every request carries a prompt
of ``prompt_len`` seeded Zipf tokens and is served ``1 + decode_tokens``
greedy tokens.  ``serve_p95_ms`` is the 95th percentile over all requests
of the window of the wall time from each request's own due time to its
tokens on the host: the wait for its batch to fill counts, as the user
waits it.  With ``--trace 1`` batches run back to back instead (timed, then
profiled).

After the window the server is freed and the reference runs once over a
seeded sample of the served requests, each prompt with its served tokens.

Traffic parameters: ``batch_size``, ``prompt_len``, ``decode_tokens``,
``zipf_a``, ``warmup_batches``, ``check_requests``, ``reference_batch``,
``trace_timed_batches``, ``trace_profiled_batches``.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np

from harness import checks, program, weights
from harness.feed import TokenFeed
from yardstick import flops


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Server:
    """The port's server over a pool of seeded prompts on the device."""

    def __init__(self, r, n_prompts: int):
        from repro_torch.core.deviceflow import Message
        from repro_torch.launch.serve import BatchedServer, stack_requests

        c, tr, dev = r.cell.config, r.cell.traffic, r.device
        arch = r.cell.model
        cfg = program.model_config(c, arch.FIELDS)
        self.spec = arch.leaves(c)
        params = weights.nest(self.spec,
                              weights.make_all(self.spec, r.seed, dev))
        program.check_tree(params, cfg)
        P, D = tr["prompt_len"], tr["decode_tokens"]
        self.prompts = next(TokenFeed(r.seed, c["vocab_size"], P, n_prompts,
                                      a=tr["zipf_a"], stream=1)).tokens
        self.server = BatchedServer(cfg, batch_size=tr["batch_size"],
                                    prompt_len=P, decode_tokens=D,
                                    max_len=P + D, params=params, device=dev)
        buf = stack_requests(self.prompts, device=dev)
        self.messages = [Message(task_id=0, device_id=i, round_idx=0,
                                 payload=buf.handle(i))
                         for i in range(n_prompts)]
        self.next = 0

    def deliver(self, t: float) -> bool:
        """Delivers the next request at virtual time ``t``; True when that
        filled a batch and the server served it (its tokens are on the host
        when this returns)."""
        from repro_torch.core.deviceflow import Delivery
        n = len(self.server.records)
        self.server(Delivery(t, message=self.messages[self.next]))
        self.next += 1
        return len(self.server.records) > n

    def batch(self) -> float:
        """Delivers one batch's requests at once; its wall seconds."""
        w0 = time.perf_counter()
        while not self.deliver(0.0):
            pass
        return time.perf_counter() - w0


def _open_loop(srv: Server, rate: float, n: int) -> tuple[list, float]:
    """Delivers ``n`` requests, request i due at ``i / rate`` s after the
    start; returns the latency of each served request (its batch's tokens
    on the host less its due time, in s) and when the last batch's tokens
    were on the host, in s from the start."""
    start = time.perf_counter()
    lat, waiting, done = [], [], 0.0
    for i in range(n):
        due = i / rate
        wait = start + due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        waiting.append(due)
        if srv.deliver(due):
            done = time.perf_counter() - start
            lat += [done - d for d in waiting]
            waiting = []
    return lat, done


def batch_flops(arch, c: dict, tr: dict) -> float:
    """Model flops of one batch: the prefill and each decode step."""
    B, P, D = tr["batch_size"], tr["prompt_len"], tr["decode_tokens"]
    return flops.model_flops(arch, c, B, P, "forward") + sum(
        flops.decode_flops(arch, c, B, P + j) for j in range(D))


def served_gaps(cell, seed, dev, spec, prompts, records, rows, matmul,
                lowp_matmul=None) -> dict:
    """The reference's logits (the cell's architecture's ``logits_at``)
    over each sampled request's prompt and served tokens: the gap of each
    served token below the reference's best (and, with ``lowp_matmul``, of
    the token the control puts first)."""
    import torch

    c, tr, model = cell.config, cell.traffic, cell.model

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = weights.nest(spec, [t.float() for t in
                                     weights.make_all(spec, seed, dev)])
        P, D = tr["prompt_len"], tr["decode_tokens"]
        gaps, ctrl = [], []
        step = tr["reference_batch"]
        for s in range(0, len(rows), step):
            recs = [records[i] for i in rows[s: s + step]]
            served = np.array([r.tokens for r in recs], np.int64)  # (b, D+1)
            seqs = np.concatenate(
                [prompts[[r.request_id for r in recs]], served[:, :D]], 1)
            tok = torch.from_numpy(seqs).to(dev)
            pos = list(range(P - 1, P + D))
            ref = model.logits_at(params, tok, pos, c, matmul)
            best = ref.max(-1).values
            got = ref.gather(-1, torch.from_numpy(served).to(dev)[..., None])
            gaps.append((best - got[..., 0]).cpu())
            if lowp_matmul is not None:
                low = model.logits_at(params, tok, pos, c, lowp_matmul)
                pick = low.argmax(-1, keepdim=True)
                ctrl.append((best - ref.gather(-1, pick)[..., 0]).cpu())
        out = {"served_gap": float(torch.cat(gaps).max())}
        if ctrl:
            out["control_gap"] = float(torch.cat(ctrl).max())
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]


def sample_rows(seed: int, first: int, count: int, k: int) -> list:
    """``k`` record indices drawn from the seed among ``count`` records
    starting at ``first``."""
    rng = np.random.default_rng([int(seed), 2])
    return sorted(first + rng.choice(count, size=min(k, count),
                                     replace=False))


def run(r) -> dict:
    import torch

    tr, dev = r.cell.traffic, r.device
    B = tr["batch_size"]
    if r.trace:
        n_window = B * (tr["trace_timed_batches"]
                        + tr["trace_profiled_batches"])
    else:
        n_window = B * math.ceil(r.seconds * r.cell.cell["rate_per_s"] / B)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if r.fault == "altered_token":
        return _with_altered_tokens(lambda: _serve(r, n_window))
    return _serve(r, n_window)


def _serve(r, n_window) -> dict:
    """Set-up, the window and the check; the server is this frame's alone,
    so that it is freed before the reference runs."""
    import torch
    from harness.cli import TraceData
    from reference.matmul import plain_matmul

    c, tr, dev = r.cell.config, r.cell.traffic, r.device
    B, rate = tr["batch_size"], r.cell.cell["rate_per_s"]
    srv = Server(r, B * tr["warmup_batches"] + n_window)
    for _ in range(tr["warmup_batches"]):
        srv.batch()
    _sync(dev)
    setup_s = time.perf_counter() - r.t0
    first = len(srv.server.records)
    r.log(f"set-up {setup_s:.3f} s; {n_window} requests in the window")
    out = {"trace": None, "e2e": {}}
    if r.trace:
        from harness.trace import profiled
        walls = [srv.batch() for _ in range(tr["trace_timed_batches"])]
        r.log(f"back-to-back batch walls s {walls}")
        before = program.counters()
        k = tr["trace_profiled_batches"]
        win = profiled(lambda: [srv.batch() for _ in range(k)])
        out["trace"] = TraceData(
            window=win, units=k, unit_wall_s=sum(walls) / len(walls),
            model_flops_per_unit=batch_flops(r.cell.model, c, tr),
            shapes=r.cell.model.kernel_shapes(c, B, tr["prompt_len"],
                                              "forward"),
            counters=program.counter_delta(before, program.counters()),
            peaks=None)
    else:
        lat, last = _open_loop(srv, rate, n_window)
        out["e2e"] = {"setup_s": setup_s,
                      "serve_p95_ms": 1e3 * float(np.percentile(lat, 95))}
        r.log(f"window: {len(lat)} requests served; latency s median "
              f"{np.median(lat):.4f}, p95 {np.percentile(lat, 95):.4f}, max "
              f"{max(lat):.4f}; last done at {last:.3f} s of "
              f"{n_window / rate:.3f} s of arrivals")
    records = srv.server.records
    n_served = len(records) - first
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
    prompts, spec = srv.prompts, srv.spec
    del srv
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    rows = sample_rows(r.seed, first, n_served, tr["check_requests"])
    numbers = served_gaps(r.cell, r.seed, dev, spec, prompts, records, rows,
                          plain_matmul)
    r.log(f"reference over {len(rows)} requests in "
          f"{time.perf_counter() - t_ref:.1f} s")
    correct, judged = checks.judge(numbers, r.cell.cell["limits"])
    failed = n_window - n_served
    out.update(correct=correct and failed == 0, checks=judged,
               attempted=n_window, failed=failed, numbers=numbers)
    return out


def _with_altered_tokens(fn):
    """``fn()`` with the fault of a token altered where it is produced:
    the server's greedy pick takes the least likely token."""
    import torch
    from repro_torch.launch import serve as port_serve

    greedy = port_serve._greedy

    def least(logits, vocab_size):
        return torch.argmin(logits[:, :vocab_size], dim=-1).to(torch.int32)
    port_serve._greedy = least
    try:
        return fn()
    finally:
        port_serve._greedy = greedy
