"""Device-cloud serving driver: DeviceFlow replays request traffic against an
LM inference service — the paper's "fluctuating access load" concern (§I
challenge 2, system level).

Two serving modes over the same virtual timeline:

* ``BatchedServer`` — the fixed-batch baseline: drains the arrival queue into
  fixed-size decode batches (a batch fires the moment it fills; ``drain``
  flushes the residual partial batch).  The greedy decode is a loop over
  ``decode_step`` that keeps the tokens on the card (``fused=True``); the
  per-token loop that round-trips each token through the host is kept as a
  correctness reference.
* ``ContinuousServer`` + ``ContinuousBatchingEngine`` (``core.serving``) —
  slot-based continuous batching over a KV-cache arena: requests join at
  iteration boundaries and retire individually, so nobody waits for
  batch-mates.  Token-identical to the fixed-batch reference.

Both modes charge virtual service time from one ``ServeCostModel`` and
produce ``ServingReport`` p50/p99 latency, time-to-first-token, and goodput
against an SLO.  Request tokens are stacked into one ``UpdateBuffer`` on the
serving device and every message carries an ``UpdateHandle`` row whose
``nbytes`` is the prompt's real wire size, so DeviceFlow byte accounting
covers serving traffic exactly like training updates.

Run on the card (the default) or, with ``--device cpu``, on the CPU::

    python -m repro_torch.launch.serve --device cpu
    python -m repro_torch.launch.serve --arch granite_moe_3b_a800m --device cpu

The encoder-decoder family (``seamless_m4t_medium``) has no serving path, as
in the reference: both servers refuse it up front with a ``ValueError``.

``--co-train`` then runs the serve-over-train preemption schedule
(``co_serving_schedule``) with its burst at the middle of the served
horizon::

    python -m repro_torch.launch.serve --co-train --device cpu
"""
from __future__ import annotations

import argparse
import collections
import dataclasses

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.allocation import GradeRuntime
from repro_torch.core.deviceflow import Delivery, DeviceFlow, Message, VirtualClock
from repro_torch.core.scheduler import ResourceManager, ResourcePool, TaskEngine
from repro_torch.core.serving import (
    NO_ENCDEC_SERVING,
    ContinuousBatchingEngine,
    ContinuousServer,
    RequestRecord,
    ServeCostModel,
    ServingReport,
)
from repro_torch.core.strategies import TimeIntervalStrategy
from repro_torch.core.task import GradeSpec, OperatorFlow, Task
from repro_torch.core.traffic_curves import diurnal, right_tailed_normal
from repro_torch.core.updates import UpdateBuffer, UpdateHandle
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.runtime import tracing


def stack_requests(token_rows: np.ndarray, *, device="cuda") -> UpdateBuffer:
    """Stack request prompts ``(n, prompt_len)`` into one token buffer on
    ``device``; ``buf.handle(i)`` is request ``i``'s message payload."""
    dev = resolve_device(device)
    return UpdateBuffer.from_stacked({"tokens": torch.as_tensor(
        np.asarray(token_rows, np.int32), device=dev)})


@dataclasses.dataclass
class ServeMetrics:
    t: float
    queue_depth: int
    batch_size: int
    tokens_decoded: int


def _greedy(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    return torch.argmax(logits[:, :vocab_size], dim=-1).to(torch.int32)


class BatchedServer:
    """Greedy-decodes fixed-size batches from an arrival queue (baseline).

    The queue is a ``deque`` and ``drain`` flushes the residual partial
    batch, so off-peak traffic never strands ``len(queue) < batch_size``
    requests.  Per-request latency is accounted on the virtual timeline via
    ``cost_model`` (service starts at ``max(arrival of batch-completing
    request, busy_until)``), making the baseline directly comparable to the
    continuous engine.  ``params`` (default: initialized from ``seed``)
    lets both servers share one model.

    Under a profiler a batch is one ``serve.batch`` span carrying its
    request ids (``runtime/tracing.py``), over ``serve.gather``,
    ``serve.prefill`` (the prefill and its greedy pick), one
    ``serve.decode`` per token and ``serve.readback`` (the tokens' copies
    to the host); the records' accounting is the batch's own time.
    """

    def __init__(self, cfg, *, batch_size: int, prompt_len: int,
                 decode_tokens: int, max_len: int, seed: int = 0,
                 cost_model: "ServeCostModel | None" = None,
                 fused: bool = True, params=None, device="cuda"):
        if cfg.family == "audio":
            raise ValueError(NO_ENCDEC_SERVING.format(cfg.name))
        self.cfg = cfg
        self.api = get_model(cfg)
        self.device = resolve_device(device)
        self.params = (params if params is not None
                       else self.api.init(seed, cfg, device=self.device))
        self.batch_size = batch_size
        self.prompt_len = prompt_len
        self.decode_tokens = decode_tokens
        self.max_len = max_len
        self.fused = fused
        self.cost = cost_model or ServeCostModel()
        self.queue: collections.deque[tuple[Message, float]] = (
            collections.deque())
        self.metrics: list[ServeMetrics] = []
        self.records: list[RequestRecord] = []
        self.busy_until = 0.0

    # DeviceFlow delivery callback: a request message arrives.
    def __call__(self, d: Delivery) -> None:
        self.queue.append((d.message, d.t))
        while len(self.queue) >= self.batch_size:
            self._serve_batch(d.t)

    def _gather_prompts(self, batch: list) -> torch.Tensor:
        """(batch, prompt_len) int32 prompt tokens from message payloads.

        Same-buffer handle payloads take the device gather fast path (no
        host round-trip); anything else stacks on the host.
        """
        if (all(isinstance(m.payload, UpdateHandle) for m in batch)
                and len({id(m.payload.buffer) for m in batch}) == 1):
            leaf = batch[0].payload.buffer.leaves2d[0]  # (rows, prompt_len)
            rows = torch.as_tensor([m.payload.row for m in batch],
                                   device=leaf.device)
            return leaf.index_select(0, rows)[:, : self.prompt_len].to(
                self.device)
        tokens = [(m.payload.materialize()["tokens"]
                   if isinstance(m.payload, UpdateHandle) else
                   m.payload["tokens"]) for m in batch]
        return torch.stack([torch.as_tensor(np.asarray(tk)[: self.prompt_len],
                                            dtype=torch.int32)
                            for tk in tokens]).to(self.device)

    def _decode_fused(self, tok, cache) -> torch.Tensor:
        """Greedy decode with the tokens kept on the card: one
        ``decode_step`` per token, no host sync until the caller reads."""
        out = []
        for j in range(self.decode_tokens):
            with tracing.span("serve.decode", j=j):
                logits, cache = self.api.decode_step(self.params, tok,
                                                     self.cfg, cache)
                tok = _greedy(logits, self.cfg.vocab_size)
            out.append(tok)
        return torch.stack(out)  # (decode_tokens, batch)

    def _decode_tokens_loop(self, tok, cache) -> torch.Tensor:
        """Reference path: each greedy token goes through the host before
        it is fed back (kept for correctness tests against the fused
        loop)."""
        out = []
        for j in range(self.decode_tokens):
            with tracing.span("serve.decode", j=j):
                logits, cache = self.api.decode_step(self.params, tok,
                                                     self.cfg, cache)
                host = _greedy(logits, self.cfg.vocab_size).cpu().numpy()
                tok = torch.from_numpy(host).to(self.device)
            out.append(tok)
        return torch.stack(out)

    def _serve_batch(self, t: float, size: "int | None" = None) -> None:
        size = self.batch_size if size is None else size
        batch = [self.queue.popleft() for _ in range(size)]
        with tracing.span("serve.batch", unit=True, size=size,
                          requests=[m.device_id for m, _ in batch]):
            with tracing.span("serve.gather"):
                prompts = self._gather_prompts([m for m, _ in batch])
            with tracing.span("serve.prefill"):
                logits, cache = self.api.prefill(self.params, prompts,
                                                 self.cfg, self.max_len)
                first = _greedy(logits, self.cfg.vocab_size)
            if self.fused:
                toks = self._decode_fused(first, cache)
            else:
                toks = self._decode_tokens_loop(first, cache)
            with tracing.span("serve.readback"):
                first_host = first.cpu().numpy()
                toks_host = toks.cpu().numpy()  # (decode_tokens, size)
            # Virtual-time accounting: the whole batch is serialized behind
            # any in-flight batch and finishes together — the structural
            # latency penalty continuous batching removes.
            start = max(t, self.busy_until)
            first_token_t = start + self.cost.prefill_s(size)
            finish = (first_token_t
                      + self.decode_tokens * self.cost.decode_s(size))
            self.busy_until = finish
            for i, (m, arrival_t) in enumerate(batch):
                rec = RequestRecord(request_id=m.device_id,
                                    arrival_t=arrival_t)
                rec.start_t = start
                rec.first_token_t = first_token_t
                rec.finish_t = finish
                rec.decoded = self.decode_tokens
                rec.tokens = [int(first_host[i])] + [int(x)
                                                     for x in toks_host[:, i]]
                self.records.append(rec)
            self.metrics.append(ServeMetrics(
                t=t, queue_depth=len(self.queue),
                batch_size=size, tokens_decoded=self.decode_tokens * size,
            ))

    def drain(self, t: float) -> None:
        """Serve everything still queued: full batches first, then the
        residual partial batch."""
        while len(self.queue) >= self.batch_size:
            self._serve_batch(t)
        if self.queue:
            self._serve_batch(t, size=len(self.queue))

    def report(self, *, horizon_s: "float | None" = None) -> ServingReport:
        if horizon_s is None:
            horizon_s = max((r.finish_t for r in self.records
                             if r.finish_t is not None), default=0.0)
        return ServingReport(records=list(self.records), horizon_s=horizon_s)


# --------------------------------------------------------------------------- #
# Traffic + reporting helpers
# --------------------------------------------------------------------------- #
def _server_device(server) -> torch.device:
    engine = getattr(server, "engine", None)
    dev = server.device if engine is None else engine.device
    return torch.device("cpu") if dev is None else dev


def run_trace(server, *, requests: int, prompt_len: int, vocab_size: int,
              curve, interval: float, seed: int = 0, clock=None):
    """Replay ``requests`` prompts through DeviceFlow on ``curve`` into
    ``server`` (either serving mode); returns the flow (clock drained).
    The prompt buffer lives on the server's device."""
    flow = DeviceFlow(server, clock=clock, seed=seed)
    flow.register_task(0, TimeIntervalStrategy(curve=curve, interval=interval))
    rng = np.random.default_rng(seed)
    buf = stack_requests(rng.integers(1, vocab_size,
                                      size=(requests, prompt_len)),
                         device=_server_device(server))
    for i in range(requests):
        flow.submit(Message(
            task_id=0, device_id=i, round_idx=0, payload=buf.handle(i)))
    flow.round_complete(0)
    flow.run()
    if isinstance(server, BatchedServer):
        server.drain(flow.clock.now)
    return flow


def co_serving_schedule(*, peak_t: float, train_rounds: int = 8,
                        train_round_s: float = 120.0,
                        serve_rounds: int = 3, serve_round_s: float = 30.0,
                        serve_priority: int = 5,
                        cost_model_gate: bool = True):
    """Serve-over-train preemption at the diurnal peak (SimDC co-serving).

    Background training (priority 0) holds the whole pool; a high-priority
    serving-burst task arrives at ``peak_t`` and — when the admission cost
    model judges the priority-weighted benefit to exceed the victim's
    re-timed lost work — preempts training at its next round boundary.
    Returns the drained ``TaskEngine`` for inspection.
    """
    rm = ResourceManager(ResourcePool({"High": 8}, {"High": 2}))
    flow = OperatorFlow(("serve",))

    def runtimes(task):
        per_round = serve_round_s if task.priority >= serve_priority \
            else train_round_s
        return [GradeRuntime(alpha=per_round, beta=per_round, lam=0.0)
                for _ in task.grades]

    eng = TaskEngine(rm, runtimes, preemptive=True,
                     preemption_cost_model=cost_model_gate)
    train = Task(flow, (GradeSpec("High", 10, logical_bundles=8,
                                  physical_devices=2),),
                 rounds=train_rounds, priority=0)
    burst = Task(flow, (GradeSpec("High", 10, logical_bundles=8,
                                  physical_devices=2),),
                 rounds=serve_rounds, priority=serve_priority)
    eng.submit(train)
    eng.submit(burst, at=peak_t)
    eng.drain()
    return eng


def print_report(name: str, rep: ServingReport, slo_s: float) -> None:
    s = rep.summary(slo_s)
    print(f"  {name:12s} p50={s['p50_latency_s'] * 1e3:8.1f}ms "
          f"p99={s['p99_latency_s'] * 1e3:8.1f}ms "
          f"ttft_p99={s['p99_ttft_s'] * 1e3:8.1f}ms "
          f"goodput={s['goodput_rps']:6.2f} req/s "
          f"(SLO {slo_s * 1e3:.0f}ms attained {s['slo_attainment'] * 100:.1f}%)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_3b")
    ap.add_argument("--mode", choices=("fixed", "continuous", "both"),
                    default="both")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=4,
                    help="fixed-batch size AND continuous slot count")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-tokens", type=int, default=8)
    ap.add_argument("--curve", choices=("diurnal", "right_normal"),
                    default="diurnal")
    ap.add_argument("--sigma", type=float, default=1.0,
                    help="sigma for --curve right_normal")
    ap.add_argument("--interval", type=float, default=60.0)
    ap.add_argument("--slo", type=float, default=30.0,
                    help="request latency SLO in virtual seconds")
    ap.add_argument("--represented-users", type=float, default=2e6,
                    help="real users each simulated request stands for "
                         "(reporting only)")
    ap.add_argument("--co-train", action="store_true",
                    help="run the serve-over-train preemption schedule at "
                         "the curve peak")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda, or cpu)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    device = resolve_device(args.device)
    max_len = args.prompt_len + args.decode_tokens + 1
    curve = (diurnal() if args.curve == "diurnal"
             else right_tailed_normal(args.sigma))
    cost = ServeCostModel()

    reports: dict[str, ServingReport] = {}
    horizon = 0.0
    if args.mode in ("fixed", "both"):
        server = BatchedServer(
            cfg, batch_size=args.batch_size, prompt_len=args.prompt_len,
            decode_tokens=args.decode_tokens, max_len=max_len,
            seed=args.seed, cost_model=cost, device=device)
        flow = run_trace(server, requests=args.requests,
                         prompt_len=args.prompt_len,
                         vocab_size=cfg.vocab_size, curve=curve,
                         interval=args.interval, seed=args.seed)
        reports["fixed"] = server.report()
        horizon = max(horizon, reports["fixed"].horizon_s)
        shelf = flow.shelf(0)
        print(f"fixed-batch: {len(server.metrics)} batches, "
              f"{sum(m.tokens_decoded for m in server.metrics)} tokens; "
              f"request traffic {shelf.total_bytes_dispatched / 1024:.1f} KiB")
    if args.mode in ("continuous", "both"):
        engine = ContinuousBatchingEngine(
            cfg, slots=args.batch_size, prompt_len=args.prompt_len,
            decode_tokens=args.decode_tokens, max_len=max_len,
            seed=args.seed, cost_model=cost, device=device)
        clock = VirtualClock()
        server = ContinuousServer(engine, clock)
        run_trace(server, requests=args.requests,
                  prompt_len=args.prompt_len, vocab_size=cfg.vocab_size,
                  curve=curve, interval=args.interval, seed=args.seed,
                  clock=clock)
        reports["continuous"] = engine.report()
        horizon = max(horizon, reports["continuous"].horizon_s)
        occ = max((it.n_active for it in engine.iterations), default=0)
        print(f"continuous: {len(engine.iterations)} iterations, "
              f"peak slot occupancy {occ}/{engine.slots}")

    scale = args.represented_users / max(args.requests, 1)
    print(f"\nserving report ({args.requests} requests standing for "
          f"{args.represented_users:.0f} users, x{scale:.0f} traffic scale):")
    for name, rep in reports.items():
        rep.horizon_s = horizon or rep.horizon_s
        print_report(name, rep, args.slo)
    if len(reports) == 2:
        f, c = reports["fixed"], reports["continuous"]
        if c.p99_latency_s > 0:
            print(f"  p99 latency cut: {f.p99_latency_s / c.p99_latency_s:.2f}x")
    if args.co_train:
        peak_t = horizon * 0.5 if horizon else 300.0
        eng = co_serving_schedule(peak_t=peak_t)
        train_ex = next(ex for ex in eng.completed if ex.task.priority == 0)
        burst_ex = next(ex for ex in eng.completed if ex.task.priority > 0)
        print(f"\nco-training: serving burst at t={peak_t:.1f}s "
              f"queued {burst_ex.queueing_delay_s:.1f}s; training preempted "
              f"{train_ex.preemptions}x, decisions "
              f"{train_ex.preemption_decisions}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
