"""The paper's own experiment (§VI): federated LR-on-CTR with DeviceFlow
traffic curves, aggregation triggers and dropout — at up to 100k devices.

Every device trains locally (one ``torch.func.vmap`` over the fleet), sends
its update as a host-dict message through DeviceFlow on a right-tailed
normal traffic curve, and the cloud aggregates whenever half the fleet's
samples have arrived.

Run on the card (the default) or on the CPU::

    python -m repro_torch.examples.federated_ctr [--devices 2000] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core import (
    AggregationService,
    DeviceFlow,
    Message,
    SampleThresholdTrigger,
    TimeIntervalStrategy,
)
from repro_torch.core.simulation import device_seeds
from repro_torch.core.traffic_curves import right_tailed_normal
from repro_torch.data.synthetic_ctr import make_federated_ctr
from repro_torch.device import resolve_device
from repro_torch.models import ctr

DIM, RECORDS = 64, 16


def run(*, devices: int = 2000, rounds: int = 4, sigma: float = 1.0,
        dropout: float = 0.0, device="cuda") -> list[dict]:
    """Runs the experiment, prints one line per round and returns the
    rounds' values."""
    dev = resolve_device(device)
    data = make_federated_ctr(num_devices=devices,
                              records_per_device=RECORDS, dim=DIM, seed=0,
                              noniid_alpha=0.5)
    test = make_federated_ctr(num_devices=200, dim=DIM, seed=1)
    local = vmap(ctr.make_local_train_fn(lr=1e-3, epochs=10))

    svc = AggregationService(
        ctr.lr_init(DIM, device=dev),
        trigger=SampleThresholdTrigger(devices * RECORDS // 2))
    flow = DeviceFlow(svc, seed=0)
    flow.register_task(0, TimeIntervalStrategy(
        curve=right_tailed_normal(sigma), interval=1200.0,
        failure_prob=dropout))

    X, Y, counts = data.stacked_shards(np.arange(devices), RECORDS)
    mask = (np.arange(RECORDS)[None] < counts[:, None]).astype(np.float32)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in (("x", X), ("y", Y), ("mask", mask))}
    test_x = torch.as_tensor(test.features, device=dev)
    test_y = torch.as_tensor(test.labels, device=dev)

    out = []
    for rnd in range(rounds):
        stacked = {k: p.expand((devices,) + p.shape)
                   for k, p in svc.global_params.items()}
        seeds = device_seeds(torch.Generator().manual_seed(rnd), devices)
        new_params, _ = local(stacked, batch, seeds.to(dev))
        host = {k: v.cpu() for k, v in new_params.items()}
        for c in range(devices):
            flow.submit(Message(0, c, rnd, {k: v[c] for k, v in host.items()},
                                num_samples=int(counts[c])))
        flow.round_complete(0)
        flow.run(flow.clock.now + 1200.0)
        acc = float(ctr.accuracy(svc.global_params, test_x, test_y))
        row = {"round": rnd, "virtual_t": flow.clock.now,
               "aggregations": len(svc.history),
               "dropped": flow.shelf(0).total_dropped, "test_acc": acc}
        out.append(row)
        print(f"round {rnd}: virtual_t={row['virtual_t']:8.1f}s "
              f"aggregations={row['aggregations']} "
              f"dropped={row['dropped']} test_acc={acc:.4f}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda, or cpu)")
    args = ap.parse_args(argv)
    run(devices=args.devices, rounds=args.rounds, sigma=args.sigma,
        dropout=args.dropout, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
