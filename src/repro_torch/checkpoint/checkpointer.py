"""Sharded, atomic, async-capable checkpointing with restart protocol.

Production layout: one directory per step; each host writes its local shards
(``shard-<host>.npz``); a ``manifest.json`` committed by atomic rename is the
durability barrier (a step without a manifest is garbage-collected on
restart).  Here host-count is 1 (a sharded state is gathered and rank 0
writes it; every rank restores its own blocks), but the layout, commit
protocol and restore path are the multi-host ones.

The format is the JAX package's, so each package reads the other's
checkpoints: leaves are named by their path in the tree — dict keys in
sorted order, list and tuple indices as numbers, joined by ``/`` — and
stored as numpy arrays.  Tensors go through numpy; numpy has no bf16, so a
bf16 tensor is stored widened to f32 (exact) and cast back to the
``like`` leaf's dtype on restore.

Federated-platform integration: the DeviceFlow shelf state and data-pipeline
RNG state ride in the manifest's ``extra`` field.  Live runtime objects
(``TaskEngine.state_dict(deviceflow=...)`` snapshots, with shelved
``Message``s and columnar ``ArrivalBatch`` segments) ride in the step
directory's ``runtime.pkl`` instead (``save(..., runtime_state=...)`` /
``restore_runtime_state``), with every device reference — handle payloads,
batch update buffers, tensors — brought to the host first, so the pickle
never holds card memory.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import pickle
import shutil
import tempfile
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.updates import (
    UpdateBuffer,
    UpdateHandle,
    materialize_handles,
)


def _jsonify(obj: Any) -> Any:
    """JSON-safe view of manifest ``extra`` state: numpy scalars and arrays
    become Python values and lists; anything else that JSON cannot carry
    fails *here*, named, before a checkpoint directory is built."""
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(
        f"manifest extra contains a non-JSON-serializable "
        f"{type(obj).__name__}; encode it in the state_dict (live objects "
        f"— Tasks, device buffers — are re-supplied on restore, not saved)")


def _host_runtime_view(obj: Any) -> Any:
    """``obj`` with every device reference replaced by host data, so
    ``runtime.pkl`` pickles cleanly and holds no card memory: shelved
    ``Message``s with handle payloads, bare handles and buffers, and
    tensors (copied to the CPU)."""
    from repro_torch.core.deviceflow import Message  # late: avoid a cycle
    if isinstance(obj, dict):
        return {k: _host_runtime_view(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_runtime_view(v) for v in obj)
    if isinstance(obj, Message):
        if isinstance(obj.payload, (UpdateHandle, UpdateBuffer)):
            return dataclasses.replace(obj, payload=obj.payload.materialize())
        return obj
    if isinstance(obj, (UpdateHandle, UpdateBuffer)):
        return obj.materialize()
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    return obj


def _with_paths(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs in JAX's flattening order: dict keys sorted,
    list and tuple entries by index; ``None`` is an empty subtree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _with_paths(v, prefix + (i,))]
    return [] if tree is None else [(prefix, tree)]


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bf16: widen (exact)
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> list[tuple[str, np.ndarray]]:
    return [(_key(path), _to_numpy(leaf)) for path, leaf in _with_paths(tree)]


def _like(arr: np.ndarray, leaf: Any) -> Any:
    """The stored array as ``leaf``'s kind: a tensor of its dtype on its
    device, or a numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        if arr.dtype.itemsize == 2 and arr.dtype.kind == "V" or \
                arr.dtype.name == "bfloat16":
            # The reference stores bf16 as its raw 16 bits (numpy has no
            # bf16: a void or an ml_dtypes array): the same bits as torch's.
            t = torch.from_numpy(np.array(arr).view(np.uint16)).view(
                torch.bfloat16)
            return t.to(device=leaf.device, dtype=leaf.dtype)
        return torch.from_numpy(np.array(arr)).to(  # a copy; keeps 0-d
            device=leaf.device, dtype=leaf.dtype)
    if hasattr(leaf, "dtype") and arr.dtype != leaf.dtype:
        return arr.astype(leaf.dtype)
    return arr


def _gather_sharded(tree: Any) -> "tuple[Any, bool]":
    """``tree`` with each ``DTensor`` leaf gathered to its full tensor (a
    collective: every rank saves), and whether this rank writes (rank 0 of
    the process group when any leaf was sharded)."""
    from torch.distributed.tensor import DTensor

    sharded = False

    def full(t):
        nonlocal sharded
        if isinstance(t, DTensor):
            sharded = True
            return t.full_tensor()
        return t

    out = _rebuild(tree, [full(leaf) for _, leaf in _with_paths(tree)])
    if not sharded:
        return tree, True
    import torch.distributed as dist
    return out, dist.get_rank() == 0


def _placed(full: torch.Tensor, like: Any, sharding: Any) -> Any:
    """A restored full tensor placed as ``sharding`` (a
    ``distribution.sharding.Sharding``) says, else as the ``like`` leaf's
    DTensor placements; a plain ``like`` leaf keeps it whole."""
    if sharding is not None and isinstance(full, torch.Tensor):
        return sharding.distribute(full)
    from torch.distributed.tensor import DTensor
    if not isinstance(like, DTensor):
        return full
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    shape, offset = compute_local_shape_and_global_offset(
        full.shape, like.device_mesh, like.placements)
    local = full
    for d, (n, o) in enumerate(zip(shape, offset)):
        local = local.narrow(d, o, n)
    return DTensor.from_local(local.contiguous(), like.device_mesh,
                              like.placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def _rebuild(tree: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    return build(tree)


class Checkpointer:
    def __init__(self, directory: "str | os.PathLike", *, keep: int = 3,
                 host_id: int = 0, num_hosts: int = 1):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._async_thread: "threading.Thread | None" = None
        self._async_err: list[BaseException] = []

    # ------------------------------------------------------------------ #
    def _step_dir(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:010d}"

    def save(self, step: int, tree: Any, *, extra: "dict | None" = None,
             runtime_state: Any = None) -> None:
        """Synchronous save with atomic manifest commit.

        ``UpdateHandle``/``UpdateBuffer`` payloads anywhere in ``tree`` are
        materialized to host dicts here — saved state never holds live card
        references.  ``runtime_state`` (optional) is an engine snapshot
        pickled to ``runtime.pkl`` after its device references are brought
        to the host; the manifest records its top-level sections
        (``runtime_sections``).  Restore it with
        :meth:`restore_runtime_state`.
        """
        tree, writes = _gather_sharded(tree)
        if not writes:
            return
        leaves = _flatten(materialize_handles(tree))
        tmp = pathlib.Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_"))
        try:
            np.savez(tmp / f"shard-{self.host_id}.npz",
                     **{k: v for k, v in leaves})
            if runtime_state is not None:
                with open(tmp / "runtime.pkl", "wb") as f:
                    pickle.dump(_host_runtime_view(runtime_state), f,
                                protocol=pickle.HIGHEST_PROTOCOL)
            manifest = {
                "step": step,
                "num_hosts": self.num_hosts,
                "keys": [k for k, _ in leaves],
                "time": time.time(),
                "extra": _jsonify(extra or {}),
                "has_runtime_state": runtime_state is not None,
                "runtime_sections": (sorted(map(str, runtime_state))
                                     if isinstance(runtime_state, dict)
                                     else []),
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            target = self._step_dir(step)
            if target.exists():
                shutil.rmtree(target)
            os.replace(tmp, target)  # atomic commit
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def save_async(self, step: int, tree: Any, *,
                   extra: "dict | None" = None,
                   runtime_state: Any = None) -> None:
        """Overlap checkpoint I/O with the next steps.

        The card-to-host copy happens here, synchronously (a consistent
        snapshot); serialization runs on a worker thread.  A failure is
        raised by the next :meth:`wait`.
        """
        self.wait()
        tree, writes = _gather_sharded(tree)
        if not writes:
            return
        host_tree = _host_runtime_view(materialize_handles(tree))
        host_runtime = (None if runtime_state is None
                        else _host_runtime_view(runtime_state))

        def work():
            try:
                self.save(step, host_tree, extra=extra,
                          runtime_state=host_runtime)
            except BaseException as e:  # surfaced on next wait()
                self._async_err.append(e)

        self._async_thread = threading.Thread(target=work, daemon=True)
        self._async_thread.start()

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        if self._async_err:
            raise self._async_err.pop()

    # ------------------------------------------------------------------ #
    def latest_step(self) -> "int | None":
        steps = []
        for d in self.dir.glob("step_*"):
            if (d / "manifest.json").exists():
                steps.append(int(d.name.split("_")[1]))
            else:  # uncommitted garbage from a crashed save
                shutil.rmtree(d, ignore_errors=True)
        return max(steps) if steps else None

    def restore(self, like: Any, step: "int | None" = None, *,
                shardings: Any = None) -> tuple[Any, dict]:
        """Restore into the structure of ``like``: each tensor leaf comes
        back as a tensor of its dtype on its device, each numpy leaf as an
        array of its dtype.  Returns ``(tree, extra)``.

        ``shardings`` (a matching tree of ``distribution.sharding.Sharding``,
        e.g. ``train_state_shardings``) places each restored leaf on its
        mesh as a ``DTensor``; without it a ``DTensor`` leaf of ``like``
        comes back with that leaf's placements.  Every rank reads the whole
        checkpoint and keeps its blocks.  (Sharded saves gather each
        ``DTensor`` to its full tensor and rank 0 writes.)"""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        shs = ([sh for _, sh in _with_paths(shardings)]
               if shardings is not None else None)
        with np.load(d / f"shard-{self.host_id}.npz") as data:
            out = [_placed(_like(data[_key(path)], leaf), leaf,
                           None if shs is None else shs[i])
                   for i, (path, leaf) in enumerate(_with_paths(like))]
        return _rebuild(like, out), manifest.get("extra", {})

    def restore_runtime_state(self, step: "int | None" = None) -> Any:
        """The ``runtime.pkl`` snapshot saved with ``step`` (the latest
        step when ``None``), or ``None`` if that save carried none."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self._step_dir(step) / "runtime.pkl"
        if not path.exists():
            return None
        with open(path, "rb") as f:
            return pickle.load(f)

    def _gc(self) -> None:
        steps = sorted(
            int(d.name.split("_")[1]) for d in self.dir.glob("step_*")
            if (d / "manifest.json").exists()
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
