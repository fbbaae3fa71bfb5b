"""Device-resident update buffers and handle payloads (zero-copy round path).

The batched round engine produces one *stacked* model update per cohort
chunk: a ``dict[str, Tensor]`` whose leaves are shaped ``(rows, ...)``.
Instead of copying that stack to the host and building one dict per device,
the zero-copy path wraps each chunk's output in an :class:`UpdateBuffer`
that *stays on the card*, and hands each message an :class:`UpdateHandle` —
a (buffer, row) reference that weighs a few dozen bytes on the wire between
the simulation tiers and the cloud service.  Aggregation never
materializes: ``federation.fused_fedavg_delta`` groups the pending handles
by buffer and runs one ``fed_reduce`` weighted row-reduction per leaf per
buffer (the hand-written CUDA kernel on the card) directly over the device
tensors.

**Layout.**  Buffer leaves are ``(rows, size)`` 2-D matrices in *sorted
key order* (``keys``): that is JAX's flatten order for a dict, so the
reference package and the port list leaves, scales and error-feedback
residuals in the same order (``b`` before ``w`` for the CTR model).  The
per-leaf trailing shapes and numpy dtypes ride alongside for
materialization and alignment checks.

Handles materialize to host dicts (CPU tensors) only where the platform
genuinely needs host data: the q_i benchmarking devices, and payload
transforms that are host-side by nature.

**Quantized wire mode** (``wire="int8"``).  A buffer built with
``wire="int8"`` stores each leaf as an int8 ``(rows, size)`` matrix plus one
f32 ``(rows,)`` *scale column* (symmetric per-row, per-leaf scaling —
``scale = max|row| / 127``), produced right after the cohort's local
training by :func:`quantize_rows`.  ``row_nbytes`` reports the true
quantized footprint (1 byte per element + 4 scale bytes per leaf per row),
so ``Shelf.total_bytes_*`` and the ``ArrivalBatch`` nbytes columns show the
real ~4x wire cut.  Aggregation never dequantizes to a dense f32 stack:
``kernels.fed_reduce.fed_reduce(stack, weights, scales=...)`` folds the
per-row scales into the weight vector and reads the int8 rows directly.
Materialization dequantizes on the way out.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.analysis.sanitizers import exempt
from repro_torch.device import resolve_device

Params = dict  # dict[str, Tensor]

_NP_DTYPES = {
    torch.float64: np.dtype(np.float64),
    torch.float32: np.dtype(np.float32),
    torch.float16: np.dtype(np.float16),
    torch.int64: np.dtype(np.int64),
    torch.int32: np.dtype(np.int32),
    torch.int16: np.dtype(np.int16),
    torch.int8: np.dtype(np.int8),
    torch.uint8: np.dtype(np.uint8),
    torch.bool: np.dtype(np.bool_),
}
_TORCH_DTYPES = {v: k for k, v in _NP_DTYPES.items()}


def np_dtype(dtype: "torch.dtype | np.dtype | str") -> np.dtype:
    """The numpy dtype matching a torch dtype (numpy dtypes pass through).
    ``bfloat16`` has no numpy counterpart and raises."""
    if isinstance(dtype, torch.dtype):
        try:
            return _NP_DTYPES[dtype]
        except KeyError:
            raise ValueError(
                f"{dtype} has no numpy dtype; buffers record update leaves "
                "in a numpy-representable dtype (cast back before stacking)"
            ) from None
    return np.dtype(dtype)


def torch_dtype(dtype: "np.dtype | str") -> torch.dtype:
    return _TORCH_DTYPES[np.dtype(dtype)]


def flatten_rows(stacked: Params) -> list[torch.Tensor]:
    """Per-leaf ``(rows, ...) -> (rows, size)`` views, in sorted key order."""
    return [stacked[k].reshape(stacked[k].shape[0], -1)
            for k in sorted(stacked)]


def quantize_rows(
    leaves2d: Sequence[torch.Tensor], *, compute_residual: bool = False
) -> tuple[list[torch.Tensor], list[torch.Tensor], list[torch.Tensor] | None]:
    """Symmetric per-row int8 quantization of ``(rows, size)`` leaves.

    Returns ``(q_leaves, scale_columns, residuals)``: int8 ``(rows, size)``
    matrices, f32 ``(rows,)`` scale columns (``max|row| / 127``, floored so
    all-zero rows quantize to zeros instead of NaN), and — when
    ``compute_residual`` — the f32 quantization error ``x - q*scale`` per
    leaf, the error-feedback memory carried into the next round's update.
    The formula is the reference's, op for op, so ``q`` and the scales
    match it bit for bit on the same f32 input.
    """
    qs: list[torch.Tensor] = []
    scales: list[torch.Tensor] = []
    residuals: list[torch.Tensor] | None = [] if compute_residual else None
    for leaf in leaves2d:
        x = leaf.to(torch.float32)
        s = torch.clamp_min(x.abs().amax(dim=1), 1e-12) / 127.0
        q = torch.clamp(torch.round(x / s[:, None]), -127, 127).to(torch.int8)
        qs.append(q)
        scales.append(s)
        if compute_residual:
            residuals.append(x - q.to(torch.float32) * s[:, None])
    return qs, scales, residuals


def dequantize_rows(q_leaves: Sequence[torch.Tensor],
                    scales: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Inverse of :func:`quantize_rows`: f32 ``(rows, size)`` leaves."""
    return [q.to(torch.float32) * s[:, None]
            for q, s in zip(q_leaves, scales)]


def stacked_spec(stacked: Params
                 ) -> tuple[tuple[str, ...], list[tuple], list[np.dtype]]:
    """(sorted keys, per-leaf trailing shapes, per-leaf numpy dtypes) of a
    stacked params dict."""
    keys = tuple(sorted(stacked))
    shapes = [tuple(stacked[k].shape[1:]) for k in keys]
    dtypes = [np_dtype(stacked[k].dtype) for k in keys]
    return keys, shapes, dtypes


class UpdateBuffer:
    """One cohort chunk's stacked model update, resident on the card.

    ``leaves2d`` are the update's leaves as ``(rows, size)`` tensors (one
    row per simulated device) in the order of ``keys`` (sorted);
    ``shapes``/``dtypes`` describe the dict each row materializes to.  The
    buffer never copies device data — it just records the layout so
    handles can report real payload sizes, aggregation can check alignment
    against the global params, and single rows can materialize on demand.

    ``wire="int8"`` marks a *quantized* buffer: ``leaves2d`` are int8 and
    ``scales`` carries one f32 ``(rows,)`` scale column per leaf.
    ``shapes``/``dtypes`` still describe what rows *materialize* to
    (dequantized), while ``row_nbytes`` reports the quantized footprint.
    """

    __slots__ = ("leaves2d", "keys", "shapes", "dtypes", "num_rows",
                 "row_nbytes", "wire", "scales", "__weakref__")

    def __init__(self, leaves2d: Sequence[torch.Tensor],
                 keys: Sequence[str],
                 shapes: Sequence[tuple], dtypes: Sequence[Any], *,
                 wire: str = "f32",
                 scales: "Sequence[torch.Tensor] | None" = None):
        leaves2d = list(leaves2d)
        if not leaves2d:
            raise ValueError("UpdateBuffer needs at least one leaf")
        n = int(leaves2d[0].shape[0])
        if n < 1:
            raise ValueError("UpdateBuffer needs at least one row")
        self.keys = tuple(keys)
        if list(self.keys) != sorted(self.keys):
            raise ValueError(f"buffer keys must be sorted, got {self.keys}")
        self.shapes = [tuple(s) for s in shapes]
        self.dtypes = [np_dtype(d) for d in dtypes]
        for leaf, shape in zip(leaves2d, self.shapes):
            if leaf.ndim != 2 or int(leaf.shape[0]) != n:
                raise ValueError(
                    f"buffer leaves must be (rows, size), got {leaf.shape}")
            if int(leaf.shape[1]) != math.prod(shape):
                raise ValueError(
                    f"leaf carries {leaf.shape[1]} elements but the spec "
                    f"shape {shape} needs {math.prod(shape)}")
        if not (len(leaves2d) == len(self.shapes) == len(self.dtypes)
                == len(self.keys)):
            raise ValueError("leaves/keys/shapes/dtypes must align")
        if wire == "f32":
            if scales is not None:
                raise ValueError("scales only apply to wire='int8' buffers")
            self.scales = None
            row_nbytes = sum(math.prod(s) * d.itemsize
                             for s, d in zip(self.shapes, self.dtypes))
        elif wire == "int8":
            if scales is None or len(list(scales)) != len(leaves2d):
                raise ValueError(
                    "wire='int8' needs one (rows,) scale column per leaf")
            scales = list(scales)
            for leaf, s in zip(leaves2d, scales):
                if leaf.dtype != torch.int8:
                    raise ValueError(
                        f"wire='int8' leaves must be int8, got {leaf.dtype}")
                if tuple(s.shape) != (n,):
                    raise ValueError(
                        f"scale column must be ({n},), got {tuple(s.shape)}")
            self.scales = scales
            # True quantized footprint: 1 byte/element + one f32 scale per
            # leaf per row — the bytes this row actually puts on the wire.
            row_nbytes = sum(math.prod(s) * 1 + sc.element_size()
                             for s, sc in zip(self.shapes, scales))
        else:
            raise ValueError(f"unknown wire format {wire!r}")
        self.wire = wire
        self.leaves2d = leaves2d
        self.num_rows = n
        self.row_nbytes = int(row_nbytes)

    @classmethod
    def from_stacked(cls, stacked: Params) -> "UpdateBuffer":
        """Build from a stacked params dict (leaves ``(rows, ...)``)."""
        if not stacked:
            raise ValueError("UpdateBuffer needs at least one leaf")
        leaves = [stacked[k] for k in sorted(stacked)]
        n = int(leaves[0].shape[0]) if leaves[0].ndim else -1
        if any(leaf.ndim < 1 or int(leaf.shape[0]) != n for leaf in leaves):
            raise ValueError(
                "every stacked leaf must share the leading (row) dimension")
        return cls(flatten_rows(stacked), *stacked_spec(stacked))

    @classmethod
    def quantized_from_stacked(cls, stacked: Params) -> "UpdateBuffer":
        """Eagerly quantized ``wire="int8"`` buffer from a stacked dict."""
        ref = cls.from_stacked(stacked)
        q, s, _ = quantize_rows(ref.leaves2d)
        return cls(q, ref.keys, ref.shapes, ref.dtypes,
                   wire="int8", scales=s)

    @property
    def device(self) -> torch.device:
        return self.leaves2d[0].device

    def handle(self, row: int) -> "UpdateHandle":
        return UpdateHandle(self, row)

    def handles(self) -> list["UpdateHandle"]:
        return [UpdateHandle(self, r) for r in range(self.num_rows)]

    @exempt  # an explicit device-to-host copy, legal in a hot path
    def materialize_row(self, row: int) -> Params:
        """One device's update as a host dict of owned CPU tensors (blocks
        on this buffer).  Quantized buffers dequantize on the way out."""
        if not 0 <= row < self.num_rows:
            raise IndexError(f"row {row} out of range [0, {self.num_rows})")
        out = {}
        for k, (key, leaf, shape, dt) in enumerate(
                zip(self.keys, self.leaves2d, self.shapes, self.dtypes)):
            r = leaf[row].to("cpu", copy=True)
            if self.wire == "int8":
                r = r.to(torch.float32) * self.scales[k][row].to("cpu")
            out[key] = r.reshape(shape).to(torch_dtype(dt))
        return out

    @exempt
    def materialize(self) -> Params:
        """The whole stacked update as a host dict (dequantized; owned CPU
        tensors)."""
        out = {}
        for k, (key, leaf, shape, dt) in enumerate(
                zip(self.keys, self.leaves2d, self.shapes, self.dtypes)):
            a = leaf.to("cpu", copy=True)
            if self.wire == "int8":
                a = a.to(torch.float32) * self.scales[k].to("cpu")[:, None]
            out[key] = a.reshape((self.num_rows,) + shape).to(torch_dtype(dt))
        return out

    def __repr__(self) -> str:
        return (f"UpdateBuffer(rows={self.num_rows}, "
                f"leaves={len(self.shapes)}, wire={self.wire!r}, "
                f"row_nbytes={self.row_nbytes})")

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> dict:
        """Snapshot with leaves copied to host numpy arrays, so columnar
        engine snapshots hold no live device references and pickle."""
        out = {
            "leaves2d": [leaf.detach().cpu().numpy().copy()
                         for leaf in self.leaves2d],
            "keys": list(self.keys),
            "shapes": [tuple(s) for s in self.shapes],
            "dtypes": [str(d) for d in self.dtypes],
            "wire": self.wire,
            "device": str(self.device),
        }
        if self.wire == "int8":
            # Quantized buffers checkpoint in wire form: int8 leaves + scale
            # columns, NOT a dequantized f32 copy.
            out["scales"] = [s.detach().cpu().numpy().copy()
                             for s in self.scales]
        return out

    @classmethod
    def from_state_dict(cls, d: dict, *, device=None) -> "UpdateBuffer":
        """Restore onto ``device`` (default: the device it was saved from,
        which must be available)."""
        dev = resolve_device(d.get("device") if device is None else device)
        wire = d.get("wire", "f32")
        scales = ([torch.as_tensor(s, device=dev) for s in d["scales"]]
                  if wire == "int8" else None)
        return cls([torch.as_tensor(leaf, device=dev)
                    for leaf in d["leaves2d"]], d["keys"],
                   d["shapes"], [np.dtype(s) for s in d["dtypes"]],
                   wire=wire, scales=scales)


class UpdateHandle:
    """Lightweight ``Message.payload``: a (buffer, row) reference.

    ``nbytes`` reports the row's real model-update size, so DeviceFlow
    traffic accounting sees the bytes a physical device would have uploaded —
    not the size of the reference.
    """

    __slots__ = ("buffer", "row", "__weakref__")

    def __init__(self, buffer: UpdateBuffer, row: int):
        if not 0 <= row < buffer.num_rows:
            raise IndexError(
                f"row {row} out of range [0, {buffer.num_rows})")
        self.buffer = buffer
        self.row = row

    @property
    def nbytes(self) -> int:
        return self.buffer.row_nbytes

    def materialize(self) -> Params:
        return self.buffer.materialize_row(self.row)

    def __repr__(self) -> str:
        return f"UpdateHandle(row={self.row}, nbytes={self.nbytes})"


def materialize_handles(tree: Any) -> Any:
    """Replace every ``UpdateHandle``/``UpdateBuffer`` in ``tree`` (nested
    dicts, lists and tuples) with its materialized host dict."""
    if isinstance(tree, (UpdateHandle, UpdateBuffer)):
        return tree.materialize()
    if isinstance(tree, dict):
        return {k: materialize_handles(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(materialize_handles(v) for v in tree)
    return tree
