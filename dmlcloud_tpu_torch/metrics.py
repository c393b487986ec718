"""Distributed metric tracking with epoch-wise reduction.

Counterpart of ``dmlcloud_tpu/metrics.py`` (``Reduction`` :43,
``MetricReducer`` :78, ``MetricTracker`` :297), on torch tensors:

1. **No per-step device sync.** ``append`` keeps device tensors as they are;
   they reach the host once per epoch, stacked on the device and copied in one
   transfer at reduce time.
2. **One collective per epoch.** ``MetricTracker.reduce_all`` packs every
   scalar metric's locally-reduced value, its emptiness bit and a name-set
   fingerprint into ONE float32 vector (``_pack_scalar_metrics``) and exchanges
   it with a single ``all_reduce`` (``runtime.all_gather_array``); at world
   size 1 there is no collective at all.

The reference's smaller API is kept too: ``reduce_tensor``, the reducer's
list protocol (``+=``, indexing), ``reduce_and_append``, the standalone
``reduce_globally`` (two object exchanges) and ``MetricTracker.bump``. The
ragged-tracking consensus error (some ranks tracked a metric, some did not)
is kept, and so are the resume hooks: ``state_dict``/``load_state_dict`` of the
tracker and its reducers (JSON-encodable, the resume sidecar's ``tracker``) and
``MetricTracker.fast_forward``.
"""

from __future__ import annotations

import zlib
from enum import Enum
from typing import Any, Iterable

import numpy as np
import torch

from .parallel import runtime


class Reduction(Enum):
    MEAN = "MEAN"
    SUM = "SUM"
    MIN = "MIN"
    MAX = "MAX"

    def combine(self, stacked: np.ndarray, axis) -> np.ndarray:
        if self is Reduction.MEAN:
            return stacked.mean(axis=axis)
        if self is Reduction.SUM:
            return stacked.sum(axis=axis)
        if self is Reduction.MIN:
            return stacked.min(axis=axis)
        if self is Reduction.MAX:
            return stacked.max(axis=axis)
        raise ValueError(f"unknown reduction {self}")


def reduce_tensor(tensor: Any, reduction: Reduction, dim: int | list[int] | None = None) -> np.ndarray:
    """Reduce an array or tensor over ``dim`` (all dims if None), on the host."""
    arr = _to_host(tensor)
    if dim is None:
        axis: Any = tuple(range(arr.ndim))
    elif isinstance(dim, int):
        axis = (dim,)
    else:
        axis = tuple(dim)
    return reduction.combine(arr, axis)


def _to_host(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype in (torch.bfloat16, torch.float16):
            value = value.float()
        return value.cpu().numpy()
    return np.asarray(value)


def _stack_host(values: list) -> np.ndarray:
    """Stack buffered values on the host, with ONE device-to-host copy when
    they are all tensors on one device."""
    if values and all(isinstance(v, torch.Tensor) for v in values) and len({v.device for v in values}) == 1:
        return _to_host(torch.stack([v.detach() for v in values]))
    return np.stack([_to_host(v) for v in values])


class MetricReducer:
    """Buffers per-step values and reduces them at epoch end. ``dim`` indexes
    dimensions of the individual appended values; the stacking dimension is
    always reduced."""

    def __init__(self, reduction: Reduction = Reduction.MEAN, dim=None, globally: bool = True):
        if reduction not in (Reduction.MEAN, Reduction.SUM, Reduction.MIN, Reduction.MAX):
            raise ValueError(f"unknown reduction {reduction}")
        self.values: list[Any] = []
        self.reduction = reduction
        self.globally = globally
        if isinstance(dim, int):
            self.dim: list[int] | None = [dim]
        elif dim is not None:
            self.dim = list(dim)
        else:
            self.dim = None

    def append(self, value: Any) -> None:
        """Append a value; a device tensor stays on the device (no sync)."""
        self.values.append(value.detach() if isinstance(value, torch.Tensor) else value)

    def extend(self, values: Iterable[Any]) -> None:
        for v in values:
            self.append(v)

    def __iadd__(self, value: Any) -> "MetricReducer":
        self.append(value)
        return self

    def __setitem__(self, idx: int, value: Any) -> None:
        self.values[idx] = value

    def __getitem__(self, idx: int) -> Any:
        return self.values[idx]

    def __delitem__(self, idx: int) -> None:
        del self.values[idx]

    def __len__(self) -> int:
        return len(self.values)

    def __iter__(self):
        return iter(self.values)

    def clear(self) -> None:
        self.values.clear()

    def reduce_and_append(self, value: Any) -> None:
        """Append ``value`` already reduced over ``dim`` (on the host)."""
        self.values.append(reduce_tensor(value, self.reduction, dim=self.dim))

    def reduce_locally(self) -> np.ndarray | None:
        """Stack buffered values and reduce on this process only."""
        if len(self.values) == 0:
            return None
        stacked = _stack_host(self.values)
        axis = tuple(range(stacked.ndim)) if self.dim is None else tuple([0] + [d + 1 for d in self.dim])
        return self.reduction.combine(stacked, axis)

    def reduce_globally(self) -> np.ndarray | None:
        """Reduce across all processes (the standalone path: ``MetricTracker``
        uses the packed exchange instead). Raises if ranks disagree on whether
        this metric was tracked."""
        if self.globally:
            empty = runtime.all_gather_object(len(self.values) == 0)
            if any(empty):
                if len(empty) > 1 and not all(empty):
                    raise ValueError("Some workers tracked values this epoch and some did not. This is likely a bug.")
                return None
        elif len(self.values) == 0:
            return None
        local = self.reduce_locally()
        if self.globally and runtime.world_size() > 1:
            local = _combine_across(runtime.all_gather_object(local), self.reduction)
        return local

    # -- serialization ------------------------------------------------------
    def state_dict(self) -> dict:
        # reduction stored by value so the state is JSON-encodable (resume
        # sidecars are JSON, not pickle: utils/serialization.py)
        return {
            "reduction": self.reduction.value,
            "dim": self.dim,
            "globally": self.globally,
            "values": [_to_host(v) for v in self.values],
        }

    def load_state_dict(self, state: dict) -> None:
        red = state["reduction"]
        self.reduction = red if isinstance(red, Reduction) else Reduction(red)
        self.dim = state["dim"]
        self.globally = bool(state["globally"])
        self.values = list(state["values"])


def _combine_across(per_rank: list, reduction: Reduction) -> np.ndarray:
    """Combine already-locally-reduced values from each rank (MEAN is the
    unweighted mean of rank-local means)."""
    return reduction.combine(np.stack([np.asarray(v) for v in per_rank]), axis=0)


def _name_fingerprint(names: list[str]) -> np.float32:
    """Order-sensitive fingerprint of the metric-name set, exactly
    representable in float32."""
    return np.float32(zlib.crc32("\x00".join(names).encode()) % (2**24 - 3))


def _pack_scalar_metrics(names: list[str], local: dict[str, tuple[bool, Any]]) -> np.ndarray:
    """``[fingerprint | empty bits | values]`` as one float32 vector — the
    payload of the single-collective epoch exchange. Values transit as
    float32, so integer SUM counters are exact up to 2**24 per epoch."""
    n = len(names)
    vec = np.zeros(1 + 2 * n, np.float32)
    vec[0] = _name_fingerprint(names)
    for i, name in enumerate(names):
        empty, value = local[name]
        vec[1 + i] = float(empty)
        vec[1 + n + i] = 0.0 if empty else float(np.asarray(value))
    return vec


def _unpack_scalar_metrics(
    names: list[str], gathered: np.ndarray, reductions: dict[str, Reduction]
) -> dict[str, np.ndarray | None]:
    """Combine the ``[world, 1+2n]`` gathered exchange vectors on the host."""
    n = len(names)
    if not np.all(gathered[:, 0] == gathered[0, 0]):
        raise ValueError("Workers disagree on the set of metrics tracked this epoch. This is likely a bug.")
    out: dict[str, np.ndarray | None] = {}
    for i, name in enumerate(names):
        empties = gathered[:, 1 + i] != 0.0
        if empties.any():
            if not empties.all():
                raise ValueError(
                    f"Metric '{name}': some workers tracked values this epoch and some did not. This is likely a bug."
                )
            out[name] = None
        else:
            out[name] = _combine_across(list(gathered[:, 1 + n + i].astype(np.float64)), reductions[name])
    return out


class MetricTracker:
    """Tracks named metric histories keyed by epoch.

    Usage::

        tracker = MetricTracker()
        tracker.register_metric('loss', reduction=Reduction.MEAN)
        tracker.track('loss', loss_value)
        tracker.next_epoch()
        tracker['loss']  # history
    """

    def __init__(self):
        self.histories: dict[str, list] = {}
        self.reducers: dict[str, MetricReducer] = {}
        #: the processes whose values the epoch exchange combines (None: all).
        #: On a mesh with a ``model`` axis the pipeline sets one process per
        #: data-parallel coordinate: tensor-parallel peers hold the same
        #: values and count once.
        self.ranks: list[int] | None = None
        self.epoch = 1

    def __getitem__(self, name: str) -> list:
        """History of a metric for completed epochs."""
        if name not in self:
            raise ValueError(f"Metric {name} does not exist")
        return list(self.histories[name])[: self.epoch - 1]

    def __contains__(self, name: str) -> bool:
        return name in self.histories

    def __len__(self) -> int:
        return len(self.histories)

    def __iter__(self):
        return iter(self.histories)

    def current_value(self, name: str):
        if name not in self:
            raise ValueError(f"Metric {name} does not exist")
        return self.histories[name][-1] if self.has_value(name) else None

    def is_reduced_metric(self, name: str) -> bool:
        if name not in self:
            raise ValueError(f"Metric {name} does not exist")
        return name in self.reducers

    def has_value(self, name: str) -> bool:
        if name not in self:
            raise ValueError(f"Metric {name} does not exist")
        return len(self.histories[name]) >= self.epoch

    def register_metric(self, name: str, reduction: Reduction | None = None, dim=None, globally: bool = True) -> None:
        if name in self:
            raise ValueError(f"Metric {name} already exists")
        if dim is not None and reduction is None:
            raise ValueError("If dim is specified, reduction must be specified as well")
        self.histories[name] = [None] * (self.epoch - 1)
        if reduction is not None:
            self.reducers[name] = MetricReducer(reduction=reduction, dim=dim, globally=globally)

    def track(self, name: str, value: Any) -> None:
        if name not in self:
            raise ValueError(f"Metric {name} does not exist")
        if self.has_value(name):
            raise ValueError(f"History for {name} already has a value for epoch {self.epoch}")
        reducer = self.reducers.get(name)
        if reducer is not None:
            reducer.append(value)
        else:
            self.histories[name].append(_to_host(value) if isinstance(value, torch.Tensor) else value)

    def bump(self, name: str, value: int | float = 1, globally: bool = True) -> None:
        """Epoch-scoped event counter: registered as a SUM reduction on first
        use, ``value`` added. With ``globally`` the epoch total sums across
        processes; safe to call any number of times per epoch."""
        if name not in self:
            self.register_metric(name, Reduction.SUM, globally=globally)
        self.track(name, value)

    def reduce_all(self, prefix: str | None = None, strict: bool = True) -> None:
        """Reduce all (or prefix-filtered) metrics and append to histories.
        Cross-process cost: one ``all_reduce`` for every scalar metric
        together, one object exchange for the rare non-scalar ones."""
        selected = []
        for name in self.histories:
            if prefix is not None and not name.startswith(prefix):
                continue
            if self.has_value(name):
                if strict:
                    raise ValueError(f"History for {name} has already been reduced for epoch {self.epoch}")
                continue
            selected.append(name)

        local: dict[str, tuple[bool, np.ndarray | None]] = {}
        for name in selected:
            reducer = self.reducers.get(name)
            if reducer is not None and reducer.globally:
                local[name] = (len(reducer.values) == 0, reducer.reduce_locally())

        fused: dict[str, np.ndarray | None] = {}
        if local and runtime.world_size() > 1:
            # scalar = registered with dim=None, a registration-time property,
            # so every rank routes a metric through the same exchange
            scalar_names = sorted(n for n in local if self.reducers[n].dim is None)
            other = {n: local[n] for n in local if n not in scalar_names}
            if scalar_names:
                reductions = {n: self.reducers[n].reduction for n in scalar_names}
                gathered = runtime.all_gather_array(_pack_scalar_metrics(scalar_names, local))
                if self.ranks is not None:
                    gathered = gathered[self.ranks]
                fused.update(_unpack_scalar_metrics(scalar_names, gathered, reductions))
            if other:
                gathered_obj = runtime.all_gather_object(other)
                if self.ranks is not None:
                    gathered_obj = [gathered_obj[r] for r in self.ranks]
                for name in other:
                    empties = [g.get(name, (True, None))[0] for g in gathered_obj]
                    if any(empties):
                        if not all(empties):
                            raise ValueError(
                                f"Metric '{name}': some workers tracked values this epoch and some did not. "
                                "This is likely a bug."
                            )
                        fused[name] = None
                    else:
                        fused[name] = _combine_across([g[name][1] for g in gathered_obj], self.reducers[name].reduction)
        else:
            for name, (is_empty, val) in local.items():
                fused[name] = None if is_empty else val

        for name in selected:
            reducer = self.reducers.get(name)
            if reducer is None:
                self.histories[name].append(None)
            elif reducer.globally:
                self.histories[name].append(fused[name])
                reducer.clear()
            else:
                self.histories[name].append(reducer.reduce_locally())
                reducer.clear()

    def next_epoch(self) -> None:
        """Reduce anything un-reduced and advance the epoch counter."""
        self.reduce_all(strict=False)
        self.epoch += 1

    def fast_forward(self, epoch: int) -> None:
        """Jump the tracker to ``epoch``, padding every history with None for
        the skipped epochs (no-op when already there or past). A mid-epoch
        resume whose restored tracker is older than the resumed epoch (sparse
        ``checkpoint_every``) keeps later epochs aligned this way."""
        if epoch <= self.epoch:
            return
        for hist in self.histories.values():
            while len(hist) < epoch - 1:
                hist.append(None)
        self.epoch = epoch

    def state_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "histories": {k: list(v) for k, v in self.histories.items()},
            "reducers": {name: r.state_dict() for name, r in self.reducers.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self.histories = {k: list(v) for k, v in state["histories"].items()}
        self.reducers = {}
        for name, rstate in state["reducers"].items():
            r = MetricReducer()
            r.load_state_dict(rstate)
            self.reducers[name] = r

    def __str__(self) -> str:
        s = "MetricTracker("
        for name, history in self.histories.items():
            s += f"\n  {name}: {history}"
        s += "\n)" if self.histories else ")"
        return s
