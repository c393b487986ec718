"""JSON-safe encoding for numeric pytrees (resume sidecars).

A copy of ``dmlcloud_tpu/utils/serialization.py``, so that both packages write
and read the same sidecar encoding.

Resume metadata used to ride a pickle sidecar; unpickling executes arbitrary
code, so a tampered checkpoint directory became a code-execution vector on
resume. The payload is purely numeric — epoch counters, stop flags, metric
histories — so JSON plus a tagged ndarray encoding covers it with no code
execution on load.
"""

from __future__ import annotations

from typing import Any

import numpy as np

__all__ = ["to_jsonable", "from_jsonable"]

_ND = "__ndarray__"
_SCALAR = "__npscalar__"


def to_jsonable(obj: Any) -> Any:
    """Recursively convert a numeric pytree (dicts with str keys, lists,
    tuples, numpy arrays/scalars, Python scalars, None) into JSON-encodable
    structures. Tuples become lists; numpy values are tagged so
    ``from_jsonable`` restores dtype and shape exactly."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (np.bool_, np.integer, np.floating)):
        return {_SCALAR: obj.item(), "dtype": str(obj.dtype)}
    if isinstance(obj, np.generic):  # complex/datetime/str_/... have no JSON form
        raise TypeError(f"numpy scalar of dtype {obj.dtype} is not JSON-encodable")
    if isinstance(obj, np.ndarray):
        if obj.dtype.kind not in "biuf":
            raise TypeError(f"ndarray of dtype {obj.dtype} is not JSON-encodable")
        return {_ND: obj.tolist(), "dtype": str(obj.dtype), "shape": list(obj.shape)}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"JSON sidecars require str keys, got {type(k).__name__}: {k!r}")
            if k in (_ND, _SCALAR):
                raise TypeError(f"dict key {k!r} collides with the ndarray encoding tag")
            out[k] = to_jsonable(v)
        return out
    # tensors and anything array-like; np.asarray of an unknown object
    # yields an object-dtype array, which the ndarray branch rejects cleanly
    # rather than recursing
    return to_jsonable(np.asarray(obj))


def from_jsonable(obj: Any) -> Any:
    """Inverse of ``to_jsonable``. Pure data transformation — never executes
    anything from the payload."""
    if isinstance(obj, dict):
        if _ND in obj:
            return np.asarray(obj[_ND], dtype=np.dtype(obj["dtype"])).reshape(obj["shape"])
        if _SCALAR in obj:
            return np.dtype(obj["dtype"]).type(obj[_SCALAR])
        return {k: from_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [from_jsonable(v) for v in obj]
    return obj
