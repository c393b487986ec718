"""Flash attention for the port: hand-written CUDA kernels and their plain versions.

Counterpart of ``dmlcloud_tpu/ops/flash_attention.py``. The three Pallas TPU
kernels there (``_attn_kernel``, ``_dq_kernel``, ``_dkv_kernel``) become CUDA
C++ kernels for ``sm_90a``, built with ``nvcc`` at first use (one ``nvcc`` per
source, started together) and bound with ``ctypes`` (no PyTorch headers, so
the build takes seconds):

- ``csrc/flash_attention_tc.cu``: forward, dQ and dK/dV on the bf16 tensor
  cores (``wgmma``, TMA), for bf16 operands with head dim 64 or 128;
- ``csrc/flash_attention.cu``: forward, dQ and dK/dV on the CUDA cores in
  fp32 arithmetic, for every other supported case (fp32, and bf16 with head
  dim 16 or 32).

``kernel_route(dtype, head_dim)`` makes that choice and nothing else does;
a kernel that fails to build or launch raises, nothing retries on the other.
Each kernel has:

- a wrapper (``attn_fwd_tc``/``attn_fwd_simt``, ``attn_dq_tc``/
  ``attn_dq_simt``, ``attn_dkv_tc``/``attn_dkv_simt``; ``attn_fwd_cuda``,
  ``attn_dq_cuda`` and ``attn_dkv_cuda`` route between the pairs) that
  checks its inputs, allocates the outputs with
  ``torch.empty``, launches on the current stream, raises if the launch
  failed, and adds one to its entry in ``LAUNCHES``;
- a plain PyTorch version of the same function (``attn_fwd_plain``,
  ``attn_dq_plain``, ``attn_dkv_plain``): the port of the reference's
  blockwise-XLA twin ``_xla_fwd``/``_xla_bwd``, with the same masks, GQA
  grouping, dead-row rule and lse layout.

The dispatchers take the kernel for a CUDA tensor and the plain version for a
CPU tensor, and raise on anything else: there is no fallback from one to the
other. ``_FlashFn``/``_FlashLseFn`` mirror the reference's custom_vjp pair
``_flash``/``_flash_lse``: the forward saves ``q, k, v, out, lse``; the
backward computes ``delta = rowsum(dO * O)`` with torch ops (shifted by the lse
cotangent for the lse-returning variant), then runs dQ and dK/dV.

Layouts follow the reference's public API: q ``[B, T, H, D]``, k/v
``[B, S, KH, D]``, lse ``[B*H, T]`` fp32 inside, ``[B, T, H]`` from
``flash_attention(return_lse=True)``.

One deliberate difference from the reference: in the backward, a masked pair
contributes exactly ``p = 0``. The reference computes ``exp(s - lse)`` with
``s = -1e30`` there, which is 0 on every live row but 1 on a row with nothing
to attend to (its lse is -1e30 too), giving such rows gradients that depend on
the TPU block sizes. Dead rows only arise on the ring's shifted hops.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

NEG_INF = -1e30
#: lse of a row with nothing to attend to (reference: ``_NEG_INF + log(1e-30)``)
DEAD_LSE = NEG_INF + math.log(1e-30)
#: query block of the plain versions (the reference's ``_XLA_BLOCK_Q``)
PLAIN_BLOCK_Q = 128
MAX_HEAD_DIM = 128

#: head dims the tensor-core kernels take (bf16 only)
TC_HEAD_DIMS = (64, 128)

#: launches of each kernel since the last ``reset_launch_counts()``:
#: the CUDA-core K1, K2, K3 and the tensor-core K1, K2, K3
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_fwd_tc": 0, "flash_bwd_dq_tc": 0, "flash_bwd_dkv_tc": 0}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: library name -> source; each is one nvcc call
_SOURCES = {"simt": _CSRC / "flash_attention.cu", "tc": _CSRC / "flash_attention_tc.cu"}
_BUILD_DIR = _CSRC / "build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_libs: dict = {}
_lib_lock = threading.Lock()
#: what the last build printed (nvcc's ``-Xptxas -v`` register/smem report)
build_log = ""


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the flash-attention kernels are built at first use")
    return found


def _lib_path(src: Path) -> Path:
    """Where the library of ``src`` goes; named by a hash of the source and the flags."""
    tag = hashlib.sha256(src.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libdml_{src.stem}-{tag}.so"


def build() -> dict[str, Path]:
    """Compile each source of ``_SOURCES`` into ``csrc/build/`` (once per source
    version), all nvcc calls started together, and return the library paths."""
    global build_log
    paths = {name: _lib_path(src) for name, src in _SOURCES.items()}
    todo = {name: path for name, path in paths.items() if not path.is_file()}
    if not todo:
        return paths
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"== {_SOURCES[name].name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{_SOURCES[name].name} ({proc.returncode})")
        else:
            os.replace(tmp, todo[name])
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{build_log}")
    return paths


def _load() -> dict:
    with _lib_lock:
        if not _libs:
            paths = build()
            simt, tc = ctypes.CDLL(str(paths["simt"])), ctypes.CDLL(str(paths["tc"]))
            vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            shape = [i] * 6 + [f, i, i, i, vp]  # B T S H KH D, scale, causal, has_window, window, stream
            simt.dml_flash_fwd.argtypes = [i, vp, vp, vp, vp, vp, vp, *shape]
            simt.dml_flash_bwd_dq.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, vp, *shape]
            simt.dml_flash_bwd_dkv.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, vp, vp, *shape]
            tc.dml_flash_fwd_tc.argtypes = [vp, vp, vp, vp, vp, vp, *shape]
            tc.dml_flash_bwd_dq_tc.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, *shape]
            tc.dml_flash_bwd_dkv_tc.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, *shape]
            for fn in (simt.dml_flash_fwd, simt.dml_flash_bwd_dq, simt.dml_flash_bwd_dkv,
                       tc.dml_flash_fwd_tc, tc.dml_flash_bwd_dq_tc, tc.dml_flash_bwd_dkv_tc):
                fn.restype = i
            _libs.update(simt=simt, tc=tc)
    return _libs


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernels take K1, K2 and K3 on the card: ``"tc"`` (the bf16
    tensor-core kernels) for bf16 with head dim 64 or 128, else ``"simt"``
    (the CUDA-core kernels)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernels take float32 or bfloat16, got {dtype}")
    return "tc" if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS else "simt"


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_cuda(q, k, v, seg, *more):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, T, H, D] / [B, S, KH, D]")
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    if k.shape != (b, s, kh, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if h % kh:
        raise ValueError(f"query heads {h} not a multiple of kv heads {kh}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM} is not supported by the kernels")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernels take float32 or bfloat16, got {q.dtype}")
    for x in (q, k, v, *more):
        if not x.is_cuda or x.device != q.device:
            raise ValueError("all kernel operands must be CUDA tensors on one device")
        if not x.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    for x in (k, v):
        if x.dtype != q.dtype:
            raise TypeError("q, k, v must share one dtype")
    if seg is not None:
        if seg.dtype != torch.int32 or seg.shape != (b, t) or not seg.is_contiguous() or seg.device != q.device:
            raise ValueError("segment_ids must be a contiguous int32 [B, T] tensor on q's device")
        if s != t:
            raise ValueError("segment_ids require equal Q/KV sequence lengths")
    return b, t, s, h, kh, d


def _check_bwd(q, do, lse, delta):
    """The backward kernels read dO in q's dtype and layout, lse/delta as fp32 [B*H, T]."""
    b, t, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO must match q ({tuple(q.shape)}, {q.dtype}), got {tuple(do.shape)}, {do.dtype}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.dtype != torch.float32 or x.shape != (b * h, t):
            raise ValueError(f"{name} must be float32 [B*H, T] == {(b * h, t)}, got {tuple(x.shape)}, {x.dtype}")


def _shape_args(dims, scale, causal, window, device):
    b, t, s, h, kh, d = dims
    stream = torch.cuda.current_stream(device).cuda_stream
    has_window = window is not None
    return (b, t, s, h, kh, d, float(scale), int(bool(causal)), int(has_window),
            int(window) if has_window else 0, stream)


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {err}")


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check_tc(q, *more):
    """The tensor-core kernels read bf16 operands with head dim 64 or 128 through
    TMA, which needs 16-byte-aligned base addresses."""
    if kernel_route(q.dtype, q.shape[-1]) != "tc":
        raise ValueError(f"tensor-core kernels take bf16 with head dim in {TC_HEAD_DIMS}, "
                         f"got {q.dtype} with head dim {q.shape[-1]}")
    if any(x.data_ptr() % 16 for x in (q, *more)):
        raise ValueError("tensor-core kernels need 16-byte-aligned operands")


def attn_fwd_simt(q, k, v, seg, causal: bool, scale: float, window: int | None):
    """K1 (``_attn_kernel``) on the CUDA cores: ``(out [B,T,H,D], lse [B*H,T] fp32)``."""
    dims = _check_cuda(q, k, v, seg)
    lib = _load()["simt"]
    b, t, _, h, _, _ = dims
    out = torch.empty_like(q)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    err = lib.dml_flash_fwd(
        _DTYPE_CODES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(seg), _ptr(out), _ptr(lse),
        *_shape_args(dims, scale, causal, window, q.device),
    )
    _raise_on(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def attn_fwd_tc(q, k, v, seg, causal: bool, scale: float, window: int | None):
    """K1 (``_attn_kernel``) on the bf16 tensor cores: ``(out [B,T,H,D], lse [B*H,T] fp32)``."""
    _check_tc(q, k, v)
    dims = _check_cuda(q, k, v, seg)
    lib = _load()["tc"]
    b, t, _, h, _, _ = dims
    out = torch.empty_like(q)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    err = lib.dml_flash_fwd_tc(
        _ptr(q), _ptr(k), _ptr(v), _ptr(seg), _ptr(out), _ptr(lse), *_shape_args(dims, scale, causal, window, q.device),
    )
    _raise_on(err, "flash_fwd_tc")
    LAUNCHES["flash_fwd_tc"] += 1
    return out, lse


def attn_fwd_cuda(q, k, v, seg, causal: bool, scale: float, window: int | None):
    """K1 on the card, by ``kernel_route``."""
    fwd = attn_fwd_tc if kernel_route(q.dtype, q.shape[-1]) == "tc" else attn_fwd_simt
    return fwd(q, k, v, seg, causal, scale, window)


def attn_dq_simt(q, k, v, do, lse, delta, seg, causal: bool, scale: float, window: int | None):
    """K2 (``_dq_kernel``) on the CUDA cores: dq ``[B,T,H,D]`` from the saved lse and ``delta``."""
    dims = _check_cuda(q, k, v, seg, do, lse, delta)
    _check_bwd(q, do, lse, delta)
    lib = _load()["simt"]
    dq = torch.empty_like(q)
    err = lib.dml_flash_bwd_dq(
        _DTYPE_CODES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(seg),
        _ptr(dq), *_shape_args(dims, scale, causal, window, q.device),
    )
    _raise_on(err, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def attn_dq_tc(q, k, v, do, lse, delta, seg, causal: bool, scale: float, window: int | None):
    """K2 (``_dq_kernel``) on the bf16 tensor cores: dq ``[B,T,H,D]`` from the saved lse and ``delta``."""
    _check_tc(q, k, v, do)
    dims = _check_cuda(q, k, v, seg, do, lse, delta)
    _check_bwd(q, do, lse, delta)
    lib = _load()["tc"]
    dq = torch.empty_like(q)
    err = lib.dml_flash_bwd_dq_tc(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(seg), _ptr(dq),
        *_shape_args(dims, scale, causal, window, q.device),
    )
    _raise_on(err, "flash_bwd_dq_tc")
    LAUNCHES["flash_bwd_dq_tc"] += 1
    return dq


def attn_dq_cuda(q, k, v, do, lse, delta, seg, causal: bool, scale: float, window: int | None):
    """K2 on the card, by ``kernel_route``."""
    dq = attn_dq_tc if kernel_route(q.dtype, q.shape[-1]) == "tc" else attn_dq_simt
    return dq(q, k, v, do, lse, delta, seg, causal, scale, window)


def attn_dkv_simt(q, k, v, do, lse, delta, seg, causal: bool, scale: float, window: int | None):
    """K3 (``_dkv_kernel``) on the CUDA cores: ``(dk, dv)`` ``[B,S,KH,D]``, GQA-summed in the kernel."""
    dims = _check_cuda(q, k, v, seg, do, lse, delta)
    _check_bwd(q, do, lse, delta)
    lib = _load()["simt"]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = lib.dml_flash_bwd_dkv(
        _DTYPE_CODES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(seg),
        _ptr(dk), _ptr(dv), *_shape_args(dims, scale, causal, window, q.device),
    )
    _raise_on(err, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def attn_dkv_tc(q, k, v, do, lse, delta, seg, causal: bool, scale: float, window: int | None):
    """K3 (``_dkv_kernel``) on the bf16 tensor cores: ``(dk, dv)`` ``[B,S,KH,D]``, GQA-summed in the kernel."""
    _check_tc(q, k, v, do)
    dims = _check_cuda(q, k, v, seg, do, lse, delta)
    _check_bwd(q, do, lse, delta)
    lib = _load()["tc"]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = lib.dml_flash_bwd_dkv_tc(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(seg), _ptr(dk), _ptr(dv),
        *_shape_args(dims, scale, causal, window, q.device),
    )
    _raise_on(err, "flash_bwd_dkv_tc")
    LAUNCHES["flash_bwd_dkv_tc"] += 1
    return dk, dv


def attn_dkv_cuda(q, k, v, do, lse, delta, seg, causal: bool, scale: float, window: int | None):
    """K3 on the card, by ``kernel_route``."""
    dkv = attn_dkv_tc if kernel_route(q.dtype, q.shape[-1]) == "tc" else attn_dkv_simt
    return dkv(q, k, v, do, lse, delta, seg, causal, scale, window)


# ---------------------------------------------------------------------------
# plain versions (the reference's _xla_fwd / _xla_bwd in torch ops)
# ---------------------------------------------------------------------------

def _bounds(q0: int, bq: int, s: int, causal: bool, window: int | None):
    """Key range [lo, hi) a query block [q0, q0+bq) can reach (``_xla_bounds``)."""
    hi = min(s, q0 + bq) if causal else s
    lo = max(0, q0 - window + 1) if window is not None else 0
    return min(lo, hi), hi


def _keep(q0, bq, lo, hi, causal, window, seg, device):
    """Keep-mask [1 or B, bq, hi-lo] for one query block, or None (``_xla_keep``)."""
    keep = None
    if causal or window is not None:
        q_pos = q0 + torch.arange(bq, device=device)[:, None]
        k_pos = lo + torch.arange(hi - lo, device=device)[None, :]
        if causal:
            keep = q_pos >= k_pos
        if window is not None:
            wkeep = (q_pos - k_pos) < window
            keep = wkeep if keep is None else keep & wkeep
        keep = keep[None]
    if seg is not None:
        same = seg[:, q0 : q0 + bq, None] == seg[:, None, lo:hi]
        keep = same if keep is None else keep & same
    return keep


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 copy of ``x`` rounded through ``dtype`` (the reference's ``astype``)."""
    return x.to(dtype).float()


def attn_fwd_plain(q, k, v, seg, causal: bool, scale: float, window: int | None):
    """Plain version of K1: ``(out, lse [B*H, T])``."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    if h % kh:
        raise ValueError(f"query heads {h} not a multiple of kv heads {kh}")
    group = h // kh
    qf = q.float().reshape(b, t, kh, group, d)
    kf, vf = k.float(), v.float()
    out = torch.zeros_like(q)
    lse = torch.full((b, t, h), DEAD_LSE, dtype=torch.float32, device=q.device)
    for q0 in range(0, t, PLAIN_BLOCK_Q):
        bq = min(PLAIN_BLOCK_Q, t - q0)
        lo, hi = _bounds(q0, bq, s, causal, window)
        if lo >= hi:  # fully dead block (ring hop outside the window)
            continue
        sc = torch.einsum("btkgd,bskd->bkgts", qf[:, q0 : q0 + bq], kf[:, lo:hi]) * scale
        keep = _keep(q0, bq, lo, hi, causal, window, seg, q.device)
        if keep is not None:
            sc = torch.where(keep[:, None, None], sc, NEG_INF)
        m = sc.amax(-1)  # [B, KH, G, bq]
        p = torch.exp(sc - m[..., None])
        p = torch.where((m > NEG_INF / 2)[..., None], p, 0.0)  # dead rows: out == 0
        l_safe = p.sum(-1).clamp_min(1e-30)
        o = torch.einsum("bkgts,bskd->btkgd", _rounded(p / l_safe[..., None], v.dtype), vf[:, lo:hi])
        out[:, q0 : q0 + bq] = o.reshape(b, bq, h, d).to(q.dtype)
        lse[:, q0 : q0 + bq] = (m + torch.log(l_safe)).permute(0, 3, 1, 2).reshape(b, bq, h)
    return out, lse.permute(0, 2, 1).reshape(b * h, t).contiguous()


def _bwd_plain(q, k, v, do, lse, delta, seg, causal, scale, window, want_dq=True, want_dkv=True):
    """Plain version of K2 (``want_dq``) and K3 (``want_dkv``): ``(dq, dk, dv)``,
    with None for the part not asked for."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    group = h // kh

    def per_query(x):  # [B*H, T] -> [B, KH, G, T]
        return x.reshape(b, kh, group, t)

    lse_k, delta_k = per_query(lse.float()), per_query(delta.float())
    qf = q.float().reshape(b, t, kh, group, d)
    gf = do.float().reshape(b, t, kh, group, d)
    kf, vf = k.float(), v.float()
    dq = torch.zeros_like(q) if want_dq else None
    dk = torch.zeros((b, s, kh, d), dtype=torch.float32, device=q.device) if want_dkv else None
    dv = torch.zeros_like(dk) if want_dkv else None
    for q0 in range(0, t, PLAIN_BLOCK_Q):
        bq = min(PLAIN_BLOCK_Q, t - q0)
        lo, hi = _bounds(q0, bq, s, causal, window)
        if lo >= hi:
            continue
        qb, dob = qf[:, q0 : q0 + bq], gf[:, q0 : q0 + bq]
        kb, vb = kf[:, lo:hi], vf[:, lo:hi]
        sc = torch.einsum("btkgd,bskd->bkgts", qb, kb) * scale
        p = torch.exp(sc - lse_k[..., q0 : q0 + bq, None])
        keep = _keep(q0, bq, lo, hi, causal, window, seg, q.device)
        if keep is not None:
            p = torch.where(keep[:, None, None], p, 0.0)  # masked pairs contribute exactly 0
        dp = torch.einsum("btkgd,bskd->bkgts", dob, vb)
        ds = _rounded(p * (dp - delta_k[..., q0 : q0 + bq, None]) * scale, k.dtype)
        if want_dq:
            dqb = torch.einsum("bkgts,bskd->btkgd", ds, kb)
            dq[:, q0 : q0 + bq] = dqb.reshape(b, bq, h, d).to(q.dtype)
        if want_dkv:
            # the GQA group sum happens inside the contraction
            dk[:, lo:hi] += torch.einsum("bkgts,btkgd->bskd", ds, qb)
            dv[:, lo:hi] += torch.einsum("bkgts,btkgd->bskd", _rounded(p, do.dtype), dob)
    if want_dkv:
        dk, dv = dk.to(k.dtype), dv.to(v.dtype)
    return dq, dk, dv


def attn_dq_plain(q, k, v, do, lse, delta, seg, causal: bool, scale: float, window: int | None):
    """Plain version of K2."""
    return _bwd_plain(q, k, v, do, lse, delta, seg, causal, scale, window, want_dkv=False)[0]


def attn_dkv_plain(q, k, v, do, lse, delta, seg, causal: bool, scale: float, window: int | None):
    """Plain version of K3."""
    return _bwd_plain(q, k, v, do, lse, delta, seg, causal, scale, window, want_dq=False)[1:]


# ---------------------------------------------------------------------------
# dispatch: the kernel on a CUDA tensor, the plain version on a CPU tensor
# ---------------------------------------------------------------------------

def _route(x: torch.Tensor) -> str:
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "cpu"
    raise RuntimeError(f"flash attention has no path for device {x.device}")


def attn_fwd(q, k, v, seg, causal, scale, window):
    if _route(q) == "cuda":
        return attn_fwd_cuda(q, k, v, seg, causal, scale, window)
    return attn_fwd_plain(q, k, v, seg, causal, scale, window)


def softmax_delta(out, do, lse_cotangent=None):
    """``delta = rowsum(dO * O)`` as fp32 ``[B*H, T]``, shifted by the lse
    cotangent (d lse / d s = p folds in as ``ds = p * (dp - (delta - g_lse))``)."""
    b, t, h, _ = out.shape
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, t)
    if lse_cotangent is not None:
        delta = delta - lse_cotangent.float()
    return delta.contiguous()


def attn_bwd(q, k, v, out, lse, do, seg, causal, scale, window, lse_cotangent=None):
    """Backward of the pair: ``delta`` with torch ops, as the reference computes
    it outside its kernels, then dQ and dK/dV."""
    delta = softmax_delta(out, do, lse_cotangent)
    do = do.contiguous()
    if _route(q) == "cuda":
        dq = attn_dq_cuda(q, k, v, do, lse, delta, seg, causal, scale, window)
        dk, dv = attn_dkv_cuda(q, k, v, do, lse, delta, seg, causal, scale, window)
        return dq, dk, dv
    return _bwd_plain(q, k, v, do, lse, delta, seg, causal, scale, window)


class _FlashFn(torch.autograd.Function):
    """``out`` of attention; the counterpart of the reference's ``_flash``."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal, scale, window):
        out, lse = attn_fwd(q, k, v, seg, causal, scale, window)
        ctx.save_for_backward(q, k, v, out, lse, seg)
        ctx.args = (causal, scale, window)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, seg = ctx.saved_tensors
        dq, dk, dv = attn_bwd(q, k, v, out, lse, g, seg, *ctx.args)
        return dq, dk, dv, None, None, None, None


class _FlashLseFn(torch.autograd.Function):
    """``(out, lse [B*H, T])``, differentiable in both; the counterpart of the
    reference's ``_flash_lse``. Accepts what the public API rejects: a window
    without ``causal``, shifted and possibly non-positive (the ring's hops)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal, scale, window):
        out, lse = attn_fwd(q, k, v, seg, causal, scale, window)
        ctx.save_for_backward(q, k, v, out, lse, seg)
        ctx.args = (causal, scale, window)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse, seg = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = attn_bwd(q, k, v, out, lse, g_out, seg, *ctx.args, lse_cotangent=g_lse)
        return dq, dk, dv, None, None, None, None


def flash_lse(q, k, v, segment_ids=None, causal: bool = True, sm_scale: float | None = None,
              window: int | None = None):
    """``(out [B,T,H,D], lse [B*H, T])`` with no argument checks beyond the
    kernels' own — the building block of blockwise/ring combiners."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    return _FlashLseFn.apply(q.contiguous(), k.contiguous(), v.contiguous(), seg, bool(causal), scale, window)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: float | None = None,
    return_lse: bool = False,
    window: int | None = None,
    segment_ids: torch.Tensor | None = None,
):
    """q: [B, T, H, D]; k/v: [B, S, KH, D] with H % KH == 0. Returns [B, T, H, D].

    Same contract as the reference's ``flash_attention``: ``window`` = W keeps
    ``q_pos - k_pos < W`` and requires ``causal``; ``segment_ids`` ([B, T],
    requires T == S) masks cross-segment pairs; causal needs T == S (top-left
    alignment). Any sequence length is accepted. With ``return_lse=True``
    returns ``(out, lse)`` with lse [B, T, H], differentiable in both.
    On a CUDA tensor it runs the kernels, on a CPU tensor their plain versions.
    """
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    if causal and t != k.shape[1]:
        raise ValueError(f"causal flash attention requires equal Q/KV sequence lengths, got {t} != {k.shape[1]}")
    if window is not None:
        if not causal:
            raise ValueError("window (sliding-window attention) requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        window = int(window)
    seg = None
    if segment_ids is not None:
        seg = torch.as_tensor(segment_ids, device=q.device).to(torch.int32).contiguous()
        if seg.shape != (b, t):
            raise ValueError(f"segment_ids must be [B, T] == {(b, t)}, got {tuple(seg.shape)}")
        if t != k.shape[1]:
            raise ValueError("segment_ids require equal Q/KV sequence lengths (self-attention packing)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if return_lse:
        out, lse = _FlashLseFn.apply(q, k, v, seg, bool(causal), scale, window)
        return out, lse.reshape(b, h, t).permute(0, 2, 1)
    return _FlashFn.apply(q, k, v, seg, bool(causal), scale, window)
