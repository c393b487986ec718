"""The port's flash attention against the JAX package's, on the CPU.

On CPU tensors ``dmlcloud_tpu_torch.ops.flash_attention`` runs the plain
PyTorch versions of its three CUDA kernels (the kernels themselves are held
against those plain versions on the card by ``chip_smoke.py``). The same
numpy inputs go through the port and through the JAX ``flash_attention`` with
both of its lowerings (``impl="xla"`` and the interpreted Pallas kernels), and
through the unfused ``_reference_attention``: forward and q/k/v gradients must
agree within ``TOL`` of tests/test_kernel_numerics.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlcloud_tpu.ops.flash_attention import _reference_attention
from dmlcloud_tpu.ops.flash_attention import flash_attention as jax_flash
from dmlcloud_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

# tests/test_kernel_numerics.py:28
TOL = {"fp32": dict(atol=5e-5, rtol=5e-5), "bf16": dict(atol=6e-2, rtol=6e-2)}
JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}
LOWERINGS = {"xla": dict(impl="xla"), "pallas": dict(impl="pallas", interpret=True, block_q=32, block_k=32)}


def _arrays(b=2, t=64, h=4, kh=None, d=16, seed=0):
    kh = kh or h
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, t, h, d) * 0.5).astype(np.float32)
    k = (rng.randn(b, t, kh, d) * 0.5).astype(np.float32)
    v = rng.randn(b, t, kh, d).astype(np.float32)
    cot = np.random.RandomState(seed + 7).randn(b, t, h, d).astype(np.float32)
    return q, k, v, cot


def _jax_fwd_grads(attn, arrays, dtype):
    """Forward and the vjp of ``vdot(out, cot)`` in one trace."""
    q, k, v, cot = arrays

    @jax.jit
    def fwd_bwd(q, k, v, cot):
        out, vjp = jax.vjp(attn, q, k, v)
        return (out, *vjp(cot.astype(out.dtype)))

    return [np.asarray(x, np.float32) for x in fwd_bwd(*(jnp.asarray(x, JNP[dtype]) for x in (q, k, v)), cot)]


def _port_fwd_grads(attn, arrays, dtype):
    q, k, v, cot = arrays
    tq, tk, tv = (torch.from_numpy(x).to(TORCH[dtype]).requires_grad_(True) for x in (q, k, v))
    out = attn(tq, tk, tv)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return [x.detach().float().numpy() for x in (out, tq.grad, tk.grad, tv.grad)]


def _assert_all_close(got, want, tol, what):
    for g, w, name in zip(got, want, ["out", "dq", "dk", "dv"]):
        np.testing.assert_allclose(g, w, err_msg=f"{what}: {name}", **tol)


@pytest.mark.parametrize("lowering", sorted(LOWERINGS))
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 24)], ids=["causal", "full", "window24"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_matches_jax_flash_and_reference(dtype, causal, window, lowering):
    arrays = _arrays()
    sm = 1.0 / np.sqrt(arrays[0].shape[-1])
    port = _port_fwd_grads(lambda q, k, v: fa.flash_attention(q, k, v, causal=causal, window=window), arrays, dtype)
    ref = _jax_fwd_grads(lambda q, k, v: jax_flash(q, k, v, causal=causal, window=window, **LOWERINGS[lowering]),
                         arrays, dtype)
    _assert_all_close(port, ref, TOL[dtype], f"port vs jax {lowering}")
    unfused = _jax_fwd_grads(lambda q, k, v: _reference_attention(q, k, v, causal, sm, window=window), arrays, dtype)
    _assert_all_close(port, unfused, TOL[dtype], "port vs _reference_attention")


@pytest.mark.parametrize("lowering", sorted(LOWERINGS))
@pytest.mark.parametrize("t", [40, 56, 96], ids=lambda t: f"t{t}")
def test_ragged_lengths(t, lowering):
    arrays = _arrays(t=t)
    kw = dict(LOWERINGS[lowering])
    if lowering == "pallas":  # the Pallas blocks must divide T; the port takes any T
        kw.update(block_q=8, block_k=8)
    port = _port_fwd_grads(lambda q, k, v: fa.flash_attention(q, k, v, causal=True), arrays, "fp32")
    ref = _jax_fwd_grads(lambda q, k, v: jax_flash(q, k, v, causal=True, **kw), arrays, "fp32")
    _assert_all_close(port, ref, TOL["fp32"], f"ragged t={t} vs jax {lowering}")


@pytest.mark.parametrize("lowering", sorted(LOWERINGS))
def test_gqa_8_to_2(lowering):
    arrays = _arrays(h=8, kh=2)
    port = _port_fwd_grads(lambda q, k, v: fa.flash_attention(q, k, v, causal=True), arrays, "fp32")
    ref = _jax_fwd_grads(lambda q, k, v: jax_flash(q, k, v, causal=True, **LOWERINGS[lowering]), arrays, "fp32")
    _assert_all_close(port, ref, TOL["fp32"], f"gqa vs jax {lowering}")


def _segment_ids(b, t, seed=3):
    rng = np.random.RandomState(seed)
    seg = np.zeros((b, t), np.int32)
    for row in range(b):
        cuts = np.sort(rng.choice(np.arange(4, t - 4), size=3, replace=False))
        for i, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, t - 5])):
            seg[row, lo:hi] = i + 1  # the last 5 slots stay padding (0)
    return seg


@pytest.mark.parametrize("lowering", sorted(LOWERINGS))
@pytest.mark.parametrize("window", [None, 24], ids=["causal", "window24"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_segment_ids(dtype, window, lowering):
    arrays = _arrays(h=4, kh=2)
    seg = _segment_ids(2, 64)
    port = _port_fwd_grads(
        lambda q, k, v: fa.flash_attention(q, k, v, causal=True, window=window, segment_ids=torch.from_numpy(seg)),
        arrays, dtype,
    )
    ref = _jax_fwd_grads(
        lambda q, k, v: jax_flash(q, k, v, causal=True, window=window, segment_ids=jnp.asarray(seg),
                                  **LOWERINGS[lowering]),
        arrays, dtype,
    )
    _assert_all_close(port, ref, TOL[dtype], f"segment_ids vs jax {lowering}")


@pytest.mark.parametrize("lowering", sorted(LOWERINGS))
def test_return_lse_with_lse_cotangent(lowering):
    """Both outputs are differentiable: the lse cotangent folds into delta."""
    q, k, v, cot = _arrays(h=4, kh=2)
    lse_cot = np.random.RandomState(11).randn(2, 64, 4).astype(np.float32)

    def jax_loss(q, k, v):
        out, lse = jax_flash(q, k, v, causal=True, return_lse=True, **LOWERINGS[lowering])
        return jnp.vdot(out, jnp.asarray(cot)) + jnp.vdot(lse, jnp.asarray(lse_cot)), (out, lse)

    (_, (j_out, j_lse)), j_grads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v))
    )
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, lse = fa.flash_attention(tq, tk, tv, causal=True, return_lse=True)
    assert lse.shape == (2, 64, 4)
    ((out * torch.from_numpy(cot)).sum() + (lse * torch.from_numpy(lse_cot)).sum()).backward()
    got = [out.detach(), lse.detach(), tq.grad, tk.grad, tv.grad]
    want = [j_out, j_lse, *j_grads]
    for g, w, name in zip(got, want, ["out", "lse", "dq", "dk", "dv"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL["fp32"])


def test_flash_lse_takes_a_shifted_non_causal_window():
    """The ring's per-hop call (causal=False, a shifted, possibly non-positive
    window) is rejected by the public API but accepted by the lse entry point,
    with the reference's dead-row rule: out 0 and a finite lse."""
    q, k, v, _ = _arrays(t=32, h=2, d=8)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    with pytest.raises(ValueError):
        fa.flash_attention(tq, tk, tv, causal=False, window=-4)
    out, lse = fa.flash_lse(tq, tk, tv, causal=False, window=-4)
    lse = lse.reshape(2, 2, 32)
    # rows q >= 27 keep no key (q - k < -4 needs k > q + 4 > 31)
    assert torch.all(out[:, 27:] == 0)
    assert torch.all(lse[:, :, 27:] == fa.DEAD_LSE) and torch.isfinite(lse).all()
    # a live row equals plain softmax attention over the keys it keeps
    row = 3
    keys = np.arange(32) > row + 4
    s = (q[0, row, 0] @ k[0, keys, 0].T) / np.sqrt(8)
    p = np.exp(s - s.max())
    np.testing.assert_allclose(out[0, row, 0].numpy(), (p / p.sum()) @ v[0, keys, 0], atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_versions_and_cuda_wrappers_refuse_them():
    q, k, v, _ = _arrays(t=16, h=2, d=8)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    fa.reset_launch_counts()
    fa.flash_attention(tq, tk, tv)
    assert set(fa.LAUNCHES) == {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                "flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc"}
    assert all(n == 0 for n in fa.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        fa.attn_fwd_cuda(tq, tk, tv, None, True, 0.35, None)
    with pytest.raises(RuntimeError, match="no path"):
        fa.attn_fwd(tq.to("meta"), tk.to("meta"), tv.to("meta"), None, True, 0.35, None)


@pytest.mark.parametrize("wrapper", ["attn_fwd_tc", "attn_fwd_cuda", "attn_dq_tc", "attn_dq_cuda", "attn_dkv_tc",
                                     "attn_dkv_cuda"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """The tensor-core wrappers, and the routers on their route, launch a kernel or raise."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _arrays(t=16, h=2, d=64))
    assert fa.kernel_route(q.dtype, q.shape[-1]) == "tc"
    stats = () if "fwd" in wrapper else (do, torch.zeros(4, 16), torch.zeros(4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        getattr(fa, wrapper)(q, k, v, *stats, None, True, 0.125, None)


@pytest.mark.parametrize("wrapper", ["attn_fwd_tc", "attn_dq_tc", "attn_dkv_tc"])
@pytest.mark.parametrize("dtype,head_dim", [(torch.float32, 64), (torch.bfloat16, 32)], ids=["fp32_d64", "bf16_d32"])
def test_tensor_core_wrappers_refuse_what_the_route_sends_elsewhere(wrapper, dtype, head_dim):
    """fp32 and head dims below 64 stay on the CUDA-core kernels: the tensor-core
    wrappers raise before touching the operands."""
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in _arrays(t=16, h=2, d=head_dim))
    stats = () if "fwd" in wrapper else (do, torch.zeros(4, 16), torch.zeros(4, 16))
    with pytest.raises(ValueError, match="tensor-core kernels take bf16"):
        getattr(fa, wrapper)(q, k, v, *stats, None, True, 0.125, None)


@pytest.mark.parametrize(
    "dtype,head_dim,route",
    [(torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"), (torch.bfloat16, 16, "simt"),
     (torch.bfloat16, 32, "simt"), (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
     (torch.float32, 16, "simt")],
    ids=lambda x: str(x).replace("torch.", ""),
)
def test_kernel_route(dtype, head_dim, route):
    """bf16 with head dim 64/128 goes to the tensor-core kernels, the rest to the CUDA-core ones."""
    assert fa.kernel_route(dtype, head_dim) == route


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32], ids=str)
def test_kernel_route_refuses_unsupported_dtypes(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.kernel_route(dtype, 64)
