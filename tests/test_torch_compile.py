"""The port's compiled step (``dmlcloud_tpu_torch.compile``) on the CPU.

- K1-K3 as ``torch.library`` custom ops: ``opcheck`` on each, with fp32 and
  bf16, segment ids present and absent, and a window; any operand strides;
  a tiny flash ``DecoderLM`` under ``torch.compile(fullgraph=True)`` with no
  graph break, its logits and gradients within ``TOL`` of eager and of the
  JAX package's model on the same weights.
- ``compile/`` against the JAX package on the same numpy inputs: bucket
  padding, specs, iterators, masked reductions (losses and gradients of a
  padded batch equal the unpadded ones), the reference's errors, signatures,
  the cache directory's resolution order and ``cache_stats()``'s keys.
- ``PrecompiledStep``: the signature registry, recompile counting, and
  Dynamo's recompile limit raising instead of falling back to eager.

The stage's use of all this is tests/test_torch_compile_stage.py.

Compiled regions use ``backend="aot_eager"`` (``compile.aot.BACKEND``,
monkeypatched): it traces and partitions like Inductor without generating
code. One test uses Inductor: the persistent cache's hit accounting.
"""


import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlcloud_tpu.compile import aot as jaot
from dmlcloud_tpu.compile import buckets as jbk
from dmlcloud_tpu.compile import cache as jcache
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu_torch.compile import aot, buckets as bk, cache as cache_lib
from dmlcloud_tpu_torch.data import markov_tokens
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

# tests/test_kernel_numerics.py:28
TOL = {"fp32": dict(atol=5e-5, rtol=5e-5), "bf16": dict(atol=6e-2, rtol=6e-2)}
TINY = dict(vocab_size=512, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16, hidden_dim=64, mlp_dim=160,
            max_seq_len=32)
BATCH, SEQ = 4, 32


@pytest.fixture(autouse=True)
def aot_eager(monkeypatch):
    monkeypatch.setattr(aot, "BACKEND", "aot_eager")


# ----------------------------------------------------------------- custom ops


def _qkv(dtype, seed=0, b=2, t=32, h=4, kh=2, d=16):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32) * 0.5).to(dtype)
    k = torch.from_numpy(rng.randn(b, t, kh, d).astype(np.float32) * 0.5).to(dtype)
    v = torch.from_numpy(rng.randn(b, t, kh, d).astype(np.float32)).to(dtype)
    return q, k, v


def _segments(b=2, t=32):
    return torch.from_numpy(np.repeat([[1] * 20 + [2] * 9 + [0] * 3], b, 0).astype(np.int32))


@pytest.mark.parametrize("window", [None, 8], ids=["full", "window8"])
@pytest.mark.parametrize("with_seg", [False, True], ids=["noseg", "seg"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_opcheck_the_three_ops(dtype, with_seg, window):
    q, k, v = _qkv(dtype)
    seg = _segments() if with_seg else None
    args = (True, 0.25, window)
    fwd = (q.requires_grad_(), k.requires_grad_(), v.requires_grad_(), seg, *args)
    torch.library.opcheck(torch.ops.dmlcloud_tpu_torch.flash_fwd.default, fwd)
    with torch.no_grad():
        out, lse = fa.flash_fwd_op(q, k, v, seg, *args)
    do = torch.randn_like(out)
    delta = fa.softmax_delta(out, do)
    bwd = (q.detach(), k.detach(), v.detach(), do, lse, delta, seg, *args)
    torch.library.opcheck(torch.ops.dmlcloud_tpu_torch.flash_dq.default, bwd)
    torch.library.opcheck(torch.ops.dmlcloud_tpu_torch.flash_dkv.default, bwd)


def test_ops_take_any_strides_and_count_no_launch_on_the_cpu():
    q, k, v = _qkv(torch.float32)
    # the same values, laid out [B, H, T, D] and viewed back: non-contiguous
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    assert not qt.is_contiguous()
    fa.reset_launch_counts()
    want = fa.flash_fwd_op(q, k, v, None, True, 0.25, None)
    got = fa.flash_fwd_op(qt, kt, vt, None, True, 0.25, None)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert all(n == 0 for n in fa.LAUNCHES.values())


def _flax_init(attn_impl="flash"):
    model = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, attn_impl=attn_impl, **TINY))
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, SEQ), jnp.int32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def test_compiled_flash_decoder_has_no_graph_break_and_matches_eager_and_jax():
    from torch._dynamo.utils import counters

    jmodel, tree = _flax_init()
    model = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, attn_impl="flash", **TINY), device="cpu")
    ttr.load_flax_params(model, tree)
    tokens = markov_tokens(TINY["vocab_size"], BATCH, SEQ, seed=3)
    tok = torch.from_numpy(tokens)

    def loss_and_logits(tok):
        logits = model(tok)
        return ttr.lm_loss(logits, tok), logits

    counters.clear()
    compiled = aot.compile_region(loss_and_logits, "tiny_lm")
    results = []
    for fn in (compiled, loss_and_logits):
        model.zero_grad(set_to_none=True)
        loss, logits = fn(tok)
        loss.backward()
        results.append((loss.detach(), logits.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}))
    assert sum(counters["graph_break"].values()) == 0
    (c_loss, c_logits, c_grads), (e_loss, e_logits, e_grads) = results
    torch.testing.assert_close(c_logits, e_logits, **TOL["fp32"])
    torch.testing.assert_close(c_loss, e_loss, **TOL["fp32"])
    for n in e_grads:
        torch.testing.assert_close(c_grads[n], e_grads[n], **TOL["fp32"], msg=n)

    def jloss(params):
        logits = jmodel.apply({"params": params}, jnp.asarray(tokens))
        return jtr.lm_loss(logits, jnp.asarray(tokens)), logits

    (j_loss, j_logits), j_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    np.testing.assert_allclose(c_logits.numpy(), np.asarray(j_logits), **TOL["fp32"])
    np.testing.assert_allclose(float(c_loss), float(j_loss), **TOL["fp32"])
    # the JAX gradients through the weight bridge, onto the torch names
    gmodel = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, attn_impl="flash", **TINY), device="cpu")
    ttr.load_flax_params(gmodel, jax.tree_util.tree_map(np.asarray, j_grads))
    for n, want in gmodel.named_parameters():
        torch.testing.assert_close(c_grads[n], want.detach(), **TOL["fp32"], msg=n)


# ---------------------------------------------------------------- compile/


def test_bucket_padding_matches_the_reference():
    rng = np.random.RandomState(0)
    cases = [
        {"x": rng.randn(5, 4).astype(np.float32), "y": rng.randn(5, 1).astype(np.float32)},
        {"x": np.ones((4, 2), np.float32)},
        {"x": np.ones((3, 2), np.float32), "sample_mask": np.array([1.0, 0.5, 1.0], np.float32)},
    ]
    for batch in cases:
        for buckets in [(4, 8), (4,), (8,)]:
            if max(b.shape[0] for b in batch.values()) > max(buckets):
                continue
            got, want = bk.pad_to_bucket(batch, buckets), jbk.pad_to_bucket(batch, buckets)
            assert got.keys() == want.keys()
            for key in want:
                np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
                assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype
    plain = rng.randn(3, 2).astype(np.float32)
    np.testing.assert_array_equal(bk.pad_to_bucket(plain, (4,)), jbk.pad_to_bucket(plain, (4,)))
    # tensors stay tensors, the mask on their device
    t = bk.pad_to_bucket({"x": torch.ones(3, 2)}, (4,))
    assert isinstance(t["sample_mask"], torch.Tensor) and t["x"].shape == (4, 2)
    np.testing.assert_array_equal(t["sample_mask"].numpy(), [1, 1, 1, 0])
    # the iterator, the spec and the errors
    batches = [{"x": np.ones((s, 2), np.float32)} for s in (8, 5, 3, 8, 1)]
    got = [b["x"].shape for b in bk.bucket_iterator(batches, (4, 8))]
    assert got == [b["x"].shape for b in jbk.bucket_iterator(batches, (4, 8))]
    spec = bk.bucket_spec(aot.abstract_spec(batches[1]), 8)
    jspec = jbk.bucket_spec(jaot.abstract_spec(batches[1]), 8)
    assert {k: (v.shape, str(v.dtype).replace("torch.", "")) for k, v in spec.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in jspec.items()}
    for fn, args in [("pad_to_bucket", ({"x": np.ones((9, 2), np.float32)}, (4, 8))),
                     ("pad_to_bucket", ({"x": np.ones((3, 2), np.float32), "y": np.ones((4,), np.float32)}, (8,))),
                     ("resolve_buckets", ([],)), ("resolve_buckets", ([0, 4],))]:
        with pytest.raises(ValueError) as want_err:
            getattr(jbk, fn)(*args)
        with pytest.raises(ValueError) as got_err:
            getattr(bk, fn)(*args)
        assert str(got_err.value) == str(want_err.value)
    assert bk.resolve_buckets([8, 4, 8]) == jbk.resolve_buckets([8, 4, 8]) == (4, 8)
    assert bk.bucket_for(5, (4, 8)) == jbk.bucket_for(5, (4, 8)) == 8


def test_masked_reductions_and_gradients_match_the_reference_and_the_unpadded_batch():
    rng = np.random.RandomState(0)
    w0 = rng.randn(4, 1).astype(np.float32)
    x, y = rng.randn(5, 4).astype(np.float32), rng.randn(5, 1).astype(np.float32)
    padded = bk.pad_to_bucket({"x": x, "y": y}, (8,))

    def port(xb, yb, mask=None):
        w = torch.from_numpy(w0).requires_grad_()
        per = ((torch.from_numpy(xb) @ w - torch.from_numpy(yb)) ** 2).sum(-1)
        loss = per.mean() if mask is None else bk.masked_mean(per, torch.from_numpy(mask))
        loss.backward()
        return float(loss), w.grad.numpy()

    def ref(w):
        per = jnp.sum((jnp.asarray(padded["x"]) @ w - jnp.asarray(padded["y"])) ** 2, axis=-1)
        return jbk.masked_mean(per, jnp.asarray(padded["sample_mask"]))

    l_plain, g_plain = port(x, y)
    l_masked, g_masked = port(padded["x"], padded["y"], padded["sample_mask"])
    j_loss, j_grad = jax.value_and_grad(ref)(jnp.asarray(w0))
    np.testing.assert_allclose(l_masked, l_plain, rtol=1e-6)
    np.testing.assert_allclose(g_masked, g_plain, rtol=1e-6)
    np.testing.assert_allclose(l_masked, float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(g_masked, np.asarray(j_grad), rtol=1e-6)
    vals, mask = rng.randn(6, 3).astype(np.float32), np.array([1, 1, 1, 1, 0, 0], np.float32)
    np.testing.assert_allclose(float(bk.masked_sum(torch.from_numpy(vals), mask)),
                               float(jbk.masked_sum(jnp.asarray(vals), jnp.asarray(mask))), rtol=1e-6)
    np.testing.assert_allclose(float(bk.masked_mean(torch.from_numpy(vals), mask)),
                               float(jbk.masked_mean(jnp.asarray(vals), jnp.asarray(mask))), rtol=1e-6)


def test_specs_signatures_and_the_divisibility_error(mesh8):
    from torch.distributed.tensor import Replicate, Shard

    batch = {"x": np.zeros((4, 3), np.float32), "n": np.int32(7)}
    spec = aot.abstract_spec(batch)
    jspec = jaot.abstract_spec(batch)
    assert spec["x"].shape == jspec["x"].shape and spec["x"].dtype == torch.float32
    assert aot.signature_of((batch,)) == aot.signature_of((spec,))
    assert aot.signature_of((batch,)) == aot.signature_of(({"x": torch.zeros(4, 3), "n": np.int32(7)},))
    assert aot.signature_of((batch,)) != aot.signature_of(({"x": np.zeros((8, 3), np.float32), "n": 7},))
    assert aot.signature_of((torch.zeros(2),)) != aot.signature_of((torch.zeros(2, dtype=torch.float64),))
    shard, rep = aot.TensorSpec((4,), torch.float32, (Shard(0),)), aot.TensorSpec((4,), torch.float32, (Replicate(),))
    assert len({aot.signature_of((s,)) for s in (shard, rep, aot.TensorSpec((4,), torch.float32))}) == 3
    # the global batch of two data-parallel processes, and the reference's error
    g = aot.global_batch_spec({"x": np.zeros((6, 2), np.float32)}, {"data": 2, "model": 2})
    assert g["x"].shape == (12, 2) and g["x"].placements == (Shard(0), Replicate())
    bad = {"x": aot.TensorSpec((6, 2), torch.float32)}
    with pytest.raises(ValueError) as got:
        aot.validate_global_batch_spec(bad, {"data": 8})
    with pytest.raises(ValueError) as want:
        jaot.validate_global_batch_spec({"x": jax.ShapeDtypeStruct((6, 2), np.float32)}, mesh8)
    assert str(got.value) == str(want.value)
    aot.validate_global_batch_spec({"x": aot.TensorSpec((16, 2), torch.float32)}, {"data": 8})


def test_a_dtensor_spec_warms_zeros_of_its_layout():
    """A DTensor input's spec keeps its mesh, and its zeros are a DTensor of
    the same placements, so the precompiled signature is the one a call with
    the DTensor matches; a process's batch rows stay a plain spec."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from dmlcloud_tpu_torch.parallel import mesh as tmesh
    from dmlcloud_tpu_torch.parallel import runtime

    runtime.init_single()
    try:
        mesh = tmesh.create_mesh({"fsdp": 1}, device="cpu")
        x = distribute_tensor(torch.randn(4, 3), mesh, [Shard(0)])
        batch = {"x": x, "rows": np.zeros((2, 5), np.int64)}
        spec = aot.abstract_spec(batch)
        assert spec["x"].placements == (Shard(0),) and spec["x"].mesh is mesh and spec["rows"].placements is None
        zeros = aot._zeros(spec, "cpu")
        assert isinstance(zeros["x"], DTensor) and zeros["x"].placements == (Shard(0),)
        assert not zeros["x"].to_local().any() and zeros["rows"].dtype == torch.int64
        assert aot.signature_of((zeros,)) == aot.signature_of((spec,)) == aot.signature_of((batch,))
        step = aot.PrecompiledStep(lambda b: b["x"].to_local().sum() + b["rows"].sum(), name="dt", compile=False)
        step.precompile(spec, device="cpu")
        step({"x": x, "rows": torch.zeros(2, 5, dtype=torch.int64)})
        assert step.signatures == 1 and step.recompiles == 0
        with pytest.raises(ValueError, match="needs its DeviceMesh"):
            aot._zeros(aot.TensorSpec((4,), torch.float32, (Shard(0),)), "cpu")
    finally:
        runtime.deinitialize()


def test_cache_resolution_order_and_stats_keys(tmp_path, monkeypatch):
    for var in (cache_lib.ENV_VAR, cache_lib.INDUCTOR_ENV_VAR):
        monkeypatch.delenv(var, raising=False)
    assert cache_lib.resolve_cache_dir(None) is None and cache_lib.resolve_cache_dir(False) is None
    assert cache_lib.resolve_cache_dir(str(tmp_path / "explicit")) == str(tmp_path / "explicit")
    assert cache_lib.resolve_cache_dir(True) == os.path.expanduser(cache_lib.DEFAULT_CACHE_DIR)
    monkeypatch.setenv(cache_lib.INDUCTOR_ENV_VAR, str(tmp_path / "inductor"))
    assert cache_lib.resolve_cache_dir(True) == str(tmp_path / "inductor")
    monkeypatch.setenv(cache_lib.ENV_VAR, str(tmp_path / "from-env"))
    assert cache_lib.resolve_cache_dir(True) == str(tmp_path / "from-env")
    assert cache_lib.resolve_cache_dir(str(tmp_path / "explicit")) == str(tmp_path / "explicit")
    resolved = cache_lib.configure_cache(True)
    assert resolved == str(tmp_path / "from-env") and os.path.isdir(resolved)
    assert os.environ[cache_lib.INDUCTOR_ENV_VAR] == resolved
    stats = cache_lib.cache_stats()
    assert set(stats) == set(jcache.cache_stats())
    assert stats["enabled"] and stats["dir"] == resolved and stats["entries"] == 0


def test_inductor_cache_turns_the_second_precompile_into_a_hit(tmp_path, monkeypatch):
    """The one Inductor compilation of this file: a fresh compilation of the
    same function after Dynamo's reset is served by the FX-graph and
    AOTAutograd caches, which the precompile accounts as a hit."""
    monkeypatch.setattr(aot, "BACKEND", "inductor")
    monkeypatch.setenv(cache_lib.INDUCTOR_ENV_VAR, str(tmp_path / "inductor"))  # restored after the test
    cache_lib.configure_cache(str(tmp_path / "inductor"))
    cache_lib.reset_process_stats()
    w = torch.randn(8, 1, requires_grad=True)

    def loss(x):
        return (torch.tanh(x @ w) * 3).square().mean()

    def precompiled(name):
        region = aot.compile_region(loss, name)  # a fresh code object: Dynamo traces anew
        return aot.PrecompiledStep(lambda x: region(x).backward(), name=name, compile=False)

    spec = aot.TensorSpec((4, 8), torch.float32)
    precompiled("cold").precompile(spec)
    first = cache_lib.cache_stats()
    precompiled("warm").precompile(spec)
    second = cache_lib.cache_stats()
    assert first["aot_misses"] == 1 and first["aot_hits"] == 0 and first["entries"] > 0
    assert second["aot_hits"] == 1 and second["aot_misses"] == 1
    assert second["entries"] == first["entries"]


def test_precompiled_step_registry_counts_recompiles_and_raises_at_the_limit():
    ps = aot.PrecompiledStep(lambda x: x * 2, name="double", recompile_limit=2)
    assert ps.precompile(aot.TensorSpec((4,), torch.float32)) > 0.0 and ps.signatures == 1
    assert ps.precompile(aot.TensorSpec((4,), torch.float32)) == 0.0  # idempotent
    np.testing.assert_array_equal(ps(torch.arange(4.0)).numpy(), [0, 2, 4, 6])
    assert ps.pop_recompiles() == 0  # matched the precompiled signature
    np.testing.assert_array_equal(ps(torch.arange(8.0)).numpy(), np.arange(8) * 2)
    assert ps._cache_size() == 2 and ps.pop_recompiles() == 1  # a new signature counted once ...
    ps(torch.arange(8.0))
    assert ps.pop_recompiles() == 0  # ... and only once
    assert ps.recompile_limit == aot.RECOMPILE_LIMIT
    small = aot.PrecompiledStep(lambda x: x + 1, name="small")
    small.recompile_limit = 2
    small(torch.zeros(1))
    small(torch.zeros(2))
    with pytest.raises(Exception, match="recompile_limit"):
        small(torch.zeros(3))  # never a silent drop to eager
