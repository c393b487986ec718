"""The port's DecoderLM against the JAX package's, on the CPU.

A tiny model (2 layers, 4/2 heads, head_dim 16, hidden 64, mlp 160, vocab
512, T 64) is initialised by the JAX package; its params go into the port
through ``load_flax_params``. Logits and the gradient of every parameter under
``lm_loss`` must then agree within 1e-4 (atol and rtol) in fp32. For the bf16
model, logits and loss agree within ``TOL[bf16]`` of
tests/test_kernel_numerics.py and each gradient within a norm-relative bound.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu_torch.models import transformer as ttr

torch.set_num_threads(2)

TINY = dict(vocab_size=512, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16, hidden_dim=64, mlp_dim=160,
            max_seq_len=64)
FP32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=6e-2, rtol=6e-2)  # tests/test_kernel_numerics.py:28
#: bf16 gradients, per leaf: ||port - jax|| / ||jax||, and the leaf norms' ratio.
#: Each bf16 side lies up to 2.7e-2 (norm-relative) from the fp32 gradients, and
#: the two lie up to 1.9e-2 from each other, with norms within 0.3 %.
BF16_GRAD_REL = 3e-2
BF16_GRAD_NORM_REL = 1e-2
LLAMA3 = ("llama3", 8.0, 1.0, 4.0, 32)


def _tokens(b=2, t=64, seed=0):
    return np.random.RandomState(seed).randint(0, TINY["vocab_size"], (b, t)).astype(np.int32)


def _segment_ids(b=2, t=64):
    seg = np.zeros((b, t), np.int32)
    seg[0, :20], seg[0, 20:45], seg[0, 45:60] = 1, 2, 3  # last 4 slots padding
    seg[1, :33], seg[1, 33:] = 1, 2
    return seg


def _models(dtype="fp32", **cfg_kw):
    jcfg = jtr.TransformerConfig(dtype=jnp.float32 if dtype == "fp32" else jnp.bfloat16, **TINY, **cfg_kw)
    jmodel = jtr.DecoderLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(_tokens()))["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    tcfg = ttr.TransformerConfig(dtype=torch.float32 if dtype == "fp32" else torch.bfloat16, **TINY, **cfg_kw)
    tmodel = ttr.load_flax_params(ttr.DecoderLM(tcfg, device="cpu"), tree)
    return jmodel, params, tmodel


def _jax_logits_and_grads(jmodel, params, tokens, seg):
    seg_j = None if seg is None else jnp.asarray(seg)

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(tokens), segment_ids=seg_j)
        return jtr.lm_loss(logits, jnp.asarray(tokens), segment_ids=seg_j), logits

    (value, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return float(value), np.asarray(logits), jax.tree_util.tree_map(np.asarray, grads)


def _port_logits_and_grads(tmodel, tokens, seg):
    tok = torch.from_numpy(tokens)
    seg_t = None if seg is None else torch.from_numpy(seg)
    tmodel.zero_grad(set_to_none=True)
    logits = tmodel(tok, segment_ids=seg_t)
    loss = ttr.lm_loss(logits, tok, segment_ids=seg_t)
    loss.backward()
    grad_model = copy.deepcopy(tmodel)
    with torch.no_grad():
        for p, src in zip(grad_model.parameters(), tmodel.parameters()):
            p.copy_(src.grad)
    return loss.item(), logits.detach().float().numpy(), ttr.to_flax_params(grad_model)


CASES = {
    "dot": dict(attn_impl="dot"),
    "flash": dict(attn_impl="flash"),
    "dot-window16": dict(attn_impl="dot", sliding_window=16),
    "flash-window16": dict(attn_impl="flash", sliding_window=16),
    "dot-packed": dict(attn_impl="dot", packed=True),
    "flash-packed": dict(attn_impl="flash", packed=True),
    "flash-packed-window16": dict(attn_impl="flash", sliding_window=16, packed=True),
    "flash-llama3-rope": dict(attn_impl="flash", rope_scaling=LLAMA3),
    "flash-remat": dict(attn_impl="flash", remat=True),
    "dot-linear-rope-tied": dict(attn_impl="dot", rope_scaling=("linear", 4.0), tie_embeddings=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_and_grads_match_jax_fp32(case):
    kw = dict(CASES[case])
    seg = _segment_ids() if kw.pop("packed", False) else None
    jmodel, params, tmodel = _models(**kw)
    tokens = _tokens()
    j_loss, j_logits, j_grads = _jax_logits_and_grads(jmodel, params, tokens, seg)
    t_loss, t_logits, t_grads = _port_logits_and_grads(tmodel, tokens, seg)
    np.testing.assert_allclose(t_logits, j_logits, **FP32_TOL)
    np.testing.assert_allclose(t_loss, j_loss, **FP32_TOL)
    flat_j = jax.tree_util.tree_flatten_with_path(j_grads)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(t_grads)[0])
    assert len(flat_j) == len(flat_t)
    for path, g in flat_j:
        np.testing.assert_allclose(flat_t[path], g, err_msg=jax.tree_util.keystr(path), **FP32_TOL)


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_logits_and_grads_match_jax_bf16(impl):
    """bf16 activations, fp32 params: operands rounded per call on both sides."""
    jmodel, params, tmodel = _models(dtype="bf16", attn_impl=impl)
    tokens = _tokens()
    j_loss, j_logits, j_grads = _jax_logits_and_grads(jmodel, params, tokens, None)
    t_loss, t_logits, t_grads = _port_logits_and_grads(tmodel, tokens, None)
    np.testing.assert_allclose(t_logits, j_logits, **BF16_TOL)
    np.testing.assert_allclose(t_loss, j_loss, **BF16_TOL)
    # gradients are ~1e-2 in size, so TOL[bf16] would hold them to nothing: each
    # leaf is held to a norm-relative bound instead
    for (path, g), (_, t) in zip(jax.tree_util.tree_flatten_with_path(j_grads)[0],
                                 jax.tree_util.tree_flatten_with_path(t_grads)[0]):
        g_norm = np.linalg.norm(g)
        assert np.linalg.norm(t - g) <= BF16_GRAD_REL * g_norm, jax.tree_util.keystr(path)
        assert abs(np.linalg.norm(t) / g_norm - 1) <= BF16_GRAD_NORM_REL, jax.tree_util.keystr(path)


def test_weights_round_trip_through_both_conversions():
    _, params, tmodel = _models()
    tree = jax.tree_util.tree_map(np.asarray, params)
    back = ttr.to_flax_params(tmodel)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                 jax.tree_util.tree_flatten_with_path(back)[0]):
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    fresh = ttr.DecoderLM(tmodel.cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    ttr.load_flax_params(fresh, back)
    for (name, p), q in zip(tmodel.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(p, q), name


def test_load_flax_params_rejects_a_mismatched_tree():
    _, params, tmodel = _models()
    tree = jax.tree_util.tree_map(np.asarray, params)
    tree["layer_0"]["mlp"]["up_proj"]["kernel"] = tree["layer_0"]["mlp"]["up_proj"]["kernel"][:, :8]
    with pytest.raises(ValueError, match="up_proj"):
        ttr.load_flax_params(tmodel, tree)


@pytest.mark.parametrize("scaling", [None, ("linear", 4.0), LLAMA3], ids=["none", "linear", "llama3"])
def test_rope_tables_and_interleaved_rotation(scaling):
    j_cos, j_sin = jtr.rope_frequencies(16, 64, 10000.0, scaling)
    t_cos, t_sin = ttr.rope_frequencies(16, 64, 10000.0, scaling)
    np.testing.assert_allclose(t_cos.numpy(), np.asarray(j_cos), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(t_sin.numpy(), np.asarray(j_sin), atol=1e-6, rtol=1e-6)
    x = np.random.RandomState(1).randn(2, 64, 4, 16).astype(np.float32)
    positions = np.tile(np.arange(64) % 23, (2, 1)).astype(np.int32)
    for kw_j, kw_t in [({}, {}), ({"positions": jnp.asarray(positions)}, {"positions": torch.from_numpy(positions)})]:
        want = np.asarray(jtr.apply_rope(jnp.asarray(x), j_cos, j_sin, **kw_j))
        got = ttr.apply_rope(torch.from_numpy(x), t_cos, t_sin, **kw_t).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_dot_attention_and_rmsnorm_match_jax():
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, 24, h, 16).astype(np.float32) for h in (4, 2, 2))
    mask = np.tril(np.ones((24, 24), bool)) & (np.arange(24)[:, None] - np.arange(24)[None] < 5)
    for kw_j, kw_t in [({}, {}), ({"mask": jnp.asarray(mask)}, {"mask": torch.from_numpy(mask)})]:
        want = np.asarray(jtr._dot_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw_j))
        got = ttr._dot_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw_t).numpy()
        np.testing.assert_allclose(got, want, **FP32_TOL)
    x = rng.randn(3, 5, 64).astype(np.float32) * 3
    scale = rng.randn(64).astype(np.float32)
    want = np.asarray(jtr.RMSNorm().apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x, jnp.bfloat16)),
                      np.float32)
    norm = ttr.RMSNorm(64, device="cpu")
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
    got = norm(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(), want, **BF16_TOL)


def test_lm_loss_and_packed_mean_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 64, 512).astype(np.float32)
    tokens, seg = _tokens(), _segment_ids()
    for s in (None, seg):
        want = float(jtr.lm_loss(jnp.asarray(logits), jnp.asarray(tokens), None if s is None else jnp.asarray(s)))
        got = ttr.lm_loss(torch.from_numpy(logits), torch.from_numpy(tokens), None if s is None else torch.from_numpy(s))
        np.testing.assert_allclose(got.item(), want, **FP32_TOL)


def test_config_refuses_paths_of_later_slices():
    # ring attention is ported (tests/test_torch_ring_attention.py); an unknown impl still raises
    assert ttr.TransformerConfig(attn_impl="ring").seq_axis == "seq"
    with pytest.raises(ValueError, match="'dot', 'flash' or 'ring'"):
        ttr.TransformerConfig(attn_impl="paged")
    # MoE blocks are ported (tests/test_torch_moe.py): the field is accepted, and
    # num_experts=0 (the default) builds the dense model, parameter for parameter
    assert ttr.TransformerConfig(num_experts=4).is_moe(1) and not ttr.TransformerConfig(num_experts=4).is_moe(0)
    tiny = dict(vocab_size=32, num_layers=2, num_heads=2, head_dim=8, hidden_dim=16, mlp_dim=32, max_seq_len=16)
    dense = ttr.DecoderLM(ttr.TransformerConfig(**tiny), device="cpu")
    zero = ttr.DecoderLM(ttr.TransformerConfig(num_experts=0, **tiny), device="cpu")
    assert [(n, p.shape) for n, p in dense.named_parameters()] == [(n, p.shape) for n, p in zero.named_parameters()]
    assert all(torch.equal(a, b) for a, b in zip(dense.parameters(), zero.parameters()))
    assert not any(hasattr(layer, "moe") for layer in zero.layers)
    with pytest.raises(ValueError):
        ttr.TransformerConfig(sliding_window=0)
