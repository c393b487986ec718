"""The port's weight-only int8 decode against the JAX package, on the CPU.

A tiny ``DecoderLM`` (2 layers, hidden 64, 4/2 heads of 16, MLP 160, vocab
256) is initialised by the JAX package and carried into the port with
``load_flax_params``. Then:

- ``quantize``: ``q`` bytes and ``scale`` bits equal the reference's on
  ``[64, 32]`` and ``[64, 4, 16]`` kernels and on a kernel with a zero channel;
- ``quantize_tree`` quantizes the reference's flax paths with equal bytes, and
  a reference quantized tree loads into the port and dumps back unchanged;
- quantized logits within 5e-5 of the reference's ``apply`` in fp32 and
  6e-2 in bf16 (``tests/test_kernel_numerics.py:28``);
- int8 greedy ``generate`` and ``beam_search`` tokens identical to the
  reference's;
- ``prepare_decode_params``: fp32-widened kernels, decode bitwise the raw
  int8 model's; ``dequant_tree``/``widen_quant_tree``; ``quantized_size``;
- the fp32 ``ServeEngine`` over the int8 model token-identical to serial
  int8 ``generate``; the bf16 int8 GEMM refuses to run off CUDA.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlcloud_tpu.models import generate as jgen
from dmlcloud_tpu.models import lora as jlora
from dmlcloud_tpu.models import quant as jq
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu_torch.models import generate as tgen
from dmlcloud_tpu_torch.models import quant as tq
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.serve import ServeEngine

torch.set_num_threads(2)

TINY = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16, hidden_dim=64, mlp_dim=160,
            max_seq_len=48)
TOL = {"float32": dict(atol=5e-5, rtol=5e-5), "bfloat16": dict(atol=6e-2, rtol=6e-2)}


@functools.lru_cache(maxsize=None)
def _models(dtype: str = "float32"):
    jmodel = jtr.DecoderLM(jtr.TransformerConfig(dtype=getattr(jnp, dtype), **TINY))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    tmodel = ttr.DecoderLM(ttr.TransformerConfig(dtype=getattr(torch, dtype), **TINY), device="cpu")
    ttr.load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


def _is_qt(x):
    return isinstance(x, jq.QuantizedTensor)


def _flat(tree):
    """{path: leaf} of a tree whose leaves are arrays, reference
    ``QuantizedTensor``s or the port's ``{"q", "scale"}`` dicts."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict) and set(node) != {"q", "scale"}:
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        else:
            out[path] = node

    walk(tree, "")
    return out


def _qs(leaf):
    return (leaf.q, leaf.scale) if _is_qt(leaf) else (leaf["q"], leaf["scale"])


def _tokens(b, t, seed):
    return np.random.RandomState(seed).randint(0, 256, (b, t)).astype(np.int32)


@pytest.mark.parametrize("case", ["dense", "heads", "zero_channel"])
def test_quantize_bytes_equal_the_reference(case):
    rng = np.random.RandomState(0)
    if case == "dense":
        w = (rng.randn(64, 32) * np.logspace(-2, 0, 32)).astype(np.float32)  # per-channel ranges
    elif case == "heads":
        w = rng.randn(64, 4, 16).astype(np.float32)
    else:
        w = rng.randn(64, 32).astype(np.float32)
        w[:, 5] = 0.0
    want = jq.quantize(jnp.asarray(w))
    got = tq.quantize(torch.from_numpy(w))
    assert got.q.dtype == torch.int8 and tuple(got.scale.shape) == tuple(want.scale.shape)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy().view(np.uint32), np.asarray(want.scale).view(np.uint32))
    back = got.dequant(torch.float32).numpy()
    if case == "zero_channel":
        np.testing.assert_array_equal(back[:, 5], 0.0)
    # symmetric int8: error <= scale/2 per element
    assert (np.abs(back - w) <= np.abs(w).max(axis=0) / 127.0 / 2 + 1e-7).all()


def test_quantize_tree_takes_the_references_paths_and_bytes():
    _, params, tmodel = _models()
    want = _flat(jq.quantize_tree(params))
    qmodel = tq.quantize_tree(tmodel)
    got = _flat(ttr.to_flax_params(qmodel))
    assert sorted(got) == sorted(want)
    quantized = sorted(p for p, leaf in want.items() if _is_qt(leaf))
    assert quantized == sorted(p for p, leaf in got.items() if isinstance(leaf, dict))
    assert len(quantized) == 2 * 7 + 1 and "embed/embedding" not in quantized  # q/k/v/o, gate/up/down, lm_head
    for path, leaf in want.items():
        if _is_qt(leaf):
            for g, w in zip(_qs(got[path]), _qs(leaf)):
                assert g.dtype == np.asarray(w).dtype and g.shape == np.asarray(w).shape, path
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=path)
        else:
            np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=path)
    # the original keeps its fp32 weights; the copy shares what it did not quantize
    assert isinstance(tmodel.layers[0].attn.q_proj.weight, torch.nn.Parameter)
    assert qmodel.embed.weight is tmodel.embed.weight
    # a reference quantized tree loads into the port and dumps back with identical bytes
    loaded = ttr.load_flax_params(ttr.DecoderLM(tmodel.cfg, device="cpu"),
                                  jax.tree_util.tree_map(np.asarray, jq.quantize_tree(params)))
    again = _flat(ttr.to_flax_params(loaded))
    for path, leaf in want.items():
        for g, w in zip(_qs(again[path]), _qs(leaf)) if _is_qt(leaf) else [(again[path], leaf)]:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_logits_match_the_reference(dtype):
    jmodel, params, tmodel = _models(dtype)
    tokens = _tokens(2, 16, 2)
    want = np.asarray(jmodel.apply({"params": jq.quantize_tree(params)}, jnp.asarray(tokens)))
    got = tq.quantize_tree(tmodel)(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32  # the fp32 LM head
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL[dtype])
    # and int8 only perturbs the full-precision logits
    full = tmodel(torch.from_numpy(tokens).long()).detach().numpy()
    assert np.abs(got.detach().numpy() - full).max() / np.abs(full).max() < 0.05


def test_int8_greedy_and_beam_tokens_match_the_reference():
    jmodel, params, tmodel = _models()
    qparams, qmodel = jq.quantize_tree(params), tq.quantize_tree(tmodel)
    prompt = _tokens(3, 8, 1)
    want = np.asarray(jgen.generate(jmodel, qparams, jnp.asarray(prompt), max_new_tokens=12))
    np.testing.assert_array_equal(tgen.generate(qmodel, prompt, 12).numpy(), want)
    wt, ws = jgen.beam_search(jmodel, qparams, jnp.asarray(prompt[:2]), max_new_tokens=6, num_beams=3)
    gt, gs = tgen.beam_search(qmodel, prompt[:2], 6, num_beams=3)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5)


def test_prepare_decode_params_is_bitwise_the_raw_int8_model():
    _, _, tmodel = _models()
    qmodel = tq.quantize_tree(tmodel)
    prepared = tq.prepare_decode_params(qmodel, torch.float32)
    raw = [m.weight for m in qmodel.modules() if isinstance(getattr(m, "weight", None), tq.QuantizedTensor)]
    wide = [m.weight for m in prepared.modules() if isinstance(getattr(m, "weight", None), tq.QuantizedTensor)]
    assert len(raw) == len(wide) == 15
    for r, w in zip(raw, wide):
        assert r.q.dtype == torch.int8 and w.q.dtype == torch.float32  # the CPU's operand dtype, widened once
        assert torch.equal(w.q, r.q.float()) and w.scale is r.scale
    tokens = torch.from_numpy(_tokens(2, 10, 3)).long()
    assert torch.equal(prepared(tokens), qmodel(tokens))
    assert torch.equal(tgen.generate(prepared, tokens, 8), tgen.generate(qmodel, tokens, 8))
    # a model with nothing quantized is returned as it is
    assert tq.prepare_decode_params(tmodel) is tmodel and tq.widen_quant_tree(tmodel) is tmodel


def test_dequant_tree_rehydrates_and_keeps_what_it_is_told():
    jmodel, params, tmodel = _models()
    # a regex that also quantizes the embedding, as a custom matcher may
    qmodel = tq.quantize_tree(tmodel, match=r"embed|kernel")
    assert isinstance(qmodel.embed.weight, tq.QuantizedTensor)
    back = tq.dequant_tree(qmodel, torch.float32)
    assert not any(isinstance(m, tq.QuantizedTensor) for m in back.modules())
    want = jq.dequant_tree(jq.quantize_tree(params, match=lambda p, x: jlora.default_match(p, x) or "embed" in p),
                           jnp.float32)
    got = _flat(ttr.to_flax_params(back))
    for path, leaf in _flat(want).items():
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=path)
    # the decode preparation rehydrates only the non-kernel leaf, so generate runs
    kept = tq.dequant_tree(qmodel, torch.float32, keep=lambda p: p.endswith("kernel"))
    assert not isinstance(kept.embed.weight, tq.QuantizedTensor)
    assert isinstance(kept.lm_head.weight, tq.QuantizedTensor)
    assert tuple(tgen.generate(qmodel, _tokens(1, 4, 4), 3).shape) == (1, 3)


def test_quantized_size_equals_the_reference():
    _, params, tmodel = _models()
    assert tq.quantized_size(tq.quantize_tree(tmodel)) == jq.quantized_size(jq.quantize_tree(params))
    assert tq.quantized_size(tmodel) == jq.quantized_size(params)


def test_engine_over_the_int8_model_matches_serial_generate():
    _, _, tmodel = _models()
    qmodel = tq.quantize_tree(tmodel)
    engine = ServeEngine(qmodel, block_size=4, max_slots=2, prefill_chunk=8)
    # the engine prepares the weights once: on the CPU the kernels are widened
    assert engine.model is not qmodel and engine.model.lm_head.weight.q.dtype == torch.float32
    prompts = [_tokens(1, n, 10 + n)[0] for n in (5, 9, 12)]
    rids = [engine.submit(p, 6) for p in prompts]
    out = engine.run()
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(out[rid], tgen.generate(qmodel, p[None], 6)[0].numpy())
    assert engine.leaked_blocks() == 0


def test_the_bf16_int8_gemm_runs_on_cuda_only():
    qt = tq.quantize(torch.randn(16, 8))
    x = torch.randn(2, 16)
    # off CUDA the operands are fp32, as the reference's off-TPU branch
    np.testing.assert_array_equal(tq._fused_quant_dot(x, qt, torch.float32).numpy(),
                                  (x @ qt.q.float() * qt.scale).numpy())
    # a bf16 x bf16 -> fp32 GEMM off CUDA is refused, never rounded to bf16 first
    with pytest.raises(RuntimeError, match="CUDA"):
        tq._mm_f32(x.bfloat16(), qt.q.bfloat16())


def test_unfusible_scales_dequantize_locally_as_the_reference():
    """A kernel quantized with per-(head_dim) scales shared across heads
    (``num_input_axes=2`` on ``[D, H, hd]``: scale ``[1, 1, hd]``) is not
    fusible; both packages dequantize it locally before the dot."""
    jmodel, params, _ = _models()
    qparams = jq.quantize_tree(params)
    layer = dict(qparams["layer_1"])
    attn = dict(layer["attn"])
    attn["q_proj"] = {"kernel": jq.quantize(params["layer_1"]["attn"]["q_proj"]["kernel"], num_input_axes=2)}
    layer["attn"] = attn
    qparams = {**qparams, "layer_1": layer}
    assert attn["q_proj"]["kernel"].scale.shape == (1, 1, 16) and not jq._fusible(attn["q_proj"]["kernel"])
    tokens = _tokens(2, 12, 6)
    want = np.asarray(jmodel.apply({"params": qparams}, jnp.asarray(tokens)))
    tmodel = ttr.load_flax_params(ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **TINY), device="cpu"),
                                  jax.tree_util.tree_map(np.asarray, qparams))
    q = tmodel.layers[1].attn.q_proj.weight
    assert isinstance(q, tq.QuantizedTensor) and not tq._fusible(q)
    np.testing.assert_allclose(tmodel(torch.from_numpy(tokens).long()).detach().numpy(), want, **TOL["float32"])
