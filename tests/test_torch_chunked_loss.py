"""``chunked_lm_loss`` and ``DecoderLM(return_hidden=True)`` of the port
against the JAX package's, on the CPU.

The same numpy hidden states, LM-head kernel, tokens and packed segment ids
go to the reference's ``chunked_lm_loss`` (under ``jax.value_and_grad``) and
the port's (under autograd), with a vocab that the chunk does not divide (the
tail chunk) and one it does; value and gradients must agree at fp32
tolerance, and the port's chunked loss must equal its own ``lm_loss`` on the
materialised logits. The vocab-parallel form (``tp=``) runs across processes
in tests/test_torch_fsdp.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu_torch.models import transformer as ttr

torch.set_num_threads(2)

#: fp32, as tests/test_kernel_numerics.py holds fp32 kernels
TOL = dict(rtol=5e-5, atol=5e-5)
B, T, D = 2, 24, 32


def _inputs(vocab: int, seed: int = 0, packed: bool = False):
    rng = np.random.RandomState(seed)
    hidden = rng.randn(B, T, D).astype(np.float32)
    kernel = (rng.randn(D, vocab) / np.sqrt(D)).astype(np.float32)
    tokens = rng.randint(0, vocab, (B, T)).astype(np.int32)
    seg = None
    if packed:
        seg = np.zeros((B, T), np.int32)
        seg[0, :10], seg[0, 10:20] = 1, 2  # two segments and 4 pad slots
        seg[1, :] = 1
    return hidden, kernel, tokens, seg


@pytest.mark.parametrize("vocab,chunk", [(200, 64), (256, 64), (97, 128)])
@pytest.mark.parametrize("packed", [False, True])
def test_chunked_loss_matches_the_reference_in_value_and_gradient(vocab, chunk, packed):
    hidden, kernel, tokens, seg = _inputs(vocab, packed=packed)

    def ref(h, k):
        return jtr.chunked_lm_loss(h, k, jnp.asarray(tokens), vocab_chunk=chunk,
                                   segment_ids=None if seg is None else jnp.asarray(seg))

    want, (want_dh, want_dk) = jax.value_and_grad(ref, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(kernel))
    h = torch.from_numpy(hidden).requires_grad_(True)
    k = torch.from_numpy(kernel).requires_grad_(True)
    got = ttr.chunked_lm_loss(h, k, torch.from_numpy(tokens), vocab_chunk=chunk,
                              segment_ids=None if seg is None else torch.from_numpy(seg))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(want_dh), **TOL)
    np.testing.assert_allclose(k.grad.numpy(), np.asarray(want_dk), **TOL)

    # and the port's own lm_loss on the materialised logits
    h2 = torch.from_numpy(hidden).requires_grad_(True)
    k2 = torch.from_numpy(kernel).requires_grad_(True)
    dense = ttr.lm_loss(h2 @ k2, torch.from_numpy(tokens), segment_ids=None if seg is None else torch.from_numpy(seg))
    dense.backward()
    np.testing.assert_allclose(float(got.detach()), float(dense.detach()), **TOL)
    np.testing.assert_allclose(h.grad.numpy(), h2.grad.numpy(), **TOL)
    np.testing.assert_allclose(k.grad.numpy(), k2.grad.numpy(), **TOL)


@pytest.mark.parametrize("tie", [False, True])
def test_return_hidden_matches_the_reference_and_feeds_the_chunked_loss(tie):
    kw = dict(vocab_size=300, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16, hidden_dim=64, mlp_dim=160,
              max_seq_len=T, tie_embeddings=tie)
    jmodel = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **kw))
    tokens = np.random.RandomState(1).randint(0, 300, (B, T)).astype(np.int32)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(2), jnp.asarray(tokens))["params"])
    want = np.asarray(jmodel.apply({"params": tree}, jnp.asarray(tokens), return_hidden=True))

    model = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **kw), device="cpu")
    ttr.load_flax_params(model, tree)
    toks = torch.from_numpy(tokens)
    hidden = model(toks, return_hidden=True)
    np.testing.assert_allclose(hidden.detach().numpy(), want, **TOL)
    kernel, tp = ttr.lm_head_kernel(model)
    assert tp is None and tuple(kernel.shape) == (64, 300)
    chunked = ttr.chunked_lm_loss(hidden, kernel, toks, vocab_chunk=128)
    np.testing.assert_allclose(float(chunked.detach()), float(ttr.lm_loss(model(toks), toks).detach()), **TOL)
