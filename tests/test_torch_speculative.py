"""The port's speculative decoding against the JAX package, on the CPU.

The reference's spec pair (``conftest.spec_models``: a 2-layer fp32 target and
an independent 1-layer draft, vocab 48) carried into the port by the bridge:

- greedy tokens and ``(rounds, advanced, accepted)`` equal the reference's
  ``speculative_generate``, and the tokens equal plain ``generate``'s: a random
  and a perfect draft, k in {1, 2, 4}, an eos early exit, a sliding-window
  target, an int8 target, ragged prompts;
- the length guard and the argument checks raise;
- ``return_cache``: the rewound tail zero, each kept slot a plain decode's of
  the same tokens (the prompt's bitwise, the decoded ones within 1e-5) and
  bitwise equal across two drafts;
- ``verify_proposals`` passes the reference's numpy-reference cases;
- sampled tokens (a seeded ``torch.Generator``) are distributed as
  target-only sampling, by the reference's statistical test;
- ``init_medusa_heads(lm_head_kernel=)`` and ``medusa_head_logits`` match the
  reference.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlcloud_tpu.models import quant as jq
from dmlcloud_tpu.models import speculative as jspec
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu_torch.models import generate as tgen
from dmlcloud_tpu_torch.models import quant as tq
from dmlcloud_tpu_torch.models import speculative as tspec
from dmlcloud_tpu_torch.models import transformer as ttr

torch.set_num_threads(2)


def _port(jmodel, params):
    cfg = ttr.TransformerConfig(**{f.name: getattr(jmodel.cfg, f.name) for f in dataclasses.fields(ttr.TransformerConfig)
                                   if f.name != "dtype"}, dtype=torch.float32)
    return ttr.load_flax_params(ttr.DecoderLM(cfg, device="cpu"), jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def pair(spec_models):
    target, tparams, draft, dparams = spec_models
    return spec_models, _port(target, tparams), _port(draft, dparams)


@functools.lru_cache(maxsize=None)
def _window_target():
    cfg = dataclasses.replace(
        jtr.TransformerConfig(vocab_size=48, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=8, hidden_dim=16,
                              mlp_dim=32, max_seq_len=96, dtype=jnp.float32), sliding_window=8)
    model = jtr.DecoderLM(cfg)
    return model, model.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"]


def _prompt(b, t, seed):
    return np.random.RandomState(seed).randint(0, 48, (b, t)).astype(np.int32)


def _ragged():
    rng = np.random.RandomState(8)
    prompt = rng.randint(1, 48, (3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[1, :4] = prompt[1, :4] = 0
    mask[2, :7] = prompt[2, :7] = 0
    return prompt, mask


# case -> (target, draft, prompt, max_new, k, extra keyword arguments)
CASES = ["random_k4", "perfect_k3", "k1", "k2", "eos", "window", "int8", "ragged"]


def _case(name, pair):
    (jt, jtp, jd, jdp), tt, td = pair
    random = (jt, jtp, tt), (jd, jdp, td)
    if name == "random_k4":
        return (*random, _prompt(3, 10, 1), 20, 4, {})
    if name == "perfect_k3":
        return (jt, jtp, tt), (jt, jtp, tt), _prompt(2, 6, 2), 16, 3, {}
    if name in ("k1", "k2"):
        return (*random, _prompt(2, 7, 3), 15, int(name[1]), {})
    if name == "eos":
        prompt = _prompt(2, 6, 4)
        eos = int(tgen.generate(tt, prompt, 14)[0, 2])  # a token that occurs early (greedy tokens are the reference's)
        return (*random, prompt, 14, 4, {"eos_id": eos})
    if name == "window":
        wt, wtp = _window_target()
        return (wt, wtp, _port(wt, wtp)), random[1], _prompt(2, 10, 6), 16, 3, {}
    if name == "int8":
        return (jt, jq.quantize_tree(jtp), tq.quantize_tree(tt)), random[1], _prompt(1, 8, 5), 8, 2, {}
    prompt, mask = _ragged()
    return (*random, prompt, 12, 3, {"prompt_mask": mask})


@pytest.mark.parametrize("name", CASES)
def test_greedy_tokens_and_counts_equal_the_references(name, pair):
    (jt, jtp, tt), (jd, jdp, td), prompt, max_new, k, kw = _case(name, pair)
    jkw = {key: jnp.asarray(v) if key == "prompt_mask" else v for key, v in kw.items()}
    want, wstats = jspec.speculative_generate(jt, jtp, jd, jdp, jnp.asarray(prompt), max_new_tokens=max_new, k=k,
                                              return_stats=True, **jkw)
    got, gstats = tspec.speculative_generate(tt, td, prompt, max_new, k=k, return_stats=True, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, w, what in zip(gstats, wstats, ("rounds", "advanced", "accepted")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
    # and the draft changed the cost, never the tokens
    plain = tgen.generate(tt, prompt, max_new, eos_id=kw.get("eos_id", -1), prompt_mask=kw.get("prompt_mask"))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    rounds, advanced, accepted = (s.numpy() for s in gstats)
    if name == "perfect_k3":
        np.testing.assert_array_equal(accepted, rounds * k)  # a perfect draft accepts every proposal
    elif name != "eos":
        np.testing.assert_array_equal(accepted, advanced - 1 - rounds)  # absent eos, the advance algebra


def test_length_guard_and_argument_checks(pair):
    _, tt, td = pair
    with pytest.raises(ValueError, match="max_seq_len"):
        tspec.speculative_generate(tt, td, np.zeros((1, 90), np.int32), 10, k=4)
    with pytest.raises(ValueError, match="k "):
        tspec.speculative_generate(tt, td, np.zeros((1, 4), np.int32), 4, k=0)
    with pytest.raises(ValueError, match="temperature"):
        tspec.speculative_generate(tt, td, np.zeros((1, 4), np.int32), 4, temperature=-1.0)


def _plain_cache(model, prompt_row, tokens, cache_len):
    """The cache of a plain decode of ``tokens`` after ``prompt_row``: a
    prefill, then one token per step, each step reading the whole cache as the
    speculative rounds do."""
    cache = tgen.init_cache(model.cfg, 1, cache_len, torch.float32, "cpu")
    t = len(prompt_row)
    _, cache = tgen.decode_step(model, torch.as_tensor(prompt_row).long()[None], cache, attend_len=t)
    for j, tok in enumerate(tokens):
        _, cache = tgen.decode_step(model, torch.tensor([[int(tok)]]), cache, offset=t + j, attend_len=cache_len)
    return cache


def test_return_cache_is_a_plain_decode_at_the_accepted_prefix(pair):
    """Every kept slot holds what a plain decode of the same tokens writes,
    and the rewound tail is zero. The prompt's slots are bitwise the plain
    prefill's; a decoded slot comes from a (k+1)-row verify pass where the
    plain decode runs one row, and the CPU's GEMMs round a row of a (k+1)-row
    product differently from a one-row product, so those are held to the
    caches' fp32 tolerance (``test_torch_generate.CACHE_TOL``) and, as the
    reference's own test holds them, bitwise across two drafts with
    different rejection patterns."""
    _, tt, td = pair
    k, max_new = 3, 12
    prompt = _prompt(2, 7, 12)
    t = prompt.shape[1]
    cache_len = t + max_new + k + 1
    toks, (_, advanced, _), (tcache, dcache) = tspec.speculative_generate(
        tt, td, prompt, max_new, k=k, return_stats=True, return_cache=True)
    toks_b, (_, advanced_b, _), (tcache_b, _) = tspec.speculative_generate(
        tt, tt, prompt, max_new, k=k, return_stats=True, return_cache=True)
    assert torch.equal(toks, toks_b)
    for row in range(2):
        valid = t + int(advanced[row]) - 1  # the final token's slot is rewound too
        common = min(valid, t + int(advanced_b[row]) - 1)
        fed = toks[row, : valid - t].numpy()
        for model, cache in ((tt, tcache), (td, dcache)):
            plain = _plain_cache(model, prompt[row], fed, cache_len)
            for name in plain:
                for key in ("k", "v"):
                    leaf, want = cache[name][key], plain[name][key][0]
                    assert tuple(leaf.shape) == (2, cache_len, 1, 8)
                    assert not leaf[row, valid:].any(), "stale tail not rewound"
                    assert torch.equal(leaf[row, :t], want[:t]), (row, name, key)
                    torch.testing.assert_close(leaf[row, :valid], want[:valid], atol=1e-5, rtol=1e-5)
                    if model is tt:
                        assert torch.equal(leaf[row, :common], tcache_b[name][key][row, :common]), (row, name, key)


def _verify_inputs(b=3, k=4, v=17, seed=0):
    rng = jax.random.PRNGKey(seed)
    tlogits = jax.random.normal(jax.random.fold_in(rng, 1), (b, k + 1, v)) * 2.0
    dlogits = jax.random.normal(jax.random.fold_in(rng, 2), (b, k, v)) * 2.0
    proposals = jax.random.randint(jax.random.fold_in(rng, 3), (b, k), 0, v)
    return np.asarray(tlogits), np.asarray(dlogits), np.asarray(proposals, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("case", ["greedy", "eos", "draft_is_target", "mixed"])
def test_verify_proposals_passes_the_references_cases(case):
    g = torch.Generator().manual_seed(7)
    if case == "greedy":
        b, k = 3, 4
        tl, dl, props = _verify_inputs(b, k)
        new, n_new, n_acc = tspec.verify_proposals(*_t(tl, dl, props), g, *_t(np.zeros(b, np.float32),
                                                   np.zeros(b, np.int32), np.ones(b, np.float32), np.full(b, -1)))
        for r in range(b):
            greedy = tl[r].argmax(-1)
            acc = 0
            while acc < k and props[r, acc] == greedy[acc]:
                acc += 1
            assert int(n_acc[r]) == acc and int(n_new[r]) == acc + 1
            np.testing.assert_array_equal(new[r, : acc + 1].numpy(), greedy[: acc + 1])
    elif case == "eos":
        b, k, v = 2, 3, 11
        tl = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (b, k + 1, v)) * 2.0)
        props = tl[:, :k].argmax(-1).astype(np.int32)  # full greedy acceptance
        # row 0's first token after the first one that has not come before (the
        # reference takes index 1; this draw repeats index 0's token there)
        j = next(i for i in range(1, k) if props[0, i] not in props[0, :i])
        eos0 = int(props[0, j])
        new, n_new, n_acc = tspec.verify_proposals(*_t(tl, np.zeros((b, k, v), np.float32), props), g, *_t(
            np.zeros(b, np.float32), np.zeros(b, np.int32), np.ones(b, np.float32), np.array([eos0, -1])))
        assert int(n_acc[0]) == k  # acceptance is eos-blind ...
        assert int(n_new[0]) == j + 1 and int(new[0, j]) == eos0  # ... but the advance stops at the eos
        assert int(n_new[1]) == k + 1
    elif case == "draft_is_target":
        b, k = 3, 4
        tl, _, _ = _verify_inputs(b, k)
        temp, topk, topp = torch.full((b,), 0.8), torch.zeros(b, dtype=torch.long), torch.ones(b)
        truncated = tgen._truncate_scaled(torch.from_numpy(tl[:, :k]).float(), temp, topk, topp)
        props = truncated.argmax(-1)
        _, n_new, n_acc = tspec.verify_proposals(torch.from_numpy(tl), truncated, props, g, temp, topk, topp,
                                                 torch.full((b,), -1))
        assert n_acc.tolist() == [k] * b and n_new.tolist() == [k + 1] * b
    else:
        b, k = 2, 3
        tl, dl, props = _verify_inputs(b, k, seed=4)
        new, n_new, n_acc = tspec.verify_proposals(*_t(tl, dl, props), g, *_t(np.array([0.0, 1.0], np.float32),
                                                   np.zeros(b, np.int32), np.ones(b, np.float32), np.full(b, -1)))
        greedy = tl[0].argmax(-1)
        acc = 0
        while acc < k and props[0, acc] == greedy[acc]:
            acc += 1
        assert int(n_acc[0]) == acc
        np.testing.assert_array_equal(new[0, : acc + 1].numpy(), greedy[: acc + 1])
        assert 0 <= int(n_acc[1]) <= k and 1 <= int(n_new[1]) <= k + 1


def test_sampled_tokens_are_distributed_as_target_sampling():
    """Rejection sampling with a different draft is distributed as target-only
    sampling: the marginals of the three generated tokens over many rows of
    one prompt, by the reference's total-variation bound, from seeded
    generators (deterministic, not flaky)."""
    vocab, n = 16, 1200

    def lm(layers, seed):
        cfg = ttr.TransformerConfig(vocab_size=vocab, num_layers=layers, num_heads=2, num_kv_heads=1, head_dim=8,
                                    hidden_dim=16, mlp_dim=32, max_seq_len=32, dtype=torch.float32)
        return ttr.DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))

    target, draft = lm(2, 11), lm(1, 12)
    prompt = np.tile(np.array([[3, 7, 1]], np.int32), (n, 1))
    spec = tspec.speculative_generate(target, draft, prompt, 3, k=2, temperature=1.0,
                                      generator=torch.Generator().manual_seed(0)).numpy()
    plain = tgen.generate(target, prompt, 3, temperature=1.0, generator=torch.Generator().manual_seed(1)).numpy()
    for pos in range(3):
        p_spec = np.bincount(spec[:, pos], minlength=vocab) / n
        p_plain = np.bincount(plain[:, pos], minlength=vocab) / n
        tv = 0.5 * np.abs(p_spec - p_plain).sum()
        assert tv < 0.12, (pos, tv, p_spec, p_plain)
    # one generator seed, one sample; another seed, another
    again = tspec.speculative_generate(target, draft, prompt[:8], 3, k=2, temperature=1.0,
                                       generator=torch.Generator().manual_seed(0)).numpy()
    other = tspec.speculative_generate(target, draft, prompt[:8], 3, k=2, temperature=1.0,
                                       generator=torch.Generator().manual_seed(5)).numpy()
    np.testing.assert_array_equal(again, spec[:8])
    assert not (again == other).all()


def test_medusa_heads_match_the_reference(pair):
    ((jt, jtp, _, _), _, _) = pair
    cfg = jt.cfg
    kernel = np.asarray(jtp["lm_head"]["kernel"])
    want = jspec.init_medusa_heads(cfg, 3, jax.random.PRNGKey(0), lm_head_kernel=jnp.asarray(kernel))
    got = tspec.init_medusa_heads(cfg, 3, lm_head_kernel=torch.from_numpy(kernel))
    for key in ("w1", "b1", "w2"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    # heads with weights everywhere, the same on both sides
    rng = np.random.RandomState(0)
    heads = {key: rng.randn(*np.asarray(want[key]).shape).astype(np.float32) * 0.3 for key in want}
    hidden = rng.randn(4, cfg.hidden_dim).astype(np.float32)
    np.testing.assert_allclose(
        tspec.medusa_head_logits({k: torch.from_numpy(v) for k, v in heads.items()}, torch.from_numpy(hidden)).numpy(),
        np.asarray(jspec.medusa_head_logits({k: jnp.asarray(v) for k, v in heads.items()}, jnp.asarray(hidden))),
        atol=5e-5, rtol=5e-5)
    empty = tspec.init_medusa_heads(cfg, 1, torch.Generator().manual_seed(0))
    assert tuple(tspec.medusa_head_logits(empty, torch.from_numpy(hidden)).shape) == (4, 0, cfg.vocab_size)
    assert tuple(tspec.init_medusa_heads(cfg, 2, torch.Generator().manual_seed(0))["w2"].shape) == (
        1, cfg.hidden_dim, cfg.vocab_size)
    with pytest.raises(ValueError, match="k"):
        tspec.init_medusa_heads(cfg, 0)
