"""The port's decode path against the JAX package, on the CPU.

Tiny fp32 models (vocab 61, 2 layers, 4 heads of 8, hidden 32, MLP 64, with
and without GQA and a sliding window) are initialised by the JAX package and
carried into the port with ``load_flax_params``. Then:

- ``decode_step`` (dense, ``attend_len``, ``pad_len``, ``pages``, window,
  GQA): logits and caches within 1e-5 of the JAX ``decode_step``, step
  after step;
- ``rewind_cache``: bitwise the JAX function;
- ``generate`` greedy: token-identical to the JAX ``generate`` (GQA, a window,
  ragged left-padded prompts, eos/pad, a run across all decode chunks), and
  the guards raise where the reference's do;
- sampling: ``_truncate_scaled`` keeps and scales the logits the JAX function
  does; greedy rows of a mixed batch are an exact argmax; draws are
  deterministic under one ``torch.Generator`` (the tokens themselves cannot
  match ``jax.random``'s);
- ``beam_search``: tokens identical to JAX's and scores within 1e-5, with 1
  beam (equal to greedy) and 4, a length penalty, eos freezing and ragged rows;
- ``examples.generate_text`` greedy, sampled and with 2 beams on the CPU.
"""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlcloud_tpu.models import generate as jgen
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu_torch.models import generate as tgen
from dmlcloud_tpu_torch.models import transformer as ttr

torch.set_num_threads(2)

TINY = dict(vocab_size=61, num_layers=2, num_heads=4, head_dim=8, hidden_dim=32, mlp_dim=64, max_seq_len=64)
VARIANTS = {"mha": {}, "gqa": dict(num_kv_heads=2), "window": dict(num_kv_heads=2, sliding_window=4)}
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
#: the caches hold K and V after RoPE, from each package's own fp32 matmuls
#: (and, past layer 0, from the previous layer's attention): they agree to
#: ~1e-6, not bitwise, so they are held to the logits' tolerance
CACHE_TOL = LOGIT_TOL
SCORE_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _models(variant: str):
    kw = dict(TINY, **VARIANTS[variant])
    jmodel = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **kw))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    tmodel = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **kw), device="cpu")
    ttr.load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


def _prompt(b, t, seed=0):
    return np.random.RandomState(seed).randint(1, 61, (b, t)).astype(np.int32)


def _ragged(lengths, seed=11):
    """Left-padded rows of the given real lengths, and their keep-mask."""
    rng = np.random.RandomState(seed)
    t = max(lengths)
    batch, mask = np.zeros((len(lengths), t), np.int32), np.zeros((len(lengths), t), np.int32)
    rows = [rng.randint(1, 61, size=n).astype(np.int32) for n in lengths]
    for i, row in enumerate(rows):
        batch[i, t - len(row):], mask[i, t - len(row):] = row, 1
    return batch, mask, rows


def _check_cache(tcache, jcache):
    assert sorted(tcache) == sorted(jcache)
    for name in jcache:
        for key in ("k", "v"):
            np.testing.assert_allclose(tcache[name][key].numpy(), np.asarray(jcache[name][key]), **CACHE_TOL)


# ---------------------------------------------------------------------------
# decode_step
# ---------------------------------------------------------------------------

def _dense_calls(t, steps, pad_len=None, attend=False):
    """(tokens, kwargs) of a prefill over ``t`` prompt tokens and ``steps``
    single-token steps, as generate makes them."""
    calls = [(_prompt(2, t, seed=1), dict(offset=0, attend_len=t if attend else None, pad_len=pad_len))]
    for i in range(steps):
        calls.append((_prompt(2, 1, seed=10 + i), dict(offset=t + i, attend_len=t + i + 1 if attend else None,
                                                        pad_len=pad_len)))
    return calls


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mode", ["dense", "attend_len", "pad_len"])
def test_decode_step_dense_modes_match_the_reference(variant, mode):
    jmodel, params, tmodel = _models(variant)
    pad = np.asarray([3, 0], np.int32) if mode == "pad_len" else None
    jcache = jgen.init_cache(jmodel.cfg, 2, 16, dtype=jnp.float32)
    tcache = tgen.init_cache(tmodel.cfg, 2, 16, dtype=torch.float32, device="cpu")
    for tokens, kw in _dense_calls(7, 2, attend=mode == "attend_len"):
        jkw = dict(kw, pad_len=None if pad is None else jnp.asarray(pad))
        tkw = dict(kw, pad_len=None if pad is None else torch.from_numpy(pad).long())
        jlogits, jcache = jgen.decode_step(jmodel, params, jnp.asarray(tokens), jcache, **jkw)
        tlogits, tcache = tgen.decode_step(tmodel, torch.from_numpy(tokens).long(), tcache, **tkw)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **LOGIT_TOL)
        _check_cache(tcache, jcache)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_step_paged_matches_the_reference(variant):
    """Two rows through a 9-block pool of 4 slots: row 0 owns blocks 3, 1, 7;
    row 1 owns block 0 only (its fifth token falls on a sentinel entry and is
    dropped); a 5-token prefill, then two single-token steps."""
    jmodel, params, tmodel = _models(variant)
    cfg = tmodel.cfg
    shape = (9, 4, cfg.kv_heads, cfg.head_dim)
    jpool = {f"layer_{i}": {"k": jnp.zeros(shape), "v": jnp.zeros(shape)} for i in range(cfg.num_layers)}
    tpool = {f"layer_{i}": {"k": torch.zeros(shape), "v": torch.zeros(shape)} for i in range(cfg.num_layers)}
    tables = np.asarray([[3, 1, 7], [0, 9, 9]], np.int32)
    for tokens, fill in [(_prompt(2, 5, seed=2), [0, 0]), (_prompt(2, 1, seed=3), [5, 5]),
                         (_prompt(2, 1, seed=4), [6, 6])]:
        fill = np.asarray(fill, np.int32)
        jlogits, jpool = jgen.decode_step(jmodel, params, jnp.asarray(tokens), jpool,
                                          pages=(jnp.asarray(tables), jnp.asarray(fill)))
        tlogits, tpool = tgen.decode_step(tmodel, torch.from_numpy(tokens).long(), tpool,
                                          pages=(torch.from_numpy(tables).long(), torch.from_numpy(fill).long()))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **LOGIT_TOL)
        _check_cache(tpool, jpool)


def test_return_hidden_with_a_cache_matches_the_reference():
    jmodel, params, tmodel = _models("gqa")
    tokens = _prompt(2, 5)
    (jl, jh), _ = jgen.decode_step(jmodel, params, jnp.asarray(tokens), jgen.init_cache(jmodel.cfg, 2, 8,
                                   dtype=jnp.float32), return_hidden=True)
    (tl, th), _ = tgen.decode_step(tmodel, torch.from_numpy(tokens).long(),
                                   tgen.init_cache(tmodel.cfg, 2, 8, dtype=torch.float32, device="cpu"),
                                   return_hidden=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **LOGIT_TOL)


def test_attend_len_bounds_cache_reads():
    """Slots past ``attend_len`` are never read: a NaN-poisoned tail leaves
    the logits finite and equal to the clean cache's; the returned cache is
    the whole buffer."""
    _, _, tmodel = _models("mha")
    prompt = torch.from_numpy(_prompt(2, 8)).long()
    clean, _ = tgen.decode_step(tmodel, prompt, tgen.init_cache(tmodel.cfg, 2, 32, torch.float32, "cpu"), attend_len=8)
    poisoned = tgen.init_cache(tmodel.cfg, 2, 32, torch.float32, "cpu")
    for layer in poisoned.values():
        for x in layer.values():
            x[:, 8:] = float("nan")
    got, cache = tgen.decode_step(tmodel, prompt, poisoned, attend_len=8)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), clean.numpy(), rtol=1e-6, atol=1e-6)
    assert cache["layer_0"]["k"].shape[1] == 32


def test_decode_mode_guards_raise_as_the_reference_does():
    _, _, tmodel = _models("mha")
    tok = torch.zeros(1, 3, dtype=torch.long)
    cache = tgen.init_cache(tmodel.cfg, 1, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="pad_len"):
        tmodel(tok, pad_len=torch.zeros(1, dtype=torch.long))
    with pytest.raises(ValueError, match="attend_len"):
        tmodel(tok, attend_len=3)
    with pytest.raises(ValueError, match="requires the pool cache"):
        tmodel(tok, pages=(torch.zeros(1, 1, dtype=torch.long), torch.zeros(1, dtype=torch.long)))
    with pytest.raises(ValueError, match="pages replaces"):
        tmodel(tok, cache=cache, attend_len=3, pages=(torch.zeros(1, 1, dtype=torch.long),
                                                      torch.zeros(1, dtype=torch.long)))
    with pytest.raises(ValueError, match="packed-training"):
        tmodel(tok, cache=cache, segment_ids=torch.ones(1, 3, dtype=torch.long))
    with pytest.raises(ValueError, match="past the cache"):
        tmodel(tok, cache=cache, offset=6)


def test_rewind_cache_is_bitwise_the_reference():
    rng = np.random.RandomState(0)
    host = {"layer_0": {"k": rng.randn(2, 16, 1, 4).astype(np.float32), "v": rng.randn(2, 16, 1, 4).astype(np.float32)}}
    jcache = jax.tree_util.tree_map(jnp.asarray, host)
    tcache = {n: {k: torch.from_numpy(x.copy()) for k, x in layer.items()} for n, layer in host.items()}
    for fill in ([5, 11], 3, [0, 16]):
        want = jgen.rewind_cache(jcache, jnp.asarray(fill))
        got = tgen.rewind_cache(tcache, torch.tensor(fill) if isinstance(fill, list) else fill)
        for key in ("k", "v"):
            np.testing.assert_array_equal(got["layer_0"][key].numpy(), np.asarray(want["layer_0"][key]))
            np.testing.assert_array_equal(tcache["layer_0"][key].numpy(), host["layer_0"][key])  # not in place


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

def _greedy_pair(variant, prompt, n, **kw):
    jmodel, params, tmodel = _models(variant)
    jkw = dict(kw)
    if "prompt_mask" in jkw:
        jkw["prompt_mask"] = jnp.asarray(jkw["prompt_mask"])
    want = np.asarray(jgen.generate(jmodel, params, jnp.asarray(prompt), n, **jkw))
    got = tgen.generate(tmodel, prompt, n, **kw).numpy()
    return got, want


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_greedy_generate_is_token_identical(variant):
    got, want = _greedy_pair(variant, _prompt(2, 7), 10)
    np.testing.assert_array_equal(got, want)


def test_greedy_ragged_left_padded_rows_are_token_identical_and_unpadded():
    batch, mask, rows = _ragged([5, 9])
    got, want = _greedy_pair("gqa", batch, 6, prompt_mask=mask)
    np.testing.assert_array_equal(got, want)
    _, _, tmodel = _models("gqa")
    for i, row in enumerate(rows):  # each row decodes as it would unpadded
        np.testing.assert_array_equal(got[i], tgen.generate(tmodel, row[None], 6).numpy()[0])


def test_greedy_windowed_ragged_rows_are_token_identical():
    batch, mask, _ = _ragged([3, 7], seed=12)
    got, want = _greedy_pair("window", batch, 5, prompt_mask=mask)
    np.testing.assert_array_equal(got, want)


def test_eos_rows_emit_pad_like_the_reference():
    prompt = _prompt(2, 7)
    first = tgen.generate(_models("mha")[2], prompt, 1).numpy()
    got, want = _greedy_pair("mha", prompt, 6, eos_id=int(first[0, 0]), pad_id=59)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == first[0, 0] and (got[0, 1:] == 59).all()


def test_long_generation_across_every_decode_chunk_is_token_identical():
    """``max_new_tokens`` > ``_DECODE_CHUNKS``: segments of 3 steps, where
    ``attend_len`` runs ahead of the fill inside a segment."""
    n = 2 * tgen._DECODE_CHUNKS + 4
    assert tgen._DECODE_CHUNKS == jgen._DECODE_CHUNKS
    got, want = _greedy_pair("gqa", _prompt(2, 6), n)
    np.testing.assert_array_equal(got, want)
    _, _, tmodel = _models("gqa")
    beam, _ = tgen.beam_search(tmodel, _prompt(2, 6), n, num_beams=1)
    np.testing.assert_array_equal(beam.numpy(), got)


def test_decode_schedule_reads_the_references_attend_lengths():
    """Every step of the chunked loop reads as many cache slots as the
    reference's scan segment does."""
    for n_total in (0, 1, 7, 8, 9, 19, 31):
        want, chunk = [], -(-n_total // jgen._DECODE_CHUNKS) if n_total else 1
        for start in range(1, 1 + n_total, chunk):
            end = min(start + chunk, 1 + n_total)
            want += [(i, end) for i in range(start, end)]
        assert list(tgen._decode_schedule(1, n_total)) == want


def test_generate_guards_raise_where_the_reference_does():
    _, _, tmodel = _models("mha")
    prompt = _prompt(2, 7)
    mask = np.ones((2, 7), np.int32)
    mask[:, -2:] = 0  # right padding
    with pytest.raises(ValueError, match="LEFT"):
        tgen.generate(tmodel, prompt, 4, prompt_mask=mask)
    with pytest.raises(ValueError, match="LEFT"):
        tgen.generate(tmodel, prompt, 4, prompt_mask=torch.from_numpy(mask))
    with pytest.raises(ValueError, match=r"\[B, T\]"):
        tgen.generate(tmodel, prompt, 4, prompt_mask=np.ones(7, np.int32))
    with pytest.raises(ValueError, match="max_seq_len"):
        tgen.generate(tmodel, prompt, 60)
    with pytest.raises(ValueError, match="max_seq_len"):
        tgen.beam_search(tmodel, prompt, 60)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

PARAM_SETS = [(0.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 10, 1.0), (0.9, 0, 0.7), (1.2, 5, 0.9)]


def _logits(b=4, v=61, seed=6, scale=3.0):
    return (np.random.RandomState(seed).randn(b, v) * scale).astype(np.float32)


def _truncations(logits, t, k, p):
    want = np.asarray(jgen._truncate_scaled(jnp.asarray(logits), jnp.asarray(t, jnp.float32),
                                            jnp.asarray(k, jnp.int32), jnp.asarray(p, jnp.float32)))
    got = tgen._truncate_scaled(torch.from_numpy(logits), torch.tensor(t, dtype=torch.float32), torch.tensor(k),
                                torch.tensor(p, dtype=torch.float32)).numpy()
    return got, want


@pytest.mark.parametrize("params", PARAM_SETS)
def test_truncate_scaled_keeps_and_scales_what_the_reference_does(params):
    t, k, p = params
    got, want = _truncations(_logits(), [t] * 4, [k] * 4, [p] * 4)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])


def test_truncate_scaled_per_row_parameters_and_time_axis():
    logits = _logits(b=4)
    rows = ([0.0, 1.5, 0.9, 0.8], [0, 5, 0, 3], [1.0, 1.0, 0.6, 0.5])
    got, want = _truncations(logits, *rows)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])
    got3, want3 = _truncations(np.stack([logits, logits[::-1]], axis=1), *rows)  # [B, T, V]
    np.testing.assert_array_equal(np.isfinite(got3), np.isfinite(want3))
    np.testing.assert_array_equal(got3[np.isfinite(got3)], want3[np.isfinite(want3)])


def test_scalar_sampler_truncates_like_the_batched_one():
    """``sample_logits`` and ``sample_logits_batched`` draw only from the
    tokens ``_truncate_scaled`` keeps, and greedy rows are the exact argmax."""
    logits = torch.from_numpy(_logits(b=2, seed=7))
    for t, k, p in PARAM_SETS[1:]:
        kept = torch.isfinite(tgen._truncate_scaled(logits, torch.full((2,), t), torch.full((2,), k),
                                                    torch.full((2,), p)))
        g = torch.Generator().manual_seed(0)
        for _ in range(20):
            for tok in (tgen.sample_logits(logits, t, k, p, g), tgen.sample_logits_batched(
                    logits, torch.full((2,), t), torch.full((2,), k), torch.full((2,), p), g)):
                assert bool(kept[torch.arange(2), tok].all())
    assert torch.equal(tgen.sample_logits(logits, 0.0, 0, 1.0), logits.argmax(-1))


def test_mixed_batch_greedy_rows_are_an_exact_argmax():
    logits = torch.from_numpy(_logits())
    out = tgen.sample_logits_batched(logits, torch.tensor([0.0, 1.5, 0.0, 0.8]), torch.tensor([0, 5, 0, 0]),
                                     torch.tensor([1.0, 1.0, 1.0, 0.6]), torch.Generator().manual_seed(0))
    greedy = logits.argmax(-1)
    assert out[0] == greedy[0] and out[2] == greedy[2]
    top1 = tgen.sample_logits_batched(logits, torch.full((4,), 5.0), torch.ones(4, dtype=torch.long),
                                      torch.ones(4), torch.Generator().manual_seed(1))
    assert torch.equal(top1, greedy)  # top_k = 1 leaves one candidate


def test_sampling_is_deterministic_under_one_generator():
    _, _, tmodel = _models("gqa")
    prompt = _prompt(2, 7)

    def draw(seed):
        return tgen.generate(tmodel, prompt, 12, temperature=0.9, top_k=20, top_p=0.95,
                             generator=torch.Generator().manual_seed(seed))

    assert torch.equal(draw(3), draw(3))
    assert not torch.equal(draw(3), draw(4))


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

def _beam_pair(variant, prompt, n, **kw):
    jmodel, params, tmodel = _models(variant)
    jkw = dict(kw)
    if "prompt_mask" in jkw:
        jkw["prompt_mask"] = jnp.asarray(jkw["prompt_mask"])
    jt, js = jgen.beam_search(jmodel, params, jnp.asarray(prompt), n, **jkw)
    tt, ts = tgen.beam_search(tmodel, prompt, n, **kw)
    return (tt.numpy(), ts.numpy()), (np.asarray(jt), np.asarray(js))


@pytest.mark.parametrize("beams,penalty", [(1, 1.0), (4, 1.0), (4, 0.6), (3, 2.0)])
def test_beam_search_matches_the_reference(beams, penalty):
    (tt, ts), (jt, js) = _beam_pair("gqa", _prompt(2, 6, seed=5), 9, num_beams=beams, length_penalty=penalty)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, atol=SCORE_TOL, rtol=0)


def test_single_beam_is_greedy():
    _, _, tmodel = _models("mha")
    prompt = _prompt(2, 7)
    toks, _ = tgen.beam_search(tmodel, prompt, 8, num_beams=1)
    np.testing.assert_array_equal(toks.numpy(), tgen.generate(tmodel, prompt, 8).numpy())


def test_beam_search_eos_freezing_matches_the_reference():
    prompt = _prompt(2, 7, seed=8)
    first = int(tgen.beam_search(_models("mha")[2], prompt, 1, num_beams=3)[0][0, 0])
    (tt, ts), (jt, js) = _beam_pair("mha", prompt, 7, num_beams=3, eos_id=first, pad_id=5)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, atol=SCORE_TOL, rtol=0)
    eos_at = np.nonzero(tt[0] == first)[0]
    if eos_at.size:  # a frozen beam pads after its eos
        assert (tt[0, eos_at[0] + 1:] == 5).all()


def test_ragged_beam_rows_match_the_reference_and_unpadded():
    batch, mask, rows = _ragged([4, 8], seed=13)
    (tt, ts), (jt, js) = _beam_pair("gqa", batch, 5, num_beams=3, prompt_mask=mask)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, atol=SCORE_TOL, rtol=0)
    _, _, tmodel = _models("gqa")
    for i, row in enumerate(rows):
        toks, score = tgen.beam_search(tmodel, row[None], 5, num_beams=3)
        np.testing.assert_array_equal(tt[i], toks.numpy()[0])
        np.testing.assert_allclose(ts[i], float(score[0]), atol=SCORE_TOL)


def test_beam_search_validation():
    _, _, tmodel = _models("mha")
    prompt = _prompt(1, 4)
    with pytest.raises(ValueError, match="num_beams"):
        tgen.beam_search(tmodel, prompt, 4, num_beams=0)
    with pytest.raises(ValueError, match="exceed vocab_size"):
        tgen.beam_search(tmodel, prompt, 4, num_beams=62)
    for bad in (-1, 61):
        with pytest.raises(ValueError, match="pad_id"):
            tgen.beam_search(tmodel, prompt, 4, pad_id=bad)


def test_decode_entry_points_run_on_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgen.init_cache(_models("mha")[2].cfg, 1, 4)


# ---------------------------------------------------------------------------
# the inference example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [[], ["--temperature", "0.8", "--top-k", "20", "--top-p", "0.9"], ["--beams", "2"]])
def test_generate_text_example_runs_on_the_cpu(mode, capsys):
    from dmlcloud_tpu_torch.examples import generate_text

    out = generate_text.main(["--device", "cpu", "--max-new", "6", *mode])
    tokens = out[0] if isinstance(out, tuple) else out
    assert tuple(tokens.shape) == (2, 6) and bool(((tokens >= 0) & (tokens < 256)).all())
    printed = capsys.readouterr().out.splitlines()
    assert [line.split(" ")[:2] for line in printed] == [["row", "0"], ["row", "1"]]
    if not mode:  # greedy: the example's ragged row 1 decodes as the same prompt unpadded
        args = argparse.Namespace(prompt_len=12, max_new=6, seed=0, device="cpu")
        model = generate_text.build_model(args)
        row = np.random.RandomState(0).randint(0, 256, (2, 12))[1, 6:]
        np.testing.assert_array_equal(tokens[1].numpy(), tgen.generate(model, row[None], 6)[0].numpy())


@pytest.mark.parametrize("flag,item", [(["--hf", "ckpt"], "item 11")])
def test_generate_text_flags_not_ported_yet_are_parser_errors(flag, item, capsys):
    from dmlcloud_tpu_torch.examples import generate_text

    with pytest.raises(SystemExit):
        generate_text.main(["--device", "cpu", *flag])
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--int8"], ["--speculative", "4"]])
def test_generate_text_int8_and_speculative_match_generate(flag, capsys):
    """``--int8`` decodes the quantized model and ``--speculative 4`` decodes
    through a 1-layer draft: each prints the reference's lines, and its tokens
    are ``generate``'s on the same model (ragged row 1 included)."""
    from dmlcloud_tpu_torch.examples import generate_text
    from dmlcloud_tpu_torch.models.quant import quantize_tree

    tokens = generate_text.main(["--device", "cpu", "--max-new", "8", *flag])
    printed = capsys.readouterr().out
    args = argparse.Namespace(prompt_len=12, max_new=8, seed=0, device="cpu", speculative=int(flag[-1]) if
                              flag[0] == "--speculative" else 0)
    model = generate_text.build_model(args)
    if flag == ["--int8"]:
        model = quantize_tree(model)
        assert "int8 weights:" in printed
    else:
        assert "matches plain greedy: True" in printed and "draft accept rate" in printed
    prompt = np.random.RandomState(0).randint(0, 256, (2, 12))
    mask = np.ones((2, 12), np.int32)
    mask[1, :6] = prompt[1, :6] = 0
    np.testing.assert_array_equal(tokens.numpy(), tgen.generate(model, prompt, 8, prompt_mask=mask).numpy())


def test_decode_with_per_row_adapters_matches_the_reference():
    """``adapters=(stacked, ids)`` in the decode mode against the reference's
    ``apply(..., adapters=)``: a prefill and two cached steps, each row with
    its own adapter (row 1 the null one)."""
    from dmlcloud_tpu.models import lora as jlora
    from dmlcloud_tpu.serve.adapters import AdapterSet
    from dmlcloud_tpu_torch.models import lora as tlora

    jmodel, params, tmodel = _models("gqa")
    rng = np.random.RandomState(4)

    def tenant(seed):
        tree = jlora.lora_init(jax.random.PRNGKey(seed), params, rank=2, in_axes=1)
        return jax.tree_util.tree_map(
            lambda p: p if p is None else jlora.LoraPair(a=p.a, b=jnp.asarray(rng.randn(*p.b.shape) * 0.1, jnp.float32)),
            tree, is_leaf=lambda x: x is None or isinstance(x, jlora.LoraPair))

    aset = AdapterSet({"a": tenant(1), "b": tenant(2)}, alpha=4.0, base=params)

    def port(tree):
        if isinstance(tree, dict):
            return {k: port(v) for k, v in tree.items()}
        return tree if tree is None else tlora.LoraPair(a=torch.from_numpy(np.array(tree.a)),
                                                        b=torch.from_numpy(np.array(tree.b)))

    fwd = torch.no_grad()(tmodel)
    ids = np.array([2, 0, 1], np.int32)
    jad, tad = (aset.stacked, jnp.asarray(ids)), (port(aset.stacked), torch.from_numpy(ids).long())
    prompt = _prompt(3, 6, seed=7)
    jcache = jgen.init_cache(jmodel.cfg, 3, 12, dtype=jnp.float32)
    tcache = tgen.init_cache(tmodel.cfg, 3, 12, torch.float32, "cpu")
    jl, jcache = jmodel.apply({"params": params}, jnp.asarray(prompt), cache=jcache, offset=0, attend_len=6,
                              adapters=jad)
    tl, tcache = fwd(torch.from_numpy(prompt).long(), cache=tcache, offset=0, attend_len=6, adapters=tad)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for step in range(2):
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        jl, jcache = jmodel.apply({"params": params}, jnp.asarray(tok), cache=jcache, offset=6 + step, adapters=jad)
        tl, tcache = fwd(torch.from_numpy(tok).long(), cache=tcache, offset=6 + step, adapters=tad)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _check_cache(tcache, jcache)
    plain = fwd(torch.from_numpy(prompt).long())
    with_ad = fwd(torch.from_numpy(prompt).long(), adapters=tad)
    assert torch.equal(plain[1], with_ad[1]) and not torch.allclose(plain[0], with_ad[0], atol=1e-4)
