"""The engine's speculative rounds against the JAX package's engine, on the
CPU (tests/test_serve.py ``TestSpeculativeEngine``, ``TestSpecPrefixCompose``,
``TestSpecLora``, ``TestSpecChaos``).

On the tiny fp32 model, with the reference's 1-layer random draft carried over
by ``load_flax_params``:

- ``spec_k`` in {1, 3} with a self-draft and with the 1-layer draft: greedy
  tokens and each request's drafted/accepted counts equal the reference
  engine's (the self-draft accepts everything, the random draft almost
  nothing), and equal serial ``generate``; both pools drain clean;
- a degraded draft round (a draft fault) keeps the reference's tokens, and
  the next round's 2-token rewrite covers the degraded token's draft slot; a
  draft failing every round drafts nothing;
- spec x prefix cache, spec x LoRA x prefix and two tenants with the base in
  one spec batch: tokens, drafted/accepted counts, cached and saved prefill
  tokens, COW forks, the tree and the leaked blocks and locks equal the
  reference engine's on the same waves, and the tokens equal serial
  ``generate`` on each tenant's merged model; tenants never share pages;
- a greedy row beside a sampled one keeps the reference's tokens and counts;
  eos truncates inside a round as the reference's does; the reservation and
  ``max_seq_len`` check carry the lookahead; bad arguments raise as the
  reference's.
"""

import functools
import re
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu.serve.chaos import ChaosMonkey as JChaosMonkey
from dmlcloud_tpu.serve.engine import ServeEngine as JEngine
from dmlcloud_tpu.telemetry import journal as jjournal
from dmlcloud_tpu_torch.models import generate as tgen
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.serve import ChaosMonkey, ServeEngine
from dmlcloud_tpu_torch.telemetry import journal as tjournal
from test_torch_serve import TINY, _models, _port_generate, _prompt
from test_torch_serve_adapters import merged_model, tenants

torch.set_num_threads(2)

#: tests/test_serve.py's ``tiny_draft``: an independent random 1-layer draft
DRAFT = dict(TINY, num_layers=1, num_heads=2, num_kv_heads=1, hidden_dim=16, mlp_dim=32)
SPECS = [(7, 6), (13, 4), (5, 9), (22, 5), (3, 8)]


@functools.lru_cache(maxsize=None)
def _drafts():
    jdraft = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **DRAFT))
    dparams = jdraft.init(jax.random.PRNGKey(9), jnp.ones((1, 4), jnp.int32))["params"]
    tdraft = ttr.load_flax_params(ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **DRAFT), device="cpu"),
                                  jax.tree_util.tree_map(np.asarray, dparams))
    return jdraft, dparams, tdraft


def _engine(pkg, draft=False, **kw):
    kw = dict(dict(num_blocks=64, block_size=4, max_slots=3, prefill_chunk=8), **kw)
    jmodel, params, tmodel = _models()
    if pkg == "jax":
        if draft:
            kw.update(draft_model=_drafts()[0], draft_params=_drafts()[1])
        return JEngine(jmodel, params, batch_buckets=[kw["max_slots"]], table_buckets=[16], **kw)
    if draft:
        kw.update(draft_model=_drafts()[2])
    return ServeEngine(tmodel, batch_buckets=[kw["max_slots"]], table_buckets=[16], **kw)


def _serve(engine, specs, seed0=0, **submit):
    rids = [engine.submit(_prompt(n, seed=seed0 + i), m, **submit) for i, (n, m) in enumerate(specs)]
    engine.run(max_steps=5000)
    return {
        "tokens": [np.asarray(engine.output(r)).tolist() for r in rids],
        "counts": [(engine.ledger.records[r]["drafted"], engine.ledger.records[r]["accepted"]) for r in rids],
        "accept_rate": engine.ledger.summary()["accept_rate"],
        "leaked": engine.leaked_blocks(),
    }


def tgen_tokens(model, prompt, n):
    """Serial greedy ``generate`` of one prompt on ``model`` (numpy)."""
    return tgen.generate(model, prompt[None], n)[0].numpy()


@functools.lru_cache(maxsize=None)
def _reference(k, draft):
    return _serve(_engine("jax", draft=draft, spec_k=k), SPECS)


@pytest.mark.parametrize("draft", [False, True], ids=["self_draft", "one_layer_draft"])
@pytest.mark.parametrize("k", [1, 3])
def test_spec_engine_equals_the_reference_engine(k, draft):
    engine = _engine("torch", draft=draft, spec_k=k)
    got = _serve(engine, SPECS)
    assert got == _reference(k, draft)
    for toks, (n, m), seed in zip(got["tokens"], SPECS, range(len(SPECS))):
        assert toks == _port_generate(_prompt(n, seed=seed), m).tolist()
    assert got["leaked"] == 0 and engine.draft_pool.num_free == engine.draft_pool.num_blocks
    if draft:
        assert got["accept_rate"] < 0.5  # genuinely partial: the rewind is exercised
    else:
        assert got["accept_rate"] == 1.0 and all(d > 0 and d % k == 0 and a == d for d, a in got["counts"])


# ---------------------------------------------------------------------------
# degraded rounds
# ---------------------------------------------------------------------------

def _fault_at(n_call, point="draft"):
    """A fault injector that raises at the ``n_call``-th ``point`` call."""
    seen = [0]

    def inject(p, seqs):
        if p == point:
            seen[0] += 1
            if seen[0] == n_call:
                raise RuntimeError(f"injected {point} fault")

    return inject


def test_degraded_round_keeps_the_references_tokens():
    """tests/test_serve.py's fault schedule (the first draft call fails, in
    the first round of requests 0 and 1): the reference engine's tokens and
    drafted counts, request 2's accepted count exactly, and for requests 0
    and 1 at least the reference's (the port's rewrite after the degraded
    round feeds the right token, the reference's a stale one; module
    docstring of ``serve/engine.py``)."""
    res = []
    for pkg in ("jax", "torch"):
        engine = _engine(pkg, max_slots=2, spec_k=2)
        engine.fault_injector = _fault_at(1)
        res.append(_serve(engine, [(5, 6), (7, 6), (9, 6)], seed0=950))
    want, got = res
    assert got["tokens"] == want["tokens"] and got["leaked"] == 0
    assert [d for d, _ in got["counts"]] == [d for d, _ in want["counts"]]
    assert got["counts"][2] == want["counts"][2]
    assert all(g[1] >= w[1] for g, w in zip(got["counts"][:2], want["counts"][:2]))
    assert got["accept_rate"] >= 0.8  # speculation resumed after the fault


def test_the_next_round_rewrites_the_degraded_tokens_draft_slot():
    """A degraded round decodes one token on the target only, so the draft
    pool misses that token's slot (position ``f``). The next healthy round's
    first draft pass feeds two tokens at ``f``/``f+1``: before it the draft
    page at ``f`` is stale, after it equal to the target's in every layer (a
    self-draft computes the same K/V). The first round after prefill degrades
    here, so every draft slot before ``f`` holds the prompt's K/V; after a
    fully accepted round the bonus token's slot ``f-1`` would stay unwritten
    too, which costs accept rate only."""
    engine = _engine("torch", max_slots=1, spec_k=3)
    seen = {"draft": 0}
    pages = []

    def page(pool, blocks, pos):
        bs = pool.block_size
        return torch.stack([layer["k"][blocks[pos // bs], pos % bs] for layer in pool.pools.values()])

    def inject(point, seqs):
        if point not in ("draft", "verify"):
            return
        [s] = seqs
        if point == "draft":
            seen["draft"] += 1
            if seen["draft"] == 1:
                seen["slot"] = s.fill  # the degraded round writes the target at fill
                raise RuntimeError("injected draft fault")
        if "slot" in seen and len(pages) < 2:
            f = seen["slot"]
            pages.append((page(engine.draft_pool, s.draft_blocks, f), page(engine.pool, s.blocks, f)))

    engine.fault_injector = inject
    got = _serve(engine, [(9, 16)], seed0=3)
    assert got["tokens"][0] == _port_generate(_prompt(9, seed=3), 16).tolist()
    (stale, target0), (rewritten, target1) = pages  # at the next round's draft hook, then its verify hook
    assert not torch.allclose(stale, target0, atol=1e-4)
    torch.testing.assert_close(rewritten, target1, rtol=1e-5, atol=1e-5)
    assert got["leaked"] == 0


def test_a_draft_failing_every_round_drafts_nothing():
    res = []
    for pkg, monkey_cls in (("jax", JChaosMonkey), ("torch", ChaosMonkey)):
        engine = _engine(pkg, draft=True, max_slots=2, spec_k=3)
        monkey = monkey_cls(seed=53, p_fault=1.0, fault_points=("draft",)).attach(engine)
        res.append((_serve(engine, [(5, 6), (9, 4), (4, 7)], seed0=900), monkey.log))
        monkey.detach()
    (want, want_log), (got, got_log) = res
    assert got == want and got_log == want_log
    assert got["counts"] == [(0, 0)] * 3 and got["accept_rate"] is None
    for toks, (n, m), i in zip(got["tokens"], [(5, 6), (9, 4), (4, 7)], range(3)):
        assert toks == _port_generate(_prompt(n, seed=900 + i), m).tolist()
    assert got["leaked"] == 0


# ---------------------------------------------------------------------------
# compositions
# ---------------------------------------------------------------------------

def _template_prompt(tmpl, n_suffix, seed):
    return np.concatenate([tmpl, np.random.RandomState(seed).randint(0, 61, n_suffix).astype(np.int32)])


def compose(pkg, waves, draft=False, adapters=False, fault=None, seed=None, **kw):
    """Serve ``waves`` (lists of ``(prompt, max_new, submit kwargs)``, each
    submitted once the one before has run) through ``pkg``'s engine, with
    the reference's two tenants when ``adapters``, a fresh ``fault()``
    injector when given, and the journal armed. Returns what must equal the
    reference's: each request's length, tokens and drafted/accepted counts
    (``None`` for a sampled row, whose draws are each engine's own), cached
    and saved prefill tokens, the COW forks, the tree, the leaked locks and
    blocks, whether the draft pool drained; and the engine."""
    if adapters:
        kw["adapters"] = tenants()[2 if pkg == "jax" else 3]
    if seed is not None and pkg == "torch":
        kw["generator"] = torch.Generator().manual_seed(seed)
    engine = _engine(pkg, draft=draft, **kw)
    if fault is not None:
        engine.fault_injector = fault()
    jmod = jjournal if pkg == "jax" else tjournal
    rids, greedy = [], []
    with tempfile.TemporaryDirectory() as tmp:
        j = jmod.activate(jmod.SpanJournal(tmp, ring_size=1 << 20))
        try:
            for wave in waves:
                for prompt, m, sub in wave:
                    rids.append(engine.submit(prompt, m, **sub))
                    greedy.append("temperature" not in sub)
                engine.run(max_steps=5000)
        finally:
            jmod.deactivate()
        spans = j.tail(1 << 20)
    recs = [engine.ledger.records[r] for r in rids]
    out = {
        "lengths": [len(engine.output(r)) for r in rids],
        "tokens": [np.asarray(engine.output(r)).tolist() if g else None for r, g in zip(rids, greedy)],
        "counts": [(rec["drafted"], rec["accepted"]) if g else None for rec, g in zip(recs, greedy)],
        "cached": [rec.get("cached_tokens") for rec in recs],
        "saved": [rec.get("saved_tokens") for rec in recs],
        "forks": [(r["request"], r["cow_block"]) for r in spans if r["kind"] == "cow_fork"],
        "leaked": engine.leaked_blocks(),
        "draft_drained": engine.draft_pool is None or engine.draft_pool.num_free == engine.draft_pool.num_blocks,
    }
    if engine.prefix is not None:
        out["tree"] = engine.prefix.stats()
        out["locks"] = engine.prefix.leaked_locks()
    return out, engine


@pytest.mark.parametrize("draft", [False, True], ids=["self_draft", "one_layer_draft"])
def test_spec_with_the_prefix_cache_stays_token_identical(draft):
    """tests/test_serve.py ``TestSpecPrefixCompose``: warm template requests
    skip their prefix in the target pool only."""
    tmpl = _prompt(16, seed=51)
    prompts = [_template_prompt(tmpl, n, 900 + i) for i, n in enumerate((3, 5, 2))]
    waves = [[(p, 5, {}) for p in prompts]]
    kw = dict(draft=draft, max_slots=1, spec_k=3, prefix_cache=True)
    got, _ = compose("torch", waves, **kw)
    assert got == compose("jax", waves, **kw)[0]
    for toks, p in zip(got["tokens"], prompts):
        assert toks == _port_generate(p, 5).tolist()
    assert got["cached"] == [0, 16, 16] and got["saved"] == [0, 16, 16]
    assert got["leaked"] == 0 and got["locks"] == [] and got["draft_drained"]


def test_spec_lora_prefix_compose():
    """spec x LoRA x prefix cache: the draft proposes with the base model, the
    verify scores with the tenant's adapter, the tree is namespaced by
    tenant, and the outputs are the merged model's."""
    tmpl = _prompt(12, seed=55)
    p1, p2 = _template_prompt(tmpl, 3, 56), _template_prompt(tmpl, 4, 57)
    # the base tenant's p2 must not hit "a"'s blocks
    waves = [[(p1, 5, dict(adapter="a"))], [(p2, 5, dict(adapter="a")), (p2, 5, {})]]
    kw = dict(max_slots=2, spec_k=2, adapters=True, prefix_cache=True)
    got, _ = compose("torch", waves, **kw)
    assert got == compose("jax", waves, **kw)[0]
    merged = merged_model(tenants()[0])
    assert got["tokens"][:2] == [tgen_tokens(merged, p, 5).tolist() for p in (p1, p2)]
    assert got["tokens"][2] == _port_generate(p2, 5).tolist() != got["tokens"][1]
    assert got["cached"] == [0, 12, 0]
    d, a = got["counts"][2]
    assert d > 0 and a == d  # the base row self-drafts against itself
    assert got["leaked"] == 0 and got["locks"] == []


def test_spec_lora_tenants_in_one_batch_equal_the_reference_engine():
    """tests/test_serve.py ``test_spec_lora_mixed_tenants_one_batch``: two
    tenants and the base in one spec batch; each row the reference's, and
    its merged model's."""
    prompt = _prompt(9, seed=54)
    waves = [[(prompt, 5, dict(adapter=a)) for a in ("a", "b", None)]]
    kw = dict(max_slots=4, spec_k=2, adapters=True)
    got, _ = compose("torch", waves, **kw)
    assert got == compose("jax", waves, **kw)[0]
    a, b, _, _ = tenants()
    assert got["tokens"] == [tgen_tokens(merged_model(a), prompt, 5).tolist(),
                             tgen_tokens(merged_model(b), prompt, 5).tolist(), _port_generate(prompt, 5).tolist()]
    assert len({tuple(t) for t in got["tokens"]}) == 3 and got["leaked"] == 0


def test_spec_mixed_sampling_keeps_the_greedy_row():
    waves = [[(_prompt(8, seed=1), 6, {}), (_prompt(8, seed=2), 6, dict(temperature=1.1, top_k=20))]]
    got, engine = compose("torch", waves, max_slots=2, spec_k=3, seed=1)
    assert got == compose("jax", waves, max_slots=2, spec_k=3)[0]
    assert got["tokens"][0] == _port_generate(_prompt(8, seed=1), 6).tolist()
    s = engine.output(max(engine.ledger.records))
    assert len(s) == 6 and ((s >= 0) & (s < 61)).all()
    d, a = got["counts"][0]
    assert d > 0 and a == d and got["leaked"] == 0


def test_spec_eos_truncates_inside_a_round():
    prompt = _prompt(9, seed=3)
    ref = _port_generate(prompt, 8)
    eos = int(ref[2])
    assert eos not in ref[:2]
    got, _ = compose("torch", [[(prompt, 8, {})]], spec_k=3, eos_id=eos)
    assert got == compose("jax", [[(prompt, 8, {})]], spec_k=3, eos_id=eos)[0]
    assert got["tokens"] == [ref[:3].tolist()] and got["leaked"] == 0


def test_reservation_and_length_check_carry_the_lookahead():
    res = []
    for pkg in ("jax", "torch"):
        engine = _engine(pkg, spec_k=3)
        engine.submit(_prompt(4), 4)
        seq = engine.scheduler.waiting[0]
        with pytest.raises(ValueError, match="spec_k") as err:
            engine.submit(_prompt(31), 30)
        res.append((engine.scheduler.reservation(seq), seq.needed_blocks(4, lookahead=3), str(err.value)))
    assert res[1] == res[0] and res[1][0] == 3


@pytest.mark.parametrize("kw", [dict(spec_k=-1), dict(spec_k=2, medusa_k=2), dict(draft="model")])
def test_bad_spec_arguments_raise_as_the_reference(kw):
    jmodel, params, tmodel = _models()
    jkw, tkw = dict(kw), dict(kw)
    if "draft" in kw:
        del jkw["draft"], tkw["draft"]
        jkw.update(draft_model=jmodel, draft_params=params)
        tkw.update(draft_model=tmodel)
    with pytest.raises(ValueError) as jerr:
        JEngine(jmodel, params, num_blocks=16, **jkw)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        ServeEngine(tmodel, num_blocks=16, **tkw)


def test_draft_params_has_no_counterpart():
    with pytest.raises(TypeError, match="draft_params"):
        ServeEngine(_models()[2], num_blocks=16, spec_k=2, draft_params={})
