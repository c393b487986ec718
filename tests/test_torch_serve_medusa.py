"""The engine's Medusa rounds against the JAX package's engine, on the CPU
(tests/test_serve.py ``TestMedusaEngine``).

On the tiny fp32 model:

- ``medusa_k`` in {1, 3} with heads from the reference's ``init_medusa_heads``
  (random ``w2``, ``PRNGKey(7)``), carried over as numpy: greedy tokens and
  each request's drafted/accepted counts equal the reference engine's, and
  serial ``generate``; ``k == 1`` drafts nothing;
- the default heads, warm-started from the ``lm_head``, equal the reference's
  default heads, and on the reference's repetitive-chain prompt the accept
  rate and the per-request counts equal the reference engine's (the reference
  test's ``> 0.8`` bar is not asserted: on this host's jax the tiny chain never
  enters a cycle);
- Medusa x LoRA x prefix cache, a greedy row beside a sampled one, and failed
  rounds degraded to plain steps: tokens, drafted/accepted counts, cached and
  saved prefill tokens, the tree and the leaked blocks equal the reference
  engine's on the same requests (greedy rows only, for tokens and counts),
  and the tokens equal serial ``generate`` (on the tenant's merged model);
  bad arguments raise as the reference's.
"""

import functools
import re

import jax
import numpy as np
import pytest
import torch

from dmlcloud_tpu.models import speculative as jspec
from dmlcloud_tpu.serve.engine import ServeEngine as JEngine
from dmlcloud_tpu_torch.serve import ServeEngine
from test_torch_serve import _models, _port_generate, _prompt
from test_torch_serve_adapters import merged_model, tenants
from test_torch_serve_spec import _engine, _serve, compose, tgen_tokens

torch.set_num_threads(2)

SPECS = [(7, 6), (13, 4), (5, 9), (22, 5), (3, 8)]


@functools.lru_cache(maxsize=None)
def _heads(k):
    """The reference's random heads (no warm start), as numpy."""
    return {n: np.asarray(v) for n, v in jspec.init_medusa_heads(_models()[0].cfg, k, jax.random.PRNGKey(7)).items()}


def _chain_prompt():
    """tests/test_serve.py's repetitive-chain prompt: a 4-token seed and its
    18-token greedy continuation."""
    seed = _prompt(4, seed=0)
    return np.concatenate([seed, _port_generate(seed, 18)]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _run(pkg, case):
    if case == "chain":
        engine = _engine(pkg, max_slots=2, num_blocks=48, medusa_k=3)
        rid = engine.submit(_chain_prompt(), 36)
        engine.run(max_steps=5000)
        return {"tokens": [np.asarray(engine.output(rid)).tolist()],
                "counts": [(engine.ledger.records[rid]["drafted"], engine.ledger.records[rid]["accepted"])],
                "accept_rate": engine.ledger.summary()["accept_rate"], "leaked": engine.leaked_blocks()}
    k, heads = case
    kw = dict(medusa_k=k)
    if heads:
        kw["medusa_heads"] = _heads(k)
    return _serve(_engine(pkg, **kw), SPECS)


@pytest.mark.parametrize("case", [(1, False), (3, True), (3, False), "chain"],
                         ids=["k1", "k3_random_heads", "k3_warm_heads", "chain"])
def test_medusa_engine_equals_the_reference_engine(case):
    got, want = _run("torch", case), _run("jax", case)
    assert got == want
    assert got["leaked"] == 0
    if case == "chain":
        assert got["tokens"][0] == _port_generate(_chain_prompt(), 36).tolist()
        return
    for toks, (n, m), seed in zip(got["tokens"], SPECS, range(len(SPECS))):
        assert toks == _port_generate(_prompt(n, seed=seed), m).tolist()
    if case[0] == 1:
        assert got["accept_rate"] is None and all(c == (0, 0) for c in got["counts"])
    else:
        assert all(d > 0 and d % 2 == 0 for d, _ in got["counts"])


def test_default_heads_are_the_references_warm_start():
    jmodel, params, tmodel = _models()
    want = jspec.init_medusa_heads(jmodel.cfg, 3, jax.random.PRNGKey(0),
                                   lm_head_kernel=params["lm_head"]["kernel"])
    got = ServeEngine(tmodel, num_blocks=16, block_size=4, medusa_k=3).medusa_heads
    for name in ("w1", "b1", "w2"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    assert ServeEngine(tmodel, num_blocks=16, block_size=4, medusa_k=3).draft_pool is None


def test_medusa_lora_prefix_compose():
    """Medusa x LoRA x prefix cache: the heads read the adapted hidden state,
    the verify is adapter-aware, the tree is namespaced by tenant, and the
    outputs are the merged model's."""
    tmpl = _prompt(12, seed=55)
    tail = lambda n, s: np.random.RandomState(s).randint(0, 61, n).astype(np.int32)
    p1, p2 = np.concatenate([tmpl, tail(3, 56)]), np.concatenate([tmpl, tail(4, 57)])
    # the base tenant's p2 must not hit "a"'s blocks
    waves = [[(p1, 5, dict(adapter="a")), (p2, 5, dict(adapter="a")), (p2, 5, {})]]
    kw = dict(max_slots=1, medusa_k=2, adapters=True, prefix_cache=True)
    got, engine = compose("torch", waves, **kw)
    assert got == compose("jax", waves, **kw)[0]
    merged = merged_model(tenants()[0])
    assert got["tokens"][:2] == [tgen_tokens(merged, p, 5).tolist() for p in (p1, p2)]
    assert got["tokens"][2] == _port_generate(p2, 5).tolist()
    assert got["cached"] == [0, 12, 0] and all(d > 0 for d, _ in got["counts"])
    assert engine.draft_pool is None and got["leaked"] == 0 and got["locks"] == []


def test_medusa_mixed_sampling_keeps_the_greedy_row():
    waves = [[(_prompt(8, seed=1), 6, {}), (_prompt(8, seed=2), 6, dict(temperature=1.1))]]
    got, engine = compose("torch", waves, max_slots=2, medusa_k=3, seed=2)
    assert got == compose("jax", waves, max_slots=2, medusa_k=3)[0]
    assert got["tokens"][0] == _port_generate(_prompt(8, seed=1), 6).tolist()
    s = engine.output(max(engine.ledger.records))
    assert len(s) == 6 and ((s >= 0) & (s < 61)).all()
    assert got["counts"][0][0] > 0 and got["leaked"] == 0


def _medusa_faults():
    """Fails the second and third Medusa rounds."""
    calls = [0]

    def inject(point, seqs):
        if point == "verify":
            calls[0] += 1
            if calls[0] in (2, 3):
                raise RuntimeError("injected medusa fault")

    return inject


def test_a_failed_medusa_round_degrades_to_a_plain_step():
    waves = [[(_prompt(n, seed=i), m, {}) for i, (n, m) in enumerate(SPECS[:3])]]
    got, _ = compose("torch", waves, medusa_k=3, fault=_medusa_faults)
    assert got == compose("jax", waves, medusa_k=3, fault=_medusa_faults)[0]
    for toks, (n, m), seed in zip(got["tokens"], SPECS, range(3)):
        assert toks == _port_generate(_prompt(n, seed=seed), m).tolist()
    assert got["leaked"] == 0


@pytest.mark.parametrize("kw", [dict(medusa_k=-1), dict(spec_k=2, medusa_k=2), dict(heads=2)])
def test_bad_medusa_arguments_raise_as_the_reference(kw):
    jmodel, params, tmodel = _models()
    if "heads" in kw:
        kw = dict(medusa_heads=_heads(kw["heads"]))
    with pytest.raises(ValueError) as jerr:
        JEngine(jmodel, params, num_blocks=16, **kw)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        ServeEngine(tmodel, num_blocks=16, **kw)
