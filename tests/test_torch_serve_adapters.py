"""The port's ``AdapterSet`` and the engine's multi-tenant LoRA serving against
the JAX package, on the CPU (tests/test_serve.py ``TestAdapterSet``).

The tenants are the reference's ``lora_init(..., rank=2, in_axes=1)`` of the
tiny fp32 model with ``b`` drawn at 0.5 (at the reference test's 0.05 this
model's greedy chain falls onto one token for every tenant), carried into the
port as the same trees of tensors.

- ``AdapterSet.stacked`` equals the reference's stacked factors (null row 0,
  ``b`` pre-scaled by ``alpha/rank``), and ``names``/``id_of``/``pack`` agree;
- one engine serving two tenants and the base in one batch gives each row the
  reference engine's tokens, each tenant equal to ``generate`` on its merged
  model and to the tenant served alone, the null adapter exactly the base;
- an unknown adapter, an adapter on an engine without a set, a mismatched
  tree, a rank mismatch and the all-but-last factorization raise as the
  reference does, with its messages;
- ``decode_step(adapters=)`` equals the JAX ``decode_step`` with the same
  packed adapters.
"""

import copy
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlcloud_tpu.models import generate as jgen
from dmlcloud_tpu.models import lora as jlora
from dmlcloud_tpu.serve.adapters import AdapterSet as JAdapterSet
from dmlcloud_tpu.serve.engine import ServeEngine as JEngine
from dmlcloud_tpu_torch.models import generate as tgen
from dmlcloud_tpu_torch.models import lora as tlora
from dmlcloud_tpu_torch.serve import AdapterSet, ServeEngine
from test_torch_serve import _models, _port_generate, _prompt

torch.set_num_threads(2)

ALPHA = 4.0


def jax_adapter(init_seed, b_seed, rank=2, in_axes=1, scale=0.5):
    """tests/test_serve.py's ``_randomized_adapter``: ``lora_init`` with ``b``
    drawn at ``scale``, so the deltas bite."""
    _, params, _ = _models()
    tree = jlora.lora_init(jax.random.PRNGKey(init_seed), params, rank=rank, in_axes=in_axes)
    key = [jax.random.PRNGKey(b_seed)]

    def f(x):
        if isinstance(x, jlora.LoraPair):
            key[0], sub = jax.random.split(key[0])
            return x.replace(b=jax.random.normal(sub, x.b.shape, jnp.float32) * scale)
        return x

    return jax.tree_util.tree_map(f, tree, is_leaf=lambda x: x is None or isinstance(x, jlora.LoraPair))


def to_torch(tree):
    """A reference adapter tree as the port's: the same nested dicts, the
    pairs' factors as tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, jlora.LoraPair):
        return tlora.LoraPair(a=torch.tensor(np.asarray(tree.a)), b=torch.tensor(np.asarray(tree.b)))
    return tree


def _flat(tree, prefix=""):
    """``{path: array}`` of every factor (a/b), numpy."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _flat(sub, f"{prefix}/{k}").items()}
    if tree is None:
        return {}
    return {f"{prefix}/a": np.asarray(tree.a), f"{prefix}/b": np.asarray(tree.b)}


@functools.lru_cache(maxsize=None)
def tenants():
    """The two reference tenants and both packages' sets over them."""
    _, params, tmodel = _models()
    a, b = jax_adapter(1, 10), jax_adapter(2, 20)
    jset = JAdapterSet({"a": a, "b": b}, alpha=ALPHA, base=params)
    tset = AdapterSet({"a": to_torch(a), "b": to_torch(b)}, alpha=ALPHA, base=tmodel)
    return a, b, jset, tset


def merged_model(tree):
    """The port's tiny model with one tenant merged in (``lora_merge``)."""
    _, _, tmodel = _models()
    model = copy.deepcopy(tmodel)
    model.load_state_dict(tlora.lora_merge(tmodel, to_torch(tree), alpha=ALPHA), strict=False)
    return model


def test_stacked_factors_equal_the_references():
    _, _, jset, tset = tenants()
    want, got = _flat(jset.stacked), _flat(tset.stacked)
    assert sorted(got) == sorted(want) and len(got) > 0
    for path in want:
        np.testing.assert_allclose(got[path].numpy() if hasattr(got[path], "numpy") else got[path], want[path],
                                   rtol=1e-6, atol=1e-7, err_msg=path)
        assert not np.asarray(want[path])[0].any()  # row 0: the null adapter
    assert tset.names == jset.names and len(tset) == len(jset) == 3
    assert [tset.id_of(n) for n in (None, "a", "b")] == [jset.id_of(n) for n in (None, "a", "b")]
    stacked, ids = tset.pack([2, 0, 1])
    assert stacked is tset.stacked and ids.tolist() == np.asarray(jset.pack([2, 0, 1])[1]).tolist()


def test_decode_step_with_adapters_equals_the_references():
    jmodel, params, tmodel = _models()
    _, _, jset, tset = tenants()
    toks = _prompt(12, seed=3).reshape(2, 6)
    ids = [1, 2]
    jcache = jgen.init_cache(jmodel.cfg, 2, 16, dtype=jnp.float32)
    jlogits, _ = jgen.decode_step(jmodel, params, jnp.asarray(toks), jcache, offset=0, attend_len=6,
                                  adapters=jset.pack(ids))
    tcache = tgen.init_cache(tmodel, 2, 16, dtype=torch.float32, device="cpu")
    tlogits, _ = tgen.decode_step(tmodel, torch.from_numpy(toks).long(), tcache, offset=0, attend_len=6,
                                  adapters=tset.pack(ids))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=2e-4, atol=2e-5)


@functools.lru_cache(maxsize=None)
def _engine_tokens(pkg, specs):
    """One engine, one request per tenant in ``specs`` (all in one batch) on
    the same prompt; the tokens per request."""
    jmodel, params, tmodel = _models()
    _, _, jset, tset = tenants()
    kw = dict(num_blocks=64, block_size=4, max_slots=4, prefill_chunk=8)
    if pkg == "jax":
        engine = JEngine(jmodel, params, adapters=jset, batch_buckets=[4], table_buckets=[16], **kw)
    else:
        engine = ServeEngine(tmodel, adapters=tset, **kw)
    rids = [engine.submit(_prompt(9, seed=9), 6, adapter=s) for s in specs]
    engine.run(max_steps=2000)
    assert engine.leaked_blocks() == 0
    return tuple(tuple(np.asarray(engine.output(r)).tolist()) for r in rids)


@pytest.mark.parametrize("row,tenant", [(0, "a"), (1, "b"), (2, None)])
def test_each_tenant_equals_the_reference_engine_and_its_merged_model(row, tenant):
    a, b, _, _ = tenants()
    specs = ("a", "b", None)
    got = _engine_tokens("torch", specs)
    assert got[row] == _engine_tokens("jax", specs)[row]
    assert got[row] == _engine_tokens("torch", (tenant,))[0]  # the tenant alone
    model = _models()[2] if tenant is None else merged_model({"a": a, "b": b}[tenant])
    assert list(got[row]) == tgen.generate(model, _prompt(9, seed=9)[None], 6)[0].tolist()


def test_tenants_decode_differently():
    got = _engine_tokens("torch", ("a", "b", None))
    assert len(set(got)) == 3
    assert list(got[2]) == _port_generate(_prompt(9, seed=9), 6).tolist()


def _raises_like(jfn, tfn, exc):
    with pytest.raises(exc) as jerr:
        jfn()
    with pytest.raises(exc, match=re.escape(str(jerr.value))):
        tfn()


def test_unknown_adapters_raise_as_the_reference():
    jmodel, params, tmodel = _models()
    _, _, jset, tset = tenants()
    _raises_like(lambda: jset.id_of("nope"), lambda: tset.id_of("nope"), KeyError)
    jeng = JEngine(jmodel, params, num_blocks=16, block_size=4, adapters=jset)
    teng = ServeEngine(tmodel, num_blocks=16, block_size=4, adapters=tset)
    _raises_like(lambda: jeng.submit(_prompt(4), 4, adapter="nope"), lambda: teng.submit(_prompt(4), 4, adapter="nope"),
                 KeyError)
    jplain = JEngine(jmodel, params, num_blocks=16, block_size=4)
    tplain = ServeEngine(tmodel, num_blocks=16, block_size=4)
    _raises_like(lambda: jplain.submit(_prompt(4), 4, adapter="a"), lambda: tplain.submit(_prompt(4), 4, adapter="a"),
                 ValueError)
    assert teng.idle and tplain.statuses() == {}


def test_bad_sets_raise_as_the_reference():
    _, params, tmodel = _models()
    a, _, _, _ = tenants()
    _raises_like(lambda: JAdapterSet({}), lambda: AdapterSet({}), ValueError)
    # the all-but-last split cannot be applied per row
    legacy = jax_adapter(3, 30, in_axes=None)
    _raises_like(lambda: JAdapterSet({"bad": legacy}, base=params),
                 lambda: AdapterSet({"bad": to_torch(legacy)}, base=tmodel), ValueError)
    # a tenant over another tree, and one at another rank
    partial = {k: v for k, v in a.items() if k != "lm_head"}
    _raises_like(lambda: JAdapterSet({"a": a, "p": partial}),
                 lambda: AdapterSet({"a": to_torch(a), "p": to_torch(partial)}), ValueError)
    rank3 = jax_adapter(5, 50, rank=3)
    _raises_like(lambda: JAdapterSet({"a": a, "r": rank3}), lambda: AdapterSet({"a": to_torch(a), "r": to_torch(rank3)}),
                 ValueError)
    # the serving split passes the same check
    AdapterSet({"ok": to_torch(a)}, base=tmodel)


def test_port_lora_init_trees_stack():
    """Adapters made by the port's own ``lora_init`` stack and serve."""
    _, _, tmodel = _models()
    g = torch.Generator().manual_seed(0)
    trees = [tlora.lora_init(g, tmodel, rank=2, in_axes=1) for _ in range(2)]
    aset = AdapterSet({"x": trees[0], "y": trees[1]}, base=tmodel)
    engine = ServeEngine(tmodel, num_blocks=32, block_size=4, adapters=aset)
    rid = engine.submit(_prompt(6, seed=1), 4, adapter="y")
    # lora_init's b is zero: the tenant decodes the base model's tokens
    np.testing.assert_array_equal(engine.run()[rid], _port_generate(_prompt(6, seed=1), 4))
