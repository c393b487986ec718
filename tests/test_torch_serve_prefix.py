"""The port's prefix cache against the JAX package's, on the CPU.

- ``_mix_u64``/``root_key``/``content_key``/``prefix_keys``: the reference's
  integers on random tokens, adapters and block sizes.
- ``PrefixCache`` over the refcounted pool: the reference's unit cases
  (tests/test_serve.py ``TestPrefixCacheUnit``) run on both packages with the
  same results, and a random 1k-op drill of ``match``/``lock``/``insert``/
  ``evict``/release leaves the same stats, block lists, evictions, free list
  and refcounts after every op.
- ``Scheduler`` with a prefix cache and ``lookahead > 0``: the same random
  trace makes the reference's admissions (shared blocks, cached tokens, COW
  spares, divergence points), evictions and queues.
- ``ServeEngine(prefix_cache=True)`` on the tiny fp32 model (``TestPrefixEngine``):
  warm templates, an exact duplicate (the COW fork), eviction pressure, an
  80 %-shared random load and a multi-turn follow-up give the reference
  engine's tokens, hits, cached and saved tokens, COW forks and tree, equal to
  the uncached engine and to serial ``generate``, with 0 leaked blocks and
  locks.
"""

import functools
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlcloud_tpu.serve import kv_pool as jpool_mod
from dmlcloud_tpu.serve import prefix_cache as jpc
from dmlcloud_tpu.serve import scheduler as jsched_mod
from dmlcloud_tpu.serve.engine import ServeEngine as JEngine
from dmlcloud_tpu.telemetry import journal as jjournal
from dmlcloud_tpu_torch.serve import KVBlockPool, ServeEngine
from dmlcloud_tpu_torch.serve import kv_pool as tpool_mod
from dmlcloud_tpu_torch.serve import prefix_cache as tpc
from dmlcloud_tpu_torch.serve import scheduler as tsched_mod
from dmlcloud_tpu_torch.telemetry import journal as tjournal
from test_torch_serve import _models, _port_generate, _prompt

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# content addresses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_size,adapter,seed", [(4, 0, 0), (16, 3, 1), (1, 7, 2), (5, 2**40, 3)])
def test_content_keys_are_the_references_integers(block_size, adapter, seed):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, 50000, size=int(rs.randint(1, 90)))
    assert tpc.prefix_keys(toks, block_size, adapter=adapter) == jpc.prefix_keys(toks, block_size, adapter=adapter)
    assert tpc.root_key(adapter) == jpc.root_key(adapter)
    assert tpc.content_key(12345, toks[:7]) == jpc.content_key(12345, toks[:7])
    for a, b in rs.randint(0, 2**62, size=(8, 2)):
        assert tpc._mix_u64(int(a), int(b)) == jpc._mix_u64(int(a), int(b))


# ---------------------------------------------------------------------------
# the cache over the refcounted pool
# ---------------------------------------------------------------------------

def _caches(n=16):
    jp = jpool_mod.KVBlockPool(2, 2, 8, num_blocks=n, block_size=4, dtype=jnp.float32)
    tp = KVBlockPool(2, 2, 8, num_blocks=n, block_size=4, dtype=torch.float32, device="cpu")
    return (jp, jpc.PrefixCache(jp)), (tp, tpc.PrefixCache(tp))


def _toks(n, seed=0):
    return np.random.RandomState(seed).randint(0, 61, size=n).astype(np.int32)


def _unit(case, pool, cache):
    """One of tests/test_serve.py's ``TestPrefixCacheUnit`` cases on either
    package; returns everything it observes."""
    obs = []
    if case == "roundtrip":
        toks = _toks(10)
        blocks = pool.alloc(3)
        obs += [cache.insert(toks, blocks), pool.refcount(blocks[0]), pool.refcount(blocks[2])]
        m = cache.match(toks)
        obs += [m.tokens, m.blocks, cache.lock(m), pool.refcount(blocks[0])]
    elif case == "block_granular":
        toks = _toks(8, seed=1)
        cache.insert(toks, pool.alloc(2))
        inner = toks.copy()
        inner[6] = (inner[6] + 1) % 61
        obs += [cache.match(np.concatenate([toks[:4], _toks(4, seed=2)])).tokens, cache.match(inner).tokens,
                cache.match(toks[:3]).tokens]
    elif case == "chained":
        a, b, tail = _toks(4, seed=3), _toks(4, seed=4), _toks(4, seed=5)
        cache.insert(np.concatenate([a, tail]), pool.alloc(2))
        obs += [cache.match(np.concatenate([b, tail])).tokens, cache.match(np.concatenate([a, tail])).tokens,
                [n.key for n in cache.match(np.concatenate([a, tail])).nodes]]
    elif case == "evict_lru":
        p1, p2 = _toks(8, seed=6), _toks(8, seed=7)
        b1, b2 = pool.alloc(2), pool.alloc(2)
        cache.insert(p1, b1)
        cache.insert(p2, b2)
        pool.release(b1 + b2)  # the tree's references only
        locked, _ = cache.lock(cache.match(p2))  # pins p2's chain
        cache.match(p1)
        obs += [cache.evictable(), cache.evict(pool.num_blocks), cache.stats(), cache.leaked_locks()]
        pool.release(locked)
        obs += [cache.evict(pool.num_blocks), cache.stats(), cache.leaked_locks()]
    elif case == "lock_race":
        toks = _toks(12, seed=8)
        blocks = pool.alloc(3)
        cache.insert(toks, blocks)
        pool.release(blocks)
        m = cache.match(toks)
        obs += [cache.evict(pool.num_blocks - 1)]  # drops the chain's leaf: stale handle
        obs += [cache.lock(m), cache.stats()]
    elif case == "adapters":
        toks = _toks(8, seed=9)
        cache.insert(toks, pool.alloc(2), adapter=1)
        obs += [cache.match(toks, adapter=0).tokens, cache.match(toks, adapter=1).tokens, cache.stats()]
    obs += [pool.stats(), list(pool._free), dict(pool._ref)]
    return obs


@pytest.mark.parametrize("case", ["roundtrip", "block_granular", "chained", "evict_lru", "lock_race", "adapters"])
def test_prefix_cache_unit_cases_match_the_reference(case):
    (jp, jc), (tp, tc) = _caches()
    assert _unit(case, tp, tc) == _unit(case, jp, jc)


def _drill(pool, cache, seed, ops=1000):
    """A random drill of match/lock/insert/evict/release over template-shaped
    prompts; returns the log of every result and the state after every op."""
    rs = np.random.RandomState(seed)
    templates = [_toks(12, seed=100 + t) for t in range(3)]
    holders: list[list[int]] = []
    pending: list = []  # matches not locked yet (stale after an eviction)
    log = []
    for _ in range(ops):
        op = rs.randint(5)
        tmpl = templates[rs.randint(3)]
        toks = np.concatenate([tmpl[: rs.randint(0, 13)], _toks(int(rs.randint(0, 9)), seed=int(rs.randint(1 << 20)))])
        adapter = int(rs.randint(2))
        if op == 0:  # a request's written blocks enter the tree
            need = pool.blocks_for(len(toks))
            if need and need <= pool.num_free:
                blocks = pool.alloc(need)
                holders.append(blocks)
                log.append(("insert", cache.insert(toks, blocks, adapter=adapter)))
        elif op == 1:
            m = cache.match(toks, adapter=adapter)
            pending.append(m)
            log.append(("match", m.tokens, m.blocks))
        elif op == 2 and pending:
            blocks, n = cache.lock(pending.pop(rs.randint(len(pending))))
            if blocks:
                holders.append(blocks)
            log.append(("lock", blocks, n))
        elif op == 3 and holders:
            pool.release(holders.pop(rs.randint(len(holders))))
        else:
            log.append(("evict", cache.evict(int(rs.randint(1, pool.num_blocks + 1)))))
        log.append((cache.stats(), cache.evictable(), sorted(cache.leaked_locks()), list(pool._free),
                    sorted(pool._ref.items())))
        pool.assert_consistent()
    while holders:
        pool.release(holders.pop())
    log.append((cache.leaked_locks(), cache.evict(pool.num_blocks), pool.num_free))
    return log


@pytest.mark.parametrize("seed", [0, 1])
def test_random_1k_op_drill_keeps_the_references_state(seed):
    (jp, jc), (tp, tc) = _caches(24)
    want = _drill(jp, jc, seed)
    got = _drill(tp, tc, seed)
    assert got == want
    assert any(e[0] == "evict" and e[1] for e in want if isinstance(e[0], str))
    assert any(e[0] == "lock" and e[1] for e in want if isinstance(e[0], str))


# ---------------------------------------------------------------------------
# scheduler: prefix-cache admission with a speculative lookahead
# ---------------------------------------------------------------------------

def _drive(pkg, lookahead, seed, steps=300):
    """A random trace through ``pkg``'s Scheduler with a prefix cache: prompts
    from three templates, finished requests publish their blocks."""
    pool_mod, sched_mod, pc_mod = pkg
    kw = dict(dtype=jnp.float32) if pool_mod is jpool_mod else dict(dtype=torch.float32, device="cpu")
    pool = pool_mod.KVBlockPool(1, 1, 2, num_blocks=28, block_size=4, **kw)
    cache = pc_mod.PrefixCache(pool)
    sched = sched_mod.Scheduler(pool, 3, 8, lookahead=lookahead, prefix_cache=cache)
    rs = np.random.RandomState(seed)
    templates = [_toks(12, seed=200 + t) for t in range(3)]
    log, now, next_id = [], 0.0, 0
    ids = lambda xs: [s.req.id for s in xs]
    for _ in range(steps):
        now += 1.0
        op = rs.randint(4)
        if op == 0:
            prompt = np.concatenate([templates[rs.randint(3)][: rs.randint(4, 13)], _toks(int(rs.randint(0, 6)),
                                                                                         seed=next_id)])
            seq = sched_mod._Sequence(req=sched_mod.Request(prompt=prompt, max_new_tokens=int(rs.randint(1, 6)),
                                                            id=next_id), arrival=now)
            next_id += 1
            sched.submit(seq)
        elif op == 1:
            log.append(("admit", [(s.req.id, list(s.blocks), s.shared, s.cached_tokens, s.cow_spare, s.fill)
                                  for s in sched.admit(now)]))
        elif op == 2:
            seq = sched.next_prefill()
            if seq is not None:
                seq.fill = min(seq.fill + sched.prefill_chunk, seq.prompt_len)
                if seq.prefilled:
                    sched.prefill_done(seq)
                    cache.insert(seq.req.prompt, seq.blocks)
                    seq.out.append(0)
        else:
            for s in sched.decode_batch():
                s.fill += 1
                s.out.append(1)
                if len(s.out) >= s.req.max_new_tokens:
                    sched.finish(s, now)
        log.append((ids(sched.iter_waiting()), ids(sched.prefilling), ids(sched.running), list(pool._free),
                    sorted(pool._ref.items()), cache.stats()))
    return log


@pytest.mark.parametrize("lookahead", [0, 3])
def test_scheduler_with_a_prefix_cache_decides_as_the_reference_does(lookahead):
    for seed in range(2):
        want = _drive((jpool_mod, jsched_mod, jpc), lookahead, seed)
        got = _drive((tpool_mod, tsched_mod, tpc), lookahead, seed)
        assert got == want
        assert any(entry[0] == "admit" and any(a[3] for a in entry[1]) for entry in want if isinstance(entry[0], str))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _template_prompt(tmpl, n_suffix, seed):
    return np.concatenate([tmpl, np.random.RandomState(seed).randint(0, 61, n_suffix).astype(np.int32)])


def _scenario_requests(name):
    """``(engine kwargs, waves)``: each wave is a list of ``(prompt, max_new)``
    submitted together, then run to idle."""
    if name == "warm":
        tmpl = _prompt(16, seed=40)
        return dict(max_slots=1), [[(_template_prompt(tmpl, n, s), 5) for n, s in ((3, 41), (5, 42), (2, 43))]]
    if name == "duplicate":
        prompt = _prompt(16, seed=44)  # 4 full blocks: the re-fed token forks the last
        return dict(max_slots=1), [[(prompt, 5)]] * 3
    if name == "eviction":
        rs = np.random.RandomState(45)
        return dict(num_blocks=16, max_slots=2), [[(_prompt(int(rs.randint(4, 20)), seed=500 + i), 4)
                                                   for i in range(12)]]
    if name == "shared_load":
        rs = np.random.RandomState(46)
        templates = [_prompt(12, seed=600 + t) for t in range(3)]
        reqs = []
        for i in range(14):
            if i % 5 != 4:
                reqs.append((_template_prompt(templates[int(rs.randint(3))], int(rs.randint(1, 5)), 700 + i),
                             int(rs.randint(1, 6))))
            else:
                reqs.append((_prompt(int(rs.randint(2, 14)), seed=700 + i), int(rs.randint(1, 6))))
        return dict(num_blocks=20, max_slots=3), [reqs]
    raise KeyError(name)


def _serve(pkg, name, prefix=True):
    """Run a scenario through ``pkg``'s engine with its journal armed."""
    kw, waves = _scenario_requests(name)
    kw = dict(dict(num_blocks=64, block_size=4, prefill_chunk=8), **kw)
    jmodel, params, tmodel = _models()
    with tempfile.TemporaryDirectory() as tmp:
        if pkg == "jax":
            jmod = jjournal
            engine = JEngine(jmodel, params, prefix_cache=prefix, batch_buckets=[kw["max_slots"]],
                             table_buckets=[16], **kw)
        else:
            jmod = tjournal
            engine = ServeEngine(tmodel, prefix_cache=prefix, **kw)
        j = jmod.activate(jmod.SpanJournal(tmp, ring_size=1 << 20))
        try:
            rids = []
            for wave in waves:
                rids += [engine.submit(p, m) for p, m in wave]
                engine.run(max_steps=5000)
                if name == "duplicate":
                    engine.pool.assert_consistent()
        finally:
            jmod.deactivate()
        spans = j.tail(1 << 20)
    out = {
        "tokens": [np.asarray(engine.output(r)).tolist() for r in rids],
        "statuses": [engine.status(r) for r in rids],
        "cached": [engine.ledger.records[r].get("cached_tokens") for r in rids],
        "saved": [engine.ledger.records[r].get("saved_tokens") for r in rids],
        "forks": [(r["request"], r["cow_block"]) for r in spans if r["kind"] == "cow_fork"],
        "admits": [(r["request"], r["blocks"], r["cached"]) for r in spans if r["kind"] == "admission"],
        "leaked": engine.leaked_blocks(),
        "pool": (engine.pool.num_free, engine.pool.num_live),
    }
    if prefix:
        summary = engine.ledger.summary()
        out["summary"] = {k: summary[k] for k in ("prefix_hit_rate", "cached_token_frac", "prefill_tokens_saved",
                                                 "prefill_tokens_saved_frac", "statuses", "total_tokens")}
        out["tree"] = engine.prefix.stats()
        out["locks"] = engine.prefix.leaked_locks()
    return out


@functools.lru_cache(maxsize=None)
def _reference(name):
    return _serve("jax", name)


@pytest.mark.parametrize("name", ["warm", "duplicate", "eviction", "shared_load"])
def test_prefix_engine_equals_the_reference_engine(name):
    want = _reference(name)
    got = _serve("torch", name)
    assert got == want
    assert got["leaked"] == 0 and got["locks"] == []
    # and the tokens are the uncached engine's and serial generate's
    plain = _serve("torch", name, prefix=False)
    assert plain["tokens"] == got["tokens"]
    _, waves = _scenario_requests(name)
    reqs = [r for wave in waves for r in wave]
    for toks, (p, m) in zip(got["tokens"], reqs):
        assert toks == _port_generate(p, m).tolist()


def test_scenarios_exercise_what_they_name():
    assert _reference("warm")["cached"] == [0, 16, 16] and _reference("warm")["saved"] == [0, 16, 16]
    dup = _reference("duplicate")
    assert dup["cached"] == [0, 16, 16] and dup["saved"] == [0, 15, 15] and len(dup["forks"]) == 2
    assert _reference("eviction")["tree"]["evictions"] > 0
    assert _reference("shared_load")["summary"]["prefix_hit_rate"] > 0.3


def test_multi_turn_blocks_are_published_at_finish():
    """A finished request's decoded full blocks enter the tree: a follow-up
    whose prompt extends prompt + output hits past the first prompt, as in
    the reference engine."""
    jmodel, params, tmodel = _models()
    prompt = _prompt(8, seed=49)
    res = []
    for engine in (JEngine(jmodel, params, num_blocks=64, block_size=4, max_slots=1, prefill_chunk=8,
                           prefix_cache=True, batch_buckets=[1], table_buckets=[16]),
                   ServeEngine(tmodel, num_blocks=64, block_size=4, max_slots=1, prefill_chunk=8, prefix_cache=True)):
        r1 = engine.submit(prompt, 8)
        engine.run(max_steps=2000)
        turn2 = np.concatenate([prompt, engine.output(r1), _prompt(3, seed=50)])
        r2 = engine.submit(turn2, 4)
        engine.run(max_steps=2000)
        res.append((np.asarray(engine.output(r1)).tolist(), np.asarray(engine.output(r2)).tolist(),
                    engine.ledger.records[r2]["cached_tokens"], engine.prefix.stats(), engine.leaked_blocks()))
        last = (turn2, engine.output(r2))
    assert res[1] == res[0]
    assert res[1][2] == 12 and res[1][4] == 0
    np.testing.assert_array_equal(last[1], _port_generate(last[0], 4))
