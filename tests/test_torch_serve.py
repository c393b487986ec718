"""The port's serving core against the JAX package, on the CPU.

- ``KVBlockPool``: the reference's two 1k-op random drills (plain and
  refcounted, tests/test_serve.py) run through the JAX pool and the port's
  with the same ops; the free list, the refcounts and the stats agree after
  every op, and both raise on the same ops.
- ``Scheduler``: the same submits, admissions, prefill and decode progress,
  cancels and expiries under a fake clock give the same admissions, decode
  batches, sheds and block lists, FIFO and deficit round-robin.
- ``ServeEngine``: tests/test_serve.py's ``TestEngineIdentity`` and
  ``TestSchedulerProperties`` cases and the lifecycle and overload cases on a
  tiny fp32 model carried over from the JAX package: a ragged batch through 2
  slots with chunked prefill is token-identical to the JAX ``generate`` of
  each prompt, eos frees a slot early, oversized and too-long requests are
  rejected at submit, nothing starves under random load, cancel and status
  work, no block leaks, and the arguments not ported yet raise.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlcloud_tpu.models import generate as jgen
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu.serve import kv_pool as jpool_mod
from dmlcloud_tpu.serve import scheduler as jsched_mod
from dmlcloud_tpu_torch.models import generate as tgen
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.serve import (TERMINAL_STATUSES, DuplicateRequest, KVBlockPool, PoolExhausted, ServeEngine,
                                      engine as tengine)
from dmlcloud_tpu_torch.serve import kv_pool as tpool_mod
from dmlcloud_tpu_torch.serve import scheduler as tsched_mod

torch.set_num_threads(2)

#: tests/conftest.py's tiny serve model
TINY = dict(vocab_size=61, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8, hidden_dim=32, mlp_dim=64,
            max_seq_len=64)


@functools.lru_cache(maxsize=None)
def _models():
    jmodel = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **TINY))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    tmodel = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **TINY), device="cpu")
    ttr.load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, 61, size=(n,)).astype(np.int32)


def _jax_generate(prompt, n, **kw):
    jmodel, params, _ = _models()
    return np.asarray(jgen.generate(jmodel, params, jnp.asarray(prompt)[None], n, **kw))[0]


def _port_generate(prompt, n, **kw):
    return tgen.generate(_models()[2], prompt[None], n, **kw).numpy()[0]


def _engine(**kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_slots", 2)
    kw.setdefault("prefill_chunk", 8)
    return ServeEngine(_models()[2], **kw)


def _drained(engine):
    assert engine.idle
    assert engine.leaked_blocks() == 0
    assert engine.pool.num_free == engine.pool.num_blocks
    engine.pool.assert_consistent()


class _Clock:
    """A fake clock: every read advances it by ``tick``."""

    def __init__(self, tick=1e-3):
        self.t, self.tick = 0.0, tick

    def __call__(self):
        self.t += self.tick
        return self.t


# ---------------------------------------------------------------------------
# block pool
# ---------------------------------------------------------------------------

def _pools(n=16):
    return (jpool_mod.KVBlockPool(2, 2, 8, num_blocks=n, block_size=4, dtype=jnp.float32),
            KVBlockPool(2, 2, 8, num_blocks=n, block_size=4, dtype=torch.float32, device="cpu"))


def _same_state(jp, tp):
    assert tp._free == jp._free
    assert tp._ref == jp._ref
    assert tp.stats() == jp.stats()


def _both(jp, tp, method, *args):
    """Call ``method`` on both pools: the same result, or the same exception."""
    out = []
    for pool in (jp, tp):
        try:
            out.append(("ok", getattr(pool, method)(*args)))
        except (jpool_mod.PoolExhausted, PoolExhausted):
            out.append(("exhausted", None))
        except ValueError as exc:
            out.append(("ValueError", str(exc)))
    assert out[0] == out[1], (method, args, out)
    return out[1][1]


@pytest.mark.parametrize("drill", ["plain", "refcounted"])
def test_random_1k_op_drills_keep_the_references_state(drill):
    """tests/test_serve.py's two drills, every op applied to both pools."""
    jp, tp = _pools(16)
    rs = np.random.RandomState(7 if drill == "plain" else 23)
    holders: list[list[int]] = []
    for _ in range(1000):
        if drill == "plain":
            op = "finish" if holders and (rs.rand() < 0.45 or tp.num_free == 0) else "admit"
            want = int(rs.randint(1, 5)) if op == "admit" else None
        else:
            op = ["admit", "finish", "share", "fork"][rs.randint(4)]
            want = int(rs.randint(1, 4)) if op == "admit" else None
        if op == "admit":
            got = _both(jp, tp, "alloc", want)
            if got is not None:
                holders.append(got)
        elif op == "finish" and holders:
            _both(jp, tp, "release" if drill == "refcounted" else "free", holders.pop(rs.randint(len(holders))))
        elif op == "share" and holders:
            src = holders[rs.randint(len(holders))]
            take = [b for b in src if rs.rand() < 0.5] or src[:1]
            _both(jp, tp, "retain", take)
            holders.append(list(take))
        elif op == "fork" and holders:
            h = holders[rs.randint(len(holders))]
            i = rs.randint(len(h))
            assert tp.is_shared(h[i]) == jp.is_shared(h[i])
            if tp.is_shared(h[i]) and tp.num_free >= 1:
                [new] = _both(jp, tp, "alloc", 1)
                _both(jp, tp, "release", [h[i]])
                h[i] = new
        _same_state(jp, tp)
        tp.assert_consistent()
        refs: dict[int, int] = {}
        for h in holders:
            for b in h:
                refs[b] = refs.get(b, 0) + 1
        assert tp.num_free + tp.num_live == 16 and tp.num_live == len(refs)
        assert all(tp.refcount(b) == n for b, n in refs.items())
    while holders:
        _both(jp, tp, "release", holders.pop())
    _same_state(jp, tp)
    assert tp.num_free == 16 and tp.num_live == 0


def test_pool_errors_match_the_reference():
    jp, tp = _pools(4)
    blocks = _both(jp, tp, "alloc", 3)
    assert _both(jp, tp, "alloc", 2) is None  # exhausted in both, allocating nothing
    assert tp.num_free == 1
    _both(jp, tp, "free", blocks)
    _both(jp, tp, "free", [blocks[0]])  # double free: ValueError in both
    _both(jp, tp, "free", [99])  # foreign block
    _both(jp, tp, "retain", [0])  # a free block cannot be retained
    [b] = _both(jp, tp, "alloc", 1)
    _both(jp, tp, "release", [b, b])  # below zero in one call: releases nothing
    assert tp.refcount(b) == 1
    _same_state(jp, tp)
    for n in (1, 4, 5, 9):
        assert tp.blocks_for(n) == jp.blocks_for(n)
    assert tp.bytes_per_block() == jp.bytes_per_block()
    assert tp.sentinel == jp.sentinel == 4


def test_assert_consistent_catches_a_corrupted_free_list():
    _, tp = _pools(4)
    tp.alloc(2)
    tp.assert_consistent()
    tp._free.append(tp._free[0])
    with pytest.raises(AssertionError, match="duplicate"):
        tp.assert_consistent()


def test_for_model_pages_and_default_device():
    cfg = _models()[2].cfg
    pool = KVBlockPool.for_model(cfg, num_blocks=5, block_size=4, device="cpu")
    k = pool.pools["layer_1"]["k"]
    assert k.shape == (5, 4, cfg.kv_heads, cfg.head_dim) and k.dtype == cfg.dtype and not k.any()
    assert sorted(pool.pools) == ["layer_0", "layer_1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            KVBlockPool.for_model(cfg, num_blocks=5, block_size=4)


# ---------------------------------------------------------------------------
# scheduler: the same decisions as the reference's
# ---------------------------------------------------------------------------

def _drive(pkg, fairness, shed_policy, max_waiting, seed, steps=400):
    """A random trace through ``pkg``'s Scheduler under a fake clock; returns
    the log of every decision and the queues after every op."""
    pool_mod, sched_mod = pkg
    kw = dict(dtype=jnp.float32) if pool_mod is jpool_mod else dict(dtype=torch.float32, device="cpu")
    pool = pool_mod.KVBlockPool(1, 1, 2, num_blocks=24, block_size=4, **kw)
    sched = sched_mod.Scheduler(pool, 3, 8, max_waiting=max_waiting, shed_policy=shed_policy, fairness=fairness)
    rs = np.random.RandomState(seed)
    seqs, log, now, next_id = [], [], 0.0, 0
    ids = lambda xs: [s.req.id for s in xs]
    for _ in range(steps):
        now += float(rs.uniform(0, 1))
        op = rs.randint(6)
        if op in (0, 1):
            n, m = int(rs.randint(1, 20)), int(rs.randint(1, 8))
            tenant, prio = "abc"[rs.randint(3)], int(rs.randint(-2, 3))
            deadline = now + float(rs.uniform(2, 40)) if rs.rand() < 0.4 else None
            seq = sched_mod._Sequence(
                req=sched_mod.Request(prompt=np.zeros(n, np.int32), max_new_tokens=m, priority=prio, tenant=tenant,
                                      id=next_id),
                arrival=now, deadline=deadline, tenant=tenant, priority=prio)
            next_id += 1
            try:
                shed = sched.submit(seq)
            except ValueError as exc:
                log.append(("rejected", str(exc)))
                continue
            seqs.append(seq)
            for victim in shed:
                sched.terminate(victim, now, "shed")
            log.append(("shed", ids(shed)))
        elif op == 2:
            log.append(("admit", [(s.req.id, list(s.blocks)) for s in sched.admit(now)]))
        elif op == 3:
            seq = sched.next_prefill()
            if seq is not None:
                seq.fill = min(seq.fill + sched.prefill_chunk, seq.prompt_len)
                if seq.prefilled:
                    sched.prefill_done(seq)
                    seq.out.append(0)
                log.append(("prefill", seq.req.id, seq.fill))
        elif op == 4:
            batch = sched.decode_batch()
            log.append(("decode", ids(batch)))
            for s in batch:
                s.fill += 1
                s.out.append(1)
                if len(s.out) >= s.req.max_new_tokens:
                    sched.finish(s, now)
        else:
            log.append(("expire", ids(sched.expire(now))))
            live = [s for s in seqs if s.status is None]
            if live and rs.rand() < 0.3:
                victim = live[rs.randint(len(live))]
                log.append(("cancel", victim.req.id, sched.terminate(victim, now, "cancelled")))
        log.append((ids(sched.iter_waiting()), ids(sched.prefilling), ids(sched.running), list(pool._free),
                    sched.num_waiting, sched.active, sched.idle))
    log.append([(s.req.id, s.status, s.admitted, s.finished) for s in seqs])
    return log


@pytest.mark.parametrize("fairness,shed_policy,max_waiting", [
    ("fifo", "reject", None), ("fifo", "reject", 3), ("fifo", "oldest-deadline", 3),
    ("tenant", "reject", None), ("tenant", "oldest-deadline", 4),
])
def test_scheduler_decides_as_the_reference_does(fairness, shed_policy, max_waiting):
    for seed in range(3):
        want = _drive((jpool_mod, jsched_mod), fairness, shed_policy, max_waiting, seed)
        got = _drive((tpool_mod, tsched_mod), fairness, shed_policy, max_waiting, seed)
        assert got == want
        assert any(entry[0] == "admit" and entry[1] for entry in want if isinstance(entry[0], str))


def test_scheduler_validation_matches_the_reference():
    jp, tp = _pools(4)
    for kw in (dict(max_slots=0, prefill_chunk=8), dict(max_slots=1, prefill_chunk=0),
               dict(max_slots=1, prefill_chunk=8, lookahead=-1), dict(max_slots=1, prefill_chunk=8, max_waiting=0),
               dict(max_slots=1, prefill_chunk=8, shed_policy="lifo"),
               dict(max_slots=1, prefill_chunk=8, fairness="random")):
        with pytest.raises(ValueError) as jerr:
            jsched_mod.Scheduler(jp, **kw)
        with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
            tsched_mod.Scheduler(tp, **kw)


# ---------------------------------------------------------------------------
# engine: token identity with serial generate
# ---------------------------------------------------------------------------

def test_ragged_batch_matches_serial_jax_generate():
    """Four ragged requests through 2 slots (slot churn, chunked prefill of
    the 22-token prompt): every output token-identical to the JAX
    ``generate`` of the same prompt."""
    specs = [(7, 6), (13, 4), (5, 9), (22, 5)]
    engine = _engine()
    rids = [engine.submit(_prompt(n, seed=i), m) for i, (n, m) in enumerate(specs)]
    out = engine.run()
    for rid, (n, m) in zip(rids, specs):
        np.testing.assert_array_equal(out[rid], _jax_generate(_prompt(n, seed=rid), m))
        seq = engine.sequence(rid)
        assert seq.arrival <= seq.admitted <= seq.first_token <= seq.finished
    assert engine.statuses() == {rid: "ok" for rid in rids}
    _drained(engine)


def test_eos_frees_slot_early():
    prompt = _prompt(9, seed=3)
    ref = _jax_generate(prompt, 8)
    j = next(j for j in range(1, 8) if ref[j] not in ref[:j])  # the first fresh token after the first
    engine = _engine(eos_id=int(ref[j]))
    rid = engine.submit(prompt, 8)
    np.testing.assert_array_equal(engine.run()[rid], ref[: j + 1])  # eos emitted, then stop
    _drained(engine)


def test_oversized_request_rejected_at_submit():
    engine = _engine(num_blocks=4, max_slots=2)
    with pytest.raises(ValueError, match="blocks worst-case"):
        engine.submit(_prompt(30), 30)  # needs 15 blocks, the pool has 4
    with pytest.raises(ValueError, match="max_seq_len"):
        _engine().submit(_prompt(40), 40)  # 80 > max_seq_len 64
    with pytest.raises(ValueError, match="at least one token"):
        _engine().submit([], 4)


def test_no_starvation_under_random_load():
    """30 random requests into 3 slots over a tight pool: every request
    finishes with its budget and the serial ``generate``'s tokens, admissions
    are strict FIFO, the pool drains clean."""
    rs = np.random.RandomState(11)
    engine = _engine(num_blocks=24, max_slots=3, clock=_Clock())
    specs = [(int(rs.randint(1, 20)), int(rs.randint(1, 8))) for _ in range(30)]
    rids = [engine.submit(_prompt(n, seed=100 + i), m) for i, (n, m) in enumerate(specs)]
    out = engine.run(max_steps=5000)
    assert sorted(out) == sorted(rids), "an admitted request starved"
    for i, (rid, (n, m)) in enumerate(zip(rids, specs)):
        np.testing.assert_array_equal(out[rid], _port_generate(_prompt(n, seed=100 + i), m))
    admits = [engine.sequence(r).admitted for r in rids]
    assert admits == sorted(admits)
    _drained(engine)


def test_per_request_sampling_keeps_greedy_rows_identical():
    """A batch mixing greedy and sampled requests: the greedy rows decode the
    serial ``generate``'s tokens, the sampled ones are reproducible from the
    engine's generator."""
    greedy = [_prompt(6, seed=1), _prompt(9, seed=2)]

    def run(seed):
        engine = _engine(max_slots=4, generator=torch.Generator().manual_seed(seed))
        g = [engine.submit(p, 6) for p in greedy]
        s = [engine.submit(_prompt(7, seed=3), 6, temperature=0.9, top_k=10),
             engine.submit(_prompt(5, seed=4), 6, temperature=1.2, top_p=0.8)]
        out = engine.run()
        _drained(engine)
        return [out[r] for r in g], [out[r] for r in s]

    g1, s1 = run(0)
    g2, s2 = run(0)
    for got, prompt in zip(g1, greedy):
        np.testing.assert_array_equal(got, _jax_generate(prompt, 6))
    assert all(np.array_equal(a, b) for a, b in zip(s1, s2))
    assert all(((x >= 0) & (x < 61)).all() and len(x) == 6 for x in s1)


def test_per_request_eos_and_engine_default():
    prompt = _prompt(8, seed=5)
    ref = _port_generate(prompt, 6)
    j = next(j for j in range(1, 6) if ref[j] not in ref[:j])
    engine = _engine()
    a = engine.submit(prompt, 6, eos_id=int(ref[j]))
    b = engine.submit(prompt, 6)
    out = engine.run()
    np.testing.assert_array_equal(out[a], ref[: j + 1])
    np.testing.assert_array_equal(out[b], ref)


# ---------------------------------------------------------------------------
# engine: lifecycle and overload control (tests/test_serve.py)
# ---------------------------------------------------------------------------

def test_cancel_queued_and_running_releases_everything():
    engine = _engine(max_slots=1)
    r_run = engine.submit(_prompt(5, seed=1), 12)
    r_ok = engine.submit(_prompt(7, seed=2), 4)
    r_queued = engine.submit(_prompt(6, seed=3), 4)
    for _ in range(3):
        engine.step()
    assert engine.status(r_run) == "running" and engine.status(r_queued) == "queued"
    assert engine.cancel(r_run) and engine.cancel(r_queued)
    assert engine.status(r_run) == engine.status(r_queued) == "cancelled"
    assert not engine.cancel(r_run)  # idempotent: no double free
    engine.run(max_steps=2000)
    assert engine.status(r_ok) == "ok"
    np.testing.assert_array_equal(engine.output(r_ok), _jax_generate(_prompt(7, seed=2), 4))
    _drained(engine)
    with pytest.raises(KeyError):
        engine.output(r_run)  # cancelled work has no output
    with pytest.raises(KeyError):
        engine.status(9999)
    assert not engine.cancel(9999)


def test_deadlines_with_a_fake_clock():
    t = [0.0]
    engine = _engine(max_slots=1, clock=lambda: t[0])
    r_doomed = engine.submit(_prompt(5, seed=4), 20, deadline_s=1.0)
    r_waiting = engine.submit(_prompt(5, seed=7), 4, deadline_s=0.5)
    r_ok = engine.submit(_prompt(5, seed=5), 4)
    for _ in range(3):
        engine.step()
    assert engine.status(r_doomed) == "running" and engine.status(r_waiting) == "queued"
    t[0] = 2.0  # past both deadlines: one mid-decode, one still queued
    engine.run(max_steps=2000)
    assert engine.statuses() == {r_doomed: "deadline_exceeded", r_waiting: "deadline_exceeded", r_ok: "ok"}
    _drained(engine)
    with pytest.raises(ValueError, match="deadline_s"):
        engine.submit(_prompt(4), 4, deadline_s=0.0)


def test_random_cancels_and_deadlines_end_terminal_without_leaks():
    rs = np.random.RandomState(23)
    clock = _Clock(tick=0.01)
    engine = _engine(num_blocks=32, max_slots=3, clock=clock)
    rids = []
    for i in range(14):
        kw = {"deadline_s": float(rs.uniform(0.05, 3.0))} if rs.rand() < 0.5 else {}
        rids.append(engine.submit(_prompt(int(rs.randint(1, 16)), seed=400 + i), int(rs.randint(1, 8)), **kw))
    for _ in range(3000):
        if engine.idle:
            break
        if rs.rand() < 0.2:
            engine.cancel(rids[rs.randint(len(rids))])
        engine.step()
        engine.pool.assert_consistent()
    statuses = [engine.status(r) for r in rids]
    assert all(s in TERMINAL_STATUSES for s in statuses), statuses
    assert {"ok", "cancelled"} <= set(statuses)
    for rid, s in zip(rids, statuses):
        if s == "ok":
            assert len(engine.output(rid)) == engine.sequence(rid).req.max_new_tokens
    _drained(engine)


def test_bounded_queue_reject_policy_sheds_arrivals():
    engine = _engine(max_slots=1, max_waiting=2)
    r_run = engine.submit(_prompt(5, seed=10), 10)
    engine.step()
    kept = [engine.submit(_prompt(4, seed=11 + i), 3) for i in range(2)]
    shed = [engine.submit(_prompt(4, seed=13 + i), 3) for i in range(2)]
    assert [engine.status(r) for r in shed] == ["shed", "shed"]
    engine.run(max_steps=2000)
    assert [engine.status(r) for r in [r_run, *kept]] == ["ok", "ok", "ok"]
    _drained(engine)


def test_oldest_deadline_policy_sheds_the_doomed_victim():
    engine = _engine(max_slots=1, max_waiting=1, shed_policy="oldest-deadline")
    engine.submit(_prompt(5, seed=20), 10)
    engine.step()
    r_doomed = engine.submit(_prompt(4, seed=21), 3, deadline_s=0.5)
    r_late = engine.submit(_prompt(4, seed=22), 3, deadline_s=60.0)
    assert engine.status(r_doomed) == "shed" and engine.status(r_late) == "queued"
    r_low = engine.submit(_prompt(4, seed=23), 3, priority=-1, deadline_s=0.1)
    assert engine.status(r_low) == "shed" and engine.status(r_late) == "queued"
    engine.run(max_steps=2000)
    assert engine.status(r_late) == "ok"
    _drained(engine)


def test_tenant_fairness_interleaves_a_cold_tenant():
    engine = _engine(max_slots=2, fairness="tenant", clock=_Clock())
    hot = [engine.submit(_prompt(5, seed=30 + i), 3, tenant="hot") for i in range(8)]
    cold = [engine.submit(_prompt(5, seed=40 + i), 3, tenant="cold") for i in range(2)]
    engine.run(max_steps=3000)
    assert all(engine.status(r) == "ok" for r in hot + cold)
    order = sorted(hot + cold, key=lambda r: engine.sequence(r).admitted)
    for rc in cold:  # every cold request beats at least the hot tail to admission
        assert order.index(rc) < order.index(hot[-1])
    _drained(engine)


def test_priority_never_reorders_fifo_admission():
    engine = _engine(max_slots=2, clock=_Clock())
    rids = [engine.submit(_prompt(4, seed=50 + i), 2, priority=p) for i, p in enumerate([5, -3, 9, 0, -7, 2])]
    engine.run(max_steps=2000)
    admits = [engine.sequence(r).admitted for r in rids]
    assert admits == sorted(admits) and all(engine.status(r) == "ok" for r in rids)


def test_idempotency_tokens_and_retention():
    engine = _engine(max_done=2)
    rid = engine.submit(_prompt(4, seed=1), 2, token="t-1")
    with pytest.raises(DuplicateRequest) as err:
        engine.submit(_prompt(4, seed=1), 2, token="t-1")
    assert err.value.rid == rid
    others = [engine.submit(_prompt(4, seed=2 + i), 2) for i in range(2)]
    engine.run()
    assert sorted(engine.statuses()) == others  # the oldest record aged out, with its token
    engine.submit(_prompt(4, seed=1), 2, token="t-1")


def test_a_failing_step_fails_only_its_requests(monkeypatch):
    engine = _engine(max_slots=2)
    good = engine.submit(_prompt(5, seed=1), 3)
    engine.run()
    bad = engine.submit(_prompt(5, seed=2), 3)

    def boom(*args, **kwargs):
        raise RuntimeError("injected")

    monkeypatch.setattr(tengine, "_paged_step", boom)
    engine.run()
    assert engine.status(good) == "ok" and engine.status(bad) == "error"
    _drained(engine)


@pytest.mark.parametrize("name,value", [("verify", "warn"), ("hbm_budget", 1 << 30)])
def test_arguments_not_ported_yet_raise(name, value):
    assert name in tengine._NOT_PORTED
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _engine(**{name: value})
    _engine(**{name: tengine._NOT_PORTED[name][0]})  # the default is accepted


def test_submit_arguments_not_ported_yet_raise():
    """Only the construction-time verify's arguments wait (item 13); every
    argument of the reference's ``submit`` is ported: ``adapter`` raises the
    reference's ``ValueError`` on an engine without an ``AdapterSet``, and
    ``trace`` names the request's trace."""
    import inspect

    from dmlcloud_tpu.serve.engine import ServeEngine as JEngine

    assert sorted(tengine._NOT_PORTED) == ["hbm_budget", "verify"]
    assert list(inspect.signature(ServeEngine.submit).parameters) == list(inspect.signature(JEngine.submit).parameters)
    engine = _engine()
    with pytest.raises(ValueError, match="no AdapterSet"):
        engine.submit(_prompt(4), 2, "tenant-a")
    assert engine.idle and engine.statuses() == {}
    rid = engine.submit(_prompt(4), 2, trace="tr-custom")
    assert engine.sequence(rid).trace == "tr-custom" and engine.sequence(engine.submit(_prompt(4), 2)).trace == "tr-1"
    engine.run()
    _drained(engine)


def test_unknown_arguments_raise_and_buckets_pad_nothing():
    with pytest.raises(TypeError, match="guard"):
        _engine(guard="raise")
    engine = _engine(batch_buckets=[1, 2], table_buckets=[4, 8])
    rid = engine.submit(_prompt(6, seed=9), 4)
    np.testing.assert_array_equal(engine.run()[rid], _port_generate(_prompt(6, seed=9), 4))
