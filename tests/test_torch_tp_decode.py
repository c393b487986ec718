"""Decode, serving and per-row adapters under tensor parallelism, over two
gloo processes on the CPU (``model=2``), against one process and the JAX
package.

Tiny fp32 models (vocab 64, 2 layers, 4 heads of 8 over 2 KV heads, hidden
32, MLP 64; a dense one and one whose second block is MoE, its experts'
hidden dim split over ``model``) are initialised by the JAX package. Each of
two processes lays one out under ``llama_partition_rules()`` on ``model=2``
(heads, the MLP hidden dim, the embedding's features and the LM head's vocab
split) and feeds the same inputs:

- ``init_cache``/``KVBlockPool.for_model`` of the sharded model hold one KV
  head per rank;
- ``decode_step`` (a dense cache with ``attend_len``, and paged): the logits
  of a prefill and two steps within ``REL`` of one process;
- ``generate`` greedy and ``beam_search`` tokens equal to one process's and to
  the JAX package's; sampled ``generate`` from a ``torch.Generator`` seeded the
  same on both ranks gives the same tokens on both, and one process's;
- ``ServeEngine`` (3 requests, 2 slots) tokens equal to one process's and to
  the JAX ``generate``'s; a prefix-cache engine whose exact duplicate forks a
  shared block (COW) and a Medusa engine with the default heads (the whole LM
  head gathered over ``model``) give one process's tokens and counts;
- per-row adapters (the reference's ``AdapterSet`` of 3 tenants): the dense
  forward and a decode step within ``REL`` of one process.
"""

import functools
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlcloud_tpu.models import generate as jgen
from dmlcloud_tpu.models import lora as jlora
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu.serve.adapters import AdapterSet
from dmlcloud_tpu_torch.models import generate as tgen
from dmlcloud_tpu_torch.models import lora as tlora
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.serve import KVBlockPool, ServeEngine
from dmlcloud_tpu_torch.utils import tcp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
#: one process against two, fp32: the row-parallel sums run in another order
REL = 1e-5
TINY = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8, hidden_dim=32, mlp_dim=64,
            max_seq_len=32)
VARIANTS = {"dense": {}, "moe": dict(num_experts=4, moe_every=2)}


def prompt(b=2, t=6, seed=0) -> np.ndarray:
    return np.random.RandomState(seed).randint(1, 64, (b, t)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_models(variant: str):
    jmodel = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **TINY, **VARIANTS[variant]))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(prompt()))["params"]
    return jmodel, params


@functools.lru_cache(maxsize=None)
def adapter_set():
    _, params = jax_models("dense")
    rng = np.random.RandomState(5)
    tenants = {}
    for i in range(3):
        tree = jlora.lora_init(jax.random.PRNGKey(i), params, rank=4, in_axes=1)
        tenants[f"t{i}"] = jax.tree_util.tree_map(
            lambda p: p if p is None else jlora.LoraPair(a=p.a, b=jnp.asarray(rng.randn(*p.b.shape) * 0.1, jnp.float32)),
            tree, is_leaf=lambda x: x is None or isinstance(x, jlora.LoraPair))
    return AdapterSet(tenants, alpha=8.0, base=params)


def _numpy_pairs(tree):
    if isinstance(tree, dict):
        return {k: _numpy_pairs(v) for k, v in tree.items()}
    if isinstance(tree, jlora.LoraPair):
        return ("pair", np.asarray(tree.a, np.float32), np.asarray(tree.b, np.float32))
    return tree


def _torch_pairs(tree):
    if isinstance(tree, dict):
        return {k: _torch_pairs(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and tree and tree[0] == "pair":
        return tlora.LoraPair(a=torch.from_numpy(tree[1]), b=torch.from_numpy(tree[2]))
    return tree


def inputs() -> dict:
    """The trees and the adapters every process loads (numpy, picklable)."""
    return {"trees": {v: jax.tree_util.tree_map(np.asarray, jax_models(v)[1]) for v in VARIANTS},
            "adapters": _numpy_pairs(adapter_set().stacked)}


def port_model(tree) -> ttr.DecoderLM:
    variant = "moe" if "moe" in tree["layer_1"] else "dense"
    cfg = ttr.TransformerConfig(dtype=torch.float32, **TINY, **VARIANTS[variant])
    return ttr.load_flax_params(ttr.DecoderLM(cfg, device="cpu"), tree)


def decode_all(model: ttr.DecoderLM, adapters=None) -> dict:
    """Every decode path on ``model`` (sharded or not), same inputs."""
    out = {}
    with torch.no_grad():
        cache = tgen.init_cache(model, 2, 16, dtype=torch.float32, device="cpu")
        out["cache heads"] = cache["layer_0"]["k"].shape[2]
        p = torch.from_numpy(prompt()).long()
        logits = [tgen.decode_step(model, p, cache, offset=0, attend_len=8)[0]]
        for i, tok in enumerate(prompt(2, 2, seed=1).T):
            logits.append(tgen.decode_step(model, torch.from_numpy(tok[:, None]).long(), cache, offset=6 + i,
                                           attend_len=8)[0])
        out["dense"] = torch.cat(logits, 1).numpy()
        pool = KVBlockPool.for_model(model, num_blocks=9, block_size=4, dtype=torch.float32, device="cpu")
        out["pool heads"] = pool.pools["layer_0"]["k"].shape[2]
        tables = torch.tensor([[3, 1, 7], [0, 2, 9]])
        logits = []
        for toks, fill in [(prompt(2, 5, seed=2), [0, 0]), (prompt(2, 1, seed=3), [5, 5]),
                           (prompt(2, 1, seed=4), [6, 6])]:
            lg, _ = tgen.decode_step(model, torch.from_numpy(toks).long(), pool.pools,
                                     pages=(tables, torch.tensor(fill)))
            logits.append(lg)
        out["paged"] = torch.cat(logits, 1).numpy()
    out["greedy"] = tgen.generate(model, prompt(), 8).numpy()
    out["medusa greedy"] = {n: tgen.generate(model, prompt(1, n, seed=30 + n), 6)[0].tolist() for n in (3, 7)}
    out["sampled"] = tgen.generate(model, prompt(), 8, temperature=0.9, top_k=20,
                                   generator=torch.Generator().manual_seed(7)).numpy()
    out["beam"] = tgen.beam_search(model, prompt(), 5, num_beams=3)[0].numpy()
    engine = ServeEngine(model, block_size=4, max_slots=2, prefill_chunk=4)
    rids = [engine.submit(prompt(1, n, seed=10 + n)[0], 5) for n in (3, 6, 9)]
    done = engine.run()
    out["engine"] = [done[r].tolist() for r in rids]
    # the prefix cache: a template hit, then an exact full-block duplicate
    # whose re-fed last token forks the shared block (COW) on every rank
    engine = ServeEngine(model, block_size=4, max_slots=1, prefill_chunk=4, prefix_cache=True)
    p = prompt(1, 8, seed=20)[0]
    rids = [engine.submit(p, 5), engine.submit(np.concatenate([p, prompt(1, 3, seed=21)[0]]), 5)]
    engine.run()
    rids.append(engine.submit(p, 5))
    engine.run()
    out["prefix engine"] = ([engine.output(r).tolist() for r in rids],
                            [(engine.ledger.records[r]["cached_tokens"], engine.ledger.records[r]["saved_tokens"])
                             for r in rids], engine.leaked_blocks())
    # Medusa with the default heads (warm-started from the whole LM head)
    engine = ServeEngine(model, block_size=4, max_slots=2, prefill_chunk=4, medusa_k=3)
    rids = [engine.submit(prompt(1, n, seed=30 + n)[0], 6) for n in (3, 7)]
    engine.run()
    out["medusa engine"] = ([engine.output(r).tolist() for r in rids],
                            [(engine.ledger.records[r]["drafted"], engine.ledger.records[r]["accepted"])
                             for r in rids], engine.leaked_blocks())
    if adapters is not None:
        ids = torch.tensor([1, 0, 3, 2])
        stacked = (_torch_pairs(adapters), ids)
        toks = torch.from_numpy(prompt(4, 10, seed=6)).long()
        with torch.no_grad():
            out["adapters dense"] = model(toks, adapters=stacked).numpy()
            out["no adapters"] = model(toks).numpy()
            cache = tgen.init_cache(model, 4, 16, dtype=torch.float32, device="cpu")
            model(toks, cache=cache, offset=0, attend_len=10, adapters=stacked)
            out["adapters decode"] = model(toks[:, :1], cache=cache, offset=10, adapters=stacked)[0].numpy()
    return out


_WORKER = textwrap.dedent(
    """
    import os, pickle, sys
    import torch
    sys.path.insert(0, os.environ["TEST_DIR"])
    from dmlcloud_tpu_torch.models import transformer as ttr
    from dmlcloud_tpu_torch.parallel import mesh as tmesh, runtime
    from test_torch_tp_decode import decode_all, port_model

    torch.set_num_threads(1)
    assert runtime.init_auto(device="cpu") == "gloo"
    out_dir = os.environ["OUT_DIR"]
    data = pickle.loads(open(os.path.join(out_dir, "inputs.pkl"), "rb").read())
    mesh = tmesh.create_mesh({"model": 2}, device="cpu")
    out = {}
    for variant, tree in data["trees"].items():
        model = port_model(tree)
        plan = tmesh.shard_module(model, mesh, ttr.llama_partition_rules())
        assert plan.tp is not None and model.tp_head is not None and model.tp_embed is not None
        out[variant] = decode_all(model, data["adapters"] if variant == "dense" else None)
    every = runtime.all_gather_object(out)
    if runtime.rank() == 0:
        with open(os.path.join(out_dir, "model2.pkl"), "wb") as f:
            pickle.dump(every, f)
    runtime.barrier("done", timeout=60)
    """
)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("tp_decode")
    data = inputs()
    (out_dir / "inputs.pkl").write_bytes(pickle.dumps(data))
    port = tcp.find_free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), TEST_DIR=str(Path(__file__).parent),
                   OUT_DIR=str(out_dir))
        # output to files: a full pipe would block one rank inside a collective
        with open(out_dir / f"log{rank}.txt", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env, cwd=out_dir, stdout=log,
                                          stderr=subprocess.STDOUT))
    try:
        one = {v: decode_all(port_model(tree), data["adapters"] if v == "dense" else None)
               for v, tree in data["trees"].items()}
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            p.kill()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (out_dir / f"log{rank}.txt").read_text()[-4000:]
    return {"one": one, "ranks": pickle.loads((out_dir / "model2.pkl").read_bytes())}


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_the_sharded_cache_and_pool_hold_the_ranks_kv_heads(results, variant):
    for r in results["ranks"]:
        assert r[variant]["cache heads"] == 1 and r[variant]["pool heads"] == 1
    assert results["one"][variant]["cache heads"] == 2


@pytest.mark.parametrize("mode", ["dense", "paged"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_step_logits_equal_one_process(results, variant, mode):
    one = results["one"][variant][mode]
    for r in results["ranks"]:
        assert _rel(r[variant][mode], one) <= REL
    np.testing.assert_array_equal(results["ranks"][0][variant][mode], results["ranks"][1][variant][mode])


@pytest.mark.parametrize("what", ["greedy", "sampled", "beam", "engine"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tokens_equal_one_process_on_every_rank(results, variant, what):
    one = results["one"][variant][what]
    for r in results["ranks"]:
        np.testing.assert_array_equal(np.asarray(r[variant][what]), np.asarray(one))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_greedy_beam_and_engine_tokens_equal_the_jax_package(results, variant):
    jmodel, params = jax_models(variant)
    got = results["ranks"][0][variant]
    np.testing.assert_array_equal(got["greedy"], np.asarray(jgen.generate(jmodel, params, jnp.asarray(prompt()), 8)))
    beams, _ = jgen.beam_search(jmodel, params, jnp.asarray(prompt()), 5, num_beams=3)
    np.testing.assert_array_equal(got["beam"], np.asarray(beams))
    for n, toks in zip((3, 6, 9), got["engine"]):
        want = jgen.generate(jmodel, params, jnp.asarray(prompt(1, n, seed=10 + n)), 5)
        assert toks == np.asarray(want)[0].tolist()


@pytest.mark.parametrize("mode", ["adapters dense", "adapters decode"])
def test_per_row_adapters_under_tensor_parallelism_equal_one_process(results, mode):
    one = results["one"]["dense"][mode]
    for r in results["ranks"]:
        assert _rel(r["dense"][mode], one) <= REL
    if mode == "adapters dense":  # the adapters move the rows they name, not the null adapter's row 1
        base = results["one"]["dense"]["no adapters"]
        np.testing.assert_allclose(one[1], base[1], atol=1e-6, rtol=1e-6)
        assert np.abs(one[0] - base[0]).max() > 1e-3


@pytest.mark.parametrize("what", ["prefix engine", "medusa engine"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefix_and_medusa_engines_equal_one_process(results, variant, what):
    one = results["one"][variant][what]
    for r in results["ranks"]:
        assert r[variant][what] == one
    tokens, counts, leaked = one
    assert leaked == 0
    if what == "prefix engine":
        assert counts == [(0, 0), (8, 8), (8, 7)]  # the duplicate re-feeds its last token: a fork
        assert tokens[2] == tokens[0]
    else:
        assert all(d > 0 for d, _ in counts)
        for n, toks in zip((3, 7), tokens):
            assert toks == results["one"][variant]["medusa greedy"][n]
