"""The port's Mixture-of-Experts against the JAX package's, on the CPU.

- ``MoEMLP`` (fp32, B 2, T 16, D 8, E 4, M 16) on the JAX layer's params:
  output, the aux loss (against ``total_aux_loss`` of the sown ``losses``)
  and the gradients of all four parameter groups (``jax.grad`` of
  ``sum(y^2) + aux``) within ``TOL`` fp32, with ample capacity, binding
  capacity (``capacity_factor`` 0.01 and 0.5: the same (token, choice) pairs
  dropped as the reference's formula on the JAX router's logits) and
  ``top_k=1``; the index dispatch against the one-hot plain version;
- a 2-layer MoE ``DecoderLM`` (layer_1 MoE) through ``load_flax_params``:
  logits and every gradient of ``lm_loss + total_aux_loss``, the flax tree
  round-tripping byte-identical, the partition rules' specs;
- MoE ``generate`` greedy tokens against the reference's ``generate``;
- ``act_sharding`` changes no bit of the logits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlcloud_tpu.models import generate as jgen
from dmlcloud_tpu.models import moe as jmoe
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu.parallel import mesh as jmesh
from dmlcloud_tpu_torch.models import generate as tgen
from dmlcloud_tpu_torch.models import moe as tmoe
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

B, T, D, E, M = 2, 16, 8, 4, 16
TOL = dict(atol=5e-5, rtol=5e-5)  # tests/test_kernel_numerics.py:28, fp32
LM = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8, hidden_dim=16, mlp_dim=32, max_seq_len=32,
          num_experts=4, moe_every=2)


def _x(seed=0):
    return np.random.RandomState(seed).randn(B, T, D).astype(np.float32)


def _layers(**kw):
    jcfg = jmoe.MoEConfig(num_experts=E, hidden_dim=D, mlp_dim=M, dtype=jnp.float32, **kw)
    jlayer = jmoe.MoEMLP(jcfg)
    params = jlayer.init(jax.random.PRNGKey(1), jnp.asarray(_x()))["params"]
    tlayer = tmoe.MoEMLP(tmoe.MoEConfig(num_experts=E, hidden_dim=D, mlp_dim=M, dtype=torch.float32, **kw))
    with torch.no_grad():
        tlayer.router.weight.copy_(torch.tensor(np.asarray(params["router"]["kernel"]).T))
        for n in ("gate", "up", "down"):
            getattr(tlayer, f"{n}_proj").copy_(torch.tensor(np.asarray(params[f"moe/{n}_proj"])))
    return jlayer, params, tlayer


def _jax_run(jlayer, params, x):
    def loss(p):
        y, state = jlayer.apply({"params": p}, jnp.asarray(x), mutable=["losses"])
        aux = jmoe.total_aux_loss(state)
        return jnp.sum(y**2) + aux, (y, aux)

    (_, (y, aux)), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(y), float(aux), grads


def _torch_run(tlayer, x, onehot=False):
    tlayer.zero_grad()
    xt = torch.tensor(x)
    y = (tlayer.forward_onehot if onehot else tlayer)(xt)
    aux = tmoe.total_aux_loss(tlayer)
    ((y**2).sum() + aux).backward()
    grads = {"router": tlayer.router.weight.grad.numpy().T}
    for n in ("gate", "up", "down"):
        grads[n] = getattr(tlayer, f"{n}_proj").grad.numpy()
    return y.detach().numpy(), float(aux), grads


def _reference_keep(jlayer, params, x, cfg):
    """The reference's (token, choice) capacity mask, from the JAX router's
    logits and moe.py:76-103's formula in numpy."""
    _, inter = jlayer.apply({"params": params}, jnp.asarray(x), capture_intermediates=True)
    logits = np.asarray(inter["intermediates"]["router"]["__call__"][0])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    k = min(cfg["top_k"], E)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    n = probs.shape[0]
    flat = np.eye(E, dtype=np.int64)[idx].reshape(n * k, E)
    pos = ((np.cumsum(flat, 0) - 1) * flat).sum(-1).reshape(n, k)
    cap = min(jmoe._round_up(max(int(n / E * cfg["capacity_factor"]), 1), 8), n)
    return pos < cap, idx


CASES = {"ample": dict(capacity_factor=4.0, top_k=2), "default": dict(capacity_factor=1.25, top_k=2),
         "binding_0.5": dict(capacity_factor=0.5, top_k=2), "binding_0.01": dict(capacity_factor=0.01, top_k=2),
         "top1": dict(capacity_factor=1.25, top_k=1)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_layer_matches_jax(case):
    kw = CASES[case]
    jlayer, params, tlayer = _layers(**kw)
    x = _x(3)
    y_j, aux_j, g_j = _jax_run(jlayer, params, x)
    y_t, aux_t, g_t = _torch_run(tlayer, x)
    np.testing.assert_allclose(y_t, y_j, **TOL)
    np.testing.assert_allclose(aux_t, aux_j, **TOL)
    assert aux_t > 0
    np.testing.assert_allclose(g_t["router"], np.asarray(g_j["router"]["kernel"]), **TOL)
    for n in ("gate", "up", "down"):
        np.testing.assert_allclose(g_t[n], np.asarray(g_j[f"moe/{n}_proj"]), **TOL)
    # the same (token, choice) pairs dropped as the reference's formula
    keep_ref, idx_ref = _reference_keep(jlayer, params, x, kw)
    r = tlayer.route(torch.tensor(x).reshape(-1, D))
    np.testing.assert_array_equal(r.experts.numpy(), idx_ref)
    np.testing.assert_array_equal(r.keep.numpy(), keep_ref)
    if case.startswith("binding"):
        assert not keep_ref.all()
    if case == "ample":
        assert keep_ref.all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_index_dispatch_equals_the_onehot_plain_version(case):
    _, _, tlayer = _layers(**CASES[case])
    x = _x(5)
    y_i, aux_i, g_i = _torch_run(tlayer, x)
    y_o, aux_o, g_o = _torch_run(tlayer, x, onehot=True)
    np.testing.assert_allclose(y_i, y_o, atol=1e-6, rtol=1e-6)
    assert aux_i == aux_o
    for n in g_i:
        np.testing.assert_allclose(g_i[n], g_o[n], atol=1e-6, rtol=1e-6)


def test_capacity_is_the_references_formula():
    for n in (1, 7, 8, 32, 100, 8192, 16384):
        for e in (1, 4, 8):
            for cf in (0.01, 0.5, 1.25, 2.0):
                cfg = tmoe.MoEConfig(num_experts=e, capacity_factor=cf)
                assert tmoe.capacity(n, cfg) == min(jmoe._round_up(max(int(n / e * cf), 1), 8), n)
    # decode: B rows of one token, at most 8 rows, keep every choice
    assert tmoe.capacity(8, tmoe.MoEConfig()) == 8
    assert tmoe.capacity(3, tmoe.MoEConfig()) == 3


def test_total_aux_loss_of_a_model_without_moe_is_zero():
    model = ttr.DecoderLM(ttr.TransformerConfig(**dict(LM, num_experts=0), dtype=torch.float32), device="cpu")
    assert float(tmoe.total_aux_loss(model)) == 0.0


# ---------------------------------------------------------------------------
# the MoE DecoderLM
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lm(capacity_factor=1.25):
    kw = dict(LM, moe_capacity_factor=capacity_factor)
    jmodel = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **kw))
    tokens = jnp.asarray(_tokens())
    params = jmodel.init(jax.random.PRNGKey(1), tokens)["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    tmodel = ttr.load_flax_params(ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **kw), device="cpu"),
                                  tree)
    return jmodel, params, tmodel


def _tokens(b=2, t=16, seed=0):
    return np.random.RandomState(seed).randint(0, LM["vocab_size"], (b, t)).astype(np.int32)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_decoder_lm_logits_and_grads_match_jax(capacity_factor):
    jmodel, params, tmodel = _lm(capacity_factor)
    assert "moe" in params["layer_1"] and "mlp" in params["layer_0"]
    assert hasattr(tmodel.layers[1], "moe") and hasattr(tmodel.layers[0], "mlp")
    tokens = _tokens()

    def loss(p):
        logits, state = jmodel.apply({"params": p}, jnp.asarray(tokens), mutable=["losses"])
        aux = jmoe.total_aux_loss(state)
        return jtr.lm_loss(logits, jnp.asarray(tokens)) + aux, (logits, aux)

    (l_j, (logits_j, aux_j)), g_j = jax.value_and_grad(loss, has_aux=True)(params)
    tmodel.zero_grad()
    tt = torch.tensor(tokens).long()
    logits_t = tmodel(tt)
    aux_t = tmoe.total_aux_loss(tmodel)
    l_t = ttr.lm_loss(logits_t, tt) + aux_t
    l_t.backward()
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)
    np.testing.assert_allclose(float(l_t), float(l_j), **TOL)
    grads = ttr.to_flax_params(tmodel, {n: p.grad for n, p in tmodel.named_parameters()})
    flat_j = {jmesh.path_str(p): np.asarray(g) for p, g in jax.tree_util.tree_leaves_with_path(g_j)}
    flat_t = {jmesh.path_str(p): g for p, g in jax.tree_util.tree_leaves_with_path(grads)}
    assert sorted(flat_t) == sorted(flat_j)
    assert "layer_1/moe/moe/gate_proj" in flat_t and "layer_1/moe/router/kernel" in flat_t
    for path, g in flat_j.items():
        np.testing.assert_allclose(flat_t[path], g, err_msg=path, **TOL)


def test_moe_flax_tree_round_trips_byte_identical():
    _, params, tmodel = _lm()
    tree = jax.tree_util.tree_map(np.asarray, params)
    back = ttr.to_flax_params(tmodel)
    assert back["layer_1"]["moe"]["moe/gate_proj"].shape == (4, 16, 32)
    assert back["layer_1"]["moe"]["moe/down_proj"].shape == (4, 32, 16)
    assert back["layer_1"]["moe"]["router"]["kernel"].shape == (16, 4)
    flat = dict(jax.tree_util.tree_leaves_with_path(tree))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat.keys() == flat_back.keys()
    for key, value in flat.items():
        assert flat_back[key].tobytes() == value.tobytes(), key


@pytest.mark.parametrize("axes", [{"expert": 2}, {"fsdp": 2, "expert": 2}, {"data": 2, "fsdp": 2, "model": 2},
                                  {"expert": 4, "fsdp": 2}])
def test_partition_rules_give_the_references_specs(axes):
    jmodel, params, tmodel = _lm()
    jrules, trules = jtr.llama_partition_rules(), ttr.llama_partition_rules()
    assert [p for p, _ in trules] == [p for p, _ in jrules]
    assert [tuple(s) for _, s in trules] == [tuple(s) for _, s in jrules]
    policy = jmesh.make_param_policy(jrules)
    jm = jmesh.create_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
    want = {jmesh.path_str(p): tuple(policy(jmesh.path_str(p), leaf, jm))
            for p, leaf in jax.tree_util.tree_leaves_with_path(params)}
    got = {k: tuple(v) for k, v in tmesh.sharding_for(tmodel, axes, trules).items()}
    assert got == want
    assert got["layer_1/moe/moe/gate_proj"][0] == ("expert" if "expert" in axes else None)


def test_moe_generate_is_token_identical_to_the_reference():
    jmodel, params, tmodel = _lm()
    prompt = _tokens(2, 7, seed=4)
    want = np.asarray(jgen.generate(jmodel, params, jnp.asarray(prompt), 8))
    got = tgen.generate(tmodel, prompt, 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_moe_decode_step_logits_match_the_no_cache_forward():
    _, _, tmodel = _lm(4.0)
    tokens = torch.tensor(_tokens(2, 12, seed=6)).long()
    with torch.no_grad():
        full = tmodel(tokens)
        cache = tgen.init_cache(tmodel.cfg, 2, 16, dtype=torch.float32, device="cpu")
        logits, cache = tgen.decode_step(tmodel, tokens[:, :8], cache, offset=0)
        steps = [logits]
        for i in range(8, 12):
            logits, cache = tgen.decode_step(tmodel, tokens[:, i:i + 1], cache, offset=i)
            steps.append(logits)
    # the prefill routes 16 tokens, each step 2, the no-cache forward 24: at
    # capacity factor 4 none drops, so the routing is per token and the
    # logits agree
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), atol=1e-5, rtol=1e-5)


def _port(capacity_factor=1.25, **kw):
    _, params, _ = _lm(capacity_factor)
    cfg = ttr.TransformerConfig(dtype=torch.float32, **dict(LM, moe_capacity_factor=capacity_factor), **kw)
    return ttr.load_flax_params(ttr.DecoderLM(cfg, device="cpu"), jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("remat", [False, True])
def test_act_sharding_changes_no_bit_of_the_logits(remat):
    tokens = torch.tensor(_tokens()).long()
    with torch.no_grad():
        base = _port(remat=remat)(tokens)
        for hint in ("data", ("data", "fsdp"), object()):
            assert torch.equal(_port(remat=remat, act_sharding=hint)(tokens), base)


def test_moe_remat_gradients_equal_the_plain_ones():
    tokens = torch.tensor(_tokens()).long()
    grads = []
    for remat in (False, True):
        model = _port(0.5, remat=remat)
        (ttr.lm_loss(model(tokens), tokens) + tmoe.total_aux_loss(model)).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n
