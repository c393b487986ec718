"""The port's LoRA adapters against the JAX package, on the CPU.

The counterpart of ``tests/test_lora.py`` on the tiny ``DecoderLM`` (2
layers, hidden 64, 4/2 heads of 16, MLP 160, vocab 256) whose weights the
bridge carries from the JAX package; adapter trees cross as they are (nested
dicts by flax path, ``LoraPair`` leaves of numpy arrays or tensors):

- a zero-init merge is the identity;
- ``lora_merge`` on the reference's factors, including the 3-D q/k/v kernels
  and both ``in_axes`` splits, within 5e-5 of the reference's ``lora_merge``;
- the default and regex matchers select the reference's paths, with its
  factor shapes and ``lora_size``;
- gradients reach only the adapters (``LoraModel``: the base is buffers);
- ``lora_partition_rules`` replicate the factors and keep the base rules;
- a stage finetunes the adapters only: the loss falls below 0.7x, the base is
  bitwise unchanged, the optimizer state is adapter-sized;
- ``DecoderLM(adapters=(stacked, ids))`` in the dense and decode modes within
  5e-5 of the reference's ``apply(..., adapters=)`` on the same stacked
  factors (the reference's ``AdapterSet``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmlcloud_tpu_torch as tdml
from dmlcloud_tpu.models import generate as jgen
from dmlcloud_tpu.models import lora as jlora
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu.serve.adapters import AdapterSet
from dmlcloud_tpu_torch import optim as toptim
from dmlcloud_tpu_torch.models import generate as tgen
from dmlcloud_tpu_torch.models import lora as tlora
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

TINY = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16, hidden_dim=64, mlp_dim=160,
            max_seq_len=32)
FP32 = dict(atol=5e-5, rtol=5e-5)


@functools.lru_cache(maxsize=None)
def _models():
    jmodel = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **TINY))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return jmodel, params


def _port_model():
    return ttr.load_flax_params(ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **TINY), device="cpu"),
                                _models()[1])


def _to_port(tree):
    """A reference adapter tree with its factors as tensors."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, jlora.LoraPair):
        return tlora.LoraPair(a=torch.from_numpy(np.array(tree.a, np.float32)),
                              b=torch.from_numpy(np.array(tree.b, np.float32)))
    return tree


def _pairs(tree, prefix=""):
    """{path: pair} of the non-None leaves of an adapter tree (either package's)."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _pairs(sub, f"{prefix}/{k}" if prefix else k).items()}
    return {} if tree is None else {prefix: tree}


def _poked(in_axes, seed=1):
    """The reference's factors with ``b`` drawn nonzero, so every delta counts."""
    rng = np.random.RandomState(seed)
    tree = jlora.lora_init(jax.random.PRNGKey(0), _models()[1], rank=2, in_axes=in_axes)
    return jax.tree_util.tree_map(
        lambda p: p if p is None else jlora.LoraPair(a=np.asarray(p.a), b=rng.randn(*p.b.shape).astype(np.float32)),
        tree, is_leaf=lambda x: x is None or isinstance(x, jlora.LoraPair))


def test_zero_init_merge_is_identity():
    model = _port_model()
    adapters = tlora.lora_init(torch.Generator().manual_seed(0), model, rank=2)
    merged = tlora.lora_merge(model, adapters)
    params = dict(model.named_parameters())
    assert sorted(merged) == sorted(params)
    for name, p in params.items():
        assert torch.equal(merged[name], p), name


@pytest.mark.parametrize("in_axes", [None, 1])
def test_merge_math_matches_the_reference_on_its_factors(in_axes):
    _, params = _models()
    adapters = _poked(in_axes)
    want = jlora.lora_merge(params, adapters, alpha=16.0)
    model = _port_model()
    merged = tlora.lora_merge(model, _to_port(adapters), alpha=16.0)
    out = ttr.DecoderLM(model.cfg, device="cpu")
    out.load_state_dict(merged)  # the merge exports a plain model
    got = ttr.to_flax_params(out)
    flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    for path, w in flat.items():
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(w), **FP32, err_msg=jax.tree_util.keystr(path))
    q = "layer_0/attn/q_proj/kernel"  # [D, H, hd] in flax: its delta moved, in the port's row order
    assert not np.allclose(got["layer_0"]["attn"]["q_proj"]["kernel"], params["layer_0"]["attn"]["q_proj"]["kernel"])
    assert _pairs(_to_port(adapters))[q].a.shape[0] == (64 if in_axes == 1 else 64 * 4)


@pytest.mark.parametrize("match", [None, r"attn/.*kernel", r"mlp/(gate|up)_proj"])
def test_matchers_select_the_references_paths(match):
    _, params = _models()
    want = _pairs(jlora.lora_init(jax.random.PRNGKey(0), params, rank=3, match=match))
    got = _pairs(tlora.lora_init(torch.Generator().manual_seed(0), _port_model(), rank=3, match=match))
    assert sorted(got) == sorted(want) and got
    for path, pair in want.items():
        assert tuple(got[path].a.shape) == pair.a.shape and tuple(got[path].b.shape) == pair.b.shape, path
        assert not got[path].b.any()  # b starts at zero
    assert tlora.lora_size(got) == jlora.lora_size(want)


def test_gradients_reach_only_the_adapters():
    model = tlora.LoraModel(_port_model(), tlora.lora_init(torch.Generator().manual_seed(1), _port_model(), rank=2))
    assert not list(model.base.parameters())  # the base is buffers: frozen
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 8))).long()
    ttr.lm_loss(model(tokens), tokens).backward()
    pairs = _pairs(model.adapters())
    assert len(pairs) == 2 * 7 + 1 and all(p.a.requires_grad for p in pairs.values())
    # b is zero but its gradient is not; a's is zero at b = 0 (dL/da = dL/dW @ b^T)
    assert float(sum(p.b.grad.abs().sum() for p in pairs.values())) > 0
    assert all(float(p.a.grad.abs().max()) == 0.0 for p in pairs.values())
    assert all(b.grad is None for b in model.base.buffers())


def test_lora_partition_rules_replicate_adapters_only():
    rules = tlora.lora_partition_rules([("attn/.*kernel", tmesh.P(None, "model"))])
    policy = tmesh.make_param_policy(rules)
    mesh = {"data": 4, "model": 2}
    assert policy("attn/q_proj/kernel", torch.empty(8, 16, device="meta"), mesh) == tmesh.P(None, "model")
    for factor in ("a", "b"):
        assert policy(f"attn/q_proj/kernel/{factor}", torch.empty(8, 2, device="meta"), mesh) == tmesh.P()
    assert rules[1:] == [("attn/.*kernel", tmesh.P(None, "model"))]


class _MLP(torch.nn.Module):
    """The reference test's flax MLP (Dense(8) -> relu -> Dense(1))."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.Dense_0 = torch.nn.Linear(4, 8)
        self.Dense_1 = torch.nn.Linear(8, 1)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)

    def flax_layout(self):
        return [((n, "kernel"), f"{n}.weight", "t") for n in ("Dense_0", "Dense_1")] + [
            ((n, "bias"), f"{n}.bias", "same") for n in ("Dense_0", "Dense_1")]

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


class _LoraStage(tdml.TrainValStage):
    """Tiny regression head finetuned through its adapters only."""

    def pre_stage(self):
        base = _MLP()
        self.pipeline.register_model("mlp", tlora.LoraModel(base, tlora.lora_init(torch.Generator().manual_seed(1),
                                                                                    base, rank=2)), verbose=False)
        self.pipeline.register_optimizer("adamw", toptim.adamw(3e-2))
        rng = np.random.RandomState(0)
        xs = rng.randn(6, 32, 4).astype(np.float32)
        w = np.array([[0.5], [-1.0], [2.0], [0.3]], np.float32)
        self.pipeline.register_dataset("train", [{"x": x, "y": x @ w} for x in xs], verbose=False)

    def step(self, state, batch):
        return torch.mean((state.model(batch["x"]) - batch["y"]) ** 2)

    def val_epoch(self):
        pass


def test_stage_finetunes_adapters_only():
    pipeline = tdml.TrainingPipeline(name="lora-test", device="cpu")
    stage = _LoraStage()
    pipeline.append_stage(stage, max_epochs=4)
    pipeline.run()
    hist = [float(x) for x in stage.tracker["train/loss"]]
    assert hist[-1] < hist[0] * 0.7, hist
    model = stage.state.model
    fresh = _MLP()
    for name, p in fresh.named_parameters():
        assert torch.equal(model.base.get_buffer(name), p.detach()), name  # the frozen base never moved
    # ... the adapters did, and they are all the optimizer holds
    assert float(model.adapters()["Dense_0"]["kernel"].b.detach().abs().sum()) > 0
    sd = stage.state.state_dict()
    assert sorted(sd["params"]) == sorted(n for n, _ in model.named_parameters())
    assert all(n.startswith("factors.") for n in sd["params"])
    assert sorted(sd["extras"]) == sorted(f"base.{n}" for n, _ in fresh.named_parameters())  # the base rides extras
    n_opt = sum(v.numel() for slot in sd["opt_state"].values() if isinstance(slot, dict) for v in slot.values())
    size = tlora.lora_size(model.adapters())
    assert size == 4 * 2 + 2 * 8 + 8 * 2 + 2 * 1 and n_opt < 3 * size + 8
    # the merge exports a plain model
    plain = _MLP()
    plain.load_state_dict(tlora.lora_merge(model.base, model.adapters()))
    x = torch.randn(5, 4)
    torch.testing.assert_close(plain(x), model(x))


def _stacked(n_tenants=3, rank=4):
    """The reference's ``AdapterSet`` over ``n_tenants`` random tenants."""
    _, params = _models()
    rng = np.random.RandomState(5)
    tenants = {}
    for i in range(n_tenants):
        tree = jlora.lora_init(jax.random.PRNGKey(i), params, rank=rank, in_axes=1)
        tenants[f"t{i}"] = jax.tree_util.tree_map(
            lambda p: p if p is None else jlora.LoraPair(a=p.a, b=jnp.asarray(rng.randn(*p.b.shape) * 0.1, jnp.float32)),
            tree, is_leaf=lambda x: x is None or isinstance(x, jlora.LoraPair))
    return AdapterSet(tenants, alpha=8.0, base=params)


@pytest.mark.parametrize("mode", ["dense", "decode"])
def test_per_row_adapters_match_the_reference(mode):
    jmodel, params = _models()
    aset = _stacked()
    ids = np.array([1, 0, 3, 2], np.int32)  # 0 is the null adapter
    tokens = np.random.RandomState(2).randint(0, 256, (4, 10)).astype(np.int32)
    model = _port_model()
    stacked = (_to_port(jax.tree_util.tree_map(np.asarray, aset.stacked)), torch.from_numpy(ids).long())
    if mode == "dense":
        want = jmodel.apply({"params": params}, jnp.asarray(tokens), adapters=(aset.stacked, jnp.asarray(ids)))
        got = model(torch.from_numpy(tokens).long(), adapters=stacked)
    else:
        # a prefill, then one decode step, both with the adapters
        jcache = jgen.init_cache(jmodel.cfg, 4, 16, dtype=jnp.float32)
        _, jcache = jmodel.apply({"params": params}, jnp.asarray(tokens), cache=jcache, offset=0, attend_len=10,
                                 adapters=(aset.stacked, jnp.asarray(ids)))
        want, _ = jmodel.apply({"params": params}, jnp.asarray(tokens[:, :1]), cache=jcache, offset=10,
                               adapters=(aset.stacked, jnp.asarray(ids)))
        cache = tgen.init_cache(model.cfg, 4, 16, torch.float32, "cpu")
        _, cache = model(torch.from_numpy(tokens).long(), cache=cache, offset=0, attend_len=10, adapters=stacked)
        got, _ = model(torch.from_numpy(tokens[:, :1]).long(), cache=cache, offset=10, adapters=stacked)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FP32)
    # the null adapter's row is the base model's
    base = model(torch.from_numpy(tokens).long())
    if mode == "dense":
        torch.testing.assert_close(got[1], base[1], atol=1e-6, rtol=1e-6)
        assert not torch.allclose(got[0], base[0], atol=1e-3)
