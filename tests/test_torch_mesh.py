"""The port's meshes and sharding policies against the JAX package's.

``parallel.mesh`` of the port computes every parameter's spec in the JAX
model's (flax) layout, so the reference's ``make_param_policy`` on the flax
tree, on a JAX CPU ``Mesh`` of the same axes (conftest forces 8 CPU devices),
must give the same spec for every parameter, for every mesh and policy here.
Around it: ``parse_mesh_axes``' messages, ``create_mesh``'s sizing and its
``-1`` errors, ``auto_mesh``'s factorisation, and the raises for placements
the torch model cannot execute.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu.parallel import mesh as jmesh
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.parallel import mesh as tmesh
from dmlcloud_tpu_torch.parallel.tensor_parallel import ModelGroup

torch.set_num_threads(2)

#: the ``toy`` preset of examples/pod_llama_fsdp.py (and the tiny model of the
#: port's tests), and a wider one whose kernels pass ``_fsdp_spec``'s min_size
CONFIGS = {
    "toy": dict(vocab_size=512, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16, hidden_dim=64, mlp_dim=160),
    "wide": dict(vocab_size=1000, num_layers=1, num_heads=8, num_kv_heads=4, head_dim=32, hidden_dim=256,
                 mlp_dim=704, tie_embeddings=True),
}
MESHES = [{"data": 8}, {"fsdp": 4}, {"data": 2, "fsdp": 2}, {"fsdp": 2, "model": 2}, {"model": 4}]


def _callable(P):
    """One callable policy, written against either package's spec class."""

    def policy(path, leaf):
        if "embed" in path:
            return P("fsdp", None)
        if path.endswith("kernel") and leaf.shape[-1] % 2 == 0:
            return P(None, "model")
        return P()

    return policy


POLICIES = {
    "replicate": ("replicate", "replicate"),
    "fsdp": ("fsdp", "fsdp"),
    "rules": (jtr.llama_partition_rules(), ttr.llama_partition_rules()),
    "callable": (_callable(JP), _callable(tmesh.P)),
}


def _models(name: str):
    kw = CONFIGS[name]
    jmodel = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **kw))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **kw), device="cpu")
    return shapes, tmodel


def _reference_specs(shapes, axes: dict, policy) -> dict[str, tuple]:
    n = int(np.prod(list(axes.values())))
    mesh = jmesh.create_mesh(axes, devices=jax.devices()[:n])
    fn = jmesh.make_param_policy(policy)
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return {jmesh.path_str(path): tuple(fn(jmesh.path_str(path), leaf, mesh)) for path, leaf in leaves}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("axes", MESHES, ids=lambda a: ",".join(f"{k}={v}" for k, v in a.items()))
def test_specs_equal_the_references_make_param_policy(config, policy, axes):
    shapes, model = _models(config)
    jpolicy, tpolicy = POLICIES[policy]
    want = _reference_specs(shapes, axes, jpolicy)
    got = tmesh.sharding_for(model, axes, tpolicy)
    assert set(got) == set(want)
    for path in want:
        assert tuple(got[path]) == want[path], f"{path}: port {got[path]}, reference {want[path]}"


def test_odd_vocab_relocates_the_fsdp_shard_like_the_reference():
    kw = dict(CONFIGS["toy"], vocab_size=1001)
    jmodel = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **kw))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **kw), device="cpu")
    want = _reference_specs(shapes, {"fsdp": 4}, jtr.llama_partition_rules())
    got = tmesh.sharding_for(model, {"fsdp": 4}, ttr.llama_partition_rules())
    assert want["embed/embedding"] == (None, "fsdp")  # 1001 rows: moved to the features
    assert tuple(got["embed/embedding"]) == want["embed/embedding"]
    assert tuple(got["lm_head/kernel"]) == want["lm_head/kernel"] == ("fsdp", None)
    # and FSDP2 shards the embedding on torch dim 1, the features
    _, fsdp_dim, _ = tmesh.placements(model, {"fsdp": 4}, ttr.llama_partition_rules())
    assert fsdp_dim["embed.weight"] == 1 and fsdp_dim["lm_head.weight"] == 1


@pytest.mark.parametrize("spec", ["data=2,fsdp=4", "fsdp=-1", " data = 2 ,model=4", "data=2,,fsdp=4", "data",
                                  "data=two", "=2", "data=2,data=4", ""])
def test_parse_mesh_axes_matches_the_reference(spec):
    try:
        want = jmesh.parse_mesh_axes(spec)
    except ValueError as exc:
        with pytest.raises(ValueError, match=re.escape(str(exc))):
            tmesh.parse_mesh_axes(spec)
    else:
        assert tmesh.parse_mesh_axes(spec) == want


@pytest.mark.parametrize("axes", [None, {"data": -1}, {"data": 2, "fsdp": -1}, {"fsdp": 4, "model": 2},
                                  {"data": -1, "fsdp": -1}, {"data": 3, "fsdp": -1}, {"data": 2, "fsdp": 2},
                                  {"data": 16}])
def test_mesh_sizing_and_its_errors_match_create_mesh(axes):
    try:
        want = dict(jmesh.create_mesh(axes).shape)
    except ValueError as exc:
        with pytest.raises(ValueError, match=re.escape(str(exc))):
            tmesh.mesh_shape(axes, 8)
    else:
        assert tmesh.mesh_shape(axes, 8) == want


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_auto_mesh_factorisation_matches_the_reference(n):
    assert tmesh.auto_mesh_axes(n) == dict(jmesh.auto_mesh(n).shape)
    assert tmesh.auto_mesh_axes(n, ("data", "fsdp")) == dict(jmesh.auto_mesh(n, ("data", "fsdp")).shape)


def test_data_axes_and_size_follow_the_reference():
    for axes in MESHES + [{"model": 2, "fsdp": 2, "data": 2}]:
        n = int(np.prod(list(axes.values())))
        ref = jmesh.create_mesh(axes, devices=jax.devices()[:n])
        assert tmesh.data_axes(axes) == jmesh.data_axes(ref)
        assert tmesh.data_parallel_size(axes) == jmesh.data_parallel_size(ref)


def test_a_head_split_the_torch_model_cannot_run_raises_naming_the_parameter():
    # 4 query heads over model=8: the reference relocates the split onto the
    # hidden dim (q kernel [64, 4, 16] -> P('model')); the port refuses it
    model = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **CONFIGS["toy"]), device="cpu")
    specs, _, model_dim = tmesh.placements(model, {"model": 8}, ttr.llama_partition_rules())
    assert tuple(specs["layers.0.attn.q_proj.weight"]) == ("model", None, None)
    with pytest.raises(ValueError, match=r"layers\.0\.attn\.q_proj\.weight"):
        model.apply_tensor_parallel(ModelGroup(None, 0, 8), model_dim)
    assert all(layer.attn.tp is None and layer.mlp.tp is None for layer in model.layers)
    # a head_dim split has no torch dim at all
    with pytest.raises(ValueError, match=r"q_proj\.weight .*head_dim"):
        tmesh.placements(model, {"model": 2}, [("q_proj", tmesh.P(None, None, "model"))])
    # KV heads that do not divide: 2 KV heads over model=4 (the 4 query heads do);
    # the reference moves the k/v splits onto the hidden dim
    specs, _, model_dim = tmesh.placements(model, {"model": 4}, ttr.llama_partition_rules())
    assert tuple(specs["layers.0.attn.k_proj.weight"]) == ("model", None, None)
    assert model_dim["layers.0.attn.q_proj.weight"] == 0
    with pytest.raises(ValueError, match=r"layers\.0\.attn\.k_proj\.weight"):
        model.apply_tensor_parallel(ModelGroup(None, 0, 4), model_dim)
    # the whole attention or none of it
    specs, _, model_dim = tmesh.placements(model, {"model": 2}, [("attn/q_proj", tmesh.P(None, "model"))])
    with pytest.raises(ValueError, match=r"layers\.0\.attn\.k_proj\.weight"):
        model.apply_tensor_parallel(ModelGroup(None, 0, 2), model_dim)
    # norms stay replicated
    with pytest.raises(ValueError, match=r"final_norm\.weight"):
        model.apply_tensor_parallel(ModelGroup(None, 0, 2), {"final_norm.weight": 0})


def test_a_parameter_split_over_data_is_refused():
    model = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **CONFIGS["toy"]), device="cpu")
    with pytest.raises(ValueError, match=r"embed\.weight .*'data'"):
        tmesh.placements(model, {"data": 2}, lambda path, leaf: tmesh.P("data") if "embed" in path else None)
