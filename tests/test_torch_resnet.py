"""The port's ResNet family and ``sgd`` against the JAX package, on the CPU.

Weights cross the bridge (``models.resnet.load_flax_params``/``to_flax_params``:
conv kernels HWIO <-> OIHW, dense ``[in, out]`` <-> ``[out, in]``, BatchNorm
``scale``/``bias`` and ``batch_stats``). Inputs are NHWC images made with
numpy from a seed; everything is fp32 at 32x32.

- ResNet-18 and ResNet-50, ``train=True`` and ``False``: logits within
  ``LOGIT_ATOL``, the running statistics after one train forward within
  ``STATS_TOL`` and the gradients of every parameter within ``REL_TOL`` in
  norm (over the whole tree). The zero-initialised scales of each block's
  last BatchNorm get small random values first, so that the gradients reach
  every convolution. The train-mode reference is the JAX model in float64
  (``jax.enable_x64``): with such weights XLA:CPU's own fp32 gradients are
  1e-3 to 1e-2 from its float64 ones (the batch statistics' gradients cancel),
  the port's ~5e-6. At the reference's own initialisation both fp32 sides
  agree within ``REL_TOL``, which the last case holds too.
- flax's ``padding="SAME"`` at odd and even sizes, kernels 1 and 3, strides 1
  and 2 (the stride-2 3x3 convolution of an even input pads (0, 1)).
- The ResNet-50 parameter count equals the JAX model's.
- ``optim.sgd`` against ``optax.sgd`` over 5 steps, with and without
  (Nesterov) momentum and with a schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from dmlcloud_tpu.models import resnet as jr
from dmlcloud_tpu_torch.models import resnet as tr
from dmlcloud_tpu_torch.optim import sgd

torch.set_num_threads(2)

#: tests/test_kernel_numerics.py's fp32 norm-relative bound, and the logits' absolute bound
REL_TOL = 1e-4
LOGIT_ATOL = 1e-4
#: running statistics (values of order 1) after one train forward, elementwise,
#: absolute and relative: ~8 fp32 ulps at 1.0 (ResNet-50's fp32 forward is
#: ~1e-6 from the float64 one by its 15th block)
STATS_TOL = 1e-6
SIZE, BATCH, CLASSES = 32, 8, 10


def _variables(name: str, seed: int, perturb: bool = True) -> dict:
    """The port model's initial variables in the flax layout (the JAX init
    costs tens of seconds eagerly), the zero scales made small and random."""
    model = getattr(tr, name)(num_classes=CLASSES, dtype=torch.float32, device="cpu",
                              generator=torch.Generator().manual_seed(seed))
    variables = tr.to_flax_params(model)
    rng = np.random.RandomState(seed)

    def fill(path, a):
        if perturb and jax.tree_util.keystr(path).endswith("['scale']") and not a.any():
            return (0.1 + 0.2 * rng.rand(*a.shape)).astype(np.float32)
        return a

    variables["params"] = jax.tree_util.tree_map_with_path(fill, variables["params"])
    # running statistics away from the init, so that eval mode reads them
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + 0.2 * rng.rand(*a.shape)).astype(np.float32), variables["batch_stats"])
    return variables


def _jax_run(name: str, variables: dict, x: np.ndarray, y: np.ndarray, train: bool, dtype):
    """logits, gradients and (train) new batch_stats of the JAX model in ``dtype``."""
    model = getattr(jr, name)(num_classes=CLASSES, dtype=dtype)
    cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)
    stats = cast(variables["batch_stats"])

    @jax.jit
    def run(params, x):
        def loss(p):
            out = model.apply({"params": p, "batch_stats": stats}, x, train=train,
                              mutable=["batch_stats"] if train else False)
            logits, new = out if train else (out, {"batch_stats": stats})
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), (logits, new["batch_stats"])

        return jax.value_and_grad(loss, has_aux=True)(params)

    (_, (logits, new_stats)), grads = run(cast(variables["params"]), jnp.asarray(x, dtype))
    to_np = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)
    return np.asarray(logits, np.float64), to_np(grads), to_np(new_stats)


def _tree_rel(got: dict, want: dict) -> float:
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    return float(np.sqrt(sum(np.sum((a - b) ** 2) for a, b in zip(g, w)) / sum(np.sum(b**2) for b in w)))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", ["ResNet18", "ResNet50"])
def test_logits_statistics_and_gradients_match_jax(name, train):
    variables = _variables(name, seed=1)
    rng = np.random.RandomState(2)
    x = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, BATCH)
    if train:
        with jax.enable_x64(True):
            want_logits, want_grads, want_stats = _jax_run(name, variables, x, y, True, jnp.float64)
    else:
        want_logits, want_grads, want_stats = _jax_run(name, variables, x, y, False, jnp.float32)

    model = tr.load_flax_params(getattr(tr, name)(num_classes=CLASSES, dtype=torch.float32, device="cpu"), variables)
    model.train(train)
    logits = model(torch.from_numpy(x))
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(y)).backward()
    got = tr.to_flax_params(model)
    grads = tr.to_flax_params(model, tensors={n: p.grad for n, p in model.named_parameters()})["params"]

    np.testing.assert_allclose(logits.detach().numpy(), want_logits, atol=LOGIT_ATOL, rtol=0)
    assert _tree_rel(grads, want_grads) <= REL_TOL
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got["batch_stats"])[0],
                            jax.tree_util.tree_leaves(want_stats)):
        np.testing.assert_allclose(a, b, atol=STATS_TOL, rtol=STATS_TOL, err_msg=jax.tree_util.keystr(path))
    if train:
        moved = max(float(np.abs(a - b).max()) for a, b in zip(jax.tree_util.tree_leaves(got["batch_stats"]),
                                                                 jax.tree_util.tree_leaves(variables["batch_stats"])))
        assert moved > 1e-2, "the train forward did not move the running statistics"
        # every parameter gets a gradient: the comparison covers the blocks' insides
        assert min(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(grads)) > 0


def test_fp32_sides_agree_at_the_references_initialisation():
    """The zero scales as the reference initialises them: JAX's fp32 gradients
    are then well conditioned, and the port's match them in fp32."""
    variables = _variables("ResNet18", seed=3, perturb=False)
    rng = np.random.RandomState(4)
    x = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, BATCH)
    want_logits, want_grads, want_stats = _jax_run("ResNet18", variables, x, y, True, jnp.float32)
    model = tr.load_flax_params(tr.ResNet18(num_classes=CLASSES, dtype=torch.float32, device="cpu"), variables)
    logits = model(torch.from_numpy(x))
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(y)).backward()
    grads = tr.to_flax_params(model, tensors={n: p.grad for n, p in model.named_parameters()})["params"]
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, atol=LOGIT_ATOL, rtol=0)
    assert _tree_rel(grads, want_grads) <= REL_TOL
    assert _tree_rel(tr.to_flax_params(model)["batch_stats"], want_stats) <= REL_TOL


@pytest.mark.parametrize("n", [7, 8, 9, 16])
@pytest.mark.parametrize("k,s", [(3, 2), (3, 1), (1, 2)])
def test_same_padding_matches_flax(n, k, s):
    rng = np.random.RandomState(n * 10 + k + s)
    x = rng.randn(2, n, n, 4).astype(np.float32)
    conv = nn.Conv(5, (k, k), (s, s), use_bias=False)
    params = conv.init(jax.random.PRNGKey(0), x)
    want = np.asarray(conv.apply(params, x))
    layer = torch.nn.Conv2d(4, 5, k, bias=False)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.asarray(params["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
    got = tr._conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), layer, s).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    lo, hi = tr.same_padding(n, k, s)
    if (k, s) == (3, 2):
        assert (lo, hi) == ((0, 1) if n % 2 == 0 else (1, 1))


def test_resnet50_parameter_count_equals_jax():
    shapes = jax.eval_shape(lambda: jr.ResNet50(num_classes=1000, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    model = tr.ResNet50(num_classes=1000, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == want == 25_557_032
    # the running statistics are buffers, not parameters, and persistent
    stats = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["batch_stats"]))
    assert sum(b.numel() for b in model.buffers()) == stats


def test_bridge_round_trips_and_rejects_wrong_shapes():
    variables = _variables("ResNet18", seed=5)
    back = tr.to_flax_params(tr.load_flax_params(tr.ResNet18(num_classes=CLASSES, device="cpu"), variables))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0], jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    variables["params"]["Dense_0"]["kernel"] = variables["params"]["Dense_0"]["kernel"][:-1]
    with pytest.raises(ValueError, match="Dense_0"):
        tr.load_flax_params(tr.ResNet18(num_classes=CLASSES, device="cpu"), variables)


@pytest.mark.parametrize("how,torch_shape,flax_shape", [
    ("same", (3, 4), (3, 4)), ("t", (3, 4), (4, 3)), ("conv", (8, 3, 5, 7), (5, 7, 3, 8)),
    (("heads", 4), (12, 6), (6, 3, 4)), (("heads_bias", 4), (12,), (3, 4)), (("heads_out", 4), (6, 12), (3, 4, 6)),
    ("scalar", (1,), ()),
])
def test_layout_transforms_are_one_definition(how, torch_shape, flax_shape):
    """Each transform's flax shape and dim map (what the mesh code reads)
    agree with the arrays ``flax_to_torch``/``torch_to_flax`` move, and the two
    are inverse."""
    from dmlcloud_tpu_torch.models.bridge import flax_to_torch, flax_view, torch_to_flax

    _, shape, dims = flax_view(torch_shape, how)
    assert shape == flax_shape
    arr = np.random.default_rng(0).standard_normal(torch_shape).astype(np.float32)
    flax = torch_to_flax(arr, how)
    assert flax.shape == flax_shape
    np.testing.assert_array_equal(flax_to_torch(flax, how, torch_shape), arr)
    for i, d in enumerate(dims):
        if d is not None and dims.count(d) == 1 and (i + 1 == len(dims) or dims[i + 1] is not None):
            assert flax_shape[i] == torch_shape[d]
    with pytest.raises(ValueError, match="does not fit"):
        flax_to_torch(np.zeros(flax_shape + (2,), np.float32), how, torch_shape)


@pytest.mark.parametrize("kw", [dict(momentum=0.9), dict(momentum=0.9, nesterov=True), dict()])
@pytest.mark.parametrize("schedule", [False, True])
def test_sgd_matches_optax_over_five_steps(kw, schedule):
    rng = np.random.RandomState(6)
    params = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()} for _ in range(5)]
    lr = optax.linear_schedule(0.1, 0.01, 4) if schedule else 0.1
    tx = optax.sgd(lr, **kw)
    state, want = tx.init(params), dict(params)
    for g in grads:
        updates, state = tx.update(g, state, want)
        want = optax.apply_updates(want, updates)

    from dmlcloud_tpu_torch.optim import linear_schedule

    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ("a", "b")]
    opt = sgd(linear_schedule(0.1, 0.01, 4) if schedule else 0.1, **kw)(tparams)
    for g in grads:
        for p, k in zip(tparams, ("a", "b")):
            p.grad = torch.from_numpy(g[k])
        opt.step()
    assert opt.count == 5
    for p, k in zip(tparams, ("a", "b")):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
    if kw:
        trace = np.asarray(state[0].trace["a"])
        np.testing.assert_allclose(opt.state[tparams[0]]["trace"].numpy(), trace, rtol=1e-6, atol=1e-6)
    else:
        assert not opt.state  # no momentum, no slot
