"""The port's MNIST model and example against the JAX package's, on the CPU.

``models/cnn.py``'s ``MnistCNN`` takes the reference's NHWC batch: with the
flax weights bridged in, its logits and its gradients (input and every
parameter) equal flax's within ``TOL`` fp32, and the bridge round-trips
exactly. ``examples/mnist.py``'s ``MnistStage`` then trains 5 steps on the
synthetic digits; each step's loss and accuracy equal a one-device JAX step
(``MnistCNN.apply``, ``optax.adam(cosine_decay_schedule)``, plain ``jax.jit``)
on the same batches from the same weights within ``STEP_RTOL``. Last, the
example's ``main`` on the CPU learns the digits.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmlcloud_tpu.data import ShardedSequenceDataset as JShardedSequenceDataset
from dmlcloud_tpu.models.cnn import MnistCNN as JMnistCNN
from dmlcloud_tpu_torch.examples import mnist
from dmlcloud_tpu_torch.models.cnn import MnistCNN, load_flax_params, to_flax_params

torch.set_num_threads(2)

#: tests/test_kernel_numerics.py:28, fp32
TOL = dict(atol=5e-5, rtol=5e-5)
#: per-step loss and accuracy over 5 steps, relative: each side rounds its
#: convolutions differently and Adam carries that into the next step's weights
STEP_RTOL = 1e-4
STEPS = 5


def _flax_params(seed: int = 0) -> dict:
    params = JMnistCNN().init(jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 1)))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def test_bridged_logits_and_gradients_equal_flax():
    tree = _flax_params()
    rng = np.random.RandomState(0)
    x = rng.rand(6, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, 6)

    def jloss(params, x):
        logits = JMnistCNN().apply({"params": params}, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), logits

    (jl, jlogits), (jgrads, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(tree, jnp.asarray(x))
    model = load_flax_params(MnistCNN(), tree)
    tx = torch.from_numpy(x).requires_grad_(True)
    logits = model(tx)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    tgrads = to_flax_params(model, tensors={n: p.grad for n, p in model.named_parameters()})
    for layer, leaves in jax.tree_util.tree_map(np.asarray, jgrads).items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(tgrads[layer][leaf], want, **TOL, err_msg=f"{layer}/{leaf}")


def test_bridge_round_trips_exactly_and_rejects_wrong_shapes():
    tree = _flax_params(3)
    back = to_flax_params(load_flax_params(MnistCNN(), {"params": tree}))
    for layer in tree:
        for leaf in tree[layer]:
            np.testing.assert_array_equal(back[layer][leaf], tree[layer][leaf])
    tree["Dense_0"]["kernel"] = tree["Dense_0"]["kernel"][:-1]
    with pytest.raises(ValueError, match="Dense_0"):
        load_flax_params(MnistCNN(), tree)


class _FiveSteps(mnist.MnistStage):
    """The example's stage, trained on its first ``STEPS`` batches only, with
    its initial weights and each step's accuracy recorded."""

    def pre_stage(self):
        super().pre_stage()
        self.start = to_flax_params(self.pipeline.models["cnn"].module)
        full = self.pipeline.datasets.pop("train")
        del self.pipeline.datasets["val"]

        class First:
            def set_epoch(self, epoch):
                full.set_epoch(epoch)

            def __iter__(self):
                return itertools.islice(iter(full), STEPS)

        self.pipeline.register_dataset("train", First(), verbose=False)
        self.accuracies = []

    def _train_step(self, batch):
        metrics = super()._train_step(batch)
        self.accuracies.append(float(metrics["accuracy"]))
        return metrics


def test_mnist_stage_steps_equal_the_jax_step():
    pipe, _ = mnist.build(["--device", "cpu", "--epochs", "1"])
    stage = _FiveSteps()
    pipe.stages.clear()
    pipe.append_stage(stage, max_epochs=1)
    pipe.run()
    losses = [float(x) for x in stage.train_losses]

    # the same batches: the reference's shard of epoch 1, batch 32
    tr_x, tr_y, _, _ = mnist.synthetic_digits()
    idx_ds = JShardedSequenceDataset(list(range(len(tr_x))), shuffle=True, rank=0, world_size=1)
    idx_ds.set_epoch(1)
    idx = np.fromiter(idx_ds, dtype=np.int64)
    model, tx = JMnistCNN(), optax.adam(optax.cosine_decay_schedule(1e-3, decay_steps=1000))

    @jax.jit
    def step(params, opt_state, x, y):
        def loss_fn(params):
            logits = model.apply({"params": params}, x)
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, jnp.mean(jnp.argmax(logits, -1) == y)

    params = jax.tree_util.tree_map(jnp.asarray, stage.start)
    opt_state = tx.init(params)
    j_losses, j_accs = [], []
    for i in range(STEPS):
        sel = idx[i * 32 : (i + 1) * 32]
        params, opt_state, loss, acc = step(params, opt_state, tr_x[sel], tr_y[sel])
        j_losses.append(float(loss))
        j_accs.append(float(acc))
    assert len(losses) == STEPS
    np.testing.assert_allclose(losses, j_losses, rtol=STEP_RTOL)
    np.testing.assert_allclose(stage.accuracies, j_accs, rtol=STEP_RTOL)
    assert max(losses) - min(losses) > 0.1, "the steps did not move the loss: the comparison would be vacuous"


def test_mnist_example_learns_the_synthetic_digits_on_the_cpu():
    """One epoch of the reference's flags at batch 128 (32 steps of the 4096
    synthetic digits; the reference's batch 32 would take 128): validation
    accuracy far above the 0.1 of chance."""
    stage = mnist.main(["--device", "cpu", "--epochs", "1", "--batch-size", "128"])
    tracker = stage.tracker
    assert float(tracker["misc/total_train_batches"][-1]) == 32
    assert float(tracker["val/accuracy"][-1]) > 0.5
    assert float(tracker["val/loss"][-1]) < float(tracker["train/loss"][-1])


def test_synthetic_digits_are_the_reference_examples_arrays():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "reference_mnist_example", Path(__file__).resolve().parent.parent / "examples" / "mnist.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for got, want in zip(mnist.synthetic_digits(), ref.load_mnist()):  # no torchvision here: its fallback
        np.testing.assert_array_equal(got, want)
    assert mnist.load_mnist()[0].shape == (4096, 28, 28, 1)
