"""Resume of the port's TrainingPipeline on the CPU: the counterparts of
``tests/test_resume.py``, ``tests/test_step_checkpoint.py`` and
``tests/test_ema.py``, on the tiny ``DecoderLM`` of the port's LM example.

A run preempted mid-epoch by a real SIGUSR1 and then resumed from its
checkpoint directory must end bit-identical (``torch.equal``) to a run that was
never interrupted: parameters, EMA shadow, AdamW moments and count, step, and
the losses after the resume. Around that: epoch resume, a stopped stage, a
corrupt or missing sidecar, step-only mode, EMA toggled across a resume, and
the EMA update held against JAX's ``TrainState.update_ema`` on weights carried
by the bridge.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmlcloud_tpu import checkpoint as jckpt
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu.train_state import TrainState as JTrainState
from dmlcloud_tpu_torch import checkpoint as tckpt
from dmlcloud_tpu_torch.data import device as tdevice
from dmlcloud_tpu_torch.examples import train_lm
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.train_state import TrainState, ema_like

torch.set_num_threads(2)

#: 40 rows: 4 for validation, 9 train batches of 4
ARGV = ["--device", "cpu", "--preset", "tiny", "--vocab-size", "128", "--seq-len", "32", "--batch-size", "4",
        "--n-seqs", "40", "--lr", "0.05", "--ema", "0.9"]
TRAIN_BATCHES = 9


class _SignalAfter:
    """A train dataset that sends this process SIGUSR1 after yielding batch
    ``k`` (the real preemption path: signal -> coordinated poll at the next
    step save)."""

    def __init__(self, ds, k: int):
        self.ds, self.k = ds, k

    def __iter__(self):
        for i, batch in enumerate(self.ds):
            yield batch
            if i + 1 == self.k:
                os.kill(os.getpid(), signal.SIGUSR1)

    def __len__(self):
        return len(self.ds)


def _run(argv, root=None, resume=False, signal_after=None, **overrides):
    """Build the example's pipeline from ``argv``, override stage knobs by
    name, and run it; with ``signal_after``, preemption handling is on and
    SIGUSR1 arrives after that many train batches."""
    argv = list(argv) + (["--checkpoint-dir", str(root)] if root is not None else [])
    pipeline, stage = train_lm.build(argv, resume=resume)
    for name, value in overrides.items():
        setattr(stage, name, (lambda v: lambda: v)(value))
    if signal_after is not None:
        datasets = stage.train_dataset
        stage.train_dataset = lambda: _SignalAfter(datasets(), signal_after)
        pipeline.enable_preemption_handling(("SIGUSR1",))
    pipeline.run()
    return pipeline, stage


def _assert_states_equal(got: TrainState, want: TrainState, ema: bool = True):
    g, w = got.state_dict(), want.state_dict()
    assert got.step == want.step and got.optimizer.count == want.optimizer.count
    for part in ("params", "ema") if ema else ("params",):
        assert g[part].keys() == w[part].keys()
        for name in w[part]:
            assert torch.equal(g[part][name], w[part][name]), f"{part} {name}"
    for slot in ("mu", "nu"):
        for name in w["opt_state"][slot]:
            assert torch.equal(g["opt_state"][slot][name], w["opt_state"][slot][name]), f"{slot} {name}"


@pytest.mark.parametrize("async_save", [True, False])
def test_preempted_mid_epoch_then_resumed_equals_uninterrupted(tmp_path, async_save):
    argv = ARGV + ["--epochs", "1", "--save-every-steps", "3"]
    _, control = _run(argv, async_checkpoint=async_save)
    assert control.state.step == TRAIN_BATCHES

    # SIGUSR1 after step 4: the drain lands at the step-6 save
    pipe1, stage1 = _run(argv, root=tmp_path, resume=True, signal_after=4,
                         async_checkpoint=async_save)
    assert stage1._mid_epoch_exit and stage1._preempt_exit and stage1.state.step == 6
    ckpt = pipe1.checkpoint_dir
    assert ckpt.latest_step(scope=stage1.name) is None  # the partial epoch is no epoch save
    assert ckpt.latest_step(scope=f"{stage1.name}.steps") == 6
    verdict = jckpt.read_requeue_verdict(str(ckpt.path))  # the JAX package reads the port's verdict
    assert verdict["requeue"] is True and verdict["kind"] == "preemption" and verdict["mid_epoch"] is True
    assert verdict["save_on_preempt_latency_s"] >= 0 and "SIGUSR1" in verdict["reason"]
    assert (ckpt.path / "log.txt").stat().st_size > 0 and (ckpt.path / "config.yaml").exists()
    assert signal.getsignal(signal.SIGUSR1) is signal.SIG_DFL  # the teardown restored the disposition

    pipe2, stage2 = _run(argv, root=ckpt.path, resume=True, async_checkpoint=async_save)
    assert pipe2.resumed and pipe2.checkpoint_dir.path == ckpt.path
    _assert_states_equal(stage2.state, control.state)
    assert len(stage2.train_losses) == TRAIN_BATCHES - 6
    for got, want in zip(stage2.train_losses, control.train_losses[6:]):
        assert torch.equal(got, want)
    assert float(stage2.tracker["val/loss"][-1]) == float(control.tracker["val/loss"][-1])
    assert tckpt.read_requeue_verdict(ckpt.path)["kind"] == "completed"


def test_mid_epoch_resume_neither_runs_nor_copies_the_skipped_batches(tmp_path, monkeypatch):
    argv = ARGV + ["--epochs", "1", "--save-every-steps", "3"]
    pipe1, _ = _run(argv, root=tmp_path, resume=True, signal_after=2)
    copies, steps = [], []
    real_put = tdevice._HostCopier.put
    monkeypatch.setattr(tdevice._HostCopier, "put", lambda self, b: (copies.append(b), real_put(self, b))[1])
    real_step = train_lm.LMStage.train_step
    monkeypatch.setattr(train_lm.LMStage, "train_step", lambda self, s, b: (steps.append(1), real_step(self, s, b))[1])
    _, stage2 = _run(argv, root=pipe1.checkpoint_dir.path, resume=True)
    assert len(steps) == TRAIN_BATCHES - 3
    # the remaining train batches and the one validation batch reach the device, no more
    assert len(copies) == TRAIN_BATCHES - 3 + 1
    assert stage2.state.step == TRAIN_BATCHES


def test_epoch_resume_equals_uninterrupted(tmp_path):
    argv = ARGV + ["--n-seqs", "24"]
    _, control = _run(argv + ["--epochs", "2"])
    pipe1, stage1 = _run(argv + ["--epochs", "1"], root=tmp_path)
    assert pipe1.checkpoint_dir.latest_step(scope=stage1.name) == 1
    _, stage2 = _run(argv + ["--epochs", "2"], root=pipe1.checkpoint_dir.path, resume=True)
    assert stage2.current_epoch == 3
    _assert_states_equal(stage2.state, control.state)
    # the restored tracker carries epoch 1's history
    assert stage2.tracker["train/loss"][0] == control.tracker["train/loss"][0]
    assert float(stage2.tracker["train/loss"][1]) == float(control.tracker["train/loss"][1])


def test_stopped_stage_is_not_retrained(tmp_path):
    argv = ARGV + ["--n-seqs", "24", "--epochs", "3"]
    pipe1, stage1 = train_lm.build(argv + ["--checkpoint-dir", str(tmp_path)])
    stage1.post_epoch = stage1.stop_stage  # stops after its first epoch
    pipe1.run()
    assert stage1.current_epoch == 2
    _, stage2 = _run(argv, root=pipe1.checkpoint_dir.path, resume=True)
    assert stage2._stop_requested and stage2.current_epoch == 2
    assert stage2.state.step == stage1.state.step


@pytest.mark.parametrize("damage", ["corrupt", "missing", "ill-typed"])
def test_damaged_epoch_sidecar_degrades_to_state_only_resume(tmp_path, damage):
    argv = ARGV + ["--n-seqs", "24"]
    pipe1, stage1 = _run(argv + ["--epochs", "1"], root=tmp_path)
    sidecar = pipe1.checkpoint_dir.path / "meta" / stage1.name / "1.json"
    if damage == "corrupt":
        sidecar.write_text("{not json")
    elif damage == "missing":
        sidecar.unlink()
    else:
        sidecar.write_text(json.dumps({"epoch": 1, "stopped": False, "tracker": {"epoch": 2}}))
    _, stage2 = _run(argv + ["--epochs", "2"], root=pipe1.checkpoint_dir.path, resume=True)
    # the tensors still came back: epoch 2 continued from epoch 1's state
    assert stage2.current_epoch == 3 and stage2.state.step == 2 * stage1.state.step
    assert len(stage2.tracker["train/loss"]) == 1  # the history was lost, the run was not


def test_step_only_mode_resumes_mid_epoch(tmp_path):
    argv = ARGV + ["--epochs", "1", "--save-every-steps", "2"]
    _, control = _run(argv)
    pipe1, _ = _run(argv, root=tmp_path, resume=True, signal_after=3,
                    checkpoint_every=0)
    assert not (pipe1.checkpoint_dir.state_dir / "LMStage").exists()
    _, stage2 = _run(argv, root=pipe1.checkpoint_dir.path, resume=True, checkpoint_every=0)
    _assert_states_equal(stage2.state, control.state)


def test_corrupt_step_sidecar_still_restores_the_weights(tmp_path):
    argv = ARGV + ["--epochs", "1", "--save-every-steps", "2"]
    pipe1, stage1 = _run(argv, root=tmp_path, resume=True, signal_after=3,
                         checkpoint_every=0)
    (pipe1.checkpoint_dir.path / "meta" / "LMStage.steps" / "4.json").write_text("garbage")
    saved = {n: p.clone() for n, p in stage1.state.model.named_parameters()}
    pipe2, stage2 = train_lm.build(argv + ["--checkpoint-dir", str(pipe1.checkpoint_dir.path)], resume=True)
    stage2.checkpoint_every = lambda: 0
    stage2.max_epochs = 0  # restore only
    pipe2.run()
    assert stage2.state.step == 4 and stage2.current_epoch == 1
    for n, p in stage2.state.model.named_parameters():
        assert torch.equal(p, saved[n]), n


@pytest.mark.parametrize("ema_before, ema_after", [("0", "0.9"), ("0.9", "0")])
def test_ema_toggled_across_a_resume(tmp_path, ema_before, ema_after):
    argv = ARGV + ["--n-seqs", "24"]
    pipe1, stage1 = _run(argv + ["--epochs", "1", "--ema", ema_before], root=tmp_path)
    params_after_1 = {n: p.detach().clone() for n, p in stage1.state.model.named_parameters()}
    pipe2, stage2 = train_lm.build(argv + ["--epochs", "1", "--ema", ema_after, "--checkpoint-dir",
                                          str(pipe1.checkpoint_dir.path)], resume=True)
    stage2.max_epochs = 0  # restore only
    pipe2.run()
    assert stage2.state.step == stage1.state.step
    if ema_after == "0":
        assert stage2.state.ema is None
    else:
        # newly enabled: the shadow starts from the RESTORED params
        for n, e in stage2.state.ema.items():
            assert torch.equal(e, params_after_1[n]), n


def test_restore_before_the_first_step_fills_moments_and_count(tmp_path):
    """AdamW creates its moments lazily and keeps its count outside
    ``Optimizer.state_dict()``: a restore into a state that never stepped
    must still bring both back."""
    argv = ARGV + ["--n-seqs", "24", "--epochs", "1"]
    _, trained = _run(argv)
    ckpt = tckpt.CheckpointDir(tmp_path / "run")
    ckpt.create()
    ckpt.save_state(1, trained.state.state_dict(), scope="s")
    ckpt.wait_until_finished()

    cfg = trained.state.model.cfg
    fresh = TrainState.create(model=ttr.DecoderLM(cfg, device="cpu"), tx=trained.pipeline.optimizers["adamw"],
                              ema=True)
    assert not fresh.optimizer.state and fresh.optimizer.count == 0
    template = fresh.state_dict()
    ckpt.restore_state(1, template=template, scope="s")
    fresh.load_state_dict(template)
    _assert_states_equal(fresh, trained.state)


def test_validation_runs_on_the_ema_without_copying_it():
    argv = ARGV + ["--n-seqs", "24", "--epochs", "1"]
    _, stage = _run(argv)
    state = stage.state
    seen = {}
    real = torch.func.functional_call

    def spy(module, tensors, args, kwargs=None):
        seen["ptrs"] = {n: t.data_ptr() for n, t in tensors.items()}
        return real(module, tensors, args, kwargs)

    torch.func.functional_call, old = spy, torch.func.functional_call
    try:
        batch = next(iter(stage._feed(stage.val_dataset())))
        got = float(stage._val_step(batch)["loss"])
    finally:
        torch.func.functional_call = old
    assert seen["ptrs"] == {n: e.data_ptr() for n, e in state.ema.items()}
    averaged = ttr.DecoderLM(state.model.cfg, device="cpu")
    averaged.load_state_dict(state.ema)
    with torch.no_grad():
        want = float(ttr.lm_loss(averaged(batch), batch))
    assert got == want
    with torch.no_grad():
        assert got != float(stage.step(state, batch))  # the raw params give another loss


# ---------------------------------------------------------------------------
# the EMA against the JAX package, on weights carried by the bridge
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8, hidden_dim=32, mlp_dim=64,
            max_seq_len=16)


def _flax_tree(seed):
    model = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **TINY))
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


#: jnp's ``d*e + (1-d)*p`` against ``torch._foreach_lerp_``'s ``e + (1-d)*(p-e)``:
#: both fp32, so they differ by rounding (a few ulp of the leaf's scale)
EMA_TOL = dict(rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("decay", [0.9, 0.999])
def test_ema_matches_jax_update_ema_on_bridged_weights(decay):
    jmodel, init = _flax_tree(0)
    rng = np.random.RandomState(1)
    steps = [jax.tree_util.tree_map(lambda x: (x + rng.randn(*x.shape).astype(np.float32) * 0.1), init)
             for _ in range(4)]

    jstate = JTrainState.create(apply_fn=jmodel.apply, params=init, tx=optax.sgd(0.0), ema=True)
    model = ttr.load_flax_params(ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **TINY), device="cpu"), init)
    tstate = TrainState.create(model=model, tx=lambda p: torch.optim.SGD(p, lr=0.0), ema=True)
    for params in steps:
        jstate = jstate.replace(params=params).update_ema(decay)
        ttr.load_flax_params(model, params)
        tstate.update_ema(decay)
    got = ttr.to_flax_params(model, tensors=tstate.ema)
    for (path, want), (_, leaf) in zip(jax.tree_util.tree_flatten_with_path(jstate.ema)[0],
                                       jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_allclose(leaf, np.asarray(want), err_msg=jax.tree_util.keystr(path), **EMA_TOL)


def test_jax_ema_tree_crosses_the_bridge_into_the_port_shadow():
    jmodel, init = _flax_tree(0)
    _, other = _flax_tree(1)
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=init, tx=optax.sgd(0.0), ema=other)
    model = ttr.load_flax_params(ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **TINY), device="cpu"), init)
    shadow = ema_like(model)
    ttr.load_flax_params(model, jax.tree_util.tree_map(np.asarray, jstate.ema), tensors=shadow)
    back = ttr.to_flax_params(model, tensors=shadow)
    for (path, want), (_, leaf) in zip(jax.tree_util.tree_flatten_with_path(other)[0],
                                       jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(leaf, want, err_msg=jax.tree_util.keystr(path))
    # the module's own parameters were not touched
    for (path, want), (_, leaf) in zip(jax.tree_util.tree_flatten_with_path(init)[0],
                                       jax.tree_util.tree_flatten_with_path(ttr.to_flax_params(model))[0]):
        np.testing.assert_array_equal(leaf, want, err_msg=jax.tree_util.keystr(path))


def test_update_ema_keeps_an_fp32_shadow_and_tracks_non_float_leaves():
    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(4, dtype=torch.bfloat16))
            self.n = torch.nn.Parameter(torch.zeros(2, dtype=torch.int32), requires_grad=False)

    m = M()
    state = TrainState.create(model=m, tx=lambda p: torch.optim.SGD(p, lr=0.0), ema=True)
    assert state.ema["w"].dtype == torch.float32 and state.ema["n"].dtype == torch.int32
    with torch.no_grad():
        m.w.fill_(1.0)
        m.n.fill_(7)
    for _ in range(3):
        state.update_ema(0.9995)  # rounds to 1.0 in bf16: a bf16 shadow would never move
    np.testing.assert_allclose(state.ema["w"].numpy(), 1.0 - 0.9995**3, rtol=1e-4)
    assert torch.equal(state.ema["n"], m.n)
