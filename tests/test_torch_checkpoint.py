"""The port's checkpoint directories against the JAX package's, on the CPU.

The directory contract (indicator, ``config.yaml``, ``log.txt``,
``.slurm-jobid``), the run-path format, the requeue verdict (``requeue.json``,
schema v1) and Slurm rediscovery are shared: a directory one package writes,
the other finds, validates and reads. Retention and keep-best agree with the
reference's ``orbax_compat.steps_to_keep``. The tensor state goes through
``torch.distributed.checkpoint``: a save survives a transient ``OSError``, and
an async save is a snapshot that the next optimizer step cannot change.
"""

import re
from datetime import datetime

import pytest
import torch

from dmlcloud_tpu import checkpoint as jckpt
from dmlcloud_tpu.utils import orbax_compat
from dmlcloud_tpu_torch import checkpoint as tckpt
from dmlcloud_tpu_torch.optim import adamw
from dmlcloud_tpu_torch.train_state import TrainState

torch.set_num_threads(2)

PACKAGES = {"jax": jckpt, "port": tckpt}


def test_generate_checkpoint_path_has_the_same_format(tmp_path):
    dt = datetime(2026, 3, 4, 5, 6)
    got = tckpt.generate_checkpoint_path(tmp_path, "exp/1", dt=dt)
    want = jckpt.generate_checkpoint_path(tmp_path, "exp/1", dt=dt)
    assert str(got.parent) == str(want.parent)
    pattern = r"exp_1-2026\.03\.04-05\.06-[a-z0-9]{8}"
    assert re.fullmatch(pattern, got.name) and re.fullmatch(pattern, want.name)
    assert got != tckpt.generate_checkpoint_path(tmp_path, "exp/1", dt=dt)
    assert tckpt.generate_checkpoint_path(tmp_path).name.startswith("run-")


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
def test_a_created_dir_is_valid_for_the_other_package(tmp_path, monkeypatch, writer, reader):
    monkeypatch.setenv("SLURM_JOB_ID", "4242")
    made = PACKAGES[writer].CheckpointDir(tmp_path / "run")
    assert not made.is_valid
    made.create()
    seen = PACKAGES[reader].CheckpointDir(str(tmp_path / "run"))
    assert seen.is_valid and seen.slurm_job_id == "4242"
    for name in (".dmlcloud_tpu", "log.txt", ".slurm-jobid"):
        assert (tmp_path / "run" / name).exists()
    with pytest.raises(RuntimeError):
        made.create()


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
def test_config_yaml_round_trips_across_the_packages(tmp_path, writer, reader):
    PACKAGES[writer].CheckpointDir(tmp_path / "run").create()
    PACKAGES[writer].CheckpointDir(tmp_path / "run").save_config(
        {"lr": 0.1, "model": {"depth": 3, "name": "lm"}, "tags": [1, 2]})
    cfg = PACKAGES[reader].CheckpointDir(str(tmp_path / "run")).load_config()
    assert cfg.lr == 0.1 and cfg.model.depth == 3 and cfg.model.name == "lm" and list(cfg.tags) == [1, 2]


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
def test_each_package_reads_the_others_requeue_verdict(tmp_path, writer, reader):
    PACKAGES[writer].write_requeue_verdict(str(tmp_path), True, "drained on SIGUSR1", "preemption",
                                           stage="LMStage", epoch=1, mid_epoch=True, save_on_preempt_latency_s=0.25)
    got = PACKAGES[reader].read_requeue_verdict(str(tmp_path))
    assert got["v"] == 1 and got["requeue"] is True and got["kind"] == "preemption"
    assert got["mid_epoch"] is True and got["save_on_preempt_latency_s"] == 0.25 and got["stage"] == "LMStage"
    assert got == PACKAGES[writer].read_requeue_verdict(str(tmp_path))


@pytest.mark.parametrize("content", ["{torn", '{"v": 2, "requeue": true}', '{"v": 1, "requeue": "yes"}', "[]"])
def test_a_bad_verdict_reads_as_none_in_both(tmp_path, content):
    (tmp_path / "requeue.json").write_text(content)
    assert tckpt.read_requeue_verdict(tmp_path) is None
    assert jckpt.read_requeue_verdict(str(tmp_path)) is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_find_slurm_checkpoint_finds_the_same_dir_in_both(tmp_path, monkeypatch, writer):
    (tmp_path / "notes.txt").write_text("not a run dir")
    (tmp_path / "unrelated").mkdir()
    monkeypatch.setenv("SLURM_JOB_ID", "111")
    PACKAGES[writer].CheckpointDir(tmp_path / "other-job").create()
    monkeypatch.setenv("SLURM_JOB_ID", "777")
    mine = PACKAGES[writer].CheckpointDir(tmp_path / "mine")
    mine.create()
    stale = PACKAGES[writer].CheckpointDir(tmp_path / "stale")
    stale.create()
    (tmp_path / "stale" / ".dmlcloud_tpu").unlink()  # torn down: must not be rediscovered
    assert str(tckpt.find_slurm_checkpoint(tmp_path)) == str(jckpt.find_slurm_checkpoint(str(tmp_path)))
    assert str(tckpt.find_slurm_checkpoint(tmp_path)) == str(tmp_path / "mine")
    monkeypatch.setenv("SLURM_JOB_ID", "999")
    assert tckpt.find_slurm_checkpoint(tmp_path) is None and jckpt.find_slurm_checkpoint(str(tmp_path)) is None
    monkeypatch.delenv("SLURM_JOB_ID")
    assert tckpt.find_slurm_checkpoint(tmp_path) is None and jckpt.find_slurm_checkpoint(str(tmp_path)) is None


def test_pipeline_resume_rediscovers_by_job_id(tmp_path, monkeypatch):
    import dmlcloud_tpu_torch as tdml

    monkeypatch.setenv("SLURM_JOB_ID", "4242")
    jckpt.CheckpointDir(str(tmp_path / "attempt-1")).create()
    pipe = tdml.TrainingPipeline(name="requeue", device="cpu")
    pipe.enable_checkpointing(str(tmp_path), resume=True)
    assert pipe.resumed is True and pipe.checkpoint_dir.path == tmp_path / "attempt-1"
    monkeypatch.setenv("SLURM_JOB_ID", "5555")
    fresh = tdml.TrainingPipeline(name="requeue", device="cpu")
    fresh.enable_checkpointing(str(tmp_path), resume=True)
    assert fresh.resumed is False and fresh.checkpoint_dir.path.parent == tmp_path


# ---------------------------------------------------------------------------
# retention against the reference's host-side policy evaluation
# ---------------------------------------------------------------------------

METRICS = {1: {"l": 3.0}, 2: {"l": 1.0}, 3: {"l": 2.0}, 4: {"l": 5.0}, 6: {"l": 1.5}}
STEPS = [1, 2, 3, 4, 5, 6, 7]


def _policies(pkg, n, mode, latest, without):
    best = pkg.BestN(get_metric_fn=lambda m: m["l"], reverse=(mode == "min"), n=n,
                     keep_checkpoints_without_metrics=without)
    return pkg.AnyPreservationPolicy([pkg.LatestN(n=latest), best]) if latest else best


@pytest.mark.parametrize("n, mode, latest, without", [
    (2, "min", 1, False),  # the stage's keep-best composition
    (2, "max", 1, False),
    (3, "min", 0, True),
    (1, "max", 2, True),
    (None, "min", 1, False),
    (0, "min", 1, False),
])
def test_keep_best_agrees_with_the_reference(n, mode, latest, without):
    got = tckpt.steps_to_keep(_policies(tckpt, n, mode, latest, without), STEPS, METRICS)
    want = orbax_compat.steps_to_keep(_policies(orbax_compat, n, mode, latest, without), STEPS, METRICS)
    assert got == want


def _tiny_state(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Linear(8, 2))
    return TrainState.create(model=model, tx=adamw(0.1), ema=True)


def _step(state):
    loss = state.model(torch.randn(4, 8)).square().mean()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.apply_gradients()
    state.update_ema(0.9)


@pytest.mark.parametrize("async_save", [True, False])
def test_max_to_keep_and_keep_best_retention_on_disk(tmp_path, async_save):
    ckpt = tckpt.CheckpointDir(tmp_path / "run")
    ckpt.create()
    state = _tiny_state()
    ckpt.state_manager("recent", max_to_keep=2, async_save=async_save)
    policy = _policies(tckpt, 2, "min", 1, False)
    ckpt.state_manager("best", async_save=async_save, preservation_policy=policy)
    (ckpt.state_dir / "recent" / "9").mkdir(parents=True)  # a killed run's uncommitted save
    assert ckpt.latest_step("recent") is None
    for step in range(1, 6):
        _step(state)
        ckpt.save_state(step, state.state_dict(), scope="recent")
        ckpt.save_state(step, state.state_dict(), scope="best", metrics=METRICS.get(step))
    ckpt.wait_until_finished()
    assert ckpt.state_manager("recent").all_steps() == [4, 5] and ckpt.latest_step("recent") == 5
    assert not (ckpt.state_dir / "recent" / "9").exists()
    want = orbax_compat.steps_to_keep(_policies(orbax_compat, 2, "min", 1, False), range(1, 6), METRICS)
    assert set(ckpt.state_manager("best").all_steps()) == want == {2, 3, 5}
    # the rankings persist for a restarted run
    again = tckpt.CheckpointDir(tmp_path / "run")
    again.state_manager("best", async_save=async_save, preservation_policy=_policies(tckpt, 2, "min", 1, False))
    _step(state)
    again.save_state(6, state.state_dict(), scope="best", metrics=METRICS[6])
    again.wait_until_finished()
    assert set(again.state_manager("best").all_steps()) == {2, 6}


def test_state_manager_options_bind_once(tmp_path):
    ckpt = tckpt.CheckpointDir(tmp_path)
    first = ckpt.state_manager("s", preservation_policy=_policies(tckpt, 2, "min", 1, False))
    # the same configuration again (a rebuilt lambda) is fine, another raises
    assert ckpt.state_manager("s", preservation_policy=_policies(tckpt, 2, "min", 1, False)) is first
    assert ckpt.state_manager("s") is first
    with pytest.raises(RuntimeError, match="already exists"):
        ckpt.state_manager("s", preservation_policy=_policies(tckpt, 3, "min", 1, False))
    with pytest.raises(RuntimeError, match="already exists"):
        ckpt.state_manager("s", max_to_keep=5)


@pytest.mark.parametrize("failures, ok", [(2, True), (3, False)])
def test_a_transient_oserror_at_save_is_retried(tmp_path, monkeypatch, failures, ok):
    ckpt = tckpt.CheckpointDir(tmp_path)
    ckpt.save_backoff_s = 0.0
    state = _tiny_state()
    real_save = tckpt.dcp.async_save
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) <= failures:
            raise OSError(f"transient {len(calls)}")
        return real_save(*args, **kwargs)

    monkeypatch.setattr(tckpt.dcp, "async_save", flaky)
    if ok:
        ckpt.save_state(1, state.state_dict(), scope="s")
        ckpt.wait_until_finished()
        assert ckpt.latest_step("s") == 1 and len(calls) == 3
    else:
        with pytest.raises(OSError, match="transient 1"):  # the ORIGINAL error surfaces
            ckpt.save_state(1, state.state_dict(), scope="s")
        assert len(calls) == 3 and ckpt.latest_step("s") is None


def test_an_async_save_is_a_snapshot(tmp_path):
    """The step mutates the live tensors in place: an async save at step k,
    followed at once by step k+1, must still restore step k's state."""
    state = _tiny_state()
    for _ in range(2):
        _step(state)
    want = {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v.clone()
            for k, v in state.state_dict().items() if k != "opt_state"}
    want_moments = {n: t.clone() for n, t in state.state_dict()["opt_state"]["mu"].items()}
    ckpt = tckpt.CheckpointDir(tmp_path)
    ckpt.save_state(2, state.state_dict(), scope="s")  # async by default
    assert ckpt.state_manager("s").last_save["async"]
    _step(state)  # mutates params, moments and EMA while the write may still run
    ckpt.wait_until_finished()
    info = ckpt.state_manager("s").last_save
    assert info["bytes"] > 0 and info["blocking_s"] >= 0 and info["commit_s"] >= 0

    restored = _tiny_state(seed=1)
    template = restored.state_dict()
    ckpt.restore_state(template=template, scope="s")
    restored.load_state_dict(template)
    assert restored.step == 2 and restored.optimizer.count == 2
    for part in ("params", "ema"):
        for n, t in want[part].items():
            assert torch.equal(getattr(restored, "ema")[n] if part == "ema" else template["params"][n], t)
    for n, t in want_moments.items():
        assert torch.equal(template["opt_state"]["mu"][n], t)
    assert not torch.equal(template["params"]["0.weight"], state.state_dict()["params"]["0.weight"])


def test_restore_needs_a_template_and_an_empty_scope_restores_nothing(tmp_path):
    ckpt = tckpt.CheckpointDir(tmp_path)
    with pytest.raises(ValueError, match="template"):
        ckpt.restore_state(scope="s")
    assert ckpt.restore_state(template={}, scope="s") is None
