"""A mid-epoch resume from the train dataset's iterator state, on the CPU.

A tiny ``TrainValStage`` trains a tiny ``DecoderLM`` on a ``.dmlshard``
corpus through ``ShardReader -> pack_stream -> batch``, fed by the stage's own
device feed (copies in flight, with and without host read-ahead), and through
``examples.train_lm --corpus`` (the pipeline ending in ``to_device``). Each is
preempted by a real SIGUSR1 and resumed from its run directory:

- the step sidecar carries ``"data"``, the pipeline's cursor at the batch the
  step took (not at the batches in flight), equal to the JAX package's
  ``state_dict`` of the same pipeline after the same batches;
- the resume fast-forwards from it (the log says so) and skips no batch by
  count;
- parameters, AdamW moments and count, and the losses after the resume are
  bitwise those of an uninterrupted run;
- with the flight recorder armed, ``misc/shard_reader`` marks the epochs a
  ``ShardReader`` fed.
"""

import json
import logging
import os
import signal

import numpy as np
import pytest
import torch

import dmlcloud_tpu_torch as dml
from dmlcloud_tpu.data import datasets as jd
from dmlcloud_tpu.data import store as js
from dmlcloud_tpu_torch.data import ShardReader, build_corpus
from dmlcloud_tpu_torch.examples import train_lm
from dmlcloud_tpu_torch.models.transformer import DecoderLM, TransformerConfig, lm_loss
from dmlcloud_tpu_torch.optim import adamw

torch.set_num_threads(2)

SEQ, ROWS, WINDOW, SAVE_EVERY = 32, 2, 8, 2
TINY = dict(num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8, hidden_dim=32, mlp_dim=64)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rs = np.random.RandomState(0)
    lengths = np.clip(np.round(rs.lognormal(np.log(12), 0.8, 90)), 2, 60).astype(int)
    docs = [rs.randint(1, 128, size=int(k)).astype(np.int32) for k in lengths]
    d = tmp_path_factory.mktemp("corpus")
    build_corpus(d, docs, shard_tokens=300)
    return str(d)


def _rows(rows):
    return {k: np.stack([r[k] for r in rows]) for k in ("tokens", "segment_ids")}


class CorpusStage(dml.TrainValStage):
    """The tiny model on ``ShardReader(corpus).pack_stream(...).batch(...)``,
    registered as it is: the stage's own feed puts it on the device."""

    def __init__(self, corpus: str, host_prefetch: int):
        super().__init__()
        self.corpus, self._host_prefetch = corpus, host_prefetch

    def pre_stage(self):
        torch.manual_seed(0)
        model = DecoderLM(TransformerConfig(vocab_size=128, max_seq_len=SEQ, attn_impl="flash", **TINY), device="cpu")
        ds = ShardReader(self.corpus, read_ahead=4).pack_stream(SEQ, pack_window=WINDOW).batch(
            ROWS, drop_remainder=True, collate=_rows)
        self.pipeline.register_dataset("train", ds)
        self.pipeline.register_model("lm", model)
        self.pipeline.register_optimizer("adamw", adamw(0.02))

    def checkpoint_every_steps(self):
        return SAVE_EVERY

    def host_prefetch(self):
        return self._host_prefetch

    def step(self, state, batch):
        logits = state.model(batch["tokens"], segment_ids=batch["segment_ids"])
        return lm_loss(logits, batch["tokens"], segment_ids=batch["segment_ids"])


def _signal_after(stage, k: int) -> None:
    """SIGUSR1 to this process right after the stage's ``k``-th train step."""
    step = stage._train_step
    done = [0]

    def wrapped(batch):
        out = step(batch)
        done[0] += 1
        if done[0] == k:
            os.kill(os.getpid(), signal.SIGUSR1)
        return out

    stage._train_step = wrapped


def _run(make_stage, root=None, signal_after=None, epochs=2, telemetry=None):
    pipe = dml.TrainingPipeline({"seed": 0}, name="corpus", device="cpu", telemetry=telemetry)
    if root is not None:
        pipe.enable_checkpointing(str(root), resume=True)
    stage = make_stage()
    pipe.append_stage(stage, max_epochs=epochs)
    if signal_after is not None:
        pipe.enable_preemption_handling(("SIGUSR1",))
        _signal_after(stage, signal_after)
    pipe.run()
    return pipe, stage


def _assert_states_equal(got, want):
    g, w = got.state_dict(), want.state_dict()
    assert got.step == want.step and got.optimizer.count == want.optimizer.count
    for name in w["params"]:
        assert torch.equal(g["params"][name], w["params"][name]), name
    for slot in ("mu", "nu"):
        for name in w["opt_state"][slot]:
            assert torch.equal(g["opt_state"][slot][name], w["opt_state"][slot][name]), f"{slot} {name}"


def _reference_state(corpus: str, epoch: int, batches: int, first_batches: int | None = None) -> dict:
    """The JAX package's ``state_dict`` of the same pipeline after ``batches``."""
    host = js.ShardReader(corpus, read_ahead=4).pack_stream(SEQ, pack_window=WINDOW).batch(
        ROWS, drop_remainder=True, collate=_rows)
    if first_batches is not None:
        host = jd.DataPipeline.from_source(train_lm._FirstBatches(host, first_batches))
    host.set_epoch(epoch)
    it = iter(host)
    for _ in range(batches):
        next(it)
    state = host.state_dict()
    it.close()
    return state


@pytest.mark.parametrize("host_prefetch", [0, 2])
def test_stage_feed_resumes_from_the_iterator_state(tmp_path, corpus, caplog, host_prefetch):
    make = lambda: CorpusStage(corpus, host_prefetch)  # noqa: E731
    _, control = _run(make, telemetry=str(tmp_path / "telemetry"))
    per_epoch = int(control.tracker["misc/total_train_batches"][-1])
    assert per_epoch >= 8 and control.tracker["misc/shard_reader"] == [1.0, 1.0]
    c_losses = [float(x) for x in control.train_losses]

    # epoch 2, SIGUSR1 after its step 3: the drain lands at its step-4 save
    pipe1, stage1 = _run(make, root=tmp_path / "run", signal_after=per_epoch + 3)
    assert stage1._mid_epoch_exit and stage1.current_epoch == 2
    gstep = per_epoch + 4
    assert stage1.state.step == gstep
    sidecar = json.loads((pipe1.checkpoint_dir.path / "meta" / f"{stage1.name}.steps" / f"{gstep}.json").read_text())
    assert sidecar["step_in_epoch"] == 4
    # the cursor of the 4 batches the steps took, not of those in flight
    assert sidecar["data"] == _reference_state(corpus, 2, 4) == {"v": 1, "epoch": 2, "global_offset": 4,
                                                                  "world_size": 1}

    with caplog.at_level(logging.INFO, logger="dmlcloud_tpu_torch"):
        _, resumed = _run(make, root=pipe1.checkpoint_dir.path)
    messages = [r.getMessage() for r in caplog.records]
    assert any("fast-forwarded from saved iterator state" in m for m in messages)
    assert not any("skipping the first" in m for m in messages)
    _assert_states_equal(resumed.state, control.state)
    assert [float(x) for x in resumed.train_losses] == c_losses[4:]


def test_train_lm_corpus_pipeline_resumes_bitwise(tmp_path, corpus, caplog):
    argv = ["--device", "cpu", "--preset", "tiny", "--vocab-size", "128", "--seq-len", str(SEQ), "--batch-size",
            str(ROWS), "--n-seqs", "16", "--epochs", "1", "--corpus", corpus, "--pack-window", str(WINDOW),
            "--save-every-steps", "2", "--attn", "flash"]
    pipe, control = train_lm.build(argv)
    pipe.run()
    assert control.state.step == 8 and "val/loss" not in control.tracker
    assert control.pack_stats.rows >= 16 and 0 <= control.pack_stats.pad_fraction < 1

    pipe1, stage1 = train_lm.build(argv + ["--checkpoint-dir", str(tmp_path)], resume=True)
    pipe1.enable_preemption_handling(("SIGUSR1",))
    _signal_after(stage1, 3)
    pipe1.run()
    assert stage1._mid_epoch_exit and stage1.state.step == 4
    sidecar = json.loads((pipe1.checkpoint_dir.path / "meta" / "LMStage.steps" / "4.json").read_text())
    assert sidecar["data"] == _reference_state(corpus, 1, 4, first_batches=8)

    with caplog.at_level(logging.INFO, logger="dmlcloud_tpu_torch"):
        pipe2, resumed = train_lm.build(argv + ["--checkpoint-dir", str(pipe1.checkpoint_dir.path)], resume=True)
        pipe2.run()
    assert any("fast-forwarded from saved iterator state" in r.getMessage() for r in caplog.records)
    _assert_states_equal(resumed.state, control.state)
    assert [float(x) for x in resumed.train_losses] == [float(x) for x in control.train_losses][4:]
