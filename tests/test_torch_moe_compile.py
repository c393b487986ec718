"""The MoE ``DecoderLM`` under the compiled step, on the CPU.

A tiny fp32 MoE model (2 blocks, the second MoE, binding capacity) trains 3
AdamW steps through ``TrainingPipeline(precompile=True)`` with a step that
returns ``lm_loss + total_aux_loss``: the forward, the index dispatch and the
aux loss the MoE layer keeps on itself trace in one graph
(``fullgraph=True``, Dynamo's ``aot_eager`` backend, one signature, no
recompile), and the losses and parameters equal the eager run's within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmlcloud_tpu_torch as tdml
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu_torch import optim as toptim
from dmlcloud_tpu_torch.compile import aot
from dmlcloud_tpu_torch.models import moe as tmoe
from dmlcloud_tpu_torch.models import transformer as ttr

torch.set_num_threads(2)

CFG = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8, hidden_dim=16, mlp_dim=32, max_seq_len=32,
           num_experts=4, moe_every=2, moe_capacity_factor=0.5)
STEPS, BATCH, SEQ = 3, 4, 16
REL = 1e-5


@pytest.fixture(autouse=True)
def aot_eager(monkeypatch):
    monkeypatch.setattr(aot, "BACKEND", "aot_eager")


def _tree():
    model = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **CFG))
    return jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(1), jnp.zeros((1, SEQ), jnp.int32))["params"])


class MoEStage(tdml.TrainValStage):
    def __init__(self, tree):
        super().__init__()
        self.tree = tree

    def pre_stage(self):
        model = ttr.load_flax_params(ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **CFG), device="cpu"),
                                     self.tree)
        self.pipeline.register_model("lm", model, verbose=False)
        self.pipeline.register_optimizer("adamw", toptim.adamw(1e-2))
        rng = np.random.RandomState(0)
        self.pipeline.register_dataset("train", [rng.randint(0, CFG["vocab_size"], (BATCH, SEQ)) for _ in range(STEPS)],
                                       verbose=False)

    def step(self, state, batch):
        return ttr.lm_loss(state.model(batch), batch) + tmoe.total_aux_loss(state.model)

    def val_epoch(self):
        pass


def _run(tree, **kw):
    pipe = tdml.TrainingPipeline({"seed": 0}, name="moe-compile", device="cpu", **kw)
    stage = MoEStage(tree)
    pipe.append_stage(stage, max_epochs=1)
    pipe.run()
    return pipe, stage


def test_the_moe_step_compiles_in_one_graph_and_matches_eager(single_runtime):
    tree = _tree()
    _, eager = _run(tree)
    pipe, compiled = _run(tree, precompile=True)
    assert compiled._train_compiled is not None and compiled._train_compiled.signatures == 1
    assert pipe.tracker["misc/recompiles"] == [0]
    np.testing.assert_allclose([float(x) for x in compiled.train_losses], [float(x) for x in eager.train_losses],
                               rtol=REL)
    want = dict(eager.state.model.named_parameters())
    for name, p in compiled.state.model.named_parameters():
        assert float((p - want[name]).norm() / want[name].norm()) <= REL, name
