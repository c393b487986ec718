"""Int8 on a mesh, over two gloo processes on the CPU, against one process
and the JAX package.

- ``quantize_tree`` of the tiny ``DecoderLM`` laid out on ``model=2`` and on
  ``fsdp=2`` (``llama_partition_rules()``): every ``q`` and ``scale`` of the
  dumped tree byte-identical to the reference's ``quantize_tree`` of the same
  params, the row-parallel ``o_proj``/``down_proj`` (input axis split over
  ``model``) and every ``fsdp`` split included, whose scales need the
  max-reduced amax;
- the reference's int8 tree loads into a ``model=2`` model and dumps back
  byte-identical, and that model decodes the greedy tokens of the int8 model
  on one process;
- ``TrainValStage(precision="int8")`` (tests/test_torch_fsdp.py's stage of
  the tiny model, AdamW, clipping and EMA) on ``fsdp=2``, ``model=2`` and
  ``seq=2`` (ring attention; one process runs it on ``seq=1``): the losses
  within ``REL`` of one process and the parameters and delayed amax after the
  steps within ``REL`` (norm-relative);
- on ``fsdp=2``, an int8 run of the LM example preempted after a step save and
  resumed equals the uninterrupted run bitwise: parameters, the amax buffers,
  the losses.
"""

import os
import pickle
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlcloud_tpu.models import quant as jq
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu.parallel import mesh as jmesh
from dmlcloud_tpu_torch.examples import train_lm
from dmlcloud_tpu_torch.models import generate as tgen
from dmlcloud_tpu_torch.models import quant as tq
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.parallel import runtime
from dmlcloud_tpu_torch.utils import tcp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
#: meshes against one process, fp32: PERF.md's gate
REL = 1e-5
TINY = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8, hidden_dim=32, mlp_dim=64,
            max_seq_len=32)
RESUME_ARGV = ["--device", "cpu", "--preset", "tiny", "--vocab-size", "128", "--seq-len", "32", "--batch-size", "4",
               "--n-seqs", "28", "--lr", "0.01", "--epochs", "1"]
#: mesh -> (its axes, the attention, the one-process mesh it is held against)
TRAIN_MESHES = {"fsdp=2": ({"fsdp": 2}, "dot", None), "model=2": ({"model": 2}, "dot", None),
                "seq=2": ({"seq": 2}, "ring", {"seq": 1})}


def train_int8(axes, attn) -> dict:
    """tests/test_torch_fsdp.py's stage at ``precision="int8"``: its losses,
    parameters and delayed amax buffers (gathered to full tensors)."""
    import test_torch_fsdp as fsdp
    from torch.distributed.tensor import DTensor

    class Int8LM(fsdp.LM):
        def precision(self):
            return "int8"

        def post_stage(self):
            full = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()
            self.amax = {n: full(b) for n, b in self.state.model.named_buffers() if n.endswith(tq.QUANT_AMAX_KEY)}

    pipe = fsdp.tdml.TrainingPipeline({"seed": 0}, name="int8", device="cpu")
    if axes:
        pipe.set_mesh(axes)
    stage = Int8LM(fsdp.flax_init(), attn=attn)
    pipe.append_stage(stage, max_epochs=1)
    pipe.run()
    per_rank = runtime.all_gather_object(stage.losses)
    return {"losses": [float(np.mean(s)) for s in zip(*per_rank)], "step": stage.state.step,
            "params": ttr.to_flax_params(stage.state.model), "amax": stage.amax}


def jax_params():
    jmodel = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **TINY))
    return jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


def port_model(tree) -> ttr.DecoderLM:
    return ttr.load_flax_params(ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **TINY), device="cpu"), tree)


def quant_leaves(tree: dict, prefix: str = "") -> dict:
    """{path: (q, scale)} of every quantized leaf of a flax tree (either
    package's form)."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict) and set(value) == {"q", "scale"}:
            out[path] = (np.asarray(value["q"]), np.asarray(value["scale"]))
        elif isinstance(value, jq.QuantizedTensor):
            out[path] = (np.asarray(value.q), np.asarray(value.scale))
        elif isinstance(value, dict):
            out.update(quant_leaves(value, path))
    return out


def int8_tokens(model) -> np.ndarray:
    prompt = np.random.RandomState(0).randint(1, 64, (2, 6)).astype(np.int32)
    return tgen.generate(model, prompt, 8).numpy()


class _SignalAfter:
    def __init__(self, ds, k: int):
        self.ds, self.k = ds, k

    def __iter__(self):
        for i, batch in enumerate(self.ds):
            yield batch
            if i + 1 == self.k:
                os.kill(os.getpid(), signal.SIGUSR1)

    def __len__(self):
        return len(self.ds)


def run_int8(argv, resume=False, signal_after=None):
    """The LM example at ``precision="int8"``: its losses, and its parameters
    and amax buffers gathered to full tensors."""
    pipeline, stage = train_lm.build(argv, resume=resume)
    stage.precision = lambda: "int8"
    if signal_after is not None:
        datasets = stage.train_dataset
        stage.train_dataset = lambda: _SignalAfter(datasets(), signal_after)
        pipeline.enable_preemption_handling(("SIGUSR1",))
    pipeline.run()
    from torch.distributed.tensor import DTensor

    full = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()
    model = stage.state.model
    losses = [float(x) for x in stage.train_losses]
    if runtime.world_size() > 1:  # each data-parallel rank's loss is its rows': the mean is the global batch's
        losses = [float(np.mean(s)) for s in zip(*runtime.all_gather_object(losses))]
    return {"losses": losses, "step": stage.state.step,
            "params": {n: full(p) for n, p in model.named_parameters()},
            "amax": {n: full(b) for n, b in model.named_buffers() if n.endswith(tq.QUANT_AMAX_KEY)}}


_WORKER = textwrap.dedent(
    """
    import os, pickle, sys
    import torch
    sys.path.insert(0, os.environ["TEST_DIR"])
    from dmlcloud_tpu_torch.models import quant as tq, transformer as ttr
    from dmlcloud_tpu_torch.parallel import mesh as tmesh, runtime
    from test_torch_quant_mesh import RESUME_ARGV, TRAIN_MESHES, int8_tokens, port_model, run_int8, train_int8

    torch.set_num_threads(1)
    assert runtime.init_auto(device="cpu") == "gloo"
    out_dir = os.environ["OUT_DIR"]
    data = pickle.loads(open(os.path.join(out_dir, "inputs.pkl"), "rb").read())
    out = {}
    for axes in ({"model": 2}, {"fsdp": 2}):
        model = port_model(data["tree"])
        tmesh.shard_module(model, tmesh.create_mesh(axes, device="cpu"), ttr.llama_partition_rules())
        out[f"quantized {axes}"] = ttr.to_flax_params(tq.quantize_tree(model))
    model = port_model(data["tree"])
    tmesh.shard_module(model, tmesh.create_mesh({"model": 2}, device="cpu"), ttr.llama_partition_rules())
    ttr.load_flax_params(model, data["int8 tree"])
    out["loaded"] = ttr.to_flax_params(model)
    out["loaded tokens"] = int8_tokens(model)
    for name, (axes, attn, _) in TRAIN_MESHES.items():
        out[name] = train_int8(axes, attn)
    root = os.path.join(out_dir, "resume")
    argv = RESUME_ARGV + ["--mesh", "fsdp=2", "--checkpoint-dir", root, "--save-every-steps", "3"]
    out["control"] = run_int8(RESUME_ARGV + ["--mesh", "fsdp=2"])
    out["first"] = run_int8(argv, resume=True, signal_after=2)
    out["resumed"] = run_int8(argv, resume=True)
    if runtime.rank() == 0:
        with open(os.path.join(out_dir, "world2.pkl"), "wb") as f:
            pickle.dump(out, f)
    runtime.barrier("done", timeout=60)
    """
)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("quant_mesh")
    tree = jax_params()
    int8_tree = jax.tree_util.tree_map(lambda x: {"q": np.asarray(x.q), "scale": np.asarray(x.scale)}
                                       if isinstance(x, jq.QuantizedTensor) else x, jq.quantize_tree(tree),
                                       is_leaf=lambda x: isinstance(x, jq.QuantizedTensor))
    (out_dir / "inputs.pkl").write_bytes(pickle.dumps({"tree": tree, "int8 tree": int8_tree}))
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
        one = {"int8 tokens": int8_tokens(tq.quantize_tree(port_model(tree)))}
        for name, (_, attn, axes) in TRAIN_MESHES.items():
            runtime.init_single()
            try:
                one[name] = train_int8(axes, attn)
            finally:
                runtime.deinitialize()
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            p.kill()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (out_dir / f"log{rank}.txt").read_text()[-4000:]
    out = pickle.loads((out_dir / "world2.pkl").read_bytes())
    out["one"], out["reference"] = one, quant_leaves(int8_tree)
    out["int8 tree"] = int8_tree
    return out


@pytest.mark.parametrize("axes", ["{'model': 2}", "{'fsdp': 2}"])
def test_quantize_tree_of_a_sharded_model_gives_the_references_bytes(results, axes):
    got = quant_leaves(results[f"quantized {axes}"])
    want = results["reference"]
    assert sorted(got) == sorted(want) and "layer_0/attn/o_proj/kernel" in want
    for path, (q, scale) in want.items():
        assert got[path][0].dtype == np.int8 and got[path][0].tobytes() == q.tobytes(), path
        assert got[path][1].tobytes() == scale.astype(np.float32).tobytes(), path


def test_a_reference_int8_tree_loads_into_model2_and_dumps_back_byte_identical(results):
    got = results["loaded"]
    want = results["int8 tree"]
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_got.keys() == flat_want.keys()
    for key, value in flat_want.items():
        assert np.asarray(flat_got[key]).tobytes() == np.asarray(value).tobytes(), jmesh.path_str(key)


def test_the_int8_model_on_model2_decodes_one_process_tokens(results):
    np.testing.assert_array_equal(results["loaded tokens"], results["one"]["int8 tokens"])


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("mesh", sorted(TRAIN_MESHES))
def test_int8_training_on_a_mesh_matches_one_process(results, mesh):
    got, one = results[mesh], results["one"][mesh]
    assert got["step"] == one["step"] >= 2
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=REL)
    flat_got = {jmesh.path_str(p): v for p, v in jax.tree_util.tree_leaves_with_path(got["params"])}
    flat_one = {jmesh.path_str(p): v for p, v in jax.tree_util.tree_leaves_with_path(one["params"])}
    assert flat_got.keys() == flat_one.keys()
    for name, p in flat_one.items():
        assert _rel(torch.from_numpy(flat_got[name]), torch.from_numpy(p)) <= REL, name
    assert got["amax"].keys() == one["amax"].keys() and len(one["amax"]) == 2 * 7 + 1
    for name, a in one["amax"].items():
        assert got["amax"][name].shape == a.shape and _rel(got["amax"][name], a) <= REL, name


def test_an_int8_run_on_fsdp2_resumes_bitwise(results):
    control, first, resumed = results["control"], results["first"], results["resumed"]
    assert first["step"] == 3 and resumed["step"] == control["step"] > 3
    for what in ("params", "amax"):
        assert resumed[what].keys() == control[what].keys()
        for name, t in control[what].items():
            assert torch.equal(resumed[what][name], t), (what, name)
    after = control["step"] - 3
    assert resumed["losses"][-after:] == control["losses"][-after:]
