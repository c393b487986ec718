"""The port stands alone: it imports no JAX and nothing of the JAX package.

A subprocess blocks ``jax``, ``jaxlib``, ``flax``, ``optax``, ``orbax`` and
``dmlcloud_tpu`` before anything else is imported, imports every module of
``dmlcloud_tpu_torch``, trains the tiny model for an epoch on ``device="cpu"``
(and once more with the flight recorder, two microbatches and the host reader),
trains the MNIST example for an epoch, calls the object collectives and the
data-parallel helpers at world size 1, trains the pod example's toy model
on a one-rank ``fsdp`` mesh (FSDP2 over gloo), trains the tiny model with
ring attention on a one-rank ``seq`` mesh, runs ``pipeline_apply`` over a
one-rank ``pipe`` group and restores a save without a template
(``restore_state(mesh=)``), decodes (``train_lm --sample``, ``generate``,
``beam_search``, ``examples.generate_text``) and serves requests through
``ServeEngine``, and checks that none of those
modules was loaded — and that, on a machine
without CUDA, entry points called without a device raise instead of running
on the CPU.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = textwrap.dedent(
    """
    import json, pkgutil, importlib, sys
    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "dmlcloud_tpu")
    for name in BLOCKED:
        sys.modules[name] = None  # any import of these now raises ImportError

    import torch
    torch.set_num_threads(2)
    import dmlcloud_tpu_torch
    modules = [m.name for m in pkgutil.walk_packages(dmlcloud_tpu_torch.__path__, "dmlcloud_tpu_torch.")]
    for name in modules:
        importlib.import_module(name)

    from dmlcloud_tpu_torch.examples.train_lm import main
    from dmlcloud_tpu_torch.models import DecoderLM, TransformerConfig
    stage = main(["--device", "cpu", "--epochs", "1", "--n-seqs", "40", "--seq-len", "32", "--attn", "flash"])
    loss = float(stage.tracker["train/loss"][-1])
    # the flight recorder, accumulation and the host reader, through the API
    import tempfile
    from dmlcloud_tpu_torch.examples.train_lm import build
    pipe, accum = build(["--device", "cpu", "--epochs", "1", "--n-seqs", "40", "--seq-len", "32", "--mfu"],
                        telemetry=tempfile.mkdtemp() + "/telemetry")
    accum.gradient_accumulation = lambda: 2
    accum.host_prefetch = lambda: 2
    pipe.run()
    goodput = float(accum.tracker["misc/goodput"][-1])
    # the MNIST example, and the object collectives and data-parallel helpers at world size 1
    from dmlcloud_tpu_torch.examples import mnist
    mnist_acc = float(mnist.main(["--device", "cpu", "--epochs", "1", "--batch-size", "512"]).tracker["val/accuracy"][-1])
    from dmlcloud_tpu_torch.parallel import data_parallel, runtime
    lin = torch.nn.Linear(2, 2)
    lin(torch.ones(1, 2)).sum().backward()
    grad = lin.weight.grad.clone()
    data_parallel.broadcast_parameters(lin)
    data_parallel.all_reduce_gradients(lin.parameters())
    collectives = [runtime.broadcast_object(1, root=0, tag="t"), runtime.all_gather_object(2), runtime.gather_object(3),
                   bool(torch.equal(grad, lin.weight.grad))]
    # the mesh path: the pod example's toy model on a one-rank fsdp mesh
    from dmlcloud_tpu_torch.examples import pod_llama_fsdp
    pod = pod_llama_fsdp.main(["--toy", "--device", "cpu", "--steps-per-epoch", "2", "--chunked-loss", "100"])
    pod_loss = float(pod.tracker["train/loss"][-1])
    pod_fsdp = pod.pipeline.models["llama"].plan.fsdp
    runtime.deinitialize()
    # the slice-8 paths: ring attention on a seq mesh, GPipe on a pipe group, an elastic restore
    ring = main(["--device", "cpu", "--epochs", "1", "--n-seqs", "40", "--seq-len", "32", "--attn", "ring",
                 "--mesh", "seq=1"])
    ring_loss = float(ring.tracker["train/loss"][-1])
    runtime.deinitialize()
    from dmlcloud_tpu_torch.checkpoint import CheckpointDir
    from dmlcloud_tpu_torch.parallel import mesh as mesh_lib, pipeline_apply, stack_pytrees
    runtime.init_single()
    mesh = mesh_lib.create_mesh({"pipe": 1}, device="cpu")
    stacked = stack_pytrees([{"w": torch.eye(4)}])
    piped = pipeline_apply(lambda p, x: x @ p["w"], stacked, torch.ones(2, 3, 4), mesh)
    ckpt = CheckpointDir(tempfile.mkdtemp() + "/run")
    ckpt.create()
    ckpt.state_manager("s", async_save=False)
    ckpt.save_state(1, {"w": torch.arange(6.0).reshape(2, 3)}, scope="s")
    restored = ckpt.restore_state(scope="s", mesh=mesh)["w"].full_tensor()
    slice8 = [ring_loss, bool(torch.equal(piped, torch.ones(2, 3, 4))),
              bool(torch.equal(restored, torch.arange(6.0).reshape(2, 3)))]
    runtime.deinitialize()
    # the slice-9 paths: decode after training, generate/beam search, the serving engine
    sampled = main(["--device", "cpu", "--epochs", "1", "--n-seqs", "40", "--seq-len", "32", "--sample", "4"])
    runtime.deinitialize()
    from dmlcloud_tpu_torch.examples import generate_text
    from dmlcloud_tpu_torch.models.generate import generate
    from dmlcloud_tpu_torch.serve import ServeEngine
    beams, _ = generate_text.main(["--device", "cpu", "--max-new", "4", "--beams", "2"])
    greedy = generate_text.main(["--device", "cpu", "--max-new", "4", "--batch", "1"])
    import argparse
    import numpy as np
    tiny = generate_text.build_model(argparse.Namespace(prompt_len=12, max_new=4, seed=0, device="cpu"))
    engine = ServeEngine(tiny, block_size=4, max_slots=2, prefill_chunk=8)
    prompt = np.random.RandomState(0).randint(0, 256, 12)
    rid = engine.submit(prompt, 4)
    served = engine.run()[rid].tolist()
    slice9 = [list(sampled.sample_output.shape), list(beams.shape),
              served == generate(tiny, prompt[None], 4)[0].tolist(), engine.leaked_blocks()]

    loaded = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and m.split(".")[0] in BLOCKED)
    raised = {}
    if not torch.cuda.is_available():
        cfg = TransformerConfig(vocab_size=64, num_layers=1, num_heads=2, head_dim=8, hidden_dim=16, mlp_dim=32)
        for name, call in [("DecoderLM", lambda: DecoderLM(cfg)),
                           ("TrainingPipeline", lambda: dmlcloud_tpu_torch.TrainingPipeline()),
                           ("train_lm.main", lambda: main(["--epochs", "1"])),
                           ("mnist.main", lambda: mnist.main(["--epochs", "1"])),
                           ("generate_text.main", lambda: generate_text.main([]))]:
            try:
                call()
                raised[name] = False
            except RuntimeError:
                raised[name] = True
    print(json.dumps({"modules": modules, "loaded": loaded, "loss": loss, "goodput": goodput, "raised": raised,
                      "mnist_acc": mnist_acc, "collectives": collectives, "pod": [pod_loss, pod_fsdp],
                      "slice8": slice8, "slice9": slice9}))
    """
)


def test_port_imports_no_jax_and_needs_an_explicit_cpu_request():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert "dmlcloud_tpu_torch.ops.flash_attention" in result["modules"]
    for name in ("stage", "checkpoint", "parallel.runtime", "utils.slurm", "utils.tcp", "utils.serialization",
                 "utils.git", "utils.project", "telemetry", "telemetry.journal", "telemetry.goodput",
                 "telemetry.watchdog", "data.device", "data.datasets", "utils.profiling", "utils.tensorboard",
                 "utils.wandb", "utils.argparse_ext", "data.sharding", "models.cnn", "examples.mnist",
                 "parallel.data_parallel", "parallel.mesh", "parallel.tensor_parallel", "examples.pod_llama_fsdp",
                 "ops.ring_attention", "parallel.pipeline_parallel", "ops.paged_attention", "models.generate",
                 "serve", "serve.kv_pool", "serve.scheduler", "serve.engine", "examples.generate_text"):
        assert f"dmlcloud_tpu_torch.{name}" in result["modules"], name
    assert result["loss"] == result["loss"] and result["loss"] > 0  # finite, trained
    assert 0 < result["goodput"] <= 1
    assert result["mnist_acc"] > 0.3  # 8 steps at batch 512: well above the 0.1 of chance
    assert result["collectives"] == [1, [2], [3], True]
    assert result["pod"][0] > 0 and result["pod"][1], "the pod toy did not train through FSDP2"
    ring_loss, piped, restored = result["slice8"]
    assert ring_loss > 0 and piped and restored, result["slice8"]
    assert result["slice9"] == [[2, 4], [2, 4], True, 0], result["slice9"]
    for name, did_raise in result["raised"].items():
        assert did_raise, f"{name} without a device ran on the CPU instead of raising"
