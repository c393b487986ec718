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
``ServeEngine``, trains the CLIP recipe's toy, runs ResNet-18, a BERT with the
flash path and a ViT, decodes an int8 model and speculatively, wraps a model
in LoRA adapters, trains at ``precision="int8"``, serves through the engine's
prefix cache with adapters, metrics and an SLO, and in its speculative and
Medusa modes, each under the chaos monkey and drained to a verdict, and checks
that none of those modules was loaded — and that, on a machine
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
    import json, os, pkgutil, importlib, sys
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

    # the slice-10 paths: the vision and encoder families and the CLIP recipe
    from dmlcloud_tpu_torch.examples import pod_clip_vit
    from dmlcloud_tpu_torch.models import BertConfig, BertForMaskedLM, ResNet18, ViT, ViTConfig, mlm_loss
    clip = pod_clip_vit.main(["--toy", "--device", "cpu", "--epochs", "1", "--steps-per-epoch", "2"])
    resnet = ResNet18(num_classes=3, device="cpu")
    logits = resnet(torch.rand(2, 16, 16, 3))
    bert = BertForMaskedLM(BertConfig(vocab_size=32, max_seq_len=8, hidden_dim=16, num_layers=1, num_heads=2,
                                      mlp_dim=32, attn_impl="flash"), device="cpu")
    mlm = mlm_loss(bert(torch.zeros(1, 8, dtype=torch.long)), torch.zeros(1, 8, dtype=torch.long))
    vit = ViT(ViTConfig(image_size=16, patch_size=8, hidden_dim=16, num_layers=1, num_heads=2, mlp_dim=32,
                        num_classes=0), device="cpu")(torch.rand(1, 16, 16, 3))
    slice10 = [float(clip.tracker["train/loss"][-1]) > 0, list(logits.shape), float(mlm) > 0, list(vit.shape),
               len(resnet.state_dict())]
    runtime.deinitialize()

    # the slice-11 paths: a .dmlshard corpus through the native packer into train_lm, on a memory:// run dir
    import numpy as np
    from dmlcloud_tpu_torch.data import ShardReader, build_corpus
    from dmlcloud_tpu_torch.native import _lib
    docs = [np.arange(1, 2 + k % 40, dtype=np.int32) for k in range(120)]
    corpus = tempfile.mkdtemp()
    build_corpus(corpus, docs, shard_tokens=500)
    _lib.reset_calls()
    lm = main(["--device", "cpu", "--epochs", "1", "--n-seqs", "16", "--seq-len", "32", "--batch-size", "4",
               "--corpus", corpus, "--checkpoint-dir", "memory://import-check", "--save-every-steps", "2"])
    slice11 = [sum(len(d) for d in ShardReader(corpus)), _lib.CALLS["pack"] > 0,
               str(lm.pipeline.checkpoint_dir.path).startswith("memory://import-check/"),
               lm.pipeline.checkpoint_dir.latest_step("LMStage.steps")]
    runtime.deinitialize()

    # the slice-12 paths: the compiled step (Dynamo's aot_eager backend here), the metrics registry, the profiler
    from dmlcloud_tpu_torch.compile import aot, cache_stats
    from dmlcloud_tpu_torch.telemetry import MetricsRegistry, to_prometheus_text
    from dmlcloud_tpu_torch.utils.profiling import profile_steps
    aot.BACKEND = "aot_eager"
    cpipe, cstage = build(["--device", "cpu", "--epochs", "1", "--n-seqs", "40", "--seq-len", "32", "--attn", "flash"],
                          precompile=True, compile_cache=tempfile.mkdtemp())
    cpipe.run()
    registry = MetricsRegistry()
    registry.counter("steps_total").inc(3)
    slice12 = [cstage._train_compiled.signatures, [int(x) for x in cpipe.tracker["misc/recompiles"]],
               cache_stats()["enabled"], to_prometheus_text(registry.snapshot()),
               float(profile_steps(lambda: torch.ones(2).sum(), 2, tempfile.mkdtemp()))]
    runtime.deinitialize()

    # the slice-13 paths: int8 decode and training, LoRA, speculative decoding
    from dmlcloud_tpu_torch.models import lora, quant, speculative
    int8 = generate(quant.quantize_tree(tiny), prompt[None], 4)
    spec = speculative.speculative_generate(tiny, tiny, prompt[None, :6], 4, k=2)
    base = generate_text.build_model(argparse.Namespace(prompt_len=12, max_new=4, seed=0, device="cpu"))
    adapted = lora.LoraModel(base, lora.lora_init(torch.Generator().manual_seed(0), base, rank=2))
    qpipe, qstage = build(["--device", "cpu", "--epochs", "1", "--n-seqs", "40", "--seq-len", "32"])
    qstage.precision = lambda: "int8"
    qpipe.run()
    slice13 = [list(int8.shape), spec.tolist() == generate(tiny, prompt[None, :6], 4).tolist(),
               lora.lora_size(adapted.adapters()) > 0 and not list(adapted.base.parameters()),
               float(qstage.tracker["train/loss"][-1]) > 0]
    runtime.deinitialize()

    # the slice-14 paths: an MoE DecoderLM, its aux loss, its decode, int8 of it
    from dmlcloud_tpu_torch.models.moe import total_aux_loss
    moe = DecoderLM(TransformerConfig(vocab_size=64, num_layers=2, num_heads=2, head_dim=8, hidden_dim=16, mlp_dim=32,
                                      max_seq_len=32, num_experts=4, dtype=torch.float32), device="cpu")
    moe_tokens = torch.randint(0, 64, (2, 12), generator=torch.Generator().manual_seed(0))
    moe_logits = moe(moe_tokens)
    slice14 = [list(moe_logits.shape), float(total_aux_loss(moe)) > 0, hasattr(moe.layers[1], "moe"),
               list(generate(quant.quantize_tree(moe), moe_tokens[:, :6], 3).shape)]

    # the slice-15 paths: the engine's prefix cache with adapters, metrics and an SLO, speculative and Medusa
    # rounds, each under the chaos monkey, then a drain writing its verdict
    from dmlcloud_tpu_torch.serve import SLO, AdapterSet, ChaosMonkey
    from dmlcloud_tpu_torch.telemetry.journal import linked_trace_report
    adapters = AdapterSet({"t": lora.lora_init(torch.Generator().manual_seed(1), tiny, rank=2, in_axes=1)}, base=tiny)
    want = generate(tiny, prompt[None, :6], 4)[0].tolist()
    slice15 = []
    for kw in (dict(prefix_cache=True, adapters=adapters, metrics=True, slos=[SLO("s", ttft_p99_s=10.0)]),
               dict(spec_k=2), dict(medusa_k=2)):
        run_dir = tempfile.mkdtemp()
        eng = ServeEngine(tiny, block_size=4, max_slots=1, prefill_chunk=8, run_dir=run_dir, **kw)
        monkey = ChaosMonkey(seed=0, p_exhaust=0.5, exhaust_blocks=2, exhaust_steps=1).attach(eng)
        rids = [eng.submit(prompt[:6], 4, adapter="t" if "adapters" in kw else None), eng.submit(prompt[:6], 4)]
        out = eng.run()
        monkey.detach()
        verdict = eng.drain()
        slice15.append([out[r].tolist() == want for r in rids] + [eng.leaked_blocks(), verdict["kind"],
                                                                  os.path.exists(run_dir + "/requeue.json")])
    slice15.append([eng.metrics_text() == "", linked_trace_report([])["orphans"]])

    loaded = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and m.split(".")[0] in BLOCKED)
    raised = {}
    if not torch.cuda.is_available():
        cfg = TransformerConfig(vocab_size=64, num_layers=1, num_heads=2, head_dim=8, hidden_dim=16, mlp_dim=32)
        for name, call in [("DecoderLM", lambda: DecoderLM(cfg)),
                           ("TrainingPipeline", lambda: dmlcloud_tpu_torch.TrainingPipeline()),
                           ("train_lm.main", lambda: main(["--epochs", "1"])),
                           ("mnist.main", lambda: mnist.main(["--epochs", "1"])),
                           ("generate_text.main", lambda: generate_text.main([])),
                           ("ResNet18", lambda: ResNet18()),
                           ("pod_clip_vit.main", lambda: pod_clip_vit.main(["--toy"]))]:
            try:
                call()
                raised[name] = False
            except RuntimeError:
                raised[name] = True
    print(json.dumps({"modules": modules, "loaded": loaded, "loss": loss, "goodput": goodput, "raised": raised,
                      "mnist_acc": mnist_acc, "collectives": collectives, "pod": [pod_loss, pod_fsdp],
                      "slice8": slice8, "slice9": slice9, "slice10": slice10,
                      "slice11": slice11, "slice12": slice12, "slice13": slice13, "slice14": slice14,
                      "slice15": slice15}))
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
                 "serve", "serve.kv_pool", "serve.scheduler", "serve.engine", "examples.generate_text",
                 "models.bridge", "models.resnet", "models.encoder", "models.bert", "models.vit", "models.clip",
                 "examples.pod_clip_vit", "utils.paths", "data.store", "native", "native._lib", "native.pack",
                 "native.interleave", "compile", "compile.aot", "compile.buckets", "compile.cache", "lint",
                 "lint.traceguard", "telemetry.metrics_registry", "models.quant", "models.lora",
                 "models.speculative", "models.moe", "serve.prefix_cache", "serve.adapters", "serve.ledger",
                 "serve.slo", "serve.metrics_http", "serve.chaos"):
        assert f"dmlcloud_tpu_torch.{name}" in result["modules"], name
    assert result["loss"] == result["loss"] and result["loss"] > 0  # finite, trained
    assert 0 < result["goodput"] <= 1
    assert result["mnist_acc"] > 0.3  # 8 steps at batch 512: well above the 0.1 of chance
    assert result["collectives"] == [1, [2], [3], True]
    assert result["pod"][0] > 0 and result["pod"][1], "the pod toy did not train through FSDP2"
    ring_loss, piped, restored = result["slice8"]
    assert ring_loss > 0 and piped and restored, result["slice8"]
    assert result["slice9"] == [[2, 4], [2, 4], True, 0], result["slice9"]
    # 62 parameters and 40 running statistics: the buffers ride the checkpoints
    assert result["slice10"] == [True, [2, 3], True, [1, 16], 102], result["slice10"]
    # every token of the corpus read back, packed natively, saved to the URL (4 steps of 4 rows)
    assert result["slice11"] == [sum(1 + k % 40 for k in range(120)), True, True, 4], result["slice11"]
    # one precompiled signature, no mid-run compile; the cache configured; the registry's page; the last result
    assert result["slice12"] == [1, [0], True, "# TYPE steps_total counter\nsteps_total 3\n", 2.0], result["slice12"]
    # int8 tokens, speculative == plain greedy, adapters over a frozen base, an int8 training run
    assert result["slice13"] == [[1, 4], True, True, True], result["slice13"]
    # a finite forward, a positive aux loss, the second block MoE, int8 decode (the router quantized)
    assert result["slice14"] == [[2, 12, 64], True, True, [2, 3]], result["slice14"]
    # prefix cache + adapters + metrics + SLO, speculative, Medusa: greedy tokens under the monkey, no leak, a verdict
    assert result["slice15"] == [[True, True, 0, "completed", True]] * 3 + [[True, []]], result["slice15"]
    for name, did_raise in result["raised"].items():
        assert did_raise, f"{name} without a device ran on the CPU instead of raising"


def test_version_and_stage_mesh_are_the_references():
    """``__version__`` is the reference package's, and ``Stage.mesh`` reads
    the pipeline's mesh (reference stage.py:109-111), as stage code written
    against the reference expects."""
    import dmlcloud_tpu
    import dmlcloud_tpu_torch as dml

    assert dml.__version__ == dmlcloud_tpu.__version__ and "__version__" in dml.__all__
    pipeline = dml.TrainingPipeline(device="cpu")
    stage = dml.TrainValStage()
    pipeline.append_stage(stage)
    assert stage.mesh is None
    pipeline.mesh = mesh = object()
    assert stage.mesh is mesh
