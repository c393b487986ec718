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
Medusa modes, each under the chaos monkey and drained to a verdict, routes
requests through the ``Router`` across a kill and a drain under replica chaos,
round-trips a HF-named state dict and finetunes it with LoRA (no
``transformers``), and checks
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

import pytest

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

    # the slice-16 paths: the package-level names, the Router over engines (a kill, a drain) under replica chaos,
    # and the HF import and finetune from a HF-named state dict, with no transformers
    from types import SimpleNamespace
    from dmlcloud_tpu_torch.parallel import parse_mesh_axes, root_first
    from dmlcloud_tpu_torch.serve import Router
    from dmlcloud_tpu_torch.models import hf
    from dmlcloud_tpu_torch.examples import finetune_hf
    router = Router([ServeEngine(tiny, block_size=4, max_slots=1, prefill_chunk=8) for _ in range(3)],
                    backoff_base_s=0.0, run_dir=tempfile.mkdtemp())
    rmonkey = ChaosMonkey(seed=0, p_replica_stall=0.2).attach_router(router)
    rrids = [router.submit(prompt[:6], 4, tenant=str(i % 2)) for i in range(4)]
    router.step()
    router.kill_replica("r2", "check")
    router.drain_replica("r1")
    router.run(max_steps=500)
    rmonkey.detach_router()
    hf_cfg = SimpleNamespace(vocab_size=64, num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
                             hidden_size=16, intermediate_size=32, max_position_embeddings=64, head_dim=8)
    rs = np.random.RandomState(0)
    shapes = {"model.embed_tokens.weight": (64, 16), "model.norm.weight": (16,), "lm_head.weight": (64, 16),
              "model.layers.0.input_layernorm.weight": (16,), "model.layers.0.post_attention_layernorm.weight": (16,),
              "model.layers.0.self_attn.q_proj.weight": (16, 16), "model.layers.0.self_attn.k_proj.weight": (8, 16),
              "model.layers.0.self_attn.v_proj.weight": (8, 16), "model.layers.0.self_attn.o_proj.weight": (16, 16),
              "model.layers.0.mlp.gate_proj.weight": (32, 16), "model.layers.0.mlp.up_proj.weight": (32, 16),
              "model.layers.0.mlp.down_proj.weight": (16, 32)}
    sd = {k: (0.1 * rs.standard_normal(v)).astype(np.float32) for k, v in shapes.items()}
    hcfg = hf.transformer_config_from_hf(hf_cfg)
    hmodel = DecoderLM(hcfg, device="cpu")
    from dmlcloud_tpu_torch.models.transformer import load_flax_params, to_flax_params
    back = hf.hf_state_dict_from_params(to_flax_params(load_flax_params(hmodel, hf.llama_params_from_hf(sd, hcfg))),
                                        hcfg)
    ft = finetune_hf.main(["--device", "cpu", "--epochs", "1", "--n-docs", "24", "--seq-len", "32", "--batch-size",
                           "2", "--sample", "3", "--lora", "2"], hf_config=hf_cfg, state_dict=sd)
    with root_first():
        slice16 = [router.statuses() == {r: "ok" for r in rrids}, router.kills, router.leaked_blocks(),
                   router.replicas["r1"].removed, all(np.array_equal(back[k], sd[k]) for k in sd),
                   list(ft.sample_output.shape), parse_mesh_axes("fsdp=1"), "transformers" in sys.modules]
    runtime.deinitialize()

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
                           ("pod_clip_vit.main", lambda: pod_clip_vit.main(["--toy"])),
                           ("finetune_hf.main", lambda: finetune_hf.main(["--epochs", "1"], hf_config=hf_cfg,
                                                                         state_dict=sd))]:
            try:
                call()
                raised[name] = False
            except RuntimeError:
                raised[name] = True
    print(json.dumps({"modules": modules, "loaded": loaded, "loss": loss, "goodput": goodput, "raised": raised,
                      "mnist_acc": mnist_acc, "collectives": collectives, "pod": [pod_loss, pod_fsdp],
                      "slice8": slice8, "slice9": slice9, "slice10": slice10,
                      "slice11": slice11, "slice12": slice12, "slice13": slice13, "slice14": slice14,
                      "slice15": slice15, "slice16": slice16}))
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
                 "serve.slo", "serve.metrics_http", "serve.chaos", "serve.router", "models.hf",
                 "examples.finetune_hf"):
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
    # the Router through a kill and a drain, an exact HF round trip, a LoRA finetune of an imported model
    assert result["slice16"] == [True, 1, 0, True, True, [2, 3], {"fsdp": 1}, False], result["slice16"]
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


#: the reference packages whose ``__all__`` the port mirrors, by suffix of ``dmlcloud_tpu``
REF_PACKAGES = ["", ".parallel", ".serve", ".utils", ".data", ".telemetry", ".compile", ".lint"]

_LINT_ITEM = "ROADMAP Queue 1 item 13 (the linter)"
#: names of a reference ``__all__`` that the port does not bind, each with its reason (ROADMAP "By design")
NOT_BOUND = {
    ".parallel": {
        "batch_sharding": "By design: a NamedSharding; a DTensor's placements carry the layout",
        "replicated": "By design: a NamedSharding; unsharded tensors are plain tensors",
        "shard_pytree": "By design: jax.device_put of a tree; parallel.mesh.shard_module lays out a module",
    },
    ".utils": {"thirdparty": "By design: the probe is utils/logging.py ML_MODULES"},
    ".lint": {name: _LINT_ITEM for name in (
        "DEFAULT_CACHE_PATH", "FIXABLE_RULES", "Finding", "IR_RULES", "LintCache", "LintError", "PROJECT_RULES",
        "ProjectGraph", "RULES", "SANITIZE_MODES", "Sanitizer", "SanitizerError", "apply_fixes",
        "apply_suppressions", "build_project_context", "lint_file", "lint_paths", "lint_source", "summarize_module")},
}


def _reference_all(pkg: str) -> list[str]:
    """The reference package's ``__all__``, read with ``ast`` (nothing of it is imported)."""
    import ast

    path = REPO / ("dmlcloud_tpu" + pkg.replace(".", "/")) / "__init__.py"
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    raise AssertionError(f"{path} has no __all__")


@pytest.mark.parametrize("pkg", REF_PACKAGES, ids=lambda p: "dmlcloud_tpu" + p)
def test_port_binds_every_name_the_reference_exports(pkg):
    import importlib

    port = importlib.import_module("dmlcloud_tpu_torch" + pkg)
    exceptions = NOT_BOUND.get(pkg, {})
    names = _reference_all(pkg)
    missing = [n for n in names if n not in exceptions and not (hasattr(port, n) and n in port.__all__)]
    assert missing == [], f"dmlcloud_tpu_torch{pkg} does not bind {missing}"
    # every exception is still true, and names a name the reference exports
    assert set(exceptions) <= set(names)
    assert [n for n in exceptions if hasattr(port, n)] == []


def test_the_reference_examples_imports_resolve():
    from dmlcloud_tpu_torch.parallel import parse_mesh_axes, root_first, runtime

    assert parse_mesh_axes("data=2,fsdp=4") == {"data": 2, "fsdp": 4}
    with root_first():
        pass
    assert runtime.device_count() == runtime.world_size() and runtime.local_device_count() == runtime.local_world_size()


def test_make_global_batch_keeps_this_coordinates_rows():
    import types

    import numpy as np
    import torch

    from dmlcloud_tpu_torch.parallel import batch_pspec, make_global_batch
    from dmlcloud_tpu_torch.parallel import mesh as mesh_lib
    from dmlcloud_tpu_torch.parallel.mesh import P

    batch = {"x": np.arange(16).reshape(8, 2), "y": [torch.arange(8)]}
    seen = []
    for d in range(2):
        for f in range(2):
            for m in range(2):  # tensor-parallel peers feed the same rows
                mesh = types.SimpleNamespace(mesh_dim_names=("data", "fsdp", "model"), shape=(2, 2, 2),
                                             get_coordinate=lambda c=(d, f, m): list(c))
                assert batch_pspec(mesh) == P(("data", "fsdp"))
                mine = make_global_batch(batch, mesh)
                rows = (2 * d + f) * 2
                np.testing.assert_array_equal(mine["x"], batch["x"][rows:rows + 2])
                assert mine["y"][0].tolist() == list(range(rows, rows + 2))
                seen.append(rows)
                # over the data axis alone: half the batch
                half = make_global_batch(batch, mesh, P("data"))["x"]
                np.testing.assert_array_equal(half, batch["x"][4 * d:4 * d + 4])
    assert sorted(set(seen)) == [0, 2, 4, 6]
    assert mesh_lib.batch_pspec({"model": 2}) == P(None)
    with pytest.raises(ValueError, match="does not split"):
        make_global_batch(np.zeros((3, 1)), types.SimpleNamespace(mesh_dim_names=("data",), shape=(2,),
                                                                    get_coordinate=lambda: [0]))
