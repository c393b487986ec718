"""The mesh axes of ``dmlcloud_tpu_torch`` across the cards of one host,
through NCCL, held against one card: FSDP2 and tensor parallelism, ring
attention on ``seq``, GPipe on ``pipe``, and an elastic resume onto fewer
cards.

Run the one-card reference first, then the N-card run, which compares, then
the elastic resumes of the N-card run's save on two cards and on one:

    python scripts/torch_mesh_cards.py --single --out one.json
    python -m torch.distributed.run --nproc_per_node=4 scripts/torch_mesh_cards.py --compare one.json \
        --elastic-out save.json
    python -m torch.distributed.run --nproc_per_node=2 scripts/torch_mesh_cards.py --resume save.json \
        --mesh fsdp=2
    python scripts/torch_mesh_cards.py --resume save.json

(build the kernels once before, or every process runs nvcc:
``python -c "from dmlcloud_tpu_torch.ops import flash_attention as fa; fa.build()"``).
``--parts`` picks the parts by name (default: all): ``8b``, ``meshes``,
``resume``, ``ring``, ``pipe``, ``elastic``, ``clip``, ``resnet``, ``moe``,
``tp_decode``, ``int8_mesh``, ``compiled``; ``--single``
runs only what the chosen parts compare with. The last ``--resume`` call
deletes the save.

The parts, on the N processes (one per card):

1. ``examples.train_lm`` with the 1b model at global batch 4 (7 steps and a
   validation batch) under ``--mesh fsdp=4``, ``data=2,fsdp=2`` and
   ``fsdp=2,model=2``, each against the one-card run at the same global batch:
   every step's loss (the mean over the data-parallel processes) within
   ``LOSS_ATOL``, and the final full parameters' norm-relative difference;
2. on ``data=2,fsdp=2``: a run that saves every 4 steps and stops after the
   step-4 save (its feed raises), resumed from its run directory, against
   part 1's uninterrupted run on that mesh: parameters, AdamW moments and
   count, and the losses of steps 5-7 bitwise equal;
3. (run first) ``examples.pod_llama_fsdp`` at the 8b model's full width and depth under
   ``--mesh fsdp=4 --global-batch 8 --seq-len 4096 --remat --chunked-loss
   8192`` for 6 steps: finite losses, the last below the first; per card the
   steady step (median of steps 2-6, each synchronised), tokens/s, the MFU
   at the steady step (6ND over its time at the bf16 peak; ``misc/mfu``, the
   pipeline's, covers the epoch), peak memory, and the device time of
   FSDP2's all-gathers and reduce-scatters in one profiled step.

4. ``ring``: ``examples.train_lm`` with the 1b model, ``--attn ring --mesh
   seq=4`` at T=8192 and B=1 (7 steps and a validation batch), then with
   ``--window 4096`` (3 of the 4 hops), each against one card's ``--attn
   flash`` run on the same batches: every step's loss within ``LOSS_ATOL``,
   the ``seq`` peers' parameters bitwise equal after every step (exact
   digests of their bits), and each rank's K1-K3 launches equal to its hops
   (rank r runs r + 1 hops per layer without a window, min(r, 2) + 1 with);
5. ``pipe``: ``pipeline_apply`` on ``pipe=4``, the 1b model's 24
   ``DecoderBlock``s as 4 stages of 6, 8 microbatches of one 2048-token row;
   the output and the gradients (parameters and input) against the same
   blocks run in sequence on one card, within ``PIPE_REL`` in norm; the time
   of a forward and backward against the one card's;
6. ``elastic``: the 1b model on ``fsdp=4`` saved at step 4 mid-epoch (the
   run stops after the save), and the uninterrupted ``fsdp=4`` run; the save
   restored here without a template (``restore_state(mesh=)``) gives the
   exact digests of every saved tensor; ``--resume`` then continues the save
   on ``fsdp=2`` (two processes) and on one card with no mesh: the restored
   parameters, AdamW moments and counters equal to the saved bits, the losses
   of steps 5-7 within ``LOSS_ATOL`` of the uninterrupted run's;
7. ``clip``: ``examples.pod_clip_vit`` at the vit-l preset on
   ``data=2,fsdp=2`` (FSDP2 over ``fsdp``, the contrastive loss gathered over
   all four processes) at ``CLIP_GLOBAL`` pairs per step, against one card at
   the same global batch: every step's loss within ``LOSS_ATOL``, the steady
   step, pairs/s per card, peak memory;
8. ``resnet``: ResNet-50 replicated (the reference's ``sharding="replicate"``)
   at global batch ``RESNET_GLOBAL``, its BatchNorm statistics summed over the
   processes, against one card on the whole batch: losses within
   ``LOSS_ATOL``, images/s per card;
9. ``moe``: 1b-moe (the 1b preset with 8 experts, top-2, capacity factor
   1.25, in every second block) through a ``TrainingPipeline`` whose step
   returns ``lm_loss + total_aux_loss``, ``MOE_STEPS`` AdamW steps of a global
   batch of 4 rows, on ``expert=4`` and ``data=2,expert=2``: at 8 layers each
   within ``LOSS_ATOL`` of one card and of each other (the global routing of
   the data-parallel ranks), at the full 24 layers the steady step, tokens/s
   and peak memory per card;
10. ``tp_decode``: the bf16 1b on ``data=2,model=2`` and ``model=4``: greedy
   ``generate`` (4 rows x 128 prompt tokens, 32 new) equal to one card's, a
   row parting only where one card's top-2 logit gap is below ``TIE_GAP``; ms
   per decode step; chip_smoke.py phase 13 (d)'s burst through
   ``ServeEngine`` (TTFT p50, decode tokens/s), beside one card's;
11. ``int8_mesh``: the 1b at ``precision="int8"`` on ``fsdp=4`` (phase 5's 7
   steps), every loss within ``LOSS_ATOL`` of one card's int8 run, the steady
   step and peak per card; then the int8 1b (``quantize_tree`` of the sharded
   model) decoding on ``data=2,model=2``, its greedy tokens held to one card's
   int8 tokens as in part 10;
12. ``compiled``: the compiled step on a mesh (``precompile=True``: each
   block a ``fullgraph`` region, FSDP2's hooks between them), each against
   the same run eager in this call: the 1b (part 1's argv) on ``fsdp=4`` and
   ``fsdp=2,model=2``, the 8b (part 3's argv, through
   ``pod_llama_fsdp.build(argv, precompile=True)``; part 3's run is its
   eager twin when both parts run) on ``fsdp=4``, and the 1b-moe (part 9's
   configuration at its check depth, 8 layers) on ``data=2,expert=2``: every loss within
   ``COMPILED_LOSS_ATOL`` of the eager run's, 0 graph breaks and
   ``misc/recompiles`` 0 on every rank; side by side the steady step, one
   profiled step's device busy time and idle share, peak memory per card and
   ``misc/compile_ms`` (cold: each run compiles into a fresh Inductor cache),
   and for the 8b the MFU at the steady step.

``--device cpu --preset tiny`` runs every part on the CPU over gloo (part 3
with the ``toy`` preset). Rank 0 prints the cards' names and power limits
and, as its last line, one JSON object with the numbers; any failed check
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlcloud_tpu_torch.examples import pod_clip_vit, pod_llama_fsdp, train_lm  # noqa: E402
from dmlcloud_tpu_torch.ops import flash_attention as fa  # noqa: E402
from dmlcloud_tpu_torch.parallel import runtime  # noqa: E402

#: per-step losses of a mesh against one card: bf16 attention and matmuls,
#: reductions in another order (and bf16 partial sums under tensor parallelism)
LOSS_ATOL = 1e-2
MESHES = ["fsdp=4", "data=2,fsdp=2", "fsdp=2,model=2"]
PARTS = ["8b", "meshes", "resume", "ring", "pipe", "elastic", "clip", "resnet", "moe", "tp_decode", "int8_mesh",
         "compiled"]
#: part 12: the compiled step on a mesh against the same run eager
#: (chip_smoke.py's COMPILED_LOSS_ATOL, PERF.md section 2's compiled bound)
COMPILED_MESHES = ["fsdp=4", "fsdp=2,model=2"]
COMPILED_MOE_MESH = "data=2,expert=2"
COMPILED_LOSS_ATOL = 2e-2
#: the ring's runs: the 1b model at T = 8192 on seq=4, without and with a window
RING_WINDOW = 4096
#: pipeline_apply against the sequential blocks: bf16 activations, the
#: gradients summed over microbatches in another order (chip_smoke's REL_TOL bf16)
PIPE_REL = 1e-2
PIPE_STAGES, PIPE_MICRO = 4, 8
ELASTIC_MESH, ELASTIC_SAVE = "fsdp=4", 4
RESUME_MESH = "data=2,fsdp=2"
SAVE_EVERY, STOP_AFTER = 4, 4
#: the vision parts: the CLIP recipe (vit-l) on data=2,fsdp=2 at 128 pairs per
#: step (32 per card; the one-card reference holds 128), and ResNet-50
#: replicated at global batch 256 (64 images per card)
CLIP_MESH, CLIP_GLOBAL, RESNET_GLOBAL, VISION_STEPS = "data=2,fsdp=2", 128, 256, 4
#: H100 SXM data sheet: dense bf16 tensor-core peak
PEAK_BF16_FLOPS = 989e12


_T0 = time.perf_counter()


def log(msg: str) -> None:
    if runtime.is_root():
        print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def lm_argv(args) -> list[str]:
    if args.preset == "1b":
        return ["--preset", "1b", "--attn", "flash", "--vocab-size", "32000", "--seq-len", "2048", "--batch-size", "4",
                "--n-seqs", "32", "--epochs", "1", "--device", args.device]
    return ["--preset", "tiny", "--attn", "flash", "--seq-len", "64", "--batch-size", "4", "--n-seqs", "32",
            "--epochs", "1", "--device", args.device]


def sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def timed(device: str, fn):
    """``fn()`` and the seconds it took, the device synchronised before and after."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


class _Stop(Exception):
    """Raised by the feed of the run that stops after its step save."""


class _Stopping:
    """The train dataset, with its length (a resume reads it to scale the
    batch skip), raising once ``after`` + 2 batches were taken: the feed reads
    2 batches ahead of the step, so the run ends after the step save at
    ``after``."""

    def __init__(self, ds, after: int):
        self.ds, self.after = ds, after

    def __len__(self):
        return len(self.ds)

    def __iter__(self):
        for i, batch in enumerate(self.ds):
            if i == self.after + 2:
                raise _Stop("stop after the step save")
            yield batch


def run_lm(argv: list[str], stop_after: int = 0, resume: bool = False, epoch_saves: bool = True, int8: bool = False,
           on_stage=None, **compile_kwargs):
    """One ``train_lm`` run; with ``stop_after`` its feed raises once that many
    batches were taken (after the step save there), which ends the run; with
    ``int8`` at ``precision="int8"``; ``on_stage(stage)`` before it runs;
    ``compile_kwargs`` go to ``TrainingPipeline`` (``precompile=True``)."""
    pipe, stage = train_lm.build(argv, resume=resume, **compile_kwargs)
    if int8:
        stage.precision = lambda: "int8"
    if on_stage is not None:
        on_stage(stage)
    if not epoch_saves:
        stage.checkpoint_every = lambda: 0
    if stop_after:
        orig = stage.train_dataset
        stage.train_dataset = lambda: _Stopping(orig(), stop_after)
        try:
            pipe.run()
        except _Stop:
            pass
        return pipe, stage
    pipe.run()
    return pipe, stage


def global_losses(stage) -> list[float]:
    """Each step's loss: the mean over the processes (tensor-parallel peers
    hold the same value, data-parallel ones their slice's)."""
    per_rank = runtime.all_gather_object([float(x) for x in stage.train_losses])
    return [statistics.fmean(step) for step in zip(*per_rank)]


def full_params(model):
    """(name, full tensor) of every parameter, gathered on every rank."""
    from torch.distributed.tensor import DTensor

    for name, p in model.named_parameters():
        p = p.detach()
        yield name, (p.full_tensor() if isinstance(p, DTensor) else p)


def state_digest(stage) -> dict:
    """Full parameters, AdamW moments and counters, as host tensors (rank 0)."""
    from torch.distributed.tensor import DTensor

    names = {p: n for n, p in stage.state.model.named_parameters()}
    out = {"step": stage.state.step, "count": stage.state.optimizer.count, "params": {}, "mu": {}, "nu": {}}
    for name, full in full_params(stage.state.model):
        if runtime.is_root():
            out["params"][name] = full.cpu()
    for p, slots in stage.state.optimizer.state.items():
        for slot in ("mu", "nu"):
            t = slots[slot]
            full = t.full_tensor() if isinstance(t, DTensor) else t
            if runtime.is_root():
                out[slot][names[p]] = full.cpu()
    return out


def part_meshes(args, one: dict, failed: list) -> tuple[dict, dict]:
    """Part 1; also returns the state and losses of the ``RESUME_MESH`` run,
    the uninterrupted run part 2 is held against (the flags part 2 adds,
    ``--save-every-steps`` and ``--checkpoint-dir``, change no number)."""
    out, uninterrupted = {}, {}
    ref = None
    if runtime.is_root():
        ref = torch.load(one["params_file"])
        _remove_params_file(one)
    for mesh in MESHES:
        t0 = time.perf_counter()
        if args.device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        pipe, stage = run_lm(lm_argv(args) + ["--mesh", mesh])
        wall = time.perf_counter() - t0
        losses = global_losses(stage)
        diff_sq = norm_sq = 0.0
        for name, full in full_params(stage.state.model):
            if runtime.is_root():
                want = ref[name].to(full.device)
                diff_sq += float((full.float() - want.float()).double().square().sum())
                norm_sq += float(want.double().square().sum())
        peak = torch.cuda.max_memory_allocated() / 2**30 if args.device != "cpu" else None
        peaks = runtime.all_gather_object(peak)
        dev = [abs(a - b) for a, b in zip(losses, one["losses"])]
        res = {"losses": losses, "max_abs_loss_diff": max(dev) if dev else None,
               "params_rel_diff": math.sqrt(diff_sq / norm_sq) if runtime.is_root() and norm_sq else None,
               "step_ms": float(stage.tracker["misc/train_step_avg_ms"][-1]),
               "val": float(stage.tracker["val/loss"][-1]), "peak_gib": peaks, "wall_s": wall,
               "plan": {"axes": pipe.models["lm"].plan.axes, "fsdp": pipe.models["lm"].plan.fsdp,
                        "tp": pipe.models["lm"].plan.tp is not None}}
        out[mesh] = res
        log(f"[mesh] {mesh}: losses {losses} (one card {one['losses']}), max |diff| {res['max_abs_loss_diff']:.3g}, "
            f"final params norm-relative diff {res['params_rel_diff']}, step avg {res['step_ms']:.1f} ms, "
            f"peak GiB per card {peaks}, {wall:.1f} s")
        if len(losses) != len(one["losses"]) or not max(dev) <= LOSS_ATOL:
            failed.append(f"{mesh}: losses off the one-card run by {max(dev) if dev else None} (> {LOSS_ATOL})")
        if mesh == RESUME_MESH:
            uninterrupted = {"state": state_digest(stage), "losses": losses}
        del pipe, stage
        _free(args)
    del ref
    return out, uninterrupted


def part_resume(args, uninterrupted: dict, failed: list) -> dict:
    """Part 2: a run that stops after its step-4 save, resumed; only step
    saves (``checkpoint_every() = 0``), so the run writes one save."""
    root = runtime.broadcast_object(tempfile.mkdtemp(prefix="mesh_resume_") if runtime.is_root() else None)
    argv = lm_argv(args) + ["--mesh", RESUME_MESH, "--save-every-steps", str(SAVE_EVERY)]
    t0 = time.perf_counter()
    p_pipe, p = run_lm(argv + ["--checkpoint-dir", os.path.join(root, "p")], stop_after=STOP_AFTER, epoch_saves=False)
    run_dir = str(p_pipe.checkpoint_dir.path)
    steps_p = p.state.step
    save = p_pipe.checkpoint_dir.state_manager(p._steps_scope).last_save
    del p_pipe, p
    _free(args)
    log(f"[resume] stopped after step {steps_p}; the step save: {save}")
    _, r = run_lm(argv + ["--checkpoint-dir", run_dir], resume=True, epoch_saves=False)
    got = state_digest(r)
    got_losses = global_losses(r)
    del r
    _free(args)
    res = {"stopped_at_step": steps_p, "save": save, "wall_s": time.perf_counter() - t0}
    if runtime.is_root():
        want, want_losses = uninterrupted["state"], uninterrupted["losses"]
        same = {part: got[part].keys() == want[part].keys()
                and all(torch.equal(got[part][n], want[part][n]) for n in want[part])
                for part in ("params", "mu", "nu")}
        same["counters"] = (got["step"], got["count"]) == (want["step"], want["count"])
        same["losses"] = got_losses == want_losses[STOP_AFTER:]
        res.update(same, losses_resumed=got_losses, losses_uninterrupted=want_losses)
        if not all(same.values()):
            failed.append(f"resume on {RESUME_MESH} not bitwise: {same}")
        log(f"[resume] {RESUME_MESH}: resumed from the step-{STOP_AFTER} save; bitwise {same}")
    res = runtime.broadcast_object(res)
    runtime.barrier("resume done", timeout=600)
    if runtime.is_root():
        shutil.rmtree(root, ignore_errors=True)
    return res


def _nccl_ms(prof) -> dict:
    """Device ms of FSDP2's collectives in a profile, by kind."""
    from torch.autograd import DeviceType

    out = {"all_gather": 0.0, "reduce_scatter": 0.0, "other_nccl": 0.0, "busy": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0))
        out["busy"] += us / 1e3
        name = e.key.lower()
        if "nccl" in name:
            key = "all_gather" if "allgather" in name else "reduce_scatter" if "reducescatter" in name else "other_nccl"
            out[key] += us / 1e3
    return out


def part_8b(args, failed: list) -> dict:
    res = run_8b(args)
    if not (len(res["losses"]) == res["steps"] and all(math.isfinite(x) for x in res["losses"])
            and res["losses"][-1] < res["losses"][0]):
        failed.append(f"8b losses not finite and falling: {res['losses']}")
    return res


def run_8b(args, **compile_kwargs) -> dict:
    """Part 3's run (``compile_kwargs`` to ``TrainingPipeline``): its losses,
    steady step, MFU, peak memory and one profiled step."""
    if args.preset == "1b":
        argv = ["--mesh", "fsdp=-1", "--global-batch", "8", "--seq-len", "4096", "--remat", "--chunked-loss", "8192",
                "--steps-per-epoch", "6", "--device", args.device]
        tokens = 8 * 4096
    else:
        argv = ["--toy", "--mesh", "fsdp=-1", "--global-batch", "8", "--steps-per-epoch", "4", "--remat",
                "--chunked-loss", "200", "--lr", "1e-2", "--device", args.device]
        tokens = 8 * 64
    base = _allocated_gib(args)
    t0 = time.perf_counter()
    _clear_dynamo_counters()
    pipe, stage = pod_llama_fsdp.build(argv, **compile_kwargs)
    step_times = []
    inner = stage._train_step

    def timed(batch):
        sync(args.device)
        t = time.perf_counter()
        metrics = inner(batch)
        sync(args.device)
        step_times.append((time.perf_counter() - t) * 1e3)
        return metrics

    stage._train_step = timed
    pipe.run()
    wall = time.perf_counter() - t0
    losses = global_losses(stage)
    steady = statistics.median(step_times[1:])
    flops = stage.step_flops()
    world = runtime.world_size()
    peak = torch.cuda.max_memory_allocated() / 2**30 if args.device != "cpu" else None
    prof_ms = None
    if args.device != "cpu":
        batch = torch.from_numpy(pipe.datasets["train"][0]).cuda()
        prof_ms = _profiled_step(inner, batch)
    res = {"losses": losses, "step_times_ms": runtime.all_gather_object(step_times), "steady_ms": steady,
           "tokens_per_s": tokens / steady * 1e3, "tokens_per_s_per_card": tokens / steady * 1e3 / world,
           "step_flops": flops, "mfu_steady": flops / (steady / 1e3) / (PEAK_BF16_FLOPS * world),
           "mfu_epoch": float(stage.tracker["misc/mfu"][-1]) if "misc/mfu" in stage.tracker else None,
           "peak_gib": runtime.all_gather_object(peak), "profiled_step": runtime.all_gather_object(prof_ms),
           "n_params": sum(p.numel() for p in stage.state.model.parameters()), "wall_s": wall,
           "steps": stage.config.steps_per_epoch, "allocated_at_start_gib": runtime.all_gather_object(base),
           **_compile_record(stage)}
    log(f"[8b] {' '.join(argv)} {compile_kwargs or 'eager'}: losses {losses}; steady step {steady:.1f} ms = "
        f"{res['tokens_per_s']:.0f} tokens/s ({res['tokens_per_s_per_card']:.0f} per card); MFU at the steady step "
        f"{res['mfu_steady']:.4f} (misc/mfu over the epoch {res['mfu_epoch']}); peak GiB per card {res['peak_gib']} "
        f"(allocated at the start {res['allocated_at_start_gib']}); "
        f"profiled step (device ms) {prof_ms}; {wall:.1f} s")
    del pipe, stage
    _free(args)
    return res


def _clear_dynamo_counters() -> None:
    import torch._dynamo.utils as dynamo_utils

    dynamo_utils.counters.clear()


def _compile_record(stage) -> dict:
    """Every rank's graph breaks (since ``_clear_dynamo_counters``),
    ``misc/recompiles`` and ``misc/compile_ms`` (None when eager)."""
    import torch._dynamo.utils as dynamo_utils

    compiled = stage._train_compiled is not None
    mine = {"graph_breaks": sum(dynamo_utils.counters["graph_break"].values()),
            "recompiles": [int(x) for x in stage.tracker["misc/recompiles"]] if compiled else None,
            "compile_ms": float(stage.tracker["misc/compile_ms"][0]) if compiled else None}
    return {"compile": runtime.all_gather_object(mine)}


def _profiled_step(step, batch) -> dict:
    """One call of ``step(batch)`` under torch.profiler: the device ms of
    FSDP2's collectives and of all device work (``busy``; kernels on the
    collectives' stream overlap the compute, so busy may exceed the wall),
    the wall ms, and the idle share ``1 - busy / wall`` (floored at 0)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, seconds = timed("cuda", lambda: step(batch))
    wall = seconds * 1e3
    out = _nccl_ms(prof)
    out.update(wall=wall, idle=max(0.0, 1 - out["busy"] / wall))
    return out


def _timed_steps(args, stage) -> list[float]:
    """Wrap ``stage``'s train step to record each step's synchronised ms."""
    times, inner = [], stage._train_step

    def timed_step(batch):
        sync(args.device)
        t = time.perf_counter()
        metrics = inner(batch)
        sync(args.device)
        times.append((time.perf_counter() - t) * 1e3)
        return metrics

    stage._train_step = timed_step
    return times


def clip_argv(args) -> list[str]:
    if args.preset == "1b":
        return ["--preset", "vit-l", "--global-batch", str(CLIP_GLOBAL), "--steps-per-epoch", str(VISION_STEPS),
                "--epochs", "1", "--device", args.device]
    return ["--toy", "--global-batch", "16", "--steps-per-epoch", str(VISION_STEPS), "--device", args.device]


def run_clip(args, mesh: str | None = None) -> dict:
    """The CLIP recipe at ``clip_argv``, with ``--mesh`` when given."""
    if args.device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    pipe, stage = pod_clip_vit.build(clip_argv(args) + (["--mesh", mesh] if mesh else []))
    times = _timed_steps(args, stage)
    pipe.run()
    peak = torch.cuda.max_memory_allocated() / 2**30 if args.device != "cpu" else None
    out = {"losses": global_losses(stage), "steady_ms": statistics.median(times[1:]),
           "pairs": stage.config.global_batch, "accuracy": float(stage.tracker["train/accuracy"][-1]),
           "peak_gib": runtime.all_gather_object(peak)}
    del pipe, stage
    _free(args)
    return out


def run_resnet(args) -> dict:
    """ResNet-50 (``tiny``: a ResNet-18 at 32x32) replicated over the
    processes, ``sgd(0.1, momentum=0.9)``, each process feeding its rows of
    one global batch made on the device from a seed: the BatchNorm statistics
    are the global batch's (``ResNet.apply_data_parallel``)."""
    import torch.nn.functional as F

    import dmlcloud_tpu_torch as dml
    from dmlcloud_tpu_torch.models.resnet import ResNet18, ResNet50
    from dmlcloud_tpu_torch.optim import sgd

    big = args.preset == "1b"
    n, size = (RESNET_GLOBAL, 224) if big else (8, 32)
    world, rank = runtime.world_size(), runtime.rank()
    g = torch.Generator(device=args.device).manual_seed(3)
    images = torch.rand(n, size, size, 3, device=args.device, generator=g)
    labels = torch.randint(0, 1000 if big else 10, (n,), device=args.device, generator=g)
    rows = slice(rank * n // world, (rank + 1) * n // world)
    batch = {"image": images[rows].contiguous(), "label": labels[rows].contiguous()}

    class Stage(dml.TrainValStage):
        def pre_stage(self):
            gen = torch.Generator(device=args.device).manual_seed(0)
            model = (ResNet50(device=args.device, generator=gen) if big else
                     ResNet18(num_classes=10, device=args.device, generator=gen))
            self.pipeline.register_model("resnet", model, verbose=False)
            self.pipeline.register_optimizer("sgd", sgd(0.1, momentum=0.9))
            self.pipeline.register_dataset("train", [batch] * VISION_STEPS, verbose=False)

        def step(self, state, b):
            return F.cross_entropy(state.model(b["image"]), b["label"])

        def val_epoch(self):
            pass

    if args.device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    pipe = dml.TrainingPipeline({"seed": 0}, name="resnet", device=args.device)
    stage = Stage()
    pipe.append_stage(stage, max_epochs=1)
    times = _timed_steps(args, stage)
    pipe.run()
    peak = torch.cuda.max_memory_allocated() / 2**30 if args.device != "cpu" else None
    out = {"losses": global_losses(stage), "steady_ms": statistics.median(times[1:]), "images": n,
           "peak_gib": runtime.all_gather_object(peak)}
    del pipe, stage, batch, images, labels
    _free(args)
    return out


def part_vision(args, one: dict, failed: list) -> dict:
    """Parts ``clip`` and ``resnet``: each against the one-card run at the
    same global batch, every step's loss within ``LOSS_ATOL``."""
    out = {}
    for part, run in (("clip", lambda: run_clip(args, CLIP_MESH)), ("resnet", lambda: run_resnet(args))):
        if part not in one:
            continue
        t0 = time.perf_counter()
        res = run()
        n = res.get("pairs", res.get("images"))
        res.update(wall_s=time.perf_counter() - t0, per_s=n / res["steady_ms"] * 1e3,
                   per_s_per_card=n / res["steady_ms"] * 1e3 / runtime.world_size(),
                   one_card_per_s=n / one[part]["steady_ms"] * 1e3)
        dev = [abs(a - b) for a, b in zip(res["losses"], one[part]["losses"])]
        res["max_abs_loss_diff"] = max(dev) if dev else None
        out[part] = res
        log(f"[{part}] {CLIP_MESH if part == 'clip' else 'replicate'} over {runtime.world_size()} processes: losses "
            f"{res['losses']} (one card {one[part]['losses']}), max |diff| {res['max_abs_loss_diff']}; steady step "
            f"{res['steady_ms']:.1f} ms = {res['per_s']:.1f} per s ({res['per_s_per_card']:.1f} per card; one card "
            f"{res['one_card_per_s']:.1f} per s); peak GiB per card {res['peak_gib']}; {res['wall_s']:.1f} s")
        if len(dev) != len(one[part]["losses"]) or not max(dev) <= LOSS_ATOL:
            failed.append(f"{part}: losses off the one-card run by {res['max_abs_loss_diff']} (> {LOSS_ATOL})")
    return out


def _digest(t: torch.Tensor) -> list[int]:
    """Two exact integer digests of a tensor's bits (the full tensor of a
    DTensor: a collective): their sum and a position-weighted sum, in int64."""
    from torch.distributed.tensor import DTensor

    t = t.detach()
    t = t.full_tensor() if isinstance(t, DTensor) else t
    flat = t.contiguous().reshape(-1)
    bits = flat.view({8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}[flat.element_size()]).long()
    weights = torch.arange(1, bits.numel() + 1, device=bits.device) % 1000003
    return [int(bits.sum()), int((bits * weights).sum())]


def state_digests(tree: dict, prefix: str = "") -> dict:
    """``{key: digest}`` of every tensor of a nested state dict (collective)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(state_digests(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = _digest(value)
    return out


def ring_argv(args, window: int | None = None, attn: str = "ring") -> list[str]:
    """The 1b model at T = 8192, one sequence per step (``tiny``: T = 64)."""
    if args.preset == "1b":
        argv = ["--preset", "1b", "--vocab-size", "32000", "--seq-len", "8192"]
    else:
        argv = ["--preset", "tiny", "--seq-len", "64"]
    argv += ["--batch-size", "1", "--n-seqs", "8", "--epochs", "1", "--attn", attn, "--device", args.device]
    if attn == "ring":
        argv += ["--mesh", "seq=-1"]
    return argv + (["--window", str(window)] if window else [])


def _ring_window(args) -> int:
    """A window that reaches two blocks back on seq=4 (3 of the 4 hops): T/2."""
    return int(ring_argv(args)[ring_argv(args).index("--seq-len") + 1]) // 2


def part_ring(args, one: dict, failed: list) -> dict:
    """Part 4: the ring on ``seq`` = every process, without and with a window."""
    from dmlcloud_tpu_torch.examples.train_lm import PRESETS

    world, rank = runtime.world_size(), runtime.rank()
    layers = PRESETS[args.preset]["num_layers"]
    route = fa.kernel_route(torch.bfloat16, PRESETS[args.preset]["head_dim"])
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    names = tuple(n + "_tc" for n in names) if route == "tc" else names
    out = {}
    for label, window in (("ring", None), ("ring window", _ring_window(args))):
        t0 = time.perf_counter()
        if args.device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        pipe, stage = train_lm.build(ring_argv(args, window))
        digests = []
        inner = stage._train_step

        def checked(batch):
            metrics = inner(batch)
            total = [0, 0]
            for p in stage.state.model.parameters():
                total = [a + b for a, b in zip(total, _digest(p))]
            digests.append(total)
            return metrics

        stage._train_step = checked
        fa.reset_launch_counts()  # the ring's run starts here ...
        pipe.run()
        sync(args.device)
        launches = dict(fa.LAUNCHES)  # ... and ends here
        wall = time.perf_counter() - t0
        losses = [float(x) for x in stage.train_losses]
        steps = len(losses)
        tl = stage.state.model.cfg.max_seq_len // world
        hops = world if window is None else min(world, max(1, (window - 2) // tl + 2))
        mine = rank + 1 if window is None else min(rank, hops - 1) + 1
        want = {names[0]: layers * mine * (steps + 1), names[1]: layers * mine * steps, names[2]: layers * mine * steps}
        got_launches = {n: launches[n] for n in names}
        per_rank = runtime.all_gather_object({"launches": got_launches, "want": want, "digests": digests,
                                              "losses": losses})
        same = all(r["digests"] == per_rank[0]["digests"] for r in per_rank)
        ref = one[label]["losses"]
        dev = [abs(a - b) for a, b in zip(losses, ref)]
        peak = torch.cuda.max_memory_allocated() / 2**30 if args.device != "cpu" else None
        res = {"losses": losses, "one_card": ref, "max_abs_loss_diff": max(dev) if dev else None,
               "seq_replicas_bitwise_every_step": same, "hops": hops,
               "launches": [r["launches"] for r in per_rank], "launches_want": [r["want"] for r in per_rank],
               "step_ms": float(stage.tracker["misc/train_step_avg_ms"][-1]),
               "one_card_step_ms": one[label]["step_ms"], "peak_gib": runtime.all_gather_object(peak),
               "wall_s": wall}
        log(f"[ring] {' '.join(ring_argv(args, window))}: losses {losses} (one card {ref}), max |diff| "
            f"{res['max_abs_loss_diff']:.3g}; seq peers bitwise after every step: {same}; launches per rank "
            f"{res['launches']} (want {res['launches_want']}); step avg {res['step_ms']:.1f} ms (one card "
            f"{res['one_card_step_ms']:.1f}; first step included); peak GiB {res['peak_gib']}; {wall:.1f} s")
        if len(losses) != len(ref) or not max(dev) <= LOSS_ATOL:
            failed.append(f"{label}: losses off the one-card run by {max(dev) if dev else None} (> {LOSS_ATOL})")
        if not same:
            failed.append(f"{label}: seq peers' parameters differ")
        if args.device != "cpu" and any(r["launches"] != r["want"] for r in per_rank):
            failed.append(f"{label}: launches {res['launches']} != {res['launches_want']}")
        out[label] = res
        del pipe, stage
        _free(args)
    return out


def part_pipe(args, failed: list) -> dict:
    """Part 5: ``pipeline_apply`` over ``pipe`` = every process."""
    from torch.func import functional_call

    from dmlcloud_tpu_torch.examples.train_lm import PRESETS
    from dmlcloud_tpu_torch.models.transformer import DecoderBlock, TransformerConfig, rope_frequencies
    from dmlcloud_tpu_torch.parallel import mesh as mesh_lib
    from dmlcloud_tpu_torch.parallel import pipeline_apply, stack_pytrees

    world, rank, dev = runtime.world_size(), runtime.rank(), args.device
    t = 2048 if args.preset == "1b" else 64
    kw = dict(PRESETS[args.preset])
    n_blocks = kw["num_layers"] if args.preset == "1b" else world
    cfg = TransformerConfig(vocab_size=32000, max_seq_len=t, attn_impl="flash", **kw)
    per = n_blocks // world
    torch.manual_seed(0)  # the same blocks on every process
    blocks = torch.nn.ModuleList(DecoderBlock(cfg, device=dev) for _ in range(n_blocks))
    cos, sin = rope_frequencies(cfg.head_dim, t, cfg.rope_theta, None, dev)

    class Blocks(torch.nn.Module):
        def __init__(self, mods):
            super().__init__()
            self.blocks = torch.nn.ModuleList(mods)

        def forward(self, x):
            for block in self.blocks:
                x = block(x, cos, sin)
            return x

    stages = [Blocks(blocks[i * per:(i + 1) * per]) for i in range(world)]
    whole = Blocks(blocks)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(PIPE_MICRO, 1, t, cfg.hidden_dim, generator=g, device=dev).to(torch.bfloat16)
    cot = torch.randn(x.shape, generator=g, device=dev).to(torch.bfloat16)
    mesh = mesh_lib.create_mesh({"pipe": world}, device=dev)
    stacked = {n: v.requires_grad_(True) for n, v in stack_pytrees(
        [{n: p.detach() for n, p in st.named_parameters()} for st in stages]).items()}

    def piped():
        xi = x.clone().requires_grad_(True)
        y = pipeline_apply(lambda params, act: functional_call(stages[0], params, (act,)), stacked, xi, mesh)
        grads = torch.autograd.grad(y, [xi, *stacked.values()], cot)
        return y.detach(), grads

    def sequential():
        xi = x.reshape(-1, t, cfg.hidden_dim).clone().requires_grad_(True)
        y = whole(xi)
        grads = torch.autograd.grad(y, [xi, *whole.parameters()], cot.reshape(y.shape))
        return y.detach(), grads

    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()  # the pipe path's run starts here ...
    y, grads = piped()
    sync(dev)
    launches = dict(fa.LAUNCHES)  # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev != "cpu" else None
    runtime.barrier("time pipe", timeout=600)
    pipe_ms = timed(dev, piped)[1] * 1e3
    dx = grads[0].clone()
    torch.distributed.all_reduce(dx)  # stage 0 holds the input's gradient, the others zeros
    mine = {n: g_[rank].clone() for n, g_ in zip(stacked, grads[1:])}
    del grads
    _free(args)
    y_ref, ref_grads = sequential()
    seq_ms = timed(dev, sequential)[1] * 1e3

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    names = [n for n, _ in whole.named_parameters()]
    errs = {"y": rel(y.reshape(y_ref.shape), y_ref), "dx": rel(dx.reshape(ref_grads[0].shape), ref_grads[0])}
    # this stage's blocks are blocks[rank * per + i]: "blocks.{i}.<rest>" in the stage module
    for n, g_ in mine.items():
        i, rest = n.split(".", 2)[1], n.split(".", 2)[2]
        errs[n] = rel(g_, ref_grads[1 + names.index(f"blocks.{rank * per + int(i)}.{rest}")])
    worst = max(errs.values())
    per_rank = runtime.all_gather_object({"worst": worst, "launches": launches, "peak": peak, "ms": pipe_ms})
    res = {"stages": world, "blocks_per_stage": per, "n_micro": PIPE_MICRO, "worst_rel": [r["worst"] for r in per_rank],
           "launches": [r["launches"] for r in per_rank], "peak_gib": [r["peak"] for r in per_rank],
           "pipe_ms": [r["ms"] for r in per_rank], "sequential_one_card_ms": seq_ms}
    log(f"[pipe] pipeline_apply on pipe={world}, {n_blocks} DecoderBlocks as {world} stages of {per}, "
        f"{PIPE_MICRO} microbatches of [1, {t}, {cfg.hidden_dim}] bf16: worst norm-relative err per rank "
        f"{res['worst_rel']} (output, input and parameter gradients; bound {PIPE_REL}); forward+backward "
        f"{res['pipe_ms']} ms against {seq_ms:.1f} ms for the blocks in sequence on one card; peak GiB "
        f"{res['peak_gib']}; launches per rank {res['launches']}")
    if not max(res["worst_rel"]) <= PIPE_REL:
        failed.append(f"pipe: outputs or gradients off the sequential blocks by {max(res['worst_rel'])}")
    del stacked, blocks, stages, whole, y, y_ref, ref_grads, mine, dx
    _free(args)
    return res


def part_elastic(args, failed: list, out_path: str | None) -> dict:
    """Part 6: the save on ``ELASTIC_MESH`` the ``--resume`` calls continue."""
    root = runtime.broadcast_object(tempfile.mkdtemp(prefix="mesh_elastic_") if runtime.is_root() else None)
    _, u = run_lm(lm_argv(args) + ["--mesh", ELASTIC_MESH])
    uninterrupted = global_losses(u)
    del u
    _free(args)
    argv = lm_argv(args) + ["--mesh", ELASTIC_MESH, "--save-every-steps", str(ELASTIC_SAVE)]
    p_pipe, p = run_lm(argv + ["--checkpoint-dir", os.path.join(root, "p")], stop_after=ELASTIC_SAVE,
                       epoch_saves=False)
    ckpt, scope = p_pipe.checkpoint_dir, p._steps_scope
    step = ckpt.latest_step(scope)
    save = ckpt.state_manager(scope).last_save
    restored, restore_s = timed(args.device, lambda: ckpt.restore_state(step, scope=scope, mesh=p_pipe.mesh))
    digests = state_digests(restored)
    side = ckpt.read_sharding_sidecar(scope, step)
    res = {"run_dir": str(ckpt.path), "root": root, "step": step, "save": save, "restore_no_template_s": restore_s,
           "uninterrupted": uninterrupted, "digests": digests, "sidecar_mesh": side and side["mesh"],
           "sidecar_specs": side and len(side["specs"])}
    log(f"[elastic] {ELASTIC_MESH}: stopped after the step-{step} save ({save}); restored without a template onto "
        f"the same mesh in {restore_s:.1f} s ({len(digests)} tensors); sidecar mesh {res['sidecar_mesh']}, "
        f"{res['sidecar_specs']} specs; uninterrupted losses {uninterrupted}")
    if step != ELASTIC_SAVE or side is None:
        failed.append(f"elastic: the save is at step {step} (want {ELASTIC_SAVE}), sidecar {side is not None}")
    if runtime.is_root() and out_path:
        with open(out_path, "w") as f:
            json.dump(res, f)
    del restored, p_pipe, p
    _free(args)
    return {k: v for k, v in res.items() if k != "digests"}


def resume_elastic(args) -> int:
    """``--resume``: continue the elastic save on this run's layout."""
    with open(args.resume) as f:
        info = json.load(f)
    argv = lm_argv(args) + (["--mesh", args.mesh] if args.mesh else []) + [
        "--save-every-steps", str(ELASTIC_SAVE), "--checkpoint-dir", info["run_dir"]]
    t0 = time.perf_counter()
    pipe, stage = train_lm.build(argv, resume=True)
    stage.checkpoint_every = lambda: 0
    captured = {}
    restore = stage._restore_state

    def restoring():
        captured["restore_s"] = timed(args.device, restore)[1]
        captured["skip"] = stage._resume_skip_steps
        captured["digests"] = state_digests(stage.state.state_dict())

    stage._restore_state = restoring
    pipe.run()
    losses = global_losses(stage)
    want = info["uninterrupted"][ELASTIC_SAVE:]
    dev = [abs(a - b) for a, b in zip(losses, want)]
    got, saved = captured.get("digests", {}), info["digests"]
    same = {part: all(got.get(k) == v for k, v in saved.items() if k.startswith(part))
            for part in ("params.", "opt_state.mu.", "opt_state.nu.", "opt_state.count", "step")}
    failed = []
    if got.keys() != saved.keys() or not all(same.values()):
        failed.append(f"restored state not bitwise the saved one: {same}")
    if captured.get("skip") != ELASTIC_SAVE:
        failed.append(f"the resume skips {captured.get('skip')} batches, want {ELASTIC_SAVE}")
    if len(losses) != len(want) or not max(dev) <= LOSS_ATOL:
        failed.append(f"continued losses off the uninterrupted run by {max(dev) if dev else None} (> {LOSS_ATOL})")
    res = {"layout": args.mesh or "one card, no mesh", "world": runtime.world_size(), "bitwise": same,
           "skip": captured.get("skip"), "restore_s": captured.get("restore_s"), "losses": losses,
           "uninterrupted": want, "max_abs_loss_diff": max(dev) if dev else None, "wall_s": time.perf_counter() - t0,
           "failed": failed}
    log(f"[elastic] resumed on {res['layout']}: restored bitwise {same}, skip {res['skip']}, restore "
        f"{res['restore_s']:.1f} s; losses {losses} against {want}, max |diff| {res['max_abs_loss_diff']:.3g}")
    runtime.barrier("resumed", timeout=600)
    if args.delete_after and runtime.is_root():
        shutil.rmtree(info["root"], ignore_errors=True)
    log(json.dumps(res))
    runtime.deinitialize()
    return 1 if failed else 0


# ---------------------------------------------------------------------------
# the MoE, tensor-parallel decode and int8 parts
# ---------------------------------------------------------------------------

#: 1b-moe (chip_smoke.py phase 18): the 1b preset with 8 experts (top-2,
#: capacity factor 1.25) in every second block
MOE = dict(num_experts=8, moe_every=2, moe_top_k=2, moe_capacity_factor=1.25)
MOE_MESHES = ["expert=4", "data=2,expert=2"]
MOE_STEPS = 4
#: the bf16 1b decoding on these meshes (``model=2`` twice over the four cards)
TP_MESHES = ["data=2,model=2", "model=4"]
#: greedy decode: rows x prompt tokens, new tokens; a row may part from the
#: one-card tokens only at a step where the one-card top-2 logit gap is below
#: ``TIE_GAP`` (two bf16 paths of the 1b differ in their logits by up to 0.086:
#: a speculative verify pass against one-row decode steps, PERF.md)
TP_DECODE = dict(rows=4, prompt=128, new=32)
TIE_GAP = 0.12
#: chip_smoke.py phase 13 (d)'s burst: 16 requests, prompts 128-1024, 128 new
SERVE = dict(requests=16, prompts=(128, 1024), new=128, max_slots=8, block_size=16, prefill_chunk=256)
INT8_MESH, INT8_DECODE_MESH = "fsdp=4", "data=2,model=2"


def _moe_layers(args) -> tuple[int, int]:
    """(the depth the meshes are checked at, the full depth)."""
    return (8, 24) if args.preset == "1b" else (2, 4)


def moe_config(args, layers: int):
    from dmlcloud_tpu_torch.models.transformer import TransformerConfig

    if args.preset == "1b":
        return TransformerConfig(vocab_size=32000, max_seq_len=2048, attn_impl="flash", **MOE,
                                 **dict(train_lm.PRESETS["1b"], num_layers=layers))
    return TransformerConfig(vocab_size=512, max_seq_len=64, attn_impl="flash", dtype=torch.float32, **MOE,
                             **dict(train_lm.PRESETS["tiny"], num_layers=layers))


def run_moe(args, mesh: str | None, layers: int, **compile_kwargs) -> dict:
    """1b-moe at ``layers`` through a ``TrainingPipeline`` on ``mesh`` (None:
    one card): ``MOE_STEPS`` AdamW steps of a global batch of 4 rows, each
    process feeding its data-parallel rows, the step ``lm_loss +
    total_aux_loss``; ``compile_kwargs`` to the pipeline."""
    import dmlcloud_tpu_torch as dml
    from dmlcloud_tpu_torch.models.moe import total_aux_loss
    from dmlcloud_tpu_torch.models.transformer import DecoderLM, llama_partition_rules, lm_loss
    from dmlcloud_tpu_torch.optim import adamw
    from dmlcloud_tpu_torch.parallel.mesh import data_parallel_rank, data_parallel_size, parse_mesh_axes

    cfg = moe_config(args, layers)
    gen = torch.Generator().manual_seed(0)
    batches = [torch.randint(0, cfg.vocab_size, (4, cfg.max_seq_len), generator=gen) for _ in range(MOE_STEPS)]

    class MoEStage(dml.TrainValStage):
        def pre_stage(self):
            model = DecoderLM(cfg, device=args.device, generator=torch.Generator(device=args.device).manual_seed(0))
            self.pipeline.register_model("lm", model, sharding=llama_partition_rules(), verbose=False)
            self.pipeline.register_optimizer("adamw", adamw(3e-4))
            m = self.pipeline.mesh
            dp, r = (data_parallel_size(m), data_parallel_rank(m)) if m is not None else (1, 0)
            self.pipeline.register_dataset("train", [b[r * 4 // dp:(r + 1) * 4 // dp] for b in batches],
                                           verbose=False)

        def step(self, state, batch):
            return lm_loss(state.model(batch), batch) + total_aux_loss(state.model)

        def val_epoch(self):
            pass

    base = _allocated_gib(args)
    pipe = dml.TrainingPipeline({"seed": 0}, name="moe", device=args.device, **compile_kwargs)
    if mesh:
        pipe.set_mesh(parse_mesh_axes(mesh))
    stage = MoEStage()
    times = _timed_steps(args, stage)
    pipe.append_stage(stage, max_epochs=1)
    _clear_dynamo_counters()
    pipe.run()
    losses = global_losses(stage)
    steady = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30 if args.device != "cpu" else None
    local = sum(getattr(p, "_local_tensor", p).numel() for p in stage.state.model.parameters())
    prof = None
    if compile_kwargs and args.device != "cpu":
        prof = _profiled_step(stage._train_step, next(iter(stage._feed(stage.train_dataset()))))
    out = {"layers": layers, "losses": losses, "step_ms": steady, "step_ms_all": times,
           "tokens_per_s": 4 * cfg.max_seq_len / steady * 1e3, "peak_gib": runtime.all_gather_object(peak),
           "local_params_b": local / 1e9, "profiled_step": runtime.all_gather_object(prof),
           "allocated_at_start_gib": runtime.all_gather_object(base), **_compile_record(stage)}
    log(f"[moe] {mesh or 'one card'}, 1b-moe at {layers} layers {compile_kwargs or ''}: losses {losses}; steady "
        f"step {steady:.1f} ms (allocated at the start {out['allocated_at_start_gib']} GiB) "
        f"(steps {[round(t, 1) for t in times]}) = {out['tokens_per_s']:.0f} tokens/s; peak GiB per card "
        f"{out['peak_gib']}; {out['local_params_b']:.3f} B parameters on rank 0")
    del pipe, stage
    _free(args)
    return out


def part_moe(args, one: dict, failed: list) -> dict:
    check, full = _moe_layers(args)
    out = {}
    for mesh in MOE_MESHES:
        out[mesh] = {"check": run_moe(args, mesh, check), "full": run_moe(args, mesh, full)}
        dev = [abs(a - b) for a, b in zip(out[mesh]["check"]["losses"], one["moe"]["losses"])]
        out[mesh]["max_abs_loss_diff"] = max(dev)
        log(f"[moe] {mesh} at {check} layers against one card: max |loss diff| {max(dev):.3g}")
        if len(dev) != MOE_STEPS or not max(dev) <= LOSS_ATOL:
            failed.append(f"moe {mesh}: losses off the one-card run by {max(dev)} (> {LOSS_ATOL})")
    gap = max(abs(a - b) for a, b in zip(out[MOE_MESHES[0]]["check"]["losses"], out[MOE_MESHES[1]]["check"]["losses"]))
    out["data_vs_expert_gap"] = gap
    log(f"[moe] {MOE_MESHES[1]} against {MOE_MESHES[0]} at {check} layers: max |loss diff| {gap:.3g}")
    if not gap <= LOSS_ATOL:
        failed.append(f"moe: {MOE_MESHES[1]} off {MOE_MESHES[0]} by {gap} (> {LOSS_ATOL})")
    return out


def _compiled_gates(what: str, eager: dict, compiled: dict, failed: list) -> float:
    """Part 12's gates on one configuration; returns the largest loss gap."""
    gaps = [abs(a - b) for a, b in zip(compiled["losses"], eager["losses"])]
    gap = max(gaps) if gaps else float("inf")
    if len(compiled["losses"]) != len(eager["losses"]) or not gap <= COMPILED_LOSS_ATOL:
        failed.append(f"compiled {what}: losses off eager by {gap} (> {COMPILED_LOSS_ATOL})")
    for rank, rec in enumerate(compiled["compile"]):
        if rec["graph_breaks"] or rec["recompiles"] != [0]:
            failed.append(f"compiled {what}, rank {rank}: {rec['graph_breaks']} graph breaks, misc/recompiles "
                          f"{rec['recompiles']}")
    return gap


def _lm_mesh_run(args, mesh: str, **compile_kwargs) -> dict:
    """Part 1's 1b run on ``mesh``: losses, steady step, one profiled step,
    peak memory per card and the compile record."""
    base = _allocated_gib(args)
    times = []
    _clear_dynamo_counters()
    t0 = time.perf_counter()
    pipe, stage = run_lm(lm_argv(args) + ["--mesh", mesh], on_stage=lambda st: times.extend([_timed_steps(args, st)]),
                         **compile_kwargs)
    wall = time.perf_counter() - t0
    steps = times[0]
    prof = None
    if args.device != "cpu":
        prof = _profiled_step(stage._train_step, next(iter(stage._feed(stage.train_dataset()))))
    peak = torch.cuda.max_memory_allocated() / 2**30 if args.device != "cpu" else None
    res = {"losses": global_losses(stage), "val": float(stage.tracker["val/loss"][-1]),
           "steady_ms": statistics.median(steps[1:]), "step_ms_all": steps, "wall_s": wall,
           "peak_gib": runtime.all_gather_object(peak), "allocated_at_start_gib": runtime.all_gather_object(base),
           "profiled_step": runtime.all_gather_object(prof), **_compile_record(stage)}
    del pipe, stage
    _free(args)
    return res


def _allocated_gib(args) -> float | None:
    """GiB allocated on this card now (a run's starting point), after which
    the peak statistic is reset; None on the CPU."""
    if args.device == "cpu":
        return None
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2**30


def part_compiled(args, out: dict, failed: list) -> dict:
    """Part 12 (module docstring); ``out`` holds part 3's run when it ran."""
    res = {}
    cache = runtime.broadcast_object(tempfile.mkdtemp(prefix="mesh_cards_inductor_") if runtime.is_root() else None)
    try:
        for mesh in COMPILED_MESHES:
            eager = _lm_mesh_run(args, mesh)
            compiled = _lm_mesh_run(args, mesh, precompile=True, compile_cache=os.path.join(cache, mesh))
            gap = _compiled_gates(f"1b {mesh}", eager, compiled, failed)
            res[mesh] = {"eager": eager, "compiled": compiled, "max_abs_loss_diff": gap}
            log(f"[compiled] 1b {mesh}: losses eager {eager['losses']} compiled {compiled['losses']} (max |diff| "
                f"{gap:.3g}); steady step {eager['steady_ms']:.1f} -> {compiled['steady_ms']:.1f} ms; profiled "
                f"step {eager['profiled_step'][0]} -> {compiled['profiled_step'][0]}; peak GiB per card "
                f"{eager['peak_gib']} -> {compiled['peak_gib']} (allocated at the start "
                f"{eager['allocated_at_start_gib']} -> {compiled['allocated_at_start_gib']}); compile "
                f"{compiled['compile']}")
        # the 8b last: each run's memory is released only once the next one
        # has started (the eager 8b of part 3 is still allocated during the
        # first 1b run; each run logs what was allocated at its start)
        layers = _moe_layers(args)[0]
        eager = run_moe(args, COMPILED_MOE_MESH, layers)
        compiled = run_moe(args, COMPILED_MOE_MESH, layers, precompile=True, compile_cache=os.path.join(cache, "moe"))
        gap = _compiled_gates(f"1b-moe {COMPILED_MOE_MESH}", eager, compiled, failed)
        res["moe"] = {"eager": eager, "compiled": compiled, "max_abs_loss_diff": gap}
        log(f"[compiled] 1b-moe {COMPILED_MOE_MESH} at {layers} layers: losses eager {eager['losses']} compiled "
            f"{compiled['losses']} (max |diff| {gap:.3g}); steady step {eager['step_ms']:.1f} -> "
            f"{compiled['step_ms']:.1f} ms; compile {compiled['compile']}")
        eager = out.get("8b") or run_8b(args)
        compiled = run_8b(args, precompile=True, compile_cache=os.path.join(cache, "8b"))
        gap = _compiled_gates("8b fsdp=4", eager, compiled, failed)
        res["8b"] = {"eager": eager, "compiled": compiled, "max_abs_loss_diff": gap}
        log(f"[compiled] 8b fsdp=4: losses eager {eager['losses']} compiled {compiled['losses']} (max |diff| "
            f"{gap:.3g}); steady step {eager['steady_ms']:.1f} -> {compiled['steady_ms']:.1f} ms; MFU "
            f"{eager['mfu_steady']:.4f} -> {compiled['mfu_steady']:.4f}; peak GiB per card {eager['peak_gib']} -> "
            f"{compiled['peak_gib']}; compile {compiled['compile']}")
    finally:
        runtime.barrier("compiled done", timeout=600)
        if runtime.is_root():
            shutil.rmtree(cache, ignore_errors=True)
    return res


def _lm_1b(args):
    from dmlcloud_tpu_torch.models.transformer import DecoderLM, TransformerConfig

    if args.preset == "1b":
        cfg = TransformerConfig(vocab_size=32000, max_seq_len=2048, **train_lm.PRESETS["1b"])
    else:  # 4 KV heads: model=4 splits them
        cfg = TransformerConfig(vocab_size=512, max_seq_len=256, **dict(train_lm.PRESETS["tiny"], num_kv_heads=4))
    return DecoderLM(cfg, device=args.device, generator=torch.Generator(device=args.device).manual_seed(0))


def _decode_prompt(args, cfg):
    d = TP_DECODE if args.preset == "1b" else dict(TP_DECODE, prompt=16, new=8)
    gen = torch.Generator().manual_seed(14)
    return torch.randint(0, cfg.vocab_size, (d["rows"], d["prompt"]), generator=gen).to(args.device), d["new"]


def decode_run(args, model) -> dict:
    """Greedy ``generate`` on ``model`` (timed: ms per decode step after the
    prefill-only call), and each step's top-2 logit gap (cached steps fed the
    generated tokens)."""
    from dmlcloud_tpu_torch.models.generate import decode_step, generate, init_cache

    prompt, new = _decode_prompt(args, model.cfg)
    generate(model, prompt[:, :8], 2)  # first calls outside the timing
    _, prefill = timed(args.device, lambda: generate(model, prompt, 1))
    tokens, full = timed(args.device, lambda: generate(model, prompt, new))
    gaps = []
    with torch.no_grad():
        cache = init_cache(model, prompt.shape[0], prompt.shape[1] + new, dtype=model.cfg.dtype, device=args.device)
        logits, cache = decode_step(model, prompt, cache, attend_len=prompt.shape[1])
        steps = [logits[:, -1]]
        for j in range(new - 1):
            logits, cache = decode_step(model, tokens[:, j:j + 1], cache, offset=prompt.shape[1] + j)
            steps.append(logits[:, 0])
        for lg in steps:
            top = lg.float().topk(2, dim=-1).values
            gaps.append((top[:, 0] - top[:, 1]).tolist())
    return {"tokens": tokens.tolist(), "gaps": [list(r) for r in zip(*gaps)],
            "ms_per_step": (full - prefill) / (new - 1) * 1e3}


def serve_run(args, model) -> dict:
    """chip_smoke.py phase 13 (d)'s burst through ``ServeEngine``: TTFT p50
    and decode tokens/s."""
    import numpy as np

    from dmlcloud_tpu_torch.serve import ServeEngine

    s = SERVE if args.preset == "1b" else dict(SERVE, requests=4, prompts=(8, 32), new=8, prefill_chunk=16)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, model.cfg.vocab_size, n) for n in rs.randint(s["prompts"][0], s["prompts"][1] + 1,
                                                                            s["requests"])]
    blocks = -(-(s["prompts"][1] + s["new"]) // s["block_size"])
    engine = ServeEngine(model, num_blocks=s["max_slots"] * blocks, max_slots=s["max_slots"],
                         block_size=s["block_size"], prefill_chunk=s["prefill_chunk"])
    engine.submit(prompts[0][:64], 2)
    engine.run()
    rids = [engine.submit(p, s["new"]) for p in prompts]
    sched = engine.scheduler
    decode_ms, rows = [], []
    sync(args.device)
    t0 = time.perf_counter()
    while not engine.idle:
        decode_only = not sched.prefilling and (sched.num_waiting == 0 or sched.active >= sched.max_slots)
        n = len(sched.running)
        s0 = time.perf_counter()
        engine.step()
        if decode_only and n:
            decode_ms.append((time.perf_counter() - s0) * 1e3)
            rows.append(n)
    wall = time.perf_counter() - t0
    seqs = [engine.sequence(r) for r in rids]
    if engine.leaked_blocks() or any(q.status != "ok" for q in seqs):
        raise AssertionError(f"serving ended with {engine.leaked_blocks()} leaked blocks")
    ttft = [(q.first_token - q.arrival) * 1e3 for q in seqs]
    return {"wall_s": wall, "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "decode_tokens_per_s": sum(rows) / sum(decode_ms) * 1e3 if decode_ms else None,
            "decode_step_ms": statistics.median(decode_ms) if decode_ms else None}


def _tie_check(got: list, want: dict) -> tuple[bool, list]:
    """Whether each row of ``got`` equals the one-card row up to its first
    difference, and that difference falls where the one-card gap is below
    ``TIE_GAP``; the first differing step of each row (None: none)."""
    first = []
    for g, w, gaps in zip(got, want["tokens"], want["gaps"]):
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        first.append(None if i is None else (i, gaps[i]))
    return all(f is None or f[1] < TIE_GAP for f in first), first


def _sharded_1b(args, mesh: str):
    from dmlcloud_tpu_torch.models.transformer import llama_partition_rules
    from dmlcloud_tpu_torch.parallel import mesh as mesh_lib

    model = _lm_1b(args)
    mesh_lib.shard_module(model, mesh_lib.create_mesh(mesh_lib.parse_mesh_axes(mesh), device=args.device),
                          llama_partition_rules())
    return model


def part_tp_decode(args, one: dict, failed: list) -> dict:
    out = {}
    for mesh in TP_MESHES:
        model = _sharded_1b(args, mesh)
        dec = decode_run(args, model)
        ok, first = _tie_check(dec["tokens"], one["decode"])
        serve = serve_run(args, model)
        out[mesh] = {"ms_per_step": dec["ms_per_step"], "first_diff": first, "tokens_match": ok, "serve": serve,
                     "local_kv_heads": model.local_kv_heads}
        log(f"[tp_decode] {mesh}: {model.local_kv_heads} KV heads per rank; greedy tokens against one card: first "
            f"differing step per row (step, one-card top-2 gap) {first}; {dec['ms_per_step']:.2f} ms per decode step "
            f"(one card {one['decode']['ms_per_step']:.2f}); engine burst: TTFT p50 {serve['ttft_p50_ms']:.1f} ms, "
            f"{serve['decode_tokens_per_s']:.1f} decode tokens/s, {serve['decode_step_ms']:.2f} ms per decode step "
            f"(one card: {one['serve']['ttft_p50_ms']:.1f} ms, {one['serve']['decode_tokens_per_s']:.1f} tokens/s)")
        if not ok:
            failed.append(f"tp_decode {mesh}: greedy tokens part from one card's at a gap >= {TIE_GAP}: {first}")
        del model
        _free(args)
    return out


def int8_single(args) -> dict:
    """One card: the 1b at ``precision="int8"`` (chip_smoke.py phase 17 (c)'s
    run) and the int8 1b's greedy decode."""
    from dmlcloud_tpu_torch.models.quant import quantize_tree

    _, stage = run_lm(lm_argv(args), int8=True)
    out = {"losses": [float(x) for x in stage.train_losses],
           "step_ms": float(stage.tracker["misc/train_step_avg_ms"][-1])}
    del stage
    _free(args)
    out["decode"] = decode_run(args, quantize_tree(_lm_1b(args)))
    _free(args)
    return out


def part_int8_mesh(args, one: dict, failed: list) -> dict:
    from dmlcloud_tpu_torch.models.quant import quantize_tree

    if args.device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    times = []
    _, stage = run_lm(lm_argv(args) + ["--mesh", INT8_MESH], int8=True,
                      on_stage=lambda s: times.extend([_timed_steps(args, s)]))
    losses = global_losses(stage)
    step = statistics.median(times[0][1:])
    peak = torch.cuda.max_memory_allocated() / 2**30 if args.device != "cpu" else None
    dev = [abs(a - b) for a, b in zip(losses, one["int8"]["losses"])]
    out = {"losses": losses, "max_abs_loss_diff": max(dev), "step_ms": step, "peak_gib": runtime.all_gather_object(peak),
           "amax_buffers": sum(n.endswith("quant_amax") for n, _ in stage.state.model.named_buffers())}
    log(f"[int8_mesh] int8 1b on {INT8_MESH}: losses {losses} (one card {one['int8']['losses']}), max |diff| "
        f"{max(dev):.3g}; steady step {step} ms (one card avg {one['int8']['step_ms']:.1f}); peak GiB per card "
        f"{out['peak_gib']}")
    if len(dev) != len(one["int8"]["losses"]) or not max(dev) <= LOSS_ATOL:
        failed.append(f"int8_mesh {INT8_MESH}: losses off the one-card int8 run by {max(dev)} (> {LOSS_ATOL})")
    del stage
    _free(args)
    qmodel = quantize_tree(_sharded_1b(args, INT8_DECODE_MESH))
    dec = decode_run(args, qmodel)
    ok, first = _tie_check(dec["tokens"], one["int8"]["decode"])
    out["decode"] = {"ms_per_step": dec["ms_per_step"], "first_diff": first, "tokens_match": ok}
    log(f"[int8_mesh] int8 1b decoding on {INT8_DECODE_MESH}: {dec['ms_per_step']:.2f} ms per step (one card "
        f"{one['int8']['decode']['ms_per_step']:.2f}); first differing step per row {first}")
    if not ok:
        failed.append(f"int8_mesh decode: greedy tokens part from one card's at a gap >= {TIE_GAP}: {first}")
    del qmodel
    _free(args)
    return out


def _remove_params_file(one: dict) -> None:
    """Delete the --single run's parameters and their directory (rank 0)."""
    if "params_file" in one:
        shutil.rmtree(os.path.dirname(one["params_file"]), ignore_errors=True)


def _free(args) -> None:
    import gc

    gc.collect()
    if args.device != "cpu":
        torch.cuda.empty_cache()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--single", action="store_true", help="the one-card reference run")
    parser.add_argument("--out", default=None, help="with --single: where its losses go (JSON)")
    parser.add_argument("--compare", default=None, help="the --single run's JSON to hold the N-card run against")
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--preset", default="1b", choices=["1b", "tiny"])
    parser.add_argument("--parts", default=",".join(PARTS), help=f"comma-separated, of {PARTS}")
    parser.add_argument("--elastic-out", default=None, help="with --compare: where the elastic save's record goes")
    parser.add_argument("--resume", default=None, help="continue the elastic save this record names")
    parser.add_argument("--mesh", default=None, help="with --resume: the mesh to resume on (default: none)")
    parser.add_argument("--delete-after", action="store_true", help="with --resume: delete the save afterwards")
    args = parser.parse_args(argv)
    parts = args.parts.split(",")
    if set(parts) - set(PARTS):
        parser.error(f"unknown parts {sorted(set(parts) - set(PARTS))}")
    device = runtime.resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    runtime.init_auto(args.device)
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()
        log(f"cards: {smi}")

    if args.resume:
        return resume_elastic(args)
    if args.single:
        if runtime.world_size() != 1 or not args.out:
            raise SystemExit("--single runs as one process and needs --out")
        t0 = time.perf_counter()
        result = {}
        if "meshes" in parts or "resume" in parts:
            _, stage = run_lm(lm_argv(args))
            # 5 GB for the 1b model, in a directory of its own under TMPDIR; the
            # --compare run deletes it once it has read it
            params_file = os.path.join(tempfile.mkdtemp(prefix="mesh_cards_one_"), "params.pt")
            torch.save({n: p.detach().cpu() for n, p in stage.state.model.named_parameters()}, params_file)
            result.update(losses=[float(x) for x in stage.train_losses], val=float(stage.tracker["val/loss"][-1]),
                          step_ms=float(stage.tracker["misc/train_step_avg_ms"][-1]), params_file=params_file)
            del stage
            _free(args)
        if "clip" in parts:
            result["clip"] = run_clip(args)
        if "resnet" in parts:
            result["resnet"] = run_resnet(args)
        if "ring" in parts:
            for label, window in (("ring", None), ("ring window", _ring_window(args))):
                _, stage = run_lm(ring_argv(args, window, attn="flash"))
                result[label] = {"losses": [float(x) for x in stage.train_losses],
                                 "step_ms": float(stage.tracker["misc/train_step_avg_ms"][-1])}
                del stage
                _free(args)
        if "moe" in parts:
            result["moe"] = run_moe(args, None, _moe_layers(args)[0])
        if "tp_decode" in parts:
            model = _lm_1b(args)
            result["decode"], result["serve"] = decode_run(args, model), serve_run(args, model)
            log(f"[tp_decode] one card: {result['decode']['ms_per_step']:.2f} ms per decode step; burst "
                f"{result['serve']}")
            del model
            _free(args)
        if "int8_mesh" in parts:
            result["int8"] = int8_single(args)
        result["wall_s"] = time.perf_counter() - t0
        with open(args.out, "w") as f:
            json.dump(result, f)
        log(json.dumps(result))
        return 0

    with open(args.compare) as f:
        one = json.load(f)
    world = runtime.world_size()
    log(f"backend {runtime._info.backend}, world {world}")
    failed: list[str] = []
    out = {"world": world, "one_card": {k: v for k, v in one.items() if k != "params_file"}}
    try:
        # the 8b model first: the measurement only four cards can give
        if "8b" in parts:
            out["8b"] = part_8b(args, failed)
        if "meshes" in parts or "resume" in parts:
            out["meshes"], uninterrupted = part_meshes(args, one, failed)
            if "resume" in parts:
                out["resume"] = part_resume(args, uninterrupted, failed)
        if "ring" in parts:
            out["ring"] = part_ring(args, one, failed)
        if "pipe" in parts:
            out["pipe"] = part_pipe(args, failed)
        if "elastic" in parts:
            out["elastic"] = part_elastic(args, failed, args.elastic_out)
        if "clip" in parts or "resnet" in parts:
            out.update(part_vision(args, one, failed))
        if "moe" in parts:
            out["moe"] = part_moe(args, one, failed)
        if "tp_decode" in parts:
            out["tp_decode"] = part_tp_decode(args, one, failed)
        if "int8_mesh" in parts:
            out["int8_mesh"] = part_int8_mesh(args, one, failed)
        if "compiled" in parts:
            out["compiled"] = part_compiled(args, out, failed)
    finally:
        if runtime.is_root():
            _remove_params_file(one)
    runtime.barrier("done", timeout=600)
    out["failed"] = failed
    log(json.dumps(out))
    runtime.deinitialize()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
