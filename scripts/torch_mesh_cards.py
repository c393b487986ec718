"""FSDP2 and tensor parallelism of ``dmlcloud_tpu_torch`` across the cards of
one host, through NCCL, held against one card.

Run the one-card reference first, then the N-card run, which compares:

    python scripts/torch_mesh_cards.py --single --out one.json
    python -m torch.distributed.run --nproc_per_node=4 scripts/torch_mesh_cards.py --compare one.json

(build the kernels once before, or every process runs nvcc:
``python -c "from dmlcloud_tpu_torch.ops import flash_attention as fa; fa.build()"``).

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

``--device cpu --preset tiny`` runs parts 1 and 2 on the CPU over gloo (and
part 3 with the ``toy`` preset). Rank 0 prints the cards' names and power
limits and, as its last line, one JSON object with the numbers; any failed
check exits non-zero.
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

from dmlcloud_tpu_torch.examples import pod_llama_fsdp, train_lm  # noqa: E402
from dmlcloud_tpu_torch.parallel import runtime  # noqa: E402

#: per-step losses of a mesh against one card: bf16 attention and matmuls,
#: reductions in another order (and bf16 partial sums under tensor parallelism)
LOSS_ATOL = 1e-2
MESHES = ["fsdp=4", "data=2,fsdp=2", "fsdp=2,model=2"]
RESUME_MESH = "data=2,fsdp=2"
SAVE_EVERY, STOP_AFTER = 4, 4
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


class _Stop(Exception):
    """Raised by the feed of the run that stops after its step save."""


def run_lm(argv: list[str], stop_after: int = 0, resume: bool = False, epoch_saves: bool = True):
    """One ``train_lm`` run; with ``stop_after`` its feed raises once that many
    batches were taken (after the step save there), which ends the run."""
    pipe, stage = train_lm.build(argv, resume=resume)
    if not epoch_saves:
        stage.checkpoint_every = lambda: 0
    if stop_after:
        orig = stage.train_dataset

        def stopping():
            for i, batch in enumerate(orig()):
                if i == stop_after + 2:  # the feed reads 2 batches ahead of the step
                    raise _Stop("stop after the step save")
                yield batch

        stage.train_dataset = stopping
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
    if args.preset == "1b":
        argv = ["--mesh", "fsdp=-1", "--global-batch", "8", "--seq-len", "4096", "--remat", "--chunked-loss", "8192",
                "--steps-per-epoch", "6", "--device", args.device]
        tokens = 8 * 4096
    else:
        argv = ["--toy", "--mesh", "fsdp=-1", "--global-batch", "8", "--steps-per-epoch", "4", "--remat",
                "--chunked-loss", "200", "--lr", "1e-2", "--device", args.device]
        tokens = 8 * 64
    if args.device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe, stage = pod_llama_fsdp.build(argv)
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
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            inner(batch)
            torch.cuda.synchronize()
        prof_ms = _nccl_ms(prof)
    res = {"losses": losses, "step_times_ms": runtime.all_gather_object(step_times), "steady_ms": steady,
           "tokens_per_s": tokens / steady * 1e3, "tokens_per_s_per_card": tokens / steady * 1e3 / world,
           "step_flops": flops, "mfu_steady": flops / (steady / 1e3) / (PEAK_BF16_FLOPS * world),
           "mfu_epoch": float(stage.tracker["misc/mfu"][-1]) if "misc/mfu" in stage.tracker else None,
           "peak_gib": runtime.all_gather_object(peak), "profiled_step": runtime.all_gather_object(prof_ms),
           "n_params": sum(p.numel() for p in stage.state.model.parameters()), "wall_s": wall}
    log(f"[8b] {' '.join(argv)}: losses {losses}; steady step {steady:.1f} ms = {res['tokens_per_s']:.0f} tokens/s "
        f"({res['tokens_per_s_per_card']:.0f} per card); MFU at the steady step {res['mfu_steady']:.4f} "
        f"(misc/mfu over the epoch {res['mfu_epoch']}); peak GiB per card {res['peak_gib']}; profiled step (device ms) {prof_ms}; "
        f"{wall:.1f} s")
    if not (len(losses) == stage.config.steps_per_epoch and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        failed.append(f"8b losses not finite and falling: {losses}")
    del pipe, stage
    _free(args)
    return res


def _remove_params_file(one: dict) -> None:
    """Delete the --single run's parameters and their directory (rank 0)."""
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
    args = parser.parse_args(argv)
    device = runtime.resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    runtime.init_auto(args.device)
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()
        log(f"cards: {smi}")

    if args.single:
        if runtime.world_size() != 1 or not args.out:
            raise SystemExit("--single runs as one process and needs --out")
        t0 = time.perf_counter()
        _, stage = run_lm(lm_argv(args))
        # 5 GB for the 1b model, in a directory of its own under TMPDIR; the
        # --compare run deletes it once it has read it
        params_file = os.path.join(tempfile.mkdtemp(prefix="mesh_cards_one_"), "params.pt")
        torch.save({n: p.detach().cpu() for n, p in stage.state.model.named_parameters()}, params_file)
        result = {"losses": [float(x) for x in stage.train_losses], "val": float(stage.tracker["val/loss"][-1]),
                  "step_ms": float(stage.tracker["misc/train_step_avg_ms"][-1]), "params_file": params_file,
                  "wall_s": time.perf_counter() - t0}
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
        out["8b"] = part_8b(args, failed)
        out["meshes"], uninterrupted = part_meshes(args, one, failed)
        out["resume"] = part_resume(args, uninterrupted, failed)
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
