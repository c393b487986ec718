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
``resume``, ``ring``, ``pipe``, ``elastic``; ``--single`` runs only what the
chosen parts compare with. The last ``--resume`` call deletes the save.

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
   of steps 5-7 within ``LOSS_ATOL`` of the uninterrupted run's.

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

from dmlcloud_tpu_torch.examples import pod_llama_fsdp, train_lm  # noqa: E402
from dmlcloud_tpu_torch.ops import flash_attention as fa  # noqa: E402
from dmlcloud_tpu_torch.parallel import runtime  # noqa: E402

#: per-step losses of a mesh against one card: bf16 attention and matmuls,
#: reductions in another order (and bf16 partial sums under tensor parallelism)
LOSS_ATOL = 1e-2
MESHES = ["fsdp=4", "data=2,fsdp=2", "fsdp=2,model=2"]
PARTS = ["8b", "meshes", "resume", "ring", "pipe", "elastic"]
#: the ring's runs: the 1b model at T = 8192 on seq=4, without and with a window
RING_WINDOW = 4096
#: pipeline_apply against the sequential blocks: bf16 activations, the
#: gradients summed over microbatches in another order (chip_smoke's REL_TOL bf16)
PIPE_REL = 1e-2
PIPE_STAGES, PIPE_MICRO = 4, 8
ELASTIC_MESH, ELASTIC_SAVE = "fsdp=4", 4
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


def run_lm(argv: list[str], stop_after: int = 0, resume: bool = False, epoch_saves: bool = True):
    """One ``train_lm`` run; with ``stop_after`` its feed raises once that many
    batches were taken (after the step save there), which ends the run."""
    pipe, stage = train_lm.build(argv, resume=resume)
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
        if "ring" in parts:
            for label, window in (("ring", None), ("ring window", _ring_window(args))):
                _, stage = run_lm(ring_argv(args, window, attn="flash"))
                result[label] = {"losses": [float(x) for x in stage.train_losses],
                                 "step_ms": float(stage.tracker["misc/train_step_avg_ms"][-1])}
                del stage
                _free(args)
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
