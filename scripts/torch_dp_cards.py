"""Data parallelism of ``dmlcloud_tpu_torch`` across the cards of one host,
through NCCL, held against one card.

Two parts, on N processes (one per card, launched by torchrun):

1. MNIST: ``examples.mnist`` for 2 epochs at batch 32 per process. With N
   processes, global batch k holds the same samples as batch k of one process
   at batch 32*N (``ShardedSequenceDataset`` gives rank r the strided shard
   ``idx[r::N]``), so the N-process run's per-step losses, averaged over the
   ranks, must equal a one-card run at batch 32*N within ``LOSS_TOL``, and the
   replicas' parameters must be bitwise equal at the end.
2. The 1b ``DecoderLM``'s gradient average: one backward on every card on the
   same tokens, then ``all_reduce_gradients`` over the N cards (the path the
   stage takes at world > 1), timed with CUDA events against its bound; the
   averaged gradients must be bitwise equal across the cards and within
   ``GRAD_REL`` in norm of each card's own gradient (the mean of N equal
   values, up to the rounding of the partial sums).

Run the one-card reference first, then the N-card run, which compares:

    python scripts/torch_dp_cards.py --single --world 4 --out one.json
    python -m torch.distributed.run --nproc_per_node=4 scripts/torch_dp_cards.py --compare one.json

``--device cpu --preset tiny`` runs both on the CPU over gloo. Rank 0 prints
the card's name and power limit and, as its last line, one JSON object with
the numbers; any failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlcloud_tpu_torch.examples import mnist  # noqa: E402
from dmlcloud_tpu_torch.examples.train_lm import PRESETS  # noqa: E402
from dmlcloud_tpu_torch.models.transformer import DecoderLM, TransformerConfig, lm_loss  # noqa: E402
from dmlcloud_tpu_torch.parallel import data_parallel, runtime  # noqa: E402

#: per-step losses, N processes against one: the two sum each global batch in
#: another order and may pick other convolution algorithms for batch 32 and
#: 32*N (the bound of chip_smoke.py's card-against-CPU MNIST phase)
LOSS_TOL = dict(rtol=1e-2, atol=1e-4)
#: the mean of N equal fp32 gradients against the gradient, in norm
GRAD_REL = 1e-6
#: H100 SXM data sheet: HBM3 bandwidth, and NVLink 4 at 900 GB/s per card,
#: both directions together
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S_EACH_WAY = 450e9


def log(msg: str) -> None:
    if runtime.is_root():
        print(msg, flush=True)


def mnist_losses(argv: list[str]) -> tuple[list[float], object]:
    """Every train step's loss of ``examples.mnist`` over all epochs, and the stage."""
    pipe, stage = mnist.build(argv)
    losses: list[float] = []
    stage.post_epoch = lambda: losses.extend(float(x) for x in stage.train_losses)
    pipe.run()
    return losses, stage


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def gradient_average(device: torch.device, preset: str) -> dict:
    """Part 2 on this rank: returns the checks' numbers and the timing."""
    cfg = TransformerConfig(vocab_size=32000 if preset == "1b" else 512,
                            max_seq_len=2048 if preset == "1b" else 64, attn_impl="flash", **PRESETS[preset])
    model = DecoderLM(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, cfg.max_seq_len), generator=gen, device=device)
    lm_loss(model(tokens), tokens).backward()
    params = list(model.parameters())
    local = [p.grad.clone() for p in params]
    data_parallel.all_reduce_gradients(params)
    sync(device)
    diff = math.sqrt(sum(float((p.grad - g).double().square().sum()) for p, g in zip(params, local)))
    norm = math.sqrt(sum(float(g.double().square().sum()) for g in local))
    digests = runtime.all_gather_object(digest(p.grad for p in params))
    del local
    times = []
    for i in range(7):
        if device.type == "cuda":
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            data_parallel.all_reduce_gradients(params)
            stop.record()
            stop.synchronize()
            ms = start.elapsed_time(stop)
        else:
            t0 = time.perf_counter()
            data_parallel.all_reduce_gradients(params)
            ms = (time.perf_counter() - t0) * 1e3
        if i >= 2:  # the first calls warm NCCL's channels up
            times.append(ms)
    n = sum(p.numel() for p in params)
    world = runtime.world_size()
    nbytes = 4 * n
    # least time: the ring all-reduce sends (and receives) 2 (N - 1) / N of the
    # bytes over each card's links, and every gradient is read and written once
    link_ms = 2 * (world - 1) / world * nbytes / NVLINK_BYTES_PER_S_EACH_WAY * 1e3
    hbm_ms = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    return {"params": n, "buckets": math.ceil(nbytes / data_parallel.BUCKET_BYTES), "rel_err": diff / norm,
            "bitwise_equal_across_ranks": len(set(digests)) == 1, "ms": statistics.median(times),
            "ms_all": times, "bound_ms": max(link_ms, hbm_ms), "bound_by": "links" if link_ms >= hbm_ms else "bytes"}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--single", action="store_true", help="the one-card reference run")
    parser.add_argument("--world", type=int, default=None, help="with --single: the N of the run it is for")
    parser.add_argument("--out", default=None, help="with --single: where its losses go (JSON)")
    parser.add_argument("--compare", default=None, help="the --single run's JSON to hold the N-card run against")
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--preset", default="1b", choices=sorted(PRESETS), help="the model of part 2")
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
        if runtime.world_size() != 1 or not args.world or not args.out:
            raise SystemExit("--single runs as one process and needs --world and --out")
        t0 = time.perf_counter()
        losses, stage = mnist_losses(["--epochs", "2", "--batch-size", str(32 * args.world), "--device", args.device])
        result = {"world": args.world, "losses": losses, "acc": float(stage.tracker["val/accuracy"][-1]),
                  "step_ms": float(stage.tracker["misc/train_step_avg_ms"][-1]), "wall_s": time.perf_counter() - t0}
        with open(args.out, "w") as f:
            json.dump(result, f)
        log(json.dumps({k: v for k, v in result.items() if k != "losses"}))
        return 0

    world = runtime.world_size()
    log(f"backend {runtime._info.backend}, world {world}")
    # part 1: MNIST on N processes
    t0 = time.perf_counter()
    losses, stage = mnist_losses(["--epochs", "2", "--batch-size", "32", "--device", args.device])
    wall = time.perf_counter() - t0
    per_rank = runtime.all_gather_object(losses)
    digests = runtime.all_gather_object(digest(stage.state.model.parameters()))
    mean = [sum(step) / world for step in zip(*per_rank)]
    step_ms = float(stage.tracker["misc/train_step_avg_ms"][-1])
    out = {"world": world, "mnist": {"steps": len(mean), "wall_s": wall, "step_ms": step_ms,
                                     "samples_s": 32 * world / step_ms * 1e3,
                                     "acc": float(stage.tracker["val/accuracy"][-1]),
                                     "replicas_bitwise_equal": len(set(digests)) == 1}}
    failed = [] if out["mnist"]["replicas_bitwise_equal"] else ["replicas differ after MNIST"]
    if args.compare:
        with open(args.compare) as f:
            one = json.load(f)
        if one["world"] != world or len(one["losses"]) != len(mean):
            failed.append(f"the one-card run is for world {one['world']} with {len(one['losses'])} steps")
        else:
            diff = [abs(a - b) for a, b in zip(mean, one["losses"])]
            outside = [i + 1 for i, (d, b) in enumerate(zip(diff, one["losses"]))
                       if d > LOSS_TOL["atol"] + LOSS_TOL["rtol"] * abs(b)]
            out["mnist"].update(one_card_step_ms=one["step_ms"], one_card_acc=one["acc"], max_abs_diff=max(diff),
                                max_rel_diff=max(d / abs(b) for d, b in zip(diff, one["losses"])),
                                steps_outside=outside[:10])
            if outside:
                failed.append(f"MNIST losses outside {LOSS_TOL} of the one-card run at steps {outside[:10]}")
    if not out["mnist"]["acc"] > 0.5:
        failed.append(f"MNIST val/accuracy {out['mnist']['acc']}")
    del stage

    # part 2: the 1b model's gradient average over the N cards
    out["gradient_average"] = ga = gradient_average(device, args.preset)
    if not ga["bitwise_equal_across_ranks"]:
        failed.append("averaged gradients differ across the ranks")
    if not ga["rel_err"] <= GRAD_REL:
        failed.append(f"the average of equal gradients is off by {ga['rel_err']:.3g} in norm")
    runtime.barrier("done", timeout=600)
    runtime.deinitialize()
    out["failed"] = failed
    log(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
