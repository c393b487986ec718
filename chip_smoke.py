#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dmlcloud_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository, with one card visible::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: the flash-attention kernels (``csrc/flash_attention.cu``, the
   CUDA-core K1-K3, and ``csrc/flash_attention_tc.cu``, the bf16 tensor-core
   K1-K3), one nvcc per source in parallel; every tensor-core kernel must be
   built and must not spill;
3. kernels: K1 (forward), K2 (dQ) and K3 (dK/dV), on the path
   ``kernel_route`` picks, each held against its plain PyTorch version on the
   card, at the training shapes (there also the CUDA-core K1-K3) and at
   small variants, and timed beside the plain version and
   ``scaled_dot_product_attention``; then the tensor-core K1-K3 at the mesh
   slice's shapes (the 8b model's, and the 1b model's heads on one of two
   tensor-parallel ranks), held and timed the same way;
4. model: the full-width 1b ``DecoderLM`` forward with the flash kernels
   against the dot path, on the same weights (2 layers, also on packed rows,
   and all 24 layers);
5. train: ``dmlcloud_tpu_torch.examples.train_lm.main`` trains the 1b model for
   7 steps and validates on 1 batch through the port's ``TrainingPipeline``,
   fed by ``device_iterator`` at depth 2 (pinned copies on a copy stream);
   every kernel's launch count is read around this run, the main path, and
   must show the tensor-core K1-K3 and no CUDA-core kernel;
6. steady: three more synchronised train steps, and one under
   ``torch.profiler`` for the split of the step's device time;
7. resume: phase 5's run again with ``--ema 0.999 --save-every-steps 4``,
   three times: uninterrupted (C); with a checkpoint directory and preemption
   handling, sending itself SIGUSR1 once its feed has read past batch 3, so
   that it drains at the step-4 save (P); and resumed from P's directory (R), which must skip 4
   batches, launch only the tensor-core K1-K3, and end with the step, the
   parameters, the EMA shadow, the AdamW moments and count, and the losses of
   steps 5-7 and of validation bitwise equal to C's. It prints the state bytes
   per save, the disk, the seconds and GB/s of each save (the blocking part
   and the background commit) and of the restore, and the EMA pass's time per
   step. Its directories live under a ``tempfile.mkdtemp()`` that it removes;
8. stage: phase 5's run again through ``examples.train_lm.build``, with the
   stage's knobs set on the instance: (a) with ``device_prefetch() = 0`` and
   with ``host_prefetch() = 2``, each bitwise equal to phase 5 in every
   step's loss and ``val/loss`` (what a missing stream wait would break), and
   one batch's host-to-device copy timed from pageable and from pinned
   memory; (b) with ``gradient_accumulation() = 2``, ``--mfu`` and the flight
   recorder armed: exact launch counts, the step-1 loss within 1e-2 of phase
   5's, peak memory under phase 5's bound, the steady step, and the gradients
   of one step with 2 microbatches against 1 within ``REL_TOL`` bf16 in norm;
   (c) ``misc/mfu`` against the formula recomputed here; (d) the journal,
   its Chrome trace, ``goodput.json``, the goodput buckets, no forensics
   dump, and the recorder's host cost per step;
9. mnist: ``dmlcloud_tpu_torch.examples.mnist`` for 2 epochs at batch 32 on
   the synthetic digits, on the card and then on the CPU: every step's loss
   within ``MNIST_LOSS_TOL`` of the CPU's, validation accuracy above
   ``MNIST_MIN_ACC``, the steady samples/s;
10. nccl: a one-rank NCCL process group from the port's ``init_auto`` over
   env://; the data-parallel gradient average (``reduce_gradient_buckets``)
   on the 1b model's gradients after one backward and the coalesced parameter
   broadcast (``broadcast_buckets``) on its parameters, each bitwise unchanged
   (an average or a broadcast over one rank) and timed against its bound by
   bytes; the group is torn down before the result line;
11. mesh: the mesh path on one card: (a) phase 5's run with ``--mesh fsdp=1``
   (``fully_shard`` over a one-rank NCCL mesh; losses against phase 5's,
   launches, peak memory); (b) ``examples.pod_llama_fsdp`` at the 8b model's
   full width with its depth cut to 2 layers, ``--remat --chunked-loss
   8192``, 3 steps of one 4096-token sequence (finite losses, step 1 near
   ln(vocab) + 1/2, K1-K3 launches); (c) ``chunked_lm_loss`` against ``lm_loss`` at
   vocab 128256, value and gradients at fp32 tolerance;
12. seq and pipe: (a) the tensor-core K1-K3 in the forms only the ring's hops
   use, at the 1b model's heads with one 2048-token block per hop (B=1, 16/8
   heads of 128): ``causal=False``, the causal diagonal, and the shifted
   windows of ``window=4096`` one and two hops back (cutoffs 2048 and 0, the
   second with a dead row) and of ``window=3000`` two hops back (cutoff -1096,
   dead rows), each held against its plain version with an lse cotangent and
   timed beside its bound and ``scaled_dot_product_attention`` (an explicit
   boolean mask for a shifted window); (b) phase 5's run with ``--attn ring
   --mesh seq=1`` (ring attention over a one-rank NCCL ``seq`` group: the
   diagonal hop only), losses within ``RING_LOSS_ATOL`` of phase 5's and
   whether bitwise, the same launches; (c) ``pipeline_apply`` over a one-rank
   NCCL ``pipe`` group, one stage of 6 of the 1b model's ``DecoderBlock``s on
   4 microbatches of one 2048-token row, against the same blocks run on the
   whole batch: outputs and gradients within ``REL_TOL`` bf16 in norm, launches;
13. serve: the decode and serving path. (a) ``scatter_tokens``/``gather_pages``
   on CUDA tensors with sentinel rows, positions past the table and negative
   positions, bitwise equal to the same calls on the CPU (a device-side assert
   ends the run); (b) phase 5's run with ``--sample 32``: the same K1-K3
   launches as phase 5 (decoding launches none), then the prompt and the
   greedy tokens through the no-cache dot path of the same model: each decode
   step's logits within ``REL_TOL`` fp32 in norm of that forward's in an fp32
   twin of the weights, and in bf16 within the larger of ``REL_TOL`` bf16 and
   the bf16 forward's distance from the fp32 one; (c) the 1b
   width in fp32 at 2 layers: 8 ragged requests through ``ServeEngine``
   (4 slots, blocks of 16, prefill chunks of 128), each output equal to the
   serial ``generate`` of its prompt (a row may differ only where the serial
   run's top-2 logit margin is under ``TIE_MARGIN``: a tie), no leaked block;
   (d) the full 1b model in bf16 serving 16 requests (prompts of 128-1024
   tokens, 128 new each; 8 slots, prefill chunks of 256): TTFT p50/p99, the
   decode tokens/s and ms per decode step, the pool's GiB, peak memory, one
   decode step under ``torch.profiler`` (device busy against wall), then
   ``beam_search`` with 4 beams on two prompts;
14. vision and encoders. (a) the tensor-core K1-K3 in BERT's form (B=32,
   T=512, 12/12 heads of 64, bf16, ``causal=False``, segment ids from a
   keep-mask with real lengths 64-512), each held against its plain version
   and timed beside it, its bound on the kept pairs and
   ``scaled_dot_product_attention`` with the equivalent boolean mask, added to
   the kernels line; (b) BERT-base classification with ``attn_impl="flash"``:
   hidden states at real positions against the dot path's, then 4 AdamW steps
   of 32 padded rows through the ``TrainingPipeline`` with exactly 12 launches
   each of the tensor-core K1-K3 per step and none of the CUDA-core kernels,
   the steady step, real tokens/s, peak memory, one profiled step; (c)
   ResNet-50 at 224x224, batch 256, bf16, ``sgd(0.1, momentum=0.9)`` through
   the pipeline: steady images/s, ``misc/mfu`` (3 x 8.2e9 FLOP per image),
   peak memory, a plain hand-written loop of the same model and the ratio;
   (d) ResNet-18 fp32 3 steps on the card against the CPU (losses and running
   statistics within ``RESNET_CARD_REL``, a TF32-on control logged beside),
   then under ``enable_determinism`` a preempted-and-resumed run bitwise equal
   to an uninterrupted one, running statistics included; (e) the vit-l
   preset's widths at 2+2 blocks, bf16 on the card against fp32 on the CPU
   within ``CLIP_CARD_REL``, then ``examples.pod_clip_vit`` at the vit-l
   preset, 64 pairs per step, 8 steps: finite falling losses, accuracy,
   steady step, pairs/s, peak memory, and ``--mesh fsdp=1`` bitwise equal;
15. data: (a) the port's host library (``native/pack.cpp``,
   ``interleave.cpp``) built with g++: 200k lognormal documents packed into
   2048-token rows and 32 batches interleaved in windows of 8, each
   bit-identical to the Python/numpy path and timed beside it, the library's
   call counts showing the native path was taken; (b) a ``.dmlshard`` corpus
   (vocab 32000, lognormal lengths median 600 and sigma 1.0 clipped to
   [16, 8192], seed 0; 16 shards of 2**22 tokens) written by
   ``scripts/torch_build_corpus.py``'s generator under a ``tempfile.mkdtemp()``
   that the phase removes: build and ``verify()`` seconds, the
   ``ShardReader`` rate and both packers' rates against the 1b step's token
   consumption (phase 6), and a reader cursor saved at world 4 resuming two
   world-2 readers; (c) ``examples.train_lm --corpus`` trains the full-width
   1b model 7 steps on ``ShardReader -> pack_stream(2048, pack_window=512) ->
   batch(4) -> to_device(prefetch=2)``: exactly 168 launches each of the
   tensor-core K1-K3 and none of the CUDA-core kernels, finite losses, step 1
   within ``DATA_FIRST_LOSS_TOL`` of ln(32000) + 1/2, the pad fraction,
   ``misc/host_stall_ms``, the steady step against phase 6's and the idle
   share of one profiled step whose batch comes from the feed; (d) the same
   path at 4 layers with step saves every 4 steps to a ``memory://`` run
   directory (DCP through ``FsspecWriter``): uninterrupted (C), preempted by
   SIGUSR1 after step 3 (P), resumed (R): R fast-forwards the pipeline from
   the step sidecar's ``"data"`` (its ``log.txt`` says so, and no batch is
   skipped) and ends bitwise equal to C (parameters, AdamW moments and count,
   losses of steps 5-7); ``log.txt`` under the URL holds both attempts and
   ``requeue.json`` reads back;
16. compiled step: (a) phase 5's run with ``precompile=True`` and
   ``compile_cache=`` a fresh directory, in a fresh process (cold): the step
   as ``torch.compile`` regions (Inductor) with K1-K3 as custom ops, warmed
   on zeros before the data loop; ``misc/compile_ms``, 0 graph breaks, the
   data loop's launches equal to phase 5's (the precompile's own launches
   printed beside), step-1 loss within 0.01 of ``PR1_FIRST_LOSS``, every loss
   within ``COMPILED_LOSS_ATOL`` of phase 5's, peak memory under
   ``PR1_PEAK_GIB``, the steady step, its idle share and device events
   against phase 6's eager step; then ``utils.profiling.profile_steps`` over 2
   compiled steps, ``roofline`` and ``format_roofline`` printed, the flash
   kernels' rows counting the launches ``LAUNCHES`` counted, and
   ``flops_from_compiled`` beside ``6 N D``; (b) the same command in a second
   fresh process on the same cache directory (warm): cache hits and no miss
   for the train step, ``misc/compile_ms`` below (a)'s, the losses bitwise
   equal to (a)'s (both processes train with deterministic algorithms, warn
   only: Inductor's embedding backward would otherwise add with atomics; the
   graphs are guarded on that mode, so the steady step and the profile run
   with it too); (c)
   ragged batches of sizes ``RAGGED_SIZES`` through a precompiled linear
   regression on the card, 2 epochs, with buckets ``RAGGED_BUCKETS`` (at most
   3 signatures, ``misc/recompiles`` [0, 0]) and without (4 signatures,
   recompiles in epoch 1);
17. int8, speculative, LoRA: (a) ``quantize_tree`` of the bf16 1b model
   (seed 0), ``quantized_size`` and the resident weight GiB of both models,
   ``generate`` of 8 rows x 128 prompt tokens, 128 new greedy, on each: ms per
   decode step, peak memory, the fused int8 path's call count, the greedy
   agreement; one decode step's logits on the int8 dense path against the
   plain one (fp32 dequantized weights, fp32 matmul) within ``TOL``/``REL_TOL``
   bf16; ``ServeEngine`` on the int8 model with phase 13's burst: TTFT p50,
   decode tokens/s, 0 leaked blocks; (b) ``speculative_generate`` with the bf16
   1b as target and its random 1-layer full-width twin as draft, k=4, 4 rows x
   128 prompt tokens, 64 new greedy: rounds, accept rate, ms per token against
   plain ``generate``, the token agreement and each mismatch's top-2 gap; then
   the fp32 1b width at 2 layers with a random and a perfect draft: tokens equal
   to ``generate``'s but at ties, the counts on the round algebra; (d) per-row
   adapters (4 tenants, rank 16, ``in_axes=1``) on the 1b forward, each row
   within ``TOL``/``REL_TOL`` bf16 of its tenant's merged model, then an
   adapters-only finetune of the 1b (``LoraModel``, 4 steps): base bitwise
   unchanged, optimizer-state bytes, ms per step, peak memory; (c) phase 5's
   run at ``precision="int8"`` (set on the stage): launches equal to phase
   5's, every loss within ``INT8_LOSS_REL`` of phase 5's, the steady step and
   peak memory; ``quant_train_dot`` at the MLP's shape against its fp32
   fake-quant plain version (``y``, ``dx`` at ``TOL``/``REL_TOL`` bf16, ``dw`` at
   fp32);
18. MoE, the 1b-moe configuration (the 1b preset with 8 experts, top-2,
   capacity factor 1.25, in every second block: ``MOE``): (a) one
   ``MoEMLP`` at its width (D 2048, M 5632, E 8) on 4 x 2048 bf16 tokens, the
   index dispatch against the one-hot plain version (output and the
   gradients of the input and of all four parameter groups within
   ``TOL``/``REL_TOL`` bf16), the capacity, the dropped (token, choice) share
   and both forms' ms forward and forward+backward; (b) 1b-moe at 8 layers
   (4 MoE blocks) through a ``TrainingPipeline`` whose step returns
   ``lm_loss + total_aux_loss``: 6 AdamW steps of 4 x 2048 tokens with finite
   losses, a finite positive aux loss, and exactly 8 launches each of the
   tensor-core K1-K3 per step and none of the CUDA-core kernels; the steady
   step, tokens/s, peak memory and one profiled step; (c) an fp32 twin at 2
   layers: each greedy decode step's logits within ``REL_TOL`` fp32 in norm
   of the no-cache forward's; then ``generate`` on the bf16 1b-moe (8 rows x
   128 prompt tokens, 64 new), ms per step; (d) ``quantize_tree`` of it (the
   routers quantized): resident GiB against bf16, ``generate`` on the int8
   model;
19. serving modes, the bf16 1b (seed 0) through ``ServeEngine`` (8 slots,
   blocks of 16, prefill chunks of 256): (a) 16 requests sharing one
   768-token prefix (suffixes of 64-256, 128 new) with and without
   ``prefix_cache``, after the prefix alone as a warm-up: prefill tokens saved
   (must be 16 x 768), the COW fork of an exact duplicate of the prefix (must
   be 1, counted from the journal's ``cow_fork`` spans), TTFT p50/p99, decode
   tokens/s, 0 leaked blocks and locks, and the greedy agreement of the two
   runs with each parting's top-2 gap (a parting at a gap of
   ``BF16_TIE_GAP`` or more fails) and the median gap of the compared steps;
   (b) ``spec_k=4`` with a self-draft and with a random 1-layer full-width
   draft, (c) ``medusa_k=4`` with the heads warm-started from the LM head,
   each on 8 requests (prompts 128-256, 64 new) beside the plain engine on
   the same requests, each engine's burst served twice in the order plain,
   the modes, the modes backwards, plain: accept rate, ms per token in both
   bursts, agreement with the plain run, 0 leaked blocks in both pools, and
   one decode step or round of the 8 rows under ``torch.profiler``; (d) 4
   rank-16 tenants and the base through one engine, each tenant's tokens
   against ``generate`` on its merged model (agreement, partings' gaps); (e)
   ``metrics=True``, a TTFT ``SLO``, the prefix cache and a
   ``ChaosMonkey(seed=7)`` drill over 12 requests: every request terminal,
   some ``ok``, ``assert_consistent()`` after every step, 0 leaked blocks;
   then ``drain()`` into a ``tempfile.mkdtemp()`` run directory (removed)
   writing ``requeue.json``, and one scrape through ``MetricsServer`` on
   ``127.0.0.1``; (f) the modes of (a)-(d) in fp32 at the 1b width with 2
   layers (the prefix cache, spec self-draft with it, the 1-layer draft,
   Medusa with the cache, 2 tenants and the base with the cache and under
   spec): every token equal to serial ``generate``'s on the (merged) model
   but at a top-2 margin under ``TIE_MARGIN``, the prefill tokens saved, 0
   leaked blocks and locks; and a tenant served with its ``b`` doubled,
   which must part from its merged model at a margin of ``TIE_MARGIN`` or
   more;
20. router: phase 19's bf16 1b behind a ``Router`` of three ``ServeEngine``
   replicas on one card (each its own pool: 8 slots, blocks of 16, prefill
   chunks of 256; all on the router's clock), replaying
   ``BENCH_serve_router_pr15.json``'s drill at the 1b's sizes in real time
   (12 hot requests at a mean interarrival of 0.01 s, 6 cold from 0.05 s,
   0.15 s apart, prompts of 128/256/512, 64 or 128 new; ``r2`` killed once 5
   requests are terminal, ``r1`` drained after 10; heartbeat 5 s, 3 retries,
   backoff 0.01 s) under a span journal: (a) every request ``ok``, at least
   one failover and every failover the planted kill's, 0 leaked blocks on
   every replica, the drain's ``requeue.json`` clean, no orphan span in
   ``linked_trace_report``, one ``metrics_text()`` page with the ``r0``-``r2``
   series, no K1-K3 launch, and the greedy tokens against a fault-free
   single engine under ``BF16_TIE_GAP``; hot and cold TTFT p50/p99, the
   failed-over p99, decode tokens/s, the router step's host ms beside its
   replicas' step ms; a replica step that raises what was not planted ends
   the run with its traceback; (b) the fp32 1b width at 2 layers through the
   same drill, every token equal to serial ``generate``'s but at a
   ``TIE_MARGIN`` tie;
21. HF import: (a) a HF-named Llama state dict at the 1b geometry (24
   layers, intermediate 5632) from a seeded generator, with a
   ``SimpleNamespace`` of HF's config names, through
   ``transformer_config_from_hf`` -> ``llama_params_from_hf`` ->
   ``load_flax_params`` into a ``DecoderLM`` on the card -> ``to_flax_params``
   -> ``hf_state_dict_from_params``: bitwise equal to the input; (b) at 2
   layers, plain and with llama3 rope scaling, the card's fp32 logits within
   ``TOL``/``REL_TOL`` fp32 of the CPU's; (c) ``examples.finetune_hf``'s stage
   on that import in bf16 with ``attn_impl="flash"``, 4 x 2048 packed rows: 2
   launches of each tensor-core K1-K3 per step and none of the CUDA-core
   kernels, the step ms and the losses.

The last line of standard output is one JSON object with ``"ok": true``. With no
card, or without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

#: tests/test_kernel_numerics.py:28 -- both sides accumulate in fp32; bf16
#: rounds operands and outputs to 8 mantissa bits
TOL = {"float32": dict(atol=5e-5, rtol=5e-5), "bfloat16": dict(atol=6e-2, rtol=6e-2)}
#: norm-relative bound ||got - want|| / ||want|| held beside TOL. At the training
#: shapes most outputs are ~1e-2 in size, below TOL bf16's atol, so TOL alone
#: would pass a kernel that is tens of percent off; rounding the outputs to
#: bf16 alone gives about 2e-3.
REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
#: H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
#: the attention shapes of training: the 1b preset at batch 4, sequence 2048
TRAIN_SHAPES = dict(b=4, t=2048, h=16, kh=8, d=128)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def max_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def rel_err(torch, got, want) -> float:
    """``||got - want|| / ||want||`` (0 when both are zero)."""
    diff, norm = float((got.float() - want.float()).norm()), float(want.float().norm())
    return diff / norm if norm else (0.0 if diff == 0 else math.inf)


def assert_close(torch, got, want, dtype_name: str, what: str) -> tuple[float, float]:
    """Hold ``got`` to ``want`` within TOL elementwise and REL_TOL in norm;
    returns (max abs err, norm-relative err)."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: kernel output is not finite")
    err, rel = max_err(torch, got, want), rel_err(torch, got, want)
    tol = TOL[dtype_name]
    if not torch.allclose(got.float(), want.float(), atol=tol["atol"], rtol=tol["rtol"]):
        raise AssertionError(f"{what}: kernel disagrees with its plain version (max abs err {err:.3g}, tol {tol})")
    if not rel <= REL_TOL[dtype_name]:
        raise AssertionError(f"{what}: kernel disagrees with its plain version "
                             f"(norm-relative err {rel:.3g} > {REL_TOL[dtype_name]})")
    return err, rel


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} ({smi}); torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"python {sys.version.split()[0]}")
    # full fp32 matmuls for every comparison below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"name": name, "smi": smi}


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def ptxas_report(build_log: str) -> dict[str, tuple[int, int]]:
    """``{kernel entry: (registers, spilled bytes)}`` from nvcc's ``-Xptxas -v`` output."""
    report, entry, spill = {}, None, 0
    for line in build_log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            entry, spill = m.group(1), 0
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)) and entry:
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            report[entry] = (int(m.group(1)), spill)
            entry = None
    return report


#: every tensor-core kernel instance the build must produce (head dim 64 and 128)
TC_KERNELS = [f"{name}ILi{d}E" for name in ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
                                             "flash_bwd_dkv_tc_kernel") for d in (64, 128)]


def phase_build(fa) -> None:
    t0 = time.perf_counter()
    paths = fa.build()
    log(f"[build] {', '.join(p.name for p in paths.values())} in {time.perf_counter() - t0:.1f} s "
        f"(one nvcc per source, in parallel)")
    report = ptxas_report(fa.build_log)
    simt = [v for k, v in report.items() if "_tc_" not in k]
    if simt:
        log(f"[build] ptxas, CUDA-core kernels: {len(simt)} instances, {min(r for r, _ in simt)}-"
            f"{max(r for r, _ in simt)} registers, {sum(s for _, s in simt)} bytes spilled")
    for entry, (regs, spill) in sorted(report.items()):
        if "_tc_" in entry:
            log(f"[build] ptxas, tensor-core kernel {entry}: {regs} registers, {spill} bytes spilled")
            if spill:
                raise AssertionError(f"{entry} spills {spill} bytes")
    missing = [k for k in TC_KERNELS if not any(k in entry for entry in report)]
    if missing:
        raise AssertionError(f"ptxas reported no tensor-core kernel {missing}")
    for line in fa.build_log.splitlines():
        if "wgmma" in line or "warning" in line.lower():
            log(f"[build] nvcc: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def _inputs(torch, dtype, b, t, h, kh, d, s=None, seed=0, qk_scale=0.5):
    """q, k, v, dO; scores have std ``qk_scale**2`` (0.5: a near-uniform
    softmax, 2.0: a peaked one)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = t if s is None else s

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    return rnd(b, t, h, d, scale=qk_scale), rnd(b, s, kh, d, scale=qk_scale), rnd(b, s, kh, d), rnd(b, t, h, d)


def _segments(torch, b, t, seed=1):
    """Packed-row ids: a few segments of random lengths per row, the tail padded (0)."""
    g = torch.Generator().manual_seed(seed)
    seg = torch.zeros((b, t), dtype=torch.int32)
    for row in range(b):
        pos, sid = 0, 1
        while pos < t - t // 8:
            n = int(torch.randint(max(2, t // 8), max(3, t // 2), (1,), generator=g))
            seg[row, pos : pos + n] = sid
            pos, sid = pos + n, sid + 1
    return seg.cuda()


def check_case(torch, fa, name, dtype, b, t, h, kh, d, causal, window, with_seg, s=None, qk_scale=0.5,
               also_simt=False, lse_cotangent=False):
    """K1, K2 and K3 (the kernels ``kernel_route`` picks) against their plain
    versions on one set of inputs; with ``also_simt`` the CUDA-core K1-K3
    too; with ``lse_cotangent`` a random cotangent of the lse is folded into
    delta (as the ring's merge gives one). Returns the errors (max abs,
    norm-relative) by kernel and the inputs."""
    q, k, v, do = _inputs(torch, dtype, b, t, h, kh, d, s=s, qk_scale=qk_scale)
    seg = _segments(torch, b, t) if with_seg else None
    scale = 1.0 / math.sqrt(d)
    dname = str(dtype).replace("torch.", "")
    args = (seg, causal, scale, window)
    route = fa.kernel_route(dtype, d)
    fwds = {route: fa.attn_fwd_tc if route == "tc" else fa.attn_fwd_simt}
    dqs = {route: fa.attn_dq_tc if route == "tc" else fa.attn_dq_simt}
    dkvs = {route: fa.attn_dkv_tc if route == "tc" else fa.attn_dkv_simt}
    if also_simt:
        fwds["simt"], dqs["simt"], dkvs["simt"] = fa.attn_fwd_simt, fa.attn_dq_simt, fa.attn_dkv_simt

    out_p, lse_p = fa.attn_fwd_plain(q, k, v, *args)
    g_lse = None
    if lse_cotangent:
        g_lse = torch.randn(b * h, t, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
    # the backward kernels take the same saved statistics as their plain versions
    delta = fa.softmax_delta(out_p, do, g_lse)
    bwd = (q, k, v, do, lse_p, delta, *args)
    dq_p = fa.attn_dq_plain(*bwd)
    dk_p, dv_p = fa.attn_dkv_plain(*bwd)
    errs = {}
    for kind, fwd in fwds.items():
        out, lse = fwd(q, k, v, *args)
        torch.cuda.synchronize()
        errs[f"K1 {kind}"] = assert_close(torch, out, out_p, dname, f"{name} K1 {kind} out")
        # both sides take lse in fp32 from the same operands, whatever their dtype
        errs[f"K1 {kind} lse"] = assert_close(torch, lse, lse_p, "float32", f"{name} K1 {kind} lse")
    for kind, dq_fn in dqs.items():
        dq = dq_fn(*bwd)
        torch.cuda.synchronize()
        errs[f"K2 {kind}"] = assert_close(torch, dq, dq_p, dname, f"{name} K2 {kind} dq")
    for kind, dkv in dkvs.items():
        dk, dv = dkv(*bwd)
        torch.cuda.synchronize()
        errs[f"K3 {kind} dk"] = assert_close(torch, dk, dk_p, dname, f"{name} K3 {kind} dk")
        errs[f"K3 {kind} dv"] = assert_close(torch, dv, dv_p, dname, f"{name} K3 {kind} dv")
    worst = max(rel for _, rel in errs.values())
    log(f"[kernels] {name:<34} " + "  ".join(f"{key} {err:.2e}/{rel:.2e}" for key, (err, rel) in errs.items())
        + f"  (max abs/norm-relative; norm-relative margin {REL_TOL[dname] / max(worst, 1e-30):.3g}x)")
    return errs, (q, k, v, do, seg, out_p, lse_p, delta)


SMALL_CASES = [
    # name, dtype, b, t, h, kh, d, causal, window, segment ids, s
    # fp32 and head dims 16/32: the CUDA-core kernels
    ("fp32 causal gqa", "float32", 2, 256, 8, 2, 128, True, None, False, None),
    ("fp32 window24", "float32", 2, 192, 8, 2, 64, True, 24, False, None),
    ("fp32 segment_ids", "float32", 2, 256, 4, 2, 64, True, None, True, None),
    ("fp32 full", "float32", 2, 200, 4, 2, 64, False, None, False, None),
    ("fp32 full t100 s160", "float32", 2, 100, 4, 1, 32, False, None, False, 160),
    ("fp32 ragged t40", "float32", 2, 40, 4, 4, 16, True, None, False, None),
    ("fp32 ragged t56", "float32", 2, 56, 4, 4, 16, True, None, False, None),
    ("fp32 ragged t96", "float32", 2, 96, 4, 4, 16, True, None, False, None),
    ("fp32 dead rows (window -8)", "float32", 2, 96, 4, 2, 32, False, -8, False, None),
    # bf16 with head dim 64/128: the tensor-core kernels, GQA groups 1, 2, 8
    ("bf16 causal d128 g2", "bfloat16", 2, 256, 8, 4, 128, True, None, False, None),
    ("bf16 causal d64 g8", "bfloat16", 2, 256, 8, 1, 64, True, None, False, None),
    ("bf16 causal d128 g1", "bfloat16", 1, 384, 4, 4, 128, True, None, False, None),
    ("bf16 ragged t40 d64 g2", "bfloat16", 2, 40, 4, 2, 64, True, None, False, None),
    ("bf16 ragged t96 d128 g1", "bfloat16", 2, 96, 4, 4, 128, True, None, False, None),
    ("bf16 ragged t200 d128 g8", "bfloat16", 1, 200, 8, 1, 128, True, None, False, None),
    ("bf16 ragged t200 d64 g1", "bfloat16", 2, 200, 2, 2, 64, True, None, False, None),
    ("bf16 full t100 s160 d64 g2", "bfloat16", 2, 100, 4, 2, 64, False, None, False, 160),
    ("bf16 full t100 s160 d128 g8", "bfloat16", 1, 100, 8, 1, 128, False, None, False, 160),
    ("bf16 segment_ids d128 g2", "bfloat16", 2, 256, 4, 2, 128, True, None, True, None),
    ("bf16 segment_ids d64 g8 t200", "bfloat16", 1, 200, 8, 1, 64, True, None, True, None),
    ("bf16 window24 d64 g2", "bfloat16", 2, 192, 8, 2, 64, True, 24, False, None),
    ("bf16 window24 d128 g8 t300", "bfloat16", 1, 300, 8, 1, 128, True, 24, False, None),
    ("bf16 segment_ids window24 d128", "bfloat16", 2, 256, 4, 2, 128, True, 24, True, None),
    ("bf16 dead rows (window -8) d64 g2", "bfloat16", 2, 96, 4, 2, 64, False, -8, False, None),
    ("bf16 dead rows (window -8) d128 g1", "bfloat16", 2, 200, 4, 4, 128, False, -8, False, None),
]


def _live_pairs(t: int, s: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs a mask keeps: ``k <= q`` when causal, ``q - k < window``."""
    total = 0
    for q in range(t):
        hi = min(s, q + 1) if causal else s
        lo = 0 if window is None else max(0, q - window + 1)
        total += max(0, hi - lo)
    return total


def _work(b, t, h, kh, d, causal: bool = True, window: int | None = None, pairs: int | None = None,
          seg: bool = False) -> dict[str, tuple[int, int]]:
    """(operations, bytes) of K1-K3 on bf16 attention (T == S), counting the
    pairs the mask keeps (``pairs``, over all rows and heads, when the mask
    comes from segment ids): each input read once, each output written once
    (for the bounds: operations over the bf16 tensor-core peak, bytes over HBM
    bandwidth); ``seg`` adds the int32 segment ids to each kernel's reads."""
    if pairs is None:
        pairs = b * h * _live_pairs(t, t, causal, window)
    e = 2  # bytes per bf16 element
    q_bytes, kv_bytes, stat_bytes = b * t * h * d * e, b * t * kh * d * e, b * h * t * 4
    seg_bytes = b * t * 4 if seg else 0
    return {
        # QK^T and PV
        "K1": (4 * d * pairs, 2 * q_bytes + 2 * kv_bytes + stat_bytes + seg_bytes),
        # QK^T, dO V^T, dS K
        "K2": (6 * d * pairs, 3 * q_bytes + 2 * kv_bytes + 2 * stat_bytes + seg_bytes),
        # QK^T, dO V^T, P^T dO, dS^T Q
        "K3": (8 * d * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * stat_bytes + seg_bytes),
    }


#: the attention shapes of the mesh slice: the 8b model's (B=1 per card under
#: fsdp, T=4096, 32/8 heads) and the 1b model's per-rank heads under model=2
MESH_SHAPES = {"8b train bf16 causal gqa 32->8": dict(b=1, t=4096, h=32, kh=8, d=128),
               "1b model=2 local heads 8->4": dict(b=4, t=2048, h=8, kh=4, d=128)}


def time_tc(torch, fa, errs, inputs, causal: bool, window: int | None, plain_reps: int = 5) -> dict:
    """The tensor-core K1-K3 on ``check_case``'s inputs, each timed beside its
    plain version, its bound (the pairs the mask keeps) and
    ``scaled_dot_product_attention`` (a window as an explicit boolean mask;
    rows with nothing to attend to come out NaN there). Rows by kernel."""
    import torch.nn.functional as F

    q, k, v, do, seg, out_p, lse_p, delta = inputs
    b, t, h, d = q.shape
    args = (None, causal, 1.0 / math.sqrt(d), window)
    bwd = (q, k, v, do, lse_p, delta, *args)
    times = {"K1": (cuda_ms(torch, lambda: fa.attn_fwd_tc(q, k, v, *args)),
                    cuda_ms(torch, lambda: fa.attn_fwd_plain(q, k, v, *args), reps=plain_reps)),
             "K2": (cuda_ms(torch, lambda: fa.attn_dq_tc(*bwd)),
                    cuda_ms(torch, lambda: fa.attn_dq_plain(*bwd), reps=plain_reps)),
             "K3": (cuda_ms(torch, lambda: fa.attn_dkv_tc(*bwd)),
                    cuda_ms(torch, lambda: fa.attn_dkv_plain(*bwd), reps=plain_reps))}
    # yardstick only: one library call for the same attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    mask = None
    if window is not None:
        pos = torch.arange(t, device="cuda")
        mask = (pos[:, None] - pos[None, :]) < window  # the hops' windows come without causal
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                                                  enable_gqa=True)
    lib_fwd = cuda_ms(torch, sdpa)
    o = sdpa()
    lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
    work = _work(b, t, h, k.shape[2], d, causal, window)
    rows = {}
    for key, (ms, plain_ms) in times.items():
        flops, nbytes = work[key]
        op_ms, byte_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        err = max(e for n, (e, _) in errs.items() if n.startswith(key) and not n.endswith("lse"))
        rows[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(op_ms, byte_ms),
                         bound_by="operations" if op_ms >= byte_ms else "bytes",
                         library_ms=lib_fwd if key == "K1" else lib_bwd, max_abs_err=err)
    return rows


def phase_mesh_shapes(torch, fa) -> dict:
    """K1-K3 (tensor cores) at the mesh slice's shapes: each held against its
    plain version at TOL/REL_TOL and timed beside the plain version, its bound
    and ``scaled_dot_product_attention``."""
    out = {}
    for name, sh in MESH_SHAPES.items():
        errs, inputs = check_case(torch, fa, name, torch.bfloat16, sh["b"], sh["t"], sh["h"], sh["kh"], sh["d"],
                                  True, None, False)
        out[name] = time_tc(torch, fa, errs, inputs, True, None)
        for key, r in out[name].items():
            log(f"[kernels] {name}: {key} tc {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, bound "
                f"{r['bound_ms']:.4f} ms by {r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of it; library "
                f"{r['library_ms']:.3f} ms)")
        del inputs
        torch.cuda.empty_cache()
    return out


def phase_kernels(torch, fa) -> dict:
    import torch.nn.functional as F

    for name, dname, b, t, h, kh, d, causal, window, with_seg, s in SMALL_CASES:
        check_case(torch, fa, name, getattr(torch, dname), b, t, h, kh, d, causal, window, with_seg, s=s)

    sl = TRAIN_SHAPES
    train_case = (torch.bfloat16, sl["b"], sl["t"], sl["h"], sl["kh"], sl["d"], True, None, False)
    check_case(torch, fa, "1b train bf16 peaked", *train_case, qk_scale=2.0, also_simt=True)
    errs, (q, k, v, do, seg, out_p, lse_p, delta) = check_case(torch, fa, "1b train bf16 causal gqa 16->8",
                                                               *train_case, also_simt=True)
    scale = 1.0 / math.sqrt(sl["d"])
    args = (None, True, scale, None)
    bwd = (q, k, v, do, lse_p, delta, *args)
    plain_fwd = cuda_ms(torch, lambda: fa.attn_fwd_plain(q, k, v, *args), reps=5)
    plain_dq = cuda_ms(torch, lambda: fa.attn_dq_plain(*bwd), reps=5)
    plain_dkv = cuda_ms(torch, lambda: fa.attn_dkv_plain(*bwd), reps=5)
    times = {
        "K1 simt": (cuda_ms(torch, lambda: fa.attn_fwd_simt(q, k, v, *args)), plain_fwd),
        "K2 simt": (cuda_ms(torch, lambda: fa.attn_dq_simt(*bwd)), plain_dq),
        "K3 simt": (cuda_ms(torch, lambda: fa.attn_dkv_simt(*bwd)), plain_dkv),
        "K1 tc": (cuda_ms(torch, lambda: fa.attn_fwd_tc(q, k, v, *args)), plain_fwd),
        "K2 tc": (cuda_ms(torch, lambda: fa.attn_dq_tc(*bwd)), plain_dq),
        "K3 tc": (cuda_ms(torch, lambda: fa.attn_dkv_tc(*bwd)), plain_dkv),
    }
    # yardstick only: one PyTorch call for the same attention (never used by the port)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    sdpa_fwd_ms = cuda_ms(torch, sdpa)
    o = sdpa()
    g = do.transpose(1, 2)
    sdpa_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(o, (qt, kt, vt), g, retain_graph=True))

    work = _work(sl["b"], sl["t"], sl["h"], sl["kh"], sl["d"])
    simt_src, tc_src = "dmlcloud_tpu_torch/csrc/flash_attention.cu", "dmlcloud_tpu_torch/csrc/flash_attention_tc.cu"
    k1_site = "dmlcloud_tpu/ops/flash_attention.py:149 (_attn_kernel, pallas_call :773)"
    k2_site = "dmlcloud_tpu/ops/flash_attention.py:229 (_dq_kernel, pallas_call :847)"
    k3_site = "dmlcloud_tpu/ops/flash_attention.py:276 (_dkv_kernel, pallas_call :883)"
    sources = {
        "K1 simt": ("flash_fwd", simt_src, k1_site),
        "K2 simt": ("flash_bwd_dq", simt_src, k2_site),
        "K3 simt": ("flash_bwd_dkv", simt_src, k3_site),
        "K1 tc": ("flash_fwd_tc", tc_src, k1_site),
        "K2 tc": ("flash_bwd_dq_tc", tc_src, k2_site),
        "K3 tc": ("flash_bwd_dkv_tc", tc_src, k3_site),
    }

    def err_of(key):
        return max(err for name, (err, _) in errs.items() if name.startswith(key) and not name.endswith("lse"))

    rows = {}
    for key, (ms, plain_ms) in times.items():
        flops, nbytes = work[key.split()[0]]
        op_ms, byte_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        name, source, replaces = sources[key]
        library_ms = sdpa_fwd_ms if key.startswith("K1") else sdpa_bwd_ms
        rows[key] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err_of(key),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "library_ms": library_ms,
        }
        extra = ""
        if key.endswith("tc"):
            earlier = times[key.replace("tc", "simt")][0]
            extra = (f", {earlier / ms:.1f}x faster than the CUDA-core kernel ({earlier:.3f} ms), "
                     f"{ms / (2 * rows[key]['bound_ms']):.2f}x twice the bound")
        log(f"[kernels] {key} {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {rows[key]['bound_ms']:.4f} ms "
            f"by {rows[key]['bound_by']}); {flops / ms / 1e9:.1f} TFLOP/s = {rows[key]['bound_ms'] / ms:.1%} of the "
            f"bound; {ms / library_ms:.2f}x the library's {library_ms:.3f} ms{extra}")
    log(f"[kernels] yardstick scaled_dot_product_attention: fwd {sdpa_fwd_ms:.3f} ms, bwd {sdpa_bwd_ms:.3f} ms "
        f"(dQ+dK+dV)")
    bwd_tc = times["K2 tc"][0] + times["K3 tc"][0]
    log(f"[kernels] backward on the tensor cores, K2 tc + K3 tc: {bwd_tc:.4f} ms = {bwd_tc / sdpa_bwd_ms:.2f}x the "
        f"library's whole backward ({sdpa_bwd_ms:.3f} ms, same run)")
    return rows


# ---------------------------------------------------------------------------
# phase 4: the full-width 1b model, flash kernels against the dot path
# ---------------------------------------------------------------------------

#: flash vs dot logits of the model. TOL is held by each kernel against its
#: plain version (phase 3); here the two attention paths differ on purpose:
#: the dot path rounds its scores to bf16 before the softmax (as the JAX
#: reference's ``_dot_attention`` does, its einsum returns bf16) and the flash
#: kernels keep them in fp32. On the H100 that gives logit differences up to
#: 0.073 after 2 layers and 0.109 after 24 (logits std 1, norm-relative 0.012
#: and 0.019), a few of them outside TOL bf16 where |logit| is small, so the
#: model is held to this wider bound and a norm-relative one instead.
MODEL_TOL = dict(atol=0.25, rtol=0.25, rel_norm=0.05)


def phase_model(torch, fa) -> None:
    from dmlcloud_tpu_torch.examples.train_lm import PRESETS
    from dmlcloud_tpu_torch.models.transformer import DecoderLM, TransformerConfig

    kw = dict(vocab_size=32000, max_seq_len=2048, **PRESETS["1b"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    dot = DecoderLM(TransformerConfig(attn_impl="dot", **kw), device="cuda", generator=gen)
    flash = DecoderLM(TransformerConfig(attn_impl="flash", **kw), device="cuda")
    flash.load_state_dict(dot.state_dict())  # the same carried weights
    tokens = torch.randint(0, 32000, (1, 2048), generator=gen, device="cuda")
    packed = _segments(torch, 1, 2048)
    all_layers = (dot.layers, flash.layers)
    for depth, seg in ((2, None), (2, packed), (kw["num_layers"], None)):
        dot.layers, flash.layers = all_layers[0][:depth], all_layers[1][:depth]
        fa.reset_launch_counts()
        with torch.no_grad():
            want = dot(tokens, segment_ids=seg)
            got = flash(tokens, segment_ids=seg)
        torch.cuda.synchronize()
        if fa.LAUNCHES["flash_fwd_tc"] != depth or fa.LAUNCHES["flash_fwd"]:
            raise AssertionError(f"flash model launched K1 {fa.LAUNCHES}, want flash_fwd_tc {depth} times")
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError("non-finite logits")
        err = max_err(torch, got, want)
        rel = float((got - want).norm() / want.norm())
        outside = float((~torch.isclose(got, want, **TOL["bfloat16"])).float().mean())
        rows = "packed rows (segment_ids)" if seg is not None else "tokens"
        log(f"[model] 1b DecoderLM at full width, {depth} of 24 layers, {rows} [1, 2048]: flash vs dot logits "
            f"max abs err {err:.3g}, relative norm err {rel:.3g}, share outside TOL bf16 {outside:.2e}, "
            f"logits std {float(want.std()):.3g}")
        if not (torch.allclose(got, want, atol=MODEL_TOL["atol"], rtol=MODEL_TOL["rtol"])
                and rel <= MODEL_TOL["rel_norm"]):
            raise AssertionError(f"1b logits ({depth} layers, {rows}), flash vs dot: outside {MODEL_TOL}")
    del dot, flash, want, got, all_layers
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: train the 1b model through the port's TrainingPipeline
# ---------------------------------------------------------------------------

#: the same run on the CUDA-core kernels (H100 80GB HBM3, 700 W): step-1 loss
#: and peak memory; the tensor-core kernels must reproduce the first and not
#: raise the second
PR1_FIRST_LOSS = 10.861
PR1_PEAK_GIB = 37.43

TRAIN_ARGV = ["--preset", "1b", "--attn", "flash", "--vocab-size", "32000", "--seq-len", "2048",
              "--batch-size", "4", "--n-seqs", "32", "--epochs", "1"]


def phase_train(torch, fa) -> dict:
    from dmlcloud_tpu_torch.examples.train_lm import main as train_main

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()  # the main path's run starts here ...
    t0 = time.perf_counter()
    stage = train_main(TRAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)  # ... and ends here
    tracker = stage.tracker
    steps = len(stage.train_losses)
    losses = [float(x) for x in stage.train_losses]
    train_loss, val_loss = float(tracker["train/loss"][-1]), float(tracker["val/loss"][-1])
    log(f"[train] per-step losses {losses}; train/loss {train_loss!r}, val/loss {val_loss!r}")
    if steps != 7:
        raise AssertionError(f"expected 7 train steps, ran {steps}")
    if not all(math.isfinite(x) for x in losses + [train_loss, val_loss]):
        raise AssertionError("non-finite loss")
    if abs(losses[0] - math.log(32000)) > 1.5:
        raise AssertionError(f"first-step loss {losses[0]:.3f} is not within 1.5 of ln(32000) = {math.log(32000):.3f}")
    # 24 layers: a forward per train step and for the val batch, a backward per train step
    want = {"flash_fwd_tc": 24 * (steps + 1), "flash_bwd_dq_tc": 24 * steps, "flash_bwd_dkv_tc": 24 * steps,
            "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if launches != want:
        raise AssertionError(f"kernel launches on the train path {launches}, want {want}")
    if abs(losses[0] - PR1_FIRST_LOSS) > 0.01:
        raise AssertionError(f"first-step loss {losses[0]:.4f} is not within 0.01 of {PR1_FIRST_LOSS}")
    step_ms = float(tracker["misc/train_step_avg_ms"][-1])
    tokens_per_step = 4 * 2048
    peak = torch.cuda.max_memory_allocated()
    if peak > PR1_PEAK_GIB * 2**30:
        raise AssertionError(f"peak memory {peak / 2**30:.2f} GiB above the CUDA-core kernels' {PR1_PEAK_GIB} GiB")
    log(f"[train] 7 steps + 1 val batch in {wall:.1f} s wall (model build and data included); "
        f"train step avg {step_ms:.1f} ms = {1e3 / step_ms:.3f} steps/s = {tokens_per_step / step_ms * 1e3:.0f} tokens/s "
        f"(first step included); peak memory {peak / 2**30:.2f} GiB; launches {launches}")
    return launches, stage


# ---------------------------------------------------------------------------
# phase 6: steady-state steps and where the step's device time goes
# ---------------------------------------------------------------------------

def _device_us(event) -> float:
    return float(getattr(event, "self_device_time_total", 0.0) or getattr(event, "self_cuda_time_total", 0.0))


def steady_ms(torch, stage, batch, steps: int = 3) -> tuple[float, list[float]]:
    """Median device time of ``steps`` more train steps of ``stage`` on
    ``batch``, each synchronised (CUDA events), and the single times."""
    times = []
    for _ in range(steps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        stage._train_step(batch)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), times


def profile_call(torch, fn) -> tuple[float, float, list]:
    """One call of ``fn`` under torch.profiler: its wall time and device busy
    time in µs, and the device-side events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side activity only (kernels, copies): host ops also carry the
    # device time of the kernels they launch, annotated ranges (the
    # optimizer's step) span other kernels, and CUPTI reports the launch
    # queue filling up ("Command Buffer Full") as an event of its own
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
              and "Command Buffer" not in e.key]
    return wall_us, sum(_device_us(e) for e in events), events


def profile_step(torch, stage, batch) -> tuple[float, float, list]:
    """One train step of ``stage`` under torch.profiler (``profile_call``)."""
    return profile_call(torch, lambda: stage._train_step(batch))


def log_profile(tag: str, what: str, wall_us: float, busy_us: float, events: list, top: int = 6) -> None:
    log(f"[{tag}] profiled {what}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms (idle share "
        f"{max(0.0, 1 - busy_us / wall_us):.3f}), {sum(e.count for e in events)} device events")
    for e in sorted(events, key=_device_us, reverse=True)[:top]:
        log(f"[{tag}]   top: {_device_us(e) / 1e3:8.3f} ms  x{e.count:<4} {e.key[:90]}")


#: phase 6's profiled eager step (idle share, device events), for phase 16
EAGER_PROFILE: dict = {}


def phase_steady(torch, stage) -> float:
    """Three more steps of the trained stage on one of its batches, each
    synchronised, then one under torch.profiler (after the main path's launch
    counts were read)."""
    batch = next(iter(stage._feed(stage.train_dataset())))
    step_ms, times = steady_ms(torch, stage, batch)
    log(f"[steady] 1b train step (B=4, T=2048): {step_ms:.1f} ms median of {[round(t, 1) for t in times]} "
        f"= {4 * 2048 / step_ms * 1e3:.0f} tokens/s")

    wall_us, busy_us, events = profile_step(torch, stage, batch)
    if busy_us == 0:
        log("[steady] profiler recorded no device time: breakdown not measured")
        return step_ms
    groups = {"flash_fwd_tc (K1)": "flash_fwd_tc_kernel", "flash_bwd_dq_tc (K2)": "flash_bwd_dq_tc_kernel",
              "flash_bwd_dkv_tc (K3)": "flash_bwd_dkv_tc_kernel", "flash_fwd (K1, CUDA cores)": "flash_fwd_kernel",
              "flash_bwd_dq (K2, CUDA cores)": "flash_bwd_dq_kernel",
              "flash_bwd_dkv (K3, CUDA cores)": "flash_bwd_dkv_kernel"}
    shares = {g: sum(_device_us(e) for e in events if pat in e.key) for g, pat in groups.items()}
    gemm = sum(_device_us(e) for e in events if re.search(r"gemm|xmma|cutlass|nvjet|sm90_", e.key, re.I)
               and not any(p in e.key for p in groups.values()))
    EAGER_PROFILE.update(idle=max(0.0, 1 - busy_us / wall_us), events=sum(e.count for e in events))
    log(f"[steady] profiled step: wall {wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
        f"(idle share {EAGER_PROFILE['idle']:.3f}, {EAGER_PROFILE['events']} device events)")
    for g, us in [*shares.items(), ("matmuls (cuBLAS)", gemm),
                  ("everything else", busy_us - gemm - sum(shares.values()))]:
        log(f"[steady]   {g:<30} {us / 1e3:8.1f} ms  {us / busy_us:6.1%} of device time")
    top = sorted(events, key=_device_us, reverse=True)[:16]
    for e in top:
        log(f"[steady]   top: {_device_us(e) / 1e3:8.1f} ms  x{e.count:<4} {e.key[:90]}")
    return step_ms


# ---------------------------------------------------------------------------
# phase 7: preempt the 1b run at a step save and resume it from its directory
# ---------------------------------------------------------------------------

RESUME_ARGV = TRAIN_ARGV + ["--ema", "0.999", "--save-every-steps", "4"]
#: SIGUSR1 arrives once the feed has read past this many batches (it reads
#: ahead of the step); the drain lands at the next save
SIGNAL_AFTER = 3
SAVE_STEP = 4
TRAIN_STEPS = 7


class _SignalAfter:
    """A train dataset that sends this process SIGUSR1 after yielding batch ``k``."""

    def __init__(self, ds, k: int):
        self.ds, self.k = ds, k

    def __iter__(self):
        for i, batch in enumerate(self.ds):
            yield batch
            if i + 1 == self.k:
                os.kill(os.getpid(), signal.SIGUSR1)

    def __len__(self):
        return len(self.ds)


def _gb(nbytes: float) -> float:
    return nbytes / 1e9


def _save_line(what: str, info: dict, smi: str) -> str:
    line = f"[resume] {what}: {_gb(info['bytes']):.2f} GB, blocking {info['blocking_s']:.3f} s"
    if info["async"]:
        line += (f" ({_gb(info['bytes']) / info['blocking_s']:.2f} GB/s, the copy to host memory), background "
                 f"commit {info['commit_s']:.3f} s ({_gb(info['bytes']) / info['commit_s']:.2f} GB/s)")
    else:
        line += f" ({_gb(info['bytes']) / info['blocking_s']:.2f} GB/s, the whole write)"
    return line + f" [{smi}]"


def phase_resume(torch, fa, smi: str) -> None:
    from dmlcloud_tpu_torch.checkpoint import read_requeue_verdict
    from dmlcloud_tpu_torch.examples.train_lm import build

    want_p = {"flash_fwd_tc": 24 * SAVE_STEP, "flash_bwd_dq_tc": 24 * SAVE_STEP, "flash_bwd_dkv_tc": 24 * SAVE_STEP,
              "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    rest = TRAIN_STEPS - SAVE_STEP
    # the rest of the epoch's train steps and the validation batch
    want_r = {"flash_fwd_tc": 24 * (rest + 1), "flash_bwd_dq_tc": 24 * rest, "flash_bwd_dkv_tc": 24 * rest,
              "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    root = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        disk = shutil.disk_usage(root)
        log(f"[resume] temp root {root}: disk total {_gb(disk.total):.1f} GB, free {_gb(disk.free):.1f} GB")

        # C: uninterrupted; its final state, losses and val loss stay on the card
        t0 = time.perf_counter()
        pipe, stage = build(RESUME_ARGV)
        pipe.run()
        torch.cuda.synchronize()
        stage.state.optimizer.zero_grad(set_to_none=True)
        c_state, c_step, c_count = stage.state.state_dict(), stage.state.step, stage.state.optimizer.count
        c_losses, c_val = stage.train_losses, float(stage.tracker["val/loss"][-1])
        log(f"[resume] C, uninterrupted: {c_step} steps + 1 val batch in {time.perf_counter() - t0:.1f} s wall; "
            f"losses {[round(float(x), 4) for x in c_losses]}, val/loss {c_val:.6f}")
        if c_step != TRAIN_STEPS:
            raise AssertionError(f"C ran {c_step} steps, want {TRAIN_STEPS}")
        del pipe, stage
        gc.collect()  # stage and pipeline reference each other

        # P: preempted by a real signal after step 3; drains at the step-4 save
        t0 = time.perf_counter()
        pipe, stage = build(RESUME_ARGV + ["--checkpoint-dir", root], resume=True)
        datasets = stage.train_dataset
        stage.train_dataset = lambda: _SignalAfter(datasets(), SIGNAL_AFTER)
        pipe.enable_preemption_handling(("SIGUSR1",))
        fa.reset_launch_counts()
        pipe.run()
        torch.cuda.synchronize()
        launches_p = dict(fa.LAUNCHES)
        run_dir, scope = pipe.checkpoint_dir.path, stage.name
        steps_mgr = pipe.checkpoint_dir.state_manager(f"{scope}.steps")
        p_save = steps_mgr.last_save
        log(f"[resume] P, preempted: drained at step {stage.state.step} in {time.perf_counter() - t0:.1f} s wall; "
            f"launches {launches_p}")
        verdict = read_requeue_verdict(run_dir)
        checks = {
            "drain at the step-4 save": stage.state.step == SAVE_STEP and stage._mid_epoch_exit and stage._preempt_exit,
            "verdict preemption mid-epoch": bool(verdict) and verdict["requeue"] is True
            and verdict["kind"] == "preemption" and verdict["mid_epoch"] is True
            and "save_on_preempt_latency_s" in verdict,
            "contract files": (run_dir / ".dmlcloud_tpu").exists() and (run_dir / "config.yaml").exists()
            and (run_dir / "log.txt").stat().st_size > 0,
            "step save 4 committed, no epoch save": steps_mgr.all_steps() == [SAVE_STEP]
            and not (run_dir / "state" / scope).exists(),
            "launch counts": launches_p == want_p,
        }
        if not all(checks.values()):
            raise AssertionError(f"preempted run: failed {[k for k, ok in checks.items() if not ok]}; "
                                 f"verdict {verdict}, launches {launches_p} (want {want_p})")
        log(f"[resume] P verdict: {json.dumps(verdict)}")
        log(_save_line("P step save (async)", p_save, smi))
        del pipe, stage, datasets
        gc.collect()
        torch.cuda.empty_cache()

        # R: the same construction on P's directory
        t0 = time.perf_counter()
        pipe, stage = build(RESUME_ARGV + ["--checkpoint-dir", str(run_dir)], resume=True)
        restore_s = []
        restore = stage._restore_state

        def timed_restore():
            t = time.perf_counter()
            restore()
            torch.cuda.synchronize()
            restore_s.append(time.perf_counter() - t)

        stage._restore_state = timed_restore
        fa.reset_launch_counts()
        pipe.run()
        torch.cuda.synchronize()
        launches_r = dict(fa.LAUNCHES)
        r_save = pipe.checkpoint_dir.state_manager(scope).last_save
        log(f"[resume] R, resumed: steps {SAVE_STEP + 1}-{stage.state.step} + 1 val batch in "
            f"{time.perf_counter() - t0:.1f} s wall; launches {launches_r}")
        log(f"[resume] restore of step {SAVE_STEP}: {restore_s[0]:.3f} s "
            f"({_gb(p_save['bytes']) / restore_s[0]:.2f} GB/s) [{smi}]")
        log(_save_line("R epoch save (async)", r_save, smi))
        verdict = read_requeue_verdict(run_dir)
        if not (verdict and verdict["kind"] == "completed" and verdict["requeue"] is False):
            raise AssertionError(f"resumed run: verdict {verdict}, want completed")
        if len(stage.train_losses) != rest or launches_r != want_r:
            raise AssertionError(f"resumed run: {len(stage.train_losses)} steps (want {rest}), "
                                 f"launches {launches_r} (want {want_r})")

        # bitwise against C: every difference must be exactly 0
        r_state = stage.state.state_dict()
        diffs = {}
        for part, got, want in (("params", r_state["params"], c_state["params"]), ("ema", r_state["ema"], c_state["ema"]),
                                ("mu", r_state["opt_state"]["mu"], c_state["opt_state"]["mu"]),
                                ("nu", r_state["opt_state"]["nu"], c_state["opt_state"]["nu"])):
            if got.keys() != want.keys():
                raise AssertionError(f"resumed {part} has other tensors than the uninterrupted run's")
            diffs[part] = max(max_err(torch, got[n], want[n]) for n in want)
        r_losses = [float(x) for x in stage.train_losses]
        r_val = float(stage.tracker["val/loss"][-1])
        diffs["losses 5-7"] = max(abs(a - float(b)) for a, b in zip(r_losses, c_losses[SAVE_STEP:]))
        diffs["val/loss"] = abs(r_val - c_val)
        counters = (stage.state.step, stage.state.optimizer.count) == (c_step, c_count)
        log(f"[resume] R against C: step {stage.state.step}/{c_step}, AdamW count "
            f"{stage.state.optimizer.count}/{c_count}; max abs difference {diffs}")
        if not counters or any(diffs.values()):
            raise AssertionError(f"resumed run is not bitwise equal to the uninterrupted one: {diffs}")
        log("[resume] R equals C bitwise: params, EMA, AdamW moments and count, step, losses of steps 5-7, val/loss")

        # the EMA pass alone, on R's state
        n_params = sum(t.numel() for t in r_state["params"].values())
        ema_ms = cuda_ms(torch, lambda: stage.state.update_ema(0.999))
        ema_bytes = 3 * 4 * n_params  # read the shadow and the fp32 params, write the shadow
        log(f"[resume] EMA pass (torch._foreach_lerp_ over {n_params / 1e9:.3f} B fp32 params): {ema_ms:.3f} ms "
            f"per step, {_gb(ema_bytes) / ema_ms * 1e3:.0f} GB/s = {ema_bytes / HBM_BYTES_PER_S * 1e3 / ema_ms:.1%} "
            f"of the {ema_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms bound by bytes [{smi}]")
        disk = shutil.disk_usage(root)
        log(f"[resume] state per save {_gb(p_save['bytes']):.2f} GB; disk after R: free {_gb(disk.free):.1f} GB")
        del pipe, stage, c_state, r_state
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 8: the stage's knobs on the 1b run (feed, accumulation, MFU, recorder)
# ---------------------------------------------------------------------------

ACCUM = 2


def _build(argv, telemetry=None, **knobs):
    """``examples.train_lm.build`` with the stage's knobs set on the instance."""
    from dmlcloud_tpu_torch.examples.train_lm import build

    pipe, stage = build(argv, telemetry=telemetry)
    for name, value in knobs.items():
        setattr(stage, name, (lambda v: lambda: v)(value))
    return pipe, stage


def _losses(stage) -> tuple[list[float], float]:
    return [float(x) for x in stage.train_losses], float(stage.tracker["val/loss"][-1])


def _free(torch) -> None:
    gc.collect()  # stage and pipeline reference each other
    torch.cuda.empty_cache()


def _h2d_times(torch, host) -> dict:
    """One host batch's copy to the card: from pageable memory, from pinned
    memory (CUDA events, median of 10), and the host time of pinning it."""
    src = torch.from_numpy(host)
    pageable = cuda_ms(torch, lambda: src.to("cuda"))
    pinned_src = src.pin_memory()
    pinned = cuda_ms(torch, lambda: pinned_src.to("cuda", non_blocking=True))
    pin = []
    for _ in range(20):
        t0 = time.perf_counter()
        src.pin_memory()
        pin.append((time.perf_counter() - t0) * 1e3)
    return {"bytes": src.numel() * src.element_size(), "pageable_ms": pageable, "pinned_ms": pinned,
            "pin_ms": statistics.median(pin)}


def _grad_rel_err(torch, stage, batch) -> float:
    """``||g2 - g1|| / ||g1||`` over all parameters, where g1 and g2 are the
    gradients of one step on ``batch`` from the example's initial weights
    (seed 0) with 1 and with ``ACCUM`` microbatches, both through the
    stage's ``_backward``."""
    from dmlcloud_tpu_torch.examples.train_lm import PRESETS
    from dmlcloud_tpu_torch.models.transformer import DecoderLM, TransformerConfig
    from dmlcloud_tpu_torch.train_state import TrainState

    cfg = TransformerConfig(vocab_size=32000, max_seq_len=2048, attn_impl="flash", **PRESETS["1b"])
    stage.state = TrainState(model=DecoderLM(cfg, device="cuda"), optimizer=None)
    params = list(stage.state.model.parameters())
    stage._backward(batch, 1)
    g1 = [p.grad for p in params]
    for p in params:
        p.grad = None
    stage._backward(batch, ACCUM)
    diff = sum(float((p.grad.float() - g.float()).square().sum()) for p, g in zip(params, g1))
    norm = sum(float(g.float().square().sum()) for g in g1)
    stage.state = None
    return math.sqrt(diff / norm)


def _recorder_cost_us(journal_mod, watchdog_mod, root: str, steps: int = 2000) -> float:
    """Host µs per train step of what the armed recorder adds to the step
    loop: the timed ``next()`` with its ``data_wait`` span, the ``h2d`` span
    and the ``step_dispatch`` span, each notifying the watchdog."""
    j = journal_mod.SpanJournal(os.path.join(root, "recorder_cost"))
    wd = watchdog_mod.HangWatchdog(os.path.join(root, "recorder_cost_forensics"), journal=j)
    j.on_emit = wd.notify
    journal_mod.activate(j)
    try:
        t0 = time.perf_counter()
        for i in range(steps):
            a = time.perf_counter()
            with journal_mod.span("h2d", prefetch=2):
                pass
            journal_mod.emit("data_wait", a, time.perf_counter())
            b = time.perf_counter_ns()
            journal_mod.emit("step_dispatch", b / 1e9, time.perf_counter_ns() / 1e9, step=i + 1)
        cost = (time.perf_counter() - t0) / steps * 1e6
    finally:
        journal_mod.deactivate()
        j.close()
    return cost


def phase_stage(torch, fa, smi: str, p5: dict) -> dict:
    """Phase 8. ``p5``: phase 5's per-step losses and val/loss, and phase 6's
    steady step in ms."""
    from dmlcloud_tpu_torch.telemetry import journal as journal_mod
    from dmlcloud_tpu_torch.telemetry import ledger_from_tracker, load_journals, to_chrome_trace
    from dmlcloud_tpu_torch.telemetry import watchdog as watchdog_mod
    from dmlcloud_tpu_torch.utils.profiling import PEAK_BF16_FLOPS, peak_flops_for_kind

    t_phase = time.perf_counter()
    out = {}
    # (a) the feed: synchronous and host-prefetched runs bitwise equal to phase 5
    for what, knobs in (("device_prefetch 0", dict(device_prefetch=0)),
                        ("host_prefetch 2 at depth 2", dict(host_prefetch=2))):
        t0 = time.perf_counter()
        pipe, stage = _build(TRAIN_ARGV, **knobs)
        pipe.run()
        torch.cuda.synchronize()
        losses, val = _losses(stage)
        log(f"[stage] (a) {what}: 7 steps + 1 val batch in {time.perf_counter() - t0:.1f} s wall; "
            f"losses {[round(x, 4) for x in losses]}, val/loss {val:.6f}, "
            f"train step avg {float(stage.tracker['misc/train_step_avg_ms'][-1]):.1f} ms")
        if losses != p5["losses"] or val != p5["val"]:
            raise AssertionError(f"(a) {what}: losses {losses} / val {val} are not bitwise phase 5's "
                                 f"{p5['losses']} / {p5['val']}")
        if "h2d" not in out:
            host = next(iter(stage.train_dataset()))
            out["h2d"] = h2d = _h2d_times(torch, host)
            log(f"[stage] (a) one batch's host-to-device copy ({h2d['bytes']} bytes, [4, 2048] int32): pageable "
                f"{h2d['pageable_ms'] * 1e3:.1f} us, pinned {h2d['pinned_ms'] * 1e3:.1f} us (CUDA events); "
                f"pinning it {h2d['pin_ms'] * 1e3:.1f} us of host time [{smi}]")
            batch = next(iter(stage._feed(stage.train_dataset())))
            out["a_steady_ms"], times = steady_ms(torch, stage, batch)
            log(f"[stage] (a) steady step {out['a_steady_ms']:.1f} ms median of {[round(t, 1) for t in times]}")
        del pipe, stage
        _free(torch)
    log("[stage] (a) both feeds bitwise equal to phase 5: every step's loss and val/loss")

    # (b) accumulation, with --mfu and the flight recorder armed
    root = tempfile.mkdtemp(prefix="chip_smoke_stage_")
    try:
        tdir = os.path.join(root, "telemetry")
        pipe, stage = _build(TRAIN_ARGV + ["--mfu"], telemetry=tdir, gradient_accumulation=ACCUM)
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()  # counted around this run alone
        t0 = time.perf_counter()
        pipe.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        losses, val = _losses(stage)
        steps = len(losses)
        want = {"flash_fwd_tc": 24 * (ACCUM * steps + 1), "flash_bwd_dq_tc": 24 * ACCUM * steps,
                "flash_bwd_dkv_tc": 24 * ACCUM * steps, "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        log(f"[stage] (b) gradient_accumulation {ACCUM}: {steps} steps + 1 val batch in {wall:.1f} s wall; losses "
            f"{[round(x, 4) for x in losses]}, val/loss {val:.4f}; launches {launches}")
        if steps != 7 or launches != want:
            raise AssertionError(f"(b) {steps} steps, launches {launches}; want 7 and {want}")
        if not all(math.isfinite(x) for x in losses + [val]):
            raise AssertionError("(b) non-finite loss")
        if abs(losses[0] - p5["losses"][0]) > 1e-2:
            raise AssertionError(f"(b) step-1 loss {losses[0]:.4f} is not within 1e-2 of phase 5's {p5['losses'][0]:.4f}")
        if peak >= PR1_PEAK_GIB * 2**30:
            raise AssertionError(f"(b) peak memory {peak / 2**30:.2f} GiB not under {PR1_PEAK_GIB} GiB")
        tracker = stage.tracker
        n_params = sum(p.numel() for p in stage.state.model.parameters())
        step_avg_ms = float(tracker["misc/train_step_avg_ms"][-1])
        batch = next(iter(stage._feed(stage.train_dataset())))
        b_steady, times = steady_ms(torch, stage, batch)
        log(f"[stage] (b) step-1 loss {losses[0]:.4f} (phase 5: {p5['losses'][0]:.4f}, the mean of two half-batch "
            f"means); peak memory {peak / 2**30:.2f} GiB (phase 5 bound {PR1_PEAK_GIB} GiB); steady step "
            f"{b_steady:.1f} ms median of {[round(t, 1) for t in times]} (phase 6: {p5['steady_ms']:.1f} ms, "
            f"(a): {out['a_steady_ms']:.1f} ms); train step avg {step_avg_ms:.1f} ms [{smi}]")
        out.update(b_steady_ms=b_steady, peak_gib=peak / 2**30, launches=launches)
        # where the accumulated step's extra time goes: one profiled step of
        # each kind, on the same weights and batch, in turns
        for accum in (1, ACCUM, ACCUM, 1):
            stage.gradient_accumulation = (lambda a: lambda: a)(accum)
            wall_us, busy_us, events = profile_step(torch, stage, batch)
            gemm = sum(_device_us(e) for e in events if re.search(r"gemm|xmma|cutlass|nvjet|sm90_", e.key, re.I))
            log(f"[stage] (b) profiled step with {accum} microbatch(es): wall {wall_us / 1e3:.1f} ms, device busy "
                f"{busy_us / 1e3:.1f} ms (idle share {max(0.0, 1 - busy_us / wall_us):.3f}), matmuls "
                f"{gemm / 1e3:.1f} ms, {sum(e.count for e in events)} device events")
        stage.gradient_accumulation = lambda: ACCUM

        # (c) MFU against the formula, recomputed here
        name = torch.cuda.get_device_name(0)
        peak_flops = peak_flops_for_kind(name)
        key = next((k for k in sorted(PEAK_BF16_FLOPS, key=len, reverse=True) if k in name.lower()), None)
        if peak_flops is None:
            raise AssertionError(f"(c) no bf16 peak for {name!r} in PEAK_BF16_FLOPS")
        flops = 6 * n_params * stage.config.batch_size * stage.config.seq_len  # 6 N B T, B 4, T 2048
        mfu = float(tracker["misc/mfu"][-1])
        want_mfu = flops / (step_avg_ms / 1e3) / peak_flops
        if not math.isclose(mfu, want_mfu, rel_tol=1e-6):
            raise AssertionError(f"(c) misc/mfu {mfu!r} is not 6*N*B*T/step/peak = {want_mfu!r}")
        steady_mfu = flops / (b_steady / 1e3) / peak_flops
        log(f"[stage] (c) {name!r} matched peak key {key!r} = {peak_flops / 1e12:.1f} TFLOP/s; N = {n_params} "
            f"parameters, {flops:.4g} FLOP per step; misc/mfu (epoch, step 1's warm-up included) {mfu:.4f} = the "
            f"formula at {step_avg_ms:.1f} ms; at the steady {b_steady:.1f} ms: {steady_mfu:.4f} [{smi}]")
        out.update(mfu=mfu, steady_mfu=steady_mfu)

        # (d) the flight recorder's output
        records = load_journals(tdir)
        files = sorted(f for f in os.listdir(tdir) if f.startswith("journal-rank0") and f.endswith(".jsonl"))
        kinds = {}
        for r in records:
            kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
        missing = [k for k in ("run", "stage", "epoch", "step_dispatch", "data_wait", "h2d") if not kinds.get(k)]
        if not files or missing or kinds.get("step_dispatch") != steps:
            raise AssertionError(f"(d) journal {files}: span kinds {kinds}, missing {missing}, "
                                 f"want {steps} step_dispatch spans")
        trace = to_chrome_trace(records)
        json.dumps(trace)
        if not os.path.exists(os.path.join(tdir, "goodput.json")):
            raise AssertionError("(d) goodput.json was not written")
        gp = float(tracker["misc/goodput"][-1])
        epoch_s = float(tracker["misc/epoch_time"][-1])
        data_wait_ms = float(tracker["misc/data_wait_ms"][-1])
        stall_ms = float(tracker["misc/host_stall_ms"][-1])
        gap = gp * epoch_s + (data_wait_ms + stall_ms) / 1e3 - epoch_s
        if not (0.0 < gp <= 1.0) or abs(gap) > 1e-3:
            raise AssertionError(f"(d) goodput {gp}, buckets off the epoch time by {gap:.3g} s")
        if os.path.exists(os.path.join(root, "forensics", "rank0.json")):
            raise AssertionError("(d) the watchdog dumped forensics on a healthy run")
        log(f"[stage] (d) journal {files}: {len(records)} spans {kinds}; Chrome trace of "
            f"{len(trace['traceEvents'])} events; goodput {gp:.4f}: data_wait {data_wait_ms:.1f} ms + host stall "
            f"{stall_ms:.1f} ms + productive {gp * epoch_s:.3f} s = epoch {epoch_s:.3f} s (off by {gap:.2g} s); "
            f"no forensics dump")
        for line in ledger_from_tracker(tracker).format_table().splitlines():
            log(f"[stage] (d) {line}")
        cost_us = _recorder_cost_us(journal_mod, watchdog_mod, root)
        log(f"[stage] (d) the recorder's host cost: {cost_us:.1f} us per step (3 spans and the timed next()), "
            f"{cost_us / 1e3 / b_steady:.2e} of the steady step; steady step with accumulation {b_steady:.1f} ms "
            f"(the recorder's run) against (a)'s {out['a_steady_ms']:.1f} ms [{smi}]")
        out.update(goodput=gp, recorder_us=cost_us)

        # (b) the gradients of 2 microbatches against 1, from the initial weights
        rel = _grad_rel_err(torch, stage, batch)
        log(f"[stage] (b) one step from the initial weights: gradients with {ACCUM} microbatches against 1, "
            f"norm-relative error {rel:.3g} (bound {REL_TOL['bfloat16']})")
        if not rel <= REL_TOL["bfloat16"]:
            raise AssertionError(f"(b) accumulated gradients off by {rel:.3g} in norm")
        out["grad_rel"] = rel
        del pipe, stage, batch
        _free(torch)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[stage] phase 8 in {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 9: the MNIST example on the card, against the same run on the CPU
# ---------------------------------------------------------------------------

MNIST_ARGV = ["--epochs", "2", "--batch-size", "32"]
#: the card's per-step losses against the CPU's, |card - cpu| <= atol + rtol *
#: |cpu| at each of both epochs' 256 steps: both run fp32 (TF32 off, phase 1),
#: but cuDNN's and the CPU's convolutions and reductions round differently and
#: 256 Adam steps carry that forward (two CPU runs that differ only in their
#: thread count drift by up to 1.7e-4 relative, where the loss is ~1e-4); the
#: atol covers the last steps, where the loss is ~1e-5
MNIST_LOSS_TOL = dict(rtol=1e-2, atol=1e-4)
#: the synthetic digits' chance level is 0.1
MNIST_MIN_ACC = 0.5


def _mnist_run(argv: list[str]):
    """``examples.mnist`` through its ``build``: the stage, every train step's
    loss over all epochs, and the wall time of the run."""
    from dmlcloud_tpu_torch.examples import mnist

    pipe, stage = mnist.build(argv)
    losses = []
    stage.post_epoch = lambda: losses.extend(float(x) for x in stage.train_losses)
    t0 = time.perf_counter()
    pipe.run()
    return stage, losses, time.perf_counter() - t0


def phase_mnist(torch, smi: str) -> dict:
    t_phase = time.perf_counter()
    card, card_losses, card_wall = _mnist_run(MNIST_ARGV)
    torch.cuda.synchronize()
    cpu, cpu_losses, cpu_wall = _mnist_run(MNIST_ARGV + ["--device", "cpu"])
    if not card_losses or len(card_losses) != len(cpu_losses):
        raise AssertionError(f"mnist: {len(card_losses)} card steps against {len(cpu_losses)} on the CPU")
    if not all(math.isfinite(x) for x in card_losses):
        raise AssertionError("mnist: non-finite loss on the card")
    diff = [abs(a - b) for a, b in zip(card_losses, cpu_losses)]
    rel = [d / abs(b) for d, b in zip(diff, cpu_losses)]
    worst = max(range(len(rel)), key=rel.__getitem__)
    outside = [i + 1 for i, (d, b) in enumerate(zip(diff, cpu_losses))
               if d > MNIST_LOSS_TOL["atol"] + MNIST_LOSS_TOL["rtol"] * abs(b)]
    acc, cpu_acc = float(card.tracker["val/accuracy"][-1]), float(cpu.tracker["val/accuracy"][-1])
    # epoch 2's average step is steady: no first-call warm-up in it
    step_ms = float(card.tracker["misc/train_step_avg_ms"][-1])
    samples_s = 32 / step_ms * 1e3
    log(f"[mnist] examples.mnist {' '.join(MNIST_ARGV)} on the card: {len(card_losses)} steps in {card_wall:.1f} s "
        f"wall; epoch-2 step {step_ms:.3f} ms = {samples_s:.0f} samples/s (steady, batch 32); val/accuracy {acc:.4f} "
        f"[{smi}]")
    log(f"[mnist] the same on the CPU: {cpu_wall:.1f} s wall, epoch-2 step "
        f"{float(cpu.tracker['misc/train_step_avg_ms'][-1]):.3f} ms, val/accuracy {cpu_acc:.4f}")
    log(f"[mnist] per-step losses, card against CPU: max abs difference {max(diff):.3g}, max relative {rel[worst]:.3g} "
        f"at step {worst + 1} ({card_losses[worst]:.6g} / {cpu_losses[worst]:.6g}); step 1 {rel[0]:.3g}, step 2 "
        f"{rel[1]:.3g}, last step {rel[-1]:.3g}; losses step 1 {card_losses[0]:.6f}, last {card_losses[-1]:.3g} "
        f"(bound {MNIST_LOSS_TOL})")
    if outside:
        raise AssertionError(f"mnist: card losses outside {MNIST_LOSS_TOL} of the CPU's at steps {outside[:10]}")
    if not acc > MNIST_MIN_ACC:
        raise AssertionError(f"mnist: val/accuracy {acc:.4f} on the card, not above {MNIST_MIN_ACC}")
    # where a step's time goes: more synchronised steps (CUDA events), then one under the profiler
    batch = next(iter(card._feed(card.train_dataset())))
    event_ms, times = steady_ms(torch, card, batch, steps=20)
    log(f"[mnist] one step between CUDA events: {event_ms:.3f} ms median of 20 (epoch-2 average {step_ms:.3f} ms)")
    log_profile("mnist", "train step (batch 32)", *profile_call(torch, lambda: card._train_step(batch)), top=10)
    del card, cpu, batch
    _free(torch)
    log(f"[mnist] phase 9 in {time.perf_counter() - t_phase:.1f} s")
    return {"samples_s": samples_s, "step_ms": step_ms, "acc": acc, "max_rel": rel[worst], "max_abs": max(diff)}


# ---------------------------------------------------------------------------
# phase 10: the data-parallel collectives on a one-rank NCCL group
# ---------------------------------------------------------------------------

def phase_nccl(torch, smi: str) -> dict:
    """The gradient average and the parameter broadcast of
    ``parallel.data_parallel`` through NCCL, on the 1b model's tensors: a
    one-rank group (the machine has one card) from the port's own
    ``init_auto`` over env://. At world 1 the stage skips the reduction, so
    the bucket paths are called directly; an average or a broadcast over one
    rank must give every tensor back bitwise."""
    import torch.distributed as dist

    from dmlcloud_tpu_torch.examples.train_lm import PRESETS
    from dmlcloud_tpu_torch.models.transformer import DecoderLM, TransformerConfig, lm_loss
    from dmlcloud_tpu_torch.parallel import data_parallel, runtime
    from dmlcloud_tpu_torch.utils.tcp import find_free_port

    t_phase = time.perf_counter()
    runtime.deinitialize()  # the earlier phases ran as a single process without a group
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(find_free_port()), "RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = {}
    try:
        backend = runtime.init_auto("cuda")
        if backend != "nccl" or dist.get_backend() is None or runtime.world_size() != 1:
            raise AssertionError(f"init_auto over env:// gave backend {backend!r}, world {runtime.world_size()}")
        cfg = TransformerConfig(vocab_size=32000, max_seq_len=2048, attn_impl="flash", **PRESETS["1b"])
        model = DecoderLM(cfg, device="cuda")
        tokens = torch.randint(0, 32000, (1, 2048), generator=torch.Generator(device="cuda").manual_seed(0),
                               device="cuda")
        lm_loss(model(tokens), tokens).backward()
        grads = [p.grad for p in model.parameters()]
        n = sum(g.numel() for g in grads)
        want = [g.clone() for g in grads]
        data_parallel.reduce_gradient_buckets(grads, world=1)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(grads, want)):
            raise AssertionError("the one-rank NCCL gradient average changed a gradient")
        del want
        buckets = math.ceil(n * 4 / data_parallel.BUCKET_BYTES)
        reduce_ms = cuda_ms(torch, lambda: data_parallel.reduce_gradient_buckets(grads, world=1), reps=5)
        # least time: read every fp32 gradient once and write it once
        reduce_bound = 2 * 4 * n / HBM_BYTES_PER_S * 1e3
        log(f"[nccl] backend {dist.get_backend()} (init_auto over env://, world 1); gradient average of the 1b "
            f"model ({n / 1e9:.4f} B fp32 gradients, {buckets} buckets of {data_parallel.BUCKET_BYTES >> 20} MiB = "
            f"{buckets} all_reduce calls per step): bitwise unchanged; {reduce_ms:.3f} ms per call against a bound of "
            f"{reduce_bound:.3f} ms by bytes ({reduce_bound / reduce_ms:.1%}) [{smi}]")
        log_profile("nccl", "gradient average", *profile_call(
            torch, lambda: data_parallel.reduce_gradient_buckets(grads, world=1)))
        tensors = [p.data for p in model.parameters()] + list(model.buffers())
        want = [t.clone() for t in tensors]
        data_parallel.broadcast_buckets(tensors, src=0)
        torch.cuda.synchronize()
        if not all(torch.equal(t, w) for t, w in zip(tensors, want)):
            raise AssertionError("the one-rank NCCL parameter broadcast changed a tensor")
        del want
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        bcast_ms = cuda_ms(torch, lambda: data_parallel.broadcast_buckets(tensors, src=0), reps=5)
        bcast_bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[nccl] coalesced parameter broadcast ({nbytes / 1e9:.3f} GB of parameters and buffers): bitwise "
            f"unchanged; {bcast_ms:.3f} ms per call against a bound of {bcast_bound:.3f} ms by bytes "
            f"({bcast_bound / bcast_ms:.1%}) [{smi}]")
        log_profile("nccl", "parameter broadcast", *profile_call(
            torch, lambda: data_parallel.broadcast_buckets(tensors, src=0)))
        out.update(reduce_ms=reduce_ms, reduce_bound_ms=reduce_bound, buckets=buckets, bcast_ms=bcast_ms,
                   bcast_bound_ms=bcast_bound)
        del model, grads, tensors
    finally:
        runtime.deinitialize()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _free(torch)
    log(f"[nccl] phase 10 in {time.perf_counter() - t_phase:.1f} s; process group torn down")
    return out



# ---------------------------------------------------------------------------
# phase 11: the mesh path on one card
# ---------------------------------------------------------------------------

MESH_ARGV = TRAIN_ARGV + ["--mesh", "fsdp=1"]
#: phase 5's losses against the same run through FSDP2 on a one-rank mesh
MESH_LOSS_REL = 1e-5
#: the 8b model at full width, depth cut to 2 layers so one card holds it
POD_ARGV = ["--mesh", "fsdp=1", "--layers", "2", "--remat", "--chunked-loss", "8192", "--global-batch", "1",
            "--seq-len", "4096", "--steps-per-epoch", "3"]
POD_VOCAB = 128256
#: the step-1 loss at initialisation: the head's logits have unit variance
#: (RMS-normed hidden, lecun-normal kernel), so the expected cross entropy is
#: ln(vocab) + 1/2, not ln(vocab) (phase 5's 1b model: 10.861 against
#: ln(32000) + 1/2 = 10.873)
POD_FIRST_LOSS = math.log(POD_VOCAB) + 0.5
POD_FIRST_LOSS_TOL = 0.1


def phase_mesh(torch, fa, smi: str, p5: dict) -> dict:
    """(a) ``examples.train_lm`` at phase 5's argv plus ``--mesh fsdp=1``:
    ``fully_shard`` over a one-rank NCCL mesh, the losses within
    ``MESH_LOSS_REL`` of phase 5's (and whether bitwise), the same launches,
    peak memory; (b) ``examples.pod_llama_fsdp`` at the 8b model's full width
    (2 of 32 layers) with ``--remat --chunked-loss 8192``, 3 steps of one
    4096-token sequence: finite losses, step 1 within ``POD_FIRST_LOSS_TOL`` of
    ``POD_FIRST_LOSS``, K1 twice per layer per step; (c) ``chunked_lm_loss`` against
    ``lm_loss`` at vocab 128256 on the same hidden states, value and
    gradients at fp32 tolerance."""
    from dmlcloud_tpu_torch.examples import pod_llama_fsdp, train_lm
    from dmlcloud_tpu_torch.models.transformer import chunked_lm_loss, lm_loss
    from dmlcloud_tpu_torch.parallel import runtime
    from torch.distributed.tensor import DTensor

    t_phase = time.perf_counter()
    out = {}
    runtime.deinitialize()
    try:
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()  # the mesh path's run starts here ...
        stage = train_lm.main(MESH_ARGV)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)  # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        plan = stage.pipeline.models["lm"].plan
        if not (plan.fsdp and plan.axes == {"fsdp": 1} and runtime._info.backend == "nccl"
                and all(isinstance(p, DTensor) for p in stage.state.model.parameters())):
            raise AssertionError(f"--mesh fsdp=1 did not run through fully_shard on NCCL: {plan.axes}, "
                                 f"fsdp {plan.fsdp}, backend {runtime._info.backend}")
        losses, val = _losses(stage)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses + [val], p5["losses"] + [p5["val"]]))
        bitwise = losses == p5["losses"] and val == p5["val"]
        step_ms = float(stage.tracker["misc/train_step_avg_ms"][-1])
        log(f"[mesh] (a) train_lm 1b --mesh fsdp=1 (fully_shard, one-rank NCCL mesh): losses {losses}, val/loss "
            f"{val!r}; against phase 5 max relative diff {rel:.3g} ({'bitwise' if bitwise else 'not bitwise'}); "
            f"step avg {step_ms:.1f} ms (first step included); peak {peak / 2**30:.2f} GiB; "
            f"launches {launches} [{smi}]")
        want = {"flash_fwd_tc": 192, "flash_bwd_dq_tc": 168, "flash_bwd_dkv_tc": 168, "flash_fwd": 0,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        if launches != want:
            raise AssertionError(f"launches on the mesh path {launches}, want {want}")
        if len(losses) != 7 or not rel <= MESH_LOSS_REL:
            raise AssertionError(f"fsdp=1 losses off phase 5's by {rel:.3g} (> {MESH_LOSS_REL})")
        out["a"] = dict(rel=rel, bitwise=bitwise, peak_gib=peak / 2**30, step_ms=step_ms)
        del stage, plan
        runtime.deinitialize()
        _free(torch)

        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        stage = pod_llama_fsdp.main(POD_ARGV)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        losses = [float(x) for x in stage.train_losses]
        step_ms = float(stage.tracker["misc/train_step_avg_ms"][-1])
        mfu = float(stage.tracker["misc/mfu"][-1]) if "misc/mfu" in stage.tracker else float("nan")
        n_params = sum(p.numel() for p in stage.state.model.parameters())
        t0 = time.perf_counter()
        batch = torch.from_numpy(stage.pipeline.datasets["train"][0]).cuda()
        stage._train_step(batch)
        torch.cuda.synchronize()
        steady = (time.perf_counter() - t0) * 1e3
        log(f"[mesh] (b) pod_llama_fsdp 8b width, 2 of 32 layers ({n_params / 1e9:.3f} B params), "
            f"{' '.join(POD_ARGV)}: "
            f"losses {losses} (ln {POD_VOCAB} + 1/2 = {POD_FIRST_LOSS:.3f}); step avg {step_ms:.1f} ms (first "
            f"included), one more step {steady:.1f} ms = {4096 / steady * 1e3:.0f} tokens/s; misc/mfu {mfu:.4f}; "
            f"peak {peak / 2**30:.2f} GiB; launches {launches} [{smi}]")
        want = {"flash_fwd_tc": 2 * 2 * 3, "flash_bwd_dq_tc": 2 * 3, "flash_bwd_dkv_tc": 2 * 3, "flash_fwd": 0,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        if launches != want:
            raise AssertionError(f"launches on the 8b path {launches}, want {want}")
        if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"8b losses {losses}")
        if abs(losses[0] - POD_FIRST_LOSS) > POD_FIRST_LOSS_TOL:
            raise AssertionError(f"8b step-1 loss {losses[0]:.4f} not within {POD_FIRST_LOSS_TOL} of "
                                 f"ln({POD_VOCAB}) + 1/2 = {POD_FIRST_LOSS:.4f}")
        out["b"] = dict(losses=losses, step_ms=steady, mfu=mfu, peak_gib=peak / 2**30)
        del stage, batch
        runtime.deinitialize()
        _free(torch)

        g = torch.Generator(device="cuda").manual_seed(0)
        t, d = 2048, 4096
        hidden = torch.randn(1, t, d, generator=g, device="cuda")
        kernel = torch.randn(d, POD_VOCAB, generator=g, device="cuda") / math.sqrt(d)
        tokens = torch.randint(0, POD_VOCAB, (1, t), generator=g, device="cuda")

        def run(fn):
            h, k = hidden.clone().requires_grad_(True), kernel.clone().requires_grad_(True)
            loss = fn(h, k)
            loss.backward()
            return loss.detach(), h.grad, k.grad

        chunked = lambda h, k: chunked_lm_loss(h, k, tokens, vocab_chunk=8192)
        dense = lambda h, k: lm_loss(h @ k, tokens)
        torch.cuda.reset_peak_memory_stats()
        got = run(chunked)
        torch.cuda.synchronize()
        peak_c = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        want_ = run(dense)
        torch.cuda.synchronize()
        peak_d = torch.cuda.max_memory_allocated()
        errs = [assert_close(torch, a, b, "float32", f"chunked_lm_loss {what}")
                for a, b, what in zip(got, want_, ("loss", "d hidden", "d kernel"))]
        ms_c, ms_d = cuda_ms(torch, lambda: run(chunked), reps=3), cuda_ms(torch, lambda: run(dense), reps=3)
        log(f"[mesh] (c) chunked_lm_loss (chunk 8192) vs lm_loss at vocab {POD_VOCAB}, hidden [1, {t}, {d}] fp32: "
            f"loss {float(got[0]):.6f} vs {float(want_[0]):.6f}; (max abs, norm-relative) loss {errs[0]}, d hidden "
            f"{errs[1]}, d kernel {errs[2]}; forward+backward {ms_c:.2f} vs {ms_d:.2f} ms, peak "
            f"{peak_c / 2**30:.2f} vs {peak_d / 2**30:.2f} GiB")
        out["c"] = dict(errs=errs, ms=ms_c, dense_ms=ms_d)
        del hidden, kernel, got, want_
    finally:
        runtime.deinitialize()
    _free(torch)
    log(f"[mesh] phase 11 in {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: the seq axis (ring attention) and the pipe axis (GPipe) on one card
# ---------------------------------------------------------------------------

#: the ring's hop forms at the 1b heads, one 2048-token block per hop:
#: name -> (causal, window cutoff handed to the kernels)
HOP_SHAPES = dict(b=1, t=2048, h=16, kh=8, d=128)
HOP_FORMS = {
    "behind (causal=False)": (False, None),
    "diagonal (causal)": (True, None),
    "window 4096, 1 hop back (cutoff 2048)": (False, 4096 - 2048),
    "window 4096, 2 hops back (cutoff 0, a dead row)": (False, 4096 - 2 * 2048),
    "window 3000, 2 hops back (cutoff -1096, dead rows)": (False, 3000 - 2 * 2048),
}
RING_ARGV = [a for a in TRAIN_ARGV if a not in ("--attn", "flash")] + ["--attn", "ring", "--mesh", "seq=1"]
#: phase 5's losses against the same run with ring attention over one rank
#: (the diagonal hop; its merge with n = 1 is exact, so bitwise is expected)
RING_LOSS_ATOL = 1e-3
PIPE_BLOCKS, PIPE_MICRO = 6, 4


def phase_hops(torch, fa, smi: str) -> dict:
    """(a): each hop form through K1/K2/K3 on the tensor cores against the
    plain versions, with a random lse cotangent folded into delta (the ring's
    merge differentiates the lse), then timed; a dead row's output must be 0."""
    sh = HOP_SHAPES
    out = {}
    for name, (causal, window) in HOP_FORMS.items():
        errs, inputs = check_case(torch, fa, f"hop: {name}", torch.bfloat16, sh["b"], sh["t"], sh["h"], sh["kh"],
                                  sh["d"], causal, window, False, lse_cotangent=True)
        q, out_p, lse_p = inputs[0], inputs[5], inputs[6]
        o, _ = fa.attn_fwd_tc(q, inputs[1], inputs[2], None, causal, 1.0 / math.sqrt(sh["d"]), window)
        dead = lse_p.reshape(sh["b"], sh["h"], sh["t"]).permute(0, 2, 1) <= fa.NEG_INF / 2  # [B, T, H]
        if not bool((o[dead] == 0).all()):
            raise AssertionError(f"{name}: a dead row's output is not 0")
        rows = time_tc(torch, fa, errs, inputs, causal, window, plain_reps=3)
        pairs = _live_pairs(sh["t"], sh["t"], causal, window)
        log(f"[seq] (a) hop form {name}: {pairs} live pairs per head, {int(dead.sum())} dead rows; "
            + "; ".join(f"{key} tc {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.4f} by "
                        f"{r['bound_by']}, library {r['library_ms']:.3f}, max abs err {r['max_abs_err']:.2e})"
                        for key, r in rows.items()) + f" [{smi}]")
        out[name] = dict(rows=rows, dead=int(dead.sum()), pairs=pairs)
        del inputs, q, out_p, lse_p, o
        torch.cuda.empty_cache()
    return out


def phase_ring(torch, fa, smi: str, p5: dict) -> dict:
    """(b): phase 5's run with ``--attn ring --mesh seq=1``."""
    from dmlcloud_tpu_torch.examples import train_lm
    from dmlcloud_tpu_torch.parallel import runtime

    runtime.deinitialize()
    try:
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()  # the ring path's run starts here ...
        stage = train_lm.main(RING_ARGV)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)  # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        losses, val = _losses(stage)
        group = stage.state.model.layers[0].attn.seq
        step_ms = float(stage.tracker["misc/train_step_avg_ms"][-1])
        # after the counts were read: the steady step beside phase 6's
        steady, _ = steady_ms(torch, stage, next(iter(stage._feed(stage.train_dataset()))))
    finally:
        runtime.deinitialize()
    diffs = [abs(a - b) for a, b in zip(losses + [val], p5["losses"] + [p5["val"]])]
    first = next((i + 1 for i, (a, b) in enumerate(zip(losses, p5["losses"])) if a != b), None)
    bitwise = first is None and val == p5["val"]
    log(f"[seq] (b) train_lm 1b --attn ring --mesh seq=1: losses {losses}, val/loss {val!r}; against phase 5 "
        f"max |diff| {max(diffs):.3g}; {'bitwise equal' if bitwise else f'not bitwise: first differs at step {first}'}"
        f" (val {'equal' if val == p5['val'] else 'differs'}); step avg {step_ms:.1f} ms (first step included), "
        f"steady {steady:.1f} ms against phase 6's {p5['steady_ms']:.1f} ms; peak {peak / 2**30:.2f} GiB; "
        f"launches {launches} [{smi}]")
    if group is None or group.size != 1:
        raise AssertionError(f"the ring model has no one-rank seq group: {group}")
    want = {"flash_fwd_tc": 192, "flash_bwd_dq_tc": 168, "flash_bwd_dkv_tc": 168, "flash_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    if launches != want:
        raise AssertionError(f"launches on the ring path {launches}, want {want}")
    if len(losses) != 7 or not max(diffs) <= RING_LOSS_ATOL:
        raise AssertionError(f"ring losses off phase 5's by {max(diffs):.3g} (> {RING_LOSS_ATOL})")
    del stage
    _free(torch)
    return dict(bitwise=bitwise, first_diff=first, max_diff=max(diffs), peak_gib=peak / 2**30, step_ms=step_ms,
                steady_ms=steady)


def phase_pipe(torch, fa, smi: str, preset: str = "1b", t: int = 2048) -> dict:
    """(c): ``pipeline_apply`` over a one-rank ``pipe`` group against the same
    blocks run in sequence on the whole batch (``preset``'s blocks on rows of
    ``t`` tokens)."""
    from torch.func import functional_call

    from dmlcloud_tpu_torch.examples.train_lm import PRESETS
    from dmlcloud_tpu_torch.models.transformer import DecoderBlock, TransformerConfig, rope_frequencies
    from dmlcloud_tpu_torch.parallel import mesh as mesh_lib
    from dmlcloud_tpu_torch.parallel import pipeline_apply, runtime

    cfg = TransformerConfig(vocab_size=32000, max_seq_len=t, attn_impl="flash", **PRESETS[preset])
    torch.manual_seed(0)
    blocks = torch.nn.ModuleList(DecoderBlock(cfg, device="cuda") for _ in range(PIPE_BLOCKS))
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, None, "cuda")

    class Stage(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.blocks = blocks

        def forward(self, x):
            for block in self.blocks:
                x = block(x, cos, sin)
            return x

    stage = Stage()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(PIPE_MICRO, t, cfg.hidden_dim, generator=g, device="cuda").to(torch.bfloat16)
    cot = torch.randn(x.shape, generator=g, device="cuda").to(torch.bfloat16)

    def sequential():
        xi = x.clone().requires_grad_(True)
        y = stage(xi)
        grads = torch.autograd.grad(y, [xi, *stage.parameters()], cot)
        return y.detach(), grads

    runtime.deinitialize()
    try:
        mesh = mesh_lib.create_mesh({"pipe": 1}, device="cuda")
        stacked = {n: p.detach()[None].clone().requires_grad_(True) for n, p in stage.named_parameters()}
        stage_fn = lambda params, act: functional_call(stage, params, (act,))

        def piped():
            xi = x.clone().requires_grad_(True)
            y = pipeline_apply(stage_fn, stacked, xi.reshape(PIPE_MICRO, 1, t, -1), mesh)
            grads = torch.autograd.grad(y, [xi, *stacked.values()], cot.reshape(y.shape))
            return y.detach().reshape(x.shape), [grads[0]] + [gr[0] for gr in grads[1:]]

        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()  # the pipe path's run starts here ...
        got_y, got_g = piped()
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)  # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        want_y, want_g = sequential()
        torch.cuda.synchronize()
        # in norm only: a weight's gradient is a sum over the batch's tokens
        # rounded to bf16 once per microbatch here and once for the whole batch
        # there, so where the partial sums cancel an element can differ by
        # their bf16 ulps (phase 3 holds the kernels elementwise)
        errs = {n: (max_err(torch, a, b), rel_err(torch, a, b))
                for (a, b), n in zip(zip([got_y, *got_g], [want_y, *want_g]), ["y", "x", *stacked])}
        bad = {n: e for n, e in errs.items() if not e[1] <= REL_TOL["bfloat16"]}
        if bad or not all(bool(torch.isfinite(a).all()) for a in [got_y, *got_g]):
            raise AssertionError(f"pipeline_apply off the sequential blocks (max abs, norm-relative): {bad}")
        bitwise = bool(torch.equal(got_y, want_y)) and all(torch.equal(a, b) for a, b in zip(got_g, want_g))
        pipe_ms, seq_ms = cuda_ms(torch, piped, reps=3), cuda_ms(torch, sequential, reps=3)
    finally:
        runtime.deinitialize()
    worst = max(rel for _, rel in errs.values())
    log(f"[pipe] (c) pipeline_apply, one stage of {PIPE_BLOCKS} {preset} DecoderBlocks on a one-rank pipe group, "
        f"{PIPE_MICRO} microbatches of [1, {t}, {cfg.hidden_dim}] bf16, against the blocks on the whole batch: worst "
        f"norm-relative err {worst:.3g} (bound {REL_TOL['bfloat16']}; output and {len(errs) - 1} gradients; max abs "
        f"err {max(e for e, _ in errs.values()):.3g}; "
        f"{'bitwise' if bitwise else 'not bitwise'}); forward+backward {pipe_ms:.2f} vs {seq_ms:.2f} ms; peak "
        f"{peak / 2**30:.2f} GiB; launches {launches} [{smi}]")
    want = {"flash_fwd_tc": PIPE_BLOCKS * PIPE_MICRO, "flash_bwd_dq_tc": PIPE_BLOCKS * PIPE_MICRO,
            "flash_bwd_dkv_tc": PIPE_BLOCKS * PIPE_MICRO, "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if launches != want:
        raise AssertionError(f"launches on the pipe path {launches}, want {want}")
    del stage, blocks, stacked, x, cot
    _free(torch)
    return dict(worst_rel=worst, bitwise=bitwise, ms=pipe_ms, seq_ms=seq_ms, peak_gib=peak / 2**30)


# ---------------------------------------------------------------------------
# phase 13: the decode and serving path
# ---------------------------------------------------------------------------

SAMPLE_NEW = 32
SAMPLE_ARGV = TRAIN_ARGV + ["--sample", str(SAMPLE_NEW)]
#: a serial run's top-2 logit margin under which a differing engine token is a tie
TIE_MARGIN = 1e-4
ENGINE_FP32 = dict(max_slots=4, block_size=16, prefill_chunk=128)
SERVE_1B = dict(max_slots=8, block_size=16, prefill_chunk=256)
SERVE_REQUESTS, SERVE_PROMPTS, SERVE_NEW = 16, (128, 1024), 128


def phase_paged(torch, smi: str) -> None:
    """(a): the paged scatter and gather on the card, bitwise the CPU's, at the
    1b model's KV heads: a row with a sentinel tail, one whose positions start
    below 0, one running past its table, and a sentinel-only row."""
    from dmlcloud_tpu_torch.ops.paged_attention import gather_pages, scatter_tokens

    g = torch.Generator().manual_seed(0)
    num_blocks, bs, kh, d, nb, t = 64, 16, 8, 128, 8, 24
    pool = torch.randn(num_blocks, bs, kh, d, generator=g).to(torch.bfloat16)
    tables = torch.randperm(num_blocks, generator=g)[: 6 * nb].reshape(6, nb)
    tables[0, 6:] = num_blocks  # a sentinel tail
    tables[5] = num_blocks  # a padded row: sentinel only
    fill = torch.tensor([90, -5, 120, 0, 40, 0])  # 90 + 23 runs into the sentinel tail, 120 + 23 past the table
    positions = fill[:, None] + torch.arange(t)[None, :]
    values = torch.randn(6, t, kh, d, generator=g)
    want = scatter_tokens(pool.clone(), tables, positions, values)
    want_view = gather_pages(want, tables)
    got = scatter_tokens(pool.cuda(), tables.cuda(), positions.cuda(), values.cuda())
    got_view = gather_pages(got, tables.cuda())
    torch.cuda.synchronize()  # a device-side assert raises here and ends the run
    changed = int((want != pool).any(-1).any(-1).sum())
    if not (torch.equal(got.cpu(), want) and torch.equal(got_view.cpu(), want_view)):
        raise AssertionError("paged scatter/gather on the card differs from the CPU's")
    log(f"[serve] (a) paged scatter/gather on the card at [{num_blocks}, {bs}, {kh}, {d}] bf16, 6 rows of {t} "
        f"tokens (sentinel rows, positions past the table and below 0): bitwise equal to the CPU's; "
        f"{changed} of {num_blocks * bs} slots written [{smi}]")


def _decode_logits(torch, model, prompt, tokens):
    """The logits a greedy decode of ``tokens`` after ``prompt`` reads, fed
    ``tokens``: a prefill over the prompt, then one cached step per token."""
    from dmlcloud_tpu_torch.models.generate import decode_step, init_cache

    (b, t), n = prompt.shape, tokens.shape[1]
    cache = init_cache(model.cfg, b, t + n, dtype=model.cfg.dtype, device="cuda")
    logits, cache = decode_step(model, prompt, cache, attend_len=t)
    out = [logits[:, -1]]
    for j in range(n - 1):
        logits, cache = decode_step(model, tokens[:, j : j + 1], cache, offset=t + j)
        out.append(logits[:, 0])
    return torch.stack(out, 1)  # [B, n, V]


def phase_sample(torch, fa, smi: str, p5: dict) -> None:
    """(b): ``train_lm --sample`` on phase 5's argv; its decode held against the
    no-cache dot-path forward of the same model. In bf16 the two differ by
    rounding alone, as far as bf16 puts the forward from exact arithmetic
    (24 layers: ≈ 1.6e-2 and 1.8e-2 in norm on an H100 80GB HBM3, PERF.md), so the
    decode is held tight in an fp32 twin of the same weights (``REL_TOL``
    fp32), and the bf16 decode within the larger of ``REL_TOL`` bf16 and that
    rounding distance, measured here."""
    import dataclasses

    from dmlcloud_tpu_torch.examples import train_lm
    from dmlcloud_tpu_torch.models.transformer import DecoderLM

    fa.reset_launch_counts()  # the sampled run starts here ...
    t0 = time.perf_counter()
    stage = train_lm.main(SAMPLE_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)  # ... and ends after the decode
    losses, val = _losses(stage)
    if launches != p5["launches"]:
        raise AssertionError(f"--sample run launches {launches}, phase 5 {p5['launches']}")
    model, out = stage.model, stage.sample_output
    prompt = torch.as_tensor(stage.sample_prompt).long().cuda()
    b, t = prompt.shape
    if tuple(out.shape) != (b, SAMPLE_NEW):
        raise AssertionError(f"--sample tokens {tuple(out.shape)}, want {(b, SAMPLE_NEW)}")
    seq = torch.cat([prompt, out[:, :-1]], 1)
    rel = lambda a, r: max(rel_err(torch, a[:, j], r[:, j]) for j in range(SAMPLE_NEW))
    dec = _decode_logits(torch, model, prompt, out)
    twins = {}
    for dtype in (model.cfg.dtype, torch.float32):
        twin = DecoderLM(dataclasses.replace(model.cfg, attn_impl="dot", dtype=dtype), device="cuda")
        twin.load_state_dict(model.state_dict())
        with torch.no_grad():
            twins[dtype] = twin, twin(seq)[:, t - 1 :]  # [B, N, V]
    ref, (f32, ref32) = twins[model.cfg.dtype][1], twins[torch.float32]
    err, err32 = rel(dec, ref), rel(_decode_logits(torch, f32, prompt, out), ref32)
    rounding = rel(ref, ref32)  # bf16's own distance from exact arithmetic
    bound = max(REL_TOL["bfloat16"], rounding)
    differ = (dec.argmax(-1) != ref.argmax(-1)).any(0).nonzero()
    first = None if differ.numel() == 0 else int(differ[0])
    greedy = bool(torch.equal(dec.argmax(-1), out))
    log(f"[serve] (b) train_lm 1b --sample {SAMPLE_NEW}: {wall:.1f} s (training included); losses "
        f"{'bitwise equal to' if (losses, val) == (p5['losses'], p5['val']) else 'differ from'} phase 5's; launches "
        f"{launches}; decode logits against the no-cache dot forward, worst step in norm: fp32 twin {err32:.3g} "
        f"(bound {REL_TOL['float32']}); bf16 {err:.4g} (bound {bound:.4g}: bf16 forward vs fp32 {rounding:.4g}), "
        f"max abs err {max_err(torch, dec, ref):.3g}, first step whose argmax differs: {first}; sampled tokens are "
        f"the decode's argmax: {greedy} [{smi}]")
    if not bool(torch.isfinite(dec).all()) or not err32 <= REL_TOL["float32"] or not err <= bound:
        raise AssertionError(f"decode logits off the no-cache forward: fp32 {err32:.3g}, bf16 {err:.3g} "
                             f"(bound {bound:.3g})")
    del stage, model, twins, f32, dec, ref, ref32
    _free(torch)


def _margin(torch, model, prompt, tokens) -> float:
    """Top-2 logit margin of the next token after ``prompt`` + ``tokens``
    (a no-cache forward of ``model``)."""
    with torch.no_grad():
        seq = torch.cat([torch.as_tensor(prompt).long().cuda(), torch.as_tensor(tokens).long().cuda()])
        top = model(seq[None])[0, -1].topk(2).values
    return float(top[0] - top[1])


def phase_engine(torch, smi: str) -> None:
    """(c): ``ServeEngine`` against serial ``generate``, token by token, at the
    1b width in fp32 with 2 layers."""
    import numpy as np

    from dmlcloud_tpu_torch.examples.train_lm import PRESETS
    from dmlcloud_tpu_torch.models.generate import generate
    from dmlcloud_tpu_torch.models.transformer import DecoderLM, TransformerConfig
    from dmlcloud_tpu_torch.serve import ServeEngine

    cfg = TransformerConfig(vocab_size=32000, max_seq_len=512, dtype=torch.float32,
                            **dict(PRESETS["1b"], num_layers=2))
    model = DecoderLM(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    rs = np.random.RandomState(0)
    specs = [(int(rs.randint(16, 301)), int(rs.randint(16, 65))) for _ in range(8)]
    prompts = [rs.randint(0, cfg.vocab_size, n) for n, _ in specs]
    engine = ServeEngine(model, **ENGINE_FP32)
    rids = [engine.submit(p, m) for p, (_, m) in zip(prompts, specs)]
    t0 = time.perf_counter()
    out = engine.run()
    wall = time.perf_counter() - t0
    ties = []
    for rid, p, (n, m) in zip(rids, prompts, specs):
        ref = generate(model, p[None], m)[0].cpu().numpy()
        got = out.get(rid)
        if got is None or len(got) != m:
            raise AssertionError(f"request {rid} ({n} + {m} tokens) ended {engine.status(rid)} with {got}")
        if not np.array_equal(got, ref):
            j = int(np.nonzero(got != ref)[0][0])
            margin = _margin(torch, model, p, ref[:j])
            ties.append((rid, j, margin))
            if not margin < TIE_MARGIN:
                raise AssertionError(f"request {rid}: engine token {got[j]} != serial {ref[j]} at step {j}, where "
                                     f"the serial top-2 margin is {margin:.3g} (not a tie)")
    engine.pool.assert_consistent()
    statuses = set(engine.statuses().values())
    if engine.leaked_blocks() or statuses != {"ok"}:
        raise AssertionError(f"engine ended with {engine.leaked_blocks()} leaked blocks, statuses {statuses}")
    log(f"[serve] (c) ServeEngine (1b width, 2 layers, fp32; {ENGINE_FP32}) on 8 ragged requests "
        f"(prompts {[n for n, _ in specs]}, new {[m for _, m in specs]}) in {wall:.2f} s: "
        + ("every output equal to serial generate" if not ties else
           f"equal to serial generate but at ties (request, step, top-2 margin) {ties}")
        + f"; 0 leaked blocks, all ok [{smi}]")
    del engine, model
    _free(torch)


def phase_serve(torch, smi: str) -> None:
    """(d): the full 1b model in bf16 serving 16 requests; then beam search."""
    import numpy as np

    from dmlcloud_tpu_torch.examples.train_lm import PRESETS
    from dmlcloud_tpu_torch.models.generate import beam_search
    from dmlcloud_tpu_torch.models.transformer import DecoderLM, TransformerConfig
    from dmlcloud_tpu_torch.serve import ServeEngine

    cfg = TransformerConfig(vocab_size=32000, max_seq_len=2048, **PRESETS["1b"])
    model = DecoderLM(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    rs = np.random.RandomState(1)
    lens = rs.randint(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1, SERVE_REQUESTS)
    prompts = [rs.randint(0, cfg.vocab_size, n) for n in lens]
    blocks = -(-(SERVE_PROMPTS[1] + SERVE_NEW) // SERVE_1B["block_size"])
    engine = ServeEngine(model, num_blocks=SERVE_1B["max_slots"] * blocks, **SERVE_1B)
    warm = engine.submit(prompts[0][:256], 4)  # first calls (cuBLAS handles, allocator) outside the timing
    engine.run()
    if engine.status(warm) != "ok":
        raise AssertionError(f"warm-up request ended {engine.status(warm)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sched = engine.scheduler
    rids = [engine.submit(p, SERVE_NEW) for p in prompts]
    step_ms, rows, profiled = [], [], None
    t0 = time.perf_counter()
    while not engine.idle:
        # a step with no prefill pending and no admission possible runs only the decode batch
        decode_only = not sched.prefilling and (sched.num_waiting == 0 or sched.active >= sched.max_slots)
        n = len(sched.running)
        if decode_only and profiled is None and n:
            profiled = n, profile_call(torch, engine.step)
            continue
        s0 = time.perf_counter()
        engine.step()
        if decode_only:
            step_ms.append((time.perf_counter() - s0) * 1e3)
            rows.append(n)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    seqs = [engine.sequence(r) for r in rids]
    if engine.leaked_blocks() or any(s.status != "ok" or len(s.out) != SERVE_NEW for s in seqs):
        raise AssertionError(f"serving ended with {engine.leaked_blocks()} leaked blocks, statuses "
                             f"{[s.status for s in seqs]}")
    engine.pool.assert_consistent()
    ttft = np.asarray([(s.first_token - s.arrival) * 1e3 for s in seqs])
    pool_gib = engine.pool.stats()["bytes_total"] / 2**30
    log(f"[serve] (d) ServeEngine, 1b bf16 (24 layers), {SERVE_REQUESTS} requests (prompts {SERVE_PROMPTS[0]}-"
        f"{SERVE_PROMPTS[1]}: {int(lens.sum())} tokens; {SERVE_NEW} new each), {SERVE_1B}: {wall:.2f} s, "
        f"{SERVE_REQUESTS * SERVE_NEW / wall:.1f} output tokens/s; TTFT p50 {np.percentile(ttft, 50):.1f} ms, p99 "
        f"{np.percentile(ttft, 99):.1f} ms; {len(step_ms)} decode-only steps: {statistics.median(step_ms):.2f} ms "
        f"median ({min(step_ms):.2f}-{max(step_ms):.2f}), {sum(rows) / sum(step_ms) * 1e3:.1f} decode tokens/s; pool "
        f"{engine.pool.num_blocks} blocks = {pool_gib:.3f} GiB; peak memory {peak / 2**30:.2f} GiB; 0 leaked blocks "
        f"[{smi}]")
    n, (wall_us, busy_us, events) = profiled
    log_profile("serve", f"decode step of {n} rows [{smi}]", wall_us, busy_us, events)
    del engine

    prompt = rs.randint(0, cfg.vocab_size, (2, 256))
    mask = np.ones((2, 256), np.int32)
    mask[1, :128] = 0  # a ragged second prompt
    beam_search(model, prompt, 4, num_beams=4, prompt_mask=mask)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, scores = beam_search(model, prompt, 32, num_beams=4, prompt_mask=mask)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    if tuple(toks.shape) != (2, 32) or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"beam search gave {tuple(toks.shape)} tokens, scores {scores}")
    log(f"[serve] (d) beam_search, 1b bf16, 2 prompts of 256 (one left-padded to 128), 4 beams, 32 new: "
        f"{beam_s * 1e3:.1f} ms = {beam_s / 32 * 1e3:.2f} ms per step; scores {[round(float(x), 4) for x in scores]} "
        f"[{smi}]")
    del model
    _free(torch)


# ---------------------------------------------------------------------------
# phase 14: the vision and encoder families
# ---------------------------------------------------------------------------

#: BERT-base's attention as the flash path sees it: B=32 rows of T=512, 12/12
#: heads of 64, bf16, a {0,1} keep-mask as segment ids, causal=False
BERT_FORM = dict(b=32, t=512, h=12, d=64)
#: the real lengths of the padded rows are drawn from this range
BERT_LENGTHS = (64, 512)
BERT_STEPS = 4
#: ResNet-50 at one of bench.py's candidate batches, 224x224, bf16 on fp32 parameters
RESNET50 = dict(batch=256, size=224, steps=6)
#: bench.py:58-65: 8.2e9 FLOP per image forward (4.1 GMACs), training 3x that
RESNET_TRAIN_FLOPS_PER_IMAGE = 3 * 8.2e9
#: ResNet-18 in fp32 on the card against the CPU (TF32 off, phase 1): 3 SGD
#: steps at lr 0.1 with momentum carry the two sides' differently rounded
#: convolutions and batch statistics forward. Relative (losses) and
#: norm-relative (each running statistic). Sound fp32 runs read ~2e-6; the
#: same run with TF32 on is logged beside it as the control the bound must
#: not admit
RESNET18 = dict(batch=8, size=32)
RESNET_CARD_REL = 1e-5
CLIP_ARGV = ["--preset", "vit-l", "--global-batch", "64", "--steps-per-epoch", "8", "--epochs", "1"]
#: the vit-l preset's widths at ``layers`` blocks per tower, ``pairs`` pairs:
#: one bf16 forward and backward on the card (towers, projections,
#: ``clip_loss``) against the same weights and batch in fp32 on the CPU.
#: Norm-relative (embeddings, the flat gradient) and relative (loss): bf16
#: activations against fp32
CLIP_CHECK = dict(layers=2, pairs=8)
CLIP_CARD_REL = 5e-2


def _keep_segments(torch, b: int, t: int, seed: int = 5):
    """A padded batch's keep-mask as int32 segment ids [B, T] (1 real, 0 pad)
    and the real lengths, drawn from ``BERT_LENGTHS``."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(BERT_LENGTHS[0], BERT_LENGTHS[1] + 1, (b,), generator=g)
    seg = (torch.arange(t)[None, :] < lens[:, None]).to(torch.int32)
    return seg.cuda(), [int(n) for n in lens]


def phase_bert_kernels(torch, fa) -> dict:
    """(a): the tensor-core K1-K3 in BERT's form, each held against its plain
    version and timed beside it, its bound on the kept pairs (real attends
    real, pad attends pad) and ``scaled_dot_product_attention`` with the
    equivalent boolean mask. Rows by kernel."""
    import torch.nn.functional as F

    sh = BERT_FORM
    b, t, h, d = sh["b"], sh["t"], sh["h"], sh["d"]
    q, k, v, do = _inputs(torch, torch.bfloat16, b, t, h, h, d)
    seg, lens = _keep_segments(torch, b, t)
    args = (seg, False, 1.0 / math.sqrt(d), None)
    out_p, lse_p = fa.attn_fwd_plain(q, k, v, *args)
    delta = fa.softmax_delta(out_p, do)
    bwd = (q, k, v, do, lse_p, delta, *args)
    dq_p = fa.attn_dq_plain(*bwd)
    dk_p, dv_p = fa.attn_dkv_plain(*bwd)
    out, lse = fa.attn_fwd_tc(q, k, v, *args)
    dq = fa.attn_dq_tc(*bwd)
    dk, dv = fa.attn_dkv_tc(*bwd)
    torch.cuda.synchronize()
    errs = {"K1": assert_close(torch, out, out_p, "bfloat16", "bert K1 out"),
            "K1 lse": assert_close(torch, lse, lse_p, "float32", "bert K1 lse"),
            "K2": assert_close(torch, dq, dq_p, "bfloat16", "bert K2 dq"),
            "K3 dk": assert_close(torch, dk, dk_p, "bfloat16", "bert K3 dk"),
            "K3 dv": assert_close(torch, dv, dv_p, "bfloat16", "bert K3 dv")}
    log(f"[bert] (a) kernels at B={b}, T={t}, {h}/{h} heads of {d}, keep-mask segments (lengths {min(lens)}-"
        f"{max(lens)}), causal=False: " + "  ".join(f"{key} {e:.2e}/{r:.2e}" for key, (e, r) in errs.items())
        + " (max abs/norm-relative)")
    times = {"K1": (cuda_ms(torch, lambda: fa.attn_fwd_tc(q, k, v, *args)),
                    cuda_ms(torch, lambda: fa.attn_fwd_plain(q, k, v, *args), reps=5)),
             "K2": (cuda_ms(torch, lambda: fa.attn_dq_tc(*bwd)), cuda_ms(torch, lambda: fa.attn_dq_plain(*bwd), reps=5)),
             "K3": (cuda_ms(torch, lambda: fa.attn_dkv_tc(*bwd)),
                    cuda_ms(torch, lambda: fa.attn_dkv_plain(*bwd), reps=5))}
    # yardstick only: one library call for the same attention, the mask as a boolean [B, 1, T, T]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    mask = (seg[:, :, None] == seg[:, None, :])[:, None]
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    lib_fwd = cuda_ms(torch, sdpa)
    o = sdpa()
    lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
    pairs = h * sum(n * n + (t - n) ** 2 for n in lens)
    work = _work(b, t, h, h, d, pairs=pairs, seg=True)
    sources = {"K1": ("flash_fwd_tc", "dmlcloud_tpu/ops/flash_attention.py:149 (_attn_kernel, pallas_call :773)"),
               "K2": ("flash_bwd_dq_tc", "dmlcloud_tpu/ops/flash_attention.py:229 (_dq_kernel, pallas_call :847)"),
               "K3": ("flash_bwd_dkv_tc", "dmlcloud_tpu/ops/flash_attention.py:276 (_dkv_kernel, pallas_call :883)")}
    rows = {}
    for key, (ms, plain_ms) in times.items():
        flops, nbytes = work[key]
        op_ms, byte_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        name, replaces = sources[key]
        rows[key] = {"name": name, "route": "cuda", "source": "dmlcloud_tpu_torch/csrc/flash_attention_tc.cu",
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": max(e for n, (e, _) in errs.items() if n.startswith(key) and not n.endswith("lse")),
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": max(op_ms, byte_ms),
                     "bound_by": "operations" if op_ms >= byte_ms else "bytes",
                     "library_ms": lib_fwd if key == "K1" else lib_bwd,
                     "shape": f"BERT-base: B={b}, T={t}, {h}/{h} heads of {d}, keep-mask segments, causal=False"}
        log(f"[bert] (a) {key} {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {rows[key]['bound_ms']:.4f} ms by "
            f"{rows[key]['bound_by']}, {rows[key]['bound_ms'] / ms:.1%} of it; library {rows[key]['library_ms']:.3f} ms "
            f"with the boolean mask)")
    log(f"[bert] (a) kept pairs {pairs} of {b * h * t * t} ({pairs / (b * h * t * t):.1%}); scaled_dot_product_attention "
        f"with the mask: fwd {lib_fwd:.3f} ms, bwd {lib_bwd:.3f} ms")
    del q, k, v, do, out, lse, dq, dk, dv, out_p, lse_p, dq_p, dk_p, dv_p, qt, kt, vt, o, mask
    _free(torch)
    return rows


def _bert_batches(torch, cfg, n: int, seed: int = 11) -> list[dict]:
    """``n`` padded batches of BERT_FORM's rows on the card: random tokens,
    real lengths from ``BERT_LENGTHS`` (pad id 0 after them), 2 classes."""
    b, t = BERT_FORM["b"], BERT_FORM["t"]
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        lens = torch.randint(BERT_LENGTHS[0], BERT_LENGTHS[1] + 1, (b,), generator=g)
        mask = (torch.arange(t)[None, :] < lens[:, None]).to(torch.int32)
        tokens = torch.randint(1, cfg.vocab_size, (b, t), generator=g) * mask
        out.append({"tokens": tokens.cuda(), "mask": mask.cuda(), "label": torch.randint(0, 2, (b,), generator=g).cuda()})
    return out


def phase_bert(torch, fa, smi: str) -> dict:
    """(b): ``BertForSequenceClassification`` at ``BertConfig()`` (BERT-base,
    T=512) with ``attn_impl="flash"``: its hidden states at the real positions
    against the dot path's on the same weights and batch (``MODEL_TOL``: the dot
    path rounds its scores to bf16, as the reference's does); then
    ``BERT_STEPS`` AdamW steps of batch 32 padded rows through the
    ``TrainingPipeline``, the main path: exactly 12 launches each of the
    tensor-core K1/K2/K3 per step and none of the CUDA-core kernels; the
    steady step, real tokens/s, peak memory and one profiled step."""
    import torch.nn.functional as F

    import dmlcloud_tpu_torch as dml
    from dmlcloud_tpu_torch.models.bert import BertConfig, BertForSequenceClassification
    from dmlcloud_tpu_torch.optim import adamw

    cfg = BertConfig(attn_impl="flash")
    batches = _bert_batches(torch, cfg, BERT_STEPS)
    model = BertForSequenceClassification(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    dot = BertForSequenceClassification(BertConfig(attn_impl="dot"), device="cuda")
    dot.load_state_dict(model.state_dict())
    first = batches[0]
    with torch.no_grad():
        real = first["mask"].bool()
        h_flash = model.bert(first["tokens"], first["mask"])[real].float()
        h_dot = dot.bert(first["tokens"], first["mask"])[real].float()
    err, rel = max_err(torch, h_flash, h_dot), rel_err(torch, h_flash, h_dot)
    log(f"[bert] (b) BERT-base hidden states at the {int(real.sum())} real positions, flash against dot: max abs "
        f"{err:.4f}, norm-relative {rel:.4f} (hidden std {float(h_dot.std()):.3f}; bound {MODEL_TOL})")
    if not (torch.allclose(h_flash, h_dot, atol=MODEL_TOL["atol"], rtol=MODEL_TOL["rtol"])
            and rel <= MODEL_TOL["rel_norm"] and bool(torch.isfinite(h_flash).all())):
        raise AssertionError(f"BERT flash hidden states off the dot path's: max abs {err:.4f}, norm-relative {rel:.4f}")
    del dot, h_flash, h_dot
    _free(torch)

    class BertStage(dml.TrainValStage):
        def pre_stage(self):
            self.pipeline.register_model("bert", model, verbose=False)
            self.pipeline.register_optimizer("adamw", adamw(2e-5, weight_decay=0.01))
            self.pipeline.register_dataset("train", batches, verbose=False)

        def step(self, state, batch):
            return F.cross_entropy(state.model(batch["tokens"], batch["mask"]), batch["label"])

        def val_epoch(self):
            pass

    pipe = dml.TrainingPipeline({"seed": 0}, name="bert-base", device="cuda")
    stage = BertStage()
    pipe.append_stage(stage, max_epochs=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()  # BERT's path starts here ...
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)  # ... and ends here
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in stage.train_losses]
    want = {"flash_fwd_tc": 12 * BERT_STEPS, "flash_bwd_dq_tc": 12 * BERT_STEPS, "flash_bwd_dkv_tc": 12 * BERT_STEPS,
            "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if launches != want:
        raise AssertionError(f"BERT launches {launches}, want {want} (12 per step each)")
    if len(losses) != BERT_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"BERT losses {losses}")
    step_ms, times = steady_ms(torch, stage, first)
    tokens = int(first["mask"].sum())
    log(f"[bert] (b) {BERT_STEPS} AdamW steps through the TrainingPipeline in {wall:.1f} s wall, losses {losses}; "
        f"launches {launches}; steady step {step_ms:.2f} ms median of {[round(x, 2) for x in times]} = "
        f"{tokens / step_ms * 1e3:.0f} real tokens/s ({tokens} real of {BERT_FORM['b'] * BERT_FORM['t']}; "
        f"{BERT_FORM['b'] / step_ms * 1e3:.1f} sequences/s); peak memory {peak / 2**30:.2f} GiB [{smi}]")
    wall_us, busy_us, events = profile_step(torch, stage, first)
    log_profile("bert", f"BERT-base train step (B={BERT_FORM['b']}, T={BERT_FORM['t']}) [{smi}]", wall_us, busy_us,
                events, top=10)
    del pipe, stage, model, batches, first
    _free(torch)
    return {"launches": launches, "step_ms": step_ms, "tokens_s": tokens / step_ms * 1e3, "peak_gib": peak / 2**30}


def phase_resnet50(torch, smi: str) -> dict:
    """(c): ResNet-50 at 224x224, batch 256, bf16 on fp32 parameters,
    ``sgd(0.1, momentum=0.9)``, through the ``TrainingPipeline`` (the batch on
    the card, as bench.py stages it): steady images/s, ``misc/mfu`` at 3 x
    8.2e9 FLOP per image, peak memory; then a plain hand-written loop of the
    same model and optimizer and the ratio of the two (bench.py's
    framework/raw), and one profiled step."""
    import torch.nn.functional as F

    import dmlcloud_tpu_torch as dml
    from dmlcloud_tpu_torch.models.resnet import ResNet50
    from dmlcloud_tpu_torch.optim import sgd

    n, size, steps = RESNET50["batch"], RESNET50["size"], RESNET50["steps"]
    g = torch.Generator(device="cuda").manual_seed(3)
    batch = {"image": torch.rand(n, size, size, 3, device="cuda", generator=g),
             "label": torch.randint(0, 1000, (n,), device="cuda", generator=g)}

    class ResNetStage(dml.TrainValStage):
        def pre_stage(self):
            model = ResNet50(device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
            self.pipeline.register_model("resnet50", model, verbose=False)
            self.pipeline.register_optimizer("sgd", sgd(0.1, momentum=0.9))
            self.pipeline.register_dataset("train", [batch] * steps, verbose=False)

        def step(self, state, b):
            return F.cross_entropy(state.model(b["image"]), b["label"])

        def step_flops(self):
            return RESNET_TRAIN_FLOPS_PER_IMAGE * n

        def val_epoch(self):
            pass

    pipe = dml.TrainingPipeline({"seed": 0}, name="resnet50", device="cuda")
    stage = ResNetStage()
    pipe.append_stage(stage, max_epochs=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in stage.train_losses]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"ResNet-50 losses {losses}")
    mfu = float(stage.tracker["misc/mfu"][-1])
    avg_ms = float(stage.tracker["misc/train_step_avg_ms"][-1])
    step_ms, times = steady_ms(torch, stage, batch, steps=5)
    steady_mfu = RESNET_TRAIN_FLOPS_PER_IMAGE * n / (step_ms / 1e3) / PEAK_BF16_FLOPS
    log(f"[resnet] (c) ResNet-50 {size}x{size}, batch {n}, {steps} SGD steps through the TrainingPipeline in "
        f"{wall:.1f} s wall, losses {[round(x, 4) for x in losses]}; epoch step average {avg_ms:.1f} ms (first step "
        f"included), misc/mfu {mfu:.4f}; steady step {step_ms:.2f} ms median of {[round(x, 2) for x in times]} = "
        f"{n / step_ms * 1e3:.1f} images/s, MFU {steady_mfu:.4f}; peak memory {peak / 2**30:.2f} GiB [{smi}]")
    wall_us, busy_us, events = profile_step(torch, stage, batch)
    log_profile("resnet", f"ResNet-50 train step (batch {n}) [{smi}]", wall_us, busy_us, events, top=12)
    del pipe, stage
    _free(torch)

    # bench.py's raw path: the same model and optimizer in a hand-written loop
    model = ResNet50(device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    opt = sgd(0.1, momentum=0.9)(model.parameters())

    def raw_step():
        opt.zero_grad(set_to_none=True)
        F.cross_entropy(model(batch["image"]), batch["label"]).backward()
        opt.step()

    raw_ms = cuda_ms(torch, raw_step, reps=5, warmup=2)
    log(f"[resnet] (c) the plain loop: {raw_ms:.2f} ms per step = {n / raw_ms * 1e3:.1f} images/s; framework / plain "
        f"throughput {raw_ms / step_ms:.4f} [{smi}]")
    del model, opt, batch
    _free(torch)
    return {"images_s": n / step_ms * 1e3, "raw_images_s": n / raw_ms * 1e3, "ratio": raw_ms / step_ms, "mfu": mfu,
            "steady_mfu": steady_mfu, "peak_gib": peak / 2**30}


def _resnet18_run(torch, device: str, steps: int, root: str | None = None, resume: bool = False,
                  signal_after: int | None = None):
    """ResNet-18 (32x32, batch 8, fp32, ``sgd(0.1, momentum=0.9)``) through
    the TrainingPipeline on ``device``, from the CPU-initialised seed-0
    weights, on seeded host batches; with ``root`` step saves every 2 steps,
    with ``signal_after`` a SIGUSR1 after that many batches."""
    import numpy as np
    import torch.nn.functional as F

    import dmlcloud_tpu_torch as dml
    from dmlcloud_tpu_torch.models.resnet import ResNet18
    from dmlcloud_tpu_torch.optim import sgd

    rs = np.random.RandomState(4)
    n, size = RESNET18["batch"], RESNET18["size"]
    batches = [{"image": rs.rand(n, size, size, 3).astype(np.float32), "label": rs.randint(0, 10, n)}
               for _ in range(steps)]

    class Stage(dml.TrainValStage):
        def pre_stage(self):
            model = ResNet18(num_classes=10, dtype=torch.float32, device="cpu", generator=torch.Generator().manual_seed(0))
            self.pipeline.register_model("resnet18", model, verbose=False)
            self.pipeline.register_optimizer("sgd", sgd(0.1, momentum=0.9))
            ds = batches if signal_after is None else _SignalAfter(batches, signal_after)
            self.pipeline.register_dataset("train", ds, verbose=False)

        def checkpoint_every_steps(self):
            return 2

        def step(self, state, b):
            return F.cross_entropy(state.model(b["image"]), b["label"].long())

        def val_epoch(self):
            pass

    pipe = dml.TrainingPipeline({"seed": 0}, name="resnet18", device=device)
    if root is not None:
        pipe.enable_checkpointing(root, resume=resume)
    if signal_after is not None:
        pipe.enable_preemption_handling(("SIGUSR1",))
    stage = Stage()
    pipe.append_stage(stage, max_epochs=1)
    pipe.run()
    return pipe, stage


def phase_resnet18(torch, smi: str) -> None:
    """(d): ResNet-18 in fp32, 3 steps on the card against the same run on the
    CPU (losses and running statistics within ``RESNET_CARD_REL``); then under
    ``enable_determinism`` a run of 6 steps preempted by SIGUSR1 after 3
    (drained at the step-4 save) and resumed, bitwise equal to an
    uninterrupted one in parameters, momentum, running statistics and losses."""
    from dmlcloud_tpu_torch.utils.seed import enable_determinism

    t0 = time.perf_counter()
    _, cpu = _resnet18_run(torch, "cpu", 3)
    cpu_l = [float(x) for x in cpu.train_losses]
    cpu_stats = dict(cpu.state.model.named_buffers())

    def errs(card) -> tuple[list[float], float, float]:
        card_l = [float(x) for x in card.train_losses]
        stats = dict(card.state.model.named_buffers())
        return (card_l, max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l)),
                max(rel_err(torch, stats[n].cpu(), b) for n, b in cpu_stats.items()))

    card_l, loss_rel, stat_rel = errs(_resnet18_run(torch, "cuda", 3)[1])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        _, tf32_loss, tf32_stat = errs(_resnet18_run(torch, "cuda", 3)[1])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    log(f"[resnet] (d) ResNet-18 fp32 32x32 batch 8, 3 SGD steps, card against CPU: losses {card_l} / {cpu_l} "
        f"(worst relative {loss_rel:.3g}), running statistics worst norm-relative {stat_rel:.3g} (bound "
        f"{RESNET_CARD_REL}); control, the card with TF32 on: {tf32_loss:.3g} and {tf32_stat:.3g}")
    if not (loss_rel <= RESNET_CARD_REL and stat_rel <= RESNET_CARD_REL):
        raise AssertionError(f"ResNet-18 on the card off the CPU: losses {loss_rel:.3g}, statistics {stat_rel:.3g}")
    del cpu, cpu_stats
    _free(torch)

    root = tempfile.mkdtemp(prefix="chip_smoke_resnet_")
    enable_determinism()
    try:
        _, control = _resnet18_run(torch, "cuda", 6)
        pipe1, preempted = _resnet18_run(torch, "cuda", 6, root=root, resume=True, signal_after=3)
        if not (preempted._mid_epoch_exit and preempted.state.step == 4):
            raise AssertionError(f"ResNet-18 preempted run ended at step {preempted.state.step}, want a drain at 4")
        _, resumed = _resnet18_run(torch, "cuda", 6, root=str(pipe1.checkpoint_dir.path), resume=True)
        got, want = resumed.state.state_dict(), control.state.state_dict()
        mismatched = []
        for part in ("params", "extras"):
            mismatched += [f"{part}/{n}" for n in want[part] if not torch.equal(got[part][n], want[part][n])]
        mismatched += [f"trace/{n}" for n in want["opt_state"]["trace"]
                       if not torch.equal(got["opt_state"]["trace"][n], want["opt_state"]["trace"][n])]
        tail = [float(x) for x in control.train_losses[4:]]
        if [float(x) for x in resumed.train_losses] != tail:
            mismatched.append("losses")
        if mismatched or resumed.state.step != 6:
            raise AssertionError(f"ResNet-18 resume not bitwise: {mismatched[:8]}, step {resumed.state.step}")
        log(f"[resnet] (d) under enable_determinism: preempted after step 3, drained at the step-4 save, resumed: "
            f"parameters, momentum, {len(want['extras'])} running statistics and losses {tail} bitwise equal to the "
            f"uninterrupted run; (d) in {time.perf_counter() - t0:.1f} s [{smi}]")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    _free(torch)


def phase_clip_width(torch, smi: str, device: str = "cuda") -> None:
    """(e) first: the vit-l preset's towers at ``CLIP_CHECK["layers"]`` blocks
    each, one bf16 forward and backward through ``clip_loss`` on the card,
    held against the same weights and batch in fp32 on the CPU within
    ``CLIP_CARD_REL``: loss, both embeddings and the flat gradient."""
    import dataclasses

    from dmlcloud_tpu_torch.examples import pod_clip_vit
    from dmlcloud_tpu_torch.models.clip import CLIP, clip_loss

    t0 = time.perf_counter()
    cfg = pod_clip_vit.clip_config("vit-l")
    layers = CLIP_CHECK["layers"]
    card_cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, num_layers=layers),
                                   text=dataclasses.replace(cfg.text, num_layers=layers))
    cpu_cfg = dataclasses.replace(card_cfg, vision=dataclasses.replace(card_cfg.vision, dtype=torch.float32),
                                  text=dataclasses.replace(card_cfg.text, dtype=torch.float32))
    batch = next(iter(pod_clip_vit.SyntheticPairs(card_cfg, CLIP_CHECK["pairs"], 1, seed=7)))
    ref = CLIP(cpu_cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = CLIP(card_cfg, device=device)
    card.load_state_dict(ref.state_dict())

    def run(model, device: str):
        img, txt, scale = model(torch.from_numpy(batch["image"]).to(device),
                                torch.from_numpy(batch["tokens"]).to(device))
        loss = clip_loss(img, txt, scale)
        loss.backward()
        grad = torch.cat([p.grad.float().flatten().cpu() for p in model.parameters()])
        return float(loss.detach()), img.detach().cpu(), txt.detach().cpu(), grad

    want, got = run(ref, "cpu"), run(card, device)
    loss_rel = abs(got[0] - want[0]) / abs(want[0])
    img_rel, txt_rel, grad_rel = (rel_err(torch, g, w) for g, w in zip(got[1:], want[1:]))
    log(f"[clip] (e) vit-l widths at {layers}+{layers} blocks, {CLIP_CHECK['pairs']} pairs, bf16 on the card against "
        f"fp32 on the CPU: loss {got[0]:.5f} / {want[0]:.5f} (relative {loss_rel:.3g}), image embeddings "
        f"{img_rel:.3g}, text embeddings {txt_rel:.3g}, gradient ({want[3].numel()} values) {grad_rel:.3g} "
        f"norm-relative (bound {CLIP_CARD_REL}); in {time.perf_counter() - t0:.1f} s [{smi}]")
    if not max(loss_rel, img_rel, txt_rel, grad_rel) <= CLIP_CARD_REL:
        raise AssertionError(f"CLIP vit-l widths on the card off the fp32 CPU run: loss {loss_rel:.3g}, embeddings "
                             f"{img_rel:.3g} / {txt_rel:.3g}, gradient {grad_rel:.3g}")
    del ref, card
    _free(torch)


def phase_clip(torch, smi: str) -> dict:
    """(e): the vit-l towers against an fp32 CPU run (``phase_clip_width``);
    then ``examples.pod_clip_vit`` at the vit-l preset (ViT-L/16 image tower,
    the CLIP text tower) with 64 pairs per step on one card for 8 steps:
    finite and falling losses, accuracy, the steady step, pairs/s and peak
    memory; then the same with ``--mesh fsdp=1`` (FSDP2 over a one-rank NCCL
    group), bitwise equal in every step's loss."""
    from dmlcloud_tpu_torch.examples import pod_clip_vit
    from dmlcloud_tpu_torch.parallel import runtime

    phase_clip_width(torch, smi)
    runtime.deinitialize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stage = pod_clip_vit.main(CLIP_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in stage.train_losses]
    acc, scale = float(stage.tracker["train/accuracy"][-1]), float(stage.tracker["train/logit_scale"][-1])
    n_params = sum(p.numel() for p in stage.state.model.parameters())
    if len(losses) != 8 or not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"CLIP losses not finite and falling: {losses}")
    batch = next(iter(stage._feed(stage.train_dataset())))
    step_ms, times = steady_ms(torch, stage, batch)
    pairs = int(batch["image"].shape[0])
    log(f"[clip] (e) examples.pod_clip_vit {' '.join(CLIP_ARGV)}: {n_params / 1e6:.1f} M parameters, 8 steps in "
        f"{wall:.1f} s wall (model build and data included), losses {[round(x, 4) for x in losses]}, epoch accuracy "
        f"{acc:.4f}, logit scale {scale:.3f}; epoch step average {float(stage.tracker['misc/train_step_avg_ms'][-1]):.1f}"
        f" ms (host data included); steady step {step_ms:.2f} ms median of {[round(x, 2) for x in times]} = "
        f"{pairs / step_ms * 1e3:.1f} pairs/s; peak memory {peak / 2**30:.2f} GiB [{smi}]")
    del stage, batch
    _free(torch)
    runtime.deinitialize()
    try:
        meshed = pod_clip_vit.main(CLIP_ARGV + ["--mesh", "fsdp=1"])
        torch.cuda.synchronize()
        m_losses = [float(x) for x in meshed.train_losses]
        plan = meshed.pipeline.models["clip"].plan
        if not (plan is not None and plan.fsdp and m_losses == losses):
            raise AssertionError(f"--mesh fsdp=1 losses {m_losses} not bitwise {losses} (fsdp {plan and plan.fsdp})")
        log(f"[clip] (e) --mesh fsdp=1 (FSDP2 over a one-rank NCCL group): every step's loss bitwise equal")
        del meshed
    finally:
        runtime.deinitialize()
    _free(torch)
    return {"step_ms": step_ms, "pairs_s": pairs / step_ms * 1e3, "peak_gib": peak / 2**30, "losses": losses}


# ---------------------------------------------------------------------------
# phase 15: the data plane (native host library, .dmlshard corpus, the 1b
# model fed from it, a mid-epoch resume through a memory:// run directory)
# ---------------------------------------------------------------------------

#: (a): lognormal documents (``build_corpus --synthetic``'s defaults) packed
#: into rows of ``NATIVE_SEQ`` and a window of ``NATIVE_WINDOW`` batches
#: interleaved, by the library and by the plain Python/numpy path
NATIVE_DOCS = 200_000
NATIVE_SEQ = 2048
NATIVE_WINDOW = 8
#: (b): the corpus, as ``scripts/torch_build_corpus.py --synthetic`` draws it
CORPUS = dict(vocab=32000, len_median=600.0, len_sigma=1.0, min_len=16, max_len=8192, seed=0)
CORPUS_SHARDS = 16
CORPUS_SHARD_TOKENS = 1 << 22
#: the reader must outrun the 1b step's token consumption by this factor,
#: the packers (on the step's path) by the second
READER_MARGIN, PACKER_MARGIN = 20.0, 4.0
#: (c): the 1b model on the corpus; first-fit-decreasing over 512 documents,
#: as the reference's data benchmark packs (bench.py:2190); 7 steps, no val
PACK_WINDOW = 512
DATA_STEPS = 7
DATA_LAYERS = 24  # the 1b preset's depth
DATA_ARGV = ["--preset", "1b", "--attn", "flash", "--vocab-size", "32000", "--seq-len", "2048", "--batch-size", "4",
             "--n-seqs", str(4 * DATA_STEPS), "--epochs", "1", "--pack-window", str(PACK_WINDOW)]
DATA_FIRST_LOSS = math.log(32000) + 0.5
DATA_FIRST_LOSS_TOL = 0.15
#: (d): the resume drill, at this depth, with the run directory at this URL
DATA_RESUME_LAYERS = 4
DATA_RESUME_ROOT = "memory://chip-smoke-data"
DATA_SAVE_STEP = 4
DATA_SIGNAL_AFTER = 3
#: the ShardReader cursor moved from 4 readers to 2 after this many records each
ELASTIC_RECORDS = 1000


def phase_native(smi: str) -> None:
    """(a) The port's host library, built with g++, against the Python path."""
    import numpy as np

    from dmlcloud_tpu_torch.data import datasets as ds
    from dmlcloud_tpu_torch.native import _lib, interleave, pack

    t0 = time.perf_counter()
    path = _lib.loaded_path()
    if path is None:
        raise AssertionError(f"the native library did not build: {_lib.build_error}")
    log(f"[data] native library {path.name} built/loaded in {time.perf_counter() - t0:.2f} s")

    rs = np.random.RandomState(0)
    lengths = np.clip(np.round(rs.lognormal(np.log(64), 0.6, NATIVE_DOCS)), 4, 256).astype(np.int64)
    flat = rs.randint(1, 32000, size=int(lengths.sum())).astype(np.int32)
    docs = np.split(flat, np.cumsum(lengths)[:-1])
    t0 = time.perf_counter()
    want = list(ds._pack_sequences_iter(docs, NATIVE_SEQ, True))
    py_s = time.perf_counter() - t0
    _lib.reset_calls()
    t0 = time.perf_counter()
    tokens, segs = pack.pack_flat(flat, lengths, NATIVE_SEQ)
    native_s = time.perf_counter() - t0
    if _lib.CALLS["pack"] != 1:
        raise AssertionError(f"pack_flat did not go through the library: {_lib.CALLS}")
    if len(want) != len(tokens) or not all(np.array_equal(r["tokens"], t) and np.array_equal(r["segment_ids"], s)
                                           for r, t, s in zip(want, tokens, segs)):
        raise AssertionError("the native packer's rows differ from the Python packer's")
    log(f"[data] pack {NATIVE_DOCS} lognormal documents ({flat.size} tokens) into {len(tokens)} rows of "
        f"{NATIVE_SEQ}: bit-identical; Python {py_s * 1e3:.1f} ms, native pack_flat {native_s * 1e3:.1f} ms "
        f"({py_s / native_s:.1f}x) [{smi}]")

    batches = [rs.randint(0, 32000, size=(64, NATIVE_SEQ)).astype(np.int32) for _ in range(4 * NATIVE_WINDOW)]
    s = 64 // NATIVE_WINDOW
    t0 = time.perf_counter()
    plain = []
    for w in range(0, len(batches), NATIVE_WINDOW):
        buf = np.empty((NATIVE_WINDOW, *batches[0].shape), np.int32)
        for i in range(NATIVE_WINDOW):
            for j in range(NATIVE_WINDOW):
                buf[i, j * s:(j + 1) * s] = batches[w + j][i * s:(i + 1) * s]
        plain.extend(buf)
    py_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in ds.interleave_batches(batches, NATIVE_WINDOW):
        pass
    native_s = time.perf_counter() - t0
    got = [b.copy() for b in ds.interleave_batches(batches, NATIVE_WINDOW)]
    if _lib.CALLS["interleave"] != 8 or not interleave.available():
        raise AssertionError(f"interleave_batches did not go through the library: {_lib.CALLS}")
    if len(got) != len(plain) or not all(np.array_equal(a, b) for a, b in zip(got, plain)):
        raise AssertionError("the native interleave differs from the numpy copies")
    mib = sum(b.nbytes for b in batches) / 2**20
    log(f"[data] interleave {len(batches)} batches [64, {NATIVE_SEQ}] int32 ({mib:.0f} MiB) in windows of "
        f"{NATIVE_WINDOW}: bit-identical; numpy {py_s * 1e3:.1f} ms, native {native_s * 1e3:.1f} ms [{smi}]")


def _corpus_docs_count(total_tokens: int) -> int:
    """The number of ``--synthetic`` documents whose lengths first reach
    ``total_tokens``: the generator draws all lengths first, so a prefix of a
    longer draw is the draw of the shorter corpus."""
    import numpy as np

    c = CORPUS
    n = 4 * total_tokens // c["len_median"]
    lengths = np.clip(np.round(np.random.RandomState(c["seed"]).lognormal(np.log(c["len_median"]), c["len_sigma"],
                                                                         int(n))), c["min_len"], c["max_len"])
    return int(np.searchsorted(np.cumsum(lengths), total_tokens) + 1)


def phase_corpus(root: str, step_ms: float, smi: str) -> dict:
    """(b) Build the corpus with ``scripts/torch_build_corpus.py``'s
    generator, verify it, and time the reader and both packers on it."""
    import importlib.util

    import numpy as np

    from dmlcloud_tpu_torch.data import PackStats, ShardReader, ShardStore

    spec = importlib.util.spec_from_file_location(
        "torch_build_corpus", os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                                           "torch_build_corpus.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    c = CORPUS
    n_docs = _corpus_docs_count(CORPUS_SHARDS * CORPUS_SHARD_TOKENS)
    t0 = time.perf_counter()
    rc = script.main(["--synthetic", str(n_docs), "--out", root, "--shard-tokens", str(CORPUS_SHARD_TOKENS),
                      "--vocab", str(c["vocab"]), "--len-median", str(c["len_median"]), "--len-sigma",
                      str(c["len_sigma"]), "--min-len", str(c["min_len"]), "--max-len", str(c["max_len"]),
                      "--seed", str(c["seed"])])
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = ShardStore(root)
    store.verify()
    verify_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root))
    if rc != 0 or len(store.shards) != CORPUS_SHARDS:
        raise AssertionError(f"corpus build: rc {rc}, {len(store.shards)} shards (want {CORPUS_SHARDS})")
    log(f"[data] corpus: {n_docs} documents, {store.total_tokens} tokens in {len(store.shards)} shards, "
        f"{size / 2**20:.1f} MiB; build {build_s:.2f} s, verify {verify_s:.2f} s")

    consume = 4 * 2048 / step_ms * 1e3  # the 1b step's tokens/s (phase 6's steady step)
    t0 = time.perf_counter()
    records = tokens = 0
    for doc in ShardReader(store):
        records += 1
        tokens += doc.size
    read_s = time.perf_counter() - t0
    if (records, tokens) != (store.total_records, store.total_tokens):
        raise AssertionError(f"the reader yielded {records} records / {tokens} tokens of "
                             f"{store.total_records} / {store.total_tokens}")
    rates = {"reader": tokens / read_s}
    n_rows = min(2048, store.total_tokens // 4096)  # up to 4 M tokens of rows through each packer
    for name, window in (("greedy chunks (native)", 0), (f"FFD window {PACK_WINDOW}", PACK_WINDOW)):
        stats = PackStats()
        it = iter(ShardReader(store).pack_stream(2048, pack_window=window, stats=stats))
        t0 = time.perf_counter()
        for _ in range(n_rows):
            next(it)
        rates[name] = n_rows * 2048 / (time.perf_counter() - t0)
        it.close()
        log(f"[data] pack_stream {name}: {rates[name]:.0f} row tokens/s, pad fraction {stats.pad_fraction:.4f}")
    log(f"[data] ShardReader: {records} records in {read_s:.3f} s = {rates['reader']:.0f} tokens/s = "
        f"{rates['reader'] / consume:.0f}x the 1b step's {consume:.0f} tokens/s [{smi}]")
    slow = {k: v for k, v in rates.items() if v < consume * (READER_MARGIN if k == "reader" else PACKER_MARGIN)}
    if slow:
        raise AssertionError(f"the feed would hold the step back: {slow} against {consume:.0f} tokens/s")

    # the reader's cursor saved at world 4 and loaded at world 2 (bench.py:2345-2362)
    k = min(ELASTIC_RECORDS, store.total_records // 8)
    readers = [ShardReader(store, rank=r, world_size=4, read_ahead=16) for r in range(4)]
    iters = [iter(r) for r in readers]
    for r, it in enumerate(iters):
        for i in range(k):
            if not np.array_equal(next(it), store.record(r + 4 * i)):
                raise AssertionError(f"world-4 reader {r} read another record than {r + 4 * i}")
        it.close()
    state = readers[0].state_dict()
    g0 = 4 * k
    if state["global_offset"] != g0 or store.locate(g0) != (state["shard_id"], state["record_offset"]):
        raise AssertionError(f"world-4 cursor {state}")
    for r in range(2):
        reader = ShardReader(store, rank=r, world_size=2, read_ahead=16)
        reader.load_state_dict(state)
        it = iter(reader)
        for i in range(k):
            if not np.array_equal(next(it), store.record(g0 + r + 2 * i)):
                raise AssertionError(f"world-2 reader {r} did not resume at record {g0 + r + 2 * i}")
        it.close()
    log(f"[data] ShardReader cursor {json.dumps(state)} saved at world 4 resumes both world-2 readers at "
        f"records {g0} and {g0 + 1}")
    return {"docs": n_docs, "tokens": store.total_tokens, "rates": rates}


def _data_argv(root: str) -> list[str]:
    return DATA_ARGV + ["--corpus", root]


def phase_data_train(torch, fa, root: str, smi: str, p5: dict) -> None:
    """(c) The full-width 1b model fed by ShardReader -> pack_stream ->
    batch -> to_device through TrainValStage."""
    from dmlcloud_tpu_torch.examples.train_lm import build

    pipe, stage = build(_data_argv(root))
    ends = []
    step = stage._train_step

    def marked(batch):
        out = step(batch)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        return out

    stage._train_step = marked
    fa.reset_launch_counts()  # phase 15's main path starts here ...
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)  # ... and ends here
    stage._train_step = step
    losses = [float(x) for x in stage.train_losses]
    log(f"[data] 1b on the corpus: losses {losses}; {len(losses)} steps in {wall:.1f} s wall (model build included); "
        f"launches {launches}")
    n = DATA_LAYERS * DATA_STEPS
    want = {"flash_fwd_tc": n, "flash_bwd_dq_tc": n, "flash_bwd_dkv_tc": n, "flash_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    if len(losses) != DATA_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"1b on the corpus: {len(losses)} steps (want {DATA_STEPS}), losses {losses}")
    if launches != want:
        raise AssertionError(f"1b on the corpus: launches {launches}, want {want}")
    if abs(losses[0] - DATA_FIRST_LOSS) > DATA_FIRST_LOSS_TOL:
        raise AssertionError(f"1b on the corpus: step-1 loss {losses[0]:.4f} not within {DATA_FIRST_LOSS_TOL} of "
                             f"ln(32000) + 1/2 = {DATA_FIRST_LOSS:.4f}")
    periods = [a.elapsed_time(b) for a, b in zip(ends[2:], ends[3:])]
    step_ms = statistics.median(periods)
    stats = stage.pack_stats
    stall = float(stage.tracker["misc/host_stall_ms"][-1])
    log(f"[data] pad fraction {stats.pad_fraction:.4f} ({stats.rows} rows, {stats.docs} documents); "
        f"misc/host_stall_ms {stall:.3f}; steady step (device time between step ends 3-7) {step_ms:.1f} ms "
        f"median of {[round(p, 1) for p in periods]} against phase 6's {p5['steady_ms']:.1f} ms "
        f"({step_ms / p5['steady_ms'] - 1:+.1%}) [{smi}]")

    # one more step under the profiler, its batch taken from the pipeline's feed
    it = iter(stage.train_dataset())
    next(it)
    wall_us, busy_us, events = profile_call(torch, lambda: stage._train_step(next(it)))
    it.close()
    if busy_us == 0:
        log("[data] profiler recorded no device time: idle share not measured")
    else:
        log_profile("data", "1b step with its batch from the corpus feed", wall_us, busy_us, events)
    del pipe, stage, it
    _free(torch)


def phase_data_resume(torch, fa, root: str, smi: str) -> None:
    """(d) Phase 15 (c)'s path at ``DATA_RESUME_LAYERS`` layers with step
    saves to a ``memory://`` run directory: uninterrupted (C), preempted by
    SIGUSR1 after step ``DATA_SIGNAL_AFTER`` (P), resumed (R)."""
    from torch.distributed.checkpoint._fsspec_filesystem import FsspecReader, FsspecWriter  # noqa: F401

    from dmlcloud_tpu_torch.checkpoint import read_requeue_verdict
    from dmlcloud_tpu_torch.examples.train_lm import build
    from dmlcloud_tpu_torch.utils.paths import RemotePath

    argv = _data_argv(root) + ["--layers", str(DATA_RESUME_LAYERS), "--save-every-steps", str(DATA_SAVE_STEP)]
    rest = DATA_STEPS - DATA_SAVE_STEP
    RemotePath(DATA_RESUME_ROOT).rm()

    def final(stage):
        stage.state.optimizer.zero_grad(set_to_none=True)
        sd = stage.state.state_dict()
        return {"params": sd["params"], "mu": sd["opt_state"]["mu"], "nu": sd["opt_state"]["nu"],
                "step": stage.state.step, "count": stage.state.optimizer.count,
                "losses": [float(x) for x in stage.train_losses]}

    try:
        t0 = time.perf_counter()
        pipe, stage = build(argv)
        pipe.run()
        torch.cuda.synchronize()
        c = final(stage)
        log(f"[data] C, uninterrupted, {DATA_RESUME_LAYERS} layers: {c['step']} steps in "
            f"{time.perf_counter() - t0:.1f} s; losses {[round(x, 4) for x in c['losses']]}")
        del pipe, stage
        _free(torch)

        t0 = time.perf_counter()
        pipe, stage = build(argv + ["--checkpoint-dir", DATA_RESUME_ROOT], resume=True)
        pipe.enable_preemption_handling(("SIGUSR1",))
        step, done = stage._train_step, [0]

        def signalled(batch):
            out = step(batch)
            done[0] += 1
            if done[0] == DATA_SIGNAL_AFTER:
                os.kill(os.getpid(), signal.SIGUSR1)
            return out

        stage._train_step = signalled
        pipe.run()
        torch.cuda.synchronize()
        run_dir = pipe.checkpoint_dir.path
        sidecar = json.loads((run_dir / "meta" / f"{stage.name}.steps" / f"{DATA_SAVE_STEP}.json").read_text())
        verdict = read_requeue_verdict(run_dir)
        p_save = pipe.checkpoint_dir.state_manager(f"{stage.name}.steps").last_save
        log(f"[data] P, preempted: drained at step {stage.state.step} in {time.perf_counter() - t0:.1f} s; "
            f"run directory {run_dir}; sidecar data {json.dumps(sidecar.get('data'))}; verdict {verdict['kind']}")
        if not (isinstance(run_dir, RemotePath) and str(run_dir).startswith(DATA_RESUME_ROOT + "/")
                and stage.state.step == DATA_SAVE_STEP and stage._mid_epoch_exit and verdict["kind"] == "preemption"
                and isinstance(sidecar.get("data"), dict)
                and sidecar["data"].get("global_offset") == DATA_SAVE_STEP):
            raise AssertionError(f"preempted run: step {stage.state.step}, dir {run_dir}, sidecar {sidecar}, "
                                 f"verdict {verdict}")
        log(f"[data] P step save to {DATA_RESUME_ROOT} through FsspecWriter: {_gb(p_save['bytes']):.2f} GB, "
            f"blocking {p_save['blocking_s']:.3f} s, background commit {p_save['commit_s'] or 0:.3f} s [{smi}]")
        first_log = (run_dir / "log.txt").read_text()
        del pipe, stage
        _free(torch)

        t0 = time.perf_counter()
        pipe, stage = build(argv + ["--checkpoint-dir", str(run_dir)], resume=True)
        fa.reset_launch_counts()
        pipe.run()
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        r = final(stage)
        log(f"[data] R, resumed: steps {DATA_SAVE_STEP + 1}-{r['step']} in {time.perf_counter() - t0:.1f} s; "
            f"launches {launches}")
        # the resumed attempt's part of log.txt (the tee of its output) says how it resumed
        text = (run_dir / "log.txt").read_text()
        lines = text[len(first_log):].splitlines() if text.startswith(first_log) else []
        fast = [m for m in lines if "fast-forwarded from saved iterator state" in m]
        skipped = [m for m in lines if "skipping the first" in m]
        if not fast or skipped:
            raise AssertionError(f"resume: fast-forward lines {fast}, batch-skip lines {skipped}")
        log(f"[data] R, from log.txt: {fast[0]}")
        want = {"flash_fwd_tc": DATA_RESUME_LAYERS * rest, "flash_bwd_dq_tc": DATA_RESUME_LAYERS * rest,
                "flash_bwd_dkv_tc": DATA_RESUME_LAYERS * rest, "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        if launches != want:
            raise AssertionError(f"resumed run: launches {launches}, want {want}")
        diffs = {part: max(max_err(torch, r[part][n], c[part][n]) for n in c[part]) for part in ("params", "mu", "nu")}
        diffs["losses 5-7"] = max(abs(a - b) for a, b in zip(r["losses"], c["losses"][DATA_SAVE_STEP:]))
        if (r["step"], r["count"]) != (c["step"], c["count"]) or len(r["losses"]) != rest or any(diffs.values()):
            raise AssertionError(f"resumed run is not bitwise the uninterrupted one: step {r['step']}/{c['step']}, "
                                 f"count {r['count']}/{c['count']}, max abs differences {diffs}")
        verdict = read_requeue_verdict(run_dir)
        if not (text.count("Checkpoint: ") == 2 and verdict["kind"] == "completed"):
            raise AssertionError(f"{run_dir}/log.txt does not hold both attempts, or the verdict {verdict} is not "
                                 "completed")
        log(f"[data] R equals C bitwise (params, AdamW moments and count, step, losses of steps 5-7); {run_dir}/log.txt "
            f"holds both attempts ({len(text)} bytes); requeue.json reads back {json.dumps(verdict)}")
        del pipe, stage, c, r
        _free(torch)
    finally:
        RemotePath(DATA_RESUME_ROOT).rm()


# ---------------------------------------------------------------------------
# phase 16: the compiled step
# ---------------------------------------------------------------------------

#: every compiled loss within this of phase 5's eager one (bf16 activations;
#: Inductor fuses the elementwise chains in fp32 registers where eager rounds
#: between ops)
COMPILED_LOSS_ATOL = 2e-2
RAGGED_SIZES = (64, 64, 40, 24, 64, 64, 12, 64)
RAGGED_BUCKETS = (16, 32, 64)
#: a compiled-run process: build phase 5's pipeline with the compiled step,
#: run it, measure, and write the result as JSON to argv[2]
_COMPILED_RUN = r"""
import json, math, os, statistics, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.use_deterministic_algorithms(True, warn_only=True)
torch.utils.deterministic.fill_uninitialized_memory = False
import chip_smoke as c
from torch._dynamo.utils import counters
from dmlcloud_tpu_torch.compile import cache as cache_lib
from dmlcloud_tpu_torch.examples.train_lm import build
from dmlcloud_tpu_torch.ops import flash_attention as fa
from dmlcloud_tpu_torch.telemetry.goodput import flops_from_compiled
from dmlcloud_tpu_torch.utils import profiling

cache_dir, out_path, profile_dir = sys.argv[1], sys.argv[2], sys.argv[3]
pipeline, stage = build(c.TRAIN_ARGV, precompile=True, compile_cache=cache_dir)
marks = {}
precompile_phase = stage._run_precompile_phase

def timed_precompile():
    before = cache_lib.compile_counters()
    precompile_phase()
    torch.cuda.synchronize()
    marks["precompile_launches"] = dict(fa.LAUNCHES)
    after = cache_lib.compile_counters()
    marks["precompile_counters"] = {k: after[k] - before[k] for k in after}

stage._run_precompile_phase = timed_precompile
torch.cuda.reset_peak_memory_stats()
fa.reset_launch_counts()
t0 = time.perf_counter()
pipeline.run()
torch.cuda.synchronize()
wall = time.perf_counter() - t0
total = dict(fa.LAUNCHES)
res = {"wall_s": wall, "launches_total": total, **marks,
       "loop_launches": {k: total[k] - marks["precompile_launches"][k] for k in total},
       "losses": [float(x) for x in stage.train_losses], "val": float(stage.tracker["val/loss"][-1]),
       "compile_ms": float(stage.tracker["misc/compile_ms"][0]),
       "recompiles": [int(x) for x in stage.tracker["misc/recompiles"]],
       "graph_breaks": int(sum(counters["graph_break"].values())),
       "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
       "train_hit": stage._train_compiled.any_compiled().hit,
       "val_hit": stage._val_compiled.any_compiled().hit,
       "signatures": stage._train_compiled.signatures, "cache_stats": cache_lib.cache_stats()}
if profile_dir != "-":
    batch = next(iter(stage._feed(stage.train_dataset())))
    res["steady_ms"], res["steady_times"] = c.steady_ms(torch, stage, batch)
    wall_us, busy_us, events = c.profile_step(torch, stage, batch)
    res["profile"] = {"wall_us": wall_us, "busy_us": busy_us, "events": sum(e.count for e in events)}
    fa.reset_launch_counts()
    profiling.profile_steps(stage._train_step, 2, profile_dir, batch)
    res["profile_launches"] = dict(fa.LAUNCHES)
    peaks, rows = profiling.roofline(profile_dir, steps=2)
    res["roofline"] = {"peaks": peaks, "rows": rows, "text": profiling.format_roofline(peaks, rows)}
    n_params = sum(p.numel() for p in stage.state.model.parameters())
    stage._train_compiled.count_flops(batch)
    res["flops_counted"] = flops_from_compiled(stage._train_compiled.any_compiled(), n_devices=1)
    res["flops_6nd"] = 6.0 * n_params * 4 * 2048
with open(out_path, "w") as f:
    json.dump(res, f)
"""


def _compiled_run(root: str, tag: str, cache_dir: str, profile: bool) -> dict:
    """One ``_COMPILED_RUN`` process (its output to a log file, not a pipe)."""
    script, out = os.path.join(root, "compiled_run.py"), os.path.join(root, f"{tag}.json")
    with open(script, "w") as f:
        f.write(_COMPILED_RUN)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [here, os.environ.get("PYTHONPATH")])),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    prof_dir = os.path.join(root, f"{tag}-trace") if profile else "-"
    t0 = time.perf_counter()
    with open(os.path.join(root, f"{tag}.log"), "w") as logf:
        rc = subprocess.run([sys.executable, script, cache_dir, out, prof_dir], env=env, cwd=here, stdout=logf,
                            stderr=subprocess.STDOUT, timeout=900).returncode
    if rc != 0:
        with open(os.path.join(root, f"{tag}.log")) as f:
            tail = f.read()[-6000:]
        raise AssertionError(f"compiled run ({tag}) exited {rc}:\n{tail}")
    with open(out) as f:
        res = json.load(f)
    res["process_s"] = time.perf_counter() - t0
    return res


def _ragged_run(torch, buckets, cache_dir: str) -> dict:
    """bench.py's ``_ragged_config`` on the card: a linear regression over
    ragged batches, precompiled, with or without shape buckets."""
    import numpy as np

    import dmlcloud_tpu_torch as dml
    from dmlcloud_tpu_torch.compile import masked_mean
    from dmlcloud_tpu_torch.optim import sgd

    rng = np.random.RandomState(0)
    w_true = rng.randn(32, 1).astype(np.float32)
    batches = []
    for n in RAGGED_SIZES:
        x = rng.randn(n, 32).astype(np.float32)
        batches.append({"x": x, "y": x @ w_true})

    class RaggedStage(dml.TrainValStage):
        def pre_stage(self):
            model = torch.nn.Linear(32, 1, bias=False, device=self.device)
            torch.nn.init.zeros_(model.weight)
            self.pipeline.register_model("linear", model, verbose=False)
            self.pipeline.register_optimizer("sgd", sgd(0.05))
            self.pipeline.register_dataset("train", batches, verbose=False)

        def step(self, state, batch):
            per_sample = ((state.model(batch["x"]) - batch["y"]) ** 2).sum(-1)
            if "sample_mask" in batch:
                return masked_mean(per_sample, batch["sample_mask"])
            return per_sample.mean()

        def val_epoch(self):
            pass

    pipeline = dml.TrainingPipeline(name=f"ragged-{'buckets' if buckets else 'none'}", device="cuda",
                                    precompile=True, buckets=buckets, compile_cache=cache_dir)
    stage = RaggedStage()
    pipeline.append_stage(stage, max_epochs=2)
    pipeline.run()
    return {"signatures": stage._train_compiled._cache_size(),
            "recompiles": [int(x) for x in pipeline.tracker["misc/recompiles"]],
            "loss": [float(x) for x in pipeline.tracker["train/loss"]]}


def phase_compiled(torch, fa, smi: str, p5: dict) -> None:
    root = tempfile.mkdtemp(prefix="chip_smoke_compiled_")
    try:
        cache_dir = os.path.join(root, "inductor")
        cold = _compiled_run(root, "cold", cache_dir, profile=True)
        warm = _compiled_run(root, "warm", cache_dir, profile=False)
        _check_compiled(cold, warm, smi, p5)
        for buckets in (RAGGED_BUCKETS, None):
            t0 = time.perf_counter()
            r = _ragged_run(torch, buckets, os.path.join(root, "ragged"))
            log(f"[compiled] (c) ragged sizes {RAGGED_SIZES}, buckets {buckets}: {r['signatures']} signatures, "
                f"misc/recompiles {r['recompiles']}, train/loss {[round(x, 4) for x in r['loss']]} "
                f"({time.perf_counter() - t0:.1f} s)")
            if buckets and (r["signatures"] > len(buckets) or r["recompiles"] != [0, 0]):
                raise AssertionError(f"bucketed ragged run: {r}")
            if not buckets and (r["signatures"] != len(set(RAGGED_SIZES)) or not r["recompiles"][0] > 0):
                raise AssertionError(f"unbucketed ragged run: {r}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _check_compiled(cold: dict, warm: dict, smi: str, p5: dict) -> None:
    want = p5["launches"]
    for tag, r in (("a, cold", cold), ("b, warm", warm)):
        log(f"[compiled] ({tag}) {smi}: process {r['process_s']:.1f} s (run {r['wall_s']:.1f} s); misc/compile_ms "
            f"{r['compile_ms']:.0f}; graph breaks {r['graph_breaks']}; precompile cache counters "
            f"{r['precompile_counters']} (train hit {r['train_hit']}, val hit {r['val_hit']}); data-loop launches "
            f"{r['loop_launches']}; precompile's launches {r['precompile_launches']}; peak {r['peak_gib']:.2f} GiB; "
            f"misc/recompiles {r['recompiles']}")
        log(f"[compiled] ({tag}) losses {r['losses']}, val/loss {r['val']!r}")
        if r["graph_breaks"]:
            raise AssertionError(f"({tag}) {r['graph_breaks']} graph breaks")
        if r["loop_launches"] != want:
            raise AssertionError(f"({tag}) data-loop launches {r['loop_launches']}, phase 5's {want}")
        if abs(r["losses"][0] - PR1_FIRST_LOSS) > 0.01:
            raise AssertionError(f"({tag}) step-1 loss {r['losses'][0]:.4f} not within 0.01 of {PR1_FIRST_LOSS}")
        gaps = [abs(a - b) for a, b in zip(r["losses"] + [r["val"]], p5["losses"] + [p5["val"]])]
        log(f"[compiled] ({tag}) |compiled - eager| per loss (phase 5): max {max(gaps):.3g}; {gaps}")
        if len(r["losses"]) != len(p5["losses"]) or max(gaps) > COMPILED_LOSS_ATOL:
            raise AssertionError(f"({tag}) losses off phase 5's by {max(gaps):.3g} > {COMPILED_LOSS_ATOL}")
        if r["peak_gib"] > PR1_PEAK_GIB:
            raise AssertionError(f"({tag}) peak memory {r['peak_gib']:.2f} GiB above {PR1_PEAK_GIB}")
    prof = cold["profile"]
    idle = max(0.0, 1 - prof["busy_us"] / prof["wall_us"])
    eager = EAGER_PROFILE
    log(f"[compiled] (a) {smi}: steady compiled step {cold['steady_ms']:.1f} ms (median of "
        f"{[round(t, 1) for t in cold['steady_times']]}) = {4 * 2048 / cold['steady_ms'] * 1e3:.0f} tokens/s, "
        f"against phase 6's eager {p5['steady_ms']:.1f} ms (x{p5['steady_ms'] / cold['steady_ms']:.3f}); profiled "
        f"step: wall {prof['wall_us'] / 1e3:.1f} ms, busy {prof['busy_us'] / 1e3:.1f} ms, idle share {idle:.3f}, "
        f"{prof['events']} device events (eager: idle share {eager.get('idle', float('nan')):.3f}, "
        f"{eager.get('events', 0)} device events)")
    log("[compiled] (d) roofline of 2 profiled compiled steps:")
    for line in cold["roofline"]["text"].splitlines():
        log(f"[compiled] (d)   {line}")
    rows = {r["category"]: r for r in cold["roofline"]["rows"]}
    for name in ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc"):
        n = rows.get(name, {}).get("n_per_step", 0) * 2
        if n != cold["profile_launches"][name]:
            raise AssertionError(f"roofline row {name}: {n} kernels in 2 steps, LAUNCHES counted "
                                 f"{cold['profile_launches'][name]}")
    flops = cold["flops_counted"]
    log(f"[compiled] (d) flops_from_compiled {flops:.4g} FLOP per step (FlopCounterMode; K1-K3 count 0) "
        f"against step_flops()'s 6ND {cold['flops_6nd']:.4g} (ratio {flops / cold['flops_6nd']:.3f})")
    log(f"[compiled] (b) warm {smi}: misc/compile_ms {warm['compile_ms']:.0f} against cold {cold['compile_ms']:.0f} "
        f"(x{cold['compile_ms'] / warm['compile_ms']:.2f}); cache {warm['cache_stats']['entries']} entries, "
        f"{warm['cache_stats']['size_bytes'] / 1e6:.1f} MB")
    counters = warm["precompile_counters"]
    if not warm["train_hit"] or counters["fxgraph_miss"] or counters["autograd_miss"] or not (
            counters["fxgraph_hit"] + counters["autograd_hit"]):
        raise AssertionError(f"(b) warm precompile missed the cache: {counters}, train hit {warm['train_hit']}")
    if not warm["compile_ms"] < cold["compile_ms"]:
        raise AssertionError(f"(b) warm compile {warm['compile_ms']:.0f} ms not below cold {cold['compile_ms']:.0f}")
    if warm["losses"] != cold["losses"] or warm["val"] != cold["val"]:
        raise AssertionError(f"(b) warm losses {warm['losses']} / {warm['val']!r} not bitwise the cold run's "
                             f"{cold['losses']} / {cold['val']!r}")
    log("[compiled] (b) warm losses bitwise equal to the cold run's")


def phase_data(torch, fa, smi: str, p5: dict) -> None:
    phase_native(smi)
    root = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    try:
        phase_corpus(root, p5["steady_ms"], smi)
        phase_data_train(torch, fa, root, smi, p5)
        phase_data_resume(torch, fa, root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 17: int8 decode, speculative decoding, int8 training, LoRA
# ---------------------------------------------------------------------------

#: (a): rows, prompt tokens and new greedy tokens of the int8-vs-bf16 decode
INT8_DECODE = dict(rows=8, prompt=128, new=128)
#: (b): draft proposals per round, rows, prompt tokens, new greedy tokens
SPEC = dict(k=4, rows=4, prompt=128, new=64)
#: (b): the fp32 check's depth (target) at the 1b width; the draft has one layer
SPEC_FP32_LAYERS = 2
#: (c): every int8 train loss within this relative distance of phase 5's
#: (the reference's own bound, tests/test_quant_train.py:140-155)
INT8_LOSS_REL = 0.05
#: (c): the MLP's up projection of one step: x [B*T, hidden] bf16, w [hidden, mlp]
QTD_SHAPE = dict(m=4 * 2048, k=2048, n=5632)
#: (d): tenants, rank, and the finetune's steps, rows and length
LORA = dict(tenants=4, rank=16, alpha=16.0, t=128, steps=4, batch=4, seq=1024)


def _resident_gib(model) -> float:
    """The bytes of ``model``'s tensors (parameters and buffers, each storage
    once), in GiB."""
    seen, total = set(), 0
    for t in list(model.parameters()) + list(model.buffers()):
        key = t.untyped_storage().data_ptr()
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total / 2**30


def _timed_generate(torch, model, prompt, new):
    """``generate``'s tokens, the ms per decode step (the prefill-only call's
    time taken off) and the peak memory in GiB, after a warm-up call."""
    from dmlcloud_tpu_torch.models.generate import generate

    generate(model, prompt[:, :16], 2)  # first calls (cuBLAS handles, allocator) outside the timing
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(model, prompt, 1)
    torch.cuda.synchronize()
    prefill = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokens = generate(model, prompt, new)
    torch.cuda.synchronize()
    full = time.perf_counter() - t0
    return tokens, (full - prefill) / (new - 1) * 1e3, torch.cuda.max_memory_allocated() / 2**30


def _plain_quant_dot(x, qt, dtype):
    """The plain version of the int8 dense path: dequantize to fp32, then an
    fp32 matmul, the result cast to ``dtype``."""
    w = qt.q.float() * qt.scale
    return (x.float().reshape(-1, x.shape[-1]) @ w.reshape(w.shape[0], -1)).to(dtype).reshape(
        *x.shape[:-1], *qt.q.shape[1:])


def phase_int8_decode(torch, smi: str) -> dict:
    """(a): ``quantize_tree`` of the bf16 1b, ``generate`` beside the bf16
    model, one decode step's logits against the plain dense path, the
    greedy-token agreement; then ``ServeEngine`` on the int8 model."""
    import numpy as np

    from dmlcloud_tpu_torch.examples.train_lm import PRESETS
    from dmlcloud_tpu_torch.models import quant
    from dmlcloud_tpu_torch.models.generate import decode_step, init_cache
    from dmlcloud_tpu_torch.models.transformer import DecoderLM, TransformerConfig
    from dmlcloud_tpu_torch.serve import ServeEngine

    cfg = TransformerConfig(vocab_size=32000, max_seq_len=2048, **PRESETS["1b"])
    _free(torch)
    base_mem = torch.cuda.memory_allocated()
    model = DecoderLM(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    bf16_alloc = (torch.cuda.memory_allocated() - base_mem) / 2**30
    t0 = time.perf_counter()
    qmodel = quant.quantize_tree(model)
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    q_alloc = (torch.cuda.memory_allocated() - base_mem) / 2**30 - bf16_alloc
    q_bytes, full_bytes = quant.quantized_size(qmodel)
    n_quant = sum(isinstance(m, quant.QuantizedTensor) for m in qmodel.modules())
    log(f"[int8] (a) quantize_tree of the bf16 1b ({n_quant} kernels) in {q_s:.2f} s: quantized_size "
        f"{q_bytes / 2**30:.3f} GiB int8 vs {full_bytes / 2**30:.3f} GiB bf16 ({full_bytes / q_bytes:.2f}x); resident "
        f"on the card: bf16 model {_resident_gib(model):.3f} GiB (fp32 master weights, cast per call; allocated "
        f"{bf16_alloc:.3f}), int8 model {_resident_gib(qmodel):.3f} GiB (int8 kernels, fp32 embedding and norms "
        f"shared with the bf16 model; the quantized kernels allocated {q_alloc:.3f}) [{smi}]")

    rs = np.random.RandomState(17)
    d = INT8_DECODE
    prompt = torch.as_tensor(rs.randint(0, cfg.vocab_size, (d["rows"], d["prompt"]))).cuda()
    bf16_tokens, bf16_ms, bf16_peak = _timed_generate(torch, model, prompt, d["new"])
    calls = {"fused": 0}
    fused = quant._fused_quant_dot

    def counted(*args):
        calls["fused"] += 1
        return fused(*args)

    quant._fused_quant_dot = counted
    try:
        int8_tokens, int8_ms, int8_peak = _timed_generate(torch, qmodel, prompt, d["new"])
    finally:
        quant._fused_quant_dot = fused
    # one call per kernel per model call: the decode ran the int8 dense path
    want_calls = n_quant * (3 + d["new"])
    if calls["fused"] != want_calls:
        raise AssertionError(f"int8 decode ran the fused int8 path {calls['fused']} times, want {want_calls}")
    agree = float((int8_tokens == bf16_tokens).float().mean())
    first = [int((r != 0).nonzero()[0]) if bool((r != 0).any()) else None for r in (int8_tokens != bf16_tokens)]
    log(f"[int8] (a) generate {d['rows']} rows x {d['prompt']} prompt tokens, {d['new']} new greedy: bf16 "
        f"{bf16_ms:.2f} ms per decode step, peak {bf16_peak:.2f} GiB; int8 {int8_ms:.2f} ms per decode step, peak "
        f"{int8_peak:.2f} GiB ({int8_ms / bf16_ms:.3f}x the bf16 step; {calls['fused']} fused int8 dense calls); "
        f"greedy-token agreement int8 vs bf16 {agree:.4f} (first differing step per row {first}) [{smi}]")

    # one decode step: every int8 dense call held against the plain version on
    # its own inputs; the LM head's call gives the step's logits
    t = d["prompt"]
    held = []

    def checked(x, qt, dtype):
        y = fused(x, qt, dtype)
        name = "float32" if dtype == torch.float32 else "bfloat16"
        held.append((name, *assert_close(torch, y, _plain_quant_dot(x, qt, dtype), name,
                                         f"int8 dense call {len(held)} ({tuple(x.shape)} x {tuple(qt.q.shape)})")))
        return y

    logits = {}
    for name, dot in (("int8", checked), ("plain", _plain_quant_dot)):
        quant._fused_quant_dot = dot
        try:
            cache = init_cache(cfg, d["rows"], t + 1, dtype=cfg.dtype, device="cuda")
            _, cache = decode_step(qmodel, prompt, cache, attend_len=t)
            if name == "int8":
                held.clear()  # the step, not the prefill
            logits[name] = decode_step(qmodel, int8_tokens[:, :1], cache, offset=t)[0][:, 0]
        finally:
            quant._fused_quant_dot = fused
    calls = list(held)
    worst = {n: max(((e, r) for m, e, r in calls if m == n), default=(0.0, 0.0)) for n in ("bfloat16", "float32")}
    log(f"[int8] (a) one decode step ({d['rows']} rows): each of its {len(calls)} int8 dense calls (bf16 operands, "
        f"fp32-output GEMM, scale on the fp32 accumulator) against the plain version on the same inputs "
        f"(dequantized fp32 weights, fp32 matmul): worst max abs / norm-relative err {worst['bfloat16'][0]:.3g} / "
        f"{worst['bfloat16'][1]:.3g} over the bf16 layers (TOL {TOL['bfloat16']}, REL_TOL {REL_TOL['bfloat16']}); "
        f"the logits (the fp32 LM head's call) {calls[-1][1]:.3g} / {calls[-1][2]:.3g} (TOL {TOL['float32']}, "
        f"REL_TOL {REL_TOL['float32']}); the whole step run on each path end to end (their bf16 roundings "
        f"compounding over {cfg.num_layers} layers, not gated): logits {max_err(torch, logits['int8'], logits['plain']):.3g} / "
        f"{rel_err(torch, logits['int8'], logits['plain']):.3g} [{smi}]")
    del logits, cache

    # phase 13's burst of 16 requests on the int8 model
    rs = np.random.RandomState(1)
    lens = rs.randint(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1, SERVE_REQUESTS)
    prompts = [rs.randint(0, cfg.vocab_size, n) for n in lens]
    blocks = -(-(SERVE_PROMPTS[1] + SERVE_NEW) // SERVE_1B["block_size"])
    engine = ServeEngine(qmodel, num_blocks=SERVE_1B["max_slots"] * blocks, **SERVE_1B)
    if engine.model is not qmodel:
        raise AssertionError("the engine widened or rehydrated the int8 kernels on the card")
    warm = engine.submit(prompts[0][:256], 4)
    engine.run()
    if engine.status(warm) != "ok":
        raise AssertionError(f"warm-up request ended {engine.status(warm)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sched = engine.scheduler
    rids = [engine.submit(p, SERVE_NEW) for p in prompts]
    step_ms, rows = [], []
    t0 = time.perf_counter()
    while not engine.idle:
        decode_only = not sched.prefilling and (sched.num_waiting == 0 or sched.active >= sched.max_slots)
        n = len(sched.running)
        s0 = time.perf_counter()
        engine.step()
        if decode_only and n:
            step_ms.append((time.perf_counter() - s0) * 1e3)
            rows.append(n)
    wall = time.perf_counter() - t0
    seqs = [engine.sequence(r) for r in rids]
    if engine.leaked_blocks() or any(s.status != "ok" or len(s.out) != SERVE_NEW for s in seqs):
        raise AssertionError(f"int8 serving ended with {engine.leaked_blocks()} leaked blocks, statuses "
                             f"{[s.status for s in seqs]}")
    engine.pool.assert_consistent()
    ttft = np.asarray([(s.first_token - s.arrival) * 1e3 for s in seqs])
    log(f"[int8] (a) ServeEngine on the int8 1b, phase 13's burst ({SERVE_REQUESTS} requests, prompts "
        f"{SERVE_PROMPTS[0]}-{SERVE_PROMPTS[1]}: {int(lens.sum())} tokens; {SERVE_NEW} new each; {SERVE_1B}): "
        f"{wall:.2f} s, TTFT p50 {np.percentile(ttft, 50):.1f} ms, p99 {np.percentile(ttft, 99):.1f} ms; "
        f"{len(step_ms)} decode-only steps, {statistics.median(step_ms):.2f} ms median, "
        f"{sum(rows) / sum(step_ms) * 1e3:.1f} decode tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; 0 leaked blocks [{smi}]")
    del engine, qmodel
    _free(torch)
    return {"model": model, "cfg": cfg}


def _top2_gap(torch, model, prompt_row, tokens) -> float:
    """The top-2 logit gap of the token after ``prompt_row`` + ``tokens``."""
    with torch.no_grad():
        seq = torch.cat([prompt_row, tokens])[None]
        top = model(seq)[0, -1].topk(2).values
    return float(top[0] - top[1])


def phase_spec(torch, smi: str, model, cfg) -> None:
    """(b): the bf16 1b verified against its random 1-layer twin; then the
    fp32 1b width at 2 layers, where tokens and counts are exact."""
    import dataclasses

    import numpy as np

    from dmlcloud_tpu_torch.models.generate import generate
    from dmlcloud_tpu_torch.models.speculative import speculative_generate
    from dmlcloud_tpu_torch.models.transformer import DecoderLM

    sp = SPEC
    target = model
    draft = DecoderLM(dataclasses.replace(cfg, num_layers=1), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(1))
    rs = np.random.RandomState(23)
    prompt = torch.as_tensor(rs.randint(0, cfg.vocab_size, (sp["rows"], sp["prompt"]))).cuda()
    speculative_generate(target, draft, prompt[:1, :16], 4, k=sp["k"])  # warm-up
    generate(target, prompt[:, :16], 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec, (rounds, advanced, accepted) = speculative_generate(target, draft, prompt, sp["new"], k=sp["k"],
                                                              return_stats=True)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = generate(target, prompt, sp["new"])
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    rate = float(accepted.sum()) / (float(rounds.sum()) * sp["k"])
    tokens = sp["rows"] * sp["new"]
    mismatches = []
    for r in range(sp["rows"]):
        diff = (spec[r] != plain[r]).nonzero()
        if diff.numel():
            j = int(diff[0])
            mismatches.append((r, j, round(_top2_gap(torch, target, prompt[r], plain[r, :j]), 5)))
    log(f"[spec] (b) speculative_generate, bf16 1b target, random 1-layer full-width draft, k={sp['k']}, "
        f"{sp['rows']} rows x {sp['prompt']} prompt tokens, {sp['new']} new greedy: rounds {rounds.tolist()}, accept "
        f"rate {rate:.4f}, {spec_s / tokens * 1e3:.2f} ms per generated token vs plain generate "
        f"{plain_s / tokens * 1e3:.2f} ms ({spec_s / plain_s:.2f}x; rows run one after another, one host read per "
        f"round); token agreement with plain greedy {float((spec == plain).float().mean()):.4f}; first mismatch per "
        f"row (row, step, top-2 logit gap of the plain run): {mismatches or 'none'} [{smi}]")
    del target, draft
    _free(torch)

    # the fp32 1b width at 2 layers: tokens and counts exact
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, num_layers=SPEC_FP32_LAYERS)
    target = DecoderLM(cfg32, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    draft = DecoderLM(dataclasses.replace(cfg32, num_layers=1), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(1))
    out = {}
    for name, drafter in (("random", draft), ("perfect", target)):
        out[name] = speculative_generate(target, drafter, prompt, sp["new"], k=sp["k"], return_stats=True)
    plain = generate(target, prompt, sp["new"])
    ties = []
    for name, (toks, (rounds, advanced, accepted)) in out.items():
        for r in range(sp["rows"]):
            diff = (toks[r] != plain[r]).nonzero()
            if diff.numel():
                j = int(diff[0])
                gap = _top2_gap(torch, target, prompt[r], plain[r, :j])
                ties.append((name, r, j, gap))
                if not gap < TIE_MARGIN:
                    raise AssertionError(f"fp32 speculative ({name} draft) row {r}: token {int(toks[r, j])} != plain "
                                         f"{int(plain[r, j])} at step {j}, top-2 gap {gap:.3g} (not a tie)")
        if not (bool((accepted == advanced - 1 - rounds).all()) and bool((advanced >= sp["new"]).all())
                and bool((advanced <= sp["new"] + sp["k"]).all())):
            raise AssertionError(f"fp32 speculative ({name} draft) counts off the round algebra: rounds "
                                 f"{rounds.tolist()}, advanced {advanced.tolist()}, accepted {accepted.tolist()}")
    p_rounds, _, p_accepted = out["perfect"][1]
    if not bool((p_accepted == p_rounds * sp["k"]).all()):
        raise AssertionError(f"a perfect draft was rejected: rounds {p_rounds.tolist()}, accepted "
                             f"{p_accepted.tolist()}")
    log(f"[spec] (b) fp32 1b width at {SPEC_FP32_LAYERS} layers, k={sp['k']}: random draft rounds "
        f"{out['random'][1][0].tolist()}, accepted {out['random'][1][2].tolist()}; perfect draft rounds "
        f"{p_rounds.tolist()}, accepted {p_accepted.tolist()} (every proposal); tokens "
        + ("equal to plain generate's for both drafts" if not ties else f"equal to plain generate's but at ties {ties}")
        + f"; counts on the round algebra (accepted = advanced - 1 - rounds) [{smi}]")
    del target, draft
    _free(torch)


def phase_int8_train(torch, fa, smi: str, p5: dict) -> None:
    """(c): phase 5's run at ``precision="int8"``, then ``quant_train_dot`` at
    the MLP's shape against its plain version."""
    from dmlcloud_tpu_torch.models import quant

    pipe, stage = _build(TRAIN_ARGV, precision="int8")
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses, val = _losses(stage)
    if launches != p5["launches"]:
        raise AssertionError(f"int8 training launches {launches}, phase 5 {p5['launches']}")
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, p5["losses"])]
    if len(losses) != len(p5["losses"]) or not all(math.isfinite(x) for x in losses) or max(rels) > INT8_LOSS_REL:
        raise AssertionError(f"int8 losses {losses} vs phase 5's {p5['losses']} (relative {rels})")
    n_layers = len(stage._quant_layers)
    batch = next(iter(stage._feed(stage.train_dataset())))
    step_ms, times = steady_ms(torch, stage, batch)
    log(f"[int8] (c) train_lm 1b at precision=\"int8\" ({n_layers} quantized dense layers): {wall:.1f} s; launches "
        f"{launches} (phase 5's); losses {[round(x, 4) for x in losses]}, val/loss {val:.4f}, each within "
        f"{max(rels):.4f} relative of phase 5's (bound {INT8_LOSS_REL}); steady step {step_ms:.1f} ms (median of "
        f"{[round(t, 1) for t in times]}) vs phase 6's {p5['steady_ms']:.1f} ms; peak memory {peak:.2f} GiB vs "
        f"phase 5's {PR1_PEAK_GIB} [{smi}]")
    del stage, pipe, batch
    _free(torch)

    sh = QTD_SHAPE
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(sh["m"], sh["k"], device="cuda", generator=g).to(torch.bfloat16).requires_grad_(True)
    w = (torch.randn(sh["k"], sh["n"], device="cuda", generator=g) / math.sqrt(sh["k"])).requires_grad_(True)
    amax = w.detach().abs().amax(0, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    gy = torch.randn(sh["m"], sh["n"], device="cuda", generator=g).to(torch.bfloat16)
    y = quant.quant_train_dot(x, w, scale)
    y.backward(gy)
    wq = torch.clamp(torch.round(w.detach() / scale), -127, 127) * scale  # the plain version: fake-quant in fp32
    y_ref = (x.detach().float() @ wq).to(torch.bfloat16)
    dx_ref = (gy.float() @ wq.t()).to(torch.bfloat16)
    dw_ref = x.detach().float().t() @ gy.float()
    errs = [assert_close(torch, y.detach(), y_ref, "bfloat16", "quant_train_dot y"),
            assert_close(torch, x.grad, dx_ref, "bfloat16", "quant_train_dot dx"),
            assert_close(torch, w.grad, dw_ref, "float32", "quant_train_dot dw")]
    fwd_ms = cuda_ms(torch, lambda: quant.quant_train_dot(x.detach(), w.detach(), scale))
    w_bf16 = w.detach().t().contiguous().to(torch.bfloat16)
    lin_ms = cuda_ms(torch, lambda: torch.nn.functional.linear(x.detach(), w_bf16))
    log(f"[int8] (c) quant_train_dot at x [{sh['m']}, {sh['k']}] bf16, w [{sh['k']}, {sh['n']}] fp32: y max abs err "
        f"{errs[0][0]:.3g} / rel {errs[0][1]:.3g}, dx {errs[1][0]:.3g} / {errs[1][1]:.3g} (bf16 TOL/REL_TOL), dw "
        f"{errs[2][0]:.3g} / {errs[2][1]:.3g} (fp32 TOL/REL_TOL) against the fp32 fake-quant plain version; forward "
        f"{fwd_ms:.3f} ms (quantize + widen + bf16 GEMM with fp32 output) vs a bf16 F.linear {lin_ms:.3f} ms [{smi}]")
    del x, w, gy, y
    _free(torch)


def phase_lora(torch, smi: str, model, cfg) -> None:
    """(d): per-row adapters on the 1b's forward against each tenant's merged
    model; then an adapters-only finetune of the 1b."""
    import dataclasses

    import numpy as np

    from dmlcloud_tpu_torch import TrainingPipeline, TrainValStage, optim
    from dmlcloud_tpu_torch.models import lora
    from dmlcloud_tpu_torch.models.transformer import DecoderLM, lm_loss

    lo = LORA
    g = torch.Generator(device="cuda").manual_seed(3)

    def nonzero_b(node):
        """The tree with every ``b`` drawn (lora_init's are zero: no delta)."""
        if isinstance(node, dict):
            return {k: nonzero_b(v) for k, v in node.items()}
        return node if node is None else node.replace(b=0.02 * torch.randn(node.b.shape, device="cuda", generator=g))

    tenants = [nonzero_b(lora.lora_init(g, model, rank=lo["rank"], in_axes=1)) for _ in range(lo["tenants"])]

    def stack(*nodes):
        if isinstance(nodes[0], dict):
            return {k: stack(*(n[k] for n in nodes)) for k in nodes[0]}
        if nodes[0] is None:
            return None
        return lora.LoraPair(a=torch.stack([n.a for n in nodes]),
                             b=torch.stack([n.b * (lo["alpha"] / lo["rank"]) for n in nodes]))

    rs = np.random.RandomState(29)
    tokens = torch.as_tensor(rs.randint(0, cfg.vocab_size, (lo["tenants"], lo["t"]))).cuda()
    ids = torch.arange(lo["tenants"], device="cuda")
    stacked = stack(*tenants)
    twin = DecoderLM(dataclasses.replace(cfg, dtype=torch.float32), device="cuda")
    twin.load_state_dict(model.state_dict())
    rows = []
    with torch.no_grad():
        got, got32 = model(tokens, adapters=(stacked, ids)), twin(tokens, adapters=(stacked, ids))
        moved = max_err(torch, got, model(tokens))
        for i, tree in enumerate(tenants):
            merged = {name: torch.func.functional_call(m, lora.lora_merge(m, tree, lo["alpha"]), (tokens[i : i + 1],))[0]
                      for name, m in (("bf16", model), ("fp32", twin))}
            # fp32: the per-row factored delta is the merged weight's, to fp32 rounding
            err32 = assert_close(torch, got32[i], merged["fp32"], "float32", f"tenant {i}'s fp32 adapted row")
            # bf16: two roundings of one function; the adapted row may be no
            # farther from its merged model than twice the merged model's own
            # bf16 distance from fp32 (phase 13 (b)'s rounding rule), and at
            # least REL_TOL bf16
            rounding = rel_err(torch, merged["bf16"], merged["fp32"])
            bound = max(REL_TOL["bfloat16"], 2 * rounding)
            rel = rel_err(torch, got[i], merged["bf16"])
            tol = TOL["bfloat16"]
            outside = float((~torch.isclose(got[i], merged["bf16"], atol=tol["atol"], rtol=tol["rtol"])).float().mean())
            if not bool(torch.isfinite(got[i]).all()) or not rel <= bound:
                raise AssertionError(f"tenant {i}'s bf16 adapted row is {rel:.3g} off its merged model in norm "
                                     f"(bound {bound:.3g}: the merged model's bf16 distance from fp32 {rounding:.3g})")
            rows.append(dict(fp32=round(err32[0], 7), bf16_rel=round(rel, 5), bound=round(bound, 5),
                             max_abs=round(max_err(torch, got[i], merged["bf16"]), 4), outside_tol=round(outside, 6)))
            del merged
    log(f"[lora] (d) per-row adapters on the 1b forward: {lo['tenants']} tenants, rank {lo['rank']}, in_axes=1, "
        f"{lo['tenants']} rows x {lo['t']} tokens, each row against its tenant's merged model: fp32 twin within "
        f"TOL/REL_TOL fp32 (max abs err per row {[r['fp32'] for r in rows]}); bf16 norm-relative "
        f"{[r['bf16_rel'] for r in rows]} against bounds {[r['bound'] for r in rows]}, max abs err "
        f"{[r['max_abs'] for r in rows]}, share of logits outside TOL bf16 {[r['outside_tol'] for r in rows]}; the "
        f"adapters move the bf16 logits by up to {moved:.3g} [{smi}]")
    del got, got32, twin, stacked
    _free(torch)

    seq_cfg = dataclasses.replace(cfg, attn_impl="flash", max_seq_len=lo["seq"])
    data = [{"tokens": rs.randint(0, cfg.vocab_size, (lo["batch"], lo["seq"])).astype(np.int64)}
            for _ in range(lo["steps"])]

    class LoraStage(TrainValStage):
        def pre_stage(self):
            base_model = DecoderLM(seq_cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
            self.snapshot = {n: p.detach().clone() for n, p in base_model.named_parameters()}
            adapters = lora.lora_init(torch.Generator(device="cuda").manual_seed(4), base_model, rank=lo["rank"])
            self.pipeline.register_model("lm", lora.LoraModel(base_model, adapters, lo["alpha"]), verbose=False)
            self.pipeline.register_optimizer("adamw", optim.adamw(1e-3))
            self.pipeline.register_dataset("train", data, verbose=False)

        def step(self, state, batch):
            return lm_loss(state.model(batch["tokens"]), batch["tokens"])

        def val_epoch(self):
            pass

    pipe = TrainingPipeline(name="lora-1b", device="cuda")
    stage = LoraStage()
    pipe.append_stage(stage, max_epochs=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in stage.train_losses]
    lm = stage.state.model
    unchanged = all(torch.equal(lm.base.get_buffer(n), p) for n, p in stage.snapshot.items())
    sd = stage.state.state_dict()
    opt_bytes = sum(v.numel() * v.element_size() for slot in sd["opt_state"].values() if isinstance(slot, dict)
                    for v in slot.values())
    adapter_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    base_bytes = sum(b.numel() * b.element_size() for b in lm.base.buffers())
    batch = next(iter(stage._feed(stage.train_dataset())))
    step_ms, times = steady_ms(torch, stage, batch)
    still = all(torch.equal(lm.base.get_buffer(n), p) for n, p in stage.snapshot.items())
    if not (unchanged and still) or not all(math.isfinite(x) for x in losses) or opt_bytes > 3 * adapter_bytes:
        raise AssertionError(f"LoRA finetune: base unchanged {unchanged}/{still}, losses {losses}, optimizer state "
                             f"{opt_bytes} B vs adapters {adapter_bytes} B")
    log(f"[lora] (d) adapters-only finetune of the 1b (rank {lo['rank']} on every kernel, flash attention, "
        f"{lo['steps']} steps of {lo['batch']} x {lo['seq']}): {wall:.1f} s, losses {[round(x, 4) for x in losses]}; "
        f"base bitwise unchanged ({base_bytes / 2**30:.2f} GiB of buffers); adapters {adapter_bytes / 2**20:.1f} MiB, "
        f"optimizer state {opt_bytes / 2**20:.1f} MiB; {step_ms:.1f} ms per step (median of "
        f"{[round(t, 1) for t in times]}); peak memory {peak:.2f} GiB [{smi}]")
    del stage, pipe, lm, batch
    _free(torch)


def phase_quant_lora(torch, fa, smi: str, p5: dict) -> None:
    """Phase 17: (a) int8 decode, (b) speculative decoding, (c) int8
    training, (d) LoRA."""
    ctx = phase_int8_decode(torch, smi)
    phase_spec(torch, smi, ctx["model"], ctx["cfg"])
    phase_lora(torch, smi, ctx["model"], ctx["cfg"])
    del ctx
    _free(torch)
    phase_int8_train(torch, fa, smi, p5)


# ---------------------------------------------------------------------------
# phase 18: Mixture-of-Experts (the 1b-moe configuration)
# ---------------------------------------------------------------------------

#: 1b-moe: the 1b preset with 8 experts in every second block (top-2,
#: capacity factor 1.25: the reference's MoE defaults), its depth cut to 8
#: layers (4 MoE blocks) so that its fp32 state fits one card
MOE = dict(num_experts=8, moe_every=2, moe_top_k=2, moe_capacity_factor=1.25)
MOE_LAYERS = 8
#: (a): one MoE layer at the 1b-moe width on B=4 rows of T=2048 tokens, bf16
MOE_LAYER = dict(b=4, t=2048)
#: (b): AdamW steps of B=4 rows of T=2048
MOE_TRAIN = dict(b=4, t=2048, steps=6, lr=3e-4)
#: (c): generate 8 rows x 128 prompt tokens, 64 new; the fp32 check at 2
#: layers decodes 16 and runs at capacity factor 8 (= the expert count: no
#: choice dropped, so a token routes the same in a decode step and in the
#: no-cache forward)
MOE_DECODE = dict(rows=8, prompt=128, new=64, check_layers=2, check_new=16)


def _moe_cfg(torch, layers: int, dtype, **kw):
    from dmlcloud_tpu_torch.examples.train_lm import PRESETS
    from dmlcloud_tpu_torch.models.transformer import TransformerConfig

    preset = dict(PRESETS["1b"], num_layers=layers)
    return TransformerConfig(vocab_size=32000, max_seq_len=2048, attn_impl="flash", dtype=dtype,
                             **dict(MOE, **kw), **preset)


def phase_moe_layer(torch, smi: str) -> None:
    """(a): the index dispatch against the one-hot plain version."""
    from dmlcloud_tpu_torch.models.moe import MoEMLP

    cfg = _moe_cfg(torch, 2, torch.bfloat16).moe_config()
    gen = torch.Generator(device="cuda").manual_seed(0)
    layer = MoEMLP(cfg, device="cuda")
    layer.reset_parameters(gen)
    with torch.no_grad():
        std = math.sqrt(1.0 / cfg.hidden_dim) / 0.87962566103423978
        torch.nn.init.trunc_normal_(layer.router.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
    b, t = MOE_LAYER["b"], MOE_LAYER["t"]
    x = torch.randn(b, t, cfg.hidden_dim, device="cuda", generator=gen).to(torch.bfloat16)
    g = torch.randn(b, t, cfg.hidden_dim, device="cuda", generator=gen).to(torch.bfloat16)
    route = layer.route(x.reshape(-1, cfg.hidden_dim))
    dropped = 1.0 - float(route.keep.float().mean())
    outs = {}
    for name, fwd in (("index", layer.forward), ("one-hot", layer.forward_onehot)):
        xi = x.clone().requires_grad_(True)
        layer.zero_grad()
        y = fwd(xi)
        y.backward(g)
        outs[name] = [y.detach(), xi.grad] + [p.grad.clone() for p in
                                              (layer.router.weight, layer.gate_proj, layer.up_proj, layer.down_proj)]
    names = ["output", "dx", "router grad", "gate grad", "up grad", "down grad"]
    errs = [assert_close(torch, got, want, "bfloat16", f"MoE index dispatch {n}")
            for n, got, want in zip(names, outs["index"], outs["one-hot"])]
    times = {}
    for name, fwd in (("index", layer.forward), ("one-hot", layer.forward_onehot)):
        xi = x.clone().requires_grad_(True)
        times[name] = cuda_ms(torch, lambda: fwd(xi), reps=5)
        times[name + " fwd+bwd"] = cuda_ms(torch, lambda: fwd(xi).backward(g), reps=5)
    layer.zero_grad()
    log(f"[moe] (a) MoEMLP D {cfg.hidden_dim}, M {cfg.mlp_dim}, E {cfg.num_experts}, top-{cfg.top_k}, cf "
        f"{cfg.capacity_factor}, N {b * t} bf16: capacity {route.capacity}, dropped (token, choice) share "
        f"{dropped:.4f}; index vs one-hot max abs err "
        f"{', '.join(f'{n} {e[0]:.3g}' for n, e in zip(names, errs))}; ms: index {times['index']:.3f} fwd / "
        f"{times['index fwd+bwd']:.3f} fwd+bwd, one-hot {times['one-hot']:.3f} / {times['one-hot fwd+bwd']:.3f} "
        f"[{smi}]")
    del layer, outs, x, g
    _free(torch)


def _moe_stage(torch, cfg, batches, lr):
    """A ``TrainValStage`` training ``DecoderLM(cfg)`` (seed 0) on ``batches``
    with AdamW; its step returns ``lm_loss + total_aux_loss`` (the reference's
    pattern) and keeps each step's aux value."""
    import dmlcloud_tpu_torch as dml
    from dmlcloud_tpu_torch.models.moe import total_aux_loss
    from dmlcloud_tpu_torch.models.transformer import DecoderLM, lm_loss
    from dmlcloud_tpu_torch.optim import adamw

    class MoEStage(dml.TrainValStage):
        def pre_stage(self):
            self.aux = []
            model = DecoderLM(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
            self.pipeline.register_model("lm", model, verbose=False)
            self.pipeline.register_optimizer("adamw", adamw(lr))
            self.pipeline.register_dataset("train", batches, verbose=False)

        def step(self, state, batch):
            loss = lm_loss(state.model(batch), batch)
            aux = total_aux_loss(state.model)
            self.aux.append(aux.detach())
            return loss + aux

        def val_epoch(self):
            pass

    return MoEStage()


def phase_moe_train(torch, fa, smi: str) -> dict:
    """(b): 1b-moe at 8 layers through the ``TrainingPipeline``."""
    import dmlcloud_tpu_torch as dml

    cfg = _moe_cfg(torch, MOE_LAYERS, torch.bfloat16)
    tr = MOE_TRAIN
    gen = torch.Generator().manual_seed(0)
    batches = [torch.randint(0, cfg.vocab_size, (tr["b"], tr["t"]), generator=gen) for _ in range(tr["steps"])]
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    pipe = dml.TrainingPipeline({"seed": 0}, name="moe", device="cuda")
    stage = _moe_stage(torch, cfg, batches, tr["lr"])
    pipe.append_stage(stage, max_epochs=1)
    fa.reset_launch_counts()  # the MoE run starts here ...
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in stage.train_losses]
    aux = [float(a) for a in stage.aux]
    n_params = sum(p.numel() for p in stage.state.model.parameters())
    n = len(losses)
    want = {"flash_fwd_tc": MOE_LAYERS * n, "flash_bwd_dq_tc": MOE_LAYERS * n, "flash_bwd_dkv_tc": MOE_LAYERS * n,
            "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    log(f"[moe] (b) 1b-moe at {MOE_LAYERS} layers ({n_params / 1e9:.3f} B parameters), {n} AdamW steps of "
        f"{tr['b']} x {tr['t']} tokens: losses {losses}; aux {aux}; launches {launches}; {wall:.1f} s wall "
        f"(model build included); peak {peak / 2**30:.2f} GiB [{smi}]")
    if n != tr["steps"] or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"1b-moe: {n} steps, losses {losses}")
    if not all(math.isfinite(a) and a > 0 for a in aux) or len(aux) != n:
        raise AssertionError(f"1b-moe: aux losses {aux}")
    if launches != want:
        raise AssertionError(f"1b-moe: kernel launches {launches}, want {want}")
    batch = next(iter(stage._feed(stage.train_dataset())))
    step_ms, times = steady_ms(torch, stage, batch)
    tokens = tr["b"] * tr["t"]
    log(f"[moe] (b) steady step {step_ms:.1f} ms median of {[round(x, 1) for x in times]} = "
        f"{tokens / step_ms * 1e3:.0f} tokens/s [{smi}]")
    wall_us, busy_us, events = profile_step(torch, stage, batch)
    if busy_us:
        log_profile("moe", f"1b-moe train step [{smi}]", wall_us, busy_us, events, top=10)
    else:
        log("[moe] profiler recorded no device time: idle share not measured")
    out = {"launches": launches, "per_step": {k: v // n for k, v in launches.items()}, "step_ms": step_ms,
           "peak_gib": peak / 2**30}
    del stage, pipe, batch
    _free(torch)
    return out


def phase_moe_decode(torch, smi: str) -> None:
    """(c) decode 1b-moe, (d) its int8 model."""
    import numpy as np

    from dmlcloud_tpu_torch.models import quant
    from dmlcloud_tpu_torch.models.generate import generate
    from dmlcloud_tpu_torch.models.transformer import DecoderLM

    d = MOE_DECODE
    rs = np.random.RandomState(18)
    # the fp32 check: each decode step's logits against the no-cache forward
    cfg32 = _moe_cfg(torch, d["check_layers"], torch.float32, moe_capacity_factor=float(MOE["num_experts"]))
    model32 = DecoderLM(cfg32, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.as_tensor(rs.randint(0, cfg32.vocab_size, (d["rows"], d["prompt"]))).cuda()
    tokens = generate(model32, prompt, d["check_new"])
    with torch.no_grad():
        dec = _decode_logits(torch, model32, prompt, tokens)
        full = model32(torch.cat([prompt, tokens[:, :-1]], 1))[:, prompt.shape[1] - 1:]
    rel = rel_err(torch, dec, full)
    log(f"[moe] (c) fp32 1b-moe width at {d['check_layers']} layers (capacity factor {cfg32.moe_capacity_factor}): "
        f"{d['check_new']} greedy decode steps' logits against the no-cache forward, norm-relative {rel:.3g} "
        f"[{smi}]")
    if not rel <= REL_TOL["float32"]:
        raise AssertionError(f"1b-moe decode logits {rel:.3g} from the no-cache forward (> {REL_TOL['float32']})")
    del model32
    _free(torch)

    cfg = _moe_cfg(torch, MOE_LAYERS, torch.bfloat16)
    model = DecoderLM(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.as_tensor(rs.randint(0, cfg.vocab_size, (d["rows"], d["prompt"]))).cuda()
    toks, ms, peak = _timed_generate(torch, model, prompt, d["new"])
    log(f"[moe] (c) generate, 1b-moe bf16 at {MOE_LAYERS} layers, {d['rows']} rows x {d['prompt']} prompt tokens, "
        f"{d['new']} new: {ms:.2f} ms per decode step = {d['rows'] / ms * 1e3:.1f} tokens/s, peak {peak:.2f} GiB "
        f"[{smi}]")
    if tuple(toks.shape) != (d["rows"], d["new"]):
        raise AssertionError(f"1b-moe generate gave {tuple(toks.shape)}")
    qmodel = quant.quantize_tree(model)
    routers = [m for name, m in qmodel.named_modules() if name.endswith("moe.router.weight")]
    if len(routers) != MOE_LAYERS // 2 or not all(isinstance(r, quant.QuantizedTensor) for r in routers):
        raise AssertionError(f"quantize_tree left the routers unquantized ({len(routers)} found)")
    qtoks, qms, qpeak = _timed_generate(torch, qmodel, prompt, d["new"])
    agree = float((qtoks == toks).float().mean())
    log(f"[moe] (d) int8 1b-moe ({len(routers)} routers and every dense kernel quantized; the experts stay fp32): "
        f"resident {_resident_gib(qmodel):.3f} GiB against {_resident_gib(model):.3f} GiB; generate {qms:.2f} ms per "
        f"decode step, peak {qpeak:.2f} GiB; greedy agreement with bf16 {agree:.3f} [{smi}]")
    if tuple(qtoks.shape) != (d["rows"], d["new"]):
        raise AssertionError(f"int8 1b-moe generate gave {tuple(qtoks.shape)}")
    del model, qmodel
    _free(torch)


def phase_moe(torch, fa, smi: str) -> dict:
    phase_moe_layer(torch, smi)
    out = phase_moe_train(torch, fa, smi)
    phase_moe_decode(torch, smi)
    return out


# ---------------------------------------------------------------------------
# phase 19: the serving engine's modes
# ---------------------------------------------------------------------------

#: (a): requests sharing one prefix: count, prefix and suffix lengths, new tokens; the engine's knobs
SHARED = dict(requests=16, prefix=768, suffix=(64, 256), new=128)
SERVE19 = dict(max_slots=8, block_size=16, prefill_chunk=256)
#: (b)/(c): requests of (b) and (c), their prompt lengths and new tokens; proposals per round
ROUNDS = dict(requests=8, prompt=(128, 256), new=64, k=4)
#: (d): tenants and their rank, requests per tenant, prompt and new tokens
TENANTS = dict(tenants=4, rank=16, alpha=16.0, prompt=128, new=32)
#: (e): the drill's requests (prompt lengths, new tokens) and the monkey
#: (prefill faults only: a decode fault fails the whole batch of 8, which leaves no survivor to check)
DRILL = dict(requests=12, prompt=(32, 256), new=32,
             monkey=dict(seed=7, p_fault=0.1, fault_points=("prefill",), max_faults=2, p_exhaust=0.1,
                         exhaust_blocks=16, exhaust_steps=2, p_stall=0.05, stall_s=0.5, p_cancel=0.05))
#: a bf16 greedy token that parts from the run it is compared with must do so where that run's top-2
#: logit gap is under this: above the gaps where two bf16 paths of the random 1b parted (<= 0.086 in
#: phase 17, <= 0.0311 in phase 19), below the median gap of the compared steps (0.11-0.28 in phase 19).
#: Each comparison prints its median and the share of steps under the bound, where a fault's parting
#: would pass; the exactness gate of the modes is (f), in fp32.
BF16_TIE_GAP = 0.1
#: (f): the fp32 run of the modes at the 1b width: depth, requests on one prefix (prefix and suffix
#: lengths), new tokens, proposals per round, tenants' rank and the scale of their b
EXACT = dict(layers=2, requests=4, prefix=64, suffix=(16, 48), new=24, k=4, rank=16, b_scale=0.05)
EXACT_ENGINE = dict(max_slots=4, block_size=16, prefill_chunk=128)


def _burst(torch, engine, prompts, new: int, profile: bool = False, adapters=None) -> dict:
    """Serve ``prompts`` (with the tenants ``adapters``, one per prompt, when
    given) through ``engine`` and time it: the wall, each request's TTFT and
    tokens, and the decode-only steps (no prefill pending).
    With ``profile``, the first decode-only step that runs every row goes
    under ``torch.profiler`` instead of the step timing; the wall keeps that
    step's own time, not the profiler's set-up and post-processing."""
    import numpy as np

    sched = engine.scheduler
    torch.cuda.synchronize()
    rids = [engine.submit(p, new, adapter=a) for p, a in zip(prompts, adapters or [None] * len(prompts))]
    emitted = lambda: sum(len(engine.sequence(r).out) for r in rids)
    step_s, step_tokens, profiled, steps, overhead = 0.0, 0, None, [], 0.0
    t0 = time.perf_counter()
    while not engine.idle:
        decode_only = not sched.prefilling and (sched.num_waiting == 0 or sched.active >= sched.max_slots)
        if profile and decode_only and profiled is None and len(sched.running) == min(len(rids), sched.max_slots):
            p0 = time.perf_counter()
            profiled = profile_call(torch, engine.step)
            overhead = time.perf_counter() - p0 - profiled[0] / 1e6
            continue
        before = emitted()
        s0 = time.perf_counter()
        engine.step()
        steps.append((time.perf_counter() - s0) * 1e3)
        if decode_only:
            step_s += steps[-1] / 1e3
            step_tokens += emitted() - before
    wall = time.perf_counter() - t0 - overhead
    seqs = [engine.sequence(r) for r in rids]
    bad = [(r, s.status, len(s.out)) for r, s in zip(rids, seqs) if s.status != "ok" or len(s.out) != new]
    if bad or engine.leaked_blocks():
        raise AssertionError(f"requests ended {bad}, {engine.leaked_blocks()} leaked blocks")
    engine.pool.assert_consistent()
    return {"wall": wall, "ttft": np.asarray([(s.first_token - s.arrival) * 1e3 for s in seqs]),
            "tokens": [list(s.out) for s in seqs], "rids": rids, "profile": profiled, "steps": steps,
            "decode_tps": step_tokens / step_s if step_s else float("nan"),
            "ms_per_token": wall / (len(rids) * new) * 1e3}


def _gaps(torch, model, prompt, tokens):
    """The top-2 logit gap of ``model`` at every greedy step of ``tokens``
    after ``prompt`` (one no-cache forward)."""
    with torch.no_grad():
        seq = torch.as_tensor([*prompt, *tokens]).long().cuda()
        top = model(seq[None])[0, len(prompt) - 1 : len(prompt) - 1 + len(tokens)].float().topk(2).values
    return (top[:, 0] - top[:, 1]).cpu().tolist()


def _agreement(torch, model, prompts, got, want) -> tuple[float, list, str]:
    """Greedy agreement of ``got`` with ``want`` (token lists per request);
    per row that parts, (row, step, the top-2 logit gap of ``want``'s run
    there, from a no-cache forward of ``model``); and the median gap over all
    of ``want``'s steps with the share of them under ``BF16_TIE_GAP``. Fails
    on a parting at or above ``BF16_TIE_GAP``."""
    same = total = 0
    partings, gaps = [], []
    for r, (p, g, w) in enumerate(zip(prompts, got, want)):
        same += sum(int(a == b) for a, b in zip(g, w))
        total += len(w)
        row = _gaps(torch, model, p, w)
        gaps += row
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is not None:
            partings.append((r, j, round(row[j], 4)))
            if not row[j] < BF16_TIE_GAP:
                raise AssertionError(f"row {r} parts at step {j} where the top-2 gap is {row[j]:.3g} "
                                     f"(>= {BF16_TIE_GAP}: not a bf16 tie)")
    under = sum(x < BF16_TIE_GAP for x in gaps) / len(gaps)
    return same / total, partings, (f"median top-2 gap {statistics.median(gaps):.4f} over {len(gaps)} steps, "
                                    f"{under:.3f} of them under {BF16_TIE_GAP}")


def phase_prefix(torch, smi: str, model, cfg) -> dict:
    """(a): 16 requests on one 768-token prefix, with and without the prefix
    cache."""
    import tempfile

    import numpy as np

    from dmlcloud_tpu_torch.serve import ServeEngine
    from dmlcloud_tpu_torch.telemetry import journal

    sh = SHARED
    rs = np.random.RandomState(19)
    prefix = rs.randint(0, cfg.vocab_size, sh["prefix"])
    prompts = [np.concatenate([prefix, rs.randint(0, cfg.vocab_size, int(rs.randint(sh["suffix"][0],
                                                                                      sh["suffix"][1] + 1)))])
               for _ in range(sh["requests"])]
    per_req = -(-(sh["prefix"] + sh["suffix"][1] + sh["new"]) // SERVE19["block_size"])
    num_blocks = SERVE19["max_slots"] * per_req + sh["prefix"] // SERVE19["block_size"]
    runs = {}
    for cached in (False, True):
        engine = ServeEngine(model, num_blocks=num_blocks, prefix_cache=cached, **SERVE19)
        # the template alone first: the cuBLAS handles warm, and with the cache its 48 blocks enter the tree
        warm = engine.submit(prefix, 4)
        engine.run()
        if engine.status(warm) != "ok":
            raise AssertionError(f"warm-up request ended {engine.status(warm)}")
        res = _burst(torch, engine, prompts, sh["new"])
        if cached:
            # an exact duplicate of the template: its full-block match re-feeds the last token, whose write
            # forks the last shared block (counted from the journal's cow_fork spans)
            with tempfile.TemporaryDirectory() as tmp:
                j = journal.activate(journal.SpanJournal(tmp))
                try:
                    dup = engine.submit(prefix, 4)
                    engine.run()
                finally:
                    journal.deactivate()
                res["forks"] = sum(1 for r in j.tail(1 << 12) if r["kind"] == "cow_fork")
            if engine.status(dup) != "ok" or engine.output(dup).tolist() != engine.output(warm).tolist():
                raise AssertionError(f"the duplicate ended {engine.status(dup)} with {engine.output(dup)}")
            recs = [engine.ledger.records[r] for r in res["rids"]]
            res["saved"] = sum(r["saved_tokens"] for r in recs)
            res["locks"] = engine.prefix.leaked_locks()
            res["tree"] = engine.prefix.stats()
            if res["saved"] != sh["requests"] * sh["prefix"] or res["forks"] != 1 or res["locks"]:
                raise AssertionError(f"prefix cache: saved {res['saved']} tokens (want "
                                     f"{sh['requests'] * sh['prefix']}), forks {res['forks']}, locks {res['locks']}")
        res["leaked"] = engine.leaked_blocks()
        if res["leaked"]:
            raise AssertionError(f"{res['leaked']} leaked blocks")
        runs[cached] = res
        del engine
        _free(torch)
    agree, partings, gaps = _agreement(torch, model, prompts, runs[True]["tokens"], runs[False]["tokens"])
    for cached, res in runs.items():
        extra = (f"; prefill tokens saved {res['saved']} of {sum(len(p) for p in prompts)}, COW forks {res['forks']} "
                 f"(the exact duplicate), tree {res['tree']['nodes']} nodes, 0 leaked locks" if cached else "")
        log(f"[serve19] (a) 1b bf16, {sh['requests']} requests on one {sh['prefix']}-token prefix (+{sh['suffix'][0]}-"
            f"{sh['suffix'][1]} suffix, {sh['new']} new), {SERVE19}, prefix_cache={cached}: {res['wall']:.2f} s, "
            f"TTFT p50 {np.percentile(res['ttft'], 50):.1f} ms, p99 {np.percentile(res['ttft'], 99):.1f} ms; "
            f"{res['decode_tps']:.1f} decode tokens/s{extra}; 0 leaked blocks [{smi}]")
    log(f"[serve19] (a) greedy agreement with and without the cache {agree:.4f}; partings (row, step, top-2 gap): "
        f"{partings or 'none'}; the uncached run's {gaps} [{smi}]")
    return runs[False]


def phase_rounds(torch, smi: str, model, cfg) -> None:
    """(b) spec_k=4 with a self-draft and a random 1-layer draft, (c)
    medusa_k=4 with warm-started heads, each against the plain engine on the
    same requests; the engine's journal spans split each mode's time. Every
    engine serves the burst twice, in the order plain, the modes, the modes
    backwards, plain, so that no mode's time rests on one place in the
    sequence."""
    import dataclasses
    import tempfile

    import numpy as np

    from dmlcloud_tpu_torch.models.transformer import DecoderLM
    from dmlcloud_tpu_torch.serve import ServeEngine
    from dmlcloud_tpu_torch.telemetry import journal

    ro = ROUNDS
    rs = np.random.RandomState(20)
    prompts = [rs.randint(0, cfg.vocab_size, int(rs.randint(ro["prompt"][0], ro["prompt"][1] + 1)))
               for _ in range(ro["requests"])]
    per_req = -(-(ro["prompt"][1] + ro["new"] + ro["k"] + 1) // SERVE19["block_size"])
    num_blocks = SERVE19["max_slots"] * per_req
    draft = DecoderLM(dataclasses.replace(cfg, num_layers=1), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(1))
    modes = {"plain": {}, "spec self-draft": dict(spec_k=ro["k"], draft_num_blocks=num_blocks),
             "spec 1-layer draft": dict(spec_k=ro["k"], draft_model=draft, draft_num_blocks=num_blocks),
             "medusa": dict(medusa_k=ro["k"])}
    engines = {}
    for name, kw in modes.items():
        engines[name] = engine = ServeEngine(model, num_blocks=num_blocks, **SERVE19, **kw)
        engine.submit(prompts[0][:32], 8)  # warm-up: first calls outside the timing
        engine.run()
    out = {}
    for name in [*modes, *reversed(modes)]:
        engine = engines[name]
        if name not in out:
            with tempfile.TemporaryDirectory() as tmp:
                j = journal.activate(journal.SpanJournal(tmp, ring_size=1 << 16))
                try:
                    res = _burst(torch, engine, prompts, ro["new"], profile=True)
                finally:
                    journal.deactivate()
                res["spans"] = _span_ms(j.tail(1 << 16))
            summary = engine.ledger.summary()
            res["accept"] = summary["accept_rate"]
            res["drafted"] = summary["drafted_tokens"]
            out[name] = res
        else:
            again = _burst(torch, engine, prompts, ro["new"])
            out[name]["ms2"] = again["ms_per_token"]
            out[name]["same2"] = again["tokens"] == out[name]["tokens"]
        pools = [engine.pool] + ([engine.draft_pool] if engine.draft_pool is not None else [])
        out[name]["leaked"] = engine.leaked_blocks()
        if out[name]["leaked"] or any(p.num_free != p.num_blocks for p in pools):
            raise AssertionError(f"{name}: {out[name]['leaked']} leaked blocks")
    del engines
    _free(torch)
    if out["spec self-draft"]["accept"] is None or out["spec self-draft"]["drafted"] == 0:
        raise AssertionError("the self-draft proposed nothing")
    for res in out.values():
        res["ms_mean"] = (res["ms_per_token"] + res["ms2"]) / 2
    plain = out["plain"]
    log(f"[serve19] (b)(c) plain engine, 1b bf16, {ro['requests']} requests ({ro['prompt'][0]}-{ro['prompt'][1]} "
        f"prompt tokens, {ro['new']} new): {plain['ms_per_token']:.2f} and {plain['ms2']:.2f} ms per token (first "
        f"and last burst of the sequence), {plain['decode_tps']:.1f} decode tokens/s in the first [{smi}]")
    _log_round_profile(f"plain decode step of {ro['requests']} rows [{smi}]", plain["profile"])
    log(f"[serve19] (b)(c) host wall per engine span (kind: calls, median ms, total ms), each mode's first burst: "
        + "; ".join(f"{name}: {out[name]['spans']}" for name in modes) + f" [{smi}]")
    for name in modes:
        st = sorted(out[name]["steps"])
        in_spans = sum(total for _, _, total in out[name]["spans"].values())
        log(f"[serve19] (b)(c) {name}, first burst: {len(st)} unprofiled steps, median {statistics.median(st):.2f} "
            f"ms, max {st[-1]:.2f}, the 3 longest {[round(x, 1) for x in st[-3:]]}; steps {sum(st):.1f} ms of the "
            f"burst's {out[name]['wall'] * 1e3:.1f}, spans {in_spans:.1f} [{smi}]")
    for name in ("spec self-draft", "spec 1-layer draft", "medusa"):
        res = out[name]
        agree, partings, gaps = _agreement(torch, model, prompts, res["tokens"], plain["tokens"])
        tag = "(c)" if name == "medusa" else "(b)"
        spread = abs(res["ms_per_token"] - res["ms2"]) / res["ms_mean"]
        log(f"[serve19] {tag} {name}, k={ro['k']}: accept rate {res['accept']}, {res['drafted']} tokens drafted; "
            f"{res['ms_per_token']:.2f} and {res['ms2']:.2f} ms per token in its two bursts (spread {spread:.3f}), "
            f"mean {res['ms_mean']:.2f} vs plain's {plain['ms_mean']:.2f} ({res['ms_mean'] / plain['ms_mean']:.2f}x); "
            f"second burst's tokens equal the first's: {res['same2']}; greedy agreement with plain {agree:.4f}, "
            f"partings (row, step, top-2 gap) {partings or 'none'}, plain's {gaps}; 0 leaked blocks"
            + (" in both pools" if name != "medusa" else "") + f" [{smi}]")
        _log_round_profile(f"{name} round of {ro['requests']} rows [{smi}]", res["profile"])
    del draft
    _free(torch)


def _span_ms(records) -> dict:
    """``{kind: (calls, median ms, total ms)}`` of the engine's device-call
    spans (the draft pool's prefill mirror apart, as ``draft_prefill``)."""
    by: dict = {}
    for r in records:
        kind = r["kind"]
        if kind == "draft" and str(r.get("label", "")).endswith(":prefill"):
            kind = "draft_prefill"
        if kind in ("prefill", "decode_batch", "draft", "draft_prefill", "verify", "medusa"):
            by.setdefault(kind, []).append(r["dur"] * 1e3)
    return {k: (len(v), round(statistics.median(v), 2), round(sum(v), 1)) for k, v in by.items()}


def _log_round_profile(what: str, profiled) -> None:
    if profiled is None:
        log(f"[serve19] {what}: not profiled (no decode-only step ran every row)")
    else:
        log_profile("serve19", what, *profiled)


def phase_tenants(torch, smi: str, model, cfg) -> None:
    """(d): 4 rank-16 tenants and the base through one engine, each against
    ``generate`` on its merged model."""
    import copy

    import numpy as np

    from dmlcloud_tpu_torch.models import lora
    from dmlcloud_tpu_torch.models.generate import generate
    from dmlcloud_tpu_torch.serve import AdapterSet, ServeEngine

    te = TENANTS
    g = torch.Generator(device="cuda").manual_seed(5)

    def nonzero_b(node):
        if isinstance(node, dict):
            return {k: nonzero_b(v) for k, v in node.items()}
        return node if node is None else node.replace(b=0.02 * torch.randn(node.b.shape, device="cuda", generator=g))

    trees = {f"t{i}": nonzero_b(lora.lora_init(g, model, rank=te["rank"], in_axes=1)) for i in range(te["tenants"])}
    aset = AdapterSet(trees, alpha=te["alpha"], base=model)
    rs = np.random.RandomState(21)
    prompt = rs.randint(0, cfg.vocab_size, te["prompt"])
    names = [*trees, None]
    engine = ServeEngine(model, num_blocks=SERVE19["max_slots"] * 16, adapters=aset, **SERVE19)
    res = _burst(torch, engine, [prompt] * len(names), te["new"], adapters=names)
    got = dict(zip(names, res["tokens"]))
    del engine
    _free(torch)
    rows = []
    for name in names:
        if name is None:
            merged = model
        else:
            merged = copy.deepcopy(model)
            merged.load_state_dict(lora.lora_merge(model, trees[name], alpha=te["alpha"]), strict=False)
        want = generate(merged, prompt[None], te["new"])[0].tolist()
        agree, partings, gaps = _agreement(torch, merged, [prompt], [got[name]], [want])
        rows.append((name, round(agree, 4), partings, gaps))
        if merged is not model:
            del merged
            _free(torch)
    if len({tuple(t) for t in got.values()}) < 2:
        raise AssertionError("every tenant decoded the base model's tokens: the adapters did not bite")
    log(f"[serve19] (d) {te['tenants']} rank-{te['rank']} tenants + the base through one engine (1b bf16, "
        f"{te['prompt']} prompt tokens, {te['new']} new): {res['ms_per_token']:.2f} ms per token; against generate "
        f"on each merged model (tenant, agreement, partings (row, step, top-2 gap), gaps): {rows}; 0 leaked blocks [{smi}]")


def phase_drill(torch, smi: str, model, cfg) -> None:
    """(e): metrics, a TTFT SLO and a seeded chaos drill, then a drain and a
    scrape."""
    import tempfile
    import urllib.request

    import numpy as np

    from dmlcloud_tpu_torch.checkpoint import read_requeue_verdict
    from dmlcloud_tpu_torch.serve import SLO, TERMINAL_STATUSES, ChaosMonkey, MetricsServer, ServeEngine
    from dmlcloud_tpu_torch.telemetry.metrics_registry import parse_prometheus_text

    dr = DRILL
    rs = np.random.RandomState(22)
    prompts = [rs.randint(0, cfg.vocab_size, int(rs.randint(dr["prompt"][0], dr["prompt"][1] + 1)))
               for _ in range(dr["requests"])]
    run_dir = tempfile.mkdtemp()
    try:
        engine = ServeEngine(model, num_blocks=SERVE19["max_slots"] * 20, metrics=True, prefix_cache=True,
                             slos=[SLO("ttft", ttft_p99_s=2.0)], run_dir=run_dir, **SERVE19)
        monkey = ChaosMonkey(**dr["monkey"]).attach(engine)
        rids = [engine.submit(p, dr["new"]) for p in prompts]
        steps = 0
        t0 = time.perf_counter()
        while not engine.idle:
            engine.step()
            engine.pool.assert_consistent()
            steps += 1
        wall = time.perf_counter() - t0
        monkey.detach()
        statuses = [engine.status(r) for r in rids]
        if not all(s in TERMINAL_STATUSES for s in statuses) or engine.leaked_blocks() or "ok" not in statuses:
            raise AssertionError(f"drill ended {statuses} with {engine.leaked_blocks()} leaked blocks")
        verdict = engine.drain()
        on_disk = read_requeue_verdict(run_dir)
        if on_disk is None or on_disk["kind"] != "completed" or on_disk["serve"]["statuses"] != verdict["serve"][
                "statuses"]:
            raise AssertionError(f"requeue.json reads {on_disk}, the drain returned {verdict}")
        with MetricsServer(engine.metrics_text) as srv:
            url = srv.url
            with urllib.request.urlopen(url, timeout=10) as resp:
                body = resp.read().decode()
                status = resp.status
        fams = parse_prometheus_text(body)
        if status != 200 or "dml_serve_ttft_seconds" not in fams or not url.startswith("http://127.0.0.1:"):
            raise AssertionError(f"the scrape answered {status} with {sorted(fams)}")
        census = engine.ledger.status_counts()
        summary = engine.ledger.summary()
        log(f"[serve19] (e) chaos drill {dr['monkey']} over {dr['requests']} requests (1b bf16, prefix cache, "
            f"metrics, SLO ttft p99 2 s): {steps} steps in {wall:.2f} s, census {census}, events "
            f"{sorted({k for _, k, _ in monkey.log})} ({len(monkey.log)}), pool consistent after every step, 0 leaked "
            f"blocks; TTFT p50 {summary['p50_ttft_s']:.3f} s, SLO alerts {summary['slo']['alerts']}; drain verdict "
            f"{verdict['kind']}, requeue {verdict['requeue']}, requeue.json written; one scrape of "
            f"{url}: {len(fams)} families, {len(body)} bytes [{smi}]")
        del engine
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    _free(torch)


def phase_exact(torch, smi: str, cfg) -> None:
    """(f): the modes of (a)-(d) in fp32 at the 1b width with ``EXACT``'s
    depth, where every greedy token must equal serial ``generate``'s (on the
    tenant's merged model) but at a tie, a top-2 margin under ``TIE_MARGIN``;
    then a planted fault, a tenant served with its ``b`` doubled, which the
    same check must catch."""
    import copy
    import dataclasses

    import numpy as np

    from dmlcloud_tpu_torch.models import lora
    from dmlcloud_tpu_torch.models.generate import generate
    from dmlcloud_tpu_torch.models.transformer import DecoderLM
    from dmlcloud_tpu_torch.serve import AdapterSet, ServeEngine

    ex, k = EXACT, EXACT["k"]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, num_layers=ex["layers"])
    model = DecoderLM(cfg32, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    draft = DecoderLM(dataclasses.replace(cfg32, num_layers=1), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(1))
    rs = np.random.RandomState(24)
    prefix = rs.randint(0, cfg.vocab_size, ex["prefix"])
    prompts = [np.concatenate([prefix, rs.randint(0, cfg.vocab_size, int(rs.randint(ex["suffix"][0],
                                                                                      ex["suffix"][1] + 1)))])
               for _ in range(ex["requests"])]
    g = torch.Generator(device="cuda").manual_seed(6)

    def scaled_b(node, scale, fresh):
        if isinstance(node, dict):
            return {key: scaled_b(v, scale, fresh) for key, v in node.items()}
        if node is None:
            return None
        return node.replace(b=scale * (torch.randn(node.b.shape, device="cuda", generator=g) if fresh else node.b))

    trees = {f"t{i}": scaled_b(lora.lora_init(g, model, rank=ex["rank"], in_axes=1), ex["b_scale"], True)
             for i in range(2)}
    aset = AdapterSet(trees, alpha=16.0, base=model)
    refs = {None: model}
    for name, tree in trees.items():
        refs[name] = copy.deepcopy(model)
        refs[name].load_state_dict(lora.lora_merge(model, tree, alpha=16.0), strict=False)
    want = {name: [generate(ref, p[None], ex["new"])[0].tolist() for p in prompts] for name, ref in refs.items()}
    if all(want["t0"][i] == want[None][i] for i in range(len(prompts))):
        raise AssertionError("(f) tenant t0 decodes the base model's tokens: the adapter does not bite")

    def partings(outs, reqs):
        """(request, step, serial top-2 margin) of every output that parts from serial generate's."""
        found = []
        for r, (out, (i, name)) in enumerate(zip(outs, reqs)):
            w = want[name][i]
            if len(out) != len(w):
                raise AssertionError(f"(f) request {r} ended with {len(out)} of {len(w)} tokens")
            j = next((t for t, (a, b) in enumerate(zip(out, w)) if a != b), None)
            if j is not None:
                found.append((r, j, _margin(torch, refs[name], prompts[i], w[:j])))
        return found

    def serve(kw, names):
        """Serve every prompt under every tenant of ``names`` (after the prefix alone under each, when the
        cache is on): the outputs, the requests, the prefill tokens saved and the accept rate."""
        engine = ServeEngine(model, num_blocks=128, **EXACT_ENGINE, **kw)
        if engine.prefix is not None:
            for name in names:
                engine.submit(prefix, 2, adapter=name)
            engine.run()
        reqs = [(i, name) for name in names for i in range(len(prompts))]
        rids = [engine.submit(prompts[i], ex["new"], adapter=name) for i, name in reqs]
        engine.run()
        engine.pool.assert_consistent()
        pools = [engine.pool] + ([engine.draft_pool] if engine.draft_pool is not None else [])
        locks = engine.prefix.leaked_locks() if engine.prefix is not None else []
        if engine.leaked_blocks() or locks or any(p.num_free + p.num_live != p.num_blocks for p in pools) or (
                engine.draft_pool is not None and engine.draft_pool.num_free != engine.draft_pool.num_blocks):
            raise AssertionError(f"(f) {kw}: {engine.leaked_blocks()} leaked blocks, locks {locks}")
        saved = sum(engine.ledger.records[r].get("saved_tokens", 0) for r in rids)
        return [list(engine.output(r)) for r in rids], reqs, saved, engine.ledger.summary()["accept_rate"]

    base, tenants = [None], ["t0", "t1", None]
    modes = [("prefix cache", dict(prefix_cache=True), base),
             ("spec self-draft + prefix cache", dict(spec_k=k, prefix_cache=True), base),
             ("spec 1-layer draft", dict(spec_k=k, draft_model=draft), base),
             ("medusa + prefix cache", dict(medusa_k=k, prefix_cache=True), base),
             ("2 tenants and the base + prefix cache", dict(adapters=aset, prefix_cache=True), tenants),
             ("spec self-draft x 2 tenants and the base", dict(spec_k=k, adapters=aset), tenants)]
    rows = []
    for what, kw, names in modes:
        outs, reqs, saved, accept = serve(kw, names)
        ties = partings(outs, reqs)
        for r, j, margin in ties:
            if not margin < TIE_MARGIN:
                raise AssertionError(f"(f) {what}: request {r} parts from serial generate at step {j}, where the "
                                     f"serial top-2 margin is {margin:.3g} (not a tie)")
        if kw.get("prefix_cache") and saved != len(reqs) * ex["prefix"]:
            raise AssertionError(f"(f) {what}: {saved} prefill tokens saved, want {len(reqs) * ex['prefix']}")
        rows.append(f"{what}: {len(reqs)} requests " + ("equal to serial generate" if not ties else
                                                         f"equal to serial generate but at ties {ties}")
                    + (f", {saved} prefill tokens saved" if kw.get("prefix_cache") else "")
                    + (f", accept rate {accept}" if accept is not None else ""))
    # the planted fault: t0 served with its b doubled, held against t0's merged model
    bad = AdapterSet({"t0": scaled_b(trees["t0"], 2.0, False), "t1": trees["t1"]}, alpha=16.0, base=model)
    outs, reqs, _, _ = serve(dict(adapters=bad), ["t0"])
    caught = [(r, j, round(m, 4)) for r, j, m in partings(outs, reqs) if not m < TIE_MARGIN]
    if not caught:
        raise AssertionError("(f) a tenant served with its b doubled passed the exactness check")
    log(f"[serve19] (f) fp32 1b width at {ex['layers']} layers, {ex['requests']} prompts on one {ex['prefix']}-token "
        f"prefix (+{ex['suffix'][0]}-{ex['suffix'][1]}), {ex['new']} new, k={k}, rank-{ex['rank']} tenants (b at "
        f"{ex['b_scale']}), {EXACT_ENGINE}, ties under a top-2 margin of {TIE_MARGIN}: " + "; ".join(rows)
        + f"; 0 leaked blocks and locks [{smi}]")
    log(f"[serve19] (f) planted fault, t0 with its b doubled: caught, parting from t0's merged model at (request, "
        f"step, serial top-2 margin) {caught} [{smi}]")
    del model, draft, refs
    _free(torch)


def phase_serve_modes(torch, smi: str):
    """Phase 19; returns its bf16 1b model and config, which phase 20 serves
    from."""
    from dmlcloud_tpu_torch.examples.train_lm import PRESETS
    from dmlcloud_tpu_torch.models.transformer import DecoderLM, TransformerConfig

    cfg = TransformerConfig(vocab_size=32000, max_seq_len=2048, **PRESETS["1b"])
    model = DecoderLM(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    for name, phase in (("(a)", phase_prefix), ("(b)(c)", phase_rounds), ("(d)", phase_tenants), ("(e)", phase_drill)):
        t0 = time.perf_counter()
        phase(torch, smi, model, cfg)
        log(f"[serve19] {name} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_exact(torch, smi, cfg)
    log(f"[serve19] (f) in {time.perf_counter() - t0:.1f} s")
    return model, cfg


# ---------------------------------------------------------------------------
# phase 20: the Router, three engine replicas of one model on one card
# ---------------------------------------------------------------------------

#: the drill of BENCH_serve_router_pr15.json ``router.config`` at the 1b's sizes: replicas, the hot tenant's
#: requests and mean interarrival, the cold tenant's requests, start and spacing, prompt lengths, new tokens,
#: the trace's seed, the replica killed once that many requests are terminal, the one drained, the router's knobs
ROUTER = dict(replicas=3, hot=12, hot_mean_interarrival_s=0.01, cold=6, cold_start_s=0.05, cold_spacing_s=0.15,
              prompts=(128, 256, 512), new=(64, 128), seed=3, kill_after=5, kill="r2", drain_after=10, drain="r1",
              knobs=dict(heartbeat_timeout_s=5.0, max_retries=3, backoff_base_s=0.01))
#: (b): the depth of the fp32 run held to serial generate
ROUTER_EXACT_LAYERS = 2


def _router_trace(vocab: int) -> list:
    """The two-tenant trace of bench.py ``_serve_router_trace``: hot requests at
    exponential interarrivals, cold ones at a fixed spacing, sorted by
    arrival: ``(offset_s, prompt, new, {"tenant": ...})``."""
    import numpy as np

    r = ROUTER
    rs = np.random.RandomState(r["seed"])

    def prompt(i):
        return rs.randint(0, vocab, size=r["prompts"][i % len(r["prompts"])]).astype(np.int32)

    offsets = np.cumsum(rs.exponential(r["hot_mean_interarrival_s"], r["hot"]))
    trace = [(float(offsets[i]), prompt(i), r["new"][i % len(r["new"])], {"tenant": "hot"}) for i in range(r["hot"])]
    trace += [(r["cold_start_s"] + j * r["cold_spacing_s"], prompt(j), r["new"][j % len(r["new"])],
               {"tenant": "cold"}) for j in range(r["cold"])]
    return sorted(trace, key=lambda e: e[0])


def _router_drill(torch, model, trace, run_dir: str) -> dict:
    """Serve ``trace`` in real time through a ``Router`` over ``ROUTER``'s
    replicas of ``model`` (each its own pool, all on the router's clock), the
    planted kill and drain fired by terminal counts as bench.py's controller
    fires them, under a span journal. A replica failure that was not planted
    ends the run here, its exception printed: on one card a CUDA error is
    sticky, and the router's catch must not hide it."""
    import tempfile
    import traceback

    from dmlcloud_tpu_torch.serve import TERMINAL_STATUSES, ChaosError, Router, ServeEngine
    from dmlcloud_tpu_torch.telemetry import journal

    r = ROUTER
    clock = time.perf_counter
    per_req = -(-(max(r["prompts"]) + max(r["new"])) // SERVE19["block_size"])
    engines = [ServeEngine(model, num_blocks=SERVE19["max_slots"] * per_req, metrics=True, clock=clock, **SERVE19)
               for _ in range(r["replicas"])]
    router = Router(engines, clock=clock, run_dir=run_dir, **r["knobs"])
    replica_ms: list[float] = []

    def guarded(name, step):
        def run():
            t0 = time.perf_counter()
            try:
                return step()
            except Exception as exc:
                if not isinstance(exc, ChaosError):
                    log(traceback.format_exc())
                    fail(f"phase 20: replica {name}'s step raised {type(exc).__name__}: {exc} (not planted)")
                raise
            finally:
                replica_ms[-1] += (time.perf_counter() - t0) * 1e3
        return run

    for name, rep in router.replicas.items():
        rep.engine.step = guarded(name, rep.engine.step)
    fired = {}

    def controller(point, seqs):
        done = sum(1 for st in router.statuses().values() if st in TERMINAL_STATUSES)
        if "kill" not in fired and done >= r["kill_after"]:
            fired["kill"] = done
            router.kill_replica(r["kill"], reason="drill")
        if "drain" not in fired and done >= r["drain_after"]:
            fired["drain"] = done
            router.drain_replica(r["drain"], reason="drill")

    router.fault_injector = controller
    steps: list[tuple[float, float]] = []
    step = router.step

    def timed_step():
        replica_ms.append(0.0)
        t0 = time.perf_counter()
        did = step()
        steps.append(((time.perf_counter() - t0) * 1e3, replica_ms[-1]))
        return did

    router.step = timed_step
    with tempfile.TemporaryDirectory() as tmp:
        j = journal.activate(journal.SpanJournal(tmp, ring_size=1 << 17))
        try:
            t0 = time.perf_counter()
            summary = router.serve_trace(trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            journal.deactivate()
        records = j.tail(1 << 17)
    return {"router": router, "summary": summary, "wall": wall, "steps": steps, "records": records,
            "fired": fired}


def _router_gates(res: dict, run_dir: str, failover: bool = True) -> dict:
    """Every request ``ok``, at least one failover (with ``failover``; the
    planted kill's only, always), 0 leaked blocks on every replica, the
    drain's verdict clean, no orphan span, one metrics page with every
    replica's series."""
    from dmlcloud_tpu_torch.checkpoint import read_requeue_verdict
    from dmlcloud_tpu_torch.telemetry.journal import linked_trace_report
    from dmlcloud_tpu_torch.telemetry.metrics_registry import parse_prometheus_text

    router, r = res["router"], ROUTER
    statuses = router.statuses()
    if set(statuses.values()) != {"ok"}:
        raise AssertionError(f"router statuses {statuses}")
    if set(res["fired"]) != {"kill", "drain"} or router.kills != 1 or router.failovers < int(failover):
        raise AssertionError(f"planted {res['fired']}, kills {router.kills}, failovers {router.failovers}")
    reasons = {rec.get("reason") for rec in res["records"] if rec["kind"] == "failover"}
    if not all(str(why).startswith("killed: ") for why in reasons):
        raise AssertionError(f"a replica failed that was not planted: failover reasons {reasons}")
    leaked = {name: rep.engine.leaked_blocks() for name, rep in router.replicas.items()}
    if any(leaked.values()):
        raise AssertionError(f"leaked blocks per replica {leaked}")
    verdict = read_requeue_verdict(run_dir)
    if not verdict or verdict["serve"]["replica"] != r["drain"] or verdict["serve"]["drained_clean"] is not True:
        raise AssertionError(f"drain verdict {verdict}")
    report = linked_trace_report(res["records"])
    if report["orphans"] or set(report["traces"]) != {f"tr-{rid}" for rid in statuses}:
        raise AssertionError(f"trace report: {len(report['orphans'])} orphans, traces {sorted(report['traces'])}")
    text = router.metrics_text()
    fams = parse_prometheus_text(text)
    series = [f'replica="r{i}"' for i in range(r["replicas"])]
    if "dml_router_failovers_total" not in fams or not all(s in text for s in series):
        raise AssertionError(f"metrics page: {sorted(fams)}")
    return {"verdict": verdict["serve"], "families": len(fams), "kinds": sorted({rec["kind"] for rec in
                                                                                   res["records"]})}


def phase_router(torch, fa, smi: str, model, cfg) -> None:
    """Phase 20: (a) the bf16 1b through the Router drill against a
    fault-free single engine under phase 19's tie rule; (b) the fp32 1b
    width at ``ROUTER_EXACT_LAYERS`` layers through the same drill against
    serial ``generate``."""
    import dataclasses

    import numpy as np

    from dmlcloud_tpu_torch.models.generate import generate
    from dmlcloud_tpu_torch.models.transformer import DecoderLM
    from dmlcloud_tpu_torch.serve import ServeEngine

    r = ROUTER
    trace = _router_trace(cfg.vocab_size)
    prompts = [p for _, p, _, _ in trace]
    news = [n for _, _, n, _ in trace]
    t0 = time.perf_counter()
    # the fault-free arm: one engine serving every request (greedy tokens do not depend on the batch's makeup
    # but at bf16 ties)
    per_req = -(-(max(r["prompts"]) + max(r["new"])) // SERVE19["block_size"])
    ref = ServeEngine(model, num_blocks=SERVE19["max_slots"] * per_req, **SERVE19)
    ref_rids = [ref.submit(p, n) for p, n in zip(prompts, news)]
    ref.run()
    want = [ref.output(rid).tolist() for rid in ref_rids]
    del ref
    _free(torch)
    ref_s = time.perf_counter() - t0

    run_dir = tempfile.mkdtemp()
    try:
        fa.reset_launch_counts()  # the serving path's run starts here ...
        res = _router_drill(torch, model, trace, run_dir)
        launches = dict(fa.LAUNCHES)  # ... and ends here
        gates = _router_gates(res, run_dir)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    router = res["router"]
    got = [router.output(rid).tolist() for rid in range(len(trace))]
    agree, partings, gaps = _agreement(torch, model, prompts, got, want)
    if any(launches.values()):
        raise AssertionError(f"the serving path launched flash kernels: {launches}")

    def pct(xs, q):
        return f"{np.percentile(xs, q):.3f}" if xs else "n/a"

    recs = router._records.values()
    failed_over = [rec.rid for rec in recs if rec.retries > 0]
    ttft = {rec.rid: router.replicas[rec.replica].engine.ledger.records[rec.engine_rid]["first_token"] - rec.arrival
            for rec in recs}
    hot, cold = router.ttfts(tenant="hot"), router.ttfts(tenant="cold")
    fo = [ttft[rid] for rid in failed_over]
    tokens = sum(len(t) for t in got)
    host = [a for a, _ in res["steps"]]
    reps = [b for _, b in res["steps"]]
    own = [a - b for a, b in res["steps"]]
    log(f"[router] (a) 1b bf16, {r['replicas']} replicas x {SERVE19}, {r['hot']} hot + {r['cold']} cold requests "
        f"(prompts {r['prompts']}, new {r['new']}), {r['kill']} killed at {res['fired']['kill']} terminal, "
        f"{r['drain']} drained at {res['fired']['drain']}, {r['knobs']}: {res['wall']:.2f} s wall, "
        f"{len(res['steps'])} router steps; all {len(got)} ok, {router.failovers} failovers ({len(failed_over)} "
        f"requests), 0 leaked blocks, drain verdict {gates['verdict']}, 0 orphan spans, metrics page of "
        f"{gates['families']} families with r0-r2 series; K1-K3 launches {launches} [{smi}]")
    log(f"[router] (a) TTFT s: hot p50 {pct(hot, 50)} p99 {pct(hot, 99)}, cold p50 {pct(cold, 50)} p99 "
        f"{pct(cold, 99)}, failed-over p99 {pct(fo, 99)} (router clock, backoff and re-prefill included); "
        f"{tokens / res['wall']:.1f} decode tokens/s over the drill [{smi}]")
    log(f"[router] (a) router step host ms: median {statistics.median(host):.2f} (max {max(host):.1f}, total "
        f"{sum(host):.0f}) beside its replicas' step ms median {statistics.median(reps):.2f} (total {sum(reps):.0f}); "
        f"the router's own ms per step: median {statistics.median(own):.3f}, total {sum(own):.1f} [{smi}]")
    log(f"[router] (a) greedy agreement with a fault-free single engine ({ref_s:.1f} s) {agree:.4f}; partings "
        f"(row, step, top-2 gap): {partings or 'none'}; {gaps}; span kinds {gates['kinds']} [{smi}]")

    # (b): fp32 at the 1b width, held to serial generate
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, num_layers=ROUTER_EXACT_LAYERS)
    model32 = DecoderLM(cfg32, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    run_dir = tempfile.mkdtemp()
    try:
        res32 = _router_drill(torch, model32, trace, run_dir)
        _router_gates(res32, run_dir, failover=False)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    router32 = res32["router"]
    ties = []
    for rid, (p, n) in enumerate(zip(prompts, news)):
        out = router32.output(rid).tolist()
        serial = generate(model32, p[None], n)[0].tolist()
        j = next((i for i, (a, b) in enumerate(zip(out, serial)) if a != b), None)
        if len(out) != n or (j is not None and not _margin(torch, model32, p, serial[:j]) < TIE_MARGIN):
            raise AssertionError(f"(b) request {rid} parts from serial generate at step {j} (not a tie)")
        if j is not None:
            ties.append((rid, j))
    log(f"[router] (b) fp32 1b width at {ROUTER_EXACT_LAYERS} layers, the same drill ({res32['wall']:.2f} s, "
        f"{router32.failovers} failovers, kill at {res32['fired']['kill']}, drain at {res32['fired']['drain']}): "
        + (f"all {len(trace)} requests token-identical to serial generate" if not ties else
           f"equal to serial generate but at ties under {TIE_MARGIN} {ties}")
        + f", 0 leaked blocks, verdict clean, 0 orphans; (b) in {time.perf_counter() - t0:.1f} s [{smi}]")
    del model32, router32, res32
    _free(torch)


# ---------------------------------------------------------------------------
# phase 21: the HF import on the card
# ---------------------------------------------------------------------------

#: a HF LlamaConfig's attributes at the 1b preset's geometry (examples/train_lm.py:28)
HF_1B = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632, num_hidden_layers=24, num_attention_heads=16,
             num_key_value_heads=8, head_dim=128, max_position_embeddings=2048, rope_theta=10000.0,
             tie_word_embeddings=False, rope_scaling=None)
HF_LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
             "original_max_position_embeddings": 512}
#: the logits check's and the finetune's depth; the logits' tokens; the finetune's rows (K1-K3 at the 1b's
#: attention shape) and its corpus (about 36 byte-chain documents per 2048-token row)
HF_CHECK = dict(layers=2, tokens=(2, 256), seq_len=2048, batch=4, n_docs=800)


def _hf_state_dict(layers: int, seed: int = 0) -> dict:
    """A HF-named Llama state dict at ``HF_1B``'s geometry with ``layers``
    blocks, float32 from a seeded generator (std 0.02, norms near 1)."""
    import numpy as np

    c = HF_1B
    d, hd, m, v = c["hidden_size"], c["head_dim"], c["intermediate_size"], c["vocab_size"]
    q, kv = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd
    shapes = {"model.embed_tokens.weight": (v, d), "model.norm.weight": (d,), "lm_head.weight": (v, d)}
    for i in range(layers):
        p = f"model.layers.{i}."
        shapes.update({p + "input_layernorm.weight": (d,), p + "post_attention_layernorm.weight": (d,),
                       p + "self_attn.q_proj.weight": (q, d), p + "self_attn.k_proj.weight": (kv, d),
                       p + "self_attn.v_proj.weight": (kv, d), p + "self_attn.o_proj.weight": (d, q),
                       p + "mlp.gate_proj.weight": (m, d), p + "mlp.up_proj.weight": (m, d),
                       p + "mlp.down_proj.weight": (d, m)})
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in shapes.items():
        x = rng.standard_normal(shape, dtype=np.float32)
        if key.endswith("norm.weight"):
            x *= 0.1
            x += 1.0
        else:
            x *= 0.02
        sd[key] = x
    return sd


def phase_hf(torch, fa, smi: str) -> None:
    """Phase 21: (a) the 1b-geometry HF state dict through
    ``transformer_config_from_hf`` -> ``llama_params_from_hf`` ->
    ``load_flax_params`` into a ``DecoderLM`` on the card -> ``to_flax_params``
    -> ``hf_state_dict_from_params``, bitwise; (b) at ``HF_CHECK``'s depth,
    plain and with llama3 rope scaling, the card's fp32 logits against the
    CPU's within ``TOL``/``REL_TOL`` fp32, and the round trip there; (c)
    ``examples.finetune_hf``'s stage at that width and depth in bf16 with
    ``attn_impl="flash"``: K1-K3 launches, step ms, losses."""
    import types

    import numpy as np

    from dmlcloud_tpu_torch.examples import finetune_hf
    from dmlcloud_tpu_torch.models import hf
    from dmlcloud_tpu_torch.models.transformer import DecoderLM, load_flax_params, to_flax_params

    def round_trip(ns, sd, device, dtype):
        cfg = hf.transformer_config_from_hf(ns, dtype=dtype)
        t0 = time.perf_counter()
        model = load_flax_params(DecoderLM(cfg, device=device), hf.llama_params_from_hf(sd, cfg))
        t_in = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = hf.hf_state_dict_from_params(to_flax_params(model), cfg)
        t_out = time.perf_counter() - t0
        bad = [k for k in sd if k not in back or back[k].dtype != sd[k].dtype or not np.array_equal(back[k], sd[k])]
        if bad or sorted(back) != sorted(sd):
            raise AssertionError(f"round trip not bitwise: {bad[:4]}")
        return model, cfg, t_in, t_out

    # (a) the full depth
    t0 = time.perf_counter()
    sd = _hf_state_dict(HF_1B["num_hidden_layers"])
    gen_s = time.perf_counter() - t0
    ns = types.SimpleNamespace(**HF_1B)
    model, cfg, t_in, t_out = round_trip(ns, sd, "cuda", torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[hf] (a) HF-named state dict at the 1b geometry ({len(sd)} tensors, {n_params / 1e9:.3f} B parameters, "
        f"made in {gen_s:.1f} s) -> transformer_config_from_hf -> llama_params_from_hf -> load_flax_params on the "
        f"card ({t_in:.1f} s) -> to_flax_params -> hf_state_dict_from_params ({t_out:.1f} s): bitwise equal [{smi}]")
    del model, sd
    _free(torch)

    # (b) logits, card against CPU, plain and llama3, at HF_CHECK's depth
    hc = HF_CHECK
    sd = _hf_state_dict(hc["layers"], seed=1)
    tokens = torch.from_numpy(np.random.RandomState(21).randint(0, HF_1B["vocab_size"], hc["tokens"]))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    try:
        for name, scaling in (("plain", None), ("llama3", HF_LLAMA3)):
            ns = types.SimpleNamespace(**dict(HF_1B, num_hidden_layers=hc["layers"], rope_scaling=scaling))
            card, cfg, _, _ = round_trip(ns, sd, "cuda", torch.float32)
            host, _, _, _ = round_trip(ns, sd, "cpu", torch.float32)
            with torch.no_grad():
                got = card(tokens.cuda()).float().cpu()
                want = host(tokens).float()
            err, rel = assert_close(torch, got, want, "float32", f"(b) {name} logits, card vs CPU")
            rows.append(f"{name} (rope_scaling {cfg.rope_scaling}): max abs err {err:.3g}, norm-relative {rel:.3g}")
            del card, host
            _free(torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"[hf] (b) {hc['layers']} layers at the 1b width, fp32 logits of {list(hc['tokens'])} tokens on the card "
        f"against the CPU within {TOL['float32']} / {REL_TOL['float32']} in norm, round trip bitwise: "
        + "; ".join(rows) + f" [{smi}]")

    # (c) the finetune stage, bf16 with the flash kernels
    ns = types.SimpleNamespace(**dict(HF_1B, num_hidden_layers=hc["layers"]))
    argv = ["--epochs", "1", "--seq-len", str(hc["seq_len"]), "--batch-size", str(hc["batch"]), "--n-docs",
            str(hc["n_docs"]), "--sample", "0"]
    fa.reset_launch_counts()  # the finetune's run starts here ...
    t0 = time.perf_counter()
    stage = finetune_hf.main(argv, hf_config=ns, state_dict=sd, dtype=torch.bfloat16, attn_impl="flash")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)  # ... and ends here
    losses = [float(x) for x in stage.train_losses]
    steps = len(losses)
    per = hc["layers"] * steps
    want = {"flash_fwd_tc": per, "flash_bwd_dq_tc": per, "flash_bwd_dkv_tc": per, "flash_fwd": 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if steps < 3 or launches != want or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"finetune: {steps} steps, losses {losses}, launches {launches} (want {want})")
    step_ms = float(stage.tracker["misc/train_step_avg_ms"][-1])
    log(f"[hf] (c) finetune_hf's stage on the imported model ({hc['layers']} layers at the 1b width, bf16, "
        f"attn_impl flash, {hc['batch']} x {hc['seq_len']} packed rows of {hc['n_docs']} byte-chain documents): "
        f"{steps} steps in {wall:.1f} s wall, step avg {step_ms:.1f} ms (first step included), losses {losses}; "
        f"K1-K3 launches {launches} ({hc['layers']} per step each) [{smi}]")
    del stage
    _free(torch)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not importable")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs one CUDA card")
    try:
        from dmlcloud_tpu_torch.ops import flash_attention as fa
    except ImportError as exc:
        fail(f"dmlcloud_tpu_torch is not importable ({exc}); run from the repository root")

    t0 = time.perf_counter()
    dev = phase_device(torch)
    phase_build(fa)
    rows = phase_kernels(torch, fa)
    phase_mesh_shapes(torch, fa)
    phase_model(torch, fa)
    launches, stage = phase_train(torch, fa)
    for row in rows.values():
        row["launches"] = launches[row["name"]]
    losses, val = _losses(stage)
    p5 = {"losses": losses, "val": val, "steady_ms": phase_steady(torch, stage), "launches": launches}
    del stage
    _free(torch)
    phase_resume(torch, fa, dev["smi"])
    phase_stage(torch, fa, dev["smi"], p5)
    phase_mnist(torch, dev["smi"])
    phase_nccl(torch, dev["smi"])
    phase_mesh(torch, fa, dev["smi"], p5)
    t12 = time.perf_counter()
    phase_hops(torch, fa, dev["smi"])
    phase_ring(torch, fa, dev["smi"], p5)
    phase_pipe(torch, fa, dev["smi"])
    log(f"[seq] phase 12 in {time.perf_counter() - t12:.1f} s")
    t13 = time.perf_counter()
    phase_paged(torch, dev["smi"])
    phase_sample(torch, fa, dev["smi"], p5)
    phase_engine(torch, dev["smi"])
    phase_serve(torch, dev["smi"])
    log(f"[serve] phase 13 in {time.perf_counter() - t13:.1f} s")
    t14 = time.perf_counter()
    bert_rows = phase_bert_kernels(torch, fa)
    bert = phase_bert(torch, fa, dev["smi"])
    for row in bert_rows.values():
        row["launches"] = bert["launches"][row["name"]]
    phase_resnet50(torch, dev["smi"])
    phase_resnet18(torch, dev["smi"])
    phase_clip(torch, dev["smi"])
    log(f"[vision] phase 14 in {time.perf_counter() - t14:.1f} s")
    t15 = time.perf_counter()
    phase_data(torch, fa, dev["smi"], p5)
    log(f"[data] phase 15 in {time.perf_counter() - t15:.1f} s")
    t16 = time.perf_counter()
    phase_compiled(torch, fa, dev["smi"], p5)
    log(f"[compiled] phase 16 in {time.perf_counter() - t16:.1f} s")
    t17 = time.perf_counter()
    phase_quant_lora(torch, fa, dev["smi"], p5)
    log(f"[int8] phase 17 in {time.perf_counter() - t17:.1f} s")
    t18 = time.perf_counter()
    moe = phase_moe(torch, fa, dev["smi"])
    log(f"[moe] phase 18 in {time.perf_counter() - t18:.1f} s; K1-K3 launches per 1b-moe step {moe['per_step']}")
    t19 = time.perf_counter()
    model, cfg = phase_serve_modes(torch, dev["smi"])
    log(f"[serve19] phase 19 in {time.perf_counter() - t19:.1f} s")
    t20 = time.perf_counter()
    phase_router(torch, fa, dev["smi"], model, cfg)
    del model
    _free(torch)
    log(f"[router] phase 20 in {time.perf_counter() - t20:.1f} s")
    t21 = time.perf_counter()
    phase_hf(torch, fa, dev["smi"])
    log(f"[hf] phase 21 in {time.perf_counter() - t21:.1f} s")
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(rows.values()) + list(bert_rows.values())}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
