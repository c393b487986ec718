"""Llama-3-8B geometry pretraining with FSDP: the port of
``examples/pod_llama_fsdp.py``.

The reference's recipe runs on a v5p-64 slice (``--mesh data=2,fsdp=32
--global-batch 128 --seq-len 4096 --remat --chunked-loss 8192``). On GPUs it is
one process per card, launched by ``torch.distributed.run``; on four H100s of
one host:

    python -m torch.distributed.run --nproc_per_node=4 -m dmlcloud_tpu_torch.examples.pod_llama_fsdp \\
        --mesh fsdp=4 --global-batch 8 --seq-len 4096 --steps-per-epoch 6 --remat --chunked-loss 8192

- **The mesh.** The model registers with ``llama_partition_rules()``:
  without a ``model`` axis every kernel is sharded over ``fsdp`` (FSDP2;
  with ``data`` as well, HSDP). In fp32 with fp32 gradients and AdamW
  moments the 8b model is 8.03 B x 16 B = 128.5 GB: it needs ``fsdp`` >= 2
  on 80 GB cards, and ``fsdp=4`` leaves ~32 GB of state per card.
- **The batch.** ``--global-batch`` sequences per step over all processes:
  each data-parallel coordinate (``parallel.mesh.data_parallel_rank``) feeds
  its contiguous slice of each global batch, tensor-parallel peers the same
  slice. The global batches are one seeded Markov stream (``markov_tokens``,
  seed 0, one successor table), so a run's data does not depend on its mesh;
  at one process it is the reference's single-host data. (The reference
  seeds per process, which on GPUs would give tensor-parallel peers
  different batches.)
- **``--remat``** recomputes each block in the backward; **``--chunked-loss
  N``** streams the 128k-vocab logits in chunks of N (``chunked_lm_loss``);
  **``--grad-accum N``** splits each global batch into N microbatches.
- The optimizer is the reference's: warmup-cosine AdamW (b2 0.95, weight
  decay 0.1; warmup 2 % of the steps), a global-norm clip at 1.0;
  ``misc/mfu`` from ``6 * (params - embedding) * tokens`` per step.

``--toy`` (any machine; ``--device cpu`` on a CPU): the same path on a tiny
decoder, e.g. over four gloo processes ``python -m torch.distributed.run
--nproc_per_node=4 -m dmlcloud_tpu_torch.examples.pod_llama_fsdp --toy --mesh
data=2,fsdp=2 --device cpu``. ``main(argv)`` returns the stage; ``build(argv)``
the unrun pipeline and stage, and ``build(argv, precompile=True)`` (also
``compile_cache=``, ``buckets=``) the pipeline whose step is compiled on the
mesh: each block a ``fullgraph`` region, FSDP2's all-gather and reshard
between them.
"""

from __future__ import annotations

import argparse

import dmlcloud_tpu_torch as dml
from dmlcloud_tpu_torch.data import markov_tokens
from dmlcloud_tpu_torch.models.transformer import (DecoderLM, TransformerConfig, chunked_lm_loss, lm_head_kernel,
                                                   llama_partition_rules, lm_loss)
from dmlcloud_tpu_torch.optim import adamw, warmup_cosine_decay_schedule
from dmlcloud_tpu_torch.parallel import init_auto
from dmlcloud_tpu_torch.parallel.mesh import data_parallel_rank, data_parallel_size, parse_mesh_axes

PRESETS = {
    # Llama-3-8B geometry
    "8b": dict(num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
               hidden_dim=4096, mlp_dim=14336, vocab_size=128256),
    "toy": dict(num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                hidden_dim=64, mlp_dim=160, vocab_size=512),
}


def rank_batches(vocab: int, global_batch: int, steps: int, seq_len: int, dp_size: int, dp_rank: int) -> list:
    """This data-parallel coordinate's rows of each of ``steps`` global
    batches of one seeded Markov stream."""
    if global_batch % dp_size:
        raise ValueError(f"--global-batch {global_batch} must divide evenly over {dp_size} data-parallel ranks")
    per = global_batch // dp_size
    toks = markov_tokens(vocab, global_batch * steps, seq_len, seed=0, table_seed=0)
    return [toks[i * global_batch + dp_rank * per:i * global_batch + (dp_rank + 1) * per] for i in range(steps)]


class LlamaStage(dml.TrainValStage):
    def pre_stage(self):
        cfg = self.config
        preset = dict(PRESETS[cfg.preset])
        if cfg.get("layers"):
            preset["num_layers"] = int(cfg.layers)
        model_cfg = TransformerConfig(max_seq_len=cfg.seq_len, attn_impl=cfg.attn, remat=bool(cfg.remat), **preset)
        self.model = DecoderLM(model_cfg, device=self.device)
        self.pipeline.register_model("llama", self.model, sharding=llama_partition_rules())
        schedule = warmup_cosine_decay_schedule(0.0, cfg.lr, cfg.warmup_steps, cfg.decay_steps)
        self.pipeline.register_optimizer("adamw", adamw(schedule, b2=0.95, weight_decay=0.1), scheduler=schedule)
        mesh = self.pipeline.mesh
        dp, dp_rank = (data_parallel_size(mesh), data_parallel_rank(mesh)) if mesh is not None else (1, 0)
        self.pipeline.register_dataset(
            "train", rank_batches(model_cfg.vocab_size, cfg.global_batch, cfg.steps_per_epoch, cfg.seq_len, dp,
                                  dp_rank), verbose=False)

    def gradient_clip(self):
        return 1.0

    def checkpoint_every_steps(self):
        return int(self.config.get("save_every_steps", 0))

    def gradient_accumulation(self):
        return int(self.config.get("grad_accum", 1))

    def step_flops(self):
        # 6 * params * tokens, embedding lookups excluded (the reference's
        # accounting); a DTensor's numel is its global size
        model = self.state.model
        n = sum(p.numel() for p in model.parameters()) - model.embed.weight.numel()
        return 6.0 * n * self.config.global_batch * self.config.seq_len

    def step(self, state, batch):
        chunk = int(self.config.get("chunked_loss", 0))
        if chunk > 0:
            hidden = state.model(batch, return_hidden=True)
            kernel, tp = lm_head_kernel(state.model)
            return chunked_lm_loss(hidden, kernel, batch, vocab_chunk=chunk, tp=tp)
        return lm_loss(state.model(batch), batch)

    def val_epoch(self):  # pretrain recipe: train metrics only
        pass


def build(argv: list[str] | None = None, **compile_kwargs) -> tuple[dml.TrainingPipeline, LlamaStage]:
    """The pipeline and stage that ``argv`` describes, not yet run;
    ``compile_kwargs`` (``compile_cache``, ``precompile``, ``buckets``) are
    passed to ``TrainingPipeline``: ``precompile=True`` compiles the step on
    the mesh (its blocks, with FSDP2's hooks between them)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="8b")
    ap.add_argument("--toy", action="store_true", help="tiny model + tiny batch (sets --preset toy)")
    ap.add_argument("--mesh", type=str, default="fsdp=-1",
                    help="the reference's v5p-64 recipe is data=2,fsdp=32; e.g. fsdp=4 on four cards")
    ap.add_argument("--global-batch", type=int, default=128)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--steps-per-epoch", type=int, default=200,
                    help="synthetic-data epoch length (a real run sizes this from the dataset)")
    ap.add_argument("--layers", type=int, default=None, help="cut the preset's depth (its widths stay)")
    ap.add_argument("--attn", choices=["dot", "flash"], default="flash")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--chunked-loss", type=int, default=0, metavar="CHUNK")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--checkpoint-dir", type=str, default=None)
    ap.add_argument("--save-every-steps", type=int, default=250)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)

    if args.toy:
        args.preset = "toy"
        args.global_batch = min(args.global_batch, 16)
        args.seq_len = min(args.seq_len, 64)
        args.steps_per_epoch = min(args.steps_per_epoch, 4)
        args.epochs = min(args.epochs, 2)
        args.attn = "dot"

    init_auto(args.device, verbose=True)
    steps_total = args.epochs * args.steps_per_epoch
    config = {
        "preset": args.preset,
        "layers": args.layers,
        "global_batch": args.global_batch,
        "seq_len": args.seq_len,
        "steps_per_epoch": args.steps_per_epoch,
        "attn": args.attn,
        "lr": args.lr,
        "warmup_steps": max(steps_total // 50, 1),
        "decay_steps": steps_total,
        "remat": args.remat,
        "chunked_loss": args.chunked_loss,
        "grad_accum": args.grad_accum,
        "save_every_steps": args.save_every_steps,
        "seed": 0,
    }
    pipeline = dml.TrainingPipeline(config, name=f"llama-{args.preset}", device=args.device, **compile_kwargs)
    pipeline.set_mesh(parse_mesh_axes(args.mesh))
    if args.checkpoint_dir:
        pipeline.enable_checkpointing(args.checkpoint_dir, resume=args.resume)
        # a scheduler's eviction drains at the next step save, commits the
        # state and writes the requeue verdict
        pipeline.enable_preemption_handling(signals=None)
    stage = LlamaStage()
    pipeline.append_stage(stage, max_epochs=args.epochs)
    return pipeline, stage


def main(argv: list[str] | None = None) -> LlamaStage:
    pipeline, stage = build(argv)
    pipeline.run()
    return stage


if __name__ == "__main__":
    main()
