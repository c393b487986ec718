"""CLIP (ViT-L/16 image tower) contrastive pretraining: the port of
``examples/pod_clip_vit.py``.

The reference's recipe runs on a v5p-64 slice (``--mesh data=8,fsdp=8
--global-batch 4096 --epochs 32 --save-every-steps 500``). On GPUs it is one
process per card, launched by ``torch.distributed.run``; on four H100s of one
host, at the recipe's load of 64 pairs per card:

    python -m torch.distributed.run --nproc_per_node=4 -m dmlcloud_tpu_torch.examples.pod_clip_vit \\
        --mesh data=2,fsdp=2 --global-batch 256 --checkpoint-dir runs/clip --save-every-steps 500

- **The mesh.** ``--mesh`` (default: none, the model replicated on every
  process and the gradients averaged) takes ``data`` and ``fsdp``: the model
  registers with ``encoder_partition_rules()``, whose kernels go to FSDP2 over
  ``fsdp`` (HSDP with ``data``) block by block (``fsdp_blocks()``). The
  recipe's mesh has no ``model`` axis; the encoder family's tensor
  parallelism is not ported (ROADMAP Queue 1 item 11) and a ``model`` axis
  raises ``NotImplementedError``.
- **The batch.** ``--global-batch`` pairs per step over all processes: each
  data-parallel coordinate (``parallel.mesh.data_parallel_rank``) feeds its
  contiguous slice of each global batch of one seeded stream
  (``SyntheticPairs``, seed 0), so a run's data does not depend on its
  layout; at one process it is the reference's single-host data. (The
  reference seeds per process.)
- **The loss** contrasts the global batch, as the reference's one program
  over it does: ``clip_loss`` gathers both embedding sets over the
  data-parallel processes with a differentiable gather (``models.clip``). The
  ``accuracy`` metric is the in-batch retrieval accuracy against the global
  batch, ``logit_scale`` the clamped scale; there is no validation.
- The optimizer is the reference's: warmup-cosine AdamW (weight decay 0.2,
  warmup 2 % of the steps). ``--checkpoint-dir`` takes local paths (remote
  URLs are ROADMAP Queue 1 item 3) and, with ``--save-every-steps``, saves
  mid-epoch; a scheduler's eviction drains at the next step save.

``--toy`` (any machine; ``--device cpu`` on a CPU): the same path on a tiny
CLIP, e.g. ``python -m torch.distributed.run --nproc_per_node=2 -m
dmlcloud_tpu_torch.examples.pod_clip_vit --toy --mesh data=2 --device cpu``.
``main(argv)`` returns the stage; ``build(argv)`` the unrun pipeline and stage.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import dmlcloud_tpu_torch as dml
from dmlcloud_tpu_torch.models.clip import CLIP, CLIPConfig, CLIPTextConfig, clip_loss, gather_rows
from dmlcloud_tpu_torch.models.encoder import encoder_partition_rules
from dmlcloud_tpu_torch.models.vit import ViTConfig
from dmlcloud_tpu_torch.optim import adamw, warmup_cosine_decay_schedule
from dmlcloud_tpu_torch.parallel import init_auto, runtime
from dmlcloud_tpu_torch.parallel.mesh import data_parallel_rank, data_parallel_size, parse_mesh_axes

PRESETS = {
    # ViT-L/16 vision tower + the standard CLIP text tower; 24L/1024d vision
    "vit-l": dict(
        vision=dict(image_size=224, patch_size=16, hidden_dim=1024, num_layers=24, num_heads=16, mlp_dim=4096,
                    num_classes=0),
        text=dict(vocab_size=49408, max_seq_len=77, hidden_dim=768, num_layers=12, num_heads=12, mlp_dim=3072),
        embed_dim=768,
    ),
    "toy": dict(
        vision=dict(image_size=32, patch_size=8, hidden_dim=32, num_layers=2, num_heads=2, mlp_dim=64, num_classes=0,
                    dtype=torch.float32),
        text=dict(vocab_size=128, max_seq_len=16, hidden_dim=32, num_layers=2, num_heads=2, mlp_dim=64,
                  dtype=torch.float32),
        embed_dim=32,
    ),
}


def clip_config(preset: str) -> CLIPConfig:
    p = PRESETS[preset]
    return CLIPConfig(embed_dim=p["embed_dim"], vision=ViTConfig(**p["vision"]), text=CLIPTextConfig(**p["text"]))


class SyntheticPairs:
    """Correlated (image, text) pairs, made per step: image class k has mean
    brightness k/8 and caption tokens from a class-specific band, so the
    contrastive objective has signal and in-batch accuracy rises. Each step
    draws one global batch of ``global_batch`` pairs from one seeded stream,
    the reference's ``SyntheticPairs`` draws bit for bit, and yields the
    contiguous rows of data-parallel coordinate ``dp_rank`` of ``dp_size``.
    Re-iterable (each epoch yields the same batches) and lazy."""

    def __init__(self, cfg: CLIPConfig, global_batch: int, steps: int, seed: int = 0, dp_size: int = 1,
                 dp_rank: int = 0):
        if global_batch % dp_size:
            raise ValueError(f"--global-batch {global_batch} must divide evenly over {dp_size} data-parallel ranks")
        self.cfg, self.batch, self.steps, self.seed = cfg, global_batch, steps, seed
        per = global_batch // dp_size
        self.rows = slice(dp_rank * per, (dp_rank + 1) * per)

    def __len__(self):
        return self.steps

    def __iter__(self):
        cfg, rng = self.cfg, np.random.default_rng(self.seed)
        size = cfg.vision.image_size
        # bands span [0, vocab-1) so no caption token collides with the EOT id
        band = (cfg.text.vocab_size - 1) // 8
        for _ in range(self.steps):
            classes = rng.integers(0, 8, size=self.batch)
            imgs = rng.random((self.batch, size, size, 3), dtype=np.float32) * 0.3
            imgs += (classes / 8.0).astype(np.float32)[:, None, None, None]
            toks = rng.integers(0, band, size=(self.batch, cfg.text.max_seq_len))
            toks += (classes * band)[:, None]
            toks[:, -1] = cfg.text.vocab_size - 1  # EOT = the highest id in the row
            yield {"image": imgs[self.rows], "tokens": toks.astype(np.int32)[self.rows]}


class CLIPStage(dml.TrainValStage):
    def pre_stage(self):
        cfg = self.config
        model = CLIP(clip_config(cfg.preset), device=self.device)
        self.pipeline.register_model("clip", model, sharding=encoder_partition_rules())
        schedule = warmup_cosine_decay_schedule(0.0, cfg.lr, cfg.warmup_steps, cfg.decay_steps)
        self.pipeline.register_optimizer("adamw", adamw(schedule, weight_decay=0.2), scheduler=schedule)
        mesh = self.pipeline.mesh
        if mesh is not None:
            dp, dp_rank = data_parallel_size(mesh), data_parallel_rank(mesh)
        else:
            dp, dp_rank = runtime.world_size(), runtime.rank()
        self.pipeline.register_dataset(
            "train", SyntheticPairs(model.cfg, cfg.global_batch, cfg.steps_per_epoch, seed=0, dp_size=dp,
                                    dp_rank=dp_rank), verbose=False)
        #: the processes whose rows make the global batch (None: this one alone)
        self.group = model.loss_group

    def checkpoint_every_steps(self):
        return int(self.config.get("save_every_steps", 0))

    def step(self, state, batch):
        img, txt, scale = state.model(batch["image"], batch["tokens"])
        loss = clip_loss(img, txt, scale, self.group)
        # in-batch retrieval accuracy against the global batch: the live
        # signal the loss should move (the mean over the ranks is the global one)
        with torch.no_grad():
            offset, all_txt = 0, txt
            if self.group is not None:
                offset = torch.distributed.get_rank(self.group) * txt.shape[0]
                all_txt = gather_rows(txt, self.group)
            labels = torch.arange(img.shape[0], device=img.device) + offset
            acc = ((img @ all_txt.T * scale).argmax(-1) == labels).float().mean()
        return loss, {"accuracy": acc, "logit_scale": scale.detach()}

    def val_epoch(self):  # contrastive pretraining: train metrics only
        pass


def build(argv: list[str] | None = None) -> tuple[dml.TrainingPipeline, CLIPStage]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="vit-l")
    ap.add_argument("--toy", action="store_true", help="tiny model + tiny batch (sets --preset toy)")
    ap.add_argument("--mesh", type=str, default=None,
                    help="e.g. data=2,fsdp=2 (the reference's v5p-64 recipe: data=8,fsdp=8); default: none, the "
                         "model replicated on every process")
    ap.add_argument("--global-batch", type=int, default=4096)
    ap.add_argument("--epochs", type=int, default=32)
    ap.add_argument("--steps-per-epoch", type=int, default=100,
                    help="synthetic-data epoch length (a real run sizes this from the dataset)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-dir", type=str, default=None, help="a local run directory (or root, with --resume)")
    ap.add_argument("--save-every-steps", type=int, default=500)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)

    if args.toy:
        args.preset = "toy"
        args.global_batch = min(args.global_batch, 16)
        args.epochs = min(args.epochs, 2)
        args.steps_per_epoch = min(args.steps_per_epoch, 4)
    if args.checkpoint_dir and "://" in args.checkpoint_dir:
        raise NotImplementedError("remote checkpoint directories are not ported yet (ROADMAP Queue 1 item 3); "
                                  f"got {args.checkpoint_dir!r}")

    init_auto(args.device, verbose=True)
    steps_total = args.epochs * args.steps_per_epoch
    config = {
        "preset": args.preset,
        "global_batch": args.global_batch,
        "steps_per_epoch": args.steps_per_epoch,
        "lr": args.lr,
        "warmup_steps": max(steps_total // 50, 1),
        "decay_steps": steps_total,
        "save_every_steps": args.save_every_steps,
        "seed": 0,
    }
    pipeline = dml.TrainingPipeline(config, name=f"clip-{args.preset}", device=args.device)
    if args.mesh:
        pipeline.set_mesh(parse_mesh_axes(args.mesh))
    if args.checkpoint_dir:
        pipeline.enable_checkpointing(args.checkpoint_dir, resume=args.resume)
        # a scheduler's eviction drains at the next step save, commits the
        # state and writes the requeue verdict
        pipeline.enable_preemption_handling(signals=None)
    stage = CLIPStage()
    pipeline.append_stage(stage, max_epochs=args.epochs)
    return pipeline, stage


def main(argv: list[str] | None = None) -> CLIPStage:
    pipeline, stage = build(argv)
    pipeline.run()
    return stage


if __name__ == "__main__":
    main()
