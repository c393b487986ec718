"""Decoder-LM pretraining through the port's pipeline — the counterpart of
``examples/train_lm.py``, with the same presets and the flags of the ported
paths (``--attn dot|flash|ring``, ``--pack``, ``--window``,
``--checkpoint-dir``, ``--save-every-steps``, ``--ema``, ``--mfu``,
``--chunked-loss``, ``--mesh``, ``--sample``), plus ``--corpus``,
``--pack-window`` and ``--layers``.

The model registers with ``sharding=llama_partition_rules()``, as the
reference's example does. Without ``--mesh`` the mesh is ``{data: world}``,
where those rules shard nothing: every process holds the whole model and
feeds the whole ``--batch-size`` batch. With ``--mesh`` (e.g.
``fsdp=4``, ``data=2,fsdp=2``, ``fsdp=2,model=2``; one process per device,
launched by ``torch.distributed.run``) ``--batch-size`` is the global batch:
each process feeds the rows of its data-parallel coordinate
(``parallel.mesh.data_parallel_rank``), the same rows as its tensor- and
sequence-parallel peers. ``--attn ring`` needs a ``seq`` axis in ``--mesh``:
attention then runs as ring attention over it (``--window`` over global
positions), everything else replicated over ``seq``; ``--pack`` does not go
with it.

Run on one GPU (``--device cpu`` runs on the CPU with the kernels' plain
PyTorch versions):

    python -m dmlcloud_tpu_torch.examples.train_lm --preset tiny --epochs 2
    python -m dmlcloud_tpu_torch.examples.train_lm --preset 1b --attn flash --vocab-size 32000 \\
        --seq-len 2048 --batch-size 4 --n-seqs 32 --epochs 1 \\
        --checkpoint-dir runs --save-every-steps 4 --ema 0.999

``--checkpoint-dir`` creates a fresh run directory under the given root, as the
reference's example does; the root may be a URL (``gs://bucket/runs``,
``memory://runs``), which is used as it is. To resume one, build the same
pipeline with ``build(argv, resume=True)``, where ``--checkpoint-dir`` names
the run directory itself (or its root, under a requeued Slurm job), and run it.

``--corpus DIR`` trains on a ``.dmlshard`` corpus (``scripts/
torch_build_corpus.py``) in place of the synthetic rows: ``ShardReader`` (this
data-parallel coordinate's record-strided share) -> ``pack_stream(seq_len,
pack_window=--pack-window)`` -> ``batch`` -> ``to_device(prefetch=2)``, the
first ``--n-seqs`` packed rows of each epoch, with no validation set. The
step sidecar then carries the pipeline's iterator state, from which a
mid-epoch resume fast-forwards; ``stage.pack_stats`` counts the padding.
``--layers N`` cuts the preset's depth.

``--sample N`` greedy-decodes N tokens after training from a prompt of the
corpus (two rows of 16 tokens, ``stage.sample_prompt``) through the KV-cache
``models.generate.generate``, prints ``prompt [...] -> [...]`` per row and
keeps the tokens as ``stage.sample_output``; it is a single-process demo and is
skipped at world size > 1.

``build(argv, telemetry=...)`` arms the flight recorder
(``TrainingPipeline(telemetry=...)``). ``main(argv)`` returns the stage, so
callers can read its tracked metrics and per-step losses.
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np

import dmlcloud_tpu_torch as dml
from dmlcloud_tpu_torch.data import DataPipeline, PackStats, ShardReader, pack_sequences
from dmlcloud_tpu_torch.data import markov_tokens as synthetic_tokens
from dmlcloud_tpu_torch.models.generate import generate
from dmlcloud_tpu_torch.models.transformer import (DecoderLM, TransformerConfig, chunked_lm_loss, llama_partition_rules,
                                                   lm_head_kernel, lm_loss)
from dmlcloud_tpu_torch.optim import adamw, warmup_cosine_decay_schedule
from dmlcloud_tpu_torch.parallel import init_auto, runtime
from dmlcloud_tpu_torch.parallel.mesh import data_parallel_rank, data_parallel_size, parse_mesh_axes

PRESETS = {
    "tiny": dict(num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16, hidden_dim=64, mlp_dim=160),
    "small": dict(num_layers=8, num_heads=8, num_kv_heads=4, head_dim=64, hidden_dim=512, mlp_dim=1408),
    "1b": dict(num_layers=24, num_heads=16, num_kv_heads=8, head_dim=128, hidden_dim=2048, mlp_dim=5632),
}


class _FirstBatches:
    """The first ``n`` batches of ``pipeline`` in each epoch."""

    def __init__(self, pipeline: DataPipeline, n: int):
        self.pipeline, self.n = pipeline, n

    def set_epoch(self, epoch: int) -> None:
        self.pipeline.set_epoch(epoch)

    def __iter__(self):
        return itertools.islice(iter(self.pipeline), self.n)

    def __len__(self) -> int:
        return self.n


def _packed_rows(rows: list[dict]) -> np.ndarray:
    """``pack_stream`` rows as one ``[B, 2, T]`` array: tokens, then segment ids."""
    return np.stack([np.stack([r["tokens"], r["segment_ids"]]) for r in rows])


class LMStage(dml.TrainValStage):
    #: tokens ``main`` greedy-decodes after training (``--sample``)
    sample_new_tokens = 0

    def pre_stage(self):
        cfg = self.config
        preset = dict(PRESETS[cfg.preset])
        if cfg.get("layers"):
            preset["num_layers"] = int(cfg.layers)
        model_cfg = TransformerConfig(
            vocab_size=cfg.vocab_size,
            max_seq_len=cfg.seq_len,
            attn_impl=cfg.attn,
            tie_embeddings=bool(cfg.get("tie_embeddings", False)),
            remat=bool(cfg.get("remat", False)),
            sliding_window=cfg.get("window"),
            **preset,
        )
        model = DecoderLM(model_cfg, device=self.device)
        self.model = model
        if cfg.get("corpus"):
            self._corpus_datasets(cfg)
            return

        if cfg.get("pack", False):
            # variable-length corpus packed into full rows: [N, 2, T] of
            # (tokens, segment_ids), routed through the segment-isolated path
            rng = np.random.RandomState(1)
            # ids shifted +1 below so pad id 0 never collides with a token
            full = synthetic_tokens(cfg.vocab_size - 1, cfg.n_seqs, cfg.seq_len)
            pieces = [row[: rng.randint(cfg.seq_len // 4, cfg.seq_len + 1)] + 1 for row in full]
            rows = list(pack_sequences(pieces, cfg.seq_len))
            tokens = np.stack([np.stack([r["tokens"], r["segment_ids"]]) for r in rows])
            self.sample_prompt = full[:2, :16] + 1  # corpus-distribution prompt, shifted like training
        else:
            tokens = synthetic_tokens(cfg.vocab_size, cfg.n_seqs, cfg.seq_len)
            self.sample_prompt = tokens[:2, :16].copy()
        n_val = max(cfg.batch_size, len(tokens) // 10)
        bs = cfg.batch_size
        if (len(tokens) - n_val) < bs:
            raise ValueError(
                f"{len(tokens)} rows after packing/splitting leave fewer than one "
                f"train batch (batch_size={bs}, val={n_val}); raise --n-seqs or lower --batch-size"
            )
        # with a mesh, each process feeds its data-parallel slice of the batch
        mesh = self.pipeline.mesh
        dp, dp_rank = (data_parallel_size(mesh), data_parallel_rank(mesh)) if mesh is not None else (1, 0)
        if bs % dp:
            raise ValueError(f"--batch-size {bs} is not divisible by the mesh's data-parallel size {dp}")
        mine = slice(dp_rank * (bs // dp), (dp_rank + 1) * (bs // dp))

        def loader(data):
            class Loader:
                def __iter__(self):
                    for i in range(0, len(data) - bs + 1, bs):
                        yield data[i : i + bs][mine]

                def __len__(self):
                    return len(data) // bs

            return Loader()

        self.pipeline.register_dataset("train", loader(tokens[n_val:]))
        self.pipeline.register_dataset("val", loader(tokens[:n_val]))
        self._register_model_and_optimizer()

    def _register_model_and_optimizer(self):
        self.pipeline.register_model("lm", self.model, sharding=llama_partition_rules())
        schedule = warmup_cosine_decay_schedule(0.0, self.config.lr, 20, 2000)
        self.pipeline.register_optimizer("adamw", adamw(schedule), scheduler=schedule)

    def _corpus_datasets(self, cfg):
        """``--corpus``: this data-parallel coordinate's share of the shard
        corpus (its record-strided share: each coordinate packs its own rows),
        packed, batched and fed onto the device by the pipeline. Under
        ``--mesh`` the batch is the global one, as in the synthetic path."""
        mesh = self.pipeline.mesh
        bs = rows = cfg.batch_size
        if mesh is not None:
            dp, dp_rank = data_parallel_size(mesh), data_parallel_rank(mesh)
            if bs % dp:
                raise ValueError(f"--batch-size {bs} is not divisible by the mesh's data-parallel size {dp}")
            rows = bs // dp
        else:
            dp, dp_rank = runtime.world_size(), runtime.rank()
        reader = ShardReader(cfg.corpus, rank=dp_rank, world_size=dp)
        self.pack_stats = PackStats()
        host = reader.pack_stream(cfg.seq_len, pack_window=int(cfg.get("pack_window", 0)), stats=self.pack_stats)
        host = host.batch(rows, drop_remainder=True, collate=_packed_rows)
        self.pipeline.register_dataset(
            "train", DataPipeline.from_source(_FirstBatches(host, cfg.n_seqs // bs)).to_device(self.device))
        first = [np.asarray(reader.store.record(g)) for g in range(min(2, reader.store.total_records))]
        self.sample_prompt = np.stack([np.resize(doc, 16) for doc in first]).astype(np.int64)
        self._register_model_and_optimizer()

    def gradient_clip(self):
        return 1.0

    def ema_decay(self):
        return float(self.config.get("ema", 0.0))

    def checkpoint_every_steps(self):
        return int(self.config.get("save_every_steps", 0))

    def step_flops(self):
        # 6 * params * tokens per global batch (the JAX example's count: every
        # parameter, embedding and head included); tracked as misc/mfu
        if not self.config.get("mfu", False):
            return 0.0
        n_params = sum(p.numel() for p in self.state.model.parameters())
        return 6.0 * n_params * self.config.batch_size * self.config.seq_len

    def segment_ids_of(self, batch):
        # --pack and --corpus rows are [B, 2, T]: tokens, then segment ids
        return batch[:, 1] if self._packed else None

    @property
    def _packed(self) -> bool:
        return bool(self.config.get("pack", False) or self.config.get("corpus"))

    def step(self, state, batch):
        if self._packed:
            toks, segs = batch[:, 0], batch[:, 1]
        else:
            toks, segs = batch, None
        chunk = int(self.config.get("chunked_loss", 0))
        if chunk > 0:
            hidden = state.model(toks, segment_ids=segs, return_hidden=True)
            kernel, tp = lm_head_kernel(state.model)
            return chunked_lm_loss(hidden, kernel, toks, vocab_chunk=chunk, segment_ids=segs, tp=tp)
        logits = state.model(toks, segment_ids=segs)
        return lm_loss(logits, toks, segment_ids=segs)


def build(
    argv: list[str] | None = None, resume: bool = False, telemetry=None
) -> tuple[dml.TrainingPipeline, LMStage]:
    """The pipeline and stage that ``argv`` describes, not yet run; with
    ``resume``, a valid ``--checkpoint-dir`` is continued instead of a fresh
    run directory being created under it; ``telemetry`` is passed to
    ``TrainingPipeline``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--vocab-size", type=int, default=512)
    parser.add_argument("--n-seqs", type=int, default=512)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--attn", choices=["dot", "flash", "ring"], default="dot")
    parser.add_argument("--window", type=int, default=None, help="sliding-window attention width")
    parser.add_argument("--pack", action="store_true", help="pack a variable-length corpus (segment_ids path)")
    parser.add_argument("--remat", action="store_true", help="recompute blocks in the backward pass")
    parser.add_argument("--tie-embeddings", action="store_true", help="share the embedding matrix with the LM head")
    parser.add_argument("--checkpoint-dir", type=str, default=None)
    parser.add_argument("--ema", type=float, default=0.0, help="param EMA decay (0 off); validation uses the average")
    parser.add_argument("--save-every-steps", type=int, default=0, help="mid-epoch step saves (resumable mid-epoch)")
    parser.add_argument("--mfu", action="store_true", help="track misc/mfu from the 6ND estimate")
    parser.add_argument("--chunked-loss", type=int, default=0, metavar="CHUNK",
                        help="vocab chunk for chunked_lm_loss (0 = full logits); big-vocab memory lever")
    parser.add_argument("--mesh", type=str, default=None, help="e.g. data=2,fsdp=4 (one process per device)")
    parser.add_argument("--sample", type=int, default=0, metavar="N",
                        help="after training, greedy-decode N tokens from a corpus prompt (KV-cache generate)")
    parser.add_argument("--corpus", type=str, default=None,
                        help="train on this .dmlshard corpus directory (ShardReader -> pack_stream -> to_device)")
    parser.add_argument("--pack-window", type=int, default=0,
                        help="--corpus: first-fit-decreasing window of pack_stream (0: greedy chunks)")
    parser.add_argument("--layers", type=int, default=None, help="cut the preset's depth to this many blocks")
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = parser.parse_args(argv)
    if (args.pack or args.corpus) and args.attn == "ring":
        parser.error("--pack and --corpus (segment_ids) are not supported with --attn ring")
    if args.attn == "ring" and "seq" not in parse_mesh_axes(args.mesh or "data=-1"):
        parser.error("--attn ring needs a seq axis in --mesh (e.g. --mesh seq=4)")

    init_auto(args.device, verbose=True)
    config = {
        "preset": args.preset,
        "batch_size": args.batch_size,
        "seq_len": args.seq_len,
        "vocab_size": args.vocab_size,
        "n_seqs": args.n_seqs,
        "lr": args.lr,
        "attn": args.attn,
        "tie_embeddings": args.tie_embeddings,
        "remat": args.remat,
        "window": args.window,
        "pack": args.pack,
        "ema": args.ema,
        "save_every_steps": args.save_every_steps,
        "mfu": args.mfu,
        "chunked_loss": args.chunked_loss,
        "corpus": args.corpus,
        "pack_window": args.pack_window,
        "layers": args.layers,
        "seed": 0,
    }
    pipeline = dml.TrainingPipeline(config, name=f"lm-{args.preset}", device=args.device, telemetry=telemetry)
    if args.mesh:
        pipeline.set_mesh(parse_mesh_axes(args.mesh))
    if args.checkpoint_dir:
        pipeline.enable_checkpointing(args.checkpoint_dir, resume=resume)
    stage = LMStage()
    stage.sample_new_tokens = args.sample
    pipeline.append_stage(stage, max_epochs=args.epochs)
    return pipeline, stage


def main(argv: list[str] | None = None) -> LMStage:
    pipeline, stage = build(argv)
    pipeline.run()
    if stage.sample_new_tokens > 0:
        if runtime.world_size() > 1:
            # a decode across processes would need the model whole on each;
            # the flag is a single-process demo of the decode path
            if runtime.rank() == 0:
                print("--sample is a single-process demo; skipping under multi-process runs")
        else:
            stage.sample_output = generate(stage.model, stage.sample_prompt, max_new_tokens=stage.sample_new_tokens)
            for row, cont in zip(stage.sample_prompt.tolist(), stage.sample_output.tolist()):
                print(f"prompt {row} -> {cont}")
    return stage


if __name__ == "__main__":
    main()
