"""MNIST training through the port's pipeline: the counterpart of
``examples/mnist.py``, with the same flags (``--epochs``, ``--batch-size``,
``--lr``, ``--checkpoint-dir``, ``--resume``) and ``--device``.

Each process trains a replica of ``MnistCNN`` (``register_model(...,
sharding="replicate")``) on its own shard of the training set
(``ShardedSequenceDataset``, reshuffled every epoch); the gradients are
averaged over the processes every step, so ``--batch-size`` is per process
and the global batch is ``batch size x processes``. Validation metrics are
reduced over the processes at each epoch's end.

Data: torchvision's MNIST if torchvision is importable and the dataset is
already on disk under ``./data`` (nothing is downloaded); otherwise the
reference example's synthetic digit set (``synthetic_digits``), so the example
runs without network.

Run on one GPU, on the CPU, or on two processes of one host:

    python -m dmlcloud_tpu_torch.examples.mnist --epochs 3 --batch-size 32
    python -m dmlcloud_tpu_torch.examples.mnist --device cpu --epochs 1 --batch-size 128
    torchrun --nproc_per_node=2 -m dmlcloud_tpu_torch.examples.mnist --device cpu --epochs 1

``main(argv)`` returns the stage, so callers can read its tracked metrics and
per-step losses.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

import dmlcloud_tpu_torch as dml
from dmlcloud_tpu_torch.data import ShardedSequenceDataset
from dmlcloud_tpu_torch.models.cnn import MnistCNN
from dmlcloud_tpu_torch.optim import adamw, cosine_decay_schedule
from dmlcloud_tpu_torch.parallel import init_auto
from dmlcloud_tpu_torch.parallel.runtime import root_first


def synthetic_digits() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The reference example's fallback set, bit for bit: 4096 train and 512
    test images of uniform noise, NHWC in [0, 1), each stamped with a
    class-dependent bar so that the task is learnable."""
    rng = np.random.RandomState(0)
    n_tr, n_te = 4096, 512
    x = rng.rand(n_tr + n_te, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, size=n_tr + n_te)
    for i, label in enumerate(y):
        x[i, label * 2 : label * 2 + 4, :8, 0] += 2.0
    return x[:n_tr], y[:n_tr], x[n_tr:], y[n_tr:]


def load_mnist() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(train_images, train_labels, test_images, test_labels) as numpy, NHWC
    in [0, 1]: torchvision's MNIST when it is importable and on disk (the
    root reads first, as the reference's download does), else
    ``synthetic_digits()``."""
    try:
        with root_first():
            from torchvision.datasets import MNIST

            train = MNIST(root="./data", train=True, download=False)
            test = MNIST(root="./data", train=False, download=False)
        tr_x = train.data.numpy()[..., None].astype(np.float32) / 255.0
        te_x = test.data.numpy()[..., None].astype(np.float32) / 255.0
        return tr_x, train.targets.numpy(), te_x, test.targets.numpy()
    except (ImportError, RuntimeError):  # no torchvision, or the dataset is not on disk
        return synthetic_digits()


class _Loader:
    """Batches of ``{"image", "label"}`` over the indices of ``idx_ds``, this
    process's shard; ``set_epoch`` reshuffles it."""

    def __init__(self, idx_ds: ShardedSequenceDataset, x: np.ndarray, y: np.ndarray, bs: int):
        self.idx_ds, self.x, self.y, self.bs = idx_ds, x, y, bs

    def set_epoch(self, epoch: int) -> None:
        self.idx_ds.set_epoch(epoch)

    def __iter__(self):
        idx = np.fromiter(self.idx_ds, dtype=np.int64)
        for i in range(0, len(idx) - self.bs + 1, self.bs):
            sel = idx[i : i + self.bs]
            yield {"image": self.x[sel], "label": self.y[sel]}

    def __len__(self) -> int:
        return len(self.idx_ds) // self.bs


class MnistStage(dml.TrainValStage):
    def pre_stage(self):
        cfg = self.config
        tr_x, tr_y, te_x, te_y = load_mnist()

        # shard the sample indices across processes; each process batches its shard
        train_idx = ShardedSequenceDataset(list(range(len(tr_x))), shuffle=True)
        val_idx = ShardedSequenceDataset(list(range(len(te_x))))
        self.pipeline.register_dataset("train", _Loader(train_idx, tr_x, tr_y, cfg.batch_size))
        self.pipeline.register_dataset("val", _Loader(val_idx, te_x, te_y, cfg.batch_size))

        model = MnistCNN(generator=torch.Generator().manual_seed(int(cfg.seed)))
        self.pipeline.register_model("cnn", model, sharding="replicate")
        # optax.adam: no weight decay, eps 1e-8; the schedule is read at the
        # 0-based update count, so the first step trains at the full lr
        schedule = cosine_decay_schedule(cfg.lr, decay_steps=1000)
        self.pipeline.register_optimizer("adam", adamw(schedule, weight_decay=0.0), scheduler=schedule)

    def step(self, state, batch):
        logits = state.model(batch["image"])
        loss = F.cross_entropy(logits, batch["label"])
        accuracy = (logits.argmax(-1) == batch["label"]).float().mean()
        return loss, {"accuracy": accuracy}

    def table_columns(self):
        cols = super().table_columns()
        cols.insert(3, {"name": "[Val] Acc.", "metric": "val/accuracy"})
        return cols


def build(argv: list[str] | None = None) -> tuple[dml.TrainingPipeline, MnistStage]:
    """The pipeline and stage that ``argv`` describes, not yet run."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--checkpoint-dir", type=str, default=None)
    parser.add_argument(
        "--resume",
        action="store_true",
        help="resume from --checkpoint-dir (a run dir, or a root scanned by Slurm job id)",
    )
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = parser.parse_args(argv)

    init_auto(args.device, verbose=True)
    config = {"batch_size": args.batch_size, "lr": args.lr, "seed": 42}
    pipeline = dml.TrainingPipeline(config, name="mnist", device=args.device)
    if args.checkpoint_dir:
        pipeline.enable_checkpointing(args.checkpoint_dir, resume=args.resume)
    stage = MnistStage()
    pipeline.append_stage(stage, max_epochs=args.epochs)
    return pipeline, stage


def main(argv: list[str] | None = None) -> MnistStage:
    pipeline, stage = build(argv)
    pipeline.run()
    return stage


if __name__ == "__main__":
    main()
