"""Fine-tune a HuggingFace Llama checkpoint, then export it back: the
counterpart of ``examples/finetune_hf.py``, with its flags (``--hf-name``,
``--epochs``, ``--seq-len``, ``--batch-size``, ``--n-docs``, ``--lr``,
``--mesh``, ``--sample``, ``--export``, ``--lora RANK``) and ``--device``.

The interop loop in one script::

    HF LlamaForCausalLM --import--> DecoderLM (models/hf.py, load_flax_params)
        --TrainingPipeline finetune (packed byte corpus, segment_ids)-->
        --KV-cache sampling--> --export--> HF state dict (.npz)

With ``--lora RANK`` the finetune trains rank-RANK adapters only
(``models.lora.LoraModel``: the base's weights are frozen buffers, the
optimizer state is adapter-sized) and the sample and export steps run on the
merged weights. ``--mesh`` (e.g. ``data=2,fsdp=2``; one process per device,
launched by ``torch.distributed.run``) lays the model out under
``llama_partition_rules()`` (with ``lora_partition_rules`` for adapters), and
each process feeds its data-parallel rows of every batch
(``parallel.make_global_batch``); sampling and export are single-process
demos, skipped at world size > 1.

With no network this builds a small randomly initialised HF model in-process
(``transformers`` is imported only then, so the rest of the port never needs
it); ``--hf-name`` names a local HF checkpoint directory for real weights.
``main(argv, hf_config=, state_dict=, **overrides)`` takes a config object
with HF's attribute names and a HF-named state dict instead of building a HF
model (no ``transformers`` needed), and passes ``overrides`` to
``transformer_config_from_hf`` (e.g. ``dtype``, ``attn_impl``); it returns
the stage (``stage.sample_output``, ``stage.exported``).

Run on one GPU (``--device cpu`` runs on the CPU):

    python -m dmlcloud_tpu_torch.examples.finetune_hf --epochs 2
    python -m dmlcloud_tpu_torch.examples.finetune_hf --lora 4 --export ft.npz
"""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

import dmlcloud_tpu_torch as dml
from dmlcloud_tpu_torch.data import pack_sequences
from dmlcloud_tpu_torch.models.generate import generate
from dmlcloud_tpu_torch.models.hf import hf_state_dict_from_params, llama_params_from_hf, transformer_config_from_hf
from dmlcloud_tpu_torch.models.lora import LoraModel, lora_init, lora_merge, lora_partition_rules, lora_size
from dmlcloud_tpu_torch.models.transformer import (DecoderLM, llama_partition_rules, lm_loss, load_flax_params,
                                                   to_flax_params)
from dmlcloud_tpu_torch.optim import adamw
from dmlcloud_tpu_torch.parallel import init_auto, make_global_batch, parse_mesh_axes, resolve_device, runtime


def build_hf_model(name: str | None):
    """A local HF checkpoint, or the reference's tiny random Llama (seeded)."""
    import transformers

    if name:
        return transformers.LlamaForCausalLM.from_pretrained(name, local_files_only=True)
    cfg = transformers.LlamaConfig(
        vocab_size=257,
        hidden_size=64,
        intermediate_size=160,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=256,
        attn_implementation="eager",
    )
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


def byte_corpus(n_docs: int, vocab: int, seed: int = 0) -> list[np.ndarray]:
    """Variable-length 'documents' with learnable structure (byte chains)."""
    rng = np.random.RandomState(seed)
    nxt = rng.randint(1, vocab, size=vocab)
    docs = []
    for _ in range(n_docs):
        n = rng.randint(16, 96)
        doc = np.empty(n, np.int32)
        doc[0] = rng.randint(1, vocab)
        for i in range(1, n):
            doc[i] = nxt[doc[i - 1]] if rng.rand() > 0.1 else rng.randint(1, vocab)
        docs.append(doc)
    return docs


class FinetuneStage(dml.TrainValStage):
    """The finetune over the packed byte corpus: ``model`` (the imported
    ``DecoderLM``) trained whole, or through rank-``lora_rank`` adapters."""

    def __init__(self, model, cfg, seq_len, batch_size, n_docs, lr, lora_rank=0):
        super().__init__()
        self.model, self.model_cfg = model, cfg
        self._seq_len, self._bs, self._n_docs, self._lr = seq_len, batch_size, n_docs, lr
        self._lora_rank = lora_rank
        self.lora = None

    def trained_tensors(self) -> dict[str, torch.Tensor]:
        """What sampling and export load, by parameter name of ``model``: the
        trained weights, or base + adapters merged when LoRA is on."""
        if self.lora is None:
            return dict(self.model.named_parameters())
        return lora_merge(self.model, self.lora.adapters(), self.lora.alpha)

    def trained_model(self) -> DecoderLM:
        """``model`` itself, or a merged copy of it when LoRA is on."""
        if self.lora is None:
            return self.model
        merged = copy.deepcopy(self.model)
        with torch.no_grad():
            merged.load_state_dict(self.trained_tensors(), strict=False)
        return merged

    def pre_stage(self):
        rows = list(pack_sequences(byte_corpus(self._n_docs, self.model_cfg.vocab_size), self._seq_len))
        packed = np.stack([np.stack([r["tokens"], r["segment_ids"]]) for r in rows])  # [N, 2, T]
        n_batches = len(packed) // self._bs
        if n_batches < 1:
            raise ValueError("corpus too small for one batch; raise --n-docs")
        batches = [packed[i * self._bs : (i + 1) * self._bs] for i in range(n_batches)]
        mesh = self.pipeline.mesh
        if mesh is not None:
            batches = [make_global_batch(b, mesh) for b in batches]
        self.pipeline.register_dataset("train", batches)
        # the partition rules shard params and optimizer state over fsdp/model
        # axes when the mesh has them; on a plain data mesh they fold to replicate
        if self._lora_rank:
            gen = torch.Generator(device=self.device).manual_seed(0)
            adapters = lora_init(gen, self.model, rank=self._lora_rank)
            self.logger.info(f"LoRA rank {self._lora_rank}: {lora_size(adapters):,} trainable params")
            # adapters replicate (rank dims should not shard); the base rules
            # still shard the frozen weights
            self.lora = LoraModel(self.model, adapters)
            self.pipeline.register_model("lm", self.lora, sharding=lora_partition_rules(llama_partition_rules()))
        else:
            self.pipeline.register_model("lm", self.model, sharding=llama_partition_rules())
        self.pipeline.register_optimizer("adamw", adamw(self._lr))

    def gradient_clip(self):
        return 1.0

    def segment_ids_of(self, batch):
        return batch[:, 1]

    def step(self, state, batch):
        toks, segs = batch[:, 0], batch[:, 1]
        logits = state.model(toks, segment_ids=segs)
        return lm_loss(logits, toks, segment_ids=segs)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--hf-name", default=None, help="local HF checkpoint dir (default: tiny random demo model)")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--n-docs", type=int, default=256)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--mesh", type=str, default=None, help="e.g. data=2,fsdp=4")
    parser.add_argument("--sample", type=int, default=16)
    parser.add_argument("--export", type=str, default=None, help="path to save the exported HF state dict (.npz)")
    parser.add_argument("--lora", type=int, default=0, metavar="RANK",
                        help="train rank-RANK LoRA adapters instead of full params")
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    return parser


def main(argv: list[str] | None = None, hf_config=None, state_dict=None, **overrides) -> FinetuneStage:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    init_auto(args.device, verbose=True)

    if hf_config is None:
        hf_model = build_hf_model(args.hf_name)
        hf_config, state_dict = hf_model.config, hf_model.state_dict()
    overrides.setdefault("dtype", torch.float32)
    overrides.setdefault("max_seq_len", max(args.seq_len + args.sample, hf_config.max_position_embeddings))
    cfg = transformer_config_from_hf(hf_config, **overrides)
    model = load_flax_params(DecoderLM(cfg, device=device), llama_params_from_hf(state_dict, cfg))

    pipeline = dml.TrainingPipeline({"seed": 0, "lr": args.lr}, name="finetune-hf", device=args.device)
    if args.mesh:
        pipeline.set_mesh(parse_mesh_axes(args.mesh))
    stage = FinetuneStage(model, cfg, args.seq_len, args.batch_size, args.n_docs, args.lr, lora_rank=args.lora)
    pipeline.append_stage(stage, max_epochs=args.epochs)
    pipeline.run()

    stage.sample_output = stage.exported = None
    if args.sample > 0 and runtime.world_size() == 1:
        # ragged prompts drawn from the training corpus's distribution (same
        # seed -> same byte-chain transition table), LEFT-padded to one width
        docs = byte_corpus(2, cfg.vocab_size, seed=0)
        pieces = [docs[0][:5], docs[1][:9]]
        width = max(len(p) for p in pieces)
        prompt = np.zeros((len(pieces), width), np.int32)
        mask = np.zeros((len(pieces), width), np.int32)
        for r, p in enumerate(pieces):
            prompt[r, width - len(p) :] = p
            mask[r, width - len(p) :] = 1
        stage.sample_output = generate(stage.trained_model(), prompt, max_new_tokens=args.sample, prompt_mask=mask)
        for p, cont in zip(pieces, stage.sample_output.tolist()):
            print(f"prompt {p.tolist()} -> {cont}")

    if args.export:
        if runtime.world_size() > 1:
            # a multi-process export would gather the shards on every rank;
            # keep the demo single-process like --sample
            if runtime.rank() == 0:
                print("--export is a single-process demo; skipping under multi-process runs")
        else:
            sd = hf_state_dict_from_params(to_flax_params(stage.model, tensors=stage.trained_tensors()), cfg)
            np.savez(args.export, **sd)
            stage.exported = args.export
            print(f"exported HF state dict ({len(sd)} tensors) to {args.export}")
    return stage


if __name__ == "__main__":
    main()
