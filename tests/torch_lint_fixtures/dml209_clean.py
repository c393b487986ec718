"""DML209 clean fixture (torch): packed pipelines with segment_ids plumbed
through both the module call and the loss — plus the shapes that must NOT
trigger (unpacked scopes, unrelated ``.pack`` receivers, explicit
``segment_ids=None`` plumbing).

Static lint corpus — never imported or executed.
"""

import struct

import numpy as np

from dmlcloud_tpu_torch import TrainValStage
from dmlcloud_tpu_torch.data import DataPipeline
from dmlcloud_tpu_torch.models.transformer import chunked_lm_loss, lm_loss


class PackedStage(TrainValStage):
    def pre_stage(self):
        docs = [np.arange(n) for n in (3, 5, 7)]
        ds = DataPipeline.from_source(docs).pack_stream(128, chunk_docs=64)
        self.pipeline.register_dataset("train", ds.batch(8))

    def step(self, state, batch):
        logits = state.model(batch["tokens"], segment_ids=batch["segment_ids"])
        return lm_loss(logits, batch["tokens"], segment_ids=batch["segment_ids"])


def packed_positional_segs(model, batch, docs):
    p = DataPipeline.from_source(docs).pack(64)
    logits = model(batch["tokens"], segment_ids=batch["segment_ids"])
    return lm_loss(logits, batch["tokens"], batch["segment_ids"]), p


def packed_chunked(model, batch, rows):
    ds = DataPipeline.from_source(rows).pack_stream(256)
    hidden = model(batch["tokens"], segment_ids=batch["segment_ids"], return_hidden=True)
    return chunked_lm_loss(hidden, model.lm_head.weight, batch["tokens"], segment_ids=batch["segment_ids"]), ds


def explicit_none_is_plumbed(model, batch, docs):
    ds = DataPipeline.from_source(docs).pack_stream(128)
    logits = model.forward(batch["tokens"], segment_ids=None)
    return lm_loss(logits, batch["tokens"], segment_ids=None), ds


def unpacked_scope_is_silent(model, batch):
    logits = model(batch["tokens"])
    return lm_loss(logits, batch["tokens"])


def unrelated_pack_receiver(model, batch, values):
    blob = struct.pack("<I", len(values))
    logits = model(batch["tokens"])
    return lm_loss(logits, batch["tokens"]), blob
