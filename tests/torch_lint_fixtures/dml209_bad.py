"""DML209 bad fixture (torch): a packed pipeline whose module call / lm_loss
drops segment_ids — silent cross-document attention leakage.

Static lint corpus — never imported or executed. Expected findings: 5.
"""

import numpy as np

from dmlcloud_tpu_torch import TrainValStage
from dmlcloud_tpu_torch.data import DataPipeline, pack_sequences
from dmlcloud_tpu_torch.models.transformer import chunked_lm_loss, lm_loss


class PackedStage(TrainValStage):
    def pre_stage(self):
        docs = [np.arange(n) for n in (3, 5, 7)]
        ds = DataPipeline.from_source(docs).pack_stream(128, chunk_docs=64)
        self.pipeline.register_dataset("train", ds.batch(8))

    def step(self, state, batch):
        logits = state.model(batch["tokens"])  # BAD: attention leaks across documents
        return lm_loss(logits, batch["tokens"])  # BAD: loss counts pad/cross-doc targets


def packed_free_function(model, batch, docs):
    rows = pack_sequences(docs, 256)
    logits = model(batch["tokens"], segment_ids=batch["segment_ids"])
    return lm_loss(logits, batch["tokens"]), rows  # BAD: model ok, loss dropped them


def packed_chunked_loss(model, batch, docs):
    rows = pack_sequences(docs, 512)
    hidden = model(batch["tokens"], segment_ids=batch["segment_ids"], return_hidden=True)
    kernel = model.lm_head.weight
    return chunked_lm_loss(hidden, kernel, batch["tokens"]), rows  # BAD: kw-only segs dropped


def packed_via_alias(docs, model, batch):
    p = DataPipeline.from_source(docs)
    packed = p.pack(64)  # receiver chases to DataPipeline: packed scope
    logits = model.forward(batch["tokens"])  # BAD: aliased receiver, same leak
    return logits, packed
