"""BERT-style bidirectional encoder: counterpart of ``dmlcloud_tpu/models/bert.py``
(``BertConfig`` :32, ``BertEmbeddings`` :61, ``BertEncoder`` :82,
``BertForMaskedLM`` :96, ``BertForSequenceClassification`` :119, ``mlm_loss``
:138, ``IGNORE_INDEX`` :29).

Word + learned-position + segment embeddings, the pre-LN encoder core
(``models.encoder``), bf16 matmuls on fp32 parameters, fp32 norms. Padding
keeps static shapes: the ``{0,1}`` attention mask becomes an additive bias on
the dot path and segment ids on the flash path (``attn_impl="flash"``: the
flash kernels with ``causal=False``).

The MLM head is tied to the word table and takes bf16 operands with an fp32
result (the reference's ``preferred_element_type=float32``): a bf16
``matmul`` would round its output to bf16. The port multiplies the
bf16-rounded operands upcast to fp32, with TF32 allowed on a card: every bf16
value is a TF32 value, so the products are exact and the sums fp32.

Models take ``device`` (default ``cuda``; raises without a card unless
``device="cpu"``) and ``generator`` (default: seed 0 on that device) for
flax's initializer families. ``load_flax_params``/``to_flax_params`` bridge
the JAX model's param tree (``models.encoder``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.runtime import resolve_device
from .encoder import (AddLearnedPositions, EncoderConfig, EncoderModel, TransformerEncoder, _dense, init_flax_style,
                      load_flax_params, to_flax_params)

__all__ = ["IGNORE_INDEX", "BertConfig", "BertEmbeddings", "BertEncoder", "BertForMaskedLM",
           "BertForSequenceClassification", "mlm_loss", "load_flax_params", "to_flax_params"]

IGNORE_INDEX = -100


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_seq_len: int = 512
    type_vocab_size: int = 2
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "dot"  # 'dot' | 'flash' (padding masks ride both paths)

    @property
    def encoder(self) -> EncoderConfig:
        return EncoderConfig(hidden_dim=self.hidden_dim, num_layers=self.num_layers, num_heads=self.num_heads,
                             mlp_dim=self.mlp_dim, dtype=self.dtype, causal=False, dropout_rate=self.dropout_rate,
                             attn_impl=self.attn_impl)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.word = nn.Embedding(cfg.vocab_size, cfg.hidden_dim, device=device)
        self.pos_embed = AddLearnedPositions(cfg.max_seq_len, cfg.hidden_dim, device=device)
        # flax's ``type`` table (``type`` is a method of ``nn.Module``)
        self.type_embed = (nn.Embedding(cfg.type_vocab_size, cfg.hidden_dim, device=device) if cfg.type_vocab_size
                           else None)
        self.norm = nn.LayerNorm(cfg.hidden_dim, eps=1e-6, device=device)

    def forward(self, tokens, token_type_ids=None):
        cfg = self.cfg
        x = self.pos_embed(F.embedding(tokens, self.word.weight).to(cfg.dtype))
        if self.type_embed is not None:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(tokens)
            x = x + F.embedding(token_type_ids, self.type_embed.weight).to(cfg.dtype)
        return self.norm(x.float()).to(cfg.dtype)


class BertEncoder(nn.Module):
    """tokens [B, T] -> hidden states [B, T, D]."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg, device)
        self.encoder = TransformerEncoder(cfg.encoder, device)

    def forward(self, tokens, attention_mask=None, token_type_ids=None):
        # raw keep-mask: the flash path turns it into segment ids, the dot
        # path into the additive bias (padding_mask_bias)
        return self.encoder(self.embeddings(tokens, token_type_ids), keep_mask=attention_mask)


class _Bert(EncoderModel):
    """The encoder under a task head; subclasses add the head, then ``_init``."""

    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.cfg = cfg
        self.bert = BertEncoder(cfg, device)

    def _init(self, generator: torch.Generator | None) -> None:
        if generator is None:
            generator = torch.Generator(device=self.bert.embeddings.word.weight.device).manual_seed(0)
        init_flax_style(self, generator)


class BertForMaskedLM(_Bert):
    """tokens [B, T] -> MLM logits [B, T, V] fp32, the decoder tied to the word table."""

    def __init__(self, cfg: BertConfig, device=None, generator: torch.Generator | None = None):
        device = resolve_device(device)
        super().__init__(cfg, device)
        self.mlm_transform = nn.Linear(cfg.hidden_dim, cfg.hidden_dim, device=device)
        self.mlm_norm = nn.LayerNorm(cfg.hidden_dim, eps=1e-6, device=device)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size, device=device))
        self._init(generator)

    def forward(self, tokens, attention_mask=None, token_type_ids=None):
        cfg = self.cfg
        h = self.bert(tokens, attention_mask, token_type_ids)
        h = F.gelu(_dense(h, self.mlm_transform, cfg.dtype), approximate="tanh")
        h = self.mlm_norm(h.float())
        return _bf16_matmul_fp32(h, self.bert.embeddings.word.weight, cfg.dtype) + self.mlm_bias


class BertForSequenceClassification(_Bert):
    """tokens [B, T] -> class logits [B, num_classes] fp32 (tanh CLS pooler)."""

    def __init__(self, cfg: BertConfig, num_classes: int = 2, device=None, generator: torch.Generator | None = None):
        device = resolve_device(device)
        super().__init__(cfg, device)
        self.num_classes = num_classes
        self.pooler = nn.Linear(cfg.hidden_dim, cfg.hidden_dim, device=device)
        self.classifier = nn.Linear(cfg.hidden_dim, num_classes, device=device)
        self._init(generator)

    def forward(self, tokens, attention_mask=None, token_type_ids=None):
        h = self.bert(tokens, attention_mask, token_type_ids)
        pooled = torch.tanh(self.pooler(h[:, 0].float()))
        return self.classifier(pooled)


def _bf16_matmul_fp32(h: torch.Tensor, table: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``h @ table.T`` of the operands rounded to ``dtype``, with an fp32
    result: exact products, fp32 sums (TF32 on a card is exact for them)."""
    a, b = h.to(dtype).float(), table.to(dtype).float()
    if not a.is_cuda or dtype not in (torch.bfloat16, torch.float16):
        return F.linear(a, b)
    with _tf32():
        return F.linear(a, b)


@contextlib.contextmanager
def _tf32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked cross entropy: positions with ``labels == IGNORE_INDEX`` are
    skipped; the mean is over the kept positions only (static shapes: the
    mask is a weight, not a gather)."""
    keep = (labels != IGNORE_INDEX).float()
    safe = torch.where(labels == IGNORE_INDEX, 0, labels).long()
    per_tok = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]), safe.reshape(-1), reduction="none")
    return (per_tok.view(labels.shape) * keep).sum() / torch.clamp(keep.sum(), min=1.0)
