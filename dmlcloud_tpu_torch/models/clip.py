"""CLIP-style contrastive dual encoder: counterpart of ``dmlcloud_tpu/models/clip.py``
(``CLIPTextConfig`` :34, ``CLIPConfig`` :56, ``CLIPTextTower`` :62, ``CLIP``
:83, ``_l2_normalize`` :113, ``clip_loss`` :117).

The image tower is a ViT with ``num_classes=0``; the text tower a causal
``TransformerEncoder`` read at the EOT position, the first argmax of the
tokens (the CLIP convention: EOT has the highest id). Both project into
``embed_dim`` and are L2-normalised in fp32; the logit scale is
``min(exp(log_logit_scale), 100)``.

**The global-batch loss.** The reference's step contrasts the GLOBAL batch
(one program over it; inside a ``shard_map`` its ``clip_loss`` all-gathers
over an ``axis_name``). The port feeds per process, so ``clip_loss(img, txt,
scale, group)`` all-gathers both embedding sets over the data-parallel
``group`` with a differentiable gather (``_GatherRows``) whose backward SUMS
every rank's gradient of the gathered rows and keeps this rank's slice, and
offsets the labels by rank x local batch. Each rank's loss is then the mean
over its rows against the global batch, and once the stage averages the
parameter gradients over the ranks they are the gradients of the global loss.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.runtime import resolve_device
from .encoder import (AddLearnedPositions, EncoderConfig, EncoderModel, TransformerEncoder, init_flax_style,
                      load_flax_params, to_flax_params)
from .vit import ViT, ViTConfig

__all__ = ["CLIPTextConfig", "CLIPConfig", "CLIPTextTower", "CLIP", "clip_loss", "gather_rows", "load_flax_params",
           "to_flax_params"]


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    max_seq_len: int = 77
    hidden_dim: int = 512
    num_layers: int = 12
    num_heads: int = 8
    mlp_dim: int = 2048
    dtype: torch.dtype = torch.bfloat16

    @property
    def encoder(self) -> EncoderConfig:
        return EncoderConfig(hidden_dim=self.hidden_dim, num_layers=self.num_layers, num_heads=self.num_heads,
                             mlp_dim=self.mlp_dim, dtype=self.dtype, causal=True)


@dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    vision: ViTConfig = field(default_factory=lambda: ViTConfig(num_classes=0))
    text: CLIPTextConfig = field(default_factory=CLIPTextConfig)


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, embed_dim: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.hidden_dim, device=device)
        self.pos_embed = AddLearnedPositions(cfg.max_seq_len, cfg.hidden_dim, stddev=0.01, device=device)
        self.encoder = TransformerEncoder(cfg.encoder, device)
        self.proj = nn.Linear(cfg.hidden_dim, embed_dim, bias=False, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.pos_embed(F.embedding(tokens, self.token_embed.weight).to(self.cfg.dtype))
        x = self.encoder(x)
        # EOT = the first position of the highest token id in each row
        eot = tokens.argmax(dim=-1)
        feats = x[torch.arange(x.shape[0], device=x.device), eot]
        return self.proj(feats.float())


class CLIP(EncoderModel):
    """(images, tokens) -> (image_emb, text_emb, logit_scale); the embeddings
    are L2-normalised fp32 [B, embed_dim]."""

    def __init__(self, cfg: CLIPConfig, device=None, generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.visual = ViT(cfg.vision, device, generator)
        self.vision_proj = nn.Linear(cfg.vision.hidden_dim, cfg.embed_dim, bias=False, device=device)
        self.text = CLIPTextTower(cfg.text, cfg.embed_dim, device)
        # flax's scalar as a [1] tensor: FSDP2 shards no 0-dim parameter
        self.log_logit_scale = nn.Parameter(torch.full((1,), math.log(1 / 0.07), device=device))
        init_flax_style(self.vision_proj, generator)
        init_flax_style(self.text, generator)
        #: the processes whose rows make the global batch ``clip_loss``
        #: contrasts (None: this process alone)
        self.loss_group = None

    def apply_data_parallel(self, group) -> None:
        """Contrast the global batch: ``group`` is the data-parallel processes."""
        self.loss_group = group

    def flax_layout(self) -> list[tuple[tuple[str, ...], str, object]]:
        return [(path, name, "scalar" if name == "log_logit_scale" else how)
                for path, name, how in super().flax_layout()]

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return _l2_normalize(self.vision_proj(self.visual(images).float()))

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return _l2_normalize(self.text(tokens))

    def forward(self, images: torch.Tensor, tokens: torch.Tensor):
        scale = torch.clamp(torch.exp(self.log_logit_scale[0]), max=100.0)
        return self.encode_image(images), self.encode_text(tokens), scale


def _l2_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


class _GatherRows(torch.autograd.Function):
    """All-gather of ``[n, ...]`` rows over ``group`` into ``[world * n, ...]``
    in rank order; the backward sums the gradient over the ranks and returns
    this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        world = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.group, ctx.rank, ctx.n = group, dist.get_rank(group), x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of every rank of ``group``, stacked in rank order; differentiable
    (the gradient of this rank's rows is summed over the ranks)."""
    return _GatherRows.apply(x, group)


def clip_loss(image_emb: torch.Tensor, text_emb: torch.Tensor, logit_scale: torch.Tensor, group=None) -> torch.Tensor:
    """Symmetric InfoNCE. With ``group`` (the data-parallel processes), both
    embedding sets are gathered so that each local example contrasts against
    the GLOBAL batch, with labels offset by ``rank * local_batch``."""
    local = image_emb.shape[0]
    if group is None or dist.get_world_size(group) == 1:
        all_img, all_txt, offset = image_emb, text_emb, 0
    else:
        all_img, all_txt = gather_rows(image_emb, group), gather_rows(text_emb, group)
        offset = dist.get_rank(group) * local
    labels = torch.arange(local, device=image_emb.device) + offset
    logits_i = logit_scale * image_emb @ all_txt.T  # [local, global]
    logits_t = logit_scale * text_emb @ all_img.T
    return 0.5 * (F.cross_entropy(logits_i, labels) + F.cross_entropy(logits_t, labels))
