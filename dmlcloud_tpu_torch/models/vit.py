"""Vision Transformer: counterpart of ``dmlcloud_tpu/models/vit.py``
(``ViTConfig`` :28, ``ViT`` :55, ``ViT_S16``/``ViT_B16``/``ViT_L16`` :94-104).

The patch embedding is one VALID strided convolution over the NHWC images
(the ``permute`` to NCHW is a channels-last view); its ``[B, D, h, w]`` output
flattens to tokens in the reference's row-major (h, w) order. ``"cls"``
prepends a learned class token (zeros at init), ``"gap"`` averages the tokens;
``num_classes=0`` returns the pooled features (in ``cfg.dtype``: the CLIP image
tower). Attention is the reference's ``dot`` path (``ViTConfig.encoder`` sets
no ``attn_impl``). bf16 activations on fp32 parameters; the head is fp32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.runtime import resolve_device
from .encoder import (AddLearnedPositions, EncoderConfig, EncoderModel, TransformerEncoder, init_flax_style,
                      load_flax_params, to_flax_params)

__all__ = ["ViTConfig", "ViT", "ViT_S16", "ViT_B16", "ViT_L16", "load_flax_params", "to_flax_params"]


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    num_classes: int = 1000  # 0 => return pooled features (no head)
    pooling: str = "cls"  # 'cls' | 'gap'
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def encoder(self) -> EncoderConfig:
        return EncoderConfig(hidden_dim=self.hidden_dim, num_layers=self.num_layers, num_heads=self.num_heads,
                             mlp_dim=self.mlp_dim, dtype=self.dtype, causal=False, dropout_rate=self.dropout_rate)

    @property
    def num_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + (self.pooling == "cls")


class ViT(EncoderModel):
    """images [B, H, W, C] -> logits [B, num_classes] fp32 (or features)."""

    def __init__(self, cfg: ViTConfig, device=None, generator: torch.Generator | None = None):
        super().__init__()
        if cfg.pooling not in ("cls", "gap"):
            raise ValueError(f"unknown pooling {cfg.pooling!r}")
        device = resolve_device(device)
        self.cfg = cfg
        p, d = cfg.patch_size, cfg.hidden_dim
        self.patch_embed = nn.Conv2d(3, d, p, stride=p, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device)) if cfg.pooling == "cls" else None
        self.pos_embed = AddLearnedPositions(cfg.num_tokens, d, device=device)
        self.encoder = TransformerEncoder(cfg.encoder, device)
        self.head = nn.Linear(d, cfg.num_classes, device=device) if cfg.num_classes else None
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        init_flax_style(self, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b = images.shape[0]
        x = images.to(cfg.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW, a channels-last view
        w = self.patch_embed.weight.to(cfg.dtype, memory_format=torch.channels_last)
        x = F.conv2d(x, w, self.patch_embed.bias.to(cfg.dtype), stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)  # [B, h*w, D], row-major (h, w)
        if self.cls_token is not None:
            x = torch.cat([self.cls_token.to(cfg.dtype).expand(b, 1, -1), x], dim=1)
        x = self.encoder(self.pos_embed(x))
        pooled = x[:, 0] if cfg.pooling == "cls" else x.mean(dim=1)
        if self.head is None:
            return pooled
        return self.head(pooled.float())


def ViT_S16(device=None, generator: torch.Generator | None = None, **kw) -> ViT:
    return ViT(ViTConfig(patch_size=16, hidden_dim=384, num_layers=12, num_heads=6, mlp_dim=1536, **kw), device,
               generator)


def ViT_B16(device=None, generator: torch.Generator | None = None, **kw) -> ViT:
    return ViT(ViTConfig(patch_size=16, hidden_dim=768, num_layers=12, num_heads=12, mlp_dim=3072, **kw), device,
               generator)


def ViT_L16(device=None, generator: torch.Generator | None = None, **kw) -> ViT:
    return ViT(ViTConfig(patch_size=16, hidden_dim=1024, num_layers=24, num_heads=16, mlp_dim=4096, **kw), device,
               generator)
