"""Bidirectional transformer encoder core of the ViT, BERT and CLIP families:
counterpart of ``dmlcloud_tpu/models/encoder.py`` (``EncoderConfig`` :32,
``encoder_partition_rules`` :65, ``AddLearnedPositions`` :77,
``padding_mask_bias`` :104, ``EncoderAttention`` :109, ``EncoderMLP`` :158,
``EncoderBlock`` :169, ``TransformerEncoder`` :186).

Pre-LN blocks with a GELU MLP. The numbers follow the reference:

- dense layers keep fp32 parameters and take operands cast to ``cfg.dtype``
  per call, bias included (flax ``dtype=bf16, param_dtype=fp32``); the
  residual stream is in ``cfg.dtype``;
- LayerNorm computes in fp32 with flax's epsilon 1e-6 (torch's default is
  1e-5) and its output is cast to ``cfg.dtype`` before attention and the MLP;
- the GELU is flax's ``nn.gelu``, the tanh approximation;
- the dot path's scores are the operand-dtype einsum upcast to fp32, masked
  with ``NEG_INF = -1e30``, softmaxed in fp32 and cast to ``v``'s dtype;
- ``attn_impl="flash"`` sends a ``{0,1}`` keep-mask to the flash kernels as
  segment ids with ``causal=cfg.causal`` (``ops.flash_attention``: on a CUDA
  tensor the kernels, on a CPU tensor their plain versions). Pad positions
  then attend pads, not everything: their outputs differ from the dot path's
  and are masked downstream, as in the reference. An explicit ``mask_bias``
  goes to the dot path; passing both arguments raises.

Dropout (rate 0 by default) draws its masks from the encoder's own CPU
``torch.Generator`` (``dropout_generator``): one seed per block and call, from
which the block's device generator is made, so that a recomputed block
(``cfg.remat``, ``torch.utils.checkpoint``) draws the same masks. The masks
are not JAX's. Dropout and training mode follow the module's ``training``
flag.

The weight layout (``flax_layout``) is the reference's param tree; the same
rows drive ``load_flax_params``/``to_flax_params`` (``models.bridge``) and the
sharding rules of ``parallel.mesh``. FSDP2 wraps the blocks
(``fsdp_blocks``); a ``model`` (tensor-parallel) placement raises
``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from ..parallel.mesh import P
from .bridge import dump_tree, load_tree

__all__ = ["NEG_INF", "EncoderConfig", "encoder_partition_rules", "AddLearnedPositions", "padding_mask_bias",
           "EncoderAttention", "EncoderMLP", "EncoderBlock", "TransformerEncoder", "flax_layout_of",
           "init_flax_style", "load_flax_params", "to_flax_params"]

NEG_INF = -1e30

@dataclass(frozen=True)
class EncoderConfig:
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    dtype: torch.dtype = torch.bfloat16
    causal: bool = False
    dropout_rate: float = 0.0
    layer_norm_eps: float = 1e-6
    # recompute each block in the backward pass (torch.utils.checkpoint)
    remat: bool = False
    # 'dot' (einsum softmax) | 'flash' (the flash kernels; a {0,1} keep-mask
    # rides as segment ids, an explicit mask_bias goes to 'dot' per call)
    attn_impl: str = "dot"

    def __post_init__(self):
        if self.attn_impl not in ("dot", "flash"):
            # a typo here would otherwise silently run the unfused path
            raise ValueError(f"attn_impl must be 'dot' or 'flash', got {self.attn_impl!r}")

    @property
    def head_dim(self) -> int:
        if self.hidden_dim % self.num_heads:
            raise ValueError(f"hidden_dim {self.hidden_dim} is not divisible by num_heads {self.num_heads}")
        return self.hidden_dim // self.num_heads


def encoder_partition_rules() -> list[tuple[str, P]]:
    """The reference's T5X-style rules for the encoder family (ViT / BERT /
    CLIP towers), matched against the flax paths."""
    return [
        ("attn/(q|k|v)_proj/kernel", P("fsdp", "model")),
        ("attn/o_proj/kernel", P("model", None, "fsdp")),
        ("mlp/fc_in/kernel", P("fsdp", "model")),
        ("mlp/fc_out/kernel", P("model", "fsdp")),
        ("(^|/)embedding$", P("fsdp", "model")),  # nn.Embed tables only, not pos_embedding
        (".*", P()),
    ]


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense with ``dtype``: operands and bias cast to ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _dropout(x: torch.Tensor, rate: float, seed: int | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale by its
    inverse; ``seed`` None is the deterministic (no-op) path."""
    if seed is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class AddLearnedPositions(nn.Module):
    """``x + pos[:, :T]`` with a learned fp32 table ``[1, max_len, D]``; rejects
    sequences longer than ``max_len``."""

    def __init__(self, max_len: int, dim: int, stddev: float = 0.02, device=None):
        super().__init__()
        self.max_len, self.stddev = max_len, stddev
        self.pos_embedding = nn.Parameter(torch.zeros(1, max_len, dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len {self.max_len}")
        return x + self.pos_embedding[:, :t].to(x.dtype)


def padding_mask_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] {0,1} keep-mask -> additive fp32 bias [B, 1, 1, S]."""
    keep = attention_mask[:, None, None, :].bool()
    return torch.where(keep, 0.0, NEG_INF).to(torch.float32)


class EncoderModel(nn.Module):
    """What every model of the encoder families shares: its flax layout, the
    blocks FSDP2 wraps, and the refusal of tensor parallelism."""

    def flax_layout(self) -> list[tuple[tuple[str, ...], str, object]]:
        return flax_layout_of(self)

    def fsdp_blocks(self) -> list[nn.Module]:
        return [m for m in self.modules() if isinstance(m, EncoderBlock)]

    def apply_tensor_parallel(self, tp, dims: dict[str, int]) -> None:
        raise NotImplementedError(f"{sorted(dims)[0]} has a 'model' placement: tensor parallelism of the encoder "
                                  "family is not ported yet (ROADMAP Queue 1 item 11)")


class EncoderAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        self.q_proj = nn.Linear(d, d, device=device)
        self.k_proj = nn.Linear(d, d, device=device)
        self.v_proj = nn.Linear(d, d, device=device)
        self.o_proj = nn.Linear(d, d, device=device)

    def forward(self, x, mask_bias=None, keep_mask=None):
        cfg = self.cfg
        b, t, _ = x.shape
        h, hd = cfg.num_heads, cfg.head_dim
        q = _dense(x, self.q_proj, cfg.dtype).view(b, t, h, hd)
        k = _dense(x, self.k_proj, cfg.dtype).view(b, t, h, hd)
        v = _dense(x, self.v_proj, cfg.dtype).view(b, t, h, hd)
        if mask_bias is not None and keep_mask is not None:
            # a silent ignore would let pad keys leak into a custom-bias call
            raise ValueError("pass either mask_bias or keep_mask, not both")
        if cfg.attn_impl == "flash" and mask_bias is None:
            seg = None if keep_mask is None else keep_mask.to(torch.int32)
            out = flash_attention(q, k, v, causal=cfg.causal, segment_ids=seg)
        else:
            if mask_bias is None and keep_mask is not None:
                mask_bias = padding_mask_bias(keep_mask)
            scores = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(hd)
            if cfg.causal:
                causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
                scores = torch.where(causal, scores, NEG_INF)
            if mask_bias is not None:
                scores = scores + mask_bias
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            out = torch.einsum("bhts,bshd->bthd", probs, v)
        return _dense(out.reshape(b, t, h * hd), self.o_proj, cfg.dtype)


class EncoderMLP(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.fc_in = nn.Linear(cfg.hidden_dim, cfg.mlp_dim, device=device)
        self.fc_out = nn.Linear(cfg.mlp_dim, cfg.hidden_dim, device=device)

    def forward(self, x):
        dt = self.cfg.dtype
        return _dense(F.gelu(_dense(x, self.fc_in, dt), approximate="tanh"), self.fc_out, dt)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = nn.LayerNorm(cfg.hidden_dim, eps=cfg.layer_norm_eps, device=device)
        self.attn = EncoderAttention(cfg, device)
        self.mlp_norm = nn.LayerNorm(cfg.hidden_dim, eps=cfg.layer_norm_eps, device=device)
        self.mlp = EncoderMLP(cfg, device)

    def forward(self, x, mask_bias=None, keep_mask=None, seed: int | None = None):
        """``seed`` (None: no dropout) seeds this call's two dropout masks."""
        cfg = self.cfg
        rate = cfg.dropout_rate
        s1, s2 = (None, None) if seed is None else (seed, seed + 1)
        x = x + _dropout(self.attn(self.attn_norm(x.float()).to(cfg.dtype), mask_bias, keep_mask), rate, s1)
        return x + _dropout(self.mlp(self.mlp_norm(x.float()).to(cfg.dtype)), rate, s2)


class TransformerEncoder(EncoderModel):
    """Stack of pre-LN encoder blocks + final LayerNorm: ``x`` [B, T, D]
    embeddings -> [B, T, D] in ``cfg.dtype``."""

    def __init__(self, cfg: EncoderConfig, device=None, dropout_seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(EncoderBlock(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = nn.LayerNorm(cfg.hidden_dim, eps=cfg.layer_norm_eps, device=device)
        self.dropout_generator = torch.Generator().manual_seed(dropout_seed)

    def forward(self, x, mask_bias=None, keep_mask=None):
        cfg = self.cfg
        dropping = self.training and cfg.dropout_rate > 0.0
        for layer in self.layers:
            seed = int(torch.randint(0, 2**62, (1,), generator=self.dropout_generator)) if dropping else None
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, mask_bias, keep_mask, seed, use_reentrant=False)
            else:
                x = layer(x, mask_bias, keep_mask, seed)
        return self.final_norm(x.float()).to(cfg.dtype)


# ---------------------------------------------------------------------------
# initialisation and the flax layout, shared by the encoder families
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_flax_style(module: nn.Module, generator: torch.Generator) -> None:
    """flax's initializer families for every submodule of ``module``:
    LeCun-normal (truncated) dense and conv kernels with zero biases, normal
    embeddings with std 1/sqrt(features), LayerNorm scale 1 and bias 0,
    learned positions normal with their ``stddev``. Other parameters (class
    token, biases of heads, the logit scale) are the caller's."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim), generator=generator)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, AddLearnedPositions):
            m.pos_embedding.normal_(0.0, m.stddev, generator=generator)


def _module_rows(name: str, module: nn.Module, flax: tuple[str, ...], head_dim: int | None) -> list:
    rows = []
    prefix = f"{name}." if name else ""
    if isinstance(module, nn.Linear):
        leaf = flax[-1]
        if leaf in ("q_proj", "k_proj", "v_proj"):
            kernel, bias = ("heads", head_dim), ("heads_bias", head_dim)
        elif leaf == "o_proj":
            kernel, bias = ("heads_out", head_dim), "same"
        else:
            kernel, bias = "t", "same"
        rows.append((flax + ("kernel",), prefix + "weight", kernel))
        if module.bias is not None:
            rows.append((flax + ("bias",), prefix + "bias", bias))
    elif isinstance(module, nn.Conv2d):
        rows.append((flax + ("kernel",), prefix + "weight", "conv"))
        if module.bias is not None:
            rows.append((flax + ("bias",), prefix + "bias", "same"))
    elif isinstance(module, nn.LayerNorm):
        rows += [(flax + ("scale",), prefix + "weight", "same"), (flax + ("bias",), prefix + "bias", "same")]
    elif isinstance(module, nn.Embedding):
        rows.append((flax + ("embedding",), prefix + "weight", "same"))
    else:
        for pname, _ in module.named_parameters(recurse=False):
            rows.append((flax + (pname,), prefix + pname, "same"))
    return rows


#: torch attribute names that cannot be flax's (``nn.Module.type`` is a method)
_FLAX_NAMES = {"type_embed": "type"}


def flax_layout_of(model: nn.Module) -> list[tuple[tuple[str, ...], str, object]]:
    """(flax path, parameter name, transform) of every parameter of a model
    of the encoder families, whose submodules carry the reference's names
    (``layers.i`` is flax's ``layer_i``; ``_FLAX_NAMES``)."""
    rows = []
    head_dim = None
    for name, module in model.named_modules():
        if isinstance(module, EncoderAttention):
            head_dim = module.cfg.head_dim
        parts = name.split(".") if name else []
        flax: list[str] = []
        for i, part in enumerate(parts):
            if part.isdigit() and i > 0 and parts[i - 1] == "layers":
                flax[-1] = f"layer_{part}"
            else:
                flax.append(_FLAX_NAMES.get(part, part))
        rows += _module_rows(name, module, tuple(flax), head_dim)
    return rows


@torch.no_grad()
def load_flax_params(model: nn.Module, tree: dict, tensors: dict[str, torch.Tensor] | None = None) -> nn.Module:
    """Copy a JAX encoder-family model's params (nested dicts of numpy arrays,
    with or without the top-level ``"params"`` key) into ``model``, or into
    ``tensors`` by parameter name (e.g. the EMA shadow)."""
    load_tree(tree.get("params", tree), model.flax_layout(),
              dict(model.named_parameters()) if tensors is None else tensors)
    return model


@torch.no_grad()
def to_flax_params(model: nn.Module, tensors: dict[str, torch.Tensor] | None = None) -> dict:
    """The inverse of ``load_flax_params``: the params tree (float32 numpy
    arrays) from ``model``'s parameters or from ``tensors`` by parameter name
    (e.g. the gradients). A sharded model's parameters are gathered."""
    return dump_tree(model.flax_layout(), dict(model.named_parameters()) if tensors is None else tensors)

