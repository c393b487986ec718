"""ResNet v1.5 (18/34/50/101/152): counterpart of ``dmlcloud_tpu/models/resnet.py``
(``BottleneckBlock`` :26, ``BasicBlock`` :52, ``ResNet`` :75 and the
``ResNet18``-``ResNet152`` partials :118-122).

The module keeps the reference's contract and numbers where a port that looks
right would compute something else:

- **NHWC in.** ``forward`` takes the reference's ``[B, H, W, C]`` images. The
  ``permute`` to NCHW is a view in ``torch.channels_last`` layout, with no
  copy, and the convolutions take their bf16 weights in that layout too (the
  cast per call writes it), so cuDNN runs them channels-last throughout. The
  fp32 parameters themselves stay contiguous, which the data-parallel bucket
  collectives need.
- **flax's ``padding="SAME"``.** For a kernel ``k`` and stride ``s`` on ``n``
  pixels it pads ``(p // 2, p - p // 2)`` with ``p = max((ceil(n/s) - 1) * s +
  k - n, 0)``: the stride-2 3x3 convolution of an even input pads (0, 1),
  which ``Conv2d(padding=1)`` does not compute. Asymmetric padding goes
  through ``F.pad``. The 7x7 stem (3, 3) and the max pool ((1, 1), -inf) are
  symmetric, as in the reference.
- **BatchNorm as flax computes it** (``momentum=0.9``, ``eps=1e-5``): fp32
  statistics, normalisation by the BIASED batch variance, the output in the
  compute dtype, and the running averages ``ra = 0.9 * ra + 0.1 * batch`` of
  that biased variance (``nn.BatchNorm2d`` would average the unbiased one,
  n/(n-1) larger). On one card the batch is normalised by torch's fused
  ``native_batch_norm`` (one statistics pass and one elementwise pass each
  way; the variance for the running average comes back from its
  ``1/sqrt(var + eps)``), and the module updates the running averages itself.
  On the CPU, and over a process group, ``_BatchNormFn`` computes the same in
  fp32 torch ops: torch's CPU kernel sums in a less accurate order (ResNet-50's
  gradients 1.6e-4 from float64 at 32x32, against 5e-6). The last BatchNorm
  of each block starts at scale 0.
- **Global statistics under data parallelism.** The reference's replicated
  step is one program over the global batch, so its batch statistics are the
  global batch's. Each process of the port feeds its own rows: after
  ``apply_data_parallel(group)`` (``TrainingPipeline.register_model`` calls it
  at world size > 1) every BatchNorm sums ``[sum x, sum x^2, count]`` over
  ``group`` in the forward and ``[sum dy, sum dy * xhat]`` in the backward
  (``_BatchNormFn``, fp32 torch ops), which gives each process the gradient of
  the global loss once the stage averages the parameter gradients. At world
  size 1 there is no collective.
- bf16 compute on fp32 parameters (flax ``dtype=bf16``): convolutions take
  bf16 operands, the residual stream and the global average pool stay in
  bf16, the head is fp32.

Training mode is the module's ``training`` flag (the reference's
``train=True``, its default; ``model.eval()`` is ``train=False``). Parameters
live on ``device`` (default ``cuda``; raises without a card unless
``device="cpu"``), initialised from ``generator`` (default: seed 0 on that
device) with flax's initializer families: LeCun-normal kernels, BatchNorm
scale 1 (0 for each block's last), biases 0.

``load_flax_params(model, variables)`` takes the JAX model's variables (``params``
and ``batch_stats``, numpy arrays); ``to_flax_params(model)`` gives them back.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.runtime import resolve_device
from .bridge import dump_tree, load_tree

__all__ = ["BatchNorm", "BasicBlock", "BottleneckBlock", "ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "ResNet152", "same_padding", "load_flax_params", "to_flax_params"]


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """flax's ``padding="SAME"`` on one spatial dim of ``n``: (before, after)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _synced(group) -> bool:
    return group is not None and dist.is_available() and dist.is_initialized() and dist.get_world_size(group) > 1


class _BatchNormFn(torch.autograd.Function):
    """Training-mode BatchNorm over dims (0, 2, 3) with flax's arithmetic,
    statistics summed over ``group`` (None: this process alone). Returns
    ``(y, mean, var)``; only ``y`` is differentiable. Saves the input in its
    own dtype and recomputes the fp32 normalised values in the backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, group):
        c = x.shape[1]
        x32 = x.float()
        count = x.numel() // c
        stats = torch.cat([x32.sum((0, 2, 3)), x32.square().sum((0, 2, 3)),
                           torch.full((1,), float(count), device=x.device)])
        sync = _synced(group)
        if sync:
            dist.all_reduce(stats, group=group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean.square(), min=0.0)
        invstd = torch.rsqrt(var + eps)
        shape = (1, c, 1, 1)
        y = ((x32 - mean.view(shape)) * (invstd * weight).view(shape) + bias.view(shape)).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group if sync else None
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        shape = (1, c, 1, 1)
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        dy32 = dy.float()
        sums = torch.cat([dy32.sum((0, 2, 3)), (dy32 * xhat).sum((0, 2, 3))])
        # the parameters' gradients are this process's part; the stage averages them
        dbias, dweight = sums[:c].clone(), sums[c:].clone()
        if ctx.group is not None:
            dist.all_reduce(sums, group=ctx.group)
        dx = (dy32 - (sums[:c] / n).view(shape) - xhat * (sums[c:] / n).view(shape)) * (weight * invstd).view(shape)
        return dx.to(x.dtype), dweight, dbias, None, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of an NCHW tensor: parameters
    ``weight`` (flax ``scale``) and ``bias``, persistent buffers
    ``running_mean`` and ``running_var`` (flax ``batch_stats`` ``mean``/``var``).
    ``group`` (set by ``ResNet.apply_data_parallel``) is the process group the
    training statistics are summed over."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5, zero_scale: bool = False,
                 device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.full((channels,), 0.0 if zero_scale else 1.0, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        if _synced(self.group) or not x.is_cuda:
            y, mean, var = _BatchNormFn.apply(x, self.weight, self.bias, self.eps, self.group)
        else:
            # no running statistics passed: torch's own update would average the unbiased variance
            y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            var = torch.clamp(invstd.detach().reciprocal().square() - self.eps, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y


def _conv2d(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1, padding: tuple[int, int] | None = None):
    """``conv`` on ``x`` in ``x``'s dtype, channels-last, with flax's SAME
    padding unless ``padding`` gives a symmetric one."""
    k = conv.kernel_size[0]
    w = conv.weight.to(x.dtype, memory_format=torch.channels_last)
    if padding is None:
        ph, pw = same_padding(x.shape[2], k, stride), same_padding(x.shape[3], k, stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1])).contiguous(memory_format=torch.channels_last)
            padding = (0, 0)
    return F.conv2d(x, w, None, stride, padding)


def _conv(cin: int, cout: int, k: int, device) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, bias=False, device=device)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, device=None):
        super().__init__()
        cout = filters * self.expansion
        self.stride = stride
        self.convs = nn.ModuleList([_conv(cin, filters, 1, device), _conv(filters, filters, 3, device),
                                    _conv(filters, cout, 1, device)])
        self.norms = nn.ModuleList([BatchNorm(filters, device=device), BatchNorm(filters, device=device),
                                    BatchNorm(cout, zero_scale=True, device=device)])
        self.conv_proj = self.norm_proj = None
        if stride != 1 or cin != cout:
            self.conv_proj = _conv(cin, cout, 1, device)
            self.norm_proj = BatchNorm(cout, device=device)

    def forward(self, x):
        y = F.relu(self.norms[0](_conv2d(x, self.convs[0])))
        y = F.relu(self.norms[1](_conv2d(y, self.convs[1], self.stride)))
        y = self.norms[2](_conv2d(y, self.convs[2]))
        residual = x if self.conv_proj is None else self.norm_proj(_conv2d(x, self.conv_proj, self.stride))
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, device=None):
        super().__init__()
        self.stride = stride
        self.convs = nn.ModuleList([_conv(cin, filters, 3, device), _conv(filters, filters, 3, device)])
        self.norms = nn.ModuleList([BatchNorm(filters, device=device),
                                    BatchNorm(filters, zero_scale=True, device=device)])
        self.conv_proj = self.norm_proj = None
        if stride != 1 or cin != filters:
            self.conv_proj = _conv(cin, filters, 1, device)
            self.norm_proj = BatchNorm(filters, device=device)

    def forward(self, x):
        y = F.relu(self.norms[0](_conv2d(x, self.convs[0], self.stride)))
        y = self.norms[1](_conv2d(y, self.convs[1]))
        residual = x if self.conv_proj is None else self.norm_proj(_conv2d(x, self.conv_proj, self.stride))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """images ``[B, H, W, in_channels]`` -> logits ``[B, num_classes]`` fp32.
    flax's ``nn.Conv`` takes its input channels from the first batch; here
    they are ``in_channels`` (3 unless given)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls: type, num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, device=None, generator: torch.Generator | None = None,
                 in_channels: int = 3):
        super().__init__()
        device = resolve_device(device)
        self.stage_sizes, self.block_cls, self.dtype = list(stage_sizes), block_cls, dtype
        self.conv_init = nn.Conv2d(in_channels, num_filters, 7, bias=False, device=device)
        self.bn_init = BatchNorm(num_filters, device=device)
        blocks, cin = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, num_filters * 2**i, stride, device=device))
                cin = num_filters * 2**i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes, device=device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                # lecun_normal: truncated normal, std 1/sqrt(fan_in) after truncation
                std = math.sqrt(1.0 / module.weight[0].numel()) / 0.87962566103423978
                nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        self.head.bias.zero_()

    def apply_data_parallel(self, group) -> None:
        """Sum every BatchNorm's training statistics over ``group`` (the
        data-parallel processes; None: each process alone)."""
        for module in self.modules():
            if isinstance(module, BatchNorm):
                module.group = group

    def flax_layout(self) -> list[tuple[tuple[str, ...], str, object]]:
        """(flax path, parameter name, transform) of every parameter."""
        return [(path[1:], name, how) for path, name, how in _layout(self) if path[0] == "params"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW, a channels-last view
        x = F.relu(self.bn_init(_conv2d(x, self.conv_init, 2, padding=(3, 3))))
        x = F.max_pool2d(x, 3, 2, 1)
        for block in self.blocks:
            x = block(x)
        x = x.mean((2, 3))
        return F.linear(x.float(), self.head.weight, self.head.bias)


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3], block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3], block_cls=BottleneckBlock)


# ---------------------------------------------------------------------------
# carrying weights across: the JAX ResNet's variables <-> this module
# ---------------------------------------------------------------------------

def _norm_rows(flax: tuple[str, ...], name: str) -> list:
    return [(("params",) + flax + ("scale",), f"{name}.weight", "same"),
            (("params",) + flax + ("bias",), f"{name}.bias", "same"),
            (("batch_stats",) + flax + ("mean",), f"{name}.running_mean", "same"),
            (("batch_stats",) + flax + ("var",), f"{name}.running_var", "same")]


def _layout(model: ResNet) -> list:
    """(path in the variables, parameter or buffer name, transform) of
    everything the JAX model's ``params`` and ``batch_stats`` hold."""
    rows = [(("params", "conv_init", "kernel"), "conv_init.weight", "conv"), *_norm_rows(("bn_init",), "bn_init")]
    kind = model.block_cls.__name__
    for i, block in enumerate(model.blocks):
        flax, port = f"{kind}_{i}", f"blocks.{i}"
        for k in range(len(block.convs)):
            rows.append((("params", flax, f"Conv_{k}", "kernel"), f"{port}.convs.{k}.weight", "conv"))
            rows += _norm_rows((flax, f"BatchNorm_{k}"), f"{port}.norms.{k}")
        if block.conv_proj is not None:
            rows.append((("params", flax, "conv_proj", "kernel"), f"{port}.conv_proj.weight", "conv"))
            rows += _norm_rows((flax, "norm_proj"), f"{port}.norm_proj")
    rows += [(("params", "Dense_0", "kernel"), "head.weight", "t"), (("params", "Dense_0", "bias"), "head.bias", "same")]
    return rows


@torch.no_grad()
def load_flax_params(model: ResNet, variables: dict) -> ResNet:
    """Copy the JAX ``ResNet``'s variables (``{"params", "batch_stats"}``,
    nested dicts of numpy arrays) into ``model``'s parameters and running
    statistics."""
    load_tree(variables, _layout(model), {**dict(model.named_parameters()), **dict(model.named_buffers())})
    return model


@torch.no_grad()
def to_flax_params(model: ResNet, tensors: dict[str, torch.Tensor] | None = None) -> dict:
    """The inverse of ``load_flax_params``: ``{"params", "batch_stats"}`` as
    float32 numpy arrays; with ``tensors`` (by parameter name, e.g. the
    gradients) only ``{"params"}`` from them."""
    if tensors is not None:
        return dump_tree([r for r in _layout(model) if r[0][0] == "params"], tensors)
    return dump_tree(_layout(model), {**dict(model.named_parameters()), **dict(model.named_buffers())})
