"""The MNIST convnet of the example pair: counterpart of
``dmlcloud_tpu/models/cnn.py`` (``MnistCNN`` :14), conv(32) -> conv(64) ->
maxpool -> dense(128) -> dense(10).

The module takes the reference's NHWC batch ``[B, 28, 28, 1]``, runs the
convolutions in torch's NCHW layout and goes back to NHWC before the flatten,
so that the first dense layer reads its 12,544 inputs in flax's (H, W, C)
order. The convolutions pad by 1, flax's ``padding="SAME"`` for a 3x3 kernel.
With ``dtype`` below fp32 the layers compute in it from fp32 parameters; the
last layer stays fp32, as in the reference. Parameters are initialised as
flax initialises them (LeCun-normal kernels, zero biases) from ``generator``
(default: seed 0) on the CPU, unless ``device`` names another device: the same
seed gives the same weights whatever device the pipeline then moves them to.

``load_flax_params(model, tree)`` and ``to_flax_params(model)`` bridge the
weights: conv kernels HWIO <-> OIHW, dense kernels ``[in, out]`` <-> ``[out, in]``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["MnistCNN", "load_flax_params", "to_flax_params"]


class MnistCNN(torch.nn.Module):
    """conv(32) -> conv(64) -> maxpool -> dense(128) -> dense(10), on NHWC input."""

    def __init__(self, num_classes: int = 10, dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.conv_0 = torch.nn.Conv2d(1, 32, 3, padding=1, device=device)
        self.conv_1 = torch.nn.Conv2d(32, 64, 3, padding=1, device=device)
        self.dense_0 = torch.nn.Linear(14 * 14 * 64, 128, device=device)
        self.dense_1 = torch.nn.Linear(128, num_classes, device=device)
        if generator is None:
            generator = torch.Generator(device=self.conv_0.weight.device).manual_seed(0)
        with torch.no_grad():
            for layer in (self.conv_0, self.conv_1, self.dense_0, self.dense_1):
                # flax's lecun_normal: a normal truncated at 2 std, rescaled to variance 1 / fan_in
                std = (1.0 / layer.weight[0].numel()) ** 0.5 / 0.87962566103423978
                torch.nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
                layer.bias.zero_()

    def _cast(self, layer: torch.nn.Module) -> tuple[torch.Tensor, torch.Tensor]:
        return layer.weight.to(self.dtype), layer.bias.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(F.conv2d(x, *self._cast(self.conv_0), padding=1))
        x = F.relu(F.conv2d(x, *self._cast(self.conv_1), padding=1))
        x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in flax's (H, W, C) order
        x = F.relu(F.linear(x, *self._cast(self.dense_0)))
        return F.linear(x.float(), self.dense_1.weight.float(), self.dense_1.bias.float())


#: (flax module, torch module, kernel layout)
_LAYOUT = [("Conv_0", "conv_0", "conv"), ("Conv_1", "conv_1", "conv"),
           ("Dense_0", "dense_0", "dense"), ("Dense_1", "dense_1", "dense")]


@torch.no_grad()
def load_flax_params(model: MnistCNN, tree: dict) -> MnistCNN:
    """Copy the JAX ``MnistCNN``'s params (a nested dict of numpy arrays, with
    or without the top-level ``"params"`` key) into ``model``."""
    tree = tree.get("params", tree)
    for flax_name, name, how in _LAYOUT:
        kernel = np.asarray(tree[flax_name]["kernel"], np.float32)
        kernel = kernel.transpose(3, 2, 0, 1) if how == "conv" else kernel.T
        layer = getattr(model, name)
        for param, arr in ((layer.weight, kernel), (layer.bias, np.asarray(tree[flax_name]["bias"], np.float32))):
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"{flax_name}: shape {arr.shape} does not fit {name} {tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.array(arr, np.float32, order="C")))
    return model


@torch.no_grad()
def to_flax_params(model: MnistCNN, tensors: dict[str, torch.Tensor] | None = None) -> dict:
    """The inverse of ``load_flax_params``: a nested dict of float32 numpy
    arrays in the JAX ``MnistCNN``'s layout, from ``model``'s parameters or
    from ``tensors`` by parameter name in their layout (e.g. the gradients)."""
    params = dict(model.named_parameters() if tensors is None else tensors)
    tree = {}
    for flax_name, name, how in _LAYOUT:
        kernel = params[f"{name}.weight"].detach().float().cpu().numpy()
        kernel = kernel.transpose(2, 3, 1, 0) if how == "conv" else kernel.T
        # copies: a CPU tensor's .numpy() would alias the live parameter
        tree[flax_name] = {"kernel": np.array(kernel, order="C"),
                           "bias": np.array(params[f"{name}.bias"].detach().float().cpu().numpy())}
    return tree
