"""The port's flash attention in bf16 at the head dims of the tensor-core kernels.

The tensor-core kernels (``csrc/flash_attention_tc.cu``) take bf16 with head
dim 64 or 128; on the card ``chip_smoke.py`` holds them against the plain
PyTorch versions. Here, on the CPU, those plain versions go against the JAX
package's ``flash_attention`` (both lowerings) at those head dims, with GQA
and windows, on the same numpy inputs and within ``TOL`` bf16.
"""

import pytest
import torch
from test_torch_flash_attention import LOWERINGS, TOL, _arrays, _assert_all_close, _jax_fwd_grads, _port_fwd_grads

from dmlcloud_tpu.ops.flash_attention import flash_attention as jax_flash
from dmlcloud_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)


@pytest.mark.parametrize("lowering", sorted(LOWERINGS))
@pytest.mark.parametrize("window", [None, 24], ids=["causal", "window24"])
@pytest.mark.parametrize("h,kh", [(4, 2), (8, 1)], ids=["gqa4to2", "gqa8to1"])
@pytest.mark.parametrize("d", [64, 128], ids=lambda d: f"d{d}")
def test_bf16_at_the_tensor_core_head_dims(d, h, kh, window, lowering):
    """bf16 at the head dims the tensor-core kernels take: the plain versions,
    which are those kernels' oracle on the card, against JAX at real widths."""
    arrays = _arrays(b=1, t=128, h=h, kh=kh, d=d)
    port = _port_fwd_grads(lambda q, k, v: fa.flash_attention(q, k, v, causal=True, window=window), arrays, "bf16")
    ref = _jax_fwd_grads(lambda q, k, v: jax_flash(q, k, v, causal=True, window=window, **LOWERINGS[lowering]),
                         arrays, "bf16")
    _assert_all_close(port, ref, TOL["bf16"], f"bf16 d{d} {h}->{kh} vs jax {lowering}")
