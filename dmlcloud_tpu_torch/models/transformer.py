"""Decoder-only transformer LM (Llama-style), training path.

Counterpart of ``dmlcloud_tpu/models/transformer.py``: ``TransformerConfig``
(:31), ``RMSNorm`` (:113), ``rope_frequencies`` (:124), ``apply_rope`` (:163),
``_dot_attention`` (:188), ``Attention`` (:232; the dense no-cache branch and
the packed ``segment_ids`` branch), ``MLP`` (:371), ``DecoderBlock`` (:388),
``DecoderLM`` (:435), ``lm_loss`` (:642) and ``_packed_mean`` (:658), with the
decode modes of ``Attention``/``DecoderBlock``/``DecoderLM`` (:236-368,
:393-432, :458-568): a dense KV cache stepped at ``offset`` with bounded reads
(``attend_len``) and left-padded ragged prompts (``pad_len``), and paged
decode through a block pool (``pages``, ``ops/paged_attention.py``). Every
projection is a quant-aware dense layer (``models/quant.py`` ``QuantDense``/
``QuantDenseGeneral``, the reference's :240-251, :362-367, :376-385,
:554-560): a plain weight multiplies as before, an int8 ``QuantizedTensor``
(``quantize_tree``) through the fused int8 dot, and under
``TrainValStage(precision="int8")`` through ``quant_train_dot``. Per-row LoRA
adapters (``adapters=(stacked_tree, ids)``, ``_adapter_add``, :210-228) add
each row's own delta in the dense and decode modes. With ``num_experts > 0``
every ``moe_every``-th block holds a Mixture-of-Experts MLP
(``models/moe.py`` ``MoEMLP``, the reference's :416-429) in the place of the
dense one, in every mode; its auxiliary loss is read after the forward with
``moe.total_aux_loss(model)``.

A cache is the reference's tree, ``{"layer_i": {"k", "v"}}``, and is written
IN PLACE: the JAX model returns an updated copy (``dynamic_update_slice``, a
paged scatter), the port writes the slots into the tensors it was given and
returns the same tree. A caller that needs the old contents (beam search's
reorder) copies first.

On a mesh (``parallel.mesh.shard_module``) the model runs tensor parallel
over ``model`` (heads, the MLP's and the experts' hidden dims, the
embedding's features, the LM head's vocab; ``apply_tensor_parallel``) in
every mode, the decode modes on a cache of the rank's KV heads
(``local_kv_heads``) and per-row adapters on the rank's slices of their
factors; and expert parallel over ``expert`` (``apply_expert_parallel``).

``attn_impl="ring"`` runs attention as ring attention over the ``seq`` axis
(``cfg.seq_axis``) of the mesh the model is registered on
(``apply_sequence_parallel``, which ``parallel.mesh.shard_module`` calls):
everything outside attention stays replicated over ``seq`` (RoPE on global
positions), and each ``seq`` peer ends the forward with the same activations.

The numerics follow the reference, where a port that looks right would
compute something else:

- dense layers keep fp32 parameters and cast operands to ``cfg.dtype`` per
  call, so their results are in ``cfg.dtype`` (flax ``dtype=bf16,
  param_dtype=fp32``); the residual stream stays in ``cfg.dtype``;
- ``RMSNorm`` computes in fp32 with eps 1e-6 and casts back to the input dtype;
- ``apply_rope`` rotates INTERLEAVED pairs ``(x[..., ::2], x[..., 1::2])``
  and re-interleaves them (not the half-split ``rotate_half``);
- ``_dot_attention`` takes its softmax in fp32 and casts the probabilities
  to ``v.dtype``; its score einsum rounds to the operand dtype first;
- the LM head upcasts the hidden state and computes fp32 logits;
- on packed rows, rotary positions restart at each segment, and only the raw
  segment ids go to the flash kernels.

``load_flax_params``/``to_flax_params`` carry weights between this module and
the JAX ``DecoderLM``'s param tree (numpy arrays).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import gather_pages, scatter_tokens, write_index
from ..ops.ring_attention import ring_attention_sharded, seq_group
from ..parallel.runtime import resolve_device
from ..parallel.tensor_parallel import ModelGroup, copy_to_model, gather_from_model, local_tensor, reduce_from_model
from .bridge import Row, dump_tree, load_tree
from .moe import MoEMLP, moe_partition_rules
from .quant import QuantDense, QuantDenseGeneral, _dump_quantized, _load_quantized


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 8
    num_heads: int = 8
    num_kv_heads: int | None = None  # None => MHA; < num_heads => GQA
    head_dim: int = 64
    hidden_dim: int = 512
    mlp_dim: int = 1408  # ~8/3 * hidden, SwiGLU convention
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    # ("linear", factor) or ("llama3", factor, low_freq_factor, high_freq_factor, original_len)
    rope_scaling: tuple | None = None
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    attn_impl: str = "dot"  # 'dot' | 'flash' | 'ring'
    # Sliding-window attention (Mistral convention): each token attends to
    # itself + the previous W-1.
    sliding_window: int | None = None
    # MoE: every ``moe_every``-th block holds an MoEMLP (models/moe.py) in the
    # place of the dense MLP (0 experts = dense everywhere); experts shard over
    # the ``expert`` mesh axis by moe_partition_rules()
    num_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # recompute each block in the backward pass (torch.utils.checkpoint)
    remat: bool = False
    seq_axis: str = "seq"  # mesh axis used when attn_impl == 'ring'
    # The reference's residual-stream sharding constraint (with_sharding_constraint
    # after the embedding and every block): a layout hint to XLA's sharding
    # propagation that changes no value. Eager torch lays activations out by the
    # code that makes them, so the field is accepted and changes nothing.
    act_sharding: object = None

    def __post_init__(self):
        if self.attn_impl not in ("dot", "flash", "ring"):
            raise ValueError(f"attn_impl must be 'dot', 'flash' or 'ring', got {self.attn_impl!r}")
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError(f"sliding_window must be >= 1, got {self.sliding_window}")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    def is_moe(self, i: int) -> bool:
        """Whether block ``i`` holds an MoE MLP (the reference's :527)."""
        return self.num_experts > 0 and self.moe_every > 0 and i % self.moe_every == self.moe_every - 1

    def moe_config(self):
        from .moe import MoEConfig

        return MoEConfig(num_experts=self.num_experts, top_k=self.moe_top_k,
                         capacity_factor=self.moe_capacity_factor, hidden_dim=self.hidden_dim,
                         mlp_dim=self.mlp_dim, dtype=self.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        normed = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (normed * local_tensor(self.weight)).to(x.dtype)


def rope_frequencies(
    head_dim: int, max_len: int, theta: float, scaling: tuple | None = None, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary cos/sin tables [max_len, head_dim/2] in fp32; ``scaling``
    applies linear or Llama-3 context extension to the base frequencies."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    if scaling is not None:
        kind = scaling[0]
        if kind == "linear":
            freqs = freqs / float(scaling[1])
        elif kind == "llama3":
            _, factor, low_ff, high_ff, orig_len = scaling
            wavelen = 2.0 * math.pi / freqs
            low_wl = orig_len / float(low_ff)
            high_wl = orig_len / float(high_ff)
            smooth = (orig_len / wavelen - low_ff) / (high_ff - low_ff)
            freqs = torch.where(
                wavelen > low_wl,
                freqs / factor,  # long wavelengths: fully interpolated
                torch.where(wavelen < high_wl, freqs, (1 - smooth) * freqs / factor + smooth * freqs),
            )
        else:
            raise ValueError(f"unsupported rope scaling kind {kind!r}")
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, offset: int = 0, positions: torch.Tensor | None = None
) -> torch.Tensor:
    """x: [B, T, H, D]. Rotates interleaved pairs (even, odd) of the head dim.
    ``positions`` [B, T] overrides the contiguous ``offset`` window."""
    if positions is not None:
        cos = cos[positions][:, :, None, :]
        sin = sin[positions][:, :, None, :]
    else:
        seq_len = x.shape[1]
        cos = cos[offset : offset + seq_len][None, :, None, :]
        sin = sin[offset : offset + seq_len][None, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.reshape(x.shape).to(x.dtype)


def _window_keep(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    return (q_pos - k_pos) < window


def _dot_attention(q, k, v, causal: bool = True, mask: torch.Tensor | None = None):
    """Unfused attention: fp32 softmax, matmuls in the operand dtype.
    q: [B,T,H,D], k/v: [B,S,KH,D]. ``mask`` ([T, S] or [B, T, S] bool, True =
    attend) replaces the causal triangle entirely. Operands of different
    dtypes (a cache kept in another dtype) are promoted, as ``jnp.einsum``
    promotes them."""
    if not q.dtype == k.dtype == v.dtype:
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    q = q.reshape(b, t, kh, h // kh, d)
    scores = torch.einsum("btkgd,bskd->bkgts", q, k).float() / math.sqrt(d)
    if mask is None and causal:
        mask = torch.ones((t, s), dtype=torch.bool, device=q.device).tril(s - t)
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None]
        scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, h, d)


def _adapter_add(y: torch.Tensor, inp: torch.Tensor, name: str, adapters, tp: ModelGroup | None = None,
                 split: str = "out") -> torch.Tensor:
    """``y`` plus the per-row LoRA delta of dense ``name`` when ``adapters``
    carries a stacked pair for it. ``adapters`` is ``(subtree, ids)``: the
    ``lora_init``-shaped subtree of the enclosing module (``LoraPair`` leaves
    with ``a`` ``[N, d_in, r]`` and ``b`` ``[N, r, d_out]``, ``b`` pre-scaled by
    alpha/rank) and the rows' adapter ids ``[B]``; or None. The delta is
    ``lora.batched_lora_delta``'s fp32 ``(x @ a) @ b``, cast to ``y``'s dtype.

    Under tensor parallelism (``tp``) the layer holds this rank's slice: a
    column-parallel one (``split="out"``) takes its slice of ``b``'s output
    columns; a row-parallel one (``split="in"``) gets its slice of the input,
    so its partial ``(x_r @ a[rows_r]) @ b`` joins the partial output the
    caller then sums over the group, and the delta counts once."""
    if adapters is None:
        return y
    from .lora import LoraPair, batched_lora_delta

    sub, ids = adapters
    pair = (sub or {}).get(name)
    if isinstance(pair, dict):
        pair = pair.get("kernel")
    if not isinstance(pair, LoraPair):
        return y
    a, b = pair.a[ids], pair.b[ids]
    if tp is not None:
        if split == "out":
            w = b.shape[-1] // tp.size
            b = b[..., tp.rank * w:(tp.rank + 1) * w]
        else:
            w = a.shape[1] // tp.size
            a = a[:, tp.rank * w:(tp.rank + 1) * w]
    delta = batched_lora_delta(inp, a, b)
    return y + delta.reshape(y.shape).to(y.dtype)


class Attention(nn.Module):
    """Grouped-query attention. Its head counts come from the local widths of
    the projections: under tensor parallelism (``tp``, set by
    ``DecoderLM.apply_tensor_parallel``) each rank runs ``H/model`` query and
    ``KH/model`` KV heads, contiguous chunks, so query head ``i`` keeps its KV
    head ``i // (H/KH)``; the output projection's partial sums are then
    summed over the ``model`` group."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, h, kh, hd, dt = cfg.hidden_dim, cfg.num_heads, cfg.kv_heads, cfg.head_dim, cfg.dtype
        self.q_proj = QuantDenseGeneral(d, (h, hd), dt, device)
        self.k_proj = QuantDenseGeneral(d, (kh, hd), dt, device)
        self.v_proj = QuantDenseGeneral(d, (kh, hd), dt, device)
        self.o_proj = QuantDense(h * hd, d, dt, device)
        self.tp: ModelGroup | None = None
        #: the ``seq`` group ring attention runs over (``apply_sequence_parallel``)
        self.seq: ModelGroup | None = None

    def forward(self, x, cos, sin, seg_info=None, cache=None, offset=0, decode_pad=None, attend_len=None,
                paged=None, adapters=None):
        """The attention block's output; with ``cache`` (decode mode) also the
        cache, written in place: ``(out, cache)``."""
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.head_dim
        tp = self.tp
        if tp is not None:
            x = copy_to_model(x, tp)
        # [B, T, heads, hd]: this rank's heads under tensor parallelism
        q = _adapter_add(self.q_proj(x), x, "q_proj", adapters, tp)
        k = _adapter_add(self.k_proj(x), x, "k_proj", adapters, tp)
        v = _adapter_add(self.v_proj(x), x, "v_proj", adapters, tp)
        h = q.shape[2]
        if cache is not None:
            # the decode modes: paged rows sit at their own absolute positions,
            # left-padded rows count from their first real token; under tensor
            # parallelism the cache holds this rank's KV heads
            positions = paged[2] if paged is not None else None if decode_pad is None else decode_pad[1]
            q = apply_rope(q, cos, sin, offset=offset, positions=positions)
            k = apply_rope(k, cos, sin, offset=offset, positions=positions)
            out, cache = _decode_attention(cfg, q, k, v, cache, offset, decode_pad, attend_len, paged)
            out = out.reshape(b, t, h * hd)
            out = _adapter_add(self.o_proj(out), out, "o_proj", adapters, tp, "in")
            return (out if tp is None else reduce_from_model(out, tp)), cache
        if seg_info is not None:
            # packed rows: positions restart per segment; attention is causal
            # AND same-segment (flash masks from the raw ids, dot from the mask)
            positions, mask, seg_ids = seg_info
            q = apply_rope(q, cos, sin, positions=positions)
            k = apply_rope(k, cos, sin, positions=positions)
            if cfg.attn_impl == "flash":
                out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window, segment_ids=seg_ids)
            else:
                out = _dot_attention(q, k, v, mask=mask)
        else:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            if cfg.attn_impl == "flash":
                out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
            elif cfg.attn_impl == "ring":
                if self.seq is None:
                    raise ValueError(f"attn_impl='ring' runs over the {cfg.seq_axis!r} axis of a mesh: register the "
                                     "model on a mesh with that axis (TrainingPipeline.set_mesh) or call "
                                     "DecoderLM.apply_sequence_parallel(mesh)")
                out = ring_attention_sharded(q, k, v, self.seq, cfg.seq_axis, causal=True, window=cfg.sliding_window)
            elif cfg.sliding_window is not None:
                pos = torch.arange(t, device=x.device)
                q_pos, k_pos = pos[:, None], pos[None, :]
                out = _dot_attention(q, k, v, mask=(q_pos >= k_pos) & _window_keep(q_pos, k_pos, cfg.sliding_window))
            else:
                out = _dot_attention(q, k, v, causal=True)
        out = out.reshape(b, t, h * hd)
        out = _adapter_add(self.o_proj(out), out, "o_proj", adapters, tp, "in")
        return out if tp is None else reduce_from_model(out, tp)


def _decode_attention(cfg, q, k, v, cache, offset, decode_pad, attend_len, paged):
    """Attention of a decode call: write this call's K/V into ``cache`` (in
    place), then attend over the written slots with the unwritten ones masked.

    Paged (``paged = (tables, fill, positions, index)``): the cache leaves are
    pool pages; the rows' tokens are scattered through their block tables and
    the tables gathered back into a contiguous view. Dense: the slots
    ``[offset, offset + t)`` are written and the first ``attend_len`` slots
    (all, when None) read. The mask is causal AND written slots AND the window
    AND, with ``decode_pad``, not a left-pad slot."""
    t = q.shape[1]
    if paged is not None:
        tables, _, positions, index = paged
        k_pool = scatter_tokens(cache["k"], tables, positions, k, index)
        v_pool = scatter_tokens(cache["v"], tables, positions, v, index)
        gk, gv = gather_pages(k_pool, tables), gather_pages(v_pool, tables)
        kv_pos = torch.arange(gk.shape[1], device=q.device)[None, None, :]  # [1, 1, L]
        q_pos = positions[:, :, None]  # [B, t, 1] absolute positions
        mask = kv_pos <= q_pos  # causal AND only this row's filled slots
        if cfg.sliding_window is not None:
            mask = mask & _window_keep(q_pos, kv_pos, cfg.sliding_window)
        return _dot_attention(q, gk, gv, mask=mask), {"k": k_pool, "v": v_pool}
    ck, cv = cache["k"], cache["v"]
    if offset + t > ck.shape[1]:
        raise ValueError(f"decode writes slots [{offset}, {offset + t}) past the cache's {ck.shape[1]}")
    ck[:, offset : offset + t] = k
    cv[:, offset : offset + t] = v
    s = ck.shape[1] if attend_len is None else min(int(attend_len), ck.shape[1])
    q_pos = offset + torch.arange(t, device=q.device)[:, None]  # [t, 1]
    kv_pos = torch.arange(s, device=q.device)[None, :]  # [1, s]
    mask = kv_pos <= q_pos  # causal AND only written slots
    if cfg.sliding_window is not None:
        mask = mask & _window_keep(q_pos, kv_pos, cfg.sliding_window)
    if decode_pad is not None:
        # left-pad slots hold garbage K/V: mask them per row
        pad_len, _ = decode_pad
        mask = mask[None] & (kv_pos[None] >= pad_len[:, None, None])
    return _dot_attention(q, ck[:, :s], cv[:, :s], mask=mask), {"k": ck, "v": cv}


class MLP(nn.Module):
    """SwiGLU; under tensor parallelism (``tp``) each rank holds a slice of the
    hidden dim and the down projection's partial sums are summed over the
    ``model`` group."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.gate_proj = QuantDense(cfg.hidden_dim, cfg.mlp_dim, cfg.dtype, device)
        self.up_proj = QuantDense(cfg.hidden_dim, cfg.mlp_dim, cfg.dtype, device)
        self.down_proj = QuantDense(cfg.mlp_dim, cfg.hidden_dim, cfg.dtype, device)
        self.tp: ModelGroup | None = None

    def forward(self, x, adapters=None):
        tp = self.tp
        if tp is not None:
            x = copy_to_model(x, tp)
        gate = _adapter_add(self.gate_proj(x), x, "gate_proj", adapters, tp)
        up = _adapter_add(self.up_proj(x), x, "up_proj", adapters, tp)
        h = F.silu(gate) * up
        out = _adapter_add(self.down_proj(h), h, "down_proj", adapters, tp, "in")
        return out if tp is None else reduce_from_model(out, tp)


def _compiled_once(fn):
    """Under ``torch.compile``, trace ``fn`` once and reuse its graph for every
    call with the same input structure (``torch.compiler.nested_compile_region``):
    the blocks of a deep model compile as one, not once per layer. A no-op in
    eager code, and where torch lacks the API."""
    region = getattr(torch.compiler, "nested_compile_region", None)
    return fn if region is None else region(fn)


def _block_body(block: "DecoderBlock", x, cos, sin, seg_info, adapters=None):
    attn_ad, mlp_ad = _split_adapters(adapters)
    x = x + block.attn(block.attn_norm(x), cos, sin, seg_info=seg_info, adapters=attn_ad)
    return x + block.ffn(block.mlp_norm(x), mlp_ad)


_block_region = _compiled_once(_block_body)


def _block_forward(block: "DecoderBlock", x, cos, sin, seg_info, adapters=None):
    """The block's body, through the nested compile region unless a
    parameter is a DTensor (a ``model`` or ``expert`` shard): torch 2.11's
    ``invoke_subgraph`` takes no DTensor input, and on such a mesh the stage
    compiles each block as a region of its own (``compile.aot.compile_blocks``),
    which the nested region would only repeat."""
    if any(isinstance(p, DTensor) for p in block.parameters()):
        return _block_body(block, x, cos, sin, seg_info, adapters)
    return _block_region(block, x, cos, sin, seg_info, adapters)


def _split_adapters(adapters):
    """A layer's ``(subtree, ids)`` as its attention's and its MLP's (the ids
    ride along), or ``(None, None)``."""
    if adapters is None:
        return None, None
    sub, ids = adapters
    return ((sub or {}).get("attn"), ids), ((sub or {}).get("mlp"), ids)


class DecoderBlock(nn.Module):
    """Attention and an MLP, each pre-normed on the residual stream; with
    ``use_moe`` the MLP is an ``MoEMLP`` (attribute ``moe``, else ``mlp``),
    which takes no per-row adapters (the reference's :427-429)."""

    def __init__(self, cfg: TransformerConfig, device=None, use_moe: bool = False):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_dim, device=device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.hidden_dim, device=device)
        if use_moe:
            self.moe = MoEMLP(cfg.moe_config(), device)
        else:
            self.mlp = MLP(cfg, device)

    def ffn(self, x, adapters=None, across_data: bool = True):
        """The block's MLP on the normed stream: the dense one with the
        layer's adapters, or the MoE one."""
        if hasattr(self, "moe"):
            return self.moe(x, across_data=across_data)
        return self.mlp(x, adapters=adapters)

    def forward(self, x, cos, sin, seg_info=None, cache=None, offset=0, decode_pad=None, attend_len=None,
                paged=None, adapters=None):
        if cache is None:
            return _block_forward(self, x, cos, sin, seg_info, adapters)
        attn_ad, mlp_ad = _split_adapters(adapters)
        attn_out, cache = self.attn(self.attn_norm(x), cos, sin, cache=cache, offset=offset, decode_pad=decode_pad,
                                    attend_len=attend_len, paged=paged, adapters=attn_ad)
        x = x + attn_out
        # each process decodes its own rows: no routing across data-parallel ranks
        return x + self.ffn(self.mlp_norm(x), mlp_ad, across_data=False), cache


class DecoderLM(nn.Module):
    """Causal LM: tokens [B, T] int -> logits [B, T, vocab] fp32.

    With ``segment_ids`` [B, T] int32, rows hold several packed examples and
    attention never crosses a segment boundary (pair with
    ``lm_loss(..., segment_ids=...)``).

    With ``cache``/``offset`` (see ``models/generate.py``) it runs in
    autoregressive-decode mode and returns ``(logits, cache)``, the cache
    written in place. With ``cache`` holding pool pages and ``pages=(tables,
    fill)`` the decode is paged (the serving engine's path, ``serve/``): each
    row reads and writes the pool blocks its table names at its own absolute
    position. ``return_hidden=True`` without a cache returns the final hidden
    states instead of logits; with a cache, ``((logits, hidden), cache)``.
    ``adapters=(stacked_tree, ids)`` adds per-row LoRA deltas, each row's
    factors gathered by its adapter id, in every dense layer and the LM head
    (multi-tenant serving; ``_adapter_add``).

    A weight may be an int8 ``QuantizedTensor`` (``models.quant.quantize_tree``):
    its layer then multiplies through the int8 path.

    Parameters live on ``device`` (default ``cuda``; raises without a card
    unless ``device="cpu"``), initialised from ``generator`` (default: seed 0
    on that device) with flax's initializer families: embeddings normal with
    std 1/sqrt(hidden), dense kernels lecun-normal (truncated at two standard
    deviations), norms one."""

    def __init__(self, cfg: TransformerConfig, device=None, generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_dim, device=device, dtype=torch.float32)
        self.layers = nn.ModuleList(DecoderBlock(cfg, device, cfg.is_moe(i)) for i in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_dim, device=device)
        # the LM head multiplies in fp32 (flax QuantDense(dtype=float32))
        self.lm_head = None if cfg.tie_embeddings else QuantDense(cfg.hidden_dim, cfg.vocab_size, torch.float32,
                                                                  device)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, cfg.rope_scaling, device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        #: tensor parallelism (``apply_tensor_parallel``): the embedding's
        #: features and the LM head's vocab split over the ``model`` group
        self.tp_embed: ModelGroup | None = None
        self.tp_head: ModelGroup | None = None
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.weight.normal_(0.0, 1.0 / math.sqrt(self.cfg.hidden_dim), generator=generator)
        for module in self.modules():
            if isinstance(module, nn.Linear):
                # lecun_normal: truncated normal, std 1/sqrt(fan_in) after truncation
                std = math.sqrt(1.0 / module.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            elif isinstance(module, RMSNorm):
                module.weight.fill_(1.0)
            elif isinstance(module, MoEMLP):  # its expert weights; the router is a Linear
                module.reset_parameters(generator)

    def flax_layout(self) -> list[Row]:
        """(flax path, parameter name, transform) of every parameter: the
        layout sharding rules are matched in (``parallel.mesh``)."""
        return _flax_layout(self.cfg)

    def fsdp_blocks(self) -> list[nn.Module]:
        """The modules FSDP2 wraps one by one (then the root)."""
        return list(self.layers)

    @property
    def local_kv_heads(self) -> int:
        """The KV heads this rank's attention runs, and its decode cache holds:
        ``kv_heads / model`` under tensor parallelism."""
        tp = self.layers[0].attn.tp if len(self.layers) else None
        return self.cfg.kv_heads // (1 if tp is None else tp.size)

    def apply_tensor_parallel(self, tp: ModelGroup, dims: dict[str, int]) -> None:
        """Run the forward on ``model``-axis shards: ``dims`` maps each
        parameter split over the ``tp`` group to the torch dim it is split on.
        Accepted: per block, all of q/k/v (dim 0, by heads) with o (dim 1), or
        none; all of gate/up (dim 0) with down (dim 1), or none; in an MoE
        block all of the experts' gate/up (dim 2) with down (dim 1), or none;
        the embedding's features (dim 1); the LM head's vocab (dim 0). Anything
        else raises a ``ValueError`` naming the parameter."""
        cfg, m = self.cfg, tp.size
        dims = dict(dims)

        def split(prefix: str, want: dict[str, int], sizes: dict[str, int]) -> bool:
            got = {n: dims.pop(prefix + n, None) for n in want}
            if all(v is None for v in got.values()):
                return False
            for n, d in got.items():
                if d != want[n]:
                    raise ValueError(f"{prefix}{n}: a 'model' split on dim {d} cannot run here; tensor parallelism "
                                     f"needs {', '.join(f'{k} on dim {v}' for k, v in want.items())}")
            for what, size in sizes.items():
                if size % m:
                    raise ValueError(f"{prefix}{next(iter(want))}: {what} {size} is not divisible by the 'model' "
                                     f"axis ({m})")
            return True

        split_modules: list[nn.Module] = []
        for i, layer in enumerate(self.layers):
            p = f"layers.{i}."
            if split(p + "attn.", {f"{n}_proj.weight": 0 if n != "o" else 1 for n in "qkvo"},
                     {"num_heads": cfg.num_heads, "num_kv_heads": cfg.kv_heads}):
                split_modules.append(layer.attn)
            if hasattr(layer, "moe"):
                if split(p + "moe.", {"gate_proj": 2, "up_proj": 2, "down_proj": 1}, {"mlp_dim": cfg.mlp_dim}):
                    split_modules.append(layer.moe)
            elif split(p + "mlp.", {"gate_proj.weight": 0, "up_proj.weight": 0, "down_proj.weight": 1},
                       {"mlp_dim": cfg.mlp_dim}):
                split_modules.append(layer.mlp)
        embed = split("", {"embed.weight": 1}, {"hidden_dim": cfg.hidden_dim})
        head = not cfg.tie_embeddings and split("", {"lm_head.weight": 0}, {"vocab_size": cfg.vocab_size})
        if dims:
            name, d = next(iter(dims.items()))
            raise ValueError(f"{name}: a 'model' split on dim {d} cannot run here (norms stay replicated)")
        # every placement checked: only now switch the forward over
        for module in split_modules:
            if isinstance(module, MoEMLP):
                module.apply_shard(tp)
            else:
                module.tp = tp
        self.tp_embed = tp if embed else None
        self.tp_head = tp if head else None

    def apply_expert_parallel(self, ep: ModelGroup, dims: dict[str, int]) -> None:
        """Run each MoE block on this rank's experts: ``dims`` maps each
        parameter split over the ``expert`` group ``ep`` to its torch dim.
        Accepted: per MoE block, all of the experts' gate/up/down on dim 0 (the
        expert dim), which the group's size must divide. Anything else raises
        a ``ValueError`` naming the parameter."""
        dims = dict(dims)
        moes = []
        for i, layer in enumerate(self.layers):
            names = [f"layers.{i}.moe.{n}_proj" for n in ("gate", "up", "down")]
            got = [dims.pop(n, None) for n in names]
            if all(d is None for d in got):
                continue
            if got != [0, 0, 0]:
                raise ValueError(f"{names[0]}: an 'expert' split cannot run here; expert parallelism needs gate, up "
                                 "and down split on dim 0 (the expert dim)")
            if self.cfg.num_experts % ep.size:
                raise ValueError(f"{names[0]}: num_experts {self.cfg.num_experts} is not divisible by the 'expert' "
                                 f"axis ({ep.size})")
            moes.append(layer.moe)
        if dims:
            name, d = next(iter(dims.items()))
            raise ValueError(f"{name}: an 'expert' split on dim {d} cannot run here (only the experts' dim 0)")
        for moe in moes:
            moe.apply_shard(ep, ep.rank * (self.cfg.num_experts // ep.size))

    def apply_data_parallel(self, group) -> None:
        """The MoE blocks route over the tokens of the data-parallel ``group``
        (``parallel.mesh.data_parallel_group``; None: this process's), as the
        reference's step routes the global batch."""
        for layer in self.layers:
            if hasattr(layer, "moe"):
                layer.moe.apply_data_parallel(group)

    def apply_sequence_parallel(self, mesh) -> None:
        """Run ``attn_impl="ring"`` attention over the ``cfg.seq_axis`` axis of
        ``mesh`` (a ``DeviceMesh``). A model with another ``attn_impl`` keeps
        its attention whole (replicated over that axis)."""
        if self.cfg.attn_impl != "ring":
            return
        group = seq_group(mesh, self.cfg.seq_axis)
        for layer in self.layers:
            layer.attn.seq = group

    def forward(self, tokens: torch.Tensor, segment_ids: torch.Tensor | None = None, return_hidden: bool = False, *,
                cache: dict | None = None, offset: int = 0, pad_len: torch.Tensor | None = None,
                attend_len: int | None = None, pages: tuple | None = None, adapters=None):
        """Logits ``[B, T, vocab]`` fp32; with ``return_hidden`` the final
        hidden states ``[B, T, hidden]`` instead (``chunked_lm_loss``'s input).
        The decode arguments (class docstring): ``cache`` written at the
        Python int ``offset``; ``pad_len`` [B], each row's count of left-pad
        slots; ``attend_len``, the cache slots read; ``pages = (tables [B, NB],
        fill [B])``."""
        cfg = self.cfg
        if pad_len is not None and cache is None:
            raise ValueError("pad_len (left-padded ragged prompts) is a decode-mode feature")
        if attend_len is not None and cache is None:
            raise ValueError("attend_len (bounded cache reads) is a decode-mode feature")
        paged = None
        if pages is not None:
            # rows sit at their own absolute positions (no left-padding), so
            # positions derive from fill, not from a batch-wide offset
            if cache is None:
                raise ValueError("pages (paged KV decode) requires the pool cache")
            if pad_len is not None or attend_len is not None:
                raise ValueError("pages replaces pad_len/attend_len: positions come from fill")
            tables, fill = pages
            positions = fill[:, None] + torch.arange(tokens.shape[1], device=tokens.device)[None, :]
            pool = cache["layer_0"]["k"]
            # where the scatter lands, found once for every layer's K and V
            paged = (tables, fill, positions, write_index(tables, positions, pool.shape[0], pool.shape[1]))
        decode_pad = None
        if pad_len is not None:
            positions = (torch.arange(tokens.shape[1], device=tokens.device)[None, :] + offset
                         - pad_len[:, None]).clamp(min=0)
            decode_pad = (pad_len, positions)
        seg_info = None
        if segment_ids is not None:
            if cache is not None:
                raise ValueError("segment_ids are a packed-training feature; unsupported in decode mode")
            if cfg.attn_impl == "ring":
                raise ValueError("segment_ids are not supported with attn_impl='ring'")
            # computed once, shared by every layer: per-segment rotary
            # positions and the causal-AND-same-segment mask of the dot path
            t = tokens.shape[1]
            same = segment_ids[:, :, None] == segment_ids[:, None, :]  # [B, T, S]
            seg_start = same.to(torch.uint8).argmax(-1)  # first index of own segment
            positions = torch.arange(t, device=tokens.device)[None, :] - seg_start
            mask = None
            if cfg.attn_impl != "flash":
                mask = torch.ones((t, t), dtype=torch.bool, device=tokens.device).tril()[None] & same
                if cfg.sliding_window is not None:
                    pos = torch.arange(t, device=tokens.device)
                    mask = mask & _window_keep(pos[:, None], pos[None, :], cfg.sliding_window)[None]
            seg_info = (positions, mask, segment_ids)
        x = F.embedding(tokens, local_tensor(self.embed.weight)).to(cfg.dtype)
        if self.tp_embed is not None:
            x = gather_from_model(x, self.tp_embed, dim=-1)
        new_cache = None if cache is None else {}
        adapter_tree, adapter_ids = adapters if adapters is not None else (None, None)
        for i, layer in enumerate(self.layers):
            name = f"layer_{i}"
            layer_ad = None
            if adapter_tree is not None and adapter_tree.get(name) is not None:
                layer_ad = (adapter_tree[name], adapter_ids)
            if cache is not None:
                x, new_cache[name] = layer(x, self.rope_cos, self.rope_sin, cache=cache[name], offset=offset,
                                           decode_pad=decode_pad, attend_len=attend_len, paged=paged,
                                           adapters=layer_ad)
            elif cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, self.rope_cos, self.rope_sin, seg_info, adapters=layer_ad,
                               use_reentrant=False)
            else:
                x = layer(x, self.rope_cos, self.rope_sin, seg_info=seg_info, adapters=layer_ad)
        x = self.final_norm(x)
        head_ad = None if adapter_tree is None else (adapter_tree, adapter_ids)
        if new_cache is not None:
            logits = self._logits(x, head_ad)
            return ((logits, x) if return_hidden else logits), new_cache
        if return_hidden:
            return x
        return self._logits(x, head_ad)

    def _logits(self, x: torch.Tensor, adapters=None) -> torch.Tensor:
        """The fp32 LM head on the final hidden states (plus the per-row
        adapters' ``lm_head`` delta; a tied head takes none, as the
        reference's)."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            head = local_tensor(self.embed.weight)
            if self.tp_embed is None:
                return F.linear(x.float(), head.float())
            # feature-sharded embedding as the head: partial logits, summed
            tp = self.tp_embed
            x = copy_to_model(x, tp).narrow(-1, tp.rank * head.shape[1], head.shape[1])
            return reduce_from_model(F.linear(x.float(), head.float()), tp)
        tp = self.tp_head
        if tp is None:
            return _adapter_add(self.lm_head(x), x, "lm_head", adapters)
        # vocab-parallel head: each rank's logits slice (and its slice of the
        # adapters' delta), gathered into the full fp32 logits
        x = copy_to_model(x, tp)
        return gather_from_model(_adapter_add(self.lm_head(x), x, "lm_head", adapters, tp), tp)


def lm_head_kernel(model) -> tuple[torch.Tensor, ModelGroup | None]:
    """The LM head as ``chunked_lm_loss`` takes it, ``[hidden, vocab]`` (a view),
    and the ``model`` group its vocab is split over (None: the whole vocab).
    Read it after the forward: under FSDP2 the root's parameters are gathered
    from then until the backward."""
    if model.cfg.tie_embeddings:
        if model.tp_embed is not None:
            raise ValueError("chunked_lm_loss with tied embeddings split over 'model' (by features) is not supported")
        return local_tensor(model.embed.weight).t(), None
    return local_tensor(model.lm_head.weight).t(), model.tp_head


def chunked_lm_loss(
    hidden: torch.Tensor,
    kernel: torch.Tensor,
    tokens: torch.Tensor,
    *,
    vocab_chunk: int = 8192,
    segment_ids: torch.Tensor | None = None,
    tp: ModelGroup | None = None,
) -> torch.Tensor:
    """``lm_loss`` without ever materialising the ``[B, T, vocab]`` logits.

    The vocab is streamed in chunks of ``vocab_chunk``: per chunk,
    ``hidden @ kernel[:, c]`` (fp32) feeds an online log-sum-exp and a gather
    of the target logit, under ``torch.utils.checkpoint``, so the backward
    recomputes each chunk's logits instead of storing them; a non-divisible
    tail is one more, narrower chunk. ``hidden`` is
    ``DecoderLM(..., return_hidden=True)``'s output, ``kernel`` the
    ``[hidden, vocab]`` projection (``lm_head_kernel(model)``). With ``tp``,
    ``kernel`` holds this rank's contiguous slice of the vocab (a
    vocab-parallel head): the per-rank statistics are gathered over the group
    and combined, so every rank gets the loss of the whole vocab. Matches
    ``lm_loss`` to float32 accuracy in value and gradient."""
    h = hidden[:, :-1].float()
    targets = tokens[:, 1:].long()
    if tp is not None:
        h = copy_to_model(h, tp)
    v = kernel.shape[1]
    base = 0 if tp is None else tp.rank * v

    def update(m, s, tl, lo, hi):
        logits = h @ kernel[:, lo:hi].float()  # [B, T-1, width], the only logits alive
        new_m = torch.maximum(m, logits.detach().amax(-1))
        s = s * torch.exp(m - new_m) + torch.exp(logits - new_m[..., None]).sum(-1)
        in_chunk = (targets >= base + lo) & (targets < base + hi)
        local = (targets - base - lo).clamp(0, hi - lo - 1)
        picked = logits.gather(-1, local[..., None])[..., 0]
        return new_m, s, torch.where(in_chunk, picked, tl)

    shape = h.shape[:-1]
    # finite sentinel: -inf would NaN the first rescale
    m = torch.full(shape, -1e30, dtype=torch.float32, device=h.device)
    s = torch.zeros(shape, dtype=torch.float32, device=h.device)
    tl = torch.zeros(shape, dtype=torch.float32, device=h.device)
    for lo in range(0, v, vocab_chunk):
        m, s, tl = checkpoint(update, m, s, tl, lo, min(lo + vocab_chunk, v), use_reentrant=False)
    if tp is not None:
        # [model, 3, B, T-1]: every rank's running max, sum and target logit
        stats = gather_from_model(torch.stack([m, s, tl])[None], tp, dim=0)
        m_all, s_all, tl_all = stats[:, 0], stats[:, 1], stats[:, 2]
        m = m_all.detach().amax(0)
        s = (s_all * torch.exp(m_all - m)).sum(0)
        tl = tl_all.sum(0)  # only the owner of the target has it, the others hold 0
    losses = (m + torch.log(s)) - tl  # logsumexp - target logit
    return _packed_mean(losses, segment_ids)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor, segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Next-token cross entropy over shifted targets. With ``segment_ids``
    (packed rows), a position only counts when its target is in the SAME
    non-pad segment (id 0 marks padding)."""
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1].float()
    losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1), reduction="none")
    return _packed_mean(losses.view(targets.shape), segment_ids)


def _packed_mean(losses: torch.Tensor, segment_ids: torch.Tensor | None) -> torch.Tensor:
    """Mean of per-position losses; with packed ``segment_ids``, a position
    only counts when its target is in the SAME non-pad segment."""
    if segment_ids is None:
        return losses.mean()
    w = ((segment_ids[:, 1:] == segment_ids[:, :-1]) & (segment_ids[:, 1:] != 0)).to(losses.dtype)
    return (losses * w).sum() / torch.clamp(w.sum(), min=1)


def llama_partition_rules() -> list[tuple[str, tuple]]:
    """The reference's sharding rules for this model family, matched against
    the flax paths (``parallel.mesh.make_param_policy``): embeddings and heads
    over ``model`` (tensor parallel), ``fsdp`` over the other large dim. Axes
    the mesh lacks are dropped. The MoE rules (``moe_partition_rules``) come
    first, as in the reference, so expert-parallel configs shard out of the box."""
    from ..parallel.mesh import P

    return list(moe_partition_rules()) + [
        # vocab over fsdp, features over model: the token gather never crosses
        # the model axis (each TP shard gathers its feature slice)
        ("embed/embedding", P("fsdp", "model")),
        ("attn/(q|k|v)_proj/kernel", P("fsdp", "model")),
        ("attn/o_proj/kernel", P("model", "fsdp")),
        ("mlp/(gate|up)_proj/kernel", P("fsdp", "model")),
        ("mlp/down_proj/kernel", P("model", "fsdp")),
        ("lm_head/kernel", P("fsdp", "model")),
        ("norm", P()),
        (".*", P()),
    ]


# ---------------------------------------------------------------------------
# carrying weights across: the JAX DecoderLM's param tree <-> this module
# ---------------------------------------------------------------------------

def _flax_layout(cfg: TransformerConfig) -> list[Row]:
    """(flax path, port parameter name, transform) for every parameter
    (``models.bridge``'s transforms)."""
    heads = ("heads", cfg.head_dim)
    rows = [(("embed", "embedding"), "embed.weight", "same")]
    for i in range(cfg.num_layers):
        flax, port = f"layer_{i}", f"layers.{i}"
        for n in ("q", "k", "v"):
            rows.append(((flax, "attn", f"{n}_proj", "kernel"), f"{port}.attn.{n}_proj.weight", heads))
        rows.append(((flax, "attn", "o_proj", "kernel"), f"{port}.attn.o_proj.weight", "t"))
        if cfg.is_moe(i):
            # the expert weights are params named "moe/gate_proj" ... inside the
            # module "moe": the '/' is part of one key
            rows.append(((flax, "moe", "router", "kernel"), f"{port}.moe.router.weight", "t"))
            for n in ("gate", "up", "down"):
                rows.append(((flax, "moe", f"moe/{n}_proj"), f"{port}.moe.{n}_proj", "same"))
        else:
            for n in ("gate", "up", "down"):
                rows.append(((flax, "mlp", f"{n}_proj", "kernel"), f"{port}.mlp.{n}_proj.weight", "t"))
        rows.append(((flax, "attn_norm", "scale"), f"{port}.attn_norm.weight", "same"))
        rows.append(((flax, "mlp_norm", "scale"), f"{port}.mlp_norm.weight", "same"))
    rows.append((("final_norm", "scale"), "final_norm.weight", "same"))
    if not cfg.tie_embeddings:
        rows.append((("lm_head", "kernel"), "lm_head.weight", "t"))
    return rows


def load_flax_params(model: DecoderLM, tree: dict, tensors: dict[str, torch.Tensor] | None = None) -> DecoderLM:
    """Copy the JAX ``DecoderLM``'s params (a nested dict of numpy arrays,
    with or without the top-level ``"params"`` key) into ``model``, or into
    ``tensors``, a dict by parameter name in ``model``'s layout (the EMA
    shadow ``TrainState.ema`` carries the JAX ``TrainState.ema`` tree so). A
    quantized leaf (the reference's ``QuantizedTensor``, or a ``{"q", "scale"}``
    dict) becomes the model's ``QuantizedTensor`` there, byte for byte."""
    tree = tree.get("params", tree)
    rows = _flax_layout(model.cfg)
    if tensors is None:
        rows = _load_quantized(model, tree, rows)
    load_tree(tree, rows, dict(model.named_parameters() if tensors is None else tensors))
    return model


def to_flax_params(model: DecoderLM, tensors: dict[str, torch.Tensor] | None = None) -> dict:
    """The inverse of ``load_flax_params``: a nested dict of float32 numpy
    arrays in the JAX ``DecoderLM``'s layout, from ``model``'s parameters or
    from ``tensors`` in their layout; a quantized weight as ``{"q": int8,
    "scale": float32}``. The parameters of a sharded model are gathered to
    full tensors (on every rank)."""
    rows = _flax_layout(model.cfg)
    if tensors is not None:
        return dump_tree(rows, tensors)
    quantized, rows = _dump_quantized(model, rows)
    tree = dump_tree(rows, dict(model.named_parameters()))
    _merge(tree, quantized)
    return tree


def _merge(dst: dict, src: dict) -> None:
    for key, value in src.items():
        if isinstance(value, dict) and set(value) != {"q", "scale"}:
            _merge(dst.setdefault(key, {}), value)
        else:
            dst[key] = value
