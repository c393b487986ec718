"""HuggingFace Llama checkpoint import and export for :class:`DecoderLM`.

Counterpart of ``dmlcloud_tpu/models/hf.py``: ``transformer_config_from_hf``
(:45), ``_rope_scaling_from_hf`` (:69), ``llama_params_from_hf`` (:95) and
``hf_state_dict_from_params`` (:166), with the same names, signatures and
errors. Everything here is numpy: the functions take any object with HF's
config attribute names and a ``LlamaForCausalLM``/``MistralForCausalLM``
state dict of torch tensors or numpy arrays, so the import runs where
``transformers`` is not installed.

The params are the reference's flax tree (nested dicts of numpy arrays by
flax path), which ``models.transformer.load_flax_params`` (over
``models/bridge.py`` ``load_tree``) loads into a port ``DecoderLM`` and
``to_flax_params`` (``dump_tree``) gives back. Two conversions happen beyond
plain transposes:

- flax kernels are ``[in, out]`` while torch ``nn.Linear`` stores
  ``[out, in]``;
- HF stores rotary q/k projections in the half-split layout
  (``[r_0..r_{D/2-1}, i_0..i_{D/2-1}]`` per head) while this model rotates
  interleaved pairs (``[r_0, i_0, r_1, i_1, ...]``, the Meta convention): the
  q/k output rows are permuted accordingly, which is how the two RoPE
  conventions are made to agree.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .transformer import TransformerConfig

__all__ = ["hf_state_dict_from_params", "llama_params_from_hf", "transformer_config_from_hf"]


def _np(t: Any) -> np.ndarray:
    """torch tensor / numpy array -> float32 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def _interleave_rope_rows(w: np.ndarray) -> np.ndarray:
    """[..., D] half-split rotary layout -> interleaved pairs."""
    d = w.shape[-1]
    out = np.empty_like(w)
    out[..., 0::2] = w[..., : d // 2]
    out[..., 1::2] = w[..., d // 2 :]
    return out


def transformer_config_from_hf(hf_config: Any, **overrides) -> TransformerConfig:
    """Build a :class:`TransformerConfig` from a HF ``LlamaConfig`` /
    ``MistralConfig`` (same architecture; Mistral's ``sliding_window``
    carries over into the model's windowed attention paths)."""
    base = dict(
        vocab_size=hf_config.vocab_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads", None),
        # some Mistral-family configs decouple head_dim from hidden/heads
        head_dim=getattr(hf_config, "head_dim", None) or hf_config.hidden_size // hf_config.num_attention_heads,
        hidden_dim=hf_config.hidden_size,
        mlp_dim=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", False)),
        sliding_window=getattr(hf_config, "sliding_window", None),
        rope_scaling=_rope_scaling_from_hf(getattr(hf_config, "rope_scaling", None)),
    )
    base.update(overrides)
    return TransformerConfig(**base)


def _rope_scaling_from_hf(rs: Any) -> tuple | None:
    """HF ``rope_scaling`` dict -> the config's hashable tuple. Unsupported
    schemes raise: a silently dropped scaling would import a Llama-3
    checkpoint with wrong positional geometry."""
    if rs is None:
        return None
    kind = rs.get("rope_type", rs.get("type"))
    if kind is None:
        # a scaling dict with no recognizable type key must not silently
        # import as plain RoPE
        raise ValueError(f"rope_scaling dict has no 'rope_type'/'type' key: {rs!r}")
    if kind == "default":
        return None
    if kind == "linear":
        return ("linear", float(rs["factor"]))
    if kind == "llama3":
        return (
            "llama3",
            float(rs["factor"]),
            float(rs["low_freq_factor"]),
            float(rs["high_freq_factor"]),
            int(rs["original_max_position_embeddings"]),
        )
    raise ValueError(f"unsupported HF rope_scaling type {kind!r} (supported: linear, llama3)")


def _as_dtype(x: np.ndarray, dtype) -> np.ndarray:
    """``x`` in ``dtype``, a numpy or a torch dtype. numpy has no bfloat16:
    a torch dtype numpy lacks rounds the values to it and keeps them in
    float32 arrays (what ``load_tree`` reads)."""
    if isinstance(dtype, torch.dtype):
        try:
            return np.asarray(x, torch.empty(0, dtype=dtype).numpy().dtype)
        except TypeError:
            return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).float().numpy()
    return np.asarray(x, dtype)


def llama_params_from_hf(state_dict: Mapping[str, Any], cfg: TransformerConfig, dtype=np.float32):
    """Convert a ``LlamaForCausalLM`` state dict into this model's params.

    ``state_dict`` values may be torch tensors or numpy arrays. Returns the
    flax params tree for ``DecoderLM(cfg)`` (nested dicts of numpy arrays in
    ``dtype``, a numpy or a torch dtype; load it with
    ``models.transformer.load_flax_params``).
    """
    sd = {k: v for k, v in state_dict.items()}
    h, kh, d, hid = cfg.num_heads, cfg.kv_heads, cfg.head_dim, cfg.hidden_dim

    def take(key: str) -> np.ndarray:
        if key not in sd:
            raise KeyError(f"HF state dict is missing {key!r}")
        return _np(sd.pop(key))

    def qkv_kernel(key: str, heads: int, rope: bool) -> np.ndarray:
        w = take(key)  # [heads*d, hid]
        w = w.reshape(heads, d, hid)
        if rope:
            w = _interleave_rope_rows(w.transpose(0, 2, 1)).transpose(0, 2, 1)
        return np.ascontiguousarray(w.transpose(2, 0, 1))  # [hid, heads, d]

    params: dict[str, Any] = {
        "embed": {"embedding": take("model.embed_tokens.weight")},
        "final_norm": {"scale": take("model.norm.weight")},
    }
    if not cfg.tie_embeddings:
        lm_head = sd.pop("lm_head.weight", None)
        if lm_head is None:  # tied checkpoint loaded into an untied config
            lm_head = np.array(params["embed"]["embedding"])
        params["lm_head"] = {"kernel": _np(lm_head).T}
    else:
        sd.pop("lm_head.weight", None)

    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        params[f"layer_{i}"] = {
            "attn_norm": {"scale": take(p + "input_layernorm.weight")},
            "mlp_norm": {"scale": take(p + "post_attention_layernorm.weight")},
            "attn": {
                "q_proj": {"kernel": qkv_kernel(p + "self_attn.q_proj.weight", h, rope=True)},
                "k_proj": {"kernel": qkv_kernel(p + "self_attn.k_proj.weight", kh, rope=True)},
                "v_proj": {"kernel": qkv_kernel(p + "self_attn.v_proj.weight", kh, rope=False)},
                # o_proj consumes the flattened [H*D] heads: [hid, H*D] -> flax [H*D, hid]
                "o_proj": {"kernel": take(p + "self_attn.o_proj.weight").T},
            },
            "mlp": {
                "gate_proj": {"kernel": take(p + "mlp.gate_proj.weight").T},
                "up_proj": {"kernel": take(p + "mlp.up_proj.weight").T},
                "down_proj": {"kernel": take(p + "mlp.down_proj.weight").T},
            },
        }

    leftovers = [k for k in sd if "rotary_emb" not in k]
    if leftovers:
        raise ValueError(f"unconverted HF weights: {leftovers[:8]}{'...' if len(leftovers) > 8 else ''}")

    def cast(node):
        return {k: cast(v) for k, v in node.items()} if isinstance(node, dict) else _as_dtype(node, dtype)

    return cast(params)


def _split_rope_rows(w: np.ndarray) -> np.ndarray:
    """[..., D] interleaved rotary layout -> half-split (inverse of
    :func:`_interleave_rope_rows`)."""
    d = w.shape[-1]
    out = np.empty_like(w)
    out[..., : d // 2] = w[..., 0::2]
    out[..., d // 2 :] = w[..., 1::2]
    return out


def hf_state_dict_from_params(params: Any, cfg: TransformerConfig) -> dict:
    """The inverse of :func:`llama_params_from_hf`: export this model's
    params (the tree ``models.transformer.to_flax_params`` gives) as a
    ``LlamaForCausalLM``/``MistralForCausalLM`` state dict of float32 numpy
    arrays (wrap in ``torch.from_numpy`` to ``load_state_dict`` into a HF
    model)."""
    h, kh, d = cfg.num_heads, cfg.kv_heads, cfg.head_dim

    def qkv_weight(kernel, heads: int, rope: bool) -> np.ndarray:
        w = _np(kernel).transpose(1, 2, 0)  # [heads, d, hid]
        if rope:
            w = _split_rope_rows(w.transpose(0, 2, 1)).transpose(0, 2, 1)
        return np.ascontiguousarray(w.reshape(heads * d, -1))

    sd: dict[str, np.ndarray] = {
        "model.embed_tokens.weight": _np(params["embed"]["embedding"]),
        "model.norm.weight": _np(params["final_norm"]["scale"]),
    }
    if cfg.tie_embeddings:
        # HF tied models still materialise the tied key in their state dict,
        # and a strict load_state_dict requires it
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    else:
        sd["lm_head.weight"] = np.ascontiguousarray(_np(params["lm_head"]["kernel"]).T)
    for i in range(cfg.num_layers):
        layer = params[f"layer_{i}"]
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = _np(layer["attn_norm"]["scale"])
        sd[p + "post_attention_layernorm.weight"] = _np(layer["mlp_norm"]["scale"])
        attn, mlp = layer["attn"], layer["mlp"]
        sd[p + "self_attn.q_proj.weight"] = qkv_weight(attn["q_proj"]["kernel"], h, rope=True)
        sd[p + "self_attn.k_proj.weight"] = qkv_weight(attn["k_proj"]["kernel"], kh, rope=True)
        sd[p + "self_attn.v_proj.weight"] = qkv_weight(attn["v_proj"]["kernel"], kh, rope=False)
        sd[p + "self_attn.o_proj.weight"] = np.ascontiguousarray(_np(attn["o_proj"]["kernel"]).T)
        sd[p + "mlp.gate_proj.weight"] = np.ascontiguousarray(_np(mlp["gate_proj"]["kernel"]).T)
        sd[p + "mlp.up_proj.weight"] = np.ascontiguousarray(_np(mlp["up_proj"]["kernel"]).T)
        sd[p + "mlp.down_proj.weight"] = np.ascontiguousarray(_np(mlp["down_proj"]["kernel"]).T)
    return sd
