"""Autoregressive text generation for ``DecoderLM``.

Counterpart of ``dmlcloud_tpu/models/generate.py``: ``init_cache`` (:39),
``rewind_cache`` (:49), the decode-chunk schedule of ``_chunked_scan`` (:70),
``decode_step`` (:87), ``sample_logits`` (:116), ``_truncate_scaled`` (:140),
``sample_logits_batched`` (:178), ``_pad_len_from_mask`` (:264), ``_check_len``
(:282), ``generate`` (:289) and ``beam_search`` (:426).

A model whose weights ``models.quant.quantize_tree`` quantized decodes as the
reference decodes an int8 tree: ``generate`` and ``beam_search`` call
``prepare_decode_params`` once per call (the reference's in-program
``dequant_tree``/``widen_quant_tree``), and every model call runs the int8
dense layers.

The reference compiles each generation as one XLA program: a prefill, then at
most ``_DECODE_CHUNKS`` ``lax.scan`` segments, each reading a statically
bounded prefix of the cache (``attend_len``) that grows with the fill. Here
the steps are a Python loop over the same schedule, so each step reads the
same cache slots as the reference's; the cache is written in place
(``models/transformer.py``). Random draws take an explicit
``torch.Generator`` in the place of a ``jax.random`` key: sampled tokens are
drawn from the same truncated distribution as the reference's, but are not
the same tokens. Greedy and beam-search tokens are.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.runtime import resolve_device
from .quant import prepare_decode_params
from .transformer import DecoderLM, TransformerConfig

#: The most segments a decode is split into: within a segment every step reads
#: the cache up to the segment's last slot, so attention work grows with the
#: fill while the schedule stays the reference's.
_DECODE_CHUNKS = 8


def init_cache(cfg: TransformerConfig | DecoderLM, batch_size: int, max_len: int | None = None,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed KV cache: ``{layer_i: {k, v: [B, S, KH, D]}}`` on ``device``
    (default ``cuda``; raises without a card unless ``device="cpu"``). Given
    the model, ``KH`` is the KV heads of this rank (``kv_heads / model`` under
    tensor parallelism); given a config, all of them."""
    device = resolve_device(device)
    kv_heads = cfg.local_kv_heads if isinstance(cfg, DecoderLM) else cfg.kv_heads
    cfg = cfg.cfg if isinstance(cfg, DecoderLM) else cfg
    shape = (batch_size, max_len or cfg.max_seq_len, kv_heads, cfg.head_dim)
    return {f"layer_{i}": {"k": torch.zeros(shape, dtype=dtype, device=device),
                           "v": torch.zeros(shape, dtype=dtype, device=device)}
            for i in range(cfg.num_layers)}


def rewind_cache(cache: dict, fill_len) -> dict:
    """A copy of ``cache`` rewound to ``fill_len`` valid positions (an int or
    a [B] tensor): slots at ``position >= fill_len`` are zero, the others
    bitwise as they were."""

    def mask_leaf(x):  # x: [B, S, KH, D]
        fill = torch.as_tensor(fill_len, device=x.device).reshape(-1, 1)
        keep = torch.arange(x.shape[1], device=x.device)[None, :] < fill  # [B or 1, S]
        return torch.where(keep[:, :, None, None], x, torch.zeros((), dtype=x.dtype, device=x.device))

    return {name: {key: mask_leaf(x) for key, x in layer.items()} for name, layer in cache.items()}


def _decode_schedule(first_step: int, n_total: int):
    """``(step, end)`` for the steps ``[first_step, first_step + n_total)``,
    cut into at most ``_DECODE_CHUNKS`` segments; ``end`` is the end of the
    step's segment, from which the caller derives its ``attend_len``."""
    chunk = -(-n_total // _DECODE_CHUNKS) if n_total else 1
    for start in range(first_step, first_step + n_total, chunk):
        end = min(start + chunk, first_step + n_total)
        for i in range(start, end):
            yield i, end


@torch.no_grad()
def decode_step(model: DecoderLM, tokens, cache, *, offset: int = 0, pad_len=None, attend_len=None, pages=None,
                adapters=None, return_hidden: bool = False):
    """The cache-step primitive: one model application that writes
    ``tokens``' K/V into ``cache`` (in place) and returns ``(logits, cache)``.
    ``generate``, ``beam_search`` and the serving engine make their
    cache-carrying model calls through it. ``cache`` is either the dense
    ``init_cache`` tree stepped at ``offset`` (with ``pad_len`` and
    ``attend_len``) or the engine's pool pages stepped through ``pages=(tables,
    fill)``; ``adapters=(stacked_tree, ids)`` adds each row's LoRA delta
    (``serve.AdapterSet.pack``); ``return_hidden`` returns ``((logits,
    hidden), cache)``."""
    return model(tokens, cache=cache, offset=offset, pad_len=pad_len, attend_len=attend_len, pages=pages,
                 adapters=adapters, return_hidden=return_hidden)


def _categorical(logits: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """One draw per row from ``softmax(logits)`` ([B, V]; -inf entries never)."""
    return torch.multinomial(torch.softmax(logits.float(), dim=-1), 1, generator=generator)[:, 0]


def sample_logits(logits: torch.Tensor, temperature: float, top_k: int, top_p: float,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """logits: [B, V] fp32 -> tokens [B]. Greedy at ``temperature == 0``."""
    if temperature == 0.0:
        return logits.argmax(-1)
    logits = logits / temperature
    if top_k > 0:
        kth = logits.topk(top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p < 1.0:
        # nucleus: keep the smallest prefix of the sorted distribution whose
        # mass reaches top_p (the first token always stays; a cumsum that never
        # reaches top_p keeps everything)
        sorted_logits = logits.sort(dim=-1, descending=True).values
        csum = torch.softmax(sorted_logits, dim=-1).cumsum(-1)
        cutoff_idx = (csum < top_p).sum(-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return _categorical(logits, generator)


def _truncate_scaled(logits: torch.Tensor, temperature, top_k, top_p) -> torch.Tensor:
    """Per-row temperature, top-k and nucleus truncation, the parameters as
    ``[B]`` tensors. ``logits`` is ``[B, V]`` or ``[B, T, V]``. Returns the
    logits scaled and masked so that their softmax is each row's sampling
    distribution, by the same ops in the same order as ``sample_logits``.
    Rows with ``temperature == 0`` stay at scale 1; ``top_k <= 0`` and
    ``top_p >= 1`` disable their mask per row."""
    v = logits.shape[-1]
    bshape = (-1,) + (1,) * (logits.dim() - 1)
    temperature, top_k, top_p = (torch.as_tensor(a, device=logits.device).reshape(bshape)
                                 for a in (temperature, top_k, top_p))
    x = logits / torch.where(temperature > 0, temperature, 1.0)
    # top-k: the row's k-th largest value is the cut (k clamped into [1, V] so
    # disabled rows still index validly; their mask is dropped)
    sorted_desc = x.sort(dim=-1, descending=True).values
    kth = sorted_desc.gather(-1, (top_k.clamp(1, v) - 1).expand(*x.shape[:-1], 1).long())
    x = torch.where((top_k > 0) & (x < kth), -torch.inf, x)
    sx = x.sort(dim=-1, descending=True).values
    csum = torch.softmax(sx, dim=-1).cumsum(-1)
    cutoff_idx = (csum < top_p).sum(-1, keepdim=True).clamp(max=v - 1)
    cutoff = sx.gather(-1, cutoff_idx)
    return torch.where((top_p < 1.0) & (x < cutoff), -torch.inf, x)


def sample_logits_batched(logits: torch.Tensor, temperature, top_k, top_p,
                          generator: torch.Generator | None = None) -> torch.Tensor:
    """Per-row twin of ``sample_logits``: ``logits`` is ``[B, V]`` fp32, the
    sampling parameters ``[B]`` tensors, so one call serves mixed greedy and
    sampled rows. Rows with ``temperature == 0`` return the exact argmax."""
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    greedy = logits.argmax(-1)
    sampled = _categorical(_truncate_scaled(logits, temperature, top_k, top_p), generator)
    return torch.where(temperature > 0, sampled, greedy)


def _pad_len_from_mask(prompt_mask, b: int, t: int, device) -> torch.Tensor | None:
    """[B, T] {0, 1} LEFT-pad keep-mask -> per-row pad counts [B] (None
    passes through). A right-padded mask raises: it would decode garbage."""
    if prompt_mask is None:
        return None
    host = np.asarray(prompt_mask.cpu() if isinstance(prompt_mask, torch.Tensor) else prompt_mask).astype(np.int64)
    if host.shape != (b, t):
        raise ValueError(f"prompt_mask must be [B, T] == {(b, t)}, got {host.shape}")
    if not (np.diff(host, axis=1) >= 0).all():
        raise ValueError("prompt_mask must be LEFT padding: zeros then ones per row")
    return torch.from_numpy(t - host.sum(1)).to(device)


def _check_len(model: DecoderLM, t: int, max_new_tokens: int) -> None:
    if t + max_new_tokens > model.cfg.max_seq_len:
        raise ValueError(
            f"prompt ({t}) + max_new_tokens ({max_new_tokens}) exceeds max_seq_len ({model.cfg.max_seq_len})"
        )


def _device_of(model: DecoderLM) -> torch.device:
    return model.embed.weight.device


def _as_prompt(prompt, device) -> torch.Tensor:
    if isinstance(prompt, torch.Tensor):
        return prompt.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=device)


@torch.no_grad()
def generate(
    model: DecoderLM,
    prompt,
    max_new_tokens: int = 32,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: torch.Generator | None = None,
    eos_id: int = -1,
    pad_id: int = 0,
    prompt_mask=None,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` [B, T]. Greedy
    when ``temperature == 0``; otherwise temperature sampling with optional
    ``top_k`` / nucleus ``top_p`` truncation, drawn from ``generator`` (on the
    model's device; None: torch's default generator there). Rows that emit
    ``eos_id`` keep emitting ``pad_id``. Returns [B, max_new_tokens] int64 on
    the model's device.

    Ragged prompts: LEFT-pad them to a common length and pass ``prompt_mask``
    ([B, T] {0, 1}, zeros first): pad slots are masked out of attention and
    rotary positions count from each row's first real token, so every row
    decodes as it would unpadded."""
    device = _device_of(model)
    prompt = _as_prompt(prompt, device)
    b, t = prompt.shape
    _check_len(model, t, max_new_tokens)
    pad_len = _pad_len_from_mask(prompt_mask, b, t, device)
    model = prepare_decode_params(model, model.cfg.dtype)  # int8 kernels stay int8; the rest as it was
    # the cache in the model's compute dtype, so fp32 configs stay exact
    cache = init_cache(model, b, t + max_new_tokens, dtype=model.cfg.dtype, device=device)
    # prefill: one pass over the whole prompt fills slots [0, t); left padding
    # puts every row's last real token in slot t - 1
    logits, cache = decode_step(model, prompt, cache, offset=0, pad_len=pad_len, attend_len=t)
    last = logits[:, -1]
    done = torch.zeros(b, dtype=torch.bool, device=device)

    def sample_next(prev_logits, done):
        tok = sample_logits(prev_logits, temperature, top_k, top_p, generator)
        tok = torch.where(done, pad_id, tok)
        return tok, done | (tok == eos_id)

    out = []
    # N - 1 decode steps (the Nth token needs only a sample); step i writes
    # slot t + i, so the segment ending at `end` reads t + end slots
    for i, end in _decode_schedule(0, max_new_tokens - 1):
        tok, done = sample_next(last, done)
        logits, cache = decode_step(model, tok[:, None], cache, offset=t + i, pad_len=pad_len, attend_len=t + end)
        last = logits[:, 0]
        out.append(tok)
    out.append(sample_next(last, done)[0])
    return torch.stack(out, dim=1)


@torch.no_grad()
def beam_search(
    model: DecoderLM,
    prompt,
    max_new_tokens: int = 32,
    *,
    num_beams: int = 4,
    length_penalty: float = 1.0,
    eos_id: int = -1,
    pad_id: int = 0,
    prompt_mask=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decoding: ``(tokens [B, max_new_tokens], scores [B])``,
    the scores length-normalised sequence log-probs (``sum logp /
    len**length_penalty``). Beams that emit ``eos_id`` freeze and pad. Ragged
    prompts work as in ``generate``: LEFT-pad and pass ``prompt_mask``."""
    device = _device_of(model)
    prompt = _as_prompt(prompt, device)
    b, t = prompt.shape
    _check_len(model, t, max_new_tokens)
    v = model.cfg.vocab_size
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    if num_beams > v:
        raise ValueError("num_beams cannot exceed vocab_size")
    if not 0 <= pad_id < v:
        raise ValueError(f"pad_id must be in [0, vocab_size), got {pad_id}")
    pad_len = _pad_len_from_mask(prompt_mask, b, t, device)
    model = prepare_decode_params(model, model.cfg.dtype)
    k = num_beams
    neg = -1e30

    # prefill once per batch row, then tile the cache across beams
    cache = init_cache(model, b, t + max_new_tokens, dtype=model.cfg.dtype, device=device)
    logits, cache = decode_step(model, prompt, cache, offset=0, pad_len=pad_len, attend_len=t)
    cache = {name: {key: x.repeat_interleave(k, dim=0) for key, x in layer.items()} for name, layer in cache.items()}
    pad_len_k = None if pad_len is None else pad_len.repeat_interleave(k, dim=0)
    first_lp = torch.log_softmax(logits[:, -1].float(), dim=-1)  # [B, V]

    # step 0: the K best first tokens seed the beams
    scores, tok = first_lp.topk(k, dim=-1)  # [B, K]
    finished = tok == eos_id
    tokens = torch.full((b, k, max_new_tokens), pad_id, dtype=torch.long, device=device)
    tokens[:, :, 0] = tok
    lengths = torch.ones((b, k), dtype=torch.long, device=device)  # emitted tokens incl. eos
    # finished beams may only extend with pad, at no cost
    pad_only = torch.full((v,), neg, device=device)
    pad_only[pad_id] = 0.0
    row_base = (torch.arange(b, device=device) * k)[:, None]

    # beam step i writes slot t + i - 1, so the segment ending at `end` reads
    # t + end - 1 slots
    for i, end in _decode_schedule(1, max_new_tokens - 1):
        attend_len = t + end - 1
        logits, cache = decode_step(model, tok.reshape(b * k, 1), cache, offset=t + i - 1, pad_len=pad_len_k,
                                    attend_len=attend_len)
        lp = torch.log_softmax(logits[:, 0].float(), dim=-1).reshape(b, k, v)
        lp = torch.where(finished[..., None], pad_only, lp)
        scores, flat_idx = (scores[..., None] + lp).reshape(b, k * v).topk(k, dim=-1)  # [B, K]
        beam_idx = torch.div(flat_idx, v, rounding_mode="floor")  # which parent beam
        tok = flat_idx % v
        # reorder per-beam state to follow the winning parents. Only the filled
        # prefix of the cache moves; the gather makes a copy before the write,
        # so no beam reads a row another beam has already overwritten
        rows = (row_base + beam_idx).reshape(-1)
        for layer in cache.values():
            for x in layer.values():
                x[:, :attend_len] = x[rows, :attend_len]
        tokens = tokens.gather(1, beam_idx[..., None].expand(-1, -1, max_new_tokens))
        lengths, finished = lengths.gather(1, beam_idx), finished.gather(1, beam_idx)
        tokens[:, :, i] = tok
        lengths = torch.where(finished, lengths, lengths + 1)
        finished = finished | (tok == eos_id)

    # each row's best beam under GNMT-style length normalisation
    norm = scores / lengths.float() ** length_penalty
    best = norm.argmax(1)  # [B]
    best_tokens = tokens.gather(1, best[:, None, None].expand(-1, 1, max_new_tokens))[:, 0]
    return best_tokens, norm.gather(1, best[:, None])[:, 0]
