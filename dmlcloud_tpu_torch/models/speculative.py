"""Speculative decoding: exact greedy or exact sampled generation with fewer
target passes.

Counterpart of ``dmlcloud_tpu/models/speculative.py``: ``verify_proposals``
(:71), ``init_medusa_heads`` (:155), ``medusa_head_logits`` (:191), the per-row
routine ``_row_spec_decode`` (:203) and ``speculative_generate`` (:456).

A small draft model proposes ``k`` tokens autoregressively; the target
verifies them in one (k+1)-token pass. At temperature 0 it accepts the longest
matching prefix plus its own correction token, so the output is greedy
``generate``'s token for token; at temperature > 0 it runs the
rejection-sampling rule (accept with ``min(1, p_t/p_d)``, resample a rejection
from the residual), distributed exactly as target-only sampling. Either model
may be int8 (``models/quant.py``).

The round structure is the reference's, because the ``rounds``/``accepted``
counts depend on it: the round's first draft pass feeds ``[y[pos-2],
y[pos-1]]`` at offset ``pos-2`` (after a fully accepted round the draft cache
has a one-slot gap at the bonus token, which this pass fills; otherwise it
rewrites a slot identically), then ``k-1`` one-token passes, then the target's
pass over ``[y[pos-1], d_1..d_k]`` at offset ``pos-1``. Rejected proposals
leave stale K/V in both caches, but every round writes the contiguous range
from its own offset and the next offset never passes this one + accepted + 1,
so a stale slot is overwritten (in the pass, before attention reads it)
before the causal mask can expose it; the port's caches, written in place,
keep that invariant. ``return_cache`` rewinds each cache to ``pos - 1``
(``generate.rewind_cache``): every kept slot is then what a plain decode of
the same tokens writes.

The reference ``vmap``s a B=1 routine over the rows inside one
``while_loop`` with the accept decision on the device. Here the rows run one
after another in Python, and each round's advance (accepted count, new
tokens, eos) is read to the host once, which sets the next round's offset.
Sampled tokens come from a ``torch.Generator``: distributed as the
reference's, not the same tokens. Greedy tokens and the counts are the
reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.runtime import resolve_device
from .generate import (_as_prompt, _categorical, _device_of, _pad_len_from_mask, _truncate_scaled, decode_step,
                       init_cache, rewind_cache)
from .quant import prepare_decode_params
from .transformer import DecoderLM

__all__ = ["speculative_generate", "verify_proposals", "init_medusa_heads", "medusa_head_logits"]


def _first_false(x: torch.Tensor) -> torch.Tensor:
    """Index of the first False along the last dim of a bool tensor whose
    last entry is False (jnp.argmin of a bool array)."""
    return (~x).to(torch.uint8).argmax(-1)


def verify_proposals(tlogits, dlogits, proposals, generator, temperature, top_k, top_p, eos_id):
    """The batched accept rule: one verification round for ``B`` rows with
    per-row sampling parameters (the serving engine's speculative step).

    ``tlogits`` is the target's ``[B, k+1, V]`` logits over ``[y_last,
    d_1..d_k]``; ``dlogits`` ``[B, k, V]``, row ``i`` the truncated, scaled
    draft distribution ``d_{i+1}`` was sampled from (``generate._truncate_scaled``;
    unread for greedy rows); ``proposals`` ``[B, k]``; ``temperature``,
    ``top_k``, ``top_p`` and ``eos_id`` are ``[B]``. Rows at temperature 0 take
    the greedy rule (longest matching prefix and the correction token); the
    others rejection-sample against their own truncated distributions, with
    draws from ``generator``.

    Returns ``(new_tokens [B, k+1], n_new [B], n_accept [B])``: the tokens to
    commit (past ``n_new`` meaningless), how many (>= 1, truncated at a row's
    own eos), and the count of accepted proposals."""
    b, kp1, _ = tlogits.shape
    k = kp1 - 1
    dev = tlogits.device
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
    eos_id = torch.as_tensor(eos_id, device=dev).long()
    proposals = proposals.long()
    ar = torch.arange(k + 1, device=dev)[None, :]
    no = torch.zeros((b, 1), dtype=torch.bool, device=dev)

    # greedy rule: longest matching prefix + correction
    greedy_tok = tlogits.argmax(-1)  # [B, k+1]
    n_acc_g = _first_false(torch.cat([proposals == greedy_tok[:, :k], no], 1))
    new_g = torch.where(ar <= n_acc_g[:, None], greedy_tok, 0)

    # rejection sampling (Leviathan et al. 2023), per-row parameters
    tlp = torch.log_softmax(_truncate_scaled(tlogits.float(), temperature, top_k, top_p), -1)  # [B, k+1, V]
    # the (k+1)-th draft row only fills the index: it is selected when every
    # proposal was accepted, where the probabilities come from p_t alone
    dlp = torch.log_softmax(torch.cat([dlogits.float(), torch.zeros_like(dlogits[:, :1]).float()], 1), -1)
    lp_t = tlp[:, :k].gather(-1, proposals[..., None])[..., 0]
    lp_d = dlp[:, :k].gather(-1, proposals[..., None])[..., 0]
    u = torch.rand((b, k), generator=generator, device=dev)
    accept = torch.log(u) < torch.clamp(lp_t - lp_d, max=0.0)
    n_acc_s = _first_false(torch.cat([accept, no], 1))
    at = n_acc_s[:, None, None].expand(-1, 1, tlp.shape[-1])
    p_t, p_d = torch.exp(tlp.gather(1, at)[:, 0]), torch.exp(dlp.gather(1, at)[:, 0])  # [B, V]
    probs = torch.where((n_acc_s == k)[:, None], p_t, torch.clamp(p_t - p_d, min=0.0))
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-30)
    final_tok = _categorical(torch.log(probs + 1e-30), generator)
    prop_pad = torch.cat([proposals, torch.zeros((b, 1), dtype=torch.long, device=dev)], 1)
    new_s = torch.where(ar < n_acc_s[:, None], prop_pad, torch.where(ar == n_acc_s[:, None], final_tok[:, None], 0))

    sampled = temperature > 0
    n_accept = torch.where(sampled, n_acc_s, n_acc_g)
    new_tokens = torch.where(sampled[:, None], new_s, new_g)

    # a row's own eos truncates its round: tokens after the first eos never
    # commit, and the advance stops at the eos inclusive
    is_eos = new_tokens == eos_id[:, None]
    first_eos = is_eos & ~((torch.cumsum(is_eos, 1) - is_eos.long()) > 0)
    hit_eos = (first_eos & (ar <= n_accept[:, None])).any(1)
    n_new = torch.minimum(n_accept + 1, torch.where(hit_eos, first_eos.to(torch.uint8).argmax(1) + 1, k + 1))
    return new_tokens, n_new, n_accept


def init_medusa_heads(cfg, k: int, generator: torch.Generator | None = None, lm_head_kernel=None) -> dict:
    """Parameters of ``k - 1`` Medusa decode heads (Cai et al.): head ``h``
    predicts the token ``h + 2`` positions past the round's anchor from the
    hidden state the LM head reads, as one residual block
    ``logits_h = (hidden + silu(hidden @ w1[h] + b1[h])) @ w2[h]``, stacked:
    ``w1 [k-1, D, D]``, ``b1 [k-1, D]``, ``w2 [k-1, D, V]``, fp32. ``w1`` and
    ``b1`` start at zero, so a fresh head is the identity block; with
    ``lm_head_kernel`` (``[D, V]``, the base model's unembedding, e.g.
    ``transformer.lm_head_kernel(model)[0]``) every head starts as a copy of
    the base head, else ``w2`` draws ``0.02``-scaled normals from
    ``generator`` (None: seed 0 on the default device). ``k == 1`` gives empty
    stacks."""
    if k < 1:
        raise ValueError(f"k (proposals per Medusa round) must be >= 1, got {k}")
    d, v, h = cfg.hidden_dim, cfg.vocab_size, k - 1
    if lm_head_kernel is not None:
        kernel = torch.as_tensor(np.asarray(lm_head_kernel) if not isinstance(lm_head_kernel, torch.Tensor)
                                 else lm_head_kernel).float()
        device = kernel.device
        w2 = kernel[None].expand(h, d, v).clone()
    else:
        if generator is None:
            generator = torch.Generator(device=resolve_device(None)).manual_seed(0)
        device = generator.device
        w2 = 0.02 * torch.randn((h, d, v), generator=generator, device=device, dtype=torch.float32)
    return {"w1": torch.zeros((h, d, d), dtype=torch.float32, device=device),
            "b1": torch.zeros((h, d), dtype=torch.float32, device=device), "w2": w2}


def medusa_head_logits(heads: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Every Medusa head on one batch of final hidden states: ``hidden [B, D]``
    -> ``[B, k-1, V]`` fp32 (``init_medusa_heads``' residual form), as two
    stacked einsums."""
    hidden = hidden.float()
    pre = torch.einsum("bd,hde->bhe", hidden, heads["w1"]) + heads["b1"][None]
    res = hidden[:, None, :] + torch.nn.functional.silu(pre)
    return torch.einsum("bhd,hdv->bhv", res, heads["w2"])


def _row_spec_decode(target: DecoderLM, draft: DecoderLM, prompt: torch.Tensor, pad_len, max_new_tokens: int,
                     k: int, eos_id: int, pad_id: int, temperature: float, generator, return_cache: bool):
    """One row: ``(tokens [max_new_tokens], (rounds, advanced, accepted),
    caches or None)``."""
    sampled = temperature > 0
    device = prompt.device
    t = prompt.shape[0]
    # slack: the last round may propose past the output; those writes land in
    # the slack and are cut off at the end
    cache_len = t + max_new_tokens + k + 1
    tcache = init_cache(target, 1, cache_len, dtype=target.cfg.dtype, device=device)
    dcache = init_cache(draft, 1, cache_len, dtype=draft.cfg.dtype, device=device)
    row = prompt[None]
    tlogits, tcache = decode_step(target, row, tcache, offset=0, pad_len=pad_len, attend_len=t)
    _, dcache = decode_step(draft, row, dcache, offset=0, pad_len=pad_len, attend_len=t)

    def pick(logits):
        """A token from one row of logits: argmax, or a temperature sample."""
        if not sampled:
            return logits.argmax(-1)
        return _categorical((logits.float() / temperature)[None], generator)[0]

    ar = torch.arange(k + 1, device=device)
    y = torch.zeros(cache_len, dtype=torch.long, device=device)
    y[:t] = prompt
    first_tok = pick(tlogits[0, -1])  # the first new token needs no speculation
    y[t] = first_tok
    pos, rounds, accepted = t + 1, 0, 0
    done = int(first_tok) == eos_id
    while pos < t + max_new_tokens and not done:
        # the draft proposes k tokens in k passes, the first over two tokens
        logits, dcache = decode_step(draft, y[pos - 2 : pos][None], dcache, offset=pos - 2, pad_len=pad_len,
                                     attend_len=cache_len)
        nxt = pick(logits[0, -1])
        props, drows = [nxt], [logits[0, -1]]
        for i in range(1, k):
            logits, dcache = decode_step(draft, nxt.view(1, 1), dcache, offset=pos - 1 + i, pad_len=pad_len,
                                         attend_len=cache_len)
            nxt = pick(logits[0, 0])
            props.append(nxt)
            drows.append(logits[0, 0])
        proposals = torch.stack(props)  # [k]
        # the target verifies y[pos-1], d_1..d_k in one pass
        x = torch.cat([y[pos - 1 : pos], proposals])[None]
        tlogits, tcache = decode_step(target, x, tcache, offset=pos - 1, pad_len=pad_len, attend_len=cache_len)
        if not sampled:
            greedy = tlogits[0].argmax(-1)  # [k+1]: the target's tokens for pos..pos+k
            n_accept = _first_false(torch.cat([proposals == greedy[:k], ar[:1] < 0]))
            new_tokens = torch.where(ar <= n_accept, greedy, pad_id)
        else:
            tlp = torch.log_softmax(tlogits[0].float() / temperature, -1)  # [k+1, V]
            dlogits = torch.cat([torch.stack(drows), torch.zeros_like(drows[0])[None]])
            dlp = torch.log_softmax(dlogits.float() / temperature, -1)
            idx = ar[:k]
            u = torch.rand(k, generator=generator, device=device)
            accept = torch.log(u) < torch.clamp(tlp[idx, proposals] - dlp[idx, proposals], max=0.0)
            n_accept = _first_false(torch.cat([accept, ar[:1] < 0]))
            # residual resample on a rejection; a plain target sample when all
            # k were accepted (the placeholder draft row is never selected)
            p_t = torch.exp(tlp[n_accept])
            probs = torch.where(n_accept == k, p_t, torch.clamp(p_t - torch.exp(dlp[n_accept]), min=0.0))
            probs = probs / torch.clamp(probs.sum(), min=1e-30)
            final_tok = _categorical(torch.log(probs + 1e-30)[None], generator)[0]
            prop_pad = torch.cat([proposals, proposals.new_full((1,), pad_id)])
            new_tokens = torch.where(ar < n_accept, prop_pad, torch.where(ar == n_accept, final_tok, pad_id))
        # tokens past the first eos inside the round do not count
        is_eos = new_tokens == eos_id
        seen_eos = (torch.cumsum(is_eos, 0) - is_eos.long()) > 0
        new_tokens = torch.where(seen_eos, pad_id, new_tokens)
        first_eos = is_eos & ~seen_eos
        hit_eos = (first_eos & (ar <= n_accept)).any()
        n_new = torch.minimum(n_accept + 1, torch.where(hit_eos, first_eos.to(torch.uint8).argmax() + 1, k + 1))
        y[pos : pos + k + 1] = new_tokens
        # the round's one host read: how far it advanced
        n_new, n_acc, hit = torch.stack([n_new, n_accept, hit_eos.long()]).tolist()
        pos, rounds, accepted, done = pos + n_new, rounds + 1, accepted + n_acc, bool(hit)
    fill = pos - t
    out = y[t : t + max_new_tokens]
    out = torch.where(torch.arange(max_new_tokens, device=device) < fill, out, pad_id)
    caches = None
    if return_cache:
        # slot pos-1 is the one the overwrite invariant does not reach (a
        # rejected draft's K/V, or a bonus token's unwritten slot): rewind to it
        caches = rewind_cache(tcache, pos - 1), rewind_cache(dcache, pos - 1)
    return out, (rounds, fill, accepted), caches


@torch.no_grad()
def speculative_generate(
    target: DecoderLM,
    draft: DecoderLM,
    prompt,
    max_new_tokens: int = 32,
    *,
    k: int = 4,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    prompt_mask=None,
    eos_id: int = -1,
    pad_id: int = 0,
    return_stats: bool = False,
    return_cache: bool = False,
):
    """Decode ``max_new_tokens`` continuations of ``prompt`` [B, T] with
    ``draft`` proposing ``k`` tokens per target verification pass: at
    ``temperature == 0`` token-identical to greedy ``generate(target, ...)``;
    at ``temperature > 0`` speculative sampling by rejection, distributed as
    target-only sampling at that temperature (draws from ``generator``;
    None: seed 0 on the target's device). Returns ``[B, max_new_tokens]``
    int64 on the target's device.

    Both models share the vocabulary; either may be int8. Ragged prompts
    work as in ``generate``: LEFT-pad and pass ``prompt_mask``.

    ``return_stats=True`` also returns ``(rounds, advanced, accepted)``, int64
    ``[B]``: the verification rounds (target passes), the positions each row
    advanced (up to ``k`` past ``max_new_tokens`` when the last round
    overshoots), and the accepted proposals, so the accept rate is
    ``accepted / (rounds * k)``. ``return_cache=True`` also returns
    ``(target_cache, draft_cache)``, each row rewound to ``advanced - 1``
    valid positions, leaves ``[B, S, KH, D]``."""
    device = _device_of(target)
    prompt = _as_prompt(prompt, device)
    b, t = prompt.shape
    if k < 1:
        raise ValueError(f"k (draft proposals per round) must be >= 1, got {k}")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    for m, name in ((target, "target"), (draft, "draft")):
        if t + max_new_tokens + k + 1 > m.cfg.max_seq_len:
            raise ValueError(
                f"prompt ({t}) + max_new_tokens ({max_new_tokens}) + k+1 ({k + 1}) exceeds the "
                f"{name} model's max_seq_len ({m.cfg.max_seq_len})"
            )
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    pad_len = _pad_len_from_mask(prompt_mask, b, t, device)
    target = prepare_decode_params(target, target.cfg.dtype)
    draft = prepare_decode_params(draft, draft.cfg.dtype)
    rows = [_row_spec_decode(target, draft, prompt[r], None if pad_len is None else pad_len[r : r + 1],
                             int(max_new_tokens), int(k), int(eos_id), int(pad_id), float(temperature), generator,
                             bool(return_cache)) for r in range(b)]
    out = torch.stack([r[0] for r in rows])
    extras = []
    if return_stats:
        extras.append(tuple(torch.tensor([r[1][j] for r in rows], dtype=torch.long, device=device) for j in range(3)))
    if return_cache:
        extras.append(tuple(
            {name: {key: torch.cat([r[2][i][name][key] for r in rows]) for key in ("k", "v")} for name in rows[0][2][i]}
            for i in range(2)))
    return (out, *extras) if extras else out
