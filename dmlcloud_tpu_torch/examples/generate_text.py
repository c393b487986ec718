"""Inference flows on a DecoderLM: greedy and sampled generation, ragged
prompts and beam search. The counterpart of ``examples/generate_text.py``
on a tiny random-weight model (nothing is downloaded).

Run on one GPU (``--device cpu`` runs on the CPU):

    python -m dmlcloud_tpu_torch.examples.generate_text --max-new 24
    python -m dmlcloud_tpu_torch.examples.generate_text --temperature 0.8 --top-p 0.9
    python -m dmlcloud_tpu_torch.examples.generate_text --beams 4

Row 1 of the batch is a ragged prompt: its first half is left padding, masked
by ``prompt_mask``. ``--int8``, ``--speculative`` and ``--hf`` are the
reference's flags for paths not ported yet; each is a parser error that names
the ROADMAP item it waits for. ``main(argv)`` returns the tokens (and, with
``--beams``, the scores).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dmlcloud_tpu_torch.models.generate import beam_search, generate
from dmlcloud_tpu_torch.models.transformer import DecoderLM, TransformerConfig
from dmlcloud_tpu_torch.parallel.runtime import resolve_device

#: the reference's flags for paths still to port, and the ROADMAP Queue 1 item
#: each waits for
NOT_PORTED = {"int8": "item 7 (int8 decode)", "speculative": "item 9 (speculative decoding)",
              "hf": "item 11 (the HF import)"}


def build_model(args) -> DecoderLM:
    cfg = TransformerConfig(
        vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16, hidden_dim=64, mlp_dim=160,
        max_seq_len=args.prompt_len + args.max_new, dtype=torch.float32,
    )
    device = resolve_device(args.device)
    return DecoderLM(cfg, device=device, generator=torch.Generator(device=device).manual_seed(args.seed))


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--beams", type=int, default=0, help=">0 switches to beam search")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    ap.add_argument("--int8", action="store_true", help="not ported yet")
    ap.add_argument("--speculative", type=int, default=0, metavar="K", help="not ported yet")
    ap.add_argument("--hf", default=None, help="not ported yet")
    args = ap.parse_args(argv)
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag):
            ap.error(f"--{flag} is not ported yet: it waits for ROADMAP Queue 1 {item}")

    model = build_model(args)
    device = model.embed.weight.device
    rng = np.random.RandomState(args.seed)
    prompt = rng.randint(0, model.cfg.vocab_size, (args.batch, args.prompt_len))
    # ragged prompts: row 1 is shorter, LEFT-padded and masked (decode
    # positions and attention then behave as if it were unpadded)
    mask = np.ones((args.batch, args.prompt_len), np.int32)
    if args.batch > 1:
        mask[1, : args.prompt_len // 2] = 0
        prompt[1, : args.prompt_len // 2] = 0

    if args.beams > 0:
        tokens, scores = beam_search(model, prompt, args.max_new, num_beams=args.beams, prompt_mask=mask)
        for row, (toks, score) in enumerate(zip(tokens.tolist(), scores.tolist())):
            print(f"row {row} (beam, score {score:.3f}): {toks}")
        return tokens, scores
    tokens = generate(
        model, prompt, args.max_new, temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        generator=torch.Generator(device=device).manual_seed(args.seed), prompt_mask=mask,
    )
    mode = "greedy" if args.temperature == 0 else f"T={args.temperature}"
    for row, toks in enumerate(tokens.tolist()):
        print(f"row {row} ({mode}): {toks}")
    return tokens


if __name__ == "__main__":
    main()
