"""Inference flows on a DecoderLM: greedy and sampled generation, ragged
prompts, beam search, int8 weights and speculative decoding. The counterpart
of ``examples/generate_text.py`` on a tiny random-weight model (nothing is
downloaded).

Run on one GPU (``--device cpu`` runs on the CPU):

    python -m dmlcloud_tpu_torch.examples.generate_text --max-new 24
    python -m dmlcloud_tpu_torch.examples.generate_text --temperature 0.8 --top-p 0.9
    python -m dmlcloud_tpu_torch.examples.generate_text --beams 4
    python -m dmlcloud_tpu_torch.examples.generate_text --int8          # weight-only int8 decode
    python -m dmlcloud_tpu_torch.examples.generate_text --speculative 4 # draft-verified greedy

Row 1 of the batch is a ragged prompt: its first half is left padding, masked
by ``prompt_mask``. ``--hf`` is the reference's flag for the HF import, not
ported yet: a parser error that names the ROADMAP item it waits for.
``main(argv)`` returns the tokens (and, with ``--beams``, the scores).
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
NOT_PORTED = {"hf": "item 11 (the HF import)"}


def build_model(args) -> DecoderLM:
    # speculative decoding writes up to k+1 proposal slots past the output
    spec = getattr(args, "speculative", 0)
    cfg = TransformerConfig(
        vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16, hidden_dim=64, mlp_dim=160,
        max_seq_len=args.prompt_len + args.max_new + (spec + 1 if spec else 0), dtype=torch.float32,
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
    ap.add_argument("--int8", action="store_true", help="weight-only int8 quantized decode (models/quant.py)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="decode via a 1-layer draft proposing K tokens/round (models/speculative.py; greedy here, "
                         "sampled with --temperature); prints the tokens and whether they match plain greedy")
    ap.add_argument("--hf", default=None, help="not ported yet")
    args = ap.parse_args(argv)
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag):
            ap.error(f"--{flag} is not ported yet: it waits for ROADMAP Queue 1 {item}")

    model = build_model(args)
    device = model.embed.weight.device
    if args.int8:
        from dmlcloud_tpu_torch.models.quant import quantize_tree, quantized_size

        model = quantize_tree(model)
        q, full = quantized_size(model)
        print(f"int8 weights: {q / 1e6:.2f} MB vs {full / 1e6:.2f} MB bf16 "
              f"({full / q:.2f}x less HBM weight traffic per decoded token)")
    rng = np.random.RandomState(args.seed)
    prompt = rng.randint(0, model.cfg.vocab_size, (args.batch, args.prompt_len))
    # ragged prompts: row 1 is shorter, LEFT-padded and masked (decode
    # positions and attention then behave as if it were unpadded)
    mask = np.ones((args.batch, args.prompt_len), np.int32)
    if args.batch > 1:
        mask[1, : args.prompt_len // 2] = 0
        prompt[1, : args.prompt_len // 2] = 0

    if args.speculative > 0:
        import dataclasses

        from dmlcloud_tpu_torch.models.speculative import speculative_generate

        # a small draft: a random 1-layer twin (low acceptance: the demo is of
        # the API and of the exactness, not of speed)
        draft = DecoderLM(dataclasses.replace(model.cfg, num_layers=1), device=device,
                          generator=torch.Generator(device=device).manual_seed(args.seed + 1))
        spec, (rounds, advanced, accepted) = speculative_generate(
            model, draft, prompt, args.max_new, k=args.speculative, temperature=args.temperature,
            generator=torch.Generator(device=device).manual_seed(args.seed), prompt_mask=mask, return_stats=True,
        )
        mode = "greedy" if args.temperature == 0 else f"sampled T={args.temperature}"
        for row, toks in enumerate(spec.tolist()):
            print(f"row {row} (speculative k={args.speculative}, {mode}): {toks}")
        rounds, advanced, accepted = (x.double().cpu().numpy() for x in (rounds, advanced, accepted))
        # max_new=1 needs no verification round: there is no rate to report
        rate = (f"{np.mean(accepted / (rounds * args.speculative)):.2f}" if rounds.min() > 0
                else "n/a (no verification rounds)")
        print(f"target passes: {rounds.mean():.1f} rounds/row for {advanced.mean():.1f} tokens "
              f"(draft accept rate {rate})")
        if args.temperature == 0:  # sampled mode matches in distribution, not per token
            plain = generate(model, prompt, args.max_new, prompt_mask=mask)
            print(f"matches plain greedy: {bool(torch.equal(spec, plain))}")
        return spec
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
