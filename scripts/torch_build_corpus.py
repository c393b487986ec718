#!/usr/bin/env python
"""Corpus builder of the PyTorch port: turn a document stream into a
``.dmlshard`` corpus directory, through ``dmlcloud_tpu_torch.data.store``.

The counterpart of ``scripts/build_corpus.py``, with the same flags and the
same output byte for byte (the format is shared: either package reads a corpus
the other wrote): fixed-header, checksummed, memory-mappable shard files plus
a ``corpus.json`` manifest. Two input modes:

- ``--jsonl FILE``: one document per line — either a JSON array of token
  ids or an object with a ``"tokens"`` key. ``-`` reads stdin, so any
  tokenizer can pipe straight in.
- ``--synthetic N``: N documents with lognormal lengths from a pinned
  seed, token ids from [1, vocab) (0 stays the pad id), handy for driving
  the disk plane without a real corpus.

    python scripts/torch_build_corpus.py --synthetic 768 --out /tmp/corpus
    python scripts/torch_build_corpus.py --jsonl docs.jsonl --out corpus/ --shard-tokens 4194304
    python scripts/torch_build_corpus.py --synthetic 111000 --vocab 32000 --len-median 600 \
        --len-sigma 1.0 --min-len 16 --max-len 8192 --out corpus/   # ~67 M tokens, 16 shards

``--verify`` checksums every shard after the build. Train on the result with
``python -m dmlcloud_tpu_torch.examples.train_lm --corpus corpus/ ...``.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _jsonl_docs(path):
    import numpy as np

    stream = sys.stdin if path == "-" else open(path)
    try:
        for lineno, line in enumerate(stream, 1):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if isinstance(obj, dict):
                obj = obj.get("tokens")
            if not isinstance(obj, list):
                raise SystemExit(f"{path}:{lineno}: expected a token array or {{'tokens': [...]}}")
            yield np.asarray(obj, np.int32)
    finally:
        if stream is not sys.stdin:
            stream.close()


def _synthetic_docs(n, vocab, len_median, len_sigma, min_len, max_len, seed):
    import numpy as np

    rs = np.random.RandomState(seed)
    lengths = np.clip(
        np.round(rs.lognormal(np.log(len_median), len_sigma, n)), min_len, max_len
    ).astype(np.int64)
    for length in lengths:  # token ids from [1, vocab): id 0 stays the pad id
        yield rs.randint(1, vocab, size=int(length)).astype(np.int32)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--jsonl", help="one JSON doc per line (array or {'tokens': [...]}); '-' = stdin")
    src.add_argument("--synthetic", type=int, metavar="N", help="generate N synthetic documents")
    parser.add_argument("--out", required=True, help="corpus directory (created if missing)")
    parser.add_argument("--shard-tokens", type=int, default=1 << 22, help="roll a new shard past this many tokens")
    parser.add_argument("--prefix", default="corpus", help="shard filename prefix")
    parser.add_argument("--vocab", type=int, default=512, help="synthetic: vocab size")
    parser.add_argument("--len-median", type=float, default=64, help="synthetic: median doc length")
    parser.add_argument("--len-sigma", type=float, default=0.6, help="synthetic: lognormal sigma")
    parser.add_argument("--min-len", type=int, default=4, help="synthetic: min doc length")
    parser.add_argument("--max-len", type=int, default=256, help="synthetic: max doc length")
    parser.add_argument("--seed", type=int, default=0, help="synthetic: RNG seed")
    parser.add_argument("--verify", action="store_true", help="checksum every shard after the build")
    args = parser.parse_args(argv)

    from dmlcloud_tpu_torch.data.store import ShardStore, build_corpus

    if args.jsonl is not None:
        docs = _jsonl_docs(args.jsonl)
    else:
        docs = _synthetic_docs(
            args.synthetic, args.vocab, args.len_median, args.len_sigma,
            args.min_len, args.max_len, args.seed,
        )
    manifest = build_corpus(args.out, docs, shard_tokens=args.shard_tokens, prefix=args.prefix)
    print(
        f"wrote {len(manifest['shards'])} shard(s), {manifest['total_records']} record(s), "
        f"{manifest['total_tokens']} token(s) -> {args.out}"
    )
    if args.verify:
        ShardStore(args.out, verify=True)
        print(f"verified {len(manifest['shards'])} shard(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
