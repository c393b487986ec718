"""The MoE ``DecoderLM`` in the serving engine, against the reference's
engine on the CPU.

The reference's engine pads each prefill chunk to ``prefill_chunk`` tokens
and each decode batch to its power-of-two bucket, and its MoE blocks route
the padding too. The port's engine pads an MoE model the same way, so with
4 slots (nothing drops) and with 32 slots (28 rows in one batch, capacity
binding) the greedy tokens of a tiny fp32 MoE model (tests/test_torch_moe.py)
are the reference engine's, request for request; so are a speculative
engine's (``spec_k=2``, self-draft) tokens and drafted/accepted counts, its
draft and verify passes padded to the same batch bucket.
"""

import numpy as np
import pytest
import torch

from test_torch_moe import _lm, _tokens

torch.set_num_threads(2)


@pytest.mark.parametrize("max_slots", [4, 32])
def test_moe_engine_tokens_equal_the_reference_engine(max_slots):
    """The reference pads each prefill chunk to ``prefill_chunk`` tokens and
    each decode batch to its power-of-two bucket, and an MoE block routes the
    padding too: its capacity grows with the rows (28 rows: 8 slots per
    expert, their bucket of 32: 16). The port's engine pads an MoE model the
    same way, so the tokens are the reference engine's, request for request
    (without the padding, 28 rows in one batch drop choices the reference
    keeps)."""
    from dmlcloud_tpu.serve.engine import ServeEngine as JEngine
    from dmlcloud_tpu_torch.serve import ServeEngine as TEngine

    jmodel, params, tmodel = _lm()
    n, new = (28, 29) if max_slots == 32 else (6, 6)
    prompts = [_tokens(1, 2 + i % 2, seed=20 + i)[0] for i in range(n)]
    jeng = JEngine(jmodel, params, block_size=4, max_slots=max_slots, prefill_chunk=4, num_blocks=232)
    teng = TEngine(tmodel, block_size=4, max_slots=max_slots, prefill_chunk=4, num_blocks=232)
    jids = [jeng.submit(p, new) for p in prompts]
    tids = [teng.submit(p, new) for p in prompts]
    jdone, tdone = jeng.run(), teng.run()
    for j, t in zip(jids, tids):
        assert tdone[t].tolist() == np.asarray(jdone[j]).tolist()
    assert teng.batch_buckets[-1] == max_slots


def test_moe_spec_engine_equals_the_reference_engine():
    from dmlcloud_tpu.serve.engine import ServeEngine as JEngine
    from dmlcloud_tpu_torch.serve import ServeEngine

    jmodel, params, tmodel = _lm()
    prompts = [_tokens(1, 3 + i % 3, seed=30 + i)[0] for i in range(5)]
    kw = dict(block_size=4, max_slots=4, prefill_chunk=4, num_blocks=64, spec_k=2, batch_buckets=[4])
    res = []
    for engine in (JEngine(jmodel, params, table_buckets=[8], **kw), ServeEngine(tmodel, **kw)):
        rids = [engine.submit(p, 7) for p in prompts]
        engine.run(max_steps=3000)
        res.append(([np.asarray(engine.output(r)).tolist() for r in rids],
                    [(engine.ledger.records[r]["drafted"], engine.ledger.records[r]["accepted"]) for r in rids],
                    engine.leaked_blocks()))
    assert res[1] == res[0]
    assert res[1][2] == 0 and sum(a for _, a in res[1][1]) > 0
