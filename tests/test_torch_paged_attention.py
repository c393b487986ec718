"""The port's paged KV indexing against the JAX package, on the CPU.

``gather_pages``/``scatter_tokens`` of ``dmlcloud_tpu_torch.ops.paged_attention``
must give bitwise the pools and views of ``dmlcloud_tpu.ops.paged_attention``
in the five cases of tests/test_serve.py's ``TestPagedIndexing`` (sentinel
rows, a position past the table, a negative position, a multi-token write
across a block boundary) and on random tables and positions. The reference
leans on JAX clipping an out-of-bounds gather and dropping an out-of-bounds
scatter; the port masks both explicitly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlcloud_tpu.ops import paged_attention as jpa
from dmlcloud_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(2)


def _values(shape, start=0.0):
    return (np.arange(np.prod(shape), dtype=np.float32) + start).reshape(shape)


#: (pool, tables, positions, values): tests/test_serve.py TestPagedIndexing
CASES = {
    "roundtrip": (np.zeros((5, 4, 2, 3), np.float32), [[3, 1]], [list(range(6))], _values((1, 6, 2, 3))),
    "sentinel_writes_dropped": (np.ones((2, 4, 1, 1), np.float32), [[2, 2]], [[0, 1, 2]],
                                np.full((1, 3, 1, 1), 7.0, np.float32)),
    "position_past_table_width": (np.zeros((3, 2, 1, 1), np.float32), [[1]], [[4]],
                                  np.full((1, 1, 1, 1), 5.0, np.float32)),
    "negative_position_dropped": (np.zeros((3, 2, 1, 1), np.float32), [[0, 1]], [[-1, 0]],
                                  np.full((1, 2, 1, 1), 5.0, np.float32)),
    "multi_token_across_blocks": (np.zeros((4, 2, 1, 1), np.float32), [[2, 0]], [[1, 2, 3]],
                                  np.asarray([10.0, 20.0, 30.0], np.float32).reshape(1, 3, 1, 1)),
}


def _both(pool, tables, positions, values):
    """(jax pool, jax view), (port pool, port view) after one scatter and a gather."""
    tables, positions = np.asarray(tables, np.int32), np.asarray(positions, np.int32)
    jpool = jpa.scatter_tokens(jnp.asarray(pool), jnp.asarray(tables), jnp.asarray(positions), jnp.asarray(values))
    jview = jpa.gather_pages(jpool, jnp.asarray(tables))
    tpool = torch.from_numpy(pool.copy())
    out = tpa.scatter_tokens(tpool, torch.from_numpy(tables).long(), torch.from_numpy(positions).long(),
                             torch.from_numpy(values))
    assert out is tpool  # written in place
    tview = tpa.gather_pages(tpool, torch.from_numpy(tables).long())
    return (np.asarray(jpool), np.asarray(jview)), (tpool.numpy(), tview.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_scatter_and_gather_bitwise_the_reference(case):
    (jpool, jview), (tpool, tview) = _both(*CASES[case])
    np.testing.assert_array_equal(tpool, jpool)
    np.testing.assert_array_equal(tview, jview)


def test_the_cases_land_where_the_reference_tests_say():
    (_, _), (pool, view) = _both(*CASES["roundtrip"])
    np.testing.assert_array_equal(view[0, :6], CASES["roundtrip"][3][0])
    assert (view[0, 6:] == 0).all()
    (_, _), (pool, _) = _both(*CASES["sentinel_writes_dropped"])
    assert (pool == 1).all()
    (_, _), (pool, _) = _both(*CASES["position_past_table_width"])
    assert (pool == 0).all()
    (_, _), (pool, _) = _both(*CASES["negative_position_dropped"])
    assert pool[0, 0, 0, 0] == 5.0 and pool.sum() == 5.0
    (_, _), (pool, view) = _both(*CASES["multi_token_across_blocks"])
    assert (pool[2, 1, 0, 0], pool[0, 0, 0, 0], pool[0, 1, 0, 0]) == (10.0, 20.0, 30.0)
    np.testing.assert_array_equal(view[0, 1:4, 0, 0], [10.0, 20.0, 30.0])


@pytest.mark.parametrize("seed", range(4))
def test_random_tables_with_sentinels_bitwise_the_reference(seed):
    """Rows own distinct blocks (a padded row owns none), tables are padded
    with the sentinel, and positions run from below 0 to past the table."""
    rs = np.random.RandomState(seed)
    num_blocks, block_size, b, nb, t = 12, 4, 3, 3, 5
    owned = rs.permutation(num_blocks)[: b * nb].reshape(b, nb)
    tables = np.where(rs.rand(b, nb) < 0.3, num_blocks, owned)  # sentinel entries
    tables[-1] = num_blocks  # a padded row: sentinel only
    positions = rs.randint(-3, nb * block_size + 4, (b, t))
    for row in range(b):  # distinct positions per row (distinct targets)
        positions[row] = rs.choice(np.arange(-3, nb * block_size + 4), t, replace=False)
    pool = rs.randn(num_blocks, block_size, 2, 3).astype(np.float32)
    values = rs.randn(b, t, 2, 3).astype(np.float32)
    (jpool, jview), (tpool, tview) = _both(pool, tables, positions, values)
    np.testing.assert_array_equal(tpool, jpool)
    np.testing.assert_array_equal(tview, jview)


def test_write_index_drops_what_the_reference_drops():
    tables = torch.tensor([[3, 5], [5, 5]])  # num_blocks 5: entry 5 is the sentinel
    positions = torch.tensor([[-1, 0, 5, 8], [0, 1, 2, 3]])
    row, col, block, slot = tpa.write_index(tables, positions, num_blocks=5, block_size=4)
    # kept: row 0's positions 0 (block 3, slot 0); 5 lies in the sentinel entry
    # and 8 past the table, -1 below it; row 1 is all sentinel
    assert row.tolist() == [0] and col.tolist() == [1]
    assert block.tolist() == [3] and slot.tolist() == [0]


def test_bf16_values_are_cast_to_the_pool_dtype_like_the_reference():
    rs = np.random.RandomState(9)
    pool = np.zeros((4, 2, 1, 2), np.float32)
    values = rs.randn(1, 3, 1, 2).astype(np.float32)
    jpool = jpa.scatter_tokens(jnp.asarray(pool, jnp.bfloat16), jnp.asarray([[1, 2]], jnp.int32),
                               jnp.asarray([[0, 1, 2]], jnp.int32), jnp.asarray(values))
    tpool = tpa.scatter_tokens(torch.zeros(4, 2, 1, 2, dtype=torch.bfloat16), torch.tensor([[1, 2]]),
                               torch.tensor([[0, 1, 2]]), torch.from_numpy(values))
    np.testing.assert_array_equal(tpool.float().numpy(), np.asarray(jpool.astype(jnp.float32)))
