"""The sort, merge and compaction primitives against numpy oracles.

``packed.merge_sorted``, ``packed.compact`` and ``packed.sort`` are the
only sort/compaction entry points of the build pipeline; each is checked
here against a plain numpy formulation of the same semantics (sorted
lanes, PADs at the tail, payloads paired with their keys, stable order),
as is ``packed.isin_merge``, the sort-based membership test built on them.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from metagraph_tpu.common import packed

PAD = 0xFFFFFFFF


def _mk(rng, n_valid, cap, L=2, hi=1 << 63):
    """(L, cap) lanes: ``n_valid`` sorted keys, then a PAD tail."""
    if L == 1:
        hi = min(hi, 1 << 31)          # keep single-lane keys sorted + < PAD
    v = rng.integers(0, hi, n_valid).astype(np.uint64)
    # sort by the LANE TUPLE order (what merge_sorted requires), not by v
    v = ((v >> 33) << 32) | (v & 0xFFFFFFFF)
    v.sort()
    lanes = np.full((L, cap), PAD, np.uint32)
    if n_valid:
        lanes[L - 1, :n_valid] = (v & 0xFFFFFFFF).astype(np.uint32)
        if L > 1:
            lanes[L - 2, :n_valid] = (v >> 32).astype(np.uint32)
        for j in range(max(L - 2, 0)):
            lanes[j, :n_valid] = 0
    return lanes


def _np_sort(lanes, *extras):
    """Stable lexicographic sort over lanes (lane 0 most significant)."""
    order = np.lexsort([lanes[j] for j in range(lanes.shape[0] - 1, -1, -1)])
    return lanes[:, order], tuple(e[order] for e in extras)


def _np_compact(lanes, keep, capacity, *extras, extra_fill=0):
    idx = np.nonzero(keep)[0][:capacity]
    out = np.full((lanes.shape[0], capacity), PAD, np.uint32)
    out[:, :len(idx)] = lanes[:, idx]
    outs = []
    for e in extras:
        o = np.full(capacity, extra_fill, e.dtype)
        o[:len(idx)] = e[idx]
        outs.append(o)
    return out, int(keep.sum()), tuple(outs)


# ---------------------------------------------------------------------------
# merge_sorted
# ---------------------------------------------------------------------------

MERGE_CASES = [
    (100, 200, 8192, 8192, 2),
    (8192, 8192, 8192, 8192, 2),
    (5000, 9000, 8192, 16384, 3),
    (0, 50, 8192, 8192, 2),
    (300, 0, 1024, 512, 1),
    (7000, 7000, 8192, 8192, 2),
]


@pytest.mark.parametrize("na,nb,ca,cb,L", MERGE_CASES)
def test_merge_sorted_matches_numpy(na, nb, ca, cb, L):
    rng = np.random.default_rng(na * 31 + nb)
    a, b = _mk(rng, na, ca, L), _mk(rng, nb, cb, L)
    pa = rng.integers(0, 1 << 30, ca).astype(np.int32)
    pb = rng.integers(0, 1 << 30, cb).astype(np.int32)
    got, (gp,) = packed.merge_sorted(jnp.asarray(a), jnp.asarray(b),
                                     (jnp.asarray(pa),), (jnp.asarray(pb),))
    want, (wp,) = _np_sort(np.concatenate([a, b], axis=1),
                           np.concatenate([pa, pb]))
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(np.asarray(gp), wp)


def test_merge_sorted_duplicate_heavy():
    """Massively duplicated keys: equal keys stay adjacent, A's first."""
    rng = np.random.default_rng(7)
    a = np.full((2, 8192), PAD, np.uint32)
    b = np.full((2, 8192), PAD, np.uint32)
    a[0, :4096] = b[0, :4096] = 0
    a[1, :4096] = np.sort(rng.integers(0, 37, 4096))
    b[1, :4096] = np.sort(rng.integers(0, 37, 4096))
    tag_a, tag_b = np.zeros(8192, np.int32), np.ones(8192, np.int32)
    got, (gt,) = packed.merge_sorted(jnp.asarray(a), jnp.asarray(b),
                                     (jnp.asarray(tag_a),),
                                     (jnp.asarray(tag_b),))
    want, (wt,) = _np_sort(np.concatenate([a, b], axis=1),
                           np.concatenate([tag_a, tag_b]))
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(np.asarray(gt), wt)


def test_merge_sorted_zero_width_sides():
    rng = np.random.default_rng(2)
    a = jnp.asarray(_mk(rng, 100, 1024, 2))
    empty = jnp.full((2, 0), PAD, jnp.uint32)
    got, _ = packed.merge_sorted(a, empty)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(a))
    got2, _ = packed.merge_sorted(empty, a)
    np.testing.assert_array_equal(np.asarray(got2), np.asarray(a))


# ---------------------------------------------------------------------------
# compact
# ---------------------------------------------------------------------------

COMPACT_CASES = [
    # (n, capacity, keep_frac, L)
    (1024, 1024, 0.5, 2),      # capacity == n
    (4096, 4096, 0.3, 2),
    (3000, 3000, 0.5, 2),      # n not a power of two
    (2048, 512, 0.7, 2),       # capacity < n (truncation + true count)
    (1500, 8192, 0.4, 3),      # capacity > n (tail fill), 3 lanes
    (2048, 2048, 1.0, 2),      # all-keep
    (2048, 2048, 0.0, 2),      # none-keep
    (1024, 1024, 0.01, 1),     # sparse keep, single lane
]


@pytest.mark.parametrize("n,capacity,frac,L", COMPACT_CASES)
def test_compact_matches_numpy(n, capacity, frac, L):
    rng = np.random.default_rng(n * 7 + capacity + L)
    lanes = rng.integers(0, 1 << 31, (L, n)).astype(np.uint32)
    keep = rng.random(n) < frac
    p_i32 = rng.integers(0, 1 << 30, n).astype(np.int32)
    p_u32 = rng.integers(0, 1 << 32, n).astype(np.uint32)
    got, gcount, (gi, gu) = packed.compact(
        jnp.asarray(lanes), jnp.asarray(keep), capacity,
        jnp.asarray(p_i32), jnp.asarray(p_u32))
    want, wcount, (wi, wu) = _np_compact(lanes, keep, capacity, p_i32,
                                         p_u32)
    assert int(gcount) == wcount
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(np.asarray(gi), wi)
    np.testing.assert_array_equal(np.asarray(gu), wu)


def test_compact_extra_fill():
    rng = np.random.default_rng(5)
    n = 1024
    lanes = rng.integers(0, 1 << 31, (2, n)).astype(np.uint32)
    keep = rng.random(n) < 0.25
    pay = rng.integers(0, 100, n).astype(np.int32)
    got, _, (gp,) = packed.compact(jnp.asarray(lanes), jnp.asarray(keep),
                                   2048, jnp.asarray(pay), extra_fill=-7)
    want, _, (wp,) = _np_compact(lanes, keep, 2048, pay, extra_fill=-7)
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(np.asarray(gp), wp)


def test_compact_stability():
    """Kept entries keep their original relative order."""
    n = 2048
    rng = np.random.default_rng(13)
    lanes = jnp.asarray(rng.integers(0, 17, (2, n)).astype(np.uint32))
    keep = rng.random(n) < 0.6
    idx = jnp.arange(n, dtype=jnp.int32)
    _, gcount, (gidx,) = packed.compact(lanes, jnp.asarray(keep), n, idx)
    np.testing.assert_array_equal(np.asarray(gidx)[:int(gcount)],
                                  np.nonzero(keep)[0])


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------

SORT_CASES = [
    # (n_valid, cap, L): duplicates likely (small value range)
    (4000, 4096, 2),
    (8192, 8192, 2),
    (5000, 6144, 3),
    (900, 1024, 2),
    (10000, 10240, 1),
]


@pytest.mark.parametrize("n,cap,L", SORT_CASES)
def test_sort_matches_numpy(n, cap, L):
    rng = np.random.default_rng(n + cap + L)
    lanes = np.full((L, cap), PAD, np.uint32)
    for j in range(L):
        lanes[j, :n] = rng.integers(0, 50, n).astype(np.uint32)
    pay = rng.integers(0, 1 << 30, cap).astype(np.int32)
    got, (gp,) = packed.sort(jnp.asarray(lanes), jnp.asarray(pay))
    want, (wp,) = _np_sort(lanes, pay)
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(np.asarray(gp), wp)


def test_sort_random_large():
    """Mostly-unique 64-bit keys in two lanes."""
    rng = np.random.default_rng(77)
    n, cap = 50000, 51200
    v = rng.integers(0, 1 << 62, n).astype(np.uint64)
    lanes = np.full((2, cap), PAD, np.uint32)
    lanes[0, :n] = (v >> 32).astype(np.uint32)
    lanes[1, :n] = (v & 0xFFFFFFFF).astype(np.uint32)
    got, _ = packed.sort(jnp.asarray(lanes))
    want, _ = _np_sort(lanes)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("n,q,L", [(0, 5, 2), (7, 0, 2), (300, 500, 2),
                                   (1000, 64, 1)])
def test_isin_merge_matches_numpy(n, q, L):
    """Unsorted keys with repeats; queries in any order, with repeats and
    PADs; the answer comes back in query order."""
    rng = np.random.default_rng(n + q + L)
    keys = rng.integers(0, 40, (L, n)).astype(np.uint32)
    queries = rng.integers(0, 40, (L, q)).astype(np.uint32)
    queries[:, ::7] = PAD
    got = np.asarray(packed.isin_merge(jnp.asarray(keys),
                                       jnp.asarray(queries)))
    key_set = {tuple(c) for c in keys.T}
    want = np.array([tuple(c) in key_set for c in queries.T], bool)
    np.testing.assert_array_equal(got, want)
