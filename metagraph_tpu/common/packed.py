"""Multi-lane packed big-integer tensors — the universal k-mer currency.

Device-side replacement for the reference's 64/128/256-bit packed k-mer
integers (reference: metagraph/src/kmer/kmer_boss.hpp:29, kmer.hpp:29).
Instead of wide scalar integers manipulated one k-mer at a time, we hold a
*batch* of N big integers as a lane-major ``(L, N) uint32`` tensor:

  * lane 0 is the most significant 32 bits, lane L-1 the least significant;
  * lexicographic comparison over lanes == integer comparison, so
    ``jax.lax.sort`` over the lane tuple sorts a whole batch in BOSS
    (colex + edge label) order — this replaces ips4o
    (reference: boss_chunk_construct.cpp:280-306);
  * every bit operation (shift by a whole number of characters, masks,
    char extract) is a vectorized uint32 shift/mask over lanes, with no
    scalar loops.

Characters are stored in *nibble-aligned* fields: ``bits_per_char`` must
divide 32 (we use 4 for DNA incl. the ``$`` sentinel, 8 for protein), so a
character never straddles a lane boundary.  This costs up to 1 bit/char of
device memory vs the reference's 3-bit sentinel packing but removes all
funnel-shift straddle logic from the hot path.

All functions are pure, shape-polymorphic in N, static in L/B/K, and safe
under ``jax.jit``/``vmap``/``shard_map``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

LANE_BITS = 32
LANE_DTYPE = jnp.uint32
# Padding value: all-ones big integer; sorts after every valid k-mer
# (valid k-mers always have zero top bits since alphabets use <= B bits).
PAD_LANE = np.uint32(0xFFFFFFFF)


def num_lanes(num_chars: int, bits_per_char: int) -> int:
    """Lanes needed for ``num_chars`` fields of ``bits_per_char`` bits."""
    assert LANE_BITS % bits_per_char == 0, "bits_per_char must divide 32"
    total = num_chars * bits_per_char
    return max(1, -(-total // LANE_BITS))


def zeros(n: int, lanes: int) -> jax.Array:
    return jnp.zeros((lanes, n), LANE_DTYPE)


def full_pad(n: int, lanes: int) -> jax.Array:
    return jnp.full((lanes, n), PAD_LANE, LANE_DTYPE)


# ---------------------------------------------------------------------------
# bitwise ops
# ---------------------------------------------------------------------------

def bitwise_or(a: jax.Array, b: jax.Array) -> jax.Array:
    return a | b


def bitwise_and(a: jax.Array, b: jax.Array) -> jax.Array:
    return a & b


def shift_right(x: jax.Array, nbits: int) -> jax.Array:
    """Logical right shift of each big integer by a static bit count."""
    if nbits == 0:
        return x
    L = x.shape[0]
    whole, bits = divmod(nbits, LANE_BITS)
    parts = []
    for j in range(L):
        src = j - whole
        if src < 0:
            parts.append(jnp.zeros_like(x[0]))
            continue
        v = x[src] >> np.uint32(bits) if bits else x[src]
        if bits and src - 1 >= 0:
            v = v | (x[src - 1] << np.uint32(LANE_BITS - bits))
        parts.append(v)
    return jnp.stack(parts)


def shift_left(x: jax.Array, nbits: int) -> jax.Array:
    """Left shift of each big integer by a static bit count (drops overflow)."""
    if nbits == 0:
        return x
    L = x.shape[0]
    whole, bits = divmod(nbits, LANE_BITS)
    parts = []
    for j in range(L):
        src = j + whole
        if src >= L:
            parts.append(jnp.zeros_like(x[0]))
            continue
        v = x[src] << np.uint32(bits) if bits else x[src]
        if bits and src + 1 < L:
            v = v | (x[src + 1] >> np.uint32(LANE_BITS - bits))
        parts.append(v)
    return jnp.stack(parts)


def mask_low_bits(lanes: int, nbits: int) -> np.ndarray:
    """(L, 1) numpy mask keeping the low ``nbits`` of the big integer."""
    out = np.zeros((lanes, 1), np.uint32)
    for j in range(lanes):
        lo_bit = (lanes - 1 - j) * LANE_BITS  # bit offset of this lane's LSB
        hi_bit = lo_bit + LANE_BITS
        if nbits >= hi_bit:
            out[j] = 0xFFFFFFFF
        elif nbits > lo_bit:
            out[j] = (1 << (nbits - lo_bit)) - 1
    return out


# ---------------------------------------------------------------------------
# character fields
# ---------------------------------------------------------------------------

def get_field(x: jax.Array, slot: int, bits_per_char: int) -> jax.Array:
    """Extract character field ``slot`` (0 = least significant) as (N,) uint32."""
    L = x.shape[0]
    bit = slot * bits_per_char
    lane = L - 1 - bit // LANE_BITS
    off = bit % LANE_BITS
    return (x[lane] >> np.uint32(off)) & np.uint32((1 << bits_per_char) - 1)


def set_field(x: jax.Array, slot: int, vals: jax.Array, bits_per_char: int) -> jax.Array:
    """Return a copy with field ``slot`` overwritten by ``vals`` (N,) uint32."""
    L = x.shape[0]
    bit = slot * bits_per_char
    lane = L - 1 - bit // LANE_BITS
    off = bit % LANE_BITS
    mask = np.uint32(((1 << bits_per_char) - 1) << off)
    new_lane = (x[lane] & ~mask) | ((vals.astype(LANE_DTYPE) << np.uint32(off)) & mask)
    return x.at[lane].set(new_lane)


def from_fields(fields: jax.Array, bits_per_char: int, lanes: Optional[int] = None) -> jax.Array:
    """Pack ``(num_slots, N)`` uint32 fields (slot 0 least significant) into lanes."""
    num_slots, n = fields.shape
    L = lanes if lanes is not None else num_lanes(num_slots, bits_per_char)
    out = jnp.zeros((L, n), LANE_DTYPE)
    per_lane = LANE_BITS // bits_per_char
    for lane_from_lsb in range(L):
        lane = L - 1 - lane_from_lsb
        acc = jnp.zeros((n,), LANE_DTYPE)
        for i in range(per_lane):
            slot = lane_from_lsb * per_lane + i
            if slot >= num_slots:
                break
            acc = acc | (fields[slot].astype(LANE_DTYPE) << np.uint32(i * bits_per_char))
        out = out.at[lane].set(acc)
    return out


def to_fields(x: jax.Array, num_slots: int, bits_per_char: int) -> jax.Array:
    """Unpack lanes into ``(num_slots, N)`` uint32 fields."""
    return jnp.stack([get_field(x, s, bits_per_char) for s in range(num_slots)])


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def eq(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.all(a == b, axis=0)


def lt(a: jax.Array, b: jax.Array) -> jax.Array:
    """Lexicographic a < b over lanes, vectorized over N."""
    L = a.shape[0]
    res = a[L - 1] < b[L - 1]
    for j in range(L - 2, -1, -1):
        res = jnp.where(a[j] == b[j], res, a[j] < b[j])
    return res


def le(a: jax.Array, b: jax.Array) -> jax.Array:
    return ~lt(b, a)


def neighbor_ne(x: jax.Array) -> jax.Array:
    """mask[i] = (i == 0) or x[:, i] != x[:, i-1]. For unique detection on sorted input."""
    n = x.shape[1]
    if n == 0:
        return jnp.zeros((0,), bool)
    diff = jnp.any(x[:, 1:] != x[:, :-1], axis=0)
    return jnp.concatenate([jnp.ones((1,), bool), diff])


# ---------------------------------------------------------------------------
# sort / searchsorted
# ---------------------------------------------------------------------------

def sort(x: jax.Array, *extras: jax.Array, stable: bool = True
         ) -> Tuple[jax.Array, Tuple[jax.Array, ...]]:
    """Sort a batch of big integers ascending; co-sort ``extras`` (N,) arrays.

    Replaces ips4o parallel sort (reference: sorted_set.hpp:42) with XLA's
    native multi-operand lexicographic sort.
    """
    L = x.shape[0]
    operands = tuple(x[j] for j in range(L)) + tuple(extras)
    res = jax.lax.sort(operands, num_keys=L, is_stable=stable)
    return jnp.stack(res[:L]), tuple(res[L:])


def merge_sorted(a: jax.Array, b: jax.Array,
                 a_extras: Sequence[jax.Array] = (),
                 b_extras: Sequence[jax.Array] = (),
                 ) -> Tuple[jax.Array, Tuple[jax.Array, ...]]:
    """Merge two sorted (+PAD-tail) lane arrays with their payloads.

    Returns (lanes (L, Na+Nb), extras): sorted ascending, PADs at the
    tail, equal keys adjacent. Payload i of A pairs with payload i of B.
    Written as concatenate + one sort, which XLA lowers itself; the
    reference does this as a linear iterator merge
    (boss_chunk_construct.cpp:233-306).
    """
    assert len(a_extras) == len(b_extras)
    lanes = jnp.concatenate([a, b], axis=1)
    extras = tuple(jnp.concatenate([ea, eb])
                   for ea, eb in zip(a_extras, b_extras))
    return sort(lanes, *extras)


def searchsorted(keys: jax.Array, queries: jax.Array, side: str = "left",
                 lo0=None, hi0=None, steps: Optional[int] = None) -> jax.Array:
    """Vectorized binary search of ``queries`` (L, Q) in sorted ``keys`` (L, N).

    Returns (Q,) int32 insertion positions. Replaces the per-k-mer
    ``std::lower_bound``/BOSS ``index_range`` searches with batched
    gather+compare rounds (log2(N) iterations, each a dense vector op).
    """
    n = keys.shape[1]
    q = queries.shape[1]
    if n == 0:
        return jnp.zeros((q,), jnp.int32)
    if steps is None:
        steps = max(1, int(np.ceil(np.log2(n + 1))))
    lo = jnp.zeros((q,), jnp.int32) if lo0 is None else lo0.astype(jnp.int32)
    hi = jnp.full((q,), n, jnp.int32) if hi0 is None else hi0.astype(jnp.int32)

    def step(state):
        lo, hi = state
        active = lo < hi
        mid = (lo + hi) >> 1
        km = keys[:, jnp.minimum(mid, n - 1)]  # (L, Q) gather
        if side == "left":
            go_right = lt(km, queries)
        else:
            go_right = le(km, queries)
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
        return lo, hi

    if steps == 0:
        # run-until-converged: for callers that narrow [lo0, hi0) with a
        # LUT whose worst-case bucket size is data-dependent
        lo, hi = jax.lax.while_loop(
            lambda s: jnp.any(s[0] < s[1]), step, (lo, hi))
    else:
        lo, hi = jax.lax.fori_loop(0, steps, lambda _, s: step(s), (lo, hi))
    return lo


def expand2to4(lanes2: jax.Array, K: int) -> jax.Array:
    """(L2, n) 2-bit-packed k-mers (chars stored as c-1) -> (L4, n)
    4-bit-packed (chars c), same field order. The per-field map c-1 -> c
    is monotone, so 2-bit big-int order == 4-bit big-int order — sorts
    and uniques run on the narrow form and expand once afterwards.
    Bit-twiddling spread: three shift/mask rounds per output lane."""
    n = lanes2.shape[1]
    L2 = lanes2.shape[0]
    L4 = (K * 4 + 31) // 32
    outs = []
    for i4 in range(L4):                  # least-significant lane first
        i2 = i4 // 2
        src = lanes2[L2 - 1 - i2]
        half = (src >> jnp.uint32(16 * (i4 % 2))) & jnp.uint32(0xFFFF)
        u = (half | (half << 8)) & jnp.uint32(0x00FF00FF)
        u = (u | (u << 4)) & jnp.uint32(0x0F0F0F0F)
        u = (u | (u << 2)) & jnp.uint32(0x33333333)
        m = min(8, K - 8 * i4)            # valid fields in this lane
        u = u + jnp.uint32(0x11111111 & ((1 << (4 * m)) - 1))
        outs.append(u)
    return jnp.stack(outs[::-1])


def isin_sorted(keys: jax.Array, queries: jax.Array) -> jax.Array:
    """(Q,) bool: query present in sorted keys. Batched set-membership."""
    n = keys.shape[1]
    if n == 0:
        return jnp.zeros((queries.shape[1],), bool)
    pos = jnp.minimum(searchsorted(keys, queries, side="left"), n - 1)
    return eq(keys[:, pos], queries)


def isin_merge(keys: jax.Array, queries: jax.Array) -> jax.Array:
    """(Q,) bool set-membership via one sort instead of binary search.

    Bulk membership tests in the construction pipeline (q ~ n) use this
    merge formulation in place of log2(n) gather rounds of a binary
    search (a choice made on a TPU, not yet measured on the H100): tag
    keys/queries, co-sort, mark
    equal-value runs containing a key with one segment-max + one gather,
    scatter results back through the co-sorted query index.
    ``keys`` need not be pre-sorted here.
    """
    L, n = keys.shape
    q = queries.shape[1]
    both = jnp.concatenate([keys, queries], axis=1)
    is_query = jnp.concatenate([jnp.zeros((n,), jnp.int32),
                                jnp.ones((q,), jnp.int32)])
    # a bare iota: keys then queries in input order. (zeros ++ iota is a
    # pad of a constant, which XLA folds into an (n+q)-element literal
    # at compile time.)
    orig = jnp.arange(n + q, dtype=jnp.int32)
    s, (is_q_s, orig_s) = sort(both, is_query, orig)
    run_first = neighbor_ne(s)
    # within an equal-value run keys sort before queries (stable sort,
    # keys concatenated first), so "run contains a key" reduces to pure
    # scans: #keys inside my run so far = inclusive key count minus the
    # key count just before my run's first element (forward-filled with a
    # running max — it is nondecreasing across runs). No scatters/gathers.
    is_key = (1 - is_q_s).astype(jnp.int32)
    keys_incl = jnp.cumsum(is_key)
    excl_at_first = jnp.where(run_first, keys_incl - is_key, 0)
    run_excl = jax.lax.cummax(excl_at_first)
    present_s = (keys_incl - run_excl) > 0
    # route answers back to query order with a sort (keys first, then
    # queries by original index) instead of a scatter
    back = jax.lax.sort(
        ((1 - is_q_s).astype(jnp.uint8), orig_s,
         present_s.astype(jnp.uint8)),
        num_keys=2, is_stable=True)
    return back[2][:q].astype(bool)


# ---------------------------------------------------------------------------
# blocked scans (XLA's 1D cumsum/cummax lower to a sequential scan at
# large N; two-level block scans keep them parallel over rows)
# ---------------------------------------------------------------------------

def blocked_cumsum(x: jax.Array, block: int = 8192) -> jax.Array:
    """Inclusive 1D cumsum via per-row scans + a tiny cross-row scan."""
    n = x.shape[0]
    if n <= block:
        return jnp.cumsum(x)
    G = -(-n // block)
    npad = G * block
    xp = x if npad == n else jnp.concatenate(
        [x, jnp.zeros((npad - n,), x.dtype)])
    x2 = xp.reshape(G, block)
    within = jnp.cumsum(x2, axis=1)
    tot = within[:, -1]
    offs = jnp.cumsum(tot) - tot
    return (within + offs[:, None]).reshape(-1)[:n]


def blocked_cummax(x: jax.Array, block: int = 8192) -> jax.Array:
    """Inclusive 1D cummax, same two-level structure as blocked_cumsum."""
    n = x.shape[0]
    if n <= block:
        return jax.lax.cummax(x)
    G = -(-n // block)
    npad = G * block
    lowest = jnp.asarray(jnp.iinfo(x.dtype).min, x.dtype)
    xp = x if npad == n else jnp.concatenate(
        [x, jnp.full((npad - n,), lowest, x.dtype)])
    x2 = xp.reshape(G, block)
    within = jax.lax.cummax(x2, axis=1)
    tot = within[:, -1]
    run = jax.lax.cummax(tot)
    offs = jnp.concatenate([lowest[None], run[:-1]])
    return jnp.maximum(within, offs[:, None]).reshape(-1)[:n]


# ---------------------------------------------------------------------------
# compaction (fixed-capacity streams)
# ---------------------------------------------------------------------------

def compact(x: jax.Array, keep: jax.Array, capacity: int,
            *extras: jax.Array, extra_fill: int = 0
            ) -> Tuple[jax.Array, jax.Array, Tuple[jax.Array, ...]]:
    """Move entries where ``keep`` to the front (original order preserved),
    PAD-fill the rest, and clip to ``capacity``.

    Returns (lanes (L, capacity), count, extras...). Entries beyond capacity
    are dropped (callers must size capacity; the TRUE count is returned so
    they can detect overflow). Implemented as a stable one-key sort on
    ``not keep`` rather than a prefix sum + scatter (a choice made on a
    TPU, not yet measured on the H100); this runs in every pipeline stage.
    """
    L, n = x.shape
    count = jnp.sum(keep.astype(jnp.int32))
    keynot = (~keep).astype(jnp.uint8)
    ops = (keynot,) + tuple(x[j] for j in range(L)) + tuple(extras)
    res = jax.lax.sort(ops, num_keys=1, is_stable=True)
    m = min(capacity, n)
    pos_ok = valid_mask(m, count)
    out_lanes = jnp.stack([
        jnp.where(pos_ok, res[1 + j][:m], PAD_LANE) for j in range(L)])
    if capacity > n:
        out_lanes = pad_to(out_lanes, capacity)
    outs = []
    for i, e in enumerate(extras):
        eo = jnp.where(pos_ok, res[1 + L + i][:m],
                       jnp.asarray(extra_fill, e.dtype))
        if capacity > n:
            eo = jnp.concatenate(
                [eo, jnp.full((capacity - n,), extra_fill, e.dtype)])
        outs.append(eo)
    return out_lanes, count, tuple(outs)


def pad_to(x: jax.Array, capacity: int) -> jax.Array:
    """Pad (L, n) lanes with PAD up to (L, capacity)."""
    L, n = x.shape
    if n == capacity:
        return x
    assert n < capacity
    return jnp.concatenate([x, full_pad(capacity - n, L)], axis=1)


def valid_mask(n_total: int, count: jax.Array) -> jax.Array:
    """(n_total,) bool mask of the first ``count`` positions."""
    return jnp.arange(n_total, dtype=jnp.int32) < count
