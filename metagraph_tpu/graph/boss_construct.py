"""BOSS construction as a host-orchestrated pipeline of device kernels.

Device re-design of the reference construction engine
(metagraph/src/graph/representation/succinct/boss_chunk_construct.cpp:55-356
and boss_chunk.cpp:33-130). The reference's sequential iterator algorithms
become set algebra over sorted packed k-mer tensors:

  stage                reference                      here
  -------------------  -----------------------------  -------------------------
  collect k-mers       KmerCollector + SortedSet      extractor + lax.sort +
                       (ips4o sort, dedupe)           neighbor-compare dedupe
  reverse complements  add_reverse_complements        vectorized rc + concat
  dummy sink k-mers    add_dummy_sink_kmers           to_next + batched set-
                       (per-char iterators)           membership (searchsorted)
  dummy source k-mers  add_dummy_source_kmers         to_prev + membership on
                                                      target-node keys
  dummy levels 2..k    per-level loop + ips4o         same loop, sort per level
  merge + emit W/last  initialize_chunk scan          neighbor-compare masks +
                       (minus flags via memo array)   second sort for first-
                                                      occurrence minus flags

Sizes are data-dependent, so the driver runs jitted stages at power-of-two
capacities (PAD-filled) and fetches only scalar counts between stages;
all O(N) work happens on device.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..common import packed
from ..kmer import packing
from ..kmer.alphabets import Alphabet, DNA, INVALID_CODE
from ..kmer.extractor import encode_sequences, extract_packed_kmers
from .boss import Boss

MODE_BASIC = "basic"
MODE_CANONICAL = "canonical"
MODE_PRIMARY = "primary"


def _bucket(n: int, lo: int = 1024) -> int:
    """Round capacity up to a bounded set of size classes.

    Small sizes use powers of two (few classes, cheap compiles). Above
    2^18, quarter-octave steps (1, 1.25, 1.5, 1.75 per octave): sort
    time scales ~n log^2 n, so the power-of-two pad waste (avg 33%,
    worst 50%) costs real wall time at the sizes where it matters, and
    the extra size classes compile once into the persistent cache."""
    n = max(int(n), 1)
    p2 = max(lo, 1 << (n - 1).bit_length())
    if p2 <= (1 << 18):
        return p2
    base = p2 >> 1          # base <= n - 1 < p2 (n > lo here)
    step = base >> 2
    return base + -(-(n - base) // step) * step


# ---------------------------------------------------------------------------
# jitted stages
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("K", "B", "suffix", "canonical", "complement"))
def _extract_stage(codes, K: int, B: int, suffix, canonical: bool, complement):
    lanes, count = extract_packed_kmers(codes, K, B, suffix=suffix or None)
    if canonical:
        rc = packing.reverse_complement(lanes, K, B, complement)
        take_rc = packed.lt(rc, lanes)
        # PAD entries: rc(PAD) may compare below PAD; keep PAD rows intact
        valid = packed.valid_mask(lanes.shape[1], count)
        take_rc = take_rc & valid
        lanes = jnp.where(take_rc[None, :], rc, lanes)
    return lanes, count


@functools.partial(jax.jit, static_argnames=("K", "B", "suffix", "canonical", "complement"))
def _collect_stage(codes, K: int, B: int, suffix, canonical: bool, complement):
    """Extract + canonical fold + sort-unique, fused into one dispatch."""
    lanes, count = extract_packed_kmers(codes, K, B, suffix=suffix or None)
    if canonical:
        rc = packing.reverse_complement(lanes, K, B, complement)
        valid = packed.valid_mask(lanes.shape[1], count)
        take_rc = packed.lt(rc, lanes) & valid
        lanes = jnp.where(take_rc[None, :], rc, lanes)
    return _sort_unique_ones_body(lanes, count)


def _rc_node(nk, K: int, B: int, complement):
    """Reverse-complement of a node key. Node keys hold S_1..S_{K-1} in
    PLAIN field order (S_{j+1} at field j) — unlike edge k-mers, whose
    field 0 is the label — so this is a direct fieldwise reverse +
    complement, not packing.reverse_complement."""
    comp = jnp.asarray(np.array(complement, np.uint32))
    fields = packed.to_fields(nk, K - 1, B)        # field j = S_{j+1}
    rc = jnp.stack([comp[fields[K - 2 - j]] for j in range(K - 1)])
    return packed.from_fields(rc, B, lanes=nk.shape[0])


def _bounds_body(lanes_all, ok, K: int, B: int, cap_b: int):
    """Boundary dummy-edge candidates from the raw (pre-compaction)
    window array. A node can lack an outgoing (incoming) edge only if
    every one of its occurrences sits at the end (start) of a maximal
    valid window run — so the candidate sets are the per-run terminal
    windows, O(#reads) of them, not O(#k-mers)
    (replaces the full-size sorts of add_dummy_sink/source_kmers,
    boss_chunk_construct.cpp:55-166, with O(#reads) probe sets).
    Canonical closure adds the rc forms of the opposite boundary.
    Returns (sink_cand, n_end, src_cand, n_start); candidates may
    contain duplicates/false positives — the finish probes each against
    the sorted edge set."""
    nw = ok.shape[0]
    L = lanes_all.shape[0]
    ok_next = jnp.concatenate([ok[1:], jnp.zeros((1,), bool)])
    ok_prev = jnp.concatenate([jnp.zeros((1,), bool), ok[:-1]])
    end_mask = ok & ~ok_next
    start_mask = ok & ~ok_prev
    pos = jnp.arange(nw, dtype=jnp.uint32)[None, :]
    pe, n_end, _ = packed.compact(pos, end_mask, cap_b)
    ps, n_start, _ = packed.compact(pos, start_mask, cap_b)

    def gather_nodes(p, n, project):
        pc = jnp.minimum(p[0], nw - 1).astype(jnp.int32)
        win = lanes_all[:, pc]
        nodes = project(win)
        v = packed.valid_mask(cap_b, jnp.minimum(n, cap_b))
        return jnp.where(v[None, :], nodes, packed.full_pad(cap_b, L))

    tgt = gather_nodes(pe, n_end,
                       lambda w: packing.node_key(
                           packing.to_next(w, K, B, 0), B))
    src = gather_nodes(ps, n_start, lambda w: packing.node_key(w, B))
    # the canonical rc closure of the candidates happens in the finish
    # stage at the TIGHT capacity (the driver slices these buffers down
    # to bucket(true count) first — at cap_b they would blow up the
    # levels buffer)
    return tgt, n_end, src, n_start


@functools.partial(jax.jit, static_argnames=(
    "K", "B", "cap_b", "canonical", "complement"))
def _collect_stage_bounds(codes, K: int, B: int, cap_b: int,
                          canonical: bool, complement):
    """_collect_stage + boundary dummy candidates in the same dispatch."""
    from ..kmer.extractor import window_validity
    n = codes.shape[0]
    nw = n - K + 1
    ok = window_validity(codes, K)
    lanes_all = packing.pack_windows(codes, K, B)
    sink_cand, n_end, src_cand, n_start = _bounds_body(
        lanes_all, ok, K, B, cap_b)
    # no pre-sort compaction: invalid windows become PAD and the big
    # sort moves them to the tail anyway (saves a full partition pass)
    L = lanes_all.shape[0]
    lanes = jnp.where(ok[None, :], lanes_all, packed.full_pad(nw, L))
    count = jnp.sum(ok.astype(jnp.int32))
    if canonical:
        rc = packing.reverse_complement(lanes, K, B, complement)
        take_rc = packed.lt(rc, lanes) & ok
        lanes = jnp.where(take_rc[None, :], rc, lanes)
    ulanes, ucounts, ucount = _sort_unique_ones_body(lanes, count)
    cnts = jnp.stack([ucount.astype(jnp.int32),
                      n_end.astype(jnp.int32), n_start.astype(jnp.int32)])
    return ulanes, ucounts, cnts, (sink_cand, src_cand)


@functools.partial(jax.jit, static_argnames=(
    "n", "K", "B", "cap_b", "canonical", "complement"))
def _collect_stage_bounds_packed(words, n: int, K: int, B: int, cap_b: int,
                                 canonical: bool, complement):
    return _collect_stage_bounds.__wrapped__(
        _unpack_codes(words, n), K, B, cap_b, canonical, complement)


def pack_codes_host(codes_np: np.ndarray) -> np.ndarray:
    """Host-side 4-bit packing of a char-code array (8 codes per uint32)
    for the h2d transfer: the input bytes are on the critical path of
    every large build, so they cross the link packed. INVALID
    (255) maps to nibble 15; only <=4-bit alphabets qualify.

    Block layout: nibble i of word j holds code[i*(n/8) + j] — both the
    host pack and the device unpack are then pure contiguous-slice
    shift/ORs with no strided access or transpose."""
    n = codes_np.shape[0]
    npad = -(-n // 8) * 8
    nib = codes_np
    if npad != n:
        nib = np.concatenate(
            [nib, np.full(npad - n, INVALID_CODE, np.uint8)])
    v = np.where(nib == INVALID_CODE, 15, nib).reshape(8, npad // 8)
    words = v[0].astype(np.uint32)
    for i in range(1, 8):
        words |= v[i].astype(np.uint32) << np.uint32(4 * i)
    return words


def _unpack_codes(words: jax.Array, n: int) -> jax.Array:
    """Device-side inverse of pack_codes_host -> (n,) uint8 codes."""
    rows = [((words >> jnp.uint32(4 * i)) & jnp.uint32(0xF)
             ).astype(jnp.uint8) for i in range(8)]
    c = jnp.concatenate(rows)[:n]
    return jnp.where(c == 15, jnp.uint8(INVALID_CODE), c)


def pack_codes2_host(codes_np: np.ndarray, max_inval: Optional[int] = None,
                     n_valid: Optional[int] = None):
    """2-bit host pack for 4-letter alphabets: codes 1..4 become 2-bit
    fields (half the h2d bytes of the nibble pack); positions outside
    1..4 (record separators, stray chars) ride a sparse int32 index
    sidecar that the device scatters back to INVALID. ``n_valid`` marks
    a contiguous INVALID padding tail (positions >= n_valid) that the
    device masks with one iota compare instead — it is excluded from
    the sidecar and from the ``max_inval`` budget. Returns (words, inval_idx,
    inval_sorted) or None when true invalids exceed ``max_inval``
    (dense-invalid inputs pack worse this way — callers fall back to
    the nibble pack)."""
    from ..native.loader import pack2_codes_native
    n = codes_np.shape[0]
    if n_valid is None:
        n_valid = n
    npad = -(-n // 16) * 16
    if max_inval is None:
        max_inval = max(4096, n >> 4)
    tail = (npad - n) + (n - n_valid)
    if npad != n:
        codes_np = np.concatenate(
            [codes_np, np.full(npad - n, INVALID_CODE, np.uint8)])
    res = pack2_codes_native(codes_np, max_inval + tail)
    if res is not None:
        words, inval = res
    else:
        bad = (codes_np - 1) > 3           # uint8 wraps: 0 and >4 are bad
        inval = np.nonzero(bad)[0]
        if inval.shape[0] > max_inval + tail:
            return None
        v = np.where(bad, 1, codes_np).reshape(16, npad // 16)
        words = (v[0].astype(np.uint32) - 1) & 3
        for i in range(1, 16):
            words |= ((v[i].astype(np.uint32) - 1) & 3) << np.uint32(2 * i)
    # Block-layout index i*nwords+j IS the original position, and the
    # pack loops emit them in ascending order, so ``inval`` is sorted.
    # Drop the padding-tail entries (device masks those positionally),
    # then pad to a bucket with an out-of-range index (dropped by the
    # device scatter) for stable compile shapes; the raw sorted list
    # rides along for host-side boundary derivation.
    inval = inval[:np.searchsorted(inval, n_valid)]
    if inval.shape[0] > max_inval:
        return None
    capi = _bucket(max(int(inval.shape[0]), 1), lo=1024)
    idx = np.full(capi, 1 << 30, np.int32)
    idx[:inval.shape[0]] = inval.astype(np.int32)
    return words, idx, inval


def _unpack_codes2(words: jax.Array, inval_idx: jax.Array, n: int,
                   n_valid=None) -> jax.Array:
    """Device-side inverse of pack_codes2_host -> (n,) uint8 codes.
    ``n_valid`` (device scalar): positions >= n_valid become INVALID
    via one iota compare (the contiguous padding tail)."""
    rows = [((words >> jnp.uint32(2 * i)) & jnp.uint32(3)
             ).astype(jnp.uint8) for i in range(16)]
    c = jnp.concatenate(rows) + jnp.uint8(1)
    c = c.at[inval_idx].set(jnp.uint8(INVALID_CODE), mode="drop")
    c = c[:n]
    if n_valid is not None:
        c = jnp.where(jnp.arange(n) < n_valid, c, jnp.uint8(INVALID_CODE))
    return c


@functools.partial(jax.jit, static_argnames=(
    "n", "K", "B", "suffix", "canonical", "complement"))
def _collect_stage_packed(words, n: int, K: int, B: int, suffix,
                          canonical: bool, complement):
    return _collect_stage.__wrapped__(
        _unpack_codes(words, n), K, B, suffix, canonical, complement)


@functools.partial(jax.jit, static_argnames=(
    "n", "K", "B", "cap_b", "canonical", "complement"))
def _collect_stage_bounds_packed2(words, inval_idx, n_valid, n: int, K: int,
                                  B: int, cap_b: int, canonical: bool,
                                  complement):
    return _collect_stage_bounds.__wrapped__(
        _unpack_codes2(words, inval_idx, n, n_valid), K, B, cap_b,
        canonical, complement)


def host_boundary_windows(inval_sorted: np.ndarray, n: int, K: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Window positions of the per-run boundaries, computed on the HOST
    from the sorted invalid-code positions (the pack2 sidecar): a
    maximal valid run [a, b) of length >= K contributes its first
    window (source candidate) and its last (sink candidate). Exact —
    replaces the device-side O(nw) mask + two full-width compaction
    passes of _bounds_body with O(#runs) host arithmetic + a device gather."""
    iv = np.concatenate([[-1], inval_sorted.astype(np.int64), [n]])
    a = iv[:-1] + 1                    # run start (code index)
    b = iv[1:]                         # run end (exclusive)
    ok = (b - a) >= K
    return (b[ok] - K).astype(np.int64), a[ok].astype(np.int64)


@functools.partial(jax.jit, static_argnames=(
    "n", "K", "B", "canonical", "complement"))
def _collect_stage_bounds_pos(words, inval_idx, n_valid, end_pos, n_end,
                              start_pos, n_start, n: int, K: int, B: int,
                              canonical: bool, complement):
    """_collect_stage + boundary candidates GATHERED at host-computed
    window positions (see host_boundary_windows) in one dispatch.

    The big sort runs in the 2-BIT domain: real k-mers never contain
    the sentinel, the per-field map c -> c-1 is monotone (identical
    big-int order), and `lax.sort` cost scales with the operand count —
    2 key lanes instead of 3 for k=20. The sorted-unique survivors
    expand back to the 4-bit domain in one bit-twiddling pass
    (packed.expand2to4)."""
    from ..kmer.extractor import window_validity
    assert B == 4
    codes = _unpack_codes2(words, inval_idx, n, n_valid)
    nw = n - K + 1
    ok = window_validity(codes, K)
    # 2-bit window lanes (chars stored as c-1; invalid windows masked)
    codes2 = (codes - jnp.uint8(1)) & jnp.uint8(3)
    lanes2 = packing.pack_windows(codes2, K, 2)
    if (2 * K) % 32 == 0:
        # full top lane: an all-T k-mer would equal the PAD pattern —
        # one zero top lane keeps PAD strictly above every real key
        lanes2 = jnp.concatenate(
            [jnp.zeros((1, nw), jnp.uint32), lanes2])
    L2 = lanes2.shape[0]
    capq = end_pos.shape[0]

    def gather_nodes(pos, cnt, project):
        win2 = lanes2[:, pos]                       # (L2, capq) tiny
        win = packed.expand2to4(win2[L2 - packed.num_lanes(K, 2):], K)
        nodes = project(win)
        v = packed.valid_mask(capq, cnt)
        return jnp.where(v[None, :], nodes,
                         packed.full_pad(capq, nodes.shape[0]))

    sink_cand = gather_nodes(
        end_pos, n_end,
        lambda w: packing.node_key(packing.to_next(w, K, B, 0), B))
    src_cand = gather_nodes(start_pos, n_start,
                            lambda w: packing.node_key(w, B))
    lanes = jnp.where(ok[None, :], lanes2, packed.full_pad(nw, L2))
    count = jnp.sum(ok.astype(jnp.int32))
    if canonical:
        comp2 = tuple(complement[c + 1] - 1 for c in range(4))
        rc = packing.reverse_complement(lanes, K, 2, comp2)
        take_rc = packed.lt(rc, lanes) & ok
        lanes = jnp.where(take_rc[None, :], rc, lanes)
    ulanes2, ucounts, ucount = _sort_unique_ones_body(lanes, count)
    ulanes = packed.expand2to4(ulanes2[L2 - packed.num_lanes(K, 2):], K)
    # expansion garbles the PAD tail (0xFF.. 2-bit pads are valid-looking
    # 4-bit chars) — restore it positionally
    ulanes = jnp.where(packed.valid_mask(nw, ucount)[None, :], ulanes,
                       packed.full_pad(nw, ulanes.shape[0]))
    return ulanes, ucounts, ucount, (sink_cand, src_cand)


@functools.partial(jax.jit, static_argnames=(
    "n", "K", "B", "suffix", "canonical", "complement"))
def _collect_stage_packed2(words, inval_idx, n_valid, n: int, K: int,
                           B: int, suffix, canonical: bool, complement):
    return _collect_stage.__wrapped__(
        _unpack_codes2(words, inval_idx, n, n_valid), K, B, suffix,
        canonical, complement)


def _sort_unique_ones_body(lanes, count):
    """Sort-unique when every input k-mer has count 1 (the from-sequence
    path): the counts payload is dropped from the big sort — with unit
    counts the exclusive running sum is just the position index, so
    per-group counts come from compacted first-occurrence positions."""
    cap = lanes.shape[1]
    lanes_s, _ = packed.sort(lanes)
    first = packed.neighbor_ne(lanes_s)
    valid_s = packed.valid_mask(cap, count)      # PADs sorted to the back
    umask = first & valid_s
    excl = jnp.arange(cap, dtype=jnp.int32)
    ulanes, ucount, (b,) = packed.compact(lanes_s, umask, cap, excl)
    total = count.astype(jnp.int32) if hasattr(count, "astype") \
        else jnp.int32(count)
    nxt = jnp.concatenate([b[1:], total[None]])
    pos_ok = packed.valid_mask(cap, ucount)
    nxt = jnp.where(jnp.concatenate([pos_ok[1:], jnp.zeros((1,), bool)]),
                    nxt, total)
    ucounts = jnp.where(pos_ok, nxt - b, 0)
    return ulanes, ucounts.astype(jnp.int32), ucount


@jax.jit
def _sort_unique_stage(lanes, counts, count):
    """Sort, dedupe, and aggregate counts (saturating add done at emit).

    Count aggregation is scatter-free: per-group sums are differences of
    the exclusive running sum taken at consecutive group-first positions
    (which compaction makes adjacent)."""
    cap = lanes.shape[1]
    valid = packed.valid_mask(cap, count)
    counts = jnp.where(valid, counts, 0)
    lanes_s, (counts_s,) = packed.sort(lanes, counts)
    valid_s = packed.valid_mask(cap, count)  # PADs sorted to the back
    first = packed.neighbor_ne(lanes_s)
    umask = first & valid_s
    # int32 running sums: a single shard holds < 2^31 k-mer occurrences
    # (larger inputs stream through chunked/sharded collection)
    excl = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            packed.blocked_cumsum(counts_s)[:-1]])
    total = jnp.sum(counts_s)
    ulanes, ucount, (b,) = packed.compact(lanes_s, umask, cap, excl)
    nxt = jnp.concatenate([b[1:], total[None]])
    pos_ok = packed.valid_mask(cap, ucount)
    nxt = jnp.where(jnp.concatenate([pos_ok[1:], jnp.zeros((1,), bool)]),
                    nxt, total)
    ucounts = jnp.where(pos_ok, nxt - b, 0)
    return ulanes, ucounts.astype(jnp.int32), ucount


@functools.partial(jax.jit, static_argnames=("K", "B", "complement"))
def _add_rc_stage(lanes, counts, count, K: int, B: int, complement):
    """Append reverse complements of all (unique, canonical-form) k-mers;
    palindromic k-mers double their count with saturation handled at emit
    (reference: boss_chunk_construct.cpp:181-214)."""
    cap = lanes.shape[1]
    valid = packed.valid_mask(cap, count)
    rc = packing.reverse_complement(lanes, K, B, complement)
    pal = packed.eq(rc, lanes) & valid
    counts = jnp.where(pal, counts * 2, counts)  # int32; emit saturates
    add_mask = valid & ~pal
    n_add = jnp.sum(add_mask.astype(jnp.int32))
    rc_comp, _, (rc_counts,) = packed.compact(
        rc, add_mask, cap, counts)
    # sort only the rc half, then one linear merge with the (already
    # sorted) canonical half — instead of re-sorting the 2x concat
    rc_s, (rc_counts_s,) = packed.sort(rc_comp, rc_counts)
    lanes_m = jnp.where(valid[None, :], lanes,
                        packed.full_pad(cap, lanes.shape[0]))
    out_s, (counts_s,) = packed.merge_sorted(
        lanes_m, rc_s, (jnp.where(valid, counts, 0),), (rc_counts_s,))
    return out_s, counts_s, count + n_add


# Valid node/target keys have zero top bits (alphabets use <= B bits per
# char and the tag shift adds one more); after the tag-bit left shift a
# PAD surfaces as 0x7FFF... in the top lane — above every valid key.
_PAD_TOP_AFTER_SHIFT = np.uint32(0x7FFFFFFF)


def _tag_lanes(keys, tag: int):
    """Shift a packed key left one bit and put ``tag`` in the new LSB:
    within an equal-key run of the (unstable) merge, tag-0 entries sort
    strictly before tag-1 entries — a stability substitute."""
    out = packed.shift_left(keys, 1)
    return out.at[-1].set(out[-1] | np.uint32(tag))


def _merge_membership(keys, queries):
    """Batch set-membership of sorted ``queries`` against sorted ``keys``
    via ONE merge of the two sorted sets (``packed.merge_sorted``)
    instead of the round-trip sorts of the old isin formulation.

    Both inputs are (L, n) sorted packed lanes with PAD tails. Returns,
    in MERGED order: (vals, is_q, present, is_pad, run_first) where
    ``present`` marks entries whose equal-value run contains a key.
    Callers then select/compact in merged order — which is sorted — so
    no route-back sort is ever needed (the reference's analog is the
    sequential two-iterator walk of add_dummy_sink_kmers,
    boss_chunk_construct.cpp:55-98)."""
    kt = _tag_lanes(keys, 0)
    qt = _tag_lanes(queries, 1)
    merged, _ = packed.merge_sorted(kt, qt)
    tagbit = merged[-1] & np.uint32(1)
    vals = packed.shift_right(merged, 1)
    is_pad = vals[0] >= _PAD_TOP_AFTER_SHIFT
    is_q = (tagbit == 1) & ~is_pad
    is_key = jnp.where((tagbit == 0) & ~is_pad, 1, 0).astype(jnp.int32)
    keys_incl = packed.blocked_cumsum(is_key)
    run_first = packed.neighbor_ne(vals)
    # keys sort before queries within a run (tag bit), so "my run has a
    # key" = key count grew since the run started; the run-start count is
    # forward-filled with a running max (it is nondecreasing across runs)
    excl_at_first = jnp.where(run_first, keys_incl - is_key, 0)
    run_excl = packed.blocked_cummax(excl_at_first)
    present = (keys_incl - run_excl) > 0
    return vals, is_q, present, is_pad, run_first


def _sink_candidates(real, n_real, K: int, B: int, cap_out: int):
    """Dummy sink edges (node = e_2..e_K, label $): target nodes of real
    edges with no real outgoing edge, sorted + deduped
    (reference: add_dummy_sink_kmers, boss_chunk_construct.cpp:55-98).
    Returns (sinks (L, cap_out) sorted, TRUE count pre-truncation)."""
    cap = real.shape[1]
    L = real.shape[0]
    valid = packed.valid_mask(cap, n_real)
    real_nodes = packing.node_key(real, B)       # order-preserving: sorted
    keys = jnp.where(valid[None, :], real_nodes, packed.full_pad(cap, L))
    shifted = packing.to_next(real, K, B, 0)
    q_nodes = jnp.where(valid[None, :], packing.node_key(shifted, B),
                        packed.full_pad(cap, L))
    q_s, _ = packed.sort(q_nodes)
    vals, is_q, present, is_pad, run_first = _merge_membership(keys, q_s)
    # keep each no-key run's first query once (dedupe falls out of the
    # merged order: duplicates are adjacent)
    keep = is_q & ~present & ~is_pad & run_first
    nodes_out, n_out, _ = packed.compact(vals, keep, cap_out)
    m = jnp.minimum(n_out, cap_out)
    sinks = jnp.where(packed.valid_mask(cap_out, m)[None, :],
                      packed.shift_left(nodes_out, B),
                      packed.full_pad(cap_out, L))
    return sinks, n_out


def _source_candidates(real, n_real, K: int, B: int, cap_out: int):
    """Dummy-1 source edges ($ e_1..e_{K-2}, label e_{K-1}) for source
    nodes with no real incoming edge
    (reference: add_dummy_source_kmers, boss_chunk_construct.cpp:100-166).

    The query key is target_key(to_prev(e)) = (e_1..e_{K-2}, e_{K-1}) —
    which both identifies the candidate uniquely AND sorts in exactly
    the BOSS order of the reconstructed dummy edge, so the compacted
    merged output is already sorted. Returns (src sorted, TRUE count)."""
    cap = real.shape[1]
    L = real.shape[0]
    valid = packed.valid_mask(cap, n_real)
    real_nodes = packing.node_key(real, B)
    node_first = packed.neighbor_ne(real_nodes) & valid
    prev = packing.to_prev(real, K, B, 0)
    q_t = packing.target_key(prev, B)
    qm = jnp.where(node_first[None, :], q_t, packed.full_pad(cap, L))
    q_s, _ = packed.sort(qm)
    tkeys = jnp.where(valid[None, :], packing.target_key(real, B),
                      packed.full_pad(cap, L))
    tk_s, _ = packed.sort(tkeys)
    vals, is_q, present, is_pad, _ = _merge_membership(tk_s, q_s)
    keep = is_q & ~present & ~is_pad
    tk_out, n_src, _ = packed.compact(vals, keep, cap_out)
    # reconstruct the edge from its target key: fields (e_1..e_{K-2})
    # move up one slot (past the $ sentinel), e_{K-1} stays the label
    lab = packing.label(tk_out, B)
    body = packed.set_field(tk_out, 0, jnp.zeros((cap_out,), jnp.uint32), B)
    src = packed.set_field(packed.shift_left(body, B), 0, lab, B)
    m = jnp.minimum(n_src, cap_out)
    src = jnp.where(packed.valid_mask(cap_out, m)[None, :], src,
                    packed.full_pad(cap_out, L))
    return src, n_src


_PAD_TOP = np.uint32(0x80000000)


def _probe_dummies(real_m, sink_cand, src_cand, K: int, B: int,
                   sigma: int):
    """Dummy sink + dummy-1 source edges from boundary candidates, with
    ALL probes fused into ONE batched binary search (each searchsorted
    round is latency-bound, so separate probes pay that latency per
    round).

    Sinks: outgoing edges of node T are the contiguous range
    [(T,0), (T,0xF)] of the BOSS order — absent iff both bounds land on
    the same position (no real label exceeds 0xF-1, so side='left' works
    for the upper bound too).
    Sources: incoming edges of node S are the <= sigma-1 exact k-mers
    (c, S_1..S_{K-1}) — absent iff no probe hits exactly."""
    capk = sink_cand.shape[1]
    capr = src_cand.shape[1]
    ks, _ = packed.sort(sink_cand)
    first_k = packed.neighbor_ne(ks)
    pad_k = ks[0] >= _PAD_TOP
    lo_keys = packed.shift_left(ks, B)                # (T, $) sink edge
    hi_keys = lo_keys.at[-1].set(lo_keys[-1] | np.uint32((1 << B) - 1))

    rs, _ = packed.sort(src_cand)
    first_r = packed.neighbor_ne(rs)
    pad_r = rs[0] >= _PAD_TOP
    # node-key layout: S_j at field j-1 (S_1 @ f0 .. S_{K-1} @ f_{K-2})
    top = packed.get_field(rs, K - 2, B)              # S_{K-1}
    body = packed.set_field(rs, K - 2,
                            jnp.zeros((capr,), jnp.uint32), B)
    # S_1..S_{K-2} up to fields 2..K-1; f0 = label S_{K-1}; f1 = $/probe
    base = packed.set_field(packed.shift_left(body, 2 * B), 0, top, B)
    probes = [packed.set_field(base, 1,
                               jnp.full((capr,), c, jnp.uint32), B)
              for c in range(1, sigma)]

    queries = jnp.concatenate([lo_keys, hi_keys] + probes, axis=1)
    # (a top-16-bit LUT narrowing was tried here on a TPU and was slower
    # than the fused log2(n)-round search below; not yet measured on the
    # H100)
    pos = packed.searchsorted(real_m, queries, side="left")
    lo, hi = pos[:capk], pos[capk:2 * capk]
    keep_k = first_k & (hi == lo) & ~pad_k
    # candidate widths are tiny (O(#reads)): one cheap compaction
    sinks, n_sinks, _ = packed.compact(lo_keys, keep_k, capk)

    n = real_m.shape[1]
    present = jnp.zeros((capr,), bool)
    for ci in range(sigma - 1):
        sl = pos[2 * capk + ci * capr:2 * capk + (ci + 1) * capr]
        p = jnp.minimum(sl, n - 1)
        present = present | packed.eq(real_m[:, p], probes[ci])
    keep_r = first_r & ~present & ~pad_r
    src, n_src, _ = packed.compact(base, keep_r, capr)
    src_s, _ = packed.sort(src)                        # PAD tail intact
    return sinks, n_sinks, src_s, n_src


def _lut_stats(kept, n_kept):
    """Search LUT over the padded kept buffer + max bucket (shared by
    both finish variants; see _finish_stage notes)."""
    top = (kept[0] >> 16).astype(jnp.uint32)
    lut = jnp.searchsorted(top, jnp.arange(1 << 16, dtype=jnp.uint32),
                           side="left").astype(jnp.int32)
    lut = jnp.minimum(jnp.concatenate(
        [lut, jnp.full((1,), kept.shape[1], jnp.int32)]), n_kept)
    max_bucket = jnp.max(jnp.diff(lut))
    return lut, max_bucket


@functools.partial(jax.jit, static_argnames=(
    "K", "B", "alph_size", "max_count", "canonical", "complement"))
def _finish_stage_bounds(real, counts, n_real, sink_cand, src_cand,
                         K: int, B: int, alph_size: int, max_count: int,
                         canonical: bool, complement):
    """Finish using boundary dummy candidates: the sink/source phases
    cost O(#candidates log n) probes instead of O(n log n) sorts.
    Candidates never overflow here (their capacity was fixed at collect
    time); one host sync at the end, as in _finish_stage."""
    if canonical:
        real, counts, n_real = _add_rc_stage.__wrapped__(
            real, counts, n_real, K, B, complement)
    L = real.shape[0]
    cap = real.shape[1]
    real_m = jnp.where(packed.valid_mask(cap, n_real)[None, :], real,
                       packed.full_pad(cap, L))
    if canonical:
        def rc_masked(x):
            r = _rc_node(x, K, B, complement)
            pad = x[0] >= _PAD_TOP
            return jnp.where(pad[None, :],
                             packed.full_pad(x.shape[1], L), r)
        tgt_c, src_c = sink_cand, src_cand
        sink_cand = jnp.concatenate([tgt_c, rc_masked(src_c)], axis=1)
        src_cand = jnp.concatenate([src_c, rc_masked(tgt_c)], axis=1)
    sinks, n_sinks, src, n_src = _probe_dummies(
        real_m, sink_cand, src_cand, K, B, alph_size)
    levels, n_levels_total = _levels_phase.__wrapped__(src, n_src, K, B)
    kept, n_kept, W, last, F, weights = _merge_emit_body(
        real, counts, n_real, sinks, n_sinks, src, n_src, levels,
        n_levels_total, K, B, alph_size, max_count,
        skip_redundant_sinks=False)
    lut, max_bucket = _lut_stats(kept, n_kept)
    stats = jnp.stack([n_kept, n_sinks, n_src, n_levels_total, n_real,
                       max_bucket])
    return kept, W, last, F, weights, lut, stats


@functools.partial(jax.jit, static_argnames=("K", "B"))
def _levels_phase(src, n_src, K: int, B: int):
    """All dummy-source levels 2..K-1 in one dispatch: an on-device loop
    writes each level into its own slot of a single PAD-filled buffer
    (replaces K-2 host-synced stage calls)."""
    cap = src.shape[1]
    L = src.shape[0]
    n_levels = max(K - 2, 0)
    out = packed.full_pad(max(n_levels, 1) * cap, L)

    def body(c, state):
        cur, n_cur, out, total = state
        valid = packed.valid_mask(cap, n_cur)
        node_first = packed.neighbor_ne(packing.node_key(cur, B)) & valid
        nxt = packing.to_prev(cur, K, B, 0)
        cand, n_cand, _ = packed.compact(nxt, node_first, cap)
        cand_s, _ = packed.sort(cand)
        out = jax.lax.dynamic_update_slice(out, cand_s, (0, c * cap))
        return cand_s, n_cand, out, total + n_cand

    if n_levels:
        _, _, out, total = jax.lax.fori_loop(
            0, n_levels, body, (src, n_src, out, jnp.int32(0)))
    else:
        total = jnp.int32(0)
    return out, total


@functools.partial(jax.jit, static_argnames=(
    "K", "B", "alph_size", "max_count", "cap_d", "canonical", "complement"))
def _finish_stage(real, counts, n_real, K: int, B: int, alph_size: int,
                  max_count: int, cap_d: int, canonical: bool, complement):
    """Everything after collection in ONE dispatch: rc closure (canonical),
    dummy sinks/sources, all levels, merge, emit. Dummy buffers use the
    static capacity ``cap_d``; the returned counts let the host detect
    overflow (then the driver retries with a larger cap — rare). This
    eliminates the per-stage host round trips that dominate wall time."""
    if canonical:
        real, counts, n_real = _add_rc_stage.__wrapped__(
            real, counts, n_real, K, B, complement)
    # dummy sinks + dummy-1 sources: one linear merge each against the
    # sorted real-edge projections (no route-back sorts)
    sinks, n_sink_cand = _sink_candidates(real, n_real, K, B, cap_d)
    src, n_src = _source_candidates(real, n_real, K, B, cap_d)
    n_sinks = jnp.minimum(n_sink_cand, cap_d)
    # levels (level counts are non-increasing from n_src, so cap_d holds
    # them all whenever n_src fits)
    levels, n_levels_total = _levels_phase.__wrapped__(
        src, jnp.minimum(n_src, cap_d), K, B)
    kept, n_kept, W, last, F, weights = _merge_emit_body(
        real, counts, n_real, sinks, n_sinks, src,
        jnp.minimum(n_src, cap_d), levels, n_levels_total, K, B,
        alph_size, max_count)
    # search LUT over the padded kept buffer (tail is PAD = all-ones, and
    # real top-16 values are < 0xFFFF, so bucket starts are exact); built
    # here so the host learns max_bucket in the SAME sync as the stats
    # (one host round trip instead of two)
    top = (kept[0] >> 16).astype(jnp.uint32)
    lut = jnp.searchsorted(top, jnp.arange(1 << 16, dtype=jnp.uint32),
                           side="left").astype(jnp.int32)
    lut = jnp.minimum(jnp.concatenate(
        [lut, jnp.full((1,), kept.shape[1], jnp.int32)]), n_kept)
    max_bucket = jnp.max(jnp.diff(lut))
    # n_sink_cand/n_src are TRUE counts (pre-truncation): host overflow check
    stats = jnp.stack([n_kept, n_sink_cand, n_src, n_levels_total, n_real,
                       max_bucket])
    return kept, W, last, F, weights, lut, stats


@functools.partial(jax.jit, static_argnames=("K", "B", "alph_size", "max_count"))
def _merge_emit_stage(real, counts, n_real, sinks, n_sinks, src, n_src,
                      levels, n_levels_total, K: int, B: int,
                      alph_size: int, max_count: int):
    return _merge_emit_body(real, counts, n_real, sinks, n_sinks, src,
                            n_src, levels, n_levels_total, K, B,
                            alph_size, max_count)


def _merge_emit_body(real, counts, n_real, sinks, n_sinks, src, n_src,
                     levels, n_levels_total, K: int, B: int,
                     alph_size: int, max_count: int,
                     with_sentinel: bool = True,
                     skip_redundant_sinks: bool = True):
    """Sort the (small) dummy side, merge it into the (already sorted)
    real side in one linear pass, then the initialize_chunk emit.
    ``with_sentinel=False`` skips the $^K row (out-of-core / sharded
    emits add it on the lowest-colex shard only).
    ``skip_redundant_sinks=False`` asserts the sink set is exact (the
    probe-based finish only emits a sink for nodes with no real
    outgoing edge), eliding the full-width compaction pass."""
    L = real.shape[0]

    def masked(lanes, n):
        v = packed.valid_mask(lanes.shape[1], n)
        return jnp.where(v[None, :], lanes,
                         packed.full_pad(lanes.shape[1], L))

    # every dummy key is distinct from every real key (dummies contain a
    # sentinel char; reals never do), so the unstable merge reproduces
    # the stable sorted order bit-for-bit
    sent = packed.zeros(1, L) if with_sentinel else packed.full_pad(1, L)
    dummies = jnp.concatenate(
        [masked(sinks, n_sinks), masked(src, n_src), levels, sent], axis=1)
    dummies_s, _ = packed.sort(dummies)
    real_m = masked(real, n_real)
    counts_m = jnp.where(packed.valid_mask(real.shape[1], n_real), counts, 0)
    merged, (mcounts,) = packed.merge_sorted(
        real_m, dummies_s, (counts_m,),
        (jnp.zeros((dummies_s.shape[1],), jnp.int32),))
    n_total = (n_real + n_sinks + n_src + n_levels_total
               + (1 if with_sentinel else 0))
    mcounts = jnp.where(packed.valid_mask(merged.shape[1], n_total),
                        mcounts, 0)
    return _emit_body(merged, mcounts, n_total, K, B, alph_size, max_count,
                      skip_redundant_sinks)


def _emit_body(merged, counts, n_total, K, B, alph_size, max_count,
               skip_redundant_sinks: bool = True):
    """The initialize_chunk scan (reference: boss_chunk.cpp:33-130),
    vectorized: last bits and redundant-sink skips from neighbor node-key
    compares; minus flags from a first-occurrence pass over target keys."""
    cap = merged.shape[1]
    valid = packed.valid_mask(cap, n_total)
    if skip_redundant_sinks:
        nodes = packing.node_key(merged, B)
        same_next = jnp.concatenate([
            packed.eq(nodes[:, :-1], nodes[:, 1:]), jnp.zeros((1,), bool)])
        same_next = same_next & valid & jnp.concatenate(
            [valid[1:], jnp.zeros((1,), bool)])
        labels = packing.label(merged, B)
        topc = packing.top_char(merged, K, B)
        skip = same_next & (labels == 0) & (topc != 0)
        keep = valid & ~skip
        kept, n_kept, (kcounts,) = packed.compact(
            merged, keep, cap, counts)
    else:
        # exact dummy-sink sets (probe-based finish) never produce a
        # redundant sink, so the full-width compaction pass is elided
        kept, n_kept, kcounts = merged, n_total, counts

    kvalid = packed.valid_mask(cap, n_kept)
    knodes = packing.node_key(kept, B)
    ksame_next = jnp.concatenate([
        packed.eq(knodes[:, :-1], knodes[:, 1:]), jnp.zeros((1,), bool)])
    next_valid = jnp.concatenate([kvalid[1:], jnp.zeros((1,), bool)])
    last = kvalid & ~(ksame_next & next_valid)

    klabels = packing.label(kept, B)
    ktopc = packing.top_char(kept, K, B)

    # minus flags: not the first occurrence of the (target node, label)
    # key in BOSS order (boss_chunk.cpp:95). Two edges share a target
    # key iff they agree on (u_2..u_{K-1}, label) — i.e. they sit in the
    # same contiguous block of the sort order (identical top K-2 compare
    # fields) and differ only in (u_1, label). Per real label c, "first
    # occurrence of c in my block" falls out of one global cumsum of the
    # label mask + a forward-filled block-start count (segmented first):
    # sigma-1 cumsum passes instead of a sort + sort-back or the
    # sigma^2-1 shifted compares (each compares full keys).
    bk = packed.shift_right(kept, 2 * B)          # u_2..u_{K-1} block id
    block_first = packed.neighbor_ne(bk)
    minus = jnp.zeros((cap,), bool)
    for c in range(1, alph_size):
        mask_c = (klabels == c) & kvalid
        cnt = packed.blocked_cumsum(mask_c.astype(jnp.int32))
        # count at my block's start (exclusive): cnt is nondecreasing,
        # so a running max of the run-start snapshots forward-fills it
        start_excl = packed.blocked_cummax(
            jnp.where(block_first, cnt - mask_c.astype(jnp.int32), 0))
        minus = minus | (mask_c & ((cnt - start_excl) > 1))
    minus = minus & (klabels != 0) & kvalid

    W = jnp.where(minus, klabels + alph_size, klabels).astype(jnp.int32)
    W = jnp.where(kvalid, W, 0)

    # kept is sorted with the top char as the most significant compare
    # field, so topc is NONDECREASING over the valid prefix (PAD tail
    # decodes above any real char): F comes from one batched binary
    # search instead of alph_size full-width reductions
    tc = jnp.where(kvalid, ktopc, jnp.uint32(alph_size)).astype(jnp.uint32)
    F = jnp.searchsorted(tc, jnp.arange(alph_size, dtype=jnp.uint32),
                         side="left").astype(jnp.int32)

    kfirst = packing.first_char(kept, B)
    weights = jnp.where((kcounts > 0) & (klabels != 0) & (kfirst != 0),
                        jnp.minimum(kcounts, max_count), 0).astype(jnp.int32)
    return kept, n_kept, W, last, F, weights


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def collect_kmers(
    seqs: Sequence[bytes | str],
    K: int,
    alphabet: Alphabet = DNA,
    canonical: bool = False,
    suffix: Tuple[int, ...] = (),
    extra_codes: Optional[np.ndarray] = None,
    with_bounds: bool = False,
):
    """Extract, sort, dedupe and count all k-mers of the input.

    Returns (sorted unique lanes, per-kmer counts, n_unique) at a
    power-of-two capacity — plus, with ``with_bounds``, the boundary
    dummy-candidate arrays (sink_cand, src_cand) for the probe-based
    finish. ``extra_codes`` allows feeding pre-encoded sequence codes
    directly (e.g. from KMC input)."""
    B = alphabet.bits_per_char
    codes_np = encode_sequences(seqs, alphabet) if extra_codes is None else extra_codes
    if codes_np.shape[0] < K:
        codes_np = np.concatenate(
            [codes_np, np.full(K - codes_np.shape[0], INVALID_CODE, np.uint8)])
    # pad to bucket so the extract kernel compiles per size class
    target = _bucket(codes_np.shape[0])
    pad_tail = max(target - codes_np.shape[0], 0)
    if pad_tail:
        codes_np = np.concatenate(
            [codes_np, np.full(pad_tail, INVALID_CODE, np.uint8)])
    n = codes_np.shape[0]
    n_valid = n - pad_tail
    pack2 = None
    if B == 4 and alphabet.size <= 5:
        # the contiguous bucket-padding tail (up to ~25% of n) is masked
        # positionally on device (n_valid iota), NOT via the sparse
        # sidecar — otherwise the pad alone forces the nibble fallback
        pack2 = pack_codes2_host(codes_np, n_valid=n_valid)
    if pack2 is not None:
        dev_in = (jnp.asarray(pack2[0]), jnp.asarray(pack2[1]))
    elif B == 4:
        dev_in = jnp.asarray(pack_codes_host(codes_np))
    else:
        dev_in = jnp.asarray(codes_np)
    if with_bounds and not suffix and pack2 is not None:
        # boundary candidate positions are a pure function of the
        # invalid-code positions, already on the host from the pack2
        # sidecar — no device-side window masks or compaction passes
        idx_np = pack2[2]
        end_pos, start_pos = host_boundary_windows(idx_np, n_valid, K)
        n_end, n_start = len(end_pos), len(start_pos)
        capq = _bucket(max(n_end, n_start, 1))
        ep = np.zeros(capq, np.int32)
        ep[:n_end] = end_pos
        sp = np.zeros(capq, np.int32)
        sp[:n_start] = start_pos
        ulanes, ucounts, ucount, bounds = _collect_stage_bounds_pos(
            dev_in[0], dev_in[1], jnp.int32(n_valid), jnp.asarray(ep),
            jnp.int32(n_end), jnp.asarray(sp), jnp.int32(n_start), n, K,
            B, canonical, alphabet.complement)
        n_u = int(ucount)                         # ONE host sync
        cap = max(_bucket(n_u), 1)
        return ulanes[:, :cap], ucounts[:cap], n_u, bounds
    if with_bounds and not suffix:
        nw = n - K + 1
        cap_b = _bucket(max(4096, min(nw >> 4, 8 << 20)))
        while True:
            if B == 4:
                ulanes, ucounts, cnts, bounds = _collect_stage_bounds_packed(
                    dev_in, n, K, B, cap_b, canonical, alphabet.complement)
            else:
                ulanes, ucounts, cnts, bounds = _collect_stage_bounds(
                    dev_in, K, B, cap_b, canonical, alphabet.complement)
            cnts = np.asarray(cnts)               # ONE host sync
            n_u, n_end, n_start = int(cnts[0]), int(cnts[1]), int(cnts[2])
            if n_end <= cap_b and n_start <= cap_b:
                break
            cap_b = _bucket(max(n_end, n_start))
        sink_cand, src_cand = bounds
        # slice the candidate buffers (front-compacted, PAD tails) down
        # to the true-count bucket: every downstream buffer (probes,
        # levels, dummy merge) scales with this capacity
        capq = min(_bucket(max(n_end, n_start, 1)), cap_b)
        sink_cand = sink_cand[:, :capq]
        src_cand = src_cand[:, :capq]
        cap = max(_bucket(n_u), 1)
        return ulanes[:, :cap], ucounts[:cap], n_u, (sink_cand, src_cand)
    if pack2 is not None:
        ulanes, ucounts, ucount = _collect_stage_packed2(
            dev_in[0], dev_in[1], jnp.int32(n_valid), n, K, B,
            tuple(suffix), canonical, alphabet.complement)
    elif B == 4:
        ulanes, ucounts, ucount = _collect_stage_packed(
            dev_in, n, K, B, tuple(suffix), canonical, alphabet.complement)
    else:
        ulanes, ucounts, ucount = _collect_stage(
            dev_in, K, B, tuple(suffix), canonical, alphabet.complement)
    n_u = int(ucount)
    cap = _bucket(n_u)
    if with_bounds:
        return ulanes[:, :max(cap, 1)], ucounts[:max(cap, 1)], n_u, None
    return ulanes[:, :max(cap, 1)], ucounts[:max(cap, 1)], n_u


def collect_counted_kmers(
    chars: np.ndarray,
    counts: np.ndarray,
    K: int,
    alphabet: Alphabet = DNA,
    canonical: bool = False,
) -> Tuple[jax.Array, jax.Array, int]:
    """Sorted unique k-mers from pre-counted input (KMC databases,
    reference kmc_parser path): (n, K) char codes + (n,) counts."""
    B = alphabet.bits_per_char
    cap = _bucket(chars.shape[0])
    lanes = packing.pack_from_chars(jnp.asarray(chars), K, B)
    lanes = packed.pad_to(lanes, cap)
    cnts = jnp.concatenate([
        jnp.asarray(np.minimum(counts, (1 << 31) - 1).astype(np.int32)),
        jnp.zeros((cap - counts.shape[0],), jnp.int32)])
    if canonical:
        rc = packing.reverse_complement(lanes, K, B, alphabet.complement)
        valid = packed.valid_mask(cap, jnp.int32(chars.shape[0]))
        take_rc = packed.lt(rc, lanes) & valid
        lanes = jnp.where(take_rc[None, :], rc, lanes)
    ulanes, ucounts, ucount = _sort_unique_stage(
        lanes, cnts, jnp.int32(chars.shape[0]))
    n_u = int(ucount)
    out_cap = _bucket(n_u)
    return ulanes[:, :out_cap], ucounts[:out_cap], n_u


LARGE_FINISH_CAP = 40 << 20    # fused finish verified at this capacity
# (the 34M-char probe ran the fused dispatch at cap 41943040; anything
# larger goes through the staged path below)


@functools.partial(jax.jit, static_argnames=("K", "B", "cap_out"))
def _sink_stage(real, n_real, K: int, B: int, cap_out: int):
    return _sink_candidates(real, n_real, K, B, cap_out)


@functools.partial(jax.jit, static_argnames=("K", "B", "cap_out"))
def _source_stage(real, n_real, K: int, B: int, cap_out: int):
    return _source_candidates(real, n_real, K, B, cap_out)


def _sync_scalar(x) -> int:
    """Fetch one device scalar; the fetch is the stage barrier."""
    return int(np.asarray(x))


def _build_boss_from_kmers_large(real, counts, n_real, K, alphabet, mode,
                                 bits_per_count, keep_kmer_index) -> Boss:
    """Stage-by-stage finish for very large inputs. Each stage syncs,
    slices its output to a tight bucket, and frees before the next stage
    launches: the fused dispatch must size dummy buffers statically
    (capacity >> true counts — pure sort/merge waste at this scale) and
    holds every intermediate live at once, which exhausts device memory
    on large inputs. The extra host round trips are amortized here."""
    import gc
    B = alphabet.bits_per_char
    max_count = (1 << bits_per_count) - 1 if bits_per_count else (1 << 31) - 1
    if mode == MODE_CANONICAL:
        real, counts, n_arr = _add_rc_stage(
            real, counts, jnp.int32(n_real), K, B, alphabet.complement)
        n_real = _sync_scalar(n_arr)
        cap2 = _bucket(n_real)
        real = real[:, :cap2]
        counts = counts[:cap2]
        gc.collect()
    # candidate buffers at full capacity: staged never overflows/retries
    cap = real.shape[1]
    sinks, n_sinks_d = _sink_stage(real, jnp.int32(n_real), K, B, cap)
    src, n_src_d = _source_stage(real, jnp.int32(n_real), K, B, cap)
    n_sinks = _sync_scalar(n_sinks_d)
    n_src = _sync_scalar(n_src_d)
    sinks = sinks[:, :_bucket(n_sinks, lo=4096)]
    src = src[:, :_bucket(n_src, lo=4096)]
    gc.collect()
    levels, n_lvl_d = _levels_phase(src, jnp.int32(n_src), K, B)
    n_levels_total = _sync_scalar(n_lvl_d)
    kept, n_kept_d, W, last, F, weights = _merge_emit_stage(
        real, counts, jnp.int32(n_real), sinks, jnp.int32(n_sinks),
        src, jnp.int32(n_src), levels, jnp.int32(n_levels_total),
        K, B, alphabet.size, max_count)
    n_kept = _sync_scalar(n_kept_d)
    del real, counts, sinks, src, levels
    gc.collect()
    lut = max_bucket = None
    if keep_kmer_index and n_kept > 0:
        top = (kept[0] >> 16).astype(jnp.uint32)
        lut = jnp.searchsorted(top, jnp.arange(1 << 16, dtype=jnp.uint32),
                               side="left").astype(jnp.int32)
        lut = jnp.minimum(jnp.concatenate(
            [lut, jnp.full((1,), kept.shape[1], jnp.int32)]), n_kept)
        max_bucket = _sync_scalar(jnp.max(jnp.diff(lut)))
    return Boss.from_finish(
        k=K - 1, alph_size=alphabet.size, bits_per_char=B,
        kept=kept, W=W, last=last, F=F, n_kept=n_kept,
        weights=weights if bits_per_count else None,
        keep_kmer_index=keep_kmer_index, lut=lut, max_bucket=max_bucket)


def build_boss_from_kmers(
    real: jax.Array,
    counts: jax.Array,
    n_real: int,
    K: int,
    alphabet: Alphabet = DNA,
    mode: str = MODE_BASIC,
    bits_per_count: int = 0,
    keep_kmer_index: bool = True,
    bounds=None,
) -> Boss:
    """Generate dummy edges, merge, and emit the BOSS arrays.

    ONE device dispatch (+ the caller's collect) and ONE host sync: the
    whole post-collection pipeline is fused to keep host round trips off
    the critical path, and dummy buffers use a static capacity with a
    host-side overflow check + retry.

    ``bounds`` (from ``collect_kmers(with_bounds=True)``) switches the
    dummy phases to the boundary-probe formulation — O(#reads) probes
    instead of O(#k-mers) sorts, the single biggest cost of the old
    finish at scale."""
    B = alphabet.bits_per_char
    if mode == MODE_CANONICAL and not alphabet.complement:
        raise ValueError(
            f"canonical mode needs a complemented alphabet; "
            f"{alphabet.name} has no complement table (reference restricts "
            f"canonical graphs to DNA alphabets, alphabets.hpp)")
    max_count = (1 << bits_per_count) - 1 if bits_per_count else (1 << 31) - 1
    if bounds is not None and real.shape[1] <= LARGE_FINISH_CAP:
        sink_cand, src_cand = bounds
        kept, W, last, F, weights, lut, stats = _finish_stage_bounds(
            real, counts, jnp.int32(n_real), sink_cand, src_cand, K, B,
            alphabet.size, max_count, mode == MODE_CANONICAL,
            alphabet.complement)
        stats = np.asarray(stats)          # the single host sync
        return Boss.from_finish(
            k=K - 1, alph_size=alphabet.size, bits_per_char=B,
            kept=kept, W=W, last=last, F=F, n_kept=int(stats[0]),
            weights=weights if bits_per_count else None,
            keep_kmer_index=keep_kmer_index,
            lut=lut, max_bucket=int(stats[5]))
    if real.shape[1] > LARGE_FINISH_CAP:
        return _build_boss_from_kmers_large(
            real, counts, n_real, K, alphabet, mode, bits_per_count,
            keep_kmer_index)
    cap_d = max(real.shape[1] >> 6, 4096)
    while True:
        kept, W, last, F, weights, lut, stats = _finish_stage(
            real, counts, jnp.int32(n_real), K, B, alphabet.size,
            max_count, cap_d, mode == MODE_CANONICAL, alphabet.complement)
        stats = np.asarray(stats)          # the single host sync
        n_kept, n_sink_cand, n_src = int(stats[0]), int(stats[1]), int(stats[2])
        if n_sink_cand <= cap_d and n_src <= cap_d:
            break
        cap_d = _bucket(max(n_sink_cand, n_src))

    return Boss.from_finish(
        k=K - 1, alph_size=alphabet.size, bits_per_char=B,
        kept=kept, W=W, last=last, F=F, n_kept=n_kept,
        weights=weights if bits_per_count else None,
        keep_kmer_index=keep_kmer_index,
        lut=lut, max_bucket=int(stats[5]))


def build_boss_from_codes(
    codes_np: np.ndarray,
    k: int,
    alphabet: Alphabet = DNA,
    mode: str = MODE_BASIC,
    bits_per_count: int = 0,
) -> Boss:
    """Build directly from a pre-encoded code array (native codec path)."""
    canonical = mode in (MODE_CANONICAL, MODE_PRIMARY)
    if codes_np.shape[0] < k:
        codes_np = np.concatenate(
            [codes_np, np.full(k - codes_np.shape[0], INVALID_CODE, np.uint8)])
    target = _bucket(codes_np.shape[0])
    if codes_np.shape[0] < target:
        codes_np = np.concatenate(
            [codes_np,
             np.full(target - codes_np.shape[0], INVALID_CODE, np.uint8)])
    # primary folds orientations, so boundary reasoning over the raw
    # reads no longer bounds the dummy sets — old path for primary
    use_bounds = mode != MODE_PRIMARY
    if use_bounds:
        ulanes, ucounts, n_u, bounds = collect_kmers(
            [], k, alphabet, canonical=canonical, extra_codes=codes_np,
            with_bounds=True)
    else:
        ulanes, ucounts, n_u = collect_kmers(
            [], k, alphabet, canonical=canonical, extra_codes=codes_np)
        bounds = None
    return build_boss_from_kmers(
        ulanes, ucounts, n_u, k, alphabet,
        mode=MODE_CANONICAL if mode == MODE_CANONICAL else MODE_BASIC,
        bits_per_count=bits_per_count, bounds=bounds)


def build_boss(
    seqs: Sequence[bytes | str],
    k: int,
    alphabet: Alphabet = DNA,
    mode: str = MODE_BASIC,
    bits_per_count: int = 0,
    suffix: Tuple[int, ...] = (),
) -> Boss:
    """End-to-end single-shard BOSS build for DBG k-mer size ``k``
    (edge k-mers have K = k characters; BOSS node length k-1, matching
    DBGSuccinct's k = BOSS k + 1, dbg_succinct.hpp:113)."""
    canonical = mode in (MODE_CANONICAL, MODE_PRIMARY)
    if canonical and not alphabet.complement:
        raise ValueError(
            f"canonical/primary mode needs a complemented alphabet; "
            f"{alphabet.name} has no complement table")
    use_bounds = mode != MODE_PRIMARY and not suffix
    if use_bounds:
        real, counts, n_real, bounds = collect_kmers(
            seqs, k, alphabet, canonical=canonical, suffix=suffix,
            with_bounds=True)
    else:
        real, counts, n_real = collect_kmers(
            seqs, k, alphabet, canonical=canonical, suffix=suffix)
        bounds = None
    # PRIMARY keeps only the canonical forms; CANONICAL adds the closure
    return build_boss_from_kmers(
        real, counts, n_real, k, alphabet,
        mode=MODE_CANONICAL if mode == MODE_CANONICAL else MODE_BASIC,
        bits_per_count=bits_per_count, bounds=bounds)
