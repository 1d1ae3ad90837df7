"""Out-of-core BOSS construction: graphs far beyond device memory on ONE card.

The reference builds trillion-node graphs by partitioning k-mer space
into suffix buckets, spilling sorted chunks to disk, and finishing one
bucket at a time (boss_chunk_construct.cpp:103-356,
sorted_set_disk_base.hpp:34). The device analog keeps the same phase
structure but puts every super-linear kernel (sort, merge-join, emit) on
the device and every linear re-bucketing step on the host, where the
full data set lives in memory-mapped files:

  pass 1  input chunks -> device collect (extract+sort+unique) -> host runs
  split   run-quantile sampling -> S-1 *group-key* splitters. Group keys
          (parallel/distributed.group_key) zero the edge label and first
          node char, so all edges of a node AND all edges sharing a
          (target node, label) pair land on one shard: the emit stage's
          last-bit / redundant-sink / minus-flag logic stays shard-local.
  pass 2  per shard: its slice of every run -> device sort-unique
  host    query generation (to_next / to_prev / node_key / target_key as
          vectorized numpy bit ops over the memmapped shard) + owner
          bucketing by group key
  pass 3  per shard: device joins — dummy-sink membership
          (boss_chunk_construct.cpp:55-98) and dummy-source has-incoming
          (ibid:100-166) — against the shard-local sorted keys
  host    verdict routing home, prev-edge construction, dummy level
          iteration (levels shrink geometrically; host numpy)
  pass 4  per shard: device merge + emit (boss_chunk.cpp:33-130), the
          $^K sentinel row on shard 0 only, per-shard top-char histogram
  final   host-concatenated W/last/weights + summed F -> Boss
          (small state by default: ~2 B/edge on device)

Peak device memory is O(total / n_shards); peak host RSS is O(chunk) for
pass 1 plus the memmapped shard files (the OS page cache manages
residency). Bit-identical to build_boss() — asserted in tests on every
mode the two share.
"""

from __future__ import annotations

import functools
import os
import tempfile
from typing import Iterable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..common import packed
from ..graph import boss_construct as bc
from ..graph.boss import Boss
from ..kmer import packing
from ..kmer.alphabets import Alphabet, DNA, INVALID_CODE

LANE_BITS = 32
U32 = np.uint32


# ---------------------------------------------------------------------------
# host mirrors of the packed-lane bit ops (numpy, vectorized over columns)
# ---------------------------------------------------------------------------

def h_shift_right(x: np.ndarray, nbits: int) -> np.ndarray:
    L = x.shape[0]
    whole, bits = divmod(nbits, LANE_BITS)
    parts = []
    for j in range(L):
        src = j - whole
        if src < 0:
            parts.append(np.zeros_like(x[0]))
            continue
        v = x[src] >> U32(bits) if bits else x[src].copy()
        if bits and src - 1 >= 0:
            v |= x[src - 1] << U32(LANE_BITS - bits)
        parts.append(v)
    return np.stack(parts)


def h_shift_left(x: np.ndarray, nbits: int) -> np.ndarray:
    L = x.shape[0]
    whole, bits = divmod(nbits, LANE_BITS)
    parts = []
    for j in range(L):
        src = j + whole
        if src >= L:
            parts.append(np.zeros_like(x[0]))
            continue
        v = x[src] << U32(bits) if bits else x[src].copy()
        if bits and src + 1 < L:
            v |= x[src + 1] >> U32(LANE_BITS - bits)
        parts.append(v)
    return np.stack(parts)


def h_get_field(x: np.ndarray, slot: int, B: int) -> np.ndarray:
    L = x.shape[0]
    bit = slot * B
    lane = L - 1 - bit // LANE_BITS
    off = bit % LANE_BITS
    return (x[lane] >> U32(off)) & U32((1 << B) - 1)


def h_set_field(x: np.ndarray, slot: int, vals, B: int) -> np.ndarray:
    """Returns a copy with field ``slot`` overwritten."""
    L = x.shape[0]
    bit = slot * B
    lane = L - 1 - bit // LANE_BITS
    off = bit % LANE_BITS
    mask = U32(((1 << B) - 1) << off)
    out = x.copy()
    out[lane] = (x[lane] & ~mask) | ((np.asarray(vals, U32) << U32(off))
                                     & mask)
    return out


def h_node_key(x: np.ndarray, B: int) -> np.ndarray:
    return h_shift_right(x, B)


def h_target_key(x: np.ndarray, B: int) -> np.ndarray:
    hi = h_shift_left(h_shift_right(x, 2 * B), B)
    hi[-1] |= h_get_field(x, 0, B)
    return hi


def h_to_next(x: np.ndarray, K: int, B: int) -> np.ndarray:
    lab = h_get_field(x, 0, B)
    out = h_shift_left(h_shift_right(x, 2 * B), B)
    return h_set_field(out, K - 1, lab, B)


def h_to_prev(x: np.ndarray, K: int, B: int) -> np.ndarray:
    L, n = x.shape
    top = h_get_field(x, K - 1, B)
    mid = x.copy()
    low_mask = _low_bits_mask(L, (K - 1) * B)
    for j in range(L):
        mid[j] &= low_mask[j]
    mid = h_set_field(mid, 0, np.zeros(n, U32), B)
    out = h_shift_left(mid, B)
    return h_set_field(out, 0, top, B)


def _low_bits_mask(lanes: int, nbits: int) -> np.ndarray:
    out = np.zeros(lanes, U32)
    for j in range(lanes):
        lo_bit = (lanes - 1 - j) * LANE_BITS
        hi_bit = lo_bit + LANE_BITS
        if nbits >= hi_bit:
            out[j] = 0xFFFFFFFF
        elif nbits > lo_bit:
            out[j] = (1 << (nbits - lo_bit)) - 1
    return out


def h_group_key(x: np.ndarray, B: int) -> np.ndarray:
    """Zero fields 0 (label) and 1 (first node char) — 2*B low bits,
    always inside the last lane (B <= 8)."""
    out = np.ascontiguousarray(x)
    out = out.copy()
    out[-1] &= ~U32((1 << (2 * B)) - 1)
    return out


def _rec(x: np.ndarray):
    """Structured view for lexicographic compare/search (lane 0 most
    significant, matching the device colex order)."""
    return np.rec.fromarrays([np.ascontiguousarray(x[j])
                              for j in range(x.shape[0])])


def h_owner_tkey(x: np.ndarray, splitters: np.ndarray,
                 B: int) -> np.ndarray:
    """Shard owner for TARGET keys (h_target_key layout: label@0,
    e_2@1..e_{K-1}@{K-2}, 0@{K-1}).

    A tkey's top field is always zero, so routing it through
    ``h_owner`` directly compares below every splitter and sends ALL
    source-join traffic to shard 0 — silently correct (both join
    sides skew identically) but catastrophically unbalanced: at 268M
    edges the single-shard join OOMs a 16 GB chip. Shifting left one
    field aligns e_2..e_{K-1} with slots 2..{K-1} — the exact bit
    positions the edge group-key splitters were sampled from — so
    tkeys distribute like edges."""
    return h_owner(h_shift_left(x, B), splitters, B)


def h_owner(x: np.ndarray, splitters: np.ndarray, B: int) -> np.ndarray:
    """Shard owner per column: #splitters <= group_key(x).

    Vectorized lane compares per splitter — NOT a structured-array
    searchsorted, whose per-element tuple comparisons run ~50x slower
    at the 10^8-entry scale this is used at."""
    if splitters.shape[1] == 0:
        return np.zeros(x.shape[1], np.int64)
    gk = h_group_key(x, B)
    L = gk.shape[0]
    owner = np.zeros(gk.shape[1], np.int64)
    for j in range(splitters.shape[1]):
        sp = splitters[:, j]
        # lexicographic gk >= sp (lane 0 most significant)
        lt = gk[L - 1] < sp[L - 1]
        for l in range(L - 2, -1, -1):
            lt = np.where(gk[l] == sp[l], lt, gk[l] < sp[l])
        owner += ~lt
    return owner


def _bucket_by_owner(x: np.ndarray, owners: np.ndarray, S: int,
                     *extras) -> List[tuple]:
    """Split columns of x (and aligned extras) into S per-owner groups."""
    order = np.argsort(owners, kind="stable")
    xs = x[:, order]
    es = [np.asarray(e)[order] for e in extras]
    bounds = np.searchsorted(owners[order], np.arange(S + 1))
    out = []
    for s in range(S):
        sl = slice(bounds[s], bounds[s + 1])
        out.append((xs[:, sl],) + tuple(e[sl] for e in es))
    return out


# ---------------------------------------------------------------------------
# device stages (per shard)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("B", "cap_out"))
def _sink_join_jit(keys, n_keys, q_nodes, n_q, B: int, cap_out: int):
    """keys: this shard's real source-node keys (sorted, PAD tail);
    q_nodes: routed sink node-key queries (unsorted concat of buckets).
    Returns (sink dummy edges sorted+deduped, true count)."""
    L = keys.shape[0]
    kcap = keys.shape[1]
    qcap = q_nodes.shape[1]
    keys_m = jnp.where(packed.valid_mask(kcap, n_keys)[None, :], keys,
                       packed.full_pad(kcap, L))
    q_m = jnp.where(packed.valid_mask(qcap, n_q)[None, :], q_nodes,
                    packed.full_pad(qcap, L))
    q_s, _ = packed.sort(q_m)
    vals, is_q, present, is_pad, run_first = bc._merge_membership(keys_m, q_s)
    keep = is_q & ~present & ~is_pad & run_first
    nodes_out, n_out, _ = packed.compact(vals, keep, cap_out)
    m = jnp.minimum(n_out, cap_out)
    sinks = jnp.where(packed.valid_mask(cap_out, m)[None, :],
                      packed.shift_left(nodes_out, B),
                      packed.full_pad(cap_out, L))
    return sinks, n_out


@jax.jit
def _src_join_jit(ref_tk, n_ref, q_tk, n_q):
    """Has-incoming verdicts, aligned to q_tk input order: True means the
    query target key matches NO real edge's target key -> the origin
    node needs a dummy-1 source edge."""
    L = ref_tk.shape[0]
    rcap, qcap = ref_tk.shape[1], q_tk.shape[1]
    valid_q = packed.valid_mask(qcap, n_q)
    keys_m = jnp.where(packed.valid_mask(rcap, n_ref)[None, :], ref_tk,
                       packed.full_pad(rcap, L))
    has_inc = packed.isin_merge(keys_m, q_tk)
    return (~has_inc) & valid_q


@functools.partial(jax.jit, static_argnames=(
    "K", "B", "alph_size", "max_count", "with_sentinel"))
def _emit_hist_jit(real, counts, n_real, sinks, n_sinks, src, n_src,
                   levels, n_levels_total, K: int, B: int, alph_size: int,
                   max_count: int, with_sentinel: bool):
    kept, n_kept, W, last, _F_local, weights = bc._merge_emit_body(
        real, counts, n_real, sinks, n_sinks, src, n_src, levels,
        n_levels_total, K, B, alph_size, max_count,
        with_sentinel=with_sentinel)
    kvalid = packed.valid_mask(kept.shape[1], n_kept)
    tc = jnp.where(kvalid, packing.top_char(kept, K, B), alph_size)
    hist = jnp.stack([jnp.sum((tc == c).astype(jnp.int32))
                      for c in range(alph_size)])
    # real-edge mask (no sentinel char): label and first node char both
    # non-$ — the small-state substitute for deriving it from edge_lanes
    valid_real = (kvalid & (packing.label(kept, B) != 0)
                  & (packing.first_char(kept, B) != 0))
    return kept, n_kept, W, last, hist, weights, valid_real


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _pad_lanes_np(x: np.ndarray, cap: int) -> np.ndarray:
    L, n = x.shape
    if n == cap:
        return np.ascontiguousarray(x)
    out = np.full((L, cap), packed.PAD_LANE, U32)
    out[:, :n] = x
    return out


def _d2h_tight(lanes, n: int) -> np.ndarray:
    return np.asarray(lanes[:, :n])


class _RunStore:
    """Sorted (lanes, counts) runs on disk (npy memmaps)."""

    def __init__(self, directory: Optional[str]):
        self.dir = tempfile.mkdtemp(prefix="mtg_ooc_", dir=directory)
        self.runs: List[Tuple[str, str, int]] = []
        self._seq = 0

    def add(self, lanes: np.ndarray, counts: Optional[np.ndarray]):
        """``counts=None`` marks a weightless run (bits_per_count == 0):
        nothing is spilled and nothing crosses the d2h link for it."""
        lp = os.path.join(self.dir, f"run{self._seq}.lanes.npy")
        cp = os.path.join(self.dir, f"run{self._seq}.counts.npy")
        self._seq += 1
        np.save(lp, np.ascontiguousarray(lanes))
        if counts is not None:
            np.save(cp, np.ascontiguousarray(counts.astype(np.int32)))
        else:
            cp = None
        self.runs.append((lp, cp, lanes.shape[1]))

    def load(self, i):
        lp, cp, n = self.runs[i]
        return (np.load(lp, mmap_mode="r"),
                np.load(cp, mmap_mode="r") if cp is not None else None)

    def cleanup(self):
        import shutil
        shutil.rmtree(self.dir, ignore_errors=True)


def _sample_splitters_from_runs(store: _RunStore, L: int, B: int,
                                n_shards: int, per_run: int = 4096
                                ) -> np.ndarray:
    """(L, n_shards-1) group-key splitters from run-stride samples."""
    samples = []
    for i in range(len(store.runs)):
        lanes, _ = store.load(i)
        n = lanes.shape[1]
        if n == 0:
            continue
        stride = max(n // per_run, 1)
        samples.append(np.asarray(lanes[:, ::stride]))
    if not samples:
        return np.zeros((L, 0), U32)
    allk = np.concatenate(samples, axis=1)
    gk = h_group_key(allk, B)
    order = np.argsort(_rec(gk), kind="stable")
    gs = gk[:, order]
    qs = [gs[:, (i * gs.shape[1]) // n_shards]
          for i in range(1, n_shards)]
    sp = np.stack(qs, axis=1) if qs else np.zeros((L, 0), U32)
    # drop duplicate splitters (empty shards are legal but wasteful)
    if sp.shape[1] > 1:
        keep = np.concatenate(
            [[True], (sp[:, 1:] != sp[:, :-1]).any(axis=0)])
        sp = sp[:, keep]
    return sp


def build_boss_out_of_core(
    seqs: Iterable[bytes],
    k: int,
    alphabet: Alphabet = DNA,
    n_shards: int = 8,
    bits_per_count: int = 0,
    chunk_codes: int = 1 << 25,
    tmp_dir: Optional[str] = None,
    keep_kmer_index: bool = False,
    verbose: bool = False,
    return_valid: bool = False,
    runs: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
):
    """Single-chip build with device working set O(total / n_shards).

    Basic mode only (canonical needs an rc-closure routing pass — use
    the sharded mesh build for that). Returns a Boss without the packed
    edge index by default (small-state scale regime).

    ``runs``: pre-sorted (lanes, counts) k-mer sets — pass 1 is skipped
    and the sets merge through the sharded finish directly. This is the
    streaming multi-BOSS merge entry (reference boss_merge.cpp:125-300:
    k-way merge of serialized chunks without re-extracting k-mers)."""
    from ..common.telemetry import span
    K = k
    B = alphabet.bits_per_char
    L = packing.lanes_for(K, B)
    max_count = (1 << bits_per_count) - 1 if bits_per_count else (1 << 31) - 1
    store = _RunStore(tmp_dir)

    import time as _time
    _t_start = _time.time()

    def log(msg):
        if verbose:
            import sys
            print(f"[ooc +{_time.time() - _t_start:7.1f}s] {msg}",
                  file=sys.stderr, flush=True)

    # ---- pass 1: collect sorted unique runs --------------------------------
    if runs is not None:
        for lanes_np, counts_np in runs:
            store.add(np.asarray(lanes_np),
                      np.asarray(counts_np) if bits_per_count
                      and counts_np is not None else None)
        seqs = ()
    tbl = alphabet.encode_table()
    buf = np.full(chunk_codes, INVALID_CODE, np.uint8)
    fill = 0

    def flush():
        nonlocal fill
        if fill == 0:
            return
        pack2 = (bc.pack_codes2_host(buf, n_valid=fill)
                 if B == 4 and alphabet.size <= 5 else None)
        if pack2 is not None:
            ulanes, ucounts, ucount = bc._collect_stage_packed2(
                jnp.asarray(pack2[0]), jnp.asarray(pack2[1]),
                jnp.int32(fill), chunk_codes, K, B, (), False,
                alphabet.complement)
        elif B == 4:
            words = jnp.asarray(bc.pack_codes_host(buf))
            ulanes, ucounts, ucount = bc._collect_stage_packed(
                words, chunk_codes, K, B, (), False, alphabet.complement)
        else:
            ulanes, ucounts, ucount = bc._collect_stage(
                jnp.asarray(buf), K, B, (), False, alphabet.complement)
        n = int(ucount)
        # counts exist only to become weights; with bits_per_count == 0
        # they never cross the d2h link or touch disk
        store.add(_d2h_tight(ulanes, n),
                  np.asarray(ucounts[:n]) if bits_per_count else None)
        buf.fill(INVALID_CODE)
        fill = 0

    for s in seqs:
        codes = (s if isinstance(s, np.ndarray)
                 else tbl[np.frombuffer(bytes(s), np.uint8)])
        pos = 0
        while pos < len(codes):
            space = chunk_codes - fill - 1
            if space < K:
                flush()
                space = chunk_codes - 1
            take = min(space, len(codes) - pos)
            buf[fill:fill + take] = codes[pos:pos + take]
            fill += take + 1
            pos += take
            if pos < len(codes):
                pos = max(0, pos - (K - 1))   # window overlap at the seam
    flush()
    log(f"pass1: {len(store.runs)} runs, "
        f"{sum(r[2] for r in store.runs) / 1e6:.1f}M entries")

    # ---- splitters + per-run shard boundaries ------------------------------
    splitters = _sample_splitters_from_runs(store, L, B, n_shards)
    S = splitters.shape[1] + 1
    run_bounds = []     # per run: (S+1,) slice boundaries
    for i in range(len(store.runs)):
        lanes, _ = store.load(i)
        gk = h_group_key(np.asarray(lanes), B)
        b = np.searchsorted(_rec(gk), _rec(splitters), side="left")
        run_bounds.append(np.concatenate([[0], b, [lanes.shape[1]]]))
    log(f"splitters: {S} shards")

    # ---- pass 2: per-shard sort-unique -------------------------------------
    # ONE capacity for every shard: each distinct shape is a fresh XLA
    # compile — uniform caps mean each stage kernel compiles exactly
    # once across all S shards
    shard_lanes: List[np.ndarray] = []
    shard_counts: List[np.ndarray] = []
    shard_ins = []
    for s in range(S):
        parts_l, parts_c = [], []
        for i in range(len(store.runs)):
            lanes, counts = store.load(i)
            lo, hi = run_bounds[i][s], run_bounds[i][s + 1]
            if hi > lo:
                parts_l.append(np.asarray(lanes[:, lo:hi]))
                if counts is not None:
                    parts_c.append(np.asarray(counts[lo:hi]))
        if not parts_l:
            shard_ins.append((np.zeros((L, 0), U32), np.zeros(0, np.int32)))
        else:
            shard_ins.append((np.concatenate(parts_l, axis=1),
                              np.concatenate(parts_c) if parts_c
                              else None))
    cap2 = bc._bucket(max(max(c[0].shape[1] for c in shard_ins), 1))
    for s in range(S):
        cat, ccat = shard_ins[s]
        n_in = cat.shape[1]
        if n_in == 0:
            shard_lanes.append(np.zeros((L, 0), U32))
            shard_counts.append(None if ccat is None
                                else np.zeros(0, np.int32))
            continue
        if ccat is None:
            # device-created zeros: no h2d bytes for the dead counts
            counts_in = jnp.zeros(cap2, jnp.int32)
        else:
            counts_in = jnp.asarray(np.concatenate(
                [ccat, np.zeros(cap2 - n_in, np.int32)]))
        ul, uc, un = bc._sort_unique_stage(
            jnp.asarray(_pad_lanes_np(cat, cap2)), counts_in,
            jnp.int32(n_in))
        n_u = int(un)
        shard_lanes.append(_d2h_tight(ul, n_u))
        shard_counts.append(None if ccat is None else np.asarray(uc[:n_u]))
        shard_ins[s] = None
    del shard_ins
    store.cleanup()
    total_real = sum(x.shape[1] for x in shard_lanes)
    log(f"pass2: {total_real / 1e6:.2f}M unique k-mers across {S} shards "
        f"(max shard {max(x.shape[1] for x in shard_lanes) / 1e6:.2f}M)")

    # ---- host query generation + bucketing ---------------------------------
    sinkq_buckets = [[] for _ in range(S)]          # node-key queries
    srcq_buckets = [[] for _ in range(S)]           # (tkey, origin, idx)
    reftk_buckets = [[] for _ in range(S)]          # real-edge tkeys
    for s in range(S):
        real = shard_lanes[s]
        if real.shape[1] == 0:
            continue
        # route by the SHIFTED EDGE's group key (its source node is the
        # query target, so gk = (t_2..t_{K-1}) — the same partition that
        # placed the real edges with source node t); the payload is the
        # node key (what the membership join compares)
        q_edge = h_to_next(real, K, B)
        q_nodes = h_node_key(q_edge, B)
        for d, (piece,) in enumerate(
                _bucket_by_owner(q_nodes, h_owner(q_edge, splitters, B),
                                 S)):
            if piece.shape[1]:
                sinkq_buckets[d].append(piece)
        ref_tk = h_target_key(real, B)
        for d, (piece,) in enumerate(
                _bucket_by_owner(ref_tk, h_owner_tkey(ref_tk, splitters, B),
                                 S)):
            if piece.shape[1]:
                reftk_buckets[d].append(piece)
        nk = h_node_key(real, B)
        node_first = np.concatenate(
            [[True], (nk[:, 1:] != nk[:, :-1]).any(axis=0)])
        idx = np.nonzero(node_first)[0].astype(np.int64)
        prev = h_to_prev(real[:, node_first], K, B)
        q_tk = h_target_key(prev, B)
        own = h_owner_tkey(q_tk, splitters, B)
        for d, (piece, pidx) in enumerate(
                _bucket_by_owner(q_tk, own, S, idx)):
            if piece.shape[1]:
                srcq_buckets[d].append((piece, np.full(
                    piece.shape[1], s, np.int32), pidx))

    log("hostgen: query buckets built")

    # ---- pass 3: device joins (uniform caps: one compile per kernel) -------
    sink_edges: List[np.ndarray] = [np.zeros((L, 0), U32)] * S
    src_home: List[List[np.ndarray]] = [[] for _ in range(S)]
    verdicts_by_origin = [[] for _ in range(S)]   # (idx, verdict)
    # concatenate each shard's bucket pieces and free the pieces at once
    # (they duplicate the concatenated arrays — at 512M inputs the
    # difference is tens of GB of peak host RSS)
    sq_cat, rt_cat, qt_cat, qt_org, qt_idx = [], [], [], [], []
    for s in range(S):
        sq_cat.append(np.concatenate(sinkq_buckets[s], axis=1)
                      if sinkq_buckets[s] else np.zeros((L, 0), U32))
        sinkq_buckets[s] = None
        rt_cat.append(np.concatenate(reftk_buckets[s], axis=1)
                      if reftk_buckets[s] else np.zeros((L, 0), U32))
        reftk_buckets[s] = None
        qt_cat.append(np.concatenate([p for p, _, _ in srcq_buckets[s]],
                                     axis=1)
                      if srcq_buckets[s] else np.zeros((L, 0), U32))
        qt_org.append(np.concatenate([o for _, o, _ in srcq_buckets[s]])
                      if srcq_buckets[s] else np.zeros(0, np.int32))
        qt_idx.append(np.concatenate([i for _, _, i in srcq_buckets[s]])
                      if srcq_buckets[s] else np.zeros(0, np.int64))
        srcq_buckets[s] = None
    kcap = bc._bucket(max(max(x.shape[1] for x in shard_lanes), 1))
    sq_cap = bc._bucket(max(max(x.shape[1] for x in sq_cat), 1))
    rcap = bc._bucket(max(max(x.shape[1] for x in rt_cat), 1))
    qt_cap = bc._bucket(max(max(x.shape[1] for x in qt_cat), 1))
    log(f"pass3 caps: keys={kcap} sinkq={sq_cap} ref={rcap} srcq={qt_cap}")
    for s in range(S):
        real = shard_lanes[s]
        n_keys = real.shape[1]
        keys = h_node_key(real, B) if n_keys else np.zeros((L, 0), U32)
        # sinks
        qs = sq_cat[s]
        n_q = qs.shape[1]
        if n_q:
            sinks_d, n_out = _sink_join_jit(
                jnp.asarray(_pad_lanes_np(keys, kcap)), jnp.int32(n_keys),
                jnp.asarray(_pad_lanes_np(qs, sq_cap)), jnp.int32(n_q),
                B, sq_cap)
            n_sinks = int(n_out)
            assert n_sinks <= sq_cap
            sink_edges[s] = _d2h_tight(sinks_d, n_sinks)
        # sources
        if qt_cat[s].shape[1]:
            qtk = qt_cat[s]
            qorg = qt_org[s]
            qidx = qt_idx[s]
            rtk = rt_cat[s]
            verd = np.asarray(_src_join_jit(
                jnp.asarray(_pad_lanes_np(rtk, rcap)),
                jnp.int32(rtk.shape[1]),
                jnp.asarray(_pad_lanes_np(qtk, qt_cap)),
                jnp.int32(qtk.shape[1])))[:qtk.shape[1]]
            for o in np.unique(qorg):
                m = qorg == o
                verdicts_by_origin[int(o)].append((qidx[m], verd[m]))
    del sq_cat, rt_cat, qt_cat, qt_org, qt_idx
    log("pass3: membership joins done")

    # ---- host: route dummy-1 sources home, then iterate levels -------------
    for s in range(S):
        real = shard_lanes[s]
        if not verdicts_by_origin[s]:
            continue
        keep_idx = np.concatenate(
            [i[v] for i, v in verdicts_by_origin[s]])
        if not len(keep_idx):
            continue
        prev = h_to_prev(real[:, np.sort(keep_idx)], K, B)
        for d, (piece,) in enumerate(
                _bucket_by_owner(prev, h_owner(prev, splitters, B), S)):
            if piece.shape[1]:
                src_home[d].append(piece)

    def host_sort(x: np.ndarray) -> np.ndarray:
        return x[:, np.argsort(_rec(x), kind="stable")]

    src_edges = [host_sort(np.concatenate(p, axis=1)) if p
                 else np.zeros((L, 0), U32) for p in src_home]
    level_edges: List[List[np.ndarray]] = [[] for _ in range(S)]
    cur = [s.copy() for s in src_edges]
    for _lvl in range(max(K - 2, 0)):
        if all(c.shape[1] == 0 for c in cur):
            break
        nxt_buckets: List[List[np.ndarray]] = [[] for _ in range(S)]
        for s in range(S):
            c = cur[s]
            if c.shape[1] == 0:
                continue
            nk = h_node_key(c, B)
            node_first = np.concatenate(
                [[True], (nk[:, 1:] != nk[:, :-1]).any(axis=0)])
            nxt = h_to_prev(c[:, node_first], K, B)
            for d, (piece,) in enumerate(
                    _bucket_by_owner(nxt, h_owner(nxt, splitters, B), S)):
                if piece.shape[1]:
                    nxt_buckets[d].append(piece)
        cur = [host_sort(np.concatenate(p, axis=1)) if p
               else np.zeros((L, 0), U32) for p in nxt_buckets]
        for s in range(S):
            if cur[s].shape[1]:
                level_edges[s].append(cur[s])
    n_dummy = (sum(x.shape[1] for x in sink_edges)
               + sum(x.shape[1] for x in src_edges)
               + sum(x.shape[1] for lv in level_edges for x in lv))
    log(f"dummies: {n_dummy} total")

    # ---- pass 4: per-shard merge + emit (uniform caps again) ---------------
    cap4 = bc._bucket(max(max(x.shape[1] for x in shard_lanes), 1))
    cap4_d = bc._bucket(max([1024] + [x.shape[1] for x in sink_edges]
                            + [x.shape[1] for x in src_edges]), lo=1024)
    cap4_lev = bc._bucket(max([1024] + [sum(x.shape[1] for x in lv)
                               for lv in level_edges]), lo=1024)
    W_parts, last_parts, weight_parts, kept_parts = [], [], [], []
    valid_parts = []
    hist_sum = np.zeros(alphabet.size, np.int64)
    for s in range(S):
        real = shard_lanes[s]
        counts = shard_counts[s]
        n_real = real.shape[1]
        sinks = sink_edges[s]
        src = src_edges[s]
        levels = (np.concatenate(level_edges[s], axis=1)
                  if level_edges[s] else np.zeros((L, 0), U32))
        with_sentinel = (s == 0)
        if n_real == 0 and sinks.shape[1] == 0 and src.shape[1] == 0 \
                and levels.shape[1] == 0 and not with_sentinel:
            continue
        cap = cap4
        cap_d = cap4_d
        lev_cap = cap4_lev
        if counts is None:
            counts_in = jnp.zeros(cap, jnp.int32)
        else:
            counts_in = jnp.asarray(np.concatenate(
                [counts, np.zeros(cap - n_real, np.int32)]))
        kept, n_kept_d, W, last, hist, weights, vreal = _emit_hist_jit(
            jnp.asarray(_pad_lanes_np(real, cap)),
            counts_in,
            jnp.int32(n_real),
            jnp.asarray(_pad_lanes_np(sinks, cap_d)),
            jnp.int32(sinks.shape[1]),
            jnp.asarray(_pad_lanes_np(src, cap_d)),
            jnp.int32(src.shape[1]),
            jnp.asarray(_pad_lanes_np(levels, lev_cap)),
            jnp.int32(levels.shape[1]),
            K, B, alphabet.size, max_count, with_sentinel)
        n_kept = int(n_kept_d)
        W_parts.append(np.asarray(W[:n_kept]))
        last_parts.append(np.asarray(last[:n_kept]))
        weight_parts.append(np.asarray(weights[:n_kept]))
        valid_parts.append(np.asarray(vreal[:n_kept]))
        hist_sum += np.asarray(hist).astype(np.int64)
        if keep_kmer_index:
            kept_parts.append(_d2h_tight(kept, n_kept))
        shard_lanes[s] = None          # free as we go
        shard_counts[s] = None

    W_all = np.concatenate(W_parts)
    last_all = np.concatenate(last_parts)
    weights_all = np.concatenate(weight_parts)
    n_kept_total = len(W_all)
    F = np.concatenate([[0], np.cumsum(hist_sum)[:-1]]).astype(np.int32)
    log(f"emit: {n_kept_total} edges")

    # ---- final assembly -----------------------------------------------------
    cap = bc._bucket(n_kept_total)
    W_pad = np.zeros(cap, np.int32)
    W_pad[:n_kept_total] = W_all
    last_pad = np.zeros(cap, bool)
    last_pad[:n_kept_total] = last_all
    wt_pad = np.zeros(cap, np.int32)
    wt_pad[:n_kept_total] = weights_all
    lut = max_bucket = None
    if keep_kmer_index:
        kept_np = np.full((L, cap), packed.PAD_LANE, U32)
        kept_np[:, :n_kept_total] = np.concatenate(kept_parts, axis=1)
        kept_d = jnp.asarray(kept_np)
        top = (kept_d[0] >> 16).astype(jnp.uint32)
        lut = jnp.searchsorted(top, jnp.arange(1 << 16, dtype=jnp.uint32),
                               side="left").astype(jnp.int32)
        lut = jnp.minimum(jnp.concatenate(
            [lut, jnp.full((1,), cap, jnp.int32)]), n_kept_total)
        max_bucket = int(np.asarray(jnp.max(jnp.diff(lut))))
    else:
        kept_d = jnp.zeros((L, 8), jnp.uint32)   # unused (with_lanes=False)
    boss = Boss.from_finish(
        k=K - 1, alph_size=alphabet.size, bits_per_char=B,
        kept=kept_d, W=jnp.asarray(W_pad), last=jnp.asarray(last_pad),
        F=jnp.asarray(F), n_kept=n_kept_total,
        weights=jnp.asarray(wt_pad) if bits_per_count else None,
        keep_kmer_index=keep_kmer_index, lut=lut, max_bucket=max_bucket)
    if return_valid:
        # (n_kept+1,) real-edge mask incl. the leading sentinel row —
        # exactly what DbgSuccinct.from_boss(valid=...) expects for
        # small-state graphs
        valid_all = np.concatenate(
            [np.zeros(1, bool)] + valid_parts) if valid_parts \
            else np.zeros(1, bool)
        return boss, valid_all
    return boss


def merge_boss_graphs_out_of_core(graphs, n_shards: int = 8,
                                  bits_per_count: int = 0,
                                  keep_kmer_index: bool = False,
                                  tmp_dir: Optional[str] = None,
                                  verbose: bool = False,
                                  return_valid: bool = False):
    """Streaming multi-BOSS merge (reference boss_merge.cpp:125-300):
    each serialized graph's REAL edge k-mers are already a sorted run
    (edge_lanes is the kept BOSS order; the valid mask drops dummies),
    so merging graphs is exactly the out-of-core finish over those runs
    — duplicate k-mers sum their weights, dummies are regenerated, and
    no k-mer is ever re-extracted from sequences. Device working set is
    O(total / n_shards): two 1B-edge graphs merge on one chip."""
    g0 = graphs[0]
    K = g0.k
    alphabet = g0.alphabet
    weighted = all(g.boss.weights is not None for g in graphs)
    runs = []
    for g in graphs:
        assert g.k == K, "merge inputs must share k"
        lanes = np.asarray(g.boss.edge_lanes)
        assert lanes is not None, \
            "streaming merge needs fast-state inputs (packed edge index)"
        valid = np.asarray(g.valid_rank.bits_host())[1:lanes.shape[1] + 1] \
            .astype(bool)
        w = (np.asarray(g.boss.weights)[1:lanes.shape[1] + 1] if weighted
             else np.ones(lanes.shape[1], np.int32))
        runs.append((lanes[:, valid],
                     np.asarray(w)[valid].astype(np.int32)))
    return build_boss_out_of_core(
        (), K, alphabet, n_shards=n_shards,
        bits_per_count=bits_per_count if not weighted else 31,
        keep_kmer_index=keep_kmer_index, tmp_dir=tmp_dir,
        verbose=verbose, return_valid=return_valid, runs=runs)
