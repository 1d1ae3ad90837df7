"""Multi-chip distribution: mesh setup + sharded build/query steps.

The device-mesh replacement for the reference's process-level sharding
(SURVEY §2.9): the k-mer space partition that the reference implements as
Σ^s separate passes + chunk files (cli/build.cpp:103-155) becomes a
device-mesh axis with an ``all_to_all`` exchange (MoE-style bucket
routing), and per-label annotation parallelism (annotate.cpp:469) becomes
column sharding with an ``all_gather`` of per-shard label counts.

All steps are written with ``shard_map`` over an explicit Mesh so the
same code runs on the GPUs of one host (NCCL collectives over NVLink) or
on the virtual CPU mesh used in tests and the multichip dry-run.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..common import packed
from ..kmer import packing
from ..kmer.alphabets import DNA
from ..kmer.extractor import extract_packed_kmers


def make_mesh(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def _owner_of(lanes: jax.Array, K: int, B: int, n_dev: int) -> jax.Array:
    """Shard owner of each k-mer: high bits of the node key, so shards are
    contiguous colex ranges (suffix sharding, SURVEY P4)."""
    top = packing.top_char(lanes, K, B)          # 1..4 for DNA
    second = packed.get_field(lanes, K - 2, B)
    bucket = (top - 1) * 4 + (second - 1)        # 0..15
    per = max(1, 16 // n_dev)
    return jnp.clip(bucket // per, 0, n_dev - 1).astype(jnp.int32)


def build_distributed_count_step(mesh: Mesh, K: int, B: int = 4,
                                 codes_per_device: int = 1 << 14,
                                 axis: str = "x"):
    """Returns a jitted step: (n_dev, codes_per_device) uint8 codes ->
    total distinct k-mers, computed by per-device extraction, all_to_all
    bucket routing, per-shard sort-unique, and a psum reduction.

    This is the inner step of the multi-chip graph build: the same
    exchange pattern scales to the full pipeline (counts ride along the
    routed k-mers; dummy generation queries route the same way).
    """
    n_dev = mesh.devices.size
    L = packing.lanes_for(K, B)
    cap = codes_per_device - K + 1
    per_dest = cap  # worst case: all k-mers to one destination

    def step(codes):
        # codes: (codes_per_device,) local slice
        lanes, count = extract_packed_kmers(codes, K, B)
        owner = _owner_of(lanes, K, B, n_dev)
        valid = packed.valid_mask(cap, count)
        # build per-destination send buffers (n_dev, L, per_dest)
        send = jnp.zeros((n_dev, L, per_dest), packed.LANE_DTYPE) \
            + packed.PAD_LANE
        for d in range(n_dev):
            m = valid & (owner == d)
            comp, _, _ = packed.compact(lanes, m, per_dest)
            send = send.at[d].set(comp)
        # exchange: dimension 0 is the destination axis
        recv = jax.lax.all_to_all(send, axis, 0, 0, tiled=False)
        # recv: (n_dev, L, per_dest) — flatten sources
        mine = recv.transpose(1, 0, 2).reshape(L, n_dev * per_dest)
        mine_s, _ = packed.sort(mine)
        not_pad = ~jnp.all(mine_s == packed.PAD_LANE, axis=0)
        uniq = packed.neighbor_ne(mine_s) & not_pad
        local_unique = jnp.sum(uniq.astype(jnp.int32))
        total = jax.lax.psum(local_unique, axis)
        return total, local_unique[None]

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=P(axis),
        out_specs=(P(), P(axis)),
        )

    @jax.jit
    def run(codes_all):
        # codes_all: (n_dev * codes_per_device,)
        return sharded(codes_all)

    return run


def build_distributed_collect_step(mesh: Mesh, K: int, B: int = 4,
                                   codes_per_device: int = 1 << 14,
                                   canonical: bool = False,
                                   complement=(0, 4, 3, 2, 1),
                                   axis: str = "x"):
    """Full distributed k-mer collection: returns per-shard sorted unique
    k-mers + counts, sharded over the mesh axis by colex bucket so that
    shard outputs concatenate into the globally sorted set.

    This is the multi-chip build front half (SURVEY §2.9 P4): dp extract
    -> all_to_all bucket routing -> per-shard sort-unique. The back half
    (dummy generation + emit) runs on the concatenated set.
    """
    n_dev = mesh.devices.size
    L = packing.lanes_for(K, B)
    cap = codes_per_device - K + 1
    per_dest = cap

    def step(codes):
        lanes, count = extract_packed_kmers(codes, K, B)
        if canonical:
            rc = packing.reverse_complement(lanes, K, B, complement)
            valid = packed.valid_mask(cap, count)
            take_rc = packed.lt(rc, lanes) & valid
            lanes = jnp.where(take_rc[None, :], rc, lanes)
        owner = _owner_of(lanes, K, B, n_dev)
        valid = packed.valid_mask(cap, count)
        send = jnp.zeros((n_dev, L, per_dest), packed.LANE_DTYPE) \
            + packed.PAD_LANE
        for d in range(n_dev):
            m = valid & (owner == d)
            comp, _, _ = packed.compact(lanes, m, per_dest)
            send = send.at[d].set(comp)
        recv = jax.lax.all_to_all(send, axis, 0, 0, tiled=False)
        mine = recv.transpose(1, 0, 2).reshape(L, n_dev * per_dest)
        counts = jnp.ones((mine.shape[1],), jnp.int32)
        # count PADs as invalid
        not_pad = ~jnp.all(mine == packed.PAD_LANE, axis=0)
        n_mine = jnp.sum(not_pad.astype(jnp.int32))
        mine = jnp.where(not_pad[None, :], mine,
                         packed.full_pad(mine.shape[1], L))
        mine_s, (counts_s,) = packed.sort(mine, counts)
        first = packed.neighbor_ne(mine_s)
        umask = first & packed.valid_mask(mine.shape[1], n_mine)
        seg = jnp.cumsum(umask.astype(jnp.int32)) - 1
        ucounts = jax.ops.segment_sum(
            jnp.where(packed.valid_mask(mine.shape[1], n_mine), counts_s, 0),
            seg, num_segments=mine.shape[1])
        ulanes, ucount, _ = packed.compact(mine_s, umask, mine.shape[1])
        return ulanes, ucounts.astype(jnp.int32), ucount[None]

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=P(axis),
        out_specs=(P(None, axis), P(axis), P(axis)),
        )
    return jax.jit(sharded)


def build_boss_distributed(seqs, k: int, mesh: Mesh,
                           alphabet=None, mode: str = "basic",
                           bits_per_count: int = 0):
    """End-to-end multi-device build: distributed collection over the mesh
    (extract + all_to_all + per-shard sort-unique), then host-side shard
    concatenation in bucket order and the standard finish stage.

    Shards are contiguous colex ranges (see _owner_of), so concatenating
    shard outputs in device order yields the globally sorted set."""
    from ..kmer.alphabets import DNA, INVALID_CODE
    from ..graph.boss_construct import _bucket, build_boss_from_kmers
    alphabet = alphabet or DNA
    B = alphabet.bits_per_char
    n_dev = mesh.devices.size
    canonical = mode in ("canonical", "primary")
    tbl = alphabet.encode_table()
    # pack input into equal per-device code slabs
    total = sum(len(s) + 1 for s in seqs)
    per_dev = _bucket(-(-total // n_dev) + 64, lo=1 << 12)
    codes = np.full((n_dev, per_dev), INVALID_CODE, np.uint8)
    d, off = 0, 0
    for s in seqs:
        cs = tbl[np.frombuffer(bytes(s), np.uint8)]
        if off + len(cs) + 1 > per_dev:
            d += 1
            off = 0
            assert d < n_dev, "input exceeds per-device slabs"
        codes[d, off:off + len(cs)] = cs
        off += len(cs) + 1
    step = build_distributed_collect_step(
        mesh, k, B, codes_per_device=per_dev, canonical=canonical,
        complement=alphabet.complement)
    ulanes, ucounts, ucnts = step(jnp.asarray(codes.reshape(-1)))
    # each shard's output block is n_dev*cap wide; valid entries form the
    # prefix; blocks concatenate in colex-bucket (= device) order
    cap = per_dev - k + 1
    shard_w = n_dev * cap
    n_per = np.asarray(ucnts).reshape(-1)
    parts, cparts = [], []
    for d in range(n_dev):
        n = int(n_per[d])
        parts.append(ulanes[:, d * shard_w:d * shard_w + n])
        cparts.append(ucounts[d * shard_w:d * shard_w + n])
    real = jnp.concatenate(parts, axis=1)
    counts = jnp.concatenate(cparts)
    return build_boss_from_kmers(
        real, counts, int(real.shape[1]), k, alphabet,
        mode="canonical" if mode == "canonical" else "basic",
        bits_per_count=bits_per_count)


# ---------------------------------------------------------------------------
# fully sharded build: splitter routing + per-shard finish
# ---------------------------------------------------------------------------

def group_key(lanes: jax.Array, B: int) -> jax.Array:
    """Suffix-group key: the edge k-mer with the label (field 0) and the
    first node char (field 1) zeroed. All edges of a node — and all edges
    sharing a (target node, label) pair — share one group key, so
    splitters aligned to group boundaries keep the emit stage's
    last-bit, redundant-sink and minus-flag logic shard-local."""
    z = jnp.zeros((lanes.shape[1],), jnp.uint32)
    out = packed.set_field(lanes, 0, z, B)
    return packed.set_field(out, 1, z, B)


def sample_splitters(seqs, k: int, n_dev: int, alphabet=None,
                     sample: int = 8192, seed: int = 0) -> np.ndarray:
    """(L, n_dev - 1) sorted splitter group keys from a host-side k-mer
    sample (the reference's fixed suffix buckets, build.cpp:103-155,
    replaced by sample-based balanced splitters)."""
    alphabet = alphabet or DNA
    B = alphabet.bits_per_char
    K = k
    L = packing.lanes_for(K, B)
    tbl = alphabet.encode_table()
    rng = np.random.default_rng(seed)
    windows = []
    budget = max(sample // max(len(seqs), 1), 8)
    for s in seqs:
        cs = tbl[np.frombuffer(bytes(s), np.uint8)]
        n = len(cs) - K + 1
        if n <= 0:
            continue
        take = min(n, budget)
        starts = rng.choice(n, size=take, replace=False) if n > take \
            else np.arange(n)
        for st in starts:
            w = cs[st:st + K]
            if (w == 255).any():
                continue
            windows.append(w)
    if not windows:
        return np.zeros((L, max(n_dev - 1, 1)), np.uint32)
    chars = np.stack(windows)
    lanes = np.asarray(packing.pack_from_chars(jnp.asarray(chars), K, B))
    gk = np.asarray(group_key(jnp.asarray(lanes), B))
    # sort group keys as big-endian tuples and pick n_dev-1 quantiles
    order = np.lexsort(tuple(gk[j] for j in range(L - 1, -1, -1)))
    gs = gk[:, order]
    qs = [gs[:, (i * gs.shape[1]) // n_dev] for i in range(1, n_dev)]
    if not qs:
        return np.zeros((L, 0), np.uint32)
    return np.stack(qs, axis=1)


def _owner_split(lanes: jax.Array, splitters: jax.Array, B: int,
                 n_dev: int) -> jax.Array:
    """Shard owner by splitter group keys (colex-contiguous shards).
    Unrolled comparisons (n_dev - 1 splitters) — loop-free so it traces
    cleanly inside shard_map."""
    if splitters.shape[1] == 0:
        return jnp.zeros((lanes.shape[1],), jnp.int32)
    gk = group_key(lanes, B)
    owner = jnp.zeros((lanes.shape[1],), jnp.int32)
    for j in range(splitters.shape[1]):
        sj = jnp.broadcast_to(splitters[:, j:j + 1], gk.shape)
        owner = owner + (~packed.lt(gk, sj)).astype(jnp.int32)
    return jnp.clip(owner, 0, n_dev - 1)


def build_distributed_full_step(mesh: Mesh, K: int, B: int = 4,
                                cap: int = 1 << 14, per: int = 1 << 12,
                                alph_size: int = 5, max_count: int = 0,
                                canonical: bool = False,
                                complement=(0, 4, 3, 2, 1),
                                axis: str = "x"):
    """The fully sharded finish (SURVEY P4/P5; replaces the round-1
    single-device back half): given per-shard sorted unique real k-mers
    (already splitter-routed), run rc closure, dummy sink/source
    generation with all_to_all joins, all dummy levels, and the W/last/F
    emit — each shard producing its colex slice, bit-identical to the
    single-device build after concatenation.

    Returns a jitted step: (real (n_dev*L, cap) interleaved? no —
    sharded (L, n_dev*cap)), counts, n, splitters -> per-shard outputs.
    ``per``: all_to_all route buffer capacity per destination; true
    counts are returned so the host can retry on overflow."""
    n_dev = mesh.devices.size
    L = packing.lanes_for(K, B)

    def route(lanes, mask, *extras, tkey=False):
        """all_to_all by owner; returns (lanes (L, n_dev*per),
        extras..., max_send (overflow check)).

        ``tkey=True``: the lanes are target keys (label@0, node chars
        at slots 1..K-2, top field ZERO). Routing them raw compares
        below every splitter — all traffic lands on device 0. Shift
        one field left so the node chars align with the edge group-key
        bit positions the splitters were sampled from; both join sides
        route through the same transform, so the join stays exact."""
        okey = packed.shift_left(lanes, B) if tkey else lanes
        owner = _owner_split(okey, _route_splitters[0], B, n_dev)
        send = packed.full_pad(n_dev * per, L).reshape(L, n_dev, per) \
            .transpose(1, 0, 2)
        send_e = [jnp.zeros((n_dev, per), e.dtype) for e in extras]
        max_send = jnp.int32(0)
        for d in range(n_dev):
            m = mask & (owner == d)
            comp, nc, ce = packed.compact(lanes, m, per, *extras)
            send = send.at[d].set(comp)
            for i, c in enumerate(ce):
                send_e[i] = send_e[i].at[d].set(c)
            max_send = jnp.maximum(max_send, nc)
        recv = jax.lax.all_to_all(send, axis, 0, 0, tiled=False)
        flat = recv.transpose(1, 0, 2).reshape(L, n_dev * per)
        out_e = []
        for se in send_e:
            re_ = jax.lax.all_to_all(se, axis, 0, 0, tiled=False)
            out_e.append(re_.reshape(-1))
        return flat, out_e, max_send

    _route_splitters = []  # bound per call below (closure cell)

    def _emit_local(merged, mcounts, n_total, K, B, alph_size, max_count):
        """_emit_body, but returning the raw top-char histogram so F can
        be psum'ed globally across shards."""
        from ..graph.boss_construct import _emit_body
        kept, n_kept, W, last, _F_local, weights = _emit_body(
            merged, mcounts, n_total, K, B, alph_size, max_count)
        kvalid = packed.valid_mask(kept.shape[1], n_kept)
        tc = jnp.where(kvalid, packing.top_char(kept, K, B), alph_size)
        hist = jnp.stack([jnp.sum((tc == c).astype(jnp.int32))
                          for c in range(alph_size)])
        return kept, n_kept, W, last, hist, weights

    def finish_shard(real, counts, n_arr, splitters):
        _route_splitters.clear()
        _route_splitters.append(splitters)
        n_real = n_arr[0]
        my = jax.lax.axis_index(axis)
        overflow = jnp.int32(0)
        valid = packed.valid_mask(cap, n_real)
        real = jnp.where(valid[None, :], real, packed.full_pad(cap, L))
        counts = jnp.where(valid, counts, 0)
        # 1) canonical rc closure: route reverse complements
        if canonical:
            rc = packing.reverse_complement(real, K, B, complement)
            pal = packed.eq(rc, real) & valid
            counts = jnp.where(pal, counts * 2, counts)
            rc_flat, (rc_counts,), ov = route(rc, valid & ~pal, counts)
            overflow = jnp.maximum(overflow, ov)
            not_pad = ~jnp.all(rc_flat == packed.PAD_LANE, axis=0)
            merged = jnp.concatenate([real, rc_flat], axis=1)
            mcounts = jnp.concatenate(
                [counts, jnp.where(not_pad, rc_counts, 0)])
            merged, (mcounts,) = packed.sort(merged, mcounts)
            n_real = n_real + jnp.sum(not_pad.astype(jnp.int32))
            real = merged[:, :cap + n_dev * per]
            counts = mcounts[:cap + n_dev * per]
            valid = packed.valid_mask(real.shape[1], n_real)
        capL = real.shape[1]
        # 2) dummy sinks: route shifted k-mers to their owner, check
        #    membership against the owner's real node keys
        shifted = packing.to_next(real, K, B, 0)
        cand_flat, _, ov = route(shifted, valid)
        overflow = jnp.maximum(overflow, ov)
        cnp = ~jnp.all(cand_flat == packed.PAD_LANE, axis=0)
        real_nodes = jnp.where(valid[None, :], packing.node_key(real, B),
                               packed.full_pad(capL, L))
        q_nodes = jnp.where(cnp[None, :], packing.node_key(cand_flat, B),
                            packed.full_pad(cand_flat.shape[1], L))
        present = packed.isin_merge(real_nodes, q_nodes)
        keep = cnp & ~present
        cand, n_sink_cand, _ = packed.compact(cand_flat, keep,
                                              cand_flat.shape[1])
        cand_s, _ = packed.sort(cand)
        first = packed.neighbor_ne(cand_s) & packed.valid_mask(
            cand_s.shape[1], n_sink_cand)
        sinks, n_sinks, _ = packed.compact(cand_s, first, cand_s.shape[1])
        # 3) dummy-1 sources: local candidates, all_to_all tkey join for
        #    the has-incoming filter, then route survivors home
        node_first = packed.neighbor_ne(real_nodes) & valid
        prev = packing.to_prev(real, K, B, 0)
        ref_tk = jnp.where(valid[None, :], packing.target_key(real, B),
                           packed.full_pad(capL, L))
        q_tk = packing.target_key(prev, B)
        # join shard = owner of the tkey (same function both sides)
        ref_flat, _, ov1 = route(ref_tk, valid, tkey=True)
        q_flat, (q_src_idx,), ov2 = route(
            q_tk, node_first,
            jnp.arange(capL, dtype=jnp.int32), tkey=True)
        overflow = jnp.maximum(overflow, jnp.maximum(ov1, ov2))
        qnp = ~jnp.all(q_flat == packed.PAD_LANE, axis=0)
        rnp = ~jnp.all(ref_flat == packed.PAD_LANE, axis=0)
        ref_m = jnp.where(rnp[None, :], ref_flat,
                          packed.full_pad(ref_flat.shape[1], L))
        has_inc = packed.isin_merge(ref_m, q_flat) & qnp
        # answers: survivors (no incoming) -> fetch their prev lanes.
        # q_src_idx came along; send the verdict back by routing
        # (verdict, src_idx) to the ORIGIN shard: origin = slot / per
        slot = jnp.arange(n_dev * per, dtype=jnp.int32)
        # all_to_all back: reshape (n_dev, per) — entry groups map back
        verd = (qnp & ~has_inc).astype(jnp.int32).reshape(n_dev, per)
        idx_back = q_src_idx.reshape(n_dev, per)
        verd_home = jax.lax.all_to_all(verd, axis, 0, 0,
                                       tiled=False).reshape(-1)
        idx_home = jax.lax.all_to_all(idx_back, axis, 0, 0,
                                      tiled=False).reshape(-1)
        keep_src = jnp.zeros((capL,), bool)
        keep_src = keep_src.at[jnp.where(verd_home == 1, idx_home,
                                         capL)].set(True, mode="drop")
        src_flat, _, ov = route(prev, keep_src & node_first)
        overflow = jnp.maximum(overflow, ov)
        snp = ~jnp.all(src_flat == packed.PAD_LANE, axis=0)
        src, _ = packed.sort(src_flat)
        n_src = jnp.sum(snp.astype(jnp.int32))
        # 4) dummy levels 2..K-1 with per-level routing
        #    (a loop, not unrolled: one level body in the program instead
        #    of K-2 copies keeps the step's compile time flat in K)
        lev_cap = src.shape[1]
        n_levels = max(K - 2, 0)

        def level(li, carry):
            levels, cur, n_cur, total_levels, overflow = carry
            v = packed.valid_mask(lev_cap, n_cur)
            nf = packed.neighbor_ne(packing.node_key(cur, B)) & v
            nxt = packing.to_prev(cur, K, B, 0)
            nxt_flat, _, ov = route(nxt, nf)
            nnp_ = ~jnp.all(nxt_flat == packed.PAD_LANE, axis=0)
            nxt_s, _ = packed.sort(nxt_flat)
            n_nxt = jnp.sum(nnp_.astype(jnp.int32))
            lvl, _, _ = packed.compact(
                nxt_s, packed.valid_mask(nxt_s.shape[1], n_nxt), lev_cap)
            levels = jax.lax.dynamic_update_slice(levels, lvl,
                                                  (0, li * lev_cap))
            return (levels, lvl, jnp.minimum(n_nxt, lev_cap),
                    total_levels + n_nxt, jnp.maximum(overflow, ov))

        # the fresh buffers become per-shard values inside the loop
        levels0, total0 = jax.lax.pcast(
            (packed.full_pad(max(n_levels, 1) * lev_cap, L), jnp.int32(0)),
            (axis,), to="varying")
        levels, _, _, total_levels, overflow = jax.lax.fori_loop(
            0, n_levels, level, (levels0, src, n_src, total0, overflow))
        # 5) local merge + emit (shard 0 adds the $^K sentinel row)
        zero_row = packed.zeros(1, L)
        zero_valid = (my == 0)
        parts = [real, sinks, src, levels,
                 jnp.where(zero_valid, zero_row,
                           packed.full_pad(1, L))]
        cparts = [counts] + [jnp.zeros((p.shape[1],), jnp.int32)
                             for p in parts[1:]]
        merged = jnp.concatenate(parts, axis=1)
        mcounts = jnp.concatenate(cparts)
        merged, (mcounts,) = packed.sort(merged, mcounts)
        n_total = (n_real + n_sinks + n_src + total_levels
                   + zero_valid.astype(jnp.int32))
        kept, n_kept, W, last, F_hist_local, weights = _emit_local(
            merged, mcounts, n_total, K, B, alph_size, max_count)
        # F: global histogram of top chars
        F_hist = jax.lax.psum(F_hist_local, axis)
        F = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                             jnp.cumsum(F_hist)[:-1].astype(jnp.int32)])
        stats = jnp.stack([n_kept, overflow, n_sink_cand, n_src,
                           total_levels])
        return (kept, W, last.astype(jnp.uint8), weights, F, stats,
                n_kept[None])

    sharded = shard_map(
        finish_shard, mesh=mesh,
        in_specs=(P(None, axis), P(axis), P(axis), P()),
        out_specs=(P(None, axis), P(axis), P(axis), P(axis), P(),
                   P(axis), P(axis)),
        )
    return jax.jit(sharded)


def build_boss_distributed_full(seqs, k: int, mesh: Mesh,
                                alphabet=None, mode: str = "basic",
                                bits_per_count: int = 0):
    """End-to-end multi-device build with the finish stage sharded too:
    collection routes by sample-based splitters; rc closure, dummy
    generation, levels and the W/last/F emit all run per shard with
    all_to_all joins. Bit-identical to the
    single-device build after shard concatenation."""
    from ..kmer.alphabets import DNA, INVALID_CODE
    from ..graph.boss_construct import _bucket
    from ..graph.boss import Boss
    alphabet = alphabet or DNA
    B = alphabet.bits_per_char
    n_dev = mesh.devices.size
    canonical = mode in ("canonical", "primary")
    K = k
    L = packing.lanes_for(K, B)
    splitters = sample_splitters(seqs, K, n_dev, alphabet)
    tbl = alphabet.encode_table()
    total = sum(len(s) + 1 for s in seqs)
    per_dev = _bucket(-(-total // n_dev) + 64, lo=1 << 12)
    codes = np.full((n_dev, per_dev), INVALID_CODE, np.uint8)
    d, off = 0, 0
    for s in seqs:
        cs = tbl[np.frombuffer(bytes(s), np.uint8)]
        if off + len(cs) + 1 > per_dev:
            d += 1
            off = 0
            assert d < n_dev, "input exceeds per-device slabs"
        codes[d, off:off + len(cs)] = cs
        off += len(cs) + 1
    # size all_to_all buffers from the measured routing histogram
    hist_step = route_histogram_step(mesh, K, B, per_dev, canonical,
                                     alphabet.complement)
    hist = np.asarray(hist_step(jnp.asarray(codes.reshape(-1)),
                                jnp.asarray(splitters))).reshape(n_dev,
                                                                 n_dev)
    per_dest = _bucket(max(int(hist.max()), 64))
    # collection with splitter routing (canonical forms routed in
    # canonical mode; rc closure happens sharded in the finish)
    collect = _collect_with_splitters(mesh, K, B, per_dev, canonical,
                                      alphabet.complement,
                                      per_dest=per_dest)
    ulanes, ucounts, ucnts = collect(jnp.asarray(codes.reshape(-1)),
                                     jnp.asarray(splitters))
    shard_w = n_dev * per_dest
    n_per = np.asarray(ucnts).reshape(-1)
    # repack each shard's prefix into a common power-of-two capacity
    cap2 = _bucket(int(n_per.max()) * (2 if canonical else 1) + 4)
    real = np.full((L, n_dev * cap2), int(packed.PAD_LANE), np.uint32)
    cnts = np.zeros((n_dev * cap2,), np.int32)
    ul = np.asarray(ulanes)
    uc = np.asarray(ucounts)
    for dd in range(n_dev):
        n = int(n_per[dd])
        real[:, dd * cap2:dd * cap2 + n] = ul[:, dd * shard_w:dd * shard_w + n]
        cnts[dd * cap2:dd * cap2 + n] = uc[dd * shard_w:dd * shard_w + n]
    n_arr = n_per.astype(np.int32)
    per = _bucket(max(int(n_per.max()), 64))
    mc = (1 << bits_per_count) - 1 if bits_per_count else (1 << 31) - 1
    while True:
        step = build_distributed_full_step(
            mesh, K, B, cap=cap2, per=per, alph_size=alphabet.size,
            max_count=mc, canonical=canonical,
            complement=alphabet.complement)
        kept, W, last, weights, F, stats, n_kepts = step(
            jnp.asarray(real), jnp.asarray(cnts), jnp.asarray(n_arr),
            jnp.asarray(splitters))
        stats_np = np.asarray(stats).reshape(n_dev, -1)
        need = int(stats_np[:, 1].max())
        if need <= per:
            break
        per = _bucket(need)  # route overflow: retry with bigger buffers
    # host concat of shard slices
    n_k = np.asarray(n_kepts).reshape(-1)
    kept_np = np.asarray(kept)
    W_np = np.asarray(W)
    last_np = np.asarray(last)
    wt_np = np.asarray(weights)
    piece = kept_np.shape[1] // n_dev
    parts_l, parts_W, parts_last, parts_wt = [], [], [], []
    for dd in range(n_dev):
        n = int(n_k[dd])
        parts_l.append(kept_np[:, dd * piece:dd * piece + n])
        parts_W.append(W_np[dd * piece:dd * piece + n])
        parts_last.append(last_np[dd * piece:dd * piece + n])
        parts_wt.append(wt_np[dd * piece:dd * piece + n])
    lanes_all = np.concatenate(parts_l, axis=1)
    # the logical arrays carry a leading sentinel row 0 (W[0] = 0),
    # matching build_boss_from_kmers
    W_all = np.concatenate([np.zeros(1, np.int32)] + parts_W)
    last_all = np.concatenate([np.zeros(1, bool)]
                              + [p.astype(bool) for p in parts_last])
    wt_all = np.concatenate([np.zeros(1, np.int32)] + parts_wt)
    F_np = np.asarray(F)[:alphabet.size]
    return Boss.from_arrays(
        k=K - 1, alph_size=alphabet.size, bits_per_char=B,
        W=jnp.asarray(W_all), last=jnp.asarray(last_all),
        F=jnp.asarray(F_np),
        edge_lanes=jnp.asarray(lanes_all),
        weights=jnp.asarray(wt_all) if bits_per_count else None)


def route_histogram_step(mesh: Mesh, K: int, B: int,
                         codes_per_device: int, canonical: bool,
                         complement, axis: str = "x"):
    """Pre-pass: per-(device, destination) k-mer counts so the driver can
    size all_to_all buffers from the measured histogram instead of the
    worst case."""
    n_dev = mesh.devices.size
    cap = codes_per_device - K + 1

    def route_histogram(codes, splitters):
        lanes, count = extract_packed_kmers(codes, K, B)
        if canonical:
            rc = packing.reverse_complement(lanes, K, B, complement)
            valid = packed.valid_mask(cap, count)
            take_rc = packed.lt(rc, lanes) & valid
            lanes = jnp.where(take_rc[None, :], rc, lanes)
        owner = _owner_split(lanes, splitters, B, n_dev)
        valid = packed.valid_mask(cap, count)
        hist = jax.ops.segment_sum(
            valid.astype(jnp.int32),
            jnp.where(valid, owner, n_dev), num_segments=n_dev + 1)
        return hist[:n_dev]

    sharded = shard_map(route_histogram, mesh=mesh,
                        in_specs=(P(axis), P()), out_specs=P(axis))
    return jax.jit(sharded)


def _collect_with_splitters(mesh: Mesh, K: int, B: int,
                            codes_per_device: int, canonical: bool,
                            complement, axis: str = "x",
                            per_dest: Optional[int] = None):
    """Collection front half with sample-splitter routing (replaces the
    fixed 16-bucket _owner_of). ``per_dest`` sizes the all_to_all send
    buffers (from the measured histogram; worst case when None)."""
    n_dev = mesh.devices.size
    L = packing.lanes_for(K, B)
    cap = codes_per_device - K + 1
    per_dest = per_dest or cap

    def collect_routed(codes, splitters):
        lanes, count = extract_packed_kmers(codes, K, B)
        if canonical:
            rc = packing.reverse_complement(lanes, K, B, complement)
            valid = packed.valid_mask(cap, count)
            take_rc = packed.lt(rc, lanes) & valid
            lanes = jnp.where(take_rc[None, :], rc, lanes)
        owner = _owner_split(lanes, splitters, B, n_dev)
        valid = packed.valid_mask(cap, count)
        send = jnp.zeros((n_dev, L, per_dest), packed.LANE_DTYPE) \
            + packed.PAD_LANE
        for d in range(n_dev):
            m = valid & (owner == d)
            comp, _, _ = packed.compact(lanes, m, per_dest)
            send = send.at[d].set(comp)
        recv = jax.lax.all_to_all(send, axis, 0, 0, tiled=False)
        mine = recv.transpose(1, 0, 2).reshape(L, n_dev * per_dest)
        counts = jnp.ones((mine.shape[1],), jnp.int32)
        not_pad = ~jnp.all(mine == packed.PAD_LANE, axis=0)
        n_mine = jnp.sum(not_pad.astype(jnp.int32))
        mine = jnp.where(not_pad[None, :], mine,
                         packed.full_pad(mine.shape[1], L))
        mine_s, (counts_s,) = packed.sort(mine, counts)
        first = packed.neighbor_ne(mine_s)
        umask = first & packed.valid_mask(mine.shape[1], n_mine)
        seg = jnp.cumsum(umask.astype(jnp.int32)) - 1
        ucounts = jax.ops.segment_sum(
            jnp.where(packed.valid_mask(mine.shape[1], n_mine),
                      counts_s, 0),
            seg, num_segments=mine.shape[1])
        ulanes, ucount, _ = packed.compact(mine_s, umask, mine.shape[1])
        return ulanes, ucounts.astype(jnp.int32), ucount[None]

    sharded = shard_map(
        collect_routed, mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=(P(None, axis), P(axis), P(axis)),
        )
    return jax.jit(sharded)


def build_distributed_query_step(mesh: Mesh, num_rows: int, num_cols: int,
                                 nnz_cap: int, query_cap: int,
                                 axis: str = "x"):
    """Column-sharded annotation query step (SURVEY P8): the annotation
    matrix is sharded by label column across the mesh; each device
    computes counts for its label shard with a segment-sum and results
    are all_gather'ed."""
    n_dev = mesh.devices.size
    cols_per = -(-num_cols // n_dev)

    def step(rows_sh, cols_sh, query_rows, query_weights):
        # rows_sh/cols_sh: (nnz_cap,) local shard of COO pairs (padded with
        # row = num_rows which never matches queries)
        hits = jnp.zeros((query_rows.shape[0],), jnp.int32)
        # membership: for each local pair, weight if its row is queried
        pos = jnp.searchsorted(query_rows, rows_sh)
        posc = jnp.clip(pos, 0, query_rows.shape[0] - 1)
        match = query_rows[posc] == rows_sh
        w = jnp.where(match, query_weights[posc], 0)
        local_counts = jax.ops.segment_sum(
            w, jnp.clip(cols_sh, 0, cols_per - 1),
            num_segments=cols_per)
        return local_counts  # concatenated over shards by out_specs

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P()),
        out_specs=P(axis),
        )

    @jax.jit
    def run(rows_sh, cols_sh, query_rows, query_weights):
        counts = sharded(rows_sh, cols_sh, query_rows, query_weights)
        return counts[:num_cols]

    return run


def shard_annotation_coo(rows: np.ndarray, cols: np.ndarray, num_rows: int,
                         num_cols: int, n_dev: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: repartition COO pairs by column shard and pad so shard d
    owns slice d of equal size; local column ids are shard-relative."""
    cols_per = -(-num_cols // n_dev)
    owner = cols // cols_per
    per = max(int(np.bincount(owner, minlength=n_dev).max()), 1)
    out_rows = np.full((n_dev, per), num_rows, np.int32)    # pad: no match
    out_cols = np.full((n_dev, per), 0, np.int32)
    for d in range(n_dev):
        sel = owner == d
        n = int(sel.sum())
        out_rows[d, :n] = rows[sel]
        out_cols[d, :n] = cols[sel] - d * cols_per
    return out_rows.reshape(-1), out_cols.reshape(-1)
