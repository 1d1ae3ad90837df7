"""Streaming collection: host-RAM spill for inputs beyond HBM.

The reference bounds memory with SortedSetDisk: fill a RAM buffer, sort,
spill Elias-Fano chunks to disk, k-way-merge the chunks
(metagraph/src/common/sorted_sets/sorted_set_disk_base.hpp:34,
elias_fano_merger.hpp:188). The device analog uses host RAM as the spill
tier (and the OS page cache / files beyond that):

  input chunks -> device extract+sort+unique -> host chunk arrays ->
  host k-way merge (numpy mergesort of pre-sorted runs) ->
  device finish (dummies + emit) per suffix shard if needed

Each device pass works on a bounded window (``chunk_codes`` characters),
so HBM usage is constant regardless of input size; the merge is linear
in the output. Counts aggregate across chunks.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..common import packed
from ..graph.boss import Boss
from ..graph.boss_construct import (MODE_BASIC, MODE_CANONICAL, MODE_PRIMARY,
                                    _bucket, _collect_stage,
                                    build_boss_from_kmers)
from ..kmer import packing
from ..kmer.alphabets import Alphabet, DNA, INVALID_CODE
from ..kmer.extractor import encode_sequences


def _repack_bits(K: int, B: int, alph_size: int) -> int:
    """Narrowest spill width: real chars are 1..alph_size-1, stored as
    c-1 in B2 bits with B2 the smallest divisor of 32 that fits — DNA
    packs 2 bits/char (the reference's Elias-Fano spill role,
    elias_fano.hpp:165: ~2.4x fewer disk bytes than the working form);
    wider alphabets fall back to the working width."""
    need = max((alph_size - 2).bit_length(), 1)
    for b2 in (1, 2, 4, 8, 16):
        if b2 >= need:
            return b2 if b2 < B else B
    return B


def _pack_run(lanes: np.ndarray, K: int, B: int, B2: int) -> np.ndarray:
    """(L, n) working-form lanes -> (L2, n) compact lanes (c -> c-1 in
    B2-bit fields). Field order is preserved, and c -> c-1 is monotone,
    so colex ORDER is preserved: disk merges compare compact keys."""
    from ..parallel.outofcore import h_get_field
    n = lanes.shape[1]
    per = 32 // B2
    L2 = max(-(-K // per), 1)
    out = np.zeros((L2, n), np.uint32)
    for slot in range(K):
        c = (h_get_field(lanes, slot, B) - 1).astype(np.uint32)
        lane = L2 - 1 - (slot * B2) // 32
        out[lane] |= c << np.uint32((slot * B2) % 32)
    return out


def _unpack_run(packed_l: np.ndarray, K: int, B: int, B2: int) -> np.ndarray:
    """Inverse of _pack_run -> working-form (L, n) lanes."""
    n = packed_l.shape[1]
    L = packing.lanes_for(K, B)
    out = np.zeros((L, n), np.uint32)
    mask2 = np.uint32((1 << B2) - 1)
    for slot in range(K):
        lane2 = packed_l.shape[0] - 1 - (slot * B2) // 32
        c = ((packed_l[lane2] >> np.uint32((slot * B2) % 32)) & mask2) + 1
        lane = L - 1 - (slot * B) // 32
        out[lane] |= c.astype(np.uint32) << np.uint32((slot * B) % 32)
    return out


def _merge_sorted_chunks(chunks: List[Tuple[np.ndarray, np.ndarray]],
                         L: int) -> Tuple[np.ndarray, np.ndarray]:
    """K-way merge of sorted (lanes (L, n), counts (n,)) host chunks with
    duplicate aggregation. Uses numpy structured sort over concatenated
    runs (mergesort exploits pre-sorted runs)."""
    if not chunks:
        return np.zeros((L, 0), np.uint32), np.zeros((0,), np.int64)
    lanes = np.concatenate([c[0] for c in chunks], axis=1)
    counts = np.concatenate([c[1] for c in chunks]).astype(np.int64)
    # lexicographic order over lanes: use structured view for mergesort
    keys = np.rec.fromarrays([lanes[j] for j in range(L)])
    order = np.argsort(keys, kind="stable")  # timsort-ish on runs
    lanes = lanes[:, order]
    counts = counts[order]
    if lanes.shape[1] == 0:
        return lanes, counts
    first = np.concatenate([[True],
                            (lanes[:, 1:] != lanes[:, :-1]).any(axis=0)])
    group = np.cumsum(first) - 1
    agg = np.zeros(int(group[-1]) + 1, np.int64)
    np.add.at(agg, group, counts)
    return lanes[:, first], agg


# ---------------------------------------------------------------------------
# disk chunk tier (the SortedSetDisk role, sorted_set_disk_base.hpp:34)
# ---------------------------------------------------------------------------

class DiskChunkStore:
    """Sorted (lanes, counts) runs spilled to memory-mapped files in a
    swap directory, merged pairwise with bounded-memory block merges
    (the reference's Elias-Fano chunk files + k-way merger,
    elias_fano_merger.hpp:188 — npy memmaps instead of EF streams; the
    OS page cache does the buffering)."""

    def __init__(self, directory: str, L: int):
        import os
        import tempfile
        self.dir = tempfile.mkdtemp(prefix="mtg_swap_", dir=directory)
        self.L = L
        self._runs: List[Tuple[str, str, int]] = []
        self._seq = 0

    def spill(self, lanes: np.ndarray, counts: np.ndarray):
        """Write one sorted run to disk."""
        import os
        n = lanes.shape[1]
        lp = os.path.join(self.dir, f"run{self._seq}.lanes.npy")
        cp = os.path.join(self.dir, f"run{self._seq}.counts.npy")
        self._seq += 1
        np.save(lp, np.ascontiguousarray(lanes))
        np.save(cp, counts.astype(np.int64))
        self._runs.append((lp, cp, n))

    @property
    def num_runs(self) -> int:
        return len(self._runs)

    def _load(self, run):
        lp, cp, n = run
        return (np.load(lp, mmap_mode="r"), np.load(cp, mmap_mode="r"))

    def merge_all(self, block: int = 1 << 20) -> Tuple[np.ndarray, np.ndarray]:
        """Cascaded pairwise block merges; returns the final memmapped
        (lanes, counts). Peak host RAM is O(block), not O(total)."""
        import os
        while len(self._runs) > 1:
            nxt = []
            for i in range(0, len(self._runs), 2):
                if i + 1 == len(self._runs):
                    nxt.append(self._runs[i])
                    continue
                nxt.append(self._merge_two(self._runs[i],
                                           self._runs[i + 1], block))
                for lp, cp, _ in (self._runs[i], self._runs[i + 1]):
                    os.remove(lp)
                    os.remove(cp)
            self._runs = nxt
        if not self._runs:
            return (np.zeros((self.L, 0), np.uint32),
                    np.zeros((0,), np.int64))
        return self._load(self._runs[0])

    def _merge_two(self, ra, rb, block: int):
        """Bounded-memory merge of two sorted runs with count
        aggregation: per round, emit everything strictly below the
        smaller of the two block tails (equal keys held back so
        duplicate groups never straddle an emit boundary)."""
        import os
        a_l, a_c = self._load(ra)
        b_l, b_c = self._load(rb)
        na, nb = ra[2], rb[2]
        out_lp = os.path.join(self.dir, f"run{self._seq}.lanes.npy")
        out_cp = os.path.join(self.dir, f"run{self._seq}.counts.npy")
        self._seq += 1
        L = self.L
        out_l = np.lib.format.open_memmap(
            out_lp, mode="w+", dtype=np.uint32, shape=(L, na + nb))
        out_c = np.lib.format.open_memmap(
            out_cp, mode="w+", dtype=np.int64, shape=(na + nb,))

        def keyview(lanes):
            return np.rec.fromarrays([lanes[j] for j in range(L)])

        i = j = w = 0
        while i < na or j < nb:
            ab = np.asarray(a_l[:, i:i + block])
            bb = np.asarray(b_l[:, j:j + block])
            ac = np.asarray(a_c[i:i + block])
            bc = np.asarray(b_c[j:j + block])
            ka, kb = keyview(ab), keyview(bb)
            # emit boundary: the smaller block tail (exclusive), unless a
            # side is exhausted
            if len(ka) and len(kb):
                bound_t = min(tuple(ka[-1]), tuple(kb[-1]))
                bound = np.array([bound_t], dtype=ka.dtype)[0]
                last_round = (i + len(ka) >= na) and (j + len(kb) >= nb)
                side = "right" if last_round else "left"
                ta = np.searchsorted(ka, bound, side=side)
                tb = np.searchsorted(kb, bound, side=side)
            elif len(ka):
                ta, tb = len(ka), 0
            else:
                ta, tb = 0, len(kb)
            if ta == 0 and tb == 0:
                # all keys equal to bound and more blocks remain: widen
                block *= 2
                continue
            lanes = np.concatenate([ab[:, :ta], bb[:, :tb]], axis=1)
            counts = np.concatenate([ac[:ta], bc[:tb]])
            order = np.argsort(keyview(lanes), kind="stable")
            lanes = lanes[:, order]
            counts = counts[order]
            first = np.concatenate(
                [[True], (lanes[:, 1:] != lanes[:, :-1]).any(axis=0)])
            group = np.cumsum(first) - 1
            agg = np.zeros(int(group[-1]) + 1, np.int64)
            np.add.at(agg, group, counts)
            u = lanes[:, first]
            out_l[:, w:w + u.shape[1]] = u
            out_c[w:w + u.shape[1]] = agg
            w += u.shape[1]
            i += ta
            j += tb
        out_l.flush()
        out_c.flush()
        # shrink to actual size via a header rewrite (reopen sliced)
        final_l = np.load(out_lp, mmap_mode="r")[:, :w]
        final_c = np.load(out_cp, mmap_mode="r")[:w]
        # re-save compacted copies blockwise to drop the padding tail
        lp2 = os.path.join(self.dir, f"run{self._seq}.lanes.npy")
        cp2 = os.path.join(self.dir, f"run{self._seq}.counts.npy")
        self._seq += 1
        o2 = np.lib.format.open_memmap(lp2, mode="w+", dtype=np.uint32,
                                       shape=(L, w))
        c2 = np.lib.format.open_memmap(cp2, mode="w+", dtype=np.int64,
                                       shape=(w,))
        for s in range(0, w, block):
            o2[:, s:s + block] = final_l[:, s:s + block]
            c2[s:s + block] = final_c[s:s + block]
        o2.flush()
        c2.flush()
        del final_l, final_c
        os.remove(out_lp)
        os.remove(out_cp)
        return (lp2, cp2, w)


def collect_kmers_streaming(
    seqs: Sequence[bytes],
    K: int,
    alphabet: Alphabet = DNA,
    canonical: bool = False,
    chunk_codes: int = 1 << 22,
    disk_dir: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted unique k-mers + counts for arbitrarily large inputs with a
    bounded device working set. Returns host arrays. With ``disk_dir``
    the sorted runs spill to memory-mapped files and merge with bounded
    host RAM (--disk-swap; the SortedSetDisk role)."""
    B = alphabet.bits_per_char
    L = packing.lanes_for(K, B)
    # disk runs spill in the narrowest order-preserving form (2 bits/char
    # for DNA); merges compare compact keys, unpack happens once at the end
    B2 = _repack_bits(K, B, alphabet.size)
    L2 = max(-(-K // (32 // B2)), 1) if B2 < B else L
    chunks: List[Tuple[np.ndarray, np.ndarray]] = []
    store = DiskChunkStore(disk_dir, L2) if disk_dir else None
    buf = np.full(chunk_codes, INVALID_CODE, np.uint8)
    fill = 0

    def flush():
        nonlocal fill
        if fill == 0:
            return
        ulanes, ucounts, ucount = _collect_stage(
            jnp.asarray(buf), K, B, (), canonical, alphabet.complement)
        n = int(ucount)
        run = np.asarray(ulanes[:, :n])
        if store is not None:
            if B2 < B:
                run = _pack_run(run, K, B, B2)
            store.spill(run, np.asarray(ucounts[:n]))
        else:
            chunks.append((run, np.asarray(ucounts[:n])))
        buf.fill(INVALID_CODE)
        fill = 0

    tbl = alphabet.encode_table()
    for s in seqs:
        codes = tbl[np.frombuffer(bytes(s), np.uint8)]
        pos = 0
        while pos < len(codes):
            space = chunk_codes - fill - 1
            if space < K:          # not enough room for a full window
                flush()
                space = chunk_codes - 1
            take = min(space, len(codes) - pos)
            buf[fill:fill + take] = codes[pos:pos + take]
            fill += take + 1       # leave one INVALID separator
            # overlap chunks by K-1 so no window is lost at the boundary
            pos += take
            if pos < len(codes):
                pos = max(0, pos - (K - 1))
    flush()
    if store is not None:
        lanes_m, counts_m = store.merge_all()
        if B2 < B:
            lanes_m = _unpack_run(np.asarray(lanes_m), K, B, B2)
        return lanes_m, counts_m
    return _merge_sorted_chunks(chunks, L)


def build_boss_streaming(
    seqs: Sequence[bytes],
    k: int,
    alphabet: Alphabet = DNA,
    mode: str = MODE_BASIC,
    bits_per_count: int = 0,
    chunk_codes: int = 1 << 22,
    disk_dir: Optional[str] = None,
) -> Boss:
    """End-to-end build with host-spill collection; ``disk_dir`` engages
    the on-disk chunk tier (--disk-swap)."""
    canonical = mode in (MODE_CANONICAL, MODE_PRIMARY)
    lanes_np, counts_np = collect_kmers_streaming(
        seqs, k, alphabet, canonical=canonical, chunk_codes=chunk_codes,
        disk_dir=disk_dir)
    n = lanes_np.shape[1]
    cap = _bucket(n)
    lanes = packed.pad_to(jnp.asarray(lanes_np), cap)
    counts = jnp.concatenate([
        jnp.asarray(np.minimum(counts_np, (1 << 31) - 1).astype(np.int32)),
        jnp.zeros((cap - n,), jnp.int32)])
    return build_boss_from_kmers(
        lanes, counts, n, k, alphabet,
        mode=MODE_CANONICAL if mode == MODE_CANONICAL else MODE_BASIC,
        bits_per_count=bits_per_count)
