"""The BOSS table as dense device tensors with batched navigation.

Device re-design of the reference BOSS class
(metagraph/src/graph/representation/succinct/boss.hpp:27,
boss.cpp:567-596). The representation keeps the same logical arrays —

    W    : edge labels with +alph_size "minus" flags on non-representative
           incoming edges (boss.hpp:483-514)
    last : 1 marks the final outgoing edge of each source node
    F[c] : #edges whose source node ends in a char < c

— but replaces wavelet-tree/bit-vector rank/select with dense prefix
tables (common/ranksel.py) so that *batches* of fwd/bwd/map operations
compile to gathers and vectorized binary searches. Optionally holds the
sorted packed edge-kmer tensor itself (``edge_lanes``) as a search
accelerator: ``map_to_edges`` is then one searchsorted over the lanes
instead of the reference's per-character range tightening
(boss.cpp:908-975).

Indexing is 1-based over edges like the reference (position 0 is a
sentinel row; index 0 == npos).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..common import packed
from ..common.ranksel import BitRank, SymbolRank
from ..kmer import packing
from ..kmer.alphabets import Alphabet, DNA


@dataclass(frozen=True)
class Boss:
    # static metadata
    k: int                      # node length (edge k-mer has k+1 chars)
    alph_size: int
    bits_per_char: int
    # core arrays (logical length num_edges+1; index 0 = sentinel row)
    # W and last live INSIDE the blocked rank structures — no duplicates
    F: jax.Array                # (alph_size,) int32
    last_rank: BitRank
    W_rank: SymbolRank
    NF: jax.Array               # (alph_size,) int32: rank_last(F[c])
    # optional accelerators / extensions
    edge_lanes: Optional[jax.Array] = None   # (L, m-1) sorted packed edge kmers
    weights: Optional[jax.Array] = None      # (m,) int32 k-mer counts
    lut: Optional[jax.Array] = None          # (2^16+1,) top-16-bit bucket starts
    lut_steps: int = 0                       # binary-search rounds within bucket

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_arrays(k: int, alph_size: int, bits_per_char: int,
                    W: jax.Array, last: jax.Array, F: jax.Array,
                    edge_lanes: Optional[jax.Array] = None,
                    weights: Optional[jax.Array] = None) -> "Boss":
        W = W.astype(jnp.int32)
        last = last.astype(bool)
        F = F.astype(jnp.int32)
        # blocked rank structures (0.25 B/pos for last, ~1.3 B/pos for W),
        # built in ONE fused dispatch (no host round trip per structure)
        n = int(last.shape[0])
        sigma = 2 * alph_size
        (lw, lbr, ltot, seq_words, blocks, NF) = _finalize_ranks(
            W, last, F, sigma=sigma, n=n)
        last_rank = BitRank(words=lw, brank=lbr, total=ltot, n=n)
        W_rank = SymbolRank(seq_words=seq_words, blocks=blocks, sigma=sigma,
                            n_seq=n)
        if edge_lanes is not None and edge_lanes.shape[1] > 0:
            lut, max_bucket = _build_lut(edge_lanes)
            lut_steps = max(1, int(np.ceil(np.log2(int(max_bucket) + 1))))
        else:
            lut, lut_steps = None, 0
        return Boss(k=k, alph_size=alph_size, bits_per_char=bits_per_char,
                    F=F, last_rank=last_rank, W_rank=W_rank, NF=NF,
                    edge_lanes=edge_lanes, weights=weights,
                    lut=lut, lut_steps=lut_steps)

    @staticmethod
    def from_finish(k: int, alph_size: int, bits_per_char: int,
                    kept: jax.Array, W: jax.Array, last: jax.Array,
                    F: jax.Array, n_kept: int,
                    weights: Optional[jax.Array] = None,
                    keep_kmer_index: bool = True,
                    lut: Optional[jax.Array] = None,
                    max_bucket: Optional[int] = None) -> "Boss":
        """Finalize straight from the construction finish-stage buffers:
        slice-to-size, sentinel row, blocked ranks and NF in ONE dispatch
        with NO host sync (vs ~6 op-by-op dispatches + 1 sync through
        from_arrays).
        ``lut``/``max_bucket`` come precomputed from the finish stage
        (max_bucket rides the stats sync the builder already pays)."""
        sigma = 2 * alph_size
        (lw, lbr, ltot, seq_words, blocks, NF, F32, w_full, lanes) = \
            _finalize_full(
                kept, W, last, F, weights, sigma=sigma, n_kept=n_kept,
                has_weights=weights is not None,
                with_lanes=keep_kmer_index)
        n = n_kept + 1
        last_rank = BitRank(words=lw, brank=lbr, total=ltot, n=n)
        W_rank = SymbolRank(seq_words=seq_words, blocks=blocks, sigma=sigma,
                            n_seq=n)
        if keep_kmer_index and lut is not None and n_kept > 0:
            lut_steps = max(1, int(np.ceil(np.log2(max_bucket + 1))))
        else:
            lut, lut_steps = None, 0
        return Boss(k=k, alph_size=alph_size, bits_per_char=bits_per_char,
                    F=F32, last_rank=last_rank, W_rank=W_rank, NF=NF,
                    edge_lanes=lanes, weights=w_full,
                    lut=lut, lut_steps=lut_steps)

    # -- basic accessors ---------------------------------------------------

    @property
    def W(self) -> jax.Array:
        """(m,) int8 view of the W array (stored inside W_rank)."""
        return self.W_rank.seq

    @property
    def last(self) -> jax.Array:
        """(m,) bool view of the last bitvector (host-materialized from
        the packed words; use last_rank for device queries)."""
        return jnp.asarray(self.last_rank.bits_host())

    @property
    def num_edges(self) -> int:
        return self.W_rank.n_seq - 1

    def num_nodes(self) -> jax.Array:
        return self.last_rank.num_set

    @property
    def K(self) -> int:
        """Edge k-mer length."""
        return self.k + 1

    def get_W(self, i: jax.Array) -> jax.Array:
        return self.W_rank[jnp.clip(i, 0, self.W_rank.n_seq - 1)]

    def get_last(self, i: jax.Array) -> jax.Array:
        return self.last_rank.bit(i)

    # -- rank / select (1-based semantics, matching boss.hpp) --------------

    def rank_last(self, i: jax.Array) -> jax.Array:
        """#set bits in last[1..i]."""
        return self.last_rank.rank1(i)  # last[0] == 0

    def select_last(self, r: jax.Array) -> jax.Array:
        return self.last_rank.select1(r)

    def succ_last(self, i: jax.Array) -> jax.Array:
        return self.last_rank.next1(i)

    def pred_last(self, i: jax.Array) -> jax.Array:
        p = self.last_rank.prev1(jnp.maximum(i, 0))
        return jnp.where((i <= 0) | (p >= self.last_rank.n), 0, p)

    def rank_W(self, i: jax.Array, c: jax.Array) -> jax.Array:
        """#occurrences of c in W[1..i] (W[0] = 0 excluded)."""
        r = self.W_rank.rank(c, i)
        return r - jnp.where((c == 0) & (i >= 0), 1, 0)

    def select_W(self, r: jax.Array, c: jax.Array) -> jax.Array:
        """Position of the r-th occurrence of c in W[1..]."""
        return self.W_rank.select(c, r + (c == 0))

    def succ_W(self, i: jax.Array, c: jax.Array) -> jax.Array:
        """Smallest j >= i with W[j] == c, else m (num_edges+1)."""
        total = self.rank_W(self.num_edges, c)
        r = self.rank_W(i - 1, c) + 1
        pos = self.select_W(r, c)
        return jnp.where(r <= total, pos, self.num_edges + 1)

    # -- navigation (boss.cpp:567-596) -------------------------------------

    def get_node_last_value(self, i: jax.Array) -> jax.Array:
        """Last character of the source node of edge i (via F offsets)."""
        c = jnp.searchsorted(self.F, i.astype(jnp.int32), side="left") - 1
        return jnp.where(i == 0, 0, jnp.clip(c, 0, self.alph_size - 1))

    def fwd(self, i: jax.Array, c: jax.Array) -> jax.Array:
        """Edge row of the target node of edge i (label c, unflagged)."""
        target_node = self.NF[c] + self.rank_W(i, c)
        return self.select_last(target_node)

    def bwd(self, i: jax.Array) -> jax.Array:
        """Row of the first incoming edge of the source node of edge i."""
        target_node = self.rank_last(i - 1) + 1
        c = self.get_node_last_value(i)
        res = self.select_W(target_node - self.NF[c], c)
        return jnp.where(target_node == 1, 1, res)

    # -- searching ---------------------------------------------------------

    @jax.jit
    def index_edge_ranksel(self, chars: jax.Array) -> jax.Array:
        """Rank/select-only edge lookup (no edge_lanes accelerator):
        the reference's index + pick_edge search (boss.hpp:640-750).
        Jitted as one program — eagerly it dispatched dozens of op
        compiles per call.

        ``chars``: (Q, K) int32 edge k-mers in sequence order
        (node chars u_1..u_k then the edge label). Per query: an initial
        F range on u_1, k-1 tighten_range steps (rank_W + select_last via
        NF), then pick_edge over the terminal node's edge rows."""
        Q, K = chars.shape
        k = self.k
        m = self.num_edges
        alph = self.alph_size
        chars = chars.astype(jnp.int32)
        ok = jnp.all((chars >= 1) & (chars < alph), axis=1)
        u1 = jnp.clip(chars[:, 0], 0, alph - 1)
        rl = jnp.minimum(self.F[u1] + 1, m + 1)
        ru = jnp.where(u1 + 1 < alph,
                       self.F[jnp.minimum(u1 + 1, alph - 1)], m)
        ok = ok & (rl <= ru)

        # the k-1 tighten steps run as a fori_loop, not unrolled Python:
        # unrolling inlined k copies of rank/select machinery into one
        # HLO, which ballooned compile time and could crash XLA:CPU's
        # compiler outright on long suites
        def tighten(i, state):
            # the two rank_W and two select_last queries of each step
            # ride ONE fused call each: the primitives are latency-bound
            # gathers, so call count — not query count — is the cost
            ok, rl, ru = state
            col = jax.lax.dynamic_slice_in_dim(chars, i, 1, axis=1)[:, 0]
            s = jnp.clip(col, 0, alph - 1)
            rk = self.rank_W(jnp.concatenate([rl - 1, ru]),
                             jnp.concatenate([s, s]))
            rk_rl = rk[:Q] + 1
            rk_ru = rk[Q:]
            step_ok = rk_rl <= rk_ru
            safe_rl = jnp.maximum(self.NF[s] + rk_rl - 1, 1)
            safe_ru = jnp.maximum(self.NF[s] + rk_ru, 1)
            sl = self.select_last(jnp.concatenate([safe_rl, safe_ru]))
            nrl = sl[:Q] + 1
            nru = sl[Q:]
            ok = ok & step_ok
            return (ok, jnp.where(ok, nrl, rl), jnp.where(ok, nru, ru))

        ok, rl, ru = jax.lax.fori_loop(1, k, tighten, (ok, rl, ru))
        # pick_edge(ru, label): search the node's edge rows for W == c
        # or c + alph (boss.hpp pick_edge)
        c = jnp.clip(chars[:, k], 0, alph - 1)
        lo = self.pred_last(ru - 1) + 1
        cc = jnp.concatenate([c, c + alph])     # unflagged + flagged probe
        rr = self.rank_W(jnp.concatenate([ru, ru]), cc)
        pos = self.select_W(jnp.maximum(rr, 1), cc)
        p1 = jnp.where((rr[:Q] >= 1) & (pos[:Q] >= lo), pos[:Q], 0)
        p2 = jnp.where((rr[Q:] >= 1) & (pos[Q:] >= lo), pos[Q:], 0)
        res = jnp.where(p1 > 0, p1, p2)
        return jnp.where(ok, res, 0).astype(jnp.int32)

    @jax.jit
    def suffix_range_ranksel(self, pattern: jax.Array
                             ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """(ok, rl, ru) inclusive 1-based edge-row range of all edges whose
        source node's last ``s`` chars equal ``pattern`` (s,) int32 — the
        rank/select-only analog of the reference's partial index_range
        (boss.hpp:694-740) used by suffix seeding on small-state graphs
        (no ``edge_lanes`` accelerator to binary-search)."""
        s = pattern.shape[0]
        m = self.num_edges
        alph = self.alph_size
        pattern = pattern.astype(jnp.int32)
        ok = jnp.all((pattern >= 1) & (pattern < alph))
        u1 = jnp.clip(pattern[0], 0, alph - 1)
        rl = jnp.minimum(self.F[u1] + 1, m + 1)
        ru = jnp.where(u1 + 1 < alph,
                       self.F[jnp.minimum(u1 + 1, alph - 1)], m)
        ok = ok & (rl <= ru)

        def tighten(i, state):
            ok, rl, ru = state
            c = jnp.clip(jax.lax.dynamic_index_in_dim(
                pattern, i, keepdims=False), 0, alph - 1)
            rk_rl = self.rank_W(rl - 1, c) + 1
            rk_ru = self.rank_W(ru, c)
            step_ok = rk_rl <= rk_ru
            safe_rl = jnp.maximum(self.NF[c] + rk_rl - 1, 1)
            safe_ru = jnp.maximum(self.NF[c] + rk_ru, 1)
            nrl = self.select_last(safe_rl) + 1
            nru = self.select_last(safe_ru)
            ok = ok & step_ok
            return (ok, jnp.where(ok, nrl, rl), jnp.where(ok, nru, ru))

        ok, rl, ru = jax.lax.fori_loop(1, s, tighten, (ok, rl, ru))
        return ok, rl, ru

    def map_to_edges(self, query_lanes: jax.Array) -> jax.Array:
        """Map packed edge k-mers (BOSS layout, sentinel codes) to 1-based
        edge indexes; 0 = not present.

        With the ``edge_lanes`` accelerator: one batched binary search
        over the stored sorted edge-kmer tensor (replaces
        BOSS::map_to_edges / index_range, boss.cpp:908-975). Without it
        (small state): the rank/select tightening search above.
        """
        if self.edge_lanes is None:
            chars = packing.unpack_to_chars(
                query_lanes, self.K, self.bits_per_char).astype(jnp.int32)
            return self.index_edge_ranksel(chars)
        n = self.edge_lanes.shape[1]
        if self.lut is not None:
            t = query_lanes[0] >> 16
            pos = packed.searchsorted(
                self.edge_lanes, query_lanes, side="left",
                lo0=self.lut[t], hi0=self.lut[t + 1], steps=self.lut_steps)
        else:
            pos = packed.searchsorted(self.edge_lanes, query_lanes,
                                      side="left")
        pos_c = jnp.minimum(pos, n - 1)
        hit = packed.eq(self.edge_lanes[:, pos_c], query_lanes)
        return jnp.where(hit, pos_c + 1, 0)

    @jax.jit
    def node_chars_ranksel(self, rows: jax.Array) -> jax.Array:
        """(Q, K) char codes of the edge k-mers at the given rows, decoded
        with rank/select only (the reference's get_node_seq bwd walk,
        boss.cpp:603-622): K-1 backward steps recover the node chars and
        W supplies the edge label. Small-state graphs use this in place
        of the edge_lanes gather."""
        K = self.k + 1
        Q = rows.shape[0]
        out = jnp.zeros((Q, K), jnp.int32)
        label = self.get_W(rows.astype(jnp.int32)) % self.alph_size
        out = out.at[:, K - 1].set(label.astype(jnp.int32))
        def body(i, state):
            x, out = state
            c = self.get_node_last_value(x).astype(jnp.int32)
            out = jax.lax.dynamic_update_slice(out, c[:, None],
                                               (0, K - 2 - i))
            return self.bwd(x), out
        _, out = jax.lax.fori_loop(
            0, K - 1, body, (rows.astype(jnp.int32), out))
        return out

    def index_range_nodes(self, node_lanes: jax.Array
                          ) -> Tuple[jax.Array, jax.Array]:
        """[lo, hi) edge-row range of all edges whose source node matches
        the given packed node (label field 0 must be 0 in the query)."""
        assert self.edge_lanes is not None
        lo = packed.searchsorted(self.edge_lanes, node_lanes, side="left")
        # upper bound: node + 1, i.e. +1 at field 1 (just above the
        # label field) with carry propagation across lanes
        hi_query = _increment_masked(node_lanes, shift=self.bits_per_char)
        hi = packed.searchsorted(self.edge_lanes, hi_query, side="left")
        return lo + 1, hi + 1  # 1-based rows

    # -- statistics --------------------------------------------------------

    def char_counts_W(self) -> jax.Array:
        """(alph_size,) total W occurrences folding minus flags."""
        m = self.num_edges
        cs = jnp.arange(self.alph_size)
        base = self.rank_W(jnp.full_like(cs, m), cs)
        flagged = self.rank_W(jnp.full_like(cs, m), cs + self.alph_size)
        return base + jnp.where(cs == 0, 0, flagged)

    def num_dummy_edges(self) -> Tuple[jax.Array, jax.Array]:
        """(#dummy source edges, #dummy sink edges) from the kmer tensor."""
        assert self.edge_lanes is not None
        B = self.bits_per_char
        first = packing.first_char(self.edge_lanes, B)
        lab = packing.label(self.edge_lanes, B)
        is_src = first == 0
        is_sink = (lab == 0) & ~is_src
        return jnp.sum(is_src.astype(jnp.int32)), jnp.sum(is_sink.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("sigma", "n"))
def _finalize_ranks(W, last, F, sigma: int, n: int):
    """Blocked BitRank + SymbolRank + NF in one dispatch."""
    from ..common.ranksel import _BS, _pack_bits_device
    words = _pack_bits_device(last)
    pops = jax.lax.population_count(words).astype(jnp.int32)
    brank = jnp.cumsum(pops) - pops
    total = (brank[-1] + pops[-1]) if words.shape[0] else jnp.int32(0)
    nb = max((n + _BS - 1) // _BS, 1)
    seq_pad = jnp.full((nb * _BS,), sigma, jnp.int8).at[:n].set(
        W.astype(jnp.int8))
    from ..common.ranksel import SymbolRank as _SR
    seq_words = _SR.pack_words(seq_pad)
    hist = jnp.stack([
        jnp.sum((seq_pad == c).reshape(nb, _BS), axis=1, dtype=jnp.int32)
        for c in range(sigma)], axis=1)
    blocks = jnp.concatenate(
        [jnp.zeros((1, sigma), jnp.int32), jnp.cumsum(hist, axis=0)])
    # NF[c] = rank_last(F[c]) on the freshly built blocked rank
    i = jnp.clip(F, -1, n - 1)
    ic = jnp.maximum(i, 0)
    wi = ic >> 5
    low = jnp.uint32(0xFFFFFFFF) >> (jnp.uint32(31)
                                     - (ic & 31).astype(jnp.uint32))
    NF = jnp.where(i < 0, 0, brank[wi] + jax.lax.population_count(
        words[wi] & low).astype(jnp.int32))
    return words, brank, total, seq_words, blocks, NF


@functools.partial(jax.jit, static_argnames=(
    "sigma", "n_kept", "has_weights", "with_lanes"))
def _finalize_full(kept, W, last, F, weights, sigma: int, n_kept: int,
                   has_weights: bool, with_lanes: bool):
    """from_finish body: sentinel-row concat + blocked ranks + NF."""
    zero = jnp.zeros((1,), jnp.int32)
    W_full = jnp.concatenate([zero, W[:n_kept].astype(jnp.int32)])
    last_full = jnp.concatenate([zero.astype(bool),
                                 last[:n_kept].astype(bool)])
    F32 = F.astype(jnp.int32)
    w_full = (jnp.concatenate([zero, weights[:n_kept].astype(jnp.int32)])
              if has_weights else None)
    n = n_kept + 1
    lw, lbr, ltot, seq_words, blocks, NF = _finalize_ranks.__wrapped__(
        W_full, last_full, F32, sigma=sigma, n=n)
    lanes = kept[:, :n_kept] if (with_lanes and n_kept > 0) else None
    return (lw, lbr, ltot, seq_words, blocks, NF, F32, w_full, lanes)


@jax.jit
def _build_lut(edge_lanes: jax.Array):
    """(2^16+1,) bucket-start table over the top lane's high 16 bits, plus
    the maximum bucket size (device-computed; one scalar sync)."""
    n = edge_lanes.shape[1]
    top = (edge_lanes[0] >> 16).astype(jnp.uint32)
    lut = jnp.searchsorted(top, jnp.arange(1 << 16, dtype=jnp.uint32),
                           side="left").astype(jnp.int32)
    lut = jnp.concatenate([lut, jnp.full((1,), n, jnp.int32)])
    max_bucket = jnp.max(jnp.diff(lut))
    return lut, max_bucket


def _increment_masked(lanes: jax.Array, shift: int = 0) -> jax.Array:
    """Add (1 << shift) to the packed big integer (carry-propagating).

    Used to form exclusive upper bounds for prefix range searches
    (shift = bits_per_char increments the node portion just above the
    label field). Queries never overflow the packed width.
    """
    L = lanes.shape[0]
    carry = jnp.full_like(lanes[0], np.uint32(1 << shift))
    out = []
    for j in range(L - 1, -1, -1):
        s = lanes[j] + carry
        carry = (s < lanes[j]).astype(lanes.dtype)
        out.append(s)
    return jnp.stack(out[::-1])


def register_pytrees():
    jax.tree_util.register_dataclass(
        Boss,
        ["F", "last_rank", "W_rank", "NF", "edge_lanes", "weights", "lut"],
        ["k", "alph_size", "bits_per_char", "lut_steps"],
    )


register_pytrees()
