"""DBGSuccinct: the node-level de Bruijn graph facade over a BOSS table.

Re-design of the reference DBGSuccinct
(metagraph/src/graph/representation/succinct/dbg_succinct.hpp:113-190):
a DBG node of k-mer size k is a BOSS *edge* (k = boss.k + 1); dummy edges
(containing ``$``) are masked out of the node index space via a rank over
the valid-edge mask, so node indexes are contiguous 1..num_nodes
(the reference's ``valid_edges_`` + rank trick).

Mapping and traversal are *batched*: ``map_to_nodes`` maps every window
of a whole read batch with one searchsorted; ``successors``/
``predecessors`` compute adjacency for a node batch with vectorized
range searches on the sorted edge-kmer tensor — no per-node pointer
chasing.
"""

from __future__ import annotations

import functools

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..common import packed
from ..common.ranksel import BitRank
from ..kmer import packing
from ..kmer.alphabets import Alphabet, DNA, INVALID_CODE
from ..kmer.extractor import encode_sequences, window_validity
from .boss import Boss

MODE_BASIC = "basic"
MODE_CANONICAL = "canonical"
MODE_PRIMARY = "primary"


@dataclass(frozen=True)
class DbgSuccinct:
    boss: Boss
    alphabet: Alphabet
    mode: str
    valid_rank: BitRank          # over (m,) incl. sentinel row 0

    @staticmethod
    def from_boss(boss: Boss, alphabet: Alphabet = DNA,
                  mode: str = MODE_BASIC,
                  valid: "Optional[jax.Array]" = None) -> "DbgSuccinct":
        """``valid``: (m,) bool real-edge mask incl. sentinel row 0; derived
        from edge_lanes when present, required for small-state graphs."""
        B = alphabet.bits_per_char
        if valid is None:
            assert boss.edge_lanes is not None, \
                "small-state graphs need an explicit valid-edge mask"
            valid = _valid_mask_fused(boss.edge_lanes, boss.K, B)
        n = int(valid.shape[0])
        words, brank, total = _bitrank_fused(jnp.asarray(valid))
        return DbgSuccinct(boss=boss, alphabet=alphabet, mode=mode,
                           valid_rank=BitRank(words=words, brank=brank,
                                              total=total, n=n))

    # -- sizes -------------------------------------------------------------

    @property
    def k(self) -> int:
        return self.boss.K

    def num_nodes(self) -> int:
        return int(self.valid_rank.num_set)

    # -- index mapping -----------------------------------------------------

    def edge_to_node(self, edge: jax.Array) -> jax.Array:
        """BOSS edge row -> DBG node index (0 if dummy/absent)."""
        return jnp.where((edge > 0) & self.valid_rank.bit(edge),
                         self.valid_rank.rank1(edge), 0)

    def node_to_edge(self, node: jax.Array) -> jax.Array:
        """DBG node index -> BOSS edge row."""
        return jnp.where(node > 0, self.valid_rank.select1(node), 0)

    def node_lanes(self, node: jax.Array) -> jax.Array:
        """Packed edge k-mers of a node batch."""
        edge = self.node_to_edge(node)
        return self.boss.edge_lanes[:, jnp.maximum(edge - 1, 0)]

    # -- sequence mapping (reference map_to_nodes, sequence_graph.hpp:166) --

    @jax.jit
    def map_codes_to_nodes(self, codes: jax.Array) -> jax.Array:
        """Map every k-window of a code array to its node id (0 = absent
        or invalid window). Returns (len(codes) - k + 1,) int32."""
        K = self.k
        B = self.alphabet.bits_per_char
        ok = window_validity(codes, K)
        lanes = packing.pack_windows(codes, K, B)
        if self.mode in (MODE_CANONICAL, MODE_PRIMARY):
            rc = packing.reverse_complement(lanes, K, B, self.alphabet.complement)
            lanes = jnp.where(packed.lt(rc, lanes)[None, :], rc, lanes)
        edges = self.boss.map_to_edges(lanes)
        nodes = self.edge_to_node(edges)
        return jnp.where(ok, nodes, 0)

    @functools.partial(jax.jit, static_argnames=("rounds",))
    def _map_reads_small_walk(self, chars2d, rounds: int = 2):
        """Incremental small-state read mapping: anchor the first
        unresolved window of each read with ONE k-step tightening
        search, then follow the BOSS fwd transition per subsequent
        window (the reference maps consecutive k-mers by traversal the
        same way, boss.hpp fwd).

        The scan carries each read's (node, edge-row range) instead of
        an edge row: the per-step transition is then ONE fused rank_W
        call (4 queries/read) + ONE fused select_last call (2/read) —
        the primitives are latency-bound, so CALL count is wall time —
        and the select_W lookups that materialize the actual edge rows
        are deferred to one batched pass at the end. Absent windows are
        *known* zeros; windows right after an absent one re-anchor on
        the next round. Returns (edges (R, nw), known (R, nw),
        n_unknown) — the host resolves stragglers (only miss-heavy
        reads) through the flat batched search."""
        boss = self.boss
        K = self.k
        R, Lr = chars2d.shape
        nw = Lr - K + 1
        alph = self.alphabet.size
        NF = boss.NF
        chars2d = chars2d.astype(jnp.int32)
        bad = ((chars2d < 1) | (chars2d >= alph)).astype(jnp.int32)
        pref = jnp.concatenate(
            [jnp.zeros((R, 1), jnp.int32), jnp.cumsum(bad, axis=1)], axis=1)
        win_ok = (pref[:, K:] - pref[:, :-K]) == 0        # (R, nw)
        edges = jnp.zeros((R, nw), jnp.int32)   # anchor-resolved rows
        rsel = jnp.zeros((R, nw), jnp.int32)    # walk-resolved: W rank
        ssel = jnp.ones((R, nw), jnp.int32)     # walk-resolved: W symbol
        via_walk = jnp.zeros((R, nw), bool)
        known = ~win_ok                                   # invalid = known 0
        rows = jnp.arange(R)
        offs = jnp.arange(K)
        # per-position window-label chars, scan-major: (nw-1, R)
        nxt_chars = chars2d[:, K:].T

        def node_range(T, valid):
            """(lo, ru) inclusive edge-row range of node T (1-based)."""
            Tc = jnp.maximum(T, 1)
            sl = boss.select_last(
                jnp.concatenate([Tc, jnp.maximum(Tc - 1, 1)]))
            ru = jnp.where(valid, sl[:R], 0)
            lo = jnp.where(T > 1, sl[R:] + 1, 1)
            return lo, ru

        for _ in range(rounds):
            unk = ~known
            has = jnp.any(unk, axis=1)
            a = jnp.argmax(unk, axis=1)
            ach = chars2d[rows[:, None], jnp.minimum(a[:, None] + offs,
                                                     Lr - 1)]
            e_a = boss.index_edge_ranksel(ach)
            e_a = jnp.where(has, e_a, 0)
            edges = edges.at[rows, a].set(
                jnp.where(has, e_a, edges[rows, a]))
            via_walk = via_walk.at[rows, a].set(
                jnp.where(has, False, via_walk[rows, a]))
            known = known.at[rows, a].set(known[rows, a] | has)
            # anchor carry state: the target node of e_a and its range
            w = boss.get_W(jnp.maximum(e_a, 1))
            cp = jnp.clip(w % alph, 0, alph - 1)
            T_a = jnp.where(e_a > 0, NF[cp] + boss.rank_W(e_a, cp), 0)
            lo_a, ru_a = node_range(T_a, e_a > 0)
            aT = jnp.zeros((R, nw), jnp.int32).at[rows, a].set(
                jnp.where(has, T_a, 0))
            aLo = jnp.zeros((R, nw), jnp.int32).at[rows, a].set(lo_a)
            aRu = jnp.zeros((R, nw), jnp.int32).at[rows, a].set(ru_a)
            aSet = jnp.zeros((R, nw), bool).at[rows, a].set(has)

            def step(carry, x):
                T, lo, ru, live = carry
                ch, k0, wok, aT_i, aLo_i, aRu_i, aSet_i = x
                c = jnp.clip(ch, 1, alph - 1)
                active = live & ~k0 & wok
                rk = boss.rank_W(
                    jnp.concatenate([ru, lo - 1, ru, lo - 1]),
                    jnp.concatenate([c, c, c + alph, c + alph]))
                rhc, rlc = rk[:R], rk[R:2 * R]
                rhf, rlf = rk[2 * R:3 * R], rk[3 * R:]
                pres_c = rhc > rlc
                present = pres_c | (rhf > rlf)
                resolved = active & present
                absent = active & ~present
                T2 = NF[c] + rhc          # target (flag-invariant: the
                # flagged edge's unflagged twin precedes lo, so
                # rank_W(ru, c) == rank_W(e, c) either way)
                lo2, ru2 = node_range(T2, resolved)
                T_n = jnp.where(aSet_i, aT_i, jnp.where(resolved, T2, 0))
                lo_n = jnp.where(aSet_i, aLo_i, lo2)
                ru_n = jnp.where(aSet_i, aRu_i, ru2)
                live_n = (aSet_i & (aT_i > 0)) | resolved
                y = (resolved, absent,
                     jnp.where(pres_c, rhc, rhf),
                     jnp.where(pres_c, c, c + alph))
                return (T_n, lo_n, ru_n, live_n), y

            xs = (nxt_chars, known[:, 1:].T, win_ok[:, 1:].T,
                  aT[:, 1:].T, aLo[:, 1:].T, aRu[:, 1:].T, aSet[:, 1:].T)
            init = (aT[:, 0], aLo[:, 0], aRu[:, 0],
                    aSet[:, 0] & (aT[:, 0] > 0))
            _, (res_s, abs_s, r_s, s_s) = jax.lax.scan(step, init, xs)
            res_w = jnp.concatenate(
                [jnp.zeros((R, 1), bool), res_s.T], axis=1)
            abs_w = jnp.concatenate(
                [jnp.zeros((R, 1), bool), abs_s.T], axis=1)
            rsel = jnp.where(res_w, jnp.concatenate(
                [jnp.zeros((R, 1), jnp.int32), r_s.T], axis=1), rsel)
            ssel = jnp.where(res_w, jnp.concatenate(
                [jnp.ones((R, 1), jnp.int32), s_s.T], axis=1), ssel)
            via_walk = via_walk | res_w
            known = known | res_w | abs_w
        # ONE batched select materializes every walk-resolved edge row
        e_w = boss.select_W(jnp.maximum(rsel.reshape(-1), 1),
                            ssel.reshape(-1)).reshape(R, nw)
        edges = jnp.where(via_walk, e_w.astype(jnp.int32), edges)
        n_unknown = jnp.sum((~known).astype(jnp.int32))
        nodes = jnp.where(win_ok & known & (edges > 0),
                          self.edge_to_node(edges), 0)
        return nodes, known, n_unknown

    def map_read_batch(self, reads, pad_to: int = 0) -> list:
        """Node ids per read for a batch of reads — the small-state
        fast path (incremental walk); fast-state graphs take the flat
        batched searchsorted. Returns a list of (len(read)-k+1,) arrays."""
        k = self.k
        if self.boss.edge_lanes is not None or not reads:
            return [self.map_to_nodes(r) for r in reads]
        Lmax = max(max(len(r) for r in reads), k)
        Lmax = max(Lmax, pad_to)
        tbl = self.alphabet.encode_table()
        chars = np.zeros((len(reads), Lmax), np.uint8)   # 0 = invalid pad
        for i, r in enumerate(reads):
            cs = (r if isinstance(r, np.ndarray)
                  else tbl[np.frombuffer(bytes(r), np.uint8)])
            chars[i, :len(cs)] = np.where(cs == 255, 0, cs)
        nodes, known, n_unk = self._map_reads_small_walk(jnp.asarray(chars))
        nodes = np.array(nodes)          # writable host copy
        if int(n_unk):
            # miss-heavy stragglers (windows the walk left unresolved
            # after its anchor rounds — e.g. every window after an absent
            # one in an all-miss read): resolve ALL of them with ONE
            # batched k-step tightening search.  The previous per-read
            # host loop re-dispatched map_codes_to_nodes once per
            # straggler read, paying one dispatch latency per read.
            known_np = np.asarray(known)
            nw_arr = np.array([max(0, len(r) - k + 1) for r in reads])
            col = np.arange(known_np.shape[1])
            unk = (~known_np) & (col[None, :] < nw_arr[:, None])
            ui, uj = np.nonzero(unk)
            if len(ui):
                wins = chars[ui[:, None], uj[:, None] + np.arange(k)[None, :]]
                U = len(ui)
                cap = max(256, 1 << (U - 1).bit_length())
                wpad = np.zeros((cap, k), np.uint8)   # 0 = invalid char
                wpad[:U] = wins
                res = np.asarray(self._resolve_windows(jnp.asarray(wpad)))
                nodes[ui, uj] = res[:U]
        return [nodes[i, :max(0, len(r) - k + 1)]
                for i, r in enumerate(reads)]

    @jax.jit
    def _resolve_windows(self, wchars: jax.Array) -> jax.Array:
        """Node ids for a flat batch of (U, k) char windows via the
        rank/select tightening search (invalid chars -> 0)."""
        edges = self.boss.index_edge_ranksel(wchars.astype(jnp.int32))
        return self.edge_to_node(edges)

    def map_to_nodes(self, seq: bytes | str) -> np.ndarray:
        codes = encode_sequences([seq], self.alphabet)[:-1]  # drop separator
        n = len(codes)
        if n < self.k:
            return np.zeros((max(0, n - self.k + 1),), np.int32)
        # pad to a power-of-two bucket so the jitted map compiles per size
        # class, not per sequence length
        cap = max(64, 1 << (n - 1).bit_length())
        codes = np.concatenate(
            [codes, np.full(cap - n, INVALID_CODE, np.uint8)])
        out = np.asarray(self.map_codes_to_nodes(jnp.asarray(codes)))
        return out[:n - self.k + 1]

    # -- adjacency ---------------------------------------------------------

    @jax.jit
    def successors(self, nodes: jax.Array) -> jax.Array:
        """(N, sigma-1) node ids of successors (0-padded), one column per
        possible next character c in 1..sigma-1. Small-state graphs (no
        edge_lanes) decode node chars with the rank/select bwd walk and
        search through index_edge_ranksel, so traversal (assemble, clean,
        stats) works in both states (reference boss.hpp fwd machinery)."""
        if self.boss.edge_lanes is None:
            return self._adjacent_ranksel(nodes, forward=True)
        B = self.alphabet.bits_per_char
        K = self.k
        lanes = self.node_lanes(nodes)
        shifted = packing.to_next(lanes, K, B, 0)
        cols = []
        for c in range(1, self.alphabet.size):
            q = packed.set_field(
                shifted, 0, jnp.full((shifted.shape[1],), c, jnp.uint32), B)
            edges = self.boss.map_to_edges(q)
            cols.append(self.edge_to_node(edges))
        out = jnp.stack(cols, axis=1)
        return jnp.where((nodes > 0)[:, None], out, 0)

    def _adjacent_ranksel(self, nodes: jax.Array, forward: bool
                          ) -> jax.Array:
        """Rank/select-only adjacency: decode each node's chars, then run
        the tightening edge search on the shifted k-mers per character."""
        K = self.k
        chars = self.boss.node_chars_ranksel(self.node_to_edge(nodes))
        Q = chars.shape[0]
        cols = []
        for c in range(1, self.alphabet.size):
            fill = jnp.full((Q, 1), c, jnp.int32)
            q = (jnp.concatenate([chars[:, 1:], fill], axis=1) if forward
                 else jnp.concatenate([fill, chars[:, :K - 1]], axis=1))
            edges = self.boss.index_edge_ranksel(q)
            cols.append(self.edge_to_node(edges))
        out = jnp.stack(cols, axis=1)
        return jnp.where((nodes > 0)[:, None], out, 0)

    @jax.jit
    def predecessors(self, nodes: jax.Array) -> jax.Array:
        """(N, sigma-1) node ids of predecessors (0-padded)."""
        if self.boss.edge_lanes is None:
            return self._adjacent_ranksel(nodes, forward=False)
        B = self.alphabet.bits_per_char
        K = self.k
        lanes = self.node_lanes(nodes)
        cols = []
        for c in range(1, self.alphabet.size):
            q = packing.to_prev(lanes, K, B, c)
            edges = self.boss.map_to_edges(q)
            cols.append(self.edge_to_node(edges))
        out = jnp.stack(cols, axis=1)
        return jnp.where((nodes > 0)[:, None], out, 0)

    def outdegree(self, nodes: jax.Array) -> jax.Array:
        return jnp.sum(self.successors(nodes) > 0, axis=1)

    def indegree(self, nodes: jax.Array) -> jax.Array:
        return jnp.sum(self.predecessors(nodes) > 0, axis=1)

    # -- node decoding -----------------------------------------------------

    def node_kmers_chars(self, nodes: np.ndarray) -> np.ndarray:
        """(N, k) char codes of the node k-mers."""
        if self.boss.edge_lanes is None:
            edge = self.node_to_edge(jnp.asarray(nodes))
            return np.asarray(self.boss.node_chars_ranksel(edge))
        lanes = self.node_lanes(jnp.asarray(nodes))
        return np.asarray(packing.unpack_to_chars(lanes, self.k,
                                                  self.alphabet.bits_per_char))

    def node_sequence(self, node: int) -> str:
        chars = self.node_kmers_chars(np.array([node]))[0]
        return self.alphabet.decode(chars)




import functools


@functools.partial(jax.jit, static_argnames=("K", "B"))
def _valid_mask_fused(edge_lanes, K: int, B: int):
    is_dummy = packing.contains_sentinel(edge_lanes, K, B)
    return jnp.concatenate([jnp.zeros((1,), bool), ~is_dummy])


@jax.jit
def _bitrank_fused(bits):
    from ..common.ranksel import _pack_bits_device
    words = _pack_bits_device(bits)
    pops = jax.lax.population_count(words).astype(jnp.int32)
    brank = jnp.cumsum(pops) - pops
    total = brank[-1] + pops[-1]
    return words, brank, total


def register_pytrees():
    jax.tree_util.register_dataclass(
        DbgSuccinct, ["boss", "valid_rank"], ["alphabet", "mode"])


register_pytrees()
