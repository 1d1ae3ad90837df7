"""Unitig / contig extraction by parallel list ranking.

The reference extracts unitigs with a sequential DFS over the BOSS table
(metagraph/src/graph/representation/succinct/boss.cpp:2042+,
sequence_graph.cpp call_unitigs). That is inherently serial; the device
formulation exploits that unitigs are *chains* of the unique-successor
function:

  1. build ``next[v]`` = unique successor w of v with indeg(w) == 1 and
     outdeg(v) == 1 (0 otherwise) — one vectorized adjacency pass;
  2. pointer-double over ``prev`` (the inverse of ``next``) to find each
     node's chain start and position: O(log N) rounds of gathers;
  3. pure cycles (no start) are broken at their minimum node id, found by
     min-propagation during the same doubling;
  4. unitig strings are materialized with two scatters (start k-mers +
     one char per interior node) into one flat char buffer.

Every step is a dense map/gather/scatter/segment op — the DFS is gone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kmer import packing
from .dbg_succinct import DbgSuccinct


@dataclass
class Unitigs:
    """Unitig decomposition: per-node chain id + position, per-chain data."""
    chain_id: np.ndarray      # (N+1,) int32; 0 unused
    pos: np.ndarray           # (N+1,) int32 position within chain
    starts: np.ndarray        # (num_chains,) start node per chain
    lengths: np.ndarray       # (num_chains,) nodes per chain
    is_cycle: np.ndarray      # (num_chains,) bool

    @property
    def num_unitigs(self) -> int:
        return len(self.starts)


def _next_links(g: DbgSuccinct) -> Tuple[jax.Array, jax.Array]:
    """(next, prev) arrays over 1..N (0 = chain boundary)."""
    N = g.num_nodes()
    nodes = jnp.arange(1, N + 1, dtype=jnp.int32)
    succ = g.successors(nodes)                      # (N, sigma-1)
    outdeg = jnp.sum(succ > 0, axis=1)
    uniq_succ = jnp.sum(succ, axis=1)               # valid when outdeg == 1
    indeg = jax.ops.segment_sum(
        jnp.ones_like(succ).reshape(-1),
        succ.reshape(-1), num_segments=N + 1)
    nxt_body = jnp.where(
        (outdeg == 1) & (uniq_succ > 0) & (indeg[uniq_succ] == 1),
        uniq_succ, 0)
    nxt = jnp.concatenate([jnp.zeros((1,), jnp.int32), nxt_body.astype(jnp.int32)])
    prv = jnp.zeros((N + 1,), jnp.int32)
    # next is injective on its support -> scatter builds the inverse
    prv = prv.at[nxt].set(jnp.arange(N + 1, dtype=jnp.int32))
    prv = prv.at[0].set(0)
    return nxt, prv


@jax.jit
def _rank_chains(prv: jax.Array):
    """Pointer doubling over ``prv``: chain start, position, cycle leaders."""
    N1 = prv.shape[0]
    steps = max(1, int(np.ceil(np.log2(max(N1, 2)))))
    ids = jnp.arange(N1, dtype=jnp.int32)
    parent = jnp.where(prv > 0, prv, ids)
    mins = jnp.minimum(ids, parent)

    def body(_, state):
        parent, mins = state
        pp = parent[parent]
        mins = jnp.minimum(mins, mins[parent])
        return pp, mins

    parent, mins = jax.lax.fori_loop(0, steps, body, (parent, mins))
    in_cycle = prv[parent] > 0          # final parent is not a root
    leader = jnp.where(in_cycle, mins, parent)
    # break each cycle at its leader, then re-rank positions
    prv2 = jnp.where(in_cycle & (ids == leader), 0, prv)
    parent2 = jnp.where(prv2 > 0, prv2, ids)
    dist = jnp.where(prv2 > 0, 1, 0).astype(jnp.int32)

    def body2(_, state):
        parent, dist = state
        dist = dist + dist[parent]
        parent = parent[parent]
        return parent, dist

    parent2, dist = jax.lax.fori_loop(0, steps, body2, (parent2, dist))
    return parent2, dist, in_cycle


def unitig_decomposition(g: DbgSuccinct) -> Unitigs:
    nxt, prv = _next_links(g)
    start_of, pos, in_cycle = _rank_chains(prv)
    start_of = np.asarray(start_of)
    pos = np.asarray(pos)
    in_cycle = np.asarray(in_cycle)
    N = g.num_nodes()
    is_start = np.zeros(N + 1, bool)
    is_start[start_of[1:]] = True
    is_start[0] = False
    starts = np.nonzero(is_start)[0].astype(np.int32)
    chain_rank = np.zeros(N + 1, np.int32)
    chain_rank[starts] = np.arange(len(starts), dtype=np.int32)
    chain_id = chain_rank[start_of]
    lengths = np.zeros(len(starts), np.int32)
    np.maximum.at(lengths, chain_id[1:], pos[1:] + 1)
    cyc = np.zeros(len(starts), bool)
    cyc[chain_id[1:]] = in_cycle[1:]
    return Unitigs(chain_id=chain_id, pos=pos, starts=starts,
                   lengths=lengths, is_cycle=cyc)


def unitig_ends(g: DbgSuccinct, u: Unitigs) -> np.ndarray:
    """Last node of each chain (pos == length - 1)."""
    last_nodes = np.zeros(u.num_unitigs, np.int32)
    nodes = np.arange(1, g.num_nodes() + 1, dtype=np.int32)
    sel = u.pos[1:] == (u.lengths[u.chain_id[1:]] - 1)
    last_nodes[u.chain_id[1:][sel]] = nodes[sel]
    return last_nodes


def unitig_keep_mask(g: DbgSuccinct, u: Unitigs, min_tip_size: int,
                     weights: Optional[np.ndarray] = None,
                     min_median_abundance: int = 1) -> np.ndarray:
    """Per-unitig keep decision matching the reference's tip filter
    (sequence_graph.cpp:208-211: keep iff the unitig is long —
    path length >= min_tip_size — or not a tip —
    indegree(start) + outdegree(end) >= 2) and the unreliable-unitig
    median-abundance filter (graph_cleaning.cpp:14)."""
    keep = np.ones(u.num_unitigs, bool)
    if min_tip_size > 1:
        ends = unitig_ends(g, u)
        ind = np.asarray(g.indegree(jnp.asarray(u.starts)))
        outd = np.asarray(g.outdegree(jnp.asarray(ends)))
        is_tip = (ind + outd) < 2
        short = u.lengths < min_tip_size
        keep &= ~(short & is_tip)
    if min_median_abundance > 1 and weights is not None:
        # unreliable iff strictly more than half the path k-mers are below
        # the threshold (graph_cleaning.cpp:23-31)
        w = np.asarray(weights)
        weak = (w[1:] < min_median_abundance).astype(np.int64)
        num_weak = np.zeros(u.num_unitigs, np.int64)
        np.add.at(num_weak, u.chain_id[1:], weak)
        keep &= ~(num_weak * 2 > u.lengths)
    return keep


def single_form_mask(g: DbgSuccinct) -> np.ndarray:
    """(N+1,) bool: keep each rc-pair's smaller-packed orientation once
    (the role of kmers_in_single_form in the reference's call_paths,
    sequence_graph.cpp:216-270 — any one-per-pair cover is equivalent
    after a canonical rebuild)."""
    from ..kmer import packing as kp
    from ..common import packed
    N = g.num_nodes()
    nodes = jnp.arange(1, N + 1, dtype=jnp.int32)
    lanes = g.node_lanes(nodes)
    B = g.alphabet.bits_per_char
    rc = kp.reverse_complement(lanes, g.k, B, g.alphabet.complement)
    keep = np.asarray(packed.le(lanes, rc))
    mask = np.zeros(N + 1, bool)
    mask[1:] = keep
    return mask


def unitig_paths(g: DbgSuccinct, u: Unitigs) -> List[np.ndarray]:
    """Node id path per unitig (host-side, for GFA/weights emit)."""
    order = np.lexsort((u.pos[1:], u.chain_id[1:]))
    nodes = np.arange(1, g.num_nodes() + 1, dtype=np.int32)[order]
    bounds = np.concatenate([[0], np.cumsum(u.lengths)])
    return [nodes[bounds[c]:bounds[c + 1]] for c in range(u.num_unitigs)]


def unitig_sequences(g: DbgSuccinct, u: Optional[Unitigs] = None,
                     min_length: int = 0, apply_mask: bool = True,
                     keep: Optional[np.ndarray] = None,
                     return_paths: bool = False):
    """Materialize unitig strings (node path of length n -> n + k - 1 chars).
    ``keep``: optional per-unitig bool filter; ``return_paths`` also yields
    the node-id path of each emitted unitig."""
    if u is None:
        u = unitig_decomposition(g)
    k = g.k
    if u.num_unitigs == 0:
        return ([], []) if return_paths else []
    out_lens = u.lengths + k - 1
    offsets = np.concatenate([[0], np.cumsum(out_lens)]).astype(np.int64)
    total = int(offsets[-1])
    buf = np.zeros(total, np.uint8)
    # chars of every node's k-mer
    N = g.num_nodes()
    nodes = np.arange(1, N + 1, dtype=np.int32)
    chars = g.node_kmers_chars(nodes)              # (N, k)
    cid = u.chain_id[1:]
    pos = u.pos[1:]
    # interior nodes contribute their final char at offset + pos + k - 1
    buf[offsets[cid] + pos + k - 1] = chars[:, k - 1]
    # start nodes contribute their full k-mer
    smask = pos == 0
    srows = np.nonzero(smask)[0]
    for j in range(k):
        buf[offsets[cid[srows]] + j] = chars[srows, j]
    letters = np.frombuffer(g.alphabet.letters.encode(), np.uint8)
    decoded = letters[buf]
    # on a masked graph, masked-out nodes are isolated singleton chains: skip
    mask = getattr(g, "mask", None) if apply_mask else None
    paths = unitig_paths(g, u) if return_paths else None
    out = []
    out_paths = []
    for c in range(u.num_unitigs):
        if mask is not None and not mask[u.starts[c]]:
            continue
        if keep is not None and not keep[c]:
            continue
        if u.lengths[c] + k - 1 >= max(min_length, k):
            out.append(decoded[offsets[c]:offsets[c + 1]].tobytes())
            if return_paths:
                out_paths.append(paths[c])
    return (out, out_paths) if return_paths else out


def contig_sequences(g: DbgSuccinct, return_paths: bool = False):
    """Contigs (call_sequences): greedy node-disjoint path cover that may
    run through branches (reference sequence_graph.cpp:call_sequences).

    Round-1 approach: start from the unitig decomposition and greedily
    join unitigs end-to-start on the host when the joint is unused —
    contigs are a covering, not canonical, so any valid cover matches the
    reference's guarantees (every node appears exactly once)."""
    u = unitig_decomposition(g)
    if u.num_unitigs == 0:
        return ([], []) if return_paths else []
    k = g.k
    mask = getattr(g, "mask", None)
    seqs = unitig_sequences(g, u, apply_mask=False)
    paths = unitig_paths(g, u) if return_paths else None
    last_nodes = unitig_ends(g, u).astype(np.int32)
    succ = np.asarray(g.successors(jnp.asarray(last_nodes)))
    U = u.num_unitigs
    # vectorized greedy tail->head matching (any maximal-ish matching is a
    # valid cover): map successor nodes to chain ids, then up to sigma-1
    # propose/resolve rounds — each round every unmatched tail proposes its
    # first still-free head candidate and each head keeps its lowest tail
    chain_of_start = np.full(int(g.num_nodes()) + 1, -1, np.int64)
    chain_of_start[u.starts] = np.arange(U)
    cand = chain_of_start[np.clip(succ, 0, g.num_nodes())]   # (U, sigma-1)
    cand[succ <= 0] = -1
    tails = np.arange(U)
    eligible_tail = ~u.is_cycle
    if mask is not None:
        eligible_tail &= mask[u.starts]
    ok = (cand >= 0) & (cand != tails[:, None]) & eligible_tail[:, None]
    ok &= np.where(cand >= 0, ~u.is_cycle[np.clip(cand, 0, None)], False)
    used_head = np.zeros(U, bool)
    next_chain = np.full(U, -1, np.int64)
    for _ in range(succ.shape[1]):
        avail = ok & ~used_head[np.clip(cand, 0, None)] & (cand >= 0)
        avail &= (next_chain[:, None] < 0)
        has = avail.any(axis=1)
        if not has.any():
            break
        pick = cand[tails, np.argmax(avail, axis=1)]          # (U,)
        pick = np.where(has, pick, -1)
        # resolve head conflicts: lowest tail wins each head
        order = np.lexsort((tails, pick))
        p_sorted, t_sorted = pick[order], tails[order]
        win_first = np.concatenate([[True], p_sorted[1:] != p_sorted[:-1]])
        winners = (p_sorted >= 0) & win_first
        next_chain[t_sorted[winners]] = p_sorted[winners]
        used_head[p_sorted[winners]] = True
    out = []
    out_paths = []
    emitted = np.zeros(u.num_unitigs, bool)
    for c in range(u.num_unitigs):
        if used_head[c] or emitted[c] or \
                (mask is not None and not mask[u.starts[c]]):
            continue
        parts = [seqs[c]]
        pparts = [paths[c]] if return_paths else None
        emitted[c] = True
        cn = next_chain[c]
        while cn >= 0 and not emitted[cn]:
            parts.append(seqs[cn][k - 1:])
            if return_paths:
                pparts.append(paths[cn])
            emitted[cn] = True
            cn = next_chain[cn]
        out.append(b"".join(parts))
        if return_paths:
            out_paths.append(np.concatenate(pparts))
    for c in range(u.num_unitigs):
        if not emitted[c] and (mask is None or mask[u.starts[c]]):
            out.append(seqs[c])
            if return_paths:
                out_paths.append(paths[c])
    return (out, out_paths) if return_paths else out
