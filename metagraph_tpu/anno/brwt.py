"""Multi-BRWT: hierarchical column-grouped binary matrix.

Re-design of the reference Multi-BRWT
(metagraph/src/annotation/binary_matrix/multi_brwt/brwt.hpp:18-75,
brwt_builders.hpp:18-59, clustering.hpp:27-48). Structure is the same —
a tree whose every node stores the OR ("nonzero rows") bitvector of its
column subset over the rows of its parent's support, with leaves owning
single columns — but construction, storage and querying are reshaped
for an accelerator:

  * column clustering: pairwise similarity of subsampled columns is a
    bit-matrix product — computed as one (num_cols, R) x (R, num_cols)
    matmul (bf16 0/1 operands, f32 accumulation: exact below 2^24 rows)
    instead of per-pair popcount loops;
  * storage: all node bitvectors live in ONE packed uint32 word array
    with a per-word rank prefix (`lax.population_count` finishes the
    rank in-word) — 2 bits/bit instead of 32, the blocked-rank layout
    the reference gets from sdsl rank_support;
  * query descent: level-synchronous and fully jitted — per tree level
    ONE device dispatch processes every live (query, node) pair with
    gathers + popcounts, then expands survivors into child pairs with
    an interval-expand scatter. No recursion, no per-node Python.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .matrix import RowSparse


# ---------------------------------------------------------------------------
# construction-time tree (host side)
# ---------------------------------------------------------------------------

@dataclass
class BrwtNode:
    """One tree node during construction: support bits over the parent's
    support rows (bool array, host)."""
    bits: np.ndarray             # (parent_support_size,) bool
    children: List["BrwtNode"]
    column: int = -1             # leaf: original column id

    @property
    def n_local(self) -> int:
        return len(self.bits)

    @property
    def num_set(self) -> int:
        return int(self.bits.sum())


def _pack_words(bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """bool bits -> (uint32 words, int32 per-word exclusive rank)."""
    n = len(bits)
    n_words = max((n + 31) // 32, 1)
    padded = np.zeros(n_words * 32, bool)
    padded[:n] = bits
    words = np.packbits(padded.reshape(-1, 32)[:, ::-1],
                        axis=1)[:, ::-1].copy().view(np.uint32).reshape(-1)
    pops = padded.reshape(-1, 32).sum(axis=1)
    brank = np.concatenate([[0], np.cumsum(pops[:-1])]).astype(np.int32)
    return words, brank


# ---------------------------------------------------------------------------
# flattened device form
# ---------------------------------------------------------------------------

@dataclass
class Brwt:
    """Flattened Multi-BRWT. Node 0 is the root (support over all rows);
    nodes are in BFS order so each node's children are contiguous."""
    parent: np.ndarray           # (M,) int32, -1 for root
    column: np.ndarray           # (M,) int32, -1 internal
    child_lo: np.ndarray         # (M,) int32
    child_hi: np.ndarray         # (M,) int32
    n_local: np.ndarray          # (M,) int32 support size of the PARENT
    word_off: np.ndarray         # (M + 1,) int64 into words/brank
    words: jax.Array             # (W,) uint32 packed node bitvectors
    brank: jax.Array             # (W,) int32 node-relative exclusive rank
    level_bounds: np.ndarray     # (L + 1,) node index range per level
    num_rows: int
    num_cols: int

    # -- stats (reference print_brwt_stats, stats.cpp) ---------------------

    def num_tree_nodes(self) -> int:
        return len(self.parent)

    def num_nodes(self) -> int:
        return len(self.parent)

    def avg_arity(self) -> float:
        internal = (self.child_hi > self.child_lo)
        n_int = int(internal.sum())
        return float((self.child_hi - self.child_lo)[internal].sum()) \
            / n_int if n_int else 0.0

    @property
    def nnz(self) -> int:
        # leaves' set bits
        total = 0
        wo = self.word_off
        words_np = np.asarray(self.words)
        for i in np.nonzero(np.asarray(self.column) >= 0)[0]:
            w = words_np[wo[i]:wo[i + 1]]
            total += int(np.bitwise_count(w).sum()) if hasattr(np, "bitwise_count") \
                else int(sum(bin(int(x)).count("1") for x in w))
        return total

    # -- queries -----------------------------------------------------------

    def _device_arrays(self):
        return (jnp.asarray(self.words), jnp.asarray(self.brank),
                jnp.asarray(self.word_off), jnp.asarray(self.column),
                jnp.asarray(self.child_lo), jnp.asarray(self.child_hi))

    def sum_rows(self, rows, weights) -> np.ndarray:
        """(num_cols,) weighted column hit counts over the query rows —
        the BinaryMatrix::sum_rows role (binary_matrix.cpp), computed by
        the jitted level descent."""
        rows = jnp.asarray(rows, jnp.int32)
        weights = jnp.asarray(weights, jnp.int32)
        counts, _ = self._descend(rows, weights, want_presence=False)
        return np.asarray(counts)

    def presence(self, rows) -> np.ndarray:
        """(Q, num_cols) bool presence matrix (slice_rows role)."""
        rows = jnp.asarray(np.asarray(rows, np.int64), jnp.int32)
        _, pres = self._descend(
            rows, jnp.ones(rows.shape, jnp.int32), want_presence=True)
        return np.asarray(pres)

    def get_rows_dense(self, rows: np.ndarray) -> np.ndarray:
        return self.presence(rows)

    def get_rows(self, rows: np.ndarray) -> List[List[int]]:
        dense = self.get_rows_dense(rows)
        return [list(np.nonzero(r)[0]) for r in dense]

    def to_row_sparse(self) -> RowSparse:
        chunks_r, chunks_c = [], []
        B = 1 << 16
        for s in range(0, self.num_rows, B):
            rows = np.arange(s, min(s + B, self.num_rows))
            dense = self.get_rows_dense(rows)
            r, c = np.nonzero(dense)
            chunks_r.append(r + s)
            chunks_c.append(c)
        if not chunks_r:
            chunks_r, chunks_c = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
        return RowSparse.from_coo(np.concatenate(chunks_r),
                                  np.concatenate(chunks_c),
                                  self.num_rows, self.num_cols)

    # -- serialization -----------------------------------------------------

    def to_npz_dict(self) -> dict:
        return {"brwt_shape": np.array([self.num_rows, self.num_cols]),
                "brwt_parent": self.parent,
                "brwt_column": self.column,
                "brwt_child_lo": self.child_lo,
                "brwt_child_hi": self.child_hi,
                "brwt_n_local": self.n_local,
                "brwt_word_off": self.word_off,
                "brwt_words": np.asarray(self.words),
                "brwt_brank": np.asarray(self.brank),
                "brwt_level_bounds": self.level_bounds}

    @staticmethod
    def from_npz_dict(d) -> "Brwt":
        shape = d["brwt_shape"]
        return Brwt(parent=np.asarray(d["brwt_parent"]),
                    column=np.asarray(d["brwt_column"]),
                    child_lo=np.asarray(d["brwt_child_lo"]),
                    child_hi=np.asarray(d["brwt_child_hi"]),
                    n_local=np.asarray(d["brwt_n_local"]),
                    word_off=np.asarray(d["brwt_word_off"]),
                    words=jnp.asarray(d["brwt_words"]),
                    brank=jnp.asarray(d["brwt_brank"]),
                    level_bounds=np.asarray(d["brwt_level_bounds"]),
                    num_rows=int(shape[0]), num_cols=int(shape[1]))

    # -- host-side reconstruction (relaxation, debugging) ------------------

    def node_bits(self, i: int) -> np.ndarray:
        """Expand node i's bitvector to a host bool array."""
        w = np.asarray(self.words[self.word_off[i]:self.word_off[i + 1]])
        bits = np.unpackbits(w.view(np.uint8), bitorder="little")
        return bits[:self.n_local[i]].astype(bool)


@functools.partial(jax.jit,
                   static_argnames=("num_cols", "cap", "want_presence"))
def _brwt_level_w(dev, w_q, q_idx, node, local, alive, counts, pres,
                  num_cols, cap, want_presence):
    """One level of the batched BRWT descent: probe every live
    (query, node) pair's bit + in-node rank (packed words + per-word
    rank + population_count), accumulate leaf hits, and interval-expand
    survivors into child pairs (capacity `cap`; the returned spawn count
    lets the host retry on overflow)."""
    words, brank, word_off, column, child_lo, child_hi = dev
    base = word_off[node]
    li = jnp.maximum(local, 0)
    wi = (base + (li >> 5)).astype(jnp.int64)
    wi = jnp.clip(wi, 0, words.shape[0] - 1)
    word = words[wi]
    bitpos = (li & 31).astype(jnp.uint32)
    bit = (word >> bitpos) & jnp.uint32(1)
    mask = (jnp.uint32(1) << bitpos) - jnp.uint32(1)
    in_word = jax.lax.population_count(word & mask).astype(jnp.int32)
    rank_ex = brank[wi] + in_word
    survive = alive & (bit == 1) & (local >= 0)
    is_leaf = column[node] >= 0
    leaf_mask = survive & is_leaf
    col_ids = jnp.where(leaf_mask, column[node], num_cols)
    counts = counts + jax.ops.segment_sum(
        jnp.where(leaf_mask, w_q[q_idx], 0).astype(jnp.int32),
        col_ids, num_segments=num_cols + 1)[:num_cols]
    if want_presence:
        flat = jnp.where(leaf_mask,
                         q_idx.astype(jnp.int32) * num_cols
                         + column[node], pres.shape[0] - 1)
        pres = pres.at[flat].max(leaf_mask)
    spawn = survive & ~is_leaf
    n_child = jnp.where(spawn, child_hi[node] - child_lo[node], 0)
    offs = jnp.cumsum(n_child) - n_child
    total = (offs[-1] + n_child[-1]) if n_child.shape[0] else jnp.int32(0)
    slots = jnp.arange(cap, dtype=jnp.int32)
    src0 = jnp.zeros((cap,), jnp.int32)
    put = jnp.where(spawn & (offs < cap), offs, cap - 1)
    src0 = src0.at[put].max(jnp.where(spawn, jnp.arange(
        n_child.shape[0], dtype=jnp.int32) + 1, 0))
    src = jax.lax.cummax(src0) - 1
    src_ok = (src >= 0) & (slots < total)
    src_c = jnp.clip(src, 0, n_child.shape[0] - 1)
    child_rank = slots - offs[src_c]
    nxt_node = child_lo[node[src_c]] + child_rank
    nxt_q = q_idx[src_c]
    nxt_local = rank_ex[src_c]
    nxt_alive = src_ok & spawn[src_c] & (child_rank < n_child[src_c])
    return (nxt_q, nxt_node.astype(jnp.int32),
            jnp.where(nxt_alive, nxt_local, -1).astype(jnp.int32),
            nxt_alive, counts, pres, total)


# rebind Brwt._descend to use the weighted kernel
def _descend_impl(self, rows: jax.Array, weights: jax.Array,
                  want_presence: bool):
    dev = self._device_arrays()
    Q = int(rows.shape[0])
    counts = jnp.zeros((self.num_cols,), jnp.int32)
    pres = jnp.zeros((Q * self.num_cols + 1,), jnp.bool_) \
        if want_presence else jnp.zeros((1,), jnp.bool_)
    q_idx = jnp.arange(Q, dtype=jnp.int32)
    node = jnp.zeros((Q,), jnp.int32)
    local = rows.astype(jnp.int32)
    alive = jnp.ones((Q,), jnp.bool_)
    w_q = weights.astype(jnp.int32)
    cap = max(int(2 ** np.ceil(np.log2(max(Q, 1)))), 16)
    n_levels = len(self.level_bounds) - 1
    state = (q_idx, node, local, alive)
    for _ in range(n_levels):
        q_idx, node, local, alive = state
        out = _brwt_level_w(dev, w_q, q_idx, node, local, alive, counts,
                            pres, num_cols=self.num_cols, cap=cap,
                            want_presence=want_presence)
        needed = int(out[6])
        while needed > cap:
            cap = max(cap * 2,
                      int(2 ** np.ceil(np.log2(max(needed, 2)))))
            out = _brwt_level_w(dev, w_q, q_idx, node, local, alive,
                                counts, pres, num_cols=self.num_cols,
                                cap=cap, want_presence=want_presence)
            needed = int(out[6])
        state = (out[0], out[1], out[2], out[3])
        counts, pres = out[4], out[5]
        if needed == 0:
            break
    if want_presence:
        pres = pres[:Q * self.num_cols].reshape(Q, self.num_cols)
    return counts, pres


Brwt._descend = _descend_impl


# ---------------------------------------------------------------------------
# flattening (tree -> device arrays)
# ---------------------------------------------------------------------------

def flatten_tree(root_bits: np.ndarray, root_children: List[BrwtNode],
                 num_rows: int, num_cols: int) -> Brwt:
    """BFS-flatten a construction tree into the packed query form.
    Node 0 is the root whose bitvector is its support over all rows."""
    # BFS order so children of each node are contiguous
    nodes: List[Tuple[BrwtNode, int, int]] = []   # (node, parent, level)
    order: List[BrwtNode] = []
    root = BrwtNode(bits=root_bits, children=root_children, column=-1)
    queue = [(root, -1, 0)]
    while queue:
        nxt = []
        for n, par, lvl in queue:
            nodes.append((n, par, lvl))
        for idx, (n, par, lvl) in enumerate(nodes[len(nodes) - len(queue):],
                                            start=len(nodes) - len(queue)):
            for c in n.children:
                nxt.append((c, idx, lvl + 1))
        queue = nxt
    M = len(nodes)
    parent = np.full(M, -1, np.int32)
    column = np.full(M, -1, np.int32)
    level = np.zeros(M, np.int32)
    n_local = np.zeros(M, np.int32)
    child_lo = np.zeros(M, np.int32)
    child_hi = np.zeros(M, np.int32)
    words_l, brank_l = [], []
    word_off = np.zeros(M + 1, np.int64)
    for i, (n, par, lvl) in enumerate(nodes):
        parent[i] = par
        column[i] = n.column
        level[i] = lvl
        n_local[i] = len(n.bits)
        w, b = _pack_words(np.asarray(n.bits, bool))
        words_l.append(w)
        brank_l.append(b)
        word_off[i + 1] = word_off[i] + len(w)
    # children ranges: BFS order -> contiguous
    for i, (n, par, lvl) in enumerate(nodes):
        if par >= 0:
            if child_hi[par] == 0:
                child_lo[par] = i
            child_hi[par] = i + 1
    n_levels = int(level.max()) + 1 if M else 1
    level_bounds = np.searchsorted(level, np.arange(n_levels + 1))
    return Brwt(parent=parent, column=column, child_lo=child_lo,
                child_hi=child_hi, n_local=n_local, word_off=word_off,
                words=jnp.asarray(np.concatenate(words_l)
                                  if words_l else np.zeros(0, np.uint32)),
                brank=jnp.asarray(np.concatenate(brank_l)
                                  if brank_l else np.zeros(0, np.int32)),
                level_bounds=level_bounds.astype(np.int64),
                num_rows=num_rows, num_cols=num_cols)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def _column_bitmaps(matrix: RowSparse) -> List[np.ndarray]:
    """Per-column sorted row-index arrays."""
    rows = np.asarray(matrix.rows)
    cols = np.asarray(matrix.cols)
    order = np.argsort(cols, kind="stable")
    rows_s, cols_s = rows[order], cols[order]
    bounds = np.searchsorted(cols_s, np.arange(matrix.num_cols + 1))
    return [np.sort(rows_s[bounds[c]:bounds[c + 1]])
            for c in range(matrix.num_cols)]


@jax.jit
def _sim_block_step(S, packed_blk):
    """S += M_blk @ M_blk.T with M_blk unpacked on device from
    little-endian bit-packed uint8 words (a fixed row permutation of
    the subsample — similarity is permutation-invariant)."""
    b = packed_blk
    M = ((b[:, :, None] >> jnp.arange(8, dtype=jnp.uint8)[None, None, :])
         & jnp.uint8(1)).reshape(b.shape[0], -1).astype(jnp.bfloat16)
    return S + jnp.dot(M, M.T, preferred_element_type=jnp.float32)


def greedy_linkage(columns: List[np.ndarray], num_rows: int,
                   subsample: int = 1_000_000,
                   seed: int = 0) -> List[Tuple[int, int]]:
    """Greedy similarity pairing (reference greedy_matching /
    agglomerative_greedy_linkage, clustering.cpp). Similarity of two
    columns = popcount of AND over subsampled rows — computed for ALL
    pairs at once as S = M @ M.T with M the (cols, rows) 0/1 matrix, an
    MXU matmul instead of the reference's per-pair word loops."""
    n = len(columns)
    if n <= 1:
        return []
    rng = np.random.default_rng(seed)
    if num_rows > subsample:
        keep = np.sort(rng.choice(num_rows, subsample, replace=False))
    else:
        keep = np.arange(num_rows)
    # bit-packed sketches, N*R/8 bytes host-side (reference parity,
    # README.md:94 / clustering.cpp) — NOT a dense float matrix (which
    # is 32x larger: 40 GB at the reference defaults)
    W = -(-len(keep) // 8)
    Mp = np.zeros((n, W), np.uint8)
    for i, col in enumerate(columns):
        mask = np.isin(keep, col, assume_unique=True)
        Mp[i] = np.packbits(mask, bitorder="little")
    # similarity S = M @ M.T accumulated on device in row-block tiles:
    # each tile unpacks (n, 8*blk_words) 0/1 bits to bf16 and hits the
    # MXU with f32 accumulation; peak device memory is one tile + S
    blk_words = max(1024, min(W, (1 << 23) // max(n, 1)))
    S_d = jnp.zeros((n, n), jnp.float32)
    for w0 in range(0, W, blk_words):
        S_d = _sim_block_step(S_d, jnp.asarray(Mp[:, w0:w0 + blk_words]))
    S = np.array(S_d)       # writable copy (fill_diagonal below)
    np.fill_diagonal(S, -1.0)
    pairs = []
    used = np.zeros(n, bool)
    order = np.dstack(np.unravel_index(np.argsort(-S, axis=None),
                                       S.shape))[0]
    for i, j in order:
        if i < j and not used[i] and not used[j]:
            pairs.append((int(i), int(j)))
            used[i] = used[j] = True
        if used.sum() >= n - 1:
            break
    return pairs


def compute_linkage(matrix: RowSparse, subsample: int = 1_000_000
                    ) -> List[Tuple[int, int, float, int]]:
    """Column linkage rows ``(child1, child2, dist, merged_id)`` in the
    reference's format (transform_annotation.cpp:parse_linkage_matrix:
    leaves are column ids 0..n-1, merged ids grow past n). Produced by
    the same level-by-level greedy pairing build_brwt uses, so feeding
    the file back via --linkage-file reproduces the same tree."""
    num_rows, num_cols = matrix.num_rows, matrix.num_cols
    col_rows = _column_bitmaps(matrix)
    ids = list(range(num_cols))
    supports: List[np.ndarray] = [col_rows[c] for c in range(num_cols)]
    next_id = num_cols
    out = []
    while len(ids) > 1:
        pairs = greedy_linkage(supports, num_rows, subsample)
        if not pairs:
            pairs = [(i, i + 1) for i in range(0, len(ids) - 1, 2)]
        merged_ids, merged_supports = [], []
        used = set()
        for i, j in pairs:
            out.append((ids[i], ids[j], 0.0, next_id))
            merged_ids.append(next_id)
            next_id += 1
            merged_supports.append(np.union1d(supports[i], supports[j]))
            used.add(i)
            used.add(j)
        for i in range(len(ids)):
            if i not in used:
                merged_ids.append(ids[i])
                merged_supports.append(supports[i])
        ids, supports = merged_ids, merged_supports
    return out


def _trees_from_linkage(linkage, num_cols: int):
    """Tree tuples from parsed linkage rows. A merged cluster id may
    appear on several rows (the reference encodes multi-child clusters
    that way, parse_linkage_matrix): children accumulate."""
    nodes = {c: ("leaf", c) for c in range(num_cols)}
    for c1, c2, _dist, m in sorted(linkage, key=lambda r: r[3]):
        m = int(m)
        kids = list(nodes[m][1:]) if m in nodes else []
        for c in (int(c1), int(c2)):
            if c not in nodes:
                raise ValueError(f"linkage references unknown cluster {c}")
            kids.append(nodes.pop(c))
        nodes[m] = ("node", *kids)
    return list(nodes.values())


def build_brwt(matrix: RowSparse, arity: int = 2,
               subsample: int = 1_000_000,
               linkage: Optional[List[Tuple[int, int, float, int]]] = None
               ) -> Brwt:
    """Bottom-up Multi-BRWT build (BRWTBottomUpBuilder semantics):
    greedily pair similar columns level by level until one root (or
    follow a precomputed ``linkage``), then flatten into the packed
    device form."""
    num_rows, num_cols = matrix.num_rows, matrix.num_cols
    col_rows = _column_bitmaps(matrix)

    # the greedy path is compute_linkage + tree reconstruction, so a
    # linkage file written by --linkage reproduces the same tree exactly
    if linkage is None and num_cols > 1:
        linkage = compute_linkage(matrix, subsample)
    trees = _trees_from_linkage(linkage or [], num_cols)
    while len(trees) > 1:         # forest: join remaining roots pairwise
        trees = [("node", *trees[i:i + 2]) if i + 1 < len(trees)
                 else trees[i] for i in range(0, len(trees), 2)]
    if matrix.nnz:
        root_support = np.unique(np.asarray(matrix.rows).astype(np.int64))
    else:
        root_support = np.zeros(0, np.int64)
    root_bits = np.zeros(num_rows, bool)
    root_bits[root_support.astype(np.int64)] = True

    support_cache: Dict[int, np.ndarray] = {}

    def collect_support(tree) -> np.ndarray:
        key = id(tree)
        if key in support_cache:
            return support_cache[key]
        if tree[0] == "leaf":
            s = col_rows[tree[1]]
        else:
            s = np.zeros(0, np.int64)
            for t in tree[1:]:
                s = np.union1d(s, collect_support(t))
        support_cache[key] = s
        return s

    def build_node(tree, parent_support: np.ndarray) -> BrwtNode:
        support = collect_support(tree)
        bits = np.isin(parent_support, support, assume_unique=True)
        if tree[0] == "leaf":
            return BrwtNode(bits=bits, children=[], column=tree[1])
        node = BrwtNode(bits=bits, children=[], column=-1)
        node.children = [build_node(t, support) for t in tree[1:]]
        return node

    if not trees:
        return flatten_tree(root_bits, [], num_rows, num_cols)
    root_tree = trees[0]
    if root_tree[0] == "leaf":
        children = [build_node(root_tree, root_support)]
    else:
        children = [build_node(t, root_support) for t in root_tree[1:]]
    return flatten_tree(root_bits, children, num_rows, num_cols)


def relax_brwt(brwt: Brwt, max_arity: int = 8) -> Brwt:
    """Arity relaxation (reference BRWTOptimizer / `relax_brwt` CLI):
    collapse chains of internal nodes into wider nodes up to max_arity,
    re-ranking child bitvectors into the grandparent's support."""
    # reconstruct the host tree from the flat form
    def rebuild(i: int) -> BrwtNode:
        kids = [rebuild(j) for j in range(brwt.child_lo[i],
                                          brwt.child_hi[i])]
        return BrwtNode(bits=brwt.node_bits(i), children=kids,
                        column=int(brwt.column[i]))

    root_kids = [rebuild(j) for j in range(brwt.child_lo[0],
                                           brwt.child_hi[0])]
    root_bits = brwt.node_bits(0)

    def relax(node: BrwtNode) -> BrwtNode:
        node.children = [relax(c) for c in node.children]
        changed = True
        while changed:
            changed = False
            for i, c in enumerate(node.children):
                if c.column < 0 and c.children and \
                        len(node.children) - 1 + len(c.children) <= max_arity:
                    set_pos = np.nonzero(c.bits)[0]
                    lifted = []
                    for gc in c.children:
                        bits = np.zeros(c.n_local, bool)
                        bits[set_pos] = gc.bits
                        lifted.append(BrwtNode(bits=bits,
                                               children=gc.children,
                                               column=gc.column))
                    node.children = (node.children[:i] + lifted
                                     + node.children[i + 1:])
                    changed = True
                    break
        return node

    fake = BrwtNode(bits=root_bits, children=root_kids, column=-1)
    relaxed = relax(fake)
    return flatten_tree(root_bits, relaxed.children,
                        brwt.num_rows, brwt.num_cols)
