"""RowDiff: annotation delta-compression along graph paths.

Re-design of the reference RowDiff
(metagraph/src/annotation/binary_matrix/row_diff/row_diff.hpp:29-230 and
the 3-stage out-of-core builder, row_diff_builder.cpp:322-688). Each
annotation row is replaced by its XOR against its graph successor's row,
except at *anchor* rows which store full rows; queries walk successor
chains XOR-accumulating until an anchor.

Device formulation:
  * successor assignment + anchor placement: the same pointer-doubling
    machinery as unitig extraction (graph/traversal.py) computes each
    node's distance to its chain root in O(log N) gather rounds; anchors
    are placed at every ``max_length``-th position and at terminals, and
    cycles are broken at their min-node leader — replacing the
    reference's sequential traverses (boss.cpp row_diff_traverse);
  * delta construction: rows XOR successor-rows = one sorted concat of
    (row, col) pairs where duplicates cancel — a sort + neighbor-compare,
    no per-row set operations;
  * query: dense (Q, num_cols) XOR accumulation over at most max_length
    batched steps, each one gather of the diff matrix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .matrix import RowSparse

DEFAULT_MAX_LENGTH = 64


def _interval_expand(lo: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Vectorized concatenation of [lo[i], lo[i]+sizes[i]) ranges."""
    total = int(sizes.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    starts = np.repeat(lo.astype(np.int64), sizes)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(sizes) - sizes, sizes)
    return starts + offs



@dataclass
class RowDiff:
    diffs: RowSparse             # sparse XOR deltas (full rows at anchors)
    anchor: np.ndarray           # (num_rows,) bool
    succ: np.ndarray             # (num_rows,) int64 successor row (-1 none)
    max_length: int

    @property
    def num_rows(self) -> int:
        return self.diffs.num_rows

    @property
    def num_cols(self) -> int:
        return self.diffs.num_cols

    @property
    def nnz(self) -> int:
        return self.diffs.nnz

    def num_anchors(self) -> int:
        return int(self.anchor.sum())

    @property
    def _max_row_nnz(self) -> int:
        if not hasattr(self, "_max_row_nnz_cache"):
            r = np.asarray(self.diffs.rows)
            object.__setattr__(self, "_max_row_nnz_cache",
                               int(np.bincount(r).max()) if len(r) else 1)
        return self._max_row_nnz_cache

    # -- queries -----------------------------------------------------------

    def _walk_inputs(self, rows) -> Tuple[jax.Array, jax.Array, jax.Array,
                                          int, int]:
        rows_d = jnp.asarray(np.asarray(rows, np.int64), jnp.int32)
        anchor_d = jnp.asarray(self.anchor)
        succ_d = jnp.asarray(self.succ.astype(np.int32))
        cap = max(1, int(rows_d.shape[0]) * max(self._max_row_nnz, 1))
        cap = 1 << (cap - 1).bit_length()
        return rows_d, anchor_d, succ_d, cap, self.max_length + 1

    def get_rows_dense(self, rows: np.ndarray) -> np.ndarray:
        """(Q, num_cols) bool — the whole anchor-walk XOR accumulation is
        ONE jitted dispatch: a fori_loop of masked interval-expand
        presence gathers (reference row_diff.hpp:153-221; replaces the
        round-1 host-numpy per-step loop)."""
        rows_d, anchor_d, succ_d, cap, steps = self._walk_inputs(rows)
        acc = _rd_walk_bits(self.diffs, anchor_d, succ_d, rows_d,
                            cap=cap, steps=steps)
        return np.asarray(acc)

    def presence(self, rows) -> np.ndarray:
        return self.get_rows_dense(np.asarray(rows))

    def sum_rows(self, rows, weights) -> np.ndarray:
        rows_d, anchor_d, succ_d, cap, steps = self._walk_inputs(rows)
        acc = _rd_walk_bits(self.diffs, anchor_d, succ_d, rows_d,
                            cap=cap, steps=steps)
        w = jnp.asarray(np.asarray(weights), jnp.int32)
        return np.asarray((acc * w[:, None]).sum(axis=0))

    def get_rows(self, rows: np.ndarray) -> List[List[int]]:
        dense = self.get_rows_dense(rows)
        return [list(np.nonzero(r)[0]) for r in dense]

    def to_row_sparse(self) -> RowSparse:
        chunks_r, chunks_c = [], []
        B = 1 << 15
        for s in range(0, self.num_rows, B):
            rows = np.arange(s, min(s + B, self.num_rows))
            dense = self.get_rows_dense(rows)
            r, c = np.nonzero(dense)
            chunks_r.append(r + s)
            chunks_c.append(c)
        return RowSparse.from_coo(np.concatenate(chunks_r),
                                  np.concatenate(chunks_c),
                                  self.num_rows, self.num_cols)

    # -- serialization -----------------------------------------------------

    def to_npz_dict(self) -> dict:
        d = self.diffs.to_npz_dict(prefix="rd_")
        d["rd_anchor_prefix"] = np.packbits(self.anchor)
        d["rd_anchor_len"] = np.array(len(self.anchor))
        d["rd_succ"] = self.succ
        d["rd_max_length"] = np.array(self.max_length)
        return d

    @staticmethod
    def from_npz_dict(d) -> "RowDiff":
        n = int(d["rd_anchor_len"])
        anchor = np.unpackbits(d["rd_anchor_prefix"])[:n].astype(bool)
        return RowDiff(diffs=RowSparse.from_npz_dict(d, prefix="rd_"),
                       anchor=anchor,
                       succ=np.asarray(d["rd_succ"]),
                       max_length=int(d["rd_max_length"]))


import functools


@functools.partial(jax.jit, static_argnames=("cap", "steps"))
def _rd_walk_bits(diffs: RowSparse, anchor_d, succ_d, rows0, cap, steps):
    """Batched anchor walk with XOR accumulation — one compiled dispatch
    for the whole walk (masked fixed shapes; done rows probe an
    out-of-range sentinel whose delta is empty)."""
    Q = rows0.shape[0]
    sentinel = jnp.int32(diffs.num_rows + 1)
    nmax = jnp.int32(max(diffs.num_rows - 1, 0))

    def body(_, state):
        acc, cur, done = state
        probe = jnp.where(done, sentinel, cur)
        delta = diffs.presence(probe, capacity=cap)
        acc = acc ^ (delta & ~done[:, None])
        curc = jnp.clip(cur, 0, nmax)
        done = done | (anchor_d[curc] & ~done)
        nxt = succ_d[curc]
        done = done | ((nxt < 0) & ~done)
        cur = jnp.where(done, cur, nxt)
        return acc, cur, done

    acc0 = jnp.zeros((Q, diffs.num_cols), bool)
    acc, _, _ = jax.lax.fori_loop(
        0, steps, body,
        (acc0, rows0, jnp.zeros((Q,), bool)))
    return acc


@functools.partial(jax.jit, static_argnames=("cap", "steps"))
def _rd_walk_vals(diffs: RowSparse, anchor_d, succ_d, rows0, cap, steps):
    """Batched anchor walk summing integer deltas (IntRowDiff query),
    one compiled dispatch."""
    Q = rows0.shape[0]
    sentinel = jnp.int32(diffs.num_rows + 1)
    nmax = jnp.int32(max(diffs.num_rows - 1, 0))

    def body(_, state):
        acc, cur, done = state
        probe = jnp.where(done, sentinel, cur)
        delta = diffs.values_dense(probe, capacity=cap)
        acc = acc + jnp.where(done[:, None], 0, delta)
        curc = jnp.clip(cur, 0, nmax)
        done = done | (anchor_d[curc] & ~done)
        nxt = succ_d[curc]
        done = done | ((nxt < 0) & ~done)
        cur = jnp.where(done, cur, nxt)
        return acc, cur, done

    acc0 = jnp.zeros((Q, diffs.num_cols), jnp.int32)
    acc, _, _ = jax.lax.fori_loop(
        0, steps, body,
        (acc0, rows0, jnp.zeros((Q,), bool)))
    return acc


@dataclass
class IntRowDiff:
    """Integer (count) annotations delta-compressed along graph paths
    (reference IntRowDiff, int_matrix/row_diff/int_row_diff.hpp:48):
    each non-anchor row stores val - val(succ) per label; walks sum the
    deltas, telescoping to the true value at the anchor."""
    rows: np.ndarray             # (nnz,) int64 sorted
    cols: np.ndarray             # (nnz,) int32
    vals: np.ndarray             # (nnz,) int64 (deltas; may be negative)
    anchor: np.ndarray
    succ: np.ndarray
    max_length: int
    num_rows: int
    num_cols: int

    @property
    def nnz(self) -> int:
        return len(self.rows)

    @property
    def _diffs(self) -> RowSparse:
        """Device RowSparse view over the delta triples (cached)."""
        if not hasattr(self, "_diffs_cache"):
            object.__setattr__(self, "_diffs_cache", RowSparse(
                rows=jnp.asarray(self.rows.astype(np.int32)),
                cols=jnp.asarray(self.cols.astype(np.int32)),
                num_rows=self.num_rows, num_cols=self.num_cols,
                values=jnp.asarray(self.vals.astype(np.int32))))
        return self._diffs_cache

    @property
    def _max_row_nnz(self) -> int:
        if not hasattr(self, "_max_row_nnz_cache"):
            r = np.asarray(self.rows)
            object.__setattr__(self, "_max_row_nnz_cache",
                               int(np.bincount(r).max()) if len(r) else 1)
        return self._max_row_nnz_cache

    def get_row_values_dense(self, rows: np.ndarray) -> np.ndarray:
        """(Q, num_cols) values — the whole delta-summing anchor walk is
        one jitted dispatch (replaces the round-1 host per-step loop)."""
        rows_d = jnp.asarray(np.asarray(rows, np.int64), jnp.int32)
        cap = max(1, int(rows_d.shape[0]) * max(self._max_row_nnz, 1))
        cap = 1 << (cap - 1).bit_length()
        acc = _rd_walk_vals(self._diffs, jnp.asarray(self.anchor),
                            jnp.asarray(self.succ.astype(np.int32)),
                            rows_d, cap=cap, steps=self.max_length + 1)
        return np.asarray(acc).astype(np.int64)

    def presence(self, rows) -> np.ndarray:
        return self.get_row_values_dense(np.asarray(rows)) > 0

    def sum_rows(self, rows, weights) -> np.ndarray:
        dense = self.presence(rows)
        return (dense * np.asarray(weights)[:, None]).sum(axis=0)

    def sum_row_values(self, rows, weights) -> np.ndarray:
        dense = self.get_row_values_dense(np.asarray(rows))
        return (dense * np.asarray(weights)[:, None]).sum(axis=0)

    def row_values_list(self, rows: np.ndarray):
        """(cols, values) pairs over requested rows (quantile queries)."""
        dense = self.get_row_values_dense(rows)
        q, c = np.nonzero(dense)
        return c, dense[q, c]

    def to_npz_dict(self) -> dict:
        return {"ird_rows": self.rows, "ird_cols": self.cols,
                "ird_vals": self.vals,
                "ird_anchor": np.packbits(self.anchor),
                "ird_anchor_len": np.array(len(self.anchor)),
                "ird_succ": self.succ,
                "ird_max_length": np.array(self.max_length),
                "ird_shape": np.array([self.num_rows, self.num_cols])}

    @staticmethod
    def from_npz_dict(d) -> "IntRowDiff":
        n = int(d["ird_anchor_len"])
        shape = d["ird_shape"]
        return IntRowDiff(
            rows=np.asarray(d["ird_rows"]), cols=np.asarray(d["ird_cols"]),
            vals=np.asarray(d["ird_vals"]),
            anchor=np.unpackbits(d["ird_anchor"])[:n].astype(bool),
            succ=np.asarray(d["ird_succ"]),
            max_length=int(d["ird_max_length"]),
            num_rows=int(shape[0]), num_cols=int(shape[1]))


@dataclass
class RowDiffBrwt:
    """RowDiff whose delta matrix is a Multi-BRWT (the reference's
    RowDiffBRWT annotator, static_annotators_def.hpp): XOR anchor walks
    over BRWT-compressed diffs. The walk runs at host level, one batched
    BRWT descent per step (each descent is itself fully jitted)."""
    diffs: "object"              # Brwt
    anchor: np.ndarray
    succ: np.ndarray
    max_length: int

    @property
    def num_rows(self) -> int:
        return self.diffs.num_rows

    @property
    def num_cols(self) -> int:
        return self.diffs.num_cols

    @property
    def nnz(self) -> int:
        return self.diffs.nnz

    def num_anchors(self) -> int:
        return int(self.anchor.sum())

    def get_rows_dense(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows, np.int64)
        Q = len(rows)
        acc = np.zeros((Q, self.num_cols), bool)
        cur = rows.copy()
        done = np.zeros(Q, bool)
        for _ in range(self.max_length + 1):
            if done.all():
                break
            curc = np.clip(cur, 0, self.num_rows - 1)
            delta = self.diffs.presence(curc)
            acc ^= delta & ~done[:, None]
            done |= self.anchor[curc] & ~done
            nxt = self.succ[curc]
            done |= (nxt < 0) & ~done
            cur = np.where(done, cur, nxt)
        return acc

    def presence(self, rows) -> np.ndarray:
        return self.get_rows_dense(np.asarray(rows))

    def sum_rows(self, rows, weights) -> np.ndarray:
        dense = self.get_rows_dense(np.asarray(rows))
        return (dense * np.asarray(weights)[:, None]).sum(axis=0)

    def to_row_sparse(self) -> RowSparse:
        chunks_r, chunks_c = [], []
        B = 1 << 15
        for s in range(0, self.num_rows, B):
            rows = np.arange(s, min(s + B, self.num_rows))
            dense = self.get_rows_dense(rows)
            r, c = np.nonzero(dense)
            chunks_r.append(r + s)
            chunks_c.append(c)
        return RowSparse.from_coo(np.concatenate(chunks_r),
                                  np.concatenate(chunks_c),
                                  self.num_rows, self.num_cols)

    def to_npz_dict(self) -> dict:
        d = self.diffs.to_npz_dict()
        d["rdb_anchor"] = np.packbits(self.anchor)
        d["rdb_anchor_len"] = np.array(len(self.anchor))
        d["rdb_succ"] = self.succ
        d["rdb_max_length"] = np.array(self.max_length)
        return d

    @staticmethod
    def from_npz_dict(d) -> "RowDiffBrwt":
        from .brwt import Brwt
        n = int(d["rdb_anchor_len"])
        return RowDiffBrwt(
            diffs=Brwt.from_npz_dict(d),
            anchor=np.unpackbits(d["rdb_anchor"])[:n].astype(bool),
            succ=np.asarray(d["rdb_succ"]),
            max_length=int(d["rdb_max_length"]))


def build_row_diff_brwt(matrix: RowSparse, graph,
                        max_length: int = DEFAULT_MAX_LENGTH,
                        subsample: int = 1_000_000) -> RowDiffBrwt:
    """RowDiff deltas compressed into a Multi-BRWT (the reference's
    row_diff_brwt transform target)."""
    from .brwt import build_brwt
    rd = build_row_diff(matrix, graph, max_length)
    return RowDiffBrwt(diffs=build_brwt(rd.diffs, subsample=subsample),
                       anchor=rd.anchor, succ=rd.succ,
                       max_length=rd.max_length)


def _int_delta_pairs(rows, cols, vals, C, succ, anchor):
    """(keys, sums): surviving ``row*C+col`` keys and their summed value
    deltas (anchor rows keep raw values; others subtract the successor)."""
    non_anchor = ~anchor
    v_ids = np.nonzero(non_anchor)[0]
    sv = succ[v_ids]
    ok = sv >= 0
    v_ids, sv = v_ids[ok], sv[ok]
    lo = np.searchsorted(rows, sv, side="left")
    hi = np.searchsorted(rows, sv, side="right")
    sizes = hi - lo
    vv = np.repeat(v_ids, sizes)
    flat = _interval_expand(lo, sizes)
    all_keys = np.concatenate([rows * C + cols, vv * C + cols[flat]])
    all_vals = np.concatenate([vals, -vals[flat]])
    order = np.argsort(all_keys, kind="stable")
    k_s, v_s = all_keys[order], all_vals[order]
    first = np.concatenate([[True], k_s[1:] != k_s[:-1]]) \
        if len(k_s) else np.zeros(0, bool)
    group = np.cumsum(first) - 1
    sums = np.zeros(int(group[-1]) + 1 if len(group) else 0, np.int64)
    np.add.at(sums, group, v_s)
    keys_u = k_s[np.nonzero(first)[0]]
    keep = sums != 0
    return keys_u[keep], sums[keep]


def build_int_row_diff(matrix: RowSparse, graph,
                       max_length: int = DEFAULT_MAX_LENGTH,
                       row_counts: Optional[np.ndarray] = None,
                       row_reduction: Optional[np.ndarray] = None
                       ) -> IntRowDiff:
    """Delta-compress integer annotation values along successor paths,
    with the same count-routed forks + negative-reduction anchors as the
    boolean builder (the reference's count variant of
    convert_batch_to_row_diff, row_diff_builder.cpp:688+)."""
    assert matrix.values is not None, "needs a count annotation"
    rows = np.asarray(matrix.rows).astype(np.int64)
    cols = np.asarray(matrix.cols).astype(np.int64)
    vals = np.asarray(matrix.values).astype(np.int64)
    C = matrix.num_cols
    if row_counts is None:
        row_counts = np.bincount(rows, minlength=matrix.num_rows)
    succ, anchor = assign_successors_and_anchors(graph, max_length,
                                                 row_counts)
    if row_reduction is None:
        keys0, _ = _int_delta_pairs(rows, cols, vals, C, succ, anchor)
        orig_nnz = np.bincount(rows, minlength=matrix.num_rows)
        diff_nnz = np.bincount(keys0 // C, minlength=matrix.num_rows)
        row_reduction = (orig_nnz - diff_nnz).astype(np.int64)
    anchor = anchor | (np.asarray(row_reduction)[:matrix.num_rows] < 0)
    keys_u, sums = _int_delta_pairs(rows, cols, vals, C, succ, anchor)
    return IntRowDiff(rows=(keys_u // C), cols=(keys_u % C).astype(np.int32),
                      vals=sums, anchor=anchor, succ=succ,
                      max_length=max_length,
                      num_rows=matrix.num_rows, num_cols=C)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def assign_successors_and_anchors(graph, max_length: int = DEFAULT_MAX_LENGTH,
                                  row_counts: Optional[np.ndarray] = None
                                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(succ (num_rows,) int64 row-space successor (-1 = none),
    anchor (num_rows,) bool).

    Successor of node v = one designated outgoing neighbor (the
    reference's rd-succ, row_diff_builder.cpp:322). With ``row_counts``
    (per-row label counts, the stage-0 artifact), forks route to the
    outgoing neighbor with the most labels (route_at_forks,
    row_diff_builder.cpp:280-298) — denser successors cancel more bits;
    without counts, the first outgoing neighbor is used.
    Anchors: terminals, every max_length-th position of each chain, and
    cycle leaders (assign_anchors, row_diff_builder.cpp:422)."""
    N = graph.num_nodes()
    nodes = jnp.arange(1, N + 1, dtype=jnp.int32)
    succs = np.asarray(graph.successors(nodes))          # (N, sigma-1)
    first = np.zeros(N + 1, np.int64)
    if row_counts is not None and len(row_counts) >= N:
        cnt = np.where(succs > 0,
                       np.asarray(row_counts)[np.clip(succs - 1, 0, N - 1)],
                       -1)
        choice = np.argmax(cnt, axis=1)                  # ties: first max
        picked = succs[np.arange(N), choice]
        first[1:] = np.where(picked > 0, picked, 0)
    else:
        for ci in range(succs.shape[1] - 1, -1, -1):
            col = succs[:, ci]
            first[1:] = np.where(col > 0, col, first[1:])
    # self-successors would loop forever
    first[1:] = np.where(first[1:] == np.arange(1, N + 1), 0, first[1:])

    # pointer-doubling over succ to find distance to root / cycle leaders
    steps = max(1, int(np.ceil(np.log2(N + 2))))
    ids = np.arange(N + 1, dtype=np.int64)
    parent = np.where(first > 0, first, ids)
    parent[0] = 0
    mins = np.minimum(ids, parent)
    par = parent.copy()
    mn = mins.copy()
    for _ in range(steps):
        mn = np.minimum(mn, mn[par])
        par = par[par]
    in_cycle = first[par] > 0
    leader = np.where(in_cycle, mn, par)
    # break cycles at leaders
    first2 = first.copy()
    first2[(in_cycle) & (ids == leader)] = 0
    par2 = np.where(first2 > 0, first2, ids)
    dist = np.where(first2 > 0, 1, 0).astype(np.int64)
    for _ in range(steps):
        dist = dist + dist[par2]
        par2 = par2[par2]
    anchor_nodes = (first2 == 0) | (dist % max_length == 0)
    anchor_nodes[0] = False
    # to row space (row = node - 1); anchors also where succ broken
    succ_rows = np.where(first2[1:] > 0, first2[1:] - 1, -1)
    return succ_rows, anchor_nodes[1:]


def _diff_pair_keys(rows: np.ndarray, cols: np.ndarray, num_cols: int,
                    succ: np.ndarray, anchor: np.ndarray) -> np.ndarray:
    """Sorted int64 ``row*C+col`` keys of the XOR-diff matrix: original
    pairs concatenated with each non-anchor row's successor pairs; keys
    appearing an odd number of times survive the cancellation."""
    base_key = rows * num_cols + cols
    non_anchor = ~anchor
    v_ids = np.nonzero(non_anchor)[0]
    sv = succ[v_ids]
    ok = sv >= 0
    v_ids, sv = v_ids[ok], sv[ok]
    lo = np.searchsorted(rows, sv, side="left")
    hi = np.searchsorted(rows, sv, side="right")
    sizes = hi - lo
    vv = np.repeat(v_ids, sizes)
    flat = _interval_expand(lo, sizes)
    succ_key = vv * num_cols + cols[flat]
    allk = np.concatenate([base_key, succ_key])
    allk.sort(kind="stable")
    boundaries = np.concatenate([[True], allk[1:] != allk[:-1]]) \
        if len(allk) else np.zeros(0, bool)
    group = np.cumsum(boundaries) - 1
    counts = np.bincount(group) if len(allk) else np.zeros(0, np.int64)
    first_idx = np.nonzero(boundaries)[0]
    odd = (counts % 2) == 1
    return allk[first_idx[odd]]


def compute_row_counts(matrix: RowSparse) -> np.ndarray:
    """Stage-0 artifact: labels per row (row_diff_builder.cpp:100-190)."""
    rows = np.asarray(matrix.rows).astype(np.int64)
    return np.bincount(rows, minlength=matrix.num_rows).astype(np.int64)


def compute_row_reduction(matrix: RowSparse, graph,
                          max_length: int = DEFAULT_MAX_LENGTH,
                          row_counts: Optional[np.ndarray] = None
                          ) -> np.ndarray:
    """Stage-1 artifact: per-row ``nnz(row) - nnz(diff row)`` under the
    preliminary (path-position) anchor assignment
    (row_diff_builder.cpp COMPUTE_REDUCTION). Negative entries mark rows
    where diffing against the successor *grows* the annotation — stage 2
    turns those into anchors."""
    succ, anchor = assign_successors_and_anchors(graph, max_length,
                                                 row_counts)
    rows = np.asarray(matrix.rows).astype(np.int64)
    cols = np.asarray(matrix.cols).astype(np.int64)
    num_rows, num_cols = matrix.num_rows, matrix.num_cols
    kept = _diff_pair_keys(rows, cols, num_cols, succ, anchor)
    orig_nnz = np.bincount(rows, minlength=num_rows)
    diff_nnz = np.bincount(kept // num_cols, minlength=num_rows)
    return (orig_nnz - diff_nnz).astype(np.int64)


def compute_row_reduction_int(matrix: RowSparse, graph,
                              max_length: int = DEFAULT_MAX_LENGTH,
                              row_counts: Optional[np.ndarray] = None
                              ) -> np.ndarray:
    """Stage-1 artifact for integer (count) annotations: nnz reduction of
    the value-delta matrix under the preliminary anchors."""
    rows = np.asarray(matrix.rows).astype(np.int64)
    cols = np.asarray(matrix.cols).astype(np.int64)
    vals = np.asarray(matrix.values).astype(np.int64)
    C = matrix.num_cols
    if row_counts is None:
        row_counts = np.bincount(rows, minlength=matrix.num_rows)
    succ, anchor = assign_successors_and_anchors(graph, max_length,
                                                 row_counts)
    keys0, _ = _int_delta_pairs(rows, cols, vals, C, succ, anchor)
    orig_nnz = np.bincount(rows, minlength=matrix.num_rows)
    diff_nnz = np.bincount(keys0 // C, minlength=matrix.num_rows)
    return (orig_nnz - diff_nnz).astype(np.int64)


def build_row_diff(matrix: RowSparse, graph,
                   max_length: int = DEFAULT_MAX_LENGTH,
                   row_counts: Optional[np.ndarray] = None,
                   row_reduction: Optional[np.ndarray] = None) -> RowDiff:
    """Convert a RowSparse annotation into RowDiff form against the given
    graph — the reference's 3 stages (row_diff_builder.cpp:100-688) in
    one in-memory pass: per-row label counts route rd-successors at
    forks, a reduction pass marks rows where diffing hurts, those become
    extra anchors, then the final diffs are computed by sorted-pair XOR
    cancellation. ``row_counts``/``row_reduction`` accept the staged CLI
    artifacts (stages 0/1) so multi-invocation pipelines produce the
    identical annotation."""
    rows = np.asarray(matrix.rows).astype(np.int64)
    cols = np.asarray(matrix.cols).astype(np.int64)
    num_rows, num_cols = matrix.num_rows, matrix.num_cols
    if row_counts is None:
        row_counts = compute_row_counts(matrix)
    if row_reduction is None:
        row_reduction = compute_row_reduction(matrix, graph, max_length,
                                              row_counts)
    succ, anchor = assign_successors_and_anchors(graph, max_length,
                                                 row_counts)
    anchor = anchor | (np.asarray(row_reduction)[:num_rows] < 0)
    kept = _diff_pair_keys(rows, cols, num_cols, succ, anchor)
    d_rows = (kept // num_cols).astype(np.int32)
    d_cols = (kept % num_cols).astype(np.int32)
    diffs = RowSparse.from_coo(d_rows, d_cols, num_rows, num_cols,
                               dedupe=False)
    return RowDiff(diffs=diffs, anchor=anchor, succ=succ,
                   max_length=max_length)
