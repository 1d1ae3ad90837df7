"""Out-of-core staged RowDiff conversion.

The reference converts column annotations to RowDiff in three disk-backed
stages so annotations larger than RAM can be transformed
(metagraph/src/annotation/row_diff_builder.cpp:322-688: assign rd-succ
and anchors, stream every source column against the graph, write diffed
columns back to disk). The in-memory `build_row_diff`
(anno/row_diff.py:477) collapses that to one pass; this module restores
the bounded-memory discipline:

  Stage 0  scan only the ``labels`` member of every input .annodbg.npz
           (npz members load lazily) to build the merged LabelEncoder —
           no matrix touches disk yet.
  Stage 1  graph side: rd-succ + anchors (shared with the in-memory
           builder) plus an inverted-successor index (sorted succ +
           argsort) computed once, O(N) ints.
  Stage 2a stream annotation files ONE AT A TIME, spilling their raw
           bits as ``col * num_rows + row`` int64 keys (sorted runs).
           Files sharing a label contribute to the same global column,
           so columns must be unioned before diffing — that union
           happens on disk in the next step, not in RAM.
  Stage 2b blockwise merge of the raw runs into one column-major key
           stream (memmap), then walk it column by column: each
           column's diff row set is computed independently with
           sorted-set ops (searchsorted membership — no dense num_rows
           buffers) and spilled as sorted ``row * num_cols + col`` runs.
  Stage 3  blockwise 2-way merges of the diff runs (memmap in/out)
           into the final key array, decoded into the RowDiff matrix.

Peak RSS is bounded by max(one input file, mem_cap, final diff nnz) —
the same guarantee as the reference's temp-file stages. Binary matrices
only; counts/coordinates keep the in-memory builders (IntRowDiff /
TupleRowDiff), matching the reference's separate code paths.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .annotator import Annotation, LabelEncoder
from .matrix import RowSparse
from .row_diff import (DEFAULT_MAX_LENGTH, RowDiff,
                       assign_successors_and_anchors)


def _isin_sorted(sorted_arr: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Membership of ``vals`` in a sorted array, O(|vals| log n)."""
    if sorted_arr.size == 0:
        return np.zeros(vals.shape, bool)
    idx = np.searchsorted(sorted_arr, vals)
    idx = np.minimum(idx, sorted_arr.size - 1)
    return sorted_arr[idx] == vals


def _expand(lo: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Flatten intervals [lo_i, lo_i + sizes_i) into one index array."""
    total = int(sizes.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    starts = np.repeat(lo, sizes)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(sizes)[:-1]]), sizes)
    return starts + offs


def _diff_column(R: np.ndarray, anchor: np.ndarray, succ: np.ndarray,
                 succ_sorted: np.ndarray, succ_order: np.ndarray
                 ) -> np.ndarray:
    """Diffed row set of one column.

    D = {v anchor, v in R}
      ∪ {v non-anchor, v in R, succ(v) not in R}
      ∪ {v non-anchor, v not in R, succ(v) in R}
    i.e. anchors keep their bits, others store M[v] XOR M[succ(v)]
    (row_diff.hpp:153's inverse transform).
    """
    if R.size == 0:
        return R
    aR = anchor[R]
    keep_a = R[aR]
    na = R[~aR]
    sv = succ[na]
    keep1 = na[~((sv >= 0) & _isin_sorted(R, sv))]
    # predecessors (in rd-succ forest) of every set row
    lo = np.searchsorted(succ_sorted, R, side="left")
    hi = np.searchsorted(succ_sorted, R, side="right")
    preds = succ_order[_expand(lo, hi - lo)]
    keep2 = preds[~anchor[preds] & ~_isin_sorted(R, preds)]
    out = np.concatenate([keep_a, keep1, keep2])
    out.sort()
    return out


class _RunSpiller:
    """Accumulate int64 keys (optionally with int64 values); spill
    sorted runs to disk past the cap."""

    def __init__(self, swap_dir: str, cap_keys: int, prefix: str = "rd",
                 with_vals: bool = False):
        self.swap_dir = swap_dir
        self.prefix = prefix
        self.with_vals = with_vals
        self.cap = max(int(cap_keys), 1 << 16)
        self.buf: List[np.ndarray] = []
        self.vbuf: List[np.ndarray] = []
        self.n_buf = 0
        self.runs: List[str] = []

    def add(self, keys: np.ndarray, vals: Optional[np.ndarray] = None):
        if keys.size == 0:
            return
        self.buf.append(keys)
        if self.with_vals:
            self.vbuf.append(np.asarray(vals, np.int64))
        self.n_buf += keys.size
        if self.n_buf >= self.cap:
            self.flush()

    def flush(self):
        if not self.n_buf:
            return
        arr = np.concatenate(self.buf)
        path = os.path.join(self.swap_dir,
                            f"{self.prefix}_run_{len(self.runs)}.npy")
        if self.with_vals:
            vals = np.concatenate(self.vbuf)
            order = np.argsort(arr, kind="stable")
            np.save(path, arr[order])
            np.save(_vpath(path), vals[order])
        else:
            arr.sort()
            np.save(path, arr)
        self.runs.append(path)
        self.buf, self.vbuf, self.n_buf = [], [], 0


def _vpath(kpath: str) -> str:
    return kpath[:-4] + ".vals.npy"


def _merge_two(a: np.ndarray, b: np.ndarray, out_path: str,
               block: int, av=None, bv=None) -> str:
    """Blockwise merge of two sorted key arrays (with optional co-sorted
    value arrays) into new sorted memmaps — O(block) resident."""
    with_vals = av is not None
    out = np.lib.format.open_memmap(out_path, mode="w+", dtype=np.int64,
                                    shape=(a.size + b.size,))
    if with_vals:
        outv = np.lib.format.open_memmap(_vpath(out_path), mode="w+",
                                         dtype=np.int64,
                                         shape=(a.size + b.size,))
    ia = ib = io = 0
    while ia < a.size and ib < b.size:
        ablk = np.asarray(a[ia:ia + block])
        bblk = np.asarray(b[ib:ib + block])
        # merge only the span both blocks fully cover
        top = min(ablk[-1], bblk[-1])
        ahi = int(np.searchsorted(ablk, top, side="right"))
        bhi = int(np.searchsorted(bblk, top, side="right"))
        if ahi == 0 and bhi == 0:  # cannot happen: top is in one of them
            ahi = ablk.size
        m = np.concatenate([ablk[:ahi], bblk[:bhi]])
        if with_vals:
            mv = np.concatenate([np.asarray(av[ia:ia + ahi]),
                                 np.asarray(bv[ib:ib + bhi])])
            order = np.argsort(m, kind="stable")
            m, mv = m[order], mv[order]
            outv[io:io + mv.size] = mv
        else:
            m.sort()
        out[io:io + m.size] = m
        io += m.size
        ia += ahi
        ib += bhi
    for src, vsrc, i in ((a, av, ia), (b, bv, ib)):
        while i < src.size:
            blk = np.asarray(src[i:i + block])
            out[io:io + blk.size] = blk
            if with_vals:
                outv[io:io + blk.size] = np.asarray(vsrc[i:i + blk.size])
            io += blk.size
            i += blk.size
    out.flush()
    if with_vals:
        outv.flush()
    return out_path


def _merge_runs(run_paths: List[str], swap_dir: str,
                block: int = 1 << 22, with_vals: bool = False):
    """Repeated pairwise merge of sorted runs; returns the final memmap
    (or a (keys, vals) pair). Runs may share keys (duplicates are
    preserved; callers dedupe/sum)."""
    if not run_paths:
        z = np.zeros(0, np.int64)
        return (z, z.copy()) if with_vals else z
    gen = 0
    paths = list(run_paths)
    base = os.path.basename(paths[0]).split("_run_")[0]
    while len(paths) > 1:
        nxt = []
        for i in range(0, len(paths) - 1, 2):
            out = os.path.join(swap_dir, f"{base}_merge_{gen}_{i}.npy")
            a = np.load(paths[i], mmap_mode="r")
            b = np.load(paths[i + 1], mmap_mode="r")
            if with_vals:
                av = np.load(_vpath(paths[i]), mmap_mode="r")
                bv = np.load(_vpath(paths[i + 1]), mmap_mode="r")
                _merge_two(a, b, out, block, av, bv)
                del av, bv
                os.unlink(_vpath(paths[i]))
                os.unlink(_vpath(paths[i + 1]))
            else:
                _merge_two(a, b, out, block)
            del a, b
            os.unlink(paths[i])
            os.unlink(paths[i + 1])
            nxt.append(out)
        if len(paths) % 2:
            nxt.append(paths[-1])
        paths = nxt
        gen += 1
    keys = np.load(paths[0], mmap_mode="r")
    if with_vals:
        return keys, np.load(_vpath(paths[0]), mmap_mode="r")
    return keys


def _diff_column_int(R: np.ndarray, V: np.ndarray, anchor: np.ndarray,
                     succ: np.ndarray, succ_sorted: np.ndarray,
                     succ_order: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Integer diff of one column: anchors keep their value, others store
    val[v] - val[succ(v)] (0 for absent); zero deltas drop
    (row_diff.build_int_row_diff semantics, out-of-core shape)."""
    if R.size == 0:
        return R, V
    def val_at(q):
        idx = np.searchsorted(R, q)
        idx_c = np.minimum(idx, R.size - 1)
        hit = (R[idx_c] == q) & (q >= 0)
        return np.where(hit, V[idx_c], 0)
    aR = anchor[R]
    keep_a, va = R[aR], V[aR]
    na, vna = R[~aR], V[~aR]
    d1 = vna - val_at(np.where(succ[na] >= 0, succ[na], -1))
    # predecessors (rd-succ) of set rows that are themselves unset
    lo = np.searchsorted(succ_sorted, R, side="left")
    hi = np.searchsorted(succ_sorted, R, side="right")
    preds = succ_order[_expand(lo, hi - lo)]
    p_ok = ~anchor[preds] & ~_isin_sorted(R, preds)
    p2 = preds[p_ok]
    d2 = -val_at(succ[p2])
    rows = np.concatenate([keep_a, na, p2])
    vals = np.concatenate([va, d1, d2])
    keep = vals != 0
    rows, vals = rows[keep], vals[keep]
    order = np.argsort(rows, kind="stable")
    return rows[order], vals[order]


def _staged_convert(paths, graph, swap_dir, mem_cap_mb, max_length,
                    with_vals: bool):
    """Shared staged pipeline (see module docstring). Returns
    (enc, succ, anchor, d_rows (int64), d_cols (int32),
    d_vals (int64 or None), num_rows, num_cols)."""
    os.makedirs(swap_dir, exist_ok=True)
    # Stage 0: merged label dictionary (lazy npz member read)
    enc = LabelEncoder()
    file_codes: List[np.ndarray] = []
    for p in paths:
        with np.load(p, allow_pickle=False) as d:
            labels = [str(x) for x in d["labels"]]
        file_codes.append(np.array([enc.insert(l) for l in labels],
                                   np.int64))
    num_cols = max(len(enc), 1)
    num_rows = int(graph.num_nodes())

    cap_keys = (mem_cap_mb << 20) // (16 if with_vals else 8)

    # Stage 2a: spill every file's entries as column-major keys, while
    # accumulating the stage-0 per-row label counts (row_count artifact,
    # row_diff_builder.cpp:100-190) — O(num_rows) ints resident
    row_counts = np.zeros(num_rows, np.int64)
    raw = _RunSpiller(swap_dir, cap_keys, prefix="raw",
                      with_vals=with_vals)
    for p, codes in zip(paths, file_codes):
        ann = Annotation.load(p)
        mat = ann.matrix
        if not isinstance(mat, RowSparse):
            mat = mat.to_row_sparse()
        if with_vals:
            assert mat.values is not None, f"{p}: needs a count annotation"
        if mat.num_rows != num_rows:
            raise ValueError(f"{p}: {mat.num_rows} rows != graph "
                             f"{num_rows}")
        rows = np.asarray(mat.rows).astype(np.int64)
        gcols = codes[np.asarray(mat.cols).astype(np.int64)]
        row_counts += np.bincount(rows, minlength=num_rows)
        keys = gcols * num_rows + rows
        raw.add(keys, np.asarray(mat.values).astype(np.int64)
                if with_vals else None)
        del ann, mat, rows, gcols
    raw.flush()

    # Stage 1: graph side (+ inverted successor index); forks route to
    # the most-labeled successor (route_at_forks), matching the
    # in-memory builder bit for bit
    succ, base_anchor = assign_successors_and_anchors(graph, max_length,
                                                      row_counts)
    succ_order = np.argsort(succ, kind="stable").astype(np.int64)
    succ_sorted = succ[succ_order]
    # drop the succ<0 prefix so pred lookups never match -1
    nneg = int(np.searchsorted(succ_sorted, 0, side="left"))
    succ_sorted = succ_sorted[nneg:]
    succ_order = succ_order[nneg:]

    # Stage 2b: union the columns on disk, then two passes per column:
    # pass A accumulates the stage-1 row-reduction artifact under the
    # preliminary anchors (COMPUTE_REDUCTION), pass B diffs with the
    # final anchors (negative-reduction rows promoted) and spills
    merged = _merge_runs(raw.runs, swap_dir, with_vals=with_vals)
    raw_keys, raw_vals = merged if with_vals else (merged, None)

    def columns():
        lo = 0
        for gcol in range(num_cols):
            hi = int(np.searchsorted(raw_keys, (gcol + 1) * num_rows,
                                     side="left"))
            if hi > lo:
                kk = np.asarray(raw_keys[lo:hi]) - gcol * num_rows
                if with_vals:
                    # files may repeat a (label, row) pair: sum values
                    R, inv = np.unique(kk, return_inverse=True)
                    V = np.zeros(R.size, np.int64)
                    np.add.at(V, inv, np.asarray(raw_vals[lo:hi]))
                    yield gcol, R, V
                else:
                    yield gcol, np.unique(kk), None
            lo = hi

    reduction = np.zeros(num_rows, np.int64)
    for gcol, R, V in columns():
        if with_vals:
            D, _ = _diff_column_int(R, V, base_anchor, succ,
                                    succ_sorted, succ_order)
        else:
            D = _diff_column(R, base_anchor, succ, succ_sorted,
                             succ_order)
        reduction += np.bincount(R, minlength=num_rows)
        reduction -= np.bincount(D, minlength=num_rows)
    anchor = base_anchor | (reduction < 0)

    spiller = _RunSpiller(swap_dir, cap_keys, prefix="diff",
                          with_vals=with_vals)
    for gcol, R, V in columns():
        if with_vals:
            D, DV = _diff_column_int(R, V, anchor, succ,
                                     succ_sorted, succ_order)
            spiller.add(D * num_cols + gcol, DV)
        else:
            D = _diff_column(R, anchor, succ, succ_sorted, succ_order)
            spiller.add(D * num_cols + gcol)
    spiller.flush()
    files = [arr.filename for arr in (raw_keys, raw_vals)
             if isinstance(arr, np.memmap)]
    del raw_keys, raw_vals, merged    # drop mappings before unlinking
    for path in files:
        os.unlink(path)

    # Stage 3: merge the diff runs; copy out and drop the temp files
    merged = _merge_runs(spiller.runs, swap_dir, with_vals=with_vals)
    kept, kvals = merged if with_vals else (merged, None)
    d_rows = np.array(np.asarray(kept) // num_cols)
    d_cols = np.array(np.asarray(kept) % num_cols, dtype=np.int32)
    d_vals = np.array(kvals) if with_vals else None
    files = [arr.filename for arr in (kept, kvals)
             if isinstance(arr, np.memmap)]
    del kept, kvals, merged
    for path in files:
        os.unlink(path)
    return enc, succ, anchor, d_rows, d_cols, d_vals, num_rows, num_cols


def build_row_diff_staged(paths: Sequence[str], graph,
                          swap_dir: str,
                          mem_cap_mb: int = 1024,
                          max_length: int = DEFAULT_MAX_LENGTH
                          ) -> Annotation:
    """Out-of-core RowDiff conversion of one or more column annotation
    files over the same row space (see module docstring)."""
    enc, succ, anchor, d_rows, d_cols, _, num_rows, num_cols = \
        _staged_convert(paths, graph, swap_dir, mem_cap_mb, max_length,
                        with_vals=False)
    diffs = RowSparse.from_coo(d_rows.astype(np.int32), d_cols, num_rows,
                               num_cols, dedupe=False)
    mat = RowDiff(diffs=diffs, anchor=anchor, succ=succ,
                  max_length=max_length)
    return Annotation(matrix=mat, encoder=enc)


def build_int_row_diff_staged(paths: Sequence[str], graph,
                              swap_dir: str,
                              mem_cap_mb: int = 1024,
                              max_length: int = DEFAULT_MAX_LENGTH
                              ) -> Annotation:
    """Out-of-core IntRowDiff conversion (counts): the binary staging
    with values co-sorted alongside the keys and summed when files
    repeat a (label, row) pair."""
    from .row_diff import IntRowDiff
    enc, succ, anchor, d_rows, d_cols, d_vals, num_rows, num_cols = \
        _staged_convert(paths, graph, swap_dir, mem_cap_mb, max_length,
                        with_vals=True)
    mat = IntRowDiff(rows=d_rows, cols=d_cols, vals=d_vals, anchor=anchor,
                     succ=succ, max_length=max_length,
                     num_rows=num_rows, num_cols=num_cols)
    return Annotation(matrix=mat, encoder=enc)
