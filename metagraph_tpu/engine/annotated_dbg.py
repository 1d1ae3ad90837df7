"""AnnotatedDbg: graph + annotation join and the label-query engine.

Re-implements the reference AnnotatedDBG
(metagraph/src/graph/annotated_dbg.hpp:71-143, annotated_dbg.cpp:195-320)
with batched device math: a sequence's windows are mapped to nodes in one
searchsorted, per-label k-mer counts come from one interval-expand +
segment-sum over the annotation matrix, and the reference's exact
selection/ordering semantics are preserved:

  * anno row index = node - 1 (annotated_dbg.hpp:54-60);
  * min_count = max(1, ceil(presence_ratio * num_windows));
  * get_labels: labels with count >= min_count in label-code order;
  * get_top_labels: same set with counts; sorted by (count desc, code asc)
    and truncated only when more than num_top_labels survive
    (annotated_dbg.cpp top_labels<>).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..anno.annotator import Annotation, ColumnAnnotator
from ..graph.dbg_succinct import DbgSuccinct


@dataclass
class AnnotatedDbg:
    graph: DbgSuccinct
    annotation: Annotation

    @property
    def num_labels(self) -> int:
        return self.annotation.num_labels

    # -- mapping helpers ---------------------------------------------------

    def _map_rows(self, sequence: bytes | str) -> Tuple[np.ndarray, int]:
        """Anno row per window (-1 = not present) and total window count."""
        nodes = self.graph.map_to_nodes(sequence)
        if hasattr(self.graph, "node_to_anno_row"):
            rows = self.graph.node_to_anno_row(nodes)
            rows = np.where(nodes > 0, rows, -1)
            return rows, len(nodes)
        return nodes.astype(np.int64) - 1, len(nodes)

    def _label_counts(self, rows: np.ndarray) -> np.ndarray:
        """(num_labels,) k-mer hit count per label over present rows."""
        present = rows[rows >= 0].astype(np.int32)
        if present.size == 0:
            return np.zeros((self.num_labels,), np.int64)
        uniq, cnt = np.unique(present, return_counts=True)
        counts = self.annotation.matrix.sum_rows(
            jnp.asarray(uniq), jnp.asarray(cnt.astype(np.int32)))
        return np.asarray(counts).astype(np.int64)

    # -- queries (annotated_dbg.cpp semantics) ------------------------------

    def get_labels(self, sequence: bytes | str,
                   presence_ratio: float = 0.0) -> List[str]:
        if len(sequence) < self.graph.k:
            return []
        rows, num_windows = self._map_rows(sequence)
        num_present = int((rows >= 0).sum())
        min_count = max(1, math.ceil(presence_ratio * num_windows))
        if num_present < min_count:
            return []
        counts = self._label_counts(rows)
        return [self.annotation.encoder.decode(c)
                for c in np.nonzero(counts >= min_count)[0]]

    def get_top_labels(self, sequence: bytes | str,
                       num_top_labels: int = 2 ** 62,
                       presence_ratio: float = 0.0,
                       with_kmer_counts: bool = False
                       ) -> List[Tuple[str, int]]:
        if len(sequence) < self.graph.k:
            return []
        rows, num_windows = self._map_rows(sequence)
        num_present = int((rows >= 0).sum())
        min_count = max(1, math.ceil(presence_ratio * num_windows))
        if num_present < min_count:
            return []
        if with_kmer_counts:
            present = rows[rows >= 0].astype(np.int32)
            uniq, cnt = np.unique(present, return_counts=True)
            counts = np.asarray(self.annotation.matrix.sum_row_values(
                jnp.asarray(uniq), jnp.asarray(cnt.astype(np.int32))))
            # min_count filter still applies to binary presence counts
            bin_counts = self._label_counts(rows)
        else:
            counts = self._label_counts(rows)
            bin_counts = counts
        codes = np.nonzero(bin_counts >= min_count)[0]
        pairs = [(int(c), int(counts[c])) for c in codes]
        if len(pairs) > num_top_labels:
            pairs.sort(key=lambda p: (-p[1], p[0]))
            pairs = pairs[:num_top_labels]
        return [(self.annotation.encoder.decode(c), n) for c, n in pairs]

    def get_top_label_signatures(self, sequence: bytes | str,
                                 num_top_labels: int = 2 ** 62,
                                 presence_ratio: float = 0.0
                                 ) -> List[Tuple[str, np.ndarray]]:
        """Per-label boolean k-mer presence masks
        (annotated_dbg.cpp:500-560)."""
        if len(sequence) < self.graph.k:
            return []
        rows, num_windows = self._map_rows(sequence)
        num_present = int((rows >= 0).sum())
        min_count = max(1, math.ceil(presence_ratio * num_windows))
        if num_present < min_count:
            return []
        present_mask = rows >= 0
        present = rows[present_mask].astype(np.int32)
        uniq, inv = np.unique(present, return_inverse=True)
        pres = np.asarray(self.annotation.matrix.presence(jnp.asarray(uniq)))
        # expand back to window positions
        sig = np.zeros((num_windows, self.num_labels), bool)
        sig[np.nonzero(present_mask)[0]] = pres[inv]
        counts = sig.sum(axis=0)
        codes = np.nonzero(counts >= min_count)[0]
        pairs = sorted(((int(c), int(counts[c])) for c in codes),
                       key=lambda p: (-p[1], p[0]))
        if len(pairs) > num_top_labels:
            pairs = pairs[:num_top_labels]
        return [(self.annotation.encoder.decode(c), sig[:, c])
                for c, _ in pairs]

    def get_kmer_coordinates(self, sequence: bytes | str,
                             num_top_labels: int = 2 ** 62,
                             presence_ratio: float = 0.0
                             ) -> List[Tuple[str, List[List[int]]]]:
        """Per label: one coordinate tuple per query k-mer window
        (reference AnnotatedDBG::get_kmer_coordinates, used by
        --query-coords)."""
        assert hasattr(self.annotation.matrix, "get_tuples"), \
            "coordinate queries need a coordinate annotation"
        if len(sequence) < self.graph.k:
            return []
        rows, num_windows = self._map_rows(sequence)
        num_present = int((rows >= 0).sum())
        min_count = max(1, math.ceil(presence_ratio * num_windows))
        if num_present < min_count:
            return []
        counts = self._label_counts(rows)
        codes = np.nonzero(counts >= min_count)[0]
        pairs = sorted(((int(c), int(counts[c])) for c in codes),
                       key=lambda p: (-p[1], p[0]))[:num_top_labels]
        out = []
        m = self.annotation.matrix
        safe_rows = np.where(rows >= 0, rows, m.num_rows + 1)
        for c, _cnt in pairs:
            tuples = m.get_tuples(safe_rows, c)
            out.append((self.annotation.encoder.decode(c), tuples))
        return out

    def get_label_count_quantiles(self, sequence: bytes | str,
                                  num_top_labels: int = 2 ** 62,
                                  presence_ratio: float = 0.0,
                                  count_quantiles: Sequence[float] = ()
                                  ) -> List[Tuple[str, List[int]]]:
        """Per-label count quantiles over the query's k-mer windows
        (annotated_dbg.cpp:301-385): quantile q -> count[i] with
        i = floor((num_kmers-1)*q) into the zero-padded sorted counts."""
        if len(sequence) < self.graph.k:
            return []
        rows, num_windows = self._map_rows(sequence)
        present = rows[rows >= 0].astype(np.int64)
        min_count = max(1, math.ceil(presence_ratio * num_windows))
        if len(present) < min_count:
            return []
        cols, vals = _row_values_host(self.annotation.matrix, present)
        q_low = [int((num_windows - 1) * q) for q in count_quantiles]
        out = []
        order = np.argsort(cols, kind="stable")
        cols_s, vals_s = cols[order], vals[order]
        uniq, starts = np.unique(cols_s, return_index=True)
        bounds = np.append(starts, len(cols_s))
        per_label = [(int(uniq[i]), vals_s[bounds[i]:bounds[i + 1]])
                     for i in range(len(uniq))]
        per_label = [(c, v) for c, v in per_label if len(v) >= min_count]
        per_label.sort(key=lambda p: (-len(p[1]), p[0]))
        per_label = per_label[:num_top_labels]
        for c, v in per_label:
            counts = np.sort(v)
            num_zeros = num_windows - len(counts)
            qs = [0 if ql < num_zeros else int(counts[ql - num_zeros])
                  for ql in q_low]
            out.append((self.annotation.encoder.decode(c), qs))
        return out

    def score_kmer_presence_mask(self, mask: np.ndarray,
                                 match_score: int = 1,
                                 mismatch_score: int = 2) -> int:
        """Alignment-free quality score of a presence mask — the exact
        reference semantics (annotated_dbg.cpp:706-900): autocorrelate
        the mask over a (kmer_adjust=3)-window, run-length encode with a
        +1 correction on every run but the last, sum one-runs, apply the
        BIGSI SNP penalty to zero-runs, and scale by
        sequence_length / mask_length."""
        mask = np.asarray(mask, bool)
        n = mask.size
        if n == 0:
            return 0
        k = self.graph.k
        kmer_adjust = 3
        seq_len = n + k - 1
        snp_t = float(k + kmer_adjust)
        # autocorrelate(v, 3): out[i] = AND of v[i..i+2] (bits past the
        # end count as set, vector_algorithm.cpp:519)
        ac = mask.copy()
        for j in range(1, kmer_adjust):
            ac &= np.concatenate([mask[j:], np.ones(j, bool)])
        # tabulate_score(ac, correction=1): run lengths, +1 on all but
        # the final run (annotated_dbg.cpp:710-770)
        change = np.nonzero(ac[1:] != ac[:-1])[0]
        bounds = np.concatenate([[0], change + 1, [n]])
        lens = np.diff(bounds).astype(np.int64)
        vals = ac[bounds[:-1]]
        lens_c = lens.copy()
        lens_c[:-1] += 1
        ones = lens_c[vals]
        zeros = lens_c[~vals]
        score = float(int(ones.sum()) * match_score)
        if score == 0:
            return 0
        if len(zeros) == 0:
            return int(score * seq_len / n)
        c = zeros.astype(np.float64)
        min_n = c / snp_t
        max_n = np.maximum(c - snp_t + 1, min_n)
        mean_n = max_n * 0.05 + min_n
        mean_penalty = mean_n * mismatch_score
        score += float(((c - mean_penalty) * match_score
                        - mean_penalty).sum())
        return int(max(score * seq_len / n, 0.0))


def _row_values_host(matrix, rows: np.ndarray):
    """(cols, values) pairs over all requested rows, host-side
    (IntMatrix::get_row_values role). Duplicated query rows contribute
    once per occurrence."""
    if hasattr(matrix, "row_values_list"):
        return matrix.row_values_list(rows)
    from ..anno.matrix import RowSparse
    if not isinstance(matrix, RowSparse):
        matrix = matrix.to_row_sparse()
    lo, hi = matrix.row_ranges(jnp.asarray(rows.astype(np.int32)))
    lo, hi = np.asarray(lo), np.asarray(hi)
    cols_np = np.asarray(matrix.cols)
    vals_np = (np.asarray(matrix.values) if matrix.values is not None
               else np.ones_like(cols_np))
    from ..anno.row_diff import _interval_expand
    idx = _interval_expand(lo, hi - lo)
    return cols_np[idx], vals_np[idx]


class BatchQuery:
    """Batched query executor (reference QueryExecutor / batch mode,
    query.cpp:628-1031): a whole read batch is mapped and aggregated in
    ~one device dispatch, instead of one dispatch per read.

    The reference builds a per-batch intersection "query graph"; here the
    batched searchsorted over the full index plays that role directly:
    all windows of all reads are mapped at once, and per-(read, label)
    k-mer counts come from one interval-expand + segment-sum over
    read_id * num_labels + label keys.
    """

    def __init__(self, adbg: AnnotatedDbg):
        self.adbg = adbg
        from ..anno.matrix import RowSparse
        m = adbg.annotation.matrix
        # host copy of the row index for exact expand-capacity computation
        self._rows_np = (np.asarray(m.rows)
                         if isinstance(m, RowSparse) else None)

    def _map_batch(self, seqs: Sequence[bytes]):
        """Concatenate reads with separators; map all windows at once.
        Returns (rows (W,) int64 anno rows (-1 absent), read_id (W,),
        windows_per_read (R,))."""
        from ..kmer.alphabets import INVALID_CODE
        from ..kmer.extractor import encode_sequences
        g = self.adbg.graph
        k = g.k
        if (getattr(g, "boss", None) is not None
                and g.boss.edge_lanes is None
                and hasattr(g, "map_read_batch")):
            # small state: incremental walk (O(1) rank/select per
            # window) instead of the flat k-step search per window
            per = g.map_read_batch(list(seqs))
            rows_l, rid_l, wpr = [], [], []
            for r, nodes in enumerate(per):
                if hasattr(g, "node_to_anno_row"):
                    rr = np.where(nodes > 0,
                                  g.node_to_anno_row(nodes), -1)
                else:
                    rr = nodes.astype(np.int64) - 1
                rows_l.append(rr)
                rid_l.append(np.full(len(nodes), r, np.int64))
                wpr.append(len(nodes))
            return (np.concatenate(rows_l) if rows_l
                    else np.zeros(0, np.int64),
                    np.concatenate(rid_l) if rid_l
                    else np.zeros(0, np.int64),
                    np.array(wpr, np.int64))
        codes_np = encode_sequences(seqs, g.alphabet)
        # pad to power-of-two bucket to bound recompiles
        target = max(1024, 1 << (max(len(codes_np), k) - 1).bit_length())
        codes_np = np.concatenate(
            [codes_np, np.full(target - len(codes_np), INVALID_CODE,
                               np.uint8)])
        nodes = np.asarray(g.map_codes_to_nodes(jnp.asarray(codes_np)))
        if hasattr(g, "node_to_anno_row"):
            rows_all = np.where(nodes > 0, g.node_to_anno_row(nodes), -1)
        else:
            rows_all = nodes.astype(np.int64) - 1
        # window w belongs to read r iff it lies fully inside read r's span
        rows, read_ids, wpr = [], [], []
        off = 0
        for r, s in enumerate(seqs):
            nw = max(0, len(s) - k + 1)
            rows.append(rows_all[off:off + nw])
            read_ids.append(np.full(nw, r, np.int64))
            wpr.append(nw)
            off += len(s) + 1
        return (np.concatenate(rows) if rows else np.zeros(0, np.int64),
                np.concatenate(read_ids) if read_ids else np.zeros(0, np.int64),
                np.array(wpr, np.int64))

    def label_count_matrix(self, seqs: Sequence[bytes]
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """((R, num_labels) per-read label k-mer counts,
        (R,) windows per read, (R,) present windows per read)."""
        adbg = self.adbg
        C = adbg.num_labels
        rows, read_ids, wpr = self._map_batch(seqs)
        present = rows >= 0
        n_present = np.zeros(len(seqs), np.int64)
        np.add.at(n_present, read_ids[present], 1)
        m = adbg.annotation.matrix
        from ..anno.matrix import RowSparse
        if isinstance(m, RowSparse):
            pr = rows[present].astype(np.int32)
            rid = read_ids[present].astype(np.int32)
            lo = np.searchsorted(self._rows_np, pr, side="left")
            hi = np.searchsorted(self._rows_np, pr, side="right")
            exact = max(int((hi - lo).sum()), 1)
            cap = 1 << (exact - 1).bit_length()
            counts = np.asarray(_batch_sum_rows(
                m, jnp.asarray(pr), jnp.asarray(rid), len(seqs), cap))
        else:
            # compressed representations: dense per-row presence then add
            pr = rows[present]
            uniq, inv = np.unique(pr, return_inverse=True)
            dense = np.asarray(m.presence(uniq))
            counts = np.zeros((len(seqs), C), np.int64)
            np.add.at(counts, read_ids[present], dense[inv])
        return counts.astype(np.int64), wpr, n_present

    def get_labels_batch(self, seqs: Sequence[bytes],
                         presence_ratio: float = 0.0) -> List[List[str]]:
        counts, wpr, n_present = self.label_count_matrix(seqs)
        out = []
        enc = self.adbg.annotation.encoder
        for r, s in enumerate(seqs):
            if len(s) < self.adbg.graph.k:
                out.append([])
                continue
            min_count = max(1, math.ceil(presence_ratio * wpr[r]))
            if n_present[r] < min_count:
                out.append([])
                continue
            out.append([enc.decode(c)
                        for c in np.nonzero(counts[r] >= min_count)[0]])
        return out

    def get_top_labels_batch(self, seqs: Sequence[bytes],
                             num_top_labels: int = 2 ** 62,
                             presence_ratio: float = 0.0,
                             with_kmer_counts: bool = False
                             ) -> List[List[Tuple[str, int]]]:
        if with_kmer_counts:
            return self._top_labels_batch_values(seqs, num_top_labels,
                                                 presence_ratio)
        counts, wpr, n_present = self.label_count_matrix(seqs)
        out = []
        enc = self.adbg.annotation.encoder
        for r, s in enumerate(seqs):
            if len(s) < self.adbg.graph.k:
                out.append([])
                continue
            min_count = max(1, math.ceil(presence_ratio * wpr[r]))
            if n_present[r] < min_count:
                out.append([])
                continue
            codes = np.nonzero(counts[r] >= min_count)[0]
            pairs = [(int(c), int(counts[r][c])) for c in codes]
            if len(pairs) > num_top_labels:
                pairs.sort(key=lambda p: (-p[1], p[0]))
                pairs = pairs[:num_top_labels]
            out.append([(enc.decode(c), n) for c, n in pairs])
        return out

    def _top_labels_batch_values(self, seqs, num_top_labels,
                                 presence_ratio):
        """--query-counts batch path: one batched value fetch for the
        whole read batch (no per-read fallback)."""
        adbg = self.adbg
        C = adbg.num_labels
        enc = adbg.annotation.encoder
        rows, read_ids, wpr = self._map_batch(seqs)
        present = rows >= 0
        n_present = np.zeros(len(seqs), np.int64)
        np.add.at(n_present, read_ids[present], 1)
        pr = rows[present]
        rid = read_ids[present]
        uniq, inv = (np.unique(pr, return_inverse=True) if len(pr)
                     else (np.zeros(0, np.int64), np.zeros(0, np.int64)))
        m = adbg.annotation.matrix
        vals_sum = np.zeros((len(seqs), C), np.int64)
        bin_sum = np.zeros((len(seqs), C), np.int64)
        if len(uniq):
            if hasattr(m, "get_row_values_dense"):
                dense_v = np.asarray(m.get_row_values_dense(uniq))
            elif getattr(m, "values", None) is not None:
                from ..anno.matrix import RowSparse
                assert isinstance(m, RowSparse)
                lo = np.searchsorted(self._rows_np, uniq, side="left")
                hi = np.searchsorted(self._rows_np, uniq, side="right")
                from ..anno.row_diff import _interval_expand
                flat = _interval_expand(lo, hi - lo)
                dense_v = np.zeros((len(uniq), C), np.int64)
                dense_v[np.repeat(np.arange(len(uniq)), hi - lo),
                        np.asarray(m.cols)[flat]] = np.asarray(m.values)[flat]
            else:
                dense_v = np.asarray(m.presence(uniq)).astype(np.int64)
            np.add.at(vals_sum, rid, dense_v[inv])
            np.add.at(bin_sum, rid, (dense_v[inv] > 0).astype(np.int64))
        out = []
        for r, s in enumerate(seqs):
            if len(s) < adbg.graph.k:
                out.append([])
                continue
            min_count = max(1, math.ceil(presence_ratio * wpr[r]))
            if n_present[r] < min_count:
                out.append([])
                continue
            codes = np.nonzero(bin_sum[r] >= min_count)[0]
            pairs = [(int(c), int(vals_sum[r][c])) for c in codes]
            if len(pairs) > num_top_labels:
                pairs.sort(key=lambda p: (-p[1], p[0]))
                pairs = pairs[:num_top_labels]
            out.append([(enc.decode(c), n) for c, n in pairs])
        return out

    def get_top_label_signatures_batch(self, seqs: Sequence[bytes],
                                       num_top_labels: int = 2 ** 62,
                                       presence_ratio: float = 0.0):
        """Batched --print-signature: ONE presence fetch for the whole
        batch's unique rows, then per-read formatting on host data."""
        adbg = self.adbg
        C = adbg.num_labels
        enc = adbg.annotation.encoder
        rows, read_ids, wpr = self._map_batch(seqs)
        present = rows >= 0
        pr = rows[present]
        uniq, inv = (np.unique(pr, return_inverse=True) if len(pr)
                     else (np.zeros(0, np.int64), np.zeros(0, np.int64)))
        pres = (np.asarray(adbg.annotation.matrix.presence(uniq))
                if len(uniq) else np.zeros((0, C), bool))
        # full window-level signature matrix, batch-major
        sig_all = np.zeros((len(rows), C), bool)
        sig_all[np.nonzero(present)[0]] = pres[inv]
        bounds = np.concatenate([[0], np.cumsum(wpr)])
        out = []
        for r, s in enumerate(seqs):
            if len(s) < adbg.graph.k:
                out.append([])
                continue
            sig = sig_all[bounds[r]:bounds[r + 1]]
            min_count = max(1, math.ceil(presence_ratio * wpr[r]))
            counts = sig.sum(axis=0)
            codes = np.nonzero(counts >= min_count)[0]
            pairs = sorted(((int(c), int(counts[c])) for c in codes),
                           key=lambda p: (-p[1], p[0]))
            if len(pairs) > num_top_labels:
                pairs = pairs[:num_top_labels]
            out.append([(enc.decode(c), sig[:, c]) for c, _ in pairs])
        return out

    def get_kmer_coordinates_batch(self, seqs: Sequence[bytes],
                                   num_top_labels: int = 2 ** 62,
                                   presence_ratio: float = 0.0):
        """Batched --query-coords: one coordinate reconstruction for the
        batch's unique rows (TupleRowDiff anchor walks included), shared
        across reads AND labels."""
        adbg = self.adbg
        m = adbg.annotation.matrix
        assert hasattr(m, "tuples_for_rows"), \
            "coordinate queries need a coordinate annotation"
        enc = adbg.annotation.encoder
        counts, wpr, n_present = self.label_count_matrix(seqs)
        rows, read_ids, _ = self._map_batch(seqs)
        rec = m.tuples_for_rows(rows[rows >= 0])
        bounds = np.concatenate([[0], np.cumsum(wpr)])
        out = []
        for r, s in enumerate(seqs):
            if len(s) < adbg.graph.k:
                out.append([])
                continue
            min_count = max(1, math.ceil(presence_ratio * wpr[r]))
            if n_present[r] < min_count:
                out.append([])
                continue
            codes = np.nonzero(counts[r] >= min_count)[0]
            pairs = sorted(((int(c), int(counts[r][c])) for c in codes),
                           key=lambda p: (-p[1], p[0]))[:num_top_labels]
            rrows = rows[bounds[r]:bounds[r + 1]]
            res = []
            for c, _cnt in pairs:
                tuples = [sorted(int(x) for x in rec[int(q)].get(c, ()))
                          if q >= 0 else [] for q in rrows]
                res.append((enc.decode(c), tuples))
            out.append(res)
        return out

    def get_label_count_quantiles_batch(self, seqs: Sequence[bytes],
                                        num_top_labels: int = 2 ** 62,
                                        presence_ratio: float = 0.0,
                                        count_quantiles: Sequence[float] = ()):
        """Batched --count-quantiles: one value fetch for the batch's
        unique rows; per-(read,label) quantiles from grouped host data."""
        adbg = self.adbg
        C = adbg.num_labels
        enc = adbg.annotation.encoder
        rows, read_ids, wpr = self._map_batch(seqs)
        present = rows >= 0
        pr = rows[present]
        rid = read_ids[present]
        n_present = np.zeros(len(seqs), np.int64)
        np.add.at(n_present, rid, 1)
        uniq, inv = (np.unique(pr, return_inverse=True) if len(pr)
                     else (np.zeros(0, np.int64), np.zeros(0, np.int64)))
        m = adbg.annotation.matrix
        if len(uniq):
            if hasattr(m, "get_row_values_dense"):
                dense_v = np.asarray(m.get_row_values_dense(uniq))
            else:
                from ..anno.matrix import RowSparse
                mm = m if isinstance(m, RowSparse) else m.to_row_sparse()
                mrows = np.asarray(mm.rows)
                lo = np.searchsorted(mrows, uniq, side="left")
                hi = np.searchsorted(mrows, uniq, side="right")
                from ..anno.row_diff import _interval_expand
                flat = _interval_expand(lo, hi - lo)
                vals_np = (np.asarray(mm.values) if mm.values is not None
                           else np.ones(mm.nnz, np.int64))
                dense_v = np.zeros((len(uniq), C), np.int64)
                dense_v[np.repeat(np.arange(len(uniq)), hi - lo),
                        np.asarray(mm.cols)[flat]] = vals_np[flat]
        else:
            dense_v = np.zeros((0, C), np.int64)
        # flat (read, label, value) records for all present windows
        wv = dense_v[inv] if len(uniq) else np.zeros((0, C), np.int64)
        wq, wc = np.nonzero(wv)
        owner = rid[wq]
        vals = wv[wq, wc]
        order = np.lexsort((vals, wc, owner))
        owner, wc, vals = owner[order], wc[order], vals[order]
        key = owner * (C + 1) + wc
        starts = (np.concatenate(
            [[0], np.nonzero(key[1:] != key[:-1])[0] + 1, [len(key)]])
            if len(key) else np.array([0]))
        per_read = [[] for _ in seqs]
        for s_, e_ in zip(starts[:-1], starts[1:]):
            per_read[int(owner[s_])].append((int(wc[s_]), vals[s_:e_]))
        out = []
        for r, s in enumerate(seqs):
            if len(s) < adbg.graph.k:
                out.append([])
                continue
            min_count = max(1, math.ceil(presence_ratio * wpr[r]))
            if n_present[r] < min_count:
                out.append([])
                continue
            q_low = [int((wpr[r] - 1) * q) for q in count_quantiles]
            groups = [(c, v) for c, v in per_read[r] if len(v) >= min_count]
            groups.sort(key=lambda p: (-len(p[1]), p[0]))
            res = []
            for c, v in groups[:num_top_labels]:
                num_zeros = wpr[r] - len(v)
                qs = [0 if ql < num_zeros else int(v[ql - num_zeros])
                      for ql in q_low]
                res.append((enc.decode(c), qs))
            out.append(res)
        return out


@functools.partial(jax.jit, static_argnames=("num_reads", "cap"))
def _batch_sum_rows(m, rows, read_ids, num_reads: int, cap: int):
    """(R, C) counts: interval-expand matrix hits keyed by read."""
    from ..anno.matrix import _expand_intervals
    lo, hi = m.row_ranges(rows)
    q, flat, valid = _expand_intervals(lo, hi, cap)
    fc = jnp.clip(flat, 0, max(m.nnz - 1, 0))
    col = m.cols[fc]
    key = read_ids[q] * m.num_cols + col
    w = jnp.where(valid, 1, 0)
    flatc = jax.ops.segment_sum(w, key,
                                num_segments=num_reads * m.num_cols)
    return flatc.reshape(num_reads, m.num_cols)


def annotate_sequences(
    graph: DbgSuccinct,
    items: Sequence[Tuple[bytes, Sequence[str]]],
    annotator: Optional[ColumnAnnotator] = None,
    with_counts: bool = False,
) -> ColumnAnnotator:
    """Build a column annotation from (sequence, labels) pairs
    (reference cli/annotate.cpp:138-300): map each sequence's windows to
    nodes and set the labels on every present row."""
    if annotator is None:
        num_rows = graph.num_nodes()
        if hasattr(graph, "node_to_anno_row"):  # primary wrapper: base rows
            num_rows = graph.base.num_nodes()
        annotator = ColumnAnnotator(num_rows=num_rows)
    for seq, labels in items:
        nodes = graph.map_to_nodes(seq)
        if hasattr(graph, "node_to_anno_row"):
            rows = graph.node_to_anno_row(nodes[nodes > 0])
        else:
            rows = nodes[nodes > 0].astype(np.int64) - 1
        if with_counts:
            uniq, cnt = np.unique(rows, return_counts=True)
            for label in labels:
                annotator.add(uniq, label, values=cnt)
        else:
            rows = np.unique(rows)
            for label in labels:
                annotator.add(rows, label)
    return annotator
