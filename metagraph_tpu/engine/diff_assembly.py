"""Differential assembly: label-based node masks.

Re-implements the reference's annotated_graph_algorithm
(metagraph/src/graph/annotated_graph_algorithm.hpp:28-74): build a node
mask keeping unitigs (or nodes) whose annotation matches a foreground /
background label contrast, then assemble the masked graph. Here the
per-node label counts for the in/out/other groups are three masked
segment-sums over the annotation matrix — one pass, no per-node label
set materialization.
"""

from __future__ import annotations

from typing import List, Sequence

import jax.numpy as jnp
import numpy as np

from ..graph.masked import MaskedDbg
from ..graph.traversal import unitig_decomposition
from .annotated_dbg import AnnotatedDbg


def _per_node_group_counts(adbg: AnnotatedDbg, codes_in, codes_out):
    """(N+1,) counts of in/out/other labels per node (one matrix pass)."""
    m = adbg.annotation.matrix
    N = adbg.graph.num_nodes()
    rows = np.asarray(m.rows)
    cols = np.asarray(m.cols)
    group = np.zeros(m.num_cols, np.int8)      # 0=other, 1=in, 2=out
    group[list(codes_in)] = 1
    group[list(codes_out)] = 2
    g = group[cols]
    n_in = np.zeros(N + 1, np.int32)
    n_out = np.zeros(N + 1, np.int32)
    n_other = np.zeros(N + 1, np.int32)
    node = rows + 1
    np.add.at(n_in, node[g == 1], 1)
    np.add.at(n_out, node[g == 2], 1)
    np.add.at(n_other, node[g == 0], 1)
    return n_in, n_out, n_other


def mask_nodes_by_node_label(adbg: AnnotatedDbg,
                             labels_in: Sequence[str],
                             labels_out: Sequence[str],
                             label_mask_in_fraction: float = 1.0,
                             label_mask_out_fraction: float = 0.0) -> np.ndarray:
    """(N+1,) keep-mask: node has >= in_fraction of in-labels and
    <= out_fraction of out-labels."""
    enc = adbg.annotation.encoder
    codes_in = [enc.encode(l) for l in labels_in]
    codes_out = [enc.encode(l) for l in labels_out if l in enc]
    n_in, n_out, _ = _per_node_group_counts(adbg, codes_in, codes_out)
    keep = (n_in >= label_mask_in_fraction * max(len(codes_in), 1)) \
        & (n_out <= label_mask_out_fraction * max(len(codes_out), 1))
    keep[0] = False
    return keep


def mask_nodes_by_unitig_labels(adbg: AnnotatedDbg,
                                labels_in: Sequence[str],
                                labels_out: Sequence[str],
                                label_mask_in_fraction: float = 1.0,
                                label_mask_out_fraction: float = 0.0,
                                label_other_fraction: float = 1.0) -> np.ndarray:
    """(N+1,) keep-mask at unitig granularity
    (mask_nodes_by_unitig_labels, annotated_graph_algorithm.cpp): a unitig
    is kept when, over the union of labels seen on its nodes,
    >= in_fraction of the in-labels are present, <= out_fraction of the
    out-labels are present, and the fraction of other labels among those
    seen is <= label_other_fraction."""
    enc = adbg.annotation.encoder
    codes_in = [enc.encode(l) for l in labels_in]
    codes_out = [enc.encode(l) for l in labels_out if l in enc]
    u = unitig_decomposition(adbg.graph)
    m = adbg.annotation.matrix
    rows = np.asarray(m.rows)
    cols = np.asarray(m.cols)
    node = rows + 1
    cid = u.chain_id[node]
    # distinct (unitig, label) pairs
    pair = cid.astype(np.int64) * m.num_cols + cols
    pair = np.unique(pair)
    ucid = (pair // m.num_cols).astype(np.int64)
    ucol = (pair % m.num_cols).astype(np.int64)
    group = np.zeros(m.num_cols, np.int8)
    group[list(codes_in)] = 1
    group[list(codes_out)] = 2
    g = group[ucol]
    nU = u.num_unitigs
    in_cnt = np.zeros(nU, np.int32)
    out_cnt = np.zeros(nU, np.int32)
    other_cnt = np.zeros(nU, np.int32)
    np.add.at(in_cnt, ucid[g == 1], 1)
    np.add.at(out_cnt, ucid[g == 2], 1)
    np.add.at(other_cnt, ucid[g == 0], 1)
    total = in_cnt + out_cnt + other_cnt
    keep_u = (in_cnt >= label_mask_in_fraction * max(len(codes_in), 1)) \
        & (out_cnt <= label_mask_out_fraction * max(len(codes_out), 1)) \
        & (other_cnt <= label_other_fraction * np.maximum(total, 1))
    keep = np.zeros(adbg.graph.num_nodes() + 1, bool)
    keep[1:] = keep_u[u.chain_id[1:]]
    keep[0] = False
    return keep


def differential_assembly(adbg: AnnotatedDbg,
                          labels_in: Sequence[str],
                          labels_out: Sequence[str],
                          unitig_mode: bool = True,
                          **fractions) -> MaskedDbg:
    mask = (mask_nodes_by_unitig_labels if unitig_mode
            else mask_nodes_by_node_label)(adbg, labels_in, labels_out,
                                           **fractions)
    return MaskedDbg(base=adbg.graph, mask=mask)
