"""Tests for the DBG facade, annotation matrices, and the query engine."""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from conftest import random_dna
from metagraph_tpu.anno.annotator import Annotation, ColumnAnnotator, LabelEncoder
from metagraph_tpu.anno.matrix import RowSparse
from metagraph_tpu.engine.annotated_dbg import AnnotatedDbg, annotate_sequences
from metagraph_tpu.graph.boss_construct import build_boss
from metagraph_tpu.graph.dbg_succinct import DbgSuccinct
from metagraph_tpu.graph import io as graph_io
from metagraph_tpu.kmer.alphabets import DNA


def build_graph(seqs, k, mode="basic"):
    boss = build_boss(seqs, k, mode=mode)
    return DbgSuccinct.from_boss(boss, DNA, mode)


def gold_kmers(seqs, k):
    tbl = DNA.encode_table()
    out = set()
    for s in seqs:
        cs = tbl[np.frombuffer(s, np.uint8)]
        for i in range(len(cs) - k + 1):
            w = cs[i:i + k]
            if (w != 255).all():
                out.add(bytes(w))
    return out


def test_map_to_nodes(rng):
    k = 6
    seqs = [random_dna(rng, 120) for _ in range(3)]
    g = build_graph(seqs, k)
    assert g.num_nodes() == len(gold_kmers(seqs, k))
    # every window of an input sequence maps to a node, and nodes decode back
    nodes = g.map_to_nodes(seqs[0])
    assert (nodes > 0).all()
    chars = g.node_kmers_chars(nodes)
    tbl = DNA.encode_table()
    cs = tbl[np.frombuffer(seqs[0], np.uint8)]
    for i in range(len(nodes)):
        np.testing.assert_array_equal(chars[i], cs[i:i + k])
    # absent sequence maps to 0s (with high probability for k=6 over 3 seqs
    # use a sequence with N to force invalid windows)
    nodes2 = g.map_to_nodes(b"ACGTNNACGT")
    assert (nodes2[:5] == 0).sum() >= 1  # windows containing N are 0


def test_adjacency(rng):
    k = 5
    seqs = [random_dna(rng, 100)]
    g = build_graph(seqs, k)
    kset = gold_kmers(seqs, k)
    nodes = np.arange(1, g.num_nodes() + 1)
    succ = np.asarray(g.successors(jnp.asarray(nodes)))
    pred = np.asarray(g.predecessors(jnp.asarray(nodes)))
    chars = g.node_kmers_chars(nodes)
    code2idx = {bytes(chars[i]): i + 1 for i in range(len(nodes))}
    for i, node in enumerate(nodes):
        km = chars[i]
        for c in range(1, 5):
            nxt = bytes(list(km[1:]) + [c])
            want = code2idx.get(nxt, 0)
            assert succ[i, c - 1] == want
            prv = bytes([c] + list(km[:-1]))
            want = code2idx.get(prv, 0)
            assert pred[i, c - 1] == want
    # degree sanity
    outd = np.asarray(g.outdegree(jnp.asarray(nodes)))
    assert (outd == (succ > 0).sum(axis=1)).all()


def test_graph_io_roundtrip(rng, tmp_path):
    seqs = [random_dna(rng, 80)]
    g = build_graph(seqs, 5)
    p = graph_io.save_graph(str(tmp_path / "g"), g)
    g2 = graph_io.load_graph(p)
    assert g2.k == g.k and g2.num_nodes() == g.num_nodes()
    np.testing.assert_array_equal(np.asarray(g2.boss.W), np.asarray(g.boss.W))
    np.testing.assert_array_equal(g2.map_to_nodes(seqs[0]),
                                  g.map_to_nodes(seqs[0]))


def test_row_sparse_queries(rng):
    num_rows, num_cols = 50, 7
    dense = rng.random((num_rows, num_cols)) < 0.2
    r, c = np.nonzero(dense)
    m = RowSparse.from_coo(r, c, num_rows, num_cols)
    rows_q = rng.integers(0, num_rows, size=20).astype(np.int32)
    w = rng.integers(1, 5, size=20).astype(np.int32)
    got = np.asarray(m.sum_rows(jnp.asarray(rows_q), jnp.asarray(w)))
    want = (dense[rows_q] * w[:, None]).sum(axis=0)
    np.testing.assert_array_equal(got, want)
    pres = np.asarray(m.presence(jnp.asarray(rows_q)))
    np.testing.assert_array_equal(pres, dense[rows_q])
    cols_p, counts = m.slice_rows(jnp.asarray(rows_q), num_cols)
    np.testing.assert_array_equal(np.asarray(counts), dense[rows_q].sum(axis=1))


def test_row_sparse_values(rng):
    num_rows, num_cols = 30, 4
    dense = (rng.random((num_rows, num_cols)) < 0.3) * \
        rng.integers(1, 10, size=(num_rows, num_cols))
    r, c = np.nonzero(dense)
    m = RowSparse.from_coo(r, c, num_rows, num_cols, values=dense[r, c])
    rows_q = np.arange(num_rows, dtype=np.int32)
    w = np.ones(num_rows, np.int32)
    got = np.asarray(m.sum_row_values(jnp.asarray(rows_q), jnp.asarray(w)))
    np.testing.assert_array_equal(got, dense.sum(axis=0))


def test_annotated_dbg_labels(rng):
    k = 6
    seqs = [random_dna(rng, 150) for _ in range(4)]
    g = build_graph(seqs, k)
    ann = annotate_sequences(
        g, [(s, [f"label_{i}"]) for i, s in enumerate(seqs)]).finalize()
    adbg = AnnotatedDbg(graph=g, annotation=ann)
    # each full input sequence must recover its own label at ratio 1.0
    for i, s in enumerate(seqs):
        labels = adbg.get_labels(s, presence_ratio=1.0)
        assert f"label_{i}" in labels
    # a fragment of seq 0 recovers label_0
    frag = seqs[0][10:60]
    assert "label_0" in adbg.get_labels(frag, presence_ratio=1.0)
    # gold check of counts for get_top_labels
    q = seqs[1][:40]
    tops = dict(adbg.get_top_labels(q, presence_ratio=0.0))
    tbl = DNA.encode_table()
    for i, s in enumerate(seqs):
        km = gold_kmers([s], k)
        cs = tbl[np.frombuffer(q, np.uint8)]
        cnt = sum(1 for j in range(len(q) - k + 1)
                  if bytes(cs[j:j + k]) in km)
        if cnt:
            assert tops[f"label_{i}"] == cnt
        else:
            assert f"label_{i}" not in tops


def test_get_labels_ordering_and_threshold(rng):
    k = 4
    s1 = b"ACGTACGTACGTACGT"
    s2 = b"TTTTTTTTTTTT"
    g = build_graph([s1, s2], k)
    ann = annotate_sequences(g, [(s1, ["B"]), (s2, ["A"]), (s1, ["C"])]).finalize()
    adbg = AnnotatedDbg(graph=g, annotation=ann)
    # label-code order (insertion order B, A, C), not alphabetical
    assert adbg.get_labels(s1) == ["B", "C"]
    assert adbg.get_labels(s2) == ["A"]
    # mixed query: threshold filters
    mixed = s1 + s2
    assert set(adbg.get_labels(mixed, presence_ratio=0.0)) == {"A", "B", "C"}
    assert adbg.get_labels(mixed, presence_ratio=0.9) == []


def test_signatures(rng):
    k = 4
    s1 = b"ACGTACGTACGT"
    g = build_graph([s1], k)
    ann = annotate_sequences(g, [(s1, ["X"])]).finalize()
    adbg = AnnotatedDbg(graph=g, annotation=ann)
    sigs = adbg.get_top_label_signatures(s1)
    assert len(sigs) == 1
    label, mask = sigs[0]
    assert label == "X"
    assert mask.all() and mask.shape[0] == len(s1) - k + 1


def test_annotation_io_roundtrip(rng, tmp_path):
    k = 5
    seqs = [random_dna(rng, 60) for _ in range(2)]
    g = build_graph(seqs, k)
    ann = annotate_sequences(g, [(s, [f"l{i}"]) for i, s in enumerate(seqs)]
                             ).finalize()
    path = str(tmp_path / "anno.npz")
    ann.save(path)
    ann2 = Annotation.load(path)
    assert ann2.encoder.labels == ann.encoder.labels
    np.testing.assert_array_equal(np.asarray(ann2.matrix.rows),
                                  np.asarray(ann.matrix.rows))


def test_annotation_merge(rng):
    k = 5
    seqs = [random_dna(rng, 60) for _ in range(2)]
    g = build_graph(seqs, k)
    a1 = annotate_sequences(g, [(seqs[0], ["x"])]).finalize()
    a2 = annotate_sequences(g, [(seqs[1], ["y"]), (seqs[0], ["x"])]).finalize()
    merged = Annotation.merge([a1, a2], g.num_nodes())
    adbg = AnnotatedDbg(graph=g, annotation=merged)
    assert "x" in adbg.get_labels(seqs[0], 1.0)
    assert "y" in adbg.get_labels(seqs[1], 1.0)


def test_batch_query_matches_single(rng):
    """BatchQuery must agree with the per-read engine exactly."""
    from metagraph_tpu.engine.annotated_dbg import BatchQuery
    k = 7
    seqs = [random_dna(rng, 180) for _ in range(4)]
    g = build_graph(seqs, k)
    ann = annotate_sequences(
        g, [(s, [f"l{i}"]) for i, s in enumerate(seqs)]).finalize()
    adbg = AnnotatedDbg(graph=g, annotation=ann)
    bq = BatchQuery(adbg)
    reads = [seqs[0][10:90], seqs[2][40:140], b"A" * 60,
             seqs[1][:30], b"ACG"]
    for ratio in (0.0, 0.7, 1.0):
        batch = bq.get_labels_batch(reads, ratio)
        single = [adbg.get_labels(r, ratio) for r in reads]
        assert batch == single, ratio
    batch_t = bq.get_top_labels_batch(reads, 2, 0.5)
    single_t = [adbg.get_top_labels(r, 2, 0.5) for r in reads]
    assert batch_t == single_t


def test_batch_query_modes_match_single(rng):
    """The batched signature / counts / quantiles / coordinate modes
    must agree with the per-read engine exactly."""
    from metagraph_tpu.engine.annotated_dbg import BatchQuery
    k = 7
    seqs = [random_dna(rng, 180) for _ in range(4)]
    g = build_graph(seqs, k)
    ann = annotate_sequences(
        g, [(s, [f"l{i}", "shared"]) for i, s in enumerate(seqs)],
        with_counts=True).finalize()
    adbg = AnnotatedDbg(graph=g, annotation=ann)
    bq = BatchQuery(adbg)
    reads = [seqs[0][10:90], seqs[2][40:140], b"A" * 60,
             seqs[1][:30], b"ACG", seqs[3][5:100]]
    # --print-signature
    for ratio in (0.0, 0.6):
        batch = bq.get_top_label_signatures_batch(reads, 3, ratio)
        single = [adbg.get_top_label_signatures(r, 3, ratio)
                  for r in reads]
        assert len(batch) == len(single)
        for b, s in zip(batch, single):
            assert [x[0] for x in b] == [x[0] for x in s]
            for (_, mb), (_, ms) in zip(b, s):
                np.testing.assert_array_equal(mb, ms)
    # --query-counts (value sums)
    batch_v = bq.get_top_labels_batch(reads, 4, 0.3, with_kmer_counts=True)
    single_v = [adbg.get_top_labels(r, 4, 0.3, with_kmer_counts=True)
                for r in reads]
    assert batch_v == single_v
    # --count-quantiles
    qs = [0.0, 0.5, 1.0]
    batch_q = bq.get_label_count_quantiles_batch(reads, 4, 0.3, qs)
    single_q = [adbg.get_label_count_quantiles(r, 4, 0.3, qs)
                for r in reads]
    assert batch_q == single_q


def test_batch_query_coords_match_single(rng):
    """Batched --query-coords against the per-read engine, on both the
    flat CoordMatrix and the delta-compressed TupleRowDiff."""
    from metagraph_tpu.anno.coords import (annotate_coordinates,
                                           build_tuple_row_diff)
    from metagraph_tpu.engine.annotated_dbg import BatchQuery
    k = 7
    seqs = [random_dna(rng, 160) for _ in range(3)]
    g = build_graph(seqs, k)
    ann = annotate_coordinates(
        g, [(s, [f"l{i}"]) for i, s in enumerate(seqs)]).finalize()
    reads = [seqs[0][5:80], seqs[1][20:120], b"G" * 40, seqs[2][:50]]
    for compress in (False, True):
        a = ann
        if compress:
            from metagraph_tpu.anno.annotator import Annotation
            a = Annotation(matrix=build_tuple_row_diff(ann.matrix, g),
                           encoder=ann.encoder)
        adbg = AnnotatedDbg(graph=g, annotation=a)
        bq = BatchQuery(adbg)
        batch = bq.get_kmer_coordinates_batch(reads, 3, 0.2)
        single = [adbg.get_kmer_coordinates(r, 3, 0.2) for r in reads]
        assert batch == single, compress
