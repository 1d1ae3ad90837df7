"""Multi-BRWT and RowDiff compressed annotation tests: every compressed
representation must answer queries identically to the RowSparse source
(the reference's matrix-contract test pattern, test_matrix_helpers.hpp)."""

import numpy as np
import jax.numpy as jnp
import pytest

from conftest import random_dna
from metagraph_tpu.anno.annotator import Annotation, LabelEncoder
from metagraph_tpu.anno.brwt import Brwt, build_brwt, relax_brwt
from metagraph_tpu.anno.matrix import RowSparse
from metagraph_tpu.anno.row_diff import RowDiff, build_row_diff
from metagraph_tpu.engine.annotated_dbg import AnnotatedDbg, annotate_sequences
from metagraph_tpu.graph.boss_construct import build_boss
from metagraph_tpu.graph.dbg_succinct import DbgSuccinct
from metagraph_tpu.kmer.alphabets import DNA


def rand_matrix(rng, num_rows, num_cols, density=0.15):
    dense = rng.random((num_rows, num_cols)) < density
    r, c = np.nonzero(dense)
    return dense, RowSparse.from_coo(r, c, num_rows, num_cols)


@pytest.fixture(scope="module")
def small_graph(rng):
    seqs = [random_dna(rng, 400) for _ in range(4)]
    g = DbgSuccinct.from_boss(build_boss(seqs, 11))
    return g, seqs


@pytest.mark.parametrize("num_rows,num_cols", [(64, 4), (200, 9), (100, 1)])
def test_brwt_matches_source(rng, num_rows, num_cols):
    dense, m = rand_matrix(rng, num_rows, num_cols)
    brwt = build_brwt(m)
    rows = np.arange(num_rows)
    np.testing.assert_array_equal(brwt.get_rows_dense(rows), dense)
    # roundtrip through serialization
    d = brwt.to_npz_dict()
    brwt2 = Brwt.from_npz_dict(d)
    np.testing.assert_array_equal(brwt2.get_rows_dense(rows), dense)
    # to_row_sparse roundtrip
    rs = brwt.to_row_sparse()
    np.testing.assert_array_equal(
        np.asarray(rs.rows), np.asarray(m.rows))
    np.testing.assert_array_equal(
        np.asarray(rs.cols), np.asarray(m.cols))


def test_brwt_relax(rng):
    dense, m = rand_matrix(rng, 128, 23)
    brwt = build_brwt(m)
    relaxed = relax_brwt(brwt, max_arity=8)
    rows = np.arange(128)
    np.testing.assert_array_equal(relaxed.get_rows_dense(rows), dense)
    assert relaxed.num_nodes() <= brwt.num_nodes()
    assert relaxed.avg_arity() >= brwt.avg_arity()


def test_brwt_sum_rows(rng):
    dense, m = rand_matrix(rng, 100, 9)
    brwt = build_brwt(m)
    rows = rng.integers(0, 100, size=20)
    w = rng.integers(1, 4, size=20)
    np.testing.assert_array_equal(
        brwt.sum_rows(rows, w), (dense[rows] * w[:, None]).sum(axis=0))


def graph_and_annotation(rng, k=7, n=3):
    seqs = [random_dna(rng, 200) for _ in range(n)]
    g = DbgSuccinct.from_boss(build_boss(seqs, k), DNA, "basic")
    ann = annotate_sequences(
        g, [(s, [f"l{i}"]) for i, s in enumerate(seqs)]).finalize()
    return g, ann, seqs


@pytest.mark.parametrize("max_length", [4, 32])
def test_row_diff_matches_source(rng, max_length):
    g, ann, seqs = graph_and_annotation(rng)
    m = ann.matrix
    rd = build_row_diff(m, g, max_length=max_length)
    rows = np.arange(m.num_rows)
    want = np.zeros((m.num_rows, m.num_cols), bool)
    want[np.asarray(m.rows), np.asarray(m.cols)] = True
    np.testing.assert_array_equal(rd.get_rows_dense(rows), want)
    # compression: deltas should be sparser than the source on paths
    assert rd.nnz <= m.nnz * 2
    # serialization roundtrip
    rd2 = RowDiff.from_npz_dict(rd.to_npz_dict())
    np.testing.assert_array_equal(rd2.get_rows_dense(rows), want)


def test_row_diff_compresses_runs(rng):
    """Nodes along a path share labels -> deltas vanish off anchors."""
    s = random_dna(rng, 400)
    g = DbgSuccinct.from_boss(build_boss([s], 9), DNA, "basic")
    ann = annotate_sequences(g, [(s, ["x"])]).finalize()
    rd = build_row_diff(ann.matrix, g, max_length=32)
    # all rows have label x; only anchors should store bits
    assert rd.nnz == rd.num_anchors()


def test_query_engine_with_compressed(rng, tmp_path):
    g, ann, seqs = graph_and_annotation(rng)
    brwt_ann = Annotation(matrix=build_brwt(ann.matrix), encoder=ann.encoder)
    rd_ann = Annotation(matrix=build_row_diff(ann.matrix, g),
                        encoder=ann.encoder)
    for a in (brwt_ann, rd_ann):
        path = str(tmp_path / f"{a.representation}.annodbg.npz")
        a.save(path)
        loaded = Annotation.load(path)
        adbg = AnnotatedDbg(graph=g, annotation=loaded)
        for i, s in enumerate(seqs):
            assert f"l{i}" in adbg.get_labels(s, presence_ratio=1.0)


def test_transform_anno_cli(rng, tmp_path, capsys):
    from metagraph_tpu.cli.main import main
    seqs = [random_dna(rng, 150) for _ in range(3)]
    fa = str(tmp_path / "in.fa")
    with open(fa, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">s{i}\n{s.decode()}\n")
    gpath = str(tmp_path / "g")
    main(["build", "-k", "9", "-o", gpath, fa])
    main(["annotate", "-i", gpath, "-o", str(tmp_path / "a"),
          "--anno-header", fa])
    col = str(tmp_path / "a.column.annodbg.npz")
    main(["transform_anno", "--anno-type", "brwt", "-o",
          str(tmp_path / "b"), col])
    main(["transform_anno", "--anno-type", "row_diff", "-i", gpath,
          "-o", str(tmp_path / "r"), col])
    # query through each representation gives identical output
    qfa = str(tmp_path / "q.fa")
    with open(qfa, "w") as f:
        f.write(f">q\n{seqs[1][10:100].decode()}\n")
    outs = []
    for anno in [col, str(tmp_path / "b.brwt.annodbg.npz"),
                 str(tmp_path / "r.row_diff.annodbg.npz")]:
        main(["query", "-i", gpath, "-a", anno,
              "--discovery-fraction", "1.0", qfa])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == outs[2]
    assert "s1" in outs[0]


def test_unique_row_matches_source(rng):
    from metagraph_tpu.anno.unique_row import UniqueRow
    # force duplicate rows
    dense = np.zeros((60, 5), bool)
    patterns = rng.random((6, 5)) < 0.4
    assign = rng.integers(0, 6, size=60)
    dense[:] = patterns[assign]
    r, c = np.nonzero(dense)
    m = RowSparse.from_coo(r, c, 60, 5)
    ur = UniqueRow.from_row_sparse(m)
    assert ur.num_distinct_rows <= 6 + 1
    np.testing.assert_array_equal(ur.presence(np.arange(60)), dense)
    w = rng.integers(1, 3, size=10).astype(np.int32)
    rows = rng.integers(0, 60, size=10)
    np.testing.assert_array_equal(ur.sum_rows(rows, w),
                                  (dense[rows] * w[:, None]).sum(axis=0))
    # serialization + expansion roundtrip
    ur2 = UniqueRow.from_npz_dict(ur.to_npz_dict())
    np.testing.assert_array_equal(ur2.presence(np.arange(60)), dense)
    rs = ur.to_row_sparse()
    np.testing.assert_array_equal(np.asarray(rs.rows), np.asarray(m.rows))
    np.testing.assert_array_equal(np.asarray(rs.cols), np.asarray(m.cols))


def test_int_row_diff_matches_source(rng):
    from metagraph_tpu.anno.row_diff import IntRowDiff, build_int_row_diff
    seqs = [random_dna(rng, 200) for _ in range(3)]
    g = DbgSuccinct.from_boss(build_boss(seqs, 7), DNA, "basic")
    ann = annotate_sequences(
        g, [(s, [f"l{i}"]) for i, s in enumerate(seqs)],
        with_counts=True).finalize()
    m = ann.matrix
    ird = build_int_row_diff(m, g, max_length=16)
    want = np.zeros((m.num_rows, m.num_cols), np.int64)
    want[np.asarray(m.rows), np.asarray(m.cols)] = np.asarray(m.values)
    got = ird.get_row_values_dense(np.arange(m.num_rows))
    np.testing.assert_array_equal(got, want)
    # roundtrip
    ird2 = IntRowDiff.from_npz_dict(ird.to_npz_dict())
    np.testing.assert_array_equal(
        ird2.get_row_values_dense(np.arange(m.num_rows)), want)
    # query-surface compatibility
    rows = rng.integers(0, m.num_rows, size=12)
    w = np.ones(12, np.int32)
    np.testing.assert_array_equal(ird.sum_row_values(rows, w),
                                  want[rows].sum(axis=0))


def test_rainbow_brwt_and_vectorized_unique(rng):
    """Rainbow<BRWT> distinct store + vectorized row dedup
    (rainbowfish/rainbow.hpp:15)."""
    from metagraph_tpu.anno.matrix import RowSparse
    from metagraph_tpu.anno.unique_row import UniqueRow

    R, C = 240, 11
    dense = rng.random((R, C)) < 0.2
    dense[60:120] = dense[0:60]          # force duplicate rows
    r, c = np.nonzero(dense)
    ur = UniqueRow.from_row_sparse(RowSparse.from_coo(r, c, R, C))
    np.testing.assert_array_equal(ur.presence(np.arange(R)), dense)
    assert ur.num_distinct_rows < R - 40
    rb = ur.with_brwt_distinct()
    np.testing.assert_array_equal(rb.presence(np.arange(R)), dense)
    np.testing.assert_array_equal(
        rb.to_row_sparse().presence(
            jnp.asarray(np.arange(R, dtype=np.int32))), dense)


def test_row_diff_brwt_round_trip(rng, small_graph):
    """RowDiff over BRWT diffs (RowDiffBRWT annotator role)."""
    from metagraph_tpu.anno.matrix import RowSparse
    from metagraph_tpu.anno.row_diff import RowDiffBrwt, build_row_diff_brwt

    g, _seqs = small_graph
    N = g.num_nodes()
    dense = rng.random((N, 7)) < 0.12
    r, c = np.nonzero(dense)
    rdb = build_row_diff_brwt(RowSparse.from_coo(r, c, N, 7), g)
    q = rng.integers(0, N, 150)
    np.testing.assert_array_equal(rdb.get_rows_dense(q), dense[q])
    rdb2 = RowDiffBrwt.from_npz_dict(rdb.to_npz_dict())
    np.testing.assert_array_equal(rdb2.get_rows_dense(q), dense[q])


def test_tuple_row_diff(rng, small_graph):
    """Coordinate row-diff (tuple_row_diff.hpp:27): unit-shift symmetric
    differences cancel along paths; reconstruction matches the raw
    coordinate matrix."""
    from metagraph_tpu.anno.coords import (CoordMatrix, TupleRowDiff,
                                           build_tuple_row_diff)

    g, seqs = small_graph
    N = g.num_nodes()
    rows, cols, coords = [], [], []
    for label, s in enumerate(seqs[:3]):
        nodes = np.asarray(g.map_to_nodes(s))
        for pos, nd in enumerate(nodes):
            if nd > 0:
                rows.append(nd - 1)
                cols.append(label)
                coords.append(pos)
    cm = CoordMatrix.from_triples(np.array(rows), np.array(cols),
                                  np.array(coords), N, 3)
    trd = build_tuple_row_diff(cm, g)
    # unit-shift cancellation: interiors store nothing
    assert trd.nnz < cm.nnz / 5
    qr = np.unique(np.array(rows))[:60]
    for col in range(3):
        want = cm.get_tuples(qr, col)
        got = trd.get_tuples(qr, col)
        assert all(sorted(a) == sorted(b) for a, b in zip(want, got))
    trd2 = TupleRowDiff.from_npz_dict(trd.to_npz_dict())
    got2 = trd2.get_tuples(qr, 1)
    assert all(sorted(a) == sorted(b)
               for a, b in zip(cm.get_tuples(qr, 1), got2))


def test_linkage_file_roundtrip(rng, tmp_path):
    """--linkage writes the reference-format file; feeding it back via
    --linkage-file builds a BRWT answering identically."""
    from metagraph_tpu.anno.brwt import build_brwt, compute_linkage
    from metagraph_tpu.anno.annotator import Annotation, LabelEncoder
    dense, m = rand_matrix(rng, 120, 7)
    rows = compute_linkage(m)
    assert rows and all(r[3] >= 7 for r in rows)
    guided = build_brwt(m, linkage=rows)
    np.testing.assert_array_equal(
        guided.get_rows_dense(np.arange(120)), dense)
    # CLI roundtrip
    from metagraph_tpu.cli.main import main
    ann = Annotation(matrix=m, encoder=LabelEncoder(
        [f"l{i}" for i in range(7)]))
    col = str(tmp_path / "a.column.annodbg.npz")
    ann.save(col)
    main(["transform_anno", "--linkage", "--greedy",
          "-o", str(tmp_path / "lk"), col])
    lk = str(tmp_path / "lk") + ".linkage"
    assert len(open(lk).read().splitlines()) == 6   # n-1 merges
    main(["transform_anno", "--anno-type", "brwt", "--linkage-file", lk,
          "-o", str(tmp_path / "g"), col])
    got = Annotation.load(str(tmp_path / "g") + ".brwt.annodbg.npz")
    np.testing.assert_array_equal(
        got.matrix.get_rows_dense(np.arange(120)), dense)


def test_aggregate_columns(rng, tmp_path):
    from metagraph_tpu.anno.annotator import Annotation, LabelEncoder
    from metagraph_tpu.cli.main import main
    dense, m = rand_matrix(rng, 90, 5, density=0.4)
    ann = Annotation(matrix=m, encoder=LabelEncoder(
        [f"c{i}" for i in range(5)]))
    col = str(tmp_path / "agg.column.annodbg.npz")
    ann.save(col)
    main(["transform_anno", "--aggregate-columns", "--min-count", "3",
          "-o", str(tmp_path / "agg_out"), col])
    out = Annotation.load(str(tmp_path / "agg_out") + ".column.annodbg.npz")
    assert out.encoder.labels == ["mask"]
    want = np.nonzero(dense.sum(axis=1) >= 3)[0]
    np.testing.assert_array_equal(np.asarray(out.matrix.rows), want)


def test_linkage_multichild_rows(rng):
    """Merged cluster ids repeated across linkage rows accumulate
    children (the reference's multi-child encoding) — no columns are
    dropped."""
    from metagraph_tpu.anno.brwt import build_brwt
    dense, m = rand_matrix(rng, 60, 4, density=0.3)
    linkage = [(0, 1, 0.0, 4), (2, 3, 0.0, 4)]   # one 4-child cluster
    brwt = build_brwt(m, linkage=linkage)
    np.testing.assert_array_equal(
        brwt.get_rows_dense(np.arange(60)), dense)
