"""CPU checks of the run-time plumbing: the compile-cache directory, the
benchmark's bandwidth table, and chip_smoke.py's device check, data
generator, numpy oracles and its main path at a small size."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import metagraph_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402

TINY = chip_smoke.Sizes(genome=6_000, contigs=4, query_reads=50)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    # conftest sets the variable before the package is imported: the
    # package then leaves JAX's own reading of it in place
    assert jax.config.jax_compilation_cache_dir == \
        os.environ["JAX_COMPILATION_CACHE_DIR"]
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert metagraph_tpu.compile_cache_dir() == str(tmp_path)


def test_compile_cache_default_is_in_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, metagraph_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, check=True, capture_output=True, text=True)
    want = os.path.join(REPO, ".jax_cache")
    assert out.stdout.strip() == want
    assert ".jax_cache/" in open(os.path.join(REPO, ".gitignore")).read()


def test_bench_bandwidth_table():
    assert bench.hbm_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert bench.hbm_bandwidth("NVIDIA H100 PCIe") == 2.0e12
    with pytest.raises(KeyError):
        bench.hbm_bandwidth("cpu")


def test_bench_corpus_shape():
    seqs = bench.make_corpus()
    assert len(seqs) == bench.N_SEQS
    assert sum(map(len, seqs)) == bench.CORPUS_BP
    assert seqs == bench.make_corpus()


def test_chip_smoke_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_data_is_seeded():
    a = chip_smoke.make_data(TINY, 3)
    b = chip_smoke.make_data(TINY, 3)
    c = chip_smoke.make_data(TINY, 4)
    assert np.array_equal(a.reads, b.reads)
    assert np.array_equal(a.genome, b.genome)
    assert not np.array_equal(a.genome, c.genome)
    assert a.reads.shape == (TINY.num_reads, TINY.read_len)
    # error-free reads are exact copies of their locus (either strand)
    i = np.nonzero(a.error_free & ~a.reverse)[0][0]
    s = a.starts[i]
    assert np.array_equal(a.reads[i], a.genome[s:s + TINY.read_len])


@pytest.fixture(scope="module")
def tiny_graph():
    from metagraph_tpu.graph.boss_construct import build_boss
    from metagraph_tpu.graph.dbg_succinct import DbgSuccinct
    data = chip_smoke.make_data(TINY, 0)
    seqs = [chip_smoke.LETTERS[r].tobytes() for r in data.reads]
    boss = build_boss(seqs, TINY.k, mode="canonical")
    return data, DbgSuccinct.from_boss(boss, mode="canonical")


def test_chip_smoke_kmer_oracle_matches_build(tiny_graph):
    data, g = tiny_graph
    canon = np.unique(chip_smoke.canonical_kmers(
        chip_smoke.joined(data.reads), TINY.k))
    assert int(g.num_nodes()) == 2 * len(canon)


def test_chip_smoke_label_oracle_matches_query(tiny_graph):
    from metagraph_tpu.engine.annotated_dbg import (AnnotatedDbg, BatchQuery,
                                                    annotate_sequences)
    data, g = tiny_graph
    k = TINY.k
    contigs = [data.genome[a:b] for a, b in
               zip(data.contig_starts[:-1], data.contig_starts[1:])]
    items = [(chip_smoke.LETTERS[c].tobytes(), [str(i)])
             for i, c in enumerate(contigs)]
    adbg = AnnotatedDbg(graph=g,
                        annotation=annotate_sequences(g, items).finalize())
    reads = data.reads[:TINY.query_reads]
    got = BatchQuery(adbg).get_labels_batch(
        [chip_smoke.LETTERS[r].tobytes() for r in reads], TINY.discovery)
    graph_kmers = np.unique(chip_smoke.canonical_kmers(
        chip_smoke.joined(data.reads), k))
    want = chip_smoke.label_oracle(
        reads, [np.unique(chip_smoke.canonical_kmers(c, k)) for c in contigs],
        graph_kmers, k, TINY.discovery)
    assert [set(int(x) for x in labels) for labels in got] == want
    assert any(want) and not all(want)


def test_chip_smoke_main_path_on_cpu(tmp_path, capsys):
    """Phases (b)-(h) of the smoke, every check included, at a small size
    on the CPU backend the tests pin."""
    sizes = chip_smoke.Sizes(genome=20_000, contigs=4, slice_bp=5_000,
                             query_reads=200, align_reads=600,
                             gold_reads=50)
    chip_smoke.run_main_path(sizes, 0, str(tmp_path))
    out = capsys.readouterr().out
    for name in ("(b) build", "(c) GPU vs CPU build", "(d) assemble",
                 "(e) annotate", "(f) query", "(g) align",
                 "(h) server_query"):
        assert f"phase {name}" in out
