"""Smoke test of the main path on one GPU, or on four with ``--four-gpu``.

Generates an E. coli-scale read set from ``--seed`` (BASELINE.json config
2: a 4.6 Mbp genome cut into 64 labelled contigs, 100 bp reads at 10x
coverage with 0.5% substitutions) and drives it through the ``metagraph``
CLI entry point (build, stats, assemble, annotate, transform_anno, query,
align) and through ``server_query`` seen from the Python client. Every
result is compared exactly with an independent numpy oracle: the path is
integer-only, and its one matrix product (bf16 0/1 operands, f32
accumulation) is exact below 2^24 rows.

``--four-gpu`` runs only the paths that exist across cards: the sharded
build on a 4-card mesh against the single-card build, and the
column-sharded query step against a dense numpy count.

One process drives the card(s); the only child process is the CPU build
of phase (c), which never opens a card. Each phase prints its wall time;
any failure exits non-zero. The last stdout line is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.

    python chip_smoke.py [--seed N] [--four-gpu]
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
LETTERS = np.frombuffer(b"ACGT", np.uint8)
SEP = 4                          # separator code between sequences


@dataclass(frozen=True)
class Sizes:
    genome: int = 4_600_000
    contigs: int = 64
    read_len: int = 100
    coverage: int = 10
    sub_rate: float = 0.005
    k: int = 31
    slice_bp: int = 2_000_000    # phase (c): GPU vs CPU bit identity
    query_reads: int = 10_000
    discovery: float = 0.9
    align_reads: int = 2_000
    gold_reads: int = 200
    requests: int = 5

    @property
    def num_reads(self) -> int:
        return self.genome * self.coverage // self.read_len


@dataclass
class Data:
    genome: np.ndarray           # (G,) uint8 codes 0..3
    contig_starts: np.ndarray    # (contigs + 1,) contig i = [s_i, s_i+1)
    reads: np.ndarray            # (N, read_len) uint8 codes 0..3
    starts: np.ndarray           # (N,) genome offset of each read
    reverse: np.ndarray          # (N,) read is the reverse complement
    subs: np.ndarray             # (N,) substitutions in the read

    @property
    def error_free(self) -> np.ndarray:
        return self.subs == 0


def sample_reads(genome: np.ndarray, n: int, sizes: Sizes, rng) -> Data:
    """``n`` reads from random loci and strands, with substitutions."""
    rl = sizes.read_len
    starts = rng.integers(0, len(genome) - rl + 1, n)
    reads = genome[starts[:, None] + np.arange(rl)]
    err = rng.random((n, rl)) < sizes.sub_rate
    reads[err] = (reads[err] + rng.integers(1, 4, int(err.sum()),
                                            dtype=np.uint8)) % 4
    reverse = rng.random(n) < 0.5
    reads[reverse] = 3 - reads[reverse, ::-1]
    contig_starts = np.linspace(0, len(genome), sizes.contigs + 1
                                ).astype(np.int64)
    return Data(genome, contig_starts, reads, starts, reverse,
                err.sum(axis=1))


def make_data(sizes: Sizes, seed: int) -> Data:
    """Random genome and its read set: deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, sizes.genome, dtype=np.uint8)
    return sample_reads(genome, sizes.num_reads, sizes, rng)


# ---------------------------------------------------------------------------
# numpy oracles
# ---------------------------------------------------------------------------

def joined(seqs) -> np.ndarray:
    """Code arrays concatenated with a separator after each."""
    parts = []
    for s in seqs:
        parts += [np.asarray(s, np.uint8), np.array([SEP], np.uint8)]
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def canonical_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """min(k-mer, reverse complement) as 2k-bit integers, one per window
    of ``codes`` (0..3, SEP between sequences) that holds no SEP."""
    n = len(codes)
    if n < k:
        return np.zeros(0, np.uint64)
    nw = n - k + 1
    bad = np.concatenate([[0], np.cumsum(codes > 3)])
    ok = (bad[k:] - bad[:-k]) == 0
    c = np.minimum(codes, 3).astype(np.uint64)
    fwd = np.zeros(nw, np.uint64)
    rc = np.zeros(nw, np.uint64)
    two = np.uint64(2)
    for j in range(k):
        fwd = (fwd << two) | c[j:j + nw]
        rc = (rc << two) | (np.uint64(3) - c[k - 1 - j:k - 1 - j + nw])
    return np.minimum(fwd, rc)[ok]


def label_oracle(read_rows: np.ndarray, contig_kmers, graph_kmers,
                 k: int, discovery: float):
    """Label set of each read, by the query semantics: a label is
    reported when at least max(1, ceil(discovery * windows)) of the
    read's windows carry it, and only when as many windows are in the
    graph at all."""
    nw = read_rows.shape[1] - k + 1
    wins = canonical_kmers(joined(read_rows), k).reshape(len(read_rows), nw)
    keys = np.concatenate(contig_kmers)
    labs = np.concatenate([np.full(len(x), i) for i, x in
                           enumerate(contig_kmers)])
    order = np.argsort(keys, kind="stable")
    keys, labs = keys[order], labs[order]
    flat = wins.reshape(-1)
    lo = np.searchsorted(keys, flat, "left")
    hi = np.searchsorted(keys, flat, "right")
    lens = hi - lo
    rid = np.repeat(np.arange(flat.size) // nw, lens)
    offs = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens)
    counts = np.zeros((len(read_rows), len(contig_kmers)), np.int64)
    np.add.at(counts, (rid, labs[np.repeat(lo, lens) + offs]), 1)
    pos = np.minimum(np.searchsorted(graph_kmers, flat), len(graph_kmers) - 1)
    n_present = (graph_kmers[pos] == flat).reshape(-1, nw).sum(axis=1)
    min_count = max(1, math.ceil(discovery * nw))
    return [set() if n_present[r] < min_count
            else set(np.nonzero(counts[r] >= min_count)[0].tolist())
            for r in range(len(read_rows))]


# ---------------------------------------------------------------------------
# files and the CLI
# ---------------------------------------------------------------------------

def write_fasta(path: str, names, rows) -> None:
    with open(path, "wb") as f:
        for name, row in zip(names, rows):
            f.write(b">" + name.encode() + b"\n"
                    + LETTERS[np.asarray(row)].tobytes() + b"\n")


def read_fasta_codes(path: str):
    tbl = np.full(256, SEP, np.uint8)
    tbl[LETTERS] = np.arange(4, dtype=np.uint8)
    opener = gzip.open if path.endswith(".gz") else open
    seqs, cur = [], []
    with opener(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                if cur:
                    seqs.append(tbl[np.frombuffer(b"".join(cur), np.uint8)])
                cur = []
            else:
                cur.append(line.strip())
    if cur:
        seqs.append(tbl[np.frombuffer(b"".join(cur), np.uint8)])
    return seqs


def cli(*argv: str) -> str:
    """One ``metagraph`` command in this process; returns its stdout."""
    from metagraph_tpu.cli.main import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([str(a) for a in argv])
    return buf.getvalue()


def stats_field(text: str, key: str) -> int:
    for line in text.splitlines():
        if line.startswith(key + ":"):
            return int(line.split(":", 1)[1])
    raise AssertionError(f"no '{key}' line in stats output:\n{text}")


def parse_query(text: str, n: int):
    out = [None] * n
    for line in text.splitlines():
        idx, _name, labels = line.split("\t")
        out[int(idx)] = set(labels.split(":")) if labels else set()
    assert all(x is not None for x in out), "query skipped reads"
    return out


@contextlib.contextmanager
def phase(name: str):
    t0 = time.time()
    yield
    print(f"phase {name}: ok {time.time() - t0:.2f} s", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------

def run_main_path(sizes: Sizes, seed: int, work: str) -> None:
    """Phases (b)-(h); phase (a), the device check, comes before."""
    k = sizes.k
    with phase("data"):
        data = make_data(sizes, seed)
        names = [f"r{i}" for i in range(len(data.reads))]
        reads_fa = os.path.join(work, "reads.fa")
        write_fasta(reads_fa, names, data.reads)
        contig_names = [f"contig_{i:02d}" for i in range(sizes.contigs)]
        contigs = [data.genome[a:b] for a, b in
                   zip(data.contig_starts[:-1], data.contig_starts[1:])]
        contigs_fa = os.path.join(work, "contigs.fa")
        write_fasta(contigs_fa, contig_names, contigs)
        graph_kmers = np.unique(canonical_kmers(joined(data.reads), k))
        contig_kmers = [np.unique(canonical_kmers(c, k)) for c in contigs]
        print(f"  {len(data.reads)} reads, "
              f"{data.reads.size / 1e6:.1f} Mbp; "
              f"{len(graph_kmers)} distinct canonical {k}-mers", flush=True)

    graph = os.path.join(work, "graph")
    with phase("(b) build"):
        cli("build", "-k", k, "--mode", "canonical", "--count-kmers",
            "-o", graph, reads_fa)
        nodes = stats_field(cli("stats", graph + ".dbg.npz"), "nodes (k)")
        # odd k: no k-mer is its own reverse complement
        check(nodes == 2 * len(graph_kmers),
              f"nodes (k) {nodes} != numpy {2 * len(graph_kmers)}")
        print(f"  nodes (k) {nodes} == numpy count", flush=True)

    with phase("(c) GPU vs CPU build"):
        n_slice = max(1, sizes.slice_bp // sizes.read_len)
        slice_fa = os.path.join(work, "slice.fa")
        write_fasta(slice_fa, names[:n_slice], data.reads[:n_slice])
        flags = ["build", "-k", str(k), "--mode", "canonical",
                 "--count-kmers"]
        cli(*flags, "-o", os.path.join(work, "slice_gpu"), slice_fa)
        env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
        subprocess.run([sys.executable, "-m", "metagraph_tpu.cli.main",
                        *flags, "-o", os.path.join(work, "slice_cpu"),
                        slice_fa], cwd=REPO, env=env, check=True,
                       stdout=subprocess.DEVNULL)
        from metagraph_tpu.graph import io as graph_io
        a = graph_io.load_graph(os.path.join(work, "slice_gpu.dbg.npz")).boss
        b = graph_io.load_graph(os.path.join(work, "slice_cpu.dbg.npz")).boss
        for f in ("W", "last", "F", "weights"):
            check(np.array_equal(np.asarray(getattr(a, f)),
                                 np.asarray(getattr(b, f))),
                  f"{f} differs between the GPU and the CPU build")
        print(f"  {n_slice} reads: W/last/F/weights identical "
              f"({a.num_edges} edges)", flush=True)

    with phase("(d) assemble --unitigs"):
        cli("assemble", "-i", graph + ".dbg.npz", "--unitigs",
            "-o", os.path.join(work, "unitigs"))
        unitigs = read_fasta_codes(os.path.join(work, "unitigs.fasta.gz"))
        got = np.unique(canonical_kmers(joined(unitigs), k))
        check(np.array_equal(got, graph_kmers),
              "unitig k-mers differ from the graph's")
        print(f"  {len(unitigs)} unitigs cover the graph's k-mers",
              flush=True)

    anno = os.path.join(work, "anno")
    annos = {t: f"{anno}.{t}.annodbg.npz"
             for t in ("column", "brwt", "row_diff")}
    with phase("(e) annotate + transform_anno"):
        cli("annotate", "-i", graph + ".dbg.npz", "--anno-header",
            "-o", anno, contigs_fa)
        cli("transform_anno", "--anno-type", "brwt", "-o", anno,
            annos["column"])
        cli("transform_anno", "--anno-type", "row_diff",
            "-i", graph + ".dbg.npz", "-o", anno, annos["column"])
        for t, path in annos.items():
            n_labels = stats_field(cli("stats", path), "labels")
            check(n_labels == sizes.contigs,
                  f"{t}: {n_labels} labels, want {sizes.contigs}")

    rng = np.random.default_rng(seed + 1)
    q_idx = np.sort(rng.choice(len(data.reads), sizes.query_reads,
                               replace=False))
    want = [{contig_names[c] for c in s} for s in
            label_oracle(data.reads[q_idx], contig_kmers, graph_kmers, k,
                         sizes.discovery)]
    with phase("(f) query"):
        q_fa = os.path.join(work, "q.fa")
        write_fasta(q_fa, [names[i] for i in q_idx], data.reads[q_idx])
        for t, path in annos.items():
            got = parse_query(cli("query", "-i", graph + ".dbg.npz",
                                  "-a", path, "--discovery-fraction",
                                  sizes.discovery, q_fa), len(q_idx))
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            check(not bad, f"{t}: {len(bad)} reads differ from the oracle, "
                  f"first {bad[:5]}")
        print(f"  {len(q_idx)} reads x {len(annos)} annotations == oracle "
              f"({sum(1 for w in want if w)} labelled)", flush=True)

    with phase("(g) align"):
        # half from the read set (each read's own k-mers form a path of
        # the graph), half fresh (their substitutions, as a rule, are not)
        n_own = sizes.align_reads // 2
        own = np.sort(rng.choice(len(data.reads), n_own, replace=False))
        fresh = sample_reads(data.genome, sizes.align_reads - n_own, sizes,
                             rng)
        reads = np.concatenate([data.reads[own], fresh.reads])
        a_fa = os.path.join(work, "a.fa")
        out = os.path.join(work, "a.tsv")
        write_fasta(a_fa, [f"a{i}" for i in range(len(reads))], reads)
        cli("align", "-i", graph + ".dbg.npz", "-o", out, a_fa)
        rows = [ln.split("\t") for ln in open(out).read().splitlines()]
        check(len(rows) == len(reads), "align skipped reads")
        scores = np.array([int(r[4]) for r in rows])
        aligned = np.array([r[2] != "*" for r in rows])
        full = 2 * sizes.read_len
        check(bool(aligned[:n_own].all())
              and bool((scores[:n_own] == full).all()),
              "a read of the read set did not align at 2 x length")

        def in_graph(rows_):
            w = canonical_kmers(joined(rows_), k).reshape(len(rows_), -1)
            pos = np.minimum(np.searchsorted(graph_kmers, w),
                             len(graph_kmers) - 1)
            return w, graph_kmers[pos] == w

        # A fresh read with a seed (a k-mer in the graph) whose true locus
        # is a path of the graph (every locus k-mer is a node) has the
        # ungapped alignment along that path, scoring 2 per match and -3
        # per substitution. Where no k-mer of the read off its locus is in
        # the graph, nothing else matches it as well: it must align, at
        # that score or better. A read-set error that repeats a fresh
        # read's substitution forms such a k-mer (a tip the beam can take
        # instead of the locus); those reads, and reads across a coverage
        # gap of the read set, are counted, not checked.
        read_w, read_in = in_graph(fresh.reads)
        locus = data.genome[fresh.starts[:, None] + np.arange(sizes.read_len)]
        locus[fresh.reverse] = 3 - locus[fresh.reverse, ::-1]  # read strand
        locus_w, locus_in = in_graph(locus)
        seeded = read_in.any(axis=1)
        on_graph = seeded & locus_in.all(axis=1)
        off_locus = (read_in & (read_w != locus_w)).any(axis=1)
        clean = on_graph & ~off_locus
        f_aligned, f_scores = aligned[n_own:], scores[n_own:]
        floor = 2 * (sizes.read_len - fresh.subs) - 3 * fresh.subs
        miss = np.nonzero(clean & ~f_aligned)[0]
        check(not len(miss), f"{len(miss)} fresh reads on the graph did "
              f"not align, first {miss[:5].tolist()}")
        low = np.nonzero(clean & (f_scores < floor))[0]
        check(not len(low), f"{len(low)} fresh reads scored below their "
              f"locus path, first {low[:5].tolist()}")
        # gold DP of read vs reported path, on fresh alignments without
        # gaps or clips (the beam's alignment is then the whole pair)
        from metagraph_tpu.align.aligner import batch_align_scores_reference
        from metagraph_tpu.align.batch_extender import batched_ends
        ungapped = [i for i in range(n_own, len(rows))
                    if rows[i][2] == "+" and len(rows[i][3]) == sizes.read_len
                    and {c for c in rows[i][6] if not c.isdigit()}
                    <= {"=", "X"}]
        # mismatched alignments first: they exercise the scoring
        sel = sorted(ungapped, key=lambda i: scores[i] == full
                     )[:sizes.gold_reads]
        check(len(sel) == sizes.gold_reads, "too few ungapped alignments")
        q = reads[sel].astype(np.int32) + 1
        tbl = np.zeros(256, np.int32)
        tbl[LETTERS] = np.arange(1, 5)
        ref = tbl[np.stack([np.frombuffer(rows[i][3].encode(), np.uint8)
                            for i in sel])]
        lens = np.full(len(sel), sizes.read_len, np.int32)
        gold = batch_align_scores_reference(q, ref, lens, lens)
        check(np.array_equal(gold, scores[sel]),
              "reported scores differ from the gold DP")
        # the device DP the score-only path runs, on fresh reads against
        # their true loci
        fwd = np.nonzero(~fresh.reverse)[0][:sizes.gold_reads]
        q2 = fresh.reads[fwd].astype(np.int32) + 1
        r2 = data.genome[fresh.starts[fwd][:, None]
                         + np.arange(sizes.read_len)].astype(np.int32) + 1
        lens2 = np.full(len(fwd), sizes.read_len, np.int32)
        dev = batched_ends(q2, r2, lens2, lens2, open_p=5, ext_p=2,
                           match=2, tpen=3, tvpen=3)[:, 0]
        check(np.array_equal(dev, batch_align_scores_reference(
            q2, r2, lens2, lens2)), "device DP differs from the gold DP")
        repeated, gap = on_graph & off_locus, seeded & ~on_graph
        n = {name: int(m.sum()) for name, m in (
            ("aligned", f_aligned), ("clean", clean),
            ("clean_exact", clean & fresh.error_free),
            ("repeated", repeated), ("repeated_low", repeated
                                     & (f_scores < floor)),
            ("gap", gap), ("gap_unaligned", gap & ~f_aligned))}
        print(f"  {n_own} read-set reads at 2 x length; fresh reads: "
              f"{n['aligned']}/{len(fresh.reads)} aligned, {n['clean']} on "
              f"the graph all at or above their locus path "
              f"({n['clean_exact']} error-free at 2 x length); "
              f"{n['repeated']} with a repeated substitution "
              f"({n['repeated_low']} below their locus path), {n['gap']} "
              f"across a coverage gap ({n['gap_unaligned']} unaligned); "
              f"{len(sel)} scores == gold DP "
              f"({int((scores[sel] < full).sum())} with mismatches); "
              f"device DP == gold on {len(fwd)} read/locus pairs",
              flush=True)

    with phase("(h) server_query via GraphClient"):
        from metagraph_tpu.align.aligner import Aligner
        from metagraph_tpu.anno.annotator import Annotation
        from metagraph_tpu.engine.annotated_dbg import AnnotatedDbg
        from metagraph_tpu.graph import io as graph_io
        from metagraph_tpu.server.client import GraphClient
        from metagraph_tpu.server.http_server import serve
        g = graph_io.load_graph(graph + ".dbg.npz")
        adbg = AnnotatedDbg(graph=g,
                            annotation=Annotation.load(annos["column"]))
        httpd = serve(adbg, Aligner(g), port=0, background=True)
        try:
            client = GraphClient("127.0.0.1", httpd.server_address[1])
            per = -(-len(q_idx) // sizes.requests)
            for j in range(sizes.requests):
                chunk = range(j * per, min((j + 1) * per, len(q_idx)))
                seqs = [LETTERS[data.reads[q_idx[i]]].tobytes().decode()
                        for i in chunk]
                recs = client.search(seqs, top_labels=sizes.contigs,
                                     discovery_threshold=sizes.discovery)
                got = [set() for _ in chunk]
                for rec in recs:
                    got[int(rec["seq_description"])].add(rec["sample"])
                check(got == [want[i] for i in chunk],
                      f"request {j}: answers differ from phase (f)")
        finally:
            httpd.shutdown()
            httpd.server_close()
        print(f"  {sizes.requests} /search requests == phase (f)",
              flush=True)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def run_four_gpu(sizes: Sizes, seed: int, n_dev: int = 4) -> None:
    import jax
    import jax.numpy as jnp
    from metagraph_tpu.engine.annotated_dbg import annotate_sequences
    from metagraph_tpu.graph.boss_construct import build_boss
    from metagraph_tpu.graph.dbg_succinct import DbgSuccinct
    from metagraph_tpu.parallel.distributed import (
        build_boss_distributed_full, build_distributed_query_step,
        make_mesh, shard_annotation_coo)
    check(len(jax.devices()) >= n_dev, f"need {n_dev} devices")
    k = sizes.k
    with phase("data"):
        data = make_data(sizes, seed)
        seqs = [LETTERS[r].tobytes() for r in data.reads]
    mesh = make_mesh(n_dev)
    # twice: the first includes compilation, the second is the run alone
    for run in ("compile + run", "run"):
        with phase(f"sharded build on {n_dev} cards ({run})"):
            dist = build_boss_distributed_full(seqs, k, mesh,
                                               mode="canonical",
                                               bits_per_count=8)
            jax.block_until_ready(dist.F)
    with phase("single-card build"):
        plain = build_boss(seqs, k, mode="canonical", bits_per_count=8)
        jax.block_until_ready(plain.F)
    for f in ("W", "last", "F", "weights", "edge_lanes"):
        check(np.array_equal(np.asarray(getattr(dist, f)),
                             np.asarray(getattr(plain, f))),
              f"sharded build differs from the single-card build in {f}")
    print(f"  sharded build == single-card build ({plain.num_edges} edges)",
          flush=True)

    with phase(f"column-sharded query on {n_dev} cards"):
        g = DbgSuccinct.from_boss(plain, mode="canonical")
        items = [(LETTERS[data.genome[a:b]].tobytes(), [f"contig_{i:02d}"])
                 for i, (a, b) in enumerate(zip(data.contig_starts[:-1],
                                                data.contig_starts[1:]))]
        m = annotate_sequences(g, items).finalize().matrix
        rows, cols = np.asarray(m.rows), np.asarray(m.cols)
        rows_sh, cols_sh = shard_annotation_coo(rows, cols, m.num_rows,
                                                m.num_cols, n_dev)
        rng = np.random.default_rng(seed + 2)
        nq = 1 << 16
        q = np.sort(rng.choice(m.num_rows, nq, replace=False)).astype(np.int32)
        w = rng.integers(1, 4, nq).astype(np.int32)
        step = build_distributed_query_step(
            mesh, m.num_rows, m.num_cols,
            nnz_cap=len(rows_sh) // n_dev, query_cap=nq)
        got = np.asarray(step(jnp.asarray(rows_sh), jnp.asarray(cols_sh),
                              jnp.asarray(q), jnp.asarray(w)))
        pos = np.minimum(np.searchsorted(q, rows), nq - 1)
        hit = q[pos] == rows
        dense = np.zeros(m.num_cols, np.int64)
        np.add.at(dense, cols[hit], w[pos[hit]])
        check(np.array_equal(got, dense),
              "column-sharded counts differ from the dense numpy count")
        print(f"  {m.num_cols} columns, {len(rows)} relations: counts == "
              f"numpy", flush=True)
    for d in jax.devices()[:n_dev]:
        print(f"  {d}: peak_bytes_in_use "
              f"{d.memory_stats()['peak_bytes_in_use']}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-gpu", action="store_true",
                    help="run only the sharded build and the column-"
                         "sharded query on four cards")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import metagraph_tpu
    from metagraph_tpu.common.device import (card_name_and_power_limit,
                                             require_gpu)
    import jax
    with phase("(a) device"):
        dev = require_gpu()
        print(f"  {card_name_and_power_limit()}", flush=True)
        print(f"  jax {jax.__version__}; {len(jax.devices())} x "
              f"{dev.device_kind}; compile cache "
              f"{metagraph_tpu.compile_cache_dir()}", flush=True)
    sizes = Sizes()
    if args.four_gpu:
        run_four_gpu(sizes, args.seed)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            run_main_path(sizes, args.seed, work)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
