"""The ``metagraph`` CLI: subcommand dispatch + reference-compatible outputs.

Mirrors the reference CLI surface (metagraph/src/cli/main.cpp:37-91,
config/config.cpp): build / clean / extend / merge / concatenate /
compare / align / stats / annotate / transform / transform_anno /
assemble / query / server_query, with the same flag names for the
common options and the same stdout formats for `stats` and `query`
(the cross-implementation behavioural contract asserted by the
reference's own integration tests).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np


def log(msg: str):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _load_graph(path, wrap_primary: bool = True):
    from ..graph import io as graph_io
    g = graph_io.load_graph(path)
    if wrap_primary and g.mode == "primary":
        # present PRIMARY graphs through the canonical wrapper
        # (reference load_annotated_graph.cpp)
        from ..graph.canonical import CanonicalDbg
        return CanonicalDbg(base=g)
    return g


def _read_input_sequences(files: Sequence[str]):
    from ..seqio.fasta import parse_records
    records = []
    for f in files:
        records.extend(parse_records(f))
    return records


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def cmd_build(args):
    from ..graph.boss_construct import build_boss
    from ..graph.dbg_succinct import DbgSuccinct
    from ..graph import io as graph_io
    from ..kmer.alphabets import ALPHABETS
    from ..parallel.sharded_build import build_boss_sharded

    if not args.fnames and not sys.stdin.isatty():
        # reference workflow: `find . -name "*.fa" | metagraph build ...`
        # reads the input file list from stdin (quick_start.rst:53)
        args.fnames = [ln.strip() for ln in sys.stdin if ln.strip()]
    assert args.fnames, "no input files (arguments or stdin list)"

    DNA = ALPHABETS[args.alphabet]

    mode = args.mode
    bits_per_count = args.count_width if args.count_kmers else 0
    if any(f.endswith((".kmc_pre", ".kmc_suf")) for f in args.fnames):
        # KMC database input (reference kmc_parser path)
        from ..graph.boss_construct import (build_boss_from_kmers,
                                            collect_counted_kmers)
        from ..seqio.kmc import read_kmers
        assert len(args.fnames) == 1, "one KMC database per build"
        chars, counts, hdr = read_kmers(args.fnames[0],
                                        min_count=args.min_count,
                                        max_count=args.max_count)
        log(f"KMC database: {len(chars)} k-mers, k={hdr.kmer_length}")
        assert args.k == hdr.kmer_length, \
            f"-k {args.k} != KMC k {hdr.kmer_length}"
        canonical = mode in ("canonical", "primary")
        t0 = time.time()
        if args.suffix:
            # one suffix bucket -> chunk file, from a KMC database
            # (test_build.py:270-330 workflow); the '$' bucket is empty
            # (dummies are generated at concatenate's finish)
            from ..common import packed as pk
            from ..kmer import packing as _kp
            from ..parallel.sharded_build import save_chunk
            import jax.numpy as jnp
            B = DNA.bits_per_char
            sfx = tuple(DNA.letters.index(ch) for ch in args.suffix)
            if 0 in sfx:
                L = _kp.lanes_for(args.k, B)
                comp = np.zeros((L, 0), np.uint32)
                ccomp = np.zeros((0,), np.int32)
            else:
                lanes, cnts, n = collect_counted_kmers(
                    chars, counts, args.k, canonical=canonical)
                s = len(sfx)
                keep = pk.valid_mask(lanes.shape[1], jnp.int32(n))
                # node suffix char e_{K-s+i} lives in field K-s+i
                for i, c in enumerate(sfx):
                    keep = keep & (pk.get_field(lanes, args.k - s + i, B)
                                   == np.uint32(c))
                comp_d, nc, (cc,) = pk.compact(lanes, keep,
                                               lanes.shape[1], cnts)
                nc = int(nc)
                comp = np.asarray(comp_d)[:, :nc]
                ccomp = np.asarray(cc)[:nc]
            name = args.suffix.replace("$", "S")
            out = f"{args.outfile_base}.{name}.chunk.npz"
            save_chunk(out, comp, ccomp, args.k, DNA.name, sfx)
            log(f"Serialized chunk to {out}")
            return
        lanes, cnts, n = collect_counted_kmers(chars, counts, args.k,
                                               canonical=canonical)
        boss = build_boss_from_kmers(
            lanes, cnts, n, args.k,
            mode="canonical" if canonical else "basic",
            bits_per_count=bits_per_count)
        log(f"Graph construction: {time.time() - t0:.2f} s")
        graph = DbgSuccinct.from_boss(boss, DNA, mode)
        out = graph_io.save_graph(args.outfile_base, graph,
                                  state=getattr(args, "state", "fast"))
        log(f"Serialized to {out}")
        return

    from ..seqio.fasta import kmer_counts_sidecar
    if (args.count_kmers
            and all(kmer_counts_sidecar(f) for f in args.fnames)
            and not any(f.endswith((".vcf", ".vcf.gz"))
                        for f in args.fnames)):
        # contigs with a per-k-mer count sidecar (the reference's
        # ExtendedFasta path, parse_sequences.hpp:107-135): constant-count
        # segments contribute their count, duplicates are summed
        from ..graph.boss_construct import build_boss_from_kmers
        from ..seqio.fasta import iter_weighted_records
        _build_weighted_from_sidecars(args, DNA, bits_per_count, mode)
        return

    if args.suffix:
        # one suffix bucket -> chunk file (reference build --suffix,
        # build.cpp:103-155); concatenate merges the chunks
        from ..parallel.sharded_build import build_shard_kmers, save_chunk
        from ..seqio.fasta import parse_records
        seqs = []
        for f in args.fnames:
            seqs.extend(r.seq for r in parse_records(f))
        from ..kmer import packing as _kp
        sfx = tuple(DNA.letters.index(ch) for ch in args.suffix)
        if 0 in sfx:     # '$' bucket: dummies are generated at finish
            L = _kp.lanes_for(args.k, DNA.bits_per_char)
            lanes = np.zeros((L, 0), np.uint32)
            counts = np.zeros((0,), np.int32)
        else:
            lanes, counts, n = build_shard_kmers(
                seqs, args.k, sfx, DNA,
                canonical=mode in ("canonical", "primary"))
        name = args.suffix.replace("$", "S")
        out = f"{args.outfile_base}.{name}.chunk.npz"
        save_chunk(out, lanes, counts, args.k, DNA.name, sfx)
        log(f"Serialized chunk to {out}")
        return

    if args.parts_total > 1:
        # manual sharding across processes/hosts (reference --part-idx/
        # --parts-total, config.cpp): part p builds the chunk files of
        # suffix buckets p, p+P, p+2P, ...; `concatenate` merges them
        from ..parallel.sharded_build import (build_shard_kmers,
                                              save_chunk, suffix_buckets)
        from ..seqio.fasta import parse_records
        assert args.suffix_len > 0, "--parts-total needs --suffix-len"
        seqs = []
        for f in args.fnames:
            seqs.extend(r.seq for r in parse_records(f))
        buckets = suffix_buckets(DNA, args.suffix_len)
        for sfx in buckets[args.part_idx::args.parts_total]:
            lanes, counts, n = build_shard_kmers(
                seqs, args.k, sfx, DNA,
                canonical=mode in ("canonical", "primary"))
            name = "".join(DNA.letters[c] for c in sfx).replace("$", "S")
            out = f"{args.outfile_base}.{name}.chunk.npz"
            save_chunk(out, lanes, counts, args.k, DNA.name, sfx)
            log(f"Serialized chunk to {out}")
        return

    seqs = []
    codes_direct = None
    streamed = False
    if (len(args.fnames) == 1
            and not args.fnames[0].endswith((".vcf", ".vcf.gz"))
            and not args.disk_swap and args.suffix_len == 0
            and args.num_shards == 1
            and not args.fwd_and_reverse):
        # fast path: native one-pass parse+encode straight to code array
        from ..seqio.fasta import read_and_encode
        codes_direct = read_and_encode(args.fnames[0], DNA)
        log(f"Encoded {len(codes_direct) / 1e6:.1f} M chars (native codec)")
    elif ((args.disk_swap or (args.num_shards > 1 and args.mode == "basic"))
            and not any(f.endswith((".vcf", ".vcf.gz"))
                        for f in args.fnames)
            and not args.fwd_and_reverse and args.suffix_len == 0):
        # out-of-core / disk-swap ingest: STREAM records through a
        # parse-ahead thread so host parsing overlaps device collection
        # (reference kmer_collector.cpp:170-200 overlaps the same way);
        # these builders consume the sequence iterable exactly once
        from ..seqio.fasta import BatchFeeder, parse_records

        def _gen():
            # hand the feeder BATCHES: per-item queue overhead is ~6 us,
            # which at short-read scale would cost ~20 s/GB
            batch = []
            for f in args.fnames:
                for r in parse_records(f):
                    batch.append(r.seq)
                    if len(batch) >= 1024:
                        yield batch
                        batch = []
            if batch:
                yield batch

        seqs = (s for chunk in BatchFeeder(_gen(), depth=8)
                for s in chunk)
        streamed = True
    else:
        for f in args.fnames:
            if f.endswith((".vcf", ".vcf.gz")):
                from ..seqio.vcf import vcf_to_sequences
                assert args.reference, "--reference required for VCF input"
                seqs.extend(vcf_to_sequences(f, args.reference, args.k))
            else:
                from ..seqio.fasta import parse_records
                seqs.extend(r.seq for r in parse_records(f))
        if args.fwd_and_reverse:
            # --fwd-and-reverse: also count each sequence's reverse
            # complement (parse_sequences with_reverse)
            comp = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")
            seqs.extend(s.translate(comp)[::-1] for s in list(seqs))
        log(f"Read {len(seqs)} sequences "
            f"({sum(map(len, seqs)) / 1e6:.1f} Mbp)")
    from ..common import telemetry
    t0 = time.time()
    valid_mask = None
    if args.disk_swap:
        # bounded-HBM streaming collection; a real directory engages the
        # on-disk chunk tier (SortedSetDisk role)
        from ..parallel.streaming import build_boss_streaming
        swap_dir = args.disk_swap if os.path.isdir(args.disk_swap) else None
        # --mem-cap-gb bounds the in-HBM collection chunk (reference
        # quick_start.rst:91 pairs it with --disk-swap)
        chunk = min(max(int(args.mem_cap_gb * (1 << 30) / 16), 1 << 20),
                    1 << 26)
        boss = build_boss_streaming(seqs, args.k, alphabet=DNA, mode=mode,
                                    bits_per_count=bits_per_count,
                                    chunk_codes=chunk,
                                    disk_dir=swap_dir)
    elif args.num_shards > 1 and mode == "basic":
        # out-of-core sharded finish: device working set shrinks by
        # ~num_shards; the preferred scale path on one chip
        from ..parallel.outofcore import build_boss_out_of_core
        with telemetry.span("construct_ooc",
                            items=0 if streamed
                            else sum(map(len, seqs)), unit="chars"):
            boss, valid_mask = build_boss_out_of_core(
                seqs, args.k, alphabet=DNA, n_shards=args.num_shards,
                bits_per_count=bits_per_count,
                keep_kmer_index=getattr(args, "state", "fast") != "small",
                verbose=args.verbose, return_valid=True)
    elif args.suffix_len > 0 or args.num_shards > 1:
        boss = build_boss_sharded(
            seqs, args.k, alphabet=DNA, mode=mode,
            bits_per_count=bits_per_count,
            suffix_len=max(args.suffix_len, 1))
    elif codes_direct is not None:
        from ..graph.boss_construct import build_boss_from_codes
        with telemetry.span("construct", items=len(codes_direct),
                            unit="chars"):
            boss = build_boss_from_codes(codes_direct, args.k,
                                         alphabet=DNA, mode=mode,
                                         bits_per_count=bits_per_count)
    else:
        with telemetry.span("construct",
                            items=sum(map(len, seqs)), unit="chars"):
            boss = build_boss(seqs, args.k, alphabet=DNA, mode=mode,
                              bits_per_count=bits_per_count)
    log(f"Graph construction: {time.time() - t0:.2f} s")
    with telemetry.span("serialize"):
        graph = DbgSuccinct.from_boss(boss, DNA, mode, valid=valid_mask)
        out = graph_io.save_graph(args.outfile_base, graph,
                                  state=getattr(args, "state", "fast"))
    log(f"Serialized to {out}")


def _build_weighted_from_sidecars(args, DNA, bits_per_count, mode):
    """Build from contigs + per-k-mer count sidecars: each k-mer of a
    constant-count segment contributes that count; duplicates summed
    (reference parse_sequences.hpp:107-135 + call_weighted_sequence)."""
    from ..graph.boss_construct import (build_boss_from_kmers,
                                        collect_counted_kmers)
    from ..graph.dbg_succinct import DbgSuccinct
    from ..graph import io as graph_io
    from ..seqio.fasta import iter_weighted_records
    k = args.k
    tbl = DNA.encode_table()
    chars_parts, count_parts = [], []
    for f in args.fnames:
        for rec, counts in iter_weighted_records(f):
            seq = rec.seq
            if len(seq) < k:
                continue
            codes = tbl[np.frombuffer(seq, np.uint8)]
            win = np.lib.stride_tricks.sliding_window_view(codes, k)
            valid = (win != 255).all(axis=1)
            chars_parts.append(win[valid])
            count_parts.append(counts[valid])
    if not chars_parts:
        chars = np.zeros((0, k), np.uint8)
        counts = np.zeros((0,), np.uint32)
    else:
        chars = np.concatenate(chars_parts)
        counts = np.concatenate(count_parts)
    log(f"Weighted input: {len(chars)} k-mers from count sidecars")
    canonical = mode in ("canonical", "primary")
    t0 = time.time()
    lanes, cnts, n = collect_counted_kmers(chars, counts, k, DNA,
                                           canonical=canonical)
    boss = build_boss_from_kmers(
        lanes, cnts, n, k, DNA,
        mode="canonical" if canonical else "basic",
        bits_per_count=bits_per_count)
    log(f"Graph construction: {time.time() - t0:.2f} s")
    graph = DbgSuccinct.from_boss(boss, DNA, mode)
    out = graph_io.save_graph(args.outfile_base, graph,
                              state=getattr(args, "state", "fast"))
    log(f"Serialized to {out}")


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

def cmd_stats(args):
    from ..kmer import packing
    for f in args.fnames:
        if _is_annotation_file(f):
            _print_annotation_stats(f, args.print_col_names)
            continue
        g = _load_graph(f, wrap_primary=False)
        log(f"Statistics for graph '{f}'")
        print("====================== GRAPH STATS =====================")
        print(f"k: {g.k}")
        print(f"nodes (k): {g.num_nodes()}")
        print(f"mode: {g.mode}")
        if g.boss.weights is not None:
            w = np.asarray(g.boss.weights)
            nnz = int((w != 0).sum())
            print(f"nnz weights: {nnz}")
            # %.6g: match C++ std::cout default double formatting
            print(f"avg weight: {w.sum() / max(nnz, 1):.6g}")
        from ..graph.io import index_bytes
        nbytes = index_bytes(g)
        print(f"index bytes: {nbytes}")
        print(f"bytes/edge: {nbytes / max(g.boss.num_edges, 1):.3g}")
        print("========================================================")
        boss = g.boss
        print("====================== BOSS STATS ======================")
        print(f"k: {boss.k + 1}")
        print(f"nodes (k-1): {int(boss.num_nodes())}")
        print(f"edges ( k ): {boss.num_edges}")
        print(f"state: {'fast' if boss.edge_lanes is not None else 'small'}")
        counts = np.asarray(boss.char_counts_W())
        letters = g.alphabet.letters
        pairs = ", ".join(f"'{letters[i]}': {int(counts[i])}"
                          for i in range(boss.alph_size))
        print("W stats: {" + pairs + "}")
        if getattr(args, "print_internal", False):
            # reference BOSS::print_internal_representation (boss.cpp)
            W = np.asarray(boss.W)
            last = np.asarray(boss.last)
            print("F:", " ".join(str(int(x)) for x in np.asarray(boss.F)))
            for i in range(1, boss.num_edges + 1):
                print(f"{i}\t{int(last[i])}\t{int(W[i])}")
        if getattr(args, "print_graph", False):
            # reference BOSS::print: one row per edge with the decoded
            # source-node string, W char (minus-flagged lower-case) and
            # the last bit (boss.cpp print)
            import jax.numpy as jnp
            W = np.asarray(boss.W)
            last = np.asarray(boss.last)
            rows = np.arange(1, boss.num_edges + 1)
            chars = np.asarray(boss.node_chars_ranksel(jnp.asarray(rows))) \
                if boss.edge_lanes is None else None
            print("index\tnode\tW\tlast")
            for i in range(1, boss.num_edges + 1):
                if chars is not None:
                    node_str = "".join(
                        "$" if c == 0 else letters[c]
                        for c in chars[i - 1][:-1])
                else:
                    from ..kmer.packing import unpack_to_chars
                    lane = boss.edge_lanes[:, i - 1:i]
                    cs = np.asarray(unpack_to_chars(
                        lane, boss.k + 1, boss.bits_per_char))[0]
                    node_str = "".join("$" if c == 0 else letters[c]
                                       for c in cs[:-1])
                w = int(W[i])
                wc = ("$" if w == 0 else
                      letters[w % boss.alph_size].lower() if w >= boss.alph_size
                      else letters[w])
                print(f"{i}\t{node_str}\t{wc}\t{int(last[i])}")
        F = np.asarray(boss.F)
        fparts = []
        for i in range(1, boss.alph_size):
            fparts.append(f"'{letters[i - 1]}': {int(F[i] - F[i - 1])}")
        fparts.append(f"'{letters[-1]}': {boss.num_edges - int(F[-1])}")
        print("F stats: {" + ", ".join(fparts) + "}")
        if args.count_dummy and boss.edge_lanes is not None:
            nsrc, nsink = boss.num_dummy_edges()
            print(f"dummy source edges: {int(nsrc)}")
            print(f"dummy sink edges: {int(nsink)}")
            print(f"real edges: {boss.num_edges - int(nsrc) - int(nsink)}")
        # the always-on top-16-bit search LUT plays the role of the
        # reference's index_suffix_ranges (boss.cpp:index_suffix_ranges);
        # report the equivalent indexed char count honestly
        suf_chars = (16 // boss.bits_per_char) if boss.lut is not None else 0
        print(f"indexed suffix length: {suf_chars}")
        if args.validate:
            errs = _validate_graph(g)
            print(f"validation: {'OK' if not errs else 'FAILED'}")
            for e in errs:
                print(f"  invariant violated: {e}")
            if errs:
                sys.exit(1)
        print("========================================================")


def _validate_graph(g) -> list:
    """BOSS structural invariant checks (stats --validate): the runtime
    integrity-verification role of the reference's sanitizer/assert
    builds (SURVEY §5), batched. Returns a list of violations."""
    import jax.numpy as jnp
    errs = []
    boss = g.boss
    m = boss.num_edges
    F = np.asarray(boss.F)
    if not (np.diff(F) >= 0).all() or F[0] != 0:
        errs.append(f"F not nondecreasing from 0: {F.tolist()}")
    W = np.asarray(boss.W[1:m + 1])
    if W.size and (W < 0).any() or (W >= 2 * boss.alph_size).any():
        errs.append("W values outside [0, 2*sigma)")
    n_nodes = int(boss.num_nodes())
    last = np.asarray(boss.last)
    if int(last[1:m + 1].sum()) != n_nodes:
        errs.append(f"last popcount {int(last[1:m+1].sum())} != "
                    f"num_nodes {n_nodes}")
    # navigation closure on sampled edges: fwd then bwd returns to the
    # source node's edge range (boss.hpp fwd/bwd contract)
    rng = np.random.default_rng(0)
    sample = np.unique(rng.integers(1, m + 1, min(1024, m)))
    Ws = np.asarray(boss.W[sample])
    real = (Ws % boss.alph_size) != 0
    s = jnp.asarray(sample[real].astype(np.int32))
    if int(s.shape[0]):
        c = jnp.asarray((Ws[real] % boss.alph_size).astype(np.int32))
        tgt = boss.fwd(s, c)
        back = boss.bwd(tgt)
        # bwd returns the FIRST incoming edge; it must share the source
        # node's label c at some edge of that node — weaker but batched:
        # the returned edge's target node must equal fwd's source row
        ok = np.asarray(boss.get_node_last_value(tgt) ==
                        np.asarray(c))
        if not ok.all():
            errs.append(f"fwd label mismatch on {int((~ok).sum())} of "
                        f"{len(ok)} sampled edges")
        if (np.asarray(back) < 1).any() or (np.asarray(back) > m).any():
            errs.append("bwd out of range on sampled edges")
    # every kept edge k-mer maps back to its own row (full check)
    if boss.edge_lanes is not None:
        rows = np.asarray(boss.map_to_edges(boss.edge_lanes))
        want = np.arange(1, boss.edge_lanes.shape[1] + 1)
        if not (rows == want).all():
            errs.append(f"map_to_edges not identity on "
                        f"{int((rows != want).sum())} rows")
    return errs


def _is_annotation_file(path) -> bool:
    if path.endswith(".annodbg.npz"):
        return True
    try:
        with np.load(path if path.endswith(".npz") else path + ".dbg.npz",
                     allow_pickle=False) as d:
            return "labels" in d
    except Exception:
        return False


def _print_annotation_stats(f, print_col_names: bool = False):
    from ..anno.annotator import Annotation
    ann = Annotation.load(f)
    log(f"Statistics for annotation '{f}'")
    print("=================== ANNOTATION STATS ===================")
    print(f"labels:  {ann.num_labels}")
    if print_col_names:
        # stats --print-col-names (stats.cpp print_annotation_stats)
        for l in ann.encoder.labels:
            print(f"<{l}>")
    print(f"objects: {ann.matrix.num_rows}")
    density = ann.matrix.nnz / max(ann.matrix.num_rows, 1) \
        / max(ann.num_labels, 1)
    print(f"density: {density:.6g}")
    rep = {"rowsparse": "column", "brwt": "brwt",
           "rowdiff": "row_diff"}.get(ann.representation,
                                      ann.representation)
    print(f"representation: {rep}")
    if rep == "brwt":
        print("=================== Multi-BRWT STATS ===================")
        print(f"num nodes: {ann.matrix.num_nodes()}")
        print(f"avg arity: {ann.matrix.avg_arity()}")
    print("========================================================")


# ---------------------------------------------------------------------------
# annotate
# ---------------------------------------------------------------------------

def cmd_annotate(args):
    from ..engine.annotated_dbg import annotate_sequences
    from ..anno.annotator import ColumnAnnotator

    g = _load_graph(args.infile_base)
    items = []
    for f in args.fnames:
        from ..seqio.fasta import parse_records
        for rec in parse_records(f):
            labels: List[str] = []
            if args.anno_filename:
                labels.append(f)
            if args.anno_header:
                # --header-delimiter splits the header into several
                # labels (annotate.cpp:100-112)
                name = rec.name.decode()
                if args.header_comment_delim and rec.comment:
                    name = (name + args.header_comment_delim
                            + rec.comment.decode())
                if args.header_delimiter:
                    labels.extend(
                        x for x in name.split(args.header_delimiter) if x)
                else:
                    labels.append(name)
            labels.extend(args.anno_label or [])
            items.append((rec.seq, labels))
    if args.coordinates:
        from ..anno.coords import annotate_coordinates
        ann = annotate_coordinates(g, items).finalize()
    else:
        num_rows = g.num_nodes()
        if hasattr(g, "node_to_anno_row"):
            num_rows = g.base.num_nodes()
        annotator = ColumnAnnotator(num_rows=num_rows)
        annotate_sequences(g, items, annotator,
                           with_counts=args.count_kmers)
        ann = annotator.finalize()
    out = args.outfile_base or args.infile_base
    if not out.endswith(".annodbg.npz"):
        out = out + (".coord.annodbg.npz" if args.coordinates
                     else ".column.annodbg.npz")
    ann.save(out)
    log(f"Serialized annotation to {out} "
        f"({ann.num_labels} labels, {ann.matrix.nnz} relations)")


# ---------------------------------------------------------------------------
# query
# ---------------------------------------------------------------------------

def format_query_result(idx: int, name: str, adbg, seq: bytes, args) -> str:
    """One output line per sequence (reference query.cpp:54-155,927)."""
    seq_name = f"{idx}\t{name}"
    if args.print_signature:
        tops = adbg.get_top_label_signatures(
            seq, args.num_top_labels, args.discovery_fraction)
        if not tops and args.suppress_unlabeled:
            return ""
        parts = [seq_name]
        for label, mask in tops:
            bits = "".join("1" if b else "0" for b in mask)
            parts.append(f"<{label}>:{int(mask.sum())}:{bits}:"
                         f"{adbg.score_kmer_presence_mask(mask)}")
        return "\t".join(parts) + "\n"
    elif args.query_coords:
        result = adbg.get_kmer_coordinates(seq, args.num_top_labels,
                                           args.discovery_fraction)
        if not result and args.suppress_unlabeled:
            return ""
        parts = [seq_name]
        for label, tuples in result:
            item = f"<{label}>"
            for coords in tuples:
                item += ":" + ",".join(str(c) for c in coords)
            parts.append(item)
        return "\t".join(parts) + "\n"
    elif args.count_quantiles:
        qs = [float(x) for x in args.count_quantiles.split()]
        result = adbg.get_label_count_quantiles(
            seq, args.num_top_labels, args.discovery_fraction, qs)
        if not result and args.suppress_unlabeled:
            return ""
        parts = [seq_name]
        for label, quants in result:
            parts.append(f"<{label}>:" + ":".join(str(q) for q in quants))
        return "\t".join(parts) + "\n"
    elif args.count_labels or args.query_counts:
        tops = adbg.get_top_labels(seq, args.num_top_labels,
                                   args.discovery_fraction,
                                   with_kmer_counts=args.query_counts)
        if not tops and args.suppress_unlabeled:
            return ""
        parts = [seq_name]
        for label, count in tops:
            parts.append(f"<{label}>:{count}")
        return "\t".join(parts) + "\n"
    else:
        labels = adbg.get_labels(seq, args.discovery_fraction)
        if not labels and args.suppress_unlabeled:
            return ""
        return seq_name + "\t" + args.anno_labels_delimiter.join(labels) + "\n"


def cmd_query(args):
    from ..anno.annotator import Annotation
    from ..engine.annotated_dbg import AnnotatedDbg
    from ..seqio.fasta import parse_records

    from ..engine.annotated_dbg import BatchQuery
    from ..seqio.fasta import iter_batches

    if args.address:
        # client mode (reference query --address): send the reads to a
        # running server_query instance instead of loading an index
        from ..server.client import GraphClient
        unsupported = [f for f, v in [
            ("--count-labels", args.count_labels),
            ("--count-kmers/--query-counts", args.query_counts),
            ("--print-signature", args.print_signature),
            ("--query-coords", args.query_coords),
            ("--count-quantiles", args.count_quantiles),
            ("--fwd-and-reverse", args.fwd_and_reverse)] if v]
        if unsupported:
            raise SystemExit("not supported with --address: "
                             + " ".join(unsupported))
        host, _, port = args.address.rpartition(":")
        client = GraphClient(host or "127.0.0.1", int(port))
        out = sys.stdout
        idx = 0
        for batch in iter_batches(args.fnames,
                                  batch_bytes=args.batch_size):
            raw, _ = client._json.search(
                [r.seq.decode() for r in batch],
                top_labels=min(args.num_top_labels, 2 ** 31 - 1),
                discovery_threshold=args.discovery_fraction,
                align=args.align or args.batch_align)
            by_desc = {}
            for entry in raw:
                labels = [r["sample"] for r in entry.get("results", [])]
                by_desc.setdefault(entry["seq_description"], labels)
            for i, rec in enumerate(batch):
                labels = by_desc.get(f"{i}", []) \
                    or by_desc.get(rec.name.decode(), [])
                if not labels and args.suppress_unlabeled:
                    idx += 1
                    continue
                out.write(f"{idx}\t{rec.name.decode()}\t"
                          + args.anno_labels_delimiter.join(labels) + "\n")
                idx += 1
        return

    assert args.infile_base and args.annotation, \
        "query needs -i and -a (or --address for client mode)"
    g = _load_graph(args.infile_base)
    ann = Annotation.load(args.annotation)
    adbg = AnnotatedDbg(graph=g, annotation=ann)
    t0 = time.time()
    n = 0
    out = sys.stdout
    simple = not (args.print_signature or args.query_coords
                  or args.query_counts or args.count_quantiles)
    aligner = None
    if args.align or args.batch_align:
        from ..align.aligner import Aligner, AlignerConfig
        aligner = Aligner(g, AlignerConfig(
            min_exact_match=args.align_min_exact_match))
    bq = BatchQuery(adbg)
    idx = 0
    from ..seqio.fasta import BatchFeeder
    # prefetch: host parsing of the next batch overlaps device compute
    # (the reference's ThreadPool/BatchAccumulator pipeline role)
    for batch in BatchFeeder(iter_batches(args.fnames,
                                          batch_bytes=args.batch_size)):
        if args.fwd_and_reverse:
            # FastaParser with_reverse: every record is queried forward
            # and as its reverse complement (own output line each)
            from ..seqio.fasta import SeqRecord
            comp = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")
            expanded = []
            for rec in batch:
                expanded.append(rec)
                expanded.append(SeqRecord(
                    name=rec.name, seq=rec.seq.translate(comp)[::-1]))
            batch = expanded
        if aligner is not None:
            # reference query --align / --batch-align: replace each read
            # with its best aligned path spelling before querying
            # (query.cpp:993-999; the --batch-align hull's role is
            # subsumed by the batched full-graph aligner, query.cpp:735)
            # score-only alignment: query consumes just the best path
            # spelling, so skip CIGAR recovery
            all_res = aligner.align_batch([rec.seq for rec in batch],
                                          with_cigar=False)
            for rec, res in zip(batch, all_res):
                if res:
                    rec.seq = res[0].sequence
        if simple and args.count_labels:
            results = bq.get_top_labels_batch(
                [r.seq for r in batch], args.num_top_labels,
                args.discovery_fraction)
            for rec, tops in zip(batch, results):
                if not tops and args.suppress_unlabeled:
                    idx += 1
                    continue
                parts = [f"{idx}\t{rec.name.decode()}"]
                parts += [f"<{l}>:{c}" for l, c in tops]
                out.write("\t".join(parts) + "\n")
                idx += 1
                n += 1
        elif simple:
            results = bq.get_labels_batch([r.seq for r in batch],
                                          args.discovery_fraction)
            for rec, labels in zip(batch, results):
                if not labels and args.suppress_unlabeled:
                    idx += 1
                    continue
                out.write(f"{idx}\t{rec.name.decode()}\t"
                          + args.anno_labels_delimiter.join(labels) + "\n")
                idx += 1
                n += 1
        else:
            # non-simple modes run through the SAME batched executor:
            # one device fetch per batch, host-only
            # per-read formatting
            seqs_b = [r.seq for r in batch]
            if args.print_signature:
                results = bq.get_top_label_signatures_batch(
                    seqs_b, args.num_top_labels, args.discovery_fraction)
                for rec, tops in zip(batch, results):
                    if not tops and args.suppress_unlabeled:
                        idx += 1
                        continue
                    parts = [f"{idx}\t{rec.name.decode()}"]
                    for label, mask in tops:
                        bits = "".join("1" if b else "0" for b in mask)
                        parts.append(
                            f"<{label}>:{int(mask.sum())}:{bits}:"
                            f"{adbg.score_kmer_presence_mask(mask)}")
                    out.write("\t".join(parts) + "\n")
                    idx += 1
                    n += 1
            elif args.query_coords:
                results = bq.get_kmer_coordinates_batch(
                    seqs_b, args.num_top_labels, args.discovery_fraction)
                for rec, res in zip(batch, results):
                    if not res and args.suppress_unlabeled:
                        idx += 1
                        continue
                    parts = [f"{idx}\t{rec.name.decode()}"]
                    for label, tuples in res:
                        item = f"<{label}>"
                        for coords in tuples:
                            item += ":" + ",".join(str(c) for c in coords)
                        parts.append(item)
                    out.write("\t".join(parts) + "\n")
                    idx += 1
                    n += 1
            elif args.count_quantiles:
                qs = [float(x) for x in args.count_quantiles.split()]
                results = bq.get_label_count_quantiles_batch(
                    seqs_b, args.num_top_labels, args.discovery_fraction,
                    qs)
                for rec, res in zip(batch, results):
                    if not res and args.suppress_unlabeled:
                        idx += 1
                        continue
                    parts = [f"{idx}\t{rec.name.decode()}"]
                    for label, quants in res:
                        parts.append(f"<{label}>:"
                                     + ":".join(str(q) for q in quants))
                    out.write("\t".join(parts) + "\n")
                    idx += 1
                    n += 1
            else:   # --query-counts (with or without --count-labels)
                results = bq.get_top_labels_batch(
                    seqs_b, args.num_top_labels, args.discovery_fraction,
                    with_kmer_counts=True)
                for rec, tops in zip(batch, results):
                    if not tops and args.suppress_unlabeled:
                        idx += 1
                        continue
                    parts = [f"{idx}\t{rec.name.decode()}"]
                    parts += [f"<{l}>:{c}" for l, c in tops]
                    out.write("\t".join(parts) + "\n")
                    idx += 1
                    n += 1
    log(f"Queried {n} sequences in {time.time() - t0:.2f} s "
        f"({n / max(time.time() - t0, 1e-9):.0f} reads/s)")


# ---------------------------------------------------------------------------
# assemble / clean
# ---------------------------------------------------------------------------

def cmd_assemble(args):
    from ..graph.traversal import contig_sequences, unitig_sequences
    from ..seqio.fasta import FastaWriter

    g = _load_graph(args.infile_base or args.fnames[0])
    if args.label_mask_in or args.label_mask_out:
        from ..anno.annotator import Annotation
        from ..engine.annotated_dbg import AnnotatedDbg
        from ..engine.diff_assembly import differential_assembly
        ann = Annotation.load(args.annotation)
        adbg = AnnotatedDbg(graph=g, annotation=ann)
        g = differential_assembly(
            adbg, args.label_mask_in or [], args.label_mask_out or [],
            unitig_mode=args.unitigs,
            label_mask_in_fraction=args.label_mask_in_fraction,
            label_mask_out_fraction=args.label_mask_out_fraction,
            label_other_fraction=args.label_other_fraction)
    if args.to_gfa:
        if not args.unitigs:
            log("Flag '--unitigs' must be set for GFA output")
            sys.exit(1)
        _write_gfa(g, args.outfile_base + ".gfa", compacted=args.compacted)
        log(f"Wrote GFA to {args.outfile_base}.gfa")
    seqs = (unitig_sequences(g, min_length=args.min_length) if args.unitigs
            else contig_sequences(g))
    with FastaWriter(args.outfile_base + ".fasta.gz", header="",
                     enumerate_sequences=True) as w:
        for s in seqs:
            w.write(s)
    log(f"Assembled {len(seqs)} sequences -> {args.outfile_base}.fasta.gz")


def cmd_clean(args):
    """Extract cleaned contigs/unitigs (+ count sidecar) from a graph
    (reference cli/clean.cpp:28-200): node min/max-count mask, then
    unitig-level tip pruning and median-abundance filtering; canonical
    graphs are emitted in single (primary) form so a canonical rebuild
    reproduces the node set and counts exactly."""
    from ..graph.cleaning import (clean_node_mask, estimate_min_kmer_abundance,
                                  node_weights)
    from ..graph.masked import MaskedDbg
    from ..graph.traversal import (contig_sequences, single_form_mask,
                                   unitig_sequences)
    from ..seqio.fasta import ExtendedFastaWriter, FastaWriter

    infile = args.infile_base or args.fnames[0]
    g = _load_graph(infile, wrap_primary=False)
    has_weights = g.boss.weights is not None
    node_w = node_weights(g) if has_weights else None
    if args.min_count_q > 0 or args.max_count_q < 1:
        # quantile-derived count thresholds (config.cpp --min-count-q/
        # --max-count-q): quantiles over the nonzero node counts
        assert has_weights, "--min/max-count-q need k-mer counts"
        w = np.sort(node_w[node_w > 0])
        def q_at(q):
            return int(w[min(int(np.ceil(q * len(w))), len(w) - 1)])
        if args.min_count_q > 0:
            args.min_count = max(args.min_count, q_at(args.min_count_q))
        if args.max_count_q < 1:
            mc = q_at(args.max_count_q)
            args.max_count = mc if args.max_count is None \
                else min(args.max_count, mc)
        log(f"count thresholds from quantiles: min {args.min_count} "
            f"max {args.max_count}")
    prune_unitigs = args.prune_unitigs
    if prune_unitigs == 0 or args.min_count_auto:
        # --prune-unitigs 0: automatic threshold (clean.cpp:76-100)
        est = estimate_min_kmer_abundance(g, args.num_singletons)
        if est < 0:
            if args.fallback < 0:
                log("Cannot estimate expected minimum k-mer abundance "
                    "and fallback is disabled (--fallback -1). Terminating.")
                sys.exit(129)
            log("Cannot estimate expected minimum k-mer abundance. "
                f"Using fallback value: {args.fallback}")
            prune_unitigs = args.fallback
        else:
            prune_unitigs = est
            log(f"Threshold for median k-mer abundance in unitigs: {est}")

    unitig_mode = (args.unitigs or args.prune_tips > 1 or prune_unitigs > 1
                   or args.smoothing_window > 1)
    mask = clean_node_mask(g, min_count=args.min_count,
                           max_count=args.max_count,
                           prune_unitigs=prune_unitigs,
                           min_tip_size=args.prune_tips,
                           node_w=node_w) \
        if (args.min_count > 1 or args.max_count is not None
            or prune_unitigs > 1 or args.prune_tips > 1) else None
    single_form = g.mode == "canonical"
    if single_form:
        sf = single_form_mask(g)
        mask = sf if mask is None else (mask & sf)
    sub = MaskedDbg(base=g, mask=mask) if mask is not None else g
    if unitig_mode and not (single_form or mask is not None):
        seqs, paths = unitig_sequences(sub, return_paths=True)
    else:
        # contigs: also used after masking, where unitigs of the masked
        # subgraph are exactly the kept/kept-fragment paths
        seqs, paths = contig_sequences(sub, return_paths=True)
    out = args.outfile_base
    for suf in (".gz", ".fasta"):
        if out.endswith(suf):
            out = out[:-len(suf)]
    csq = [float(x) for x in args.count_slice_quantiles.split()]
    if csq != [0.0, 1.0]:
        # abundance-binned output (clean.cpp:196-291): per quantile pair,
        # count thresholds from the CLEANED nodes' weighted histogram,
        # one fasta per slice named <out>.<qa>.<qb>.fasta.gz
        assert has_weights, "--count-slice-quantiles needs k-mer counts"
        assert all(a < b for a, b in zip(csq, csq[1:])), \
            "quantiles must increase"
        kept_nodes = np.concatenate(paths) if paths else \
            np.zeros(0, np.int64)
        counts_kept = np.sort(node_w[kept_nodes])
        def quantile(q):
            # reference utils::get_quantile over the count histogram:
            # smallest count with cumulative share >= q
            if not len(counts_kept):
                return 1
            idx = min(int(np.ceil(q * len(counts_kept))),
                      len(counts_kept) - 1)
            return int(counts_kept[idx])
        for qa, qb in zip(csq, csq[1:]):
            min_c = quantile(qa) if qa > 0 else 1
            max_c = quantile(qb) if qb < 1 else (1 << 62)
            log(f"k-mer count thresholds: min (including): {min_c} "
                f"max (excluding): {max_c}")
            m2 = np.zeros(g.num_nodes() + 1, bool)
            m2[kept_nodes] = (node_w[kept_nodes] >= min_c) \
                & (node_w[kept_nodes] < max_c)
            slice_g = MaskedDbg(base=g, mask=m2)
            sseqs = contig_sequences(slice_g)
            fb = f"{out}.{qa:g}.{qb:g}"
            with FastaWriter(fb + ".fasta.gz",
                             header=getattr(args, "header", "")) as w:
                for s in sseqs:
                    w.write(s)
            log(f"Slice [{qa:g}, {qb:g}): {len(sseqs)} sequences "
                f"-> {fb}.fasta.gz")
        return
    if has_weights:
        with ExtendedFastaWriter(out, g.k,
                                 header=getattr(args, "header", "")) as w:
            for s, p in zip(seqs, paths):
                counts = node_w[p]
                if args.smoothing_window > 1:
                    counts = _smooth_counts(counts, args.smoothing_window)
                w.write(s, counts)
    else:
        with FastaWriter(out + ".fasta.gz",
                         header=getattr(args, "header", "")) as w:
            for s in seqs:
                w.write(s)
    kept = (int(mask[1:].sum()) if mask is not None else g.num_nodes())
    log(f"Cleaned graph: kept {kept}/{g.num_nodes()} nodes, "
        f"{len(seqs)} sequences -> {out}.fasta.gz")


def _smooth_counts(counts, window: int):
    """Sliding-window mean smoothing (utils::smooth_vector)."""
    c = np.asarray(counts, np.float64)
    half = window // 2
    cum = np.concatenate([[0], np.cumsum(c)])
    n = len(c)
    lo = np.maximum(np.arange(n) - half, 0)
    hi = np.minimum(np.arange(n) + half + 1, n)
    return ((cum[hi] - cum[lo]) / (hi - lo)).astype(np.uint32)


# ---------------------------------------------------------------------------
# align
# ---------------------------------------------------------------------------

def cmd_align(args):
    from ..align.aligner import Aligner, AlignerConfig
    from ..seqio.fasta import parse_records

    g = _load_graph(args.infile_base)
    if args.outfile_base and args.outfile_base.endswith(".gfa"):
        # GFA path mode (align.cpp gfa_map_files:300-330): map each read
        # onto the assembled GFA segments as P lines
        _align_gfa_paths(g, args)
        return
    cfg = AlignerConfig(
        match_score=args.match_score,
        mm_transition_penalty=args.mm_transition_penalty,
        mm_transversion_penalty=args.mm_transversion_penalty,
        gap_opening_penalty=args.gap_opening_penalty,
        gap_extension_penalty=args.gap_extension_penalty,
        xdrop=args.align_xdrop,
        min_seed_length=args.align_min_seed_length or g.k,
        max_seed_length=args.align_max_seed_length,
        min_exact_match=args.align_min_exact_match,
        max_seeds_per_locus=args.align_max_num_seeds_per_locus,
        min_cell_score=args.align_min_cell_score,
        max_ram_mb=args.align_max_ram,
    )
    if args.align_max_nodes_per_seq_char:
        # the beam width IS the expanded-nodes-per-query-char bound in
        # this engine (reference --align-max-nodes-per-seq-char role)
        cfg.beam_width = max(int(args.align_max_nodes_per_seq_char), 1)
    if args.align_edit_distance:
        # unit scoring matrix (reference set_scoring_matrix,
        # aligner_config.cpp:98-113) + unit gap costs
        cfg.score_matrix_type = "unit"
        cfg.match_score = 1
        cfg.mm_transition_penalty = 1
        cfg.mm_transversion_penalty = 1
        cfg.gap_opening_penalty = 1
        cfg.gap_extension_penalty = 1
    aligner = Aligner(g, cfg)
    out = open(args.outfile_base, "w") if args.outfile_base else sys.stdout
    recs = []
    for f in args.fnames:
        recs.extend(parse_records(f))
    if args.map_only or args.query_presence:
        for rec in recs:
            name = rec.name.decode()
            nodes = np.asarray(g.map_to_nodes(rec.seq))
            n_disc = int((nodes > 0).sum())
            if args.query_presence:
                # 0/1 presence per read (align.cpp:198-208); with
                # --filter-present emit the present reads as FASTA.
                # Reads with no full k-mer window are absent by definition
                n_k = len(nodes)
                min_disc = n_k - int(n_k * (1 - args.discovery_fraction))
                found = n_k > 0 and n_disc >= min_disc
                if args.filter_present:
                    if found:
                        out.write(f">{name}\n{rec.seq.decode()}\n")
                else:
                    out.write(f"{int(found)}\n")
            elif args.count_kmers:
                # name \t discovered/total/unique (align.cpp:212-226)
                n_uniq = len(np.unique(nodes[nodes > 0]))
                out.write(f"{name}\t{n_disc}/{len(nodes)}/{n_uniq}\n")
            else:
                for i, v in enumerate(nodes):
                    out.write(f"{rec.seq[i:i + g.k].decode()}: {int(v)}\n")
        if out is not sys.stdout:
            out.close()
        return
    from ..common import telemetry
    t0 = time.time()
    with telemetry.span("align_batch", items=len(recs), unit="reads"):
        all_results = aligner.align_batch(
            [r.seq for r in recs], both_strands=args.align_both_strands,
            num_alternative_paths=args.num_alternative_paths)
    log(f"Aligned {len(recs)} reads in {time.time() - t0:.2f} s "
        f"({len(recs) / max(time.time() - t0, 1e-9):.0f} reads/s)")
    for rec, results in zip(recs, all_results):
        name = rec.name.decode()
        if args.align_min_path_score:
            results = [r for r in results
                       if r.score >= args.align_min_path_score]
        if args.json:
            for r in results:
                out.write(json.dumps(r.to_json(name)) + "\n")
            continue
        # header \t query [\t +/- \t seq \t score \t matches \t cigar
        # \t offset]... (format_alignment, aligner_alignment.hpp:180)
        row = f"{name}\t{rec.seq.decode()}"
        if not results:
            row += "\t*\t*\t0\t*\t*\t*"
        else:
            for r in results:
                strand = "-" if r.orientation else "+"
                row += (f"\t{strand}\t{r.sequence.decode()}\t{r.score}"
                        f"\t{r.num_matches}\t{r.cigar}\t0")
        out.write(row + "\n")
    if out is not sys.stdout:
        out.close()


def _align_gfa_paths(g, args):
    """Write <base>.path.gfa with one P line per input read
    (align.cpp sequence_to_gfa_path + gfa_map_files)."""
    from ..graph.traversal import unitig_decomposition, unitig_ends
    from ..seqio.fasta import parse_records
    u = unitig_decomposition(g)
    ends = set(int(x) for x in unitig_ends(g, u))
    base = args.outfile_base
    for suf in (".gfa", ".path"):
        if base.endswith(suf):
            base = base[:-len(suf)]
    k = g.k
    with open(base + ".path.gfa", "w") as f:
        seq_id = 0
        for fn in args.fnames:
            for rec in parse_records(fn):
                seq_id += 1
                path = [int(x) for x in np.asarray(g.map_to_nodes(rec.seq))]
                nodes_str, cigars = [], []
                for v in path[:-1]:
                    if args.compacted and v not in ends:
                        continue
                    nodes_str.append(f"{v}+")
                    cigars.append(f"{k - 1}M")
                last = path[-1]
                while args.compacted and last not in ends:
                    succ = np.asarray(g.successors(
                        np.array([last], np.int32)))[0]
                    nxt = succ[succ > 0]
                    if not len(nxt):
                        break
                    last = int(nxt[0])
                nodes_str.append(f"{last}+")
                f.write(f"P\t{seq_id}\t{','.join(nodes_str)}\t"
                        f"{','.join(cigars)}\n")


# ---------------------------------------------------------------------------
# misc graph ops
# ---------------------------------------------------------------------------

def cmd_extend(args):
    """Add sequences to an existing graph (reference cli/augment.cpp).

    The reference mutates a DYN-state BOSS in place; static rebuild from
    the union of k-mer sets is both simpler and faster here (the
    reference itself prefers static construction, build.cpp:99)."""
    import jax.numpy as jnp
    from ..common import packed
    from ..graph.boss_construct import (_sort_unique_stage,
                                        build_boss_from_kmers,
                                        collect_kmers)
    from ..graph.dbg_succinct import DbgSuccinct
    from ..graph import io as graph_io
    from ..kmer import packing as kp

    g = _load_graph(args.infile_base, wrap_primary=False)
    k = g.k
    B = g.alphabet.bits_per_char
    lanes = g.boss.edge_lanes
    real_mask = ~kp.contains_sentinel(lanes, k, B)
    w = (g.boss.weights[1:] if g.boss.weights is not None
         else jnp.ones((lanes.shape[1],), jnp.int32))
    old, n_old, (old_w,) = packed.compact(lanes, real_mask, lanes.shape[1], w)
    records = _read_input_sequences(args.fnames)
    canonical = g.mode in ("canonical", "primary")
    new, new_c, n_new = collect_kmers([r.seq for r in records], k,
                                      g.alphabet, canonical=canonical)
    merged = jnp.concatenate([old[:, :int(n_old)], new[:, :n_new]], axis=1)
    mc = jnp.concatenate([old_w[:int(n_old)], new_c[:n_new]])
    u, uc, n_u = _sort_unique_stage(merged, mc, jnp.int32(merged.shape[1]))
    bits = args.count_width if g.boss.weights is not None else 0
    boss = build_boss_from_kmers(
        u, uc, int(n_u), k, g.alphabet,
        mode="canonical" if g.mode == "canonical" else "basic",
        bits_per_count=bits)
    out = graph_io.save_graph(args.outfile_base or args.infile_base,
                              DbgSuccinct.from_boss(boss, g.alphabet, g.mode))
    log(f"Extended graph -> {out} ({int(n_u)} k-mers)")


def cmd_compare(args):
    g1 = _load_graph(args.fnames[0])
    g2 = _load_graph(args.fnames[1])
    same = (g1.k == g2.k
            and g1.num_nodes() == g2.num_nodes()
            and np.array_equal(np.asarray(g1.boss.W), np.asarray(g2.boss.W))
            and np.array_equal(np.asarray(g1.boss.last),
                               np.asarray(g2.boss.last)))
    print("Graphs are identical" if same else "Graphs are not identical")


def cmd_transform(args):
    from ..graph.traversal import contig_sequences
    g = _load_graph(args.infile_base or args.fnames[0], wrap_primary=False)
    if args.initialize_bloom:
        # batched searchsorted has uniform hit/miss cost (COMPONENTS.md);
        # accept and no-op the Bloom prefilter flags for CLI parity
        log("Bloom filter subsumed by batched membership; nothing to do")
        return
    if args.state:
        # BOSS state switching (transform_graph.cpp): small drops the
        # packed-kmer search accelerator (rank/select-only queries)
        from ..graph import io as graph_io
        if args.state == "fast" and g.boss.edge_lanes is None:
            log("small -> fast state restore is not supported yet; rebuild")
            sys.exit(1)
        out = graph_io.save_graph(args.outfile_base, g, state=args.state)
        log(f"Serialized {args.state}-state graph to {out}")
        return
    if args.to_fasta:
        from ..seqio.fasta import FastaWriter
        if args.primary_kmers:
            # one orientation per rc-pair (kmers_in_single_form): mask to
            # the smaller-packed form, contigs over the masked graph
            from ..graph.masked import MaskedDbg
            from ..graph.traversal import single_form_mask
            g = MaskedDbg(base=g, mask=single_form_mask(g))
        out = args.outfile_base
        if not out.endswith(".fasta.gz"):
            out = out + ".fasta.gz"
        with FastaWriter(out) as w:
            for s in contig_sequences(g):
                w.write(s)
        log(f"Wrote contigs to {out}")
    elif args.to_gfa:
        _write_gfa(g, args.outfile_base + ".gfa",
                   compacted=getattr(args, "compacted", True))
        log(f"Wrote GFA to {args.outfile_base}.gfa")
    elif args.to_adj_list:
        import jax.numpy as jnp
        nodes = np.arange(1, g.num_nodes() + 1, dtype=np.int32)
        succ = np.asarray(g.successors(jnp.asarray(nodes)))
        with open(args.outfile_base + ".adjlist", "w") as fh:
            for i, row in zip(nodes, succ):
                tgts = [str(t) for t in row if t > 0]
                fh.write(f"{i}\t" + " ".join(tgts) + "\n")
        log(f"Wrote adjacency list to {args.outfile_base}.adjlist")


def _write_gfa(g, path, compacted: bool = True):
    """GFA writer matching assemble.cpp:118-155: compacted segments are
    whole unitigs named by their LAST node id, with one L line per
    incoming edge of each unitig's first node; non-compacted emits every
    node as a segment plus intra-unitig links."""
    import jax.numpy as jnp
    from ..graph.traversal import (unitig_decomposition, unitig_ends,
                                   unitig_paths, unitig_sequences)
    u = unitig_decomposition(g)
    seqs, paths = unitig_sequences(g, u, return_paths=True)
    k = g.k
    overlap = k - 1
    starts = np.array([p[0] for p in paths], np.int32) \
        if paths else np.zeros(0, np.int32)
    preds = np.asarray(g.predecessors(jnp.asarray(starts))) \
        if len(starts) else np.zeros((0, 0), np.int32)
    with open(path, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        if compacted:
            for c, (s, p) in enumerate(zip(seqs, paths)):
                fh.write(f"S\t{p[-1]}\t{s.decode()}\n")
                for pr in preds[c]:
                    if pr > 0:
                        fh.write(f"L\t{pr}\t+\t{p[-1]}\t+\t{overlap}M\n")
        else:
            for c, (s, p) in enumerate(zip(seqs, paths)):
                for i, v in enumerate(p):
                    fh.write(f"S\t{v}\t{s[i:i + k].decode()}\n")
                    if i:
                        fh.write(f"L\t{p[i - 1]}\t+\t{v}\t+\t{overlap}M\n")
                for pr in preds[c]:
                    if pr > 0:
                        fh.write(f"L\t{pr}\t+\t{p[0]}\t+\t{overlap}M\n")


def cmd_concatenate(args):
    # merge chunked graphs produced by sharded builds (reference
    # concatenate, build.cpp:359-456)
    from ..parallel.sharded_build import concatenate_chunks, suffix_buckets
    from ..kmer.alphabets import DNA
    files = list(args.fnames)
    if not files and args.infile_base:
        # gather <base>.<suffix>.chunk.npz in bucket colex order
        for sfx in suffix_buckets(DNA, args.len_suffix):
            name = "".join(DNA.letters[c] for c in sfx)
            p = f"{args.infile_base}.{name}.chunk.npz"
            if os.path.exists(p):
                files.append(p)
    concatenate_chunks(
        files, args.outfile_base, mode=args.mode,
        bits_per_count=args.count_width if args.count_kmers else 0)
    log(f"Concatenated {len(files)} chunks -> {args.outfile_base}")


def cmd_merge(args):
    from ..graph.boss_construct import build_boss_from_kmers
    from ..graph.dbg_succinct import DbgSuccinct
    from ..graph import io as graph_io
    from ..common import packed
    from ..kmer import packing as kp
    import jax.numpy as jnp
    graphs = [_load_graph(f) for f in args.fnames]
    k = graphs[0].k
    alphabet = graphs[0].alphabet
    B = alphabet.bits_per_char
    if getattr(args, "num_shards", 0) > 1:
        # streaming merge: serialized sorted edge sets feed the sharded
        # out-of-core finish directly (boss_merge.cpp role) — no re-sort
        # of the union in one dispatch, device working set O(total/S)
        from ..parallel.outofcore import merge_boss_graphs_out_of_core
        boss, valid_mask = merge_boss_graphs_out_of_core(
            graphs, n_shards=args.num_shards,
            keep_kmer_index=args.state != "small",
            verbose=args.verbose, return_valid=True)
        out = graph_io.save_graph(
            args.outfile_base,
            DbgSuccinct.from_boss(boss, alphabet, graphs[0].mode,
                                  valid=valid_mask),
            state=args.state)
        log(f"Merged {len(graphs)} graphs (streaming, "
            f"{args.num_shards} shards) -> {out}")
        return
    # merge = union of real edge k-mers, then rebuild dummies; weighted
    # inputs sum their counts per k-mer (reference merge accumulates
    # weights, boss_merge.cpp traversal + weight sum)
    weighted = all(g.boss.weights is not None for g in graphs)
    all_lanes, all_counts = [], []
    for g in graphs:
        lanes = g.boss.edge_lanes
        real = ~kp.contains_sentinel(lanes, k, B)
        # weights are (m,) with slot 0 = sentinel row; edge_lanes is (L, m-1)
        w = (g.boss.weights[1:] if weighted
             else jnp.ones((lanes.shape[1],), jnp.int32))
        comp, cnt, (wc,) = packed.compact(lanes, real, lanes.shape[1],
                                          w.astype(jnp.int32))
        n = int(cnt)
        all_lanes.append(comp[:, :n])
        all_counts.append(wc[:n])
    merged = jnp.concatenate(all_lanes, axis=1)
    counts = jnp.concatenate(all_counts)
    from ..graph.boss_construct import _sort_unique_stage
    u, ucounts, ucount = _sort_unique_stage(merged, counts,
                                            jnp.int32(merged.shape[1]))
    # 31-bit count headroom: merged weights must not clamp below the
    # inputs' widths (counts are int32 throughout)
    boss = build_boss_from_kmers(
        u, ucounts, int(ucount), k, alphabet,
        bits_per_count=31 if weighted else 0)
    out = graph_io.save_graph(args.outfile_base,
                              DbgSuccinct.from_boss(boss, alphabet,
                                                    graphs[0].mode))
    log(f"Merged {len(graphs)} graphs -> {out}")


def cmd_merge_anno(args):
    from ..anno.annotator import Annotation
    parts = [Annotation.load(f) for f in args.fnames]
    num_rows = max(p.matrix.num_rows for p in parts)
    merged = Annotation.merge(parts, num_rows)
    path = args.outfile_base + ".column.annodbg.npz"
    merged.save(path)
    log(f"Merged {len(parts)} annotations -> {path} "
        f"({merged.num_labels} labels)")


def _load_rd_artifacts(outfile_base):
    """Stage-0/1 artifacts (.row_count/.row_reduction) if present next to
    the output base — the staged-pipeline inputs to the final convert."""
    rc = rr = None
    p = outfile_base + ".row_count.npz"
    if os.path.exists(p):
        rc = np.load(p)["row_count"]
    p = outfile_base + ".row_reduction.npz"
    if os.path.exists(p):
        rr = np.load(p)["row_reduction"]
    return rc, rr


def cmd_transform_anno(args):
    from ..anno.annotator import Annotation, LabelEncoder
    from ..anno.matrix import RowSparse

    ann = Annotation.load(args.fnames[0])
    mat = ann.matrix
    if args.rename_cols:
        # whitespace-separated "<old> <new>" pairs
        # (transform_annotation.cpp:380-400)
        toks = open(args.rename_cols).read().split()
        if len(toks) % 2:
            raise SystemExit(f"{args.rename_cols}: odd token count in "
                             "rename rules")
        dic = dict(zip(toks[::2], toks[1::2]))
        enc = LabelEncoder([dic.get(l, l) for l in ann.encoder.labels])
        if len(enc) != len(ann.encoder.labels):
            raise SystemExit("rename rules collapse distinct labels")
        ann = Annotation(matrix=mat, encoder=enc)
    if args.aggregate_columns:
        # one "mask" column: rows set in [min_cols, max_cols] of the
        # input columns (transform_annotation.cpp:437-500)
        import math
        parts = [ann] + [Annotation.load(f) for f in args.fnames[1:]]
        num_columns = sum(p.num_labels for p in parts)
        num_rows = max(p.matrix.num_rows for p in parts)
        counts = np.zeros(num_rows, np.int64)
        for p in parts:
            m = p.matrix if isinstance(p.matrix, RowSparse) \
                else p.matrix.to_row_sparse()
            np.add.at(counts, np.asarray(m.rows).astype(np.int64), 1)
        min_cols = max(math.ceil(num_columns * args.min_fraction),
                       args.min_count)
        max_cols = min(math.floor(num_columns * args.max_fraction),
                       args.max_count if args.max_count is not None
                       else num_columns)
        keep = np.nonzero((counts >= min_cols) & (counts <= max_cols))[0]
        label = args.anno_label or "mask"
        out = Annotation(
            matrix=RowSparse.from_coo(keep, np.zeros(len(keep), np.int64),
                                      num_rows, 1),
            encoder=LabelEncoder([label]))
        path = args.outfile_base + ".column.annodbg.npz"
        out.save(path)
        log(f"Aggregated {num_columns} columns ({min_cols} <= * <= "
            f"{max_cols}) -> {path} ({len(keep)} rows set)")
        return
    if args.compute_linkage:
        # column linkage only (convert_to_MultiBRWT's first stage):
        # "<c1> <c2> <dist> <merged>" lines, leaves = column ids
        from ..anno.brwt import compute_linkage
        rs = mat if isinstance(mat, RowSparse) else mat.to_row_sparse()
        rows = compute_linkage(rs, subsample=args.num_rows_subsampled)
        path = args.outfile_base + ".linkage"
        with open(path, "w") as f:
            for c1, c2, dist, m in rows:
                f.write(f"{c1} {c2} {dist:g} {m}\n")
        log(f"Linkage of {rs.num_cols} columns -> {path}")
        return
    if args.dump_text_anno:
        # per-column text dump (ColumnCompressed::dump_columns):
        # first line "<num set bits>", then one set row id per line
        rs = mat if isinstance(mat, RowSparse) else mat.to_row_sparse()
        cols = np.asarray(rs.cols)
        rows = np.asarray(rs.rows)
        for ci, label in enumerate(ann.encoder.labels):
            rset = np.sort(rows[cols == ci])
            path = f"{args.outfile_base}.{ci}.text.annodbg"
            with open(path, "w") as f:
                f.write(f"{len(rset)}\n")
                f.write("".join(f"{int(r)}\n" for r in rset))
            log(f"Dumped column '{label}' -> {path}")
        return
    target = args.anno_type
    if target.startswith(("row_diff", "int_row_diff", "tuple_row_diff")) \
            and args.row_diff_stage < 2:
        # the reference's 3-stage out-of-core pipeline
        # (row_diff_builder.cpp): stage 0 accumulates per-row label
        # counts (.row_count), stage 1 per-row reduction stats
        # (.row_reduction); stage 2 consumes both. Repeat invocations
        # SUM into the artifacts (the reference processes column batches
        # the same way, row_diff_builder.cpp:125-190).
        from ..anno import row_diff as rd
        rs = mat if isinstance(mat, RowSparse) else mat.to_row_sparse()
        if args.row_diff_stage == 0:
            path = args.outfile_base + ".row_count.npz"
            counts = rd.compute_row_counts(rs)
            if os.path.exists(path):
                old = np.load(path)["row_count"]
                n = max(len(old), len(counts))
                acc = np.zeros(n, np.int64)
                acc[:len(old)] += old
                acc[:len(counts)] += counts
                counts = acc
            np.savez_compressed(path, row_count=counts)
            log(f"row_diff stage 0: accumulated label counts for "
                f"{rs.num_cols} columns -> {path}")
        else:
            assert args.infile_base, "row_diff stage 1 requires the graph (-i)"
            g = _load_graph(args.infile_base)
            cpath = args.outfile_base + ".row_count.npz"
            row_counts = (np.load(cpath)["row_count"]
                          if os.path.exists(cpath) else None)
            if target.startswith("int_row_diff") and rs.values is not None:
                red = rd.compute_row_reduction_int(
                    rs, g, max_length=args.max_path_length,
                    row_counts=row_counts)
            else:
                red = rd.compute_row_reduction(
                    rs, g, max_length=args.max_path_length,
                    row_counts=row_counts)
            path = args.outfile_base + ".row_reduction.npz"
            if os.path.exists(path):
                old = np.load(path)["row_reduction"]
                n = max(len(old), len(red))
                acc = np.zeros(n, np.int64)
                acc[:len(old)] += old
                acc[:len(red)] += red
                red = acc
            np.savez_compressed(path, row_reduction=red)
            log(f"row_diff stage 1: accumulated row reductions -> {path}")
        return
    if target == "brwt":
        from ..anno.brwt import build_brwt
        if not isinstance(mat, RowSparse):
            mat = mat.to_row_sparse()
        linkage = None
        if args.linkage_file:
            linkage = []
            for line in open(args.linkage_file):
                ps = line.split()
                if len(ps) == 4:
                    linkage.append((int(ps[0]), int(ps[1]), float(ps[2]),
                                    int(ps[3])))
        out_mat = build_brwt(mat, arity=args.arity,
                             subsample=args.num_rows_subsampled,
                             linkage=linkage)
        if args.relax_arity > 2:
            from ..anno.brwt import relax_brwt
            out_mat = relax_brwt(out_mat, args.relax_arity)
    elif target in ("row_diff", "int_row_diff"):
        assert args.infile_base, f"{target} requires the graph (-i)"
        g = _load_graph(args.infile_base)
        if args.disk_swap:
            # out-of-core staged conversion (row_diff_builder.cpp:322-688):
            # bounded RSS, input files streamed one at a time
            from ..anno import row_diff_disk
            build = (row_diff_disk.build_int_row_diff_staged
                     if target == "int_row_diff"
                     else row_diff_disk.build_row_diff_staged)
            out = build(args.fnames, g, swap_dir=args.disk_swap,
                        mem_cap_mb=int(args.mem_cap_gb * 1024),
                        max_length=args.max_path_length)
            path = args.outfile_base + f".{target}.annodbg.npz"
            out.save(path)
            log(f"Serialized {target} annotation to {path}")
            return
        rc, rr = _load_rd_artifacts(args.outfile_base)
        if target == "int_row_diff":
            from ..anno.row_diff import build_int_row_diff
            out_mat = build_int_row_diff(mat, g,
                                         max_length=args.max_path_length,
                                         row_counts=rc, row_reduction=rr)
        else:
            from ..anno.row_diff import build_row_diff
            if not isinstance(mat, RowSparse):
                mat = mat.to_row_sparse()
            out_mat = build_row_diff(mat, g,
                                     max_length=args.max_path_length,
                                     row_counts=rc, row_reduction=rr)
    elif target == "row_diff_brwt":
        from ..anno.row_diff import build_row_diff_brwt
        assert args.infile_base, "row_diff_brwt requires the graph (-i)"
        g = _load_graph(args.infile_base)
        if not isinstance(mat, RowSparse):
            mat = mat.to_row_sparse()
        out_mat = build_row_diff_brwt(mat, g,
                                      max_length=args.max_path_length,
                                      subsample=args.num_rows_subsampled)
    elif target == "row_diff_sparse":
        # RowDiff over a RowSparse delta matrix (RowDiffRowSparse,
        # static_annotators_def.hpp) — the delta store here is already
        # RowSparse, so this is the row_diff build under its own name
        from ..anno.row_diff import build_row_diff
        assert args.infile_base, "row_diff_sparse requires the graph (-i)"
        g = _load_graph(args.infile_base)
        if not isinstance(mat, RowSparse):
            mat = mat.to_row_sparse()
        rc, rr = _load_rd_artifacts(args.outfile_base)
        out_mat = build_row_diff(mat, g, max_length=args.max_path_length,
                                 row_counts=rc, row_reduction=rr)
    elif target == "int_brwt":
        from ..anno.int_brwt import build_int_brwt
        if not isinstance(mat, RowSparse):
            mat = mat.to_row_sparse()
        assert mat.values is not None, \
            "int_brwt needs a count annotation (annotate --count-kmers)"
        out_mat = build_int_brwt(mat, arity=args.arity,
                                 subsample=args.num_rows_subsampled)
    elif target in ("row_diff_int_brwt", "int_row_diff_brwt"):
        from ..anno.int_brwt import build_int_row_diff_brwt
        assert args.infile_base, f"{target} requires the graph (-i)"
        g = _load_graph(args.infile_base)
        if not isinstance(mat, RowSparse):
            mat = mat.to_row_sparse()
        assert mat.values is not None, \
            f"{target} needs a count annotation (annotate --count-kmers)"
        rc, rr = _load_rd_artifacts(args.outfile_base)
        out_mat = build_int_row_diff_brwt(
            mat, g, max_length=args.max_path_length, arity=args.arity,
            subsample=args.num_rows_subsampled,
            row_counts=rc, row_reduction=rr)
        target = "row_diff_int_brwt"
    elif target == "column_coord":
        from ..anno.coords import CoordMatrix
        assert isinstance(mat, CoordMatrix), \
            "column_coord needs a coordinate annotation input"
        out_mat = mat
    elif target in ("row_diff_coord", "tuple_row_diff"):
        from ..anno.coords import CoordMatrix, build_tuple_row_diff
        assert args.infile_base, "row_diff_coord requires the graph (-i)"
        assert isinstance(mat, CoordMatrix), \
            "row_diff_coord needs a coordinate annotation input"
        g = _load_graph(args.infile_base)
        out_mat = build_tuple_row_diff(mat, g,
                                       max_length=args.max_path_length)
    elif target in ("unique_row", "rbfish"):
        from ..anno.unique_row import UniqueRow
        if not isinstance(mat, RowSparse):
            mat = mat.to_row_sparse()
        out_mat = UniqueRow.from_row_sparse(mat)
    elif target == "rb_brwt":
        from ..anno.unique_row import UniqueRow
        if not isinstance(mat, RowSparse):
            mat = mat.to_row_sparse()
        out_mat = UniqueRow.from_row_sparse(mat).with_brwt_distinct(
            subsample=args.num_rows_subsampled)
    elif target in ("column", "row", "row_sparse", "flat"):
        out_mat = mat if isinstance(mat, RowSparse) else mat.to_row_sparse()
    elif target in ("bin_rel_wt", "bin_rel_wt_sdsl"):
        # binary-relation WT role: same query surface as the Multi-BRWT
        # (COMPONENTS.md subsumption); accepted under the reference
        # names and stored as a BRWT
        from ..anno.brwt import build_brwt
        if not isinstance(mat, RowSparse):
            mat = mat.to_row_sparse()
        out_mat = build_brwt(mat, arity=args.arity,
                             subsample=args.num_rows_subsampled)
    else:
        raise SystemExit(f"unknown annotation type {target}")
    out = Annotation(matrix=out_mat, encoder=ann.encoder)
    path = args.outfile_base + f".{target}.annodbg.npz"
    out.save(path)
    log(f"Serialized {target} annotation to {path}")


def cmd_relax_brwt(args):
    from ..anno.annotator import Annotation
    from ..anno.brwt import Brwt, relax_brwt

    ann = Annotation.load(args.fnames[0])
    assert isinstance(ann.matrix, Brwt), "input must be a BRWT annotation"
    out = Annotation(matrix=relax_brwt(ann.matrix, args.relax_arity),
                     encoder=ann.encoder)
    path = args.outfile_base + ".brwt.annodbg.npz"
    out.save(path)
    log(f"Serialized relaxed BRWT to {path}")


def cmd_server_query(args):
    from ..server.http_server import run_server
    run_server(args)


# ---------------------------------------------------------------------------
# distributed workflow (reference scripts/cloud/server.py role)
# ---------------------------------------------------------------------------

def cmd_coordinator(args):
    """Serve a work queue of per-suffix chunk-build jobs, wait for
    workers, then concatenate the chunks into the final graph
    (reference cloud work-queue server, scripts/cloud/server.py:88-230)."""
    from ..kmer.alphabets import DNA
    from ..parallel.coordinator import serve_queue
    from ..parallel.sharded_build import concatenate_chunks, suffix_buckets
    jobs = []
    chunk_files = []
    for sfx in suffix_buckets(DNA, args.suffix_len):
        name = "".join(DNA.letters[c] for c in sfx)
        argv = (["build", "-k", str(args.k), "--mode", args.mode,
                 "--suffix", name, "-o", args.outfile_base]
                + (["--count-kmers"] if args.count_kmers else [])
                + args.fnames)
        jobs.append({"argv": argv})
        chunk_files.append(f"{args.outfile_base}.{name}.chunk.npz")
    httpd, queue = serve_queue(jobs, host=args.host, port=args.port)
    log(f"Coordinator: {len(jobs)} jobs on "
        f"http://{httpd.server_address[0]}:{httpd.server_address[1]}")
    try:
        while not queue.finished():
            time.sleep(0.5)
    finally:
        httpd.shutdown()
    concatenate_chunks(
        chunk_files, args.outfile_base, mode=args.mode,
        bits_per_count=args.count_width if args.count_kmers else 0)
    log(f"Distributed build complete -> {args.outfile_base}")


def cmd_worker(args):
    """Pull and run jobs from a coordinator until the queue drains
    (reference cloud worker, scripts/cloud/client.py)."""
    from ..parallel.coordinator import Worker
    Worker(args.server, name=args.name).run_until_empty()
    log("Worker done: queue drained")


# ---------------------------------------------------------------------------
# argument parsing
# ---------------------------------------------------------------------------

# Reference options (config.cpp:100-420) accepted on every subcommand
# for script compatibility but with no effect here: threading/caching
# knobs the XLA runtime owns, the Bloom prefilter (subsumed: batched
# searchsorted has uniform hit/miss cost), and niche experimental modes.
# Setting one logs a warning naming it (see main()).
_PARITY_INERT = [
    ("--threads", dict(type=int, default=None,
                       help="thread count (XLA-managed here)")),
    ("--parallel-nodes", dict(type=int, default=None)),
    ("--bins-per-thread", dict(type=int, default=None)),
    ("--sequentially", dict(action="store_true")),
    ("--cache", dict(type=int, default=None)),
    ("--cache-size", dict(type=int, default=None)),
    ("--disk-cap-gb", dict(type=int, default=None)),
    ("--bloom-bpk", dict(type=float, default=None)),
    ("--bloom-max-num-hash-functions", dict(type=int, default=None)),
    ("--dynamic", dict(action="store_true")),
    ("--complete", dict(action="store_true")),
    ("--sparse", dict(action="store_true")),
    ("--num-kmers-in-seq", dict(type=int, default=None)),
    ("--frequency", dict(type=int, default=None)),
    ("--distance", dict(type=int, default=None)),
    ("--coord-binsize", dict(type=int, default=None)),
    ("--align-length", dict(type=int, default=None)),
    ("--filter-by-kmer", dict(action="store_true")),
    ("--intersected-anno", dict(default=None)),
    ("--annotator", dict(default=None)),
]
_INERT_ATTRS = [(f.lstrip("-").replace("-", "_"), f)
                for f, _ in _PARITY_INERT]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="metagraph",
                                description="MetaGraph on JAX")
    sub = p.add_subparsers(dest="command", required=True)

    def common_out(sp):
        sp.add_argument("-o", "--outfile-base", default="graph")

    _subparsers = []
    _orig_add_parser = sub.add_parser

    def _add_parser(*a, **kw):
        sp = _orig_add_parser(*a, **kw)
        # global flags accepted by every subcommand (reference Config):
        # -v enables span telemetry, -p is accepted for CLI parity (the
        # XLA runtime manages its own threading)
        sp.add_argument("-v", "--verbose", action="store_true")
        sp.add_argument("-p", "--parallel", type=int, default=1)
        sp.add_argument("--debug", action="store_true",
                        help="verbose logging (reference --debug)")
        # remaining reference options (config.cpp:100-420) accepted for
        # script compatibility; inert ones warn at dispatch
        for flag, fkw in _PARITY_INERT:
            sp.add_argument(flag, **fkw)
        _subparsers.append(sp)
        return sp

    sub.add_parser = _add_parser

    sp = sub.add_parser("build")
    sp.add_argument("-k", "--kmer-length", dest="k", type=int, required=True)
    sp.add_argument("--mode", choices=["basic", "canonical", "primary"],
                    default="basic")
    sp.add_argument("--count-kmers", action="store_true")
    sp.add_argument("--count-width", type=int, default=8)
    sp.add_argument("--mask-dummy", action="store_true")  # always on
    # reference --clear-dummy / --no-postprocessing (config.cpp:333-338):
    # dummy-edge erasure is always on here (the valid mask is built at
    # finalize), so both are accepted for workflow parity
    sp.add_argument("--clear-dummy", action="store_true")
    sp.add_argument("--no-postprocessing", action="store_true")
    # reference --index-ranges N (boss.cpp:index_suffix_ranges): the
    # always-on top-16-bit search LUT plays this role (stats reports the
    # equivalent indexed suffix length); accepted for workflow parity
    sp.add_argument("--index-ranges", type=int, default=None)
    sp.add_argument("--suffix-len", type=int, default=0)
    sp.add_argument("--suffix", default=None)
    sp.add_argument("--num-shards", type=int, default=1)
    sp.add_argument("--graph", default="succinct")
    sp.add_argument("--disk-swap", default="")
    sp.add_argument("--min-count", type=int, default=1)
    sp.add_argument("--max-count", type=int, default=None)
    sp.add_argument("--reference", default=None,
                    help="reference FASTA for VCF inputs")
    sp.add_argument("--alphabet", default="DNA",
                    choices=["DNA", "DNA5", "DNACaseSent", "Protein"])
    sp.add_argument("--fwd-and-reverse", action="store_true")
    sp.add_argument("--state", choices=["fast", "small"], default="fast")
    sp.add_argument("--mem-cap-gb", type=float, default=1.0,
                    help="in-HBM buffer cap for --disk-swap collection")
    sp.add_argument("--parts-total", type=int, default=1,
                    help="split the suffix buckets across this many "
                         "independent build invocations")
    sp.add_argument("--part-idx", type=int, default=0,
                    help="which bucket subset this invocation builds")
    common_out(sp)
    sp.add_argument("fnames", nargs="*")
    sp.set_defaults(func=cmd_build)

    sp = sub.add_parser("stats")
    sp.add_argument("--count-dummy", action="store_true")
    sp.add_argument("--print", dest="print_graph", action="store_true",
                    help="print the decoded BOSS table")
    sp.add_argument("--print-internal", dest="print_internal",
                    action="store_true",
                    help="print the internal W/last/F representation")
    sp.add_argument("--print-col-names", action="store_true")
    sp.add_argument("--validate", action="store_true",
                    help="check BOSS structural invariants")
    sp.add_argument("-a", "--annotation", default=None)
    sp.add_argument("fnames", nargs="+")
    sp.set_defaults(func=cmd_stats)

    sp = sub.add_parser("annotate")
    sp.add_argument("-i", "--infile-base", required=True)
    sp.add_argument("-o", "--outfile-base", default=None)
    sp.add_argument("--anno-filename", action="store_true")
    sp.add_argument("--anno-header", action="store_true")
    sp.add_argument("--header-delimiter", default="",
                    help="split sequence headers into multiple labels")
    sp.add_argument("--header-comment-delim", default="",
                    help="join fasta header with its comment using this "
                         "delimiter before label extraction "
                         "(reference --header-comment-delim)")
    sp.add_argument("--anno-label", action="append")
    sp.add_argument("--count-kmers", action="store_true")
    sp.add_argument("--coordinates", action="store_true")
    sp.add_argument("--separately", action="store_true")
    sp.add_argument("fnames", nargs="+")
    sp.set_defaults(func=cmd_annotate)

    sp = sub.add_parser("coordinate")
    sp.add_argument("-i", "--infile-base", required=True)
    sp.add_argument("-o", "--outfile-base", default=None)
    sp.add_argument("--anno-filename", action="store_true")
    sp.add_argument("--anno-header", action="store_true")
    sp.add_argument("--header-delimiter", default="")
    sp.add_argument("--anno-label", action="append")
    sp.set_defaults(count_kmers=False, coordinates=True, separately=False)
    sp.add_argument("fnames", nargs="+")
    sp.set_defaults(func=cmd_annotate)

    sp = sub.add_parser("query")
    sp.add_argument("-i", "--infile-base", default=None)
    sp.add_argument("-a", "--annotation", default=None)
    sp.add_argument("--address", default="",
                    help="query a running server_query at host:port "
                         "instead of loading an index")
    sp.add_argument("--count-labels", action="store_true")
    sp.add_argument("--count-kmers", dest="query_counts",
                    action="store_true")
    sp.add_argument("--query-counts", dest="query_counts",
                    action="store_true")
    sp.add_argument("--count-quantiles", default=None,
                    help="space-separated quantiles in [0, 1]")
    sp.add_argument("--print-signature", action="store_true")
    sp.add_argument("--query-coords", action="store_true")
    sp.add_argument("--suppress-unlabeled", action="store_true")
    sp.add_argument("--num-top-labels", type=int, default=2 ** 62)
    sp.add_argument("--discovery-fraction", type=float, default=0.7)
    sp.add_argument("--fwd-and-reverse", action="store_true")
    sp.add_argument("--labels-delimiter", dest="anno_labels_delimiter",
                    default=":")
    sp.add_argument("--align", action="store_true")
    sp.add_argument("--batch-align", action="store_true")
    # reference --max-hull-depth/--max-hull-forks bound the query-graph
    # hull expansion around suffix matches (query.cpp:735-765); the
    # batch path here aligns against the full graph directly, so the
    # hull approximation (and its knobs) is subsumed — accepted so
    # reference command lines run unchanged
    sp.add_argument("--max-hull-depth", type=int, default=None)
    sp.add_argument("--max-hull-forks", type=int, default=None)
    sp.add_argument("--align-min-exact-match", type=float, default=0.7)
    sp.add_argument("--fast", action="store_true")  # batch mode (default path)
    sp.add_argument("--batch-size", type=int, default=100 << 20)
    sp.add_argument("fnames", nargs="+")
    sp.set_defaults(func=cmd_query)

    sp = sub.add_parser("assemble")
    sp.add_argument("-i", "--infile-base", default=None)
    sp.add_argument("fnames", nargs="*")
    sp.add_argument("--enumerate", action="store_true",
                    help="number output sequences (always on here)")
    common_out(sp)
    sp.add_argument("--unitigs", action="store_true")
    sp.add_argument("--to-gfa", action="store_true")
    sp.add_argument("--compacted", action="store_true")
    sp.add_argument("--min-length", type=int, default=0)
    sp.add_argument("-a", "--annotation", default=None)
    sp.add_argument("--label-mask-in", action="append")
    sp.add_argument("--label-mask-out", action="append")
    sp.add_argument("--label-mask-in-fraction", type=float, default=1.0)
    sp.add_argument("--label-mask-out-fraction", type=float, default=0.0)
    sp.add_argument("--label-other-fraction", type=float, default=1.0)
    sp.set_defaults(func=cmd_assemble)

    sp = sub.add_parser("clean")
    sp.add_argument("-i", "--infile-base", default=None)
    sp.add_argument("fnames", nargs="*")
    common_out(sp)
    sp.add_argument("--min-count", type=int, default=1)
    sp.add_argument("--max-count", type=int, default=None)
    sp.add_argument("--min-count-q", type=float, default=0.0,
                    help="min k-mer abundance quantile")
    sp.add_argument("--max-count-q", type=float, default=1.0,
                    help="max k-mer abundance quantile")
    sp.add_argument("--min-count-auto", action="store_true")
    sp.add_argument("--prune-tips", type=int, default=1)
    sp.add_argument("--prune-unitigs", type=int, default=1)
    sp.add_argument("--fallback", type=int, default=5)
    sp.add_argument("--num-singletons", type=int, default=0,
                    help="override the count-1 bin of the abundance "
                         "histogram for threshold estimation")
    sp.add_argument("--smoothing-window", type=int, default=1)
    sp.add_argument("--count-slice-quantiles", "--count-bins-q",
                    dest="count_slice_quantiles", default="0 1",
                    help="space-separated quantiles; one fasta per "
                         "adjacent pair, binned by k-mer count")
    sp.add_argument("--to-fasta", action="store_true")
    sp.add_argument("--unitigs", action="store_true")
    sp.add_argument("--header", default="",
                    help="prefix for the output sequence headers")
    sp.set_defaults(func=cmd_clean)

    sp = sub.add_parser("align")
    sp.add_argument("-i", "--infile-base", required=True)
    sp.add_argument("-o", "--outfile-base", default=None)
    sp.add_argument("--map", dest="map_only", action="store_true")
    sp.add_argument("--count-kmers", action="store_true")
    sp.add_argument("--query-presence", action="store_true",
                    help="test reads for presence, report 0/1")
    sp.add_argument("--filter-present", action="store_true",
                    help="with --query-presence: emit present reads as "
                         "FASTA")
    sp.add_argument("--discovery-fraction", type=float, default=1.0)
    sp.add_argument("--align-both-strands", action="store_true")
    sp.add_argument("--align-edit-distance", action="store_true")
    sp.add_argument("--align-min-exact-match", type=float, default=0.7)
    sp.add_argument("--compacted", action="store_true")
    sp.add_argument("--align-min-seed-length", type=int, default=0)
    sp.add_argument("--align-max-seed-length", type=int, default=0,
                    help="clamp exact-match anchors to this length")
    sp.add_argument("--align-max-num-seeds-per-locus", type=int,
                    default=16)
    sp.add_argument("--align-max-nodes-per-seq-char", type=float,
                    default=0.0,
                    help="bounds the beam width (expanded nodes per "
                         "query char)")
    # scoring flags accept both the short and the reference's
    # --align-* spellings (config.cpp:1005-1030)
    sp.add_argument("--match-score", "--align-match-score",
                    dest="match_score", type=int, default=2)
    sp.add_argument("--mm-transition-penalty",
                    "--align-mm-transition-penalty",
                    dest="mm_transition_penalty", type=int, default=3)
    sp.add_argument("--mm-transversion-penalty",
                    "--align-mm-transversion-penalty",
                    dest="mm_transversion_penalty", type=int, default=3)
    sp.add_argument("--gap-opening-penalty", "--align-gap-open-penalty",
                    dest="gap_opening_penalty", type=int, default=5)
    sp.add_argument("--gap-extension-penalty",
                    "--align-gap-extension-penalty",
                    dest="gap_extension_penalty", type=int, default=2)
    sp.add_argument("--align-xdrop", type=int, default=27)
    sp.add_argument("--align-min-cell-score", type=int, default=None,
                    help="prune beam entries whose best DP cell falls "
                         "below this (reference config.cpp:237)")
    sp.add_argument("--align-max-ram", type=float, default=None,
                    help="approximate per-batch DP memory budget in MB "
                         "(reference config.cpp:255); caps the extension "
                         "sub-batch size")
    sp.add_argument("--align-min-path-score", type=int, default=0,
                    help="drop alignments scoring below this")
    sp.add_argument("--num-alternative-paths",
                    "--align-alternative-alignments",
                    dest="num_alternative_paths", type=int, default=1)
    sp.add_argument("--json", action="store_true")
    sp.add_argument("fnames", nargs="+")
    sp.set_defaults(func=cmd_align)

    sp = sub.add_parser("extend")
    sp.add_argument("-i", "--infile-base", required=True)
    sp.add_argument("-o", "--outfile-base", default=None)
    sp.add_argument("--count-width", type=int, default=8)
    sp.add_argument("fnames", nargs="+")
    sp.set_defaults(func=cmd_extend)

    sp = sub.add_parser("compare")
    sp.add_argument("fnames", nargs=2)
    sp.set_defaults(func=cmd_compare)

    sp = sub.add_parser("transform")
    sp.add_argument("-i", "--infile-base", default=None)
    sp.add_argument("fnames", nargs="*")
    sp.add_argument("--enumerate", action="store_true",
                    help="number output sequences (always on here)")
    common_out(sp)
    sp.add_argument("--to-fasta", action="store_true")
    sp.add_argument("--primary-kmers", action="store_true")
    sp.add_argument("--to-gfa", action="store_true")
    sp.add_argument("--compacted", action="store_true")
    sp.add_argument("--to-adj-list", action="store_true")
    sp.add_argument("--state", choices=["fast", "small"], default=None)
    sp.add_argument("--initialize-bloom", action="store_true")
    sp.add_argument("--bloom-fpp", type=float, default=None)
    sp.set_defaults(func=cmd_transform)

    sp = sub.add_parser("concatenate")
    common_out(sp)
    sp.add_argument("-i", "--infile-base", default=None)
    sp.add_argument("--len-suffix", type=int, default=1)
    sp.add_argument("--mode", choices=["basic", "canonical", "primary"],
                    default="basic")
    sp.add_argument("--count-kmers", action="store_true")
    sp.add_argument("--count-width", type=int, default=8)
    sp.add_argument("fnames", nargs="*")
    sp.set_defaults(func=cmd_concatenate)

    sp = sub.add_parser("merge")
    common_out(sp)
    sp.add_argument("fnames", nargs="+")
    sp.add_argument("--num-shards", type=int, default=0,
                    help="stream the merge through the out-of-core "
                         "sharded finish (beyond-HBM inputs)")
    sp.add_argument("--state", choices=["fast", "small"], default="fast")
    sp.set_defaults(func=cmd_merge)

    sp = sub.add_parser("merge_anno")
    sp.add_argument("-o", "--outfile-base", required=True)
    sp.add_argument("fnames", nargs="+")
    sp.set_defaults(func=cmd_merge_anno)

    sp = sub.add_parser("transform_anno")
    sp.add_argument("-o", "--outfile-base", required=True)
    sp.add_argument("-i", "--infile-base", default=None,
                    help="graph (required for row_diff)")
    sp.add_argument("--anno-type", default="column",
                    choices=["column", "row", "row_sparse", "flat", "brwt",
                             "bin_rel_wt", "bin_rel_wt_sdsl",
                             "row_diff", "row_diff_sparse", "int_row_diff",
                             "unique_row", "rbfish", "rb_brwt",
                             "row_diff_brwt", "int_brwt",
                             "row_diff_int_brwt", "int_row_diff_brwt",
                             "column_coord", "row_diff_coord",
                             "tuple_row_diff"])
    sp.add_argument("--max-path-length", type=int, default=64)
    sp.add_argument("--arity", type=int, default=2,
                    help="BRWT tree arity for the bottom-up build "
                         "(reference --arity)")
    sp.add_argument("--relax-arity", type=int, default=2)
    sp.add_argument("--num-rows-subsampled", "--subsample",
                    dest="num_rows_subsampled", type=int, default=1000000)
    sp.add_argument("--disk-swap", default="",
                    help="directory for the out-of-core staged row_diff "
                         "conversion (bounded RSS)")
    sp.add_argument("--mem-cap-gb", type=float, default=1.0,
                    help="spill buffer cap for --disk-swap conversions")
    sp.add_argument("--row-diff-stage", type=int, default=2,
                    help="reference 3-stage conversion: 0 accumulates "
                         "row label counts, 1 row reduction stats, 2 "
                         "runs the conversion")
    sp.add_argument("--rename-cols", default="",
                    help="file with '<old> <new>' label rename pairs")
    sp.add_argument("--dump-text-anno", action="store_true",
                    help="dump each column as a text file of set row ids")
    sp.add_argument("--linkage", dest="compute_linkage",
                    action="store_true",
                    help="only compute the column linkage file")
    sp.add_argument("--greedy", action="store_true",
                    help="greedy column pairing (the only strategy here)")
    sp.add_argument("--linkage-file", default="",
                    help="guide the BRWT tree with this linkage file")
    sp.add_argument("--aggregate-columns", action="store_true")
    sp.add_argument("--min-count", type=int, default=1)
    sp.add_argument("--max-count", type=int, default=None)
    sp.add_argument("--min-fraction", type=float, default=0.0)
    sp.add_argument("--max-fraction", type=float, default=1.0)
    sp.add_argument("--anno-label", default="",
                    help="label of the aggregated column")
    sp.add_argument("fnames", nargs="+")
    sp.set_defaults(func=cmd_transform_anno)

    sp = sub.add_parser("relax_brwt")
    sp.add_argument("-o", "--outfile-base", required=True)
    sp.add_argument("--relax-arity", type=int, default=8)
    sp.add_argument("fnames", nargs="+")
    sp.set_defaults(func=cmd_relax_brwt)

    sp = sub.add_parser("coordinator")
    sp.add_argument("-k", "--kmer-length", dest="k", type=int, required=True)
    sp.add_argument("--mode", choices=["basic", "canonical", "primary"],
                    default="basic")
    sp.add_argument("--count-kmers", action="store_true")
    sp.add_argument("--count-width", type=int, default=8)
    sp.add_argument("--suffix-len", type=int, default=1)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=0)
    common_out(sp)
    sp.add_argument("fnames", nargs="+")
    sp.set_defaults(func=cmd_coordinator)

    sp = sub.add_parser("worker")
    sp.add_argument("--server", required=True)
    sp.add_argument("--name", default="worker")
    sp.set_defaults(func=cmd_worker)

    sp = sub.add_parser("server_query")
    sp.add_argument("-i", "--infile-base", required=True)
    sp.add_argument("-a", "--annotation", required=True)
    sp.add_argument("--port", type=int, default=5555)
    sp.add_argument("--host", default="127.0.0.1")
    sp.set_defaults(func=cmd_server_query)

    return p


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    if getattr(args, "debug", False):
        args.verbose = True
    if getattr(args, "verbose", False):
        from ..common import telemetry
        telemetry.VERBOSE = True
    # warn on accepted-but-inert reference options (see _PARITY_INERT)
    for attr, flag in _INERT_ATTRS:
        v = getattr(args, attr, None)
        if v not in (None, False):
            log(f"WARNING: {flag} is accepted for reference-script "
                f"compatibility but has no effect in this implementation")
    args.func(args)


if __name__ == "__main__":
    main()
