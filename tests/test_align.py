"""Aligner tests: exact, mismatch, indel, reverse-complement reads."""

import numpy as np
import pytest

from conftest import random_dna
from metagraph_tpu.align.aligner import (Aligner, AlignerConfig,
                                         affine_semiglobal, _revcomp)
from metagraph_tpu.graph.boss_construct import build_boss
from metagraph_tpu.graph.canonical import CanonicalDbg
from metagraph_tpu.graph.dbg_succinct import DbgSuccinct
from metagraph_tpu.kmer.alphabets import DNA


@pytest.fixture(scope="module")
def ref_graph():
    rng = np.random.default_rng(7)
    ref = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=400))
    g = DbgSuccinct.from_boss(build_boss([ref], 15), DNA, "basic")
    return g, ref


def test_exact_read(ref_graph):
    g, ref = ref_graph
    read = ref[100:200]
    aln = Aligner(g).align(read)[0]
    assert aln.score == 2 * len(read)
    assert aln.cigar == f"{len(read)}="
    assert aln.sequence == read
    assert not aln.orientation


def test_reverse_complement_read(ref_graph):
    # rc reads align only under --align-both-strands on a basic graph
    # (reference dbg_aligner.hpp:160 forward-only default)
    g, ref = ref_graph
    read = _revcomp(ref[100:200])
    aln = Aligner(g).align(read, both_strands=True)[0]
    assert aln.orientation
    assert aln.score == 2 * len(read)
    assert aln.sequence == ref[100:200]


@pytest.mark.parametrize("graph_mode", ["canonical", "primary"])
@pytest.mark.parametrize("strand", ["forward", "reverse"])
def test_canonical_graph_spells_the_read(strand, graph_mode):
    """On a canonical graph (both orientations), and on a primary graph
    seen through CanonicalDbg as the CLI loads it, the reported path is the
    read's own strand, not the canonical form of each k-mer."""
    rng = np.random.default_rng(11)
    ref = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=400))
    g = DbgSuccinct.from_boss(build_boss([ref], 15, mode=graph_mode),
                              DNA, graph_mode)
    if graph_mode == "primary":
        g = CanonicalDbg(base=g)
    read = ref[100:200] if strand == "forward" else _revcomp(ref[100:200])
    aln = Aligner(g).align(read)[0]
    assert aln.score == 2 * len(read)
    assert aln.cigar == f"{len(read)}="
    assert aln.sequence == read


def test_single_mismatch(ref_graph):
    g, ref = ref_graph
    read = bytearray(ref[100:200])
    old = read[50]
    # transversion substitution
    sub = {65: 67, 67: 65, 71: 84, 84: 71}  # A<->C, G<->T
    read[50] = sub[old]
    aln = Aligner(g).align(bytes(read))[0]
    # 99 matches, 1 transversion mismatch
    assert aln.score == 2 * 99 - 3
    assert "X" in aln.cigar
    assert aln.cigar.count("X") == 1
    assert aln.sequence == ref[100:200]


def test_prefix_mismatch_extension(ref_graph):
    """Mismatch near the read start exercises backward extension."""
    g, ref = ref_graph
    read = bytearray(ref[100:180])
    old = read[5]
    sub = {65: 67, 67: 65, 71: 84, 84: 71}
    read[5] = sub[old]
    aln = Aligner(g).align(bytes(read))[0]
    assert aln.score == 2 * 79 - 3
    assert aln.query_begin == 0


def test_unmappable_read(ref_graph):
    g, ref = ref_graph
    read = b"A" * 60
    res = Aligner(g).align(read)
    # homopolymer absent from random reference (with high probability)
    assert not res or res[0].score < 2 * 30


def test_map_fraction(ref_graph):
    g, ref = ref_graph
    nodes = g.map_to_nodes(ref[50:150])
    assert (nodes > 0).all()


def test_affine_semiglobal_gold():
    sub = AlignerConfig().score_matrix()
    q = np.array([1, 2, 3, 4, 1, 2], np.int32)       # ACGTAC
    r = np.array([1, 2, 3, 4, 1, 2], np.int32)
    score, qe, re_, ops = affine_semiglobal(q, r, sub, 5, 2)
    assert score == 12 and ops == ["="] * 6
    # deletion in query: ref has an extra char
    r2 = np.array([1, 2, 3, 3, 4, 1, 2], np.int32)   # ACG G TAC
    score2, _, _, ops2 = affine_semiglobal(q, r2, sub, 5, 2)
    assert score2 == 12 - 5
    assert "".join(ops2).count("D") == 1
    # insertion in query
    q3 = np.array([1, 2, 3, 3, 4, 1, 2], np.int32)
    score3, _, _, ops3 = affine_semiglobal(q3, r, sub, 5, 2)
    assert score3 == 12 - 5
    assert "".join(ops3).count("I") == 1


def test_insertion_read(ref_graph):
    g, ref = ref_graph
    read = ref[100:150] + b"G" + ref[150:200]  # 1-bp insertion
    aln = Aligner(g).align(read)[0]
    # expected: 100 matches + gap open (or 99+X..X depending on context)
    assert aln.score >= 2 * 100 - 5 - 4  # allow suboptimal tie
    assert aln.sequence == ref[100:200] or len(aln.sequence) >= 90


def test_suffix_seed_fallback(ref_graph):
    """A read shorter than k (or with no full-k match) still aligns via
    suffix seeds (reference SuffixSeeder)."""
    g, ref = ref_graph
    # take a 10bp fragment (k=15): no full k-mer can match
    frag = ref[200:210]
    res = Aligner(g).align(frag)
    assert res, "suffix seeding should produce an alignment"
    aln = res[0]
    assert aln.score >= 2 * len(frag) - 6  # mostly matching
    assert aln.query_begin == 0


def test_multiple_seeds_extended(ref_graph):
    """Every exact run is extended as its own anchor (the reference
    extends all seeds and keeps top-N, dbg_aligner.cpp align_core):
    a chimeric read half from one region, half from a distant region
    must yield two distinct alternative alignments."""
    g, ref = ref_graph
    read = ref[50:90] + ref[300:340]   # two 40bp anchors, k=15
    cfg = AlignerConfig(min_exact_match=0.3)
    res = Aligner(g, cfg).align_batch([read], num_alternative_paths=4)[0]
    assert len(res) >= 2
    # the two alternatives anchor different query intervals
    spans = {(a.query_begin, a.query_end) for a in res}
    assert len(spans) >= 2
    # each alternative's matched interval is a real exact region
    best = res[0]
    assert best.num_matches >= 40


def test_batch_matches_single_with_multiseeds(ref_graph):
    g, ref = ref_graph
    rng = np.random.default_rng(3)
    reads = [ref[i:i + 80] for i in (0, 77, 200)]
    batch = Aligner(g).align_batch(reads)
    for read, res in zip(reads, batch):
        assert res and res[0].score == 2 * len(read)
        assert res[0].cigar == f"{len(read)}="


def test_batched_ends_match_cigar_ends(rng, ref_graph):
    """batched_ends (score-only engine) must agree with batched_cigars'
    (score, q_end, r_end) exactly — same DP, same argmax tie rule."""
    from metagraph_tpu.align.batch_extender import batched_cigars, batched_ends
    cfg = AlignerConfig()
    sub = cfg.score_matrix()
    B, LQ, LR = 9, 33, 37
    q = rng.integers(1, 5, (B, LQ)).astype(np.int32)
    r = rng.integers(1, 5, (B, LR)).astype(np.int32)
    # make some pairs related so scores vary
    r[0, :LQ] = q[0]
    r[1, :20] = q[1, :20]
    qlens = rng.integers(5, LQ + 1, B).astype(np.int32)
    rlens = rng.integers(5, LR + 1, B).astype(np.int32)
    args = (cfg.gap_opening_penalty, cfg.gap_extension_penalty,
            cfg.match_score, cfg.mm_transition_penalty,
            cfg.mm_transversion_penalty)
    cig = batched_cigars(q, r, qlens, rlens, sub, *args)
    ends = batched_ends(q, r, qlens, rlens, *args)
    for b in range(B):
        score, q_end, r_end, _ = cig[b]
        assert ends[b, 0] == score
        assert ends[b, 1] == r_end
        assert ends[b, 2] == q_end


def test_align_batch_score_only(ref_graph):
    """with_cigar=False returns the same sequences/scores/spans as the
    CIGAR path for reads it keeps."""
    g, ref = ref_graph
    reads = [ref[10:90], ref[200:280]]
    reads.append(bytearray(ref[100:180]))
    reads[2][40] = ord("T") if reads[2][40] != ord("T") else ord("A")
    reads[2] = bytes(reads[2])
    full = Aligner(g).align_batch(reads)
    fast = Aligner(g).align_batch(reads, with_cigar=False)
    for fu, fa in zip(full, fast):
        assert fu and fa
        assert fa[0].score == fu[0].score
        assert fa[0].sequence == fu[0].sequence
        assert (fa[0].query_begin, fa[0].query_end) == \
            (fu[0].query_begin, fu[0].query_end)


def test_batch_suffix_seed_matches_single(ref_graph):
    """Batched suffix-seed extension equals the per-read path
    (Aligner.align) for short reads with no full-k window."""
    g, ref = ref_graph
    frags = [ref[200:210], ref[37:49], ref[300:311]]
    single = [Aligner(g).align(f) for f in frags]
    batch = Aligner(g).align_batch(frags)
    for s, b in zip(single, batch):
        assert bool(s) == bool(b)
        if s:
            assert b[0].score == s[0].score
            assert b[0].sequence == s[0].sequence
            assert b[0].cigar == s[0].cigar


def test_device_traceback_matches_host_gold(rng):
    """_dp_traceback's cigar ops must equal affine_semiglobal's host
    traceback on random pairs (same branch order, same run semantics)."""
    from metagraph_tpu.align.batch_extender import batched_cigars
    cfg = AlignerConfig()
    sub = cfg.score_matrix()
    B, LQ, LR = 16, 24, 28
    q = rng.integers(1, 5, (B, LQ)).astype(np.int32)
    r = rng.integers(1, 5, (B, LR)).astype(np.int32)
    r[0, :LQ] = q[0]
    r[1, :10] = q[1, :10]
    qlens = rng.integers(3, LQ + 1, B).astype(np.int32)
    rlens = rng.integers(3, LR + 1, B).astype(np.int32)
    got = batched_cigars(q, r, qlens, rlens, sub,
                         cfg.gap_opening_penalty, cfg.gap_extension_penalty,
                         cfg.match_score, cfg.mm_transition_penalty,
                         cfg.mm_transversion_penalty)
    for b in range(B):
        ws, wqe, wre, wops = affine_semiglobal(
            q[b, :qlens[b]], r[b, :rlens[b]], sub,
            cfg.gap_opening_penalty, cfg.gap_extension_penalty)
        gs, gqe, gre, gops = got[b]
        assert (gs, gqe, gre) == (ws, wqe, wre), b
        # batched_cigars returns op CODES (1..4); map to chars to compare
        op_chars = np.array(["", "=", "X", "D", "I"])
        assert list(op_chars[np.asarray(gops)]) == wops, (b, gops, wops)


def test_small_state_align(ref_graph, tmp_path):
    """Small-state graphs (no edge_lanes accelerator) must align through
    the rank/select search paths, including suffix seeding (reference
    SuffixSeeder over BOSS index_range, aligner_seeder_methods.hpp:16)."""
    from metagraph_tpu.graph.io import save_graph, load_graph
    g, ref = ref_graph
    p = save_graph(str(tmp_path / "g"), g, state="small")
    gs = load_graph(p)
    assert gs.boss.edge_lanes is None
    read = ref[100:200]
    aln = Aligner(gs).align(read)[0]
    assert aln.score == 2 * len(read)
    assert aln.sequence == read
    # a read whose only full-k seeds are destroyed exercises suffix seeds:
    # take a short prefix-anchored read with a mutated tail
    short = bytearray(ref[200:240])
    sub = {65: 67, 67: 65, 71: 84, 84: 71}
    for i in range(20, 40):
        short[i] = sub[short[i]]
    fast = Aligner(g).align(bytes(short))
    small = Aligner(gs).align(bytes(short))
    if fast:
        assert small, "small-state alignment missing where fast state aligns"
        assert small[0].score == fast[0].score


def test_small_state_suffix_range_matches_lanes(ref_graph):
    """suffix_range_ranksel must return the same edge-row range the
    packed-lanes binary search finds for every (prefix, s)."""
    import jax.numpy as jnp
    from metagraph_tpu.common import packed as pk
    g, ref = ref_graph
    boss = g.boss
    K, B = g.k, g.boss.bits_per_char
    lanes = boss.edge_lanes
    L = lanes.shape[0]
    rng = np.random.default_rng(3)
    from metagraph_tpu.kmer.alphabets import DNA
    enc = np.zeros(256, np.int32)
    for i, ch in enumerate(b"$ACGT"):
        enc[ch] = i
    for trial in range(20):
        pos = rng.integers(0, len(ref) - K)
        s = int(rng.integers(2, K))
        pattern = enc[np.frombuffer(ref[pos:pos + s], np.uint8)]
        ok, rl, ru = boss.suffix_range_ranksel(jnp.asarray(pattern))
        lo = jnp.zeros((L, 1), pk.LANE_DTYPE)
        for j in range(s):
            lo = pk.set_field(lo, K - s + j,
                              jnp.full((1,), int(pattern[j]), jnp.uint32), B)
        unit = pk.set_field(jnp.zeros((L, 1), pk.LANE_DTYPE), K - s,
                            jnp.ones((1,), jnp.uint32), B)
        lo_i = int(pk.searchsorted(lanes, lo, side="left")[0]) + 1
        hi_i = int(pk.searchsorted(lanes, lo + unit, side="left")[0])
        if hi_i >= lo_i:
            assert bool(ok), (trial, s)
            assert (int(rl), int(ru)) == (lo_i, hi_i), (trial, s)
        else:
            assert not bool(ok) or int(rl) > int(ru)


# ---------------------------------------------------------------------------
# protein / BLOSUM62 / unit scoring (reference aligner_config.cpp:97-222)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def protein_graph():
    from metagraph_tpu.kmer.alphabets import PROTEIN
    rng = np.random.default_rng(11)
    letters = np.frombuffer(PROTEIN.letters[1:].encode(), np.uint8)
    ref = bytes(rng.choice(letters, size=300))
    g = DbgSuccinct.from_boss(build_boss([ref], 9, PROTEIN), PROTEIN,
                              "basic")
    return g, ref


def test_blosum62_matrix_values():
    """Spot-check the table against textbook BLOSUM62 entries."""
    from metagraph_tpu.align.aligner import blosum62_matrix
    from metagraph_tpu.kmer.alphabets import PROTEIN
    s = blosum62_matrix(PROTEIN)
    enc = {ch: i for i, ch in enumerate(PROTEIN.letters)}
    assert s[enc["W"], enc["W"]] == 11
    assert s[enc["A"], enc["A"]] == 4
    assert s[enc["A"], enc["R"]] == -1
    assert s[enc["C"], enc["C"]] == 9
    assert s[enc["E"], enc["Q"]] == 2
    assert s[enc["W"], enc["G"]] == -2
    # letters outside the BLOSUM set: -4 off-diagonal, +1 self
    assert s[enc["J"], enc["J"]] == 1
    assert s[enc["J"], enc["A"]] == -4
    # symmetric
    assert (s == s.T).all()


def test_protein_exact_read(protein_graph):
    g, ref = protein_graph
    from metagraph_tpu.align.aligner import blosum62_matrix
    read = ref[50:110]
    al = Aligner(g)
    assert al._sub_tt is not None       # table scoring engaged
    aln = al.align(read)[0]
    sub = blosum62_matrix(g.alphabet)
    enc = g.alphabet.encode_table()
    codes = enc[np.frombuffer(read, np.uint8)].astype(int)
    expect = int(sub[codes, codes].sum())
    assert aln.cigar == f"{len(read)}="
    assert aln.score == expect
    assert aln.sequence == read


def test_protein_substitution_scored_by_blosum(protein_graph):
    g, ref = protein_graph
    from metagraph_tpu.align.aligner import blosum62_matrix
    sub = blosum62_matrix(g.alphabet)
    enc = g.alphabet.encode_table()
    read = bytearray(ref[50:110])
    old = read[30]
    # pick a substitution with a known BLOSUM62 penalty
    new = ord("W") if old != ord("W") else ord("A")
    read[30] = new
    cfg = AlignerConfig(min_exact_match=0.5)
    aln = Aligner(g, cfg).align(bytes(read))[0]
    codes = enc[np.frombuffer(ref[50:110], np.uint8)].astype(int)
    expect = int(sub[codes, codes].sum()) - int(sub[codes[30], codes[30]]) \
        + int(sub[enc[new], codes[30]])
    assert aln.cigar.count("X") == 1
    assert aln.score == expect
    assert aln.sequence == ref[50:110]


def test_unit_matrix_edit_distance(ref_graph):
    """score_matrix_type='unit': +1 match / -1 mismatch via the table
    path (reference unit_scoring_matrix)."""
    g, ref = ref_graph
    read = bytearray(ref[100:200])
    sub = {65: 67, 67: 65, 71: 84, 84: 71}
    read[50] = sub[read[50]]
    cfg = AlignerConfig(score_matrix_type="unit", match_score=1,
                        mm_transition_penalty=1, mm_transversion_penalty=1,
                        gap_opening_penalty=1, gap_extension_penalty=1,
                        min_exact_match=0.5)
    al = Aligner(g, cfg)
    assert al._sub_tt is not None
    aln = al.align(bytes(read))[0]
    assert aln.score == 99 - 1
    assert aln.cigar.count("X") == 1
