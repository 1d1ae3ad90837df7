"""Sequence-to-graph alignment: seed & extend.

Covers the reference aligner stack (metagraph/src/graph/alignment/):
DBGAlignerConfig scoring (aligner_config.hpp:18-96 — match/transition/
transversion + affine gaps + x-drop), ExactSeeder (aligner_seeder_methods
.hpp:16), and a column extender (aligner_extender_methods.hpp:43) that
walks graph successors from the seed end with banded affine-gap DP and
x-drop + beam pruning.

Layering: seeding is fully batched on device (one map_to_nodes over all
query windows); extension is the whole-batch lockstep beam DP of
align/batch_extender.py (one lax.scan for every read at once); CIGARs
come from the batched device traceback. The single-read ``align()`` is
a batch of one — there is exactly one extension engine.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

NEG = -(10 ** 9)

# BLOSUM62 substitution scores (standard public matrix; the reference
# embeds the same table, aligner_config.cpp:174-219). Row/col order:
_BLOSUM62_ORDER = "ARNDCQEGHILKMFPSTWYVBZX"
_BLOSUM62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1
-2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1
-1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1
"""


def blosum62_matrix(alphabet) -> np.ndarray:
    """(size, size) BLOSUM62 scores over an alphabet's code space
    (reference: DBGAlignerConfig::score_matrix_blosum62,
    aligner_config.cpp:174-222). Letters outside the 23-symbol BLOSUM
    set (J, O, U and the sentinel) score -4 vs everything and +1 vs
    themselves, matching the reference's fill rule."""
    vals = np.array(_BLOSUM62.split(), np.int32).reshape(23, 23)
    pos = {ch: i for i, ch in enumerate(_BLOSUM62_ORDER)}
    size = alphabet.size
    s = np.full((size, size), -4, np.int32)
    np.fill_diagonal(s, 1)
    for a, ca in enumerate(alphabet.letters):
        for b, cb in enumerate(alphabet.letters):
            ia, ib = pos.get(ca.upper()), pos.get(cb.upper())
            if ia is not None and ib is not None:
                s[a, b] = vals[ia, ib]
    s[0, :] = -4
    s[:, 0] = -4
    return s


def unit_matrix(alphabet, match_score: int = 1) -> np.ndarray:
    """Edit-distance scoring: +match on identical real letters, -match
    otherwise (reference: unit_scoring_matrix, aligner_config.cpp:153)."""
    size = alphabet.size
    s = np.full((size, size), -match_score, np.int32)
    for c in range(1, size):
        s[c, c] = match_score
    return s


@dataclass
class AlignerConfig:
    match_score: int = 2
    mm_transition_penalty: int = 3
    mm_transversion_penalty: int = 3
    gap_opening_penalty: int = 5      # positive penalties, subtracted
    gap_extension_penalty: int = 2
    xdrop: int = 27
    min_seed_length: int = 0
    max_seed_length: int = 0           # 0 = unbounded (reference
                                       # --align-max-seed-length)
    min_exact_match: float = 0.7
    min_cell_score: Optional[int] = None  # prune beam entries whose best
                                          # cell drops below this
                                          # (reference config.cpp:237)
    max_ram_mb: Optional[float] = None    # DP memory budget -> extension
                                          # sub-batch cap (config.cpp:255)
    beam_width: int = 4         # batch beam entries per read (validated:
                                # 4 misses 0/1000 vs 64 on 2-SNP+indel
                                # reads, scripts/align_validate.py)
    max_seeds_per_read: int = 4        # anchors extended per read/strand
    max_seeds_per_locus: int = 16      # suffix-seed candidates per locus
                                       # (reference --align-max-num-seeds-
                                       # per-locus, seeder_methods)
    # scoring matrix selection (reference set_scoring_matrix,
    # aligner_config.cpp:97-129): "auto" = dna matrix for DNA alphabets /
    # BLOSUM62 for Protein; "unit" = edit distance (--align-edit-distance)
    score_matrix_type: str = "auto"

    def score_matrix(self, alphabet=None) -> np.ndarray:
        """(size, size) substitution scores over alphabet codes.

        DNA default: transition/transversion matrix (A<->G, C<->T
        transitions); Protein default: BLOSUM62; "unit": edit distance.
        With no alphabet, the historical (5, 5) DNA matrix is returned."""
        kind = self.score_matrix_type
        if kind == "auto":
            kind = ("blosum62" if alphabet is not None
                    and alphabet.name == "Protein" else "dna")
        if kind == "unit":
            from ..kmer.alphabets import DNA
            return unit_matrix(alphabet or DNA, 1)
        if kind == "blosum62":
            if alphabet is None:
                from ..kmer.alphabets import PROTEIN
                alphabet = PROTEIN
            return blosum62_matrix(alphabet)
        size = alphabet.size if alphabet is not None else 5
        s = np.full((size, size), -self.mm_transversion_penalty, np.int32)
        for a, b in [(1, 3), (3, 1), (2, 4), (4, 2)]:  # A<->G, C<->T
            if a < size and b < size:
                s[a, b] = -self.mm_transition_penalty
        for c in range(1, min(5, size)):
            s[c, c] = self.match_score
        s[0, :] = -self.mm_transversion_penalty
        s[:, 0] = -self.mm_transversion_penalty
        return s

    def uses_table_scoring(self, alphabet) -> bool:
        """True when the extension DP must gather from the matrix instead
        of using the arithmetic DNA transition/transversion formula."""
        kind = self.score_matrix_type
        if kind == "auto":
            kind = "blosum62" if alphabet.name == "Protein" else "dna"
        return kind != "dna"


@dataclass
class GraphAlignment:
    score: int
    cigar: str
    query_begin: int
    query_end: int                     # exclusive
    sequence: bytes                    # matched path spelling
    nodes: List[int]
    orientation: bool = False          # True = reverse complement

    @property
    def num_matches(self) -> int:
        """Number of '=' positions in the cigar (Alignment::get_num_matches)."""
        import re
        return sum(int(n) for n, op in re.findall(r"(\d+)([=XIDS])", self.cigar)
                   if op == "=")

    def to_json(self, name: str = "") -> dict:
        return {
            "name": name,
            "score": int(self.score),
            "cigar": self.cigar,
            "query_begin": self.query_begin,
            "query_end": self.query_end,
            "sequence": self.sequence.decode(),
            "orientation": "-" if self.orientation else "+",
        }


_OP_CHARS = np.array(["", "=", "X", "D", "I"])
_EQ = np.int8(1)


def _compress_ops_codes(a: np.ndarray) -> str:
    """RLE cigar from an int op-code array (1 = '=', 2 = 'X', 3 = 'D',
    4 = 'I') — numpy run detection, one join over the few runs."""
    if len(a) == 0:
        return ""
    b = np.nonzero(np.diff(a))[0]
    starts = np.concatenate([[0], b + 1])
    lens = np.diff(np.concatenate([starts, [len(a)]]))
    return "".join(f"{l}{_OP_CHARS[a[s]]}" for s, l in zip(starts, lens))


def _compress_cigar(ops: Sequence[str]) -> str:
    out: List[List] = []
    for op in ops:
        if out and out[-1][1] == op:
            out[-1][0] += 1
        else:
            out.append([1, op])
    return "".join(f"{n}{o}" for n, o in out)


def affine_semiglobal(query: np.ndarray, ref: np.ndarray, sub: np.ndarray,
                      open_p: int, ext_p: int
                      ) -> Tuple[int, int, int, List[str]]:
    """Affine-gap DP: query prefix vs ref prefix, free ends (best cell
    anywhere). Returns (score, q_end, r_end, ops). Small host routine used
    for CIGAR reconstruction on the winning path."""
    Lq, Lr = len(query), len(ref)
    H = np.full((Lr + 1, Lq + 1), NEG, np.int64)
    I = np.full_like(H, NEG)   # gap in ref (consumes query)
    D = np.full_like(H, NEG)   # gap in query (consumes ref)
    H[0, 0] = 0
    for j in range(1, Lq + 1):
        I[0, j] = -open_p - (j - 1) * ext_p
        H[0, j] = I[0, j]
    for t in range(1, Lr + 1):
        D[t, 0] = max(H[t - 1, 0] - open_p, D[t - 1, 0] - ext_p)
        H[t, 0] = D[t, 0]
        subs = sub[query, ref[t - 1]]
        for j in range(1, Lq + 1):
            D[t, j] = max(H[t - 1, j] - open_p, D[t - 1, j] - ext_p)
            I[t, j] = max(H[t, j - 1] - open_p, I[t, j - 1] - ext_p)
            H[t, j] = max(H[t - 1, j - 1] + subs[j - 1], D[t, j], I[t, j])
    t, j = np.unravel_index(np.argmax(H), H.shape)
    best = int(H[t, j])
    ops: List[str] = []
    while t > 0 or j > 0:
        if t > 0 and j > 0 and H[t, j] == H[t - 1, j - 1] \
                + sub[query[j - 1], ref[t - 1]]:
            ops.append("=" if query[j - 1] == ref[t - 1] else "X")
            t -= 1
            j -= 1
        elif t > 0 and H[t, j] == D[t, j]:
            while t > 0 and D[t, j] == D[t - 1, j] - ext_p:
                ops.append("D")
                t -= 1
            ops.append("D")
            t -= 1
        elif j > 0:
            if H[t, j] == I[t, j]:
                while j > 0 and I[t, j] == I[t, j - 1] - ext_p:
                    ops.append("I")
                    j -= 1
            ops.append("I")
            j -= 1
        else:
            ops.append("D")
            t -= 1
    return best, int(np.unravel_index(np.argmax(H), H.shape)[1]), int(
        np.unravel_index(np.argmax(H), H.shape)[0]), ops[::-1]


def batch_align_scores_reference(queries, refs, qlens, rlens,
                                 match=2, tpen=3, tvpen=3, open_p=5,
                                 ext_p=2) -> np.ndarray:
    """(R,) best semi-global affine scores of R (query, ref) code pairs:
    the numpy gold of the device DP (``batch_extender.batched_ends``)."""
    cfg = AlignerConfig(match_score=match, mm_transition_penalty=tpen,
                        mm_transversion_penalty=tvpen,
                        gap_opening_penalty=open_p,
                        gap_extension_penalty=ext_p)
    sub = cfg.score_matrix()
    out = []
    for i in range(len(queries)):
        q = np.asarray(queries[i][:qlens[i]], np.int32)
        r = np.asarray(refs[i][:rlens[i]], np.int32)
        out.append(affine_semiglobal(q, r, sub, open_p, ext_p)[0])
    return np.array(out)


class Aligner:
    """Seed & extend against a DbgSuccinct (reference DBGAligner,
    dbg_aligner.hpp:60-215)."""

    def __init__(self, graph, config: Optional[AlignerConfig] = None):
        self.graph = graph
        self.config = config or AlignerConfig()
        self.sub = self.config.score_matrix(graph.alphabet)
        # non-DNA scoring (BLOSUM62 / unit): the device DP gathers from
        # the matrix, passed as a static tuple-of-tuples so each distinct
        # matrix compiles once (aligner_config.cpp:97-129 parity)
        self._sub_tt = (tuple(tuple(int(v) for v in row) for row in self.sub)
                        if self.config.uses_table_scoring(graph.alphabet)
                        else None)
        self.max_seeds_per_read = self.config.max_seeds_per_read
        # per-code exact-match scores (BLOSUM62's diagonal varies by
        # letter; for DNA this is just match_score everywhere)
        self._diag = np.diagonal(self.sub).astype(np.int64)
        self._tbl = graph.alphabet.encode_table()
        self._adj = {}          # lazy per-direction adjacency cache

    def _adjacency_table(self, backward: bool):
        """(N+1, sigma-1) int32 node table for one walk direction, built
        lazily per direction in node-range chunks (bounds the transient
        device memory of the sweep): each beam step then costs ONE
        gather instead of sigma-1 rank/select edge searches. Skipped
        when the table would exceed ~512 MB (the scan falls back to
        on-the-fly lookups)."""
        if backward not in self._adj:
            import jax.numpy as jnp
            g = self.graph
            N = int(g.num_nodes())
            sig1 = g.alphabet.size - 1
            if (N + 1) * sig1 * 4 > (512 << 20):
                self._adj[backward] = None
            else:
                fn = g.predecessors if backward else g.successors
                chunk = 1 << 22
                parts = []
                for lo in range(0, N + 1, chunk):
                    n = min(chunk, N + 1 - lo)
                    nodes = jnp.arange(lo, lo + n, dtype=jnp.int32)
                    parts.append(np.asarray(fn(nodes), dtype=np.int32))
                self._adj[backward] = jnp.asarray(np.concatenate(parts))
        return self._adj[backward]

    # -- seeding -----------------------------------------------------------

    def _exact_runs(self, nodes: np.ndarray) -> List[Tuple[int, int]]:
        """Maximal runs [start, end) of consecutive present windows
        (vectorized edge detection, no per-window Python)."""
        present = np.asarray(nodes) > 0
        if not present.size:
            return []
        d = np.diff(present.astype(np.int8))
        starts = np.nonzero(d == 1)[0] + 1
        ends = np.nonzero(d == -1)[0] + 1
        if present[0]:
            starts = np.concatenate([[0], starts])
        if present[-1]:
            ends = np.concatenate([ends, [present.size]])
        return list(zip(starts.tolist(), ends.tolist()))

    def _suffix_seeds(self, codes: np.ndarray, max_seeds: int = 0
                      ) -> Tuple[List[int], int]:
        """Seeds shorter than k (reference SuffixSeeder,
        aligner_seeder_methods.hpp:16-120): nodes whose k-mer *suffix*
        equals the longest possible query prefix. Node suffixes are
        contiguous ranges of the BOSS sort order (the suffix chars are
        the most significant comparison fields), so each probe is one
        batched binary search."""
        import jax.numpy as jnp
        from ..common import packed as pk
        if not max_seeds:
            max_seeds = self.config.max_seeds_per_locus
        g = self.graph
        K = g.k
        B = g.alphabet.bits_per_char
        lanes_all = g.boss.edge_lanes
        cfg = self.config
        min_len = max(cfg.min_seed_length or 1, 1)
        for s in range(min(K - 1, len(codes)), min_len - 1, -1):
            pattern = codes[:s]
            if (pattern == 0).any():
                continue
            if lanes_all is not None:
                L = lanes_all.shape[0]
                lo = jnp.zeros((L, 1), pk.LANE_DTYPE)
                # pattern char j sits at field K-s+j (suffix of the node)
                for j in range(s):
                    lo = pk.set_field(
                        lo, K - s + j,
                        jnp.full((1,), int(pattern[j]), jnp.uint32), B)
                # exclusive upper bound: +1 at the least significant
                # constrained field (carry-free: field values <= alph size)
                unit = pk.set_field(jnp.zeros((L, 1), pk.LANE_DTYPE), K - s,
                                    jnp.ones((1,), jnp.uint32), B)
                hi = lo + unit
                lo_i = int(pk.searchsorted(lanes_all, lo, side="left")[0]) + 1
                hi_i = int(pk.searchsorted(lanes_all, hi, side="left")[0])
            else:
                # small state: rank/select range tightening (the
                # reference's partial index_range, boss.hpp:694-740)
                ok, rl, ru = g.boss.suffix_range_ranksel(
                    jnp.asarray(pattern.astype(np.int32)))
                if not bool(ok):
                    continue
                lo_i, hi_i = int(rl), int(ru)
            if hi_i >= lo_i:
                rows = np.arange(lo_i, min(hi_i + 1, lo_i + 4 * max_seeds))
                nodes = np.asarray(g.edge_to_node(jnp.asarray(rows)))
                nodes = nodes[nodes > 0][:max_seeds]
                if len(nodes):
                    return [int(x) for x in nodes], s
        return [], 0

    # -- top level ---------------------------------------------------------

    def align(self, sequence: bytes, num_alternative_paths: int = 1,
              both_strands: bool = False) -> List[GraphAlignment]:
        """Forward-only by default (the reference aligns the reverse
        complement only under --align-both-strands, dbg_aligner.hpp:160;
        canonical graphs contain both orientations so forward search
        already covers them)."""
        # one extension engine: the single-read path IS a batch of one
        return self.align_batch(
            [sequence], both_strands=both_strands,
            num_alternative_paths=num_alternative_paths)[0]

    def align_batch(self, seqs: Sequence[bytes],
                    both_strands: bool = False,
                    num_alternative_paths: int = 1,
                    with_cigar: bool = True
                    ) -> List[List[GraphAlignment]]:
        """Batched alignment (reference DBGAligner::align_batch,
        dbg_aligner.hpp:160): seeding, beam extension and CIGAR DP all
        run batched on device via align/batch_extender.py — no per-read
        Python DP. Falls back to the per-read path only for reads that
        need suffix seeding.

        ``with_cigar=False`` is the score-only fast path (query --align /
        server align: only the path spelling is consumed): alignment ends
        come from the device full DP + argmax (``batched_ends``) with no
        (B, LR, LQ) matrix transfer; the min_exact_match filter then uses
        the exact lower bound score/match_score <= num_matches (every
        non-match op scores <= 0), so it only ever keeps a subset of the
        CIGAR path's results."""
        from .batch_extender import batched_cigars, beam_extend_batch
        orientations = [(False, list(seqs))]
        if both_strands:
            orientations.append((True, [_revcomp(s) for s in seqs]))
        per_read: List[List[GraphAlignment]] = [[] for _ in seqs]
        for orientation, oseqs in orientations:
            results = self._align_batch_oriented(oseqs, orientation,
                                                 beam_extend_batch,
                                                 batched_cigars,
                                                 with_cigar=with_cigar)
            for i, r in enumerate(results):
                per_read[i].extend(r)
        out = []
        match = max(self.config.match_score, 1)
        for i, rs in enumerate(per_read):
            n = max(len(seqs[i]), 1)
            if with_cigar:
                rs = [a for a in rs
                      if a.num_matches >= self.config.min_exact_match * n]
            else:
                rs = [a for a in rs
                      if a.score / match >= self.config.min_exact_match * n]
            rs.sort(key=lambda a: -a.score)
            # alternative seeds can converge on the same alignment: dedupe
            seen, uniq = set(), []
            for a in rs:
                key = (a.query_begin, a.query_end, a.cigar, a.orientation,
                       tuple(a.nodes))
                if key not in seen:
                    seen.add(key)
                    uniq.append(a)
            out.append(uniq[:num_alternative_paths])
        return out

    def _align_batch_oriented(self, seqs, orientation, beam_extend_batch,
                              batched_cigars, with_cigar: bool = True):
        g = self.graph
        k = g.k
        cfg = self.config
        B = len(seqs)
        results: List[List[GraphAlignment]] = [[] for _ in range(B)]
        # 1) batched seeding: ONE device dispatch maps every read's
        # windows (reads concatenated with separators)
        codes_l, runs_l = [], []
        for s in seqs:
            codes = self._tbl[np.frombuffer(s, np.uint8)].astype(np.int32)
            codes_l.append(np.where(codes == 255, 0, codes))
        nodes_l = _map_batch_nodes(g, seqs)
        seeded = []
        for i, s in enumerate(seqs):
            if len(s) < k:
                runs_l.append([])
                continue
            nodes = nodes_l[i]
            runs = self._exact_runs(nodes)
            runs_l.append(runs)
            if runs:
                # extend every seed, not just the longest (the reference
                # extends all seeds and keeps the top-N alignments,
                # dbg_aligner.cpp align_core); cap at max_seeds_per_read
                # anchors ranked by run length
                runs.sort(key=lambda r: (r[1] - r[0]), reverse=True)
                for run in runs[:self.max_seeds_per_read]:
                    seeded.append((i, nodes, run))
        # reads without full-k seeds: suffix-seeded (sub-k anchors), all
        # candidates extended in ONE device batch — no per-read DP
        fb_entries = []
        for i, s in enumerate(seqs):
            if len(s) >= k and runs_l[i]:
                continue
            cand, s_len = self._suffix_seeds(codes_l[i])
            # every candidate is one batch row; candidates come in BOSS
            # row order, not ranked, so none may be dropped a priori
            for node in cand:
                fb_entries.append((i, node, s_len))
        if fb_entries:
            self._extend_suffix_seeded(seqs, codes_l, fb_entries,
                                       orientation, results,
                                       beam_extend_batch, batched_cigars,
                                       with_cigar)
        if not seeded:
            return results
        # 2) batched forward + backward beam extension
        Lmax = max(len(seqs[i]) for i, _, _ in seeded)
        nb = len(seeded)
        fwd_tails = np.zeros((nb, Lmax), np.int32)
        fwd_lens = np.zeros(nb, np.int32)
        fwd_start = np.zeros(nb, np.int32)
        bwd_tails = np.zeros((nb, Lmax), np.int32)
        bwd_lens = np.zeros(nb, np.int32)
        bwd_start = np.zeros(nb, np.int32)
        seed_info = []
        for bi, (i, nodes, (rs, re)) in enumerate(seeded):
            if self.config.max_seed_length:
                # reference --align-max-seed-length: clamp the anchor
                re = min(re, rs + max(self.config.max_seed_length
                                      - (k - 1), 1))
            seed_len = (re - rs) + k - 1
            qb, qe = rs, rs + seed_len
            fwd = codes_l[i][qe:]
            bwd = codes_l[i][:qb][::-1]
            fwd_tails[bi, :len(fwd)] = fwd
            fwd_lens[bi] = len(fwd)
            fwd_start[bi] = nodes[re - 1]
            bwd_tails[bi, :len(bwd)] = bwd
            bwd_lens[bi] = len(bwd)
            bwd_start[bi] = nodes[rs]
            seed_info.append((i, nodes, rs, re, seed_len, qb, qe))
        f_scores, f_chars, f_nodes = beam_extend_batch(
            g, fwd_start, fwd_tails, fwd_lens, cfg, beam=cfg.beam_width,
            backward=False, adj_tab=self._adjacency_table(False),
            sub_tt=self._sub_tt)
        b_scores, b_chars, b_nodes = beam_extend_batch(
            g, bwd_start, bwd_tails, bwd_lens, cfg, beam=cfg.beam_width,
            backward=True, adj_tab=self._adjacency_table(True),
            sub_tt=self._sub_tt)
        # 3) batched CIGAR recovery over the winning paths
        def pack(tails, lens, chars):
            LQ = tails.shape[1]
            LR = max([len(c) for c in chars] + [1])
            r = np.zeros((nb, LR), np.int32)
            rl = np.zeros(nb, np.int32)
            for bi, c in enumerate(chars):
                r[bi, :len(c)] = c
                rl[bi] = len(c)
            return tails, lens, r, rl
        fq, fql, fr, frl = pack(fwd_tails, fwd_lens, f_chars)
        bq, bql, br, brl = pack(bwd_tails, bwd_lens, b_chars)
        if with_cigar:
            f_cig = batched_cigars(fq, fr, fql, frl, self.sub,
                                   cfg.gap_opening_penalty,
                                   cfg.gap_extension_penalty,
                                   cfg.match_score,
                                   cfg.mm_transition_penalty,
                                   cfg.mm_transversion_penalty,
                                   sub_tt=self._sub_tt)
            b_cig = batched_cigars(bq, br, bql, brl, self.sub,
                                   cfg.gap_opening_penalty,
                                   cfg.gap_extension_penalty,
                                   cfg.match_score,
                                   cfg.mm_transition_penalty,
                                   cfg.mm_transversion_penalty,
                                   sub_tt=self._sub_tt)
        else:
            # score-only: device DP ends, no matrices, no traceback
            from .batch_extender import batched_ends
            fe = batched_ends(fq, fr, fql, frl, cfg.gap_opening_penalty,
                              cfg.gap_extension_penalty, cfg.match_score,
                              cfg.mm_transition_penalty,
                              cfg.mm_transversion_penalty,
                              sub_tt=self._sub_tt)
            be = batched_ends(bq, br, bql, brl, cfg.gap_opening_penalty,
                              cfg.gap_extension_penalty, cfg.match_score,
                              cfg.mm_transition_penalty,
                              cfg.mm_transversion_penalty,
                              sub_tt=self._sub_tt)
            f_cig = [(int(s), int(j), int(t), None) for s, t, j in fe]
            b_cig = [(int(s), int(j), int(t), None) for s, t, j in be]
        finals = []
        for bi, (i, nodes, rs, re, seed_len, qb, qe) in enumerate(seed_info):
            seq = seqs[i]
            score = int(self._diag[codes_l[i][qb:qe]].sum())
            ops = [np.full(seed_len, _EQ, np.int8)]
            parts = [np.asarray(nodes[rs:re], np.int64)]
            if fwd_lens[bi] and f_scores[bi] > 0:
                s2, q_end, r_end, dops = f_cig[bi]
                score += s2
                parts.append(np.asarray(f_nodes[bi][:r_end], np.int64))
                if dops is not None:
                    ops.append(dops)
                qe += q_end
            if bwd_lens[bi] and b_scores[bi] > 0:
                s2, q_end, r_end, dops = b_cig[bi]
                score += s2
                parts.insert(0, np.asarray(b_nodes[bi][:r_end],
                                           np.int64)[::-1])
                if dops is not None:
                    ops.insert(0, dops[::-1])
                qb -= q_end
            path = np.concatenate(parts) if len(parts) > 1 else parts[0]
            if with_cigar:
                cig = _compress_ops_codes(np.concatenate(ops))
            else:
                # aligned-span placeholder (consumers of the score-only
                # path read .sequence/.score, never the cigar)
                cig = f"{qe - qb}M"
            if qb > 0:
                cig = f"{qb}S" + cig
            if qe < len(seq):
                cig = cig + f"{len(seq) - qe}S"
            finals.append((i, score, cig, qb, qe, path))
        # 4) ONE device dispatch spells every winning path
        spells = self._spell_batch([f[5] for f in finals])
        for (i, score, cig, qb, qe, path), spelled in zip(finals, spells):
            results[i].append(GraphAlignment(
                score=int(score), cigar=cig, query_begin=qb, query_end=qe,
                sequence=spelled, nodes=path, orientation=orientation))
        return results

    def _extend_suffix_seeded(self, seqs, codes_l, entries, orientation,
                              results, beam_extend_batch, batched_cigars,
                              with_cigar: bool):
        """Batched forward extension of suffix-seeded reads: every
        (read, candidate-node) pair is one batch row; the best-scoring
        candidate per read is kept (the per-read equivalent is
        _align_from_partial_seed)."""
        cfg = self.config
        nb = len(entries)
        Lmax = max(len(seqs[i]) for i, _, _ in entries)
        tails = np.zeros((nb, Lmax), np.int32)
        lens = np.zeros(nb, np.int32)
        starts = np.zeros(nb, np.int32)
        for bi, (i, node, s_len) in enumerate(entries):
            fwd = codes_l[i][s_len:]
            tails[bi, :len(fwd)] = fwd
            lens[bi] = len(fwd)
            starts[bi] = node
        scores, chars_l, nodes_l = beam_extend_batch(
            self.graph, starts, tails, lens, cfg, beam=cfg.beam_width,
            backward=False, adj_tab=self._adjacency_table(False),
            sub_tt=self._sub_tt)
        LR = max([len(c) for c in chars_l] + [1])
        r = np.zeros((nb, LR), np.int32)
        rl = np.zeros(nb, np.int32)
        for bi, c in enumerate(chars_l):
            r[bi, :len(c)] = c
            rl[bi] = len(c)
        dp_args = (cfg.gap_opening_penalty, cfg.gap_extension_penalty,
                   cfg.match_score, cfg.mm_transition_penalty,
                   cfg.mm_transversion_penalty)
        if with_cigar:
            cig = batched_cigars(tails, r, lens, rl, self.sub, *dp_args,
                                 sub_tt=self._sub_tt)
        else:
            from .batch_extender import batched_ends
            e = batched_ends(tails, r, lens, rl, *dp_args,
                             sub_tt=self._sub_tt)
            cig = [(int(s), int(j), int(t), None) for s, t, j in e]
        finals = []
        for bi, (i, node, s_len) in enumerate(entries):
            seq = seqs[i]
            score = int(self._diag[codes_l[i][:s_len]].sum())
            ops = [np.full(s_len, _EQ, np.int8)]
            path = np.asarray([node], np.int64)
            qe = s_len
            if lens[bi] and scores[bi] > 0:
                s2, q_end, r_end, dops = cig[bi]
                score += s2
                path = np.concatenate([path,
                                       np.asarray(nodes_l[bi][:r_end],
                                                  np.int64)])
                if dops is not None:
                    ops.append(dops)
                qe += q_end
            cs = (_compress_ops_codes(np.concatenate(ops))
                  if with_cigar else f"{qe}M")
            if qe < len(seq):
                cs = cs + f"{len(seq) - qe}S"
            finals.append((i, score, cs, qe, path, s_len))
        spells = self._spell_batch([f[4] for f in finals])
        best_per_read = {}
        for (i, score, cs, qe, path, s_len), spelled in zip(finals, spells):
            a = GraphAlignment(
                score=int(score), cigar=cs, query_begin=0, query_end=qe,
                sequence=spelled[-(s_len + len(path) - 1):], nodes=path,
                orientation=orientation)
            cur = best_per_read.get(i)
            if cur is None or a.score > cur.score:
                best_per_read[i] = a
        for i, a in best_per_read.items():
            results[i].append(a)

    def _spell(self, path: List[int]) -> bytes:
        g = self.graph
        chars = g.node_kmers_chars(np.array(path, np.int64))
        letters = np.frombuffer(g.alphabet.letters.encode(), np.uint8)
        out = list(letters[chars[0]])
        for i in range(1, len(path)):
            out.append(letters[chars[i][-1]])
        return bytes(out)

    def _spell_batch(self, paths: Sequence[List[int]]) -> List[bytes]:
        """Spell many paths with one node_kmers_chars dispatch: concatenate
        all path nodes, decode once, slice back per path."""
        g = self.graph
        flat = np.concatenate(
            [np.asarray(p, np.int64) for p in paths if len(p)]
            or [np.zeros(0, np.int64)])
        if len(flat) == 0:
            return [b"" for _ in paths]
        # pad to a power-of-two bucket: compile per size class
        cap = max(64, 1 << (len(flat) - 1).bit_length())
        padded = np.concatenate([flat, np.ones(cap - len(flat), np.int64)])
        chars = g.node_kmers_chars(padded)
        letters = np.frombuffer(g.alphabet.letters.encode(), np.uint8)
        out, off = [], 0
        for p in paths:
            if not len(p):
                out.append(b"")
                continue
            c = chars[off:off + len(p)]
            off += len(p)
            out.append(bytes(letters[c[0]]) + bytes(letters[c[1:, -1]]))
        return out


def _map_batch_nodes(g, seqs: Sequence[bytes]) -> List[np.ndarray]:
    """Map every read's k-mer windows to node ids in ONE device dispatch:
    reads are concatenated with INVALID separators (windows spanning a
    boundary are invalid by window_validity), mapped once, and sliced back
    per read. Each window maps to the node of its own orientation: on a
    canonical DbgSuccinct that differs from g.map_to_nodes(s), which maps
    to the node of the canonical form (the other strand for half the
    windows); a CanonicalDbg wrapper already maps oriented."""
    from ..graph.dbg_succinct import MODE_BASIC, MODE_CANONICAL, DbgSuccinct
    from ..kmer.alphabets import INVALID_CODE
    from ..kmer.extractor import encode_sequences
    import jax.numpy as jnp
    k = g.k
    if isinstance(g, DbgSuccinct) and g.mode == MODE_CANONICAL:
        # alignments are oriented paths: a canonical graph stores both
        # orientations, so look each window up as it is
        g = replace(g, mode=MODE_BASIC)
    codes = encode_sequences(seqs, g.alphabet)       # trailing sep per read
    n = len(codes)
    if n < k:
        return [np.zeros(max(0, len(s) - k + 1), np.int32) for s in seqs]
    cap = max(64, 1 << (n - 1).bit_length())
    codes = np.concatenate([codes, np.full(cap - n, INVALID_CODE, np.uint8)])
    out = np.asarray(g.map_codes_to_nodes(jnp.asarray(codes)))
    nodes_l, off = [], 0
    for s in seqs:
        ln = len(s)
        nodes_l.append(out[off:off + max(0, ln - k + 1)].astype(np.int32)
                       if ln >= k else np.zeros(0, np.int32))
        off += ln + 1                                # +1 for the separator
    return nodes_l


_COMP = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")


def _revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]
