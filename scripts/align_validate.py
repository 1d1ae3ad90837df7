"""Beam-width validation: does beam=8 miss alignments?

Aligns mutated reads at the production beam width and at an effectively
exhaustive width, and reports the fraction of reads where the narrow
beam returns a lower-scoring alignment.

Usage: python scripts/align_validate.py [n_reads=1000] [beam=8] [wide=64]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
BEAM = int(sys.argv[2]) if len(sys.argv) > 2 else 8
WIDE = int(sys.argv[3]) if len(sys.argv) > 3 else 64


def mutate(rng, read: bytes) -> bytes:
    """2 substitutions + 1 single-base indel per 100bp read."""
    sub = {65: 67, 67: 71, 71: 84, 84: 65}
    r = bytearray(read)
    for _ in range(2):
        p = rng.integers(5, len(r) - 5)
        r[p] = sub[r[p]]
    p = rng.integers(10, len(r) - 10)
    if rng.random() < 0.5:
        del r[p]
    else:
        r.insert(p, rng.choice([65, 67, 71, 84]))
    return bytes(r)


def main():
    from metagraph_tpu.align.aligner import Aligner, AlignerConfig
    from metagraph_tpu.graph.boss_construct import build_boss
    from metagraph_tpu.graph.dbg_succinct import DbgSuccinct
    from metagraph_tpu.kmer.alphabets import DNA

    rng = np.random.default_rng(0)
    letters = np.frombuffer(b"ACGT", np.uint8)
    seqs = [bytes(letters[rng.integers(0, 4, 2000)]) for _ in range(20)]
    k = 15
    g = DbgSuccinct.from_boss(build_boss(seqs, k), DNA, "basic")
    reads = []
    for _ in range(N):
        s = seqs[rng.integers(0, len(seqs))]
        p = rng.integers(0, len(s) - 100)
        reads.append(mutate(rng, s[p:p + 100]))

    def run(beam):
        al = Aligner(g, AlignerConfig(beam_width=beam))
        t0 = time.time()
        res = al.align_batch(reads, with_cigar=False)
        dt = time.time() - t0
        scores = np.array([r[0].score if r else -10**9 for r in res])
        return scores, dt

    s_narrow, t_narrow = run(BEAM)
    s_wide, t_wide = run(WIDE)
    missed = int((s_narrow < s_wide).sum())
    better = int((s_narrow > s_wide).sum())
    print(f"reads={N} beam={BEAM} vs wide={WIDE}: "
          f"missed(higher score exists)={missed} ({100*missed/N:.2f}%), "
          f"narrow_better={better}, "
          f"time {t_narrow:.1f}s vs {t_wide:.1f}s", flush=True)
    aligned = int((s_narrow > -10**9).sum())
    print(f"aligned {aligned}/{N} at beam={BEAM}", flush=True)


if __name__ == "__main__":
    main()
