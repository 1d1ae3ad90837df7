"""The device alignment DP (``batch_extender.batched_ends``) against the
numpy gold DP (``aligner.batch_align_scores_reference`` and
``aligner.affine_semiglobal``)."""

import numpy as np
import pytest

from metagraph_tpu.align.aligner import (AlignerConfig, affine_semiglobal,
                                         batch_align_scores_reference)
from metagraph_tpu.align.batch_extender import batched_ends


def make_batch(rng, R, LQ, LR):
    qs = np.zeros((R, LQ), np.int32)
    rs = np.zeros((R, LR), np.int32)
    qlens = rng.integers(LQ // 2, LQ + 1, size=R)
    rlens = np.zeros(R, np.int64)
    for i in range(R):
        q = rng.integers(1, 5, size=qlens[i])
        r = list(q)
        for _ in range(rng.integers(0, 3)):          # substitutions
            p = rng.integers(0, len(r))
            r[p] = int(rng.integers(1, 5))
        if rng.random() < 0.5 and len(r) > 4:        # one indel
            p = rng.integers(1, len(r) - 1)
            if rng.random() < 0.5:
                r.insert(p, int(rng.integers(1, 5)))
            else:
                del r[p]
        r = r[:LR]
        qs[i, :qlens[i]] = q
        rs[i, :len(r)] = r
        rlens[i] = len(r)
    return qs, rs, qlens, rlens


def _ends(q, r, qlens, rlens, match=2, tpen=3, tvpen=3, open_p=5, ext_p=2):
    return batched_ends(q, r, np.asarray(qlens), np.asarray(rlens),
                        open_p=open_p, ext_p=ext_p, match=match,
                        tpen=tpen, tvpen=tvpen)


@pytest.mark.parametrize("R,LQ,LR", [(4, 16, 20), (10, 32, 32), (3, 8, 24)])
def test_device_dp_matches_gold(rng, R, LQ, LR):
    qs, rs, qlens, rlens = make_batch(rng, R, LQ, LR)
    got = _ends(qs, rs, qlens, rlens)[:, 0]
    want = batch_align_scores_reference(qs, rs, qlens, rlens)
    np.testing.assert_array_equal(got, want)


def test_exact_and_empty():
    q = np.array([[1, 2, 3, 4, 1, 2, 3, 4]], np.int32)
    assert _ends(q, q, [8], [8])[0, 0] == 16       # 8 matches * 2
    # empty ref -> best is the empty alignment (score 0 at origin)
    assert _ends(q, q, [8], [0])[0, 0] == 0


def test_scoring_params():
    # mid-sequence transition vs transversion (free ends can't clip it
    # out without losing more matches)
    q = np.array([[1, 1, 2, 3, 4, 4]], np.int32)      # AACGTT
    r_ts = np.array([[1, 1, 4, 3, 4, 4]], np.int32)   # C->T transition
    r_tv = np.array([[1, 1, 1, 3, 4, 4]], np.int32)   # C->A transversion
    s_ts = _ends(q, r_ts, [6], [6], tpen=1, tvpen=5)[0, 0]
    s_tv = _ends(q, r_tv, [6], [6], tpen=1, tvpen=5)[0, 0]
    assert s_ts == 5 * 2 - 1        # five matches, one transition
    assert s_tv == 5 * 2 - 5        # fixed-origin semiglobal: mismatch paid
    want = batch_align_scores_reference(q, r_tv, [6], [6], tpen=1, tvpen=5)
    assert s_tv == want[0]


def test_ends_follow_gold_argmax(rng):
    """[score, r_end, q_end] equal the gold DP's best cell, with its
    row-major first-max tie rule."""
    B, LQ, LR = 6, 17, 21
    q = rng.integers(1, 5, (B, LQ)).astype(np.int32)
    r = rng.integers(1, 5, (B, LR)).astype(np.int32)
    r[0, :LQ] = q[0]
    qlens = rng.integers(3, LQ + 1, B).astype(np.int32)
    rlens = rng.integers(3, LR + 1, B).astype(np.int32)
    got = _ends(q, r, qlens, rlens)
    sub = AlignerConfig().score_matrix()
    for i in range(B):
        score, q_end, r_end, _ = affine_semiglobal(
            q[i, :qlens[i]], r[i, :rlens[i]], sub, 5, 2)
        assert list(got[i]) == [score, r_end, q_end], i
