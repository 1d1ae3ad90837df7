"""Batched device beam-search extension for the aligner.

The reference extends each seed with a per-read column DP over a graph
BFS (DefaultColumnExtender, aligner_extender_methods.hpp:43-119) and
batches only across threads (DBGAligner::align_batch, dbg_aligner.hpp:160).
Here the whole read batch extends in lockstep on the device:

  * state: (B reads x W beam entries) DP columns H/D of width LQ+1 —
    dense VPU math for every candidate in parallel;
  * per step: ONE batched successor lookup for all B*W frontier nodes,
    a vectorized affine-DP column update for all B*W*4 candidate edges,
    and a per-read top-W selection (lax.top_k) with x-drop pruning;
  * the whole walk is one `lax.scan` that also records per-step
    (parent beam, character) choices, so the winning path is recovered
    with an O(steps) vectorized host traceback — no per-read Python DP;
  * CIGARs come from one batched full-DP (device) over (tail, winning
    path spelling) pairs plus an O(L) host argmax walk per read.

This replaces the round-1 per-read Python beam search
(align/aligner.py:_search) on the batch path.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(10 ** 8)


def _cap(n: int, lo: int) -> int:
    """Power-of-two size class (bounds the number of compiled shapes)."""
    return max(lo, 1 << (max(int(n), 1) - 1).bit_length())


def _cap_lin(n: int, step: int, lo: int) -> int:
    """Multiple-of-`step` size class. Power-of-two classes waste up to 2x
    work on the scan-length-dominated beam DP (a 69-char tail padded to
    128 columns runs 128/69 the columns AND 160/86 the steps); linear
    classes cost a few more compiles (bounded: reads are <= a few hundred
    bp) and cut the padded volume to <= (1 + step/n)."""
    n = max(int(n), lo)
    return ((n + step - 1) // step) * step


def _pad_pairs(q, r, qlens, rlens):
    """Pad (B, LQ)/(B, LR) pair arrays to bounded shape classes."""
    B, LQ = q.shape
    LR = r.shape[1]
    Bp, LQp, LRp = _cap(B, 8), _cap_lin(LQ, 16, 16), _cap_lin(LR, 16, 16)
    qp = np.zeros((Bp, LQp), np.int32)
    qp[:B, :LQ] = q
    rp = np.zeros((Bp, LRp), np.int32)
    rp[:B, :LR] = r
    qlp = np.zeros(Bp, np.int32)
    qlp[:B] = qlens
    rlp = np.zeros(Bp, np.int32)
    rlp[:B] = rlens
    return qp, rp, qlp, rlp


def _subst(q, c, match, tpen, tvpen, dtype=jnp.int32, sub_tt=None):
    """Substitution scores. DNA default: arithmetic transition/
    transversion formula (codes 1-4; |q-c|==2 <=> A<->G / C<->T).
    ``sub_tt`` (static tuple-of-tuples) switches to table scoring for
    BLOSUM62 / unit matrices (reference aligner_config.cpp:97-129)."""
    if sub_tt is not None:
        tab = jnp.asarray(np.asarray(sub_tt, np.int32), dtype)
        return tab[q, jnp.broadcast_to(c, jnp.broadcast_shapes(
            q.shape, c.shape))]
    diff = jnp.abs(q - c)
    s = jnp.where(diff == 0, jnp.asarray(match, dtype),
                  jnp.where(diff == 2, jnp.asarray(-tpen, dtype),
                            jnp.asarray(-tvpen, dtype)))
    return jnp.where((q == 0) | (c == 0), jnp.asarray(-tvpen, dtype), s)


def _neg(dtype):
    """-inf sentinel that fits the DP dtype."""
    return NEG if dtype == jnp.int32 else -20000


def _prefix_max(x):
    n = x.shape[-1]
    neg = _neg(x.dtype)
    s = 1
    while s < n:
        pad = jnp.full(x.shape[:-1] + (s,), neg, x.dtype)
        x = jnp.maximum(x, jnp.concatenate([pad, x[..., :-s]], axis=-1))
        s *= 2
    return x


def _column_update(H, D, q, c, jj, match, tpen, tvpen, open_p, ext_p,
                   with_insertions: bool = True, sub_tt=None):
    """One DP column step. H, D: (..., LQ+1); q: (..., LQ); c: (..., 1).
    Returns (Hn, Dn, I). Runs in H's dtype (int16 for short tails in the
    beam scan: the candidate-column updates are memory-bound)."""
    dtype = H.dtype
    subs = _subst(q, c, match, tpen, tvpen, dtype, sub_tt)
    Dn = jnp.maximum(H - jnp.asarray(open_p, dtype),
                     D - jnp.asarray(ext_p, dtype))
    diag = H[..., :-1] + subs
    # broadcast Dn over any extra candidate axes introduced by subs
    Dn = jnp.broadcast_to(Dn, diag.shape[:-1] + (Dn.shape[-1],))
    Hn = jnp.concatenate([Dn[..., :1], jnp.maximum(diag, Dn[..., 1:])],
                         axis=-1)
    aug = Hn + (jj * ext_p).astype(dtype)
    run = _prefix_max(aug)
    pad = jnp.full(Hn.shape[:-1] + (1,), _neg(dtype), dtype)
    I = jnp.concatenate([pad, run[..., :-1]], axis=-1) \
        - (jj * ext_p).astype(dtype) - jnp.asarray(open_p - ext_p, dtype)
    return jnp.maximum(Hn, I), Dn, I


@functools.partial(jax.jit, static_argnames=(
    "steps", "beam", "match", "tpen", "tvpen", "open_p", "ext_p", "xdrop",
    "backward", "min_cell", "sub_tt", "sigma"))
def _beam_scan(graph, start_nodes, tails, tlens, steps, beam,
               match, tpen, tvpen, open_p, ext_p, xdrop, backward,
               adj_tab=None, min_cell=NEG, sub_tt=None, sigma=5):
    """Run the batched beam extension.

    Returns (best (B,), best_step (B,), best_beam (B,),
             parents (steps, B, W) int32, chars (steps, B, W) int32,
             nodes_hist (steps, B, W) int32).
    """
    B, LQ = tails.shape
    W = beam
    S = sigma - 1  # successors per node (4 for DNA, 26 for Protein)
    # int32 DP columns: int16 was slower on a TPU despite the traffic
    # cut (sub-word elements pay pack/unpack on every op); not yet
    # measured on the H100
    dtype = jnp.int32
    negd = _neg(dtype)
    jj = jnp.arange(LQ + 1, dtype=jnp.int32)
    j_valid = jj[None, :] <= tlens[:, None]          # (B, LQ+1)
    H0 = jnp.where(jj[None, :] == 0, 0,
                   -open_p - (jj[None, :] - 1) * ext_p)
    H0 = jnp.where(j_valid, H0, negd).astype(dtype)
    # beam slot 0 holds the seed column; others start dead
    H = jnp.full((B, W, LQ + 1), negd, dtype).at[:, 0, :].set(H0)
    D = jnp.full((B, W, LQ + 1), negd, dtype)
    node = jnp.zeros((B, W), jnp.int32).at[:, 0].set(start_nodes)
    alive = jnp.zeros((B, W), bool).at[:, 0].set(start_nodes > 0)
    best0 = jnp.where(start_nodes > 0, 0, NEG).astype(jnp.int32)

    q_codes = tails.astype(jnp.int32)

    def step(carry, t):
        H, D, node, alive, best, best_step, best_beam = carry
        flat_nodes = node.reshape(-1)
        if adj_tab is not None:
            # cached adjacency: ONE gather per step instead of sigma-1
            # rank/select edge searches (the walk's dominant cost)
            adj = adj_tab[flat_nodes]
        else:
            adj = (graph.predecessors(flat_nodes) if backward
                   else graph.successors(flat_nodes))
        succ = adj.reshape(B, W, S)
        # candidate columns: (B, W, S, LQ+1)
        He = H[:, :, None, :]
        De = D[:, :, None, :]
        c = jnp.arange(1, S + 1, dtype=jnp.int32)[None, None, :, None]
        qb = q_codes[:, None, None, :]
        Hn, Dn, _ = _column_update(He, De, qb, c, jj[None, None, None, :],
                                   match, tpen, tvpen, open_p, ext_p,
                                   sub_tt=sub_tt)
        Hn = jnp.where(j_valid[:, None, None, :], Hn, negd)
        valid = alive[:, :, None] & (succ > 0)
        colmax = jnp.max(Hn, axis=-1).astype(jnp.int32)
        # dead-slot sentinel in int32 space for x-drop/top-k bookkeeping
        colmax = jnp.where(valid, colmax, NEG)                # (B, W, S)
        flat_score = colmax.reshape(B, W * S)
        top_score, top_idx = jax.lax.top_k(flat_score, W)     # (B, W)
        pw = top_idx // S
        pc = top_idx % S + 1
        bidx = jnp.arange(B, dtype=jnp.int32)[:, None]
        Hn2 = Hn.reshape(B, W * S, LQ + 1)[bidx, top_idx]
        Dn2 = Dn.reshape(B, W * S, LQ + 1)[bidx, top_idx]
        node2 = succ.reshape(B, W * S)[bidx, top_idx]
        # best update + x-drop
        step_best = top_score[:, 0]
        improved = step_best > best
        best = jnp.maximum(best, step_best)
        best_step = jnp.where(improved, t, best_step)
        best_beam = jnp.where(improved, 0, best_beam)
        alive2 = (top_score > NEG // 2) & (top_score >= (best[:, None]
                                                         - xdrop))
        if min_cell > NEG:        # reference --align-min-cell-score
            alive2 &= top_score >= min_cell
        return ((Hn2, Dn2, node2, alive2, best, best_step, best_beam),
                (pw.astype(jnp.int32), pc.astype(jnp.int32),
                 node2.astype(jnp.int32)))

    init = (H, D, node, alive, best0,
            jnp.full((B,), -1, jnp.int32), jnp.zeros((B,), jnp.int32))
    (Hf, Df, nodef, alivef, best, best_step, best_beam), hist = \
        jax.lax.scan(step, init, jnp.arange(steps, dtype=jnp.int32))
    parents, chars, nodes_hist = hist
    return best, best_step, best_beam, parents, chars, nodes_hist


def beam_extend_batch(graph, start_nodes: np.ndarray, tails: np.ndarray,
                      tlens: np.ndarray, cfg, beam: int = 8,
                      backward: bool = False, adj_tab=None, sub_tt=None
                      ) -> Tuple[np.ndarray, List[np.ndarray],
                                 List[np.ndarray]]:
    """Extend every read's seed through the graph at once.

    Returns (best_scores (B,), per-read char-code paths,
    per-read node-id paths) — paths already truncated at the best step.

    The scan length follows the longest REAL tail (bucketed), and when
    the batch mixes short and long tails the short ones run in their own
    sub-batch with a proportionally shorter scan — walk steps are the
    dominant cost and most backward tails are short."""
    B = tails.shape[0]
    if B == 0:
        return np.zeros(0, np.int64), [], []
    max_ram = getattr(cfg, "max_ram_mb", None)
    if max_ram:
        # reference --align-max-ram: bound the live DP footprint. The
        # scan's big tensors are the (B, W, S, LQ+1) candidate columns
        # (x3 for H/D/I) in int32.
        LQ1 = tails.shape[1] + 1
        per_row = beam * 4 * LQ1 * 4 * 3
        cap = max(int(max_ram * 1e6 / per_row), 8)
        if B > cap:
            scores = np.zeros(B, np.int64)
            chars = [None] * B
            nodes = [None] * B
            for lo in range(0, B, cap):
                hi = min(lo + cap, B)
                s, c, n = beam_extend_batch(
                    graph, start_nodes[lo:hi], tails[lo:hi], tlens[lo:hi],
                    cfg, beam, backward, adj_tab, sub_tt)
                scores[lo:hi] = s
                for o in range(hi - lo):
                    chars[lo + o] = c[o]
                    nodes[lo + o] = n[o]
            return scores, chars, nodes
    SHORT = 32
    long_mask = np.asarray(tlens) > SHORT
    if B >= 32 and long_mask.any() and (~long_mask).sum() >= B // 4:
        scores = np.zeros(B, np.int64)
        chars: List[np.ndarray] = [None] * B
        nodes: List[np.ndarray] = [None] * B
        for idx in (np.nonzero(~long_mask)[0], np.nonzero(long_mask)[0]):
            if idx.size == 0:
                continue
            w = min(int(tlens[idx].max()) if idx.size else 1,
                    tails.shape[1])
            s, c, n = _beam_extend_group(
                graph, start_nodes[idx], tails[idx, :max(w, 1)],
                tlens[idx], cfg, beam, backward, adj_tab, sub_tt)
            for o, i in enumerate(idx):
                scores[i] = s[o]
                chars[i] = c[o]
                nodes[i] = n[o]
        return scores, chars, nodes
    return _beam_extend_group(graph, start_nodes, tails, tlens, cfg,
                              beam, backward, adj_tab, sub_tt)


def _beam_extend_group(graph, start_nodes, tails, tlens, cfg, beam,
                       backward, adj_tab=None, sub_tt=None):
    B, LQ = tails.shape
    # pad batch and query dims to power-of-two classes: every distinct
    # shape compiles once (persistent cache), not once per batch size;
    # the query dim follows the longest real tail, not the array width
    true_max = int(tlens.max()) if B else 1
    Bp = _cap(B, 8) if B < 128 else _cap_lin(B, 128, 128)
    LQp = _cap_lin(max(true_max, 1), 16, 16)
    LQp = min(LQp, _cap_lin(LQ, 16, 16))
    tails = tails[:, :LQp] if LQp < LQ else tails
    LQ = tails.shape[1]
    tails_p = np.zeros((Bp, LQp), tails.dtype)
    tails_p[:B, :LQ] = tails
    tlens_p = np.zeros(Bp, np.int32)
    tlens_p[:B] = tlens
    starts_p = np.ones(Bp, np.int32)           # node 1: any valid id
    starts_p[:B] = start_nodes
    # walk length: the true longest tail plus indel slack, rounded to a
    # compile class — NOT the padded column width (that alone ran 160
    # steps x 129 columns for a 69-char tail; this runs 96 x 80)
    steps = _cap_lin(true_max + max(4, true_max // 4), 16, 16)
    best, best_step, best_beam, parents, chars, nodes_hist = _beam_scan(
        graph, jnp.asarray(starts_p.astype(np.int32)),
        jnp.asarray(tails_p.astype(np.int32)),
        jnp.asarray(tlens_p.astype(np.int32)),
        steps=steps, beam=beam,
        match=cfg.match_score, tpen=cfg.mm_transition_penalty,
        tvpen=cfg.mm_transversion_penalty,
        open_p=cfg.gap_opening_penalty, ext_p=cfg.gap_extension_penalty,
        xdrop=cfg.xdrop, backward=backward, adj_tab=adj_tab,
        min_cell=(cfg.min_cell_score
                  if getattr(cfg, "min_cell_score", None) is not None
                  else NEG),
        sub_tt=sub_tt, sigma=graph.alphabet.size)
    # traceback ON DEVICE: the raw (steps, B, W) histories are ~11 MB a
    # scan — walking the parent pointers in a reverse scan ships only
    # the (B, steps) winning paths to the host
    out_chars_d, out_nodes_d = _traceback_scan(parents, chars, nodes_hist,
                                               best_step, best_beam)
    best = np.asarray(best)[:B]
    best_step = np.asarray(best_step)[:B]
    out_chars = np.asarray(out_chars_d)[:B]
    out_nodes = np.asarray(out_nodes_d)[:B]
    char_paths = [out_chars[b, :best_step[b] + 1] for b in range(B)]
    node_paths = [out_nodes[b, :best_step[b] + 1] for b in range(B)]
    return best.astype(np.int64), char_paths, node_paths


@jax.jit
def _traceback_scan(parents, chars, nodes_hist, best_step, best_beam):
    """(B, steps) winning char/node paths from the per-step (parent,
    char, node) histories, walked backward from each read's best step."""
    steps, B, W = parents.shape
    bidx = jnp.arange(B)

    def step(cur_beam, t):
        active = best_step >= t
        ch = jnp.where(active, chars[t, bidx, cur_beam], 0)
        nd = jnp.where(active, nodes_hist[t, bidx, cur_beam], 0)
        nxt = jnp.where(active, parents[t, bidx, cur_beam], cur_beam)
        return nxt, (ch, nd)

    _, (cs, ns) = jax.lax.scan(
        step, best_beam, jnp.arange(steps - 1, -1, -1, dtype=jnp.int32))
    return cs[::-1].T, ns[::-1].T


# ---------------------------------------------------------------------------
# batched full DP for CIGAR recovery
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=(
    "match", "tpen", "tvpen", "open_p", "ext_p", "sub_tt"))
def _full_dp(q, r, qlens, rlens, match, tpen, tvpen, open_p, ext_p,
             sub_tt=None):
    """(B, LR+1, LQ+1) H/D/I matrices of the affine semi-global DP —
    same semantics as aligner.affine_semiglobal, batched on device."""
    B, LQ = q.shape
    LR = r.shape[1]
    jj = jnp.arange(LQ + 1, dtype=jnp.int32)
    j_valid = jj[None, :] <= qlens[:, None]
    H0 = jnp.where(jj[None, :] == 0, 0,
                   -open_p - (jj[None, :] - 1) * ext_p)
    H0 = jnp.where(j_valid, H0, NEG).astype(jnp.int32)
    I0 = jnp.where(jj[None, :] == 0, NEG, H0).astype(jnp.int32)
    D0 = jnp.full((B, LQ + 1), NEG, jnp.int32)

    def step(carry, t):
        H, D = carry
        c = jax.lax.dynamic_slice_in_dim(r, t, 1, axis=1).astype(jnp.int32)
        Hn, Dn, In = _column_update(H, D, q.astype(jnp.int32), c,
                                    jj[None, :], match, tpen, tvpen,
                                    open_p, ext_p, sub_tt=sub_tt)
        Hn = jnp.where(j_valid, Hn, NEG)
        t_ok = (t < rlens)[:, None]
        Hn = jnp.where(t_ok, Hn, H)
        Dn = jnp.where(t_ok, Dn, D)
        In = jnp.where(t_ok, In, NEG)
        return (Hn, Dn), (Hn, Dn, In)

    (_, _), (Hs, Ds, Is) = jax.lax.scan(step, (H0, D0),
                                        jnp.arange(LR, dtype=jnp.int32))
    H = jnp.concatenate([H0[:, None, :], jnp.moveaxis(Hs, 0, 1)], axis=1)
    D = jnp.concatenate([D0[:, None, :], jnp.moveaxis(Ds, 0, 1)], axis=1)
    I0 = jnp.where(jj[None, :] == 0, NEG, H0)
    I = jnp.concatenate([I0[:, None, :], jnp.moveaxis(Is, 0, 1)], axis=1)
    return H, D, I


@functools.partial(jax.jit, static_argnames=(
    "match", "tpen", "tvpen", "open_p", "ext_p", "sub_tt"))
def _full_dp_ends(q, r, qlens, rlens, match, tpen, tvpen, open_p, ext_p,
                  sub_tt=None):
    """(B, 3) [score, r_end, q_end] via the XLA full DP + device argmax
    (row-major first-max, same tie rule as np.argmax)."""
    H, _, _ = _full_dp(q, r, qlens, rlens, match, tpen, tvpen,
                       open_p, ext_p, sub_tt)
    B, LRp, LQp = H.shape
    tt = jnp.arange(LRp, dtype=jnp.int32)[None, :, None]
    jjj = jnp.arange(LQp, dtype=jnp.int32)[None, None, :]
    mask = (tt <= rlens[:, None, None]) & (jjj <= qlens[:, None, None])
    Hm = jnp.where(mask, H, NEG)
    flat = Hm.reshape(B, -1)
    pos = jnp.argmax(flat, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(flat, pos[:, None], axis=1)[:, 0]
    return jnp.stack([best, pos // LQp, pos % LQp], axis=1)


@functools.partial(jax.jit, static_argnames=(
    "match", "tpen", "tvpen", "open_p", "ext_p", "sub_tt"))
def _dp_traceback(q, r, qlens, rlens, match, tpen, tvpen, open_p, ext_p,
                  sub_tt=None):
    """Device traceback: (B, 3) ends + (steps, B) op codes.

    Replays aligner.affine_semiglobal's host traceback as a per-read
    state machine inside one lax.scan (phase 0 = main, 1 = D-run,
    2 = I-run; op codes 0 none / 1 '=' / 2 'X' / 3 'D' / 4 'I'), so only
    ~(LQ+LR) bytes per read cross the wire instead of the three
    (B, LR, LQ) DP matrices. Bit-identical to the host walk (same branch
    order, same run semantics)."""
    H, D, I = _full_dp(q, r, qlens, rlens, match, tpen, tvpen,
                       open_p, ext_p, sub_tt)
    B, LRp1, LQp1 = H.shape
    tt = jnp.arange(LRp1, dtype=jnp.int32)[None, :, None]
    jjj = jnp.arange(LQp1, dtype=jnp.int32)[None, None, :]
    mask = (tt <= rlens[:, None, None]) & (jjj <= qlens[:, None, None])
    flatH = jnp.where(mask, H, NEG).reshape(B, -1)
    pos = jnp.argmax(flatH, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(flatH, pos[:, None], axis=1)[:, 0]
    t0 = pos // LQp1
    j0 = pos % LQp1
    ends = jnp.stack([best, t0, j0], axis=1)

    Hf = H.reshape(B, -1)
    Df = D.reshape(B, -1)
    If = I.reshape(B, -1)
    bidx = jnp.arange(B, dtype=jnp.int32)

    def cell(Mf, t, j):
        idx = jnp.clip(t, 0, LRp1 - 1) * LQp1 + jnp.clip(j, 0, LQp1 - 1)
        return jnp.take_along_axis(Mf, idx[:, None], axis=1)[:, 0]

    def qat(j):
        return jnp.take_along_axis(
            q, jnp.clip(j - 1, 0, q.shape[1] - 1)[:, None], axis=1)[:, 0]

    def rat(t):
        return jnp.take_along_axis(
            r, jnp.clip(t - 1, 0, r.shape[1] - 1)[:, None], axis=1)[:, 0]

    def subst(qc, rc):
        return _subst(qc, rc, match, tpen, tvpen, jnp.int32, sub_tt)

    def step(carry, _):
        t, j, phase = carry
        done = (t <= 0) & (j <= 0) & (phase == 0)
        Htj = cell(Hf, t, j)
        Hdg = cell(Hf, t - 1, j - 1)
        Dtj = cell(Df, t, j)
        Dup = cell(Df, t - 1, j)
        Itj = cell(If, t, j)
        Ile = cell(If, t, j - 1)
        qc, rc = qat(j).astype(jnp.int32), rat(t).astype(jnp.int32)
        main = (phase == 0) & ~done
        diag = main & (t > 0) & (j > 0) & (Htj == Hdg + subst(qc, rc))
        dment = main & ~diag & (t > 0) & (Htj == Dtj)
        iment = main & ~diag & ~dment & (j > 0)
        i_run = iment & (Htj == Itj)
        deg = main & ~diag & ~dment & ~iment        # t > 0, j == 0
        inD = (phase == 1) | dment
        inI = (phase == 2) | iment
        dcont = inD & (t > 0) & (Dtj == Dup - ext_p)
        icont = ((phase == 2) | i_run) & (j > 0) & (Itj == Ile - ext_p)
        op = jnp.where(diag, jnp.where(qc == rc, 1, 2),
                       jnp.where(inD | deg, 3, jnp.where(inI, 4, 0)))
        op = jnp.where(done, 0, op).astype(jnp.int8)
        t2 = jnp.where(~done & (diag | inD | deg), t - 1, t)
        j2 = jnp.where(~done & (diag | inI), j - 1, j)
        phase2 = jnp.where(dcont, 1, jnp.where(icont, 2, 0))
        phase2 = jnp.where(done, phase, phase2).astype(jnp.int32)
        return (t2, j2, phase2), op

    steps = LRp1 + LQp1 + 2
    (_, _, _), ops = jax.lax.scan(
        step, (t0, j0, jnp.zeros((B,), jnp.int32)),
        None, length=steps)
    return ends, ops                                  # ops: (steps, B)


def batched_ends(q: np.ndarray, r: np.ndarray, qlens: np.ndarray,
                 rlens: np.ndarray, open_p: int, ext_p: int, match: int,
                 tpen: int, tvpen: int, sub_tt=None) -> np.ndarray:
    """(B, 3) [score, r_end, q_end] — the score-only alignment engine.

    Runs the XLA full DP + device argmax (row-major first-max, the same
    tie rule as np.argmax); the scan advances all B pairs per ref step.
    ``aligner.batch_align_scores_reference`` is the numpy gold it is
    tested against."""
    B = len(q)
    if B == 0:
        return np.zeros((0, 3), np.int32)
    qp, rp, qlp, rlp = _pad_pairs(q, r, qlens, rlens)
    out = _full_dp_ends(jnp.asarray(qp), jnp.asarray(rp), jnp.asarray(qlp),
                        jnp.asarray(rlp), match=match, tpen=tpen,
                        tvpen=tvpen, open_p=open_p, ext_p=ext_p,
                        sub_tt=sub_tt)
    return np.asarray(out)[:B]


def batched_cigars(q: np.ndarray, r: np.ndarray, qlens: np.ndarray,
                   rlens: np.ndarray, sub: np.ndarray, open_p: int,
                   ext_p: int, match: int, tpen: int, tvpen: int,
                   sub_tt=None) -> List[Tuple[int, int, int, List[str]]]:
    """Batched (score, q_end, r_end, ops): the whole DP AND the traceback
    run on the device (_dp_traceback); only (steps, B) op codes and (B, 3)
    ends cross the wire — no (B, LR, LQ) matrix transfer. ``sub`` is kept
    for API compatibility (the device walk derives substitution scores
    arithmetically from the same penalties)."""
    B = len(q)
    if B == 0:
        return []
    qp, rp, qlp, rlp = _pad_pairs(q, r, qlens, rlens)
    ends_d, ops_d = _dp_traceback(jnp.asarray(qp), jnp.asarray(rp),
                                  jnp.asarray(qlp), jnp.asarray(rlp),
                                  match=match, tpen=tpen, tvpen=tvpen,
                                  open_p=open_p, ext_p=ext_p, sub_tt=sub_tt)
    ends = np.asarray(ends_d)
    ops_arr = np.asarray(ops_d)                       # (steps, B)
    out = []
    for b in range(B):
        col = ops_arr[:, b]
        nz = col[col != 0][::-1]                      # op CODES 1..4
        out.append((int(ends[b, 0]), int(ends[b, 2]), int(ends[b, 1]),
                    nz.astype(np.int8)))
    return out
