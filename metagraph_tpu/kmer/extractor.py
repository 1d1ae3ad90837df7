"""Sequence → packed k-mer extraction.

Device replacement for KmerExtractorBOSS::sequence_to_kmers
(reference: metagraph/src/kmer/kmer_extractor.hpp:62-98). The reference
walks each sequence with a rolling scalar update; we instead treat a whole
*batch* of concatenated sequences as one uint8 code tensor and compute all
windows at once:

  * validity: a window of length K is a real k-mer iff it contains no
    invalid/separator code — computed with one prefix sum;
  * packing: K gather+shift+or vector ops build the (L, N) lane tensor
    (the "rolling" recurrence is inherently sequential; K independent
    gathers are embarrassingly parallel and K is small);
  * suffix filtering for sharded builds (kmer_extractor.hpp:89) becomes a
    predicate on the packed fields, applied in the same compaction pass.

Sequences are concatenated with a single INVALID separator byte, so no
window straddles two sequences.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..common import packed
from . import packing
from .alphabets import Alphabet, INVALID_CODE


def encode_sequences(seqs: Sequence[bytes | str], alphabet: Alphabet) -> np.ndarray:
    """Host-side: concatenate sequences into one uint8 code array with
    INVALID separators between (and after) each sequence."""
    tbl = alphabet.encode_table()
    parts = []
    for s in seqs:
        if isinstance(s, str):
            s = s.encode()
        parts.append(tbl[np.frombuffer(s, np.uint8)])
        parts.append(np.array([INVALID_CODE], np.uint8))
    if not parts:
        return np.zeros((0,), np.uint8)
    return np.concatenate(parts)


def window_validity(codes: jax.Array, K: int) -> jax.Array:
    """(N-K+1,) bool: window i..i+K-1 contains only real character codes."""
    bad = (codes == INVALID_CODE) | (codes == 0)
    prefix = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(bad.astype(jnp.int32))])
    return (prefix[K:] - prefix[:-K]) == 0


def extract_packed_kmers(
    codes: jax.Array,
    K: int,
    B: int,
    suffix: Optional[Tuple[int, ...]] = None,
) -> Tuple[jax.Array, jax.Array]:
    """All valid K-windows of ``codes``, packed in BOSS field layout.

    Returns (lanes (L, N-K+1) PAD-compacted, count). If ``suffix`` is
    given (codes of the last ``len(suffix)`` *node* characters, i.e.
    e_{K-1-s+1}..e_{K-1}), only k-mers whose node suffix matches are kept —
    this is the k-mer-space sharding predicate (reference
    kmer_collector.hpp:46, KMerBOSS::match_suffix kmer_boss.hpp:108-113).
    """
    n = codes.shape[0]
    num_windows = n - K + 1
    assert num_windows >= 0, "input shorter than k"
    ok = window_validity(codes, K)
    # windows are contiguous slices, NOT gathers (a gather per window
    # char would multiply the memory traffic); lanes accumulate per slot
    # with no (K, N) field stack — see packing.pack_windows
    lanes = packing.pack_windows(codes, K, B)
    if suffix:
        s = len(suffix)
        # node chars e_{K-s}..e_{K-1} live in fields K-s..K-1
        for i, c in enumerate(suffix):
            off = (K - 1) if (K - s + i) == 0 else (K - s + i) - 1
            field = jax.lax.slice(codes, (off,), (off + num_windows,)) \
                .astype(jnp.uint32)
            ok = ok & (field == np.uint32(c))
    lanes, count, _ = packed.compact(lanes, ok, num_windows)
    return lanes, count
