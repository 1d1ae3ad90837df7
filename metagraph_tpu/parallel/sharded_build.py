"""Suffix-sharded BOSS construction.

The reference bounds build memory by partitioning the k-mer space on a
node-suffix of length s and running Σ^s passes, each emitting a chunk
that is later concatenated (cli/build.cpp:103-155,359-456;
kmer_extractor.hpp:89). The same partition is the device *distribution* axis
(SURVEY §2.9 P4): suffix buckets are contiguous ranges of the BOSS sort
order (the suffix chars are the most significant comparison fields), so

  * per-bucket sorted unique k-mer sets concatenate — in bucket colex
    order — directly into the globally sorted set;
  * on a device mesh each bucket lives on one device and k-mers are
    routed with one all_to_all (see parallel/distributed.py).

This module provides the host-driven pass loop (single chip, bounded
working set) and the chunk save/concatenate used by the CLI.
"""

from __future__ import annotations

import itertools
import os
from typing import List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..common import packed
from ..graph.boss import Boss
from ..graph.boss_construct import (build_boss_from_kmers, collect_kmers,
                                    MODE_BASIC, MODE_CANONICAL, MODE_PRIMARY)
from ..kmer.alphabets import Alphabet, DNA


def suffix_buckets(alphabet: Alphabet, suffix_len: int) -> List[Tuple[int, ...]]:
    """All real-char suffixes of the given length, in colex order — i.e.
    ordered by (last char, second-to-last char, ...), matching the BOSS
    comparison order so concatenated buckets are globally sorted."""
    chars = range(1, alphabet.size)
    combos = list(itertools.product(chars, repeat=suffix_len))
    combos.sort(key=lambda t: tuple(reversed(t)))
    return combos


def build_shard_kmers(
    seqs: Sequence[bytes],
    K: int,
    suffix: Tuple[int, ...],
    alphabet: Alphabet = DNA,
    canonical: bool = False,
):
    """Collect the sorted unique k-mers of one suffix bucket."""
    real, counts, n = collect_kmers(seqs, K, alphabet, canonical=canonical,
                                    suffix=suffix)
    return real[:, :n], counts[:n], n


def build_boss_sharded(
    seqs: Sequence[bytes],
    k: int,
    alphabet: Alphabet = DNA,
    mode: str = MODE_BASIC,
    bits_per_count: int = 0,
    suffix_len: int = 1,
    chunk_dir: Optional[str] = None,
) -> Boss:
    """Σ^suffix_len passes over the input; each pass keeps only its
    bucket's k-mers, so the peak working set shrinks by ~Σ^suffix_len.
    Bucket outputs concatenate into the globally sorted real k-mer set,
    then dummy generation and emit run once (they are cheap relative to
    collection)."""
    canonical = mode in (MODE_CANONICAL, MODE_PRIMARY)
    # cheap input fingerprint: resume must not fold in chunks from a
    # different input set or build mode
    input_fp = (len(seqs) * 1000003 + sum(len(s) for s in seqs)) \
        % (1 << 62) ^ (k << 8) ^ int(canonical)
    parts = []
    cparts = []
    total = 0
    for suffix in suffix_buckets(alphabet, suffix_len):
        path = None
        if chunk_dir:
            os.makedirs(chunk_dir, exist_ok=True)
            name = "".join(alphabet.letters[c] for c in suffix)
            path = os.path.join(chunk_dir, f"chunk_{name}.npz")
        if path and os.path.exists(path):
            # mid-build resume: a finished pass is its own checkpoint
            # (the reference restarts from .dbg.chunk files the same way,
            # build.cpp concatenate path); only chunks stamped with the
            # same input fingerprint + mode are trusted
            with np.load(path) as d:
                if (int(d["k"]) == k and str(d["alphabet"]) == alphabet.name
                        and "input_fp" in d
                        and int(d["input_fp"]) == input_fp):
                    counts_np = d["counts"]
                    n = int((counts_np > 0).sum())
                    parts.append(jnp.asarray(d["lanes"][:, :n]))
                    cparts.append(jnp.asarray(counts_np[:n]))
                    total += n
                    continue
        lanes, counts, n = build_shard_kmers(seqs, k, suffix, alphabet,
                                             canonical=canonical)
        if path:
            save_chunk(path, lanes, counts, k, alphabet.name, suffix,
                       canonical=canonical, input_fp=input_fp)
        parts.append(lanes)
        cparts.append(counts)
        total += n
    real = jnp.concatenate(parts, axis=1)
    counts = jnp.concatenate(cparts)
    return build_boss_from_kmers(
        real, counts, total, k, alphabet,
        mode=MODE_CANONICAL if canonical else MODE_BASIC,
        bits_per_count=bits_per_count)


def save_chunk(path: str, lanes, counts, K: int, alphabet_name: str,
               suffix: Tuple[int, ...], canonical: bool = False,
               input_fp: int = 0):
    np.savez_compressed(path, lanes=np.asarray(lanes),
                        counts=np.asarray(counts), k=np.array(K),
                        alphabet=np.array(alphabet_name),
                        suffix=np.array(suffix),
                        canonical=np.array(int(canonical)),
                        input_fp=np.array(int(input_fp)))


def concatenate_chunks(chunk_files: Sequence[str], outfile_base: str,
                       mode: str = MODE_BASIC, bits_per_count: int = 0):
    """Merge per-suffix chunk files into a full graph
    (reference `concatenate`, build.cpp:359-456). Chunks must be passed
    in bucket colex order (as produced by suffix_buckets)."""
    from ..graph.dbg_succinct import DbgSuccinct
    from ..graph import io as graph_io
    from ..kmer.alphabets import ALPHABETS

    parts, cparts = [], []
    K = None
    alphabet = DNA
    for f in chunk_files:
        with np.load(f) as d:
            counts_np = d["counts"]
            n = int((counts_np > 0).sum())  # valid entries form a prefix
            parts.append(jnp.asarray(d["lanes"][:, :n]))
            cparts.append(jnp.asarray(counts_np[:n]))
            if "k" in d:
                K = int(d["k"])
                alphabet = ALPHABETS[str(d["alphabet"])]
    assert K is not None, "chunks missing metadata"
    real = jnp.concatenate(parts, axis=1)
    counts = jnp.concatenate(cparts)
    total = int(real.shape[1])
    boss = build_boss_from_kmers(real, counts, total, K, alphabet,
                                 mode=mode, bits_per_count=bits_per_count)
    return graph_io.save_graph(outfile_base,
                               DbgSuccinct.from_boss(boss, alphabet, mode))
