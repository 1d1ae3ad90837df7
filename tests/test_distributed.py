"""Multi-device tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from conftest import random_dna
from metagraph_tpu.kmer.alphabets import DNA, INVALID_CODE
from metagraph_tpu.parallel.distributed import (build_distributed_count_step,
                                                build_distributed_query_step,
                                                make_mesh,
                                                shard_annotation_coo)


def test_mesh():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_distributed_kmer_count(rng):
    K = 8
    n_dev = 8
    codes_per = 1 << 10
    mesh = make_mesh(n_dev)
    tbl = DNA.encode_table()
    seqs = [random_dna(rng, codes_per - 1) for _ in range(n_dev)]
    codes = np.full((n_dev, codes_per), INVALID_CODE, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = tbl[np.frombuffer(s, np.uint8)]
    step = build_distributed_count_step(mesh, K, codes_per_device=codes_per)
    total, per_shard = step(jnp.asarray(codes.reshape(-1)))
    gold = set()
    for s in seqs:
        for i in range(len(s) - K + 1):
            gold.add(s[i:i + K])
    assert int(total) == len(gold)
    assert int(np.asarray(per_shard).sum()) == len(gold)
    # sharding is balanced-ish: no shard owns everything
    assert int(np.asarray(per_shard).max()) < len(gold)


def test_distributed_query(rng):
    n_dev = 8
    num_rows, num_cols = 200, 16
    dense = rng.random((num_rows, num_cols)) < 0.15
    r, c = np.nonzero(dense)
    mesh = make_mesh(n_dev)
    rows_sh, cols_sh = shard_annotation_coo(
        r.astype(np.int32), c.astype(np.int32), num_rows, num_cols, n_dev)
    q = np.sort(rng.choice(num_rows, size=32, replace=False)).astype(np.int32)
    w = rng.integers(1, 4, size=32).astype(np.int32)
    step = build_distributed_query_step(
        mesh, num_rows, num_cols, nnz_cap=len(rows_sh) // n_dev,
        query_cap=32)
    got = np.asarray(step(jnp.asarray(rows_sh), jnp.asarray(cols_sh),
                          jnp.asarray(q), jnp.asarray(w)))
    want = (dense[q] * w[:, None]).sum(axis=0)
    np.testing.assert_array_equal(got, want)


def test_streaming_build_equals_plain(rng):
    """Host-spill collection (bounded device window) must produce the
    same graph as the in-memory build."""
    from metagraph_tpu.graph.boss_construct import build_boss
    from metagraph_tpu.parallel.streaming import build_boss_streaming
    seqs = [random_dna(rng, 700) for _ in range(4)]
    k = 11
    plain = build_boss(seqs, k, bits_per_count=8)
    stream = build_boss_streaming(seqs, k, bits_per_count=8,
                                  chunk_codes=512)  # force many chunks
    assert stream.num_edges == plain.num_edges
    np.testing.assert_array_equal(np.asarray(stream.W), np.asarray(plain.W))
    np.testing.assert_array_equal(np.asarray(stream.weights),
                                  np.asarray(plain.weights))


def test_streaming_canonical(rng):
    from metagraph_tpu.graph.boss_construct import build_boss
    from metagraph_tpu.parallel.streaming import build_boss_streaming
    seqs = [random_dna(rng, 400) for _ in range(2)]
    plain = build_boss(seqs, 9, mode="canonical")
    stream = build_boss_streaming(seqs, 9, mode="canonical",
                                  chunk_codes=256)
    np.testing.assert_array_equal(np.asarray(stream.W), np.asarray(plain.W))


def test_distributed_full_build_equals_plain(rng):
    """The all_to_all distributed build must produce the identical graph."""
    from metagraph_tpu.graph.boss_construct import build_boss
    from metagraph_tpu.parallel.distributed import build_boss_distributed
    mesh = make_mesh(8)
    seqs = [random_dna(rng, 600) for _ in range(4)]
    k = 9
    plain = build_boss(seqs, k)
    dist = build_boss_distributed(seqs, k, mesh)
    assert dist.num_edges == plain.num_edges
    np.testing.assert_array_equal(np.asarray(dist.W), np.asarray(plain.W))
    np.testing.assert_array_equal(np.asarray(dist.last),
                                  np.asarray(plain.last))


def test_distributed_build_canonical(rng):
    from metagraph_tpu.graph.boss_construct import build_boss
    from metagraph_tpu.parallel.distributed import build_boss_distributed
    mesh = make_mesh(8)
    seqs = [random_dna(rng, 300) for _ in range(2)]
    plain = build_boss(seqs, 7, mode="canonical")
    dist = build_boss_distributed(seqs, 7, mesh, mode="canonical")
    np.testing.assert_array_equal(np.asarray(dist.W), np.asarray(plain.W))


def test_full_sharded_finish_bit_identity(rng):
    """The fully sharded build (splitter routing + per-shard rc closure,
    dummy joins, levels and emit) is bit-identical to the single-device
    build on the 8-device mesh, both modes."""
    from metagraph_tpu.parallel.distributed import (
        build_boss_distributed_full, make_mesh)
    from metagraph_tpu.graph.boss_construct import build_boss
    from conftest import random_dna

    seqs = [random_dna(rng, 350) for _ in range(10)]
    mesh = make_mesh(8)
    for mode in ("basic", "canonical"):
        dist = build_boss_distributed_full(seqs, 11, mesh, mode=mode,
                                           bits_per_count=8)
        plain = build_boss(seqs, 11, mode=mode, bits_per_count=8)
        for f in ("W", "last", "F", "weights", "edge_lanes"):
            np.testing.assert_array_equal(
                np.asarray(getattr(dist, f)),
                np.asarray(getattr(plain, f)), err_msg=f"{mode} {f}")


def test_disk_swap_bit_identity(tmp_path, rng):
    """--disk-swap tier: spilled memmap runs + cascaded block merges
    produce the same build as in-RAM."""
    from metagraph_tpu.parallel.streaming import (build_boss_streaming,
                                                  collect_kmers_streaming)
    from metagraph_tpu.graph.boss_construct import build_boss
    from conftest import random_dna

    seqs = [random_dna(rng, 500) for _ in range(20)]
    ld, cd = collect_kmers_streaming(seqs, 13, chunk_codes=2048,
                                     disk_dir=str(tmp_path))
    lr, cr = collect_kmers_streaming(seqs, 13, chunk_codes=2048)
    np.testing.assert_array_equal(np.asarray(ld), lr)
    np.testing.assert_array_equal(np.asarray(cd), cr)
    bd = build_boss_streaming(seqs, 13, chunk_codes=2048,
                              disk_dir=str(tmp_path), bits_per_count=8)
    bp = build_boss(seqs, 13, bits_per_count=8)
    for f in ("W", "last", "F", "weights", "edge_lanes"):
        np.testing.assert_array_equal(np.asarray(getattr(bd, f)),
                                      np.asarray(getattr(bp, f)))


def test_spill_pack_roundtrip_and_bytes(rng):
    """Compact spill form: order-preserving, reversible, ~2.4x smaller
    for DNA (reference EF spill elias_fano.hpp:165)."""
    import jax.numpy as jnp
    import numpy as np
    from metagraph_tpu.kmer import packing
    from metagraph_tpu.kmer.alphabets import DNA
    from metagraph_tpu.parallel.streaming import (_pack_run, _repack_bits,
                                                  _unpack_run)
    K, B = 20, DNA.bits_per_char
    B2 = _repack_bits(K, B, DNA.size)
    assert B2 == 2
    chars = rng.integers(1, 5, (500, K)).astype(np.uint8)
    lanes = np.asarray(packing.pack_from_chars(jnp.asarray(chars), K, B))
    order = np.lexsort(tuple(lanes[j] for j in range(lanes.shape[0] - 1,
                                                     -1, -1)))
    lanes = lanes[:, order]
    packed_l = _pack_run(lanes, K, B, B2)
    # 2 bits/char vs 4, quantized to whole uint32 lanes: K=20 stores
    # 2 lanes instead of 3 (1.5x); k=31 stores 2 instead of 4 (2x)
    assert packed_l.shape[0] < lanes.shape[0]
    # order-preserving: the packed keys are sorted too
    o2 = np.lexsort(tuple(packed_l[j] for j in range(packed_l.shape[0] - 1,
                                                     -1, -1)))
    assert (o2 == np.arange(len(o2))).all()
    np.testing.assert_array_equal(_unpack_run(packed_l, K, B, B2), lanes)
