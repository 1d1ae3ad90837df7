"""Out-of-core build parity: bit-identical to the in-core build."""

import numpy as np
import pytest

from conftest import random_dna
from metagraph_tpu.graph.boss_construct import build_boss
from metagraph_tpu.parallel.outofcore import (build_boss_out_of_core,
                                              h_group_key, h_node_key,
                                              h_target_key, h_to_next,
                                              h_to_prev)
from metagraph_tpu.kmer.alphabets import DNA


def _boss_equal(a, b, weights=False):
    np.testing.assert_array_equal(np.asarray(a.W), np.asarray(b.W))
    np.testing.assert_array_equal(np.asarray(a.last), np.asarray(b.last))
    np.testing.assert_array_equal(np.asarray(a.F), np.asarray(b.F))
    assert a.num_edges == b.num_edges
    if weights:
        np.testing.assert_array_equal(np.asarray(a.weights),
                                      np.asarray(b.weights))


def test_host_transforms_match_device(rng):
    """The numpy key transforms must mirror kmer/packing.py exactly."""
    import jax.numpy as jnp
    from metagraph_tpu.common import packed
    from metagraph_tpu.kmer import packing
    K, B = 11, 4
    L = packing.lanes_for(K, B)
    chars = rng.integers(1, 5, (257, K)).astype(np.uint8)
    lanes = np.asarray(packing.pack_from_chars(jnp.asarray(chars), K, B))
    d = jnp.asarray(lanes)
    np.testing.assert_array_equal(
        h_node_key(lanes, B), np.asarray(packing.node_key(d, B)))
    np.testing.assert_array_equal(
        h_target_key(lanes, B), np.asarray(packing.target_key(d, B)))
    np.testing.assert_array_equal(
        h_to_next(lanes, K, B), np.asarray(packing.to_next(d, K, B, 0)))
    np.testing.assert_array_equal(
        h_to_prev(lanes, K, B), np.asarray(packing.to_prev(d, K, B, 0)))
    from metagraph_tpu.parallel.distributed import group_key
    np.testing.assert_array_equal(
        h_group_key(lanes, B), np.asarray(group_key(d, B)))


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_out_of_core_matches_incore(rng, n_shards):
    k = 9
    seqs = [random_dna(rng, 400) for _ in range(6)]
    ref = build_boss(seqs, k)
    got = build_boss_out_of_core(seqs, k, n_shards=n_shards,
                                 chunk_codes=1 << 10)
    _boss_equal(ref, got)


def test_out_of_core_weights_and_chunking(rng):
    """Tiny chunks force duplicate k-mers across runs; counts must
    aggregate identically to the in-core build."""
    k = 8
    base = random_dna(rng, 300)
    seqs = [base, base[50:250], random_dna(rng, 200), base]
    ref = build_boss(seqs, k, bits_per_count=8)
    got = build_boss_out_of_core(seqs, k, n_shards=4, bits_per_count=8,
                                 chunk_codes=1 << 9)
    _boss_equal(ref, got, weights=True)


def test_out_of_core_query_surface(rng):
    """A small-state out-of-core graph must answer node queries."""
    from metagraph_tpu.graph.dbg_succinct import DbgSuccinct
    k = 9
    seqs = [random_dna(rng, 500) for _ in range(3)]
    boss, valid = build_boss_out_of_core(seqs, k, n_shards=4,
                                         chunk_codes=1 << 10,
                                         return_valid=True)
    assert boss.edge_lanes is None          # small state
    g = DbgSuccinct.from_boss(boss, DNA, "basic", valid=valid)
    nodes = g.map_to_nodes(seqs[0])
    assert (nodes > 0).all()
    nodes2 = g.map_to_nodes(b"N" * 40)
    assert (nodes2 == 0).all()


def test_streaming_merge_matches_rebuild(rng, tmp_path):
    """merge --num-shards: k-way merge of serialized graphs' sorted edge
    sets through the sharded finish must equal the union rebuild
    bit-for-bit (reference boss_merge.cpp:125-300)."""
    from metagraph_tpu.graph.dbg_succinct import DbgSuccinct
    from metagraph_tpu.parallel.outofcore import \
        merge_boss_graphs_out_of_core
    k = 9
    s1 = [random_dna(rng, 400) for _ in range(2)]
    s2 = [s1[0][100:300]] + [random_dna(rng, 350)]
    g1 = DbgSuccinct.from_boss(build_boss(s1, k, bits_per_count=8),
                               DNA, "basic")
    g2 = DbgSuccinct.from_boss(build_boss(s2, k, bits_per_count=8),
                               DNA, "basic")
    ref = build_boss(s1 + s2, k, bits_per_count=31)
    got, valid = merge_boss_graphs_out_of_core(
        [g1, g2], n_shards=4, return_valid=True)
    _boss_equal(ref, got, weights=True)
    # the merged valid mask matches the rebuild-derived one
    gref = DbgSuccinct.from_boss(ref, DNA, "basic")
    np.testing.assert_array_equal(
        np.asarray(gref.valid_rank.bits_host()), valid)


def test_small_state_walk_mapping_matches_flat(rng):
    """map_read_batch (incremental small-state walk) must agree with the
    flat k-step search on hits, misses, SNP reads and short reads."""
    from metagraph_tpu.graph.dbg_succinct import DbgSuccinct
    k = 9
    seqs = [random_dna(rng, 600) for _ in range(3)]
    boss, valid = build_boss_out_of_core(seqs, k, n_shards=2,
                                         chunk_codes=1 << 10,
                                         return_valid=True)
    g = DbgSuccinct.from_boss(boss, DNA, "basic", valid=valid)
    assert g.boss.edge_lanes is None
    sub = {65: 67, 67: 71, 71: 84, 84: 65}
    reads = [seqs[0][10:110], b"T" * 80, seqs[1][5:60], b"ACGTACG"]
    for snps in (1, 2, 3):
        r = bytearray(seqs[2][100:200])
        for j in range(snps):
            p = 10 + j * 30
            r[p] = sub[r[p]]
        reads.append(bytes(r))
    got = g.map_read_batch(reads)
    want = [g.map_to_nodes(r) for r in reads]
    for gg, ww, r in zip(got, want, reads):
        np.testing.assert_array_equal(gg, ww), r


def test_small_state_batch_query(rng):
    """BatchQuery over a small-state graph routes through the walk and
    matches the fast-state answers."""
    from metagraph_tpu.engine.annotated_dbg import (AnnotatedDbg,
                                                    BatchQuery,
                                                    annotate_sequences)
    from metagraph_tpu.graph.dbg_succinct import DbgSuccinct
    k = 9
    seqs = [random_dna(rng, 400) for _ in range(3)]
    fast = DbgSuccinct.from_boss(build_boss(seqs, k), DNA, "basic")
    boss, valid = build_boss_out_of_core(seqs, k, n_shards=2,
                                         chunk_codes=1 << 10,
                                         return_valid=True)
    small = DbgSuccinct.from_boss(boss, DNA, "basic", valid=valid)
    reads = [seqs[0][5:105], b"G" * 60, seqs[2][40:120]]
    for ratio in (0.0, 0.6):
        outs = []
        for g in (fast, small):
            ann = annotate_sequences(
                g, [(s, [f"l{i}"]) for i, s in enumerate(seqs)]).finalize()
            bq = BatchQuery(AnnotatedDbg(graph=g, annotation=ann))
            outs.append(bq.get_labels_batch(reads, ratio))
        assert outs[0] == outs[1], ratio


def test_tkey_routing_balance():
    """Target-key routing must spread across shards (the raw tkey's top
    field is zero, which once routed ALL source-join traffic to shard
    0 — OOM at 268M edges)."""
    import numpy as np
    from metagraph_tpu.parallel import outofcore as oc
    from metagraph_tpu.kmer import packing
    from metagraph_tpu.kmer.alphabets import DNA
    import jax.numpy as jnp
    from metagraph_tpu.graph import boss_construct as bc

    K, B = 20, DNA.bits_per_char
    rng = np.random.default_rng(3)
    codes = rng.integers(1, 5, 200_000).astype(np.uint8)
    real = np.asarray(packing.pack_windows(jnp.asarray(codes), K, B))
    order = np.argsort(oc._rec(oc.h_group_key(real, B)), kind="stable")
    real = real[:, order]
    # splitters from edge group keys (like the build)
    store = oc._RunStore(None)
    store.add(real, None)
    S = 8
    sp = oc._sample_splitters_from_runs(store, real.shape[0], B, S)
    store.cleanup()
    tk = oc.h_target_key(real, B)
    own = oc.h_owner_tkey(tk, sp, B)
    counts = np.bincount(own, minlength=S)
    assert counts.max() < 2.5 * counts.mean(), counts
    # the raw-tkey owner is the degenerate case this guards against
    raw = oc.h_owner(tk, sp, B)
    assert np.bincount(raw, minlength=S).max() == len(raw)  # documents the trap
