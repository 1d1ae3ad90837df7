"""Benchmark: BOSS graph construction throughput on one GPU.

Config: a corpus shaped like the reference's transcripts_1000.fa (1,000
sequences, 1.49 Mbp), generated from a seed, k=20 (BASELINE.json config
#1). Metric: k-mers/sec through the full build pipeline (extract ->
sort-unique -> dummy generation -> W/last/F emit), measured on a warm run
(compiles done by the first run).

Baseline (BASELINE.md measurement plan — the reference publishes no
numbers): the same collection in single-threaded numpy on the same host
(window extract + sort + unique), the algorithmic class of the
reference's ips4o sort-based collection.

Extra keys report the capacity build (2^25 chars), its share of an ideal
radix-sort bandwidth roofline, the plain sort/merge/compaction primitives
at fixed shapes, and batched query and alignment throughput.

Runs only on a GPU; any failed phase exits non-zero. Prints the card's
name and power limit, then ONE JSON line as the last line of stdout.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

K = 20
N_SEQS = 1000
CORPUS_BP = 1_490_000

# Device-memory bandwidth by device_kind (bytes/s), for the rooflines
# (NVIDIA data sheets). A kind not listed is an error, never a default.
HBM_BW = {
    "H100 80GB HBM3": 3.35e12,     # SXM
    "H100 PCIe": 2.0e12,
    "H100 NVL": 3.9e12,
}


def hbm_bandwidth(device_kind: str) -> float:
    """Bandwidth of the card JAX names ``device_kind``; raises if unknown."""
    for name, bw in HBM_BW.items():
        if name in device_kind:
            return bw
    raise KeyError(f"no memory bandwidth known for device kind "
                   f"{device_kind!r}; add it to HBM_BW")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_corpus(seed: int = 0):
    """1,000 random DNA sequences totalling 1.49 Mbp."""
    rng = np.random.default_rng(seed)
    mean = CORPUS_BP // N_SEQS
    lens = rng.integers(mean // 5, 2 * mean - mean // 5 + 1, N_SEQS)
    lens = lens * CORPUS_BP // lens.sum()
    lens[:CORPUS_BP - lens.sum()] += 1
    letters = np.frombuffer(b"ACGT", np.uint8)
    return [letters[rng.integers(0, 4, n)].tobytes() for n in lens]


def numpy_baseline_kmers_per_sec(seqs):
    """Single-threaded numpy build-collection pipeline (the reference's
    algorithmic core: encode, window, pack, sort, dedupe)."""
    code = np.full(256, 255, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        code[ch] = i
    t0 = time.time()
    packed_all = []
    total_windows = 0
    for s in seqs:
        a = code[np.frombuffer(s, np.uint8)]
        if len(a) < K:
            continue
        w = np.lib.stride_tricks.sliding_window_view(a, K)
        ok = np.all(w != 255, axis=1)
        total_windows += len(w)
        w = w[ok].astype(np.uint64)
        p = np.zeros(len(w), np.uint64)
        for j in range(K):
            p = (p << np.uint64(2)) | w[:, j]
        packed_all.append(p)
    allk = np.concatenate(packed_all)
    allk.sort(kind="stable")
    uniq = np.concatenate([[True], allk[1:] != allk[:-1]])
    n_unique = int(uniq.sum())
    dt = time.time() - t0
    return total_windows / dt, n_unique, total_windows


def build_seconds(seqs):
    import jax
    from metagraph_tpu.graph.boss_construct import build_boss

    t0 = time.time()
    boss = build_boss(seqs, K)
    jax.block_until_ready(boss.F)
    log(f"cold build (incl. compile): {time.time() - t0:.2f} s, "
        f"num_edges={boss.num_edges}")
    best = float("inf")
    for _ in range(5):
        t0 = time.time()
        boss = build_boss(seqs, K)
        jax.block_until_ready((boss.F, boss.NF, boss.last_rank.words))
        best = min(best, time.time() - t0)
    return best, boss


def roofline_pct(n_kmers: int, lanes: int, seconds: float, bw: float) -> float:
    """Fraction of the device-memory speed of light achieved by the build.

    Speed-of-light model: an ideal 8-bit-digit LSD radix sort of the
    packed keys is the irreducible work of this pipeline (the reference's
    equivalent is ips4o, boss_chunk_construct.cpp:280-306).  Each digit
    pass reads + writes every key once: passes = ceil(key_bits / 8),
    bytes = 2 * passes * N * key_bytes, plus one extract read and one
    emit write.  Everything else (dedupe masks, neighbor compares, emit)
    is fused elementwise traffic already counted by those passes."""
    key_bytes = 4 * lanes
    passes = -(-(32 * lanes) // 8)
    sort_bytes = 2 * passes * n_kmers * key_bytes
    io_bytes = 2 * n_kmers * key_bytes
    sol_seconds = (sort_bytes + io_bytes) / bw
    return sol_seconds / seconds


def bench_capacity(bw: float):
    """Capacity metric: a large single-card build (33.5M distinct k-mers,
    random DNA — a worst case: zero duplicate collapse), input from the
    host. Returns (kmers_per_sec, roofline_fraction)."""
    import gc
    import jax
    from metagraph_tpu.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu.kmer.alphabets import DNA
    n = 1 << 25
    rng = np.random.default_rng(0)
    codes = rng.integers(1, 5, n).astype(np.uint8)
    boss = build_boss_from_codes(codes, 20, DNA)      # compile + warm
    jax.block_until_ready((boss.F, boss.NF, boss.last_rank.words))
    lanes = boss.edge_lanes.shape[0] if boss.edge_lanes is not None else 3
    del boss
    gc.collect()
    codes = rng.integers(1, 5, n).astype(np.uint8)
    dt = float("inf")
    for _ in range(3):
        t0 = time.time()
        boss = build_boss_from_codes(codes, 20, DNA)
        jax.block_until_ready((boss.F, boss.NF, boss.last_rank.words))
        dt = min(dt, time.time() - t0)
        gc.collect()
    rate = (n - 19) / dt
    pct = roofline_pct(n - 19, lanes, dt, bw)
    log(f"capacity: {n/1e6:.0f}M-char single-card build in {dt:.3f}s -> "
        f"{rate/1e6:.1f} Mk-mers/s ({boss.num_edges} edges), "
        f"{100*pct:.2f}% of ideal-radix roofline")
    return rate, pct


def bench_capacity_device(bw: float):
    """The same 33.5M-k-mer build with the input already staged in device
    memory: the compute path without the host-to-device copy."""
    import jax
    import jax.numpy as jnp
    from metagraph_tpu.graph import boss_construct as bc
    from metagraph_tpu.kmer.alphabets import DNA
    n = 1 << 25
    rng = np.random.default_rng(3)
    codes_np = rng.integers(1, 5, n).astype(np.uint8)
    target = bc._bucket(n)
    if n < target:
        codes_np = np.concatenate(
            [codes_np, np.full(target - n, 255, np.uint8)])
    nn = codes_np.shape[0]
    words_np, idx_np, inval = bc.pack_codes2_host(codes_np, n_valid=n)
    words = jax.device_put(words_np)
    idx = jax.device_put(idx_np)
    B = DNA.bits_per_char
    end_pos, start_pos = bc.host_boundary_windows(inval, n, K)
    capq = bc._bucket(max(len(end_pos), len(start_pos), 1))
    ep = np.zeros(capq, np.int32)
    ep[:len(end_pos)] = end_pos
    sp = np.zeros(capq, np.int32)
    sp[:len(start_pos)] = start_pos
    epd, spd = jax.device_put(ep), jax.device_put(sp)
    jax.block_until_ready((words, idx, epd, spd))
    max_count = (1 << 31) - 1

    def run():
        ulanes, ucounts, ucount, bounds = bc._collect_stage_bounds_pos(
            words, idx, jnp.int32(n), epd, jnp.int32(len(end_pos)),
            spd, jnp.int32(len(start_pos)), nn, K, B, False,
            DNA.complement)
        n_u = int(ucount)
        cap = min(max(bc._bucket(n_u), 1), ulanes.shape[1])
        kept, W, last, F, weights, lut, stats = bc._finish_stage_bounds(
            ulanes[:, :cap], ucounts[:cap], jnp.int32(n_u), *bounds,
            K, B, DNA.size, max_count, False, DNA.complement)
        return int(np.asarray(stats)[0])

    run()                                  # compile + warm
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        edges = run()
        best = min(best, time.time() - t0)
    rate = (n - K + 1) / best
    pct = roofline_pct(n - K + 1, 3, best, bw)
    log(f"capacity (device-resident input): {best:.3f}s -> "
        f"{rate/1e6:.1f} Mk-mers/s, {100*pct:.2f}% of ideal-radix "
        f"roofline ({edges} edges)")
    return rate, pct


def bench_primitives(bw: float):
    """The sort, merge and compaction primitives as XLA compiles them,
    at fixed shapes: merge of 16M + 16M sorted 3-lane keys, compaction of
    32M 3-lane keys, a 2-lane sort of 16M keys. GB/s counts one read and
    one write of the keys (12 B per 3-lane key), the least traffic each
    operation needs; ``cub`` says whether the compiled program calls
    CUB's radix sort."""
    import jax
    import jax.numpy as jnp
    from metagraph_tpu.common import packed
    rng = np.random.default_rng(0)
    N = 1 << 24
    res = {}

    def timeit(name, f, moved, *args):
        compiled = jax.jit(f).lower(*args).compile()
        cub = "cub" in compiled.as_text().lower()
        jax.block_until_ready(compiled(*args))
        best = float("inf")
        for _ in range(5):
            t0 = time.time()
            jax.block_until_ready(compiled(*args))
            best = min(best, time.time() - t0)
        gbs = moved / best / 1e9
        res[name] = {"ms": best * 1e3, "GB_s": gbs,
                     "roofline_pct": 100 * moved / best / bw, "cub": cub}
        log(f"{name}: {best * 1e3:.2f} ms, {gbs:.0f} GB/s "
            f"({100 * moved / best / bw:.1f}% of {bw / 1e12:.2f} TB/s), "
            f"cub={cub}")

    def sorted_lanes():
        v = np.sort(rng.integers(0, 1 << 62, N).astype(np.uint64))
        return jnp.asarray(np.stack([
            np.zeros(N, np.uint32), (v >> 32).astype(np.uint32),
            (v & 0xFFFFFFFF).astype(np.uint32)]))

    a, b = sorted_lanes(), sorted_lanes()
    timeit("merge_16m_16m_L3", lambda a, b: packed.merge_sorted(a, b)[0],
           2 * 2 * N * 12, a, b)
    x2 = jnp.concatenate([a, b], axis=1)
    keep = jnp.asarray(rng.random(2 * N) < 0.5)
    timeit("compact_32m_L3",
           lambda x, k: packed.compact(x, k, 2 * N)[0],
           2 * N * (12 + 1) + N * 12, x2, keep)
    shuffled = jnp.asarray(rng.permutation(np.asarray(x2[1:, :N]), axis=1))
    timeit("sort_16m_L2", lambda x: packed.sort(x)[0], 2 * N * 8, shuffled)
    return res


def bench_query(boss, seqs):
    """Secondary metric: batched query throughput (reads/sec)."""
    from metagraph_tpu.graph.dbg_succinct import DbgSuccinct
    from metagraph_tpu.kmer.alphabets import DNA
    from metagraph_tpu.engine.annotated_dbg import (AnnotatedDbg, BatchQuery,
                                                    annotate_sequences)
    g = DbgSuccinct.from_boss(boss, DNA, "basic")
    ann_items = [(s, [f"label_{i % 10}"]) for i, s in enumerate(seqs[:200])]
    ann = annotate_sequences(g, ann_items).finalize()
    bq = BatchQuery(AnnotatedDbg(graph=g, annotation=ann))
    rng = np.random.default_rng(0)
    reads = []
    for _ in range(2000):
        s = seqs[rng.integers(0, len(seqs))]
        if len(s) > 120:
            p = rng.integers(0, len(s) - 100)
            reads.append(s[p:p + 100])
    bq.get_labels_batch(reads, 0.7)        # warm up (same shapes)
    t0 = time.time()
    bq.get_labels_batch(reads, 0.7)
    dt = time.time() - t0
    log(f"query: {len(reads)} reads in {dt:.3f}s -> "
        f"{len(reads)/dt:.0f} reads/s (batched label queries)")
    return len(reads) / dt


def bench_align_batch(boss, seqs):
    """Secondary metric: end-to-end batched aligner reads/sec."""
    from metagraph_tpu.align.aligner import Aligner
    from metagraph_tpu.graph.dbg_succinct import DbgSuccinct
    from metagraph_tpu.kmer.alphabets import DNA
    g = DbgSuccinct.from_boss(boss, DNA, "basic")
    rng = np.random.default_rng(1)
    reads = []
    sub = {65: 67, 67: 65, 71: 84, 84: 71}
    for _ in range(512):
        s = seqs[rng.integers(0, len(seqs))]
        if len(s) < 130:
            continue
        p = rng.integers(0, len(s) - 110)
        r = bytearray(s[p:p + 100])
        # one substitution per read: exercises the extension DP
        q = rng.integers(10, 90)
        r[q] = sub.get(r[q], 65)
        reads.append(bytes(r))
    al = Aligner(g)
    al.align_batch(reads)                  # warm up / compile (same shapes)
    t0 = time.time()
    res = al.align_batch(reads)
    dt = time.time() - t0
    n_ok = sum(1 for r in res if r)
    log(f"align_batch: {len(reads)} reads in {dt:.2f}s -> "
        f"{len(reads)/dt:.0f} reads/s ({n_ok} aligned)")
    return len(reads) / dt


def main():
    from metagraph_tpu.common.device import (card_name_and_power_limit,
                                             require_gpu)
    dev = require_gpu()
    bw = hbm_bandwidth(dev.device_kind)
    card = card_name_and_power_limit()
    print(card, flush=True)
    log(f"device: {dev.device_kind}, memory bandwidth {bw / 1e12:.2f} TB/s")

    seqs = make_corpus()
    log(f"{len(seqs)} sequences, {sum(map(len, seqs)) / 1e6:.2f} Mbp")
    base_rate, _, total_windows = numpy_baseline_kmers_per_sec(seqs)
    log(f"baseline (numpy 1-thread collection): {base_rate / 1e6:.2f} "
        f"Mk-mers/s")

    dt, boss = build_seconds(seqs)
    value = total_windows / dt
    log(f"warm full build: {dt:.3f} s -> {value / 1e6:.2f} Mk-mers/s")
    cap_rate, cap_pct = bench_capacity(bw)
    dev_rate, dev_pct = bench_capacity_device(bw)
    out = {
        "metric": "build_kmers_per_sec",
        "value": value,
        "unit": "kmers/sec (seeded 1000-sequence 1.49 Mbp corpus, k=20, "
                "full BOSS build)",
        "vs_baseline": value / base_rate,
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "card": card,
        "capacity_kmers_per_sec": cap_rate,
        "capacity_roofline_pct": 100 * cap_pct,
        "capacity_device_kmers_per_sec": dev_rate,
        "capacity_device_roofline_pct": 100 * dev_pct,
        "primitives": bench_primitives(bw),
        "query_reads_per_sec": bench_query(boss, seqs),
        "align_reads_per_sec": bench_align_batch(boss, seqs),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
