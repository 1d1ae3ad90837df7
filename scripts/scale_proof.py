"""Scale proof: out-of-core build of a >=500M-edge graph on ONE card.

Random DNA (worst case: no duplicate collapse, ~n distinct k-mers),
k=20 — BASELINE.md measurement plan item 'prove scale'. Reports wall
time, peak RSS, edges, device index bytes/edge (small state), and
batched small-state query throughput.

Usage: python scripts/scale_proof.py [n_chars_log2=29] [n_shards=16]
"""
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_LOG2 = int(sys.argv[1]) if len(sys.argv) > 1 else 29
SHARDS = int(sys.argv[2]) if len(sys.argv) > 2 else 16
K = 20
CHUNK = 1 << 26


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def log(m):
    print(f"[{time.strftime('%H:%M:%S')}] {m}", flush=True)


def gen_chunks(n_total, chunk, seed=0):
    rng = np.random.default_rng(seed)
    done = 0
    while done < n_total:
        take = min(chunk, n_total - done)
        yield rng.integers(1, 5, take).astype(np.uint8)
        done += take


def main():
    import jax
    from metagraph_tpu.parallel.outofcore import build_boss_out_of_core
    from metagraph_tpu.graph.dbg_succinct import DbgSuccinct
    from metagraph_tpu.graph import io as graph_io
    from metagraph_tpu.kmer.alphabets import DNA

    n = 1 << N_LOG2
    dev = jax.devices()[0]
    log(f"device: {dev.device_kind}; input {n / 1e6:.0f}M chars, "
        f"k={K}, {SHARDS} shards")
    t0 = time.time()
    boss, valid = build_boss_out_of_core(
        gen_chunks(n, CHUNK - 8), K, DNA, n_shards=SHARDS,
        chunk_codes=CHUNK, keep_kmer_index=False, verbose=True,
        return_valid=True)
    build_s = time.time() - t0
    edges = boss.num_edges
    log(f"BUILD: {edges / 1e6:.1f}M edges in {build_s:.1f}s "
        f"({(n - K + 1) / build_s / 1e6:.2f} Mk-mers/s), "
        f"peak RSS {rss_gb():.1f} GB")
    _root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(_root, "SCALE_PROOF.json"), "a") as f:
        f.write('{"edges": %d, "build_s": %.1f, "mkmers_per_s": %.2f, '
                '"peak_rss_gb": %.1f, "n_log2": %d, "n_shards": %d, '
                '"stage": "build"}\n'
                % (edges, build_s, (n - K + 1) / build_s / 1e6,
                   rss_gb(), N_LOG2, SHARDS))
    g = DbgSuccinct.from_boss(boss, DNA, "basic", valid=valid)
    idx_bytes = graph_io.index_bytes(g)
    log(f"small-state index: {idx_bytes / 1e9:.2f} GB "
        f"= {idx_bytes / edges:.2f} B/edge")

    # batched query throughput (small-state rank/select search)
    rng = np.random.default_rng(7)
    # reads sampled from the input stream (hits) + random reads (misses)
    src = rng.integers(1, 5, 1 << 20).astype(np.uint8)
    # rebuild chunk 0's first MB so reads actually hit: same seed/stream
    src_hit = next(gen_chunks(1 << 20, 1 << 20))
    reads = []
    for i in range(2000):
        if i % 2 == 0:
            p = rng.integers(0, len(src_hit) - 100)
            reads.append(src_hit[p:p + 100])
        else:
            p = rng.integers(0, len(src) - 100)
            reads.append(src[p:p + 100])
    res = g.map_read_batch(reads)            # compile + warm
    t0 = time.time()
    res = g.map_read_batch(reads)
    q_s = time.time() - t0
    hit_windows = int(sum((r > 0).sum() for r in res))
    n_windows = sum(len(r) for r in res)
    log(f"QUERY: {len(reads)} reads ({n_windows / 1e6:.2f}M windows) in "
        f"{q_s:.3f}s -> {len(reads) / q_s:.0f} reads/s small-state "
        f"incremental walk ({hit_windows} present windows)")
    line = (
        '{"edges": %d, "build_s": %.1f, "mkmers_per_s": %.2f, '
        '"peak_rss_gb": %.1f, "bytes_per_edge": %.2f, '
        '"query_reads_per_s": %.0f, "n_log2": %d, "n_shards": %d}'
        % (edges, build_s, (n - K + 1) / build_s / 1e6, rss_gb(),
           idx_bytes / edges, len(reads) / q_s, N_LOG2, SHARDS))
    print(line, flush=True)
    # persist at the repo root so a long run that finishes after the
    # interactive session still lands in the round snapshot
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "SCALE_PROOF.json")
    with open(out, "a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
