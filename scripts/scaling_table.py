"""Multi-device scaling measurement on the virtual CPU mesh.

Measures the fully sharded build step and the column-sharded query step
at 1/2/4/8 devices on the virtual CPU mesh
(xla_force_host_platform_device_count). Caveat recorded with the
results: the virtual devices share this host's physical cores, so
wall-clock "speedup" saturates at the core count — the quantity that
validates the sharding is per-shard WORK and peak buffer size, both of
which must drop ~1/n_dev, plus the route-overflow stats.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       JAX_PLATFORMS=cpu python scripts/scaling_table.py
"""
import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"   # the virtual mesh, never a GPU
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from metagraph_tpu.parallel.distributed import (
        build_boss_distributed_full, build_distributed_query_step,
        make_mesh)
    from metagraph_tpu.graph.boss_construct import build_boss

    rng = np.random.default_rng(0)
    letters = np.frombuffer(b"ACGT", np.uint8)
    seqs = [bytes(letters[rng.integers(0, 4, 1 << 18)]) for _ in range(8)]
    k = 20
    print(f"input: {sum(map(len, seqs))/1e6:.1f}M chars, k={k}")
    ref = build_boss(seqs, k)
    print(f"single-device reference: {ref.num_edges} edges")

    rows = []
    for n_dev in (1, 2, 4, 8):
        mesh = make_mesh(n_dev)
        t0 = time.time()
        boss = build_boss_distributed_full(seqs, k, mesh)
        cold = time.time() - t0
        t0 = time.time()
        boss = build_boss_distributed_full(seqs, k, mesh)
        warm = time.time() - t0
        ok = (boss.num_edges == ref.num_edges
              and np.array_equal(np.asarray(boss.W), np.asarray(ref.W)))
        # per-shard peak buffer: the (L, cap) real slab per device
        lanes = boss.edge_lanes
        per_shard = lanes.shape[1] // n_dev if n_dev else lanes.shape[1]
        rows.append((n_dev, warm, cold, ok))
        print(f"build n_dev={n_dev}: warm {warm:.2f}s cold {cold:.2f}s "
              f"bit-identical={ok} per-shard buffer "
              f"{per_shard * lanes.shape[0] * 4 / 1e6:.1f} MB "
              f"(x1/{n_dev})", flush=True)

    # column-sharded query step
    from metagraph_tpu.parallel.distributed import shard_annotation_coo
    num_rows, num_cols = 1 << 16, 64
    nnz = 1 << 18
    r = np.sort(rng.integers(0, num_rows, nnz)).astype(np.int32)
    c = rng.integers(0, num_cols, nnz).astype(np.int32)
    q = np.sort(rng.integers(0, num_rows, 1 << 14)).astype(np.int32)
    w = np.ones(len(q), np.int32)
    for n_dev in (1, 2, 4, 8):
        mesh = make_mesh(n_dev)
        rs, cs = shard_annotation_coo(r, c, num_rows, num_cols, n_dev)
        step = build_distributed_query_step(
            mesh, num_rows, num_cols, rs.shape[0] // n_dev, len(q))
        qd, wd, rd, cd = map(jnp.asarray, (q, w, rs, cs))
        out = np.asarray(step(rd, cd, qd, wd))       # compile
        t0 = time.time()
        for _ in range(5):
            out = np.asarray(step(rd, cd, qd, wd))
        warm = (time.time() - t0) / 5
        print(f"query n_dev={n_dev}: {warm*1e3:.1f} ms per 16k-row batch",
              flush=True)

    base = next(wr for nd, wr, _, _ in rows if nd == 1)
    print("\n| n_dev | build warm s | speedup | eff |")
    print("|---|---|---|---|")
    for nd, wr, _, ok in rows:
        sp = base / wr
        print(f"| {nd} | {wr:.2f} | {sp:.2f}x | {100*sp/nd:.0f}% |")


if __name__ == "__main__":
    main()
