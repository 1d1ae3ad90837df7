"""Work-queue coordinator tests: ack/nack/retry semantics + end-to-end
sharded build through worker jobs."""

import threading

import numpy as np
import pytest

from conftest import random_dna
from metagraph_tpu.parallel.coordinator import WorkQueue, Worker, serve_queue


def test_queue_ack_nack_retry():
    q = WorkQueue([{"n": i} for i in range(3)], max_attempts=2)
    j1 = q.acquire("w1")
    j2 = q.acquire("w2")
    assert {j1.payload["n"], j2.payload["n"]} == {0, 1}
    assert q.ack(j1.job_id)
    assert not q.ack(j1.job_id)  # double ack rejected
    # nack requeues (to the back) until max_attempts
    assert q.nack(j2.job_id)
    j3 = q.acquire("w1")                 # fresh job first (FIFO)
    assert j3.payload["n"] == 2
    j2b = q.acquire("w1")                # then the retried one
    assert j2b.payload == j2.payload and j2b.attempts == 2
    assert q.nack(j2b.job_id)            # second failure -> failed bucket
    st = q.status()
    assert st["failed"] == 1 and st["done"] == 1
    q.ack(j3.job_id)
    assert q.finished()


def test_lease_expiry_requeues():
    q = WorkQueue([{"n": 0}], lease_seconds=0.0)
    j = q.acquire("w1")
    st = q.status()          # reaps the expired lease
    assert st["pending"] == 1 and st["active"] == 0


def test_http_workers_flaky_execution():
    httpd, queue = serve_queue([{"x": i} for i in range(8)],
                               max_attempts=3)
    port = httpd.server_address[1]
    fail_once = set()
    lock = threading.Lock()
    done = []

    def execute(payload):
        with lock:
            if payload["x"] % 3 == 0 and payload["x"] not in fail_once:
                fail_once.add(payload["x"])
                raise RuntimeError("transient")
            done.append(payload["x"])
        return {"x": payload["x"]}

    workers = [Worker(f"http://127.0.0.1:{port}", f"w{i}") for i in range(3)]
    threads = [threading.Thread(target=w.run_until_empty,
                                args=(execute, 0.05)) for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    st = queue.status()
    assert st["done"] == 8 and st["failed"] == 0
    assert sorted(done) == sorted(range(8))
    httpd.shutdown()


def test_sharded_build_via_queue(tmp_path, rng):
    """Distribute per-suffix shard collection as queue jobs, then
    concatenate — the multi-host build flow without multi-host."""
    from metagraph_tpu.graph.boss_construct import build_boss
    from metagraph_tpu.graph import io as graph_io
    from metagraph_tpu.graph.dbg_succinct import DbgSuccinct
    from metagraph_tpu.kmer.alphabets import DNA
    from metagraph_tpu.parallel.sharded_build import (build_shard_kmers,
                                                      concatenate_chunks,
                                                      save_chunk,
                                                      suffix_buckets)

    seqs = [random_dna(rng, 200) for _ in range(3)]
    k = 9
    jobs = [{"suffix": list(sfx)} for sfx in suffix_buckets(DNA, 1)]
    httpd, queue = serve_queue(jobs)
    port = httpd.server_address[1]
    chunks = {}

    def execute(payload):
        sfx = tuple(payload["suffix"])
        lanes, counts, n = build_shard_kmers(seqs, k, sfx)
        name = "".join(DNA.letters[c] for c in sfx)
        path = str(tmp_path / f"chunk_{name}.npz")
        save_chunk(path, lanes, counts, k, DNA.name, sfx)
        chunks[sfx] = path
        return {"path": path}

    Worker(f"http://127.0.0.1:{port}").run_until_empty(execute, 0.05)
    httpd.shutdown()
    assert queue.finished()
    ordered = [chunks[sfx] for sfx in suffix_buckets(DNA, 1)]
    out = concatenate_chunks(ordered, str(tmp_path / "full"))
    got = graph_io.load_graph(out)
    want = DbgSuccinct.from_boss(build_boss(seqs, k), DNA, "basic")
    assert got.num_nodes() == want.num_nodes()
    np.testing.assert_array_equal(np.asarray(got.boss.W),
                                  np.asarray(want.boss.W))


def test_two_process_distributed_build(tmp_path, rng):
    """Two separate worker PROCESSES complete a sharded build through the
    work queue; the concatenated graph matches a direct build."""
    import os
    import subprocess
    import sys
    import time as _time

    from conftest import random_dna
    from metagraph_tpu.cli.main import main as cli_main
    from metagraph_tpu.parallel.coordinator import serve_queue
    from metagraph_tpu.parallel.sharded_build import (concatenate_chunks,
                                                      suffix_buckets)
    from metagraph_tpu.kmer.alphabets import DNA
    from metagraph_tpu.graph import io as graph_io

    fa = str(tmp_path / "in.fa")
    seqs = [random_dna(rng, 300) for _ in range(5)]
    with open(fa, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">s{i}\n{s.decode()}\n")
    base = str(tmp_path / "dg")
    jobs, chunks = [], []
    for sfx in suffix_buckets(DNA, 1):
        name = "".join(DNA.letters[c] for c in sfx)
        jobs.append({"argv": ["build", "-k", "11", "--suffix", name,
                              "-o", base, fa]})
        chunks.append(f"{base}.{name}.chunk.npz")
    httpd, queue = serve_queue(jobs)
    server = f"http://{httpd.server_address[0]}:{httpd.server_address[1]}"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__)))]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    workers = [subprocess.Popen(
        [sys.executable, "-m", "metagraph_tpu.cli.main", "worker",
         "--server", server, "--name", f"w{i}"], env=env)
        for i in range(2)]
    deadline = _time.time() + 560
    while not queue.finished() and _time.time() < deadline:
        _time.sleep(0.5)
    for w in workers:
        w.wait(timeout=60)
    httpd.shutdown()
    assert queue.finished(), queue.status()
    concatenate_chunks(chunks, base)
    got = graph_io.load_graph(base)
    cli_main(["build", "-k", "11", "-o", str(tmp_path / "direct"), fa])
    want = graph_io.load_graph(str(tmp_path / "direct"))
    np.testing.assert_array_equal(np.asarray(got.boss.W),
                                  np.asarray(want.boss.W))
    np.testing.assert_array_equal(np.asarray(got.boss.last),
                                  np.asarray(want.boss.last))


def test_sharded_build_resume(tmp_path, rng, monkeypatch):
    """A finished suffix pass is a checkpoint: rebuilding with the same
    input and chunk_dir resumes from the chunk files without recomputing
    any bucket (the reference's .dbg.chunk restart discipline), while a
    DIFFERENT input must not reuse stale chunks."""
    from conftest import random_dna
    from metagraph_tpu.parallel import sharded_build as sb
    import numpy as np

    seqs = [random_dna(rng, 300) for _ in range(3)]
    fresh = sb.build_boss_sharded(seqs, 11, suffix_len=1)
    cdir = str(tmp_path / "chunks")
    first = sb.build_boss_sharded(seqs, 11, suffix_len=1, chunk_dir=cdir)

    def boom(*a, **kw):
        raise AssertionError("bucket recomputed despite valid chunks")
    monkeypatch.setattr(sb, "build_shard_kmers", boom)
    resumed = sb.build_boss_sharded(seqs, 11, suffix_len=1, chunk_dir=cdir)
    monkeypatch.undo()
    for a, b in ((fresh, first), (fresh, resumed)):
        assert a.num_edges == b.num_edges
        np.testing.assert_array_equal(np.asarray(a.W), np.asarray(b.W))
        np.testing.assert_array_equal(np.asarray(a.F), np.asarray(b.F))
    # stale chunks (different input) are rejected, not silently reused
    other = [random_dna(rng, 250) for _ in range(2)]
    fresh2 = sb.build_boss_sharded(other, 11, suffix_len=1)
    rebuilt = sb.build_boss_sharded(other, 11, suffix_len=1,
                                    chunk_dir=cdir)
    assert rebuilt.num_edges == fresh2.num_edges
