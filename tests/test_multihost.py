"""Multi-host runtime entry (parallel/multihost.py): single-process
no-op path, mesh construction, and a REAL two-process
jax.distributed.initialize rendezvous over localhost."""

import os
import socket
import subprocess
import sys

import numpy as np


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_single_process_noop():
    from metagraph_tpu.parallel import multihost
    assert multihost.initialize() is False      # no env, no args
    mesh = multihost.global_mesh()
    assert mesh.devices.size == len(__import__("jax").devices())
    assert multihost.is_primary()


_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, {repo!r})
import jax
from metagraph_tpu.parallel import multihost
ok = multihost.initialize(coordinator_address={addr!r},
                          num_processes=2, process_id={pid})
assert ok
assert jax.process_count() == 2
assert jax.device_count() == 4          # 2 local per process
mesh = multihost.global_mesh()
assert mesh.devices.size == 4
print("proc", {pid}, "primary:", multihost.is_primary(), flush=True)
"""


def test_two_process_initialize(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    addr = f"127.0.0.1:{free_port()}"
    # children start from a clean environment: the parent's JAX_/XLA_
    # settings (8 virtual devices) must not leak into their 2-device setup
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_")) and k != "PYTHONPATH"}
    procs = []
    for pid in range(2):
        script = _WORKER.format(repo=repo, addr=addr, pid=pid)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out.decode())
        assert p.returncode == 0, out.decode()
    joined = "".join(outs)
    assert "proc 0 primary: True" in joined
    assert "proc 1 primary: False" in joined


_BUILD_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, {repo!r})
import jax
import jax.numpy as jnp
import numpy as np
from metagraph_tpu.parallel import multihost
assert multihost.initialize(coordinator_address={addr!r},
                            num_processes=2, process_id={pid})
from jax.sharding import NamedSharding, PartitionSpec as P
from metagraph_tpu.parallel.distributed import build_distributed_count_step
from metagraph_tpu.kmer.alphabets import DNA, INVALID_CODE

mesh = multihost.global_mesh()
K, per = 8, 256
n_dev = mesh.devices.size
rng = np.random.default_rng(0)                  # same data on both procs
tbl = DNA.encode_table()
codes = np.full((n_dev, per), INVALID_CODE, np.uint8)
for i in range(n_dev):
    s = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=per - 1))
    codes[i, :per - 1] = tbl[np.frombuffer(s, np.uint8)]
flat = codes.reshape(-1)
# every process contributes its 2 local device slices of the global array
sh = NamedSharding(mesh, P("x"))
local = flat.reshape(n_dev, per)[2 * {pid}:2 * {pid} + 2].reshape(-1)
garr = jax.make_array_from_process_local_data(sh, local, (n_dev * per,))
step = build_distributed_count_step(mesh, K, codes_per_device=per)
total, per_shard = step(garr)
total = int(total.addressable_data(0))
print("TOTAL", total, flush=True)

# single-process truth: count distinct k-mers of the 4 segments on host
gold = set()
for i in range(n_dev):
    row = codes[i]
    for j in range(per - K + 1):
        w = row[j:j + K]
        if (w == INVALID_CODE).any() or (w == 0).any():
            continue
        gold.add(bytes(w))
assert total == len(gold), (total, len(gold))
print("MATCH", flush=True)
"""


def test_two_process_distributed_build_step(tmp_path):
    """TWO processes jointly run the all_to_all k-mer count step over a
    4-device global mesh (2 local devices each) — collectives cross the
    process boundary via the CPU gloo backend — and the distinct-k-mer
    total matches the host truth."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    addr = f"127.0.0.1:{free_port()}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_")) and k != "PYTHONPATH"}
    procs = []
    for pid in range(2):
        script = _BUILD_WORKER.format(repo=repo, addr=addr, pid=pid)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode()[-2000:]
        assert b"MATCH" in out
