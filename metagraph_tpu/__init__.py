"""metagraph_tpu — an annotated de Bruijn graph framework on JAX.

A from-scratch re-design of MetaGraph (ratschlab/projects2014-metagenome)
for accelerators: packed k-mer tensors + XLA sort/scan/gather programs
replace the reference's succinct CPU data structures; jax.sharding meshes
+ collectives replace its file-based sharding.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax


def compile_cache_dir() -> str:
    """Directory of the persistent XLA compilation cache:
    ``JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself), else the
    fixed ``<checkout>/.jax_cache``, so every process of one checkout
    shares one cache."""
    return (_os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or _os.path.join(_os.path.dirname(_os.path.dirname(
                _os.path.abspath(__file__))), ".jax_cache"))


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
# CLI runs are short processes: keep every program that took noticeable
# time to compile, not only the >1 s ones JAX keeps by default
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
