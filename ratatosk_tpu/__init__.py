"""ratatosk_tpu — hybrid long-read error correction on an accelerator.

A from-scratch JAX/XLA framework with the capabilities of
DecodeGenetics/Ratatosk: a compacted, colored de Bruijn graph built from
accurate short reads corrects noisy ONT long reads via anchored graph-path
beam search scored by a banded edit-distance DP.

See ARCHITECTURE.md for the layer map and design decisions.
"""

import os

import jax

# k-mers are packed into uint64 words (ops/kmers.py).
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR itself
# when it is set; otherwise the cache lives at a fixed directory of this
# checkout (the path is part of the cache key, so it must not move), where
# every later run and every process of a run finds the compiled kernels.
# That directory belongs to this checkout alone, so a size limit meant for
# a shared cache (JAX_COMPILATION_CACHE_MAX_SIZE) does not apply to it: with
# eviction on, JAX failed to write entries there.
CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(CHECKOUT_DIR, ".jax_cache"))
    jax.config.update("jax_compilation_cache_max_size", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

__version__ = "0.1.0"

from ratatosk_tpu.config import CorrectOpt  # noqa: E402,F401
