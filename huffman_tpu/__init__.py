"""huffman_tpu — a Huffman codec framework for NVIDIA GPUs in JAX.

Built from scratch in JAX/XLA/Pallas with the full capabilities of the
reference GPU encoder (vlnguyen92/Huffman-GPU "PAVLE"): device byte
histogram, canonical Huffman codebook, block-local variable-length encode
with prefix-summed bit offsets, bit-granular packing into one dense
stream, a CPU golden codec oracle, plus — beyond the reference — a
table-driven parallel decoder and data-parallel multi-device scale-out
over a jax.sharding.Mesh.

Layer map (mirrors SURVEY.md section 1's L1-L6):
  cli / api        — L6 driver (reference: main_test_cu.cu)
  container        — L5 serialization (reference: load_data.h)
  codebook, models — L5 codebook construction (reference: huffTree.h)
  backend          — which implementation runs on this platform
  ops/             — L4 device compute: histogram, encode, scan, pack,
                     decode; ops/pallas for the hand-written GPU kernel
  golden/          — L3 CPU golden codec (reference: cpuencode.cpp)
  config           — L2 runtime configuration (reference: parameters.h)
  utils/, verify   — L1 observability + verification helpers
  parallel/        — mesh / collectives layer (no reference analogue;
                     the reference is single-GPU)
"""

import os as _os

import jax as _jax

# Persistent compilation cache: where JAX_COMPILATION_CACHE_DIR points
# (JAX reads it itself), else one fixed directory in the checkout, which
# git ignores — a fixed path, because the path is part of the cache key.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))

from .config import CodecConfig, DEFAULT_CONFIG, NUM_SYMBOLS
from .codebook import Codebook, entropy_bits_per_byte, byte_histogram_host

__version__ = "0.1.0"

__all__ = [
    "CodecConfig", "DEFAULT_CONFIG", "NUM_SYMBOLS",
    "Codebook", "entropy_bits_per_byte", "byte_histogram_host",
    "__version__",
]
