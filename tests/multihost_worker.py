"""Worker process for the 2-host distributed test (test_multihost.py).

Each process owns 2 virtual CPU devices; jax.distributed stitches them
into one 4-device global mesh — the same code path a multi-host cluster
uses (parallel/mesh.init_multihost), with the collectives run by local
gloo.  Usage:
    python multihost_worker.py <process_id> <num_processes> <port>
Prints MULTIHOST-OK on success (every process must).
"""

import os
import sys

pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
except Exception:
    pass

from huffman_tpu.parallel.mesh import init_multihost  # noqa: E402

init_multihost(coordinator_address=f"localhost:{port}",
               num_processes=nprocs, process_id=pid)

import numpy as np  # noqa: E402
from unittest import mock  # noqa: E402

from huffman_tpu import api, backend, container, golden  # noqa: E402
from huffman_tpu.codebook import Codebook  # noqa: E402
from huffman_tpu.config import CodecConfig  # noqa: E402
from huffman_tpu.parallel.mesh import make_mesh  # noqa: E402
from huffman_tpu.parallel.pipeline import ShardedCodec  # noqa: E402
from huffman_tpu.utils import testdata  # noqa: E402

assert jax.process_count() == nprocs, jax.process_count()
ndev = len(jax.devices())
assert ndev == 2 * nprocs, ndev

# ---- the XLA path: histogram, bit counts, encode, assembly, decode ----
cfg = CodecConfig(block_bytes=64)
codec = ShardedCodec(make_mesh(), cfg)   # all 4 global devices
data = testdata.skewed(ndev * 3 * cfg.block_bytes + 29, num_symbols=16,
                       seed=7)
enc = codec.encode(data)
ref_bytes, ref_bits = golden.encode(data, enc.codebook)
assert enc.total_bits == ref_bits, (enc.total_bits, ref_bits)
assert np.array_equal(enc.stream_bytes, ref_bytes), \
    "multi-host stream not bit-exact vs golden"
assert np.array_equal(codec.decode(enc), data), "multi-host decode"

# ---- the GPU kernel (under the Pallas interpreter) in every shard ----
codec2 = ShardedCodec(make_mesh(), CodecConfig())
data2 = testdata.skewed(ndev * 6 * 1024 + 333, num_symbols=32, seed=8)
cb2 = Codebook.from_data(data2)
with mock.patch.object(backend, "encode_path",
                       lambda: backend.INTERPRET):
    enc2 = codec2.encode(data2, codebook=cb2)
ref2_bytes, ref2_bits = golden.encode(data2, cb2)
assert enc2.total_bits == ref2_bits, (enc2.total_bits, ref2_bits)
assert np.array_equal(enc2.stream_bytes, ref2_bytes), \
    "2-process kernel stream not bit-exact vs golden"
assert container.dumps(enc2) == container.dumps(
    api.encode(data2, codebook=cb2)), \
    "2-process container differs from the single-device one"

print("MULTIHOST-OK", flush=True)
