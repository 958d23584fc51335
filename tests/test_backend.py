"""backend.py: the one place that picks the implementation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from huffman_tpu import api, backend
from huffman_tpu.codebook import Codebook
from huffman_tpu.config import CodecConfig
from huffman_tpu.parallel.mesh import make_mesh
from huffman_tpu.parallel.pipeline import ShardedCodec
from huffman_tpu.utils import testdata


def test_cpu_selects_xla():
    assert backend.platform() == "cpu"
    assert backend.encode_path() == backend.XLA


def test_gpu_selects_kernel(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.platform() == "gpu"
    assert backend.encode_path() == backend.KERNEL


@pytest.mark.parametrize("name", ["neuron", "rocm", "METAL"])
def test_unknown_platform_raises(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    with pytest.raises(RuntimeError, match="not supported"):
        backend.platform()
    with pytest.raises(RuntimeError, match="not supported"):
        backend.encode_path()


@pytest.mark.parametrize("entry", ["encode", "decode", "decode_range",
                                   "sharded_encode"])
def test_entry_points_refuse_unknown_platform(monkeypatch, entry):
    data = testdata.skewed(3000, seed=1)
    enc = api.encode(data)
    monkeypatch.setattr(jax, "default_backend", lambda: "neuron")
    call = {
        "encode": lambda: api.encode(data),
        "decode": lambda: api.decode(enc),
        "decode_range": lambda: api.decode_range(enc, 0, 10),
        "sharded_encode": lambda: ShardedCodec(make_mesh(2)).encode(data),
    }[entry]
    with pytest.raises(RuntimeError, match="not supported"):
        call()


def test_unknown_path_raises():
    z = jnp.zeros((1, 4), jnp.uint8)
    i = jnp.zeros(1, jnp.int32)
    with pytest.raises(ValueError, match="unknown encode path"):
        backend.encode_stream("cuda", z, jnp.zeros(256, jnp.uint32),
                              jnp.zeros(256, jnp.int32), i, i, i, 2, 1)


@pytest.mark.parametrize("block_bytes", [256, 1024])
def test_paths_agree(block_bytes):
    """XLA and the kernel (interpreter) write the same stream."""
    cfg = CodecConfig(block_bytes=block_bytes)
    data = testdata.skewed(5 * block_bytes + 11, num_symbols=40, seed=2)
    blocks, n = api._as_blocks(data, cfg)
    valid = api.valid_per_block(n, blocks.shape[0], block_bytes)
    cb = Codebook.from_data(data, 12)
    bits = np.asarray(api._block_bits(jnp.asarray(blocks),
                                      jnp.asarray(cb.lengths),
                                      jnp.asarray(valid))[0])
    wb, sh = api.block_offsets(bits)
    args = (jnp.asarray(blocks), jnp.asarray(cb.codes),
            jnp.asarray(cb.lengths), jnp.asarray(valid), jnp.asarray(wb),
            jnp.asarray(sh), blocks.shape[0] * cfg.capacity_words + 1,
            cfg.capacity_words)
    np.testing.assert_array_equal(
        np.asarray(backend.encode_stream(backend.XLA, *args)),
        np.asarray(backend.encode_stream(backend.INTERPRET, *args)))


def test_api_encode_takes_the_chosen_path(monkeypatch):
    seen = []
    real = backend.encode_stream

    def spy(path, *a):
        seen.append(path)
        return real(path, *a)

    monkeypatch.setattr(backend, "encode_stream", spy)
    monkeypatch.setattr(backend, "encode_path", lambda: backend.INTERPRET)
    data = testdata.skewed(4000, seed=3)
    enc = api.encode(data)
    assert seen == [backend.INTERPRET]
    np.testing.assert_array_equal(api.decode(enc), data)
