"""Sampled codebook build + exact missing-symbol detection.

Above api.SAMPLE_MIN_BYTES api.encode histograms every SAMPLE_EVERY-th
block only; the block bit-count pass flags every block holding a valid
byte without a code, and api.encode then rebuilds from the full
histogram (speculate-and-check).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from huffman_tpu import api, golden
from huffman_tpu.codebook import Codebook
from huffman_tpu.config import CodecConfig
from huffman_tpu.golden.numpy_codec import packed_bytes_to_words
from huffman_tpu.ops.pallas.encode_pack import block_bits


@pytest.fixture
def kernel_calls(kernel_interpret, monkeypatch):
    """The kernel path (interpreter) with its block_bits passes counted."""
    calls = {"encode": []}
    real = api._block_bits

    def counted(*a):
        calls["encode"].append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(api, "_block_bits", counted)
    return calls


@pytest.fixture
def small_sampling(monkeypatch):
    """Make tiny suite inputs take the sampled path: sample every 4th
    block above 8 KiB."""
    monkeypatch.setattr(api, "SAMPLE_MIN_BYTES", 8 * 1024)
    monkeypatch.setattr(api, "SAMPLE_EVERY", 4)


def _check_vs_golden(data, enc):
    ref_bytes, ref_bits = golden.encode(data, enc.codebook)
    assert enc.total_bits == ref_bits
    assert np.array_equal(
        enc.stream_words,
        packed_bytes_to_words(ref_bytes)[: len(enc.stream_words)])


def test_build_codebook_sampled(rng):
    data = (rng.geometric(0.4, size=32 * 1024 + 321) % 32).astype(np.uint8)
    cfg = CodecConfig()
    cb_s = api.build_codebook(data, cfg, use_device=False, sample_every=4)
    cb_x = api.build_codebook(data, cfg, use_device=False)
    # sampling can only MISS symbols, never invent them
    assert set(np.nonzero(cb_s.lengths)[0]) <= set(
        np.nonzero(cb_x.lengths)[0])
    # the hot symbols are always in the sample (geometric support is 1+)
    assert cb_s.lengths[1] > 0 and cb_s.lengths[2] > 0
    # device and host sampled histograms agree
    cb_d = api.build_codebook(data, cfg, use_device=True, sample_every=4)
    assert np.array_equal(cb_s.lengths, cb_d.lengths)


def test_kernel_detect_missing_exact():
    """The missing flag marks exactly the blocks containing an uncoded
    valid byte; padding bytes never flag."""
    rng = np.random.default_rng(5)
    data = rng.integers(0, 16, size=8 * 1024 + 100).astype(np.uint8)
    data[3 * 1024 + 7] = 200          # uncoded symbol in block 3 only
    cb = Codebook.from_data(np.concatenate(
        [data[: 3 * 1024], data[4 * 1024:]]))   # build WITHOUT block 3
    assert cb.lengths[200] == 0
    cfg = CodecConfig()
    blocks, n = api._as_blocks(data, cfg)
    valid = api.valid_per_block(n, blocks.shape[0], cfg.block_bytes)
    _, missing = block_bits(jnp.asarray(blocks), jnp.asarray(cb.lengths),
                            jnp.asarray(valid))
    want = np.zeros(blocks.shape[0], bool)
    want[3] = True
    assert np.array_equal(np.asarray(missing), want)


def test_api_sampled_holds(kernel_calls, small_sampling, rng):
    """Stationary stream: the sampled codebook covers every symbol, one
    encode pass, bit-exact."""
    data = (rng.geometric(0.4, size=48 * 1024 + 37) % 8).astype(np.uint8)
    enc = api.encode(data, CodecConfig())
    assert len(kernel_calls["encode"]) == 1   # no full-rebuild extra pass
    _check_vs_golden(data, enc)


def test_api_sampled_miss_rebuilds(kernel_calls, small_sampling):
    """A symbol appearing ONLY outside the sampled blocks triggers the
    exact rebuild; output is bit-exact under the exact codebook."""
    rng = np.random.default_rng(9)
    data = (rng.geometric(0.4, size=48 * 1024 + 11) % 32).astype(np.uint8)
    # SAMPLE_EVERY=4 samples blocks 0,4,8...; poison blocks 1..3 only
    data[1 * 1024: 1 * 1024 + 64] = 201
    data[2 * 1024: 2 * 1024 + 64] = 202
    enc = api.encode(data, CodecConfig())
    assert enc.codebook.lengths[201] > 0 and enc.codebook.lengths[202] > 0
    # at least one extra encode pass happened (the rebuild redo)
    assert len(kernel_calls["encode"]) >= 2
    _check_vs_golden(data, enc)
