"""The fused encode+pack GPU kernel (ops/pallas/encode_pack.py).

On the CPU the kernel runs under the Pallas interpreter and is checked
bit for bit against the golden codec and the plain XLA path
(ops/encode.encode_blocks + ops/pack.pack_at_offsets): entropy, every
code-length cap, partial and zero-valid blocks, blocks exactly at
capacity, block widths that are not powers of two, and the wrapper's
padding.  The tests marked `gpu` run the compiled kernel on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from huffman_tpu import api, backend, golden
from huffman_tpu.codebook import Codebook
from huffman_tpu.config import CodecConfig
from huffman_tpu.golden.numpy_codec import packed_bytes_to_words
from huffman_tpu.ops.pallas import encode_pack as ep
from huffman_tpu.utils import testdata


def encode_blocks_at(path, blocks, valid, cb, cfg, word0=0, shift0=0):
    """Both passes over host blocks, the stream starting at (word0,
    shift0); returns (stream, bits)."""
    d_blocks = jnp.asarray(blocks)
    d_valid = jnp.asarray(valid)
    bits, missing = ep.block_bits(d_blocks, jnp.asarray(cb.lengths),
                                  d_valid)
    bits = np.asarray(bits)
    assert not np.asarray(missing).any()
    starts = np.cumsum(bits.astype(np.int64)) - bits + shift0
    stream = backend.encode_stream(
        path, d_blocks, jnp.asarray(cb.codes), jnp.asarray(cb.lengths),
        d_valid, jnp.asarray((starts >> 5) + word0, dtype=jnp.int32),
        jnp.asarray(starts & 31, dtype=jnp.int32),
        word0 + blocks.shape[0] * cfg.capacity_words + 2,
        cfg.capacity_words)
    return np.asarray(stream), bits


def check_vs_golden(data, cfg=CodecConfig(), cb=None):
    """Kernel (interpreter) over `data` == golden, word for word."""
    blocks, n = api._as_blocks(data, cfg)
    valid = api.valid_per_block(n, blocks.shape[0], cfg.block_bytes)
    cb = cb or Codebook.from_data(data, cfg.max_code_len)
    stream, bits = encode_blocks_at(backend.INTERPRET, blocks, valid, cb,
                                    cfg)
    ref_bytes, ref_bits = golden.encode(data, cb)
    assert int(bits.astype(np.int64).sum()) == ref_bits
    ref = packed_bytes_to_words(ref_bytes)
    np.testing.assert_array_equal(stream[: ref.size], ref)
    assert not stream[ref.size:].any(), "words past the stream are zero"
    return cb, bits


@pytest.mark.parametrize("profile", ["single", "skewed", "log2",
                                     "uniform16", "rle"])
def test_matches_golden_by_entropy(profile):
    n = 9 * 1024 + 77
    data = {
        "single": lambda: np.full(n, 7, np.uint8),
        "skewed": lambda: testdata.skewed(n, num_symbols=32, seed=1),
        "log2": lambda: np.asarray(testdata.log2_skewed_device(n, 2)),
        "uniform16": lambda: testdata.uniform_random(n, 16, seed=3),
        "rle": lambda: testdata.rle_runs(n, seed=4),
    }[profile]()
    check_vs_golden(data)


@pytest.mark.parametrize("cap", list(range(1, 13)))
def test_code_length_caps(cap):
    """Every code-length cap 1..12: the codebook reaches the cap."""
    m = min(1 << cap, 256)
    data = testdata.skewed(6 * 1024 + 5, num_symbols=m, decay=0.5,
                           seed=cap)
    data[:m] = np.arange(m)                 # every symbol present
    cfg = CodecConfig(max_code_len=cap)
    cb = Codebook.from_data(data, cap)
    assert cb.max_len == cap
    check_vs_golden(data, cfg, cb)


@pytest.mark.parametrize("cap", [16, 20, 24])
def test_long_code_caps(cap):
    """Codes up to the config's 24-bit limit: Fibonacci frequencies make
    Huffman want a code per level, so the cap binds."""
    fib = [1, 1]
    while len(fib) < 26:
        fib.append(fib[-1] + fib[-2])
    rng = np.random.default_rng(cap)
    data = rng.permutation(np.repeat(np.arange(26, dtype=np.uint8), fib))
    cfg = CodecConfig(max_code_len=cap, capacity_bits_per_byte=cap)
    cb = Codebook.from_data(data, cap)
    assert cb.max_len == cap
    check_vs_golden(data, cfg, cb)


@pytest.mark.parametrize("n", [1, 3, 1023, 1025, 4097, 8191])
def test_partial_last_block(n):
    check_vs_golden(testdata.skewed(n, num_symbols=24, seed=n))


def test_zero_valid_padding_blocks():
    """Blocks with no valid bytes (mesh padding) write nothing, wherever
    they sit."""
    cfg = CodecConfig(block_bytes=256)
    rng = np.random.default_rng(5)
    blocks = rng.integers(0, 20, size=(9, 256)).astype(np.uint8)
    valid = np.array([256, 0, 0, 256, 17, 0, 256, 0, 0], np.int32)
    data = np.concatenate([blocks[i, :v] for i, v in enumerate(valid)])
    cb = Codebook.from_data(data, 12)
    stream, bits = encode_blocks_at(backend.INTERPRET, blocks, valid, cb,
                                    cfg)
    assert (bits[valid == 0] == 0).all()
    ref_bytes, ref_bits = golden.encode(data, cb)
    ref = packed_bytes_to_words(ref_bytes)
    np.testing.assert_array_equal(stream[: ref.size], ref)
    assert not stream[ref.size:].any()


@pytest.mark.parametrize("block_bytes", [256, 1024])
def test_blocks_exactly_at_capacity(block_bytes):
    """All 256 symbols at 8 bits: every full block fills its capacity
    (8 bits/byte) exactly, and every block starts word-aligned."""
    cfg = CodecConfig(block_bytes=block_bytes)
    data = testdata.uniform_random(5 * block_bytes, 256, seed=6)
    data[:256] = np.arange(256)
    cb = Codebook.from_lengths(np.full(256, 8))
    _, bits = check_vs_golden(data, cfg, cb)
    assert (bits == cfg.capacity_words * 32).all()


@pytest.mark.parametrize("where", ["first", "last_valid", "padding"])
def test_missing_flag(where):
    """block_bits flags exactly the blocks with a valid uncoded byte."""
    cfg = CodecConfig()
    data = testdata.skewed(3 * 1024 + 500, num_symbols=16, seed=7)
    cb = Codebook.from_data(data, 12)
    blocks, n = api._as_blocks(data, cfg)
    valid = api.valid_per_block(n, blocks.shape[0], cfg.block_bytes)
    want = np.zeros(blocks.shape[0], bool)
    if where == "first":
        blocks[1, 0] = 200
        want[1] = True
    elif where == "last_valid":
        blocks[3, valid[3] - 1] = 200
        want[3] = True
    else:
        blocks[3, valid[3]] = 200           # past the valid bytes
    _, missing = ep.block_bits(jnp.asarray(blocks), jnp.asarray(cb.lengths),
                               jnp.asarray(valid))
    np.testing.assert_array_equal(np.asarray(missing), want)


@pytest.mark.parametrize("block_bytes", [4, 64, 100, 256, 1000, 4096])
def test_block_widths(block_bytes):
    """Widths that are not powers of two are padded to one."""
    cfg = CodecConfig(block_bytes=block_bytes)
    check_vs_golden(testdata.skewed(7 * block_bytes + 3, seed=block_bytes),
                    cfg)


@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_rows_per_program(monkeypatch, rows):
    """Block counts that are not a multiple of the program's rows get
    zero-valid padding rows."""
    monkeypatch.setattr(ep, "ROWS_PER_PROGRAM", rows)
    cfg = CodecConfig(block_bytes=128)
    data = testdata.skewed(11 * 128 + 9, num_symbols=12, seed=rows)
    blocks, n = api._as_blocks(data, cfg)
    valid = api.valid_per_block(n, blocks.shape[0], 128)
    cb = Codebook.from_data(data, 12)
    bits = np.asarray(ep.block_bits(jnp.asarray(blocks),
                                    jnp.asarray(cb.lengths),
                                    jnp.asarray(valid))[0])
    starts = np.cumsum(bits.astype(np.int64)) - bits
    # the unjitted wrapper traces anew, at this ROWS_PER_PROGRAM
    out = np.asarray(ep.encode_pack.__wrapped__(
        jnp.asarray(blocks), jnp.asarray(cb.codes), jnp.asarray(cb.lengths),
        jnp.asarray(valid), jnp.asarray(starts >> 5, dtype=jnp.int32),
        jnp.asarray(starts & 31, dtype=jnp.int32), out_words=11 * 32 + 2,
        capacity_words=32, interpret=True))
    assert out.shape == (11 * 32 + 2,) and out.dtype == np.uint32
    ref_bytes, _ = golden.encode(data, cb)
    ref = packed_bytes_to_words(ref_bytes)
    np.testing.assert_array_equal(out[: ref.size], ref)


@pytest.mark.parametrize("word0,shift0", [(0, 0), (3, 17), (5, 31)])
def test_offset_start_matches_xla(word0, shift0):
    """A stream starting mid-buffer (a shard's local start) matches the
    XLA path bit for bit."""
    cfg = CodecConfig(block_bytes=512)
    data = testdata.skewed(6 * 512 + 100, num_symbols=40, seed=word0)
    blocks, n = api._as_blocks(data, cfg)
    valid = api.valid_per_block(n, blocks.shape[0], 512)
    cb = Codebook.from_data(data, 12)
    kern, _ = encode_blocks_at(backend.INTERPRET, blocks, valid, cb, cfg,
                               word0, shift0)
    ref, _ = encode_blocks_at(backend.XLA, blocks, valid, cb, cfg,
                              word0, shift0)
    np.testing.assert_array_equal(kern, ref)
    assert not kern[:word0].any()


@pytest.mark.parametrize("block_bytes", [64, 1000, 1024, 4096])
def test_block_bits_match_encode_blocks(block_bytes):
    from huffman_tpu.ops import encode as encode_ops
    cfg = CodecConfig(block_bytes=block_bytes)
    data = testdata.skewed(5 * block_bytes + 7, num_symbols=64, seed=8)
    blocks, n = api._as_blocks(data, cfg)
    valid = jnp.asarray(api.valid_per_block(n, blocks.shape[0],
                                            block_bytes))
    cb = Codebook.from_data(data, 12)
    args = (jnp.asarray(blocks), jnp.asarray(cb.codes),
            jnp.asarray(cb.lengths), valid)
    _, ref = encode_ops.encode_blocks(*args, cfg.capacity_words)
    bits, _ = ep.block_bits(args[0], args[2], valid)
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(ref))


@pytest.mark.gpu
@pytest.mark.parametrize("n,nsym", [(1, 2), (3 * 1024 + 5, 30),
                                    (257 * 1024 + 99, 256)])
def test_compiled_kernel_matches_xla(gpu_device, n, nsym):
    """The kernel as compiled for the card == the XLA path."""
    cfg = CodecConfig(capacity_bits_per_byte=12)
    data = testdata.skewed(n, num_symbols=nsym, decay=0.9, seed=n)
    blocks, n = api._as_blocks(data, cfg)
    valid = api.valid_per_block(n, blocks.shape[0], cfg.block_bytes)
    cb = Codebook.from_data(data, 12)
    kern, _ = encode_blocks_at(backend.KERNEL, blocks, valid, cb, cfg)
    ref, _ = encode_blocks_at(backend.XLA, blocks, valid, cb, cfg)
    np.testing.assert_array_equal(kern, ref)


def test_rejects_int32_index_overflow():
    """Run slots and stream words are int32-indexed: a call that would
    need more raises before allocating anything."""
    z = jnp.zeros((2, 4), jnp.uint8)
    i = jnp.zeros(2, jnp.int32)
    with pytest.raises(ValueError, match="int32"):
        ep.encode_pack(z, jnp.zeros(256, jnp.uint32),
                       jnp.zeros(256, jnp.int32), i, i, i, out_words=4,
                       capacity_words=1 << 30, interpret=True)
