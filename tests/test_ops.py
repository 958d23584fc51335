"""Device pipeline tests: bit-exactness vs the golden oracle.

The automated form of the reference's built-in golden differential test
(reference: main_test_cu.cu:159-172): device output compared word-for-word
with the CPU golden encoder, across sizes, distributions and block shapes —
plus roundtrip and histogram checks the reference never had.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from huffman_tpu import api
from huffman_tpu import golden
from huffman_tpu.codebook import Codebook
from huffman_tpu.config import CodecConfig
from huffman_tpu.golden.numpy_codec import packed_bytes_to_words
from huffman_tpu.ops import bitio, pack as pack_ops, encode as encode_ops
from huffman_tpu.ops import histogram as hist_ops
from huffman_tpu.ops.scan import exclusive_bit_offsets
from huffman_tpu.utils import testdata


def assert_bit_exact(enc: api.Encoded, data: np.ndarray):
    ref_bytes, ref_bits = golden.encode(data, enc.codebook)
    assert enc.total_bits == ref_bits
    ref_words = packed_bytes_to_words(ref_bytes)
    np.testing.assert_array_equal(enc.stream_words, ref_words)


class TestBitio:
    def test_safe_shifts(self):
        x = jnp.uint32(0xDEADBEEF)
        assert int(bitio.safe_shl(x, 0)) == 0xDEADBEEF
        assert int(bitio.safe_shl(x, 4)) == 0xEADBEEF0
        assert int(bitio.safe_shl(x, 32)) == 0
        assert int(bitio.safe_shr(x, 32)) == 0
        assert int(bitio.safe_shr(x, 16)) == 0xDEAD

    def test_code_word_parts_fits(self):
        p0, p1 = bitio.code_word_parts(jnp.uint32(0b101), 3, 0)
        assert int(p0) == 0b101 << 29 and int(p1) == 0

    def test_code_word_parts_split(self):
        # 8-bit code 0xAB starting at bit 28: 4 bits in word0, 4 in word1.
        p0, p1 = bitio.code_word_parts(jnp.uint32(0xAB), 8, 28)
        assert int(p0) == 0xA and int(p1) == 0xB0000000

    def test_zero_length_contributes_nothing(self):
        p0, p1 = bitio.code_word_parts(jnp.uint32(0xFF), 0, 13)
        assert int(p0) == 0 and int(p1) == 0

    def test_extract_window(self):
        w0, w1 = jnp.uint32(0x12345678), jnp.uint32(0x9ABCDEF0)
        assert int(bitio.extract_window(w0, w1, 0)) == 0x12345678
        assert int(bitio.extract_window(w0, w1, 16)) == 0x56789ABC


class TestEncodeBitExact:
    @pytest.mark.parametrize("n", [1, 3, 255, 1024, 1025, 4096, 65537, 200_000])
    def test_skewed(self, n):
        data = testdata.skewed(n, num_symbols=32, seed=n)
        enc = api.encode(data)
        assert_bit_exact(enc, data)

    @pytest.mark.parametrize("n", [64, 1000, 16384])
    def test_uniform_all_symbols(self, n):
        data = testdata.uniform_random(n, num_symbols=256, seed=n)
        # Uniform 256-symbol data doesn't compress: ratio 1 exactly fills
        # capacity; use a margin.
        cfg = CodecConfig(capacity_bits_per_byte=10)
        enc = api.encode(data, cfg)
        assert_bit_exact(enc, data)

    def test_rle(self):
        data = testdata.rle_runs(50_000, run_len=64, num_symbols=8, seed=2)
        enc = api.encode(data)
        assert_bit_exact(enc, data)

    def test_single_symbol(self):
        data = np.full(5000, 7, dtype=np.uint8)
        enc = api.encode(data)
        assert enc.total_bits == 5000
        assert_bit_exact(enc, data)

    def test_reference_fixture_profile(self):
        data = testdata.entropy_fixture(n=1 << 17)
        enc = api.encode(data)
        assert_bit_exact(enc, data)
        assert enc.ratio < 0.35  # ~2.2 bits/byte source

    @pytest.mark.parametrize("block_bytes", [64, 256, 1024, 4096])
    def test_block_sizes(self, block_bytes):
        data = testdata.skewed(10_000, num_symbols=32, seed=9)
        cfg = CodecConfig(block_bytes=block_bytes)
        enc = api.encode(data, cfg)
        assert_bit_exact(enc, data)

    def test_explicit_codebook(self):
        data = testdata.skewed(5000, num_symbols=16, seed=4)
        cb = testdata.dummy_codebook(16)
        enc = api.encode(data, codebook=cb)
        assert_bit_exact(enc, data)

    def test_foreign_symbol_rejected(self):
        cb = testdata.dummy_codebook(4)
        with pytest.raises(ValueError):
            api.encode(np.array([200], dtype=np.uint8), codebook=cb)

    def test_overflow_detected(self):
        # Build a skewed codebook, then encode a block made entirely of its
        # longest-code symbol: len > 8 bits/byte overflows ratio-1 capacity.
        train = testdata.skewed(50_000, num_symbols=32, decay=0.5, seed=1)
        cb = Codebook.from_data(train)
        rare = int(np.argmax(cb.lengths))
        assert cb.lengths[rare] > 8
        data = np.full(2048, rare, dtype=np.uint8)
        cfg = CodecConfig(capacity_bits_per_byte=8)
        with pytest.raises(OverflowError):
            api.encode(data, cfg, codebook=cb)

    def test_empty(self):
        enc = api.encode(b"")
        assert enc.total_bits == 0 and enc.n_bytes == 0
        assert api.decode(enc).size == 0


class TestScan:
    def test_offsets_match_cumsum(self):
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 8193, 1000).astype(np.int32)
        off = exclusive_bit_offsets(jnp.asarray(bits))
        ex = np.concatenate([[0], np.cumsum(bits.astype(np.int64))[:-1]])
        np.testing.assert_array_equal(np.asarray(off.word_base), ex >> 5)
        np.testing.assert_array_equal(np.asarray(off.bit_shift), ex & 31)
        total = int(bits.sum())
        assert (int(off.total_full_words) * 32 + int(off.total_rem_bits)) == total
        assert int(off.total_words) == -(-total // 32)


class TestPack:
    def test_matches_numpy_twin(self):
        rng = np.random.default_rng(5)
        nb, cap = 37, 8
        bits = rng.integers(0, cap * 32 + 1, nb).astype(np.int32)
        blocks = np.zeros((nb, cap), dtype=np.uint32)
        for b in range(nb):
            nbits = int(bits[b])
            raw = rng.integers(0, 1 << 32, cap, dtype=np.uint64)
            # zero bits past nbits (encoder guarantees this)
            for j in range(cap):
                lo = j * 32
                keep = min(max(nbits - lo, 0), 32)
                mask = ((1 << keep) - 1) << (32 - keep) if keep else 0
                blocks[b, j] = np.uint32(raw[j] & mask)
        stream, offsets = pack_ops.pack_blocks(jnp.asarray(blocks),
                                               jnp.asarray(bits))
        ref, total = pack_ops.pack_reference(blocks, bits)
        np.testing.assert_array_equal(np.asarray(stream), ref)


class TestDecode:
    @pytest.mark.parametrize("n", [1, 100, 1024, 1025, 50_000, 131072])
    def test_roundtrip(self, n):
        data = testdata.skewed(n, num_symbols=64, seed=n + 7)
        assert api.roundtrip_ok(data)

    def test_roundtrip_all_256(self):
        data = testdata.uniform_random(32768, num_symbols=256, seed=3)
        cfg = CodecConfig(capacity_bits_per_byte=12)
        enc = api.encode(data, cfg)
        np.testing.assert_array_equal(api.decode(enc), data)

    def test_roundtrip_small_blocks(self):
        data = testdata.skewed(9999, num_symbols=32, seed=12)
        cfg = CodecConfig(block_bytes=128)
        enc = api.encode(data, cfg)
        np.testing.assert_array_equal(api.decode(enc), data)

    def test_decode_matches_golden(self):
        data = testdata.skewed(20_000, num_symbols=48, seed=21)
        enc = api.encode(data)
        gd = golden.decode(enc.stream_bytes, enc.n_bytes, enc.codebook)
        np.testing.assert_array_equal(api.decode(enc), gd)

    @pytest.mark.parametrize("block_bytes,mcl", [(64, 12), (1000, 8),
                                                 (4096, 16)])
    def test_xla_decode_matches_golden_decode(self, block_bytes, mcl):
        """The XLA reader against golden.decode of the same stream."""
        data = testdata.skewed(33_333, num_symbols=100, decay=0.9, seed=22)
        cfg = CodecConfig(block_bytes=block_bytes, max_code_len=mcl,
                          capacity_bits_per_byte=16)
        enc = api.encode(data, cfg)
        gd = golden.decode(enc.stream_bytes, enc.n_bytes, enc.codebook)
        np.testing.assert_array_equal(gd, data)
        np.testing.assert_array_equal(api.decode(enc), gd)

    @pytest.mark.parametrize("start,stop", [
        (0, 1), (1023, 1025), (5000, 5000), (4096, 20_000), (19_999, 20_000)])
    def test_decode_range_matches_golden(self, start, stop):
        """decode_range == golden.decode started at the covering block's
        bit offset (the container's per-block counts)."""
        data = testdata.skewed(20_000, num_symbols=40, seed=23)
        enc = api.encode(data)
        b0 = start // 1024
        bit0 = int(np.asarray(enc.block_bits[:b0], np.int64).sum())
        gd = golden.decode(enc.stream_bytes, stop - b0 * 1024, enc.codebook,
                           bit_offset=bit0)
        np.testing.assert_array_equal(api.decode_range(enc, start, stop),
                                      gd[start - b0 * 1024:])


class TestBlockOffsets:
    @pytest.mark.parametrize("nb,maxbits", [(1, 0), (1000, 8192),
                                            (70_000, 4000)])
    def test_host_scan_matches_device_scan(self, nb, maxbits):
        rng = np.random.default_rng(nb)
        bits = rng.integers(0, maxbits + 1, nb).astype(np.int32)
        wb, sh = api.block_offsets(bits)
        off = exclusive_bit_offsets(jnp.asarray(bits))
        np.testing.assert_array_equal(wb, np.asarray(off.word_base))
        np.testing.assert_array_equal(sh, np.asarray(off.bit_shift))


def _hist(data, block_bytes=1024, n_valid=None):
    cfg = CodecConfig(block_bytes=block_bytes)
    blocks, n = api._as_blocks(data, cfg)
    valid = api.valid_per_block(n if n_valid is None else n_valid,
                                blocks.shape[0], block_bytes)
    return np.asarray(hist_ops.histogram(jnp.asarray(blocks),
                                         jnp.asarray(valid)))


class TestHistogram:
    @pytest.mark.parametrize("block_bytes", [64, 1000, 1024])
    def test_matches_host(self, block_bytes):
        data = testdata.uniform_random(100_000, seed=6)
        np.testing.assert_array_equal(_hist(data, block_bytes),
                                      golden.histogram(data))

    @pytest.mark.parametrize("n_valid", [0, 1, 7777])
    def test_respects_n_valid(self, n_valid):
        data = testdata.uniform_random(10_000, seed=8)
        h = _hist(data, n_valid=n_valid)
        np.testing.assert_array_equal(
            h, np.bincount(data[:n_valid], minlength=256))
        assert h.sum() == n_valid

    def test_per_block_valid_counts(self):
        """Zero counts leave whole blocks out (sampling, mesh padding)."""
        data = testdata.uniform_random(8 * 256, seed=9)
        blocks = data.reshape(8, 256)
        valid = np.array([256, 0, 256, 0, 100, 0, 0, 256], np.int32)
        h = np.asarray(hist_ops.histogram(jnp.asarray(blocks),
                                          jnp.asarray(valid)))
        want = sum(np.bincount(blocks[i, :v], minlength=256)
                   for i, v in enumerate(valid))
        np.testing.assert_array_equal(h, want)

    def test_empty_counts(self):
        h = np.asarray(hist_ops.histogram(jnp.zeros((0, 1024), jnp.uint8),
                                          jnp.zeros(0, jnp.int32)))
        assert h.shape == (256,) and h.sum() == 0
