"""Multi-device data-parallel pipeline tests on the virtual 8-device CPU mesh.

SURVEY.md section 4's prescription: multi-device logic tested without a
cluster — the same mesh/shard_map code that runs on the cards runs here
over 8 virtual CPU devices.  Key property: sharded output is bit-identical
to the single-device pipeline and the golden codec, for every mesh size.
"""

import jax
import numpy as np
import pytest

from huffman_tpu import api, container, golden, verify
from huffman_tpu.codebook import Codebook
from huffman_tpu.config import CodecConfig
from huffman_tpu.parallel.mesh import make_mesh
from huffman_tpu.parallel.pipeline import ShardedCodec, histogram_sharded
from huffman_tpu.utils import testdata


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return make_mesh(8)


class TestShardedHistogram:
    def test_matches_host(self, mesh8):
        codec = ShardedCodec(mesh8)
        data = testdata.uniform_random(100_000, seed=1)
        blocks, valid, n = codec.prepare(data)
        d_blocks, d_valid = codec.shard_inputs(blocks, valid)
        rows = np.asarray(histogram_sharded(mesh8)(d_blocks, d_valid))
        assert rows.shape == (8, 256)
        np.testing.assert_array_equal(rows.sum(axis=0),
                                      np.bincount(data, minlength=256))
        np.testing.assert_array_equal(codec.histogram(d_blocks, valid),
                                      np.bincount(data, minlength=256))

    def test_sampled_codebook_matches_single_device(self, mesh8,
                                                    monkeypatch):
        """Above SAMPLE_MIN_BYTES both paths histogram the same global
        every-k-th blocks, so they build the same codebook."""
        monkeypatch.setattr(api, "SAMPLE_MIN_BYTES", 8 * 1024)
        monkeypatch.setattr(api, "SAMPLE_EVERY", 4)
        data = testdata.skewed(77 * 1024 + 5, num_symbols=48, seed=2)
        enc1 = api.encode(data)
        enc8 = ShardedCodec(mesh8).encode(data)
        np.testing.assert_array_equal(enc1.codebook.lengths,
                                      enc8.codebook.lengths)
        assert container.dumps(enc1) == container.dumps(enc8)


class TestShardedEncode:
    @pytest.mark.parametrize("ndev", [1, 2, 8])
    @pytest.mark.parametrize("n", [1024, 100_000, 131072])
    def test_bit_exact_vs_golden(self, ndev, n):
        mesh = make_mesh(ndev)
        data = testdata.skewed(n, num_symbols=32, seed=n + ndev)
        codec = ShardedCodec(mesh)
        enc = codec.encode(data)
        ref_bytes, ref_bits = golden.encode(data, enc.codebook)
        assert enc.total_bits == ref_bits
        from huffman_tpu.golden.numpy_codec import packed_bytes_to_words
        np.testing.assert_array_equal(enc.stream_words,
                                      packed_bytes_to_words(ref_bytes))

    def test_matches_single_chip(self, mesh8):
        data = testdata.skewed(50_000, num_symbols=48, seed=3)
        cb = Codebook.from_data(data)
        enc1 = api.encode(data, codebook=cb)
        enc8 = ShardedCodec(mesh8).encode(data, codebook=cb)
        assert enc1.total_bits == enc8.total_bits
        np.testing.assert_array_equal(enc1.stream_words, enc8.stream_words)
        np.testing.assert_array_equal(enc1.block_bits, enc8.block_bits)

    def test_uneven_tail(self, mesh8):
        # Input not divisible by block size nor by mesh size.
        data = testdata.skewed(12_345, num_symbols=16, seed=4)
        enc = ShardedCodec(mesh8).encode(data)
        assert verify.verify_encoded(enc, data)

    def test_small_input_fewer_blocks_than_devices(self, mesh8):
        data = testdata.skewed(100, num_symbols=8, seed=5)
        enc = ShardedCodec(mesh8).encode(data)
        assert verify.verify_encoded(enc, data)


class TestShardedKernel:
    """The GPU kernel (Pallas interpreter) inside shard_map: each shard
    encodes into its own buffer at host-scanned local offsets, and the
    assembled stream is bit-exact against golden and the single-device
    container."""

    @pytest.mark.parametrize("ndev", [2, 8])
    @pytest.mark.parametrize("n", [48 * 1024, 48 * 1024 + 333])
    def test_bit_exact_vs_golden(self, kernel_interpret, ndev, n):
        data = testdata.skewed(n, num_symbols=32, seed=21 + ndev)
        cb = Codebook.from_data(data)
        enc = ShardedCodec(make_mesh(ndev)).encode(data, codebook=cb)
        ref_bytes, ref_bits = golden.encode(data, cb)
        assert enc.total_bits == ref_bits
        from huffman_tpu.golden.numpy_codec import packed_bytes_to_words
        np.testing.assert_array_equal(enc.stream_words,
                                      packed_bytes_to_words(ref_bytes))
        assert container.dumps(enc) == container.dumps(
            api.encode(data, codebook=cb))

    def test_empty_shards(self, kernel_interpret, mesh8):
        # 3 blocks on 8 devices: five shards encode nothing
        data = testdata.skewed(2 * 1024 + 100, num_symbols=8, seed=5)
        enc = ShardedCodec(mesh8).encode(data)
        assert verify.verify_encoded(enc, data)


class TestShardedDecode:
    @pytest.mark.parametrize("ndev", [2, 8])
    def test_roundtrip(self, ndev):
        mesh = make_mesh(ndev)
        codec = ShardedCodec(mesh)
        data = testdata.skewed(77_777, num_symbols=64, seed=6 + ndev)
        enc = codec.encode(data)
        np.testing.assert_array_equal(codec.decode(enc), data)

    def test_sharded_decode_of_single_chip_encode(self, mesh8):
        data = testdata.rle_runs(30_000, seed=7)
        enc = api.encode(data)
        np.testing.assert_array_equal(ShardedCodec(mesh8).decode(enc), data)

    def test_small_block_config(self, mesh8):
        cfg = CodecConfig(block_bytes=256)
        codec = ShardedCodec(mesh8, cfg)
        data = testdata.skewed(10_000, num_symbols=32, seed=9)
        enc = codec.encode(data)
        np.testing.assert_array_equal(codec.decode(enc), data)


class TestShardedMissingSymbol:
    """ShardedCodec.encode shares api.encode's missing-symbol contract
    (round-4: it previously skipped the check entirely)."""

    def test_pallas_path_raises(self, kernel_interpret, mesh8):
        cb = testdata.dummy_codebook(4)
        data = testdata.skewed(40_000, num_symbols=4, seed=12)
        data[17_000] = 200
        with pytest.raises(ValueError, match="absent from the codebook"):
            ShardedCodec(mesh8).encode(data, codebook=cb)

    def test_xla_path_raises(self, mesh8):
        cb = testdata.dummy_codebook(4)
        data = testdata.skewed(40_000, num_symbols=4, seed=12)
        data[17_000] = 200
        with pytest.raises(ValueError, match="absent from the codebook"):
            ShardedCodec(mesh8).encode(data, codebook=cb)

    def test_clean_input_passes(self, kernel_interpret, mesh8):
        cb = testdata.dummy_codebook(4)
        data = testdata.skewed(40_000, num_symbols=4, seed=12)
        enc = ShardedCodec(mesh8).encode(data, codebook=cb)
        ref_bytes, ref_bits = golden.encode(data, cb)
        assert enc.total_bits == ref_bits
