"""Container format + CLI + verify + models + utils tests."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from huffman_tpu import api, container, verify
from huffman_tpu.codebook import Codebook
from huffman_tpu.config import CodecConfig
from huffman_tpu.models import CanonicalHuffman, FixedCodebook
from huffman_tpu.utils import printers, stats, testdata


class TestContainer:
    def test_roundtrip_memory(self):
        data = testdata.skewed(10_000, num_symbols=32, seed=1)
        enc = api.encode(data)
        enc2 = container.loads(container.dumps(enc))
        assert enc2.n_bytes == enc.n_bytes
        assert enc2.total_bits == enc.total_bits
        np.testing.assert_array_equal(enc2.stream_words, enc.stream_words)
        np.testing.assert_array_equal(enc2.block_bits, enc.block_bits)
        np.testing.assert_array_equal(enc2.codebook.codes, enc.codebook.codes)
        np.testing.assert_array_equal(api.decode(enc2), data)

    def test_roundtrip_file(self, tmp_path):
        data = testdata.rle_runs(5000, seed=2)
        enc = api.encode(data)
        p = str(tmp_path / "x.htz")
        container.dump(enc, p)
        enc2 = container.load(p)
        np.testing.assert_array_equal(api.decode(enc2), data)

    def test_bad_magic(self):
        with pytest.raises(ValueError, match="magic"):
            container.loads(b"NOPE" + b"\x00" * 64)

    def test_truncation_fuzz(self):
        """Every strict prefix of a valid container fails CLEANLY
        (ValueError/struct.error), never decodes garbage or crashes —
        the failure-detection contract of the self-describing header."""
        import struct
        data = testdata.skewed(4000, num_symbols=16, seed=13)
        blob = container.dumps(api.encode(data))
        for cut in (0, 3, 4, 11, len(blob) // 2, len(blob) - 1):
            with pytest.raises((ValueError, struct.error)):
                container.loads(blob[:cut])

    def test_corrupt_header_fields(self):
        """Flipped header fields are rejected, not mis-parsed."""
        data = testdata.skewed(4000, num_symbols=16, seed=14)
        blob = bytearray(container.dumps(api.encode(data)))
        bad_ver = bytes(blob[:4]) + (99).to_bytes(4, "little") + bytes(
            blob[8:])
        with pytest.raises(ValueError, match="version"):
            container.loads(bad_ver)

    def test_wide_truncation_fuzz(self):
        import struct
        from wide_v3 import dumps_v3, encode_v3
        data = testdata.skewed(5000, num_symbols=16, seed=15)
        blob = dumps_v3(encode_v3(data))
        for cut in (0, 7, 32, len(blob) // 2, len(blob) - 1):
            with pytest.raises((ValueError, struct.error)):
                container.loads_wide(blob[:cut])

    def test_payload_crc_catches_corruption(self):
        """A flipped payload bit is a clean error, not silent garbage
        (flags bit 0 CRC, VERDICT r4 item 9)."""
        data = testdata.skewed(4000, num_symbols=16, seed=16)
        blob = bytearray(container.dumps(api.encode(data)))
        pay0 = container.overhead_bytes(
            len(api.encode(data).block_bits))
        blob[pay0 + 5] ^= 0x10
        with pytest.raises(ValueError, match="CRC"):
            container.loads(bytes(blob))

    def test_payload_crc_wide(self):
        from wide_v3 import dumps_v3, encode_v3
        data = testdata.skewed(5000, num_symbols=16, seed=17)
        enc = encode_v3(data)
        blob = bytearray(dumps_v3(enc))
        blob[-6] ^= 0x01          # inside the payload, before the CRC
        with pytest.raises(ValueError, match="CRC"):
            container.loads_wide(bytes(blob))
        # and the untampered blob still loads
        container.loads_wide(bytes(dumps_v3(enc)))

    def test_crcless_container_still_loads(self):
        """Pre-r5 containers (flags=0, no trailing CRC) remain readable."""
        import struct
        data = testdata.skewed(3000, num_symbols=16, seed=18)
        enc = api.encode(data)
        blob = bytearray(container.dumps(enc)[:-4])   # strip CRC
        struct.pack_into("<I", blob, 8, 0)            # clear flags
        enc2 = container.loads(bytes(blob))
        np.testing.assert_array_equal(api.decode(enc2), data)

    def test_nondefault_config_preserved(self):
        data = testdata.skewed(3000, seed=3)
        cfg = CodecConfig(block_bytes=256, max_code_len=12)
        enc = api.encode(data, cfg)
        enc2 = container.loads(container.dumps(enc))
        assert enc2.config.block_bytes == 256
        assert enc2.config.max_code_len == 12
        np.testing.assert_array_equal(api.decode(enc2), data)

    def test_payload_is_msb_first_bytes(self):
        data = testdata.skewed(1000, seed=4)
        enc = api.encode(data)
        blob = container.dumps(enc)
        payload = blob[container.overhead_bytes(len(enc.block_bits)):]
        sbytes = enc.stream_bytes
        assert payload[: len(sbytes)] == sbytes.tobytes()


class TestLegacyWide:
    """Version-3 containers written by earlier releases stay readable:
    loaded by container.load, decoded on the host by the spec decoder."""

    @pytest.mark.parametrize("n,nsym,mcl", [
        (1, 4, 12), (5000, 16, 12), (262_144, 32, 12),   # one full tile
        (300_000, 64, 12),                               # two tiles
        (70_000, 200, 10), (9_000, 3, 4)])
    def test_load_and_decode(self, tmp_path, n, nsym, mcl):
        from wide_v3 import dumps_v3, encode_v3
        data = testdata.skewed(n, num_symbols=nsym, seed=n)
        p = tmp_path / "legacy.htz"
        p.write_bytes(dumps_v3(encode_v3(data, mcl)))
        enc = container.load(str(p))
        assert isinstance(enc, container.WideEncoded)
        assert enc.n_bytes == n
        np.testing.assert_array_equal(container.decode_wide(enc), data)

    def test_crcless_v3_loads(self):
        from wide_v3 import dumps_v3, encode_v3
        data = testdata.skewed(3000, num_symbols=16, seed=19)
        enc = container.loads_wide(dumps_v3(encode_v3(data),
                                            checksum=False))
        np.testing.assert_array_equal(container.decode_wide(enc), data)

    def test_rejects_foreign_tile_size(self):
        import struct
        from wide_v3 import dumps_v3, encode_v3
        blob = bytearray(dumps_v3(encode_v3(
            testdata.skewed(100, num_symbols=4, seed=1))))
        struct.pack_into("<I", blob, 20, 1024)       # block_bytes field
        with pytest.raises(ValueError, match="tile size"):
            container.loads_wide(bytes(blob))


class TestVerify:
    def test_pass(self):
        data = testdata.skewed(5000, seed=5)
        enc = api.encode(data)
        assert verify.verify_encoded(enc, data)
        assert verify.verify_roundtrip(enc, data)

    def test_fail_detected(self):
        data = testdata.skewed(5000, seed=6)
        enc = api.encode(data)
        tampered = enc.stream_words.copy()
        tampered[0] ^= 1 << 7
        import dataclasses
        bad = dataclasses.replace(enc, stream_words=tampered)
        res = verify.verify_encoded(bad, data)
        assert not res and "word 0" in res.detail


class TestModels:
    def test_canonical_huffman_model(self):
        data = testdata.skewed(4000, seed=7)
        m = CanonicalHuffman(use_device_histogram=False)
        cb = m.codebook_for(data)
        enc = api.encode(data, codebook=cb)
        assert verify.verify_encoded(enc, data)

    def test_fixed_codebook_model(self):
        train = testdata.skewed(10_000, num_symbols=64, seed=8)
        m = FixedCodebook.train(train)
        assert not m.needs_histogram
        # Smoothing means *any* bytes are encodable, even unseen ones.
        data = testdata.uniform_random(2000, num_symbols=256, seed=9)
        cfg = CodecConfig(capacity_bits_per_byte=20)
        enc = api.encode(data, cfg, codebook=m.codebook_for(data))
        np.testing.assert_array_equal(api.decode(enc), data)


class TestCLI:
    def _run(self, *args, cwd):
        env = dict(os.environ,
                   JAX_PLATFORMS="cpu",
                   PYTHONPATH="/root/repo")
        return subprocess.run(
            [sys.executable, "-m", "huffman_tpu", *args],
            capture_output=True, text=True, cwd=cwd, env=env)

    def test_encode_decode_files(self, tmp_path):
        src = tmp_path / "input.bin"
        data = testdata.skewed(20_000, num_symbols=32, seed=10)
        src.write_bytes(data.tobytes())
        r = self._run("encode", str(src), "--verify", cwd=tmp_path)
        assert r.returncode == 0, r.stderr
        assert "PASS" in r.stdout
        r = self._run("decode", str(src) + ".htz",
                      "-o", str(tmp_path / "out.bin"), cwd=tmp_path)
        assert r.returncode == 0, r.stderr
        assert (tmp_path / "out.bin").read_bytes() == data.tobytes()

    def test_info_and_roundtrip(self, tmp_path):
        src = tmp_path / "input.bin"
        src.write_bytes(testdata.rle_runs(8192, seed=11).tobytes())
        r = self._run("roundtrip", str(src), cwd=tmp_path)
        assert r.returncode == 0, r.stderr
        assert r.stdout.count("PASS") == 2
        self._run("encode", str(src), cwd=tmp_path)
        r = self._run("info", str(src) + ".htz", cwd=tmp_path)
        assert r.returncode == 0 and "blocks" in r.stdout


class TestStatsLogger:
    def test_gbps_formula(self):
        # Reference formula: (MB*1000)/(ms*1024)  (stats_logger.h:42)
        assert abs(stats.gb_per_s(1024.0, 1000.0) - 1.0) < 1e-12

    def test_series_files(self, tmp_path):
        lg = stats.StatsLogger(str(tmp_path), run_name="t")
        lg.log_rate("encode", 100.0, 50.0, chips=1)
        rec = json.loads(open(lg.jsonl_path).read().splitlines()[0])
        assert rec["series"] == "encode" and rec["gbps"] > 0
        series = (tmp_path / "graph__encode__rate_series.txt").read_text()
        assert series.startswith("#") and "\t" in series.splitlines()[1]


class TestPrinters:
    def test_bits32(self):
        assert printers.bits32(0x80000001) == "1" + "0" * 30 + "1"

    def test_diff_words(self):
        a = np.array([1, 2, 3], np.uint32)
        b = np.array([1, 9, 3], np.uint32)
        assert "word 1" in printers.diff_words(a, b)
        assert printers.diff_words(a, a) == "streams identical"

    def test_format_codebook(self):
        cb = Codebook.from_data(b"aabbbc")
        s = printers.format_codebook(cb)
        assert "'a'" in s and "'b'" in s and "'c'" in s
