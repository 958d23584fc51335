"""CLI driver coverage (reference analogue: main_test_cu.cu:41-52 —
everything reachable from argv).

Runs cli.main() in-process on the 8-device virtual CPU mesh from
conftest.  Covers the --mesh flag (ShardedCodec reachable from argv,
round-trips bit-exactly vs golden), legacy version-3 containers, and the
encode/decode/roundtrip/info surfaces.
"""

import numpy as np
import pytest

from huffman_tpu import api, cli, container, golden
from huffman_tpu.golden.numpy_codec import packed_bytes_to_words


@pytest.fixture
def sample_file(tmp_path, rng):
    data = (rng.geometric(0.4, size=9 * 1024 + 321) % 32).astype(np.uint8)
    p = tmp_path / "in.bin"
    p.write_bytes(data.tobytes())
    return str(p), data


def test_encode_decode_default(sample_file, tmp_path):
    path, data = sample_file
    out = str(tmp_path / "a.htz")
    dec = str(tmp_path / "a.out")
    assert cli.main(["encode", path, "-o", out, "--verify"]) == 0
    assert cli.main(["decode", out, "-o", dec]) == 0
    assert open(dec, "rb").read() == data.tobytes()
    assert cli.main(["info", out]) == 0


@pytest.mark.parametrize("mesh", ["2", "auto"])
def test_encode_decode_mesh(sample_file, tmp_path, mesh):
    """--mesh N routes through ShardedCodec and stays bit-exact."""
    path, data = sample_file
    out = str(tmp_path / "m.htz")
    dec = str(tmp_path / "m.out")
    assert cli.main(["encode", path, "-o", out, "--mesh", mesh]) == 0
    enc = container.load(out)
    ref_bytes, ref_bits = golden.encode(data, enc.codebook)
    assert enc.total_bits == ref_bits
    assert np.array_equal(
        enc.stream_words,
        packed_bytes_to_words(ref_bytes)[: len(enc.stream_words)])
    assert cli.main(["decode", out, "-o", dec, "--mesh", mesh]) == 0
    assert open(dec, "rb").read() == data.tobytes()


def test_bench_mesh_smoke(sample_file, tmp_path):
    path, _ = sample_file
    assert cli.main(["bench", path, "--iters", "2", "--mesh", "2",
                     "--log-dir", str(tmp_path / "logs")]) == 0


def test_roundtrip_cmd(sample_file):
    path, _ = sample_file
    assert cli.main(["roundtrip", path]) == 0


def test_format_option_removed(sample_file, tmp_path):
    """Only the dense container is written; --format is gone."""
    path, _ = sample_file
    with pytest.raises(SystemExit):
        cli.main(["encode", path, "-o", str(tmp_path / "x.htz"),
                  "--format", "wide"])


def test_decode_range(tmp_path):
    """--range decodes only the covering blocks (random access)."""
    from huffman_tpu.utils import testdata
    data = testdata.skewed(5000, num_symbols=16, seed=44)
    src = tmp_path / "r.bin"
    src.write_bytes(data.tobytes())
    htz = str(tmp_path / "r.htz")
    out = tmp_path / "r.part"
    assert cli.main(["encode", str(src), "-o", htz]) == 0
    assert cli.main(["decode", htz, "-o", str(out),
                     "--range", "1000:3500"]) == 0
    assert out.read_bytes() == data[1000:3500].tobytes()


def test_decode_range_degenerate():
    """Degenerate ranges (advisor r4): empty at 0/mid/end, reversed."""
    from huffman_tpu import api
    from huffman_tpu.utils import testdata
    data = testdata.skewed(5000, num_symbols=16, seed=46)
    enc = api.encode(data)
    for pos in (0, 100, 5000):
        assert api.decode_range(enc, pos, pos).size == 0
    with pytest.raises(ValueError):
        api.decode_range(enc, 10, 5)
    with pytest.raises(ValueError):
        api.decode_range(enc, 0, 5001)
    np.testing.assert_array_equal(api.decode_range(enc, 4999, 5000),
                                  data[4999:5000])


@pytest.mark.parametrize("rng_arg", [None, "1000:270000"])
def test_decode_legacy_v3(tmp_path, rng_arg):
    """A version-3 container from an earlier release decodes (and
    --range slices) through the host spec decoder."""
    from huffman_tpu.utils import testdata
    from wide_v3 import dumps_v3, encode_v3
    data = testdata.skewed(300_000, num_symbols=32, seed=45)   # 2 tiles
    htz = tmp_path / "old.htz"
    htz.write_bytes(dumps_v3(encode_v3(data)))
    out = tmp_path / "old.out"
    argv = ["decode", str(htz), "-o", str(out)]
    if rng_arg:
        argv += ["--range", rng_arg]
    assert cli.main(argv) == 0
    a, b = (0, data.size) if rng_arg is None else (1000, 270000)
    assert out.read_bytes() == data[a:b].tobytes()
    assert cli.main(["info", str(htz)]) == 0
