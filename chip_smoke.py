"""Smoke test of the codec on NVIDIA GPUs: the main path at full size.

  python chip_smoke.py [--seed N]          one card, every phase below
  python chip_smoke.py --chips 4 [--seed N]   the four-card phase only

One card, on a 1 GiB skewed stream made from --seed (the regime of
bench.py: 30 symbols, H ~ 2 bits/byte):
  1. api.encode on host bytes -> container.dump -> container.load ->
     api.decode, bit for bit against the input;
  2. Encoded.stream_bytes against the C++ golden encoder (whole stream);
  3. cli.main encode / decode / decode --range, in this process;
  4. api.decode_range reads against slices of the input;
  5. each kernel against its plain reference at 1 GiB: the fused
     encode+pack kernel against the XLA pipeline (ops/encode
     .encode_blocks + ops/pack.pack_blocks), against pack_reference on a
     slice, and against golden; the histogram against golden.histogram;
  6. the tests marked `gpu` (pytest, in this process).
Four cards: ShardedCodec over make_mesh(4) encodes and decodes 4 GiB
(1 GiB per card), bit-exact against golden and back to the input; and on
1 GiB its container is byte-identical to the single-card api.encode one.

The first line is the card's name and power limit (nvidia-smi); the last
is one JSON object {"ok": true, "device": {...}}.  Any failure raises and
the exit code is non-zero; with no GPU the script exits non-zero before
any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

GIB = 1 << 30


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


def make_stream(n: int, seed: int) -> np.ndarray:
    from huffman_tpu.utils import testdata
    return np.asarray(testdata.log2_skewed_device(n, seed))


def main_path_phase(data: np.ndarray, workdir: str) -> None:
    """Phases 1-4: api, container, golden, CLI, decode_range."""
    from huffman_tpu import api, cli, container, golden
    n = data.size
    t0 = time.perf_counter()
    enc = api.encode(data)
    log(f"api.encode {n} B -> {enc.total_bits} bits "
        f"({enc.ratio:.4f}) in {time.perf_counter() - t0:.2f} s")
    path = os.path.join(workdir, "smoke.htz")
    size = container.dump(enc, path)
    back = container.load(path)
    log(f"container {size} B written and read")
    check(np.array_equal(api.decode(back), data),
          "encode -> dump -> load -> decode is the input, bit for bit")

    t0 = time.perf_counter()
    gold_bytes, gold_bits = golden.encode(data, enc.codebook)
    log(f"golden.encode {time.perf_counter() - t0:.2f} s")
    check(enc.total_bits == gold_bits
          and np.array_equal(enc.stream_bytes, gold_bytes),
          "stream_bytes equal golden.encode over the whole stream")
    del gold_bytes

    src = os.path.join(workdir, "in.bin")
    data.tofile(src)
    htz, out, part = (os.path.join(workdir, f) for f in
                      ("cli.htz", "cli.out", "cli.part"))
    check(cli.main(["encode", src, "-o", htz]) == 0, "cli encode exits 0")
    check(cli.main(["decode", htz, "-o", out]) == 0, "cli decode exits 0")
    check(np.array_equal(np.fromfile(out, np.uint8), data),
          "cli decode output is the input")
    a, b = n // 3, n // 3 + 12345
    check(cli.main(["decode", htz, "-o", part,
                    "--range", f"{a}:{b}"]) == 0, "cli decode --range")
    check(np.array_equal(np.fromfile(part, np.uint8), data[a:b]),
          "cli decode --range output is the input slice")
    for name in (src, htz, out, part, path):
        os.unlink(name)

    bb = enc.config.block_bytes
    for a, b in ((0, 1), (0, 5000), (bb - 3, 3 * bb + 7), (n // 2, n // 2),
                 (n - 100_000, n), (n // 7, min(n, n // 7 + (1 << 20)))):
        check(np.array_equal(api.decode_range(enc, a, b), data[a:b]),
              f"decode_range [{a}, {b})")


def kernel_phase(data: np.ndarray) -> None:
    """Phase 5: each kernel compiled for the card against its reference."""
    import jax
    import jax.numpy as jnp
    from huffman_tpu import api, golden
    from huffman_tpu.codebook import Codebook
    from huffman_tpu.config import DEFAULT_CONFIG as cfg
    from huffman_tpu.ops import encode as encode_ops
    from huffman_tpu.ops import histogram as hist_ops
    from huffman_tpu.ops import pack as pack_ops
    from huffman_tpu.ops.pallas.encode_pack import block_bits, encode_pack

    blocks, n = api._as_blocks(data, cfg)
    nb = blocks.shape[0]
    valid = api.valid_per_block(n, nb, cfg.block_bytes)
    d_blocks, d_valid = jnp.asarray(blocks), jnp.asarray(valid)

    freqs = np.asarray(hist_ops.histogram(d_blocks, d_valid))
    check(np.array_equal(freqs, golden.histogram(data)),
          "histogram equals golden.histogram")
    cb = Codebook.from_frequencies(freqs, cfg.max_code_len)
    codes, lens = jnp.asarray(cb.codes), jnp.asarray(cb.lengths)
    bits, missing = block_bits(d_blocks, lens, d_valid)
    bits = np.asarray(bits)
    check(not np.asarray(missing).any(), "no missing symbols")
    word_base, bit_shift = api.block_offsets(bits)
    total = int(bits.astype(np.int64).sum())
    n_words = -(-total // 32)
    out_words = nb * cfg.capacity_words + 1

    operands = (d_blocks, codes, lens, d_valid, jnp.asarray(word_base),
                jnp.asarray(bit_shift))
    compiled = jax.jit(encode_pack, static_argnames=(
        "out_words", "capacity_words", "interpret")).lower(
            *operands, out_words=out_words,
            capacity_words=cfg.capacity_words).compile()
    log(f"encode_pack memory_analysis: {compiled.memory_analysis()}")
    kern = np.asarray(compiled(*operands)[:n_words])

    ref_stream, ref_bits, _ = api.encode_pipeline(
        d_blocks, codes, lens, d_valid, cfg.capacity_words)
    check(np.array_equal(np.asarray(ref_bits), bits),
          "block_bits equal ops/encode.encode_blocks' bit counts")
    check(np.array_equal(kern, np.asarray(ref_stream[:n_words])),
          "encode_pack equals encode_blocks + pack_blocks at full size")
    del ref_stream

    k = 512                       # pack_reference is a Python loop
    packed, kbits = encode_ops.encode_blocks(
        d_blocks[:k], codes, lens, d_valid[:k], cfg.capacity_words)
    want, want_bits = pack_ops.pack_reference(np.asarray(packed),
                                              np.asarray(kbits))
    kw = -(-want_bits // 32)
    check(np.array_equal(kern[:kw - 1], want[:kw - 1]),
          f"encode_pack equals pack_reference on the first {k} blocks")

    gold_bytes, gold_bits = golden.encode(data, cb)
    from huffman_tpu.golden.numpy_codec import words_to_packed_bytes
    check(gold_bits == total and np.array_equal(
        words_to_packed_bytes(kern, total), gold_bytes),
        "encode_pack equals golden.encode at full size")
    log(f"peak_bytes_in_use: "
        f"{(jax.devices()[0].memory_stats() or {}).get('peak_bytes_in_use')}")


def gpu_tests_phase() -> None:
    """Phase 6: the `gpu`-marked tests, in this process."""
    import pytest
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests")])
    check(rc == 0, "pytest -m gpu passes")


def multi_card_phase(seed: int, per_card: int = GIB) -> None:
    """Four cards: sharded encode/decode of 4 x per_card bytes against
    golden and the input, and 1 x per_card bytes against api.encode."""
    import jax
    from huffman_tpu import api, container, golden
    from huffman_tpu.parallel.mesh import make_mesh
    from huffman_tpu.parallel.pipeline import ShardedCodec
    ndev = 4
    check(len(jax.devices()) >= ndev, f"{ndev} devices present")
    codec = ShardedCodec(make_mesh(ndev))

    data = make_stream(ndev * per_card, seed)
    t0 = time.perf_counter()
    enc = codec.encode(data)
    log(f"ShardedCodec.encode {data.size} B -> {enc.total_bits} bits in "
        f"{time.perf_counter() - t0:.2f} s")
    gold_bytes, gold_bits = golden.encode(data, enc.codebook)
    check(enc.total_bits == gold_bits
          and np.array_equal(enc.stream_bytes, gold_bytes),
          f"sharded stream equals golden over {data.size} B")
    del gold_bytes
    t0 = time.perf_counter()
    out = codec.decode(enc)
    log(f"ShardedCodec.decode in {time.perf_counter() - t0:.2f} s")
    check(np.array_equal(out, data), "sharded decode is the input")
    del out, enc, data

    data = make_stream(per_card, seed + 1)
    blob4 = container.dumps(codec.encode(data))
    blob1 = container.dumps(api.encode(data))
    check(blob4 == blob1, f"{ndev}-card container equals the single-card "
          f"one over {data.size} B")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # The card's name and power limit, from a child that never imports
    # JAX (nvidia-smi); absent without a GPU, which ends the run here.
    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU: JAX found {dev.platform}")
        return 1
    from huffman_tpu import backend
    backend.platform()

    if args.chips == 4:
        multi_card_phase(args.seed)
    else:
        data = make_stream(GIB, args.seed)
        with tempfile.TemporaryDirectory() as workdir:
            main_path_phase(data, workdir)
        kernel_phase(data)
        del data
        gpu_tests_phase()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
