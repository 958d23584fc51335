"""Benchmark driver for one NVIDIA GPU: prints ONE JSON line.

Stages, on a skewed byte stream made on the device from --seed
(testdata.log2_skewed_device: 30 symbols, H ~ 2 bits/byte, the regime of
the reference's shipped fixture) at BASELINE.md's spec size of 1 GiB:

  histogram      device histogram of the whole stream (codebook input)
  block_bits     encode pass 1: exact bits per block + missing flag
  encode_kernel  encode pass 2: the fused encode+pack kernel
  encode_xla     pass 2 by the plain XLA path (block encode + pack), the
                 reference the kernel replaces
  decode         the XLA decoder over the whole stream
  encode_e2e     api.encode from host bytes (H2D, histogram, both passes,
                 the host sync, D2H of the stream)
  decode_e2e     api.decode from the Encoded stream back to host bytes

Device stages run on device-resident inputs; each time is the median of
--reps calls that end in block_until_ready, after one warm-up call whose
time (compilation included) is reported as *_first_s.  Rates are input
GB/s (1e9 bytes).  Every record names the device kind, the device count
and the card's power limit; without a GPU the script exits non-zero.

  python bench.py [--mib 1024] [--reps 5] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(fn, *args, reps: int):
    """(first call s, median s, all s) of fn(*args), each waited for."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, statistics.median(times), times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from huffman_tpu import api, backend, golden
    from huffman_tpu.config import CodecConfig
    from huffman_tpu.ops import histogram as hist_ops
    from huffman_tpu.ops import decode as decode_ops
    from huffman_tpu.ops.pallas.encode_pack import block_bits
    from huffman_tpu.utils import testdata

    if backend.platform() != "gpu":
        print("bench.py measures an NVIDIA GPU; none found", file=sys.stderr)
        return 2
    dev = jax.devices()[0]
    card = gpu_name_and_power_limit()
    cfg = CodecConfig()
    n = args.mib * 1024 * 1024
    nb = n // cfg.block_bytes
    res = {}

    def record(stage, first, med, times, nbytes=n):
        res[stage + "_first_s"] = first
        res[stage + "_ms"] = med * 1e3
        res[stage + "_ms_all"] = [t * 1e3 for t in times]
        res[stage + "_gbps"] = nbytes / med / 1e9

    d_flat = jax.block_until_ready(testdata.log2_skewed_device(n, args.seed))
    d_blocks = d_flat.reshape(nb, cfg.block_bytes)
    valid = np.full(nb, cfg.block_bytes, np.int32)
    d_valid = jnp.asarray(valid)

    record("histogram", *timed(hist_ops.histogram, d_blocks, d_valid,
                               reps=args.reps))
    freqs = np.asarray(hist_ops.histogram(d_blocks, d_valid))
    from huffman_tpu.codebook import Codebook, entropy_bits_per_byte
    cb = Codebook.from_frequencies(freqs, cfg.max_code_len)
    res["entropy_bits_per_byte"] = entropy_bits_per_byte(freqs)
    codes, lens = jnp.asarray(cb.codes), jnp.asarray(cb.lengths)

    record("block_bits", *timed(block_bits, d_blocks, lens, d_valid,
                                reps=args.reps))
    bits = np.asarray(block_bits(d_blocks, lens, d_valid)[0])
    word_base, bit_shift = api.block_offsets(bits)
    d_wb, d_sh = jnp.asarray(word_base), jnp.asarray(bit_shift)
    out_words = nb * cfg.capacity_words + 1
    n_words = -(-int(bits.astype(np.int64).sum()) // 32)
    res["bits_per_byte"] = float(bits.astype(np.int64).sum()) / n

    def stage2(path):
        return lambda *a: backend.encode_stream(
            path, *a, out_words, cfg.capacity_words)

    operands = (d_blocks, codes, lens, d_valid, d_wb, d_sh)
    record("encode_kernel", *timed(stage2(backend.KERNEL), *operands,
                                   reps=args.reps))
    record("encode_xla", *timed(stage2(backend.XLA), *operands,
                                reps=args.reps))
    kern = stage2(backend.KERNEL)(*operands)[:n_words]
    ref = stage2(backend.XLA)(*operands)[:n_words]
    res["encode_kernel_matches_xla"] = bool(jnp.array_equal(kern, ref))
    del kern, ref

    syms, tlens = cb.decode_table(cfg.decode_table_bits)
    d_stream = jnp.concatenate([
        stage2(backend.KERNEL)(*operands)[:n_words],
        jnp.zeros(2, jnp.uint32)])
    record("decode", *timed(
        lambda *a: decode_ops.decode_blocks(*a, cfg.block_bytes,
                                            cfg.decode_table_bits),
        d_stream, d_wb, d_sh, d_valid, jnp.asarray(syms),
        jnp.asarray(tlens), reps=args.reps))
    del d_stream

    host = np.asarray(d_flat)
    del d_flat, d_blocks
    record("encode_e2e", *timed(api.encode, host, cfg, reps=args.reps))
    enc = api.encode(host, cfg)
    record("decode_e2e", *timed(api.decode, enc, reps=args.reps))
    res["roundtrip_ok"] = bool(np.array_equal(api.decode(enc), host))
    t0 = time.perf_counter()
    gold_bytes, gold_bits = golden.encode(host, enc.codebook)
    res["golden_cpu_gbps"] = n / (time.perf_counter() - t0) / 1e9
    res["bit_exact"] = bool(enc.total_bits == gold_bits and np.array_equal(
        enc.stream_bytes, gold_bytes))
    res["peak_bytes_in_use"] = (dev.memory_stats() or {}).get(
        "peak_bytes_in_use")

    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card, "input_mib": args.mib, "seed": args.seed,
        "reps": args.reps, **res}))
    ok = (res["bit_exact"] and res["roundtrip_ok"]
          and res["encode_kernel_matches_xla"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
