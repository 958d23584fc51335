"""Command-line driver.

Counterpart of the reference binary `pavle`
(reference: main_test_cu.cu:32-180): each input file runs through the full
pipeline with timing and optional golden verification.  Beyond the
reference: real subcommands (encode / decode / roundtrip / bench / info),
an on-disk container, and decode — the reference can only encode+verify in
memory and discards the result.

Usage:
  python -m huffman_tpu encode FILE [-o OUT.htz] [--verify] [--mesh N|auto]
  python -m huffman_tpu decode FILE.htz [-o OUT] [--mesh N|auto]
                         [--range START:STOP]   # random access
  python -m huffman_tpu roundtrip FILE...        # encode+decode+verify
  python -m huffman_tpu bench FILE [--iters N] [--mesh N|auto]
  python -m huffman_tpu info FILE.htz            # container header dump
  python -m huffman_tpu devices                  # device probe

--mesh routes through parallel.pipeline.ShardedCodec over a device mesh.
Containers of version 3 (the retired interleaved "wide" format) are read
by the host-side spec decoder (container.py).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import api, container
from .codebook import entropy_bits_per_byte, byte_histogram_host
from .config import CodecConfig
from .utils import device as device_utils
from .utils.stats import StatsLogger, gb_per_s
from .utils.timing import HostTimer, time_fn


def _cfg(args) -> CodecConfig:
    kw = {}
    if getattr(args, "block_bytes", None):
        kw["block_bytes"] = args.block_bytes
    if getattr(args, "max_code_len", None):
        kw["max_code_len"] = args.max_code_len
    if getattr(args, "capacity", None):
        kw["capacity_bits_per_byte"] = args.capacity
    return CodecConfig(**kw)


def _read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return np.frombuffer(f.read(), dtype=np.uint8)


def _mesh_codec(args, cfg):
    """--mesh N|auto -> a ShardedCodec over the first N (or all) devices.

    Makes the scale-out layer reachable from argv, like the reference
    drives everything from main (reference: main_test_cu.cu:41-52)."""
    spec = getattr(args, "mesh", None)
    if not spec:
        return None
    from .parallel.mesh import make_mesh
    from .parallel.pipeline import ShardedCodec
    nd = None if spec == "auto" else int(spec)
    return ShardedCodec(make_mesh(nd), cfg)


def cmd_encode(args) -> int:
    cfg = _cfg(args)
    rc = 0
    sc = _mesh_codec(args, cfg)
    for path in args.files:
        data = _read(path)
        h = entropy_bits_per_byte(byte_histogram_host(data))
        with HostTimer() as t:
            enc = sc.encode(data) if sc is not None else api.encode(data, cfg)
        out = args.output or (path + ".htz")
        size = container.dump(enc, out,
                              checksum=not args.no_checksum)
        print(f"{path}: {data.size} B, H={h:.4f} bits/B -> {out}: {size} B "
              f"(ratio {size / max(data.size, 1):.4f}) in {t.ms:.1f} ms "
              f"[{gb_per_s(data.size / 2**20, t.ms):.3f} GB/s inc. compile]")
        if args.verify:
            from .verify import verify_encoded
            res = verify_encoded(enc, data)
            print(f"  verify vs golden: "
                  f"{'PASS' if res else 'FAIL'} — {res.detail}")
            rc |= 0 if res else 1
    return rc


def _parse_range(spec: str, n: int) -> tuple[int, int]:
    """START:STOP byte range (either side may be empty)."""
    a, _, b = spec.partition(":")
    return (int(a) if a else 0), (int(b) if b else n)


def cmd_decode(args) -> int:
    sc = None
    for path in args.files:
        enc = container.load(path)
        with HostTimer() as t:
            if isinstance(enc, container.WideEncoded):
                data = container.decode_wide(enc)
                if getattr(args, "range", None):
                    start, stop = _parse_range(args.range, enc.n_bytes)
                    data = data[start:stop]
            elif getattr(args, "range", None):
                start, stop = _parse_range(args.range, enc.n_bytes)
                data = api.decode_range(enc, start, stop)
            elif getattr(args, "mesh", None):
                sc = sc or _mesh_codec(args, enc.config)
                data = sc.decode(enc)
            else:
                data = api.decode(enc)
        out = args.output or (path[:-4] if path.endswith(".htz")
                              else path + ".out")
        with open(out, "wb") as f:
            f.write(data.tobytes())
        print(f"{path} -> {out}: {data.size} B in {t.ms:.1f} ms")
    return 0


def cmd_roundtrip(args) -> int:
    cfg = _cfg(args)
    rc = 0
    for path in args.files:
        data = _read(path)
        enc = api.encode(data, cfg)
        from .verify import verify_encoded, verify_roundtrip
        r1 = verify_encoded(enc, data)
        r2 = verify_roundtrip(enc, data)
        ok = bool(r1) and bool(r2)
        print(f"{path}: encode {'PASS' if r1 else 'FAIL'} ({r1.detail}); "
              f"decode {'PASS' if r2 else 'FAIL'} ({r2.detail})")
        rc |= 0 if ok else 1
    return rc


def cmd_bench(args) -> int:
    import jax
    cfg = _cfg(args)
    logger = StatsLogger(args.log_dir)
    dev = jax.devices()[0]
    rc = 0
    for path in args.files:
        data = _read(path)
        mb = data.size / 2**20
        cb = api.build_codebook(data, cfg)

        # End-to-end wall of the path `encode` runs (host bytes in,
        # Encoded out), sharded under --mesh.
        sc = _mesh_codec(args, cfg)
        if sc is not None:
            bench_fn = lambda: sc.encode(data, codebook=cb)  # noqa: E731
        else:
            bench_fn = lambda: api.encode(data, cfg, codebook=cb)  # noqa: E731
        enc_stats = time_fn(bench_fn, iters=args.iters)
        rec = logger.log_rate("encode", mb, enc_stats["median_ms"],
                              file=path, bytes=data.size,
                              iters=args.iters, device=dev.device_kind)
        print(f"{path}: encode {enc_stats['median_ms']:.3f} ms median "
              f"({args.iters} iters) = {rec['gbps']:.3f} GB/s "
              f"on {dev.device_kind}")

        enc = api.encode(data, cfg, codebook=cb)
        if args.verify:
            from .verify import verify_encoded
            res = verify_encoded(enc, data)
            print(f"  verify: {'PASS' if res else 'FAIL'} — {res.detail}")
            rc |= 0 if res else 1
    return rc


def cmd_info(args) -> int:
    for path in args.files:
        enc = container.load(path)
        used = int((enc.codebook.lengths > 0).sum())
        if isinstance(enc, container.WideEncoded):
            print(f"{path}: v2 (wide), {enc.n_bytes} B original, "
                  f"{enc.payload_words.size} payload words, "
                  f"{len(enc.tile_words)} tiles, {used} symbols, "
                  f"max code len {enc.codebook.max_len}")
        else:
            print(f"{path}: v1 (dense), {enc.n_bytes} B original, "
                  f"{enc.total_bits} bits payload, "
                  f"{len(enc.block_bits)} blocks "
                  f"x {enc.config.block_bytes} B, {used} symbols, "
                  f"max code len {enc.codebook.max_len}, "
                  f"overhead {container.overhead_bytes(len(enc.block_bits))} B")
    return 0


def cmd_devices(args) -> int:
    print(device_utils.describe_devices())
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="huffman_tpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_mesh(sp):
        sp.add_argument("--mesh", default=None, metavar="N|auto",
                        help="shard over the first N (or all) devices via "
                        "ShardedCodec")

    def add_common(sp, output=False):
        sp.add_argument("files", nargs="+")
        sp.add_argument("--block-bytes", type=int, default=None)
        sp.add_argument("--max-code-len", type=int, default=None)
        sp.add_argument("--capacity", type=int, default=None,
                        help="per-block capacity in bits per input byte")
        if output:
            sp.add_argument("-o", "--output", default=None)

    sp = sub.add_parser("encode", help="encode files to .htz containers")
    add_common(sp, output=True)
    add_mesh(sp)
    sp.add_argument("--verify", action="store_true",
                    help="bit-exact check vs the CPU golden encoder")
    sp.add_argument("--no-checksum", action="store_true",
                    help="skip the container payload CRC-32 (host-side "
                         "single-thread pass; readers accept both forms)")
    sp.set_defaults(fn=cmd_encode)

    sp = sub.add_parser("decode", help="decode .htz containers")
    sp.add_argument("files", nargs="+")
    sp.add_argument("-o", "--output", default=None)
    add_mesh(sp)
    sp.add_argument("--range", default=None, metavar="START:STOP",
                    help="decode only bytes [START, STOP): random "
                    "access via the per-block container offsets")
    sp.set_defaults(fn=cmd_decode)

    sp = sub.add_parser("roundtrip", help="encode+decode+verify, no output")
    add_common(sp)
    sp.set_defaults(fn=cmd_roundtrip)

    sp = sub.add_parser("bench", help="timing loop (median of N iters)")
    add_common(sp)
    add_mesh(sp)
    sp.add_argument("--iters", type=int, default=10)
    sp.add_argument("--verify", action="store_true")
    sp.add_argument("--log-dir", default="bench_logs")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("info", help="dump container headers")
    sp.add_argument("files", nargs="+")
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("devices", help="probe accelerator devices")
    sp.set_defaults(fn=cmd_devices)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
