"""The one place that decides which implementation runs on this machine.

On an NVIDIA GPU (JAX platform "gpu") the encoder runs the Pallas kernel
compiled for the card (ops/pallas/encode_pack.py).  On the CPU, which the
tests use, it runs the plain XLA path (ops/encode.py + ops/pack.py) — the
reference the kernel is checked against.  Any other platform is refused.
The histogram, the block bit counts and the decoder are plain XLA on both.

A kernel that fails to compile raises; nothing falls back to XLA or to
the interpreter.  INTERPRET (the kernel under the Pallas interpreter) is
only ever chosen by tests, which patch encode_path.
"""

from __future__ import annotations

import jax

KERNEL = "kernel"
XLA = "xla"
INTERPRET = "interpret"

SUPPORTED = ("gpu", "cpu")


def platform() -> str:
    """The default backend's platform; raises unless it is supported."""
    p = jax.default_backend()
    if p not in SUPPORTED:
        raise RuntimeError(
            f"platform {p!r} is not supported: the codec runs on an NVIDIA "
            f"GPU, or on the CPU for tests")
    return p


def encode_path() -> str:
    """KERNEL on the GPU, XLA on the CPU."""
    return KERNEL if platform() == "gpu" else XLA


def encode_stream(path: str, byte_blocks, codes, lengths, valid_bytes,
                  word_base, bit_shift, out_words: int,
                  capacity_words: int):
    """Encode blocks straight into a dense (out_words,) stream.

    word_base / bit_shift are each block's start (ops/scan.py split form,
    relative to the buffer); every block must fit capacity_words (the
    XLA path stages each block at that width).  Traceable, so it also
    runs inside shard_map; `path` is static.
    """
    if path == XLA:
        from .ops import encode as encode_ops, pack as pack_ops
        packed, _bits = encode_ops.encode_blocks(
            byte_blocks, codes, lengths, valid_bytes, capacity_words)
        return pack_ops.pack_at_offsets(packed, word_base, bit_shift,
                                        out_words)
    if path not in (KERNEL, INTERPRET):
        raise ValueError(f"unknown encode path {path!r}")
    from .ops.pallas.encode_pack import encode_pack
    return encode_pack(byte_blocks, codes, lengths, valid_bytes, word_base,
                       bit_shift, out_words, capacity_words,
                       interpret=path == INTERPRET)
