"""High-level single-process codec API.

The device analogue of the reference driver's per-file pipeline
(reference: main_test_cu.cu:52-180 runVLCTest): histogram -> codebook ->
block bit counts -> offset scan -> encode + pack, plus decode (which the
reference lacks).  Differences from the reference:

  * Encode is two device passes with one host sync between them: the
    exact per-block bit counts (and the missing-symbol flag) first, then
    one pass that writes every block straight into the dense stream at
    its scanned offset (backend.encode_stream).  The host needs the bit
    counts anyway, for the overflow check and the container header.
  * Arbitrary input sizes are handled by a zero-contribution padded tail
    (the reference punts: load_data.h:20 todo, pack's divisibility
    assumption main_test_cu.cu:166).
  * Overflow of the per-block output capacity is detected and raised
    (the reference silently corrupts shared memory past its assumption,
    vlc_kernel_sm64huff.cu:30-32).

Multi-device variants of the same pipeline live in parallel/pipeline.py;
this module is intentionally mesh-free.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import backend
from .codebook import Codebook
from .config import CodecConfig, DEFAULT_CONFIG, cdiv
from .ops import decode as decode_ops
from .ops import encode as encode_ops
from .ops import histogram as hist_ops
from .ops import pack as pack_ops
from .ops.pallas.encode_pack import block_bits as _block_bits


@dataclasses.dataclass(frozen=True)
class Encoded:
    """An encoded stream plus everything needed to decode it.

    This is the in-memory form of the container (container.py serializes
    it): the dense bitstream, the codebook as lengths, and per-block bit
    counts — which make every block's start offset recomputable, the
    property that enables parallel decode and doubles as the
    checkpoint/resume story (SURVEY.md section 5, checkpoint row).
    """
    stream_words: np.ndarray      # (ceil(total_bits/32),) uint32
    total_bits: int
    block_bits: np.ndarray        # (NB,) int32
    codebook: Codebook
    n_bytes: int
    config: CodecConfig

    @property
    def stream_bytes(self) -> np.ndarray:
        """MSB-first byte view (bit-comparable with the golden codec)."""
        from .golden.numpy_codec import words_to_packed_bytes
        return words_to_packed_bytes(self.stream_words, self.total_bits)

    @property
    def ratio(self) -> float:
        return (self.total_bits / 8) / max(self.n_bytes, 1)


def _as_u8(data) -> np.ndarray:
    return (np.frombuffer(data, dtype=np.uint8)
            if isinstance(data, (bytes, bytearray))
            else np.ascontiguousarray(data, dtype=np.uint8).reshape(-1))


def _as_blocks(data, cfg: CodecConfig) -> tuple[np.ndarray, int]:
    arr = _as_u8(data)
    n = arr.size
    nb = cfg.num_blocks(n)
    padded = np.zeros(nb * cfg.block_bytes, dtype=np.uint8)
    padded[:n] = arr
    return padded.reshape(nb, cfg.block_bytes), n


def _device_blocks(data, cfg: CodecConfig):
    """Upload bytes as (NB, BB) device blocks -> (blocks, n).  Only a
    partial last block is padded on the host; full blocks go up as a
    view of the input, with no host copy."""
    arr = _as_u8(data)
    n, bb = arr.size, cfg.block_bytes
    full = n // bb
    parts = [jnp.asarray(arr[: full * bb].reshape(full, bb))] if full else []
    if n % bb or not n:
        tail = np.zeros((1, bb), np.uint8)
        tail[0, : n - full * bb] = arr[full * bb:]
        parts.append(jnp.asarray(tail))
    return (jnp.concatenate(parts) if len(parts) > 1 else parts[0]), n


def valid_per_block(n_bytes: int, num_blocks: int, block_bytes: int,
                    ) -> np.ndarray:
    """Real byte count of each block: BB for full blocks, the remainder for
    the final partial block, 0 for padding blocks (mesh rounding)."""
    starts = np.arange(num_blocks, dtype=np.int64) * block_bytes
    return np.clip(n_bytes - starts, 0, block_bytes).astype(np.int32)


def block_offsets(block_bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host exclusive scan of bit counts -> (word_base, bit_shift) int32.

    Exact in int64 on the host; word indices must fit int32 (streams
    under 2**36 bits)."""
    ends = np.cumsum(np.asarray(block_bits, np.int64))
    starts = ends - block_bits
    if ends.size and ends[-1] >= (1 << 36):
        raise OverflowError("stream exceeds 2**31 words")
    return ((starts >> 5).astype(np.int32),
            (starts & 31).astype(np.int32))


@functools.partial(jax.jit, static_argnames=("capacity_words",))
def encode_pipeline(byte_blocks, codes, lengths, valid_bytes, capacity_words):
    """The plain XLA pipeline in one jit: block encode -> scan -> pack.

    The reference the kernel path is checked against at full size."""
    packed, block_bits = encode_ops.encode_blocks(
        byte_blocks, codes, lengths, valid_bytes, capacity_words)
    stream, offsets = pack_ops.pack_blocks(packed, block_bits)
    return stream, block_bits, offsets


# Codebook-build sampling policy: above SAMPLE_MIN_BYTES the histogram
# reads every SAMPLE_EVERY-th block only (contiguous rows, so the device
# traffic drops with the compute).  The block bit-count pass then flags
# exactly the blocks holding a byte the sampled codebook cannot code, and
# api.encode rebuilds from the full histogram when any block is flagged
# (the symbol appeared only outside the sample).  The reference
# histograms ~1/4 of the file by accident, with no detection at all
# (hist.cu:98-102 units bug).
SAMPLE_MIN_BYTES = 4 * 1024 * 1024
SAMPLE_EVERY = 16

# One histogram call counts at most this many blocks: its int32 counts
# and positions must stay below 2**31 bytes.
HIST_CHUNK_BYTES = 1 << 30


def _histogram(d_blocks, valid: np.ndarray) -> np.ndarray:
    """Device histogram of (NB, BB) blocks, summed exactly on the host."""
    rows = max(1, HIST_CHUNK_BYTES // d_blocks.shape[1])
    freqs = np.zeros(256, np.int64)
    for i in range(0, d_blocks.shape[0], rows):
        freqs += np.asarray(hist_ops.histogram(
            d_blocks[i: i + rows], jnp.asarray(valid[i: i + rows])))
    return freqs


def _codebook_from_blocks(d_blocks, valid: np.ndarray, cfg: CodecConfig,
                          sample_every: int = 1) -> Codebook:
    if sample_every > 1:
        d_blocks, valid = d_blocks[::sample_every], valid[::sample_every]
    return Codebook.from_frequencies(_histogram(d_blocks, valid),
                                     cfg.max_code_len)


def build_codebook(data, cfg: CodecConfig = DEFAULT_CONFIG,
                   use_device: bool = True,
                   sample_every: int = 1) -> Codebook:
    """Histogram (on device by default) + host-side canonical codebook.

    sample_every: histogram every k-th block only (see SAMPLE_EVERY);
    the result may lack codes for symbols outside the sample — callers
    must check the missing-symbol flag (api.encode does) or pass 1.
    """
    if use_device:
        d_blocks, n = _device_blocks(data, cfg)
        valid = valid_per_block(n, d_blocks.shape[0], cfg.block_bytes)
        return _codebook_from_blocks(d_blocks, valid, cfg, sample_every)
    blocks, n = _as_blocks(data, cfg)
    valid = valid_per_block(n, blocks.shape[0], cfg.block_bytes)
    from .codebook import byte_histogram_host
    sub = blocks[::sample_every]
    # only the overall-last block can be partial, and slicing keeps it
    # last — so the sampled valid bytes are a prefix of sub
    nv = int(valid[::sample_every].astype(np.int64).sum())
    return Codebook.from_frequencies(
        byte_histogram_host(sub.reshape(-1)[:nv]), cfg.max_code_len)


MISSING_SYMBOL = "input contains symbols absent from the codebook"


def check_capacity(bits: np.ndarray, cfg: CodecConfig) -> None:
    """Raise OverflowError if a block exceeds cfg's per-block capacity.

    Always checked, before the encode pass: the output buffer and the
    kernel's per-block run slots are sized by the capacity."""
    if (bits > cfg.capacity_words * 32).any():
        bad = int(np.argmax(bits > cfg.capacity_words * 32))
        raise OverflowError(
            f"block {bad} needs {int(bits[bad])} bits > capacity "
            f"{cfg.capacity_words * 32}; raise config.capacity_bits_per_byte")


def encode(data, cfg: CodecConfig = DEFAULT_CONFIG,
           codebook: Codebook | None = None,
           model: "CodebookModel | None" = None) -> Encoded:
    """Encode a byte stream on the default device.

    The codebook comes from (in priority order): `codebook` directly, a
    `model` (models.CodebookModel — e.g. models.FixedCodebook skips the
    histogram pass entirely), or the default per-stream canonical Huffman
    build (device histogram + host tree, the reference's load_data.h:25-58
    flow).  A supplied codebook that lacks a code for some input symbol
    raises ValueError.
    """
    path = backend.encode_path()
    if _as_u8(data).size == 0:
        return Encoded(np.zeros(0, np.uint32), 0,
                       np.zeros(1, np.int32),
                       codebook or Codebook.from_lengths(np.zeros(256)),
                       0, cfg)
    if codebook is None and model is not None:
        codebook = model.codebook_for(_as_u8(data))
    d_blocks, n = _device_blocks(data, cfg)
    nb = d_blocks.shape[0]
    valid = valid_per_block(n, nb, cfg.block_bytes)
    d_valid = jnp.asarray(valid)
    explicit_cb = codebook is not None
    sampled = not explicit_cb and n >= SAMPLE_MIN_BYTES
    cb = codebook or _codebook_from_blocks(
        d_blocks, valid, cfg, SAMPLE_EVERY if sampled else 1)
    bits, missing = _block_bits(d_blocks, jnp.asarray(cb.lengths), d_valid)
    if np.asarray(missing).any():
        if explicit_cb:
            raise ValueError(MISSING_SYMBOL)
        # a symbol seen only outside the sampled blocks: build exactly
        cb = _codebook_from_blocks(d_blocks, valid, cfg)
        bits, missing = _block_bits(d_blocks, jnp.asarray(cb.lengths),
                                    d_valid)
    bits = np.asarray(bits)
    check_capacity(bits, cfg)
    word_base, bit_shift = block_offsets(bits)
    total_bits = int(bits.astype(np.int64).sum())
    n_words = cdiv(total_bits, 32)
    stream = backend.encode_stream(
        path, d_blocks, jnp.asarray(cb.codes), jnp.asarray(cb.lengths),
        d_valid, jnp.asarray(word_base), jnp.asarray(bit_shift),
        nb * cfg.capacity_words + 1, cfg.capacity_words)
    return Encoded(stream_words=np.asarray(stream[:n_words]),
                   total_bits=total_bits, block_bits=bits,
                   codebook=cb, n_bytes=n, config=cfg)


def table_bits(enc: Encoded) -> int:
    """Decode-table width: the config's, widened to a supplied codebook's
    longest code."""
    return max(enc.config.decode_table_bits, enc.codebook.max_len)


def _decode_blocks(enc: Encoded, stream: np.ndarray, word_base: np.ndarray,
                   bit_shift: np.ndarray, valid: np.ndarray) -> np.ndarray:
    tb = table_bits(enc)
    syms, lens = enc.codebook.decode_table(tb)
    # Two words of tail slack for the final window peek.
    stream = np.concatenate([stream, np.zeros(2, np.uint32)])
    out = decode_ops.decode_blocks(
        jnp.asarray(stream), jnp.asarray(word_base), jnp.asarray(bit_shift),
        jnp.asarray(valid), jnp.asarray(syms), jnp.asarray(lens),
        enc.config.block_bytes, tb)
    return np.asarray(out).reshape(-1)


def decode(enc: Encoded) -> np.ndarray:
    """Decode an Encoded stream on the default device. Returns uint8 array.

    The XLA table-gather reader (ops/decode.py): one lane per block, every
    block decoded in parallel from its offset in the container.
    """
    backend.platform()
    if enc.n_bytes == 0:
        return np.zeros(0, np.uint8)
    valid = valid_per_block(enc.n_bytes, len(enc.block_bits),
                            enc.config.block_bytes)
    word_base, bit_shift = block_offsets(enc.block_bits)
    return _decode_blocks(enc, enc.stream_words, word_base, bit_shift,
                          valid)[: enc.n_bytes]


def decode_range(enc: Encoded, start: int, stop: int) -> np.ndarray:
    """Decode bytes [start, stop) WITHOUT decoding the whole stream.

    Blocks are independently encoded (the container stores per-block bit
    counts), so random access costs one host scan over the bit counts
    plus a device decode of ONLY the covering blocks — the random-access
    capability the blocked format exists for (SURVEY.md §5 long-context
    row; the reference's container has the same per-block counts but no
    reader exploits them).
    """
    backend.platform()
    if not 0 <= start <= stop <= enc.n_bytes:
        raise ValueError(f"range [{start}, {stop}) outside "
                         f"[0, {enc.n_bytes})")
    if start == stop:
        return np.zeros(0, np.uint8)
    bb = enc.config.block_bytes
    b0, b1 = start // bb, cdiv(stop, bb)
    valid = valid_per_block(enc.n_bytes, len(enc.block_bits), bb)
    # Upload ONLY the covering word span, with word_base rebased: device
    # bytes are proportional to the requested range, not the stream.
    word_base, bit_shift = block_offsets(enc.block_bits)
    w0 = int(word_base[b0])
    w_end = cdiv(int(np.asarray(enc.block_bits[:b1], np.int64).sum()), 32)
    out = _decode_blocks(enc, enc.stream_words[w0:w_end],
                         word_base[b0:b1] - w0, bit_shift[b0:b1],
                         valid[b0:b1])
    return out[start - b0 * bb: stop - b0 * bb]


def roundtrip_ok(data, cfg: CodecConfig = DEFAULT_CONFIG) -> bool:
    """Encode+decode and compare (the one-call verification helper)."""
    arr = _as_u8(data)
    enc = encode(arr, cfg)
    return bool(np.array_equal(decode(enc), arr))
