"""Bit-granular pack: stitch per-block bitstreams into one dense stream.

Plain XLA counterpart of the reference pack kernel (reference:
pack_kernels.cu:19-52), which assigns one CUDA thread per encoded block and
resolves the shared head/tail words between neighboring blocks with
atomicOr (pack_kernels.cu:34,45-51).  Here every block's contribution is a
pure shift-merge of its word stream (bitio.shift_word_stream — the
vectorized form of pack_kernels.cu:36-41), and seam words are combined by a
disjoint-bit scatter-add: deterministic, no atomics.

Also unlike the reference, which launches <<<num_blocks/16, 16>>> and
silently requires 16 | num_blocks (main_test_cu.cu:166), any block count
works here.

Output sizing under XLA's static-shape rule: the dense stream is returned
in a worst-case buffer of NB*capacity+1 words together with the real
total; callers slice on the host (SURVEY.md section 7, "variable-length
output on a fixed-shape compiler").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import bitio
from .scan import BitOffsets, exclusive_bit_offsets


def pack_at_offsets(packed_blocks: jax.Array, word_base: jax.Array,
                    bit_shift: jax.Array, out_words: int) -> jax.Array:
    """Scatter block bitstreams into a dense buffer at given (word, bit) starts.

    The mesh-agnostic core: single-chip pack passes offsets from the global
    scan; the sharded pipeline passes shard-local offsets that already
    include the shard's starting bit shift, producing a shard-local dense
    buffer whose seams are OR-combined at assembly (parallel/pipeline.py).

    Args:
      packed_blocks: (NB, CAP) uint32 block bitstreams (bit 0 at word 0 MSB).
      word_base: (NB,) int32 destination word index of each block's first bit.
      bit_shift: (NB,) int32 destination bit (0..31) within that word.
      out_words: static output buffer length in words.
    """
    nb, cap = packed_blocks.shape
    s = bit_shift.astype(jnp.int32)[:, None]             # (NB, 1)
    x = packed_blocks.astype(jnp.uint32)
    prev = jnp.pad(x, ((0, 0), (1, 0)))[:, :-1]          # word j-1, 0 in front
    y = bitio.shift_word_stream(x, prev, s)              # (NB, CAP)
    tail = bitio.shift_word_stream(jnp.zeros((nb, 1), jnp.uint32),
                                   x[:, -1:], s)         # spill word (NB, 1)
    contrib = jnp.concatenate([y, tail], axis=1)         # (NB, CAP+1)

    dest = word_base.astype(jnp.int32)[:, None] + jnp.arange(
        cap + 1, dtype=jnp.int32)
    out = jnp.zeros(out_words, jnp.uint32)
    # Seam words (tail of block b overlapping head of block b+1) carry
    # disjoint bits, so add == or.  Everything past each block's used words
    # is zero in `contrib` and adds nothing.
    return out.at[dest.reshape(-1)].add(contrib.reshape(-1), mode="drop")


def pack_blocks(packed_blocks: jax.Array, block_bits: jax.Array):
    """Pack per-block bitstreams into one dense stream.

    Args:
      packed_blocks: (NB, CAP) uint32 block-local bitstreams (bit 0 of each
        block at the MSB of its word 0), as produced by encode_blocks.
      block_bits: (NB,) int32 bits used per block.

    Returns:
      stream: (NB*CAP + 1,) uint32 dense stream (valid words: offsets.total_words).
      offsets: BitOffsets for the blocks (reused by the decoder/container).
    """
    nb, cap = packed_blocks.shape
    offsets = exclusive_bit_offsets(block_bits)
    stream = pack_at_offsets(packed_blocks, offsets.word_base,
                             offsets.bit_shift, nb * cap + 1)
    return stream, offsets


def pack_reference(packed_blocks, block_bits) -> "tuple":
    """NumPy twin of pack_blocks (slow, for differential testing)."""
    import numpy as np
    nb, cap = packed_blocks.shape
    x = np.asarray(packed_blocks, dtype=np.uint64)
    bits = np.asarray(block_bits, dtype=np.int64)
    total_bits = int(bits.sum())
    out = np.zeros(nb * cap + 1, dtype=np.uint64)
    cursor = 0
    for b in range(nb):
        nwords = (int(bits[b]) + 31) // 32
        base, sh = cursor >> 5, cursor & 31
        for j in range(nwords):
            v = int(x[b, j]) << (32 - sh) if sh else int(x[b, j]) << 32
            out[base + j] |= (v >> 32) & 0xFFFFFFFF
            out[base + j + 1] |= v & 0xFFFFFFFF
        cursor += int(bits[b])
    return out.astype(np.uint32), total_bits
