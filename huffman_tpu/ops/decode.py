"""Table-driven canonical Huffman decoder (XLA path).

The reference has **no decoder** (SURVEY.md section 0); this is the north
star capability (SURVEY.md section 7, capability 10).  Parallelization
follows the container design: encode records per-block bit counts, so each
block's start offset is known and blocks decode independently — decode
parallelism across blocks mirrors encode's (SURVEY.md section 7, "decoder
parallelism").

Within a block, decoding is inherently sequential (each code's end position
depends on all previous lengths), so the kernel runs `block_bytes` dependent
steps — but every step is vectorized across ALL blocks: one lane per block,
with per-lane (word, bit) cursors into the dense stream and gathers into the
2**table_bits single-level decode table.  This is the standard
"self-synchronization-free" layout used by GPU Huffman decoders, written
as wide vector steps for XLA.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import bitio


@functools.partial(jax.jit, static_argnames=("block_bytes", "table_bits"))
def decode_blocks(stream: jax.Array, word_base: jax.Array,
                  bit_shift: jax.Array, valid_bytes: jax.Array,
                  table_syms: jax.Array, table_lens: jax.Array,
                  block_bytes: int, table_bits: int):
    """Decode all blocks of a dense stream in parallel.

    Args:
      stream: (NW,) uint32 dense bitstream (>= 2 words of tail slack).
      word_base, bit_shift: (NB,) int32 per-block start cursors (from the
        container header / BitOffsets).
      valid_bytes: (NB,) int32 — real byte count per block (lanes stop
        consuming bits past their share; shard-local under shard_map).
      table_syms, table_lens: (2**table_bits,) decode table (uint8 each).
      block_bytes: static bytes per full block.
      table_bits: static table width.

    Returns:
      out: (NB, block_bytes) uint8 decoded bytes (invalid positions zero).
    """
    nb = word_base.shape[0]
    nw = stream.shape[0]
    syms_i = table_syms.astype(jnp.int32)
    lens_i = table_lens.astype(jnp.int32)
    valid = valid_bytes.astype(jnp.int32)

    def step(i, state):
        wordpos, bitpos, out = state
        w0 = jnp.take(stream, wordpos, mode="clip")
        w1 = jnp.take(stream, jnp.minimum(wordpos + 1, nw - 1), mode="clip")
        window = bitio.extract_window(w0, w1, bitpos)
        idx = (window >> jnp.uint32(32 - table_bits)).astype(jnp.int32)
        sym = jnp.take(syms_i, idx, mode="clip")
        length = jnp.take(lens_i, idx, mode="clip")
        # Lane b decodes its block's byte i; stop past the block's share.
        active = i < valid
        length = jnp.where(active, length, 0)
        sym = jnp.where(active, sym, 0)
        out = jax.lax.dynamic_update_index_in_dim(
            out, sym.astype(jnp.uint8), i, axis=0)
        bitpos = bitpos + length
        wordpos = wordpos + (bitpos >> 5)
        bitpos = bitpos & 31
        return wordpos, bitpos, out

    out0 = jnp.zeros((block_bytes, nb), jnp.uint8)   # (byte-step, lane)
    _, _, out = jax.lax.fori_loop(
        0, block_bytes, step,
        (word_base.astype(jnp.int32), bit_shift.astype(jnp.int32), out0))
    return out.T
