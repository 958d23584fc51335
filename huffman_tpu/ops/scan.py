"""Exclusive scans of per-block bit counts, in (word, bit) split form.

Replaces the reference's multi-level GPU Gems prescan machinery
(reference: scan.cu:39-231, scanLargeArray_kernel.cu:75-258) — ~500 lines of
recursive kernel launches, per-level block-sum buffers and bank-conflict
padding — with XLA's fused `cumsum`, plus one structural idea of our own:

The reference scans 32-bit *bit* counts, which overflows past 512 MiB of
encoded output.  We scan the (full_words, remainder_bits) decomposition
instead: bits = 32*w + r with r in [0,32).  Both component cumsums stay in
int32 up to ~64 GiB streams (r-cumsum <= 31 * num_blocks), and the pack
stage only ever needs (word_base, bit_shift) — never the raw 64-bit offset.

The codec itself scans on the host, exactly in int64, since the bit
counts are fetched there anyway (api.block_offsets, also per shard in
parallel/pipeline.py); this device scan serves the plain XLA reference
pipeline (ops/pack.pack_blocks).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

WORD_BITS = 32


class BitOffsets(NamedTuple):
    """Exclusive bit offsets of each block, split to avoid 64-bit ints.

    word_base[i]: index of the 32-bit word where block i's bits begin.
    bit_shift[i]: starting bit within that word (0..31, from the MSB).
    total_words: total words spanned (scalar, includes the partial tail word).
    total_rem_bits / total_full_words: components of the grand-total bit
      count: total_bits = 32 * total_full_words + total_rem_bits.
    """
    word_base: jax.Array
    bit_shift: jax.Array
    total_words: jax.Array
    total_full_words: jax.Array
    total_rem_bits: jax.Array


def exclusive_bit_offsets(block_bits: jax.Array) -> BitOffsets:
    """Exclusive scan of per-block bit counts -> per-block (word, bit) starts.

    block_bits: (NB,) int32/uint32, bits emitted by each block (the analogue
    of the reference's d_cindex written at vlc_kernel_sm64huff.cu:120 and
    scanned at scan.cu:228-231).
    """
    bits = block_bits.astype(jnp.int32)
    w = bits >> 5           # full words per block
    r = bits & 31           # leftover bits per block
    cw = jnp.cumsum(w)      # inclusive
    cr = jnp.cumsum(r)
    ex_w = cw - w           # exclusive
    ex_r = cr - r
    word_base = ex_w + (ex_r >> 5)
    bit_shift = ex_r & 31
    total_full = cw[-1] if cw.shape[0] > 0 else jnp.int32(0)
    total_r = cr[-1] if cr.shape[0] > 0 else jnp.int32(0)
    # total_r is a sum of remainders and can exceed 32; fold it in.
    total_words = total_full + (total_r >> 5) + jnp.where(
        (total_r & 31) > 0, 1, 0).astype(jnp.int32)
    return BitOffsets(word_base=word_base, bit_shift=bit_shift,
                      total_words=total_words,
                      total_full_words=total_full, total_rem_bits=total_r)

