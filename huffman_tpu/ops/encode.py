"""Block-local variable-length encode (plain XLA path).

Counterpart of the reference's encode kernel (reference:
vlc_kernel_sm64huff.cu:37-160), written as whole-array XLA ops.  It is
the CPU path and the reference the GPU kernel (ops/pallas/encode_pack.py)
is checked against.  Structural correspondence:

  CUDA (one 256-thread block per 1 KiB)        XLA (vectorized over blocks)
  -------------------------------------        ---------------------------
  SM-cached codeword LUT (:56-63)              jnp.take gathers from HBM LUTs
  4-symbol concat into 64-bit cw64 (:66-82)    per-*byte* placement: codes are
                                               <= 24 bits so each spans <= 2
                                               words; no 64-bit emulation
  in-place Blelloch scan of lengths (:87-117)  fused jnp.cumsum along bytes
  3-part shared-mem atomicOr write (:131-154)  2-part disjoint-bit scatter-add
                                               (OR == ADD because bit ranges
                                               are disjoint) — deterministic
  outidx[block] = total bits (:119-122)        block_bits output

The reference requires exactly 256 threads/block and compression ratio <= 1
or it corrupts shared memory (vlc_kernel_sm64huff.cu:30-32); here block size
and capacity are config knobs and overflow is *detected* (api.check_capacity
raises before any encode).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import bitio


@functools.partial(jax.jit, static_argnames=("capacity_words",))
def encode_blocks(byte_blocks: jax.Array, codes: jax.Array, lengths: jax.Array,
                  valid_bytes: jax.Array, capacity_words: int):
    """Encode independent blocks of bytes into per-block bitstreams.

    Args:
      byte_blocks: (NB, BB) uint8 — the padded input stream, one row per block.
      codes: (256,) uint32 right-aligned canonical codeword values.
      lengths: (256,) int32 codeword bit lengths (0 = absent symbol).
      valid_bytes: (NB,) int32 — real byte count of each block (BB for full
        blocks, less for the final partial block, 0 for mesh-padding blocks).
        Per-block rather than a global scalar so the function is shard-local
        under shard_map with no global positions.
      capacity_words: static per-block output capacity in 32-bit words.

    Returns:
      packed: (NB, capacity_words) uint32 — each block's bitstream,
        MSB-first, starting at bit 0 of word 0 (block-aligned, uncompacted —
        same intermediate form as the reference's `out` at
        vlc_kernel_sm64huff.cu:158).
      block_bits: (NB,) int32 — bits used per block (the reference's outidx).
    """
    nb, bb = byte_blocks.shape
    sym = byte_blocks.astype(jnp.int32)
    L = jnp.take(lengths.astype(jnp.int32), sym, axis=0)
    c = jnp.take(codes.astype(jnp.uint32), sym, axis=0)

    pos = jnp.arange(bb, dtype=jnp.int32)[None, :]
    L = jnp.where(pos < valid_bytes.astype(jnp.int32)[:, None], L, 0)

    ends = jnp.cumsum(L, axis=1)                 # inclusive bit ends
    off = ends - L                               # exclusive bit offsets
    block_bits = ends[:, -1]

    d0 = off >> 5                                # destination word in block
    sh = off & 31                                # start bit within that word
    part0, part1 = bitio.code_word_parts(c, L, sh)

    out = jnp.zeros((nb, capacity_words), jnp.uint32)
    rows = jnp.broadcast_to(jnp.arange(nb, dtype=jnp.int32)[:, None], (nb, bb))
    # Disjoint bit ranges make add == or; 'drop' guards the d0+1 spill of the
    # final code in a full block (and any capacity overflow, detected below).
    out = out.at[rows, d0].add(part0, mode="drop")
    out = out.at[rows, d0 + 1].add(part1, mode="drop")
    return out, block_bits

