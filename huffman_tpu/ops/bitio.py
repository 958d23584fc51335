"""Deterministic bit-level I/O primitives (device side).

Counterpart of the reference's atomic bit-put device library
(reference: pabio_kernels_v2.cu:17-61, `put_bits_atomic2`): where that
library resolves concurrent sub-word writes with atomicAnd/atomicOr, these
express the same bit placement as pure functions whose contributions are
combined by OR/ADD (equal on disjoint bits) — the XLA path by scatter-add,
the GPU kernel by a cumsum and one OR per output word.

All functions are shape-polymorphic jnp element-wise ops, usable both in
plain XLA code and inside Pallas kernel bodies.

Bitstream convention (matches the golden codec, golden/cpu_codec.cpp):
bit i of the stream lives in 32-bit word (i >> 5) at bit (31 - (i & 31)),
i.e. MSB-first within big-endian-viewed words.
"""

from __future__ import annotations

import jax.numpy as jnp

WORD_BITS = 32
_U32 = jnp.uint32


def _u32(x):
    return x.astype(_U32) if hasattr(x, "astype") else jnp.uint32(x)


def safe_shl(x, n):
    """x << n with n possibly >= 32 (result 0), defined for n in [0, 63]."""
    x = _u32(x)
    n = jnp.asarray(n, jnp.int32)
    shifted = x << _u32(jnp.clip(n, 0, WORD_BITS - 1))
    return jnp.where((n >= WORD_BITS) | (n < 0), _U32(0), shifted)


def safe_shr(x, n):
    """x >> n (logical) with n possibly >= 32 (result 0)."""
    x = _u32(x)
    n = jnp.asarray(n, jnp.int32)
    shifted = x >> _u32(jnp.clip(n, 0, WORD_BITS - 1))
    return jnp.where((n >= WORD_BITS) | (n < 0), _U32(0), shifted)


def code_word_parts(code, length, bit_offset):
    """Place a right-aligned codeword at a bit offset within a word pair.

    Given a code of `length` bits (value right-aligned in a uint32) that
    must start at bit `bit_offset` (0..31, counted from the word MSB), return
    (part0, part1): the OR-contributions to the destination word and the
    next word.  This is the functional equivalent of the reference encode
    kernel's 3-part atomicOr write (vlc_kernel_sm64huff.cu:131-154) — two
    parts suffice because per-*byte* codes are <= 24 bits (config.max_code_len
    <= 24), whereas the reference concatenates 4 symbols into <= 64 bits.

    length == 0 contributes nothing (used for masking padding bytes).
    """
    code = _u32(code)
    length = jnp.asarray(length, jnp.int32)
    bit_offset = jnp.asarray(bit_offset, jnp.int32)
    end = bit_offset + length
    code = jnp.where(length > 0, code, _U32(0))
    fits = end <= WORD_BITS
    part0 = jnp.where(fits, safe_shl(code, WORD_BITS - end),
                      safe_shr(code, end - WORD_BITS))
    part1 = jnp.where(fits, _U32(0), safe_shl(code, 2 * WORD_BITS - end))
    return part0, part1


def shift_word_stream(words, prev_words, shift):
    """Shift a word-aligned bitstream right by `shift` bits (0..31).

    out[j] = (words[j] >> shift) | (prev_words[j] << (32 - shift)), where
    prev_words[j] is the word preceding words[j] (i.e. words shifted by one
    position, with 0 in front).  Vector equivalent of the reference pack
    kernel's shift-merge loop (pack_kernels.cu:36-41).
    """
    words = _u32(words)
    prev_words = _u32(prev_words)
    shift = jnp.asarray(shift, jnp.int32)
    lo = safe_shr(words, shift)
    hi = jnp.where(shift == 0, _U32(0),
                   prev_words << _u32((WORD_BITS - shift) & (WORD_BITS - 1)))
    return lo | hi


def extract_window(w0, w1, bitpos):
    """Read 32 bits starting at bit `bitpos` (0..31) of word w0 (w1 follows).

    Used by the decoder to peek at an arbitrary bit cursor.
    """
    w0 = _u32(w0)
    w1 = _u32(w1)
    bitpos = jnp.asarray(bitpos, jnp.int32)
    hi = jnp.where(bitpos == 0, w0, w0 << _u32(bitpos & (WORD_BITS - 1)))
    lo = jnp.where(bitpos == 0, _U32(0),
                   w1 >> _u32((WORD_BITS - bitpos) & (WORD_BITS - 1)))
    return hi | lo
