"""Fused encode + pack: blocks of bytes straight into the dense stream.

A Pallas kernel on the Triton route (reference design:
vlc_kernel_sm64huff.cu:37-160 encodes a 1 KiB block per CUDA block, then
pack_kernels.cu:19-52 stitches the blocks at bit offsets).  Here the two
stages are one kernel, because the block offsets are known before it
runs: the host holds the exact per-block bit counts (block_bits below,
needed anyway for the container header and the overflow check), so each
block's (word, bit) start is an exclusive scan of them and every block
can write its codes directly at their final position.  No per-block
streams are staged: besides the stream, the kernel writes one run-slot
word per output word.

Per block, with codes placed MSB-first (ops/bitio.py):

  * L = lengths[byte], off = exclusive cumsum of L (+ the block's start
    bit), d0 = off >> 5: the word each code starts in.  With codes of at
    most 24 bits, every word of the block's span holds at least one code
    start, so "the codes starting in word j" is a run of bytes, and the
    block's j-th run fills its j-th word.
  * part0/part1 = the code's bits in words d0 and d0+1 (bitio
    .code_word_parts).  Bits are disjoint, so OR == ADD, and
    H = cumsum(part0 + part1) - part1 at a run's last byte is everything
    up to and including that run's word (mod 2**32, exact because each
    word's true sum fits).  The word's value is H minus the previous
    run's H: each run end stores H in slot j of the block's run slots,
    and after a barrier reads slot j-1 back.
  * One atomic OR per run writes the word; the block's last code also
    ORs its spill (part1) into the next word.  Only seam words are
    shared between blocks, and their bits are disjoint.

The OR goes through `atomic_or`: Pallas' tensor `atomic_add` lowers to a
float add on this route.  The interpreter has no `atomic_or`, so tests
run the same arithmetic with `atomic_add` of the disjoint values.

block_bits (plain XLA, fused gather + reduction) is the first pass: the
exact bit count of each block and the missing-symbol flag (a valid byte
whose symbol has no code), which the sampled codebook build and the
explicit-codebook ValueError depend on.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import bitio

# Blocks encoded by one program.  Each program is R x (block width) lanes.
ROWS_PER_PROGRAM = 2
NUM_WARPS = 4


@jax.jit
def block_bits(byte_blocks, lengths, valid_bytes):
    """Exact bits per block and missing-symbol flag, before any encode.

    byte_blocks: (NB, BB) uint8; lengths: (256,) int32; valid_bytes:
    (NB,) int32.  Returns (bits (NB,) int32, missing (NB,) bool) — missing
    is true where a valid byte's symbol has length 0 (no code).
    """
    lens = jnp.take(lengths.astype(jnp.int32), byte_blocks.astype(jnp.int32),
                    axis=0)
    pos = jnp.arange(byte_blocks.shape[1], dtype=jnp.int32)[None, :]
    live = pos < valid_bytes.astype(jnp.int32)[:, None]
    bits = jnp.sum(jnp.where(live, lens, 0), axis=1)
    missing = jnp.any(live & (lens == 0), axis=1)
    return bits, missing


def _kernel(blocks_ref, codes_ref, lengths_ref, valid_ref, base_ref,
            shift_ref, _zeros_ref, out_ref, runs_ref, *, stride: int,
            interpret: bool):
    sym = blocks_ref[...].astype(jnp.int32)                  # (R, P)
    rows, width = sym.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, sym.shape, 1)
    valid = valid_ref[...][:, None]
    live = pos < valid
    L = jnp.where(live, lengths_ref[sym], 0)
    code = codes_ref[sym]
    ends = jnp.cumsum(L, axis=1) + shift_ref[...][:, None]
    starts = ends - L
    d0 = starts >> 5
    part0, part1 = bitio.code_word_parts(code, L, starts & 31)
    last = pos == valid - 1
    run_end = live & (((ends >> 5) != d0) | last)
    h = jnp.cumsum(part0 + part1, axis=1) - part1
    # H of run j goes to slot j of this block's row (`stride` slots) of
    # the runs buffer; after a barrier each run end reads its
    # predecessor's H back.  The word's value is the difference (0 for
    # the block's first run).
    row = pl.program_id(0) * rows + jax.lax.broadcasted_iota(
        jnp.int32, sym.shape, 0)
    slot = row * stride + d0
    prev_slot = slot - 1
    has_prev = run_end & (d0 > 0)
    word = base_ref[...][:, None] + d0
    spill = run_end & last
    if interpret:
        # The interpreter runs programs in order (no barrier needed), its
        # atomics take no mask and keep one of several updates to one
        # index: idle lanes go to the scratch slot/word (the buffers'
        # last) with 0, one row at a time (two rows can share a seam).
        scratch = runs_ref.shape[0] - 1
        runs_ref[jnp.where(run_end, slot, scratch)] = h
        prev = jnp.where(has_prev,
                         runs_ref[jnp.where(has_prev, prev_slot, scratch)],
                         jnp.uint32(0))
        w = h - prev
        scratch = out_ref.shape[0] - 1
        for r in range(rows):
            for m, idx, val in ((run_end[r], word[r], w[r]),
                                (spill[r], word[r] + 1, part1[r])):
                plgpu.atomic_add(out_ref, jnp.where(m, idx, scratch),
                                 jnp.where(m, val, jnp.uint32(0)))
    else:
        plgpu.store(runs_ref.at[slot], h, mask=run_end)
        plgpu.debug_barrier()
        prev = plgpu.load(runs_ref.at[prev_slot], mask=has_prev, other=0,
                          volatile=True)
        w = h - prev
        # bits of different blocks in a seam word are disjoint: OR them
        plgpu.atomic_or(out_ref, word, w, mask=run_end)
        plgpu.atomic_or(out_ref, word + 1, part1, mask=spill)


@functools.partial(jax.jit, static_argnames=("out_words", "capacity_words",
                                             "interpret"))
def encode_pack(byte_blocks, codes, lengths, valid_bytes, word_base,
                bit_shift, out_words: int, capacity_words: int,
                interpret: bool = False):
    """Encode every block into one dense stream at the given offsets.

    byte_blocks: (NB, BB) uint8; codes (256,) uint32; lengths (256,)
    int32 (every valid byte's symbol must have a code: check block_bits'
    missing flag first); valid_bytes (NB,) int32; word_base / bit_shift
    (NB,) int32: each block's start word and bit (the exclusive scan of
    block_bits, ops/scan.py form).  Every block must fit capacity_words
    (it sizes the kernel's per-block run slots).  Returns the
    (out_words,) uint32 stream; out_words must exceed the last word any
    block touches.
    """
    nb, bb = byte_blocks.shape
    width = pl.next_power_of_2(bb)
    rows = ROWS_PER_PROGRAM
    nbp = -(-nb // rows) * rows
    if (nbp, width) != (nb, bb):
        # Triton blocks are powers of two; padding lanes and padding
        # blocks have no valid bytes and write nothing
        byte_blocks = jnp.pad(byte_blocks, ((0, nbp - nb), (0, width - bb)))
        pad = (0, nbp - nb)
        valid_bytes = jnp.pad(valid_bytes, pad)
        word_base = jnp.pad(word_base, pad)
        bit_shift = jnp.pad(bit_shift, pad)
    row_spec = pl.BlockSpec((rows,), lambda i: (i,))
    lut_spec = pl.BlockSpec((256,), lambda i: (0,))
    # under the interpreter, one scratch word past each buffer (_kernel)
    extra = 1 if interpret else 0
    size = out_words + extra
    stride = capacity_words + 1          # run slots per block
    runs = nbp * stride + extra
    if max(size, runs) >= 1 << 31:
        raise ValueError("too many blocks for one encode call: indices "
                         "must fit int32 (shard the input over devices)")
    zeros = jnp.zeros(size, jnp.uint32)
    out = pl.pallas_call(
        functools.partial(_kernel, stride=stride, interpret=interpret),
        grid=(nbp // rows,),
        in_specs=[pl.BlockSpec((rows, width), lambda i: (i, 0)),
                  lut_spec, lut_spec, row_spec, row_spec, row_spec,
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 2,
        out_shape=[jax.ShapeDtypeStruct((size,), jnp.uint32),
                   jax.ShapeDtypeStruct((runs,), jnp.uint32)],
        input_output_aliases={6: 0},
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        name="huffman_encode_pack",
    )(byte_blocks, codes.astype(jnp.uint32), lengths.astype(jnp.int32),
      valid_bytes.astype(jnp.int32), word_base.astype(jnp.int32),
      bit_shift.astype(jnp.int32), zeros)[0]
    return out[:out_words] if interpret else out
