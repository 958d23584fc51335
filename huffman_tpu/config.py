"""Runtime configuration for the Huffman codec.

Replaces the reference's compile-time parameter header
(reference: parameters.h:1-26) and file-derived geometry init
(reference: load_data.h:8-23).  Where the reference bakes NUM_SYMBOLS / DPT /
TESTING / CACHECWLUT into the binary and hardcodes 256 threads per block
(main_test_cu.cu:43), we use a runtime dataclass: block geometry, codeword
length limits, verification toggles and mesh shape are all per-call options,
and every derived quantity handles arbitrary input sizes (the reference
admits it does not: load_data.h:20 "//todo" on remainder handling).
"""

from __future__ import annotations

import dataclasses
import math

# The symbol alphabet is bytes, as in the reference (parameters.h:22
# NUM_SYMBOLS 256).  This is fixed: the codec is a byte-stream codec.
NUM_SYMBOLS = 256

# Stream words are 32-bit, MSB-first, as in the reference bitstream
# convention (cpuencode.cpp:32-40).
WORD_BITS = 32
WORD_BYTES = 4


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """All runtime knobs of the codec.

    Attributes:
      block_bytes: bytes per independently-encoded block.  The reference uses
        1 KiB blocks (256 threads x 4 bytes, vlc_kernel_sm64huff.cu:31,
        parameters.h:23 DPT=4).  Must be a multiple of 4.
      max_code_len: canonical-Huffman codeword length cap in bits.  The
        reference relies on data-dependent luck to stay <=32
        (cpuencode.cpp:10); we enforce the cap with package-merge
        (length-limited Huffman) so the table-driven decoder always works
        with a single 2**max_code_len-entry lookup.  Default 12: it keeps
        the decoder's table at 4096 entries, and 12-bit-limited codes cost
        <<1% compression on byte alphabets; up to 24 is accepted.
      capacity_bits_per_byte: per-block encoded-output capacity, in bits per
        input byte.  The reference assumes compression ratio <= 1, i.e. 8
        bits/byte (vlc_kernel_sm64huff.cu:30-32); we keep that default but
        make it a knob and *check* for overflow instead of corrupting memory.
      table_bits: decoder lookup-table width.  Must be >= max_code_len.
    """

    block_bytes: int = 1024
    max_code_len: int = 12
    capacity_bits_per_byte: int = 8
    table_bits: int | None = None

    def __post_init__(self):
        if self.block_bytes % WORD_BYTES != 0:
            raise ValueError("block_bytes must be a multiple of 4")
        if not (1 <= self.max_code_len <= 24):
            raise ValueError("max_code_len must be in [1, 24]")
        if self.table_bits is not None and self.table_bits < self.max_code_len:
            raise ValueError("table_bits must be >= max_code_len")

    @property
    def block_words(self) -> int:
        return self.block_bytes // WORD_BYTES

    @property
    def capacity_words(self) -> int:
        """Encoded-output capacity per block, in 32-bit words."""
        return cdiv(self.block_bytes * self.capacity_bits_per_byte, WORD_BITS)

    @property
    def decode_table_bits(self) -> int:
        return self.table_bits if self.table_bits is not None else self.max_code_len

    def num_blocks(self, n_bytes: int) -> int:
        """Blocks needed for an n-byte stream (last block may be partial)."""
        return max(1, cdiv(n_bytes, self.block_bytes))

    def padded_bytes(self, n_bytes: int) -> int:
        return self.num_blocks(n_bytes) * self.block_bytes


DEFAULT_CONFIG = CodecConfig()
