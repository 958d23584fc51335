"""Self-describing container file format (.htz) for encoded streams.

The reference has no on-disk format at all — its output lives and dies in
device memory within one process run (SURVEY.md section 5, checkpoint row:
"the packed bitstream + codebook fully determine resumability per block").
This container makes that observation concrete: the header carries the
canonical codebook (as 256 code lengths — canonical codes are fully
determined by lengths) and the per-block bit counts, so any block range can
be decoded independently: the format doubles as checkpoint/resume state.

Layout (all integers little-endian):

  offset  size  field
  0       4     magic  b"HTZ1"
  4       4     version (u32) = 1
  8       4     flags (u32; bit 0 = payload CRC-32 appended, see below)
  12      8     original length in bytes (u64)
  20      4     block_bytes (u32)
  24      4     max_code_len (u32)
  28      8     total_bits (u64)
  36      4     num_blocks (u32)
  40      256   code lengths, one byte per symbol
  296     4*NB  per-block bit counts (u32 each)
  ...           payload: ceil(total_bits/32) words, each stored big-endian
                (so the payload bytes are exactly the MSB-first bitstream)
  ...     4     CRC-32 of the payload bytes (u32, when flags bit 0 set;
                writers set it by default, readers accept its absence)

Version 3 (the retired interleaved "wide" format, spec and reference
codec in golden/wide_codec.py) is read-only: files written by earlier
releases load and decode on the host through that spec decoder
(decode_wide).  Nothing writes it any more.  Its layout: the same header
with block_bytes := the tile size, total_bits := payload words * 32 and
num_blocks := the tile count; the per-block table holds per-TILE payload
PLANE word counts (u32 each), followed by the per-tile per-round
pull-index bases (ROUNDS u16 per tile), and the payload is the
word-aligned concatenation of tile payloads, each tile stored as plane
P0 then plane P1 (words little-endian).  Version 2 is retired entirely.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .api import Encoded
from .codebook import Codebook
from .config import CodecConfig, cdiv

MAGIC = b"HTZ1"
VERSION = 1
_HEADER = struct.Struct("<4sIIQIIQI")  # magic, ver, flags, n, bb, mcl, bits, nb

# flags bit 0: a u32 CRC-32 (zlib polynomial) of the payload bytes is
# appended after the payload and verified on load.  Writers set it by
# default (checksum=False opts out); readers accept flag-less (pre-r5)
# containers unchanged — the reserved-flags escape hatch at work.
FLAG_CRC32 = 1


def _crc_check(blob: bytes, flags: int, pay_off: int, pay_len: int) -> None:
    """Verify the appended payload CRC when FLAG_CRC32 is set.

    Turns silent payload corruption (bit flips decode to garbage — the
    fuzz tests used to assert only 'no crash') into a clean error."""
    if not flags & FLAG_CRC32:
        return
    if len(blob) < pay_off + pay_len + 4:
        raise ValueError("truncated HTZ container (missing payload CRC)")
    import zlib
    want = struct.unpack_from("<I", blob, pay_off + pay_len)[0]
    got = zlib.crc32(blob[pay_off: pay_off + pay_len]) & 0xFFFFFFFF
    if got != want:
        raise ValueError(
            f"HTZ payload CRC mismatch (stored {want:#010x}, computed "
            f"{got:#010x}) — container corrupt")


def dumps(enc: Encoded, checksum: bool = True) -> bytes:
    """Serialize an Encoded stream to container bytes.

    checksum=False skips the payload CRC (a single-threaded ~1.5 GB/s
    host pass — noticeable next to the device kernels at GiB scale);
    readers accept either form (flags bit 0)."""
    header = _HEADER.pack(MAGIC, VERSION, FLAG_CRC32 if checksum else 0,
                          enc.n_bytes,
                          enc.config.block_bytes, enc.config.max_code_len,
                          enc.total_bits, len(enc.block_bits))
    lens = np.asarray(enc.codebook.lengths, dtype=np.uint8).tobytes()
    bbits = np.asarray(enc.block_bits, dtype=np.uint32).tobytes()
    n_words = cdiv(enc.total_bits, 32)
    payload = np.ascontiguousarray(
        enc.stream_words[:n_words], dtype=np.uint32).astype(">u4").tobytes()
    if not checksum:
        return header + lens + bbits + payload
    import zlib
    crc = struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)
    return header + lens + bbits + payload + crc


def loads(blob: bytes) -> Encoded:
    """Deserialize container bytes back to an Encoded stream."""
    if len(blob) < _HEADER.size:
        raise ValueError(
            f"not an HTZ container: {len(blob)} bytes < header size")
    magic, ver, flags, n_bytes, block_bytes, max_code_len, total_bits, nb = \
        _HEADER.unpack_from(blob, 0)
    if magic != MAGIC:
        raise ValueError(f"not an HTZ container (magic {magic!r})")
    if ver != VERSION:
        raise ValueError(f"unsupported container version {ver}")
    if len(blob) < overhead_bytes(nb) + 4 * cdiv(total_bits, 32):
        raise ValueError("truncated HTZ container")
    _crc_check(blob, flags, overhead_bytes(nb), 4 * cdiv(total_bits, 32))
    off = _HEADER.size
    lens = np.frombuffer(blob, dtype=np.uint8, count=256, offset=off)
    off += 256
    block_bits = np.frombuffer(blob, dtype=np.uint32, count=nb,
                               offset=off).astype(np.int32)
    off += 4 * nb
    n_words = cdiv(total_bits, 32)
    words = np.frombuffer(blob, dtype=">u4", count=n_words,
                          offset=off).astype(np.uint32)
    cfg = CodecConfig(block_bytes=block_bytes, max_code_len=max_code_len)
    cb = Codebook.from_lengths(lens.astype(np.int32))
    return Encoded(stream_words=words, total_bits=total_bits,
                   block_bits=block_bits, codebook=cb,
                   n_bytes=n_bytes, config=cfg)


WIDE_VERSION = 3


@dataclasses.dataclass(frozen=True)
class WideEncoded:
    """A version-3 (wide) container's contents."""
    payload_words: np.ndarray     # per tile: P0 then P1, concatenated
    tile_words: np.ndarray        # (NT,) int32 PLANE words per tile
    bases: np.ndarray             # (NT, ROUNDS) int32 per-round pull bases
    codebook: Codebook
    n_bytes: int
    config: CodecConfig


def decode_wide(enc: WideEncoded) -> np.ndarray:
    """Decode a version-3 container on the host with the format's NumPy
    spec decoder (golden/wide_codec.decode).  A reader for files written
    by earlier releases, not a device path."""
    from .golden.wide_codec import decode
    tiles = []
    start = 0
    for tw, bases in zip(enc.tile_words.astype(np.int64), enc.bases):
        p0 = enc.payload_words[start: start + tw]
        p1 = enc.payload_words[start + tw: start + 2 * tw]
        tiles.append((p0, p1, bases))
        start += 2 * tw
    syms, lens = enc.codebook.decode_table()
    mcl = int(enc.codebook.lengths.max(initial=1)) or 1
    return decode(tiles, enc.n_bytes, syms, lens,
                  max(int(enc.codebook.max_len), 1), mcl)


def loads_wide(blob: bytes) -> WideEncoded:
    """Deserialize container version 3."""
    from .golden.wide_codec import MAXLEN, ROUNDS, TILE_BYTES
    magic, ver, flags, n_bytes, tile, max_code_len, bits, nt = \
        _HEADER.unpack_from(blob, 0)
    if magic != MAGIC or ver != WIDE_VERSION:
        raise ValueError(f"not a version-{WIDE_VERSION} (wide) HTZ container")
    # The stored tile size and code-length cap are format constants: a
    # different value would silently misdecode the payload.
    if tile != TILE_BYTES:
        raise ValueError(
            f"wide container tile size {tile} != supported {TILE_BYTES}")
    if not (1 <= max_code_len <= MAXLEN):
        raise ValueError(
            f"wide container max_code_len {max_code_len} outside [1, {MAXLEN}]")
    if len(blob) < overhead_bytes(nt) + 2 * ROUNDS * nt + 4 * (bits // 32):
        raise ValueError("truncated HTZ container")
    _crc_check(blob, flags, overhead_bytes(nt) + 2 * ROUNDS * nt,
               4 * (bits // 32))
    off = _HEADER.size
    lens = np.frombuffer(blob, dtype=np.uint8, count=256, offset=off)
    off += 256
    counts = np.frombuffer(blob, dtype=np.uint32, count=nt,
                           offset=off).astype(np.int32)
    off += 4 * nt
    bases = np.frombuffer(blob, dtype=np.uint16, count=nt * ROUNDS,
                          offset=off).astype(np.int32).reshape(nt, ROUNDS)
    off += 2 * ROUNDS * nt
    words = np.frombuffer(blob, dtype=np.uint32, count=bits // 32,
                          offset=off)
    cfg = CodecConfig(max_code_len=max_code_len)
    cb = Codebook.from_lengths(lens.astype(np.int32))
    return WideEncoded(payload_words=words.copy(), tile_words=counts,
                       bases=bases, codebook=cb, n_bytes=n_bytes,
                       config=cfg)


def container_version(blob: bytes) -> int:
    if len(blob) < _HEADER.size or blob[:4] != MAGIC:
        raise ValueError("not an HTZ container")
    return _HEADER.unpack_from(blob, 0)[1]


def dump(enc: Encoded, path: str, checksum: bool = True) -> int:
    blob = dumps(enc, checksum)
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def load(path: str):
    """Load either container version (dense Encoded or WideEncoded)."""
    with open(path, "rb") as f:
        blob = f.read()
    return (loads_wide(blob) if container_version(blob) == WIDE_VERSION
            else loads(blob))


def overhead_bytes(num_blocks: int) -> int:
    """Container overhead for a given block count (header + tables)."""
    return _HEADER.size + 256 + 4 * num_blocks
