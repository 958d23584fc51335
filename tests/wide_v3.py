"""Build version-3 (wide) containers, as earlier releases wrote them, from
the format's NumPy spec encoder (golden/wide_codec.py) — test input for
the read-only v3 path in container.py."""

import struct
import zlib

import numpy as np

from huffman_tpu import container
from huffman_tpu.codebook import Codebook
from huffman_tpu.config import CodecConfig
from huffman_tpu.golden import wide_codec


def encode_v3(data, max_code_len: int = 12) -> container.WideEncoded:
    cb = Codebook.from_data(data, max_code_len)
    tiles, n = wide_codec.encode(data, cb.codes, cb.lengths)
    payload = np.concatenate([np.concatenate([p0, p1])
                              for p0, p1, _ in tiles]).astype(np.uint32)
    return container.WideEncoded(
        payload_words=payload,
        tile_words=np.array([p0.size for p0, _, _ in tiles], np.int32),
        bases=np.stack([b for _, _, b in tiles]).astype(np.int32),
        codebook=cb, n_bytes=n,
        config=CodecConfig(max_code_len=max_code_len))


def dumps_v3(enc: container.WideEncoded, checksum: bool = True) -> bytes:
    """Container version 3 bytes: header, lengths, per-tile plane words,
    per-tile round bases (u16), payload (little-endian words), CRC."""
    header = container._HEADER.pack(
        container.MAGIC, container.WIDE_VERSION,
        container.FLAG_CRC32 if checksum else 0, enc.n_bytes,
        wide_codec.TILE_BYTES, enc.config.max_code_len,
        int(enc.payload_words.size) * 32, len(enc.tile_words))
    payload = enc.payload_words.astype("<u4").tobytes()
    blob = (header + enc.codebook.lengths.astype(np.uint8).tobytes()
            + enc.tile_words.astype("<u4").tobytes()
            + enc.bases.astype("<u2").tobytes() + payload)
    if checksum:
        blob += struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)
    return blob
