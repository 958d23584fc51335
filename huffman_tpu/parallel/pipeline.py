"""Data-parallel encode/decode over a device mesh (shard_map).

The reference is single-GPU (SURVEY.md section 2 parallelism table); this
module is the scale-out: blocks are data-parallel across devices, and
the only cross-device traffic is

  * the per-shard histograms, summed exactly (int64) on the host — the
    global analogue of the reference's shared-memory atomicAdd merge
    (hist.cu:51); a device psum in int32 would overflow past 2 GiB of
    skewed data;
  * the replicated codebook broadcast (jax replicates small operands);
  * the per-block bit counts, fetched once: the host scans them into
    every block's offset (the cross-shard level of the reference's
    multi-level scan, scan.cu:114-226) — the same host sync the
    single-device path makes;
  * the ordered gather + seam-OR of shard payloads at assembly time.

Every shard runs the single-device encode (backend.encode_stream: the
kernel on the GPU, XLA on the CPU) on its own blocks, into a shard-local
buffer that starts at the shard's first word, so `--mesh` takes the path
a single card takes and the result is bit-identical to api.encode.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .. import backend
from ..codebook import Codebook
from ..config import CodecConfig, DEFAULT_CONFIG, cdiv
from ..ops import histogram as hist_ops
from ..ops.pallas.encode_pack import block_bits
from .mesh import DATA_AXIS, fetch, put_global


@functools.lru_cache(maxsize=16)
def histogram_sharded(mesh: Mesh):
    """Jitted per-shard histograms, (ndev, 256) int32 sharded on the mesh.

    Sum the rows on the host in int64 (each shard stays under 2**31
    bytes; their total need not)."""

    @functools.partial(
        shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS)), out_specs=P(DATA_AXIS))
    def _hist(blocks_loc, valid_loc):
        return hist_ops.histogram(blocks_loc, valid_loc)[None, :]

    return jax.jit(_hist)


@functools.lru_cache(maxsize=16)
def bits_phase(mesh: Mesh):
    """Sharded encode pass 1: exact bits + missing flag per block."""

    @functools.partial(
        shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(DATA_AXIS), P(), P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)))
    def _bits(blocks_loc, lengths, valid_loc):
        return block_bits(blocks_loc, lengths, valid_loc)

    return jax.jit(_bits)


@functools.lru_cache(maxsize=16)
def encode_phase(mesh: Mesh, path: str, out_words: int,
                 capacity_words: int):
    """Sharded encode pass 2: each shard encodes its blocks into a local
    (1, out_words) buffer at host-scanned offsets relative to the
    shard's first word."""

    @functools.partial(
        shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(DATA_AXIS), P(), P(), P(DATA_AXIS), P(DATA_AXIS),
                  P(DATA_AXIS)),
        out_specs=P(DATA_AXIS))
    def _enc(blocks_loc, codes, lengths, valid_loc, base_loc, shift_loc):
        return backend.encode_stream(
            path, blocks_loc, codes, lengths, valid_loc, base_loc,
            shift_loc, out_words, capacity_words)[None, :]

    return jax.jit(_enc)


def assemble_dense(shard_streams: np.ndarray, shard_word_base: np.ndarray,
                   shard_words: np.ndarray, total_words: int) -> np.ndarray:
    """Stitch shard slices into the dense stream (host-side, ordered).

    Adjacent shards overlap by at most one word (the seam), whose bits
    are disjoint — the cross-shard analogue of the reference pack
    kernel's head/tail atomicOr (pack_kernels.cu:34,45-51).  Shard
    interiors are pairwise disjoint, so they are plain assignments run
    on a thread pool (numpy releases the GIL for large slice copies);
    only the n_shards seam words need the OR, done serially after."""
    out = np.zeros(total_words + 1, dtype=np.uint32)
    shard_streams = np.asarray(shard_streams)
    ns = shard_streams.shape[0]

    def place(s: int) -> None:
        base = int(shard_word_base[s])
        used = int(shard_words[s])
        if used > 1:
            out[base + 1: base + used] = shard_streams[s, 1:used]

    if ns > 1 and total_words >= (1 << 20):
        import os
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(min(ns, os.cpu_count() or 4)) as ex:
            list(ex.map(place, range(ns)))
    else:
        for s in range(ns):
            place(s)
    for s in range(ns):           # seam words (bit-disjoint with prior)
        if int(shard_words[s]):
            out[int(shard_word_base[s])] |= shard_streams[s, 0]
    return out[:total_words]


@dataclasses.dataclass(frozen=True)
class ShardedCodec:
    """Sharded encode/decode pipelines bound to a mesh + config."""
    mesh: Mesh
    cfg: CodecConfig = DEFAULT_CONFIG

    def prepare(self, data) -> tuple[np.ndarray, np.ndarray, int]:
        """Pad to (blocks x block_bytes) with block count a mesh multiple."""
        from ..api import _as_u8, valid_per_block
        arr = _as_u8(data)
        n = arr.size
        ndev = self.mesh.devices.size
        nb = cdiv(max(n, 1), self.cfg.block_bytes)
        nb = cdiv(nb, ndev) * ndev
        padded = np.zeros(nb * self.cfg.block_bytes, dtype=np.uint8)
        padded[:n] = arr
        blocks = padded.reshape(nb, self.cfg.block_bytes)
        valid = valid_per_block(n, nb, self.cfg.block_bytes)
        return blocks, valid, n

    def shard_inputs(self, blocks, valid):
        """Upload blocks + valid counts, sharded on the block axis."""
        bs = NamedSharding(self.mesh, P(DATA_AXIS))
        return put_global(blocks, bs), put_global(valid, bs)

    def histogram(self, d_blocks, valid: np.ndarray) -> np.ndarray:
        """Exact global histogram of the blocks whose valid counts are
        given (zero counts leave blocks out), as int64."""
        bs = NamedSharding(self.mesh, P(DATA_AXIS))
        rows = fetch(histogram_sharded(self.mesh)(
            d_blocks, put_global(valid, bs)))
        return rows.astype(np.int64).sum(axis=0)

    def _codebook(self, d_blocks, valid: np.ndarray,
                  sample_every: int) -> Codebook:
        """The same codebook api.encode builds for the same bytes: the
        histogram of every sample_every-th block (global index)."""
        if sample_every > 1:
            keep = np.arange(valid.size) % sample_every == 0
            valid = np.where(keep, valid, 0).astype(np.int32)
        return Codebook.from_frequencies(self.histogram(d_blocks, valid),
                                         self.cfg.max_code_len)

    def encode(self, data, codebook: Codebook | None = None):
        """Full sharded encode returning a single-device-identical Encoded.

        Same flow as api.encode — sampled codebook, exact bit counts and
        missing-symbol check, capacity check, host offset scan, encode
        into the stream — with each device pass run per shard.
        """
        from .. import api
        path = backend.encode_path()
        cfg = self.cfg
        blocks, valid, n = self.prepare(data)
        d_blocks, d_valid = self.shard_inputs(blocks, valid)
        explicit_cb = codebook is not None
        sampled = not explicit_cb and n >= api.SAMPLE_MIN_BYTES
        cb = codebook or self._codebook(
            d_blocks, valid, api.SAMPLE_EVERY if sampled else 1)
        rs = NamedSharding(self.mesh, P())
        bits_dev, missing = bits_phase(self.mesh)(
            d_blocks, put_global(cb.lengths, rs), d_valid)
        if fetch(missing).any():
            if explicit_cb:
                raise ValueError(api.MISSING_SYMBOL)
            cb = self._codebook(d_blocks, valid, 1)
            bits_dev, _ = bits_phase(self.mesh)(
                d_blocks, put_global(cb.lengths, rs), d_valid)
        bits = fetch(bits_dev)
        api.check_capacity(bits, cfg)
        total_bits = int(bits.astype(np.int64).sum())

        # Host scan: global starts, then each shard's offsets relative
        # to the word its first block starts in.
        ndev = self.mesh.devices.size
        nb_loc = bits.size // ndev
        ends = np.cumsum(bits.astype(np.int64))
        starts = ends - bits
        shard_word = starts[::nb_loc] >> 5
        shard_end = ends[nb_loc - 1::nb_loc]
        local = starts - np.repeat(shard_word << 5, nb_loc)
        used = (-(-shard_end // 32) - shard_word).astype(np.int64)
        bs = NamedSharding(self.mesh, P(DATA_AXIS))
        enc = encode_phase(self.mesh, path, nb_loc * cfg.capacity_words + 1,
                           cfg.capacity_words)
        shard_streams = enc(
            d_blocks, put_global(cb.codes, rs), put_global(cb.lengths, rs),
            d_valid, put_global((local >> 5).astype(np.int32), bs),
            put_global((local & 31).astype(np.int32), bs))
        width = int(used.max(initial=0))
        stream = assemble_dense(fetch(shard_streams[:, :width]),
                                shard_word, used, cdiv(total_bits, 32))
        return api.Encoded(stream_words=stream, total_bits=total_bits,
                           block_bits=bits[: cfg.num_blocks(n)],
                           codebook=cb, n_bytes=n, config=cfg)

    def decode(self, enc) -> np.ndarray:
        """Sharded decode: blocks split over the mesh, stream replicated;
        each shard runs the XLA table-gather reader on its blocks."""
        from ..api import block_offsets, table_bits, valid_per_block
        from ..ops import decode as decode_ops
        backend.platform()
        if enc.n_bytes == 0:
            return np.zeros(0, np.uint8)
        cfg = enc.config
        ndev = self.mesh.devices.size
        nb = len(enc.block_bits)
        nb_pad = cdiv(nb, ndev) * ndev
        bits = np.zeros(nb_pad, np.int32)
        bits[:nb] = enc.block_bits
        word_base, bit_shift = block_offsets(bits)
        valid = valid_per_block(enc.n_bytes, nb_pad, cfg.block_bytes)
        tb = table_bits(enc)
        syms, lens = enc.codebook.decode_table(tb)
        stream = np.concatenate([enc.stream_words, np.zeros(2, np.uint32)])

        bs = NamedSharding(self.mesh, P(DATA_AXIS))
        rs = NamedSharding(self.mesh, P())

        @functools.partial(
            shard_map, mesh=self.mesh, check_vma=False,
            in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                      P(), P()),
            out_specs=P(DATA_AXIS))
        def _dec(stream_r, wb, sh, vb, ts, tl):
            return decode_ops.decode_blocks(
                stream_r, wb, sh, vb, ts, tl, cfg.block_bytes, tb)

        out = jax.jit(_dec)(
            put_global(stream, rs), put_global(word_base, bs),
            put_global(bit_shift, bs), put_global(valid, bs),
            put_global(syms, rs), put_global(lens, rs))
        return fetch(out).reshape(-1)[: enc.n_bytes]
