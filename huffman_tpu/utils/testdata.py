"""Synthetic test-data and fixture generators.

Replaces the reference's dormant generators (reference: testdatagen.h:7-67):
RLE-friendly run patterns, a deterministic dummy codebook with lengths
{1,2,3,4,4,5,6,7} repeating, and uniform random symbols — all of which had
bit-rotted off the reference's load path (load_data.h:4 commented out).
Also generates an entropy-targeted fixture equivalent to the reference's
shipped 1 MiB sample `data/test1024_H2.206587175259.in` (32 distinct bytes,
H = 2.2066 bits/byte) without copying it.
"""

from __future__ import annotations

import numpy as np

from ..codebook import Codebook, entropy_bits_per_byte, byte_histogram_host
from ..config import NUM_SYMBOLS


def rle_runs(n: int, run_len: int = 32, num_symbols: int = 16,
             seed: int = 0) -> np.ndarray:
    """Run-length-friendly data: constant runs of random symbols.

    Analogue of generateRLETestData (reference: testdatagen.h:7-33), which
    emits fixed-length runs of cycling symbols; ours randomizes the symbol
    per run but keeps the run structure.
    """
    rng = np.random.default_rng(seed)
    n_runs = -(-n // run_len)
    syms = rng.integers(0, num_symbols, size=n_runs, dtype=np.uint8)
    return np.repeat(syms, run_len)[:n]


def uniform_random(n: int, num_symbols: int = NUM_SYMBOLS,
                   seed: int = 0) -> np.ndarray:
    """Uniform random bytes (reference: testdatagen.h:62-67 generateData)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, num_symbols, size=n, dtype=np.uint8)


def dummy_codebook(num_symbols: int = NUM_SYMBOLS) -> Codebook:
    """Deterministic non-Huffman codebook with lengths cycling 1..7.

    Mirrors generateCodewords (reference: testdatagen.h:42-60) whose lengths
    repeat {1,2,3,4,4,5,6,7}; we canonicalize a cycling-length profile into
    a *valid* prefix code by clamping to the Kraft inequality: lengths are
    assigned round-robin but deepened until the canonical assignment fits.
    """
    # A valid prefix code needs Kraft sum <= 1; build lengths greedily.
    lengths = np.zeros(NUM_SYMBOLS, dtype=np.int32)
    budget = 1.0
    want = [1, 2, 3, 4, 4, 5, 6, 7]
    for i in range(num_symbols):
        L = want[i % len(want)]
        while 2.0 ** -L > budget - (num_symbols - i - 1) * 2.0 ** -24 and L < 24:
            L += 1
        lengths[i] = L
        budget -= 2.0 ** -L
    return Codebook.from_lengths(lengths)


def skewed(n: int, num_symbols: int = 32, decay: float = 0.75,
           seed: int = 0) -> np.ndarray:
    """Geometrically skewed symbol distribution (compressible)."""
    rng = np.random.default_rng(seed)
    p = decay ** np.arange(num_symbols)
    p /= p.sum()
    return rng.choice(num_symbols, size=n, p=p).astype(np.uint8)


def log2_skewed_device(n: int, seed: int = 0, chunk: int = 1 << 28):
    """(n,) uint8 device array: floor(log2(u)) of uniform 30-bit u >= 1.

    Symbol 29-k has probability 2**-(k+1), so H is about 2 bits/byte over
    30 symbols — the regime of the reference's shipped fixture (32
    distinct bytes, H=2.21).  Made on the device from `seed`, chunk by
    chunk, so a GiB-size stream costs no host generation pass.
    """
    import jax
    import jax.numpy as jnp

    size = max(1, min(chunk, n))

    @jax.jit
    def gen(key):
        bits = jax.random.bits(key, (size,), jnp.uint32)
        u = (bits >> 2) | jnp.uint32(1)
        return (31 - jax.lax.clz(u)).astype(jnp.uint8)

    key = jax.random.PRNGKey(seed)
    parts = [gen(jax.random.fold_in(key, i)) for i in range(-(-n // size))]
    return jnp.concatenate(parts)[:n] if len(parts) > 1 else parts[0][:n]


def entropy_fixture(n: int = 1 << 20, target_entropy: float = 2.206587175259,
                    num_symbols: int = 32, seed: int = 1024) -> np.ndarray:
    """Fixture with the same profile as the reference's shipped sample.

    The reference ships data/test1024_H2.206587175259.in: 1 MiB, 32 distinct
    byte values, entropy 2.2066 bits/byte (SURVEY.md C19).  We synthesize an
    equivalent (not a copy): a geometric distribution over `num_symbols`
    bytes whose decay is bisected until the measured entropy matches the
    target to ~1e-3 bits.
    """
    rng = np.random.default_rng(seed)

    def gen(decay: float) -> np.ndarray:
        p = decay ** np.arange(num_symbols)
        p /= p.sum()
        return rng.choice(num_symbols, size=n, p=p).astype(np.uint8)

    lo, hi = 0.05, 0.999
    data = None
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        data = gen(mid)
        h = entropy_bits_per_byte(byte_histogram_host(data))
        if abs(h - target_entropy) < 1e-3:
            break
        if h < target_entropy:
            lo = mid
        else:
            hi = mid
    return data
