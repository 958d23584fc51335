"""Canonical Huffman codebook construction (host side).

Replaces the reference's greedy pointer-tree builder + recursive DFS code
assignment (reference: huffTree.h:55-94) and the flattening of the code map
into two 256-entry uint32 LUTs (reference: load_data.h:40-47).

Differences, by design (SURVEY.md section 7, capability 2):
  * Codes are *canonical*: fully determined by the code lengths and the
    symbol ordering, which makes the codebook serializable as 256 bytes of
    lengths and enables a table-driven decoder.  The reference's codes
    depend on STL heap tie-breaking (huffTree.h:51-75) and are neither
    canonical nor decodable without shipping the whole tree.
  * Code lengths are capped at config.max_code_len via the package-merge
    (length-limited Huffman) algorithm.  The reference has no explicit cap
    and relies on data staying friendly (cpuencode.cpp:10).

Everything here is O(NUM_SYMBOLS log NUM_SYMBOLS) host work on at most 256
symbols — deliberately plain NumPy/Python, exactly like the reference keeps
tree construction on the host (SURVEY.md section 3.1).
"""

from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np

from .config import NUM_SYMBOLS


def byte_histogram_host(data: bytes | np.ndarray) -> np.ndarray:
    """256-bin byte histogram on the host (oracle twin of ops.histogram)."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    return np.bincount(arr, minlength=NUM_SYMBOLS).astype(np.int64)


def entropy_bits_per_byte(freqs: np.ndarray) -> float:
    """Shannon entropy of the source, in bits/byte.

    Parity with the reference's entropy report (load_data.h:49-56), which
    prints H = -sum p log2 p over nonzero symbol probabilities.
    """
    freqs = np.asarray(freqs, dtype=np.float64)
    total = freqs.sum()
    if total == 0:
        return 0.0
    p = freqs[freqs > 0] / total
    return float(-(p * np.log2(p)).sum())


def huffman_code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Unrestricted Huffman code lengths from symbol frequencies.

    Same greedy two-minimum merge as the reference tree build
    (huffTree.h:55-76), but producing lengths directly (no pointer tree):
    we only ever need depths, since codes are assigned canonically.
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    syms = np.flatnonzero(freqs)
    lengths = np.zeros(NUM_SYMBOLS, dtype=np.int32)
    if len(syms) == 0:
        return lengths
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths
    # Heap of (freq, tiebreak, node). Leaf nodes are ints; internal nodes are
    # lists of leaf symbols (fine at 256 symbols). Deterministic tiebreak.
    heap = [(int(freqs[s]), int(s), [int(s)]) for s in syms]
    heapq.heapify(heap)
    tb = NUM_SYMBOLS
    while len(heap) > 1:
        fa, _, a = heapq.heappop(heap)
        fb, _, b = heapq.heappop(heap)
        for s in a:
            lengths[s] += 1
        for s in b:
            lengths[s] += 1
        heapq.heappush(heap, (fa + fb, tb, a + b))
        tb += 1
    return lengths


def package_merge_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Length-limited Huffman code lengths via package-merge.

    Optimal code lengths subject to length <= max_len (Larmore & Hirschberg
    1990).  Used when the unrestricted lengths exceed the cap; guarantees the
    decoder's single-level 2**max_len lookup table always suffices.
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    syms = np.flatnonzero(freqs)
    n = len(syms)
    lengths = np.zeros(NUM_SYMBOLS, dtype=np.int32)
    if n == 0:
        return lengths
    if n == 1:
        lengths[syms[0]] = 1
        return lengths
    if n > (1 << max_len):
        raise ValueError(f"cannot code {n} symbols with max length {max_len}")
    # Items are (weight, symbol_multiset). Coins for each level 1..max_len.
    orig = sorted((int(freqs[s]), (int(s),)) for s in syms)
    pkg = list(orig)
    for _ in range(max_len - 1):
        paired = [
            (pkg[i][0] + pkg[i + 1][0], pkg[i][1] + pkg[i + 1][1])
            for i in range(0, len(pkg) - 1, 2)
        ]
        pkg = sorted(orig + paired)
    for _, symset in pkg[: 2 * n - 2]:
        for s in symset:
            lengths[s] += 1
    return lengths


def kraft_sum(lengths: np.ndarray) -> float:
    l = np.asarray(lengths)
    nz = l[l > 0].astype(np.float64)
    return float(np.sum(2.0 ** (-nz)))


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical code values from lengths.

    Symbols sorted by (length, symbol value); codes count up, left-shifted
    when the length grows.  Codes are returned right-aligned (the value
    occupies the low `length` bits), matching how the reference stores
    codeword values for its encoder input (load_data.h:40-47).
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    codes = np.zeros(NUM_SYMBOLS, dtype=np.uint32)
    order = np.lexsort((np.arange(NUM_SYMBOLS), lengths))
    code = 0
    prev_len = 0
    for s in order:
        L = int(lengths[s])
        if L == 0:
            continue
        if prev_len:
            code <<= L - prev_len
        codes[s] = code
        code += 1
        prev_len = L
    return codes


@dataclasses.dataclass(frozen=True)
class Codebook:
    """A canonical Huffman codebook over the byte alphabet.

    `codes[s]` is the right-aligned codeword value for byte s, `lengths[s]`
    its bit length (0 = symbol absent from the source).  This is the exact
    analogue of the reference's (codewords[256], codewordlens[256]) LUT pair
    (load_data.h:40-47), plus everything needed for decoding.
    """

    codes: np.ndarray      # (256,) uint32, right-aligned values
    lengths: np.ndarray    # (256,) int32
    max_len: int

    @staticmethod
    def from_frequencies(freqs: np.ndarray, max_code_len: int = 16) -> "Codebook":
        lengths = huffman_code_lengths(freqs)
        if lengths.max(initial=0) > max_code_len:
            lengths = package_merge_lengths(freqs, max_code_len)
        return Codebook.from_lengths(lengths)

    @staticmethod
    def from_lengths(lengths: np.ndarray) -> "Codebook":
        """Rebuild from serialized lengths (container deserialization)."""
        lengths = np.asarray(lengths, dtype=np.int32)
        return Codebook(codes=canonical_codes(lengths), lengths=lengths,
                        max_len=int(lengths.max(initial=0)))

    @staticmethod
    def from_data(data: bytes | np.ndarray, max_code_len: int = 16) -> "Codebook":
        return Codebook.from_frequencies(byte_histogram_host(data), max_code_len)

    def validate(self) -> None:
        ks = kraft_sum(self.lengths)
        if ks > 1.0 + 1e-12:
            raise ValueError(f"invalid codebook: Kraft sum {ks} > 1")

    def expected_bits_per_byte(self, freqs: np.ndarray) -> float:
        freqs = np.asarray(freqs, dtype=np.float64)
        total = freqs.sum()
        if total == 0:
            return 0.0
        return float((freqs * self.lengths).sum() / total)

    def decode_table(self, table_bits: int | None = None):
        """Single-level decode table: peek `table_bits` bits -> (symbol, len).

        Entry i covers every bitstream whose next `table_bits` bits equal i;
        since codes are prefix-free and <= table_bits long, the code is a
        prefix of i's binary expansion.  Returns (syms[2**tb] uint8,
        lens[2**tb] uint8) as NumPy arrays.
        """
        tb = int(table_bits) if table_bits is not None else max(self.max_len, 1)
        if tb < self.max_len:
            raise ValueError("table_bits smaller than max code length")
        size = 1 << tb
        syms = np.zeros(size, dtype=np.uint8)
        lens = np.zeros(size, dtype=np.uint8)
        for s in range(NUM_SYMBOLS):
            L = int(self.lengths[s])
            if L == 0:
                continue
            base = int(self.codes[s]) << (tb - L)
            span = 1 << (tb - L)
            syms[base: base + span] = s
            lens[base: base + span] = L
        return syms, lens
