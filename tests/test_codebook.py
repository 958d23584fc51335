"""Codebook construction tests (reference parity: huffTree.h, load_data.h)."""

import numpy as np
import pytest

from huffman_tpu.codebook import (
    Codebook, byte_histogram_host, canonical_codes, entropy_bits_per_byte,
    huffman_code_lengths, kraft_sum, package_merge_lengths)
from huffman_tpu.utils import testdata


def optimal_cost(freqs, lengths):
    return int((np.asarray(freqs, dtype=np.int64) * lengths).sum())


class TestHuffmanLengths:
    def test_two_symbols(self):
        freqs = np.zeros(256, dtype=np.int64)
        freqs[65], freqs[66] = 10, 1
        lens = huffman_code_lengths(freqs)
        assert lens[65] == 1 and lens[66] == 1
        assert lens.sum() == 2

    def test_single_symbol(self):
        freqs = np.zeros(256, dtype=np.int64)
        freqs[7] = 100
        lens = huffman_code_lengths(freqs)
        assert lens[7] == 1 and lens.sum() == 1

    def test_empty(self):
        assert huffman_code_lengths(np.zeros(256, dtype=np.int64)).sum() == 0

    def test_kraft_equality(self):
        rng = np.random.default_rng(3)
        freqs = np.zeros(256, dtype=np.int64)
        freqs[:64] = rng.integers(1, 10_000, 64)
        lens = huffman_code_lengths(freqs)
        assert abs(kraft_sum(lens) - 1.0) < 1e-12

    def test_matches_entropy_bound(self):
        data = testdata.skewed(100_000, num_symbols=32, seed=5)
        freqs = byte_histogram_host(data)
        lens = huffman_code_lengths(freqs)
        h = entropy_bits_per_byte(freqs)
        avg = optimal_cost(freqs, lens) / len(data)
        assert h <= avg + 1e-9 < h + 1.0  # Huffman within 1 bit of entropy

    def test_dyadic_exact(self):
        # freqs 1,1,2,4 -> lengths 3,3,2,1
        freqs = np.zeros(256, dtype=np.int64)
        freqs[0], freqs[1], freqs[2], freqs[3] = 1, 1, 2, 4
        lens = huffman_code_lengths(freqs)
        assert sorted(lens[lens > 0].tolist()) == [1, 2, 3, 3]


class TestPackageMerge:
    def test_respects_limit(self):
        # Fibonacci-ish frequencies force deep unrestricted Huffman trees.
        freqs = np.zeros(256, dtype=np.int64)
        a, b = 1, 1
        for i in range(30):
            freqs[i] = a
            a, b = b, a + b
        unrestricted = huffman_code_lengths(freqs)
        assert unrestricted.max() > 16
        limited = package_merge_lengths(freqs, 16)
        assert limited.max() <= 16
        assert kraft_sum(limited) <= 1.0 + 1e-12
        assert (limited[freqs > 0] > 0).all()

    def test_matches_huffman_when_unconstrained(self):
        rng = np.random.default_rng(11)
        freqs = np.zeros(256, dtype=np.int64)
        freqs[:40] = rng.integers(1, 1000, 40)
        huff = huffman_code_lengths(freqs)
        pm = package_merge_lengths(freqs, 32)
        assert optimal_cost(freqs, huff) == optimal_cost(freqs, pm)

    def test_limit_cost_monotone(self):
        rng = np.random.default_rng(12)
        freqs = np.zeros(256, dtype=np.int64)
        freqs[:100] = (rng.pareto(0.3, 100) * 100 + 1).astype(np.int64)
        costs = [optimal_cost(freqs, package_merge_lengths(freqs, L))
                 for L in (8, 10, 12, 16, 32)]
        assert costs == sorted(costs, reverse=True)


class TestCanonicalCodes:
    def test_prefix_free(self):
        data = testdata.skewed(50_000, num_symbols=64, seed=9)
        cb = Codebook.from_data(data)
        cb.validate()
        entries = [(f"{cb.codes[s]:0{cb.lengths[s]}b}")
                   for s in range(256) if cb.lengths[s] > 0]
        for i, a in enumerate(entries):
            for j, b in enumerate(entries):
                if i != j:
                    assert not b.startswith(a), (a, b)

    def test_canonical_order(self):
        # Among equal lengths, code values increase with symbol value.
        data = testdata.uniform_random(4096, num_symbols=16, seed=2)
        cb = Codebook.from_data(data)
        by_len = {}
        for s in range(256):
            if cb.lengths[s]:
                by_len.setdefault(int(cb.lengths[s]), []).append(int(cb.codes[s]))
        for L, codes in by_len.items():
            assert codes == sorted(codes)

    def test_roundtrip_from_lengths(self):
        data = testdata.skewed(10_000, seed=4)
        cb = Codebook.from_data(data)
        cb2 = Codebook.from_lengths(cb.lengths)
        np.testing.assert_array_equal(cb.codes, cb2.codes)
        assert cb.max_len == cb2.max_len


class TestDecodeTable:
    def test_table_consistent(self):
        data = testdata.skewed(20_000, num_symbols=48, seed=7)
        cb = Codebook.from_data(data)
        syms, lens = cb.decode_table()
        tb = cb.max_len
        for s in range(256):
            L = int(cb.lengths[s])
            if L == 0:
                continue
            idx = int(cb.codes[s]) << (tb - L)
            assert syms[idx] == s and lens[idx] == L
            # Last index covered by this code too.
            idx2 = idx + (1 << (tb - L)) - 1
            assert syms[idx2] == s and lens[idx2] == L

    def test_full_kraft_table_fully_covered(self):
        freqs = np.zeros(256, dtype=np.int64)
        freqs[:8] = [8, 4, 2, 1, 1, 1, 1, 1]  # not dyadic but full tree
        cb = Codebook.from_frequencies(freqs)
        if abs(kraft_sum(cb.lengths) - 1.0) < 1e-12:
            _, lens = cb.decode_table()
            assert (lens > 0).all()


class TestEntropy:
    def test_fixture_matches_reference_profile(self):
        # Reference fixture: 1 MiB, 32 unique symbols, H=2.206587 (SURVEY C19).
        data = testdata.entropy_fixture(n=1 << 18)
        h = entropy_bits_per_byte(byte_histogram_host(data))
        assert abs(h - 2.206587175259) < 2e-2
        assert len(np.unique(data)) <= 32

    def test_uniform_entropy(self):
        freqs = np.full(256, 1000, dtype=np.int64)
        assert abs(entropy_bits_per_byte(freqs) - 8.0) < 1e-12
