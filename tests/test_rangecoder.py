"""Range coder + layer framing: self-consistency and stream-layout contract.

Contract reference: /root/reference/src/rangecod/rangecod.c (rngcod13
semantics) and src/core/wrappers.cpp:68-224 (block framing). Verified facts
from the survey appendix: leading 0x00 byte, 5-byte tail with 24-bit byte
count, empty trailing block at exact multiples of 60000 symbols.
"""
import numpy as np
import pytest

from waverange import native as wn


@pytest.mark.parametrize("n", [1, 2, 5, 255, 1000, 59999, 60000, 60001,
                               119999, 120000, 123457])
def test_plane_roundtrip_random(n):
    rng = np.random.default_rng(n)
    syms = rng.integers(0, 256, n).astype(np.uint8)
    enc = wn.encode_plane(syms)
    dec = wn.decode_plane(enc, n)
    assert np.array_equal(syms, dec)


@pytest.mark.parametrize("p", [0.0, 0.001, 0.5])
def test_plane_roundtrip_skewed(p):
    rng = np.random.default_rng(7)
    n = 70000
    syms = (rng.random(n) < p).astype(np.uint8) * 255
    enc = wn.encode_plane(syms)
    assert np.array_equal(wn.decode_plane(enc, n), syms)


def test_stream_starts_with_zero_byte():
    syms = np.arange(100, dtype=np.uint8)
    enc = wn.encode_plane(syms)
    assert enc[0] == 0


def test_tail_contains_bytecount():
    # Last 3 bytes are the low 24 bits of the total byte count.
    syms = np.zeros(1000, dtype=np.uint8)
    enc = wn.encode_plane(syms)
    count = int.from_bytes(enc[-3:], "big")
    assert count == len(enc)


def test_empty_trailing_block_at_multiple():
    # A stream of exactly k*60000 symbols must embed an empty final block:
    # its encoded length exceeds the (k*60000 - 1)-symbol stream by roughly
    # the 256 zero counts (~512 bytes of model data).
    rng = np.random.default_rng(3)
    base = rng.integers(0, 2, 60001).astype(np.uint8)
    l_599 = len(wn.encode_plane(base[:59999]))
    l_600 = len(wn.encode_plane(base[:60000]))
    l_601 = len(wn.encode_plane(base[:60001]))
    assert l_600 - l_599 > 400          # empty block present
    assert abs(l_601 - l_600) < 50      # one extra symbol ≈ no growth
    for n in (59999, 60000, 60001):
        assert np.array_equal(wn.decode_plane(wn.encode_plane(base[:n]), n),
                              base[:n])


def test_batch_matches_single():
    rng = np.random.default_rng(11)
    planes = rng.integers(0, 256, (5, 10000)).astype(np.uint8)
    planes[2] = 0  # constant plane
    payload, lens = wn.encode_planes_batch(planes, nthreads=4)
    off = 0
    for i in range(5):
        single = wn.encode_plane(planes[i])
        assert payload[off:off + int(lens[i])] == single
        off += int(lens[i])
    dec = wn.decode_planes_batch(payload, lens, 10000, nthreads=4)
    assert np.array_equal(dec, planes)


@pytest.mark.parametrize("width", ["1", "2", "4"])
@pytest.mark.parametrize("nplanes", [1, 2, 3, 4, 5, 8])
def test_interleaved_widths_bit_identical(monkeypatch, width, nplanes):
    # Lockstep multi-stream coding must emit byte-identical streams at
    # every interleave width and plane-group remainder (1..4 per group).
    monkeypatch.setenv("WR_IL_STREAMS", width)
    rng = np.random.default_rng(int(width) * 100 + nplanes)
    n = 10007
    planes = rng.integers(0, 256, (nplanes, n)).astype(np.uint8)
    payload, lens = wn.encode_planes_batch(planes, nthreads=1)
    off = 0
    for i in range(nplanes):
        monkeypatch.setenv("WR_IL_STREAMS", "1")
        solo = wn.encode_plane(planes[i])
        monkeypatch.setenv("WR_IL_STREAMS", width)
        assert payload[off:off + int(lens[i])] == solo, (width, nplanes, i)
        off += int(lens[i])
    dec = wn.decode_planes_batch(payload, lens, n, nthreads=1)
    assert np.array_equal(dec, planes)


@pytest.mark.parametrize("n", [59999, 60000, 60001, 120000])
def test_interleaved_block_boundaries(monkeypatch, n):
    # The empty-trailing-block rule (n % 60000 == 0) must survive
    # lockstep coding: every stream in a group carries the empty block.
    monkeypatch.setenv("WR_IL_STREAMS", "4")
    rng = np.random.default_rng(n)
    planes = rng.integers(0, 4, (4, n)).astype(np.uint8)
    payload, lens = wn.encode_planes_batch(planes, nthreads=1)
    off = 0
    for i in range(4):
        monkeypatch.setenv("WR_IL_STREAMS", "1")
        solo = wn.encode_plane(planes[i])
        assert payload[off:off + int(lens[i])] == solo
        off += int(lens[i])
    monkeypatch.setenv("WR_IL_STREAMS", "4")
    dec = wn.decode_planes_batch(payload, lens, n, nthreads=1)
    assert np.array_equal(dec, planes)
