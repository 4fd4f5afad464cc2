"""Device-side rANS (format v2) vs the C++ turbo coder: bit-identity A/B.

The C++ coder (native/src/wr_native.cc, turbo::encode_plane_t /
decode_plane_t) is the format oracle. These tests run the JAX
implementation on the CPU backend (conftest pins jax_platforms=cpu);
the arithmetic is exact integer u32 on every device, and chip_smoke.py
re-asserts identity on the GPU.
"""
import numpy as np
import pytest

from waverange import native as wn
from waverange.ops import rans


def _ab(syms: np.ndarray):
    """Assert byte-identity and cross-decodability in both directions."""
    n = syms.size
    ref = wn.encode_plane(syms, coder=1)
    dev = rans.encode_planes([syms])[0]
    assert dev == ref
    assert np.array_equal(rans.decode_planes([ref], [n])[0], syms)
    assert np.array_equal(wn.decode_plane(dev, n, coder=1), syms)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 63, 65, 65535, 65536, 65537,
                               131072, 200001])
def test_sizes_bitexact(n):
    rng = np.random.default_rng(n)
    _ab(np.clip(rng.normal(100, 9, n), 0, 255).astype(np.uint8))


@pytest.mark.parametrize("name", ["constant", "two_skew", "uniform",
                                  "steal", "ramp", "mixed_const_block"])
def test_distributions_bitexact(name):
    rng = np.random.default_rng(hash(name) % 2**31)
    n = 196608
    if name == "constant":
        syms = np.full(n, 42, np.uint8)
    elif name == "two_skew":
        syms = np.where(rng.random(n) < 1e-4, 7, 200).astype(np.uint8)
    elif name == "uniform":
        syms = rng.integers(0, 256, n).astype(np.uint8)
    elif name == "steal":
        # ~220 rare symbols force normalize_freqs' 0->1 clamps and the
        # iterative steal loop (wr_native.cc normalize_freqs).
        syms = np.zeros(n, np.uint8)
        syms[:220] = np.arange(1, 221) % 256
        rng.shuffle(syms)
    elif name == "ramp":
        syms = (np.arange(n) % 251).astype(np.uint8)
    else:  # a single-symbol block sandwiched between normal blocks
        syms = np.clip(rng.normal(100, 9, n), 0, 255).astype(np.uint8)
        syms[65536:131072] = 9
    _ab(syms)


def test_multi_plane_batch():
    """Several planes (incl. empty) encoded/decoded in one device batch."""
    rng = np.random.default_rng(3)
    planes = [
        np.clip(rng.normal(128, 60, 196608), 0, 255).astype(np.uint8),
        rng.integers(0, 4, 70001).astype(np.uint8),
        np.zeros(0, np.uint8),
        np.full(65536, 7, np.uint8),
    ]
    refs = [wn.encode_plane(p, coder=1) for p in planes]
    devs = rans.encode_planes(planes)
    assert all(d == r for d, r in zip(devs, refs))
    decs = rans.decode_planes(refs, [p.size for p in planes])
    assert all(np.array_equal(d, p) for d, p in zip(decs, planes))


def test_quantized_field_planes_bitexact():
    """End-to-end: the real byte layers of a turbo-encoded field.

    Encode a field with the C++ turbo path (coder=1), split the payload
    into per-layer streams, decode each with the device coder, and
    re-encode on device — every layer stream must round back byte-exact.
    """
    from tests.conftest import smooth_field
    a = smooth_field((48, 40, 56))
    meta = wn.encode_field(a, wtflag=1, cutoff=np.array([1e-12]), coder=1)
    assert meta["nlay"] >= 2
    n = a.size
    offs = np.concatenate(
        [[0], np.cumsum(meta["len_enc_vec"][:meta["nlay"]])]).astype(int)
    layers = [meta["data"][offs[i]:offs[i + 1]]
              for i in range(meta["nlay"])]
    planes = rans.decode_planes(layers, [n] * meta["nlay"])
    assert rans.encode_planes(planes) == layers


def test_device_resident_planes_roundtrip():
    """encode_planes_device / decode_planes_device vs the host-staged
    paths: identical streams from device-resident planes, identical
    symbols back, for n both multiple and non-multiple of TBLOCK."""
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    for n in (65536 * 2, 107520, 4096, 1):
        planes = np.clip(rng.normal(100, 25, (3, n)), 0, 255).astype(np.uint8)
        planes[1] = 7  # a single-symbol plane in the middle
        host = rans.encode_planes(list(planes))
        dev = rans.encode_planes_device(jnp.asarray(planes), n)
        assert dev == host
        syms = np.asarray(rans.decode_planes_device(host, n))
        assert np.array_equal(syms, planes)


def test_full_device_codec_matches_host_entropy():
    """backend='jax' entropy='device' vs entropy='host': byte-identical
    streams (same planes feed both coders) and bit-identical decode."""
    from tests.conftest import smooth_field
    from waverange.core import codec
    a = smooth_field((48, 40, 56))
    kw = dict(tolrel=1e-10, backend="jax", coder="rans")
    eh = codec.encode_field(a, **kw)
    ed = codec.encode_field(a, entropy="device", **kw)
    assert ed.data == eh.data
    assert np.array_equal(ed.len_enc_vec, eh.len_enc_vec)
    assert (ed.tolabs, ed.midval, ed.nlay) == (eh.tolabs, eh.midval, eh.nlay)
    dh = codec.decode_field(eh, backend="jax")
    dd = codec.decode_field(eh, backend="jax", entropy="device")
    assert np.array_equal(dh, dd)
    assert np.abs(dd - a).max() <= 1.3 * 1e-10 * np.abs(a).max()
    # cross-decodability: the device-encoded stream through the C++ turbo
    # decoder (native inverse wavelet differs from XLA's in low bits, so
    # assert the error contract rather than bit-identity with dh)
    dn = codec.decode_field(ed, backend="native")
    assert np.abs(dn - a).max() <= 1.3 * 1e-10 * np.abs(a).max()


def test_full_device_codec_trivial_and_single_layer():
    from waverange.core import codec
    const = np.full((8, 8, 8), 3.25)
    e = codec.encode_field(const, tolrel=1e-3, backend="jax", coder="rans",
                           entropy="device")
    assert e.ntot_enc == 0
    assert np.array_equal(
        codec.decode_field(e, backend="jax", entropy="device"), const)
    rng = np.random.default_rng(5)
    a = rng.standard_normal((16, 16, 16))
    e1 = codec.encode_field(a, tolrel=0.5, backend="jax", coder="rans",
                            entropy="device")
    assert e1.nlay == 1
    d1 = codec.decode_field(e1, backend="jax", entropy="device")
    assert np.abs(d1 - a).max() <= 0.5 * np.abs(a).max()


def test_exact_divmod_exhaustive_edges():
    """The division-free floor(x/f) against numpy over adversarial pairs."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    f = rng.integers(1, 16384, 4096).astype(np.uint32)
    # x just below/above multiples of f, near the renorm bound f<<18,
    # and near u32 wrap candidates.
    k = rng.integers(0, 1 << 18, 4096).astype(np.uint64)
    base = (k * f.astype(np.uint64))
    xs = []
    for d in (0, 1, 2**16 - 1, 2**16, 2**16 + 1):
        xs.append(((base + d) & 0xFFFFFFFF).astype(np.uint32))
    x = np.concatenate(xs)
    fr = np.tile(f, 5)
    # keep the precondition q < 2^18
    m = (x.astype(np.uint64) // fr) < (1 << 18)
    x, fr = x[m], fr[m]
    q, r = rans._exact_divmod(jnp.asarray(x), jnp.asarray(fr), 9)
    assert np.array_equal(np.asarray(q), x // fr)
    assert np.array_equal(np.asarray(r), x % fr)


def test_corrupt_stream_fuzz_never_crashes():
    """Corrupt v2 containers through the device decode path (VERDICT r4
    item 8): truncations and bit flips must either decode to garbage
    (structurally valid — matching the reference range decoder's
    no-integrity contract, rangecod.c:282-290) or raise a clean
    ValueError from the framing parser — never an IndexError/numpy
    shape error from deep inside the pipeline, and never a crash."""
    rng = np.random.default_rng(2026)
    syms = np.clip(rng.normal(96, 40, 70000), 0, 255).astype(np.uint8)
    n = syms.size
    good = rans.encode_planes([syms])[0]
    assert np.array_equal(np.asarray(
        rans.decode_planes_device([good], n))[0], syms)

    def try_decode(s):
        try:
            out = rans.decode_planes_device([s], n)
            assert np.asarray(out).shape == (1, n)
        except ValueError as e:
            assert "corrupt v2 stream" in str(e)

    # truncations at every region boundary + random cuts
    cuts = [0, 1, 2, 100, 516, 517, len(good) - 1]
    cuts += [int(rng.integers(0, len(good))) for _ in range(40)]
    for c in cuts:
        try_decode(good[:c])
    # oversized payload length field + unknown tags
    for _ in range(60):
        b = bytearray(good)
        i = int(rng.integers(0, len(b)))
        b[i] = int(rng.integers(0, 256))
        try_decode(bytes(b))
    # zero-length and garbage-only streams
    try_decode(b"")
    try_decode(bytes(rng.integers(0, 256, 2000, dtype=np.uint8)))


@pytest.mark.parametrize("k", [225, 235, 240])
def test_near_raw_blocks_scan(k):
    """Near-raw modeled blocks: a uniform alphabet of ~225-245 symbols
    nearly fills the raw-escape budget while still being modeled; the
    XLA scan encodes them as the C++ coder does and decodes them
    symbol-exact."""
    rng = np.random.default_rng(k)
    data = rng.integers(0, k, 2 * 65536).astype(np.uint8)
    s = wn.encode_plane(data, coder=1)
    batch, raws, *_ = rans._parse_to_batch([s], [data.size])
    assert len(batch) >= 1 and not raws, "expected modeled blocks only"
    import jax.numpy as jnp
    assert rans.encode_planes_device(jnp.asarray(data[None]),
                                     data.size) == [s]
    back = np.asarray(rans.decode_planes_device([s], data.size))[0]
    assert np.array_equal(back, data)
