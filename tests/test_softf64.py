"""Software-IEEE-f64 (ops/softf64) correctness: differential vs numpy,
then the lifting/codec built on it vs the native bit-exact pipeline.

The WHOLE point of this arithmetic is device bit-exactness whatever the
device's own f64 does; on the CPU backend numpy IS IEEE f64, so these
tests pin exact equality. The integer ops used are exact on every
backend, so the same results hold on a GPU (re-asserted there by
chip_smoke.py).
"""
import numpy as np
import pytest

from waverange.ops import softf64 as sf

from conftest import smooth_field

rng = np.random.default_rng(0)
np.seterr(all="ignore")


def rand_f64(n):
    bits = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    x = bits.view(np.float64)
    return np.where(np.isfinite(x), x, rng.standard_normal(n))


def _check(op, npop, a, b):
    got = sf.unpack(*op(*sf.pack(a), *sf.pack(b)))
    want = npop(a, b)
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64)), \
        np.nonzero(got.view(np.uint64) != want.view(np.uint64))[0][:5]


N = 100000


def test_add_random_full_range():
    _check(sf.add, np.add, rand_f64(N), rand_f64(N))


def test_add_cancellation():
    e = rng.integers(-300, 300, N)
    a = rng.standard_normal(N) * (2.0 ** e)
    b = -a * (1 + rng.choice([-1, 1], N) * 2.0 ** -rng.integers(1, 54, N))
    _check(sf.add, np.add, a, b)


@pytest.mark.parametrize("d", [0, 1, 2, 11, 52, 53, 54, 55, 63])
def test_add_exponent_gap(d):
    a = rand_f64(N // 10)
    b = a * (2.0 ** -d) * rng.choice([-1, 1], N // 10)
    _check(sf.add, np.add, a, b)


def test_add_zeros_signs():
    vals = np.array([0.0, -0.0, 1.0, -1.0, 5e-324, -5e-324, np.inf,
                     -np.inf])
    a, b = np.meshgrid(vals, vals)
    got = sf.unpack(*sf.add(*sf.pack(a.ravel()), *sf.pack(b.ravel())))
    want = a.ravel() + b.ravel()
    ok = (got.view(np.uint64) == want.view(np.uint64)) | \
        (np.isnan(got) & np.isnan(want))
    assert ok.all()


def test_mul_random_full_range():
    _check(sf.mul, np.multiply, rand_f64(N), rand_f64(N))


def test_mul_subnormals_and_limits():
    s = (rng.integers(0, 1 << 52, N, dtype=np.uint64)
         | (rng.integers(0, 2, N, dtype=np.uint64) << 63)).view(np.float64)
    _check(sf.mul, np.multiply, s, rand_f64(N))
    e = rng.integers(-300, 300, N)
    a = rng.standard_normal(N) * (2.0 ** e)
    _check(sf.mul, np.multiply, a * 2.0 ** -1000, a * 2.0 ** -80)  # under
    _check(sf.mul, np.multiply, a * 2.0 ** 700, a * 2.0 ** 700)    # over


def test_mul_rounding_ties():
    # sparse mantissas make exact half-way products likely
    t1 = ((np.uint64(1023) << 52)
          | rng.integers(0, 1 << 52, N, dtype=np.uint64)).view(np.float64)
    t2 = ((np.uint64(1023) << 52)
          | (rng.integers(0, 1 << 26, N, dtype=np.uint64) << 26)
          ).view(np.float64)
    _check(sf.mul, np.multiply, t1, t2)


def test_minmax_and_conversions():
    a, b = rand_f64(N), rand_f64(N)
    mn = sf.unpack(*sf.minimum(*sf.pack(a), *sf.pack(b)))
    mx = sf.unpack(*sf.maximum(*sf.pack(a), *sf.pack(b)))
    assert np.array_equal(mn, np.minimum(a, b))
    assert np.array_equal(mx, np.maximum(a, b))
    h, l = sf.pack(a)
    assert sf.unpack(*sf.reduce_min(h, l)) == a.min()
    assert sf.unpack(*sf.reduce_max(h, l)) == a.max()
    q = rng.integers(0, 256, N).astype(np.uint8)
    import jax.numpy as jnp
    back = sf.unpack(*sf.from_u8(jnp.asarray(q)))
    assert np.array_equal(back, q.astype(np.float64))
    x = rng.random(N) * 255.9999
    got = np.asarray(sf.to_u8_trunc(*sf.pack(x)))
    assert np.array_equal(got, x.astype(np.uint8))


def _roundtrip_wavelet(shape):
    """Forward+inverse soft wavelet vs the native bit-exact pipeline.

    NOT wrapped in an outer jit: cdf97_forward_s jits one small graph per
    canonical (lines, n) sweep internally; an outer jit would inline them
    into one monolithic graph that takes XLA minutes to compile (the
    round-2 verdict's test-budget blowup)."""
    from waverange import native as wn
    from waverange.ops import wavelet_soft64 as ws
    a = rng.standard_normal(shape) * 10
    h, l = sf.pack(a)
    oh, ol = ws.cdf97_forward_s((h, l), 4)
    got = sf.unpack(np.asarray(oh), np.asarray(ol)).reshape(a.shape)
    want = wn.wavelet3d(a.copy(), 4)
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    ih, il = ws.cdf97_inverse_s((oh, ol), 4)
    inv = sf.unpack(np.asarray(ih), np.asarray(il)).reshape(a.shape)
    winv = wn.wavelet3d(want.copy(), -4)
    assert np.array_equal(inv.view(np.uint64), winv.view(np.uint64))


def test_soft_wavelet_bitexact_vs_native():
    # cube: all three axis sweeps of a level share one compiled graph,
    # and extents cover odd lengths (10 -> 5 -> 3 -> 2)
    _roundtrip_wavelet((10, 10, 10))


@pytest.mark.slow
def test_soft_wavelet_bitexact_noncube():
    # distinct per-axis extents compile ~3x the graphs; slow-marked
    _roundtrip_wavelet((12, 10, 8))


@pytest.mark.parametrize("tol", [1e-4, 1e-16])
def test_exact64_codec_bitexact_vs_native(tol):
    """The full softf64 encode/decode == the native C++ pipeline, bit for
    bit: metadata, quantized planes (via the stream bytes), and the
    reconstructed field."""
    from waverange import native as wn
    from waverange.core import exact64
    # cube shape shares the wavelet graphs compiled by the test above
    a = smooth_field((10, 10, 10))
    ref = wn.encode_field(a, wtflag=1, cutoff=np.array([tol]), coder=1)
    got = exact64.encode_field_exact64(a, tol, entropy="host")
    assert got["nlay"] == ref["nlay"]
    assert got["tolabs"] == ref["tolabs"]
    assert np.array_equal(got["deps_vec"], ref["deps_vec"])
    assert np.array_equal(got["minval_vec"], ref["minval_vec"])
    assert got["data"] == ref["data"]
    dref = wn.decode_field(ref, a.shape, coder=1)
    dgot = exact64.decode_field_exact64(got, a.shape, entropy="host")
    assert np.array_equal(dgot.view(np.uint64), dref.view(np.uint64))


def test_exact64_trivial_field():
    from waverange.core import exact64
    c = np.full((6, 5, 4), 7.5)
    m = exact64.encode_field_exact64(c, 1e-6)
    assert m["ntot_enc"] == 0
    assert np.array_equal(exact64.decode_field_exact64(m, c.shape), c)
