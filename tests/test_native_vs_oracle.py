"""Bit-exactness of the native pipeline vs the reference oracle.

The oracle is the reference library built with ISO FP semantics
(-ffp-contract=off; see tools/oracle/build_oracle.sh) — the only
well-defined build of the reference (gcc's default contract=fast makes
vectorization-dependent FMA choices that differ between any two builds).
"""
import numpy as np
import pytest

from waverange import native as wn

from conftest import smooth_field

SHAPES = [(16, 16, 16), (17, 13, 9), (32, 1, 7), (1, 1, 64), (1, 64, 1),
          (64, 1, 1), (5, 5, 5), (33, 31, 29), (2, 3, 4), (1, 1, 1),
          (60, 50, 40)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lvl", [1, 4])
def test_wavelet_bitexact(oracle, shape, lvl):
    rng = np.random.default_rng(hash((shape, lvl)) % 2**32)
    a = rng.standard_normal(shape)
    ow = oracle.wavelet(a.copy(), lvl)
    mw = wn.wavelet3d(a.copy(), lvl)
    assert np.array_equal(ow.view(np.uint64), mw.view(np.uint64))
    oi = oracle.wavelet(ow.copy(), -lvl)
    mi = wn.wavelet3d(ow.copy(), -lvl)
    assert np.array_equal(oi.view(np.uint64), mi.view(np.uint64))


def test_index_p2w_matches(oracle):
    for (nx, ny, nz) in [(16, 16, 16), (7, 5, 3), (9, 1, 4)]:
        for lvl in (0, 1, 4):
            for (i1, i2, i3) in [(0, 0, 0), (1, 0, 0), (3, 2, 1),
                                 (nx - 1, ny - 1, nz - 1)]:
                assert wn.index_p2w(lvl, nx, ny, nz, i1, i2, i3) == \
                    oracle.p2w(lvl, nx, ny, nz, i1, i2, i3)


CASES = [
    ((16, 16, 16), 1e-16, 1, "smooth"),
    ((16, 16, 16), 1e-16, 1, "const"),
    ((17, 13, 9), 1e-7, 1, "noisy"),
    ((32, 32, 32), 1e-16, 1, "smooth"),
    ((32, 32, 32), 1e-3, 0, "noisy"),
    ((5, 5, 5), 0.5, 1, "rand"),
    ((60, 50, 40), 1e-5, 1, "noisy"),
    ((1, 1, 60000), 1e-5, 1, "smooth"),   # exact block multiple
    ((1, 1, 120000), 1e-4, 1, "noisy"),
]


@pytest.mark.parametrize("shape,tol,wt,kind", CASES)
def test_field_codec_bitexact(oracle, shape, tol, wt, kind):
    rng = np.random.default_rng(99)
    if kind == "smooth":
        a = smooth_field(shape)
    elif kind == "noisy":
        a = smooth_field(shape, rng, noise=0.01)
    elif kind == "const":
        a = np.full(shape, 3.14)
    else:
        a = rng.standard_normal(shape)
    om = oracle.encode(a.copy(), wt, tol)
    mm = wn.encode_field(a.copy(), wtflag=wt, cutoff=np.array([tol]))
    assert om["nlay"] == mm["nlay"]
    assert om["tolabs"] == mm["tolabs"]
    assert om["midval"] == mm["midval"]
    assert om["halfspanval"] == mm["halfspanval"]
    assert np.array_equal(np.asarray(om["deps_vec"]), mm["deps_vec"])
    assert np.array_equal(np.asarray(om["minval_vec"]), mm["minval_vec"])
    assert np.array_equal(np.asarray(om["len_enc_vec"]), mm["len_enc_vec"])
    assert om["data"] == mm["data"]

    od = oracle.decode(om, shape)
    md = wn.decode_field(mm, shape)
    assert np.array_equal(od.view(np.uint64), md.view(np.uint64))
    # error-control property (paper: within ~20% of tol except at
    # round-off-limited tolerances)
    if tol >= 1e-7:
        err = np.abs(md - a).max()
        assert err <= 1.3 * tol * np.abs(a).max() + 1e-300


def test_cross_decodability(oracle):
    """Our decoder decodes oracle streams bit-exactly and vice versa."""
    a = smooth_field((24, 20, 16))
    om = oracle.encode(a.copy(), 1, 1e-9)
    # our decoder on the oracle's stream
    md = wn.decode_field(om, (24, 20, 16))
    od = oracle.decode(om, (24, 20, 16))
    assert np.array_equal(md.view(np.uint64), od.view(np.uint64))


def test_fuzz_shapes_and_tolerances(oracle):
    """Seeded fuzz: random shapes (odd/even/degenerate), tolerances and
    wtflag — every case byte-exact vs the oracle, encode and decode."""
    rng = np.random.default_rng(2026)
    for trial in range(12):
        nx = int(rng.integers(1, 40))
        ny = int(rng.integers(1, 40))
        nz = int(rng.integers(1, 40))
        tol = float(10.0 ** rng.uniform(-10, -2))
        wt = int(rng.integers(0, 2))
        a = smooth_field((nz, ny, nx)) * float(10 ** rng.uniform(-3, 3))
        if rng.random() < 0.5:
            a = a + 0.01 * np.abs(a).max() * rng.standard_normal(a.shape)
        om = oracle.encode(a.copy(), wt, tol)
        mm = wn.encode_field(a.copy(), wtflag=wt, cutoff=np.array([tol]))
        assert om["data"] == mm["data"], (nx, ny, nz, tol, wt)
        assert om["nlay"] == mm["nlay"]
        od = oracle.decode(om, a.shape)
        md = wn.decode_field(mm, a.shape)
        assert np.array_equal(od.view(np.uint64), md.view(np.uint64)), \
            (nx, ny, nz, tol, wt)


@pytest.mark.parametrize("wt", [1, 0])
def test_local_cutoff_bitexact(oracle, wt):
    """Non-uniform (mx,my,mz) cutoff path: exercises ind_p2w_3d +
    lcl_prec per element (wrappers.cpp:343-379). With wtflag=1 the
    level-latch quirk makes it uniform at the min cutoff; with wtflag=0
    the per-block mask genuinely fires (l=0 <= LOC_CUTOFF_LVL)."""
    a = smooth_field((16, 12, 8))
    mx, my, mz = 2, 2, 2
    cutoffs = [1e-4, 1e-6, 1e-5, 1e-3, 1e-6, 1e-4, 1e-5, 1e-6]
    om = oracle.encode_masked(a.copy(), wt, mx, my, mz, cutoffs)
    mm = wn.encode_field(a.copy(), wtflag=wt,
                         cutoff=np.array(cutoffs), mx=mx, my=my, mz=mz)
    assert om["nlay"] == mm["nlay"]
    assert om["tolabs"] == mm["tolabs"]
    assert np.array_equal(np.asarray(om["deps_vec"]), mm["deps_vec"])
    assert om["data"] == mm["data"]
    od = oracle.decode(om, a.shape)
    md = wn.decode_field(mm, a.shape)
    assert np.array_equal(od.view(np.uint64), md.view(np.uint64))
