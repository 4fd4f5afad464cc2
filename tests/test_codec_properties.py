"""Error-control regression: the paper's core quality claim (measured
L-inf error within ~20-30% of the requested tolerance except at
round-off-limited tolerances; doc/cfdproc2017.pdf p.2 Fig.3)."""
import numpy as np
import pytest

from waverange.core import codec
from conftest import smooth_field


@pytest.mark.parametrize("tol", [1e-2, 1e-4, 1e-6, 1e-8, 1e-10, 1e-12])
def test_error_control_sweep(tol):
    a = smooth_field((40, 36, 32))
    a = a + 0.02 * np.abs(a).max() * \
        np.random.default_rng(7).standard_normal(a.shape)
    e = codec.encode_field(a, tol, backend="native")
    r = codec.decode_field(e, backend="native")
    err = np.abs(r - a).max()
    assert err <= 1.3 * tol * np.abs(a).max()


@pytest.mark.parametrize("tol", [1e-2, 1e-4, 1e-6, 1e-8, 1e-10, 1e-12])
@pytest.mark.parametrize("entropy", ["host", "device"])
def test_error_control_sweep_jax_backend(tol, entropy):
    """Device-path mirror of the sweep (VERDICT r1 item 4): the jax
    backend must satisfy the same error contract at every tolerance.
    On the CPU backend x64 is true IEEE f64, so this pins the XLA
    pipeline's contract exactly; chip_smoke.py measures the GPU's
    envelope (codec.DEVICE_F64_REL_FLOOR, PERF.md)."""
    a = smooth_field((40, 36, 32))
    a = a + 0.02 * np.abs(a).max() * \
        np.random.default_rng(7).standard_normal(a.shape)
    coder = "rans" if entropy == "device" else "range"
    e = codec.encode_field(a, tol, backend="jax", coder=coder,
                           entropy=entropy)
    r = codec.decode_field(e, backend="jax", entropy=entropy)
    err = np.abs(r - a).max()
    assert err <= 1.3 * tol * np.abs(a).max()


def test_monotone_size_vs_tolerance():
    a = smooth_field((32, 32, 32))
    sizes = [codec.encode_field(a, t, backend="native").ntot_enc
             for t in (1e-2, 1e-5, 1e-8, 1e-11, 1e-14)]
    assert sizes == sorted(sizes), sizes


def test_f32_native_pipeline():
    # opt-in f32 host pipeline: tolerance-exact at f32 resolution, stream
    # decodable by the f64 decoder (format-identical, f64 metadata)
    from waverange import native as wn
    from waverange.core import codec
    rng = np.random.default_rng(9)
    a = (np.cumsum(rng.standard_normal((32, 40, 48)), axis=2) / 4
         ).astype(np.float32)
    tol = 1e-5
    enc = codec.encode_field(a, tol, precision="native")
    rec64 = codec.decode_field(enc)
    lim = 1.5 * 1.3 * tol * float(np.abs(a).max())
    assert np.abs(rec64 - a).max() <= lim
    # direct f32 decode matches too
    meta = dict(tolabs=enc.tolabs, midval=enc.midval,
                halfspanval=enc.halfspanval, wlev=enc.wlev, nlay=enc.nlay,
                ntot_enc=enc.ntot_enc, deps_vec=enc.deps_vec,
                minval_vec=enc.minval_vec, len_enc_vec=enc.len_enc_vec,
                data=enc.data)
    rec32 = wn.decode_field_f32(meta, a.shape)
    assert np.abs(rec32 - a).max() <= lim


def test_f32_native_with_turbo():
    from waverange import native as wn
    rng = np.random.default_rng(10)
    a = (np.cumsum(rng.standard_normal((24, 24, 24)), axis=1) / 4
         ).astype(np.float32)
    tol = 1e-4
    m = wn.encode_field_f32(a, tol, coder=1)
    r = wn.decode_field_f32(m, a.shape, coder=1)
    assert np.abs(r - a).max() <= 1.5 * 1.3 * tol * float(np.abs(a).max())


@pytest.mark.parametrize("wt", [1, 0])
def test_f32_local_cutoff_parity(wt):
    """f32 + local cutoff (mtot > 1): templated masked quantizer parity
    with the f64 masked path at f32-scale tolerances (VERDICT r4 item 7;
    reference contract wrappers.cpp:339-379 / lcl_prec). With wtflag=0
    the per-block mask genuinely fires; with wtflag=1 the ind_p2w_3d
    level-latch quirk makes it uniform at the min cutoff."""
    from waverange import native as wn
    a64 = smooth_field((16, 12, 8))
    a32 = a64.astype(np.float32)
    mx, my, mz = 2, 2, 2
    cutoffs = np.array([1e-3, 1e-4, 2e-4, 1e-3, 5e-4, 1e-3, 1e-4, 2e-4])
    tol = float(cutoffs.min())
    m32 = wn.encode_field_f32(a32, tol, wtflag=wt, cutoff=cutoffs,
                              mx=mx, my=my, mz=mz)
    m64 = wn.encode_field(a64.copy(), wtflag=wt, cutoff=cutoffs,
                          mx=mx, my=my, mz=mz)
    # same layer schedule and uniform-min tolabs derivation
    assert m32["nlay"] == m64["nlay"]
    assert abs(m32["tolabs"] - m64["tolabs"]) <= 1e-6 * m64["tolabs"]
    r32 = wn.decode_field_f32(m32, a32.shape)
    r64 = wn.decode_field(m64, a64.shape)
    # f32 reconstruction tracks the f64 masked reconstruction to within
    # one quantization step (f32 rounding can flip a symbol across a
    # boundary, moving the reconstruction by <= deps ~ tolabs), and both
    # honor the (min-cutoff) error contract
    maxabs = float(np.abs(a64).max())
    assert np.abs(r32.astype(np.float64) - r64).max() <= \
        1.3 * tol * maxabs
    assert np.abs(r32 - a32).max() <= 1.5 * 1.3 * tol * maxabs
    # coarse-tolerance blocks must not be *better* encoded than the
    # fine ones ask: streams decode through the standard f64 decoder too
    r_via64 = wn.decode_field(m32, a32.shape)
    assert np.abs(r_via64 - r32.astype(np.float64)).max() <= 1e-6 * maxabs
