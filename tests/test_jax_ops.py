"""JAX device-path ops: wavelet inverse-consistency, quantization layers,
and the full jax-backend codec vs the native conformance path.

The JAX path is the performance path: streams are format-identical and
tolerance-exact. At moderate tolerances the symbol planes (and hence the
bitstreams) coincide with the native path — asserted below on smooth
fields. At round-off-limited tolerances (~1e-16) XLA's FMA contraction
flips occasional quantization boundaries; those cases assert the
tolerance property instead.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from waverange import native as wn
from waverange.core import codec
from waverange.ops import cdf97_3d
from waverange.ops.quant import quantize_layers, accumulate_layers

from conftest import smooth_field

SHAPES = [(16, 16, 16), (17, 13, 9), (32, 1, 7), (1, 1, 64), (5, 5, 5),
          (33, 31, 29)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lvl", [1, 4])
def test_wavelet_roundtrip(shape, lvl):
    rng = np.random.default_rng(1)
    a = rng.standard_normal(shape)
    f = jax.jit(cdf97_3d, static_argnums=1)
    w = f(jnp.asarray(a), lvl)
    r = np.asarray(f(w, -lvl))
    assert np.abs(r - a).max() < 1e-12


@pytest.mark.parametrize("shape", SHAPES)
def test_wavelet_close_to_native(shape):
    # XLA contracts FMAs; agreement is to a few ulps, not bit-exact.
    rng = np.random.default_rng(2)
    a = rng.standard_normal(shape)
    jw = np.asarray(jax.jit(cdf97_3d, static_argnums=1)(jnp.asarray(a), 4))
    nw = wn.wavelet3d(a.copy(), 4)
    scale = np.abs(nw).max()
    assert np.abs(jw - nw).max() < 1e-13 * max(scale, 1.0)


def test_quantize_layers_match_native_planes():
    a = smooth_field((24, 20, 16))
    w = wn.wavelet3d(a.copy(), 4)
    tolrel = 1e-7
    tolabs = tolrel * max(abs(a.min()), abs(a.max())) / 1.75
    planes, deps, minv, nlay = quantize_layers(jnp.asarray(w.ravel()),
                                               jnp.float64(tolabs))
    nlay = int(nlay)
    # native full encode for the same field
    m = wn.encode_field(a.copy(), wtflag=1, cutoff=np.array([tolrel]))
    assert nlay == m["nlay"]
    # deps/minv agree to ulp noise (XLA contracts the residual update into
    # an FMA; the layers stay internally consistent — see module docstring)
    np.testing.assert_allclose(np.asarray(deps[:nlay]),
                               m["deps_vec"][:nlay], rtol=1e-12)
    np.testing.assert_allclose(np.asarray(minv[:nlay]),
                               m["minval_vec"][:nlay], rtol=1e-10, atol=1e-18)
    # symbol planes reproduce the native streams byte for byte
    payload, lens = wn.encode_planes_batch(np.asarray(planes[:nlay]))
    assert payload == m["data"]


def test_accumulate_layers_order():
    rng = np.random.default_rng(3)
    planes = rng.integers(0, 256, (3, 100)).astype(np.uint8)
    deps = np.array([1.5, 0.25, 1e-3])
    minv = np.array([-7.0, 0.1, 3e-4])
    acc = np.asarray(accumulate_layers(jnp.asarray(planes),
                                       jnp.asarray(deps), jnp.asarray(minv)))
    ref = np.zeros(100)
    for i in range(3):
        ref = ref + (planes[i].astype(np.float64) * deps[i] + minv[i])
    assert np.array_equal(acc, ref)


@pytest.mark.parametrize("tol", [1e-7, 1e-3])
def test_jax_codec_stream_identical_at_moderate_tol(tol):
    a = smooth_field((32, 24, 20))
    ej = codec.encode_field(a, tol, backend="jax")
    en = codec.encode_field(a, tol, backend="native")
    assert ej.nlay == en.nlay
    assert ej.data == en.data
    assert ej.tolabs == en.tolabs


def test_jax_codec_roundtrip_tolerance():
    a = smooth_field((32, 32, 32))
    for tol in (1e-16, 1e-8, 1e-4):
        e = codec.encode_field(a, tol, backend="jax")
        # conformance decode of the jax-produced stream
        r_native = codec.decode_field(e, backend="native")
        r_jax = codec.decode_field(e, backend="jax")
        bound = 1.3 * tol * np.abs(a).max() + 5e-15 * np.abs(a).max()
        assert np.abs(r_native - a).max() <= bound
        # device decode agrees with conformance decode to ulp noise
        assert np.abs(r_jax - r_native).max() <= 1e-13 * np.abs(a).max()


def test_trivial_field_jax():
    a = np.full((8, 8, 8), 42.0)
    e = codec.encode_field(a, 1e-6, backend="jax")
    assert e.ntot_enc == 0 and e.nlay == 0
    r = codec.decode_field(e)
    assert np.array_equal(r, a)


def test_wtflag0_jax_matches_native():
    a = smooth_field((16, 16, 16))
    ej = codec.encode_field(a, 1e-5, wtflag=0, backend="jax")
    en = codec.encode_field(a, 1e-5, wtflag=0, backend="native")
    assert ej.wlev == 0 == en.wlev
    assert ej.data == en.data


def test_f32_native_precision_mode():
    """precision="native" keeps f32 on device; the
    stream stays decodable by the conformance decoder with f32-level
    error control."""
    a32 = smooth_field((32, 24, 16)).astype(np.float32)
    e = codec.encode_field(a32, 1e-4, backend="jax", precision="native")
    r = codec.decode_field(e, backend="native")
    err = np.abs(r - a32.astype(np.float64)).max()
    assert err <= 1.3e-4 * np.abs(a32).max() + 1e-5 * np.abs(a32).max()
    # f32 path compresses at least as well as widened-f64 at this tol
    e64 = codec.encode_field(a32, 1e-4, backend="jax")
    assert abs(e.ntot_enc - e64.ntot_enc) < 0.1 * e64.ntot_enc + 1024


@pytest.mark.parametrize("shape", [(8, 8, 256), (4, 16, 512), (8, 16, 256),
                                   (16, 32, 128), (4, 8, 128), (5, 9, 131)])
def test_f32_device_path_roundtrip(shape):
    """The f32 device path is plain XLA on every platform: its encode
    and decode steps keep f32, and the stream round-trips within the
    contract through both decoders."""
    from waverange.ops.quant import decode_step, encode_step
    a32 = smooth_field(shape, np.random.default_rng(3),
                       noise=1e-3).astype(np.float32)
    tol = 1e-5
    out = encode_step(jnp.asarray(a32), tol)
    nlay = int(out[3])
    assert out[1].dtype == jnp.float32 and 1 <= nlay <= 8
    back = decode_step(out[0][:nlay], out[1][:nlay], out[2][:nlay],
                       shape=shape)
    assert back.dtype == jnp.float32 and back.shape == shape
    e = codec.encode_field(a32, tol, backend="jax", precision="native")
    assert e.nlay == nlay
    bound = 1.3 * tol * np.abs(a32).max()
    for be in ("jax", "native"):
        r = codec.decode_field(e, backend=be)
        assert np.abs(r - a32.astype(np.float64)).max() <= bound, be
