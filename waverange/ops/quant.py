"""Byte-layer quantization as XLA ops.

The reference quantizes the wavelet field into successive 8-bit "byte
layers" with residual refinement until the quantization step drops below
the absolute tolerance (wrappers.cpp:305-441). The layer count is
data-dependent; on device we run all NLAYMAX=8 layers speculatively under
`lax.scan` with a done-mask — layers past the break keep the field frozen
and their planes are discarded on the host. This keeps the whole encode
step a single jittable program (no host round-trip per layer).

Bit-exactness notes (f64):
  * min/max are associative+commutative (NaN-free data), so XLA's tree
    reductions equal the reference's sequential fmin/fmax scans;
  * quantize is `floor(a*x + b)` with separate mul/add (C's double->uchar
    conversion truncates, and a*x+b >= 0);
  * the residual update and the decode-side accumulate preserve the
    per-layer sequential op order.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .wavelet import cdf97_forward, cdf97_inverse

NLAYMAX = 8
QALPHABET = 255.0  # q - 1


def quantize_layers(w: jax.Array, tolabs: jax.Array,
                    qalpha: jax.Array | None = None):
    """Quantize a wavelet-space field into up to 8 byte layers.

    Args:
      w: flattened f64 (or f32) wavelet coefficients, any shape.
      tolabs: scalar absolute tolerance (already derated by WAV_ACC_COEF).
      qalpha: runtime scalar 255.0. Passed as a traced value (not a
        constant) so XLA emits a true division — its algebraic simplifier
        rewrites division by a *constant* into multiplication by the
        reciprocal, which changes the low bits vs the reference's
        `(max-min)/255` (wrappers.cpp:323).

    Returns:
      planes: (8,) + w.shape uint8 — quantized symbols per layer,
      deps: (8,) f64 — quantization steps,
      minv: (8,) f64 — per-layer offsets,
      nlay: () int32 — number of valid layers (1..8).
    """
    dtype = w.dtype
    tolabs = jnp.asarray(tolabs, dtype)
    if qalpha is None:
        qalpha = jnp.asarray(QALPHABET, dtype)

    def body(carry, ilay):
        fld, done = carry
        mn = jnp.min(fld)
        mx = jnp.max(fld)
        deps0 = (mx - mn) / qalpha
        hit_tol = deps0 < tolabs
        deps = jnp.where(hit_tol, tolabs, deps0)
        last = hit_tol | (ilay >= NLAYMAX - 1)
        a = 1.0 / deps
        b = -mn * a + 0.5
        q = jnp.floor(a * fld + b).astype(jnp.uint8)
        resid = fld - (q.astype(dtype) * deps + mn)
        new_fld = jnp.where(done, fld, resid)
        # A layer is "emitted" if we were not already done before it.
        emitted = ~done
        return (new_fld, done | last), (q, deps, mn, emitted)

    (_, _), (planes, deps, minv, emitted) = jax.lax.scan(
        body, (w, jnp.asarray(False)), jnp.arange(NLAYMAX))
    nlay = jnp.sum(emitted).astype(jnp.int32)
    return planes, deps, minv, nlay


def accumulate_layers(planes: jax.Array, deps: jax.Array, minv: jax.Array,
                      dtype=jnp.float64) -> jax.Array:
    """Decode-side: sum the dequantized layers in layer order.

    planes: (nlay, ...) uint8; deps/minv: (nlay,). The loop is unrolled at
    trace time (nlay is static on the decode path) to preserve the exact
    sequential accumulation order of the reference (wrappers.cpp:512-514).
    """
    nlay = planes.shape[0]
    acc = jnp.zeros(planes.shape[1:], dtype)
    for i in range(nlay):
        acc = acc + (planes[i].astype(dtype) * deps[i] + minv[i])
    return acc


@partial(jax.jit, static_argnames=("wtflag", "levels"))
def _encode_step_impl(fld: jax.Array, tolrel: jax.Array, wav_acc: jax.Array,
                      qalpha: jax.Array, wtflag: bool = True,
                      levels: int = 4):
    dtype = fld.dtype
    mn = jnp.min(fld)
    mx = jnp.max(fld)
    halfspanval = (mx - mn) / 2
    midval = mn + halfspanval
    tiny = jnp.asarray(4.4501477170144023e-308, dtype)  # 2*DBL_MIN
    trivial = halfspanval <= tiny

    w = cdf97_forward(fld, levels if wtflag else 0)
    tolabs = tolrel * jnp.maximum(jnp.abs(mn), jnp.abs(mx)) / wav_acc
    planes, deps, minv, nlay = quantize_layers(w.ravel(), tolabs, qalpha)
    return planes, deps, minv, nlay, tolabs, midval, halfspanval, trivial


def encode_step(fld: jax.Array, tolrel: jax.Array, wtflag: bool = True,
                levels: int = 4):
    """Full device-side encode: stats + wavelet + byte layers.

    Returns (planes, deps, minv, nlay, tolabs, midval, halfspanval,
    trivial) — the host slices planes[:nlay] into the entropy coder.
    `trivial` flags the constant-field early exit (wrappers.cpp:257-266);
    the caller must emit ntot_enc=0 in that case.

    The WAV_ACC_COEF (1.75) and alphabet (255) divisors are fed as runtime
    scalars so XLA performs true divisions (see quantize_layers).
    """
    dtype = fld.dtype
    return _encode_step_impl(fld, jnp.asarray(tolrel, dtype),
                             jnp.asarray(1.75, dtype),
                             jnp.asarray(QALPHABET, dtype),
                             wtflag=wtflag, levels=levels)


@partial(jax.jit, static_argnames=("shape", "levels"))
def decode_step(planes: jax.Array, deps: jax.Array, minv: jax.Array,
                shape, levels: int = 4):
    """Full device-side decode: accumulate layers + inverse wavelet."""
    acc = accumulate_layers(planes, deps, minv, dtype=deps.dtype)
    return cdf97_inverse(acc.reshape(shape), levels)
