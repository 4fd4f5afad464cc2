"""Separable 3-D CDF 9/7 lifting wavelet as vectorized XLA ops.

Instead of the reference's per-line gather loops (waveletcdf97_3d.c:94-136),
each level/axis sweep operates on the whole active sub-box at once —
even/odd deinterleave via strided slices, four lifting updates as fused
elementwise ops, edge-replicated boundaries via concatenation. XLA fuses
each stage into a handful of elementwise kernels; every line in the
sub-box is processed in parallel.

Bit-exactness: with f64 inputs (x64 enabled) the op order per element is
identical to the native/reference implementation, and the boundary terms
are expressed as edge-replicated sums, which round identically to the
reference's doubled-endpoint form: round(l*(v+v)) == round((2l)*v) since
v+v and 2l are exact. That needs mul and add kept separate: XLA's GPU
backend does (no FMA in the lifting PTX; the device wavelet equals the
native one bit for bit on an H100, PERF.md), its CPU backend contracts
them into FMAs and differs in the last bit.

Shapes are static under jit: `levels` and the input shape determine all
sub-box extents at trace time.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Lifting coefficients (CDF 9/7, Getreuer convention — reference
# waveletcdf97_3d.c:41-45).
L0 = -1.5861343420693648
L1 = -0.0529801185718856
L2 = 0.8829110755411875
L3 = 0.4435068520511142
SCALE = 1.1496043988602418
SCALE_INV = 1.0 / 1.1496043988602418

# Extrapolation coefficients for odd-length lines (exact expressions as in
# the reference; evaluated in f64 at import time).
_DEN = 1 + 2 * L1 * L2
EXT0 = -2 * L0 * L1 * L2 / _DEN
EXT1 = -2 * L1 * L2 / _DEN
EXT2 = -2 * (L0 + L2 + 3 * L0 * L1 * L2) / _DEN


def _halve(n: int) -> int:
    return n // 2 + (n % 2)


def _shift_down(v, axis):
    """v[i+1] with edge replication at the end: [v1..v_{m-1}, v_{m-1}]."""
    first = jax.lax.slice_in_dim(v, 1, v.shape[axis], axis=axis)
    last = jax.lax.slice_in_dim(v, v.shape[axis] - 1, v.shape[axis], axis=axis)
    return jnp.concatenate([first, last], axis=axis)


def _shift_up(v, axis):
    """v[i-1] with edge replication at the start: [v_0, v_0..v_{m-2}]."""
    head = jax.lax.slice_in_dim(v, 0, 1, axis=axis)
    rest = jax.lax.slice_in_dim(v, 0, v.shape[axis] - 1, axis=axis)
    return jnp.concatenate([head, rest], axis=axis)


def _lift_fwd_axis(v, axis):
    """Forward-lift all lines of `v` along `axis` (length must be > 1)."""
    n = v.shape[axis]
    m = _halve(n)
    idx_even = jax.lax.slice_in_dim(v, 0, n, stride=2, axis=axis)
    idx_odd = jax.lax.slice_in_dim(v, 1, n, stride=2, axis=axis)
    lo = idx_even  # length m
    if n % 2:
        # Extrapolate the missing odd tail sample.
        lo_m2 = jax.lax.slice_in_dim(lo, m - 2, m - 1, axis=axis)
        lo_m1 = jax.lax.slice_in_dim(lo, m - 1, m, axis=axis)
        hi_m2 = jax.lax.slice_in_dim(idx_odd, m - 2, m - 1, axis=axis)
        tail = lo_m2 * EXT0 + hi_m2 * EXT1 + lo_m1 * EXT2
        hi = jnp.concatenate([idx_odd, tail], axis=axis)
    else:
        hi = idx_odd

    # Four lifting stages; boundary handling == edge replication.
    hi = hi + L0 * (_shift_down(lo, axis) + lo)
    lo = lo + L1 * (hi + _shift_up(hi, axis))
    hi = hi + L2 * (_shift_down(lo, axis) + lo)
    lo = lo + L3 * (hi + _shift_up(hi, axis))

    lo = lo * SCALE
    hi = hi * SCALE_INV
    if n % 2:  # the extrapolated sample is not stored
        hi = jax.lax.slice_in_dim(hi, 0, n - m, axis=axis)
    return jnp.concatenate([lo, hi], axis=axis)


def _lift_inv_axis(v, axis):
    """Inverse-lift all lines of `v` along `axis` (length must be > 1)."""
    n = v.shape[axis]
    q = _halve(n)
    lo = jax.lax.slice_in_dim(v, 0, q, axis=axis) * SCALE_INV
    hi = jax.lax.slice_in_dim(v, q, n, axis=axis) * SCALE
    if n % 2:  # re-append the (zeroed) extrapolated sample slot
        zshape = list(v.shape)
        zshape[axis] = 1
        hi = jnp.concatenate([hi, jnp.zeros(zshape, v.dtype)], axis=axis)

    lo = lo - L3 * (hi + _shift_up(hi, axis))
    hi = hi - L2 * (_shift_down(lo, axis) + lo)
    lo = lo - L1 * (hi + _shift_up(hi, axis))
    hi = hi - L0 * (_shift_down(lo, axis) + lo)

    # Re-interleave even/odd.
    st = jnp.stack([lo, hi], axis=axis + 1)  # (..., q, 2, ...)
    shape = list(v.shape)
    shape[axis] = 2 * q
    out = st.reshape(shape)
    if n % 2:
        out = jax.lax.slice_in_dim(out, 0, n, axis=axis)
    return out


def _set_subbox(x, sub, extents):
    if sub.shape == x.shape:
        return sub
    return jax.lax.dynamic_update_slice(x, sub, (0, 0, 0))


def cdf97_forward(x: jax.Array, levels: int) -> jax.Array:
    """Forward multiresolution transform of an (nz, ny, nx) array.

    Sweeps x (fastest axis), then y, then z per level, on the shrinking
    active low-pass sub-box (extent ceil(n/2^k)), exactly mirroring the
    reference's level/axis order (waveletcdf97_3d.c:73-276).
    """
    nz, ny, nx = x.shape
    az, ay, ax_ = nz, ny, nx
    for _ in range(levels):
        sub = x[:az, :ay, :ax_]
        if ax_ > 1:
            sub = _lift_fwd_axis(sub, 2)
        if ay > 1:
            sub = _lift_fwd_axis(sub, 1)
        if az > 1:
            sub = _lift_fwd_axis(sub, 0)
        x = _set_subbox(x, sub, (az, ay, ax_))
        az, ay, ax_ = _halve(az), _halve(ay), _halve(ax_)
    return x


def cdf97_inverse(x: jax.Array, levels: int) -> jax.Array:
    """Inverse transform: coarsest level first, axes z then y then x."""
    nz, ny, nx = x.shape

    def cdiv_pow(n, k):
        p = 1 << k
        return n // p + (1 if n % p else 0)

    for k in range(levels, 0, -1):
        az, ay, ax_ = (cdiv_pow(nz, k - 1), cdiv_pow(ny, k - 1),
                       cdiv_pow(nx, k - 1))
        sub = x[:az, :ay, :ax_]
        if az > 1:
            sub = _lift_inv_axis(sub, 0)
        if ay > 1:
            sub = _lift_inv_axis(sub, 1)
        if ax_ > 1:
            sub = _lift_inv_axis(sub, 2)
        x = _set_subbox(x, sub, (az, ay, ax_))
    return x


def cdf97_3d(x: jax.Array, levels: int) -> jax.Array:
    """Reference-style signed-level entry: >0 forward, <0 inverse."""
    if levels >= 0:
        return cdf97_forward(x, levels)
    return cdf97_inverse(x, -levels)
