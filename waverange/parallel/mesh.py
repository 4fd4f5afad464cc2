"""Distributed / multi-device execution over a `jax.sharding.Mesh`.

Device-parallel replacements for the reference's file-level parallelism
(SURVEY.md §2 item 5):

  * **Field data-parallelism** — independent fields in one file are
    sharded across devices (reference: sequential field loop,
    gen_enc.cpp:538). `encode_fields_sharded` jits a vmapped encode step
    with `NamedSharding(P("d"))` on the batch axis; each device transforms
    and quantizes its fields, the host range-codes all per-field layer
    streams in a thread pool, preserving file order.

  * **Subdomain data-parallelism (divided mode)** — one huge field is
    split into z-slabs, each encoded as an independent subdomain stream
    with deterministic ordering (reference: PROCID-sharded files,
    mssg_enc.cpp:457-470). Bitstreams stay reference-compatible per
    subdomain.

  * **United mode** — one global field assembled from per-device slabs:
    global min/max via collectives inside `shard_map` and an
    `all_gather` for the (whole-field) wavelet — the device equivalent of
    the reference's gather-then-encode (mssg_enc.cpp:522-543), riding
    the device interconnect instead of the filesystem.
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import native as wn
from ..core.codec import NLAYMAX, WAV_LVL, EncodedField
from ..device import require_x64
from ..ops.quant import _encode_step_impl, decode_step


def make_mesh(n_devices: Optional[int] = None, axis: str = "d") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


# ---------------------------------------------------------------------------
# Batched (vmapped) encode/decode over a leading field axis
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("wtflag", "levels"))
def _encode_batch(fields, tolrel, wav_acc, qalpha, wtflag=True, levels=4):
    fn = partial(_encode_step_impl, wtflag=wtflag, levels=levels)
    return jax.vmap(fn, in_axes=(0, None, None, None))(
        fields, tolrel, wav_acc, qalpha)


def encode_fields_sharded(fields: np.ndarray, tolrel: float,
                          mesh: Optional[Mesh] = None, wtflag: int = 1,
                          backend_threads: Optional[int] = None
                          ) -> List[EncodedField]:
    """Encode a batch of equally-shaped fields, sharded over the mesh.

    fields: (B, nz, ny, nx). B should be a multiple of the mesh size for
    even sharding (padding is handled by replicating the last field and
    dropping its result).
    """
    require_x64()
    B, nz, ny, nx = fields.shape
    n = nz * ny * nx
    dtype = jnp.float64
    arr = np.asarray(fields, np.float64)
    pad = 0
    if mesh is not None:
        d = mesh.devices.size
        pad = (-B) % d
        if pad:
            arr = np.concatenate([arr, np.repeat(arr[-1:], pad, 0)], 0)
    xs = jnp.asarray(arr, dtype)
    if mesh is not None:
        sh = NamedSharding(mesh, P(mesh.axis_names[0]))
        xs = jax.device_put(xs, sh)
    planes, deps, minv, nlay, tolabs, midval, halfspan, trivial = (
        _encode_batch(xs, jnp.asarray(tolrel, dtype),
                      jnp.asarray(1.75, dtype),
                      jnp.asarray(255.0, dtype), wtflag=bool(wtflag)))
    # Small metadata comes down whole; the (B, 8, n) plane matrix stays
    # on device and is streamed per (field, layer) below.
    nlay = np.asarray(nlay)[:B]
    deps = np.asarray(deps)[:B]
    minv = np.asarray(minv)[:B]
    tolabs = np.asarray(tolabs)[:B]
    midval = np.asarray(midval)[:B]
    halfspan = np.asarray(halfspan)[:B]
    trivial = np.asarray(trivial)[:B]

    # Host side: stream planes one (field, layer) at a time through a
    # bounded coder pool — the native pipeline's slot-pool discipline
    # (wr_native.cc encode loop: resident planes <= threads + 2). The
    # old path materialized the full (B, 8, n) u8 matrix first (8 GiB
    # per 1024^3 field in flight).
    idx = [(b, l) for b in range(B) if not trivial[b]
           for l in range(int(nlay[b]))]
    streams = _stream_code_planes(planes, idx, backend_threads)

    out: List[EncodedField] = []
    for b in range(B):
        deps_vec = np.zeros(NLAYMAX)
        minv_vec = np.zeros(NLAYMAX)
        len_vec = np.zeros(NLAYMAX, np.uint64)
        if trivial[b]:
            out.append(EncodedField(
                nx=nx, ny=ny, nz=nz, tolabs=0.0, midval=float(midval[b]),
                halfspanval=float(halfspan[b]), wlev=0, nlay=0, ntot_enc=0,
                deps_vec=deps_vec, minval_vec=minv_vec, len_enc_vec=len_vec,
                data=b""))
            continue
        nl = int(nlay[b])
        chunks = [streams[(b, l)] for l in range(nl)]
        for l in range(nl):
            len_vec[l] = len(chunks[l])
        deps_vec[:nl] = deps[b, :nl]
        minv_vec[:nl] = minv[b, :nl]
        data = b"".join(chunks)
        out.append(EncodedField(
            nx=nx, ny=ny, nz=nz, tolabs=float(tolabs[b]),
            midval=float(midval[b]), halfspanval=float(halfspan[b]),
            wlev=WAV_LVL if wtflag else 0, nlay=nl, ntot_enc=len(data),
            deps_vec=deps_vec, minval_vec=minv_vec, len_enc_vec=len_vec,
            data=data))
    return out


#: test hook — peak count of host-resident symbol planes during the last
#: `_stream_code_planes` call (must stay <= threads + 2).
_last_peak_resident = 0


def _stream_code_planes(planes_dev, idx, backend_threads=None):
    """Entropy-code device planes with bounded host residency.

    Transfers plane (b, l) from the device only when a slot is free
    (threads + 2 slots, matching the native coder's slot pool) and codes
    it on a thread pool; at most `threads + 2` planes live on the host
    at any instant regardless of batch size.
    """
    import os
    import threading
    from concurrent.futures import ThreadPoolExecutor

    global _last_peak_resident
    nthreads = backend_threads or os.cpu_count() or 1
    slots = nthreads + 2
    sem = threading.Semaphore(slots)
    lock = threading.Lock()
    resident = 0
    peak = 0
    streams = {}

    def code_one(key, plane_host):
        nonlocal resident
        try:
            streams[key] = wn.encode_plane(plane_host)
        finally:
            with lock:
                resident -= 1
            sem.release()

    with ThreadPoolExecutor(max_workers=nthreads) as pool:
        futs = []
        for (b, l) in idx:
            sem.acquire()
            with lock:
                resident += 1
                peak = max(peak, resident)
            plane_host = np.asarray(planes_dev[b, l])  # one-plane D2H
            futs.append(pool.submit(code_one, (b, l), plane_host))
        for f in futs:
            f.result()
    _last_peak_resident = peak
    return streams


#: test hook — peak count of host-resident symbol planes during the last
#: `_stream_decode_planes` call (must stay <= threads + 2).
_last_peak_resident_decode = 0


def _stream_decode_planes(encs: Sequence[EncodedField], n: int,
                          backend_threads: Optional[int] = None):
    """Entropy-decode per (field, layer) with bounded host residency.

    Mirror of `_stream_code_planes` (VERDICT r4 item 4): a plane is
    decoded only when one of `threads + 2` slots is free and uploaded to
    the device as soon as it is ready — at most `threads + 2` planes live
    on the host at any instant regardless of batch size (the old path
    materialized the full (B, NLAYMAX, n) matrix: 8.6 GiB for 8
    1024^3-slab fields). Returns {(b, l): device (n,) u8 array}.
    """
    import os
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from ..core.codec import coder_id_for_version

    global _last_peak_resident_decode
    nthreads = backend_threads or os.cpu_count() or 1
    slots = nthreads + 2
    sem = threading.Semaphore(slots)
    lock = threading.Lock()
    resident = 0
    peak = 0
    out = {}

    def one(key, data, coder):
        nonlocal resident
        try:
            plane = wn.decode_plane(data, n, coder=coder)
            d = jax.device_put(plane)
            d.block_until_ready()  # host buffer is free after this
            out[key] = d
        finally:
            with lock:
                resident -= 1
            sem.release()

    with ThreadPoolExecutor(max_workers=nthreads) as pool:
        futs = []
        for b, e in enumerate(encs):
            if e.ntot_enc == 0:
                continue
            offs = np.concatenate(
                [[0], np.cumsum(e.len_enc_vec[:e.nlay])]).astype(int)
            cid = coder_id_for_version(e.coder_version)
            for l in range(e.nlay):
                sem.acquire()
                with lock:
                    resident += 1
                    peak = max(peak, resident)
                futs.append(pool.submit(
                    one, (b, l), e.data[offs[l]:offs[l + 1]], cid))
        for f in futs:
            f.result()
    _last_peak_resident_decode = peak
    return out


def decode_fields_sharded(encs: Sequence[EncodedField],
                          mesh: Optional[Mesh] = None,
                          backend_threads: Optional[int] = None
                          ) -> np.ndarray:
    """Decode equally-shaped fields: streamed host entropy-decode
    (threaded, bounded residency), then a sharded device
    accumulate+inverse-wavelet batch."""
    require_x64()
    B = len(encs)
    nz, ny, nx = encs[0].shape_zyx
    n = nz * ny * nx
    dev = _stream_decode_planes(encs, n, backend_threads)
    deps = np.zeros((B, NLAYMAX))
    minv = np.zeros((B, NLAYMAX))
    for b, e in enumerate(encs):
        deps[b, :e.nlay] = e.deps_vec[:e.nlay]
        minv[b, :e.nlay] = e.minval_vec[:e.nlay]

    # assemble (B, NLAYMAX, n) on the device from the streamed planes
    zero = jnp.zeros((n,), jnp.uint8)
    xs = jnp.stack([
        jnp.stack([dev.get((b, l), zero) for l in range(NLAYMAX)])
        for b in range(B)])
    deps_p, minv_p = deps, minv
    if mesh is not None:
        # batch must divide evenly for sharding; replicate-pad
        d = mesh.devices.size
        pad = (-B) % d
        if pad:
            xs = jnp.concatenate([xs, jnp.repeat(xs[-1:], pad, 0)], 0)
            deps_p = np.concatenate([deps, np.repeat(deps[-1:], pad, 0)], 0)
            minv_p = np.concatenate([minv, np.repeat(minv[-1:], pad, 0)], 0)
        sh = NamedSharding(mesh, P(mesh.axis_names[0]))
        xs = jax.device_put(xs, sh)
    fn = jax.jit(jax.vmap(partial(decode_step, shape=(nz, ny, nx),
                                  levels=WAV_LVL)))
    # np.array (not asarray): device arrays view as read-only and the
    # trivial/wlev==0 branches below write into the result
    out = np.array(fn(xs, jnp.asarray(deps_p), jnp.asarray(minv_p))[:B])
    for b, e in enumerate(encs):
        # wtflag=0 fields (rare path — e.g. MSSG masks): accumulate on
        # the host, one plane at a time (residency stays bounded).
        # XLA contracts `plane*deps + minv` into an FMA, which breaks
        # bit-identity with the native decoder exactly where these
        # fields live (huge-magnitude mask sentinels cancel against
        # minval); numpy's separate mul/add matches the native order.
        if e.ntot_enc != 0 and e.wlev == 0:
            acc = np.zeros(n)
            for l in range(e.nlay):
                pl = np.asarray(dev[(b, l)]).astype(np.float64)
                acc += pl * e.deps_vec[l] + e.minval_vec[l]
            out[b] = acc.reshape(nz, ny, nx)
    for b, e in enumerate(encs):
        if e.ntot_enc == 0:
            out[b] = e.midval
    return out


# ---------------------------------------------------------------------------
# Divided mode: one big field -> per-chip z-slab subdomains
# ---------------------------------------------------------------------------

def encode_field_divided(fld: np.ndarray, tolrel: float,
                         n_blocks: Optional[int] = None,
                         mesh: Optional[Mesh] = None,
                         wtflag: int = 1) -> List[EncodedField]:
    """Split (nz, ny, nx) into z-slabs and encode each independently
    (the reference's backup-divided semantics, PROCID == slab index)."""
    nz = fld.shape[0]
    if n_blocks is None:
        n_blocks = mesh.devices.size if mesh is not None else 1
    assert nz % n_blocks == 0, "nz must divide into equal slabs"
    slabs = np.stack(np.split(np.asarray(fld, np.float64), n_blocks, 0))
    return encode_fields_sharded(slabs, tolrel, mesh=mesh, wtflag=wtflag)


def decode_field_divided(encs: Sequence[EncodedField],
                         mesh: Optional[Mesh] = None) -> np.ndarray:
    slabs = decode_fields_sharded(encs, mesh=mesh)
    return np.concatenate(list(slabs), axis=0)


# ---------------------------------------------------------------------------
# United mode: global field from per-chip slabs, with real collectives
# ---------------------------------------------------------------------------

def united_encode_step(mesh: Mesh, shape, levels: int = WAV_LVL):
    """Build a jitted united-mode encode step over `mesh`.

    Input: per-device z-slabs (D, nz/D, ny, nx) sharded over the mesh.
    Inside shard_map: global min/max via collectives (the device
    equivalent of the reference's shared quantization parameters), then
    an all_gather assembles the global field for the whole-field wavelet
    + byte-layer quantization (mssg united gather, mssg_enc.cpp:522-543).
    Returns a function (slabs, tolrel) -> (planes, deps, minv, nlay,
    tolabs, midval, halfspan, trivial).
    """
    require_x64()
    from jax import shard_map

    axis = mesh.axis_names[0]
    nz, ny, nx = shape

    def step(slabs, tolrel, wav_acc, qalpha):
        def local(sl, tolrel, wav_acc, qalpha):
            # sl: (nz/D, ny, nx) local slab
            lmn = jnp.min(sl)
            lmx = jnp.max(sl)
            gmn = jax.lax.pmin(lmn, axis)
            gmx = jax.lax.pmax(lmx, axis)
            full = jax.lax.all_gather(sl, axis, axis=0, tiled=True)
            return (full, gmn, gmx)

        full, gmn, gmx = shard_map(
            local, mesh=mesh,
            in_specs=(P(axis, None, None), P(), P(), P()),
            out_specs=(P(), P(), P()),
            check_vma=False)(slabs, tolrel, wav_acc, qalpha)
        halfspan = (gmx - gmn) / 2
        midval = gmn + halfspan
        trivial = halfspan <= jnp.asarray(4.4501477170144023e-308,
                                          full.dtype)
        from ..ops.wavelet import cdf97_forward
        from ..ops.quant import quantize_layers
        w = cdf97_forward(full, levels)
        tolabs = tolrel * jnp.maximum(jnp.abs(gmn), jnp.abs(gmx)) / wav_acc
        planes, deps, minv, nlay = quantize_layers(w.ravel(), tolabs,
                                                   qalpha)
        return planes, deps, minv, nlay, tolabs, midval, halfspan, trivial

    jitted = jax.jit(step)

    def run(slabs, tolrel):
        dtype = slabs.dtype
        return jitted(slabs, jnp.asarray(tolrel, dtype),
                      jnp.asarray(1.75, dtype), jnp.asarray(255.0, dtype))

    return run


# ---------------------------------------------------------------------------
# Distributed united mode: level-1 wavelet sharded, collective quantizer
# ---------------------------------------------------------------------------

def distributed_encode_step(mesh: Mesh, shape, levels: int = WAV_LVL):
    """United-mode encode with the transform itself distributed.

    The existing `united_encode_step` all_gathers the full field before
    transforming (memory V per chip). Here level 1 — 7/8 of the wavelet
    FLOPs and the full-volume memory — runs sharded: x/y sweeps are local
    to each z-slab, the z sweep runs on an `all_to_all` transpose
    (y-sharded layout), and only the level-1 low-pass half-box (V/2) is
    replicated (psum-assembled) for the cheap deeper levels. The 8-layer
    quantizer then runs fully distributed: per-layer global min/max via
    pmin/pmax collectives, every device quantizing its own slab; the
    returned planes are z-major sharded, so host-order concatenation
    reproduces the reference's global symbol order.

    Requirements (else fall back to `united_encode_step`): nz and ny
    divisible by 2*D, extents even through `levels` halvings.

    Returns run(slabs, tolrel) like `united_encode_step`.
    """
    require_x64()
    from jax import shard_map

    axis = mesh.axis_names[0]
    D = mesh.devices.size
    nz, ny, nx = shape
    n = nz * ny * nx

    def _ok():
        if nz % (2 * D) or ny % D:
            return False
        a = [nz, ny, nx]
        for _ in range(levels):
            if any(v % 2 for v in a):
                return False
            a = [v // 2 for v in a]
        return True

    if not _ok():
        return united_encode_step(mesh, shape, levels)

    from ..ops.quant import NLAYMAX

    def step(slabs, tolrel, wav_acc, qalpha):
        def local(sl, tolrel, wav_acc, qalpha):
            dtype = sl.dtype
            gmn = jax.lax.pmin(jnp.min(sl), axis)
            gmx = jax.lax.pmax(jnp.max(sl), axis)
            halfspan = (gmx - gmn) / 2
            midval = gmn + halfspan
            trivial = halfspan <= jnp.asarray(4.4501477170144023e-308,
                                              dtype)
            tolabs = (tolrel * jnp.maximum(jnp.abs(gmn), jnp.abs(gmx))
                      / wav_acc)

            # --- fully-distributed multiresolution: every level's x/y
            # sweeps run local, z sweeps on all_to_all transposes, and
            # the shrinking low-pass box is re-distributed across all
            # ranks with ppermutes (replicated fallback only once the
            # extents stop dividing) ---
            w = _dist_fwd_recursive(sl, nz, ny, nx, levels, D, axis)

            # --- distributed 8-layer quantizer ---
            flat = w.reshape(-1)

            def body(carry, ilay):
                fld, done = carry
                mn = jax.lax.pmin(jnp.min(fld), axis)
                mx = jax.lax.pmax(jnp.max(fld), axis)
                deps0 = (mx - mn) / qalpha
                hit = deps0 < tolabs
                deps = jnp.where(hit, tolabs, deps0)
                last = hit | (ilay >= NLAYMAX - 1)
                a = 1.0 / deps
                b = -mn * a + 0.5
                q = jnp.floor(a * fld + b).astype(jnp.uint8)
                resid = fld - (q.astype(fld.dtype) * deps + mn)
                new_fld = jnp.where(done, fld, resid)
                return (new_fld, done | last), (q, deps, mn, ~done)

            (_, _), (planes, deps, minv, emitted) = jax.lax.scan(
                body, (flat, jnp.asarray(False)), jnp.arange(NLAYMAX))
            nlay = jnp.sum(emitted).astype(jnp.int32)
            return (planes, deps, minv, nlay, tolabs, midval, halfspan,
                    trivial)

        return shard_map(
            local, mesh=mesh,
            in_specs=(P(axis, None, None), P(), P(), P()),
            out_specs=(P(None, axis), P(), P(), P(), P(), P(), P(), P()),
            check_vma=False)(slabs, tolrel, wav_acc, qalpha)

    jitted = jax.jit(step)

    def run(slabs, tolrel):
        dtype = slabs.dtype
        return jitted(slabs, jnp.asarray(tolrel, dtype),
                      jnp.asarray(1.75, dtype), jnp.asarray(255.0, dtype))

    return run


def distributed_decode_step(mesh: Mesh, shape, levels: int = WAV_LVL):
    """Distributed counterpart of `distributed_encode_step`: layer
    accumulation on z-major-sharded planes, deep inverse levels on the
    psum-assembled half-box, and the level-1 inverse sweeps sharded
    (z via all_to_all transpose, y/x local).

    Returns run(planes, deps, minv) -> (nz, ny, nx) field sharded P(d).
    planes: (nlay, n) z-major with the last axis sharded over the mesh.
    Falls back to the single-device `decode_step` (replicated) for
    non-divisible shapes.
    """
    require_x64()
    from jax import shard_map

    axis = mesh.axis_names[0]
    D = mesh.devices.size
    nz, ny, nx = shape

    def _ok():
        if nz % (2 * D) or ny % D:
            return False
        a = [nz, ny, nx]
        for _ in range(levels):
            if any(v % 2 for v in a):
                return False
            a = [v // 2 for v in a]
        return True

    if not _ok():
        fn = jax.jit(partial(decode_step, shape=shape, levels=levels))

        def run_fallback(planes, deps, minv):
            return fn(planes, deps, minv)

        return run_fallback

    nzl = nz // D

    def step(planes, deps, minv):
        def local(pl, deps, minv):
            # pl: (nlay, n/D) — this rank's z-slab symbols per layer
            dtype = deps.dtype
            acc = jnp.zeros(pl.shape[1:], dtype)
            for l in range(pl.shape[0]):
                acc = acc + (pl[l].astype(dtype) * deps[l] + minv[l])
            sl = acc.reshape(nzl, ny, nx)
            return _dist_inv_recursive(sl, nz, ny, nx, levels, D, axis)

        return shard_map(
            local, mesh=mesh,
            in_specs=(P(None, axis), P(), P()),
            out_specs=P(axis, None, None),
            check_vma=False)(planes, deps, minv)

    return jax.jit(step)


# ---------------------------------------------------------------------------
# Fully-distributed multiresolution (per-level redistribution)
# ---------------------------------------------------------------------------

def _level_divisible(az, ay, ax, D):
    """Can level (az, ay, ax) be transformed fully sharded over D ranks?"""
    return (az % (2 * D) == 0 and ay % D == 0 and ay % 2 == 0
            and ax % 2 == 0)


def _dist_fwd_recursive(shard, az, ay, ax, lvls, D, axis):
    """Forward-transform `lvls` levels of an active box compact-sharded
    over z: each rank holds (az/D, ay, ax). Per level: x/y sweeps local,
    z sweep on an all_to_all transpose, then the low-pass half's rows are
    re-distributed with two ppermutes so the recursion stays sharded.
    Falls back to a psum-replicated transform for levels whose extents
    stop dividing (tiny by then)."""
    import jax
    import jax.numpy as jnp
    from ..ops.wavelet import _lift_fwd_axis, cdf97_forward

    if lvls == 0:
        return shard
    if not _level_divisible(az, ay, ax, D):
        # replicate the remaining (small) active box via psum and keep
        # only this rank's rows of the result
        azl = az // D
        r = jax.lax.axis_index(axis)
        start = (r * azl).astype(jnp.int32)
        zero = jnp.int32(0)
        contrib = jnp.zeros((az, ay, ax), shard.dtype)
        contrib = jax.lax.dynamic_update_slice(contrib, shard,
                                               (start, zero, zero))
        box = jax.lax.psum(contrib, axis)
        box = cdf97_forward(box, lvls)
        return jax.lax.dynamic_slice(box, (start, zero, zero),
                                     (azl, ay, ax))

    azl = az // D
    sub = _lift_fwd_axis(shard, 2)
    sub = _lift_fwd_axis(sub, 1)
    t = jax.lax.all_to_all(sub, axis, split_axis=1, concat_axis=0,
                           tiled=True)
    t = _lift_fwd_axis(t, 0)
    sub = jax.lax.all_to_all(t, axis, split_axis=0, concat_axis=1,
                             tiled=True)

    # Redistribute the low-pass half rows z[0:az/2] (on ranks < D/2,
    # 2c rows each) so every rank gets c = az/(2D) compact rows.
    c = az // (2 * D)
    lo0 = sub[:c]          # rows destined for rank 2r
    lo1 = sub[c:2 * c]     # rows destined for rank 2r + 1
    perm0 = [(r, 2 * r) for r in range(D // 2)]
    perm1 = [(r, 2 * r + 1) for r in range(D // 2)]
    half0 = jax.lax.ppermute(lo0, axis, perm0)
    half1 = jax.lax.ppermute(lo1, axis, perm1)
    half = half0 + half1   # exactly one is nonzero per rank

    corner = half[:, :ay // 2, :ax // 2]
    corner = _dist_fwd_recursive(corner, az // 2, ay // 2, ax // 2,
                                 lvls - 1, D, axis)
    half = half.at[:, :ay // 2, :ax // 2].set(corner)

    # Send the transformed half rows back to their parent-layout ranks.
    back0 = jax.lax.ppermute(half, axis, [(d, s) for (s, d) in perm0])
    back1 = jax.lax.ppermute(half, axis, [(d, s) for (s, d) in perm1])
    restored = jnp.concatenate([back0[:c], back1[:c]], axis=0)
    r = jax.lax.axis_index(axis)
    sub = jnp.where(r < D // 2,
                    jnp.concatenate([restored, sub[2 * c:]], axis=0)
                    if 2 * c < azl else restored,
                    sub)
    return sub


def _dist_inv_recursive(shard, az, ay, ax, lvls, D, axis):
    """Inverse of `_dist_fwd_recursive` (coarsest level first)."""
    import jax
    import jax.numpy as jnp
    from ..ops.wavelet import _lift_inv_axis, cdf97_inverse

    if lvls == 0:
        return shard
    if not _level_divisible(az, ay, ax, D):
        azl = az // D
        r = jax.lax.axis_index(axis)
        start = (r * azl).astype(jnp.int32)
        zero = jnp.int32(0)
        contrib = jnp.zeros((az, ay, ax), shard.dtype)
        contrib = jax.lax.dynamic_update_slice(contrib, shard,
                                               (start, zero, zero))
        box = jax.lax.psum(contrib, axis)
        box = cdf97_inverse(box, lvls)
        return jax.lax.dynamic_slice(box, (start, zero, zero),
                                     (azl, ay, ax))

    azl = az // D
    c = az // (2 * D)
    # gather this level's low-pass half into compact sharding
    perm0 = [(r, 2 * r) for r in range(D // 2)]
    perm1 = [(r, 2 * r + 1) for r in range(D // 2)]
    half0 = jax.lax.ppermute(shard[:c], axis, perm0)
    half1 = jax.lax.ppermute(shard[c:2 * c], axis, perm1)
    half = half0 + half1

    corner = half[:, :ay // 2, :ax // 2]
    corner = _dist_inv_recursive(corner, az // 2, ay // 2, ax // 2,
                                 lvls - 1, D, axis)
    half = half.at[:, :ay // 2, :ax // 2].set(corner)

    back0 = jax.lax.ppermute(half, axis, [(d, s) for (s, d) in perm0])
    back1 = jax.lax.ppermute(half, axis, [(d, s) for (s, d) in perm1])
    restored = jnp.concatenate([back0[:c], back1[:c]], axis=0)
    r = jax.lax.axis_index(axis)
    shard = jnp.where(r < D // 2,
                      jnp.concatenate([restored, shard[2 * c:]], axis=0)
                      if 2 * c < azl else restored,
                      shard)

    # level-1-of-this-depth inverse: z (transposed), y, x
    t = jax.lax.all_to_all(shard, axis, split_axis=1, concat_axis=0,
                           tiled=True)
    t = _lift_inv_axis(t, 0)
    shard = jax.lax.all_to_all(t, axis, split_axis=0, concat_axis=1,
                               tiled=True)
    shard = _lift_inv_axis(shard, 1)
    shard = _lift_inv_axis(shard, 2)
    return shard
