"""Codec orchestration: field-level encode/decode with pluggable backends.

Backends:
  * "native" — the C++ host pipeline. Bit-exact to the reference library
    (ISO FP build; see tools/oracle/build_oracle.sh). The conformance
    path, and the fastest single-field CPU path.
  * "jax"    — device path: wavelet + byte-layer quantization on the
    default JAX device (plain XLA), entropy stage on the host (C++
    threads) or, for the v2 format, on the device. Streams are
    format-identical and tolerance-exact; on a GPU they are
    byte-identical to the native path's, on the CPU backend except at
    round-off-limited tolerances (see DEVICE_F64_REL_FLOOR).
  * "auto"   — "jax" on a GPU, "native" on the CPU (device.platform()).

Contract reference: encoding_wrap/decoding_wrap
(/root/reference/src/core/wrappers.cpp:228-527, wrappers.h:53-75).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .. import native as wn
from ..device import platform, require_x64

NLAYMAX = 8
WAV_LVL = 4
CODER_VERSION = 31503        # reference-bit-exact range-coder format
CODER_VERSION_TURBO = 31600  # v2 interleaved-rANS format (opt-in)

_CODER_IDS = {"range": 0, "rans": 1, "turbo": 1}
_VERSION_BY_ID = {0: CODER_VERSION, 1: CODER_VERSION_TURBO}
_ID_BY_VERSION = {CODER_VERSION: 0, CODER_VERSION_TURBO: 1}


def coder_id(coder) -> int:
    """Resolve a coder name ("range" | "rans"/"turbo") or id to 0/1."""
    if isinstance(coder, str):
        return _CODER_IDS[coder]
    return int(coder)


def coder_id_for_version(version: int) -> int:
    if version not in _ID_BY_VERSION:
        raise ValueError(f"unsupported coder version {version}")
    return _ID_BY_VERSION[version]


@dataclass
class EncodedField:
    """Codec metadata + payload for one field (mirrors the reference's
    per-field header record; gen_aux.cpp:505-556)."""
    nx: int
    ny: int
    nz: int
    tolabs: float
    midval: float
    halfspanval: float
    wlev: int
    nlay: int
    ntot_enc: int
    deps_vec: np.ndarray       # (8,) f64
    minval_vec: np.ndarray     # (8,) f64
    len_enc_vec: np.ndarray    # (8,) u64
    data: bytes = b""
    coder_version: int = CODER_VERSION

    @property
    def shape_zyx(self) -> Tuple[int, int, int]:
        return (self.nz, self.ny, self.nx)


# Relative-error floors of the device path: below them its result would
# break the error contract, so `conformance="strict"` refuses the request
# and "route" sends it to a conforming backend. f64 is per platform. The
# GPU's is 0: on an NVIDIA H100 XLA emits no FMA in the lifting fusions,
# and the 512^3 device stream is byte-identical to the native path's at
# every tolerance from 1e-5 to 1e-16 (chip_smoke.py; PERF.md). The CPU
# backend contracts multiply-adds, which flips a few round-off-limited
# symbols but leaves the error on the native path's scale. No platform
# has a non-zero f64 floor today; the table keeps the floor per platform
# (read through device.platform()) so that one measured on a device
# sits beside that device's name. f32 (precision="native") floors at a
# few ulp of 2^-24 on any platform.
DEVICE_F64_REL_FLOOR = {"cpu": 0.0, "gpu": 0.0}
DEVICE_F32_REL_FLOOR = 1e-6


def _resolve_backend(backend: str) -> str:
    if backend != "auto":
        return backend
    return "jax" if platform() == "gpu" else "native"


def _device_floor(precision: str) -> float:
    if precision == "native":
        return DEVICE_F32_REL_FLOOR
    return DEVICE_F64_REL_FLOOR[platform()]


def _check_conformance(backend: str, precision: str, tolrel: float,
                       conformance: str) -> None:
    """Refuse device paths whose error floor exceeds the requested
    tolerance (the error contract is err <= ~1.2 * tolrel * max|fld|,
    doc/cfdproc2017.pdf p.2 Fig.3)."""
    if conformance not in ("strict", "degraded", "route"):
        raise ValueError("conformance must be 'strict', 'degraded' or "
                         "'route'")
    if conformance == "degraded" or backend != "jax":
        return
    floor = _device_floor(precision)
    if tolrel < floor:
        raise ValueError(
            f"tolerance {tolrel:g} is below the device path's error floor "
            f"({floor:g} relative) on this device — the result would "
            "violate the codec's error contract. Use backend='exact64' "
            "(bit-exact integer-emulated f64 on device), "
            "backend='native' (host C++), or pass "
            "conformance='degraded' to accept the floor.")


def encode_field(fld: np.ndarray, tolrel: float, wtflag: int = 1,
                 cutoff: Optional[np.ndarray] = None,
                 mx: int = 1, my: int = 1, mz: int = 1,
                 backend: str = "native",
                 precision: str = "f64",
                 coder: str = "range",
                 entropy: str = "host",
                 conformance: str = "strict") -> EncodedField:
    """Encode one (nz, ny, nx) field (f64 array or castable).

    `tolrel` is the relative tolerance; `cutoff` optionally provides the
    (mx, my, mz) local-cutoff block tolerances (reference wrappers.h:39-42;
    effectively uniform — see SURVEY.md §2 ind_p2w_3d quirk).

    `precision`: "f64" (reference semantics — f32 inputs are widened, as
    the reference always does) or "native": keep f32 inputs in f32. On
    the jax backend the whole device step runs in f32; on the native
    backend a templated f32 C++ pipeline runs at
    half the memory bandwidth of the widened path. Tolerance-exact at
    f32 resolution (tol >= ~1e-6); the stream stays format-compatible
    (metadata is stored as f64) and is decodable by the f64 decoders.

    `coder`: "range" (default, reference-bit-exact bitstream,
    CODER_VERSION 31503) or "rans"/"turbo" (format v2, CODER_VERSION
    31600: 8-lane interleaved rANS — same layered structure and ~equal
    ratio at several times the entropy-stage throughput; NOT readable by
    the reference tools).

    `entropy`: "host" (C++ threads) or "device" (jax backend + rans
    coder only): the entropy stage runs on the accelerator too, so the
    whole encode is on-chip and only compressed bytes cross PCIe.

    `backend="exact64"`: IEEE binary64 emulated in u32 integer ops on the
    device (core/exact64) — bit-identical streams to the native path on
    any device, at correctness-path throughput. Uniform cutoff only.

    `conformance`: "strict" (default) refuses device paths whose dtype
    error floor exceeds `tolrel` (raising with the conforming
    alternatives); "route" silently falls back to a conforming backend
    instead (exact64 when entropy='device' so the encode stays on-chip,
    the native C++ pipeline otherwise); "degraded" permits the
    non-conforming path.
    """
    backend = _resolve_backend(backend)
    cid = coder_id(coder)
    if entropy == "device" and (backend not in ("jax", "exact64")
                                or cid != 1):
        raise ValueError("entropy='device' requires backend='jax'/"
                         "'exact64' and coder='rans' (the v2 format is the "
                         "lane-parallel one; the v1 range coder is "
                         "sequential)")
    if conformance == "route":
        try:
            _check_conformance(backend, precision, tolrel, "strict")
        except ValueError:
            backend = "exact64" if entropy == "device" else "native"
            # The host f32 pipeline shares the ~1e-6 floor strict just
            # refused; the routed fallback must be the widened f64 path.
            precision = "f64"
    else:
        _check_conformance(backend, precision, tolrel, conformance)
    nz, ny, nx = fld.shape
    if cutoff is None:
        cutoff = np.array([tolrel], dtype=np.float64)
    from ..utils import timed
    if backend == "exact64":
        if not (mx == my == mz == 1):
            raise ValueError("backend='exact64' supports the uniform "
                             "cutoff only (mx=my=mz=1); the local-cutoff "
                             "branch is the native f64 pipeline's")
        from .exact64 import encode_field_exact64
        with timed("encode.exact64"):
            meta = encode_field_exact64(np.asarray(fld, np.float64),
                                        tolrel, wtflag=wtflag, coder=cid,
                                        entropy=entropy)
    elif backend == "jax":
        with timed("encode.jax"):
            meta = _encode_jax(fld, tolrel, wtflag=wtflag,
                               keep_dtype=(precision == "native"),
                               coder=cid, entropy=entropy)
    elif precision == "native" and fld.dtype == np.float32:
        with timed("encode.native.f32"):
            meta = wn.encode_field_f32(fld, tolrel, wtflag=wtflag,
                                       coder=cid, cutoff=cutoff,
                                       mx=mx, my=my, mz=mz)
    else:
        with timed("encode.native"):
            meta = wn.encode_field(np.asarray(fld, np.float64),
                                   wtflag=wtflag, cutoff=cutoff, mx=mx,
                                   my=my, mz=mz, coder=cid)
    return EncodedField(
        nx=nx, ny=ny, nz=nz, tolabs=meta["tolabs"], midval=meta["midval"],
        halfspanval=meta["halfspanval"], wlev=meta["wlev"],
        nlay=meta["nlay"], ntot_enc=meta["ntot_enc"],
        deps_vec=np.asarray(meta["deps_vec"], np.float64),
        minval_vec=np.asarray(meta["minval_vec"], np.float64),
        len_enc_vec=np.asarray(meta["len_enc_vec"], np.uint64),
        data=meta["data"], coder_version=_VERSION_BY_ID[cid])


def decode_field(enc: EncodedField, backend: str = "native",
                 entropy: str = "host") -> np.ndarray:
    """Decode to an (nz, ny, nx) f64 array. The entropy coder is chosen
    by the stream's coder_version (31503 range / 31600 turbo rANS).
    `entropy="device"` (jax backend, turbo streams only) runs the entropy
    stage on the accelerator: only compressed bytes cross PCIe."""
    backend = _resolve_backend(backend)
    cid = coder_id_for_version(enc.coder_version)
    if entropy == "device" and (backend not in ("jax", "exact64")
                                or cid != 1):
        raise ValueError("entropy='device' requires backend='jax'/"
                         "'exact64' and a turbo (v2) stream")
    meta = dict(tolabs=enc.tolabs, midval=enc.midval,
                halfspanval=enc.halfspanval, wlev=enc.wlev, nlay=enc.nlay,
                ntot_enc=enc.ntot_enc, deps_vec=enc.deps_vec,
                minval_vec=enc.minval_vec, len_enc_vec=enc.len_enc_vec,
                data=enc.data)
    from ..utils import timed
    if backend == "exact64":
        from .exact64 import decode_field_exact64
        with timed("decode.exact64"):
            return decode_field_exact64(meta, enc.shape_zyx, coder=cid,
                                        entropy=entropy)
    if backend == "jax":
        with timed("decode.jax"):
            return _decode_jax(meta, enc.shape_zyx, coder=cid,
                               entropy=entropy)
    with timed("decode.native"):
        return wn.decode_field(meta, enc.shape_zyx, coder=cid)


# ---------------------------------------------------------------------------
# JAX device path
# ---------------------------------------------------------------------------

def _encode_jax(fld: np.ndarray, tolrel: float, wtflag: int = 1,
                keep_dtype: bool = False, coder: int = 0,
                entropy: str = "host") -> dict:
    import jax.numpy as jnp
    from ..ops.quant import encode_step

    if keep_dtype and fld.dtype == np.float32:
        arr = jnp.asarray(fld)
    else:
        require_x64()
        arr = jnp.asarray(np.asarray(fld, np.float64))
    planes, deps, minv, nlay, tolabs, midval, halfspanval, trivial = (
        encode_step(arr, jnp.asarray(tolrel, arr.dtype),
                    wtflag=bool(wtflag)))
    trivial = bool(trivial)
    midval_f = float(midval)
    halfspan_f = float(halfspanval)
    if trivial:
        return dict(tolabs=0.0, midval=midval_f, halfspanval=halfspan_f,
                    wlev=0, nlay=0, ntot_enc=0,
                    deps_vec=np.zeros(NLAYMAX), minval_vec=np.zeros(NLAYMAX),
                    len_enc_vec=np.zeros(NLAYMAX, np.uint64), data=b"")
    nlay_i = int(nlay)
    if entropy == "device":
        from ..ops import rans
        streams = rans.encode_planes_device(planes[:nlay_i],
                                            planes.shape[1])
        payload = b"".join(streams)
        lens = np.array([len(s) for s in streams], np.uint64)
    else:
        planes_np = np.asarray(planes[:nlay_i])  # (nlay, ntot) uint8
        payload, lens = wn.encode_planes_batch(planes_np, coder=coder)
    deps_vec = np.zeros(NLAYMAX)
    minv_vec = np.zeros(NLAYMAX)
    len_vec = np.zeros(NLAYMAX, np.uint64)
    deps_vec[:nlay_i] = np.asarray(deps[:nlay_i])
    minv_vec[:nlay_i] = np.asarray(minv[:nlay_i])
    len_vec[:nlay_i] = lens
    return dict(tolabs=float(tolabs), midval=midval_f,
                halfspanval=halfspan_f, wlev=WAV_LVL if wtflag else 0,
                nlay=nlay_i,
                ntot_enc=len(payload), deps_vec=deps_vec,
                minval_vec=minv_vec, len_enc_vec=len_vec, data=payload)


def _decode_jax(meta: dict, shape, coder: int = 0,
                entropy: str = "host") -> np.ndarray:
    import jax.numpy as jnp
    from ..ops.quant import decode_step

    nz, ny, nx = shape
    n = nz * ny * nx
    if meta["ntot_enc"] == 0:
        return np.full(shape, meta["midval"])
    require_x64()
    nlay = int(meta["nlay"])
    if entropy == "device":
        from ..ops import rans
        offs = np.concatenate(
            [[0], np.cumsum(meta["len_enc_vec"][:nlay])]).astype(int)
        layers = [bytes(meta["data"][offs[i]:offs[i + 1]])
                  for i in range(nlay)]
        planes = rans.decode_planes_device(layers, n)  # stays in HBM
    else:
        planes = jnp.asarray(wn.decode_planes_batch(
            meta["data"], meta["len_enc_vec"][:nlay], n, coder=coder))
    out = decode_step(planes,
                      jnp.asarray(meta["deps_vec"][:nlay]),
                      jnp.asarray(meta["minval_vec"][:nlay]),
                      shape=(nz, ny, nx), levels=int(meta["wlev"]))
    return np.asarray(out)
