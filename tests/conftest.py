"""Test configuration.

JAX tests run on the CPU backend with 8 virtual devices (the sharded
paths' semantics are the same on a GPU mesh; chip_smoke.py runs them on
the card). x64 is enabled because the codec's normative arithmetic is
f64, and the compile cache follows the program's own rule
(waverange.device.configure_jax).
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")

from waverange.device import configure_jax  # noqa: E402

configure_jax()

import subprocess
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
ORACLE = REPO / "build" / "oracle"
TMP = REPO / "build" / "tmp"


def _have_oracle() -> bool:
    return (ORACLE / "dump_harness").exists()


def build_oracle():
    subprocess.run([str(REPO / "tools" / "oracle" / "build_oracle.sh")],
                   check=True, capture_output=True)


@pytest.fixture(scope="session")
def oracle():
    """Reference-built binaries (ISO FP semantics). Skips if unbuildable."""
    if not _have_oracle():
        try:
            build_oracle()
        except Exception as e:  # pragma: no cover
            pytest.skip(f"reference oracle unavailable: {e}")
    TMP.mkdir(parents=True, exist_ok=True)
    return OracleHarness()


class OracleHarness:
    """Wraps the dump_harness binary around the reference library."""

    def __init__(self):
        self.exe = str(ORACLE / "dump_harness")
        self.tmp = TMP

    def wavelet(self, a: np.ndarray, lvl: int) -> np.ndarray:
        nz, ny, nx = a.shape
        fin = self.tmp / "o_in.f64"
        fout = self.tmp / "o_out.f64"
        np.ascontiguousarray(a, np.float64).tofile(fin)
        subprocess.run([self.exe, "wavelet", str(nx), str(ny), str(nz),
                        str(lvl), str(fin), str(fout)], check=True,
                       capture_output=True)
        return np.fromfile(fout, dtype=np.float64).reshape(a.shape)

    def p2w(self, lvl, nx, ny, nz, i1, i2, i3):
        r = subprocess.run([self.exe, "p2w", str(lvl), str(nx), str(ny),
                            str(nz), str(i1), str(i2), str(i3)], check=True,
                           capture_output=True, text=True)
        return tuple(int(x) for x in r.stdout.split())

    def encode(self, a: np.ndarray, wtflag: int, tolrel: float) -> dict:
        import struct
        nz, ny, nx = a.shape
        fin = self.tmp / "o_in.f64"
        fout = self.tmp / "o_enc.bin"
        np.ascontiguousarray(a, np.float64).tofile(fin)
        subprocess.run([self.exe, "encode", str(nx), str(ny), str(nz),
                        str(wtflag), repr(tolrel), str(fin), str(fout)],
                       check=True, capture_output=True)
        raw = Path(fout).read_bytes()
        tolabs, midval, hsv = struct.unpack("<3d", raw[:24])
        wlev, nlay = raw[24], raw[25]
        (ne,) = struct.unpack("<Q", raw[26:34])
        return dict(
            tolabs=tolabs, midval=midval, halfspanval=hsv, wlev=wlev,
            nlay=nlay, ntot_enc=ne,
            deps_vec=np.frombuffer(raw[34:98]).copy(),
            minval_vec=np.frombuffer(raw[98:162]).copy(),
            len_enc_vec=np.frombuffer(raw[162:226], dtype=np.uint64).copy(),
            data=raw[226:226 + ne])

    def encode_masked(self, a: np.ndarray, wtflag: int, mx: int, my: int,
                      mz: int, cutoffs) -> dict:
        """encoding_wrap with a non-uniform (mx,my,mz) cutoff grid."""
        import struct
        nz, ny, nx = a.shape
        fin = self.tmp / "o_in.f64"
        fout = self.tmp / "o_enc.bin"
        np.ascontiguousarray(a, np.float64).tofile(fin)
        args = [self.exe, "encodem", str(nx), str(ny), str(nz),
                str(wtflag), str(mx), str(my), str(mz), str(fin),
                str(fout)] + [repr(float(c)) for c in cutoffs]
        subprocess.run(args, check=True, capture_output=True)
        raw = Path(fout).read_bytes()
        tolabs, midval, hsv = struct.unpack("<3d", raw[:24])
        wlev, nlay = raw[24], raw[25]
        (ne,) = struct.unpack("<Q", raw[26:34])
        return dict(
            tolabs=tolabs, midval=midval, halfspanval=hsv, wlev=wlev,
            nlay=nlay, ntot_enc=ne,
            deps_vec=np.frombuffer(raw[34:98]).copy(),
            minval_vec=np.frombuffer(raw[98:162]).copy(),
            len_enc_vec=np.frombuffer(raw[162:226], dtype=np.uint64).copy(),
            data=raw[226:226 + ne])

    def decode(self, meta: dict, shape) -> np.ndarray:
        import struct
        nz, ny, nx = shape
        fenc = self.tmp / "o_enc_in.bin"
        fdec = self.tmp / "o_dec.f64"
        raw = (struct.pack("<3d", meta["tolabs"], meta["midval"],
                           meta["halfspanval"])
               + bytes([meta["wlev"], meta["nlay"]])
               + struct.pack("<Q", meta["ntot_enc"])
               + np.asarray(meta["deps_vec"], np.float64).tobytes()
               + np.asarray(meta["minval_vec"], np.float64).tobytes()
               + np.asarray(meta["len_enc_vec"], np.uint64).tobytes()
               + meta["data"])
        fenc.write_bytes(raw)
        subprocess.run([self.exe, "decode", str(nx), str(ny), str(nz),
                        str(fenc), str(fdec)], check=True, capture_output=True)
        return np.fromfile(fdec, dtype=np.float64).reshape(shape)

    def wrenc_generic(self, args, cwd):
        return subprocess.run([str(ORACLE / "wrenc"), *args], cwd=cwd,
                              check=True, capture_output=True, text=True)

    def wrdec_generic(self, args, cwd):
        return subprocess.run([str(ORACLE / "wrdec"), *args], cwd=cwd,
                              check=True, capture_output=True, text=True)


def smooth_field(shape, rng=None, noise=0.0):
    """A compressible analytic test field (+ optional noise)."""
    nz, ny, nx = shape
    a = np.fromfunction(
        lambda k, j, i: 10 * np.sin(i / 7.3) * np.sin(j / 5.1) ** 2
        * np.cos(k / 9.7)
        + 0.3 * np.exp(-((i - nx / 2) ** 2 + (j - ny / 2) ** 2
                         + (k - nz / 2) ** 2) / (nx * 0.2 + 1) ** 2),
        shape)
    if noise and rng is not None:
        a = a + noise * rng.standard_normal(shape)
    return a
