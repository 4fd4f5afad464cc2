"""Build the drop-in `libwaverange.so` + headers.

Produces the reference-compatible library products (reference
Makefile:40-41, src/core/Makefile:7-23): a shared library exporting
encoding_wrap/decoding_wrap/setup_wr and the Fortran `_f` shims, plus a
C/C++ header. Existing users of the reference libwaverange relink
against this without source changes.
"""
from __future__ import annotations

import shutil
from pathlib import Path

from .build import ensure_built

HEADER = """\
/* waverange.h — C/C++ interface of libwaverange (waverange build).
   Drop-in compatible with the reference wrappers.h (see that file for
   full parameter documentation). */
#ifndef WAVERANGE_WAVERANGE_H
#define WAVERANGE_WAVERANGE_H

#ifdef __cplusplus
extern "C" {
void encoding_wrap(int nx, int ny, int nz, double *fld_1d, int wtflag,
                   int mx, int my, int mz, double *cutoffvec,
                   double &tolabs, double &midval, double &halfspanval,
                   unsigned char &wlev, unsigned char &nlay,
                   unsigned long int &ntot_enc, double *deps_vec,
                   double *minval_vec, unsigned long int *len_enc_vec,
                   unsigned char *data_enc);
void decoding_wrap(int nx, int ny, int nz, double *fld_1d, double &tolabs,
                   double &midval, double &halfspanval,
                   unsigned char &wlev, unsigned char &nlay,
                   unsigned long int &ntot_enc, double *deps_vec,
                   double *minval_vec, unsigned long int *len_enc_vec,
                   unsigned char *data_enc);
void setup_wr(int nx, int ny, int nz, unsigned char &nlaymax,
              unsigned long int &ntot_enc_max);
}
#else
/* C callers: reference parameters are pointers at the ABI level */
void encoding_wrap(int nx, int ny, int nz, double *fld_1d, int wtflag,
                   int mx, int my, int mz, double *cutoffvec,
                   double *tolabs, double *midval, double *halfspanval,
                   unsigned char *wlev, unsigned char *nlay,
                   unsigned long int *ntot_enc, double *deps_vec,
                   double *minval_vec, unsigned long int *len_enc_vec,
                   unsigned char *data_enc);
void decoding_wrap(int nx, int ny, int nz, double *fld_1d, double *tolabs,
                   double *midval, double *halfspanval,
                   unsigned char *wlev, unsigned char *nlay,
                   unsigned long int *ntot_enc, double *deps_vec,
                   double *minval_vec, unsigned long int *len_enc_vec,
                   unsigned char *data_enc);
void setup_wr(int nx, int ny, int nz, unsigned char *nlaymax,
              unsigned long int *ntot_enc_max);
#endif

#endif /* WAVERANGE_WAVERANGE_H */
"""


def build_libwaverange(dest_dir: str | Path = None) -> Path:
    """Build and install shared + static lib and header; returns the lib
    directory (reference products: libwaverange.{a,so} + wrappers.h)."""
    import subprocess

    root = Path(dest_dir) if dest_dir else \
        Path(__file__).resolve().parents[2] / "build"
    libdir = root / "lib"
    incdir = root / "include"
    libdir.mkdir(parents=True, exist_ok=True)
    incdir.mkdir(parents=True, exist_ok=True)
    so = ensure_built()
    shutil.copyfile(so, libdir / "libwaverange.so")
    # static archive from a non-PIC-agnostic object build
    from .build import CXX, CXXFLAGS, _SRC
    obj = libdir / "wr_native.o"
    flags = [f for f in CXXFLAGS if f != "-shared"]
    subprocess.run([CXX, *flags, "-c", "-o", str(obj), str(_SRC)],
                   check=True, capture_output=True)
    ar = libdir / "libwaverange.a"
    if ar.exists():
        ar.unlink()
    subprocess.run(["ar", "rcs", str(ar), str(obj)], check=True,
                   capture_output=True)
    obj.unlink()
    (incdir / "waverange.h").write_text(HEADER)
    return libdir


if __name__ == "__main__":
    print(build_libwaverange())
