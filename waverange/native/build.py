"""Build the wr_native shared library on demand.

The library is compiled once per source hash into
``waverange/native/_build/libwrnative-<hash>.so`` and reused. No pip
packages required — plain g++ with pinned, FP-deterministic flags.

FP flags matter: the f64 wavelet must match the reference binary bit for
bit, so FMA contraction is disabled (-ffp-contract=off). The entropy-coder
integer code is unaffected by FP flags.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

_SRC = Path(__file__).parent / "src" / "wr_native.cc"
_BUILD_DIR = Path(__file__).parent / "_build"

CXX = os.environ.get("WR_CXX", "g++")
CXXFLAGS = [
    "-O3",
    "-std=c++17",
    "-fPIC",
    "-shared",
    "-pthread",
    "-march=native",
    # Bit-exactness contract: the codec's normative FP semantics are the
    # ISO-conforming build of the reference (-ffp-contract=off). gcc's
    # default contract=fast makes position-dependent FMA choices that vary
    # with vectorization context, so no two builds agree; contract=off is
    # the only well-defined target, and both the oracle and this library
    # pin it.
    os.environ.get("WR_FP_CONTRACT", "-ffp-contract=off"),
    "-fno-math-errno",
]


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(_SRC.read_bytes())
    h.update(" ".join([CXX] + CXXFLAGS).encode())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return _BUILD_DIR / f"libwrnative-{_source_hash()}.so"


def ensure_built(verbose: bool = False) -> Path:
    out = lib_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # per-process temporary: concurrent first imports (test workers)
    # each build their own and the atomic rename keeps one
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [CXX, *CXXFLAGS, "-o", str(tmp), str(_SRC)]
    if verbose:
        print("building wr_native:", " ".join(cmd))
    subprocess.run(cmd, check=True, capture_output=not verbose)
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(ensure_built(verbose=True))
