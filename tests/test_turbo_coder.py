"""Turbo (format v2) entropy coder: 8-lane interleaved rANS, coder id 1,
CODER_VERSION_TURBO=31600. Opt-in alternative to the reference-bit-exact
range coder — same layered stream structure, ~equal ratio, several times
the entropy-stage throughput. These tests pin round-trip correctness,
ratio parity, and header-driven dispatch across all three interfaces.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from waverange import native as wn
from waverange.core import codec


@pytest.mark.parametrize("n", [1, 7, 8, 9, 65535, 65536, 65537, 131072,
                               200001])
def test_plane_roundtrip(n):
    rng = np.random.default_rng(n)
    syms = np.clip(rng.normal(100, 9, n), 0, 255).astype(np.uint8)
    enc = wn.encode_plane(syms, coder=1)
    assert np.array_equal(wn.decode_plane(enc, n, coder=1), syms)


def test_constant_plane_two_bytes_per_block():
    # single-symbol blocks are tag 2 + the symbol: 2 bytes per block
    const = np.full(200000, 42, np.uint8)
    enc = wn.encode_plane(const, coder=1)
    nblocks = -(-200000 // 65536)
    assert len(enc) == nblocks * 2
    assert enc[:2] == b"\x02\x2a"


def test_incompressible_plane_raw_escape():
    rng = np.random.default_rng(0)
    syms = rng.integers(0, 256, 300000).astype(np.uint8)
    enc = wn.encode_plane(syms, coder=1)
    # near-uniform blocks take the raw escape: 1 tag byte + bs verbatim
    nblocks = -(-300000 // 65536)
    assert len(enc) == 300000 + nblocks
    assert np.array_equal(wn.decode_plane(enc, 300000, coder=1), syms)
    assert len(enc) < 300000 * 1.05  # bounded expansion on noise


def test_ratio_parity_with_range_coder():
    rng = np.random.default_rng(1)
    syms = np.clip(rng.normal(128, 20, 2_000_000), 0, 255).astype(np.uint8)
    l_range = len(wn.encode_plane(syms, coder=0))
    l_rans = len(wn.encode_plane(syms, coder=1))
    assert l_rans < l_range * 1.02  # within 2% of the range coder


def test_codec_roundtrip_and_version_dispatch():
    rng = np.random.default_rng(2)
    a = np.cumsum(rng.standard_normal((20, 24, 28)), axis=2)
    e = codec.encode_field(a, 1e-9, coder="rans")
    assert e.coder_version == codec.CODER_VERSION_TURBO
    r = codec.decode_field(e)  # dispatches on coder_version
    assert np.abs(r - a).max() <= 1.3e-9 * np.abs(a).max() * 3
    e0 = codec.encode_field(a, 1e-9)
    assert e0.coder_version == codec.CODER_VERSION
    assert abs(e.ntot_enc - e0.ntot_enc) < 0.05 * e0.ntot_enc


def test_unknown_version_rejected():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((8, 8, 8))
    e = codec.encode_field(a, 1e-6)
    e.coder_version = 99999
    with pytest.raises(ValueError, match="unsupported coder version"):
        codec.decode_field(e)


def test_generic_file_turbo_roundtrip(tmp_path):
    from waverange.io.generic import (FieldSpec, decode_generic_file,
                                      encode_generic_file)
    a = np.sin(np.arange(17 * 18 * 19) / 55.0).reshape(19, 18, 17) * 3.0
    raw = tmp_path / "in.raw"
    a.astype("<f8").tofile(raw)
    spec = FieldSpec(nbytes=8, nx=17, ny=18, nz=19, nh=1, idinv=0,
                     icomp=1, tol_base=1e-9)
    encode_generic_file(str(raw), str(tmp_path / "t.wrb"),
                        str(tmp_path / "t.wrh"), 2, False, [spec],
                        coder="rans", verbose=False)
    assert " Coder version: 31600" in (tmp_path / "t.wrh").read_text()
    decode_generic_file(str(tmp_path / "t.wrb"), str(tmp_path / "t.wrh"),
                        str(tmp_path / "t.out"), 2, False, verbose=False)
    r = np.fromfile(tmp_path / "t.out", "<f8").reshape(a.shape)
    assert np.abs(r - a).max() <= 1.3e-9 * np.abs(a).max() * 3


def test_cli_env_optin(tmp_path):
    a = (np.cos(np.arange(16 ** 3) / 100.0) * 2.0).reshape(16, 16, 16)
    raw = tmp_path / "c.raw"
    a.astype("<f8").tofile(raw)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, WR_CODER="rans",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    args = [sys.executable, "-m", "waverange.cli.wrenc", str(raw),
            str(tmp_path / "c.wrb"), str(tmp_path / "c.wrh"), "2", "0",
            "1", "2", "16", "16", "16", "1e-8"]
    subprocess.run(args, check=True, env=env, cwd=tmp_path,
                   capture_output=True)
    assert " Coder version: 31600" in (tmp_path / "c.wrh").read_text()
    args = [sys.executable, "-m", "waverange.cli.wrdec",
            str(tmp_path / "c.wrb"), str(tmp_path / "c.wrh"),
            str(tmp_path / "c.out"), "2", "0"]
    subprocess.run(args, check=True, cwd=tmp_path, env=env,
                   capture_output=True)
    r = np.fromfile(tmp_path / "c.out", "<f8").reshape(a.shape)
    assert np.abs(r - a).max() <= 1.3e-8 * np.abs(a).max() * 3


@pytest.mark.slow
def test_cli_env_backend_exact64(tmp_path):
    """WR_BACKEND=exact64 routes the CLI encode through the software-
    IEEE f64 device path; the emitted stream must be byte-identical to
    the native path's (exact64's core guarantee) and decode losslessly
    at the tolerance. slow: the CLI subprocess re-traces the softf64
    graphs (~4 min) — the in-process equivalents run in test_softf64."""
    a = (np.cos(np.arange(16 ** 3) / 100.0) * 2.0).reshape(16, 16, 16)
    raw = tmp_path / "x.raw"
    a.astype("<f8").tofile(raw)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache = os.path.join(repo, "build", "jax_cache_cpu")
    env = dict(os.environ, WR_BACKEND="exact64", WR_CODER="rans",
               JAX_COMPILATION_CACHE_DIR=cache,
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    args = [sys.executable, "-m", "waverange.cli.wrenc", str(raw),
            str(tmp_path / "x.wrb"), str(tmp_path / "x.wrh"), "2", "0",
            "1", "2", "16", "16", "16", "1e-8"]
    subprocess.run(args, check=True, env=env, cwd=tmp_path,
                   capture_output=True)
    # byte-identical to the native host pipeline with the same coder
    env2 = dict(env, WR_BACKEND="native")
    args2 = [sys.executable, "-m", "waverange.cli.wrenc", str(raw),
             str(tmp_path / "y.wrb"), str(tmp_path / "y.wrh"), "2", "0",
             "1", "2", "16", "16", "16", "1e-8"]
    subprocess.run(args2, check=True, env=env2, cwd=tmp_path,
                   capture_output=True)
    assert (tmp_path / "x.wrb").read_bytes() == \
        (tmp_path / "y.wrb").read_bytes()
    args = [sys.executable, "-m", "waverange.cli.wrdec",
            str(tmp_path / "x.wrb"), str(tmp_path / "x.wrh"),
            str(tmp_path / "x.out"), "2", "0"]
    subprocess.run(args, check=True, cwd=tmp_path, env=env,
                   capture_output=True)
    r = np.fromfile(tmp_path / "x.out", "<f8").reshape(a.shape)
    assert np.abs(r - a).max() <= 1.3e-8 * np.abs(a).max() * 3


def test_simd_streams_byte_identical_to_scalar():
    """The AVX-512 lane engine must produce byte-identical streams to the
    portable scalar loops (WR_NO_SIMD=1), and decode them interchangeably.
    Runs the scalar side in a subprocess because the dispatch decision is
    cached per process."""
    prog = r"""
import numpy as np, hashlib, sys
from waverange import native as wn
rng = np.random.default_rng(123)
hashes = []
for n in [8, 63, 65535, 65536, 65537, 200001]:
    for syms in [rng.integers(0, 256, n).astype(np.uint8),
                 (rng.exponential(2.0, n) % 256).astype(np.uint8),
                 np.full(n, 9, np.uint8)]:
        e = wn.encode_plane(syms, coder=1)
        assert np.array_equal(wn.decode_plane(e, n, coder=1), syms)
        hashes.append(hashlib.sha256(e).hexdigest())
print("\n".join(hashes))
"""
    def run(extra_env):
        env = dict(os.environ, **extra_env)
        r = subprocess.run([sys.executable, "-c", prog], env=env,
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        return r.stdout

    assert run({}) == run({"WR_NO_SIMD": "1"})
