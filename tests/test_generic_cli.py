"""Golden file-level tests: our wrenc/wrdec vs the reference binaries.

Byte-compares `.wrh` (text header), `.wrb` (encoded stream), and the
reconstructed data files, across file types (C raw, Fortran 4/8-byte
markers), dtypes, endian conversion, idinv, nh folding, icomp=0
passthrough, and both inmeta formats.
"""
import struct
import subprocess

import numpy as np
import pytest

from waverange.cli import wrenc, wrdec

from conftest import ORACLE, smooth_field


def run_ours_enc(args, cwd):
    import contextlib, os
    old = os.getcwd()
    os.chdir(cwd)
    try:
        wrenc.main([str(a) for a in args])
    finally:
        os.chdir(old)


def run_ours_dec(args, cwd):
    import os
    old = os.getcwd()
    os.chdir(cwd)
    try:
        wrdec.main([str(a) for a in args])
    finally:
        os.chdir(old)


def make_c_file(path, fields):
    with open(path, "wb") as f:
        for arr, nbytes in fields:
            f.write(np.asarray(arr).astype(
                np.float32 if nbytes == 4 else np.float64).tobytes())


def make_fortran_file(path, fields, mlen=4, bigendian=False):
    """Fortran sequential records: marker, payload, marker."""
    end = ">" if bigendian else "<"
    fmt = {4: end + "I", 8: end + "Q"}[mlen]
    with open(path, "wb") as f:
        for arr, nbytes in fields:
            a = np.asarray(arr).astype(
                np.dtype(f"{end}f{nbytes}"))
            payload = a.tobytes()
            f.write(struct.pack(fmt, len(payload)))
            f.write(payload)
            f.write(struct.pack(fmt, len(payload)))


@pytest.mark.parametrize("ifiletype", [0, 1, 2])
@pytest.mark.parametrize("nbytes", [4, 8])
def test_argv_roundtrip_vs_oracle(oracle, tmp_path, ifiletype, nbytes):
    shape = (16, 16, 16)
    a = smooth_field(shape)
    oracle_dir = tmp_path / "o"
    ours_dir = tmp_path / "m"
    oracle_dir.mkdir()
    ours_dir.mkdir()
    for d in (oracle_dir, ours_dir):
        if ifiletype == 2:
            make_c_file(d / "data.bin", [(a, nbytes)])
        else:
            make_fortran_file(d / "data.bin", [(a, nbytes)],
                              mlen=4 if ifiletype == 0 else 8)
    args = ["data.bin", "data.wrb", "data.wrh", str(ifiletype), "0", "1",
            "1" if nbytes == 4 else "2", "16", "16", "16", "1e-7"]
    subprocess.run([str(ORACLE / "wrenc"), *args], cwd=oracle_dir,
                   check=True, capture_output=True)
    run_ours_enc(args, ours_dir)
    assert (ours_dir / "data.wrh").read_text() == \
        (oracle_dir / "data.wrh").read_text()
    assert (ours_dir / "data.wrb").read_bytes() == \
        (oracle_dir / "data.wrb").read_bytes()

    dargs = ["data.wrb", "data.wrh", "datarec.bin", str(ifiletype), "0"]
    subprocess.run([str(ORACLE / "wrdec"), *dargs], cwd=oracle_dir,
                   check=True, capture_output=True)
    run_ours_dec(dargs, ours_dir)
    assert (ours_dir / "datarec.bin").read_bytes() == \
        (oracle_dir / "datarec.bin").read_bytes()
    # cross: our decoder on the oracle's files
    run_ours_dec(["data.wrb", "data.wrh", "datarec2.bin", str(ifiletype),
                  "0"], oracle_dir)
    assert (oracle_dir / "datarec2.bin").read_bytes() == \
        (oracle_dir / "datarec.bin").read_bytes()


def _write_inmeta_new(path, in_name, nf, fields_txt):
    txt = (f"&in_name = {in_name}\n&out_name = data.wrb\n"
           f"&header_name = data.wrh\n&file_type = 2\n"
           f"&endian_conversion = 0\n&number_of_field = {nf}\n"
           + fields_txt)
    path.write_text(txt)


def test_inmeta_new_heterogeneous_vs_oracle(oracle, tmp_path):
    """Multiple fields, mixed dtype/shape/icomp, new inmeta format."""
    rng = np.random.default_rng(4)
    f0 = smooth_field((8, 12, 16))
    f1 = (smooth_field((4, 4, 20)) + 0.01 * rng.standard_normal((4, 4, 20)))
    f2 = rng.standard_normal((2, 3, 4))  # uncompressed passthrough
    fields = [(f0, 8), (f1, 4), (f2, 8)]
    fields_txt = (
        "%field = 0\n&input_data_type = 2\n&nx = 16\n&ny = 12\n&nz = 8\n"
        "&nh = 1\n&order = 0\n&compress = 1\n&tolerance = 1e-8\n/\n"
        "%field = 1\n&input_data_type = 1\n&nx = 20\n&ny = 4\n&nz = 4\n"
        "&compress = 1\n&tolerance = 1e-4\n/\n"
        "%field = 2\n&input_data_type = 2\n&nx = 4\n&ny = 3\n&nz = 2\n"
        "&compress = 0\n/\n")
    for d in ("o", "m"):
        dd = tmp_path / d
        dd.mkdir()
        make_c_file(dd / "data.bin", fields)
        _write_inmeta_new(dd / "inmeta", "data.bin", 3, fields_txt)
    subprocess.run([str(ORACLE / "wrenc")], cwd=tmp_path / "o", check=True,
                   capture_output=True)
    run_ours_enc([], tmp_path / "m")
    assert (tmp_path / "m" / "data.wrh").read_text() == \
        (tmp_path / "o" / "data.wrh").read_text()
    assert (tmp_path / "m" / "data.wrb").read_bytes() == \
        (tmp_path / "o" / "data.wrb").read_bytes()
    dargs = ["data.wrb", "data.wrh", "datarec.bin", "2", "0"]
    subprocess.run([str(ORACLE / "wrdec"), *dargs], cwd=tmp_path / "o",
                   check=True, capture_output=True)
    run_ours_dec(dargs, tmp_path / "m")
    assert (tmp_path / "m" / "datarec.bin").read_bytes() == \
        (tmp_path / "o" / "datarec.bin").read_bytes()


def test_inmeta_old_format_vs_oracle(oracle, tmp_path):
    a = smooth_field((8, 8, 8))
    for d in ("o", "m"):
        dd = tmp_path / d
        dd.mkdir()
        make_c_file(dd / "data.bin", [(a, 8)])
        (dd / "inmeta").write_text(
            "data.bin\ndata.wrb\ndata.wrh\n2\n0\n1\n"
            "2\n8\n8\n8\n1\n0\n1\n1e-6\n")
    subprocess.run([str(ORACLE / "wrenc")], cwd=tmp_path / "o", check=True,
                   capture_output=True)
    run_ours_enc([], tmp_path / "m")
    assert (tmp_path / "m" / "data.wrh").read_text() == \
        (tmp_path / "o" / "data.wrh").read_text()
    assert (tmp_path / "m" / "data.wrb").read_bytes() == \
        (tmp_path / "o" / "data.wrb").read_bytes()


def test_endian_and_idinv_vs_oracle(oracle, tmp_path):
    """Big-endian Fortran input with dimension inversion and nh > 1."""
    nx, ny, nz, nh = 6, 5, 4, 3
    rng = np.random.default_rng(11)
    # idinv file order: (ix, iy, iz, ih) outer->inner
    data = rng.standard_normal((nx, ny, nz, nh))
    fields_txt = (
        f"%field = 0\n&input_data_type = 2\n&nx = {nx}\n&ny = {ny}\n"
        f"&nz = {nz}\n&nh = {nh}\n&order = 1\n&compress = 1\n"
        "&tolerance = 1e-5\n/\n")
    for d in ("o", "m"):
        dd = tmp_path / d
        dd.mkdir()
        make_fortran_file(dd / "data.bin", [(data, 8)], mlen=4,
                          bigendian=True)
        txt = ("&in_name = data.bin\n&out_name = data.wrb\n"
               "&header_name = data.wrh\n&file_type = 0\n"
               "&endian_conversion = 1\n&number_of_field = 1\n"
               + fields_txt)
        (dd / "inmeta").write_text(txt)
    subprocess.run([str(ORACLE / "wrenc")], cwd=tmp_path / "o", check=True,
                   capture_output=True)
    run_ours_enc([], tmp_path / "m")
    assert (tmp_path / "m" / "data.wrh").read_text() == \
        (tmp_path / "o" / "data.wrh").read_text()
    assert (tmp_path / "m" / "data.wrb").read_bytes() == \
        (tmp_path / "o" / "data.wrb").read_bytes()
    dargs = ["data.wrb", "data.wrh", "datarec.bin", "0", "1"]
    subprocess.run([str(ORACLE / "wrdec"), *dargs], cwd=tmp_path / "o",
                   check=True, capture_output=True)
    run_ours_dec(dargs, tmp_path / "m")
    assert (tmp_path / "m" / "datarec.bin").read_bytes() == \
        (tmp_path / "o" / "datarec.bin").read_bytes()


def test_trivial_and_multifield_argv(oracle, tmp_path):
    """Constant field (ntot_enc=0) among normal fields."""
    a = np.full((8, 8, 8), 7.5)
    b = smooth_field((8, 8, 8))
    for d in ("o", "m"):
        dd = tmp_path / d
        dd.mkdir()
        make_c_file(dd / "data.bin", [(a, 8), (b, 8)])
    args = ["data.bin", "data.wrb", "data.wrh", "2", "0", "2", "2",
            "8", "8", "8", "1e-6"]
    subprocess.run([str(ORACLE / "wrenc"), *args], cwd=tmp_path / "o",
                   check=True, capture_output=True)
    run_ours_enc(args, tmp_path / "m")
    assert (tmp_path / "m" / "data.wrh").read_text() == \
        (tmp_path / "o" / "data.wrh").read_text()
    assert (tmp_path / "m" / "data.wrb").read_bytes() == \
        (tmp_path / "o" / "data.wrb").read_bytes()
    dargs = ["data.wrb", "data.wrh", "datarec.bin", "2", "0"]
    subprocess.run([str(ORACLE / "wrdec"), *dargs], cwd=tmp_path / "o",
                   check=True, capture_output=True)
    run_ours_dec(dargs, tmp_path / "m")
    assert (tmp_path / "m" / "datarec.bin").read_bytes() == \
        (tmp_path / "o" / "datarec.bin").read_bytes()
