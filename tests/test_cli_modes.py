"""CLI mode coverage: magic-div self-test, stdin-driven (outmeta-style)
decode, and interactive encode — compared against the oracle binaries,
which are driven through the same stdin protocol."""
import ctypes as ct
import pytest
import subprocess

import numpy as np

from waverange.native.build import ensure_built

from conftest import ORACLE, smooth_field
from test_generic_cli import make_c_file


def test_magicdiv_selftest():
    lib = ct.CDLL(str(ensure_built()))
    assert lib.wrn_selftest_magicdiv() == 0


def test_stdin_decode_matches_oracle(oracle, tmp_path):
    """wrdec fed via stdin (the reference examples' `wrdec < outmeta`)."""
    a = smooth_field((12, 10, 8))
    for d in ("o", "m"):
        dd = tmp_path / d
        dd.mkdir()
        make_c_file(dd / "data.bin", [(a, 8)])
    args = ["data.bin", "data.wrb", "data.wrh", "2", "0", "1", "2",
            "8", "10", "12", "1e-6"]
    subprocess.run([str(ORACLE / "wrenc"), *args], cwd=tmp_path / "o",
                   check=True, capture_output=True)
    import os
    import sys
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(ORACLE.parent.parent) + ":"
                         + env.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-m", "waverange.cli.wrenc",
                    *args], cwd=tmp_path / "m", check=True,
                   capture_output=True, env=env)
    outmeta = "data.wrb\ndata.wrh\ndatarec.bin\n2\n0\n"
    subprocess.run([str(ORACLE / "wrdec")], cwd=tmp_path / "o",
                   input=outmeta, text=True, check=True,
                   capture_output=True)
    subprocess.run([sys.executable, "-m", "waverange.cli.wrdec"],
                   cwd=tmp_path / "m", input=outmeta, text=True,
                   check=True, capture_output=True, env=env)
    assert (tmp_path / "m" / "datarec.bin").read_bytes() == \
        (tmp_path / "o" / "datarec.bin").read_bytes()


def test_header_field_mismatch_raises(tmp_path):
    """Decoder errors out when the header's field id doesn't match
    (reference throws std::exception — gen_aux.cpp:567)."""
    import shutil
    from pathlib import Path
    from waverange.io.generic import decode_generic_file
    G = Path(__file__).parent / "golden"
    wrh = (G / "data.wrh").read_text()
    # corrupt the per-field id line (first line after the ' -----' marker)
    lines = wrh.splitlines()
    idx = lines.index(" -----") + 1
    lines[idx] = "7"
    (tmp_path / "bad.wrh").write_text("\n".join(lines) + "\n")
    shutil.copy(G / "data.wrb", tmp_path / "data.wrb")
    with pytest.raises(ValueError, match="header"):
        decode_generic_file(str(tmp_path / "data.wrb"),
                            str(tmp_path / "bad.wrh"),
                            str(tmp_path / "out.bin"), 2, False,
                            verbose=False)


def test_truncated_payload_raises(tmp_path):
    import shutil
    from pathlib import Path
    from waverange.io.generic import decode_generic_file
    G = Path(__file__).parent / "golden"
    shutil.copy(G / "data.wrh", tmp_path / "data.wrh")
    (tmp_path / "data.wrb").write_bytes(
        (G / "data.wrb").read_bytes()[:100])
    with pytest.raises(Exception):
        decode_generic_file(str(tmp_path / "data.wrb"),
                            str(tmp_path / "data.wrh"),
                            str(tmp_path / "out.bin"), 2, False,
                            verbose=False)


# ---------------------------------------------------------------------------
# MSSG inmeta + stdin config modes vs the oracle binaries
# (reference parsers: mssg_enc.cpp:106-232, mssg_dec.cpp:96-140)
# ---------------------------------------------------------------------------

MSSG_INMETA_NEW = (
    "&prefix_name = ocean\n"
    "&EXT_NAME = .enc\n"          # case-insensitive keys (std::transform)
    "&file_type = 0\n"
    "&input_data_type = 1\n"
    "&endian_conversion = 1\n"
    "&tolerance = 1e-4\n"
    "&id_of_proc = 0\n"
    "comment line without ampersand is ignored\n")
MSSG_INMETA_OLD = "ocean\n.enc\n0\n1\n1\n1e-4\n0\n"
# stdin with empty answers exercising the defaults (ext .enc, endian 1,
# procid 0 — mssg_enc.cpp:70-102 initializers)
MSSG_STDIN = "ocean\n\n0\n1\n\n1e-4\n\n"


@pytest.mark.parametrize("mode", ["new", "old", "stdin"])
def test_mssg_enc_config_modes_vs_oracle(oracle, tmp_path, mode):
    import os
    import sys
    from test_mssg import make_regular
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(ORACLE.parent.parent) + ":"
                         + env.get("PYTHONPATH", ""))
    for d in ("o", "m"):
        dd = tmp_path / d
        dd.mkdir()
        make_regular(dd)
        if mode == "new":
            (dd / "inmeta").write_text(MSSG_INMETA_NEW)
        elif mode == "old":
            (dd / "inmeta").write_text(MSSG_INMETA_OLD)
    stdin = MSSG_STDIN if mode == "stdin" else ""
    subprocess.run([str(ORACLE / "wrmssgenc")], cwd=tmp_path / "o",
                   input=stdin, text=True, check=True, capture_output=True)
    subprocess.run([sys.executable, "-m", "waverange.cli.mssg_enc"],
                   cwd=tmp_path / "m", input=stdin, text=True, check=True,
                   capture_output=True, env=env)
    # stdin mode leaves the extension EMPTY (getline clobbers the .enc
    # initializer — mssg_enc.cpp:102/218): files are ocean_h / ocean_f.
    ext = "" if mode == "stdin" else ".enc"
    for f in (f"ocean_h{ext}", f"ocean_f{ext}"):
        assert (tmp_path / "m" / f).read_bytes() == \
            (tmp_path / "o" / f).read_bytes(), (mode, f)
    if mode == "stdin":
        # empty-ext streams decode via argv mode (the reference decoder's
        # stdin path aborts on empty ext: mssg_dec.cpp:96 never applies
        # the advertised default)
        dargs = ["ocean", "", "oceanrec", "0", "1", "1", "0"]
        subprocess.run([str(ORACLE / "wrmssgdec"), *dargs],
                       cwd=tmp_path / "o", check=True, capture_output=True)
        subprocess.run([sys.executable, "-m", "waverange.cli.mssg_dec",
                        *dargs], cwd=tmp_path / "m", check=True,
                       capture_output=True, env=env)
    else:
        # decode side has no inmeta mode in the reference: stdin only.
        # endian must be explicit (uninitialized in the reference: UB
        # on ""); empty data-type answer = float (iouttype=1 initializer
        # despite the [2] prompt — mssg_dec.cpp:92).
        dec_stdin = "ocean\n.enc\noceanrec\n0\n\n1\n0\n"
        subprocess.run([str(ORACLE / "wrmssgdec")], cwd=tmp_path / "o",
                       input=dec_stdin, text=True, check=True,
                       capture_output=True)
        subprocess.run([sys.executable, "-m", "waverange.cli.mssg_dec"],
                       cwd=tmp_path / "m", input=dec_stdin, text=True,
                       check=True, capture_output=True, env=env)
    for f in ("oceanrec.grd", "oceanrec.ctl"):
        assert (tmp_path / "m" / f).read_bytes() == \
            (tmp_path / "o" / f).read_bytes(), (mode, f)


# ---------------------------------------------------------------------------
# FluSI inmeta + stdin config modes vs the shim-built oracle binaries
# (reference parsers: main_enc.cpp:95-191, main_dec.cpp:80-110)
# ---------------------------------------------------------------------------

FLUSI_INMETA_NEW = ("&in_name = in.h5\n&OUT_NAME = enc.h5\n"
                    "&file_type = 0\n&tolerance = 1e-5\n")
FLUSI_INMETA_OLD = "in.h5\nenc.h5\n0\n1e-5\n"
FLUSI_STDIN = "in.h5\nenc.h5\n\n1e-5\n"  # empty type -> default 0


@pytest.mark.parametrize("mode", ["new", "old", "stdin"])
def test_flusi_enc_config_modes_vs_oracle(tmp_path, mode):
    import os
    import sys
    h5py = pytest.importorskip("h5py")
    from test_flusi import _flusi_oracle, _h5_equal, make_regular_input
    enc_exe, dec_exe = _flusi_oracle()
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(ORACLE.parent.parent) + ":"
                         + env.get("PYTHONPATH", ""))
    for d in ("o", "m"):
        dd = tmp_path / d
        dd.mkdir()
        make_regular_input(dd / "in.h5", shape=(12, 16, 8), name="p_00003")
        if mode == "new":
            (dd / "inmeta").write_text(FLUSI_INMETA_NEW)
        elif mode == "old":
            (dd / "inmeta").write_text(FLUSI_INMETA_OLD)
    stdin = FLUSI_STDIN if mode == "stdin" else ""
    subprocess.run([enc_exe], cwd=tmp_path / "o", input=stdin, text=True,
                   check=True, capture_output=True)
    subprocess.run([sys.executable, "-m", "waverange.cli.flusi_enc"],
                   cwd=tmp_path / "m", input=stdin, text=True, check=True,
                   capture_output=True, env=env)
    _h5_equal(tmp_path / "o" / "enc.h5", tmp_path / "m" / "enc.h5",
              ["p_00003"])
    # decoder: stdin mode (no inmeta in the reference decoder)
    dec_stdin = "enc.h5\ndec.h5\n0\n\n"   # empty precision -> double
    subprocess.run([dec_exe], cwd=tmp_path / "o", input=dec_stdin,
                   text=True, check=True, capture_output=True)
    subprocess.run([sys.executable, "-m", "waverange.cli.flusi_dec"],
                   cwd=tmp_path / "m", input=dec_stdin, text=True,
                   check=True, capture_output=True, env=env)
    _h5_equal(tmp_path / "o" / "dec.h5", tmp_path / "m" / "dec.h5",
              ["p_00003"])
