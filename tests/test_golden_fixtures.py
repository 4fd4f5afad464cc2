"""Committed golden fixtures (produced once by the reference binaries,
ISO FP build — see tests/golden/). These pin conformance even when the
oracle can't be rebuilt, and double as example-script rot protection.

Fixture: 16^3 analytic f64 field, C raw file, tol 1e-16 (BASELINE
config[0]) — input, encoded .wrb/.wrh, and the reference-decoded output.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

GOLDEN = Path(__file__).parent / "golden"
REPO = Path(__file__).resolve().parent.parent


def test_encoder_matches_golden(tmp_path):
    from waverange.cli import wrenc
    shutil.copy(GOLDEN / "data.bin", tmp_path / "data.bin")
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        wrenc.main(["data.bin", "data.wrb", "data.wrh", "2", "0", "1",
                    "2", "16", "16", "16", "1e-16"])
    finally:
        os.chdir(old)
    assert (tmp_path / "data.wrb").read_bytes() == \
        (GOLDEN / "data.wrb").read_bytes()
    assert (tmp_path / "data.wrh").read_text() == \
        (GOLDEN / "data.wrh").read_text()


def test_decoder_matches_golden(tmp_path):
    from waverange.cli import wrdec
    for f in ("data.wrb", "data.wrh"):
        shutil.copy(GOLDEN / f, tmp_path / f)
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        wrdec.main(["data.wrb", "data.wrh", "datarec.bin", "2", "0"])
    finally:
        os.chdir(old)
    assert (tmp_path / "datarec.bin").read_bytes() == \
        (GOLDEN / "datarec.bin").read_bytes()


@pytest.mark.parametrize("script", ["generic/generic_enc_dec.sh",
                                    "flusi/flusi_enc_dec.sh",
                                    "mssg/all_enc_dec.sh"])
def test_example_scripts(script, tmp_path):
    """The example round-trip scripts run to completion (copied into a
    temp dir so artifacts don't pollute the tree)."""
    src_dir = REPO / "examples" / Path(script).parent
    work = tmp_path / Path(script).parent
    shutil.copytree(src_dir, work)
    # scripts reference the repo via relative paths; point PYTHONPATH home
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + ":" + env.get("PYTHONPATH", "")
    r = subprocess.run(["bash", Path(script).name], cwd=work, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
    assert "round trip complete" in r.stdout


def test_vendored_flusi_golden_decode():
    """Decode the VENDORED reference-binary-produced FluSI file (the
    permanent stand-in for the OSF sample-data download of
    examples/flusi/flusi_dec_enc.sh:15-17): our decoder's output must be
    bit-identical to the vendored reference decode, and re-encoding must
    reproduce the vendored encoded payload byte-for-byte."""
    h5py = pytest.importorskip("h5py")
    from waverange.io.flusi import decode_flusi_file, encode_flusi_file
    g = Path(__file__).parent / "golden"
    src = g / "flusi_ux_golden.enc.h5"
    if not src.exists():
        pytest.skip("vendored golden missing")
    tmpd = REPO / "build" / "tmp"
    tmpd.mkdir(parents=True, exist_ok=True)
    out = tmpd / "flusi_golden_dec.h5"
    decode_flusi_file(str(src), str(out), ifiletype=0, iouttype=2,
                      verbose=False)
    with h5py.File(out) as fo, h5py.File(g / "flusi_ux_golden.dec.h5") as fr:
        a = fo["ux_00042"][...]
        b = fr["ux_00042"][...]
        assert np.array_equal(a.view(np.uint64), b.view(np.uint64))
    # re-encode the ORIGINAL field: payload must match the vendored enc
    enc2 = tmpd / "flusi_golden_reenc.h5"
    encode_flusi_file(str(g / "flusi_ux_golden.h5"), str(enc2),
                      ifiletype=0, tol_base=1e-5, verbose=False)
    with h5py.File(enc2) as fa, h5py.File(src) as fb:
        assert np.array_equal(fa["ux_00042"][...], fb["ux_00042"][...])
