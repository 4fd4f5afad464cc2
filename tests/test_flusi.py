"""FluSI/HDF5 interface tests.

Two layers of proof:
 1. structural tests (dataset/attribute names, dtypes, shapes) verified
    against the already-oracle-validated core codec — these run anywhere;
 2. real-binary interop: the reference flusi wrenc/wrdec
    (main_enc.cpp:237-527, main_dec.cpp) are built against h5py's bundled
    libhdf5 via a minimal API shim (tools/oracle/hdf5_shim/hdf5.h) and
    round-tripped against io/flusi.py IN BOTH DIRECTIONS with byte
    compares of payloads, attributes, and decoded fields.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from waverange.core import codec
from waverange.io.flusi import (BACKUP_DATASETS, encode_flusi_file,
                                decode_flusi_file)

from conftest import smooth_field


def make_regular_input(path, shape=(16, 12, 8), name="ux_00010"):
    nz, ny, nx = shape
    fld = smooth_field(shape)
    with h5py.File(path, "w") as f:
        d = f.create_dataset(name, data=fld)
        d.attrs.create("time", np.array([1.25]))
        d.attrs.create("viscosity", np.array([1e-3]))
        d.attrs.create("epsi", np.array([0.1]))
        d.attrs.create("domain_size", np.array([2.0, 1.0, 0.5]))
        d.attrs.create("nxyz", np.array([nx, ny, nz], np.int32))
    return fld, name


def test_regular_roundtrip_and_structure(tmp_path):
    fld, name = make_regular_input(tmp_path / "in.h5")
    nz, ny, nx = fld.shape
    encode_flusi_file(str(tmp_path / "in.h5"), str(tmp_path / "enc.h5"),
                      0, 1e-7, verbose=False)
    with h5py.File(tmp_path / "enc.h5", "r") as f:
        assert list(f.keys()) == [name]
        d = f[name]
        # encoded payload: 1-D uint8 dataset
        assert d.dtype == np.uint8 and d.ndim == 1
        # codec attribute schema (hdf5_interfaces.cpp:283-441)
        for k, dt in [("coder_version", np.int32), ("tolabs", np.float64),
                      ("midval", np.float64), ("halfspanval", np.float64),
                      ("wlev", np.uint8), ("nlay", np.uint8),
                      ("ntot_enc", np.uint64)]:
            assert k in d.attrs, k
            assert d.attrs[k].dtype == dt, (k, d.attrs[k].dtype)
        nlay = int(d.attrs["nlay"][0])
        assert d.attrs["deps_vec"].shape == (nlay,)
        assert d.attrs["len_enc_vec"].dtype == np.uint64
        # propagated FluSI attributes
        for k in ("time", "viscosity", "epsi", "domain_size", "nxyz"):
            assert k in d.attrs
        # payload bit-exact vs the conformance codec
        ref = codec.encode_field(fld, 1e-7, backend="native")
        assert bytes(d[...].tobytes()) == ref.data
        assert float(d.attrs["tolabs"][0]) == ref.tolabs

    decode_flusi_file(str(tmp_path / "enc.h5"), str(tmp_path / "dec.h5"),
                      0, iouttype=2, verbose=False)
    with h5py.File(tmp_path / "dec.h5", "r") as f:
        rec = np.asarray(f[name])
        assert rec.dtype == np.float64
        assert rec.shape == (nz, ny, nx)
        # matches the conformance decode bit for bit
        ref_dec = codec.decode_field(ref, backend="native")
        assert np.array_equal(rec, ref_dec)
        assert np.abs(rec - fld).max() <= 1.3e-7 * np.abs(fld).max()


def test_regular_float_output(tmp_path):
    fld, name = make_regular_input(tmp_path / "in.h5", shape=(8, 8, 8))
    encode_flusi_file(str(tmp_path / "in.h5"), str(tmp_path / "enc.h5"),
                      0, 1e-5, verbose=False)
    decode_flusi_file(str(tmp_path / "enc.h5"), str(tmp_path / "dec.h5"),
                      0, iouttype=1, verbose=False)
    with h5py.File(tmp_path / "dec.h5", "r") as f:
        assert f[name].dtype == np.float32


def make_backup_input(path, shape=(8, 10, 12), names=("ux", "uy", "uz",
                                                      "scalar1")):
    nz, ny, nx = shape
    fields = {}
    with h5py.File(path, "w") as f:
        for i, n in enumerate(names):
            fld = smooth_field(shape) * (1 + 0.2 * i)
            if n == "scalar1":
                fld = np.full(shape, 3.25)  # trivial dataset
            d = f.create_dataset(n, data=fld)
            bckp = np.array([1.5, 1e-3, 1e-3, 2.0, 100.0,
                             nx, ny, nz], np.float64)
            d.attrs.create("bckp", bckp)
            fields[n] = fld
    return fields


def test_backup_roundtrip(tmp_path):
    fields = make_backup_input(tmp_path / "in.h5")
    encode_flusi_file(str(tmp_path / "in.h5"), str(tmp_path / "enc.h5"),
                      1, 1e-6, verbose=False)
    with h5py.File(tmp_path / "enc.h5", "r") as f:
        # only existing datasets processed, in table order
        assert set(f.keys()) == set(fields.keys())
        for n in fields:
            assert "bckp" in f[n].attrs
            assert "coder_version" in f[n].attrs
        # trivial dataset: empty payload, ntot_enc == 0
        assert f["scalar1"].shape == (0,)
        assert int(f["scalar1"].attrs["ntot_enc"][0]) == 0
        assert "deps_vec" not in f["scalar1"].attrs
    decode_flusi_file(str(tmp_path / "enc.h5"), str(tmp_path / "dec.h5"),
                      1, iouttype=2, verbose=False)
    with h5py.File(tmp_path / "dec.h5", "r") as f:
        for n, fld in fields.items():
            rec = np.asarray(f[n])
            assert np.abs(rec - fld).max() <= 1.3e-6 * \
                max(np.abs(fld).max(), 1e-30)


def test_backup_dataset_table():
    assert len(BACKUP_DATASETS) == 50
    assert BACKUP_DATASETS[0] == "ux"
    assert BACKUP_DATASETS[18] == "scalar1"
    assert BACKUP_DATASETS[-1] == "Z_avg"
    assert "scalar9_nlk1" in BACKUP_DATASETS


def test_backup_jax_batched_matches_native(tmp_path):
    """jax backend batches equal-shaped backup datasets through the
    sharded encoder; streams equal the native path at moderate tol."""
    fields = make_backup_input(tmp_path / "in.h5",
                               names=("ux", "uy", "uz"))
    encode_flusi_file(str(tmp_path / "in.h5"), str(tmp_path / "j.h5"),
                      1, 1e-6, backend="jax", verbose=False)
    encode_flusi_file(str(tmp_path / "in.h5"), str(tmp_path / "n.h5"),
                      1, 1e-6, backend="native", verbose=False)
    with h5py.File(tmp_path / "j.h5") as fj, \
            h5py.File(tmp_path / "n.h5") as fn:
        for name in fields:
            assert bytes(fj[name][...].tobytes()) == \
                bytes(fn[name][...].tobytes()), name


# ---------------------------------------------------------------------------
# Interop against the reference-built flusi binaries (HDF5 shim build).
# ---------------------------------------------------------------------------
def _flusi_oracle():
    from conftest import ORACLE, build_oracle
    exe = ORACLE / "wrencflusi"
    if not exe.exists():
        try:
            build_oracle()
        except Exception as e:  # pragma: no cover
            pytest.skip(f"flusi oracle unavailable: {e}")
    if not exe.exists():  # pragma: no cover
        pytest.skip("flusi oracle not built (no libhdf5 runtime)")
    return str(ORACLE / "wrencflusi"), str(ORACLE / "wrdecflusi")


def _run(exe, *args):
    r = subprocess.run([exe, *map(str, args)], capture_output=True,
                       text=True)
    assert r.returncode == 0, (exe, r.stdout[-300:], r.stderr[-300:])


def _ours(mod, *args):
    env = {**os.environ, "PYTHONPATH": str(
        __import__("pathlib").Path(__file__).resolve().parent.parent)}
    r = subprocess.run(
        [sys.executable, "-m", f"waverange.cli.{mod}", *map(str, args)],
        capture_output=True, text=True, env=env)
    assert r.returncode == 0, (mod, r.stdout[-300:], r.stderr[-600:])


def _h5_equal(pa, pb, names):
    with h5py.File(pa) as fa, h5py.File(pb) as fb:
        assert sorted(fa.keys()) == sorted(fb.keys())
        for nm in names:
            assert np.array_equal(fa[nm][...].view(np.uint8).reshape(-1),
                                  fb[nm][...].view(np.uint8).reshape(-1)), nm
            for k in fa[nm].attrs:
                assert np.array_equal(fa[nm].attrs[k],
                                      fb[nm].attrs.get(k)), (nm, k)


def test_regular_interop_reference_binaries(tmp_path):
    """Type 0: byte-identical payloads+attrs and cross-decodability."""
    enc, dec = _flusi_oracle()
    make_regular_input(tmp_path / "in.h5", shape=(20, 24, 16),
                       name="ux_00077")
    _run(enc, tmp_path / "in.h5", tmp_path / "e_ref.h5", 0, "1e-6")
    _ours("flusi_enc", tmp_path / "in.h5", tmp_path / "e_our.h5", 0, "1e-6")
    _h5_equal(tmp_path / "e_ref.h5", tmp_path / "e_our.h5", ["ux_00077"])
    # cross decodes: ref->ours and ours->ref, fields bit-identical
    _run(dec, tmp_path / "e_our.h5", tmp_path / "d_ref.h5", 0, 2)
    _ours("flusi_dec", tmp_path / "e_ref.h5", tmp_path / "d_our.h5", 0, 2)
    _h5_equal(tmp_path / "d_ref.h5", tmp_path / "d_our.h5", ["ux_00077"])


def test_backup_interop_reference_binaries(tmp_path):
    """Type 1: multiple 50-table datasets with bckp attrs, both dirs,
    double and float reconstruction outputs."""
    enc, dec = _flusi_oracle()
    names = ["ux", "uy", "uz", "nlkx0", "Z_avg"]
    shape = (24, 20, 28)
    with h5py.File(tmp_path / "in.h5", "w") as f:
        for i, nm in enumerate(names):
            a = smooth_field(shape) * (i + 1) + 0.1 * i
            d = f.create_dataset(nm, data=a.astype(np.float64))
            d.attrs.create("bckp", np.array(
                [0.5, 1e-3, 2e-3, 1.0, 7.0,
                 shape[2], shape[1], shape[0]]), dtype=np.float64)
    _run(enc, tmp_path / "in.h5", tmp_path / "e_ref.h5", 1, "3e-5")
    _ours("flusi_enc", tmp_path / "in.h5", tmp_path / "e_our.h5", 1, "3e-5")
    _h5_equal(tmp_path / "e_ref.h5", tmp_path / "e_our.h5", names)
    _run(dec, tmp_path / "e_our.h5", tmp_path / "d_ref.h5", 1, 2)
    _ours("flusi_dec", tmp_path / "e_ref.h5", tmp_path / "d_our.h5", 1, 2)
    _h5_equal(tmp_path / "d_ref.h5", tmp_path / "d_our.h5", names)
    _run(dec, tmp_path / "e_ref.h5", tmp_path / "df_ref.h5", 1, 1)
    _ours("flusi_dec", tmp_path / "e_our.h5", tmp_path / "df_our.h5", 1, 1)
    _h5_equal(tmp_path / "df_ref.h5", tmp_path / "df_our.h5", names)
    with h5py.File(tmp_path / "df_ref.h5") as f:
        assert f["ux"].dtype == np.float32
