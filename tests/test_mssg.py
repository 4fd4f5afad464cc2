"""MSSG interface golden tests vs the reference wrmssgenc/wrmssgdec.

Covers: GrADS regular mode with mask separation, backup united
(subdomain gather + time record), backup divided (PROCID sharding), and
byte-compares headers, encoded payloads and reconstructed files.
"""
import os
import subprocess

import numpy as np
import pytest

from waverange.cli import mssg_enc, mssg_dec

from conftest import ORACLE, smooth_field


def run_oracle(exe, args, cwd):
    return subprocess.run([str(ORACLE / exe), *[str(a) for a in args]],
                          cwd=cwd, check=True, capture_output=True,
                          text=True)


def run_ours(mod, args, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        mod.main([str(a) for a in args])
    finally:
        os.chdir(old)


def cmp_file(a, b):
    assert a.read_bytes() == b.read_bytes(), f"{a.name} differs"


# ---------------------------------------------------------------------------
# regular output (GrADS) with masking
# ---------------------------------------------------------------------------

def make_regular(dirpath, nx=12, ny=10, nz=6, nt=3, undef=-9.99e33,
                 masked=True):
    rng = np.random.default_rng(5)
    recs = []
    for it in range(nt):
        fld = smooth_field((nz, ny, nx)) * (1 + 0.3 * it) + 300.0
        if masked and it != 1:  # one record unmasked
            m = rng.random((nz, ny, nx)) < 0.2
            fld[m] = undef
        recs.append(fld)
    data = np.concatenate([r.ravel() for r in recs])
    # big-endian f32 .grd (MSSG convention, endian conversion ON)
    (dirpath / "ocean.grd").write_bytes(
        data.astype(">f4").tobytes())
    (dirpath / "ocean.ctl").write_text(
        f"DSET ^ocean.grd\n"
        f"UNDEF {undef:g}\n"
        f"XDEF {nx} LINEAR 0 1\n"
        f"YDEF {ny} LINEAR 0 1\n"
        f"ZDEF {nz} LEVELS 1 2 3 4 5 6\n"
        f"TDEF {nt} LINEAR 00Z01JAN2000 1dy\n")
    return recs


def test_regular_with_mask_vs_oracle(oracle, tmp_path):
    for d in ("o", "m"):
        dd = tmp_path / d
        dd.mkdir()
        make_regular(dd)
    args = ["ocean", ".enc", "0", "1", "1", "1e-4", "0"]
    run_oracle("wrmssgenc", args, tmp_path / "o")
    run_ours(mssg_enc, args, tmp_path / "m")
    cmp_file(tmp_path / "m" / "ocean_h.enc", tmp_path / "o" / "ocean_h.enc")
    cmp_file(tmp_path / "m" / "ocean_f.enc", tmp_path / "o" / "ocean_f.enc")

    dargs = ["ocean", ".enc", "oceanrec", "0", "1", "1", "0"]
    run_oracle("wrmssgdec", dargs, tmp_path / "o")
    run_ours(mssg_dec, dargs, tmp_path / "m")
    cmp_file(tmp_path / "m" / "oceanrec.grd", tmp_path / "o" / "oceanrec.grd")
    cmp_file(tmp_path / "m" / "oceanrec.ctl", tmp_path / "o" / "oceanrec.ctl")


# ---------------------------------------------------------------------------
# backup united / divided
# ---------------------------------------------------------------------------

def make_backup(dirpath, nx=16, ny=12, nz=8, nprocx=2, nprocy=2, ndset=4):
    """Per-proc files prefix.p_NNNN, each with ndset records of
    (nz, nyloc, nxloc); record 0 is the time record."""
    rng = np.random.default_rng(9)
    nxloc, nyloc = nx // nprocx, ny // nprocy
    glob = [smooth_field((nz, ny, nx)) * (1 + 0.5 * k) for k in
            range(ndset)]
    # time record: distinctive doubles in the first elements
    glob[0] = np.zeros((nz, ny, nx))
    glob[0].ravel()[:20] = 1000.0 + np.arange(20) * 0.125
    for ipy in range(nprocy):
        for ipx in range(nprocx):
            iproc = ipx + nprocx * ipy
            with open(dirpath / f"rst.p_{iproc:04d}", "wb") as f:
                for k in range(ndset):
                    sub = glob[k][:, ipy * nyloc:(ipy + 1) * nyloc,
                                  ipx * nxloc:(ipx + 1) * nxloc]
                    f.write(sub.astype(">f8").tobytes())
    names = ["time", "u", "v", "t", "w", "q"][:ndset]
    recs = "".join(f" var = '{nm}', rec = {k + 1},\n"
                   for k, nm in enumerate(names))
    (dirpath / "rst.nmlst").write_text(
        "&gridparam\n"
        f" nx = {nx},\n ny = {ny},\n nr = {nz},\n"
        "/\n"
        "&procparam\n"
        f" nproc = {nprocx * nprocy}, dim_size = {nprocx},\n"
        "/\n"
        "&recparam\n"
        + recs +
        "/\n")
    return glob


def test_backup_united_vs_oracle(oracle, tmp_path):
    for d in ("o", "m"):
        dd = tmp_path / d
        dd.mkdir()
        make_backup(dd)
    args = ["rst", ".enc", "1", "2", "1", "1e-7", "0"]
    run_oracle("wrmssgenc", args, tmp_path / "o")
    run_ours(mssg_enc, args, tmp_path / "m")
    cmp_file(tmp_path / "m" / "rst_h.enc", tmp_path / "o" / "rst_h.enc")
    cmp_file(tmp_path / "m" / "rst_f.enc", tmp_path / "o" / "rst_f.enc")

    dargs = ["rst", ".enc", "rstrec", "1", "2", "1", "0"]
    run_oracle("wrmssgdec", dargs, tmp_path / "o")
    run_ours(mssg_dec, dargs, tmp_path / "m")
    for iproc in range(4):
        cmp_file(tmp_path / "m" / f"rstrec.p_{iproc:04d}",
                 tmp_path / "o" / f"rstrec.p_{iproc:04d}")


def test_backup_divided_vs_oracle(oracle, tmp_path):
    for d in ("o", "m"):
        dd = tmp_path / d
        dd.mkdir()
        make_backup(dd)
    # all four PROCIDs, serial (the reference's multi-node story)
    for procid in range(4):
        args = ["rst", ".enc", "2", "2", "1", "1e-7", str(procid)]
        run_oracle("wrmssgenc", args, tmp_path / "o")
        run_ours(mssg_enc, args, tmp_path / "m")
        cmp_file(tmp_path / "m" / f"rst_h{procid:04d}.enc",
                 tmp_path / "o" / f"rst_h{procid:04d}.enc")
        cmp_file(tmp_path / "m" / f"rst_f{procid:04d}.enc",
                 tmp_path / "o" / f"rst_f{procid:04d}.enc")
        dargs = ["rst", ".enc", "rstrec", "2", "2", "1", str(procid)]
        run_oracle("wrmssgdec", dargs, tmp_path / "o")
        run_ours(mssg_dec, dargs, tmp_path / "m")
        cmp_file(tmp_path / "m" / f"rstrec.p_{procid:04d}",
                 tmp_path / "o" / f"rstrec.p_{procid:04d}")


def test_yinyang_grid_arithmetic(tmp_path):
    """npg/i_over/j_over → nx/ny per the hardcoded MSSG formulas."""
    from waverange.io.mssg import read_control_file
    (tmp_path / "g.nmlst").write_text(
        "&gridparam\n npg = 12, i_over = 2, j_over = 1, nr = 4,\n/\n"
        "&procparam\n nproc = 4, dim_size = 2,\n/\n"
        "&recparam\n var = 'time', rec = 1,\n var = 'u', rec = 2,\n/\n")
    nx, ny, nz, npx, npy, tab = read_control_file(str(tmp_path / "g.nmlst"))
    assert nx == 3 * 12 - 4 + 2 * 2   # nlg + 2*i_over
    assert ny == (12 + 2 * 1) * 2     # (npg + 2*j_over) * ngrids
    assert (nz, npx, npy) == (4, 2, 2)
    assert tab == ["time", "u"]
