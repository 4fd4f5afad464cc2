"""Race/memory sanitizer builds of the native codec (SURVEY §5.2).

The reference's only sanitizer story is a commented-out CFLAGS line
(config.mk:17-19). Here the threaded pipeline (quantize + coder slot
pool, BufPool recycling, concurrent caller threads) actually runs under
ThreadSanitizer and AddressSanitizer via a standalone driver linked
against the same wr_native.cc translation unit.
"""
import subprocess

import pytest

from conftest import REPO

SRC = REPO / "waverange" / "native" / "src" / "wr_native.cc"
DRIVER = REPO / "tests" / "helpers" / "tsan_driver.cc"


def _build_and_run(tmp_path, san: str):
    exe = tmp_path / f"driver_{san}"
    r = subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", "-pthread",
         f"-fsanitize={san}", "-fno-omit-frame-pointer",
         "-ffp-contract=off", str(DRIVER), str(SRC), "-o", str(exe)],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    import os
    env = dict(os.environ)
    # The wavelet sweeps keep thread_local scratch vectors alive for the
    # thread's lifetime (deliberate reuse); main-thread copies destruct
    # after LSAN's exit check and are reported as 'leaks'. Corruption
    # and race detection — the point of these builds — stay enabled.
    env["ASAN_OPTIONS"] = "detect_leaks=0"
    r = subprocess.run([str(exe)], capture_output=True, text=True,
                       timeout=600, env=env)
    out = r.stdout + r.stderr
    assert "PASS" in r.stdout, out[-3000:]
    assert "WARNING: ThreadSanitizer" not in out, out[-5000:]
    assert "ERROR: AddressSanitizer" not in out, out[-5000:]
    assert r.returncode == 0, out[-3000:]


def test_threaded_codec_under_tsan(tmp_path):
    _build_and_run(tmp_path, "thread")


def test_threaded_codec_under_asan(tmp_path):
    _build_and_run(tmp_path, "address")
