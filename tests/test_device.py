"""The platform decision, the x64 guard, the compile-cache rule and the
smoke script's refusal to run without a GPU — on the CPU backend, with
the platform function monkeypatched where a GPU is needed."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from waverange import device
from waverange.core import codec

from conftest import smooth_field

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def gpu(monkeypatch):
    """Make the codec believe it runs on a GPU (the arithmetic stays on
    the CPU backend)."""
    monkeypatch.setattr(codec, "platform", lambda: "gpu")


def test_auto_resolves_to_jax_on_gpu(gpu):
    a = smooth_field((16, 16, 16))
    assert codec._resolve_backend("auto") == "jax"
    e = codec.encode_field(a, 1e-7, backend="auto")
    assert e.data == codec.encode_field(a, 1e-7, backend="jax").data


def test_strict_uses_gpu_f64_floor(gpu, monkeypatch):
    """The GPU's f64 floor is the measured 0: strict accepts 1e-16 there.
    A floor set for the GPU is read only on the GPU."""
    a = smooth_field((16, 16, 16))
    assert codec.DEVICE_F64_REL_FLOOR["gpu"] == 0.0
    codec.encode_field(a, 1e-16, backend="jax")
    monkeypatch.setitem(codec.DEVICE_F64_REL_FLOOR, "gpu", 1e-12)
    with pytest.raises(ValueError, match="error floor"):
        codec.encode_field(a, 1e-14, backend="jax")
    codec.encode_field(a, 1e-12, backend="jax")
    monkeypatch.setattr(codec, "platform", lambda: "cpu")
    codec.encode_field(a, 1e-14, backend="jax")


def test_route_picks_native_below_gpu_floor(gpu, monkeypatch):
    a = smooth_field((16, 16, 16))
    dev16 = codec.encode_field(a, 1e-16, backend="jax")
    assert codec.encode_field(a, 1e-16, backend="jax",
                              conformance="route").data == dev16.data
    monkeypatch.setitem(codec.DEVICE_F64_REL_FLOOR, "gpu", 1e-12)
    routed = codec.encode_field(a, 1e-14, backend="jax", conformance="route")
    assert routed.data == codec.encode_field(a, 1e-14,
                                             backend="native").data
    # above the floor route keeps the device path
    above = codec.encode_field(a, 1e-7, backend="jax", conformance="route")
    assert above.data == codec.encode_field(a, 1e-7, backend="jax").data


def test_backend_errors_propagate(monkeypatch):
    import jax

    def broken():
        raise RuntimeError("backend failed to initialise")

    monkeypatch.setattr(jax, "devices", broken)
    with pytest.raises(RuntimeError, match="failed to initialise"):
        device.platform()
    with pytest.raises(RuntimeError, match="failed to initialise"):
        codec.encode_field(smooth_field((8, 8, 8)), 1e-5, backend="auto")


_NO_X64 = """
import numpy as np
from waverange.core import codec
a = np.fromfunction(lambda k, j, i: np.sin(i / 3.1) * np.cos(j / 2.3)
                    + 0.01 * k, (16, 16, 16))
try:
    e = codec.encode_field(a, 1e-12, backend="jax")
    d = codec.decode_field(e, backend="jax")
except RuntimeError as err:
    print("REFUSED", err)
else:
    print("ERR", float(np.abs(d - a).max()) / float(np.abs(a).max()),
          d.dtype)
"""


def test_f64_device_path_never_runs_in_f32():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_ENABLE_X64", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _NO_X64], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout.strip().splitlines()[-1]
    if out.startswith("REFUSED"):
        assert "x64" in out
    else:
        _, rel, dtype = out.split()
        assert dtype == "float64" and float(rel) <= 1.3e-12, out


_NO_X64_SHARDED = """
import sys
import numpy as np
from waverange.core import codec
from waverange.parallel import mesh
a = np.fromfunction(lambda b, k, j, i: np.sin(i / 3.1) * np.cos(j / 2.3)
                    + 0.01 * k + b, (2, 16, 16, 16))
try:
    if sys.argv[1] == "encode":
        d = np.stack([codec.decode_field(e, backend="native")
                      for e in mesh.encode_fields_sharded(a, 1e-12)])
    else:
        d = mesh.decode_fields_sharded(
            [codec.encode_field(f, 1e-12, backend="native") for f in a])
except RuntimeError as err:
    print("REFUSED", err)
else:
    print("ERR", float(np.abs(d - a).max()) / float(np.abs(a).max()),
          d.dtype)
"""


@pytest.mark.parametrize("step", ["encode", "decode"])
def test_sharded_f64_path_never_runs_in_f32(step):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_ENABLE_X64", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _NO_X64_SHARDED, step],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout.strip().splitlines()[-1]
    if out.startswith("REFUSED"):
        assert "x64" in out
    else:
        _, rel, dtype = out.split()
        assert dtype == "float64" and float(rel) <= 1.3e-12, out


_CACHE = ("from waverange.device import configure_jax; configure_jax(); "
          "import jax; print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_rule(env_dir, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    want = (str(tmp_path / env_dir) if env_dir
            else str(REPO / "build" / "jax_cache"))
    for cwd in ("a", "b"):
        (tmp_path / cwd).mkdir()
        r = subprocess.run([sys.executable, "-c", _CACHE], env=env,
                           cwd=tmp_path / cwd, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        assert r.stdout.strip().splitlines()[-1] == want


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    last = (r.stdout.strip().splitlines() or [""])[-1]
    assert '"ok": true' not in last
    assert "not a GPU" in r.stderr
