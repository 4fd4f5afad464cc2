"""Where the device path runs, and how JAX is set up for it.

`platform()` is the one place the codec asks which device it is on: the
"auto" backend and the conformance floors (core/codec.py) read it. It
does not catch backend errors: a JAX that cannot start is an error, not
a CPU.

`configure_jax()` is the one place the program configures JAX and XLA.
Entry points that drive the device (the CLIs on a device backend,
chip_smoke.py, bench.py) call it before their first device computation.
"""
from __future__ import annotations

import os
from pathlib import Path

#: Platforms the device path runs on.
PLATFORMS = ("cpu", "gpu")

#: Persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset:
#: one fixed path in the checkout, so every process of every entry point
#: finds what an earlier one compiled.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "jax_cache"


def platform() -> str:
    """Platform of the default JAX device: "cpu" or "gpu"."""
    import jax
    p = jax.devices()[0].platform
    if p not in PLATFORMS:
        raise RuntimeError(f"unsupported JAX platform {p!r}; the device "
                           f"path runs on {' or '.join(PLATFORMS)}")
    return p


def configure_jax() -> None:
    """Enable x64 (the codec's normative arithmetic is f64) and point the
    persistent compile cache at JAX_COMPILATION_CACHE_DIR if it is set
    (JAX reads it itself), else at DEFAULT_CACHE_DIR."""
    import jax
    jax.config.update("jax_enable_x64", True)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          str(DEFAULT_CACHE_DIR))


def require_x64() -> None:
    """Refuse to run the f64 device path in f32 (JAX silently truncates
    f64 inputs to f32 when x64 is off)."""
    import jax
    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            "the f64 device path needs JAX's x64 mode; call "
            "waverange.device.configure_jax() (or set JAX_ENABLE_X64=1) "
            "before the first device computation")
