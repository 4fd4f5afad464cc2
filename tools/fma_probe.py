"""Does XLA's GPU backend contract the f64 multiply-adds of the wavelet's
lifting steps into FMAs, and does the device path then match the native
C++ path bit for bit?

    python tools/fma_probe.py [default|nofma] [DUMP_DIR]

Compiles the 4-level forward and inverse CDF 9/7 transforms of a 64^3
field with XLA's dump on (into DUMP_DIR, default build/fma_probe/<variant>),
counts the f64 fma/mul/add/sub/div instructions in the emitted PTX, and
compares both transforms element for element with the native wavelet.
Then it compares the device and native streams of a 128^3 field at 1e-10,
1e-14 and 1e-16, with each path's L-inf error relative to max|f|.
"nofma" passes the LLVM option -nvptx-fma-level=0 through
xla_backend_extra_options. Prints one JSON object; exits 1 without a GPU
or when no PTX was dumped. The persistent compile cache is off here.
Run it as its own process: the dump flags must be set before JAX starts.
"""
import glob
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = {"default": "",
            "nofma": "--xla_backend_extra_options=-nvptx-fma-level=0"}
PTX_OPS = ("fma.rn.f64", "mul.rn.f64", "add.rn.f64", "sub.rn.f64",
           "div.rn.f64")


def main(argv):
    variant = argv[1] if len(argv) > 1 else "default"
    dump = argv[2] if len(argv) > 2 else str(ROOT / "build" / "fma_probe"
                                             / variant)
    os.environ["XLA_FLAGS"] = " ".join(
        f for f in (f"--xla_dump_to={dump}",
                    "--xla_dump_hlo_module_re=.*probe_lift.*",
                    VARIANTS[variant]) if f)
    sys.path.insert(0, str(ROOT))
    import jax

    from waverange.device import configure_jax, platform
    configure_jax()
    # A persistent-cache hit skips compilation, and with it the dump.
    jax.config.update("jax_enable_compilation_cache", False)
    if platform() != "gpu":
        print("fma_probe.py inspects GPU code; JAX found no GPU",
              file=sys.stderr)
        return 1
    import jax.numpy as jnp
    import numpy as np

    import bench
    from waverange import native as wn
    from waverange.core import codec
    from waverange.ops.wavelet import cdf97_forward, cdf97_inverse

    def probe_lift(x):
        return cdf97_forward(x, 4)

    def probe_lift_inv(x):
        return cdf97_inverse(x, 4)

    fld = bench.make_field(64)
    w = np.asarray(jax.jit(probe_lift)(jnp.asarray(fld)))
    wref = wn.wavelet3d(fld.copy(), 4)
    inv = np.asarray(jax.jit(probe_lift_inv)(jnp.asarray(wref)))
    invref = wn.wavelet3d(wref.copy(), -4)
    res = dict(variant=variant, card=bench.card(),
               fwd_diff=int(np.count_nonzero(w != wref)),
               inv_diff=int(np.count_nonzero(inv != invref)), n=fld.size)
    files = set(glob.glob(f"{dump}/**/*.ptx", recursive=True))
    ptx = "".join(Path(p).read_text() for p in files)
    res["ptx_files"] = len(files)
    res["ptx_counts"] = {op: ptx.count(op) for op in PTX_OPS}
    if not files:
        print(json.dumps(res), flush=True)
        print(f"no PTX was dumped under {dump}", file=sys.stderr)
        return 1

    fld = bench.make_field(128)
    mx = float(np.abs(fld).max())
    for tol in (1e-10, 1e-14, 1e-16):
        en = codec.encode_field(fld, tol, backend="native")
        ed = codec.encode_field(fld, tol, backend="jax")
        dn = codec.decode_field(en, backend="native")
        dd = codec.decode_field(ed, backend="jax")
        res[f"tol{tol:g}"] = dict(
            identical=ed.data == en.data
            and bool(np.array_equal(ed.deps_vec, en.deps_vec)),
            err_native=float(np.abs(dn - fld).max() / mx),
            err_device=float(np.abs(dd - fld).max() / mx))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
