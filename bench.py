"""Benchmark rows of the codec on one GPU: the native host pipeline and the
jax device path, end to end, from a host array to compressed bytes and
back.

    python bench.py

Env: WR_BENCH_N (grid size, default 512). Each row is the best of REPS
timed round trips at one of TOLS.

Needs a GPU: it exits non-zero when JAX finds none. Each row names the
device; the last line of stdout is one JSON object with every row.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

#: Relative tolerances of the rows: checkpoint, intermediate, analysis.
TOLS = (1e-16, 1e-10, 1e-5)
#: Timed round trips per row; the minimum is reported.
REPS = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_field(n):
    """CFD-like (n, n, n) f64 field from seed 0: smooth trigonometric base
    plus band-limited noise at two scales, built slab by slab into one
    allocation."""
    i = np.arange(n)
    sx = np.sin(i / 17.3)
    sy = np.sin(i / 11.1) ** 2
    sz = np.cos(i / 23.7)
    rng = np.random.default_rng(0)
    small = rng.standard_normal((n // 8, n // 8, n // 8))
    plane = 10.0 * (sy[:, None] * sx[None, :])          # (n, n)
    fld = np.empty((n, n, n))
    s2 = None
    for k in range(n):
        if k % 8 == 0:
            s2 = 0.05 * np.repeat(np.repeat(small[k // 8], 8, 0), 8, 1)
        slab = fld[k]
        np.multiply(plane, sz[k], out=slab)
        slab += s2
        slab += 1e-4 * rng.standard_normal((n, n), dtype=np.float32)
    return fld


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def time_row(fld, tol, backend, reps):
    """Best-of-`reps` encode and decode seconds of one backend, after one
    untimed round trip that compiles the device programs."""
    from waverange.core import codec

    enc = codec.encode_field(fld, tol, backend=backend)
    codec.decode_field(enc, backend=backend)
    enc_s = dec_s = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        enc = codec.encode_field(fld, tol, backend=backend)
        enc_s = min(enc_s, time.perf_counter() - t0)
        t0 = time.perf_counter()
        rec = codec.decode_field(enc, backend=backend)
        dec_s = min(dec_s, time.perf_counter() - t0)
    return dict(backend=backend, tol=tol, encode_s=enc_s, decode_s=dec_s,
                ratio=enc.ntot_enc / fld.nbytes, nlay=enc.nlay,
                err=float(np.abs(rec - fld).max()), data=enc.data)


def main():
    from waverange.device import configure_jax, platform
    configure_jax()
    import jax

    if platform() != "gpu":
        log("bench.py measures on a GPU; JAX found none")
        return 1
    dev = jax.devices()[0]
    device = dict(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()))
    where = card()
    n = int(os.environ.get("WR_BENCH_N", "512"))
    fld = make_field(n)
    gb = fld.nbytes / 1e9
    limit_rel = 1.3 * float(np.abs(fld).max())
    rows = []
    for tol in TOLS:
        native = time_row(fld, tol, "native", REPS)
        ref = native["data"]
        for r in (native, time_row(fld, tol, "jax", REPS)):
            r["identical_to_native"] = r.pop("data") == ref
            r["err_ok"] = r["err"] <= max(limit_rel * tol, native["err"])
            r["encode_gbps"] = gb / r["encode_s"]
            r["decode_gbps"] = gb / r["decode_s"]
            log(f"[{where}] {n}^3 f64 tol {tol:g} {r['backend']}: encode "
                f"{r['encode_s']:.4f} s ({r['encode_gbps']:.4f} GB/s), "
                f"decode {r['decode_s']:.4f} s, ratio {r['ratio']:.4f}, "
                f"err {r['err']:.3e}, identical {r['identical_to_native']}")
            rows.append(r)
    print(json.dumps(dict(n=n, card=where, device=device, rows=rows)))
    return 0 if all(r["err_ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
