"""Smoke test of the codec's device path on a GPU, through the entry points
a user calls.

    python chip_smoke.py                # one GPU: phases 1-6
    python chip_smoke.py --four-cards   # the sharded path on four GPUs

Phases on one GPU:
  1. device check: the default JAX device must be a GPU (no CPU fallback);
  2. main path: one 512^3 f64 field (bench.make_field) through
     core/codec.encode_field/decode_field(backend="jax") at tolerances
     1e-5, 1e-10, 1e-14 and 1e-16, cross-decoded with the native path;
  3. CLI: wrenc/wrdec with WR_BACKEND=jax on a 256^3 raw f64 file, called
     in-process, against the native CLI;
  4. f32 path: precision="native" on a 512^3 f32 field at 1e-5, and the
     time of each device stage beside the bytes it moves;
  5. v2 device entropy: the XLA rANS scan on the planes of a 256^3 f64
     field at 1e-7 and on distribution cases, byte-identical to the C++
     coder;
  6. exact64: a 32^3 field at 1e-16, bit-identical to the native path.

With --four-cards it runs only the sharded path of parallel/mesh.py on
four GPUs and its single-card comparison.

Every timing line names the card and its power limit. The last line of
stdout is {"ok": true, "device": {...}} only if every phase passed; any
failed phase makes the script exit non-zero. Everything runs in this one
process: a second JAX process could not get the card's memory.
"""
import argparse
import json
import os
import shutil
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"

#: Peak device-memory bandwidth by JAX device_kind (NVIDIA data sheets).
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,   # H100 SXM5
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}

CARD = "not read"   # nvidia-smi name and power limit, set by main()


def say(msg):
    print(msg, flush=True)


def linf(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max())


def best_time(fn, *args, reps=5):
    """(result, best seconds of `reps` runs) of a device function, after
    one untimed call that compiles it."""
    import jax
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best


def clock(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def layer_symbol_diffs(a, b, n):
    """Differing symbols per layer between two range-coded (v1) fields."""
    from waverange import native as wn
    nl = min(a.nlay, b.nlay)
    pa = wn.decode_planes_batch(a.data, a.len_enc_vec[:a.nlay], n)
    pb = wn.decode_planes_batch(b.data, b.len_enc_vec[:b.nlay], n)
    return [int(np.count_nonzero(pa[i] != pb[i])) for i in range(nl)]


def warm_encode(shape, dtype):
    """Compile the encode step outside the timed region (the tolerance is
    a traced scalar, so one compilation serves every tolerance)."""
    import jax
    import jax.numpy as jnp
    from waverange.ops.quant import encode_step
    jax.block_until_ready(encode_step(jnp.ones(shape, dtype), 1e-5))


def warm_decode(shape, dtype, nlays):
    """Compile the decode step for each layer count in `nlays`."""
    import jax
    import jax.numpy as jnp
    from waverange.ops.quant import decode_step
    n = int(np.prod(shape))
    for nl in set(nlays):
        jax.block_until_ready(decode_step(
            jnp.zeros((nl, n), jnp.uint8), jnp.ones(nl, dtype),
            jnp.zeros(nl, dtype), shape=shape))


# ---------------------------------------------------------------------------
# Phase 2: the main path
# ---------------------------------------------------------------------------

def phase_main_path(n=512, tols=(1e-5, 1e-10, 1e-14, 1e-16)):
    from bench import make_field
    from waverange.core import codec

    fld = make_field(n)
    shape = fld.shape
    maxabs = float(np.abs(fld).max())
    warm_encode(shape, np.float64)
    for tol in tols:
        e_nat, t_en = clock(codec.encode_field, fld, tol, backend="native")
        e_dev, t_ed = clock(codec.encode_field, fld, tol, backend="jax")
        warm_decode(shape, np.float64, [e_dev.nlay, e_nat.nlay])
        d_nn, t_dn = clock(codec.decode_field, e_nat, backend="native")
        d_dd, t_dd = clock(codec.decode_field, e_dev, backend="jax")
        d_dn = codec.decode_field(e_dev, backend="native")
        d_nd = codec.decode_field(e_nat, backend="jax")
        err = dict(native=linf(d_nn, fld), device=linf(d_dd, fld),
                   dev_stream_native_dec=linf(d_dn, fld),
                   native_stream_dev_dec=linf(d_nd, fld))
        identical = (e_dev.data == e_nat.data and e_dev.nlay == e_nat.nlay
                     and np.array_equal(e_dev.deps_vec, e_nat.deps_vec))
        diffs = [] if identical else layer_symbol_diffs(e_dev, e_nat,
                                                        fld.size)
        # below the native path's own round-off, its error bounds both
        bound = max(1.3 * tol * maxabs, err["native"])
        say(f"[{CARD}] main path {n}^3 f64 tol {tol:g}: nlay "
            f"{e_dev.nlay}/{e_nat.nlay} (device/native), ratio "
            f"{e_dev.ntot_enc / fld.nbytes:.6f}, byte-identical "
            f"{identical}, differing symbols per layer {diffs}")
        say(f"[{CARD}] main path {n}^3 f64 tol {tol:g}: encode device "
            f"{t_ed:.4f} s, native {t_en:.4f} s; decode device {t_dd:.4f} "
            f"s, native {t_dn:.4f} s")
        say(f"  L-inf error (relative to max|f| {maxabs:.6g}): " + ", ".join(
            f"{k} {v:.6e} ({v / maxabs:.3e})" for k, v in err.items())
            + f"; bound {bound:.6e}")
        for k, v in err.items():
            if v > bound:
                raise AssertionError(f"tol {tol:g}: {k} error {v:.6e} > "
                                     f"bound {bound:.6e}")


# ---------------------------------------------------------------------------
# Phase 3: the generic CLI, in-process
# ---------------------------------------------------------------------------

def phase_cli(n=256, tol=1e-10):
    from bench import make_field
    from waverange.cli import wrdec, wrenc

    fld = make_field(n)
    maxabs = float(np.abs(fld).max())
    work = WORK / "cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    fld.tofile(work / "in.bin")
    cwd = os.getcwd()
    out, dec = {}, {}
    try:
        # each backend writes the same file names in its own directory
        # (the header records them), so the headers compare byte for byte
        for be in ("native", "jax"):
            (work / be).mkdir()
            os.chdir(work / be)
            os.environ["WR_BACKEND"] = be
            _, out[be] = clock(wrenc.main, [
                "../in.bin", "data.wrb", "data.wrh", "2", "0", "1", "2",
                str(n), str(n), str(n), repr(tol)])
        for src in ("native", "jax"):
            os.chdir(work / src)
            for be in ("native", "jax"):
                os.environ["WR_BACKEND"] = be
                name = f"by_{be}.bin"
                _, t = clock(wrdec.main, ["data.wrb", "data.wrh", name,
                                          "2", "0"])
                dec[(src, be)] = (np.fromfile(name).reshape(fld.shape), t)
    finally:
        os.environ.pop("WR_BACKEND", None)
        os.chdir(cwd)
    same_wrh, same_wrb = ((work / "jax" / f).read_bytes()
                          == (work / "native" / f).read_bytes()
                          for f in ("data.wrh", "data.wrb"))
    err = {f"{s} stream, {b} decoder": linf(a, fld)
           for (s, b), (a, _) in dec.items()}
    bound = max(1.3 * tol * maxabs, err["native stream, native decoder"])
    say(f"[{CARD}] CLI wrenc/wrdec {n}^3 f64 tol {tol:g}: encode jax "
        f"{out['jax']:.4f} s, native {out['native']:.4f} s; decode jax "
        f"{dec[('jax', 'jax')][1]:.4f} s, native "
        f"{dec[('native', 'native')][1]:.4f} s; .wrh identical {same_wrh}, "
        f".wrb identical {same_wrb}")
    say("  L-inf error: " + ", ".join(f"{k} {v:.6e}" for k, v in err.items())
        + f"; bound {bound:.6e}")
    for k, v in err.items():
        if v > bound:
            raise AssertionError(f"CLI {k}: error {v:.6e} > {bound:.6e}")
    shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 4: the f32 path and the device stages against the memory bound
# ---------------------------------------------------------------------------

def wavelet_bytes(shape, itemsize, levels=4):
    """One read and one write of the active box per axis sweep."""
    box = list(shape)
    total = 0
    for _ in range(levels):
        total += 6 * int(np.prod(box)) * itemsize
        box = [b // 2 + b % 2 for b in box]
    return total


def quantize_bytes(n, itemsize, layers=8):
    """Per layer: the min/max read, then the quantize pass's read, symbol
    write and residual write."""
    return layers * (3 * itemsize + 1) * n


def stage_table(fld, dtype, tol):
    """Time each device stage of encode and decode at `shape`, with the
    bytes it moves and its share of the card's peak bandwidth."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from waverange.ops.quant import (QALPHABET, accumulate_layers,
                                     decode_step, encode_step,
                                     quantize_layers)
    from waverange.ops.wavelet import cdf97_forward, cdf97_inverse

    kind = jax.devices()[0].device_kind
    if kind not in PEAK_BYTES_PER_S:
        raise KeyError(f"no peak bandwidth known for {kind!r}")
    peak = PEAK_BYTES_PER_S[kind]
    shape = fld.shape
    n = fld.size
    isz = np.dtype(dtype).itemsize
    x = jnp.asarray(fld, dtype)
    tolabs = jnp.asarray(tol * float(jnp.abs(x).max()) / 1.75, dtype)
    qa = jnp.asarray(QALPHABET, dtype)
    fwd = jax.jit(partial(cdf97_forward, levels=4))
    inv = jax.jit(partial(cdf97_inverse, levels=4))
    quant = jax.jit(quantize_layers)
    w, t_fwd = best_time(fwd, x)
    (planes, deps, minv, nlay), t_q = best_time(quant, w.ravel(), tolabs, qa)
    nl = int(nlay)
    acc = jax.jit(partial(accumulate_layers, dtype=dtype))
    a, t_acc = best_time(acc, planes[:nl], deps[:nl], minv[:nl])
    _, t_inv = best_time(inv, a.reshape(shape))
    _, t_copy = best_time(jax.jit(lambda v: v + 1), x)
    _, t_enc = best_time(encode_step, x, jnp.asarray(tol, dtype))
    _, t_dec = best_time(partial(decode_step, shape=shape), planes[:nl],
                         deps[:nl], minv[:nl])
    wb = wavelet_bytes(shape, isz)
    rows = [("forward wavelet", t_fwd, wb),
            ("quantize, 8 layers", t_q, quantize_bytes(n, isz)),
            (f"accumulate, {nl} layers", t_acc, (nl + isz) * n),
            ("inverse wavelet", t_inv, wb),
            ("copy x+1 (reference)", t_copy, 2 * isz * n),
            ("encode_step", t_enc, wb + quantize_bytes(n, isz) + isz * n),
            ("decode_step", t_dec, (nl + isz) * n + wb)]
    name = np.dtype(dtype).name
    for what, t, b in rows:
        say(f"[{CARD}] {'x'.join(map(str, shape))} {name} {what}: "
            f"{t * 1e3:.3f} ms, {b / 1e9:.3f} GB moved, "
            f"{b / t / 1e9:.1f} GB/s = {b / t / peak:.1%} of "
            f"{peak / 1e12:.2f} TB/s")
    return t_enc, t_dec


def phase_f32(n=512, tol=1e-5):
    from bench import make_field
    from waverange.core import codec

    fld = make_field(n).astype(np.float32)
    maxabs = float(np.abs(fld).max())
    warm_encode(fld.shape, np.float32)
    e, t_e = clock(codec.encode_field, fld, tol, backend="jax",
                   precision="native")
    warm_decode(fld.shape, np.float64, [e.nlay])
    d, t_d = clock(codec.decode_field, e, backend="jax")
    dn = codec.decode_field(e, backend="native")
    err, err_n = linf(d, fld), linf(dn, fld)
    bound = 1.3 * tol * maxabs
    say(f"[{CARD}] f32 path {n}^3 tol {tol:g}: encode {t_e:.4f} s, decode "
        f"{t_d:.4f} s (end to end), nlay {e.nlay}, ratio "
        f"{e.ntot_enc / fld.nbytes:.6f}, L-inf device {err:.6e}, native "
        f"decoder {err_n:.6e}, bound {bound:.6e}")
    if max(err, err_n) > bound:
        raise AssertionError(f"f32 round trip error {max(err, err_n):.6e} "
                             f"> {bound:.6e}")
    for dtype in (np.float32, np.float64):
        t_step, t_dstep = stage_table(fld, dtype, tol)
        if dtype == np.float32:
            say(f"  f32 device steps are {t_step / t_e:.1%} of the end-to-"
                f"end encode and {t_dstep / t_d:.1%} of the decode")


# ---------------------------------------------------------------------------
# Phase 5: v2 device entropy (XLA rANS scan)
# ---------------------------------------------------------------------------

def phase_rans(n=256, tol=1e-7):
    import jax
    import jax.numpy as jnp
    from bench import make_field
    from waverange import native as wn
    from waverange.core import codec
    from waverange.ops import rans
    from waverange.ops.quant import encode_step

    fld = make_field(n)
    size = fld.size
    out = encode_step(jnp.asarray(fld), tol)
    nlay = int(out[3])
    planes = out[0][:nlay]
    host = np.asarray(planes)
    want = [wn.encode_plane(p, coder=1) for p in host]
    got = rans.encode_planes_device(planes, size)
    if got != want:
        raise AssertionError("device rANS streams != C++ turbo coder")
    _, t_enc = clock(rans.encode_planes_device, planes, size)
    back = np.asarray(rans.decode_planes_device(want, size))
    if not np.array_equal(back, host):
        raise AssertionError("device rANS decode is not symbol-exact")
    _, t_dec = clock(lambda: jax.block_until_ready(
        rans.decode_planes_device(want, size)))
    syms = nlay * size
    say(f"[{CARD}] rANS scan {n}^3 f64 tol {tol:g}: {nlay} planes, "
        f"{syms} symbols -> {sum(map(len, want))} bytes; encode "
        f"{t_enc:.4f} s ({syms / t_enc / 1e6:.1f} Msym/s), decode "
        f"{t_dec:.4f} s ({syms / t_dec / 1e6:.1f} Msym/s); byte-identical "
        f"to the C++ turbo coder")
    e = codec.encode_field(fld, tol, backend="jax", coder="rans",
                           entropy="device")
    eh = codec.encode_field(fld, tol, backend="jax", coder="rans")
    if e.data != eh.data:
        raise AssertionError("entropy='device' != entropy='host' stream")
    d = codec.decode_field(e, backend="jax", entropy="device")
    err, bound = linf(d, fld), 1.3 * tol * float(np.abs(fld).max())
    say(f"  codec coder='rans' entropy='device': L-inf {err:.6e}, bound "
        f"{bound:.6e}")
    if err > bound:
        raise AssertionError("device-entropy round trip out of contract")

    rng = np.random.default_rng(7)
    cases = {
        "normal": rng.normal(128, 20, 200000).clip(0, 255).astype(np.uint8),
        "raw escape": rng.integers(0, 256, 200000, np.uint8),
        "constant": np.full(130000, 9, np.uint8),
        "sparse": (rng.random(200000) < 0.02).astype(np.uint8),
        "exact blocks": rng.normal(100, 40, 2 * 65536).clip(0, 255)
        .astype(np.uint8),
    }
    for k in (225, 235, 240):
        cases[f"near-raw k={k}"] = rng.integers(0, k, 2 * 65536) \
            .astype(np.uint8)
    for name, data in cases.items():
        s = rans.encode_planes_device(jnp.asarray(data[None, :]),
                                      data.size)[0]
        if s != wn.encode_plane(data, coder=1):
            raise AssertionError(f"{name}: device stream != C++ stream")
        b = np.asarray(rans.decode_planes_device([s], data.size))[0]
        if not np.array_equal(b, data):
            raise AssertionError(f"{name}: decode is not symbol-exact")
    say(f"  distribution cases byte-identical and symbol-exact: "
        f"{', '.join(cases)}")


# ---------------------------------------------------------------------------
# Phase 6: exact64
# ---------------------------------------------------------------------------

def phase_exact64(n=32, tol=1e-16):
    from bench import make_field
    from waverange import native as wn
    from waverange.core import exact64

    a = np.ascontiguousarray(make_field(64)[:n, :n, :n])
    got, t_e = clock(exact64.encode_field_exact64, a, tol, entropy="host",
                     coder=1)
    want = wn.encode_field(a, wtflag=1, cutoff=np.array([tol]), coder=1)
    if not (got["nlay"] == want["nlay"] and got["data"] == want["data"]
            and np.array_equal(got["deps_vec"], want["deps_vec"])):
        raise AssertionError("exact64 stream != native stream")
    dec, t_d = clock(exact64.decode_field_exact64, got, a.shape,
                     entropy="host", coder=1)
    dref = wn.decode_field(want, a.shape, coder=1)
    if not np.array_equal(dec.view(np.uint64), dref.view(np.uint64)):
        raise AssertionError("exact64 decode != native decode (bitwise)")
    say(f"[{CARD}] exact64 {n}^3 tol {tol:g}: stream and decode "
        f"bit-identical to native; encode {t_e:.2f} s, decode {t_d:.2f} s "
        f"(first calls, compilation included)")


# ---------------------------------------------------------------------------
# Four cards: the sharded path
# ---------------------------------------------------------------------------

def on_devices(arr):
    return len({s.device for s in arr.addressable_shards})


def phase_four_cards(n=512, tol=1e-5, ncards=4):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bench import make_field
    from waverange import native as wn
    from waverange.core import codec
    from waverange.parallel import mesh as M

    if len(jax.devices()) < ncards:
        raise AssertionError(f"{len(jax.devices())} devices, need {ncards}")
    mesh = M.make_mesh(ncards)
    f = make_field(n)
    # four fields of one FluSI file's shape (ux, uy, uz, p)
    fields = np.stack([f, 0.5 * f[::-1], f.transpose(0, 2, 1),
                       0.1 * f * f])
    sh = NamedSharding(mesh, P(mesh.axis_names[0]))
    xs = jax.device_put(jnp.asarray(fields), sh)
    planes = M._encode_batch(xs, jnp.asarray(tol), jnp.asarray(1.75),
                             jnp.asarray(255.0))[0]
    if on_devices(xs) != ncards or on_devices(planes) != ncards:
        raise AssertionError("the field batch does not span the mesh")
    del xs, planes
    encs, t_e = clock(M.encode_fields_sharded, fields, tol, mesh=mesh)
    dec, t_d = clock(M.decode_fields_sharded, encs, mesh=mesh)
    singles = [codec.encode_field(fields[b], tol, backend="jax")
               for b in range(len(fields))]
    for b, (e, s) in enumerate(zip(encs, singles)):
        if e.data != s.data or e.nlay != s.nlay:
            raise AssertionError(f"field {b}: sharded stream != single-card")
        err = linf(dec[b], fields[b])
        bound = 1.3 * tol * float(np.abs(fields[b]).max())
        if err > bound:
            raise AssertionError(f"field {b}: error {err:.6e} > {bound:.6e}")
    say(f"[{CARD}] {ncards} cards: encode_fields_sharded of "
        f"{len(fields)} {n}^3 f64 fields at tol {tol:g} {t_e:.4f} s, "
        f"decode_fields_sharded {t_d:.4f} s; streams byte-equal to the "
        f"single-card encode, decodes within the contract")

    fld = fields[0]
    single = singles[0]
    slabs = jax.device_put(jnp.asarray(fld), sh)
    if on_devices(slabs) != ncards:
        raise AssertionError("z-slabs do not span the mesh")
    for name, build in (("united_encode_step", M.united_encode_step),
                        ("distributed_encode_step",
                         M.distributed_encode_step)):
        step = build(mesh, fld.shape)
        out, t = best_time(step, slabs, tol, reps=3)
        nl = int(out[3])
        payload, _ = wn.encode_planes_batch(np.asarray(out[0][:nl]))
        if nl != single.nlay or payload != single.data:
            raise AssertionError(f"{name}: planes != single-card planes")
        say(f"[{CARD}] {ncards} cards: {name} {n}^3 f64 z-sharded: "
            f"{t * 1e3:.3f} ms on device, planes byte-equal to the "
            f"single-card encode (planes on {on_devices(out[0])} devices)")
    dstep = M.distributed_decode_step(mesh, fld.shape)
    rec, t = best_time(dstep, out[0][:nl], out[1][:nl], out[2][:nl], reps=3)
    err = linf(np.asarray(rec), fld)
    bound = 1.3 * tol * float(np.abs(fld).max())
    say(f"[{CARD}] {ncards} cards: distributed_decode_step {n}^3: "
        f"{t * 1e3:.3f} ms on device, L-inf {err:.6e}, bound {bound:.6e}, "
        f"output on {on_devices(rec)} devices")
    if err > bound:
        raise AssertionError("distributed decode out of contract")


# ---------------------------------------------------------------------------

def run_phases(phases):
    """Run each (name, fn) phase; return the names of those that failed."""
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failed.append(name)
        say(f"phase {name}: {'FAILED' if name in failed else 'passed'} "
            f"({time.perf_counter() - t0:.1f} s)")
    return failed


def main(argv=None):
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    try:
        from waverange.device import configure_jax, platform
    except ImportError as e:
        print(f"chip_smoke.py: the waverange package is not beside it "
              f"({e})", file=sys.stderr)
        return 2
    configure_jax()
    import jax

    # phase 1: the device check
    if platform() != "gpu":
        print(f"chip_smoke.py: the default JAX device is "
              f"{jax.devices()[0].platform}, not a GPU", file=sys.stderr)
        return 1
    from bench import card

    dev = jax.devices()[0]
    CARD = card()
    say(f"card: {CARD}")
    say(f"device: {dev.platform} {dev.device_kind}, {len(jax.devices())} "
        f"visible; jax {jax.__version__}")
    if args.four_cards:
        phases = [("four cards", phase_four_cards)]
    else:
        phases = [("2 main path", phase_main_path), ("3 CLI", phase_cli),
                  ("4 f32 path", phase_f32), ("5 rANS scan", phase_rans),
                  ("6 exact64", phase_exact64)]
    failed = run_phases(phases)
    if failed:
        print(f"chip_smoke.py: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    say(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
