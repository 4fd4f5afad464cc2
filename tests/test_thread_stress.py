"""Thread-pipeline stress test (VERDICT r1 weak item 7).

The C++ encode/decode pipelines use a bounded slot pool with
condition-variable handoff (wr_native.cc encode_field_t slot logic:
slots = min(8, threads+2), slot reuse waits, opportunistic pairing).
This sweep forces every slot-reuse shape: WR_NUM_THREADS in {1,2,3,8}
(threads=1 -> 3 slots for 8 layers), WR_IL_STREAMS in {1,2,4}
(interleaved coder variants are bit-identical by design), repeated runs
— the encoded bytes and the decode round trip must be identical every
time for both coders.
"""
import os

import numpy as np
import pytest

from waverange import native as wn

from conftest import smooth_field


@pytest.fixture()
def env_guard():
    saved = {k: os.environ.get(k) for k in ("WR_NUM_THREADS",
                                            "WR_IL_STREAMS")}
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.mark.parametrize("coder", [0, 1])
def test_slot_pool_determinism(env_guard, coder):
    rng = np.random.default_rng(7)
    a = smooth_field((48, 40, 56), rng=rng, noise=1e-8)
    cutoff = np.array([1e-16])  # forces nlay = 8 (all slots cycled)
    os.environ["WR_NUM_THREADS"] = "2"
    os.environ["WR_IL_STREAMS"] = "1"
    base = wn.encode_field(a, wtflag=1, cutoff=cutoff, coder=coder)
    assert base["nlay"] == 8
    base_dec = wn.decode_field(base, a.shape, coder=coder)
    for nt in ("1", "2", "3", "8"):
        for il in ("1", "2", "4"):
            os.environ["WR_NUM_THREADS"] = nt
            os.environ["WR_IL_STREAMS"] = il
            for rep in range(2):
                m = wn.encode_field(a, wtflag=1, cutoff=cutoff, coder=coder)
                assert m["data"] == base["data"], (nt, il, rep)
                assert np.array_equal(m["len_enc_vec"],
                                      base["len_enc_vec"]), (nt, il, rep)
                d = wn.decode_field(m, a.shape, coder=coder)
                assert np.array_equal(d, base_dec), (nt, il, rep)


def test_batch_planes_thread_sweep(env_guard):
    """encode_planes_batch / decode_planes_batch across thread counts."""
    rng = np.random.default_rng(3)
    planes = np.clip(rng.normal(128, 40, (8, 70001)), 0,
                     255).astype(np.uint8)
    ref_payload, ref_lens = wn.encode_planes_batch(planes, nthreads=1)
    for nt in (2, 3, 8):
        payload, lens = wn.encode_planes_batch(planes, nthreads=nt)
        assert payload == ref_payload and np.array_equal(lens, ref_lens)
        back = wn.decode_planes_batch(payload, lens, planes.shape[1],
                                      nthreads=nt)
        assert np.array_equal(back, planes)
