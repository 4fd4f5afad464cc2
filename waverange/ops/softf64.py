"""Software IEEE-754 binary64 arithmetic in pure uint32 vector ops.

Why: a device whose f64 is not IEEE binary64 in the reference's operation
order (no f64 unit, an emulated f64, or contracted multiply-adds) breaks
the codec's bit-exactness contract at near-lossless tolerances (the
whole pipeline is normatively f64 — reference wrappers.cpp operates on
double*, decode accumulate wrappers.cpp:512-514).
This module implements correctly-rounded (round-to-nearest-even) binary64
add/mul — the only per-element f64 ops the codec needs; all scalar
parameters (deps, minval, 1/deps, tolabs) are computed on the host in
real IEEE doubles — plus comparisons and u8<->f64 conversions, using only
32-bit integer ops (and 16x16->32 partial products), all of which are
exact on every backend.

Representation: a "soft double" is a pair of u32 arrays (hi, lo) holding
the IEEE bit pattern (hi = sign|exp|mant[51:32], lo = mant[31:0]).

Rounding follows the classic softfloat recipe: significands carried in a
64-bit frame (u32 pair) with the 53-bit result at bit offset 10, jamming
shifted-out bits into bit 0, and a 10-bit RNE rounding field. Subnormals
(gradual underflow) are fully supported in both directions; +-0 and
+-inf behave per IEEE for the operations used here. NaNs propagate as
*some* NaN (payloads are not preserved); the codec pipeline is NaN-free
by construction (the reference's fmin/fmax scans assume the same).

Performance: ~10^2 integer ops per f64 op. This is the CORRECTNESS path
(device bit-exactness at f64); the throughput path is the XLA f64
device path. See ops/wavelet_soft64.py for the lifting built on this.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32


def _u(x):
    return jnp.asarray(x, _U32)


_ZERO = np.uint32(0)
_ONE = np.uint32(1)


# ---------------------------------------------------------------------------
# u64-as-u32-pair primitives (all elementwise, branch-free)
# ---------------------------------------------------------------------------

def _add64(ah, al, bh, bl):
    l = al + bl
    carry = (l < al).astype(_U32)
    return ah + bh + carry, l


def _sub64(ah, al, bh, bl):
    borrow = (al < bl).astype(_U32)
    return ah - bh - borrow, al - bl


def _shl64(h, l, k):
    """(h,l) << k for per-element k in [0, 63]."""
    k = k.astype(_U32)
    big = k >= 32
    ks = jnp.where(big, k - 32, k)          # [0,31]
    # small-shift form; (l >> (32-k)) guarded for k == 0
    hi_small = (h << ks) | jnp.where(ks > 0, l >> (_u(32) - ks), _u(0))
    lo_small = l << ks
    hi_big = l << ks
    return jnp.where(big, hi_big, hi_small), jnp.where(big, _u(0), lo_small)


def _shr64_jam(h, l, k):
    """(h,l) >> k with all shifted-out bits ORed into bit 0 (jam).
    Per-element k >= 0; k >= 64 yields (0, (h|l) != 0)."""
    k = k.astype(_U32)
    huge = k >= 64
    big = (k >= 32) & ~huge
    ks = jnp.where(big, k - 32, jnp.where(huge, _u(0), k))  # [0,31]
    # small shift (k in [0,31])
    lo_s = jnp.where(ks > 0, (l >> ks) | (h << (_u(32) - ks)), l)
    hi_s = h >> ks
    lost_s = jnp.where(ks > 0, (l << (_u(32) - ks)) != 0, False)
    # big shift (k in [32,63]) : result = h >> (k-32)
    lo_b = h >> ks
    lost_b = (l != 0) | jnp.where(ks > 0, (h << (_u(32) - ks)) != 0, False)
    h_out = jnp.where(big | huge, _u(0), hi_s)
    l_out = jnp.where(huge, _u(0), jnp.where(big, lo_b, lo_s))
    lost = jnp.where(huge, (h | l) != 0, jnp.where(big, lost_b, lost_s))
    return h_out, l_out | lost.astype(_U32)


def _clz32(x):
    n = jnp.full(x.shape, 0, _U32)
    for shift, mask in ((16, _u(0xFFFF0000)), (8, _u(0xFF000000)),
                        (4, _u(0xF0000000)), (2, _u(0xC0000000)),
                        (1, _u(0x80000000))):
        empty = (x & mask) == 0
        n = jnp.where(empty, n + shift, n)
        x = jnp.where(empty, x << shift, x)
    return jnp.where(x == 0, _u(32), n)


def _clz64(h, l):
    return jnp.where(h != 0, _clz32(h), _u(32) + _clz32(l))


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def pack(x) -> tuple[jax.Array, jax.Array]:
    """numpy/jax f64 array -> (hi, lo) u32 bit-pattern pair."""
    b = np.ascontiguousarray(np.asarray(x, np.float64)).view(np.uint64)
    return (jnp.asarray((b >> 32).astype(np.uint32)),
            jnp.asarray(b.astype(np.uint32)))


def unpack(h, l) -> np.ndarray:
    """(hi, lo) pair -> numpy f64 array."""
    b = (np.asarray(h).astype(np.uint64) << 32) | np.asarray(l)
    return b.view(np.float64)


def from_scalar(x: float, shape=()) -> tuple[jax.Array, jax.Array]:
    b = np.float64(x).view(np.uint64)
    return (jnp.broadcast_to(_u(np.uint32(b >> 32)), shape),
            jnp.broadcast_to(_u(np.uint32(b & 0xFFFFFFFF)), shape))


# ---------------------------------------------------------------------------
# rounding core: 64-bit frame, 53-bit result at offset 10, RNE
# ---------------------------------------------------------------------------

def _round_pack(sign, exp, fh, fl):
    """softfloat roundPackToF64: (fh,fl) is the significand frame with the
    candidate 53-bit mantissa (implicit bit included) at bits [62:10]
    (frame < 2^63), bit 0 may be a jam. `exp` follows the softfloat
    convention: ONE LESS than the candidate's true biased exponent, so the
    positional encoding add below carries the implicit bit into the
    exponent field (and a rounding carry to 2^53 bumps it once more).
    exp < 0 means subnormal: shift right with jam by -exp first, encode
    with exponent field 0. Returns (hi, lo)."""
    exp = exp.astype(jnp.int32)
    # subnormal squeeze
    need = exp < 0
    shift = jnp.where(need, (-exp).astype(_U32), _u(0))
    fh2, fl2 = _shr64_jam(fh, fl, shift)
    fh = jnp.where(need, fh2, fh)
    fl = jnp.where(need, fl2, fl)
    exp = jnp.where(need, jnp.int32(0), exp)

    round_bits = fl & _u(0x3FF)
    fh, fl = _add64(fh, fl, _u(0), _u(0x200))
    # ties-to-even: if round bits were exactly 0x200, clear result lsb
    tie = round_bits == _u(0x200)
    # result = frame >> 10 (53 bits incl. implicit at bit 52)
    rl = (fl >> 10) | (fh << 22)
    rh = fh >> 10
    rl = jnp.where(tie, rl & ~_u(1), rl)
    # positional pack: implicit bit (2^52) adds 1 to the exponent field,
    # a carry to 2^53 adds 2; subnormal (no bit 52) leaves field 0.
    rh = rh + (exp.astype(_U32) << 20)
    # overflow to infinity
    over = rh >= _u(0x7FF00000)
    rh = jnp.where(over, _u(0x7FF00000), rh)
    rl = jnp.where(over, _u(0), rl)
    return (sign << 31) | rh, rl


# ---------------------------------------------------------------------------
# add / sub
# ---------------------------------------------------------------------------

def _fields(h, l):
    sign = h >> 31
    exp = (h >> 20) & _u(0x7FF)
    mh = h & _u(0xFFFFF)
    return sign, exp, mh, l


def add(ah, al, bh, bl):
    """Correctly rounded a + b."""
    sa, ea, mha, mla = _fields(ah, al)
    sb, eb, mhb, mlb = _fields(bh, bl)

    # magnitude order on raw bit patterns (finite: bit order == mag order)
    maga_h, magb_h = ah & _u(0x7FFFFFFF), bh & _u(0x7FFFFFFF)
    a_ge = (maga_h > magb_h) | ((maga_h == magb_h) & (al >= bl))
    xh = jnp.where(a_ge, ah, bh)
    xl = jnp.where(a_ge, al, bl)
    yh = jnp.where(a_ge, bh, ah)
    yl = jnp.where(a_ge, bl, al)
    sx, ex, mhx, mlx = _fields(xh, xl)
    sy, ey, mhy, mly = _fields(yh, yl)
    sub_op = sx != sy

    # significands with implicit bit, effective exponents
    impx = (ex != 0).astype(_U32)
    impy = (ey != 0).astype(_U32)
    fxh = mhx | (impx << 20)
    fyh = mhy | (impy << 20)
    Ex = jnp.maximum(ex, _u(1)).astype(_U32)
    Ey = jnp.maximum(ey, _u(1)).astype(_U32)
    d = Ex - Ey

    # frames at offset 10: 53-bit sig -> bits [62:10]
    FXh, FXl = _shl64(fxh, mlx, jnp.broadcast_to(_u(10), fxh.shape))
    FYh, FYl = _shl64(fyh, mly, jnp.broadcast_to(_u(10), fyh.shape))
    FYh, FYl = _shr64_jam(FYh, FYl, d)

    # add magnitudes
    Ah, Al = _add64(FXh, FXl, FYh, FYl)
    a_carry = Ah >= _u(0x80000000)  # frame reached 2^63: shift back 1
    Ah2, Al2 = _shr64_jam(Ah, Al, jnp.broadcast_to(_u(1), Ah.shape))
    add_h = jnp.where(a_carry, Ah2, Ah)
    add_l = jnp.where(a_carry, Al2, Al)
    add_e = Ex.astype(jnp.int32) + a_carry.astype(jnp.int32)

    # subtract magnitudes (X >= Y so no borrow)
    Sh, Sl = _sub64(FXh, FXl, FYh, FYl)
    # normalize: candidate bit at position 62; cancellation only when
    # d <= 1 (jam-free, exact), so a big left shift never moves a jam bit
    nlz = _clz64(Sh, Sl) - _u(1)  # shift to put msb at bit 62
    # don't shift below exponent 1 (gradual underflow, exact)
    max_shift = (Ex - _u(1)).astype(jnp.int32)
    shl = jnp.minimum(nlz.astype(jnp.int32),
                      jnp.maximum(max_shift, 0)).astype(_U32)
    zero_s = (Sh | Sl) == 0
    shl = jnp.where(zero_s, _u(0), shl)
    Sh, Sl = _shl64(Sh, Sl, shl)
    sub_e = Ex.astype(jnp.int32) - shl.astype(jnp.int32)

    rh_s = jnp.where(sub_op, Sh, add_h)
    rl_s = jnp.where(sub_op, Sl, add_l)
    # softfloat convention: pass true biased exponent minus one
    re = jnp.where(sub_op, sub_e, add_e) - jnp.int32(1)
    rsign = sx  # exact-zero result handled below

    oh, ol = _round_pack(rsign, re, rh_s, rl_s)
    # exact zero from subtraction: +0 (RNE), even for (-x) + x
    exact_zero = sub_op & zero_s
    oh = jnp.where(exact_zero, _u(0), oh)
    ol = jnp.where(exact_zero, _u(0), ol)

    # special cases: any exp == 0x7FF (inf/nan) -> propagate
    spec_a = ea == _u(0x7FF)
    spec_b = eb == _u(0x7FF)
    nan_a = spec_a & ((mha | mla) != 0)
    nan_b = spec_b & ((mhb | mlb) != 0)
    # inf + (-inf) -> NaN
    inf_cancel = spec_a & spec_b & ~nan_a & ~nan_b & (sa != sb)
    any_nan = nan_a | nan_b | inf_cancel
    qnan_h, qnan_l = _u(0x7FF80000), _u(0)
    spec = spec_a | spec_b
    sp_h = jnp.where(spec_a, ah, bh)
    sp_l = jnp.where(spec_a, al, bl)
    oh = jnp.where(spec, jnp.where(any_nan, qnan_h, sp_h), oh)
    ol = jnp.where(spec, jnp.where(any_nan, qnan_l, sp_l), ol)
    return oh, ol


def neg(h, l):
    return h ^ _u(0x80000000), l


def sub(ah, al, bh, bl):
    nbh, nbl = neg(bh, bl)
    return add(ah, al, nbh, nbl)


# ---------------------------------------------------------------------------
# mul
# ---------------------------------------------------------------------------

def _mul_53x53(fah, fal, fbh, fbl):
    """106-bit product of two 53-bit significands, via 16-bit limbs.

    Inputs: (fah: bits 52..32, fal: bits 31..0) x2.
    Returns four u32 words p3..p0 (p3 = bits 127..96, ...), with the
    product occupying bits [105:0]."""
    a = [fal & _u(0xFFFF), fal >> 16, fah & _u(0xFFFF), fah >> 16]
    b = [fbl & _u(0xFFFF), fbl >> 16, fbh & _u(0xFFFF), fbh >> 16]
    # column sums of 16-bit half-products: each column accumulates the
    # low and high halves separately so u32 never overflows (<= 8 terms
    # of <= 0xFFFF plus carries < 2^20).
    cols = [jnp.zeros_like(fal) for _ in range(9)]
    for i in range(4):
        for j in range(4):
            p = a[i] * b[j]
            cols[i + j] = cols[i + j] + (p & _u(0xFFFF))
            cols[i + j + 1] = cols[i + j + 1] + (p >> 16)
    # carry propagate into 8 u16 limbs
    limbs = []
    carry = jnp.zeros_like(fal)
    for c in cols[:8]:
        s = c + carry
        limbs.append(s & _u(0xFFFF))
        carry = s >> 16
    p0 = limbs[0] | (limbs[1] << 16)
    p1 = limbs[2] | (limbs[3] << 16)
    p2 = limbs[4] | (limbs[5] << 16)
    p3 = limbs[6] | (limbs[7] << 16)
    return p3, p2, p1, p0


def mul(ah, al, bh, bl):
    """Correctly rounded a * b."""
    sa, ea, mha, mla = _fields(ah, al)
    sb, eb, mhb, mlb = _fields(bh, bl)
    sign = sa ^ sb

    # normalize subnormal inputs (implicit bit position 52)
    def norm(e, mh, ml):
        isnorm = e != 0
        fh = mh | (isnorm.astype(_U32) << 20)
        nlz = _clz64(fh, ml) - _u(11)  # leading zeros below bit 52
        shift = jnp.where(isnorm, _u(0), nlz)
        fh, fl = _shl64(fh, ml, shift)
        eeff = jnp.where(isnorm, e.astype(jnp.int32),
                         jnp.int32(1) - shift.astype(jnp.int32))
        return eeff, fh, fl

    eA, fAh, fAl = norm(ea, mha, mla)
    eB, fBh, fBl = norm(eb, mhb, mlb)

    p3, p2, p1, p0 = _mul_53x53(fAh, fAl, fBh, fBl)
    # product P in [2^104, 2^106); take a 63-bit frame with the candidate
    # mantissa msb at bit 62, jamming everything below.
    big = ((p3 >> 9) & _u(1)) != 0  # bit 105 set
    # P >> 43 (big): frame msb 105-43 = 62. High u32 = P bits [106..75],
    # low = bits [74..43], jam = bits [42..0].
    h43 = (p3 << 21) | (p2 >> 11)
    l43 = (p2 << 21) | (p1 >> 11)
    lost43 = (p0 != 0) | ((p1 << 21) != 0)
    l43 = l43 | lost43.astype(_U32)
    # P >> 42 (small): frame msb 104-42 = 62
    h42 = (p3 << 22) | (p2 >> 10)
    l42 = (p2 << 22) | (p1 >> 10)
    lost42 = (p0 != 0) | ((p1 << 22) != 0)
    l42 = l42 | lost42.astype(_U32)

    fh = jnp.where(big, h43, h42)
    fl = jnp.where(big, l43, l42)
    # true biased exponent of the candidate is eA+eB-1023 (+1 if big);
    # _round_pack takes one less (softfloat convention)
    exp = eA + eB - jnp.int32(1024) + big.astype(jnp.int32)

    oh, ol = _round_pack(sign, exp, fh, fl)

    # zeros: either input zero (after field check) -> signed zero
    zero_a = (ea == 0) & ((mha | mla) == 0)
    zero_b = (eb == 0) & ((mhb | mlb) == 0)
    any_zero = zero_a | zero_b
    oh = jnp.where(any_zero, sign << 31, oh)
    ol = jnp.where(any_zero, _u(0), ol)

    # specials
    spec_a = ea == _u(0x7FF)
    spec_b = eb == _u(0x7FF)
    nan_a = spec_a & ((mha | mla) != 0)
    nan_b = spec_b & ((mhb | mlb) != 0)
    inf_times_zero = (spec_a & zero_b) | (spec_b & zero_a)
    any_nan = nan_a | nan_b | inf_times_zero
    spec = spec_a | spec_b
    inf_h = (sign << 31) | _u(0x7FF00000)
    oh = jnp.where(spec, jnp.where(any_nan, _u(0x7FF80000), inf_h), oh)
    ol = jnp.where(spec, _u(0), ol)
    return oh, ol


# ---------------------------------------------------------------------------
# comparisons / conversions
# ---------------------------------------------------------------------------

def _ordkey(h, l):
    """Monotone (h', l') key: integer order == float order (NaN-free)."""
    neg_ = (h >> 31) != 0
    h2 = jnp.where(neg_, ~h, h | _u(0x80000000))
    l2 = jnp.where(neg_, ~l, l)
    return h2, l2


def less(ah, al, bh, bl):
    ka_h, ka_l = _ordkey(ah, al)
    kb_h, kb_l = _ordkey(bh, bl)
    return (ka_h < kb_h) | ((ka_h == kb_h) & (ka_l < kb_l))


def minimum(ah, al, bh, bl):
    a_lt = less(ah, al, bh, bl)
    return jnp.where(a_lt, ah, bh), jnp.where(a_lt, al, bl)


def maximum(ah, al, bh, bl):
    a_lt = less(ah, al, bh, bl)
    return jnp.where(a_lt, bh, ah), jnp.where(a_lt, bl, al)


def reduce_min(h, l):
    kh, kl = _ordkey(h, l)
    # lexicographic argmin via combined u64 ordering on sorted pieces:
    # reduce hi first, then lo among ties
    mh = jnp.min(kh)
    ties = kh == mh
    ml = jnp.min(jnp.where(ties, kl, _u(0xFFFFFFFF)))
    return _ordkey_inv(mh, ml)


def reduce_max(h, l):
    kh, kl = _ordkey(h, l)
    mh = jnp.max(kh)
    ties = kh == mh
    ml = jnp.max(jnp.where(ties, kl, _u(0)))
    return _ordkey_inv(mh, ml)


def _ordkey_inv(h2, l2):
    neg_ = (h2 >> 31) == 0
    h = jnp.where(neg_, ~h2, h2 & _u(0x7FFFFFFF))
    l = jnp.where(neg_, ~l2, l2)
    return h, l


def from_u8(q):
    """Exact uint8 -> f64 (0..255)."""
    q32 = q.astype(_U32)
    nz = q32 != 0
    # e = 7 - clz8; mantissa = q << (52 - e) without implicit bit
    lz = _clz32(q32) - _u(24)          # leading zeros within 8 bits
    e = _u(7) - lz                      # floor(log2 q) for q != 0
    exp = jnp.where(nz, _u(1023) + e, _u(0))
    # shift q left so its msb lands at bit 52: total shift = 52 - e
    sh = _u(52) - e
    fh, fl = _shl64(q32 * 0, q32, jnp.where(nz, sh, _u(0)))
    mh = fh & _u(0xFFFFF)               # drop the implicit bit
    return (exp << 20) | mh, jnp.where(nz, fl, _u(0))


def to_u8_trunc(h, l):
    """C-style (unsigned char)(double) truncation for values in [0, 256).
    Negative inputs and values >= 256 are the caller's contract (the
    quantizer guarantees [0, 255.5] + 0.5-rounding bias)."""
    exp = ((h >> 20) & _u(0x7FF)).astype(jnp.int32)
    e = exp - jnp.int32(1023)
    frac_h = (h & _u(0xFFFFF)) | _u(0x100000)  # implicit bit at 20
    # integer part = sig53 >> (52 - e) for 0 <= e <= 7
    sh = (_u(52) - e.astype(_U32)) - _u(32)    # shift within hi word + lo
    # sig53 >> (52-e): since e <= 7, result fits in 8 bits and comes from
    # the hi word: frac_h >> (20 - e)
    val = frac_h >> (_u(20) - jnp.clip(e, 0, 8).astype(_U32))
    val = jnp.where(e < 0, _u(0), val)
    del sh
    return val.astype(jnp.uint8)


def mul_const(h, l, c: float):
    """a * c with a compile-time scalar constant."""
    ch, cl = from_scalar(c, h.shape)
    return mul(h, l, ch, cl)
