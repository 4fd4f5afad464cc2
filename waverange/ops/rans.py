"""Device-side turbo (format v2) interleaved-rANS entropy coder.

Format oracle: the C++ turbo coder in ``native/src/wr_native.cc``
(``turbo::encode_plane_t`` / ``turbo::decode_plane_t``).  Streams produced
here are byte-identical to the C++ coder and vice versa — the A/B tests in
``tests/test_rans_device.py`` pin this on every distribution/shape class.
(The v2 format itself is this repo's own opt-in design; the reference
range coder — /root/reference/src/rangecod/rangecod.c:182-207 — is a
sequential carry chain and cannot run wide, which is exactly why v2 was
designed 8-lane interleaved with a static per-block model.)

Design
------
* Every 65536-symbol block is a self-contained stream (its own normalized
  model, its own 8 lane states stored in the payload head), so a field's
  byte layers map onto thousands of independent blocks: the batch axis is
  the device's parallel axis, with 8 rANS lane states per block.
* The only sequential dependency is the per-block state chain over groups
  of 8 symbols.  It runs as ONE ``lax.scan`` vectorized over all blocks of
  all byte layers at once (up to ~128K lane states advancing per step).
* There is no integer division on device: exact ``floor(x/f)`` is computed
  from two f32 quotient estimates plus exact u32 fix-ups, which makes the
  result independent of the accuracy of the hardware divide (a fast
  float division need not be correctly rounded; the fix-ups tolerate ±2).
* Decode resolves each slot by a sweep over the block's 256-entry
  cumulative table (see ``_decode_scan``).
* Container framing (512-byte model headers, payload lengths) is assembled
  and parsed on the host — it is a few hundred bytes per 64 KiB block; all
  per-symbol work stays on device.

Stream layout per block (see wr_native.cc "Per-plane stream layout"):
a 1-byte tag, then
  tag 0 (modeled): u16 freqs[256] LE (sum = 16384), u32 payload_len LE,
                   payload (8 LE u32 lane states, then u16 words);
  tag 1 (raw):     bs verbatim bytes — chosen iff payload_len + 516 >= bs
                   (the decision is part of the format);
  tag 2 (const):   u8 symbol (single-symbol block).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

PROB_BITS = 14
PROB_SCALE = 1 << PROB_BITS
TBLOCK = 1 << 16
RANS_L = 1 << 16
LANES = 8

_U32 = jnp.uint32
_I32 = jnp.int32


def _u32(x):
    return jnp.asarray(x, _U32)


# ----------------------------------------------------------------------------
# Exact unsigned division on device.
# ----------------------------------------------------------------------------
def _fix_divmod(x, d, q):
    """Exact (q, r) of divmod(x, d) in u32 given an estimate q within ±2.

    All math mod 2^32.  A too-large estimate makes r = x - q*d wrap to the
    top half of the u32 range (requires q*d - x < 2^31, true for every call
    site: d ≤ 2^23 and estimates are within ±2).
    """
    r = x - q * d
    half = _u32(0x80000000)
    for _ in range(2):
        over = r >= half
        q = jnp.where(over, q - _u32(1), q)
        r = jnp.where(over, r + d, r)
        under = jnp.logical_and(r < half, r >= d)
        q = jnp.where(under, q + _u32(1), q)
        r = jnp.where(under, r - d, r)
    return q, r


def _exact_divmod(x, d, split: int):
    """Exact (floor(x/d), x mod d) for u32 vectors, division-free in int.

    Preconditions: 1 ≤ d, d << split ≤ 2^23, true quotient < 2^(2*split).
    Uses two rounds of long division with f32 quotient estimates; the
    integer fix-ups restore exactness, so hardware f32 divide accuracy
    (within a couple ulp) never leaks into the result.
    """
    d1 = d << _u32(split)
    q1 = (x.astype(jnp.float32) / d1.astype(jnp.float32)).astype(_U32)
    q1, r1 = _fix_divmod(x, d1, q1)
    q0 = (r1.astype(jnp.float32) / d.astype(jnp.float32)).astype(_U32)
    q0, r = _fix_divmod(r1, d, q0)
    return (q1 << _u32(split)) + q0, r


# ----------------------------------------------------------------------------
# Model building (histogram + deterministic normalization, wr_native.cc
# turbo::normalize_freqs).
# ----------------------------------------------------------------------------
def _histogram(syms: jax.Array, bs: jax.Array) -> jax.Array:
    """Per-block 256-bin histograms. syms (B, TBLOCK) u8, bs (B,) i32."""
    B, N = syms.shape
    pos = jnp.arange(N, dtype=_I32)[None, :]
    active = pos < bs[:, None]
    s = syms.astype(_I32)
    ids = jnp.where(active, s, 256)  # pads land in a dropped bin
    counts = jnp.zeros((B, 257), _I32).at[
        jnp.broadcast_to(jnp.arange(B, dtype=_I32)[:, None], (B, N)), ids
    ].add(1, mode="drop")
    return counts[:, :256]


def _normalize_freqs(counts: jax.Array, bs: jax.Array) -> jax.Array:
    """Normalize counts to sum exactly PROB_SCALE, replicating the C++
    algorithm bit-for-bit: floor(c*16384/bs) clamped up to 1 for present
    symbols; a deficit goes to the (first) max-count symbol; an excess is
    stolen repeatedly from the (first) max frequency > 1."""
    B = counts.shape[0]
    bs_safe = jnp.maximum(bs, 1).astype(_U32)
    num = counts.astype(_U32) << _u32(PROB_BITS)  # ≤ 2^16 * 2^14 = 2^30
    # quotient ≤ 16384 < 2^14 = 2^(2*7); bs << 7 ≤ 2^23.
    q, _ = _exact_divmod(num, bs_safe[:, None], 7)
    f = jnp.where(counts > 0, jnp.maximum(q.astype(_I32), 1), 0)
    ssum = jnp.sum(f, axis=1, dtype=_I32)
    maxs = jnp.argmax(counts, axis=1).astype(_I32)  # first max
    deficit = jnp.maximum(PROB_SCALE - ssum, 0)
    f = f.at[jnp.arange(B, dtype=_I32), maxs].add(deficit)
    ssum = ssum + deficit

    # Steal loop: ≤255 excess (only the 0→1 clamps overshoot) and each
    # pass takes the whole excess from the current max unless it would
    # drop below 1, so it converges in 1-2 passes for real data (bounded
    # by 255). A while_loop runs only as long as any block has excess.
    def has_excess(state):
        _, ssum = state
        return jnp.any(ssum > PROB_SCALE)

    def steal(state):
        f, ssum = state
        excess = ssum - PROB_SCALE
        eligible = jnp.where(f > 1, f, 0)
        b = jnp.argmax(eligible, axis=1).astype(_I32)  # first max, freq > 1
        fb = f[jnp.arange(B, dtype=_I32), b]
        take = jnp.clip(jnp.minimum(fb - 1, excess), 0)
        f = f.at[jnp.arange(B, dtype=_I32), b].add(-take)
        return f, ssum - take

    f, _ = jax.lax.while_loop(has_excess, steal, (f, ssum))
    return f


# ----------------------------------------------------------------------------
# Encode: one reverse scan over groups of 8 symbols, all blocks at once.
#
# The scan body is pure vector arithmetic: freq/cum are pre-gathered for
# EVERY symbol position in one bulk gather and packed into one u32 per
# symbol, so no step gathers from a table; per-step operands use an (8, B)
# layout with the block axis minor.
# ----------------------------------------------------------------------------
@partial(jax.jit, static_argnums=(2, 3))
def _encode_scan(syms: jax.Array, bs: jax.Array, G: int, unroll: int):
    """Run the rANS state chains for a batch of blocks.

    Args:
      syms: (B, TBLOCK) uint8, zero-padded past bs.
      bs:   (B,) int32 actual symbol counts (0 < bs ≤ TBLOCK; 0 = dummy).
      G:    number of 8-symbol groups to process (≥ ceil(max(bs)/8)).

    Returns (freqs (B,256) i32, nsym (B,) i32, x_fin (B,8) u32,
             words (G,8,B) u16, emits (G,8,B) bool, nwords (B,) i32).
    """
    B = syms.shape[0]
    counts = _histogram(syms, bs)
    freqs = _normalize_freqs(counts, bs)
    nsym = jnp.sum(counts > 0, axis=1, dtype=_I32)
    cum = jnp.cumsum(freqs, axis=1, dtype=_I32) - freqs  # exclusive (B,256)
    # Pack freq | cum<<16 (both ≤ 16384) and bulk-gather per position.
    etab = freqs.astype(_U32) | (cum.astype(_U32) << _u32(16))
    si = syms[:, : G * 8].astype(_I32)
    e = jnp.take_along_axis(etab, si, axis=1)          # (B, G*8) u32
    eg = e.reshape(B, G, 8).transpose(1, 2, 0)          # (G, 8, B)

    lane = jnp.arange(8, dtype=_I32)[:, None]           # (8, 1)
    bsr = bs[None, :]                                   # (1, B)

    def step(x, xs):
        e, g = xs                                       # e: (8, B) u32
        f = e & _u32(0xFFFF)
        c = e >> _u32(16)
        active = (g * 8 + lane) < bsr
        fs = jnp.maximum(f, _u32(1))  # pads/inactive only; active f ≥ 1
        # Renormalize: emit low u16 while x ≥ f<<18 (wraps to 0 for
        # f = 16384 exactly like the C++ u32 arithmetic; those are
        # single-symbol blocks whose payload is discarded).
        xmax = fs << _u32(18)
        emit = jnp.logical_and(active, x >= xmax)
        word = (x & _u32(0xFFFF)).astype(jnp.uint16)
        x1 = jnp.where(emit, x >> _u32(16), x)
        # x' = (q << 14) + (x - q*f) + cum  with exact q = floor(x/f)
        q, r = _exact_divmod(x1, fs, 9)
        xn = (q << _u32(PROB_BITS)) + r + c
        x = jnp.where(active, xn, x)
        return x, (word, emit)

    x0 = jnp.full((LANES, B), RANS_L, _U32)
    xs = (eg, jnp.arange(G, dtype=_I32))
    # rANS encodes from the last symbol backwards; reverse=True also
    # stacks outputs in natural group order = final stream order.
    x_fin, (words, emits) = jax.lax.scan(step, x0, xs, reverse=True,
                                         unroll=unroll)
    nwords = jnp.sum(emits, axis=(0, 1), dtype=_I32)
    return freqs, nsym, x_fin.T, words, emits, nwords


@partial(jax.jit, static_argnums=(6,))
def _encode_compact(x_fin, words, emits, nsym, bs, wlens, Wcap: int):
    """Scatter per-block payloads into one contiguous u16 stream.

    Stream order per block: 16 lane-state words (lane k low u16 then high
    u16, k ascending — the 8 LE u32 states), then the renorm words in
    stream order (scan already stacked groups in final order; within a
    group ascending lane order matches the C++ scalar loop's descending-i
    `*--w` writes and the SIMD compress-store).
    """
    G, _, B = words.shape
    multi = nsym > 1
    off = jnp.cumsum(wlens, dtype=_I32) - wlens  # exclusive prefix

    st = jnp.stack([x_fin & _u32(0xFFFF), x_fin >> _u32(16)],
                   axis=2).reshape(B, 16).astype(jnp.uint16)
    st_pos = off[:, None] + jnp.arange(16, dtype=_I32)[None, :]
    st_pos = jnp.where(multi[:, None], st_pos, Wcap)

    wm = words.transpose(2, 0, 1).reshape(B, G * 8)
    em = emits.transpose(2, 0, 1).reshape(B, G * 8)
    pos = off[:, None] + 16 + jnp.cumsum(em, axis=1, dtype=_I32) - 1
    valid = jnp.logical_and(em, multi[:, None])
    pos = jnp.where(valid, pos, Wcap)

    out = jnp.zeros((Wcap,), jnp.uint16)
    out = out.at[st_pos.reshape(-1)].set(st.reshape(-1), mode="drop")
    out = out.at[pos.reshape(-1)].set(wm.reshape(-1), mode="drop")
    return out


def _block_batch(planes: list[np.ndarray] | np.ndarray):
    """Split planes into (blocks (B,TBLOCK) u8, bs (B,), plane spans)."""
    if isinstance(planes, np.ndarray) and planes.ndim == 1:
        planes = [planes]
    blocks, bs, spans = [], [], []
    for p in planes:
        p = np.ascontiguousarray(p, np.uint8).ravel()
        n = p.size
        nb = -(-n // TBLOCK) if n else 0
        spans.append((len(blocks), nb, n))
        for ib in range(nb):
            seg = p[ib * TBLOCK:(ib + 1) * TBLOCK]
            bs.append(seg.size)
            if seg.size < TBLOCK:
                seg = np.pad(seg, (0, TBLOCK - seg.size))
            blocks.append(seg)
    if not blocks:
        return np.zeros((0, TBLOCK), np.uint8), np.zeros(0, np.int64), spans
    return np.stack(blocks), np.asarray(bs, np.int64), spans


def _bucket(n: int) -> int:
    """Round up to a power of two to bound jit recompiles."""
    b = 1
    while b < n:
        b <<= 1
    return b


def _assemble_blocks(ibs, bs_h, nsym_h, wlens_h, freqs_h, stream, offs,
                     raw_bytes) -> bytes:
    """Build one plane's container from per-block scan results.

    Tag rules are part of the format (mirrored in wr_native.cc):
    nsym <= 1 -> tag 2 (constant); plen + 516 >= bs -> tag 1 (raw,
    bytes supplied by ``raw_bytes[ib]``); else tag 0 (modeled).
    """
    parts = []
    for ib in ibs:
        if nsym_h[ib] <= 1:
            only = int(np.argmax(freqs_h[ib]))
            parts.append(bytes([2, only]))
            continue
        plen = 2 * int(wlens_h[ib])
        if plen + 516 >= bs_h[ib]:
            parts.append(b"\x01")
            parts.append(raw_bytes[ib])
            continue
        parts.append(b"\x00")
        parts.append(freqs_h[ib].tobytes())
        parts.append(np.uint32(plen).astype("<u4").tobytes())
        parts.append(stream[offs[ib]:offs[ib + 1]].astype("<u2").tobytes())
    return b"".join(parts)


def _raw_candidates(bs_h, nsym_h, wlens_h, nb_total: int):
    """Block ids that the tag rule will emit raw."""
    ids = []
    for ib in range(nb_total):
        if nsym_h[ib] > 1 and 2 * int(wlens_h[ib]) + 516 >= bs_h[ib]:
            ids.append(ib)
    return ids


def encode_planes(planes, unroll: int = 4) -> list[bytes]:
    """Encode u8 symbol planes to format-v2 streams on the default device.

    Byte-identical to ``native.encode_plane(p, coder=1)`` per plane.
    """
    blocks, bs, spans = _block_batch(planes)
    nplanes = len(spans)
    out: list[bytes] = [b""] * nplanes
    B = blocks.shape[0]
    if B == 0:
        return out
    Bpad = _bucket(B)
    if Bpad > B:
        blocks_p = np.pad(blocks, ((0, Bpad - B), (0, 0)))
        bs_p = np.pad(bs, (0, Bpad - B))
    else:
        blocks_p, bs_p = blocks, bs
    G = -(-int(bs_p.max()) // 8)
    bs_d = jnp.asarray(bs_p, _I32)
    freqs, nsym, x_fin, words, emits, nwords = _encode_scan(
        jnp.asarray(blocks_p), bs_d, G, unroll)
    nsym_h = np.asarray(nsym)
    nwords_h = np.asarray(nwords)
    wlens_h = np.where(nsym_h > 1, nwords_h + 16, 0)
    total = int(wlens_h.sum())
    Wcap = _bucket(max(total, 1))
    stream = np.asarray(_encode_compact(
        x_fin, words, emits, nsym, bs_d, jnp.asarray(wlens_h, _I32), Wcap))
    freqs_h = np.asarray(freqs).astype("<u2")
    offs = np.concatenate([[0], np.cumsum(wlens_h)])
    raw_bytes = {ib: blocks[ib, :bs[ib]].tobytes()
                 for ib in _raw_candidates(bs, nsym_h, wlens_h, B)}
    for ip, (b0, nb, n) in enumerate(spans):
        out[ip] = _assemble_blocks(range(b0, b0 + nb), bs, nsym_h, wlens_h,
                                   freqs_h, stream, offs, raw_bytes)
    return out


@partial(jax.jit, static_argnums=(1, 2, 3))
def _blockify(planes: jax.Array, nb: int, Bpad: int, n: int):
    """Device-side split of (L, n) planes into (Bpad, TBLOCK) blocks."""
    L = planes.shape[0]
    p = jnp.pad(planes, ((0, 0), (0, nb * TBLOCK - n)))
    blocks = p.reshape(L * nb, TBLOCK)
    return jnp.pad(blocks, ((0, Bpad - L * nb), (0, 0)))


def _plane_bs(L: int, nb: int, n: int, Bpad: int) -> np.ndarray:
    bs = np.full(L * nb, TBLOCK, np.int64)
    bs[nb - 1::nb] = n - (nb - 1) * TBLOCK
    return np.pad(bs, (0, Bpad - L * nb))


def encode_planes_device(planes: jax.Array, n: int,
                         unroll: int = 4) -> list[bytes]:
    """Encode device-resident (L, n) u8 planes to format-v2 streams.

    Same streams as ``encode_planes`` / ``native.encode_plane(p, coder=1)``
    but the symbols never touch the host: blocks are built on device and
    only the compressed words + per-block models are downloaded.
    """
    L = planes.shape[0]
    if n == 0 or L == 0:
        return [b""] * L
    nb = -(-n // TBLOCK)
    B = L * nb
    Bpad = _bucket(B)
    bs = _plane_bs(L, nb, n, Bpad)
    blocks = _blockify(planes, nb, Bpad, n)
    G = -(-int(bs.max()) // 8)
    bs_d = jnp.asarray(bs, _I32)
    freqs, nsym, x_fin, words, emits, nwords = _encode_scan(
        blocks, bs_d, G, unroll)
    nsym_h = np.asarray(nsym)
    nwords_h = np.asarray(nwords)
    wlens_h = np.where(nsym_h > 1, nwords_h + 16, 0)
    total = int(wlens_h.sum())
    Wcap = _bucket(max(total, 1))
    stream = np.asarray(_encode_compact(
        x_fin, words, emits, nsym, bs_d, jnp.asarray(wlens_h, _I32), Wcap))
    freqs_h = np.asarray(freqs).astype("<u2")
    offs = np.concatenate([[0], np.cumsum(wlens_h)])
    # raw blocks: download the verbatim symbols (same bytes the modeled
    # payload would have cost, so no extra transfer vs pre-tag format)
    raw_ids = _raw_candidates(bs, nsym_h, wlens_h, B)
    raw_bytes = {}
    if raw_ids:
        fetched = np.asarray(blocks[jnp.asarray(raw_ids)])
        for k, ib in enumerate(raw_ids):
            raw_bytes[ib] = fetched[k, :bs[ib]].tobytes()
    out = []
    for ip in range(L):
        out.append(_assemble_blocks(range(ip * nb, (ip + 1) * nb), bs,
                                    nsym_h, wlens_h, freqs_h, stream, offs,
                                    raw_bytes))
    return out


# ----------------------------------------------------------------------------
# Decode: forward scan; per-block slot tables gathered each step.
# ----------------------------------------------------------------------------
@partial(jax.jit, static_argnums=(5, 6))
def _decode_scan(freqs, states, words, wlen, bs, G: int, unroll: int):
    """Decode a batch of multi-symbol blocks.

    Args:
      freqs:  (B,256) i32 model (sum 16384 per block).
      states: (B,8) u32 initial lane states (payload head).
      words:  (B,W) i32 u16 renorm words (payload tail), zero-padded.
      wlen:   (B,) i32 word counts.
      bs:     (B,) i32 symbols per block.
    Returns syms (B, G*8) u8.

    The slot -> (symbol, freq, cum) resolution is a broadcast SWEEP over
    the 256-entry cumulative table (sym = #cum <= slot - 1; cumExcl by
    masked max; cumIncl by masked min) rather than a 16384-entry
    slot-table gather, so each step is fused vector arithmetic with no
    gather from a device-memory table. Zero-frequency symbols share
    their successor's cum and never cover a slot, matching the C++
    symtab construction (wr_native.cc decode_plane_t).
    """
    B = freqs.shape[0]
    cum = jnp.cumsum(freqs, axis=1, dtype=_I32) - freqs  # (B,256) exclusive
    cum_b = cum[:, None, :]                              # (B,1,256)
    lane = jnp.arange(8, dtype=_I32)[None, :]
    W = words.shape[1]

    def step(carry, g):
        x, cur = carry
        slot = (x & _u32(PROB_SCALE - 1)).astype(_I32)   # (B,8)
        mask = cum_b <= slot[:, :, None]                 # (B,8,256)
        sym = jnp.sum(mask, axis=2, dtype=_I32) - 1
        cum_e = jnp.max(jnp.where(mask, cum_b, 0), axis=2)
        cum_i = jnp.min(jnp.where(mask, PROB_SCALE, cum_b), axis=2)
        f = (cum_i - cum_e).astype(_U32)
        s = sym
        offv = (slot - cum_e).astype(_U32)
        active = (g * 8 + lane) < bs[:, None]
        xn = f * (x >> _u32(PROB_BITS)) + offv
        need = jnp.logical_and(active, xn < _u32(RANS_L))
        ni = need.astype(_I32)
        widx = cur[:, None] + jnp.cumsum(ni, axis=1, dtype=_I32) - ni
        can = jnp.logical_and(need, widx < wlen[:, None])
        w = jnp.take_along_axis(words, jnp.clip(widx, 0, W - 1), axis=1)
        xr = jnp.where(can, (xn << _u32(16)) | w.astype(_U32), xn)
        x = jnp.where(active, xr, x)
        cur = cur + jnp.sum(can, axis=1, dtype=_I32)
        return (x, cur), s.astype(jnp.uint8)

    (_, _), syms = jax.lax.scan(
        step, (states, jnp.zeros((B,), _I32)),
        jnp.arange(G, dtype=_I32), unroll=unroll)
    return syms.transpose(1, 0, 2).reshape(B, G * 8)


def _parse_stream(data: bytes, n: int):
    """Walk a v2 container; yields (pos, bsz, tag, freqs, aux) per block:
    tag 0 -> (freqs, payload), tag 1 -> (None, raw bytes),
    tag 2 -> (None, symbol int).

    Corrupt input (truncated container, unknown tag, payload running past
    the buffer) raises ValueError here, at the framing layer — decoded
    SYMBOLS from a bit-flipped but structurally valid stream are garbage
    by contract (the reference range decoder has no integrity check
    either, rangecod.c:282-290), but malformed framing must never
    surface as an IndexError/ValueError from deep inside numpy."""
    mv = memoryview(data)
    total = len(mv)
    pos = 0
    blocks = []
    r = 0
    while pos < n:
        bsz = min(TBLOCK, n - pos)
        if r >= total:
            raise ValueError(
                f"corrupt v2 stream: truncated at block tag "
                f"(offset {r} of {total}, {n - pos} symbols missing)")
        tag = mv[r]
        r += 1
        if tag == 2:
            if r >= total:
                raise ValueError(
                    "corrupt v2 stream: truncated constant block")
            blocks.append((pos, bsz, 2, None, mv[r]))
            r += 1
        elif tag == 1:
            if r + bsz > total:
                raise ValueError(
                    f"corrupt v2 stream: raw block declares {bsz} bytes, "
                    f"{total - r} remain")
            blocks.append((pos, bsz, 1, None, mv[r:r + bsz]))
            r += bsz
        elif tag == 0:
            if r + 516 > total:
                raise ValueError(
                    "corrupt v2 stream: truncated model header "
                    f"({total - r} of 516 bytes)")
            freqs = np.frombuffer(mv[r:r + 512], "<u2")
            r += 512
            plen = int(np.frombuffer(mv[r:r + 4], "<u4")[0])
            r += 4
            if plen and (plen < 32 or r + plen > total):
                raise ValueError(
                    f"corrupt v2 stream: block payload length {plen} "
                    f"invalid ({total - r} bytes remain)")
            blocks.append((pos, bsz, 0, freqs, mv[r:r + plen]))
            r += plen
        else:
            raise ValueError(f"corrupt v2 stream: unknown block tag {tag}")
        pos += bsz
    return blocks


def _parse_to_batch(streams: list[bytes], ns: list[int]):
    """Parse v2 containers into padded device-upload arrays.

    Constant (tag 2) blocks are included with a synthetic single-symbol
    model, zero words, and lane states at RANS_L: the decode scan then
    yields that symbol every step with no renormalization. Raw (tag 1)
    blocks are returned separately — their bytes bypass the scan.
    """
    batch = []  # (plane, pos, bsz, freqs, payload)
    raws = []   # (plane, pos, bsz, raw bytes)
    for ip, (s, n) in enumerate(zip(streams, ns)):
        for pos, bsz, tag, freqs, aux in _parse_stream(s, n):
            if tag == 1:
                raws.append((ip, pos, bsz, aux))
            elif tag == 2:
                f = np.zeros(256, np.int32)
                f[aux] = PROB_SCALE
                batch.append((ip, pos, bsz, f, b""))
            else:
                batch.append((ip, pos, bsz, freqs, aux))
    B = len(batch)
    Bpad = _bucket(max(B, 1))
    maxw = max((max(len(p[4]) - 32, 0)) // 2 for p in batch) if batch else 0
    Wcap = _bucket(max(maxw, 1))
    freqs_a = np.zeros((Bpad, 256), np.int32)
    states_a = np.full((Bpad, 8), RANS_L, np.uint32)
    words_a = np.zeros((Bpad, Wcap), np.uint16)
    wlen_a = np.zeros(Bpad, np.int32)
    bs_a = np.zeros(Bpad, np.int32)
    for i, (ip, pos, bsz, freqs, payload) in enumerate(batch):
        freqs_a[i] = freqs
        bs_a[i] = bsz
        if len(payload):
            states_a[i] = np.frombuffer(payload[:32], "<u4")
            nw = (len(payload) - 32) // 2
            words_a[i, :nw] = np.frombuffer(payload[32:32 + 2 * nw], "<u2")
            wlen_a[i] = nw
    freqs_a[B:, 0] = PROB_SCALE  # benign model for pad rows
    return batch, raws, freqs_a, states_a, words_a, wlen_a, bs_a


def decode_planes_device(streams: list[bytes], n: int,
                         unroll: int = 4) -> jax.Array:
    """Decode L same-length v2 streams to a device-resident (L, n) u8.

    Device mirror of ``encode_planes_device``: only the compressed words,
    per-block models, and raw-block bytes are uploaded; the symbol planes
    stay in device memory for the accumulate/inverse-wavelet stage. Raw
    blocks skip the scan entirely and are scattered into their slots.
    """
    L = len(streams)
    batch, raws, freqs_a, states_a, words_a, wlen_a, bs_a = \
        _parse_to_batch(streams, [n] * L)
    nb = -(-n // TBLOCK)
    drop = L * nb  # out-of-range slot: scatter mode="drop"
    slots_b = np.full(freqs_a.shape[0], drop, np.int32)
    for i, (ip, pos, bsz, _, _) in enumerate(batch):
        slots_b[i] = ip * nb + pos // TBLOCK
    if batch:
        G = -(-int(bs_a.max()) // 8)
        syms = _decode_scan(
            jnp.asarray(freqs_a), jnp.asarray(states_a),
            jnp.asarray(words_a), jnp.asarray(wlen_a), jnp.asarray(bs_a),
            G, unroll)
    else:
        syms = jnp.zeros((1, TBLOCK), jnp.uint8)
        slots_b = np.full(1, drop, np.int32)
    Rpad = _bucket(max(len(raws), 1))
    rawbuf = np.zeros((Rpad, TBLOCK), np.uint8)
    slots_r = np.full(Rpad, drop, np.int32)
    for i, (ip, pos, bsz, rb) in enumerate(raws):
        rawbuf[i, :bsz] = np.frombuffer(rb, np.uint8)
        slots_r[i] = ip * nb + pos // TBLOCK
    return _compose_planes(syms, jnp.asarray(slots_b), jnp.asarray(rawbuf),
                           jnp.asarray(slots_r), L, nb, n)


@partial(jax.jit, static_argnums=(4, 5, 6))
def _compose_planes(syms, slots_b, rawbuf, slots_r, L: int, nb: int,
                    n: int):
    W8 = syms.shape[1]
    if W8 < TBLOCK:
        syms = jnp.pad(syms, ((0, 0), (0, TBLOCK - W8)))
    out = jnp.zeros((L * nb, TBLOCK), jnp.uint8)
    out = out.at[slots_b].set(syms[:, :TBLOCK], mode="drop")
    out = out.at[slots_r].set(rawbuf, mode="drop")
    return out.reshape(L, nb * TBLOCK)[:, :n]


def decode_planes(streams: list[bytes], ns: list[int],
                  unroll: int = 4) -> list[np.ndarray]:
    """Decode format-v2 streams (one per plane) back to u8 symbols.

    Byte-identical to ``native.decode_plane(s, n, coder=1)``.
    """
    outs = [np.empty(n, np.uint8) for n in ns]
    batch, raws, freqs_a, states_a, words_a, wlen_a, bs_a = \
        _parse_to_batch(streams, ns)
    for ip, pos, bsz, rb in raws:
        outs[ip][pos:pos + bsz] = np.frombuffer(rb, np.uint8)
    if not batch:
        return outs
    G = -(-int(bs_a.max()) // 8)
    syms = np.asarray(_decode_scan(
        jnp.asarray(freqs_a), jnp.asarray(states_a), jnp.asarray(words_a),
        jnp.asarray(wlen_a), jnp.asarray(bs_a), G, unroll))
    for i, (ip, pos, bsz, _, _) in enumerate(batch):
        outs[ip][pos:pos + bsz] = syms[i, :bsz]
    return outs
