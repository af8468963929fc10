"""JPEG back-half on device: dequantize + ISLOW IDCT + fancy h2v2 chroma
upsampling + fixed-point YCbCr->BGR, as one jit-traceable integer graph.

The host-side JPEG cost floor is the inherently sequential Huffman
decode; everything after it is data-parallel fixed-point arithmetic that
belongs on the accelerator. The native loader entropy-decodes only
(io/native/meterelf_jpeg.c mej_read_coefs_region*) and ships a
block-aligned window of raw DCT coefficients; this module finishes the
decode on device with numerics bit-identical to libjpeg's default path
(jidctint.c ISLOW IDCT, jdsample.c h2v2_fancy_upsample, jdcolor.c
fixed-point color conversion) — which is in turn the verified byte-exact
match for the reference's 2019 OpenCV wheel (SURVEY.md §8bis; reference
decode call: meterelf/_image.py:49). Byte-exactness of this graph vs the
native pixel decoder is proven over the whole corpus and under fuzz
(tests/test_jpegdec.py).

Everything is int32 with wraparound semantics matching the C library on
overflow; right shifts are arithmetic; no floats anywhere.

Supported layout: 8-bit baseline YCbCr 4:2:0 (the whole sample corpus).
Files in any other layout fail the coefficient read and take the
pixel-path fallback host-side.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

import jax.numpy as jnp

from ..types import Rect

# ---- ISLOW IDCT constants (jidctint.c; FIX(x) at CONST_BITS=13) ----
_F_0_298631336 = 2446
_F_0_390180644 = 3196
_F_0_541196100 = 4433
_F_0_765366865 = 6270
_F_0_899976223 = 7373
_F_1_175875602 = 9633
_F_1_501321110 = 12299
_F_1_847759065 = 15137
_F_1_961570560 = 16069
_F_2_053119869 = 16819
_F_2_562915447 = 20995
_F_3_072711026 = 25172

_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


class CoefWindow(NamedTuple):
    """Static geometry of a chroma-block-aligned coefficient window
    covering ``meter_rect`` plus the >=2 px margin that preserves fancy
    upsampling's neighbor context (block units are luma 8x8 blocks)."""
    lbx0: int   # window origin, luma blocks (even)
    lby0: int
    lbw: int    # window size, luma blocks (even)
    lbh: int
    ox: int     # crop origin inside the window, luma px
    oy: int
    rw: int     # crop size, luma px
    rh: int
    cw_valid: int  # valid (non-block-padding) chroma samples in window
    ch_valid: int  # — the upsampling clamp bound (= image edge)


def coef_window(rect: Rect, frame_w: int,
                frame_h: int) -> CoefWindow:
    """Window for ``rect`` (types.Rect) in a frame_w x frame_h 4:2:0
    frame. Margin of 2 luma px (1 chroma sample) on every side keeps the
    triangle filter's context; at image edges the filter replicates,
    which the device graph reproduces by clamping sample indices to the
    image bounds mapped into window coordinates."""
    (rx, ry) = rect.top_left
    rw, rh = rect.width, rect.height
    img_cbw = math.ceil(frame_w / 16)   # chroma blocks across the image
    img_cbh = math.ceil(frame_h / 16)
    cx0 = min(max((rx - 2) // 16, 0), img_cbw - 1)
    cy0 = min(max((ry - 2) // 16, 0), img_cbh - 1)
    cx1 = max(min(math.ceil((rx + rw + 2) / 16), img_cbw), cx0 + 1)
    cy1 = max(min(math.ceil((ry + rh + 2) / 16), img_cbh), cy0 + 1)
    img_cw = (frame_w + 1) // 2         # valid chroma samples (image)
    img_ch = (frame_h + 1) // 2
    return CoefWindow(
        lbx0=2 * cx0, lby0=2 * cy0,
        lbw=2 * (cx1 - cx0), lbh=2 * (cy1 - cy0),
        ox=rx - 16 * cx0, oy=ry - 16 * cy0, rw=rw, rh=rh,
        cw_valid=min(8 * (cx1 - cx0), img_cw - 8 * cx0),
        ch_valid=min(8 * (cy1 - cy0), img_ch - 8 * cy0),
    )


def uncompact_plane(arr: jnp.ndarray) -> jnp.ndarray:
    """Compact wire plane -> dense i16 coefficient plane.

    arr [B, R*3/2, C] int8: rows [0, R) are the lo bytes (v & 0xFF),
    rows [R, 3R/2) pack the 4-bit hi parts two plane rows per byte
    (plane row 2r in the low nibble of hi row r, 2r+1 in the high).
    v = sign-extend-12(hi << 8 | lo) — exact for the legal baseline
    coefficient range (the host packer routes out-of-range streams to
    the pixel fallback). Pure elementwise: XLA fuses it into the
    back-half's first consumers (io/jpeg.read_coefs_batch compact=True
    is the producer)."""
    i32 = jnp.int32
    R = arr.shape[-2] * 2 // 3
    lo = arr[..., :R, :].astype(i32) & i32(255)
    hi = arr[..., R:, :].astype(i32) & i32(255)
    hi2 = jnp.repeat(hi, 2, axis=-2)
    par = (jnp.arange(R, dtype=i32) & i32(1)).reshape(R, 1)
    hv = jnp.where(par == 0, hi2 & i32(15), (hi2 >> 4) & i32(15))
    v = (hv << 8) | lo
    return ((v << 20) >> 20).astype(jnp.int16)


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(d, shift: int):
    """One ISLOW butterfly over 8 same-shape i32 arrays; returns the 8
    outputs descaled by ``shift`` (jidctint.c, both passes)."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * _F_0_541196100
    t2 = z1 - z3 * _F_1_847759065
    t3 = z1 + z2 * _F_0_765366865
    z2, z3 = d[0], d[4]
    e0 = (z2 + z3) << 13
    e1 = (z2 - z3) << 13
    t10, t13 = e0 + t3, e0 - t3
    t11, t12 = e1 + t2, e1 - t2

    o0, o1, o2, o3 = d[7], d[5], d[3], d[1]
    z1 = o0 + o3
    z2 = o1 + o2
    z3 = o0 + o2
    z4 = o1 + o3
    z5 = (z3 + z4) * _F_1_175875602
    o0 = o0 * _F_0_298631336
    o1 = o1 * _F_2_053119869
    o2 = o2 * _F_3_072711026
    o3 = o3 * _F_1_501321110
    z1 = -z1 * _F_0_899976223
    z2 = -z2 * _F_2_562915447
    z3 = -z3 * _F_1_961570560 + z5
    z4 = -z4 * _F_0_390180644 + z5
    o0 = o0 + z1 + z3
    o1 = o1 + z2 + z4
    o2 = o2 + z2 + z3
    o3 = o3 + z1 + z4

    return [_descale(t10 + o3, shift), _descale(t11 + o2, shift),
            _descale(t12 + o1, shift), _descale(t13 + o0, shift),
            _descale(t13 - o0, shift), _descale(t12 - o1, shift),
            _descale(t11 - o2, shift), _descale(t10 - o3, shift)]


def idct_blocks(coef: jnp.ndarray, qt: jnp.ndarray) -> jnp.ndarray:
    """coef [B, NB, 64] i16 (natural order), qt [B, 64] -> samples
    (level-shifted +128, clamped to [0, 255]) as u8 [B, NB, 64].

    The per-column all-AC-zero shortcut in jidctint.c is arithmetically
    identical to the general path (dc<<13 has 11 zero low bits, so the
    DESCALE rounding adds nothing), so the general path runs
    unconditionally — bit-equal, branch-free, vectorizable. Each pass
    runs the butterfly ONCE on 8 stacked slices (vectorized over the
    other axis) with the block dim minor — small traced graph, full
    vector lanes."""
    B, NB = coef.shape[0], coef.shape[1]
    # transpose while still i16 (half the relayout traffic), dequantize
    # in the plane layout: [B, NB, 8r, 8c] -> [B, 8r, 8c, NB]
    c4 = coef.reshape(B, NB, 8, 8).transpose(0, 2, 3, 1)
    d4 = (c4.astype(jnp.int32)
          * qt.astype(jnp.int32).reshape(B, 8, 8, 1))
    ws = _idct_1d([d4[:, r] for r in range(8)], 11)   # over rows: 8x[B,8c,NB]
    ws4 = jnp.stack(ws, axis=1)                       # [B, 8r, 8c, NB]
    out = _idct_1d([ws4[:, :, c] for c in range(8)], 18)  # 8x[B,8r,NB]
    # samples fit u8 after the clip: narrowing BEFORE the transpose-back
    # quarters the relayout + downstream plane traffic (HBM-bound tail)
    o4 = jnp.clip(jnp.stack(out, axis=2) + 128, 0, 255).astype(jnp.uint8)
    return o4.transpose(0, 3, 1, 2).reshape(B, NB, 64)


def _blocks_to_plane(s: jnp.ndarray, bh: int, bw: int) -> jnp.ndarray:
    """[B, bh*bw, 64] -> [B, bh*8, bw*8]."""
    B = s.shape[0]
    return (s.reshape(B, bh, bw, 8, 8).transpose(0, 1, 3, 2, 4)
            .reshape(B, bh * 8, bw * 8))


def _idct_1d_nodescale(d):
    """The ISLOW butterfly of ``_idct_1d`` without the final descale —
    used only to probe the pass's exact linear form (see _IDCT_MAT)."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * _F_0_541196100
    t2 = z1 - z3 * _F_1_847759065
    t3 = z1 + z2 * _F_0_765366865
    z2, z3 = d[0], d[4]
    e0 = (z2 + z3) << 13
    e1 = (z2 - z3) << 13
    t10, t13 = e0 + t3, e0 - t3
    t11, t12 = e1 + t2, e1 - t2
    o0, o1, o2, o3 = d[7], d[5], d[3], d[1]
    z1 = o0 + o3
    z2 = o1 + o2
    z3 = o0 + o2
    z4 = o1 + o3
    z5 = (z3 + z4) * _F_1_175875602
    o0 = o0 * _F_0_298631336
    o1 = o1 * _F_2_053119869
    o2 = o2 * _F_3_072711026
    o3 = o3 * _F_1_501321110
    z1 = -z1 * _F_0_899976223
    z2 = -z2 * _F_2_562915447
    z3 = -z3 * _F_1_961570560 + z5
    z4 = -z4 * _F_0_390180644 + z5
    o0 = o0 + z1 + z3
    o1 = o1 + z2 + z4
    o2 = o2 + z2 + z3
    o3 = o3 + z1 + z4
    return [t10 + o3, t11 + o2, t12 + o1, t13 + o0,
            t13 - o0, t12 - o1, t11 - o2, t10 - o3]


def _idct_pass_matrix() -> np.ndarray:
    """The 8x8 integer matrix M with butterfly(d) == M @ d before the
    descale. The butterfly is a fixed integer linear map; i32 add/mul
    wrap mod 2^32, a commutative ring, so ANY evaluation order —
    including a plain dot product — produces bit-identical wrapped
    values. Probed from the butterfly itself on unit vectors (exact
    in int64: entries are small combinations of the FIX constants)."""
    cols = []
    for j in range(8):
        e = [np.int64(1 if k == j else 0) for k in range(8)]
        cols.append([int(v) for v in _idct_1d_nodescale(e)])
    return np.array(cols, dtype=np.int32).T  # [out, in]


_IDCT_MAT = _idct_pass_matrix()


def idct_to_plane(coef: jnp.ndarray, qt: jnp.ndarray, bh: int,
                  bw: int) -> jnp.ndarray:
    """coef [B, bh*bw, 64] i16 + qt [B, 64] -> spatial u8 plane
    [B, bh*8, bw*8], level-shifted and clamped like ``idct_blocks``.

    Bit-identical to ``_blocks_to_plane(idct_blocks(...))`` but
    relayout-free until the final block->plane step: each ISLOW pass is
    the exact linear map _IDCT_MAT (mod-2^32 ring, see
    _idct_pass_matrix) applied as an i32 dot_general over the 8-length
    row/column axis of the NATURAL [B, NB, 8, 8] layout — no
    coefficient transpose, no stacked butterfly intermediate."""
    from jax import lax
    B, NB = coef.shape[0], coef.shape[1]
    m = jnp.asarray(_IDCT_MAT)
    d4 = (coef.reshape(B, NB, 8, 8).astype(jnp.int32)
          * qt.astype(jnp.int32).reshape(B, 1, 8, 8))
    # pass 1 contracts the row axis; output lands as [B, NB, 8c, 8r']
    # (contracted-out axis replaced by the matrix's output axis, which
    # dot_general appends) — exactly the orientation pass 2 wants, so
    # contracting axis 2 again yields natural [B, NB, 8r', 8c'] with no
    # explicit transpose anywhere.
    ws = _descale(lax.dot_general(
        d4, m, (((2,), (1,)), ((), ())),
        preferred_element_type=jnp.int32), 11)
    out = _descale(lax.dot_general(
        ws, m, (((2,), (1,)), ((), ())),
        preferred_element_type=jnp.int32), 18)
    o4 = jnp.clip(out + 128, 0, 255).astype(jnp.uint8)
    return _blocks_to_plane(o4.reshape(B, NB, 64), bh, bw)


def _upsample_h2v2_fancy(c: jnp.ndarray, ch_valid: int,
                         cw_valid: int) -> jnp.ndarray:
    """[B, ch, cw] u8 chroma plane -> [B, 2*ch, 2*cw] u8, libjpeg's
    triangle filter (jdsample.c h2v2_fancy_upsample): vertical 3:1
    colsums, then horizontal 3:1 with the +8/+7 rounding pair. Neighbor
    indices clamp at (ch_valid, cw_valid) — the image edge in window
    coordinates, where the filter replicates the edge sample; interior
    window edges are never referenced by kept outputs (the >=1-chroma-
    sample margin in coef_window guarantees real context)."""
    B, ch, cw = c.shape
    ci = c.astype(jnp.int32)
    # neighbor access via jnp.take with STATIC clamped indices
    rows = np.arange(ch)
    up = np.maximum(rows - 1, 0)
    dn = np.minimum(rows + 1, ch_valid - 1)
    cs_even = 3 * ci + jnp.take(ci, up, axis=1)      # near row above
    cs_odd = 3 * ci + jnp.take(ci, dn, axis=1)       # near row below
    # colsums fit u16 (max 4*255): narrow the materialized intermediate
    cs = (jnp.stack([cs_even, cs_odd], axis=2)
          .reshape(B, 2 * ch, cw).astype(jnp.uint16))
    csi = cs.astype(jnp.int32)
    cols = np.arange(cw)
    lf = np.maximum(cols - 1, 0)
    rt = np.minimum(cols + 1, cw_valid - 1)
    o_even = (3 * csi + jnp.take(csi, lf, axis=2) + 8) >> 4
    o_odd = (3 * csi + jnp.take(csi, rt, axis=2) + 7) >> 4
    return (jnp.stack([o_even, o_odd], axis=3)
            .reshape(B, 2 * ch, 2 * cw).astype(jnp.uint8))


# ---- fixed-point YCbCr->BGR (jdcolor.c build_ycc_rgb_table) ----
_FIX_1_40200 = _fix(1.40200)
_FIX_1_77200 = _fix(1.77200)
_FIX_0_71414 = _fix(0.71414)
_FIX_0_34414 = _fix(0.34414)


def _ycc_to_packed_bgr(y: jnp.ndarray, cb: jnp.ndarray,
                       cr: jnp.ndarray) -> jnp.ndarray:
    """u8 planes -> packed BGR i32 (b | g<<8 | r<<16), the decode
    graph's staging word. The u8->i32 casts fuse into the elementwise
    chain; keeping the plane arrays u8 quarters their HBM traffic."""
    y = y.astype(jnp.int32)
    cbi = cb.astype(jnp.int32) - 128
    cri = cr.astype(jnp.int32) - 128
    r = y + ((_FIX_1_40200 * cri + _ONE_HALF) >> _SCALEBITS)
    b = y + ((_FIX_1_77200 * cbi + _ONE_HALF) >> _SCALEBITS)
    g = y + ((-_FIX_0_34414 * cbi - _FIX_0_71414 * cri + _ONE_HALF)
             >> _SCALEBITS)
    r = jnp.clip(r, 0, 255)
    g = jnp.clip(g, 0, 255)
    b = jnp.clip(b, 0, 255)
    return b | (g << 8) | (r << 16)


def backhalf_to_packed(
    coef_y: jnp.ndarray,    # [B, lbh*lbw, 64] i16
    coef_cb: jnp.ndarray,   # [B, (lbh//2)*(lbw//2), 64] i16
    coef_cr: jnp.ndarray,
    qt: jnp.ndarray,        # [B, 3, 64] u16/i32 per-image quant tables
    win: CoefWindow,
) -> jnp.ndarray:
    """Finish the JPEG decode on device: -> [B, rh, rw] packed-BGR i32
    crops — the decode graph's staging layout, so the whole JPEG
    back-half fuses into the same jit graph that reads the dials."""
    assert coef_y.shape[1:] == (win.lbh * win.lbw, 64), (
        f"block layout expected, got {coef_y.shape}; frequency-plane "
        "feeds go through backhalf_planes_to_packed")
    cbh, cbw = win.lbh // 2, win.lbw // 2
    sy = idct_to_plane(coef_y, qt[:, 0], win.lbh, win.lbw)
    scb = idct_to_plane(coef_cb, qt[:, 1], cbh, cbw)
    scr = idct_to_plane(coef_cr, qt[:, 2], cbh, cbw)
    ucb = _upsample_h2v2_fancy(scb, win.ch_valid, win.cw_valid)
    ucr = _upsample_h2v2_fancy(scr, win.ch_valid, win.cw_valid)
    oy, ox, rh, rw = win.oy, win.ox, win.rh, win.rw
    return _ycc_to_packed_bgr(
        sy[:, oy:oy + rh, ox:ox + rw],
        ucb[:, oy:oy + rh, ox:ox + rw],
        ucr[:, oy:oy + rh, ox:ox + rw])


def _plane_to_blocks(fp: jnp.ndarray, bh: int, bw: int) -> jnp.ndarray:
    """[B, bh*8, bw*8] frequency-plane -> [B, bh*bw, 64] block layout
    (inverse of the C reader's plane mode)."""
    B = fp.shape[0]
    return (fp.reshape(B, bh, 8, bw, 8).transpose(0, 1, 3, 2, 4)
            .reshape(B, bh * bw, 64))


def backhalf_planes_to_packed(
    fy: jnp.ndarray,        # [B, lbh*8, lbw*8] i16 frequency-plane
    fcb: jnp.ndarray,       # [B, lbh*4, lbw*4] i16
    fcr: jnp.ndarray,
    qt: jnp.ndarray,        # [B, 3, 64]
    win: CoefWindow,
) -> jnp.ndarray:
    """backhalf_to_packed for the frequency-plane coefficient layout
    (io.jpeg read_coefs_batch plane_layout=True), dense i16 or the
    compact 12-bit i8 wire (compact=True): unpack, relayout to blocks
    in-graph, then the block-layout back-half. Bit-identical to it
    (tests/test_jpegdec.py)."""
    if fy.dtype == jnp.int8:
        fy = uncompact_plane(fy)
        fcb = uncompact_plane(fcb)
        fcr = uncompact_plane(fcr)
    cbh, cbw = win.lbh // 2, win.lbw // 2
    return backhalf_to_packed(
        _plane_to_blocks(fy, win.lbh, win.lbw),
        _plane_to_blocks(fcb, cbh, cbw),
        _plane_to_blocks(fcr, cbh, cbw),
        qt, win)
