"""Color-space ops: exact uint8 BGR -> HLS_FULL (and back) in jnp.

Replicates OpenCV 3.4's float-path 8u conversion bit-for-bit (see
SURVEY.md §8bis item 2): u8 * (1/255) -> RGB2HLS_f in float32 ->
H*(256/360), L*255, S*255 -> saturate_cast (round-half-to-even, clamp).
Replaces cv2.cvtColor at reference meterelf/_utils.py:100-110.

The conversion's two divisions must be IEEE-correctly rounded in f32.
XLA's GPU backend does not round them so, in f32 or through f64 (LLVM
narrows a truncated f64 quotient of f32 operands back to an f32
divide): on an H100, 4.7M of the 2^24 BGR inputs get an S quotient one
ulp off, and 18,348 of them a different S byte. Both quotients depend
only on the (max, min) channel pair, so they come from 64K-entry tables
built once on the host with numpy's IEEE division; the device does only
adds, multiplies, compares and one gather per pixel, and matches the
host twin (api._host_hls) on all 2^24 inputs on the CPU and the GPU.
"""
from __future__ import annotations

import functools

import numpy as np

import jax.numpy as jnp

_F32 = jnp.float32


@functools.lru_cache(maxsize=None)
def _pair_tables() -> tuple:
    """Per (max, min) u8 channel pair, flat index max*256 + min:
    (L | S << 8 as i32, 60 / (max - min) as f32), evaluated with the
    float path's exact op sequence in IEEE numpy."""
    f32 = np.float32
    u = np.arange(256, dtype=f32) * (f32(1.0) / f32(255.0))
    vmax = np.repeat(u, 256)
    vmin = np.tile(u, 256)
    l = (vmax + vmin) * f32(0.5)
    diff = vmax - vmin
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(l < f32(0.5), diff / (vmax + vmin),
                     diff / (f32(2.0) - vmax - vmin)).astype(f32)
        d60 = (f32(60.0) / diff).astype(f32)
    live = diff > 0                      # max > min; other slots unused
    s = np.where(live, s, f32(0.0))
    d60 = np.where(live, d60, f32(0.0))

    def sat(x):
        return np.clip(np.rint(x), 0, 255).astype(np.int32)

    ls = sat(l * f32(255.0)) | (sat(s * f32(255.0)) << 8)
    return ls.astype(np.int32), d60


def bgr_to_hls_full(bgr_u8: jnp.ndarray, hue_shift: int) -> jnp.ndarray:
    """[..., 3] uint8 BGR -> [..., 3] int32 HLS (FULL hue range 0..255),
    with the reference's wrapping hue shift applied
    (meterelf/_utils.py:100-102: uint8 wraparound add on H only)."""
    h, l, s = bgr_planes_to_hls(
        bgr_u8[..., 0], bgr_u8[..., 1], bgr_u8[..., 2], hue_shift)
    return jnp.stack([h, l, s], axis=-1).astype(jnp.uint8)


def bgr_planes_to_hls(b_u8: jnp.ndarray, g_u8: jnp.ndarray,
                      r_u8: jnp.ndarray, hue_shift: int
                      ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Planar variant of bgr_to_hls_full: three uint8 planes in, three
    int32 planes (h, l, s) out. Channel-planes layouts keep the minor
    dimension a full image axis instead of the 3-wide channel axis."""
    bi = b_u8.astype(jnp.int32)
    gi = g_u8.astype(jnp.int32)
    ri = r_u8.astype(jnp.int32)
    imax = jnp.maximum(jnp.maximum(ri, gi), bi)
    imin = jnp.minimum(jnp.minimum(ri, gi), bi)
    ls_tab, d60_tab = _pair_tables()
    pair = imax * 256 + imin
    ls = jnp.asarray(ls_tab)[pair]
    diff60 = jnp.asarray(d60_tab)[pair]

    # u8 * (1/255) is strictly increasing, so the integer max/min pick
    # the same channel the float compares would
    scale = _F32(1.0) / _F32(255.0)
    b = b_u8.astype(_F32) * scale
    g = g_u8.astype(_F32) * scale
    r = r_u8.astype(_F32) * scale
    h = jnp.where(
        imax == ri,
        (g - b) * diff60,
        jnp.where(imax == gi, (b - r) * diff60 + _F32(120.0),
                  (r - g) * diff60 + _F32(240.0)),
    )
    h = jnp.where(h < 0, h + _F32(360.0), h)
    h = jnp.where(imax != imin, h, _F32(0.0))

    hscale = _F32(256.0) / _F32(360.0)
    h_u8 = _saturate_u8(h * hscale)
    h_u8 = (h_u8 + jnp.int32(hue_shift)) % 256  # uint8 wraparound semantics
    return h_u8, ls & 255, ls >> 8


def lightness_channel(bgr_u8: jnp.ndarray) -> jnp.ndarray:
    """L channel only — pure IEEE add/mul/rint, no divisions. Used for
    the template-match path where H/S are not needed."""
    return lightness_from_planes(
        bgr_u8[..., 0], bgr_u8[..., 1], bgr_u8[..., 2])


def lightness_from_planes(b_u8: jnp.ndarray, g_u8: jnp.ndarray,
                          r_u8: jnp.ndarray) -> jnp.ndarray:
    """Planar-layout L channel (see bgr_planes_to_hls)."""
    scale = _F32(1.0) / _F32(255.0)
    b = b_u8.astype(_F32) * scale
    g = g_u8.astype(_F32) * scale
    r = r_u8.astype(_F32) * scale
    vmax = jnp.maximum(jnp.maximum(r, g), b)
    vmin = jnp.minimum(jnp.minimum(r, g), b)
    l = (vmax + vmin) * _F32(0.5)
    return _saturate_u8(l * _F32(255.0))


def _saturate_u8(x: jnp.ndarray) -> jnp.ndarray:
    """cv::saturate_cast<uchar>(float): round half-to-even then clamp.
    Kept as int32 internally; callers cast the packed result to uint8."""
    return jnp.clip(jnp.rint(x), 0, 255).astype(jnp.int32)


def hls_full_to_bgr(hls_i32: jnp.ndarray, hue_shift: int) -> jnp.ndarray:
    """Inverse conversion (reference meterelf/_utils.py:105-110), used by
    calibration/debug paths. Mirrors OpenCV's sector-table HLS2RGB float
    algorithm (sector = floor(h/60), channels picked from
    {p2, p1, falling, rising} per sector)."""
    h_i = (hls_i32[..., 0] - jnp.int32(hue_shift)) % 256
    h = h_i.astype(_F32) * (_F32(6.0) / _F32(256.0))  # sector units
    l = hls_i32[..., 1].astype(_F32) * (_F32(1.0) / _F32(255.0))
    s = hls_i32[..., 2].astype(_F32) * (_F32(1.0) / _F32(255.0))

    p2 = jnp.where(l <= _F32(0.5), l * (1 + s), l + s - l * s)
    p1 = 2 * l - p2
    sector = jnp.clip(jnp.floor(h), 0, 5).astype(jnp.int32)
    frac = h - sector.astype(_F32)

    tab0 = p2
    tab1 = p1
    tab2 = p1 + (p2 - p1) * (1 - frac)
    tab3 = p1 + (p2 - p1) * frac

    # per-sector channel sources (OpenCV's sector_data): index into tab
    sector_data = jnp.asarray(
        [[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]],
        jnp.int32)  # rows: sector; cols: (b, g, r)

    def pick(tab_idx):
        return jnp.where(
            tab_idx == 0, tab0,
            jnp.where(tab_idx == 1, tab1,
                      jnp.where(tab_idx == 2, tab2, tab3)))

    idx = sector_data[sector]           # [..., 3]
    b = pick(idx[..., 0])
    g = pick(idx[..., 1])
    r = pick(idx[..., 2])
    gray = s == 0
    b = jnp.where(gray, l, b)
    g = jnp.where(gray, l, g)
    r = jnp.where(gray, l, r)
    out = jnp.stack([b, g, r], axis=-1) * _F32(255.0)
    return jnp.clip(jnp.rint(out), 0, 255).astype(jnp.uint8)
