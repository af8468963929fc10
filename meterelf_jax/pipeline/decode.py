"""The batched, jit-compiled decode graph: uint8 meter-rect crops in,
per-image readings + error codes out.

This restructures the reference's per-image object/exception flow
(meterelf/_api.py + _image.py + _reading.py) as arrays-over-batch with
error codes, no data-dependent control flow, all shapes static. One call
decodes a whole batch; vmap supplies the batch and per-dial axes; XLA
lowers the template correlation to a 1-D convolution and fuses the
elementwise stages.

Stages (per image):
  1. exact BGR->HLS_FULL + wrapping hue shift        (ops/color.py)
  2. template correlation -> argmax location + score (ops/template.py)
  3. dial-cluster crop at the match location
  4. per dial: color sample -> inRange -> 3x3 close -> component
     analysis -> momentum/tip angle reductions       (ops/*.py)
  5. carry-corrected 4-dial value                    (ops/angles.py)
  6. error-code priority replicating the reference's raise order

Precision: "exact" mode keeps the reference's float64 semantics for the
angle statistics (all discrete decisions are integer-exact by
construction); "fast" mode runs them in float32. See
ops/angles.py for why both modes share identical discrete behavior.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..errors import ErrCode
from ..params import DIAL_WIN, Params, ParamArrays
from ..ops import angles as angles_ops
from ..ops import color as color_ops
from ..ops import components as comp_ops
from ..ops import morphology as morph_ops
from ..ops import template as template_ops


class BatchResult(NamedTuple):
    err: jnp.ndarray              # [B] i32 ErrCode
    first_bad_dial: jnp.ndarray   # [B] i32 (valid when err == NEEDLE_CONTOURS)
    unreadable_bits: jnp.ndarray  # [B] i32 bitmask (valid when err == DIAL_ANGLE)
    match_val: jnp.ndarray        # [B] f32
    match_x: jnp.ndarray          # [B] i32
    match_y: jnp.ndarray          # [B] i32
    dial_pos: jnp.ndarray         # [B, D] f
    readable: jnp.ndarray         # [B, D] bool
    value: jnp.ndarray            # [B] f
    converged: jnp.ndarray        # [B] bool: CCL propagation fixpoint check


def _dial_masks_from_packed_window(
    win_pk: jnp.ndarray,       # [W, W] i32 packed BGR (b | g<<8 | r<<16)
    color_range: jnp.ndarray,  # [3] i32
    center_int: jnp.ndarray,   # [2] i32 (x, y), window coords
    mask_full: jnp.ndarray,    # [W, W] bool
    hue_shift,
):
    """Exact HLS + inRange + 3x3 close for one extracted dial window.

    Works on the packed-BGR representation (one i32 word per pixel):
    a channel-minor uint8 layout wastes 125/128 of each vector register,
    and packing is done once on the host. The unpack fuses into the HLS
    compares; the 5x5 dial-center color sample keeps the reference's
    integer-exact rounding (round(S/25) has no ties, _reading.py:154-160).
    """
    h, l, s = color_ops.bgr_planes_to_hls(
        (win_pk & 255).astype(jnp.uint8),
        ((win_pk >> 8) & 255).astype(jnp.uint8),
        ((win_pk >> 16) & 255).astype(jnp.uint8),
        hue_shift)
    hls_pl = jnp.stack([h, l, s])                         # [3, W, W] i32
    core = lax.dynamic_slice(
        hls_pl,
        (jnp.int32(0), center_int[1] - 2, center_int[0] - 2),
        (3, 5, 5),
    )
    ssum = jnp.sum(core, axis=(1, 2))                     # [3] i32
    dial_color = (2 * ssum + 25) // 50
    lo = jnp.clip(dial_color - color_range, 0, 255)
    hi = jnp.clip(dial_color + color_range, 0, 255)
    raw = jnp.all(
        (hls_pl >= lo[:, None, None]) & (hls_pl <= hi[:, None, None]),
        axis=0)
    closed = morph_ops.close3(raw)
    masked = closed & mask_full
    return masked, closed


def _decode_batch(
    pa: ParamArrays,
    crops: jnp.ndarray,      # [B, ch, cw] i32 packed BGR, or [B,ch,cw,3] u8
    load_ok: jnp.ndarray,    # [B] bool
    *,
    sum_dtype=None,
    static_bbox=None,        # per-dial stats bounding box (see analyze_batch)
    ccl_caps=None,           # CCL pass caps; None = corpus-tuned defaults,
                             # comp_ops.RESCUE_CAPS = guaranteed convergence
) -> BatchResult:
    D = pa.mask_full.shape[0]
    W = DIAL_WIN
    B = crops.shape[0]

    # canonical internal format: one i32 word per pixel (b|g<<8|r<<16).
    # The host feeder packs for free; u8 channel-last input (API compat)
    # is packed in-graph.
    if crops.ndim == 4:
        c32 = crops.astype(jnp.int32)
        packed = c32[..., 0] | (c32[..., 1] << 8) | (c32[..., 2] << 16)
    else:
        packed = crops

    b_pl = (packed & 255).astype(jnp.uint8)
    g_pl = ((packed >> 8) & 255).astype(jnp.uint8)
    r_pl = ((packed >> 16) & 255).astype(jnp.uint8)
    lightness = color_ops.lightness_from_planes(
        b_pl, g_pl, r_pl).astype(jnp.float32)
    scores = template_ops.match_template_scores_matmul(
        lightness, pa.template_u8, pa.template_mean)
    max_val, mx, my = template_ops.locate(scores)

    # per-(image, dial) window masks: one single-channel dynamic
    # slice from the packed image per window, then fused unpack+HLS
    def window(img_pk, x, y, i):
        return lax.dynamic_slice(
            img_pk,
            (y + pa.win_origin[i][1], x + pa.win_origin[i][0]),
            (W, W))

    masked, closed = jax.vmap(  # over batch
        lambda img, x, y: jax.vmap(  # over dials
            lambda i: _dial_masks_from_packed_window(
                window(img, x, y, i),
                pa.color_range[i], pa.centers_int[i],
                pa.mask_full[i], pa.hue_shift,
            )
        )(jnp.arange(D))
    )(packed, mx, my)                                # [B, D, W, W]

    # stage B: ONE batched component analysis over all B*D windows
    disk_b = jnp.broadcast_to(pa.mask_full[None], (B, D, W, W))
    comp = comp_ops.analyze_batch(
        masked.reshape(B * D, W, W),
        closed.reshape(B * D, W, W),
        disk_b.reshape(B * D, W, W),
        static_bbox=static_bbox,
        caps=ccl_caps,
    )
    has_any = comp.has_any.reshape(B, D)
    conv = comp.converged.reshape(B, D)
    needle = comp.needle_region.reshape(B, D, W * W)

    # stage C: angle statistics per window (masked f64 reductions)
    per_dial = jax.vmap(  # over batch
        lambda nr: jax.vmap(  # over dials
            lambda i: angles_ops.read_dial(
                nr[i],
                pa.disk_idx[i], pa.disk_valid[i],
                pa.disk_sx2[i], pa.disk_sy2[i],
                pa.ann_idx[i], pa.ann_valid[i],
                pa.ann_x[i], pa.ann_y[i], pa.ann_angle[i], pa.ann_sqd[i],
                pa.neg_sign[i], pa.zero_turn[i],
                sum_dtype=sum_dtype,
            )
        )(jnp.arange(D))
    )(needle)
    readable, positions = per_dial.readable, per_dial.position  # [B, D]

    f = positions.dtype
    if D == 4:
        value = jax.vmap(
            lambda p: angles_ops.assemble_value(p[pa.value_perm])
        )(positions)
    else:
        value = jnp.zeros(positions.shape[0], f)

    match_ok = max_val >= pa.threshold
    no_contours = ~has_any
    any_nc = no_contours.any(axis=1)
    first_bad = jnp.argmax(no_contours, axis=1).astype(jnp.int32)
    unreadable = has_any & ~readable
    any_unr = (~readable).any(axis=1)
    bits = jnp.sum(
        (~readable).astype(jnp.int32) * (1 << jnp.arange(D, dtype=jnp.int32)),
        axis=1,
    )

    err = jnp.where(
        ~load_ok,
        jnp.int32(ErrCode.LOAD),
        jnp.where(
            ~match_ok,
            jnp.int32(ErrCode.DIALS_NOT_FOUND),
            jnp.where(
                any_nc,
                jnp.int32(ErrCode.NEEDLE_CONTOURS),
                jnp.where(
                    any_unr,
                    jnp.int32(ErrCode.DIAL_ANGLE),
                    jnp.int32(ErrCode.OK),
                ),
            ),
        ),
    )
    del unreadable  # bits carries the full mask; host renders names

    return BatchResult(
        err=err,
        first_bad_dial=first_bad,
        unreadable_bits=bits,
        match_val=max_val,
        match_x=mx,
        match_y=my,
        dial_pos=positions,
        readable=readable,
        value=value,
        converged=conv.all(axis=1),
    )


def pack_crops_device(crops_u8: jnp.ndarray) -> jnp.ndarray:
    """Device-side analog of io.jpeg.pack_crops: [B, H, W, 3] u8 BGR ->
    [B, H, W] i32 packed (b | g<<8 | r<<16).

    Lets hosts ship raw 3-byte/px crops (io.jpeg.load_crop_bytes_u8)
    over the host->device link and do the 4-byte staging expansion on
    the accelerator — 25% less H2D traffic on the end-to-end path."""
    c = crops_u8.astype(jnp.int32)
    return c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)


def make_coef_decode_fn(dec: "MeterDecoder",
                        frame_wh: tuple) -> tuple:
    """Compose the device JPEG back-half (ops/jpegdec.py) with the
    decode graph: one jitted dispatch from entropy-decoded DCT
    coefficient windows to readings.

    The host side only runs the inherently sequential Huffman decode
    (io.jpeg.load_coef_feed); dequantize + ISLOW IDCT + fancy chroma
    upsampling + YCbCr->BGR + crop/pack all fuse into the same graph
    that reads the dials. Fallback rows (pixel-path packed crops for
    frames the coefficient reader rejects) scatter over the back-half
    output; unused slots carry an out-of-range index and drop.

    The step takes either coefficient layout io.jpeg.read_coefs_batch
    writes: blocks ([B, lbh*lbw, 64] i16, what load_coef_feed ships) or
    frequency planes ([B, lbh*8, lbw*8], dense i16 or the compact 12-bit
    i8 wire), told apart by shape and dtype at trace time.

    Returns (step, win): ``step(param_arrays, coef_y, coef_cb, coef_cr,
    qt, load_ok, fb_packed, fb_idx) -> BatchResult`` and the static
    CoefWindow the feed arrays must match. Fallback slots hold packed
    crops of the meter rect's shape."""
    from ..ops import jpegdec

    rect = dec.params.meter_rect
    win = jpegdec.coef_window(rect, frame_wh[0], frame_wh[1])

    plane_shape = (win.lbh * 8, win.lbw * 8)
    block_shape = (win.lbh * win.lbw, 64)
    assert plane_shape != block_shape, "ambiguous coef layouts"

    @jax.jit
    def step(pa, cy, cb, cr, qt, ok, fb_packed, fb_idx):
        cy_shape = tuple(cy.shape[1:])
        if cy.dtype == jnp.int8:   # compact wire: 3/2 the plane's rows
            cy_shape = (cy.shape[1] * 2 // 3, cy.shape[2])
        if cy_shape == plane_shape:
            packed = jpegdec.backhalf_planes_to_packed(cy, cb, cr, qt, win)
        else:
            assert tuple(cy.shape[1:]) == block_shape, cy.shape
            packed = jpegdec.backhalf_to_packed(cy, cb, cr, qt, win)
        packed = packed.at[fb_idx].set(fb_packed, mode="drop")
        return dec._fn(pa, packed, ok)

    return step, win


def _stats_bbox(mask_full: np.ndarray, sb: int = 48):
    """Static per-dial sub-box containing every disk pixel, for the
    component-stats sort (analyze_batch static_bbox). None when any
    dial's disk doesn't fit — the general full-window path then runs."""
    D, W, _ = mask_full.shape
    origins = []
    for i in range(D):
        ys, xs = np.nonzero(np.asarray(mask_full[i]))
        if len(xs) == 0:
            return None
        ox = int(min(xs.min(), W - sb))
        oy = int(min(ys.min(), W - sb))
        if xs.max() >= ox + sb or ys.max() >= oy + sb:
            return None
        origins.append((ox, oy))
    return (tuple(origins), sb)


class MeterDecoder:
    """Compiled batched decoder for one camera configuration.

    exact=True keeps the reference's float64 statistics (requires jax
    x64); exact=False runs the continuous math in float32. Discrete
    decisions are integer-exact in both modes.
    """

    def __init__(
        self,
        params: Params,
        *,
        exact: bool = True,
    ) -> None:
        self.params = params
        self.exact = exact
        # x64 is required in both modes: the angle statistics accumulate
        # in float64 (exact reference semantics); fast mode only demotes
        # the bulk per-pixel data to f32.
        jax.config.update("jax_enable_x64", True)
        pa = params.arrays()
        if not exact:
            f32 = (
                "zero_turn", "disk_sx2", "disk_sy2",
                "ann_x", "ann_y", "ann_angle", "ann_sqd",
            )
            pa = pa._replace(
                **{k: getattr(pa, k).astype(np.float32) for k in f32})
        self.param_arrays = pa
        self.crop_shape = (params.meter_rect.height, params.meter_rect.width, 3)
        self._static_kwargs = dict(
            sum_dtype=jnp.float64,
            static_bbox=_stats_bbox(pa.mask_full),
        )
        self._fn = jax.jit(
            functools.partial(_decode_batch, **self._static_kwargs))
        self._rescue_fn = None  # compiled on first non-converged batch

    def __call__(self, crops_u8, load_ok=None) -> BatchResult:
        if load_ok is None:
            load_ok = jnp.ones(crops_u8.shape[0], bool)
        return self._fn(self.param_arrays, crops_u8, load_ok)

    def decode_numpy(self, crops_u8: np.ndarray,
                     load_ok: Optional[np.ndarray] = None) -> BatchResult:
        """Decode and pull results to host numpy.

        If any image's CCL propagation failed to reach its fixpoint
        under the corpus-tuned pass caps (pathological needle masks —
        never the corpus), the batch is re-decoded through the rescue
        graph (comp_ops.RESCUE_CAPS: generous caps, pay-per-pass via
        the early-exit loops) and the non-converged rows are replaced.
        Guarantees no silently-mislabeled component analysis ever
        reaches a caller."""
        res = jax.tree.map(np.asarray, self(crops_u8, load_ok))
        return self.rescue_numpy(crops_u8, res, load_ok)

    def rescue_numpy(self, crops_u8: np.ndarray, res: BatchResult,
                     load_ok: Optional[np.ndarray] = None) -> BatchResult:
        """Replace any non-converged rows of an already-computed (host)
        BatchResult for `crops_u8` via the rescue graph — the entry point
        for callers that dispatched the default graph themselves (e.g.
        the streaming loop) and only discovered non-convergence at drain
        time; skips the redundant default-graph re-run decode_numpy
        would pay."""
        if bool(res.converged.all()):
            return res
        if self._rescue_fn is None:
            from ..ops import components as comp_ops
            self._rescue_fn = jax.jit(functools.partial(
                _decode_batch, ccl_caps=comp_ops.RESCUE_CAPS,
                **self._static_kwargs))
        if load_ok is None:
            load_ok = jnp.ones(crops_u8.shape[0], bool)
        res2 = jax.tree.map(
            np.asarray,
            self._rescue_fn(self.param_arrays, crops_u8, load_ok))
        if not bool(res2.converged.all()):
            bad = np.nonzero(~res2.converged)[0].tolist()
            raise RuntimeError(
                "component propagation failed to converge even under "
                f"rescue caps for batch rows {bad}; refusing to emit "
                "potentially mislabeled readings")
        take = res.converged
        merged = type(res)(*[
            np.where(_bcast(take, a.shape), a, b)
            for a, b in zip(res, res2)
        ])
        return merged


def _bcast(mask: np.ndarray, shape) -> np.ndarray:
    """[B] bool -> broadcastable to a [B, ...] result field."""
    return mask.reshape(mask.shape + (1,) * (len(shape) - 1))
