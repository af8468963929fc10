"""Dial-cluster localization: TM_CCOEFF template matching as a batched
cross-correlation (reference: cv2.matchTemplate at meterelf/_utils.py:91-97).

TM_CCOEFF(I, T) at offset (x, y) is sum over the window of
(I - mean(window)) * (T - mean(T)); the window-mean term cancels because
sum(T - mean(T)) = 0, so the score is exactly the correlation of I with
the zero-mean template. That correlation is the FLOP hot spot of the whole
pipeline (~372 MFLOP per image for a 188x119 template on a 250x250 crop);
XLA lowers it as a 1-D convolution.

Tie-breaking matches cv2.minMaxLoc: first maximum in row-major scan order
(jnp.argmax also returns the first occurrence).
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
from jax import lax


def match_template_scores(
    lightness_f32: jnp.ndarray,  # [B, H, W] f32
    template_zm: jnp.ndarray,    # [th, tw] f32 zero-mean
    precision: lax.Precision = lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """Valid cross-correlation -> [B, H-th+1, W-tw+1] f32 scores.

    Straightforward 2-D conv lowering; kept as the reference
    implementation for tests — production uses
    match_template_scores_matmul."""
    lhs = lightness_f32[:, None, :, :]          # NCHW
    rhs = template_zm[None, None, :, :]          # OIHW
    out = lax.conv_general_dilated(
        lhs, rhs,
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=precision,
    )
    return out[:, 0]


def match_template_scores_matmul(
    lightness_f32: jnp.ndarray,   # [B, H, W] f32
    template_u8: jnp.ndarray,     # [th, tw] integer-valued template
    template_mean: float,         # f64 scalar mean(template)
    dtype: jnp.dtype = jnp.float32,
) -> jnp.ndarray:
    """TM_CCOEFF as a row-decomposed 1-D convolution, with the same
    argmax as the 2-D conv.

    Exploits two identities:
    - TM_CCOEFF = corr(L, T - mean(T)) = corr(L, T) - mean(T)*boxsum(L),
      and L and T are integers in [0, 255], exact even in TF32 (an
      11-bit significand), so the products are exact and only the f32
      accumulation rounds (max 1.2e-5 of the peak vs exact —
      threshold/argmax margins are ~1e-2).
    - 2D correlation = 1D row correlations + diagonal sums over template
      rows: R[r, y', x] = sum_c T[r, c] * L[y', x+c] via one matmul over
      an x-unfolded image, then scores[y, x] = sum_r R[r, y+r, x].
    """
    B, H, W = lightness_f32.shape
    th, tw = template_u8.shape
    oh, ow = H - th + 1, W - tw + 1
    T_aug = jnp.concatenate(
        [jnp.asarray(template_u8, dtype),
         jnp.ones((1, tw), dtype)], axis=0)          # [th+1, tw]

    def scores_chunk(Lc):
        b = Lc.shape[0]
        # 1D valid conv along x, one output channel per template row (plus
        # the box-sum channel): R[(b,y'), r, x] = sum_c T_aug[r,c]*L[y',x+c]
        # — XLA lowers this to a well-tiled implicit GEMM, unlike the
        # equivalent 2D conv (no im2col buffer is ever materialized).
        lhs = Lc.reshape(b * H, 1, W).astype(dtype)
        rhs = T_aug[:, None, :]                       # [th+1, 1, tw] OIW
        R = lax.conv_general_dilated(
            lhs, rhs, (1,), "VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            preferred_element_type=jnp.float32,
        ).reshape(b, H, th + 1, ow)
        # diagonal sums over template rows (XLA fuses into one pass)
        corr = sum(lax.slice_in_dim(R, r, r + oh, axis=1)[:, :, r]
                   for r in range(th))
        box = sum(lax.slice_in_dim(R, r, r + oh, axis=1)[:, :, th]
                  for r in range(th))
        return corr - jnp.float32(template_mean) * box

    # R is ~7.7 MB/image in f32: chunk the batch to bound device memory
    CHUNK = 128
    if B <= CHUNK:
        return scores_chunk(lightness_f32)
    pad = (-B) % CHUNK
    Lp = jnp.pad(lightness_f32, ((0, pad), (0, 0), (0, 0)))
    chunks = Lp.reshape(-1, CHUNK, H, W)
    out = lax.map(scores_chunk, chunks)
    return out.reshape(-1, oh, ow)[:B]


def locate(
    scores: jnp.ndarray,  # [B, oh, ow]
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """-> (max_val [B] f32, x [B] i32, y [B] i32), first-max tie-break."""
    B, oh, ow = scores.shape
    flat = scores.reshape(B, oh * ow)
    idx = jnp.argmax(flat, axis=1)
    max_val = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
    y = (idx // ow).astype(jnp.int32)
    x = (idx % ow).astype(jnp.int32)
    return max_val, x, y


def crop_at(
    img: jnp.ndarray,  # [H, W, C]
    x: jnp.ndarray,
    y: jnp.ndarray,
    th: int,
    tw: int,
) -> jnp.ndarray:
    """Dynamic [th, tw, C] crop at (y, x) (one image; vmap over batch)."""
    return lax.dynamic_slice(
        img, (y, x, jnp.zeros_like(y)), (th, tw, img.shape[2])
    )
