"""Needle-angle extraction as masked reductions over static dial geometry.

The reference iterates Python lists of nonzero pixels
(meterelf/_reading.py:32-96). Here we exploit that each dial's disk and
annulus pixel sets are STATIC (fixed by params): their coordinates,
reference-rounded offsets (x, y) = (px - cx, py - cy), squared distances,
and even their needle angles (math.atan based, bit-identical to
meterelf/_utils.py:18-42) are precomputed on the host and baked into
ParamArrays. The device then only gathers the needle-region bits at those
pixel slots and performs exact masked reductions:

- momentum: sum of sign-preserving squares over needle pixels
  (_reading.py:32-37). All terms are multiples of 0.01 well below 2^53,
  so f64 sums are EXACT regardless of reduction order.
- tip filter: the reference keeps annulus pixels whose angle is within
  0.25 turn of the momentum angle (_reading.py:59-66). Angular distance
  < 0.25 turn is exactly the open half-plane test  v . m > 0  (and the
  reference's handling of zero vectors / exact-90-degree cases maps to
  dot == 0), so no runtime atan is needed at all.
- unwrap/trim/weighted mean (_reading.py:82-94): fixed-size two-key sort
  (angle, sqdist) over the annulus slots replicates Python's tuple sort,
  then a masked [cut, n-cut) weighted mean.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp


class DialReading(NamedTuple):
    position: jnp.ndarray  # [] float: dial position in [0, 10)
    readable: jnp.ndarray  # [] bool


def read_dial(
    region_flat: jnp.ndarray,   # [W*W] bool needle region (window coords)
    disk_idx: jnp.ndarray,      # [Pd] i32 flat indices of disk pixels
    disk_valid: jnp.ndarray,    # [Pd] bool
    disk_sx2: jnp.ndarray,      # [Pd] f: sign(x) * x^2 (reference-rounded)
    disk_sy2: jnp.ndarray,      # [Pd] f
    ann_idx: jnp.ndarray,       # [Pa] i32 flat indices of annulus pixels
    ann_valid: jnp.ndarray,     # [Pa] bool
    ann_x: jnp.ndarray,         # [Pa] f: px - cx
    ann_y: jnp.ndarray,         # [Pa] f
    ann_angle: jnp.ndarray,     # [Pa] f: get_angle_by_vector(x, y), host
    ann_sqd: jnp.ndarray,       # [Pa] f: x^2 + y^2 (reference-rounded)
    neg_sign: jnp.ndarray,      # [] i32
    zero_turn: jnp.ndarray,     # [] f: angle_of_zero / 360
    sum_dtype: Optional[jnp.dtype] = None,   # accumulation dtype
) -> DialReading:
    needle = region_flat[disk_idx] & disk_valid
    tip = region_flat[ann_idx] & ann_valid
    f = disk_sx2.dtype
    acc = jnp.dtype(sum_dtype) if sum_dtype is not None else f

    # momentum terms are multiples of 0.01 far below 2^53: f64 sums are
    # exact regardless of reduction order
    mom_x = jnp.sum(jnp.where(needle, disk_sx2, f.type(0)).astype(acc))
    mom_y = jnp.sum(jnp.where(needle, disk_sy2, f.type(0)).astype(acc))
    sign = neg_sign.astype(acc)
    msx = sign * mom_x
    msy = sign * mom_y

    dot = ann_x.astype(acc) * msx + ann_y.astype(acc) * msy
    kept = tip & (dot > 0)
    n = jnp.sum(kept).astype(jnp.int32)
    readable = n > 0

    # The annulus slots are statically ordered by (angle, sqdist), so the
    # reference's sorted(angles_and_sqdists_r) (_reading.py:89) — sorting
    # angles rebased by -1 when >= 0.75 turn above the minimum — is just
    # a cyclic rotation of the kept slots: the "tail" (rebased) block
    # wraps to the front. No runtime sort needed.
    inf = f.type(jnp.inf)
    min_angle = jnp.min(jnp.where(kept, ann_angle, inf))
    # exact reference predicate: abs(a - min) < 0.75 keeps a; else a-1
    is_tail = kept & ~(jnp.abs(ann_angle - min_angle) < f.type(0.75))
    k_tail = jnp.sum(is_tail).astype(jnp.int32)

    rank = (jnp.cumsum(kept.astype(jnp.int32)) - 1)  # rank among kept
    pos = jnp.where(is_tail, rank - (n - k_tail), rank + k_tail)

    cut = jnp.where(n >= 5, jnp.minimum(2, (n - 3) // 2), 0)
    in_trim = kept & (pos >= cut) & (pos < n - cut)

    rebased = jnp.where(is_tail, ann_angle - f.type(1.0), ann_angle)
    w = jnp.where(in_trim, ann_sqd, f.type(0)).astype(acc)
    num = jnp.sum(rebased.astype(acc) * w)
    den = jnp.sum(w)
    angle = num / jnp.where(den == 0, jnp.ones((), acc), den)

    ten = jnp.asarray(10.0, acc)
    position = jnp.mod(ten * (angle - zero_turn.astype(acc)), ten)
    return DialReading(position=position, readable=readable)


def assemble_value(positions_sorted: jnp.ndarray) -> jnp.ndarray:
    """Carry-corrected 4-dial value (reference _reading.py:163-182).

    positions_sorted: [4] positions in name-sorted order (r4, r3, r2, r1)
    = ("0.0001", "0.001", "0.01", "0.1").
    """
    f = positions_sorted.dtype
    r4, r3, r2, r1 = (positions_sorted[i] for i in range(4))

    def digit(r, lower_le2, lower_ge8):
        base = jnp.floor(r).astype(jnp.int32)  # int(r) for r >= 0
        frac = r - jnp.floor(r)                # r % 1.0 for r >= 0
        up = (frac > f.type(0.55)) & lower_le2
        down = (frac < f.type(0.45)) & lower_ge8
        return jnp.mod(base + up.astype(jnp.int32) - down.astype(jnp.int32), 10)

    # note: d3's carry compares the RAW float r4 against 2/8
    # (_reading.py:174-175); the coarser dials compare corrected digits.
    d3 = digit(r3, r4 <= f.type(2), r4 >= f.type(8))
    d2 = digit(r2, d3 <= 2, d3 >= 8)
    d1 = digit(r1, d2 <= 2, d2 >= 8)
    return (
        d1.astype(f) * f.type(100.0)
        + d2.astype(f) * f.type(10.0)
        + d3.astype(f)
        + r4 / f.type(10.0)
    )
