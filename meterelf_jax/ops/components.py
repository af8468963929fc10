"""Connected-component analysis on per-dial windows, replacing
cv2.findContours / contourArea / drawContours (reference:
meterelf/_reading.py:132-148) with fixed-shape dense integer ops.

Semantics replicated:

- findContours(RETR_EXTERNAL) returns one outer contour per top-level
  8-connected component; components nested inside another component's
  hole are not candidates. We detect top-level components by flooding the
  "outside" background (4-connected, per Suzuki duality) from outside the
  dial disk.
- contourArea is the Green-formula area of the traced outer boundary.
  We compute it EXACTLY via a marching-squares identity: over all 2x2
  pixel cells, count the component's F-set corners (F = component plus
  its enclosed holes); a cell with 4 F-corners contributes 1, with
  exactly 3 F-corners contributes 1/2:

      contourArea = Q4 + Q3 / 2.

  Why this is exact: the traced polygon (Suzuki border following
  through pixel centers) covers each unit cell according to its corner
  pattern — 4 corners inside-or-on give a full cell, 3 give a corner
  triangle (the boundary cuts the cell diagonally), 2-adjacent give a
  boundary edge (zero enclosed area), and 2-diagonal give either a
  doubly-traced degenerate segment (spur/pinch, zero area) or, when one
  off-diagonal corner is an enclosed hole, a 3-F-corner cell (holes are
  in F). 1-px-wide spurs, diagonal pinches, and hole closures all fall
  out of the same rule. Validated against cv2.contourArea on 20k+
  random 8-connected components with holes/spurs (zero mismatches) and
  the full corpus; the earlier Pick surrogate 2F-B-2 overcounted B at
  concave corners (pixels only diagonally adjacent to outside are not
  on cv2's trace) and mis-ranked near-threshold blobs (the round-1
  oracle-fuzz frame-10 failure).
- drawContours(..., thickness=-1) fill = component plus its enclosed
  holes.
- Largest selection replicates Python's stable sorted()[-1]: ties by
  area are broken toward the contour found LAST in raster order, i.e.
  the larger component root index.

Array mapping:

- one batched call over all B*D windows (vmap lowers to the same, but
  the batched form lets the stats stage run one big sort);
- segmented scans ride native reverse cumsum/cummax (no flips), and the
  run-id offsets (cumsum of the walls) are LOOP-INVARIANT, computed once
  and reused by every propagation pass;
- per-component stats ride ONE uint16 sort per window (a (key, payload)
  i32 pair sort moves four times the bytes): key = owner*16 + bits with
  the owner label remapped to the static stats bbox (so the key fits
  u16), and a single packed cumsum carries both the boundary count and
  the cell-area total. The per-cell area contributions are folded into
  the key's low 2 bits: each cell's value (2 or 1) is assigned to its
  first F corner in raster order, which is provably the NW or NE
  corner, bounding any pixel's total at 3.

Everything runs on a [W, W] window (W=64) that provably contains the
dial's mask disk, so results equal full-template processing exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

# propagation iteration counts, sized from measured fixpoint distances
# over the full 1208-dial corpus under the ALTERNATING half-sweep
# schedule (label max 7 halves, outside max 4, fill max 5) plus safety
# margin. analyze() also reports a convergence bit (one extra step
# changes nothing) so out-of-corpus shapes that need more iterations
# are detected, not silently mislabeled.
K_LABEL_HYBRID = 10
K_OUTSIDE_HYBRID = 6
K_FILL = 8


class ComponentResult(NamedTuple):
    has_any: jnp.ndarray        # [...] bool: masked image nonempty
    needle_region: jnp.ndarray  # [..., W, W] bool: reference's needle_mask
    converged: jnp.ndarray      # [...] bool: propagations reached fixpoint


_SEG_BASE = 8192  # > any window label value (W*W + 1)


class _SegWalls(NamedTuple):
    """Precomputed run-id offsets for segmented scans against one wall
    set: rid[i] = number of walls at-or-before i in scan direction.
    Loop-invariant across propagation passes."""
    fwd_row: jnp.ndarray
    rev_row: jnp.ndarray
    fwd_col: jnp.ndarray
    rev_col: jnp.ndarray


def _make_walls(wall: jnp.ndarray) -> _SegWalls:
    w = wall.astype(jnp.int32)
    return _SegWalls(
        fwd_row=lax.cumsum(w, axis=wall.ndim - 1),
        rev_row=lax.cumsum(w, axis=wall.ndim - 1, reverse=True),
        fwd_col=lax.cumsum(w, axis=wall.ndim - 2),
        rev_col=lax.cumsum(w, axis=wall.ndim - 2, reverse=True),
    )


def _rid_of(walls: _SegWalls, axis: int, reverse: bool) -> jnp.ndarray:
    if axis == -1:
        return walls.rev_row if reverse else walls.fwd_row
    return walls.rev_col if reverse else walls.fwd_col


# Half-pass sweep schedule: even halves sweep forward along rows+cols,
# odd halves sweep backward — half the sweep work of the old
# all-four-directions pass at a sublinear increase in fixpoint distance
# (corpus label max: 5 full passes -> 7 halves). Any schedule reaches the
# same unique fixpoint, and a no-op composite half still certifies it:
# labels only decrease, so half(x) == x forces its min3x3 part to be a
# no-op, which makes labels constant per 8-connected component.
_ALT_DIRS = (
    ((-1, False), (-2, False)),
    ((-1, True), (-2, True)),
)


def _seg_min_sweep(vals: jnp.ndarray, walls: _SegWalls,
                   dirs) -> jnp.ndarray:
    """Segmented cummin sweeps along `dirs`, using the monotone-offset
    transform: v' = rid*BASE + (BASE-1-v). Later runs (in scan
    direction) get strictly larger offsets, so a global cummax never
    leaks values across run boundaries; within a run max(BASE-1-v)
    recovers min(v)."""
    nd = vals.ndim
    for axis, reverse in dirs:
        rid = _rid_of(walls, axis, reverse)
        vp = rid * _SEG_BASE + (_SEG_BASE - 1 - vals)
        m = lax.cummax(vp, axis=axis % nd, reverse=reverse)
        vals = (_SEG_BASE - 1) - (m - rid * _SEG_BASE)
    return vals


def _seg_or_sweep(vals: jnp.ndarray, walls: _SegWalls,
                  dirs) -> jnp.ndarray:
    """Segmented cumulative-OR sweeps along `dirs`; same offset trick
    with 0/1 payloads."""
    nd = vals.ndim
    for axis, reverse in dirs:
        rid = _rid_of(walls, axis, reverse)
        vp = rid * 2 + vals.astype(jnp.int32)
        m = lax.cummax(vp, axis=axis % nd, reverse=reverse)
        vals = (m - rid * 2) > 0
    return vals


def _min3x3(x: jnp.ndarray, big: int) -> jnp.ndarray:
    nd = x.ndim
    return lax.reduce_window(
        x, jnp.asarray(big, x.dtype), lax.min,
        window_dimensions=(1,) * (nd - 2) + (3, 3),
        window_strides=(1,) * nd,
        padding=[(0, 0)] * (nd - 2) + [(1, 1), (1, 1)],
    )


def _any4(x: jnp.ndarray) -> jnp.ndarray:
    """OR of the 4-neighborhood (von Neumann), border = False."""
    z2 = [(0, 0)] * (x.ndim - 2)
    up = jnp.pad(x[..., 1:, :], z2 + [(0, 1), (0, 0)])
    dn = jnp.pad(x[..., :-1, :], z2 + [(1, 0), (0, 0)])
    lf = jnp.pad(x[..., :, 1:], z2 + [(0, 0), (0, 1)])
    rt = jnp.pad(x[..., :, :-1], z2 + [(0, 0), (1, 0)])
    return up | dn | lf | rt


def _any8(x: jnp.ndarray) -> jnp.ndarray:
    nd = x.ndim
    return lax.reduce_window(
        x, False, lax.bitwise_or,
        window_dimensions=(1,) * (nd - 2) + (3, 3),
        window_strides=(1,) * nd,
        padding=[(0, 0)] * (nd - 2) + [(1, 1), (1, 1)],
    )


def analyze(
    masked: jnp.ndarray,     # [W, W] bool: closed needle mask & dial mask
    closed: jnp.ndarray,     # [W, W] bool: closed needle mask (unmasked)
    disk: jnp.ndarray,       # [W, W] bool: dial full-disk mask (static)
) -> ComponentResult:
    """Single-window convenience wrapper over analyze_batch."""
    res = analyze_batch(masked[None], closed[None], disk[None])
    return ComponentResult(
        has_any=res.has_any[0],
        needle_region=res.needle_region[0],
        converged=res.converged[0],
    )


def analyze_batch(
    masked: jnp.ndarray,     # [K, W, W] bool
    closed: jnp.ndarray,     # [K, W, W] bool
    disk: jnp.ndarray,       # [K, W, W] bool
    static_bbox: tuple | None = None,  # (((ox, oy) per dial), SB): sub-box that
                             # provably contains every disk pixel; shrinks the
                             # stats domain from W*W to SB*SB keys per window.
                             # K must then be a multiple of len(origins).
    stats: str = "sort",     # "sort" (u16 sort) | "hist" (one-hot matmul
                             # histogram, a cross-validated alternative)
    caps: tuple | None = None,  # (k_label, k_outside, k_fill); None =
                             # the corpus-tuned defaults. High caps (the
                             # RESCUE_CAPS rescue path) guarantee convergence
                             # on pathological masks: they switch the
                             # unrolled loops to lax.while_loop.
) -> ComponentResult:
    """Batched component analysis: label propagation, then the
    largest-component selection."""
    okey, converged = _propagate_xla(masked, disk, caps=caps)
    return _finalize(okey, masked, closed, converged,
                     static_bbox=static_bbox, stats=stats)


def _iterate(k_max: int, body, x0):
    """Run body(i, x) up to k_max times; -> (x_final, eq = elementwise
    "the final pass changed nothing"). Small caps unroll (XLA fuses
    across passes); large caps ride a lax.while_loop with early exit
    (compile size stays constant, runtime is pay-per-pass)."""
    if k_max <= 12:
        prev = x0
        x = x0
        for i in range(k_max):
            prev = x
            x = body(i, x)
        return x, x == prev

    def cond(c):
        i, done, _, _ = c
        return (i < jnp.int32(k_max)) & jnp.logical_not(done)

    def step(c):
        i, _, x, _ = c
        nx = body(i, x)
        eq = nx == x
        return (i + jnp.int32(1), eq.all(), nx, eq)

    _, _, xf, eqf = lax.while_loop(
        cond, step,
        (jnp.int32(0), jnp.bool_(False), x0, jnp.zeros_like(x0, bool)))
    return xf, eqf


# rescue-path caps: generous enough for any plausible 64x64 mask (a
# full serpentine needs ~one hybrid pass per switchback, <= 64; the
# alternating half-sweeps at most double that). Decode users re-run
# non-converged windows through these (pipeline/decode.py)
RESCUE_CAPS = (192, 96, 192)


def _propagate_xla(
    masked: jnp.ndarray,     # [K, W, W] bool
    disk: jnp.ndarray,       # [K, W, W] bool
    caps=None,
):
    """-> (owner_key i32 [K, W, W], converged bool [K]) where
    owner_key = owner*4 + masked*2 + boundary, owner = N at non-support
    pixels — the packed key _finalize sorts."""
    k_label, k_outside, k_fill = caps or (
        K_LABEL_HYBRID, K_OUTSIDE_HYBRID, K_FILL)
    K, W, W2 = masked.shape
    assert W2 == W
    N = W * W
    BIG = N

    idx = (
        lax.broadcasted_iota(jnp.int32, (W, W), 0) * W
        + lax.broadcasted_iota(jnp.int32, (W, W), 1)
    )

    # ---- 8-connected component labels (min flat index per component) ----
    # hybrid propagation: one 3x3 min (glues diagonals) + segmented
    # row/col cummin sweeps (propagate through straight runs in one shot)
    labels = jnp.where(masked, idx, BIG)
    label_walls = _make_walls(~masked)

    def hybrid_half(dirs, lab):
        lab = jnp.where(masked, jnp.minimum(lab, _min3x3(lab, BIG)), BIG)
        lab = _seg_min_sweep(lab, label_walls, dirs)
        return jnp.where(masked, lab, BIG)

    def hybrid_pass(i, lab):
        if isinstance(i, int):  # unrolled caps: static schedule
            return hybrid_half(_ALT_DIRS[i % 2], lab)
        return lax.cond(  # while-loop caps (rescue): traced index
            i % 2 == 0,
            lambda v: hybrid_half(_ALT_DIRS[0], v),
            lambda v: hybrid_half(_ALT_DIRS[1], v), lab)

    # convergence = "the final pass changed nothing": saves the separate
    # verification pass the old formulation ran after the loop (the caps
    # carry >=2 passes of margin over the measured corpus fixpoint
    # distances, so this stricter flag — distance <= cap-1 instead of
    # <= cap — never fires on the corpus, and still never mislabels:
    # a non-no-op final pass is flagged, not trusted)
    labels, labels_eq = _iterate(k_label, hybrid_pass, labels)

    # ---- outside background (bg 4-connected to beyond the dial disk) ----
    bg = ~masked
    outside = bg & ~disk
    bg_walls = _make_walls(masked)

    def out_half(dirs, out):
        out = out | (bg & _any4(out))
        out = _seg_or_sweep(out, bg_walls, dirs)
        return out & bg

    def out_pass(i, out):
        if isinstance(i, int):
            return out_half(_ALT_DIRS[i % 2], out)
        return lax.cond(
            i % 2 == 0,
            lambda v: out_half(_ALT_DIRS[0], v),
            lambda v: out_half(_ALT_DIRS[1], v), out)

    outside, outside_eq = _iterate(k_outside, out_pass, outside)
    enclosed = bg & ~outside
    support = masked | enclosed

    # ---- assign enclosed holes to their surrounding component ----
    def fill_pass(i, own):
        del i  # min3x3-only: no sweep schedule to alternate
        return jnp.where(
            enclosed, jnp.minimum(own, _min3x3(own, BIG)), own)

    owner, fill_eq = _iterate(
        k_fill, fill_pass, jnp.where(masked, labels, BIG))

    def conv_per_window(eq):
        return eq.all(axis=(1, 2))

    converged = (conv_per_window(labels_eq)
                 & conv_per_window(outside_eq)
                 & conv_per_window(fill_eq))

    boundary = masked & _any8(outside)
    okey = (
        jnp.where(support, owner, N) * 4
        + masked.astype(jnp.int32) * 2
        + boundary.astype(jnp.int32)
    )
    return okey, converged


def _cell_contrib(owner: jnp.ndarray, N: int) -> jnp.ndarray:
    """Per-pixel marching-squares area contributions (2x scale).

    owner: [..., W, W] i32 component label at F-set pixels (component +
    enclosed holes), N elsewhere. Each 2x2 cell contributes 2 (all four
    corners in one component's F-set) or 1 (exactly three) to that
    component's doubled contourArea — see the module docstring for why
    this reproduces cv2's Green-formula value exactly. All F corners
    within one cell are 8-adjacent, hence share a component, so the
    cell's component is the corner minimum. The cell value is assigned
    to the first F corner in raster order; for a contributing cell
    (k >= 3) that corner is necessarily the NW or NE one, so a pixel
    collects at most 2 + 1 = 3 — two bits, which is what lets the sort
    path fold contributions into its u16 key.
    """
    o00 = owner[..., :-1, :-1]
    o01 = owner[..., :-1, 1:]
    o10 = owner[..., 1:, :-1]
    o11 = owner[..., 1:, 1:]
    m = jnp.minimum(jnp.minimum(o00, o01), jnp.minimum(o10, o11))
    e00 = o00 == m
    e01 = o01 == m
    e10 = o10 == m
    e11 = o11 == m
    k = (e00.astype(jnp.int32) + e01.astype(jnp.int32)
         + e10.astype(jnp.int32) + e11.astype(jnp.int32))
    has = m < N
    cls = jnp.where(has & (k == 4), 2, jnp.where(has & (k == 3), 1, 0))
    a01 = e01 & ~e00
    a10 = e10 & ~e00 & ~e01
    a11 = e11 & ~e00 & ~e01 & ~e10
    z2 = [(0, 0)] * (owner.ndim - 2)
    return (
        jnp.pad(cls * e00, z2 + [(0, 1), (0, 1)])
        + jnp.pad(cls * a01, z2 + [(0, 1), (1, 0)])
        + jnp.pad(cls * a10, z2 + [(1, 0), (0, 1)])
        + jnp.pad(cls * a11, z2 + [(1, 0), (1, 0)])
    )


def _finalize(
    okey: jnp.ndarray,       # [K, W, W] i32 packed owner key
    masked: jnp.ndarray,     # [K, W, W] bool
    closed: jnp.ndarray,     # [K, W, W] bool
    converged: jnp.ndarray,  # [K] bool
    static_bbox=None,
    stats: str = "sort",
) -> ComponentResult:
    K, W, _ = okey.shape
    N = W * W
    owner_full = okey >> 2                       # owner, N at non-support
    contrib = _cell_contrib(owner_full, N)
    bbit = okey & 1

    # Every support pixel lies inside the dial disk, so when the caller
    # provides a static per-dial bounding box the stats cover SB*SB keys
    # instead of W*W, and owner labels remap to bbox-local flat indices
    # (a monotone map, so min-label identities and the raster tie-break
    # order are preserved) — which is what makes the sort key fit u16.
    if static_bbox is not None:
        origins, SB = static_bbox
        D = len(origins)
        SENT = SB * SB

        def pack(x):
            x4 = x.reshape(K // D, D, W, W)
            return jnp.stack(
                [x4[:, i, oy:oy + SB, ox:ox + SB]
                 for i, (ox, oy) in enumerate(origins)], axis=1,
            ).reshape(K, SENT)

        oy_r = jnp.asarray(
            [origins[k % D][1] for k in range(K)], jnp.int32)[:, None]
        ox_r = jnp.asarray(
            [origins[k % D][0] for k in range(K)], jnp.int32)[:, None]
        ow = pack(owner_full)
        ol = jnp.where(
            ow < N, (ow // W - oy_r) * SB + (ow % W - ox_r), SENT)
        pb, pc = pack(bbit), pack(contrib)
    else:
        SENT = N
        ol = owner_full.reshape(K, N)
        pb = bbit.reshape(K, N)
        pc = contrib.reshape(K, N)
        oy_r = ox_r = None

    if stats == "hist":
        sel_l, area2_sel, sel_valid = _stats_hist(ol, pb, pc, SENT)
    else:
        sel_l, area2_sel, sel_valid = _stats_sort(ol, pb, pc, SENT)

    if static_bbox is not None:
        sel = ((sel_l // SB + oy_r[:, 0]) * W
               + (sel_l % SB) + ox_r[:, 0])
    else:
        sel = sel_l
    sel = jnp.where(sel_valid, sel, N)

    big_blob = sel_valid & (area2_sel > 200)  # contourArea > 100
    fill_sel = ((owner_full == sel[:, None, None])
                & (sel[:, None, None] < N))
    needle_region = jnp.where(big_blob[:, None, None], fill_sel, closed)

    return ComponentResult(
        has_any=masked.any(axis=(1, 2)),
        needle_region=needle_region,
        converged=converged,
    )


def _stats_hist(ol: jnp.ndarray, bbit: jnp.ndarray, contrib: jnp.ndarray,
                SENT: int):
    """Largest-component selection via a one-hot matmul histogram.

    ol = hi*64 + lo with hi, lo < 64 (the non-support sentinel falls
    outside the hi one-hot range or lands on a B = 0 cell and drops
    out). One batched int8 matmul between the hi one-hot [K, 64, NS]
    and the lo one-hot weighted by the two payloads [K, NS, 2*64]
    yields both 64x64 histograms at once, exactly, in i32:

        B[hi, lo]  = #trace pixels of owner   (weight boundary-bit)
        A2[hi, lo] = doubled contourArea      (weight cell contrib)

    B > 0 marks candidate components: exactly the top-level ones (every
    top-level component touches outside-adjacent background; components
    nested inside another component's hole never do, and RETR_EXTERNAL
    never lists them — reference _reading.py:134-140).

    The one-hot materializations cost more memory traffic than the u16
    sort; kept as a cross-validated alternative whose speed on the GPU
    is not measured yet. Selection key and tie-break are identical to the sort
    path (area2*4096 + owner, larger owner wins ties = Python's stable
    sorted()[-1], reference _reading.py:132-148)."""
    K, NS = ol.shape
    hi = ol >> 6
    lo = ol & 63
    iota64 = lax.broadcasted_iota(jnp.int32, (1, 1, 64), 2)
    a = (hi[:, None, :] == jnp.transpose(iota64, (0, 2, 1))
         ).astype(jnp.int8)                      # [K, 64, NS]
    oh = lo[:, :, None] == iota64                # [K, NS, 64]
    bm = jnp.concatenate(
        [oh * bbit[:, :, None], oh * contrib[:, :, None]],
        axis=2).astype(jnp.int8)                 # [K, NS, 128]
    h = lax.dot_general(
        a, bm, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32)        # [K, 64, 128]
    bc = h[:, :, 0:64].reshape(K, 4096)
    area2 = h[:, :, 64:128].reshape(K, 4096)

    cell = lax.broadcasted_iota(jnp.int32, (K, 4096), 1)
    valid = bc > 0
    key = jnp.where(valid, area2 * 4096 + cell, jnp.int32(-1))
    i_sel = jnp.argmax(key, axis=1)
    sel = jnp.take_along_axis(cell, i_sel[:, None], 1)[:, 0]
    area2_sel = jnp.take_along_axis(area2, i_sel[:, None], 1)[:, 0]
    sel_valid = jnp.take_along_axis(valid, i_sel[:, None], 1)[:, 0]
    return sel, area2_sel, sel_valid


def _stats_sort(ol: jnp.ndarray, bbit: jnp.ndarray, contrib: jnp.ndarray,
                SENT: int):
    """Largest-component selection via ONE narrow sort + prefix scans.

    key = owner*16 + boundary*4 + contrib: sorting groups each
    component's pixels into one run; a single packed cumsum then yields
    per-run totals of both payloads (doubled area in the low half,
    boundary count in the high half — their row sums stay well under
    2^16 each). B > 0 marks candidates: exactly the top-level
    components (cv2 trace pixels exist only for components that touch
    outside-adjacent background; components nested inside another
    component's hole never do, and RETR_EXTERNAL never lists them).
    The key fits u16 when the caller's owner remap allows
    (SENT+1)*16 <= 2^16; the general path sorts i32."""
    K, NS = ol.shape
    key = ol * 16 + bbit * 4 + contrib
    if (SENT + 1) * 16 <= 1 << 16:
        (skey,) = lax.sort(
            (key.astype(jnp.uint16),), dimension=1, num_keys=1)
        spk = skey.astype(jnp.int32)
    else:
        (spk,) = lax.sort((key,), dimension=1, num_keys=1)
    sk = spk >> 4

    nxt = jnp.concatenate([sk[:, 1:], jnp.full((K, 1), -1, sk.dtype)], 1)
    run_end = sk != nxt
    cum = jnp.cumsum((spk & 3) + (((spk >> 2) & 1) << 16), axis=1)

    def prev_run(v):
        m = lax.cummax(jnp.where(run_end, v, 0), axis=1)
        return jnp.concatenate([jnp.zeros((K, 1), m.dtype), m[:, :-1]], 1)

    tot = cum - prev_run(cum)
    area2 = tot & 0xFFFF
    bc = tot >> 16

    valid = run_end & (sk < SENT) & (bc > 0)
    key2 = jnp.where(valid, area2 * (SENT + 1) + sk, jnp.int32(-1))
    i_sel = jnp.argmax(key2, axis=1)
    sel = jnp.take_along_axis(sk, i_sel[:, None], 1)[:, 0]          # [K]
    area2_sel = jnp.take_along_axis(area2, i_sel[:, None], 1)[:, 0]
    sel_valid = jnp.take_along_axis(valid, i_sel[:, None], 1)[:, 0]
    return sel, area2_sel, sel_valid
