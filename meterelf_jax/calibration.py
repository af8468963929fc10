"""Offline dial-center calibration (reference: meterelf/_calibration.py).

Derives per-dial centers/diameters from data:

  1. decode + localize every frame (the batched decoder's template
     matcher), translation-stabilize each meter crop so the matched dial
     rect lands at a fixed anchor (reference used cv2.warpAffine with an
     integer translation, _image.py:34-44 — here a zero-padded shift),
  2. stream a float64 running mean with the reference's exact reducer
     semantics (new = prev*((n-1)/n) + img/n, _utils.py:82-88) as a
     sequential lax.scan on device,
  3. threshold the averaged image by the global needle color
     (_calibration.py:82-84), label components, and least-squares-fit an
     ellipse to each component's boundary (replacing cv2.fitEllipse with
     the standard Fitzgibbon/Halir-Flusser direct conic fit).

Calibration is an offline tool: the heavy batched decode/average runs on
device; the per-component ellipse fit of a single 188x119 mask runs in
numpy on the host.
"""
from __future__ import annotations

import glob as glob_mod
import random
from typing import Iterable, List, Tuple, Union

import numpy as np

from .params import Params
from .types import DialCenter

# frames excluded from calibration globs (reference _calibration.py:72-79
# hardcodes these two corrupt sample frames)
_EXCLUDED_FILENAMES = (
    "20180814021309-01-e01.jpg",
    "20180814021310-00-e02.jpg",
)

STABILIZE_ANCHOR = (30, 116)  # matched rect top-left target (_image.py:41-42)


def get_image_filenames(params: Params) -> List[str]:
    return [
        path for path in glob_mod.glob(params.image_glob)
        if all(bad not in path for bad in _EXCLUDED_FILENAMES)
    ]


def get_files(
    params: Params, files: Union[int, Iterable[str]] = 255
) -> Iterable[str]:
    if isinstance(files, int):
        return random.sample(get_image_filenames(params), files)
    return files


def find_dial_centers(
    params: Params, files: Union[int, Iterable[str]] = 255
) -> List[DialCenter]:
    avg_meter = get_average_meter_image(params, list(get_files(params, files)))
    return find_dial_centers_from_image(params, avg_meter)


def get_average_meter_image(
    params: Params, files: List[str]
) -> np.ndarray:
    """Decode, localize, stabilize and average frames -> uint8 BGR crop."""
    import jax
    import jax.numpy as jnp
    from .io import jpeg as jio
    from .ops import color as color_ops
    from .ops import template as template_ops

    jax.config.update("jax_enable_x64", True)
    pa = params.arrays()
    crops, ok = jio.load_crops(files, params.meter_rect)
    ch, cw = crops.shape[1:3]
    th, tw = pa.template_u8.shape

    @jax.jit
    def locate_batch(c):
        hls = color_ops.bgr_to_hls_full(c, pa.hue_shift)
        L = hls[..., 1].astype(jnp.float32)
        tmean = (jnp.sum(pa.template_u8.astype(jnp.int32)).astype(jnp.float32)
                 / jnp.float32(th * tw))
        scores = template_ops.match_template_scores_matmul(
            L, pa.template_u8, tmean)
        return template_ops.locate(scores)

    max_val, mx, my = (np.asarray(v) for v in locate_batch(crops))
    usable = ok & (max_val >= params.dials_match_threshold)

    @jax.jit
    def stabilized_mean(c, sx, sy, use):
        ax, ay = STABILIZE_ANCHOR

        def shift_one(img, dx, dy):
            # integer translation with zero fill (cv2.warpAffine identity
            # translation semantics at _image.py:38-44)
            shifted = jnp.roll(img, (dy, dx), axis=(0, 1))
            yy = jnp.arange(ch)[:, None]
            xx = jnp.arange(cw)[None, :]
            valid = (
                ((yy - dy) >= 0) & ((yy - dy) < ch)
                & ((xx - dx) >= 0) & ((xx - dx) < cw)
            )
            return jnp.where(valid[..., None], shifted, 0)

        imgs = jax.vmap(shift_one)(c, ax - sx, ay - sy)
        norm = imgs.astype(jnp.float64) / 255.0

        # reference reducer: sequential running mean (_utils.py:82-88)
        def step(carry, xs):
            prev, n = carry
            img, u = xs
            new = prev * ((n - 1.0) / n) + img / n
            new = jnp.where(u, new, prev)
            n = jnp.where(u, n + 1.0, n)
            return (new, n), None

        # seed with the first usable frame
        first_idx = jnp.argmax(use)
        init = (norm[first_idx], jnp.float64(2.0))
        (avg, _n), _ = jax.lax.scan(step, init, (norm, use))
        # the seed frame must not be folded twice: mask it out of the scan
        return avg

    # mask the seed frame out of the scan stream
    first = int(np.argmax(usable))
    use2 = usable.copy()
    use2[first] = False
    avg = np.asarray(stabilized_mean(crops, mx, my, use2))
    if not usable.any():
        raise ValueError("Cannot calculate average of empty sequence")
    return ((avg * 255.0) + 0.5).astype(np.uint8)


def get_needles_mask_by_color(params: Params, hls_image: np.ndarray) -> np.ndarray:
    lo, hi = params.needle_color.get_range(params.needle_color_range)
    lo_a = np.array(lo, np.int32)
    hi_a = np.array(hi, np.int32)
    return ((hls_image >= lo_a) & (hls_image <= hi_a)).all(axis=-1)


def find_dial_centers_from_image(
    params: Params, avg_meter: np.ndarray
) -> List[DialCenter]:
    import jax
    import jax.numpy as jnp
    from .ops import color as color_ops
    from .ops import template as template_ops

    pa = params.arrays()
    th, tw = pa.template_u8.shape
    hls = np.asarray(color_ops.bgr_to_hls_full(
        jnp.asarray(avg_meter[None]), pa.hue_shift))[0]
    L = jnp.asarray(hls[None, :, :, 1], jnp.float32)
    tmean = float(pa.template_u8.astype(np.float64).mean())
    scores = template_ops.match_template_scores_matmul(
        L, jnp.asarray(pa.template_u8), tmean)
    _mv, x, y = template_ops.locate(scores)
    x, y = int(x[0]), int(y[0])
    dials_hls = hls[y:y + th, x:x + tw]

    mask = get_needles_mask_by_color(params, dials_hls)
    centers = []
    for comp in _components_8(mask):
        boundary = _boundary_points(comp)
        (cx, cy), (w, h) = fit_ellipse(boundary)
        diameter = (w + h) / 2.0
        if abs(h - w) / diameter > 0.2:
            raise ValueError("Needle center not circle enough")
        centers.append(DialCenter((cx, cy), int(round(diameter))))
    return sorted(centers, key=lambda c: c.center[0])


def _components_8(mask: np.ndarray) -> List[np.ndarray]:
    """8-connected components of a small host mask (BFS)."""
    h, w = mask.shape
    seen = np.zeros_like(mask, bool)
    comps = []
    for sy, sx in zip(*np.nonzero(mask)):
        if seen[sy, sx]:
            continue
        stack = [(sy, sx)]
        seen[sy, sx] = True
        comp = np.zeros_like(mask, bool)
        while stack:
            y, x = stack.pop()
            comp[y, x] = True
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    ny, nx = y + dy, x + dx
                    if (0 <= ny < h and 0 <= nx < w and mask[ny, nx]
                            and not seen[ny, nx]):
                        seen[ny, nx] = True
                        stack.append((ny, nx))
        comps.append(comp)
    return comps


def _boundary_points(comp: np.ndarray) -> np.ndarray:
    """Moore-neighbor border trace of a component, reproducing the point
    sequence (including revisits of 1-px-wide parts) that the reference's
    cv2.findContours(CHAIN_APPROX_NONE) feeds into fitEllipse — validated
    to produce identical point multisets on randomized blobs."""
    ys, xs = np.nonzero(comp)
    order = np.lexsort((xs, ys))  # raster order: topmost, then leftmost
    sy, sx = int(ys[order[0]]), int(xs[order[0]])
    h, w = comp.shape

    def fg(y, x):
        return 0 <= y < h and 0 <= x < w and comp[y, x]

    # counterclockwise directions (y-down coords): E NE N NW W SW S SE
    dirs = [(0, 1), (-1, 1), (-1, 0), (-1, -1),
            (0, -1), (1, -1), (1, 0), (1, 1)]
    pts = [(sx, sy)]
    if not any(fg(sy + dy, sx + dx) for dy, dx in dirs):
        return np.array(pts, np.float64)
    prev_dir = 4  # pretend we arrived from the west
    y, x = sy, sx
    while True:
        moved = False
        for k in range(8):
            d = (prev_dir + 1 + k) % 8
            dy, dx = dirs[d]
            if fg(y + dy, x + dx):
                y, x = y + dy, x + dx
                prev_dir = (d + 4) % 8
                moved = True
                break
        if not moved or ((x, y) == (sx, sy) and len(pts) > 1):
            break
        pts.append((x, y))
        if len(pts) > 4 * (h * w):  # safety bound
            break
    return np.array(pts, np.float64)


def fit_ellipse(points: np.ndarray) -> Tuple[Tuple[float, float], Tuple[float, float]]:
    """Direct least-squares ellipse fit (Fitzgibbon / Halir-Flusser).

    Returns ((cx, cy), (width, height)) like cv2.fitEllipse's center/size
    (axis lengths = full axes, unordered orientation ignored).
    """
    x = points[:, 0]
    y = points[:, 1]
    xm, ym = x.mean(), y.mean()
    xs, ys = x - xm, y - ym

    D1 = np.stack([xs ** 2, xs * ys, ys ** 2], axis=1)
    D2 = np.stack([xs, ys, np.ones_like(xs)], axis=1)
    S1 = D1.T @ D1
    S2 = D1.T @ D2
    S3 = D2.T @ D2
    T = -np.linalg.solve(S3, S2.T)
    M = S1 + S2 @ T
    C_inv_M = np.array([M[2] / 2.0, -M[1], M[0] / 2.0])
    eigval, eigvec = np.linalg.eig(C_inv_M)
    cond = 4 * eigvec[0] * eigvec[2] - eigvec[1] ** 2
    a1 = eigvec[:, cond > 0][:, 0]
    a, b, c, d, e, f = np.concatenate([a1, T @ a1])

    # center: gradient of the conic vanishes
    cx, cy = np.linalg.solve(
        np.array([[2 * a, b], [b, 2 * c]]), np.array([-d, -e]))
    # conic value at the center
    f_c = a * cx * cx + b * cx * cy + c * cy * cy + d * cx + e * cy + f
    # centered quadratic form: [x y] M [x y]^T = -f_c
    M = np.array([[a, b / 2.0], [b / 2.0, c]]) / (-f_c)
    lam = np.linalg.eigvalsh(M)
    if (lam <= 0).any():
        raise ValueError("degenerate ellipse fit")
    semi = 1.0 / np.sqrt(lam)
    width, height = 2.0 * semi[0], 2.0 * semi[1]
    return ((cx + xm, cy + ym), (width, height))


def main(argv: "Union[None, List[str]]" = None) -> None:
    """Calibration CLI for bringing up a NEW camera:
    `python -m meterelf_jax.calibration PARAMS_FILE [N_SAMPLES|FILE...]`
    averages sample frames (default: 255 random frames from the params'
    image_glob, or the given count/files), finds the dial centers, and
    prints them as YAML-pasteable `center`/`diameter` needle fields
    (sorted by x, the params file's dial order). The reference exposes
    this only as a library helper its tests call
    (/root/reference/meterelf/_calibration.py:16)."""
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print("usage: python -m meterelf_jax.calibration PARAMS_FILE "
              "[N_SAMPLES | IMAGE_FILE...]", file=sys.stderr)
        raise SystemExit(1)
    from .compile_cache import setup_compile_cache

    setup_compile_cache()
    params = Params.load(args[0])
    files: Union[int, List[str]]
    if len(args) == 1:
        files = min(255, len(get_image_filenames(params)))
    elif len(args) == 2 and args[1].isdigit():
        files = int(args[1])
    else:
        files = args[1:]
    centers = find_dial_centers(params, files)
    print(f"# {len(centers)} dial centers (sorted by x); paste per-dial"
          " into the params' needle entries")
    for i, dc in enumerate(centers):
        print(f"# dial {i + 1}")
        print(f"center: [{dc.center[0]:.1f}, {dc.center[1]:.1f}]")
        print(f"diameter: {dc.diameter:g}")


if __name__ == "__main__":  # pragma: no cover - exercised via CLI test
    main()
