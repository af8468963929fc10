"""Synthetic camera configs and meter frames.

Generates a complete Params (dial template PNG + YAML-schema dict) and
renderable meter frames with needles at known angles, so the framework
can be exercised — entry-point compile checks, multi-chip dry runs,
self-validating end-to-end tests — without the reference sample corpus.

Parameterized by `SyntheticCamera`: the module-level functions serve the
DEFAULT camera (the reference's 188x119-template / 250x250-crop shape),
while `ALT_CAMERA` is a deliberately different geometry (141x90
template, 210x200 crop) — proof the framework is not hardwired to one
camera (reference analog: the two shipped params.yml files,
sample-images1/2)."""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .params import Params
from .types import Rect

TEMPLATE_H = 119
TEMPLATE_W = 188
FRAME_H = 480
FRAME_W = 640
METER_RECT = Rect((50, 160), (300, 410))

# dial layout mirroring the real meter's scattered arrangement
DIAL_SPECS = [
    ("0.0001", (37.3, 63.4), 16),
    ("0.001", (94.0, 86.0), 15),
    ("0.01", (135.0, 71.9), 11),
    ("0.1", (160.9, 36.5), 12),
]


@dataclasses.dataclass(frozen=True)
class SyntheticCamera:
    """One synthetic camera geometry: template + crop + dial layout."""

    template_h: int = TEMPLATE_H
    template_w: int = TEMPLATE_W
    frame_h: int = FRAME_H
    frame_w: int = FRAME_W
    meter_rect: Rect = METER_RECT
    dial_specs: Sequence[Tuple[str, Tuple[float, float], int]] = tuple(
        DIAL_SPECS)
    seed: int = 1234

    def make_template(self) -> np.ndarray:
        """Grayscale dial-cluster template with distinctive structure (so
        the correlation has a sharp, unambiguous peak)."""
        rng = np.random.default_rng(self.seed)
        t = np.full((self.template_h, self.template_w), 200, np.uint8)
        t = (t + rng.integers(-20, 20, t.shape)).astype(np.uint8)
        yy, xx = np.mgrid[:self.template_h, :self.template_w]
        for _name, (cx, cy), diam in self.dial_specs:
            r2 = (yy - cy) ** 2 + (xx - cx) ** 2
            ring = (r2 <= (diam + 8) ** 2) & (r2 >= (diam + 4) ** 2)
            t[ring] = 60
            t[r2 <= (diam // 2) ** 2] = 120
        return t

    def params_dict(self, template_file: str) -> Dict:
        (x0, y0), (x1, y1) = self.meter_rect
        return {
            "image_glob": "*.jpg",
            "meter_rect": {"top_left": [x0, y0], "bottom_right": [x1, y1]},
            "dials_template": os.path.basename(template_file),
            "dials_template_match_threshold": 1000000,
            "dials_template_size": [self.template_w, self.template_h],
            "hue_shift": 128,
            "needle_color": {"h": 125, "l": 80, "s": 130},
            "needle_color_range": {"h": 9, "l": 45, "s": 35},
            "needle_data": [
                {
                    "name": name,
                    "color_range": {"h": 15, "l": 60, "s": 80},
                    "dist_from_center": 4,
                    "circle_thickness": 10,
                    "angle_of_zero": -4.5,
                    "center": [float(cx), float(cy)],
                    "diameter": diam,
                    "negative_momentum": name == "0.001",
                }
                for name, (cx, cy), diam in self.dial_specs
            ],
        }

    def make_params(self, dir_path: str) -> Params:
        """Write template + params into dir_path and load a Params."""
        from .io.png import write_png_gray

        os.makedirs(dir_path, exist_ok=True)
        tpath = os.path.join(dir_path, "synthetic_template.png")
        write_png_gray(tpath, self.make_template())
        return Params(dir_path, self.params_dict(tpath))

    def render_frame(
        self,
        dial_positions: List[float],
        offset: Tuple[int, int] = (30, 40),
        rng: Optional[np.random.Generator] = None,
        stub_dials: Tuple[int, ...] = (),
    ) -> np.ndarray:
        """Render a BGR frame: gray background, template-like dial cluster
        at meter_rect.top_left + offset, red needles at the given
        positions (fraction-of-dial 0..10; needle angle convention matches
        the reference: 0 = up, clockwise)."""
        rng = rng or np.random.default_rng(0)
        frame = np.full((self.frame_h, self.frame_w, 3), 180, np.uint8)
        tmpl = self.make_template()
        ox = self.meter_rect.top_left[0] + offset[0]
        oy = self.meter_rect.top_left[1] + offset[1]
        frame[oy:oy + self.template_h,
              ox:ox + self.template_w] = tmpl[..., None]

        for di, (name_spec, pos) in enumerate(
                zip(self.dial_specs, dial_positions)):
            name, (cx, cy), diam = name_spec
            negative = name == "0.001"
            zero_turn = -4.5 / 360.0
            angle = pos / 10.0 + zero_turn  # invert pos = 10*(angle-zero)
            theta = 2 * math.pi * angle
            dx = math.sin(theta)
            dy = -math.cos(theta)
            tip_len = diam / 2.0 + 4 + 9

            def paint(px, py, rad):
                for ddy in range(-rad, rad + 1):
                    for ddx in range(-rad, rad + 1):
                        x, y = int(round(px + ddx)), int(round(py + ddy))
                        if 0 <= x < self.template_w and 0 <= y < self.template_h:
                            frame[oy + y, ox + x] = (40, 40, 200)  # BGR red

            if di in stub_dials:
                # a needle stub that never reaches the tip annulus: the
                # dial becomes unreadable (no tip pixels survive)
                paint(cx, cy, 2)
                continue
            if negative:
                # counterweighted needle (negative_momentum geometry): a
                # fat mass on the tail side dominates the distance^2
                # momentum, while a thin connected spur pokes just into
                # the annulus on the tip side
                r0 = diam // 2 + 4
                for t in np.linspace(0, r0 - 2, 24):
                    paint(cx - dx * t, cy - dy * t, 5)
                for t in np.linspace(0, r0 + 3, 48):
                    paint(cx + dx * t, cy + dy * t, 1)
            else:
                for t in np.linspace(0, tip_len, 64):
                    paint(cx + dx * t, cy + dy * t, 2)
        return frame

    def render_crops(self, batch_positions: List[List[float]]) -> np.ndarray:
        """Render a batch of meter-rect crops [B, ch, cw, 3] u8."""
        crops = []
        (x0, y0), (x1, y1) = self.meter_rect
        max_ox = (x1 - x0) - self.template_w - 1
        max_oy = (y1 - y0) - self.template_h - 1
        for i, pos in enumerate(batch_positions):
            f = self.render_frame(
                pos, offset=(min(20 + (i % 3) * 7, max_ox),
                             min(30 + (i % 5) * 5, max_oy)))
            crops.append(f[y0:y1, x0:x1])
        return np.stack(crops)


DEFAULT_CAMERA = SyntheticCamera()

# A second, deliberately different geometry: smaller template, different
# crop size, shifted dial layout.
ALT_CAMERA = SyntheticCamera(
    template_h=90,
    template_w=141,
    meter_rect=Rect((60, 120), (270, 320)),   # 210 x 200 crop
    # pairwise center distances >= ~38 px: a neighbor's needle tip
    # (reach ~18.5) can never enter another dial's disk (radius ~19.5)
    dial_specs=(
        ("0.0001", (20.0, 52.0), 14),
        ("0.001", (62.0, 70.0), 13),
        ("0.01", (96.0, 48.0), 11),
        ("0.1", (122.0, 20.0), 11),
    ),
    seed=77,
)


def make_template() -> np.ndarray:
    return DEFAULT_CAMERA.make_template()


def params_dict(template_file: str) -> Dict:
    return DEFAULT_CAMERA.params_dict(template_file)


def make_params(dir_path: str) -> Params:
    return DEFAULT_CAMERA.make_params(dir_path)


def render_frame(
    dial_positions: List[float],
    offset: Tuple[int, int] = (30, 40),
    rng: Optional[np.random.Generator] = None,
    stub_dials: Tuple[int, ...] = (),
) -> np.ndarray:
    return DEFAULT_CAMERA.render_frame(
        dial_positions, offset=offset, rng=rng, stub_dials=stub_dials)


def render_crops(batch_positions: List[List[float]]) -> np.ndarray:
    return DEFAULT_CAMERA.render_crops(batch_positions)
