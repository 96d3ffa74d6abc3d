"""Particle-field rendering to PNG: render2d, boundary_segments, save_png.

Counterpart of adaptive_sph_tpu/utils/render.py, on the host: a white
canvas, world scale min(W, H) / (2 zoom_out) centred on the origin with y
up, the boundary lines (5/1000 wide), filled circles at the physical radius
r(m / rho0) with a black border of 0.1 r (utils/raster.py), then the
gradient legend with its labelled stops and the title (`#p`: the particle
count) drawn with Pillow. The labels use Pillow's own scalable font
(`ImageFont.load_default(size)`), so the text does not depend on the fonts a
machine has installed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from ..models import boundary as bnd
from ..ops import kernels
from ..ops.sdf import SdfPlane, SdfPolygon2D
from . import raster
from .colors import ColorMap

SCENE_WIDTH = 2.0


def boundary_segments(boundary_handler) -> np.ndarray:
    """(n, 4) float32 world-space line segments of the boundary's shapes."""
    segs = []
    if isinstance(boundary_handler, bnd.WinchenbachBoundary):
        for s in boundary_handler.sdfs:
            if isinstance(s, SdfPlane):
                # the plane as a segment of length 5 through dir * delta
                d = np.asarray(s.direction, np.float64)
                line_dir = np.asarray([-d[1], d[0]])
                center = d * s.delta
                a = center + line_dir * 2.5
                b = center - line_dir * 2.5
                segs.append([a[0], a[1], b[0], b[1]])
            elif isinstance(s, SdfPolygon2D):
                for (a, b) in s.draw_lines():
                    segs.append([a[0], a[1], b[0], b[1]])
    return np.asarray(segs, np.float32).reshape(-1, 4)


def particle_radii(masses, rest_density: float) -> np.ndarray:
    """Physical radii r(m / rho0) as float32, rounded as the reference rounds
    them (the volume in float64, its square root in float32)."""
    vol = np.asarray(masses, np.float64) / rest_density / kernels.PI
    return np.sqrt(vol.astype(np.float32))


def render_canvas(positions, masses, rest_density: float, colors, boundary_handler,
                  img_width: int, img_height: int, zoom_out: float) -> np.ndarray:
    """The (H, W, 3) float32 canvas before the legend and the title: the
    boundary lines, then the particles in index order."""
    img = raster.new_canvas(img_width, img_height)
    scale = min(img_width, img_height) / (SCENE_WIDTH * zoom_out)
    segs = boundary_segments(boundary_handler)
    if len(segs):
        raster.draw_lines(img, segs, scale, width_world=5.0 / 1000.0)
    raster.draw_circles(img, positions, particle_radii(masses, rest_density),
                        np.asarray(colors, np.float32), scale)
    return img


def render2d(
    positions: np.ndarray,
    masses: np.ndarray,
    rest_density: float,
    colors: np.ndarray,
    boundary_handler,
    img_width: int = 2000,
    img_height: int = 2000,
    legend: Optional[dict] = None,  # {color_map, text_right, only_min_max}
    title: Optional[str] = None,
    zoom_out: float = 1.04,
) -> np.ndarray:
    """Returns an (H, W, 3) uint8 image."""
    img = render_canvas(positions, masses, rest_density, colors, boundary_handler, img_width,
                        img_height, zoom_out)
    out = Image.fromarray(raster.to_uint8(img))
    draw = ImageDraw.Draw(out)

    if legend is not None:
        cm: ColorMap = legend["color_map"]
        lx, ly = img_width * 0.83, img_height * 0.5
        lw, lh = img_width * 0.07, img_height * 0.3
        vmin, vmax = float(cm.xs[0]), float(cm.xs[-1])
        # the gradient box spans screen rows [H - (ly + lh), H - ly], the value
        # increasing upward; a label's row is H - (ly + interp lh)
        top = img_height - (ly + lh)
        grad = cm.get(np.linspace(vmax, vmin, int(lh)))  # (lh, 3), top row = vmax
        grad_img = np.repeat(grad[:, None, :], int(lw), axis=1)
        out.paste(Image.fromarray((np.clip(grad_img, 0, 1) * 255).astype(np.uint8)),
                  (int(lx), int(top)))
        draw.rectangle([lx, top, lx + lw, top + lh], outline=(0, 0, 0), width=3)

        font = ImageFont.load_default(size=int(img_height * 0.04))
        stops = [vmin, vmax] if legend.get("only_min_max") else [float(x) for x in cm.xs]
        ind = img_width * 0.01
        for v in stops:
            interp = (v - vmin) / (vmax - vmin) if vmax > vmin else 0.0
            yc = img_height - (ly + interp * lh)
            label = f"{round(v * 1000.0) / 1000.0:g}"
            tw = draw.textlength(label, font=font)
            if legend.get("text_right"):
                draw.line([lx + lw, yc, lx + lw + ind, yc], fill=(0, 0, 0), width=3)
                draw.text((lx + lw + ind + img_width * 0.008, yc), label, fill=(0, 0, 0),
                          font=font, anchor="lm")
            else:
                draw.line([lx - ind, yc, lx, yc], fill=(0, 0, 0), width=3)
                draw.text((lx - ind - img_width * 0.008 - tw, yc), label, fill=(0, 0, 0),
                          font=font, anchor="lm")

    if title is not None:
        t = title.replace("#p", str(len(positions)))
        font = ImageFont.load_default(size=int(img_width * 0.048))
        x, y = img_width * 0.02, img_height * 0.01
        draw.text((x, y), t, fill=(0, 0, 0), font=font,
                  stroke_width=int(img_height * 0.006), stroke_fill=(255, 255, 255))

    return np.asarray(out)


def save_png(img: np.ndarray, path: str):
    Image.fromarray(img).save(path)
