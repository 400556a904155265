"""Offline visualization (counterpart of ``semantic_suma_tpu/utils/viz.py``):
trajectories against ground truth with loop-closure markers, per-scan
statistics time series, the devkit's error plots, and depth / normal /
semantic map images, as PNG files.

The JAX package draws them with matplotlib. The machines the port runs on
need not have a plotting library (the H100 hosts have none), so these are
drawn with numpy (lines, markers, the ``bitmap_font`` text) and written
with ``zlib``: the same files, names and content (curves, markers, axes
with ticks, labels, legend, title), drawn more plainly.

The functions take numpy arrays or tensors on any device; a tensor comes to
the host through ``device.AsyncFetch`` (one read, counted in
``device.to_host.count``).
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import AsyncFetch
from . import bitmap_font as bf

WHITE, BLACK, GRAY = (255, 255, 255), (0, 0, 0), (128, 128, 128)
GRID = (225, 225, 225)
BLUE, GREEN, RED = (0, 0, 255), (0, 128, 0), (255, 0, 0)
SERIES = (31, 119, 180)                  # matplotlib's first cycle colour
T_HUE, R_HUE = (59, 95, 192), (176, 74, 62)   # t_rel blue, r_rel red-brown


def _np(a) -> np.ndarray:
    """A numpy array of ``a``; a tensor is read through the counted door."""
    if isinstance(a, torch.Tensor):
        return AsyncFetch(a.detach()).wait()
    return np.asarray(a)


def write_png(path: str, img: np.ndarray) -> None:
    """An ``[H, W, 3]`` uint8 image as an 8-bit RGB PNG."""
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(img, np.uint8).reshape(h, -1)],
                         axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _text_mask(s: str, scale: int = 1) -> np.ndarray:
    """The pixels of ``s`` in the bitmap font, ``[14 s, 8 s len]`` bool."""
    blank = np.zeros((bf.HEIGHT, bf.WIDTH), bool)
    cells = [np.unpackbits(np.frombuffer(bytes.fromhex(bf.GLYPHS[c]),
                                         np.uint8)).reshape(bf.HEIGHT,
                                                            bf.WIDTH)
             .astype(bool) if c in bf.GLYPHS else blank for c in s]
    mask = np.concatenate(cells, axis=1) if cells else blank[:, :0]
    return mask.repeat(scale, axis=0).repeat(scale, axis=1)


class _Canvas:
    """A white RGB image with clipped drawing primitives."""

    def __init__(self, width: int, height: int):
        self.img = np.full((height, width, 3), 255, np.uint8)

    def _put(self, xs, ys, color, clip=None) -> None:
        xs = np.rint(np.asarray(xs, np.float64)).astype(np.int64)
        ys = np.rint(np.asarray(ys, np.float64)).astype(np.int64)
        h, w = self.img.shape[:2]
        x0, y0, x1, y1 = clip if clip is not None else (0, 0, w - 1, h - 1)
        ok = (xs >= max(x0, 0)) & (xs <= min(x1, w - 1)) \
            & (ys >= max(y0, 0)) & (ys <= min(y1, h - 1))
        self.img[ys[ok], xs[ok]] = color

    def rect(self, x0, y0, x1, y1, color, fill=False) -> None:
        if fill:
            self.img[max(y0, 0):y1 + 1, max(x0, 0):x1 + 1] = color
            return
        self.polyline([x0, x1, x1, x0, x0], [y0, y0, y1, y1, y0], color)

    def polyline(self, xs, ys, color, width: int = 1, dash=None,
                 clip=None) -> None:
        """Connected segments through the points (non-finite points break
        the line), ``width`` pixels wide, ``dash`` = (on, off) pixels."""
        xs = np.atleast_1d(np.asarray(xs, np.float64))
        ys = np.atleast_1d(np.asarray(ys, np.float64))
        if xs.size == 1 and np.isfinite(xs[0]) and np.isfinite(ys[0]):
            xs, ys = np.repeat(xs, 2), np.repeat(ys, 2)
        dx, dy = np.diff(xs), np.diff(ys)
        ok = np.isfinite(dx) & np.isfinite(dy)
        if not ok.any():
            return
        x0, y0, dx, dy = xs[:-1][ok], ys[:-1][ok], dx[ok], dy[ok]
        n = np.ceil(np.maximum(np.abs(dx), np.abs(dy))).astype(np.int64) + 1
        seg = np.repeat(np.arange(n.size), n)
        t = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) \
            / np.maximum(n[seg] - 1, 1)
        px, py = x0[seg] + t * dx[seg], y0[seg] + t * dy[seg]
        if dash is not None:
            length = np.hypot(dx, dy)
            arc = np.repeat(np.cumsum(length) - length, n) + t * length[seg]
            keep = (arc % (dash[0] + dash[1])) < dash[0]
            px, py = px[keep], py[keep]
        r = width // 2
        for ox in range(-r, width - r):
            for oy in range(-r, width - r):
                self._put(px + ox, py + oy, color, clip)

    def marker(self, x, y, color, kind: str = "o", size: int = 5) -> None:
        if not (np.isfinite(x) and np.isfinite(y)):
            return
        if kind == "o":
            oy, ox = np.mgrid[-size:size + 1, -size:size + 1]
            disk = ox ** 2 + oy ** 2 <= size ** 2
            self._put(x + ox[disk], y + oy[disk], color)
            return
        for a in range(5):    # "*": five spokes
            ang = -math.pi / 2 + a * 2 * math.pi / 5
            self.polyline([x, x + size * math.cos(ang)],
                          [y, y + size * math.sin(ang)], color, width=2)

    def text(self, x, y, s: str, color=BLACK, scale: int = 1,
             ha: str = "left", va: str = "top", rotate: bool = False) -> None:
        """``s`` placed by its (``ha``, ``va``) corner at (x, y);
        ``rotate`` turns it a quarter to read bottom to top."""
        mask = _text_mask(s, scale)
        if rotate:
            mask = np.rot90(mask)
        h, w = mask.shape
        x0 = int(round(x - {"left": 0, "center": w / 2, "right": w}[ha]))
        y0 = int(round(y - {"top": 0, "center": h / 2, "bottom": h}[va]))
        ys, xs = np.nonzero(mask)
        self._put(xs + x0, ys + y0, color)


def _nice_ticks(lo: float, hi: float, n: int = 6):
    """Round tick values within [lo, hi] and their labels."""
    span = hi - lo
    raw = span / n
    mag = 10.0 ** math.floor(math.log10(raw))
    mult = next(m for m in (1, 2, 2.5, 5, 10) if m * mag >= raw)
    step = mult * mag
    ticks = np.arange(math.ceil(lo / step) * step, hi + step * 1e-9, step)
    big = max(abs(lo), abs(hi))
    if big >= 1e5 or big < 1e-3:
        return ticks, [f"{v:.2e}" for v in ticks]
    digits = max(0, -math.floor(math.log10(step)) + (mult == 2.5))
    return ticks, [f"{0.0 if abs(v) < step * 1e-6 else v:.{digits}f}"
                   for v in ticks]


def _limits(*arrays, margin: float = 0.05):
    v = np.concatenate([np.asarray(a, np.float64).ravel() for a in arrays])
    v = v[np.isfinite(v)]
    if v.size == 0:
        return 0.0, 1.0
    lo, hi = float(v.min()), float(v.max())
    if hi - lo < 1e-12 * max(1.0, abs(lo)):
        pad = max(abs(lo) * 0.05, 0.5)
        return lo - pad, hi + pad
    pad = (hi - lo) * margin
    return lo - pad, hi + pad


class _Axes:
    """A data box on a canvas: maps data to pixels, draws the frame, grid,
    ticks and labels, and clips what is plotted to the box."""

    def __init__(self, canvas: _Canvas, box, xlim, ylim):
        self.c, self.box = canvas, box
        self.xlim, self.ylim = xlim, ylim

    def px(self, x, y):
        x0, y0, x1, y1 = self.box
        (xl, xh), (yl, yh) = self.xlim, self.ylim
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        return (x0 + (x - xl) / (xh - xl) * (x1 - x0),
                y1 - (y - yl) / (yh - yl) * (y1 - y0))

    def decorate(self, xticks=None, xlabels=None, xlabel="", ylabel="",
                 title="", show_xlabels=True) -> None:
        x0, y0, x1, y1 = self.box
        if xticks is None:
            xticks, xlabels = _nice_ticks(*self.xlim)
        yticks, ylabels = _nice_ticks(*self.ylim)
        for v, lab in zip(xticks, xlabels):
            p = float(self.px(v, self.ylim[0])[0])
            self.c.polyline([p, p], [y0, y1], GRID)
            self.c.polyline([p, p], [y1, y1 + 4], BLACK)
            if show_xlabels:
                self.c.text(p, y1 + 7, lab, ha="center")
        for v, lab in zip(yticks, ylabels):
            p = float(self.px(self.xlim[0], v)[1])
            self.c.polyline([x0, x1], [p, p], GRID)
            self.c.polyline([x0 - 4, x0], [p, p], BLACK)
            self.c.text(x0 - 7, p, lab, ha="right", va="center")
        self.c.rect(x0, y0, x1, y1, BLACK)
        if xlabel and show_xlabels:
            self.c.text((x0 + x1) / 2, y1 + 26, xlabel, ha="center")
        if ylabel:
            width = max(len(lab) for lab in ylabels) * bf.WIDTH
            self.c.text(x0 - 14 - width, (y0 + y1) / 2, ylabel, ha="right",
                        va="center", rotate=True)
        if title:
            self.c.text((x0 + x1) / 2, y0 - 8, title, scale=2, ha="center",
                        va="bottom")

    def plot(self, x, y, color, width: int = 1, dash=None,
             marker: str | None = None, size: int = 5) -> None:
        px, py = self.px(x, y)
        self.c.polyline(px, py, color, width, dash, clip=self.box)
        if marker:
            for a, b in zip(np.atleast_1d(px), np.atleast_1d(py)):
                self.c.marker(a, b, color, marker, size)

    def legend(self, entries) -> None:
        """Entries ``(label, color, dash, marker)`` in a box at the upper
        right."""
        x1, y0 = self.box[2], self.box[1]
        w = 50 + max(len(e[0]) for e in entries) * bf.WIDTH
        h = 10 + 20 * len(entries)
        bx0, by0 = x1 - 10 - w, y0 + 10
        self.c.rect(bx0, by0, bx0 + w, by0 + h, WHITE, fill=True)
        self.c.rect(bx0, by0, bx0 + w, by0 + h, GRAY)
        for k, (label, color, dash, marker) in enumerate(entries):
            yy = by0 + 15 + 20 * k
            if marker:
                self.c.marker(bx0 + 22, yy, color, marker, 5)
            else:
                self.c.polyline([bx0 + 8, bx0 + 36], [yy, yy], color, 2, dash)
            self.c.text(bx0 + 44, yy, label, va="center")


def plot_trajectory(est, gt: Optional[np.ndarray] = None,
                    loop_frames: Sequence[int] = (), path: str = "traj.png",
                    title: str = "trajectory") -> None:
    """Bird's-eye XY trajectory plot (the devkit's gnuplot path plot,
    kitti_utils.cpp savePathPlot analogue), equal scales on both axes."""
    est = _np(est)
    gt = None if gt is None else _np(gt)
    c = _Canvas(960, 960)
    xs = [est[:, 0, 3]] + ([gt[:, 0, 3]] if gt is not None else [])
    ys = [est[:, 1, 3]] + ([gt[:, 1, 3]] if gt is not None else [])
    (xl, xh), (yl, yh) = _limits(*xs), _limits(*ys)
    half = max(xh - xl, yh - yl) / 2
    cx, cy = (xl + xh) / 2, (yl + yh) / 2
    ax = _Axes(c, (110, 50, 930, 870), (cx - half, cx + half),
               (cy - half, cy + half))
    ax.decorate(xlabel="x [m]", ylabel="y [m]", title=title)
    entries = []
    if gt is not None:
        ax.plot(gt[:, 0, 3], gt[:, 1, 3], BLACK, 2, dash=(8, 5))
        entries.append(("ground truth", BLACK, (8, 5), None))
    ax.plot(est[:, 0, 3], est[:, 1, 3], BLUE, 2)
    ax.plot(est[0, 0, 3], est[0, 1, 3], GREEN, marker="o", size=6)
    for f in loop_frames:
        if f < len(est):
            ax.plot(est[f, 0, 3], est[f, 1, 3], RED, marker="*", size=8)
    entries += [("estimate", BLUE, None, None), ("start", GREEN, None, "o")]
    ax.legend(entries)
    write_png(path, c.img)


def plot_statistics(statistics: list[dict], keys: Sequence[str] = (
        "icp-iterations", "icp-error", "map-count", "complete-time"),
        path: str = "stats.png") -> None:
    """Per-scan statistics time series (the GraphWidget live plots,
    VisualizerWindow.cpp:701-714): one panel a key, a shared scan axis."""
    keys = [k for k in keys if statistics and k in statistics[0]]
    if not keys:
        raise ValueError("no statistics to plot")
    panel = 264
    c = _Canvas(1200, panel * len(keys) + 40)
    n = len(statistics)
    xlim = _limits([0, max(n - 1, 1)], margin=0.02)
    for i, key in enumerate(keys):
        y = np.array([s.get(key, np.nan) for s in statistics], np.float64)
        ax = _Axes(c, (150, panel * i + 14, 1180, panel * (i + 1) - 30),
                   xlim, _limits(y))
        ax.decorate(xlabel="scan", ylabel=key,
                    show_xlabels=i == len(keys) - 1)
        ax.plot(np.arange(n), y, SERIES, 1)
    write_png(path, c.img)


def plot_error_breakdown(by_length: dict, by_speed: dict,
                         path: str = "errors.png") -> None:
    """Devkit error plots: t_rel / r_rel against segment length and against
    speed (the reference devkit's saveErrorPlots tl/rl/ts/rs gnuplot
    outputs, kitti_utils.cpp:149-191), as four panels; input dicts come from
    ``metrics.evaluate(..., breakdown=True)``. One metric a panel, each
    metric in one hue across both rows."""
    c = _Canvas(1200, 720)
    c.text(600, 8, "KITTI-devkit segment errors", scale=2, ha="center")
    rows = [("segment length", by_length), ("speed bucket", by_speed)]
    fields = (("t_rel_percent", "t_rel [%]", T_HUE),
              ("r_rel_deg_per_100m", "r_rel [deg/100m]", R_HUE))
    for r, (xlabel, table) in enumerate(rows):
        names = list(table.keys())
        x = np.arange(len(names), dtype=np.float64)
        for col, (field, label, hue) in enumerate(fields):
            y = np.array([table[k][field] for k in names], np.float64)
            box = (110 + 600 * col, 60 + 330 * r, 570 + 600 * col,
                   300 + 330 * r)
            ax = _Axes(c, box, _limits(x if names else [0, 1]),
                       _limits(y) if names else (0.0, 1.0))
            ax.decorate(xticks=x, xlabels=[str(k) for k in names],
                        xlabel=xlabel, ylabel=label)
            ax.plot(x, y, hue, 2, marker="o", size=4)
            if not names:
                c.text((box[0] + box[2]) / 2, (box[1] + box[3]) / 2,
                       "no segments", GRAY, ha="center", va="center")
    write_png(path, c.img)


def _turbo(t: np.ndarray) -> np.ndarray:
    """The turbo colour map at ``t`` in [0, 1] (Google's polynomial fit of
    it, within 0.13 of the table), as uint8 RGB."""
    t = np.clip(t, 0.0, 1.0)[..., None]
    coef = np.array([
        [0.13572138, 4.61539260, -42.66032258, 132.13108234, -152.94239396,
         59.28637943],
        [0.09140261, 2.19418839, 4.84296658, -14.18503333, 4.27729857,
         2.82956604],
        [0.10667330, 12.64194608, -60.58204836, 110.36276771, -89.90310912,
         27.34824973]])
    rgb = sum(coef[:, k] * t ** k for k in range(6))
    return (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)


def save_map_images(maps, prefix: str = "frame") -> list[str]:
    """Dump depth / normal / semantic map images of a ``Maps`` tuple (the
    renderMaps texture dump, VisualizerWindow.cpp:815-840); returns the
    three paths."""
    from ..models.labels import label_colors
    vertex = _np(maps.vertex).astype(np.float64)
    valid = _np(maps.vertex_valid).astype(bool)
    h, w = valid.shape
    # nearest-neighbour scaling to at least 1200 columns, about six times
    # as wide as high (the JAX package's 12 x 2 inch figures)
    sx = max(1, math.ceil(1200 / w))
    sy = max(1, round(w * sx / (6 * h)))
    out = []

    depth = np.linalg.norm(vertex, axis=-1)
    lo, hi = _limits(depth[valid], margin=0.0) if valid.any() else (0, 1)
    img = np.where(valid[..., None], _turbo((depth - lo) / (hi - lo)), 255)
    normal = np.clip(_np(maps.normal) * 0.5 + 0.5, 0.0, 1.0)
    sem = label_colors(_np(maps.sem_label))
    for name, im in (
            ("depth", img),
            ("normals", np.where(valid[..., None], normal * 255, 0)),
            ("semantics", np.where(valid[..., None], sem, 0))):
        p = f"{prefix}_{name}.png"
        write_png(p, np.asarray(im, np.uint8).repeat(sy, 0).repeat(sx, 1))
        out.append(p)
    return out
