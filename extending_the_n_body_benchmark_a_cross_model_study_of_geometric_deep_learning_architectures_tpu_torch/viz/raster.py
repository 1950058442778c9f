"""Raster figures in numpy: the port's stand-in for matplotlib's Agg canvas.

A figure is first a *description*, plain data: a :class:`Figure` holds its
file name, its size in inches and a grid of :class:`Panel` (one per axes),
and each panel its title, labels, scales and what it shows, with the arrays
as they were given: histogram bars (:class:`Bars`, edges and counts), lines
(:class:`Line`, their points, non-finite ones kept), bands
(:class:`Band`, ``fill_between``) and 3D points (:class:`Points`).  The
methods of :class:`Panel` take the arguments of the matplotlib calls they
stand for.  :func:`render` then draws the description into an RGB ``uint8``
array ``[H, W, 3]`` at 100 dpi, matplotlib's default, so that
``figsize=(10, 12)`` is 1000 x 1200 pixels; :func:`save` writes it as PNG.

What is drawn: the ``subplots`` grid with margins fitted to the labels (a
tight layout), a frame, linear and log10 axes with ticks and tick labels,
shared x or y limits, an equal aspect (``adjustable="datalim"``), titles,
axis labels (the y label turned 90 degrees) and a legend box; filled and
edged rectangles, polylines sampled half a pixel apart and blended once
a line, dashed and dotted lines, filled bands, disc markers, box plots with
matplotlib's default statistics, and an orthographic 3D view.  Non-finite
points are dropped as matplotlib drops them, and segments are clipped to the
axes before they are sampled.

What differs from matplotlib's pixels: the font is a 1-bit bitmap of DejaVu
Sans at 9 pt (printable ASCII 32-126, the glyph table below, one size for
every text), so a non-ASCII character is drawn as its ASCII stand-in
(:data:`STAND_INS`, else ``?``) while the description keeps the exact
string; nothing is anti-aliased; ticks are chosen by a simpler rule, log
ticks are labelled ``1e-5``; the legend sits at the upper right; box plot
tick labels are not rotated; the 3D view is orthographic (elevation 30,
azimuth -60, matplotlib's default angles) without ticks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import encode

DPI = 100
# matplotlib's default colour cycle (tab10)
TAB10 = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
         "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")
NAMED = {"black": "#000000", "white": "#ffffff", "red": "#ff0000", "blue": "#0000ff",
         "green": "#008000", "gray": "#808080", "grey": "#808080"}
# drawn in place of a character outside printable ASCII
STAND_INS = {"—": "-", "–": "-", "−": "-", "Σ": "S", "·": "."}

PT = DPI / 72.0  # pixels a point
TICK = 5  # tick length, pixels
PAD = 8  # around each panel's cell
GRID_GRAY = (176, 176, 176)

# The font: DejaVu Sans at 9 pt and 100 dpi, rasterised without anti-aliasing.
# Per character its cell width and one hex number a row (14 rows; the
# highest bit is the leftmost pixel); the baseline lies under row 11.
_GLYPH_TABLE = {
    ' ': (4, "0 0 0 0 0 0 0 0 0 0 0 0 0 0"),
    '!': (5, "0 0 4 4 4 4 4 4 0 0 4 0 0 0"),
    '"': (5, "0 0 a a a 0 0 0 0 0 0 0 0 0"),
    '#': (11, "0 0 28 48 48 1fe 50 90 3fc 90 a0 0 0 0"),
    '$': (8, "0 10 10 3e 52 50 70 1e 12 12 7c 10 10 0"),
    '%': (13, "0 0 608 910 920 920 64c 92 92 112 20c 0 0 0"),
    '&': (11, "0 0 f0 100 100 180 346 224 21c 31c 1f6 0 0 0"),
    "'": (3, "0 0 2 2 2 0 0 0 0 0 0 0 0 0"),
    '(': (5, "0 4 4 8 8 8 8 8 8 8 4 4 0 0"),
    ')': (5, "0 8 8 8 4 4 4 4 4 8 8 8 0 0"),
    '*': (7, "0 0 10 54 38 7c 10 0 0 0 0 0 0 0"),
    '+': (10, "0 0 0 10 10 10 10 1fe 10 10 10 0 0 0"),
    ',': (4, "0 0 0 0 0 0 0 0 0 2 2 4 0 0"),
    '-': (5, "0 0 0 0 0 0 0 e 0 0 0 0 0 0"),
    '.': (3, "0 0 0 0 0 0 0 0 0 0 2 0 0 0"),
    '/': (4, "0 0 1 1 3 2 2 2 4 4 4 8 0 0"),
    '0': (8, "0 0 3c 24 42 42 42 42 42 24 3c 0 0 0"),
    '1': (8, "0 0 70 10 10 10 10 10 10 10 7c 0 0 0"),
    '2': (8, "0 0 7c 46 2 2 4 8 10 20 7e 0 0 0"),
    '3': (8, "0 0 f8 4 4 7c 8 4 4 c f8 0 0 0"),
    '4': (8, "0 0 18 18 28 48 c8 88 fc 8 8 0 0 0"),
    '5': (8, "0 0 f8 80 80 f0 c 4 4 c f8 0 0 0"),
    '6': (8, "0 0 1e 20 40 5c 66 42 42 26 3c 0 0 0"),
    '7': (8, "0 0 7e 6 4 c 8 8 18 10 30 0 0 0"),
    '8': (8, "0 0 3c 42 42 42 3c 46 42 42 3c 0 0 0"),
    '9': (8, "0 0 3c 64 42 42 66 3a 2 4 78 0 0 0"),
    ':': (5, "0 0 0 0 0 4 0 0 0 0 4 0 0 0"),
    ';': (5, "0 0 0 0 4 0 0 0 0 4 4 8 0 0"),
    '<': (10, "0 0 0 6 38 1c0 1c0 38 e 0 0 0 0 0"),
    '=': (10, "0 0 0 0 0 1fe 0 0 1fe 0 0 0 0 0"),
    '>': (10, "0 0 0 180 70 e e 70 1c0 0 0 0 0 0"),
    '?': (6, "0 0 1c 22 2 6 c 8 8 0 8 0 0 0"),
    '@': (13, "0 0 1f0 30c 404 8f2 912 912 914 8f8 400 208 1f0 0"),
    'A': (9, "0 0 10 38 28 6c 44 44 fe 82 183 0 0 0"),
    'B': (9, "0 0 f8 84 84 84 f8 86 82 86 fc 0 0 0"),
    'C': (9, "0 0 3e 41 80 80 80 80 80 41 3e 0 0 0"),
    'D': (10, "0 0 1f8 10c 106 102 102 102 102 10c 1f8 0 0 0"),
    'E': (8, "0 0 7e 40 40 40 7e 40 40 40 7e 0 0 0"),
    'F': (7, "0 0 3e 20 20 20 3e 20 20 20 20 0 0 0"),
    'G': (10, "0 0 7c 82 100 100 10e 102 102 82 7c 0 0 0"),
    'H': (9, "0 0 82 82 82 82 fe 82 82 82 82 0 0 0"),
    'I': (3, "0 0 2 2 2 2 2 2 2 2 2 0 0 0"),
    'J': (3, "0 0 1 1 1 1 1 1 1 1 1 1 1 6"),
    'K': (8, "0 0 42 44 58 70 70 58 4c 46 43 0 0 0"),
    'L': (7, "0 0 20 20 20 20 20 20 20 20 3f 0 0 0"),
    'M': (11, "0 0 306 306 28a 28a 252 252 272 202 202 0 0 0"),
    'N': (9, "0 0 c2 c2 a2 b2 92 9a 8a 86 86 0 0 0"),
    'O': (11, "0 0 f8 18c 306 202 202 202 206 10c f8 0 0 0"),
    'P': (8, "0 0 7c 42 42 42 7c 40 40 40 40 0 0 0"),
    'Q': (11, "0 0 f8 18c 306 202 202 202 206 10c f8 8 0 0"),
    'R': (9, "0 0 f8 84 84 84 f8 88 84 84 82 0 0 0"),
    'S': (9, "0 0 7e c2 80 c0 3c 2 2 86 fc 0 0 0"),
    'T': (8, "0 0 ff 8 8 8 8 8 8 8 8 0 0 0"),
    'U': (9, "0 0 82 82 82 82 82 82 82 c6 7c 0 0 0"),
    'V': (9, "0 0 183 82 86 44 44 6c 28 38 10 0 0 0"),
    'W': (13, "0 0 1084 1144 114c 194c 948 a28 a38 e30 630 0 0 0"),
    'X': (9, "0 0 184 88 58 70 20 50 d8 188 104 0 0 0"),
    'Y': (7, "0 0 41 22 36 14 8 8 8 8 8 0 0 0"),
    'Z': (10, "0 0 1fe 4 c 18 30 60 c0 80 1fe 0 0 0"),
    '[': (5, "0 e 8 8 8 8 8 8 8 8 8 e 0 0"),
    '\\': (4, "0 0 8 c 4 4 4 2 2 2 1 1 0 0"),
    ']': (5, "0 e 2 2 2 2 2 2 2 2 2 e 0 0"),
    '^': (11, "0 40 e0 110 208 0 0 0 0 0 0 0 0 0"),
    '_': (7, "0 0 0 0 0 0 0 0 0 0 0 0 0 7f"),
    '`': (7, "20 10 8 0 0 0 0 0 0 0 0 0 0 0"),
    'a': (8, "0 0 0 0 7c 46 2 3e 42 46 3a 0 0 0"),
    'b': (8, "0 40 40 40 5c 66 42 42 42 66 5c 0 0 0"),
    'c': (7, "0 0 0 0 1f 31 20 20 20 31 1f 0 0 0"),
    'd': (8, "0 2 2 2 3a 66 42 42 42 66 3a 0 0 0"),
    'e': (9, "0 0 0 0 3c 46 82 fe 80 40 3e 0 0 0"),
    'f': (4, "0 3 4 4 f 4 4 4 4 4 4 0 0 0"),
    'g': (8, "0 0 0 0 3a 66 42 42 42 66 3a 2 6 3c"),
    'h': (8, "0 40 40 40 5c 62 42 42 42 42 42 0 0 0"),
    'i': (3, "0 2 0 0 2 2 2 2 2 2 2 0 0 0"),
    'j': (3, "0 2 0 0 2 2 2 2 2 2 2 2 2 4"),
    'k': (7, "0 20 20 20 22 24 28 30 28 26 23 0 0 0"),
    'l': (3, "0 2 2 2 2 2 2 2 2 2 2 0 0 0"),
    'm': (13, "0 0 0 0 b9c c62 842 842 842 842 842 0 0 0"),
    'n': (8, "0 0 0 0 5c 62 42 42 42 42 42 0 0 0"),
    'o': (8, "0 0 0 0 3c 66 42 42 42 66 3c 0 0 0"),
    'p': (8, "0 0 0 0 5c 66 42 42 42 66 5c 40 40 40"),
    'q': (8, "0 0 0 0 3a 66 42 42 42 66 3a 2 2 2"),
    'r': (5, "0 0 0 b c 8 8 8 8 8 0 0 0 0"),
    's': (7, "0 0 0 0 3c 40 40 38 4 4 78 0 0 0"),
    't': (5, "0 0 8 8 1e 8 8 8 8 8 e 0 0 0"),
    'u': (8, "0 0 0 0 42 42 42 42 42 46 3a 0 0 0"),
    'v': (8, "0 0 0 0 84 8c c8 48 58 70 30 0 0 0"),
    'w': (11, "0 0 0 0 4c4 4c4 4a8 6a8 328 338 310 0 0 0"),
    'x': (8, "0 0 0 0 8c 48 70 30 70 c8 84 0 0 0"),
    'y': (8, "0 0 0 0 84 8c c8 48 58 30 30 20 20 c0"),
    'z': (7, "0 0 0 0 3f 2 4 8 18 30 3f 0 0 0"),
    '{': (8, "0 e 8 8 8 8 30 8 8 8 8 8 e 0"),
    '|': (5, "0 4 4 4 4 4 4 4 4 4 4 4 4 0"),
    '}': (8, "0 70 10 10 10 10 c 10 10 10 10 10 70 0"),
    '~': (10, "0 0 0 0 0 e2 11c 0 0 0 0 0 0 0"),
}


def _parse_glyphs(table: Dict[str, Tuple[int, str]]) -> Dict[str, np.ndarray]:
    out = {}
    for ch, (width, rows) in table.items():
        bits = [int(r, 16) for r in rows.split()]
        out[ch] = np.array([[(b >> (width - 1 - x)) & 1 for x in range(width)] for b in bits],
                           dtype=bool)
    return out


GLYPHS = _parse_glyphs(_GLYPH_TABLE)
LINE_H = GLYPHS[" "].shape[0]  # one text line, pixels


def drawn_text(s: str) -> str:
    """``s`` as it is drawn: printable ASCII, other characters by their stand-in."""
    return "".join(c if " " <= c <= "~" else STAND_INS.get(c, "?") for c in s)


def text_mask(s: str) -> np.ndarray:
    """The 1-bit image ``[LINE_H, width]`` of one line of text."""
    cells = [GLYPHS[c] for c in drawn_text(s)]
    if not cells:
        return np.zeros((LINE_H, 0), bool)
    return np.concatenate(cells, axis=1)


def text_width(s: str) -> int:
    return sum(GLYPHS[c].shape[1] for c in drawn_text(s))


def rgb(color) -> np.ndarray:
    """``"#rrggbb"``, ``"Cn"`` (the colour cycle) or a name, as float RGB 0-255."""
    if isinstance(color, str):
        if color[:1] == "C" and color[1:].isdigit():
            color = TAB10[int(color[1:]) % len(TAB10)]
        color = NAMED.get(color, color)
        if color.startswith("#") and len(color) == 7:
            return np.array([int(color[i:i + 2], 16) for i in (1, 3, 5)], np.float64)
        raise ValueError(f"unknown colour {color!r}")
    return np.asarray(color, np.float64)[:3]


def _f64(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).ravel()


# ------------------------------------------------------------ description


@dataclass
class Line:
    """One ``plot`` call (or an ``axhline``/``axvline``/box-plot part).

    ``kind="axhline"`` keeps matplotlib's data: x ``[0, 1]`` in axes
    fractions, y the value twice (``axvline`` the other way round)."""

    x: np.ndarray
    y: np.ndarray
    z: Optional[np.ndarray] = None
    color: str = "C0"
    alpha: float = 1.0
    lw: float = 1.5
    ls: str = "-"  # "-", "--", ":" or "" (markers only)
    marker: str = ""  # "", "o" or "."
    ms: float = 6.0
    hollow: bool = False
    label: str = ""
    kind: str = "plot"


@dataclass
class Bars:
    """One ``hist`` call: its bin edges and counts."""

    edges: np.ndarray
    counts: np.ndarray
    color: str = "C0"
    alpha: float = 1.0
    edgecolor: Optional[str] = None


@dataclass
class Band:
    """One ``fill_between`` call."""

    x: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    color: str = "C0"
    alpha: float = 1.0


@dataclass
class Points:
    """One 3D ``scatter`` call (``s`` in points squared)."""

    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    s: float = 20.0
    color: str = "C0"


_FMT_MARKERS = ("o", ".")
_FMT_STYLES = ("--", ":", "-")


@dataclass
class Panel:
    """One axes: its texts, scales and contents, and the matplotlib-like calls
    that fill them."""

    title: str = ""
    xlabel: str = ""
    ylabel: str = ""
    xscale: str = "linear"
    yscale: str = "linear"
    lines: List[Line] = field(default_factory=list)
    bars: List[Bars] = field(default_factory=list)
    bands: List[Band] = field(default_factory=list)
    points: List[Points] = field(default_factory=list)
    legend: bool = False
    aspect: str = "auto"  # "equal": matplotlib's adjustable="datalim"
    xlim: Optional[Tuple[float, float]] = None
    ylim: Optional[Tuple[float, float]] = None
    xticks: Optional[Tuple[Sequence[float], Sequence[str]]] = None
    projection: str = "2d"
    _lines_drawn: int = field(default=0, repr=False)
    _patches_drawn: int = field(default=0, repr=False)

    def _next(self, kind: str) -> str:
        """matplotlib's two colour cycles: one for lines, one for patches."""
        if kind == "line":
            self._lines_drawn += 1
            return f"C{(self._lines_drawn - 1) % 10}"
        self._patches_drawn += 1
        return f"C{(self._patches_drawn - 1) % 10}"

    def plot(self, x, y, fmt: str = "", *, z=None, color=None, alpha=1.0, lw=1.5, ms=6.0,
             label="") -> Line:
        marker = next((m for m in _FMT_MARKERS if m in fmt), "")
        ls = next((s for s in _FMT_STYLES if s in fmt), "" if marker else "-")
        line = Line(_f64(x), _f64(y), None if z is None else _f64(z),
                    color or self._next("line"), alpha, lw, ls, marker, ms, label=label)
        self.lines.append(line)
        return line

    def axhline(self, y, color="black", ls="-", lw=1.5, label="") -> None:
        self.lines.append(Line(np.array([0.0, 1.0]), np.array([y, y], np.float64), color=color,
                               lw=lw, ls=ls, label=label, kind="axhline"))

    def axvline(self, x, color="black", ls="-", lw=1.5, label="") -> None:
        self.lines.append(Line(np.array([x, x], np.float64), np.array([0.0, 1.0]), color=color,
                               lw=lw, ls=ls, label=label, kind="axvline"))

    def hist(self, data, edges, alpha=1.0, edgecolor=None) -> Bars:
        edges = _f64(edges)
        counts = np.histogram(_f64(data), bins=edges)[0].astype(np.float64)
        bars = Bars(edges, counts, self._next("patch"), alpha, edgecolor)
        self.bars.append(bars)
        return bars

    def fill_between(self, x, lo, hi, color=None, alpha=1.0) -> None:
        self.bands.append(Band(_f64(x), _f64(lo), _f64(hi), color or self._next("patch"), alpha))

    def scatter3d(self, x, y, z, s=20.0) -> None:
        """A non-finite point is dropped from the data, as matplotlib's scatter drops it."""
        x, y, z = _f64(x), _f64(y), _f64(z)
        keep = np.isfinite(x) & np.isfinite(y) & np.isfinite(z)
        self.points.append(Points(x[keep], y[keep], z[keep], s, self._next("patch")))

    def boxplot(self, data: Sequence, tick_labels: Sequence[str]) -> None:
        """matplotlib's ``boxplot`` with its defaults: per box, in matplotlib's
        order, the box, the two whiskers (1.5 IQR), the two caps, the median
        and the fliers, each a :class:`Line` with matplotlib's points."""
        n = len(data)
        positions = np.arange(1, n + 1, dtype=np.float64)
        w = float(np.clip(0.15 * np.ptp(positions), 0.15, 0.5))
        cw = 0.5 * w
        for pos, d in zip(positions, data):
            s = box_stats(d)
            lo, hi = pos - w / 2, pos + w / 2
            parts = [
                ("box", [lo, hi, hi, lo, lo], [s["q1"], s["q1"], s["q3"], s["q3"], s["q1"]]),
                ("whisker", [pos, pos], [s["q1"], s["whislo"]]),
                ("whisker", [pos, pos], [s["q3"], s["whishi"]]),
                ("cap", [pos - cw / 2, pos + cw / 2], [s["whislo"]] * 2),
                ("cap", [pos - cw / 2, pos + cw / 2], [s["whishi"]] * 2),
                ("median", [lo, hi], [s["med"]] * 2),
            ]
            for kind, xs, ys in parts:
                self.lines.append(Line(_f64(xs), _f64(ys), color="C1" if kind == "median"
                                       else "black", kind=kind))
            fl = s["fliers"]
            self.lines.append(Line(np.full(len(fl), pos), fl, color="black", ls="", marker="o",
                                   hollow=True, kind="flier"))
        self.xticks = (list(positions), [str(t) for t in tick_labels])


def box_stats(data) -> dict:
    """matplotlib's ``cbook.boxplot_stats`` at ``whis=1.5``."""
    x = _f64(data)
    if x.size == 0:
        nan = float("nan")
        return dict(q1=nan, med=nan, q3=nan, whislo=nan, whishi=nan, fliers=np.array([]))
    q1, med, q3 = np.percentile(x, [25, 50, 75])
    iqr = q3 - q1
    hi = x[x <= q3 + 1.5 * iqr]
    whishi = q3 if hi.size == 0 or np.max(hi) < q3 else np.max(hi)
    lo = x[x >= q1 - 1.5 * iqr]
    whislo = q1 if lo.size == 0 or np.min(lo) > q1 else np.min(lo)
    fliers = np.concatenate([x[x < whislo], x[x > whishi]])
    return dict(q1=q1, med=med, q3=q3, whislo=whislo, whishi=whishi, fliers=fliers)


@dataclass
class Figure:
    """A figure: its file name, size and panels (row-major), ``subplots``'s
    sharing."""

    filename: str
    figsize: Tuple[float, float]
    panels: List[Panel]
    nrows: int = 1
    ncols: int = 1
    sharex: bool = False
    sharey: bool = False

    @property
    def size_px(self) -> Tuple[int, int]:
        """(width, height) in pixels."""
        return int(round(self.figsize[0] * DPI)), int(round(self.figsize[1] * DPI))

    def axes(self, row: int, col: int = 0) -> Panel:
        return self.panels[row * self.ncols + col]


def subplots(filename: str, nrows: int = 1, ncols: int = 1, figsize=(6.4, 4.8),
             sharex: bool = False, sharey: bool = False, projection: str = "2d") -> Figure:
    panels = [Panel(projection=projection) for _ in range(nrows * ncols)]
    return Figure(filename, tuple(figsize), panels, nrows, ncols, sharex, sharey)


# ------------------------------------------------------------ primitives


def blend(img: np.ndarray, rows, cols, color, alpha: float = 1.0) -> None:
    """Blend ``color`` once into each listed pixel (repeats count once)."""
    H, W = img.shape[:2]
    rows, cols = np.asarray(rows).ravel(), np.asarray(cols).ravel()
    ok = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
    flat = np.unique(rows[ok].astype(np.int64) * W + cols[ok])
    if flat.size == 0:
        return
    px = img.reshape(-1, 3)
    c = rgb(color)
    if alpha >= 1.0:
        px[flat] = c.astype(np.uint8)
    else:
        px[flat] = (px[flat] * (1.0 - alpha) + c * alpha + 0.5).astype(np.uint8)


def fill_rect(img, x0, y0, x1, y1, color, alpha=1.0) -> None:
    """Fill pixels ``[x0, x1) x [y0, y1)`` (clipped to the image)."""
    H, W = img.shape[:2]
    c0, c1 = max(int(round(min(x0, x1))), 0), min(int(round(max(x0, x1))), W)
    r0, r1 = max(int(round(min(y0, y1))), 0), min(int(round(max(y0, y1))), H)
    if c0 >= c1 or r0 >= r1:
        return
    region = img[r0:r1, c0:c1]
    c = rgb(color)
    if alpha >= 1.0:
        region[:] = c.astype(np.uint8)
    else:
        region[:] = (region * (1.0 - alpha) + c * alpha + 0.5).astype(np.uint8)


def rect_outline(img, x0, y0, x1, y1, color, alpha=1.0) -> None:
    xs = [x0, x1, x1, x0, x0]
    ys = [y0, y0, y1, y1, y0]
    rows, cols = stroke(np.array(xs, float), np.array(ys, float), 1.0)
    blend(img, rows, cols, color, alpha)


def _clip_segments(x0, y0, x1, y1, box):
    """Liang-Barsky: the part of each segment inside ``box = (xmin, ymin,
    xmax, ymax)``; returns the clipped ends and which segments remain."""
    xmin, ymin, xmax, ymax = box
    keep = np.isfinite(x0) & np.isfinite(y0) & np.isfinite(x1) & np.isfinite(y1)
    inside = ((np.minimum(x0, x1) >= xmin) & (np.maximum(x0, x1) <= xmax)
              & (np.minimum(y0, y1) >= ymin) & (np.maximum(y0, y1) <= ymax))
    if inside[keep].all():  # nothing to clip
        return (x0, y0, x1, y1), keep
    dx, dy = x1 - x0, y1 - y0
    t0, t1 = np.zeros_like(x0), np.ones_like(x0)
    with np.errstate(divide="ignore", invalid="ignore"):
        for p, q in ((-dx, x0 - xmin), (dx, xmax - x0), (-dy, y0 - ymin), (dy, ymax - y0)):
            keep &= ~((p == 0) & (q < 0))
            r = q / p
            t0 = np.where(p < 0, np.maximum(t0, r), t0)
            t1 = np.where(p > 0, np.minimum(t1, r), t1)
    keep &= t0 <= t1
    return (x0 + t0 * dx, y0 + t0 * dy, x0 + t1 * dx, y0 + t1 * dy), keep


_DASHES = {"--": (6.0, 3.0), ":": (1.5, 2.5)}


def stroke(px, py, width: float, ls: str = "-", box=None, segments: bool = False):
    """The pixels ``(rows, cols)`` of a polyline through ``(px, py)`` (pixel
    coordinates; a non-finite point breaks it), and with ``segments`` the
    index of the segment (from point i to i + 1) each pixel belongs to;
    ``width`` pixels wide,
    sampled half a pixel apart (so that no pixel is skipped), clipped to
    ``box``."""
    px, py = np.asarray(px, np.float64), np.asarray(py, np.float64)
    if px.size < 2:
        empty = np.zeros(0, np.int64)
        return (empty, empty, empty) if segments else (empty, empty)
    box = box or (-1e6, -1e6, 1e6, 1e6)
    (x0, y0, x1, y1), keep = _clip_segments(px[:-1], py[:-1], px[1:], py[1:], box)
    kept = np.flatnonzero(keep)
    x0, y0, x1, y1 = x0[kept], y0[kept], x1[kept], y1[kept]
    dx, dy = x1 - x0, y1 - y0
    n = np.ceil(2.0 * np.maximum(np.abs(dx), np.abs(dy))).astype(np.int64) + 1  # half a pixel apart
    seg = np.repeat(np.arange(n.size), n)
    start = np.cumsum(n) - n
    frac = (np.arange(seg.size) - start[seg]) / np.maximum(n[seg] - 1, 1)
    sx, sy = x0[seg] + frac * dx[seg], y0[seg] + frac * dy[seg]
    if ls in _DASHES:
        on, off = _DASHES[ls]
        length = np.hypot(dx, dy)
        s = (np.cumsum(length) - length)[seg] + frac * length[seg]
        on_dash = np.mod(s, on + off) < on
        sx, sy, seg = sx[on_dash], sy[on_dash], seg[on_dash]
    k = max(1, int(round(width)))
    offs = np.arange(k) - (k - 1) // 2
    rows = np.floor(sy)[:, None, None] + offs[None, :, None]
    cols = np.floor(sx)[:, None, None] + offs[None, None, :]
    rows, cols = np.broadcast_arrays(rows, cols)
    rows, cols = rows.astype(np.int64).ravel(), cols.astype(np.int64).ravel()
    if segments:
        return rows, cols, np.repeat(kept[seg], k * k)
    return rows, cols


def discs(cx, cy, radius: float, hollow: bool = False):
    """The pixels of discs (or rings) of ``radius`` pixels at finite centres."""
    cx, cy = np.asarray(cx, np.float64).ravel(), np.asarray(cy, np.float64).ravel()
    ok = np.isfinite(cx) & np.isfinite(cy)
    cx, cy = cx[ok], cy[ok]
    r = max(radius, 0.5)
    R = int(math.ceil(r))
    oy, ox = np.mgrid[-R:R + 1, -R:R + 1]
    d = np.hypot(ox, oy)
    sel = (d <= r) & ((d > r - 1.2) if hollow else True)
    oy, ox = oy[sel], ox[sel]
    rows = np.floor(cy)[:, None] + oy[None, :]
    cols = np.floor(cx)[:, None] + ox[None, :]
    return rows.astype(np.int64).ravel(), cols.astype(np.int64).ravel()


def draw_text(img, x: float, y: float, s: str, color="black", ha: str = "left",
              va: str = "top", rotate: bool = False) -> None:
    """One line of text; ``(x, y)`` is the anchor, ``ha`` left/center/right,
    ``va`` top/center/bottom (a rotation by 90 degrees reads upwards and is
    centred on the anchor)."""
    mask = text_mask(s)
    if mask.shape[1] == 0:
        return
    if rotate:
        mask = np.rot90(mask)
        h, w = mask.shape
        top, left = y - h / 2, x - w / 2
    else:
        h, w = mask.shape
        left = {"left": x, "center": x - w / 2, "right": x - w}[ha]
        top = {"top": y, "center": y - h / 2, "bottom": y - h}[va]
    rr, cc = np.nonzero(mask)
    blend(img, rr + int(round(top)), cc + int(round(left)), color)


# ------------------------------------------------------------------ axes


def _finite(a) -> np.ndarray:
    a = np.asarray(a, np.float64).ravel()
    return a[np.isfinite(a)]


class Axes:
    """A panel placed on the canvas: its box in pixels and limits, the map from
    data to pixels."""

    def __init__(self, panel: Panel, box, xlim, ylim):
        self.panel, self.box = panel, box  # box: (x0, y0, x1, y1), pixels
        self.xlim, self.ylim = xlim, ylim  # in the scale's space (log10 for "log")

    @staticmethod
    def scaled(v, scale: str) -> np.ndarray:
        v = np.asarray(v, np.float64)
        if scale == "log":
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.where(v > 0, np.log10(np.where(v > 0, v, 1.0)), np.nan)
        return v

    def px(self, x) -> np.ndarray:
        x0, _, x1, _ = self.box
        lo, hi = self.xlim
        return x0 + (self.scaled(x, self.panel.xscale) - lo) / (hi - lo) * (x1 - x0)

    def py(self, y) -> np.ndarray:
        _, y0, _, y1 = self.box
        lo, hi = self.ylim
        return y1 - (self.scaled(y, self.panel.yscale) - lo) / (hi - lo) * (y1 - y0)


def _data_limits(panel: Panel, axis: str) -> Optional[Tuple[float, float, bool]]:
    """(lo, hi, sticky_zero) of the panel's data along ``axis`` in scale space,
    None without data."""
    scale = panel.xscale if axis == "x" else panel.yscale
    vals, sticky = [], False
    for ln in panel.lines:
        if ln.kind == ("axvline" if axis == "y" else "axhline"):
            continue  # the axes-fraction coordinate
        vals.append(ln.x if axis == "x" else ln.y)
    for b in panel.bars:
        if axis == "x":
            vals.append(b.edges)
        else:
            vals.append(np.concatenate([[0.0], b.counts]))
            sticky = True
    for band in panel.bands:
        vals.extend([band.x] if axis == "x" else [band.lo, band.hi])
    v = _finite(Axes.scaled(np.concatenate(vals), scale)) if vals else np.zeros(0)
    if v.size == 0:
        return None
    return float(v.min()), float(v.max()), sticky


def _with_margins(lim, scale: str, explicit) -> Tuple[float, float]:
    if explicit is not None:
        lo, hi = (Axes.scaled(np.array(explicit, np.float64), scale)).tolist()
        return (lo, hi) if hi > lo else (lo - 0.5, lo + 0.5)
    if lim is None:
        return (0.0, 1.0)
    lo, hi, sticky = lim
    if hi == lo:
        d = max(abs(lo) * 0.05, 0.5 if scale == "linear" else 0.05)
        return lo - d, hi + d
    m = 0.05 * (hi - lo)
    return (lo if sticky and lo == 0.0 else lo - m), hi + m


def _nice_ticks(lo: float, hi: float, target: int) -> Tuple[np.ndarray, int]:
    """About ``target`` round ticks in ``[lo, hi]`` and the decimals to show."""
    span = hi - lo
    raw = span / max(target, 1)
    mag = 10.0 ** math.floor(math.log10(raw))
    for m in (1.0, 2.0, 2.5, 5.0, 10.0):
        step = m * mag
        if span / step <= target:
            break
    first = math.ceil(lo / step - 1e-9)
    ticks = (first + np.arange(int(math.floor(hi / step + 1e-9)) - first + 1)) * step
    decimals = max(0, -int(math.floor(math.log10(step))) + (1 if m == 2.5 else 0))
    return ticks, decimals


def _format(v: float, decimals: int, big: bool) -> str:
    if big:
        return f"{v:.3g}"
    s = f"{v:.{decimals}f}"
    return "0" if s.strip("-0.") == "" else s


def _ticks(lim, scale: str, target: int) -> Tuple[np.ndarray, List[str]]:
    """Tick positions in scale space and their labels."""
    lo, hi = lim
    if not (np.isfinite(lo) and np.isfinite(hi)) or hi <= lo:
        return np.zeros(0), []
    if scale == "log":
        k0, k1 = math.ceil(lo - 1e-9), math.floor(hi + 1e-9)
        if k1 >= k0:
            stride = max(1, math.ceil((k1 - k0 + 1) / max(target, 1)))
            ks = np.arange(k0, k1 + 1, stride, dtype=np.float64)
            return ks, [f"1e{int(k)}" for k in ks]
    ticks, decimals = _nice_ticks(lo, hi, target)
    if scale == "log":
        return ticks, [f"{10.0 ** t:.3g}" for t in ticks]
    big = max(abs(lo), abs(hi)) >= 1e5 or (hi - lo) < 1e-4
    return ticks, [_format(t, decimals, big) for t in ticks]


def layout(fig: Figure) -> List[Axes]:
    """Each panel's box on the canvas and its limits (shared where the figure
    shares them), margins fitted to the tick labels and texts."""
    W, H = fig.size_px
    cw, ch = W / fig.ncols, H / fig.nrows
    xl = [_with_margins(_data_limits(p, "x"), p.xscale, p.xlim) for p in fig.panels]
    yl = [_with_margins(_data_limits(p, "y"), p.yscale, p.ylim) for p in fig.panels]
    for share, lims in ((fig.sharex, xl), (fig.sharey, yl)):
        if share and lims:
            lo, hi = min(v[0] for v in lims), max(v[1] for v in lims)
            lims[:] = [(lo, hi)] * len(lims)
    ytargets = max(3, min(8, int(ch // 70)))
    ylabel_w = 0
    for p, lim in zip(fig.panels, yl):
        if p.projection == "2d":
            _, labels = _ticks(lim, p.yscale, ytargets)
            ylabel_w = max([ylabel_w] + [text_width(s) for s in labels])
    flat2d = [p for p in fig.panels if p.projection == "2d"]
    left = PAD + ylabel_w + TICK + 4 + (LINE_H + 4 if any(p.ylabel for p in flat2d) else 0)
    bottom = PAD + (TICK + 3 + LINE_H if flat2d else 0) + (
        LINE_H + 4 if any(p.xlabel for p in flat2d) else 0)
    top = PAD + (LINE_H + 6 if any(p.title for p in fig.panels) else 0)
    right = PAD + 12
    out = []
    for i, (p, xlim, ylim) in enumerate(zip(fig.panels, xl, yl)):
        r, c = divmod(i, fig.ncols)
        if p.projection == "3d":
            box = (c * cw + PAD, r * ch + top, (c + 1) * cw - PAD, (r + 1) * ch - PAD)
        else:
            box = (c * cw + left, r * ch + top, (c + 1) * cw - right, (r + 1) * ch - bottom)
        box = (box[0], box[1], max(box[2], box[0] + 10), max(box[3], box[1] + 10))
        if p.aspect == "equal" and p.projection == "2d":
            xlim, ylim = _equal_aspect(box, xlim, ylim)
        out.append(Axes(p, box, xlim, ylim))
    return out


def _equal_aspect(box, xlim, ylim):
    """Widen one range so that a data unit is as many pixels along x as along y
    (matplotlib's ``set_aspect("equal", adjustable="datalim")``)."""
    w, h = box[2] - box[0], box[3] - box[1]
    dx, dy = xlim[1] - xlim[0], ylim[1] - ylim[0]
    if dx / w > dy / h:
        mid, half = (ylim[0] + ylim[1]) / 2, dx / w * h / 2
        return xlim, (mid - half, mid + half)
    mid, half = (xlim[0] + xlim[1]) / 2, dy / h * w / 2
    return (mid - half, mid + half), ylim


# ------------------------------------------------------------- rendering


def _draw_line(img, ax: Axes, ln: Line, box) -> None:
    x0, y0, x1, y1 = ax.box
    if ln.kind == "axhline":
        px, py = x0 + ln.x * (x1 - x0), ax.py(ln.y)
    elif ln.kind == "axvline":
        px, py = ax.px(ln.x), y1 - ln.y * (y1 - y0)
    else:
        px, py = ax.px(ln.x), ax.py(ln.y)
    if ln.ls:
        rows, cols = stroke(px, py, ln.lw * PT, ln.ls, box)
        blend(img, rows, cols, ln.color, ln.alpha)
    if ln.marker:
        inside = (px >= box[0]) & (px <= box[2]) & (py >= box[1]) & (py <= box[3])
        radius = (ln.ms * PT / 2) if ln.marker == "o" else max(ln.ms * PT / 4, 1.0)
        rows, cols = discs(px[inside], py[inside], radius, ln.hollow)
        blend(img, rows, cols, ln.color, ln.alpha)


def _draw_bars(img, ax: Axes, b: Bars, box) -> None:
    xs = ax.px(b.edges)
    base = ax.py(np.zeros(1))[0] if ax.panel.yscale == "linear" else box[3]
    tops = ax.py(b.counts)
    for i, count in enumerate(b.counts):
        if count <= 0 or not np.isfinite(tops[i]):
            continue
        l, r = max(xs[i], box[0]), min(xs[i + 1], box[2])
        t, btm = max(tops[i], box[1]), min(base, box[3])
        if r <= l or btm <= t:
            continue
        fill_rect(img, l, t, r, btm, b.color, b.alpha)
        if b.edgecolor:
            rect_outline(img, l, t, r - 1, btm - 1, b.edgecolor, b.alpha)


def _draw_band(img, ax: Axes, band: Band, box) -> None:
    px, plo, phi = ax.px(band.x), ax.py(band.lo), ax.py(band.hi)
    ok = np.isfinite(px) & np.isfinite(plo) & np.isfinite(phi)
    if ok.sum() < 2:
        return
    px, plo, phi = px[ok], plo[ok], phi[ok]
    order = np.argsort(px, kind="stable")
    px, plo, phi = px[order], plo[order], phi[order]
    cols = np.arange(max(int(np.ceil(px[0])), int(box[0])), min(int(px[-1]) + 1, int(box[2])))
    if cols.size == 0:
        return
    a, b = np.interp(cols, px, plo), np.interp(cols, px, phi)
    top = np.clip(np.minimum(a, b), box[1], box[3])
    bot = np.clip(np.maximum(a, b), box[1], box[3])
    n = np.maximum(np.ceil(bot) - np.floor(top), 0).astype(np.int64)
    idx = np.repeat(np.arange(cols.size), n)
    rows = np.floor(top)[idx] + (np.arange(idx.size) - (np.cumsum(n) - n)[idx])
    blend(img, rows.astype(np.int64), cols[idx], band.color, band.alpha)


def _draw_frame_and_ticks(img, ax: Axes, fig: Figure, index: int) -> None:
    p = ax.panel
    x0, y0, x1, y1 = ax.box
    rect_outline(img, x0, y0, x1, y1, "black")
    r, c = divmod(index, fig.ncols)
    show_x = not fig.sharex or r == fig.nrows - 1
    show_y = not fig.sharey or c == 0
    xt = max(3, min(9, int((x1 - x0) // 90)))
    yt = max(3, min(8, int((y1 - y0) // 60)))
    if p.xticks is not None:
        xpos = ax.px(np.asarray(p.xticks[0], np.float64))
        xlab = list(p.xticks[1])
    else:
        ticks, xlab = _ticks(ax.xlim, p.xscale, xt)
        lo, hi = ax.xlim
        xpos = x0 + (ticks - lo) / (hi - lo) * (x1 - x0)
    for xp, s in zip(xpos, xlab):
        if x0 - 0.5 <= xp <= x1 + 0.5:
            blend(img, np.arange(int(y1), int(y1) + TICK), np.full(TICK, int(xp)), "black")
            if show_x:
                draw_text(img, xp, y1 + TICK + 3, s, ha="center", va="top")
    ticks, ylab = _ticks(ax.ylim, p.yscale, yt)
    lo, hi = ax.ylim
    for t, s in zip(ticks, ylab):
        yp = y1 - (t - lo) / (hi - lo) * (y1 - y0)
        if y0 - 0.5 <= yp <= y1 + 0.5:
            blend(img, np.full(TICK, int(yp)), np.arange(int(x0) - TICK, int(x0)), "black")
            if show_y:
                draw_text(img, x0 - TICK - 3, yp, s, ha="right", va="center")
    if p.xlabel and show_x:
        draw_text(img, (x0 + x1) / 2, y1 + TICK + 3 + LINE_H + 4, p.xlabel, ha="center",
                  va="top")
    if p.ylabel and show_y:
        width = max([0] + [text_width(s) for s in ylab])
        draw_text(img, x0 - TICK - 4 - width - LINE_H / 2 - 2, (y0 + y1) / 2, p.ylabel,
                  rotate=True)


def _draw_legend(img, ax: Axes) -> None:
    entries = [ln for ln in ax.panel.lines if ln.label and not ln.label.startswith("_")]
    if not entries:
        return
    x0, y0, x1, y1 = ax.box
    w = 34 + max(text_width(ln.label) for ln in entries)
    h = len(entries) * LINE_H + 8
    lx0, ly0 = x1 - w - 6, y0 + 6
    fill_rect(img, lx0, ly0, lx0 + w, ly0 + h, "white", 0.8)
    rect_outline(img, lx0, ly0, lx0 + w, ly0 + h, "#cccccc")
    for i, ln in enumerate(entries):
        yc = ly0 + 4 + i * LINE_H + LINE_H / 2
        if ln.ls:
            rows, cols = stroke(np.array([lx0 + 4, lx0 + 24]), np.array([yc, yc]),
                                ln.lw * PT, ln.ls)
            blend(img, rows, cols, ln.color, ln.alpha)
        if ln.marker:
            rows, cols = discs([lx0 + 14], [yc], ln.ms * PT / 2 if ln.marker == "o" else 1.5)
            blend(img, rows, cols, ln.color, ln.alpha)
        draw_text(img, lx0 + 28, yc, ln.label, va="center")


VIEW_3D = (30.0, -60.0)  # elevation, azimuth: matplotlib's default view


def project3d(x, y, z, lims):
    """Orthographic screen coordinates (right, up) of 3D points seen from
    :data:`VIEW_3D`, each axis scaled to matplotlib's box (4 : 4 : 3) around
    its limits."""
    elev, azim = np.radians(VIEW_3D[0]), np.radians(VIEW_3D[1])
    aspect = (1.0, 1.0, 0.75)
    P = [(np.asarray(v, np.float64) - (lo + hi) / 2) / (hi - lo) * a
         for v, (lo, hi), a in zip((x, y, z), lims, aspect)]
    right = -np.sin(azim) * P[0] + np.cos(azim) * P[1]
    up = (-np.sin(elev) * np.cos(azim) * P[0] - np.sin(elev) * np.sin(azim) * P[1]
          + np.cos(elev) * P[2])
    return right, up


def _render_3d(img, ax: Axes) -> None:
    p = ax.panel
    lims = []
    for axis in range(3):
        vals = [(ln.x, ln.y, ln.z)[axis] for ln in p.lines if ln.z is not None]
        vals += [(pt.x, pt.y, pt.z)[axis] for pt in p.points]
        v = _finite(np.concatenate(vals)) if vals else np.zeros(0)
        lo, hi = (float(v.min()), float(v.max())) if v.size else (0.0, 1.0)
        if hi <= lo:
            lo, hi = lo - 0.5, hi + 0.5
        pad = (hi - lo) / 48  # matplotlib 3D's margin
        lims.append((lo - pad, hi + pad))
    x0, y0, x1, y1 = ax.box
    scale = 0.9 * min(x1 - x0, y1 - y0)  # the box's diagonal fits the axes
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2

    def to_px(x, y, z):
        r, u = project3d(x, y, z, lims)
        return cx + r * scale / 1.6, cy - u * scale / 1.6

    corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)], float)
    for a in range(8):
        for b in range(a + 1, 8):
            if np.abs(corners[a] - corners[b]).sum() == 1:
                pts = [np.array([lims[d][int(corners[e][d])] for e in (a, b)]) for d in range(3)]
                rows, cols = stroke(*to_px(*pts), 1.0)
                blend(img, rows, cols, GRID_GRAY)
    for ln in p.lines:
        px, py = to_px(ln.x, ln.y, ln.z)
        rows, cols = stroke(px, py, ln.lw * PT, ln.ls or "-", ax.box)
        blend(img, rows, cols, ln.color, ln.alpha)
    for pt in p.points:
        rows, cols = discs(*to_px(pt.x, pt.y, pt.z), math.sqrt(pt.s) * PT / 2)
        blend(img, rows, cols, pt.color)


def render(fig: Figure) -> np.ndarray:
    """The figure as an RGB ``uint8`` array ``[H, W, 3]``."""
    W, H = fig.size_px
    img = np.full((H, W, 3), 255, np.uint8)
    for i, ax in enumerate(layout(fig)):
        p = ax.panel
        if p.title:
            draw_text(img, (ax.box[0] + ax.box[2]) / 2, ax.box[1] - 6, p.title, ha="center",
                      va="bottom")
        if p.projection == "3d":
            _render_3d(img, ax)
            continue
        box = ax.box
        for band in p.bands:
            _draw_band(img, ax, band, box)
        for b in p.bars:
            _draw_bars(img, ax, b, box)
        for ln in p.lines:
            _draw_line(img, ax, ln, box)
        _draw_frame_and_ticks(img, ax, fig, i)
        if p.legend:
            _draw_legend(img, ax)
    return img


def save(fig: Figure, path: str) -> str:
    """Render ``fig`` and write it as PNG to ``path``."""
    encode.write_png(path, render(fig))
    return path
