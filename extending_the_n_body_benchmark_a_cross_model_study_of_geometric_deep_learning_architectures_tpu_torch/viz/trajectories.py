"""Trajectory figures, the HTML animation, the mp4/GIF animation and the
checkpoint PDF: counterpart of the JAX package's ``viz/trajectories.py``.

* :func:`plot_trajectories_3d`: one sim's tracks in 3D, the last frame
  marked, matplotlib's default view (orthographic here).
* :func:`interactive_trajectory_html`: a self-contained HTML canvas animation,
  byte for byte the JAX package's for the same arrays.
* :func:`animate_trajectory`: mp4 through ``ffmpeg`` when it runs, else a GIF
  at ``min(fps, 15)`` frames a second, under the same file names.
* :func:`aggregate_checkpoint_plots_pdf`: every checkpoint's PNGs as the
  pages of one PDF.

Drawing is host work: the arrays are numpy (a tensor is copied to the host
first).
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Sequence

import numpy as np

from . import encode, raster
from .raster import Figure, subplots


def _finite_bounds(pts: np.ndarray, pad: float = 1.0) -> tuple:
    """(lo, hi) over the finite entries of ``pts``; safe on exploded rollouts
    whose later frames are NaN/inf (rollout freeze semantics)."""
    finite = pts[np.isfinite(pts)]
    if finite.size == 0:
        return -pad, pad
    lo, hi = float(finite.min()) - pad, float(finite.max()) + pad
    if hi <= lo:
        hi = lo + 2 * pad
    return lo, hi


def trajectory_3d_figure(loc: np.ndarray, sim_index: int = 0,
                         filename: str = "trajectory_3d.png", title: str = "") -> Figure:
    """loc ``[S, T, N, 3]`` -> one sim's tracks, each body's last position a
    marker."""
    fig = subplots(filename, figsize=(8, 8), projection="3d")
    ax = fig.panels[0]
    for b in range(loc.shape[2]):
        ax.plot(loc[sim_index, :, b, 0], loc[sim_index, :, b, 1],
                z=loc[sim_index, :, b, 2], alpha=0.7, lw=0.8)
        ax.scatter3d(*loc[sim_index, -1, b], s=18)
    ax.title = title or f"sim {sim_index}"
    return fig


def plot_trajectories_3d(save_dir: str, loc: np.ndarray, sim_index: int = 0,
                         filename: str = "trajectory_3d.png", title: str = "") -> str:
    os.makedirs(save_dir, exist_ok=True)
    fig = trajectory_3d_figure(np.asarray(loc), sim_index, filename, title)
    return raster.save(fig, os.path.join(save_dir, filename))


def interactive_trajectory_html(
    save_dir: str,
    loc_actual: np.ndarray,
    loc_pred: Optional[np.ndarray] = None,
    sim_index: int = 0,
    filename: str = "trajectory.html",
    max_steps: int = 1000,
) -> str:
    """Self-contained HTML canvas animation (no external JS)."""
    os.makedirs(save_dir, exist_ok=True)

    def prep(loc):
        a = np.asarray(loc[sim_index], dtype=np.float64)
        if a.shape[0] > max_steps:
            a = a[np.linspace(0, a.shape[0] - 1, max_steps).astype(int)]
        return a[..., :2]  # project to 2D for the canvas

    tracks = {"ground truth": prep(loc_actual)}
    if loc_pred is not None:
        tracks["predicted"] = prep(loc_pred)
    allpts = np.concatenate(list(tracks.values()), axis=0).reshape(-1, 2)
    lo, hi = _finite_bounds(allpts)
    payload = {
        k: np.round(v, 4).tolist() for k, v in tracks.items()
    }
    html = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>trajectory sim {sim_index}</title></head><body>
<canvas id="c" width="800" height="800" style="border:1px solid #999"></canvas>
<div><button onclick="playing=!playing">play/pause</button>
<input type="range" id="s" min="0" max="0" value="0" style="width:600px"></div>
<script>
const data = {json.dumps(payload)};
const lo = {lo}, hi = {hi};
const colors = {{"ground truth": "#2b6cb0", "predicted": "#c53030"}};
const ctx = document.getElementById('c').getContext('2d');
const T = Object.values(data)[0].length;
document.getElementById('s').max = T - 1;
let t = 0, playing = true;
function sc(p) {{ return [(p[0]-lo)/(hi-lo)*800, 800-(p[1]-lo)/(hi-lo)*800]; }}
function draw() {{
  ctx.clearRect(0,0,800,800);
  for (const [name, track] of Object.entries(data)) {{
    ctx.strokeStyle = colors[name] || '#555'; ctx.fillStyle = ctx.strokeStyle;
    const N = track[0].length;
    for (let b = 0; b < N; b++) {{
      ctx.beginPath();
      for (let i = Math.max(0, t-100); i <= t; i++) {{
        const [x, y] = sc(track[i][b]);
        if (i === Math.max(0, t-100)) ctx.moveTo(x, y); else ctx.lineTo(x, y);
      }}
      ctx.stroke();
      const [x, y] = sc(track[t][b]);
      ctx.beginPath(); ctx.arc(x, y, 4, 0, 6.283); ctx.fill();
    }}
  }}
  ctx.fillStyle = '#000'; ctx.fillText('t = ' + t + ' / ' + (T-1), 10, 15);
  let ly = 30;
  for (const name of Object.keys(data)) {{
    ctx.fillStyle = colors[name] || '#555'; ctx.fillText(name, 10, ly); ly += 15;
  }}
}}
setInterval(() => {{ if (playing) {{ t = (t+1) % T;
  document.getElementById('s').value = t; draw(); }} }}, 30);
document.getElementById('s').oninput = (e) => {{ t = +e.target.value; draw(); }};
draw();
</script></body></html>"""
    path = os.path.join(save_dir, filename)
    with open(path, "w") as f:
        f.write(html)
    return path


def animation_figure(a: np.ndarray) -> Figure:
    """The animation's axes, empty: ``a [T, N, 3]``'s finite x-y bounds as both
    limits (its tracks are drawn frame by frame onto the rendered axes)."""
    fig = subplots("frame.png", figsize=(6, 6))
    lo, hi = _finite_bounds(a[..., :2])
    fig.panels[0].xlim = fig.panels[0].ylim = (lo, hi)
    return fig


def animation_frames(a: np.ndarray, tail: int = 40) -> Iterator[np.ndarray]:
    """RGB frames of ``a [T, N, 3]``: at frame t, each body's last ``tail + 1``
    positions as a line (alpha 0.6, 1 pt) and its position as a dot (5 pt),
    the lines taking the colour cycle's first N colours and the dots the next
    N, as matplotlib gives them."""
    fig = animation_figure(a)
    background = raster.render(fig)
    ax = raster.layout(fig)[0]
    T, N, _ = a.shape
    px, py = ax.px(a[..., 0]), ax.py(a[..., 1])  # [T, N]
    breaks = np.full((1, N), np.nan)
    colours = np.arange(N) % 10
    inside_all = (px >= ax.box[0]) & (px <= ax.box[2]) & (py >= ax.box[1]) & (py <= ax.box[3])
    dot = raster.discs([0.0], [0.0], 5 * raster.PT / 2)[0].size  # pixels a dot
    for t in range(T):
        img = background.copy()
        s = max(0, t - tail)
        # every body's tail as one polyline, a NaN point after each
        xs, ys = np.concatenate([px[s:t + 1], breaks]), np.concatenate([py[s:t + 1], breaks])
        rows, cols, seg = raster.stroke(xs.T.ravel(), ys.T.ravel(), raster.PT, box=ax.box,
                                        segments=True)
        line_colour = colours[seg // (t + 2 - s)]
        inside = np.flatnonzero(inside_all[t])
        drows, dcols = raster.discs(px[t, inside], py[t, inside], 5 * raster.PT / 2)
        dot_colour = np.repeat(colours[inside], dot)
        for c in range(min(N, 10)):
            sel = line_colour == c
            raster.blend(img, rows[sel], cols[sel], f"C{c}", 0.6)
        for c in range(min(N, 10)):
            sel = dot_colour == c
            raster.blend(img, drows[sel], dcols[sel], f"C{(N + c) % 10}")
        yield img


def animate_trajectory(
    save_dir: str,
    loc: np.ndarray,
    sim_index: int = 0,
    filename: str = "trajectory.mp4",
    fps: int = 30,
    max_frames: int = 300,
    tail: int = 40,
) -> str:
    """mp4 via ffmpeg if available, else GIF."""
    os.makedirs(save_dir, exist_ok=True)
    a = np.asarray(loc[sim_index])
    if a.shape[0] > max_frames:
        a = a[np.linspace(0, a.shape[0] - 1, max_frames).astype(int)]
    path = os.path.join(save_dir, filename)
    size = animation_figure(a).size_px
    try:
        encode.write_mp4(path, animation_frames(a, tail), size, fps)
    except (FileNotFoundError, RuntimeError):
        path = os.path.join(save_dir, os.path.splitext(filename)[0] + ".gif")
        encode.write_gif(path, list(animation_frames(a, tail)), min(fps, 15))
    return path


def aggregate_checkpoint_plots_pdf(
    run_path: str,
    patterns: Sequence[str] = ("sticking_distribution.png", "collision_distribution.png"),
    filename: str = "checkpoint_plots.pdf",
) -> Optional[str]:
    """Collect per-checkpoint PNGs into one multi-page PDF (checkpoints in
    order, each checkpoint's ``patterns`` in order); None, and no file, when
    there is none."""
    ckpt_root = os.path.join(run_path, "checkpoints")
    if not os.path.isdir(ckpt_root):
        return None
    steps = sorted((d for d in os.listdir(ckpt_root) if d.isdigit()), key=int)
    pages = []
    for step in steps:
        for pat in patterns:
            p = os.path.join(ckpt_root, step, pat)
            if os.path.exists(p):
                pages.append((f"checkpoint {step} — {pat}", encode.as_rgb(encode.read_png(p))))
    out = os.path.join(run_path, filename)
    if not pages:
        if os.path.exists(out):
            os.remove(out)
        return None
    return encode.write_pdf(out, pages)
