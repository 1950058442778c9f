"""Figures of the evaluation, drawn with numpy and the standard library:
macro histograms, trajectories, p-value curves and the studies' figures
(:mod:`.macro_plots`, :mod:`.trajectories`), rendered by :mod:`.raster` and
written by :mod:`.encode` (PNG, GIF, mp4 through ffmpeg, PDF).  No
matplotlib and no Pillow."""

from .macro_plots import plot_macro_histograms  # noqa: F401
