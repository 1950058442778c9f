"""The port's figures (``viz/``, numpy and the standard library only) against
the JAX package's (matplotlib), on the CPU at small sizes.

*Figure contents.*  ``matplotlib.figure.Figure.savefig`` is patched while a
JAX function runs, to record each figure it saves: the file name, the pixel
size, and per axes the title, labels, scales, the bars (``ax.patches``: x,
width, height) and the lines' points (``get_xydata``, ``get_data_3d`` in 3D;
3D scatter offsets).  The port's figure description of the same numpy inputs
must give the same record: counts exactly, edges and points to 1e-12 of the
largest value in float64, titles and labels equal (the description keeps the
exact string; the raster draws a non-ASCII character as its stated ASCII
stand-in).  Inputs carry NaN frames where the functions take rollouts.

*HTML.*  ``interactive_trajectory_html`` byte-identical.

*Files.*  Every PNG opens with Pillow at the JAX figure's pixel size and is
not blank; the port's PNG reader gives back what its writer wrote and reads
matplotlib's RGBA PNG; the GIF has the JAX GIF's frame count; the PDF has a
page per PNG and a valid ``xref``, and ``None`` with no file when there is no
PNG.
"""

import io
import json
import os
import re
import subprocess
import sys
import textwrap

import matplotlib

matplotlib.use("Agg")
import matplotlib.figure  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from PIL import Image  # noqa: E402

from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.evaluation import (  # noqa: E402
    ks_checkpoints as JK,
    studies as JS,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.metrics import (  # noqa: E402
    extended_artifacts as JX,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.viz import (  # noqa: E402
    macro_plots as JM,
    trajectories as JT,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.evaluation import (  # noqa: E402
    ks_checkpoints as TK,
    studies as TS,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.metrics import (  # noqa: E402
    extended_artifacts as TX,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.viz import (  # noqa: E402
    encode,
    macro_plots as TM,
    raster,
    trajectories as TT,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch"
RTOL = 1e-12
S, T, N = 4, 40, 5
MACRO_FIELDS = ("sticking_histogram", "collision_histogram", "leaving_count",
                "sharp_turn_count_30", "sharp_turn_count_45", "com_movement",
                "group_collision_count")


# ------------------------------------------------------------ records


def _mpl_record(fig, fname) -> dict:
    W, H = np.round(fig.get_size_inches() * fig.dpi).astype(int)
    axes = []
    for ax in fig.axes:
        three_d = ax.name == "3d"
        rec = dict(title=ax.get_title(), xlabel=ax.get_xlabel(), ylabel=ax.get_ylabel(),
                   xscale=ax.get_xscale(), yscale=ax.get_yscale())
        rec["bars"] = np.array([(p.get_x(), p.get_width(), p.get_height())
                                for p in ax.patches]).reshape(-1, 3)
        rec["lines"] = [np.column_stack(ln.get_data_3d()) if three_d else ln.get_xydata()
                        for ln in ax.lines]
        rec["labels"] = [ln.get_label() if not ln.get_label().startswith("_") else ""
                         for ln in ax.lines]
        rec["points"] = ([np.column_stack([np.asarray(v, float) for v in c._offsets3d])
                          for c in ax.collections] if three_d else [])
        axes.append(rec)
    return dict(file=os.path.basename(str(fname)), size=(int(W), int(H)), axes=axes)


def _port_record(fig: raster.Figure) -> dict:
    axes = []
    for p in fig.panels:
        bars = [(b.edges[i], b.edges[i + 1] - b.edges[i], c)
                for b in p.bars for i, c in enumerate(b.counts)]
        axes.append(dict(
            title=p.title, xlabel=p.xlabel, ylabel=p.ylabel, xscale=p.xscale, yscale=p.yscale,
            bars=np.array(bars, dtype=np.float64).reshape(-1, 3),
            lines=[np.column_stack([ln.x, ln.y] + ([ln.z] if ln.z is not None else []))
                   for ln in p.lines],
            labels=[ln.label for ln in p.lines],
            points=[np.column_stack([pt.x, pt.y, pt.z]) for pt in p.points]))
    return dict(file=fig.filename, size=fig.size_px, axes=axes)


@pytest.fixture
def recorded(monkeypatch):
    """Every figure the JAX package saves while the test runs, in order."""
    records = []
    orig = matplotlib.figure.Figure.savefig

    def savefig(self, fname, *args, **kwargs):
        if isinstance(fname, (str, os.PathLike)):
            records.append(_mpl_record(self, fname))
        return orig(self, fname, *args, **kwargs)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", savefig)
    return records


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    finite = want[np.isfinite(want)]
    scale = np.abs(finite).max() if finite.size else 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, equal_nan=True,
                               err_msg=what)


def _same(port_figs, mpl_records):
    assert [f.filename for f in port_figs] == [r["file"] for r in mpl_records]
    for fig, want in zip(port_figs, mpl_records):
        got = _port_record(fig)
        assert got["size"] == want["size"], fig.filename
        assert len(got["axes"]) == len(want["axes"]), fig.filename
        for i, (g, w) in enumerate(zip(got["axes"], want["axes"])):
            tag = f"{fig.filename} axes {i}"
            for key in ("title", "xlabel", "ylabel", "xscale", "yscale", "labels"):
                assert g[key] == w[key], (tag, key, g[key], w[key])
            assert raster.drawn_text(g["title"]).isascii()
            np.testing.assert_array_equal(g["bars"][:, 2], w["bars"][:, 2], err_msg=tag)
            _close(g["bars"][:, :2], w["bars"][:, :2], tag + " bars")
            assert len(g["lines"]) == len(w["lines"]), tag
            for j, (gl, wl) in enumerate(zip(g["lines"], w["lines"])):
                _close(gl, wl, f"{tag} line {j}")
            assert len(g["points"]) == len(w["points"]), tag
            for gp, wp in zip(g["points"], w["points"]):
                _close(gp, wp, tag + " points")


# ------------------------------------------------------------- inputs


def _walk(seed, nan_from=None):
    rng = np.random.default_rng(seed)
    loc = rng.normal(size=(S, 1, N, 3)).cumsum(axis=1) + rng.normal(
        size=(S, T, N, 3)).cumsum(axis=1) * 0.1
    if nan_from is not None:
        loc[1, nan_from:] = np.nan  # an exploded sim, frozen from here on
    return loc


def _macros(seed, nan=False):
    rng = np.random.default_rng(seed)
    out = {k: rng.poisson(3.0, size=8).astype(np.float64) for k in MACRO_FIELDS}
    out["com_movement"] = rng.gamma(2.0, 1.0, size=8)
    if nan:
        out["group_collision_count"][:] = np.nan  # the gated macro
        out["com_movement"][2] = np.nan
    return out


def _energies(seed, nan=False):
    rng = np.random.default_rng(seed)
    e = {s: rng.normal(size=(3, T, 3)) for s in ("ground truth", "predicted")}
    if nan:
        e["predicted"][1, 25:] = np.nan
    return e


# ------------------------------------------------------- figure parity


@pytest.mark.parametrize("nan", [False, True])
def test_macro_histograms_match(recorded, tmp_path, nan):
    gt, pred = _macros(0, nan), _macros(1)
    del pred["leaving_count"]  # a field missing on one side is skipped
    JM.plot_macro_histograms(str(tmp_path / "j"), gt, pred)
    figs = TM.plot_macro_histograms(str(tmp_path / "t"), gt, pred)
    assert len(figs) == 6
    _same(figs, recorded)


@pytest.mark.parametrize("nan_from", [None, 25])
def test_trajectories_2d_match(recorded, tmp_path, nan_from):
    a, p = _walk(0, nan_from), _walk(1)
    JM.plot_trajectories_2d(str(tmp_path / "j"), a, p)
    _same(TM.plot_trajectories_2d(str(tmp_path / "t"), a, p), recorded)


@pytest.mark.parametrize("nan", [False, True])
def test_extended_multiplots_match(recorded, tmp_path, nan):
    loc = np.stack([_walk(0, 30 if nan else None), _walk(1)])
    vel = np.diff(loc, axis=2, prepend=loc[:, :, :1])
    e = _energies(2, nan)
    JM.plot_extended_multiplots(str(tmp_path / "j"), loc, vel, e)
    figs = TM.plot_extended_multiplots(str(tmp_path / "t"), loc, vel, e)
    assert len(figs) == 5
    _same(figs, recorded)


def test_pvalue_series_matches(recorded, tmp_path):
    per = {"energy_total": [0.2, 0.3, 1e-320], "sticking_histogram": [np.nan] * 3,
           "com_movement": [0.5, np.nan, 0.1]}
    JM.plot_pvalue_series(str(tmp_path / "j"), [10, 20, 30], [0.1, 0.0, 0.9], per)
    _same(TM.plot_pvalue_series(str(tmp_path / "t"), [10, 20, 30], [0.1, 0.0, 0.9], per),
          recorded)


@pytest.mark.parametrize("nan_from", [None, 20])
def test_trajectories_3d_matches(recorded, tmp_path, nan_from):
    loc = _walk(3, nan_from)
    JT.plot_trajectories_3d(str(tmp_path / "j"), loc, sim_index=1, title="predicted sim 1")
    TT.plot_trajectories_3d(str(tmp_path / "t"), loc, sim_index=1, title="predicted sim 1")
    _same([TT.trajectory_3d_figure(loc, 1, title="predicted sim 1")], recorded)


def test_energy_statistics_figure_matches(recorded, tmp_path):
    loc = np.stack([_walk(4), _walk(5)])
    vel = np.diff(loc, axis=2, prepend=loc[:, :, :1])
    JX.write_energy_statistics(str(tmp_path), loc, vel, 2.0, 0.2, plot=True)
    arrays = {s: TX.compute_per_sim_energies(loc[b], vel[b], 2.0, 0.2)
              for b, s in enumerate(TX.TITLE_SUFFIXES)}
    _same([TM.energy_statistics_figure(arrays)], recorded)


def _ckpt_run(root, name, pvals):
    """A run dir whose checkpoints' macro JSONs give combined p-values of the
    given ordering."""
    run = root / name / "run"
    rng = np.random.default_rng(len(pvals))
    for step, shift in pvals:
        d = run / "checkpoints" / str(step)
        d.mkdir(parents=True)
        for fname, field in (("sticking_distributions.json", "sticking_histogram"),
                             ("leaving_distribution.json", "leaving_count")):
            g = rng.poisson(3.0, size=30).tolist()
            p = (rng.poisson(3.0 + shift, size=30)).tolist()
            with open(d / fname, "w") as f:
                json.dump({"ground truth": {field: g}, "predicted": {field: p}}, f)
    return str(run)


def test_ks_figures_match(recorded, tmp_path):
    runs = [_ckpt_run(tmp_path, "egnn_mc", [(1, 3.0), (2, 0.5), (3, 0.0)]),
            _ckpt_run(tmp_path, "painn", [(5, 1.0)])]
    JK.evaluate_run_checkpoints(runs[0], plot=True)
    TK.evaluate_run_checkpoints(runs[0], plot=True)  # overwrites the JAX one's files
    JK.combined_pvalues_report(runs, str(tmp_path / "j" / "summary.csv"))
    TK.combined_pvalues_report(runs, str(tmp_path / "t" / "summary.csv"))
    assert [r["file"] for r in recorded] == ["ks_results.png", "summary_multi.png"]
    s = json.load(open(os.path.join(runs[0], "ks_summary.json")))
    rows = s["results"]
    keys = sorted({k for r in rows for k in r if k not in ("checkpoint", "combined_pvalue")})
    series = {f"{m} (run)": TK.evaluate_run_checkpoints(r, plot=False)["results"]
              for m, r in zip(("egnn_mc", "painn"), runs)}
    _same([TM.pvalue_series_figure([r["checkpoint"] for r in rows],
                                   [r["combined_pvalue"] for r in rows],
                                   {k: [r.get(k, np.nan) for r in rows] for k in keys},
                                   "ks_results.png"),
           TM.multi_model_figure(series, "summary_multi.png")], recorded)
    for d in (tmp_path / "t", runs[0]):
        assert any(n.endswith(".png") for n in os.listdir(d))


def test_study_figures_match(recorded, tmp_path):
    rng = np.random.default_rng(6)
    keys = list(JS.MACRO_KEYS)
    assert keys == list(TS.MACRO_KEYS)
    stats = {k: {"kl": rng.gamma(2.0, 0.1, 10).tolist(), "js": rng.gamma(2.0, 0.01, 10).tolist(),
                 "ks_p": []} for k in keys}
    stats[keys[0]]["kl"][3] = 5.0  # a flier
    floor = rng.uniform(0.0, 1.0, 45).tolist()
    out = {"base_dt": 0.001, "results": {
        str(d): {"combined": float(rng.uniform()),
                 "per_macro_ks_p": {k: float(rng.uniform()) for k in keys}}
        for d in (0.001, 0.005, 0.002, 0.01)}}
    JS._plot_metamacros(str(tmp_path), stats, floor)
    JS._plot_compare_dt(str(tmp_path), out)
    _same([TM.metamacros_figure(stats, floor), TM.compare_dt_figure(out, TS.MACRO_KEYS)],
          recorded)


# --------------------------------------------------------------- files


def test_evaluate_rollout_writes_the_jax_files(tmp_path):
    """``evaluate_rollout(plot=True, extended=True)`` (``cli self-feed --plot``
    and the trainer's ``plot_macros``) writes the JAX package's set of files."""
    from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.metrics import (
        artifacts as JA,
    )
    from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.metrics import (
        artifacts as TA,
    )

    a, p = _walk(0, 30), _walk(1)
    va, vp = np.diff(a, axis=1, prepend=a[:, :1]), np.diff(p, axis=1, prepend=p[:, :1])
    for pkg, root in ((JA, "j"), (TA, "t")):
        pkg.evaluate_rollout(str(tmp_path / root), a, va, p, vp, plot=True, extended=True)

    def files(d):
        return sorted(os.path.relpath(os.path.join(b, n), d) for b, _, ns in os.walk(d)
                      for n in ns)

    want = files(tmp_path / "j")
    assert files(tmp_path / "t") == want
    assert sum(n.endswith(".png") for n in want) == 14


def test_html_is_byte_identical(tmp_path):
    a, p = _walk(0, 30), _walk(1)
    for kw in (dict(), dict(sim_index=1, max_steps=7), dict(loc_pred=None)):
        kw = {"loc_pred": p, **kw}
        j = JT.interactive_trajectory_html(str(tmp_path / "j"), a, **kw)
        t = TT.interactive_trajectory_html(str(tmp_path / "t"), a, **kw)
        assert os.path.basename(j) == os.path.basename(t)
        assert open(t, "rb").read() == open(j, "rb").read()


def test_pngs_open_at_the_jax_size(recorded, tmp_path):
    loc = np.stack([_walk(0, 25), _walk(1)])
    vel = np.diff(loc, axis=2, prepend=loc[:, :, :1])
    JM.plot_extended_multiplots(str(tmp_path / "j"), loc, vel, _energies(0))
    TM.plot_extended_multiplots(str(tmp_path / "t"), loc, vel, _energies(0))
    JT.plot_trajectories_3d(str(tmp_path / "j"), loc[0])
    TT.plot_trajectories_3d(str(tmp_path / "t"), loc[0])
    assert len(recorded) == 6
    for rec in recorded:
        path = tmp_path / "t" / rec["file"]
        im = Image.open(path)
        assert im.size == rec["size"] and im.mode == "RGB", rec["file"]
        arr = np.asarray(im)
        packed = (arr[..., 0].astype(np.int64) << 16) | (arr[..., 1].astype(np.int64) << 8)
        packed |= arr[..., 2]
        assert (arr != 255).any() and np.unique(packed).size > 2
        np.testing.assert_array_equal(encode.read_png(str(path)), arr)


def test_png_reader_round_trips_and_reads_matplotlib(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (31, 47, 3), dtype=np.uint8)
    np.testing.assert_array_equal(encode.read_png(encode.png_bytes(img)), img)
    fig, ax = plt.subplots(figsize=(3, 2))
    ax.plot([0, 1, 3], [2, 0, 1])
    ax.set_title("sine")
    fig.savefig(tmp_path / "m.png")
    plt.close(fig)
    want = np.asarray(Image.open(tmp_path / "m.png"))
    assert want.shape == (200, 300, 4)
    np.testing.assert_array_equal(encode.read_png(str(tmp_path / "m.png")), want)
    for mode, bands in (("L", 1), ("LA", 2), ("RGB", 3)):
        im = Image.fromarray(rng.integers(0, 256, (9, 13, bands), dtype=np.uint8).squeeze(),
                             mode)
        buf = io.BytesIO()
        im.save(buf, "PNG", optimize=True)
        np.testing.assert_array_equal(encode.read_png(buf.getvalue()).squeeze(),
                                      np.asarray(im))


def test_animation_has_the_jax_frame_count(tmp_path):
    loc = _walk(2)
    j = JT.animate_trajectory(str(tmp_path / "j"), loc, max_frames=12, filename="t.mp4")
    t = TT.animate_trajectory(str(tmp_path / "t"), loc, max_frames=12, filename="t.mp4")
    assert os.path.basename(t) == os.path.basename(j)
    if t.endswith(".gif"):
        jg, tg = Image.open(j), Image.open(t)
        assert tg.n_frames == jg.n_frames == 12
        assert tg.size == jg.size == (600, 600)
        tg.seek(5)
        assert len(np.unique(np.asarray(tg.convert("RGB")).reshape(-1, 3), axis=0)) > 3


def _pdf_pages_and_xref(data: bytes) -> int:
    start = int(re.search(rb"startxref\s+(\d+)", data).group(1))
    assert data[start:start + 4] == b"xref"
    m = re.match(rb"xref\s+0 (\d+)\s+", data[start:])
    count = int(m.group(1))
    entries = data[start + m.end():].split(b"\n")[:count]
    for i, e in enumerate(entries[1:], start=1):
        off = int(e[:10])
        assert data[off:].startswith(b"%d 0 obj" % i), i
    return len(re.findall(rb"/Type /Page\b", data))


def test_checkpoint_pdf(tmp_path):
    assert TT.aggregate_checkpoint_plots_pdf(str(tmp_path)) is None  # no checkpoints/
    (tmp_path / "checkpoints" / "7").mkdir(parents=True)
    assert TT.aggregate_checkpoint_plots_pdf(str(tmp_path)) is None
    assert not (tmp_path / "checkpoint_plots.pdf").exists()
    gt, pred = _macros(0), _macros(1)
    TM.plot_macro_histograms(str(tmp_path / "checkpoints" / "7"), gt, pred)
    ck = tmp_path / "checkpoints" / "12"
    ck.mkdir()
    fig, ax = plt.subplots()
    ax.plot([1, 2])
    fig.savefig(ck / "sticking_distribution.png")  # matplotlib's RGBA
    plt.close(fig)
    out = TT.aggregate_checkpoint_plots_pdf(str(tmp_path))
    want = JT.aggregate_checkpoint_plots_pdf(str(tmp_path), filename="jax.pdf")
    assert os.path.basename(out) == "checkpoint_plots.pdf" and want is not None
    data = open(out, "rb").read()
    assert data.startswith(b"%PDF-") and data.rstrip().endswith(b"%%EOF")
    assert _pdf_pages_and_xref(data) == 3  # 7: two patterns; 12: one
    titles = re.findall(rb"\((checkpoint [^)]*)\) Tj", data)
    assert titles == [b"checkpoint 7 - sticking_distribution.png",
                      b"checkpoint 7 - collision_distribution.png",
                      b"checkpoint 12 - sticking_distribution.png"]


def test_gif_encoder_round_trips(tmp_path):
    rng = np.random.default_rng(1)
    frames = []
    for t in range(6):
        f = np.full((40, 50, 3), 255, np.uint8)
        f[5:9, t * 5:t * 5 + 7] = (31, 119, 180)
        f[20 + t] = rng.integers(0, 4, (50, 1)) * 60
        frames.append(f)
    frames.append(frames[-1].copy())  # equal to the one before: one longer frame
    assert encode.write_gif(str(tmp_path / "a.gif"), frames, 10) == 6
    im = Image.open(tmp_path / "a.gif")
    assert im.n_frames == 6
    for i in range(6):
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), frames[i])


# ------------------------------------------- no matplotlib, no Pillow

_CHILD = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("matplotlib", "PIL"):
                raise ImportError("blocked in this test: " + name)
            return None

    sys.meta_path.insert(0, Block())
    from {port}.viz import cli, macro_plots as M, trajectories as T
    from {port}.evaluation import ks_checkpoints as K, studies as S
    from {port}.metrics import artifacts

    out = sys.argv[1]
    rng = np.random.default_rng(0)
    S_, T_, N_ = 2, 12, 3
    loc = rng.normal(size=(S_, T_, N_, 3)).cumsum(axis=1) * 0.1
    vel = np.diff(loc, axis=1, prepend=loc[:, :1])
    ck = os.path.join(out, "run", "checkpoints", "3")
    artifacts.evaluate_rollout(ck, loc, vel, loc + 0.01, vel, plot=True, extended=True)
    cli.main(["--folder", os.path.join(ck, "trajectories_data"), "--html", "--animate",
              "--extended"])
    T.aggregate_checkpoint_plots_pdf(os.path.join(out, "run"))
    K.evaluate_run_checkpoints(os.path.join(out, "run"))
    K.combined_pvalues_report([os.path.join(out, "run")], os.path.join(out, "multi.csv"))
    stats = {{k: {{"kl": [0.1, 0.2, 0.4], "js": [0.01, 0.02, 0.5]}} for k in S.MACRO_KEYS}}
    M.save_figures(out, [M.metamacros_figure(stats, [0.2, 0.5, 0.9]),
                         M.compare_dt_figure({{"base_dt": 0.001, "results": {{
                             "0.001": {{"combined": 0.5, "per_macro_ks_p": {{
                                 k: 0.5 for k in S.MACRO_KEYS}}}}}}}}, S.MACRO_KEYS)])
    pngs = sorted(os.path.relpath(os.path.join(b, n), out) for b, _, ns in os.walk(out)
                  for n in ns if n.endswith((".png", ".gif", ".pdf", ".html")))
    bad = [m for m in sys.modules if m.split(".")[0] in ("matplotlib", "PIL")]
    print(json.dumps({{"files": pngs, "bad": bad}}))
    """
)


def test_port_figures_need_no_matplotlib_or_pillow(tmp_path):
    code = _CHILD.format(port=PORT)
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    names = {os.path.basename(f) for f in got["files"]}
    assert {"sticking_distribution.png", "trajectories_3D_to_2D.png",
            "energy_statistics.png", "feature_distributions.png",
            "trajectory_3d_actual.png", "trajectory.html", "checkpoint_plots.pdf",
            "ks_results.png", "multi_multi.png", "baseline_metamacros.png",
            "compare_dt.png"} <= names
    assert "trajectory.gif" in names or "trajectory.mp4" in names
