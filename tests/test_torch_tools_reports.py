"""The port's host tools (``<torch>/tools/``) against the JAX repo's
``scripts/`` of the same names, on the CPU.

* ``diagnose_macros``: the same stdout, stderr and exit code on committed
  archives (read only): rows one by one, files given by name, every
  archived summary and battery at once, an empty dir.
* ``results_report``: ``collect`` equal on the committed ``docs/results``
  (read only); on two copies of its JSON files and READMEs in ``tmp_path``
  the CSV byte for byte the script's, and the figure's record (file, size,
  titles, labels, scales, line points; ``tests/test_torch_viz.py``'s
  record of a matplotlib figure) the one of the JAX script's
  ``_plot_multi_model``; the port's PNG decoded at that size.
* ``archive_row``: from one workdir, the same tree as the script's (file
  names and bytes, mtimes of the copies), the same stdout JSON but for the
  fields written from an absolute path (``dest`` and ``kept_ckpt``: each run
  writes into its own results dir), the same stderr (the fallback warning)
  and exit code.  No field is written from the clock; the README's file
  mtime is (its bytes are compared).
* ``wait_for_backend``: exit codes under a patched probe, and with the real
  probe on the host (``--platform cpu``).
* Importing every tool, and drawing a report's figure, loads no JAX, flax,
  optax, matplotlib, Pillow or module of the JAX package (a subprocess).
"""

import csv
import glob
import importlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import textwrap
from contextlib import redirect_stderr, redirect_stdout

import pytest
from test_torch_viz import _mpl_record, _same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "docs", "results")
PORT = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch"
TOOLS = ("pipeline", "wait_for_backend", "diagnose_macros", "archive_row", "results_report")
TD = importlib.import_module(PORT + ".tools.diagnose_macros")
TR = importlib.import_module(PORT + ".tools.results_report")
TA = importlib.import_module(PORT + ".tools.archive_row")
TW = importlib.import_module(PORT + ".tools.wait_for_backend")
device = importlib.import_module(PORT + ".utils.device")
TM = importlib.import_module(PORT + ".viz.macro_plots")
encode = importlib.import_module(PORT + ".viz.encode")


def _load_script(name):
    """``scripts/<name>.py`` under a module name of its own (the JAX tests
    import them as top-level modules)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JD, JR, JA = (_load_script(n) for n in ("diagnose_macros", "results_report", "archive_row"))


def _run(main, argv):
    """``(exit code, stdout, stderr)`` of ``main(argv)``."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _snapshot(root):
    """Every file under ``root`` with its bytes and mtime."""
    got = {}
    for r, _, fs in os.walk(root):
        for n in fs:
            p = os.path.join(r, n)
            with open(p, "rb") as f:
                got[os.path.relpath(p, root)] = (f.read(), os.stat(p).st_mtime_ns)
    return got


# ------------------------------------------------------ diagnose_macros


def _all_archives():
    return sorted(glob.glob(os.path.join(RESULTS, "*", "ks_summary*.json"))
                  + glob.glob(os.path.join(RESULTS, "*", "draws*.json")))


DIAGNOSES = {
    "row_dirs": lambda: [os.path.join(RESULTS, r) for r in ("cgenn_harden_A", "gt10m_r5")],
    "row_files": lambda: sorted(glob.glob(os.path.join(RESULTS, "segnn10m_r5", "*.json"))),
    "top5_all": lambda: ["--top", "5"] + _all_archives(),
    "fidelity": lambda: sorted(glob.glob(os.path.join(RESULTS, "fidelity_n100", "egnn_*.json"))),
    "empty": lambda: [os.path.join(RESULTS, "bign")],
}


@pytest.mark.parametrize("case", list(DIAGNOSES))
def test_diagnose_macros_prints_what_the_script_prints(case):
    argv = DIAGNOSES[case]()
    before = _snapshot(os.path.join(RESULTS, "cgenn_harden_A"))
    got, want = _run(TD.main, argv), _run(JD.main, argv)
    assert got == want
    assert got[0] == (1 if case == "empty" else 0)
    if case != "empty":
        assert "verdict: '" in got[1] and " binds (" in got[1]
    assert _snapshot(os.path.join(RESULTS, "cgenn_harden_A")) == before


# ------------------------------------------------------- results_report


def _dumps(obj):
    return json.dumps(obj, sort_keys=True)  # NaN compares as its text


def test_results_report_collect_equals_the_script_on_the_committed_rows():
    got, want = TR.collect(RESULTS), JR.collect(RESULTS)
    assert _dumps(got) == _dumps(want)
    rows, series = got
    assert len(rows) >= 10 and series
    assert TR.FIELDS == JR.FIELDS


def _copy_results(dst):
    """The committed rows' JSON files and READMEs, the report's inputs."""
    for src in glob.glob(os.path.join(RESULTS, "**", "*"), recursive=True):
        if os.path.isfile(src) and (src.endswith(".json") or src.endswith("README.md")):
            out = os.path.join(dst, os.path.relpath(src, RESULTS))
            os.makedirs(os.path.dirname(out), exist_ok=True)
            shutil.copy2(src, out)


@pytest.fixture
def recorded(monkeypatch):
    """Every figure matplotlib saves while the test runs, in order."""
    import matplotlib.figure

    records = []
    orig = matplotlib.figure.Figure.savefig

    def savefig(self, fname, *args, **kwargs):
        if isinstance(fname, (str, os.PathLike)):
            records.append(_mpl_record(self, fname))
        return orig(self, fname, *args, **kwargs)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", savefig)
    return records


def test_results_report_writes_the_scripts_csv_and_figure(tmp_path, recorded):
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    _copy_results(j)
    _copy_results(t)
    rc_j, out_j, _ = _run(JR.main, ["--results-dir", j])
    rc_t, out_t, _ = _run(TR.main, ["--results-dir", t])
    assert rc_j == rc_t == 0
    assert out_t.replace(t, "<dir>") == out_j.replace(j, "<dir>")
    name = "combined_pvalues_summary.csv"
    with open(os.path.join(j, name), "rb") as a, open(os.path.join(t, name), "rb") as b:
        want = a.read()
        assert b.read() == want
    assert len(list(csv.DictReader(io.StringIO(want.decode())))) >= 10
    _, series = TR.collect(t)
    fig = TM.multi_model_figure(series, "combined_pvalues_multi.png")
    _same([fig], recorded)
    png = encode.read_png(os.path.join(t, "combined_pvalues_multi.png"))
    assert png.shape[:2] == fig.size_px[::-1] and (png != 255).any()


def test_results_report_empty_dir_fails_alike(tmp_path):
    argv = ["--results-dir", str(tmp_path)]
    assert _run(TR.main, argv) == _run(JR.main, argv)
    assert _run(TR.main, argv)[0] == 1


# ---------------------------------------------------------- archive_row


def _mk_run(wd, name, ck_ps, draws, ckpts=(), extras=()):
    rd = os.path.join(wd, "runs", "egnn_mc", name)
    os.makedirs(rd)
    with open(os.path.join(rd, "ks_summary.json"), "w") as f:
        json.dump({"run_path": rd, "best_combined_pvalue": max(ck_ps.values()),
                   "results": [{"checkpoint": c, "combined_pvalue": p}
                               for c, p in ck_ps.items()]}, f)
    for ext in extras:
        with open(os.path.join(rd, f"ks_results.{ext}"), "wb") as f:
            f.write(f"{name} {ext}".encode())
    for dname, p in draws.items():
        os.makedirs(os.path.join(rd, dname))
        with open(os.path.join(rd, dname, "self_feed_draws.json"), "w") as f:
            json.dump({"best_combined_pvalue": p, "draws": [{"combined_pvalue": p}]}, f)
    for c in ckpts:
        os.makedirs(os.path.join(rd, "checkpoints", str(c)))
        with open(os.path.join(rd, "checkpoints", str(c), "model.ckpt"), "wb") as f:
            f.write(f"{name} params {c}".encode())
    return rd


def _workdir_one(wd):
    _mk_run(wd, "2026-01-01_00-00-00__a", {10: 1e-4, 50: 2e-3},
            {"draws_ckpt50": 3e-3, "draws2_ckpt50": 1.5e-3}, ckpts=(10, 50),
            extras=("csv", "png"))


def _workdir_fallback(wd):
    # the older run dir wins the battery at ckpt 50 but lost that checkpoint;
    # the newer one has a checkpoint 50 of its own: kept with a warning
    _mk_run(wd, "2026-01-01_00-00-00__a", {50: 1e-4}, {"draws_ckpt50": 9e-3})
    _mk_run(wd, "2026-01-02_00-00-00__b", {50: 1e-5, 60: 2e-5}, {"draws_ckpt60": 1e-6},
            ckpts=(50, 60), extras=("csv",))


def _workdir_no_draws(wd):
    _mk_run(wd, "2026-01-01_00-00-00__a", {10: 1e-4, 20: 5e-4}, {}, ckpts=(20,))


@pytest.mark.parametrize("layout,extra", [
    (_workdir_one, ["--note", "a port row\n"]),
    (_workdir_fallback, []),
    (_workdir_no_draws, ["--no-keep-ckpt"]),
    (lambda wd: os.makedirs(wd), []),  # nothing to archive
])
def test_archive_row_writes_the_scripts_tree(tmp_path, layout, extra):
    wd = str(tmp_path / "wd")
    layout(wd)
    runs = {}
    for tag, main in (("j", JA.main), ("t", TA.main)):
        results = str(tmp_path / tag)
        runs[tag] = (results, _run(main, ["--workdir", wd, "--dest", "row",
                                          "--results-dir", results, *extra]))
    (rj, (rc_j, out_j, err_j)), (rt, (rc_t, out_t, err_t)) = runs["j"], runs["t"]
    assert (rc_t, err_t) == (rc_j, err_j)
    if rc_j:
        assert not os.path.exists(rt) and not os.path.exists(rj)
        return
    # the copies keep their sources' mtimes; README.md is written, at each run's time
    got, want = _snapshot(rt), _snapshot(rj)
    readme = os.path.join("row", "README.md")
    assert got.pop(readme)[0] == want.pop(readme)[0]
    assert got == want
    pj, pt = json.loads(out_j), json.loads(out_t)
    # written from an absolute path: the row's dir and the kept checkpoint, under
    # each run's own results dir
    assert pt.pop("dest") == os.path.join(rt, "row") and pj.pop("dest") == os.path.join(rj, "row")
    kj, kt = pj.pop("kept_ckpt"), pt.pop("kept_ckpt")
    assert (kj is None) == (kt is None) == ("--no-keep-ckpt" in extra)
    if kt is not None:
        assert os.path.relpath(kt, rt) == os.path.relpath(kj, rj)
    assert pt == pj
    if layout is _workdir_fallback:
        assert "WARNING" in err_t
        with open(os.path.join(rt, "row", "ckpt_50_model.ckpt"), "rb") as f:
            assert f.read() == b"2026-01-02_00-00-00__b params 50"


# ------------------------------------------------------ wait_for_backend


def test_wait_for_backend_exit_codes_under_a_patched_probe(monkeypatch, capsys):
    seen = []

    def probe(answers):
        def healthy(probe_timeout_s, platform):
            seen.append((probe_timeout_s, platform))
            return answers.pop(0)
        return healthy

    monkeypatch.setattr(device, "backend_healthy", probe([True]))
    assert TW.main([]) == 0 and seen == [(90.0, "cuda")]
    assert "backend healthy" in capsys.readouterr().out
    monkeypatch.setattr(device, "backend_healthy", probe([False]))
    assert TW.main(["--max-wait", "0", "--platform", "cpu"]) == 1
    assert "unavailable at deadline" in capsys.readouterr().err
    seen.clear()
    monkeypatch.setattr(device, "backend_healthy", probe([False, False, True]))
    assert TW.main(["--max-wait", "30", "--poll", "0", "--probe-timeout", "5"]) == 0
    assert seen == [(5.0, "cuda")] * 3


def test_wait_for_backend_with_the_real_probe():
    res = subprocess.run([sys.executable, "-m", PORT + ".tools.wait_for_backend",
                          "--platform", "cpu", "--max-wait", "0", "--probe-timeout", "120"],
                         capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=240)
    assert res.returncode == 0, res.stderr
    assert res.stdout == "backend healthy\n"


# -------------------------------------------------------------- imports


def test_tools_load_no_jax_and_no_matplotlib(tmp_path):
    row = tmp_path / "results" / "row"
    row.mkdir(parents=True)
    (row / "ks_summary.json").write_text(json.dumps({
        "run_path": "/x/runs/egnn_mc/r", "best_combined_pvalue": 0.2,
        "results": [{"checkpoint": 1, "combined_pvalue": 0.1},
                    {"checkpoint": 2, "combined_pvalue": 0.2}]}))
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {TOOLS!r}:
            importlib.import_module({PORT!r} + ".tools." + name)
        rr = sys.modules[{PORT!r} + ".tools.results_report"]
        assert rr.main(["--results-dir", {str(tmp_path / "results")!r}]) == 0
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "optax", "matplotlib", "PIL")
                     or m.split(".")[0] == {PORT[:-len("_torch")]!r})
        print("loaded:", bad)
        assert not bad
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert (tmp_path / "results" / "combined_pvalues_multi.png").exists()
