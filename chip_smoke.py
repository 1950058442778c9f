#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels (nvcc, one process per source, in parallel)
and its C++ macro library (g++) from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, then drives the port's
main path once through ``rollout.self_feed.run_self_feed`` at the bench
workload -- EGNN-MC (6 layers, width 128, fully connected, f32) on B=64 sims
of N=100 bodies:

  1. device    card name and power limit, torch / CUDA versions, TF32 off
  2. build     kernels (nvcc -> one .so, ctypes) and macro library (g++)
  3. K2        gravity kernel vs plain at (B,N) = (64,100) and (2,300)
  4. K1        EGNN edge kernel vs plain at the bench shape, FC and k=5 masks
  5. datagen   fresh GT trajectories through K2 (2000 substeps, T=200 frames)
  6. rollout   the committed N=100 checkpoint, 199 self-feed steps through K1,
               and 20 steps of the kernel path against the plain path
  7. score     six-macro KS p-values and the Fisher-combined p

Each phase prints one line with its result and elapsed seconds.  Any failed
check exits non-zero before the result is printed.  The second-to-last line
is a JSON object with every kernel's launches on the main path, its error
against the plain version, its time, the plain version's time and its bound;
the last line is ``{"ok": true, "device": {...}}``.  The script writes only
into the package's ignored build directory.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch"
TPU_PKG = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
CKPT = os.path.join(REPO, "docs", "results", "fidelity_n100", "egnn_n100_ckpt_30_model.ckpt")

B, N, WIDTH, LAYERS = 64, 100, 128, 6
SUBSTEPS, SAMPLE_FREQ = 2000, 10
FRAMES = SUBSTEPS // SAMPLE_FREQ
G_CONST, SOFTENING = 2.0, 0.2
COMPARE_STEPS = 20

# K2: same sums in the same order up to rsqrtf's few ulp
K2_RTOL, K2_ATOL = 1e-5, 1e-5
# K1: the kernel sums products and means in another order than cuBLAS / torch
K1_RTOL, K1_ATOL = 1e-4, 1e-5

# H100 SXM peaks (NVIDIA data sheet): f32 on CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
K2_FLOPS_PER_PAIR = 20  # 3 sub, 6 for r2 + eps^2, rsqrt, 3 for inv^3 * m, 3 FMA
T_START = time.perf_counter()


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def report(phase: str, t0: float, **info) -> None:
    items = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{phase}] ok {time.perf_counter() - t0:.2f} s {items}", flush=True)


def bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    sys.path.insert(0, REPO)
    try:
        import importlib

        pkg = importlib.import_module(PKG)  # noqa: F841  (sets the TF32 flags)
        _build = importlib.import_module(f"{PKG}.ops._build")
        gravity = importlib.import_module(f"{PKG}.ops.gravity")
        EM = importlib.import_module(f"{PKG}.ops.egnn_messages")
        physics = importlib.import_module(f"{PKG}.core.physics")
        graph = importlib.import_module(f"{PKG}.core.graph")
        scene_mod = importlib.import_module(f"{PKG}.core.scene")
        models = importlib.import_module(f"{PKG}.models")
        otf = importlib.import_module(f"{PKG}.data.gravity_otf")
        self_feed = importlib.import_module(f"{PKG}.rollout.self_feed")
        native_build = importlib.import_module(f"{PKG}.native.build")
        native = importlib.import_module(f"{PKG}.metrics.native")
        macros = importlib.import_module(f"{PKG}.metrics.macros")
        ks = importlib.import_module(f"{PKG}.metrics.ks")
        weights = importlib.import_module(f"{PKG}.weights")
    except ImportError as e:
        fail(f"the port's package is not importable from {REPO}: {e}")
    if not os.path.exists(CKPT):
        fail(f"checkpoint missing: {CKPT}")
    dev = torch.device("cuda", 0)

    def sync():
        torch.cuda.synchronize(dev)

    def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        sync()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    # ------------------------------------------------------------ 1. device
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    if not card:
        fail(f"nvidia-smi gave no card: {smi.stderr.strip()}")
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    report("device", t0, kind=repr(kind), torch=torch.__version__, cuda=torch.version.cuda,
           tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
           tf32_cudnn=torch.backends.cudnn.allow_tf32)

    # ------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        kern_job = pool.submit(_build.build)
        macro_job = pool.submit(native_build.build)
        try:
            kern_path = kern_job.result()
            macro_path = macro_job.result()
        except Exception as e:  # a failed build fails the smoke, no NumPy fallback
            fail(f"build failed: {e}")
    _build.kernels()
    if native.get_lib() is None:
        fail(f"macro library {macro_path} did not load")
    ptxas = [ln.strip() for ln in _build.build_log.splitlines() if "Used" in ln]
    for ln in ptxas:
        print(f"  ptxas: {ln}", flush=True)
    report("build", t0, kernels=os.path.relpath(kern_path, REPO),
           macros=os.path.relpath(macro_path, REPO))

    gen = torch.Generator(device=dev).manual_seed(0)

    # ---------------------------------------------------------------- 3. K2
    t0 = time.perf_counter()
    k2_err = 0.0
    for bb, nn_, soft in ((B, N, SOFTENING), (2, 300, SOFTENING), (B, N, 0.0)):
        pos = torch.randn((bb, nn_, 3), device=dev, generator=gen) * (nn_ / 5.0) ** (1 / 3)
        mass = torch.rand((bb, nn_, 1), device=dev, generator=gen) + 0.5
        got = gravity.acceleration(pos, mass, G_CONST, soft)
        want = gravity.acceleration_plain(pos, mass, G_CONST, soft)
        sync()
        if not torch.isfinite(got).all():
            fail(f"K2 not finite at B={bb} N={nn_} softening={soft}")
        err = (got - want).abs()
        if not bool((err <= K2_ATOL + K2_RTOL * want.abs()).all()):
            fail(f"K2 disagrees at B={bb} N={nn_} softening={soft}: max abs err {err.max().item()}")
        if soft == SOFTENING:
            k2_err = max(k2_err, err.max().item())
    pos = torch.randn((B, N, 3), device=dev, generator=gen) * (N / 5.0) ** (1 / 3)
    mass = torch.ones((B, N, 1), device=dev)
    k2_ms = cuda_ms(lambda: gravity.acceleration(pos, mass, G_CONST, SOFTENING), iters=200)
    k2_plain_ms = cuda_ms(lambda: gravity.acceleration_plain(pos, mass, G_CONST, SOFTENING), iters=50)
    k2_bound, k2_by = bound_ms(4 * B * N * (3 + 1 + 3), K2_FLOPS_PER_PAIR * B * N * N)
    report("K2", t0, max_abs_err=k2_err, rtol=K2_RTOL, atol=K2_ATOL, ms=f"{k2_ms:.5f}",
           plain_ms=f"{k2_plain_ms:.5f}", bound_ms=f"{k2_bound:.5f}", bound_by=k2_by)

    # ---------------------------------------------------------------- 4. K1
    t0 = time.perf_counter()
    model = models.create_model("egnn_mc", device=dev)
    model.load_state_dict(weights.params_from_jax(weights.read_jax_checkpoint(CKPT)))
    model.eval()
    if len(model.layers) != LAYERS or model.hidden_node_dim != WIDTH:
        fail("the checkpoint is not EGNN-MC 6 x 128")
    Scene = scene_mod.Scene
    pos = torch.randn((B, N, 3), device=dev, generator=gen) * (N / 5.0) ** (1 / 3)
    vel = torch.randn((B, N, 3), device=dev, generator=gen)
    ones = torch.ones((B, N, 1), device=dev)
    scene = Scene(pos=pos, vel=vel, force=torch.zeros_like(pos), mass=ones)
    block = model.layers[0]
    with torch.no_grad():
        x, edge_attr = model.featurize(scene)
        hA, hB, geom = block.edge_inputs(model.embedding(x), pos, edge_attr)
        w = block.edge_weights()
        k1_err = {}
        masks = {"fc": graph.knn_mask(pos, N - 1).float(), "knn5": graph.knn_mask(pos, 5).float()}
        for name, mask in masks.items():
            want = EM.egnn_messages_plain(hA, hB, geom, mask, *w)
            got = EM.fused_egnn_messages(hA, hB, geom, mask, *w)
            sync()
            for label, a, b in (("agg", got[0], want[0]), ("trans", got[1], want[1])):
                if not torch.isfinite(a).all():
                    fail(f"K1 {label} not finite ({name} mask)")
                err = (a - b).abs().max().item()
                scale = b.abs().max().item()
                if err > K1_ATOL + K1_RTOL * scale:
                    fail(f"K1 {label} disagrees ({name} mask): "
                         f"max abs err {err}, max |plain| {scale}")
                k1_err[f"{label}_{name}"] = (err, err / max(scale, 1e-30))
        mask = masks["fc"]
        k1_ms = cuda_ms(lambda: EM.fused_egnn_messages(hA, hB, geom, mask, *w), iters=20)
        k1_plain_ms = cuda_ms(lambda: EM.egnn_messages_plain(hA, hB, geom, mask, *w), iters=5)
    He = Hc = WIDTH
    k1_flops = 2.0 * B * N * N * (He * He + He * Hc + 5 * He + Hc)
    k1_bytes = 4.0 * (2 * B * N * He + B * N * N * 8 + B * N * N + 5 * He + He * He + He
                      + He * Hc + 2 * Hc + B * N * He + B * N * 3)
    k1_bound, k1_by = bound_ms(k1_bytes, k1_flops)
    for key, (a, r) in k1_err.items():
        print(f"  K1 {key}: max_abs_err={a:.3e} max_rel_err={r:.3e}", flush=True)
    report("K1", t0, rtol=K1_RTOL, atol=K1_ATOL, ms=f"{k1_ms:.4f}", plain_ms=f"{k1_plain_ms:.4f}",
           bound_ms=f"{k1_bound:.4f}", bound_by=k1_by, gflop=f"{k1_flops / 1e9:.2f}")

    # ------------------------------------------- 5 + 6. main path (counted)
    class TimedDataset:
        """Times the GT generation that run_self_feed asks for."""

        def __init__(self, ds):
            self.ds, self.target = ds, ds.target

        def get_ground_truth_trajectories(self, batch_size=None):
            t = time.perf_counter()
            out = self.ds.get_ground_truth_trajectories(batch_size)
            sync()
            self.seconds = time.perf_counter() - t
            self.k2 = gravity.acceleration.launches
            self.k1 = EM.fused_egnn_messages.launches
            self.t_end = time.perf_counter()
            return out

    dataset = TimedDataset(otf.GravityDatasetOtf(
        batch_size=B, sim_length=SUBSTEPS, sample_freq=SAMPLE_FREQ, num_nodes=N,
        interaction_strength=G_CONST, softening=SOFTENING, seed=0, device=dev,
    ))
    t0 = time.perf_counter()
    gravity.acceleration.launches = 0
    EM.fused_egnn_messages.launches = 0
    loc_gt, vel_gt, loc_pred, vel_pred, survived_min = self_feed.run_self_feed(model, dataset)
    sync()
    t_main = time.perf_counter()
    k2_launches = gravity.acceleration.launches
    k1_launches = EM.fused_egnn_messages.launches

    if tuple(loc_gt.shape) != (B, FRAMES, N, 3) or not torch.isfinite(loc_gt).all():
        fail(f"GT trajectories bad: shape {tuple(loc_gt.shape)}")
    if dataset.k2 < SUBSTEPS or dataset.k1 != 0:
        fail(f"datagen launched K2 {dataset.k2} times (want >= {SUBSTEPS}) and K1 {dataset.k1}")
    mass = torch.ones((B, 1, N, 1), device=dev)
    _, _, energy = physics.energies(loc_gt, vel_gt, mass, G_CONST, SOFTENING)  # [B, T]
    drift = ((energy[:, -1] - energy[:, 0]).abs() / energy[:, 0].abs()).double()
    print(f"[datagen] ok {dataset.seconds:.2f} s B={B} N={N} substeps={SUBSTEPS} "
          f"frames={FRAMES} k2_launches={dataset.k2} "
          f"energy_drift_rel_mean={drift.mean().item():.3e} max={drift.max().item():.3e}",
          flush=True)

    rollout_s = t_main - dataset.t_end
    want_k1 = LAYERS * (FRAMES - 1)
    if k1_launches - dataset.k1 != want_k1:
        fail(f"rollout launched K1 {k1_launches - dataset.k1} times, want {want_k1}")
    if k2_launches != dataset.k2:
        fail("the rollout launched the gravity kernel")
    if tuple(loc_pred.shape) != (B, FRAMES, N, 3) or not torch.isfinite(loc_pred).all():
        fail(f"rollout bad: shape {tuple(loc_pred.shape)} or non-finite")

    # The kernel path against the plain path, outside the counted run: one model
    # call on GT frame 0, held to K1's tolerance, then COMPARE_STEPS closed-loop
    # steps, printed beside the spread that a 1e-7 relative nudge of frame 0
    # gives the plain path alone (a closed loop amplifies last-bit differences).
    def plain_path():
        return mock.patch.object(EM, "fused_egnn_messages", EM.egnn_messages_plain)

    scene0 = Scene(pos=loc_gt[:, 0], vel=vel_gt[:, 0],
                   force=torch.zeros_like(loc_gt[:, 0]), mass=torch.ones((B, N, 1), device=dev))
    mask0 = graph.knn_mask(scene0.pos, N - 1)
    with torch.no_grad():
        out_k = model(scene0, mask0)
        with plain_path():
            out_p = model(scene0, mask0)
    step_err, step_scale = (out_k - out_p).abs().max().item(), out_p.abs().max().item()
    if not step_err <= K1_ATOL + K1_RTOL * step_scale:
        fail(f"one model call differs by {step_err} between the kernel and plain paths "
             f"(max |out| {step_scale})")
    short = self_feed.make_rollout_fn(model, COMPARE_STEPS + 1)
    loc_k, _, surv_k = short(scene0)
    with plain_path():
        loc_p, _, surv_p = short(scene0)
        nudged = Scene(pos=scene0.pos * (1 + 1e-7), vel=scene0.vel, force=scene0.force,
                       mass=scene0.mass)
        loc_n, _, _ = short(nudged)
    sync()
    d_kp = (loc_k - loc_p).abs().amax(dim=(0, 2, 3))  # per step, over sims and bodies
    d_np = (loc_n - loc_p).abs().amax(dim=(0, 2, 3))
    size = torch.maximum(loc_k.abs().amax(dim=(1, 2, 3)), loc_p.abs().amax(dim=(1, 2, 3)))
    calm = size < 1e3  # sims that stay bounded over the compared steps
    d_calm = (loc_k - loc_p)[calm].abs().max().item() if calm.any() else float("nan")
    dpos = d_kp[-1].item()
    if not torch.isfinite(loc_k).all():
        fail("the kernel path's short rollout is not finite")
    for t in sorted({1, 2, 5, 10, COMPARE_STEPS}):
        print(f"  step {t:3d}: max|dpos| kernel vs plain {d_kp[t].item():.3e}, "
              f"plain vs nudged plain {d_np[t].item():.3e}", flush=True)
    print(f"[rollout] ok {rollout_s:.2f} s steps={FRAMES - 1} layers={LAYERS} width={WIDTH} "
          f"k1_launches={k1_launches - dataset.k1} survived_min={survived_min} "
          f"steps_per_s={(FRAMES - 1) / rollout_s:.2f} one_call_max_abs_err={step_err:.3e} "
          f"max_dpos_{COMPARE_STEPS}_steps={dpos:.3e} "
          f"max_dpos_bounded_sims={d_calm:.3e} ({int(calm.sum())} of {B} sims below 1e3) "
          f"survived_min_kernel/plain={int(surv_k.min())}/{int(surv_p.min())}",
          flush=True)

    # -------------------------------------------------------------- 7. score
    t0 = time.perf_counter()
    gt = macros.compute_all_macros(loc_gt.double().cpu().numpy(), vel_gt.double().cpu().numpy())
    pred = macros.compute_all_macros(loc_pred.double().cpu().numpy(),
                                     vel_pred.double().cpu().numpy())
    import numpy as np

    for name, d in (("gt", gt), ("pred", pred)):
        for key, arr in d.items():
            if arr.shape != (B,):
                fail(f"macro {key} ({name}) has shape {arr.shape}")
            gated = key == "group_collision_count" and N > int(
                os.environ.get("NBX_GROUP_MACRO_MAX_N", "32"))
            if gated != bool(np.isnan(arr).all()) or not (gated or np.isfinite(arr).all()):
                fail(f"macro {key} ({name}) has unexpected NaN / non-finite values")
    per, combined = ks.macro_ks_pvalues(gt, pred)
    if not (combined == combined and 0.0 < combined <= 1.0):
        fail(f"combined p out of range: {combined}")
    pvals = " ".join(f"{k}={v:.3e}" for k, v in per.items())
    report("score", t0, combined_p=f"{combined:.3e}", **{"p": "[" + pvals + "]"})

    kernels = [
        {
            "name": "egnn_messages (K1)",
            "route": "cuda",
            "source": f"{PKG}/csrc/egnn_messages.cu",
            "replaces": f"{TPU_PKG}/ops/pallas/egnn_messages.py:197",
            "launches": k1_launches,
            "max_abs_err": max(a for a, _ in k1_err.values()),
            "ms": k1_ms,
            "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound,
            "bound_by": k1_by,
            "library_ms": None,
        },
        {
            "name": "gravity (K2)",
            "route": "cuda",
            "source": f"{PKG}/csrc/gravity.cu",
            "replaces": f"{TPU_PKG}/ops/pallas/gravity.py:69",
            "launches": k2_launches,
            "max_abs_err": k2_err,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound,
            "bound_by": k2_by,
            "library_ms": None,
        },
    ]
    print(f"total {time.perf_counter() - T_START:.2f} s on {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
