#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels (nvcc, one process per source, in parallel)
and its C++ macro library (g++) from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, then drives the port's
two paths through ``rollout.self_feed.run_self_feed`` with the committed N=100
checkpoint of EGNN-MC (6 layers, width 128, fully connected, f32): the bench
workload (B=64 sims of N=100 bodies, dense edge stage K1) and the big-N path
(B=8 sims of N=512 bodies, streaming edge stage K3):

  1. device        card name and power limit, torch / CUDA versions, TF32 off
  2. build         kernels (nvcc -> one .so, ctypes) and macro library (g++)
  3. K2            gravity kernel vs plain at (B,N) = (64,100) and (2,300)
  4. K1            EGNN edge kernel vs plain at the bench shape, FC and k=5 masks
  5. K3            streaming edge kernel vs plain at (8,512) FC and k=5, (2,300)
                   and (1,1000), both norm_diff settings; vs K1 at (8,512)
  6. datagen       fresh GT trajectories through K2 (2000 substeps, T=200 frames)
  7. rollout       199 self-feed steps through K1, and 20 steps of the kernel
                   path against the plain path
  8. score         six-macro KS p-values and the Fisher-combined p
  9. bign-rollout  GT at N=512 through K2 (1000 substeps, T=100), 99 streaming
                   steps through K3, 20 steps against the plain path, KS score
 10. bign          bign_bench rows: steps/s and peak memory, dense K1 against
                   streaming K3, at (N,B) = (256,16), (512,8), (1024,2), (4096,1)

Each phase prints one line with its result and elapsed seconds.  Any failed
check exits non-zero before the result is printed.  The second-to-last line
is a JSON object with every kernel's launches on its path, its error against
the plain version, its time, the plain version's time and its bound; the last
line is ``{"ok": true, "device": {...}}``.  The script writes only into the
package's ignored build directory.
"""

from __future__ import annotations

import json
import os
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
# the big-N path: the N=100 checkpoint rolled out at N=512 (EGNN's parameters
# do not depend on N)
BIG_B, BIG_N, BIG_SUBSTEPS = 8, 512, 1000
BIG_FRAMES = BIG_SUBSTEPS // SAMPLE_FREQ
K3_SHAPES = ((8, 512, ("fc", "knn5")), (2, 300, ("fc",)), (1, 1000, ("fc",)))
BIGN_STEPS = 20

# K2: same sums in the same order up to rsqrtf's few ulp
K2_RTOL, K2_ATOL = 1e-5, 1e-5
# K1 and K3: the kernels sum products and means in another order than cuBLAS / torch
K1_RTOL, K1_ATOL = 1e-4, 1e-5

# H100 SXM peaks (NVIDIA data sheet): f32 on CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
K2_FLOPS_PER_PAIR = 20  # 3 sub, 6 for r2 + eps^2, rsqrt, 3 for inv^3 * m, 3 FMA
T_START = time.perf_counter()


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def report(phase: str, t0: float, seconds=None, **info) -> None:
    """One phase's line: its seconds (since ``t0`` unless given) and results."""
    seconds = time.perf_counter() - t0 if seconds is None else seconds
    items = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{phase}] ok {seconds:.2f} s {items}", flush=True)


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
        ES = importlib.import_module(f"{PKG}.ops.egnn_stream")
        bign_bench = importlib.import_module(f"{PKG}.bign_bench")
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
    card = bign_bench.card_name()
    if not card:
        fail("nvidia-smi gave no card name and power limit")
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

    def check_close(kernel: str, label: str, got, want, errs: dict) -> None:
        """Hold a kernel's ``(agg, trans)`` against a reference's, at K1's tolerance
        against the reference's scale; record the errors in ``errs``."""
        for part, a, b in (("agg", got[0], want[0]), ("trans", got[1], want[1])):
            if not torch.isfinite(a).all():
                fail(f"{kernel} {part} not finite ({label})")
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            if err > K1_ATOL + K1_RTOL * scale:
                fail(f"{kernel} {part} disagrees ({label}): "
                     f"max abs err {err}, max |reference| {scale}")
            errs[f"{part} {label}"] = (err, err / max(scale, 1e-30))

    def print_errs(kernel: str, errs: dict) -> None:
        for key, (a, r) in errs.items():
            print(f"  {kernel} {key}: max_abs_err={a:.3e} max_rel_err={r:.3e}", flush=True)

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
    w = block.edge_weights()
    k1_err = {}
    with torch.no_grad():
        x, edge_attr = model.featurize(scene)
        hA, hB, geom = block.edge_inputs(model.embedding(x), pos, edge_attr)
        masks = {"fc": graph.knn_mask(pos, N - 1).float(), "knn5": graph.knn_mask(pos, 5).float()}
        for name, mask in masks.items():
            check_close("K1", f"{name} mask", EM.fused_egnn_messages(hA, hB, geom, mask, *w),
                        EM.egnn_messages_plain(hA, hB, geom, mask, *w), k1_err)
        mask = masks["fc"]
        k1_ms = cuda_ms(lambda: EM.fused_egnn_messages(hA, hB, geom, mask, *w), iters=20)
        k1_plain_ms = cuda_ms(lambda: EM.egnn_messages_plain(hA, hB, geom, mask, *w), iters=5)
    He = Hc = WIDTH
    edge_flops = He * He + He * Hc + 5 * He + Hc  # per edge row, times 2 for multiply-add
    weight_floats = 5 * He + He * He + He + He * Hc + 2 * Hc
    k1_flops = 2.0 * B * N * N * edge_flops
    k1_bytes = 4.0 * (2 * B * N * He + B * N * N * 8 + B * N * N + weight_floats
                      + B * N * He + B * N * 3)
    k1_bound, k1_by = bound_ms(k1_bytes, k1_flops)
    print_errs("K1", k1_err)
    report("K1", t0, rtol=K1_RTOL, atol=K1_ATOL, ms=f"{k1_ms:.4f}", plain_ms=f"{k1_plain_ms:.4f}",
           bound_ms=f"{k1_bound:.4f}", bound_by=k1_by, gflop=f"{k1_flops / 1e9:.2f}")

    # ---------------------------------------------------------------- 5. K3
    t0 = time.perf_counter()
    k3_err, k3_vs_k1_err = {}, {}
    with torch.no_grad():
        for bb, nn_, mask_names in K3_SHAPES:
            pos0 = torch.randn((bb, nn_, 3), device=dev, generator=gen) * (nn_ / 5.0) ** (1 / 3)
            vel = torch.randn((bb, nn_, 3), device=dev, generator=gen)
            mass = torch.rand((bb, nn_, 1), device=dev, generator=gen) + 0.5
            coord = pos0 + 0.1 * torch.randn((bb, nn_, 3), device=dev, generator=gen)
            x = torch.cat([torch.linalg.vector_norm(vel, dim=-1, keepdim=True), mass], dim=-1)
            h = model.embedding(x)
            hA, hB = block.node_terms(h)
            node = (pos0, vel, mass, coord)
            for name in mask_names:
                mask = graph.knn_mask(pos0, nn_ - 1 if name == "fc" else 5).float()
                for nd in (True, False):
                    check_close("K3", f"{bb}x{nn_} {name} norm_diff={nd}",
                                ES.streaming_egnn_messages(hA, hB, *node, mask, *w, norm_diff=nd),
                                ES.streaming_egnn_messages_plain(hA, hB, *node, mask, *w,
                                                                 norm_diff=nd),
                                k3_err)
            if (bb, nn_) != K3_SHAPES[0][:2]:
                continue
            # the main shape: K3 against K1 fed the dense path's geometry (the
            # model's norm_diff), then the times
            mask = graph.knn_mask(pos0, nn_ - 1).float()
            _, edge_attr = model.featurize(Scene(pos=pos0, vel=vel, force=torch.zeros_like(pos0),
                                                 mass=mass))
            _, _, geom = block.edge_inputs(h, coord, edge_attr)
            check_close("K3 vs K1", f"{bb}x{nn_} fc",
                        ES.streaming_egnn_messages(hA, hB, *node, mask, *w),
                        EM.fused_egnn_messages(hA, hB, geom, mask, *w), k3_vs_k1_err)
            del edge_attr, geom
            k3_ms = cuda_ms(lambda: ES.streaming_egnn_messages(hA, hB, *node, mask, *w), iters=10)
            k3_plain_ms = cuda_ms(
                lambda: ES.streaming_egnn_messages_plain(hA, hB, *node, mask, *w),
                iters=3, warmup=1)
            k3_b, k3_n = bb, nn_
    k3_flops = 2.0 * k3_b * k3_n * k3_n * edge_flops
    k3_bytes = 4.0 * (2 * k3_b * k3_n * He + k3_b * k3_n * 10 + k3_b * k3_n * k3_n
                      + weight_floats + k3_b * k3_n * (He + 3))
    k3_bound, k3_by = bound_ms(k3_bytes, k3_flops)
    print_errs("K3", k3_err)
    print_errs("K3 vs K1", k3_vs_k1_err)
    report("K3", t0, rtol=K1_RTOL, atol=K1_ATOL, shape=f"B={k3_b},N={k3_n}", ms=f"{k3_ms:.4f}",
           plain_ms=f"{k3_plain_ms:.4f}", bound_ms=f"{k3_bound:.4f}", bound_by=k3_by,
           gflop=f"{k3_flops / 1e9:.2f}")

    # ------------------------------------------------ helpers of the paths
    def counts() -> dict:
        return {"k1": EM.fused_egnn_messages.launches, "k2": gravity.acceleration.launches,
                "k3": ES.streaming_egnn_messages.launches}

    def reset_counts() -> None:
        EM.fused_egnn_messages.launches = 0
        gravity.acceleration.launches = 0
        ES.streaming_egnn_messages.launches = 0

    class TimedDataset:
        """Times the GT generation that run_self_feed asks for, and reads the
        launch counts at its end."""

        def __init__(self, ds):
            self.ds, self.target = ds, ds.target

        def get_ground_truth_trajectories(self, batch_size=None):
            t = time.perf_counter()
            out = self.ds.get_ground_truth_trajectories(batch_size)
            sync()
            self.seconds = time.perf_counter() - t
            self.counts = counts()
            self.t_end = time.perf_counter()
            return out

    def drive(model_, bb: int, nn_: int, substeps: int, seed: int, edge_kernel: str):
        """One counted run of a path: fresh GT through K2, then the self-feed
        rollout, which must launch ``edge_kernel`` once per layer and step and
        no other kernel."""
        frames = substeps // SAMPLE_FREQ
        ds = TimedDataset(otf.GravityDatasetOtf(
            batch_size=bb, sim_length=substeps, sample_freq=SAMPLE_FREQ, num_nodes=nn_,
            interaction_strength=G_CONST, softening=SOFTENING, seed=seed, device=dev,
        ))
        reset_counts()
        loc_gt, vel_gt, loc_pred, vel_pred, survived_min = self_feed.run_self_feed(model_, ds)
        sync()
        t_end = time.perf_counter()
        total = counts()
        if tuple(loc_gt.shape) != (bb, frames, nn_, 3) or not torch.isfinite(loc_gt).all():
            fail(f"GT trajectories bad at N={nn_}: shape {tuple(loc_gt.shape)}")
        if ds.counts["k2"] < substeps or ds.counts["k1"] or ds.counts["k3"]:
            fail(f"datagen at N={nn_} launched {ds.counts} (want K2 >= {substeps}, no edge kernel)")
        rolled = {k: total[k] - ds.counts[k] for k in total}
        want = {"k1": 0, "k2": 0, "k3": 0}
        want[edge_kernel] = LAYERS * (frames - 1)
        if rolled != want:
            fail(f"the rollout at N={nn_} launched {rolled}, want {want}")
        if tuple(loc_pred.shape) != (bb, frames, nn_, 3) or not torch.isfinite(loc_pred).all():
            fail(f"rollout bad at N={nn_}: shape {tuple(loc_pred.shape)} or non-finite")
        mass_ = torch.ones((bb, 1, nn_, 1), device=dev)
        _, _, energy = physics.energies(loc_gt, vel_gt, mass_, G_CONST, SOFTENING)  # [B, T]
        drift = ((energy[:, -1] - energy[:, 0]).abs() / energy[:, 0].abs()).double()
        print(f"[datagen] ok {ds.seconds:.2f} s B={bb} N={nn_} substeps={substeps} "
              f"frames={frames} k2_launches={ds.counts['k2']} "
              f"energy_drift_rel_mean={drift.mean().item():.3e} max={drift.max().item():.3e}",
              flush=True)
        return (loc_gt, vel_gt, loc_pred, vel_pred, survived_min, t_end - ds.t_end, total)

    def compare_paths(model_, loc_gt, vel_gt, plain_path, tag: str) -> dict:
        """The kernel path against the plain path, outside the counted run: one
        model call on GT frame 0, held to K1's tolerance, then COMPARE_STEPS
        closed-loop steps, printed beside the spread that a 1e-7 relative nudge
        of frame 0 gives the plain path alone (a closed loop amplifies last-bit
        differences)."""
        bb, nn_ = loc_gt.shape[0], loc_gt.shape[2]
        scene0 = Scene(pos=loc_gt[:, 0], vel=vel_gt[:, 0], force=torch.zeros_like(loc_gt[:, 0]),
                       mass=torch.ones((bb, nn_, 1), device=dev))
        mask0 = graph.knn_mask(scene0.pos, nn_ - 1)
        with torch.no_grad():
            out_k = model_(scene0, mask0)
            with plain_path():
                out_p = model_(scene0, mask0)
        step_err, step_scale = (out_k - out_p).abs().max().item(), out_p.abs().max().item()
        if not step_err <= K1_ATOL + K1_RTOL * step_scale:
            fail(f"{tag}: one model call differs by {step_err} between the kernel and plain "
                 f"paths (max |out| {step_scale})")
        short = self_feed.make_rollout_fn(model_, COMPARE_STEPS + 1)
        loc_k, _, surv_k = short(scene0)
        with plain_path():
            loc_p, _, surv_p = short(scene0)
            nudged = Scene(pos=scene0.pos * (1 + 1e-7), vel=scene0.vel, force=scene0.force,
                           mass=scene0.mass)
            loc_n, _, _ = short(nudged)
        sync()
        if not torch.isfinite(loc_k).all():
            fail(f"{tag}: the kernel path's short rollout is not finite")
        d_kp = (loc_k - loc_p).abs().amax(dim=(0, 2, 3))  # per step, over sims and bodies
        d_np = (loc_n - loc_p).abs().amax(dim=(0, 2, 3))
        size = torch.maximum(loc_k.abs().amax(dim=(1, 2, 3)), loc_p.abs().amax(dim=(1, 2, 3)))
        calm = size < 1e3  # sims that stay bounded over the compared steps
        d_calm = (loc_k - loc_p)[calm].abs().max().item() if calm.any() else float("nan")
        for t in sorted({1, 2, 5, 10, COMPARE_STEPS}):
            print(f"  step {t:3d}: max|dpos| kernel vs plain {d_kp[t].item():.3e}, "
                  f"plain vs nudged plain {d_np[t].item():.3e}", flush=True)
        return {"one_call_max_abs_err": f"{step_err:.3e}",
                f"max_dpos_{COMPARE_STEPS}_steps": f"{d_kp[-1].item():.3e}",
                "max_dpos_bounded_sims": f"{d_calm:.3e} ({int(calm.sum())} of {bb} sims below 1e3)",
                "survived_min_kernel/plain": f"{int(surv_k.min())}/{int(surv_p.min())}"}

    import numpy as np

    def score(tag: str, loc_gt, vel_gt, loc_pred, vel_pred) -> None:
        t0 = time.perf_counter()
        bb, nn_ = loc_gt.shape[0], loc_gt.shape[2]
        gt = macros.compute_all_macros(loc_gt.double().cpu().numpy(), vel_gt.double().cpu().numpy())
        pred = macros.compute_all_macros(loc_pred.double().cpu().numpy(),
                                         vel_pred.double().cpu().numpy())
        gated_group = nn_ > int(os.environ.get("NBX_GROUP_MACRO_MAX_N", "32"))
        for name, d in (("gt", gt), ("pred", pred)):
            for key, arr in d.items():
                if arr.shape != (bb,):
                    fail(f"{tag}: macro {key} ({name}) has shape {arr.shape}")
                gated = key == "group_collision_count" and gated_group
                if gated != bool(np.isnan(arr).all()) or not (gated or np.isfinite(arr).all()):
                    fail(f"{tag}: macro {key} ({name}) has unexpected NaN / non-finite values")
        per, combined = ks.macro_ks_pvalues(gt, pred)
        ext = per.get("stuck_cluster_size", float("nan"))
        if gated_group and not ext == ext:
            fail(f"{tag}: no stuck_cluster_size p-value to stand in for the gated group macro")
        if not (combined == combined and 0.0 < combined <= 1.0):
            fail(f"{tag}: combined p out of range: {combined}")
        pvals = " ".join(f"{k}={v:.3e}" for k, v in per.items())
        report(tag, t0, combined_p=f"{combined:.3e}", **{"p": "[" + pvals + "]"})

    # ------------------------------------------- 6 + 7. main path (counted)
    loc_gt, vel_gt, loc_pred, vel_pred, survived_min, rollout_s, main_counts = drive(
        model, B, N, SUBSTEPS, 0, "k1")
    cmp = compare_paths(model, loc_gt, vel_gt,
                        lambda: mock.patch.object(EM, "fused_egnn_messages", EM.egnn_messages_plain),
                        "rollout")
    report("rollout", 0.0, rollout_s, steps=FRAMES - 1, layers=LAYERS,
           width=WIDTH, k1_launches=main_counts["k1"], survived_min=survived_min,
           steps_per_s=f"{(FRAMES - 1) / rollout_s:.2f}", **cmp)

    # -------------------------------------------------------------- 8. score
    score("score", loc_gt, vel_gt, loc_pred, vel_pred)

    # ------------------------------------------------------ 9. bign-rollout
    # the same checkpoint in the streaming model, at N=512 (counted)
    big_model = models.create_model("egnn_mc", device=dev, streaming=True)
    big_model.load_state_dict(model.state_dict())
    big_model.eval()
    loc_gt, vel_gt, loc_pred, vel_pred, survived_min, big_s, big_counts = drive(
        big_model, BIG_B, BIG_N, BIG_SUBSTEPS, 1, "k3")
    cmp = compare_paths(
        big_model, loc_gt, vel_gt,
        lambda: mock.patch.object(ES, "streaming_egnn_messages", ES.streaming_egnn_messages_plain),
        "bign-rollout")
    report("bign-rollout", 0.0, big_s, B=BIG_B, N=BIG_N,
           steps=BIG_FRAMES - 1, k3_launches=big_counts["k3"], k1_launches=big_counts["k1"],
           survived_min=survived_min, steps_per_s=f"{(BIG_FRAMES - 1) / big_s:.2f}", **cmp)
    score("bign-score", loc_gt, vel_gt, loc_pred, vel_pred)
    del loc_gt, vel_gt, loc_pred, vel_pred, big_model

    # --------------------------------------------------------------- 10. bign
    t0 = time.perf_counter()
    state = bign_bench.seeded_state(2)
    rows = []
    for nn_, bb in bign_bench.SHAPES:
        for path, streaming in bign_bench.PATHS.items():
            reset_counts()
            row = bign_bench.measure_row(nn_, bb, path, BIGN_STEPS, state, dev)
            got = counts()
            want = {"k1": 0, "k2": 0, "k3": 0}
            want["k3" if streaming else "k1"] = LAYERS * (
                bign_bench.WARMUP_STEPS - 1 + BIGN_STEPS - 1)
            if got != want:
                fail(f"bign {path} at N={nn_} launched {got}, want {want}")
            peak, start = row["max_memory_allocated_bytes"], row["start_allocated_bytes"]
            print(f"  N={nn_:5d} B={bb:3d} {path:13s} {row['steps_per_sec']:9.3f} steps/s "
                  f"peak {peak / 2**20:9.1f} MiB, {(peak - start) / 2**20:9.1f} MiB above "
                  f"the start; survived_min {row['survived_min']} "
                  f"warmup {row['compile_s']:.2f} s", flush=True)
            rows.append(row)
    report("bign", t0, steps=BIGN_STEPS, rows=len(rows))

    kernels = [
        {
            "name": "egnn_messages (K1)",
            "route": "cuda",
            "source": f"{PKG}/csrc/egnn_messages.cu",
            "replaces": f"{TPU_PKG}/ops/pallas/egnn_messages.py:197",
            "launches": main_counts["k1"],
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
            "launches": main_counts["k2"],
            "max_abs_err": k2_err,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound,
            "bound_by": k2_by,
            "library_ms": None,
        },
        {
            "name": "egnn_stream (K3)",
            "route": "cuda",
            "source": f"{PKG}/csrc/egnn_stream.cu",
            "replaces": f"{TPU_PKG}/ops/pallas/egnn_stream.py:192",
            "launches": big_counts["k3"],
            "max_abs_err": max(a for a, _ in k3_err.values()),
            "ms": k3_ms,
            "plain_ms": k3_plain_ms,
            "bound_ms": k3_bound,
            "bound_by": k3_by,
            "library_ms": None,
        },
    ]
    print(f"total {time.perf_counter() - T_START:.2f} s on {card}", flush=True)
    print(json.dumps({"bign": rows}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
