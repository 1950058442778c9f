#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels (nvcc, one process per source, in parallel)
and its C++ macro library (g++) from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, then drives the port's
paths through ``rollout.self_feed.run_self_feed`` with the committed N=100
checkpoint of EGNN-MC (6 layers, width 128, fully connected), PONITA's
paths with a fresh model of its 10M run's width at depth 2 (phases 25-29),
SEGNN's with a fresh
model of its 10M run's width at depth 2 (phases 30-34), EquiformerV2's with
its committed 10M checkpoint (phases 35-39), GraphTransformer's with its
committed 10M checkpoint (phases 40-44), PaiNN's with a fresh model at
the width of its stability run and depth 2 (phases 45-48), CGENN's with a
fresh model at its 10M run's shape (phases 49-52), GMN's with a fresh
model at its defaults (phases 53-56), and the offline charged systems
(phases 57-61: the legacy sims, the offline datagen, training SEGNN, EGNN-MC
and GMN on it through ``cli train``), and the multi-GPU paths on gloo ranks
that share the card (phases 63-64: data-parallel ``cli train`` and the
body-sharded ring, each rank a process of its own): the bench
workload (B=64 sims of N=100 bodies, dense edge stage K1) and the big-N path
(B=8 sims of N=512 bodies, streaming edge stage K3), each in f32 and in the
mixed-bf16 model (``compute_dtype="bfloat16"``: hidden and message stack in
bf16, coordinates, geometry and integration in f32).  Phase 24b drives the
research loop's tools (``tools/``) as a user runs them:

  1. device        card name and power limit, torch / CUDA versions, TF32 off,
                   bf16 products reduced in f32
  2. build         kernels (nvcc -> one .so, ctypes) and macro library (g++)
     silu          the edge stage's silu (SFU exp2 and reciprocal) against float64
                   over [-100, 100], and IEEE's edges: -0, NaN, x
  3. K2            gravity kernel vs plain at (B,N) = (64,100), (8,512), (2,300)
                   and (1,8192), and at softening 0
     integrate     the GT integrator K2-leapfrog (one launch a batch, a thread-
                   block cluster a sim) bitwise against the loop of K2 launches
                   at (B,N,substeps) = (64,100,2000), (8,512,1000), (3,300,200),
                   (1,7264,20) (its largest N) and at softening 0, within a
                   tolerance of the plain loop over 20 substeps at (4,100),
                   (64,100) and (8,512); GT datagen seconds both ways at
                   (64,100,2000), (8,512,1000), (64,100,10000), (1,4096,200)
                   and (1,7264,200), the bound, cluster sizes, and the path
                   simulate's rule takes at each
  4. K1            EGNN edge kernel vs plain at the bench shape, FC and k=5 masks,
                   and with hA, hB x100 (pre-activations past expf's overflow);
                   its error against the plain version in float64 beside the
                   f32 plain version's (the gate of its 3xTF32 product)
  5. K1-bf16       its bf16 form vs the bf16 plain version, same shapes, and at
                   (4,5) and (2,33) FC (a 32-row group holds several receivers,
                   groups cross receivers); its error against the plain version
                   in float64 beside the bf16 plain version's (FC); its SFU floor
  6. K3            streaming edge kernel vs plain at (8,512) FC and k=5, (2,300)
                   and (1,1000), both norm_diff settings, and at (2,64) with hA,
                   hB x100; vs K1 at (8,512); against float64 at the FC shapes
                   beside the f32 plain version; the persistent grid's block
                   count at (1,1000) beside the card's SM count
  7. K3-bf16,      its bf16 form and its elem_bf16 form (with bf16 and with f32
     K3-elem       operands) vs their plain versions at (8,512) FC and k=5,
                   (1,1000), (4,5) and (2,33) FC, both norm_diff settings, and at
                   (2,64) with hA, hB x100; the bf16 forms against float64 at
                   the FC path shapes beside the bf16 plain version; SFU floors
  8. datagen       fresh GT trajectories through one K2-leapfrog launch (2000
                   substeps, T=200 frames), no K2 launch
  9. rollout       199 self-feed steps through K1, and 20 steps of the kernel
                   path against the plain path
 10. score         six-macro KS p-values and the Fisher-combined p
 11. determinism   every edge kernel form launched twice on one input gives
                   bitwise-equal outputs; the counted f32 rollout repeated from
                   the same GT gives bitwise-equal trajectories
 12. rollout-bf16  the mixed-bf16 model on the same GT: 199 steps through
                   K1-bf16 only, against the plain path, KS score
 13. bign-rollout  GT at N=512 through K2-leapfrog (1000 substeps, T=100), 99 streaming
                   steps through K3, 20 steps against the plain path, KS score
 14. bign-rollout-bf16  the same GT in the mixed-bf16 streaming model, with
                   the bf16 elementwise stack (99 steps through K3-elem only)
                   and without it (through K3-bf16 only), KS score
 14b. rollout-full-bf16  a full-bf16 scene (scene and parameters in bf16, the
                   JAX package's pallas-bf16-t64): the checkpoint on [determinism]'s
                   GT frame, 20 steps through K1-bf16 only (120 launches), and in
                   the streaming model on [bign-rollout]'s frame, 3 steps through
                   K3-bf16 only (18), finite; each kernel given the bf16 geometry
                   or node inputs bitwise equal to it given them cast to float32
                   by hand; the trainer builds in precision_mode bfloat16 with
                   the kernel edge stage and refuses double
 15. datagen-substeps  GT where simulate's rule takes the loop of K2 launches
                   (B=1, 20 substeps; N=8192, above the integrator's shared
                   memory, and N=7264, where the loop is faster): one K2
                   launch a substep, against the plain loop
 16. train         the trainer on the N=100 study run (EGNN-MC 6 x 128, B=16,
                   2500 substeps, T=250) resumed from the committed checkpoint
                   and its AdamW state: two epochs of 20 steps through the dense
                   autograd edge stage (no K1 launch), then its self-feed
                   evaluation (249 frames, 6 K1 f32 launches a step) and KS
                   score; the written checkpoint read back bitwise; one training
                   step on the card against the same step on the CPU in float64;
                   step ms, steps/s and peak memory (CUDA events), the split of a
                   step and its top kernels (torch.profiler)
 16b. orbax        the orbax checkpoint backend without orbax: the committed
                   tensorstore-written fixture (EGNN-MC 2 x 16) bitwise its
                   model.ckpt; [train]'s run resumed for an epoch of 4 steps with
                   checkpoint_backend orbax, its model.orbax bitwise its
                   model.ckpt, one step resumed from each bitwise equal, each
                   rolled out 20 frames through load_run bitwise equal (6 x 19
                   K1 launches and one K2-leapfrog each); bytes, seconds, the
                   fixture's zstd decode MB/s
 16c. fc-fast      [train]'s dense training step with and without fc_fast, ms
                   a step (a measurement, not a gate)
 17. train-n5      the reference default (N=5, B=64, 10000 substeps) from a fresh
                   initialisation, 50 steps, every loss finite
 18. floor-n100    the GT-vs-GT floor (evaluation.studies.baseline_metamacros) at
                   the committed N=100 protocol: B=16, 2500 substeps, 8 batches
                   (one K2-leapfrog launch each), 28 pairs; per-macro and
                   combined p beside the committed six-macro floor; the combined
                   median at least 0.05; its JSON and figure written for [viz]
 19. floor-n512    the same at N=512: B=8, 1000 substeps, 6 batches, 15 pairs
 20. battery       `cli self-feed --draws 3 --seed 281` on a run dir of the study
                   protocol around the committed checkpoint (its bytes unchanged):
                   3 x 6 x 248 K1 launches; each draw's survived and combined p on
                   the six-macro basis and the committed batteries' five-macro one,
                   beside the committed battery; self_feed_draws.json has the JAX
                   package's keys
 21. validate      `cli validate --batches 2` on that run dir, every loss finite
 22. ks-test       `cli ks-test` on [train]'s run dir: its best checkpoint's
                   combined p equals the one [train] scored, to 1e-12; it writes
                   ks_results.csv, ks_summary.json and ks_results.png
 22b. viz          the figures of [battery]'s first draw (B=16, N=100, T=249),
                   drawn on the host with numpy and the standard library: the
                   macro histograms, the projected trajectories and the KS
                   figures (from [ks-test]'s JSON) by direct calls, then
                   `viz.cli --html --animate --extended`, the checkpoint PDF of
                   both PNG sets; every file there, every PNG decoded at its
                   figure's size and not blank (the floor figure [floor-n100]
                   drew too), each histogram np.histogram of its macro, no
                   matplotlib or PIL imported, no launch, under 10 s
 23. inferencer    Inferencer on the battery's run dir: predict through K1
                   against the plain path, and a 20-step rollout bitwise equal to
                   run_self_feed's from the same scene
 24. hpo           hpo.run_study("egnn_mc", 2 trials, param_small) at the
                   reference default (N=5, B=64): one epoch of 10 steps and a
                   20-step evaluation through K1 a trial, finite values, parameter
                   counts within the budget
 24b. pipeline     the research loop's tools as a user runs them, each a
                   process of its own: `python -m <package>.tools.pipeline` on
                   EGNN-MC at the root config.yaml (6 x 128, N=5, B=64), fresh:
                   2 epochs of 10 steps with a checkpoint and a 100-frame
                   evaluation an epoch (`cli train`: 2 x 6 x 99 K1 launches),
                   `cli ks-test`, a 1-draw battery at the top checkpoint
                   (`cli self-feed`: 6 x 99 K1, 1 K2-leapfrog), the launches
                   read from the lines the CLI prints on the card; its best p
                   the maximum of the run's ks_summary.json and battery; the
                   same call again prints the same JSON and starts no stage;
                   `tools.wait_for_backend` exits 0; `tools.archive_row` into a
                   temporary results dir, `tools.results_report` on it (a CSV
                   row of the run's numbers, a PNG the port's reader decodes),
                   `tools.diagnose_macros` names a binding macro; each stage's
                   and each tool's seconds
 25. ponita        a fresh PONITA at the width of its committed 10M run (width
                   480, 20 orientations) and depth 2 (the run's 5 cut to give the
                   smoke's time to the later families) from a seed: its
                   calibration on a fresh GT frame at B=64, N=5 on the card
                   against the same on the CPU in float64 (6 statistics), its
                   forward against the CPU's float64; the parameter count
                   4,075,946 (parameters and calibration statistics)
 26. ponita-rollout  GT at the reference workload (B=64, N=5, 10000 substeps,
                   T=1000) through one K2-leapfrog launch, 100 self-feed steps (no
                   kernel; the battery rolls 999), six-macro KS score; 20 steps on
                   the card against the CPU's float64 on 4 sims; the 100 steps
                   repeated from the same GT bitwise equal, and their steps/s warm
 27. train-ponita  the train command with the queue's argv (--main.model_type ponita
                   --model.num_layers 2 --model.hidden_features 480, B=64, N=5) from
                   a fresh initialisation that calibrates on its first batch: 2
                   epochs of 20 steps, the checkpoint read back bitwise and in the
                   JAX layout (params, AdamW's mu and nu, calib included), its
                   100-step evaluation and KS score; step ms, busy share, peak
                   memory; then resumed from a copy of that checkpoint on another
                   dataloader seed: 10 steps, the AdamW count and the epoch going on
                   from the saved ones, the calibration the saved one (not run
                   again on the resumed run's first batch)
 28. battery-ponita  [train-ponita]'s checkpoint through the converter, its forward on
                   [ponita]'s GT frame against the CPU's float64; `cli self-feed
                   --draws 1 --seed 281` on its run dir (its bytes unchanged): 999
                   steps, 1 K2-leapfrog launch; six- and five-macro p a draw
 29. hpo-ponita    hpo.run_study("ponita", 2 trials, param_small) at the reference
                   default: one epoch of 10 steps and a 20-step evaluation a trial
 30. segnn         a fresh SEGNN at the width of its committed 10M run (width
                   448, hidden irreps 224x0e+224x1o) and depth 2 (the run's 6 cut
                   to give the smoke's time to the later families; the committed
                   checkpoint stays out of the copy sent to the card) from a seed:
                   a forward at B=64, N=5 on a fresh GT frame against the same
                   model in float64 on the CPU, its ms beside its bound and its
                   device busy share; O(3) equivariance on the card with
                   center_mode "nodes" (a rotation with a reflection); the
                   parameter count 3,721,760
 31. segnn-rollout  GT at the reference workload through one K2-leapfrog
                   launch, 100 self-feed steps (no kernel; the battery rolls 999),
                   six-macro KS score; 20 steps on the card against the CPU's
                   float64 on 4 sims; the 100 steps repeated from the same GT
                   bitwise equal, their steps/s warm
 32. train-segnn   the train command with the queue's argv at depth 2
                   (--main.model_type segnn --model.num_layers 2
                   --model.hidden_features 448, B=64, N=5) from a fresh
                   initialisation: 2 epochs of 20 steps, the checkpoint read back
                   bitwise and in the JAX layout, its 100-step evaluation and KS
                   score, one step from that checkpoint against the CPU's float64
                   step ([train]'s gates); step ms, busy share, peak memory; then
                   resumed from a copy of that checkpoint on another dataloader
                   seed: 10 steps, the AdamW count and the epoch going on
 33. battery-segnn  [train-segnn]'s checkpoint through the converter, its forward on
                   [segnn]'s GT frame against the CPU's float64; `cli self-feed
                   --draws 1 --seed 281` on its run dir (its bytes unchanged): 999
                   steps, 1 K2-leapfrog launch; six- and five-macro p (in (0, 1])
 34. hpo-segnn     hpo.run_study("segnn", 2 trials, param_small) at the reference
                   default: one epoch of 10 steps and a 20-step evaluation a trial
 35. eqv2          the committed EquiformerV2 checkpoint (docs/results/
                   eqv2_10m_L8c128_cont: 8 blocks, 128 channels, 8 heads, lmax 2,
                   mmax 1) through the converter: an eval-mode forward at B=64,
                   N=5 on a fresh GT frame against the same model in float64 on
                   the CPU, its ms, device busy share and kernels beside its bound
                   and the eager byte floor of its S2 grids; permutation
                   equivariance on the card; rotation equivariance of a fresh
                   full-width model with the equivariant velocity gate; the
                   parameter count 9,689,010
 36. eqv2-rollout  GT at the reference workload through one K2-leapfrog launch,
                   100 self-feed steps in training mode with live dropout (masks
                   from a seeded generator on the card; the battery rolls 999),
                   six-macro KS score; 20 eval-mode steps on the card against the
                   CPU's float64 on 4 sims; the 100 steps repeated from the same GT
                   and the same dropout seed bitwise equal, their steps/s warm
 37. train-eqv2    the train command with the queue's argv (--main.model_type
                   equiformer_v2 --model.num_layers 8 --model.sphere_channels 128
                   --model.attn_hidden_channels 128 --model.ffn_hidden_channels 128
                   --model.num_heads 8 --model.remat true, B=64, N=5) resumed from
                   the committed checkpoint, its AdamW state and Noam step: 2
                   epochs of 20 steps with live dropout, the checkpoint read back
                   bitwise and in the JAX layout, its 100-step evaluation and KS
                   score, one step against the CPU's float64 step with both
                   dropout rates at 0 ([train]'s gates); step ms, busy share, peak
                   memory with and without remat; then a fresh initialisation, 10
                   steps, losses finite
 38. battery-eqv2  `cli self-feed --draws 1 --seed 281` on a run dir of the queue's
                   argv around the committed checkpoint (its bytes unchanged, train
                   mode on): 999 steps, 1 K2-leapfrog launch; six- and five-macro p
                   (in (0, 1]) and survival beside the committed 12-draw battery
 39. hpo-equiformer_v2  hpo.run_study("equiformer_v2", 2 trials, param_small) at
                   the reference default: one epoch of 10 steps and a 20-step
                   evaluation a trial, each trial's widths and count those the
                   JAX package's width bisection gives its sampled trial
 40. gt            the committed GraphTransformer checkpoint (docs/results/gt10m_r5:
                   8 layers, width 248, 8 heads of 31, feed-forward 2048) through
                   the converter: an eval-mode forward at B=64, N=5 on a fresh GT
                   frame against the same model in float64 on the CPU, its ms,
                   device busy share and kernels beside its bound; permutation
                   equivariance on the card; the parameter count 10,255,566
 41. gt-rollout    GT at the reference workload through one K2-leapfrog launch,
                   100 self-feed steps in training mode with live dropout (masks
                   from a seeded generator on the card: a broadcast [1, 1, N, N]
                   attention mask and three full ones a layer; the battery rolls
                   999), six-macro KS score; 20 eval-mode steps on the card
                   against the CPU's float64 on 4 sims; the 100 steps repeated
                   from the same GT and the same dropout seed bitwise equal, their
                   steps/s warm
 42. train-gt      the train command with the queue's argv (--main.model_type
                   graph_transformer --model.num_layers 8 --model.hidden_features
                   248 --model.num_heads 8, B=64, N=5) resumed from the committed
                   checkpoint, its AdamW state and Noam step: 2 epochs of 20 steps
                   with live dropout, the checkpoint read back bitwise and in the
                   JAX layout, its 100-step evaluation and KS score, one step
                   against the CPU's float64 step with the dropout rate at 0
                   ([train]'s gates); step ms, busy share, peak memory; then a
                   fresh initialisation, 10 steps, losses finite
 43. battery-gt    `cli self-feed --draws 1 --seed 281` on a run dir of the queue's
                   argv around the committed checkpoint (its bytes unchanged, train
                   mode on): 999 steps, 1 K2-leapfrog launch; six- and five-macro p
                   (in (0, 1]) and survival beside the committed 12-draw battery
 44. hpo-gt        hpo.run_study("graph_transformer", 2 trials, param_small) at the
                   reference default: one epoch of 10 steps and a 20-step
                   evaluation a trial, widths a multiple of the heads
 45. painn         a fresh PaiNN at the width of its stability run
                   (docs/results/painn_stab_v5e/run_config.yaml: width 192, 64
                   RBF, cutoff 10, with that run's stability toggles) and depth 2
                   (the run's 6 cut to give the smoke's time to CGENN and GMN)
                   from a seed: a forward at B=64, N=5 on a fresh GT frame against
                   the CPU's float64, its ms, busy share and kernels beside its
                   bound; rotation, translation and permutation equivariance on
                   the card; the parameter count 2,687,616
 46. painn-rollout  GT at the reference workload through one K2-leapfrog launch,
                   100 self-feed steps (no kernel), six-macro KS score; 20 steps
                   on the card against the CPU's float64 on 4 sims; the 100 steps
                   repeated from the same GT bitwise equal, their steps/s warm
 47. train-painn   the train command with the stability run's argv from a fresh
                   initialisation: 2 epochs of 20 steps, the checkpoint read back
                   bitwise and in the JAX layout, its 100-step evaluation and KS
                   score, one step from that checkpoint against the CPU's float64
                   step ([train]'s gates); step ms, busy share, peak memory; then
                   resumed from a copy of that checkpoint on another dataloader
                   seed: 10 steps, the AdamW count and the epoch going on
 48. hpo-painn     hpo.run_study("painn", 2 trials, param_small) at the reference
                   default: one epoch of 10 steps and a 20-step evaluation a trial
 49. cgenn         a fresh CGENN at its 10M run's shape (docs/results/
                   cgenn_10m_L6h176_cont: 6 layers, 176 channels of Cl(3)
                   multivectors, remat) from a seed: a forward at B=64, N=5 on a
                   fresh GT frame against the CPU's float64, its ms, busy share,
                   kernels and peak memory beside its bound; CGENN is
                   near-equivariant only (its algebra's signature is a frozen
                   metric's eigenvalues), so the card's output at a rotated scene
                   is held against the CPU's float64 output at the same rotated
                   scene, and the CPU's own rotation residual is printed;
                   translation and permutation; the parameter count 9,814,466
                   (also by hpo's meta-device count)
 50. cgenn-rollout  a fresh CGENN of its own at [cgenn]'s width and depth 2 (L6
                   cut for the smoke's time; count 3,272,898): GT at the
                   reference workload through one K2-leapfrog launch,
                   100 self-feed steps (no kernel), six-macro KS score; 20 steps
                   on the card against the CPU's float64 on 4 sims; the 100 steps
                   repeated from the same GT bitwise equal, their steps/s warm
 51. train-cgenn   the train command with the 10M run's argv (--main.model_type
                   cgenn --model.num_layers 6 --model.hidden_features 176
                   --model.remat true, B=64, N=5) from a fresh initialisation: 2
                   epochs of 20 steps, the checkpoint read back bitwise and in the
                   JAX layout, its 100-step evaluation and KS score, one step from
                   that checkpoint against the CPU's float64 step ([train]'s
                   gates); step ms, busy share, peak memory; then resumed from a
                   copy of that checkpoint on another dataloader seed: 10 steps,
                   the AdamW count and the epoch going on
 52. hpo-cgenn     hpo.run_study("cgenn", 2 trials, param_small) at the reference
                   default: one epoch of 10 steps and a 20-step evaluation a
                   trial, each trial's widths and count the JAX bisection's
                   (CGENN_HPO_WANT)
 53. gmn           a fresh GMN at its defaults (64 channels, 4 layers, 5 isolated
                   bodies) from a seed: a forward at B=64, N=5 against the CPU's
                   float64 beside its bound; rotation (exact for GMN),
                   translation and permutation on the card; one forward each of
                   a seeded stick (1, 2, 0) and hinge (0, 0, 2) composition on a
                   seeded scene against the CPU's float64; the count 150,212
 54. gmn-rollout   as [cgenn-rollout]
 55. train-gmn     the train command (--main.model_type gmn, B=64, N=5) as
                   [train-cgenn]
 56. hpo-gmn       hpo.run_study("gmn", 2 trials, mode="free") at the reference
                   default (GMN's space has no width knob to bisect)
 57. legacy-sims   the spring and charged sims (core/legacy_sims.py) at their
                   defaults, 64 sims of 5 balls, 10000 Euler steps, through the
                   samplers on the card: shapes, couplings and charges; the first
                   5 frames against the CPU's float64 from the same initial arrays
                   (redrawn from the same seed), beside the CPU float32's error
                   from them; seconds and launches a step; no kernel of the port's
 58. offline-datagen  both offline datasets (data/offline_datagen.py at the JAX
                   package's defaults: 100 / 20 / 20 sims, 5000 Euler steps, a
                   frame every 100, seed 42), 5_0_0 and 3_2_1 (3 isolated bodies,
                   2 sticks and a hinge), generated on the card: files, shapes,
                   dtypes and cfg lists, edges q q^T; the first 3 frames against
                   the CPU's float64 from the same arrays beside the CPU float32's
                   error; the valid split's stick and hinge-beam lengths over all
                   5000 steps beside the CPU float32's drift from the same arrays;
                   the first 1000 steps run again from the same draws, every frame
                   bitwise equal to the files'; seconds and launches a step
 59. train-offline-segnn  `cli train --main.dataloader_type segnn_nbody_offline`
                   (B=64, frame_0 30, frame_T 40) of SEGNN at config.yaml:36-40
                   (h96, lmax 1) at depth 6 (its 20 layers cut for the smoke's
                   time) on 5_0_0: 2 epochs of 20 steps on the data's
                   masks (no kernel), each epoch's validation on 10 batches of the
                   valid split and their masks, the checkpoint read back bitwise,
                   one step from it against the CPU's float64 ([train]'s gates)
                   with the batch's charges and mask, step ms; resumed from a copy
                   of the checkpoint for 10 steps, the AdamW count and the epoch
                   going on
 60. train-offline-egnn  the same for EGNN-MC at its bench width (L6, 128) on
                   5_0_0 at cutoff rate 0.3: training through the dense edge
                   stage, validation through K1 on the cutoff-rate masks (6
                   launches a batch); K1 against its plain version on a valid
                   batch's mask and on it with a zero-degree receiver, launches
                   counted
 61. train-offline-gmn  the same for GMN at its defaults (h64, L4) on 3_2_1
 62. bign          bign_bench rows: steps/s and peak memory, dense K1 against
                   streaming K3, at (N,B) = (256,16), (512,8), (1024,2), (4096,1)
 63. dp-train      `cli train` data parallel (parallel/) on 2 gloo ranks that share
                   the card (NCCL puts one rank on a card; the machine has one):
                   [train]'s study run resumed from the committed checkpoint at
                   B=64 (32 sims a rank), 4 steps and a 20-step evaluation; each
                   rank's GT rows bitwise the single-process batch's, the ranks'
                   parameters bitwise equal after every step, the first step
                   within [train]'s gates of the single-process card step on the
                   whole batch, the gathered evaluation rollout within YARDSTICK x
                   the nudged spread of the single-process one and survived per
                   sim equal, 120 K1 and 2 K2-leapfrog launches a rank, only the
                   first rank writing; step ms a rank, the gradient all_reduce's
                   share of a step, peak memory, the backend
 64. ring          the body-sharded ring on 4 gloo ranks, a (sim, body) = (2, 2)
                   mesh at [bign-rollout]'s workload (B=8, N=512: 4 sims and 256
                   bodies a rank): the ring force at a GT frame against K2 within
                   K2's tolerance; 20 steps of the committed checkpoint as
                   EGNNMC(body_ring=True) against the single-process plain dense
                   rollout of the same frame (YARDSTICK), survived per sim equal;
                   each rank's peak memory beside the dense path's; then, in the
                   same ranks, the body-sharded training step: a GT batch at
                   B=8, N=100 from sharded_datagen (1 K2-leapfrog launch a rank,
                   its rows bitwise the single-process batch's), one step of the
                   committed checkpoint's training state on the fully connected
                   mask and one on a k=50 mask (make_sharded_train_step(...,
                   shard_bodies=True): receiver rows against gathered senders)
                   within [train]'s gates of the single-process card step, the
                   ranks' parameters bitwise equal, and one backward of
                   EGNNMC(body_ring=True) whose gradient, summed over the ranks,
                   is within [train]'s parameter gate of the dense model's; step
                   ms and peak memory a rank beside the single-process step's;
                   0 card tensors among every rank's gloo collectives

Each phase prints one line with its result and elapsed seconds, and
``[launch-probe]`` lines give the host's microseconds a tiny op at a few
points of the run (the start, around the first torch.profiler trace, before
the families' phases, the end).  Any failed check exits non-zero before the
result is printed.  The second-to-last line
is a JSON object with every kernel's launches on its path (and on the
training and evaluation paths), its error against the plain version, its
time, the plain version's time and its bound (and its launches per rank on
the multi-GPU paths); the last line is ``{"ok":
true, "device": {...}}``.  The script writes only into the package's ignored
build directory and, for the training and evaluation phases, into temporary
working directories that it removes.  It sets ``CUBLAS_WORKSPACE_CONFIG`` so that
the cuBLAS products around the kernels are reproducible too.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import json
import os
import pickle
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before torch loads cuBLAS

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
K3_BF16_SHAPES = ((8, 512, ("fc", "knn5")), (1, 1000, ("fc",)), (4, 5, ("fc",)), (2, 33, ("fc",)))
K3_BF16_F64_SHAPES = ((8, 512), (1, 1000))  # the bf16 forms against float64, FC mask
# K1-bf16 beside its path shape: n = 5 (a 32-row group holds several receivers)
# and n = 33 (the groups' receivers run across their edges), FC
K1_BF16_SMALL = ((4, 5), (2, 33))
K3_F64_SHAPES = ((8, 512), (2, 300), (1, 1000))  # K3 against float64 (check_f64), FC mask
BIGN_STEPS = 20

# K2: same sums in the same order up to rsqrtf's few ulp
K2_RTOL, K2_ATOL = 1e-5, 1e-5
DT = 0.01  # the datagen's substep (GravityParams, GravityDatasetOtf)
# K2-leapfrog against the loop of K2 launches: bitwise, at (B, N, substeps, softening)
INTEGRATE_BITWISE = ((B, N, SUBSTEPS, SOFTENING), (BIG_B, BIG_N, BIG_SUBSTEPS, SOFTENING),
                     (3, 300, 200, SOFTENING), (16, 100, 200, 0.0), (1, 7264, 20, SOFTENING),
                     # the trainer's GT: the reference default and the N=100 study run
                     (64, 5, 10000, SOFTENING), (16, 100, 2500, SOFTENING))
# ... and against the plain loop over 20 substeps, a frame each, at its launch
# for (4, 100) and at the two GT shapes: K2's 1e-5 an acceleration, 20 times
# over, against each output's largest value
PLAIN_SUBSTEPS, LEAPFROG_RTOL = 20, 20 * K2_RTOL
PLAIN_SHAPES = ((4, N), (B, N), (BIG_B, BIG_N))
# GT datagen seconds, both ways: the two paths' GT, the evaluation's T=1000,
# one sim at N=4096 and N=7264, the two sides of simulate's rule at B=1, and
# the reference default's training GT
DATAGEN_SHAPES = ((B, N, SUBSTEPS), (BIG_B, BIG_N, BIG_SUBSTEPS), (B, N, 10000),
                  (1, 4096, 200), (1, 7264, 200), (64, 5, 10000))
# GT through the loop of K2 launches: above the integrator's shared-memory
# limit, and at the largest N that fits, where simulate's rule takes the loop
FAR_B, FAR_N, FAR_RULE_N, FAR_SUBSTEPS = 1, 8192, 7264, 20
# K1 and K3: the kernels sum products and means in another order than cuBLAS / torch
K1_RTOL, K1_ATOL = 1e-4, 1e-5
# their bf16 forms: the kernels round where the plain versions round, but an f32
# sum taken in another order (or elem_bf16's approximate h2exp / h2rcp) can move
# an intermediate across a bf16 rounding boundary, one bf16 ulp being 2**-8
# relative; so 1e-2 of the largest value, for agg (bf16) and trans (f32) alike
BF16_RTOL, BF16_ATOL = 1e-2, 1e-5
# the f32 K1 / K3 times of the edge stage with its f32 FMA products (commit
# 8a96933, the mean of two runs of edge_phases.py beside this code's in one
# call on an NVIDIA H100 80GB HBM3, 700.00 W), printed with this run's
PARENT_8A96933_K1_MS, PARENT_8A96933_K3_MS = 1.4476, 4.4767
# the bf16 forms' times before their chunk was laid out for the H100 (commit
# e8e28ee, the mean of two runs of edge_phases.py beside this code's in one call
# on an NVIDIA H100 80GB HBM3, 700.00 W), printed with this run's
PARENT_E8E28EE_K1_BF16_MS = 0.5721
PARENT_E8E28EE_K3_BF16_MS = 1.6705
PARENT_E8E28EE_K3_ELEM_MS = 1.7826
# an edge form's error against the plain version in float64, per output (max
# abs error over max |reference|), may be at most this times its plain
# version's in the same dtype on the same inputs (TF32 off): the f32 forms'
# tensor-core product must keep f32's accuracy, the bf16 forms may round no
# worse than the bf16 plain version
F64_RATIO_MAX = 2.0
# the silus of the edge stage, per edge row: m1, m2 and the Wc1 epilogue's, 128
# each; two special-function operations each (ex2, rcp), 16 a clock an SM
SILUS_PER_ROW, SFU_OPS_PER_SILU, SFU_PER_CLOCK = 3 * 128, 2, 16
# the silu's worst relative error against float64 must stay a tenth of K1_RTOL
SILU_RTOL = K1_RTOL / 10
# hA and hB scaled so that pre-activations pass expf's overflow at -88
BIG_PRE = 100.0

# the trainer: the N=100 study run that made the committed checkpoint (README
# of docs/results/fidelity_n100, section 3: B=16, sim_length 2500, T=250),
# resumed from it for two epochs of 20 steps, then scored over 249 frames.
# It resumes from a copy in its temporary directory: a resumed run links
# itself into the checkpoint's folder (``restoring/``), which is in the tree
STUDY_ARGV = ["--dataloader.batch_size", "16",
              "--dataloader.gravity_dataset.num_atoms", "100",
              "--dataloader.gravity_dataset.sim_length", "2500",
              "--trainer.steps_per_epoch", "20", "--trainer.train_steps", "32",
              "--trainer.save_model_every", "1", "--trainer.test_macros_every", "1000",
              "--trainer.self_feed_limit_steps", "249", "--dataloader.seed", "0",
              "--trainer.run_name", "study_n100"]
STUDY_EPOCHS, STUDY_STEPS = 2, 20
# the reference default (default_config.yaml: N=5, B=64, sim_length 10000) from
# a fresh initialisation: 5 epochs of 10 steps
N5_ARGV = ["--trainer.steps_per_epoch", "10", "--trainer.train_steps", "5",
           "--trainer.save_model_every", "5", "--trainer.test_macros_every", "1000",
           "--trainer.seed", "0", "--dataloader.seed", "0", "--trainer.run_name", "n5"]
N5_EPOCHS, N5_STEPS = 5, 10
# [orbax]: [train]'s study run resumed for one epoch of 4 steps with
# checkpoint_backend orbax, then rolled out from its model.orbax through
# load_run for ORBAX_ROLLOUT_STEPS frames
ORBAX_ARGV = list(STUDY_ARGV) + ["--trainer.checkpoint_backend", "orbax"]
for _flag, _value in (("--trainer.steps_per_epoch", "4"), ("--trainer.train_steps", "31"),
                      ("--trainer.run_name", "study_orbax")):
    ORBAX_ARGV[ORBAX_ARGV.index(_flag) + 1] = _value
ORBAX_ROLLOUT_STEPS = 20
# one training step on the card (f32) against the same step on the CPU in
# float64, from the checkpoint's parameters and AdamW state, on the first
# TRAIN_CMP_B sims of one batch.  The parameters after the step: each tensor
# within 1e-4 of its largest value (f32 holds 6e-8; the f32 gradient's error,
# ~1e-5 relative through 6 layers of 100-sender sums, enters the update at
# the learning rate, ~2.6e-4 at count 30000).  The update itself (parameters
# after minus before): within 2e-2 of each tensor's largest update, the f32
# rounding of the parameters being up to ~2.4e-3 of an update of 2.6e-4 x
# the ratio of Adam's moments.
TRAIN_CMP_B, TRAIN_PARAM_RTOL, TRAIN_UPDATE_RTOL = 4, 1e-4, 2e-2
# a tensor no output reads (GMN's last node model) gets a zero gradient and
# moves by its weight decay alone, ~1e-12 of itself a step: below 1e-10 of
# the parameter on the CPU in float64, and invisible in float32, where its
# card update is held within two float32 ulps of the parameter
DECAY_ONLY_RTOL, F32_ULP = 1e-10, 2.0**-23
# the host's cost of a launch, by PROBE_LAUNCHES tiny elementwise ops
PROBE_LAUNCHES = 2000
TIMED_STEPS = 10

# the evaluation layer.  The GT-vs-GT floors at the committed protocols
# (docs/results/fidelity_n100/README.md sections 1, 2 and 4): tag -> (B, N,
# sim_length, batches, the committed six-macro floor); under the null a median
# combined p of the pairs below 0.05 means the datagen or the scoring is broken
FIDELITY = os.path.join(REPO, "docs", "results", "fidelity_n100")
FLOORS = {"floor-n100": (16, 100, 2500, 8, "gtgt_n100_sixbasis_baseline_metamacros.json"),
          "floor-n512": (8, 512, 1000, 6, "gtgt_n512_sixbasis_baseline_metamacros.json")}
FLOOR_SEED, FLOOR_MEDIAN_MIN = 0, 0.05
# the battery of the committed checkpoint (README section 3's first seed)
BATTERY_DRAWS, BATTERY_SEED = 3, 281  # 3 of the committed battery's 6 draws
# a full-bf16 scene (scene and parameters in bf16, the JAX package's
# pallas-bf16-t64 config): steps through K1-bf16 at (B, N) and K3-bf16 at
# (BIG_B, BIG_N)
FULL_BF16_STEPS, FULL_BF16_BIG_STEPS = 20, 3
# the figures of a card rollout, drawn on the host: the phase's limit
VIZ_MAX_S = 10.0
VALIDATE_BATCHES = 2
# ks-test ranks [train]'s checkpoint from the JSONs [train] scored: the same
# p-values, combined in another order
KS_RTOL = 1e-12
INF_STEPS = 20
# HPO at the reference default: trials of one epoch of 10 steps, 20-step evaluations
HPO_TRIALS, HPO_EVAL_STEPS = 2, 20
# the research loop through `python -m <package>.tools.pipeline` at the root
# config.yaml (EGNN-MC 6 x 128, N=5, B=64, sim_length 10000), fresh: 2 epochs
# of PIPE_STEPS steps, a checkpoint and an evaluation of PIPE_EVAL_STEPS frames
# an epoch (the evaluation's 999 steps cut for the smoke's time), a 1-draw
# battery at the top checkpoint; each tool a process of its own
PIPE_STEPS, PIPE_EVAL_STEPS, PIPE_SEED, PIPE_TIMEOUT = 10, 100, 281, 300
PIPE_ARGV = ["--model", "egnn_mc", "--epochs", "2", "--ckpt-interval", "1",
             "--min-checkpoints", "2", "--draws", "1", "--top-k", "1",
             "--draw-seed", str(PIPE_SEED), "--deadline-hours", "0.05", "--poll-s", "5",
             "-o", f"trainer.steps_per_epoch={PIPE_STEPS}", "-o", "trainer.test_macros_every=1",
             "-o", "trainer.save_model_every=1",
             "-o", f"trainer.self_feed_limit_steps={PIPE_EVAL_STEPS}",
             "-o", "trainer.seed=0", "-o", "dataloader.seed=0"]
PIPE_ROW = "pipeline_egnn_mc"

# PONITA at the width of its committed 10M run (h480, 20 orientations;
# scripts/queues/tpu_queue48.sh:63-64 trained it at L5) and depth 2 (cut to
# give the smoke's time to the later families; the checkpoint stays out of
# the copy sent to the card), from a fresh initialisation made from a seed
# and calibrated on its first batch, at the reference workload (N=5, B=64,
# sim_length 10000: T=1000, 999 rollout steps)
PONITA_KW = dict(num_layers=2, hidden_features=480)
PONITA_ARGV = ["--main.model_type", "ponita", "--model.num_layers", "2",
               "--model.hidden_features", "480"]
PONITA_PARAMS = 4_075_946  # 4,075,940 parameters and 6 calibration statistics
PONITA_B, PONITA_N, PONITA_SUBSTEPS = 64, 5, 10000
PONITA_SEED = 12
# the card's f32 forward against the CPU's float64 one: layers of f32 sums
# (over 4 senders, 480 and 1920 channels, 20 orientations) hold ~1e-6 of the
# largest output; 1e-4 of it is the gate.  The calibration's statistics:
# 1e-5 relative (population stds of f32 tensors of 3-15M elements)
PONITA_FWD_RTOL, PONITA_CALIB_RTOL = 1e-4, 1e-5
# the card's 20 closed-loop steps against the CPU's float64 ones, on the first
# PONITA_CMP_B sims: within 1e-3 of the largest position, or 100 times the
# spread a 1e-7 nudge of frame 0 gives the CPU alone where that is larger
PONITA_CMP_B, PONITA_ROLL_RTOL, PONITA_NUDGE_FACTOR = 4, 1e-3, 100.0
# the families' training phases: 2 epochs of 20 steps (cut from 1000 steps an
# epoch), their evaluation cut to 100 steps (the smoke's depth; the queue
# rolls 999), and a second run of 10 steps: fresh after a resumed run,
# resumed from the checkpoint it wrote after a fresh one (its first batch
# drawn from another dataloader seed, so that a calibration run again on it
# would show)
FAMILY_TRAIN_EPOCHS, FAMILY_TRAIN_STEPS, FAMILY_AFTER_STEPS = 2, 20, 10
FAMILY_EVAL_FRAMES = 101
RESUME_DATA_SEED = 1
# the families' rollout phases roll 100 steps and repeat them bitwise; the
# batteries roll the reference's 999
REPEAT_FRAMES = 101
# a PONITA battery of one draw on the fresh run's run dir
PONITA_DRAWS = 1
PONITA_FRAMES = PONITA_SUBSTEPS // SAMPLE_FREQ

# SEGNN at the width of its committed 10M run (w448, lmax 1, hidden irreps
# 224x0e+224x1o; the queue step scripts/queues/tpu_queue48.sh:55-56 trained
# it at L6) and depth 2, from a fresh initialisation made from a seed, at
# the reference workload (N=5, B=64, sim_length 10000: T=1000, 999 rollout
# steps, num_neighbors 4).  The committed checkpoint stays out of the copy
# sent to the card (GraphTransformer's takes its room), and depth 2 gives
# the smoke's time to the later families; the CPU tests hold the committed
# checkpoint against the JAX package
SEGNN_KW = dict(num_layers=2, hidden_features=448)
SEGNN_ARGV = ["--main.model_type", "segnn", "--model.num_layers", "2",
              "--model.hidden_features", "448"]
SEGNN_PARAMS = 3_721_760
SEGNN_B, SEGNN_N, SEGNN_SUBSTEPS = 64, 5, 10000
SEGNN_FRAMES = SEGNN_SUBSTEPS // SAMPLE_FREQ
SEGNN_SEED = 13
# the card's f32 forward against the CPU's float64 one: layers of f32 sums
# (contractions up to 898 long, 4 senders) hold ~1e-6 of the largest output;
# 1e-5 of it is the gate.  O(3): the center_mode "nodes" model on a scene
# turned with a reflection and shifted, against its outputs turned the same
# way, two f32 forwards each ~1e-6 from exact: 1e-4 of the largest output
SEGNN_FWD_RTOL, SEGNN_EQUIV_RTOL = 1e-5, 1e-4
# the card's 20 closed-loop steps against the CPU's float64 ones, on the
# first SEGNN_CMP_B sims: within 1e-4 of the largest position, or 100 times
# the spread a 1e-7 nudge of frame 0 gives the CPU alone where that is larger
SEGNN_CMP_B, SEGNN_ROLL_RTOL, SEGNN_NUDGE_FACTOR = 4, 1e-4, 100.0
# the battery: seed 281, 1 draw of [train-segnn]'s checkpoint
SEGNN_DRAWS = 1

# EquiformerV2: the committed 10M checkpoint (L8 c128, 8 heads, lmax 2,
# mmax 1, epoch 130), trained by the queue step
# scripts/queues/tpu_queue44.sh:38-48 at the reference workload (N=5, B=64,
# sim_length 10000, fully connected), with live dropout (alpha_drop 0.1,
# drop_path_rate 0.05) in training and in its rollouts
EQV2_KW = dict(num_layers=8, sphere_channels=128, attn_hidden_channels=128,
               ffn_hidden_channels=128, num_heads=8, remat=True)
EQV2_PARAMS = 9_689_010
EQV2_B, EQV2_N, EQV2_SUBSTEPS = 64, 5, 10000
EQV2_FRAMES = EQV2_SUBSTEPS // SAMPLE_FREQ
EQV2_EPOCH, EQV2_COUNT = 130, 130000  # the checkpoint's epoch and AdamW count
EQV2_DROPOUT_SEED = 281
# the card's f32 forward against the CPU's float64 one (8 blocks of f32 sums,
# the grid's 648-point sums among them): 1e-4 of the largest output.  A
# permutation of the bodies: the same sums in other batch positions, 1e-5.
# A rotation of a fresh model with the equivariant velocity gate: the SiLU on
# the 18 x 36 grid aliases the frequencies above lmax, so the model is
# equivariant only that far, in float64 too (tests/test_torch_eqv2_model.py
# holds that to 1e-4); 2e-4, the JAX package's own test's tolerance
EQV2_FWD_RTOL, EQV2_PERM_RTOL, EQV2_ROT_RTOL = 1e-4, 1e-5, 2e-4
EQV2_FRESH_SEED = 34
# 20 eval-mode closed-loop steps against the CPU's float64 ones, on the first
# EQV2_CMP_B sims: 1e-3 of the largest position, or 100 times a 1e-7 nudge's
# spread where that is larger
EQV2_CMP_B, EQV2_ROLL_RTOL, EQV2_NUDGE_FACTOR = 4, 1e-3, 100.0
EQV2_DRAWS = 1
# the two param_small trials of the study (seed 0): the sampled trials'
# widths and counts as the JAX package's adjust_width_to_target gives them
# (tests/test_torch_eqv2_train.py holds these against it).  The bisection
# steps by 16 and stops outside the 7% band of 1,800,000 for both; the study
# goes on with them, as the JAX package's does
EQV2_HPO_WANT = (
    (dict(num_layers=8, num_heads=4, sphere_channels=48, attn_hidden_channels=48,
          ffn_hidden_channels=48), 2_379_506),
    (dict(num_layers=6, num_heads=8, sphere_channels=48, attn_hidden_channels=48,
          ffn_hidden_channels=48), 2_040_738))
# the forward's bounds: f32 operations at the card's peak, and the bytes an
# eager forward moves through its S2 grids (each grid written and read twice:
# the product into the grid, the SiLU, the product out of it)
EQV2_GRID_PASSES = 4

# GraphTransformer: the committed 10M checkpoint (L8 h248, 8 heads of 31,
# feed-forward 2048, epoch 130), trained by the queue step
# scripts/queues/tpu_queue48.sh:58-60 at the reference workload (N=5, B=64,
# sim_length 10000, full attention), with live dropout (0.1) in training and
# in its rollouts
GT_KW = dict(num_layers=8, hidden_features=248, num_heads=8)
GT_PARAMS = 10_255_566
GT_B, GT_N, GT_SUBSTEPS = 64, 5, 10000
GT_FRAMES = GT_SUBSTEPS // SAMPLE_FREQ
GT_EPOCH, GT_COUNT = 130, 130000  # the checkpoint's epoch and AdamW count
GT_DROPOUT_SEED = 281
# the card's f32 forward against the CPU's float64 one (8 layers of f32
# sums up to 2048 long, softmaxes, LayerNorms): 1e-4 of the largest output.
# A permutation of the bodies: the same sums in other positions, 1e-5
GT_FWD_RTOL, GT_PERM_RTOL = 1e-4, 1e-5
# 20 eval-mode closed-loop steps against the CPU's float64 ones, on the
# first GT_CMP_B sims: 1e-3 of the largest position, or 100 times a 1e-7
# nudge's spread where that is larger
GT_CMP_B, GT_ROLL_RTOL, GT_NUDGE_FACTOR = 4, 1e-3, 100.0
GT_DRAWS = 1
# the key projections' biases get no gradient in exact arithmetic (the
# softmax over keys ignores what they add to a query's every logit): in
# float64 their gradient is rounding noise, ~1e-16 of their kernels' (a CPU
# rehearsal of the committed checkpoint: 2.6e-17 to 3.0e-16)
GT_KEY_BIAS_GRAD_RTOL = 1e-10

# PaiNN at the width of its stability run (docs/results/painn_stab_v5e/
# run_config.yaml: H192, 64 RBF, cutoff 10, the stability toggles and
# gradient clipping by norm 1.0; no checkpoint is committed) and depth 2 (the
# run's 6 cut to give the smoke's time to CGENN and GMN, as PONITA's and
# SEGNN's were), from a fresh initialisation made from a seed, at the
# reference workload (N=5, B=64, sim_length 10000, num_neighbors 4)
PAINN_TOGGLES = dict(residual_scale_interaction=0.5, tanh_message_scale=5.0, filter_gain=0.5,
                     clip_vector_msg_norm=10.0, clip_scalar_msg_value=10.0,
                     residual_scale_mixing=0.5, tanh_mixing_scale=5.0, clip_mu_norm=20.0,
                     clip_q_value=100.0)
PAINN_KW = dict(hidden_features=192, num_layers=2, num_rbf=64, cutoff=10.0, **PAINN_TOGGLES)
PAINN_ARGV = (["--main.model_type", "painn", "--model.num_layers", "2",
               "--trainer.clip_gradients_norm", "1.0"]
              + [a for k, v in PAINN_TOGGLES.items() for a in (f"--model.{k}", str(v))])
PAINN_PARAMS = 2_687_616
PAINN_SEED = 14
# the card's f32 forward against the CPU's float64 one (2 layers of f32 sums
# over 4 senders, 576 channels): 1e-4 of the largest output.  Rotation,
# translation and permutation of the scene: two f32 forwards, each ~1e-6
# from exact, 1e-4 of the largest output
PAINN_FWD_RTOL, PAINN_EQUIV_RTOL = 1e-4, 1e-4
PAINN_CMP_B, PAINN_ROLL_RTOL, PAINN_NUDGE_FACTOR = 4, 1e-3, 100.0

# the two param_small trials of the GraphTransformer study (seed 0): the
# sampled trials' widths and counts as the JAX package's
# adjust_width_to_target gives them (tests/test_torch_gt_train.py holds these
# against it); the second stops outside the 7% band of 1,800,000, its
# feed-forward's 2048 setting the count at width 64, and the study goes on
# with it, as the JAX package's does
GT_HPO_WANT = ((dict(hidden_features=64, num_layers=6, num_heads=8), 1_696_070),
               (dict(hidden_features=64, num_layers=8, num_heads=4), 2_258_374))

# the reference workload of the fresh families' paths (PaiNN's, CGENN's and
# GMN's): N=5, B=64, sim_length 10000
REF_B, REF_N, REF_SUBSTEPS = 64, 5, 10000

# CGENN at its 10M run's shape (docs/results/cgenn_10m_L6h176_cont: L6 h176,
# remat; scripts/queues/tpu_queue39.sh:58-67; no checkpoint is committed),
# from a fresh initialisation made from a seed, at the reference workload
CGENN_KW = dict(hidden_features=176, num_layers=6, remat=True)
CGENN_ARGV = ["--main.model_type", "cgenn", "--model.num_layers", "6",
              "--model.hidden_features", "176", "--model.remat", "true"]
CGENN_PARAMS = 9_814_466
CGENN_SEED = 15
# the card's f32 forward against the CPU's float64 one: 1e-4 of the largest
# output.  CGENN is near-equivariant only (its algebra's signature is the
# frozen metric's eigenvalues), so the rotated scene's output on the card is
# held against the CPU's float64 output at the same rotated scene, within the
# same 1e-4; translation and permutation as PaiNN's
CGENN_FWD_RTOL, CGENN_EQUIV_RTOL = 1e-4, 1e-4
CGENN_CMP_B, CGENN_ROLL_RTOL, CGENN_NUDGE_FACTOR = 4, 1e-3, 100.0
# [cgenn-rollout]'s own fresh model: the 10M shape at depth 2 (the L6 model's
# 28 s rollout cut for the smoke's time; its gates as they were)
CGENN_ROLL_KW = dict(CGENN_KW, num_layers=2)
CGENN_ROLL_PARAMS = 3_272_898
# the tensors a fresh CGENN starts at zero: the gates' biases, the product's
# normalisation logits, the linears' scalar-blade biases.  After [train-cgenn]'s
# 40 steps their values are those steps' updates alone (one update is ~5% of
# them), so [train]'s parameter gate (1e-4 of the largest value) would hold
# their one-step update to ~2e-3 of itself, tighter than the 2e-2 every
# tensor's update meets; float32 rounds the model's small gradient elements
# as the JAX model's float32 does (tests/test_torch_cgenn_model.py), and
# AdamW's update of each element reads its gradient relative to its own size.
# They are held by the update gate
CGENN_ZERO_INIT = (".b", "._Normalization_0.a", ".bias")
# the two param_small trials of the CGENN study (seed 0): the widths and counts
# of the JAX package's adjust_width_to_target (tests/test_torch_cgenn_train.py
# holds these against it)
CGENN_HPO_WANT = ((dict(hidden_features=80, num_layers=5), 1_720_962),
                  (dict(hidden_features=64, num_layers=8), 1_776_386))

# GMN at its defaults (h64, L4, 5 isolated bodies), fresh from a seed
GMN_KW = dict(hidden_features=64, num_layers=4, n_isolated=5, n_stick=0, n_hinge=0)
GMN_ARGV = ["--main.model_type", "gmn"]
GMN_PARAMS = 150_212
GMN_SEED = 16
# rotation is exact for GMN: the card's output at the rotated scene against
# the card's output turned, within 1e-4 of the largest output
GMN_FWD_RTOL, GMN_EQUIV_RTOL = 1e-4, 1e-4
GMN_CMP_B, GMN_ROLL_RTOL, GMN_NUDGE_FACTOR = 4, 1e-3, 100.0
# the stick and hinge compositions, one forward each on a seeded scene against
# the CPU's float64 (GMN trains on the offline data's sticks and hinges in
# [train-offline-gmn])
GMN_COMPOSITIONS = ((1, 2, 0), (0, 0, 2))

# the legacy sims at their defaults: 64 sims of 5 balls, 10000 Euler steps, a
# frame every 10 (999 frames); the first LEGACY_CMP_FRAMES frames on the card
# against the CPU's float64 from the same initial arrays
LEGACY_S, LEGACY_N, LEGACY_T, LEGACY_FREQ, LEGACY_CMP_FRAMES = 64, 5, 10000, 10, 5
# the offline charged systems at the JAX package's datagen defaults (100 / 20 /
# 20 sims, 5000 Euler steps of 0.001, a frame every 100, seed 42):
# segnn_nbody_offline's default 5_0_0 (config.yaml:100-107) and 3_2_1, every
# object kind in one system (N = 10)
OFFLINE_SETS = ((5, 0, 0), (3, 2, 1))
OFFLINE_SIMS, OFFLINE_T, OFFLINE_FREQ, OFFLINE_SEED = (100, 20, 20), 5000, 100, 42
OFFLINE_CMP_FRAMES = 3
# the repeat: the first OFFLINE_REPEAT_FRAMES frames (1000 steps) made again
# from the same draws, at the generator's shapes (all three splits in one
# loop), bitwise equal to the files'.  A split's loop is bound by the host's
# launches, not by its sims, so steps are what the repeat costs
OFFLINE_REPEAT_FRAMES = 10
# charged bodies meet closely and the force cap is 0.1 / dt, so a float32 run
# leaves float64 fast (CPU, 3_2_1: 3e-5 of the largest position after 3 frames,
# 1e-2 after 10).  The card's first frames (float32) against the CPU's float64
# from the same arrays: within INTEGRATOR_F32_FACTOR times the CPU float32's
# error from those arrays, or INTEGRATOR_ATOL_REL of the largest value.  Over
# all the frames the constraints are held instead, on the valid split's sims
# (OFFLINE_DRIFT_SPLIT): stick and hinge-beam lengths within CONSTRAINT_FACTOR
# times the CPU float32's drift over the same steps from the same arrays
# (1.2e-4 relative over 5000 steps on the CPU), edges exactly q q^T
INTEGRATOR_F32_FACTOR, INTEGRATOR_ATOL_REL, CONSTRAINT_FACTOR = 10.0, 1e-5, 10.0
OFFLINE_DRIFT_SPLIT = "valid"
# launches a step: torch.profiler's kernel count of a run of this many more
# steps than another, over the difference (the set-up and the frames' saves
# cancel)
LAUNCH_COUNT_STEPS = 20
# training on them through `cli train --main.dataloader_type
# segnn_nbody_offline` (config.yaml:100-107: B=64, frame_0 30, frame_T 40), 2
# epochs of 20 steps, validation on the valid split, a resume of 10 steps.
# tag -> (model argv, dataset, cutoff rate): SEGNN at config.yaml:36-40, the
# dataloader's own model (h96, lmax 1) at depth 6, its 20 layers cut: at L20
# its 2 x 20 steps took 17 s of a smoke that took 682 s on an NVIDIA H100
# 80GB HBM3, 700.00 W, past the 600 s failure line; 6 is the depth of its
# committed 10M run; EGNN-MC at its bench width on cutoff-rate masks,
# validated through K1; GMN at its defaults on 3_2_1
OFFLINE_SEGNN_LAYERS = 6
OFFLINE_TRAIN = {
    "segnn": (["--main.model_type", "segnn", "--model.hidden_features", "96",
               "--model.lmax_attr", "1", "--model.lmax_h", "1", "--model.num_layers",
               str(OFFLINE_SEGNN_LAYERS)], "5_0_0", 0.0),
    "egnn": (["--main.model_type", "egnn_mc", "--model.num_layers", "6",
              "--model.hidden_node_dim", "128", "--model.hidden_edge_dim", "128",
              "--model.hidden_coord_dim", "128"], "5_0_0", 0.3),
    "gmn": (["--main.model_type", "gmn", "--model.n_isolated", "3", "--model.n_stick", "2",
             "--model.n_hinge", "1"], "3_2_1", 0.0),
}
OFFLINE_EPOCHS, OFFLINE_STEPS, OFFLINE_RESUME_STEPS, OFFLINE_VALID_BATCHES = 2, 20, 10, 10

# H100 SXM peaks (NVIDIA data sheet): f32 on CUDA cores, dense bf16 and TF32 on
# the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
K2_FLOPS_PER_PAIR = 20  # 3 sub, 6 for r2 + eps^2, rsqrt, 3 for inv^3 * m, 3 FMA
# the multi-GPU paths: gloo ranks that share the one card (NCCL puts one rank
# on a card, and the machine has one).  [dp-train]: `cli train` on DP_RANKS
# ranks at [train]'s study settings (N=100) with B=64 (32 a rank), resumed
# from the committed checkpoint for DP_STEPS steps and one evaluation of
# DP_FRAMES frames (the GT cache, the trajectory files and the extended
# artifacts off: the CPU tests hold the cache's one writer, [train] the rest)
DP_RANKS, DP_B, DP_STEPS, DP_FRAMES = 2, 64, 4, 21
DP_ARGV = ["--dataloader.batch_size", str(DP_B),
           "--dataloader.gravity_dataset.num_atoms", "100",
           "--dataloader.gravity_dataset.sim_length", "2500", "--dataloader.seed", "0",
           "--dataloader.cache_data", "false", "--trainer.steps_per_epoch", str(DP_STEPS),
           "--trainer.train_steps", "31", "--trainer.save_model_every", "1",
           "--trainer.test_macros_every", "1", "--trainer.self_feed_limit_steps", str(DP_FRAMES),
           "--trainer.save_trajectory_npys", "false", "--trainer.plot_macros", "false",
           "--trainer.run_name", "dp"]
# [ring]: RING_RANKS ranks on a (sim, body) = (2, 2) mesh at [bign-rollout]'s
# workload (B=8, N=512: 4 sims and 256 bodies a rank), RING_STEPS steps
RING_RANKS, RING_BODY, RING_STEPS = 4, 2, 20
# [ring]'s training steps (shard_bodies=True) in the same ranks: a GT batch of
# RING_TRAIN_B sims at N=100 (RING_TRAIN_SUBSTEPS substeps from
# RING_TRAIN_SEED), the training pair at frame RING_TRAIN_FRAME, one step on
# the fully connected mask and one on a kNN mask of RING_TRAIN_KNN.  The
# checkpoint was trained fully connected: on a much sparser mask (k=10) its
# loss runs away, AdamW's update turns into the gradient's signs, and f32
# rounding sets the signs of the gradients near 0, so the step would test
# conditioning, not the sharding; at k=50 the step is as well conditioned
# as the fully connected one
RING_TRAIN_B, RING_TRAIN_SUBSTEPS, RING_TRAIN_FRAME = 8, 200, 5
RING_TRAIN_KNN, RING_TRAIN_SEED = 50, 65
RING_TRAIN_CASES = (("fc", N - 1), ("knn", RING_TRAIN_KNN))
# a rank that has not finished by then fails its phase (and each group's
# collectives time out after it too)
RANK_TIMEOUT_S = 300.0
# a sharded rollout against the single-process one: at every step within
# YARDSTICK times the spread that a 1e-7 relative nudge of frame 0 gives the
# single-process rollout, or K1's tolerance of the largest position where that
# is larger (a closed loop amplifies last-bit differences, [rollout]'s reading)
YARDSTICK = 10.0
T_START = time.perf_counter()


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def report(phase: str, t0: float, seconds=None, **info) -> None:
    """One phase's line: its seconds (since ``t0`` unless given) and results."""
    seconds = time.perf_counter() - t0 if seconds is None else seconds
    items = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{phase}] ok {seconds:.2f} s {items}", flush=True)


def bound_ms(n_bytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def eqv2_forward_cost(model, bb: int, nn_: int):
    """``(operations, grid bytes)`` of one eval-mode EquiformerV2 forward
    (lmax 2, mmax 1, separable S2 activations, per-block atom-edge
    embeddings) at ``bb`` sims of ``nn_`` bodies, every pair an edge row as
    the dense model computes it.  Multiply-adds count 2.  The grid bytes are
    the f32 S2 grids an eager forward writes and reads EQV2_GRID_PASSES
    times: ``[E, 648, hidden]`` a block's attention and the head's,
    ``[B N, 648, ffn]`` a block's feed-forward."""
    kw = model.init_kwargs
    C, H, F = kw["sphere_channels"], kw["attn_hidden_channels"], kw["ffn_hidden_channels"]
    heads, A, V = kw["num_heads"], kw["attn_alpha_channels"], kw["attn_value_channels"]
    Ce, L, G = kw["edge_channels"], kw["num_layers"], 648
    E, Nn, HV = bb * nn_ * nn_, bb * nn_, heads * kw["attn_value_channels"]
    edge_in = 1024 + 2 * Ce
    attn_edge = (7 * 9 * 2 * C  # rotate the message [x_s, x_r]
                 + edge_in * Ce + Ce * Ce + Ce * 10 * C  # the radial MLP
                 + 6 * C * (3 * H + heads * A + H) + 2 * 4 * C * 4 * H  # SO2Conv_0
                 + 2 * 7 * G * H  # the S2 activation's grid round trip
                 + 3 * H * 3 * HV + 2 * 2 * H * 4 * HV  # SO2Conv_1
                 + heads * A + 9 * 7 * HV)  # the alpha dot, the rotation back
    ffn_node = C * F + 9 * C * F + 2 * 9 * G * F + 9 * F * C
    input_edge = 1024 + edge_in * Ce + Ce * Ce + Ce * 3 * C + 9 * 3 * C
    macs = (E * ((L + 1) * attn_edge + input_edge)
            + Nn * (L * (9 * HV * C + ffn_node) + 9 * HV * 2 + 3 * 3 * C))
    grid = 4.0 * EQV2_GRID_PASSES * G * ((L + 1) * E * H + L * Nn * F)
    return 2.0 * macs, grid


def cgenn_forward_flops(C: int, L: int, bb: int, nn_: int) -> float:
    """The operations of one CGENN forward (multiply-adds count 2) at ``bb``
    sims of ``nn_`` bodies, every pair an edge row as the dense model computes
    it: per layer two Clifford MLP sublayers on the edge rows and two on the
    node rows (the node MLP's first reads ``2 C`` channels), each an
    ``MVLinear`` (8 blades of an ``in x C`` product), the product's two
    ``MVLinear``s and its two-step contraction (``C x 8 x 64``, then ``C x
    64`` a row); the embedding and the readout.  The gates and norms
    (elementwise, ~2% more) are left out."""
    e_rows, n_rows = bb * nn_ * nn_, bb * nn_

    def sublayer(rows: int, c_in: int) -> int:
        return rows * C * (8 * (c_in + 2 * C) + 8 * 64 + 64)

    macs = (L * (2 * sublayer(e_rows, C) + sublayer(n_rows, 2 * C) + sublayer(n_rows, C))
            + n_rows * C * 3 * 8 + n_rows * 2 * C * 8)
    return 2.0 * macs


def tp_flops(tp) -> float:
    """The operations of one row of a steerable tensor product (multiply-adds
    count 2), over its paths: the CG tensor with the second input, then the
    first input, then the weights."""
    ir1, ir2, ir3 = tp.irreps_in1, tp.irreps_in2, tp.irreps_out
    macs = 0
    for a, b, c in tp.paths:
        (m1, (l1, _)), (m2, (l2, _)), (m3, (l3, _)) = ir1.items[a], ir2.items[b], ir3.items[c]
        d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
        macs += m1 * m2 * m3 * d3 + m1 * m2 * d1 * d2 * d3
    return 2.0 * macs


def _kernel_counters(mods) -> dict:
    """Every kernel form's launch counter: name -> (wrapper, attribute)."""
    EM, ES, gravity = mods
    return {"k1": (EM.fused_egnn_messages, "launches"),
            "k1_bf16": (EM.fused_egnn_messages, "launches_bf16"),
            "k2": (gravity.acceleration, "launches"), "leapfrog": (gravity.leapfrog, "launches"),
            "k3": (ES.streaming_egnn_messages, "launches"),
            "k3_bf16": (ES.streaming_egnn_messages, "launches_bf16"),
            "k3_elem": (ES.streaming_egnn_messages, "launches_elem")}


def _kernel_counts(mods) -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _kernel_counters(mods).items()}


def _host_copies_only() -> dict:
    """Wrap this process's gloo collectives to count the tensors they are
    handed and those of them on the card (gloo moves host memory: the
    port's collectives hand it host copies, by backend)."""
    import torch.distributed as dist

    seen = {"collectives": 0, "tensors": 0, "on_card": 0}

    def note(tensors):
        seen["collectives"] += 1
        for t in tensors:
            seen["tensors"] += 1
            seen["on_card"] += t.device.type != "cpu"

    def wrap(name, tensors_of):
        fn = getattr(dist, name)

        def wrapped(*a, **k):
            note(tensors_of(*a, **k))
            return fn(*a, **k)
        setattr(dist, name, wrapped)

    wrap("all_reduce", lambda t, *a, **k: [t])
    wrap("broadcast", lambda t, *a, **k: [t])
    wrap("all_gather", lambda parts, t, *a, **k: [*parts, t])
    wrap("batch_isend_irecv", lambda ops: [op.tensor for op in ops])
    return seen


def _rank_setup():
    """A rank's card and flags (``main``'s), and its kernel wrappers' modules."""
    import importlib

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    mods = tuple(importlib.import_module(f"{PKG}.{m}")
                 for m in ("ops.egnn_messages", "ops.egnn_stream", "ops.gravity"))
    importlib.import_module(f"{PKG}.ops._build").kernels()  # built by the parent: loads
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.empty(0, device=dev)  # the rank's context, before its memory statistics
    return dev, mods


def _dp_rank(rank: int, argv, root: str) -> dict:
    """A [dp-train] rank: ``cli.train_main(argv)`` in ``<root>/rank<r>``,
    recording its first GT batch (its rows), each step's batch (the first),
    parameters and ms, each gradient all_reduce's ms, and the evaluation
    rollout's scene, parameters and gathered trajectories."""
    t_enter = time.time()
    import importlib

    import torch

    dev, mods = _rank_setup()
    wire = _host_copies_only()
    cli = importlib.import_module(f"{PKG}.cli")
    trainer_mod = importlib.import_module(f"{PKG}.train.trainer")
    sharded = importlib.import_module(f"{PKG}.parallel.sharded")
    self_feed = importlib.import_module(f"{PKG}.rollout.self_feed")
    otf = importlib.import_module(f"{PKG}.data.gravity_otf")
    cwd = os.path.join(root, f"rank{rank}")
    os.makedirs(cwd)
    os.chdir(cwd)
    rec = {"gt": None, "steps": [], "step_ms": [], "reduce_ms": [], "eval": None,
           "marks": {"enter": t_enter}}

    def sync():
        torch.cuda.synchronize(dev)

    generate = otf.GravityDatasetOtf.generate_trajectories

    def first_gt(self, bs):
        out = generate(self, bs)
        if rec["gt"] is None:
            rec["gt"] = {k: v.cpu() for k, v in out.items()}
        return out

    make_step = trainer_mod.make_sharded_train_step

    def make_timed(model, *a, **k):
        step, names = make_step(model, *a, **k)

        def timed(scene, y, mask=None):
            sync()
            rec["marks"].setdefault("first_step", time.time())
            t = time.perf_counter()
            vec = step(scene, y, mask)
            sync()
            rec["step_ms"].append((time.perf_counter() - t) * 1e3)
            rec["steps"].append({
                "batch": None if rec["steps"] else tuple(
                    x.cpu() for x in (scene.pos, scene.vel, scene.force, scene.mass, y)),
                "params": {n: p.detach().cpu().clone() for n, p in model.named_parameters()}})
            return vec
        return timed, names

    average = sharded.average_step

    def average_timed(*a, **k):
        sync()
        t = time.perf_counter()
        out = average(*a, **k)
        sync()
        rec["reduce_ms"].append((time.perf_counter() - t) * 1e3)
        return out

    sharded_rollout = self_feed.make_sharded_rollout_fn

    def sharded_rollout_rec(model, *a, **k):
        fn = sharded_rollout(model, *a, **k)

        def rollout(scene0, rng=None):
            rec["marks"]["eval_rollout"] = time.time()
            out = fn(scene0, rng)
            rec["marks"]["eval_rollout_end"] = time.time()
            rec["eval"] = {"scene0": tuple(x.cpu() for x in (scene0.pos, scene0.vel,
                                                             scene0.force, scene0.mass)),
                           "params": {n: v.cpu() for n, v in model.state_dict().items()},
                           "loc": out[0].cpu(), "vel": out[1].cpu(), "survived": out[2].cpu()}
            return out
        return rollout

    for fn, attr in _kernel_counters(mods).values():
        setattr(fn, attr, 0)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    rec["marks"]["train_main"] = time.time()
    with mock.patch.object(otf.GravityDatasetOtf, "generate_trajectories", first_gt), \
            mock.patch.object(trainer_mod, "make_sharded_train_step", make_timed), \
            mock.patch.object(sharded, "average_step", average_timed), \
            mock.patch.object(self_feed, "make_sharded_rollout_fn", sharded_rollout_rec):
        trainer = cli.train_main(argv)
    sync()
    rec["marks"]["end"] = time.time()
    rec.update(seconds=time.perf_counter() - t, counts=_kernel_counts(mods), wire=wire,
               peak_mib=torch.cuda.max_memory_allocated(dev) / 2**20,
               backend=torch.distributed.get_backend(), save_dir=trainer.save_dir_path,
               data_parallel=trainer.mesh is not None, count=trainer.optim.count,
               files=sorted(os.path.relpath(os.path.join(b, n), cwd)
                            for b, _, ns in os.walk(cwd) for n in ns))
    return rec


def _train_pair(Scene, loc, vel, force, mass):
    """[ring]'s training pair (``pos_dt+vel``) at RING_TRAIN_FRAME of a GT batch."""
    import torch

    f = RING_TRAIN_FRAME
    y = torch.cat([loc[:, f + 1] - loc[:, f], vel[:, f + 1]], dim=-1)
    return Scene(pos=loc[:, f], vel=vel[:, f], force=force[:, f], mass=mass), y


def _ring_weights(dev):
    """The weights ``w [RING_TRAIN_B, N, 6]`` of the ring's backward, ``sum(pred * w)``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(RING_TRAIN_SEED + 1)
    return torch.randn((RING_TRAIN_B, N, 6), generator=g, device=dev)


def _train_setup(model, payload):
    """An optimizer and loss for [ring]'s training steps, the default
    config's; ``load`` puts the committed checkpoint's parameters and AdamW
    state (``payload``) into the model and the optimizer, as often as a step
    needs them anew."""
    import importlib

    trainer_mod = importlib.import_module(f"{PKG}.train.trainer")
    args, _ = importlib.import_module(f"{PKG}.utils.config").parse_args([])
    optim = trainer_mod.create_optimizer(
        model.parameters(), learning_rate=args.learning_rate, model_size=model.get_model_size(),
        factor=args.learning_rate_factor, warmup=args.learning_rate_warmup_steps,
        clip_value=args.clip_gradients_value, clip_norm=args.clip_gradients_norm,
        discard_nan_gradients=args.discard_nan_gradients)
    loss_fn = importlib.import_module(f"{PKG}.train.losses").build_loss_fn(args)

    def load():
        trainer_mod.load_training_state(model, optim, payload, "egnn_mc")

    return optim, loss_fn, args.target.split("+"), load


def _timed_step(step, scene, y, dev) -> dict:
    """One step's ms, its peak MiB above its start and its loss."""
    import torch

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev)
    t = time.perf_counter()
    vec = step(scene, y)
    torch.cuda.synchronize(dev)
    return {"ms": (time.perf_counter() - t) * 1e3,
            "peak_mib": (torch.cuda.max_memory_allocated(dev) - start) / 2**20,
            "loss": float(vec[0])}


def _ring_train(dev, mods, mesh, ring_model, params) -> dict:
    """A [ring] rank's training work: its rows of a GT batch from
    sharded_datagen, the body-sharded step from the committed checkpoint on
    each of RING_TRAIN_CASES (ms, peak MiB, loss, parameters after), and its
    share of the ring model's gradient of ``sum(pred * w)``; the kernel
    launches of all of it."""
    import importlib

    import torch

    par = importlib.import_module(f"{PKG}.parallel")
    pmesh = importlib.import_module(f"{PKG}.parallel.mesh")
    models = importlib.import_module(f"{PKG}.models")
    Scene = importlib.import_module(f"{PKG}.core.scene").Scene
    before = _kernel_counts(mods)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(RING_TRAIN_SEED)
    gt = par.sharded_datagen(gen, mesh, RING_TRAIN_B, N, T=RING_TRAIN_SUBSTEPS,
                             sample_freq=SAMPLE_FREQ, params=params, device=dev)
    scene, y = _train_pair(Scene, *gt)
    body = pmesh.axis_rows(N, mesh, pmesh.BODY_AXIS)
    rows = Scene(*(t[:, body] for t in (scene.pos, scene.vel, scene.force, scene.mass)))
    out = {"gt": tuple(t.cpu() for t in gt), "steps": {}}
    marks = {"gt": time.perf_counter()}
    model = models.create_model("egnn_mc", device=dev)
    optim, loss_fn, targets, load = _train_setup(
        model, importlib.import_module(f"{PKG}.weights").read_checkpoint(CKPT))
    marks["setup"] = time.perf_counter()
    for tag, k in RING_TRAIN_CASES:
        load()
        step, _ = par.make_sharded_train_step(model, optim, loss_fn, targets, k, mesh,
                                              torch.float32, shard_bodies=True)
        rec = _timed_step(step, rows, y[:, body], dev)
        rec["params"] = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        out["steps"][tag] = rec
        marks[tag] = time.perf_counter()
    del model, optim, step
    w = pmesh.local_rows(_ring_weights(dev), mesh, shard_bodies=True)
    ring_model.zero_grad(set_to_none=True)
    (ring_model(rows, None, ring=pmesh.axis_group(mesh, pmesh.BODY_AXIS)) * w).sum().backward()
    out["ring_grads"] = {n: p.grad.cpu() for n, p in ring_model.named_parameters()}
    torch.cuda.synchronize(dev)
    marks["ring_backward"] = time.perf_counter()
    after = _kernel_counts(mods)
    out["counts"] = {k: after[k] - before[k] for k in after}
    out["seconds"] = {k: v - t0 for k, v in marks.items()}
    return out


def _ring_rank(rank: int, scene0, state, frames: int) -> dict:
    """A [ring] rank on the (2, 2) mesh: the ring force at ``scene0`` and the
    body-ring rollout of ``frames`` frames from it, this rank's blocks, its
    peak memory above its start and its seconds; then its training work
    (``_ring_train``)."""
    import importlib

    import torch

    t_enter = time.time()
    dev, mods = _rank_setup()
    wire = _host_copies_only()
    par = importlib.import_module(f"{PKG}.parallel")
    models = importlib.import_module(f"{PKG}.models")
    physics = importlib.import_module(f"{PKG}.core.physics")
    Scene = importlib.import_module(f"{PKG}.core.scene").Scene
    mesh = par.make_mesh(RING_RANKS, body_parallel=RING_BODY)
    scene = Scene(*(x.to(dev) for x in scene0))
    local = par.shard_scene(scene, mesh, shard_bodies=True)
    params = physics.GravityParams(interaction_strength=G_CONST, softening=SOFTENING)
    t = time.perf_counter()
    acc = par.make_ring_acceleration(mesh, params)(local.pos, local.mass)
    torch.cuda.synchronize(dev)
    force_s = time.perf_counter() - t
    model = models.create_model("egnn_mc", device=dev, body_ring=True)
    model.load_state_dict(state)
    model.eval()
    fn = par.make_body_ring_rollout_fn(model, frames, mesh)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev)
    before = _kernel_counts(mods)
    t = time.perf_counter()
    loc, vel, surv = fn(scene)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t
    after = _kernel_counts(mods)
    peak_mib = (torch.cuda.max_memory_allocated(dev) - start) / 2**20
    train = _ring_train(dev, mods, mesh, model, params)
    return {"coord": (mesh.get_local_rank("sim"), mesh.get_local_rank("body")),
            "acc": acc.cpu(), "loc": loc.cpu(), "vel": vel.cpu(), "survived": surv.cpu(),
            "seconds": seconds, "force_s": force_s, "enter": t_enter, "end": time.time(),
            "peak_mib": peak_mib, "backend": torch.distributed.get_backend(), "wire": wire,
            "counts": {k: after[k] - before[k] for k in after}, "train": train}


def _against_single(tag: str, got_loc, single_loc, nudged_loc) -> dict:
    """A sharded rollout's positions against the single-process rollout's from
    the same frame, at every step within YARDSTICK times the nudged spread
    or K1's tolerance of the largest position, whichever is larger."""
    import torch

    d = (got_loc - single_loc).abs().amax(dim=(0, 2, 3))  # per frame
    d_n = (nudged_loc - single_loc).abs().amax(dim=(0, 2, 3))
    size = single_loc.abs().amax(dim=(0, 2, 3))
    limit = torch.maximum(YARDSTICK * d_n, K1_ATOL + K1_RTOL * size)
    if not (torch.isfinite(got_loc).all() and bool((d <= limit).all())):
        t = int(torch.argmax(d - limit))
        fail(f"{tag}: frame {t} differs from the single-process rollout by {d[t].item():.3e} "
             f"(limit {limit[t].item():.3e}: the nudged spread {d_n[t].item():.3e})")
    last = len(d) - 1
    for t in sorted({t_ for t_ in (1, 2, 5, 10, last) if t_ <= last}):
        print(f"  {tag} step {t:3d}: max|dpos| against the single process {d[t].item():.3e}, "
              f"single vs nudged single {d_n[t].item():.3e}", flush=True)
    return {"max_dpos": f"{d.max().item():.3e}", "max_dpos_nudged": f"{d_n.max().item():.3e}",
            "bitwise": bool((d == 0).all())}


def _phase_modules():
    import importlib

    return {m: importlib.import_module(f"{PKG}.{m}") for m in (
        "models", "weights", "cli", "train.trainer", "train.losses", "utils.config",
        "data.dataloaders", "data.gravity_otf", "rollout.self_feed", "ops.gravity",
        "parallel.launch", "core.scene")}


def _tools(*calls, cwd: str) -> list:
    """Run ``python -m <package>.tools.<name> args`` for each ``(name, args)``
    side by side, as a user would (each in a process group of its own, killed with
    everything it started past PIPE_TIMEOUT); a list of calls runs one after
    another beside the rest.  ``(seconds, stdout, stderr)`` a call, its
    seconds from the start to its own end.  A tool that fails or overruns
    fails the phase.

    The tools and their stages share a bytecode cache under ``cwd``: the
    card's image sets PYTHONDONTWRITEBYTECODE and ships torch without .pyc
    files, so each process would compile torch's sources as it imports them
    (10.3 s a process there, 6-7 s from the cache)."""
    import signal
    import subprocess

    path = [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path),
               PYTHONPYCACHEPREFIX=os.path.join(cwd, "pyc"))
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    t0 = time.perf_counter()
    live = []  # every process started, for the kill on an overrun

    def run(name, args):
        proc = subprocess.Popen([sys.executable, "-m", f"{PKG}.tools.{name}", *args],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                cwd=cwd, env=env, start_new_session=True)
        live.append(proc)
        try:
            stdout, stderr = proc.communicate(timeout=max(1.0, PIPE_TIMEOUT -
                                                          (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            stdout, stderr = "", ""
        return name, proc.returncode, stdout, stderr, time.perf_counter() - t0

    def chain(calls):
        out = []
        for name, args in calls:
            out.append(run(name, args))
            if out[-1][1] != 0:
                break
        return out

    groups = [c if isinstance(c, list) else [c] for c in calls]
    with ThreadPoolExecutor(max_workers=len(groups)) as pool:
        done = [r for g in pool.map(chain, groups) for r in g]
    for name, rc, stdout, stderr, *_ in done:
        if rc is None:
            for q in live:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(q.pid, signal.SIGKILL)
            fail(f"pipeline: tools.{name} ran past {PIPE_TIMEOUT} s")
        if rc != 0:
            fail(f"pipeline: tools.{name} exited {rc}:\n{stdout[-3000:]}\n{stderr[-3000:]}")
    if len(done) != sum(len(g) for g in groups):
        fail("pipeline: a chain of tools stopped early")
    return [(seconds, stdout, stderr) for _, _, stdout, stderr, seconds in done]


def _launch_line(text: str, command: str) -> dict:
    """The launches the port's CLI reports at the end of ``command`` on the card
    (``kernel launches (<command> on cuda): {...}``), or {} for none."""
    head = f"kernel launches ({command} on cuda): "
    lines = [ln for ln in text.splitlines() if ln.startswith(head)]
    if len(lines) > 1:
        fail(f"pipeline: {len(lines)} launch lines of {command}: {lines}")
    return json.loads(lines[0][len(head):]) if lines else {}


def _pipeline_phase(layers: int) -> dict:
    """Phase 24b, [pipeline]: the research loop's tools as a user runs them
    (``tools/``), on the card; returns the phase's fields and the launches
    the train and battery stages report."""
    import csv
    import re

    viz_encode = __import__(f"{PKG}.viz.encode", fromlist=["read_png"])
    tmp = tempfile.TemporaryDirectory()
    wd, results = os.path.join(tmp.name, "wd"), os.path.join(tmp.name, "results")
    argv = ["--workdir", wd, *PIPE_ARGV]
    t_wall = time.time()
    (first_s, out1, err1), (wait_s, out_w, _) = _tools(
        ("pipeline", argv), ("wait_for_backend", ["--max-wait", "60", "--poll", "5"]),
        cwd=tmp.name)
    if out_w.strip() != "backend healthy":
        fail(f"pipeline: wait_for_backend printed {out_w!r}")
    last1 = out1.strip().splitlines()[-1]
    result = json.loads(last1)
    if result.get("status") != "ok":
        fail(f"pipeline: {last1}\n{err1[-3000:]}")
    run = result["run"]
    # each stage's seconds from the files it ends with (wall clock, probes included)
    log = os.path.join(wd, "train_attempt1.log")
    summary_path = os.path.join(run, "ks_summary.json")
    with open(summary_path) as f:
        summary = json.load(f)
    best_ck = max(summary["results"], key=lambda r: r["combined_pvalue"])["checkpoint"]
    battery_path = os.path.join(run, f"draws_ckpt{best_ck}", "self_feed_draws.json")
    if not os.path.exists(battery_path):
        fail(f"pipeline: no battery at the top checkpoint {best_ck} of {run}")
    with open(battery_path) as f:
        battery = json.load(f)
    ends = [os.path.getmtime(p) for p in (log, summary_path, battery_path)]
    stage_s = dict(zip(("train", "score", "draws"),
                       (b - a for a, b in zip([t_wall] + ends, ends))))
    ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")), key=int)
    want_best = max([r["combined_pvalue"] for r in summary["results"]]
                    + [d["combined_pvalue"] for d in battery["draws"]])
    if (ckpts != ["1", "2"] or result["best"] != want_best
            or summary["num_checkpoints"] != 2 or battery["seed"] != PIPE_SEED
            or len(battery["draws"]) != 1 or not 0.0 < want_best <= 1.0):
        fail(f"pipeline: checkpoints {ckpts}, best {result['best']} against {want_best} read "
             f"back from {summary_path} and {battery_path}, battery seed {battery['seed']}")
    # training and the draw on the card through the kernel edge stage: the
    # evaluations and the battery roll out through K1, each GT batch one K2-leapfrog
    with open(log) as f:
        train_log = f.read()
    train_launch, draw_launch = _launch_line(train_log, "train"), _launch_line(out1, "self-feed")
    steps = PIPE_EVAL_STEPS - 1
    if (train_launch.get("k1") != 2 * layers * steps or train_launch.get("leapfrog", 0) < 1
            or set(train_launch) - {"k1", "leapfrog"}
            or draw_launch != {"k1": layers * steps, "leapfrog": 1}):
        fail(f"pipeline: the train stage launched {train_launch} (want {2 * layers * steps} "
             f"K1 and K2-leapfrog), the battery {draw_launch} (want {layers * steps} K1 "
             "and 1 K2-leapfrog)")
    if "Epoch 1 |" not in train_log or "Training egnn_mc | params:" not in train_log:
        fail(f"pipeline: the train log lacks its epochs:\n{train_log[-2000:]}")

    # the same call again (nothing to do) beside the binding macro and the
    # workdir into a row, then the row into the report
    (again_s, out2, err2), (diag_s, out_d, _), (archive_s, out_a, _), (report_s, _, _) = _tools(
        ("pipeline", argv), ("diagnose_macros", [run]),
        [("archive_row", ["--workdir", wd, "--dest", PIPE_ROW, "--results-dir", results]),
         ("results_report", ["--results-dir", results])], cwd=tmp.name)
    if (out2.strip() != last1 or "pipeline: reusing run" not in err2
            or "training attempt" in err2 or "draws at" in err2):
        fail(f"pipeline: the second call printed {out2!r} / {err2[-2000:]!r}, want only {last1}")
    archived = json.loads(out_a)
    with open(os.path.join(results, "combined_pvalues_summary.csv")) as f:
        rows = list(csv.DictReader(f))
    png = viz_encode.read_png(os.path.join(results, "combined_pvalues_multi.png"))
    row = rows[0] if len(rows) == 1 else {}
    if (row.get("folder") != PIPE_ROW or row.get("model") != "egnn_mc"
            or row.get("num_checkpoints") != "2"
            or float(row["best_combined_pvalue"]) != summary["best_combined_pvalue"]
            or float(row["best_draw_pvalue"]) != battery["best_combined_pvalue"]
            or float(row["best_overall_pvalue"]) != max(summary["best_combined_pvalue"],
                                                       battery["best_combined_pvalue"])
            or archived["kept_ckpt"] is None or png.ndim != 3 or not (png != 255).any()):
        fail(f"pipeline: report rows {rows}, archive {archived}, figure {png.shape}")
    m = re.search(r"^verdict: '(\w+)' binds \((\d+)/(\d+) records", out_d, re.MULTILINE)
    if m is None:
        fail(f"pipeline: diagnose_macros named no binding macro:\n{out_d}")
    tmp.cleanup()
    launches = {k: train_launch.get(k, 0) + draw_launch.get(k, 0)
                for k in set(train_launch) | set(draw_launch)}
    fields = dict(
        model="egnn_mc", layers=layers, B=64, N=5, steps=2 * PIPE_STEPS,
        eval_steps=steps, best=f"{result['best']:.4g}", best_ckpt=best_ck,
        first_call_s=f"{first_s:.2f}", train_stage_s=f"{stage_s['train']:.2f}",
        score_stage_s=f"{stage_s['score']:.2f}", draws_stage_s=f"{stage_s['draws']:.2f}",
        second_call_s=f"{again_s:.2f}", wait_s=f"{wait_s:.2f}", archive_s=f"{archive_s:.2f}",
        report_s=f"{report_s:.2f}", diagnose_s=f"{diag_s:.2f}", binding=m.group(1),
        binding_records=f"{m.group(2)}/{m.group(3)}",
        k1_launches_train=train_launch["k1"], k1_launches_battery=draw_launch["k1"],
        leapfrog_launches=launches["leapfrog"])
    return fields, launches


def _orbax_phase(dev, counters: dict) -> dict:
    """Phases 16b, [orbax], and 16c, [fc-fast]: the committed tensorstore-written
    fixture held bitwise against its model.ckpt; [train]'s study run resumed
    for an epoch with checkpoint_backend orbax, its model.orbax read back
    bitwise its model.ckpt, one step resumed from each bitwise equal, and a
    rollout of each through load_run bitwise equal, counted; then the dense
    training step at those shapes timed with and without fc_fast.  Returns
    the rollout's launches.  ``counters`` maps a kernel to its wrapper's
    launch counter (``main``'s)."""
    import importlib

    import numpy as np
    import torch

    def mod(name):
        return importlib.import_module(f"{PKG}.{name}")

    ckpt_mod, ckpt_rate = mod("train.checkpoint"), mod("ckpt_format.rate")
    config_mod, trainer_mod, models = mod("utils.config"), mod("train.trainer"), mod("models")
    weights, restore, self_feed = mod("weights"), mod("train.restore"), mod("rollout.self_feed")
    losses_mod = mod("train.losses")

    def sync():
        torch.cuda.synchronize(dev)

    def counts() -> dict:
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    def reset_counts() -> None:
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def cuda_ms(fn, iters: int) -> float:
        fn()
        sync()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        sync()
        return start.elapsed_time(stop) / iters

    def same_payload(a, b) -> bool:
        """Two checkpoint payloads hold the same state bitwise: the params
        tree, AdamW's count and moments, apply_if_finite's counters."""
        def leaves(tree, path=()):
            if isinstance(tree, dict):
                return [x for k in sorted(tree) for x in leaves(tree[k], path + (k,))]
            return [(path, np.asarray(tree))]

        pa, pb = leaves(a["params"]), leaves(b["params"])
        if [k for k, _ in pa] != [k for k, _ in pb] or not all(
                x.dtype == y.dtype and np.array_equal(x, y) for (_, x), (_, y) in zip(pa, pb)):
            return False
        adam_a = weights.opt_state_from_jax(a["opt_state"])
        adam_b = weights.opt_state_from_jax(b["opt_state"])
        return (adam_a[0] == adam_b[0]
                and all(torch.equal(adam_a[i][k], adam_b[i][k]) for i in (1, 2) for k in adam_a[1])
                and weights.skip_counts_from_jax(a["opt_state"])
                == weights.skip_counts_from_jax(b["opt_state"])
                and a["step_count"] == b["step_count"])

    t0 = time.perf_counter()
    fixture_dir = os.path.join(REPO, "tests", "torch_fixtures", "orbax_egnn_mc")
    fixture_rate = ckpt_rate.measure(os.path.join(fixture_dir, "model.orbax"))
    fixture = ckpt_mod.load_checkpoint(os.path.join(fixture_dir, "model.orbax"))
    if not same_payload(fixture, weights.read_checkpoint(os.path.join(fixture_dir, "model.ckpt"))):
        fail("orbax: the committed tensorstore-written model.orbax is not bitwise its model.ckpt")
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        args, resolved = config_mod.parse_args(["--trainer.model_path", shutil.copy(CKPT, tmp)]
                                               + ORBAX_ARGV)
        reset_counts()
        trainer = trainer_mod.create_trainer_from_args(args, resolved_config=resolved, device=dev)
        trainer.train()
        sync()
        run_dir = trainer.save_dir_path
        orbax_dir = os.path.join(run_dir, "model.orbax")
        if not os.path.isfile(os.path.join(orbax_dir, "_METADATA")) or os.path.exists(
                os.path.join(run_dir, "model.ckpt")):
            fail(f"orbax: training with checkpoint_backend orbax wrote {sorted(os.listdir(run_dir))}")
        t = time.perf_counter()
        trainer.save_model()
        save_s = time.perf_counter() - t
        written = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(orbax_dir) for f in fs)
        trainer.args.checkpoint_backend = "pickle"
        pkl = trainer.save_model()
        t = time.perf_counter()
        payload_o = ckpt_mod.load_checkpoint(orbax_dir)
        load_s = time.perf_counter() - t
        payload_p = weights.read_checkpoint(pkl)
        if not same_payload(payload_o, payload_p) or payload_o["step_count"] != 31:
            fail("orbax: the port's model.orbax does not read back bitwise its model.ckpt")
        # one step resumed from each backend, on one batch: bitwise equal
        scene, y = trainer.dataset.get_batch()
        stepped = []
        for payload in (payload_o, payload_p):
            m = models.create_model(args.model_type, device=dev, **args.model_kwargs)
            o = trainer_mod.create_optimizer(m.parameters(), learning_rate=args.learning_rate,
                                             model_size=m.get_model_size(),
                                             factor=args.learning_rate_factor,
                                             warmup=args.learning_rate_warmup_steps)
            trainer_mod.load_training_state(m, o, payload, args.model_type)
            step_fn, _ = trainer_mod.make_train_step(m, o, trainer.loss_fn, trainer.targets,
                                                     trainer.num_neighbors, torch.float32)
            vec = step_fn(scene, y, None)
            stepped.append(({k: v.detach().clone() for k, v in m.state_dict().items()},
                            [[t_.clone() for t_ in ts] for ts in o.moments()], o.count, vec))
            del m, o
        (p_o, mom_o, c_o, v_o), (p_p, mom_p, c_p, v_p) = stepped
        if not (c_o == c_p and torch.equal(v_o, v_p)
                and all(torch.equal(v, p_p[k]) for k, v in p_o.items())
                and all(torch.equal(a, b) for xs, ys in zip(mom_o, mom_p) for a, b in zip(xs, ys))):
            fail("orbax: the step resumed from model.orbax is not bitwise the one from model.ckpt")
        # the orbax run dir rolled out through load_run, against model.ckpt's
        rolled = []
        for ck in ("model.orbax", "model.ckpt"):
            model_r, ds_r, _ = restore.load_run(run_dir, checkpoint=ck, seed=281, device=dev)
            reset_counts()
            t = time.perf_counter()
            out = self_feed.run_self_feed(model_r, ds_r, num_steps=ORBAX_ROLLOUT_STEPS)
            sync()
            rolled.append((out, counts(), time.perf_counter() - t))
            del model_r, ds_r
        (out_o, orbax_counts, roll_s), (out_p, _, _) = rolled
        want = dict.fromkeys(counters, 0)
        want["k1"], want["leapfrog"] = LAYERS * (ORBAX_ROLLOUT_STEPS - 1), 1
        if orbax_counts != want:
            fail(f"orbax: the rollout launched {orbax_counts}, want {want}")
        if not (all(torch.equal(a, b) for a, b in zip(out_o[:4], out_p[:4]))
                and out_o[4] == out_p[4] and torch.isfinite(out_o[2]).all()):
            fail("orbax: the rollout of model.orbax is not bitwise that of model.ckpt")
        del trainer
    orbax_s = time.perf_counter() - t0
    print(f"  orbax: fixture {fixture_rate['file_bytes']} bytes read, "
          f"{fixture_rate['compressed_bytes']} bytes of tensorstore's zstd chunks decoded to "
          f"{fixture_rate['decoded_bytes']} in {fixture_rate['decode_s']:.4f} s "
          f"({fixture_rate['decode_mb_s']:.2f} MB/s); the port's model.orbax {written} bytes "
          f"written in {save_s:.3f} s, read back in {load_s:.3f} s "
          f"({written / load_s / 1e6:.1f} MB/s)", flush=True)
    report("orbax", t0, orbax_s, fixture_bytes=fixture_rate["file_bytes"],
           fixture_decode_mb_s=f"{fixture_rate['decode_mb_s']:.2f}", written_bytes=written,
           save_s=f"{save_s:.3f}", load_s=f"{load_s:.3f}", resumed_step="bitwise",
           rollout_steps=ORBAX_ROLLOUT_STEPS, rollout_s=f"{roll_s:.3f}",
           k1_launches=orbax_counts["k1"], leapfrog_launches=orbax_counts["leapfrog"],
           survived=out_o[4])

    # the dense training step at [train]'s shapes with and without fc_fast: a
    # measurement, not a gate
    t0 = time.perf_counter()
    fc_ms, fc_params = {}, {}
    for fast in (False, True):
        m = models.create_model(args.model_type, device=dev,
                                **{**args.model_kwargs, "fc_fast": fast})
        o = trainer_mod.create_optimizer(m.parameters(), learning_rate=args.learning_rate,
                                         model_size=m.get_model_size(),
                                         factor=args.learning_rate_factor,
                                         warmup=args.learning_rate_warmup_steps)
        trainer_mod.load_training_state(m, o, payload_p, args.model_type)
        step_fn, _ = trainer_mod.make_train_step(m, o, losses_mod.build_loss_fn(args),
                                                 args.target.split("+"),
                                                 args.num_neighbors or (N - 1), torch.float32)
        step_fn(scene, y, None)
        sync()
        fc_params[fast] = {k: v.detach().double().clone() for k, v in m.state_dict().items()}
        fc_ms[fast] = cuda_ms(lambda: step_fn(scene, y, None), iters=TIMED_STEPS)
        del m, o
    fc_diff = max(((fc_params[True][k] - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
                  for k, v in fc_params[False].items())
    print(f"  fc-fast: dense step {fc_ms[False]:.3f} ms masked, {fc_ms[True]:.3f} ms fc_fast "
          f"(B=16, N={N}, {LAYERS} x {WIDTH}); parameters after one step differ by {fc_diff:.3e} "
          "of their largest value (not held)", flush=True)
    report("fc-fast", t0, B=16, N=N, masked_ms=f"{fc_ms[False]:.3f}",
           fc_fast_ms=f"{fc_ms[True]:.3f}", ratio=f"{fc_ms[True] / fc_ms[False]:.4f}",
           param_diff=f"{fc_diff:.3e}")
    del payload_o, payload_p, fixture
    return orbax_counts


def _dp_train_phase(dev) -> dict:
    """Phase 63, [dp-train]; returns each rank's kernel launches."""
    # `cli train` data parallel over DP_RANKS gloo ranks that share the card
    # (each rank its half of every batch, one gradient all_reduce a step), at
    # [train]'s study settings with B=64, resumed from the committed
    # checkpoint: each rank's GT rows bitwise the single-process batch's, the
    # ranks' parameters bitwise equal after every step, the first step within
    # [train]'s gates of the single-process card step on the whole batch, the
    # gathered evaluation rollout against the single-process one (YARDSTICK),
    # survived per sim equal; K1 and K2-leapfrog launches per rank; only the
    # first rank writes
    import torch

    m = _phase_modules()
    models, weights, trainer_mod = m["models"], m["weights"], m["train.trainer"]
    config_mod, dataloaders = m["utils.config"], m["data.dataloaders"]
    self_feed = m["rollout.self_feed"]
    launch, Scene = m["parallel.launch"], m["core.scene"].Scene
    t0 = time.perf_counter()
    parallel_counts = {}
    with tempfile.TemporaryDirectory() as root:
        argv = ["--trainer.model_path", shutil.copy(CKPT, root)] + DP_ARGV
        logs = os.path.join(root, "logs")
        t_spawn = time.time()
        try:
            ranks = launch.spawn_ranks(_dp_rank, DP_RANKS, (argv, root), timeout=RANK_TIMEOUT_S,
                                       threads=2, workdir=logs)
        except RuntimeError as e:
            fail(f"dp-train: {e}")
        t_back = time.time()
        print(f"  dp-train: ranks {t_back - t_spawn:.2f} s", flush=True)
        dp_args, _ = config_mod.parse_args(argv)
        whole = dataloaders.create_dataloader(dp_args, device=dev).dataset.generate_trajectories(
            DP_B)
        half = DP_B // DP_RANKS
        for r, rec in enumerate(ranks):
            for k, v in whole.items():
                if not torch.equal(rec["gt"][k], v[r * half:(r + 1) * half].cpu()):
                    fail(f"dp-train: rank {r}'s GT {k} is not the single-process batch's rows")
            if not rec["wire"]["collectives"] or rec["wire"]["on_card"]:
                fail(f"dp-train: rank {r}'s gloo collectives got {rec['wire']} (want host "
                     "tensors only)")
            if not rec["data_parallel"] or rec["count"] != ranks[0]["count"]:
                fail(f"dp-train: rank {r} data parallel {rec['data_parallel']}, AdamW count "
                     f"{rec['count']}")
            want = dict.fromkeys(rec["counts"], 0)
            want["k1"], want["leapfrog"] = LAYERS * (DP_FRAMES - 1), 2
            if rec["counts"] != want:
                fail(f"dp-train: rank {r} launched {rec['counts']}, want {want} (the training "
                     "GT batch and the evaluation's, its sims' evaluation steps through K1)")
        if len(ranks[0]["steps"]) != DP_STEPS or any(
                len(rec["steps"]) != DP_STEPS for rec in ranks):
            fail(f"dp-train: {[len(rec['steps']) for rec in ranks]} steps, want {DP_STEPS}")
        for i in range(DP_STEPS):
            a, b = ranks[0]["steps"][i]["params"], ranks[1]["steps"][i]["params"]
            if not all(torch.equal(a[k], b[k]) for k in a):
                fail(f"dp-train: the ranks' parameters differ after step {i + 1}")
        # the first step against the single-process card step on the whole batch
        sp = models.create_model("egnn_mc", device=dev)
        sp_optim = trainer_mod.create_optimizer(
            sp.parameters(), learning_rate=dp_args.learning_rate, model_size=sp.get_model_size(),
            factor=dp_args.learning_rate_factor, warmup=dp_args.learning_rate_warmup_steps,
            clip_value=dp_args.clip_gradients_value, clip_norm=dp_args.clip_gradients_norm,
            discard_nan_gradients=dp_args.discard_nan_gradients)
        trainer_mod.load_training_state(sp, sp_optim, weights.read_checkpoint(CKPT), "egnn_mc")
        sp_before = {n: p.detach().cpu().clone() for n, p in sp.named_parameters()}
        parts = [rec["steps"][0]["batch"] for rec in ranks]
        pos_, vel_, force_, mass_, y_ = (torch.cat([p[i] for p in parts]).to(dev)
                                          for i in range(5))
        sp_step, _ = trainer_mod.make_train_step(
            sp, sp_optim, m["train.losses"].build_loss_fn(dp_args), dp_args.target.split("+"),
            N - 1, torch.float32)
        sp_step(Scene(pos=pos_, vel=vel_, force=force_, mass=mass_), y_)
        p_err, up_err = _step_gate("dp-train: the first step", ranks[0]["steps"][0]["params"],
                                   sp, sp_before)
        del sp, sp_optim, sp_before
        # the gathered evaluation rollout against the single-process one
        ev = ranks[0]["eval"]
        if ev is None or any(rec["eval"] is None for rec in ranks):
            fail("dp-train: a rank ran no sharded evaluation rollout")
        for rec in ranks[1:]:
            if not (torch.equal(rec["eval"]["loc"], ev["loc"])
                    and torch.equal(rec["eval"]["survived"], ev["survived"])):
                fail("dp-train: the ranks' gathered evaluation rollouts differ")
        sp = models.create_model("egnn_mc", device=dev)
        sp.load_state_dict(ev["params"])
        sp.eval()
        scene_e = Scene(*(x.to(dev) for x in ev["scene0"]))
        roll = self_feed.make_rollout_fn(sp, DP_FRAMES)
        loc_s, _, surv_s = roll(scene_e)
        loc_n, _, _ = roll(Scene(pos=scene_e.pos * (1 + 1e-7), vel=scene_e.vel,
                                 force=scene_e.force, mass=scene_e.mass))
        if not torch.equal(ev["survived"], surv_s.cpu()):
            fail(f"dp-train: survived per sim {ev['survived'].tolist()}, the single process "
                 f"{surv_s.tolist()}")
        dp_cmp = _against_single("dp-train", ev["loc"], loc_s.cpu(), loc_n.cpu())
        del sp, roll, loc_s, loc_n
        if ranks[1]["files"]:
            fail(f"dp-train: rank 1 wrote {ranks[1]['files'][:5]}")
        run0 = ranks[0]["save_dir"]
        need = {os.path.join(run0, f) for f in (
            "model.ckpt", "metrics.jsonl", "config.yaml", "training_args.json",
            os.path.join("checkpoints", "31", "nbody_macro_metrics.json"))}
        if not need <= set(ranks[0]["files"]):
            fail(f"dp-train: rank 0 did not write {sorted(need - set(ranks[0]['files']))}")
    for r, rec in enumerate(ranks):
        mk = rec["marks"]
        print(f"  dp-train rank {r}: started {mk['enter'] - t_spawn:.2f} s after the spawn, "
              f"train_main at +{mk['train_main'] - mk['enter']:.2f} s, its first step at "
              f"+{mk['first_step'] - mk['train_main']:.2f} s, the evaluation rollout "
              f"+{mk['eval_rollout'] - mk['train_main']:.2f} s to "
              f"+{mk['eval_rollout_end'] - mk['train_main']:.2f} s, done at "
              f"+{mk['end'] - mk['train_main']:.2f} s; back in the parent "
              f"{t_back - mk['end']:.2f} s later", flush=True)
        steady = rec["step_ms"][1:] or rec["step_ms"]
        ms = sum(steady) / len(steady)
        red = rec["reduce_ms"][1:] or rec["reduce_ms"]
        print(f"  dp-train rank {r}: {rec['seconds']:.2f} s in train_main, step ms "
              f"{' '.join(f'{x:.2f}' for x in rec['step_ms'])} (steady {ms:.3f}), gradient "
              f"all_reduce {sum(red) / len(red):.3f} ms ({sum(red) / len(red) / ms:.1%} of a "
              f"step), peak {rec['peak_mib']:.1f} MiB, backend {rec['backend']}", flush=True)
        parallel_counts[f"dp-train_rank{r}"] = rec["counts"]
    report("dp-train", t0, ranks=DP_RANKS, backend=ranks[0]["backend"], B=DP_B, N=N,
           steps=DP_STEPS, cmp_param_err=f"{p_err:.3e}", cmp_update_err=f"{up_err:.3e}",
           eval_frames=DP_FRAMES, survived_min=int(ev["survived"].min()),
           eval_max_dpos=dp_cmp["max_dpos"], eval_max_dpos_nudged=dp_cmp["max_dpos_nudged"],
           eval_bitwise=dp_cmp["bitwise"],
           k1_launches_per_rank=ranks[0]["counts"]["k1"],
           gloo_collectives_rank0=ranks[0]["wire"]["collectives"],
           gloo_tensors_on_card=sum(rec["wire"]["on_card"] for rec in ranks),
           leapfrog_launches_per_rank=ranks[0]["counts"]["leapfrog"],
           **{f"step_ms_rank{r}": f"{sum(rec['step_ms'][1:]) / max(1, DP_STEPS - 1):.3f}"
              for r, rec in enumerate(ranks)})
    return parallel_counts


def _step_gate(tag: str, got: dict, ref_model, before: dict):
    """A sharded step's parameters ``got`` against the single-process step's
    (``ref_model``'s) from the same ``before``: each within TRAIN_PARAM_RTOL of
    its largest value and its update within TRAIN_UPDATE_RTOL of its largest
    update.  Returns the largest of each error."""
    p_err = up_err = 0.0
    bad = []
    for n, p in ref_model.named_parameters():
        ref = p.detach().cpu()
        e = (got[n] - ref).abs().max().item() / (ref.abs().max().item() or 1.0)
        du = (ref - before[n]).abs().max().item() or 1.0
        u = ((got[n] - before[n]) - (ref - before[n])).abs().max().item() / du
        p_err, up_err = max(p_err, e), max(up_err, u)
        if not (e <= TRAIN_PARAM_RTOL and u <= TRAIN_UPDATE_RTOL):
            bad.append(f"{n} by {e:.3e} of its largest value, its update by {u:.3e}")
    if bad:
        fail(f"{tag} against the single-process step on the whole batch (limits "
             f"{TRAIN_PARAM_RTOL}, {TRAIN_UPDATE_RTOL}): " + "; ".join(bad))
    return p_err, up_err


def _ring_train_phase(dev, ranks, state, m) -> dict:
    """[ring]'s training checks in the parent: each rank's GT rows bitwise the
    single-process batch's and its launches (one K2-leapfrog, nothing else),
    each body-sharded step within [train]'s gates of the single-process card
    step, the ranks' parameters bitwise equal, and the ring's gradient summed
    over the ranks within TRAIN_PARAM_RTOL of the dense model's.  Returns the
    report's fields."""
    import importlib

    import torch

    models, Scene = m["models"], m["core.scene"].Scene
    physics = importlib.import_module(f"{PKG}.core.physics")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(RING_TRAIN_SEED)
    gt = physics.sample_trajectory_batch(
        RING_TRAIN_B, N, T=RING_TRAIN_SUBSTEPS, sample_freq=SAMPLE_FREQ,
        params=physics.GravityParams(interaction_strength=G_CONST, softening=SOFTENING),
        device=dev, generator=gen)
    rows = RING_TRAIN_B // (RING_RANKS // RING_BODY)
    for rec in ranks:
        tr, s = rec["train"], rec["coord"][0]
        if not all(torch.equal(a, b[s * rows:(s + 1) * rows].cpu()) for a, b in zip(tr["gt"], gt)):
            fail(f"ring: rank {rec['coord']}'s GT rows are not the single-process batch's")
        want = dict.fromkeys(tr["counts"], 0)
        want["leapfrog"] = 1
        if tr["counts"] != want:
            fail(f"ring: rank {rec['coord']}'s training work launched {tr['counts']}, want {want}")
    scene, y = _train_pair(Scene, *gt)
    fields = {}
    marks = {"gt": time.perf_counter() - t0}
    sp = models.create_model("egnn_mc", device=dev, edge_impl="dense")
    optim, loss_fn, targets, load = _train_setup(sp, m["weights"].read_checkpoint(CKPT))
    marks["setup"] = time.perf_counter() - t0
    for tag, k in RING_TRAIN_CASES:
        got = [rec["train"]["steps"][tag] for rec in ranks]
        if not all(torch.equal(g["params"][n], got[0]["params"][n])
                   for g in got[1:] for n in got[0]["params"]):
            fail(f"ring: the ranks' parameters differ after the {tag} step")
        load()
        before = {n: p.detach().cpu().clone() for n, p in sp.named_parameters()}
        step, _ = m["train.trainer"].make_train_step(sp, optim, loss_fn, targets, k,
                                                      torch.float32)
        single = _timed_step(step, scene, y, dev)
        p_err, up_err = _step_gate(f"ring: the body-sharded {tag} step", got[0]["params"], sp,
                                   before)
        ms = max(g["ms"] for g in got)
        peak = max(g["peak_mib"] for g in got)
        print(f"  ring train {tag} (k={k}): loss {got[0]['loss']:.8f} (single process "
              f"{single['loss']:.8f}), params max rel err {p_err:.3e}, update max rel err "
              f"{up_err:.3e}; a rank's step {ms:.2f} ms, peak {peak:.1f} MiB above its start, "
              f"the single-process step {single['ms']:.2f} ms, {single['peak_mib']:.1f} MiB",
              flush=True)
        marks[tag] = time.perf_counter() - t0
        fields.update({f"train_{tag}_param_err": f"{p_err:.3e}",
                       f"train_{tag}_update_err": f"{up_err:.3e}",
                       f"train_{tag}_rank_ms": f"{ms:.3f}",
                       f"train_{tag}_single_ms": f"{single['ms']:.3f}",
                       f"train_{tag}_rank_peak_mib": f"{peak:.1f}",
                       f"train_{tag}_single_peak_mib": f"{single['peak_mib']:.1f}"})
    del optim, step
    sp.load_state_dict(state)
    sp.zero_grad(set_to_none=True)
    G = importlib.import_module(f"{PKG}.core.graph")
    (sp(scene, G.knn_mask(scene.pos, N - 1)) * _ring_weights(dev)).sum().backward()
    g_err = 0.0
    for n, p in sp.named_parameters():
        got = sum(rec["train"]["ring_grads"][n] for rec in ranks)
        want = p.grad.cpu()
        e = (got - want).abs().max().item() / (want.abs().max().item() or 1.0)
        g_err = max(g_err, e)
        if e > TRAIN_PARAM_RTOL:
            fail(f"ring: the ring's gradient of {n} differs from the dense model's by {e:.3e} "
                 f"of its largest value (limit {TRAIN_PARAM_RTOL})")
    secs = ranks[0]["train"]["seconds"]
    print(f"  ring train: the ring's gradient summed over the ranks against the dense model's: "
          f"max rel err {g_err:.3e} (limit {TRAIN_PARAM_RTOL}); a rank's training work, s from "
          "its start: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
          + "; the parent's checks, s: " + ", ".join(f"{k} {v:.2f}" for k, v in marks.items())
          + f", ring_backward {time.perf_counter() - t0:.2f}", flush=True)
    del sp
    fields["ring_grad_err"] = f"{g_err:.3e}"
    return fields


def _ring_phase(dev, state) -> dict:
    """Phase 64, [ring], with the committed checkpoint's ``state``; returns each
    rank's kernel launches."""
    # the body-sharded ring on RING_RANKS gloo ranks that share the card, a
    # (sim, body) = (2, 2) mesh at [bign-rollout]'s workload: the ring force
    # at a GT frame against K2; the body-ring rollout of the committed
    # checkpoint against the single-process plain dense rollout
    # (edge_impl="dense") of the same frame (YARDSTICK), survived per sim
    # equal; each rank's peak memory beside the dense path's
    import torch

    m = _phase_modules()
    models, self_feed, gravity = m["models"], m["rollout.self_feed"], m["ops.gravity"]
    otf, launch, Scene = m["data.gravity_otf"], m["parallel.launch"], m["core.scene"].Scene
    parallel_counts = {}
    t0 = time.perf_counter()
    gt_ring = otf.GravityDatasetOtf(batch_size=BIG_B, sim_length=BIG_SUBSTEPS,
                                    sample_freq=SAMPLE_FREQ, num_nodes=BIG_N,
                                    interaction_strength=G_CONST, softening=SOFTENING, seed=64,
                                    device=dev).get_ground_truth_trajectories()
    scene_r = Scene(pos=gt_ring[0][:, 0], vel=gt_ring[1][:, 0], force=gt_ring[2][:, 0],
                    mass=gt_ring[3])
    t_spawn = time.time()
    try:
        ranks = launch.spawn_ranks(
            _ring_rank, RING_RANKS, (tuple(x.cpu() for x in (scene_r.pos, scene_r.vel,
                                                            scene_r.force, scene_r.mass)),
                                     state, RING_STEPS + 1),
            timeout=RANK_TIMEOUT_S, threads=2)
    except RuntimeError as e:
        fail(f"ring: {e}")
    t_back = time.time()
    sims, bodies = RING_RANKS // RING_BODY, RING_BODY
    block = {rec["coord"]: rec for rec in ranks}

    def whole(key, axis):
        return torch.cat([torch.cat([block[(s, b)][key] for b in range(bodies)], dim=axis)
                          for s in range(sims)])

    acc_k2 = gravity.acceleration(scene_r.pos, scene_r.mass, G_CONST, SOFTENING).cpu()
    acc_ring = whole("acc", 1)
    ring_err = (acc_ring - acc_k2).abs()
    if not bool((ring_err <= K2_ATOL + K2_RTOL * acc_k2.abs()).all()):
        fail(f"ring: the ring force differs from K2 by {ring_err.max().item():.3e} "
             f"(rtol {K2_RTOL}, atol {K2_ATOL})")
    ring_rel = ring_err.max().item() / acc_k2.abs().max().item()
    dense = models.create_model("egnn_mc", device=dev, edge_impl="dense")
    dense.load_state_dict(state)
    dense.eval()
    roll = self_feed.make_rollout_fn(dense, RING_STEPS + 1)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev)
    loc_d, _, surv_d = roll(scene_r)
    torch.cuda.synchronize(dev)
    dense_peak = (torch.cuda.max_memory_allocated(dev) - start) / 2**20
    loc_n, _, _ = roll(Scene(pos=scene_r.pos * (1 + 1e-7), vel=scene_r.vel, force=scene_r.force,
                             mass=scene_r.mass))
    surv_ring = torch.cat([block[(s, 0)]["survived"] for s in range(sims)])
    for rec in ranks:
        if not torch.equal(rec["survived"], block[(rec["coord"][0], 0)]["survived"]):
            fail("ring: the body shards of a sim disagree on survived")
        if any(rec["counts"].values()):
            fail(f"ring: the ring rollout launched {rec['counts']} (plain PyTorch, no kernel)")
        if not rec["wire"]["collectives"] or rec["wire"]["on_card"]:
            fail(f"ring: a rank's gloo collectives got {rec['wire']} (want host tensors only)")
    if not torch.equal(surv_ring, surv_d.cpu()):
        fail(f"ring: survived per sim {surv_ring.tolist()}, the dense rollout {surv_d.tolist()}")
    ring_cmp = _against_single("ring", whole("loc", 2), loc_d.cpu(), loc_n.cpu())
    del dense, roll, loc_d, loc_n
    train_fields = _ring_train_phase(dev, ranks, state, m)
    for rec in sorted(ranks, key=lambda r_: r_["coord"]):
        print(f"  ring rank at (sim, body) = {rec['coord']}: started "
              f"{rec['enter'] - t_spawn:.2f} s after the spawn, done "
              f"{rec['end'] - rec['enter']:.2f} s later, back in the parent "
              f"{t_back - rec['end']:.2f} s later; rollout {rec['seconds']:.2f} s "
              f"({RING_STEPS / rec['seconds']:.2f} steps/s), ring force {rec['force_s']:.3f} s, "
              f"peak {rec['peak_mib']:.1f} MiB above its start, backend {rec['backend']}",
              flush=True)
        parallel_counts[f"ring_{rec['coord'][0]}{rec['coord'][1]}"] = rec["counts"]
        parallel_counts[f"ring-train_{rec['coord'][0]}{rec['coord'][1]}"] = rec["train"]["counts"]
    report("ring", t0, ranks=RING_RANKS, mesh=f"{sims}x{bodies}", backend=ranks[0]["backend"],
           B=BIG_B, N=BIG_N, steps=RING_STEPS, force_max_rel_err=f"{ring_rel:.3e}",
           rollout_max_dpos=ring_cmp["max_dpos"], max_dpos_nudged=ring_cmp["max_dpos_nudged"],
           survived_min=int(surv_ring.min()),
           gloo_collectives_per_rank=ranks[0]["wire"]["collectives"],
           gloo_tensors_on_card=sum(rec["wire"]["on_card"] for rec in ranks),
           peak_mib_per_rank=f"{max(rec['peak_mib'] for rec in ranks):.1f}",
           dense_peak_mib=f"{dense_peak:.1f}", **train_fields)
    return parallel_counts


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    sys.path.insert(0, REPO)
    try:
        import importlib

        pkg = importlib.import_module(PKG)  # noqa: F841
        _build = importlib.import_module(f"{PKG}.ops._build")
        gravity = importlib.import_module(f"{PKG}.ops.gravity")
        EM = importlib.import_module(f"{PKG}.ops.egnn_messages")
        ES = importlib.import_module(f"{PKG}.ops.egnn_stream")
        bign_bench = importlib.import_module(f"{PKG}.bign_bench")
        datagen_bench = importlib.import_module(f"{PKG}.datagen_bench")
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
        trainer_mod = importlib.import_module(f"{PKG}.train.trainer")
        config_mod = importlib.import_module(f"{PKG}.utils.config")
        artifacts = importlib.import_module(f"{PKG}.metrics.artifacts")
        extended = importlib.import_module(f"{PKG}.metrics.extended_artifacts")
        ks_checkpoints = importlib.import_module(f"{PKG}.evaluation.ks_checkpoints")
        viz_cli = importlib.import_module(f"{PKG}.viz.cli")
        viz_encode = importlib.import_module(f"{PKG}.viz.encode")
        viz_plots = importlib.import_module(f"{PKG}.viz.macro_plots")
        viz_traj = importlib.import_module(f"{PKG}.viz.trajectories")
        cli = importlib.import_module(f"{PKG}.cli")
        studies = importlib.import_module(f"{PKG}.evaluation.studies")
        battery = importlib.import_module(f"{PKG}.battery")
        inferencer = importlib.import_module(f"{PKG}.rollout.inferencer")
        hpo = importlib.import_module(f"{PKG}.hpo.hpo")
        restore = importlib.import_module(f"{PKG}.train.restore")
        ponita = importlib.import_module(f"{PKG}.models.ponita")
        edge_phases = importlib.import_module(f"{PKG}.edge_phases")
        steerable = importlib.import_module(f"{PKG}.ops.steerable")
        legacy = importlib.import_module(f"{PKG}.core.legacy_sims")
        offline_datagen = importlib.import_module(f"{PKG}.data.offline_datagen")
        launch = importlib.import_module(f"{PKG}.parallel.launch")
        dataloaders = importlib.import_module(f"{PKG}.data.dataloaders")
        losses_mod = importlib.import_module(f"{PKG}.train.losses")
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

    probes = []

    def launch_probe(where: str) -> None:
        """The host's microseconds a launch at this point of the run: a sync,
        then PROBE_LAUNCHES in-place adds on a 64-float tensor (dispatch and
        launch, no new tensor), the same number of out-of-place adds (a new
        tensor object each) with the garbage collector on and with it off,
        and the collector's tracked objects.  One line; a failed probe fails
        no phase."""
        x = torch.zeros(64, device=dev)
        times = {}
        for name, fn in (("inplace", lambda: x.add_(1.0)), ("alloc", lambda: x + 1.0),
                         ("alloc_gc_off", lambda: x + 1.0)):
            if name == "alloc_gc_off":
                gc.disable()
            try:
                sync()
                t = time.perf_counter()
                for _ in range(PROBE_LAUNCHES):
                    fn()
                sync()
                times[name] = (time.perf_counter() - t) * 1e6 / PROBE_LAUNCHES
            finally:
                gc.enable()
        probes.append((where, times))
        print(f"[launch-probe] at={where!r} " + " ".join(f"{k}_us={v:.2f}" for k, v in
                                                           times.items())
              + f" gc_tracked_objects={len(gc.get_objects())} gc_counts={gc.get_count()} "
              f"t={time.perf_counter() - T_START:.1f}", flush=True)

    # ------------------------------------------------------------ 1. device
    t0 = time.perf_counter()
    card = bign_bench.card_name()
    if not card:
        fail("nvidia-smi gave no card name and power limit")
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the cuBLAS bf16 products around the kernels (hA, hB, node MLPs) reduce in
    # f32, as XLA's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kind = torch.cuda.get_device_name(0)
    report("device", t0, kind=repr(kind), torch=torch.__version__, cuda=torch.version.cuda,
           tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
           tf32_cudnn=torch.backends.cudnn.allow_tf32,
           bf16_reduced_precision_reduction=(
               torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction),
           cublas_workspace_config=os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    launch_probe("start")

    # ------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    launch.start_server()  # the gloo ranks' fork server (phases 63-64) imports torch meanwhile
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

    # --------------------------------------------------------------- silu
    t0 = time.perf_counter()
    inf, nan = float("inf"), float("nan")
    edges = torch.tensor([-inf, -100.0, -89.0, nan, 0.0, -0.0, 100.0, inf], device=dev)
    x = torch.cat([torch.linspace(-100.0, 100.0, 2_000_001, device=dev), edges])
    y = torch.empty_like(x)
    _build.check(_build.kernels().nbody_edge_silu_f32(x.data_ptr(), y.data_ptr(), x.numel(),
                                                      _build.stream_ptr(x)), "silu")
    ieee = x / (1.0 + torch.exp(-x))  # the formula the kernels used before, on the card
    sync()
    ye, ie = y[-len(edges):], ieee[-len(edges):]
    same = (torch.isnan(ye) == torch.isnan(ie)) & ((ye == ie) | torch.isnan(ye))
    if not bool(same.all()) or not bool((torch.signbit(ye) == torch.signbit(ie)).all()):
        fail(f"silu at {edges.tolist()}: {ye.tolist()}, IEEE gives {ie.tolist()}")
    # where exp(-x) < 2^126; below, the sigmoid is under 2^-126 and flushes to 0
    ref = x.double() * torch.sigmoid(x.double())
    keep = torch.isfinite(ref) & (x >= -87.0) & (ref != 0)
    silu_err = ((y.double() - ref).abs() / ref.abs())[keep].max().item()
    below = (x < -87.0) & torch.isfinite(x)
    silu_abs_below = (y.double() - ref).abs()[below].max().item()
    if not silu_err <= SILU_RTOL:
        fail(f"silu: worst relative error {silu_err} over [-87, 100] (limit {SILU_RTOL})")
    report("silu", t0, max_rel_err=f"{silu_err:.3e}", limit=SILU_RTOL,
           max_abs_err_below_minus_87=f"{silu_abs_below:.3e}", edges="IEEE")

    gen = torch.Generator(device=dev).manual_seed(0)

    # ---------------------------------------------------------------- 3. K2
    t0 = time.perf_counter()
    k2_err = 0.0
    for bb, nn_, soft in ((B, N, SOFTENING), (BIG_B, BIG_N, SOFTENING), (2, 300, SOFTENING),
                          (FAR_B, FAR_N, SOFTENING), (B, N, 0.0)):
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

    def k2_times(bb: int, nn_: int, iters: int):
        """K2's and its plain version's ms a call, and its bound, at (bb, nn_)."""
        pos = torch.randn((bb, nn_, 3), device=dev, generator=gen) * (nn_ / 5.0) ** (1 / 3)
        mass = torch.ones((bb, nn_, 1), device=dev)
        ms = cuda_ms(lambda: gravity.acceleration(pos, mass, G_CONST, SOFTENING), iters=iters)
        plain = cuda_ms(lambda: gravity.acceleration_plain(pos, mass, G_CONST, SOFTENING),
                        iters=max(3, iters // 4))
        return (ms, plain, *bound_ms(4 * bb * nn_ * (3 + 1 + 3), K2_FLOPS_PER_PAIR * bb * nn_ * nn_))

    # at the shape of the path that runs K2 (GT above the integrator's limit), and
    # at the N=100 GT shape that earlier PRs timed it at
    k2_ms, k2_plain_ms, k2_bound, k2_by = k2_times(FAR_B, FAR_N, 50)
    k2_gt_ms, k2_gt_plain_ms, k2_gt_bound, _ = k2_times(B, N, 200)
    report("K2", t0, max_abs_err=k2_err, rtol=K2_RTOL, atol=K2_ATOL,
           shape=f"B={FAR_B},N={FAR_N}", ms=f"{k2_ms:.5f}", plain_ms=f"{k2_plain_ms:.5f}",
           bound_ms=f"{k2_bound:.5f}", bound_by=k2_by, **{
               f"ms_{B}x{N}": f"{k2_gt_ms:.5f}", f"plain_ms_{B}x{N}": f"{k2_gt_plain_ms:.5f}",
               f"bound_ms_{B}x{N}": f"{k2_gt_bound:.5f}"})

    # --------------------------------------------------------- integrate
    t0 = time.perf_counter()
    sms = _build.sm_count(torch.empty(0, device=dev))

    def initial(bb: int, nn_: int, seed: int):
        g = torch.Generator(device=dev).manual_seed(seed)
        return physics.sample_initial_conditions(bb, nn_, device=dev, generator=g)

    def k2_loop(state, substeps: int, soft: float = SOFTENING, freq: int = SAMPLE_FREQ):
        """The per-substep path: one K2 launch (and the kicks around it) a substep."""
        return gravity.leapfrog_loop(*state, substeps, freq, G_CONST, soft, DT, gravity.acceleration)

    def integrate(state, substeps: int, soft: float = SOFTENING, freq: int = SAMPLE_FREQ):
        return gravity.leapfrog(*state, substeps, freq, G_CONST, soft, DT)

    def launch_info(bb: int, nn_: int) -> str:
        return " ".join(f"{k}={v}" for k, v in datagen_bench.launch(bb, nn_, sms).items())

    for bb, nn_, substeps, soft in INTEGRATE_BITWISE:
        state = initial(bb, nn_, 10)
        got, want = integrate(state, substeps, soft), k2_loop(state, substeps, soft)
        sync()
        for name, a, b_ in zip(("loc", "vel", "force"), got, want):
            if not torch.equal(a.view(torch.int32), b_.view(torch.int32)):
                fail(f"integrate: {name} at (B,N,substeps)=({bb},{nn_},{substeps}) softening "
                     f"{soft} is not bitwise the loop of K2 launches' "
                     f"(max abs diff {(a - b_).abs().max().item()})")
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        print(f"  bitwise equal: B={bb} N={nn_} substeps={substeps} softening={soft} "
              f"{launch_info(bb, nn_)} finite={finite}", flush=True)
    lf_err = 0.0
    for bb, nn_ in PLAIN_SHAPES:
        state = initial(bb, nn_, 11)
        got = integrate(state, PLAIN_SUBSTEPS, freq=1)
        want = gravity.leapfrog_plain(*state, PLAIN_SUBSTEPS, 1, G_CONST, SOFTENING, DT)
        sync()
        errs = []
        for name, a, b_ in zip(("loc", "vel", "force"), got, want):
            err, scale = (a - b_).abs().max().item(), b_.abs().max().item()
            if not err <= LEAPFROG_RTOL * scale:
                fail(f"integrate: {name} at B={bb} N={nn_} differs from the plain loop by {err} "
                     f"over {PLAIN_SUBSTEPS} substeps (max |plain| {scale}, rtol {LEAPFROG_RTOL})")
            errs.append(f"{name} max_abs_err={err:.3e} max_abs={scale:.3e}")
            lf_err = max(lf_err, err)
        print(f"  vs plain, {PLAIN_SUBSTEPS} substeps at B={bb} N={nn_} ({launch_info(bb, nn_)}): "
              f"{' '.join(errs)}", flush=True)
    for bb, nn_, substeps in DATAGEN_SHAPES:
        row = datagen_bench.measure(bb, nn_, substeps, dev)
        if (bb, nn_, substeps) == (B, N, SUBSTEPS):
            main_gt = row
        print(f"  datagen B={bb} N={nn_} substeps={substeps}: integrator "
              f"{' '.join(f'{x:.6f}' for x in row['integrator_s'])} s "
              f"({row['us_per_substep']:.3f} us a substep), loop of K2 launches "
              f"{' / '.join(f'{x:.6f}' for x in row['k2_loop_s'])} s, {row['speedup']:.1f}x; "
              f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}), {row['bound_share']:.1%} "
              f"of it; {launch_info(bb, nn_)}; simulate takes {row['simulate_takes']}", flush=True)
    lf_ms, lf_bound, lf_by = (main_gt["integrator_mean_s"] * 1e3, main_gt["bound_ms"],
                              main_gt["bound_by"])
    state = initial(B, N, 12)
    lf_plain_ms = datagen_bench.event_s(lambda: gravity.leapfrog_plain(
        *state, SUBSTEPS, SAMPLE_FREQ, G_CONST, SOFTENING, DT)) * 1e3
    del state, got, want
    report("integrate", t0, bitwise_shapes=len(INTEGRATE_BITWISE), max_abs_err=f"{lf_err:.3e}",
           rtol=LEAPFROG_RTOL, ms=f"{lf_ms:.4f}", plain_ms=f"{lf_plain_ms:.2f}",
           bound_ms=f"{lf_bound:.5f}", bound_by=lf_by, sms=sms)

    def check_close(kernel: str, label: str, got, want, errs: dict,
                    rtol: float = K1_RTOL, atol: float = K1_ATOL) -> None:
        """Hold a kernel's ``(agg, trans)`` against a reference's, at K1's tolerance
        (or the given one) against the reference's scale; record the errors in
        ``errs``.  Dtypes must agree (agg in the operand dtype, trans in f32)."""
        for part, a, b in (("agg", got[0], want[0]), ("trans", got[1], want[1])):
            if a.dtype != b.dtype:
                fail(f"{kernel} {part} is {a.dtype}, its reference {b.dtype} ({label})")
            a, b = a.float(), b.float()
            if not torch.isfinite(a).all():
                fail(f"{kernel} {part} not finite ({label})")
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            if err > atol + rtol * scale:
                fail(f"{kernel} {part} disagrees ({label}): "
                     f"max abs err {err}, max |reference| {scale}")
            errs[f"{part} {label}"] = (err, err / max(scale, 1e-30))

    def print_errs(kernel: str, errs: dict) -> None:
        for key, (a, r) in errs.items():
            print(f"  {kernel} {key}: max_abs_err={a:.3e} max_rel_err={r:.3e}", flush=True)

    def check_f64(kernel: str, label: str, fn, plain, args, ratios: dict, **kwargs) -> None:
        """An edge kernel and its plain version, both in the form's dtypes, against
        the plain version in float64 on the same inputs (edge_phases.f64_errors: the
        exact function, no bf16 rounding); the kernel's relative error on agg and on
        trans at most F64_RATIO_MAX times the plain version's.  Both errors and
        their ratio are printed."""
        errs = edge_phases.f64_errors(fn, plain, args, kwargs)
        dtype = str(args[0].dtype).replace("torch.", "")
        for part, e in errs.items():
            print(f"  {kernel} {part} {label} vs float64: kernel_rel_err={e['kernel']:.3e} "
                  f"plain_{dtype}_rel_err={e['plain']:.3e} ratio={e['ratio']:.3f}", flush=True)
            if not e["ratio"] <= F64_RATIO_MAX:
                fail(f"{kernel} {part} ({label}): its error against float64, {e['kernel']:.3e}, "
                     f"is over {F64_RATIO_MAX}x the {dtype} plain version's, {e['plain']:.3e}")
            ratios[f"{part} {label}"] = e["ratio"]
        torch.cuda.empty_cache()

    sm_clock_mhz = bign_bench.max_sm_clock_mhz()

    def sfu_floor_ms(rows: int) -> float:
        """The least time the silus of ``rows`` edge rows take on the special-function
        units: SFU_OPS_PER_SILU operations each, SFU_PER_CLOCK a clock on each SM, at
        the card's maximum SM clock."""
        sms_ = _build.sm_count(torch.empty(0, device=dev))
        return rows * SILUS_PER_ROW * SFU_OPS_PER_SILU / (SFU_PER_CLOCK * sms_ * sm_clock_mhz * 1e6) * 1e3

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
        big = (BIG_PRE * hA[:4, :40], BIG_PRE * hB[:4, :40], geom[:4, :40, :40],
               masks["fc"][:4, :40, :40])
        check_close("K1", f"hA, hB x{BIG_PRE:g}", EM.fused_egnn_messages(*big, *w),
                    EM.egnn_messages_plain(*big, *w), k1_err)
        mask = masks["fc"]
        k1_f64 = {}
        check_f64("K1", "fc mask", EM.fused_egnn_messages, EM.egnn_messages_plain,
                  (hA, hB, geom, mask, *w), k1_f64)
        k1_ms = cuda_ms(lambda: EM.fused_egnn_messages(hA, hB, geom, mask, *w), iters=20)
        k1_plain_ms = cuda_ms(lambda: EM.egnn_messages_plain(hA, hB, geom, mask, *w), iters=5)
    # the edge kernels' calls that [determinism] repeats, by form
    repeat = {"K1": functools.partial(EM.fused_egnn_messages, hA, hB, geom, mask, *w)}
    He = Hc = WIDTH
    edge_flops = He * He + He * Hc + 5 * He + Hc  # per edge row, times 2 for multiply-add
    product_flops = He * He + He * Hc  # the two 128x128 products' part of it
    weight_floats = 5 * He + He * He + He + He * Hc + 2 * Hc

    def f32_bound_ms(n_bytes: float, rows: int):
        """The f32 forms' bound, the smaller of two routes for f32-accurate work:
        every operation on the CUDA cores at the f32 peak (the FMA route), or the
        two products as three TF32 products on the tensor cores (3xTF32) and the
        rest at the f32 peak (the tensor route); each route the larger of its
        operations' time and the bytes'.  Returns (bound, by, FMA route's bound)."""
        fma, fma_by = bound_ms(n_bytes, 2.0 * rows * edge_flops)
        t_bytes = n_bytes / PEAK_BYTES
        t_ops = (3 * 2.0 * rows * product_flops / PEAK_TF32_FLOPS
                 + 2.0 * rows * (edge_flops - product_flops) / PEAK_F32_FLOPS)
        tensor = max(t_bytes, t_ops) * 1e3
        if tensor > fma:
            return fma, fma_by, fma
        return tensor, ("bytes" if t_bytes >= t_ops else "operations"), fma

    k1_flops = 2.0 * B * N * N * edge_flops
    k1_bytes = 4.0 * (2 * B * N * He + B * N * N * 8 + B * N * N + weight_floats
                      + B * N * He + B * N * 3)
    k1_bound, k1_by, k1_bound_fma = f32_bound_ms(k1_bytes, B * N * N)
    print_errs("K1", k1_err)
    report("K1", t0, rtol=K1_RTOL, atol=K1_ATOL, ms=f"{k1_ms:.4f}", plain_ms=f"{k1_plain_ms:.4f}",
           bound_ms=f"{k1_bound:.4f}", bound_by=k1_by, bound_fma_ms=f"{k1_bound_fma:.4f}",
           gflop=f"{k1_flops / 1e9:.2f}", f64_ratio_max=f"{max(k1_f64.values()):.3f}")

    # ----------------------------------------------------------- 5. K1-bf16
    # the mixed-bf16 model's inputs: h in bf16 after the embedding, the block's
    # parameters cast to bf16 at use, the geometry f32
    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    wb = block.edge_weights(bf16)
    k1b_err = {}
    with torch.no_grad():
        hAb, hBb = block.node_terms(model.embedding(x).to(bf16))
        for name, mask in masks.items():
            check_close("K1-bf16", f"{name} mask",
                        EM.fused_egnn_messages(hAb, hBb, geom, mask, *wb),
                        EM.egnn_messages_plain(hAb, hBb, geom, mask, *wb), k1b_err,
                        BF16_RTOL, BF16_ATOL)
        # K1's cases beside the path shape: hA, hB x100, and small n (FC: the
        # first n nodes of the first sims, where the FC mask is 1 - eye too)
        small = [(f"hA, hB x{BIG_PRE:g}", (BIG_PRE * hAb[:4, :40], BIG_PRE * hBb[:4, :40],
                                           geom[:4, :40, :40], masks["fc"][:4, :40, :40]))]
        small += [(f"{bb}x{nn_} fc", (hAb[:bb, :nn_], hBb[:bb, :nn_], geom[:bb, :nn_, :nn_],
                                      masks["fc"][:bb, :nn_, :nn_])) for bb, nn_ in K1_BF16_SMALL]
        for label, args in small:
            args = tuple(t.contiguous() for t in args)
            check_close("K1-bf16", label, EM.fused_egnn_messages(*args, *wb),
                        EM.egnn_messages_plain(*args, *wb), k1b_err, BF16_RTOL, BF16_ATOL)
        mask = masks["fc"]
        k1b_f64 = {}
        check_f64("K1-bf16", "fc mask", EM.fused_egnn_messages, EM.egnn_messages_plain,
                  (hAb, hBb, geom, mask, *wb), k1b_f64)
        k1b_ms = cuda_ms(lambda: EM.fused_egnn_messages(hAb, hBb, geom, mask, *wb), iters=20)
        k1b_plain_ms = cuda_ms(lambda: EM.egnn_messages_plain(hAb, hBb, geom, mask, *wb), iters=5)
    repeat["K1-bf16"] = functools.partial(EM.fused_egnn_messages, hAb, hBb, geom, mask, *wb)
    # bf16 operands and agg, f32 geometry, mask and trans; the products at the
    # tensor cores' bf16 rate
    k1b_bytes = (2.0 * (2 * B * N * He + weight_floats + B * N * He)
                 + 4.0 * (B * N * N * 8 + B * N * N + B * N * 3))
    k1b_bound, k1b_by = bound_ms(k1b_bytes, k1_flops, PEAK_BF16_FLOPS)
    k1b_sfu = sfu_floor_ms(B * N * N)
    print_errs("K1-bf16", k1b_err)
    report("K1-bf16", t0, rtol=BF16_RTOL, atol=BF16_ATOL, ms=f"{k1b_ms:.4f}",
           ms_e8e28ee=PARENT_E8E28EE_K1_BF16_MS, plain_ms=f"{k1b_plain_ms:.4f}",
           bound_ms=f"{k1b_bound:.4f}", bound_by=k1b_by, sfu_floor_ms=f"{k1b_sfu:.4f}",
           sm_clock_mhz=sm_clock_mhz, gflop=f"{k1_flops / 1e9:.2f}",
           f64_ratio_max=f"{max(k1b_f64.values()):.3f}")

    def k3_inputs(bb: int, nn_: int):
        """A random scene's node data ``(pos0, vel, mass, coord)`` and its
        embedding ``h`` through the checkpoint's first layer."""
        pos0 = torch.randn((bb, nn_, 3), device=dev, generator=gen) * (nn_ / 5.0) ** (1 / 3)
        vel = torch.randn((bb, nn_, 3), device=dev, generator=gen)
        mass = torch.rand((bb, nn_, 1), device=dev, generator=gen) + 0.5
        coord = pos0 + 0.1 * torch.randn((bb, nn_, 3), device=dev, generator=gen)
        x = torch.cat([torch.linalg.vector_norm(vel, dim=-1, keepdim=True), mass], dim=-1)
        return model.embedding(x), (pos0, vel, mass, coord)

    # ---------------------------------------------------------------- 6. K3
    t0 = time.perf_counter()
    k3_err, k3_vs_k1_err, k3_f64 = {}, {}, {}
    with torch.no_grad():
        for bb, nn_, mask_names in K3_SHAPES:
            h, node = k3_inputs(bb, nn_)
            hA, hB = block.node_terms(h)
            pos0, vel, mass, coord = node
            for name in mask_names:
                mask = graph.knn_mask(pos0, nn_ - 1 if name == "fc" else 5).float()
                for nd in (True, False):
                    check_close("K3", f"{bb}x{nn_} {name} norm_diff={nd}",
                                ES.streaming_egnn_messages(hA, hB, *node, mask, *w, norm_diff=nd),
                                ES.streaming_egnn_messages_plain(hA, hB, *node, mask, *w,
                                                                 norm_diff=nd),
                                k3_err)
                if name == "fc" and (bb, nn_) in K3_F64_SHAPES:
                    check_f64("K3", f"{bb}x{nn_} fc", ES.streaming_egnn_messages,
                              ES.streaming_egnn_messages_plain, (hA, hB, *node, mask, *w), k3_f64)
            if (bb, nn_) == (1, 1000):
                sms = _build.sm_count(hA)
                k3_blocks = EM.launch_blocks(bb, nn_, sms)
                if k3_blocks < min(bb * nn_, sms):
                    fail(f"K3 at (1,1000) launches {k3_blocks} blocks on {sms} SMs")
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
            repeat["K3"] = functools.partial(ES.streaming_egnn_messages, hA, hB, *node, mask, *w)
            k3_b, k3_n = bb, nn_
        h, node = k3_inputs(2, 64)
        hA, hB = (BIG_PRE * t for t in block.node_terms(h))
        mask = graph.knn_mask(node[0], 63).float()
        check_close("K3", f"2x64 fc hA, hB x{BIG_PRE:g}",
                    ES.streaming_egnn_messages(hA, hB, *node, mask, *w),
                    ES.streaming_egnn_messages_plain(hA, hB, *node, mask, *w), k3_err)
    k3_flops = 2.0 * k3_b * k3_n * k3_n * edge_flops
    k3_bytes = 4.0 * (2 * k3_b * k3_n * He + k3_b * k3_n * 10 + k3_b * k3_n * k3_n
                      + weight_floats + k3_b * k3_n * (He + 3))
    k3_bound, k3_by, k3_bound_fma = f32_bound_ms(k3_bytes, k3_b * k3_n * k3_n)
    print_errs("K3", k3_err)
    print_errs("K3 vs K1", k3_vs_k1_err)
    report("K3", t0, rtol=K1_RTOL, atol=K1_ATOL, shape=f"B={k3_b},N={k3_n}", ms=f"{k3_ms:.4f}",
           plain_ms=f"{k3_plain_ms:.4f}", bound_ms=f"{k3_bound:.4f}", bound_by=k3_by,
           bound_fma_ms=f"{k3_bound_fma:.4f}", gflop=f"{k3_flops / 1e9:.2f}",
           f64_ratio_max=f"{max(k3_f64.values()):.3f}", blocks_1x1000=k3_blocks, sms=sms)

    # ---------------------------------------------------- 7. K3-bf16, K3-elem
    # the mixed-bf16 streaming model's two kernel forms: bf16 operands, and the
    # same with the bf16 elementwise stack (elem_bf16); and elem_bf16 with f32
    # operands, the third instantiation of the template (on no counted path)
    t0 = time.perf_counter()
    f32 = torch.float32
    k3b = {"K3-bf16": dict(op=bf16, elem=False), "K3-elem": dict(op=bf16, elem=True),
           "K3-elem f32 operands": dict(op=f32, elem=True)}
    for f in k3b.values():
        f["err"] = {}
    with torch.no_grad():
        for bb, nn_, mask_names in K3_BF16_SHAPES:
            h, node = k3_inputs(bb, nn_)
            operands = {op: (*block.node_terms(h.to(op)), block.edge_weights(op))
                        for op in (bf16, f32)}
            for name in mask_names:
                mask = graph.knn_mask(node[0], nn_ - 1 if name == "fc" else 5).float()
                for nd in (True, False):
                    for form, f in k3b.items():
                        hA_, hB_, w_ = operands[f["op"]]
                        check_close(
                            form, f"{bb}x{nn_} {name} norm_diff={nd}",
                            ES.streaming_egnn_messages(hA_, hB_, *node, mask, *w_, norm_diff=nd,
                                                       elem_bf16=f["elem"]),
                            ES.streaming_egnn_messages_plain(hA_, hB_, *node, mask, *w_,
                                                             norm_diff=nd, elem_bf16=f["elem"]),
                            f["err"], BF16_RTOL, BF16_ATOL)
                if name == "fc" and (bb, nn_) in K3_BF16_F64_SHAPES:
                    hA_, hB_, w_ = operands[bf16]
                    for form, f in k3b.items():
                        if f["op"] == bf16:
                            check_f64(form, f"{bb}x{nn_} fc", ES.streaming_egnn_messages,
                                      ES.streaming_egnn_messages_plain, (hA_, hB_, *node, mask, *w_),
                                      f.setdefault("f64", {}), elem_bf16=f["elem"])
            if (bb, nn_) != (k3_b, k3_n):
                continue
            mask = graph.knn_mask(node[0], nn_ - 1).float()
            for form, f in k3b.items():
                hA_, hB_, w_ = operands[f["op"]]
                args = (hA_, hB_, *node, mask, *w_)
                call = functools.partial(ES.streaming_egnn_messages, *args, elem_bf16=f["elem"])
                f["ms"] = cuda_ms(call, iters=10)
                f["plain_ms"] = cuda_ms(functools.partial(
                    ES.streaming_egnn_messages_plain, *args, elem_bf16=f["elem"]),
                    iters=3, warmup=1)
                repeat[form] = call
            del operands
        h, node = k3_inputs(2, 64)
        mask = graph.knn_mask(node[0], 63).float()
        for form, f in k3b.items():
            hA_, hB_ = (BIG_PRE * t for t in block.node_terms(h.to(f["op"])))
            w_ = block.edge_weights(f["op"])
            check_close(form, f"2x64 fc hA, hB x{BIG_PRE:g}",
                        ES.streaming_egnn_messages(hA_, hB_, *node, mask, *w_, elem_bf16=f["elem"]),
                        ES.streaming_egnn_messages_plain(hA_, hB_, *node, mask, *w_,
                                                         elem_bf16=f["elem"]),
                        f["err"], BF16_RTOL, BF16_ATOL)
    # bf16 operands and agg move half the bytes and run the products at the
    # tensor cores' rate; f32 operands run them on the CUDA cores, as K3 does
    k3b_bytes = (2.0 * (2 * k3_b * k3_n * He + weight_floats + k3_b * k3_n * He)
                 + 4.0 * (k3_b * k3_n * 10 + k3_b * k3_n * k3_n + k3_b * k3_n * 3))
    k3b_bound, k3b_by = bound_ms(k3b_bytes, k3_flops, PEAK_BF16_FLOPS)
    k3b_sfu = sfu_floor_ms(k3_b * k3_n * k3_n)
    k3b_s = time.perf_counter() - t0
    parent_ms = {"K3-bf16": PARENT_E8E28EE_K3_BF16_MS, "K3-elem": PARENT_E8E28EE_K3_ELEM_MS}
    for form, f in k3b.items():
        print_errs(form, f["err"])
        if f["op"] == bf16:
            extra = dict(ms_e8e28ee=parent_ms[form], bound_ms=f"{k3b_bound:.4f}", bound_by=k3b_by,
                         sfu_floor_ms=f"{k3b_sfu:.4f}", sm_clock_mhz=sm_clock_mhz,
                         f64_ratio_max=f"{max(f['f64'].values()):.3f}")
        else:
            extra = dict(bound_ms=f"{k3_bound:.4f}", bound_by=k3_by)
        report(form, t0, k3b_s, rtol=BF16_RTOL, atol=BF16_ATOL, shape=f"B={k3_b},N={k3_n}",
               ms=f"{f['ms']:.4f}", plain_ms=f"{f['plain_ms']:.4f}", **extra,
               gflop=f"{k3_flops / 1e9:.2f}")

    # ------------------------------------------------ helpers of the paths
    counters = {  # name -> (wrapper, attribute): every kernel form's launch count
        "k1": (EM.fused_egnn_messages, "launches"),
        "k1_bf16": (EM.fused_egnn_messages, "launches_bf16"),
        "k2": (gravity.acceleration, "launches"),
        "leapfrog": (gravity.leapfrog, "launches"),
        "k3": (ES.streaming_egnn_messages, "launches"),
        "k3_bf16": (ES.streaming_egnn_messages, "launches_bf16"),
        "k3_elem": (ES.streaming_egnn_messages, "launches_elem"),
    }

    def counts() -> dict:
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    def reset_counts() -> None:
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    class TimedDataset:
        """Times the GT generation that run_self_feed asks for, reads the launch
        counts at its end and keeps the GT ``(loc, vel, force, mass)``."""

        def __init__(self, ds):
            self.ds, self.target = ds, ds.target

        def get_ground_truth_trajectories(self, batch_size=None):
            t = time.perf_counter()
            self.gt = self.ds.get_ground_truth_trajectories(batch_size)
            sync()
            self.seconds = time.perf_counter() - t
            self.counts = counts()
            self.t_end = time.perf_counter()
            return self.gt

    def drive(model_, bb: int, nn_: int, substeps: int, seed: int, edge_kernel,
              train_mode: bool = False, rng=None, frames=None) -> dict:
        """One counted run of a path: fresh GT through K2, then the self-feed
        rollout over its first ``frames`` (all of the GT's where None), which
        must launch ``edge_kernel`` once per layer and step (a model without
        an edge stage: None, no kernel at all) and no other kernel.
        ``train_mode`` rolls out in training mode, a model with dropout
        drawing its masks from the seed ``rng``."""
        frames = frames or substeps // SAMPLE_FREQ
        ds = TimedDataset(otf.GravityDatasetOtf(
            batch_size=bb, sim_length=substeps, sample_freq=SAMPLE_FREQ, num_nodes=nn_,
            interaction_strength=G_CONST, softening=SOFTENING, seed=seed, device=dev,
        ))
        reset_counts()
        loc_gt, vel_gt, loc_pred, vel_pred, survived_min = self_feed.run_self_feed(
            model_, ds, num_steps=frames, train_mode=train_mode, rng=rng)
        sync()
        t_end = time.perf_counter()
        total = counts()
        if tuple(loc_gt.shape) != (bb, frames, nn_, 3) or not torch.isfinite(loc_gt).all():
            fail(f"GT trajectories bad at N={nn_}: shape {tuple(loc_gt.shape)}")
        edge_launches = sum(v for k, v in ds.counts.items() if k not in ("k2", "leapfrog"))
        if ds.counts["leapfrog"] != 1 or ds.counts["k2"] or edge_launches:
            fail(f"datagen at N={nn_} launched {ds.counts} (want one K2-leapfrog launch, "
                 "no K2, no edge kernel)")
        rolled = {k: total[k] - ds.counts[k] for k in total}
        want = dict.fromkeys(counters, 0)
        if edge_kernel is not None:
            want[edge_kernel] = LAYERS * (frames - 1)
        if rolled != want:
            fail(f"the rollout at N={nn_} launched {rolled}, want {want}")
        if tuple(loc_pred.shape) != (bb, frames, nn_, 3) or not torch.isfinite(loc_pred).all():
            fail(f"rollout bad at N={nn_}: shape {tuple(loc_pred.shape)} or non-finite")
        mass_ = torch.ones((bb, 1, nn_, 1), device=dev)
        _, _, energy = physics.energies(loc_gt, vel_gt, mass_, G_CONST, SOFTENING)  # [B, T]
        drift = ((energy[:, -1] - energy[:, 0]).abs() / energy[:, 0].abs()).double()
        print(f"[datagen] ok {ds.seconds:.4f} s B={bb} N={nn_} substeps={substeps} "
              f"frames={frames} leapfrog_launches={ds.counts['leapfrog']} "
              f"k2_launches={ds.counts['k2']} {launch_info(bb, nn_)} "
              f"energy_drift_rel_mean={drift.mean().item():.3e} max={drift.max().item():.3e}",
              flush=True)
        return dict(loc_gt=loc_gt, vel_gt=vel_gt, loc_pred=loc_pred, vel_pred=vel_pred,
                    survived_min=survived_min, seconds=t_end - ds.t_end, counts=total,
                    gt=ds.gt, target=ds.target)

    def same_gt(run: dict, ref: dict, tag: str) -> None:
        """A path that is compared with another runs from the same GT (same seed)."""
        if not (torch.equal(run["loc_gt"], ref["loc_gt"])
                and torch.equal(run["vel_gt"], ref["vel_gt"])):
            fail(f"{tag}: the GT drawn from the same seed differs from the f32 run's")

    def compare_paths(model_, loc_gt, vel_gt, plain_path, tag: str,
                      rtol: float = K1_RTOL, atol: float = K1_ATOL) -> dict:
        """The kernel path against the plain path, outside the counted run: one
        model call on GT frame 0, held to K1's tolerance (or the given one), then COMPARE_STEPS
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
        if not step_err <= atol + rtol * step_scale:
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
                "one_call_max_abs_out": f"{step_scale:.3e}",
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

    plain_k1 = lambda: mock.patch.object(EM, "fused_egnn_messages",  # noqa: E731
                                         EM.egnn_messages_plain)
    plain_k3 = lambda: mock.patch.object(ES, "streaming_egnn_messages",  # noqa: E731
                                         ES.streaming_egnn_messages_plain)

    def mixed(**kw):
        """The checkpoint in the mixed-bf16 model: parameters stay f32."""
        m = models.create_model("egnn_mc", device=dev, compute_dtype="bfloat16", **kw)
        m.load_state_dict(model.state_dict())
        return m.eval()

    # ---------------------------------------- 8 + 9. main path (counted), f32
    main = drive(model, B, N, SUBSTEPS, 0, "k1")
    main_counts = main["counts"]
    cmp = compare_paths(model, main["loc_gt"], main["vel_gt"], plain_k1, "rollout")
    report("rollout", 0.0, main["seconds"], steps=FRAMES - 1, layers=LAYERS,
           width=WIDTH, k1_launches=main["counts"]["k1"], survived_min=main["survived_min"],
           steps_per_s=f"{(FRAMES - 1) / main['seconds']:.2f}", **cmp)

    # ------------------------------------------------------------- 10. score
    score("score", main["loc_gt"], main["vel_gt"], main["loc_pred"], main["vel_pred"])

    # ------------------------------------------------------- 11. determinism
    # F1: the edge kernels sum in a fixed order, so a repeated launch and a
    # repeated rollout from the same GT are bitwise equal
    t0 = time.perf_counter()
    forms = ",".join(repeat)
    with torch.no_grad():
        for form, call in repeat.items():
            first, second = call(), call()
            sync()
            if not all(torch.equal(a, b) for a, b in zip(first, second)):
                fail(f"determinism: two launches of {form} on one input differ")
    del repeat
    loc_gt0, vel_gt0, force_gt0, mass0 = main["gt"]
    scene0 = Scene(pos=loc_gt0[:, 0], vel=vel_gt0[:, 0], force=force_gt0[:, 0], mass=mass0)
    loc2, vel2, surv2 = self_feed.make_rollout_fn(model, FRAMES, target=main["target"])(scene0)
    sync()
    if not (torch.equal(loc2, main["loc_pred"]) and torch.equal(vel2, main["vel_pred"])
            and int(surv2.min()) == main["survived_min"]):
        fail("determinism: the f32 rollout repeated from the same GT differs")
    del loc2, vel2
    report("determinism", t0, kernel_forms=repr(forms),
           launches_bitwise_equal=True, rollout_steps=FRAMES - 1, rollout_bitwise_equal=True,
           survived_min=main["survived_min"],
           k1_f32_ms=f"{k1_ms:.4f}", k1_f32_ms_8a96933=PARENT_8A96933_K1_MS,
           k3_f32_ms=f"{k3_ms:.4f}", k3_f32_ms_8a96933=PARENT_8A96933_K3_MS)

    # ------------------------------------------------------ 12. rollout-bf16
    # the mixed-bf16 model (the JAX package's pallas-mixed-bf16 config) on the
    # same GT, through K1-bf16 only (counted)
    model_bf = mixed()
    run = drive(model_bf, B, N, SUBSTEPS, 0, "k1_bf16")
    same_gt(run, main, "rollout-bf16")
    cmp = compare_paths(model_bf, run["loc_gt"], run["vel_gt"], plain_k1, "rollout-bf16",
                        BF16_RTOL, BF16_ATOL)
    bf16_counts = {"k1_bf16": run["counts"]["k1_bf16"]}
    report("rollout-bf16", 0.0, run["seconds"], steps=FRAMES - 1,
           k1_bf16_launches=run["counts"]["k1_bf16"], k1_launches=run["counts"]["k1"],
           survived_min=run["survived_min"], survived_min_f32=main["survived_min"],
           steps_per_s=f"{(FRAMES - 1) / run['seconds']:.2f}",
           steps_per_s_f32=f"{(FRAMES - 1) / main['seconds']:.2f}", **cmp)
    score("score-bf16", run["loc_gt"], run["vel_gt"], run["loc_pred"], run["vel_pred"])
    del run, model_bf, main

    # ------------------------------------------------------ 13. bign-rollout
    # the same checkpoint in the streaming model, at N=512 (counted)
    big_model = models.create_model("egnn_mc", device=dev, streaming=True)
    big_model.load_state_dict(model.state_dict())
    big_model.eval()
    big = drive(big_model, BIG_B, BIG_N, BIG_SUBSTEPS, 1, "k3")
    big_counts = big["counts"]
    cmp = compare_paths(big_model, big["loc_gt"], big["vel_gt"], plain_k3, "bign-rollout")
    report("bign-rollout", 0.0, big["seconds"], B=BIG_B, N=BIG_N,
           steps=BIG_FRAMES - 1, k3_launches=big_counts["k3"], k1_launches=big_counts["k1"],
           survived_min=big["survived_min"],
           steps_per_s=f"{(BIG_FRAMES - 1) / big['seconds']:.2f}", **cmp)
    score("bign-score", big["loc_gt"], big["vel_gt"], big["loc_pred"], big["vel_pred"])
    del big_model

    # ------------------------------------------------- 14. bign-rollout-bf16
    # the mixed-bf16 streaming model on the same GT, with the bf16 elementwise
    # stack (the JAX package's stream-mixed-ebf16, through K3-elem only) and
    # without it (stream-mixed-bf16, through K3-bf16 only), each counted
    for config, kw, kernel in (("stream-mixed-ebf16", dict(stream_elem_bf16=True), "k3_elem"),
                               ("stream-mixed-bf16", {}, "k3_bf16")):
        big_bf = mixed(streaming=True, **kw)
        run = drive(big_bf, BIG_B, BIG_N, BIG_SUBSTEPS, 1, kernel)
        same_gt(run, big, f"bign-rollout-bf16 {config}")
        cmp = compare_paths(big_bf, run["loc_gt"], run["vel_gt"], plain_k3,
                            f"bign-rollout-bf16 {config}", BF16_RTOL, BF16_ATOL)
        bf16_counts[kernel] = run["counts"][kernel]
        report("bign-rollout-bf16", 0.0, run["seconds"], config=config, B=BIG_B, N=BIG_N,
               steps=BIG_FRAMES - 1, **{f"{kernel}_launches": run["counts"][kernel]},
               k3_launches=run["counts"]["k3"], survived_min=run["survived_min"],
               survived_min_f32=big["survived_min"],
               steps_per_s=f"{(BIG_FRAMES - 1) / run['seconds']:.2f}",
               steps_per_s_f32=f"{(BIG_FRAMES - 1) / big['seconds']:.2f}", **cmp)
        score(f"bign-score-bf16 {config}", run["loc_gt"], run["vel_gt"], run["loc_pred"],
              run["vel_pred"])
        del run, big_bf

    # ------------------------------------------------- 14b. rollout-full-bf16
    # a full-bf16 scene (scene and parameters in bf16, the JAX package's
    # pallas-bf16-t64): the kernels take its geometry (K1) and node inputs (K3)
    # as float32, as the JAX wrappers cast them.  The checkpoint in bf16 on
    # [determinism]'s GT frame, FULL_BF16_STEPS counted steps through K1-bf16
    # alone, and in the streaming model on [bign-rollout]'s GT frame,
    # FULL_BF16_BIG_STEPS through K3-bf16 alone; each kernel given the bf16
    # inputs bitwise equal to it given the same values cast to float32 by hand
    t0 = time.perf_counter()
    bf = torch.bfloat16
    lg, vg, fg, mg = big["gt"]
    full_bf16_counts = dict.fromkeys(counters, 0)
    fb_info = {}
    for tag, kw, scene_fb, steps, kernel in (
            ("k1", {}, scene0.astype(bf), FULL_BF16_STEPS, "k1_bf16"),
            ("k3", dict(streaming=True),
             Scene(pos=lg[:, 0], vel=vg[:, 0], force=fg[:, 0], mass=mg).astype(bf),
             FULL_BF16_BIG_STEPS, "k3_bf16")):
        model_fb = models.create_model("egnn_mc", device=dev, **kw)
        model_fb.load_state_dict(model.state_dict())
        model_fb = model_fb.to(bf).eval()
        if any(p.dtype != bf for p in model_fb.parameters()):
            fail(f"rollout-full-bf16: the {tag} model's parameters are not all bf16")
        reset_counts()
        t = time.perf_counter()
        loc_fb, vel_fb, surv_fb = self_feed.make_rollout_fn(model_fb, steps + 1)(scene_fb)
        sync()
        roll_s = time.perf_counter() - t
        got_counts = counts()
        want = dict.fromkeys(counters, 0)
        want[kernel] = LAYERS * steps
        if got_counts != want:
            fail(f"rollout-full-bf16 ({tag}): launched {got_counts}, want {want}")
        if loc_fb.dtype != bf or not (torch.isfinite(loc_fb).all() and torch.isfinite(vel_fb).all()):
            fail(f"rollout-full-bf16 ({tag}): the rollout is {loc_fb.dtype} or not finite")
        for k, v in got_counts.items():
            full_bf16_counts[k] += v
        # layer 0's inputs on the scene, as the model makes them
        bb, nn_ = scene_fb.pos.shape[:2]
        layer = model_fb.layers[0]
        maskf = graph.knn_mask(scene_fb.pos, nn_ - 1).to(bf)
        with torch.no_grad():
            if tag == "k1":
                x, edge_attr = model_fb.featurize(scene_fb)
                hA, hB, geom = layer.edge_inputs(model_fb.embedding(x), scene_fb.pos, edge_attr)
                ins = (hA, hB, geom, maskf, *layer.edge_weights(bf))
                cast = (2,)
                fn = EM.fused_egnn_messages
            else:
                speed = torch.linalg.vector_norm(scene_fb.vel, dim=-1, keepdim=True)
                hA, hB = layer.node_terms(model_fb.embedding(torch.cat([speed, scene_fb.mass], -1)))
                ins = (hA, hB, scene_fb.pos, scene_fb.vel, scene_fb.mass, scene_fb.pos, maskf,
                       *layer.edge_weights(bf))
                cast = (2, 3, 4, 5)
                fn = ES.streaming_egnn_messages
            if any(ins[i].dtype != bf for i in cast) or hA.dtype != bf:
                fail(f"rollout-full-bf16 ({tag}): the scene's inputs are not bf16")
            got = fn(*ins, tanh=layer.tanh)
            by_hand = fn(*(t.float() if i in cast else t for i, t in enumerate(ins)),
                         tanh=layer.tanh)
        sync()
        if not (got[0].dtype == bf and got[1].dtype == torch.float32
                and all(torch.equal(a, b) for a, b in zip(got, by_hand))):
            fail(f"rollout-full-bf16 ({tag}): the kernel given bf16 inputs differs from it "
                 "given them cast to float32 by hand")
        fb_info[f"{tag}_B"], fb_info[f"{tag}_N"] = bb, nn_
        fb_info[f"{tag}_steps"], fb_info[f"{kernel}_launches"] = steps, got_counts[kernel]
        fb_info[f"{tag}_rollout_s"] = f"{roll_s:.3f}"
        fb_info[f"{tag}_survived_min"] = int(surv_fb.min())
        fb_info[f"{tag}_bitwise_hand_cast"] = True
        del model_fb, loc_fb, vel_fb
    # the trainer builds in bfloat16 with the kernel edge stage; double still raises
    class _FirstBatch(Exception):
        pass

    class _NoData:
        def get_batch(self):
            raise _FirstBatch

    for mode in ("bfloat16", "double"):
        targs, _ = config_mod.parse_args(["--trainer.precision_mode", mode])
        kernel_model = models.create_model("egnn_mc", device=dev, num_layers=1)
        try:
            trainer_mod.Trainer(kernel_model, _NoData(), targs, device=str(dev))
            fail(f"rollout-full-bf16: the trainer in {mode} drew no batch")
        except _FirstBatch:
            built = True
        except NotImplementedError:
            built = False
        if built != (mode == "bfloat16"):
            fail(f"rollout-full-bf16: precision_mode {mode} on the card "
                 f"{'built' if built else 'was refused'}")
        fb_info[f"trainer_{mode}"] = "builds" if built else "refused"
    report("rollout-full-bf16", t0, **fb_info)
    del big

    # --------------------------------------------------- 15. datagen-substeps
    # GT where simulate's rule takes the loop of K2 launches (counted), one a
    # substep and one for the first acceleration: past the integrator's shared
    # memory, and one sim of N=7264, which fits but runs faster through K2
    t0 = time.perf_counter()
    far_err, far_counts = 0.0, {}
    for nn_ in (FAR_N, FAR_RULE_N):
        if gravity.integrator_takes(FAR_B, nn_, sms):
            fail(f"simulate takes the integrator at B={FAR_B} N={nn_}: the path is not reached")
        far_ds = otf.GravityDatasetOtf(
            batch_size=FAR_B, sim_length=FAR_SUBSTEPS, sample_freq=SAMPLE_FREQ, num_nodes=nn_,
            interaction_strength=G_CONST, softening=SOFTENING, seed=3, device=dev)
        reset_counts()
        loc, vel, force, mass = far_ds.get_ground_truth_trajectories()
        sync()
        far_counts[nn_] = counts()
        want = dict.fromkeys(counters, 0)
        want["k2"] = 1 + FAR_SUBSTEPS
        if far_counts[nn_] != want:
            fail(f"datagen at N={nn_} launched {far_counts[nn_]}, want {want}")
        if tuple(loc.shape) != (FAR_B, FAR_SUBSTEPS // SAMPLE_FREQ, nn_, 3):
            fail(f"datagen at N={nn_}: shape {tuple(loc.shape)}")
        # frame 0 is the initial state: the plain loop from it
        plain = gravity.leapfrog_plain(loc[:, 0], vel[:, 0], mass, FAR_SUBSTEPS, SAMPLE_FREQ,
                                       G_CONST, SOFTENING, DT)
        for name, a, b_ in zip(("loc", "vel", "force"), (loc, vel, force), plain):
            err, scale = (a - b_).abs().max().item(), b_.abs().max().item()
            if not (torch.isfinite(a).all() and err <= LEAPFROG_RTOL * scale):
                fail(f"datagen at N={nn_}: {name} differs from the plain loop by {err} "
                     f"(max |plain| {scale}, rtol {LEAPFROG_RTOL})")
            far_err = max(far_err, err)
        print(f"  B={FAR_B} N={nn_}: k2_launches={far_counts[nn_]['k2']} "
              f"leapfrog_launches={far_counts[nn_]['leapfrog']}", flush=True)
        del loc, vel, force, mass, plain
    report("datagen-substeps", t0, B=FAR_B, N=f"{FAR_N},{FAR_RULE_N}", substeps=FAR_SUBSTEPS,
           k2_launches=far_counts[FAR_N]["k2"] + far_counts[FAR_RULE_N]["k2"],
           leapfrog_launches=far_counts[FAR_N]["leapfrog"] + far_counts[FAR_RULE_N]["leapfrog"],
           max_abs_err_vs_plain=f"{far_err:.3e}", rtol=LEAPFROG_RTOL)

    # ------------------------------------------------------------- 16. train
    # the trainer's path: create_trainer_from_args and Trainer.train(), in a
    # temporary working directory (runs/ and saved_simulations/ land there)

    def train_run(argv, tag: str, epochs: int, steps: int) -> dict:
        """Build the trainer from ``argv`` and train it, counted: its first GT
        batch through one K2-leapfrog launch, the steps through no kernel.
        Returns the trainer, each step's loss and the counts."""
        args, resolved = config_mod.parse_args(argv)
        cli.set_seed(args.seed)
        reset_counts()
        t = time.perf_counter()
        trainer = trainer_mod.create_trainer_from_args(args, resolved_config=resolved, device=dev)
        sync()
        init_s, init_counts = time.perf_counter() - t, counts()
        want = dict.fromkeys(counters, 0)
        want["leapfrog"] = 1  # the first training GT batch, drawn by the constructor
        if init_counts != want:
            fail(f"{tag}: the trainer's construction launched {init_counts}, want {want}")
        losses = []
        step = trainer._train_step

        def recorded(scene, y):
            vec = step(scene, y)
            losses.append(vec[0])
            return vec

        trainer._train_step = recorded
        count0 = trainer.optim.count
        reset_counts()
        t = time.perf_counter()
        trainer.train()
        sync()
        train_s, train_counts = time.perf_counter() - t, counts()
        trainer._train_step = step
        # GT batches drawn while training: PREFETCH frame pairs at a time, the
        # constructor's draw and every step's, T - 1 pairs a batch
        pairs = trainer.dataset.sim_length // trainer.dataset.sample_freq - 1
        prefetch = trainer.dataset.PREFETCH
        drawn = -(-(1 + epochs * steps) // prefetch) * prefetch
        want = dict.fromkeys(counters, 0)
        want["leapfrog"] = -(-drawn // pairs) - 1
        if train_counts != want:
            fail(f"{tag}: training launched {train_counts}, want {want} (the dense edge stage "
                 "launches no edge kernel, and new GT batches one K2-leapfrog each)")
        losses = torch.stack(losses).cpu()
        if len(losses) != epochs * steps or not torch.isfinite(losses).all():
            fail(f"{tag}: {len(losses)} step losses, finite: {bool(torch.isfinite(losses).all())}")
        with open(os.path.join(trainer.save_dir_path, "metrics.jsonl")) as f:
            epoch_losses = [r["train/loss"] for r in map(json.loads, f) if "train/loss" in r]
        if len(epoch_losses) != epochs or not all(np.isfinite(epoch_losses)):
            fail(f"{tag}: epoch losses {epoch_losses}")
        if trainer.optim.count != count0 + epochs * steps:
            fail(f"{tag}: AdamW took {trainer.optim.count - count0} updates, want {epochs * steps}")
        c = trainer.optim.count
        a = args
        noam = a.learning_rate * a.learning_rate_factor * trainer.model.get_model_size() ** -0.5 \
            * min(c ** -0.5, c * a.learning_rate_warmup_steps ** -1.5)
        lr = float(trainer.optim.lr)
        if not abs(lr - noam) <= 1e-6 * noam:
            fail(f"{tag}: learning rate {lr} after {c} updates, the Noam formula gives {noam}")
        ckpt = os.path.join(trainer.save_dir_path, "model.ckpt")
        back = weights.params_from_jax(weights.read_jax_checkpoint(ckpt))
        if not all(torch.equal(back[k], v.cpu()) for k, v in trainer.model.state_dict().items()):
            fail(f"{tag}: {ckpt} does not read back bitwise through params_from_jax")
        return dict(trainer=trainer, args=args, losses=losses, epoch_losses=epoch_losses,
                    init_s=init_s, train_s=train_s, count0=count0, count=c, lr=lr, noam=noam,
                    counts={k: init_counts[k] + train_counts[k] for k in counters})

    def time_steps(trainer, scene, y) -> dict:
        """ms a training step (CUDA events over TIMED_STEPS steps after a warm-up
        step) and the peak memory above what was allocated before them."""
        trainer._train_step(scene, y)
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        start_bytes = torch.cuda.memory_allocated(dev)
        ms = cuda_ms(lambda: trainer._train_step(scene, y), iters=TIMED_STEPS, warmup=0)
        peak = torch.cuda.max_memory_allocated(dev)
        return dict(ms=ms, steps_per_s=1e3 / ms, peak_mib=peak / 2**20,
                    peak_above_start_mib=(peak - start_bytes) / 2**20)

    def step_split(trainer, scene, y) -> dict:
        """One step cut at its forward (featurise, model, loss), backward and
        update, by CUDA events around each, averaged over TIMED_STEPS steps."""
        model, optim, loss_fn = trainer.model, trainer.optim, trainer.loss_fn
        mask = graph.knn_mask(scene.pos, trainer.num_neighbors)
        dense = {"edge_impl": "dense"} if models.has_edge_stage(model) else {}
        model.train()
        if models.needs_generator(model):
            dense["generator"] = trainer.generator
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        split = np.zeros(3)
        for _ in range(TIMED_STEPS):
            ev[0].record()
            loss, _ = loss_fn(model(scene, mask, **dense), scene, y)
            ev[1].record()
            optim.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            ev[2].record()
            optim.update()
            ev[3].record()
            ev[3].synchronize()
            split += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        return dict(zip(("forward_ms", "backward_ms", "update_ms"), split / TIMED_STEPS))

    def top_kernels(step, n: int = 6):
        """``(device busy ms a call of step(), its top kernels, kernels a
        call)`` over 3 calls, from torch.profiler's kernel events (user
        annotations left out), or None, why there is no such list, and
        None.  The first call probes the host's launch cost just before and
        just after its trace."""
        first = not any(where.endswith("first trace") for where, _ in probes)
        try:
            if first:
                launch_probe("before the first trace")
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(3):
                    step()
                sync()
            if first:
                launch_probe("after the first trace")
            by_name = collections.Counter()
            launches = 0
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
                    by_name[e.name] += e.time_range.elapsed_us()
                    launches += 1
            total = sum(by_name.values())
            if not total:
                return None, "not measured (the profiler saw no kernel)", None
            top = "; ".join(f"{k[:56]} {v / total:.1%}" for k, v in by_name.most_common(n))
            return total / 3e3, top, launches / 3
        except Exception as e:  # a profiler that cannot trace the card fails no phase
            return None, f"not measured ({type(e).__name__}: {e})", None

    def step_vs_cpu(tag: str, run: dict, payload, model_kw: dict, scene, y,
                    noise_only: tuple = (), zero_init: tuple = (), mask=None):
        """One training step on the card (f32) against the same step on the
        CPU in float64, from ``payload``'s parameters and AdamW state, on the
        first TRAIN_CMP_B sims of ``(scene, y)`` (their charges too, where the
        scene has them, and of ``mask``, the data's mask where the kNN mask
        is not the run's graph): each parameter within
        TRAIN_PARAM_RTOL of its largest value, each update within
        TRAIN_UPDATE_RTOL of its largest update.  A bias whose key ends with
        one of ``noise_only`` gets no gradient in exact arithmetic, so its
        step is AdamW's reading of rounding noise (float32 noise on the card,
        float64 noise on the CPU) and its update is printed, not held; its
        parameters are held within TRAIN_PARAM_RTOL of the largest value of
        the kernel it biases.  A tensor whose key ends with one of
        ``zero_init`` starts at zero in a fresh model, so after the run's
        steps its value is those steps' updates alone, and its parameter
        error, which is its update error (both sides start from the same
        parameters), is held by the update gate: within TRAIN_UPDATE_RTOL of
        its largest update.  Returns both errors and both losses."""
        trainer, a = run["trainer"], run["args"]
        sub = (Scene(*(t_[:TRAIN_CMP_B] for t_ in (scene.pos, scene.vel, scene.force,
                                                  scene.mass)),
                     charge=None if scene.charge is None else scene.charge[:TRAIN_CMP_B]),
               y[:TRAIN_CMP_B])
        after = []
        for where, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
            m = models.create_model(a.model_type, device=where, dtype=dtype, **model_kw)
            o = trainer_mod.create_optimizer(m.parameters(), learning_rate=a.learning_rate,
                                             model_size=m.get_model_size(),
                                             factor=a.learning_rate_factor,
                                             warmup=a.learning_rate_warmup_steps)
            trainer_mod.load_training_state(m, o, payload, a.model_type)
            before = {k: v.detach().cpu().double().clone() for k, v in m.state_dict().items()}
            step_fn, _ = trainer_mod.make_train_step(m, o, trainer.loss_fn, trainer.targets,
                                                     trainer.num_neighbors, dtype)
            sub_where = Scene(*(t_.to(where) for t_ in (sub[0].pos, sub[0].vel, sub[0].force,
                                                        sub[0].mass)),
                              charge=None if sub[0].charge is None else sub[0].charge.to(where))
            vec = step_fn(sub_where, sub[1].to(where),
                          None if mask is None else mask[:TRAIN_CMP_B].to(where))
            if not torch.isfinite(vec).all():
                fail(f"{tag}: the {where} step's metrics are not finite")
            after.append(({k: v.detach().cpu().double() for k, v in m.state_dict().items()},
                          before, float(vec[0])))
            del m, o
        (card_p, card_b, card_loss), (cpu_p, cpu_b, cpu_loss) = after
        p_err = up_err = noise_err = young_err = 0.0
        bad, decay_only = [], []
        for k, want_p in cpu_p.items():
            noise = bool(noise_only) and k.endswith(noise_only)
            # a tensor the loss never reaches stays zero with a zero update
            # (EquiformerV2's head bias adds to the l=0 row, which the output
            # does not read): its errors are held absolute, so they must be 0
            ref = cpu_p[k[:-len("bias")] + "kernel"] if noise else want_p
            scale = ref.abs().max().item() or 1.0
            e = (card_p[k] - want_p).abs().max().item() / scale
            du = (cpu_p[k] - cpu_b[k]).abs().max().item() or 1.0
            u = ((card_p[k] - card_b[k]) - (cpu_p[k] - cpu_b[k])).abs().max().item() / du
            young = bool(zero_init) and k.endswith(zero_init)
            if young:  # its whole value is the run's updates
                e = (card_p[k] - want_p).abs().max().item() / du
                young_err = max(young_err, e)
            decay = not noise and bool(
                ((cpu_p[k] - cpu_b[k]).abs() <= DECAY_ONLY_RTOL * cpu_b[k].abs()).all())
            if decay:  # held within two float32 ulps of the parameter, elementwise
                over = (((card_p[k] - card_b[k]) - (cpu_p[k] - cpu_b[k])).abs()
                        - 2 * F32_ULP * cpu_b[k].abs()).max().item()
                decay_only.append(k)
            if not (e <= (TRAIN_UPDATE_RTOL if young else TRAIN_PARAM_RTOL)
                    and (noise or (over <= 0 if decay else u <= TRAIN_UPDATE_RTOL))):
                bad.append(f"{k} by {e:.3e} of its largest {'update' if young else 'value'}"
                           + (" (of its kernel's)" if noise else
                              f" and its update by {over:.3e} past two float32 ulps" if decay
                              else f" and its update by {u:.3e}"))
            if not young:
                p_err = max(p_err, e)
            if noise:
                noise_err = max(noise_err, u)
            elif not decay:
                up_err = max(up_err, u)
        if bad:
            fail(f"{tag}: after one step on the card, against the CPU float64 step (limits "
                 f"{TRAIN_PARAM_RTOL}, {TRAIN_UPDATE_RTOL} of the largest update): "
                 + "; ".join(bad))
        if noise_only:
            print(f"  {tag}: the biases {noise_only} (no gradient in exact arithmetic): update "
                  f"differs by {noise_err:.3e} of the CPU's, not held", flush=True)
        if zero_init:
            print(f"  {tag}: the tensors that start at zero ({', '.join(zero_init)}): parameters "
                  f"within {young_err:.3e} of their largest update (limit {TRAIN_UPDATE_RTOL})",
                  flush=True)
        if decay_only:
            print(f"  {tag}: {len(decay_only)} tensors no output reads moved by their weight "
                  f"decay alone (under {DECAY_ONLY_RTOL} of themselves on the CPU): their card "
                  f"update within two float32 ulps: {', '.join(decay_only)}", flush=True)
        return p_err, up_err, card_loss, cpu_loss

    def busy_share(busy_ms, step_ms) -> str:
        if busy_ms is None:
            return "not measured"
        return f"{busy_ms:.3f} ms of {step_ms:.3f} ms a step (idle share {1 - busy_ms / step_ms:.1%})"

    t0 = time.perf_counter()
    train_counts = {}
    # kept until [ks-test] has ranked the run's checkpoint
    study_tmp = tempfile.TemporaryDirectory()
    with contextlib.chdir(study_tmp.name):
        tmp = study_tmp.name
        resume = ["--trainer.model_path", shutil.copy(CKPT, tmp)]
        run = train_run(resume + STUDY_ARGV, "train", STUDY_EPOCHS, STUDY_STEPS)
        trainer = run["trainer"]
        ckpt_count = run["count0"]
        if run["count"] != ckpt_count + STUDY_EPOCHS * STUDY_STEPS or trainer.step_count != 32:
            fail(f"train: resumed at count {ckpt_count}, epoch {trainer.step_count}")
        train_counts["train"] = run["counts"]
        # the evaluation, called directly (train() swallows an evaluation failure)
        gt_s = []
        get_gt = trainer.dataset.get_ground_truth_trajectories

        def timed_gt(batch_size=None):
            t = time.perf_counter()
            out = get_gt(batch_size)
            sync()
            gt_s.append(time.perf_counter() - t)
            return out

        trainer.dataset.get_ground_truth_trajectories = timed_gt
        roll_s = []
        run_self_feed = trainer_mod.run_self_feed

        def timed_rollout(*a, **k):
            t = time.perf_counter()
            out = run_self_feed(*a, **k)
            sync()
            roll_s.append(time.perf_counter() - t)
            return out

        reset_counts()
        t = time.perf_counter()
        with mock.patch.object(trainer_mod, "run_self_feed", timed_rollout):
            survived = trainer.run_self_feed_eval()
        sync()
        eval_s, eval_counts = time.perf_counter() - t, counts()
        trainer.dataset.get_ground_truth_trajectories = get_gt
        frames = int(STUDY_ARGV[STUDY_ARGV.index("--trainer.self_feed_limit_steps") + 1])
        want = dict.fromkeys(counters, 0)
        want["k1"], want["leapfrog"] = LAYERS * (frames - 1), 1
        if eval_counts != want:
            fail(f"train: the evaluation launched {eval_counts}, want {want}")
        train_counts["train_eval"] = eval_counts
        eval_dir = os.path.join(trainer.save_dir_path, "checkpoints", str(trainer.step_count))
        read = artifacts.read_macro_jsons(eval_dir)
        per, macro_p = ks.macro_ks_pvalues({k: v["ground truth"] for k, v in read.items()},
                                           {k: v["predicted"] for k, v in read.items()})
        with open(os.path.join(eval_dir, "nbody_macro_metrics.json")) as f:
            energy_p = json.load(f)["ks_pvalues"]["combined"]
        if not (0 <= survived <= frames - 1 and 0 < macro_p <= 1 and 0 < energy_p <= 1):
            fail(f"train: survived {survived}, macro combined p {macro_p}, energy p {energy_p}")
        study_run = dict(dir=os.path.abspath(trainer.save_dir_path), epoch=trainer.step_count,
                         macro_p=macro_p)
        rollout_s = roll_s[0] - gt_s[0]
        # one fixed batch for the timings and the card-against-CPU step
        scene, y = trainer.dataset.get_batch()
        timing = time_steps(trainer, scene, y)
        split = step_split(trainer, scene, y)
        busy_ms, kernels_top, _ = top_kernels(lambda: trainer._train_step(scene, y))

        p_err, up_err, card_loss, cpu_loss = step_vs_cpu(
            "train", run, weights.read_checkpoint(CKPT), {}, scene, y)
        del trainer, run["trainer"]
    study_s = time.perf_counter() - t0
    print(f"  train: {STUDY_EPOCHS} epochs x {STUDY_STEPS} steps, losses "
          f"{' '.join(f'{x:.5f}' for x in run['epoch_losses'])}; AdamW count "
          f"{run['count0']} -> {run['count']}, lr {run['lr']:.6e} (Noam {run['noam']:.6e})",
          flush=True)
    print(f"  train: step split {' '.join(f'{k}={v:.3f}' for k, v in split.items())}", flush=True)
    print(f"  train: device busy {busy_share(busy_ms, timing['ms'])}; top kernels: {kernels_top}",
          flush=True)
    print(f"  train: one step, card f32 vs CPU f64 on {TRAIN_CMP_B} sims: loss {card_loss:.8f} / "
          f"{cpu_loss:.8f}, params max rel err {p_err:.3e} (limit {TRAIN_PARAM_RTOL}), update "
          f"max rel err {up_err:.3e} (limit {TRAIN_UPDATE_RTOL})", flush=True)
    report("train", t0, study_s, B=16, N=N, layers=LAYERS, width=WIDTH,
           steps=STUDY_EPOCHS * STUDY_STEPS, k1_launches_training=train_counts["train"]["k1"],
           leapfrog_launches_training=train_counts["train"]["leapfrog"],
           train_s=f"{run['train_s']:.3f}", ms_per_step=f"{timing['ms']:.3f}",
           steps_per_s=f"{timing['steps_per_s']:.2f}", peak_mib=f"{timing['peak_mib']:.1f}",
           peak_above_start_mib=f"{timing['peak_above_start_mib']:.1f}",
           eval_s=f"{eval_s:.3f}", eval_rollout_steps=frames - 1,
           eval_k1_launches=eval_counts["k1"],
           eval_rollout_steps_per_s=f"{(frames - 1) / rollout_s:.2f}",
           gt_s=f"{gt_s[0]:.4f}", survived=survived, macro_combined_p=f"{macro_p:.3e}",
           energy_combined_p=f"{energy_p:.3e}", cmp_param_err=f"{p_err:.3e}",
           cmp_update_err=f"{up_err:.3e}")

    # ------------------------------------------------- 16b. orbax, 16c. fc-fast
    orbax_counts = _orbax_phase(dev, counters)

    # ---------------------------------------------------------- 17. train-n5
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        run = train_run(N5_ARGV, "train-n5", N5_EPOCHS, N5_STEPS)
        trainer = run["trainer"]
        train_counts["train_n5"] = run["counts"]
        scene, y = trainer.dataset.get_batch()
        timing_n5 = time_steps(trainer, scene, y)
        split_n5 = step_split(trainer, scene, y)
        busy_n5, top_n5, _ = top_kernels(lambda: trainer._train_step(scene, y))
        del trainer, run["trainer"]
    print(f"  train-n5: step split {' '.join(f'{k}={v:.3f}' for k, v in split_n5.items())}; "
          f"device busy {busy_share(busy_n5, timing_n5['ms'])}; top kernels: {top_n5}",
          flush=True)
    first10, last10 = run["losses"][:10].mean().item(), run["losses"][-10:].mean().item()
    report("train-n5", t0, B=64, N=5, layers=LAYERS, width=WIDTH,
           steps=N5_EPOCHS * N5_STEPS, loss_first10=f"{first10:.5f}",
           loss_last10=f"{last10:.5f}", k1_launches=run["counts"]["k1"],
           leapfrog_launches=run["counts"]["leapfrog"], train_s=f"{run['train_s']:.3f}",
           ms_per_step=f"{timing_n5['ms']:.3f}", steps_per_s=f"{timing_n5['steps_per_s']:.2f}",
           peak_mib=f"{timing_n5['peak_mib']:.1f}",
           peak_above_start_mib=f"{timing_n5['peak_above_start_mib']:.1f}")

    # ------------------------------------------- 18-19. floor-n100, floor-n512
    # the GT-vs-GT floor at the committed protocols, beside the committed
    # six-macro floors: datagen and scoring alone, no model
    eval_counts = {"rollout-full-bf16": full_bf16_counts, "orbax": orbax_counts}
    floor_dirs = tempfile.TemporaryDirectory()  # the floors' JSON and figure, for [viz]

    def counted(want: dict, tag: str) -> dict:
        got = counts()
        full = dict.fromkeys(counters, 0)
        full.update(want)
        if got != full:
            fail(f"{tag} launched {got}, want {full}")
        return got

    for tag, (fb, fn_, flen, fbatches, committed) in FLOORS.items():
        t0 = time.perf_counter()
        with open(os.path.join(FIDELITY, committed)) as f:
            ref = json.load(f)
        reset_counts()
        ds = otf.GravityDatasetOtf(batch_size=fb, num_nodes=fn_, sim_length=flen,
                                   cache_data=False, seed=FLOOR_SEED, device=dev)
        floor = studies.baseline_metamacros(ds, num_batches=fbatches,
                                            save_dir=os.path.join(floor_dirs.name, tag))
        sync()
        eval_counts[tag] = counted({"leapfrog": fbatches}, tag)
        comb = np.asarray(floor["combined_pvalues"])
        pairs = fbatches * (fbatches - 1) // 2
        if len(comb) != pairs or not np.all((comb > 0) & (comb <= 1)):
            fail(f"{tag}: {len(comb)} combined p-values (want {pairs}), range "
                 f"[{comb.min()}, {comb.max()}]")
        if not np.median(comb) >= FLOOR_MEDIAN_MIN:
            fail(f"{tag}: GT-vs-GT combined median {np.median(comb):.4g} below "
                 f"{FLOOR_MEDIAN_MIN}: the datagen or the scoring is broken")
        rc = np.asarray(ref["combined_pvalues"])
        for k, v in floor["per_macro"].items():
            r = ref["per_macro"][k]
            print(f"  {tag}: {k:22s} ks_p median {v['ks_p_median']:.4g} min {v['ks_p_min']:.4g}"
                  f" (committed {r['ks_p_median']:.4g} / {r['ks_p_min']:.4g})", flush=True)
        report(tag, t0, B=fb, N=fn_, sim_length=flen, batches=fbatches, pairs=pairs,
               combined_median=f"{np.median(comb):.4g}", combined_min=f"{comb.min():.4g}",
               combined_max=f"{comb.max():.4g}",
               committed_median=f"{np.median(rc):.4g}", committed_min=f"{rc.min():.4g}",
               committed_max=f"{rc.max():.4g}", leapfrog_launches=eval_counts[tag]["leapfrog"])

    # ----------------------------------------------- 20. battery (self-feed)
    # the committed checkpoint, untouched, in a run dir of the study protocol:
    # `cli self-feed --draws 3 --seed 281` in f32, each draw on the six-macro
    # basis (the JSON's) and the five-macro one of the committed batteries
    eval_tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    run_dir = battery.make_study_run_dir(os.path.join(eval_tmp.name, "egnn_n100"))
    with open(CKPT, "rb") as f:
        ckpt_bytes = f.read()
    reset_counts()
    summary = cli.main(["self-feed", "--run_dir", run_dir, "--draws", str(BATTERY_DRAWS),
                        "--seed", str(BATTERY_SEED)])
    sync()
    battery_s = time.perf_counter() - t0
    rollout_steps = int(battery.STUDY_RUN_ARGV[-1]) - 1
    eval_counts["battery"] = counted({"k1": BATTERY_DRAWS * LAYERS * rollout_steps,
                                      "leapfrog": BATTERY_DRAWS}, "battery")
    with open(os.path.join(run_dir, "model.ckpt"), "rb") as f:
        if f.read() != ckpt_bytes:
            fail("battery: the run dir's model.ckpt is not the committed checkpoint's bytes")
    with open(os.path.join(run_dir, "generated_trajectories", "self_feed_draws.json")) as f:
        written = json.load(f)
    with open(battery.COMMITTED[BATTERY_SEED]) as f:
        ref = json.load(f)
    if set(written) != set(ref) or any(set(d) != set(ref["draws"][0]) for d in written["draws"]):
        fail(f"battery: self_feed_draws.json keys {sorted(written)} / "
             f"{sorted(written['draws'][0])}, the JAX package's {sorted(ref)} / "
             f"{sorted(ref['draws'][0])}")
    b = battery.bases(written["draws"])
    if not all(0 <= p <= 1 for p in b["six"] + b["five"]):
        fail(f"battery: combined p outside [0, 1]: six {b['six']}, five {b['five']}")
    for i, (surv, six, five) in enumerate(zip(b["survived"], b["six"], b["five"])):
        print(f"  battery: draw {i} survived={surv} six-macro p={six:.4g} "
              f"five-macro p={five:.4g}", flush=True)
    port6, port5 = battery.spread(b["six"]), battery.spread(b["five"])
    ref5 = battery.spread(battery.committed(BATTERY_SEED)["five"])
    report("battery", t0, battery_s, draws=BATTERY_DRAWS, seed=BATTERY_SEED, B=16, N=N,
           steps=rollout_steps, s_per_draw=f"{battery_s / BATTERY_DRAWS:.3f}",
           six_best=f"{port6['best']:.4g}", six_median=f"{port6['median']:.4g}",
           six_worst=f"{port6['worst']:.4g}", five_best=f"{port5['best']:.4g}",
           five_median=f"{port5['median']:.4g}", five_worst=f"{port5['worst']:.4g}",
           survived=",".join(map(str, b["survived"])),
           committed_five_best=f"{ref5['best']:.4g}",
           committed_five_median=f"{ref5['median']:.4g}",
           committed_five_worst=f"{ref5['worst']:.4g}",
           committed_survived=",".join(str(d["steps_survived"]) for d in ref["draws"]),
           k1_launches=eval_counts["battery"]["k1"])

    # ----------------------------------------------------------- 21. validate
    t0 = time.perf_counter()
    reset_counts()
    valid = cli.main(["validate", "--run_dir", run_dir, "--batches", str(VALIDATE_BATCHES)])
    sync()
    eval_counts["validate"] = counted({"k1": VALIDATE_BATCHES * LAYERS, "leapfrog": 1},
                                      "validate")
    if not all(np.isfinite(v) for v in valid.values()):
        fail(f"validate: {valid}")
    report("validate", t0, batches=VALIDATE_BATCHES,
           **{k.replace(" ", "_"): f"{v:.6g}" for k, v in valid.items()},
           k1_launches=eval_counts["validate"]["k1"])

    # ---------------------------------------------------------- 22. ks-test
    t0 = time.perf_counter()
    ranked = cli.main(["ks-test", study_run["dir"]])
    written = [f for f in ("ks_results.csv", "ks_summary.json", "ks_results.png")
               if os.path.exists(os.path.join(study_run["dir"], f))]
    if len(written) != 3:
        study_tmp.cleanup()
        fail(f"ks-test: wrote {written} into the run dir, want ks_results.csv, "
             "ks_summary.json and ks_results.png")
    with open(os.path.join(study_run["dir"], "ks_summary.json")) as f:
        ks_written = json.load(f)  # [viz] draws its figures from it
    ks_png = viz_encode.read_png(os.path.join(study_run["dir"], "ks_results.png"))
    study_tmp.cleanup()
    if ks_png.shape != (600, 1000, 3) or not (ks_png != 255).any():
        fail(f"ks-test: ks_results.png is {ks_png.shape} or blank")
    rel = abs(ranked["best_combined_pvalue"] - study_run["macro_p"]) / study_run["macro_p"]
    if ranked["best_checkpoint"] != study_run["epoch"] or not rel <= KS_RTOL:
        fail(f"ks-test: best checkpoint {ranked['best_checkpoint']} p "
             f"{ranked['best_combined_pvalue']}, [train] scored checkpoint {study_run['epoch']} "
             f"at {study_run['macro_p']} (relative difference {rel:.3e}, limit {KS_RTOL})")
    report("ks-test", t0, checkpoints=ranked["num_checkpoints"],
           best_checkpoint=ranked["best_checkpoint"],
           best_combined_p=f"{ranked['best_combined_pvalue']:.6e}",
           train_macro_p=f"{study_run['macro_p']:.6e}", rel_diff=f"{rel:.3e}", limit=KS_RTOL)

    # ---------------------------------------------------------------- 22b. viz
    # the figures of a card rollout, drawn on the host with numpy and the
    # standard library: [battery]'s first draw (its GT and predicted
    # trajectories, written from the card's tensors), the figure functions
    # called directly (evaluate_rollout would swallow a rendering error),
    # `viz.cli --html --animate --extended` on the same arrays, the checkpoint
    # PDF of both PNG sets, the KS figures from [ks-test]'s JSON, and the
    # floor figure [floor-n100] drew beside its JSON
    t0 = time.perf_counter()
    reset_counts()
    draw_dir = os.path.join(run_dir, "generated_trajectories", "draw_00")
    folder = os.path.join(draw_dir, "trajectories_data")
    loc_a, vel_a, loc_p, vel_p = viz_cli.load_trajectories(folder)
    viz_root = os.path.join(eval_tmp.name, "viz")
    direct = os.path.join(viz_root, "checkpoints", "0")
    read = artifacts.read_macro_jsons(draw_dir)  # the draw's macros, as [battery] wrote them
    gt_m = {k: v["ground truth"] for k, v in read.items()}
    pred_m = {k: v["predicted"] for k, v in read.items()}
    figs = viz_plots.plot_macro_histograms(direct, gt_m, pred_m)
    figs += viz_plots.plot_trajectories_2d(direct, loc_a, loc_p)
    rows_ks = ks_written["results"]
    keys_ks = sorted({k for r in rows_ks for k in r if k not in ("checkpoint", "combined_pvalue")})
    figs += viz_plots.plot_pvalue_series(direct, [r["checkpoint"] for r in rows_ks],
                                         [r["combined_pvalue"] for r in rows_ks],
                                         {k: [r.get(k, float("nan")) for r in rows_ks]
                                          for k in keys_ks}, filename="ks_results.png")
    figs += viz_plots.save_figures(direct, [viz_plots.multi_model_figure(
        {"egnn_mc (study_n100)": rows_ks}, "ks_multi.png")])
    by_name = {f.filename: f for f in figs}
    # each histogram's counts are np.histogram's of the macros, on the pair's edges
    for field, (fname, _, bins) in viz_plots._MACRO_PLOTS.items():
        if field not in gt_m:
            continue
        g, p = (np.asarray(d[field], np.float64) for d in (gt_m, pred_m))
        lo = min(np.nanmin(g, initial=np.inf), np.nanmin(p, initial=np.inf))
        hi = max(np.nanmax(g, initial=-np.inf), np.nanmax(p, initial=-np.inf))
        lo, hi = (lo, hi) if np.isfinite(lo) and np.isfinite(hi) else (0.0, 1.0)
        edges = np.linspace(lo, hi if hi > lo else lo + 1.0, bins + 1)
        for panel, data in zip(by_name[fname].panels, (g, p)):
            want = np.histogram(data[np.isfinite(data)], edges)[0]
            if not (np.array_equal(panel.bars[0].edges, edges)
                    and np.array_equal(panel.bars[0].counts, want)):
                fail(f"viz: {fname}: the histogram is not np.histogram of the macro {field}")
    viz_cli.main(["--folder", folder, "--out", os.path.join(viz_root, "checkpoints", "1"),
                  "--html", "--animate", "--extended"])
    pdf = viz_traj.aggregate_checkpoint_plots_pdf(viz_root)
    viz_s = time.perf_counter() - t0
    # every expected file, each PNG decoded at its figure's size and not blank
    sizes = {name: f.size_px for name, f in by_name.items()}
    sizes.update({"trajectory_3d_actual.png": (800, 800), "trajectory_3d_pred.png": (800, 800),
                  "energy_statistics.png": (1200, 1200), "feature_distributions.png": (1400, 1000),
                  "difference_distributions.png": (1400, 1000),
                  "momentum_statistics_multiplot.png": (1000, 1000),
                  "energies_of_all_sims.png": (1200, 1000),
                  "energy_distributions_across_all_sims.png": (1600, 900)})
    cli_pngs = [n for n in sizes if n not in ("ks_results.png", "ks_multi.png")]
    floor_png = os.path.join(floor_dirs.name, "floor-n100", "baseline_metamacros.png")
    expected = ([os.path.join(direct, f.filename) for f in figs]
                + [os.path.join(viz_root, "checkpoints", "1", n) for n in cli_pngs
                   + ["trajectory.html"]]
                + [floor_png, os.path.join(viz_root, "checkpoint_plots.pdf")])
    movie = [os.path.join(viz_root, "checkpoints", "1", n)
             for n in ("trajectory.mp4", "trajectory.gif")]
    missing = [f for f in expected if not os.path.exists(f)]
    if missing or not any(os.path.exists(m) for m in movie) or pdf is None:
        fail(f"viz: missing {missing}, movie {movie}, pdf {pdf}")
    sizes["baseline_metamacros.png"] = (1200, 1400)
    for path in expected:
        if not path.endswith(".png"):
            continue
        img = viz_encode.read_png(path)
        w, h = sizes[os.path.basename(path)]
        if img.shape != (h, w, 3) or not (img != 255).any() or not (img != img[0, 0]).any():
            fail(f"viz: {path} decodes to {img.shape} (want {(h, w, 3)}) or is blank")
    with open(os.path.join(viz_root, "checkpoint_plots.pdf"), "rb") as f:
        pdf_pages = f.read().count(b"/Type /Page ")
    if pdf_pages != 4:
        fail(f"viz: the checkpoint PDF has {pdf_pages} pages, want 4")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("matplotlib", "PIL"))
    if loaded:
        fail(f"viz: {loaded} imported")
    eval_counts["viz"] = counted({}, "viz")
    if not viz_s < VIZ_MAX_S:
        fail(f"viz: {viz_s:.2f} s, over the limit of {VIZ_MAX_S} s")
    written_files = expected + [m for m in movie if os.path.exists(m)]
    names = [os.path.relpath(f, viz_root) if f.startswith(viz_root) else os.path.basename(f)
             for f in written_files]
    print("  viz files (bytes): " + " ".join(f"{n}={os.path.getsize(f)}"
                                            for n, f in zip(names, written_files)), flush=True)
    report("viz", t0, viz_s, B=loc_a.shape[0], N=loc_a.shape[2], T=loc_a.shape[1],
           files=len(written_files), bytes=sum(os.path.getsize(f) for f in written_files),
           pdf_pages=pdf_pages, movie=os.path.basename(next(m for m in movie if os.path.exists(m))),
           matplotlib_or_pil_loaded=False)
    floor_dirs.cleanup()

    # ------------------------------------------------------- 23. inferencer
    t0 = time.perf_counter()
    reset_counts()
    inf = inferencer.Inferencer(run_dir)
    scene_i, _ = inf.dataset.get_batch()
    out_k = inf.predict(scene_i)
    with torch.no_grad():
        out_p = inf.model(scene_i, graph.knn_mask(scene_i.pos, inf.num_neighbors),
                          edge_impl="dense")
    err, scale = (out_k - out_p).abs().max().item(), out_p.abs().max().item()
    if not err <= K1_ATOL + K1_RTOL * scale:
        fail(f"inferencer: predict differs from the plain path by {err} (max |out| {scale})")
    gt_i = inf.dataset.get_ground_truth_trajectories()

    class Served:
        target = inf.dataset.target

        def get_ground_truth_trajectories(self, batch_size=None):
            return gt_i

    _, _, loc_sf, vel_sf, surv_sf = self_feed.run_self_feed(inf.model, Served(),
                                                            num_steps=INF_STEPS)
    scene0 = Scene(pos=gt_i[0][:, 0], vel=gt_i[1][:, 0], force=gt_i[2][:, 0], mass=gt_i[3])
    loc_i, vel_i, surv_i = inf.rollout(scene0, INF_STEPS)
    sync()
    if not (torch.equal(loc_i, loc_sf) and torch.equal(vel_i, vel_sf) and surv_i == surv_sf):
        fail(f"inferencer: its {INF_STEPS}-step rollout is not run_self_feed's on the same "
             f"scene0 (max |dpos| {(loc_i - loc_sf).abs().max().item()})")
    # predict, then two rollouts of INF_STEPS - 1 steps; GT for the batch and for the rollouts
    eval_counts["inferencer"] = counted(
        {"k1": LAYERS * (1 + 2 * (INF_STEPS - 1)), "leapfrog": 2}, "inferencer")
    report("inferencer", t0, predict_max_abs_err=f"{err:.3e}", max_abs_out=f"{scale:.3e}",
           rtol=K1_RTOL, atol=K1_ATOL, rollout_steps=INF_STEPS, rollout="bitwise",
           survived=surv_i, k1_launches=eval_counts["inferencer"]["k1"])
    del inf
    eval_tmp.cleanup()

    # ---------------------------------------------------------------- 24. hpo
    # two param_small trials at the reference default (N=5, B=64), each one
    # epoch of 10 steps and a 20-step evaluation through K1
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        reset_counts()
        best = hpo.run_study("egnn_mc", trials=HPO_TRIALS, mode="param_small", study_dir="hpo",
                             train_epochs=1, steps_per_epoch=10,
                             self_feed_limit_steps=HPO_EVAL_STEPS, device=dev)
        sync()
        got = counts()
        with open(os.path.join("hpo", "egnn_mc_param_small_trials.jsonl")) as f:
            trials = [json.loads(line) for line in f]
        if not os.path.exists(os.path.join("hpo", "egnn_mc_param_small_summary.json")):
            fail("hpo: no study summary written")
    target = hpo.PARAM_TARGETS["param_small"]
    for t in trials:
        if not (t["status"] == "done" and np.isfinite(t["value"])
                and abs(t["n_params"] - target) <= hpo.PARAM_TOLERANCE * target):
            fail(f"hpo: trial {t}")
    k1_hpo = sum(t["model_kwargs"]["num_layers"] * (HPO_EVAL_STEPS - 1) for t in trials)
    others = {k: v for k, v in got.items() if k not in ("k1", "leapfrog")}
    # each trial draws its evaluation GT, and a training batch unless the
    # shared cache of the default config serves it
    if (len(trials) != HPO_TRIALS or got["k1"] != k1_hpo or any(others.values())
            or not HPO_TRIALS <= got["leapfrog"] <= 2 * HPO_TRIALS):
        fail(f"hpo: {len(trials)} trials launched {got}, want {k1_hpo} K1 launches")
    eval_counts["hpo"] = got
    for t in trials:
        print(f"  hpo: trial {t['number']} {t['model_kwargs']} n_params={t['n_params']} "
              f"value={t['value']:.4f} {t['seconds']:.2f} s steps_per_min="
              f"{t['steps_per_min']:.1f} peak_hbm_mb={t.get('peak_hbm_mb', float('nan')):.1f}",
              flush=True)
    report("hpo", t0, trials=len(trials), mode="param_small", best_value=f"{best['value']:.4f}",
           k1_launches=got["k1"], leapfrog_launches=got["leapfrog"])

    # --------------------------------------------------------- 24b. pipeline
    t0 = time.perf_counter()
    reset_counts()
    pipe_fields, pipe_launches = _pipeline_phase(LAYERS)
    if any(counts().values()):  # every launch of the phase is in its tools' processes
        fail(f"pipeline: this process launched {counts()}")
    eval_counts["pipeline"] = {**dict.fromkeys(counters, 0), **pipe_launches}
    report("pipeline", t0, **pipe_fields)

    # ------------------------------------- helpers of the families' paths
    def cpu64(s):
        return Scene(*(t_.detach().cpu().double() for t_ in (s.pos, s.vel, s.force, s.mass)))

    def fc(s):
        return graph.knn_mask(s.pos, s.pos.shape[1] - 1)

    def ref_frame(tag: str, seed: int):
        """A fresh GT batch at the reference workload (REF_B sims of REF_N
        bodies, REF_SUBSTEPS substeps) through one K2-leapfrog launch and no
        other kernel: its first frame as a scene on the card, and the
        launch counts."""
        reset_counts()
        gt_ = otf.GravityDatasetOtf(
            batch_size=REF_B, sim_length=REF_SUBSTEPS, sample_freq=SAMPLE_FREQ, num_nodes=REF_N,
            interaction_strength=G_CONST, softening=SOFTENING, seed=seed,
            device=dev).get_ground_truth_trajectories()
        sync()
        got = counted({"leapfrog": 1}, tag)
        return Scene(pos=gt_[0][:, 0], vel=gt_[1][:, 0], force=gt_[2][:, 0], mass=gt_[3]), got

    def fresh_pair(family: str, kw: dict, seed: int, want: int):
        """A fresh model of ``family`` from ``seed`` in float64 on the CPU and
        the same parameters in float32 on the card, both in eval mode; its
        parameter count, by the model and by hpo's meta-device count, must be
        ``want``."""
        torch.manual_seed(seed)
        cpu_m = models.create_model(family, device="cpu", dtype=torch.float64, **kw).eval()
        card_m = models.create_model(family, device=dev, **kw).eval()
        card_m.load_state_dict(cpu_m.state_dict())
        got = (models.count_params(card_m), hpo._count_params(family, kw, REF_N))
        if got != (want, want):
            fail(f"{family}: {got[0]} parameters ({got[1]} by hpo), want {want}")
        return card_m, cpu_m

    def forward_vs_cpu(tag: str, card_m, cpu_m, s, rtol: float):
        """``card_m``'s forward on ``s`` against ``cpu_m``'s in float64 on the
        CPU, within ``rtol`` of the largest output: ``(card output, CPU
        output, error, largest output)``."""
        s_c = cpu64(s)
        with torch.no_grad():
            out_k, out_c = card_m(s, fc(s)), cpu_m(s_c, fc(s_c))
        err, scale = (out_k.double().cpu() - out_c).abs().max().item(), out_c.abs().max().item()
        if not (torch.isfinite(out_k).all() and err <= rtol * scale):
            fail(f"{tag}: the card's forward differs from the CPU's float64 one by {err} "
                 f"(max |out| {scale}, rtol {rtol})")
        return out_k, out_c, err, scale

    def proper_rotation(seed: int):
        """A rotation (no reflection), float64 on the host, from a seed."""
        q, r = torch.linalg.qr(torch.randn((3, 3), generator=torch.Generator().manual_seed(seed),
                                           dtype=torch.float64))
        R_ = q * torch.sign(torch.diagonal(r))
        return R_ if torch.det(R_) > 0 else -R_

    def turn_scene(s, R_):
        return Scene(pos=s.pos @ R_.T, vel=s.vel @ R_.T, force=s.force @ R_.T, mass=s.mass)

    def turn_out(o, R_):
        return torch.cat([o[..., :3] @ R_.T, o[..., 3:] @ R_.T], dim=-1)

    def check_moves(tag: str, model_, s, out, rtol: float, rotation=None) -> dict:
        """On the card: a shift of the scene leaves the output as it was, a
        permutation of its 5 bodies permutes it, and ``rotation`` (where
        given) turns both output vectors, each within ``rtol`` of the largest
        output.  Returns each move's largest error."""
        perm = torch.tensor([3, 0, 4, 1, 2], device=dev)
        moves = {"trans": (Scene(pos=s.pos + torch.tensor([1.5, -0.5, 2.0], device=dev),
                                 vel=s.vel, force=s.force, mass=s.mass), out),
                 "perm": (Scene(pos=s.pos[:, perm], vel=s.vel[:, perm], force=s.force[:, perm],
                                mass=s.mass[:, perm]), out[:, perm])}
        if rotation is not None:
            R_ = rotation.float().to(dev)
            moves["rot"] = (turn_scene(s, R_), turn_out(out, R_))
        errs = {}
        for name, (moved, want_m) in moves.items():
            with torch.no_grad():
                got_m = model_(moved, fc(moved))
            errs[name] = (got_m - want_m).abs().max().item()
            if not (torch.isfinite(got_m).all()
                    and errs[name] <= rtol * want_m.abs().max().item()):
                fail(f"{tag}: {name} off by {errs[name]} (max |out| "
                     f"{want_m.abs().max().item()}, rtol {rtol})")
        return errs

    def family_rollout(family: str, model_, cpu_model, bb: int, nn_: int, substeps: int,
                       seed: int, cmp_b: int, rtol: float, nudge_factor: float,
                       train_mode: bool = False, dropout_seed=None) -> dict:
        """A family's rollout from GT at the reference workload (one
        K2-leapfrog launch): the counted self-feed rollout over its first
        REPEAT_FRAMES (no kernel; in training mode with ``train_mode``,
        dropout masks from ``dropout_seed``; the family's battery rolls all
        999 steps), the six-macro score; COMPARE_STEPS eval-mode steps on the
        card against the CPU's float64 on the first ``cmp_b`` sims, within
        ``rtol`` of the largest position, or ``nudge_factor`` times the spread
        a 1e-7 nudge of frame 0 gives the CPU alone where that is larger; the
        rollout repeated from the same GT (and dropout seed) bitwise equal,
        and timed warm.  Returns the phase's fields."""
        tag, frames = f"{family}-rollout", REPEAT_FRAMES
        run_f = drive(model_, bb, nn_, substeps, seed, None, train_mode, dropout_seed, frames)
        eval_counts[f"{family}_rollout"] = run_f["counts"]
        model_.eval()
        score(f"{family}-score", run_f["loc_gt"], run_f["vel_gt"], run_f["loc_pred"],
              run_f["vel_pred"])
        loc0, vel0, force0, mass0 = run_f["gt"]
        sub = Scene(pos=loc0[:cmp_b, 0], vel=vel0[:cmp_b, 0], force=force0[:cmp_b, 0],
                    mass=mass0[:cmp_b])
        sub_c = cpu64(sub)
        nudged = Scene(pos=sub_c.pos * (1 + 1e-7), vel=sub_c.vel, force=sub_c.force,
                       mass=sub_c.mass)
        loc_k, _, surv_k = self_feed.make_rollout_fn(model_, COMPARE_STEPS + 1)(sub)
        short_c = self_feed.make_rollout_fn(cpu_model, COMPARE_STEPS + 1)
        loc_c, _, surv_c = short_c(sub_c)
        loc_n, _, _ = short_c(nudged)
        d_kc = (loc_k.double().cpu() - loc_c).abs().max().item()
        d_nc = (loc_n - loc_c).abs().max().item()
        pos_scale = loc_c.abs().max().item()
        limit = max(rtol * pos_scale, nudge_factor * d_nc)
        if not (torch.isfinite(loc_k).all() and d_kc <= limit):
            fail(f"{tag}: {COMPARE_STEPS} steps on the card differ from the CPU's float64 ones "
                 f"by {d_kc} (limit {limit}; max |pos| {pos_scale}, nudged spread {d_nc})")
        model_.train(train_mode)
        rollout_f = self_feed.make_rollout_fn(model_, REPEAT_FRAMES, target=run_f["target"])
        scene0 = Scene(pos=loc0[:, 0], vel=vel0[:, 0], force=force0[:, 0], mass=mass0)
        reset_counts()
        t = time.perf_counter()
        loc2, vel2, _ = rollout_f(scene0, dropout_seed)
        sync()
        warm_s = time.perf_counter() - t
        counted({}, f"{tag} (repeated)")
        if not (torch.equal(loc2, run_f["loc_pred"]) and torch.equal(vel2, run_f["vel_pred"])):
            fail(f"{tag}: the {REPEAT_FRAMES - 1} steps repeated from the same GT differ")
        model_.eval()
        return dict(B=bb, N=nn_, steps=frames - 1, train_mode=train_mode,
                    dropout_seed=dropout_seed, leapfrog_launches=run_f["counts"]["leapfrog"],
                    rollout_s=f"{run_f['seconds']:.3f}", survived_min=run_f["survived_min"],
                    steps_per_s_first=f"{(frames - 1) / run_f['seconds']:.2f}",
                    steps_per_s_warm=f"{(REPEAT_FRAMES - 1) / warm_s:.2f}",
                    ms_per_step_warm=f"{warm_s * 1e3 / (REPEAT_FRAMES - 1):.3f}",
                    repeat_steps_bitwise_equal=REPEAT_FRAMES - 1,
                    **{f"max_dpos_{COMPARE_STEPS}_steps_card_vs_cpu64": f"{d_kc:.3e}",
                       "max_abs_pos": f"{pos_scale:.3e}", "max_dpos_nudged_cpu64": f"{d_nc:.3e}",
                       "cmp_sims": cmp_b,
                       "survived_min_card/cpu64": f"{int(surv_k.min())}/{int(surv_c.min())}"})

    def family_battery(family: str, ckpt: str, draws: int, frames: int, argv=None):
        """`cli self-feed --draws D --seed BATTERY_SEED --steps frames` on a
        run dir of the family's queue ``argv`` around the checkpoint ``ckpt``
        (the run dir that holds ``ckpt`` where ``argv`` is None), whose
        model.ckpt is ``ckpt``'s bytes after it: D K2-leapfrog launches and no
        other kernel; each draw's survived and combined p on the six- and
        five-macro bases, six-macro p in (0, 1].  Returns ``(seconds, the
        phase's fields)``."""
        tag = f"battery-{family}"
        t0 = time.perf_counter()
        with open(ckpt, "rb") as f:
            ckpt_bytes = f.read()
        with tempfile.TemporaryDirectory() as tmp:
            run_dir_f = (os.path.dirname(ckpt) if argv is None
                         else restore.make_run_dir(os.path.join(tmp, f"{family}10m"), argv, ckpt))
            reset_counts()
            cli.main(["self-feed", "--run_dir", run_dir_f, "--draws", str(draws),
                      "--seed", str(BATTERY_SEED), "--steps", str(frames)])
            sync()
            seconds = time.perf_counter() - t0
            eval_counts[f"battery_{family}"] = counted({"leapfrog": draws}, tag)
            with open(os.path.join(run_dir_f, "model.ckpt"), "rb") as f:
                if f.read() != ckpt_bytes:
                    fail(f"{tag}: the run dir's model.ckpt is not {ckpt}'s bytes")
            del ckpt_bytes
            with open(os.path.join(run_dir_f, "generated_trajectories",
                                   "self_feed_draws.json")) as f:
                drawn = json.load(f)["draws"]
        b = battery.bases(drawn)
        if (len(drawn) != draws or not all(0 < p <= 1 for p in b["six"])
                or not all(0 <= p <= 1 for p in b["five"])
                or not all(0 <= s_ <= frames - 1 for s_ in b["survived"])):
            fail(f"{tag}: {len(drawn)} draws, six {b['six']}, five {b['five']}, "
                 f"survived {b['survived']}")
        for i, (surv, six, five) in enumerate(zip(b["survived"], b["six"], b["five"])):
            print(f"  {tag}: draw {i} survived={surv} six-macro p={six:.4g} "
                  f"five-macro p={five:.4g}", flush=True)
        p6, p5 = battery.spread(b["six"]), battery.spread(b["five"])
        return seconds, dict(
            draws=draws, seed=BATTERY_SEED, steps=frames - 1, s_per_draw=f"{seconds / draws:.3f}",
            six_best=f"{p6['best']:.4g}", six_median=f"{p6['median']:.4g}",
            six_worst=f"{p6['worst']:.4g}", five_best=f"{p5['best']:.4g}",
            five_median=f"{p5['median']:.4g}", five_worst=f"{p5['worst']:.4g}",
            survived=",".join(map(str, b["survived"])),
            leapfrog_launches=eval_counts[f"battery_{family}"]["leapfrog"])

    def key_shapes(tree, prefix=()) -> set:
        if isinstance(tree, dict):
            return set().union(*(key_shapes(v, prefix + (k,)) for k, v in tree.items()))
        if type(tree) is tuple:
            return set().union(*(key_shapes(v, prefix + (i,)) for i, v in enumerate(tree)))
        return {(prefix, np.shape(tree))}

    def family_train(family: str, ckpt, argv, payload, epoch: int, count: int,
                     n_params: int, extra=None, workdir=None):
        """The train command with a family's queue argv at the reference
        workload, resumed from its committed checkpoint ``ckpt`` (read as
        ``payload``; epoch ``epoch``, AdamW count ``count``), or from a fresh
        initialisation where ``ckpt`` is None: FAMILY_TRAIN_EPOCHS epochs of
        FAMILY_TRAIN_STEPS steps; the checkpoint it wrote read back bitwise
        (``train_run``) and in the JAX layout (params, AdamW's mu and nu with
        the keys and shapes of ``params_to_jax`` of the model, PONITA's calib
        included, and of the committed checkpoint where there is one; its
        count the run's); its self-feed evaluation (FAMILY_EVAL_FRAMES - 1
        steps, one K2-leapfrog launch) and KS score; step ms, the step's
        split, busy share and peak memory.  ``extra(run, scene, y)`` runs on
        the trainer before it is dropped.  Then a second run of
        FAMILY_AFTER_STEPS steps, every loss finite: after a resumed run a
        fresh initialisation; after a fresh run a resume from a copy of the
        checkpoint it wrote, with another dataloader seed, whose AdamW count
        and epoch go on from the saved ones and whose statistics that are no
        parameter (PONITA's calibration) stay the saved ones.  The runs are
        made in ``workdir`` (a temporary directory where None).  Returns the
        phase's fields, ``extra``'s result, the second run's model and the
        first run's directory."""
        tag = f"train-{family}"
        frames = FAMILY_EVAL_FRAMES
        common = ["--trainer.save_model_every", "1", "--trainer.test_macros_every", "1000",
                  "--trainer.self_feed_limit_steps", str(frames)]
        with contextlib.ExitStack() as stack:
            if workdir is None:
                workdir = stack.enter_context(tempfile.TemporaryDirectory())
            stack.enter_context(contextlib.chdir(workdir))
            if ckpt is None:
                start = ["--trainer.train_steps", str(FAMILY_TRAIN_EPOCHS), "--trainer.seed", "0"]
            else:
                start = ["--trainer.model_path", shutil.copy(ckpt, workdir),
                         "--trainer.train_steps", str(epoch + FAMILY_TRAIN_EPOCHS)]
            run = train_run(start + argv + common + [
                "--dataloader.seed", "0", "--trainer.steps_per_epoch", str(FAMILY_TRAIN_STEPS),
                "--trainer.run_name", f"{family}10m"], tag, FAMILY_TRAIN_EPOCHS,
                FAMILY_TRAIN_STEPS)
            trainer = run["trainer"]
            if run["count0"] != count or trainer.step_count != epoch + FAMILY_TRAIN_EPOCHS:
                fail(f"{tag}: started at count {run['count0']}, epoch {trainer.step_count}")
            if trainer.n_params != n_params:
                fail(f"{tag}: n_params {trainer.n_params}, want {n_params}")
            train_counts[f"train_{family}"] = run["counts"]
            run_dir_f = os.path.abspath(trainer.save_dir_path)
            saved = os.path.join(run_dir_f, "model.ckpt")
            written = weights.read_checkpoint(saved)
            w_count, w_mu, w_nu = weights._find_adam(written["opt_state"])
            layout = key_shapes(weights.params_to_jax(trainer.model.state_dict()))
            if not (key_shapes(written["params"]) == layout
                    and key_shapes(w_mu) == layout and key_shapes(w_nu) == layout
                    and (payload is None or key_shapes(payload["params"]) == layout)
                    and int(w_count) == run["count"]):
                fail(f"{tag}: the written checkpoint's params / mu / nu / count leave the JAX "
                     "layout of the model" + ("" if payload is None else
                                              " and of the committed checkpoint"))
            del written
            reset_counts()
            t = time.perf_counter()
            survived = trainer.run_self_feed_eval()
            sync()
            eval_s_f = time.perf_counter() - t
            train_counts[f"train_{family}_eval"] = counted({"leapfrog": 1}, f"{tag} evaluation")
            eval_dir = os.path.join(run_dir_f, "checkpoints", str(trainer.step_count))
            read = artifacts.read_macro_jsons(eval_dir)
            _, macro_p_f = ks.macro_ks_pvalues({k: v["ground truth"] for k, v in read.items()},
                                               {k: v["predicted"] for k, v in read.items()})
            with open(os.path.join(eval_dir, "nbody_macro_metrics.json")) as f:
                energy_ps = json.load(f)["ks_pvalues"]
            energy_p_f = energy_ps.pop("combined")
            # an energy series whose values never meet GT's gives a KS p that
            # underflows to 0; Fisher drops p = 0, so the combine of three such
            # p is NaN ("no data"), in the JAX trainer too
            energy_ok = all(0 <= p <= 1 for p in energy_ps.values()) and (
                0 < energy_p_f <= 1 or (energy_p_f != energy_p_f and not any(energy_ps.values())))
            if not (0 <= survived <= frames - 1 and 0 < macro_p_f <= 1 and energy_ok):
                fail(f"{tag}: survived {survived}, macro p {macro_p_f}, energy p "
                     f"{energy_p_f} ({energy_ps})")
            scene, y = trainer.dataset.get_batch()
            timing_f = time_steps(trainer, scene, y)
            split_f = step_split(trainer, scene, y)
            busy_f, top_f, _ = top_kernels(lambda: trainer._train_step(scene, y))
            more = extra(run, scene, y) if extra else None
            del trainer, run["trainer"]

            # the second run in a directory of its own: a GT cache of the first
            # run's would serve its first batch
            kind = "resumed" if ckpt is None else "fresh"
            os.makedirs(kind)
            stack.enter_context(contextlib.chdir(kind))
            if ckpt is None:
                after_argv = ["--trainer.model_path", os.path.abspath(shutil.copy(saved, ".")),
                              "--trainer.train_steps", str(FAMILY_TRAIN_EPOCHS + 1),
                              "--dataloader.seed", str(RESUME_DATA_SEED)]
            else:
                after_argv = ["--trainer.train_steps", "1", "--trainer.seed", "0",
                              "--dataloader.seed", "0"]
            after = train_run(after_argv + argv + common + [
                "--trainer.steps_per_epoch", str(FAMILY_AFTER_STEPS),
                "--trainer.run_name", kind], f"{tag}-{kind}", 1, FAMILY_AFTER_STEPS)
            train_counts[f"train_{family}_{kind}"] = after["counts"]
            after_trainer = after.pop("trainer")
            after_model, after_epoch = after_trainer.model, after_trainer.step_count
            del after_trainer
            kept = 0
            if ckpt is None:
                if (after["count0"] != run["count"] or after_epoch != FAMILY_TRAIN_EPOCHS + 1):
                    fail(f"{tag}-resumed: AdamW count {after['count0']}, epoch {after_epoch} "
                         f"after resuming at the saved count {run['count']}, epoch "
                         f"{FAMILY_TRAIN_EPOCHS}")
                back = weights.params_from_jax(weights.read_jax_checkpoint(saved))
                names = {k for k, _ in after_model.named_parameters()}
                stats = {k: v for k, v in after_model.state_dict().items() if k not in names}
                if not all(torch.equal(v.cpu(), back[k]) for k, v in stats.items()):
                    fail(f"{tag}-resumed: statistics that are no parameter differ from the saved "
                         "checkpoint's: recomputed on the resumed run's first batch")
                kept = len(stats)
        print(f"  {tag}: losses {' '.join(f'{x:.5f}' for x in run['epoch_losses'])}; AdamW count "
              f"{run['count0']} -> {run['count']}, lr {run['lr']:.6e} (Noam {run['noam']:.6e}); "
              f"step split {' '.join(f'{k}={v:.3f}' for k, v in split_f.items())}; device busy "
              f"{busy_share(busy_f, timing_f['ms'])}; top kernels: {top_f}", flush=True)
        fields = dict(
            steps=FAMILY_TRAIN_EPOCHS * FAMILY_TRAIN_STEPS, resumed=ckpt is not None,
            leapfrog_launches_training=train_counts[f"train_{family}"]["leapfrog"],
            train_s=f"{run['train_s']:.3f}", ms_per_step=f"{timing_f['ms']:.3f}",
            steps_per_s=f"{timing_f['steps_per_s']:.2f}", peak_mib=f"{timing_f['peak_mib']:.1f}",
            peak_above_start_mib=f"{timing_f['peak_above_start_mib']:.1f}",
            busy_ms=("not measured" if busy_f is None else f"{busy_f:.3f}"),
            eval_s=f"{eval_s_f:.3f}", eval_rollout_steps=frames - 1, survived=survived,
            macro_combined_p=f"{macro_p_f:.3e}", energy_combined_p=f"{energy_p_f:.3e}",
            energy_p="[" + " ".join(f"{k}={v:.3e}" for k, v in energy_ps.items()) + "]",
            checkpoint="bitwise, JAX layout" + (" with calib" if family == "ponita" else ""))
        if ckpt is None:
            fields.update(resumed_steps=FAMILY_AFTER_STEPS,
                          resumed_count=f"{after['count0']}->{after['count']}",
                          resumed_epoch=FAMILY_TRAIN_EPOCHS + 1, resumed_kept_stats=kept)
        else:
            fields.update(fresh_steps=FAMILY_AFTER_STEPS)
        fields.update(after_loss_first=f"{after['losses'][0].item():.5f}",
                      after_loss_last=f"{after['losses'][-1].item():.5f}")
        return fields, more, after_model, run_dir_f

    def written(run_) -> dict:
        """The checkpoint a run of ``train_run`` wrote, read back."""
        return weights.read_checkpoint(os.path.join(run_["trainer"].save_dir_path, "model.ckpt"))

    def written_forward(tag: str, family: str, run_dir_f: str, model_kw: dict, scene_f,
                        rtol: float):
        """The checkpoint in ``run_dir_f`` through the converter: its forward
        on ``scene_f`` on the card against the same parameters (and PONITA's
        calibration) in float64 on the CPU, within ``rtol`` of the largest
        output.  Returns the error and that output."""
        sd_f = weights.params_from_jax(
            weights.read_checkpoint(os.path.join(run_dir_f, "model.ckpt"))["params"], family)
        card_m = models.create_model(family, device=dev, **model_kw)
        cpu_m = models.create_model(family, device="cpu", dtype=torch.float64, **model_kw)
        card_m.load_state_dict(sd_f)
        cpu_m.load_state_dict(sd_f)
        card_m.eval()
        cpu_m.eval()
        scene_c = cpu64(scene_f)
        with torch.no_grad():
            out_k = card_m(scene_f, fc(scene_f))
            out_c = cpu_m(scene_c, fc(scene_c))
        err, scale = (out_k.double().cpu() - out_c).abs().max().item(), out_c.abs().max().item()
        if not (torch.isfinite(out_k).all() and err <= rtol * scale):
            fail(f"{tag}: the written checkpoint's forward on the card differs from the CPU's "
                 f"float64 one by {err} (max |out| {scale}, rtol {rtol})")
        return err, scale

    def family_hpo(family: str, want=None, tag=None, mode: str = "param_small") -> None:
        """Two trials of ``family`` at the reference default, each one epoch
        of 10 steps and a 20-step evaluation: every trial done, its value
        finite and, in a param mode, its count within the budget, or, where
        ``want`` gives them, its widths and count those of ``want``;
        K2-leapfrog launches only.  The phase is ``tag`` (``hpo-<family>``
        where None)."""
        tag = tag or f"hpo-{family}"
        t0 = time.perf_counter()
        target = hpo.PARAM_TARGETS.get(mode)
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
            reset_counts()
            best = hpo.run_study(family, trials=HPO_TRIALS, mode=mode, study_dir="hpo",
                                 train_epochs=1, steps_per_epoch=10,
                                 self_feed_limit_steps=HPO_EVAL_STEPS, device=dev)
            sync()
            got = counts()
            with open(os.path.join("hpo", f"{family}_{mode}_trials.jsonl")) as f:
                trials = [json.loads(line) for line in f]
        for i, t in enumerate(trials):
            if target is None:
                budget = True
            elif want is None:
                budget = abs(t["n_params"] - target) <= hpo.PARAM_TOLERANCE * target
            else:
                budget = i < len(want) and (t["model_kwargs"], t["n_params"]) == want[i]
            if not (t["status"] == "done" and np.isfinite(t["value"]) and budget):
                fail(f"{tag}: trial {t}")
        others = {k: v for k, v in got.items() if k != "leapfrog"}
        if (len(trials) != HPO_TRIALS or any(others.values())
                or not HPO_TRIALS <= got["leapfrog"] <= 2 * HPO_TRIALS):
            fail(f"{tag}: {len(trials)} trials launched {got}")
        eval_counts[tag.replace("-", "_")] = got
        for t in trials:
            print(f"  {tag}: trial {t['number']} {t['model_kwargs']} n_params={t['n_params']} "
                  f"value={t['value']:.4f} {t['seconds']:.2f} s steps_per_min="
                  f"{t['steps_per_min']:.1f} peak_hbm_mb={t.get('peak_hbm_mb', float('nan')):.1f}",
                  flush=True)
        report(tag, t0, trials=len(trials), mode=mode,
               best_value=f"{best['value']:.4f}", leapfrog_launches=got["leapfrog"])

    launch_probe("before [ponita]")
    # ------------------------------------------------------------- 25. ponita
    # a fresh PONITA of its 10M run's width (h480, L2) from a seed, calibrated on its first
    # batch (a fresh GT frame) on the card and, from the same parameters, on
    # the CPU in float64, as the trainer calibrates; its forward on that frame
    # against the CPU's float64; the parameter count.  PONITA is plain
    # PyTorch: no kernel but the GT's
    t0 = time.perf_counter()
    torch.manual_seed(PONITA_SEED)
    pcpu = models.create_model("ponita", device="cpu", dtype=torch.float64, **PONITA_KW)
    pmodel = models.create_model("ponita", device=dev, **PONITA_KW)
    pmodel.load_state_dict(pcpu.state_dict())
    n_params_p = models.count_params(pmodel)
    n_params_hpo = hpo._count_params("ponita", PONITA_KW, PONITA_N)
    if n_params_p != PONITA_PARAMS or n_params_hpo != PONITA_PARAMS:
        fail(f"ponita: {n_params_p} parameters ({n_params_hpo} by hpo), want {PONITA_PARAMS}")
    reset_counts()
    gt_p = otf.GravityDatasetOtf(
        batch_size=PONITA_B, sim_length=PONITA_SUBSTEPS, sample_freq=SAMPLE_FREQ,
        num_nodes=PONITA_N, interaction_strength=G_CONST, softening=SOFTENING, seed=20,
        device=dev).get_ground_truth_trajectories()
    sync()
    eval_counts["ponita"] = counted({"leapfrog": 1}, "ponita")

    scene_p = Scene(pos=gt_p[0][:, 0], vel=gt_p[1][:, 0], force=gt_p[2][:, 0], mass=gt_p[3])
    scene_c = cpu64(scene_p)
    ponita.calibrate_params(pmodel, scene_p, fc(scene_p))
    ponita.calibrate_params(pcpu, scene_c, fc(scene_c))
    calib_err = 0.0
    for k, (bc, bf) in enumerate(zip(pmodel.blocks, pcpu.blocks)):
        for stat in ponita.CALIB_STATS:
            got, want = float(getattr(bc.conv, stat)), float(getattr(bf.conv, stat))
            rel = abs(got - want) / abs(want)
            if not (want > 0 and rel <= PONITA_CALIB_RTOL):
                fail(f"ponita: calibration {stat} of block {k}: card {got}, CPU f64 {want}")
            calib_err = max(calib_err, rel)
    # both sides keep their own calibration: the card's, in f32, is held to
    # the CPU's above
    pmodel.eval()
    pcpu.eval()
    with torch.no_grad():
        out_card = pmodel(scene_p, fc(scene_p))
        out_cpu = pcpu(scene_c, fc(scene_c))
        fwd_ms = cuda_ms(lambda: pmodel(scene_p, fc(scene_p)), iters=20)
        busy_fwd, top_fwd, launches_fwd = top_kernels(lambda: pmodel(scene_p, fc(scene_p)), n=8)
    fwd_err = (out_card.double().cpu() - out_cpu).abs().max().item()
    fwd_scale = out_cpu.abs().max().item()
    if not (torch.isfinite(out_card).all() and fwd_err <= PONITA_FWD_RTOL * fwd_scale):
        fail(f"ponita: the card's forward differs from the CPU's float64 one by {fwd_err} "
             f"(max |out| {fwd_scale}, rtol {PONITA_FWD_RTOL})")
    # the forward's operations (multiply-adds count 2) and its bound: rows of
    # edge-orientations and of node-orientations, f32 at the card's peak
    O_, H_, Kb = pmodel.num_ori, pmodel.hidden_features, 128
    e_rows, n_rows = PONITA_B * PONITA_N * PONITA_N * O_, PONITA_B * PONITA_N * O_
    fwd_flops = 2.0 * e_rows * (14 * H_ + H_ * Kb) + PONITA_KW["num_layers"] * (
        2.0 * e_rows * Kb * H_ + 3.0 * e_rows * H_ + 2.0 * PONITA_B * PONITA_N * O_ * O_ * H_
        + 2.0 * n_rows * 8 * H_ * H_ + 2.0 * n_rows * H_ * 2)
    fwd_bound = fwd_flops / PEAK_F32_FLOPS * 1e3
    print(f"  ponita: forward, device busy {busy_share(busy_fwd, fwd_ms)}, {launches_fwd} "
          f"kernels; top kernels: {top_fwd}", flush=True)
    report("ponita", t0, B=PONITA_B, N=PONITA_N, layers=PONITA_KW["num_layers"], width=H_,
           num_ori=O_, init=f"fresh, seed {PONITA_SEED}", n_params=n_params_p,
           fwd_max_abs_err=f"{fwd_err:.3e}", max_abs_out=f"{fwd_scale:.3e}",
           rtol=PONITA_FWD_RTOL, fwd_ms=f"{fwd_ms:.4f}", fwd_bound_ms=f"{fwd_bound:.4f}",
           fwd_gflop=f"{fwd_flops / 1e9:.2f}", calib_stats=3 * len(pmodel.blocks),
           calib_max_rel_err=f"{calib_err:.3e}", calib_rtol=PONITA_CALIB_RTOL,
           leapfrog_launches=eval_counts["ponita"]["leapfrog"])

    # ----------------------------------------------------- 26. ponita-rollout
    # GT at the reference workload through one K2-leapfrog launch, 100 counted
    # self-feed steps (no kernel; [battery-ponita] rolls 999), the six-macro
    # score; 20 steps on the card against the CPU's float64; the 100 steps
    # repeated bitwise, and timed warm
    t0 = time.perf_counter()
    info = family_rollout("ponita", pmodel, pcpu, PONITA_B, PONITA_N, PONITA_SUBSTEPS, 21,
                          PONITA_CMP_B, PONITA_ROLL_RTOL, PONITA_NUDGE_FACTOR)
    del pcpu, pmodel
    report("ponita-rollout", t0, **info)

    # ------------------------------------------------------- 27. train-ponita
    # the queue's argv from a fresh initialisation, which calibrates on its
    # first batch: 2 epochs of 20 steps and a 100-step evaluation; then a
    # resume from the checkpoint it wrote (JAX layout, calib and AdamW
    # included): 10 steps, the count and epoch going on, the calibration kept.
    # Its run dir stays for [battery-ponita]
    t0 = time.perf_counter()
    ponita_tmp = tempfile.TemporaryDirectory()
    info, _, resumed_model, run_dir_p = family_train("ponita", None, PONITA_ARGV, None, 0, 0,
                                                     PONITA_PARAMS, workdir=ponita_tmp.name)
    convs = [blk.conv for blk in resumed_model.blocks]
    if any(float(getattr(c, s_)) == 1.0 for c in convs for s_ in ponita.CALIB_STATS):
        fail("train-ponita: the fresh run's model was not calibrated on its first batch")
    del resumed_model, convs
    report("train-ponita", t0, B=PONITA_B, N=PONITA_N, **info, fresh_calibrated=True)

    # ----------------------------------------------------- 28. battery-ponita
    # [train-ponita]'s run dir: the checkpoint it wrote through the converter,
    # its forward on [ponita]'s GT frame on the card against the same
    # parameters and calibration in float64 on the CPU; then `cli self-feed
    # --draws 1 --seed 281` on the run dir, 999 steps; a class, not a gate
    t0 = time.perf_counter()
    ckpt_err, ckpt_scale = written_forward("battery-ponita", "ponita", run_dir_p, PONITA_KW,
                                           scene_p, PONITA_FWD_RTOL)
    _, info = family_battery("ponita", os.path.join(run_dir_p, "model.ckpt"), PONITA_DRAWS,
                             PONITA_FRAMES)
    ponita_tmp.cleanup()
    report("battery-ponita", t0, B=PONITA_B, N=PONITA_N, ckpt_fwd_max_abs_err=f"{ckpt_err:.3e}",
           ckpt_max_abs_out=f"{ckpt_scale:.3e}", ckpt_rtol=PONITA_FWD_RTOL, **info)

    # --------------------------------------------------------- 29. hpo-ponita
    family_hpo("ponita")

    # -------------------------------------------------------------- 30. segnn
    # a fresh SEGNN at its 10M run's width (w448) and depth 2, from a seed, on
    # the card: a forward on a fresh GT frame against the same model in
    # float64 on the CPU, the parameter count, and O(3) equivariance with
    # center_mode "nodes".  SEGNN is plain PyTorch: no kernel but the GT's
    t0 = time.perf_counter()
    torch.manual_seed(SEGNN_SEED)
    scpu = models.create_model("segnn", device="cpu", dtype=torch.float64, **SEGNN_KW)
    smodel = models.create_model("segnn", device=dev, **SEGNN_KW)
    smodel.load_state_dict(scpu.state_dict())
    smodel.eval()
    scpu.eval()
    n_params_s = models.count_params(smodel)
    n_params_s_hpo = hpo._count_params("segnn", SEGNN_KW, SEGNN_N)
    if n_params_s != SEGNN_PARAMS or n_params_s_hpo != SEGNN_PARAMS:
        fail(f"segnn: {n_params_s} parameters ({n_params_s_hpo} by hpo), want {SEGNN_PARAMS}")
    reset_counts()
    gt_sg = otf.GravityDatasetOtf(
        batch_size=SEGNN_B, sim_length=SEGNN_SUBSTEPS, sample_freq=SAMPLE_FREQ,
        num_nodes=SEGNN_N, interaction_strength=G_CONST, softening=SOFTENING, seed=30,
        device=dev).get_ground_truth_trajectories()
    sync()
    eval_counts["segnn"] = counted({"leapfrog": 1}, "segnn")
    scene_s = Scene(pos=gt_sg[0][:, 0], vel=gt_sg[1][:, 0], force=gt_sg[2][:, 0], mass=gt_sg[3])
    scene_sc = cpu64(scene_s)
    with torch.no_grad():
        out_card = smodel(scene_s, fc(scene_s))
        out_cpu = scpu(scene_sc, fc(scene_sc))
        fwd_ms_s = cuda_ms(lambda: smodel(scene_s, fc(scene_s)), iters=20)
        busy_fwd_s, top_fwd_s, launches_fwd_s = top_kernels(lambda: smodel(scene_s, fc(scene_s)),
                                                            n=8)
    fwd_err_s = (out_card.double().cpu() - out_cpu).abs().max().item()
    fwd_scale_s = out_cpu.abs().max().item()
    if not (torch.isfinite(out_card).all() and fwd_err_s <= SEGNN_FWD_RTOL * fwd_scale_s):
        fail(f"segnn: the card's forward differs from the CPU's float64 one by {fwd_err_s} "
             f"(max |out| {fwd_scale_s}, rtol {SEGNN_FWD_RTOL})")
    # the forward's bound: every path of every tensor product (multiply-adds
    # count 2; the CG tensor with the attribute, then the input, then the
    # weights), edge rows for the message products, node rows for the rest,
    # f32 at the card's peak; the bytes (parameters, inputs, output) are far
    # below
    e_rows_s, n_rows_s = SEGNN_B * SEGNN_N * SEGNN_N, SEGNN_B * SEGNN_N
    fwd_flops_s = sum(tp_flops(tp) * (e_rows_s if ".message" in name else n_rows_s)
                      for name, tp in smodel.named_modules()
                      if isinstance(tp, steerable.SteerableTensorProduct))
    fwd_bytes_s = 4.0 * (n_params_s + e_rows_s * 6 + n_rows_s * 16)
    fwd_bound_s, fwd_by_s = bound_ms(fwd_bytes_s, fwd_flops_s)
    # O(3): the model with center_mode "nodes" on the scene turned by an
    # orthogonal matrix with a reflection and shifted, against its outputs
    # on the scene turned the same way
    nodes = models.create_model("segnn", device=dev, center_mode="nodes", **SEGNN_KW)
    nodes.load_state_dict(smodel.state_dict())
    nodes.eval()
    q, r = torch.linalg.qr(torch.randn((3, 3), generator=torch.Generator().manual_seed(31),
                                       dtype=torch.float64))
    R = q * torch.sign(torch.diagonal(r))
    R = (-R if torch.det(R) > 0 else R).float().to(dev)
    moved = Scene(pos=scene_s.pos @ R.T + torch.tensor([1.5, -0.5, 2.0], device=dev),
                  vel=scene_s.vel @ R.T, force=scene_s.force @ R.T, mass=scene_s.mass)
    with torch.no_grad():
        out_n = nodes(scene_s, fc(scene_s))
        out_m = nodes(moved, fc(moved))
    want_m = torch.cat([out_n[..., :3] @ R.T, out_n[..., 3:] @ R.T], dim=-1)
    equiv_err = (out_m - want_m).abs().max().item()
    equiv_scale = want_m.abs().max().item()
    if not (torch.isfinite(out_m).all() and equiv_err <= SEGNN_EQUIV_RTOL * equiv_scale):
        fail(f"segnn: O(3) with center_mode nodes off by {equiv_err} (max |out| {equiv_scale}, "
             f"rtol {SEGNN_EQUIV_RTOL})")
    del nodes, out_n, out_m, want_m, gt_sg
    print(f"  segnn: forward, device busy {busy_share(busy_fwd_s, fwd_ms_s)}; top kernels: "
          f"{top_fwd_s}", flush=True)
    report("segnn", t0, B=SEGNN_B, N=SEGNN_N, layers=SEGNN_KW["num_layers"],
           width=SEGNN_KW["hidden_features"], hidden_irreps=repr(smodel.hidden_irreps),
           init=f"fresh, seed {SEGNN_SEED}", n_params=n_params_s,
           fwd_max_abs_err=f"{fwd_err_s:.3e}",
           max_abs_out=f"{fwd_scale_s:.3e}", rtol=SEGNN_FWD_RTOL, fwd_ms=f"{fwd_ms_s:.4f}",
           fwd_bound_ms=f"{fwd_bound_s:.4f}", fwd_bound_by=fwd_by_s,
           fwd_gflop=f"{fwd_flops_s / 1e9:.2f}",
           fwd_busy_ms=("not measured" if busy_fwd_s is None else f"{busy_fwd_s:.3f}"),
           fwd_kernels=launches_fwd_s,
           o3_max_abs_err=f"{equiv_err:.3e}", o3_rtol=SEGNN_EQUIV_RTOL,
           leapfrog_launches=eval_counts["segnn"]["leapfrog"])

    # ------------------------------------------------------ 31. segnn-rollout
    # 100 steps ([battery-segnn] rolls 999), as [ponita-rollout]
    t0 = time.perf_counter()
    info = family_rollout("segnn", smodel, scpu, SEGNN_B, SEGNN_N, SEGNN_SUBSTEPS, 32,
                          SEGNN_CMP_B, SEGNN_ROLL_RTOL, SEGNN_NUDGE_FACTOR)
    del scpu, smodel
    report("segnn-rollout", t0, **info)

    # -------------------------------------------------------- 32. train-segnn
    # the queue's argv at depth 2 from a fresh initialisation, with one step
    # from the checkpoint it wrote against the same step on the CPU in
    # float64 ([train]'s gates); then a resume from that checkpoint.  Its run
    # dir stays for [battery-segnn]
    t0 = time.perf_counter()
    segnn_tmp = tempfile.TemporaryDirectory()
    info, (p_err_s, up_err_s, card_loss_s, cpu_loss_s), resumed_model, run_dir_sg = family_train(
        "segnn", None, SEGNN_ARGV, None, 0, 0, SEGNN_PARAMS, workdir=segnn_tmp.name,
        extra=lambda run_, scene_, y_: step_vs_cpu("train-segnn", run_, written(run_), SEGNN_KW,
                                                   scene_, y_))
    del resumed_model
    print(f"  train-segnn: one step from the written checkpoint, card f32 vs CPU f64 on "
          f"{TRAIN_CMP_B} sims: loss {card_loss_s:.8f} / {cpu_loss_s:.8f}, params max rel err "
          f"{p_err_s:.3e} (limit {TRAIN_PARAM_RTOL}), update max rel err {up_err_s:.3e} (limit "
          f"{TRAIN_UPDATE_RTOL})", flush=True)
    report("train-segnn", t0, B=SEGNN_B, N=SEGNN_N, **info,
           cmp_param_err=f"{p_err_s:.3e}", cmp_update_err=f"{up_err_s:.3e}")

    # ------------------------------------------------------ 33. battery-segnn
    # [train-segnn]'s run dir: the checkpoint it wrote through the converter,
    # its forward on [segnn]'s GT frame on the card against the CPU's float64;
    # then `cli self-feed --draws 1 --seed 281` on the run dir, 999 steps; a
    # class, not a gate
    t0 = time.perf_counter()
    ckpt_err_s, ckpt_scale_s = written_forward("battery-segnn", "segnn", run_dir_sg, SEGNN_KW,
                                               scene_s, SEGNN_FWD_RTOL)
    battery_s_s, info = family_battery("segnn", os.path.join(run_dir_sg, "model.ckpt"),
                                       SEGNN_DRAWS, SEGNN_FRAMES)
    segnn_tmp.cleanup()
    report("battery-segnn", t0, battery_s_s, B=SEGNN_B, N=SEGNN_N,
           ckpt_fwd_max_abs_err=f"{ckpt_err_s:.3e}", ckpt_max_abs_out=f"{ckpt_scale_s:.3e}",
           ckpt_rtol=SEGNN_FWD_RTOL, **info)
    del scene_s, scene_sc

    # --------------------------------------------------------- 34. hpo-segnn
    family_hpo("segnn")

    launch_probe("before [eqv2]")
    # --------------------------------------------------------------- 35. eqv2
    # the committed EquiformerV2 checkpoint through the converter, on the
    # card: an eval-mode forward on a fresh GT frame against the same model in
    # float64 on the CPU, its ms, busy share and kernels beside its bound and
    # the eager byte floor, the parameter count, permutation equivariance;
    # rotation equivariance of a fresh L8 c128 with the equivariant velocity
    # gate.  EquiformerV2 is plain PyTorch: no kernel but the GT's
    t0 = time.perf_counter()
    payload_e = weights.read_checkpoint(battery.EQV2_CKPT)
    emodel = models.create_model("equiformer_v2", device=dev, **EQV2_KW)
    emodel.load_state_dict(weights.params_from_jax(payload_e["params"], "equiformer_v2"))
    emodel.eval()
    ecpu = models.create_model("equiformer_v2", device="cpu", dtype=torch.float64, **EQV2_KW)
    ecpu.load_state_dict(emodel.state_dict())
    ecpu.eval()
    n_params_e = models.count_params(emodel)
    n_params_e_hpo = hpo._count_params("equiformer_v2", EQV2_KW, EQV2_N)
    if n_params_e != EQV2_PARAMS or n_params_e_hpo != EQV2_PARAMS:
        fail(f"eqv2: {n_params_e} parameters ({n_params_e_hpo} by hpo), want {EQV2_PARAMS}")
    reset_counts()
    gt_e = otf.GravityDatasetOtf(
        batch_size=EQV2_B, sim_length=EQV2_SUBSTEPS, sample_freq=SAMPLE_FREQ,
        num_nodes=EQV2_N, interaction_strength=G_CONST, softening=SOFTENING, seed=40,
        device=dev).get_ground_truth_trajectories()
    sync()
    eval_counts["eqv2"] = counted({"leapfrog": 1}, "eqv2")
    scene_e = Scene(pos=gt_e[0][:, 0], vel=gt_e[1][:, 0], force=gt_e[2][:, 0], mass=gt_e[3])
    scene_ec = cpu64(scene_e)
    with torch.no_grad():
        out_card = emodel(scene_e, fc(scene_e))
        out_cpu = ecpu(scene_ec, fc(scene_ec))
        # the caching allocator's traffic over the timed forwards: device
        # allocations, frees (each a device sync) and retries after a failed
        # allocation, with the memory it holds
        stats0 = torch.cuda.memory_stats(dev)
        fwd_ms_e = cuda_ms(lambda: emodel(scene_e, fc(scene_e)), iters=10)
        stats1 = torch.cuda.memory_stats(dev)
        alloc_traffic = {k: stats1.get(k, 0) - stats0.get(k, 0)
                         for k in ("num_device_alloc", "num_device_free", "num_alloc_retries")}
        busy_e, top_e, launches_e = top_kernels(lambda: emodel(scene_e, fc(scene_e)), n=8)
    fwd_err_e = (out_card.double().cpu() - out_cpu).abs().max().item()
    fwd_scale_e = out_cpu.abs().max().item()
    if not (torch.isfinite(out_card).all() and fwd_err_e <= EQV2_FWD_RTOL * fwd_scale_e):
        fail(f"eqv2: the card's forward differs from the CPU's float64 one by {fwd_err_e} "
             f"(max |out| {fwd_scale_e}, rtol {EQV2_FWD_RTOL})")
    # permutation: the bodies reordered, the outputs reordered the same way
    perm = torch.tensor([3, 0, 4, 1, 2], device=dev)
    moved = Scene(pos=scene_e.pos[:, perm], vel=scene_e.vel[:, perm],
                  force=scene_e.force[:, perm], mass=scene_e.mass[:, perm])
    with torch.no_grad():
        perm_err = (emodel(moved, fc(moved)) - out_card[:, perm]).abs().max().item()
    if not perm_err <= EQV2_PERM_RTOL * fwd_scale_e:
        fail(f"eqv2: permutation off by {perm_err} (max |out| {fwd_scale_e})")
    # rotation: a fresh full-width model with the equivariant velocity gate
    torch.manual_seed(EQV2_FRESH_SEED)
    rot_model = models.create_model("equiformer_v2", device=dev, equivariant_embedding=True,
                                    **EQV2_KW).eval()
    q, r = torch.linalg.qr(torch.randn((3, 3), generator=torch.Generator().manual_seed(41),
                                       dtype=torch.float64))
    R = q * torch.sign(torch.diagonal(r))
    R = (R if torch.det(R) > 0 else -R).float().to(dev)
    turned = Scene(pos=scene_e.pos @ R.T, vel=scene_e.vel @ R.T, force=scene_e.force @ R.T,
                   mass=scene_e.mass)
    with torch.no_grad():
        out_f = rot_model(scene_e, fc(scene_e))
        out_t = rot_model(turned, fc(turned))
    want_t = torch.cat([out_f[..., :3] @ R.T, out_f[..., 3:] @ R.T], dim=-1)
    rot_err, rot_scale = (out_t - want_t).abs().max().item(), want_t.abs().max().item()
    if not (torch.isfinite(out_t).all() and rot_err <= EQV2_ROT_RTOL * rot_scale):
        fail(f"eqv2: rotation off by {rot_err} (max |out| {rot_scale}, rtol {EQV2_ROT_RTOL})")
    del rot_model, out_f, out_t, want_t, gt_e
    fwd_flops_e, grid_bytes_e = eqv2_forward_cost(emodel, EQV2_B, EQV2_N)
    fwd_bytes_e = 4.0 * (n_params_e + EQV2_B * EQV2_N * 13 + EQV2_B * EQV2_N * 6)
    fwd_bound_e, fwd_by_e = bound_ms(fwd_bytes_e, fwd_flops_e)
    print(f"  eqv2: forward, device busy {busy_share(busy_e, fwd_ms_e)}, {launches_e} kernels; "
          f"top kernels: {top_e}", flush=True)
    report("eqv2", t0, B=EQV2_B, N=EQV2_N, layers=EQV2_KW["num_layers"],
           channels=EQV2_KW["sphere_channels"], heads=EQV2_KW["num_heads"], n_params=n_params_e,
           fwd_max_abs_err=f"{fwd_err_e:.3e}", max_abs_out=f"{fwd_scale_e:.3e}",
           rtol=EQV2_FWD_RTOL, fwd_ms=f"{fwd_ms_e:.4f}", fwd_bound_ms=f"{fwd_bound_e:.4f}",
           fwd_bound_by=fwd_by_e, fwd_gflop=f"{fwd_flops_e / 1e9:.2f}",
           eager_grid_gb=f"{grid_bytes_e / 1e9:.2f}",
           eager_byte_floor_ms=f"{grid_bytes_e / PEAK_BYTES * 1e3:.4f}",
           fwd_busy_ms=("not measured" if busy_e is None else f"{busy_e:.3f}"),
           fwd_kernels=launches_e, allocator_over_timed_forwards=repr(alloc_traffic),
           reserved_gib=f"{torch.cuda.memory_reserved(dev) / 2**30:.2f}",
           perm_max_abs_err=f"{perm_err:.3e}",
           perm_rtol=EQV2_PERM_RTOL, rot_max_abs_err=f"{rot_err:.3e}",
           rot_max_abs_out=f"{rot_scale:.3e}", rot_rtol=EQV2_ROT_RTOL,
           leapfrog_launches=eval_counts["eqv2"]["leapfrog"])

    # ------------------------------------------------------- 36. eqv2-rollout
    # GT at the reference workload through one K2-leapfrog launch, 100 counted
    # self-feed steps in training mode with live dropout (masks seeded with
    # EQV2_DROPOUT_SEED; [battery-eqv2] rolls 999), the six-macro score; 20
    # eval-mode steps on the card against the CPU's float64; the 100 steps
    # repeated from the same GT and dropout seed bitwise, and timed warm
    t0 = time.perf_counter()
    info = family_rollout("eqv2", emodel, ecpu, EQV2_B, EQV2_N, EQV2_SUBSTEPS, 42, EQV2_CMP_B,
                          EQV2_ROLL_RTOL, EQV2_NUDGE_FACTOR, train_mode=True,
                          dropout_seed=EQV2_DROPOUT_SEED)
    del ecpu
    report("eqv2-rollout", t0, **info)

    # --------------------------------------------------------- 37. train-eqv2
    # the queue's argv resumed from the committed checkpoint with its AdamW
    # state and Noam step (dropout live, from the run's seeded generator); one
    # step against the same step on the CPU in float64 with both dropout rates
    # at 0 (the card's and the CPU's generators draw different masks), at
    # [train]'s gates; a step's peak memory without remat; then a fresh run
    eqv2_argv = list(battery.EQV2_RUN_ARGV)
    quiet_kw = dict(EQV2_KW, alpha_drop=0.0, drop_path_rate=0.0)

    def eqv2_extra(run_, scene_, y_):
        cmp_ = step_vs_cpu("train-eqv2", run_, payload_e, quiet_kw, scene_, y_)
        model_ = run_["trainer"].model
        model_.remat = False
        try:
            plain_ = time_steps(run_["trainer"], scene_, y_)
        finally:
            model_.remat = True
        return cmp_, plain_

    t0 = time.perf_counter()
    info, ((p_err_e, up_err_e, card_loss_e, cpu_loss_e), no_remat), fresh_model, _ = family_train(
        "eqv2", battery.EQV2_CKPT, eqv2_argv, payload_e, EQV2_EPOCH, EQV2_COUNT, EQV2_PARAMS,
        extra=eqv2_extra)
    del fresh_model
    print(f"  train-eqv2: one step, card f32 vs CPU f64 on {TRAIN_CMP_B} sims (no dropout): "
          f"loss {card_loss_e:.8f} / {cpu_loss_e:.8f}, params max rel err {p_err_e:.3e} (limit "
          f"{TRAIN_PARAM_RTOL}), update max rel err {up_err_e:.3e} (limit {TRAIN_UPDATE_RTOL}); "
          f"without remat {no_remat['ms']:.3f} ms a step, peak "
          f"{no_remat['peak_above_start_mib']:.1f} MiB above the start", flush=True)
    report("train-eqv2", t0, B=EQV2_B, N=EQV2_N, **info,
           cmp_param_err=f"{p_err_e:.3e}", cmp_update_err=f"{up_err_e:.3e}",
           no_remat_ms_per_step=f"{no_remat['ms']:.3f}",
           no_remat_peak_above_start_mib=f"{no_remat['peak_above_start_mib']:.1f}")

    # ------------------------------------------------------- 38. battery-eqv2
    # `cli self-feed --draws 1 --seed 281` on a run dir of the queue's argv
    # around the committed checkpoint (train mode, live dropout), beside the
    # committed 12-draw battery of the same seed; a class, not a gate
    t0 = time.perf_counter()
    battery_e_s, info = family_battery("eqv2", battery.EQV2_CKPT, EQV2_DRAWS, EQV2_FRAMES,
                                       eqv2_argv)
    ref_six_e = battery.committed(BATTERY_SEED, battery.EQV2_COMMITTED)["six"]
    ref_e = battery.spread(ref_six_e)
    report("battery-eqv2", t0, battery_e_s, B=EQV2_B, N=EQV2_N, **info,
           committed_draws=len(ref_six_e), committed_six_best=f"{ref_e['best']:.4g}",
           committed_six_median=f"{ref_e['median']:.4g}",
           committed_six_worst=f"{ref_e['worst']:.4g}")
    del payload_e, emodel

    # ------------------------------------------------- 39. hpo-equiformer_v2
    # each trial's widths and count the JAX package's bisection's (EQV2_HPO_WANT)
    family_hpo("equiformer_v2", EQV2_HPO_WANT)

    # ----------------------------------------------------------------- 40. gt
    # the committed GraphTransformer checkpoint through the converter, on the
    # card: an eval-mode forward on a fresh GT frame against the same model in
    # float64 on the CPU, its ms, busy share and kernels beside its bound, the
    # parameter count, permutation equivariance.  GraphTransformer is plain
    # PyTorch: no kernel but the GT's
    t0 = time.perf_counter()
    payload_g = weights.read_checkpoint(battery.GT_CKPT)
    gmodel = models.create_model("graph_transformer", device=dev, **GT_KW)
    gmodel.load_state_dict(weights.params_from_jax(payload_g["params"], "graph_transformer"))
    gmodel.eval()
    gcpu = models.create_model("graph_transformer", device="cpu", dtype=torch.float64, **GT_KW)
    gcpu.load_state_dict(gmodel.state_dict())
    gcpu.eval()
    n_params_g = models.count_params(gmodel)
    n_params_g_hpo = hpo._count_params("graph_transformer", GT_KW, GT_N)
    if n_params_g != GT_PARAMS or n_params_g_hpo != GT_PARAMS:
        fail(f"gt: {n_params_g} parameters ({n_params_g_hpo} by hpo), want {GT_PARAMS}")
    reset_counts()
    gt_g = otf.GravityDatasetOtf(
        batch_size=GT_B, sim_length=GT_SUBSTEPS, sample_freq=SAMPLE_FREQ,
        num_nodes=GT_N, interaction_strength=G_CONST, softening=SOFTENING, seed=50,
        device=dev).get_ground_truth_trajectories()
    sync()
    eval_counts["gt"] = counted({"leapfrog": 1}, "gt")
    scene_g = Scene(pos=gt_g[0][:, 0], vel=gt_g[1][:, 0], force=gt_g[2][:, 0], mass=gt_g[3])
    scene_gc = cpu64(scene_g)
    with torch.no_grad():
        out_card = gmodel(scene_g, fc(scene_g))
        out_cpu = gcpu(scene_gc, fc(scene_gc))
        fwd_ms_g = cuda_ms(lambda: gmodel(scene_g, fc(scene_g)), iters=20)
        busy_g, top_g, launches_g = top_kernels(lambda: gmodel(scene_g, fc(scene_g)), n=8)
    fwd_err_g = (out_card.double().cpu() - out_cpu).abs().max().item()
    fwd_scale_g = out_cpu.abs().max().item()
    if not (torch.isfinite(out_card).all() and fwd_err_g <= GT_FWD_RTOL * fwd_scale_g):
        fail(f"gt: the card's forward differs from the CPU's float64 one by {fwd_err_g} "
             f"(max |out| {fwd_scale_g}, rtol {GT_FWD_RTOL})")
    # permutation: the bodies reordered, the outputs reordered the same way
    perm = torch.tensor([3, 0, 4, 1, 2], device=dev)
    moved = Scene(pos=scene_g.pos[:, perm], vel=scene_g.vel[:, perm],
                  force=scene_g.force[:, perm], mass=scene_g.mass[:, perm])
    with torch.no_grad():
        perm_err_g = (gmodel(moved, fc(moved)) - out_card[:, perm]).abs().max().item()
    if not perm_err_g <= GT_PERM_RTOL * fwd_scale_g:
        fail(f"gt: permutation off by {perm_err_g} (max |out| {fwd_scale_g})")
    # the forward's operations (multiply-adds count 2) per token: the
    # embedding, per layer the four projections, the two feed-forward
    # products and the attention's two products over N keys, the head; its
    # bytes the parameters, the scene and the output once
    H_, F_, L_ = GT_KW["hidden_features"], gmodel.dim_feedforward, GT_KW["num_layers"]
    tokens = GT_B * GT_N
    fwd_flops_g = 2.0 * tokens * (6 * H_ + L_ * (4 * H_ * H_ + 2 * H_ * F_ + 2 * GT_N * H_)
                                  + 2 * H_ * H_ + H_ * 6)
    fwd_bytes_g = 4.0 * (n_params_g + tokens * 6 + tokens * 6)
    fwd_bound_g, fwd_by_g = bound_ms(fwd_bytes_g, fwd_flops_g)
    del gt_g, moved
    print(f"  gt: forward, device busy {busy_share(busy_g, fwd_ms_g)}, {launches_g} kernels; "
          f"top kernels: {top_g}", flush=True)
    report("gt", t0, B=GT_B, N=GT_N, layers=L_, width=H_, heads=GT_KW["num_heads"],
           dim_feedforward=F_, n_params=n_params_g, fwd_max_abs_err=f"{fwd_err_g:.3e}",
           max_abs_out=f"{fwd_scale_g:.3e}", rtol=GT_FWD_RTOL, fwd_ms=f"{fwd_ms_g:.4f}",
           fwd_bound_ms=f"{fwd_bound_g:.4f}", fwd_bound_by=fwd_by_g,
           fwd_gflop=f"{fwd_flops_g / 1e9:.2f}",
           fwd_busy_ms=("not measured" if busy_g is None else f"{busy_g:.3f}"),
           fwd_kernels=launches_g, perm_max_abs_err=f"{perm_err_g:.3e}", perm_rtol=GT_PERM_RTOL,
           leapfrog_launches=eval_counts["gt"]["leapfrog"])

    # --------------------------------------------------------- 41. gt-rollout
    # GT at the reference workload through one K2-leapfrog launch, 100 counted
    # self-feed steps in training mode with live dropout (masks seeded with
    # GT_DROPOUT_SEED; [battery-gt] rolls 999), the six-macro score; 20
    # eval-mode steps on the card against the CPU's float64; the 100 steps
    # repeated from the same GT and dropout seed bitwise, and timed warm
    t0 = time.perf_counter()
    info = family_rollout("gt", gmodel, gcpu, GT_B, GT_N, GT_SUBSTEPS, 52, GT_CMP_B,
                          GT_ROLL_RTOL, GT_NUDGE_FACTOR, train_mode=True,
                          dropout_seed=GT_DROPOUT_SEED)
    del gcpu, gmodel
    report("gt-rollout", t0, **info)

    # ----------------------------------------------------------- 42. train-gt
    # the queue's argv resumed from the committed checkpoint with its AdamW
    # state and Noam step (dropout live, from the run's seeded generator); one
    # step against the same step on the CPU in float64 with the dropout rate
    # at 0 (the card's and the CPU's generators draw different masks), at
    # [train]'s gates; then a fresh run
    gt_argv = list(battery.GT_RUN_ARGV)
    quiet_g = dict(GT_KW, dropout=0.0)

    def gt_extra(run_, scene_, y_):
        # the key projections' biases add q . b_k to each of a query's logits
        # alike, which the softmax over keys ignores: no gradient in exact
        # arithmetic, so step_vs_cpu holds their parameters only.  The
        # premise, in float64 on the CPU: their gradient is rounding noise
        # beside their kernels'
        trainer_ = run_["trainer"]
        m = models.create_model("graph_transformer", device="cpu", dtype=torch.float64, **quiet_g)
        m.load_state_dict(weights.params_from_jax(payload_g["params"], "graph_transformer"))
        m.train()
        sub = Scene(*(t_[:TRAIN_CMP_B].cpu().double() for t_ in (scene_.pos, scene_.vel,
                                                                 scene_.force, scene_.mass)))
        loss_, _ = trainer_.loss_fn(m(sub, graph.knn_mask(sub.pos, trainer_.num_neighbors)), sub,
                                    y_[:TRAIN_CMP_B].cpu().double())
        loss_.backward()
        ratio = max((blk.MultiHeadDotProductAttention_0.key.bias.grad.abs().max()
                     / blk.MultiHeadDotProductAttention_0.key.kernel.grad.abs().max()).item()
                    for blk in m.blocks)
        if not ratio <= GT_KEY_BIAS_GRAD_RTOL:
            fail(f"train-gt: the key biases' float64 gradient is {ratio:.3e} of their kernels' "
                 f"(limit {GT_KEY_BIAS_GRAD_RTOL}): not zero in exact arithmetic")
        del m, loss_
        return step_vs_cpu("train-gt", run_, payload_g, quiet_g, scene_, y_,
                           noise_only=("key.bias",)), ratio

    t0 = time.perf_counter()
    info, ((p_err_g, up_err_g, card_loss_g, cpu_loss_g), key_ratio), fresh_model, _ = \
        family_train("gt", battery.GT_CKPT, gt_argv, payload_g, GT_EPOCH, GT_COUNT, GT_PARAMS,
                     extra=gt_extra)
    del fresh_model
    print(f"  train-gt: one step, card f32 vs CPU f64 on {TRAIN_CMP_B} sims (no dropout): loss "
          f"{card_loss_g:.8f} / {cpu_loss_g:.8f}, params max rel err {p_err_g:.3e} (limit "
          f"{TRAIN_PARAM_RTOL}), update max rel err {up_err_g:.3e} (limit {TRAIN_UPDATE_RTOL}); "
          f"the key biases' f64 gradient {key_ratio:.3e} of their kernels'", flush=True)
    report("train-gt", t0, B=GT_B, N=GT_N, **info,
           cmp_param_err=f"{p_err_g:.3e}", cmp_update_err=f"{up_err_g:.3e}",
           key_bias_grad_ratio=f"{key_ratio:.3e}")

    # --------------------------------------------------------- 43. battery-gt
    # `cli self-feed --draws 1 --seed 281` on a run dir of the queue's argv
    # around the committed checkpoint (train mode, live dropout), beside the
    # committed 12-draw battery of the same seed; survived 999 is the gate,
    # the p a class
    t0 = time.perf_counter()
    battery_g_s, info = family_battery("gt", battery.GT_CKPT, GT_DRAWS, GT_FRAMES, gt_argv)
    if info["survived"] != ",".join([str(GT_FRAMES - 1)] * GT_DRAWS):
        fail(f"battery-gt: survived {info['survived']}, want {GT_FRAMES - 1} in every draw")
    ref_six_g = battery.committed(BATTERY_SEED, battery.GT_COMMITTED)["six"]
    ref_g = battery.spread(ref_six_g)
    report("battery-gt", t0, battery_g_s, B=GT_B, N=GT_N, **info,
           committed_draws=len(ref_six_g), committed_six_best=f"{ref_g['best']:.4g}",
           committed_six_median=f"{ref_g['median']:.4g}",
           committed_six_worst=f"{ref_g['worst']:.4g}")
    del payload_g

    # ------------------------------------------------------------- 44. hpo-gt
    # each trial's widths and count the JAX package's bisection's (GT_HPO_WANT)
    family_hpo("graph_transformer", GT_HPO_WANT, tag="hpo-gt")

    # -------------------------------------------------------------- 45. painn
    # a fresh PaiNN at the width of its stability run (depth 2), from a seed: a forward
    # on a fresh GT frame on the card against the same model in float64 on
    # the CPU, its ms, busy share and kernels beside its bound, the parameter
    # count; rotation, translation and permutation equivariance.  PaiNN is
    # plain PyTorch: no kernel but the GT's
    t0 = time.perf_counter()
    nmodel, ncpu = fresh_pair("painn", PAINN_KW, PAINN_SEED, PAINN_PARAMS)
    scene_n, eval_counts["painn"] = ref_frame("painn", 60)
    out_card, _, fwd_err_n, fwd_scale_n = forward_vs_cpu("painn", nmodel, ncpu, scene_n,
                                                         PAINN_FWD_RTOL)
    with torch.no_grad():
        fwd_ms_n = cuda_ms(lambda: nmodel(scene_n, fc(scene_n)), iters=20)
        busy_n, top_n, launches_n = top_kernels(lambda: nmodel(scene_n, fc(scene_n)), n=8)
    # rotation (a proper one), translation and permutation of the scene: both
    # output vectors turn with the scene and follow its bodies, and a shift
    # changes nothing
    equiv_n = check_moves("painn", nmodel, scene_n, out_card, PAINN_EQUIV_RTOL,
                          rotation=proper_rotation(61))
    # the forward's operations (multiply-adds count 2): per layer the filter
    # MLP on the edge rows, the source MLP, the equivariant linear and the
    # mixing MLP on the node rows; the embeddings and the two readouts
    H_, R_, L_ = PAINN_KW["hidden_features"], PAINN_KW["num_rbf"], PAINN_KW["num_layers"]
    e_rows, n_rows = REF_B * REF_N * REF_N, REF_B * REF_N
    fwd_flops_n = 2.0 * (
        L_ * (e_rows * (R_ * H_ + 3 * H_ * H_) + n_rows * (3 * H_ * H_ + 9 * H_ * H_)
              + n_rows * (3 * 2 * H_ * H_ + 2 * H_ * 3 * H_ + 9 * H_ * H_))
        + n_rows * 2 * (2 * H_ + H_ * H_) + n_rows * 2 * (2 * H_ * H_ + 3 * H_ * H_ + 3 * H_))
    fwd_bytes_n = 4.0 * (PAINN_PARAMS + n_rows * 10 + n_rows * 6)
    fwd_bound_n, fwd_by_n = bound_ms(fwd_bytes_n, fwd_flops_n)
    print(f"  painn: forward, device busy {busy_share(busy_n, fwd_ms_n)}, {launches_n} kernels; "
          f"top kernels: {top_n}", flush=True)
    report("painn", t0, B=REF_B, N=REF_N, layers=L_, width=H_, num_rbf=R_,
           init=f"fresh, seed {PAINN_SEED}", n_params=PAINN_PARAMS,
           fwd_max_abs_err=f"{fwd_err_n:.3e}", max_abs_out=f"{fwd_scale_n:.3e}",
           rtol=PAINN_FWD_RTOL, fwd_ms=f"{fwd_ms_n:.4f}", fwd_bound_ms=f"{fwd_bound_n:.4f}",
           fwd_bound_by=fwd_by_n, fwd_gflop=f"{fwd_flops_n / 1e9:.2f}",
           fwd_busy_ms=("not measured" if busy_n is None else f"{busy_n:.3f}"),
           fwd_kernels=launches_n, equiv_rtol=PAINN_EQUIV_RTOL,
           **{f"{k}_max_abs_err": f"{v:.3e}" for k, v in equiv_n.items()},
           leapfrog_launches=eval_counts["painn"]["leapfrog"])

    # ------------------------------------------------------ 46. painn-rollout
    # 100 steps, as [ponita-rollout]
    t0 = time.perf_counter()
    info = family_rollout("painn", nmodel, ncpu, REF_B, REF_N, REF_SUBSTEPS, 62,
                          PAINN_CMP_B, PAINN_ROLL_RTOL, PAINN_NUDGE_FACTOR)
    del ncpu, nmodel, scene_n
    report("painn-rollout", t0, **info)

    # -------------------------------------------------------- 47. train-painn
    # the stability run's argv from a fresh initialisation, with one step
    # from the checkpoint it wrote against the same step on the CPU in
    # float64 ([train]'s gates); then a resume from that checkpoint
    t0 = time.perf_counter()
    info, (p_err_n, up_err_n, card_loss_n, cpu_loss_n), resumed_model, _ = family_train(
        "painn", None, PAINN_ARGV, None, 0, 0, PAINN_PARAMS,
        extra=lambda run_, scene_, y_: step_vs_cpu("train-painn", run_, written(run_), PAINN_KW,
                                                   scene_, y_))
    del resumed_model
    print(f"  train-painn: one step from the written checkpoint, card f32 vs CPU f64 on "
          f"{TRAIN_CMP_B} sims: loss {card_loss_n:.8f} / {cpu_loss_n:.8f}, params max rel err "
          f"{p_err_n:.3e} (limit {TRAIN_PARAM_RTOL}), update max rel err {up_err_n:.3e} (limit "
          f"{TRAIN_UPDATE_RTOL})", flush=True)
    report("train-painn", t0, B=REF_B, N=REF_N, **info,
           cmp_param_err=f"{p_err_n:.3e}", cmp_update_err=f"{up_err_n:.3e}")

    # ---------------------------------------------------------- 48. hpo-painn
    family_hpo("painn")

    # -------------------------------------------------------------- 49. cgenn
    # a fresh CGENN at its 10M run's shape (L6 h176, remat) from a seed: a
    # forward on a fresh GT frame on the card against the same model in
    # float64 on the CPU, its ms, busy share, kernels and peak memory beside
    # its bound, the parameter count; near-equivariance: the card at a rotated
    # scene against the CPU's float64 at that scene, the CPU's own rotation
    # residual printed; translation and permutation.  Plain PyTorch: no kernel
    # but the GT's
    launch_probe("before [cgenn]")
    t0 = time.perf_counter()
    cmodel, ccpu = fresh_pair("cgenn", CGENN_KW, CGENN_SEED, CGENN_PARAMS)
    scene_c, eval_counts["cgenn"] = ref_frame("cgenn", 70)
    torch.cuda.reset_peak_memory_stats(dev)
    start_c = torch.cuda.memory_allocated(dev)
    out_card, out_cpu, fwd_err_c, fwd_scale_c = forward_vs_cpu("cgenn", cmodel, ccpu, scene_c,
                                                               CGENN_FWD_RTOL)
    peak_c = (torch.cuda.max_memory_allocated(dev) - start_c) / 2**20
    with torch.no_grad():
        fwd_ms_c = cuda_ms(lambda: cmodel(scene_c, fc(scene_c)), iters=10)
        busy_c, top_c, launches_c = top_kernels(lambda: cmodel(scene_c, fc(scene_c)), n=8)
    R_c = proper_rotation(71)
    _, want_rot, rot_err_c, _ = forward_vs_cpu(
        "cgenn at the rotated scene", cmodel, ccpu, turn_scene(scene_c, R_c.float().to(dev)),
        CGENN_EQUIV_RTOL)
    # the model's own rotation residual, in float64 on the CPU: not zero (the
    # algebra's signature is the metric's eigenvalues), the same as the JAX
    # model's (tests/test_torch_cgenn_model.py)
    residual_c = ((want_rot - turn_out(out_cpu, R_c)).abs().max().item() / fwd_scale_c)
    equiv_c = check_moves("cgenn", cmodel, scene_c, out_card, CGENN_EQUIV_RTOL, rotation=None)
    fwd_flops_c = cgenn_forward_flops(CGENN_KW["hidden_features"], CGENN_KW["num_layers"],
                                      REF_B, REF_N)
    fwd_bound_c, fwd_by_c = bound_ms(4.0 * (CGENN_PARAMS + REF_B * REF_N * 10), fwd_flops_c)
    print(f"  cgenn: forward, device busy {busy_share(busy_c, fwd_ms_c)}, {launches_c} kernels; "
          f"top kernels: {top_c}", flush=True)
    report("cgenn", t0, B=REF_B, N=REF_N, layers=CGENN_KW["num_layers"],
           width=CGENN_KW["hidden_features"], remat=True, init=f"fresh, seed {CGENN_SEED}",
           n_params=CGENN_PARAMS, fwd_max_abs_err=f"{fwd_err_c:.3e}",
           max_abs_out=f"{fwd_scale_c:.3e}", rtol=CGENN_FWD_RTOL, fwd_ms=f"{fwd_ms_c:.4f}",
           fwd_bound_ms=f"{fwd_bound_c:.4f}", fwd_bound_by=fwd_by_c,
           fwd_gflop=f"{fwd_flops_c / 1e9:.2f}",
           fwd_busy_ms=("not measured" if busy_c is None else f"{busy_c:.3f}"),
           fwd_kernels=launches_c, fwd_peak_mib_above_start=f"{peak_c:.1f}",
           rot_card_vs_cpu64_max_abs_err=f"{rot_err_c:.3e}",
           cpu64_rotation_residual=f"{residual_c:.3e}", equiv_rtol=CGENN_EQUIV_RTOL,
           **{f"{k}_max_abs_err": f"{v:.3e}" for k, v in equiv_c.items()},
           leapfrog_launches=eval_counts["cgenn"]["leapfrog"])

    # ------------------------------------------------------ 50. cgenn-rollout
    # a fresh CGENN of its own at depth 2 (CGENN_ROLL_KW), every gate as at L6
    del ccpu, cmodel, scene_c
    t0 = time.perf_counter()
    rmodel, rcpu = fresh_pair("cgenn", CGENN_ROLL_KW, CGENN_SEED, CGENN_ROLL_PARAMS)
    info = family_rollout("cgenn", rmodel, rcpu, REF_B, REF_N, REF_SUBSTEPS, 72, CGENN_CMP_B,
                          CGENN_ROLL_RTOL, CGENN_NUDGE_FACTOR)
    del rmodel, rcpu
    report("cgenn-rollout", t0, layers=CGENN_ROLL_KW["num_layers"], n_params=CGENN_ROLL_PARAMS,
           **info)

    # -------------------------------------------------------- 51. train-cgenn
    # the 10M run's argv from a fresh initialisation, with one step from the
    # checkpoint it wrote against the same step on the CPU in float64
    # ([train]'s gates); then a resume from that checkpoint
    t0 = time.perf_counter()
    info, (p_err_c, up_err_c, card_loss_c, cpu_loss_c), resumed_model, _ = family_train(
        "cgenn", None, CGENN_ARGV, None, 0, 0, CGENN_PARAMS,
        extra=lambda run_, scene_, y_: step_vs_cpu("train-cgenn", run_, written(run_), CGENN_KW,
                                                   scene_, y_, zero_init=CGENN_ZERO_INIT))
    del resumed_model
    print(f"  train-cgenn: one step from the written checkpoint, card f32 vs CPU f64 on "
          f"{TRAIN_CMP_B} sims: loss {card_loss_c:.8f} / {cpu_loss_c:.8f}, params max rel err "
          f"{p_err_c:.3e} (limit {TRAIN_PARAM_RTOL}), update max rel err {up_err_c:.3e} (limit "
          f"{TRAIN_UPDATE_RTOL})", flush=True)
    report("train-cgenn", t0, B=REF_B, N=REF_N, **info,
           cmp_param_err=f"{p_err_c:.3e}", cmp_update_err=f"{up_err_c:.3e}")

    # ---------------------------------------------------------- 52. hpo-cgenn
    # each trial's widths and count the JAX package's bisection's (CGENN_HPO_WANT)
    family_hpo("cgenn", CGENN_HPO_WANT)

    # ---------------------------------------------------------------- 53. gmn
    # a fresh GMN at its defaults from a seed: a forward on a fresh GT frame
    # against the CPU's float64 beside its bound; rotation, translation and
    # permutation on the card; the stick and hinge compositions on seeded
    # scenes against the CPU's float64; the parameter count
    t0 = time.perf_counter()
    gmodel, gcpu = fresh_pair("gmn", GMN_KW, GMN_SEED, GMN_PARAMS)
    scene_m, eval_counts["gmn"] = ref_frame("gmn", 80)
    out_card_m, _, fwd_err_m, fwd_scale_m = forward_vs_cpu("gmn", gmodel, gcpu, scene_m,
                                                           GMN_FWD_RTOL)
    with torch.no_grad():
        fwd_ms_m = cuda_ms(lambda: gmodel(scene_m, fc(scene_m)), iters=20)
        busy_m, top_m, launches_m = top_kernels(lambda: gmodel(scene_m, fc(scene_m)), n=8)
    equiv_m = check_moves("gmn", gmodel, scene_m, out_card_m, GMN_EQUIV_RTOL,
                          rotation=proper_rotation(81))
    comp_err = {}
    for i, (iso, st, hi) in enumerate(GMN_COMPOSITIONS):
        kw_o = dict(GMN_KW, n_isolated=iso, n_stick=st, n_hinge=hi)
        nn_o = iso + 2 * st + 3 * hi
        torch.manual_seed(GMN_SEED + 1 + i)
        cpu_o = models.create_model("gmn", device="cpu", dtype=torch.float64, **kw_o).eval()
        card_o = models.create_model("gmn", device=dev, **kw_o).eval()
        card_o.load_state_dict(cpu_o.state_dict())
        g_o = torch.Generator().manual_seed(82 + i)
        s_k = Scene(pos=torch.randn((4, nn_o, 3), generator=g_o) * 1.5,
                    vel=torch.randn((4, nn_o, 3), generator=g_o) * 0.5,
                    force=torch.zeros((4, nn_o, 3)), mass=torch.ones((4, nn_o, 1)))
        s_k = Scene(*(t_.to(dev) for t_ in (s_k.pos, s_k.vel, s_k.force, s_k.mass)))
        comp_err[(iso, st, hi)] = forward_vs_cpu(f"gmn composition {(iso, st, hi)}", card_o,
                                                 cpu_o, s_k, GMN_FWD_RTOL)[2]
        del cpu_o, card_o
    # per layer the edge MLP, the force weight and the node MLP, on 1,600 edge
    # and 320 node rows; the velocity gate; the embedding (multiply-adds count 2)
    H_m, L_m = GMN_KW["hidden_features"], GMN_KW["num_layers"]
    e_rows_m, n_rows_m = REF_B * REF_N * REF_N, REF_B * REF_N
    fwd_flops_m = 2.0 * (L_m * (e_rows_m * ((2 * H_m + 2) * H_m + 2 * H_m * H_m + H_m)
                                + n_rows_m * (4 * H_m * H_m + H_m * H_m + H_m))
                         + n_rows_m * 2 * H_m)
    fwd_bound_m, fwd_by_m = bound_ms(4.0 * (GMN_PARAMS + n_rows_m * 10 + n_rows_m * 6),
                                     fwd_flops_m)
    print(f"  gmn: forward, device busy {busy_share(busy_m, fwd_ms_m)}, {launches_m} kernels; "
          f"top kernels: {top_m}", flush=True)
    report("gmn", t0, B=REF_B, N=REF_N, layers=L_m, width=H_m, n_isolated=GMN_KW["n_isolated"],
           init=f"fresh, seed {GMN_SEED}", n_params=GMN_PARAMS,
           fwd_max_abs_err=f"{fwd_err_m:.3e}", max_abs_out=f"{fwd_scale_m:.3e}",
           rtol=GMN_FWD_RTOL, fwd_ms=f"{fwd_ms_m:.4f}", fwd_bound_ms=f"{fwd_bound_m:.5f}",
           fwd_bound_by=fwd_by_m, fwd_gflop=f"{fwd_flops_m / 1e9:.3f}",
           fwd_busy_ms=("not measured" if busy_m is None else f"{busy_m:.3f}"),
           fwd_kernels=launches_m, equiv_rtol=GMN_EQUIV_RTOL,
           **{f"{k}_max_abs_err": f"{v:.3e}" for k, v in equiv_m.items()},
           **{f"composition_{a}_{b}_{c}_max_abs_err": f"{v:.3e}"
              for (a, b, c), v in comp_err.items()},
           leapfrog_launches=eval_counts["gmn"]["leapfrog"])

    # -------------------------------------------------------- 54. gmn-rollout
    t0 = time.perf_counter()
    info = family_rollout("gmn", gmodel, gcpu, REF_B, REF_N, REF_SUBSTEPS, 83, GMN_CMP_B,
                          GMN_ROLL_RTOL, GMN_NUDGE_FACTOR)
    del gcpu, gmodel, scene_m
    report("gmn-rollout", t0, **info)

    # ---------------------------------------------------------- 55. train-gmn
    t0 = time.perf_counter()
    info, (p_err_m, up_err_m, card_loss_m, cpu_loss_m), resumed_model, _ = family_train(
        "gmn", None, GMN_ARGV, None, 0, 0, GMN_PARAMS,
        extra=lambda run_, scene_, y_: step_vs_cpu("train-gmn", run_, written(run_), GMN_KW,
                                                   scene_, y_))
    del resumed_model
    print(f"  train-gmn: one step from the written checkpoint, card f32 vs CPU f64 on "
          f"{TRAIN_CMP_B} sims: loss {card_loss_m:.8f} / {cpu_loss_m:.8f}, params max rel err "
          f"{p_err_m:.3e} (limit {TRAIN_PARAM_RTOL}), update max rel err {up_err_m:.3e} (limit "
          f"{TRAIN_UPDATE_RTOL})", flush=True)
    report("train-gmn", t0, B=REF_B, N=REF_N, **info,
           cmp_param_err=f"{p_err_m:.3e}", cmp_update_err=f"{up_err_m:.3e}")

    # ------------------------------------------------------------ 56. hpo-gmn
    # GMN's search space has no width knob: two free trials
    family_hpo("gmn", mode="free")

    # ---------------------------------------------------------- 57. legacy-sims
    # the spring and charged sims at their defaults through the samplers on the
    # card: shapes, couplings, charges; the first frames against the CPU's
    # float64 from the same initial arrays (redrawn from the same seed),
    # beside the CPU float32's error from them; seconds and launches a step
    def launches_per_step(run) -> float:
        """Kernels a step of an integrator: ``run(steps)`` integrates ``steps``
        steps (saving the same frames at either length); torch.profiler's
        kernel count at 2 LAUNCH_COUNT_STEPS less that at LAUNCH_COUNT_STEPS,
        over LAUNCH_COUNT_STEPS; NaN where it saw no kernel.  The traces'
        events are collected before the next phase."""
        n = LAUNCH_COUNT_STEPS
        counts_ = [top_kernels(functools.partial(run, steps))[2] for steps in (n, 2 * n)]
        gc.collect()
        return float("nan") if None in counts_ else (counts_[1] - counts_[0]) / n

    def f32_gate(tag: str, card_a, f64_a, cpu32_a) -> dict:
        """The card's float32 frames against float64 ones from the same
        arrays, within INTEGRATOR_F32_FACTOR times the CPU float32's error or
        INTEGRATOR_ATOL_REL of the largest value."""
        card_a, cpu32_a = card_a.double().cpu(), cpu32_a.double()
        err, ref = (card_a - f64_a).abs().max().item(), (cpu32_a - f64_a).abs().max().item()
        scale = f64_a.abs().max().item()
        limit = max(INTEGRATOR_F32_FACTOR * ref, INTEGRATOR_ATOL_REL * scale)
        if not (torch.isfinite(card_a).all() and err <= limit):
            fail(f"{tag}: the card's first frames differ from the CPU's float64 ones by {err} "
                 f"(limit {limit}; CPU float32 {ref}, max |value| {scale})")
        return {"err": err, "cpu32_err": ref, "limit": limit}

    t0 = time.perf_counter()
    legacy_info = {}
    for sim_kind, sampler, initial_of, params_l in (
            ("spring", legacy.sample_spring_batch, legacy.spring_initial, legacy.SpringParams()),
            ("charged", legacy.sample_charged_batch, legacy.charged_initial,
             legacy.ChargedParams())):
        seed_l = 90 if sim_kind == "spring" else 91
        reset_counts()
        t = time.perf_counter()
        out_l = sampler(LEGACY_S, LEGACY_N, T=LEGACY_T, sample_freq=LEGACY_FREQ,
                        generator=torch.Generator(device=dev).manual_seed(seed_l), device=dev)
        sync()
        secs_l = time.perf_counter() - t
        counted({}, f"legacy-sims {sim_kind}")
        loc_l, vel_l, edges_l = out_l[:3]
        frames_l = LEGACY_T // LEGACY_FREQ - 1
        if (tuple(loc_l.shape) != (LEGACY_S, frames_l, 3, LEGACY_N)
                or tuple(vel_l.shape) != tuple(loc_l.shape)
                or not (torch.isfinite(loc_l).all() and torch.isfinite(vel_l).all())):
            fail(f"legacy-sims {sim_kind}: shape {tuple(loc_l.shape)} or not finite")
        if sim_kind == "spring":
            ok = (torch.equal(edges_l, edges_l.transpose(1, 2))
                  and bool((torch.diagonal(edges_l, dim1=1, dim2=2) == 0).all())
                  and set(edges_l.unique().tolist()) <= {0.0, 1.0}
                  and loc_l.abs().max().item() < 50.0)
        else:
            q_l = out_l[3]
            ok = (set(q_l.unique().tolist()) <= {-1.0, 1.0}
                  and torch.equal(edges_l, q_l @ q_l.transpose(1, 2)))
        if not ok:
            fail(f"legacy-sims {sim_kind}: couplings, charges or bounds wrong")
        init_l = initial_of(LEGACY_S, LEGACY_N, params_l,
                            generator=torch.Generator(device=dev).manual_seed(seed_l), device=dev)
        short_t = (LEGACY_CMP_FRAMES + 1) * LEGACY_FREQ

        def simulate_from(arrays, dtype):
            a = [t_.detach().cpu().to(dtype) for t_ in arrays]
            forces_fn = ((lambda loc, e=-params_l.interaction_strength * a[2]: e)
                         if sim_kind == "spring"
                         else legacy.charged_forces(a[2], params_l.interaction_strength))
            return legacy.simulate(a[0], a[1], forces_fn, params_l, short_t, LEGACY_FREQ)[0]

        gate_l = f32_gate(f"legacy-sims {sim_kind}", loc_l[:, :LEGACY_CMP_FRAMES],
                          simulate_from(init_l, torch.float64),
                          simulate_from(init_l, torch.float32))
        if sim_kind == "spring":
            e_dev = -params_l.interaction_strength * init_l[2]
            f_dev = lambda loc: e_dev  # noqa: E731
        else:
            f_dev = legacy.charged_forces(init_l[2], params_l.interaction_strength)
        # one frame, after ``steps`` steps, in either run
        lp = launches_per_step(lambda steps: legacy.simulate(
            init_l[0], init_l[1], f_dev, params_l, 2 * steps, steps))
        legacy_info.update({f"{sim_kind}_s": f"{secs_l:.3f}", f"{sim_kind}_launches_per_step": f"{lp:.1f}",
                            f"{sim_kind}_first_frames_err": f"{gate_l['err']:.3e}",
                            f"{sim_kind}_cpu32_err": f"{gate_l['cpu32_err']:.3e}",
                            f"{sim_kind}_limit": f"{gate_l['limit']:.3e}"})
        del out_l, loc_l, vel_l, edges_l, init_l
    report("legacy-sims", t0, sims=LEGACY_S, N=LEGACY_N, steps=LEGACY_T, frames=frames_l,
           cmp_frames=LEGACY_CMP_FRAMES, **legacy_info)

    # ------------------------------------------------------- 58. offline-datagen
    # both offline datasets at the JAX package's defaults, generated on the
    # card into a temporary directory the training phases read: files, shapes
    # and dtypes; the first frames against the CPU's float64 from the same
    # arrays (redrawn from the splits' generators); the valid split's
    # constraints over all 5000 steps beside the CPU float32's drift; the first
    # 1000 steps made again, every frame bitwise equal; seconds and launches a
    # step
    t0 = time.perf_counter()
    offline_tmp = tempfile.TemporaryDirectory()
    offline_dir = os.path.join(offline_tmp.name, "data")
    datagen_info = {}

    def constraint_drift(loc, n_iso: int, n_st: int, n_hi: int) -> float:
        """The largest relative change of a stick's or a hinge beam's length
        over the frames of ``loc [S, T, N, 3]`` (0 without either)."""
        pairs = [(n_iso + 2 * k, n_iso + 2 * k + 1) for k in range(n_st)]
        p0 = n_iso + 2 * n_st
        pairs += [(p0 + 3 * k, p0 + 3 * k + b) for k in range(n_hi) for b in (1, 2)]
        worst = 0.0
        for a_, b_ in pairs:
            length = np.linalg.norm(loc[:, :, a_] - loc[:, :, b_], axis=-1)
            worst = max(worst, float(np.abs(length / length[:, :1] - 1).max()))
        return worst

    for comp in OFFLINE_SETS:
        name_o = "_".join(map(str, comp))
        n_o = comp[0] + 2 * comp[1] + 3 * comp[2]
        reset_counts()
        t = time.perf_counter()
        tag_o = offline_datagen.generate_offline_dataset(
            offline_dir, *comp, *OFFLINE_SIMS, OFFLINE_T, OFFLINE_T, OFFLINE_FREQ, OFFLINE_SEED,
            device=dev)
        sync()
        gen_s = time.perf_counter() - t
        counted({}, f"offline-datagen {name_o}")
        if tag_o != f"_charged{name_o}":
            fail(f"offline-datagen: tag {tag_o}")
        cfg_o = offline_datagen.object_config(*comp)
        frames_o = OFFLINE_T // OFFLINE_FREQ
        locs_o, vels_o = [], []
        for split, sims_o in zip(offline_datagen.SPLITS, OFFLINE_SIMS):
            arrays_o = {}
            for field, shape in (("loc", (sims_o, frames_o, n_o, 3)),
                                 ("vel", (sims_o, frames_o, n_o, 3)),
                                 ("edges", (sims_o, n_o, n_o)), ("charges", (sims_o, n_o, 1))):
                fname = f"{field}_{split}{tag_o}.npy"
                a_ = np.load(os.path.join(offline_dir, fname))
                if a_.shape != shape or a_.dtype != np.float32 or not np.isfinite(a_).all():
                    fail(f"offline-datagen {name_o}: {fname} is {a_.shape} {a_.dtype}, want "
                         f"{shape} float32, finite")
                arrays_o[field] = a_
            with open(os.path.join(offline_dir, f"cfg_{split}{tag_o}.pkl"), "rb") as f:
                if pickle.load(f) != [cfg_o] * sims_o:
                    fail(f"offline-datagen {name_o}: cfg_{split} is not {cfg_o} a system")
            q_o = arrays_o["charges"]
            if not (set(np.unique(q_o)) <= {-1.0, 1.0}
                    and np.array_equal(arrays_o["edges"], q_o @ q_o.transpose(0, 2, 1))):
                fail(f"offline-datagen {name_o}: {split} edges are not q q^T of charges +-1")
            locs_o.append(arrays_o["loc"])
            vels_o.append(arrays_o["vel"])
        locs_o, vels_o = np.concatenate(locs_o), np.concatenate(vels_o)
        # every split's initial arrays, as its generator drew them on the card
        X_o, V_o, q_o = (torch.cat(a_) for a_ in zip(*(
            offline_datagen.sample_initial_state(
                sims_o, n_o, generator=offline_datagen.split_generator(OFFLINE_SEED, i, dev),
                device=dev) for i, sims_o in enumerate(OFFLINE_SIMS))))
        t = time.perf_counter()
        rep_loc, rep_vel = (a_.cpu().numpy() for a_ in offline_datagen.integrate_systems(
            X_o, V_o, q_o, *comp, OFFLINE_REPEAT_FRAMES * OFFLINE_FREQ, OFFLINE_FREQ)[:2])
        repeat_s = time.perf_counter() - t
        if not (np.array_equal(rep_loc, locs_o[:, :OFFLINE_REPEAT_FRAMES])
                and np.array_equal(rep_vel, vels_o[:, :OFFLINE_REPEAT_FRAMES])):
            fail(f"offline-datagen {name_o}: the first {OFFLINE_REPEAT_FRAMES} frames differ "
                 f"when made again from the same draws")
        i_d = offline_datagen.SPLITS.index(OFFLINE_DRIFT_SPLIT)
        drift_sims = slice(sum(OFFLINE_SIMS[:i_d]), sum(OFFLINE_SIMS[:i_d + 1]))

        def cpu_run(dtype, steps, sims=slice(None)):
            return offline_datagen.integrate_systems(
                X_o[sims].cpu().to(dtype), V_o[sims].cpu().to(dtype), q_o[sims].cpu().to(dtype),
                *comp, steps, OFFLINE_FREQ)[0]

        cmp_steps = OFFLINE_CMP_FRAMES * OFFLINE_FREQ
        gate_o = f32_gate(f"offline-datagen {name_o}",
                          torch.from_numpy(locs_o[:, :OFFLINE_CMP_FRAMES]),
                          cpu_run(torch.float64, cmp_steps), cpu_run(torch.float32, cmp_steps))
        if comp[1] or comp[2]:
            drift_o = constraint_drift(locs_o[drift_sims], *comp)
            t = time.perf_counter()
            cpu_drift = constraint_drift(cpu_run(torch.float32, OFFLINE_T, drift_sims).numpy(),
                                         *comp)
            datagen_info[f"{name_o}_cpu32_drift_s"] = f"{time.perf_counter() - t:.3f}"
            if not drift_o <= CONSTRAINT_FACTOR * cpu_drift:
                fail(f"offline-datagen {name_o}: {OFFLINE_DRIFT_SPLIT} stick / hinge lengths "
                     f"drift by {drift_o:.3e} over {OFFLINE_T} steps, over {CONSTRAINT_FACTOR}x "
                     f"the CPU float32's {cpu_drift:.3e} from the same arrays")
            datagen_info.update({f"{name_o}_constraint_drift": f"{drift_o:.3e}",
                                 f"{name_o}_cpu32_drift": f"{cpu_drift:.3e}"})
        lp_o = launches_per_step(lambda steps: offline_datagen.integrate_systems(
            X_o, V_o, q_o, *comp, steps, steps))
        datagen_info.update({f"{name_o}_s": f"{gen_s:.3f}",
                             f"{name_o}_repeat_s": f"{repeat_s:.3f}",
                             f"{name_o}_launches_per_step": f"{lp_o:.1f}",
                             f"{name_o}_first_frames_err": f"{gate_o['err']:.3e}",
                             f"{name_o}_cpu32_err": f"{gate_o['cpu32_err']:.3e}"})
        del X_o, V_o, q_o, locs_o, vels_o, rep_loc, rep_vel
    report("offline-datagen", t0, sims="/".join(map(str, OFFLINE_SIMS)), steps=OFFLINE_T,
           frames=OFFLINE_T // OFFLINE_FREQ, seed=OFFLINE_SEED, cmp_frames=OFFLINE_CMP_FRAMES,
           repeat_frames=OFFLINE_REPEAT_FRAMES, drift_split=OFFLINE_DRIFT_SPLIT, **datagen_info)

    # ------------------------------------- 59-61. train-offline-{segnn,egnn,gmn}
    def offline_train(tag: str, model_argv, dataset: str, cutoff: float, eval_kernel=None):
        """`cli train --main.dataloader_type segnn_nbody_offline` on ``dataset``
        at ``cutoff``: OFFLINE_EPOCHS epochs of OFFLINE_STEPS steps (no kernel),
        each epoch's validation on OFFLINE_VALID_BATCHES batches of the valid
        split with their masks (``eval_kernel`` once a layer a batch, or no
        kernel), finite losses, the checkpoint read back bitwise, one step
        from it against the CPU's float64 step on a training batch and its
        mask ([train]'s gates), step ms; then resumed from a copy of the
        checkpoint for one epoch of OFFLINE_RESUME_STEPS steps, the AdamW
        count and the epoch going on.  Returns the phase's fields and the
        first run's trainer."""
        argv = model_argv + [
            "--main.dataloader_type", "segnn_nbody_offline",
            "--dataloader.offline_dataset.dataset_name", dataset,
            "--dataloader.offline_dataset.data_directory", offline_dir,
            "--dataloader.offline_dataset.cutoff_rate", str(cutoff), "--dataloader.seed", "0",
            "--trainer.save_model_every", "1", "--trainer.test_macros_every", "1000",
            "--trainer.validation.do_validation=true", "--trainer.seed", "0"]
        valid_counts = collections.Counter()
        validate = trainer_mod.Trainer.validate_one_epoch

        def counted_validate(self, num_batches=OFFLINE_VALID_BATCHES):
            before = counts()
            out = validate(self, num_batches)
            sync()
            valid_counts.update({k: v - before[k] for k, v in counts().items()})
            valid_losses.append(out["valid/loss"])
            return out

        def run_cli(extra, epochs, steps):
            valid_counts.clear()
            reset_counts()
            t = time.perf_counter()
            with mock.patch.object(trainer_mod.Trainer, "validate_one_epoch", counted_validate):
                trainer_ = cli.train_main(argv + extra + ["--trainer.steps_per_epoch", str(steps)])
            sync()
            secs = time.perf_counter() - t
            total = counts()
            training = {k: total[k] - valid_counts[k] for k in total}
            if any(training.values()):
                fail(f"{tag}: its training launched {training}, want no kernel")
            want_v = dict.fromkeys(counters, 0)
            if eval_kernel:
                want_v[eval_kernel] = LAYERS * OFFLINE_VALID_BATCHES * epochs
            if dict(valid_counts) != want_v:
                fail(f"{tag}: its validation launched {dict(valid_counts)}, want {want_v}")
            with open(os.path.join(trainer_.save_dir_path, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            losses_ = [r["train/loss"] for r in recs if "train/loss" in r]
            if len(losses_) != epochs or not np.all(np.isfinite(losses_ + valid_losses[-epochs:])):
                fail(f"{tag}: epoch losses {losses_}, valid losses {valid_losses}")
            return trainer_, secs, training, dict(valid_counts), losses_

        valid_losses = []
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
            trainer_o, secs_o, train_c, valid_c, losses_o = run_cli(
                ["--trainer.train_steps", str(OFFLINE_EPOCHS), "--trainer.run_name", tag],
                OFFLINE_EPOCHS, OFFLINE_STEPS)
            if not (trainer_o._data_masks and trainer_o.optim.count == OFFLINE_EPOCHS * OFFLINE_STEPS
                    and trainer_o.dataset.num_nodes == trainer_o.valid_dataset.num_nodes
                    and trainer_o.valid_dataset.partition == "valid"):
                fail(f"{tag}: data masks {trainer_o._data_masks}, AdamW count "
                     f"{trainer_o.optim.count}")
            train_counts[f"train_offline_{tag}"] = train_c
            eval_counts[f"train_offline_{tag}_valid"] = valid_c
            count0, epoch0 = trainer_o.optim.count, trainer_o.step_count
            batch = trainer_o.args.batch_size
            saved = os.path.abspath(os.path.join(trainer_o.save_dir_path, "model.ckpt"))
            back = weights.params_from_jax(weights.read_jax_checkpoint(saved))
            if not all(torch.equal(back[k], v.cpu()) for k, v in trainer_o.model.state_dict().items()):
                fail(f"{tag}: {saved} does not read back bitwise through params_from_jax")
            scene_o, y_o, mask_o = trainer_o.dataset.get_batch()
            if scene_o.charge is None or mask_o.dtype != torch.bool:
                fail(f"{tag}: the offline batch has no charge or no boolean mask")
            step_ms = cuda_ms(lambda: trainer_o._train_step(scene_o, y_o, mask_o),
                              iters=TIMED_STEPS)
            p_err, up_err, card_loss, cpu_loss = step_vs_cpu(
                f"train-offline-{tag}", dict(trainer=trainer_o, args=trainer_o.args),
                weights.read_checkpoint(saved), trainer_o.args.model_kwargs, scene_o, y_o,
                mask=mask_o)
            more = {}
            if eval_kernel:
                more = offline_k1(trainer_o)
            del trainer_o
            os.makedirs("resumed")
            os.chdir("resumed")
            trainer_r, secs_r, train_r, valid_r, losses_r = run_cli(
                ["--trainer.model_path", shutil.copy(saved, "."), "--trainer.train_steps",
                 str(OFFLINE_EPOCHS + 1), "--trainer.run_name", f"{tag}_resumed"],
                1, OFFLINE_RESUME_STEPS)
            if (trainer_r.optim.count != count0 + OFFLINE_RESUME_STEPS
                    or trainer_r.step_count != epoch0 + 1):
                fail(f"{tag}: resumed at AdamW count {trainer_r.optim.count - OFFLINE_RESUME_STEPS}"
                     f", epoch {trainer_r.step_count - 1}; saved {count0}, {epoch0}")
            train_counts[f"train_offline_{tag}_resumed"] = train_r
            eval_counts[f"train_offline_{tag}_resumed_valid"] = valid_r
            del trainer_r
        print(f"  train-offline-{tag}: losses {' '.join(f'{x:.5f}' for x in losses_o)}, valid "
              f"losses {' '.join(f'{x:.5f}' for x in valid_losses)}; one step, card f32 vs CPU "
              f"f64 on {TRAIN_CMP_B} sims: loss {card_loss:.8f} / {cpu_loss:.8f}", flush=True)
        return dict(B=batch, dataset=dataset, cutoff_rate=cutoff,
                    steps=OFFLINE_EPOCHS * OFFLINE_STEPS, train_s=f"{secs_o:.3f}",
                    ms_per_step=f"{step_ms:.3f}", valid_batches=OFFLINE_VALID_BATCHES * OFFLINE_EPOCHS,
                    valid_loss_last=f"{valid_losses[OFFLINE_EPOCHS - 1]:.5f}",
                    cmp_param_err=f"{p_err:.3e}", cmp_update_err=f"{up_err:.3e}",
                    resumed_steps=OFFLINE_RESUME_STEPS, resumed_count=f"{count0}->"
                    f"{count0 + OFFLINE_RESUME_STEPS}", resumed_s=f"{secs_r:.3f}",
                    resumed_loss=f"{losses_r[0]:.5f}", **more)

    def offline_k1(trainer_o) -> dict:
        """K1 against its plain version on the first layer's inputs of a valid
        batch under its cutoff-rate mask, and under that mask with receiver 0
        of the first sim given no sender (a zero-degree row); the launches
        counted."""
        scene_v, _, mask_v = trainer_o.valid_dataset.get_batch()
        model_v = trainer_o.model
        block_v = model_v.layers[0]
        zero = mask_v.clone()
        zero[0, 0, :] = False
        errs = {}
        reset_counts()
        with torch.no_grad():
            x_v, ea_v = model_v.featurize(scene_v)
            args_v = block_v.edge_inputs(model_v.embedding(x_v), scene_v.pos, ea_v)
            w_v = block_v.edge_weights()
            for label, m in (("cutoff mask", mask_v), ("cutoff mask, a zero-degree row", zero)):
                got = EM.fused_egnn_messages(*args_v, m.float(), *w_v)
                check_close("K1", f"offline {label}", got,
                            EM.egnn_messages_plain(*args_v, m.float(), *w_v), errs)
                if label.endswith("row") and not (got[0][0, 0] == 0).all():
                    fail("K1: a receiver with no sender has a nonzero agg")
        sync()
        counted({"k1": 2}, "train-offline-egnn K1 check")
        print_errs("K1", errs)
        degrees = mask_v.sum(-1)
        return dict(k1_cmp_launches=2, k1_max_abs_err=f"{max(a for a, _ in errs.values()):.3e}",
                    valid_mask_edges=int(mask_v.sum()),
                    valid_zero_degree_rows=int((degrees == 0).sum()))

    for tag_t, (argv_t, dataset_t, cutoff_t) in OFFLINE_TRAIN.items():
        t0 = time.perf_counter()
        info = offline_train(tag_t, argv_t, dataset_t, cutoff_t,
                             eval_kernel="k1" if tag_t == "egnn" else None)
        report(f"train-offline-{tag_t}", t0, **info)
    offline_tmp.cleanup()

    launch_probe("end")

    # --------------------------------------------------------------- 62. bign
    t0 = time.perf_counter()
    state = bign_bench.seeded_state(2)
    rows = []
    for nn_, bb in bign_bench.SHAPES:
        for path, streaming in bign_bench.PATHS.items():
            reset_counts()
            row = bign_bench.measure_row(nn_, bb, path, BIGN_STEPS, state, dev)
            got = counts()
            want = dict.fromkeys(counters, 0)
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

    # --------------------------------------------------- 63-64. dp-train, ring
    torch.cuda.empty_cache()
    parallel_counts = _dp_train_phase(dev)
    torch.cuda.empty_cache()
    parallel_counts.update(_ring_phase(dev, {k: v.cpu() for k, v in model.state_dict().items()}))

    kernels = [
        {
            "name": "egnn_messages (K1)",
            "route": "cuda",
            "reworked": "PR 8",
            "redesigned": "PR 17",
            "source": f"{PKG}/csrc/egnn_messages.cu",
            "replaces": f"{TPU_PKG}/ops/pallas/egnn_messages.py:197",
            "launches": main_counts["k1"],
            "max_abs_err": max(a for a, _ in k1_err.values()),
            "ms": k1_ms,
            "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound,
            "bound_by": k1_by,
            "bound_fma_ms": k1_bound_fma,
            "library_ms": None,
        },
        {
            "name": "gravity (K2)",
            "route": "cuda",
            "source": f"{PKG}/csrc/gravity.cu",
            "replaces": f"{TPU_PKG}/ops/pallas/gravity.py:69",
            # the main path's GT goes through K2-leapfrog; K2 runs GT above its limit
            "path": f"datagen-substeps, B={FAR_B} N={FAR_N}",
            "launches": far_counts[FAR_N]["k2"],
            "max_abs_err": k2_err,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound,
            "bound_by": k2_by,
            "library_ms": None,
        },
        {
            "name": "gravity leapfrog (K2-leapfrog)",
            "route": "cuda",
            "source": f"{PKG}/csrc/gravity.cu",
            "replaces": f"{TPU_PKG}/ops/pallas/gravity.py:69",
            "launches": main_counts["leapfrog"],
            "max_abs_err": lf_err,
            "ms": lf_ms,
            "plain_ms": lf_plain_ms,
            "bound_ms": lf_bound,
            "bound_by": lf_by,
            "library_ms": None,
        },
        {
            "name": "egnn_stream (K3)",
            "route": "cuda",
            "reworked": "PR 8",
            "redesigned": "PR 17",
            "source": f"{PKG}/csrc/egnn_stream.cu",
            "replaces": f"{TPU_PKG}/ops/pallas/egnn_stream.py:192",
            "launches": big_counts["k3"],
            "max_abs_err": max(a for a, _ in k3_err.values()),
            "ms": k3_ms,
            "plain_ms": k3_plain_ms,
            "bound_ms": k3_bound,
            "bound_by": k3_by,
            "bound_fma_ms": k3_bound_fma,
            "library_ms": None,
        },
        {
            "name": "egnn_messages bf16 (K1-bf16)",
            "route": "cuda",
            "reworked": "PR 8",
            "redesigned": "PR 18",
            "source": f"{PKG}/csrc/egnn_messages.cu",
            "replaces": f"{TPU_PKG}/ops/pallas/egnn_messages.py:197",
            "launches": bf16_counts["k1_bf16"],
            "max_abs_err": max(a for a, _ in k1b_err.values()),
            "ms": k1b_ms,
            "plain_ms": k1b_plain_ms,
            "bound_ms": k1b_bound,
            "bound_by": k1b_by,
            "sfu_floor_ms": k1b_sfu,
            "sm_clock_mhz": sm_clock_mhz,
            "library_ms": None,
        },
    ]
    for form, kernel in (("K3-bf16", "k3_bf16"), ("K3-elem", "k3_elem")):
        f = k3b[form]
        kernels.append({
            "name": f"egnn_stream {'elem_bf16' if f['elem'] else 'bf16'} ({form})",
            "route": "cuda",
            "reworked": "PR 8",
            "redesigned": "PR 18",
            "source": f"{PKG}/csrc/egnn_stream.cu",
            "replaces": f"{TPU_PKG}/ops/pallas/egnn_stream.py:192",
            "launches": bf16_counts[kernel],
            "max_abs_err": max(a for a, _ in f["err"].values()),
            "ms": f["ms"],
            "plain_ms": f["plain_ms"],
            "bound_ms": k3b_bound,
            "bound_by": k3b_by,
            "sfu_floor_ms": k3b_sfu,
            "sm_clock_mhz": sm_clock_mhz,
            "library_ms": None,
        })
    # each kernel's launches on the training paths: [train]'s training (its
    # first GT batch included), [train]'s evaluation, [train-n5], and
    # [train-ponita]'s, [train-segnn]'s, [train-painn]'s, [train-cgenn]'s and
    # [train-gmn]'s fresh training,
    # its evaluation and its resumed run, [train-eqv2]'s and [train-gt]'s
    # resumed training, its evaluation and its fresh run, and
    # [train-offline-*]'s training and resumed training
    counter_of = {"egnn_messages (K1)": "k1", "gravity (K2)": "k2",
                  "gravity leapfrog (K2-leapfrog)": "leapfrog", "egnn_stream (K3)": "k3",
                  "egnn_messages bf16 (K1-bf16)": "k1_bf16",
                  "egnn_stream bf16 (K3-bf16)": "k3_bf16",
                  "egnn_stream elem_bf16 (K3-elem)": "k3_elem"}
    for entry in kernels:
        entry["launches_train"] = {path: c[counter_of[entry["name"]]]
                                   for path, c in train_counts.items()}
        # ... and on the evaluation layer's paths, PONITA's ([ponita],
        # [ponita-rollout], [battery-ponita], [hpo-ponita]), SEGNN's ([segnn],
        # [segnn-rollout], [battery-segnn], [hpo-segnn]), EquiformerV2's
        # ([eqv2], [eqv2-rollout], [battery-eqv2], [hpo-equiformer_v2]),
        # GraphTransformer's ([gt], [gt-rollout], [battery-gt], [hpo-gt]),
        # PaiNN's ([painn], [painn-rollout], [hpo-painn]), CGENN's ([cgenn],
        # [cgenn-rollout], [hpo-cgenn]) and GMN's ([gmn], [gmn-rollout],
        # [hpo-gmn]), and [train-offline-*]'s validations (EGNN-MC's through
        # K1 on the cutoff-rate masks)
        entry["launches_eval"] = {path: c[counter_of[entry["name"]]]
                                  for path, c in eval_counts.items()}
        # ... and on the multi-GPU paths, per rank: [dp-train]'s (its training
        # GT and evaluation), [ring]'s rollout (plain PyTorch: none) and
        # [ring]'s training work (its GT batch: one K2-leapfrog)
        entry["launches_parallel"] = {path: c[counter_of[entry["name"]]]
                                      for path, c in parallel_counts.items()}
    print(f"total {time.perf_counter() - T_START:.2f} s on {card}", flush=True)
    print(json.dumps({"bign": rows}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
