#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port trains and serves its models on an NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--log-dir DIR]
    python3 chip_smoke.py --kernel-times ROOT   (alias: --cascade-times)
    python3 chip_smoke.py --edc-loss
    python3 chip_smoke.py --options
    python3 chip_smoke.py --parallel
    python3 chip_smoke.py --host-batches
    python3 chip_smoke.py --examples

Phases (any failure raises and exits non-zero, with no result line):

1. build the kernels of ``diffgfdn_torch/csrc`` (one ``nvcc`` per source)
   and hold ptxas's report of the directional shapes' kernels: no stack
   frame and no spill stores in B1 / B2 and B5 at N = 9 and in B6 at N = 9,
   12 and 27, no spill stores in B7 at N = 27 (B1 / B2 at N = 8, phase
   10's blocks, are printed);
2. serve both slice configurations at full width through the user entry
   point ``InferDiffGFDN.rirs_at``: a synthetic 3-room dataset at 32 kHz
   (96 receivers, 3 batches of 32, nfft 131072), seeded parameters written
   as a checkpoint and read back. Each kernel's launch count is set to 0
   just before a configuration is served and read just after; every kernel
   of the path must have launched. The RIRs must be finite, decay, and match
   the same path run with the kernels' plain versions on the card;
3. hold each kernel against its plain version on the card, at the inputs the
   served path gave it and at the other shapes the model family uses, and
   against a float64 numpy reference on a few systems; the inverse (B1) and
   the LU solve (B5: x, factors, pivots) must equal their plain versions bit
   for bit (path, and N = 12, 27 for B1, N = 27 for B5);
4. time each kernel, its plain version and the library call computing the
   same function (CUDA events around one wrapper call, L2 flushed before
   each: ``ms``), the kernel's own device time (CUDA events around the bare
   launches, the host's enqueueing hidden behind a sleep kernel:
   ``kernel_ms``), and the served RIRs per second of each configuration;
5. train both configurations at full width for 2 epochs through the user
   entry point ``run_training_var_receiver_pos`` (the same synthetic
   dataset, the preset's hold-out and split: 3 steps of 32 per epoch). Each
   kernel's launch count is set to 0 just before a configuration trains and
   read just after; every forward and backward kernel of its path must have
   launched. The losses must be finite and the last checkpoint must read
   back to the trained parameters. One step at the same parameters, batch
   and EDC mask then runs on the kernels and on the plain versions: the
   losses must agree to 1e-6 relative and every parameter gradient to 1e-3
   relative L2. The inputs each backward kernel got in that step are kept;
   each backward kernel is held against its plain version on them (1e-4;
   B2 bit for bit) and timed beside its bound, its plain version and the
   library call computing the same function. Per configuration the step
   then runs through its CUDA graph and eagerly (``graphed_vs_eager``, as in
   phases 7-10): the run must have replayed its captured step; the graphs
   are made anew (a warm-up step, the capture), three graphed and three
   eager steps from one restored state must agree (each loss 1e-6
   relative, the parameters after the last step 1e-5 and its gradients
   1e-3 relative L2), then five steps of each path are timed in turns
   (eager, graphed, graphed, eager), the graphed ones under
   ``torch.cuda.set_sync_debug_mode("error")``, with the same launches per
   step on both paths. One more graphed step runs under torch.profiler: it
   must replay its graph, and the launches the wrappers count for it (the
   counts seen at the capture, added again on each replay) must equal the
   hand-written kernels the card ran in it, kernel by kernel. The phase
   prints both medians, steps/s, the warm-up and capture times, each path's
   peak memory and the profiled step's idle share (with ``--log-dir``, beside
   an eager step's);
6. synthesize 96 RIRs per configuration in the time domain through the user
   entry point ``make_time_domain_synthesis_fn`` (the model as phase 2's
   ``InferDiffGFDN`` loaded it, num_samples = nfft, batches of 32). Each
   kernel's launch count is set to 0 just before the factory (the delay-line
   run) and read after the mix: three_room_example (scalar absorption) must
   have launched B7, fullband_grid_colorless (GEQ absorption, the exact
   filtered path in PyTorch) the SVF heads' B3 and no B7. The RIRs must be finite,
   decay, match the same path on the plain versions, and match the
   frequency path of the same model at the same receivers without the
   direct part (max |delta| <= 2e-3 peak, EDC within 0.01 dB over 0.5 s).
   B7 is then held against its plain version bit for bit at the path's
   delays (impulse and random input), at the delay spreads whose
   shared-memory ring fills the card's shared memory exactly and one slot
   past it (which takes the device-memory history), and at a spread of
   50000 samples, and against a float64 numpy recursion, and timed beside
   its bound and plain version;
7. train the eight octave bands of the subband presets at full width
   (``create_config``'s per-band MLPs: three architecture groups of 2, 4 and
   2 bands; N = 12, G = 3, nfft 131072, batch 32, fs 32 kHz, scalar heads,
   GEQ absorption, the colorless loss) for 2 epochs on phase 2's synthetic
   dataset through the user entry point ``training_band_parallel`` (the
   subband CLI's ``--band-parallel``). Each kernel's launch count is set to
   0 just before and read just after: B1, B3 and B5 must have launched once
   per optimizer step and validation batch of each group, B2 and B6 once
   per step, B4 (the absorption cascades take no gradient) and B7 never;
   the losses must be finite and each band's last checkpoint must load into
   its own model. Per group, one band-stacked step then runs on the kernels
   and on the plain versions (losses 1e-6 relative, every band's gradients
   1e-3 relative L2), its graphed and eager steps are held and timed as in
   phase 5, each of B1, B2, B3, B5, B6 launched exactly once a step. At the
   4-band group, B1-B6 are held against their plain versions at that
   step's band-stacked inputs (B1, B2, B5 bit for bit) and timed, and its
   last band's step against the sequential ``GFDNTrainer``'s (loss 1e-5,
   gradients 1e-3). One band-parallel step of every group and one
   sequential step of every band are timed in turns. Finally the trained
   bands are merged into 96 broadband RIRs through ``infer_all_octave_bands``
   (finite; kernels vs plain versions rel L2 1e-3, EDC 0.01 dB over 0.5 s)
   and ``broadband_edc_errors_device`` is held to the same errors computed
   on the host from those RIRs (within 0.01 dB: at nfft 131072 the circular
   band filtering on the card and the linear one on the host agree; a
   shrunken nfft, as in a CPU rehearsal, does not hold this limit);
8. train the directional preset ``directional_1000Hz_res0.6m`` at full
   width (ambi order 2: N = 27 lines in 3 groups of 9, zero coupling,
   scalar absorption; a 10 x 128 skip-connection MLP with 20 Fourier
   features and the max-directivity beamformer; nfft 131072, batch 32; the
   directional EDC loss with its mask, the colorless losses, the 1 kHz
   band's response in the loss) for 2 epochs through the user entry point
   ``run_training_anisotropic_decay_var_receiver_pos`` on the synthetic
   spatial dataset at 32 kHz (a 0.3 m grid: 847 receivers, 12 directions,
   9 SH channels, 0.5 s SRIRs, decay times 1.2 / 2.2 / 1.6 s, so nfft
   131072) with the preset's 0.6 m split (232 train, 615 valid). Each
   kernel's launch count is set to 0 just before and read just after: B1
   and B5 once per step and validation batch, B2 and B6 once per step, B3,
   B4, B7 never; the losses must be finite and the last checkpoint must
   read back. One step then runs on the kernels and on the plain versions
   (loss 1e-6 relative, gradients 1e-3 relative L2); B1, B2, B5 and B6 are
   held bit for bit to their plain versions at that step's 9 x 9 inputs
   (B6: the transposed solve's N > 8 kernel, its factors fetched ahead
   through a ring of asynchronous copies, w in registers) and timed; its
   graphed and eager steps are held and timed as in phase 5, each kernel
   launched exactly once a step. ``InferDiffGFDN``
   with ``variant="directional"`` then serves 96 receivers' SH-domain RIRs
   (96, 9, 131072) from the trained checkpoint (vs plain rel L2 1e-3, EDC
   0.01 dB over 0.5 s), and ``make_time_domain_synthesis_fn`` synthesizes
   them with one launch of B7 at N = 27 on the transposed feedback matrix
   (vs plain, and vs the frequency path within 2e-3 of the peak and 0.01 dB
   of EDC); B7 there is held bit for bit to its plain version and to
   float64 numpy;
9. train the common-slopes spatial-sampling presets through the user entry
   point ``run_training_spatial_sampling`` on phase 8's grid:
   ``spatial_directional_1000Hz`` (a 12 x 128 MLP, batch 50) at its grid
   resolutions 0.9, 0.6 and 0.3 m, then ``spatial_omni_1000Hz`` (5 x 16) at
   its ten (3.0 .. 0.3 m) on the grid's omni collapse, 4 epochs each; serve
   all 847 receivers from the 0.3 m checkpoints through
   ``get_ambisonic_rirs(use_trained_model=True)`` ((847, 9, 16000) SRIRs,
   (847, 16000) omni RIRs). No hand-written kernel lies on this path: every
   launch count must stay 0. The losses must be finite and fall, the served
   RIRs finite and decaying; a directional step on the card must match the
   same step on the CPU (loss 1e-5 relative, gradients 1e-3 relative L2),
   the served amplitudes the CPU's (1e-5) and the synthesis the CPU's on one
   noise tensor (1e-4 relative L2). Per preset and resolution the step's
   graphed and eager paths are held and timed as in phase 5; the phase
   prints them, the epoch time, the first and last losses, and the served
   RIRs per second.

10. fit the single-RIR presets through the user entry point, the CLI
   ``python -m diffgfdn_torch.cli.run_model -c <preset>`` (each run from a
   working directory that holds the preset's ``ir_path``): the synthetic RIR
   is one receiver of phase 2's dataset at 32 kHz for ``single_rir_example``
   (N = 12 in 3 groups, nfft 131072, SVF output heads) and a two-slope
   synthetic RIR at 48 kHz for ``single_rir_two_stage_colorless_proto`` (N =
   8 in 2 groups) and ``single_rir_single_room_colorless_proto`` (N = 8 in
   one group), both with SVF input heads, nfft 32768 from the data, and
   their colorless prototypes first (one per group on 2048 bins: 1638 in one
   step, 410 in one validation batch an epoch, 5 or 15 epochs). The full
   preset: 50 epochs of one full-spectrum step, or as early stopping ends
   them. Each kernel's launch count is set to 0 just before a preset and
   read just after: B1, B2, B3 and B4 exactly as often as the path runs
   them, B5, B6 and B7 never. The losses must be finite, the last checkpoint
   and the prototype pickles must read back, the warm-started feedback
   blocks must equal the prototypes' matrices within 1e-4 and the io gains
   theirs. One step and one prototype step then run on the kernels and on
   the plain versions (loss 1e-6 relative, gradients 1e-3 relative L2); B1
   and B2 are held bit for bit at those steps' 4 x 4 and 8 x 8 inputs, B3
   and B4 within 1e-4, and timed. Per preset the step's (and a prototype
   step's) graphed and eager paths are held and timed as in phase 5; the
   phase prints them and one prototype epoch's time.
11. train the floor-plan CNN preset through the spatial CLI at 0.9, 0.6 and
   0.3 m and serve every receiver from it (no hand-written kernel), and
   merge the eight directional band presets (one epoch each) into broadband
   SRIRs (B5 exactly 24 times, against the plain versions);
12. (a) build each of the nine synth presets by name and run it forward
   once at its bins on a synthetic stand-in grid at 48 kHz (96 receivers,
   2 s RIRs, decay times of 0.7 / 1.1 / 0.9 s for the preset's groups, per
   octave band for GEQ absorption); (b) serve ``synth_subband_single_room``
   at full width (8 lines in one group coupled by one dense RANDOM matrix,
   nfft 96000, batch 10, SVF heads of 3 x 32, GEQ absorption) through
   ``InferDiffGFDN.rirs_at``: B1 on (48001, 8, 8) and B3 exactly once and
   twice a batch, the RIRs within 1e-3 rel L2 and 0.01 dB of the plain
   path; one gradient of the trainer's EDC and EDR loss on a gathered
   batch (B2 on (48001, 8, 8) and B4 once; kernels vs plain: loss 1e-6,
   gradients 1e-3; B1 / B2 bit for bit, B3 / B4 1e-4, timed); the
   time-domain factory timed; ``fit_indexed`` must raise ROADMAP C16
   before any step; (c) run ``synth_subband_hyp_tuning`` through the CLI,
   its search cut to 2 trials of 1 epoch and the winner to 2 epochs: each
   trial's architecture, objective and reserved memory are printed, and the
   reserved memory may not grow from trial to trial by a tenth of what the
   first trial reserved; then train
   ``DiffGFDNVarSourceReceiverPos`` at the widths of
   ``fullband_grid_colorless`` (input heads like the output heads, a seeded
   source position per receiver of phase 2's grid) with scalar heads and
   with SVF heads on both sides, 2 epochs of ``fit_indexed`` each: one step
   on the kernels against the plain versions, the step graphed and eagerly
   as in phase 5 with its launches per step as the model's structure
   says, and 96 receivers served through
   ``InferDiffGFDN(variant="var_source_receiver")`` (launches per batch as
   the structure says, against the plain path; RIRs per second).
13. render BASELINE's fifth configuration, a 6DoF moving-listener binaural
   render, through the user entry points of ``inference/rendering.py`` and
   ``inference/sofa.py``, with a seeded order-2 HRIR set of 256 taps on the
   icosahedron (its SH representation through ``HRIRSOFAReader``): (a) the
   common-slopes chain: phase 9's 0.3 m checkpoint of
   ``spatial_directional_1000Hz`` serves all 847 receivers ((847, 9, 16000)
   SRIRs at 32 kHz), ``convert_srir_to_brir`` makes BRIRs at 1 and at 12
   head orientations, and a 30-hop walk (100 ms hops over 30 receivers, yaw
   0 to 2 pi, pitch within +-0.3 rad, a 1 s seeded stimulus) is rendered
   four ways: the host loop, ``backend="device"`` through the einsum
   program and through the dictionary program (both forced), and the multi
   render of 8 walks; (b) the same four ways at tools/binaural_bench.py's
   sizes (a 1.2 m grid, 1 s SRIRs, decays 0.4 / 0.8 / 0.6 s, 30 hops over 4
   receivers, 8 walks); (c) phase 8's 96 served SRIRs (96, 9, 131072)
   through the conversion at one orientation; every launch count must stay
   0 across (a)-(c). Each batched render must be finite and within 1e-4 of
   the peak of the host loop, the dictionary program within 2e-5 of the
   einsum program, walk 0 of the multi render within 1e-5 of the single
   render, each program within 1e-5 of the same render on the CPU and the
   BRIRs within 1e-5 relative L2 of the CPU's. The phase prints the
   x-real-time of each way and size, the host's rotation time apart from
   the device program, BRIRs per second, peak memory and (with
   ``--log-dir``) the card's idle share of one device render. (d) The native
   streaming renderer (``diffgfdn_torch/native``, g++) must give B7's
   impulse response of phase 6's three-room model at receiver 0 (131072
   samples) within 1e-4 of the peak; its x-real-time is printed. (e) With
   h5py, a synthetic HRIR SOFA file is written and the spatial CLI's
   ``--infer-dataset`` and ``--return-brirs --hrtf`` run on phase 9's
   checkpoint; both files are read back and held to (a)'s SRIRs and BRIRs
   (1e-6 relative L2). Without h5py the phase prints ``h5py: absent``.
14. run every coupling, absorption, encoding and loss option of the config
   at full width (``options``): (a) ``fullband_grid_colorless`` with FILTER
   coupling (order 32) and SVF heads, (b) the same with scalar heads, (c)
   ``directional_1000Hz_res0.9m`` with ``use_zero_coupling: false`` (27
   lines in one dense loop) on phase 8's grid, (d) ``fullband_grid_colorless``
   with learnable common decay times, meshgrid encoding and the aliasing
   regularizer, the ERB-grouped and the frequency-weighted EDR losses, each
   trained for 2 epochs of ``fit_indexed`` (the directional solver for (c))
   with its launches counted, one step on the kernels against the plain
   versions, the step graphed and eagerly as in phase 5 with its launches
   per step exactly as OPTIONS_STEP says, 96 receivers served through
   ``InferDiffGFDN`` (launches per batch as OPTIONS_SERVE says, against the
   plain path) and synthesized in the time domain (against the plain path
   and the frequency path: 2e-3 of the peak, 0.01 dB of EDC over 0.5 s);
   B1 / B2 at (65537, 12, 12) in (a), B5 / B6 at (65537, 12) in (b) and at
   (65537, 27) in (c) bit for bit, B3 / B4 at the regularizer's 96 x 8001
   in (d) within 1e-4, each at the inputs of that step, timed beside its
   bound, plain version and library call; one band-parallel step of the
   first 2-band subband group with SVF heads and the three loss options,
   kernels against plain; (e) a model with the warped-Prony IIR absorption
   of ``absorption_arrays(use_prony=True)``: 96 receivers served and
   synthesized in the time domain (the time domain against the frequency
   path with the IIR responses in float64; the served complex64 path's own
   error beside it, ROADMAP C19).
15. run the tools (``tools``): (a) ``cli/inspect_checkpoint.py``'s metrics
   step on phase 2's checkpoints of both configurations (96 receivers, the
   EDR's STFT on the card, the common-slopes baseline for the three-room
   model, whose decay times are broadband), its launches equal to phase 2's
   for the same batches, its metrics within 0.01 dB of the same call on the
   plain versions and the diagonal measure equal; the call's wall time,
   serving share and RIRs/s; with matplotlib, the whole CLI through
   ``main`` from a working directory holding the dataset and checkpoint at
   the preset's paths, its figures checked (without, ``matplotlib:
   absent``); (b) ``csolve`` at (3 x 65537, 4, 4) and (65537, 12, 12) with 3
   right-hand sides: B1 forward and B2 backward once each, the solution bit
   for bit with the plain versions' and within 1e-4 of
   ``torch.linalg.solve``, both timed; (c) the int8 target codec on a
   288-receiver grid of 2 s at 32 kHz (73.7 MB of float32 targets): the
   uploaded targets bit for bit with the host's dequantization, the upload's
   time and bytes, and one graphed ``fullband_grid_colorless`` step on them;
   (d) ``cli/compare_baselines.py`` on phase 9's grid at 0.9 m (2 epochs):
   a finite summary, the barycentric maps equal to a CPU run of the same
   call (serving the card's checkpoint), the NAF exports read back, no
   kernel launched; (e) ``utils/profiling.trace`` around one served batch
   writes a Chrome trace that holds B5;
16. run the sharded paths over ``torch.distributed`` process groups
   (``parallel``), the topology printed first: with two or more cards one
   NCCL group over all of them, its steps graphed; with one card NCCL at
   world 1 in this process, graphed (the collectives captured in the step
   graphs), then gloo at world 2 with both ranks on ``cuda:0``, eager
   (gloo's collectives cannot be captured), so that bins, bands and
   receivers really split and gather. On each rank: (a) ``single_rir_example``
   fit for 3 epochs through ``run_training_single_pos`` with its 65537 bins
   sharded (B1 / B2 / B3 x 2 / B4 x 2 a step at the shard shape, launches
   checked exactly), then one step against an unsharded trainer from the
   same parameters (loss 1e-6 relative, gradients 1e-3, one Adam step
   1e-5), the parameters bit for bit the same on every rank, and both
   paths' step times; (b) the eight ``subband_*Hz`` presets' groups (2, 4,
   2 bands) each on ``make_mesh(len(group))`` at full width (phase 7's grid):
   a step's per-band losses and gradients against the one-rank trainer,
   one launch of B1, B2, B3, B5, B6 a step, group and one-rank step times,
   each band's checkpoint written by its owner, read back and continued;
   (c) ``spatial_directional_1000Hz`` at 0.9 m, two epochs batch-sharded
   against the unsharded ones (losses 1e-6, parameters 1e-5). The kernels
   at the gloo (or multi-card) run's shard shapes join the kernel line.
   Then, in this process, (d) ``ops/mxu_fft.irfft_matmul`` against
   ``torch.fft.irfft`` on a directional batch's (32, 9, 65537) SH spectra
   over the loss window (1e-5 of the peak; both times), and phase 8's step,
   graphed, with ``use_mxu_fft`` off and on (both step times; the losses
   within 1e-5). ``--parallel`` runs phase 16 alone.
17. train on batches made on the host (``data/batching.iterate_batches``)
   through the user entry points ``GFDNTrainer.fit`` and
   ``BandParallelTrainer.init`` / ``fit``: (a) ``fullband_grid_colorless``
   and (b) ``three_room_example`` at full width on a 321-receiver synthetic
   grid (2 s RIRs at 32 kHz; a seeded split of 256 train receivers, 8
   batches of 32, and 64 valid, 2 batches), one epoch; (c) the 4-band group
   of phase 7 (one ``init`` from the bands' config seeds, which must give
   the built models' parameters) on phase 7's 96 receivers, 2 epochs of 3
   batches. Each kernel's launch count is set to 0 just before the fit and
   read just after: every kernel of the path must have launched ((c):
   exactly once a step each of B1, B2, B3, B5, B6), no other. Each part
   checks: the same fit run eagerly (losses within 1e-6); one host batch on
   the kernels and on the plain versions (loss 1e-6, gradients 1e-3); the
   host step graphed and eagerly as in phase 5, with the launches per step
   (and of the profiled graphed step) exactly ``HOST_STEP`` /
   ``BAND_STEP_KERNELS``; ``fit`` against ``fit_indexed`` on the same
   batches, (a) / (b) with precomputed target features, the EDC mask off
   and the host's early spectra in both (per-epoch losses within 1e-5), (c)
   across the loss branches (1e-3); one step's EDC and EDR terms on the raw
   spectra against the features (1e-3). It prints the host-batch step (gather, copy,
   replay) beside the ``fit_indexed`` step (median of 3 after 2 untimed),
   the bytes copied a batch with the gather and copy times, and the card's
   idle share in a profiled host-batch step. ``--host-batches`` runs phase
   17 alone.
18. run the README's walkthrough and the notebook studies through the port's
   ``diffgfdn_torch/examples/``: (a) the walkthrough's steps 1-5 at its own
   sizes (dataset, colorless warm start and scalar-head grid training,
   checkpoint inference, the two-band subband CLI, the binaural render; the
   animation needs matplotlib and is left out), every artifact written and
   the RIRs finite; (b) each study's compute function at its ``main``
   defaults and the conclusion ``tests/test_examples.py`` asserts (the
   colorless study from the JAX package's own draw, its seed-0 torch draw
   printed; the amplitude study's GMM by the EM fallback where sklearn is
   absent, held to the EM's result, ROADMAP C25); (c) every launch count
   set to 0 before each part and read after it: each kernel of
   ``EXAMPLE_KERNELS`` must have launched, no other; (d) each kernel against
   its plain version at every input shape a part gave it (B1, B2, B5, B6,
   B7 bit for bit; B7's plan printed), and the new shapes timed beside
   their bound, plain version and library call; (e) each part's wall time.
   ``--examples`` runs phase 18 alone.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. ``--kernel-times ROOT``
(or its older name ``--cascade-times``) instead only times the seven kernels
of the port's checkout under ROOT at the paths' shapes (so that two trees
can be compared in turns in one call) and prints no result line.
``--log-dir`` receives the compiler's resource report and a torch.profiler
table of one served batch and of one training step per configuration (and
of one band-parallel step per group, of one directional step, of one
step of each spatial-sampling preset and of each single-RIR preset); their
wall time, the card's busy time within them and its idle share join the
phase-2, phase-5, phase-7, phase-8, phase-9 and phase-10 lines.
"""

import argparse
import contextlib
import copy
import dataclasses
import json
import re
from pathlib import Path
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores, H100 SXM data sheet
NUM_RECEIVERS = 96
BATCH = 32
SEED = 2024
# the two configurations and the kernels each one's serving path launches
CONFIGS = {
    "fullband_grid_colorless": ("cinv", "sos"),
    "three_room_example": ("lu",),
}
# ... and each one's training path, forward and backward
TRAIN_KERNELS = {
    "fullband_grid_colorless": ("cinv", "neg_ptgpt", "sos", "sos_backward"),
    "three_room_example": ("lu", "lut_apply", "cinv"),
}
TRAIN_EPOCHS = 2
TIMED_STEPS = 5
DEVICE = "cuda"
LOSS_TOL = 1e-6   # step loss, kernels vs plain versions, relative
GRAD_TOL = 1e-3   # each parameter gradient, kernels vs plain versions, relative L2
RIR_TOL = 1e-3   # relative L2 error of the RIRs, kernel path vs plain path
EDC_TOL_DB = 0.01  # Schroeder EDC difference over the first 0.5 s
KERNEL_TOL = 1e-4  # max abs error / max |plain|
TD_FREQ_TOL = 2e-3  # time-domain vs frequency-path RIRs: max abs error / peak
# the configurations whose time-domain synthesis launches B7 (scalar
# absorption); the GEQ-absorbed one runs the filtered path and B3 in its heads
TD_KERNELS = {
    "fullband_grid_colorless": ("sos",),
    "three_room_example": ("tdgfdn",),
}
# the float64 check of the cascade: a low-cutoff section evaluated in float32
# near DC cancels about four digits (a0 + a1 + a2 ~ 4 f^2), in every version
SOS_F64_TOL = 1e-2


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them; raises if unreadable."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip()
    require(bool(out), "nvidia-smi printed no name and power limit")
    return out.splitlines()[0]


def device_busy_us(events, window) -> float:
    """Time within ``window`` during which the card ran a kernel or a copy:
    the union of the profiled device events' intervals, clipped to the window.
    A ``record_function`` span also appears on the device timeline, as a user
    annotation from its first device op to its last; it is not device work."""
    from torch.autograd import DeviceType

    spans = sorted(
        (max(e.time_range.start, window.start), min(e.time_range.end, window.end))
        for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    )
    busy, reach = 0.0, window.start
    for start, end in spans:
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


# device symbols of the hand-written kernels (csrc/*.cu)
KERNEL_SYMBOLS = ("cinv_kernel", "neg_ptgpt_kernel", "sos_cascade_kernel", "sos_bwd_",
                  "lu_solve_kernel", "lut_apply_kernel", "tdgfdn_")
# the device symbol of the kernel that each counted wrapper launches once a call
WRAPPER_SYMBOLS = {"cinv": "cinv_kernel", "neg_ptgpt": "neg_ptgpt_kernel",
                   "sos": "sos_cascade_kernel", "sos_backward": "sos_bwd_partial_kernel",
                   "lu": "lu_solve_kernel", "lut_apply": "lut_apply_kernel",
                   "tdgfdn": "tdgfdn_"}


def profile_window(events, label: str):
    """The host-side span of the ``record_function`` named ``label``,
    widened to the label's device annotation, which spans its first to last
    device op (either event may come first in the list). The device times
    are converted to the host's clock, and the first kernels of a step
    launched as soon as the span opens have been placed before its start:
    the annotation keeps them in the window."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Interval

    host = next(e.time_range for e in events
                if e.name == label and e.device_type == DeviceType.CPU)
    device = [e.time_range for e in events
              if e.name == label and e.device_type == DeviceType.CUDA]
    return Interval(min([host.start] + [d.start for d in device]),
                    max([host.end] + [d.end for d in device]))


def profile_events(fn, label: str):
    """Run ``fn`` once under torch.profiler, within a ``record_function``
    named ``label``: (the profiler, its events, the label's window). The
    card is idle when the profiler starts and ``fn``'s work has finished
    when it stops, so every device event of the profile is ``fn``'s."""
    import torch
    from torch.profiler import profile as tprofile, ProfilerActivity, record_function

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    return prof, events, profile_window(events, label)


def device_kernels(events, window=None) -> list:
    """The kernels the card ran (no copies, no annotations): all of them, or
    those that started within ``window``."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation and not e.name.startswith(("Memcpy", "Memset"))
            and (window is None or window.start <= e.time_range.start < window.end)]


def wrapper_launches(kernels) -> dict:
    """{counted wrapper name: how many of ``kernels`` (device events) are the
    kernel it launches}, wrappers that launched none left out."""
    out = {}
    for name, symbol in WRAPPER_SYMBOLS.items():
        n = sum(1 for e in kernels if symbol in e.name)
        if n:
            out[name] = n
    return out


def profile_numbers(prof, events, window, label: str, table_path=None):
    """(wall ms of the window, device busy ms in it, device ms of the
    hand-written kernels in it, the number of kernels the card ran in it);
    with ``table_path``, the profile's tables (by device time, then by host
    time) are written there."""
    if table_path is not None:
        averages = prof.key_averages()
        table_path.write_text(averages.table(sort_by="cuda_time_total", row_limit=60) + "\n"
                              + averages.table(sort_by="self_cpu_time_total", row_limit=40))
    busy = device_busy_us(events, window)
    require(busy > 0.0, f"{label}: the profiled window shows no device work")
    ours = [e for e in events if any(k in e.name for k in KERNEL_SYMBOLS)]
    return (window.elapsed_us() / 1e3, busy / 1e3, device_busy_us(ours, window) / 1e3,
            len(device_kernels(events, window)))


def profile_once(fn, label: str, table_path: Path):
    """Run ``fn`` once under torch.profiler and write its tables to
    ``table_path``: :func:`profile_numbers` of it."""
    return profile_numbers(*profile_events(fn, label), label, table_path)


def edc_db(x: np.ndarray) -> np.ndarray:
    e = np.cumsum((x.astype(np.float64) ** 2)[..., ::-1], axis=-1)[..., ::-1]
    return 10.0 * np.log10(e + 1e-300)


def make_room(tmp: Path, name: str, fs: float, nfft: int, receivers: int = NUM_RECEIVERS,
              folder: str = None):
    """Synthetic 3-room dataset of ``receivers`` 2 s RIRs under
    ``tmp / (folder or name)``; per-band decay times for the GEQ configs."""
    from diffgfdn_torch.data import ThreeRoomDataset, generate_three_room_pickle

    rng = np.random.RandomState(SEED)
    base = rng.uniform(0.6, 1.5, 3)
    path = generate_three_room_pickle(
        tmp / (folder or name) / "srirs.pkl", fs=fs, num_rec_per_room=receivers // 3,
        rir_len_s=2.0, decay_times=tuple(base), seed=SEED,
    )
    room = ThreeRoomDataset(path, nfft=nfft)
    if name != "three_room_example":
        room.common_decay_times = base[None, :] * np.linspace(1.2, 0.8, 8)[:, None]
        room.band_centre_hz = [63.0, 125.0, 250.0, 500.0, 1000.0, 2000.0, 4000.0, 8000.0]
    return room


def launch_counts():
    from diffgfdn_torch.kernels import counted_wrappers

    return {name: fn.launches for name, fn in counted_wrappers().items()}


def reset_counts() -> None:
    from diffgfdn_torch.kernels import counted_wrappers

    for fn in counted_wrappers().values():
        fn.launches = 0


def serve(name: str, tmp: Path, log_dir):
    """Phase 2 for one configuration: returns (infer, per-kernel launches, result)."""
    import torch

    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.inference import InferDiffGFDN
    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.training import build_gfdn_model, save_checkpoint
    from diffgfdn_torch.utils.params import jax_params_from_torch

    cfg = preset_config(name)
    cfg.trainer_config.train_dir = str(tmp / name / "train")
    nfft = cfg.trainer_config.num_freq_bins
    room = make_room(tmp, name, cfg.sample_rate, nfft)
    seeded = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz, device="cuda")
    save_checkpoint(cfg.trainer_config.train_dir, -1, jax_params_from_torch(seeded))
    infer = InferDiffGFDN(cfg, room, device="cuda")
    idx = np.arange(NUM_RECEIVERS)
    infer.rirs_at(idx[:BATCH], BATCH)  # warm-up: host spectra, kernel loads
    torch.cuda.synchronize()

    reset_counts()
    rirs = infer.rirs_at(idx, BATCH)
    launches = launch_counts()
    for kernel in CONFIGS[name]:
        require(launches[kernel] > 0, f"{name}: kernel {kernel} never launched")

    require(rirs.shape == (NUM_RECEIVERS, nfft), f"{name}: RIR shape {rirs.shape}")
    require(bool(np.isfinite(rirs).all()), f"{name}: non-finite RIRs")
    fs = cfg.sample_rate
    edc = edc_db(rirs)
    drop = edc[:, int(0.05 * fs)] - edc[:, int(1.0 * fs)]
    require(bool((drop > 10.0).all()), f"{name}: RIRs do not decay (min drop {drop.min()} dB)")

    with plain_versions():
        plain = infer.rirs_at(idx, BATCH)
    mix = int(0.02 * fs)
    rel = float(np.linalg.norm(rirs - plain) / np.linalg.norm(plain))
    rel_late = float(np.linalg.norm(rirs[:, mix:] - plain[:, mix:])
                     / np.linalg.norm(plain[:, mix:]))
    edc_err = float(np.abs(edc - edc_db(plain))[:, : int(0.5 * fs)].max())
    require(rel <= RIR_TOL and rel_late <= RIR_TOL,
            f"{name}: RIRs vs plain path rel L2 {rel}, late {rel_late}")
    require(edc_err <= EDC_TOL_DB, f"{name}: EDC vs plain path {edc_err} dB")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        infer.rirs_at(idx, BATCH)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    with plain_versions():
        t0 = time.perf_counter()
        infer.rirs_at(idx, BATCH)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    profiled = {}
    if log_dir is not None:
        wall, busy, ours, _ = profile_once(lambda: infer.rirs_at(idx[:BATCH], BATCH),
                                        "served_batch", Path(log_dir) / f"profile_{name}.txt")
        profiled = {
            "profiled_batch_ms": wall,
            "profiled_device_busy_ms": busy,
            "profiled_kernels_ms": ours,
            "profiled_idle_share": 1.0 - busy / wall,
        }
    result = {
        "config": name,
        "receivers": NUM_RECEIVERS,
        "nfft": nfft,
        "rirs_per_s": NUM_RECEIVERS / float(np.median(times)),
        "serve_s": [round(t, 6) for t in times],
        "plain_serve_s": plain_s,
        "rel_l2_vs_plain": rel,
        "rel_l2_late_vs_plain": rel_late,
        "edc_max_abs_db_vs_plain": edc_err,
        "launches": {k: launches[k] for k in CONFIGS[name]},
        **profiled,
    }
    return infer, launches, result


def path_inputs(infer_fb, infer_tr):
    """The kernels' inputs at the served path's shapes, taken from the models."""
    import torch

    from diffgfdn_torch.models.gain_heads import svf_params_to_response

    dev = infer_fb.device
    z = torch.from_numpy(infer_fb.arrays.z_values).to(dev)
    idx = np.arange(BATCH)
    with torch.no_grad():
        fl = infer_fb.model.feedback_loop
        m_cinv = fl.loop_matrix_blocks(z).reshape(-1, 4, 4).contiguous()
        head = infer_fb.model.output_filters
        pos = torch.from_numpy(infer_fb.arrays.listener_position[idx]).to(dev)
        _, num, den = svf_params_to_response(head.mlp(head.position.encoding(pos)),
                                             head.cutoffs, z)
        fl_tr = infer_tr.model.feedback_loop
        z_tr = torch.from_numpy(infer_tr.arrays.z_values).to(dev)
        m_lu = fl_tr.loop_matrix_blocks(z_tr)
        g, f, nper = m_lu.shape[0], m_lu.shape[1], m_lu.shape[2]
        b_lu = infer_tr.model.input_gains[:, 0].to(torch.complex64).reshape(g, 1, nper)
        b_lu = b_lu.expand(g, f, nper).reshape(-1, nper).contiguous()
    return {
        "cinv": (m_cinv,),
        "sos96": (num.reshape(-1, num.shape[-2], 3).contiguous(),
                  den.reshape(-1, den.shape[-2], 3).contiguous(), z),
        "sos12": (fl.sos_coeffs[..., 0].contiguous(), fl.sos_coeffs[..., 1].contiguous(), z),
        "lu": (m_lu.reshape(-1, nper, nper).contiguous(), b_lu),
    }


def random_systems(k: int, n: int, gen):
    import torch

    m = 0.4 * torch.randn((k, n, n), dtype=torch.complex64, device="cuda", generator=gen)
    m = m + 2.0 * torch.eye(n, device="cuda")
    m[: k // 3, 0, 0] = 0.0  # zero leading pivots: elimination must pivot
    b = torch.randn((k, n), dtype=torch.complex64, device="cuda", generator=gen)
    return m, b


def rel_err(a, b) -> float:
    import torch

    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def check_kernels(inputs) -> dict:
    """Phase 3: each kernel against its plain version (and numpy) on the card."""
    import torch

    from diffgfdn_torch.kernels import sos as sos_mod
    from diffgfdn_torch.kernels.cinv import cinv
    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.kernels.lu import lu_solve
    from diffgfdn_torch.kernels.sos import sos_cascade_response

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errors = {}

    def both(fn, *args):
        out = fn(*args)
        with plain_versions():
            ref = fn(*args)
        torch.cuda.synchronize()
        return out, ref

    # B1: the served path's blocks, then the coupled (12) and directional (27) sizes
    cases = [("path", inputs["cinv"][0])] + [
        (f"N={n}", random_systems(65537, n, gen)[0]) for n in (12, 27)
    ]
    for label, m in cases:
        out, ref = both(cinv, m)
        differ = int((out != ref).sum())
        require(differ == 0, f"cinv {label}: {differ} elements differ from the plain version")
        m64 = m[:256].cpu().numpy().astype(np.complex128)
        inv64 = np.linalg.inv(m64)
        err64 = float(np.abs(out[:256].cpu().numpy() - inv64).max() / np.abs(inv64).max())
        require(err64 <= KERNEL_TOL, f"cinv {label}: vs float64 numpy {err64}")
        if label == "path":
            errors["cinv"] = float(torch.max(torch.abs(out - ref)))
        print(f"cinv {label} {tuple(m.shape)}: elements differing from plain {differ}, "
              f"vs numpy {err64:.3e}")

    # B3: the SVF heads (R = B*G = 96) and the absorption cascades (R = N = 12)
    for label in ("sos96", "sos12"):
        num, den, z = inputs[label]
        out, ref = both(sos_cascade_response, num, den, z)
        err = rel_err(out, ref)
        require(err <= KERNEL_TOL, f"sos {label}: rel err {err}")
        w = 1.0 / z[:4096].cpu().numpy().astype(np.complex128)
        wp = np.stack([np.ones_like(w), w, w * w])
        n64 = num[:4].cpu().numpy().astype(np.float64)
        d64 = den[:4].cpu().numpy().astype(np.float64)
        h64 = np.prod((n64 @ wp) / (d64 @ wp), axis=1)
        err64 = float(np.abs(out[:4, :4096].cpu().numpy() - h64).max() / np.abs(h64).max())
        require(err64 <= SOS_F64_TOL, f"sos {label}: vs float64 numpy {err64}")
        if label == "sos96":
            errors["sos"] = float(torch.max(torch.abs(out - ref)))
        print(f"sos {label} {tuple(num.shape)} x F={z.shape[0]}: rel err vs plain {err:.3e}, "
              f"vs numpy {err64:.3e}")

    # B5: the served path's blocks, then the directional size (27)
    cases = [("path",) + inputs["lu"], ("N=27",) + random_systems(65537, 27, gen)]
    for label, m, b in cases:
        (x, lu, piv), (x_p, lu_p, piv_p) = both(lu_solve, m, b)
        err_x, err_lu = rel_err(x, x_p), rel_err(lu, lu_p)
        differ = [int((o != r).sum()) for o, r in ((x, x_p), (lu, lu_p), (piv, piv_p))]
        require(differ == [0, 0, 0], f"lu {label}: elements of x, factors and pivots differing "
                f"from the plain version {differ}")
        m64, b64 = m[:256].cpu().numpy().astype(np.complex128), b[:256].cpu().numpy()
        x64 = np.linalg.solve(m64, b64[..., None])[..., 0]
        err64 = float(np.abs(x[:256].cpu().numpy() - x64).max() / np.abs(x64).max())
        require(err64 <= KERNEL_TOL, f"lu {label}: vs float64 numpy {err64}")
        if label == "path":
            errors["lu"] = float(torch.max(torch.abs(x - x_p)))
        print(f"lu {label} {tuple(m.shape)}: elements differing from plain (x, factors, "
              f"pivots) {differ}, rel err x {err_x:.3e}, factors {err_lu:.3e}, vs numpy "
              f"{err64:.3e}")
    return errors


def device_ms(fn, reps: int = 20) -> float:
    """Median device time of one call (CUDA events), L2 flushed before each."""
    import torch

    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# a sleep kernel of this many clock cycles (some 2 ms on an H100) outlasts
# the host's enqueueing of one kernel call
SLEEP_CYCLES = 4_000_000


def kernel_ms(fn, reps: int = 20) -> float:
    """The kernel's own device time: median over ``reps`` calls of CUDA
    events around one call of ``fn``, which launches the kernel on prepared
    inputs and nothing else, L2 flushed before each. A sleep kernel ahead of
    the start event keeps the stream busy while the host enqueues the call,
    so the window holds the launches back to back and not the host's time
    (which :func:`device_ms`, around a whole wrapper call on an idle stream,
    includes). CUDA events only: the profiler's device records are not
    complete on every run."""
    import torch

    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bare_cascade(sos_module, num, den, z):
    """A call of the forward cascade kernel alone (``sos_cascade`` of the
    given module), on the inputs ``sos_cascade_response`` would prepare from
    (..., K, 3) coefficients and z."""
    import torch

    k = num.shape[-2]
    num32 = num.reshape(-1, k, 3).to(torch.float32).contiguous()
    den32 = den.reshape(-1, k, 3).to(torch.float32).contiguous()
    w = (1.0 / z).to(torch.complex64)
    return lambda: sos_module.sos_cascade(num32, den32, w)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cinv_cost(k: int, n: int):
    """Bytes moved and fp32 operations of the Gauss-Jordan inverse."""
    flops = 0
    for s in range(n):
        w = 2 * n - s  # active columns of the augmented system
        flops += 3 * (n - s) + 4 + 6 * w + 8 * (n - 1) * w
    return 2 * k * n * n * 8, k * flops


def lu_cost(k: int, n: int):
    """Bytes moved and fp32 operations of the LU solve (x, factors, pivots out)."""
    flops = 0
    for s in range(n):
        a = n - s - 1  # rows (and columns) below / right of the pivot
        flops += 3 * (n - s) + (4 + a * (6 + 8 * a + 8) if a else 0)
        flops += 8 * a + 8  # back substitution of row s
    nbytes = k * (n * n * 8 + n * 8) + k * (n * 8 + n * n * 8 + n * 4)
    return nbytes, k * flops


def sos_cost(r: int, k: int, f: int):
    """Bytes moved and fp32 operations of the cascade response."""
    return r * f * 8 + f * 8 + 2 * r * k * 3 * 4, r * f * (32 * k + 3)


def time_kernels(inputs, errors, launches) -> list:
    """Phase 4: kernel, plain version and library call at the path shapes."""
    import torch

    from diffgfdn_torch.kernels import sos as sos_mod
    from diffgfdn_torch.kernels.cinv import cinv
    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.kernels.lu import lu_solve
    from diffgfdn_torch.kernels.sos import sos_cascade_response

    def plain(fn, *args):
        with plain_versions():
            return fn(*args)

    rows = []
    (m,) = inputs["cinv"]
    k, n = m.shape[0], m.shape[1]
    b_ms, b_by = bound(*cinv_cost(k, n))
    rows.append({
        "name": "cinv", "route": "cuda", "source": "diffgfdn_torch/csrc/cinv.cu",
        "replaces": "diffgfdn_tpu/kernels/pallas_cinv.py:34",
        "launches": launches["cinv"], "max_abs_err": errors["cinv"],
        "ms": device_ms(lambda: cinv(m)), "plain_ms": device_ms(lambda: plain(cinv, m)),
        "kernel_ms": kernel_ms(lambda: cinv(m)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: torch.linalg.inv(m)),
    })
    num, den, z = inputs["sos96"]
    b_ms, b_by = bound(*sos_cost(num.shape[0], num.shape[1], z.shape[0]))
    rows.append({
        "name": "sos_cascade_response", "route": "cuda", "source": "diffgfdn_torch/csrc/sos.cu",
        "replaces": "diffgfdn_tpu/kernels/pallas_sos.py:47",
        "launches": launches["sos"], "max_abs_err": errors["sos"],
        "ms": device_ms(lambda: sos_cascade_response(num, den, z)),
        "plain_ms": device_ms(lambda: plain(sos_cascade_response, num, den, z)),
        "kernel_ms": kernel_ms(bare_cascade(sos_mod, num, den, z)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })
    m, b = inputs["lu"]
    k, n = m.shape[0], m.shape[1]
    b_ms, b_by = bound(*lu_cost(k, n))
    rows.append({
        "name": "lu_solve", "route": "cuda", "source": "diffgfdn_torch/csrc/lu.cu",
        "replaces": "diffgfdn_tpu/kernels/pallas_lu.py:46",
        "launches": launches["lu"], "max_abs_err": errors["lu"],
        "ms": device_ms(lambda: lu_solve(m, b)),
        "plain_ms": device_ms(lambda: plain(lu_solve, m, b)),
        "kernel_ms": kernel_ms(lambda: lu_solve(m, b)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: torch.linalg.solve(m, b.unsqueeze(-1))),
    })
    # the SOS kernel at the absorption shape (R = N = 12) is printed, not listed
    num, den, z = inputs["sos12"]
    b_ms, _ = bound(*sos_cost(num.shape[0], num.shape[1], z.shape[0]))
    print(f"sos at R={num.shape[0]}: {device_ms(lambda: sos_cascade_response(num, den, z)):.4f} ms "
          f"(kernel {kernel_ms(bare_cascade(sos_mod, num, den, z)):.4f} ms, "
          f"plain {device_ms(lambda: plain(sos_cascade_response, num, den, z)):.4f} ms, "
          f"bound {b_ms:.4f} ms)")
    return rows


@contextlib.contextmanager
def recording_kernel_inputs(store: dict, forward: bool = False, select=None):
    """Within the block, the wrappers of B5 and of the backward kernels (with
    ``forward``, of B1 and B3 too) keep a copy of the inputs of their first
    call, under the kernel's name; ``select`` {kernel name: predicate of the
    call's arguments} keeps the first call the predicate accepts instead."""
    from diffgfdn_torch.kernels import cinv, lu, sos

    patched = [(cinv, "neg_ptgpt", "neg_ptgpt"), (lu, "lut_apply", "lut_apply"),
               (lu, "lu_solve", "lu"), (sos, "sos_cascade_backward", "sos_backward")]
    if forward:
        patched += [(cinv, "cinv", "cinv"), (sos, "sos_cascade", "sos")]
    originals = [getattr(mod, attr) for mod, attr, _ in patched]

    def recorder(fn, name):
        def wrapped(*args):
            if name not in store and (select is None or name not in select
                                      or select[name](*args)):
                store[name] = tuple(a.detach().clone() for a in args)
            return fn(*args)
        # the wrapper counts under its module name, which is this recorder
        # while the block runs: launches made here are comparisons, not counted
        wrapped.launches = 0
        return wrapped

    for (mod, attr, name), fn in zip(patched, originals):
        setattr(mod, attr, recorder(fn, name))
    try:
        yield
    finally:
        for (mod, attr, _), fn in zip(patched, originals):
            setattr(mod, attr, fn)


def rel_l2(a, b) -> float:
    import torch

    ref = float(torch.linalg.vector_norm(b))
    diff = float(torch.linalg.vector_norm(a - b))
    return diff / ref if ref > 0.0 else diff


# a training step captured in a CUDA graph (training/scan.py) against the
# same step run eagerly (scan_epochs = False), from one state
GRAPH_STEPS = 3
GRAPH_LOSS_TOL = 1e-6  # each step's loss, relative
GRAPH_PARAM_TOL = 1e-5  # each parameter after the last step, relative L2
GRAPH_GRAD_TOL = 1e-3  # each gradient of the last step, relative L2


class TrainerState:
    """A trainer's parameters, Adam state, learning rates, schedule and EDC
    mask generator, restored in place: a captured step reads them by address."""

    def __init__(self, params: dict, optimizer, scheduler, generator=None):
        import copy

        self.params, self.optimizer, self.scheduler = params, optimizer, scheduler
        self.generator = generator
        self.values = {k: p.detach().clone() for k, p in params.items()}
        self.adam = {p: {k: v.clone() for k, v in st.items()}
                     for p, st in optimizer.state.items()}
        self.lrs = [g["lr"].clone() for g in optimizer.param_groups]
        self.schedule = copy.deepcopy(scheduler.state_dict())
        self.rng = None if generator is None else generator.get_state()

    def restore(self) -> None:
        import copy

        import torch

        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(self.values[k])
            for p, st in self.adam.items():
                for k, v in st.items():
                    self.optimizer.state[p][k].copy_(v)
            for g, lr in zip(self.optimizer.param_groups, self.lrs):
                g["lr"].copy_(lr)
        self.scheduler.load_state_dict(copy.deepcopy(self.schedule))
        if self.generator is not None:
            self.generator.set_state(self.rng)


@contextlib.contextmanager
def syncs_raise():
    """Within the block, an operation that waits for the card raises."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def graphed_vs_eager(label: str, trainer, params: dict, step, log_dir, generator=None,
                     kind: str = "train") -> dict:
    """A trainer's step (``step()``, returning the step's loss) through its
    CUDA graph (of the step kind ``kind``) and eagerly, in one process.

    The step graphs are made anew: a warm-up step and the capture. From one
    state (``params``, Adam's, the schedule's and ``generator``'s), then
    GRAPH_STEPS graphed steps and GRAPH_STEPS eager ones must agree: each
    loss within GRAPH_LOSS_TOL, the parameters after the last step within
    GRAPH_PARAM_TOL, its gradients within GRAPH_GRAD_TOL. Then TIMED_STEPS
    steps of each path in turns (eager, graphed, graphed, eager), the
    graphed ones under ``syncs_raise``; the launches per step of both paths
    must be equal. Then one graphed step runs under the profiler: it must
    replay a graph, and the launches the wrappers count for it (those a
    replay adds, ``training/scan.py`` ``ReplayCounts``) must be the kernels
    the card ran in the profile, kernel by kernel (``WRAPPER_SYMBOLS``); with
    ``log_dir`` its tables are written there. Returns the numbers, with the
    warm-up and capture times, each path's peak memory and the profiled
    step's busy time and idle share.
    """
    import torch

    trainer.scan_epochs = True
    trainer.graphs.clear()
    while trainer.graphs.get(kind) is None or not trainer.graphs.get(kind).captured:
        step()
    graph = trainer.graphs.get(kind)
    state = TrainerState(params, trainer.optimizer, trainer.scheduler, generator)
    runs = {}
    for scan in (True, False):
        state.restore()
        trainer.scan_epochs = scan
        losses = torch.stack([step().detach().clone().reshape(-1) for _ in range(GRAPH_STEPS)])
        runs[scan] = (losses, {k: p.detach().clone() for k, p in params.items()},
                      {k: p.grad.clone() for k, p in params.items()})
    (loss_g, par_g, grad_g), (loss_e, par_e, grad_e) = runs[True], runs[False]
    loss_rel = float(torch.max(torch.abs(loss_g - loss_e) / torch.abs(loss_e)))
    par_rel = max(rel_l2(par_g[k], par_e[k]) for k in par_e)
    grad_rel = max(rel_l2(grad_g[k], grad_e[k]) for k in grad_e)
    require(bool(torch.isfinite(loss_g).all()) and loss_rel <= GRAPH_LOSS_TOL
            and par_rel <= GRAPH_PARAM_TOL and grad_rel <= GRAPH_GRAD_TOL,
            f"{label}: graphed vs eager steps: loss {loss_rel}, parameters {par_rel}, "
            f"gradients {grad_rel}")

    times, peaks, per_step = {True: [], False: []}, {True: 0, False: 0}, {}
    for scan in (False, True, True, False):
        trainer.scan_epochs = scan
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        for _ in range(TIMED_STEPS):
            t0 = time.perf_counter()
            with syncs_raise() if scan else contextlib.nullcontext():
                step()
            torch.cuda.synchronize()
            times[scan].append(time.perf_counter() - t0)
        per_step[scan] = {k: v / TIMED_STEPS for k, v in launch_counts().items() if v}
        peaks[scan] = max(peaks[scan], torch.cuda.max_memory_allocated())
    require(per_step[True] == per_step[False],
            f"{label}: launches per graphed step {per_step[True]}, eager {per_step[False]}")
    trainer.scan_epochs = True
    graphed, eager = float(np.median(times[True])), float(np.median(times[False]))
    out = {
        "graph_vs_eager_loss_rel": loss_rel, "graph_vs_eager_param_rel_l2": par_rel,
        "graph_vs_eager_grad_rel_l2": grad_rel,
        "graphed_step_ms": graphed * 1e3, "graphed_steps_per_s": 1.0 / graphed,
        "eager_step_ms": eager * 1e3, "eager_steps_per_s": 1.0 / eager,
        "graphed_step_ms_all": [t * 1e3 for t in times[True]],
        "eager_step_ms_all": [t * 1e3 for t in times[False]],
        "warmup_s": graph.warmup_s, "capture_s": graph.capture_s,
        "graphed_peak_mem_mb": peaks[True] / 2 ** 20, "eager_peak_mem_mb": peaks[False] / 2 ** 20,
        "reserved_mem_mb": torch.cuda.memory_reserved() / 2 ** 20,
        "launches_per_step": per_step[True],
    }
    replays = sum(g.replays for g in trainer.graphs)
    reset_counts()
    prof, events, window = profile_events(step, f"graphed_{label}")
    counted = {k: v for k, v in launch_counts().items() if v}
    # the whole profile, not the window: device times converted to the
    # host's clock have placed a replay's first kernels before both the
    # host span and the label's device annotation
    kernels = device_kernels(events)
    ran = wrapper_launches(kernels)
    outside = len(kernels) - len(device_kernels(events, window))
    require(sum(g.replays for g in trainer.graphs) > replays and len(kernels) > 0,
            f"{label}: the profiled graphed step replayed no graph or ran no kernel")
    require(ran == counted, f"{label}: a graphed step counted the launches {counted}, "
            f"the card ran {ran}")
    table = None if log_dir is None else Path(log_dir) / f"profile_graphed_{label}.txt"
    wall, busy, ours, count = profile_numbers(prof, events, window, f"graphed_{label}", table)
    out.update(graphed_profiled_step_ms=wall, graphed_profiled_device_busy_ms=busy,
               graphed_profiled_kernels_ms=ours, graphed_profiled_kernel_count=count,
               graphed_profiled_launches=ran, graphed_profiled_idle_share=1.0 - busy / wall,
               graphed_profiled_kernels_outside_window=outside)
    return out


def train(name: str, tmp: Path, log_dir):
    """Phase 5 for one configuration: returns (result, backward-kernel inputs, launches)."""
    import torch

    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.losses import edc_mask
    from diffgfdn_torch.training import load_checkpoint, run_training_var_receiver_pos
    from diffgfdn_torch.utils.params import torch_state_from_jax

    cfg = preset_config(name)
    tc = cfg.trainer_config
    tc.train_dir = str(tmp / name / "train_run")
    tc.max_epochs = TRAIN_EPOCHS
    room = make_room(tmp, name, cfg.sample_rate, tc.num_freq_bins)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer, model = run_training_var_receiver_pos(cfg, room, device=DEVICE)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_run = torch.cuda.max_memory_allocated()
    for kernel in TRAIN_KERNELS[name]:
        require(launches[kernel] > 0, f"{name}: kernel {kernel} never launched in training")
    losses = trainer.train_loss + trainer.valid_loss
    require(len(trainer.train_loss) == TRAIN_EPOCHS and bool(np.isfinite(losses).all()),
            f"{name}: training losses {losses}")
    saved = torch_state_from_jax(load_checkpoint(tc.train_dir, TRAIN_EPOCHS - 1))
    for key, value in model.state_dict().items():
        require(torch.equal(saved[key], value.cpu()), f"{name}: checkpoint differs at {key}")
    require(any(g.replays for g in trainer.graphs), f"{name}: the run replayed no captured step")

    # one step on the kernels and on the plain versions: same parameters,
    # batch and EDC mask; the kernels' step keeps each backward kernel's inputs
    idx = torch.arange(BATCH, device=DEVICE)
    batch = trainer.gather(idx)
    mask = None
    if tc.use_edc_mask:
        n = 2 * (batch["z_values"].shape[0] - 1)
        length = min(trainer.max_ir_len_samps, n) - trainer.mixing_time_samps
        mask = edc_mask(length, torch.Generator(device=DEVICE).manual_seed(SEED), idx.device)
    inputs = {}
    with recording_kernel_inputs(inputs):
        loss_k, _ = trainer.loss_and_grads(batch, mask)
    grads_k = {n: p.grad.clone() for n, p in model.named_parameters()}
    with plain_versions():
        loss_p, _ = trainer.loss_and_grads(batch, mask)
    grads_p = {n: p.grad.clone() for n, p in model.named_parameters()}
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_errs = {n: rel_l2(grads_k[n], grads_p[n]) for n in grads_k}
    worst = max(grad_errs, key=grad_errs.get)
    require(loss_rel <= LOSS_TOL, f"{name}: step loss kernels vs plain {loss_rel}")
    require(grad_errs[worst] <= GRAD_TOL, f"{name}: gradient of {worst} kernels vs plain "
            f"{grad_errs[worst]}")

    # the step graphed and eagerly: agreement, times in turns, no sync; then
    # an eager step on the plain versions, and a profiled eager step
    graph = graphed_vs_eager(name, trainer, dict(model.named_parameters()),
                             lambda: trainer.fit_step(idx)[0], log_dir, trainer.mask_generator)
    trainer.scan_epochs = False
    with plain_versions():
        t0 = time.perf_counter()
        trainer.fit_step(idx)
        torch.cuda.synchronize()
        plain_step_s = time.perf_counter() - t0
    profiled = {}
    if log_dir is not None:
        wall, busy, ours, _ = profile_once(lambda: trainer.fit_step(idx), "train_step",
                                           Path(log_dir) / f"profile_train_{name}.txt")
        profiled = {"eager_profiled_step_ms": wall, "eager_profiled_device_busy_ms": busy,
                    "eager_profiled_kernels_ms": ours,
                    "eager_profiled_idle_share": 1.0 - busy / wall}
    trainer.scan_epochs = True
    result = {
        "config": name,
        "epochs": TRAIN_EPOCHS,
        "steps_per_epoch": trainer.steps_per_epoch,
        "batch": BATCH,
        "nfft": tc.num_freq_bins,
        "run_s": run_s,
        "train_loss": trainer.train_loss,
        "valid_loss": trainer.valid_loss,
        "plain_eager_step_ms": plain_step_s * 1e3,
        "peak_mem_run_mb": peak_run / 2 ** 20,
        "step_loss_rel_vs_plain": loss_rel,
        "max_grad_rel_l2_vs_plain": grad_errs[worst],
        "launches": {k: launches[k] for k in TRAIN_KERNELS[name]},
        **graph,
        **profiled,
    }
    return result, inputs, launches


def neg_ptgpt_cost(k: int, n: int):
    """Bytes moved and fp32 operations of -P^H G P^H (two N^3 complex contractions)."""
    return 3 * k * n * n * 8, k * 16 * n ** 3


def lut_apply_cost(k: int, n: int):
    """Bytes moved and fp32 operations of the transposed solve from the factors."""
    nbytes = k * (n * n * 8 + n * 4 + 2 * n * 8)
    return nbytes, k * (12 * n + 8 * n * (n - 1) + 2 * (n - 1))


def sos_backward_cost(r: int, k: int, f: int):
    """Bytes moved and fp32 operations of the cascade backward (h recomputed,
    then 6K sums per row)."""
    return r * f * 8 + f * 8 + 4 * r * k * 3 * 4, r * f * (91 * k + 11)


def sos_backward_saved_h_cost(r: int, k: int, f: int):
    """The same with h read from the forward's output instead of recomputed:
    G and h read, and the recompute's operations (sos_cost's) left out."""
    return 2 * r * f * 8 + f * 8 + 4 * r * k * 3 * 4, r * f * ((91 * k + 11) - (32 * k + 3))


def backward_rows(inputs: dict, launches: dict) -> list:
    """Phase 5, kernels: each backward kernel against its plain version (and a
    float64 reference on a few systems) at the inputs a training step gave
    it, and its time beside its bound, plain version and library call."""
    import torch

    from diffgfdn_torch.kernels.cinv import neg_ptgpt
    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.kernels.lu import lut_apply
    from diffgfdn_torch.kernels.sos import sos_cascade_backward, sos_cascade_backward_plain

    def both(fn, *args):
        out = fn(*args)
        with plain_versions():
            ref = fn(*args)
        torch.cuda.synchronize()
        return out, ref

    def plain(fn, *args):
        with plain_versions():
            return fn(*args)

    rows = []
    p, g = inputs["neg_ptgpt"]
    out, ref = both(neg_ptgpt, p, g)
    differ = int((out != ref).sum())
    p64, g64 = p[:256].cpu().numpy().astype(np.complex128), g[:256].cpu().numpy()
    ph = np.conj(np.swapaxes(p64, -1, -2))
    ref64 = -(ph @ g64 @ ph)
    err64 = float(np.abs(out[:256].cpu().numpy() - ref64).max() / np.abs(ref64).max())
    require(differ == 0 and err64 <= KERNEL_TOL,
            f"neg_ptgpt: {differ} elements differ from the plain version, f64 {err64}")
    print(f"neg_ptgpt {tuple(p.shape)}: elements differing from plain {differ}, "
          f"vs numpy {err64:.3e}")
    b_ms, b_by = bound(*neg_ptgpt_cost(p.shape[0], p.shape[1]))
    rows.append({
        "name": "neg_ptgpt", "route": "cuda", "source": "diffgfdn_torch/csrc/cinv.cu",
        "replaces": "diffgfdn_tpu/kernels/pallas_cinv.py:146",
        "launches": launches["neg_ptgpt"], "max_abs_err": float(torch.max(torch.abs(out - ref))),
        "ms": device_ms(lambda: neg_ptgpt(p, g)), "plain_ms": device_ms(lambda: plain(neg_ptgpt, p, g)),
        "kernel_ms": kernel_ms(lambda: neg_ptgpt(p, g)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: -(p.mH @ g @ p.mH)),
    })

    num, den, w, g, h = inputs["sos_backward"]
    (dn, dd), (dn_p, dd_p) = both(sos_cascade_backward, num, den, w, g, h)
    err = max(rel_err(dn, dn_p), rel_err(dd, dd_p))
    dn64, dd64 = sos_cascade_backward_plain(num[:4].double(), den[:4].double(),
                                            w.to(torch.complex128), g[:4].to(torch.complex128),
                                            h[:4].to(torch.complex128))
    err64 = max(rel_err(dn[:4].double(), dn64), rel_err(dd[:4].double(), dd64))
    require(err <= KERNEL_TOL, f"sos_cascade_backward: rel err {err}")
    require(err64 <= SOS_F64_TOL, f"sos_cascade_backward: vs float64 {err64}")
    print(f"sos_cascade_backward {tuple(num.shape)} x F={w.shape[0]}: rel err vs plain "
          f"{err:.3e}, vs float64 {err64:.3e}")
    b_ms, b_by = bound(*sos_backward_saved_h_cost(num.shape[0], num.shape[1], w.shape[0]))
    b_old, b_old_by = bound(*sos_backward_cost(num.shape[0], num.shape[1], w.shape[0]))
    k_ms = kernel_ms(lambda: sos_cascade_backward(num, den, w, g, h))
    print(f"sos_cascade_backward: kernel {k_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, h read), "
          f"bound with h recomputed {b_old:.4f} ms ({b_old_by})")
    rows.append({
        "name": "sos_cascade_backward", "route": "cuda", "source": "diffgfdn_torch/csrc/sos.cu",
        "replaces": "diffgfdn_tpu/kernels/pallas_sos.py:64",
        "launches": launches["sos_backward"],
        "max_abs_err": float(max(torch.max(torch.abs(dn - dn_p)), torch.max(torch.abs(dd - dd_p)))),
        "ms": device_ms(lambda: sos_cascade_backward(num, den, w, g, h)),
        "plain_ms": device_ms(lambda: plain(sos_cascade_backward, num, den, w, g, h)),
        "kernel_ms": k_ms, "bound_ms": b_ms, "bound_by": b_by,
        "bound_ms_h_recomputed": b_old, "library_ms": None,
    })

    m, _ = inputs["lu"]
    lu, piv, g = inputs["lut_apply"]
    out, ref = both(lut_apply, lu, piv, g)
    err = rel_err(out, ref)
    m64, g64 = m[:256].cpu().numpy().astype(np.complex128), g[:256].cpu().numpy()
    y64 = np.linalg.solve(np.conj(np.swapaxes(m64, -1, -2)), g64[..., None])[..., 0]
    err64 = float(np.abs(out[:256].cpu().numpy() - y64).max() / np.abs(y64).max())
    require(err <= KERNEL_TOL and err64 <= KERNEL_TOL, f"lut_apply: rel err {err}, f64 {err64}")
    print(f"lut_apply {tuple(g.shape)}: rel err vs plain {err:.3e}, vs numpy {err64:.3e}")
    b_ms, b_by = bound(*lut_apply_cost(g.shape[0], g.shape[1]))
    rows.append({
        "name": "lut_apply", "route": "cuda", "source": "diffgfdn_torch/csrc/lu.cu",
        "replaces": "diffgfdn_tpu/kernels/pallas_lu.py:142",
        "launches": launches["lut_apply"], "max_abs_err": float(torch.max(torch.abs(out - ref))),
        "ms": device_ms(lambda: lut_apply(lu, piv, g)),
        "plain_ms": device_ms(lambda: plain(lut_apply, lu, piv, g)),
        "kernel_ms": kernel_ms(lambda: lut_apply(lu, piv, g)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: torch.linalg.solve(m.mH, g.unsqueeze(-1))),
    })
    return rows


def ptxas_usage(log: str, fragment: str):
    """{registers, spill-store bytes, stack-frame bytes} that ptxas reported
    for the first entry function whose mangled name contains ``fragment``,
    or None. A stack frame without spills is a per-thread array that stayed
    in local memory."""
    for m in re.finditer(r"entry function '(\S+)'(.*?)Used (\d+) registers", log, re.S):
        if fragment in m.group(1):
            spill = re.search(r"(\d+) bytes spill stores", m.group(2))
            frame = re.search(r"(\d+) bytes stack frame", m.group(2))
            return {"registers": int(m.group(3)),
                    "spill_stores": int(spill.group(1)) if spill else 0,
                    "stack_frame": int(frame.group(1)) if frame else 0}
    return None


def sass_counts(lib_path: Path, fragment: str):
    """{instruction: count} of the shared-memory loads (LDS) and stores
    (STS), the constant-bank loads (LDC by register index, ULDC into a
    uniform register) and the fp32 products and sums (FMUL, FADD) that
    cuobjdump's SASS shows in the first kernel whose mangled name contains
    ``fragment``, and all its instructions, or None where cuobjdump or the
    kernel is missing."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                              timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    for block in sass.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        if fragment in name:
            counts = {op: len(re.findall(rf"\b{op}(?:\.[A-Z0-9.]+)?\s", block))
                      for op in ("LDS", "STS", "LDC", "ULDC", "FMUL", "FADD")}
            counts["all"] = len(re.findall(r"/\*[0-9a-f]{4}\*/\s", block))
            return counts
    return None


def kernel_times(root: Path) -> dict:
    """B1-B7 of the diffgfdn_torch package under ``root``, at the paths'
    shapes, so that two trees can be compared in turns in one call. B1: the
    seeded fullband model's loop-matrix blocks (3 x 65537 systems of 4 x 4),
    then 65537 random systems at N = 12 (learned scalar coupling) and 27
    (directional), each with ``torch.linalg.inv``'s time; B2: P from B1 and a
    seeded G at each of those shapes, with ``-(P^H G P^H)``'s time. B3
    (R = 96 heads, R = 12 absorption) and B4: coefficients from the same
    model at phase 2's first batch of receivers, a random G, h from B3. B5:
    the seeded three-room model's blocks (3 x 65537 of 4 x 4) and its input
    gains; B6: B5's factors and a seeded g. B7: the three-room model's
    delays, gains, feedback matrix and input gains on an impulse of 131072
    samples and at a 50000-sample spread. B1 and B2 also run at the
    directional step's sub-FDN shape (3 x 65536 random systems of 9 x 9).
    Per kernel and shape: the wrapper call's time (``ms``), the kernel's own
    device time (``kernel_ms``) and the bound (B1 / B2: the plain version's
    time too, median of 5); and, when this process built
    them, ptxas's registers, spill-store and stack-frame bytes of
    ``cinv_kernel`` and ``neg_ptgpt_kernel`` at N = 4, 8, 9, 12 and 27, the cascade kernels at
    K = 11, ``lu_solve_kernel`` and ``lut_apply_kernel`` at N = 4, 9, 12
    and 27 (B6 above N = 8: w in registers to N = 12, in shared memory
    above) and the B7 kernels at N = 12 and 27, with the
    shared-memory loads (LDS) cuobjdump counts in the B7 kernels. B5 and
    B6 also run at the directional step's shape (3 x 65537 random systems
    of 9 x 9) and at N = 27 (65537), with the plain version's time (median
    of 5) and ``torch.linalg.solve``'s beside each, and B7 at the
    directional preset's 27 delays (random orthogonal A, gains of a 1.2 s
    decay, an impulse of 131072 samples). Runs any tree of the port,
    whether its B4 reads h or recomputes it and whichever C entry point its
    B7 has."""
    import inspect

    sys.path.insert(0, str(root.resolve()))
    import diffgfdn_torch
    import torch

    require(root.resolve() in Path(diffgfdn_torch.__file__).resolve().parents,
            f"diffgfdn_torch imported from {diffgfdn_torch.__file__}, not from {root}")
    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.data.batching import arrays_from_room_dataset
    from diffgfdn_torch.kernels import _build, cinv, lu, sos, tdgfdn
    from diffgfdn_torch.models.gain_heads import svf_params_to_response
    from diffgfdn_torch.training import build_gfdn_model

    # before a model's first call loads a library; empty if this checkout
    # built it before
    logs = _build.build_all(("sos", "cinv", "lu", "tdgfdn"))
    name = "fullband_grid_colorless"
    cfg = preset_config(name)
    tr_cfg = preset_config("three_room_example")
    with tempfile.TemporaryDirectory() as tmp:
        room = make_room(Path(tmp), name, cfg.sample_rate, cfg.trainer_config.num_freq_bins)
        arrays = arrays_from_room_dataset(room)
        tr_room = make_room(Path(tmp), "three_room_example", tr_cfg.sample_rate,
                            tr_cfg.trainer_config.num_freq_bins)
    model = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz, device=DEVICE)
    tr_model = build_gfdn_model(tr_cfg, tr_room.common_decay_times, tr_room.band_centre_hz,
                                device=DEVICE)
    z = torch.from_numpy(arrays.z_values).to(DEVICE)
    pos = torch.from_numpy(arrays.listener_position[:BATCH]).to(DEVICE)
    with torch.no_grad():
        m_path = model.feedback_loop.loop_matrix_blocks(z).reshape(-1, 4, 4).contiguous()
        head = model.output_filters
        _, num, den = svf_params_to_response(head.mlp(head.position.encoding(pos)),
                                             head.cutoffs, z)
        num96 = num.reshape(-1, num.shape[-2], 3).contiguous()
        den96 = den.reshape(-1, den.shape[-2], 3).contiguous()
        coeffs = model.feedback_loop.sos_coeffs
        num12, den12 = coeffs[..., 0].contiguous(), coeffs[..., 1].contiguous()
        blocks = tr_model.feedback_loop.loop_matrix_blocks(z)
        groups, f, nper = blocks.shape[0], blocks.shape[1], blocks.shape[2]
        m_lu = blocks.reshape(-1, nper, nper).contiguous()
        b_lu = tr_model.input_gains[:, 0].to(torch.complex64).reshape(groups, 1, nper)
        b_lu = b_lu.expand(groups, f, nper).reshape(-1, nper).contiguous()
        fl = tr_model.feedback_loop
        td_args = (tr_model.delays, fl.gamma_scalar().clone(), fl.coupled_feedback_matrix(),
                   tr_model.input_gains[:, 0].clone())
    w = (1.0 / z).to(torch.complex64)
    r, k, f = num96.shape[0], num96.shape[1], w.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    g = torch.randn((r, f), dtype=torch.complex64, device=DEVICE, generator=gen)
    h = sos.sos_cascade(num96, den96, w)
    reads_h = "h" in inspect.signature(sos.sos_cascade_backward).parameters
    bwd_args = (num96, den96, w, g, h) if reads_h else (num96, den96, w, g)
    variants = hasattr(tdgfdn, "kernel_launcher")
    out = {"root": str(root), "b4_reads_h": reads_h, "b7_variants": variants, "ptxas": None}
    b7 = (("tdgfdn_ring_kernel<12>", "tdgfdn_ring_kernelILi12E"),
          ("tdgfdn_hist_kernel<12>", "tdgfdn_hist_kernelILi12E"),
          ("tdgfdn_kernel<12>", "tdgfdn_kernelILi12E"),
          ("tdgfdn_hist_kernel<27>", "tdgfdn_hist_kernelILi27E"),
          ("tdgfdn_lines_kernel<27>", "tdgfdn_lines_kernelILi27E"))
    out["b7_sass"] = {label: sass_counts(_build.library_path("tdgfdn"), frag)
                      for label, frag in b7}
    if any(logs.values()):
        out["ptxas"] = {
            **{f"{kern}<{n}>": ptxas_usage(logs["cinv"], f"{kern}ILi{n}E")
               for kern in ("cinv_kernel", "neg_ptgpt_kernel") for n in (4, 8, 9, 12, 27)},
            "sos_cascade_kernel": (ptxas_usage(logs["sos"], f"sos_cascade_kernelILi{k}E")
                                   or ptxas_usage(logs["sos"], "sos_cascade_kernelE")),
            f"sos_bwd_partial_kernel<{k}>": ptxas_usage(logs["sos"],
                                                        f"sos_bwd_partial_kernelILi{k}E"),
            **{f"lu_solve_kernel<{n}>": ptxas_usage(logs["lu"], f"lu_solve_kernelILi{n}E")
               for n in (4, 9, 12, 27)},
            **{f"lut_apply_kernel<{n}>": ptxas_usage(logs["lu"], f"lut_apply_kernelILi{n}E")
               for n in (4, 9, 12, 27)},
            **{label: ptxas_usage(logs["tdgfdn"], frag) for label, frag in b7},
        }
    for label, m in (("path", m_path),
                     ("directional", random_systems(DIRECTIONAL_SUB_FDN_SYSTEMS, 9, gen)[0]),
                     ("N=12", random_systems(65537, 12, gen)[0]),
                     ("N=27", random_systems(65537, 27, gen)[0])):
        kb, n = m.shape[0], m.shape[1]
        p = cinv.cinv(m)
        g_p = torch.randn(p.shape, dtype=torch.complex64, device=DEVICE, generator=gen)
        out[f"cinv {label}"] = {
            "shape": list(m.shape), "ms": device_ms(lambda: cinv.cinv(m)),
            "kernel_ms": kernel_ms(lambda: cinv.cinv(m)), "bound_ms": bound(*cinv_cost(kb, n))[0],
            "plain_ms": device_ms(lambda: cinv.cinv_plain(m), reps=5),
            "library_ms": device_ms(lambda: torch.linalg.inv(m))}
        out[f"neg_ptgpt {label}"] = {
            "shape": list(p.shape), "ms": device_ms(lambda: cinv.neg_ptgpt(p, g_p)),
            "kernel_ms": kernel_ms(lambda: cinv.neg_ptgpt(p, g_p)),
            "bound_ms": bound(*neg_ptgpt_cost(kb, n))[0],
            "plain_ms": device_ms(lambda: cinv.neg_ptgpt_plain(p, g_p), reps=5),
            "library_ms": device_ms(lambda: -(p.mH @ g_p @ p.mH))}
        del p, g_p
    for label, (n, d) in (("sos96", (num96, den96)), ("sos12", (num12, den12))):
        def call(n=n, d=d):
            return sos.sos_cascade_response(n, d, z)
        out[label] = {"ms": device_ms(call), "kernel_ms": kernel_ms(bare_cascade(sos, n, d, z)),
                      "bound_ms": bound(*sos_cost(n.shape[0], n.shape[1], f))[0]}

    def backward():
        return sos.sos_cascade_backward(*bwd_args)
    out["sos_backward"] = {
        "ms": device_ms(backward), "kernel_ms": kernel_ms(backward),
        "bound_ms": bound(*sos_backward_saved_h_cost(r, k, f))[0],
        "bound_ms_h_recomputed": bound(*sos_backward_cost(r, k, f))[0],
    }

    kb, n = m_lu.shape[0], m_lu.shape[1]
    _, factors, piv = lu.lu_solve(m_lu, b_lu)
    g_lu = torch.randn((kb, n), dtype=torch.complex64, device=DEVICE, generator=gen)
    out["lu_solve path"] = {
        "shape": list(m_lu.shape), "ms": device_ms(lambda: lu.lu_solve(m_lu, b_lu)),
        "kernel_ms": kernel_ms(lambda: lu.lu_solve(m_lu, b_lu)),
        "bound_ms": bound(*lu_cost(kb, n))[0],
        "library_ms": device_ms(lambda: torch.linalg.solve(m_lu, b_lu.unsqueeze(-1)))}
    out["lut_apply path"] = {
        "shape": list(g_lu.shape), "ms": device_ms(lambda: lu.lut_apply(factors, piv, g_lu)),
        "kernel_ms": kernel_ms(lambda: lu.lut_apply(factors, piv, g_lu)),
        "bound_ms": bound(*lut_apply_cost(kb, n))[0],
        "library_ms": device_ms(lambda: torch.linalg.solve(m_lu.mH, g_lu.unsqueeze(-1)))}

    t_len = 131072
    impulse = torch.zeros(t_len, device=DEVICE)
    impulse[0] = 1.0
    td_in = td_args + (impulse,)
    out["tdgfdn path"] = {
        "delays": [int(x) for x in td_args[0]], "t_len": t_len,
        "ms": device_ms(lambda: tdgfdn.delay_line_outputs(*td_in)),
        "kernel_ms": kernel_ms(bare_tdgfdn(tdgfdn, *td_in)),
        "bound_ms": bound(*tdgfdn_cost(t_len, len(td_args[0])))[0]}
    if variants:
        out["tdgfdn path"]["plan"] = list(tdgfdn.kernel_plan(
            td_args[0], tdgfdn.shared_memory_limit(impulse.device)))
    wide = tuple(int(x) for x in np.linspace(100, 50000, len(td_args[0])))
    out["tdgfdn wide"] = {
        "delays": [min(wide), max(wide)], "t_len": t_len,
        "kernel_ms": kernel_ms(bare_tdgfdn(tdgfdn, wide, *td_in[1:]))}

    for label, n, kb in (("directional", 9, 3 * 65537), ("N=27", 27, 65537)):
        m5, b5 = random_systems(kb, n, gen)
        _, factors, piv = lu.lu_solve(m5, b5)
        g5 = torch.randn((kb, n), dtype=torch.complex64, device=DEVICE, generator=gen)
        out[f"lu_solve {label}"] = {
            "shape": list(m5.shape), "ms": device_ms(lambda: lu.lu_solve(m5, b5)),
            "kernel_ms": kernel_ms(lambda: lu.lu_solve(m5, b5)),
            "bound_ms": bound(*lu_cost(kb, n))[0],
            "plain_ms": device_ms(lambda: lu.lu_solve_plain(m5, b5), reps=5),
            "library_ms": device_ms(lambda: torch.linalg.solve(m5, b5.unsqueeze(-1)))}
        out[f"lut_apply {label}"] = {
            "shape": list(g5.shape), "ms": device_ms(lambda: lu.lut_apply(factors, piv, g5)),
            "kernel_ms": kernel_ms(lambda: lu.lut_apply(factors, piv, g5)),
            "bound_ms": bound(*lut_apply_cost(kb, n))[0],
            "plain_ms": device_ms(lambda: lu.lut_apply_plain(factors, piv, g5), reps=5),
            "library_ms": device_ms(lambda: torch.linalg.solve(m5.mH, g5.unsqueeze(-1)))}
        del m5, b5, factors, piv, g5

    d_cfg = preset_config(DIRECTIONAL_PRESET)
    delays27 = tuple(int(x) for x in d_cfg.delay_length_samps)
    rng = np.random.RandomState(SEED)
    a27 = np.linalg.qr(rng.randn(27, 27))[0].astype(np.float32)
    g27 = (10.0 ** (-3.0 * np.asarray(delays27) / (1.2 * d_cfg.sample_rate))).astype(np.float32)
    b27 = rng.randn(27).astype(np.float32)
    td27 = tuple(torch.from_numpy(x).to(DEVICE) for x in (g27, a27, b27)) + (impulse,)
    out["tdgfdn directional"] = {
        "delays": [min(delays27), max(delays27)], "n": 27, "t_len": t_len,
        "ms": device_ms(lambda: tdgfdn.delay_line_outputs(delays27, *td27)),
        "kernel_ms": kernel_ms(bare_tdgfdn(tdgfdn, delays27, *td27)),
        "bound_ms": bound(*tdgfdn_cost(t_len, 27))[0]}
    if variants:
        out["tdgfdn directional"]["plan"] = list(tdgfdn.kernel_plan(
            delays27, tdgfdn.shared_memory_limit(impulse.device)))
    return out


def td_reference_f64(delays, gains, a, b, u) -> np.ndarray:
    """Delay-line outputs (T, N) by the block recursion in float64 numpy."""
    n, t_len, m_max = len(delays), len(u), max(delays)
    block = min(delays)
    hist = np.zeros((n, t_len + m_max))
    y = np.zeros((t_len, n))
    for start in range(0, t_len, block):
        stop = min(start + block, t_len)
        t = np.arange(start, stop)
        y_blk = gains * hist[np.arange(n)[None, :], t[:, None] + m_max - np.asarray(delays)]
        hist[:, m_max + start:m_max + stop] = (y_blk @ a.T + u[start:stop, None] * b).T
        y[start:stop] = y_blk
    return y


def tdgfdn_cost(t_len: int, n: int):
    """Bytes moved and fp32 operations of the delay-line recursion: u read,
    y written, the loop's constants read; per sample N gain products, the
    N x N mix and the N input terms."""
    return 4 * t_len * (1 + n) + 4 * (n * n + 3 * n), t_len * (2 * n * n + 2 * n)


def time_domain(name: str, infer, log_dir):
    """Phase 6 for one configuration: returns (result, launches, B7 inputs or None)."""
    import torch

    from diffgfdn_torch.inference import make_rir_synthesis_fn, make_time_domain_synthesis_fn
    from diffgfdn_torch.kernels.dispatch import plain_versions

    model, cfg = infer.model, infer.config
    nfft, fs = cfg.trainer_config.num_freq_bins, cfg.sample_rate
    idx = np.arange(NUM_RECEIVERS)
    batches = [infer._device_batch(idx[k:k + BATCH]) for k in range(0, NUM_RECEIVERS, BATCH)]

    def mix(synth, drop_direct=False):
        outs = []
        for batch in batches:
            if drop_direct:
                batch = {k: v for k, v in batch.items() if k != "target_early_response"}
            outs.append(synth(batch).cpu().numpy())
        return np.concatenate(outs)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    synth = make_time_domain_synthesis_fn(model, nfft)
    torch.cuda.synchronize()
    factory_s = time.perf_counter() - t0
    rirs = mix(synth)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for kernel in TD_KERNELS[name]:
        require(launches[kernel] > 0, f"{name}: kernel {kernel} never launched in time-domain synthesis")
    if "tdgfdn" not in TD_KERNELS[name]:
        require(launches["tdgfdn"] == 0, f"{name}: the filtered path launched B7")
    require(rirs.shape == (NUM_RECEIVERS, nfft), f"{name}: time-domain RIR shape {rirs.shape}")
    require(bool(np.isfinite(rirs).all()), f"{name}: non-finite time-domain RIRs")
    edc = edc_db(rirs)
    drop = edc[:, int(0.05 * fs)] - edc[:, int(1.0 * fs)]
    require(bool((drop > 10.0).all()), f"{name}: time-domain RIRs do not decay (min {drop.min()} dB)")
    half_s = int(0.5 * fs)

    with plain_versions():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = mix(make_time_domain_synthesis_fn(model, nfft))
        plain_s = time.perf_counter() - t0
    rel = float(np.linalg.norm(rirs - plain) / np.linalg.norm(plain))
    edc_plain = float(np.abs(edc - edc_db(plain))[:, :half_s].max())
    require(rel <= RIR_TOL, f"{name}: time-domain RIRs vs plain path rel L2 {rel}")
    require(edc_plain <= EDC_TOL_DB, f"{name}: time-domain EDC vs plain path {edc_plain} dB")

    freq = mix(make_rir_synthesis_fn(model, cfg.trainer_config.reduced_pole_radius), True)
    freq_err = float(np.abs(rirs - freq).max() / np.abs(freq).max())
    edc_freq = float(np.abs(edc - edc_db(freq))[:, :half_s].max())
    require(freq_err <= TD_FREQ_TOL, f"{name}: time domain vs frequency path {freq_err} of peak")
    require(edc_freq <= EDC_TOL_DB, f"{name}: time domain vs frequency path EDC {edc_freq} dB")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        mix(synth)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    profiled = {}
    if log_dir is not None:
        wall, busy, ours, _ = profile_once(lambda: synth(batches[0]), "td_batch",
                                        Path(log_dir) / f"profile_td_{name}.txt")
        profiled = {"profiled_batch_ms": wall, "profiled_device_busy_ms": busy,
                    "profiled_kernels_ms": ours, "profiled_idle_share": 1.0 - busy / wall}
    mix_s = float(np.median(times))
    result = {
        "config": name,
        "receivers": NUM_RECEIVERS,
        "num_samples": nfft,
        "factory_ms": factory_s * 1e3,
        "mix_ms": mix_s * 1e3,
        "mix_ms_all": [t * 1e3 for t in times],
        "rirs_per_s": NUM_RECEIVERS / mix_s,
        "plain_factory_and_mix_ms": plain_s * 1e3,
        "rel_l2_vs_plain": rel,
        "edc_max_abs_db_vs_plain": edc_plain,
        "max_abs_over_peak_vs_freq_path": freq_err,
        "edc_max_abs_db_vs_freq_path": edc_freq,
        "peak_mem_mb": peak / 2 ** 20,
        "launches": {k: launches[k] for k in TD_KERNELS[name]},
        **profiled,
    }
    b7_inputs = None
    if "tdgfdn" in TD_KERNELS[name]:
        fl = model.feedback_loop
        with torch.no_grad():
            b7_inputs = (model.delays, fl.gamma_scalar().clone(), fl.coupled_feedback_matrix(),
                         model.input_gains[:, 0].clone())
    return result, launches, b7_inputs


def bare_tdgfdn(tdgfdn_module, delays, g, a, b, u):
    """A call of B7 alone on the buffers ``delay_line_outputs`` would
    prepare: through the module's ``kernel_launcher`` (this tree's
    ``csrc/tdgfdn.cu``, the wrapper's plan), or for a tree from before it,
    through the C entry point that took the delays as a device array (whose
    copy to the card stays outside the timed window)."""
    import torch

    if hasattr(tdgfdn_module, "kernel_launcher"):
        return tdgfdn_module.kernel_launcher(delays, g, a, b, u)[0]
    from diffgfdn_torch.kernels import _build

    delays = tuple(int(x) for x in delays)
    n, t_len, m_max = len(delays), u.shape[0], max(delays)
    bufs = [x.to(torch.float32).contiguous() for x in (u, g, a, b)]
    bufs.append(torch.tensor(delays, dtype=torch.int32, device=u.device))
    bufs.append(torch.empty((n, t_len), dtype=torch.float32, device=u.device))
    bufs.append(torch.empty((n, t_len + m_max), dtype=torch.float32, device=u.device))
    block = min(tdgfdn_module._block_size(delays), tdgfdn_module.MAX_THREADS)
    lib = _build.load("tdgfdn", tdgfdn_module._SIGNATURES)

    def call():
        err = lib.diffgfdn_tdgfdn_f32(*(x.data_ptr() for x in bufs), t_len, n, m_max, block,
                                      torch.cuda.current_stream().cuda_stream)
        _build.check(err, "tdgfdn")
    return call


def tdgfdn_row(b7_inputs, launches: int) -> dict:
    """Phase 6, B7: the kernel against its plain version, bit for bit, at the
    path's delays (impulse and random input), at the delay spreads whose
    ring fills the shared memory exactly and one slot past it, and at a
    50000-sample spread, and against float64 numpy; then its time beside
    its bound and plain version."""
    import torch

    from diffgfdn_torch.kernels import tdgfdn
    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.kernels.tdgfdn import delay_line_outputs

    delays, g, a, b = b7_inputs
    n = len(delays)
    t_len = 131072
    rng = np.random.RandomState(SEED)
    impulse = torch.zeros(t_len, device=g.device)
    impulse[0] = 1.0
    noise = torch.from_numpy(rng.randn(t_len).astype(np.float32)).to(g.device)
    wide = tuple(int(d) for d in np.linspace(100, 50000, n))
    limit = tdgfdn.shared_memory_limit(g.device)
    cases = [("path", delays, impulse), ("path_random", delays, noise), ("wide", wide, noise),
             ("ring_full", tdgfdn.ring_boundary_delays(n, 683, limit, False), noise),
             ("ring_full_plus_one", tdgfdn.ring_boundary_delays(n, 683, limit, True), noise)]
    err_path = None
    for label, dl, u in cases:
        out = delay_line_outputs(dl, g, a, b, u)
        with plain_versions():
            ref = delay_line_outputs(dl, g, a, b, u)
        torch.cuda.synchronize()
        differ = int((out != ref).sum())
        require(differ == 0, f"tdgfdn {label}: {differ} elements differ from the plain version")
        head = 8192
        ref64 = td_reference_f64(dl, g.double().cpu().numpy(), a.double().cpu().numpy(),
                                 b.double().cpu().numpy(), u[:head].double().cpu().numpy())
        err64 = float(np.abs(out[:head].cpu().numpy() - ref64).max() / np.abs(ref64).max())
        require(err64 <= KERNEL_TOL, f"tdgfdn {label}: vs float64 numpy {err64}")
        if label == "path":
            err_path = float(torch.max(torch.abs(out - ref)))
        plan = tdgfdn.kernel_plan(dl, limit)
        print(f"tdgfdn {label} T={t_len} N={n} delays {min(dl)}..{max(dl)} ({plan}): elements "
              f"differing from plain {differ}, vs float64 numpy (first {head}) {err64:.3e}")
    b_ms, b_by = bound(*tdgfdn_cost(t_len, n))
    plain_args = (delays, g, a, b, impulse)

    def plain():
        with plain_versions():
            return delay_line_outputs(*plain_args)

    return {
        "name": "tdgfdn", "route": "cuda", "source": "diffgfdn_torch/csrc/tdgfdn.cu",
        "replaces": "diffgfdn_tpu/kernels/tdgfdn.py:167",
        "launches": launches, "max_abs_err": err_path,
        "ms": device_ms(lambda: delay_line_outputs(*plain_args)),
        "plain_ms": device_ms(plain, reps=5),
        "kernel_ms": kernel_ms(bare_tdgfdn(tdgfdn, *plain_args)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


# ----------------------------- phase 7: subband -------------------------------

# the kernels a band-parallel step launches, once each for all bands of a group:
# B1 / B2 in the colorless loss, B3 for the GEQ absorption (fixed buffers: no
# B4), B5 / B6 in the scalar heads' drive
SUBBAND_KERNELS = ("cinv", "neg_ptgpt", "sos", "lu", "lut_apply")
SUBBAND_GROUP_SIZES = [2, 4, 2]  # the architecture groups of the eight default bands
BAND_SEQ_LOSS_TOL = 1e-5  # a band of the band-parallel step vs the sequential trainer
TURNS = 4  # rounds of band-parallel and sequential steps, in turns
SUBBAND_FS = 32000.0  # create_config's sample rate and nfft
SUBBAND_NFFT = 131072


def timed_row(name, source, replaces, launches, err, call, plain_call, kernel_call, cost,
              library, shape) -> dict:
    """A kernel's JSON row: one wrapper call (``ms``), its plain version, the
    kernel alone (``kernel_ms``), the bound of ``cost`` (bytes, operations)
    and the library call, timed on the card."""
    b_ms, b_by = bound(*cost)
    return {
        "name": name, "route": "cuda",
        "source": f"diffgfdn_torch/csrc/{source}", "replaces": replaces,
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(call), "plain_ms": device_ms(plain_call),
        "kernel_ms": kernel_ms(kernel_call), "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None if library is None else device_ms(library),
        "shape": list(shape),
    }


def band_rows(inputs: dict, launches: dict, bands: int) -> list:
    """Phase 7, kernels: each kernel of the band-parallel step against its plain
    version at the inputs that step gave it (B1, B2, B5 bit for bit), timed
    beside its bound, plain version and library call; B4 at the band-stacked
    cascades (off the path: the absorption cascades take no gradient)."""
    import torch

    from diffgfdn_torch.kernels import sos as sos_mod
    from diffgfdn_torch.kernels.cinv import cinv, neg_ptgpt
    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.kernels.lu import lu_solve, lut_apply

    def both(fn, *args):
        out = fn(*args)
        with plain_versions():
            ref = fn(*args)
        torch.cuda.synchronize()
        return out, ref

    def plain(fn, *args):
        with plain_versions():
            return fn(*args)

    def row(name, source, replaces, launch_key, err, call, plain_call, kernel_call, cost,
            library, shape):
        return timed_row(f"{name} [{bands}-band group]", source, replaces,
                         launches[launch_key], err, call, plain_call, kernel_call, cost,
                         library, shape)

    rows = []
    (m,) = inputs["cinv"]
    out, ref = both(cinv, m)
    differ = int((out != ref).sum())
    require(differ == 0, f"band cinv {tuple(m.shape)}: {differ} elements differ from plain")
    k, n = m.shape[0], m.shape[1]
    rows.append(row("cinv", "cinv.cu", "diffgfdn_tpu/kernels/pallas_cinv.py:34", "cinv",
                    float(torch.max(torch.abs(out - ref))), lambda: cinv(m),
                    lambda: plain(cinv, m), lambda: cinv(m), cinv_cost(k, n),
                    lambda: torch.linalg.inv(m), m.shape))
    p, g = inputs["neg_ptgpt"]
    out, ref = both(neg_ptgpt, p, g)
    differ_b2 = int((out != ref).sum())
    require(differ_b2 == 0, f"band neg_ptgpt {tuple(p.shape)}: {differ_b2} elements differ")
    rows.append(row("neg_ptgpt", "cinv.cu", "diffgfdn_tpu/kernels/pallas_cinv.py:146",
                    "neg_ptgpt", float(torch.max(torch.abs(out - ref))),
                    lambda: neg_ptgpt(p, g), lambda: plain(neg_ptgpt, p, g),
                    lambda: neg_ptgpt(p, g), neg_ptgpt_cost(p.shape[0], p.shape[1]),
                    lambda: -(p.mH @ g @ p.mH), p.shape))
    num, den, w = inputs["sos"]
    out, ref = both(sos_mod.sos_cascade, num, den, w)
    err_b3 = rel_err(out, ref)
    require(err_b3 <= KERNEL_TOL, f"band sos {tuple(num.shape)}: rel err {err_b3}")
    rows.append(row("sos_cascade_response", "sos.cu", "diffgfdn_tpu/kernels/pallas_sos.py:47",
                    "sos", float(torch.max(torch.abs(out - ref))),
                    lambda: sos_mod.sos_cascade(num, den, w),
                    lambda: plain(sos_mod.sos_cascade, num, den, w),
                    lambda: sos_mod.sos_cascade(num, den, w),
                    sos_cost(num.shape[0], num.shape[1], w.shape[0]), None, num.shape))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    g4 = torch.randn(out.shape, dtype=torch.complex64, device=DEVICE, generator=gen)
    h = out
    (dn, dd), (dn_p, dd_p) = both(sos_mod.sos_cascade_backward, num, den, w, g4, h)
    err_b4 = max(rel_err(dn, dn_p), rel_err(dd, dd_p))
    require(err_b4 <= KERNEL_TOL, f"band sos_cascade_backward {tuple(num.shape)}: {err_b4}")
    rows.append(row("sos_cascade_backward", "sos.cu", "diffgfdn_tpu/kernels/pallas_sos.py:64",
                    "sos_backward",
                    float(max(torch.max(torch.abs(dn - dn_p)), torch.max(torch.abs(dd - dd_p)))),
                    lambda: sos_mod.sos_cascade_backward(num, den, w, g4, h),
                    lambda: plain(sos_mod.sos_cascade_backward, num, den, w, g4, h),
                    lambda: sos_mod.sos_cascade_backward(num, den, w, g4, h),
                    sos_backward_saved_h_cost(num.shape[0], num.shape[1], w.shape[0]), None,
                    num.shape))
    m, b = inputs["lu"]
    (x, lu, piv), (x_p, lu_p, piv_p) = both(lu_solve, m, b)
    differ_b5 = [int((o != r).sum()) for o, r in ((x, x_p), (lu, lu_p), (piv, piv_p))]
    require(differ_b5 == [0, 0, 0], f"band lu {tuple(m.shape)}: elements differing {differ_b5}")
    k, n = m.shape[0], m.shape[1]
    rows.append(row("lu_solve", "lu.cu", "diffgfdn_tpu/kernels/pallas_lu.py:46", "lu",
                    float(torch.max(torch.abs(x - x_p))), lambda: lu_solve(m, b),
                    lambda: plain(lu_solve, m, b), lambda: lu_solve(m, b), lu_cost(k, n),
                    lambda: torch.linalg.solve(m, b.unsqueeze(-1)), m.shape))
    lu, piv, g6 = inputs["lut_apply"]
    out, ref = both(lut_apply, lu, piv, g6)
    err_b6 = rel_err(out, ref)
    require(err_b6 <= KERNEL_TOL, f"band lut_apply {tuple(g6.shape)}: rel err {err_b6}")
    rows.append(row("lut_apply", "lu.cu", "diffgfdn_tpu/kernels/pallas_lu.py:142",
                    "lut_apply", float(torch.max(torch.abs(out - ref))),
                    lambda: lut_apply(lu, piv, g6), lambda: plain(lut_apply, lu, piv, g6),
                    lambda: lut_apply(lu, piv, g6), lut_apply_cost(g6.shape[0], g6.shape[1]),
                    lambda: torch.linalg.solve(m.mH, g6.unsqueeze(-1)), g6.shape))
    print(f"phase 7 kernels at the {bands}-band group: B1 {tuple(m.shape)} and B2 differ "
          f"from plain in {differ} / {differ_b2} elements, B3 {tuple(num.shape)} rel err "
          f"{err_b3:.3e}, B4 {err_b4:.3e}, B5 (x, factors, pivots) {differ_b5}, B6 "
          f"{err_b6:.3e}")
    return rows


def sequential_trainers(configs, room, arrays, spe: int) -> list:
    """One sequential GFDNTrainer per band, ready to step (as fit_indexed sets
    them up): the user path without --band-parallel."""
    from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer, make_optimizer
    from diffgfdn_torch.training.solver import subband_resp

    out = []
    for cfg in configs:
        model = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz,
                                 device=DEVICE)
        trainer = GFDNTrainer(model, cfg.trainer_config, spe,
                              common_decay_times=room.common_decay_times,
                              subband_filter_resp=subband_resp(cfg),
                              sample_rate=cfg.sample_rate, device=DEVICE)
        trainer.upload_arrays(arrays)
        trainer.optimizer, trainer.scheduler = make_optimizer(cfg.trainer_config, model, spe)
        out.append(trainer)
    return out


def subband(tmp: Path, log_dir):
    """Phase 7: 8-band subband training and broadband reconstruction.
    Returns (result, kernel rows)."""
    import torch

    from diffgfdn_torch.cli import run_subband_training as rst
    from diffgfdn_torch.data.batching import arrays_from_room_dataset, train_valid_split
    from diffgfdn_torch.inference import broadband_edc_errors_device, infer_all_octave_bands
    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer, load_checkpoint
    from diffgfdn_torch.training.solver import steps_per_epoch, subband_resp
    from diffgfdn_torch.utils.params import load_jax_params

    fs, nfft = SUBBAND_FS, SUBBAND_NFFT
    room = make_room(tmp, "subband", fs, nfft)
    configs = [
        rst.create_config(f, str(tmp / "subband" / "srirs.pkl"), str(tmp / "subband" / "train"),
                          nfft, sample_rate=fs, max_epochs=TRAIN_EPOCHS, batch_size=BATCH)
        for f in rst.DEFAULT_FREQS
    ]
    groups = rst.architecture_groups(configs)
    require([len(g) for g in groups] == SUBBAND_GROUP_SIZES,
            f"subband architecture groups {[len(g) for g in groups]}")
    arrays = arrays_from_room_dataset(room)
    splits = [train_valid_split(np.arange(arrays.num_items),
                                g[0].trainer_config.train_valid_split, seed=g[0].seed)
              for g in groups]

    # the main path: training_band_parallel as the CLI's --band-parallel runs it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    histories = rst.training_band_parallel(configs, room, device=DEVICE)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_run = torch.cuda.max_memory_allocated()
    steps = valid = 0
    for (tr, va), hist in zip(splits, histories):
        steps += hist.shape[0] * steps_per_epoch(len(tr), BATCH)
        valid += hist.shape[0] * -(-len(va) // min(BATCH, len(va)))
    for kernel in ("neg_ptgpt", "lut_apply"):
        require(launches[kernel] == steps, f"subband: {kernel} launched {launches[kernel]} "
                f"times in {steps} steps of {len(groups)} groups")
    for kernel in ("cinv", "sos", "lu"):
        require(launches[kernel] == steps + valid, f"subband: {kernel} launched "
                f"{launches[kernel]} times in {steps} steps and {valid} validation batches")
    require(launches["sos_backward"] == 0 and launches["tdgfdn"] == 0,
            f"subband: kernels off the path launched {launches}")
    require(all(np.isfinite(h).all() and h.shape == (TRAIN_EPOCHS, len(g))
                for h, g in zip(histories, groups)), f"subband: train losses {histories}")
    for cfg in configs:
        tree = load_checkpoint(cfg.trainer_config.train_dir, TRAIN_EPOCHS - 1)
        model = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz,
                                 device=DEVICE)
        load_jax_params(model, tree)  # strict: the band's own architecture
        require(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
                f"subband: non-finite checkpoint of {cfg.trainer_config.train_dir}")

    # per group: one step on kernels vs plain versions and, for the largest
    # group, one band against the sequential trainer; then timed steps
    idx = torch.arange(BATCH, device=DEVICE)
    group_results, trainers, rows = [], [], []
    for group, (tr, _) in zip(groups, splits):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = rst.band_parallel_trainer(group, room, arrays, tr, DEVICE)
        freqs = [c.trainer_config.subband_process_config.centre_frequency for c in group]
        inputs = {}
        with recording_kernel_inputs(inputs, forward=True):
            loss_k, _ = trainer.loss_and_grads(idx)
        grads_k = {n: p.grad.clone() for n, p in trainer.params.items()}
        with plain_versions():
            loss_p, _ = trainer.loss_and_grads(idx)
        grads_p = {n: p.grad.clone() for n, p in trainer.params.items()}
        loss_rel = float(torch.max(torch.abs(loss_k - loss_p) / torch.abs(loss_p)))
        grad_errs = {(n, b): rel_l2(grads_k[n][b], grads_p[n][b])
                     for n in grads_k for b in range(len(group))}
        worst = max(grad_errs, key=grad_errs.get)
        require(loss_rel <= LOSS_TOL, f"subband {freqs}: step loss kernels vs plain {loss_rel}")
        require(grad_errs[worst] <= GRAD_TOL, f"subband {freqs}: gradient {worst} kernels "
                f"vs plain {grad_errs[worst]}")
        result = {"bands_hz": freqs, "step_loss_rel_vs_plain": loss_rel,
                  "max_grad_rel_l2_vs_plain": grad_errs[worst]}
        if len(group) == max(SUBBAND_GROUP_SIZES):
            rows = band_rows(inputs, launches, len(group))
            b = len(group) - 1  # the group's last band: its own delays, not the first's
            cfg = group[b]
            model = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz,
                                     device=DEVICE)
            seq = GFDNTrainer(model, cfg.trainer_config, 1,
                              common_decay_times=room.common_decay_times,
                              subband_filter_resp=subband_resp(cfg), sample_rate=fs,
                              device=DEVICE)
            seq.features = {k: v[b] for k, v in trainer.band_feats.items()}
            seq.upload_arrays(arrays)
            loss_s, _ = seq.loss_and_grads(seq.gather(idx))
            seq_loss = abs(float(loss_s) - float(loss_k[b])) / abs(float(loss_s))
            seq_grad = max(rel_l2(grads_k[n][b], p.grad) for n, p in model.named_parameters())
            require(seq_loss <= BAND_SEQ_LOSS_TOL and seq_grad <= GRAD_TOL,
                    f"subband band {freqs[b]} Hz vs sequential: loss {seq_loss}, "
                    f"gradient {seq_grad}")
            result.update(sequential_band_hz=freqs[b], loss_rel_vs_sequential=seq_loss,
                          max_grad_rel_l2_vs_sequential=seq_grad)
            del seq, model, inputs
        label = f"subband_{len(group)}_bands_{freqs[0]:.0f}Hz"
        graph = graphed_vs_eager(label, trainer, trainer.params,
                                 lambda trainer=trainer: trainer.step(idx)[0], log_dir,
                                 trainer.mask_generator)
        require(graph["launches_per_step"] == {k: 1.0 for k in SUBBAND_KERNELS},
                f"subband {freqs}: launches per step {graph['launches_per_step']}")
        result.update(graph)
        if log_dir is not None:
            trainer.scan_epochs = False
            wall, busy, ours, _ = profile_once(
                lambda trainer=trainer: trainer.step(idx), "band_step",
                Path(log_dir) / f"profile_{label}.txt")
            trainer.scan_epochs = True
            result.update(eager_profiled_step_ms=wall, eager_profiled_device_busy_ms=busy,
                          eager_profiled_kernels_ms=ours,
                          eager_profiled_idle_share=1.0 - busy / wall)
        group_results.append(result)
        trainers.append(trainer)

    # every band's step: the groups' band-parallel steps against the eight
    # sequential trainers' steps, in turns
    seqs = sequential_trainers(configs, room, arrays, steps_per_epoch(len(splits[0][0]), BATCH))
    for seq in seqs:  # the warm-up step and the capture
        seq.fit_step(idx)
        seq.fit_step(idx)
    parallel_s, sequential_s = [], []
    for turn in range(TURNS):
        order = ("parallel", "sequential") if turn % 2 == 0 else ("sequential", "parallel")
        for kind in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for step in ([t.step for t in trainers] if kind == "parallel"
                         else [s.fit_step for s in seqs]):
                step(idx)
            torch.cuda.synchronize()
            (parallel_s if kind == "parallel" else sequential_s).append(time.perf_counter() - t0)
    del seqs, trainers

    # broadband reconstruction from the trained bands' checkpoints
    rec = np.arange(NUM_RECEIVERS)
    infer_all_octave_bands(configs, room, rec[:BATCH], device=DEVICE)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rirs = infer_all_octave_bands(configs, room, rec, device=DEVICE)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    with plain_versions():
        plain_rirs = infer_all_octave_bands(configs, room, rec, device=DEVICE)
    require(rirs.shape == (NUM_RECEIVERS, nfft) and bool(np.isfinite(rirs).all()),
            f"subband: broadband RIRs {rirs.shape}, finite {np.isfinite(rirs).all()}")
    mix = int(0.02 * fs)
    merge_rel = float(np.linalg.norm(rirs - plain_rirs) / np.linalg.norm(plain_rirs))
    merge_rel_late = float(np.linalg.norm(rirs[:, mix:] - plain_rirs[:, mix:])
                           / np.linalg.norm(plain_rirs[:, mix:]))
    merge_edc = float(np.abs(edc_db(rirs) - edc_db(plain_rirs))[:, : int(0.5 * fs)].max())
    require(merge_rel <= RIR_TOL and merge_rel_late <= RIR_TOL and merge_edc <= EDC_TOL_DB,
            f"subband: broadband RIRs vs plain rel L2 {merge_rel}, late {merge_rel_late}, "
            f"EDC {merge_edc} dB")
    broadband_edc_errors_device(configs, room, rec[:BATCH], BATCH, device=DEVICE)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errs = broadband_edc_errors_device(configs, room, rec, BATCH, device=DEVICE)
    device_edc_s = time.perf_counter() - t0
    end = min(int(float(np.max(room.common_decay_times)) * fs), nfft)
    target = np.zeros((NUM_RECEIVERS, nfft), np.float32)
    t_len = min(nfft, arrays.target_rir_time.shape[1])
    target[:, :t_len] = arrays.target_rir_time[:, :t_len]

    def edc_np(x):  # ops.basic.db of the Schroeder integral, in float64
        e = np.cumsum((x[..., mix:end].astype(np.float64) ** 2)[..., ::-1], axis=-1)[..., ::-1]
        eps = float(np.finfo(np.float32).eps)
        return np.maximum(10.0 * np.log10(np.abs(e) + eps), -200.0)

    errs_host = np.mean(np.abs(edc_np(rirs) - edc_np(target)), axis=-1)
    edc_gap = float(np.max(np.abs(errs - errs_host)))
    require(errs.shape == (NUM_RECEIVERS,) and bool(np.isfinite(errs).all())
            and edc_gap <= EDC_TOL_DB,
            f"subband: device EDC errors vs host: {edc_gap} dB")
    result = {
        "bands": len(configs), "groups": [len(g) for g in groups], "epochs": TRAIN_EPOCHS,
        "batch": BATCH, "nfft": nfft, "run_s": run_s, "peak_mem_run_mb": peak_run / 2 ** 20,
        "train_loss_last_epoch": [h[-1].tolist() for h in histories],
        "launches": {k: launches[k] for k in SUBBAND_KERNELS + ("sos_backward",)},
        "steps": steps, "valid_batches": valid, "group_steps": group_results,
        "all_bands_step_ms_parallel": [t * 1e3 for t in parallel_s],
        "all_bands_step_ms_sequential": [t * 1e3 for t in sequential_s],
        "merge_s": merge_s, "merged_rirs_per_s": NUM_RECEIVERS / merge_s,
        "merge_rel_l2_vs_plain": merge_rel, "merge_rel_l2_late_vs_plain": merge_rel_late,
        "merge_edc_max_abs_db_vs_plain": merge_edc,
        "device_edc_s": device_edc_s, "device_edc_mean_db": float(np.mean(errs)),
        "device_edc_max_abs_db_vs_host": edc_gap,
    }
    return result, rows


# ----------------------------- phase 8: directional ----------------------------

# the directional preset at full width: ambi order 2, N = 27 lines in 3 groups
# of 9 (B1, B2, B5, B6 on 9 x 9 blocks), a 10 x 128 skip MLP, 20 Fourier
# features, nfft 131072, batch 32; the synthetic spatial dataset at 32 kHz
DIRECTIONAL_PRESET = "directional_1000Hz_res0.6m"
DIRECTIONAL_GRID_M = 0.3  # 847 receivers (the Treble grid: 838)
DIRECTIONAL_DECAYS = (1.2, 2.2, 1.6)  # nfft 131072, as the preset's
DIRECTIONAL_RIR_S = 0.5
DIRECTIONAL_RECEIVERS = 847
# B1 / B2 systems of a directional step: 3 sub-FDNs of 9 lines at the 65536
# bins above DC (C10)
DIRECTIONAL_SUB_FDN_SYSTEMS = 3 * 65536
# B1 / B2 in the colorless loss (one sub-FDN inverse a step, shared with the
# per-step normalization), B5 / B6 in the transposed drive
DIRECTIONAL_KERNELS = ("cinv", "neg_ptgpt", "lu", "lut_apply")


def directional_rows(inputs: dict, launches: dict) -> list:
    """Phase 8, kernels: B1, B2, B5 and B6 against their plain versions (bit
    for bit) at the 9 x 9 inputs one directional training step gave them,
    timed beside their bounds, plain versions and library calls."""
    import torch

    from diffgfdn_torch.kernels.cinv import cinv, neg_ptgpt
    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.kernels.lu import lu_solve, lut_apply

    def both(fn, *args):
        out = fn(*args)
        with plain_versions():
            ref = fn(*args)
        torch.cuda.synchronize()
        return out, ref

    def plain(fn, *args):
        with plain_versions():
            return fn(*args)

    def row(name, source, replaces, key, err, fn, args, cost, library, shape):
        return timed_row(f"{name} [directional]", source, replaces, launches[key], err,
                         lambda: fn(*args), lambda: plain(fn, *args), lambda: fn(*args), cost,
                         library, shape)

    (m,) = inputs["cinv"]
    out, ref = both(cinv, m)
    differ = [int((out != ref).sum())]
    k, n = m.shape[0], m.shape[1]
    rows = [row("cinv", "cinv.cu", "diffgfdn_tpu/kernels/pallas_cinv.py:34", "cinv",
                float(torch.max(torch.abs(out - ref))), cinv, (m,), cinv_cost(k, n),
                lambda: torch.linalg.inv(m), m.shape)]
    p, g = inputs["neg_ptgpt"]
    out, ref = both(neg_ptgpt, p, g)
    differ.append(int((out != ref).sum()))
    rows.append(row("neg_ptgpt", "cinv.cu", "diffgfdn_tpu/kernels/pallas_cinv.py:146",
                    "neg_ptgpt", float(torch.max(torch.abs(out - ref))), neg_ptgpt, (p, g),
                    neg_ptgpt_cost(p.shape[0], p.shape[1]), lambda: -(p.mH @ g @ p.mH),
                    p.shape))
    m5, b5 = inputs["lu"]
    (x, lu, piv), (x_p, lu_p, piv_p) = both(lu_solve, m5, b5)
    differ_b5 = [int((o != r).sum()) for o, r in ((x, x_p), (lu, lu_p), (piv, piv_p))]
    rows.append(row("lu_solve", "lu.cu", "diffgfdn_tpu/kernels/pallas_lu.py:46", "lu",
                    float(torch.max(torch.abs(x - x_p))), lu_solve, (m5, b5),
                    lu_cost(m5.shape[0], m5.shape[1]),
                    lambda: torch.linalg.solve(m5, b5.unsqueeze(-1)), m5.shape))
    lu6, piv6, g6 = inputs["lut_apply"]
    out, ref = both(lut_apply, lu6, piv6, g6)
    differ.append(int((out != ref).sum()))
    rows.append(row("lut_apply", "lu.cu", "diffgfdn_tpu/kernels/pallas_lu.py:142",
                    "lut_apply", float(torch.max(torch.abs(out - ref))), lut_apply,
                    (lu6, piv6, g6), lut_apply_cost(g6.shape[0], g6.shape[1]),
                    lambda: torch.linalg.solve(m5.mH, g6.unsqueeze(-1)), g6.shape))
    # B5's factors are those of the transposed blocks, B6 solves with them:
    # float64 numpy on a few systems
    m64, b64, g64 = (t[:256].cpu().numpy().astype(np.complex128) for t in (m5, b5, g6))
    x64 = np.linalg.solve(m64, b64[..., None])[..., 0]
    y64 = np.linalg.solve(np.conj(np.swapaxes(m64, -1, -2)), g64[..., None])[..., 0]
    err64 = max(float(np.abs(x[:256].cpu().numpy() - x64).max() / np.abs(x64).max()),
                float(np.abs(out[:256].cpu().numpy() - y64).max() / np.abs(y64).max()))
    print(f"phase 8 kernels: B1 {tuple(m.shape)}, B2, B6 differ from plain in {differ} "
          f"elements, B5 {tuple(m5.shape)} (x, factors, pivots) in {differ_b5}; B5 / B6 vs "
          f"float64 numpy {err64:.3e}")
    require(differ == [0, 0, 0] and differ_b5 == [0, 0, 0] and err64 <= KERNEL_TOL,
            f"directional kernels vs plain: B1, B2, B6 {differ}, B5 {differ_b5}, f64 {err64}")
    return rows


def directional_b7_row(model, launches: int) -> dict:
    """Phase 8, B7 at N = 27 on the transposed feedback matrix: against its
    plain version bit for bit (impulse and random input) and float64 numpy,
    timed beside its bound and plain version. The plan is the lines
    variant: the coefficients in shared memory, the history in device
    memory."""
    import torch

    from diffgfdn_torch.kernels import tdgfdn
    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.kernels.tdgfdn import delay_line_outputs

    fl = model.feedback_loop
    with torch.no_grad():
        delays, g = model.delays, fl.gamma_scalar().clone()
        a = fl.coupled_feedback_matrix().T.contiguous()
        b = model.input_gains[:, 0].clone()
    n, t_len = len(delays), 131072
    impulse = torch.zeros(t_len, device=g.device)
    impulse[0] = 1.0
    noise = torch.from_numpy(np.random.RandomState(SEED).randn(t_len).astype(np.float32))
    plan = tdgfdn.kernel_plan(delays, tdgfdn.shared_memory_limit(g.device))
    err_path = None
    for label, u in (("path", impulse), ("path_random", noise.to(g.device))):
        out = delay_line_outputs(delays, g, a, b, u)
        with plain_versions():
            ref = delay_line_outputs(delays, g, a, b, u)
        torch.cuda.synchronize()
        differ = int((out != ref).sum())
        head = 8192
        ref64 = td_reference_f64(delays, g.double().cpu().numpy(), a.double().cpu().numpy(),
                                 b.double().cpu().numpy(), u[:head].double().cpu().numpy())
        err64 = float(np.abs(out[:head].cpu().numpy() - ref64).max() / np.abs(ref64).max())
        require(differ == 0 and err64 <= KERNEL_TOL,
                f"directional tdgfdn {label}: {differ} elements differ, f64 {err64}")
        if label == "path":
            err_path = float(torch.max(torch.abs(out - ref)))
        print(f"tdgfdn directional {label} T={t_len} N={n} ({plan}): elements differing from "
              f"plain {differ}, vs float64 numpy (first {head}) {err64:.3e}")
    args = (delays, g, a, b, impulse)

    def plain():
        with plain_versions():
            return delay_line_outputs(*args)

    row = timed_row("tdgfdn [directional, N = 27]", "tdgfdn.cu",
                    "diffgfdn_tpu/kernels/tdgfdn.py:167", launches, err_path,
                    lambda: delay_line_outputs(*args), plain, bare_tdgfdn(tdgfdn, *args),
                    tdgfdn_cost(t_len, n), None, (t_len, n))
    row["plan"] = list(plan)
    print(f"tdgfdn directional: the plan {plan} {row['kernel_ms']:.4f} ms")
    return row


def directional(tmp: Path, log_dir):
    """Phase 8: the directional preset trained, served and synthesized in
    the time domain at full width. Returns (result, kernel rows, the served
    SRIRs (96, 9, 131072), which phase 13 converts to BRIRs)."""
    import torch

    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.data import (
        generate_spatial_three_room_pickle,
        SpatialThreeRoomDataset,
        split_by_grid_resolution,
    )
    from diffgfdn_torch.inference import (
        InferDiffGFDN,
        make_rir_synthesis_fn,
        make_time_domain_synthesis_fn,
    )
    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.losses import edc_mask
    from diffgfdn_torch.training import load_checkpoint
    from diffgfdn_torch.training import run_training_anisotropic_decay_var_receiver_pos
    from diffgfdn_torch.training.solver import steps_per_epoch
    from diffgfdn_torch.utils.params import torch_state_from_jax

    cfg = preset_config(DIRECTIONAL_PRESET)
    tc = cfg.trainer_config
    tc.train_dir = str(tmp / "directional" / "train")
    tc.max_epochs = TRAIN_EPOCHS
    fs = cfg.sample_rate
    t0 = time.perf_counter()
    path = generate_spatial_three_room_pickle(
        tmp / "directional" / "srirs.pkl", fs=fs, grid_spacing_m=DIRECTIONAL_GRID_M,
        rir_len_s=DIRECTIONAL_RIR_S, decay_times=DIRECTIONAL_DECAYS, seed=SEED)
    room = SpatialThreeRoomDataset(path)
    data_s = time.perf_counter() - t0
    nfft = room.num_freq_bins
    require(room.num_rec == DIRECTIONAL_RECEIVERS and nfft == tc.num_freq_bins,
            f"directional dataset: {room.num_rec} receivers, nfft {nfft}")
    train_idx, valid_idx = split_by_grid_resolution(room, tc.grid_resolution_m)

    # the main path: the directional solver, as the CLI runs a preset with ambi_order
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer, model = run_training_anisotropic_decay_var_receiver_pos(cfg, room, device=DEVICE)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_run = torch.cuda.max_memory_allocated()
    steps = TRAIN_EPOCHS * steps_per_epoch(len(train_idx), BATCH)
    valid = TRAIN_EPOCHS * -(-len(valid_idx) // min(BATCH, len(valid_idx)))
    for kernel in ("neg_ptgpt", "lut_apply"):
        require(launches[kernel] == steps, f"directional: {kernel} launched "
                f"{launches[kernel]} times in {steps} steps")
    for kernel in ("cinv", "lu"):
        require(launches[kernel] == steps + valid, f"directional: {kernel} launched "
                f"{launches[kernel]} times in {steps} steps and {valid} validation batches")
    require(launches["sos"] == launches["sos_backward"] == launches["tdgfdn"] == 0,
            f"directional: kernels off the path launched {launches}")
    losses = trainer.train_loss + trainer.valid_loss
    require(len(trainer.train_loss) == TRAIN_EPOCHS and bool(np.isfinite(losses).all()),
            f"directional: training losses {losses}")
    saved = torch_state_from_jax(load_checkpoint(tc.train_dir, TRAIN_EPOCHS - 1))
    for key, value in model.state_dict().items():
        require(torch.equal(saved[key], value.cpu()), f"directional: checkpoint differs at {key}")

    # one step on the kernels and on the plain versions (same parameters,
    # batch and EDC mask); the kernels' step keeps each kernel's inputs
    idx = torch.arange(BATCH, device=DEVICE)
    batch = trainer.gather(idx)
    mask = edc_mask(trainer.edc_mask_length(batch["z_values"].shape[0]),
                    torch.Generator(device=DEVICE).manual_seed(SEED), idx.device)
    inputs = {}
    with recording_kernel_inputs(inputs, forward=True):
        loss_k, _ = trainer.loss_and_grads(batch, mask)
    grads_k = {n: p.grad.clone() for n, p in model.named_parameters()}
    with plain_versions():
        loss_p, _ = trainer.loss_and_grads(batch, mask)
    grads_p = {n: p.grad.clone() for n, p in model.named_parameters()}
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_errs = {n: rel_l2(grads_k[n], grads_p[n]) for n in grads_k}
    worst = max(grad_errs, key=grad_errs.get)
    require(loss_rel <= LOSS_TOL, f"directional: step loss kernels vs plain {loss_rel}")
    require(grad_errs[worst] <= GRAD_TOL, f"directional: gradient of {worst} kernels vs "
            f"plain {grad_errs[worst]}")
    rows = directional_rows(inputs, launches)
    del inputs

    # the step graphed and eagerly: agreement, times in turns, no sync
    graph = graphed_vs_eager("directional", trainer, dict(model.named_parameters()),
                             lambda: trainer.fit_step(idx)[0], log_dir, trainer.mask_generator)
    per_step = graph["launches_per_step"]
    require(per_step == {k: 1.0 for k in DIRECTIONAL_KERNELS},
            f"directional: launches per step {per_step}")
    # an eager step on the plain versions, and a profiled eager step
    trainer.scan_epochs = False
    with plain_versions():
        t0 = time.perf_counter()
        trainer.fit_step(idx)
        torch.cuda.synchronize()
        plain_step_s = time.perf_counter() - t0
    profiled = {}
    if log_dir is not None:
        wall, busy, ours, _ = profile_once(lambda: trainer.fit_step(idx), "directional_step",
                                           Path(log_dir) / "profile_train_directional.txt")
        profiled = {"eager_profiled_step_ms": wall, "eager_profiled_device_busy_ms": busy,
                    "eager_profiled_kernels_ms": ours,
                    "eager_profiled_idle_share": 1.0 - busy / wall}
    for row, kernel in zip(rows, DIRECTIONAL_KERNELS):
        row["launches_per_step"] = per_step[kernel]
    train_loss, valid_loss = trainer.train_loss, trainer.valid_loss
    del trainer, batch

    # serving: InferDiffGFDN from the trained checkpoint, as a user serves SRIRs
    rec = np.arange(NUM_RECEIVERS)
    infer = InferDiffGFDN(cfg, room, variant="directional", device=DEVICE)
    infer.rirs_at(rec[:BATCH], BATCH)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    rirs = infer.rirs_at(rec, BATCH)
    serve_launches = launch_counts()
    n_ch = (cfg.ambi_order + 1) ** 2
    require(serve_launches["lu"] == NUM_RECEIVERS // BATCH,
            f"directional serving: B5 launched {serve_launches['lu']} times")
    require(rirs.shape == (NUM_RECEIVERS, n_ch, nfft) and bool(np.isfinite(rirs).all()),
            f"directional: served SRIRs {rirs.shape}, finite {np.isfinite(rirs).all()}")
    edc = edc_db(rirs)
    drop = edc[..., int(0.05 * fs)] - edc[..., int(1.0 * fs)]
    require(bool((drop > 10.0).all()), f"directional: SRIRs do not decay (min {drop.min()} dB)")
    with plain_versions():
        plain = infer.rirs_at(rec, BATCH)
    half_s = int(0.5 * fs)
    serve_rel = rel_l2(torch.from_numpy(rirs), torch.from_numpy(plain))
    serve_edc = float(np.abs(edc - edc_db(plain))[..., :half_s].max())
    require(serve_rel <= RIR_TOL and serve_edc <= EDC_TOL_DB,
            f"directional: served SRIRs vs plain rel L2 {serve_rel}, EDC {serve_edc} dB")
    del plain
    serve_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        infer.rirs_at(rec, BATCH)
        torch.cuda.synchronize()
        serve_times.append(time.perf_counter() - t0)

    # time domain: B7 once on the transposed feedback matrix, then the SH mix
    batches = [infer._device_batch(rec[k:k + BATCH]) for k in range(0, NUM_RECEIVERS, BATCH)]

    def mix(synth):
        return np.concatenate([synth(b).cpu().numpy() for b in batches])

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    synth = make_time_domain_synthesis_fn(infer.model, nfft)
    torch.cuda.synchronize()
    factory_s = time.perf_counter() - t0
    td = mix(synth)
    td_launches = launch_counts()
    require(td_launches["tdgfdn"] == 1, f"directional time domain: B7 launched "
            f"{td_launches['tdgfdn']} times")
    require(td.shape == rirs.shape and bool(np.isfinite(td).all()),
            f"directional time domain: {td.shape}")
    with plain_versions():
        td_plain = mix(make_time_domain_synthesis_fn(infer.model, nfft))
    td_rel = rel_l2(torch.from_numpy(td), torch.from_numpy(td_plain))
    require(td_rel <= RIR_TOL, f"directional time domain vs plain rel L2 {td_rel}")
    del td_plain
    freq = mix(make_rir_synthesis_fn(infer.model, tc.reduced_pole_radius))
    freq_err = float(np.abs(td - freq).max() / np.abs(freq).max())
    td_edc = float(np.abs(edc_db(td) - edc_db(freq))[..., :half_s].max())
    require(freq_err <= TD_FREQ_TOL and td_edc <= EDC_TOL_DB,
            f"directional time domain vs frequency path {freq_err} of peak, EDC {td_edc} dB")
    del freq, td
    mix_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        mix(synth)
        torch.cuda.synchronize()
        mix_times.append(time.perf_counter() - t0)
    rows.append(directional_b7_row(infer.model, td_launches["tdgfdn"]))

    result = {
        "preset": DIRECTIONAL_PRESET, "receivers": room.num_rec, "train": len(train_idx),
        "valid": len(valid_idx), "delay_lines": len(cfg.delay_length_samps), "nfft": nfft,
        "batch": BATCH, "epochs": TRAIN_EPOCHS, "data_s": data_s, "run_s": run_s,
        "train_loss": train_loss, "valid_loss": valid_loss,
        "launches": {k: launches[k] for k in DIRECTIONAL_KERNELS},
        "steps": steps, "valid_batches": valid,
        "step_loss_rel_vs_plain": loss_rel, "max_grad_rel_l2_vs_plain": grad_errs[worst],
        "plain_eager_step_ms": plain_step_s * 1e3, "peak_mem_run_mb": peak_run / 2 ** 20,
        **graph, **profiled,
        "served_rirs_per_s": NUM_RECEIVERS / float(np.median(serve_times)),
        "serve_s": serve_times, "serve_rel_l2_vs_plain": serve_rel,
        "serve_edc_max_abs_db_vs_plain": serve_edc,
        "td_factory_ms": factory_s * 1e3, "td_mix_ms": float(np.median(mix_times)) * 1e3,
        "td_rirs_per_s": NUM_RECEIVERS / float(np.median(mix_times)),
        "td_rel_l2_vs_plain": td_rel, "td_max_abs_over_peak_vs_freq_path": freq_err,
        "td_edc_max_abs_db_vs_freq_path": td_edc,
    }
    return result, rows, rirs


SPATIAL_PRESETS = ("spatial_directional_1000Hz", "spatial_omni_1000Hz")
SPATIAL_FS = 32000.0  # phase 8's grid: the directional preset's sample rate
SPATIAL_EPOCHS = 4  # of the presets' 20
SPATIAL_STEP_LOSS_TOL = 1e-5  # a directional step, card vs CPU, relative
SPATIAL_AMP_TOL = 1e-5  # served amplitudes, card vs CPU: max abs error / max |CPU|
SPATIAL_SYNTH_TOL = 1e-4  # synthesis on one noise tensor, card vs CPU, relative L2


def spatial_step_times(trainer, train_idx: np.ndarray, log_dir, label: str) -> dict:
    """``fit_step`` on the first batch graphed and eagerly
    (:func:`graphed_vs_eager`), what was already allocated when the steps
    began (earlier phases' tensors included), and with ``log_dir`` the
    card's idle share of one profiled eager step too."""
    import torch

    idx = torch.as_tensor(train_idx[: min(trainer.cfg.batch_size, len(train_idx))],
                          device=trainer.device)
    resident = torch.cuda.memory_allocated()
    out = graphed_vs_eager(label, trainer, dict(trainer.model.named_parameters()),
                           lambda: trainer.fit_step(idx), log_dir)
    out["resident_mem_mb"] = resident / 2 ** 20
    if log_dir is not None:
        trainer.scan_epochs = False
        wall, busy, _, _ = profile_once(lambda: trainer.fit_step(idx), label,
                                        Path(log_dir) / f"profile_{label}.txt")
        trainer.scan_epochs = True
        out.update(eager_profiled_step_ms=wall, eager_profiled_device_busy_ms=busy,
                   eager_profiled_idle_share=1.0 - busy / wall)
    return out


def spatial_sampling(tmp: Path, log_dir):
    """Phase 9: the common-slopes spatial-sampling MLPs trained and served at
    the presets' widths.

    ``spatial_directional_1000Hz`` (a 12 x 128 MLP, 20 Fourier features,
    batch 50, lr 1e-3, the max-directivity beamformer, ambi order 2, 12
    directions) trains through ``run_training_spatial_sampling`` at its three
    grid resolutions (0.9, 0.6, 0.3 m), then ``spatial_omni_1000Hz`` (a 5 x 16
    MLP, batch 50) at its ten (3.0 .. 0.3 m; each has training receivers on
    this grid) on the grid's omni collapse. Cuts: 4 epochs of the presets' 20;
    phase 8's synthetic spatial grid at 32 kHz (0.3 m, 847 receivers, 0.5 s
    SRIRs, decays 1.2 / 2.2 / 1.6 s, so the EDC envelopes are 70400 samples)
    instead of the Treble grids (git-LFS placeholders), for the omni preset
    too (its own pickle is an omni one). Every receiver is then served from
    the 0.3 m checkpoints through ``get_ambisonic_rirs(use_trained_model=True)``:
    (847, 9, 16000) SRIRs and (847, 16000) omni RIRs. No hand-written kernel
    lies on this path: every launch count must stay 0.
    """
    import torch

    from diffgfdn_torch.config import spatial_preset_config
    from diffgfdn_torch.data import (
        arrays_from_spatial_dataset,
        generate_spatial_three_room_pickle,
        SpatialThreeRoomDataset,
        split_by_grid_resolution,
    )
    from diffgfdn_torch.inference import get_ambisonic_rirs, get_output_from_trained_model
    from diffgfdn_torch.inference.cs_synthesis import get_rirs_from_common_slopes_model
    from diffgfdn_torch.training import (
        build_spatial_model,
        collapse_amplitudes_to_omni,
        run_training_spatial_sampling,
        SpatialSamplingTrainer,
    )
    from diffgfdn_torch.utils.params import jax_params_from_torch, load_jax_params

    path = tmp / "directional" / "srirs.pkl"
    t0 = time.perf_counter()
    if not path.exists():
        generate_spatial_three_room_pickle(
            path, fs=SPATIAL_FS, grid_spacing_m=DIRECTIONAL_GRID_M, rir_len_s=DIRECTIONAL_RIR_S,
            decay_times=DIRECTIONAL_DECAYS, seed=SEED)
    full_room = SpatialThreeRoomDataset(path)
    data_s = time.perf_counter() - t0
    require(full_room.num_rec == DIRECTIONAL_RECEIVERS,
            f"spatial sampling: {full_room.num_rec} receivers")
    rec = full_room.receiver_position
    ir_len = full_room.rir_length
    result = {"receivers": full_room.num_rec, "epochs": SPATIAL_EPOCHS, "data_s": data_s}
    for name in SPATIAL_PRESETS:
        cfg = spatial_preset_config(name, max_epochs=SPATIAL_EPOCHS,
                                    train_dir=str(tmp / "spatial" / name))
        room = full_room if cfg.use_directional_rirs else collapse_amplitudes_to_omni(full_room)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        trained = run_training_spatial_sampling(cfg, room, device=DEVICE)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        require(all(v == 0 for v in launch_counts().values()),
                f"{name}: hand-written kernels launched {launch_counts()}")
        per_res = {"run_s": run_s, "peak_mem_run_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
        finest = min(trained)
        for res, (trainer, _) in trained.items():
            losses = trainer.train_loss + trainer.valid_loss
            require(len(trainer.train_loss) == SPATIAL_EPOCHS and bool(np.isfinite(losses).all())
                    and trainer.train_loss[-1] < trainer.train_loss[0],
                    f"{name} at {res:.1f} m: losses {trainer.train_loss} {trainer.valid_loss}")
            train_idx, valid_idx = split_by_grid_resolution(room, res)
            row = {"train": len(train_idx), "valid": len(valid_idx),
                   "epoch_s": float(np.median(trainer.epoch_s)),
                   "train_loss": [trainer.train_loss[0], trainer.train_loss[-1]],
                   "valid_loss": trainer.valid_loss[:1] + trainer.valid_loss[-1:]}
            row.update(spatial_step_times(trainer, train_idx, log_dir if res == finest else None,
                                          f"spatial_step_{name}_{res:.1f}m"))
            per_res[f"{res:.1f}"] = row
        trainer, model = trained[finest]
        if cfg.use_directional_rirs:
            # one step on the card and on the CPU from the same parameters and batch
            cpu_model = build_spatial_model(cfg, room.num_rooms, room.ambi_order, device="cpu")
            load_jax_params(cpu_model, jax_params_from_torch(model))
            cpu = SpatialSamplingTrainer(cpu_model, cfg, room, device="cpu")
            cpu.upload_arrays(arrays_from_spatial_dataset(room))
            idx = np.arange(cfg.batch_size)
            loss_k = trainer.loss_and_grads(trainer.gather(torch.as_tensor(idx, device=DEVICE)))
            loss_c = cpu.loss_and_grads(cpu.gather(torch.from_numpy(idx)))
            loss_rel = abs(float(loss_k) - float(loss_c)) / abs(float(loss_c))
            grad_errs = {n: rel_l2(p.grad.cpu(), q.grad) for (n, p), q in
                         zip(model.named_parameters(), cpu_model.parameters())}
            worst = max(grad_errs, key=grad_errs.get)
            require(loss_rel <= SPATIAL_STEP_LOSS_TOL,
                    f"{name}: step loss card vs CPU {loss_rel}")
            require(grad_errs[worst] <= GRAD_TOL,
                    f"{name}: gradient of {worst} card vs CPU {grad_errs[worst]}")
            per_res.update(step_loss_rel_card_vs_cpu=loss_rel,
                           max_grad_rel_l2_card_vs_cpu=grad_errs[worst])
            del cpu, cpu_model
        del trained, trainer, model

        # serving every receiver from the finest resolution's checkpoints
        def serve_all():
            return get_ambisonic_rirs(rec, room, use_trained_model=True, configs=[cfg],
                                      grid_resolution_m=finest, seed=SEED, device=DEVICE)

        reset_counts()
        out = serve_all()
        require(all(v == 0 for v in launch_counts().values()),
                f"{name} serving: hand-written kernels launched {launch_counts()}")
        want = ((room.num_rec, (room.ambi_order + 1) ** 2, ir_len) if cfg.use_directional_rirs
                else (room.num_rec, ir_len))
        require(out.rirs.shape == want and bool(np.isfinite(out.rirs).all()),
                f"{name}: served {out.rirs.shape}, finite {np.isfinite(out.rirs).all()}")
        # the omni RIRs and the SRIRs' W channel of every receiver decay
        edc = edc_db(out.rirs[:, 0] if cfg.use_directional_rirs else out.rirs)
        fs = room.sample_rate
        drop = edc[:, int(0.05 * fs)] - edc[:, int(0.45 * fs)]
        require(bool((drop > 3.0).all()), f"{name}: served RIRs do not decay "
                f"(min {drop.min()} dB)")
        serve_times = []
        for _ in range(3):
            t0 = time.perf_counter()
            serve_all()
            torch.cuda.synchronize()
            serve_times.append(time.perf_counter() - t0)
        amps_k = get_output_from_trained_model(cfg, room, rec, finest, device=DEVICE)
        amps_c = get_output_from_trained_model(cfg, room, rec, finest, device="cpu")
        amp_err = rel_err(amps_k.cpu(), amps_c)
        require(amp_err <= SPATIAL_AMP_TOL, f"{name}: served amplitudes card vs CPU {amp_err}")
        # the synthesis of NUM_RECEIVERS receivers on one noise tensor
        sub = slice(0, NUM_RECEIVERS)
        bands = list(np.atleast_1d(room.band_centre_hz))
        shape = (len(rec[sub]), len(bands), ir_len)
        kw = {}
        if cfg.use_directional_rirs:
            shape = (room.sph_directions.shape[-1],) + shape
            kw = dict(ambi_order=room.ambi_order, des_directions=room.sph_directions,
                      beamformer_type=cfg.dnn_config.beamformer_type)
        noise = torch.randn(shape, generator=torch.Generator().manual_seed(SEED))
        synth = [get_rirs_from_common_slopes_model(
            fs, rec[sub], bands, ir_len, amps[sub][..., None].to(dev),
            np.asarray(room.common_decay_times), noise=noise.to(dev), **kw).cpu()
            for amps, dev in ((amps_k, DEVICE), (amps_c, "cpu"))]
        synth_err = rel_l2(synth[0], synth[1])
        require(synth_err <= SPATIAL_SYNTH_TOL, f"{name}: synthesis card vs CPU {synth_err}")
        per_res.update(
            served_shape=list(out.rirs.shape),
            served_rirs_per_s=room.num_rec / float(np.median(serve_times)),
            serve_s=serve_times, amplitudes_max_rel_card_vs_cpu=amp_err,
            synthesis_rel_l2_card_vs_cpu=synth_err)
        result[name] = per_res
        del out
    return result


# the kernels of a step whose rows slice_rows makes, in its order
SLICE_KERNELS = ("cinv", "neg_ptgpt", "sos", "sos_backward")

# phase 10: single-RIR fits and the colorless prototype warm start, through
# the CLI, each preset in a working directory holding its wav at its ir_path
SINGLE_RIR_PRESETS = ("single_rir_example", "single_rir_two_stage_colorless_proto",
                      "single_rir_single_room_colorless_proto")
SINGLE_RIR_OFF_PATH = ("lu", "lut_apply", "tdgfdn")
WARM_START_TOL = 1e-4  # warm-started feedback blocks vs the prototypes' matrices


def two_slope_rir(fs: float, seconds: float = 1.2) -> np.ndarray:
    """A direct impulse and noise under two exponential decays (T60 0.4 and
    1.0 s), peak 0.9, seeded."""
    rng = np.random.RandomState(SEED)
    t = np.arange(int(seconds * fs)) / fs
    rir = rng.randn(t.size) * (np.exp(-6.9 * t / 0.4) + 0.3 * np.exp(-6.9 * t / 1.0))
    rir[0] = 5.0
    return (0.9 * rir / np.abs(rir).max()).astype(np.float32)


def colorless_counts(cfg, nfft: int):
    """(optimizer steps, validation batches) per epoch of a prototype on nfft / 16 bins,
    as ``ColorlessFDNTrainer.fit`` splits them."""
    ccfg = cfg.colorless_fdn_config
    nbins = nfft // 16
    n_train = int(nbins * ccfg.train_valid_split)
    n_valid = nbins - n_train
    vbs = min(ccfg.batch_size, max(1, n_valid))
    return n_train // min(ccfg.batch_size, n_train), (max(1, n_valid // vbs) if n_valid else 0)


def slice_rows(label: str, inputs: dict, launches: dict) -> list:
    """Rows of B1 and B2 (bit for bit) and B3 and B4 (within KERNEL_TOL)
    against their plain versions at the inputs one step gave them (those it
    launched, in the order of SLICE_KERNELS), timed beside their bounds,
    plain versions and library calls."""
    import torch

    from diffgfdn_torch.kernels import sos as sos_mod
    from diffgfdn_torch.kernels.cinv import cinv, neg_ptgpt
    from diffgfdn_torch.kernels.dispatch import plain_versions

    def both(fn, *args):
        out = fn(*args)
        with plain_versions():
            ref = fn(*args)
        torch.cuda.synchronize()
        return out, ref

    def plain(fn, *args):
        with plain_versions():
            return fn(*args)

    rows, differ, errs = [], {}, {}
    if "cinv" in inputs:
        (m,) = inputs["cinv"]
        out, ref = both(cinv, m)
        differ["cinv"] = int((out != ref).sum())
        rows.append(timed_row(
            f"cinv [{label}]", "cinv.cu", "diffgfdn_tpu/kernels/pallas_cinv.py:34",
            launches.get("cinv", 0), float(torch.max(torch.abs(out - ref))), lambda: cinv(m),
            lambda: plain(cinv, m), lambda: cinv(m), cinv_cost(m.shape[0], m.shape[1]),
            lambda: torch.linalg.inv(m), m.shape))
    if "neg_ptgpt" in inputs:
        p, g = inputs["neg_ptgpt"]
        out, ref = both(neg_ptgpt, p, g)
        differ["neg_ptgpt"] = int((out != ref).sum())
        rows.append(timed_row(
            f"neg_ptgpt [{label}]", "cinv.cu", "diffgfdn_tpu/kernels/pallas_cinv.py:146",
            launches.get("neg_ptgpt", 0), float(torch.max(torch.abs(out - ref))),
            lambda: neg_ptgpt(p, g), lambda: plain(neg_ptgpt, p, g), lambda: neg_ptgpt(p, g),
            neg_ptgpt_cost(p.shape[0], p.shape[1]), lambda: -(p.mH @ g @ p.mH), p.shape))
    if "sos" in inputs:
        num, den, w = inputs["sos"]
        out, ref = both(sos_mod.sos_cascade, num, den, w)
        errs["sos"] = rel_err(out, ref)
        rows.append(timed_row(
            f"sos_cascade_response [{label}]", "sos.cu", "diffgfdn_tpu/kernels/pallas_sos.py:47",
            launches.get("sos", 0), float(torch.max(torch.abs(out - ref))),
            lambda: sos_mod.sos_cascade(num, den, w),
            lambda: plain(sos_mod.sos_cascade, num, den, w),
            lambda: sos_mod.sos_cascade(num, den, w),
            sos_cost(num.shape[0], num.shape[1], w.shape[0]), None, num.shape))
    if "sos_backward" in inputs:
        bn, bd, bw, bg, bh = inputs["sos_backward"]
        (dn, dd), (dn_p, dd_p) = both(sos_mod.sos_cascade_backward, bn, bd, bw, bg, bh)
        errs["sos_backward"] = max(rel_err(dn, dn_p), rel_err(dd, dd_p))
        rows.append(timed_row(
            f"sos_cascade_backward [{label}]", "sos.cu", "diffgfdn_tpu/kernels/pallas_sos.py:64",
            launches.get("sos_backward", 0),
            float(max(torch.max(torch.abs(dn - dn_p)), torch.max(torch.abs(dd - dd_p)))),
            lambda: sos_mod.sos_cascade_backward(bn, bd, bw, bg, bh),
            lambda: plain(sos_mod.sos_cascade_backward, bn, bd, bw, bg, bh),
            lambda: sos_mod.sos_cascade_backward(bn, bd, bw, bg, bh),
            sos_backward_saved_h_cost(bn.shape[0], bn.shape[1], bw.shape[0]), None, bn.shape))
    print(f"kernels, {label}: { {r['name']: r['shape'] for r in rows} }; elements "
          f"differing from plain {differ}; B3 / B4 rel err {errs}")
    require(all(v == 0 for v in differ.values()) and all(v <= KERNEL_TOL for v in errs.values()),
            f"{label}: kernels vs plain: B1 / B2 differ in {differ}, B3 / B4 {errs}")
    return rows


def single_rir_rows(name: str, inputs: dict, colorless_inputs: dict, per_epoch: dict,
                    launches: dict) -> list:
    """Phase 10, kernels: :func:`slice_rows` at the inputs one GFDN step and
    one colorless step of the preset gave them, each row with its launches
    per epoch (``per_epoch``, keyed by kernel and " colorless"). The single
    room's one SVF head (R = 1) gets no B3 / B4 row."""
    if inputs["sos"][0].shape[0] == 1:
        inputs = {k: v for k, v in inputs.items() if k not in ("sos", "sos_backward")}
    rows = []
    for label, rec in (("", inputs), (" colorless", colorless_inputs)):
        if not rec:
            continue
        keys = [k for k in SLICE_KERNELS if k in rec]
        for key, row in zip(keys, slice_rows(f"{name}{label}", rec, launches)):
            row["launches_per_epoch"] = per_epoch[key + label]
            rows.append(row)
    return rows


def kernel_step(step) -> tuple:
    """One loss-and-backward ``step()`` (returning the loss) on the kernels,
    keeping each kernel's inputs, then on the plain versions: (relative loss
    error, worst gradient's relative L2 error, kernel inputs)."""
    import torch

    from diffgfdn_torch.kernels.dispatch import plain_versions

    inputs = {}
    with recording_kernel_inputs(inputs, forward=True):
        loss_k, params = step()
    grads_k = [p.grad.clone() for p in params]
    with plain_versions():
        loss_p, params = step()
    grads_p = [p.grad.clone() for p in params]
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_err = max(rel_l2(a, b) for a, b in zip(grads_k, grads_p))
    torch.cuda.synchronize()
    return loss_rel, grad_err, inputs


def single_rir(tmp: Path, log_dir):
    """Phase 10: the single-RIR presets fit through the CLI at full width, the
    prototypes' warm start, the kernels of their path against their plain
    versions. Returns (results, kernel rows)."""
    import torch
    from scipy.io import loadmat

    from diffgfdn_torch.cli import run_model
    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.data import RIRData, ThreeRoomDataset, write_wav
    from diffgfdn_torch.ops.unitary import orthogonal_from_skew
    from diffgfdn_torch.training import (
        build_colorless_fdn,
        build_gfdn_model,
        ColorlessFDNTrainer,
        load_checkpoint,
        load_colorless_fdn_params,
        make_optimizer,
        SinglePosGFDNTrainer,
    )
    from diffgfdn_torch.training.optim import make_single_lr_optimizer, STEP_SIZE_EPOCHS
    from diffgfdn_torch.training.solver import single_pos_batch
    from diffgfdn_torch.utils.params import load_jax_params

    results, rows = [], []
    for name in SINGLE_RIR_PRESETS:
        cfg = preset_config(name)
        tc, ccfg = cfg.trainer_config, cfg.colorless_fdn_config
        work = tmp / "single_rir" / name
        wav = work / cfg.ir_path
        wav.parent.mkdir(parents=True, exist_ok=True)
        if name == "single_rir_example":  # a receiver of phase 2's dataset, at 32 kHz
            rir = ThreeRoomDataset(tmp / "three_room_example" / "srirs.pkl").rirs32[0]
        else:
            rir = two_slope_rir(cfg.sample_rate)
        write_wav(wav, rir, cfg.sample_rate)
        cdt = np.array([0.5] * cfg.num_groups)
        data = RIRData.from_wav(wav, common_decay_times=cdt, nfft=tc.num_freq_bins)
        nfft = data.num_freq_bins

        # the main path: the CLI, as a user fits the preset
        with contextlib.chdir(work):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            run_model.main(["-c", name, "--device", DEVICE])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = launch_counts()
            peak_run = torch.cuda.max_memory_allocated()
            protos = (load_colorless_fdn_params(cfg) if ccfg.use_colorless_prototype
                      else None)
        train_dir = work / tc.train_dir
        losses = loadmat(str(train_dir / "losses.mat"))["train_loss"].reshape(-1)
        epochs = losses.size
        require(0 < epochs <= tc.max_epochs and bool(np.isfinite(losses).all()),
                f"{name}: training losses {losses}")

        # every kernel of the path launched, exactly as often as the path runs it
        model = build_gfdn_model(cfg, cdt, variant="single_pos", device=DEVICE,
                                 colorless_params=protos)
        svf_sides = int(model.use_svf_in_output) + int(model.use_svf_in_input)
        steps_c, valid_c = colorless_counts(cfg, nfft) if protos else (0, 0)
        groups_c = cfg.num_groups * ccfg.max_epochs if protos else 0
        both_scalar = svf_sides == 0
        expected = {
            "cinv": epochs + (0 if protos else 1) + int(both_scalar)
            + (cfg.num_groups + groups_c * (steps_c + valid_c) if protos else 0),
            "neg_ptgpt": epochs + groups_c * steps_c,
            "sos": epochs * svf_sides, "sos_backward": epochs * svf_sides,
            **{k: 0 for k in SINGLE_RIR_OFF_PATH},
        }
        require({k: launches[k] for k in expected} == expected,
                f"{name}: launches {launches}, expected {expected}")

        # the last checkpoint and the prototypes read back; the warm start is exact
        load_jax_params(model, load_checkpoint(train_dir, epochs - 1))
        params = loadmat(str(train_dir / "parameters_opt.mat"))
        with torch.no_grad():
            a = model.feedback_loop.coupled_feedback_matrix().cpu().numpy()
        require(np.array_equal(params["coupled_feedback_matrix"], a),
                f"{name}: the exported feedback matrix is not the checkpoint's")
        warm_err = None
        if protos:
            m0 = torch.from_numpy(load_checkpoint(train_dir, -1)["params"]["feedback_loop"]["M"])
            blocks = orthogonal_from_skew(m0).numpy()
            warm_err = max(float(np.abs(blocks[g] - p.opt_feedback_matrix).max())
                           for g, p in enumerate(protos))
            gains_equal = all(np.array_equal(
                model.input_gains[g * model.num_delay_lines_per_group:
                                  (g + 1) * model.num_delay_lines_per_group, 0].cpu().numpy(),
                np.asarray(p.opt_input_gains, np.float32)) for g, p in enumerate(protos))
            require(warm_err <= WARM_START_TOL and gains_equal and model.io_gains_fixed,
                    f"{name}: warm start vs prototypes {warm_err}, io gains fixed "
                    f"{model.io_gains_fixed}, equal {gains_equal}")

        # one step on the kernels and on the plain versions, at the trained parameters
        trainer = SinglePosGFDNTrainer(model, tc, 1, common_decay_times=cdt,
                                       sample_rate=cfg.sample_rate, device=DEVICE)
        trainer.optimizer, trainer.scheduler = make_optimizer(tc, model, 1)
        trainer.upload_batch(single_pos_batch(cfg, data))

        def gfdn_step():
            loss, _ = trainer.loss_and_grads(trainer.data)
            return loss, [p for p in model.parameters()]

        loss_rel, grad_err, inputs = kernel_step(gfdn_step)
        require(loss_rel <= LOSS_TOL and grad_err <= GRAD_TOL,
                f"{name}: step kernels vs plain: loss {loss_rel}, gradient {grad_err}")
        colorless = {}
        per_epoch = {"cinv": 1, "neg_ptgpt": 1, "sos": svf_sides, "sos_backward": svf_sides}
        if protos:
            cmodel = build_colorless_fdn(cfg, 0, device=DEVICE)
            load_jax_params(cmodel, load_checkpoint(work / tc.train_dir / "colorless-fdn"
                                                    / "group0", ccfg.max_epochs - 1))
            ctrainer = ColorlessFDNTrainer(cmodel, ccfg, str(tmp / "single_rir" / "scratch"),
                                           use_asym_loss=tc.use_asym_spectral_loss,
                                           device=DEVICE)
            nbins = nfft // 16
            angles = torch.as_tensor(np.arange(nbins) / nbins * np.pi, dtype=torch.float32,
                                     device=DEVICE)
            rng = np.random.RandomState(cfg.seed)
            train_idx = rng.permutation(nbins)[:int(nbins * ccfg.train_valid_split)]
            first = torch.as_tensor(rng.permutation(train_idx)[:min(ccfg.batch_size,
                                                                    len(train_idx))],
                                    device=DEVICE)

            def colorless_step():
                for p in cmodel.parameters():
                    p.grad = None
                loss = ctrainer.loss(angles[first])
                loss.backward()
                return loss.detach(), list(cmodel.parameters())

            c_loss_rel, c_grad_err, colorless = kernel_step(colorless_step)
            require(c_loss_rel <= LOSS_TOL and c_grad_err <= GRAD_TOL,
                    f"{name}: colorless step kernels vs plain: loss {c_loss_rel}, "
                    f"gradient {c_grad_err}")
            per_epoch.update({"cinv colorless": cfg.num_groups * (steps_c + valid_c),
                              "neg_ptgpt colorless": cfg.num_groups * steps_c})
        rows += single_rir_rows(name, inputs, colorless, per_epoch, launches)
        del inputs, colorless

        # the step graphed and eagerly: agreement, times in turns, no sync
        graph = graphed_vs_eager(name, trainer, dict(model.named_parameters()),
                                 lambda: trainer.fit_step()[0], log_dir, trainer.mask_generator)
        profiled = {}
        if log_dir is not None:
            trainer.scan_epochs = False
            wall, busy, ours, _ = profile_once(trainer.fit_step, f"single_rir_step_{name}",
                                               Path(log_dir) / f"profile_train_{name}.txt")
            trainer.scan_epochs = True
            profiled = {"eager_profiled_step_ms": wall, "eager_profiled_device_busy_ms": busy,
                        "eager_profiled_kernels_ms": ours,
                        "eager_profiled_idle_share": 1.0 - busy / wall}
        if protos:  # a prototype step graphed and eagerly, at the prototype's parameters
            ctrainer.angles = angles
            ctrainer.optimizer, ctrainer.scheduler = make_single_lr_optimizer(
                cmodel, ccfg.lr, steps_c, STEP_SIZE_EPOCHS)
            cgraph = graphed_vs_eager(f"{name}_colorless", ctrainer,
                                      dict(cmodel.named_parameters()),
                                      lambda: ctrainer.fit_step(first), log_dir)
            profiled.update({f"colorless_{k}": v for k, v in cgraph.items()})
        colorless_epoch = {}
        if protos:  # one prototype epoch as the fit runs it: normalization, steps, validation
            one = dataclasses.replace(ccfg, max_epochs=1)
            c1 = ColorlessFDNTrainer(build_colorless_fdn(cfg, 0, device=DEVICE), one,
                                     str(tmp / "single_rir" / "scratch"), device=DEVICE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c1.fit(nfft // 16, seed=cfg.seed)
            torch.cuda.synchronize()
            colorless_epoch = {"colorless_epoch_s": time.perf_counter() - t0,
                               "colorless_step_loss_rel_vs_plain": c_loss_rel,
                               "colorless_max_grad_rel_l2_vs_plain": c_grad_err}
        results.append({
            "preset": name, "fs": cfg.sample_rate, "nfft": nfft, "bins": nfft // 2 + 1,
            "delay_lines": len(cfg.delay_length_samps), "groups": cfg.num_groups,
            "prototype_bins": nfft // 16 if protos else None, "epochs": epochs,
            "run_s": run_s, "first_loss": float(losses[0]), "last_loss": float(losses[-1]),
            "launches": {k: launches[k] for k in expected},
            "warm_start_max_abs_vs_prototypes": warm_err,
            "step_loss_rel_vs_plain": loss_rel, "max_grad_rel_l2_vs_plain": grad_err,
            **graph, **colorless_epoch, "peak_mem_run_mb": peak_run / 2 ** 20, **profiled,
        })
        del trainer, model
    return results, rows

# phase 11: the floor-plan CNN preset through the spatial CLI, and the
# directional octave-band merge of the eight directional band presets
SPATIAL_CNN_PRESET = "spatial_directional_1000Hz_cnn"
# the CNN's full grids of phase 8's receivers at the preset's resolutions
# (rows = distinct y, columns = distinct x of the resolution's training receivers)
SPATIAL_CNN_MESHES = {0.9: (21, 17), 0.6: (31, 24), 0.3: (61, 45)}
SPATIAL_CNN_CPU_RES = 0.9  # the resolution of the card-vs-CPU step
MERGE_BANDS = (63, 125, 250, 500, 1000, 2000, 4000, 8000)
MERGE_EPOCHS = 1


def spatial_cnn(tmp: Path, log_dir):
    """Phase 11 (a): the floor-plan CNN preset trained through the spatial
    CLI at full width, its steps held graphed against eager and card against
    CPU, every receiver served from its 0.3 m checkpoint.

    ``spatial_directional_1000Hz_cnn`` (4 convolutions of 3 x 3 and 32
    channels, 10 Fourier features, lr 1e-3, 15 epochs of one full-grid step,
    the max-directivity beamformer, ambi order 2, 12 directions) runs as
    ``python -m diffgfdn_torch.cli.run_spatial_sampling -c <preset>`` does, in
    a working directory that holds phase 8's synthetic grid at the preset's
    ``room_dataset_path`` (0.3 m, 847 receivers, 0.5 s SRIRs at 32 kHz,
    decays 1.2 / 2.2 / 1.6 s, so the EDC envelopes are 70400 samples): at
    0.9, 0.6 and 0.3 m, grids of 21 x 17, 31 x 24 and 61 x 45 cells. No
    hand-written kernel lies on this path: every launch count must stay 0.
    """
    import torch

    from diffgfdn_torch.cli import run_spatial_sampling
    from diffgfdn_torch.config import spatial_preset_config
    from diffgfdn_torch.data import (
        generate_spatial_three_room_pickle,
        SpatialThreeRoomDataset,
        split_by_grid_resolution,
    )
    from diffgfdn_torch.inference import get_ambisonic_rirs, get_output_from_trained_model
    from diffgfdn_torch.training import build_spatial_model, make_cnn_batch, SpatialSamplingTrainer
    from diffgfdn_torch.utils.params import jax_params_from_torch, load_jax_params

    path = tmp / "directional" / "srirs.pkl"
    if not path.exists():
        generate_spatial_three_room_pickle(
            path, fs=SPATIAL_FS, grid_spacing_m=DIRECTIONAL_GRID_M, rir_len_s=DIRECTIONAL_RIR_S,
            decay_times=DIRECTIONAL_DECAYS, seed=SEED)
    work = tmp / "spatial_cnn"
    cfg = spatial_preset_config(SPATIAL_CNN_PRESET)
    data = work / cfg.room_dataset_path
    data.parent.mkdir(parents=True, exist_ok=True)
    data.symlink_to(path)
    cfg = spatial_preset_config(SPATIAL_CNN_PRESET, train_dir=str(work / cfg.train_dir))
    room = SpatialThreeRoomDataset(path)
    rec = room.receiver_position

    # the main path: the CLI, as a user trains the preset
    with contextlib.chdir(work):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        trained = run_spatial_sampling.main(["-c", SPATIAL_CNN_PRESET, "--device", DEVICE])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    require(all(v == 0 for v in launch_counts().values()),
            f"{SPATIAL_CNN_PRESET}: hand-written kernels launched {launch_counts()}")
    require(sorted(round(r, 1) for r in trained) == sorted(SPATIAL_CNN_MESHES),
            f"{SPATIAL_CNN_PRESET}: resolutions {sorted(trained)}")
    result = {"preset": SPATIAL_CNN_PRESET, "epochs": cfg.max_epochs, "run_s": run_s,
              "peak_mem_run_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
              "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
              "cudnn_benchmark": torch.backends.cudnn.benchmark}
    require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cudnn.benchmark,
            f"{SPATIAL_CNN_PRESET}: cuDNN TF32 {torch.backends.cudnn.allow_tf32}, benchmark "
            f"{torch.backends.cudnn.benchmark}")
    for res, (trainer, model) in sorted(trained.items(), reverse=True):
        losses = trainer.train_loss
        require(len(losses) == cfg.max_epochs and bool(np.isfinite(losses).all())
                and losses[-1] < losses[0], f"CNN at {res:.1f} m: losses {losses}")
        train_idx, _ = split_by_grid_resolution(room, res)
        batch = trainer.to_device(make_cnn_batch(room, train_idx))
        shape = tuple(batch["mesh_2d"].shape[:2])
        require(shape == SPATIAL_CNN_MESHES[round(res, 1)], f"CNN at {res:.1f} m: mesh {shape}")
        row = {"train": len(train_idx), "mesh": list(shape), "cells": shape[0] * shape[1],
               "epoch_s": float(np.median(trainer.epoch_s)), "epoch_s_all": trainer.epoch_s,
               "train_loss": [losses[0], losses[-1]]}
        if round(res, 1) == SPATIAL_CNN_CPU_RES:
            # one step on the card and on the CPU from the same parameters and grid
            cpu_model = build_spatial_model(cfg, room.num_rooms, room.ambi_order, device="cpu")
            load_jax_params(cpu_model, jax_params_from_torch(model))
            cpu = SpatialSamplingTrainer(cpu_model, cfg, room, device="cpu")
            loss_k = trainer.loss_and_grads(batch)
            loss_c = cpu.loss_and_grads(cpu.to_device(make_cnn_batch(room, train_idx)))
            loss_rel = abs(float(loss_k) - float(loss_c)) / abs(float(loss_c))
            grad_errs = {n: rel_l2(p.grad.cpu(), q.grad) for (n, p), q in
                         zip(model.named_parameters(), cpu_model.parameters())}
            worst = max(grad_errs, key=grad_errs.get)
            require(loss_rel <= SPATIAL_STEP_LOSS_TOL,
                    f"CNN at {res:.1f} m: step loss card vs CPU {loss_rel}")
            require(grad_errs[worst] <= GRAD_TOL,
                    f"CNN at {res:.1f} m: gradient of {worst} card vs CPU {grad_errs[worst]}")
            row.update(step_loss_rel_card_vs_cpu=loss_rel,
                       max_grad_rel_l2_card_vs_cpu=grad_errs[worst])
            del cpu, cpu_model
        # the step graphed and eagerly: agreement, times in turns, no sync
        resident = torch.cuda.memory_allocated()
        row.update(graphed_vs_eager(f"spatial_cnn_{res:.1f}m", trainer,
                                    dict(model.named_parameters()),
                                    lambda: trainer.fit_batch(batch), log_dir))
        row["resident_mem_mb"] = resident / 2 ** 20
        result[f"{res:.1f}"] = row
        trainer.graphs.clear()
        del trainer, model, batch
        torch.cuda.empty_cache()
    del trained

    # serving every receiver from the 0.3 m checkpoint
    finest = min(SPATIAL_CNN_MESHES)

    def serve_all():
        return get_ambisonic_rirs(rec, room, use_trained_model=True, configs=[cfg],
                                  grid_resolution_m=finest, seed=SEED, device=DEVICE)

    reset_counts()
    out = serve_all()
    require(all(v == 0 for v in launch_counts().values()),
            f"CNN serving: hand-written kernels launched {launch_counts()}")
    want = (room.num_rec, (room.ambi_order + 1) ** 2, room.rir_length)
    require(out.rirs.shape == want and bool(np.isfinite(out.rirs).all()),
            f"CNN: served {out.rirs.shape}, finite {np.isfinite(out.rirs).all()}")
    edc = edc_db(out.rirs[:, 0])
    fs = room.sample_rate
    drop = edc[:, int(0.05 * fs)] - edc[:, int(0.45 * fs)]
    require(bool((drop > 3.0).all()), f"CNN: served SRIRs do not decay (min {drop.min()} dB)")
    serve_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        serve_all()
        torch.cuda.synchronize()
        serve_times.append(time.perf_counter() - t0)
    amps_k = get_output_from_trained_model(cfg, room, rec, finest, device=DEVICE)
    amps_c = get_output_from_trained_model(cfg, room, rec, finest, device="cpu")
    amp_err = rel_err(amps_k.cpu(), amps_c)
    require(amp_err <= SPATIAL_AMP_TOL, f"CNN: served amplitudes card vs CPU {amp_err}")
    result.update(served_shape=list(out.rirs.shape),
                  served_srirs_per_s=room.num_rec / float(np.median(serve_times)),
                  serve_s=serve_times, amplitudes_max_rel_card_vs_cpu=amp_err)
    return result


# the directional EDC loss at a directional MLP batch and at the CNN's 0.3 m
# grid (receivers or cells); 12 directions, phase 8's decays: T = 70400
EDC_LOSS_ROWS = {"mlp_batch": 50, "cnn_0.3m": 2745}
EDC_LOSS_DIRECTIONS = 12
EDC_LOSS_TIMED = 20


def edc_loss_check() -> dict:
    """The directional EDC loss of the common-slopes trainers (port
    ``losses/spatial.py``: a chunked forward that keeps each element's
    derivative, a backward of one contraction) against autograd through
    ``db``, the loss as JAX writes it, on seeded amplitudes at
    ``EDC_LOSS_ROWS``. For each way and shape, one step (the loss and its
    backward) runs eagerly, then through a ``training/scan.py`` StepGraph (a
    warm-up step, the capture, replays), the cache emptied before each: the
    median of ``EDC_LOSS_TIMED`` synchronized steps and the peak memory
    allocated above what was resident. The two ways' losses and gradients
    are compared. Autograd's graphed step at the 0.3 m grid runs last, and
    an out-of-memory error there is its printed result."""
    import gc

    import torch

    from diffgfdn_torch.losses import make_decay_envelopes, spatial_edc_loss
    from diffgfdn_torch.ops.basic import db
    from diffgfdn_torch.training.scan import StepGraph

    def autograd_loss(pred, target, env):
        return torch.mean(torch.abs(
            db(torch.einsum("bjk,kt->bjt", target, env), is_squared=True)
            - db(torch.einsum("bjk,kt->bjt", pred, env), is_squared=True)))

    dev = torch.device(DEVICE)
    edc_len = int(max(DIRECTIONAL_DECAYS) * SPATIAL_FS)
    env = make_decay_envelopes(np.asarray(DIRECTIONAL_DECAYS), edc_len, SPATIAL_FS).to(dev)
    rng = np.random.RandomState(SEED)
    ways = {"port": spatial_edc_loss, "autograd": autograd_loss}
    out = {"edc_len": edc_len, "directions": EDC_LOSS_DIRECTIONS}
    for label, rows in EDC_LOSS_ROWS.items():
        shape = (rows, EDC_LOSS_DIRECTIONS, len(DIRECTIONAL_DECAYS))
        target = rng.lognormal(-2.0, 1.0, shape).astype(np.float32)
        pred = target * rng.lognormal(0.0, 0.3, shape).astype(np.float32)
        target = torch.as_tensor(target, device=dev)
        row, grads = {"rows": rows}, {}
        for name, fn in ways.items():
            amps = torch.as_tensor(pred, device=dev).requires_grad_(True)

            def step(inputs, fn=fn, amps=amps):
                amps.grad = None
                loss = fn(amps, inputs["target"], env)
                loss.backward()
                return loss.detach()

            for graphed in (False, True):
                key = f"{name}_{'graphed' if graphed else 'eager'}"
                if graphed and name == "autograd" and label == "cnn_0.3m":
                    continue  # last, below
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                run = StepGraph(step, dev) if graphed else (lambda target: step({"target": target}))
                loss = run(target=target)
                times = []
                for _ in range(EDC_LOSS_TIMED):
                    t0 = time.perf_counter()
                    loss = run(target=target)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                require(bool(torch.isfinite(loss)), f"EDC loss {key} at {label}: {loss}")
                row[key] = {"ms": float(np.median(times)) * 1e3,
                            "peak_mb": (torch.cuda.max_memory_allocated() - resident) / 2 ** 20,
                            "loss": float(loss)}
                grads[key] = amps.grad.detach().clone()
                del run, loss
            del amps
        ref = grads["autograd_eager"]
        row["port_vs_autograd_loss_rel"] = abs(row["port_eager"]["loss"]
                                              - row["autograd_eager"]["loss"]) \
            / abs(row["autograd_eager"]["loss"])
        row["port_vs_autograd_grad_rel_l2"] = {k: rel_l2(g, ref) for k, g in grads.items()
                                               if k != "autograd_eager"}
        require(row["port_vs_autograd_loss_rel"] <= 1e-5
                and max(row["port_vs_autograd_grad_rel_l2"].values()) <= 1e-4,
                f"EDC loss at {label}: port against autograd {row}")
        out[label] = row
        del grads, ref
    # autograd's graphed step at the 0.3 m grid: the warm-up's tensors stay
    # cached beside the capture's pool
    rows = EDC_LOSS_ROWS["cnn_0.3m"]
    shape = (rows, EDC_LOSS_DIRECTIONS, len(DIRECTIONAL_DECAYS))
    amps = torch.ones(shape, device=dev, requires_grad=True)
    target = torch.full(shape, 0.5, device=dev)

    def big_step(inputs):
        amps.grad = None
        loss = autograd_loss(amps, inputs["target"], env)
        loss.backward()
        return loss.detach()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    graph = StepGraph(big_step, dev)
    try:
        graph(target=target)
        graph(target=target)
        torch.cuda.synchronize()
        result = {"peak_mb": (torch.cuda.max_memory_allocated() - resident) / 2 ** 20}
    except torch.cuda.OutOfMemoryError as exc:
        result = {"out_of_memory": str(exc).split("\n")[0][:400],
                  "peak_mb_before": (torch.cuda.max_memory_allocated() - resident) / 2 ** 20}
    out["cnn_0.3m"]["autograd_graphed"] = result
    return out


def directional_merge(tmp: Path):
    """Phase 11 (b): the eight directional band presets trained for one epoch
    each through the directional solver on phase 8's grid, then merged into
    broadband SRIRs through ``infer_all_octave_bands(variant="directional")``.
    Returns (result, B5's kernel row at the merge path's inputs)."""
    import torch

    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.data import generate_spatial_three_room_pickle, SpatialThreeRoomDataset
    from diffgfdn_torch.inference import (
        band_reconstruction_filters,
        infer_all_octave_bands,
        infer_all_octave_bands_directional,
        InferDiffGFDN,
        merge_subband_rirs,
    )
    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.kernels.lu import lu_solve
    from diffgfdn_torch.training import run_training_anisotropic_decay_var_receiver_pos

    path = tmp / "directional" / "srirs.pkl"
    if not path.exists():
        generate_spatial_three_room_pickle(
            path, fs=SPATIAL_FS, grid_spacing_m=DIRECTIONAL_GRID_M, rir_len_s=DIRECTIONAL_RIR_S,
            decay_times=DIRECTIONAL_DECAYS, seed=SEED)
    room = SpatialThreeRoomDataset(path)
    configs, train_s = [], []
    for band in MERGE_BANDS:
        cfg = preset_config(f"directional_{band}Hz_res0.6m")
        cfg.trainer_config.train_dir = str(tmp / "merge" / f"{band}Hz")
        cfg.trainer_config.max_epochs = MERGE_EPOCHS
        t0 = time.perf_counter()
        trainer, _ = run_training_anisotropic_decay_var_receiver_pos(cfg, room, device=DEVICE)
        torch.cuda.synchronize()
        train_s.append(time.perf_counter() - t0)
        require(bool(np.isfinite(trainer.train_loss + trainer.valid_loss).all()),
                f"merge, {band} Hz band: losses {trainer.train_loss} {trainer.valid_loss}")
        configs.append(cfg)
        del trainer
    rec = np.arange(NUM_RECEIVERS)
    nfft = room.num_freq_bins
    n_ch = (room.ambi_order + 1) ** 2

    # the main path: the entry point a user calls
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    merged = infer_all_octave_bands(configs, room, rec, variant="directional", device=DEVICE)
    call_s = time.perf_counter() - t0
    launches = launch_counts()
    batches = len(MERGE_BANDS) * -(-NUM_RECEIVERS // BATCH)
    require(launches == {**{k: 0 for k in launches}, "lu": batches},
            f"merge: launches {launches}, expected B5 {batches} times and nothing else")
    require(merged.shape == (NUM_RECEIVERS, n_ch, nfft) and bool(np.isfinite(merged).all()),
            f"merge: {merged.shape}, finite {np.isfinite(merged).all()}")
    with plain_versions():
        plain = infer_all_octave_bands(configs, room, rec, variant="directional", device=DEVICE)
    half_s = int(0.5 * room.sample_rate)
    merge_rel = rel_l2(torch.from_numpy(merged), torch.from_numpy(plain))
    edc = edc_db(merged)
    merge_edc = float(np.abs(edc - edc_db(plain))[..., :half_s].max())
    require(merge_rel <= RIR_TOL and merge_edc <= EDC_TOL_DB,
            f"merge vs plain: rel L2 {merge_rel}, EDC {merge_edc} dB")
    drop = edc[:, 0, int(0.05 * room.sample_rate)] - edc[:, 0, half_s]
    require(bool((drop > 3.0).all()), f"merge: SRIRs do not decay (min {drop.min()} dB)")
    del plain, edc
    try:
        infer_all_octave_bands_directional(configs, room, rec[:1], convert_to_ambisonics=True,
                                           device=DEVICE)
    except ValueError:
        pass
    else:
        require(False, "merge: convert_to_ambisonics=True did not raise (ROADMAP C12)")

    # the same merge, each band's serving timed alone: SRIRs/s per band, and
    # the host merge's time is the call's time less the bands' build and serve
    serve_s, build_s = [], []

    def timed_bands():
        for cfg in configs:
            t0 = time.perf_counter()
            infer = InferDiffGFDN(cfg, room, variant="directional", device=DEVICE)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rirs = infer.rirs_at(rec, BATCH)
            serve_s.append(time.perf_counter() - t1)
            build_s.append(t1 - t0)
            yield rirs

    filters = band_reconstruction_filters(configs, room.sample_rate, 2 ** 12)
    t0 = time.perf_counter()
    again = merge_subband_rirs(timed_bands(), filters)
    total_s = time.perf_counter() - t0
    require(np.array_equal(again, merged), "merge: a second run differs from the first")
    del again

    # B5 at the merge path's inputs: one served batch of the last band
    infer = InferDiffGFDN(configs[-1], room, variant="directional", device=DEVICE)
    inputs = {}
    with recording_kernel_inputs(inputs):
        infer.rirs_at(rec[:BATCH], BATCH)
    m5, b5 = inputs["lu"]
    (x, lu, piv) = lu_solve(m5, b5)
    with plain_versions():
        (x_p, lu_p, piv_p) = lu_solve(m5, b5)
    torch.cuda.synchronize()
    differ = [int((o != r).sum()) for o, r in ((x, x_p), (lu, lu_p), (piv, piv_p))]
    require(differ == [0, 0, 0], f"merge: B5 vs plain differs in {differ} elements")

    def plain_call():
        with plain_versions():
            return lu_solve(m5, b5)

    row = timed_row("lu_solve [directional merge]", "lu.cu",
                    "diffgfdn_tpu/kernels/pallas_lu.py:46", launches["lu"],
                    float(torch.max(torch.abs(x - x_p))), lambda: lu_solve(m5, b5), plain_call,
                    lambda: lu_solve(m5, b5), lu_cost(m5.shape[0], m5.shape[1]),
                    lambda: torch.linalg.solve(m5, b5.unsqueeze(-1)), m5.shape)
    result = {
        "bands": list(MERGE_BANDS), "receivers": NUM_RECEIVERS, "nfft": nfft,
        "epochs": MERGE_EPOCHS, "train_s": train_s, "shape": list(merged.shape),
        "launches": {"lu": launches["lu"]}, "call_s": call_s,
        "rel_l2_vs_plain": merge_rel, "edc_max_abs_db_vs_plain": merge_edc,
        "served_srirs_per_s": [NUM_RECEIVERS / t for t in serve_s],
        "serve_s": serve_s, "build_s": build_s,
        "host_merge_s": total_s - sum(serve_s) - sum(build_s),
        "b5_shape": list(m5.shape), "b5_differ_from_plain": differ,
    }
    return result, row


# phase 12: the nine synth presets by name, synth_subband_single_room (the
# RANDOM-coupled GFDN) at full width, the MLP search through the CLI, and the
# source-and-receiver model at the full-band preset's widths
SYNTH_FS = 48000.0
SYNTH_DECAYS = (0.7, 1.1, 0.9)  # the stand-in decay time of each group
SINGLE_ROOM_PRESET = "synth_subband_single_room"
HYP_TUNING_PRESET = "synth_subband_hyp_tuning"
# the search cut to 2 trials of 1 epoch (the preset's: 50 of 2), the winner
# trained for 2 epochs (20)
HYP_TUNING_CUT = {"num_trials": 2, "trial_epochs": 1}
HYP_TUNING_EPOCHS = 2
SOURCE_RECEIVER_BASE = "fullband_grid_colorless"
SOURCE_RECEIVER_HEADS = {"scalar_scalar": False, "svf_svf": True}
# the launches of one source-and-receiver training step: both sides' SVF
# heads and the absorption cascades (B3), their gradients (B4), the blocks'
# and the sub-FDNs' inverses (B1) and their gradients (B2); scalar heads
# normalize the io gains before every step, from the sub-FDN inverse the
# colorless loss then reuses
SOURCE_RECEIVER_STEP = {
    "scalar_scalar": {"cinv": 2, "neg_ptgpt": 2, "sos": 1},
    "svf_svf": {"cinv": 2, "neg_ptgpt": 2, "sos": 3, "sos_backward": 2},
}
# ... and of one served batch: the blocks' inverse, the heads' and the
# absorption cascades
SOURCE_RECEIVER_SERVE = {"scalar_scalar": {"cinv": 1, "sos": 1},
                         "svf_svf": {"cinv": 1, "sos": 3}}
OFF_PATH = ("lu", "lut_apply", "tdgfdn")


def write_synth_pickle(path: Path, num_groups: int, geq: bool) -> Path:
    """A synthetic 3-room grid at 48 kHz (96 receivers, 2 s RIRs) whose
    common decay times are the first ``num_groups`` of SYNTH_DECAYS, per
    octave band (8 bands, scaled 1.2 .. 0.8) for GEQ absorption."""
    import pickle

    from diffgfdn_torch.data import generate_three_room_pickle

    generate_three_room_pickle(path, fs=SYNTH_FS, num_rec_per_room=NUM_RECEIVERS // 3,
                               rir_len_s=2.0, decay_times=SYNTH_DECAYS, seed=SEED)
    with open(path, "rb") as f:
        data = pickle.load(f)
    base = np.asarray(SYNTH_DECAYS[:num_groups])
    bands = len(data["band_centre_hz"])
    data["common_decay_times"] = (base[None, :] * np.linspace(1.2, 0.8, bands)[:, None]
                                  if geq else base[None, :])
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


def synth_room(tmp: Path, num_groups: int, geq: bool, nfft=None):
    """The stand-in dataset of a synth preset (:func:`write_synth_pickle`),
    written once per group count and absorption kind, read at ``nfft``."""
    from diffgfdn_torch.data import ThreeRoomDataset

    path = tmp / "synth" / f"g{num_groups}_{'geq' if geq else 'scalar'}" / "srirs.pkl"
    if not path.exists():
        write_synth_pickle(path, num_groups, geq)
    return ThreeRoomDataset(path, nfft=nfft)


def served_vs_plain(label: str, infer, idx: np.ndarray, batch_size: int, fs: float) -> dict:
    """Phases 12 and 14's serving check: ``infer.rirs_at`` over ``idx`` on the
    kernels (launches counted) and on the plain versions; finite, decaying
    RIRs (or SH-domain SRIRs) within RIR_TOL and EDC_TOL_DB over 0.5 s of
    the plain path; RIRs per second, median of 3."""
    import torch

    from diffgfdn_torch.kernels.dispatch import plain_versions

    infer.rirs_at(idx[:batch_size], batch_size)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    rirs = infer.rirs_at(idx, batch_size)
    launches = {k: v for k, v in launch_counts().items() if v}
    require(bool(np.isfinite(rirs).all()), f"{label}: non-finite RIRs")
    edc = edc_db(rirs)
    drop = edc[..., int(0.05 * fs)] - edc[..., int(1.0 * fs)]
    require(bool((drop > 10.0).all()), f"{label}: RIRs do not decay (min drop {drop.min()} dB)")
    with plain_versions():
        plain = infer.rirs_at(idx, batch_size)
    rel = float(np.linalg.norm(rirs - plain) / np.linalg.norm(plain))
    edc_err = float(np.abs(edc - edc_db(plain))[..., : int(0.5 * fs)].max())
    require(rel <= RIR_TOL and edc_err <= EDC_TOL_DB,
            f"{label}: RIRs vs plain path rel L2 {rel}, EDC {edc_err} dB")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        infer.rirs_at(idx, batch_size)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"rirs": rirs, "launches": launches, "rel_l2_vs_plain": rel,
            "edc_max_abs_db_vs_plain": edc_err,
            "rirs_per_s": len(idx) / float(np.median(times)), "serve_s": times}


def synth_presets(tmp: Path) -> list:
    """Phase 12 (a): each synth preset built by name on the card and run
    forward once at its bins on a batch of its stand-in grid."""
    import torch

    from diffgfdn_torch.config import PRESETS, preset_config
    from diffgfdn_torch.data import arrays_from_room_dataset
    from diffgfdn_torch.training import build_gfdn_model
    from diffgfdn_torch.training.trainer import upload_model_inputs

    results = []
    for name in sorted(p for p in PRESETS if p.startswith("synth_")):
        cfg = preset_config(name)
        tc = cfg.trainer_config
        room = synth_room(tmp, cfg.num_groups, cfg.decay_filter_config.use_absorption_filters,
                          tc.num_freq_bins)
        model = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz,
                                 device=DEVICE)
        data = upload_model_inputs(arrays_from_room_dataset(room), torch.device(DEVICE))
        bs = min(tc.batch_size, NUM_RECEIVERS)
        batch = {k: v if k == "z_values" else v[:bs] for k, v in data.items()}
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            h = model(batch)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        bins = room.num_freq_bins // 2 + 1
        require(tuple(h.shape) == (bs, bins) and bool(torch.isfinite(h).all()),
                f"{name}: H {tuple(h.shape)}, finite {bool(torch.isfinite(h).all())}")
        results.append({
            "preset": name, "model": type(model).__name__,
            "delay_lines": model.num_delay_lines, "groups": model.num_groups, "bins": bins,
            "batch": bs, "coupling": cfg.feedback_loop_config.coupling_matrix_type.value,
            "heads": "svf" if model.use_svf_in_output else "scalar",
            "forward_s": forward_s, "launches": {k: v for k, v in launch_counts().items() if v},
        })
        print(f"phase 12 (a): {name}: {type(model).__name__} N = {model.num_delay_lines}, "
              f"G = {model.num_groups}, {bins} bins, batch {bs}")
        del model, data, batch, h
    return results


def single_room(tmp: Path) -> tuple:
    """Phase 12 (b): ``synth_subband_single_room`` at full width (8 lines in
    one group coupled by one dense RANDOM matrix, nfft 96000, batch 10, SVF
    heads of 3 x 32, GEQ absorption). Returns (result, kernel rows)."""
    import torch

    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.data import arrays_from_room_dataset
    from diffgfdn_torch.inference import InferDiffGFDN, make_time_domain_synthesis_fn
    from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer, save_checkpoint
    from diffgfdn_torch.training.solver import steps_per_epoch
    from diffgfdn_torch.utils.params import jax_params_from_torch

    cfg = preset_config(SINGLE_ROOM_PRESET)
    tc = cfg.trainer_config
    tc.train_dir = str(tmp / "synth" / "single_room")
    bs, nfft, fs = tc.batch_size, tc.num_freq_bins, cfg.sample_rate
    room = synth_room(tmp, cfg.num_groups, True, nfft)
    seeded = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz, device=DEVICE)
    save_checkpoint(tc.train_dir, -1, jax_params_from_torch(seeded))
    infer = InferDiffGFDN(cfg, room, device=DEVICE)
    n = infer.model.num_delay_lines
    require(tuple(infer.model.feedback_loop.random_feedback_matrix.shape) == (n, n)
            and not infer.model.feedback_loop.is_block_diagonal,
            f"{SINGLE_ROOM_PRESET}: not a dense RANDOM loop")

    # serving: one dense (F, N, N) inverse (B1) and two cascades (B3: the
    # heads, the absorption) a batch
    idx = np.arange(NUM_RECEIVERS)
    served = served_vs_plain(SINGLE_ROOM_PRESET, infer, idx, bs, fs)
    batches = -(-NUM_RECEIVERS // bs)
    require(served["launches"] == {"cinv": batches, "sos": 2 * batches},
            f"{SINGLE_ROOM_PRESET}: served launches {served['launches']} in {batches} batches")

    # one gradient of the trainer's EDC + EDR loss on a gathered batch
    arrays = arrays_from_room_dataset(room)
    trainer = GFDNTrainer(seeded, tc, steps_per_epoch(NUM_RECEIVERS, bs),
                          common_decay_times=room.common_decay_times, sample_rate=fs,
                          device=DEVICE)
    trainer.upload_arrays(arrays)
    batch = trainer.gather(torch.arange(bs, device=DEVICE))
    torch.cuda.synchronize()
    reset_counts()
    trainer.loss_and_grads(batch)
    torch.cuda.synchronize()
    grad_launches = {k: v for k, v in launch_counts().items() if v}
    require(grad_launches == {"cinv": 1, "neg_ptgpt": 1, "sos": 2, "sos_backward": 1},
            f"{SINGLE_ROOM_PRESET}: one gradient launched {grad_launches}")

    def step():
        loss, _ = trainer.loss_and_grads(batch)
        return loss, list(seeded.parameters())

    loss_rel, grad_err, inputs = kernel_step(step)
    require(loss_rel <= LOSS_TOL and grad_err <= GRAD_TOL,
            f"{SINGLE_ROOM_PRESET}: gradient kernels vs plain: loss {loss_rel}, "
            f"gradient {grad_err}")
    launches = {**served["launches"], **{k: v for k, v in grad_launches.items()
                                         if k in ("neg_ptgpt", "sos_backward")}}
    rows = slice_rows(SINGLE_ROOM_PRESET, inputs, launches)
    del inputs

    # the time-domain factory (GEQ absorption: the exact filtered path) and one batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    synth = make_time_domain_synthesis_fn(infer.model, nfft)
    torch.cuda.synchronize()
    factory_s = time.perf_counter() - t0
    positions = {k: v[:bs] for k, v in trainer.data.items()
                 if k in ("listener_position", "norm_listener_position")}
    t0 = time.perf_counter()
    td = synth(positions)
    torch.cuda.synchronize()
    mix_s = time.perf_counter() - t0
    require(tuple(td.shape) == (bs, nfft) and bool(torch.isfinite(td).all()),
            f"{SINGLE_ROOM_PRESET}: time-domain RIRs {tuple(td.shape)}")

    # fit_indexed refuses the io-gain normalization before any step (C16)
    refused = GFDNTrainer(seeded, tc, steps_per_epoch(NUM_RECEIVERS, bs),
                          common_decay_times=room.common_decay_times, sample_rate=fs,
                          device=DEVICE)
    reset_counts()
    try:
        refused.fit_indexed(arrays, idx[:80], idx[80:], seed=cfg.seed)
        raise RuntimeError(f"check failed: {SINGLE_ROOM_PRESET}: fit_indexed did not raise C16")
    except ValueError as exc:
        require("C16" in str(exc), f"{SINGLE_ROOM_PRESET}: fit_indexed raised {exc}")
    require(not any(launch_counts().values()) and not list(refused.graphs)
            and not refused.train_loss, f"{SINGLE_ROOM_PRESET}: fit_indexed ran before C16")
    result = {
        "preset": SINGLE_ROOM_PRESET, "delay_lines": n, "groups": cfg.num_groups,
        "bins": nfft // 2 + 1, "batch": bs, "receivers": NUM_RECEIVERS,
        "served_launches": served["launches"], "rirs_per_s": served["rirs_per_s"],
        "serve_s": served["serve_s"], "rel_l2_vs_plain": served["rel_l2_vs_plain"],
        "edc_max_abs_db_vs_plain": served["edc_max_abs_db_vs_plain"],
        "gradient_launches": grad_launches, "step_loss_rel_vs_plain": loss_rel,
        "max_grad_rel_l2_vs_plain": grad_err, "td_factory_s": factory_s,
        "td_batch_s": mix_s, "fit_indexed_refused": "C16",
    }
    del trainer, refused, infer, seeded, synth, td
    return result, rows


def hyp_tuning(tmp: Path) -> dict:
    """Phase 12 (c): ``synth_subband_hyp_tuning`` through the CLI
    (``python -m diffgfdn_torch.cli.run_model -c <preset>``) in a working
    directory that holds its stand-in grid at its ``room_dataset_path``, the
    search cut to HYP_TUNING_CUT and the winner to HYP_TUNING_EPOCHS epochs.
    Each trial's architecture, objective and the card's reserved memory are
    read around the solver's trial function: the first trial may leave
    behind half of what it reserved at most, and the reserved memory may
    grow by a tenth of that from trial to trial at most (a graph pool each
    would pile up over the preset's 50 trials)."""
    import copy

    import torch
    from scipy.io import loadmat

    from diffgfdn_torch.cli import run_model
    from diffgfdn_torch.config import PRESETS
    from diffgfdn_torch.training import hypertuning

    raw = PRESETS[HYP_TUNING_PRESET]
    cut = copy.deepcopy(raw)
    cut["output_filter_config"]["mlp_tuning_config"].update(HYP_TUNING_CUT)
    cut["trainer_config"]["max_epochs"] = HYP_TUNING_EPOCHS
    work = tmp / "synth" / "hyp_tuning"
    write_synth_pickle(work / raw["room_dataset_path"], raw["num_groups"], True)
    trials, search = [], hypertuning.mlp_hyperparameter_tuning
    torch.cuda.empty_cache()  # what a trial reserves, it reserves anew

    def recorded(config, train_fn, **kw):
        def trial(cand):
            torch.cuda.synchronize()
            start = torch.cuda.memory_reserved()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            objective = train_fn(cand)
            torch.cuda.synchronize()
            trials.append({
                "layers": cand.output_filter_config.num_hidden_layers,
                "neurons": cand.output_filter_config.num_neurons_per_layer,
                "objective": float(objective), "trial_s": time.perf_counter() - t0,
                "reserved_before_mb": start / 2 ** 20,
                "peak_reserved_mb": torch.cuda.max_memory_reserved() / 2 ** 20,
                "reserved_after_mb": torch.cuda.memory_reserved() / 2 ** 20,
            })
            print(f"phase 12 (c): trial {trials[-1]}")
            return objective

        best, results = search(config, trial, **kw)
        trials.append({"winner": [best.output_filter_config.num_hidden_layers,
                                  best.output_filter_config.num_neurons_per_layer]})
        return best, results

    hypertuning.mlp_hyperparameter_tuning = recorded
    PRESETS[HYP_TUNING_PRESET] = cut
    try:
        with contextlib.chdir(work):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            run_model.main(["-c", HYP_TUNING_PRESET, "--device", DEVICE])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = {k: v for k, v in launch_counts().items() if v}
    finally:
        hypertuning.mlp_hyperparameter_tuning = search
        PRESETS[HYP_TUNING_PRESET] = raw
    winner = trials.pop()["winner"]
    require(len(trials) == HYP_TUNING_CUT["num_trials"]
            and all(np.isfinite(t["objective"]) for t in trials),
            f"{HYP_TUNING_PRESET}: trials {trials}")
    best = min(trials, key=lambda t: t["objective"])
    require(winner == [best["layers"], best["neurons"]]
            or sum(t["objective"] == best["objective"] for t in trials) > 1,
            f"{HYP_TUNING_PRESET}: winner {winner}, trials {trials}")
    # the first trial leaves what the process keeps (FFT plans, the side
    # stream's cuBLAS workspace); a later one may add a tenth of that trial's
    # graph pool and cached blocks at most
    first = trials[0]
    held = first["peak_reserved_mb"] - first["reserved_before_mb"]
    left = first["reserved_after_mb"] - first["reserved_before_mb"]
    require(0.0 < held and left <= 0.5 * held, f"{HYP_TUNING_PRESET}: the first trial left "
            f"{left} of the {held} MB it reserved")
    for t in trials[1:]:
        require(t["reserved_after_mb"] <= first["reserved_after_mb"] + 0.1 * held,
                f"{HYP_TUNING_PRESET}: reserved memory grew from trial to trial: {trials}")
    for kernel in ("cinv", "neg_ptgpt", "sos", "sos_backward"):
        require(launches.get(kernel, 0) > 0, f"{HYP_TUNING_PRESET}: {kernel} never launched")
    require(not any(launches.get(k, 0) for k in OFF_PATH),
            f"{HYP_TUNING_PRESET}: kernels off the path launched {launches}")
    train_dir = work / raw["trainer_config"]["train_dir"]
    losses = loadmat(str(train_dir / "losses.mat"))
    final = losses["train_loss"].reshape(-1)
    require(final.size == HYP_TUNING_EPOCHS and bool(np.isfinite(final).all()),
            f"{HYP_TUNING_PRESET}: the winner's losses {final}")
    return {"preset": HYP_TUNING_PRESET, "cut": {**HYP_TUNING_CUT,
                                                 "max_epochs": HYP_TUNING_EPOCHS},
            "trials": trials, "winner": winner, "run_s": run_s, "launches": launches,
            "winner_train_loss": final.tolist(),
            "winner_valid_loss": losses["valid_loss"].reshape(-1).tolist()}


def source_receiver(tmp: Path, log_dir) -> tuple:
    """Phase 12 (c): ``DiffGFDNVarSourceReceiverPos`` at the widths of
    ``fullband_grid_colorless`` (N = 12 in 3 groups, 65537 bins, batch 32,
    GEQ absorption, the colorless loss), input heads like the output heads,
    each receiver of phase 2's grid with a seeded source position: both
    heads scalar, then both SVF. Per kind: 2 epochs of ``fit_indexed``
    (graphed), one step on the kernels and on the plain versions, the step
    graphed and eagerly with its launches against SOURCE_RECEIVER_STEP, and
    96 RIRs served through ``InferDiffGFDN(variant="var_source_receiver")``.
    Returns (results, kernel rows)."""
    import copy

    import torch

    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.data.batching import (
        arrays_from_room_dataset,
        fixed_test_split,
        train_valid_split,
    )
    from diffgfdn_torch.inference import InferDiffGFDN
    from diffgfdn_torch.losses import edc_mask
    from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer
    from diffgfdn_torch.training.solver import steps_per_epoch

    results, rows = [], []
    for heads, svf in SOURCE_RECEIVER_HEADS.items():
        label = f"var_source_receiver {heads}"
        cfg = preset_config(SOURCE_RECEIVER_BASE)
        cfg.output_filter_config.use_svfs = svf
        cfg.input_filter_config = copy.deepcopy(cfg.output_filter_config)
        tc = cfg.trainer_config
        tc.max_epochs = TRAIN_EPOCHS
        tc.train_dir = str(tmp / "source_receiver" / heads)
        room = make_room(tmp, SOURCE_RECEIVER_BASE, cfg.sample_rate, tc.num_freq_bins)
        room.source_position = np.random.RandomState(SEED).uniform(
            [0.5, 0.5, 1.0], [9.5, 12.5, 2.0], (room.num_rec, 3))
        model = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz,
                                 variant="var_source_receiver", device=DEVICE)
        arrays = arrays_from_room_dataset(room)
        _, indices = fixed_test_split(arrays.num_items, tc.hold_out_test_set.ratio,
                                      tc.hold_out_test_set.seed)
        train_idx, valid_idx = train_valid_split(indices, tc.train_valid_split, seed=cfg.seed)
        trainer = GFDNTrainer(model, tc, steps_per_epoch(len(train_idx), tc.batch_size),
                              common_decay_times=room.common_decay_times,
                              sample_rate=cfg.sample_rate, device=DEVICE)
        trainer.precompute_target_features(arrays)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        trainer.fit_indexed(arrays, train_idx, valid_idx, seed=cfg.seed)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts().items() if v}
        peak_run = torch.cuda.max_memory_allocated()
        for kernel in SOURCE_RECEIVER_STEP[heads]:
            require(launches.get(kernel, 0) > 0, f"{label}: {kernel} never launched")
        require(not any(launches.get(k, 0) for k in OFF_PATH),
                f"{label}: kernels off the path launched {launches}")
        losses = trainer.train_loss + trainer.valid_loss
        require(len(trainer.train_loss) == TRAIN_EPOCHS and bool(np.isfinite(losses).all()),
                f"{label}: training losses {losses}")
        require(any(g.replays for g in trainer.graphs), f"{label}: the run replayed no step")
        require("source_position" in trainer.data, f"{label}: no source positions uploaded")

        # one step on the kernels and on the plain versions
        idx = torch.arange(BATCH, device=DEVICE)
        batch = trainer.gather(idx)
        mask = edc_mask(trainer.edc_mask_length(batch["z_values"].shape[0]),
                        torch.Generator(device=DEVICE).manual_seed(SEED), idx.device)

        def step():
            loss, _ = trainer.loss_and_grads(batch, mask)
            return loss, list(model.parameters())

        loss_rel, grad_err, inputs = kernel_step(step)
        require(loss_rel <= LOSS_TOL and grad_err <= GRAD_TOL,
                f"{label}: step kernels vs plain: loss {loss_rel}, gradient {grad_err}")
        expected = {k: float(v) for k, v in SOURCE_RECEIVER_STEP[heads].items()}
        graph = graphed_vs_eager(f"source_receiver_{heads}", trainer,
                                 dict(model.named_parameters()),
                                 lambda: trainer.fit_step(idx)[0], log_dir,
                                 trainer.mask_generator)
        require(graph["launches_per_step"] == expected,
                f"{label}: launches per step {graph['launches_per_step']}, expected {expected}")
        rows += slice_rows(label, inputs, {k: launches.get(k, 0) for k in inputs})
        del inputs

        # serving from the trained checkpoint
        infer = InferDiffGFDN(cfg, room, variant="var_source_receiver", device=DEVICE)
        served = served_vs_plain(label, infer, np.arange(NUM_RECEIVERS), BATCH,
                                 cfg.sample_rate)
        per_batch = {k: v * (NUM_RECEIVERS // BATCH)
                     for k, v in SOURCE_RECEIVER_SERVE[heads].items()}
        require(served["launches"] == per_batch,
                f"{label}: served launches {served['launches']}, expected {per_batch}")
        results.append({
            "model": label, "delay_lines": model.num_delay_lines, "groups": model.num_groups,
            "bins": tc.num_freq_bins // 2 + 1, "batch": BATCH, "epochs": TRAIN_EPOCHS,
            "steps_per_epoch": trainer.steps_per_epoch, "run_s": run_s,
            "train_loss": trainer.train_loss, "valid_loss": trainer.valid_loss,
            "launches": launches, "peak_mem_run_mb": peak_run / 2 ** 20,
            "step_loss_rel_vs_plain": loss_rel, "max_grad_rel_l2_vs_plain": grad_err,
            **graph, "served_launches": served["launches"],
            "rirs_per_s": served["rirs_per_s"], "serve_s": served["serve_s"],
            "rel_l2_vs_plain": served["rel_l2_vs_plain"],
            "edc_max_abs_db_vs_plain": served["edc_max_abs_db_vs_plain"],
        })
        del trainer, model, infer, served
        torch.cuda.empty_cache()
    return results, rows


# ----------------------------- phase 13: 6DoF rendering -----------------------------

RENDER_HOPS = 30
RENDER_HOP_MS = 100.0
RENDER_PITCH = 0.3  # the walk's pitch swings between -0.3 and 0.3 rad
RENDER_TRAJECTORIES = 8
RENDER_PRESET = "spatial_directional_1000Hz"
RENDER_GRID_RESOLUTION_M = 0.3  # phase 9's finest resolution
HRIR_TAPS = 256
BRIR_ORIENTATIONS = 12
BRIR_CPU_RECEIVERS = 16  # the conversion's card-vs-CPU check, on the first receivers
BENCH_GRID_M = 1.2  # tools/binaural_bench.py's grid, SRIR length, decays and receivers
BENCH_RIR_S = 1.0
BENCH_DECAYS = (0.4, 0.8, 0.6)
BENCH_RECEIVERS = 4
RENDER_HOST_TOL = 1e-4  # batched render vs the host loop: max abs error / peak
RENDER_DICT_TOL = 2e-5  # dictionary program vs einsum program: max abs error / peak
RENDER_MULTI_TOL = 1e-5  # multi render's walk 0 vs the single render: max abs error / peak
RENDER_CPU_TOL = 1e-5  # the batched render, card vs CPU: max abs error / peak
BRIR_CPU_TOL = 1e-5  # BRIRs, card vs CPU: relative L2 of each BRIR
SRIR_CLI_TOL = 1e-6  # the CLI's SOFA SRIRs and pickled BRIRs vs (a)'s: relative L2
NATIVE_TOL = 1e-4  # the native renderer vs B7's: max abs error / peak


def hrir_set(fs: float):
    """A synthetic order-2 HRIR set: (12, 2, HRIR_TAPS) decaying noise with
    a direct tap, seeded, on the icosahedron (a spherical 5-design), and its
    (M, 3) source positions in degrees."""
    from diffgfdn_torch.ops.sph import t_design_directions

    dirs = t_design_directions(5)
    views = np.stack([np.rad2deg(dirs[0]), 90.0 - np.rad2deg(dirs[1]),
                      np.ones(dirs.shape[1])], axis=-1)
    rng = np.random.RandomState(SEED)
    t = np.arange(HRIR_TAPS)
    irs = rng.randn(len(views), 2, HRIR_TAPS) * np.exp(-t / 32.0)
    irs[:, :, 0] += 1.0
    return irs, views


def max_over_peak(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def brir_rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    """The largest relative L2 error of one BRIR (a receiver and orientation)."""
    d = np.linalg.norm((got - want).reshape(got.shape[0], got.shape[1], -1), axis=-1)
    return float((d / np.linalg.norm(want.reshape(d.shape + (-1,)), axis=-1)).max())


def brir_conversion(srirs: np.ndarray, reader, orientations: np.ndarray, cpu_receivers: int):
    """``convert_srir_to_brir`` on the card, twice (the first call sets up
    cuFFT's plans), and on the CPU for the first receivers. Returns (BRIRs,
    result)."""
    import torch

    from diffgfdn_torch.inference import convert_srir_to_brir

    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        brirs = convert_srir_to_brir(srirs, reader, orientations, device=DEVICE)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    p, o = srirs.shape[0], orientations.shape[0]
    require(brirs.shape[:2] == (p, o) and brirs.shape[-1] == 2 and bool(np.isfinite(brirs).all()),
            f"BRIRs {brirs.shape}, finite {np.isfinite(brirs).all()}")
    cpu = convert_srir_to_brir(srirs[:cpu_receivers], reader, orientations, device="cpu")
    err = brir_rel_l2(brirs[:cpu_receivers], cpu)
    require(err <= BRIR_CPU_TOL, f"BRIRs card vs CPU rel L2 {err}")
    return brirs, {"srirs": list(srirs.shape), "orientations": o, "brirs": list(brirs.shape),
                   "first_s": walls[0], "wall_s": walls[1], "brirs_per_s": p * o / walls[1],
                   "peak_mem_mb": peak / 2 ** 20, "cpu_receivers": cpu_receivers,
                   "max_rel_l2_card_vs_cpu": err}


def fft_flops(n: int, count: int) -> float:
    """Operations of ``count`` real FFTs of length n, 2.5 n log2 n each."""
    return count * 2.5 * n * np.log2(n)


def render_cost(rend, walks: int, dictionary: bool):
    """Bytes and fp32 operations of a batched render's device program for
    ``walks`` walks: its inputs read once (the stimulus segments; the
    rotations and gather index, or the atom weights; the RTFs and the
    HRTF-SH set, or the dictionary) and its (B, T, 2) output written once;
    the smoothing and the two einsums (4 operations a real-by-complex, 8 a
    complex multiply-add), or the (B K, J) x (J, 2 F2 2) product, and the
    FFTs."""
    k, hop, nfft = rend.num_pos, rend.hop_size, rend.num_freq_bins
    nfft2 = rend._conv_nfft()
    f, f2 = nfft // 2 + 1, nfft2 // 2 + 1
    u, s = rend._rtf_uniq.shape[:2]
    bk = walks * k
    io = 4 * bk * hop * 3  # the segments in, two ears out
    spectra = 6 * bk * 2 * f2  # the stimulus spectrum times each ear's
    if dictionary:
        j = u * s * s
        return (io + 4 * bk * j + 16 * j * f2,
                2 * bk * j * 4 * f2 + spectra + fft_flops(nfft2, 3 * bk))
    return (io + 4 * bk * s * s + 8 * bk + 8 * (u * s * f + s * 2 * f),
            4 * bk * s * f + 4 * bk * s * s * f + 8 * bk * s * 2 * f + spectra
            + fft_flops(nfft, 2 * bk) + fft_flops(nfft2, 5 * bk))


def timed_device_render(rend, render, stimuli: np.ndarray, stored_orientations: np.ndarray):
    """``render()`` (a batched render of the renderer, host arrays in, host
    float64 out) once (uploads, dictionary, cuFFT plans) and three times
    more, and its halves apart: the host's inputs (one rotation recursion per
    hop and walk, from ``stored_orientations``, pitch negated) and the
    device program. Returns (the first output, result)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = render()
    first_s = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        render()
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    args = rend.device_inputs(stimuli, stored_orientations)
    host_s = time.perf_counter() - t0
    device = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rend.render_device(*args)
        torch.cuda.synchronize()
        device.append(time.perf_counter() - t0)
    audio_s = stimuli.shape[0] * rend.total_sim_len / rend.sample_rate
    b_ms, b_by = bound(*render_cost(rend, stimuli.shape[0], rend._use_dict_path()))
    return out, {"program": "dictionary" if rend._use_dict_path() else "einsum",
                 "walks": stimuli.shape[0], "first_s": first_s, "wall_s": walls,
                 "x_real_time": audio_s / float(np.median(walls)),
                 "host_inputs_s": host_s, "device_program_s": device,
                 "device_program_x_real_time": audio_s / float(np.median(device)),
                 "device_program_bound_ms": b_ms, "bound_by": b_by,
                 "peak_mem_mb": torch.cuda.max_memory_allocated() / 2 ** 20}


def render_ways(label: str, room, rec_idx, orientations, stimulus, hrir_sh,
                multi_orientations, log_dir) -> dict:
    """A walk of ``len(rec_idx)`` hops over the room's receivers, four ways:
    the host loop (``stream_host`` from a fresh renderer), the default
    ``backend="device"`` through the
    einsum program and through the dictionary program (both forced), and
    the multi render of RENDER_TRAJECTORIES walks (seeded stimuli, walk 0
    this one) through the program the auto policy picks. Each batched
    render is held against the host loop, the two programs against each
    other, walk 0 against the single render and each program against the
    same render on the CPU."""
    from diffgfdn_torch.inference import BinauralDynamicRendering

    pos = room.receiver_position[rec_idx]

    def renderer(device):
        return BinauralDynamicRendering(room, pos, orientations, stimulus, hrir_sh,
                                        update_ms=RENDER_HOP_MS, use_whole_rir=True,
                                        device=device)

    rend = renderer(DEVICE)
    audio_s = rend.total_sim_len / room.sample_rate
    t0 = time.perf_counter()
    host = renderer(DEVICE).stream_host()
    host_s = time.perf_counter() - t0
    require(bool(np.isfinite(host).all()), f"{label}: host loop not finite")
    result = {"hops": len(rec_idx), "unique_receivers": int(rend._rtf_uniq.shape[0]),
              "num_freq_bins": rend.num_freq_bins, "conv_nfft": rend._conv_nfft(),
              "dictionary_mb": rend._dict_nbytes() / 2 ** 20,
              "auto_program": "dictionary" if rend._use_dict_path() else "einsum",
              "audio_s": audio_s, "host": {"wall_s": host_s, "x_real_time": audio_s / host_s}}
    outs = {}
    cpu = renderer("cpu")
    for name, dict_path in (("einsum", False), ("dictionary", True)):
        rend.dict_path = cpu.dict_path = dict_path
        out, row = timed_device_render(
            rend, lambda: rend.binaural_filter_overlap_add(backend="device"),
            rend.extended_stimulus[None], rend.orientation_list[None])
        require(bool(np.isfinite(out).all()), f"{label} {name}: render not finite")
        row["max_abs_over_peak_vs_host"] = max_over_peak(out, host)
        row["max_abs_over_peak_card_vs_cpu"] = max_over_peak(
            out, cpu.binaural_filter_overlap_add(backend="device"))
        require(row["max_abs_over_peak_vs_host"] <= RENDER_HOST_TOL,
                f"{label} {name}: device vs host {row['max_abs_over_peak_vs_host']}")
        require(row["max_abs_over_peak_card_vs_cpu"] <= RENDER_CPU_TOL,
                f"{label} {name}: card vs CPU {row['max_abs_over_peak_card_vs_cpu']}")
        outs[name] = out
        result[f"device_{name}"] = row
    result["dictionary_vs_einsum"] = max_over_peak(outs["dictionary"], outs["einsum"])
    require(result["dictionary_vs_einsum"] <= RENDER_DICT_TOL,
            f"{label}: dictionary vs einsum {result['dictionary_vs_einsum']}")
    del cpu

    rend.dict_path = None
    rng = np.random.RandomState(SEED + 1)
    stimuli = np.concatenate([rend.extended_stimulus[None], rng.randn(
        RENDER_TRAJECTORIES - 1, rend.total_sim_len).astype(np.float32)])
    multi_oris = np.concatenate([orientations[None], multi_orientations[1:]])
    multi, row = timed_device_render(
        rend, lambda: rend.binaural_filter_overlap_add_multi(stimuli, multi_oris), stimuli,
        multi_oris * np.array([1.0, -1.0]))
    require(multi.shape == (RENDER_TRAJECTORIES, rend.total_sim_len, 2)
            and bool(np.isfinite(multi).all()), f"{label}: multi render {multi.shape}")
    row["walk0_max_abs_over_peak_vs_single"] = max_over_peak(multi[0], outs[row["program"]])
    require(row["walk0_max_abs_over_peak_vs_single"] <= RENDER_MULTI_TOL,
            f"{label}: multi walk 0 vs single {row['walk0_max_abs_over_peak_vs_single']}")
    result["multi"] = row
    if log_dir is not None:
        wall, busy, _, kernels = profile_once(
            lambda: rend.binaural_filter_overlap_add(backend="device"), f"render_{label}",
            Path(log_dir) / f"profile_render_{label}.txt")
        result.update(profiled_render_ms=wall, profiled_device_busy_ms=busy,
                      profiled_idle_share=1.0 - busy / wall, profiled_device_kernels=kernels)
    return result


def receiver_output_gains(infer, receiver: int) -> "torch.Tensor":
    """(N,) output gains of one receiver of a scalar-head model: the mix that
    ``make_time_domain_synthesis_fn`` applies to the delay-line outputs."""
    import torch

    from diffgfdn_torch.models.gain_heads import expand_groups_to_delay_lines

    model = infer.model
    with torch.no_grad():
        c = expand_groups_to_delay_lines(model.output_scalars(infer._device_batch(
            np.array([receiver]))), model.num_delay_lines_per_group)
        return (c * model.output_gains[:, 0])[0]


def native_vs_b7(native_inputs, fs: float) -> dict:
    """(d): the native streaming renderer against B7 on phase 6's
    three-room model (its delays, gains, A and b, receiver 0's output
    gains), on an impulse of 131072 samples."""
    import torch

    from diffgfdn_torch.kernels.tdgfdn import delay_line_outputs
    from diffgfdn_torch.native import NativeGFDNRenderer
    from diffgfdn_torch.native import tdfdn

    delays, g, a, b, c = native_inputs
    t_len = 131072
    impulse = torch.zeros(t_len, device=g.device)
    impulse[0] = 1.0
    reset_counts()
    with torch.no_grad():
        ref = (delay_line_outputs(delays, g, a, b, impulse) @ c).cpu().numpy()
    require(launch_counts()["tdgfdn"] == 1, f"native reference: B7 launched {launch_counts()}")
    t0 = time.perf_counter()
    renderer = NativeGFDNRenderer(delays, g.cpu().numpy(), a.cpu().numpy(), b.cpu().numpy())
    build_s = time.perf_counter() - t0
    c_np = c.cpu().numpy()[None]
    out = renderer.process(impulse.cpu().numpy(), c_np)[0]
    err = max_over_peak(out, ref)
    require(bool(np.isfinite(out).all()) and err <= NATIVE_TOL, f"native vs B7 {err} of peak")
    walls = []
    for _ in range(3):
        renderer.reset()
        t0 = time.perf_counter()
        renderer.process(impulse.cpu().numpy(), c_np)
        walls.append(time.perf_counter() - t0)
    x_real_time = t_len / fs / float(np.median(walls))
    require(x_real_time > 1, f"native renderer {x_real_time}x real time: cannot stream")
    return {"library": str(tdfdn.library_path()), "build_and_create_s": build_s,
            "delay_lines": len(delays), "samples": t_len, "max_abs_over_peak_vs_b7": err,
            "process_s": walls, "x_real_time": x_real_time}


def sofa_files(tmp: Path, room_path: Path, srirs: np.ndarray, brirs: np.ndarray,
               hrirs, fs: float) -> dict:
    """(e): with h5py, a synthetic HRIR SOFA file, then the spatial CLI's
    ``--infer-dataset`` (SOFA out) and ``--return-brirs --hrtf`` on phase
    9's checkpoint, run from a working directory that holds it at the
    preset's ``train_dir``; both files read back and held to (a)'s SRIRs and
    1-orientation BRIRs."""
    import pickle

    import torch

    try:
        import h5py
    except ImportError:
        print("phase 13 (e): h5py: absent; the HRIR readers were built from arrays")
        return {"h5py": "absent"}

    from diffgfdn_torch.cli import run_spatial_sampling
    from diffgfdn_torch.config import spatial_preset_config

    work = tmp / "render_cli"
    ckpt = work / spatial_preset_config(RENDER_PRESET).train_dir
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    ckpt.symlink_to(tmp / "spatial" / RENDER_PRESET)
    irs, views = hrirs
    hrtf = work / "hrir.sofa"
    with h5py.File(hrtf, "w") as f:
        f.create_dataset("Data.IR", data=irs)
        f.create_dataset("Data.SamplingRate", data=np.array([fs]))
        f.create_dataset("SourcePosition", data=views).attrs["Units"] = "degree, degree, metre"
    args = ["-c", RENDER_PRESET, "--infer-dataset", str(room_path), "--grid-resolution",
            str(RENDER_GRID_RESOLUTION_M), "--device", DEVICE]
    with contextlib.chdir(work):
        reset_counts()
        t0 = time.perf_counter()
        sofa = run_spatial_sampling.main(args + ["--output", "out/srirs_est"])
        sofa_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pkl = run_spatial_sampling.main(args + ["--output", "out/brirs", "--return-brirs",
                                                "--hrtf", str(hrtf)])
        pkl_s = time.perf_counter() - t0
        require(all(v == 0 for v in launch_counts().values()),
                f"spatial CLI inference: hand-written kernels launched {launch_counts()}")
        with h5py.File(sofa, "r") as f:
            sofa_ir = f["Data.IR"][()]
            conventions = f.attrs["SOFAConventions"]
        with open(pkl, "rb") as f:
            pickled = pickle.load(f)
    sofa_err = rel_l2(torch.from_numpy(sofa_ir), torch.from_numpy(srirs).double())
    brir_err = rel_l2(torch.from_numpy(pickled["brirs"]), torch.from_numpy(brirs))
    require(conventions == "SingleRoomSRIR" and sofa_ir.shape == srirs.shape
            and sofa_err <= SRIR_CLI_TOL,
            f"CLI SOFA: {conventions}, {sofa_ir.shape}, rel L2 vs served {sofa_err}")
    require(pickled["brirs"].shape == brirs.shape and brir_err <= SRIR_CLI_TOL,
            f"CLI BRIRs {pickled['brirs'].shape}, rel L2 vs (a) {brir_err}")
    return {"h5py": h5py.__version__, "sofa": list(sofa_ir.shape), "sofa_s": sofa_s,
            "sofa_rel_l2_vs_served": sofa_err, "brirs": list(pickled["brirs"].shape),
            "brirs_s": pkl_s, "brirs_rel_l2_vs_conversion": brir_err}


def walk_orientations(hops: int, pitch: float, turns: float = 1.0) -> np.ndarray:
    """(hops, 2) yaw from 0 to 2 pi turns and pitch swinging through +-pitch."""
    phase = np.linspace(0.0, 2.0 * np.pi, hops)
    return np.stack([turns * phase, pitch * np.sin(phase)], axis=-1)


def rendering(tmp: Path, log_dir, directional_srirs: np.ndarray, native_inputs) -> dict:
    """Phase 13: BASELINE's fifth configuration (a 6DoF moving-listener
    binaural render) on the common-slopes chain, at the repo's benchmark
    sizes, the directional GFDN's SRIRs through the conversion, the native
    renderer against B7, and the spatial CLI's SOFA and BRIR output. No
    hand-written kernel lies on (a)-(c): every launch count must stay 0."""
    import torch

    from diffgfdn_torch.config import spatial_preset_config
    from diffgfdn_torch.data import generate_spatial_three_room_pickle, SpatialThreeRoomDataset
    from diffgfdn_torch.inference import get_ambisonic_rirs, HRIRSOFAReader

    room_path = tmp / "directional" / "srirs.pkl"
    room = SpatialThreeRoomDataset(room_path)
    fs = room.sample_rate
    hrirs = hrir_set(fs)
    reader = HRIRSOFAReader.from_arrays(*hrirs[:1], fs, hrirs[1])
    hrir_sh = reader.get_spherical_harmonic_representation(2)
    result = {"hrir_sh": list(hrir_sh.shape)}
    reset_counts()

    # (a) the CS chain: SRIRs served from phase 9's 0.3 m checkpoint, BRIRs, a walk
    cfg = spatial_preset_config(RENDER_PRESET, max_epochs=SPATIAL_EPOCHS,
                                train_dir=str(tmp / "spatial" / RENDER_PRESET))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = get_ambisonic_rirs(room.receiver_position, room, use_trained_model=True,
                                configs=[cfg], grid_resolution_m=RENDER_GRID_RESOLUTION_M,
                                device=DEVICE)
    serve_s = time.perf_counter() - t0
    require(served.rirs.shape == (room.num_rec, 9, room.rir_length)
            and bool(np.isfinite(served.rirs).all()), f"(a): served {served.rirs.shape}")
    ori1 = np.zeros((1, 2))
    brirs1, conv1 = brir_conversion(served.rirs, reader, ori1, BRIR_CPU_RECEIVERS)
    oris = walk_orientations(BRIR_ORIENTATIONS + 1, RENDER_PITCH)[:-1]
    _, conv12 = brir_conversion(served.rirs, reader, oris, BRIR_CPU_RECEIVERS)
    rng = np.random.RandomState(SEED)
    stim = rng.randn(int(fs)).astype(np.float32)
    multi = np.stack([walk_orientations(RENDER_HOPS, RENDER_PITCH, (i + 1) / RENDER_TRAJECTORIES)
                      for i in range(RENDER_TRAJECTORIES)])
    walk = render_ways("cs", served, np.arange(RENDER_HOPS),
                       walk_orientations(RENDER_HOPS, RENDER_PITCH), stim, hrir_sh, multi,
                       log_dir)
    result["a"] = {"preset": RENDER_PRESET, "served": list(served.rirs.shape), "serve_s": serve_s,
                   "brirs_1_orientation": conv1, f"brirs_{BRIR_ORIENTATIONS}_orientations": conv12,
                   "walk": walk}
    print("phase 13 (a): " + json.dumps(result["a"]), flush=True)

    # (b) tools/binaural_bench.py's sizes: a 1.2 m grid, 1 s SRIRs, 30 hops over 4 receivers
    path = generate_spatial_three_room_pickle(
        tmp / "render" / "s.pkl", fs=fs, grid_spacing_m=BENCH_GRID_M, rir_len_s=BENCH_RIR_S,
        decay_times=BENCH_DECAYS, seed=SEED)
    bench = SpatialThreeRoomDataset(path)
    rng = np.random.RandomState(0)
    t = np.arange(HRIR_TAPS)
    bench_sh = rng.randn(9, 2, HRIR_TAPS) * np.exp(-t / 64.0)[None, None, :]
    idx = np.tile(np.arange(BENCH_RECEIVERS), RENDER_HOPS // BENCH_RECEIVERS + 1)[:RENDER_HOPS]
    bench_stim = rng.randn(int(fs)).astype(np.float32)
    bench_multi = np.stack([walk_orientations(RENDER_HOPS, 0.0, (i + 1) / RENDER_TRAJECTORIES)
                            for i in range(RENDER_TRAJECTORIES)])
    result["b"] = {"grid_m": BENCH_GRID_M, "srirs": list(bench.rirs.shape), "walk": render_ways(
        "bench", bench, idx, walk_orientations(RENDER_HOPS, 0.0), bench_stim, bench_sh,
        bench_multi, log_dir)}
    print("phase 13 (b): " + json.dumps(result["b"]), flush=True)
    del bench

    # (c) the directional GFDN's served SRIRs (phase 8) through the conversion
    _, result["c"] = brir_conversion(directional_srirs, reader, ori1, 4)
    print("phase 13 (c): " + json.dumps(result["c"]), flush=True)
    require(all(v == 0 for v in launch_counts().values()),
            f"rendering and conversion: hand-written kernels launched {launch_counts()}")

    # (d) the native streaming renderer against B7
    result["d"] = native_vs_b7(native_inputs, fs)
    print("phase 13 (d): " + json.dumps(result["d"]), flush=True)

    # (e) SOFA files through the spatial CLI
    result["e"] = sofa_files(tmp, room_path, served.rirs, brirs1, hrirs, fs)
    print("phase 13 (e): " + json.dumps(result["e"]), flush=True)
    return result


# --------------- phase 14: coupling, absorption, encoding and loss options ---------------

OPTIONS_BASE = "fullband_grid_colorless"
OPTIONS_DIRECTIONAL = "directional_1000Hz_res0.9m"
# launches of one training step and of one served batch of each part:
# (a) FILTER coupling, SVF heads: the dense (F, 12, 12) loop's inverse and
#     the sub-FDNs' (B1), their gradients (B2), the heads' and the
#     absorption's cascades (B3), the heads' gradient (B4);
# (b) FILTER coupling, scalar heads: the sub-FDN inverse of the per-step
#     normalization, which the colorless loss reuses (B1, B2), the dense
#     drive's solve (B5, B6), the absorption's cascade (B3);
# (c) the coupled directional model: the 9 x 9 sub-FDNs (B1, B2), the dense
#     (F, 27, 27) transposed drive (B5, B6);
# (d) learned decay times, meshgrid SVF heads, the three loss options: the
#     blocks' and the sub-FDNs' inverses (B1, B2), the heads' and the
#     regularizer's cascades (B3, B4)
OPTIONS_STEP = {
    "a": {"cinv": 2, "neg_ptgpt": 2, "sos": 2, "sos_backward": 1},
    "b": {"cinv": 1, "neg_ptgpt": 1, "lu": 1, "lut_apply": 1, "sos": 1},
    "c": {"cinv": 1, "neg_ptgpt": 1, "lu": 1, "lut_apply": 1},
    "d": {"cinv": 2, "neg_ptgpt": 2, "sos": 2, "sos_backward": 2},
}
OPTIONS_SERVE = {"a": {"cinv": 1, "sos": 2}, "b": {"lu": 1, "sos": 1}, "c": {"lu": 1},
                 "d": {"cinv": 1, "sos": 1}, "e": {"cinv": 1, "sos": 1}}
# the time-domain factory's kernel: B7 on a static feedback matrix with
# scalar gains; the filtered block path (absorption filters, or FILTER
# coupling's polynomial feedback) launches none
OPTIONS_TD = {"a": {}, "b": {}, "c": {"tdgfdn": 1}, "d": {"tdgfdn": 1}, "e": {}}


def option_shape(kernel: str, n: int = None, bins: int = None):
    """A ``select`` predicate of :func:`recording_kernel_inputs`: the first
    call of ``kernel`` on N x N systems, or on ``bins`` points z."""
    if kernel in ("cinv", "neg_ptgpt", "lu"):
        return lambda *a: a[0].shape[-1] == n
    if kernel == "lut_apply":
        return lambda *a: a[2].shape[-1] == n
    return lambda *a: a[2].shape[0] == bins  # sos, sos_backward: (num, den, w, ...)


def solve_rows(label: str, inputs: dict, launches: dict) -> list:
    """Rows of B5 (x, factors and pivots) and B6 against their plain versions,
    bit for bit, at the inputs one step gave them; timed beside their bounds,
    plain versions and ``torch.linalg.solve``."""
    import torch

    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.kernels.lu import lu_solve, lut_apply

    def plain(fn, *args):
        with plain_versions():
            return fn(*args)

    m5, b5 = inputs["lu"]
    x, lu, piv = lu_solve(m5, b5)
    ref = plain(lu_solve, m5, b5)
    torch.cuda.synchronize()
    differ = [int((o != r).sum()) for o, r in zip((x, lu, piv), ref)]
    lu6, piv6, g6 = inputs["lut_apply"]
    y = lut_apply(lu6, piv6, g6)
    y_p = plain(lut_apply, lu6, piv6, g6)
    differ.append(int((y != y_p).sum()))
    rows = [
        timed_row(f"lu_solve [{label}]", "lu.cu", "diffgfdn_tpu/kernels/pallas_lu.py:46",
                  launches.get("lu", 0), float(torch.max(torch.abs(x - ref[0]))),
                  lambda: lu_solve(m5, b5), lambda: plain(lu_solve, m5, b5),
                  lambda: lu_solve(m5, b5), lu_cost(m5.shape[0], m5.shape[1]),
                  lambda: torch.linalg.solve(m5, b5.unsqueeze(-1)), m5.shape),
        timed_row(f"lut_apply [{label}]", "lu.cu", "diffgfdn_tpu/kernels/pallas_lu.py:142",
                  launches.get("lut_apply", 0), float(torch.max(torch.abs(y - y_p))),
                  lambda: lut_apply(lu6, piv6, g6), lambda: plain(lut_apply, lu6, piv6, g6),
                  lambda: lut_apply(lu6, piv6, g6), lut_apply_cost(g6.shape[0], g6.shape[1]),
                  lambda: torch.linalg.solve(m5.mH, g6.unsqueeze(-1)), g6.shape),
    ]
    print(f"kernels, {label}: B5 {tuple(m5.shape)} (x, factors, pivots), B6 "
          f"{tuple(g6.shape)} differ from plain in {differ} elements")
    require(differ == [0, 0, 0, 0], f"{label}: B5 / B6 vs plain differ in {differ}")
    return rows


def td_check(label: str, model, batches: list, nfft: int, fs: float, expect: dict,
             reduced_pole_radius: float = 1.0, reference=contextlib.nullcontext) -> dict:
    """Phase 14's time domain: ``make_time_domain_synthesis_fn`` (launches
    counted from the factory to the end of the mix, as ``expect``), against
    its plain versions (RIR_TOL, EDC_TOL_DB) and the model's frequency path
    without the direct part, computed within ``reference()`` (TD_FREQ_TOL of
    the peak, EDC_TOL_DB over 0.5 s), finite and decaying; the factory's and
    a mix's times."""
    import torch

    from diffgfdn_torch.inference import make_rir_synthesis_fn, make_time_domain_synthesis_fn
    from diffgfdn_torch.kernels.dispatch import plain_versions

    def mix(synth, drop_direct=False):
        return np.concatenate([
            synth({k: v for k, v in b.items()
                   if not (drop_direct and k == "target_early_response")}).cpu().numpy()
            for b in batches])

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    synth = make_time_domain_synthesis_fn(model, nfft)
    torch.cuda.synchronize()
    factory_s = time.perf_counter() - t0
    td = mix(synth)
    launches = {k: v for k, v in launch_counts().items() if v}
    require({k: v for k, v in launches.items() if k == "tdgfdn"} == expect,
            f"{label} time domain: launches {launches}, expected {expect}")
    require(bool(np.isfinite(td).all()), f"{label} time domain: non-finite RIRs")
    edc = edc_db(td)
    drop = edc[..., int(0.05 * fs)] - edc[..., int(1.0 * fs)]
    require(bool((drop > 10.0).all()), f"{label} time domain: no decay (min {drop.min()} dB)")
    half_s = int(0.5 * fs)
    with plain_versions():
        plain = mix(make_time_domain_synthesis_fn(model, nfft))
    rel = float(np.linalg.norm(td - plain) / np.linalg.norm(plain))
    edc_plain = float(np.abs(edc - edc_db(plain))[..., :half_s].max())
    require(rel <= RIR_TOL and edc_plain <= EDC_TOL_DB,
            f"{label} time domain vs plain: rel L2 {rel}, EDC {edc_plain} dB")
    del plain
    with reference():
        freq = mix(make_rir_synthesis_fn(model, reduced_pole_radius), True)
    freq_err = float(np.abs(td - freq).max() / np.abs(freq).max())
    edc_freq = float(np.abs(edc - edc_db(freq))[..., :half_s].max())
    require(freq_err <= TD_FREQ_TOL and edc_freq <= EDC_TOL_DB,
            f"{label} time domain vs frequency path: {freq_err} of the peak, EDC {edc_freq} dB")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        mix(synth)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    mix_s = float(np.median(times))
    return {"td_launches": launches, "td_factory_ms": factory_s * 1e3, "td_mix_ms": mix_s * 1e3,
            "td_rirs_per_s": len(td) / mix_s, "td_rel_l2_vs_plain": rel,
            "td_edc_max_abs_db_vs_plain": edc_plain,
            "td_max_abs_over_peak_vs_freq_path": freq_err,
            "td_edc_max_abs_db_vs_freq_path": edc_freq}


def option_fit(part: str, label: str, train_idx, valid_idx, log_dir, select: dict,
               run) -> tuple:
    """One part of phase 14's training: ``run()`` (``fit_indexed`` or the
    directional solver: 2 epochs, graphed; it returns the trainer and the
    model) with its launches counted, finite losses and replayed graphs; one
    step on the kernels and on the plain versions (the kernels' inputs
    recorded as ``select`` picks them); the step graphed and eagerly
    (``graphed_vs_eager``), its launches per step as OPTIONS_STEP[part].
    Returns (result, the run's launches, the recorded inputs, the model)."""
    import torch

    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.losses import edc_mask

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer, model = run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    peak_run = torch.cuda.max_memory_allocated()
    require(set(launches) == set(OPTIONS_STEP[part]),
            f"{label}: the run launched {launches}, its path is {OPTIONS_STEP[part]}")
    losses = trainer.train_loss + trainer.valid_loss
    require(len(trainer.train_loss) == TRAIN_EPOCHS and bool(np.isfinite(losses).all()),
            f"{label}: training losses {losses}")
    require(any(g.replays for g in trainer.graphs), f"{label}: the run replayed no step")

    idx = torch.arange(BATCH, device=DEVICE)
    batch = trainer.gather(idx)
    mask = edc_mask(trainer.edc_mask_length(batch["z_values"].shape[0]),
                    torch.Generator(device=DEVICE).manual_seed(SEED), idx.device)
    inputs = {}
    with recording_kernel_inputs(inputs, forward=True, select=select):
        loss_k, aux = trainer.loss_and_grads(batch, mask)
    grads_k = {n: p.grad.clone() for n, p in model.named_parameters()}
    with plain_versions():
        loss_p, _ = trainer.loss_and_grads(batch, mask)
    grads_p = {n: p.grad.clone() for n, p in model.named_parameters()}
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_errs = {n: rel_l2(grads_k[n], grads_p[n]) for n in grads_k}
    worst = max(grad_errs, key=grad_errs.get)
    require(loss_rel <= LOSS_TOL and grad_errs[worst] <= GRAD_TOL,
            f"{label}: step kernels vs plain: loss {loss_rel}, gradient of {worst} "
            f"{grad_errs[worst]}")
    require(set(select) <= set(inputs), f"{label}: no call of {set(select) - set(inputs)} "
            "at the shape of the path")
    graph = graphed_vs_eager(f"options_{part}", trainer, dict(model.named_parameters()),
                             lambda: trainer.fit_step(idx)[0], log_dir, trainer.mask_generator)
    expected = {k: float(v) for k, v in OPTIONS_STEP[part].items()}
    require(graph["launches_per_step"] == expected,
            f"{label}: launches per step {graph['launches_per_step']}, expected {expected}")
    result = {"part": part, "model": label, "delay_lines": model.num_delay_lines,
              "bins": batch["z_values"].shape[0], "batch": BATCH, "epochs": TRAIN_EPOCHS,
              "steps_per_epoch": trainer.steps_per_epoch, "train": len(train_idx),
              "valid": len(valid_idx), "run_s": run_s, "train_loss": trainer.train_loss,
              "valid_loss": trainer.valid_loss, "step_losses": {k: float(v) for k, v in
                                                                aux.items()},
              "launches": launches, "peak_mem_run_mb": peak_run / 2 ** 20,
              "step_loss_rel_vs_plain": loss_rel, "max_grad_rel_l2_vs_plain": grad_errs[worst],
              **graph}
    return result, launches, inputs, model


def grid_option(part: str, label: str, cfg, tmp: Path, log_dir, select: dict) -> tuple:
    """Phase 14 (a), (b), (d): ``fullband_grid_colorless`` with the part's
    options on phase 2's synthetic grid: trained (:func:`option_fit`), served
    through ``InferDiffGFDN`` (launches per batch as OPTIONS_SERVE[part],
    against the plain path) and synthesized in the time domain
    (:func:`td_check`). Returns (result, launches of the run, inputs)."""
    import torch

    from diffgfdn_torch.data.batching import (
        arrays_from_room_dataset,
        fixed_test_split,
        train_valid_split,
    )
    from diffgfdn_torch.inference import InferDiffGFDN
    from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer
    from diffgfdn_torch.training.solver import steps_per_epoch

    tc = cfg.trainer_config
    tc.max_epochs = TRAIN_EPOCHS
    tc.train_dir = str(tmp / "options" / part)
    room = make_room(tmp, OPTIONS_BASE, cfg.sample_rate, tc.num_freq_bins)
    model = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz, device=DEVICE)
    arrays = arrays_from_room_dataset(room)
    _, indices = fixed_test_split(arrays.num_items, tc.hold_out_test_set.ratio,
                                  tc.hold_out_test_set.seed)
    train_idx, valid_idx = train_valid_split(indices, tc.train_valid_split, seed=cfg.seed)
    trainer = GFDNTrainer(model, tc, steps_per_epoch(len(train_idx), tc.batch_size),
                          common_decay_times=room.common_decay_times,
                          sample_rate=cfg.sample_rate, device=DEVICE)
    trainer.precompute_target_features(arrays)
    result, launches, inputs, _ = option_fit(
        part, label, train_idx, valid_idx, log_dir, select,
        lambda: (trainer, trainer.fit_indexed(arrays, train_idx, valid_idx, seed=cfg.seed)))
    del trainer
    infer = InferDiffGFDN(cfg, room, device=DEVICE)
    served = served_vs_plain(label, infer, np.arange(NUM_RECEIVERS), BATCH, cfg.sample_rate)
    per_batch = {k: v * (NUM_RECEIVERS // BATCH) for k, v in OPTIONS_SERVE[part].items()}
    require(served["launches"] == per_batch,
            f"{label}: served launches {served['launches']}, expected {per_batch}")
    rec = np.arange(NUM_RECEIVERS)
    batches = [infer._device_batch(rec[k:k + BATCH]) for k in range(0, NUM_RECEIVERS, BATCH)]
    td = td_check(label, infer.model, batches, tc.num_freq_bins, cfg.sample_rate,
                  OPTIONS_TD[part], tc.reduced_pole_radius)
    result.update(served_launches=served["launches"], rirs_per_s=served["rirs_per_s"],
                  serve_s=served["serve_s"], rel_l2_vs_plain=served["rel_l2_vs_plain"],
                  edc_max_abs_db_vs_plain=served["edc_max_abs_db_vs_plain"], **td)
    del infer, served
    torch.cuda.empty_cache()
    return result, launches, inputs


def coupled_directional(tmp: Path, log_dir) -> tuple:
    """Phase 14 (c): ``directional_1000Hz_res0.9m`` with ``use_zero_coupling:
    false`` (27 lines, learned Givens angles: one dense 27 x 27 loop) trained
    through the directional solver on phase 8's spatial grid, its 96
    receivers' SRIRs served and synthesized in the time domain (B7 at N = 27
    on the dense transposed A). Returns (result, kernel rows)."""
    import torch

    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.data import (
        generate_spatial_three_room_pickle,
        SpatialThreeRoomDataset,
        split_by_grid_resolution,
    )
    from diffgfdn_torch.inference import InferDiffGFDN
    from diffgfdn_torch.training import run_training_anisotropic_decay_var_receiver_pos

    cfg = preset_config(OPTIONS_DIRECTIONAL)
    cfg.feedback_loop_config.use_zero_coupling = False
    tc = cfg.trainer_config
    tc.train_dir = str(tmp / "options" / "c")
    tc.max_epochs = TRAIN_EPOCHS
    path = tmp / "directional" / "srirs.pkl"
    if not path.exists():  # phase 8's grid, when phase 14 runs alone
        generate_spatial_three_room_pickle(
            path, fs=cfg.sample_rate, grid_spacing_m=DIRECTIONAL_GRID_M,
            rir_len_s=DIRECTIONAL_RIR_S, decay_times=DIRECTIONAL_DECAYS, seed=SEED)
    room = SpatialThreeRoomDataset(path)
    train_idx, valid_idx = split_by_grid_resolution(room, tc.grid_resolution_m)
    label = f"{OPTIONS_DIRECTIONAL} coupled"
    n = len(cfg.delay_length_samps)
    select = {"lu": option_shape("lu", n), "lut_apply": option_shape("lut_apply", n)}
    result, launches, inputs, model = option_fit(
        "c", label, train_idx, valid_idx, log_dir, select,
        lambda: run_training_anisotropic_decay_var_receiver_pos(cfg, room, device=DEVICE))
    require(not model.feedback_loop.is_block_diagonal and n == 27,
            f"{label}: the loop is not the dense 27-line one")
    rows = solve_rows(label, inputs, launches)
    for row, kernel in zip(rows, ("lu", "lut_apply")):
        row["launches_per_step"] = result["launches_per_step"][kernel]
    del inputs, model
    infer = InferDiffGFDN(cfg, room, variant="directional", device=DEVICE)
    served = served_vs_plain(label, infer, np.arange(NUM_RECEIVERS), BATCH, cfg.sample_rate)
    per_batch = {k: v * (NUM_RECEIVERS // BATCH) for k, v in OPTIONS_SERVE["c"].items()}
    require(served["launches"] == per_batch,
            f"{label}: served launches {served['launches']}, expected {per_batch}")
    rec = np.arange(NUM_RECEIVERS)
    batches = [infer._device_batch(rec[k:k + BATCH]) for k in range(0, NUM_RECEIVERS, BATCH)]
    td = td_check(label, infer.model, batches, tc.num_freq_bins, cfg.sample_rate,
                  OPTIONS_TD["c"], tc.reduced_pole_radius)
    result.update(srirs_shape=list(served["rirs"].shape), served_launches=served["launches"],
                  srirs_per_s=served["rirs_per_s"], serve_s=served["serve_s"],
                  rel_l2_vs_plain=served["rel_l2_vs_plain"],
                  edc_max_abs_db_vs_plain=served["edc_max_abs_db_vs_plain"], **td)
    del infer, served
    torch.cuda.empty_cache()
    return result, rows


def band_options(tmp: Path) -> dict:
    """Phase 14 (d): one band-parallel step of the first 2-band group of the
    subband presets (32 kHz, nfft 131072, batch 32) with SVF heads and the
    three loss options, on the kernels and on the plain versions (losses
    LOSS_TOL, every band's gradients GRAD_TOL), its launches counted."""
    import torch

    from diffgfdn_torch.cli import run_subband_training as rst
    from diffgfdn_torch.data.batching import arrays_from_room_dataset, train_valid_split
    from diffgfdn_torch.kernels.dispatch import plain_versions

    fs, nfft = SUBBAND_FS, SUBBAND_NFFT
    room = make_room(tmp, "subband", fs, nfft)
    configs = [rst.create_config(f, str(tmp / "subband" / "srirs.pkl"),
                                 str(tmp / "options" / "band"), nfft, sample_rate=fs,
                                 max_epochs=TRAIN_EPOCHS, batch_size=BATCH)
               for f in rst.DEFAULT_FREQS]
    group = rst.architecture_groups(configs)[0]
    for cfg in group:
        cfg.output_filter_config.use_svfs = True
        tc = cfg.trainer_config
        tc.use_reg_loss = tc.use_erb_edr_loss = tc.use_frequency_weighting = True
    arrays = arrays_from_room_dataset(room)
    train_idx, _ = train_valid_split(np.arange(arrays.num_items),
                                     group[0].trainer_config.train_valid_split,
                                     seed=group[0].seed)
    trainer = rst.band_parallel_trainer(group, room, arrays, train_idx, DEVICE)
    idx = torch.arange(BATCH, device=DEVICE)
    reset_counts()
    loss_k, losses = trainer.loss_and_grads(idx)
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    grads_k = {n: p.grad.clone() for n, p in trainer.params.items()}
    with plain_versions():
        loss_p, _ = trainer.loss_and_grads(idx)
    grads_p = {n: p.grad.clone() for n, p in trainer.params.items()}
    loss_rel = float(torch.max(torch.abs(loss_k - loss_p) / torch.abs(loss_p)))
    grad_errs = {(n, b): rel_l2(grads_k[n][b], grads_p[n][b])
                 for n in grads_k for b in range(len(group))}
    worst = max(grad_errs, key=grad_errs.get)
    freqs = [c.trainer_config.subband_process_config.centre_frequency for c in group]
    require({"edc_loss", "edr_loss", "reg_loss"} <= set(losses)
            and all(bool(torch.isfinite(v).all()) for v in losses.values()),
            f"band-parallel options {freqs}: losses {losses}")
    require({"cinv", "neg_ptgpt", "sos", "sos_backward"} <= set(launches),
            f"band-parallel options {freqs}: launches {launches}")
    require(loss_rel <= LOSS_TOL and grad_errs[worst] <= GRAD_TOL,
            f"band-parallel options {freqs}: kernels vs plain loss {loss_rel}, gradient "
            f"{worst} {grad_errs[worst]}")
    out = {"bands_hz": freqs, "launches": launches,
           "losses": {k: v.tolist() for k, v in losses.items()},
           "step_loss_rel_vs_plain": loss_rel, "max_grad_rel_l2_vs_plain": grad_errs[worst]}
    del trainer
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def float64_iir(model):
    """Within the block, the model's IIR absorption responses are evaluated
    from the designed float64 coefficients in complex128 (the time domain
    builds its state-space constants from them in float64 too). The served
    frequency path evaluates them as the JAX package does, in complex64 from
    float32 coefficients: for order-8 warped-Prony filters that leaves an
    error floor some 57 dB below the peak (ROADMAP C19)."""
    import functools

    import torch

    from diffgfdn_torch.models import feedback_loop as fl_mod

    fl = model.feedback_loop
    coeffs, response = fl.iir_coeffs, fl_mod.iir_frequency_response
    fl.iir_coeffs = torch.as_tensor(fl.iir_coeffs_host, dtype=torch.float64,
                                    device=coeffs.device)
    fl_mod.iir_frequency_response = functools.partial(response, dtype=torch.complex128)
    try:
        yield
    finally:
        fl.iir_coeffs, fl_mod.iir_frequency_response = coeffs, response


def prony_option(tmp: Path) -> dict:
    """Phase 14 (e): a ``fullband_grid_colorless`` model whose absorption is
    ``absorption_arrays(use_prony=True)`` of the grid's per-band decay times
    (warped-Prony IIR filters of order 8), seeded weights: 96 receivers'
    RIRs served through the model's synthesis function (launches per batch
    as OPTIONS_SERVE["e"], against the plain path) and synthesized in the
    time domain (the filtered block path of ``filter_bank_from_iir``)."""
    import torch

    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.data.batching import arrays_from_room_dataset
    from diffgfdn_torch.inference import make_rir_synthesis_fn, make_time_domain_synthesis_fn
    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.models import DiffGFDNVarReceiverPos
    from diffgfdn_torch.training.build import absorption_arrays
    from diffgfdn_torch.training.trainer import upload_model_inputs

    cfg = preset_config(OPTIONS_BASE)
    tc, out_cfg = cfg.trainer_config, cfg.output_filter_config
    fs = cfg.sample_rate
    room = make_room(tmp, OPTIONS_BASE, fs, tc.num_freq_bins)
    t0 = time.perf_counter()
    kw = absorption_arrays(cfg, room.common_decay_times, room.band_centre_hz, use_prony=True)
    fit_s = time.perf_counter() - t0
    require(kw["iir_coeffs"] is not None and kw["iir_coeffs"].shape == (12, 9, 2),
            f"Prony absorption: {None if kw['iir_coeffs'] is None else kw['iir_coeffs'].shape}")
    model = DiffGFDNVarReceiverPos(
        sample_rate=fs, num_groups=cfg.num_groups, delays=cfg.delay_length_samps,
        coupling_matrix_type=cfg.feedback_loop_config.coupling_matrix_type,
        use_zero_coupling=cfg.feedback_loop_config.use_zero_coupling,
        generator=torch.Generator().manual_seed(cfg.seed), use_svf_in_output=out_cfg.use_svfs,
        num_fourier_features=out_cfg.num_fourier_features,
        num_hidden_layers=out_cfg.num_hidden_layers, num_neurons=out_cfg.num_neurons_per_layer,
        **kw).to(DEVICE).eval()
    data = upload_model_inputs(arrays_from_room_dataset(room), torch.device(DEVICE))
    rec = torch.arange(NUM_RECEIVERS, device=DEVICE)
    batches = [{k: v if k in ("z_values", "mesh_2d") else v[rec[j:j + BATCH]]
                for k, v in data.items()} for j in range(0, NUM_RECEIVERS, BATCH)]
    synth = make_rir_synthesis_fn(model)
    synth(batches[0])  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    rirs = np.concatenate([synth(b).cpu().numpy() for b in batches])
    launches = {k: v for k, v in launch_counts().items() if v}
    per_batch = {k: v * len(batches) for k, v in OPTIONS_SERVE["e"].items()}
    require(launches == per_batch, f"Prony: served launches {launches}, expected {per_batch}")
    require(bool(np.isfinite(rirs).all()), "Prony: non-finite RIRs")
    edc = edc_db(rirs)
    drop = edc[:, int(0.05 * fs)] - edc[:, int(1.0 * fs)]
    require(bool((drop > 10.0).all()), f"Prony: RIRs do not decay (min drop {drop.min()} dB)")
    with plain_versions():
        plain = np.concatenate([synth(b).cpu().numpy() for b in batches])
    rel = float(np.linalg.norm(rirs - plain) / np.linalg.norm(plain))
    edc_err = float(np.abs(edc - edc_db(plain))[:, : int(0.5 * fs)].max())
    require(rel <= RIR_TOL and edc_err <= EDC_TOL_DB,
            f"Prony: served vs plain rel L2 {rel}, EDC {edc_err} dB")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for b in batches:
            synth(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    td = td_check("Prony absorption", model, batches, tc.num_freq_bins, fs, OPTIONS_TD["e"],
                  tc.reduced_pole_radius, lambda: float64_iir(model))
    # the served frequency path's own error against the time domain, unbounded
    td_rirs = np.concatenate([s.cpu().numpy() for s in map(
        make_time_domain_synthesis_fn(model, tc.num_freq_bins), batches)])
    freq32 = np.concatenate([synth({k: v for k, v in b.items() if k != "target_early_response"})
                             .cpu().numpy() for b in batches])
    td["served_freq_path_max_abs_over_peak_vs_td"] = float(
        np.abs(td_rirs - freq32).max() / np.abs(td_rirs).max())
    td["served_freq_path_edc_max_abs_db_vs_td"] = float(
        np.abs(edc_db(td_rirs) - edc_db(freq32))[:, : int(0.5 * fs)].max())
    out = {"part": "e", "model": f"{OPTIONS_BASE} with warped-Prony absorption",
           "iir_coeffs_shape": list(kw["iir_coeffs"].shape), "fit_s": fit_s,
           "served_launches": launches, "rirs_per_s": NUM_RECEIVERS / float(np.median(times)),
           "serve_s": times, "rel_l2_vs_plain": rel, "edc_max_abs_db_vs_plain": edc_err, **td}
    del model, data, batches
    torch.cuda.empty_cache()
    return out


def reg_cotangent_errors(num, den, w, g, h) -> dict:
    """B4 at the regularizer's inputs and cotangent: the kernel against its
    plain version, and the plain version in float32 against float64, each
    the largest error over the largest float64 (or plain) value of dnum and
    dden."""
    import torch

    from diffgfdn_torch.kernels import sos as sos_mod
    from diffgfdn_torch.kernels.dispatch import plain_versions

    kernel = sos_mod.sos_cascade_backward(num, den, w, g, h)
    with plain_versions():
        plain = sos_mod.sos_cascade_backward(num, den, w, g, h)
        wide = sos_mod.sos_cascade_backward_plain(
            num.double(), den.double(), w.to(torch.complex128), g.to(torch.complex128),
            h.to(torch.complex128))
    return {"kernel_vs_plain": max(rel_err(a, b) for a, b in zip(kernel, plain)),
            "plain_vs_float64": max(rel_err(a.double(), b) for a, b in zip(plain, wide)),
            "kernel_vs_float64": max(rel_err(a.double(), b) for a, b in zip(kernel, wide))}


def options(tmp: Path, log_dir) -> tuple:
    """Phase 14: every coupling, absorption, encoding and loss option of the
    config at full width on the card, parts (a)-(e). Returns (results,
    kernel rows)."""
    import torch

    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.config.schema import CouplingMatrixType, FeatureEncodingType

    results, rows = [], []
    for part, svf in (("a", True), ("b", False)):
        cfg = preset_config(OPTIONS_BASE)
        cfg.feedback_loop_config.coupling_matrix_type = CouplingMatrixType.FILTER
        cfg.output_filter_config.use_svfs = svf
        n = len(cfg.delay_length_samps)
        label = f"{OPTIONS_BASE} filter_matrix {'svf' if svf else 'scalar'} heads"
        kernels = ("cinv", "neg_ptgpt") if svf else ("lu", "lut_apply")
        select = {k: option_shape(k, n) for k in kernels}
        result, launches, inputs = grid_option(part, label, cfg, tmp, log_dir, select)
        inputs = {k: inputs[k] for k in kernels}
        part_rows = (slice_rows(label, inputs, launches) if svf
                     else solve_rows(label, inputs, launches))
        for row, kernel in zip(part_rows, kernels):
            row["launches_per_step"] = result["launches_per_step"][kernel]
        rows += part_rows
        results.append(result)
        print(f"phase 14 ({part}): " + json.dumps(result), flush=True)
    result, part_rows = coupled_directional(tmp, log_dir)
    rows += part_rows
    results.append(result)
    print("phase 14 (c): " + json.dumps(result), flush=True)

    cfg = preset_config(OPTIONS_BASE)
    cfg.decay_filter_config.learn_common_decay_times = True
    for head in (cfg.output_filter_config, cfg.input_filter_config):
        head.encoding_type = FeatureEncodingType.MESHGRID
    tc = cfg.trainer_config
    tc.use_reg_loss = tc.use_erb_edr_loss = tc.use_frequency_weighting = True
    reg_bins = int(tc.output_filt_ir_len_ms * 1e-3 * cfg.sample_rate) // 2 + 1
    label = f"{OPTIONS_BASE} learned decays, meshgrid, reg / ERB / weighted EDR"
    select = {k: option_shape(k, bins=reg_bins) for k in ("sos", "sos_backward")}
    result, launches, inputs = grid_option("d", label, cfg, tmp, log_dir, select)
    # over the preset's 500 ms the regularizer's cotangent of the cascades is
    # float32 rounding (ROADMAP C19): the coefficient sums of B4 then cancel
    # to rounding in any float32 order. Its agreement there is printed; B4 is
    # held to its plain version on the path's cascades with a seeded cotangent
    num, den, w, g, h = inputs["sos_backward"]
    result["reg_b4_path_cotangent"] = reg_cotangent_errors(num, den, w, g, h)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    seeded = torch.complex(torch.randn(g.shape, generator=gen, device=DEVICE),
                           torch.randn(g.shape, generator=gen, device=DEVICE))
    part_rows = slice_rows(label, {"sos": inputs["sos"],
                                   "sos_backward": (num, den, w, seeded, h)}, launches)
    for row, kernel in zip(part_rows, ("sos", "sos_backward")):
        row["launches_per_step"] = result["launches_per_step"][kernel]
        row["launches_per_step_at_this_shape"] = 1.0
    rows += part_rows
    result["band_parallel"] = band_options(tmp)
    results.append(result)
    print("phase 14 (d): " + json.dumps(result), flush=True)
    result = prony_option(tmp)
    results.append(result)
    print("phase 14 (e): " + json.dumps(result), flush=True)
    return results, rows


# ------------------------------- phase 15: tools -------------------------------

INSPECT_TOL_DB = 0.01  # inspect's metrics, kernels vs plain versions on the card
CSOLVE_SHAPES = ((3 * 65537, 4), (65537, 12))  # (K, N): the fullband blocks, a FILTER loop
CSOLVE_RHS = 3
CSOLVE_SOLVE_TOL = 1e-4  # vs torch.linalg.solve, relative L2
CSOLVE_GRAD_TOL = 1e-5  # gradients vs the plain versions', relative L2
INT8_RECEIVERS = 288  # 2 s at 32 kHz: 73.7 MB of float32 targets, past 64 MiB
TOOLS_CS_RESOLUTION_M = 0.9
TOOLS_CS_EPOCHS = 2
BARY_TOL_DB = 1e-10  # barycentric EDC-error maps, card vs CPU run
INSPECT_FIGURES = ("edc_error_map.png", "edr_error_map.png", "coupling_matrix.png")
INSPECT_TAGGED = ("edc_overlay", "edr_true", "edr_synth", "echo_density")


def matplotlib_present() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


@contextlib.contextmanager
def timed_serving(times: list):
    """Within the block, each ``InferDiffGFDN.rirs_at`` call's wall time
    (host arrays out: the card is done) is appended to ``times``."""
    from diffgfdn_torch.inference import InferDiffGFDN

    original = InferDiffGFDN.rirs_at

    def rirs_at(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = original(self, *args, **kwargs)
        times.append(time.perf_counter() - t0)
        return out

    InferDiffGFDN.rirs_at = rirs_at
    try:
        yield
    finally:
        InferDiffGFDN.rirs_at = original


def inspect_cli(tmp: Path, name: str, cfg, room, cs: bool) -> dict:
    """(a) with matplotlib: ``inspect_checkpoint.main`` by preset name from a
    working directory holding phase 2's dataset (with the room's decay
    times) and checkpoint at the preset's paths; its figures checked."""
    import os
    import pickle

    from diffgfdn_torch.cli import inspect_checkpoint
    from diffgfdn_torch.config import preset_config

    work = tmp / "tools_cli" / name
    data = work / cfg.room_dataset_path
    data.parent.mkdir(parents=True, exist_ok=True)
    with open(tmp / name / "srirs.pkl", "rb") as f:
        raw = pickle.load(f)
    raw.update(common_decay_times=np.asarray(room.common_decay_times),
               band_centre_hz=room.band_centre_hz)
    with open(data, "wb") as f:
        pickle.dump(raw, f)
    ckpt = work / preset_config(name).trainer_config.train_dir  # the preset's own path
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    ckpt.symlink_to(tmp / name / "train")
    out = tmp / "tools_cli" / f"{name}_figures"
    here = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        inspect_checkpoint.main(["-c", name, "--max-receivers", str(NUM_RECEIVERS), "--out",
                                 str(out), "--device", DEVICE]
                                + (["--cs-baseline"] if cs else []))
        cli_s = time.perf_counter() - t0
    finally:
        os.chdir(here)
    files = sorted(p.name for p in out.iterdir())
    require(all(f in files for f in INSPECT_FIGURES)
            and all(any(f.startswith(t) for f in files) for t in INSPECT_TAGGED),
            f"{name}: inspect_checkpoint wrote {files}")
    return {"cli_s": cli_s, "figures": len(files)}


def inspect_checkpoints(tmp: Path, rooms: dict, serve_launches: dict, plots: bool) -> dict:
    """(a): the metrics step of ``cli/inspect_checkpoint.py`` on phase 2's
    checkpoints, on the kernels and on the plain versions; the CLI with
    matplotlib."""
    import torch

    from diffgfdn_torch.cli import inspect_checkpoint
    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.kernels.dispatch import plain_versions

    out = {}
    for name in CONFIGS:
        cfg = preset_config(name)
        cfg.trainer_config.train_dir = str(tmp / name / "train")
        room = rooms[name]
        cs = name == "three_room_example"  # the baseline reads one decay time a slope

        def metrics():
            return inspect_checkpoint.inspect_metrics(cfg, room, max_receivers=NUM_RECEIVERS,
                                                      cs_baseline=cs, device=DEVICE).metrics

        serving = []
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with timed_serving(serving):
            got = metrics()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts().items() if v}
        require(launches == serve_launches[name],
                f"{name}: inspect launched {launches}, phase 2 served the same receivers "
                f"with {serve_launches[name]}")
        with plain_versions():
            plain = metrics()
        db_keys = [k for k in got if k.endswith("_db")]
        errs = {k: abs(got[k] - plain[k]) for k in db_keys}
        require(all(np.isfinite(v) for v in got.values()), f"{name}: inspect metrics {got}")
        require(max(errs.values()) <= INSPECT_TOL_DB and got["rec_index"] == plain["rec_index"]
                and got["coupling_diagonal_measure"] == plain["coupling_diagonal_measure"],
                f"{name}: inspect metrics kernels {got} vs plain {plain}")
        result = {"metrics": got, "abs_db_vs_plain": errs, "launches": launches,
                  "wall_s": wall, "serve_s": sum(serving), "serving_share": sum(serving) / wall,
                  "rirs_per_s": NUM_RECEIVERS / sum(serving)}
        if plots:
            result.update(inspect_cli(tmp, name, cfg, room, cs))
        out[name] = result
    if not plots:
        print("phase 15 (a): matplotlib: absent; ran the metrics step", flush=True)
    return out


def csolve_check() -> dict:
    """(b): ``kernels.csolve`` forward and backward at the path shapes:
    launches, the plain versions, ``torch.linalg.solve``, times."""
    import torch

    from diffgfdn_torch.kernels import csolve
    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.kernels.linalg import cinv

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {}
    for k, n in CSOLVE_SHAPES:
        m = 0.4 * torch.randn((k, n, n), dtype=torch.complex64, device=DEVICE, generator=gen)
        m = m + 2.0 * torch.eye(n, device=DEVICE)
        m[: k // 3, 0, 0] = 0.0  # zero leading pivots: elimination must pivot
        b = torch.randn((k, n, CSOLVE_RHS), dtype=torch.complex64, device=DEVICE, generator=gen)
        w = torch.randn((k, n, CSOLVE_RHS), device=DEVICE, generator=gen)

        def solve_and_grad():
            mm, bb = m.clone().requires_grad_(), b.clone().requires_grad_()
            x = csolve(mm, bb)
            torch.sum(w * torch.abs(x) ** 2).backward()
            return x.detach(), mm.grad, bb.grad

        torch.cuda.synchronize()
        reset_counts()
        x, gm, gb = solve_and_grad()
        torch.cuda.synchronize()
        launches = {key: v for key, v in launch_counts().items() if v}
        require(launches == {"cinv": 1, "neg_ptgpt": 1},
                f"csolve {(k, n)}: launched {launches}, not B1 and B2 once each")
        with plain_versions():
            xp, gmp, gbp = solve_and_grad()
        ref = torch.linalg.solve(m, b)
        p = cinv(m)  # csolve's two parts, timed apart below
        solve_rel = rel_l2(x, ref)
        grad_rel = max(rel_l2(gm, gmp), rel_l2(gb, gbp))
        require(torch.equal(x, xp), f"csolve {(k, n)}: not bit for bit with the plain versions")
        require(solve_rel <= CSOLVE_SOLVE_TOL and grad_rel <= CSOLVE_GRAD_TOL,
                f"csolve {(k, n)}: vs torch.linalg.solve {solve_rel}, gradients vs plain "
                f"{grad_rel}")
        out[f"{k}x{n}x{n}"] = {
            "launches": launches, "rel_l2_vs_linalg_solve": solve_rel,
            "grad_rel_l2_vs_plain": grad_rel, "bit_equal_plain": True,
            "csolve_ms": device_ms(lambda: csolve(m, b)),
            "inverse_ms": device_ms(lambda: cinv(m)),
            "product_ms": device_ms(lambda: p @ b),
            "linalg_solve_ms": device_ms(lambda: torch.linalg.solve(m, b)),
            "csolve_with_backward_ms": device_ms(solve_and_grad, reps=5),
        }
    return out


def int8_targets(tmp: Path) -> dict:
    """(c): the int8 codec on a grid past 64 MiB: the uploaded targets bit for
    bit with the host's dequantization, the upload, one graphed step."""
    import torch

    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.data import arrays_from_room_dataset
    from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer
    from diffgfdn_torch.training.optim import make_optimizer
    from diffgfdn_torch.training.trainer import target_rirs
    from diffgfdn_torch.utils import cio

    name = "fullband_grid_colorless"
    cfg = preset_config(name)
    tc = cfg.trainer_config
    tc.train_dir = str(tmp / "int8" / "train")
    t0 = time.perf_counter()
    room = make_room(tmp, name, cfg.sample_rate, tc.num_freq_bins, INT8_RECEIVERS, "int8")
    arrays = arrays_from_room_dataset(room)
    data_s = time.perf_counter() - t0
    rirs = room.rirs32
    require(rirs.nbytes >= cio.QUANT_MIN_BYTES,
            f"int8: {rirs.nbytes} bytes of targets, under the {cio.QUANT_MIN_BYTES} threshold")
    q, scale, t = cio.quantize_int8_blocks(rirs)
    host = (q.astype(np.float32) * scale).reshape(q.shape[0], -1)[:, :t]
    nfft = tc.num_freq_bins
    upload = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = target_rirs(arrays, nfft, torch.device(DEVICE))
        torch.cuda.synchronize()
        upload.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact = torch.as_tensor(rirs, device=DEVICE)
    torch.cuda.synchronize()
    float32_s = time.perf_counter() - t0
    n = min(t, nfft)  # zero padded (or cut) to nfft, as the trainer takes them
    require(torch.equal(dev[:, :n].cpu(), torch.from_numpy(host[:, :n]))
            and not bool(dev[:, n:].any()),
            "int8: the uploaded targets differ from the host's dequantization")
    quant_err = float((dev[:, :n] - exact[:, :n]).abs().max() / exact[:, :n].abs().max())
    del dev, exact

    model = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz, device=DEVICE)
    trainer = GFDNTrainer(model, tc, 1, common_decay_times=room.common_decay_times,
                          sample_rate=cfg.sample_rate, device=DEVICE)
    trainer.optimizer, trainer.scheduler = make_optimizer(tc, model, 1)
    trainer.precompute_target_features(arrays)
    trainer.upload_arrays(arrays)
    idx = torch.arange(min(BATCH, INT8_RECEIVERS), device=DEVICE)
    reset_counts()
    losses = [float(trainer.fit_step(idx)[0]) for _ in range(3)]
    launches = {k: v for k, v in launch_counts().items() if v}
    graph = trainer.graphs.get("train")
    require(graph is not None and graph.captured and graph.replays > 0,
            "int8: the fullband step was not captured and replayed")
    require(all(np.isfinite(losses)), f"int8: step losses {losses}")
    require(all(launches.get(k, 0) > 0 for k in TRAIN_KERNELS[name]),
            f"int8: the steps launched {launches}")
    return {"receivers": INT8_RECEIVERS, "float32_bytes": rirs.nbytes,
            "int8_bytes": q.nbytes + scale.nbytes, "upload_s": upload,
            "float32_upload_s": float32_s, "max_abs_err_over_peak": quant_err,
            "data_s": data_s, "step_losses": losses, "launches": launches}


def compare_baselines_check(tmp: Path, plots: bool) -> dict:
    """(d): ``cli/compare_baselines.py``'s comparison on phase 9's grid, on the
    card; the barycentric maps against a CPU run serving the card's model."""
    import torch

    from diffgfdn_torch.cli import compare_baselines
    from diffgfdn_torch.data import generate_spatial_three_room_pickle
    from diffgfdn_torch.data.naf import load_pickle_tolerant

    path = tmp / "directional" / "srirs.pkl"
    if not path.exists():  # phase 8's grid, when phase 15 runs alone
        generate_spatial_three_room_pickle(
            path, fs=SPATIAL_FS, grid_spacing_m=DIRECTIONAL_GRID_M, rir_len_s=DIRECTIONAL_RIR_S,
            decay_times=DIRECTIONAL_DECAYS, seed=SEED)
    maps = {}
    original = compare_baselines.edc_error_db

    def run(out: Path, device: str, train_dir=None, export_naf=True):
        store = maps.setdefault(device, [])

        def record(ref, pred, mix):
            store.append(original(ref, pred, mix))
            return store[-1]

        compare_baselines.edc_error_db = record
        try:
            return compare_baselines.compare(str(path), str(out), TOOLS_CS_RESOLUTION_M,
                                             train_dir=train_dir, max_epochs=TOOLS_CS_EPOCHS,
                                             export_naf=export_naf, device=device)
        finally:
            compare_baselines.edc_error_db = original

    out = tmp / "tools_compare"
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    summary, err, valid_pos, room = run(out, DEVICE)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    require(all(v == 0 for v in launch_counts().values()),
            f"compare_baselines: hand-written kernels launched {launch_counts()}")
    values = [summary["common_slopes_model_mean_edc_error_db"],
              summary["barycentric_mean_edc_error_db"]]
    values += summary["common_slopes_model_per_direction_db"]
    values += summary["barycentric_per_direction_db"]
    require(bool(np.isfinite(values).all()), f"compare_baselines: summary {summary}")
    train = load_pickle_tolerant(summary["naf_exports"]["naf_train"])
    infer = load_pickle_tolerant(summary["naf_exports"]["naf_infer"])
    require(train.rirs.shape[0] == summary["num_train"]
            and infer.receiver_position.shape[0] == summary["num_heldout"],
            "compare_baselines: the NAF exports do not hold the split")
    t0 = time.perf_counter()
    run(tmp / "tools_compare_cpu", "cpu", train_dir=str(out / "cs_model"), export_naf=False)
    cpu_s = time.perf_counter() - t0
    bary_err = float(np.abs(maps[DEVICE][1] - maps["cpu"][1]).max())
    require(bary_err <= BARY_TOL_DB, f"compare_baselines: barycentric maps card vs CPU {bary_err}")
    result = {"summary": {k: v for k, v in summary.items() if k != "naf_exports"},
              "card_s": card_s, "cpu_serve_s": cpu_s, "barycentric_max_abs_db_card_vs_cpu": bary_err,
              "model_max_abs_db_card_vs_cpu_noise_differs": float(
                  np.abs(maps[DEVICE][0] - maps["cpu"][0]).max())}
    if plots:
        compare_baselines.plot_error_maps(err, valid_pos, room, TOOLS_CS_RESOLUTION_M, str(out))
        require(all((out / f"edc_error_map_{m}.png").exists()
                    for m in ("common_slopes_model", "barycentric")),
                "compare_baselines: the maps were not written")
    return result


def trace_check(tmp: Path, rooms: dict, log_dir) -> dict:
    """(e): ``utils/profiling.trace`` around one served batch of the
    three-room model (B5) writes a Chrome trace that holds the kernel."""
    import torch

    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.inference import InferDiffGFDN
    from diffgfdn_torch.utils import profiling

    name = "three_room_example"
    cfg = preset_config(name)
    cfg.trainer_config.train_dir = str(tmp / name / "train")
    infer = InferDiffGFDN(cfg, rooms[name], device=DEVICE)
    idx = np.arange(BATCH)
    infer.rirs_at(idx, BATCH)
    torch.cuda.synchronize()
    where = Path(log_dir) / "trace" if log_dir is not None else tmp / "trace"
    t0 = time.perf_counter()
    with profiling.trace(str(where)):
        infer.rirs_at(idx, BATCH)
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    path = where / profiling.TRACE_FILE
    text = path.read_text()
    require("lu_solve_kernel" in text, f"the trace {path} holds no B5")
    return {"trace_bytes": path.stat().st_size, "traced_s": traced_s}


def tools(tmp: Path, log_dir, rooms: dict, serve_launches: dict) -> dict:
    """Phase 15: (a)-(e) of the module docstring; returns their results."""
    plots = matplotlib_present()
    result = {"matplotlib": plots}
    for part, run in (("a", lambda: inspect_checkpoints(tmp, rooms, serve_launches, plots)),
                      ("b", csolve_check), ("c", lambda: int8_targets(tmp)),
                      ("d", lambda: compare_baselines_check(tmp, plots)),
                      ("e", lambda: trace_check(tmp, rooms, log_dir))):
        t0 = time.perf_counter()
        result[part] = run()
        result[part]["part_s"] = time.perf_counter() - t0
        print(f"phase 15 ({part}): " + json.dumps(result[part]), flush=True)
    return result


# ------------------- phase 16: ranks (torch.distributed) -------------------

PARALLEL_SINGLE_RIR = "single_rir_example"
PARALLEL_EPOCHS = 3  # the frequency-sharded fit's epochs
PARALLEL_BAND_STEPS = 2  # band-parallel steps of each group on its mesh
PARALLEL_TIMED = 3  # timed steps of each path
PARALLEL_SPATIAL = "spatial_directional_1000Hz"
PARALLEL_SPATIAL_RES = 0.9
PARALLEL_SPATIAL_EPOCHS = 2  # the second epoch's time is the steady one
SHARD_LOSS_TOL = 1e-6  # sharded vs unsharded loss, relative
SHARD_GRAD_TOL = 1e-3  # sharded vs unsharded gradients on the card, relative L2
# parameters after one Adam step from zero moments, relative L2: a first
# step moves each element by the learning rate times its gradient's sign, so
# an element whose gradient is summation-order noise can flip (1.04e-6 on
# the card where the CPU test reads 7e-9: ROADMAP C21)
SHARD_ADAM_TOL = 1e-5
SHARD_FIT_TOL = 1e-5  # parameters after the batch-sharded epoch, relative L2
MXU_PEAK_TOL = 1e-5  # matmul irfft vs torch.fft.irfft: max abs error / max |irfft|
MXU_LOSS_TOL = 1e-5  # the directional loss with and without the matmul irfft, relative
# B1-B4 launches a frequency-sharded step; B1, B2, B3, B5, B6 a band step
SHARD_STEP_KERNELS = {"cinv": 1, "neg_ptgpt": 1, "sos": 2, "sos_backward": 2}
BAND_STEP_KERNELS = {"cinv": 1, "neg_ptgpt": 1, "sos": 1, "lu": 1, "lut_apply": 1}


def parallel_data(tmp: Path) -> dict:
    """Phase 16's inputs on disk, made where an earlier phase has not made
    them: the single-RIR preset's wav, phase 7's 96-receiver grid at 32
    kHz, phase 8's spatial grid."""
    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.data import generate_spatial_three_room_pickle, write_wav

    cfg = preset_config(PARALLEL_SINGLE_RIR)
    work = tmp / "parallel" / "single_rir"
    wav = work / cfg.ir_path
    wav.parent.mkdir(parents=True, exist_ok=True)
    write_wav(wav, two_slope_rir(cfg.sample_rate), cfg.sample_rate)
    if not (tmp / "subband" / "srirs.pkl").exists():
        make_room(tmp, "subband", SUBBAND_FS, SUBBAND_NFFT)
    spatial = tmp / "directional" / "srirs.pkl"
    if not spatial.exists():
        generate_spatial_three_room_pickle(
            spatial, fs=SPATIAL_FS, grid_spacing_m=DIRECTIONAL_GRID_M,
            rir_len_s=DIRECTIONAL_RIR_S, decay_times=DIRECTIONAL_DECAYS, seed=SEED)
    return {"tmp": str(tmp), "single_rir_work": str(work), "wav": str(wav),
            "spatial": str(spatial)}


def subband_room(tmp: Path):
    """Phase 7's grid read back, with its per-band decay times (as make_room sets them)."""
    from diffgfdn_torch.data import ThreeRoomDataset

    base = np.random.RandomState(SEED).uniform(0.6, 1.5, 3)
    room = ThreeRoomDataset(tmp / "subband" / "srirs.pkl", nfft=SUBBAND_NFFT)
    room.common_decay_times = base[None, :] * np.linspace(1.2, 0.8, 8)[:, None]
    room.band_centre_hz = [63.0, 125.0, 250.0, 500.0, 1000.0, 2000.0, 4000.0, 8000.0]
    return room


def flat_params(named) -> "torch.Tensor":
    import torch

    return torch.cat([p.detach().reshape(-1).float() for _, p in named])


def same_on_every_rank(x, group) -> bool:
    """True when ``x`` is bit for bit the same tensor on every rank of ``group``."""
    import torch
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return all(torch.equal(p, parts[0]) for p in parts)


def timed_steps(step, n: int = PARALLEL_TIMED, warmup: int = 2) -> list:
    """Wall time (ms) of ``n`` calls of ``step`` after ``warmup`` untimed ones
    (a graphed step's warm-up and capture), the card synchronized around each."""
    import torch

    for _ in range(warmup):
        step()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def shard_single_rir(spec: dict, mesh, device, rows: list) -> dict:
    """(a): ``single_rir_example`` fit through ``run_training_single_pos``
    with its bins sharded over the mesh, then one step against an unsharded
    trainer from the same parameters. Rank 0 appends the shard shapes'
    kernel rows to ``rows``."""
    import torch

    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.data import RIRData
    from diffgfdn_torch.losses import edc_mask
    from diffgfdn_torch.parallel import all_reduce_grads
    from diffgfdn_torch.training import build_gfdn_model, make_optimizer, SinglePosGFDNTrainer
    from diffgfdn_torch.training.solver import run_training_single_pos, single_pos_batch
    from diffgfdn_torch.utils.params import jax_params_from_torch, load_jax_params

    cfg = preset_config(PARALLEL_SINGLE_RIR)
    tc = cfg.trainer_config
    tc.max_epochs = PARALLEL_EPOCHS
    tc.train_dir = str(Path(spec["single_rir_work"]) / f"train_{spec['run']}")
    cdt = np.array([0.5] * cfg.num_groups)
    data = RIRData.from_wav(spec["wav"], common_decay_times=cdt, nfft=tc.num_freq_bins)
    bins = data.num_freq_bins // 2 + 1
    reset_counts()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    trainer, model = run_training_single_pos(cfg, data, device=device, freq_mesh=mesh)
    torch.cuda.synchronize(device)
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    epochs = len(trainer.train_loss)
    expected = {"cinv": epochs + 1, "neg_ptgpt": epochs, "sos": 2 * epochs,
                "sos_backward": 2 * epochs, "lu": 0, "lut_apply": 0, "tdgfdn": 0}
    require(epochs == PARALLEL_EPOCHS and bool(np.isfinite(trainer.train_loss).all()),
            f"(a): losses {trainer.train_loss}")
    require({k: launches[k] for k in expected} == expected,
            f"(a): launches {launches}, expected {expected}")
    require(trainer.used_freq_parallel, "(a): the fit did not shard its bins")
    require(same_on_every_rank(flat_params(model.named_parameters()), mesh.batch_group),
            "(a): the parameters differ across ranks after the fit")
    graphs = trainer.graphs.get("train")
    replays = 0 if graphs is None else graphs.replays
    require(not trainer.scan_epochs or replays > 0, "(a): the sharded step was not replayed")

    # one step from the same parameters and mask: sharded against unsharded
    other = build_gfdn_model(cfg, cdt, variant="single_pos", device=device)
    load_jax_params(other, jax_params_from_torch(model))
    unsharded = SinglePosGFDNTrainer(other, tc, 1, common_decay_times=cdt,
                                     sample_rate=cfg.sample_rate, device=device)
    unsharded.upload_batch(single_pos_batch(cfg, data))
    mask = None
    if tc.use_edc_mask:
        mask = edc_mask(unsharded.edc_mask_length(bins),
                        torch.Generator(device=device).manual_seed(SEED), device)
    trainer._step_mask = mask
    inputs = {}
    params = list(model.parameters())
    for p in params:
        p.grad = None
    with recording_kernel_inputs(inputs, forward=True):
        loss_s, _ = trainer._sharded_losses(trainer.data, trainer._shard)
        loss_s.backward()
    all_reduce_grads(params, mesh.batch_group)
    loss_u, _ = unsharded.loss_and_grads(unsharded.data, mask)
    loss_rel = abs(float(loss_s.detach()) - float(loss_u)) / abs(float(loss_u))
    grad_errs = {n: rel_l2(p.grad, q.grad) for (n, p), q in
                 zip(model.named_parameters(), other.parameters())}
    opt_s, _ = make_optimizer(tc, model, 1)
    opt_u, _ = make_optimizer(tc, other, 1)
    opt_s.step()
    opt_u.step()
    adam_errs = {n: rel_l2(p.detach(), q.detach()) for (n, p), q in
                 zip(model.named_parameters(), other.parameters())}
    require(loss_rel <= SHARD_LOSS_TOL and max(grad_errs.values()) <= SHARD_GRAD_TOL
            and max(adam_errs.values()) <= SHARD_ADAM_TOL,
            f"(a): sharded vs unsharded: loss {loss_rel}, gradients {grad_errs}, "
            f"Adam {adam_errs}")
    shard_shape = tuple(inputs["cinv"][0].shape)
    require(shard_shape[0] == cfg.num_groups * trainer._shard.block,
            f"(a): B1 ran on {shard_shape}, not this rank's {trainer._shard.block} bins")

    # step times: the fit's trainer (sharded) and the unsharded one, each on its path
    unsharded.optimizer, unsharded.scheduler = make_optimizer(tc, other, 1)
    sharded_ms = timed_steps(lambda: trainer.fit_step())
    unsharded_ms = timed_steps(lambda: unsharded.fit_step())
    if rows is not None:
        keys = [k for k in SLICE_KERNELS if k in inputs]
        for key, row in zip(keys, slice_rows(
                f"{PARALLEL_SINGLE_RIR}, {trainer._shard.block} bins of {bins} a rank, "
                f"{mesh.size} ranks", inputs, launches)):
            row["launches_per_epoch"] = SHARD_STEP_KERNELS[key]
            rows.append(row)
    return {"bins": bins, "bins_per_rank": trainer._shard.block, "B1_shape": list(shard_shape),
            "epochs": epochs, "run_s": run_s, "losses": trainer.train_loss,
            "launches": {k: launches[k] for k in expected}, "replays": replays,
            "step_loss_rel_vs_unsharded": loss_rel,
            "max_grad_rel_l2_vs_unsharded": max(grad_errs.values()),
            "max_adam_rel_l2_vs_unsharded": max(adam_errs.values()),
            "sharded_step_ms": sharded_ms, "unsharded_step_ms": unsharded_ms}


def shard_subband(spec: dict, device, rows: list) -> dict:
    """(b): the eight subband presets' band-parallel groups (2, 4, 2 bands),
    each on ``make_mesh(len(group))``: a step's losses and gradients against
    the one-rank trainer (gathered to rank 0), the launches of each step,
    step times, and each band's checkpoint written by its owner, read back
    and continued."""
    import torch
    import torch.distributed as dist

    from diffgfdn_torch.cli import run_subband_training as rst
    from diffgfdn_torch.data.batching import arrays_from_room_dataset, train_valid_split
    from diffgfdn_torch.parallel import make_mesh, Mesh
    from diffgfdn_torch.training import load_checkpoint, save_checkpoint
    from diffgfdn_torch.training.trainer import padded_batches
    from diffgfdn_torch.utils.params import (
        flax_tree,
        stack_jax_trees,
        torch_state_from_jax,
        unstack_jax_tree,
    )

    tmp = Path(spec["tmp"])
    room = subband_room(tmp)
    base = tmp / "parallel" / "subband" / spec["run"]
    configs = [rst.create_config(f, str(tmp / "subband" / "srirs.pkl"), str(base), SUBBAND_NFFT,
                                 sample_rate=SUBBAND_FS, max_epochs=TRAIN_EPOCHS,
                                 batch_size=BATCH) for f in rst.DEFAULT_FREQS]
    groups = rst.architecture_groups(configs)
    require([len(g) for g in groups] == SUBBAND_GROUP_SIZES,
            f"(b): group sizes {[len(g) for g in groups]}")
    arrays = arrays_from_room_dataset(room)
    rank = dist.get_rank()
    out = {"groups": []}
    for gi, group in enumerate(groups):
        mesh = make_mesh(len(group))
        train_idx, _ = train_valid_split(np.arange(arrays.num_items),
                                         group[0].trainer_config.train_valid_split,
                                         seed=group[0].seed)
        trainer = rst.band_parallel_trainer(group, room, arrays, train_idx, device, mesh)
        idx = torch.as_tensor(next(padded_batches(train_idx, BATCH)), device=device)
        trainer.mask_generator.manual_seed(SEED)
        mask = trainer._edc_mask()
        inputs = {}
        with recording_kernel_inputs(inputs, forward=True):
            totals, _ = trainer.loss_and_grads(idx, mask)
        mine = {"bands": (trainer.bands.start, trainer.bands.stop),
                "totals": totals.cpu().numpy(),
                "grads": {k: p.grad.cpu().numpy() for k, p in trainer.params.items()}}
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, mine)
        group_result = {"bands": len(group), "mesh": list(mesh.shape),
                        "bands_per_rank": trainer.bands.stop - trainer.bands.start}
        one_ms = None
        if rank == 0:  # the one-rank trainer of the whole group, the same batch and mask
            one = rst.band_parallel_trainer(group, room, arrays, train_idx, device, Mesh((1, 1)))
            ref_totals, _ = one.loss_and_grads(idx, mask)
            ref_grads = {k: p.grad for k, p in one.params.items()}
            loss_rel, grad_rel = 0.0, 0.0
            for part in gathered:
                lo, hi = part["bands"]
                for b in range(lo, hi):
                    ref = float(ref_totals[b])
                    loss_rel = max(loss_rel, abs(float(part["totals"][b - lo]) - ref) / abs(ref))
                    for k, g in part["grads"].items():
                        grad_rel = max(grad_rel, rel_l2(torch.as_tensor(g[b - lo]),
                                                        ref_grads[k][b].cpu()))
            require(loss_rel <= SHARD_LOSS_TOL and grad_rel <= SHARD_GRAD_TOL,
                    f"(b) group {gi}: sharded vs one-rank loss {loss_rel}, gradients {grad_rel}")
            group_result.update(loss_rel_vs_one_rank=loss_rel,
                                max_grad_rel_l2_vs_one_rank=grad_rel)
            one_ms = timed_steps(lambda: one.step(idx))
            del one, ref_grads
        # the steps on the mesh: launches per step and times
        reset_counts()
        for _ in range(PARALLEL_BAND_STEPS):
            trainer.step(idx)
        torch.cuda.synchronize(device)
        per_step = {k: v / PARALLEL_BAND_STEPS for k, v in launch_counts().items() if v}
        require(per_step == BAND_STEP_KERNELS, f"(b) group {gi}: launches per step {per_step}")
        group_ms = timed_steps(lambda: trainer.step(idx))
        # each band's checkpoint by its owner, read back by its ranks, continued
        dirs = [Path(c.trainer_config.train_dir) for c in group]
        bands = range(trainer.bands.start, trainer.bands.stop)
        if trainer.writes_checkpoints():
            tree = flax_tree(trainer.params.items())
            for b, g in enumerate(bands):
                save_checkpoint(dirs[g], 0, unstack_jax_tree(tree, b))
        dist.barrier()
        before = flat_params(trainer.params.items())
        trainer.load_band_params(torch_state_from_jax(stack_jax_trees(
            [load_checkpoint(dirs[g], 0) for g in bands])))
        require(torch.equal(before, flat_params(trainer.params.items())),
                f"(b) group {gi}: a checkpoint read back differs")
        continued, _ = trainer.step(idx)
        require(bool(torch.isfinite(continued).all()), f"(b) group {gi}: continued {continued}")
        require(same_on_every_rank(flat_params(trainer.params.items()), mesh.batch_group),
                f"(b) group {gi}: a band's parameters differ across its ranks")
        group_result.update(launches_per_step=per_step, group_step_ms=group_ms,
                            one_rank_step_ms=one_ms)
        if rank == 0 and rows is not None and len(group) == max(SUBBAND_GROUP_SIZES):
            local = trainer.bands.stop - trainer.bands.start
            label = f"[{local} of the {len(group)}-band group, {mesh.size} ranks]"
            counts = {k: int(v) for k, v in per_step.items()} | {"sos_backward": 0}
            rows += [dict(r, name=r["name"].replace(f"[{local}-band group]", label),
                          launches_per_step=BAND_STEP_KERNELS[k])
                     for r, k in zip(band_rows(inputs, counts, local),
                                     ("cinv", "neg_ptgpt", "sos", "sos_backward", "lu",
                                      "lut_apply"))
                     if k != "sos_backward"]
        out["groups"].append(group_result)
        del trainer
        torch.cuda.empty_cache()
    return out


def shard_spatial(spec: dict, device) -> dict:
    """(c): ``spatial_directional_1000Hz`` at 0.9 m, two epochs of
    ``fit_indexed`` batch-sharded over the mesh, against the unsharded
    epochs from the same initialization (rank 0)."""
    import torch

    from diffgfdn_torch.config import spatial_preset_config
    from diffgfdn_torch.data import (
        arrays_from_spatial_dataset,
        SpatialThreeRoomDataset,
        split_by_grid_resolution,
    )
    from diffgfdn_torch.parallel import make_mesh
    from diffgfdn_torch.training import build_spatial_model, SpatialSamplingTrainer

    tmp = Path(spec["tmp"])
    room = SpatialThreeRoomDataset(spec["spatial"])
    arrays = arrays_from_spatial_dataset(room)
    train_idx, valid_idx = split_by_grid_resolution(room, PARALLEL_SPATIAL_RES)
    mesh = make_mesh(1)
    fits = {}
    for name, m in (("sharded", mesh), ("unsharded", None)):
        if m is None and mesh.index != 0:
            break
        cfg = spatial_preset_config(PARALLEL_SPATIAL, max_epochs=PARALLEL_SPATIAL_EPOCHS,
                                    train_dir=str(tmp / "parallel" / "spatial" / spec["run"]
                                                  / name))
        model = build_spatial_model(cfg, room.num_rooms, room.ambi_order, device=device)
        trainer = SpatialSamplingTrainer(model, cfg, room, grid_resolution_m=PARALLEL_SPATIAL_RES,
                                         device=device)
        reset_counts()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        trainer.fit_indexed(arrays, train_idx, valid_idx, seed=cfg.seed, mesh=m)
        torch.cuda.synchronize(device)
        require(all(v == 0 for v in launch_counts().values()),
                f"(c): hand-written kernels launched {launch_counts()}")
        fits[name] = (time.perf_counter() - t0, trainer, model)
    batch = fits["sharded"][1].cfg.batch_size
    result = {"train": len(train_idx), "valid": len(valid_idx), "batch": batch,
              "receivers_per_rank": -(-batch // mesh.shape[1]), "run_s": fits["sharded"][0],
              "epoch_s": fits["sharded"][1].epoch_s,
              "train_loss": fits["sharded"][1].train_loss,
              "valid_loss": fits["sharded"][1].valid_loss}
    require(same_on_every_rank(flat_params(fits["sharded"][2].named_parameters()),
                               mesh.batch_group), "(c): parameters differ across ranks")
    if "unsharded" in fits:
        s, u = fits["sharded"], fits["unsharded"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(s[1].train_loss + s[1].valid_loss,
                                                         u[1].train_loss + u[1].valid_loss))
        param_rel = max(rel_l2(p.detach(), q.detach()) for p, q in
                        zip(s[2].parameters(), u[2].parameters()))
        require(loss_rel <= SHARD_LOSS_TOL and param_rel <= SHARD_FIT_TOL,
                f"(c): sharded vs unsharded epoch: losses {loss_rel}, parameters {param_rel}")
        result.update(unsharded_run_s=u[0], unsharded_epoch_s=u[1].epoch_s,
                      loss_rel_vs_unsharded=loss_rel,
                      max_param_rel_l2_vs_unsharded=param_rel)
    return result


def parallel_rank(rank: int, world: int, spec_path: str) -> None:
    """Phase 16 on one rank of a process group: (a), (b) and (c) on this
    rank's card (``cuda:rank`` under NCCL, ``cuda:0`` for every gloo rank,
    whose steps run eagerly: gloo's collectives cannot be captured)."""
    import torch
    import torch.distributed as dist

    from diffgfdn_torch.parallel import make_mesh
    from diffgfdn_torch.training.scan import GraphedSteps
    from diffgfdn_torch.utils.device import resolve_device

    spec = json.loads(Path(spec_path).read_text())
    backend = dist.get_backend()
    device = resolve_device(f"cuda:{rank}" if backend == "nccl" else "cuda:0")
    torch.cuda.set_device(device)
    if backend != "nccl":
        GraphedSteps.scan_epochs = False
    rows = [] if rank == 0 and spec["rows"] else None
    result = {"rank": rank, "world": world, "backend": backend, "device": str(device),
              "graphed": GraphedSteps.scan_epochs}
    t0 = time.perf_counter()
    result["a"] = shard_single_rir(spec, make_mesh(1), device, rows)
    result["b"] = shard_subband(spec, device, rows)
    result["c"] = shard_spatial(spec, device)
    result["s"] = time.perf_counter() - t0
    out = Path(spec_path).parent / f"{spec['run']}_rank{rank}.json"
    out.write_text(json.dumps({"result": result, "rows": rows}))


def matmul_irfft(tmp: Path, spec: dict) -> dict:
    """(d): ``irfft_matmul`` against ``torch.fft.irfft`` on a directional
    batch's SH half-spectra over the loss window, then phase 8's directional
    step, graphed, with ``use_mxu_fft`` off and on."""
    import torch

    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.data import SpatialThreeRoomDataset
    from diffgfdn_torch.losses import edc_mask
    from diffgfdn_torch.ops.mxu_fft import irfft_matmul
    from diffgfdn_torch.training import run_training_anisotropic_decay_var_receiver_pos

    cfg = preset_config(DIRECTIONAL_PRESET)
    tc = cfg.trainer_config
    tc.train_dir = str(tmp / "parallel" / "directional")
    tc.max_epochs = 1
    room = SpatialThreeRoomDataset(spec["spatial"])
    trainer, model = run_training_anisotropic_decay_var_receiver_pos(cfg, room, device=DEVICE)
    idx = torch.arange(BATCH, device=DEVICE)
    batch = trainer.gather(idx)
    with torch.no_grad():
        h = model(batch)
    n = 2 * (h.shape[-1] - 1)
    lo = trainer.mixing_time_samps
    hi = min(trainer.max_ir_len_samps + lo, n)
    got = irfft_matmul(h, n, lo, hi)
    ref = torch.fft.irfft(h, n, dim=-1)[..., lo:hi]
    err = float(torch.max(torch.abs(got - ref)) / torch.max(torch.abs(ref)))
    require(err <= MXU_PEAK_TOL, f"(d): matmul irfft vs torch.fft.irfft: {err}")
    result = {"h_shape": list(h.shape), "n": n, "window": [lo, hi], "max_err_over_peak": err,
              "matmul_irfft_ms": device_ms(lambda: irfft_matmul(h, n, lo, hi)),
              "torch_irfft_ms": device_ms(lambda: torch.fft.irfft(h, n, dim=-1)[..., lo:hi])}
    mask = edc_mask(trainer.edc_mask_length(batch["z_values"].shape[0]),
                    torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    losses = {}  # the EDC term (the one the switch computes) at the same parameters
    for flag in (False, True):
        trainer.use_mxu_fft = flag
        with torch.no_grad():
            losses[flag] = float(trainer._losses(batch, mask)["edc_loss"])
    for flag in (False, True):
        trainer.use_mxu_fft = flag
        trainer.graphs.clear()
        times = timed_steps(lambda: trainer.fit_step(idx))
        graph = trainer.graphs.get("train")
        require(graph is not None and graph.replays >= PARALLEL_TIMED,
                f"(d): the step with use_mxu_fft={flag} was not replayed")
        result[f"step_ms_mxu_fft_{'on' if flag else 'off'}"] = times
    trainer.use_mxu_fft = False
    loss_rel = abs(losses[True] - losses[False]) / abs(losses[False])
    require(loss_rel <= MXU_LOSS_TOL, f"(d): the loss with and without the matmul irfft "
            f"differ by {loss_rel}")
    result.update(edc_loss_off=losses[False], edc_loss_on=losses[True],
                  edc_loss_rel_on_vs_off=loss_rel)
    return result


def parallel(tmp: Path, card: str) -> tuple:
    """Phase 16: the sharded paths over process groups. With two or more
    cards, one NCCL run over all of them (graphed); with one card, NCCL at
    world 1 in this process (graphed: the collectives captured in the step
    graphs), then gloo at world 2 with both ranks on ``cuda:0`` (eager), so
    that bins, bands and receivers really split and gather on the card.
    Then (d), the matmul irfft, in this process. Returns (result, rows)."""
    import torch

    from diffgfdn_torch.parallel import spawn
    from diffgfdn_torch.parallel.mesh import run_rank

    count = torch.cuda.device_count()
    runs = [("nccl", count)] if count >= 2 else [("nccl", 1), ("gloo", 2)]
    topology = {"cards": count, "runs": [{"backend": b, "world": w,
                                          "devices": [f"cuda:{r}" for r in range(w)]
                                          if b == "nccl" else ["cuda:0"] * w,
                                          "graphed": b == "nccl"} for b, w in runs]}
    print(f"phase 16: topology [{card}] " + json.dumps(topology), flush=True)
    spec = parallel_data(tmp)
    torch.cuda.empty_cache()
    result, rows = {"topology": topology}, []
    for backend, world in runs:
        run = f"{backend}{world}"
        spec_path = tmp / "parallel" / f"{run}.json"
        spec_path.write_text(json.dumps(dict(spec, run=run, rows=world > 1)))
        t0 = time.perf_counter()
        if world == 1:
            run_rank(0, parallel_rank, 1, backend, str(tmp / "parallel" / f"{run}.store"),
                     (str(spec_path),))
        else:
            spawn(parallel_rank, world, backend, (str(spec_path),))
        per_rank = [json.loads((tmp / "parallel" / f"{run}_rank{r}.json").read_text())
                    for r in range(world)]
        result[run] = {"s": time.perf_counter() - t0,
                       "ranks": [p["result"] for p in per_rank]}
        print(f"phase 16: {run} [{card}]: " + json.dumps(result[run]), flush=True)
        if world > 1:  # the kernels at each rank's shard shapes
            rows = per_rank[0]["rows"]
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    result["d"] = matmul_irfft(tmp, spec)
    print(f"phase 16 (d) in {time.perf_counter() - t0:.1f} s [{card}]: "
          + json.dumps(result["d"]), flush=True)
    return result, rows


# ----------------------- phase 17: batches made on the host -----------------------

# (a), (b): 321 receivers of 2 s (107 a room); a seeded split of 256 train (8
# batches of 32, so that fit and fit_indexed see the same batches) and 64 valid
# (2 batches); one epoch. (c): phase 7's 96 receivers, 2 epochs of 3 batches.
HOST_RECEIVERS = 321
HOST_TRAIN = 256
HOST_VALID = 64
HOST_EPOCHS = 1
HOST_BAND_EPOCHS = 2
HOST_FIT_TOL = 1e-5  # fit vs fit_indexed on the same batches, per epoch, relative
HOST_BRANCH_TOL = 1e-3  # the raw-spectrum losses vs the feature losses, relative
HOST_TIMED = 3  # timed host-batch and indexed steps, after 2 untimed
# the loss terms whose targets the two branches take differently (the colorless
# terms, which read no target, can dwarf them in the total: ROADMAP C2)
HOST_TARGET_TERMS = ("edc_loss", "edr_loss")
# the hand-written kernels of one host-batch step (as of one fit_indexed step)
HOST_STEP = {"fullband_grid_colorless": {"cinv": 2, "neg_ptgpt": 2, "sos": 2, "sos_backward": 1},
             "three_room_example": {"cinv": 1, "lu": 1, "lut_apply": 1}}


def host_copy_numbers(send, uploader, arrays, idx: np.ndarray) -> dict:
    """The host gather of one batch (``gather_batch``) and its copy to the
    card (``send(batch)``, then ``synchronize``): median ms of HOST_TIMED
    after 2 untimed, and the bytes the copy moved (``uploader.bytes``)."""
    import torch

    from diffgfdn_torch.data import gather_batch

    gather, copies = [], []
    for k in range(2 + HOST_TIMED):
        t0 = time.perf_counter()
        batch = gather_batch(arrays, idx)
        t1 = time.perf_counter()
        send(batch)
        torch.cuda.synchronize()
        if k >= 2:
            gather.append((t1 - t0) * 1e3)
            copies.append((time.perf_counter() - t1) * 1e3)
    return {"bytes_a_batch": uploader.bytes, "gather_ms": float(np.median(gather)),
            "copy_ms": float(np.median(copies))}


def epoch_gap(ref, got) -> float:
    """The largest relative difference of two runs' per-epoch losses (lists
    of floats, or of per-band arrays)."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    require(ref.shape == got.shape, f"histories {ref.shape} and {got.shape}")
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


def host_grid(name: str, tmp: Path, log_dir) -> dict:
    """Phase 17 (a) / (b): ``iterate_batches`` -> ``GFDNTrainer.fit`` at full
    width for one configuration."""
    import torch

    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.data import arrays_from_room_dataset, gather_batch, iterate_batches
    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer

    cfg = preset_config(name)
    cfg.trainer_config.max_epochs = HOST_EPOCHS
    room = make_room(tmp, name, cfg.sample_rate, cfg.trainer_config.num_freq_bins, HOST_RECEIVERS,
                     folder=f"host_{name}")
    arrays = arrays_from_room_dataset(room)
    perm = np.random.RandomState(SEED).permutation(arrays.num_items)
    train_idx, valid_idx = perm[:HOST_TRAIN], perm[HOST_TRAIN:HOST_TRAIN + HOST_VALID]
    rng = np.random.RandomState(SEED)  # fit_indexed's batch order for seed SEED
    perms = [train_idx[rng.permutation(HOST_TRAIN)] for _ in range(HOST_EPOCHS)]
    t0 = time.perf_counter()
    arrays.target_early_response, arrays.target_rir_response  # the host's rffts, once
    spectra_s = time.perf_counter() - t0

    def trainer(tag: str, **trainer_cfg):
        c = copy.deepcopy(cfg)
        c.trainer_config.train_dir = str(tmp / f"host_{name}" / tag)
        for k, v in trainer_cfg.items():
            setattr(c.trainer_config, k, v)
        model = build_gfdn_model(c, room.common_decay_times, room.band_centre_hz, device=DEVICE)
        return GFDNTrainer(model, c.trainer_config, HOST_TRAIN // BATCH,
                           common_decay_times=room.common_decay_times, sample_rate=c.sample_rate,
                           device=DEVICE)

    def batches(source):
        return (lambda e: iterate_batches(source, perms[e], BATCH, shuffle=False),
                lambda: iterate_batches(source, valid_idx, BATCH, shuffle=False,
                                        drop_last=False))

    # the main path: fit on host batches without features (the raw spectra)
    main = trainer("graphed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    main.fit(*batches(arrays), seed=SEED)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    for kernel in HOST_STEP[name]:
        require(launches[kernel] > 0, f"host {name}: {kernel} never launched in fit")
    require(all(launches[k] == 0 for k in launches if k not in HOST_STEP[name]),
            f"host {name}: kernels off the path launched {launches}")
    require(len(main.train_loss) == HOST_EPOCHS and bool(np.isfinite(main.train_loss + main.valid_loss).all()),
            f"host {name}: losses {main.train_loss} {main.valid_loss}")
    require(any(g.replays for g in main.graphs), f"host {name}: fit replayed no graph")
    history = {"fit_train_loss": main.train_loss, "fit_valid_loss": main.valid_loss}

    # the same fit eagerly: the graphed fit's losses within GRAPH_LOSS_TOL
    eager = trainer("eager")
    eager.scan_epochs = False
    eager.fit(*batches(arrays), seed=SEED)
    graph_gap = max(epoch_gap(eager.train_loss, main.train_loss),
                    epoch_gap(eager.valid_loss, main.valid_loss))
    require(graph_gap <= GRAPH_LOSS_TOL, f"host {name}: graphed vs eager fit {graph_gap}")
    del eager

    # one host batch on the kernels and on the plain versions
    idx = perms[0][:BATCH]
    sent = main.send(gather_batch(arrays, idx))
    mask = main.draw_edc_mask(sent["z_values"].shape[0])
    loss_k, _ = main.loss_and_grads(sent, mask)
    grads_k = {n: p.grad.clone() for n, p in main.model.named_parameters()}
    with plain_versions():
        loss_p, _ = main.loss_and_grads(sent, mask)
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_rel = max(rel_l2(grads_k[n], p.grad) for n, p in main.model.named_parameters())
    require(loss_rel <= LOSS_TOL and grad_rel <= GRAD_TOL,
            f"host {name}: kernels vs plain loss {loss_rel}, gradients {grad_rel}")

    # the host step graphed and eagerly, the profiled launches of a graphed step
    graph = graphed_vs_eager(f"host_{name}", main, dict(main.model.named_parameters()),
                             lambda: main.host_step(gather_batch(arrays, idx))[0], log_dir,
                             main.mask_generator, kind="host_train")
    require(graph["launches_per_step"] == {k: float(v) for k, v in HOST_STEP[name].items()}
            and graph["graphed_profiled_launches"] == HOST_STEP[name],
            f"host {name}: launches per step {graph['launches_per_step']}, profiled "
            f"{graph['graphed_profiled_launches']}")
    spectra_copy = host_copy_numbers(main.send, main.host_batches, arrays, idx)
    host_spectra_ms = timed_steps(lambda: main.host_step(gather_batch(arrays, idx)), HOST_TIMED)
    del main

    # fit and fit_indexed on the same batches, the target features
    # precomputed and the EDC mask off; fit_indexed takes the host's early
    # spectra (its own rfft on the card differs from scipy's by rounding)
    feat_arrays = copy.copy(arrays)  # the same spectra; precomputed features of its own
    feat = trainer("features", use_edc_mask=False)
    feat.precompute_target_features(feat_arrays)
    indexed = trainer("indexed", use_edc_mask=False)
    indexed.features = feat.features
    indexed.upload_arrays(arrays)
    indexed.data["target_early_response"] = torch.as_tensor(arrays.target_early_response,
                                                            device=DEVICE)
    feat.fit(*batches(feat_arrays), seed=SEED)
    indexed.fit_indexed(arrays, train_idx, valid_idx, seed=SEED)
    fit_gap = max(epoch_gap(indexed.train_loss, feat.train_loss),
                  epoch_gap(indexed.valid_loss, feat.valid_loss),
                  *(epoch_gap([d[k] for d in indexed.individual_train_loss],
                              [d[k] for d in feat.individual_train_loss])
                    for k in indexed.individual_train_loss[0]))
    require(fit_gap <= HOST_FIT_TOL, f"host {name}: fit vs fit_indexed {fit_gap}")

    # one step's target terms: the raw spectra against the precomputed features
    with torch.no_grad():
        by_spectra = feat._losses(feat.send(gather_batch(arrays, idx)))
        by_features = feat._losses(feat.send(gather_batch(feat_arrays, idx)))
    branch_rel = max(abs(float(by_spectra[k]) - float(by_features[k])) / abs(float(by_features[k]))
                     for k in HOST_TARGET_TERMS)
    require(branch_rel <= HOST_BRANCH_TOL, f"host {name}: spectra vs features {branch_rel}")

    feature_copy = host_copy_numbers(feat.send, feat.host_batches, feat_arrays, idx)
    host_feature_ms = timed_steps(lambda: feat.host_step(gather_batch(feat_arrays, idx)),
                                  HOST_TIMED)
    idx_dev = torch.as_tensor(idx, device=DEVICE)
    indexed_ms = timed_steps(lambda: indexed.fit_step(idx_dev), HOST_TIMED)
    del feat, indexed
    torch.cuda.empty_cache()
    return {
        "config": name, "receivers": arrays.num_items, "train": HOST_TRAIN, "valid": HOST_VALID,
        "batch": BATCH, "nfft": cfg.trainer_config.num_freq_bins, "epochs": HOST_EPOCHS,
        "host_spectra_s": spectra_s, "fit_s": run_s, **history,
        "launches": {k: launches[k] for k in HOST_STEP[name]},
        "graphed_vs_eager_fit_loss_rel": graph_gap, "step_loss_rel_vs_plain": loss_rel,
        "max_grad_rel_l2_vs_plain": grad_rel, "fit_vs_fit_indexed_rel": fit_gap,
        "spectra_vs_features_loss_rel": branch_rel,
        "host_step_ms_spectra": host_spectra_ms, "host_step_ms_features": host_feature_ms,
        "indexed_step_ms": indexed_ms,
        "host_step_ms_spectra_median": float(np.median(host_spectra_ms)),
        "host_step_ms_features_median": float(np.median(host_feature_ms)),
        "indexed_step_ms_median": float(np.median(indexed_ms)),
        "copy_spectra": spectra_copy, "copy_features": feature_copy,
        **{k: graph[k] for k in ("graphed_step_ms", "eager_step_ms", "graphed_profiled_step_ms",
                                 "graphed_profiled_device_busy_ms",
                                 "graphed_profiled_idle_share", "launches_per_step",
                                 "graphed_profiled_launches", "graph_vs_eager_loss_rel")},
    }


def host_bands(tmp: Path, log_dir) -> dict:
    """Phase 17 (c): the 4-band subband group of phase 7,
    ``BandParallelTrainer.init`` then ``fit`` on host batches."""
    import torch

    from diffgfdn_torch.cli import run_subband_training as rst
    from diffgfdn_torch.data import arrays_from_room_dataset, gather_batch, iterate_batches
    from diffgfdn_torch.kernels.dispatch import plain_versions
    from diffgfdn_torch.parallel import BandParallelTrainer
    from diffgfdn_torch.training import build_gfdn_model
    from diffgfdn_torch.training.host_batches import grid_keys
    from diffgfdn_torch.training.solver import subband_resp

    fs, nfft = SUBBAND_FS, SUBBAND_NFFT
    room = make_room(tmp, "subband", fs, nfft, folder="host_subband")
    configs = [rst.create_config(f, str(tmp / "host_subband" / "srirs.pkl"),
                                 str(tmp / "host_subband" / "train"), nfft, sample_rate=fs,
                                 max_epochs=HOST_BAND_EPOCHS, batch_size=BATCH)
               for f in rst.DEFAULT_FREQS]
    group = max(rst.architecture_groups(configs), key=len)
    require(len(group) == max(SUBBAND_GROUP_SIZES), f"the largest group has {len(group)} bands")
    arrays = arrays_from_room_dataset(room)
    idx_all = np.arange(arrays.num_items)
    rng = np.random.RandomState(SEED)  # fit_indexed's batch order for seed SEED
    perms = [idx_all[rng.permutation(len(idx_all))] for _ in range(HOST_BAND_EPOCHS)]
    steps = len(idx_all) // BATCH
    seeds = [c.seed for c in group]
    example = gather_batch(arrays, idx_all[:BATCH])

    def trainer():
        models = [build_gfdn_model(c, room.common_decay_times, room.band_centre_hz,
                                   device=DEVICE) for c in group]
        t = BandParallelTrainer(models, group[0].trainer_config,
                                np.stack([subband_resp(c) for c in group]), steps,
                                max_ir_len_ms=float(np.max(room.common_decay_times)) * 1e3,
                                device=DEVICE)
        built = {k: v.detach().clone() for k, v in t.params.items()}
        t.init(example, seeds=seeds)  # each band's config seed: what its model drew
        require(all(torch.equal(t.params[k], v) for k, v in built.items()),
                "band init from the configs' seeds differs from the built models")
        return t

    def batches(e):
        return iterate_batches(arrays, perms[e], BATCH, shuffle=False)

    main = trainer()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    history = main.fit(batches, seed=SEED)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    fit_steps = HOST_BAND_EPOCHS * steps
    require({k: v for k, v in launches.items() if v} == {k: fit_steps for k in BAND_STEP_KERNELS},
            f"host bands: {fit_steps} steps launched {launches}")
    require(history.shape == (HOST_BAND_EPOCHS, len(group)) and bool(np.isfinite(history).all()),
            f"host bands: history {history}")

    eager = trainer()
    eager.scan_epochs = False
    graph_gap = epoch_gap(eager.fit(batches, seed=SEED), history)
    require(graph_gap <= GRAPH_LOSS_TOL, f"host bands: graphed vs eager fit {graph_gap}")
    del eager

    idx = perms[0][:BATCH]
    sent = main.host_batches(gather_batch(arrays, idx), grid_keys(example))
    loss_k, _ = main.loss_and_grads(sent)
    grads_k = {n: p.grad.clone() for n, p in main.params.items()}
    with plain_versions():
        loss_p, _ = main.loss_and_grads(sent)
    loss_rel = float(torch.max(torch.abs(loss_k - loss_p) / torch.abs(loss_p)))
    grad_rel = max(rel_l2(grads_k[n][b], p.grad[b]) for n, p in main.params.items()
                   for b in range(len(group)))
    require(loss_rel <= LOSS_TOL and grad_rel <= GRAD_TOL,
            f"host bands: kernels vs plain loss {loss_rel}, gradients {grad_rel}")

    graph = graphed_vs_eager("host_subband_4_bands", main, main.params,
                             lambda: main.step(gather_batch(arrays, idx))[0], log_dir,
                             main.mask_generator, kind="host_train")
    require(graph["launches_per_step"] == {k: 1.0 for k in BAND_STEP_KERNELS},
            f"host bands: launches per step {graph['launches_per_step']}")
    band_copy = host_copy_numbers(lambda b: main.host_batches(b, grid_keys(b)),
                                  main.host_batches, arrays, idx)
    host_ms = timed_steps(lambda: main.step(gather_batch(arrays, idx)), HOST_TIMED)

    # fit_indexed on the same batches takes each band's precomputed target
    # features; the host batches carry none (the raw spectra times each band's
    # response): the two branches agree to rounding
    indexed = trainer()
    indexed_history = indexed.fit_indexed(arrays, idx_all, None, max_epochs=HOST_BAND_EPOCHS,
                                          seed=SEED)
    fit_gap = epoch_gap(indexed_history, history)
    require(fit_gap <= HOST_BRANCH_TOL, f"host bands: fit vs fit_indexed {fit_gap}")
    with torch.no_grad():
        by_spectra = indexed.host_losses(
            indexed.host_batches(gather_batch(arrays, idx), grid_keys(example)))
        by_features = indexed.losses(torch.as_tensor(idx, device=DEVICE))
    branch_rel = max(float(torch.max(torch.abs(by_spectra[k] - by_features[k])
                                     / torch.abs(by_features[k]))) for k in HOST_TARGET_TERMS)
    require(branch_rel <= HOST_BRANCH_TOL, f"host bands: spectra vs features {branch_rel}")
    idx_dev = torch.as_tensor(idx, device=DEVICE)
    indexed_ms = timed_steps(lambda: indexed.step(idx_dev), HOST_TIMED)
    del main, indexed
    torch.cuda.empty_cache()
    return {
        "bands_hz": [c.trainer_config.subband_process_config.centre_frequency for c in group],
        "receivers": arrays.num_items, "epochs": HOST_BAND_EPOCHS, "steps_per_epoch": steps,
        "fit_s": run_s, "history": history.tolist(),
        "launches": {k: launches[k] for k in BAND_STEP_KERNELS},
        "graphed_vs_eager_fit_loss_rel": graph_gap, "step_loss_rel_vs_plain": loss_rel,
        "max_grad_rel_l2_vs_plain": grad_rel, "fit_vs_fit_indexed_rel": fit_gap,
        "spectra_vs_features_loss_rel": branch_rel, "host_step_ms": host_ms,
        "indexed_step_ms": indexed_ms, "host_step_ms_median": float(np.median(host_ms)),
        "indexed_step_ms_median": float(np.median(indexed_ms)), "copy": band_copy,
        **{k: graph[k] for k in ("graphed_step_ms", "eager_step_ms", "graphed_profiled_step_ms",
                                 "graphed_profiled_device_busy_ms",
                                 "graphed_profiled_idle_share", "launches_per_step",
                                 "graphed_profiled_launches", "graph_vs_eager_loss_rel")},
    }


def host_batches(tmp: Path, log_dir) -> dict:
    """Phase 17: the host-batch training entry points at full width, (a)
    ``fullband_grid_colorless``, (b) ``three_room_example``, (c) the 4-band
    subband group. Returns each part's numbers."""
    out = {}
    for part, name in (("a", "fullband_grid_colorless"), ("b", "three_room_example")):
        t0 = time.perf_counter()
        out[part] = host_grid(name, tmp, log_dir)
        print(f"phase 17 ({part}) in {time.perf_counter() - t0:.1f} s: " + json.dumps(out[part]),
              flush=True)
    t0 = time.perf_counter()
    out["c"] = host_bands(tmp, log_dir)
    print(f"phase 17 (c) in {time.perf_counter() - t0:.1f} s: " + json.dumps(out["c"]),
          flush=True)
    return out


# ---------------- phase 18: the walkthrough and the notebook studies ----------------

# the kernels each part of phase 18 launches, and no other: the walkthrough's
# colorless warm start (B1 / B2 on the 2-line prototypes) and its scalar-head
# grid training (B5 / B6); its inference (B5); the subband CLI's two bands
# (the colorless loss's B1 / B2, the scalar heads' B5 / B6; the synthetic
# dataset's scalar absorption builds no SOS filters: no B3 / B4); the
# binaural render (no kernel); the studies
EXAMPLE_KERNELS = {
    "walkthrough_train": ("cinv", "neg_ptgpt", "lu", "lut_apply"),
    "walkthrough_infer": ("lu",),
    "walkthrough_subband": ("cinv", "neg_ptgpt", "lu", "lut_apply"),
    "walkthrough_render": (),
    "loss_surface": ("cinv",),
    "fdn_colouration": ("cinv",),
    "fadein_study": ("tdgfdn",),
    "low_rank_study": ("tdgfdn",),
    "colorless_output_study": ("cinv", "neg_ptgpt"),
    "check_edr_loss": (),
    "cs_amplitude_study": (),
    "room_geometry_study": (),
    "compare_flops": (),
}
# the kernels held and timed at each part's new launch shapes (the largest
# recorded call of each; B7 at the study's first N-line call)
EXAMPLE_ROWS = (("loss_surface", "cinv"), ("fdn_colouration", "cinv"),
                ("fadein_study", "tdgfdn"), ("low_rank_study", "tdgfdn"),
                ("walkthrough_train", "cinv"), ("walkthrough_train", "neg_ptgpt"),
                ("walkthrough_train", "lu"), ("walkthrough_train", "lut_apply"),
                ("walkthrough_subband", "lu"), ("walkthrough_subband", "lut_apply"),
                ("colorless_output_study", "cinv"), ("colorless_output_study", "neg_ptgpt"))
# the JAX package's colorless study draws each group's prototype from
# PRNGKey(g) (``ColorlessFDN.init``, examples/colorless_output_study.py);
# these are those draws (tests/test_torch_examples.py holds them to JAX), so
# that the card trains the reference's own start. The port's torch.Generator
# draw at seed 0 misses the study's conclusion in its second and third groups, as
# JAX's own draws at seeds 2-4 do (ROADMAP C25): it is trained and printed too
COLORLESS_JAX_INIT = (
    {"input_gains": [-0.21192875504493713, -1.057873010635376, -1.092886209487915,
                     0.1063445508480072],
     "output_gains": [0.05087786912918091, -0.12233859300613403, -0.11316075921058655,
                      -1.348760724067688],
     "random_feedback_matrix": [
         -0.18820416927337646, 0.3959047794342041, 0.3980250358581543, 0.1735067367553711,
         -0.28652775287628174, -0.3049508333206177, 0.24836599826812744, -0.17970573902130127,
         -0.10865139961242676, 0.16720151901245117, 0.3165961503982544, -0.2682422399520874,
         0.4457317590713501, 0.42637574672698975, 0.4308100938796997, 0.44273459911346436]},
    {"input_gains": [0.5624796152114868, -0.09593465924263, 0.5806792378425598,
                     0.2702077627182007],
     "output_gains": [-0.5155810713768005, -0.8035312294960022, 0.17861109972000122,
                      -1.033357858657837],
     "random_feedback_matrix": [
         0.14834284782409668, -0.4831491708755493, 0.20190834999084473, -0.19254803657531738,
         -0.3190140724182129, -0.44324052333831787, 0.16093730926513672, 0.25077521800994873,
         -0.21328258514404297, -0.28577184677124023, 0.19192492961883545, -0.0800391435623169,
         -0.47819340229034424, 0.3037172555923462, -0.3712574243545532, 0.33035099506378174]},
    {"input_gains": [-0.39993515610694885, -0.27035731077194214, -1.4117337465286255,
                     -1.041123628616333],
     "output_gains": [-0.8695033192634583, 0.012001723051071167, 0.32459431886672974,
                      0.20632871985435486],
     "random_feedback_matrix": [
         -0.09675300121307373, 0.3425283432006836, 0.30464422702789307, 0.4670071601867676,
         0.4485654830932617, 0.1441594362258911, -0.3529895544052124, 0.05073404312133789,
         0.29665040969848633, -0.3250093460083008, -0.4065239429473877, 0.30273449420928955,
         -0.2782045602798462, 0.39159250259399414, -0.3321995735168457, 0.24555933475494385]},
)
# the colouration study at tests/test_examples.py's size, where its conclusion
# (the filterbank sum decays within 2 dB of the top band alone) is drawn, and
# at its main default; there the top band's decay over the window (-82 to -87
# dB in float64) sits at float32's rounding floor, where the 2 dB gap is
# rounding in every float32 run (ROADMAP C25): the plain sum's excess is held
COLOURATION_NFFTS = (8192, 16384)
# the EM fallback of fit_gmm (the card's image has no sklearn) assigns 113 of
# the 180 receivers to their room, in both packages (ROADMAP C25); sklearn's
# mixture more than 0.85 of them, the study's conclusion
CS_EM_ACCURACY = 113 / 180


def colorless_jax_init() -> list:
    """:data:`COLORLESS_JAX_INIT` as the JAX parameter trees (numpy) that
    ``load_jax_params`` takes."""
    return [{"params": {
        "feedback_loop": {"random_feedback_matrix": np.asarray(
            g["random_feedback_matrix"], np.float32).reshape(4, 4)},
        "input_gains": np.asarray(g["input_gains"], np.float32).reshape(4, 1),
        "output_gains": np.asarray(g["output_gains"], np.float32).reshape(4, 1),
    }} for g in COLORLESS_JAX_INIT]


def _signature(args) -> tuple:
    return tuple(tuple(a.shape) if hasattr(a, "shape") else a for a in args)


@contextlib.contextmanager
def recorded_launches(store: dict):
    """Within the block each counted kernel wrapper is replaced by one that
    counts its launches from 0 (the kernel's own count, which lands on the
    replacement; a replayed graph adds its captured counts to it too) and
    keeps a copy of the inputs of its first eager call at each distinct
    shape, ``store[name][signature]``. Yields a function that reads the
    counts."""
    import torch

    from diffgfdn_torch.kernels import cinv, counted_wrappers, lu, sos, tdgfdn

    patched = [(cinv, "cinv"), (cinv, "neg_ptgpt"), (sos, "sos_cascade_response"),
               (sos, "sos_cascade_backward"), (lu, "lu_solve"), (lu, "lut_apply"),
               (tdgfdn, "delay_line_outputs")]
    names = {id(fn): name for name, fn in counted_wrappers().items()}
    originals = [getattr(mod, attr) for mod, attr in patched]

    def recorder(fn, name):
        def wrapped(*args):
            calls = store.setdefault(name, {})
            sig = _signature(args)
            if sig not in calls and not torch.cuda.is_current_stream_capturing():
                calls[sig] = tuple(a.detach().clone() if torch.is_tensor(a) else a
                                   for a in args)
            return fn(*args)
        wrapped.launches = 0
        return wrapped

    for (mod, attr), fn in zip(patched, originals):
        setattr(mod, attr, recorder(fn, names[id(fn)]))
    try:
        yield lambda: {name: fn.launches for name, fn in counted_wrappers().items()}
    finally:
        for (mod, attr), fn in zip(patched, originals):
            setattr(mod, attr, fn)


def example_part(label: str, fn, parts: dict, inputs: dict):
    """Run ``fn()`` as the phase-18 part ``label`` with every launch count
    at 0 and the kernels' inputs recorded; every kernel of
    :data:`EXAMPLE_KERNELS` ``[label]`` must have launched, no other.
    Returns ``fn()``'s result; notes the part's wall time and launches."""
    import torch

    store = {}
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_launches(store) as counts:
        out = fn()
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        launches = {k: v for k, v in counts().items() if v}
    wall = time.perf_counter() - t0
    expect = EXAMPLE_KERNELS[label]
    require(set(launches) == set(expect),
            f"phase 18 {label}: launched {launches}, expected each of {expect} and no other")
    parts[label] = {"wall_s": wall, "launches": launches}
    inputs[label] = store
    print(f"phase 18 {label} in {wall:.2f} s: launches {launches}", flush=True)
    return out


def example_kernel_checks(inputs: dict) -> dict:
    """Phase 18 (d): each kernel against its plain version on the card at
    every input shape a part recorded: B1, B2, B5, B6 and B7 bit for bit,
    B3 / B4 within 1e-4 of the largest value. Returns {(part, kernel):
    (largest signature, max abs error)}."""
    import torch

    from diffgfdn_torch.kernels import counted_wrappers, tdgfdn
    from diffgfdn_torch.kernels.dispatch import plain_versions

    wrappers = counted_wrappers()
    limit = tdgfdn.shared_memory_limit(torch.device(DEVICE))
    out = {}
    for part, store in inputs.items():
        for name, calls in store.items():
            for sig, args in calls.items():
                got = wrappers[name](*args)
                with plain_versions():
                    ref = wrappers[name](*args)
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                if name in ("sos", "sos_backward"):
                    err = max(rel_err(a, b) for a, b in zip(got, ref))
                    require(err <= KERNEL_TOL, f"phase 18 {part} {name} {sig}: rel err {err}")
                    differ = None
                else:
                    differ = sum(int((a != b).sum()) for a, b in zip(got, ref))
                    require(differ == 0, f"phase 18 {part} {name} {sig}: {differ} elements "
                            "differ from the plain version")
                err = max(float(torch.max(torch.abs(a - b).to(torch.float64)))
                          for a, b in zip(got, ref) if a.is_floating_point() or a.is_complex())
                plan = ""
                if name == "tdgfdn":
                    plan = f", plan {tdgfdn.kernel_plan(args[0], limit)}"
                print(f"phase 18 (d) {part} {name} {sig}: elements differing from plain "
                      f"{differ}, max abs err {err:.3e}{plan}")
                size = int(np.prod(args[-1].shape)) if name != "tdgfdn" else len(args[0])
                key = (part, name)
                if key not in out or size > out[key][2]:
                    out[key] = (sig, err, size)
    return {k: v[:2] for k, v in out.items()}


def example_row(part: str, name: str, args, launches: int, err: float, store: dict) -> dict:
    """A kernel row of phase 18 at one recorded input (``timed_row``)."""
    import torch

    from diffgfdn_torch.kernels import counted_wrappers, tdgfdn
    from diffgfdn_torch.kernels.dispatch import plain_versions

    fn = counted_wrappers()[name]

    def plain():
        with plain_versions():
            return fn(*args)

    replaces = {"cinv": ("cinv.cu", "diffgfdn_tpu/kernels/pallas_cinv.py:34"),
                "neg_ptgpt": ("cinv.cu", "diffgfdn_tpu/kernels/pallas_cinv.py:146"),
                "lu": ("lu.cu", "diffgfdn_tpu/kernels/pallas_lu.py:46"),
                "lut_apply": ("lu.cu", "diffgfdn_tpu/kernels/pallas_lu.py:142"),
                "tdgfdn": ("tdgfdn.cu", "diffgfdn_tpu/kernels/tdgfdn.py:167")}
    source, site = replaces[name]
    library, kernel_call = None, (lambda: fn(*args))
    if name == "cinv":
        (m,) = args
        cost, shape = cinv_cost(m.shape[0], m.shape[1]), m.shape
        library = lambda: torch.linalg.inv(m)  # noqa: E731
    elif name == "neg_ptgpt":
        p, g = args
        cost, shape = neg_ptgpt_cost(p.shape[0], p.shape[1]), p.shape
        library = lambda: -(p.mH @ g @ p.mH)  # noqa: E731
    elif name == "lu":
        m, b = args
        cost, shape = lu_cost(m.shape[0], m.shape[1]), m.shape
        library = lambda: torch.linalg.solve(m, b.unsqueeze(-1))  # noqa: E731
    elif name == "lut_apply":
        _, _, g = args
        cost, shape = lut_apply_cost(g.shape[0], g.shape[1]), g.shape
        # the factored systems: the part's B5 input with as many systems
        systems = [a[0] for a in store.get("lu", {}).values() if a[0].shape[0] == g.shape[0]]
        if systems:
            m = systems[0]
            library = lambda: torch.linalg.solve(m.mH, g.unsqueeze(-1))  # noqa: E731
    else:
        delays, gains, a, b, u = args
        cost, shape = tdgfdn_cost(u.shape[0], len(delays)), (u.shape[0], len(delays))
        kernel_call = bare_tdgfdn(tdgfdn, delays, gains, a, b, u)
    row = timed_row(name, source, site, launches, err, lambda: fn(*args), plain, kernel_call,
                    cost, library, shape)
    row["part"] = part
    return row


def example_conclusions(tmp: Path, parts: dict, inputs: dict) -> dict:
    """Phase 18 (b): each study's compute function at its ``main`` defaults
    on the card, and the conclusion ``tests/test_examples.py`` asserts."""
    import importlib.util

    from diffgfdn_torch.examples import (check_edr_loss, colorless_output_study, compare_flops,
                                         cs_amplitude_study, fadein_study, fdn_colouration,
                                         loss_surface, low_rank_study, room_geometry_study)

    res = {}
    g, edc, edr, prod = example_part("loss_surface", lambda: loss_surface.compute_surfaces(
        device=DEVICE), parts, inputs)
    require(bool(np.isfinite(edc).all() and np.isfinite(edr).all()), "loss surface: not finite")
    i, j = np.unravel_index(np.argmin(edc), edc.shape)
    mirror = abs(edc[len(g) - 1 - i, len(g) - 1 - j] - edc[i, j])
    require(abs(g[i] * g[j] - prod) < 0.15 and mirror < 1e-3,
            f"loss surface: valley at {g[i] * g[j]} (true {prod}), mirror off by {mirror}")
    res["loss_surface"] = {"grid": int(len(g)), "argmin_product": float(g[i] * g[j]),
                           "mirror_db": float(mirror)}

    fs = 32000.0
    responses = example_part("fdn_colouration", lambda: {
        nfft: fdn_colouration.band_responses(nfft, fs, device=DEVICE)
        for nfft in COLOURATION_NFFTS}, parts, inputs)
    res["fdn_colouration"] = {}
    for nfft, (centres, h_bands, w_bands, _) in responses.items():
        freqs = np.fft.rfftfreq(nfft, d=1.0 / fs)
        top = w_bands[-1]
        d_plain = fdn_colouration.band_decay_db(h_bands.sum(0), top, nfft, fs)
        d_filt = fdn_colouration.band_decay_db((w_bands * h_bands).sum(0), top, nfft, fs,
                                               undo_delay_samps=2 ** 11)
        d_ref = fdn_colouration.band_decay_db(h_bands[-1], top, nfft, fs)
        sel = (freqs >= centres[0]) & (freqs <= fs / 2 * 0.9)
        colour = fdn_colouration.colouration_db(h_bands.sum(0), freqs, centres[0], fs / 2 * 0.9)
        require(d_plain > d_filt + 3.0 and (nfft != 8192 or abs(d_filt - d_ref) < 2.0),
                f"colouration at nfft {nfft}: decays plain {d_plain}, filtered {d_filt}, "
                f"top band {d_ref}")
        require(bool(np.allclose(np.abs(w_bands.sum(0))[sel], 1.0, atol=0.1))
                and bool(np.isfinite(colour)), "colouration: the bank does not reconstruct")
        res["fdn_colouration"][nfft] = {
            "decay_plain_db": float(d_plain), "decay_filtered_db": float(d_filt),
            "decay_top_band_db": float(d_ref), "colouration_db": colour}

    fs, t60s = 16000.0, (0.25, 0.9)
    t, rirs, analytic, t0, u = example_part(
        "fadein_study", lambda: fadein_study.synthesize_cases(fs=fs, device=DEVICE),
        parts, inputs)
    d = 3.0 * np.log(10) / np.asarray(t60s)
    w = 0.2 / np.sqrt(abs(d[1] - d[0]))
    got, got_ss = rirs["uncoupled, +/- taps"], rirs["uncoupled, same-sign taps"]
    err_pm = float(np.max(np.abs(got - w * (np.exp(-d[0] * t) - np.exp(-d[1] * t)) * u))
                   / np.max(np.abs(got)))
    err_ss = float(np.max(np.abs(got_ss - 0.35 * (np.exp(-d[0] * t) + np.exp(-d[1] * t)) * u))
                   / np.max(np.abs(got_ss)))
    win = int(0.01 * fs)
    pk_pm = float(t[np.argmax(fadein_study.envelope_db(got, win))] - t0)
    pk_ss = float(t[np.argmax(fadein_study.envelope_db(got_ss, win))] - t0)
    require(err_pm < 1e-3 and err_ss < 1e-3, f"fade-in: identities off by {err_pm}, {err_ss}")
    require(pk_pm > pk_ss + 0.01 and 0 < np.argmax(analytic) < len(t) - 1,
            f"fade-in: envelope peaks {pk_pm} (+/-), {pk_ss} (same sign)")
    res["fadein_study"] = {"identity_err_pm": err_pm, "identity_err_same_sign": err_ss,
                           "peak_pm_s": pk_pm, "peak_same_sign_s": pk_ss}

    lr = example_part("low_rank_study", lambda: low_rank_study.low_rank_render(device=DEVICE),
                      parts, inputs)
    require(bool(np.all(lr["explained"] > 0.95)) and lr["mean_edc_err_db"] < 4.0,
            f"low rank: explained {lr['explained']}, EDC error {lr['mean_edc_err_db']} dB")
    require(bool(np.isfinite(lr["rendered"]).all()), "low rank: renders not finite")
    res["low_rank_study"] = {"explained": lr["explained"].tolist(),
                             "mean_edc_err_db": lr["mean_edc_err_db"]}

    def colorless():
        ref = colorless_output_study.train_groups(tmp / "colorless_jax_init", device=DEVICE,
                                                  params=colorless_jax_init())
        own = colorless_output_study.train_groups(tmp / "colorless", device=DEVICE)
        return ref, own

    ref, own = example_part("colorless_output_study", colorless, parts, inputs)
    for r in ref:
        require(r["flat1"] > r["flat0"] and r["mse1"] < 0.5 * r["mse0"],
                f"colorless study (the reference's start): {r['flat0']} -> {r['flat1']}, "
                f"MSE {r['mse0']} -> {r['mse1']}")
    require(all(np.isfinite([r[k] for r in own for k in ("flat1", "mse1")])),
            "colorless study: the port's own start trained to non-finite numbers")
    res["colorless_output_study"] = {
        label: [{k: r[k] for k in ("flat0", "flat1", "mse0", "mse1")} for r in rs]
        for label, rs in (("jax_init", ref), ("torch_generator_seed0", own))}

    edr = example_part("check_edr_loss", lambda: check_edr_loss.edr_errors(device=DEVICE),
                       parts, inputs)
    require(edr["err_irfft_db"] < 0.05 and edr["err_shortcut_db"] > 20.0 * edr["err_irfft_db"]
            and edr["err_shortcut_db"] > 5.0,
            f"EDR check: irfft {edr['err_irfft_db']}, shortcut {edr['err_shortcut_db']} dB")
    res["check_edr_loss"] = {k: edr[k] for k in ("err_irfft_db", "err_shortcut_db")}

    cs = example_part("cs_amplitude_study", cs_amplitude_study.amplitude_statistics,
                      parts, inputs)
    sklearn = importlib.util.find_spec("sklearn") is not None
    if sklearn:
        require(cs["accuracy"] > 0.85, f"amplitude study: GMM accuracy {cs['accuracy']}")
    else:
        require(abs(cs["accuracy"] - CS_EM_ACCURACY) <= 1.0 / 180,
                f"amplitude study: the EM's accuracy {cs['accuracy']}, JAX's {CS_EM_ACCURACY}")
    require(all(r > 0.9 for r in cs["lowpass_ratios"]),
            f"amplitude study: low-pass ratios {cs['lowpass_ratios']}")
    res["cs_amplitude_study"] = {"gmm": "sklearn" if sklearn else "em",
                                 "accuracy": cs["accuracy"],
                                 "lowpass_ratios": [float(r) for r in cs["lowpass_ratios"]]}

    geo = example_part("room_geometry_study", lambda: room_geometry_study.geometry_checks(
        tmp / "room_geometry", device=DEVICE), parts, inputs)
    require(all(geo["one_hot"][s]["unique"] for s in ("train", "valid"))
            and int((geo["feat_std"] > 0.05).sum()) >= len(geo["feat_std"]) // 2
            and geo["patches"]["disjoint"] and geo["patches"]["covered"] > 0.9,
            f"room geometry: {geo['one_hot']}, {geo['patches']}")
    res["room_geometry_study"] = {"one_hot": geo["one_hot"], "patches": geo["patches"]}

    flops = example_part("compare_flops", compare_flops.cost_table, parts, inputs)
    costs = dict(flops["rows"])
    conv = costs["partitioned conv, 9ch 2s SRIR"]
    require(costs["full-band GFDN, GEQ absorption"] < conv
            and costs["8 parallel subband GFDNs"] < conv,
            f"FLOP table: {costs}")
    res["compare_flops"] = costs
    return res


def walkthrough_artifacts(tmp: Path, parts: dict, inputs: dict) -> dict:
    """Phase 18 (a): the walkthrough's steps 1-5 on the card, the animation
    left out (matplotlib), each step counted as a part."""
    from diffgfdn_torch.examples import walkthrough

    out = tmp / "walkthrough"
    out.mkdir(parents=True, exist_ok=True)
    omni, spatial = walkthrough.step1_dataset(out)
    config = example_part("walkthrough_train", lambda: walkthrough.step2_train(out, omni, DEVICE),
                          parts, inputs)
    rirs = example_part("walkthrough_infer",
                        lambda: walkthrough.step3_infer(out, config, omni, DEVICE), parts, inputs)
    broadband = example_part("walkthrough_subband",
                             lambda: walkthrough.step4_subband(out, omni, DEVICE), parts, inputs)
    binaural, *_ = example_part("walkthrough_render",
                                lambda: walkthrough.step5_render(out, spatial, DEVICE),
                                parts, inputs)
    for name in ("srirs.pkl", "spatial_srirs.pkl", "config.yml", "inferred_rir.wav",
                 "subband/broadband_rirs.npy", "binaural_walkthrough.wav"):
        require((out / name).exists(), f"walkthrough: {name} not written")
    require(bool(np.isfinite(np.load(out / "subband" / "broadband_rirs.npy")).all()),
            "walkthrough: the broadband subband RIRs are not finite")
    require(bool(np.isfinite(rirs).all() and np.isfinite(binaural).all()),
            "walkthrough: the inferred RIRs or the binaural render are not finite")
    return {"inferred": list(rirs.shape), "broadband": list(broadband.shape),
            "binaural": list(binaural.shape)}


def examples(tmp: Path) -> tuple:
    """Phase 18: the README's walkthrough (a) and the notebook studies (b)
    through the port's ``examples/`` on the card, each part's launch set
    (c), each new launch shape held to its plain version (d), each part's
    wall time (e). Returns (results, kernel rows)."""
    parts, inputs = {}, {}
    results = {"walkthrough": walkthrough_artifacts(tmp, parts, inputs)}
    results.update(example_conclusions(tmp, parts, inputs))
    checked = example_kernel_checks(inputs)
    rows = []
    for part, name in EXAMPLE_ROWS:
        sig, err = checked[(part, name)]
        rows.append(example_row(part, name, inputs[part][name][sig],
                                parts[part]["launches"][name], err, inputs[part]))
    results["parts"] = parts
    return results, rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--log-dir", default=None,
                        help="write the build log and a profile of one served batch here")
    parser.add_argument("--kernel-times", "--cascade-times", dest="kernel_times",
                        metavar="ROOT", default=None,
                        help="only time the kernels B1-B7 of the diffgfdn_torch package "
                             "under ROOT (another checkout of the port) and print them as one "
                             "JSON line; no result line")
    parser.add_argument("--options", action="store_true",
                        help="only build the kernels and run phase 14 (the coupling, "
                             "absorption, encoding and loss options at full width); prints "
                             "its kernel rows; no result line")
    parser.add_argument("--tools", action="store_true",
                        help="only build the kernels, serve phase 2's two configurations "
                             "and run phase 15 (the inspection, comparison and dataset "
                             "tools, csolve, the int8 targets); no result line")
    parser.add_argument("--parallel", action="store_true",
                        help="only build the kernels and run phase 16 (the sharded paths over "
                             "process groups and the matmul irfft); prints its kernel rows; "
                             "no result line")
    parser.add_argument("--host-batches", action="store_true",
                        help="only build the kernels and run phase 17 (training on batches "
                             "made on the host); no result line")
    parser.add_argument("--examples", action="store_true",
                        help="only build the kernels and run phase 18 (the walkthrough and the "
                             "notebook studies); prints its kernel rows; no result line")
    parser.add_argument("--edc-loss", action="store_true",
                        help="only hold the directional EDC loss against autograd through "
                             "db, time both and print their peak memory as one JSON line "
                             "(edc_loss_check); no result line")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.kernel_times is not None:
        print(card_line())
        print(json.dumps({"kernel_times": kernel_times(Path(args.kernel_times))}))
        return 0
    if args.edc_loss:
        print(card_line())
        print(json.dumps({"edc_loss": edc_loss_check()}), flush=True)
        return 0
    try:
        from diffgfdn_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: the diffgfdn_torch package is not importable ({exc}); "
              "run from the repository root", file=sys.stderr)
        return 1
    card = card_line()
    log_dir = None
    if args.log_dir is not None:
        log_dir = Path(args.log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
    if args.options:
        print(card)
        t0 = time.perf_counter()
        print(f"phase 1: built {sorted(_build.build_all())} in {time.perf_counter() - t0:.1f} s")
        with tempfile.TemporaryDirectory() as tmp_name:
            t0 = time.perf_counter()
            _, option_rows = options(Path(tmp_name), log_dir)
            print(f"phase 14 in {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"kernels": option_rows}))
        return 0
    if args.parallel:
        print(card)
        t0 = time.perf_counter()
        print(f"phase 1: built {sorted(_build.build_all())} in {time.perf_counter() - t0:.1f} s")
        with tempfile.TemporaryDirectory() as tmp_name:
            t0 = time.perf_counter()
            _, parallel_rows = parallel(Path(tmp_name), card)
            print(f"phase 16 in {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps({"kernels": parallel_rows}))
        return 0
    if args.host_batches:
        print(card)
        t0 = time.perf_counter()
        print(f"phase 1: built {sorted(_build.build_all())} in {time.perf_counter() - t0:.1f} s")
        with tempfile.TemporaryDirectory() as tmp_name:
            t0 = time.perf_counter()
            host_batches(Path(tmp_name), log_dir)
            print(f"phase 17 in {time.perf_counter() - t0:.1f} s", flush=True)
        return 0
    if args.examples:
        print(card)
        t0 = time.perf_counter()
        print(f"phase 1: built {sorted(_build.build_all())} in {time.perf_counter() - t0:.1f} s")
        with tempfile.TemporaryDirectory() as tmp_name:
            t0 = time.perf_counter()
            result, example_rows = examples(Path(tmp_name))
            print(f"phase 18 in {time.perf_counter() - t0:.1f} s: " + json.dumps(result),
                  flush=True)
        print(card)
        print(json.dumps({"kernels": example_rows}))
        return 0
    if args.tools:
        print(card)
        t0 = time.perf_counter()
        print(f"phase 1: built {sorted(_build.build_all())} in {time.perf_counter() - t0:.1f} s")
        with tempfile.TemporaryDirectory() as tmp_name:
            tmp = Path(tmp_name)
            rooms, serve_launches = {}, {}
            for name in CONFIGS:
                infer, counts, result = serve(name, tmp, None)
                rooms[name] = infer.room_data
                serve_launches[name] = {k: v for k, v in counts.items() if v}
                print(f"phase 2: served {name}: " + json.dumps(result))
                del infer
            t0 = time.perf_counter()
            tools(tmp, log_dir, rooms, serve_launches)
            print(f"phase 15: tools in {time.perf_counter() - t0:.1f} s", flush=True)
        return 0
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    # the row kernels of B1 / B2 and B5 keep each lane's row in registers: a
    # stack frame would be a system left in local memory; so would one in
    # B6 above N = 8 (w in registers to N = 12, in shared memory above); B7
    # at N = 27 keeps its coefficients in shared memory: a spill would put a
    # sample's outputs in local memory
    rows = {}
    if logs.get("cinv"):
        rows.update({f"{kern}<{n}>": ptxas_usage(logs["cinv"], f"{kern}ILi{n}E")
                     for kern in ("cinv_kernel", "neg_ptgpt_kernel") for n in (8, 9, 12, 27)})
    if logs.get("lu"):
        rows.update({f"{kern}<{n}>": ptxas_usage(logs["lu"], f"{kern}ILi{n}E")
                     for kern in ("lu_solve_kernel", "lut_apply_kernel") for n in (9, 12, 27)})
    if logs.get("tdgfdn"):
        rows["tdgfdn_lines_kernel<27>"] = ptxas_usage(logs["tdgfdn"], "tdgfdn_lines_kernelILi27E")
    if rows:
        print("phase 1: ptxas " + json.dumps(rows))
    require(all(u is not None and u["stack_frame"] == 0 and u["spill_stores"] == 0
                for label, u in rows.items()
                if label.endswith("<9>") or label.startswith("lut_apply_kernel")),
            f"B1 / B2 / B5 at N = 9 or B6 above N = 8 left in local memory: {rows}")
    if logs.get("tdgfdn"):
        b7 = rows["tdgfdn_lines_kernel<27>"]
        require(b7 is not None and b7["spill_stores"] == 0, f"B7 at N = 27 spills: {b7}")
    if log_dir is not None:
        (log_dir / "nvcc.log").write_text(
            "\n".join(f"==== {k}\n{v}" for k, v in logs.items())
        )

    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        served, launches, results, serve_launches = {}, {}, [], {}
        for name in CONFIGS:
            t0 = time.perf_counter()
            served[name], counts, result = serve(name, tmp, log_dir)
            serve_launches[name] = {k: v for k, v in counts.items() if v}
            for kernel in CONFIGS[name]:
                launches[kernel] = counts[kernel]
            results.append(result)
            print(f"phase 2: served {name} in {time.perf_counter() - t0:.1f} s: "
                  + json.dumps(result))
        inputs = path_inputs(served["fullband_grid_colorless"], served["three_room_example"])
        errors = check_kernels(inputs)
        print("phase 3: every kernel matches its plain version and numpy")
        rows = time_kernels(inputs, errors, launches)
        del inputs
        backward_inputs, train_launches = {}, {}
        for name in TRAIN_KERNELS:
            t0 = time.perf_counter()
            result, recorded, counts = train(name, tmp, log_dir)
            backward_inputs.update(recorded)
            for kernel in ("neg_ptgpt", "sos_backward", "lut_apply"):
                if kernel in TRAIN_KERNELS[name]:
                    train_launches[kernel] = counts[kernel]
            print(f"phase 5: trained {name} in {time.perf_counter() - t0:.1f} s: "
                  + json.dumps(result))
        rows += backward_rows(backward_inputs, train_launches)
        print("phase 5: every backward kernel matches its plain version and numpy")
        del backward_inputs
        for name in TD_KERNELS:
            t0 = time.perf_counter()
            result, counts, b7_inputs = time_domain(name, served[name], log_dir)
            print(f"phase 6: time-domain synthesis {name} in {time.perf_counter() - t0:.1f} s: "
                  + json.dumps(result))
            if b7_inputs is not None:
                rows.append(tdgfdn_row(b7_inputs, counts["tdgfdn"]))
                native_inputs = b7_inputs + (receiver_output_gains(served[name], 0),)
        rooms = {name: served[name].room_data for name in CONFIGS}
        del served
        print("phase 6: B7 matches its plain version and numpy")
        t0 = time.perf_counter()
        result, band_kernel_rows = subband(tmp, log_dir)
        rows += band_kernel_rows
        print(f"phase 7: subband in {time.perf_counter() - t0:.1f} s: " + json.dumps(result))
        t0 = time.perf_counter()
        result, directional_kernel_rows, directional_srirs = directional(tmp, log_dir)
        rows += directional_kernel_rows
        print(f"phase 8: directional in {time.perf_counter() - t0:.1f} s: " + json.dumps(result))
        t0 = time.perf_counter()
        result = spatial_sampling(tmp, log_dir)
        print(f"phase 9: spatial sampling in {time.perf_counter() - t0:.1f} s: "
              + json.dumps(result))
        t0 = time.perf_counter()
        results, single_rir_kernel_rows = single_rir(tmp, log_dir)
        rows += single_rir_kernel_rows
        for result in results:
            print(f"phase 10: {result['preset']}: " + json.dumps(result))
        print(f"phase 10: single-RIR fits in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        result = spatial_cnn(tmp, log_dir)
        print(f"phase 11: floor-plan CNN in {time.perf_counter() - t0:.1f} s: "
              + json.dumps(result))
        t0 = time.perf_counter()
        result, merge_row = directional_merge(tmp)
        rows.append(merge_row)
        print(f"phase 11: directional octave-band merge in {time.perf_counter() - t0:.1f} s: "
              + json.dumps(result))
        t0 = time.perf_counter()
        for result in synth_presets(tmp):
            print("phase 12 (a): " + json.dumps(result))
        result, synth_rows = single_room(tmp)
        rows += synth_rows
        print(f"phase 12 (b): {SINGLE_ROOM_PRESET}: " + json.dumps(result))
        print("phase 12 (c): MLP search: " + json.dumps(hyp_tuning(tmp)))
        results, synth_rows = source_receiver(tmp, log_dir)
        rows += synth_rows
        for result in results:
            print("phase 12 (c): " + json.dumps(result))
        print(f"phase 12: synth presets and source heads in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        rendering(tmp, log_dir, directional_srirs, native_inputs)
        print(f"phase 13: 6DoF rendering and SOFA I/O in {time.perf_counter() - t0:.1f} s",
              flush=True)
        del directional_srirs
        t0 = time.perf_counter()
        _, option_rows = options(tmp, log_dir)
        rows += option_rows
        print(f"phase 14: coupling, absorption, encoding and loss options in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        tools(tmp, log_dir, rooms, serve_launches)
        print(f"phase 15: tools in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        _, parallel_rows = parallel(tmp, card)
        rows += parallel_rows
        print(f"phase 16: sharded paths and the matmul irfft in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        host_batches(tmp, log_dir)
        print(f"phase 17: batches made on the host in {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        result, example_rows = examples(tmp)
        rows += example_rows
        print(f"phase 18: the walkthrough and the notebook studies in "
              f"{time.perf_counter() - t0:.1f} s: " + json.dumps(result), flush=True)
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
