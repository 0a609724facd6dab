#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port serves, trains and synthesizes DiffGFDNs on an NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--log-dir DIR]
    python3 chip_smoke.py --kernel-times ROOT   (alias: --cascade-times)

Phases (any failure raises and exits non-zero, with no result line):

1. build the kernels of ``diffgfdn_torch/csrc`` (one ``nvcc`` per source);
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
   library call computing the same function. Per configuration the phase prints the
   median step time after a warm-up step, steps/s and the peak memory;
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
   its bound and plain version.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. ``--kernel-times ROOT``
(or its older name ``--cascade-times``) instead only times the seven kernels
of the port's checkout under ROOT at the paths' shapes (so that two trees
can be compared in turns in one call) and prints no result line.
``--log-dir`` receives the compiler's resource report and a torch.profiler
table of one served batch and of one training step per configuration;
their wall time, the card's busy time within them and its idle share join
the configuration's phase-2 and phase-5 lines.
"""

import argparse
import contextlib
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
                  "lu_solve_kernel", "lut_apply_kernel", "tdgfdn_kernel")


def profile_once(fn, label: str, table_path: Path):
    """Run ``fn`` once under torch.profiler; write its tables (by device time,
    then by host time) to ``table_path``; return (wall ms of the window,
    device busy ms in it, device ms of the hand-written kernels in it)."""
    import torch
    from torch.profiler import profile as tprofile, ProfilerActivity, record_function

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            fn()
            torch.cuda.synchronize()
    averages = prof.key_averages()
    table_path.write_text(averages.table(sort_by="cuda_time_total", row_limit=60) + "\n"
                          + averages.table(sort_by="self_cpu_time_total", row_limit=40))
    events = prof.events()
    window = next(e.time_range for e in events if e.name == label)
    busy = device_busy_us(events, window)
    require(busy > 0.0, f"{label}: the profiled window shows no device work")
    ours = [e for e in events if any(k in e.name for k in KERNEL_SYMBOLS)]
    return window.elapsed_us() / 1e3, busy / 1e3, device_busy_us(ours, window) / 1e3


def edc_db(x: np.ndarray) -> np.ndarray:
    e = np.cumsum((x.astype(np.float64) ** 2)[..., ::-1], axis=-1)[..., ::-1]
    return 10.0 * np.log10(e + 1e-300)


def make_room(tmp: Path, name: str, fs: float, nfft: int):
    """Synthetic 3-room dataset; per-band decay times for the GEQ config."""
    from diffgfdn_torch.data import ThreeRoomDataset, generate_three_room_pickle

    rng = np.random.RandomState(SEED)
    base = rng.uniform(0.6, 1.5, 3)
    path = generate_three_room_pickle(
        tmp / name / "srirs.pkl", fs=fs, num_rec_per_room=NUM_RECEIVERS // 3,
        rir_len_s=2.0, decay_times=tuple(base), seed=SEED,
    )
    room = ThreeRoomDataset(path, nfft=nfft)
    if name == "fullband_grid_colorless":
        room.common_decay_times = base[None, :] * np.linspace(1.2, 0.8, 8)[:, None]
        room.band_centre_hz = [63.0, 125.0, 250.0, 500.0, 1000.0, 2000.0, 4000.0, 8000.0]
    return room


def kernel_wrappers():
    """{name: the wrapper that counts the kernel's launches}."""
    from diffgfdn_torch.kernels import cinv, lu, sos, tdgfdn

    return {
        "cinv": cinv.cinv,
        "neg_ptgpt": cinv.neg_ptgpt,
        "sos": sos.sos_cascade_response,
        "sos_backward": sos.sos_cascade_backward,
        "lu": lu.lu_solve,
        "lut_apply": lu.lut_apply,
        "tdgfdn": tdgfdn.delay_line_outputs,
    }


def launch_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_counts() -> None:
    for fn in kernel_wrappers().values():
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
        wall, busy, ours = profile_once(lambda: infer.rirs_at(idx[:BATCH], BATCH),
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
        _, num, den = svf_params_to_response(head.mlp(head.encoding(pos)), head.cutoffs, z)
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
def recording_kernel_inputs(store: dict):
    """Within the block, the wrappers of B5 and of the backward kernels keep
    a copy of the inputs of their first call, under the kernel's name."""
    from diffgfdn_torch.kernels import cinv, lu, sos

    patched = [(cinv, "neg_ptgpt", "neg_ptgpt"), (lu, "lut_apply", "lut_apply"),
               (lu, "lu_solve", "lu"), (sos, "sos_cascade_backward", "sos_backward")]
    originals = [getattr(mod, attr) for mod, attr, _ in patched]

    def recorder(fn, name):
        def wrapped(*args):
            store.setdefault(name, tuple(a.detach().clone() for a in args))
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

    # step time, as fit_indexed runs a step: warm-up, then timed steps
    trainer.fit_step(idx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        trainer.fit_step(idx)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    per_step = {k: launch_counts()[k] / TIMED_STEPS for k in TRAIN_KERNELS[name]}
    peak_step = torch.cuda.max_memory_allocated()
    with plain_versions():
        t0 = time.perf_counter()
        trainer.fit_step(idx)
        torch.cuda.synchronize()
        plain_step_s = time.perf_counter() - t0
    profiled = {}
    if log_dir is not None:
        wall, busy, ours = profile_once(lambda: trainer.fit_step(idx), "train_step",
                                        Path(log_dir) / f"profile_train_{name}.txt")
        profiled = {"profiled_step_ms": wall, "profiled_device_busy_ms": busy,
                    "profiled_kernels_ms": ours, "profiled_idle_share": 1.0 - busy / wall}
    step_s = float(np.median(times))
    result = {
        "config": name,
        "epochs": TRAIN_EPOCHS,
        "steps_per_epoch": trainer.steps_per_epoch,
        "batch": BATCH,
        "nfft": tc.num_freq_bins,
        "run_s": run_s,
        "train_loss": trainer.train_loss,
        "valid_loss": trainer.valid_loss,
        "step_ms": step_s * 1e3,
        "step_ms_all": [t * 1e3 for t in times],
        "steps_per_s": 1.0 / step_s,
        "plain_step_ms": plain_step_s * 1e3,
        "peak_mem_run_mb": peak_run / 2 ** 20,
        "peak_mem_step_mb": peak_step / 2 ** 20,
        "step_loss_rel_vs_plain": loss_rel,
        "max_grad_rel_l2_vs_plain": grad_errs[worst],
        "launches": {k: launches[k] for k in TRAIN_KERNELS[name]},
        "launches_per_step": per_step,
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
    samples and at a 50000-sample spread. Per kernel and shape:
    the wrapper call's time (``ms``), the kernel's own device time
    (``kernel_ms``) and the bound; and, when this process built them,
    ptxas's registers, spill-store and stack-frame bytes of
    ``cinv_kernel<4>``, ``neg_ptgpt_kernel<4>``, the cascade kernels at
    K = 11, ``lu_solve_kernel<4>`` and ``<9>``, ``lut_apply_kernel<4>`` and
    the B7 kernels at N = 12, with the shared-memory loads (LDS) cuobjdump
    counts in the B7 kernels. Runs any tree of the port, whether its B4
    reads h or recomputes it and whichever C entry point its B7 has."""
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
        _, num, den = svf_params_to_response(head.mlp(head.encoding(pos)), head.cutoffs, z)
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
          ("tdgfdn_kernel<12>", "tdgfdn_kernelILi12E"))
    out["b7_sass"] = {label: sass_counts(_build.library_path("tdgfdn"), frag)
                      for label, frag in b7}
    if any(logs.values()):
        out["ptxas"] = {
            "cinv_kernel<4>": ptxas_usage(logs["cinv"], "cinv_kernelILi4E"),
            "neg_ptgpt_kernel<4>": ptxas_usage(logs["cinv"], "neg_ptgpt_kernelILi4E"),
            "sos_cascade_kernel": (ptxas_usage(logs["sos"], f"sos_cascade_kernelILi{k}E")
                                   or ptxas_usage(logs["sos"], "sos_cascade_kernelE")),
            f"sos_bwd_partial_kernel<{k}>": ptxas_usage(logs["sos"],
                                                        f"sos_bwd_partial_kernelILi{k}E"),
            "lu_solve_kernel<4>": ptxas_usage(logs["lu"], "lu_solve_kernelILi4E"),
            "lu_solve_kernel<9>": ptxas_usage(logs["lu"], "lu_solve_kernelILi9E"),
            "lut_apply_kernel<4>": ptxas_usage(logs["lu"], "lut_apply_kernelILi4E"),
            **{label: ptxas_usage(logs["tdgfdn"], frag) for label, frag in b7},
        }
    for label, m in (("path", m_path), ("N=12", random_systems(65537, 12, gen)[0]),
                     ("N=27", random_systems(65537, 27, gen)[0])):
        kb, n = m.shape[0], m.shape[1]
        p = cinv.cinv(m)
        g_p = torch.randn(p.shape, dtype=torch.complex64, device=DEVICE, generator=gen)
        out[f"cinv {label}"] = {
            "shape": list(m.shape), "ms": device_ms(lambda: cinv.cinv(m)),
            "kernel_ms": kernel_ms(lambda: cinv.cinv(m)), "bound_ms": bound(*cinv_cost(kb, n))[0],
            "library_ms": device_ms(lambda: torch.linalg.inv(m))}
        out[f"neg_ptgpt {label}"] = {
            "shape": list(p.shape), "ms": device_ms(lambda: cinv.neg_ptgpt(p, g_p)),
            "kernel_ms": kernel_ms(lambda: cinv.neg_ptgpt(p, g_p)),
            "bound_ms": bound(*neg_ptgpt_cost(kb, n))[0],
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
        wall, busy, ours = profile_once(lambda: synth(batches[0]), "td_batch",
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--log-dir", default=None,
                        help="write the build log and a profile of one served batch here")
    parser.add_argument("--kernel-times", "--cascade-times", dest="kernel_times",
                        metavar="ROOT", default=None,
                        help="only time the kernels B1-B7 of the diffgfdn_torch package "
                             "under ROOT (another checkout of the port) and print them as one "
                             "JSON line; no result line")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.kernel_times is not None:
        print(card_line())
        print(json.dumps({"kernel_times": kernel_times(Path(args.kernel_times))}))
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
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    if log_dir is not None:
        (log_dir / "nvcc.log").write_text(
            "\n".join(f"==== {k}\n{v}" for k, v in logs.items())
        )

    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        served, launches, results = {}, {}, []
        for name in CONFIGS:
            t0 = time.perf_counter()
            served[name], counts, result = serve(name, tmp, log_dir)
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
        del served
        print("phase 6: B7 matches its plain version and numpy")
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
