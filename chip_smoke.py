#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port serves DiffGFDN RIRs on an NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--log-dir DIR]

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
   against a float64 numpy reference on a few systems;
4. time each kernel, its plain version and the library call computing the
   same function (CUDA events, L2 flushed before each launch), and the
   served RIRs per second of each configuration.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. ``--log-dir`` receives
the compiler's resource report and a torch.profiler table of one served
batch per configuration; that batch's wall time, the card's busy time within
it and its idle share join the configuration's phase-2 line.
"""

import argparse
import json
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
# the slice's two configurations and the kernels each one's path launches
CONFIGS = {
    "fullband_grid_colorless": ("cinv", "sos"),
    "three_room_example": ("lu",),
}
RIR_TOL = 1e-3   # relative L2 error of the RIRs, kernel path vs plain path
EDC_TOL_DB = 0.01  # Schroeder EDC difference over the first 0.5 s
KERNEL_TOL = 1e-4  # max abs error / max |plain|
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


def launch_counts():
    from diffgfdn_torch.kernels import cinv, lu, sos

    return {
        "cinv": cinv.cinv.launches,
        "sos": sos.sos_cascade_response.launches,
        "lu": lu.lu_solve.launches,
    }


def reset_counts() -> None:
    from diffgfdn_torch.kernels import cinv, lu, sos

    cinv.cinv.launches = 0
    sos.sos_cascade_response.launches = 0
    lu.lu_solve.launches = 0


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
        from torch.profiler import profile as tprofile, ProfilerActivity, record_function

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("served_batch"):
                infer.rirs_at(idx[:BATCH], BATCH)
                torch.cuda.synchronize()
        (Path(log_dir) / f"profile_{name}.txt").write_text(
            prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
        )
        events = prof.events()
        window = next(e.time_range for e in events if e.name == "served_batch")
        busy = device_busy_us(events, window)
        require(busy > 0.0, f"{name}: the profiled batch shows no device work")
        profiled = {
            "profiled_batch_ms": window.elapsed_us() / 1e3,
            "profiled_device_busy_ms": busy / 1e3,
            "profiled_idle_share": 1.0 - busy / window.elapsed_us(),
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
        err = rel_err(out, ref)
        require(err <= KERNEL_TOL, f"cinv {label}: rel err {err}")
        m64 = m[:256].cpu().numpy().astype(np.complex128)
        inv64 = np.linalg.inv(m64)
        err64 = float(np.abs(out[:256].cpu().numpy() - inv64).max() / np.abs(inv64).max())
        require(err64 <= KERNEL_TOL, f"cinv {label}: vs float64 numpy {err64}")
        if label == "path":
            errors["cinv"] = float(torch.max(torch.abs(out - ref)))
        print(f"cinv {label} {tuple(m.shape)}: rel err vs plain {err:.3e}, vs numpy {err64:.3e}")

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
        piv_diff = int((piv != piv_p).sum())
        require(err_x <= KERNEL_TOL and err_lu <= KERNEL_TOL,
                f"lu {label}: rel err x {err_x}, factors {err_lu}")
        require(piv_diff == 0, f"lu {label}: {piv_diff} pivots differ from the plain version")
        m64, b64 = m[:256].cpu().numpy().astype(np.complex128), b[:256].cpu().numpy()
        x64 = np.linalg.solve(m64, b64[..., None])[..., 0]
        err64 = float(np.abs(x[:256].cpu().numpy() - x64).max() / np.abs(x64).max())
        require(err64 <= KERNEL_TOL, f"lu {label}: vs float64 numpy {err64}")
        if label == "path":
            errors["lu"] = float(torch.max(torch.abs(x - x_p)))
        print(f"lu {label} {tuple(m.shape)}: rel err x {err_x:.3e}, factors {err_lu:.3e}, "
              f"pivots differing {piv_diff}, vs numpy {err64:.3e}")
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
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: torch.linalg.solve(m, b.unsqueeze(-1))),
    })
    # the SOS kernel at the absorption shape (R = N = 12) is printed, not listed
    num, den, z = inputs["sos12"]
    b_ms, _ = bound(*sos_cost(num.shape[0], num.shape[1], z.shape[0]))
    print(f"sos at R={num.shape[0]}: {device_ms(lambda: sos_cascade_response(num, den, z)):.4f} ms "
          f"(plain {device_ms(lambda: plain(sos_cascade_response, num, den, z)):.4f} ms, "
          f"bound {b_ms:.4f} ms)")
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--log-dir", default=None,
                        help="write the build log and a profile of one served batch here")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
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
