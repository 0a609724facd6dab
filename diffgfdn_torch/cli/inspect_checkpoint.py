"""CLI: inspect a trained GFDN checkpoint (port of ``cli/inspect_checkpoint.py``).

    python -m diffgfdn_torch.cli.inspect_checkpoint -c <config.yml | preset name>
        [--index N | --position x y z] [--split all|test]
        [--max-receivers M] [--out DIR] [--cs-baseline]
        [--compare-runs DIR ...] [--device cpu]

Serves the newest checkpoint under the config's ``train_dir`` (JAX's or the
port's) at up to ``--max-receivers`` receivers through
:class:`InferDiffGFDN`, on CUDA unless ``--device cpu`` is given, and maps
the grid's EDC and EDR errors against the dataset's RIRs; then a deep dive
at one receiver (truncated EDC overlay, EDR waterfalls, normalized echo
density, with ``--cs-baseline`` a common-slopes shaped-noise resynthesis
beside it), the learned coupled feedback matrix's diagonal-dominance
measure, and the loss curves of the run's ``losses.mat``.
``--compare-runs`` only compares the final losses of several train dirs.

The inspection is two steps: :func:`inspect_metrics` serves and computes
the metrics (the EDR's STFT on the device, the EDC on the host as the JAX
package computes it), and :func:`plot_inspection` draws the figures
(matplotlib). :func:`inspect` runs both and returns the metrics, as the
JAX package's ``inspect`` does.
"""

import argparse
from dataclasses import dataclass
import logging
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..utils.device import resolve_device

logger = logging.getLogger("diffgfdn_torch")

EDR_WIN = 512
CS_BASELINE_SEED = 0


def diagonal_measure(matrix: np.ndarray) -> float:
    """Squared diagonal over total energy of a matrix; 1 is perfectly
    diagonal (a learned feedback matrix that barely couples the rooms)."""
    m = np.asarray(matrix)
    return float(np.sum(np.diag(m) ** 2) / np.sum(m ** 2))


def _edc_db(rirs: np.ndarray, mix: int, crop_end: int) -> np.ndarray:
    """Truncated Schroeder EDC in dB, (..., T') from (..., T) (host)."""
    x = np.asarray(rirs)[..., mix : -crop_end if crop_end else None]
    e = np.flip(np.cumsum(np.flip(x ** 2, axis=-1), axis=-1), axis=-1)
    return 10.0 * np.log10(e + np.finfo(np.float32).tiny)


def _edr_err_db(a: np.ndarray, b: np.ndarray, device: torch.device) -> np.ndarray:
    """Per-item mean |EDR dB| error between two RIR sets, the STFTs (window
    512, hop 256) in float32 on ``device``."""
    from ..ops.stft import edr_from_stft, stft

    ea, eb = (edr_from_stft(stft(torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                                 device=device), EDR_WIN, EDR_WIN // 2))
              for x in (a, b))
    return torch.mean(torch.abs(ea - eb), dim=(-2, -1)).cpu().numpy()


@dataclass
class Inspection:
    """What :func:`inspect_metrics` computed, for :func:`plot_inspection`."""

    metrics: Dict
    fs: float
    positions: np.ndarray  # (P, 3) of the mapped receivers
    edc_err: np.ndarray
    edr_err: np.ndarray
    room_dims: List
    room_start_coord: List
    tag: str  # the deep-dive position, x_y_z
    h_true: torch.Tensor  # the deep dive's RIRs on the device
    h_synth: torch.Tensor
    rir_sets: List[np.ndarray]  # truncated: true, DiffGFDN[, common slopes]
    labels: List[str]
    feedback_matrix: np.ndarray


def inspect_metrics(
    config,
    room_data=None,
    rec_index: Optional[int] = None,
    position=None,
    split: str = "all",
    max_receivers: int = 128,
    cs_baseline: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Inspection:
    """Serve the checkpoint and compute the inspection's metrics: the mean
    EDC and EDR errors over the mapped receivers, the deep-dive receiver,
    the common-slopes baseline's EDC error (``cs_baseline``: its noise drawn
    by ``cs_synthesis.draw_noise`` from a generator seeded 0 on the device)
    and the coupled feedback matrix's diagonal measure (its z^0 tap with
    FILTER coupling)."""
    from ..data.room_dataset import ThreeRoomDataset
    from ..inference.cs_synthesis import draw_noise
    from ..inference.gfdn_inference import InferDiffGFDN
    from ..ops.basic import ms_to_samps, shaped_wgn

    dev = resolve_device(device)
    tc = config.trainer_config
    if room_data is None:
        room_data = ThreeRoomDataset(config.room_dataset_path, nfft=tc.num_freq_bins)
    fs = room_data.sample_rate
    mix = ms_to_samps(20.0, fs)
    crop_end = ms_to_samps(5.0, fs)

    # the receivers: all, or the fixed seeded test split; at most max_receivers
    indices = np.arange(room_data.num_rec)
    if split == "test" and tc.hold_out_test_set is not None:
        from ..data.batching import fixed_test_split

        test_idx, _ = fixed_test_split(room_data.num_rec, tc.hold_out_test_set.ratio,
                                       tc.hold_out_test_set.seed)
        indices = np.asarray(test_idx)
    if len(indices) > max_receivers:
        indices = indices[np.linspace(0, len(indices) - 1, max_receivers).astype(int)]

    infer = InferDiffGFDN(config, room_data, device=dev)
    synth = infer.rirs_at(indices)
    true = np.asarray(room_data.rirs)[indices]
    t_len = min(synth.shape[-1], true.shape[-1])
    synth, true = synth[..., :t_len], true[..., :t_len]

    # the grid's EDC and EDR errors
    edc_err = np.mean(np.abs(_edc_db(true, mix, crop_end) - _edc_db(synth, mix, crop_end)),
                      axis=-1)
    edr_err = _edr_err_db(true, synth, dev)
    logger.info("mean EDC error %.3f dB / mean EDR error %.3f dB over %d receivers",
                float(np.mean(edc_err)), float(np.mean(edr_err)), len(indices))

    # the deep-dive receiver
    if rec_index is None:
        if position is not None:
            d = np.linalg.norm(np.asarray(room_data.receiver_position)
                               - np.asarray(position, float)[None], axis=-1)
            rec_index = int(np.argmin(d))
        else:
            rec_index = int(indices[0])
    where = np.where(indices == rec_index)[0]
    if len(where):
        h_s = synth[int(where[0])]
    else:
        h_s = infer.rirs_at(np.asarray([rec_index]))[0][..., :t_len]
    h_t = np.asarray(room_data.rirs)[rec_index][..., :t_len]
    p = np.asarray(room_data.receiver_position)[rec_index]

    rir_sets = [h_t[mix:-crop_end], h_s[mix:-crop_end]]
    labels = ["True", "DiffGFDN"]
    metrics = {"mean_edc_err_db": float(np.mean(edc_err)),
               "mean_edr_err_db": float(np.mean(edr_err)),
               "rec_index": rec_index}

    if cs_baseline:  # a common-slopes shaped-noise resynthesis at the same position
        amps = np.asarray(room_data.amplitudes)
        a_pos = amps[rec_index] if amps.ndim == 2 else amps[rec_index, ..., 0]
        a_pos = torch.as_tensor(a_pos.reshape(1, -1), dtype=torch.float32, device=dev)
        generator = torch.Generator(device=dev).manual_seed(CS_BASELINE_SEED)
        noise = draw_noise((1, t_len), generator, dev)
        h_cs = shaped_wgn(a_pos, np.asarray(room_data.common_decay_times).reshape(-1), t_len,
                          fs, noise=noise).cpu().numpy().reshape(-1)[:t_len]
        rir_sets.append(h_cs[mix:-crop_end])
        labels.append("Common slopes")
        metrics["cs_edc_err_db"] = float(np.mean(np.abs(
            _edc_db(h_t[None], mix, crop_end) - _edc_db(h_cs[None], mix, crop_end))))

    # the learned coupling's diagnostic
    with torch.no_grad():
        a_mat = infer.model.feedback_loop.coupled_feedback_matrix().cpu().numpy()
    if a_mat.ndim == 3:  # FILTER coupling: the z^0 tap
        a_mat = a_mat[0]
    metrics["coupling_diagonal_measure"] = diagonal_measure(a_mat)
    logger.info("coupling diagonal measure: %.4f", metrics["coupling_diagonal_measure"])
    return Inspection(
        metrics=metrics, fs=fs, positions=np.asarray(room_data.receiver_position)[indices],
        edc_err=edc_err, edr_err=edr_err, room_dims=room_data.room_dims,
        room_start_coord=room_data.room_start_coord, tag=f"{p[0]:.2f}_{p[1]:.2f}_{p[2]:.2f}",
        h_true=torch.as_tensor(h_t, dtype=torch.float32, device=dev),
        h_synth=torch.as_tensor(h_s, dtype=torch.float32, device=dev),
        rir_sets=rir_sets, labels=labels, feedback_matrix=a_mat,
    )


def plot_inspection(ins: Inspection, out_dir, train_dir: Optional[str] = None) -> None:
    """The inspection's figures under ``out_dir``: the EDC and EDR error
    maps, the deep dive's EDC overlay, EDR waterfalls and echo densities,
    the coupled feedback matrix, and the loss curves of
    ``<train_dir>/losses.mat`` where it exists (matplotlib)."""
    from ..ops.basic import normalized_echo_density
    from ..utils.plot import (
        plot_edc_comparison,
        plot_edr,
        plot_loss_curves,
        plot_matrix,
        plot_position_map,
        pyplot,
    )

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for name, err in (("edc", ins.edc_err), ("edr", ins.edr_err)):
        plot_position_map(ins.positions, err, ins.room_dims, ins.room_start_coord,
                          title=f"mean {name.upper()} error", cbar_label="dB",
                          save_path=str(out / f"{name}_error_map.png"))
    tag, fs = ins.tag, ins.fs
    plot_edc_comparison(ins.rir_sets, ins.labels, fs, save_path=str(out / f"edc_overlay_{tag}.png"))
    plot_edr(ins.h_true, fs, title="True EDR", save_path=str(out / f"edr_true_{tag}.png"))
    plot_edr(ins.h_synth, fs, title="DiffGFDN EDR", save_path=str(out / f"edr_synth_{tag}.png"))

    plt = pyplot()
    fig, ax = plt.subplots(figsize=(7, 4))
    for lab, r in zip(ins.labels, ins.rir_sets):
        ned = normalized_echo_density(r, fs, window_length_ms=50.0)
        ax.plot(np.arange(len(ned)) / fs, ned, label=lab)
    ax.set_xlabel("time [s]")
    ax.set_ylabel("normalized echo density")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.savefig(out / f"echo_density_{tag}.png", dpi=120)
    plt.close(fig)

    plot_matrix(ins.feedback_matrix, title=(
        f"coupled feedback matrix (diag measure "
        f"{ins.metrics['coupling_diagonal_measure']:.3f})"),
        save_path=str(out / "coupling_matrix.png"))

    losses_mat = Path(train_dir) / "losses.mat" if train_dir is not None else None
    if losses_mat is not None and losses_mat.exists():
        import scipy.io as sio

        m = sio.loadmat(losses_mat)
        plot_loss_curves(np.asarray(m["train_loss"]).ravel(), np.asarray(m["valid_loss"]).ravel(),
                         save_path=str(out / "loss_curves.png"))


def inspect(
    config,
    room_data=None,
    rec_index: Optional[int] = None,
    position=None,
    split: str = "all",
    max_receivers: int = 128,
    out_dir: Optional[str] = None,
    cs_baseline: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Dict:
    """The whole inspection (:func:`inspect_metrics`, then
    :func:`plot_inspection` under ``out_dir``, by default
    ``<train_dir>/inspection``); returns the metrics. Raises ``ImportError``
    before serving where matplotlib is missing."""
    import matplotlib  # noqa: F401  (the figures need it: fail before serving)

    ins = inspect_metrics(config, room_data, rec_index, position, split, max_receivers,
                          cs_baseline, device)
    tc = config.trainer_config
    plot_inspection(ins, out_dir or Path(tc.train_dir) / "inspection", tc.train_dir)
    return ins.metrics


def compare_runs(train_dirs, out_path: str) -> dict:
    """Final losses of several runs (the last validation loss, else the
    last training loss, of each ``losses.mat``) as one bar figure; returns
    {train_dir: final loss}."""
    import scipy.io as sio

    from ..utils.plot import pyplot

    plt = pyplot()
    finals = {}
    for d in train_dirs:
        m = sio.loadmat(Path(d) / "losses.mat")
        v = np.asarray(m["valid_loss"]).ravel()
        t = np.asarray(m["train_loss"]).ravel()
        finals[str(d)] = float(v[-1] if len(v) and v[-1] else t[-1])
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.bar([Path(k).name for k in finals], list(finals.values()))
    ax.set_ylabel("final loss")
    ax.tick_params(axis="x", rotation=30)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return finals


def _load_config(spec: str):
    from ..config import load_and_validate_config, PRESETS, preset_config
    from ..config.schema import DiffGFDNConfig

    if spec in PRESETS:
        return preset_config(spec)
    return load_and_validate_config(spec, DiffGFDNConfig)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Inspect a trained DiffGFDN checkpoint")
    parser.add_argument("-c", "--config", required=True,
                        help="YAML config path, or the name of a preset")
    parser.add_argument("--index", type=int, default=None,
                        help="receiver index for the deep dive")
    parser.add_argument("--position", type=float, nargs=3, default=None,
                        help="receiver position (nearest grid point used)")
    parser.add_argument("--split", choices=("all", "test"), default="all")
    parser.add_argument("--max-receivers", type=int, default=128)
    parser.add_argument("--out", default=None, help="figure output dir")
    parser.add_argument("--cs-baseline", action="store_true",
                        help="add a common-slopes shaped-noise baseline")
    parser.add_argument("--compare-runs", nargs="+", default=None, metavar="TRAIN_DIR",
                        help="ONLY compare final losses across these train dirs")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)  # raises before anything is written
    logging.basicConfig(level=logging.INFO)

    if args.compare_runs:
        out = args.out or "run_comparison.png"
        for k, v in compare_runs(args.compare_runs, out).items():
            print(f"{k}: final loss {v:.4f}")
        print(f"saved {out}")
        return

    metrics = inspect(_load_config(args.config), rec_index=args.index, position=args.position,
                      split=args.split, max_receivers=args.max_receivers, out_dir=args.out,
                      cs_baseline=args.cs_baseline, device=device)
    for k, v in metrics.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
