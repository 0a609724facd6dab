"""CLI: the common-slopes MLP against barycentric interpolation (port of
``cli/compare_baselines.py``).

    python -m diffgfdn_torch.cli.compare_baselines --dataset <spatial.pkl>
        --out <dir> --grid-resolution <m> [--train-dir DIR] [--max-epochs N]
        [--mlp-layers L] [--mlp-neurons W] [--seed S] [--no-naf-export]
        [--device cpu]

1. split a spatial SRIR grid by grid resolution (training subgrid against
   held-out receivers);
2. train (or load from ``--train-dir``) the common-slopes MLP and serve
   SRIRs at the held-out positions, on CUDA unless ``--device cpu``;
3. interpolate SRIRs at the same positions barycentrically from the
   training subgrid (host numpy);
4. per-direction EDC-error maps (mean |dB| Schroeder difference after the
   mixing time) of both against the measured SRIRs, a JSON summary
   (``comparison_summary.json``) and the maps over the floor plan;
5. optionally NAF-compatible train / infer pickles of the same split.

:func:`compare` runs steps 1-5 without plotting, :func:`plot_error_maps`
draws the maps (matplotlib), and :func:`run_comparison` runs both, as the
JAX package's ``run_comparison`` does.
"""

import argparse
import json
import logging
from pathlib import Path
import pickle
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device

logger = logging.getLogger("diffgfdn_torch")


def edc_error_db(ref_rirs: np.ndarray, pred_rirs: np.ndarray, mixing_time_samps: int
                 ) -> np.ndarray:
    """Mean |dB| Schroeder-EDC difference per leading entry of (..., T)
    arrays, from the mixing time on (host float64)."""
    from ..analysis import schroeder_edc
    from ..ops.basic import db_np

    n = min(ref_rirs.shape[-1], pred_rirs.shape[-1])
    ref = db_np(schroeder_edc(ref_rirs[..., mixing_time_samps:n]), is_squared=True)
    pred = db_np(schroeder_edc(pred_rirs[..., mixing_time_samps:n]), is_squared=True)
    return np.mean(np.abs(ref - pred), axis=-1)


def interpolate_srirs(train_positions: np.ndarray, train_srirs: np.ndarray,
                      query_positions: np.ndarray):
    """Barycentric SRIR interpolation of (M, C, T) ambisonic or (M, T) omni
    SRIRs; returns the interpolated dataset, its RIRs in the same layout."""
    from ..data.naf import barycentric_interpolate

    srirs = np.asarray(train_srirs)
    omni = srirs.ndim == 2
    if omni:
        srirs = srirs[:, None, :]
    m, c, t = srirs.shape
    ds = barycentric_interpolate(train_positions, srirs.reshape(m, c * t), query_positions)
    ds.rirs = ds.rirs.reshape(len(query_positions), c, t)
    if omni:
        ds.rirs = ds.rirs[:, 0]
    return ds


def export_naf_dataset(room_data, train_idx: np.ndarray, valid_idx: np.ndarray,
                       out_dir: Path, grid_resolution_m: float) -> Dict[str, Path]:
    """NAF-compatible train / infer pickles of the split,
    ``naf_{train,infer}_grid=<res>m.pkl`` under ``out_dir``."""
    from ..data.naf import NAFDatasetInfer, NAFDatasetTrain

    meta = {
        "grid_resolution_m": grid_resolution_m,
        "band_centre_hz": np.atleast_1d(room_data.band_centre_hz).tolist(),
        "source_position": np.asarray(room_data.source_position).tolist(),
        "ambi_order": room_data.ambi_order,
    }
    train = NAFDatasetTrain(receiver_position=room_data.receiver_position[train_idx],
                            rirs=room_data.rirs[train_idx],
                            sample_rate=float(room_data.sample_rate), metadata=meta)
    infer = NAFDatasetInfer(receiver_position=room_data.receiver_position[valid_idx],
                            sample_rate=float(room_data.sample_rate), metadata=meta)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, obj in (("naf_train", train), ("naf_infer", infer)):
        p = out_dir / f"{name}_grid={grid_resolution_m:.1f}m.pkl"
        with open(p, "wb") as f:
            pickle.dump(obj, f)
        paths[name] = p
    return paths


def compare(
    dataset_path: str,
    out_dir: str,
    grid_resolution_m: float,
    train_dir: Optional[str] = None,
    max_epochs: int = 10,
    mixing_time_ms: float = 20.0,
    export_naf: bool = True,
    mlp_layers: int = 3,
    mlp_neurons: int = 64,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[Dict, Dict[str, np.ndarray], np.ndarray, object]:
    """Steps 1-5 without plotting: (summary, {method: (P, J) EDC errors in
    dB}, the held-out positions, the dataset). Writes the NAF exports and
    ``comparison_summary.json`` under ``out_dir``."""
    from ..config.schema import SpatialSamplingConfig
    from ..data.spatial_dataset import SpatialThreeRoomDataset, split_by_grid_resolution
    from ..inference.spatial_inference import get_soundfield_from_trained_model
    from ..ops.basic import ms_to_samps
    from ..training.spatial_trainer import run_training_spatial_sampling
    from .convert_dataset import process_srirs_to_directional

    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    room = SpatialThreeRoomDataset(dataset_path)
    train_idx, valid_idx = split_by_grid_resolution(room, grid_resolution_m)
    logger.info("grid split at %.1f m: %d train / %d held-out receivers",
                grid_resolution_m, len(train_idx), len(valid_idx))
    valid_pos = room.receiver_position[valid_idx]
    mix = ms_to_samps(mixing_time_ms, room.sample_rate)
    directional = room.sph_directions is not None and room.rirs.ndim == 3

    # 2. the common-slopes model, trained unless its checkpoint exists
    cfg = SpatialSamplingConfig.from_dict(dict(
        room_dataset_path=str(dataset_path), batch_size=16, seed=seed,
        max_epochs=max_epochs, lr=5e-3, train_dir=train_dir or str(out / "cs_model"),
        use_directional_rirs=directional,
        dnn_config=dict(mlp_config=dict(num_hidden_layers=mlp_layers,
                                        num_neurons_per_layer=mlp_neurons),
                        num_fourier_features=10),
    ))

    def serve():
        rirs, _ = get_soundfield_from_trained_model(
            [cfg], room, valid_pos, room.rir_length, grid_resolution_m=grid_resolution_m,
            seed=seed, device=dev)
        return rirs.cpu().numpy()

    try:
        model_srirs = serve()
        logger.info("loaded trained CS model from %s", cfg.train_dir)
    except FileNotFoundError:
        logger.info("no checkpoint under %s — training", cfg.train_dir)
        run_training_spatial_sampling(cfg, room_data=room, grid_resolutions=[grid_resolution_m],
                                      device=dev)
        model_srirs = serve()

    # 3. the barycentric baseline
    bary = interpolate_srirs(room.receiver_position[train_idx], room.rirs[train_idx], valid_pos)

    # 4. EDC errors against the measured SRIRs, per direction
    ref = room.rirs[valid_idx]
    if directional:
        ref_d, model_d, bary_d = (
            process_srirs_to_directional(x, room.ambi_order, room.sph_directions, device=dev)
            for x in (ref, model_srirs, np.asarray(bary.rirs)))
    else:
        ref_d, model_d, bary_d = (x[:, None, :] for x in (ref, model_srirs,
                                                         np.asarray(bary.rirs)))
    err = {"common_slopes_model": edc_error_db(ref_d, model_d, mix),
           "barycentric": edc_error_db(ref_d, bary_d, mix)}  # each (P, J)

    summary = {"grid_resolution_m": grid_resolution_m, "num_train": int(len(train_idx)),
               "num_heldout": int(len(valid_idx))}
    for name, e in err.items():
        summary[f"{name}_mean_edc_error_db"] = float(np.mean(e))
        summary[f"{name}_per_direction_db"] = np.mean(e, axis=0).tolist()
    logger.info("mean EDC error: CS model %.3f dB vs barycentric %.3f dB",
                summary["common_slopes_model_mean_edc_error_db"],
                summary["barycentric_mean_edc_error_db"])

    # 5. the NAF export
    if export_naf:
        paths = export_naf_dataset(room, train_idx, valid_idx, out, grid_resolution_m)
        summary["naf_exports"] = {k: str(v) for k, v in paths.items()}
    with open(out / "comparison_summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    return summary, err, valid_pos, room


def plot_error_maps(err: Dict[str, np.ndarray], valid_pos: np.ndarray, room,
                    grid_resolution_m: float, out_dir: str) -> None:
    """Each method's mean EDC error per held-out receiver over the floor
    plan, ``edc_error_map_<method>.png`` under ``out_dir`` (matplotlib)."""
    from ..utils.plot import plot_position_map

    for name, e in err.items():
        plot_position_map(
            valid_pos, np.mean(e, axis=-1), room.room_dims, room.room_start_coord,
            aperture_coords=room.aperture_coords,
            title=f"{name}: mean EDC error ({np.mean(e):.2f} dB, grid {grid_resolution_m:.1f} m)",
            cbar_label="EDC error [dB]",
            save_path=str(Path(out_dir) / f"edc_error_map_{name}.png"),
        )


def run_comparison(dataset_path: str, out_dir: str, grid_resolution_m: float, **kwargs) -> Dict:
    """The whole comparison (:func:`compare`, then :func:`plot_error_maps`);
    returns the summary. Raises ``ImportError`` before any work where
    matplotlib is missing."""
    import matplotlib  # noqa: F401  (the maps need it: fail before training)

    summary, err, valid_pos, room = compare(dataset_path, out_dir, grid_resolution_m, **kwargs)
    plot_error_maps(err, valid_pos, room, grid_resolution_m, out_dir)
    return summary


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", required=True, help="spatial SRIR pickle")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--grid-resolution", type=float, required=True)
    ap.add_argument("--train-dir", default=None,
                    help="existing CS-model train dir (else trains fresh)")
    ap.add_argument("--max-epochs", type=int, default=10)
    ap.add_argument("--mixing-time-ms", type=float, default=20.0)
    ap.add_argument("--mlp-layers", type=int, default=3)
    ap.add_argument("--mlp-neurons", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-naf-export", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises before anything is written
    logging.basicConfig(level=logging.INFO)
    summary = run_comparison(
        args.dataset, args.out, args.grid_resolution, train_dir=args.train_dir,
        max_epochs=args.max_epochs, mixing_time_ms=args.mixing_time_ms,
        export_naf=not args.no_naf_export, mlp_layers=args.mlp_layers,
        mlp_neurons=args.mlp_neurons, seed=args.seed, device=device,
    )
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
