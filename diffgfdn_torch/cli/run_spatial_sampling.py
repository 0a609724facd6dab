"""CLI: common-slopes spatial-sampling training and all-band inference (port of
``cli/run_spatial_sampling.py``).

    python -m diffgfdn_torch.cli.run_spatial_sampling -c <config.yml | preset name> [--device cpu]
    python -m diffgfdn_torch.cli.run_spatial_sampling -c <config> --infer-dataset <srirs.pkl>
        [--band-configs <config> ...] [--grid-resolution 0.3] [--output <path>]
        [--return-brirs --hrtf <hrir.sofa>] [--device cpu]

``-c`` (and each ``--band-configs`` entry) takes a YAML file or the name of a
spatial preset in ``config/presets.py`` (``spatial_directional_1000Hz``,
``spatial_directional_1000Hz_cnn``, ``spatial_omni_1000Hz``), which needs no
YAML parser. Without ``--infer-dataset`` it trains one model per grid
resolution on the spatial dataset at ``room_dataset_path``: the position
MLPs on receiver batches, the floor-plan CNN (``network_type: cnn``) on one
full-grid batch per resolution. With it, it serves every receiver of that
dataset from the band configs' checkpoints at ``--grid-resolution``
(reference: src/run_test_spatial_sampling.py:22-227) and writes the SRIRs
as a SingleRoomSRIR SOFA file (``<output>.sofa``), or with
``--return-brirs`` converts them to BRIRs at one head orientation through
the HRIR set of ``--hrtf`` and pickles them (``<output>.pkl``). Everything
runs on CUDA unless ``--device cpu`` is given; the SOFA files need h5py.
"""

import argparse
import logging
from pathlib import Path
import pickle
from typing import List, Optional

import numpy as np

# JAX's argparse defaults; the flags default to None here so that the parser
# can tell a given inference-only flag from an absent one
GRID_RESOLUTION_M = 0.3
OUTPUT = "output/spatial/srirs_est"


def _load_config(spec: str):
    from ..config import load_and_validate_config, SPATIAL_PRESETS, spatial_preset_config
    from ..config.schema import SpatialSamplingConfig

    if spec in SPATIAL_PRESETS:
        return spatial_preset_config(spec)
    return load_and_validate_config(spec, SpatialSamplingConfig)


def run_inference_on_all_bands(
    config_paths: List[str],
    dataset_path: str,
    grid_resolution_m: float,
    output_path: str,
    return_brirs: bool = False,
    hrtf_path: Optional[str] = None,
    device="cuda",
) -> Path:
    """Serve every receiver of the spatial dataset at ``dataset_path`` from
    the configs' trained models and write ``<output_path>.sofa`` (SRIRs) or,
    with ``return_brirs``, ``<output_path>.pkl`` ({"brirs": (P, 1, nfft, 2),
    "positions": (P, 3)}); returns the path written."""
    from ..data.spatial_dataset import SpatialThreeRoomDataset
    from ..inference.spatial_inference import get_ambisonic_rirs
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    if return_brirs and hrtf_path is None:
        raise ValueError("--return-brirs needs an HRIR SOFA file (--hrtf)")
    room_data = SpatialThreeRoomDataset(dataset_path)
    configs = [_load_config(p) for p in config_paths]
    cs_room = get_ambisonic_rirs(
        room_data.receiver_position,
        room_data,
        use_trained_model=True,
        configs=configs,
        grid_resolution_m=grid_resolution_m,
        device=dev,
    )
    out = Path(output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    if return_brirs:
        from ..inference.sofa import convert_srir_to_brir, HRIRSOFAReader

        reader = HRIRSOFAReader(hrtf_path)
        if reader.fs != cs_room.sample_rate:
            reader.resample_hrirs(cs_room.sample_rate)
        orientations = np.array([[0.0, 0.0]])
        brirs = convert_srir_to_brir(cs_room.rirs, reader, orientations, device=dev)
        path = out.with_suffix(".pkl")
        with open(path, "wb") as f:
            pickle.dump({"brirs": brirs, "positions": cs_room.receiver_position}, f)
        return path
    from ..inference.sofa import SRIRSOFAWriter

    rirs = np.asarray(cs_room.rirs)
    if rirs.ndim == 2:  # omni synthesis: single receiver channel
        rirs = rirs[:, None, :]
    ambi_order = int(np.sqrt(rirs.shape[1]) - 1)
    writer = SRIRSOFAWriter(
        cs_room.num_rec, ambi_order, cs_room.rir_length, cs_room.sample_rate,
    )
    writer.set_ir_data(rirs)
    writer.set_receiver_positions(cs_room.receiver_position)
    writer.set_source_positions(cs_room.source_position)
    path = out.with_suffix(".sofa")
    writer.write_to_file(path)
    return path


def main(argv=None):
    """Parse ``argv``, then train (returns ``run_training_spatial_sampling``'s
    {resolution: (trainer, model)}) or, with ``--infer-dataset``, infer
    (returns the path written)."""
    parser = argparse.ArgumentParser(
        description="Common-slopes spatial-sampling training / inference with the PyTorch port")
    parser.add_argument("-c", "--config", required=True,
                        help="YAML config path, or the name of a spatial preset")
    parser.add_argument("--infer-dataset", default=None,
                        help="run all-band inference on this dataset")
    parser.add_argument("--band-configs", nargs="*", default=None,
                        help="per-band configs (YAML paths or preset names) for inference")
    parser.add_argument("--grid-resolution", type=float, default=None,
                        help=f"checkpoints' grid resolution in m (default {GRID_RESOLUTION_M})")
    parser.add_argument("--output", default=None,
                        help=f"output path without suffix (default {OUTPUT})")
    parser.add_argument("--return-brirs", action="store_true",
                        help="write BRIRs (pickle) instead of SRIRs (SOFA)")
    parser.add_argument("--hrtf", default=None, help="HRTF SOFA path")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    inference_only = {"--band-configs": args.band_configs is not None,
                      "--grid-resolution": args.grid_resolution is not None,
                      "--output": args.output is not None,
                      "--return-brirs": args.return_brirs, "--hrtf": args.hrtf is not None}
    given = [flag for flag, set_ in inference_only.items() if set_]
    if args.infer_dataset is None and given:
        parser.error(f"{', '.join(given)} apply to inference only: add --infer-dataset")

    from ..utils.device import resolve_device

    device = resolve_device(args.device)  # raises before anything is written
    logging.basicConfig(level=logging.INFO)
    if args.infer_dataset is not None:
        # no per-band configs -> single-band inference with the main config
        band_configs = args.band_configs or [args.config]
        return run_inference_on_all_bands(
            band_configs, args.infer_dataset,
            GRID_RESOLUTION_M if args.grid_resolution is None else args.grid_resolution,
            args.output or OUTPUT, args.return_brirs, args.hrtf,
            device=device,
        )

    from ..training.spatial_trainer import run_training_spatial_sampling

    return run_training_spatial_sampling(_load_config(args.config), device=device)


if __name__ == "__main__":
    main()
