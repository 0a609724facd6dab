"""CLI: train a DiffGFDN from a config (port of ``diffgfdn_tpu/cli/run_model.py``).

    python -m diffgfdn_torch.cli.run_model -c <config.yml | preset name> [--resume]

``-c`` takes a YAML file or the name of a preset in ``config/presets.py``
(``fullband_grid_colorless``, ``three_room_example``, ``subband_<f>Hz``,
``directional_<f>Hz_res<r>m``, ``single_rir_example``, the ``single_rir_*``
presets, ``synth_broadband_colorless_proto``), which needs no YAML parser.
Trains on CUDA unless ``--device cpu`` is given. A config with ``ir_path``
fits the one RIR in that wav; one with ``ambi_order`` trains a directional
FDN on the spatial dataset at ``room_dataset_path``; any other trains on the
receiver grid. Relative paths are read from the working directory.
"""

import argparse
import dataclasses
import logging
from pathlib import Path
import pickle
import shutil

import numpy as np


def _load_config(spec: str):
    from ..config import load_and_validate_config, PRESETS, preset_config
    from ..config.schema import DiffGFDNConfig

    if spec in PRESETS:
        return preset_config(spec)
    return load_and_validate_config(spec, DiffGFDNConfig)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Train a DiffGFDN with the PyTorch port")
    parser.add_argument("-c", "--config", required=True,
                        help="YAML config path, or the name of a preset")
    parser.add_argument("--wipe-train-dir", action="store_true",
                        help="delete and recreate the training directory first")
    parser.add_argument("--resume", action="store_true",
                        help="continue an interrupted run from the newest checkpoint "
                        "(parameters and optimizer state)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.resume and args.wipe_train_dir:
        parser.error("--resume and --wipe-train-dir are mutually exclusive")

    from ..utils.device import resolve_device

    device = resolve_device(args.device)  # raises before anything is written
    logging.basicConfig(level=logging.INFO)
    config = _load_config(args.config)
    np.random.seed(config.seed)
    if config.ir_path is not None and args.resume:
        parser.error("--resume is not supported for single-position fits "
                     "(they train in seconds from scratch)")

    train_dir = Path(config.trainer_config.train_dir)
    if args.wipe_train_dir and train_dir.exists():
        shutil.rmtree(train_dir)
    train_dir.mkdir(parents=True, exist_ok=True)
    with open(train_dir / "config_args.pickle", "wb") as f:
        pickle.dump(dataclasses.asdict(config), f)

    from ..training.solver import (
        run_training_anisotropic_decay_var_receiver_pos,
        run_training_single_pos,
        run_training_var_receiver_pos,
    )

    if config.ir_path is not None:
        run_training_single_pos(config, device=device)
    elif config.ambi_order is not None:
        from ..data.spatial_dataset import SpatialThreeRoomDataset

        room_data = SpatialThreeRoomDataset(config.room_dataset_path)
        run_training_anisotropic_decay_var_receiver_pos(config, room_data, resume=args.resume,
                                                        device=device)
    else:
        run_training_var_receiver_pos(config, export_irs=True, resume=args.resume, device=device)


if __name__ == "__main__":
    main()
