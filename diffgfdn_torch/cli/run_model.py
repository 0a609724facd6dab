"""CLI: train a DiffGFDN from a config (port of ``diffgfdn_tpu/cli/run_model.py``).

    python -m diffgfdn_torch.cli.run_model -c <config.yml | preset name> [--resume]

``-c`` takes a YAML file or the name of a preset in ``config/presets.py``
(``fullband_grid_colorless``, ``three_room_example``, ``subband_<f>Hz``,
``directional_<f>Hz_res<r>m``, ``single_rir_example``, the ``single_rir_*``
presets, the nine ``synth_*`` presets), which needs no YAML parser.
Trains on CUDA unless ``--device cpu`` is given. A config with ``ir_path``
fits the one RIR in that wav; one with ``ambi_order`` trains a directional
FDN on the spatial dataset at ``room_dataset_path``; any other trains on the
receiver grid. Relative paths are read from the working directory.

Under ``torchrun`` each rank joins the launch's process group (NCCL, each on
its ``cuda:LOCAL_RANK``; gloo with ``--device cpu``) and a single-position
fit shards its rFFT bins over the ranks (``--freq-parallel``, default auto:
on when more than one rank runs); only rank 0 writes (the grid and
directional trainers run as one process)::

    torchrun --nproc-per-node=<cards> -m diffgfdn_torch.cli.run_model \
        -c single_rir_example --freq-parallel on

``--profile-dir DIR`` writes a ``torch.profiler`` trace of the whole run
(``utils/profiling.trace``; each rank of several into ``DIR/rank<r>``).
"""

import argparse
import contextlib
import dataclasses
import logging
from pathlib import Path
import pickle
import shutil

import numpy as np
import torch.distributed as dist


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
    parser.add_argument("--freq-parallel", choices=("auto", "on", "off"), default="auto",
                        help="single-position fits: shard the rFFT bin axis over the ranks "
                        "of the process group (auto = on when more than one rank runs)")
    parser.add_argument("--profile-dir", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the whole run into DIR "
                        "(trace.json: chrome://tracing or Perfetto)")
    args = parser.parse_args(argv)
    if args.resume and args.wipe_train_dir:
        parser.error("--resume and --wipe-train-dir are mutually exclusive")

    from ..parallel.mesh import init_process_group_from_env
    from ..utils.device import resolve_device

    device = resolve_device(args.device)  # raises before anything is written
    ranked = init_process_group_from_env("nccl" if device.type == "cuda" else "gloo")
    if ranked is not None:
        device = ranked
    logging.basicConfig(level=logging.INFO)
    config = _load_config(args.config)
    np.random.seed(config.seed)
    if config.ir_path is not None and args.resume:
        parser.error("--resume is not supported for single-position fits "
                     "(they train in seconds from scratch)")
    if args.freq_parallel != "auto":
        config.trainer_config.use_freq_parallel = args.freq_parallel == "on"

    writer = not dist.is_initialized() or dist.get_rank() == 0
    train_dir = Path(config.trainer_config.train_dir)
    if writer:
        if args.wipe_train_dir and train_dir.exists():
            shutil.rmtree(train_dir)
        train_dir.mkdir(parents=True, exist_ok=True)
        with open(train_dir / "config_args.pickle", "wb") as f:
            pickle.dump(dataclasses.asdict(config), f)
    if dist.is_initialized():
        dist.barrier()

    if config.ir_path is None and dist.is_initialized() and dist.get_world_size() > 1:
        parser.error("only single-position fits shard over ranks: launch the grid and "
                     "directional trainers as one process")

    from ..utils.profiling import trace

    profile = contextlib.nullcontext()
    if args.profile_dir is not None:
        out = Path(args.profile_dir)
        if dist.is_initialized() and dist.get_world_size() > 1:
            out = out / f"rank{dist.get_rank()}"
        profile = trace(str(out))
    with profile:
        _dispatch(config, args, device)


def _dispatch(config, args, device) -> None:
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
