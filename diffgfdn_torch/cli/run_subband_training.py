"""CLI: octave-band DiffGFDN training and broadband reconstruction (port of
``diffgfdn_tpu/cli/run_subband_training.py``).

    python -m diffgfdn_torch.cli.run_subband_training --dataset srirs.pkl \\
        [--freqs 63 125 ...] [--band-parallel] [--infer] [--device cpu]

One model per octave band, each from :func:`create_config` (its own seed and
MLP size); training runs the bands one after the other through
``run_training_var_receiver_pos``, or with ``--band-parallel`` the bands of
each architecture group as one step (``parallel/band_parallel.py``).
``--infer`` merges the bands' RIRs into broadband RIRs
(``broadband_rirs.npy`` in the training directory). Runs on CUDA unless
``--device cpu`` is given.

Under ``torchrun`` (``--band-parallel`` only) each rank joins the launch's
process group (NCCL on ``cuda:LOCAL_RANK``; gloo with ``--device cpu``) and
each architecture group trains over ``make_mesh(len(group))``, the JAX
trainer's default mesh: its bands over the band axis, each batch's receivers
over the batch axis; each band's checkpoints are written by one rank::

    torchrun --nproc-per-node=<cards> -m diffgfdn_torch.cli.run_subband_training \
        --dataset srirs.pkl --band-parallel
"""

import argparse
import logging
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

DEFAULT_FREQS = [63.0, 125.0, 250.0, 500.0, 1000.0, 2000.0, 4000.0, 8000.0]

# per-band MLP (hidden layers, neurons per layer)
BAND_MLP_PARAMS: Dict[float, Tuple[int, int]] = {
    63.0: (3, 64), 125.0: (3, 64), 250.0: (3, 128), 500.0: (3, 128),
    1000.0: (3, 128), 2000.0: (3, 128), 4000.0: (4, 128), 8000.0: (4, 128),
}

logger = logging.getLogger("diffgfdn_torch")


def create_config(
    freq: float,
    dataset_path: str,
    base_train_dir: str = "output/subband",
    num_freq_bins: int = 2 ** 17,
    sample_rate: float = 32000.0,
    max_epochs: int = 20,
    batch_size: int = 32,
    use_colorless_loss: bool = True,
):
    """The DiffGFDNConfig of one octave band (the JAX CLI's ``create_config``)."""
    from ..config.schema import DiffGFDNConfig

    layers, neurons = BAND_MLP_PARAMS.get(freq, (3, 128))
    return DiffGFDNConfig.from_dict(dict(
        seed=int(235 + freq),
        room_dataset_path=dataset_path,
        num_groups=3,
        sample_rate=sample_rate,
        num_delay_lines=12,
        trainer_config=dict(
            batch_size=batch_size,
            num_freq_bins=num_freq_bins,
            max_epochs=max_epochs,
            lr=1e-3,
            io_lr=1e-3,
            coupling_angle_lr=1e-3,
            use_colorless_loss=use_colorless_loss,
            subband_process_config=dict(
                centre_frequency=freq,
                frequency_range=(63.0, min(16000.0, sample_rate / 2)),
                num_fraction_octaves=1,
            ),
            train_dir=f"{base_train_dir}/band_{freq:.0f}Hz/",
            ir_dir=f"{base_train_dir}/band_{freq:.0f}Hz/audio/",
        ),
        output_filter_config=dict(
            use_svfs=False, num_hidden_layers=layers, num_neurons_per_layer=neurons,
        ),
        colorless_fdn_config=dict(use_colorless_prototype=False),
    ))


def _room(configs, room_data):
    from ..data.room_dataset import ThreeRoomDataset

    if room_data is not None:
        return room_data
    return ThreeRoomDataset(configs[0].room_dataset_path,
                            nfft=configs[0].trainer_config.num_freq_bins)


def training(configs, room_data=None, device: Union[str, torch.device] = "cuda") -> None:
    """The bands one after the other, each a grid-of-receivers training."""
    from ..training.solver import run_training_var_receiver_pos

    for cfg in configs:
        run_training_var_receiver_pos(cfg, room_data=room_data, device=device)


def _architecture_key(cfg) -> Tuple:
    """The config fields that fix the parameter shapes of a band model."""
    oc = cfg.output_filter_config
    return (oc.num_hidden_layers, oc.num_neurons_per_layer, oc.num_fourier_features,
            oc.use_svfs, cfg.num_delay_lines, cfg.num_groups)


def architecture_groups(configs) -> List[list]:
    """The configs grouped by architecture, in order of first appearance."""
    groups: Dict[Tuple, list] = {}
    for cfg in configs:
        groups.setdefault(_architecture_key(cfg), []).append(cfg)
    return list(groups.values())


def band_parallel_trainer(group, room_data, arrays, train_idx, device, mesh=None):
    """The band-parallel trainer of one architecture group: one model per
    band from its own config (seed, delays, absorption), each band's filter
    response, target features on the device; over ``mesh`` (default
    ``make_mesh(len(group))``) this rank keeps its bands."""
    from ..parallel import BandParallelTrainer
    from ..training.build import build_gfdn_model
    from ..training.solver import subband_resp

    cfg0 = group[0]
    models = [
        build_gfdn_model(cfg, common_decay_times=room_data.common_decay_times,
                         band_centre_hz=room_data.band_centre_hz, device=device)
        for cfg in group
    ]
    bs = min(cfg0.trainer_config.batch_size, max(1, len(train_idx)))
    trainer = BandParallelTrainer(
        models, cfg0.trainer_config, np.stack([subband_resp(c) for c in group]),
        steps_per_epoch=-(-len(train_idx) // bs),
        max_ir_len_ms=float(np.max(room_data.common_decay_times)) * 1e3, device=device,
        mesh=mesh,
    )
    trainer.upload_arrays(arrays)
    return trainer


def training_band_parallel(configs, room_data=None,
                           device: Union[str, torch.device] = "cuda") -> List[np.ndarray]:
    """All bands, the bands of each architecture group as one step.

    Every band keeps its seed, the full loss stack (the colorless loss
    included), per-band validation and early stopping, and per-epoch
    checkpoints in its own ``train_dir``; the group shares one train / valid
    split and batch order (from its first config's seed). Returns each
    group's per-band train losses (epochs, bands). Under a process group each
    group trains over ``make_mesh(len(group))``.
    """
    from ..data.batching import arrays_from_room_dataset, train_valid_split
    from ..parallel.mesh import make_mesh
    from ..training.checkpoints import save_checkpoint
    from ..training.solver import check_sample_rate
    from ..utils.device import resolve_device
    from ..utils.params import flax_tree, unstack_jax_tree

    dev = resolve_device(device)
    room_data = _room(configs, room_data)
    for cfg in configs:
        check_sample_rate(cfg, room_data)
    arrays = arrays_from_room_dataset(room_data)
    histories = []
    for group in architecture_groups(configs):
        cfg0 = group[0]
        train_idx, valid_idx = train_valid_split(
            np.arange(arrays.num_items), cfg0.trainer_config.train_valid_split, seed=cfg0.seed
        )
        trainer = band_parallel_trainer(group, room_data, arrays, train_idx, dev,
                                        make_mesh(len(group)))

        def on_epoch(epoch, trainer, train_losses, valid_losses, trained, group=group):
            if not trainer.writes_checkpoints():
                return
            tree = flax_tree(trainer.params.items())  # one read of this rank's bands
            for b, g in enumerate(range(trainer.bands.start, trainer.bands.stop)):
                if trained[g] or epoch == 0:
                    save_checkpoint(group[g].trainer_config.train_dir, epoch,
                                    unstack_jax_tree(tree, b))

        history = trainer.fit_indexed(arrays, train_idx, valid_idx,
                                      max_epochs=cfg0.trainer_config.max_epochs,
                                      seed=cfg0.seed, on_epoch=on_epoch)
        histories.append(history)
        logger.info("band group of %s Hz: %d epochs, final train losses %s",
                    [c.trainer_config.subband_process_config.centre_frequency for c in group],
                    history.shape[0], history[-1])
    return histories


def inferencing(configs, room_data=None, rec_indices=None,
                device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Each band's RIRs, band filtered and summed into broadband RIRs."""
    from ..inference.gfdn_inference import infer_all_octave_bands

    room_data = _room(configs, room_data)
    if rec_indices is None:
        rec_indices = np.arange(room_data.num_rec)
    return infer_all_octave_bands(configs, room_data, rec_indices, device=device)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Per-octave-band DiffGFDN training and broadband resynthesis"
    )
    parser.add_argument("--freqs", type=float, nargs="+", default=DEFAULT_FREQS,
                        help="octave band centre frequencies")
    parser.add_argument("--dataset", required=True, help="srirs.pkl path")
    parser.add_argument("--train-dir", default="output/subband")
    parser.add_argument("--num-freq-bins", type=int, default=2 ** 17)
    parser.add_argument("--max-epochs", type=int, default=20)
    parser.add_argument("--sample-rate", type=float, default=None,
                        help="sample rate in Hz (default: the dataset's)")
    parser.add_argument("--band-parallel", action="store_true",
                        help="train the bands of each architecture group as one step")
    parser.add_argument("--infer", action="store_true", help="run inference")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ..data.room_dataset import ThreeRoomDataset
    from ..parallel.mesh import init_process_group_from_env
    from ..utils.device import resolve_device

    device = resolve_device(args.device)  # raises before anything is read or written
    ranked = init_process_group_from_env("nccl" if device.type == "cuda" else "gloo")
    if ranked is not None:
        device = ranked
        if not args.band_parallel or args.infer:
            parser.error("under torchrun only --band-parallel training shards over ranks")
    logging.basicConfig(level=logging.INFO)
    room_data = ThreeRoomDataset(args.dataset, nfft=args.num_freq_bins)
    sample_rate = args.sample_rate or float(room_data.sample_rate)
    configs = [
        create_config(f, args.dataset, args.train_dir, args.num_freq_bins,
                      sample_rate=sample_rate, max_epochs=args.max_epochs)
        for f in args.freqs
    ]
    if args.infer:
        rirs = inferencing(configs, room_data=room_data, device=device)
        out = Path(args.train_dir) / "broadband_rirs.npy"
        np.save(out, rirs)
        print(f"saved broadband RIRs to {out}")
    elif args.band_parallel:
        training_band_parallel(configs, room_data=room_data, device=device)
    else:
        training(configs, room_data=room_data, device=device)


if __name__ == "__main__":
    main()
