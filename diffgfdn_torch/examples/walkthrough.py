"""End-to-end walkthrough: dataset -> training -> inference -> 6DoF render.

Port of ``examples/walkthrough.py``, the repository's counterpart of the
reference's end-to-end notebooks: one documented, reproducible pipeline through
every stage at toy scale, on the port's entry points:

1. synthesize a 3-coupled-room dataset (omni RIR grid + directional SRIRs);
2. colorless-FDN warm start + grid training (``DiffGFDNVarReceiverPos``);
3. checkpoint inference -> RIR wav export;
4. subband training on two octave bands + broadband resynthesis;
5. 6DoF moving-listener binaural render (SH rotation + HRTF beamforming
   + crossfaded overlap-add) -> stereo wav, then the floor-plan animation.

Steps 2-5 run on ``device``: CUDA unless the caller passes ``device="cpu"``
(``--device cpu``). The animation (matplotlib) is drawn on the host by
:func:`step5_animation`; :func:`step5_render` is the render alone.

Usage: python -m diffgfdn_torch.examples.walkthrough [--out-dir /tmp/diffgfdn_walkthrough]
       [--device cpu]
"""

import argparse
import json
from pathlib import Path
from typing import Union

import numpy as np
import torch

from ..utils.device import resolve_device

Device = Union[str, torch.device]

FS = 8000.0
NFFT = 2048
DECAY_TIMES = (0.08, 0.12, 0.1)
HOPS = 8


def step1_dataset(out: Path):
    """Synthetic coupled-room data: an omni RIR grid and directional SRIRs.

    (The reference ships a Treble-simulated dataset; the synthetic
    generator produces the same containers and shapes.)
    """
    from ..data import generate_spatial_three_room_pickle, generate_three_room_pickle

    omni = out / "srirs.pkl"
    generate_three_room_pickle(omni, fs=FS, num_rec_per_room=8, rir_len_s=0.25,
                               decay_times=DECAY_TIMES)
    spatial = out / "spatial_srirs.pkl"
    generate_spatial_three_room_pickle(spatial, fs=FS, grid_spacing_m=1.2, rir_len_s=0.25,
                                       decay_times=DECAY_TIMES)
    print(f"[1/5] datasets written: {omni.name}, {spatial.name}")
    return omni, spatial


def walkthrough_config(out: Path, dataset: Path) -> dict:
    """The walkthrough's training config (the one the JAX package's
    walkthrough writes to ``config.yml``), as a dict."""
    return {
        "seed": 1,
        "room_dataset_path": str(dataset),
        "num_groups": 3,
        "sample_rate": FS,
        "num_delay_lines": 6,
        "delay_range_ms": [20, 45],
        "trainer_config": {"batch_size": 8, "num_freq_bins": NFFT, "max_epochs": 3,
                           "lr": 1.0e-3, "train_dir": str(out / "train"),
                           "ir_dir": str(out / "audio")},
        "output_filter_config": {"use_svfs": False, "num_hidden_layers": 1,
                                 "num_neurons_per_layer": 16, "num_fourier_features": 4},
        "decay_filter_config": {"use_absorption_filters": False},
        "colorless_fdn_config": {"use_colorless_prototype": True, "max_epochs": 3,
                                 "batch_size": 128},
    }


def step2_train(out: Path, dataset: Path, device: Device = "cuda"):
    """Grid training with a colorless-FDN warm start.

    The colorless prototype optimizes a flat-magnitude FDN per group; its
    feedback-matrix log warm-starts the coupled model. Writes the config to
    ``config.yml`` as JSON, which is YAML (``config.load_and_validate_config``
    reads it back) and needs no PyYAML to write.
    """
    from ..config.schema import DiffGFDNConfig
    from ..training.solver import run_training_var_receiver_pos

    dev = resolve_device(device)
    raw = walkthrough_config(out, dataset)
    (out / "config.yml").write_text(json.dumps(raw, indent=2) + "\n")
    config = DiffGFDNConfig.from_dict(raw)
    trainer, _ = run_training_var_receiver_pos(config, export_irs=True, device=dev)
    print(f"[2/5] trained {len(trainer.train_loss)} epochs, "
          f"final train loss {trainer.train_loss[-1]:.3f}")
    return config


def step3_infer(out: Path, config, dataset: Path, device: Device = "cuda"):
    """Checkpoint inference: synthesize RIRs at grid positions -> wav."""
    from ..data import ThreeRoomDataset, write_wav
    from ..inference import InferDiffGFDN

    room = ThreeRoomDataset(str(dataset), nfft=NFFT)
    infer = InferDiffGFDN(config, room, device=device)
    rirs = infer.rirs_at(np.arange(4), batch_size=4)
    wav = out / "inferred_rir.wav"
    write_wav(wav, rirs[0] / (np.abs(rirs[0]).max() + 1e-9), FS)
    assert np.isfinite(rirs).all()
    print(f"[3/5] checkpoint inference OK -> {wav.name}")
    return rirs


def step4_subband(out: Path, dataset: Path, device: Device = "cuda"):
    """Two-band subband training + broadband resynthesis (band filters
    re-applied and bands summed, reference run_subband_training_treble)."""
    from ..cli.run_subband_training import main as subband_main

    dev = resolve_device(device)
    args = [
        "--dataset", str(dataset),
        "--train-dir", str(out / "subband"),
        "--freqs", "500", "1000",
        "--num-freq-bins", str(NFFT),
        "--max-epochs", "1",
        "--device", str(dev),
    ]
    subband_main(args)
    subband_main(args + ["--infer"])
    broadband = out / "subband" / "broadband_rirs.npy"
    assert broadband.exists()
    rirs = np.load(broadband)
    assert np.isfinite(rirs).all()
    print(f"[4/5] subband training + resynthesis OK -> {broadband.name} {rirs.shape}")
    return rirs


def step5_render(out: Path, spatial: Path, device: Device = "cuda"):
    """6DoF binaural render along a walking path -> ``binaural_walkthrough.wav``.

    Returns (the (T, 2) render, the room, the path's positions and
    orientations)."""
    from ..data import SpatialThreeRoomDataset, write_wav
    from ..inference import BinauralDynamicRendering

    dev = resolve_device(device)
    room = SpatialThreeRoomDataset(str(spatial))
    rng = np.random.RandomState(0)
    pos = np.tile(room.receiver_position[:4], (2, 1))[:HOPS]
    oris = np.stack([np.linspace(0, np.pi, HOPS), np.zeros(HOPS)], axis=-1)
    # synthetic HRIR SH set (decaying noise); swap in a measured SOFA HRTF
    # set via inference.sofa.HRIRSOFAReader.get_spherical_harmonic_representation
    t = np.arange(128)
    hrir_sh = rng.randn(9, 2, 128) * np.exp(-t / 32.0)[None, None, :]
    stim = rng.randn(int(0.5 * FS)).astype(np.float32)

    rend = BinauralDynamicRendering(room, pos, oris, stim, hrir_sh, update_ms=100.0,
                                    use_whole_rir=True, device=dev)
    binaural = rend.binaural_filter_overlap_add()  # (T, 2)
    write_wav(out / "binaural_walkthrough.wav", binaural / (np.abs(binaural).max() + 1e-9), FS)
    assert np.isfinite(binaural).all()
    return binaural, room, pos, oris


def step5_animation(out: Path, room, pos, oris) -> Path:
    """The floor-plan animation of the walk -> ``trajectory.gif`` (matplotlib)."""
    from ..utils.plot import animate_moving_listener

    anim = out / "trajectory.gif"
    animate_moving_listener(
        pos, room.room_dims, room.room_start_coord, yaw_angles=oris[:, 0],
        source_position=np.asarray(room.source_position).reshape(-1)[:3],
        save_path=str(anim), fps=4,
    )
    return anim


def step5_binaural(out: Path, spatial: Path, device: Device = "cuda"):
    """6DoF binaural render along a walking path + floor-plan animation."""
    binaural, room, pos, oris = step5_render(out, spatial, device)
    anim = step5_animation(out, room, pos, oris)
    print(f"[5/5] binaural render OK -> binaural_walkthrough.wav, {anim.name}")
    return binaural


def main(argv=None):
    ap = argparse.ArgumentParser(description="End-to-end walkthrough on the port")
    ap.add_argument("--out-dir", default="/tmp/diffgfdn_walkthrough")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises before anything is written
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    omni, spatial = step1_dataset(out)
    config = step2_train(out, omni, device)
    step3_infer(out, config, omni, device)
    step4_subband(out, omni, device)
    step5_binaural(out, spatial, device)
    print(f"walkthrough complete; artifacts in {out}")


if __name__ == "__main__":
    main()
