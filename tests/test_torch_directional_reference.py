"""The port's directional model and trainer (``DiffDirectionalFDNVarReceiverPos``,
``gfdn_losses``, ``DirectionalGFDNTrainer``) against the benchmark's plain
reference (``benchmark/reference/directional.py``), on seeded random weights
at a small size: 3 groups of 9 SH lines, the 12 t-design directions, nfft
1024 at 8 kHz, batch 4, the preset's 10 x 128 residual MLP over 20 Fourier
features, the 1 kHz band filter, the masked directional EDC loss, the
asymmetric colorless and the sparsity losses.

The bins lie on the circle of radius 1.001 (``new_sampling_radius``): on the
unit circle the lossless sub-FDNs' terms (the colorless spectral loss, the
loop leaves' gradients through it, the io-gain normalization) are set by the
bin nearest a lossless mode, which float32 rounding moves (ROADMAP C2, C14);
a hair inside the circle both sides compute the same function to rounding.
Both sides compute in float32 on the CPU, so each tolerance is a float32
rounding allowance over the sums a quantity takes (stated where it is set).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.lib import port as bench_port
from benchmark.reference import directional as ref_dir, gfdn as ref
from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.data import generate_spatial_three_room_pickle, SpatialThreeRoomDataset
from diffgfdn_torch.data.spatial_dataset import arrays_from_spatial_dataset
from diffgfdn_torch.losses import make_decay_envelopes
from diffgfdn_torch.ops.basic import ms_to_samps
from diffgfdn_torch.training import build_gfdn_model, make_optimizer
from diffgfdn_torch.training.solver import subband_resp
from diffgfdn_torch.training.trainer import DirectionalGFDNTrainer, gfdn_losses, sub_fdn_bins
from diffgfdn_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
FS = 8000.0
DECAYS = (0.05, 0.09, 0.07)  # nfft 1024 at 8 kHz
RADIUS = 1.001
IDX = np.array([0, 9, 23, 40])
SEED = 2 ** 31 + 3


def preset() -> dict:
    conf = json.loads((ROOT / "benchmark" / "configs" /
                       "directional_1000Hz_res0.6m.json").read_text())
    raw = conf["preset"]
    raw["sample_rate"] = FS
    raw["trainer_config"].update(num_freq_bins=1024, batch_size=len(IDX))
    return raw


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(raw config, room, the port's trainer on seeded random weights, those weights)."""
    path = generate_spatial_three_room_pickle(
        tmp_path_factory.mktemp("directional_ref") / "srirs.pkl", fs=FS, grid_spacing_m=1.2,
        rir_len_s=0.1, decay_times=DECAYS)
    room = SpatialThreeRoomDataset(path)
    raw = preset()
    cfg = DiffGFDNConfig.from_dict(raw)
    model = build_gfdn_model(cfg, common_decay_times=room.common_decay_times,
                             band_centre_hz=room.band_centre_hz, variant="directional",
                             device="cpu", desired_directions=room.desired_directions)
    params = dict(model.named_parameters())
    weights = bench_port.draw_weights({k: tuple(p.shape) for k, p in params.items()}, SEED, "cpu")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(weights[k])
    cdt = np.asarray(room.common_decay_times)
    envelopes = make_decay_envelopes(cdt.reshape(-1)[:3], ms_to_samps(cdt.max() * 1e3, FS), FS)
    trainer = DirectionalGFDNTrainer(
        model, cfg.trainer_config, steps_per_epoch=1, common_decay_times=cdt,
        subband_filter_resp=subband_resp(cfg, room.num_freq_bins), sample_rate=FS,
        device="cpu", directional_envelopes=envelopes)
    trainer.upload_arrays(arrays_from_spatial_dataset(room, new_sampling_radius=RADIUS))
    return raw, room, trainer, weights


def reference(raw, room) -> ref_dir.DirectionalGFDN:
    return ref_dir.DirectionalGFDN(raw, room.common_decay_times, room.sph_directions, "cpu")


def fresh(weights) -> dict:
    return {k: v.clone().requires_grad_(True) for k, v in weights.items()}


def reset(trainer, weights) -> None:
    with torch.no_grad():
        for k, p in trainer.model.named_parameters():
            p.copy_(weights[k])


def inputs(trainer, room):
    """(the batch, its z, the sub-FDNs' z, normalized positions, amplitudes)."""
    batch = trainer.gather(torch.from_numpy(IDX))
    z = batch["z_values"]
    norm = torch.as_tensor(room.norm_receiver_position[IDX], dtype=torch.float32)
    amps = torch.as_tensor(room.amplitudes[IDX], dtype=torch.float32)
    return batch, z, sub_fdn_bins(trainer.model, z), norm, amps


def mask_of(trainer, z) -> torch.Tensor:
    return ref.edc_mask(trainer.edc_mask_length(z.shape[0]),
                        torch.Generator().manual_seed(5), "cpu")


def rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a.detach() - b.detach())
                 / torch.linalg.vector_norm(b.detach()))


def test_the_sh_domain_response_and_the_band_match_the_reference(setup):
    """H (B, 9, F): the MLP's 11 dense layers, a 9 x 9 solve a bin and the
    mix, in float32: 1e-5 of its norm. The analysis matrix and the band
    filter (designed in float64, then float32 / complex64): 1e-6."""
    raw, room, trainer, weights = setup
    reset(trainer, weights)
    batch, z, _, norm, _ = inputs(trainer, room)
    model = reference(raw, room)
    with torch.no_grad():
        h = trainer.model(batch)
        h_ref = model.sh_response(fresh(weights), z, norm)
    assert h.shape == (len(IDX), 9, z.shape[0])
    assert rel(h, h_ref) < 1e-5
    assert rel(trainer.model.analysis_matrix, model.analysis) < 1e-6
    assert rel(trainer.subband_filter_resp, model.band) < 1e-6


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_each_loss_term_matches_the_reference(setup, masked):
    """The directional EDC loss (a mean of |dB| errors over 4 x 12 x 720
    samples, each a float32 log of a float32 scan): 1e-5 relative; the
    colorless spectral term (a mean over 3 x 512 bins of |H_sub|, a 9 x 9
    inverse a bin) 1e-5; the sparsity term (a sum of 81 |entries| of a
    float32 matrix exponential) 1e-6."""
    raw, room, trainer, weights = setup
    reset(trainer, weights)
    batch, z, z_sub, norm, amps = inputs(trainer, room)
    mask = mask_of(trainer, z) if masked else None
    with torch.no_grad():
        port_parts = gfdn_losses(
            trainer.model, trainer.cfg, batch, trainer.mixing_time_samps,
            trainer.max_ir_len_samps, trainer.edr_win, trainer.edr_hop,
            trainer.subband_filter_resp, mask, trainer.directional_envelopes)
        model = reference(raw, room)
        p = fresh(weights)
        ref_parts = model.losses(p, model.response(p, z, norm), amps, mask, z_sub)
    assert set(port_parts) == set(ref_parts) == {"edc_loss", "spectral_loss", "sparsity_loss"}
    tol = {"edc_loss": 1e-5, "spectral_loss": 1e-5, "sparsity_loss": 1e-6}
    for name, value in ref_parts.items():
        assert abs(float(port_parts[name]) - float(value)) <= tol[name] * abs(float(value)), name


def test_every_leaf_gradient_matches_the_reference(setup):
    """Each leaf's gradient of the total loss (masked EDC): 1e-5 of its norm
    (the backward sums over the batch, 512 bins and 720 samples in another
    order than the forward's, and the EDC error's derivative is a sign)."""
    raw, room, trainer, weights = setup
    reset(trainer, weights)
    batch, z, z_sub, norm, amps = inputs(trainer, room)
    mask = mask_of(trainer, z)
    trainer.loss_and_grads(batch, mask)
    model = reference(raw, room)
    p = fresh(weights)
    total = sum(model.losses(p, model.response(p, z, norm), amps, mask, z_sub).values())
    grads = dict(zip(p, torch.autograd.grad(total, list(p.values()))))
    port_grads = {k: q.grad for k, q in trainer.model.named_parameters()}
    assert set(port_grads) == set(grads)
    worst = max(grads, key=lambda k: rel(port_grads[k], grads[k]))
    assert rel(port_grads[worst], grads[worst]) < 1e-5, worst


def test_the_normalization_matches_the_reference(setup):
    """Each group's io gains divided by E[|H_sub|^2]^(1/4) over the bins
    above DC: the gains within 1e-6 of theirs (a float32 mean over 511 bins
    under a fourth root)."""
    raw, room, trainer, weights = setup
    reset(trainer, weights)
    _, z, z_sub, _, _ = inputs(trainer, room)
    trainer._normalize_params(z=z)
    p = fresh(weights)
    with torch.no_grad():
        reference(raw, room).normalize(p, z_sub)
    for name in ("input_gains", "output_gains"):
        assert rel(getattr(trainer.model, name), p[name]) < 1e-6, name


def test_one_adam_step_matches_the_reference(setup):
    """A whole step (the normalization, the masked losses, the backward and
    fused Adam at the preset's rates): each leaf's change within 1e-4 of
    the reference's (Adam's first step divides each gradient element by its
    own magnitude, so elements whose gradient is near rounding move by
    +-lr either way)."""
    raw, room, trainer, weights = setup
    reset(trainer, weights)
    trainer.optimizer, trainer.scheduler = make_optimizer(trainer.cfg, trainer.model, 1)
    trainer.mask_generator.manual_seed(SEED)
    batch, z, z_sub, norm, amps = inputs(trainer, room)
    trainer.fit_step(torch.from_numpy(IDX))
    model = reference(raw, room)
    p = fresh(weights)
    with torch.no_grad():
        model.normalize(p, z_sub)
    mask = ref.edc_mask(model.edc_len, torch.Generator().manual_seed(SEED), "cpu")
    total = sum(model.losses(p, model.response(p, z, norm), amps, mask, z_sub).values())
    ref.Adam(raw, p).step(p, dict(zip(p, torch.autograd.grad(total, list(p.values())))))
    for k, q in trainer.model.named_parameters():
        change = q.detach() - weights[k]
        assert rel(change, p[k].detach() - weights[k]) < 1e-4, k


def test_the_directional_trainer_records_its_step_spans(setup):
    """``fit_step`` and ``valid_step`` of ``DirectionalGFDNTrainer`` record
    the program's step spans, and a validation remainder its eager span."""
    _, _, trainer, weights = setup
    reset(trainer, weights)
    trainer.optimizer, trainer.scheduler = make_optimizer(trainer.cfg, trainer.model, 1)
    profiling.clear()
    try:
        with profiling.recording():
            trainer.fit_step(torch.from_numpy(IDX))
            trainer.valid_step(torch.from_numpy(IDX), len(IDX))
            trainer.valid_step(torch.from_numpy(IDX[:3]), len(IDX))
        names = [s.name for s in profiling.records()]
    finally:
        profiling.clear()
    assert names.count("gfdn.step.train") == 1 and names.count("gfdn.step.valid") == 2
    assert names.count("gfdn.graph.eager") == 1
