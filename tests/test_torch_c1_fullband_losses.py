"""The full-band preset's loss set trained by both packages from one start.

ROADMAP C1 asked whether the growth of the full-band training loss seen on
the card (1.7e5 at epoch 0, 1.9e7 at epoch 1) is the port's or the preset's.
Here both trainers, JAX ``GFDNTrainer.fit_indexed`` and the port's
``GFDNTrainer.fit_indexed(device="cpu")``, train the same model (SVF heads,
GEQ absorption; the preset's EDC, EDR, colorless spectral and sparsity
losses at its learning rates, the EDC mask off) at reduced size (fs 8 kHz,
nfft 2^12, 24 synthetic receivers, a 2 x 16 MLP) from the same converted
parameters, with the same split and batch order, and each loss term is
logged per epoch.

What it shows: the colorless spectral term, evaluated on |z| = 1 where the
lossless sub-FDNs have their poles, grows tenfold or more within an epoch
in JAX as in the port (here by some 3.7e3 and 1.2e5), while the other terms
agree. So the growth is a property of the preset, not a fault of the port.
Its value on the unit circle is set by the few bins nearest a pole and
cannot be held to JAX (ROADMAP C2): as there, the spectral term of each
epoch's trained parameters is compared just off the circle (|z| = 1.001),
where it is well conditioned. Bounds per epoch, relative: the EDC, EDR and
sparsity terms (train and valid) 1e-3 after epoch 0, 1e-2 after epoch 1,
5e-2 after epoch 2 (the spectral term's gradients on the circle differ, so
the trajectories part slowly); the spectral term off the circle 1e-4 at the
start, 1e-3, 1e-2 and 5e-2 after epochs 0, 1 and 2. The longer case (3
epochs at nfft 2^13) is marked slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.data import arrays_from_room_dataset, generate_three_room_pickle
from diffgfdn_torch.data import ThreeRoomDataset
from diffgfdn_torch.losses import amse_loss
from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer, load_checkpoint
from diffgfdn_torch.utils.params import load_jax_params
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data import ThreeRoomDataset as JaxThreeRoomDataset
from diffgfdn_tpu.data.batching import arrays_from_room_dataset as jax_arrays
from diffgfdn_tpu.data.batching import train_valid_split
from diffgfdn_tpu.losses import amse_loss as jax_amse_loss
from diffgfdn_tpu.models.gfdn import DiffGFDN as JaxDiffGFDN
from diffgfdn_tpu.training.checkpoints import load_checkpoint as jax_load_checkpoint
from diffgfdn_tpu.training.trainer import GFDNTrainer as JaxGFDNTrainer, padded_batches
from torch_port_helpers import BANDS, DECAY_TIMES, FS, jax_model_and_params, raw_config

BATCH = 8
RECEIVERS_PER_ROOM = 8  # 24 receivers: 19 train (3 steps of 8), 5 valid
GROWTH = 10.0  # the spectral term's least growth from epoch 0 to epoch 1
TERMS = ("edc_loss", "edr_loss", "sparsity_loss")
TERM_TOL = (1e-3, 1e-2, 5e-2)  # per epoch 0, 1, 2
OFF_CIRCLE_TOL = (1e-4, 1e-3, 1e-2, 5e-2)  # the start, then after epochs 0, 1, 2


def _train_both(tmp_path, nfft: int, epochs: int) -> dict:
    path = generate_three_room_pickle(tmp_path / "srirs.pkl", fs=FS,
                                      num_rec_per_room=RECEIVERS_PER_ROOM, rir_len_s=0.5,
                                      decay_times=DECAY_TIMES)
    jax_room, port_room = JaxThreeRoomDataset(path, nfft=nfft), ThreeRoomDataset(path, nfft=nfft)
    cdt = np.stack([np.array(DECAY_TIMES)] * len(BANDS)) * np.linspace(
        1.2, 0.8, len(BANDS))[:, None]
    for room in (jax_room, port_room):  # per-band decay times select the GEQ fit
        room.common_decay_times, room.band_centre_hz = cdt, BANDS
    raw = raw_config(tmp_path, True, nfft=nfft, batch=BATCH)
    raw["trainer_config"].update(  # the full-band preset's losses and learning rates
        max_epochs=epochs, lr=0.01, io_lr=0.01, coupling_angle_lr=0.01,
        use_colorless_loss=True, use_asym_spectral_loss=True, spectral_loss_weight=1.0,
        sparsity_loss_weight=1.0, edc_loss_weight=1.0, edr_loss_weight=1.0,
        use_edc_mask=False,
    )
    dirs = {side: str(tmp_path / side) for side in ("jax", "port")}

    jcfg = JaxDiffGFDNConfig.model_validate(
        dict(raw, trainer_config=dict(raw["trainer_config"], train_dir=dirs["jax"])))
    jax_model, params = jax_model_and_params(jcfg, jax_room, BATCH)
    params = jax.tree_util.tree_map(np.asarray, params)  # JAX donates its copy
    arrays = jax_arrays(jax_room)
    train_idx, valid_idx = train_valid_split(np.arange(arrays.num_items), 0.8, seed=jcfg.seed)
    steps = len(list(padded_batches(train_idx, BATCH)))
    jtrainer = JaxGFDNTrainer(jax_model, jcfg.trainer_config, steps,
                              common_decay_times=jax_room.common_decay_times, sample_rate=FS)
    jtrainer.patience = 10 ** 9  # a fixed number of epochs on both sides
    jtrainer.fit_indexed(jax.tree_util.tree_map(jnp.asarray, params), arrays, train_idx,
                         valid_idx, seed=jcfg.seed)

    cfg = DiffGFDNConfig.from_dict(
        dict(raw, trainer_config=dict(raw["trainer_config"], train_dir=dirs["port"])))
    model = build_gfdn_model(cfg, port_room.common_decay_times, port_room.band_centre_hz,
                             device="cpu")
    load_jax_params(model, params)
    trainer = GFDNTrainer(model, cfg.trainer_config, steps,
                          common_decay_times=port_room.common_decay_times, sample_rate=FS,
                          device="cpu")
    trainer.patience = 10 ** 9
    trainer.fit_indexed(arrays_from_room_dataset(port_room), train_idx, valid_idx, seed=cfg.seed)

    # the spectral term of each epoch's parameters just off the unit circle
    z = (1.001 * np.exp(1j * np.linspace(0.0, np.pi, nfft // 2 + 1))).astype(np.complex64)
    off_circle = []
    for epoch in range(-1, epochs):
        jp = jax.tree_util.tree_map(jnp.asarray, jax_load_checkpoint(dirs["jax"], epoch))
        h, _ = jax_model.apply(jp, jnp.asarray(z), method=JaxDiffGFDN.sub_fdn_output)
        ref = float(sum(jax_amse_loss(h[:, k], jnp.ones(h.shape[0]))
                        for k in range(h.shape[1])))
        state = build_gfdn_model(cfg, port_room.common_decay_times, port_room.band_centre_hz,
                                 device="cpu")
        load_jax_params(state, load_checkpoint(dirs["port"], epoch))
        with torch.no_grad():
            h, _ = state.sub_fdn_output(torch.from_numpy(z))
            ours = float(sum(amse_loss(h[:, k], torch.ones(h.shape[0]))
                             for k in range(h.shape[1])))
        off_circle.append((ref, ours))
    return {
        "jax": (jtrainer.individual_train_loss, jtrainer.individual_valid_loss),
        "port": (trainer.individual_train_loss, trainer.individual_valid_loss),
        "off_circle": off_circle,
    }


@pytest.fixture(scope="module")
def two_epochs(tmp_path_factory):
    return _train_both(tmp_path_factory.mktemp("c1"), nfft=2 ** 12, epochs=2)


def _rel(a: float, ref: float) -> float:
    return abs(a - ref) / abs(ref)


def check_growth_is_the_presets(runs, record_property) -> None:
    """The spectral term on |z| = 1 grows by GROWTH or more from epoch 0 to
    epoch 1 in JAX and in the port alike."""
    for side in ("jax", "port"):
        train = runs[side][0]
        growth = train[1]["spectral_loss"] / train[0]["spectral_loss"]
        for epoch, losses in enumerate(train):
            record_property(f"{side}_spectral_e{epoch}", losses["spectral_loss"])
        record_property(f"{side}_spectral_growth", growth)
        assert growth >= GROWTH, (side, [d["spectral_loss"] for d in train])


def check_terms_agree(runs, record_property) -> None:
    for split in (0, 1):  # train, valid
        ref, ours = runs["jax"][split], runs["port"][split]
        assert len(ref) == len(ours)
        for epoch, (r, o) in enumerate(zip(ref, ours)):
            assert sorted(r) == sorted(o)
            for term in TERMS:
                err = _rel(o[term], r[term])
                record_property(f"{('train', 'valid')[split]}_{term}_e{epoch}", err)
                assert err <= TERM_TOL[epoch], (split, epoch, term, err)


def check_spectral_off_circle(runs, record_property) -> None:
    for k, (ref, ours) in enumerate(runs["off_circle"]):
        err = _rel(ours, ref)
        record_property(f"spectral_off_circle_e{k - 1}", err)
        assert err <= OFF_CIRCLE_TOL[k], (k - 1, ref, ours)


def test_spectral_term_grows_in_jax_as_in_the_port(two_epochs, record_property):
    check_growth_is_the_presets(two_epochs, record_property)


def test_other_terms_agree_with_jax_per_epoch(two_epochs, record_property):
    check_terms_agree(two_epochs, record_property)


def test_spectral_term_agrees_off_the_unit_circle(two_epochs, record_property):
    check_spectral_off_circle(two_epochs, record_property)


@pytest.mark.slow
def test_three_epochs_at_nfft_8192(tmp_path, record_property):
    runs = _train_both(tmp_path, nfft=2 ** 13, epochs=3)
    check_growth_is_the_presets(runs, record_property)
    check_terms_agree(runs, record_property)
    check_spectral_off_circle(runs, record_property)
