"""The band-parallel trainer's host-batch entry points against the JAX
package: ``init``, ``step`` on a batch made on the host, ``fit`` and
``make_band_loss_fn``.

The setup is ``tests/test_parallel.py``'s: a synthetic 24-receiver grid
(fs 16 kHz, 0.12 s RIRs), a 6-line model with scalar heads (a 1 x 16 MLP),
the 500 and 1000 Hz octave bands at nfft 1024, batch 8, 3 epochs of 3
shuffled batches. JAX trains on the conftest's virtual devices (its default
(band, batch) mesh), the port on one CPU process, both from JAX's initial
parameters. Without precomputed features each band's loss compares H times
the band's response with the batch's target spectrum times the same
response. Bounds: the (3, 2) history within 1e-3 relative, each epoch; the
band loss and each of its terms within 1e-3; a band with ``active = 0``
keeps its parameters bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from diffgfdn_torch.config.schema import TrainerConfig
from diffgfdn_torch.data import arrays_from_room_dataset, iterate_batches, ThreeRoomDataset
from diffgfdn_torch.models import DiffGFDNVarReceiverPos
from diffgfdn_torch.ops.filterbanks import subband_filter_response
from diffgfdn_torch.parallel import BandParallelTrainer, make_band_loss_fn
from diffgfdn_torch.utils.params import load_jax_params, torch_state_from_jax
from diffgfdn_tpu.config.schema import TrainerConfig as JaxTrainerConfig
from diffgfdn_tpu.data import arrays_from_room_dataset as jax_arrays
from diffgfdn_tpu.data import iterate_batches as jax_iterate_batches
from diffgfdn_tpu.data import generate_three_room_pickle
from diffgfdn_tpu.data import ThreeRoomDataset as JaxThreeRoomDataset
from diffgfdn_tpu.parallel import BandParallelTrainer as JaxBandParallelTrainer
from diffgfdn_tpu.parallel.band_parallel import make_band_loss_fn as jax_make_band_loss_fn
from diffgfdn_tpu.utils.cio import decode_batch, encode_batch
from test_parallel import _model as jax_model
from torch_port_helpers import one_torch_thread  # noqa: F401 (a module fixture)

NFFT = 1024
BATCH = 8
EPOCHS = 3
BAND_HZ = (500.0, 1000.0)
MAX_IR_MS = 120.0
HISTORY_TOL = 1e-3  # each epoch's loss of each band, relative
LOSS_TOL = 1e-3
TRAINER = dict(batch_size=BATCH, num_freq_bins=NFFT, max_epochs=2, lr=5e-3, io_lr=5e-3)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = generate_three_room_pickle(tmp_path_factory.mktemp("band_host") / "srirs.pkl",
                                      num_rec_per_room=8, rir_len_s=0.12,
                                      decay_times=(0.05, 0.08, 0.06))
    jroom, room = JaxThreeRoomDataset(path, nfft=NFFT), ThreeRoomDataset(path, nfft=NFFT)
    resps = np.stack([subband_filter_response(fc, (63.0, 4000.0), 1, jroom.sample_rate, NFFT)
                      for fc in BAND_HZ])
    jmodel = jax_model(jroom)
    jtrainer = JaxBandParallelTrainer(jmodel, JaxTrainerConfig(**TRAINER), resps,
                                      steps_per_epoch=3, max_ir_len_ms=MAX_IR_MS)
    jarr = jax_arrays(jroom)
    idx = np.arange(jarr.num_items)
    params, opt_state = jtrainer.init(next(iter(jax_iterate_batches(jarr, idx, BATCH, seed=0))),
                                      seed=0)
    init = jax.tree_util.tree_map(np.asarray, params)
    _, _, history = jtrainer.fit(params, opt_state,
                                 lambda e: jax_iterate_batches(jarr, idx, BATCH, seed=e),
                                 max_epochs=EPOCHS)
    return {"jroom": jroom, "room": room, "resps": resps, "jmodel": jmodel, "init": init,
            "history": history, "jtrainer": jtrainer}


def _port_model(room, seed: int = 0) -> DiffGFDNVarReceiverPos:
    """The port's twin of test_parallel.py's model (its delays and gains)."""
    j = jax_model(room)
    return DiffGFDNVarReceiverPos(
        sample_rate=j.sample_rate, num_groups=j.num_groups, delays=j.delays, gains=j.gains,
        use_svf_in_output=False, num_hidden_layers=1, num_neurons=16, num_fourier_features=4,
        generator=torch.Generator().manual_seed(seed))


def _trainer(setup) -> BandParallelTrainer:
    room = setup["room"]
    return BandParallelTrainer([_port_model(room), _port_model(room)], TrainerConfig(**TRAINER),
                               setup["resps"], steps_per_epoch=3, max_ir_len_ms=MAX_IR_MS,
                               device="cpu")


def test_init_draws_each_band_from_its_seed(setup):
    """``init`` gives every parameter the band axis; band b's draw is what
    the model built with seed ``seeds[b]`` holds; the default seeds give the
    bands different draws, the same for the same ``seed``."""
    room = setup["room"]
    trainer = _trainer(setup)
    example = next(iter(iterate_batches(arrays_from_room_dataset(room), np.arange(24), BATCH)))
    params = trainer.init(example, seeds=[3, 5])
    assert set(params) == {n for n, _ in _port_model(room).named_parameters()}
    for b, seed in enumerate((3, 5)):
        for name, p in _port_model(room, seed).named_parameters():
            assert params[name].shape == (2, *p.shape)
            assert torch.equal(params[name][b], p), name
    drawn = {k: v.clone() for k, v in trainer.init(example, seed=1).items()}
    assert not torch.equal(drawn["input_gains"][0], drawn["input_gains"][1])
    again = trainer.init(example, seed=1)
    assert all(torch.equal(again[k], drawn[k]) for k in drawn)
    with pytest.raises(ValueError, match="bins"):
        trainer.init({"z_values": np.zeros(7, np.complex64)})


def test_fit_history_matches_jax(setup, record_property):
    room = setup["room"]
    trainer = _trainer(setup)
    trainer.load_band_params(torch_state_from_jax(setup["init"]))
    arrays = arrays_from_room_dataset(room)
    history = trainer.fit(lambda e: iterate_batches(arrays, np.arange(24), BATCH, seed=e),
                          max_epochs=EPOCHS)
    ref = setup["history"]
    assert history.shape == ref.shape == (EPOCHS, 2)
    for epoch in range(EPOCHS):
        err = float(np.max(np.abs(history[epoch] - ref[epoch]) / np.abs(ref[epoch])))
        record_property(f"history_rel_e{epoch}", err)
        assert err <= HISTORY_TOL, (epoch, history, ref)


def test_band_loss_fn_matches_jax(setup, record_property):
    """Each band's loss on a host batch without features: the total and each
    term, JAX's ``make_band_loss_fn`` against the port's."""
    jroom, room, jtrainer = setup["jroom"], setup["room"], setup["jtrainer"]
    jbatch = next(iter(jax_iterate_batches(jax_arrays(jroom), np.arange(24), BATCH, seed=2)))
    batch = next(iter(iterate_batches(arrays_from_room_dataset(room), np.arange(24), BATCH,
                                      seed=2)))
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    jloss = jax.jit(jax_make_band_loss_fn(setup["jmodel"], jtrainer.cfg, jroom.sample_rate,
                                          MAX_IR_MS, jtrainer._edr_win, jtrainer._edr_hop))
    worst = 0.0
    for b in range(2):
        pb = jax.tree_util.tree_map(lambda x: x[b], setup["init"])
        total, aux = jloss(pb, decode_batch(encode_batch(jbatch)), jtrainer.band_responses[b],
                           jax.random.PRNGKey(0))
        model = load_jax_params(_port_model(room), pb)
        loss = make_band_loss_fn(model, TrainerConfig(**TRAINER), room.sample_rate, MAX_IR_MS,
                                 jtrainer._edr_win, jtrainer._edr_hop)
        with torch.no_grad():
            ours = loss(tensors, {}, torch.from_numpy(setup["resps"][b].astype(np.complex64)),
                        None)
        assert sorted(ours) == sorted(aux)
        worst = max(worst, abs(float(sum(ours.values())) - float(total)) / abs(float(total)),
                    *(abs(float(ours[k]) - float(v)) / abs(float(v)) for k, v in aux.items()))
    record_property("band_loss_rel", worst)
    assert worst <= LOSS_TOL


def test_stopped_band_keeps_its_parameters_on_host_batches(setup):
    room = setup["room"]
    trainer = _trainer(setup)
    arrays = arrays_from_room_dataset(room)
    before = {k: v.detach().clone() for k, v in trainer.params.items()}
    for batch in iterate_batches(arrays, np.arange(24), BATCH, seed=0):
        trainer.step(batch, active=np.array([1.0, 0.0], np.float32))
    for k, p in trainer.params.items():
        assert torch.equal(p[1], before[k][1]), k
    assert any(not torch.equal(p[0], before[k][0]) for k, p in trainer.params.items())
