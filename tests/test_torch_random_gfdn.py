"""The RANDOM-coupled GFDN in the port against JAX, and the nine synth presets.

``synth_subband_single_room`` couples all its lines through one dense
orthogonal matrix exp(skew(X)) (``coupling_matrix_type: random_matrix``).
Here the same model at small width: one group of 8 lines, SVF heads, GEQ
absorption, fs 8 kHz, nfft 2^12 (the JAX model's initial parameters
carried into the port; the per-band decay times of torch_port_helpers,
first group). Bounds:

* H: 1e-3 relative L2 (C7's slice bound); the trainer's EDC and EDR losses
  1e-3 relative and their gradients 2e-3 relative L2, every leaf;
* served RIRs (``InferDiffGFDN.rirs_at``): relative L2 1e-3, EDC 0.01 dB
  over 0.5 s; time-domain synthesis (the filtered path, and B7's plain
  version with scalar heads and scalar absorption): 1e-4 of the peak;
* ROADMAP C16: JAX's trainer cannot normalize the io gains of this model
  (``sub_fdn_output`` reads the per-group ``M`` that a RANDOM loop lacks:
  ``AttributeError``); the port's ``fit_indexed`` raises ``ValueError``
  naming C16 before its first step.

And each synth preset's dict builds, in the port, the parameter tree (leaves
and shapes) of JAX's ``init`` of the same config.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.config import PRESETS
from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.data import arrays_from_room_dataset, ThreeRoomDataset
from diffgfdn_torch.inference import InferDiffGFDN, make_time_domain_synthesis_fn
from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer
from diffgfdn_torch.utils.params import jax_grads_from_torch, load_jax_params
from diffgfdn_torch.utils.params import torch_state_from_jax
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data import generate_three_room_pickle
from diffgfdn_tpu.data import ThreeRoomDataset as JaxThreeRoomDataset
from diffgfdn_tpu.data.batching import arrays_from_room_dataset as jax_arrays
from diffgfdn_tpu.data.batching import gather_batch, init_example_batch
from diffgfdn_tpu.inference import gfdn_inference as jinf
from diffgfdn_tpu.training.build import build_gfdn_model as jax_build_gfdn_model
from diffgfdn_tpu.training.checkpoints import save_checkpoint
from diffgfdn_tpu.training.trainer import GFDNTrainer as JaxGFDNTrainer
from torch_port_helpers import edc_db, FS, jax_model_and_params, raw_config, rel_l2, rooms

NFFT = 4096
BATCH = 4
IDX = np.array([0, 3, 5, 7])
H_TOL = 1e-3
LOSS_TOL = 1e-3
GRAD_TOL = 2e-3
RIR_TOL = 1e-3
EDC_TOL_DB = 0.01
TD_TOL = 1e-4
INPUTS = ("z_values", "listener_position", "norm_listener_position", "target_early_response")


def random_models(tmp_path, svf: bool = True):
    """(raw config, JAX model, its initial params, the port model with them,
    JAX room, port room): one group of 8 lines, a RANDOM feedback matrix; SVF
    heads with GEQ absorption, or scalar heads with scalar absorption."""
    raw = raw_config(tmp_path, svf, nfft=NFFT, batch=BATCH)
    raw.update(num_groups=1, num_delay_lines=8,
               feedback_loop_config=dict(coupling_matrix_type="random_matrix"))
    jax_room, port_room = rooms(tmp_path, svf, NFFT)
    for room in (jax_room, port_room):  # the first group's decay times
        cdt = np.asarray(room.common_decay_times)
        room.common_decay_times = cdt[:, :1] if cdt.ndim == 2 else cdt[:1]
    jmodel, params = jax_model_and_params(JaxDiffGFDNConfig.model_validate(raw), jax_room,
                                          BATCH)
    model = build_gfdn_model(DiffGFDNConfig.from_dict(raw), port_room.common_decay_times,
                             port_room.band_centre_hz, device="cpu")
    mapped = torch_state_from_jax(params)
    assert ({k: tuple(v.shape) for k, v in mapped.items()}
            == {k: tuple(v.shape) for k, v in model.state_dict().items()})
    assert mapped["feedback_loop.random_feedback_matrix"].shape == (8, 8)
    return raw, jmodel, params, load_jax_params(model, params), jax_room, port_room


def test_forward_and_loss_gradients_match_jax(tmp_path, record_property):
    raw, jmodel, params, model, jax_room, port_room = random_models(tmp_path)
    jcfg = JaxDiffGFDNConfig.model_validate(raw)
    arrays = jax_arrays(jax_room)
    jtrainer = JaxGFDNTrainer(jmodel, jcfg.trainer_config, 1,
                              common_decay_times=jax_room.common_decay_times, sample_rate=FS)
    jtrainer.precompute_target_features(arrays)
    jbatch = gather_batch(arrays, IDX)
    key = jax.random.PRNGKey(11)

    def total(p):
        losses = jtrainer._losses(p, jbatch, key)
        return sum(losses.values()), (losses, jmodel.apply(p, {k: jbatch[k] for k in INPUTS}))

    (ref_total, (ref_losses, h_ref)), ref_grads = jax.jit(
        jax.value_and_grad(total, has_aux=True))(params)

    cfg = DiffGFDNConfig.from_dict(raw)
    trainer = GFDNTrainer(model, cfg.trainer_config, 1,
                          common_decay_times=port_room.common_decay_times, sample_rate=FS,
                          device="cpu")
    trainer.upload_arrays(arrays_from_room_dataset(port_room))
    batch = trainer.gather(torch.from_numpy(IDX))
    with torch.no_grad():
        h = model(batch).numpy()
    direct = jbatch["target_early_response"]
    h_err = rel_l2(h - direct, np.asarray(h_ref) - direct)
    tot, losses = trainer.loss_and_grads(batch)
    assert sorted(losses) == sorted(ref_losses) == ["edc_loss", "edr_loss"]
    loss_errs = {k: abs(float(losses[k]) - float(v)) / abs(float(v))
                 for k, v in ref_losses.items()}
    loss_errs["total"] = abs(float(tot) - float(ref_total)) / abs(float(ref_total))
    grads = dict(jax.tree_util.tree_leaves_with_path(jax_grads_from_torch(model)))
    flat = jax.tree_util.tree_leaves_with_path(ref_grads)
    assert len(grads) == len(flat)
    grad_errs = {jax.tree_util.keystr(p): rel_l2(grads[p], np.asarray(v)) for p, v in flat}
    record_property("h_rel_l2", h_err)
    record_property("loss_rel", loss_errs)
    record_property("worst_grad_rel_l2", max(grad_errs.values()))
    assert h_err <= H_TOL
    assert max(loss_errs.values()) <= LOSS_TOL, loss_errs
    for path, err in grad_errs.items():
        assert err <= GRAD_TOL, (path, err)


def test_served_rirs_match_jax(tmp_path, record_property):
    raw, _, params, _, jax_room, port_room = random_models(tmp_path)
    jcfg = JaxDiffGFDNConfig.model_validate(raw)
    save_checkpoint(jcfg.trainer_config.train_dir, -1, params)
    idx = np.arange(6)  # a full batch and a padded one
    ref = jinf.InferDiffGFDN(jcfg, jax_room).rirs_at(idx, batch_size=BATCH)
    rirs = InferDiffGFDN(DiffGFDNConfig.from_dict(raw), port_room, device="cpu").rirs_at(
        idx, batch_size=BATCH)
    assert rirs.shape == ref.shape == (len(idx), NFFT)
    err = rel_l2(rirs, ref)
    edc_err = float(np.abs(edc_db(rirs) - edc_db(ref))[:, : int(0.5 * FS)].max())
    record_property("rir_rel_l2", err)
    record_property("edc_max_abs_db", edc_err)
    assert err <= RIR_TOL and edc_err <= EDC_TOL_DB


@pytest.mark.parametrize("svf", [True, False], ids=["svf_heads_geq", "scalar_heads"])
def test_time_domain_synthesis_matches_jax(tmp_path, svf, record_property):
    _, jmodel, params, model, _, port_room = random_models(tmp_path, svf)
    idx = np.arange(BATCH)
    batch = {"listener_position": port_room.receiver_position[idx].astype(np.float32),
             "norm_listener_position": port_room.norm_receiver_position[idx].astype(np.float32)}
    ref = np.asarray(jinf.make_time_domain_synthesis_fn(jmodel, params, NFFT)(
        dict(batch, z_values=np.ones(1, np.complex64))))
    rirs = make_time_domain_synthesis_fn(model, NFFT)(
        {k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    assert rirs.shape == ref.shape == (BATCH, NFFT) and np.isfinite(rirs).all()
    err = float(np.abs(rirs - ref).max() / np.abs(ref).max())
    record_property("max_abs_over_peak_vs_jax", err)
    assert err <= TD_TOL


def test_fit_indexed_raises_c16(tmp_path):
    """JAX fails where it normalizes the io gains; the port refuses there,
    before a step (no launch, no step graph)."""
    raw, jmodel, params, model, jax_room, port_room = random_models(tmp_path)
    jcfg = JaxDiffGFDNConfig.model_validate(raw)
    train_idx, valid_idx = np.arange(6), np.arange(6, 9)
    jtrainer = JaxGFDNTrainer(jmodel, jcfg.trainer_config, 2,
                              common_decay_times=jax_room.common_decay_times, sample_rate=FS)
    arrays = jax_arrays(jax_room)
    jtrainer.precompute_target_features(arrays)
    with pytest.raises(AttributeError, match='has no attribute "M"'):
        jtrainer.fit_indexed(jax.tree_util.tree_map(jnp.asarray, params), arrays, train_idx,
                             valid_idx)
    cfg = DiffGFDNConfig.from_dict(raw)
    trainer = GFDNTrainer(model, cfg.trainer_config, 2,
                          common_decay_times=port_room.common_decay_times, sample_rate=FS,
                          device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="ROADMAP C16"):
        trainer.fit_indexed(arrays_from_room_dataset(port_room), train_idx, valid_idx)
    assert not trainer.train_loss and list(trainer.graphs) == []
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


SYNTH_PRESETS = sorted(name for name in PRESETS if name.startswith("synth_"))


@pytest.fixture(scope="module")
def rooms_48k(tmp_path_factory):
    """(JAX dataset, port dataset): a small synthetic grid at the synth
    presets' 48 kHz."""
    path = generate_three_room_pickle(tmp_path_factory.mktemp("synth") / "srirs.pkl",
                                      fs=48000.0, num_rec_per_room=2, rir_len_s=0.1,
                                      decay_times=(0.6, 0.9, 0.75))
    return JaxThreeRoomDataset(path, nfft=512), ThreeRoomDataset(path, nfft=512)


def test_synth_presets_are_the_nine():
    assert len(SYNTH_PRESETS) == 9


@pytest.mark.parametrize("name", SYNTH_PRESETS)
def test_synth_preset_builds_the_jax_parameter_tree(rooms_48k, name):
    raw = copy.deepcopy(PRESETS[name])
    cfg = DiffGFDNConfig.from_dict(raw)
    jcfg = JaxDiffGFDNConfig.model_validate(raw)
    g = cfg.num_groups
    base = np.array([0.6, 0.9, 0.75])[:g]
    jax_room, port_room = rooms_48k
    bands = np.asarray(port_room.band_centre_hz)
    cdt = (base[None, :] * np.linspace(1.2, 0.8, len(bands))[:, None]
           if cfg.decay_filter_config.use_absorption_filters else base[None, :])
    model = build_gfdn_model(cfg, cdt, bands, device="cpu")
    jmodel = jax_build_gfdn_model(jcfg, common_decay_times=cdt, band_centre_hz=bands,
                                  use_pallas_inverse=False)
    example = init_example_batch(jax_arrays(jax_room), 2)
    tree = jax.eval_shape(lambda k: jmodel.init(k, example), jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    mapped = torch_state_from_jax(jax.tree_util.tree_map(lambda v: np.zeros(v.shape), tree))
    assert len(mapped) == len(want)
    assert ({k: tuple(v.shape) for k, v in mapped.items()}
            == {k: tuple(v.shape) for k, v in model.state_dict().items()})
