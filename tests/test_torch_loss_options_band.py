"""The loss options (ROADMAP A5) in the band-parallel trainer and on the
single-position SVF head, in the port against the JAX package.

* one band-parallel step of the 500 / 1000 Hz group (fs 8 kHz, nfft 2^12,
  24 synthetic receivers; SVF heads, GEQ absorption) with
  ``use_erb_edr_loss``, ``use_frequency_weighting`` and ``use_reg_loss``
  on, as tests/test_band_parallel_parity.py turns them on in JAX's: each
  band's losses 1e-3 relative and gradients 1e-2 relative L2 against JAX's
  ``BandParallelTrainer`` (its band loss vmapped over the band-stacked
  parameters, the port's under ``torch.func.vmap``). The regularizer runs
  over 20 ms (over the default 500 ms it is float32 rounding in both
  packages, ROADMAP C19). JAX builds the group's models from its first
  config, so the port's are built from it too here;
* ``reg_loss`` on the single-position SVF head of JAX's fixture
  (tests/test_plot_and_misc.py).
"""

import jax
import numpy as np
import torch

from diffgfdn_torch.data import arrays_from_room_dataset
from diffgfdn_torch.losses import reg_loss
from diffgfdn_torch.parallel import BandParallelTrainer
from diffgfdn_torch.training import build_gfdn_model
from diffgfdn_torch.training.solver import subband_resp
from diffgfdn_torch.utils.params import jax_grads_from_torch, torch_state_from_jax
from diffgfdn_tpu.data.batching import arrays_from_room_dataset as jax_arrays
from diffgfdn_tpu.data.batching import gather_batch, init_example_batch
from diffgfdn_tpu.losses import gfdn as jlosses
from diffgfdn_tpu.parallel import BandParallelTrainer as JaxBandParallelTrainer
from diffgfdn_tpu.parallel.mesh import make_mesh
from diffgfdn_tpu.training.build import build_gfdn_model as jax_build_gfdn_model
from torch_port_helpers import (
    rel_l2,
    single_pos_models,
    single_pos_raw,
    subband_configs,
    subband_room_path,
    subband_rooms,
)

LOSS_TOL = 1e-3
GRAD_TOL = 1e-2
IDX = np.arange(8)


def test_band_parallel_step_with_the_loss_options_matches_jax(tmp_path, monkeypatch,
                                                             record_property):
    path = subband_room_path(tmp_path)
    jax_room, port_room = subband_rooms(path)
    jcfgs, cfgs = subband_configs(monkeypatch, path, tmp_path, spectral_weight=0.0)
    jcfgs, cfgs = jcfgs[:2], cfgs[:2]
    for cfg in jcfgs + cfgs:
        cfg.output_filter_config.use_svfs = True
        tc = cfg.trainer_config
        tc.use_erb_edr_loss = tc.use_frequency_weighting = tc.use_reg_loss = True
        tc.output_filt_ir_len_ms = 20.0
    resps = np.stack([subband_resp(c) for c in cfgs])
    max_ir_ms = float(np.max(jax_room.common_decay_times)) * 1e3
    arrays = jax_arrays(jax_room)
    jax_model = jax_build_gfdn_model(jcfgs[0], common_decay_times=jax_room.common_decay_times,
                                     band_centre_hz=jax_room.band_centre_hz,
                                     use_pallas_inverse=False)
    jtrainer = JaxBandParallelTrainer(jax_model, jcfgs[0].trainer_config, resps,
                                      steps_per_epoch=2, max_ir_len_ms=max_ir_ms,
                                      mesh=make_mesh(1, devices=jax.devices("cpu")[:1]))
    params, _ = jtrainer.init(init_example_batch(arrays, len(IDX)),
                              seeds=[c.seed for c in jcfgs])
    jtrainer.precompute_band_target_features(arrays)
    key = jax.random.PRNGKey(3)
    batch = gather_batch(arrays, IDX)
    feats = {k: v[:, IDX] for k, v in jtrainer._band_feats.items()}

    @jax.jit
    def band_grads(p, f, resp):
        return jax.vmap(jax.value_and_grad(
            lambda pb, fb, rb: jtrainer._loss_fn(pb, {**batch, **fb}, rb, key), has_aux=True
        ))(p, f, resp)

    (ref_totals, ref_auxes), ref_grads = band_grads(params, feats, jtrainer.band_responses)
    assert set(ref_auxes) >= {"edc_loss", "edr_loss", "reg_loss"}

    models = [build_gfdn_model(cfgs[0], port_room.common_decay_times, port_room.band_centre_hz,
                               device="cpu") for _ in cfgs]
    trainer = BandParallelTrainer(models, cfgs[0].trainer_config, resps, 2,
                                  max_ir_len_ms=max_ir_ms, device="cpu")
    assert trainer.erb_filters.shape == (64, trainer.edr_win // 2 + 1)
    trainer.load_band_params(torch_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    trainer.upload_arrays(arrays_from_room_dataset(port_room))
    totals, losses = trainer.loss_and_grads(torch.from_numpy(IDX))
    assert sorted(losses) == sorted(ref_auxes)
    loss_errs, grad_errs = {}, {}
    grads = {k: p.grad for k, p in trainer.params.items()}
    for b in range(2):
        for k, v in ref_auxes.items():
            # relative, or absolute for the spectral term at weight 0
            loss_errs[f"{k}[{b}]"] = abs(float(losses[k][b]) - float(v[b])) / (
                abs(float(v[b])) or 1.0)
        loss_errs[f"total[{b}]"] = abs(float(totals[b]) - float(ref_totals[b])) / abs(
            float(ref_totals[b]))
        model = models[b]
        for name, p in model.named_parameters():
            p.grad = grads[name][b]
        got = dict(jax.tree_util.tree_leaves_with_path(jax_grads_from_torch(model)))
        for path_, leaf in jax.tree_util.tree_leaves_with_path(ref_grads):
            grad_errs[f"{jax.tree_util.keystr(path_)}[{b}]"] = rel_l2(
                got[path_], np.asarray(leaf)[b])
    record_property("loss_rel", max(loss_errs.values()))
    record_property("worst_grad_rel_l2", max(grad_errs.values()))
    assert max(loss_errs.values()) <= LOSS_TOL, loss_errs
    assert max(grad_errs.values()) <= GRAD_TOL, grad_errs


def test_reg_loss_on_the_single_position_svf_head(tmp_path, record_property):
    """JAX's fixture: 3 groups of 2 lines at 8 kHz, SVF output heads, the
    regularizer over 100 ms (800 samples). At the fixture's initial heads
    (gain channel 0: each section's 0 dB peak or shelf is the identity, so
    the cascades are impulses) both packages' values are float32 rounding
    (below 1e-6, ROADMAP C19); with the resonance channel near -9 (R near
    1e-4) and gains of a few dB the cascades ring, and the port's value and
    gradient in the head's parameters are held to JAX's."""
    raw = single_pos_raw(tmp_path, svf_out=True, svf_in=False, num_delay_lines=6,
                         use_reg_loss=True, output_filt_ir_len_ms=100.0)
    jcfg, jmodel, params, model, _, _ = single_pos_models(raw, tmp_path)
    jax_model = type(jmodel)

    def jloss(p):
        h = jmodel.apply(p, {}, method=jax_model.output_filter_params)
        return jlosses.reg_loss(h["biquad_num"], h["biquad_den"], 800)

    head = model.output_filter_params({})
    with torch.no_grad():
        floor = float(reg_loss(head["biquad_num"], head["biquad_den"], 800))
    assert floor <= 1e-6 and float(jloss(params)) <= 1e-6
    svf = np.array(params["params"]["output_svf_params"])
    rng = np.random.RandomState(2)
    svf[..., 0] = -9.0 + 0.1 * rng.randn(*svf.shape[:-1])
    svf[..., 1] = 3.0 * rng.randn(*svf.shape[:-1])
    params = {"params": {**params["params"], "output_svf_params": svf}}
    with torch.no_grad():
        model.output_svf_params.copy_(torch.from_numpy(svf))
    head = model.output_filter_params({})
    assert head["biquad_num"].shape == (1, 3) + tuple(params["params"]["output_svf_params"]
                                                      .shape[1:2]) + (3,)
    val = reg_loss(head["biquad_num"], head["biquad_den"], 800)
    val.backward()
    jax_model = type(jmodel)

    def jloss(p):
        h = jmodel.apply(p, {}, method=jax_model.output_filter_params)
        return jlosses.reg_loss(h["biquad_num"], h["biquad_den"], 800)

    jval, jgrad = jax.value_and_grad(jloss)(params)
    ref = np.asarray(jgrad["params"]["output_svf_params"])
    errs = (abs(float(val.detach()) - float(jval)) / abs(float(jval)),
            rel_l2(model.output_svf_params.grad.numpy(), ref))
    record_property("reg_value_at_the_initial_heads", floor)
    record_property("reg_value_rel_and_grad_rel_l2", errs)
    assert errs[0] <= LOSS_TOL and errs[1] <= GRAD_TOL, errs


def test_reg_loss_refuses_the_source_receiver_model(tmp_path):
    """ROADMAP C19: JAX's trainer reads the regularizer's biquads through
    ``output_filter_params``, which ``DiffGFDNVarSourceReceiverPos`` lacks
    (an ``AttributeError`` at its first loss); the port's trainer refuses
    the combination with ``ValueError`` when it is built."""
    import pytest

    from diffgfdn_torch.config.schema import DiffGFDNConfig
    from diffgfdn_torch.training import GFDNTrainer
    from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
    from diffgfdn_tpu.training.trainer import GFDNTrainer as JaxGFDNTrainer
    from torch_port_helpers import jax_model_and_params, raw_config, rooms

    raw = raw_config(tmp_path, svf=True, nfft=512)
    raw["trainer_config"]["use_reg_loss"] = True
    jax_room, port_room = rooms(tmp_path, True, 512)
    jcfg = JaxDiffGFDNConfig.model_validate(raw)
    jmodel, params = jax_model_and_params(jcfg, jax_room, 2, variant="var_source_receiver")
    jtrainer = JaxGFDNTrainer(jmodel, jcfg.trainer_config, 1,
                              common_decay_times=jax_room.common_decay_times)
    batch = gather_batch(jax_arrays(jax_room), np.arange(2))
    with pytest.raises(AttributeError, match="output_filter_params"):
        jtrainer._losses(params, batch, jax.random.PRNGKey(0))
    model = build_gfdn_model(DiffGFDNConfig.from_dict(raw), port_room.common_decay_times,
                             port_room.band_centre_hz, variant="var_source_receiver",
                             device="cpu")
    with pytest.raises(ValueError, match="ROADMAP C19"):
        GFDNTrainer(model, DiffGFDNConfig.from_dict(raw).trainer_config, 1, device="cpu")
