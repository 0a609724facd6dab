"""The source-and-receiver model DiffGFDNVarSourceReceiverPos in the port against JAX.

The JAX model is initialized (flax ``init``) and its parameters are carried
into the port; both see the same synthetic dataset (fs 8 kHz, nfft 2^12),
each receiver with its own seeded source position. The four head
combinations (scalar or SVF output heads, scalar or SVF input heads of
other widths), on a block-diagonal loop (zero coupling) and a coupled one
(learned Givens angles). Bounds:

* the parameter trees: the port's ``state_dict`` has the leaves and shapes
  of JAX's ``init``;
* H: 1e-3 relative L2 (C7's slice bound); gradients of a smooth functional
  of H, every leaf: 2e-3 relative L2 (C3);
* a 2-epoch ``fit_indexed`` from the same parameters, split and batch order:
  the train and validation losses of epoch 0 within 1e-3 and of epoch 1
  within 1e-2 relative (C3's);
* ``InferDiffGFDN(variant="var_source_receiver").rirs_at`` against JAX's:
  relative L2 1e-3, EDC 0.01 dB over 0.5 s;
* time-domain synthesis (ROADMAP C17): JAX's ``make_time_domain_synthesis_fn``
  drives the loop with the input gains alone, so its RIRs depart from its
  own frequency path by far more than the time-domain bound (2e-3 of the
  peak, C5); the port raises ``ValueError`` naming C17 instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.data import arrays_from_room_dataset
from diffgfdn_torch.inference import InferDiffGFDN, make_time_domain_synthesis_fn
from diffgfdn_torch.models import DiffGFDNVarSourceReceiverPos
from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer
from diffgfdn_torch.utils.params import jax_grads_from_torch, load_jax_params
from diffgfdn_torch.utils.params import torch_state_from_jax
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data.batching import arrays_from_room_dataset as jax_arrays
from diffgfdn_tpu.data.batching import gather_batch, train_valid_split
from diffgfdn_tpu.inference import gfdn_inference as jinf
from diffgfdn_tpu.training.checkpoints import save_checkpoint
from diffgfdn_tpu.training.trainer import GFDNTrainer as JaxGFDNTrainer, padded_batches
from diffgfdn_tpu.utils.cio import encode_batch
from torch_port_helpers import edc_db, FS, jax_model_and_params, raw_config, rel_l2, rooms

NFFT = 4096
BATCH = 4
H_TOL = 1e-3
GRAD_TOL = 2e-3
EPOCH_TOL = (1e-3, 1e-2)
RIR_TOL = 1e-3
EDC_TOL_DB = 0.01
TD_FREQ_TOL = 2e-3
HEADS = {"scalar_scalar": (False, False), "scalar_svf": (False, True),
         "svf_scalar": (True, False), "svf_svf": (True, True)}
INPUTS = ("z_values", "listener_position", "norm_listener_position", "source_position",
          "target_early_response")


def vs_raw(tmp_path, out_svf: bool, in_svf: bool, zero_coupling: bool = True,
           nfft: int = NFFT) -> dict:
    """A narrow source-and-receiver config: raw_config's output heads (2 x 16)
    and input heads of other widths (1 x 8, 3 Fourier features)."""
    raw = raw_config(tmp_path, out_svf, zero_coupling, nfft=nfft, batch=BATCH)
    raw["input_filter_config"] = dict(use_svfs=in_svf, num_hidden_layers=1,
                                      num_neurons_per_layer=8, num_fourier_features=3)
    return raw


def vs_rooms(tmp_path, out_svf: bool, nfft: int = NFFT):
    """rooms() with a seeded source position per receiver, in both datasets."""
    jax_room, port_room = rooms(tmp_path, out_svf, nfft)
    src = np.random.RandomState(8).uniform([0.5, 0.5, 1.0], [9.5, 7.5, 2.0],
                                           (port_room.num_rec, 3))
    for room in (jax_room, port_room):
        room.source_position = src
    return jax_room, port_room


def vs_models(tmp_path, heads: str, zero_coupling: bool = True, nfft: int = NFFT,
              decays=None):
    """(raw config, JAX model, its initial params, the port model with them,
    JAX room, port room)."""
    out_svf, in_svf = HEADS[heads]
    raw = vs_raw(tmp_path, out_svf, in_svf, zero_coupling, nfft)
    jax_room, port_room = vs_rooms(tmp_path, out_svf, nfft)
    if decays is not None:
        for room in (jax_room, port_room):
            cdt = np.asarray(room.common_decay_times)
            room.common_decay_times = (
                np.asarray(decays)[None] * np.linspace(1.2, 0.8, cdt.shape[0])[:, None]
                if cdt.ndim == 2 else np.asarray(decays))
    jmodel, params = jax_model_and_params(JaxDiffGFDNConfig.model_validate(raw), jax_room,
                                          BATCH, variant="var_source_receiver")
    model = build_gfdn_model(DiffGFDNConfig.from_dict(raw), port_room.common_decay_times,
                             port_room.band_centre_hz, variant="var_source_receiver",
                             device="cpu")
    return raw, jmodel, params, model, jax_room, port_room


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# half of the combinations in the quick set, each head kind on each loop
QUICK = {("scalar_scalar", True), ("svf_scalar", True), ("scalar_scalar", False),
         ("scalar_svf", False)}


@pytest.mark.parametrize("heads,zero_coupling", [
    pytest.param(h, zc, id=f"{h}-{'block_diagonal' if zc else 'coupled'}",
                 marks=() if (h, zc) in QUICK else pytest.mark.slow)
    for zc in (True, False) for h in HEADS])
def test_forward_and_gradients_match_jax(tmp_path, heads, zero_coupling, record_property):
    _, jmodel, params, model, jax_room, _ = vs_models(tmp_path, heads, zero_coupling)
    mapped = torch_state_from_jax(params)
    assert ({k: tuple(v.shape) for k, v in mapped.items()}
            == {k: tuple(v.shape) for k, v in model.state_dict().items()})
    assert any(k.startswith("input_") and "mlp" in k for k in mapped)
    load_jax_params(model, params)
    batch = gather_batch(jax_arrays(jax_room), np.array([0, 2, 4, 8]))
    batch = {k: np.asarray(batch[k]) for k in INPUTS}
    assert len({tuple(p) for p in batch["source_position"]}) == BATCH
    direct = batch["target_early_response"]
    weight = np.random.RandomState(5).uniform(0.5, 1.5, NFFT // 2 + 1).astype(np.float32)

    def jax_loss(p):
        h = jmodel.apply(p, batch)
        hd = h - direct
        return jnp.sum(weight * (jnp.real(hd) ** 2 + jnp.imag(hd) ** 2)), h

    (_, h_ref), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    h_ref = np.asarray(h_ref)
    tb = _tensors(batch)
    h = model(tb)
    assert h.shape == (BATCH, NFFT // 2 + 1)
    h_err = rel_l2(h.detach().numpy() - direct, h_ref - direct)
    hd = h - tb["target_early_response"]
    torch.sum(torch.from_numpy(weight) * (hd.real ** 2 + hd.imag ** 2)).backward()
    grads = dict(jax.tree_util.tree_leaves_with_path(jax_grads_from_torch(model)))
    flat = jax.tree_util.tree_leaves_with_path(ref_grads)
    assert len(grads) == len(flat)
    grad_errs = {jax.tree_util.keystr(p): rel_l2(grads[p], np.asarray(v)) for p, v in flat}
    record_property("h_rel_l2", h_err)
    record_property("worst_grad_rel_l2", max(grad_errs.values()))
    assert h_err <= H_TOL
    for path, err in grad_errs.items():
        assert err <= GRAD_TOL, (path, err)


def _two_epochs(tmp_path, heads: str, zero_coupling: bool, record_property) -> None:
    raw, jmodel, params, model, jax_room, port_room = vs_models(tmp_path, heads, zero_coupling)
    load_jax_params(model, params)
    raw["trainer_config"].update(max_epochs=2)
    dirs = {side: str(tmp_path / side) for side in ("jax", "port")}
    jcfg = JaxDiffGFDNConfig.model_validate(
        dict(raw, trainer_config=dict(raw["trainer_config"], train_dir=dirs["jax"])))
    cfg = DiffGFDNConfig.from_dict(
        dict(raw, trainer_config=dict(raw["trainer_config"], train_dir=dirs["port"])))
    arrays = jax_arrays(jax_room)
    train_idx, valid_idx = train_valid_split(np.arange(arrays.num_items), 0.8, seed=cfg.seed)
    steps = len(list(padded_batches(train_idx, BATCH)))
    jtrainer = JaxGFDNTrainer(jmodel, jcfg.trainer_config, steps,
                              common_decay_times=jax_room.common_decay_times, sample_rate=FS)
    jtrainer.precompute_target_features(arrays)
    jtrainer.fit_indexed(jax.tree_util.tree_map(jnp.asarray, params), arrays, train_idx,
                         valid_idx, seed=cfg.seed)
    trainer = GFDNTrainer(model, cfg.trainer_config, steps,
                          common_decay_times=port_room.common_decay_times, sample_rate=FS,
                          device="cpu")
    port_arrays = arrays_from_room_dataset(port_room)
    trainer.precompute_target_features(port_arrays)
    trainer.fit_indexed(port_arrays, train_idx, valid_idx, seed=cfg.seed)
    assert "source_position" in trainer.data
    errs = []
    for epoch in range(2):
        pairs = ((trainer.train_loss[epoch], jtrainer.train_loss[epoch]),
                 (trainer.valid_loss[epoch], jtrainer.valid_loss[epoch]))
        errs.append(max(abs(a - b) / abs(b) for a, b in pairs))
    record_property("epoch_loss_rel", errs)
    for err, tol in zip(errs, EPOCH_TOL):
        assert err <= tol, (errs, trainer.train_loss, jtrainer.train_loss)


def test_two_epoch_fit_indexed_matches_jax(tmp_path, record_property):
    """Scalar heads on both sides of a block-diagonal loop: the io gains are
    normalized before every step."""
    _two_epochs(tmp_path, "scalar_scalar", True, record_property)


@pytest.mark.slow
@pytest.mark.parametrize("heads,zero_coupling", [("svf_svf", True), ("svf_scalar", False)],
                         ids=["svf_svf_block_diagonal", "svf_scalar_coupled"])
def test_two_epoch_fit_indexed_matches_jax_svf(tmp_path, heads, zero_coupling,
                                               record_property):
    """SVF output heads: the io gains are normalized once an epoch."""
    _two_epochs(tmp_path, heads, zero_coupling, record_property)


@pytest.mark.parametrize("heads", ["scalar_svf", "svf_svf"])
def test_served_rirs_match_jax(tmp_path, heads, record_property):
    raw, _, params, _, jax_room, port_room = vs_models(tmp_path, heads)
    jcfg = JaxDiffGFDNConfig.model_validate(raw)
    save_checkpoint(jcfg.trainer_config.train_dir, -1, params)
    idx = np.arange(6)  # a full batch and a padded one
    ref = jinf.InferDiffGFDN(jcfg, jax_room, variant="var_source_receiver").rirs_at(
        idx, batch_size=BATCH)
    infer = InferDiffGFDN(DiffGFDNConfig.from_dict(raw), port_room,
                          variant="var_source_receiver", device="cpu")
    assert isinstance(infer.model, DiffGFDNVarSourceReceiverPos)
    rirs = infer.rirs_at(idx, batch_size=BATCH)
    assert rirs.shape == ref.shape == (len(idx), NFFT)
    err = rel_l2(rirs, ref)
    edc_err = float(np.abs(edc_db(rirs) - edc_db(ref))[:, : int(0.5 * FS)].max())
    record_property("rir_rel_l2", err)
    record_property("edc_max_abs_db", edc_err)
    assert err <= RIR_TOL and edc_err <= EDC_TOL_DB


@pytest.mark.parametrize("heads", ["scalar_scalar",
                                   pytest.param("svf_svf", marks=pytest.mark.slow)])
def test_time_domain_synthesis_raises_c17(tmp_path, heads, record_property):
    """JAX's time domain against JAX's own frequency path at nfft 8192 and
    decays near 0.5 s, where the two agree within 2e-3 of the peak for a
    model without source heads (tests/test_torch_td_inference.py)."""
    nfft = 8192
    _, jmodel, params, model, jax_room, _ = vs_models(tmp_path, heads, nfft=nfft,
                                                      decays=(0.45, 0.55, 0.5))
    batch = gather_batch(jax_arrays(jax_room), np.arange(BATCH))
    batch = {k: np.asarray(batch[k]) for k in INPUTS if k != "target_early_response"}
    td = np.asarray(jinf.make_time_domain_synthesis_fn(jmodel, params, nfft)(
        dict(batch, z_values=np.ones(1, np.complex64))))
    freq = np.asarray(jinf.make_rir_synthesis_fn(jmodel)(params, encode_batch(batch)))
    err = float(np.abs(td - freq).max() / np.abs(freq).max())
    record_property("jax_time_domain_vs_frequency_path", err)
    assert err > 10 * TD_FREQ_TOL
    with pytest.raises(ValueError, match="ROADMAP C17"):
        make_time_domain_synthesis_fn(model, nfft)
