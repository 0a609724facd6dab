"""Meshgrid heads (ROADMAP A4) served, synthesized and on the source side,
in the port against the JAX package.

* scalar meshgrid heads: RIRs served by ``InferDiffGFDN`` from a JAX
  checkpoint (the mesh in each batch) within 1e-3 relative L2 and 0.01 dB,
  the time domain within 1e-4 of JAX's peak;
* ``DiffGFDNVarSourceReceiverPos`` with meshgrid heads on both sides: SVF
  heads (each looks up its own ``position_key``) H within 1e-3 of JAX's.
  Scalar heads: JAX's ``GainsFromMLP`` looks up the raw ``listener_position``
  on the mesh even for the source head; the port's source head looks up
  ``source_position`` (ROADMAP C19). Its gains equal JAX's head given the
  source positions as the listener's, and H equals JAX's where the two
  positions coincide.
"""

import numpy as np
import pytest
import torch

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.training import build_gfdn_model
from diffgfdn_torch.utils.params import load_jax_params
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data.batching import arrays_from_room_dataset, gather_batch
from torch_option_parity import (
    EDC_TOL_DB,
    H_TOL,
    merged,
    option_models,
    RIR_TOL,
    SERVE_NFFT,
    served_errors,
    TD_TOL,
    time_domain_error,
)
from torch_port_helpers import jax_model_and_params, raw_config, rel_l2, rooms

MESH_SCALAR = {"output_filter_config": {"encoding_type": "meshgrid", "use_svfs": False}}
NFFT = 1024
IDX = np.array([0, 2, 4, 8])


def test_scalar_heads_served_and_time_domain_match_jax(tmp_path, record_property):
    m = option_models(tmp_path, MESH_SCALAR, svf=False, nfft=SERVE_NFFT)
    served = served_errors(m)
    td = time_domain_error(m, mesh=True)
    record_property("served", served)
    record_property("time_domain_max_abs_over_peak", td)
    assert served["rel_l2"] <= RIR_TOL and served["edc_db"] <= EDC_TOL_DB, served
    assert td <= TD_TOL


@pytest.mark.parametrize("svf", [True, False], ids=["svf_heads", "scalar_heads"])
def test_source_heads_match_jax(tmp_path, svf, record_property):
    mesh = {"encoding_type": "meshgrid", "use_svfs": svf, "num_hidden_layers": 1,
            "num_neurons_per_layer": 8}
    raw = merged(raw_config(tmp_path, svf, nfft=NFFT), {"output_filter_config": mesh})
    raw["input_filter_config"] = dict(mesh)
    jax_room, port_room = rooms(tmp_path, svf, NFFT)
    src = np.random.RandomState(8).uniform([0.5, 0.5, 1.0], [9.5, 7.5, 2.0],
                                           (port_room.num_rec, 3))
    for room in (jax_room, port_room):
        room.source_position = src
    jmodel, params = jax_model_and_params(JaxDiffGFDNConfig.model_validate(raw), jax_room, 4,
                                          variant="var_source_receiver")
    model = build_gfdn_model(DiffGFDNConfig.from_dict(raw), port_room.common_decay_times,
                             port_room.band_centre_hz, variant="var_source_receiver",
                             device="cpu")
    load_jax_params(model, params)
    batch = gather_batch(arrays_from_room_dataset(jax_room), IDX)
    keys = ("z_values", "listener_position", "norm_listener_position", "source_position",
            "target_early_response", "mesh_2d")
    batch = {k: np.asarray(batch[k]) for k in keys}
    if not svf:  # JAX's source head looks up the listener position
        same = dict(batch, source_position=batch["listener_position"])
        gains = model.input_scalars({k: torch.from_numpy(v) for k, v in batch.items()})
        ref = jmodel.apply(params, dict(batch, listener_position=batch["source_position"]),
                           method=lambda mdl, x: mdl.input_scalars(x))
        gain_err = float(np.abs(gains.detach().numpy() - np.asarray(ref)).max())
        record_property("source_gains_max_abs_err", gain_err)
        assert gain_err <= 1e-6
        batch = same
    h_ref = np.asarray(jmodel.apply(params, batch))
    with torch.no_grad():
        h = model({k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    direct = batch["target_early_response"]
    err = rel_l2(h - direct, h_ref - direct)
    record_property("h_rel_l2", err)
    assert err <= H_TOL
