"""The coupled directional model (ROADMAP A10: ``use_zero_coupling: false``
at ambi order 2) served and synthesized by the port against JAX.

* SH-domain SRIRs served by ``InferDiffGFDN(variant="directional")``
  against JAX's ``make_rir_synthesis_fn`` (JAX's class cannot build the
  model, C11) within 1e-3 relative L2;
* the time domain (B7's plain version on the dense transposed A) within
  1e-4 of JAX's peak, decays near 0.5 s at 8192 samples (C5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffgfdn_torch.inference import InferDiffGFDN, make_time_domain_synthesis_fn
from diffgfdn_tpu.data.spatial_dataset import arrays_from_spatial_dataset as jax_arrays
from diffgfdn_tpu.inference import gfdn_inference as jinf
from diffgfdn_tpu.utils.cio import encode_batch
from test_torch_coupled_directional import BATCH, coupled_models
from torch_port_helpers import rel_l2, spatial_rooms

RIR_TOL = 1e-3
TD_TOL = 1e-4
TD_SAMPLES = 8192


def test_served_and_time_domain_match_jax(tmp_path, record_property):
    """Served at the dataset's nfft, and in the time domain at decays near 0.5 s."""
    rooms = spatial_rooms(tmp_path, decay_times=(0.4, 0.5, 0.45))
    m = coupled_models(tmp_path, rooms)
    room = m.port_room
    infer = InferDiffGFDN(m.cfg, room, variant="directional", params=m.params, device="cpu")
    idx = np.array([0, 5, 17, 30, 43])
    rirs = infer.rirs_at(idx, batch_size=BATCH)
    arrays = jax_arrays(m.jax_room)
    batch = {"z_values": arrays.z_values, "listener_position": arrays.listener_position[idx],
             "norm_listener_position": arrays.norm_listener_position[idx]}
    synth = jinf.make_rir_synthesis_fn(m.jmodel, m.jcfg.trainer_config.reduced_pole_radius)
    ref = np.asarray(synth(jax.tree_util.tree_map(jnp.asarray, m.params), encode_batch(batch)))
    served = rel_l2(rirs, ref)
    tb = {k: batch[k] for k in ("listener_position", "norm_listener_position")}
    td = make_time_domain_synthesis_fn(infer.model, TD_SAMPLES)(
        {k: torch.from_numpy(v) for k, v in tb.items()}).numpy()
    td_ref = np.asarray(jinf.make_time_domain_synthesis_fn(
        m.jmodel, jax.tree_util.tree_map(jnp.asarray, m.params), TD_SAMPLES)(tb))
    assert td.shape == td_ref.shape == (len(idx), 9, TD_SAMPLES)
    td_err = float(np.abs(td - td_ref).max() / np.abs(td_ref).max())
    record_property("served_rel_l2", served)
    record_property("time_domain_max_abs_over_peak", td_err)
    assert rirs.shape == ref.shape and served <= RIR_TOL
    assert td_err <= TD_TOL
