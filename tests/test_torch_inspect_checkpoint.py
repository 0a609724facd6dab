"""The checkpoint-inspection CLI against the JAX package (the slice as a whole).

A JAX checkpoint of a narrow ``DiffGFDNVarReceiverPos`` (12 lines in 3
groups, 2 x 16 MLP heads) with SVF heads, and one with scalar heads and
learned SCALAR coupling, on 24 synthetic receivers (fs 8 kHz, nfft 2048),
both with the dataset's broadband decay times: the common-slopes baseline
of both packages reads one decay time a slope (per-band decay times make
JAX's ``shaped_wgn`` raise, and the port's alike). JAX's ``inspect`` and the
port's (``device="cpu"``, the baseline on JAX's noise) read the same
checkpoint and dataset. Bounds: the mean EDC and EDR errors and the baseline's EDC error
within 0.01 dB of JAX's; the deep-dive receiver equal; the coupling's
diagonal measure within 1e-5 relative; the same figures written.
``compare_runs`` over the two train dirs gives JAX's summary.
"""

import jax
import numpy as np
import pytest
import torch

from diffgfdn_torch.cli import inspect_checkpoint as port_cli
from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.data import ThreeRoomDataset
from diffgfdn_torch.inference import cs_synthesis
from diffgfdn_tpu.cli import inspect_checkpoint as jax_cli
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data import generate_three_room_pickle
from diffgfdn_tpu.data import ThreeRoomDataset as JaxThreeRoomDataset
from diffgfdn_tpu.training.checkpoints import save_checkpoint
from diffgfdn_tpu.training.save_results import save_loss
from torch_port_helpers import FS, jax_model_and_params, raw_config

NFFT = 2048
DB_TOL = 0.01
DIAG_TOL = 1e-5
DECAYS = (0.2, 0.3, 0.25)
HEADS = {"svf": dict(svf=True), "scalar_coupled": dict(svf=False, zero_coupling=False)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{head kind: (raw config, JAX dataset, port dataset)}, a JAX checkpoint
    and a losses.mat in each train dir."""
    tmp = tmp_path_factory.mktemp("inspect")
    path = generate_three_room_pickle(tmp / "srirs.pkl", fs=FS, num_rec_per_room=8,
                                      rir_len_s=0.3, decay_times=DECAYS)
    out = {}
    for name, kw in HEADS.items():
        raw = raw_config(tmp / name, nfft=NFFT, batch=8, **kw)
        raw["decay_filter_config"]["use_absorption_filters"] = False
        jax_room, room = JaxThreeRoomDataset(path, nfft=NFFT), ThreeRoomDataset(path, nfft=NFFT)
        jcfg = JaxDiffGFDNConfig.model_validate(raw)
        _, params = jax_model_and_params(jcfg, jax_room, 8, inference_solve=True)
        train_dir = jcfg.trainer_config.train_dir
        save_checkpoint(train_dir, -1, params)
        losses = np.random.RandomState(len(name)).rand(2, 4)
        save_loss(losses[0], losses[1], train_dir)
        out[name] = (raw, jax_room, room)
    return out


@pytest.mark.parametrize("heads", sorted(HEADS))
def test_inspect_matches_jax(runs, heads, tmp_path, monkeypatch, record_property):
    raw, jax_room, room = runs[heads]
    want = jax_cli.inspect(JaxDiffGFDNConfig.model_validate(raw), room_data=jax_room,
                           max_receivers=24, out_dir=str(tmp_path / "jax"), cs_baseline=True)
    monkeypatch.setattr(cs_synthesis, "draw_noise", lambda shape, generator, device:
                        torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0),
                                                                    shape))))
    got = port_cli.inspect(DiffGFDNConfig.from_dict(raw), room_data=room, max_receivers=24,
                           out_dir=str(tmp_path / "port"), cs_baseline=True, device="cpu")
    assert sorted(got) == sorted(want) and got["rec_index"] == want["rec_index"]
    errs = {k: abs(got[k] - want[k]) for k in ("mean_edc_err_db", "mean_edr_err_db",
                                                "cs_edc_err_db")}
    diag = abs(got["coupling_diagonal_measure"] - want["coupling_diagonal_measure"]) / abs(
        want["coupling_diagonal_measure"])
    record_property("abs_db", errs)
    record_property("diagonal_measure_rel", diag)
    assert max(errs.values()) <= DB_TOL, errs
    assert diag <= DIAG_TOL
    if heads == "scalar_coupled":  # learned coupling: the matrix is not block-diagonal
        assert got["coupling_diagonal_measure"] < 1.0
    names = {p.name for p in (tmp_path / "jax").iterdir()}
    assert {p.name for p in (tmp_path / "port").iterdir()} == names
    assert "loss_curves.png" in names and "coupling_matrix.png" in names


def test_metrics_step_and_compare_runs_match_jax(runs, tmp_path):
    """The metrics step alone serves (a deep-dive receiver outside the
    mapped ones too) and writes nothing; ``compare_runs`` gives JAX's final
    losses and writes its figure."""
    raw, _, room = runs["svf"]
    before = sorted(p.name for p in tmp_path.parent.rglob("*"))
    ins = port_cli.inspect_metrics(DiffGFDNConfig.from_dict(raw), room, rec_index=5,
                                   max_receivers=6, device="cpu")
    assert sorted(p.name for p in tmp_path.parent.rglob("*")) == before
    assert ins.metrics["rec_index"] == 5 and len(ins.edc_err) == len(ins.edr_err) == 6
    assert ins.h_true.shape == ins.h_synth.shape and len(ins.rir_sets) == 2
    dirs = [runs[h][0]["trainer_config"]["train_dir"] for h in sorted(HEADS)]
    got = port_cli.compare_runs(dirs, str(tmp_path / "port.png"))
    assert got == jax_cli.compare_runs(dirs, str(tmp_path / "jax.png"))
    assert (tmp_path / "port.png").stat().st_size > 0
