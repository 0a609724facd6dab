"""Serving common-slopes models, checkpoints both ways, the omni collapse
and the CLI. Amplitudes from one checkpoint within 1e-6 relative (max abs
error over max |JAX|); served SRIRs on JAX's noise within 1e-5 relative L2.
"""

import jax
import numpy as np
import pytest
import torch
import yaml

from diffgfdn_torch.cli.run_spatial_sampling import main as cli_main
from diffgfdn_torch.inference import cs_synthesis
from diffgfdn_torch.inference import get_ambisonic_rirs, get_output_from_trained_model
from diffgfdn_torch.training import (
    build_spatial_model,
    collapse_amplitudes_to_omni,
    run_training_spatial_sampling,
    SpatialSamplingTrainer,
)
from diffgfdn_tpu.data.spatial_dataset import arrays_from_spatial_dataset as jax_arrays
from diffgfdn_tpu.data.spatial_dataset import split_by_grid_resolution as jax_split
from diffgfdn_tpu.inference.spatial_inference import get_ambisonic_rirs as jax_ambisonic_rirs
from diffgfdn_tpu.inference.spatial_inference import (
    get_output_from_trained_model as jax_output_from_trained_model,
)
from diffgfdn_tpu.training.checkpoints import load_latest_checkpoint as jax_load_latest
from diffgfdn_tpu.training.spatial_trainer import (
    collapse_amplitudes_to_omni as jax_collapse,
    SpatialSamplingTrainer as JaxSpatialSamplingTrainer,
)
from test_torch_cs_synthesis import _jax_noise
from torch_port_helpers import cs_configs, cs_models, cs_raw_config, cs_room_path, cs_rooms
from torch_port_helpers import CS_RESOLUTION_M, max_rel, rel_l2

AMP_TOL = 1e-6
RIR_TOL = 1e-5


@pytest.fixture(scope="module")
def room_path(tmp_path_factory):
    return cs_room_path(tmp_path_factory.mktemp("cs_inference"))


def _rooms(room_path, directional):
    jax_room, room = cs_rooms(room_path)
    if not directional:
        return jax_collapse(jax_room), collapse_amplitudes_to_omni(room)
    return jax_room, room


@pytest.mark.parametrize("directional", [True, False], ids=["directional", "omni"])
def test_jax_reads_the_ports_checkpoints(tmp_path, room_path, directional, record_property):
    jax_room, room = _rooms(room_path, directional)
    jcfg, cfg = cs_configs(cs_raw_config(tmp_path / "port", directional, epochs=1))
    results = run_training_spatial_sampling(cfg, room, grid_resolutions=[CS_RESOLUTION_M],
                                            device="cpu")
    trainer, model = results[CS_RESOLUTION_M]
    tree = jax_load_latest(str(tmp_path / "port" / f"grid_resolution={CS_RESOLUTION_M:.1f}"),
                           cfg.max_epochs)
    assert tree is not None
    jmodel, _, _ = cs_models(jcfg, cfg, jax_room)
    jtrainer = JaxSpatialSamplingTrainer(jmodel, jcfg, jax_room)
    rec = room.receiver_position[::5]
    want = jax_output_from_trained_model(jcfg, jax_room, rec, CS_RESOLUTION_M)
    got = get_output_from_trained_model(cfg, room, rec, CS_RESOLUTION_M, device="cpu")
    batch = {"norm_listener_position": room.norm_receiver_position[::5].astype(np.float32)}
    direct = trainer.predict_amplitudes(batch).numpy()
    assert max_rel(np.asarray(jtrainer.predict_amplitudes(tree, batch)), direct) <= AMP_TOL
    record_property("amplitudes_max_rel", max_rel(got.numpy(), np.asarray(want)))
    assert max_rel(got.numpy(), np.asarray(want)) <= AMP_TOL


@pytest.mark.parametrize("directional", [True, False], ids=["directional", "omni"])
def test_port_serves_jax_checkpoints(tmp_path, room_path, directional, monkeypatch,
                                     record_property):
    """JAX trains (``fit_indexed`` at the 1.2 m split); the port's amplitudes
    from JAX's checkpoint directory, and the SRIRs ``get_ambisonic_rirs``
    serves from them on JAX's noise, against JAX's."""
    jax_room, room = _rooms(room_path, directional)
    jcfg, cfg = cs_configs(cs_raw_config(tmp_path / "jax", directional, epochs=2))
    jmodel, params, _ = cs_models(jcfg, cfg, jax_room)
    train_idx, valid_idx = jax_split(jax_room, CS_RESOLUTION_M)
    JaxSpatialSamplingTrainer(jmodel, jcfg, jax_room, grid_resolution_m=CS_RESOLUTION_M
                              ).fit_indexed(params, jax_arrays(jax_room), train_idx, valid_idx)
    rec = room.receiver_position[::7]
    want = jax_output_from_trained_model(jcfg, jax_room, rec, CS_RESOLUTION_M)
    got = get_output_from_trained_model(cfg, room, rec, CS_RESOLUTION_M, device="cpu")
    amp_err = max_rel(got.numpy(), np.asarray(want))

    seed = 9
    served = jax_ambisonic_rirs(rec, jax_room, use_trained_model=True, configs=[jcfg],
                                grid_resolution_m=CS_RESOLUTION_M, seed=seed)
    key = jax.random.PRNGKey(seed)

    def jax_draw(shape, generator, device):
        if len(shape) == 4:
            return torch.from_numpy(np.stack([_jax_noise(jax.random.fold_in(key, j), shape[1:])
                                              for j in range(shape[0])]))
        return torch.from_numpy(_jax_noise(key, shape))

    monkeypatch.setattr(cs_synthesis, "draw_noise", jax_draw)
    out = get_ambisonic_rirs(rec, room, use_trained_model=True, configs=[cfg],
                             grid_resolution_m=CS_RESOLUTION_M, seed=seed, device="cpu",
                             output_pkl_path=str(tmp_path / "served.pkl"))
    rir_err = rel_l2(out.rirs, served.rirs)
    record_property("amplitudes_max_rel", amp_err)
    record_property("served_rel_l2", rir_err)
    assert amp_err <= AMP_TOL
    assert out.rirs.shape == served.rirs.shape and rir_err <= RIR_TOL
    assert (tmp_path / "served.pkl").exists()


def test_omni_collapse_equals_jax_and_keeps_its_input(room_path):
    jax_room, room = cs_rooms(room_path)
    amps = room.amplitudes.copy()
    omni = collapse_amplitudes_to_omni(room)
    assert np.array_equal(omni.amplitudes, jax_collapse(jax_room).amplitudes)
    assert omni.sph_directions is None and omni.amplitudes.shape == (room.num_rec, 3)
    assert np.array_equal(room.amplitudes, amps) and room.sph_directions is not None
    assert collapse_amplitudes_to_omni(omni) is omni


def _yaml_config(tmp_path, room_path, **raw):
    path = tmp_path / "spatial.yml"
    cfg = {**cs_raw_config(tmp_path / "cli", True, epochs=1), "num_grid_spacing": 2,
           "room_dataset_path": str(room_path), **raw}
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_cli_trains_one_epoch_per_resolution_on_the_cpu(tmp_path, room_path):
    """The three-room parser's grid spacing is 0.3 m: two spacings sweep 0.6, 0.3 m."""
    cli_main(["-c", str(_yaml_config(tmp_path, room_path)), "--device", "cpu"])
    for res in (0.6, 0.3):
        assert (tmp_path / "cli" / f"grid_resolution={res:.1f}" / "checkpoints"
                / "model_e0.ckpt").exists()


@pytest.mark.parametrize("flag", [["--infer-dataset", "x.pkl"], ["--return-brirs"]])
def test_cli_sofa_and_brir_output_raise_naming_a13(tmp_path, room_path, flag):
    """All-band inference to SOFA files and BRIRs (ROADMAP A13, ported)
    raises on a bad request before it writes or trains anything: a missing
    dataset names its path, BRIRs without an HRIR set name ``--hrtf``."""
    args = ["-c", str(_yaml_config(tmp_path, room_path)), "--device", "cpu",
            "--output", str(tmp_path / "out" / "srirs")]
    if flag[0] == "--infer-dataset":
        with pytest.raises(FileNotFoundError, match="x.pkl"):
            cli_main(args + [flag[0], str(tmp_path / flag[1])])
    else:
        with pytest.raises(ValueError, match="--hrtf"):
            cli_main(args + ["--infer-dataset", str(room_path)] + flag)
    assert not (tmp_path / "out").exists() and not (tmp_path / "cli").exists()


@pytest.mark.parametrize("flag", [["--band-configs", "a.yml"], ["--grid-resolution", "0.6"],
                                  ["--output", "out"], ["--hrtf", "h.sofa"]])
def test_cli_refuses_the_unported_inference_options(tmp_path, room_path, flag):
    """The SOFA inference options (ROADMAP A13) are not accepted as silent no-ops."""
    with pytest.raises(SystemExit):
        cli_main(["-c", str(_yaml_config(tmp_path, room_path)), "--device", "cpu"] + flag)
    assert not (tmp_path / "cli").exists()


def test_spatial_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path, room_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid here")
    _, room = cs_rooms(room_path)
    _, cfg = cs_configs(cs_raw_config(tmp_path / "train", True, epochs=1))
    model = build_spatial_model(cfg, 3, 2, device="cpu")
    rec = room.receiver_position[:2]
    for call in (lambda: build_spatial_model(cfg, 3, 2),
                 lambda: SpatialSamplingTrainer(model, cfg, room),
                 lambda: run_training_spatial_sampling(cfg, room),
                 lambda: get_output_from_trained_model(cfg, room, rec),
                 lambda: get_ambisonic_rirs(rec, room),
                 lambda: cli_main(["-c", str(_yaml_config(tmp_path, room_path))])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "train").exists() and not (tmp_path / "cli").exists()
