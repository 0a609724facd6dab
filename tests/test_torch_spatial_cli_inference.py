"""The spatial CLI's all-band inference on a tiny checkpoint trained on the
CPU: ``--infer-dataset`` writes the SRIRs that ``get_ambisonic_rirs`` serves
for the same seed, bit for bit, in a SOFA file laid out as the JAX CLI's;
``--return-brirs --hrtf`` pickles the BRIRs that ``convert_srir_to_brir``
makes of them, keyed and shaped as the JAX CLI's pickle.
"""

import pickle

import h5py
import numpy as np
import pytest
import torch
import yaml

from diffgfdn_torch.cli.run_spatial_sampling import main as cli_main
from diffgfdn_torch.data import SpatialThreeRoomDataset
from diffgfdn_torch.inference import convert_srir_to_brir, get_ambisonic_rirs, HRIRSOFAReader
from diffgfdn_torch.training import run_training_spatial_sampling
from diffgfdn_tpu.cli.run_spatial_sampling import (
    run_inference_on_all_bands as jax_run_inference_on_all_bands,
)
from test_torch_sofa import _contents, _write_hrir_file
from torch_port_helpers import cs_configs, cs_raw_config, cs_room_path, CS_RESOLUTION_M


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(dataset path, YAML config path, port config) of a 1-epoch checkpoint."""
    tmp = tmp_path_factory.mktemp("cli_inference")
    path = cs_room_path(tmp)
    raw = {**cs_raw_config(tmp / "train", True, epochs=1), "room_dataset_path": str(path)}
    _, cfg = cs_configs(raw)
    run_training_spatial_sampling(cfg, SpatialThreeRoomDataset(path),
                                  grid_resolutions=[CS_RESOLUTION_M], device="cpu")
    yml = tmp / "spatial.yml"
    yml.write_text(yaml.safe_dump(raw))
    return path, yml, cfg


def _infer(trained, out, *extra):
    path, yml, _ = trained
    return cli_main(["-c", str(yml), "--infer-dataset", str(path), "--grid-resolution",
                     str(CS_RESOLUTION_M), "--output", str(out), "--device", "cpu", *extra])


def test_infer_dataset_writes_the_served_srirs_as_sofa(tmp_path, trained):
    path, yml, cfg = trained
    written = _infer(trained, tmp_path / "port" / "srirs_est")
    assert written == tmp_path / "port" / "srirs_est.sofa"
    room = SpatialThreeRoomDataset(path)
    served = get_ambisonic_rirs(room.receiver_position, room, use_trained_model=True,
                                configs=[cfg], grid_resolution_m=CS_RESOLUTION_M, device="cpu")
    with h5py.File(written, "r") as f:
        assert np.array_equal(f["Data.IR"][()], np.asarray(served.rirs, np.float64))
        assert np.array_equal(f["ListenerPosition"][()], room.receiver_position)
        assert float(f["Data.SamplingRate"][0]) == room.sample_rate

    # the JAX CLI's file of the same checkpoint: the same layout and metadata
    # (its SRIRs are drawn from JAX's noise)
    jax_out = tmp_path / "jax" / "srirs_est"
    jax_out.parent.mkdir()
    jax_run_inference_on_all_bands([str(yml)], str(path), CS_RESOLUTION_M, str(jax_out))
    root, data = _contents(written)
    root_ref, data_ref = _contents(jax_out.with_suffix(".sofa"))
    assert root.keys() == root_ref.keys() and list(data) == list(data_ref)
    for name, (value, attrs, scales, dtype, _) in data.items():
        value_ref, attrs_ref, scales_ref, dtype_ref, _ = data_ref[name]
        assert dtype == dtype_ref and scales == scales_ref and attrs.keys() == attrs_ref.keys()
        if value is not None and name != "Data.IR":
            assert np.array_equal(value, value_ref), name
    assert data["Data.IR"][0].shape == data_ref["Data.IR"][0].shape


def test_return_brirs_pickles_the_converted_srirs(tmp_path, trained):
    path, yml, cfg = trained
    hrtf = _write_hrir_file(tmp_path / "hrir.sofa")  # 8 kHz, the dataset's rate
    written = _infer(trained, tmp_path / "port" / "brirs", "--return-brirs", "--hrtf", str(hrtf))
    assert written == tmp_path / "port" / "brirs.pkl"
    with open(written, "rb") as f:
        got = pickle.load(f)
    room = SpatialThreeRoomDataset(path)
    served = get_ambisonic_rirs(room.receiver_position, room, use_trained_model=True,
                                configs=[cfg], grid_resolution_m=CS_RESOLUTION_M, device="cpu")
    want = convert_srir_to_brir(served.rirs, HRIRSOFAReader(hrtf), np.array([[0.0, 0.0]]),
                                device="cpu")
    assert np.array_equal(got["brirs"], want)
    assert np.array_equal(got["positions"], room.receiver_position)

    jax_out = tmp_path / "jax" / "brirs"
    jax_out.parent.mkdir()
    jax_run_inference_on_all_bands([str(yml)], str(path), CS_RESOLUTION_M, str(jax_out),
                                   return_brirs=True, hrtf_path=str(hrtf))
    with open(jax_out.with_suffix(".pkl"), "rb") as f:
        ref = pickle.load(f)
    assert got.keys() == ref.keys()
    assert got["brirs"].shape == ref["brirs"].shape and got["brirs"].dtype == ref["brirs"].dtype
    assert np.array_equal(got["positions"], ref["positions"])


@pytest.mark.parametrize("flag", [["--return-brirs"], ["--return-brirs", "--hrtf", "h.sofa"]])
def test_brir_flags_without_infer_dataset_are_refused(tmp_path, trained, flag):
    """JAX's CLI would train and ignore them; the port's parser refuses them,
    as it refuses every inference-only flag, before anything is trained."""
    _, yml, _ = trained
    with pytest.raises(SystemExit):
        cli_main(["-c", str(yml), "--device", "cpu", "--output", str(tmp_path / "out")] + flag)
    assert not (tmp_path / "out").exists()


def test_inference_defaults_to_cuda_and_raises_without_a_card(tmp_path, trained):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid here")
    path, yml, _ = trained
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["-c", str(yml), "--infer-dataset", str(path),
                  "--output", str(tmp_path / "out" / "srirs")])
    with pytest.raises(ValueError, match="--hrtf"):
        _infer(trained, tmp_path / "out" / "brirs", "--return-brirs")
    assert not (tmp_path / "out").exists()
