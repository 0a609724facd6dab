"""The port's end-to-end walkthrough (``diffgfdn_torch/examples/walkthrough.py``)
on the CPU, and its datasets against the JAX package's walkthrough.

``main(["--out-dir", tmp, "--device", "cpu"])`` runs all five steps (about
15-20 s in one process) and must leave what ``tests/test_walkthrough.py``
asserts of the JAX walkthrough: the inferred RIR, the binaural render and
the animation written, the broadband subband RIRs finite. Step 1's pickles
must equal those of JAX's ``step1_dataset`` (the same keys and shapes,
arrays within 1e-6), and ``config.yml`` must read back as the config the
walkthrough trained.
"""

import importlib.util
from pathlib import Path
import pickle

import numpy as np

from torch_port_helpers import one_torch_thread  # noqa: F401 (a module fixture)

ROOT = Path(__file__).resolve().parents[1]


def _jax_walkthrough():
    spec = importlib.util.spec_from_file_location("walkthrough_jax_study",
                                                  ROOT / "examples" / "walkthrough.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_same(a, b, path=""):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.max(np.abs(a - b), initial=0.0) <= 1e-6, path
    else:
        assert a == b, path


def test_walkthrough_end_to_end_on_the_cpu(tmp_path):
    from diffgfdn_torch.config.loader import load_and_validate_config
    from diffgfdn_torch.config.schema import DiffGFDNConfig
    from diffgfdn_torch.examples import walkthrough

    walkthrough.main(["--out-dir", str(tmp_path), "--device", "cpu"])
    assert (tmp_path / "inferred_rir.wav").exists()
    assert (tmp_path / "binaural_walkthrough.wav").exists()
    assert (tmp_path / "trajectory.gif").exists()
    rirs = np.load(tmp_path / "subband" / "broadband_rirs.npy")
    assert np.isfinite(rirs).all()
    trained = DiffGFDNConfig.from_dict(walkthrough.walkthrough_config(tmp_path,
                                                                      tmp_path / "srirs.pkl"))
    assert load_and_validate_config(tmp_path / "config.yml") == trained


def test_step1_datasets_equal_jax(tmp_path):
    from diffgfdn_torch.examples import walkthrough

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_paths = _jax_walkthrough().step1_dataset(tmp_path / "jax")
    port_paths = walkthrough.step1_dataset(tmp_path / "port")
    for jp, pp in zip(jax_paths, port_paths):
        assert jp.name == pp.name
        with open(jp, "rb") as f:
            want = pickle.load(f)
        with open(pp, "rb") as f:
            got = pickle.load(f)
        _assert_same(got, want, pp.name)
