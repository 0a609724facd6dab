"""Fixtures of the benchmark's own tests: cells run on the CPU at a small size."""

import copy
import json
from pathlib import Path
import sys

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL_NFFT = 4096
SMALL_RECEIVERS = 120


def small_overrides(config_name: str, root: Path = ROOT) -> dict:
    """A configuration file's preset and grid at a size the CPU holds: nfft
    4096, 120 receivers of 0.1 s (every width as published)."""
    conf = json.loads((root / "benchmark" / "configs" / f"{config_name}.json").read_text())
    preset = copy.deepcopy(conf["preset"])
    preset["trainer_config"]["num_freq_bins"] = SMALL_NFFT
    data = dict(conf["data"], receivers=SMALL_RECEIVERS, rir_seconds=0.1)
    return {"preset": preset, "data": data}


@pytest.fixture
def card():
    """Skips the test without a CUDA card (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    """Two intra-op threads a worker: the tests run in several processes."""
    import torch

    torch.set_num_threads(2)
