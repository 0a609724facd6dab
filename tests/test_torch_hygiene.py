"""Hygiene of the PyTorch port: imports, devices, lint, the chip smoke script."""

from pathlib import Path
import subprocess
import sys

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in (ROOT / "diffgfdn_torch").rglob("*.py")
)


def test_port_imports_no_jax():
    """Every module of diffgfdn_torch, and chip_smoke.py, loads without JAX."""
    code = (
        "import sys, importlib\n"
        f"for name in {PORT_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'diffgfdn_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert len(PORT_MODULES) >= 25


def test_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid here")
    from diffgfdn_torch.config.schema import DiffGFDNConfig
    from diffgfdn_torch.data import synthetic_three_room_dataset
    from diffgfdn_torch.inference import InferDiffGFDN
    from diffgfdn_torch.training import build_gfdn_model

    cfg = DiffGFDNConfig.from_dict(dict(sample_rate=8000.0, num_delay_lines=6,
                                        delay_range_ms=[20.0, 45.0]))
    room = synthetic_three_room_dataset(tmp_path, nfft=512, num_rec_per_room=1,
                                        rir_len_s=0.05)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferDiffGFDN(cfg, room)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_gfdn_model(cfg, room.common_decay_times)


def test_port_is_lint_clean():
    sys.path.insert(0, str(ROOT / "tools"))
    import lint

    assert lint.main([str(ROOT / "diffgfdn_torch"), str(ROOT / "chip_smoke.py")]) == 0


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    here = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert here.returncode != 0 and '"ok"' not in here.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_chip_smoke_device_busy_time_is_the_union_of_device_work():
    """Overlapping device events count once, events are clipped to the
    window, and CPU events and user annotations are not device work."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Interval

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    def event(start, end, device=DeviceType.CUDA, annotation=False):
        return SimpleNamespace(time_range=Interval(start, end), device_type=device,
                               is_user_annotation=annotation)

    events = [event(5, 10), event(8, 12), event(20, 25), event(-5, 2), event(95, 130),
              event(30, 31), event(0, 100, annotation=True),
              event(40, 60, device=DeviceType.CPU)]
    assert chip_smoke.device_busy_us(events, Interval(0, 100)) == 20.0


def test_entry_point_device_turns_tf32_off():
    from diffgfdn_torch.utils.device import resolve_device

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        assert resolve_device("cpu") == torch.device("cpu")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        with pytest.raises(ValueError, match="unsupported device"):
            resolve_device("meta")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_plain_versions_is_scoped():
    from diffgfdn_torch.kernels import dispatch

    cpu = torch.zeros(1)
    assert not dispatch.runs_kernel(cpu)
    with dispatch.plain_versions():
        assert dispatch._plain_on_card
    assert not dispatch._plain_on_card
    with pytest.raises(ValueError, match="different devices"):
        dispatch.runs_kernel(cpu, torch.zeros(1, device="meta"))
