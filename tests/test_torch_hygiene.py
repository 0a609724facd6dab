"""Hygiene of the PyTorch port: imports, devices, lint, the chip smoke script."""

import os
from pathlib import Path
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in (ROOT / "diffgfdn_torch").rglob("*.py")
)


# the checkpoint-inspection, baseline and dataset CLIs and the modules they
# brought in: the import check above must load each of them without JAX
TOOL_MODULES = ("diffgfdn_torch.cli.compare_baselines", "diffgfdn_torch.cli.convert_dataset",
                "diffgfdn_torch.cli.inspect_checkpoint", "diffgfdn_torch.data.naf",
                "diffgfdn_torch.low_rank", "diffgfdn_torch.utils.cio",
                "diffgfdn_torch.utils.flops", "diffgfdn_torch.utils.plot",
                "diffgfdn_torch.utils.profiling")


def test_port_imports_no_jax():
    """Every module of diffgfdn_torch, and chip_smoke.py, loads without JAX
    and without matplotlib (the card's image lacks it: ``utils/plot.py``
    imports it when it draws)."""
    code = (
        "import sys, importlib\n"
        f"for name in {PORT_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'diffgfdn_tpu', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert len(PORT_MODULES) >= 78
    assert set(TOOL_MODULES) <= set(PORT_MODULES)


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


def test_training_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid here")
    from diffgfdn_torch.cli.run_model import main as cli_main
    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.data import synthetic_three_room_dataset
    from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer
    from diffgfdn_torch.training import run_training_var_receiver_pos

    cfg = preset_config("three_room_example", sample_rate=8000.0, num_delay_lines=6)
    cfg.trainer_config.train_dir = str(tmp_path / "train")
    room = synthetic_three_room_dataset(tmp_path, nfft=512, num_rec_per_room=1,
                                        rir_len_s=0.05)
    model = build_gfdn_model(cfg, room.common_decay_times, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GFDNTrainer(model, cfg.trainer_config, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training_var_receiver_pos(cfg, room)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["-c", "three_room_example"])
    assert not (tmp_path / "train").exists()


def test_single_position_and_colorless_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid here")
    from diffgfdn_torch.cli.run_model import main as cli_main
    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.data import RIRData
    from diffgfdn_torch.training import (
        build_colorless_fdn,
        ColorlessFDNTrainer,
        run_training_colorless_fdn,
        run_training_single_pos,
    )

    cfg = preset_config("single_rir_two_stage_colorless_proto", sample_rate=8000.0)
    cfg.trainer_config.train_dir = str(tmp_path / "train")
    rir = RIRData(rir=np.zeros(800, np.float32), sample_rate=8000.0,
                  common_decay_times=np.array([0.5, 0.5]), nfft=512)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training_single_pos(cfg, rir)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training_colorless_fdn(cfg, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_colorless_fdn(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ColorlessFDNTrainer(build_colorless_fdn(cfg, 0, device="cpu"),
                            cfg.colorless_fdn_config, str(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["-c", "single_rir_example"])  # ir_path: the single-position fit
    assert not (tmp_path / "train").exists()


# the upload of the host-batch entry points: the import check above must load it
HOST_BATCH_MODULES = ("diffgfdn_torch.training.host_batches",)


def test_host_batch_entry_points_default_to_cuda(tmp_path):
    """``GFDNTrainer.fit`` and ``BandParallelTrainer.fit`` run on their
    trainer's device: without a card the default raises before any step, and
    ``device="cpu"`` trains one epoch of host batches."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid here")
    from diffgfdn_torch.config import preset_config
    from diffgfdn_torch.data import (
        arrays_from_room_dataset,
        iterate_batches,
        synthetic_three_room_dataset,
    )
    from diffgfdn_torch.parallel import BandParallelTrainer
    from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer

    assert set(HOST_BATCH_MODULES) <= set(PORT_MODULES)
    cfg = preset_config("three_room_example", sample_rate=8000.0, num_delay_lines=6)
    tc = cfg.trainer_config
    tc.train_dir, tc.max_epochs, tc.batch_size, tc.num_freq_bins = str(tmp_path / "t"), 1, 2, 512
    room = synthetic_three_room_dataset(tmp_path, nfft=512, num_rec_per_room=1, rir_len_s=0.05)
    model = build_gfdn_model(cfg, room.common_decay_times, device="cpu")
    resp = np.ones((1, 257), np.complex64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GFDNTrainer(model, tc, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BandParallelTrainer([model], tc, resp, 1)
    arrays = arrays_from_room_dataset(room)

    def batches(epoch):
        return iterate_batches(arrays, np.arange(3), 2, seed=epoch)

    trainer = GFDNTrainer(model, tc, 1, common_decay_times=room.common_decay_times,
                          device="cpu")
    trainer.fit(batches, lambda: iterate_batches(arrays, np.arange(1), 2, drop_last=False))
    assert len(trainer.train_loss) == 1 and np.isfinite(trainer.train_loss[0])
    band = BandParallelTrainer([model], tc, resp, 1, device="cpu")
    assert band.fit(batches).shape == (1, 1)


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


STEP_GRAPH_USERS = ("diffgfdn_torch/training/trainer.py", "diffgfdn_torch/training/scan.py",
                    "diffgfdn_torch/training/spatial_trainer.py",
                    "diffgfdn_torch/training/colorless_trainer.py",
                    "diffgfdn_torch/parallel/band_parallel.py",
                    "diffgfdn_torch/parallel/freq_parallel.py",
                    "diffgfdn_torch/parallel/collectives.py")


def test_step_graphs_import_no_jax():
    """training/scan.py names no JAX module, and importing it loads none."""
    import ast

    tree = ast.parse((ROOT / "diffgfdn_torch/training/scan.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert names and not [m for m in names
                          if m.split(".")[0] in ("jax", "jaxlib", "flax", "diffgfdn_tpu")]
    code = ("import sys, diffgfdn_torch.training.scan\n"
            "print([m for m in sys.modules if m.split('.')[0] in ('jax', 'diffgfdn_tpu')])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_no_try_around_a_capture_falls_back_to_eager():
    """No exception handler in scan.py (its one ``try`` has a ``finally``
    only), and none in a trainer around a graphed step: a failed capture
    raises, it never continues eagerly."""
    import ast

    graphed = {"run_step", "graphs", "graph", "_capture", "replay"}
    for rel in STEP_GRAPH_USERS:
        tree = ast.parse((ROOT / rel).read_text())
        tries = [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
        if rel.endswith("scan.py"):
            assert tries and not [t for t in tries if t.handlers or t.orelse], rel
        for t in tries:
            calls = [c.func for stmt in t.body for c in ast.walk(stmt) if isinstance(c, ast.Call)]
            names = {f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
                     for f in calls}
            assert not (t.handlers and names & graphed), (rel, t.lineno, names & graphed)


RENDERING_MODULES = ("diffgfdn_torch.inference.rendering", "diffgfdn_torch.inference.sofa",
                     "diffgfdn_torch.native", "diffgfdn_torch.native.tdfdn")


def test_rendering_modules_import_no_jax_and_no_h5py():
    """The rendering, SOFA and native modules are among those the import
    check loads without JAX, and importing them loads neither JAX nor h5py
    (the SOFA file I/O imports it when it reads or writes; the card may lack it)."""
    assert set(RENDERING_MODULES) <= set(PORT_MODULES)
    code = ("import sys, importlib\n"
            f"for name in {RENDERING_MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "print([m for m in sys.modules if m.split('.')[0] in ('jax', 'diffgfdn_tpu', 'h5py')])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_rendering_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    """convert_srir_to_brir, the binaural render (backend="device", its
    default) and the multi render; the streaming host loop needs no card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid here")
    from diffgfdn_torch.data import generate_spatial_three_room_pickle, SpatialThreeRoomDataset
    from diffgfdn_torch.inference import (
        BinauralDynamicRendering,
        convert_srir_to_brir,
        HRIRSOFAReader,
    )
    from diffgfdn_torch.ops.sph import t_design_directions

    dirs = np.rad2deg(t_design_directions(5))
    views = np.stack([dirs[0], 90.0 - dirs[1], np.ones(12)], axis=-1)
    reader = HRIRSOFAReader.from_arrays(np.random.RandomState(0).randn(12, 2, 16), 8000.0, views)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert_srir_to_brir(np.zeros((1, 9, 64)), reader, np.zeros((1, 2)))
    room = SpatialThreeRoomDataset(generate_spatial_three_room_pickle(
        tmp_path / "s.pkl", grid_spacing_m=1.2, rir_len_s=0.1, decay_times=(0.03, 0.05, 0.04)))
    rend = BinauralDynamicRendering(room, room.receiver_position[:3], np.zeros((3, 2)),
                                    np.ones(800, np.float32),
                                    reader.get_spherical_harmonic_representation(2),
                                    update_ms=50, use_whole_rir=True)
    assert np.isfinite(rend.stream_host()).all()
    for backend in ((), ("device",)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rend.binaural_filter_overlap_add(*backend)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rend.binaural_filter_overlap_add_multi(rend.extended_stimulus[None])


def test_tool_clis_default_to_cuda_and_raise_without_a_card(tmp_path, monkeypatch):
    """inspect_checkpoint, compare_baselines and convert_dataset, without
    ``--device cpu``, raise the device error before they read or write a file."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid here")
    from diffgfdn_torch.cli import compare_baselines, convert_dataset, inspect_checkpoint

    monkeypatch.chdir(tmp_path)
    calls = [
        (inspect_checkpoint.main, ["-c", "three_room_example", "--out", "insp"]),
        (inspect_checkpoint.main, ["-c", "x", "--compare-runs", "a", "b", "--out", "c.png"]),
        (compare_baselines.main, ["--dataset", "missing.pkl", "--out", "cmp",
                                  "--grid-resolution", "1.2"]),
        (convert_dataset.main, ["missing.mat", "out/srirs.pkl", "--ambi"]),
        (convert_dataset.main, ["missing.mat", "out/srirs.pkl", "--per-band-dir", "bands"]),
    ]
    for main, argv in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    assert not list(tmp_path.iterdir())


PARALLEL_MODULES = ("diffgfdn_torch.parallel.mesh", "diffgfdn_torch.parallel.collectives",
                    "diffgfdn_torch.parallel.freq_parallel", "diffgfdn_torch.ops.mxu_fft")


def test_sharded_paths_and_rank_workers_import_no_jax():
    """The mesh, the collectives, the frequency-sharded step and the matmul
    irfft are among the modules the import check loads; the tests' rank
    functions (``tests/torch_dist_workers.py``), with every port module they
    reach, load no JAX either: the spawned ranks never import it."""
    assert set(PARALLEL_MODULES) <= set(PORT_MODULES)
    code = ("import sys, importlib\n"
            "import torch_dist_workers\n"
            "for name in torch_dist_workers.SPAWN['preload']:\n"
            "    importlib.import_module(name)\n"
            f"for name in {PARALLEL_MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "print([m for m in sys.modules if m.split('.')[0] in ('jax', 'diffgfdn_tpu')])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT / "tests", capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_no_entry_point_chooses_gloo_or_the_cpu_unless_asked(monkeypatch):
    """``spawn`` and ``init_process_group_from_env`` default to NCCL; the
    CLIs join a torchrun group over NCCL on their card, and over gloo only
    with ``--device cpu``."""
    import inspect

    from diffgfdn_torch.cli import run_model, run_subband_training
    from diffgfdn_torch.parallel import mesh

    assert inspect.signature(mesh.spawn).parameters["backend"].default == "nccl"
    assert inspect.signature(mesh.init_process_group_from_env).parameters[
        "backend"].default == "nccl"
    chosen = []

    def record(backend="nccl"):
        chosen.append(backend)
        raise SystemExit(0)

    monkeypatch.setattr(mesh, "init_process_group_from_env", record)
    for main, argv in ((run_model.main, ["-c", "single_rir_example"]),
                       (run_subband_training.main, ["--dataset", "x.pkl", "--band-parallel"])):
        for device, backend in (("cpu", "gloo"), ("cuda", "nccl")):
            monkeypatch.setattr("diffgfdn_torch.utils.device.resolve_device",
                                lambda d, device=device: torch.device(device))
            with pytest.raises(SystemExit):
                main(argv + ["--device", device])
            assert chosen[-1] == backend
    assert len(chosen) == 4


# the README's walkthrough and the notebook studies (diffgfdn_torch/examples/)
EXAMPLE_MODULES = tuple(f"diffgfdn_torch.examples.{name}" for name in (
    "check_edr_loss", "colorless_output_study", "compare_flops", "cs_amplitude_study",
    "fadein_study", "fdn_colouration", "loss_surface", "low_rank_study", "room_geometry_study",
    "walkthrough"))


def test_examples_import_no_jax_and_no_matplotlib():
    """The walkthrough and the studies are among the modules the import check
    loads, and importing them loads neither JAX, the JAX package nor
    matplotlib (their drawing functions import it when they draw)."""
    assert set(EXAMPLE_MODULES) <= set(PORT_MODULES)
    assert len([m for m in PORT_MODULES if m.startswith("diffgfdn_torch.examples.")]) == 10
    code = ("import sys, importlib\n"
            f"for name in {EXAMPLE_MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "print([m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'flax', 'diffgfdn_tpu', 'matplotlib')])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_examples_default_to_cuda_and_raise_without_a_card(tmp_path):
    """Every study's entry point that computes on a device, and its ``main``
    without ``--device cpu``, raises the device error; the walkthrough
    raises before it writes its output directory."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid here")
    from diffgfdn_torch.examples import (check_edr_loss, colorless_output_study, fadein_study,
                                         fdn_colouration, loss_surface, low_rank_study,
                                         room_geometry_study, walkthrough)

    calls = [
        lambda: loss_surface.compute_surfaces(nfft=64, grid=3),
        lambda: loss_surface.main(["--out", str(tmp_path / "a.png")]),
        lambda: fdn_colouration.band_responses(nfft=64),
        lambda: fdn_colouration.main(["--out", str(tmp_path / "b.png")]),
        lambda: fadein_study.synthesize_cases(dur_s=0.01),
        lambda: fadein_study.main(["--out", str(tmp_path / "c.png")]),
        lambda: low_rank_study.low_rank_render(),
        lambda: low_rank_study.run(str(tmp_path / "d")),
        lambda: colorless_output_study.train_groups(str(tmp_path / "e"), epochs=1),
        lambda: colorless_output_study.main(["--out", str(tmp_path / "e")]),
        lambda: check_edr_loss.make_rir(),
        lambda: check_edr_loss.stft_edr(np.zeros(64)),
        lambda: check_edr_loss.run(str(tmp_path / "f")),
        lambda: room_geometry_study.geometry_checks(str(tmp_path / "g")),
        lambda: room_geometry_study.main(["--out", str(tmp_path / "g")]),
        lambda: walkthrough.step2_train(tmp_path, tmp_path / "srirs.pkl"),
        lambda: walkthrough.step5_render(tmp_path, tmp_path / "spatial.pkl"),
        lambda: walkthrough.main(["--out-dir", str(tmp_path / "walk")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "walk").exists()
    assert not list(tmp_path.glob("*.png"))
