"""The step graphs of ``diffgfdn_torch/training/scan.py`` on the CPU.

On CPU tensors a trainer's ``scan_epochs`` path runs the same step closure
as ``scan_epochs = False``, over static input buffers that it refills before
each step (the buffers a CUDA graph reads on the card). Here:

* each of the six trainers, run through its entry point for 2-3 epochs from
  one seed, gives bit-identical per-epoch losses and final parameters with
  and without ``scan_epochs`` (at toy sizes: 8 kHz, nfft 512, 6 delay
  lines, 1 x 8 MLPs; the EDC mask and a validation remainder where the
  trainer has them);
* one step of each trainer runs with every host read a capture cannot take
  (``Tensor.item`` / ``tolist`` / ``cpu`` / ``numpy``, ``bool`` / ``int`` /
  ``float`` of a tensor) and every copy of host data to the device
  (``torch.tensor``, ``torch.as_tensor`` of non-tensor data,
  ``torch.from_numpy``) made to raise;
* the fused Adam with tensor learning rates is held to optax (1e-6) across
  the step decay's boundary and a resume from the optimizer-state sidecar,
  its learning rates 0-d tensors on the parameters' device throughout;
* the replay bookkeeping adds the launch counts seen at capture once per
  replay (stand-in counters);
* one more step of each trainer records the program's spans: the step
  graph's refill, or the eager closure (``tests/test_torch_profiling.py``
  holds the recorder itself).
"""

import contextlib
import copy

import jax
import numpy as np
import optax
import pytest
import torch

from diffgfdn_torch.cli import run_subband_training as port_cli
from diffgfdn_torch.config import SpatialSamplingConfig
from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.data import (
    arrays_from_room_dataset,
    generate_spatial_three_room_pickle,
    RIRData,
    SpatialThreeRoomDataset,
    synthetic_three_room_dataset,
    train_valid_split,
    write_wav,
)
from diffgfdn_torch.training import (
    build_colorless_fdn,
    build_gfdn_model,
    ColorlessFDNTrainer,
    load_opt_state,
    make_optimizer,
    run_training_anisotropic_decay_var_receiver_pos,
    run_training_single_pos,
    run_training_spatial_sampling,
    run_training_var_receiver_pos,
    save_opt_state,
)
from diffgfdn_torch.training.optim import (
    load_optimizer_state,
    param_labels,
    step_decay_factor,
)
from diffgfdn_torch.training.scan import GraphedSteps, ReplayCounts, StepGraphs
from diffgfdn_torch.utils import profiling
from diffgfdn_torch.utils.params import flax_path, load_jax_params
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.training import optim as jax_optim
from torch_port_helpers import BANDS, jax_model_and_params, raw_config, rooms, SUBBAND_MLP

FS = 8000.0
NFFT = 512
EPOCHS = 2
UPDATE_TOL = 1e-6


def _raw(tmp, **trainer) -> dict:
    """A narrow grid config: 6 lines in 3 groups, scalar heads (normalized
    before every step), scalar absorption, a 1 x 8 MLP."""
    return dict(
        seed=3, num_groups=3, sample_rate=FS, num_delay_lines=6, delay_range_ms=[10.0, 25.0],
        trainer_config={**dict(batch_size=4, num_freq_bins=NFFT, max_epochs=EPOCHS,
                               train_dir=str(tmp / "train"), ir_dir=str(tmp / "audio")),
                        **trainer},
        output_filter_config=dict(use_svfs=False, num_hidden_layers=1,
                                  num_neurons_per_layer=8, num_fourier_features=2),
        decay_filter_config=dict(use_absorption_filters=False),
        colorless_fdn_config=dict(use_colorless_prototype=False),
    )


def _state(module_or_params) -> dict:
    items = (module_or_params.items() if isinstance(module_or_params, dict)
             else module_or_params.named_parameters())
    return {k: v.detach().clone() for k, v in items}


def _grid(tmp):
    """GFDNTrainer: the EDC mask, the colorless loss and the per-step
    normalization; 9 train receivers (3 padded steps), 9 valid (2 full
    batches and a remainder of 1)."""
    room = synthetic_three_room_dataset(tmp, nfft=NFFT, fs=FS, num_rec_per_room=6,
                                        rir_len_s=0.1, decay_times=(0.05, 0.08, 0.06))
    cfg = DiffGFDNConfig.from_dict(_raw(tmp, train_valid_split=0.5, use_edc_mask=True,
                                        use_colorless_loss=True))
    trainer, model = run_training_var_receiver_pos(cfg, room, device="cpu")
    losses = (trainer.individual_train_loss, trainer.individual_valid_loss)
    idx = torch.arange(4)
    return losses, _state(model), trainer, lambda: (trainer.fit_step(idx),
                                                    trainer.valid_step(idx, 4))


def _directional(tmp):
    """DirectionalGFDNTrainer at ambi order 1 (12 lines in groups of 4) on a
    1.2 m grid of 44 receivers at 4 kHz, the 2.4 m split, the EDC mask on."""
    path = generate_spatial_three_room_pickle(tmp / "spatial.pkl", fs=4000.0,
                                              grid_spacing_m=1.2, rir_len_s=0.15,
                                              decay_times=(0.04, 0.06, 0.05))
    room = SpatialThreeRoomDataset(path)
    raw = _raw(tmp, batch_size=8, grid_resolution_m=2.4, use_edc_mask=True,
               use_colorless_loss=True, use_asym_spectral_loss=True)
    raw.update(sample_rate=4000.0, ambi_order=1)
    del raw["num_delay_lines"]
    raw["output_filter_config"].update(use_skip_connections=True,
                                       beamformer_type="max_directivity")
    cfg = DiffGFDNConfig.from_dict(raw)
    trainer, model = run_training_anisotropic_decay_var_receiver_pos(cfg, room, device="cpu")
    idx = torch.arange(8)
    return ((trainer.individual_train_loss, trainer.individual_valid_loss), _state(model),
            trainer, lambda: (trainer.fit_step(idx), trainer.valid_step(idx, 8)))


def _single_pos(tmp):
    """SinglePosGFDNTrainer: SVF output heads, 3 epochs of one full-spectrum step."""
    rng = np.random.RandomState(5)
    t = np.arange(int(0.06 * FS)) / FS
    rir = (rng.randn(t.size) * np.exp(-6.9 * t / 0.05)).astype(np.float32)
    rir[0] = 1.0
    write_wav(tmp / "ir_(1.00, 2.00, 1.50).wav", rir, FS)
    raw = _raw(tmp, batch_size=1, max_epochs=3, lr=1e-2, io_lr=0.05, use_edc_mask=True)
    raw["ir_path"] = str(tmp / "ir_(1.00, 2.00, 1.50).wav")
    raw["output_filter_config"] = dict(use_svfs=True)
    cfg = DiffGFDNConfig.from_dict(raw)
    data = RIRData.from_wav(cfg.ir_path, common_decay_times=np.array([0.05] * 3), nfft=NFFT)
    trainer, model = run_training_single_pos(cfg, data, device="cpu")
    return (trainer.individual_train_loss,), _state(model), trainer, trainer.fit_step


def _colorless(tmp):
    """ColorlessFDNTrainer on 256 bins: steps of 32, a validation batch of 32."""
    raw = _raw(tmp)
    raw["colorless_fdn_config"] = dict(use_colorless_prototype=True, max_epochs=EPOCHS,
                                       batch_size=32, lr=1e-2)
    cfg = DiffGFDNConfig.from_dict(raw)
    model = build_colorless_fdn(cfg, 0, device="cpu")
    trainer = ColorlessFDNTrainer(model, cfg.colorless_fdn_config, str(tmp / "colorless"),
                                  device="cpu")
    trainer.fit(256, seed=2)
    idx = torch.arange(32)
    return ((trainer.train_loss, trainer.valid_loss), _state(model), trainer,
            lambda: trainer.fit_step(idx))


def _band_parallel(tmp, monkeypatch):
    """BandParallelTrainer: two bands of one architecture at nfft 512, the
    EDC mask on, band 1 stopped in the host-read step."""
    monkeypatch.setattr(port_cli, "BAND_MLP_PARAMS", dict(SUBBAND_MLP))
    room = synthetic_three_room_dataset(tmp, nfft=NFFT, fs=FS, num_rec_per_room=6,
                                        rir_len_s=0.1, decay_times=(0.05, 0.08, 0.06))
    cdt = np.stack([np.array((0.05, 0.08, 0.06))] * len(BANDS)) * np.linspace(
        1.2, 0.8, len(BANDS))[:, None]
    room.common_decay_times, room.band_centre_hz = cdt, BANDS
    cfgs = [port_cli.create_config(f, str(tmp / "srirs.pkl"), str(tmp / "bands"), NFFT,
                                   sample_rate=FS, batch_size=4, max_epochs=EPOCHS)
            for f in (500.0, 1000.0)]
    for cfg in cfgs:
        cfg.trainer_config.use_edc_mask = True
    arrays = arrays_from_room_dataset(room)
    train_idx, valid_idx = train_valid_split(np.arange(arrays.num_items), 0.5, seed=cfgs[0].seed)
    trainer = port_cli.band_parallel_trainer(cfgs, room, arrays, train_idx, "cpu")
    trainer.fit_indexed(arrays, train_idx, valid_idx, seed=cfgs[0].seed)
    idx = torch.arange(4)
    active = np.array([1.0, 0.0], np.float32)
    trainer.stopped_bands(active)  # its one copy to the device, as an epoch's first step makes
    return ((trainer.train_loss, trainer.valid_loss), _state(trainer.params), trainer,
            lambda: trainer.step(idx, active))


def _spatial(tmp):
    """SpatialSamplingTrainer: the directional MLP at the 1.2 m resolution of
    a 0.6 m grid (a validation remainder), 2 epochs."""
    path = generate_spatial_three_room_pickle(tmp / "cs.pkl", grid_spacing_m=0.6,
                                              rir_len_s=0.2, decay_times=(0.05, 0.09, 0.07))
    room = SpatialThreeRoomDataset(path)
    cfg = SpatialSamplingConfig.from_dict(dict(
        batch_size=16, seed=0, max_epochs=EPOCHS, lr=5e-3, train_dir=str(tmp / "cs"),
        use_directional_rirs=True,
        dnn_config=dict(mlp_config=dict(num_neurons_per_layer=8, num_hidden_layers=1),
                        num_fourier_features=2)))
    ((_, (trainer, model)),) = run_training_spatial_sampling(cfg, room, grid_resolutions=[1.2],
                                                             device="cpu").items()
    idx = torch.arange(16)
    return ((trainer.train_loss, trainer.valid_loss), _state(model), trainer,
            lambda: trainer.fit_step(idx))


TRAINERS = {"grid": _grid, "directional": _directional, "single_pos": _single_pos,
            "colorless": _colorless, "band_parallel": _band_parallel, "spatial": _spatial}


@pytest.fixture(scope="module", params=sorted(TRAINERS))
def runs(request, tmp_path_factory):
    """{scan_epochs: (losses, final parameters, trainer, one-step callable)}."""
    out = {}
    for scan in (True, False):
        tmp = tmp_path_factory.mktemp(f"{request.param}_{scan}")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(GraphedSteps, "scan_epochs", scan)
            make = TRAINERS[request.param]
            out[scan] = make(tmp, mp) if request.param == "band_parallel" else make(tmp)
    return request.param, out


def test_scan_and_eager_runs_are_bit_identical(runs):
    name, out = runs
    (losses, params, trainer, _), (e_losses, e_params, e_trainer, _) = out[True], out[False]
    assert not list(e_trainer.graphs)
    assert len(list(trainer.graphs)) >= 1, f"{name}: no step graph was made"
    np.testing.assert_equal(losses, e_losses)
    assert params.keys() == e_params.keys()
    for k in params:
        assert torch.equal(params[k], e_params[k]), (name, k)


@contextlib.contextmanager
def host_reads_raise():
    """Every host read and host-to-device copy of a step raises within the block."""
    def refuse(what):
        def raiser(*args, **kwargs):
            raise AssertionError(f"a step called {what}")
        return raiser

    def as_tensor(data, *args, **kwargs):
        if not torch.is_tensor(data):
            raise AssertionError("a step copied host data with torch.as_tensor")
        return real_as_tensor(data, *args, **kwargs)

    real_as_tensor = torch.as_tensor
    with pytest.MonkeyPatch.context() as mp:
        for attr in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__"):
            mp.setattr(torch.Tensor, attr, refuse(f"Tensor.{attr}"))
        mp.setattr(torch, "tensor", refuse("torch.tensor"))
        mp.setattr(torch, "from_numpy", refuse("torch.from_numpy"))
        mp.setattr(torch, "as_tensor", as_tensor)
        yield


def test_a_step_reads_nothing_from_the_host(runs):
    """One more step of the scan run's trainer (and a validation batch where
    it has a public one) under :func:`host_reads_raise`; a host read in the
    step closure would break its capture on the card."""
    _, out = runs
    trainer, step = out[True][2], out[True][3]
    with host_reads_raise():
        step()
    with pytest.raises(AssertionError, match="Tensor.item"):
        with host_reads_raise():
            torch.zeros(()).item()


GRID_STEPS = ("grid", "directional", "single_pos")  # GFDNTrainer.fit_step's spans


def test_a_step_records_the_program_s_spans(runs):
    """One more step of the scan run's trainer under ``profiling.recording``,
    through its step graph and then eagerly: the graph's refill or the eager
    closure; for ``GFDNTrainer.fit_step`` under ``gfdn.step.train`` with the
    mask draw and the schedule's step; a validation remainder eagerly."""
    name, out = runs
    trainer, step = out[True][2], out[True][3]

    def recorded(run):
        profiling.clear()
        with profiling.recording():
            run()
        spans = profiling.records()
        parents = {s.id: s.name for s in spans}
        return [(s.name, parents.get(s.parent)) for s in spans]

    graphed = recorded(step)
    trainer.scan_epochs = False
    try:
        eager = recorded(step)
    finally:
        del trainer.scan_epochs
    for spans, through, other in ((graphed, "gfdn.graph.fill", "gfdn.graph.eager"),
                                  (eager, "gfdn.graph.eager", "gfdn.graph.fill")):
        assert other not in {n for n, _ in spans}, (name, spans)
        if name not in GRID_STEPS:
            assert spans == [(through, None)], (name, spans)
            continue
        assert ("gfdn.step.train", None) in spans
        under = [n for n, p in spans if p == "gfdn.step.train"]
        assert under[0] == "gfdn.step.mask" and under[-1] == "gfdn.step.schedule"
        assert through in under, (name, spans)
    if name in ("grid", "directional"):
        remainder = recorded(lambda: trainer.valid_step(torch.arange(1), trainer.cfg.batch_size))
        assert remainder == [("gfdn.step.mask", "gfdn.step.valid"),
                             ("gfdn.graph.eager", "gfdn.step.valid"), ("gfdn.step.valid", None)]
    profiling.clear()


def test_replay_bookkeeping_adds_the_capture_counts_per_replay():
    class Counter:
        launches = 0

    a, b, idle = Counter(), Counter(), Counter()
    counts = ReplayCounts(lambda: {"a": a, "b": b, "idle": idle})
    a.launches = 5  # launches before the capture stay as they are
    with counts.recording():  # the capture: its launches are its first replay's
        a.launches += 2
        b.launches += 1
    assert counts.per_replay == {"a": 2, "b": 1}
    for _ in range(3):
        counts.replayed()
    assert (a.launches, b.launches, idle.launches) == (5 + 2 * 4, 1 * 4, 0)


def test_step_graphs_refuse_other_shapes_and_keep_one_graph_per_kind_and_shape():
    graphs = StepGraphs(torch.device("cpu"))
    seen = []
    step = (lambda b: seen.append(b["idx"].clone()) or b["idx"].sum())
    assert int(graphs("train", step, idx=torch.tensor([1, 2]))) == 3
    assert int(graphs("train", step, idx=torch.tensor([4, 5]))) == 9
    graphs("train", step, idx=torch.tensor([1, 2, 3]), mask=None)
    graphs("valid", step, idx=torch.tensor([1, 2]))
    assert len(list(graphs)) == 3
    (first,) = [g for g in graphs if g.inputs["idx"].shape == (2,) and g is graphs.get("train")]
    assert torch.equal(first.inputs["idx"], torch.tensor([4, 5]))  # refilled in place
    with pytest.raises(ValueError, match="shape"):
        first(idx=torch.tensor([1]))
    graphs.clear()
    assert not list(graphs)


def test_fused_tensor_lr_adam_matches_optax_across_the_decay_and_a_resume(tmp_path):
    """Steps at counts 9, 10 and 11 of one step per epoch with the count
    offset 9: the first at the full rate, the others after the decay; the
    optimizer and its schedule saved after the first and resumed into a new
    pair, as ``fit_indexed(resume=True)`` does."""
    raw = raw_config(tmp_path, svf=False, zero_coupling=False)
    raw["trainer_config"].update(lr=3e-3, io_lr=2e-2, coupling_angle_lr=5e-2)
    jax_room, port_room = rooms(tmp_path, False, 512)
    jcfg = JaxDiffGFDNConfig.model_validate(raw)
    _, params = jax_model_and_params(jcfg, jax_room, 2)
    cfg = DiffGFDNConfig.from_dict(raw)
    model = build_gfdn_model(cfg, port_room.common_decay_times, port_room.band_centre_hz,
                             device="cpu")
    load_jax_params(model, params)

    def lrs_on_device(opt):
        return all(torch.is_tensor(g["lr"]) and g["lr"].dim() == 0
                   and g["lr"].device == g["params"][0].device for g in opt.param_groups)

    optimizer, scheduler = make_optimizer(cfg.trainer_config, model, 1, count_offset=9)
    assert lrs_on_device(optimizer)
    assert all(g["fused"] and g["capturable"] for g in optimizer.param_groups)
    jopt = jax_optim.make_optimizer(jcfg.trainer_config, params, 1, count_offset=9)
    jstate = jopt.init(params)
    rng = np.random.RandomState(0)
    for step in range(3):
        if step == 1:  # resume from the sidecar into a new optimizer and schedule
            save_opt_state(tmp_path, 0, {"optimizer": optimizer.state_dict(),
                                         "scheduler": scheduler.state_dict()})
            optimizer, scheduler = make_optimizer(cfg.trainer_config, model, 1, count_offset=9)
            load_optimizer_state(optimizer, scheduler, load_opt_state(tmp_path, 0, "cpu"))
            assert lrs_on_device(optimizer)
        grads = jax.tree_util.tree_map(
            lambda x: rng.randn(*np.shape(x)).astype(np.float32), params)
        updates, jstate = jopt.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(grads))
        flat_u = dict(jax.tree_util.tree_leaves_with_path(updates))
        before = _state(model)
        for name, p in model.named_parameters():
            keys, transpose = flax_path(name)
            g = torch.from_numpy(np.asarray(
                flat_g[tuple(jax.tree_util.DictKey(k) for k in ["params"] + keys)]))
            p.grad = g.T.contiguous() if transpose else g
        optimizer.step()
        scheduler.step()
        for name, p in model.named_parameters():
            keys, transpose = flax_path(name)
            ref = np.asarray(flat_u[tuple(jax.tree_util.DictKey(k) for k in ["params"] + keys)])
            got = (p.detach() - before[name]).numpy()
            got = got.T if transpose else got
            assert np.abs(got - ref).max() <= UPDATE_TOL, (step, name)
    assert lrs_on_device(optimizer)
    assert {g["label"]: float(g["lr"]) for g in optimizer.param_groups} == pytest.approx(
        {"coupling": 5e-3, "io": 2e-3, "other": 3e-4})


def test_a_sidecar_with_float_learning_rates_loads_as_device_tensors(tmp_path):
    """A sidecar of the earlier format, saved from a float-rate, unfused Adam
    after one step: loaded into the fused optimizer, every group is fused and
    capturable again, its rate a 0-d tensor and its step counts float32 on the
    parameters' device, and the next step matches the unfused Adam's."""
    raw = _raw(tmp_path)
    cfg = DiffGFDNConfig.from_dict(raw)
    tc = cfg.trainer_config
    room = synthetic_three_room_dataset(tmp_path, nfft=NFFT, fs=FS, num_rec_per_room=1,
                                        rir_len_s=0.05)
    model = build_gfdn_model(cfg, room.common_decay_times, device="cpu")
    labels = param_labels(model)
    rates = {"coupling": tc.coupling_angle_lr, "io": tc.io_lr, "other": tc.lr}
    groups = [{"params": [p for n, p in model.named_parameters() if labels[n] == label],
               "lr": lr, "label": label} for label, lr in rates.items()]
    old = torch.optim.Adam([g for g in groups if g["params"]], betas=(0.9, 0.999), eps=1e-8)
    old_scheduler = torch.optim.lr_scheduler.LambdaLR(
        old, lambda count: step_decay_factor(count, 1))
    gen = torch.Generator().manual_seed(0)

    def grads(params):
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen, dtype=p.dtype)

    grads(model.parameters())
    old.step()
    old_scheduler.step()
    state = copy.deepcopy({"optimizer": old.state_dict(), "scheduler": old_scheduler.state_dict()})
    resumed = copy.deepcopy(model)
    optimizer, scheduler = make_optimizer(tc, resumed, 1)
    load_optimizer_state(optimizer, scheduler, state)
    for group in optimizer.param_groups:
        assert group["fused"] and group["capturable"] and group["foreach"] is None
        assert torch.is_tensor(group["lr"]) and group["lr"].dim() == 0
        assert group["lr"].device == group["params"][0].device
        for p in group["params"]:
            step = optimizer.state[p]["step"]
            assert step.dtype == torch.float32 and step.device == p.device
    before = _state(model)
    grads(model.parameters())
    for p, q in zip(model.parameters(), resumed.parameters()):
        q.grad = p.grad.clone()
    old.step()
    optimizer.step()
    for (name, p), q in zip(model.named_parameters(), resumed.parameters()):
        assert (q.detach() - before[name]).sub(p.detach() - before[name]).abs().max() \
            <= UPDATE_TOL, name
