"""Rank functions of the port's process-group tests.

``diffgfdn_torch.parallel.mesh.spawn`` runs each function here in every rank
of a gloo group on the CPU. They import torch, numpy and the port only (the
spawned processes never load JAX): the test process writes each scenario's
inputs to ``<out>/<name>.pkl`` and each rank writes what it measured to
``<out>/<name>_rank<r>.pkl``, which the tests hold against the unsharded port
and against JAX.
"""

import logging
import os
from pathlib import Path
import pickle
from typing import Dict

import numpy as np
import torch


# spawn()'s keywords for the tests: the ranks fork from one server process
# that imported torch and the port once
SPAWN = dict(start_method="forkserver",
             preload=["torch_dist_workers", "diffgfdn_torch.parallel", "diffgfdn_torch.models",
                      "diffgfdn_torch.cli.run_model", "diffgfdn_torch.cli.run_subband_training",
                      "diffgfdn_torch.training"])


def save(out, name: str, rank: int, result: Dict) -> None:
    with open(Path(out) / f"{name}_rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def load(out, name: str):
    with open(Path(out) / f"{name}.pkl", "rb") as f:
        return pickle.load(f)


def flat(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays as {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _setup() -> None:
    torch.set_num_threads(1)
    logging.basicConfig(level=logging.INFO)


# --------------------------- frequency-sharded fits ---------------------------

def freq_model(spec):
    from diffgfdn_torch.models import DiffGFDNSinglePos
    from diffgfdn_torch.utils.params import load_jax_params

    model = DiffGFDNSinglePos(sample_rate=spec["fs"], num_groups=3, delays=spec["delays"],
                              gains=spec["gains"], use_svf_in_output=False)
    return load_jax_params(model, spec["params"])


def freq_edc_loss(model, spec):
    from diffgfdn_torch.losses import edc_loss

    def loss_fn(batch, shard):
        total = edc_loss(batch["target_rir_response"], shard.response(model, batch),
                         spec["mixing"], spec["max_len"])
        return total, {"edc": total}

    return loss_fn


def freq_step_result(model, spec, mesh) -> Dict:
    """One step of ``make_freq_sharded_step`` from the spec's parameters:
    the loss, the summed gradients and the parameters after Adam."""
    from diffgfdn_torch.config.schema import TrainerConfig
    from diffgfdn_torch.parallel import make_freq_sharded_step
    from diffgfdn_torch.training.optim import make_optimizer
    from diffgfdn_torch.utils.params import jax_grads_from_torch, jax_params_from_torch

    cfg = TrainerConfig(batch_size=1, num_freq_bins=spec["nfft"], max_epochs=1, lr=1e-3)
    optimizer, _ = make_optimizer(cfg, model, 1)
    step = make_freq_sharded_step(model, freq_edc_loss(model, spec), optimizer, mesh)
    batch = {k: torch.as_tensor(v) for k, v in spec["batch"].items()}
    grads = {}

    def record(*_):
        grads.update(flat(jax_grads_from_torch(model)))

    hook = optimizer.register_step_pre_hook(record)
    total, _ = step(batch)
    hook.remove()
    return {"loss": float(total), "grads": grads,
            "params": flat(jax_params_from_torch(model))}


def freq_step(rank: int, world: int, out) -> None:
    """A sharded step on every rank; rank 0 also the unsharded one."""
    from diffgfdn_torch.parallel.mesh import make_mesh, Mesh

    _setup()
    spec = load(out, "freq_step")
    result = {"sharded": freq_step_result(freq_model(spec), spec, make_mesh(1))}
    if rank == 0:
        result["unsharded"] = freq_step_result(freq_model(spec), spec, Mesh((1, 1)))
    save(out, f"freq_step_w{world}", rank, result)


def freq_cli(rank: int, world: int, out) -> None:
    """``run_model`` on a single-position YAML under the process group, with
    every checkpoint write and warning counted."""
    from diffgfdn_torch.cli.run_model import main
    from diffgfdn_torch.training import trainer as trainer_module

    _setup()
    spec = load(out, "freq_cli")
    writes = []
    real = trainer_module.save_checkpoint

    def counted(*args, **kwargs):
        writes.append(args[1])
        return real(*args, **kwargs)

    trainer_module.save_checkpoint = counted
    messages = []

    class Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    logging.getLogger("diffgfdn_torch").addHandler(Keep())
    os.chdir(spec["cwd"])
    main(["-c", spec["config"], "--device", "cpu", "--freq-parallel", "on"])
    save(out, f"freq_cli_w{world}", rank, {"writes": writes, "messages": messages})


def freq_pair(rank: int, world: int, out) -> None:
    """The two-rank group's work: the sharded step, then the CLI."""
    freq_step(rank, world, out)
    freq_cli(rank, world, out)


# --------------------------- band x batch meshes ---------------------------

BAND_MESHES = {"2x1": (2, 2), "1x2": (1, 2), "2x2": (2, 4)}  # name: (bands axis ask, world)


def band_trainer(spec, mesh, scan: bool = True):
    """The band-parallel trainer of the spec's group on ``mesh`` (every band
    model built from the group's first config, as JAX builds its one
    model), from the spec's initial parameters."""
    from diffgfdn_torch.data import arrays_from_room_dataset, ThreeRoomDataset
    from diffgfdn_torch.parallel import BandParallelTrainer
    from diffgfdn_torch.training import build_gfdn_model
    from diffgfdn_torch.utils.params import torch_state_from_jax

    room = ThreeRoomDataset(spec["path"], nfft=spec["nfft"])
    room.common_decay_times = spec["cdt"]
    room.band_centre_hz = spec["band_centres"]
    cfg = spec["cfg"]
    models = [build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz, device="cpu")
              for _ in range(len(spec["resps"]))]
    trainer = BandParallelTrainer(models, cfg.trainer_config, spec["resps"], 2,
                                  max_ir_len_ms=spec["max_ir_ms"], device="cpu", mesh=mesh)
    trainer.scan_epochs = scan
    state = torch_state_from_jax(spec["params"])
    trainer.load_band_params({k: v[trainer.bands] for k, v in state.items()})
    arrays = arrays_from_room_dataset(room)
    trainer.upload_arrays(arrays)
    return trainer, arrays


def band_state(trainer) -> Dict:
    return {k: p.detach().numpy().copy() for k, p in trainer.params.items()}


def band_run(spec, mesh) -> Dict:
    """One step (losses, gradients, parameters after Adam) and a 2-epoch
    ``fit_indexed`` from the spec's parameters on ``mesh``."""
    idx = torch.as_tensor(spec["idx"])
    trainer, arrays = band_trainer(spec, mesh)
    totals, losses = trainer.loss_and_grads(idx)
    grads = {k: p.grad.numpy().copy() for k, p in trainer.params.items()}
    trainer.step(idx)
    out = {"bands": (trainer.bands.start, trainer.bands.stop), "totals": totals.numpy(),
           "losses": {k: v.numpy() for k, v in losses.items()}, "grads": grads,
           "adam": band_state(trainer), "mesh": trainer.mesh.shape}
    trainer, arrays = band_trainer(spec, mesh)
    history = trainer.fit_indexed(arrays, spec["train_idx"], spec["valid_idx"], max_epochs=2,
                                  seed=spec["seed"])
    out.update(history=history, valid=np.stack(trainer.valid_loss), fit=band_state(trainer))
    return out


def band_checkpoint(spec, mesh, out) -> Dict:
    """Under the mesh: a step, each band's checkpoint written by its owner,
    read back by every rank of the band, one more step from it."""
    import torch.distributed as dist

    from diffgfdn_torch.training.checkpoints import load_checkpoint, save_checkpoint
    from diffgfdn_torch.utils.params import (
        flax_tree,
        stack_jax_trees,
        torch_state_from_jax,
        unstack_jax_tree,
    )

    idx = torch.as_tensor(spec["idx"])
    trainer, _ = band_trainer(spec, mesh)
    trainer.step(idx)
    dirs = [Path(out) / f"ckpt_band{b}" for b in range(len(spec["resps"]))]
    bands = range(trainer.bands.start, trainer.bands.stop)
    if trainer.writes_checkpoints():
        tree = flax_tree(trainer.params.items())
        for b, g in enumerate(bands):
            save_checkpoint(dirs[g], 0, unstack_jax_tree(tree, b))
    dist.barrier()
    before = band_state(trainer)
    restored = torch_state_from_jax(stack_jax_trees([load_checkpoint(dirs[g], 0) for g in bands]))
    trainer.load_band_params(restored)
    after = band_state(trainer)
    totals, _ = trainer.step(idx)
    return {"equal": all(np.array_equal(before[k], after[k]) for k in before),
            "continued": totals.numpy().copy(), "bands": (bands.start, bands.stop)}


def band_meshes(rank: int, world: int, out) -> None:
    """The meshes (2, 1) and (1, 2) on ranks 0 and 1 while rank 3 runs the
    one-rank trainer, then (2, 2) on all four and the checkpoint round trip
    under it. Every rank makes every mesh first (``make_mesh`` is called by
    the whole group, in one order)."""
    from diffgfdn_torch.parallel.mesh import make_mesh, Mesh

    _setup()
    spec = load(out, "band_mesh")
    small = {name: make_mesh(bands, world_size=size)
             for name, (bands, size) in BAND_MESHES.items() if size < world}
    result = {name: band_run(spec, mesh) for name, mesh in small.items() if mesh is not None}
    if rank == world - 1:
        result["one_rank"] = band_run(spec, Mesh((1, 1)))
    joint = make_mesh(2)
    result["2x2"] = band_run(spec, joint)
    result["checkpoint"] = band_checkpoint(spec, joint, out)
    save(out, "band_mesh", rank, result)


# --------------------------- batch-sharded spatial ---------------------------

def spatial_fit(spec, mesh) -> Dict:
    """``fit_indexed`` of the spec's common-slopes MLP from its parameters."""
    from diffgfdn_torch.data import arrays_from_spatial_dataset, SpatialThreeRoomDataset
    from diffgfdn_torch.training import build_spatial_model, SpatialSamplingTrainer
    from diffgfdn_torch.utils.params import jax_params_from_torch, load_jax_params

    room = SpatialThreeRoomDataset(spec["path"])
    cfg = spec["cfg"]
    model = build_spatial_model(cfg, room.num_rooms, room.ambi_order, device="cpu")
    load_jax_params(model, spec["params"])
    trainer = SpatialSamplingTrainer(model, cfg, room, grid_resolution_m=spec["resolution"],
                                     device="cpu")
    trainer.fit_indexed(arrays_from_spatial_dataset(room), spec["train_idx"], spec["valid_idx"],
                        seed=cfg.seed, mesh=mesh)
    return {"train": trainer.train_loss, "valid": trainer.valid_loss,
            "params": flat(jax_params_from_torch(model))}


def spatial_mesh(rank: int, world: int, out) -> None:
    """The batch-sharded fit on every rank; the last rank then the unsharded one."""
    from diffgfdn_torch.parallel.mesh import make_mesh, Mesh

    _setup()
    spec = load(out, "spatial_mesh")
    result = {"sharded": spatial_fit(spec, make_mesh(1))}
    if rank == world - 1:
        spec["cfg"].train_dir = spec["one_rank_dir"]
        result["unsharded"] = spatial_fit(spec, Mesh((1, 1)))
    save(out, "spatial_mesh", rank, result)
