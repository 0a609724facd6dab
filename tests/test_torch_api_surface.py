"""The port's public API against the JAX package's, name by name.

Every ``diffgfdn_tpu/**/*.py``, and every study of ``examples/*.py`` (the
README's walkthrough and the notebook studies, whose port is
``diffgfdn_torch/examples/``), is parsed with ``ast`` (not imported). Each
public top-level function or class, and each public method or property of
such a class, must be defined under the same name in the port's module at
the same path (``diffgfdn_torch/...``); an attribute that the class's
``__init__`` assigns counts. Otherwise the name must be in :data:`RENAMED`
(the port's name for it, which must exist) or in :data:`OMITTED` (why the
port leaves it out on purpose, as ROADMAP's "Not ported, on purpose" list
says). A second case fails when an entry of either table names something
that the JAX package no longer has, or that the port now has under the
same name.
"""

import ast
from functools import lru_cache
from pathlib import Path
from typing import Set

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "diffgfdn_tpu", ROOT / "diffgfdn_torch"
EXAMPLES = "examples/"  # the studies: examples/<name>.py -> diffgfdn_torch/examples/<name>.py

# "<module path>:<name>" in the JAX package -> the same in the port
RENAMED = {
    "training/optim.py:label_params": "training/optim.py:param_labels",
    "training/optim.py:step_decay_schedule": "training/optim.py:step_decay_factor",
    "kernels/pallas_cinv.py:cinv_pallas": "kernels/cinv.py:cinv",
    "kernels/pallas_cinv.py:neg_ptgpt_pallas": "kernels/cinv.py:neg_ptgpt",
    "kernels/pallas_lu.py:lu_solve_pallas": "kernels/lu.py:lu_solve",
    "kernels/pallas_lu.py:lut_apply_pallas": "kernels/lu.py:lut_apply",
    "kernels/pallas_sos.py:sos_cascade_response_pallas": "kernels/sos.py:sos_cascade_response",
    "ops/biquad.py:sos_frequency_response": "kernels/sos.py:sos_cascade_response",
    "utils/placement.py:placement_is_tpu": "kernels/dispatch.py:runs_kernel",
    "kernels/linalg.py:csolve1_pallas": "kernels/linalg.py:csolve1",
    "kernels/tdgfdn.py:delay_line_outputs_pallas": "kernels/tdgfdn.py:delay_line_outputs",
    "models/gfdn.py:DiffGFDN.setup": "models/gfdn.py:DiffGFDN.__init__",
    "models/feedback_loop.py:FeedbackLoop.setup": "models/feedback_loop.py:FeedbackLoop.__init__",
    "models/colorless.py:ColorlessFDN.setup": "models/colorless.py:ColorlessFDN.__init__",
    "training/colorless_trainer.py:ColorlessFDNTrainer.init_params":
        "training/build.py:build_colorless_fdn",
    "training/scan.py:scan_epoch": "training/scan.py:GraphedSteps.run_step",
    "inference/cs_synthesis.py:band_noise": "inference/cs_synthesis.py:filter_band_noise",
}

_UNREAD = "nothing in the port or its benchmark reads it (ROADMAP A, not ported)"
_TRANSPORT = "works around the TPU's transport and changes no number (ROADMAP A, not ported)"
# "<module path>:<name>" in the JAX package -> why the port leaves it out
OMITTED = {
    "utils/compile_cache.py:enable_persistent_cache":
        "XLA's compilation cache: nothing to cache without XLA (ROADMAP A, not ported)",
    "utils/cio.py:encode_complex": f"the re/im codec {_TRANSPORT}",
    "utils/cio.py:to_real_pair": f"the re/im codec {_TRANSPORT}",
    "utils/cio.py:encode_batch": f"the re/im codec {_TRANSPORT}",
    "utils/cio.py:decode_batch": f"the re/im codec {_TRANSPORT}",
    "utils/cio.py:fast_device_put": f"a host-to-TPU copy that {_TRANSPORT}",
    "utils/cio.py:device_early_response_ri": f"a re/im device upload that {_TRANSPORT}",
    "utils/cio.py:device_target_rir_time": f"a device upload that {_TRANSPORT}",
    "utils/cio.py:device_target_spectra_ri": f"a re/im device upload that {_TRANSPORT}",
    "utils/cio.py:shrink_init_batch":
        "flax init on a cut batch; a torch module draws its parameters when built "
        "(ROADMAP A, not ported)",
    "utils/cio.py:init_with_batch":
        "flax init on a batch; a torch module draws its parameters when built "
        "(ROADMAP A, not ported)",
    "data/batching.py:init_example_batch":
        "the batch flax init traces; a torch module draws its parameters when built "
        "(ROADMAP A, not ported)",
    "parallel/mesh.py:batch_sharding": "a GSPMD sharding: ranks are processes here "
                                       "(ROADMAP A, not ported)",
    "parallel/mesh.py:band_sharding": "a GSPMD sharding: ranks are processes here "
                                      "(ROADMAP A, not ported)",
    "parallel/mesh.py:replicated": "a GSPMD sharding: ranks are processes here "
                                   "(ROADMAP A, not ported)",
    "training/checkpoints.py:save_checkpoint_orbax":
        "orbax's format; checkpoints are the JAX package's pickles (ROADMAP A, not ported)",
    "training/checkpoints.py:load_checkpoint_orbax":
        "orbax's format; checkpoints are the JAX package's pickles (ROADMAP A, not ported)",
    "kernels/tdgfdn.py:use_pallas_kernel":
        "the TPU's timed choice of kernel or scan; B7 always runs on CUDA operands "
        "(ROADMAP A, not ported)",
    "kernels/tdgfdn.py:record_kernel_timing":
        "the TPU's timed choice of kernel or scan; B7 always runs on CUDA operands "
        "(ROADMAP A, not ported)",
    **{f"utils/profiling.py:{name}": _UNREAD for name in (
        "StepTimer", "StepTimer.steps_per_sec", "StepTimer.mean_step_ms", "x_realtime",
        "emit_metric", "get_str_results")},
}


def public_names(tree: ast.Module) -> Set[str]:
    """Public top-level functions and classes, and the public methods and
    properties of those classes ("Class.method")."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{sub.name}" for sub in node.body
                        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not sub.name.startswith("_")}
    return out


def defined_names(tree: ast.Module) -> Set[str]:
    """Every top-level function, class and assignment, every method of those
    classes, their class attributes and the attributes their ``__init__``
    assigns ("Class.name")."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out |= {t.id for t in targets if isinstance(t, ast.Name)}
        if not isinstance(node, ast.ClassDef):
            continue
        for sub in node.body:
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.add(f"{node.name}.{sub.name}")
                if sub.name == "__init__":
                    out |= {f"{node.name}.{a.attr}" for a in ast.walk(sub)
                            if isinstance(a, ast.Attribute) and isinstance(a.ctx, ast.Store)
                            and isinstance(a.value, ast.Name) and a.value.id == "self"}
            elif isinstance(sub, (ast.Assign, ast.AnnAssign)):
                targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                out |= {f"{node.name}.{t.id}" for t in targets if isinstance(t, ast.Name)}
    return out


@lru_cache(maxsize=None)
def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def jax_path(module: str) -> Path:
    """The JAX package's file of ``module``, or the study's under ``examples/``."""
    return ROOT / module if module.startswith(EXAMPLES) else JAX / module


def jax_public(module: str) -> Set[str]:
    return public_names(_parse(jax_path(module)))


def port_defined(module: str) -> Set[str]:
    path = PORT / module
    return defined_names(_parse(path)) if path.exists() else set()


JAX_MODULES = (sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))
               + sorted(EXAMPLES + p.name for p in (ROOT / "examples").glob("*.py")))


def _missing(module: str) -> Set[str]:
    return {f"{module}:{name}" for name in jax_public(module) - port_defined(module)}


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    missing = _missing(module)
    unrecorded = sorted(missing - set(RENAMED) - set(OMITTED))
    assert not unrecorded, f"no port counterpart, rename or recorded omission: {unrecorded}"
    for key in sorted(missing & set(RENAMED)):
        target_module, target = RENAMED[key].split(":")
        assert target in port_defined(target_module), f"{key} -> {RENAMED[key]} does not exist"


def test_recorded_entries_are_current():
    """Each entry names a public name of the JAX package that the port does
    not define under the same name at the same path; each omission gives
    a reason that cites ROADMAP."""
    for key in list(RENAMED) + list(OMITTED):
        module, name = key.split(":")
        assert jax_path(module).exists() and name in jax_public(module), f"stale entry {key}"
        assert name not in port_defined(module), f"{key}: the port has it now"
    assert not set(RENAMED) & set(OMITTED)
    assert all("ROADMAP" in why for why in OMITTED.values())


def test_the_checker_sees_a_missing_name():
    """The parse counts methods, class attributes and ``__init__``'s
    attributes, and not a method's other assignments."""
    jax_src = "class A:\n    def f(self): pass\n    def g(self): pass\n    def h(self): pass\n" \
              "def k(): pass\n"
    port_src = "class A:\n    g = 1\n    def __init__(self):\n        self.f = 0\n" \
               "    def m(self):\n        self.h = 0\n"
    missing = public_names(ast.parse(jax_src)) - defined_names(ast.parse(port_src))
    assert missing == {"A.h", "k"}


def test_the_studies_are_checked():
    """The ten studies of ``examples/`` are among the checked modules, and a
    study the port lacked would be missing name by name."""
    studies = [m for m in JAX_MODULES if m.startswith(EXAMPLES)]
    assert len(studies) == 10 and "examples/walkthrough.py" in studies
    assert {"step1_dataset", "step5_binaural", "main"} <= jax_public("examples/walkthrough.py")
    assert _missing("examples/walkthrough.py") == set()
    assert port_defined("examples/no_such_study.py") == set()
