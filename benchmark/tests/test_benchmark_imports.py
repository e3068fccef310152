"""Nothing the benchmark runs loads JAX, its libraries or the JAX package,
and the reference loads nothing of the program. Each check runs in a fresh
interpreter, whose ``sys.modules`` holds only what it imported."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dynamo_depth_tpu")
REFERENCE = spec.HERE / "reference"

# A reference step on the CPU at 64x96, batch 2, after importing ``modules``;
# prints the top-level names of every loaded module.
_DRIVE = """
import importlib, importlib.util, sys
from pathlib import Path
for m in {modules!r}:
    importlib.import_module(m)
for p in sorted(Path({metrics!r}).glob("*.py")):
    spec = importlib.util.spec_from_file_location("metric_" + p.stem.replace(".", "_"), p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import torch
from benchmark import inputs
from benchmark.reference.model import DynamoModel
from benchmark.reference.step import ReferenceStep
opts = dict(depth_model="litemono", encoder_num_layers=18, height=64, width=96, scales=[0, 1, 2], frame_ids=[0, -1, 1],
            batch_size=2, learning_rate=1e-4, scheduler_step_size=10, epoch_size=8000, min_depth=0.1, max_depth=100.0,
            ssim_weight=0.85, mask_disp_thrd=0.03, g_p_photo=1.0, g_d_smooth=1e-3, g_d_ground=0.1, g_c_smooth=1e-3,
            g_c_consistency=5.0, g_m_sparsity=0.04, g_m_smooth=0.1, ramp_red=3.0, gp_prior=0.4, gp_tol=0.005,
            gp_max_it=100, gp_np_per_it=5, gp_score_mode="per_batch", image_dtype="auto",
            weight_ramp=["g_c_smooth", "g_c_consistency", "g_m_sparsity", "g_m_smooth"])
ref = ReferenceStep(opts, "fine_tune", 8000, 0.4, "cpu")
ref.model.load_state_dict(inputs.draw_weights(ref.model.state_dict(), 3, "cpu"))
losses = ref.step(inputs.make_batches(opts, 1, 3, "cpu")[0], torch.Generator().manual_seed(3), 0)
assert torch.isfinite(losses["loss"])
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(modules) -> set:
    code = _DRIVE.format(modules=modules, metrics=str(spec.HERE / "metrics"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(proc.stdout.split())


def _benchmark_modules():
    out = []
    for p in sorted(spec.HERE.rglob("*.py")):
        rel = p.relative_to(spec.ROOT).with_suffix("")
        if "tests" in rel.parts or "metrics" in rel.parts:
            continue
        out.append(".".join(rel.parts).removesuffix(".__init__"))
    return out


def test_the_benchmark_and_the_program_load_no_jax():
    loaded = _loaded(_benchmark_modules() + ["dynamo_depth_torch.training.trainer"])
    assert "benchmark" in loaded and "dynamo_depth_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    reference = [m for m in _benchmark_modules() if m.startswith("benchmark.reference")]
    loaded = _loaded(reference)
    assert not loaded & set(FORBIDDEN + ("dynamo_depth_torch",))


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_only_torch_numpy_and_themselves(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] in ("torch", "numpy", "math", "functools", "typing", "types", "__future__",
                                           "benchmark"), f"{path.name} imports {name}"
            assert not name.startswith("benchmark") or name.startswith("benchmark.reference") or \
                name == "benchmark", f"{path.name} imports {name}"
