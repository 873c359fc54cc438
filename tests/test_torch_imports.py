"""The port stands alone: `repro_torch` and chip_smoke.py import neither JAX
nor any module of the JAX package `repro`."""
import os
import pathlib
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_MODULES = [
    "repro_torch", "repro_torch.interop", "repro_torch.configs",
    "repro_torch.core.types", "repro_torch.core.patterns",
    "repro_torch.core.layers", "repro_torch.core.moe",
    "repro_torch.core.ssm", "repro_torch.core.model",
    "repro_torch.kernels.dots", "repro_torch.kernels.ref",
    "repro_torch.kernels._build", "repro_torch.kernels.swat_decode",
    "repro_torch.kernels.swat_attention", "repro_torch.kernels.ops",
    "repro_torch.kernels.swat_backward", "repro_torch.tree",
    "repro_torch.serving.sampling", "repro_torch.serving.scheduler",
    "repro_torch.serving.engine", "repro_torch.launch.serve",
    "repro_torch.optim.adamw", "repro_torch.optim.compress",
    "repro_torch.data.pipeline", "repro_torch.checkpoint.manager",
    "repro_torch.launch.steps", "repro_torch.runtime.trainer",
    "repro_torch.launch.train", "repro_torch.telemetry",
    "repro_torch.telemetry.events", "repro_torch.telemetry.tracer",
    "repro_torch.telemetry.validate", "repro_torch.telemetry.metrics",
    "repro_torch.telemetry.kernelprof", "repro_torch.launch.scope",
    "repro_torch.analysis", "repro_torch.analysis.collectives",
    "repro_torch.analysis.tracer", "repro_torch.analysis.rules",
    "repro_torch.analysis.report", "repro_torch.analysis.baselines",
    "repro_torch.launch.analyze", "repro_torch.launch.mesh",
    "repro_torch.distributed.context_parallel",
    "repro_torch.distributed.pipeline",
    "repro_torch.distributed.sharding",
    "repro_torch.distributed.tensor_parallel",
]


def test_port_imports_without_jax_or_repro():
    """Block `jax` outright, import every port module, and check that no
    module of `repro` was loaded on the way."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import repro_torch.configs as C\n"
        "for a in C.ARCH_IDS + C.PAPER_IDS:\n"
        "    C.get_config(a)\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_port_imports_without_triton_or_cuda():
    """Every port module imports with `triton` blocked and without touching
    CUDA: kernels are built and launched only inside the calls that need
    them, never at import time."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['triton'] = None\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._LIBS\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


_BANNED = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)"
                     r"|from\s+(jax|repro)(\.|\s)(?!_torch))", re.M)


def test_port_sources_name_no_jax_or_repro_import():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {str(f.relative_to(ROOT / "src")) for f in files[:-1]}
    assert {"repro_torch/optim/adamw.py", "repro_torch/data/pipeline.py",
            "repro_torch/checkpoint/manager.py",
            "repro_torch/runtime/trainer.py",
            "repro_torch/launch/train.py", "repro_torch/launch/scope.py",
            "repro_torch/telemetry/metrics.py",
            "repro_torch/telemetry/kernelprof.py",
            "repro_torch/analysis/tracer.py", "repro_torch/analysis/rules.py",
            "repro_torch/launch/analyze.py"} <= names
    assert len(files) > 25
    for f in files:
        hits = _BANNED.findall(f.read_text())
        assert not hits, (f, hits)


def _run_without_card(launcher):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{launcher}", "--arch",
         "llama3.2-1b", "--smoke"], capture_output=True, text=True, env=env,
        timeout=120)


def test_serve_launcher_refuses_to_run_without_a_card():
    """The launcher's default device is cuda: with no card it exits non-zero
    instead of serving on the CPU."""
    if torch.cuda.is_available():
        return
    out = _run_without_card("serve")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_train_launcher_refuses_to_run_without_a_card():
    """The same for training: the default device is cuda."""
    if torch.cuda.is_available():
        return
    out = _run_without_card("train")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
