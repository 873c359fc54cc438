"""The example twins (`examples/*_torch.py`) run on the CPU with --cpu, as
a user would run them, each in a process of its own: exit 0, the lines
their JAX examples print, and no import of `jax` or `repro`.

Each twin runs at its default size, save train_longformer_torch.py: its
default is 300 steps of a 152M-param model at batch 8 x 512, which the
test cuts to 2 steps at batch 1 x 128 (the model keeps its size)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

TWINS = {
    "quickstart_torch.py": ([], ["kernel-vs-banded max err",
                                 "tiny longformer loss=",
                                 "ring cache per layer"]),
    "serve_window_torch.py": ([], ["[serve] 6 requests, 96 tokens",
                                   "x saving — paper Fig. 3"]),
    "long_context_torch.py": ([], ["decoded 256 tokens at context depth "
                                   "4352", "MB flat (window=512)"]),
    "train_longformer_torch.py": (["--steps", "2", "--batch", "1", "--seq",
                                   "128"],
                                  ["longformer-100m: 151.9M params",
                                   "[trainer] step 0 loss=",
                                   "first-10 loss"]),
    "pipeline_train_torch.py": ([], ["bubble=0.20", "== single-pass",
                                     "step  15 loss=",
                                     "loss decreased: True"]),
}


@pytest.mark.parametrize("name", list(TWINS))
def test_example_twin_runs_on_the_cpu(name, tmp_path):
    args, lines = TWINS[name]
    if name.startswith("train_longformer"):
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2",
               TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                          "--cpu", *args], capture_output=True, text=True,
                         env=env, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    for line in lines:
        assert line in out.stdout, (line, out.stdout)


@pytest.mark.parametrize("name", list(TWINS) + ["context_parallel_torch.py"])
def test_example_twin_imports_neither_jax_nor_repro(name):
    tree = ast.parse((ROOT / "examples" / name).read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    roots = {m.split(".")[0] for m in mods}
    assert not roots & {"jax", "repro"}, roots
