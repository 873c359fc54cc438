"""Build and load the port's CUDA kernels (plain C entry points + ctypes).

Every `repro_torch/csrc/*.cu` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>.<hash>.so <name>.cu

into `repro_torch/_kernels_build/` (listed in .gitignore), at first use.
All sources start compiling together, one `nvcc` process each, and are
waited for together. The file name carries a hash of the source, of every
header in `csrc/` (`*.cuh`, which the sources include) and of the flags, so
an edited source or header is rebuilt and a stale library is never loaded.
Nothing outside the package's own `csrc/` is compiled or included.

The sources include no PyTorch header: a kernel takes raw device pointers,
sizes and the stream as plain C arguments and returns `cudaGetLastError()`.
Wrappers declare `argtypes`/`restype` for every entry point they call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_kernels_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report per source, from the last build in
# this process (empty when the libraries were already built)
BUILD_LOG: Dict[str, str] = {}


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built from source and need the CUDA toolkit")
    return path


def _target(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}.{digest}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.
    Returns {source stem: library path}. Raises with nvcc's output if any
    build fails."""
    srcs = sorted(CSRC.glob("*.cu"))
    targets = {s.stem: _target(s) for s in srcs}
    todo = [s for s in srcs if not targets[s.stem].exists()]
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs: List = []
    for s in todo:
        tmp = targets[s.stem].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for s, tmp, p in procs:
        out, _ = p.communicate()
        BUILD_LOG[s.stem] = out
        if p.returncode != 0:
            failed.append(f"--- {s.name} (exit {p.returncode}) ---\n{out}")
        else:
            os.replace(tmp, targets[s.stem])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<stem>.cu` (building all sources
    first if needed)."""
    with _LOCK:
        if stem not in _LIBS:
            targets = build_all()
            if stem not in targets:
                raise RuntimeError(f"no CUDA source csrc/{stem}.cu")
            _LIBS[stem] = ctypes.CDLL(str(targets[stem]))
        return _LIBS[stem]


class LaunchCounter:
    """Counts a wrapper's kernel launches: `n` grows by one where the
    wrapper launches its kernel, and nowhere else."""

    def __init__(self):
        self.n = 0

    def reset(self) -> None:
        self.n = 0


def check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
