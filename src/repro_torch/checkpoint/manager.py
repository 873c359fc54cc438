"""Fault-tolerant checkpointing for the port's state trees: atomic, async,
with retention (the port of the JAX package's `checkpoint/manager.py`,
same on-disk layout).

Layout (one directory per step):
    <root>/step_00000100.tmp.<pid>.<id>/   (written)
    <root>/step_00000100/                  (atomic rename on completion)
        arrays.npz      every leaf, as leaf_<i> in manifest order
        manifest.json   step, leaf paths, shapes, dtypes (written last)

Guarantees:
  * atomicity - readers never see partial checkpoints (tmp dir + rename;
    the manifest is written last inside the tmp dir).
  * restart   - `latest_step()` + `restore()`; directories without a
    manifest (a crash mid-save) are ignored, and a manifest that does not
    match the target tree is rejected.
  * async     - `save()` copies every leaf to host memory on the caller's
    thread (so later in-place updates of the state cannot reach the
    checkpoint) and a worker thread writes the files; `wait()` joins it and
    re-raises a failed write.
numpy has no bfloat16: bf16 leaves are stored as their raw bytes (uint8),
with the dtype in the manifest. Restoring onto another mesh (resharding)
belongs to the distributed slice.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree


def _to_host(t) -> Tuple[np.ndarray, str, List[int]]:
    """(numpy copy, torch dtype name, shape) of one leaf; bf16 as raw
    bytes."""
    t = torch.as_tensor(t).detach()
    name = str(t.dtype).replace("torch.", "")
    host = t.to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        host = host.reshape(-1).view(torch.uint8)
    return host.numpy(), name, list(t.shape)


def _from_host(a: np.ndarray, shape, dtype_name: str) -> torch.Tensor:
    dtype = getattr(torch, dtype_name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype in checkpoint manifest: "
                         f"{dtype_name!r}")
    t = torch.from_numpy(np.array(a))
    if dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.reshape(shape).to(dtype)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------- save ----
    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        """Device->host copies happen here, on the caller's thread; file IO
        on the worker unless `blocking`."""
        items = [(path, *_to_host(leaf))
                 for path, leaf in tree.flatten_with_paths(state)]
        if blocking:
            self._write(step, items)
        else:
            self._ensure_worker()
            self._q.put((step, items))

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    def _run(self) -> None:
        while True:
            step, items = self._q.get()
            try:
                self._write(step, items)
            except Exception as e:  # surfaced by wait()
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, step: int, items: List[Tuple[str, np.ndarray, str,
                                                   List[int]]]):
        final = self.root / f"step_{step:08d}"
        # unique tmp per writer: a blocking save and a queued async save of
        # the same step may run concurrently; the atomic rename at the end
        # makes last-wins safe
        tmp = self.root / f"step_{step:08d}.tmp.{os.getpid()}.{id(items)}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz",
                 **{f"leaf_{i}": it[1] for i, it in enumerate(items)})
        manifest = {
            "step": step,
            "num_leaves": len(items),
            "paths": [it[0] for it in items],
            "shapes": [it[3] for it in items],
            "dtypes": [it[2] for it in items],
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        try:
            if final.exists():
                shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
        except OSError:
            # a concurrent writer of the same step won the rename; its
            # payload is identical: drop ours
            shutil.rmtree(tmp, ignore_errors=True)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    def wait(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            self._q.join()
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # ---------------------------------------------------------- restore ----
    def all_steps(self) -> List[int]:
        steps = []
        for p in self.root.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, device=None) -> Any:
        """A tree shaped like `like` with the saved leaves, each in its
        `like` leaf's dtype, on `device` (default: that leaf's device).
        Raises ValueError when the saved tree does not match `like`."""
        d = self.root / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        refs = tree.flatten_with_paths(like)
        if manifest["num_leaves"] != len(refs) or manifest["paths"] != [
                p for p, _ in refs]:
            raise ValueError(f"checkpoint {d}: tree structure changed")
        out = []
        with np.load(d / "arrays.npz") as data:
            for i, (path, ref) in enumerate(refs):
                shape = tuple(manifest["shapes"][i])
                if shape != tuple(ref.shape):
                    raise ValueError(f"checkpoint {d}: {path} is {shape}, "
                                     f"the target is {tuple(ref.shape)}")
                t = _from_host(data[f"leaf_{i}"], shape,
                               manifest["dtypes"][i])
                dev = ref.device if device is None else device
                out.append(t.to(device=dev, dtype=ref.dtype))
        return tree.unflatten(like, out)
