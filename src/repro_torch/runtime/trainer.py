"""Fault-tolerant single-device training runtime (the port of the JAX
package's `runtime/trainer.py`).

  * auto-resume     - on start, restores the latest valid checkpoint
                      (params, optimizer state, residual; the data stream is
                      a function of the step), so a killed run continues
                      bit-exactly where the kernels are deterministic.
  * failure drill   - FailureInjector raises at a configured step.
  * straggler watch - steps slower than `straggler_factor` x the running
                      median are flagged in the metrics.
  * grad compression (optional int8 error feedback).

Runs on the card by default (`TrainConfig.device`); `impl=None` picks the
CUDA kernels for CUDA tensors and the plain versions for CPU tensors.
Mesh-sharded training and resharding on restore belong to the distributed
slice.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import model as Mod
from repro_torch.core.types import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import steps as St
from repro_torch.optim import adamw, compress


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    straggler_factor: float = 3.0
    grad_compression: bool = False
    impl: Optional[str] = None      # None: kernel on CUDA, banded on CPU
    fail_at_step: int = -1          # failure-injection drill (tests)
    metrics_path: Optional[str] = None
    device: str = "cuda"


class FailureInjector:
    def __init__(self, fail_at: int):
        self.fail_at = fail_at

    def check(self, step: int) -> None:
        if self.fail_at >= 0 and step == self.fail_at:
            raise RuntimeError(f"injected failure at step {step}")


class StragglerWatchdog:
    def __init__(self, factor: float):
        self.factor = factor
        self.times: list = []
        self.flagged: list = []

    def record(self, step: int, dt: float) -> bool:
        slow = (len(self.times) >= 5
                and dt > self.factor * float(np.median(self.times)))
        self.times.append(dt)
        if len(self.times) > 100:
            self.times.pop(0)
        if slow:
            self.flagged.append((step, dt))
        return slow


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                 train_cfg: TrainConfig, data_cfg: DataConfig):
        self.cfg, self.opt_cfg, self.tc = cfg, opt_cfg, train_cfg
        self.device = torch.device(train_cfg.device)
        self.data = SyntheticLM(data_cfg)
        self.ckpt = CheckpointManager(train_cfg.ckpt_dir, keep=train_cfg.keep)
        self.watchdog = StragglerWatchdog(train_cfg.straggler_factor)
        self.injector = FailureInjector(train_cfg.fail_at_step)
        self.step_fn = St.make_train_step(
            cfg, opt_cfg, impl=train_cfg.impl,
            grad_compression=train_cfg.grad_compression)

    # ------------------------------------------------------------ state ----
    def init_state(self) -> Dict[str, Any]:
        params = Mod.init_model(self.cfg, seed=self.tc.seed,
                                device=self.device)
        state: Dict[str, Any] = {"params": params,
                                 "opt": adamw.init_opt_state(params)}
        if self.tc.grad_compression:
            state["residual"] = compress.init_residual(params)
        return state

    def resume_or_init(self):
        latest = self.ckpt.latest_step()
        state = self.init_state()
        if latest is None:
            return state, 0
        state = self.ckpt.restore(latest, like=state)
        print(f"[trainer] resumed from step {latest}")
        return state, latest

    # ------------------------------------------------------------- loop ----
    def _step(self, state, batch):
        if self.tc.grad_compression:
            (state["params"], state["opt"], metrics,
             state["residual"]) = self.step_fn(state["params"], state["opt"],
                                               batch, state["residual"])
        else:
            state["params"], state["opt"], metrics = self.step_fn(
                state["params"], state["opt"], batch)
        # one host sync per step: it also ends the step's time
        names = sorted(metrics)
        values = torch.stack([metrics[k].float() for k in names]).tolist()
        return dict(zip(names, values))

    def train(self) -> Dict[str, Any]:
        state, start = self.resume_or_init()
        history = []
        metrics_f = (open(self.tc.metrics_path, "a")
                     if self.tc.metrics_path else None)
        try:
            for step in range(start, self.tc.total_steps):
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in self.data.global_batch(step).items()}
                t0 = time.perf_counter()
                self.injector.check(step)
                metrics = self._step(state, batch)
                dt = time.perf_counter() - t0
                slow = self.watchdog.record(step, dt)
                metrics.update(step=step, step_time_s=dt,
                               straggler=bool(slow))
                history.append(metrics)
                if metrics_f:
                    metrics_f.write(json.dumps(metrics) + "\n")
                    metrics_f.flush()
                if step % self.tc.log_every == 0:
                    print(f"[trainer] step {step} loss={metrics['loss']:.4f} "
                          f"gnorm={metrics['grad_norm']:.3f} {dt*1e3:.0f}ms"
                          + (" STRAGGLER" if slow else ""))
                if (step + 1) % self.tc.ckpt_every == 0:
                    self.ckpt.save(step + 1, state)
        finally:
            if metrics_f:
                metrics_f.close()
        self.ckpt.save(self.tc.total_steps, state, blocking=True)
        self.ckpt.wait()
        return {"state": state, "history": history,
                "stragglers": self.watchdog.flagged}
