"""The port's training runtime, with the cases of tests/test_runtime.py
(port against port): failure injection then bit-exact resume, loss falls on
the synthetic language, grad compression still converges, the straggler
watchdog; and the train launcher."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import StragglerWatchdog, TrainConfig, Trainer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def make_trainer(tmp_path, total=8, fail_at=-1, ckpt_every=4, seed=0,
                 compression=False, impl=None):
    cfg = get_smoke_config("llama3p2_1b")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                          global_batch=4, seed=7)
    tc = TrainConfig(total_steps=total, ckpt_every=ckpt_every,
                     ckpt_dir=str(tmp_path / "ckpt"), log_every=100,
                     seed=seed, fail_at_step=fail_at,
                     grad_compression=compression, impl=impl, device="cpu",
                     metrics_path=str(tmp_path / "metrics.jsonl"))
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=total)
    return Trainer(cfg, opt, tc, data_cfg)


@pytest.mark.parametrize("impl", [None, "kernel"])
def test_failure_injection_and_bitexact_resume(tmp_path, impl):
    ref = make_trainer(tmp_path / "ref", impl=impl).train()
    with pytest.raises(RuntimeError, match="injected failure"):
        make_trainer(tmp_path / "x", fail_at=6, impl=impl).train()
    out = make_trainer(tmp_path / "x", impl=impl).train()
    assert [h["step"] for h in out["history"]] == [4, 5, 6, 7]
    for a, b in zip(tree.leaves(ref["state"]["params"]),
                    tree.leaves(out["state"]["params"]), strict=True):
        assert torch.equal(a, b)
    assert int(out["state"]["opt"].step) == 8
    lines = (tmp_path / "x" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 6 + 4          # steps 0-5, then 4-7 after resume


def _first_last(hist):
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    return first, last


def test_loss_decreases(tmp_path):
    out = make_trainer(tmp_path, total=30, ckpt_every=100).train()
    first, last = _first_last(out["history"])
    assert last < first - 0.1, (first, last)


def test_grad_compression_training_still_converges(tmp_path):
    out = make_trainer(tmp_path, total=30, ckpt_every=100,
                       compression=True).train()
    first, last = _first_last(out["history"])
    assert last < first - 0.1, (first, last)
    assert "residual" in out["state"]


def test_straggler_watchdog():
    w = StragglerWatchdog(factor=3.0)
    for s in range(10):
        assert not w.record(s, 0.1)
    assert w.record(10, 1.0)      # 10x median -> flagged
    assert not w.record(11, 0.11)
    assert w.flagged and w.flagged[0][0] == 10


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, env=env,
                          timeout=300)


def test_train_launcher_runs_on_cpu_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    out = _launch("--arch", "longformer-paper", "--smoke", "--steps", "2",
                  "--batch", "2", "--seq", "64", "--device", "cpu",
                  "--ckpt-dir", ck)
    assert out.returncode == 0, out.stderr
    assert "[train] done" in out.stdout and "(cpu)" in out.stdout
    again = _launch("--arch", "longformer-paper", "--smoke", "--steps", "3",
                    "--batch", "2", "--seq", "64", "--device", "cpu",
                    "--ckpt-dir", ck)
    assert again.returncode == 0, again.stderr
    assert "resumed from step 2" in again.stdout


@pytest.mark.parametrize("flag", [["--debug-mesh", "2,2"],
                                  ["--device-count", "4"], ["--multi-pod"]])
def test_train_launcher_refuses_mesh_flags(tmp_path, flag):
    """The JAX launcher's mesh flags, ported: --debug-mesh 2,2 trains on a
    2x2 LocalMesh and resumes from its checkpoint; --device-count is
    checked against the debug mesh (2 devices cannot hold 2x2, 4 can);
    --multi-pod refuses, naming the 512 ranks its mesh needs."""
    common = ("--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
              "--batch", "4", "--seq", "32", "--ckpt-dir",
              str(tmp_path / "ck"))
    if flag[0] == "--debug-mesh":
        out = _launch(*common, *flag, "--steps", "2")
        assert out.returncode == 0, out.stderr
        assert "2x2 LocalMesh, sequence parallel" in out.stdout
        again = _launch(*common, *flag, "--steps", "3")
        assert again.returncode == 0, again.stderr
        assert "resumed from step 2" in again.stdout
    elif flag[0] == "--device-count":
        out = _launch(*common, "--debug-mesh", "2,2", "--device-count", "2")
        assert out.returncode != 0
        assert ("Number of devices 2 must be >= the product of mesh_shape "
                "(2, 2)") in out.stderr
        out = _launch(*common, "--debug-mesh", "2,2", *flag, "--steps", "1")
        assert out.returncode == 0, out.stderr
    else:
        out = _launch(*common, *flag)
        assert out.returncode != 0
        assert "needs a process group of 512 ranks" in out.stderr
    assert "not ported" not in out.stderr
