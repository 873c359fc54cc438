"""Fixtures of the benchmark's CPU tests: the benchmark's cells at a tiny
size that the CPU runs in seconds (the plain versions of the port's
kernels), and the `chip` marker for the cases that need a CUDA card.

    python -m pytest -q bench/tests
"""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness as H  # noqa: E402

CELLS = ("granite-8b-swat.decode-long", "granite-8b-swat.prefill-long",
         "granite-moe-swat.train-16k")
# tiny limits, read from these sizes' sound runs and controls (served:
# program 0.0000-0.0028, fp8 0.049-0.130 over 8 requests, seeds 0-4)
TINY_LIMITS = {"max_logit_gap": 0.02, "loss_gap": 0.01, "grad_gap": 0.06,
               "change_gap": 0.06}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")


def tiny_config(name: str) -> dict:
    c = H.load_json(ROOT / "bench" / "configs" / f"{name}.json")
    c.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, vocab_size=256,
             swat={"window": 16, "num_global": 4})
    if "attention_multiplier" in c:
        c["attention_multiplier"] = 16 ** -0.5
    if c["num_local_experts"]:
        c.update(num_local_experts=4, num_experts_per_tok=2,
                 intermediate_size=32)
    else:
        c["intermediate_size"] = 128
    return c


def tiny_spec(name: str, trace: bool = False) -> H.Spec:
    """The workload at a tiny size: a backlog that outlasts a 1 s window,
    short prompts that still wrap the 21-row rings."""
    full = H.Spec.load(name, trace)
    cell = copy.deepcopy(full.cell)
    drv = cell["driver"]
    if drv == "serve_stream":
        cell["traffic"].update(requests=800, cycle=8, prompt_len=[16, 48],
                               output_len=[4, 24])
        cell["engine"].update(batch_slots=4, max_len=128)
        cell["ramp_steps"] = 8
    elif drv == "serve_burst":
        cell["traffic"].update(requests=1600, cycle=16, prompt_len=[16, 64])
        cell["engine"].update(max_len=128, max_prefill_tokens=128)
        cell["check"]["sample"] = 4
    else:
        cell["traffic"].update(batch=2, seq_len=64)
    cell["trace_seconds"] = 0.5
    cell["check"]["limits"] = {k: TINY_LIMITS[k]
                               for k in cell["check"]["limits"]}
    return H.Spec(full.workload, cell, tiny_config(full.workload["config"]),
                  full.metrics)


@pytest.fixture
def tiny():
    return tiny_spec
