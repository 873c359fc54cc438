"""The port's serve launcher on the CPU: every flag value under which the
JAX launcher runs its default behavior runs, `--decode-impl` maps to the
engine's `decode_impl` (the kernel route refuses the CPU), and the paged
layout with prefix sharing serves the JAX launcher's shared-prefix demo
workload, and the resilience flags report what they did. Each case is one
launcher process on a smoke config."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE = ("--arch", "llama3.2-1b", "--smoke", "--swat", "--window", "16",
         "--requests", "3", "--slots", "2", "--prompt-len", "40",
         "--new-tokens", "6", "--max-len", "128", "--device", "cpu")


def _serve(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *SMOKE, *args], capture_output=True, text=True,
                          env=env, timeout=300)


@pytest.mark.parametrize("flag", [["--kv-layout", "contiguous"],
                                  ["--profile", "tp"],
                                  ["--max-pending", "0"],
                                  ["--deadline", "0"],
                                  ["--chaos-poison-step", "3"],
                                  ["--decode-impl", "ref"]],
                         ids=lambda f: f[0].lstrip("-"))
def test_jax_default_values_run(flag):
    """The JAX launcher's default of each flag (and its plain decode impl)
    serves on the port; the summary names the decode impl."""
    out = _serve(*flag)
    assert out.returncode == 0, out.stderr
    assert "3 requests / 18 tokens" in out.stdout
    assert "decode_impl=ref, kv_layout=contiguous" in out.stdout


def test_decode_impl_pallas_refuses_the_cpu():
    """`--decode-impl pallas` is the CUDA kernel: on `--device cpu` the
    launcher exits non-zero with a message and serves nothing (no silent
    plain version)."""
    out = _serve("--decode-impl", "pallas")
    assert out.returncode != 0
    assert "decode_impl='pallas' runs the CUDA decode kernel" in out.stderr
    assert "requests /" not in out.stdout


def test_paged_share_prefix_runs():
    """`--kv-layout paged --share-prefix --prefill-chunk 8` serves the
    shared-system-prompt workload, shares the prefix of each admission
    batch, and prints the paged pool line: 3 prompts of 24 shared + 16
    tokens on 2 slots prefill 24 + 2 x 16 tokens in the first batch and 40
    in the second, which holds one row and shares nothing."""
    out = _serve("--kv-layout", "paged", "--share-prefix",
                 "--prefill-chunk", "8")
    assert out.returncode == 0, out.stderr
    assert "3 requests / 18 tokens" in out.stdout
    assert "kv_layout=paged" in out.stdout
    pool = [l for l in out.stdout.splitlines() if "paged pool:" in l]
    assert len(pool) == 1, out.stdout
    assert "prefixes shared=1, prefill tokens computed=96" in pool[0], pool


@pytest.mark.parametrize("flags,want", [
    (["--max-pending", "2"], "rejected=1"),
    (["--deadline", "0.000001"], "deadline=3"),
    (["--chaos-poison-slot", "0"], "poisoned=1")],
    ids=["max-pending", "deadline", "chaos-poison-slot"])
def test_resilience_flags_run(flags, want):
    """`--max-pending 2` sheds the third request (queue overflow), a
    deadline of a microsecond expires every request in the queue, and
    `--chaos-poison-slot 0` quarantines slot 0's request at token 3: each
    run exits 0 and prints its statuses, its degradation events and every
    request that did not end ok."""
    out = _serve(*flags)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    (status,) = [l for l in lines if l.startswith("[serve] statuses: ")]
    assert want in status, status
    events = [l for l in lines if l.startswith("[serve] degradation event")]
    kind = {"max-pending": "request_rejected", "deadline": "deadline_expired",
            "chaos-poison-slot": "slot_quarantined"}[flags[0][2:]]
    assert any(kind in l for l in events), events
    assert any(l.startswith("[serve]   rid ") for l in lines), lines
