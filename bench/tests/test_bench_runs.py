"""Whole runs of each cell at a tiny size on the CPU (the harness's look
for a card skipped): a sound run comes out correct; the same run with
the timed path broken underneath, or the fp8 control in the program's
place, comes out not correct. On a card, one short run of each cell
through bench/run.py."""
import json
import subprocess
import sys

import pytest
import torch

from bench import harness as H
from bench import serving as S
from bench.reference import compare, lm
from conftest import CELLS, ROOT, tiny_spec

SEED = 2**31 + 101


def _run(spec, trace=False, seconds=1.0):
    return H.run_driver(spec, SEED, seconds, trace, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out, reading = _run(tiny_spec(cell))
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    metrics = H.read_metrics(tiny_spec(cell), reading)
    assert set(metrics) == {m["name"] for m in H.Spec.load(cell,
                                                           False).metrics}
    assert all(v["value"] > 0 for v in metrics.values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_trace(cell):
    spec = tiny_spec(cell, trace=True)
    out, reading = _run(spec, trace=True)
    assert out.correct
    assert reading.trace is not None and reading.trace.window_s > 0
    metrics = H.read_metrics(spec, reading)
    # the CPU has no device operations: only the host's metrics read
    assert all(m.startswith(("mfu.", "decode_step_ms", "prefill_share"))
               for m in metrics), metrics
    bd = H.breakdown(reading.trace)
    assert bd["idle_gaps"] and len(bd["device_ops"]) <= 10


def _alter_tokens(monkeypatch):
    """Served tokens altered where they are produced: every 7th call of
    the sampler moves each row's pick to the next vocabulary id."""
    from repro_torch.serving import sampling
    plain = sampling.sample
    state = {"n": 0}

    def sample(*a, **k):
        out = plain(*a, **k)
        state["n"] += 1
        if state["n"] % 7 == 0:
            out = (out + 1) % 256
        return out

    monkeypatch.setattr(sampling, "sample", sample)


@pytest.mark.parametrize("cell", CELLS[:2])
def test_an_altered_token_is_not_correct(cell, monkeypatch):
    _alter_tokens(monkeypatch)
    out, _ = _run(tiny_spec(cell), seconds=2.0)
    assert not out.correct, out.checks


def _fault_step(kind):
    from repro_torch.launch import steps
    plain = steps.make_train_step

    def make(cfg, opt_cfg, **kw):
        step = plain(cfg, opt_cfg, **kw)

        def faulty(params, opt, batch):
            if kind == "half_batch":
                half = batch["tokens"].shape[0] // 2
                return step(params, opt, {k: v[:half]
                                          for k, v in batch.items()})
            keep = [t.clone() for t in _leaves(params, opt)]
            out = step(params, opt, batch)
            for t, k in zip(_leaves(params, opt), keep):
                t.copy_(k)                     # the state left unchanged
            return out
        return faulty
    return make


def _leaves(params, opt):
    from repro_torch import tree
    return tree.leaves(params) + tree.leaves(opt.mu) + tree.leaves(opt.nu)


@pytest.mark.parametrize("kind", ["unchanged_state", "half_batch"])
def test_a_faulty_train_step_is_not_correct(kind, monkeypatch):
    from repro_torch.launch import steps
    monkeypatch.setattr(steps, "make_train_step", _fault_step(kind))
    out, _ = _run(tiny_spec(CELLS[2]))
    assert not out.correct, out.checks


@pytest.mark.parametrize("cell", CELLS[:2])
def test_the_serving_control_is_not_correct(cell):
    """fp8 in the program's place, at each position of 8 requests the
    program served to the end, the gap of the token fp8 puts first: over
    the tiny limit, where the program's own gap is under it."""
    from repro_torch.serving.engine import ServingEngine
    from bench import weights as Wt
    from bench.traffic import generate
    from bench.work import Shape
    spec = tiny_spec(cell)
    shape = Shape.from_config(spec.config)
    params = Wt.make(shape, SEED, "cpu")
    eng = ServingEngine(S.port_config(spec.config, check=False), params,
                        seed=0, **spec.cell["engine"])
    prompts = generate.serve_requests(spec.cell["traffic"], SEED,
                                      shape.vocab)[:8]
    served = {r.rid: r.tokens for r in eng.run(S.requests(prompts))}
    lm.exact_fp32()
    args = (params, [p.tokens for p in prompts],
            [served[p.rid] for p in prompts], "cpu")
    model = lm.Model.from_config(spec.config)
    program = max(float(g.max()) for g in S.served_gaps(model, *args))
    control = max(float(g.max()) for g in S.served_gaps(
        model, *args, control=lm.Model.from_config(spec.config, "fp8")))
    limit = spec.cell["check"]["limits"]["max_logit_gap"]
    assert program <= limit < control, (program, control)


def test_the_training_control_is_not_correct():
    from bench.traffic import generate
    from bench.work import Shape
    spec = tiny_spec(CELLS[2])
    drv = H.load_module(ROOT / "bench" / "drivers" / "train.py", "t_ctl")
    h = H.Harness(spec=spec, seed=SEED, window=None, device="cpu")
    shape = Shape.from_config(spec.config)
    fn = generate.train_batches(spec.cell["traffic"], SEED, shape.vocab)
    ref = drv.reference(h, shape, fn)
    gaps = compare.train_gaps(drv.reference(h, shape, fn, prec="fp8"), ref)
    lim = spec.cell["check"]["limits"]
    assert any(gaps[k] > lim[k] for k in lim), gaps


def test_q8_rounds_to_e4m3():
    x = torch.tensor([448.0, 1.0, 0.1, -3.3])
    r = lm.q8(x)
    assert r[0] == 448.0 and r[1] == 1.0
    assert float(r[2]) != 0.1 and abs(float(r[2]) - 0.1) < 0.01


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell, card):
    res = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "5", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert line["device"]["platform"] == "gpu" and line["correct"]
