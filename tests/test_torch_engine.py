"""The port's ServingEngine against the JAX ServingEngine on the CPU, for
the verify recipe's serve run (llama3.2-1b smoke + SWAT window 64,
5 requests, 2 slots, prompt 70, 12 new tokens, max_len 256, scan_steps 8):
greedy tokens must be identical to the JAX engine's with decode_impl "ref"
and "pallas"."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config, with_swat
from repro.core import model as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import with_swat as t_swat
from repro_torch.serving.engine import Request, ServingEngine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = with_swat(get_smoke_config("llama3.2-1b"), window=64, num_global=4)
    tcfg = t_swat(t_smoke("llama3.2-1b"), window=64, num_global=4)
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (70,)).astype(np.int32)
               for _ in range(5)]
    return cfg, tcfg, jp, tp, prompts


def _port_run(tcfg, tp, prompts, **kw):
    eng = ServingEngine(tcfg, tp, batch_slots=2, max_len=256,
                        **{"scan_steps": 8, **kw})
    return eng, eng.run([Request(rid=i, prompt=p, max_new_tokens=12)
                         for i, p in enumerate(prompts)])


@pytest.mark.parametrize("decode_impl", ["ref", "pallas"])
def test_greedy_tokens_equal_jax_engine(setup, decode_impl):
    cfg, tcfg, jp, tp, prompts = setup
    jeng = JEngine(cfg, jp, batch_slots=2, max_len=256, scan_steps=8,
                   decode_impl=decode_impl)
    want = jeng.run([JRequest(rid=i, prompt=p, max_new_tokens=12)
                     for i, p in enumerate(prompts)])
    eng, got = _port_run(tcfg, tp, prompts)
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert g.status == w.status == "ok"
        assert g.tokens == w.tokens, (g.rid, g.tokens, w.tokens)
    assert eng.stats["tokens_delivered"] == 60


def test_block_decode_equals_stepwise(setup):
    """scan_steps changes only the host-sync cadence: sampled and greedy
    tokens are identical at scan_steps 1 and 8."""
    _, tcfg, _, tp, prompts = setup

    def run(steps):
        eng = ServingEngine(tcfg, tp, batch_slots=2, max_len=256,
                            scan_steps=steps, seed=5)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=7,
                        temperature=[0.0, 2.0][i % 2])
                for i, p in enumerate(prompts[:4])]
        return [r.tokens for r in eng.run(reqs)]

    assert run(1) == run(8)


def test_rejections_and_prompt_only_requests(setup):
    _, tcfg, _, tp, prompts = setup
    eng = ServingEngine(tcfg, tp, batch_slots=2, max_len=256,
                        max_prompt_len=64)
    res = eng.run([Request(rid=0, prompt=prompts[0][:10], max_new_tokens=1),
                   Request(rid=1, prompt=prompts[1], max_new_tokens=3),
                   Request(rid=2, prompt=[], max_new_tokens=3),
                   Request(rid=3, prompt=prompts[2][:20], max_new_tokens=3)])
    assert [r.status for r in res] == ["ok", "rejected", "rejected", "ok"]
    assert len(res[0].tokens) == 1 and len(res[3].tokens) == 3
    assert eng.stats["rejected"] == 2


def test_non_finite_rows_are_quarantined(setup):
    """A slot whose logits go non-finite is finalized as "poisoned" with
    the tokens emitted before; the other slot is untouched."""
    _, tcfg, _, tp, prompts = setup
    reqs = lambda: [Request(rid=i, prompt=p, max_new_tokens=6)
                    for i, p in enumerate(prompts[:2])]
    clean = ServingEngine(tcfg, tp, batch_slots=2, max_len=256).run(reqs())
    eng = ServingEngine(tcfg, tp, batch_slots=2, max_len=256)
    eng._admit(__import__("collections").deque(reqs()))
    for blk in eng.caches:                   # poison slot 1's K rings
        for layer in blk.values():
            layer["k"][1] = float("nan")
    while not all(eng.slot_free):
        eng._decode_block(eng._block_len())
    res = eng.take_completed()
    assert res[0].status == "ok" and res[0].tokens == clean[0].tokens
    assert res[1].status == "poisoned"
    assert res[1].tokens == clean[1].tokens[:1]
    assert eng.stats["quarantined"] == 1


@pytest.mark.parametrize("option", [dict(kv_layout="paged"),
                                    dict(mesh="4x1"),
                                    dict(faults=object()),
                                    dict(metrics=True)],
                         ids=lambda o: next(iter(o)))
def test_unported_options_raise(setup, option):
    _, tcfg, _, tp, _ = setup
    with pytest.raises(NotImplementedError):
        ServingEngine(tcfg, tp, batch_slots=2, max_len=256, **option)
