"""The port's "attn_moe" layer kind against the JAX package on the CPU:
granite-moe-1b-a400m and moonshot-v1-16b-a3b smoke configs (4 experts,
top-2, fp32), each plain and with SWAT (window 16, 4 globals), params
converted from the JAX pytree. forward_logits, loss_fn (total, loss,
aux_loss and every grad leaf), prefill, prefill_chunk, decode_step at T=1
and T=3, the paged layout and the interop round trip; then the
ServingEngine against the JAX engine (greedy tokens, statuses, shared
stats) sequential, chunked, speculative, paged with a shared prefix and
under a fault plan; and both launchers. fp32 tolerance atol 2e-5 / rtol
1e-4; ring steps and tables exactly."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config, with_swat
from repro.core import model as JM
from repro.serving import faults as JF
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch import tree
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import with_swat as t_swat
from repro_torch.core import model as TM
from repro_torch.serving import faults as TF
from repro_torch.serving.engine import Request, ServingEngine

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(atol=2e-5, rtol=1e-4)
CASES = ("granite", "granite_swat", "moonshot", "moonshot_swat")
ARCH = {"granite": "granite-moe-1b-a400m", "moonshot": "moonshot-v1-16b-a3b"}


def _configs(case):
    arch = ARCH[case.split("_")[0]]
    cfg, tcfg = get_smoke_config(arch), t_smoke(arch)
    if case.endswith("swat"):
        cfg = with_swat(cfg, window=16, num_global=4)
        tcfg = t_swat(tcfg, window=16, num_global=4)
    return cfg, tcfg


def _build(case):
    cfg, tcfg = _configs(case)
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree.map(np.asarray, jp)
    return cfg, tcfg, jp, np_params, interop.params_from_jax(
        np_params, tcfg, device="cpu")


@pytest.fixture(scope="module", params=CASES)
def model(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def granite_swat():
    return _build("granite_swat")


def _compare_caches(tc, jc, leaves=("k", "v")):
    got = interop.caches_to_numpy(tc)
    want = jax.tree.map(np.asarray, jc)
    for name in want:
        np.testing.assert_array_equal(got[name]["step"], want[name]["step"])
        for leaf in leaves:
            assert got[name][leaf].shape == want[name][leaf].shape
            np.testing.assert_allclose(got[name][leaf], want[name][leaf],
                                       **F32, err_msg=f"{name}/{leaf}")


# ----------------------------------------------------------- the model ----

def test_config_is_moe_and_params_match_jax_layout(model):
    """init_model accepts the attn_moe kind and lays out the JAX leaves:
    norm2 and moe (router fp32 (D, E), w1/w3 (E, D, F), w2 (E, F, D)), no
    mlp."""
    cfg, tcfg, _, np_params, _ = model
    assert tcfg.layer_pattern == ("attn_moe",) and tcfg.moe.enabled
    tp = TM.init_model(tcfg, seed=0, device="cpu")
    got = dict(tree.flatten_with_paths(interop.params_to_numpy(tp, tcfg)))
    want = dict(tree.flatten_with_paths(np_params))
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape for k in want)
    layer = tp["blocks"][0]["l0"]
    assert "mlp" not in layer and set(layer["moe"]) == {"router", "w1",
                                                        "w2", "w3"}
    e, d, f = tcfg.moe.num_experts, tcfg.d_model, tcfg.d_ff
    assert layer["moe"]["router"].shape == (d, e)
    assert layer["moe"]["w1"].shape == layer["moe"]["w3"].shape == (e, d, f)
    assert layer["moe"]["w2"].shape == (e, f, d)


def test_forward_logits_match(model):
    cfg, tcfg, jp, _, tp = model
    tok = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 40))
    want, _ = JM.forward_logits(jp, cfg, {"tokens": jnp.asarray(tok)},
                                remat=False)
    got = TM.forward_logits(tp, tcfg, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_loss_aux_and_every_grad_leaf_match_jax(model):
    """Total, loss and aux_loss (the Switch loss summed over layers, sort
    dispatch, weighted 0.01 into the total) and every gradient leaf,
    experts and routers included, against jax.value_and_grad."""
    cfg, tcfg, jp, np_params, _ = model
    rng = np.random.RandomState(4)
    tok = rng.randint(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    labels = tok.copy()
    labels[0, 7:11] = -1
    (jtotal, jm), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg, {"tokens": jnp.asarray(tok),
                                      "labels": jnp.asarray(labels)}),
        has_aux=True)(jp)
    tp = interop.params_from_jax(np_params, tcfg, device="cpu")
    leaves = tree.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    total, metrics = TM.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(tok),
                                           "labels": torch.from_numpy(labels)})
    grads = tree.unflatten(tp, list(torch.autograd.grad(total, leaves)))
    np.testing.assert_allclose(float(total.detach()), float(jtotal), **F32)
    assert float(metrics["aux_loss"].detach()) > 0
    for k in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   **F32, err_msg=k)
    got = dict(tree.flatten_with_paths(interop.params_to_numpy(grads, tcfg)))
    want = dict(tree.flatten_with_paths(jax.tree.map(np.asarray, jg)))
    assert got.keys() == want.keys()
    assert {k.rsplit("/", 1)[1] for k in want if "/moe/" in k} == {
        "router", "w1", "w2", "w3"}
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, **F32, err_msg=str(path))


def test_prefill_and_decode_across_ring_wrap(model):
    """Padded batched prefill (ragged lengths), then six T=1 decode steps:
    the SWAT rows (ring capacity 21) cross their wrap point."""
    cfg, tcfg, jp, _, tp = model
    rng = np.random.RandomState(1)
    tok = rng.randint(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    lengths = np.asarray([18, 24], np.int32)
    jl, jc = JM.prefill(jp, cfg, {"tokens": jnp.asarray(tok)}, 64,
                        lengths=jnp.asarray(lengths))
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)}, 64,
                        lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _compare_caches(tc, jc)
    nxt = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
    for _ in range(6):
        jl, jc = JM.decode_step(jp, cfg,
                                {"tokens": jnp.asarray(nxt)[:, None]}, jc)
        tl, tc = TM.decode_step(tp, tcfg,
                                {"tokens": torch.from_numpy(nxt)[:, None]},
                                tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
        nxt = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
    _compare_caches(tc, jc)


def test_multi_token_decode_on_a_lookahead_ring(model):
    """T=3 decode steps (a verify step's shape) on caches with lookahead 2."""
    cfg, tcfg, jp, _, tp = model
    rng = np.random.RandomState(2)
    tok = rng.randint(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    _, jc = JM.prefill(jp, cfg, {"tokens": jnp.asarray(tok)}, 64,
                       lookahead=2)
    _, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)}, 64,
                       lookahead=2)
    for _ in range(2):
        nxt = rng.randint(0, cfg.vocab_size, (2, 3)).astype(np.int32)
        jl, jc = JM.decode_step(jp, cfg, {"tokens": jnp.asarray(nxt)}, jc,
                                lookahead=2)
        tl, tc = TM.decode_step(tp, tcfg, {"tokens": torch.from_numpy(nxt)},
                                tc, lookahead=2)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _compare_caches(tc, jc)


def test_prefill_chunks_match(model):
    """Four chunks of 8 from fresh caches (row 1 ends inside chunk 3):
    caches, and the chunk's hidden states as the engine reads them (through
    the final norm and the head: the fp32 logits), after every chunk. The
    raw residual stream is not compared at atol 2e-5 / rtol 1e-4: at these
    configs' expert init (scale E^-1/2 = 0.5) it reaches |x| ~ 70, where
    fp32 summation order alone moves an element near zero by ~1e-4."""
    cfg, tcfg, jp, _, tp = model
    rng = np.random.RandomState(3)
    tok = rng.randint(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    lens = np.asarray([32, 21], np.int32)
    jc = JM.init_caches(cfg, 2, 64)
    tc = TM.init_caches(tcfg, 2, 64, device="cpu")
    for p in range(0, 32, 8):
        jx, jc = JM.prefill_chunk(jp, cfg, {"tokens": jnp.asarray(
            tok[:, p:p + 8])}, jc, p, jnp.asarray(lens))
        tx = TM.prefill_chunk(tp, tcfg, {"tokens": torch.from_numpy(
            tok[:, p:p + 8])}, tc, p, torch.from_numpy(lens))
        np.testing.assert_allclose(TM._unembed(tp, tcfg, tx).numpy(),
                                   np.asarray(JM._unembed(jp, cfg, jx)),
                                   **F32)
        _compare_caches(tc, jc)


def test_paged_decode_matches(model):
    """Paged caches (block pools and one shared table a layer position)
    from `init_caches(paged=True)` and JAX's `init_paged_caches`: five T=1
    decode steps from a fresh cache, logits and pools."""
    cfg, tcfg, jp, _, tp = model
    jc = JM.init_paged_caches(cfg, 2, 64)
    tc = TM.init_caches(tcfg, 2, 64, paged=True, device="cpu")
    rng = np.random.RandomState(5)
    for _ in range(5):
        nxt = rng.randint(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = JM.decode_step(jp, cfg, {"tokens": jnp.asarray(nxt)}, jc)
        tl, tc = TM.decode_step(tp, tcfg, {"tokens": torch.from_numpy(nxt)},
                                tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _compare_caches(tc, jc, leaves=("pk", "pv", "table"))


def test_interop_round_trip_is_bitwise_with_an_fp32_router():
    """bf16 granite-moe + SWAT: JAX params -> port -> numpy are bitwise the
    JAX leaves; the router stays fp32 and the experts bf16."""
    cfg, tcfg = _configs("granite_swat")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    want = jax.tree.map(np.asarray, JM.init_model(jax.random.PRNGKey(1), cfg))
    tp = interop.params_from_jax(want, tcfg, device="cpu")
    moe = tp["blocks"][0]["l0"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert {moe[w].dtype for w in ("w1", "w2", "w3")} == {torch.bfloat16}
    got = dict(tree.flatten_with_paths(interop.params_to_numpy(tp, tcfg)))
    flat = dict(tree.flatten_with_paths(want))
    assert got.keys() == flat.keys()
    for path, w in flat.items():
        np.testing.assert_array_equal(got[path], w.astype(np.float32),
                                      err_msg=str(path))


def test_mamba_kinds_still_raise():
    """The mamba kinds no longer raise (the name is the MoE slice's, when
    they did): both mamba configs initialise with the JAX package's leaf
    paths, shapes and dtypes (bf16), jamba's plain mamba layers with a
    dense MLP and its mamba_moe layers with the experts."""
    for arch in ("mamba2_1p3b", "jamba_1p5_large"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
        tcfg = dataclasses.replace(t_smoke(arch), dtype="bfloat16")
        want = dict(tree.flatten_with_paths(jax.tree.map(
            np.asarray, JM.init_model(jax.random.PRNGKey(0), cfg))))
        tp = TM.init_model(tcfg, seed=0, device="cpu")
        shapes = dict(tree.flatten_with_paths(
            interop.params_to_numpy(tp, tcfg)))
        assert shapes.keys() == want.keys(), arch
        # the port's "blocks/<super-block>/..." leaves by the JAX path
        dtypes = {("blocks/" + p.split("/", 2)[2]
                   if p.startswith("blocks/") else p):
                  str(t.dtype).split(".")[-1]
                  for p, t in tree.flatten_with_paths(tp)}
        for path, w in want.items():
            assert shapes[path].shape == w.shape, (arch, path)
            assert dtypes[path] == w.dtype.name, (arch, path)
        for i, kind in enumerate(tcfg.layer_pattern):
            layer = tp["blocks"][0][f"l{i}"]
            assert ("moe" in layer) == kind.endswith("_moe")
            assert ("mlp" in layer) == (not kind.endswith("_moe")
                                        and tcfg.d_ff > 0)


# ---------------------------------------------------------- the engine ----

def _prompts(cfg, seed=0, n=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, (int(l),)).astype(np.int32)
            for l in rng.randint(8, 40, n)]


def _shared_prompts(cfg, seed=7, n=4, sys_len=40):
    rng = np.random.RandomState(seed)
    sys_p = rng.randint(0, cfg.vocab_size, (sys_len,)).astype(np.int32)
    return [np.concatenate([sys_p, rng.randint(0, cfg.vocab_size, (8,))
                            .astype(np.int32)]) for _ in range(n)]


ENGINE_CELLS = {
    "sequential": ({}, _prompts),
    "chunked": ({"prefill_chunk": 16}, _prompts),
    "speculative": ({"speculative": 3}, _prompts),
    "paged_shared": ({"kv_layout": "paged", "share_prefix": True,
                      "prefill_chunk": 16}, _shared_prompts),
}


def _serve_both(s, kw, prompts, n_new=10, faults=None):
    """The JAX engine and the port's engine serve `prompts` (greedy, 2
    slots): (port engine, port results, JAX engine, JAX results)."""
    cfg, tcfg, jp, _, tp = s
    common = dict(batch_slots=2, max_len=128, scan_steps=4, **kw)
    jeng = JEngine(cfg, jp, faults=JF.FaultPlan(**faults) if faults else None,
                   **common)
    jres = jeng.run([JRequest(rid=i, prompt=p, max_new_tokens=n_new)
                     for i, p in enumerate(prompts)])
    teng = ServingEngine(tcfg, tp,
                         faults=TF.FaultPlan(**faults) if faults else None,
                         **common)
    tres = teng.run([Request(rid=i, prompt=p, max_new_tokens=n_new)
                     for i, p in enumerate(prompts)])
    return teng, tres, jeng, jres


def _assert_engine_parity(teng, tres, jeng, jres):
    key = lambda r: r.rid
    got = [(r.rid, r.status, list(r.tokens)) for r in sorted(tres, key=key)]
    want = [(r.rid, r.status, list(r.tokens)) for r in sorted(jres, key=key)]
    assert got == want
    assert {k: teng.stats[k] for k in jeng.stats} == dict(jeng.stats)


@pytest.mark.parametrize("cell", sorted(ENGINE_CELLS))
def test_engine_equals_jax_engine(granite_swat, cell):
    """granite-moe + SWAT: greedy tokens, statuses and every shared stat
    equal the JAX engine's in each serving cell (the MoE layers run the
    dense dispatch at every serving site in both)."""
    kw, prompts = ENGINE_CELLS[cell]
    run = _serve_both(granite_swat, kw, prompts(granite_swat[0]))
    _assert_engine_parity(*run)
    assert all(r.status == "ok" for r in run[1])
    if cell == "speculative":
        assert run[0].stats["spec_steps"] > 0
    if cell == "paged_shared":
        assert run[0].stats["prefill_prefix_shared"] >= 1


@pytest.mark.parametrize("kw", [{}, {"speculative": 2}],
                         ids=["sequential", "speculative"])
def test_moonshot_engine_equals_jax_engine(kw):
    """moonshot-v1-16b-a3b (dense attention, 16 kv heads at full size)."""
    s = _build("moonshot")
    _assert_engine_parity(*_serve_both(s, kw, _prompts(s[0], seed=1)))


def test_fault_plan_nan_on_slot_1_at_token_3(granite_swat):
    """NaN on slot 1 at token 3: that request ends "poisoned" with its 3
    clean tokens, as in the JAX engine; the other requests are bitwise the
    JAX engine's."""
    prompts = _prompts(granite_swat[0], seed=2, n=4)
    try:
        run = _serve_both(granite_swat, {}, prompts,
                          faults=dict(poison_logits=((1, 3, "nan"),)))
    finally:
        TF.consume_events()
        JF.consume_events()
    _assert_engine_parity(*run)
    statuses = [r.status for r in sorted(run[1], key=lambda r: r.rid)]
    assert statuses.count("poisoned") == 1
    bad = next(r for r in run[1] if r.status == "poisoned")
    assert len(bad.tokens) == 3
    assert run[0].stats["quarantined"] == 1


# ------------------------------------------------------- the launchers ----

def _launch(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env,
                          timeout=300)


def test_serve_launcher_serves_granite_moe():
    out = _launch("repro_torch.launch.serve", "--arch",
                  "granite-moe-1b-a400m", "--smoke", "--swat", "--window",
                  "16", "--requests", "3", "--slots", "2", "--prompt-len",
                  "40", "--new-tokens", "6", "--max-len", "128",
                  "--prefill-chunk", "16", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "[serve] statuses: ok=3" in out.stdout
    assert "3 requests / 18 tokens" in out.stdout


def test_train_launcher_trains_granite_moe_and_prints_aux(tmp_path):
    out = _launch("repro_torch.launch.train", "--arch",
                  "granite-moe-1b-a400m", "--smoke", "--steps", "2",
                  "--batch", "2", "--seq", "64", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path / "ck"))
    assert out.returncode == 0, out.stderr
    line = next(l for l in out.stdout.splitlines()
                if l.startswith("[train] step"))
    aux = float(line.split("aux_loss=")[1].split()[0])
    assert np.isfinite(aux) and aux > 0
    assert "[train] done" in out.stdout
