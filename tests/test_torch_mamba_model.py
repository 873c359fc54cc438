"""The port's "mamba" and "mamba_moe" layer kinds against the JAX package on
the CPU: the mamba2-1.3b smoke config (attention-free) and the
jamba-1.5-large smoke config + SWAT (window 16, 4 globals; a period-8
super-block of 7 mamba layers, 4 of them with experts, and one attention
layer), fp32, params converted from the JAX pytree. forward_logits, loss_fn
(total, loss, aux_loss and every grad leaf), prefill with `lengths` and
decode_step (logits and caches, ring steps exactly), the paged layout, the
interop round trip and the T > 1 refusal; then the ServingEngine against
the JAX engine (greedy tokens, statuses, shared stats) contiguous and
paged on both configs and under `fail_pallas_dispatch` on jamba (one
super-block), F5's `ring_cache_bytes`, and the three launcher runs. fp32
tolerance atol 2e-5 / rtol 1e-4."""
import collections
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

from repro.configs import get_config, get_smoke_config, with_swat
from repro.configs import ARCH_IDS, PAPER_IDS
from repro.core import model as JM
from repro.serving import engine as JE
from repro.serving import faults as JF
from repro_torch import interop
from repro_torch import tree
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import with_swat as t_swat
from repro_torch.core import model as TM
from repro_torch.kernels import swat_decode as SD
from repro_torch.serving import engine as TE
from repro_torch.serving import faults as TF

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(atol=2e-5, rtol=1e-4)
CASES = ("mamba2", "jamba_swat")
ARCH = {"mamba2": "mamba2_1p3b", "jamba": "jamba_1p5_large"}


def _configs(case, num_layers=None):
    arch = ARCH[case.split("_")[0]]
    cfg, tcfg = get_smoke_config(arch), t_smoke(arch)
    if case.endswith("swat"):
        cfg = with_swat(cfg, window=16, num_global=4)
        tcfg = t_swat(tcfg, window=16, num_global=4)
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
        tcfg = dataclasses.replace(tcfg, num_layers=num_layers)
    return cfg, tcfg


def _build(case, num_layers=None):
    cfg, tcfg = _configs(case, num_layers)
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree.map(np.asarray, jp)
    return cfg, tcfg, jp, np_params, interop.params_from_jax(
        np_params, tcfg, device="cpu")


@pytest.fixture(scope="module", params=CASES)
def model(request):
    return _build(request.param)


def _serving_builds():
    """The engine cells' models: mamba2 smoke, and jamba smoke + SWAT cut
    to one super-block (8 layers)."""
    return {"mamba2": _build("mamba2"), "jamba_swat": _build("jamba_swat", 8)}


@pytest.fixture(scope="module")
def serving():
    return _serving_builds()


def _compare_caches(tc, jc):
    """Every leaf of every layer: ring steps exactly, the rest (K/V rows,
    pools, conv windows, SSM states) within F32; tables exactly."""
    got = interop.caches_to_numpy(tc)
    want = jax.tree.map(np.asarray, jc)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys(), name
        for leaf, w in want[name].items():
            assert got[name][leaf].shape == w.shape, (name, leaf)
            if leaf in ("step", "table"):
                np.testing.assert_array_equal(got[name][leaf], w)
            else:
                np.testing.assert_allclose(got[name][leaf], w, **F32,
                                           err_msg=f"{name}/{leaf}")


# ----------------------------------------------------------- the model ----

def test_forward_logits_match(model):
    cfg, tcfg, jp, _, tp = model
    tok = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 40))
    want, _ = JM.forward_logits(jp, cfg, {"tokens": jnp.asarray(tok)},
                                remat=False)
    got = TM.forward_logits(tp, tcfg, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_loss_aux_and_every_grad_leaf_match_jax(model):
    """Total, loss and aux_loss (jamba's mamba_moe layers add the Switch
    loss; mamba2 has none) and every gradient leaf, the SSM's fp32 a_log,
    d_skip and dt_bias included, against jax.value_and_grad at the smoke
    chunk (16)."""
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
    assert (float(metrics["aux_loss"].detach()) > 0) == tcfg.moe.enabled
    for k in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   **F32, err_msg=k)
    got = dict(tree.flatten_with_paths(interop.params_to_numpy(grads, tcfg)))
    want = dict(tree.flatten_with_paths(jax.tree.map(np.asarray, jg)))
    assert got.keys() == want.keys()
    assert {"a_log", "d_skip", "dt_bias", "conv_w"} <= {
        k.rsplit("/", 1)[1] for k in want if "/mixer/" in k}
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, **F32, err_msg=str(path))


def test_prefill_with_lengths_and_decode(model):
    """Padded batched prefill (row 0 stops at 18 of 24 tokens: its SSM
    state freezes there and its conv window is gathered per row), then six
    T=1 decode steps: logits after each, and every cache leaf at the end
    (jamba's SWAT ring, capacity 21, crosses its wrap point)."""
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


def test_paged_decode_matches(model):
    """`init_caches(paged=True)` against JAX's `init_paged_caches`: the
    mamba leaves stay unpaged, the attention layer holds pools and one
    shared table; five T=1 decode steps from a fresh cache."""
    cfg, tcfg, jp, _, tp = model
    jc = JM.init_paged_caches(cfg, 2, 64)
    tc = TM.init_caches(tcfg, 2, 64, paged=True, device="cpu")
    assert TM.paged_layout(tcfg, 64).keys() == JM.paged_layout(cfg, 64).keys()
    rng = np.random.RandomState(5)
    for _ in range(5):
        nxt = rng.randint(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = JM.decode_step(jp, cfg, {"tokens": jnp.asarray(nxt)}, jc)
        tl, tc = TM.decode_step(tp, tcfg, {"tokens": torch.from_numpy(nxt)},
                                tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _compare_caches(tc, jc)


def test_multi_token_decode_refused(model):
    """A T > 1 step raises on a config with a mamba layer (the JAX
    decode_step asserts it), before any cache is written."""
    _, tcfg, _, _, tp = model
    tc = TM.init_caches(tcfg, 2, 64, lookahead=2, device="cpu")
    before = [t.clone() for blk in tc for c in blk.values()
              for t in c.values()]
    with pytest.raises(ValueError, match="one token at a time"):
        TM.decode_step(tp, tcfg, {"tokens": torch.zeros((2, 3),
                                                        dtype=torch.long)},
                       tc, lookahead=2)
    after = [t for blk in tc for c in blk.values() for t in c.values()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not TM.prefill_chunkable(tcfg)
    assert not TM.speculative_supported(tcfg)


def test_interop_round_trip_is_bitwise_with_fp32_ssm_leaves():
    """bf16 jamba + SWAT: JAX params -> port -> numpy are bitwise the JAX
    leaves; the mixer's a_log, d_skip, dt_bias and norm stay fp32, its
    projections and conv bf16."""
    cfg, tcfg = _configs("jamba_swat", num_layers=8)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    want = jax.tree.map(np.asarray, JM.init_model(jax.random.PRNGKey(1), cfg))
    tp = interop.params_from_jax(want, tcfg, device="cpu")
    mixer = tp["blocks"][0]["l0"]["mixer"]
    assert {mixer[k].dtype for k in ("a_log", "d_skip", "dt_bias")} == {
        torch.float32}
    assert mixer["norm"]["scale"].dtype == torch.float32
    assert {mixer[k].dtype for k in ("in_proj", "conv_w", "conv_b",
                                     "out_proj")} == {torch.bfloat16}
    got = dict(tree.flatten_with_paths(interop.params_to_numpy(tp, tcfg)))
    flat = dict(tree.flatten_with_paths(want))
    assert got.keys() == flat.keys()
    for path, w in flat.items():
        np.testing.assert_array_equal(got[path], w.astype(np.float32),
                                      err_msg=str(path))


# ---------------------------------------------------------- the engine ----

def _prompts(cfg, seed=0, n=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, (int(l),)).astype(np.int32)
            for l in rng.randint(8, 40, n)]


def _serve_both(s, kw, prompts, n_new=10, faults=None, kernel=False):
    """The JAX engine and the port's engine serve `prompts` (greedy, 2
    slots): (port engine, port results, JAX engine, JAX results).
    kernel=True: the JAX engine on decode_impl="pallas", the port on the
    fused decode kernel's wrapper (its plain version on CPU tensors)."""
    cfg, tcfg, jp, _, tp = s
    common = dict(batch_slots=2, max_len=128, scan_steps=4, **kw)
    try:
        jeng = JE.ServingEngine(
            cfg, jp, faults=JF.FaultPlan(**faults) if faults else None,
            decode_impl="pallas" if kernel else "ref", **common)
        jres = jeng.run([JE.Request(rid=i, prompt=p, max_new_tokens=n_new)
                         for i, p in enumerate(prompts)])
    finally:
        JF.clear_kernel_failure()
    try:
        teng = TE.ServingEngine(
            tcfg, tp, faults=TF.FaultPlan(**faults) if faults else None,
            **common)
        if kernel:
            teng._impl = "kernel"
        tres = teng.run([TE.Request(rid=i, prompt=p, max_new_tokens=n_new)
                         for i, p in enumerate(prompts)])
    finally:
        TF.clear_kernel_failure()
    return teng, tres, jeng, jres


def _assert_engine_parity(teng, tres, jeng, jres):
    key = lambda r: r.rid
    got = [(r.rid, r.status, list(r.tokens)) for r in sorted(tres, key=key)]
    want = [(r.rid, r.status, list(r.tokens)) for r in sorted(jres, key=key)]
    assert got == want
    assert {k: teng.stats[k] for k in jeng.stats} == dict(jeng.stats)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("case", CASES)
def test_engine_equals_jax_engine(serving, case, layout):
    """Greedy tokens, statuses and every shared stat equal the JAX
    engine's: single-shot prefill (neither config is chunkable), T=1
    decode blocks; paged, the mamba states are copied into their slots at
    admission beside the attention layer's pages."""
    s = serving[case]
    teng, tres, jeng, jres = _serve_both(s, {"kv_layout": layout},
                                         _prompts(s[0]))
    _assert_engine_parity(teng, tres, jeng, jres)
    assert all(r.status == "ok" for r in tres)
    assert teng.prefill_chunk == 0 and teng.speculative == 0
    if layout == "paged":
        assert teng._paged.layout.keys() == TM.paged_layout(
            s[1], 128).keys()


def test_kernel_failure_on_jamba_steps_down_before_any_write(serving):
    """jamba (mamba layers l0-l3 before the attention layer l4): the armed
    failure raises at decode_step's entry, so a raising block writes
    nothing (every cache leaf and the version counters unchanged), and an
    engine under fail_pallas_dispatch ends as the JAX engine's does: every
    request ok with its tokens, kernel_fallbacks 1, readmitted 0."""
    s = serving["jamba_swat"]
    _, tcfg, _, _, tp = s
    eng = TE.ServingEngine(tcfg, tp, batch_slots=2, max_len=128,
                           scan_steps=4)
    eng._impl = "kernel"
    prompts = _prompts(s[0], seed=2, n=4)
    eng._admit(collections.deque(
        TE.Request(rid=i, prompt=p, max_new_tokens=8)
        for i, p in enumerate(prompts[:2])))
    eng._stage()
    before = [t.clone() for blk in eng.caches for layer in blk.values()
              for t in layer.values()]
    mark = eng._cache_versions()
    TF.install_kernel_failure()
    try:
        with pytest.raises(TF.KernelDispatchError):
            eng._decode_steps(2, [0, 1])
    finally:
        TF.clear_kernel_failure()
    after = [t for blk in eng.caches for layer in blk.values()
             for t in layer.values()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert eng._cache_versions() == mark
    try:
        teng, tres, jeng, jres = _serve_both(
            s, {}, prompts, faults=dict(fail_pallas_dispatch=True),
            kernel=True)
    finally:
        TF.consume_events()
        JF.consume_events()
    _assert_engine_parity(teng, tres, jeng, jres)
    assert [r.status for r in tres] == ["ok"] * len(prompts)
    assert teng.stats["kernel_fallbacks"] == 1
    assert teng.stats["readmitted"] == 0 and teng.stats["failed"] == 0
    assert teng._impl == "ref" and not SD._FORCE_FAIL


# ----------------------------------------------------------- F5: bytes ----

@pytest.mark.parametrize("context", [16384, 524288])
def test_ring_cache_bytes_equals_jax(context):
    """Every full config (all bf16) at 1 and 4 slots: the port's decode
    cache bytes equal the JAX function's, a mamba layer counted as its
    fixed SSM and conv state; mamba2-1.3b's is the same at every context
    (tests/test_serving.py::test_mamba_state_is_constant_memory)."""
    for arch in ARCH_IDS + PAPER_IDS:
        cfg, tcfg = get_config(arch), t_config(arch)
        assert tcfg.dtype == "bfloat16"
        for batch in (1, 4):
            assert TE.ring_cache_bytes(tcfg, batch, context) == \
                JE.ring_cache_bytes(cfg, batch, context), (arch, batch)
    mamba = t_config("mamba2_1p3b")
    assert TE.ring_cache_bytes(mamba, 1, context) == \
        TE.ring_cache_bytes(mamba, 1, 1024) == 48 * (
            64 * 64 * 128 * 4 + 3 * (4096 + 2 * 128) * 2)


# ------------------------------------------------------- the launchers ----

def _launch(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env,
                          timeout=300)


@pytest.mark.parametrize("arch,extra", [
    ("mamba2-1.3b", ()),
    ("jamba-1.5-large", ("--swat", "--window", "16", "--kv-layout",
                         "paged"))], ids=["mamba2", "jamba_swat_paged"])
def test_serve_launcher_serves_mamba_configs(arch, extra):
    """The serve launcher on the CPU; its cache line is F5's number."""
    out = _launch("repro_torch.launch.serve", "--arch", arch, "--smoke",
                  *extra, "--requests", "3", "--slots", "2", "--prompt-len",
                  "40", "--new-tokens", "6", "--max-len", "128", "--device",
                  "cpu")
    assert out.returncode == 0, out.stderr
    assert "[serve] statuses: ok=3" in out.stdout
    assert "3 requests / 18 tokens" in out.stdout
    tcfg = t_smoke(arch)
    if "--swat" in extra:
        tcfg = t_swat(tcfg, window=16, num_global=4)
    mb = TE.ring_cache_bytes(tcfg, 2, 128) / 1e6
    assert f"[serve] cache bytes @max_len: {mb:.1f}MB" in out.stdout


def test_train_launcher_trains_mamba2(tmp_path):
    out = _launch("repro_torch.launch.train", "--arch", "mamba2-1.3b",
                  "--smoke", "--steps", "2", "--batch", "2", "--seq", "64",
                  "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"))
    assert out.returncode == 0, out.stderr
    line = next(l for l in out.stdout.splitlines()
                if l.startswith("[train] step"))
    assert np.isfinite(float(line.split("loss=")[1].split()[0]))
    assert "[train] done" in out.stdout
