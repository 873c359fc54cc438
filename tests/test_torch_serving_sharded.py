"""The port's mesh-sharded serving (`ServingEngine(mesh=, profile=)`,
`distributed/tensor_parallel.py`) against the single-device engines, the
port's and the JAX package's, on the CPU in fp32, on the JAX package's own
sharded-serving cell (tests/test_serving_sharded.py: smoke llama +
with_swat(16, 4), 4 slots, max_len 128, scan_steps 4, seed 11, six prompts
with mixed temperatures).

  * Slot-parallel 4x1 LocalMesh: tokens bitwise the single-device port
    engine's, sampled rows included, and the greedy rows the JAX engine's;
    the caches' and `step`'s slot dim split and slot_quantum 4; with
    chunked prefill, speculative decoding, device metrics (counters
    equal), a fault plan (statuses and quarantines equal) and the paged
    layout (bitwise the contiguous engine; with the fault plan, the paged
    single-device engine); granite-moe and mamba2 at 2x1.
  * TP: the smoke llama at 2x2 (its one kv head cannot split: the ring
    is gathered on use) and gemma2's smoke config at 1x2 (2 kv heads, the
    Megatron split), on JAX-initialised params: prefill and first decode
    step logits within F32 of the JAX package's single-device `prefill`
    and `decode_step` and of the port's single-device engine, every budget
    exact, two engines bitwise; the cp and fsdp profiles at 2x2 give the
    single-device port engine's tokens, and the JAX engine's greedy rows.
  * The ProcessMesh over gloo in two CPU processes, 2x1 and 1x2, on the
    cell's JAX params: tokens the single-device port engine's and greedy
    rows the JAX engine's, logits within F32 of the JAX package's.
"""
import collections
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs import with_swat as j_swat
from repro.core import model as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_smoke_config, with_swat
from repro_torch.core import model as TM
from repro_torch.distributed import sharding as Sh
from repro_torch.launch import mesh as ML
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.faults import FaultPlan

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(atol=2e-5, rtol=1e-4)
TEMPS = [0.0, 1.5, 0.0, 2.5, 1.0, 0.0]
BUDGETS = [6, 9, 4, 7, 5, 8]


def _prompts(vocab):
    rng = np.random.RandomState(3)
    return [rng.randint(0, vocab, (n,)).astype(np.int32)
            for n in (12, 30, 7, 18, 25, 10)]


def _reqs(prompts, temps=TEMPS):
    return [Request(rid=i, prompt=p, max_new_tokens=BUDGETS[i],
                    temperature=temps[i]) for i, p in enumerate(prompts)]


def _engine(cfg, params, mesh=None, **kw):
    if isinstance(mesh, tuple):
        mesh = ML.LocalMesh(mesh, ("data", "model"))
    return ServingEngine(cfg, params, batch_slots=4, max_len=128,
                         scan_steps=4, seed=11, mesh=mesh, **kw)


def _serve(eng, prompts, temps=TEMPS):
    return {r.rid: r for r in eng.run(_reqs(prompts, temps))}


def _tokens(res):
    return {rid: r.tokens for rid, r in res.items()}


def _configs(name):
    """(JAX config, port config, JAX params, the port's copy of them) of a
    smoke config + with_swat(16, 4)."""
    jcfg = j_swat(j_smoke(name), window=16, num_global=4)
    cfg = with_swat(get_smoke_config(name), window=16, num_global=4)
    jp = JM.init_model(jax.random.PRNGKey(0), jcfg)
    params = interop.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu")
    return jcfg, cfg, jp, params


def _first_batch(prompts, n=4):
    """The first n prompts as one right-padded batch, and their lengths."""
    tok = np.zeros((n, max(len(p) for p in prompts[:n])), np.int32)
    for i, p in enumerate(prompts[:n]):
        tok[i, :len(p)] = p
    return tok, np.asarray([len(p) for p in prompts[:n]], np.int32)


def _jax_logits(jcfg, jp, prompts):
    """The JAX package's single-device `prefill` of `_first_batch` and its
    first greedy `decode_step`: fp32 logits (4, V) and (4, 1, V)."""
    tok, lens = _first_batch(prompts)
    pre, caches = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(tok)}, 128,
                             lengths=jnp.asarray(lens))
    nxt = jnp.argmax(pre[:, 0], axis=-1).astype(jnp.int32)[:, None]
    step, _ = JM.decode_step(jp, jcfg, {"tokens": nxt}, caches)
    return (torch.from_numpy(np.array(pre[:, 0], np.float32)),
            torch.from_numpy(np.array(step, np.float32)))


@pytest.fixture(scope="module")
def cell():
    """The JAX cell's configs and params (JAX's, and the port's copy), its
    prompts, the JAX single-device engine's results and `_jax_logits`."""
    jcfg, cfg, jp, params = _configs("llama3p2_1b")
    prompts = _prompts(cfg.vocab_size)
    jeng = JEngine(jcfg, jp, batch_slots=4, max_len=128, scan_steps=4,
                   seed=11)
    jres = {r.rid: r.tokens for r in jeng.run(
        [JRequest(rid=i, prompt=p, max_new_tokens=BUDGETS[i],
                  temperature=TEMPS[i]) for i, p in enumerate(prompts)])}
    return dict(cfg=cfg, params=params, prompts=prompts, jres=jres,
                logits=_jax_logits(jcfg, jp, prompts))


@pytest.fixture(scope="module")
def single(cell):
    """The single-device port engine's results per option set."""
    cfg, params, prompts = cell["cfg"], cell["params"], cell["prompts"]
    memo = {}

    def get(**kw):
        key = tuple(sorted((k, repr(v)) for k, v in kw.items()))
        if key not in memo:
            eng = _engine(cfg, params, **kw)
            memo[key] = (eng, _serve(eng, prompts))
        return memo[key]
    return get


FAULTS = FaultPlan(poison_logits=((1, 3, "nan"),), poison_cache=((2, 2),))
SLOT_CASES = {
    "plain": {},
    "chunked": dict(prefill_chunk=8),
    "speculative": dict(speculative=3),
    "metrics": dict(metrics=True),
    "faults": dict(faults=FAULTS),
    "paged": dict(kv_layout="paged"),
    "paged_faults": dict(kv_layout="paged", faults=FAULTS),
}


@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_slot_parallel_mesh_bitwise(cell, single, case):
    cfg, params, prompts = cell["cfg"], cell["params"], cell["prompts"]
    jres = cell["jres"]
    kw = SLOT_CASES[case]
    eng = _engine(cfg, params, (4, 1), **kw)
    got = _serve(eng, prompts)
    base_kw = {} if case == "paged" else kw
    base_eng, base = single(**base_kw)
    assert _tokens(got) == _tokens(base)
    assert [r.status for r in got.values()] == \
        [r.status for r in base.values()]
    assert eng.scheduler.slot_quantum == 4
    mp = eng._mp
    assert mp.groups == 4 and len(eng.shard_caches) == 4
    layer = eng.shard_caches[0][0]["l0"]
    specs = mp.cache_specs[0]["l0"]
    lead = "pk" if "kv_layout" in kw else "k"
    assert specs[lead][0] == "data" and specs["step"] == Sh.P("data")
    assert layer[lead].shape[0] == 1 and layer["step"].shape == (1,)
    if case == "plain":
        for i in range(6):
            if TEMPS[i] == 0.0:
                assert got[i].tokens == jres[i], i
    if case == "metrics":
        a, b = eng.device_metrics(per_slot=True), \
            base_eng.device_metrics(per_slot=True)
        assert a.keys() == b.keys() and a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if "faults" in kw:
        assert got[1].status == "poisoned" and len(got[1].tokens) == 3
        for k in ("quarantined", "tokens_delivered"):
            assert eng.stats[k] == base_eng.stats[k]
    if case == "speculative":
        for k in ("spec_steps", "draft_proposed", "draft_accepted"):
            assert eng.stats[k] == base_eng.stats[k], k


@pytest.mark.parametrize("name", ["granite_moe_1b", "mamba2_1p3b"])
def test_slot_parallel_other_kinds(name):
    """The attn_moe and mamba kinds on a 2x1 mesh: bitwise single-device
    (the experts and the mamba state ride the slot groups whole)."""
    cfg = with_swat(get_smoke_config(name), window=16, num_global=4)
    params = TM.init_model(cfg, seed=0, device="cpu")
    prompts = _prompts(cfg.vocab_size)
    base = _tokens(_serve(_engine(cfg, params), prompts))
    eng = _engine(cfg, params, (2, 1))
    assert _tokens(_serve(eng, prompts)) == base
    assert eng._mp.groups == 2


def _tp_logits(eng, prompts):
    """Prefill logits of `_first_batch`, then the first decode step's
    logits after admitting its prompts greedily."""
    tok, lens = _first_batch(prompts)
    pre, _ = eng.prefill_logits(torch.from_numpy(tok), torch.from_numpy(lens))
    pre = pre.clone()
    eng._admit(collections.deque(_reqs(prompts[:4], [0.0] * 6)))
    eng._stage()
    step = eng._model_step(eng._dev["tok"][:, None])
    return pre, step


TP_CASES = {
    "llama_2x2_gathered_ring": ("llama3p2_1b", (2, 2), False),
    "gemma2_1x2_megatron": ("gemma2_2b", (1, 2), True),
}


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tp_mesh_logits_and_determinism(case):
    name, shape, megatron = TP_CASES[case]
    jcfg, cfg, jp, params = _configs(name)
    prompts = _prompts(cfg.vocab_size)
    eng = _engine(cfg, params, shape)
    assert all(eng._mp.megatron(i) == megatron for i in eng._mp._megatron)
    if name == "llama3p2_1b":
        assert eng._mp.cache_specs[0]["l0"]["k"] == \
            Sh.P("data", None, "model", None)
    else:
        hkv = eng.shard_caches[0][0]["l0"]["k"].shape[1]
        assert hkv == cfg.num_kv_heads // 2
    got = _tp_logits(eng, prompts)
    for ref in (_jax_logits(jcfg, jp, prompts),
                _tp_logits(_engine(cfg, params), prompts)):
        for g, want in zip(got, ref):
            torch.testing.assert_close(g, want, **F32)
    a = _serve(_engine(cfg, params, shape), prompts)
    b = _serve(_engine(cfg, params, shape), prompts)
    assert _tokens(a) == _tokens(b)
    assert [len(a[i].tokens) for i in range(6)] == BUDGETS


@pytest.mark.parametrize("profile", ["cp", "fsdp"])
def test_2d_fsdp_profiles_gather_on_use(cell, single, profile):
    """Every weight gathered on use, the slots split over 'data': the
    single-device port engine's tokens, sampled rows included, and the JAX
    engine's greedy rows."""
    cfg, params, prompts = cell["cfg"], cell["params"], cell["prompts"]
    eng = _engine(cfg, params, (2, 2), profile=profile)
    assert not any(eng._mp.megatron(i) for i in eng._mp._megatron)
    got = _tokens(_serve(eng, prompts))
    assert got == _tokens(single()[1])
    for i in range(6):
        if TEMPS[i] == 0.0:
            assert got[i] == cell["jres"][i], i


RANK = """
import datetime, sys, numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, d, spec = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                        sys.argv[4])
dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.configs import get_smoke_config, with_swat
from repro_torch.serving.engine import Request, ServingEngine
cfg = with_swat(get_smoke_config("llama3p2_1b"), window=16, num_global=4)
params = torch.load(f"{d}/params.pt")
prompts, temps, budgets = (np.load(f"{d}/cell.npz", allow_pickle=True)[k]
                           for k in ("prompts", "temps", "budgets"))
mk = lambda **kw: ServingEngine(cfg, params, batch_slots=4, max_len=128,
                                scan_steps=4, seed=11, mesh=spec, **kw)
eng = mk(speculative=2)
res = eng.run([Request(rid=i, prompt=p, max_new_tokens=int(budgets[i]),
                       temperature=float(temps[i]))
               for i, p in enumerate(prompts)])
tp = mk()
tok, lens = (np.load(f"{d}/cell.npz")[k] for k in ("tok", "lens"))
pre = tp.prefill_logits(torch.from_numpy(tok),
                        torch.from_numpy(lens))[0].clone()
import collections
tp._admit(collections.deque(Request(rid=i, prompt=p, max_new_tokens=9)
                            for i, p in enumerate(prompts[:4])))
tp._stage()
step = tp._model_step(tp._dev["tok"][:, None])
np.savez(f"{d}/out{rank}.npz", pre=pre.numpy(), step=step.numpy(),
         lo=tp._lo, wire=eng.mesh.wire_ops, kind=type(eng.mesh).__name__,
         **{f"calls_{k}": v for k, v in eng.mesh.calls.items()},
         **{f"t{r.rid}": np.asarray(r.tokens) for r in res})
dist.destroy_process_group()
"""


@pytest.mark.parametrize("spec", ["2x1", "1x2"])
def test_process_mesh_over_gloo(cell, single, tmp_path, spec):
    """Two ranks, one shard each (a "DxM" string under an initialised
    group is a ProcessMesh), on the cell's JAX params, with speculative
    decoding: tokens equal the single-device port engine's on both ranks
    (the slot groups' blocks all-gathered at each host sync) and their
    greedy rows the JAX engine's; prefill and first-step logits within F32
    of the JAX package's `prefill` and `decode_step` (each rank's step
    rows its slot group's); all-reduces and all-gathers issued, some
    crossing between the processes. The ranks time out after 240 s."""
    prompts = cell["prompts"]
    tok, lens = _first_batch(prompts)
    np.savez(tmp_path / "cell.npz", prompts=np.asarray(prompts, object),
             temps=np.asarray(TEMPS), budgets=np.asarray(BUDGETS), tok=tok,
             lens=lens)
    torch.save(cell["params"], tmp_path / "params.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(RANK), str(r), "2",
         str(tmp_path), spec], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    base = single(speculative=2)[1]
    pre, step = cell["logits"]
    for r in range(2):
        got = np.load(tmp_path / f"out{r}.npz")
        assert str(got["kind"]) == "ProcessMesh" and int(got["wire"]) > 0
        assert int(got["calls_all_reduce"]) and int(got["calls_all_gather"])
        for i in range(6):
            assert got[f"t{i}"].tolist() == base[i].tokens, (r, i)
            if TEMPS[i] == 0.0:
                assert got[f"t{i}"].tolist() == cell["jres"][i], (r, i)
        np.testing.assert_allclose(got["pre"], pre.numpy(), **F32)
        lo = int(got["lo"])
        np.testing.assert_allclose(
            got["step"], step.numpy()[lo:lo + len(got["step"])], **F32)
