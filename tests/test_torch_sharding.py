"""The port's sharding rule tables (`repro_torch.distributed.sharding`)
spec for spec against the JAX package's, in-process on
`jax.sharding.AbstractMesh`: `param_sharding` (tp, cp, fsdp),
`param_sharding_serving`, `cache_sharding` (contiguous rings, the paged
slot-local pool, mamba conv/ssm), `batch_sharding`, `activation_spec` and
`decode_batch_sharding`, over every config in `configs/` (full and smoke,
shapes only: `jax.eval_shape` on the JAX side, `FakeTensorMode` and the
meta device on the port's) and every production and debug mesh shape.
Equality is exact through the module's stacking rule: the JAX stacked spec
is the port's per-super-block spec behind the stacked dim's entry. Also
`shard_at` against `LocalMesh.shard`, and `placements` on a DeviceMesh."""
import functools

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as JC
from repro.core import model as JM
from repro.distributed import sharding as JS
from repro_torch import configs as TC
from repro_torch.core import model as TM
from repro_torch.distributed import sharding as S
from repro_torch.launch import mesh as ML

torch.set_num_threads(1)

NAMES = JC.ARCH_IDS + JC.PAPER_IDS
MESHES = {
    "2x2": ((2, 2), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "pipe4x4x16": ((4, 4, 16), ("pipe", "data", "model")),
    "pipe2x2": ((2, 2), ("pipe", "data")),
}
SERVE_MESHES = [m for m in MESHES if not m.startswith("pipe")]
CONFIGS = [(n, smoke) for n in NAMES for smoke in (False, True)]


def _cfgs(name, smoke):
    if smoke:
        return JC.get_smoke_config(name), TC.get_smoke_config(name)
    return JC.get_config(name), TC.get_config(name)


def _meshes(key):
    shape, names = MESHES[key]
    return AbstractMesh(shape, names), ML.LocalMesh(shape, names)


@functools.lru_cache(maxsize=None)
def _param_shapes(name, smoke):
    jcfg, tcfg = _cfgs(name, smoke)
    jshapes = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    with FakeTensorMode():
        tshapes = TM.init_model(tcfg, device="cpu")
    # keep the shapes only: fake tensors must not outlive their mode
    tshapes = S._tree_map(lambda _, x: torch.empty(x.shape, device="meta"),
                          tshapes)
    return jshapes, tshapes


def _jax_specs(tree):
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path)
        out[key] = sh.spec if hasattr(sh, "spec") else sh
    return out


def _compare(jtree, ttree, *, stacked_keys, lead_of):
    """Every port leaf against its JAX leaf through the stacking rule;
    returns the number of leaves compared."""
    want = _jax_specs(jtree)
    seen = set()
    for path, spec in S._path_items(ttree):
        parts = path.split("/")
        lead = None
        if parts[0] in stacked_keys:
            lead = lead_of(parts[0])
            parts = parts[:1] + parts[2:]
            got = S.stack_spec(spec, lead)
        elif stacked_keys == ("*",):
            got = S.stack_spec(spec, None)
            parts = parts[1:]
        else:
            got = S.canonical(spec)
        jpath = "/".join(parts)
        assert jpath in want, (jpath, sorted(want)[:8])
        assert got == S.canonical(want[jpath]), (path, got, want[jpath])
        seen.add(jpath)
    assert seen == set(want), sorted(set(want) - seen)
    return len(seen)


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("profile", ["tp", "cp", "fsdp", "serving"])
def test_param_specs_equal_jax(mesh_key, profile):
    jmesh, tmesh = _meshes(mesh_key)
    n = 0
    for name, smoke in CONFIGS:
        jcfg, tcfg = _cfgs(name, smoke)
        jshapes, tshapes = _param_shapes(name, smoke)
        if profile == "serving":
            jsh = JS.param_sharding_serving(jshapes, jmesh)
            tsh = S.param_sharding_serving(tshapes, tmesh)
        else:
            jsh = JS.param_sharding(jshapes, jmesh, profile)
            tsh = S.param_sharding(tshapes, tmesh, profile)
        counts = {"blocks": tcfg.num_super_blocks,
                  "enc_blocks": tcfg.encoder_layers}
        n += _compare(jsh, tsh, stacked_keys=("blocks", "enc_blocks"),
                      lead_of=lambda k: S.super_block_axis(counts[k], tmesh))
    assert n > 100


@pytest.mark.parametrize("mesh_key", SERVE_MESHES)
@pytest.mark.parametrize("layout", ["contiguous", "paged_local"])
def test_cache_specs_equal_jax(mesh_key, layout):
    """Contiguous rings (and the mamba conv/ssm state, whisper's cross K/V)
    at 8 slots and at 1 slot (the sequence-dim fallback), and the paged
    slot-local pool."""
    jmesh, tmesh = _meshes(mesh_key)
    n = 0
    for name, smoke in CONFIGS:
        jcfg, tcfg = _cfgs(name, smoke)
        max_len = 256 if smoke else 4096
        enc = 8 if jcfg.encoder_decoder else 0
        for slots in (8, 1):
            if layout == "paged_local":
                if jcfg.encoder_decoder:
                    continue
                jsh = jax.eval_shape(lambda: JM.init_paged_caches(
                    jcfg, slots, max_len, lookahead=2, shared_pool=False))
                tsh = TM.init_caches(tcfg, slots, max_len, lookahead=2,
                                     paged=True, shared_pool=False,
                                     device="meta")
            else:
                jsh = jax.eval_shape(lambda: JM.init_caches(
                    jcfg, slots, max_len, enc_len=enc))
                tsh = TM.init_caches(tcfg, slots, max_len, enc_len=enc,
                                     device="meta")
            n += _compare(JS.cache_sharding(jsh, jmesh),
                          S.cache_sharding(tsh, tmesh), stacked_keys=("*",),
                          lead_of=None)
    assert n > 100


def test_smoke_llama_ring_falls_back_to_the_sequence_dim():
    """The smoke llama keeps the 4:1 q:kv ratio, so at 2x2 its one kv head
    cannot split over 'model' and the ring's sequence dim takes it."""
    _, tmesh = _meshes("2x2")
    cfg = TC.get_smoke_config("llama3p2_1b")
    spec = S.cache_sharding(TM.init_caches(cfg, 4, 128, device="meta"),
                            tmesh)[0]["l0"]
    assert spec["k"] == S.P("data", None, "model", None)
    assert spec["step"] == S.P("data")
    jmesh, _ = _meshes("2x2")
    jspec = JS.cache_sharding(jax.eval_shape(
        lambda: JM.init_caches(JC.get_smoke_config("llama3p2_1b"), 4, 128)),
        jmesh)["l0"]["k"].spec
    assert tuple(jspec) == (None, "data", None, "model", None)


@pytest.mark.parametrize("mesh_key", SERVE_MESHES)
def test_batch_and_activation_specs_equal_jax(mesh_key):
    jmesh, tmesh = _meshes(mesh_key)
    for b in (1, 2, 4, 8, 16, 32, 512):
        jt = {"tokens": jax.ShapeDtypeStruct((b, 64), np.int32),
              "labels": jax.ShapeDtypeStruct((b, 64), np.int32)}
        tt = {k: torch.empty((b, 64), device="meta") for k in jt}
        for profile in ("tp", "fsdp"):
            _compare(JS.batch_sharding(jt, jmesh, profile),
                     S.batch_sharding(tt, tmesh, profile), stacked_keys=(),
                     lead_of=None)
    for profile in ("tp", "cp", "fsdp"):
        for sp in (True, False):
            assert S.canonical(S.activation_spec(tmesh, sp, profile)) == \
                S.canonical(JS.activation_spec(jmesh, sp, profile))


@pytest.mark.parametrize("mesh_key", SERVE_MESHES)
@pytest.mark.parametrize("slots", [1, 2, 4, 8, 16])
def test_decode_batch_specs_equal_jax(mesh_key, slots):
    """slot_dim 0 (the per-slot vectors, the drafter history) and 1 (the
    (n, slots) token blocks), with n equal to the slot count among them."""
    jmesh, tmesh = _meshes(mesh_key)
    shapes = {"tok": (slots,), "hist": (slots, 32), "key": (2,),
              "blk": (slots, slots), "blk3": (3, slots, 4),
              "blk_n": (4, slots)}
    jt = {k: jax.ShapeDtypeStruct(v, np.int32) for k, v in shapes.items()}
    tt = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
    for slot_dim in (0, 1):
        _compare(JS.decode_batch_sharding(jt, jmesh, slots, slot_dim),
                 S.decode_batch_sharding(tt, tmesh, slots, slot_dim),
                 stacked_keys=(), lead_of=None)
    assert S.canonical(S.replicated(tmesh)) == \
        S.canonical(JS.replicated(jmesh).spec)


@settings(deadline=None, max_examples=40)
@given(shape=st.sampled_from(list(MESHES.values())[:6]),
       dims=st.lists(st.integers(1, 4), min_size=1, max_size=3),
       data=st.data())
def test_shard_at_reassembles(shape, dims, data):
    """Cutting a global tensor at every coordinate of a mesh and putting
    the blocks back gives the tensor again, and a one-axis cut is
    `LocalMesh.shard`'s."""
    sizes, names = shape
    mesh = ML.LocalMesh(sizes, names)
    entries = []
    free = list(names)
    full = []
    for d in dims:
        pick = data.draw(st.sampled_from([None] + free
                                         + ([tuple(free[:2])]
                                            if len(free) > 1 else [])))
        entries.append(pick)
        axes = S.entry_axes(pick)
        free = [a for a in free if a not in axes]
        full.append(d * S._axis_size(mesh, axes) if axes else d)
    x = torch.arange(int(np.prod(full)), dtype=torch.float32).reshape(full)
    spec = S.P(*entries)
    out = torch.zeros_like(x)
    for coord in mesh.coords():
        piece = S.shard_at(x, spec, mesh, coord)
        idx = []
        for d, e in enumerate(entries):
            axes = S.entry_axes(e)
            n, i = 1, 0
            for a in axes:
                n, i = n * mesh.shape[a], i * mesh.shape[a] + coord[a]
            w = x.shape[d] // n
            idx.append(slice(i * w, (i + 1) * w))
        out[tuple(idx)] = piece
        assert torch.equal(piece, x[tuple(idx)])
    assert torch.equal(out, x)
    for d, e in enumerate(entries):
        if isinstance(e, str):
            one = S.P(*([None] * d + [e]))
            want = mesh.shard(x, e, d)
            for coord in mesh.coords():
                assert torch.equal(S.shard_at(x, one, mesh, coord),
                                   want[coord[e]])


def test_placements_on_a_device_mesh():
    from torch.distributed.tensor import Replicate, Shard
    names = ("data", "model")
    assert S.placements(S.P("data", None, "model"), names) == \
        [Shard(0), Shard(2)]
    assert S.placements(S.P(None, ("data", "model")), names) == \
        [Shard(1), Shard(1)]
    assert S.placements(S.P(), names) == [Replicate(), Replicate()]
    with pytest.raises(ValueError):
        S.placements(S.P(("model", "data")), names)
