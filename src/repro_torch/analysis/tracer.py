"""Tracing the serving engine's bodies (the port of the JAX package's
`analysis/tracer.py`).

The JAX analyzer lowers each jitted entry point to a jaxpr and to HLO and
reads the invariants off the program. The port has no program to read: its
hot paths are Python bodies that the engine runs eagerly once and then
captures as CUDA graphs (`serving/engine.py`, `_Compiled.run`). So the
port's tracer RUNS each body, once, under a recording `TorchDispatchMode`,
and the rules read the op log:

  * every aten op the body dispatches, with its inputs' and outputs'
    (shape, dtype, device, storage) and the arguments its schema writes,
  * the kernels it launched (the wrappers' launch counters: kernels are
    called through ctypes, which no dispatcher sees),
  * on a mesh engine, the collectives the mesh issued (its record, kept
    on while the body runs: a LocalMesh's collectives are cats and sums
    that no op log tells apart),
  * whether a declared carry was rebound: the engine holds another tensor,
    or another storage, after the body.

Before the traced run the body runs once untraced, as the engine's first
use of a key does (kernel builds, pattern uploads), and every run is
undone: the tracer snapshots each carry (the tensor, its `data_ptr()` and
a clone), the engine's generator and its host counters, and restores them
after each run. So tracing an entry twice gives the same op log, and an
analyzed engine serves the tokens it would have served. On the card it
then proves each captured body capture-safe: it runs the body's graph key
through the engine's own `_Compiled` until the key is captured and
replayed.

The registry half (`engine_entry_points`) mirrors the JAX one: the same
families, defaults and entry names, with the engine's own bodies, on one
device or on a mesh (every shard's caches are carries, and one op log
holds every shard's ops).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import inspect
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.collectives import is_collective
from repro_torch.kernels import _build

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.dirname(os.path.abspath(__file__))
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))

# ops that wait for the device (the host needs a value the device computes)
SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::item", "aten::is_nonzero",
    "aten::nonzero", "aten::equal", "aten::masked_select",
    "aten::_unique", "aten::_unique2", "aten::unique_dim",
    "aten::unique_consecutive", "aten::unique_dim_consecutive"})
# repeat_interleave with tensor repeats sizes its output from their sum
REPEAT_OPS = frozenset({"aten::repeat_interleave.Tensor",
                        "aten::repeat_interleave.self_Tensor"})
# indexing with a bool mask sizes its output from the mask's count
INDEX_OPS = frozenset({"aten::index.Tensor", "aten::index_put_",
                       "aten::index_put", "aten::_index_put_impl_"})
COPY_OPS = frozenset({"aten::_to_copy", "aten::copy_", "aten::_copy_from",
                      "aten::_copy_from_and_resize"})
# a tensor made from host data (`torch.tensor`, `as_tensor` of a list or an
# array): built on the host, and on the card copied to it with
# non_blocking=False before this op; the copy itself no dispatcher sees
CONSTRUCTOR_OPS = frozenset({"aten::lift_fresh", "aten::lift_fresh_copy"})
MATMUL_OPS = frozenset({
    "aten::mm", "aten::mm.dtype", "aten::bmm", "aten::addmm",
    "aten::baddbmm", "aten::linear", "aten::matmul", "aten::convolution",
    "aten::_convolution"})


@dataclasses.dataclass(frozen=True)
class LeafInfo:
    """One named carry of an entry point."""
    name: str
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int


@dataclasses.dataclass(frozen=True)
class OpTensor:
    """A tensor as one op saw it. `storage` identifies its storage within
    one trace (views share it)."""
    shape: Tuple[int, ...]
    dtype: str
    device: str
    storage: int
    nbytes: int


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched aten op. `writes`: the tensors its schema mutates;
    `scalars`: its non-tensor arguments by schema name, and for a copy
    `src_pinned`, whether its host source is pinned (ops a rule may flag
    only); `site`: "file:function" of the first frame inside repro_torch,
    and `line`: "file:line" of that frame (ops a rule may flag only).
    Reports key on `site`, which an edit elsewhere in the file leaves
    as it is; `line` is for the printout."""
    name: str
    inputs: Tuple[OpTensor, ...]
    outputs: Tuple[OpTensor, ...]
    writes: Tuple[OpTensor, ...]
    scalars: Tuple[Tuple[str, Any], ...] = ()
    site: Optional[str] = None
    line: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """One serving entry point: an engine body and what it carries.

    body:       zero-argument callable, the engine's own body.
    carries:    zero-argument callable returning the named tensors the
                engine feeds back into its next call (read before and after
                the body: a carry must keep its tensor and storage).
    inputs:     the named tensors the body reads that an eager family's
                compile key is taken from.
    setup:      run before every run of the body (the engine's own block
                set-up that is not part of the captured body).
    graph_key:  the key `_Compiled.run` captures the body under (None for
                the families the engine runs eagerly); graph_body is what
                that key captures (default: body), compiled the engine's
                `_Compiled`.
    host_key:   names of the graph key's fields that hold a host position
                rather than a shape (the recompile rule's WARN).
    host_reads: host reads the engine makes between this entry's captured
                steps (reported, not traced: outside the body).
    generator / host: the engine's generator, and a snapshot of its host
                counters (returns the callable that restores them).
    mesh:       the engine's mesh (None on one device), whose collectives
                are recorded while the body runs.
    tags:       rule routing, as in JAX: "decode_hot_path", "metrics",
                "paged", and one of "single", "slot_parallel", "tp".
    """
    name: str
    family: str
    body: Callable[[], Any]
    carries: Callable[[], Dict[str, torch.Tensor]] = dict
    inputs: Tuple[Tuple[str, torch.Tensor], ...] = ()
    setup: Optional[Callable[[], Any]] = None
    graph_key: Optional[tuple] = None
    graph_body: Optional[Callable[[], Any]] = None
    compiled: Any = None
    host_key: Tuple[str, ...] = ()
    host_reads: int = 0
    generator: Optional[torch.Generator] = None
    host: Optional[Callable[[], Callable[[], None]]] = None
    mesh: Any = None
    tags: frozenset = frozenset()


@dataclasses.dataclass
class TracedEntry:
    point: EntryPoint
    ops: List[OpRecord]
    carry_leaves: List[LeafInfo]
    carry_storages: Dict[int, str]      # storage -> carry name
    rebound: List[str]                  # carries the body rebound
    launches: Dict[str, int]            # kernel launches, by counter name
    compile_key: str
    captured: Optional[bool] = None     # None: not captured on this device
    capture_error: Optional[str] = None
    # the mesh's record of the traced run: (kind, axis, bytes); None
    # without a mesh
    record: Optional[List[Tuple[str, str, int]]] = None

    @property
    def carry_bytes(self) -> int:
        return sum(l.nbytes for l in self.carry_leaves)

    def canonical(self) -> List[tuple]:
        """The op log with storages renumbered in order of appearance:
        equal for two traces of the same entry."""
        ids: Dict[int, int] = {}

        def t(x: OpTensor):
            return (x.shape, x.dtype, x.device,
                    ids.setdefault(x.storage, len(ids)))
        return [(o.name, tuple(map(t, o.inputs)), tuple(map(t, o.outputs)),
                 tuple(map(t, o.writes)), o.scalars, o.site, o.line)
                for o in self.ops]


# ---------------------------------------------------------------- tracing --

def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _storage(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return id(t)


def _optensor(t: torch.Tensor) -> OpTensor:
    return OpTensor(tuple(t.shape), _dtype(t), t.device.type, _storage(t),
                    t.numel() * t.element_size())


def _leaf(name: str, t: torch.Tensor) -> LeafInfo:
    return LeafInfo(name, tuple(t.shape), _dtype(t),
                    t.numel() * t.element_size())


def _path(fn: str) -> str:
    """A source file as reports name it: from the package's parent inside
    repro_torch, else its base name."""
    fn = os.path.abspath(fn)
    return (os.path.relpath(fn, os.path.dirname(_PKG))
            if fn.startswith(_PKG) else os.path.basename(fn))


def _site() -> Tuple[Optional[str], Optional[str]]:
    """('path:function', 'path:line') of the innermost frame inside
    repro_torch (outside this package), else of the innermost frame outside
    torch and this package."""
    f = sys._getframe(2)
    fallback = (None, None)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_HERE) and not fn.startswith(_TORCH):
            where = (f"{_path(fn)}:{f.f_code.co_qualname}",
                     f"{_path(fn)}:{f.f_lineno}")
            if fn.startswith(_PKG):
                return where
            if fallback[0] is None:
                fallback = where
        f = f.f_back
    return fallback


def _unwrap(fn):
    while hasattr(fn, "__wrapped__") or hasattr(fn, "func"):
        fn = getattr(fn, "__wrapped__", None) or fn.func
    return fn


def code_site(fn) -> str:
    """'path:function' of a function (of a partial's function)."""
    fn = _unwrap(fn)
    return f"{_path(inspect.getsourcefile(fn))}:{fn.__qualname__}"


def code_line(fn) -> str:
    """'path:line' of a function's definition."""
    fn = _unwrap(fn)
    return (f"{_path(inspect.getsourcefile(fn))}:"
            f"{inspect.getsourcelines(fn)[1]}")


@functools.lru_cache(maxsize=None)
def _schema_writes(func) -> Tuple[Tuple[int, str], ...]:
    """(position, name) of the arguments `func`'s schema mutates."""
    return tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                 if a.alias_info is not None and a.alias_info.is_write)


def _group_size(v) -> Optional[int]:
    """The rank count of a c10d op's process group argument."""
    if not isinstance(v, torch.ScriptObject):
        return None
    if not v._type().qualified_name().endswith("c10d.ProcessGroup"):
        return None
    import torch.distributed as dist
    return dist.ProcessGroup.unbox(v).size()


def _scalars(func, args, kwargs) -> Tuple[Tuple[str, Any], ...]:
    """The op's non-tensor arguments by schema name, and for a c10d op its
    process group's `group_size`."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        v = args[i] if i < len(args) else kwargs.get(a.name, None)
        if v is None or isinstance(v, (bool, int, str)):
            out.append((a.name, v))
        elif isinstance(v, (float, torch.dtype)):
            out.append((a.name, repr(v)))
        elif (size := _group_size(v)) is not None:
            out.append(("group_size", size))
    return tuple(out)


def _flaggable(name: str, writes: bool) -> bool:
    """Ops a rule may flag, whose call site the tracer keeps."""
    return (writes or name in SYNC_OPS or name in COPY_OPS
            or name in CONSTRUCTOR_OPS or name in MATMUL_OPS
            or name in REPEAT_OPS or name in INDEX_OPS
            or is_collective(name))


def _src_pinned(name: str, args) -> bool:
    """Whether a copy op reads a pinned host tensor."""
    src = args[1] if name == "aten::copy_" else args[0]
    return (isinstance(src, torch.Tensor) and src.device.type == "cpu"
            and src.is_pinned())


class _Recorder(TorchDispatchMode):
    """Records every op dispatched under it. Outputs are kept alive until
    the trace ends, so no storage id is reused within one trace."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self._keep: List[Any] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.name()
        ins = tuple(_optensor(t) for t in tree_flatten((args, kwargs))[0]
                    if isinstance(t, torch.Tensor))
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        writes = []
        for i, arg in _schema_writes(func):
            v = args[i] if i < len(args) else kwargs.get(arg)
            writes += [_optensor(t) for t in tree_flatten(v)[0]
                       if isinstance(t, torch.Tensor)]
        flag = _flaggable(name, bool(writes))
        scalars = _scalars(func, args, kwargs) if flag else ()
        if name in COPY_OPS:
            scalars += (("src_pinned", _src_pinned(name, args)),)
        site, line = _site() if flag else (None, None)
        self.ops.append(OpRecord(
            name, ins, tuple(_optensor(t) for t in outs), tuple(writes),
            scalars, site, line))
        self._keep.append(outs)
        return out


class _Snapshot:
    """The state one run of a body may change: each carry (the tensor, its
    data_ptr and a clone), the generator's state and the host counters."""

    def __init__(self, point: EntryPoint):
        # name -> (tensor, data_ptr, clone); a storage met again under
        # another name (a table every super-block shares) is cloned once
        self.carries: Dict[str, Tuple[torch.Tensor, int,
                                      Optional[torch.Tensor]]] = {}
        cloned = set()
        for name, t in point.carries().items():
            key = _storage(t)
            self.carries[name] = (t, t.data_ptr(),
                                  None if key in cloned else t.clone())
            cloned.add(key)
        self.gen = point.generator
        self.gen_state = self.gen.get_state() if self.gen is not None \
            else None
        self.host_restore = point.host() if point.host is not None else None

    def rebound(self, now: Dict[str, torch.Tensor]) -> List[str]:
        return sorted(name for name, (t, ptr, _) in self.carries.items()
                      if name not in now or now[name] is not t
                      or now[name].data_ptr() != ptr)

    def restore(self) -> None:
        with torch.no_grad():
            for t, _, saved in self.carries.values():
                if saved is not None:
                    t.copy_(saved)
        if self.gen is not None:
            self.gen.set_state(self.gen_state)
        if self.host_restore is not None:
            self.host_restore()


def _compile_key(point: EntryPoint) -> str:
    if point.graph_key is not None:
        return repr(point.graph_key)
    sig = tuple((n, tuple(t.shape), _dtype(t)) for n, t in point.inputs)
    return hashlib.sha1(repr((point.family, sig)).encode()).hexdigest()[:12]


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def trace(point: EntryPoint, *, capture: bool = True) -> TracedEntry:
    """Warm up, trace and restore one entry point; on the card (capture and
    an enabled `compiled`) also capture and replay its graph key."""
    snap = _Snapshot(point)
    carry_storages: Dict[int, str] = {}
    for name, (t, _, _) in snap.carries.items():
        carry_storages.setdefault(_storage(t), name)
    capture_error = None
    captured = None
    try:
        if point.setup is not None:
            point.setup()
        point.body()                               # the engine's first use
        snap.restore()
        if point.setup is not None:
            point.setup()
        before = _build.launch_counts_by_name()
        rec = _Recorder()
        with (contextlib.nullcontext() if point.mesh is None
              else point.mesh.recording()) as record, rec:
            point.body()
        launches = _delta(_build.launch_counts_by_name(), before)
        rebound = snap.rebound(point.carries())
        snap.restore()
        compiled = point.compiled
        if (capture and point.graph_key is not None and compiled is not None
                and compiled.enabled):
            captured = False
            replays = compiled.replays
            try:
                for _ in range(2):     # a key unseen so far first runs eager
                    if point.setup is not None:
                        point.setup()
                    compiled.run(point.graph_key,
                                 point.graph_body or point.body)
                    snap.restore()
                    if compiled.replays > replays:
                        break
                captured = point.graph_key in compiled.captured \
                    and compiled.replays > replays
            except RuntimeError as e:
                capture_error = str(e)
    finally:
        snap.restore()
    carry_leaves = [_leaf(n, t) for n, (t, _, _) in snap.carries.items()
                    if carry_storages.get(_storage(t)) == n]
    return TracedEntry(point=point, ops=rec.ops, carry_leaves=carry_leaves,
                       carry_storages=carry_storages, rebound=rebound,
                       launches=launches, compile_key=_compile_key(point),
                       captured=captured, capture_error=capture_error,
                       record=record)


# ------------------------------------------------- serving entry registry --

def engine_tags(engine) -> frozenset:
    """"single" without a mesh; on a mesh "tp" when 'model' splits, else
    "slot_parallel" (the JAX tags)."""
    if engine.mesh is None:
        return frozenset({"single"})
    model = engine.mesh.shape.get("model", 1)
    return frozenset({"tp"} if model > 1 else {"slot_parallel"})


def _cache_leaves(caches, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}[{b}].{name}.{leaf}": t
            for b, blk in enumerate(caches) for name, layer in blk.items()
            for leaf, t in layer.items()}


def _trees_leaves(trees: List[list], prefix: str) -> Dict[str, torch.Tensor]:
    """The leaves of one cache tree, or of one per local shard (named
    prefix@k)."""
    if len(trees) == 1:
        return _cache_leaves(trees[0], prefix)
    out = {}
    for k, tree in enumerate(trees):
        out.update(_cache_leaves(tree, f"{prefix}@{k}"))
    return out


def _slot_caches(engine) -> Dict[str, torch.Tensor]:
    return _trees_leaves(engine._cache_trees(), "caches")


def engine_entry_points(engine, *, batch_sizes: Optional[Sequence[int]] = None,
                        scan_lens: Optional[Sequence[int]] = None,
                        prefill_len: int = 64,
                        chunk_len: int = 32) -> List[EntryPoint]:
    """The serving matrix of one engine, with the JAX registry's families,
    defaults and entry names: batch_sizes are prefill-row counts (default:
    1 and the slot count), scan_lens decode-block lengths (default: 1 and
    scan_steps). Each body is the engine's own, on seeded inputs made here
    on the engine's device:

      prefill[n,len]          prefill_logits, single-shot (len must not
                              exceed the engine's prefill_chunk)
      prefill_chunk[n,c]      _chunk_body on _chunk_rows(n): the chunk
                              [c, 2c), the first that runs the global-row
                              pass on a spec with globals
      cache_insert[slots,n]   _insert (paged engines: cache_insert_paged,
                              _insert_paged into slots 0..n-1)
      sample[n]               sampling.sample, the full sampler
      cache_fixup[slots,m]    _paged_flush of m copy-on-write moves a layer
                              position and the table push (paged)
      scan[n,slots]           _decode_body(n, greedy)
      spec_scan[n,slots]      n x _verify_body(greedy), the verify step the
                              engine captures, after the block's own
                              set-up (_verify_begin)

    greedy is the engine's current sampler branch (a fresh engine's: the
    greedy-only branch). Building the list runs no body.

    On a mesh (the JAX registry's mesh engines) each body runs the engine's
    plan over every local shard: the prefill and chunk rows split over the
    slot groups when they divide them, as the engine splits them; the
    insert takes the rows as prefill leaves them (plan-local, a slot
    group's rows each when split); the paged fixup is the table push alone
    (m=0: a slot-local pool has no copy-on-write moves). Every shard's
    caches are carries."""
    from repro_torch.core import model as Mod
    from repro_torch.serving import sampling

    cfg, slots, dev = engine.cfg, engine.slots, engine.device
    mp = engine._mp
    paged = engine._paged is not None
    base = engine_tags(engine) | ({"paged"} if paged else frozenset())
    if batch_sizes is None:
        batch_sizes = sorted({1, slots})
    if scan_lens is None:
        scan_lens = sorted({1, engine.scan_steps})
    if engine.prefill_chunk and prefill_len > engine.prefill_chunk:
        raise ValueError(f"prefill_len={prefill_len}: the prefill entry is "
                         "single-shot, so at most the engine's prefill_chunk"
                         f"={engine.prefill_chunk}")
    gen = torch.Generator().manual_seed(0)
    v = cfg.vocab_size
    common = dict(generator=engine.generator, host=functools.partial(
        _host_state, engine), compiled=engine._compiled, mesh=engine.mesh)
    caches = functools.partial(_slot_caches, engine)

    points: List[EntryPoint] = []
    for n in batch_sizes:
        tok = torch.randint(0, v, (n, prefill_len), generator=gen).to(dev)
        lens = torch.full((n,), prefill_len, dtype=torch.int32, device=dev)
        points.append(EntryPoint(
            name=f"prefill[n={n},len={prefill_len}]", family="prefill",
            body=functools.partial(engine.prefill_logits, tok, lens),
            inputs=(("tokens", tok), ("lengths", lens)), tags=base,
            **common))
        per = n // mp.groups if mp is not None and mp.splits(n) else n
        if Mod.prefill_chunkable(cfg):
            bufs = [dict(b) for b in engine._chunk_rows(per)]
            for buf in bufs:
                if buf["tok"].shape[1] < chunk_len:
                    # an engine without prefill_chunk never runs chunks:
                    # the entry stages its chunk tokens in a buffer of its
                    # own
                    buf["tok"] = torch.zeros((per, chunk_len),
                                             dtype=torch.long, device=dev)
            body = functools.partial(engine._chunk_body, bufs, chunk_len,
                                     chunk_len)
            points.append(EntryPoint(
                name=f"prefill_chunk[n={n},c={chunk_len}]",
                family="prefill_chunk", body=body,
                carries=functools.partial(_chunk_carries, engine),
                inputs=(("tokens", bufs[0]["tok"][:, :chunk_len]),
                        ("lengths", bufs[0]["lens"])),
                graph_key=("chunk", n, chunk_len, chunk_len),
                host_key=("pos0",), tags=base, **common))
        if mp is None:
            rows = Mod.init_caches(cfg, n, engine.max_len,
                                   lookahead=engine.lookahead, device=dev)
            trees = [rows]
        else:
            trees = rows = mp.chunk_caches(per, dev)
        idx = torch.arange(n, device=dev)
        inputs = tuple(_trees_leaves(trees, "rows").items())
        if mp is not None:
            insert = functools.partial(engine._mesh_insert, rows,
                                       list(range(n)))
        elif paged:
            insert = functools.partial(engine._insert_paged, rows,
                                       list(range(n)), idx)
        else:
            insert = functools.partial(engine._insert, rows, idx)
        family = "cache_insert_paged" if paged else "cache_insert"
        points.append(EntryPoint(
            name=f"{family}[slots={slots},n={n}]", family=family,
            body=insert, carries=caches, inputs=inputs, tags=base,
            **common))
        logits = torch.randn((n, v), generator=gen).to(dev)
        temps = torch.zeros((n,), dtype=torch.float32, device=dev)
        points.append(EntryPoint(
            name=f"sample[n={n}]", family="sample",
            body=functools.partial(sampling.sample, engine.generator, logits,
                                   temps, engine.top_k, any_sampling=True),
            inputs=(("logits", logits), ("temperatures", temps)), tags=base,
            **common))

    hot = base | {"decode_hot_path"}
    if paged:
        # m copy-on-write moves a layer position between decode blocks, and
        # the table push; the moves' ids are any distinct pool blocks. A
        # mesh's slot-local pool has none: the push alone (m=0)
        m = 4 if mp is None else 0
        moves = {}
        for i in engine._paged.tables:
            blocks = engine._cache_trees()[0][0][f"l{i}"]["pk"].shape[0]
            moves[i] = [(j % blocks, (blocks - 1 - j) % blocks)
                        for j in range(m)]
        points.append(EntryPoint(
            name=f"cache_fixup[slots={slots},m={m}]", family="cache_fixup",
            body=functools.partial(engine._paged_flush, moves),
            setup=functools.partial(setattr, engine._paged, "dirty", True),
            carries=caches, tags=hot, **common))
    if engine.metrics:
        hot = hot | {"metrics"}
    greedy = not engine._anyt
    for n in scan_lens:
        if engine.speculative:
            step = functools.partial(engine._verify_body, greedy)
            points.append(EntryPoint(
                name=f"spec_scan[n={n},slots={slots}]", family="spec_scan",
                body=functools.partial(_repeat, step, n),
                carries=functools.partial(_decode_carries, engine, True),
                setup=engine._verify_begin,
                graph_key=("verify", slots, greedy), graph_body=step,
                host_reads=n, tags=hot, **common))
        else:
            points.append(EntryPoint(
                name=f"scan[n={n},slots={slots}]", family="scan",
                body=functools.partial(engine._decode_body, n, greedy),
                carries=functools.partial(_decode_carries, engine, False),
                graph_key=("decode", n, slots, greedy), tags=hot, **common))
    # the engine runs every body under no_grad
    return [dataclasses.replace(
        p, body=torch.no_grad()(p.body),
        graph_body=p.graph_body and torch.no_grad()(p.graph_body))
        for p in points]


def _repeat(step: Callable[[], Any], n: int) -> None:
    for _ in range(n):
        step()


def _decode_carries(engine, spec: bool) -> Dict[str, torch.Tensor]:
    out = _slot_caches(engine)
    out.update({f"dev.{k}": t for k, t in engine._dev.items()})
    out.update(toks=engine._toks, emit=engine._emit)
    if spec:
        out.update(sidx=engine._sidx, flip=engine._flip,
                   active0=engine._active0, hist=engine.slot_hist,
                   hcnt=engine.slot_hcnt)
    if engine._mx is not None:
        out.update({f"mx.{k}": t for k, t in engine._mx.items()})
    return out


def _chunk_carries(engine) -> Dict[str, torch.Tensor]:
    bufs = engine._chunk_buf
    out = _trees_leaves([b["caches"] for b in bufs], "chunk.caches")
    for j, buf in enumerate(bufs):
        at = "" if len(bufs) == 1 else f"@{j}"
        out.update({f"chunk{at}.{k}": buf[k]
                    for k in ("last", "tok", "lens")})
    return out


def _host_state(engine) -> Callable[[], None]:
    """Snapshot the engine's host counters and the paged manager's dirty
    flag (a table push clears it); returns their restore."""
    stats = dict(engine.stats)
    dirty = engine._paged.dirty if engine._paged is not None else None

    def restore():
        engine.stats.clear()
        engine.stats.update(stats)
        if engine._paged is not None:
            engine._paged.dirty = dirty
    return restore
