"""Sharding rules: FSDP + TP + EP + SP with divisibility fallback (the port
of the JAX package's `distributed/sharding.py`, with its rule tables).

Every parameter / cache / batch leaf gets an ordered list of
(dim, axes-preference) rules by *role* (derived from its `/`-joined tree
path). Rules are applied greedily: an axis is used only if the dim is
divisible by it and the axis is not already used by an earlier rule on the
same leaf, otherwise the next preference (or replication) applies. This is
what lets one rule table drive vocab sizes like 50280 (not 16-divisible:
falls back), kv_heads 8 < model=16 (falls back to sharding the cache's
sequence dim), and batch=1 long-context decode (shards the KV sequence axis
instead of batch).

Conventions:
  params:  TP on the contraction-adjacent dim over 'model'
           (column-parallel in-proj, row-parallel out-proj),
           FSDP over 'data' on another dim, experts over 'model' (EP).
  batch:   leading dim over ('pod','data').
  caches:  batch -> ('pod','data'), heads -> 'model', else seq -> 'model'.
  activations (training): batch -> ('pod','data'), sequence -> 'model' (SP).

A spec is a `P`: a tuple with JAX's PartitionSpec entries, one per tensor
dim: None (replicated), an axis name, or a tuple of names (the dim split
over their product, the first name major). The functions take the port's
trees (nested dicts and lists of anything with `.shape`: tensors on any
device, the meta device included) and any mesh with `shape[axis]` and
`axis_names` (`launch/mesh.py`'s LocalMesh and ProcessMesh).

The stacking rule. The JAX package stacks the super-blocks (`blocks/...`,
`enc_blocks/...`, and every cache leaf) on a leading axis; the port keeps a
Python list with one dict per super-block (`interop.py`). A per-super-block
leaf's spec here is the JAX stacked spec without its leading entry, which
is None everywhere except on a pipeline mesh: there the JAX package puts
"pipe" on the stacked params' leading dim when the super-block count
divides the stages, and the port splits the LIST instead, super-block b on
stage b // (n / pipe) (`super_block_axis`). `stack_spec` rebuilds the JAX
spec from a port spec, and `canonical` drops trailing None entries, which
place a tensor no differently.

Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, NamedTuple, Optional, \
    Sequence, Tuple

import torch

# (regex on path, [(dim, (axes preference tuples...)), ...]); dim indices
# are for the per-super-block (unstacked) leaf
_PARAM_RULES: List[Tuple[str, List[Tuple[int, Sequence[Any]]]]] = [
    # order matters: specific (moe/...) before generic; first match wins
    (r"moe/(w1|w3)$",         [(0, ("model",)), (2, ("data",))]),
    (r"moe/w2$",              [(0, ("model",)), (1, ("data",))]),
    (r"embed$",               [(0, ("model", "data")), (1, ("data",))]),
    (r"lm_head$",             [(1, ("model", "data")), (0, ("data",))]),
    (r"(wq|wk|wv|w1|w3)$",    [(1, ("model",)), (0, ("data",))]),
    (r"(wo|w2|out_proj)$",    [(0, ("model",)), (1, ("data",))]),
    (r"in_proj$",             [(1, ("model",)), (0, ("data",))]),
    (r"router$",              [(0, ("data",))]),
    (r"conv_w$",              [(1, ("model",))]),
    (r"(bq|bk|bv|conv_b)$",   [(0, ("model",))]),
    # norms, a_log, d_skip, dt_bias, scalars: replicated (no rule)
]

_CACHE_RULES: List[Tuple[str, List[Tuple[int, Sequence[Any]]]]] = [
    (r"(^|/)(k|v|xk|xv)$", [(0, (("pod", "data"), "data")),
                            (1, ("model",)),
                            (2, ("model", "data", ("model", "data")))]),
    # paged pool (local-id mode): (slots, nb+1, H, page, D): the slot dim
    # rides the batch axes, heads ride 'model'; page rows never split
    (r"(^|/)(pk|pv)$",     [(0, (("pod", "data"), "data")),
                            (2, ("model",))]),
    (r"(^|/)table$",       [(0, (("pod", "data"), "data"))]),
    (r"conv$",             [(0, (("pod", "data"), "data")),
                            (2, ("model",))]),
    (r"ssm$",              [(0, (("pod", "data"), "data")),
                            (1, ("model",)),
                            (3, ("model",))]),
    # the per-slot ring write pointer rides the same slot axis as the K/V
    # batch dim: a replicated `step` under a slot-sharded cache would make
    # every ring insert a cross-shard broadcast
    (r"(^|/)step$",        [(0, (("pod", "data"), "data"))]),
]

# MoE sharded over 'model': expert dim of the dispatch buffers
_EXPERT_RULE = [(0, ("model",))]

# "cp" profile: no TP; both mesh axes do FSDP (ZeRO-3 2D), compute is
# sequence-sharded and window attention runs halo-exchange context
# parallelism. Weights are gathered on use. MoE keeps EP.
_PARAM_RULES_CP: List[Tuple[str, List[Tuple[int, Sequence[Any]]]]] = [
    (r"moe/(w1|w3|w2)$",      [(0, ("model",)), (1, ("data",))]),
    (r"embed$",               [(0, (("data", "model"), "data", "model")),
                               (1, ("data",))]),
    (r"lm_head$",             [(1, (("data", "model"), "data", "model")),
                               (0, ("data",))]),
    (r"(wq|wk|wv|w1|w3|wo|w2|out_proj|in_proj)$",
                              [(0, (("data", "model"), "data")),
                               (1, (("data", "model"), "data"))]),
    (r"router$",              [(0, ("data",))]),
    (r"conv_w$",              [(1, (("data", "model"), "data"))]),
    (r"(bq|bk|bv|conv_b)$",   [(0, (("data", "model"), "data"))]),
]

# "fsdp": the "cp" parameter placement with batch-parallel compute
_PROFILES = {"tp": None, "cp": _PARAM_RULES_CP, "fsdp": _PARAM_RULES_CP}
PROFILES = tuple(_PROFILES)

SLOT_AXES = ("pod", "data")


class P(tuple):
    """A partition spec: one entry per tensor dim (None, an axis name, or
    a tuple of axis names). As in JAX, a one-name tuple is that name and
    an empty tuple None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e if e is None or isinstance(e, str)
            else (tuple(e) if len(e) > 1 else (e[0] if e else None))
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def canonical(spec) -> tuple:
    """The spec as a plain tuple without trailing None entries: two specs
    place a tensor the same way iff their canonical forms are equal."""
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def stack_spec(spec, lead: Optional[str] = None) -> tuple:
    """The JAX package's spec of the stacked leaf whose per-super-block
    spec is `spec` (canonical): `lead` is the stacked dim's entry, None or
    "pipe" (`super_block_axis`)."""
    return canonical((lead,) + tuple(spec))


def super_block_axis(num_blocks: int, mesh) -> Optional[str]:
    """"pipe" when a pipeline mesh splits the list of super-blocks over
    its stages (the JAX package's `pipe` rule on the stacked dim), else
    None."""
    if "pipe" in mesh.axis_names and num_blocks % mesh.shape["pipe"] == 0:
        return "pipe"
    return None


def _path_items(tree, prefix: str = ""):
    """[(path, leaf)] of a port tree (dicts and lists; a P is a leaf)."""
    if isinstance(tree, P):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _path_items(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _path_items(v, f"{prefix}/{i}" if prefix else str(i))
    elif tree is not None:
        yield prefix, tree


def _tree_map(fn, tree, prefix: str = ""):
    """fn(path, leaf) over a port tree, keeping its dicts and lists."""
    if isinstance(tree, P):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return None if tree is None else fn(prefix, tree)


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def _spec_for(shape: Tuple[int, ...], rules, mesh, shift: int = 0) -> P:
    assignment: List[Optional[Any]] = [None] * len(shape)
    used: set = set()
    for dim, prefs in rules:
        d = dim + shift
        if d >= len(shape):
            continue
        for axes in prefs:
            names = (axes,) if isinstance(axes, str) else tuple(axes)
            if any(n not in mesh.axis_names for n in names):
                continue
            if any(n in used for n in names):
                continue
            if shape[d] % _axis_size(mesh, names) != 0:
                continue
            assignment[d] = axes if isinstance(axes, str) else tuple(axes)
            used.update(names)
            break
    return P(*assignment)


def _match_rules(path: str, tables) -> Optional[List]:
    for pattern, rules in tables:
        if re.search(pattern, path):
            return rules
    return None


def param_sharding(params, mesh, profile: str = "tp"):
    """A tree of P matching `params` (per-super-block leaves under the
    stacking rule). profile: 'tp' (Megatron TP + FSDP, default), 'cp' or
    'fsdp' (2D-FSDP)."""
    if profile not in _PROFILES:
        raise ValueError(f"profile {profile!r}: one of {PROFILES}")
    tables = _PROFILES[profile] or _PARAM_RULES

    def leaf(path, x):
        rules = _match_rules(path, tables)
        return _spec_for(tuple(x.shape), rules, mesh) if rules else P()
    return _tree_map(leaf, params)


def _strip_batch_axes(spec) -> P:
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = tuple(a for a in axes if a not in SLOT_AXES)
        out.append(kept[0] if len(kept) == 1 else (kept or None))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def param_sharding_serving(params, mesh, profile: str = "tp"):
    """Inference parameter placement: the batch axes ('data'/'pod')
    REPLICATE the weights instead of FSDP-sharding them, so the decode
    and verify bodies of a slot-parallel mesh run no collective."""
    return _tree_map(lambda _, s: _strip_batch_axes(s),
                     param_sharding(params, mesh, profile))


def cache_sharding(caches, mesh):
    """A tree of P matching the decode caches (a list of per-super-block
    dicts)."""
    def leaf(path, x):
        rules = _match_rules(path, _CACHE_RULES)
        return _spec_for(tuple(x.shape), rules, mesh) if rules else P()
    return _tree_map(leaf, caches)


def batch_sharding(batch, mesh, profile: str = "tp"):
    """Leading dim over ('pod','data') when divisible, else replicate.
    fsdp profile: over ('pod','data','model'), one sequence per shard."""
    baxes = tuple(a for a in SLOT_AXES if a in mesh.axis_names)
    if profile == "fsdp":
        rules = [(0, (baxes + ("model",), baxes, "data"))]
    else:
        rules = [(0, (baxes, "data"))]
    return _tree_map(lambda _, x: _spec_for(tuple(x.shape), rules, mesh),
                     batch)


def activation_spec(mesh, sequence_parallel: bool = True,
                    profile: str = "tp") -> P:
    """(B, L, D) activations at super-block boundaries. tp/cp: batch over
    ('pod','data'), sequence over 'model'; fsdp: batch over
    ('pod','data','model')."""
    baxes = tuple(a for a in SLOT_AXES if a in mesh.axis_names)
    if profile == "fsdp":
        return P(baxes + ("model",), None, None)
    return P(baxes, "model" if sequence_parallel else None, None)


def decode_batch_sharding(tree, mesh, slots: int, slot_dim: int = 0):
    """Serving decode-state placement: a leaf whose `slot_dim` equals the
    engine's slot count rides the slot axes over ('pod','data')
    (divisibility permitting); everything else replicates. slot_dim is
    explicit: the (n, slots) token blocks pass slot_dim=1, and when n
    happens to equal the slot count a guess would shard the time axis."""
    baxes = tuple(a for a in SLOT_AXES if a in mesh.axis_names)
    rules = [(0, (baxes, "data"))]

    def leaf(_, x):
        shape = tuple(x.shape)
        if len(shape) > slot_dim and shape[slot_dim] == slots:
            return _spec_for(shape, rules, mesh, shift=slot_dim)
        return P()
    return _tree_map(leaf, tree)


def replicated(mesh) -> P:
    return P()


# ------------------------------------------------------------ placement --

def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_at(x: torch.Tensor, spec, mesh, coord: Dict[str, int]
             ) -> torch.Tensor:
    """The shard of the global tensor `x` at mesh coordinate `coord`
    ({axis: index}): each dim with an entry is cut into the product of its
    axes' sizes, and the coordinate's block is kept (the first axis of a
    tuple entry is the major one). A view of x."""
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        n, i = 1, 0
        for a in axes:
            n, i = n * mesh.shape[a], i * mesh.shape[a] + coord[a]
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide "
                             f"over {axes}")
        x = x.narrow(d, i * (x.shape[d] // n), x.shape[d] // n)
    return x


def placements(spec, mesh_dim_names: Sequence[str]) -> list:
    """The `torch.distributed.tensor` placements of a spec on a DeviceMesh
    with these dim names: Shard(d) on each mesh dim that splits tensor dim
    d, Replicate() elsewhere. A tuple entry must name its axes in the
    mesh's order (DTensor splits a dim over several mesh dims major to
    minor in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh_dim_names]
    order = list(mesh_dim_names)
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if [order.index(a) for a in axes] != sorted(order.index(a)
                                                      for a in axes):
            raise ValueError(f"entry {entry} splits dim {d} against the "
                             f"mesh order {tuple(mesh_dim_names)}")
        for a in axes:
            out[order.index(a)] = Shard(d)
    return out


class NamedSharding(NamedTuple):
    """A mesh and a spec: the JAX package's NamedSharding, as the train
    launcher passes the activation layout (`activation_spec`) to
    `steps.make_train_step(act_sharding=)` and `Trainer(act_sharding=)`.
    `profile` names the parameter placement the layout belongs to ("tp",
    "cp" or "fsdp"): the JAX package hands the jit the params' shardings
    and turns context parallelism on globally, where the port's train step
    takes both from here (the tp and cp layouts are the same spec)."""
    mesh: Any
    spec: P
    profile: str = "tp"


def _block_key(spec, mesh, coord) -> tuple:
    return tuple((d, tuple(coord[a] for a in entry_axes(e)))
                 for d, e in enumerate(spec) if e is not None)


class Placement:
    """Where every leaf of a global tree lies on a mesh: `spec_of(path)`
    gives the spec of the leaf at a `repro_torch.tree` path. A placed tree
    is a list over the mesh's local coordinates (`mesh.coords()`) of trees
    of shards; the replicas of one shard on a LocalMesh are one tensor.
    `CheckpointManager.save` / `restore(sharding=)` take a Placement:
    checkpoints hold the gathered global leaves, so a run saved on one
    mesh restores onto another."""

    def __init__(self, mesh, spec_of: Callable[[str], Any]):
        self.mesh, self.spec_of = mesh, spec_of
        self.coords = mesh.coords()

    @property
    def is_writer(self) -> bool:
        """Whether this process writes a gathered tree (the coordinate
        (0, ..., 0) is local)."""
        return any(not any(c.values()) for c in self.coords)

    def place(self, tree) -> list:
        """Each local coordinate's tree of shards (contiguous copies)."""
        from repro_torch import tree as T
        items = T.flatten_with_paths(tree)
        memo: Dict[tuple, torch.Tensor] = {}
        out = []
        for coord in self.coords:
            leaves = []
            for path, x in items:
                spec = self.spec_of(path)
                key = (id(x), _block_key(spec, self.mesh, coord))
                if key not in memo:
                    memo[key] = shard_at(x, spec, self.mesh, coord).clone(
                        memory_format=torch.contiguous_format)
                leaves.append(memo[key])
            out.append(T.unflatten(tree, leaves))
        return out

    @torch.no_grad()
    def gather(self, trees: list):
        """The global tree from the local coordinates' trees (on a
        ProcessMesh, an all-gather over each split axis: every rank calls
        it)."""
        from repro_torch import tree as T
        paths = [p for p, _ in T.flatten_with_paths(trees[0])]
        per = [T.leaves(t) for t in trees]
        out = []
        for j, path in enumerate(paths):
            xs = [leaves[j] for leaves in per]
            for d, entry in enumerate(self.spec_of(path)):
                for a in reversed(entry_axes(entry)):
                    xs = self.mesh.all_gather(xs, a, d)
            out.append(xs[0])
        return T.unflatten(trees[0], out)
