"""Serving on a mesh: the placement of a model's params and decode caches
by the rule tables (`distributed/sharding.py`), and the compute plan each
shard runs them with (the counterpart of the JAX package's
`ServingEngine(mesh=, profile=)`, where XLA partitions one program by the
same tables).

The program is SPMD over the mesh's local coordinates (`mesh.coords()`:
every shard of a LocalMesh, this rank's of a ProcessMesh). The model's own
`decode_step`, `prefill_chunk` and `prefill` run it: given a plan, every
value there is a list with one entry per local coordinate, every layer maps
over it, and the plan's hooks (`model.OneDevice`'s: embed, mixer params,
attention config, cache views, the attention reduction, FFN, unembed) add
the collectives (`psum`, `all_gather`), which act on the lists through the
mesh. A coordinate computes what its rank would.

  * Slot axes ('pod', 'data'). A coordinate holds its slot group's rows of
    every cache, slot vector and batch (`decode_batch_sharding` decides the
    split: slots that do not divide the slot axes replicate). Decode and
    verify run no collective over them.
  * 'model', Megatron TP where the table splits whole heads and whole d_ff
    columns: wq/wk/wv/w1/w3 column-parallel, wo/w2 row-parallel with one
    psum each, the decode and prefill kernels on the shard's local heads
    (and its heads of the caches); MoE experts over 'model', each shard
    combining its experts' share, then one psum; the embedding and the
    unembedding vocab-parallel where the table splits the vocab (a masked
    lookup and a psum; logits all-gathered before sampling).
  * Everything else the table splits is gathered on use (`all_gather` over
    its axes) and used whole: wk split inside a head, the mamba mixer, the
    cp and fsdp profiles' 2-D weights, and a ring whose sequence dim took
    the axis (kv heads that do not divide it, or slots that do not divide
    the slot axes). A cache gathered on use is updated whole and each
    coordinate writes back its own slice: correct, and a full gather of
    the ring a step.

The embeddings are `model.embed_tokens`'s on every coordinate: a
frontend's `"embeddings"`, or the token rows (the vocab-parallel lookup
where the table splits the vocab), then the scale and sinusoidal
positions. An encoder-decoder config (whisper) runs its encoder on each
coordinate's rows with the encoder's params gathered whole; an "xattn"
layer's cross attention gathers its params, and the cross K/V ("xk",
"xv", placed by the cache table and never written by a decode step),
whole. The engine still serves decoder-only models, as the JAX engine
does; the model functions and the train step take whisper on a mesh.

Kernel #1 plans its split for the whole slot batch's rings of the shard's
heads (slots x local kv heads), not for the rings the shard launches: the
split is the order of the decode's softmax merge, and with the
single-device engine's split a slot-parallel shard computes its slots'
outputs bit for bit as that engine does (the dense products are
row-invariant on the card and the CPU). A Megatron shard counts only its
kv / m heads, so its split is the one the single-device engine would plan
for a model of those heads.

The plan is decided per layer from the specs; `megatron(i)`, `mlp_tp(i)`,
`experts_tp(i)`, `vocab_tp` report it. Prefill returns caches in the plan's
layout before the foreign cut (`plan-local`: Megatron heads local, every
other dim whole) for the engine to insert, which cuts them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch import tree
from repro_torch.core import layers as L
from repro_torch.core import model as Mod
from repro_torch.core import moe as M
from repro_torch.core.types import ModelConfig
from repro_torch.distributed import sharding as Sh

Shards = List[torch.Tensor]

# the dims a Megatron op keeps split over 'model', by leaf name
_ATTN_KEEP = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0, "bv": 0}
_MLP_KEEP = {"w1": 1, "w3": 1, "w2": 0}
_CACHE_HEADS = {"k": 1, "v": 1, "pk": 2, "pv": 2}
# cache leaves that a decode step reads and never writes: the encoder's
# cross K/V of an "xattn" layer
_READ_ONLY = ("xk", "xv")


def resolve_mesh(mesh, device: torch.device):
    """A mesh object from the engine's or launcher's `mesh=`: a
    LocalMesh/ProcessMesh as given, or a "DxM" string (a ProcessMesh when
    a torch.distributed group is initialised, else a LocalMesh)."""
    if not isinstance(mesh, str):
        return mesh
    import torch.distributed as dist
    from repro_torch.launch import mesh as ML
    return ML.parse_mesh(mesh, process=dist.is_available()
                         and dist.is_initialized(), device_type=device.type)


def _meta(tree):
    return Sh._tree_map(lambda _, x: torch.empty(x.shape, device="meta"),
                        tree)


class PlanBase:
    """What the serving plan (`MeshPlan`) and the training plan
    (`distributed.train_parallel.TrainPlan`) share: the per-layer Megatron
    decisions, taken on the specs without the batch axes (`tp_specs`), and
    the gathering of whatever else the placement specs (`param_specs`)
    split."""

    def _init_plan(self, cfg: ModelConfig, mesh, param_specs,
                   tp_specs) -> None:
        self.cfg, self.mesh = cfg, mesh
        self.coords = mesh.coords()
        self.m = mesh.shape.get("model", 1)
        self.param_specs, self._tp_specs = param_specs, tp_specs

    # ------------------------------------------------------------ plan --
    def _split(self, entry) -> Tuple[str, ...]:
        """The axes of an entry that actually split (size > 1)."""
        return tuple(a for a in Sh.entry_axes(entry)
                     if self.mesh.shape[a] > 1)

    def _is_model(self, spec, dim: int) -> bool:
        """spec splits exactly `dim`, over 'model' (or nothing splits)."""
        for d, entry in enumerate(spec):
            axes = self._split(entry)
            if d == dim:
                if axes not in ((), ("model",)):
                    return False
            elif axes:
                return False
        return True

    def _keeps(self, path: str, dim: int) -> bool:
        """The param at `path` can stay split on `dim` under TP: its spec
        without the batch axes splits exactly `dim`, over 'model', and its
        placement splits that dim over 'model' only (a 2-D FSDP split of
        it over ('data', 'model') is gathered). With 'model' > 1 the dim
        must split: a table the rule left whole (a vocabulary that 'model'
        does not divide) is used whole."""
        spec = _leaf_at(self.param_specs, path)
        entry = spec[dim] if dim < len(spec) else None
        return (self._is_model(_leaf_at(self._tp_specs, path), dim)
                and self._split(entry) == (("model",) if self.m > 1
                                           else ()))

    def _decide(self, attn_ok=None, tp: bool = True) -> None:
        """The plan per layer position; `attn_ok(i)`: a further condition
        on Megatron attention at position i (the serving caches'); `tp`
        False keeps nothing split over 'model' (everything is gathered on
        use, as the fsdp profile's batch-parallel compute needs)."""
        cfg, m = self.cfg, self.m
        blk = self._tp_specs["blocks"][0]
        self._megatron, self._mlp_tp, self._experts_tp = {}, {}, {}
        for i, kind in enumerate(cfg.layer_pattern):
            p, at = blk[f"l{i}"], f"blocks/0/l{i}"
            if not Mod._is_mamba(kind):
                a = Mod.attn_cfg(cfg, kind, index=i)
                self._megatron[i] = tp and (
                    a.num_heads % m == 0 and a.num_kv_heads % m == 0
                    and all(self._keeps(f"{at}/mixer/{k}", _ATTN_KEEP[k])
                            for k in p["mixer"])
                    and (attn_ok is None or attn_ok(i)))
            if "mlp" in p:
                self._mlp_tp[i] = tp and all(
                    self._keeps(f"{at}/mlp/{k}", d)
                    for k, d in _MLP_KEEP.items() if k in p["mlp"])
            if "moe" in p:
                self._experts_tp[i] = tp and (
                    cfg.moe.num_experts % m == 0
                    and all(self._keeps(f"{at}/moe/{k}", 0)
                            for k in ("w1", "w2", "w3")))
        ps = self._tp_specs
        self.vocab_tp = tp and "embed" in ps and self._keeps("embed", 0)
        self.head_tp = (self.vocab_tp if cfg.tie_embeddings
                        else tp and self._keeps("lm_head", 1))

    def megatron(self, i: int) -> bool:
        return self._megatron[i]

    def mlp_tp(self, i: int) -> bool:
        return self._mlp_tp.get(i, False)

    def experts_tp(self, i: int) -> bool:
        return self._experts_tp.get(i, False)

    def member(self, coord) -> int:
        return coord.get("model", 0)

    # --------------------------------------------------------- gathering --
    def _foreign(self, spec, keep: Sequence[int]) -> Sh.P:
        """The entries of spec outside the plan's dims `keep` that split."""
        return Sh.P(*(None if d in keep or not self._split(e) else e
                      for d, e in enumerate(spec)))

    def gather(self, xs: Shards, spec, keep: Sequence[int] = ()) -> Shards:
        """All-gather each coordinate's shard over its foreign axes: the
        plan-local tensor (dims in `keep` stay split)."""
        for d, entry in enumerate(self._foreign(spec, keep)):
            for a in reversed(Sh.entry_axes(entry)):
                xs = self.mesh.all_gather(xs, a, d)
        return xs

    def cut(self, x: torch.Tensor, spec, keep: Sequence[int],
            coord) -> torch.Tensor:
        """A plan-local tensor's part at coord (the inverse of gather)."""
        return Sh.shard_at(x, self._foreign(spec, keep), self.mesh, coord)

    # ----------------------------------------------------------- hooks --
    def _params_of(self, ps: List[dict], specs: dict,
                   keep: Dict[str, int]) -> List[dict]:
        """Per coordinate, the param dict `ps` with every foreign split
        gathered (the leaves named in `keep` stay split on that dim)."""
        out = [{} for _ in ps]
        for name in ps[0]:
            xs = [p[name] for p in ps]
            if isinstance(xs[0], dict):
                parts = self._params_of(xs, specs[name], {})
            else:
                k = (keep[name],) if name in keep else ()
                parts = self.gather(xs, specs[name], k)
            for d, x in zip(out, parts):
                d[name] = x
        return out

    def embed(self, ps, cfg: ModelConfig, batches) -> Shards:
        """The model's embeddings per coordinate (`model.embed_tokens`: a
        frontend's `"embeddings"`, or the tokens' rows, then the scale and
        the sinusoidal positions): the lookup is vocab-parallel, each shard
        its rows and a psum, where the table splits the vocab."""
        rows = [None] * len(batches)
        if "embeddings" not in batches[0]:
            tokens = [b["tokens"] for b in batches]
            tables = [p["embed"] for p in ps]
            if self.vocab_tp and self.m > 1:
                tables = self.gather(tables, self.param_specs["embed"],
                                     keep=(0,))
                rows = self.mesh.psum([
                    Mod.embed_lookup(tab, tok, self.member(c) * tab.shape[0])
                    for tok, tab, c in zip(tokens, tables, self.coords)],
                    "model")
            else:
                tables = self.gather(tables, self.param_specs["embed"])
                rows = [Mod.embed_lookup(tab, tok)
                        for tok, tab in zip(tokens, tables)]
        return [Mod.embed_tokens(p, cfg, b, rows=r)
                for p, b, r in zip(ps, batches, rows)]

    def _whole_params(self, trees, specs):
        """Per coordinate, the tree `trees[k]` with every split gathered."""
        items = [tree.flatten_with_paths(t) for t in trees]
        spec_of = dict(Sh._path_items(specs))
        out = [[] for _ in trees]
        for j, (path, _) in enumerate(items[0]):
            for o, x in zip(out, self.gather([it[j][1] for it in items],
                                             spec_of[path])):
                o.append(x)
        return [tree.unflatten(t, o) for t, o in zip(trees, out)]

    def encode(self, ps, cfg: ModelConfig, batches, impl=None) -> Shards:
        """The whisper encoder on each coordinate's rows, its params
        gathered whole (`model.encode`: the bidirectional dense stack)."""
        specs = {k: self.param_specs[k] for k in ("enc_blocks", "enc_norm")}
        encs = self._whole_params([{k: p[k] for k in specs} for p in ps],
                                  specs)
        return [Mod.encode(e, cfg, b, impl=impl)
                for e, b in zip(encs, batches)]

    def _cross_specs(self, i: int):
        return self.param_specs["blocks"][0][f"l{i}"]["cross"]

    def cross_params(self, ps, sb: int, i: int) -> List[dict]:
        """Per coordinate, "xattn" layer i's cross-attention params,
        gathered whole (its heads attend the whole cross K/V)."""
        return self._params_of([p["blocks"][sb][f"l{i}"]["cross"]
                                for p in ps], self._cross_specs(i), {})

    def layer_cross(self, lps, i: int) -> List[dict]:
        return self._params_of([p["cross"] for p in lps],
                               self._cross_specs(i), {})

    def attn_cfg(self, cfg: ModelConfig, kind: str, i: int):
        a = Mod.attn_cfg(cfg, kind, index=i)
        if self.megatron(i):
            a = dataclasses.replace(a, num_heads=a.num_heads // self.m,
                                    num_kv_heads=a.num_kv_heads // self.m)
        return a

    def attn_out(self, i: int, ys: Shards) -> Shards:
        """One psum over 'model' of a Megatron layer's row-parallel wo."""
        return self.mesh.psum(ys, "model") if self.megatron(i) else ys

    def attention(self, i: int, ws, acfg, hs, impl) -> Shards:
        return Mod.OneDevice.attention(self, i, ws, acfg, hs, impl)

    def whole(self, fn, hs) -> Shards:
        return fn(hs)



class MeshPlan(PlanBase):
    """The placement and compute plan of one config on one mesh for an
    engine of `slots` slots."""

    def __init__(self, cfg: ModelConfig, mesh, params, *, slots: int,
                 max_len: int, lookahead: int, paged: bool,
                 profile: str = "tp", enc_len: int = 0):
        self.profile, self.enc_len = profile, enc_len
        self.slots, self.max_len, self.lookahead = slots, max_len, lookahead
        self.paged = paged
        specs = Sh.param_sharding_serving(_meta(params), mesh, profile)
        self._init_plan(cfg, mesh, specs, specs)
        vec = Sh.decode_batch_sharding(
            {"v": torch.empty((slots,), device="meta")}, mesh, slots)["v"]
        self.slot_axes = Sh.entry_axes(vec[0]) if len(vec) else ()
        self.groups = 1
        for a in self.slot_axes:
            self.groups *= mesh.shape[a]
        self.spg = slots // self.groups                  # slots per group
        self.cache_specs = Sh.cache_sharding(
            self._cache_shapes(slots), mesh)
        # the contiguous rings' specs: prefill's caches, before insertion
        self.ring_specs = Sh.cache_sharding(Mod.init_caches(
            cfg, slots, max_len, enc_len=enc_len, lookahead=lookahead,
            device="meta"), mesh)
        self._decide(self._heads_ride_model)

    def _heads_ride_model(self, i: int) -> bool:
        """Layer i's cache heads split over 'model' or not at all."""
        heads = "pk" if self.paged else "k"
        return self._split(self.cache_specs[0][f"l{i}"][heads][
            _CACHE_HEADS[heads]]) in ((), ("model",))

    def describe(self) -> Dict[str, object]:
        """The plan per layer position (for logs and tests)."""
        return {"slot_axes": self.slot_axes, "groups": self.groups,
                "attention_tp": dict(self._megatron),
                "mlp_tp": dict(self._mlp_tp),
                "experts_tp": dict(self._experts_tp),
                "vocab_tp": self.vocab_tp, "head_tp": self.head_tp}

    # ------------------------------------------------------ coordinates --
    def group(self, coord: Dict[str, int]) -> int:
        """The slot group of a coordinate (0 when slots replicate)."""
        g = 0
        for a in self.slot_axes:
            g = g * self.mesh.shape[a] + coord[a]
        return g

    def slot_range(self, coord) -> Tuple[int, int]:
        """The global slots a coordinate holds: [lo, hi)."""
        g = self.group(coord)
        return g * self.spg, (g + 1) * self.spg

    def local_slots(self) -> Tuple[int, int]:
        """[lo, hi): the slots this process's coordinates hold together
        (every slot on a LocalMesh)."""
        ranges = [self.slot_range(c) for c in self.coords]
        return min(r[0] for r in ranges), max(r[1] for r in ranges)

    def representatives(self) -> List[int]:
        """Positions in coords of one coordinate per local slot group, in
        slot order: the shards whose rows make the engine's rows."""
        seen, out = set(), []
        for k, c in sorted(enumerate(self.coords),
                           key=lambda kc: self.group(kc[1])):
            if self.group(c) not in seen:
                seen.add(self.group(c))
                out.append(k)
        return out

    def slot_quantum(self) -> int:
        """The slot axes' size when the slot count shards over it (the
        JAX engine's): the scheduler keeps prefill batches multiples of
        it."""
        size = 1
        for a in Sh.SLOT_AXES:
            if a in self.mesh.axis_names:
                size *= self.mesh.shape[a]
        return size if size > 1 and self.slots % size == 0 else 1

    def splits(self, n: int) -> bool:
        """Whether a prefill batch of n rows splits over the slot groups
        (they divide it); else every group prefills every row."""
        return self.groups > 1 and n % self.groups == 0

    def gather_slots(self, xs: Shards, dim: int = 0) -> Shards:
        """All-gather over the slot axes (minor first): each coordinate
        receives every slot group's rows."""
        for a in reversed(self.slot_axes):
            xs = self.mesh.all_gather(xs, a, dim)
        return xs

    # --------------------------------------------------------- placement --
    def place_params(self, params) -> List[dict]:
        """Each coordinate's shard of every param (a copy: replicas of one
        shard share it)."""
        memo: Dict[tuple, torch.Tensor] = {}

        def one(coord):
            def leaf(path, x):
                spec = _leaf_at(self.param_specs, path)
                key = (id(x), _block_key(spec, self.mesh, coord))
                if key not in memo:
                    memo[key] = Sh.shard_at(x, spec, self.mesh,
                                            coord).clone()
                return memo[key]
            return Sh._tree_map(leaf, params)
        return [one(c) for c in self.coords]

    def _cache_shapes(self, batch: int, device="meta"):
        return Mod.init_caches(self.cfg, batch, self.max_len,
                               enc_len=self.enc_len,
                               lookahead=self.lookahead, paged=self.paged,
                               shared_pool=False, device=device)

    def init_caches(self, device) -> List[list]:
        """Each coordinate's zeroed shard of the slot caches (a layer's
        paged table stays one tensor per coordinate, shared by every
        super-block)."""
        full = self._cache_shapes(self.slots, device)
        out = []
        for coord in self.coords:
            memo: Dict[int, torch.Tensor] = {}

            def leaf(path, x, coord=coord):
                if id(x) not in memo:
                    spec = _leaf_at(self.cache_specs, path)
                    memo[id(x)] = Sh.shard_at(x, spec, self.mesh,
                                              coord).clone()
                return memo[id(x)]
            out.append(Sh._tree_map(leaf, full))
        return out

    def cache_keep(self, i: int, name: str) -> Tuple[int, ...]:
        """The dims of cache leaf `name` of layer i that the plan keeps
        split: the slot dim, and the heads under Megatron attention."""
        keep = (0,) if self.slot_axes else ()
        if name in _CACHE_HEADS and self._megatron.get(i):
            keep += (_CACHE_HEADS[name],)
        return keep

    def prefill_cut(self, i: int, name: str, x: torch.Tensor,
                    coord) -> torch.Tensor:
        """A plan-local contiguous prefill cache leaf's rows cut to the
        coordinate's slot cache layout (the slot dim is the caller's). A
        paged layer's K or V rows are cut as its pool is: heads by the
        pool's heads entry."""
        if self.paged and name in ("k", "v"):
            pool = self.cache_specs[0][f"l{i}"]["p" + name]
            spec = Sh.P(None, pool[2] if len(pool) > 2 else None)
            keep = (1,) if self._megatron.get(i) else ()
            return self.cut(x, spec, keep, coord)
        spec = self.ring_specs[0][f"l{i}"][name]
        return self.cut(x, spec, tuple(self.cache_keep(i, name)) + (0,),
                        coord)

    # ------------------------------------------------------------ rows --
    def local_rows(self, x: torch.Tensor, lo: int) -> Shards:
        """Per coordinate, its slot group's rows of x, which holds the
        local slots [lo, ...) (the engine's)."""
        return [x[a - lo:b - lo] for a, b in map(self.slot_range,
                                                 self.coords)]

    def join_rows(self, xs: Shards) -> torch.Tensor:
        """The local slots' rows from per-coordinate rows: one coordinate
        per local slot group, in slot order."""
        reps = self.representatives()
        return (xs[reps[0]] if len(reps) == 1
                else torch.cat([xs[k] for k in reps]))

    def chunk_caches(self, rows: int, device) -> List[list]:
        """Zeroed plan-local contiguous caches of `rows` prefill rows per
        coordinate (the chunked-prefill carry)."""
        full = Mod.init_caches(self.cfg, rows, self.max_len,
                               lookahead=self.lookahead, device=device)
        out = []
        for coord in self.coords:
            def leaf(path, x, coord=coord):
                i, name = _layer_leaf(path)
                spec = self.ring_specs[0][f"l{i}"][name]
                keep = [d for d in self.cache_keep(i, name) if d != 0]
                return Sh.shard_at(x, Sh.P(*(
                    e if d in keep else None for d, e in enumerate(spec))),
                    self.mesh, coord).clone()
            out.append(Sh._tree_map(leaf, full))
        return out

    def caches_from_prefill(self, caches: List[list]) -> List[list]:
        """Each coordinate's slot caches (contiguous layout) from
        `model.prefill`'s plan-local caches of a batch that holds every
        slot in order: the rows gathered over the slot axes where the
        prefill split them, then each coordinate's slots cut to its
        layout, as the engine's insert cuts them."""
        if self.paged:
            raise ValueError("caches_from_prefill: the contiguous layout")
        items = [tree.flatten_with_paths(c) for c in caches]
        if self.splits(self.slots):
            cols = [self.gather_slots([it[j][1] for it in items])
                    for j in range(len(items[0]))]
            items = [[(p, col[k]) for (p, _), col in zip(items[0], cols)]
                     for k in range(len(caches))]
        out = []
        for c, it, coord in zip(caches, items, self.coords):
            lo, hi = self.slot_range(coord)
            leaves = []
            for path, x in it:
                i, name = _layer_leaf(path)
                leaves.append(self.prefill_cut(i, name, x[lo:hi],
                                               coord).clone())
            out.append(tree.unflatten(c, leaves))
        return out

    # ----------------------------------------------------------- hooks --
    # `model.OneDevice`'s hooks on the mesh, for the model's forward: ps
    # are the local coordinates' param shards (`place_params`), caches
    # their cache trees, xs their activations.

    def unembed(self, ps, cfg: ModelConfig, xs) -> Shards:
        """fp32 logits per coordinate (`model._unembed`): vocab-parallel
        head products all-gathered over 'model' where the table splits the
        vocab."""
        xs = [L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
              for p, x in zip(ps, xs)]
        if cfg.tie_embeddings:
            heads = [p["embed"].t() for p in ps]
            e = tuple(self.param_specs["embed"]) + (None, None)
            spec = Sh.P(e[1], e[0])
        else:
            heads = [p["lm_head"] for p in ps]
            spec = self.param_specs["lm_head"]
        if not self.head_tp:
            heads = self.gather(heads, spec)
        out = []
        for x, head in zip(xs, heads):
            lg = Mod._head_product(x.reshape(-1, x.shape[-1]), head)
            out.append(L.softcap(lg.reshape(*x.shape[:-1], head.shape[1]),
                                 cfg.final_softcap))
        if self.head_tp:
            out = self.mesh.all_gather(out, "model", out[0].dim() - 1)
        return out

    def mixer(self, ps, sb: int, i: int) -> List[dict]:
        specs = self.param_specs["blocks"][0][f"l{i}"]["mixer"]
        keep = _ATTN_KEEP if self._megatron.get(i) else {}
        return self._params_of(
            [p["blocks"][sb][f"l{i}"]["mixer"] for p in ps], specs, keep)

    def split_rings(self, acfg) -> int:
        """Kernel #1's split planned for the whole slot batch's rings of the
        shard's heads (the single-device engine's plan when 'model' does not
        split them; see the module docstring)."""
        return self.slots * acfg.num_kv_heads

    def cache_views(self, caches: List[list], sb: int, i: int
                    ) -> Tuple[List[dict], bool]:
        """Per coordinate, layer i's decode cache leaves with every foreign
        split gathered, and whether any was (the caller then writes back)."""
        kind = self.cfg.layer_pattern[i]
        if Mod._is_mamba(kind):
            names = ("conv", "ssm")
        else:
            names = (("pk", "pv", "table", "step") if self.paged
                     else ("k", "v", "step"))
        if kind == "xattn":
            names += _READ_ONLY
        specs = self.cache_specs[0][f"l{i}"]
        views = [{} for _ in caches]
        gathered = False
        for name in names:
            xs = [c[sb][f"l{i}"][name] for c in caches]
            keep = self.cache_keep(i, name)
            if any(self._foreign(specs[name], keep)):
                gathered = True
                xs = self.gather(xs, specs[name], keep)
                # a LocalMesh line shares one gathered tensor: each shard
                # updates its own copy (a state update need not be
                # idempotent)
                seen = set()
                xs = [x.clone() if id(x) in seen or seen.add(id(x)) else x
                      for x in xs]
            for v, x in zip(views, xs):
                v[name] = x
        return views, gathered

    def write_back(self, caches: List[list], sb: int, i: int,
                   views: List[dict]) -> None:
        specs = self.cache_specs[0][f"l{i}"]
        for c, v, coord in zip(caches, views, self.coords):
            for name, x in v.items():
                dst = c[sb][f"l{i}"][name]
                if x is not dst and name not in _READ_ONLY:
                    dst.copy_(self.cut(x, specs[name],
                                       self.cache_keep(i, name), coord))

    def ffn(self, ps, cfg: ModelConfig, sb: int, i: int,
            xs: Shards) -> Shards:
        """The serving FFN (`model._ffn`) per coordinate: Megatron MLP or
        expert-parallel dense MoE with one psum, else gathered weights."""
        lps = [p["blocks"][sb][f"l{i}"] for p in ps]
        if "moe" not in lps[0] and "mlp" not in lps[0]:
            return xs
        hs = [L.rmsnorm(p["norm2"], x, cfg.norm_eps)
              for p, x in zip(lps, xs)]
        specs = self.param_specs["blocks"][0][f"l{i}"]
        if "moe" in lps[0]:
            tp = self.experts_tp(i)
            keep = {"w1": 0, "w2": 0, "w3": 0} if tp else {}
            ws = self._params_of([p["moe"] for p in lps], specs["moe"], keep)
            parts = []
            for h, w, c in zip(hs, ws, self.coords):
                xf = h.reshape(-1, h.shape[-1])
                _, gates, ids = M._route(w, xf, cfg.moe.top_k)
                lo = self.member(c) * w["w1"].shape[0] if tp else 0
                parts.append(M.dense_partial(w, xf, gates, ids,
                                             cfg.moe.num_experts, lo))
            if tp:
                parts = self.mesh.psum(parts, "model")
            ys = [y.to(h.dtype).reshape(h.shape) for y, h in zip(parts, hs)]
        else:
            tp = self.mlp_tp(i)
            ws = self._params_of([p["mlp"] for p in lps], specs["mlp"],
                                 _MLP_KEEP if tp else {})
            ys = [L.mlp(w, h) for w, h in zip(ws, hs)]
            if tp:
                ys = self.mesh.psum(ys, "model")
        return [x + y for x, y in zip(xs, ys)]


def _leaf_at(specs, path: str):
    node = specs
    for part in path.split("/"):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def _layer_leaf(path: str) -> Tuple[int, str]:
    """(layer position, leaf name) of a cache path "b/l{i}/name"."""
    _, layer, name = path.split("/")
    return int(layer[1:]), name


def _block_key(spec, mesh, coord) -> tuple:
    return tuple((d, tuple(coord[a] for a in Sh.entry_axes(e)))
                 for d, e in enumerate(spec) if e is not None)
