"""Training on a mesh: the placement of a model's params and optimizer state
by the `tp` rule table (`distributed/sharding.py`) and the compute plan
each shard trains with (the counterpart of the JAX launcher's jit with
param, optimizer and activation shardings, where XLA partitions one
program: `src/repro/launch/train.py`).

A mesh train step computes the single-device loss, gradients and updated
params; the layout changes where each value lives and which collective
moves it, not what is computed. The program is SPMD over the mesh's local
coordinates, as the serving plan's is (`tensor_parallel.py`): the model's
own `loss_fn` runs it with `plan=`, every value there a list with one entry
per local coordinate, and this plan's hooks add the collectives.

  * Placement. Params by `Sh.param_sharding(profile="tp")`: Megatron dims
    over 'model', FSDP over 'data'. The optimizer moments and the error
    feedback residual like the params, the step replicated. On a LocalMesh
    the replicas of one shard are ONE tensor, so autograd sums its
    cotangents over the coordinates that read it (JAX's transpose of a
    replicated in_spec) and AdamW updates it once; on a ProcessMesh every
    rank holds its own copy, the step all-reduces each leaf's gradient over
    the axes that replicate it, and every copy takes the same update.
  * Batch. Each coordinate takes its rows of the global batch over the
    batch axes ('pod', 'data'), every position.
  * Activations. At super-block boundaries the residual is laid out by the
    activation spec: with sequence parallelism (sequence over 'model') each
    coordinate keeps its block of positions, which is what a remat region
    saves; a super-block all-gathers it over 'model' on entry and runs on
    the whole sequence of its rows, replicated over 'model'.
  * Inside a super-block, Megatron TP over 'model' where the table splits
    whole heads and whole d_ff columns (one psum after wo and after w2),
    each shard's attention on its local heads through `ops.swat_attention`
    (kernels #2, #4 and #5 on CUDA tensors); everything else the table
    splits is all-gathered on use (the FSDP 'data' splits always; a mixer
    whose heads do not divide 'model'; the mamba mixer), the gather's
    backward being the reduce-scatter of the cotangents.
  * MoE. The "sort" dispatch keeps its global capacity: each slot is
    ranked within its expert over the global batch from the expert ids
    gathered over the batch axes, so the same slots drop as on one device;
    each shard runs its experts (split over 'model' where they divide it)
    on its own kept slots and a psum over 'model' combines them. "dense"
    runs every local expert on every token, then the psum. "ep" with
    `moe.set_expert_parallel(mesh)` on this plan's mesh runs
    `moe_ep.moe_ffn_ep_local` on each shard's sequence slice (the JAX
    shard_map's view, the batch axes' rows ranked globally), then gathers
    the outputs over 'model'. The aux loss is the global statistic: the
    routed counts and the router probabilities summed over the batch axes.
  * Embedding and unembedding. The lookup is vocab-parallel over 'model'
    where the table splits the vocab (a masked lookup and a psum), after
    the 'data' splits are gathered. The head is gathered whole and each
    coordinate takes fp32-accumulated logits of its own positions only.
  * Objective. Every token's loss is counted on exactly one coordinate: its
    rows' coordinate, and of a 'model' line the member whose block of
    positions holds it (the sequence parallel block, or an even split of
    the positions without sequence parallelism). Each coordinate's
    objective is its summed token losses over the global token count,
    plus, on coordinate (0, ..., 0), the aux term; the other coordinates
    add the aux term times zero, so every rank runs the backward of every
    collective. The objectives' sum is the single-device loss.
  * The step. `launch.steps.make_train_step(act_sharding=)` runs its one
    step body through this plan's hooks (`train_loss`, `reduce_grads`,
    `global_norm`, `amax_reduce`). The clipping norm counts each logical
    element once (a replicated shard on its coordinate with index 0 on the
    replicating axes), summed over the mesh; int8 compression scales each
    leaf by its max over all its shards (a pmax), as the JAX package's jit
    does over the whole leaf.

Profiles (`Sh.param_sharding(profile=)`, `sharding.NamedSharding.profile`):
  * "tp": the above.
  * "cp": 2-D FSDP over ('data', 'model') and no tensor-parallel dims
    (every weight gathered on use), experts still over 'model'. The
    residual stays split over 'model' by sequence through the whole
    super-block: each window attention layer that context parallelism
    takes (`kernels.ops.cp_eligible`) projects its block of positions
    (roped at their global positions) and runs the halo exchange over
    'model' (`context_parallel.swat_attention_cp_local`, kernels #2, #4
    and #5 on CUDA tensors); the dense MLP runs on the block; every other
    mixer (dense or global attention, mamba) and the MoE FFN all-gather
    the block over 'model', run on the whole sequence of the rows and
    keep their block of the result (`whole`).
  * "fsdp": the same placement with batch-parallel compute: the batch is
    split over every axis ('pod', 'data', 'model'), each coordinate runs
    its own rows whole, and nothing stays split over 'model' (the
    experts too are gathered; expert parallelism is refused).

The whisper encoder-decoder trains on every profile: each coordinate runs
the encoder on its rows with the encoder's params gathered whole, and its
"xattn" layers' cross attention with their params gathered whole.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch import tree
from repro_torch.core import layers as L
from repro_torch.core import model as Mod
from repro_torch.core import moe as M
from repro_torch.core import moe_ep as EP
from repro_torch.core.types import ModelConfig
from repro_torch.distributed import context_parallel as CP
from repro_torch.distributed import sharding as Sh
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import ops as kops

Shards = List[torch.Tensor]

# the prefixes of a train state's leaves placed like a param
_STATE_PREFIXES = ("params/", "opt/mu/", "opt/nu/", "residual/")


class TrainPlan(TP.PlanBase):
    """The placement and compute plan of one config on one mesh for
    training under `profile`, with the activation layout `act_spec`
    (`Sh.activation_spec`: tp, batch over the batch axes, sequence over
    'model' or not; cp, the sequence over 'model'; fsdp, the batch over
    every axis)."""

    def __init__(self, cfg: ModelConfig, mesh, act_spec=None,
                 profile: str = "tp"):
        if "model" not in mesh.axis_names:
            raise ValueError(f"{mesh}: mesh training needs a 'model' axis")
        if profile not in Sh.PROFILES:
            raise ValueError(f"profile {profile!r}: one of {Sh.PROFILES}")
        self.profile, self.cp = profile, profile == "cp"
        baxes = tuple(a for a in Sh.SLOT_AXES if a in mesh.axis_names)
        self.batch_axes = baxes + (("model",) if profile == "fsdp" else ())
        act_spec = (Sh.activation_spec(mesh, sequence_parallel=self.cp,
                                       profile=profile)
                    if act_spec is None else act_spec)
        seq = {"tp": (None, "model"), "cp": ("model",),
               "fsdp": (None,)}[profile]
        if (len(act_spec) < 2 or Sh.entry_axes(act_spec[0])
                != self.batch_axes or act_spec[1] not in seq):
            raise NotImplementedError(
                f"activation spec {act_spec}: the {profile} profile's "
                f"(batch over {self.batch_axes}, sequence over "
                f"{' or '.join(map(str, seq))})")
        self.sp = act_spec[1] == "model"
        meta = Mod.init_model(cfg, device="meta")
        self._init_plan(cfg, mesh, Sh.param_sharding(meta, mesh, profile),
                        Sh.param_sharding_serving(meta, mesh, profile))
        self._decide(tp=profile != "fsdp")
        # the 'model' members that split a row's positions (for counting
        # its tokens, or by sequence parallelism): none under fsdp, whose
        # 'model' members hold other rows
        self.seq_split = 1 if profile == "fsdp" else self.m
        self._paths = {p: s for p, s in Sh._path_items(self.param_specs)}
        self.rows = 1
        for a in self.batch_axes:
            self.rows *= mesh.shape[a]

    def describe(self) -> Dict[str, object]:
        return {"profile": self.profile, "batch_axes": self.batch_axes,
                "sequence_parallel": self.sp,
                "attention_tp": dict(self._megatron),
                "mlp_tp": dict(self._mlp_tp),
                "experts_tp": dict(self._experts_tp),
                "vocab_tp": self.vocab_tp}

    # --------------------------------------------------------- placement --
    def spec_of(self, path: str):
        """The spec of a param or train-state leaf (`tree` path): a param's
        table spec for the params, moments and residual, P() else (the
        optimizer step)."""
        if path in self._paths:
            return self._paths[path]
        for pre in _STATE_PREFIXES:
            if path.startswith(pre) and path[len(pre):] in self._paths:
                return self._paths[path[len(pre):]]
        return Sh.P()

    def placement(self) -> Sh.Placement:
        return Sh.Placement(self.mesh, self.spec_of)

    def place(self, tree_) -> list:
        """Each local coordinate's shards of a global params or state
        tree."""
        return self.placement().place(tree_)

    def gather_tree(self, trees: list):
        """The global tree of a placed tree (a list over the local
        coordinates)."""
        return self.placement().gather(trees)

    def batch_rows(self, batch: Dict[str, torch.Tensor]) -> List[dict]:
        """Each local coordinate's rows of a global batch."""
        spec = Sh.P(self.batch_axes)
        out = []
        for c in self.coords:
            d = {}
            for k, v in batch.items():
                if v.shape[0] % self.rows:
                    raise ValueError(f"batch {k} of {tuple(v.shape)} does "
                                     f"not divide over {self.batch_axes}")
                d[k] = Sh.shard_at(v, spec, self.mesh, c)
            out.append(d)
        return out

    # ------------------------------------------------------------ layout --
    def _block(self, coord, length: int) -> Tuple[int, int]:
        """[a, b): the positions a 'model' member holds or counts."""
        if self.seq_split == 1:
            return 0, length
        bounds = torch.tensor_split(torch.arange(length), self.m)[
            self.member(coord)]
        if not len(bounds):
            return length, length
        return int(bounds[0]), int(bounds[-1]) + 1

    def constrain(self, xs: Shards) -> Shards:
        """The residual to the activation layout: under sequence
        parallelism each coordinate keeps its block of positions."""
        if not self.sp or self.m == 1:
            return xs
        length = xs[0].shape[1]
        if length % self.m:
            raise ValueError(f"sequence parallelism: {length} positions "
                             f"over model={self.m}")
        return [x[:, slice(*self._block(c, length))].contiguous()
                for x, c in zip(xs, self.coords)]

    def _whole_seq(self, xs: Shards) -> Shards:
        """The whole sequence of each coordinate's rows."""
        if not self.sp or self.m == 1:
            return xs
        return self.mesh.all_gather(xs, "model", 1)

    def block_output(self, xs: Shards) -> Shards:
        """A super-block's output: re-laid to the activation layout (under
        cp it kept its block of positions)."""
        return xs if self.cp else self.constrain(xs)

    def block_input(self, xs: Shards) -> Shards:
        """A super-block's input: the whole sequence of the rows (under cp
        the block of positions, which the super-block keeps)."""
        return xs if self.cp else self._whole_seq(xs)

    def whole(self, fn, hs: Shards) -> Shards:
        """fn over the whole sequences, each coordinate keeping its block
        of the result (cp), or fn over hs."""
        if not self.cp or self.m == 1:
            return fn(hs)
        length = hs[0].shape[1] * self.m
        return [y[:, slice(*self._block(c, length))]
                for y, c in zip(fn(self._whole_seq(hs)), self.coords)]

    def attention(self, i: int, ws, acfg, hs: Shards, impl) -> Shards:
        """A self-attention layer: under cp, a window layer that context
        parallelism takes runs the halo exchange over 'model' on each
        coordinate's block of positions; any other runs `whole`."""
        def full(xs):
            return TP.PlanBase.attention(self, i, ws, acfg, xs, impl)
        length = hs[0].shape[1] * self.m
        if not self.cp or not kops.cp_eligible(acfg.spec, length, length,
                                               self.m):
            return self.whole(full, hs)
        qs, ks, vs = [], [], []
        for w, h, c in zip(ws, hs, self.coords):
            lo = self._block(c, length)[0]
            q, k, v = L.attention_qkv(w, acfg, h, positions=lo + torch.arange(
                h.shape[1], device=h.device))
            qs.append(q)
            ks.append(k)
            vs.append(v)
        outs = CP.swat_attention_cp_local(qs, ks, vs, spec=acfg.spec,
                                          mesh=self.mesh, axis="model",
                                          seq_len=length)
        return self.attn_out(i, [L.attention_out(w, o)
                                 for w, o in zip(ws, outs)])

    # ------------------------------------------------------------- layers --
    def _layer_specs(self, i: int) -> dict:
        return self.param_specs["blocks"][0][f"l{i}"]

    def layer_mixer(self, lps, i: int) -> List[dict]:
        keep = TP._ATTN_KEEP if self._megatron.get(i) else {}
        return self._params_of([p["mixer"] for p in lps],
                               self._layer_specs(i)["mixer"], keep)

    def train_ffn(self, lps, cfg: ModelConfig, i: int, xs: Shards):
        if "moe" not in lps[0] and "mlp" not in lps[0]:
            return xs, None
        hs = [L.rmsnorm(p["norm2"], x, cfg.norm_eps)
              for p, x in zip(lps, xs)]
        specs = self._layer_specs(i)
        if "mlp" in lps[0]:
            tp = self.mlp_tp(i)
            ws = self._params_of([p["mlp"] for p in lps], specs["mlp"],
                                 TP._MLP_KEEP if tp else {})
            ys = [L.mlp(w, h) for w, h in zip(ws, hs)]
            if tp:
                ys = self.mesh.psum(ys, "model")
            return [x + y for x, y in zip(xs, ys)], None
        moes = [p["moe"] for p in lps]
        e = cfg.moe.num_experts
        auxes = []

        def moe(hs):
            if (cfg.moe.dispatch == "ep"
                    and M.expert_parallel_mesh(e) is not None):
                ys, aux = self._moe_ep(moes, specs["moe"], cfg, hs)
            else:
                ys, aux = self._moe(moes, specs["moe"], cfg, hs, i)
            auxes.append(aux)
            return ys
        ys = self.whole(moe, hs)
        return [x + y for x, y in zip(xs, ys)], auxes[0]

    def _psum_batch(self, xs: Shards) -> Shards:
        for a in self.batch_axes:
            xs = self.mesh.psum(xs, a)
        return xs

    def _aux(self, cfg: ModelConfig, routed, t: int) -> Shards:
        """The Switch aux loss of the global batch's tokens per coordinate
        (each 'model' line holds the same tokens: sums over the batch axes
        only)."""
        e, k = cfg.moe.num_experts, cfg.moe.top_k
        counts = self._psum_batch([M._expert_counts(ids, e).float()
                                   for _, _, ids in routed])
        sums = self._psum_batch([probs.sum(0) for probs, _, _ in routed])
        return [e * torch.sum(c / (t * k) * (s / t))
                for c, s in zip(counts, sums)]

    def _moe(self, moes, specs, cfg: ModelConfig, hs: Shards, i: int):
        """The "sort" (global capacity) or "dense" dispatch on the mesh."""
        e, k = cfg.moe.num_experts, cfg.moe.top_k
        tp = self.experts_tp(i) and self.m > 1
        ws = self._params_of(moes, specs,
                             {"w1": 0, "w2": 0, "w3": 0} if tp else {})
        b, length, d = hs[0].shape
        t_local = b * length
        t = t_local * self.rows
        routed = [M._route(w, h.reshape(t_local, d), k)
                  for w, h in zip(ws, hs)]
        los = [self.member(c) * w["w1"].shape[0] if tp else 0
               for w, c in zip(ws, self.coords)]
        if cfg.moe.dispatch == "dense":
            parts = [M.dense_partial(w, h.reshape(t_local, d), gates, ids,
                                     e, lo)
                     for w, h, (_, gates, ids), lo in zip(ws, hs, routed,
                                                          los)]
            if tp:
                parts = self.mesh.psum(parts, "model")
            ys = [y.to(h.dtype).reshape(h.shape) for y, h in zip(parts, hs)]
            return ys, self._aux(cfg, routed, t)
        cap = M.sort_capacity(t, k, e, M.CAPACITY_FACTOR)
        ranks = EP.slot_ranks(self.mesh, [ids.reshape(-1) for _, _, ids
                                          in routed], cap, e,
                              self.batch_axes, self.coords)
        parts = [M.sort_partial(w, h.reshape(t_local, d), gates, ids, rank,
                                keep, cap, lo)
                 for w, h, (_, gates, ids), (rank, keep), lo in zip(
                     ws, hs, routed, ranks, los)]
        if tp:
            parts = self.mesh.psum(parts, "model")
        ys = [y.to(h.dtype).reshape(h.shape) for y, h in zip(parts, hs)]
        return ys, self._aux(cfg, routed, t)

    def _moe_ep(self, moes, specs, cfg: ModelConfig, hs: Shards):
        """Expert parallelism over 'model' on each shard's sequence slice,
        outputs gathered back to the whole sequence."""
        if M._EP_MESH is not self.mesh:
            raise ValueError("expert parallelism is registered on another "
                             "mesh than the train plan's")
        if self.profile == "fsdp":
            raise NotImplementedError(
                "expert parallelism under the fsdp profile: its 'model' "
                "members hold other rows; use the sort or dense dispatch")
        length = hs[0].shape[1]
        if length % self.m:
            raise ValueError(f"expert parallelism over model={self.m}: "
                             f"{length} positions do not divide")
        ws = self._params_of(moes, specs, {"w1": 0, "w2": 0, "w3": 0})
        xs = [h[:, slice(*self._block(c, length))]
              for h, c in zip(hs, self.coords)]
        outs, auxes = EP.moe_ffn_ep_local(
            ws, xs, cfg.moe, mesh=self.mesh, axis="model",
            batch_axes=self.batch_axes, coords=self.coords)
        return self.mesh.all_gather(outs, "model", 1), auxes

    # -------------------------------------------------------------- head --
    def _heads(self, ps) -> Shards:
        """The whole (D, V) head per coordinate."""
        if self.cfg.tie_embeddings:
            tabs = self.gather([p["embed"] for p in ps],
                               self.param_specs["embed"])
            return [t.t() for t in tabs]
        return self.gather([p["lm_head"] for p in ps],
                           self.param_specs["lm_head"])

    def _logits(self, p, cfg: ModelConfig, x, head) -> torch.Tensor:
        x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
        lg = Mod._head_product(x.reshape(-1, x.shape[-1]), head)
        return L.softcap(lg.reshape(*x.shape[:-1], head.shape[1]),
                         cfg.final_softcap)

    def logits(self, ps, cfg: ModelConfig, xs: Shards) -> Shards:
        """fp32 logits of every position of each coordinate's rows."""
        xs = self._whole_seq(xs)
        return [self._logits(p, cfg, x, head)
                for p, x, head in zip(ps, xs, self._heads(ps))]

    def _psum_all(self, xs: Shards) -> Shards:
        for a in self.mesh.axis_names:
            xs = self.mesh.psum(xs, a)
        return xs

    def _owner(self, coord, spec=None) -> bool:
        """Whether coord counts a value replicated over every axis that
        `spec` does not split (every axis without a spec)."""
        split = {a for e in (spec or ()) for a in Sh.entry_axes(e)}
        return all(coord[a] == 0 for a in self.mesh.axis_names
                   if a not in split)

    def objective(self, ps, cfg: ModelConfig, xs: Shards, bs, auxes,
                  aux_weight: float):
        """(per-coordinate objectives, global metrics): see the module
        docstring."""
        sums, counts = [], []
        for p, x, b, head, c in zip(ps, xs, bs, self._heads(ps),
                                    self.coords):
            labels = b["labels"].long()
            length = labels.shape[1]
            lo, hi = self._block(c, length)
            if not self.sp or self.m == 1:
                x = x[:, lo:hi]
            n = max(0, min(hi, length - 1) - lo)
            s, k = Mod.cross_entropy_sum(
                self._logits(p, cfg, x[:, :n], head),
                labels[:, lo + 1:lo + 1 + n])
            sums.append(s)
            counts.append(k)
        denom = [torch.clamp(k, min=1) for k in self._psum_all(counts)]
        objs = [s / dn + aux_weight * a * float(self._owner(c))
                for s, dn, a, c in zip(sums, denom, auxes, self.coords)]
        loss = self._psum_all([(s / dn).detach()
                               for s, dn in zip(sums, denom)])[0]
        return objs, {"loss": loss, "aux_loss": auxes[0].detach(),
                      "tokens": denom[0].to(torch.float32)}

    # ------------------------------------------------ the train step's --
    # hooks (`launch.steps.make_train_step`): grads are lists over the
    # local coordinates of gradient trees shaped like the params
    def train_loss(self, ps, cfg: ModelConfig, batch, **kw):
        """(the sum of the coordinates' objectives, global metrics)."""
        objs, metrics = Mod.loss_fn(ps, cfg, self.batch_rows(batch),
                                    plan=self, **kw)
        return sum(objs[1:], objs[0]), metrics

    def _replicating(self, path: str):
        split = {a for e in self.spec_of(path) for a in Sh.entry_axes(e)}
        return [a for a in self.mesh.axis_names if a not in split]

    def reduce_grads(self, grads: list) -> list:
        """Each gradient summed over the axes that replicate its leaf (a
        ProcessMesh's copies; a LocalMesh's replicas are one tensor, whose
        gradient autograd has summed)."""
        if getattr(self.mesh, "one_graph", False):
            return grads
        out = []
        for t in grads:
            gs = []
            for path, g in tree.flatten_with_paths(t):
                for a in self._replicating(path):
                    g = self.mesh.psum([g], a)[0]
                gs.append(g)
            out.append(tree.unflatten(t, gs))
        return out

    def global_norm(self, grads: list) -> torch.Tensor:
        """The norm of the global gradient, each logical element once (a
        shard on its coordinate with index 0 on the axes that replicate
        it)."""
        sq = []
        for t, c in zip(grads, self.coords):
            s = torch.zeros((), dtype=torch.float32,
                            device=tree.leaves(t)[0].device)
            for path, g in tree.flatten_with_paths(t):
                if self._owner(c, self.spec_of(path)):
                    s = s + g.float().square().sum()
            sq.append(s)
        return torch.sqrt(self._psum_all(sq)[0])

    def amax_reduce(self, amax: torch.Tensor) -> torch.Tensor:
        """int8 compression's scales (`compress.compress_decompress` over
        the coordinates' trees): each leaf's max over all of its shards
        (a pmax over the mesh)."""
        parts = list(amax.reshape(len(self.coords), -1))
        for a in self.mesh.axis_names:
            parts = self.mesh.pmax(parts, a)
        return torch.cat(parts)
