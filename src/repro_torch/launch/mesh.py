"""Meshes: the port of the JAX package's `launch/mesh.py`, and the two kinds
of mesh the distributed modules run on.

Axis names and shapes are the JAX package's:
  single pod  (16, 16)     = 256 ranks, axes (data, model);
  multi-pod   (2, 16, 16)  = 512 ranks, axes (pod, data, model);
  pipeline    (n, 16/n, 16) axes (pipe, data, model), and (2, n, 16/n, 16)
              with "pod" first across pods;
  debug       (2, 2) (data, model), (2, 2) (pipe, data); `parse_mesh` reads
              the launchers' "DxM" flags ("4x1", "2x2", "2x2x2").

Both kinds answer one small interface, per axis: `shape[axis]`,
`axis_names`, `index(axis)`, `coords()`, `shift` (JAX's ppermute by one
position), `psum`, `pmax`, `all_gather`, `reduce_scatter` (JAX's tiled
psum_scatter), `all_to_all` (JAX's all_to_all), `replicated` and
`sum_out`. The
distributed modules write their per-shard code over LISTS of shards: the
mesh's local shards of one axis in axis order, or the local shards of the
whole grid in `coords()` order (row-major over the axes), where an op over
one axis runs within each line of the other axes:

  ProcessMesh - a `torch.distributed.device_mesh.DeviceMesh` over an
                initialised process group, one shard per rank: every list
                has one entry, and the collectives are `batch_isend_irecv`
                (shift), `all_reduce` (psum, pmax), `all_gather`,
                `reduce_scatter_tensor` and `all_to_all_single` on the
                axis's group.
                Every rank must run the same program: the same collectives
                in the same order, forward and backward, with the same
                tensors requiring grad.
  LocalMesh   - every shard of the grid in ONE process, on one device
                (the counterpart of the forced host devices on which the
                JAX package runs its meshes in tests and examples). A list
                of one axis's n shards, or of the whole grid's shards; the
                shift moves them along each line with zeros at the edge,
                the reductions sum or max over each line, the gather
                concatenates it and the all-to-all trades its chunks, in
                one thread and one autograd graph.

Gradients are JAX's transposes: the shift's is the opposite shift; psum's is
the psum of the cotangents (the objective is the sum of what every shard
computes); `replicated` (a value every shard reads, JAX's replicated
in_spec) sums its cotangents over the axis; `sum_out` (a per-shard
contribution summed into one replicated result, JAX's psum under
out_specs=P()) passes each shard's cotangent back once; the all-gather's is
the reduce-scatter of the cotangents and the reduce-scatter's the
all-gather; the all-to-all's is the all-to-all with the split and concat
dims swapped. pmax has none (the JAX package takes it of a
stop_gradient'd max).

A ProcessMesh issues every collective it is asked for, over an axis of
size 1 too (a one-rank group: NCCL or gloo runs it and nothing crosses a
wire; the shift alone sends nothing, having no neighbour), and counts them
as Python issues them: `calls` by kind, and `wire_ops` for those over an
axis of more than one rank (a captured CUDA graph's replays run its
collectives again uncounted).

Both kinds keep one record of the collectives a program issues while
`recording()` is on: (kind, axis, bytes of one shard's result) for each
call over an axis of more than one shard, with the kinds `all_reduce`
(psum, pmax, sum_out), `all_gather`, `reduce_scatter`, `all_to_all` and
`p2p` (shift). A call is one entry however many shards take part, as each
device of a JAX mesh runs one collective of the partitioned program; a
LocalMesh records the collectives its `cat`s and sums stand for, and a
ProcessMesh those it hands the process group. A size-1 axis moves nothing
on either kind (XLA elides such collectives) and is not recorded, so the
two kinds record the same program alike. swatlint's collective budgets
read this record (`analysis/collectives.py`).

Defined as functions, so importing this module touches no device and no
process group.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

Shards = List[torch.Tensor]

PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


Record = List[Tuple[str, str, int]]


class _Recording:
    """The record both mesh kinds keep (see the module docstring)."""

    record: Optional[Record] = None

    @contextlib.contextmanager
    def recording(self) -> Iterator[Record]:
        """Record the collectives issued inside the block; yields the
        record, a list of (kind, axis, bytes of one shard's result)."""
        prev, self.record = self.record, []
        try:
            yield self.record
        finally:
            self.record = prev

    def _note(self, kind: str, axis: str, nbytes: int) -> None:
        if self.record is not None and self.shape[axis] > 1:
            self.record.append((kind, axis, int(nbytes)))


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# ------------------------------------------------------ single process ----

class LocalMesh(_Recording):
    """n shards per axis in one process and one autograd graph."""

    one_graph = True

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or min(shape) < 1:
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.record = None

    def __repr__(self) -> str:
        return f"LocalMesh({self.shape})"

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n

    def index(self, axis: str) -> List[int]:
        return list(range(self.shape[axis]))

    def coords(self) -> List[Dict[str, int]]:
        """Every coordinate of the grid, row-major ({axis: index})."""
        return [dict(zip(self.axis_names, c)) for c in itertools.product(
            *(range(self.shape[a]) for a in self.axis_names))]

    def shard(self, x: torch.Tensor, axis: str, dim: int) -> Shards:
        """The local shards of a global tensor split evenly along `dim`."""
        n = self.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                             f"over {axis}={n}")
        return list(torch.chunk(x, n, dim=dim))

    def _lines(self, xs: Shards, axis: str) -> List[List[int]]:
        """Positions in `xs` of each line along `axis`: one line when xs
        holds one axis's shards, else one per coordinate of the others."""
        n = self.shape[axis]
        if len(xs) == n:
            return [list(range(n))]
        if len(xs) != self.size:
            raise ValueError(f"{len(xs)} shards on a {self.shape} mesh")
        stride = 1
        for a in reversed(self.axis_names):
            if a == axis:
                break
            stride *= self.shape[a]
        return [[base + i * stride for i in range(n)]
                for base in range(len(xs))
                if (base // stride) % n == 0]

    def _per_line(self, xs: Shards, axis: str, fn,
                  kind: Optional[str] = None) -> Shards:
        """fn over each line along axis; `kind`: the collective this
        stands for, recorded once with the bytes of one shard's result."""
        out = list(xs)
        for line in self._lines(xs, axis):
            for pos, y in zip(line, fn([xs[p] for p in line])):
                out[pos] = y
        if kind is not None:
            self._note(kind, axis, _nbytes(out[0]))
        return out

    def shift(self, xs: Shards, axis: str, direction: int = +1) -> Shards:
        """Shard i receives shard i - direction; shards with no sender get
        zeros."""
        def line(ys):
            n = len(ys)
            return [ys[i - direction] if 0 <= i - direction < n
                    else torch.zeros_like(ys[i]) for i in range(n)]
        return self._per_line(xs, axis, line, "p2p")

    def psum(self, xs: Shards, axis: str) -> Shards:
        def line(ys):
            total = ys[0]
            for y in ys[1:]:
                total = total + y
            return [total] * len(ys)
        return self._per_line(xs, axis, line, "all_reduce")

    def pmax(self, xs: Shards, axis: str) -> Shards:
        def line(ys):
            top = ys[0].detach()
            for y in ys[1:]:
                top = torch.maximum(top, y.detach())
            return [top] * len(ys)
        return self._per_line(xs, axis, line, "all_reduce")

    def all_gather(self, xs: Shards, axis: str, dim: int) -> Shards:
        """Each shard receives its line's shards concatenated along dim, in
        axis order."""
        return self._per_line(
            xs, axis, lambda ys: [torch.cat(ys, dim=dim)] * len(ys),
            "all_gather")

    def reduce_scatter(self, xs: Shards, axis: str, dim: int) -> Shards:
        """The line's sum cut evenly along dim: shard i receives block i."""
        def line(ys):
            total = ys[0]
            for y in ys[1:]:
                total = total + y
            return list(torch.chunk(total, len(ys), dim=dim))
        return self._per_line(xs, axis, line, "reduce_scatter")

    def all_to_all(self, xs: Shards, axis: str, split_dim: int,
                   concat_dim: int) -> Shards:
        """Each shard's split_dim cut into n chunks; shard j receives chunk
        j of every shard of its line, concatenated along concat_dim in
        axis order."""
        def line(ys):
            n = len(ys)
            parts = [_chunks(y, n, split_dim) for y in ys]
            return [torch.cat([p[j] for p in parts], dim=concat_dim)
                    for j in range(n)]
        return self._per_line(xs, axis, line, "all_to_all")

    def replicated(self, x: torch.Tensor, axis: str) -> Shards:
        return [x] * self.shape[axis]

    def sum_out(self, xs: Shards, axis: str) -> torch.Tensor:
        return self.psum(xs, axis)[0]


def _chunks(x: torch.Tensor, n: int, dim: int) -> Tuple[torch.Tensor, ...]:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"into {n}")
    return torch.chunk(x, n, dim=dim)


# ------------------------------------------------------- process group ----

class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, direction):
        ctx.mesh, ctx.axis, ctx.direction = mesh, axis, direction
        return mesh._p2p(x, axis, direction)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._p2p(g, ctx.axis, -ctx.direction), None, None, None


class _AllReduce(torch.autograd.Function):
    """Sum over the axis; backward: `grad_sum` decides whether the
    cotangents are summed too (psum, replicated) or passed back (sum_out)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, fwd_sum, grad_sum):
        ctx.mesh, ctx.axis, ctx.grad_sum = mesh, axis, grad_sum
        return mesh._all_reduce(x, axis) if fwd_sum else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = ctx.mesh._all_reduce(g, ctx.axis)
        return g, None, None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh._all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh._reduce_scatter(g, ctx.axis, ctx.dim), None, None,
                None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh._reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._all_gather(g, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.dims = split_dim, concat_dim
        return mesh._all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (ctx.mesh._all_to_all(g, ctx.axis, concat_dim, split_dim),
                None, None, None, None)


class ProcessMesh(_Recording):
    """One shard per rank of a `DeviceMesh`."""

    one_graph = False

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              device_mesh.shape))
        # collectives issued, by kind; those over an axis of size > 1
        self.calls: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                                      "reduce_scatter": 0, "all_to_all": 0,
                                      "p2p": 0}
        self.wire_ops = 0
        self.record = None

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape})"

    def _group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def _count(self, kind: str, axis: str, nbytes: int) -> None:
        """Count a collective; nbytes: this rank's result."""
        self.calls[kind] += 1
        self.wire_ops += self.shape[axis] > 1
        self._note(kind, axis, nbytes)

    def index(self, axis: str) -> List[int]:
        return [self.device_mesh.get_local_rank(axis)]

    def coords(self) -> List[Dict[str, int]]:
        """This rank's coordinate."""
        return [{a: self.index(a)[0] for a in self.axis_names}]

    def shard(self, x: torch.Tensor, axis: str, dim: int) -> Shards:
        """This rank's shard of a global tensor split evenly along `dim`."""
        n = self.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                             f"over {axis}={n}")
        return [torch.chunk(x, n, dim=dim)[self.index(axis)[0]]]

    def _p2p(self, x: torch.Tensor, axis: str, direction: int):
        import torch.distributed as dist
        n, i = self.shape[axis], self.index(axis)[0]
        x = x.contiguous()
        out = torch.zeros_like(x)
        if n == 1:
            return out
        self._count("p2p", axis, _nbytes(x))
        group = self._group(axis)
        ops = []
        if 0 <= i + direction < n:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(
                group, i + direction), group))
        if 0 <= i - direction < n:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(
                group, i - direction), group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out

    def _all_reduce(self, x: torch.Tensor, axis: str, op=None):
        import torch.distributed as dist
        y = x.detach().clone().contiguous()
        self._count("all_reduce", axis, _nbytes(y))
        dist.all_reduce(y, op=dist.ReduceOp.SUM if op is None else op,
                        group=self._group(axis))
        return y

    def _all_gather(self, x: torch.Tensor, axis: str, dim: int):
        import torch.distributed as dist
        n = self.shape[axis]
        self._count("all_gather", axis, n * _nbytes(x))
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self._group(axis))
        return torch.cat(parts, dim=dim)

    def _reduce_scatter(self, x: torch.Tensor, axis: str, dim: int):
        import torch.distributed as dist
        n = self.shape[axis]
        parts = _chunks(x.detach(), n, dim)
        self._count("reduce_scatter", axis, _nbytes(parts[0]))
        out = torch.empty(parts[0].numel(), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, torch.stack(parts).reshape(-1),
                                   group=self._group(axis))
        return out.reshape(parts[0].shape)

    def _all_to_all(self, x: torch.Tensor, axis: str, split_dim: int,
                    concat_dim: int):
        import torch.distributed as dist
        n = self.shape[axis]
        send = torch.stack(_chunks(x.detach(), n, split_dim)).contiguous()
        recv = torch.empty_like(send)
        self._count("all_to_all", axis, _nbytes(send))
        dist.all_to_all_single(recv, send, group=self._group(axis))
        return torch.cat(list(recv.unbind(0)), dim=concat_dim)

    def all_gather(self, xs: Shards, axis: str, dim: int) -> Shards:
        """The axis's shards concatenated along dim, in axis order."""
        return [_AllGather.apply(xs[0], self, axis, dim)]

    def reduce_scatter(self, xs: Shards, axis: str, dim: int) -> Shards:
        """The axis's sum cut evenly along dim: this rank's block."""
        return [_ReduceScatter.apply(xs[0], self, axis, dim)]

    def all_to_all(self, xs: Shards, axis: str, split_dim: int,
                   concat_dim: int) -> Shards:
        """split_dim cut into n chunks, chunk j sent to rank j; the chunks
        received concatenated along concat_dim in axis order."""
        return [_AllToAll.apply(xs[0], self, axis, split_dim, concat_dim)]

    def shift(self, xs: Shards, axis: str, direction: int = +1) -> Shards:
        return [_Shift.apply(xs[0], self, axis, direction)]

    def psum(self, xs: Shards, axis: str) -> Shards:
        return [_AllReduce.apply(xs[0], self, axis, True, True)]

    def pmax(self, xs: Shards, axis: str) -> Shards:
        import torch.distributed as dist
        return [self._all_reduce(xs[0], axis, dist.ReduceOp.MAX)]

    def replicated(self, x: torch.Tensor, axis: str) -> Shards:
        return [_AllReduce.apply(x, self, axis, False, True)]

    def sum_out(self, xs: Shards, axis: str) -> torch.Tensor:
        return _AllReduce.apply(xs[0], self, axis, True, False)


# ----------------------------------------------------------- builders -----

def _build(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
           process: bool, device_type: str = "cuda"):
    """A LocalMesh, or with `process` a ProcessMesh over the initialised
    default process group, whose world size must be the mesh's size."""
    if not process:
        return LocalMesh(shape, axes)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    size = 1
    for s in shape:
        size *= s
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != size:
        raise RuntimeError(
            f"a {shape} mesh {axes} needs a process group of {size} ranks; "
            + ("none is initialised" if world is None
               else f"this one has {world}"))
    return ProcessMesh(init_device_mesh(device_type, shape,
                                        mesh_dim_names=axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> ProcessMesh:
    """(16, 16) (data, model), or (2, 16, 16) (pod, data, model) across two
    pods, over a process group of exactly that many ranks."""
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _build(shape, axes, process=True, device_type=device_type)


def make_pp_mesh(*, num_stages: int = 4, multi_pod: bool = False,
                 device_type: str = "cuda") -> ProcessMesh:
    """Pipeline-parallel production mesh: the "pipe" axis takes ranks from
    "data". Single pod (n, 16/n, 16); multi-pod keeps the stages inside a
    pod, (2, n, 16/n, 16)."""
    if 16 % num_stages:
        raise ValueError(f"{num_stages} stages do not divide 16")
    if multi_pod:
        return _build((2, num_stages, 16 // num_stages, 16),
                      ("pod", "pipe", "data", "model"), process=True,
                      device_type=device_type)
    return _build((num_stages, 16 // num_stages, 16),
                  ("pipe", "data", "model"), process=True,
                  device_type=device_type)


def parse_mesh(spec: str, *, process: bool = False,
               device_type: str = "cuda"):
    """A mesh from a "DxM" launcher flag: "4x1" = 4-way data (slot)
    parallel, "2x2" = data x model, "2x2x2" = pod x data x model."""
    dims = tuple(int(x) for x in spec.lower().replace("×", "x").split("x"))
    if not dims or min(dims) < 1 or len(dims) > 3:
        raise ValueError(f"mesh spec {spec!r}")
    axes = {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}[len(dims)]
    return _build(dims, axes, process=process, device_type=device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    process: bool = False, device_type: str = "cuda"):
    """Small (data, model) mesh for tests and examples."""
    return _build((n_data, n_model), ("data", "model"), process=process,
                  device_type=device_type)


def make_debug_pp_mesh(n_pipe: int = 2, n_data: int = 2, *,
                       process: bool = False, device_type: str = "cuda"):
    return _build((n_pipe, n_data), ("pipe", "data"), process=process,
                  device_type=device_type)


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
