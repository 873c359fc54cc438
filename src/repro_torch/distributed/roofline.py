"""The three roofline terms of a step, priced on the H100 (the port of the
roofline half of the JAX package's `distributed/hlo_analysis.py`; its
collective half is `analysis/collectives.py`).

The JAX dry-run reads FLOPs and HBM bytes off XLA's `cost_analysis()` of
the compiled, partitioned program, and the collectives off its HLO text.
The port has no compiled program. It RUNS the step once on the meta device
(shapes only, nothing allocated) under `CostCounter`, a TorchDispatchMode
that sees every aten op the step dispatches, its backward and remat
recompute included:

  * FLOPs: 2*M*N*K for each product (mm, addmm, bmm, baddbmm and their
    overloads, `.dtype` among them). Any other product op raises
    (`UncountedProduct`), so none passes uncounted; elementwise ops count
    no FLOPs, as the roofline's compute term is the tensor cores'.
  * Bytes: each op's tensor inputs read once and its outputs written
    once. View and alias ops (an output on an input's storage, no write)
    and allocations (`empty`) move nothing; a pure write (`copy_`,
    `fill_`, `zero_`) does not read its destination.
  * Peak live bytes: every storage an op creates counts from then until
    the storage is freed (a weakref finalizer), over the arguments that
    were live before the step.

Collectives come from the mesh's own record (`mesh.recording()`: kind,
axis, one shard's result bytes), weighted by the JAX parser's factors
(`analysis/collectives.py`). Each is priced at the link its axis crosses:
NVLink 4 when the axis's groups stay inside one 8-GPU node (the product of
the axis and every axis minor to it is at most 8), else one NDR InfiniBand
port. This replaces the JAX package's one ICI link.

On a LocalMesh every shard of the mesh runs in this one process, so the
counter sees the whole mesh: a per-device FLOP, byte or memory figure is
the mesh total over the device count. A collective's record entry is
already one device's. Two things a LocalMesh counts otherwise than a mesh
of cards would: it hands one tensor to every shard of a line for a psum or
an all-gather result (and to the replicas of a placed shard), so that
tensor's write and storage count once, not once a shard; and a remat
region's recompute stops early after the last tensor its backward needs,
which is the last coordinate's, so the other coordinates recompute the
super-block's tail (the last layer's final product: a few percent of a
train step's FLOPs).

Peak and HBM rates are `telemetry/kernelprof.py`'s `H100` (data sheet).
"""
from __future__ import annotations

import dataclasses
import re
import weakref
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import tree
from repro_torch.analysis.collectives import CollectiveStats, wire_factor
from repro_torch.telemetry.kernelprof import H100

PEAK_FLOPS_BF16 = H100["bfloat16"]       # FLOP/s, dense tensor cores
HBM_BW = H100["hbm_bytes_per_s"]         # B/s
# NVIDIA H100 SXM data sheet: NVLink 4 is 900 GB/s bidirectional per GPU,
# 450e9 B/s a direction
NVLINK_BW = 450e9
# NVIDIA ConnectX-7 data sheet: one NDR InfiniBand port is 400 Gb/s
IB_BW = 50e9
GPUS_PER_NODE = 8                        # an HGX H100 8-GPU board


# -------------------------------------------------------- collectives ----

def axis_bandwidth(mesh, axis: str) -> float:
    """The link a collective over `axis` crosses: NVLink when the axis's
    groups stay inside one node (the axis and every axis minor to it span
    at most `GPUS_PER_NODE` ranks), else InfiniBand."""
    names = tuple(mesh.axis_names)
    span = 1
    for a in names[names.index(axis):]:
        span *= mesh.shape[a]
    return NVLINK_BW if span <= GPUS_PER_NODE else IB_BW


def collective_seconds(record: Iterable[Tuple[str, str, int]],
                       mesh) -> float:
    """Wire time per device of a mesh's record: each collective's
    factor-weighted bytes over its axis's link."""
    return float(sum(wire_factor(kind) * nbytes / axis_bandwidth(mesh, axis)
                     for kind, axis, nbytes in record))


# ------------------------------------------------------------ roofline --

@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float                # per device
    bytes_accessed: float       # per device
    collective_bytes: float     # per device, factor-weighted
    model_flops: float          # 6ND / 2ND (per device share)
    counts: Dict[str, int]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the card runs at
        the dominant term's rate: (useful compute time) / (bound)."""
        ideal = self.model_flops / PEAK_FLOPS_BF16
        return ideal / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": self.collective_bytes,
            "model_flops_per_device": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_counts": self.counts,
        }


def roofline_terms(cost: dict, coll: CollectiveStats,
                   model_flops_per_device: float,
                   collective_s: Optional[float] = None) -> Roofline:
    """The JAX function's terms on the H100. cost: {"flops", "bytes
    accessed"} per device (`CostCounter.cost_analysis`); collective_s: the
    record's wire time (`collective_seconds`), else coll's wire bytes over
    one NVLink direction."""
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    return Roofline(
        compute_s=flops / PEAK_FLOPS_BF16,
        memory_s=bytes_accessed / HBM_BW,
        collective_s=(coll.wire_bytes / NVLINK_BW if collective_s is None
                      else collective_s),
        flops=flops,
        bytes_accessed=bytes_accessed,
        collective_bytes=coll.wire_bytes,
        model_flops=model_flops_per_device,
        counts=coll.counts,
    )


# ------------------------------------------------------------- counting --

class UncountedProduct(NotImplementedError):
    """A product op the counter has no FLOP formula for."""


def _mm(a, b) -> int:
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b) -> int:
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


# FLOPs of each product with a formula, from its tensor arguments
_FORMULAS = {
    "mm": lambda args: _mm(args[0], args[1]),
    "addmm": lambda args: _mm(args[1], args[2]),
    "bmm": lambda args: _bmm(args[0], args[1]),
    "baddbmm": lambda args: _bmm(args[1], args[2]),
}
# every other op of these names is a product without a formula
_PRODUCT = re.compile(r"mm|matmul|dot|einsum|attention|^_?conv(olution)?"
                      r"|^(mv|addmv|addr|outer|ger|linear|bilinear|tensordot)$")
# ops that write their destination without reading it
_PURE_WRITES = frozenset({"copy_", "fill_", "zero_"})
# allocations: a storage, no traffic
_ALLOCS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                     "new_empty_strided"})


def _base(func) -> str:
    return func.name().split("::", 1)[-1].split(".", 1)[0]


def _storage(t: torch.Tensor):
    return t.untyped_storage()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and peak live bytes of everything dispatched
    under it (see the module docstring). `arguments(tree)` first declares
    the tensors that are live before the step."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.by_op: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._known: Dict[int, int] = {}

    def arguments(self, *trees) -> int:
        """Declare the step's arguments (live before it; not counted as
        allocations). Returns their bytes: each distinct storage once."""
        total = 0
        for t in trees:
            for x in tree.leaves(t):
                if isinstance(x, torch.Tensor):
                    s = _storage(x)
                    if s._cdata not in self._known:
                        self._known[s._cdata] = 0
                        total += s.nbytes()
        return total

    def _freed(self, key: int, nbytes: int) -> None:
        self._known.pop(key, None)
        self.live -= nbytes

    def _allocated(self, t: torch.Tensor) -> None:
        s = _storage(t)
        if s._cdata in self._known:
            return
        n = s.nbytes()
        self._known[s._cdata] = n
        weakref.finalize(s, self._freed, s._cdata, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        base = _base(func)
        if base in _FORMULAS:
            f = _FORMULAS[base](args)
            self.flops += f
            self.by_op[base] = self.by_op.get(base, 0) + f
        elif _PRODUCT.search(base):
            raise UncountedProduct(f"{func.name()}: a product op with no "
                                   "FLOP formula in the cost counter")
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        for t in ins:                        # live before the step
            self._known.setdefault(_storage(t)._cdata, 0)
        for t in outs:
            self._allocated(t)
        if base in _ALLOCS:
            return out
        in_storages = {_storage(t)._cdata for t in ins}
        writes = func._schema.is_mutable
        if not writes and outs and all(_storage(t)._cdata in in_storages
                                       for t in outs):
            return out                       # a view or an alias
        reads = ins[1:] if base in _PURE_WRITES else ins
        if "out" in kwargs:
            reads = [t for t in reads if t is not kwargs["out"]]
        self.bytes += sum(map(_nbytes, reads)) + sum(map(_nbytes, outs))
        return out

    def cost_analysis(self, n_devices: int = 1) -> dict:
        """JAX's `cost_analysis()` keys, per device."""
        return {"flops": self.flops / n_devices,
                "bytes accessed": self.bytes / n_devices}

