"""Context-parallel window attention with the PyTorch/CUDA port: the
paper's FIFO locality across shards. A sequence sharded over N shards
exchanges only a w-token halo per attention call, wire bytes independent
of L, instead of the O(L) kv all-gather dense attention would force.

The twin of examples/context_parallel.py: 4 shards of a single-process mesh
(`repro_torch.launch.mesh.LocalMesh`; the JAX example forces 4 host
devices), checked against the O(N^2) reference, then the halo's wire bytes
against the all-gather's. Runs on the card (the band pass is the forward
kernel with offsets), or with --cpu on the kernels' plain versions.

    PYTHONPATH=src python examples/context_parallel_torch.py [--cpu]
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.core.types import AttentionSpec
from repro_torch.distributed import context_parallel as CP
from repro_torch.kernels import ref as R
from repro_torch.launch.mesh import LocalMesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device: pass --cpu to run on the CPU", file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda"

    mesh = LocalMesh((4,), ("seq",))
    spec = AttentionSpec(kind="swat", window=256, num_global=16, causal=True)
    B, H, L, D = 1, 4, 4096, 64
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(B, H, L, D).astype(np.float32)
                                * 0.3).to(device) for _ in range(3))

    with torch.no_grad():
        out = CP.swat_attention_context_parallel(q, k, v, spec, mesh=mesh,
                                                 axis="seq")
        ref = R.attention_ref(q, k, v, spec)
    err = float((out.float() - ref.float()).abs().max())
    print(f"CP(4 shards, {device}) vs O(N^2) oracle: max err {err:.2e}")
    if not err < 1e-3:
        print("CP output disagrees with the reference", file=sys.stderr)
        return 1

    # the headline scaling: halo wire bytes don't grow with L
    print(f"{'L':>10} {'halo B/dev':>12} {'all-gather B/dev':>17} {'x':>7}")
    for L_ in (8192, 65536, 524288):
        halo = CP.cp_wire_bytes_per_device(L_, 16, 512, H, D, batch=B)
        ag = 2 * (L_ - L_ // 16) * H * D * 2 * B
        print(f"{L_:>10} {halo:>12,} {ag:>17,} {ag / halo:>6.0f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
