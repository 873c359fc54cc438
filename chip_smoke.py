#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; exits non-zero, with no result
line, when there is no card or when it is run outside a checkout. Phases,
each of which raises on failure:

  1. build   - compile every kernel in src/repro_torch/csrc (nvcc, in
               parallel) and print the card's name and power limit, and
               each kernel's registers and spills (ptxas): no spill in the
               tensor-core dQ and dK/dV kernels or the decode kernels.
  2. kernels - each CUDA kernel against its plain PyTorch version at the
               serving path's shapes (fused decode at head dim 64, 128 and
               256, T=1/4/5/8 (5 and 8: verify steps on lookahead rings), on
               cold, wrapped and chunk-border rings, the chosen split
               printed: caches bitwise equal, two launches bitwise equal,
               outputs within bf16 atol 3e-2 / fp32 atol 2e-5 rtol 1e-4;
               banded forward: O at the same tolerances, LSE atol 1e-3,
               for the band pass, the global-row pass, and both composed
               by ops.swat_attention; also at head dim 128 and on
               whisper's ragged 1500-row encoder band). Each forward
               launch must count on its route's counter: bf16 at head dim
               64/128/256 on the tensor-core kernel, fp32 on the SIMT one.
  3. serve   - full-width llama3.2-1b + SWAT (window 256, 4 globals), bf16,
               random weights from seed 0: 8 requests, 4 slots, prompt 512,
               64 new tokens, greedy, through ServingEngine. Launch counts
               are zeroed just before and read just after; they must equal
               one per layer and step (and pass, for the forward), every
               forward launch on the tensor-core route.
  4. e2e     - the kernel path against the plain path on the card: prefill
               last-token logits and 8 teacher-forced decode steps.
  5. times   - each kernel, its plain version and one PyTorch library call
               of the same function (timed only; the port never calls it),
               beside the least time the card could take.
  6. trace   - torch.profiler over a short serve run: the device's busy
               share of the wall time and device time by kernel category;
               one fused decode launch per layer and decode step and no
               plain one (the wrappers' launch counters: the profiler may
               drop records), and no profiler record of another decode
               kernel (the cluster merge launches nothing).
 17. chunk   - (run after phase 6) kernel #2 as a prefill chunk launches
               it, against banded_plain with the same arguments: pass A
               (the gathered ring tail and the chunk, q_offset / kv_offset
               / seq_kv_bound, return_lse) and pass B (the pinned globals)
               at llama's 64-token chunk at pos0 0, 64 and 448 (after a
               wrap), on its dense layer, and at gemma2-2b's D=256 local
               layer after a wrap, bf16 and fp32, each launch on its route;
               the whole chunk route against the plain chunk attention on
               the card. Then pass A's time beside banded_plain's and one
               SDPA call (boolean band mask over the gathered buffer), and
               the fused decode's at T=5.
 18. serve slice - full-width llama3.2-1b + SWAT, bf16, the 8 requests of
               phase 3 through ServingEngine(prefill_chunk=64) and
               ServingEngine(speculative=4, n-gram drafter 3/64): launch
               counts zeroed before and read after each run (the forward:
               one pass A per layer and chunk, one pass B per layer and
               chunk after the first; the fused decode: one per layer and
               decode or verify step; every forward launch on the
               tensor-core route); chunked against single-shot first-token
               logits within LOGIT_BOUND, the speculative tokens against
               sequential decode teacher-forced along them within
               AGREE_BOUND; traced chunked and single-shot prefill batches
               and a traced verify block split by kernel category.
 19. serve slice fp32 - the same 8 requests at fp32 through the default,
               chunked and speculative engines (SIMT forward): greedy
               tokens equal on every request; then phase 20's fp32 gate.
 20. paged   - (run after phase 18) kernel #1 on a paged cache's gathered
               view (rings stored as shuffled 16-row blocks of a pool, read
               through a table) against its plain version, the write-back
               round trip bitwise, and its time beside the whole paged
               route's (gather, kernel, scatter). Then full-width
               llama3.2-1b + SWAT, bf16, through ServingEngine(kv_layout=
               "paged"): the 8 requests of phase 3 sequentially and with
               speculative=4, greedy tokens bitwise equal to the contiguous
               engines' (phases 3 and 18); the launcher's shared-prefix demo
               workload (496 shared + 16 tokens) with prefill_chunk=64,
               unshared and with share_prefix: launch counts as in phase
               18, the shared first-token logits within LOGIT_BOUND of the
               unshared ones, the shared tokens teacher-forced within
               AGREE_BOUND, prefill tokens computed, blocks in use after
               the first admission and copy-on-write moves printed; the
               decode step of the contiguous and paged engines timed in
               turns (graph engines, warmed by one run); traced paged decode block and shared / unshared
               prefill batches. In
               phase 19 (fp32) the shared tokens equal the unshared ones
               on every request.
 21. graphs  - (run after phase 20) the engine's compiled dispatch against
               eager dispatch (graphs=False), bf16 (and in phase 19 fp32):
               the sequential, speculative, chunked, paged and
               shared-prefix cells each serve the requests of phases 3 and
               20 on an eager engine and twice on a graph engine (the first
               run warms up and captures, the second only replays); the
               graph runs' greedy tokens bitwise the eager run's and every
               launch counter's count equal to eager's; no capture in the
               second run. Then, bf16, eager and graph engines timed in
               turns (4 runs each of one 4-request batch): decode ms a
               step, verify ms a step, chunked prefill ms a batch (phase
               20 times the paged step against the contiguous one under
               graphs); traced eager decode, verify, chunked
               prefill and paged decode blocks beside phases 6, 18 and
               20's traces (which run graphs, the engine's default on the
               card): busy share and kernels a step; graphs captured,
               capture time and pool memory per cell.
 22. telemetry - (run after phase 21) the sequential, speculative,
               chunked, paged and shared-prefix cells of phase 21 on graph
               engines with metrics=True (bf16): tokens bitwise phase 21's
               metrics-off graph runs, run for run, with every launch
               counter, the keys captured and the replays equal; the device
               counters equal to the host oracle; the Chrome trace and
               Prometheus exports valid; the fused decode's dispatch census
               (its split and chunk). Then TTFT, TPOT and queue-delay
               p50/p95/p99 per cell, metrics-on against metrics-off decode
               and verify ms a step in turns, a traced metrics-on decode
               block beside phase 6's, and one kernelprof.profile_decode
               row at phase 5's decode shape with its share of the bound.
 23. resilience - (run after phase 22) fault plans on phase 21's cell
               (graphs, bf16): a FaultPlan() engine equal to the plan-less
               one (tokens, launches, keys, replays); NaN / +Inf on slot 1
               at token 3, sequential and speculative, each served twice
               (the second time inside replays): that request keeps the
               clean run's first 3 tokens, the others stay bitwise, kernels
               #1 and #2 launch as in phase 3; corrupt drafts give the
               clean speculative tokens; cache poison, contiguous and
               paged with a shared prefix, poisons only its request; the
               one step down (fail_pallas_dispatch on decode_impl="pallas",
               sequential and speculative): one kernel_fallbacks, one
               pallas_fallback event and one warning, no fused decode
               launch, tokens bitwise a decode_impl="ref" engine's;
               max_pending and deadlines end their requests "rejected" and
               "deadline". Then the plan's and the degraded engine's step
               costs in turns, capture after the step down and the
               degraded run's TTFT / TPOT. Every healthy serve engine of
               every phase is checked for zero steps down.
 24. moe     - (run after phase 19) granite-moe-1b-a400m + SWAT (window
               256, 4 globals) at full width and depth, bf16, random
               weights from seed 0: kernels #1 (T=1 and T=5) and #2 (the
               L=512 band, a chunk at pos0 448) at its group-2 heads
               against their plain versions; the port's moe_ffn on the
               card against the CPU and the dense oracle (serving shape
               "dense", training shape "sort"); phase 3's cell and phase
               21's chunked and speculative cells, graph tokens bitwise
               eager's with #1 once per layer and step and #2 as phase 3
               counts; in fp32 the kernel engine's greedy tokens equal to
               the plain path's and phase 4's kernel-vs-plain bounds; two
               AdamW steps (B=4, L=2048, launches as phase 8 counts), then
               the kernel path's loss against the plain path's (bf16, full
               depth) and every gradient leaf (fp32, 4 layers, as phase
               9); the bf16 dQ and dK/dV kernels at its group-2 heads are
               held in phase 7; decode,
               prefill and train times, a traced decode step with the MoE
               FFN's device time named, and #1, #2, #4 and #5 timed at its
               shapes.
 25. mamba   - (run after phase 24) the Mamba2 layer kinds: ssd_chunked
               against ssd_scan_ref at the published shape (B=2, L=2048,
               64 heads of 64, state 128, chunk 256, fp32): outputs within
               atol 2e-4 / rtol 1e-3, gradients finite and within
               SSD_GRAD_REL of the recurrence's; mamba2-1.3b at full width
               and depth in fp32, prefill (a right-padded row) and 8
               teacher-forced decode steps against forward_logits within
               MAMBA_RECUR_BOUND, a state left running past `lengths`
               above it; mamba2 bf16 on phase 3's cell: graph and paged
               tokens bitwise eager's, no SWAT kernel launched or traced
               (decode_impl "pallas" included), zero steps down; a traced
               eager decode step with the SSM update named; two AdamW
               steps (B=4, L=2048), loss, gradient norm and params
               finite. jamba-1.5-large + SWAT at its published widths cut
               to one super-block and 2 experts: #1 and #2 at its shape
               (64 q over 8 kv heads, D=128) against their plain
               versions; phase 3's cell, graph tokens bitwise eager's, #1
               once per decode step, #2 twice per prefill batch on the
               tensor-core route, zero steps down; fail_pallas_dispatch:
               every request ok, one fallback, none readmitted or failed;
               fp32 kernel path against the plain path, greedy tokens
               equal within JAMBA_FP32_LOGIT_BOUND. Decode ms a step
               beside its byte bound and llama's, prefill ms, TTFT /
               TPOT, peak memory, train step ms, and #1 / #2 timed at
               jamba's shape.
  26. swatlint - (run after phase 23, on phase 3's params) the port's
               static analysis (`repro_torch.analysis`) on the card: the
               single-device labels of `launch/analyze.py`'s smoke matrix
               (its mesh labels run in phase 30) against the committed
               ANALYSIS_torch.json (zero errors, no warning or lowering
               count above the baseline's, every graph key captured and
               replayed); llama3.2-1b + SWAT at full width (bf16, 4 slots,
               decode_impl "pallas", prefill_chunk 64, graphs, metrics)
               and its speculative twin (zero errors, host_sync and
               telemetry clean on the captured entries, #1 layers x n
               launches a scan[n] entry and no plain decode kernel, #2's
               pass A and pass B a chunk on the tensor cores); a body with
               .item() flagged and refused by the capture, a rebound carry
               flagged, blocking uploads on the hot path flagged and the
               engine's pinned non-blocking staging clean. Prints its wall
               time beside the card.
  7. backward - the dQ and dK/dV kernels against their plain version at the
               training shapes (B=4, Hq=32, Hkv=8, L=2048, D=64, window
               256, 4 globals, causal; plus group 1, 2 (granite-moe's
               16 q over 8 kv heads) and 8, softcap 30 and
               50, random blocks, the longformer-paper bidirectional spec,
               the global-row pass, head dim 128 and 256, whisper's ragged
               1500-row encoder band and its cross shape, 448 queries
               against 1500 keys), bf16 and fp32, each dQ and dK/dV
               launch on its route's counter (bf16 at head dim 64/128/256
               on the tensor-core kernels); two launches bitwise equal (the
               split dK/dV rows and their combine included); the combine
               kernel bitwise equal to its plain version; autograd
               through ops.swat_attention, kernel against banded, both
               passes composed.
  8. train   - full-width llama3.2-1b + SWAT, bf16, 6 AdamW steps (lr
               3e-5) of 4 x 2048 tokens (remat "nothing"): losses finite
               and falling, launch counts of all three attention kernels
               (forward and dK/dV on the tensor-core route, one combine
               per band pass).
  9. train e2e - one loss/grad at full width and 4 layers, kernel path
               against the plain path.
 10. resume  - the smoke config trained 8 steps uninterrupted and with a
               failure at step 6 resumed from the step-4 checkpoint give
               bitwise-equal params (deterministic algorithms).
 11. train times - the backward kernels, their plain version and SDPA's
               backward at the training shapes, the split combine, the
               forward at L=2048 (band pass and global-row pass apart),
               the unembed product, and a profiled train step split by
               kernel category.
 27. context parallelism and pipeline - (run after phase 11, on phase 8's
               params) (a) the halo-exchange CP op on a single-process
               mesh at llama3.2-1b + with_swat's defaults (window 2048,
               128 globals, 32 q over 8 kv heads, D=64, bf16): B=1,
               L=32768 over 4 shards (one hop), L=4096 over 8 (four hops)
               and L=4096 over 4 bidirectional, each against
               ops.swat_attention on the unsharded sequence (atol 3e-2),
               one kernel #2 launch a shard on the tensor cores; on the
               bidirectional case kernel #2 (and #4, #5 with dLSE) on
               shard 0 and the last shard against their plain versions
               with the same offsets; both ops timed. (b) a loss and
               gradient of the whole model with every attention layer CP
               over 4 shards (B=2, L=8192) against the same without CP
               (|dloss| <= 0.02, per-leaf grad error <= 0.05), #2 / #4 /
               #5 launched 2 / 1 / 1 x layers x shards. (c) the GPipe loss
               and gradient (4 stages of 4 layers, 4 microbatches of
               phase 8's batch) against the plain step, same gates, each
               kernel launched 4x the plain step's count; the bubble
               fraction. (d) a one-rank NCCL process group and DeviceMesh:
               one CP op and its gradients through the process mesh
               against a single-process mesh, its psum and pmax issued
               to NCCL as all_reduce calls. Then one AdamW step each
               through CP and the pipeline, and #2 / #4 / #5 timed on a
               CP shard's band pass at (b)'s shape.
 28. mesh    - (run after phase 27) serving on a mesh, on phase 3's cell
               (llama3.2-1b + SWAT, bf16, params from seed 0, 8 requests,
               4 slots, prompt 512, 64 new tokens, graphs): (a) a 4x1
               slot-parallel LocalMesh, two runs with tokens bitwise phase
               3's, kernel #1 16 layers x 4 shards a decode step and no
               plain decode launch, #2 twice a layer and shard a prefill
               batch; (b) 2x2 and 1x4 TP (per shard 16 q / 4 kv heads and
               d_ff 4096, or 8 q / 2 kv and 2048, vocab-parallel head):
               prefill and first decode step logits against the
               single-device engine within LOGIT_BOUND, greedy agreement at
               least AGREE_BOUND, every budget exact, two runs bitwise, the
               same launch counts per shard; (c) the paged layout on the 4x1
               mesh's slot-local pool, tokens bitwise (a)'s; (d) a one-rank
               NCCL ProcessMesh (1x1), tokens bitwise phase 3's, the
               plan's psums and logit gathers issued to NCCL (all_reduce
               and all_gather calls, inside the captured graphs; none
               crosses a wire on one rank). Decode ms a step of each beside
               the single-device engine's.
 29. mesh train - (run right after phase 27, on phase 8's state, which it
               consumes) training on a mesh: (a) one train step of
               llama3.2-1b + SWAT at full width and depth on a 2x2
               LocalMesh (tp profile, sequence parallelism, phase 8's batch)
               against the plain single-device kernel step on the same
               state (loss and every gradient leaf within phase 9's gates;
               each of the 4 shards launching #2 / #4 / #5 what the plain
               step launches, on the tensor cores), then one AdamW step
               each (params and first moments within the gates), its time
               beside phase 8's; (d) that state saved (gathered global
               leaves) and restored onto one device and a 4x1 mesh, every
               leaf bitwise, and a resumed 4x1 step against the 2x2 mesh's
               second step within the gates; (b) granite-moe-1b-a400m +
               SWAT at full width cut to 4 layers, fp32, on a 1x4 mesh and
               on a 2x2 one (capacity drops slots of phase 8's batch; the
               2x2 mesh ranks the 'data' rows together) with the sort
               dispatch (the plain step's global capacity) and the ep
               dispatch (`set_expert_parallel`; against the single-device
               model running the same expert-parallel function): loss, aux
               loss and every gradient leaf within MESH_LOSS_BOUND /
               MESH_GRAD_BOUND, the all-to-alls counted and their bytes
               beside `ep_wire_bytes_per_device`, and a control (the 2x2
               sort ranked per shard) that must leave those bounds; (c) a
               one-rank NCCL ProcessMesh (llama cut to 4 layers): the step
               against the plain step within MESH_LOSS_BOUND /
               MESH_GRAD_BOUND, its collectives counted, none over a
               wire.
 30. mesh lint and the paper's baseline - (run after phase 28, ~40 s)
               (a) swatlint's five mesh labels (`launch/analyze.py`'s
               slot_parallel_4x1, tp_2x2, chaos_4x1, paged_slot_parallel_4x1
               and metrics_on, each on a single-process LocalMesh on the
               card) against the committed ANALYSIS_torch.json: zero
               errors, no warning, lowering or collective-budget count
               above the baseline's, every decode hot-path entry of the 4x1
               engines collective-free, every graph key captured and
               replayed, each 4x1 scan[n] entry launching #1 n x layers a
               shard (x 4 shards) and no plain decode kernel; each mesh
               family's collectives and wire bytes printed beside the JAX
               package's committed ANALYSIS.json. (b) the negative
               control: an all-gather over the slot axis added to a 4x1
               scan body gives a collectives ERROR. (c) the paper's
               comparison on this card: longformer-paper's attention (12
               heads, D=64, window 256, bidirectional, no globals: the
               baseline has no global pass), B=1, L=4096 and 16384, bf16
               and fp32: ops.swat_attention(impl="sliding_chunks") (plain
               torch ops, not a kernel) against impl="kernel" (#2) within
               bf16 atol 3e-2 / fp32 atol 2e-5 rtol 1e-4, #2 against its
               plain version, both timed (CUDA events, L2 flushed, mean of
               10), their ratio beside the redundant-FLOP ratio of
               `patterns.sliding_chunks_flops_ratio` and the card.
 31. mesh gaps and the dry-run - (run after phase 30, ~25 s) (a)
               whisper-tiny + SWAT(128, 4), bf16, full width, on a 2x2
               LocalMesh: 8 clips prefilled and 20 greedy steps against
               the single-device run (greedy agreement >= 0.75, |dlogit|
               <= 0.25 teacher-forced), each shard launching #1, #2 and
               #3 what one device launches; (b) one cp and one fsdp train
               step on 2x2 (llama3.2-1b + SWAT cut to 4 layers, phase 8's
               batch) against the plain step within phase 9's gates, #2 /
               #4 / #5 launched on every shard, cp's halo shifts
               recorded and fsdp's none, then one AdamW step each; (c)
               the dry-run's count against the card: llama3.2-1b + SWAT
               (256, 4) train 4 x 2048, prefill 4 x 512 and decode with 4
               slots at 1024 traced on the meta device over a 1x1 mesh
               (`launch.dryrun.trace_cell`), then the same steps built on
               the card and run with the kernels (CUDA events, mean of 5
               after a warm-up, `max_memory_allocated`): measured ms
               beside compute_s and memory_s, the peak beside the
               predicted argument + temp bytes; the argument bytes must
               equal to the byte and the time be at least 0.9 x
               compute_s.
 12. plain decode - the plain-mode decode kernel (the fused kernel's
               cluster split without the insert) against its plain version,
               bf16 and fp32, both GQA layouts, two launches bitwise equal,
               one launch a call: whisper's cross attention (B=8, 6 heads,
               T=1, D=64, 1500 encoder rows, dense non-causal),
               kernel_bench.py's unpacked shape (B=8, group 4, 2 kv heads,
               W=512, wrapped) and a causal window + globals + softcap ring
               with T=4; then its time at every split count (1-8 CTAs a
               cluster) at whisper's cross shape and at D=256, beside the
               split `plain_splits` picks.
 13. gemma2 D=256 - all five kernel entry points against their plain
               versions at gemma2-2b's shapes (head dim 256, 8 q heads
               over 4 kv heads, L=8192): the local layer (window 4096,
               softcap 50; decode on its wrapped 4097-row ring) and the
               dense causal global layer (softcap 50; decode on its
               8192-row cache), bf16 and fp32, each dQ and dK/dV launch on
               its route (bf16: the tensor cores), two backward launches
               bitwise equal; then the kernels' times at the local layer
               (dK/dV also at the global layer), each beside one SDPA call
               of the same shapes and mask (the backward's as
               forward+backward minus forward).
 14. whisper - full-width whisper-tiny + SWAT (window 128, 4 globals),
               bf16, random weights from seed 0: 8 clips of 1500 encoder
               frames, prefill of a 16-token prompt, 200 greedy decode
               steps through model.prefill / model.decode_step; launch
               counts of the three serving kernels equal to the expected
               counts, every forward launch on the tensor-core route.
 15. whisper e2e - the same run with every kernel swapped for its plain
               version: fp32 greedy tokens equal on every step and fp32
               logits within WHISPER_FP32_LOGIT_BOUND; bf16 logits,
               teacher-forced on the kernel path's tokens, within
               WHISPER_LOGIT_BOUND. The fp32 run's forward launches all
               count on the SIMT route.
 16. whisper times - encoder, prefill and decode step times, tokens/s,
               peak memory, a traced decode block split by kernel (one
               plain decode launch a cross-attention call and one fused
               launch a self-attention call, from the launch counters; no
               profiler record of another decode kernel; the plain decode
               records seen beside the launches), and the plain decode
               kernel, its plain version and SDPA at the cross shape.

The serving engine replays its decode blocks, verify steps and prefill
chunks as CUDA graphs on the card (its default); phases 3, 6 and 18-20 run
it so, and a traced engine first serves its requests twice untraced, so
that the traced run only replays.

Prints the kernels JSON line and the card line, then as its last line
{"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

# cuBLAS is deterministic only with a fixed workspace; set before the first
# cuBLAS call (the resume drill runs under torch.use_deterministic_algorithms)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,    # dense tensor-core bf16
            "float32": 67e12}      # fp32 outside the tensor cores

MAIN = dict(b=4, hq=32, hkv=8, d=64, window=256, num_global=4,
            prompt=512, new_tokens=64, max_len=1024)
TOL = {"bfloat16": dict(atol=3e-2, rtol=1e-2),
       "float32": dict(atol=2e-5, rtol=1e-4)}
LOGIT_BOUND = 0.25          # bf16 kernel path vs plain path, max |dlogit|
AGREE_BOUND = 0.75          # greedy agreement, kernel vs plain path
SPIN_CYCLES = 40_000_000    # ~20 ms at the H100's ~2 GHz: covers the host
                            # time of enqueuing the slowest plain version

# lr 3e-5: at 3e-4 AdamW's first sign-sized updates on the random init
# push the loss up before it falls (12.155 -> 12.330 over the 6 steps)
TRAIN = dict(b=4, seq=2048, steps=6, lr=3e-5, warmup=2, e2e_layers=4)
# backward kernels vs their plain version. fp32: the JAX package's own
# gradient tolerance (tests/test_kernels.py). bf16: both compute in fp32
# from the same bf16 inputs and round once at the end, so they differ by at
# most one bf16 ulp (2^-8..2^-7 relative) plus fp32 summation order
BWD_TOL = {"bfloat16": dict(atol=1e-2, rtol=1e-2),
           "float32": dict(atol=5e-5, rtol=1e-3)}
# autograd through ops.swat_attention, kernel vs banded. bf16: the banded
# path rounds the probabilities to bf16 before P.V and autograd sums the
# gathered K/V gradients in bf16 (up to 16 gathers of a global block), a
# few bf16 ulps
GRAD_TOL = {"bfloat16": dict(atol=6e-2, rtol=3e-2),
            "float32": dict(atol=5e-5, rtol=1e-3)}
TRAIN_LOSS_BOUND = 0.02     # |loss kernel - loss plain|, bf16, 4 layers
TRAIN_GRAD_BOUND = 0.05     # max over leaves of |g_k - g_p| / |g_p|
# phase 29's fp32 mesh cells (b) and its one-rank NCCL step (c) against the
# plain step: the same function summed in another order. Sound runs read
# |dloss| <= 9.5e-7, |daux| 0 and a worst leaf <= 8.9e-6; (b)'s control,
# the sort dispatch ranking each shard's slots on its own, read 3.6e-3,
# 0.24 and 1.0 (PERF.md). A routed token whose 8th and 9th router
# probabilities tie to an ulp can flip with the summation order and then
# leaves these bounds too (PERF.md): phase 8's batch has no such token.
MESH_LOSS_BOUND = 1e-5      # |dloss| and |daux|
MESH_GRAD_BOUND = 1e-4      # max over leaves of |g_mesh - g_p| / |g_p|
# moe_ffn at granite-moe's own experts (outputs up to |y| ~ 70, RMS ~ 25,
# one bf16 ulp 0.25-0.5), bf16, the card against the CPU: max |error| over
# the output's RMS. A sound run differs by a rounding or two at the largest
# outputs; phase 24 also reads the card's output cut to one mantissa bit
# fewer (reported) and a run with one expert fewer a token, which must
# read above the limit.
MOE_RMS_LIMIT = 3e-2

# whisper-tiny + SWAT at full width (4+4 layers, d_model 384, 6 heads, head
# dim 64, vocab 51865): 8 clips of ENCODER_FRAMES, a 16-token prompt, 200
# greedy decode steps (the decoder ring of 133 rows wraps within them)
WHISPER = dict(clips=8, frames=1500, prompt=16, steps=200, max_len=448,
               window=128, num_global=4)
# bf16, kernel vs plain path, teacher-forced: about 4x the 0.0163 that the
# sound runs read on the H100 (a logit's spread at this init is ~0.4)
WHISPER_LOGIT_BOUND = 0.06
# fp32, kernel vs plain path on equal tokens: both accumulate in fp32 and
# differ in summation order only, far below bf16's ~1e-2
WHISPER_FP32_LOGIT_BOUND = 1e-3
# whisper's encoder band (AttentionSpec fields): bidirectional window 128,
# 4 global tokens
WHISPER_BAND = dict(kind="swat", window=WHISPER["window"],
                    num_global=WHISPER["num_global"], causal=False)
# gemma2-2b's attention shapes (configs/gemma2_2b.py): head dim 256, 8 q
# heads over 4 kv heads, local window 4096, softcaps 50
GEMMA = dict(b=1, hq=8, hkv=4, d=256, seq=8192, window=4096, softcap=50.0)
# the chunked and speculative serve cells (phases 17-19): prefill chunk,
# drafts per verify step, and the n-gram drafter (the JAX launcher's
# --draft-ngram / --draft-history defaults)
CHUNK = 64
SPEC_K = 4
DRAFT = dict(max_ngram=3, history=64)
# the paged shared-prefix cell (phase 20): the serve launcher's demo
# workload at the serve cell's 512-token prompts, a system prompt of
# max(prompt - 16, 16) tokens and a 16-token suffix a request
SHARED_PREFIX = MAIN["prompt"] - 16


# phase 30's paper comparison: longformer-paper's attention
# (configs/longformer_paper.py: 12 heads of 64, window 256, bidirectional)
# without its global token (the sliding-chunks baseline has no global
# pass), one sequence at two lengths
PAPER = dict(b=1, lengths=(4096, 16384), iters=10)


# kernels whose design keeps every register row in registers: a spill in
# them is a fault (phase 1)
NO_SPILL = ("attention_dkv_tc_kernel", "attention_dq_tc_kernel",
            "decode_fused_kernel", "decode_plain_kernel")


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0].strip()


def no_step_down(eng, where, impl=None):
    """A healthy serve engine never steps down from kernel #1 to its plain
    version: kernel_fallbacks 0, decode_impl as constructed (None: the
    kernel on the card) and no pallas_fallback event on the bus."""
    from repro_torch.telemetry import events as TEV
    bus = "pallas_fallback" in [e["kind"] for e in TEV.peek_events()]
    if eng.stats["kernel_fallbacks"] or eng.decode_impl != impl or bus:
        raise AssertionError(
            f"{where}: a healthy engine stepped down (kernel_fallbacks "
            f"{eng.stats['kernel_fallbacks']}, decode_impl "
            f"{eng.decode_impl!r}, pallas_fallback on the bus: {bus})")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def route_counts():
    """Launch counts of the forward's, dQ's and dK/dV's routes and the
    combine."""
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_backward as SB
    return {"fwd_tc": SA.ROUTE_LAUNCHES["tc"].n,
            "fwd_simt": SA.ROUTE_LAUNCHES["simt"].n,
            "dq_tc": SB.DQ_ROUTE_LAUNCHES["tc"].n,
            "dq_simt": SB.DQ_ROUTE_LAUNCHES["simt"].n,
            "dkv_tc": SB.DKV_ROUTE_LAUNCHES["tc"].n,
            "dkv_simt": SB.DKV_ROUTE_LAUNCHES["simt"].n,
            "combine": SB.COMBINE_LAUNCHES.n}


def check_route(name, before, kernel, route, n=1):
    """Since `before` (route_counts()), `kernel` ("fwd", "dq" or "dkv") was
    launched n times, every time on `route` ("tc" or "simt")."""
    now = route_counts()
    other = "simt" if route == "tc" else "tc"
    got = now[f"{kernel}_{route}"] - before[f"{kernel}_{route}"]
    stray = now[f"{kernel}_{other}"] - before[f"{kernel}_{other}"]
    if got != n or stray:
        raise AssertionError(f"{name}: {got} {kernel} launches on the {route} "
                             f"route and {stray} on the {other} route, "
                             f"expected {n} and 0")


def expected_route(dtype, d, kernel):
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_backward as SB
    return {"fwd": SA.route, "dq": SB.dq_route,
            "dkv": SB.dkv_route}[kernel](dtype, d)


def check_close(name, got, want, dtype_name, **tol):
    import torch
    tol = tol or TOL[dtype_name]
    err = max_err(got, want)
    if not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError(f"{name}: max abs err {err} outside {tol}")
    return err


# ------------------------------------------------------------- phase 2 ---

def _ring_inputs(torch, gen, dtype, b, group, hkv, t, d, lens):
    cap = MAIN["window"] + 1 + (t - 1) + MAIN["num_global"]
    w = 320                                   # _round_capacity(cap)
    dev = "cuda"
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    q = mk(b, group * hkv, t, d)
    kc, vc = mk(b, hkv, w, d), mk(b, hkv, w, d)
    nk, nv = mk(b, hkv, t, d), mk(b, hkv, t, d)
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    nn = torch.tensor([t, max(1, t - 1), t, t][:b], dtype=torch.int32,
                      device=dev)
    return q, kc, vc, nk, nv, pos, nn, cap


def _border_lens(chunk, cap):
    """Ring depths (tokens before the insert) whose first insert slot is
    the last row of chunk 0 (so T=4 straddles the border), the first row
    of chunk 1, the last row of chunk 1 and the first of chunk 2, each
    after one or more wraps of the ring."""
    g = MAIN["num_global"]
    ring = cap - g
    return [chunk - 1 + 2 * ring, chunk + 3 * ring, 2 * chunk - 1 + ring,
            2 * chunk + 5 * ring]


def check_decode(torch, spec):
    """The fused decode kernel against its plain version: head dim 64, 128
    and 256 x bf16/fp32 x T=1/4/5/8 (5 and 8: a speculative verify step's
    k+1 rows on a ring with k lookahead rows) x group 1/4/8 x three rings
    (cold: slot 0
    at pos 0, so that most of the cluster's chunks see nothing; wrapped;
    insert slots on the split's chunk borders). Caches bitwise equal,
    outputs within TOL, two launches bitwise equal. Returns the bf16 error
    of the serve shape (D=64, group 4, wrapped) for each T."""
    from repro_torch.kernels import swat_decode as SD
    gen = torch.Generator(device="cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    main_err, n, splits = {}, 0, set()
    for d in (64, 128, 256):
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            for t in (1, 4, 5, 8):
                cap = MAIN["window"] + 1 + (t - 1) + MAIN["num_global"]
                chunk, nsplit = SD.fused_splits(MAIN["b"] * MAIN["hkv"], cap,
                                                sms)
                splits.add((cap, nsplit, chunk))
                rings = (([0, 3, 100, 200], "cold"),
                         ([600, 261, 1037, 5000], "wrapped"),
                         (_border_lens(chunk, cap), "chunk borders"))
                for group in (1, 4, 8):
                    for lens, tag in rings:
                        q, kc, vc, nk, nv, pos, nn, cap = _ring_inputs(
                            torch, gen, dtype, MAIN["b"], group, MAIN["hkv"],
                            t, d, lens)
                        want, kw, vw = SD.swat_decode_fused_plain(
                            q, kc, vc, nk, nv, pos, nn, spec, ring_cap=cap)
                        k2, v2 = kc.clone(), vc.clone()
                        got = SD.swat_decode_fused(q, k2, v2, nk, nv, pos,
                                                   nn, spec, ring_cap=cap)
                        k3, v3 = kc.clone(), vc.clone()
                        again = SD.swat_decode_fused(q, k3, v3, nk, nv, pos,
                                                     nn, spec, ring_cap=cap)
                        torch.cuda.synchronize()
                        name = (f"swat_decode D={d} {dn} T={t} group={group}"
                                f" {tag}")
                        if not (torch.equal(k2, kw) and torch.equal(v2, vw)):
                            raise AssertionError(f"{name}: caches not bitwise "
                                                 "equal to the plain version")
                        if not torch.equal(got, again):
                            raise AssertionError(f"{name}: two launches "
                                                 "differ")
                        err = 0.0
                        for i in range(MAIN["b"]):
                            real = int(nn[i])   # rows past num_new: garbage
                            err = max(err, check_close(
                                name, got[i, :, :real], want[i, :, :real],
                                dn))
                        n += 1
                        if (d, dn, group, tag) == (64, "bfloat16", 4,
                                                   "wrapped"):
                            main_err[t] = err
    log(f"swat_decode: {n} cases, caches bitwise equal, outputs within "
        "tolerance, bitwise repeatable; split (cap, CTAs per ring, chunk "
        f"rows) for {MAIN['b']} slots x {MAIN['hkv']} kv heads on {sms} "
        f"SMs: {sorted(splits)}")
    return main_err


def check_banded(torch, spec):
    import dataclasses
    from repro_torch.core.types import AttentionSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_attention as SA
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, hq, hkv, d, l = MAIN["b"], MAIN["hq"], MAIN["hkv"], MAIN["d"], \
        MAIN["prompt"]
    specs = {"causal+globals": spec,
             "bidirectional": dataclasses.replace(spec, causal=False,
                                                  window=64),
             "random blocks": dataclasses.replace(spec, num_random=2,
                                                  random_seed=7)}
    main_err = None
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        mk = lambda *s: torch.randn(*s, generator=gen,
                                    device="cuda").to(dtype)
        q, k, v = mk(b, hq, l, d), mk(b, hkv, l, d), mk(b, hkv, l, d)
        for tag, sp in specs.items():
            pat = ops.get_pattern(sp, l, l, 128, 128)
            want, wl = SA.banded_plain(q, k, v, sp, pat, d ** -0.5,
                                       return_lse=True)
            before = route_counts()
            got, gl = SA.swat_attention_fwd(q, k, v, sp, pattern=pat,
                                            return_lse=True)
            torch.cuda.synchronize()
            name = f"swat_attention_fwd {dn} {tag}"
            check_route(name, before, "fwd",
                        expected_route(dtype, d, "fwd"))
            err = check_close(name, got, want, dn)
            check_close(name + " lse", gl, wl, dn, atol=1e-3, rtol=1e-4)
            if (dn, tag) == ("bfloat16", "causal+globals"):
                main_err = err
        # the global-row pass that ops.swat_attention runs after the band
        # pass: the first g rows against every key, under the dense causal
        # spec (Lq=4, Lkv=512: a q block mostly past Lq, sparse==0)
        g = spec.num_global
        gspec = dataclasses.replace(spec, kind="dense", window=0,
                                    num_global=0, num_random=0)
        gpat = ops.get_pattern(gspec, g, l, 128, 128)
        qg = q[:, :, :g].contiguous()
        want, wl = SA.banded_plain(qg, k, v, gspec, gpat, d ** -0.5,
                                   return_lse=True)
        got, gl = SA.swat_attention_fwd(qg, k, v, gspec, pattern=gpat,
                                        return_lse=True)
        torch.cuda.synchronize()
        name = f"swat_attention_fwd {dn} global rows"
        gerr = check_close(name, got, want, dn)
        check_close(name + " lse", gl, wl, dn, atol=1e-3, rtol=1e-4)
        # both passes composed as the serve path calls them
        got = ops.swat_attention(q, k, v, spec, impl="kernel")
        want = ops.swat_attention(q, k, v, spec, impl="banded")
        torch.cuda.synchronize()
        err = check_close(f"ops.swat_attention {dn} kernel vs banded", got,
                          want, dn)
        if dn == "bfloat16":        # the serve path's shapes and dtype
            main_err = max(main_err, gerr, err)
        # head dim 128 (granite-8b, qwen2.5-32b, moonshot, jamba), and
        # whisper's encoder band: 1500 rows, not a multiple of any tile
        for tag, sp, bb, hq_, hkv_, ll, dd in (
                ("D=128", spec, b, hq, hkv, l, 128),
                ("ragged whisper band", AttentionSpec(**WHISPER_BAND),
                 WHISPER["clips"], 6, 6, WHISPER["frames"], 64)):
            qq, kk, vv = mk(bb, hq_, ll, dd), mk(bb, hkv_, ll, dd), \
                mk(bb, hkv_, ll, dd)
            pat = ops.get_pattern(sp, ll, ll, 128, 128)
            want, wl = SA.banded_plain(qq, kk, vv, sp, pat, dd ** -0.5,
                                       return_lse=True)
            before = route_counts()
            got, gl = SA.swat_attention_fwd(qq, kk, vv, sp, pattern=pat,
                                            return_lse=True)
            torch.cuda.synchronize()
            name = f"swat_attention_fwd {dn} {tag}"
            check_route(name, before, "fwd",
                        expected_route(dtype, dd, "fwd"))
            err = check_close(name, got, want, dn)
            check_close(name + " lse", gl, wl, dn, atol=1e-3, rtol=1e-4)
            log(f"{name}: max abs err {err:.3g}")
            del qq, kk, vv, want, wl, got, gl
    log("swat_attention_fwd: 14 cases (3 specs, the global-row pass, "
        "ops.swat_attention's two passes composed, head dim 128 and the "
        "ragged whisper band, x bf16/fp32), O and LSE within tolerance, "
        "each launch on its route")
    return main_err


# ------------------------------------------------------------- phase 3 ---

def serve(torch, cfg, params):
    import numpy as np
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_decode as SD
    from repro_torch.serving.engine import Request, ServingEngine
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (MAIN["prompt"],))
               .astype(np.int32) for _ in range(8)]

    def run(n_new, reqs):
        eng = ServingEngine(cfg, params, batch_slots=4,
                            max_len=MAIN["max_len"], scan_steps=8)
        t0 = time.perf_counter()
        res = eng.run([Request(rid=i, prompt=p, max_new_tokens=n_new)
                       for i, p in enumerate(reqs)])
        torch.cuda.synchronize()
        no_step_down(eng, "serve")
        return eng, res, time.perf_counter() - t0

    run(4, prompts[:4])                      # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    SD.LAUNCHES.reset()
    SA.LAUNCHES.reset()
    before = route_counts()
    eng, res, wall = run(MAIN["new_tokens"], prompts)
    launches = {"swat_decode": SD.LAUNCHES.n,
                "swat_attention_fwd": SA.LAUNCHES.n}
    check_route("serve", before, "fwd", "tc", n=SA.LAUNCHES.n)
    st = eng.stats
    n_tok = sum(len(r.tokens) for r in res)
    for r in res:
        if r.status != "ok" or len(r.tokens) != MAIN["new_tokens"]:
            raise AssertionError(f"request {r.rid}: {r.status}, "
                                 f"{len(r.tokens)} tokens")
        if min(r.tokens) < 0 or max(r.tokens) >= cfg.vocab_size:
            raise AssertionError(f"request {r.rid}: token out of range")
    layers = cfg.num_layers
    passes = 2 if cfg.attention.num_global else 1   # band + global rows
    expected = {"swat_decode": layers * st["decode_steps"],
                "swat_attention_fwd": layers * passes
                * st["prefill_batches"]}
    if launches != expected:
        raise AssertionError(f"serve launches {launches}, expected "
                             f"{expected} for {st['decode_steps']} decode "
                             f"steps and {st['prefill_batches']} prefill "
                             "batches")
    summary = {
        "requests": len(res), "tokens": n_tok, "wall_s": wall,
        "tok_per_s": n_tok / wall,
        "prefill_batches": st["prefill_batches"],
        "prefill_ms_per_batch": st["prefill_s"] * 1e3
        / st["prefill_batches"],
        "decode_steps": st["decode_steps"],
        "decode_ms_per_step": st["decode_s"] * 1e3 / st["decode_steps"],
        "decode_ms_per_token": st["decode_s"] * 1e3
        / max(1, st["tokens_emitted"]),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches}
    log("serve: " + json.dumps(summary))
    return summary, [r.tokens for r in res]


# ------------------------------------------------------------- phase 4 ---

def end_to_end(torch, cfg, params, tokens):
    """Kernel path vs plain path on the same prompts (the serve run's first
    four). Also reports whether the serve run's first tokens are the kernel
    path's greedy prefill tokens."""
    import numpy as np
    from repro_torch.core import model as Mod
    rng = np.random.RandomState(0)
    prompts = np.stack([rng.randint(0, cfg.vocab_size, (MAIN["prompt"],))
                        for _ in range(4)]).astype(np.int64)
    tok = torch.as_tensor(prompts, device="cuda")
    lk, ck = Mod.prefill(params, cfg, {"tokens": tok}, MAIN["max_len"],
                         impl="kernel")
    lp, cp = Mod.prefill(params, cfg, {"tokens": tok}, MAIN["max_len"],
                         impl="banded")
    nxt = lk[:, 0].argmax(-1)
    first = nxt.tolist()
    diffs = [max_err(lk, lp)]
    agree = [(lk.argmax(-1) == lp.argmax(-1)).float().mean().item()]
    for _ in range(8):
        batch = {"tokens": nxt[:, None]}
        lk, _ = Mod.decode_step(params, cfg, batch, ck, impl="kernel")
        lp, _ = Mod.decode_step(params, cfg, batch, cp, impl="banded")
        diffs.append(max_err(lk, lp))
        agree.append((lk.argmax(-1) == lp.argmax(-1)).float().mean().item())
        nxt = lk[:, 0].argmax(-1)       # teacher-forced on the kernel run
    torch.cuda.synchronize()
    out = {"max_abs_logit_diff": max(diffs),
           "greedy_agreement": sum(agree) / len(agree),
           "logit_bound": LOGIT_BOUND, "agreement_bound": AGREE_BOUND,
           "serve_first_tokens_match": all(
               tokens[i][0] == first[i] for i in range(4))}
    log(f"e2e kernel vs plain ({cfg.name}, {cfg.dtype}): "
        + json.dumps(out))
    if not all(np.isfinite(diffs)):
        raise AssertionError("non-finite logits")
    if not (out["max_abs_logit_diff"] <= LOGIT_BOUND
            and out["greedy_agreement"] >= AGREE_BOUND):
        raise AssertionError(f"kernel path vs plain path: {out}")
    return out


# ------------------------------------------------------------- phase 5 ---

def time_ms(torch, fn, iters=30):
    """Mean device time of fn(), L2 flushed before each call (the serving
    loop reaches each layer's data cold). A spin kernel queued ahead of the
    start event keeps the card busy while the host enqueues fn's launches,
    so host launch latency never lands between the two events."""
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def time_decode(torch, spec, t=1, shape=MAIN):
    """The fused decode at T rows a slot (T=1: a decode step; T=5: a
    speculative verify step at k=4) on a ring with T-1 lookahead rows, at
    `shape`'s slots and heads (llama's serve shape by default)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, hq, hkv, d = shape["b"], shape["hq"], shape["hkv"], shape["d"]
    lens = [600, 575, 530, 700]             # mid-serve ring depths
    q, kc, vc, nk, nv, pos, nn, cap = _ring_inputs(
        torch, gen, torch.bfloat16, b, hq // hkv, hkv, t, d, lens)
    nn.fill_(t)
    return _time_fused(torch, spec, q, kc, vc, nk, nv, pos, nn, cap)


def _time_fused(torch, spec, q, kc, vc, nk, nv, pos, nn, cap):
    """(kernel ms, plain ms, SDPA ms, bytes, operations) of the fused
    decode on the given rings."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import swat_decode as SD
    b, hq, t, d = q.shape
    hkv = kc.shape[1]
    k_ms = time_ms(torch, lambda: SD.swat_decode_fused(
        q, kc, vc, nk, nv, pos, nn, spec, ring_cap=cap))
    p_ms = time_ms(torch, lambda: SD.swat_decode_fused_plain(
        q, kc, vc, nk, nv, pos, nn, spec, ring_cap=cap))
    # library yardstick: SDPA on the updated rings with the same mask
    w = kc.shape[2]
    t_s, ok = ref.ring_slot_positions(pos.long() + nn.long(), w,
                                      ring_cap=cap, num_global=4)
    qp = pos.long()[:, None, None] + torch.arange(t, device="cuda")[:, None]
    vis = ok[:, None] & (t_s[:, None] <= qp) & (
        (t_s[:, None] >= qp - spec.window)
        | (torch.arange(w, device="cuda") < 4))            # (B, T, W)
    mask = vis[:, None]
    ke = kc.repeat_interleave(hq // hkv, dim=1)
    ve = vc.repeat_interleave(hq // hkv, dim=1)
    l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, ke, ve, attn_mask=mask))
    rows = int(vis.any(dim=1).sum())        # ring rows read, all slots
    pairs = int(vis.sum())                  # visible (query, row) pairs
    itm = 2
    bytes_ = (itm * d * (2 * b * hq * t          # q in, out
                         + 4 * b * hkv * t       # new k/v in, written rows
                         + 2 * hkv * rows))      # visible K and V rows
    ops_ = 4 * d * hq * pairs
    return k_ms, p_ms, l_ms, bytes_, ops_


def time_banded(torch, spec, shape=MAIN):
    import torch.nn.functional as F
    from repro_torch.core import patterns
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_attention as SA
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, hq, hkv, d, l = shape["b"], shape["hq"], shape["hkv"], shape["d"], \
        MAIN["prompt"]
    mk = lambda *s: torch.randn(*s, generator=gen,
                                device="cuda").to(torch.bfloat16)
    q, k, v = mk(b, hq, l, d), mk(b, hkv, l, d), mk(b, hkv, l, d)
    pat = ops.get_pattern(spec, l, l, 128, 128)
    k_ms = time_ms(torch, lambda: SA.swat_attention_fwd(
        q, k, v, spec, pattern=pat, return_lse=True))
    p_ms = time_ms(torch, lambda: SA.banded_plain(
        q, k, v, spec, pat, d ** -0.5, return_lse=True))
    dm = torch.as_tensor(patterns.dense_mask(spec, l, l), device="cuda")
    ke = k.repeat_interleave(hq // hkv, dim=1)
    ve = v.repeat_interleave(hq // hkv, dim=1)
    l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, ke, ve, attn_mask=dm))
    n_vis = int(dm.sum())
    bytes_ = 2 * d * l * b * (2 * hq + 2 * hkv) + 4 * b * hq * l
    ops_ = 4 * d * b * hq * n_vis
    return k_ms, p_ms, l_ms, bytes_, ops_


# ------------------------------------------------------------- phase 6 ---

_CATEGORIES = (("swat_decode_plain", ("decode_plain_",)),
               ("swat_decode", ("decode_fused_kernel",)),
               ("swat_attention_fwd", ("attention_fwd_kernel",
                                       "attention_fwd_tc_kernel")),
               ("swat_attention_dq", ("attention_dq_kernel",
                                      "attention_dq_tc_kernel")),
               ("swat_attention_dkv", ("attention_dkv_kernel",
                                       "attention_dkv_tc_kernel")),
               ("swat_attention_dkv_combine", ("dkv_combine_kernel",)),
               ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas")))


def _union_ms(ranges):
    """Length of the union of profiler time ranges (us -> ms)."""
    spans = sorted((r.start, r.end) for r in ranges)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    return (busy + cur_e - cur_s) / 1e3


def trace_decode(torch, cfg, params, span="engine.decode_block",
                 n_new=17, prompts=None, **engine_kw):
    """torch.profiler over one admitted batch of 4 requests (random
    prompts, or `prompts`) served by a ServingEngine(**engine_kw): the
    device's busy share of the wall time and of the host time of the
    `span` ranges ("engine.decode_block": the decode or verify blocks;
    "engine.prefill": the admission), and device time by kernel category
    inside them. Decode blocks must launch one fused decode kernel per
    layer and step and no plain one (the wrappers' launch counters, which
    see every launch) and hold no profiler record of another decode
    kernel; the fused records the profiler saw are reported beside the
    launches counted, since it may drop records."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import swat_decode as SD
    from repro_torch.serving.engine import Request, ServingEngine
    if prompts is None:
        rng = np.random.RandomState(1)
        prompts = [rng.randint(0, cfg.vocab_size, (MAIN["prompt"],))
                   for _ in range(4)]

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=n_new)
                for i, p in enumerate(prompts)]

    eng = ServingEngine(cfg, params, batch_slots=4, max_len=MAIN["max_len"],
                        scan_steps=8, **engine_kw)
    # a graph is captured at its key's second use: after two untraced runs
    # of the same requests the traced run only replays
    for _ in range(2 if eng.graphs else 0):
        eng.run(reqs())
    stats0 = dict(eng.stats)
    captured0 = len(eng._compiled.captured)
    torch.cuda.synchronize()
    launches0 = (SD.LAUNCHES.n, SD.PLAIN_LAUNCHES.n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # launches from the wrappers' counters (a replay adds back what its
    # capture counted); the profiler may drop kernel records
    fused_n = SD.LAUNCHES.n - launches0[0]
    plain_n = SD.PLAIN_LAUNCHES.n - launches0[1]
    no_step_down(eng, f"trace {span}")
    st = {k: v - stats0[k] for k, v in eng.stats.items()}
    if span == "engine.decode_block" and (
            fused_n != cfg.num_layers * st["decode_steps"] or plain_n):
        raise AssertionError(
            f"trace: {fused_n} fused decode launches in "
            f"{st['decode_steps']} decode steps of {cfg.num_layers} layers "
            f"and {plain_n} plain decode launches, expected one fused "
            "launch a layer and step and no plain one")
    events = prof.events()
    dt = torch.autograd.DeviceType
    kernels = [e for e in events if e.device_type == dt.CUDA
               and not e.name.startswith("engine.")]
    blocks = [e.time_range for e in events
              if e.name == span and e.device_type == dt.CPU]
    out = {"span": span, "graphs": eng.graphs,
           "captured_in_traced_run": len(eng._compiled.captured) - captured0,
           "wall_ms": wall_ms,
           "prefill_ms": st["prefill_s"] * 1e3,
           "decode_ms": st["decode_s"] * 1e3,
           "decode_steps": st["decode_steps"],
           "spec_steps": st["spec_steps"],
           "device_kernels": len(kernels)}
    if not kernels or not blocks:
        out["device_time"] = "not measured (no device events traced)"
        log("trace: " + json.dumps(out))
        return out
    # spans end in a host sync and start after the previous one, so a
    # kernel belongs to the span whose host range holds its start
    dec = [e for e in kernels
           if any(b.start <= e.time_range.start <= b.end for b in blocks)]
    if not dec:
        out["device_time"] = f"not measured (no kernel inside {span})"
        log("trace: " + json.dumps(out))
        return out
    block_ms = sum(b.elapsed_us() for b in blocks) / 1e3
    by_cat = {}
    for e in dec:
        name = e.name.lower()
        cat = next((c for c, keys in _CATEGORIES
                    if any(k in name for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + e.time_range.elapsed_us() / 1e3
    if span == "engine.decode_block":
        per = max(1, st["decode_steps"])
        # the fused decode is one kernel per layer and step (counted
        # above): its cluster merge launches nothing else
        fused = sum("decode_fused_kernel" in e.name for e in dec)
        stray = sorted({e.name[:60] for e in dec
                        if "decode" in e.name.lower()
                        and "decode_fused_kernel" not in e.name})
        if stray:
            raise AssertionError(f"trace: other decode kernels in the "
                                 f"decode blocks: {stray}")
        out.update(fused_decode_kernels_per_step=fused_n / per,
                   fused_decode_launches_counted=fused_n,
                   fused_decode_records_seen=fused)
        unit = "step"
    else:
        per = max(1, st["prefill_batches"])
        out["attention_fwd_kernels_per_batch"] = sum(
            "attention_fwd" in e.name for e in dec) / per
        unit = "batch"
    busy = _union_ms([e.time_range for e in dec])
    out.update({
        "span_host_ms": block_ms,
        "span_device_busy_ms": busy,
        "span_busy_share": busy / block_ms,
        f"device_ms_per_{unit}_by_category": {
            k: v / per for k, v in sorted(by_cat.items())},
        f"kernels_per_{unit}": len(dec) / per,
        "run_busy_share": _union_ms([e.time_range for e in kernels])
        / wall_ms})
    log("trace: " + json.dumps(out))
    return out


# ------------------------------------------------------------- phase 7 ---

def _bwd_inputs(torch, gen, dtype, b, hq, hkv, lq, lkv, d, sp, pat):
    from repro_torch.kernels import swat_attention as SA
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    q, k, v = mk(b, hq, lq, d), mk(b, hkv, lkv, d), mk(b, hkv, lkv, d)
    do = mk(b, hq, lq, d)
    o, lse = SA.swat_attention_fwd(q, k, v, sp, pattern=pat, return_lse=True)
    return q, k, v, o, lse, do


def check_backward(torch, spec):
    """dQ and dK/dV kernels against swat_attention_bwd_plain at the
    training shapes; a second launch must be bitwise equal, and each dQ
    and dK/dV launch must count on its route (with one combine launch where
    the chunk plan cut a row). The combine kernel is held bitwise against
    its plain version on the main case's partials. Then autograd through
    ops.swat_attention (both passes), kernel against banded. Returns the
    largest bf16 error of dQ and of dK/dV on the main case."""
    import dataclasses
    from repro_torch.core.types import AttentionSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_backward as SB
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, d, l = MAIN["b"], MAIN["d"], TRAIN["seq"]
    gspec = dataclasses.replace(spec, kind="dense", window=0, num_global=0,
                                num_random=0)
    wl = WHISPER["frames"]
    # (tag, spec, batch, q heads, kv heads, Lq, Lkv, head dim)
    cases = [("causal+globals group 4", spec, b, 32, 8, l, l, d),
             ("group 1", spec, b, 8, 8, l, l, d),
             ("group 8", spec, b, 32, 4, l, l, d),
             # granite-moe-1b's heads: the shape its training step gives
             # the tensor-core dQ and dK/dV kernels
             ("group 2 (granite-moe)", spec, b, 16, 8, l, l, d),
             ("softcap 30", dataclasses.replace(spec, softcap=30.0), b, 32,
              8, l, l, d),
             ("softcap 50", dataclasses.replace(spec, softcap=50.0), b, 32,
              8, l, l, d),
             ("random blocks", dataclasses.replace(spec, num_random=2,
                                                   random_seed=7),
              b, 32, 8, l, l, d),
             ("longformer bidirectional", AttentionSpec(
                 kind="swat", window=256, num_global=1, causal=False),
              b, 12, 12, l, l, d),
             ("global rows", gspec, b, 32, 8, spec.num_global, l, d),
             ("D=128", spec, b, 32, 8, l, l, 128),
             # gemma2-2b's head dim: the two-warpgroup tensor-core dK/dV,
             # with kv block 0 cut by the chunk plan (the combine at D=256)
             ("D=256", spec, 1, 8, 4, l, l, 256),
             ("ragged whisper band", AttentionSpec(**WHISPER_BAND),
              WHISPER["clips"], 6, 6, wl, wl, d),
             # Lq != Lkv: whisper's cross attention, the decoder's max_len
             # queries against the 1500 encoder rows, dense non-causal
             ("whisper cross Lq != Lkv", AttentionSpec(kind="dense",
                                                       causal=False),
              WHISPER["clips"], 6, 6, WHISPER["max_len"], wl, d)]
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for tag, sp, bb, hq, hkv, lq, lkv, dd in cases:
            pat = ops.get_pattern(sp, lq, lkv, 128, 128)
            q, k, v, o, lse, do = _bwd_inputs(torch, gen, dtype, bb, hq, hkv,
                                              lq, lkv, dd, sp, pat)
            want = SB.swat_attention_bwd_plain(q, k, v, o, lse, do, sp, pat,
                                               dd ** -0.5)
            before = route_counts()
            got = SB.swat_attention_bwd(q, k, v, o, lse, do, sp, pattern=pat)
            again = SB.swat_attention_bwd(q, k, v, o, lse, do, sp,
                                          pattern=pat)
            torch.cuda.synchronize()
            name = f"swat_attention_bwd {dn} {tag}"
            dq_route = expected_route(dtype, dd, "dq")
            check_route(name, before, "dq", dq_route, n=2)
            route = expected_route(dtype, dd, "dkv")
            check_route(name, before, "dkv", route, n=2)
            split = SB.dkv_plan(pat.inverse()).combine.shape[0] > 0
            combines = route_counts()["combine"] - before["combine"]
            if combines != (2 if route == "tc" and split else 0):
                raise AssertionError(f"{name}: {combines} combine launches "
                                     f"for 2 dK/dV launches (split: {split})")
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{name}: two launches differ")
            e = [check_close(f"{name} d{n}", g, w, dn, **BWD_TOL[dn])
                 for n, g, w in zip("qkv", got, want)]
            errs[(dn, tag)] = e
            log(f"{name}: max abs err dq {e[0]:.3g} dk {e[1]:.3g} "
                f"dv {e[2]:.3g}, bitwise deterministic, dQ on the "
                f"{dq_route} route, dK/dV on the {route} route, {combines} "
                "combine launches")
            if (dn, tag) == ("bfloat16", "causal+globals group 4"):
                combine_err = check_combine(torch, SB, q, k, v, o, lse, do,
                                            sp, pat, got)
            del q, k, v, o, lse, do, want, got, again
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        mk = lambda *s: torch.randn(*s, generator=gen,
                                    device="cuda").to(dtype)
        q, k, v = mk(b, 32, l, d), mk(b, 8, l, d), mk(b, 8, l, d)
        w = mk(b, 32, l, d)
        grads = {}
        for impl in ("kernel", "banded"):
            qkv = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = ops.swat_attention(*qkv, spec, impl=impl)
            grads[impl] = torch.autograd.grad((out.float() * w.float()).sum(),
                                              qkv)
        torch.cuda.synchronize()
        for n, g, p in zip("qkv", grads["kernel"], grads["banded"]):
            err = check_close(f"autograd {dn} d{n} kernel vs banded", g, p,
                              dn, **GRAD_TOL[dn])
            log(f"autograd {dn} d{n}: kernel vs banded max abs err {err:.3g}")
    main = errs[("bfloat16", "causal+globals group 4")]
    log(f"swat_attention_bwd: {len(errs)} cases, bitwise deterministic, "
        "within tolerance, each dQ and dK/dV launch on its route; autograd "
        "kernel vs banded within tolerance")
    return main[0], max(main[1], main[2]), combine_err


def check_combine(torch, SB, q, k, v, o, lse, do, sp, pat, full):
    """The tensor-core dK/dV launch alone, then its combine launch and the
    combine's plain version on the same partials: bitwise equal to each
    other and to the full dK/dV of `full` (dq, dk, dv). Returns the max
    abs difference of the combine against its plain version (0)."""
    delta = (do.float() * o.float()).sum(-1)
    dk, dv, part_k, part_v, combine = SB.launch_dkv_tc(
        q, k, v, do, lse, delta, sp, pat, q.shape[3] ** -0.5,
        bound=k.shape[2])
    dk2, dv2 = dk.clone(), dv.clone()
    SB.dkv_combine(part_k, part_v, combine, dk, dv)
    SB.dkv_combine_plain(part_k, part_v, combine, dk2, dv2)
    torch.cuda.synchronize()
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError("dkv_combine: kernel and plain version differ")
    if not (torch.equal(dk, full[1]) and torch.equal(dv, full[2])):
        raise AssertionError("dkv_combine: launch_dkv_tc + dkv_combine "
                             "differ from swat_attention_bwd's dK/dV")
    err = max(max_err(dk, dk2), max_err(dv, dv2))
    log(f"dkv_combine: {combine.shape[0]} split kv block(s), "
        f"{part_k.shape[0]} partials; bitwise equal to its plain version "
        "and to the full dK/dV")
    return err


# ------------------------------------------------------------- phase 8 ---

def _train_batches(torch, cfg, n):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN["seq"],
                                  global_batch=TRAIN["b"], seed=1234))
    return [{k: torch.as_tensor(v, device="cuda")
             for k, v in data.global_batch(s).items()} for s in range(n)]


def train(torch, cfg, n=TRAIN["steps"]):
    """n AdamW steps at full width (phase 8: 6 of llama; phase 24: 2 of
    granite-moe; phase 25: 2 of mamba2, which launches no attention
    kernel); launch counts zeroed just before and read just after,
    every launch on the tensor-core route, losses (and MoE aux losses)
    finite. Returns (summary, launches, (params, opt, step_fn, batch)) for
    the profiled step of phase 11 and phase 24's gradient check."""
    import math
    from repro_torch import tree
    from repro_torch.core import model as Mod
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_backward as SB
    from repro_torch.launch import steps as St
    from repro_torch.optim import adamw
    params = Mod.init_model(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in tree.leaves(params))
    opt = adamw.init_opt_state(params)
    step_fn = St.make_train_step(
        cfg, adamw.AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                               total_steps=n), remat_policy="nothing")
    batches = _train_batches(torch, cfg, n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in (SA.LAUNCHES, SB.DQ_LAUNCHES, SB.DKV_LAUNCHES):
        c.reset()
    before = route_counts()
    losses, auxes, gnorms, times = [], [], [], []
    for s in range(n):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batches[s])
        loss, aux, gn = torch.stack([m["loss"], m["aux_loss"],
                                     m["grad_norm"]]).tolist()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        auxes.append(aux)
        gnorms.append(gn)
        log(f"train step {s} ({cfg.name}): loss {loss:.4f} aux_loss "
            f"{aux:.4f} grad_norm {gn:.4f} {times[-1] * 1e3:.1f} ms")
    launches = {"swat_attention_fwd": SA.LAUNCHES.n,
                "swat_attention_dq": SB.DQ_LAUNCHES.n,
                "swat_attention_dkv": SB.DKV_LAUNCHES.n}
    check_route("train", before, "fwd", "tc", n=SA.LAUNCHES.n)
    check_route("train", before, "dq", "tc", n=SB.DQ_LAUNCHES.n)
    check_route("train", before, "dkv", "tc", n=SB.DKV_LAUNCHES.n)
    combines = route_counts()["combine"] - before["combine"]
    launches["swat_attention_dkv_combine"] = combines
    tokens = TRAIN["b"] * TRAIN["seq"]
    steady = sum(times[1:]) / (n - 1)
    # params a token runs through: an MoE layer's top-k of E experts
    experts = sum(p.numel() for blk in params["blocks"]
                  for layer in blk.values() if "moe" in layer
                  for k, p in layer["moe"].items() if k != "router")
    active = n_params - experts * (1 - cfg.moe.top_k
                                   / max(1, cfg.moe.num_experts))
    summary = {"losses": losses, "aux_losses": auxes, "grad_norms": gnorms,
               "step_ms": [t * 1e3 for t in times],
               "tokens_per_s_after_step_1": tokens * (n - 1)
               / sum(times[1:]),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "params": n_params, "active_params": active,
               "model_tflop_per_step": 6 * active * tokens / 1e12,
               "model_flop_share": 6 * active * tokens / steady
               / PEAK_OPS["bfloat16"],
               "launches": launches}
    log(f"train ({cfg.name}): " + json.dumps(summary))
    if not all(math.isfinite(x) for x in losses + auxes + gnorms):
        raise AssertionError(f"non-finite training metrics: {summary}")
    layers = attn_layers(cfg)
    need = {"swat_attention_fwd": 2 * layers * 2 * n,   # 2 passes, remat
            "swat_attention_dq": 2 * layers * n,
            "swat_attention_dkv": 2 * layers * n,
            # the band pass's plan cuts kv block 0; the global-row pass's
            # plan cuts nothing
            "swat_attention_dkv_combine": layers * n}
    if launches != need:
        raise AssertionError(f"train launches {launches} in {n} steps, "
                             f"expected {need}")
    return summary, launches, (params, opt, step_fn, batches[0])


# ------------------------------------------------------------- phase 9 ---

def _loss_grads(torch, params, cfg, batch, impl):
    """(loss, aux_loss, gradient of the total per leaf) through `impl`."""
    from repro_torch import tree
    from repro_torch.core import model as Mod
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        total, m = Mod.loss_fn(params, cfg, batch, impl=impl)
        grads = torch.autograd.grad(total, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return float(m["loss"].detach()), float(m["aux_loss"].detach()), grads


def _grad_gap(params, a, b):
    """|dloss|, |daux| and the largest relative gradient error over the
    leaves (over the MoE leaves apart) of `a` against `b`, each
    (loss, aux, grads)."""
    from repro_torch import tree
    paths = [p for p, _ in tree.flatten_with_paths(params)]
    rel = [float((x.float() - y.float()).norm()
                 / y.float().norm().clamp(min=1e-30))
           for x, y in zip(a[2], b[2])]
    worst = max(range(len(rel)), key=rel.__getitem__)
    return {"loss": a[0], "loss_diff": abs(a[0] - b[0]),
            "aux_loss": a[1], "aux_diff": abs(a[1] - b[1]),
            "max_leaf_rel_grad_err": rel[worst], "worst_leaf": paths[worst],
            "max_moe_leaf_rel_grad_err": max(
                (r for r, p in zip(rel, paths) if "/moe/" in p),
                default=None)}


def train_end_to_end(torch, cfg):
    """One loss and gradient at full width, depth cut to 4 layers so the
    plain path fits the time: kernel path against the plain path."""
    import dataclasses
    from repro_torch.core import model as Mod
    cfg4 = dataclasses.replace(cfg, num_layers=TRAIN["e2e_layers"])
    params = Mod.init_model(cfg4, seed=0, device="cuda")
    batch = _train_batches(torch, cfg4, 1)[0]
    out = {"layers": cfg4.num_layers, **_grad_gap(
        params, *(_loss_grads(torch, params, cfg4, batch, impl)
                  for impl in ("kernel", "banded"))),
        "loss_bound": TRAIN_LOSS_BOUND, "grad_bound": TRAIN_GRAD_BOUND}
    log("train e2e kernel vs plain: " + json.dumps(out))
    if not (out["loss_diff"] <= TRAIN_LOSS_BOUND
            and out["max_leaf_rel_grad_err"] <= TRAIN_GRAD_BOUND):
        raise AssertionError(f"train step kernel path vs plain path: {out}")
    return out


# ------------------------------------------------------------ phase 10 ---

def resume_drill(torch):
    """The JAX package's bit-exact resume test on the card: an
    uninterrupted 8-step run and a run that fails at step 6, then resumes
    from the step-4 checkpoint, end with bitwise-equal params."""
    import shutil
    import tempfile
    from repro_torch import tree
    from repro_torch.configs import get_smoke_config, with_swat
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    cfg = with_swat(get_smoke_config("llama3.2-1b"), window=16, num_global=4)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")

    def make(sub, fail_at=-1):
        return Trainer(
            cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8),
            TrainConfig(total_steps=8, ckpt_every=4,
                        ckpt_dir=os.path.join(root, sub), log_every=100,
                        fail_at_step=fail_at, device="cuda"),
            DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                       global_batch=4, seed=7))

    torch.use_deterministic_algorithms(True)
    try:
        ref = make("ref").train()
        try:
            make("x", fail_at=6).train()
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        else:
            raise AssertionError("the failure drill did not fail")
        out = make("x").train()
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    a = tree.leaves(ref["state"]["params"])
    b = tree.leaves(out["state"]["params"])
    same = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    res = {"leaves": len(a), "bitwise_equal": same,
           "resumed_steps": len(out["history"]),
           "final_loss": out["history"][-1]["loss"]}
    log("resume drill: " + json.dumps(res))
    if not same:
        raise AssertionError("resumed params differ from the uninterrupted "
                             "run's")
    return res


# ------------------------------------------------------------ phase 11 ---

def time_backward(torch, spec, shape=MAIN):
    """dQ and dK/dV at the training shapes (`shape`'s heads; llama's by
    default), their plain version (which computes all three gradients) and
    SDPA's backward (forward+backward minus forward) on head-expanded K/V
    with the same boolean mask."""
    import torch.nn.functional as F
    from repro_torch.core import patterns
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_backward as SB
    gen = torch.Generator(device="cuda").manual_seed(6)
    b, hq, hkv, d, l = shape["b"], shape["hq"], shape["hkv"], shape["d"], \
        TRAIN["seq"]
    pat = ops.get_pattern(spec, l, l, 128, 128)
    q, k, v, o, lse, do = _bwd_inputs(torch, gen, torch.bfloat16, b, hq, hkv,
                                      l, l, d, spec, pat)
    delta = (do.float() * o.float()).sum(-1)
    kw = dict(q_offset=0, kv_offset=0, bound=l)
    scale = d ** -0.5
    dq_ms = time_ms(torch, lambda: SB.launch_dq(q, k, v, do, lse, delta,
                                                spec, pat, scale, **kw))
    dkv_ms = time_ms(torch, lambda: SB.launch_dkv(q, k, v, do, lse, delta,
                                                  spec, pat, scale, **kw))
    tc_ms = time_ms(torch, lambda: SB.launch_dkv_tc(
        q, k, v, do, lse, delta, spec, pat, scale, **kw))
    dk, dv, part_k, part_v, combine = SB.launch_dkv_tc(
        q, k, v, do, lse, delta, spec, pat, scale, **kw)
    c_ms = time_ms(torch, lambda: SB.dkv_combine(part_k, part_v, combine,
                                                 dk, dv))
    cp_ms = time_ms(torch, lambda: SB.dkv_combine_plain(
        part_k, part_v, combine, dk, dv))
    p_ms = time_ms(torch, lambda: SB.swat_attention_bwd_plain(
        q, k, v, o, lse, do, spec, pat, scale))
    dm = torch.as_tensor(patterns.dense_mask(spec, l, l), device="cuda")
    qr = q.detach().clone().requires_grad_()
    ke = k.repeat_interleave(hq // hkv, dim=1).requires_grad_()
    ve = v.repeat_interleave(hq // hkv, dim=1).requires_grad_()

    def fwd():
        return F.scaled_dot_product_attention(qr, ke, ve, attn_mask=dm)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qr, ke, ve), do)

    with torch.no_grad():
        f_ms = time_ms(torch, fwd)
    l_ms = time_ms(torch, fwd_bwd) - f_ms
    n_vis = int(dm.sum()) * b * hq
    itm, rows_q, rows_kv = 2, b * hq * l, b * hkv * l
    dq_bytes = itm * d * (3 * rows_q + 2 * rows_kv) + 4 * 2 * rows_q
    dkv_bytes = itm * d * (2 * rows_q + 4 * rows_kv) + 4 * 2 * rows_q
    # the combine reads the partials of the cut kv blocks and writes their
    # dK and dV rows
    rows_cut = sum(min(pat.block_kv, l - j * pat.block_kv)
                   for j in combine[:, 0].tolist())
    c_bytes = (2 * part_k.numel() * 4
               + 2 * itm * d * b * hkv * rows_cut)
    out = {"visible_pairs": n_vis,
           "dq": (dq_ms, p_ms, l_ms, dq_bytes, 6 * d * n_vis),
           "dkv": (tc_ms, p_ms, l_ms, dkv_bytes, 8 * d * n_vis),
           "combine": (c_ms, cp_ms, None, c_bytes, part_k.numel() * 2),
           "dkv_total_ms": dkv_ms}
    log(f"backward times ({hq} q over {hkv} kv heads): dq {dq_ms:.4f} ms, "
        f"dkv {dkv_ms:.4f} ms (the "
        f"tensor-core launch {tc_ms:.4f} ms + combine {c_ms:.4f} ms; the "
        f"combine's plain version {cp_ms:.4f} ms), plain {p_ms:.4f} ms, "
        f"SDPA backward {l_ms:.4f} ms (forward {f_ms:.4f}); {n_vis} visible "
        "pairs")
    return out


def time_forward_train(torch, spec):
    """The forward at the training shape (B=4, 32 q heads over 8 kv heads,
    L=2048, D=64, bf16): the band pass and the global-row pass apart, each
    with its plain version, SDPA on the same q/K/V with the pass's mask,
    and its bound. Returns {pass: (ms, plain_ms, sdpa_ms, bound_ms,
    bound_by)}."""
    import dataclasses
    import torch.nn.functional as F
    from repro_torch.core import patterns
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_attention as SA
    gen = torch.Generator(device="cuda").manual_seed(11)
    b, hq, hkv, d, l = MAIN["b"], MAIN["hq"], MAIN["hkv"], MAIN["d"], \
        TRAIN["seq"]
    g = spec.num_global
    mk = lambda *s: torch.randn(*s, generator=gen,
                                device="cuda").to(torch.bfloat16)
    q, k, v = mk(b, hq, l, d), mk(b, hkv, l, d), mk(b, hkv, l, d)
    ke = k.repeat_interleave(hq // hkv, dim=1)
    ve = v.repeat_interleave(hq // hkv, dim=1)
    gspec = dataclasses.replace(spec, kind="dense", window=0, num_global=0,
                                num_random=0)
    qg = q[:, :, :g].contiguous()
    out = {}
    for tag, sp, qq, lq in (("band pass", spec, q, l),
                            ("global-row pass", gspec, qg, g)):
        pat = ops.get_pattern(sp, lq, l, 128, 128)
        k_ms = time_ms(torch, lambda: SA.swat_attention_fwd(
            qq, k, v, sp, pattern=pat, return_lse=True))
        p_ms = time_ms(torch, lambda: SA.banded_plain(
            qq, k, v, sp, pat, d ** -0.5, return_lse=True))
        if tag == "band pass":
            dm = torch.as_tensor(patterns.dense_mask(sp, l, l), device="cuda")
            n_vis = int(dm.sum())
            kv_rows = l                       # every K/V row is visible
        else:                                 # causal: row i sees keys <= i
            dm = (torch.arange(l, device="cuda")[None, :]
                  <= torch.arange(g, device="cuda")[:, None])
            n_vis = g * (g + 1) // 2
            kv_rows = g
        l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qq, ke, ve, attn_mask=dm))
        bytes_ = (2 * d * b * (2 * hq * lq + 2 * hkv * kv_rows)
                  + 4 * b * hq * lq)
        out[tag] = (k_ms, p_ms, l_ms, *bound(bytes_, 4 * d * b * hq * n_vis))
    log("forward at L=2048 (bf16, tensor-core route): " + json.dumps(
        {k_: dict(zip(("ms", "plain_ms", "sdpa_ms", "bound_ms", "bound_by"),
                      v_)) for k_, v_ in out.items()}))
    return out


def time_unembed(torch, params, cfg):
    """The decode step's unembed product (B=4 rows against the tied
    128256 x 2048 bf16 head): the fp32-output product the port uses, and
    the bf16-rounded product it replaced. Also reports whether
    aten::mm.dtype has a backward in this PyTorch."""
    import torch.nn.functional as F
    x = torch.randn(MAIN["b"], cfg.d_model, device="cuda").to(torch.bfloat16)
    emb = params["embed"]
    new_ms = time_ms(torch, lambda: torch.mm(x, emb.t(),
                                             out_dtype=torch.float32))
    old_ms = time_ms(torch, lambda: F.linear(x, emb).float())
    a = x.detach().clone().requires_grad_()
    has_bwd = True
    try:
        torch.mm(a, emb.t(), out_dtype=torch.float32).sum().backward()
    except RuntimeError as e:
        if "not implemented" not in str(e):
            raise
        has_bwd = False
    out = {"fp32_out_ms": new_ms, "bf16_rounded_ms": old_ms,
           "mm_dtype_has_backward": has_bwd}
    log("unembed: " + json.dumps(out))
    return out


def trace_train_step(torch, state):
    """torch.profiler over one warm full-width train step: device time by
    kernel category and the device's busy share of the step."""
    from torch.profiler import ProfilerActivity, profile
    params, opt, step_fn, batch = state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, m = step_fn(params, opt, batch)
        m["loss"].item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dt = torch.autograd.DeviceType
    # the step's phase spans appear on the device too: they are not kernels
    kernels = [e for e in prof.events() if e.device_type == dt.CUDA
               and not e.name.startswith(("train.", "engine."))]
    out = {"wall_ms": wall_ms, "device_kernels": len(kernels)}
    if not kernels:
        out["device_time"] = "not measured (no device events traced)"
        log("train trace: " + json.dumps(out))
        return out
    by_cat, by_name = {}, {}
    for e in kernels:
        name = e.name.lower()
        cat = next((c for c, keys in _CATEGORIES
                    if any(k_ in name for k_ in keys)), "other")
        ms = e.time_range.elapsed_us() / 1e3
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + ms
    busy = _union_ms([e.time_range for e in kernels])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out.update(device_ms_by_category=dict(sorted(by_cat.items())),
               device_busy_ms=busy, busy_share=busy / wall_ms,
               top_kernels_ms=dict(top))
    log("train trace: " + json.dumps(out))
    return out


# ------------------------------------------------------------ phase 27 ---

# phase 27's shapes: CP forward cases (sequence, shards, causal) at
# llama3.2-1b + with_swat's defaults (window 2048, 128 globals); the CP
# train step (B=2, L=8192 over 4 shards) and the pipeline (4 stages of 4
# layers, 4 microbatches of phase 8's 4 x 2048 batch) at phase 8's spec
CP_CASES = ((32768, 4, True), (4096, 8, True), (4096, 4, False))
CP_TRAIN = dict(b=2, seq=8192, shards=4)
PP = dict(stages=4, microbatches=4)
# phase 27's O limits, set from a sound run (H100): randn inputs over a
# 2048-wide window give |O| ~ 0.03, so bf16's TOL (atol 3e-2) would be as
# large as the values. The CP op read 0.0039 against the unsharded op, the
# band pass 0.00098 against its plain version; rtol 1e-2 covers one bf16
# ulp at the larger outputs of the first causal rows
CP_TOL = dict(atol=1e-2, rtol=1e-2)
CP_BAND_TOL = dict(atol=4e-3, rtol=1e-2)
# F.embedding's bf16 table gradient against an fp32 index_add, relative
# norm over the touched rows (a sound run read 0.0017; the indexing's
# backward 0.2355)
EMBED_GRAD_LIMIT = 5e-3


def _cp_band_case(torch, gen, spec, b, lp, n, idx, dtype=None):
    """Inputs of shard `idx`'s band pass (n shards of lp rows): q (B, 32,
    Lp, 64), the halo-extended K/V, the pass's spec, pattern and offsets,
    and its visibility in global coordinates (Lp, halo + Lp (+ halo))."""
    import dataclasses
    from repro_torch.distributed import context_parallel as CP
    from repro_torch.kernels import ops
    dtype = dtype or torch.bfloat16
    band = dataclasses.replace(spec, num_global=0, num_random=0)
    halo = CP.halo_rows(spec.window, lp)
    lkv = halo + lp + (0 if spec.causal else halo)
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    q = mk(b, MAIN["hq"], lp, MAIN["d"])
    k, v = mk(b, MAIN["hkv"], lkv, MAIN["d"]), mk(b, MAIN["hkv"], lkv,
                                                  MAIN["d"])
    pat = ops.get_pattern(band, lp, lkv, 128, 128, q_shift=halo)
    kw = dict(q_offset=idx * lp, kv_offset=idx * lp - halo,
              seq_kv_bound=n * lp)
    qi = idx * lp + torch.arange(lp, device="cuda")[:, None]
    ki = idx * lp - halo + torch.arange(lkv, device="cuda")[None, :]
    vis = (ki >= 0) & (ki < n * lp) & (ki >= qi - spec.window)
    vis &= (ki <= qi) if spec.causal else (ki <= qi + spec.window)
    return q, k, v, band, pat, kw, vis


def check_cp_band(torch, spec, lp, n):
    """Kernel #2's CP band pass on shard 0 (halo rows at negative token
    indices, read as zeros) and on the last shard (rows past L on a
    bidirectional spec) against banded_plain with the same offsets, and
    the CP op's band pass against the kernel #4 / #5 backward of the same
    offsets, each launch on the tensor-core route. Returns the largest
    errors."""
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_backward as SB
    gen = torch.Generator(device="cuda").manual_seed(27)
    errs = {}
    for idx in (0, n - 1):
        q, k, v, band, pat, kw, _ = _cp_band_case(torch, gen, spec, 1, lp, n,
                                                  idx)
        before = route_counts()
        o, lse = SA.swat_attention_fwd(q, k, v, band, pattern=pat,
                                       return_lse=True, **kw)
        check_route(f"cp band shard {idx}", before, "fwd", "tc")
        po, plse = SA.banded_plain(q, k, v, band, pat, MAIN["d"] ** -0.5,
                                   return_lse=True, **kw)
        errs[f"shard{idx}_o"] = check_close(f"cp band shard {idx} O", o, po,
                                            "bfloat16", **CP_BAND_TOL)
        errs[f"shard{idx}_lse"] = check_close(f"cp band shard {idx} LSE",
                                              lse, plse, "bfloat16",
                                              atol=1e-3, rtol=0.0)
        do = torch.randn(o.shape, generator=gen, device="cuda").to(o.dtype)
        dlse = torch.randn(lse.shape, generator=gen, device="cuda")
        before = route_counts()
        got = SB.swat_attention_bwd(q, k, v, o, lse, do, band, pattern=pat,
                                    seq_kv_bound=kw["seq_kv_bound"],
                                    q_offset=kw["q_offset"],
                                    kv_offset=kw["kv_offset"], dlse=dlse)
        check_route(f"cp band dq shard {idx}", before, "dq", "tc")
        check_route(f"cp band dkv shard {idx}", before, "dkv", "tc")
        want = SB.swat_attention_bwd_plain(
            q, k, v, o, lse, do, band, pat, MAIN["d"] ** -0.5,
            q_offset=kw["q_offset"], kv_offset=kw["kv_offset"],
            seq_kv_bound=kw["seq_kv_bound"], dlse=dlse)
        for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
            errs[f"shard{idx}_{name}"] = check_close(
                f"cp band {name} shard {idx}", a, b_, "bfloat16",
                **BWD_TOL["bfloat16"])
    return errs


def cp_forward(torch):
    """(a): CP_CASES through swat_attention_context_parallel on a
    single-process mesh against ops.swat_attention on the unsharded
    sequence (CP_TOL); one kernel #2 launch per shard, on the
    tensor cores; the two ops timed."""
    import dataclasses
    from repro_torch.configs import get_config, with_swat
    from repro_torch.distributed import context_parallel as CP
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import LocalMesh
    base = with_swat(get_config("llama3.2-1b")).attention
    gen = torch.Generator(device="cuda").manual_seed(28)
    out = {}
    for seq, n, causal in CP_CASES:
        spec = dataclasses.replace(base, causal=causal)
        tag = f"L={seq} over {n}{'' if causal else ' bidirectional'}"
        mk = lambda *s: torch.randn(*s, generator=gen,
                                    device="cuda").to(torch.bfloat16)
        q = mk(1, MAIN["hq"], seq, MAIN["d"])
        k, v = mk(1, MAIN["hkv"], seq, MAIN["d"]), mk(1, MAIN["hkv"], seq,
                                                      MAIN["d"])
        mesh = LocalMesh((n,), ("model",))
        cp = lambda: CP.swat_attention_context_parallel(
            q, k, v, spec, mesh=mesh, axis="model")
        ref = lambda: ops.swat_attention(q, k, v, spec)
        with torch.no_grad():
            before = route_counts()
            got = cp()
            check_route(f"cp {tag}", before, "fwd", "tc", n=n)
            want = ref()
            err = check_close(f"cp {tag}", got, want, "bfloat16", **CP_TOL)
            cp_ms, ref_ms = time_ms(torch, cp, 5), time_ms(torch, ref, 5)
        lp = seq // n
        out[tag] = {"lp": lp, "hops": CP.halo_hops(spec.window, lp),
                    "halo_rows": CP.halo_rows(spec.window, lp),
                    "band_launches": n, "max_abs_err": err,
                    "cp_ms": cp_ms, "unsharded_ms": ref_ms,
                    "wire_bytes_per_shard": CP.cp_wire_bytes_per_device(
                        seq, n, spec.window, MAIN["hkv"], MAIN["d"],
                        causal=causal)}
        if not causal:
            out[tag]["band_pass_errors"] = check_cp_band(torch, spec, lp, n)
        log(f"cp forward {tag}: " + json.dumps(out[tag]))
    return out


def time_cp_band(torch, spec, b, lp, n):
    """Kernels #2, #4 and #5 on shard 1's band pass (b rows of lp tokens of
    n shards; kv_offset = lp - halo), their plain versions and SDPA with
    the pass's mask over the halo-extended K/V. Returns {kernel: (ms,
    plain_ms, sdpa_ms, bytes, ops, max_abs_err)}."""
    import torch.nn.functional as F
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_backward as SB
    gen = torch.Generator(device="cuda").manual_seed(29)
    q, k, v, band, pat, kw, vis = _cp_band_case(torch, gen, spec, b, lp, n,
                                                1)
    scale = MAIN["d"] ** -0.5
    hq, hkv, d = MAIN["hq"], MAIN["hkv"], MAIN["d"]
    fwd = lambda: SA.swat_attention_fwd(q, k, v, band, pattern=pat,
                                        return_lse=True, **kw)
    o, lse = fwd()
    po, _ = SA.banded_plain(q, k, v, band, pat, scale, return_lse=True, **kw)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(o.dtype)
    delta = (do.float() * o.float()).sum(-1)
    bk = dict(q_offset=kw["q_offset"], kv_offset=kw["kv_offset"],
              bound=kw["seq_kv_bound"])
    dq = SB.launch_dq(q, k, v, do, lse, delta, band, pat, scale, **bk)
    dk, dv = SB.launch_dkv(q, k, v, do, lse, delta, band, pat, scale, **bk)
    pq, pk, pv = SB.swat_attention_bwd_plain(q, k, v, o, lse, do, band, pat,
                                             scale, **kw)
    f_ms = time_ms(torch, fwd)
    fp_ms = time_ms(torch, lambda: SA.banded_plain(
        q, k, v, band, pat, scale, return_lse=True, **kw), 5)
    dq_ms = time_ms(torch, lambda: SB.launch_dq(q, k, v, do, lse, delta,
                                                band, pat, scale, **bk))
    dkv_ms = time_ms(torch, lambda: SB.launch_dkv(q, k, v, do, lse, delta,
                                                  band, pat, scale, **bk))
    bp_ms = time_ms(torch, lambda: SB.swat_attention_bwd_plain(
        q, k, v, o, lse, do, band, pat, scale, **kw), 5)
    qr = q.detach().clone().requires_grad_()
    ke = k.repeat_interleave(hq // hkv, dim=1).requires_grad_()
    ve = v.repeat_interleave(hq // hkv, dim=1).requires_grad_()
    sdpa = lambda: F.scaled_dot_product_attention(qr, ke, ve, attn_mask=vis)
    with torch.no_grad():
        sf_ms = time_ms(torch, sdpa)
    sb_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa(), (qr, ke, ve), do)) - sf_ms
    n_vis = int(vis.sum()) * b * hq
    rows_q, rows_kv = b * hq * lp, b * hkv * k.shape[2]
    return {
        "fwd": (f_ms, fp_ms, sf_ms,
                2 * d * (2 * rows_q + 2 * rows_kv) + 4 * rows_q,
                4 * d * n_vis, max_err(o, po)),
        "dq": (dq_ms, bp_ms, sb_ms,
               2 * d * (3 * rows_q + 2 * rows_kv) + 4 * 2 * rows_q,
               6 * d * n_vis, max_err(dq, pq)),
        "dkv": (dkv_ms, bp_ms, sb_ms,
                2 * d * (2 * rows_q + 4 * rows_kv) + 4 * 2 * rows_q,
                8 * d * n_vis, max(max_err(dk, pk), max_err(dv, pv)))}


def _kernel_counts():
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_backward as SB
    return {"swat_attention_fwd": SA.LAUNCHES.n,
            "swat_attention_dq": SB.DQ_LAUNCHES.n,
            "swat_attention_dkv": SB.DKV_LAUNCHES.n,
            "swat_attention_dkv_combine": SB.COMBINE_LAUNCHES.n}


def _counted(torch, fn):
    """fn() with every attention kernel's counter zeroed just before and
    read just after; returns (result, counts, host ms)."""
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_backward as SB
    for c in (SA.LAUNCHES, SB.DQ_LAUNCHES, SB.DKV_LAUNCHES,
              SB.COMBINE_LAUNCHES):
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, _kernel_counts(), (time.perf_counter() - t0) * 1e3


def cp_train(torch, cfg, params):
    """(b): one loss and gradient of the whole model (phase 8's params, all
    16 layers) on B=2 x 8192 tokens with every attention layer
    context-parallel over 4 shards of a single-process mesh, against the
    same step without CP; phase 9's gates; kernels #2, #4 and #5 launch
    layers x shards times (#2 twice: remat)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import LocalMesh
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=CP_TRAIN["seq"],
                                  global_batch=CP_TRAIN["b"], seed=1234))
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in data.global_batch(0).items()}
    n = CP_TRAIN["shards"]
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    # the step without CP runs first, so its time includes this shape's
    # first allocations; CP then runs twice, the second run counted and
    # timed
    plain, plain_counts, plain_ms = _counted(
        torch, lambda: _loss_grads(torch, params, cfg, batch, None))
    ops.set_context_parallel(LocalMesh((n,), ("model",)), "model")
    try:
        _, _, first_ms = _counted(
            torch, lambda: _loss_grads(torch, params, cfg, batch, None))
        before = route_counts()
        cp, counts, cp_ms = _counted(
            torch, lambda: _loss_grads(torch, params, cfg, batch, None))
    finally:
        ops.set_context_parallel(None)
    layers = attn_layers(cfg)
    need = {"swat_attention_fwd": 2 * layers * n,
            "swat_attention_dq": layers * n,
            "swat_attention_dkv": layers * n,
            "swat_attention_dkv_combine": 0}
    if counts != need:
        raise AssertionError(f"cp train launches {counts}, expected {need}")
    check_route("cp train", before, "fwd", "tc", n=need["swat_attention_fwd"])
    check_route("cp train", before, "dq", "tc", n=layers * n)
    check_route("cp train", before, "dkv", "tc", n=layers * n)
    out = {"b": CP_TRAIN["b"], "seq": CP_TRAIN["seq"], "shards": n,
           "layers": cfg.num_layers, **_grad_gap(params, cp, plain),
           "launches": counts, "launches_without_cp": plain_counts,
           "loss_grad_ms": cp_ms, "loss_grad_ms_first_cp_run": first_ms,
           "loss_grad_ms_without_cp_first_at_shape": plain_ms,
           "alloc_retries": torch.cuda.memory_stats().get(
               "num_alloc_retries", 0) - retries,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss_bound": TRAIN_LOSS_BOUND, "grad_bound": TRAIN_GRAD_BOUND}
    del cp, plain
    log("cp train (B=2, L=8192 over 4 shards) vs no CP: " + json.dumps(out))
    if not (out["loss_diff"] <= TRAIN_LOSS_BOUND
            and out["max_leaf_rel_grad_err"] <= TRAIN_GRAD_BOUND):
        raise AssertionError(f"cp train step vs the step without CP: {out}")
    return out, batch


def pp_train(torch, cfg, params, batch):
    """(c): the GPipe loss and gradient (4 stages of 4 layers, 4
    microbatches of phase 8's batch) on a single-process mesh against the
    plain step on the whole batch; phase 9's gates; each attention kernel
    launched m times the plain step's count (one microbatch a pass)."""
    from repro_torch.distributed import pipeline as PPL
    from repro_torch.launch.mesh import LocalMesh
    pcfg = PPL.PipelineConfig(PP["stages"], PP["microbatches"])
    loss = PPL.make_pipeline_loss(cfg, pcfg, LocalMesh((PP["stages"],),
                                                       ("pipe",)))
    leaves_fn = lambda: _pp_loss_grads(torch, params, loss, batch)
    pp, counts, pp_ms = _counted(torch, leaves_fn)
    plain, plain_counts, plain_ms = _counted(
        torch, lambda: _loss_grads(torch, params, cfg, batch, None))
    need = {k: v * PP["microbatches"] for k, v in plain_counts.items()}
    if counts != need:
        raise AssertionError(f"pipeline launches {counts}, expected {need}")
    out = {"stages": PP["stages"], "microbatches": PP["microbatches"],
           "layers_per_stage": cfg.num_layers // PP["stages"],
           "bubble_fraction": PPL.bubble_fraction(pcfg),
           **_grad_gap(params, pp, plain), "launches": counts,
           "launches_plain": plain_counts, "loss_grad_ms": pp_ms,
           "loss_grad_ms_plain": plain_ms, "loss_bound": TRAIN_LOSS_BOUND,
           "grad_bound": TRAIN_GRAD_BOUND}
    log("pipeline train vs plain step: " + json.dumps(out))
    if not (out["loss_diff"] <= TRAIN_LOSS_BOUND
            and out["max_leaf_rel_grad_err"] <= TRAIN_GRAD_BOUND):
        raise AssertionError(f"pipeline step vs the plain step: {out}")
    return out


def embed_grad_sums(torch, params, cfg, batch):
    """The plain step's gradient at the embedding output, summed into the
    table's rows three ways: the indexing's backward and F.embedding's on
    the bf16 table, and an fp32 index_add (the reference). Returns each
    one's relative error (norm over the touched rows) and norm. The model's
    lookup, F.embedding, must read below EMBED_GRAD_LIMIT."""
    import torch.nn.functional as F
    from repro_torch.core import model as Mod
    emb, tok = params["embed"], batch["tokens"].long()
    x0 = emb[tok].detach().requires_grad_()
    total, _ = Mod.loss_fn(params, cfg, {"embeddings": x0,
                                         "labels": batch["labels"]})
    (dx,) = torch.autograd.grad(total, x0)
    rows = torch.unique(tok)
    ref = torch.zeros(emb.shape, device="cuda").index_add_(
        0, tok.reshape(-1), dx.float().reshape(-1, emb.shape[1]))[rows]
    out = {"reference_norm": float(ref.norm())}
    for name, fn in (("index", lambda e: e[tok]),
                     ("F.embedding", lambda e: F.embedding(tok, e))):
        e = emb.detach().requires_grad_()
        (g,) = torch.autograd.grad(fn(e), e, dx)
        g = g[rows].float()
        out[name] = {"norm": float(g.norm()),
                     "rel_err": float((g - ref).norm() / ref.norm())}
    log("embedding gradient sums (bf16 table, phase 8's batch): "
        + json.dumps(out))
    if not out["F.embedding"]["rel_err"] <= EMBED_GRAD_LIMIT:
        raise AssertionError(f"F.embedding's table gradient: {out}")
    return out


def _pp_loss_grads(torch, params, loss, batch):
    from repro_torch import tree
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        total, m = loss(params, batch)
        grads = torch.autograd.grad(total, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return float(m["loss"].detach()), float(m["aux_loss"].detach()), grads


def process_mesh_cp(torch):
    """(d): a one-rank NCCL process group and its DeviceMesh on the card;
    one CP op (and its gradients) through the process mesh, bitwise equal
    to the same op on a single-process mesh of the same shape. With one
    rank the shift has no neighbour and sends nothing: the psum and pmax
    reach NCCL as all_reduce calls on the one-rank group, and the run fails
    unless some did."""
    import dataclasses
    import datetime
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import get_config, with_swat
    from repro_torch.distributed import context_parallel as CP
    from repro_torch.launch import mesh as ML
    spec = with_swat(get_config("llama3.2-1b")).attention
    spec = dataclasses.replace(spec, causal=True)
    gen = torch.Generator(device="cuda").manual_seed(30)
    mk = lambda *s: torch.randn(*s, generator=gen,
                                device="cuda").to(torch.bfloat16)
    seq = 4096
    ins = [mk(1, MAIN["hq"], seq, MAIN["d"]), mk(1, MAIN["hkv"], seq,
                                                 MAIN["d"]),
           mk(1, MAIN["hkv"], seq, MAIN["d"])]
    t = mk(1, MAIN["hq"], seq, MAIN["d"])

    def run(mesh):
        q, k, v = (x.detach().clone().requires_grad_() for x in ins)
        o = CP.swat_attention_context_parallel(q, k, v, spec, mesh=mesh,
                                               axis="model")
        (o.float() * t.float()).sum().backward()
        return [o.detach(), q.grad, k.grad, v.grad]

    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=120))
    try:
        pm = ML.make_debug_mesh(1, 1, process=True, device_type="cuda")
        got = run(pm)
        backend = dist.get_backend(pm.device_mesh.get_group("model"))
    finally:
        dist.destroy_process_group()
    want = run(ML.make_debug_mesh(1, 1))
    out = {"mesh": repr(pm), "backend": backend, "collectives": pm.calls,
           "bitwise": all(torch.equal(a, b) for a, b in zip(got, want))}
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        out[f"{name}_err"] = check_close(f"process mesh cp {name}", a, b,
                                         "bfloat16")
    log("process mesh cp (one-rank NCCL group): " + json.dumps(out))
    if not out["bitwise"] or not pm.calls["all_reduce"]:
        raise AssertionError(f"process mesh cp vs single-process mesh: {out}")
    return out


def context_pipeline(torch, cfg, state, card):
    """Phase 27: (a) CP forward at full width, (b) a CP train step of the
    whole model, (c) a GPipe train step, (d) the process mesh on NCCL; then
    one AdamW step each through CP and the pipeline on phase 8's params
    and optimizer state (losses finite)."""
    import math
    from repro_torch.distributed import pipeline as PPL
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import LocalMesh
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    params, opt, step_fn, batch = state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = {"forward": cp_forward(torch)}
    res["train"], cp_batch = cp_train(torch, cfg, params)
    res["pipeline"] = pp_train(torch, cfg, params, batch)
    res["embed_grad"] = embed_grad_sums(torch, params, cfg, batch)
    res["process_mesh"] = process_mesh_cp(torch)
    res["band_times"] = time_cp_band(torch, cfg.attention, CP_TRAIN["b"],
                                     CP_TRAIN["seq"] // CP_TRAIN["shards"],
                                     CP_TRAIN["shards"])
    steps = {}
    ops.set_context_parallel(LocalMesh((CP_TRAIN["shards"],), ("model",)),
                             "model")
    try:
        _, _, m = step_fn(params, opt, cp_batch)
        steps["cp_adamw_loss"] = float(m["loss"])
    finally:
        ops.set_context_parallel(None)
    pcfg = PPL.PipelineConfig(PP["stages"], PP["microbatches"])
    pp_step = PPL.make_pp_train_step(
        cfg, adamw.AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                               total_steps=TRAIN["steps"]), pcfg,
        LocalMesh((PP["stages"],), ("pipe",)))
    _, _, m = pp_step(params, opt, batch)
    steps["pp_adamw_loss"] = float(m["loss"])
    if not all(math.isfinite(x) for x in steps.values()):
        raise AssertionError(f"phase 27 AdamW steps: {steps}")
    res["adamw_steps"] = steps
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 27 ({card}): " + json.dumps(
        {k: res[k] for k in ("adamw_steps", "phase_s")}))
    return res


# ------------------------------------------------------------ phase 28 ---

# phase 28's meshes: slot-parallel, and TP at two widths (per shard 16 q / 4
# kv heads and d_ff 4096 at 2x2, 8 q / 2 kv and 2048 at 1x4)
MESH_TP = ("2x2", "1x4")


def _mesh_run(torch, eng, prompts, where):
    """Phase 3's requests through `eng` once: tokens, the launch counts of
    this run (zeroed just before, read just after), the run's decode steps,
    prefill batches and decode ms a step. Every request meets its budget
    and no engine steps down."""
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_decode as SD
    from repro_torch.serving.engine import Request
    st = eng.stats
    s0, b0, d0 = st["decode_steps"], st["prefill_batches"], st["decode_s"]
    torch.cuda.synchronize()
    SD.LAUNCHES.reset()
    SD.PLAIN_LAUNCHES.reset()
    SA.LAUNCHES.reset()
    before = route_counts()
    res = eng.run([Request(rid=i, prompt=p, max_new_tokens=MAIN["new_tokens"])
                   for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    launches = {"swat_decode": SD.LAUNCHES.n,
                "swat_decode_plain": SD.PLAIN_LAUNCHES.n,
                "swat_attention_fwd": SA.LAUNCHES.n}
    check_route(where, before, "fwd", "tc", n=SA.LAUNCHES.n)
    no_step_down(eng, where)
    for r in res:
        if r.status != "ok" or len(r.tokens) != MAIN["new_tokens"]:
            raise AssertionError(f"{where} request {r.rid}: {r.status}, "
                                 f"{len(r.tokens)} tokens")
    steps = st["decode_steps"] - s0
    return {"tokens": [r.tokens for r in res], "launches": launches,
            "decode_steps": steps,
            "prefill_batches": st["prefill_batches"] - b0,
            "decode_ms_per_step": (st["decode_s"] - d0) * 1e3 / steps}


def _mesh_launch_gate(run, layers, shards, where):
    """Kernel #1 once per layer, shard and decode step, no plain decode
    launch; kernel #2's band and global-row passes once per layer and shard
    a prefill batch."""
    want = {"swat_decode": layers * shards * run["decode_steps"],
            "swat_decode_plain": 0,
            "swat_attention_fwd": 2 * layers * shards
            * run["prefill_batches"]}
    if run["launches"] != want:
        raise AssertionError(f"{where} launches {run['launches']}, expected "
                             f"{want} ({shards} shards)")


def _first_logits(torch, eng, prompts):
    """The engine's prefill logits of four prompts as one batch, and its
    first decode step's logits after admitting them."""
    import collections
    from repro_torch.serving.engine import Request
    tok = torch.as_tensor(__import__("numpy").stack(prompts[:4]),
                          device="cuda")
    lens = torch.full((4,), MAIN["prompt"], dtype=torch.int32, device="cuda")
    pre = eng.prefill_logits(tok, lens)[0].clone()
    eng._admit(collections.deque(
        Request(rid=i, prompt=p, max_new_tokens=MAIN["new_tokens"])
        for i, p in enumerate(prompts[:4])))
    eng._stage()
    step = eng._model_step(eng._dev["tok"][:, None])[:, 0]
    return torch.cat([pre, step])


def serve_mesh(torch, cfg, tokens, card):
    """Phase 28: serving on a mesh, on phase 3's cell (llama3.2-1b + SWAT,
    bf16, params from seed 0, 8 requests, 4 slots, graphs). (a) a 4x1
    slot-parallel LocalMesh: tokens bitwise phase 3's single-device tokens,
    kernel #1 16 layers x 4 shards a decode step; (b) 2x2 and 1x4 TP: the
    shards' head and d_ff widths, prefill and first-step logits against the
    single-device engine's within LOGIT_BOUND with greedy agreement at
    least AGREE_BOUND, every budget exact, two runs bitwise, #1 and #2 per
    shard; (c) the paged layout on the 4x1 mesh's slot-local pool: tokens
    bitwise (a)'s; (d) a one-rank NCCL ProcessMesh (1x1): tokens bitwise
    phase 3's, the plan's psums (all_reduce) and logit gathers (all_gather)
    issued to NCCL on the one-rank groups, inside the captured decode
    graphs (none crosses a wire: the mesh has one rank). Decode ms a step
    of each beside the single-device engine's (graphs, second runs)."""
    import datetime
    import tempfile
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core import model as Mod
    from repro_torch.launch import mesh as ML
    from repro_torch.serving.engine import ServingEngine
    t0 = time.perf_counter()
    params = Mod.init_model(cfg, seed=0, device="cuda")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (MAIN["prompt"],))
               .astype(np.int32) for _ in range(8)]
    layers = cfg.num_layers

    def engine(mesh=None, **kw):
        return ServingEngine(cfg, params, batch_slots=MAIN["b"],
                             max_len=MAIN["max_len"], scan_steps=8,
                             mesh=mesh, **kw)

    out = {}
    base = engine()
    _mesh_run(torch, base, prompts, "phase 28 single-device")
    single = _mesh_run(torch, base, prompts, "phase 28 single-device")
    if single["tokens"] != tokens:
        raise AssertionError("phase 28: the single-device engine's tokens "
                             "differ from phase 3's")
    out["single_device_decode_ms_per_step"] = single["decode_ms_per_step"]
    base_logits = _first_logits(torch, engine(), prompts)
    del base

    # (a) slot-parallel, and (c) its paged twin
    for key, kw in (("4x1", {}), ("4x1_paged", {"kv_layout": "paged"})):
        eng = engine(ML.LocalMesh((4, 1), ("data", "model")), **kw)
        runs = [_mesh_run(torch, eng, prompts, f"phase 28 {key}")
                for _ in range(2)]
        for r in runs:
            _mesh_launch_gate(r, layers, 4, f"phase 28 {key}")
        want = tokens if key == "4x1" else out["4x1"]["tokens"]
        bitwise = [r["tokens"] == want for r in runs]
        out[key] = {"tokens": runs[1]["tokens"], "bitwise": bitwise,
                    "launches": runs[1]["launches"],
                    "decode_steps": runs[1]["decode_steps"],
                    "decode_ms_per_step": runs[1]["decode_ms_per_step"],
                    "slot_quantum": eng.scheduler.slot_quantum,
                    "graphs_captured": len(eng._compiled.captured),
                    "replays": eng._compiled.replays}
        del eng
        if not all(bitwise):
            raise AssertionError(f"phase 28 {key}: tokens not bitwise "
                                 f"{'phase 3' if key == '4x1' else '4x1'}'s "
                                 f"({bitwise})")

    # (b) tensor parallelism
    for key in MESH_TP:
        dm, mm = (int(x) for x in key.split("x"))
        mesh = ML.LocalMesh((dm, mm), ("data", "model"))
        lg = _first_logits(torch, engine(mesh), prompts)
        err = max_err(lg, base_logits)
        agree = float((lg.argmax(-1) == base_logits.argmax(-1)).float()
                      .mean())
        eng = engine(mesh)
        shard = eng.shard_params[-1]["blocks"][0]["l0"]
        widths = {"q_heads": shard["mixer"]["wq"].shape[1] // MAIN["d"],
                  "kv_heads": eng.shard_caches[-1][0]["l0"]["k"].shape[1],
                  "d_ff": shard["mlp"]["w1"].shape[1],
                  "vocab": eng.shard_params[-1]["embed"].shape[0]}
        want_w = {"q_heads": MAIN["hq"] // mm, "kv_heads": MAIN["hkv"] // mm,
                  "d_ff": cfg.d_ff // mm, "vocab": cfg.vocab_size // mm}
        runs = [_mesh_run(torch, eng, prompts, f"phase 28 {key}")
                for _ in range(2)]
        for r in runs:
            _mesh_launch_gate(r, layers, dm * mm, f"phase 28 {key}")
        out[key] = {"max_abs_logit_err": err, "greedy_agreement": agree,
                    "shard_widths": widths,
                    "plan": {k: v for k, v in eng._mp.describe().items()
                             if k != "slot_axes"},
                    "two_runs_bitwise": runs[0]["tokens"] == runs[1]["tokens"],
                    "agreement_with_single_device": float(np.mean(
                        np.asarray(runs[1]["tokens"]) == np.asarray(tokens))),
                    "launches": runs[1]["launches"],
                    "decode_ms_per_step": runs[1]["decode_ms_per_step"]}
        del eng
        if widths != want_w or not all(
                out[key]["plan"]["attention_tp"].values()):
            raise AssertionError(f"phase 28 {key}: shard widths {widths} "
                                 f"(expected {want_w}), plan "
                                 f"{out[key]['plan']}")
        if err > LOGIT_BOUND or agree < AGREE_BOUND:
            raise AssertionError(f"phase 28 {key}: logits vs single-device "
                                 f"max |d| {err} (limit {LOGIT_BOUND}), "
                                 f"greedy agreement {agree} (limit "
                                 f"{AGREE_BOUND})")
        if not out[key]["two_runs_bitwise"]:
            raise AssertionError(f"phase 28 {key}: two runs differ")

    # (d) a one-rank NCCL process mesh
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg28_")
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=120))
    try:
        pm = ML.parse_mesh("1x1", process=True, device_type="cuda")
        eng = engine(pm)
        runs = [_mesh_run(torch, eng, prompts, "phase 28 1x1 process")
                for _ in range(2)]
        backend = dist.get_backend(pm.device_mesh.get_group("model"))
        del eng
    finally:
        dist.destroy_process_group()
    for r in runs:
        _mesh_launch_gate(r, layers, 1, "phase 28 1x1 process")
    out["1x1_process"] = {
        "backend": backend, "collectives": pm.calls,
        "wire_collectives": pm.wire_ops,
        "bitwise": [r["tokens"] == tokens for r in runs],
        "decode_ms_per_step": runs[1]["decode_ms_per_step"]}
    if (not all(out["1x1_process"]["bitwise"]) or pm.wire_ops
            or not pm.calls["all_reduce"] or not pm.calls["all_gather"]):
        raise AssertionError(f"phase 28 1x1 process mesh: "
                             f"{out['1x1_process']}")
    for key in ("4x1", "4x1_paged"):
        out[key].pop("tokens")
    out["decode_ms_per_step"] = {
        k: out[k]["decode_ms_per_step"] for k in
        ("4x1", "4x1_paged") + MESH_TP + ("1x1_process",)}
    out["decode_ms_per_step"]["single_device"] = single["decode_ms_per_step"]
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 28 decode ms a step ({card}): "
        + json.dumps(out["decode_ms_per_step"]))
    return out


# ------------------------------------------------------------ phase 29 ---

# phase 29's meshes: (a) 2x2 tp + SP on phase 8's state; (b) granite-moe at
# full width cut to 4 layers, fp32 (the random experts amplify bf16
# rounding into routing flips, as in phase 24's gradient gate), on 1x4
# and 2x2 with the sort and the ep dispatch; (c) a one-rank NCCL
# ProcessMesh on llama cut to 4 layers (phase 9's shape)
MESH_TRAIN = dict(shape=(2, 2), elastic=(4, 1), layers=4, elastic_layers=2)
# (a) and (d)'s optimizer: phase 8's, two steps further on
MESH_OPT = dict(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                total_steps=TRAIN["steps"] + 2)


def _mesh_plan_step(torch, cfg, mesh, opt_cfg, **kw):
    """A mesh train step with the tp profile and sequence parallelism."""
    from repro_torch.distributed import sharding as Sh
    from repro_torch.launch import steps as St
    return St.make_train_step(cfg, opt_cfg, act_sharding=Sh.NamedSharding(
        mesh, Sh.activation_spec(mesh, sequence_parallel=True)), **kw)


def _mesh_loss_grads(torch, plan, cfg, placed, batch):
    """(loss, aux_loss, the global gradient of every leaf) of one mesh loss
    and backward (`model.loss_fn(plan=)`), leaves in `tree` order."""
    from repro_torch import tree
    from repro_torch.launch import steps as St
    leaves = St.unique_leaves(placed)
    for p in leaves:
        p.requires_grad_(True)
    try:
        total, m = plan.train_loss(placed, cfg, batch)
        grads = torch.autograd.grad(total, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    by_id = {id(x): g for x, g in zip(leaves, grads)}
    full = plan.gather_tree([tree.tree_map(lambda x: by_id[id(x)], t)
                        for t in placed])
    return (float(m["loss"]), float(m["aux_loss"]), tree.leaves(full))


def _leaf_gap(a, b):
    """The largest relative (norm) error over the leaves of a against b."""
    return max(float((x.float() - y.float()).norm()
                     / y.float().norm().clamp(min=1e-30))
               for x, y in zip(a, b))


def _fingerprint(torch, tree_):
    """Per leaf, two exact integer sums of its raw bits (bitwise equality
    of two trees without keeping both)."""
    from repro_torch import tree
    out = []
    for x in tree.leaves(tree_):
        v = x.contiguous().view(
            {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}[x.element_size()]).reshape(-1).long()
        w = torch.arange(v.numel(), device=v.device) % 65521 + 1
        out.append((int(v.sum()), int((v * w).sum())))
    return out


def _within(out, loss_bound=TRAIN_LOSS_BOUND, grad_bound=TRAIN_GRAD_BOUND):
    return (out["loss_diff"] <= loss_bound
            and out["max_leaf_rel_grad_err"] <= grad_bound)


def _gates(out, where, **bounds):
    if not _within(out, **bounds):
        raise AssertionError(f"{where}: {out}")


def mesh_train_llama(torch, cfg, params, opt, batch, phase8_ms):
    """(a): one train step of the whole model (phase 8's state and batch)
    on a 2x2 LocalMesh, tp + SP, against the plain single-device kernel
    step on the same state: loss and every gradient leaf within phase 9's
    gates, each shard launching #2 / #4 / #5 what the single-device step
    launches; then one AdamW step each, params and first moments within
    the gates. Returns (summary, the 2x2 step, its placed state)."""
    from repro_torch import tree
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import LocalMesh
    from repro_torch.optim import adamw
    opt_cfg = adamw.AdamWConfig(**MESH_OPT)
    mesh = LocalMesh(MESH_TRAIN["shape"], ("data", "model"))
    step = _mesh_plan_step(torch, cfg, mesh, opt_cfg)
    plan = step.plan
    plain, plain_counts, plain_ms = _counted(
        torch, lambda: _loss_grads(torch, params, cfg, batch, None))
    t0 = time.perf_counter()
    placed = plan.place({"params": params, "opt": opt})
    torch.cuda.synchronize()
    place_ms = (time.perf_counter() - t0) * 1e3
    shards = mesh.size
    before = route_counts()
    got, counts, mesh_ms = _counted(torch, lambda: _mesh_loss_grads(
        torch, plan, cfg, [s["params"] for s in placed], batch))
    need = {k: v * shards for k, v in plain_counts.items()}
    if counts != need:
        raise AssertionError(f"mesh train launches {counts}, expected "
                             f"{need} ({shards} shards x the plain step)")
    for k in ("fwd", "dq", "dkv"):
        check_route("mesh train", before, k, "tc",
                    n=counts[f"swat_attention_{k}"])
    out = {"mesh": "x".join(map(str, MESH_TRAIN["shape"])),
           "plan": plan.describe(), **_grad_gap(params, got, plain),
           "launches": counts, "launches_plain": plain_counts,
           "launches_per_shard": {k: v // shards for k, v in counts.items()},
           "loss_grad_ms": mesh_ms, "loss_grad_ms_plain": plain_ms,
           "place_ms": place_ms}
    del got, plain
    _gates(out, "mesh train step vs the plain step")
    # one AdamW step each from the same state: the mesh's on its copies
    ps, opts = [s["params"] for s in placed], [s["opt"] for s in placed]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps, opts, m = step(ps, opts, batch)
    loss = float(m["loss"])
    out["adamw_step_ms"] = (time.perf_counter() - t0) * 1e3
    out["phase8_step_ms_after_step_1"] = phase8_ms
    for s, p, o in zip(placed, ps, opts):
        s["params"], s["opt"] = p, o
    _, opt1, m1 = St.make_train_step(cfg, opt_cfg)(params, opt, batch)
    glob = plan.gather_tree(ps)
    out["adamw_loss"], out["adamw_loss_plain"] = loss, float(m1["loss"])
    out["adamw_param_rel_err"] = _leaf_gap(tree.leaves(glob),
                                           tree.leaves(params))
    del glob
    mu = plan.gather_tree([o.mu for o in opts])
    out["adamw_mu_rel_err"] = _leaf_gap(tree.leaves(mu),
                                        tree.leaves(opt1.mu))
    del mu
    out["grad_norm"], out["grad_norm_plain"] = (float(m["grad_norm"]),
                                                float(m1["grad_norm"]))
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if not (abs(loss - out["adamw_loss_plain"]) <= TRAIN_LOSS_BOUND
            and out["adamw_param_rel_err"] <= TRAIN_GRAD_BOUND
            and out["adamw_mu_rel_err"] <= TRAIN_GRAD_BOUND):
        raise AssertionError(f"mesh AdamW step vs the plain step: {out}")
    return out, step, placed


def mesh_elastic(torch, cfg, step, placed, batches):
    """(d): the 2x2 state after (a)'s step, cut to its first
    MESH_TRAIN["elastic_layers"] layers at full width (the whole state's
    12.4 GB took 21 s to save and 71 s to restore twice on the H100
    machine's host: PERF.md), saved (the gathered global leaves),
    restored onto one device and onto a 4x1 mesh, every leaf bitwise the
    saved one; a step on the restored 4x1 state against the 2x2 state's
    second step on the same batch, within phase 9's gates."""
    import shutil
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        return _mesh_elastic(torch, cfg, step, placed, batches,
                             CheckpointManager(root, keep=1))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _cut_state(state, n):
    """A train state (params and AdamW state) cut to its first n
    super-blocks."""
    from repro_torch.optim import adamw
    cut = lambda t: {**t, "blocks": t["blocks"][:n]}
    o = state["opt"]
    return {"params": cut(state["params"]),
            "opt": adamw.OptState(o.step, cut(o.mu), cut(o.nu))}


def _mesh_elastic(torch, cfg, step, placed, batches, ckpt):
    import dataclasses
    from repro_torch import tree
    from repro_torch.launch.mesh import LocalMesh
    from repro_torch.optim import adamw
    # (a)'s state cut in depth: the checkpoint's bytes are its time
    n = MESH_TRAIN["elastic_layers"]
    cfg = dataclasses.replace(cfg, num_layers=n)
    placed[:] = [_cut_state(st, n) for st in placed]
    step = _mesh_plan_step(torch, cfg, step.plan.mesh,
                           adamw.AdamWConfig(**MESH_OPT))
    plan = step.plan
    t0 = time.perf_counter()
    glob = plan.gather_tree(placed)
    saved = _fingerprint(torch, glob)
    like = tree.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                               device="meta"), glob)
    ckpt.save(1, glob, blocking=True)
    del glob
    save_s = time.perf_counter() - t0
    ps, opts = [s["params"] for s in placed], [s["opt"] for s in placed]
    ps, opts, m2 = step(ps, opts, batches[1])
    want_p = tree.leaves(plan.gather_tree(ps))
    want_mu = tree.leaves(plan.gather_tree([o.mu for o in opts]))
    placed.clear()
    del ps, opts
    t0 = time.perf_counter()
    one = ckpt.restore(1, like=like, device="cuda")
    one_ok = _fingerprint(torch, one) == saved
    del one
    mesh4 = LocalMesh(MESH_TRAIN["elastic"], ("data", "model"))
    step4 = _mesh_plan_step(torch, cfg, mesh4, adamw.AdamWConfig(**MESH_OPT))
    placed4 = ckpt.restore(1, like=like, device="cuda",
                           sharding=step4.plan.placement())
    restore_s = time.perf_counter() - t0
    glob4 = step4.plan.gather_tree(placed4)
    mesh_ok = _fingerprint(torch, glob4) == saved
    del glob4
    ps4, opts4 = [s["params"] for s in placed4], [s["opt"] for s in placed4]
    ps4, opts4, m4 = step4(ps4, opts4, batches[1])
    out = {"layers": n, "state_gb": sum(
        x.numel() * x.element_size() for x in tree.leaves(like)) / 1e9,
        "restored_onto": ["one device", "x".join(map(
            str, MESH_TRAIN["elastic"]))], "one_device_bitwise": one_ok,
        "mesh_4x1_bitwise": mesh_ok, "save_s": save_s,
        "restore_s": restore_s, "step2_loss_2x2": float(m2["loss"]),
        "step2_loss_4x1": float(m4["loss"]),
        "loss_diff": abs(float(m2["loss"]) - float(m4["loss"])),
        "grad_norm_2x2": float(m2["grad_norm"]),
        "grad_norm_4x1": float(m4["grad_norm"]),
        "param_rel_err": _leaf_gap(tree.leaves(step4.plan.gather_tree(ps4)),
                                   want_p),
        "mu_rel_err": _leaf_gap(tree.leaves(step4.plan.gather_tree(
            [o.mu for o in opts4])), want_mu)}
    out["max_leaf_rel_grad_err"] = max(out["param_rel_err"],
                                       out["mu_rel_err"])
    if not (one_ok and mesh_ok):
        raise AssertionError(f"elastic restore: leaves differ: {out}")
    _gates(out, "resumed 4x1 step vs the 2x2 step")
    return out


def mesh_train_moe(torch):
    """(b): granite-moe-1b-a400m + SWAT at full width, 4 layers, fp32, on
    a 1x4 and a 2x2 LocalMesh (phase 8's batch, whose skewed tokens make
    capacity drop slots; the 2x2 mesh ranks them over its 'data' rows): the sort dispatch against the
    plain single-device step (global capacity: the same slots drop), and
    the ep dispatch (`set_expert_parallel`) against the single-device
    model whose MoE layers run the same expert-parallel function on the
    same mesh; loss, aux loss and every gradient leaf within
    MESH_LOSS_BOUND / MESH_GRAD_BOUND; the all-to-alls counted and their
    bytes beside `ep_wire_bytes_per_device`. The control, the 2x2 sort
    dispatch with each shard ranking its own slots, must leave the
    bounds."""
    import dataclasses
    from repro_torch.core import model as Mod
    from repro_torch.core import moe as M
    from repro_torch.core import moe_ep as EP
    from repro_torch.launch.mesh import LocalMesh
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(granite_cfg("float32"),
                              num_layers=MESH_TRAIN["layers"])
    params = Mod.init_model(cfg, seed=0, device="cuda")
    batch = _train_batches(torch, cfg, 1)[0]
    out = {"layers": cfg.num_layers, "dtype": "float32",
           "loss_bound": MESH_LOSS_BOUND, "grad_bound": MESH_GRAD_BOUND}
    sent = {"calls": 0, "token_bytes": 0, "dropped": 0}
    ranks = M.group_ranks

    def dropping(ids, cap, n):
        r, keep = ranks(ids, cap, n)
        if n == sent["buckets"]:
            sent["dropped"] += int((~keep).sum())
        return r, keep

    def cell(shape, dispatch, b, control=False):
        mesh = LocalMesh(shape, ("data", "model"))
        a2a = mesh.all_to_all

        def counting(xs, axis, split_dim, concat_dim):
            sent["calls"] += 1
            if xs[0].dim() == 3:                # the (n, cap, D) buffers
                sent["token_bytes"] += sum(x.numel() * x.element_size()
                                           for x in xs)
            return a2a(xs, axis, split_dim, concat_dim)

        mesh.all_to_all = counting
        dcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch))
        plan = _mesh_plan_step(torch, dcfg, mesh, adamw.AdamWConfig()).plan
        placed = plan.place(params)
        if dispatch == "ep":
            M.set_expert_parallel(mesh)
        slot_ranks = EP.slot_ranks
        if control:                             # each shard on its own
            EP.slot_ranks = lambda m, ids, cap, n, *a, **k: slot_ranks(
                m, ids, cap, n)
        try:
            plain, _, plain_ms = _counted(
                torch, lambda: _loss_grads(torch, params, dcfg, b, None))
            sent.update(calls=0, token_bytes=0, dropped=0,
                        buckets=plan.m if dispatch == "ep" else cfg.moe
                        .num_experts)
            M.group_ranks = dropping
            got, counts, ms = _counted(torch, lambda: _mesh_loss_grads(
                torch, plan, dcfg, placed, b))
        finally:
            M.set_expert_parallel(None)
            M.group_ranks, EP.slot_ranks = ranks, slot_ranks
        res = {**_grad_gap(params, got, plain), "loss_grad_ms": ms,
               "loss_grad_ms_plain": plain_ms, "launches": counts,
               "slots_dropped": sent["dropped"]}
        if dispatch == "ep":
            t_local = (b["tokens"].numel() // mesh.size)
            res.update(
                all_to_all_calls=sent["calls"],
                all_to_all_calls_expected=3 * cfg.num_layers * 2,
                # tokens there and back a layer, two forward passes (remat)
                exchanged_bytes_per_shard_layer=sent["token_bytes"]
                // (2 * cfg.num_layers * mesh.size),
                ep_wire_bytes_per_device=EP.ep_wire_bytes_per_device(
                    t_local, cfg.moe.top_k, cfg.d_model, bytes_per_el=4))
            if sent["calls"] != res["all_to_all_calls_expected"]:
                raise AssertionError(f"ep all-to-alls: {res}")
        return res

    for shape in ((1, 4), (2, 2)):
        name = "x".join(map(str, shape))
        for dispatch in ("sort", "ep"):
            res = cell(shape, dispatch, batch)
            out[f"{dispatch} {name}"] = res
            log(f"phase 29 (b) {dispatch} {name}: {json.dumps(res)}")
            where = f"mesh train ({dispatch}, {name}) vs the plain step"
            _gates(res, where, loss_bound=MESH_LOSS_BOUND,
                   grad_bound=MESH_GRAD_BOUND)
            if res["aux_diff"] > MESH_LOSS_BOUND:
                raise AssertionError(f"{where}, aux: {res}")
    if not out["sort 2x2"]["slots_dropped"]:
        raise AssertionError(f"(b): no slot dropped on 2x2: {out}")
    ctl = cell((2, 2), "sort", batch, control=True)
    out["control: sort 2x2 ranked per shard"] = ctl
    log(f"phase 29 (b) control: {json.dumps(ctl)}")
    if _within(ctl, MESH_LOSS_BOUND, MESH_GRAD_BOUND) and (
            ctl["aux_diff"] <= MESH_LOSS_BOUND):
        raise AssertionError(f"(b): the per-shard ranking control stays "
                             f"within the bounds: {ctl}")
    return out


def mesh_train_process(torch, cfg):
    """(c): a one-rank NCCL process group and ProcessMesh (1x1): one train
    loss and gradient of llama at full width, 4 layers, against the plain
    step (bitwise, or within phase 9's gates), then one AdamW step; the
    plan's psums and the gradients' all-reduces issued to NCCL and counted
    (a one-rank axis splits nothing, so nothing is gathered), none over a
    wire."""
    import dataclasses
    import datetime
    import tempfile
    import torch.distributed as dist
    from repro_torch.core import model as Mod
    from repro_torch.launch import mesh as ML
    from repro_torch.optim import adamw
    cfg4 = dataclasses.replace(cfg, num_layers=MESH_TRAIN["layers"])
    params = Mod.init_model(cfg4, seed=0, device="cuda")
    batch = _train_batches(torch, cfg4, 1)[0]
    plain, plain_counts, plain_ms = _counted(
        torch, lambda: _loss_grads(torch, params, cfg4, batch, None))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=120))
    try:
        pm = ML.make_debug_mesh(1, 1, process=True, device_type="cuda")
        step = _mesh_plan_step(torch, cfg4, pm, adamw.AdamWConfig())
        placed = step.plan.place(params)
        got, counts, ms = _counted(torch, lambda: _mesh_loss_grads(
            torch, step.plan, cfg4, placed, batch))
        state = step.plan.place({"params": params,
                                 "opt": adamw.init_opt_state(params)})
        _, _, m = step([state[0]["params"]], [state[0]["opt"]], batch)
        adamw_loss = float(m["loss"])
        backend = dist.get_backend(pm.device_mesh.get_group("model"))
    finally:
        dist.destroy_process_group()
    out = {"mesh": repr(pm), "backend": backend,
           "collectives": dict(pm.calls), "wire_ops": pm.wire_ops,
           "bitwise": (got[0] == plain[0] and all(
               torch.equal(a, b) for a, b in zip(got[2], plain[2]))),
           **_grad_gap(params, got, plain), "launches": counts,
           "launches_plain": plain_counts, "loss_grad_ms": ms,
           "loss_grad_ms_plain": plain_ms, "adamw_loss": adamw_loss}
    if counts != plain_counts:
        raise AssertionError(f"process mesh train launches: {out}")
    if pm.wire_ops or not pm.calls["all_reduce"]:
        raise AssertionError(f"process mesh train collectives: {out}")
    _gates(out, "process mesh train step vs the plain step",
           loss_bound=MESH_LOSS_BOUND, grad_bound=MESH_GRAD_BOUND)
    return out


def train_mesh(torch, cfg, holder, phase8, card):
    """Phase 29: (a) the 2x2 mesh step on phase 8's state, (b) granite-moe
    with sort and ep on 1x4 and 2x2, (c) the one-rank NCCL mesh, (d) the
    elastic restore of (a)'s state. `holder["state"]` is phase 8's state, which
    this phase consumes (its params and moments are updated in place)."""
    t0 = time.perf_counter()
    params, opt, _, batch = holder.pop("state")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steady = sum(phase8["step_ms"][1:]) / (len(phase8["step_ms"]) - 1)
    res = {}
    res["llama_2x2"], step, placed = mesh_train_llama(
        torch, cfg, params, opt, batch, steady)
    del params, opt
    batches = _train_batches(torch, cfg, 2)
    res["elastic"] = mesh_elastic(torch, cfg, step, placed, [batch,
                                                             batches[1]])
    del placed, step
    torch.cuda.empty_cache()
    res["granite"] = mesh_train_moe(torch)
    res["process_1x1"] = mesh_train_process(torch, cfg)
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 29 ({card}): " + json.dumps(
        {"step_ms_2x2": res["llama_2x2"]["adamw_step_ms"],
         "phase8_step_ms": steady, "phase_s": res["phase_s"]}))
    return res


# ------------------------------------------------------------ phase 12 ---

def _plain_cases(torch, gen, dtype):
    """(tag, q, k_cache, v_cache, pos, spec, ring_cap) at phase 12's three
    shapes; random cache rows (the comparison needs no FIFO history)."""
    from repro_torch.core.types import AttentionSpec
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")
    n = WHISPER["frames"]
    ring = AttentionSpec(kind="swat", window=256, num_global=4, causal=True,
                         softcap=30.0)
    ring_cap = 256 + 1 + 3 + 4
    return [
        ("whisper cross", mk(8, 6, 1, 64), mk(8, 6, n, 64), mk(8, 6, n, 64),
         i32([n] * 8), AttentionSpec(kind="dense", causal=False), n),
        ("kernel_bench unpacked", mk(8, 8, 1, 64), mk(8, 2, 512, 64),
         mk(8, 2, 512, 64), i32([512 + 8] * 8),
         AttentionSpec(kind="dense", causal=True), 512),
        ("ring T=4", mk(4, 32, 4, 64), mk(4, 8, 320, 64), mk(4, 8, 320, 64),
         i32([4, 100, 1037, 5000]), ring, ring_cap),
    ]


def check_decode_plain(torch):
    """The plain-mode decode kernel against its plain version, both GQA
    layouts, bf16 and fp32; two launches bitwise equal. Then
    ops.decode_attention on the cross shape, kernel route (positional
    masks from pos = cache_len) against the JAX ref routing (valid-prefix
    mask). Returns the bf16 error at the whisper cross shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_decode as SD
    gen = torch.Generator(device="cuda").manual_seed(7)
    main_err, n = None, 0
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for tag, q, kc, vc, pos, spec, cap in _plain_cases(torch, gen, dtype):
            want = SD.swat_decode_plain_ref(q, kc, vc, pos, spec,
                                            ring_cap=cap)
            for pack in (True, False):
                before = SD.PLAIN_LAUNCHES.n
                got = SD.swat_decode_plain(q, kc, vc, pos, spec,
                                           ring_cap=cap, pack_gqa=pack)
                again = SD.swat_decode_plain(q, kc, vc, pos, spec,
                                             ring_cap=cap, pack_gqa=pack)
                torch.cuda.synchronize()
                name = f"swat_decode_plain {dn} {tag} pack_gqa={pack}"
                launches = SD.PLAIN_LAUNCHES.n - before
                if launches != 2:
                    raise AssertionError(f"{name}: {launches} launches for "
                                         "two calls")
                if not torch.equal(got, again):
                    raise AssertionError(f"{name}: two launches differ")
                err = check_close(name, got, want, dn)
                n += 1
                log(f"{name}: max abs err {err:.3g}, bitwise repeatable")
                if (dn, tag, pack) == ("bfloat16", "whisper cross", True):
                    main_err = err
            if tag == "whisper cross":
                cl = pos.reshape(-1, 1, 1, 1)
                got = ops.decode_attention(q, kc, vc, cl, spec,
                                           impl="kernel")
                ref = ops.decode_attention(q, kc, vc, cl, spec, impl="ref")
                torch.cuda.synchronize()
                check_close(f"ops.decode_attention {dn} cross kernel vs ref",
                            got, ref, dn)
    log(f"swat_decode_plain: {n} cases within tolerance and bitwise "
        "repeatable; ops.decode_attention kernel route vs the ref routing "
        "within tolerance")
    return main_err


def sweep_plain_splits(torch):
    """The plain-mode kernel's time (bf16) at each split count a cluster
    can take, at whisper's cross shape (B=8, 6 heads, T=1, D=64, 1500
    encoder rows, dense non-causal) and at gemma2's local layer (B=4, 8 q
    over 4 kv heads, D=256, a 4097-row ring, every row visible), beside
    the split `plain_splits` picks. The rule is written down from it."""
    from repro_torch.core.types import AttentionSpec
    from repro_torch.kernels import swat_decode as SD
    gen = torch.Generator(device="cuda").manual_seed(12)
    mk = lambda *s: torch.randn(*s, generator=gen,
                                device="cuda").to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n, g = WHISPER["frames"], GEMMA
    local = AttentionSpec(kind="swat", window=g["window"], causal=True,
                          softcap=g["softcap"])
    cap = g["window"] + 1
    w = -(-cap // 64) * 64                    # as _gemma_ring allocates
    cases = {"whisper cross": (mk(8, 6, 1, 64), mk(8, 6, n, 64),
                               mk(8, 6, n, 64), 8 * [n],
                               AttentionSpec(kind="dense", causal=False), n),
             "gemma2 D=256": (mk(4, g["hq"], 1, g["d"]),
                              mk(4, g["hkv"], w, g["d"]),
                              mk(4, g["hkv"], w, g["d"]), 4 * [9000], local,
                              cap)}
    out = {}
    for tag, (q, kc, vc, lens, spec, cap) in cases.items():
        pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
        times = {}
        for ns in range(1, SD.MAX_SPLITS + 1):
            times[ns] = time_ms(torch, lambda: SD.launch_plain(
                q, kc, vc, pos, spec, ring_cap=cap, scale=q.shape[-1] ** -0.5,
                pack_gqa=True, nsplit=ns), iters=20)
        chunk, chosen = SD.plain_splits(q.shape[0] * kc.shape[1], cap, sms)
        out[tag] = {"ms_by_splits": times, "chosen": chosen, "chunk": chunk,
                    "fastest": min(times, key=times.get)}
    log("plain decode split sweep (bf16, CTAs per cluster -> ms): "
        + json.dumps(out))
    return out


# ------------------------------------------------------------ phase 13 ---

def _band_pairs(seq, window):
    """Visible (query, key) pairs of one causal band of `window` (or dense
    causal for window 0) over `seq` tokens."""
    if not window:
        return seq * (seq + 1) // 2
    return sum(min(i, window) + 1 for i in range(seq))


def _gemma_ring(torch, mk, cap=GEMMA["window"] + 1):
    """Decode inputs on a gemma2 cache of `cap` rows (default the local
    layer's ring, window 4096 + 1 rows), allocated to a multiple of 64: 4
    slots, one new token each. Returns (q, k_cache, v_cache, new_k, new_v,
    num_new, ring_cap)."""
    g = GEMMA
    w = -(-cap // 64) * 64
    return (mk(4, g["hq"], 1, g["d"]), mk(4, g["hkv"], w, g["d"]),
            mk(4, g["hkv"], w, g["d"]), mk(4, g["hkv"], 1, g["d"]),
            mk(4, g["hkv"], 1, g["d"]),
            torch.ones(4, dtype=torch.int32, device="cuda"), cap)


def check_gemma2(torch):
    """All five kernel entry points against their plain versions at
    gemma2-2b's shapes (D=256), bf16 and fp32, the backward twice (bitwise
    equal), then the kernels' bf16 times at the local layer, and dK/dV's at
    the global layer too. Returns {kernel: max bf16 err} and the times."""
    from repro_torch.core.types import AttentionSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_backward as SB
    from repro_torch.kernels import swat_decode as SD
    g = GEMMA
    b, hq, hkv, d, l = g["b"], g["hq"], g["hkv"], g["d"], g["seq"]
    scale = d ** -0.5
    local = AttentionSpec(kind="swat", window=g["window"], causal=True,
                          softcap=g["softcap"])
    glob = AttentionSpec(kind="dense", causal=True, softcap=g["softcap"])
    gen = torch.Generator(device="cuda").manual_seed(8)
    errs = {}

    def note(key, dn, err):
        if dn == "bfloat16":
            errs[key] = max(errs.get(key, 0.0), err)

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        mk = lambda *s: torch.randn(*s, generator=gen,
                                    device="cuda").to(dtype)
        q, k, v, do = (mk(b, hq, l, d), mk(b, hkv, l, d), mk(b, hkv, l, d),
                       mk(b, hq, l, d))
        for tag, sp in (("local", local), ("global", glob)):
            pat = ops.get_pattern(sp, l, l, 128, 128)
            name = f"gemma2 D=256 {dn} {tag}"
            wo, wl = SA.banded_plain(q, k, v, sp, pat, scale,
                                     return_lse=True)
            before = route_counts()
            o, lse = SA.swat_attention_fwd(q, k, v, sp, pattern=pat,
                                           return_lse=True)
            torch.cuda.synchronize()
            check_route(name + " forward", before, "fwd",
                        expected_route(dtype, d, "fwd"))
            note("swat_attention_fwd", dn,
                 check_close(name + " forward", o, wo, dn))
            check_close(name + " lse", lse, wl, dn, atol=1e-3, rtol=1e-4)
            del wo, wl
            want = SB.swat_attention_bwd_plain(q, k, v, o, lse, do, sp, pat,
                                               scale)
            before = route_counts()
            got = SB.swat_attention_bwd(q, k, v, o, lse, do, sp, pattern=pat)
            again = SB.swat_attention_bwd(q, k, v, o, lse, do, sp,
                                          pattern=pat)
            torch.cuda.synchronize()
            check_route(name + " dQ", before, "dq",
                        expected_route(dtype, d, "dq"), n=2)
            check_route(name + " dK/dV", before, "dkv",
                        expected_route(dtype, d, "dkv"), n=2)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{name}: two backward launches differ")
            del again
            e = [check_close(f"{name} d{c}", x, y, dn, **BWD_TOL[dn])
                 for c, x, y in zip("qkv", got, want)]
            note("swat_attention_dq", dn, e[0])
            note("swat_attention_dkv", dn, max(e[1], e[2]))
            log(f"{name}: forward and dq/dk/dv within tolerance (max abs "
                f"err dq {e[0]:.3g} dk {e[1]:.3g} dv {e[2]:.3g}), backward "
                "bitwise repeatable, dK/dV on the "
                f"{expected_route(dtype, d, 'dkv')} route")
            del want, got, o, lse
            torch.cuda.empty_cache()
        del q, k, v, do
        torch.cuda.empty_cache()
        # decode on the local layer's ring (window 4096, wrapped) and on the
        # global layer's dense causal cache (one row per token, 8192 rows);
        # `lens` counts tokens before the step's insert
        local_cap = g["window"] + 1
        for tag, sp, cap, lens in (
                ("local", local, local_cap, [4100, 9000, 100, local_cap]),
                ("global", glob, l, [l - 1, 8000, 100, 4096])):
            qd, kc, vc, nk, nv, ones, cap = _gemma_ring(torch, mk, cap)
            lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
            name = f"gemma2 D=256 {dn} {tag}"
            want, kw, vw = SD.swat_decode_fused_plain(
                qd, kc, vc, nk, nv, lens, ones, sp, ring_cap=cap)
            got = SD.swat_decode_fused(qd, kc, vc, nk, nv, lens, ones, sp,
                                       ring_cap=cap)
            torch.cuda.synchronize()
            if not (torch.equal(kc, kw) and torch.equal(vc, vw)):
                raise AssertionError(f"{name} fused decode: caches not "
                                     "bitwise equal")
            note("swat_decode_fused", dn,
                 check_close(f"{name} fused decode", got, want, dn))
            # plain decode on the caches after the insert: lens + 1 tokens,
            # the query the newest
            tot = lens + 1
            want = SD.swat_decode_plain_ref(qd, kc, vc, tot, sp,
                                            ring_cap=cap)
            for pack in (True, False):
                got = SD.swat_decode_plain(qd, kc, vc, tot, sp, ring_cap=cap,
                                           pack_gqa=pack)
                torch.cuda.synchronize()
                note("swat_decode_plain", dn, check_close(
                    f"{name} plain decode pack_gqa={pack}", got, want, dn))
            del qd, kc, vc, nk, nv, kw, vw
            torch.cuda.empty_cache()
    log("gemma2 D=256: forward, dq, dk/dv, fused and plain decode within "
        "tolerance, bf16 and fp32, local and global layers: "
        + json.dumps(errs))

    # bf16 times at the local layer (a few calls each), and one SDPA call
    # of the same shapes and mask beside each (SDPA has no softcap: it is
    # timed without one)
    import torch.nn.functional as F
    from repro_torch.core import patterns
    mk = lambda *s: torch.randn(*s, generator=gen,
                                device="cuda").to(torch.bfloat16)
    q, k, v, do = (mk(b, hq, l, d), mk(b, hkv, l, d), mk(b, hkv, l, d),
                   mk(b, hq, l, d))
    pat = ops.get_pattern(local, l, l, 128, 128)
    o, lse = SA.swat_attention_fwd(q, k, v, local, pattern=pat,
                                   return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    kw = dict(q_offset=0, kv_offset=0, bound=l)
    n_vis = _band_pairs(l, g["window"]) * b * hq
    itm, rows_q, rows_kv = 2, b * hq * l, b * hkv * l
    times = {
        "swat_attention_fwd": (
            time_ms(torch, lambda: SA.swat_attention_fwd(
                q, k, v, local, pattern=pat, return_lse=True), iters=5),
            bound(itm * d * (2 * rows_q + 2 * rows_kv) + 4 * rows_q,
                  4 * d * n_vis)),
        "swat_attention_dq": (
            time_ms(torch, lambda: SB.launch_dq(q, k, v, do, lse, delta,
                                                local, pat, scale, **kw),
                    iters=3),
            bound(itm * d * (3 * rows_q + 2 * rows_kv) + 4 * 2 * rows_q,
                  6 * d * n_vis)),
        "swat_attention_dkv": (
            time_ms(torch, lambda: SB.launch_dkv(q, k, v, do, lse, delta,
                                                 local, pat, scale, **kw),
                    iters=3),
            bound(itm * d * (2 * rows_q + 4 * rows_kv) + 4 * 2 * rows_q,
                  8 * d * n_vis)),
    }
    del o, lse, delta
    # dK/dV at the dense causal global layer (softcap 50)
    gpat = ops.get_pattern(glob, l, l, 128, 128)
    o, lse = SA.swat_attention_fwd(q, k, v, glob, pattern=gpat,
                                   return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    times["swat_attention_dkv global"] = (
        time_ms(torch, lambda: SB.launch_dkv(q, k, v, do, lse, delta, glob,
                                             gpat, scale, **kw), iters=3),
        bound(itm * d * (2 * rows_q + 4 * rows_kv) + 4 * 2 * rows_q,
              8 * d * _band_pairs(l, 0) * b * hq))
    del o, lse, delta
    qd, kc, vc, nk, nv, ones, cap = _gemma_ring(torch, mk)
    lens = torch.full((4,), 9000, dtype=torch.int32, device="cuda")
    # every slot sees the whole window (cap rows): q in, out, K/V rows read
    # (fused: cap-1 cached rows plus the new one, which it also writes)
    io_q = 2 * 4 * hq
    dec_ops = 4 * d * 4 * hq * cap
    times["swat_decode_fused"] = (
        time_ms(torch, lambda: SD.swat_decode_fused(
            qd, kc, vc, nk, nv, lens, ones, local, ring_cap=cap)),
        bound(itm * d * (io_q + 2 * 4 * hkv * (cap + 1)), dec_ops))
    times["swat_decode_plain"] = (
        time_ms(torch, lambda: SD.swat_decode_plain(
            qd, kc, vc, lens, local, ring_cap=cap)),
        bound(itm * d * (io_q + 2 * 4 * hkv * cap), dec_ops))
    lib = _gemma_library_ms(torch, F, patterns, local, q, k, v, do, qd, kc,
                            vc, lens, cap)
    out = {k_: {"ms": t, "bound_ms": bd[0], "bound_by": bd[1],
                "library_ms": lib[k_]}
           for k_, (t, bd) in times.items()}
    log("gemma2 D=256 times (bf16, local layer unless named; decode B=4 "
        "on a 4097-row ring; library: SDPA, backward as forward+backward "
        "minus forward): " + json.dumps(out))
    del q, k, v, do, qd, kc, vc, nk, nv
    torch.cuda.empty_cache()
    return errs, out


def _gemma_library_ms(torch, F, patterns, local, q, k, v, do, qd, kc, vc,
                      lens, cap):
    """SDPA at phase 13's timed shapes: the local layer's forward and its
    backward (forward+backward minus forward, which computes dQ, dK and dV
    together) on head-expanded K/V with the band as a boolean mask, the
    global layer's backward (is_causal, the same function), and the
    decode query on the ring (after the step's insert) with the ring's
    visibility mask, whose row count the timed plain decode call also
    attends."""
    from repro_torch.kernels import ref
    g = GEMMA
    rep = g["hq"] // g["hkv"]
    dm = torch.as_tensor(patterns.dense_mask(local, g["seq"], g["seq"]),
                         device="cuda")
    qr = q.detach().clone().requires_grad_()
    ke = k.repeat_interleave(rep, dim=1).requires_grad_()
    ve = v.repeat_interleave(rep, dim=1).requires_grad_()

    def fwd():
        return F.scaled_dot_product_attention(qr, ke, ve, attn_mask=dm)

    def causal():  # the global layer: dense causal, SDPA's own mask
        return F.scaled_dot_product_attention(qr, ke, ve, is_causal=True)

    with torch.no_grad():
        f_ms = time_ms(torch, fwd, iters=3)
        fc_ms = time_ms(torch, causal, iters=3)
    b_ms = time_ms(torch, lambda: torch.autograd.grad(fwd(), (qr, ke, ve),
                                                      do), iters=3) - f_ms
    bc_ms = time_ms(torch, lambda: torch.autograd.grad(
        causal(), (qr, ke, ve), do), iters=3) - fc_ms
    del qr, ke, ve, dm
    w = kc.shape[2]
    t_s, ok = ref.ring_slot_positions(lens.long() + 1, w, ring_cap=cap,
                                      num_global=0)
    qp = lens.long()[:, None]
    vis = (ok & (t_s <= qp) & (t_s >= qp - local.window))[:, None, None, :]
    kce = kc.repeat_interleave(rep, dim=1)
    vce = vc.repeat_interleave(rep, dim=1)
    d_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kce, vce, attn_mask=vis))
    torch.cuda.empty_cache()
    return {"swat_attention_fwd": f_ms, "swat_attention_dq": b_ms,
            "swat_attention_dkv": b_ms, "swat_attention_dkv global": bc_ms,
            "swat_decode_fused": d_ms, "swat_decode_plain": d_ms}


# ------------------------------------------------------------ phase 14 ---

def whisper_setup(torch, dtype_name):
    """Full-width whisper-tiny + SWAT in `dtype_name`, random weights from
    seed 0, and a batch of 8 clips of random frame embeddings (the conv
    frontend is a stub) with 16-token prompts, from seed 9."""
    import dataclasses
    from repro_torch.configs import get_config, with_swat
    from repro_torch.core import model as Mod
    cfg = with_swat(get_config("whisper-tiny"), window=WHISPER["window"],
                    num_global=WHISPER["num_global"])
    cfg = dataclasses.replace(cfg, dtype=dtype_name)
    params = Mod.init_model(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    enc = torch.randn(WHISPER["clips"], WHISPER["frames"], cfg.d_model,
                      generator=gen, device="cuda")
    tok = torch.randint(0, cfg.vocab_size,
                        (WHISPER["clips"], WHISPER["prompt"]),
                        generator=gen, device="cuda")
    return cfg, params, {"enc_embeddings": enc, "tokens": tok}


def whisper_run(torch, cfg, params, batch, impl, steps, forced=None,
                keep_logits=False):
    """Prefill, then `steps` greedy decode steps (fed with `forced[i]`
    instead of the path's own token when given). Returns (tokens
    (steps+1, B) on the card, per-step last logits or None, host seconds
    of the prefill and of the decode steps). Two host syncs: after the
    prefill and after the last step."""
    from repro_torch.core import model as Mod
    t0 = time.perf_counter()
    logits, caches = Mod.prefill(params, cfg, batch, WHISPER["max_len"],
                                 impl=impl)
    tok = logits[:, 0].argmax(-1)
    toks, kept = [tok], ([logits[:, 0]] if keep_logits else None)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(steps):
        feed = tok if forced is None else forced[i]
        logits, caches = Mod.decode_step(params, cfg,
                                         {"tokens": feed[:, None]}, caches,
                                         impl=impl)
        tok = logits[:, 0].argmax(-1)
        toks.append(tok)
        if keep_logits:
            kept.append(logits[:, 0])
    toks = torch.stack(toks)
    torch.cuda.synchronize()
    return toks, kept, {"prefill_s": t1 - t0,
                        "decode_s": time.perf_counter() - t1}


def whisper(torch):
    """Phase 14 (the main run, bf16, launch counts), 15 (kernel vs plain
    path, bf16 teacher-forced and fp32 free-running) and 16 (times)."""
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_decode as SD
    steps, clips = WHISPER["steps"], WHISPER["clips"]
    cfg, params, batch = whisper_setup(torch, "bfloat16")
    whisper_run(torch, cfg, params, batch, None, 2)     # warm-up
    torch.cuda.reset_peak_memory_stats()
    counters = {"swat_attention_fwd": SA.LAUNCHES,
                "swat_decode_fused": SD.LAUNCHES,
                "swat_decode_plain": SD.PLAIN_LAUNCHES}
    for c in counters.values():
        c.reset()
    before = route_counts()
    toks, _, host = whisper_run(torch, cfg, params, batch, None, steps)
    launches = {k: c.n for k, c in counters.items()}
    check_route("whisper bf16", before, "fwd", "tc",
                n=launches["swat_attention_fwd"])
    peak = torch.cuda.max_memory_allocated() / 1e9
    toks_host = toks.cpu()
    n_enc, n_dec = cfg.encoder_layers, cfg.num_layers
    passes = 2 if cfg.attention.num_global else 1  # band + global rows
    expected = {"swat_attention_fwd": n_enc * passes + n_dec * passes
                + n_dec,                 # encoder, decoder self, cross
                "swat_decode_fused": n_dec * steps,
                "swat_decode_plain": n_dec * steps}
    if launches != expected:
        raise AssertionError(f"whisper launches {launches}, expected "
                             f"{expected}")
    if int(toks_host.min()) < 0 or int(toks_host.max()) >= cfg.vocab_size:
        raise AssertionError("whisper: token out of range")
    summary = {"clips": clips, "frames": WHISPER["frames"],
               "prompt": WHISPER["prompt"], "decode_steps": steps,
               "tokens_per_clip": steps + 1,
               "prefill_ms": host["prefill_s"] * 1e3,
               "decode_ms_per_step": host["decode_s"] * 1e3 / steps,
               "decode_tokens_per_s": clips * steps / host["decode_s"],
               "peak_mem_gb": peak, "launches": launches,
               "expected_launches": expected,
               "distinct_tokens": int(toks_host.unique().numel())}
    log("whisper: " + json.dumps(summary))

    # phase 15a: bf16, both paths teacher-forced on the main run's tokens
    _, logits_k, _ = whisper_run(torch, cfg, params, batch, None, steps,
                                 forced=toks[:-1], keep_logits=True)
    _, logits_p, _ = whisper_run(torch, cfg, params, batch, "banded", steps,
                                 forced=toks[:-1], keep_logits=True)
    if not all(bool(torch.isfinite(x).all()) for x in logits_k):
        raise AssertionError("whisper: non-finite logits")
    diffs = [max_err(a, b) for a, b in zip(logits_k, logits_p)]
    agree = sum((a.argmax(-1) == b.argmax(-1)).float().mean().item()
                for a, b in zip(logits_k, logits_p)) / len(logits_k)
    del logits_k, logits_p
    e2e = {"bf16_max_abs_logit_diff": max(diffs),
           "bf16_logit_bound": WHISPER_LOGIT_BOUND,
           "bf16_greedy_agreement": agree, "steps": steps}

    # phase 16: device times and a traced decode block, bf16 model
    times = whisper_times(torch, cfg, params, batch)
    log("whisper times: " + json.dumps(times))
    del params
    torch.cuda.empty_cache()

    # phase 15b: fp32, both paths free-running: greedy tokens equal, and
    # (on those equal tokens) logits within WHISPER_FP32_LOGIT_BOUND
    cfg32, p32, b32 = whisper_setup(torch, "float32")
    before, fwd_before = route_counts(), SA.LAUNCHES.n
    tk, lk, _ = whisper_run(torch, cfg32, p32, b32, None, steps,
                            keep_logits=True)
    check_route("whisper fp32", before, "fwd", "simt",
                n=SA.LAUNCHES.n - fwd_before)
    tp, lp, _ = whisper_run(torch, cfg32, p32, b32, "banded", steps,
                            keep_logits=True)
    same = torch.equal(tk, tp)
    first_diff = (None if same else
                  int((tk != tp).any(dim=1).nonzero()[0, 0]))
    fp32_diff = max(max_err(a, b) for a, b in zip(lk, lp))
    del lk, lp
    e2e.update(fp32_tokens_equal=same, fp32_first_differing_step=first_diff,
               fp32_max_abs_logit_diff=fp32_diff,
               fp32_logit_bound=WHISPER_FP32_LOGIT_BOUND,
               fp32_distinct_tokens=int(tk.unique().numel()))
    log("whisper e2e kernel vs plain: " + json.dumps(e2e))
    del p32
    torch.cuda.empty_cache()
    if not same:
        raise AssertionError(f"whisper fp32: kernel path tokens differ from "
                             f"the plain path's from step {first_diff}")
    if not fp32_diff <= WHISPER_FP32_LOGIT_BOUND:
        raise AssertionError(f"whisper fp32 kernel vs plain path: {e2e}")
    if not max(diffs) <= WHISPER_LOGIT_BOUND:
        raise AssertionError(f"whisper bf16 kernel vs plain path: {e2e}")
    return summary, e2e, times


def whisper_times(torch, cfg, params, batch):
    """Encoder and prefill device times (CUDA events, mean of 5), and a
    profiled decode block of 8 steps split by kernel category, its decode
    launches counted by the wrappers."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import model as Mod
    from repro_torch.kernels import swat_decode as SD

    def timed(fn, n=5):
        fn()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / n

    with torch.no_grad():
        enc_ms = timed(lambda: Mod.encode(params, cfg, batch))
    pre_ms = timed(lambda: Mod.prefill(params, cfg, batch,
                                       WHISPER["max_len"]))
    logits, caches = Mod.prefill(params, cfg, batch, WHISPER["max_len"])
    tok = logits[:, 0].argmax(-1)
    n = 8
    torch.cuda.synchronize()
    launches0 = (SD.LAUNCHES.n, SD.PLAIN_LAUNCHES.n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            logits, caches = Mod.decode_step(params, cfg,
                                             {"tokens": tok[:, None]}, caches)
            tok = logits[:, 0].argmax(-1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # launches from the wrappers' counters, which see every launch (the
    # profiler may drop kernel records): each plain decode call (the cross
    # attention) is one decode_plain_kernel, merge included, and the
    # decoder's self-attention one decode_fused_kernel a layer and step
    calls = n * cfg.num_layers
    fused_n = SD.LAUNCHES.n - launches0[0]
    plain_n = SD.PLAIN_LAUNCHES.n - launches0[1]
    if plain_n != calls or fused_n != calls:
        raise AssertionError(f"whisper trace: {plain_n} plain and {fused_n} "
                             f"fused decode launches in {n} steps of "
                             f"{cfg.num_layers} layers, expected {calls} "
                             "each")
    out = {"encoder_ms": enc_ms, "prefill_ms": pre_ms, "trace_steps": n,
           "trace_wall_ms": wall_ms, "plain_decode_launches": plain_n,
           "fused_decode_launches": fused_n}
    dt = torch.autograd.DeviceType
    kernels = [e for e in prof.events() if e.device_type == dt.CUDA]
    if not kernels:
        out["device_time"] = "not measured (no device events traced)"
        return out
    by_cat = {}
    for e in kernels:
        name = e.name.lower()
        cat = next((c for c, keys in _CATEGORIES
                    if any(k_ in name for k_ in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = _union_ms([e.time_range for e in kernels])
    plain = [e for e in kernels if "decode_plain_kernel" in e.name]
    stray = sorted({e.name[:60] for e in kernels if "decode" in e.name.lower()
                    and "decode_plain_kernel" not in e.name
                    and "decode_fused_kernel" not in e.name})
    if stray:
        raise AssertionError(f"whisper trace: other decode kernels: {stray}")
    if len(plain) != calls:
        log(f"whisper trace: the profiler saw {len(plain)} plain decode "
            f"records for {plain_n} launches counted (a short trace)")
    out.update(device_kernels_per_step=len(kernels) / n,
               plain_decode_records_seen=len(plain),
               plain_decode_us_per_call=(sum(
                   e.time_range.elapsed_us() for e in plain) / len(plain)
                   if plain else "not measured (no record traced)"),
               device_ms_per_step_by_category={
                   k: v / n for k, v in sorted(by_cat.items())},
               device_busy_ms_per_step=busy / n,
               device_busy_share=busy / wall_ms)
    return out


def time_decode_plain(torch):
    """Kernel #3 at whisper's cross shape (B=8, 6 heads, T=1, D=64, 1500
    encoder rows, bf16): the kernel, its plain version, and SDPA on the
    same q, K, V (dense, no mask: the same function)."""
    import torch.nn.functional as F
    from repro_torch.core.types import AttentionSpec
    from repro_torch.kernels import swat_decode as SD
    gen = torch.Generator(device="cuda").manual_seed(10)
    b, h, d, n = WHISPER["clips"], 6, 64, WHISPER["frames"]
    mk = lambda *s: torch.randn(*s, generator=gen,
                                device="cuda").to(torch.bfloat16)
    q, kc, vc = mk(b, h, 1, d), mk(b, h, n, d), mk(b, h, n, d)
    pos = torch.full((b,), n, dtype=torch.int32, device="cuda")
    spec = AttentionSpec(kind="dense", causal=False)
    k_ms = time_ms(torch, lambda: SD.swat_decode_plain(q, kc, vc, pos, spec))
    p_ms = time_ms(torch, lambda: SD.swat_decode_plain_ref(q, kc, vc, pos,
                                                           spec))
    l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(q, kc, vc))
    bytes_ = 2 * d * (2 * b * h + 2 * b * h * n)
    ops_ = 4 * d * b * h * n
    return k_ms, p_ms, l_ms, bytes_, ops_


# ------------------------------------------------------------ phase 17 ---

def _chunk_case(torch, gen, dtype, b, hq, hkv, d, t, pos0, w):
    """A prefill chunk's inputs: q, k_new, v_new for tokens [pos0, pos0+T),
    a random ring cache (B, Hkv, W, D) as it stands before the chunk, and
    ragged lengths (row 0 runs past the chunk, row 1 ends inside it, other
    rows end at its end)."""
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    q = mk(b, hq, t, d)
    kn, vn = mk(b, hkv, t, d), mk(b, hkv, t, d)
    kc, vc = mk(b, hkv, w, d), mk(b, hkv, w, d)
    lens = torch.full((b,), pos0 + t, dtype=torch.int32, device="cuda")
    lens[0] = pos0 + t + 100
    if b > 1:
        lens[1] = pos0 + t // 2
    return q, kn, vn, kc, vc, lens


def chunk_cases(spec):
    """(name, spec, b, hq, hkv, d, T, pos0, logical ring capacity, physical
    rows): llama's serve chunk (window 256, 4 globals, a 261-row ring in
    320 rows) at pos0 0, 64 and 448 (after a wrap), the same chunk on a
    dense causal layer (a 1024-row cache), and gemma2-2b's D=256 local
    layer (window 4096, softcap 50, a 4097-row ring in 4160 rows) after a
    wrap."""
    import dataclasses
    from repro_torch.core.types import AttentionSpec
    cap = MAIN["window"] + 1 + MAIN["num_global"]
    gl = AttentionSpec(kind="swat", window=GEMMA["window"],
                       softcap=GEMMA["softcap"])
    ll = (spec, MAIN["b"], MAIN["hq"], MAIN["hkv"], MAIN["d"], CHUNK)
    dense = dataclasses.replace(spec, kind="dense", window=0, num_global=0)
    return [(f"llama pos0={p}", *ll, p, cap, 320) for p in (0, 64, 448)] + [
        ("llama dense causal pos0=448", dense, *ll[1:], 448, MAIN["max_len"],
         MAIN["max_len"]),
        ("gemma2 local D=256 pos0=4480", gl, GEMMA["b"] + 1, GEMMA["hq"],
         GEMMA["hkv"], GEMMA["d"], CHUNK, 4480, GEMMA["window"] + 1, 4160)]


def _check_chunk_case(torch, gen, dtype, case):
    """One case of `check_chunk` (a `chunk_cases` row) in `dtype`: pass A,
    pass B and the whole chunk route, each launch on its route. Returns
    the largest error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.core.types import AttentionSpec
    name, sp, b, hq, hkv, d, t, pos0, cap, w = case
    dn = str(dtype).split(".")[-1]
    q, kn, vn, kc, vc, lens = _chunk_case(torch, gen, dtype, b, hq, hkv, d,
                                          t, pos0, w)
    g = sp.num_global if sp.is_sparse else 0
    ring = cap - g
    lo = max(g, pos0 - ring) if pos0 >= g else pos0
    slots = g + torch.remainder(
        torch.arange(lo, pos0, device="cuda") - g, ring)
    kb = torch.cat([kc.index_select(2, slots), kn], dim=2)
    vb = torch.cat([vc.index_select(2, slots), vn], dim=2)
    pat = ops.get_pattern(sp, t, kb.shape[2], 128, 128,
                          q_shift=pos0 - lo)
    off = dict(q_offset=pos0, kv_offset=lo, seq_kv_bound=pos0 + t)
    want, wl = SA.banded_plain(q, kb, vb, sp, pat, d ** -0.5,
                               return_lse=True, **off)
    before = route_counts()
    got, gl = SA.swat_attention_fwd(q, kb, vb, sp, pattern=pat,
                                    return_lse=True, **off)
    torch.cuda.synchronize()
    tag = f"chunk {dn} {name}"
    check_route(tag, before, "fwd", expected_route(dtype, d, "fwd"))
    err = check_close(tag + " pass A", got, want, dn)
    check_close(tag + " pass A lse", gl, wl, dn, atol=1e-3,
                rtol=1e-4)
    ng = min(pos0, g)
    if ng:
        pinned = AttentionSpec(kind="dense", causal=False,
                               softcap=sp.softcap)
        kp = kc[:, :, :ng].contiguous()
        vp = vc[:, :, :ng].contiguous()
        ppat = ops.get_pattern(pinned, t, ng, 128, 128)
        want, wl = SA.banded_plain(q, kp, vp, pinned, ppat,
                                   d ** -0.5, return_lse=True)
        before = route_counts()
        got, gl = SA.swat_attention_fwd(q, kp, vp, pinned,
                                        pattern=ppat,
                                        return_lse=True)
        torch.cuda.synchronize()
        check_route(tag + " pass B", before, "fwd",
                    expected_route(dtype, d, "fwd"))
        err = max(err, check_close(tag + " pass B", got, want, dn))
        check_close(tag + " pass B lse", gl, wl, dn, atol=1e-3,
                    rtol=1e-4)
    before = route_counts()
    got = ops.prefill_chunk_attention(q, kn, vn, kc, vc, sp, pos0,
                                      lens, ring_cap=cap,
                                      impl="kernel")
    want = ops.prefill_chunk_attention(q, kn, vn, kc, vc, sp, pos0,
                                       lens, ring_cap=cap,
                                       impl="banded")
    torch.cuda.synchronize()
    check_route(tag + " route", before, "fwd",
                expected_route(dtype, d, "fwd"), n=2 if ng else 1)
    real = (pos0 + torch.arange(t, device="cuda"))[None] < lens[:, None]
    sel = real[:, None, :, None].expand_as(got)
    err = max(err, check_close(tag + " route vs plain", got[sel],
                               want[sel], dn))
    return err


def check_chunk(torch, spec):
    """Kernel #2 as a prefill chunk launches it: pass A (the gathered ring
    tail and the chunk, q_offset = pos0, kv_offset = lo, seq_kv_bound =
    pos0 + T, return_lse) and pass B (the pinned globals) against
    `banded_plain` with the same arguments, O within TOL and the LSE within
    atol 1e-3, each launch on its route; then the whole chunk route
    (`ops.prefill_chunk_attention`, impl "kernel") against the plain chunk
    attention on the card at every real position. bf16 and fp32. Returns
    the largest error of each dtype."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    worst, n = {}, 0
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for case in chunk_cases(spec):
            worst[dn] = max(worst.get(dn, 0.0),
                            _check_chunk_case(torch, gen, dtype, case))
            n += 1
    log(f"chunk: {n} cases (llama's chunk at pos0 0/64/448, its dense "
        "layer, gemma2's D=256 local layer, x bf16/fp32): pass A with "
        "offsets and pass B within tolerance, LSE within 1e-3, each launch "
        "on its route; the chunk route vs the plain chunk attention within "
        f"tolerance; worst errors {json.dumps(worst)}")
    return worst


def time_chunk(torch, spec, dtype_name="bfloat16"):
    """Kernel #2's pass A at the serve chunk after a wrap (B=4, 64 queries
    at pos0 448 against the 257-row ring tail and the chunk, 321 keys):
    the kernel, `banded_plain` and SDPA with the band as a boolean mask
    over the gathered buffer; then the whole chunk route and the plain
    chunk attention. Returns (k_ms, p_ms, l_ms, bytes, ops, route_ms,
    plain_route_ms)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_attention as SA
    dtype = getattr(torch, dtype_name)
    name, sp, b, hq, hkv, d, t, pos0, cap, w = chunk_cases(spec)[2]
    gen = torch.Generator(device="cuda").manual_seed(18)
    q, kn, vn, kc, vc, lens = _chunk_case(torch, gen, dtype, b, hq, hkv, d,
                                          t, pos0, w)
    g = sp.num_global
    lo = max(g, pos0 - (cap - g))
    slots = g + torch.remainder(torch.arange(lo, pos0, device="cuda") - g,
                                cap - g)
    kb = torch.cat([kc.index_select(2, slots), kn], dim=2)
    vb = torch.cat([vc.index_select(2, slots), vn], dim=2)
    lkv = kb.shape[2]
    pat = ops.get_pattern(sp, t, lkv, 128, 128, q_shift=pos0 - lo)
    off = dict(q_offset=pos0, kv_offset=lo, seq_kv_bound=pos0 + t)
    k_ms = time_ms(torch, lambda: SA.swat_attention_fwd(
        q, kb, vb, sp, pattern=pat, return_lse=True, **off))
    p_ms = time_ms(torch, lambda: SA.banded_plain(
        q, kb, vb, sp, pat, d ** -0.5, return_lse=True, **off))
    kidx = lo + torch.arange(lkv, device="cuda")
    qidx = pos0 + torch.arange(t, device="cuda")[:, None]
    mask = (kidx <= qidx) & (kidx >= qidx - sp.window)        # (T, Lkv)
    ke = kb.repeat_interleave(hq // hkv, dim=1)
    ve = vb.repeat_interleave(hq // hkv, dim=1)
    l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, ke, ve, attn_mask=mask))
    r_ms = time_ms(torch, lambda: ops.prefill_chunk_attention(
        q, kn, vn, kc, vc, sp, pos0, lens, ring_cap=cap, impl="kernel"))
    pr_ms = time_ms(torch, lambda: ops.prefill_chunk_attention(
        q, kn, vn, kc, vc, sp, pos0, lens, ring_cap=cap, impl="banded"))
    itm = q.element_size()
    bytes_ = (itm * d * (2 * b * hq * t + 2 * b * hkv * lkv)
              + 4 * b * hq * t)
    ops_ = 4 * d * b * hq * int(mask.sum())
    return k_ms, p_ms, l_ms, bytes_, ops_, r_ms, pr_ms


# ------------------------------------------------------------ phase 18 ---

def _serve_run(torch, cfg, params, prompts, n_new, **kw):
    """Serve `prompts` to completion: (engine, results in rid order, wall
    seconds, the paged pool's blocks in use right after the first
    admission, or None for the contiguous layout)."""
    import collections
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=MAIN["max_len"],
                        scan_steps=8, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = collections.deque(Request(rid=i, prompt=p, max_new_tokens=n_new)
                                for i, p in enumerate(prompts))
    eng._admit(pending)
    blocks = eng.paged_stats().get("blocks_in_use")
    res = eng.run(list(pending))
    torch.cuda.synchronize()
    no_step_down(eng, "serve cell")
    return eng, sorted(res, key=lambda r: r.rid), time.perf_counter() - t0, \
        blocks


def _cell_kw(cell):
    """Engine arguments of each serve cell. The paged cells (phase 20) add
    `kv_layout="paged"` to the default, speculative and chunked cells;
    "paged_shared" also shares each admission batch's common prefix."""
    from repro_torch.serving.drafter import NGramDrafter
    kw = {"default": {}, "chunked": {"prefill_chunk": CHUNK},
          "speculative": {"speculative": SPEC_K,
                          "draft": NGramDrafter(**DRAFT)}}
    kw.update({f"paged_{c}": {**v, "kv_layout": "paged"}
               for c, v in list(kw.items())})
    kw["paged_shared"] = {**kw["paged_chunked"], "share_prefix": True}
    # phase 21's mixed-temperature cells (requests alternate greedy and
    # SAMPLED_TEMP)
    kw["sampled"] = kw["default"]
    kw["speculative_sampled"] = kw["speculative"]
    return kw[cell]


def _shared_prompts(cfg):
    """The serve launcher's shared-prefix demo workload at the serve cell's
    prompt length: one system prompt of SHARED_PREFIX tokens, then a
    16-token suffix a request, from seed 0."""
    import numpy as np
    rng = np.random.RandomState(0)
    sys_prompt = rng.randint(0, cfg.vocab_size, (SHARED_PREFIX,))
    return [np.concatenate([sys_prompt, rng.randint(0, cfg.vocab_size,
                                                    (16,))]).astype(np.int32)
            for _ in range(8)]


def _fwd_launches_per_batch(eng, l_pad, g):
    """Banded-forward launches of one prefill batch of l_pad tokens: a
    single-shot prefill runs the band pass and (with globals) the
    global-row pass a layer; a chunk runs pass A, and pass B when pinned
    globals precede it. A shared-prefix batch runs the prefix single-shot
    on one row, then its suffix chunks from the prefix on."""
    single = 2 if g else 1
    c = eng.prefill_chunk
    if eng.stats["prefill_prefix_shared"]:
        return single + -(-(l_pad - SHARED_PREFIX) // c) * single
    if not c or l_pad <= c:
        return single
    chunks = -(-l_pad // c)
    return chunks + (chunks - 1 if g else 0)


def serve_cells(torch, cfg, params, cells, route, prompts=None):
    """Each cell's engine serves the 8 requests of phase 3 (or `prompts`)
    after a short warm-up. The launch counters are zeroed just before each
    run and read just after: the banded forward launches as
    `_fwd_launches_per_batch` counts, the fused decode once per layer and
    decode or verify step, every forward launch on `route`. Returns
    ({cell: (summary, tokens, engine)}, prompts)."""
    import numpy as np
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_decode as SD
    if prompts is None:
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, cfg.vocab_size, (MAIN["prompt"],))
                   .astype(np.int32) for _ in range(8)]
    layers = cfg.num_layers
    g = cfg.attention.num_global
    out = {}
    for cell in cells:
        kw = _cell_kw(cell)
        _serve_run(torch, cfg, params, prompts[:4], 4, **kw)    # warm-up
        SD.LAUNCHES.reset()
        SA.LAUNCHES.reset()
        before = route_counts()
        eng, res, wall, blocks = _serve_run(torch, cfg, params, prompts,
                                            MAIN["new_tokens"], **kw)
        launches = {"swat_decode": SD.LAUNCHES.n,
                    "swat_attention_fwd": SA.LAUNCHES.n}
        check_route(f"serve {cell}", before, "fwd", route,
                    n=SA.LAUNCHES.n)
        st = eng.stats
        for r in res:
            if r.status != "ok" or len(r.tokens) != MAIN["new_tokens"]:
                raise AssertionError(f"{cell} request {r.rid}: {r.status}, "
                                     f"{len(r.tokens)} tokens")
        l_pad = max(len(p) for p in prompts)
        per_batch = _fwd_launches_per_batch(eng, l_pad, g)
        if eng.share_prefix and \
                st["prefill_prefix_shared"] != st["prefill_batches"]:
            raise AssertionError(f"serve {cell}: {st['prefill_prefix_shared']}"
                                 f" of {st['prefill_batches']} prefill "
                                 "batches shared their prefix")
        expected = {"swat_decode": layers * st["decode_steps"],
                    "swat_attention_fwd": layers * per_batch
                    * st["prefill_batches"]}
        if launches != expected:
            raise AssertionError(f"serve {cell}: launches {launches}, "
                                 f"expected {expected}")
        n_tok = sum(len(r.tokens) for r in res)
        summary = {
            "tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
            "prefill_batches": st["prefill_batches"],
            "prefill_ms_per_batch": st["prefill_s"] * 1e3
            / st["prefill_batches"],
            "decode_steps": st["decode_steps"],
            "decode_ms_per_step": st["decode_s"] * 1e3 / st["decode_steps"],
            "tokens_per_step_per_slot": st["tokens_emitted"]
            / (st["decode_steps"] * 4),
            "spec_steps": st["spec_steps"],
            "acceptance_rate": eng.acceptance_rate,
            "launches": launches,
            "fwd_launches_per_batch": launches["swat_attention_fwd"]
            / st["prefill_batches"],
            "prefill_tokens_computed": st["prefill_tokens_computed"]}
        if blocks is not None:
            summary.update(blocks_in_use_after_first_admission=blocks,
                           prefill_prefix_shared=st["prefill_prefix_shared"],
                           cow_moves=st["cow_moves"], **eng.paged_stats())
        log(f"serve {cell} ({str(params['embed'].dtype)}; a fresh engine: "
            "first uses eager, captures included): " + json.dumps(summary))
        out[cell] = (summary, [r.tokens for r in res], eng)
    return out, prompts


def _teacher_forced_agreement(torch, cfg, params, tok, tokens):
    """Mean greedy agreement of served `tokens` (rows of the prompts
    `tok`) with single-shot prefill and sequential contiguous decode
    teacher-forced along them."""
    from repro_torch.core import model as Mod
    want = torch.as_tensor(tokens, device="cuda")
    logits, caches = Mod.prefill(params, cfg, {"tokens": tok},
                                 MAIN["max_len"])
    agree = [(logits[:, 0].argmax(-1) == want[:, 0]).float().mean()]
    for j in range(1, want.shape[1]):
        logits, _ = Mod.decode_step(params, cfg,
                                    {"tokens": want[:, j - 1:j]}, caches)
        agree.append((logits[:, 0].argmax(-1) == want[:, j]).float().mean())
    return float(torch.stack(agree).mean())


def serve_slice(torch, cfg, params):
    """Phase 18, bf16: the chunked (prefill_chunk 64) and speculative (k=4)
    cells at full width and depth, then their gates against the default
    engine: chunked against single-shot first-token logits (max |dlogit|
    <= LOGIT_BOUND) on the first four prompts, and the speculative run's
    tokens against sequential decode teacher-forced along them (greedy
    agreement >= AGREE_BOUND). Returns (summaries, gates, tokens), each by
    cell."""
    import numpy as np
    from repro_torch.serving.engine import ServingEngine
    cells, prompts = serve_cells(torch, cfg, params,
                                 ("chunked", "speculative"), "tc")
    base = ServingEngine(cfg, params, batch_slots=4, max_len=MAIN["max_len"])
    tok = torch.as_tensor(np.stack(prompts[:4]), device="cuda")
    lens = torch.full((4,), MAIN["prompt"], dtype=torch.int32, device="cuda")
    chunk_eng = cells["chunked"][2]
    lc, _ = chunk_eng.prefill_logits(tok, lens)
    ls, _ = base.prefill_logits(tok, lens)
    dlogit = max_err(lc, ls)
    agreement = _teacher_forced_agreement(torch, cfg, params, tok,
                                          cells["speculative"][1][:4])
    gates = {"chunked_first_token_max_abs_logit_diff": dlogit,
             "logit_bound": LOGIT_BOUND,
             "speculative_teacher_forced_agreement": agreement,
             "agreement_bound": AGREE_BOUND}
    log("serve slice gates (bf16): " + json.dumps(gates))
    if not (dlogit <= LOGIT_BOUND and agreement >= AGREE_BOUND):
        raise AssertionError(f"serve slice gates: {gates}")
    return ({c: v[0] for c, v in cells.items()}, gates,
            {c: v[1] for c, v in cells.items()})


def serve_slice_fp32(torch, cfg):
    """Phase 19, fp32 at full width and depth (the SIMT forward): the
    default, chunked and speculative cells serve the same 8 requests, and
    their greedy tokens must be equal on every request."""
    import dataclasses
    from repro_torch.core import model as Mod
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = Mod.init_model(cfg32, seed=0, device="cuda")
    cells, _ = serve_cells(torch, cfg32, params,
                           ("default", "chunked", "speculative"), "simt")
    base = cells["default"][1]
    for cell in ("chunked", "speculative"):
        got = cells[cell][1]
        bad = [i for i, (a, b) in enumerate(zip(got, base)) if a != b]
        if bad:
            raise AssertionError(f"fp32 {cell}: greedy tokens differ from "
                                 f"the default engine's on requests {bad}")
    log("serve slice fp32: chunked and speculative greedy tokens equal the "
        "default engine's on all 8 requests")
    # phase 20's fp32 gate: shared-prefix tokens equal the unshared ones
    paged, _ = serve_cells(torch, cfg32, params,
                           ("paged_chunked", "paged_shared"), "simt",
                           prompts=_shared_prompts(cfg))
    bad = [i for i, (a, b) in enumerate(zip(paged["paged_shared"][1],
                                            paged["paged_chunked"][1]))
           if a != b]
    if bad:
        raise AssertionError("fp32 paged_shared: greedy tokens differ from "
                             f"the unshared paged engine's on requests {bad}")
    log("serve paged fp32: shared-prefix greedy tokens equal the unshared "
        "paged engine's on all 8 requests")
    out = {c: v[0] for c, v in {**cells, **paged}.items()}
    # phase 21's fp32 gates: graph tokens bitwise eager's, counts equal
    out["graphs"] = graph_gates(torch, cfg32, params, "fp32")[0]
    del params
    return out


# ------------------------------------------------------------ phase 20 ---

def time_decode_paged(torch, spec):
    """Kernel #1 on a paged cache's gathered view: the serve shape's T=1
    rings stored as 16-row blocks of a pool, in shuffled block order, read
    through a table into the view `layers.paged_gather` builds. The kernel
    against its plain version on the view (caches bitwise, outputs within
    TOL); the updated view scattered back and gathered again, bitwise.
    Returns (max abs err, the kernel's (ms, plain ms, SDPA ms, bytes,
    operations) on the view, the whole paged route's ms: gather K and V,
    the kernel, scatter both back)."""
    from repro_torch.core import layers as L
    from repro_torch.kernels import swat_decode as SD
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, hq, hkv, d = MAIN["b"], MAIN["hq"], MAIN["hkv"], MAIN["d"]
    q, kc, vc, nk, nv, pos, nn, cap = _ring_inputs(
        torch, gen, torch.bfloat16, b, hq // hkv, hkv, 1, d,
        [600, 575, 530, 700])
    page = L.PAGE_SIZE
    nb = kc.shape[2] // page
    table = torch.randperm(b * (nb + 1), generator=gen, device="cuda")[
        :b * nb].view(b, nb).int()
    pools = []
    for ring in (kc, vc):
        pool = torch.zeros((b * (nb + 1), hkv, page, d), dtype=ring.dtype,
                           device="cuda")
        pools.append(L.paged_scatter(pool, table, ring))
    kv, vv = (L.paged_gather(pool, table) for pool in pools)
    if not (torch.equal(kv, kc) and torch.equal(vv, vc)):
        raise AssertionError("paged view: gather of the scattered rings "
                             "differs from the rings")
    want, kw, vw = SD.swat_decode_fused_plain(q, kv, vv, nk, nv, pos, nn,
                                              spec, ring_cap=cap)
    got = SD.swat_decode_fused(q, kv, vv, nk, nv, pos, nn, spec,
                               ring_cap=cap)
    if not (torch.equal(kv, kw) and torch.equal(vv, vw)):
        raise AssertionError("paged view: kernel caches not bitwise equal "
                             "to the plain version")
    err = check_close("swat_decode paged view", got, want, "bfloat16")
    for pool, view in zip(pools, (kv, vv)):
        L.paged_scatter(pool, table, view)
        if not torch.equal(L.paged_gather(pool, table), view):
            raise AssertionError("paged view: write-back round trip differs")
    times = _time_fused(torch, spec, q, kv, vv, nk, nv, pos, nn, cap)

    def route():
        views = [L.paged_gather(pool, table) for pool in pools]
        SD.swat_decode_fused(q, *views, nk, nv, pos, nn, spec, ring_cap=cap)
        for pool, view in zip(pools, views):
            L.paged_scatter(pool, table, view)
    return err, times, time_ms(torch, route)


def serve_paged(torch, cfg, params, base_tokens, spec_tokens):
    """Phase 20, bf16 at full width and depth: the paged cell serves the 8
    requests of phase 3 and the paged speculative cell (k=4) those of phase
    18; their greedy tokens must equal the contiguous engines' bitwise
    (`base_tokens`, `spec_tokens`). Then the shared-prefix demo workload
    (SHARED_PREFIX + 16 tokens) through the paged engine with
    prefill_chunk=CHUNK, unshared and shared: the shared batch's
    first-token logits within LOGIT_BOUND of the unshared one's on the
    first four prompts, and the shared run's tokens teacher-forced
    against single-shot prefill and sequential decode (agreement >=
    AGREE_BOUND). Returns (summaries by cell, gates)."""
    import numpy as np
    cells, base_prompts = serve_cells(torch, cfg, params,
                                      ("paged_default", "paged_speculative"),
                                      "tc")
    for cell, want in (("paged_default", base_tokens),
                       ("paged_speculative", spec_tokens)):
        bad = [i for i, (a, b) in enumerate(zip(cells[cell][1], want))
               if a != b]
        if bad:
            raise AssertionError(f"bf16 {cell}: greedy tokens differ from "
                                 f"the contiguous engine's on requests {bad}")
    prompts = _shared_prompts(cfg)
    shared, _ = serve_cells(torch, cfg, params,
                            ("paged_chunked", "paged_shared"), "tc",
                            prompts=prompts)
    tok = torch.as_tensor(np.stack(prompts[:4]), device="cuda")
    lens = torch.full((4,), len(prompts[0]), dtype=torch.int32,
                      device="cuda")
    ls, _ = shared["paged_shared"][2].prefill_logits(tok, lens,
                                                     SHARED_PREFIX)
    lu, _ = shared["paged_chunked"][2].prefill_logits(tok, lens)
    gates = {"paged_tokens_bitwise_equal_contiguous": True,
             "paged_speculative_tokens_bitwise_equal_contiguous": True,
             "shared_first_token_max_abs_logit_diff": max_err(ls, lu),
             "logit_bound": LOGIT_BOUND,
             "shared_teacher_forced_agreement": _teacher_forced_agreement(
                 torch, cfg, params, tok, shared["paged_shared"][1][:4]),
             "agreement_bound": AGREE_BOUND}
    log("serve paged gates (bf16): " + json.dumps(gates))
    if not (gates["shared_first_token_max_abs_logit_diff"] <= LOGIT_BOUND
            and gates["shared_teacher_forced_agreement"] >= AGREE_BOUND):
        raise AssertionError(f"serve paged gates: {gates}")
    # time the two layouts in turns (contiguous, paged, paged, contiguous,
    # twice) on one engine each, warmed by one run, so that every timed
    # run only replays graphs
    from repro_torch.serving.engine import ServingEngine
    engines = {layout: ServingEngine(cfg, params, batch_slots=4,
                                     max_len=MAIN["max_len"], scan_steps=8,
                                     kv_layout=layout)
               for layout in ("contiguous", "paged")}
    for eng in engines.values():
        _serve_on(torch, eng, base_prompts, MAIN["new_tokens"])
    ab = {"contiguous": [], "paged": []}
    for layout in ("contiguous", "paged", "paged", "contiguous") * 2:
        st_ = _serve_on(torch, engines[layout], base_prompts,
                        MAIN["new_tokens"])[2]
        ab[layout].append(st_["decode_s"] * 1e3 / st_["decode_steps"])
    ab["paged_over_contiguous"] = (sum(ab["paged"])
                                   / sum(ab["contiguous"]))
    log("decode ms a step, in turns (bf16): " + json.dumps(ab))
    # the shared-prefix batch against the unshared chunked one, the same
    # way: warmed engines, prefill ms a batch in turns, no capture timed
    engines = {c: ServingEngine(cfg, params, batch_slots=4,
                                max_len=MAIN["max_len"], scan_steps=8,
                                **_cell_kw(c))
               for c in ("paged_chunked", "paged_shared")}
    for eng in engines.values():
        _serve_on(torch, eng, prompts, 2)
    pf = {"paged_chunked": [], "paged_shared": []}
    captured0 = {c: len(e._compiled.captured) for c, e in engines.items()}
    for cell in ("paged_chunked", "paged_shared") * 2:
        st_ = _serve_on(torch, engines[cell], prompts, 2)[2]
        pf[cell].append(st_["prefill_s"] * 1e3 / st_["prefill_batches"])
    if any(len(e._compiled.captured) != captured0[c]
           for c, e in engines.items()):
        raise AssertionError("prefill turns: a timed run captured a graph")
    pf["shared_over_unshared"] = (sum(pf["paged_shared"])
                                  / sum(pf["paged_chunked"]))
    log("prefill ms a batch, in turns (bf16, warmed graph engines): "
        + json.dumps(pf))
    out = {c: v[0] for c, v in {**cells, **shared}.items()}
    out["decode_ms_per_step_in_turns"] = ab
    out["prefill_ms_per_batch_in_turns"] = pf
    return out, gates


# ------------------------------------------------------------ phase 21 ---

# the serve cells whose graph runs are held to eager runs; the "sampled"
# ones serve requests that alternate greedy and SAMPLED_TEMP
GRAPH_CELLS = ("default", "speculative", "chunked", "paged_default",
               "paged_shared", "sampled", "speculative_sampled")
SAMPLED_TEMP = 0.8


def _serve_on(torch, eng, prompts, n_new, temps=None, healthy=True):
    """Serve `prompts` on an existing engine (n_new tokens each, or a list;
    temperature 0, or `temps`): (tokens in rid order, every launch
    counter's count in the run, the engine's stats in the run, wall
    seconds). A healthy engine (every engine but phase 23's stepped-down
    ones) must not have stepped down."""
    from repro_torch.serving.engine import Request
    news = n_new if isinstance(n_new, list) else [n_new] * len(prompts)
    temps = temps or [0.0] * len(prompts)
    res, counts, st, wall = _run_requests(
        torch, eng, [Request(rid=i, prompt=p, max_new_tokens=n,
                             temperature=t)
                     for i, (p, n, t) in enumerate(zip(prompts, news,
                                                        temps))])
    if healthy:
        no_step_down(eng, "serve")
    return [r.tokens for r in res], counts, st, wall


def _run_requests(torch, eng, reqs):
    """eng.run(reqs) between two syncs: (Results in rid order, every launch
    counter's count in the run, the engine's stats in the run, wall
    seconds)."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    counts0, stats0 = _build.launch_counts(), dict(eng.stats)
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = [a - b for a, b in zip(_build.launch_counts(), counts0)]
    return (sorted(res, key=lambda r: r.rid), counts,
            {k: v - stats0[k] for k, v in eng.stats.items()}, wall)


def _chunk_buffer_mb(eng):
    """The persistent chunked-prefill set's size (caches, logits, tokens,
    lengths), MiB; 0 before the engine's first chunked batch."""
    if eng._chunk_buf is None:
        return 0.0
    leaves = []
    for buf in eng._chunk_buf:
        leaves += [t for blk in buf["caches"] for layer in blk.values()
                   for t in layer.values()]
        leaves += [buf[k] for k in ("last", "tok", "lens")]
    return sum(t.numel() * t.element_size() for t in leaves) / 2 ** 20


def _graph_stats(eng):
    c = eng._compiled
    return {"graphs_captured": len(c.captured),
            "keys": sorted({k[0] for k in c.captured}),
            "capture_s": c.capture_s, "pool_mb": c.pool_bytes / 2 ** 20,
            "chunk_buffer_mb": _chunk_buffer_mb(eng),
            "replays": c.replays, "evicted": c.evicted}


def sampler_replays(torch, vocab):
    """A sampled key through the engine's graph cache: the sampler at
    SAMPLED_TEMP on fixed logits (4 rows of the vocabulary), run 4 times
    under one key (eager, capture and replay, replay, replay) on the
    engine's kind of generator. Each draw must equal an eager draw from a
    generator of the same seed, bitwise, and the replays must draw fresh
    noise (no two consecutive draws equal)."""
    from repro_torch.serving import engine as E
    from repro_torch.serving import sampling
    lg = torch.randn((4, vocab), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(12))
    temps = torch.full((4,), SAMPLED_TEMP, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = torch.zeros((4,), dtype=torch.int32, device="cuda")
    comp = E._Compiled(True, gen)

    def body():
        out.copy_(sampling.sample(gen, lg, temps, 0, any_sampling=True))

    draws = []
    for _ in range(4):
        comp.run(("sample",), body)
        draws.append(out.clone())
    ref = torch.Generator(device="cuda").manual_seed(11)
    want = [sampling.sample(ref, lg, temps, 0, any_sampling=True)
            for _ in range(4)]
    res = {"captured": len(comp.captured), "replays": comp.replays,
           "draws_equal_eager": all(torch.equal(a, b)
                                    for a, b in zip(draws, want)),
           "consecutive_draws_differ": all(
               not torch.equal(a, b) for a, b in zip(draws, draws[1:]))}
    log("graphs sampled key: " + json.dumps(res))
    if not (res["captured"] == 1 and res["replays"] == 3
            and res["draws_equal_eager"] and res["consecutive_draws_differ"]):
        raise AssertionError(f"graphs sampled key: {res}")
    return res


def graph_gates(torch, cfg, params, tag):
    """Phase 21's gates at one dtype: in each of GRAPH_CELLS an eager
    engine (graphs=False) and a graph engine with the same seed serve the
    same requests (the 8 of phase 3, or phase 20's shared-prefix
    workload), the graph engine twice: its first run warms each key up and
    captures it at its second use, its second run only replays. Each graph
    run's tokens must equal the eager run's bitwise (in the sampled cells
    the eager engine runs twice too, run for run, and the second run's
    sampled requests must differ from the first's: fresh noise), every
    launch counter must count what eager counted, the step and batch
    counts must agree, and the second run must capture nothing. Then a
    sampled key's replays against eager draws (`sampler_replays`). Returns
    ({cell: summary}, {cell: (eager engine, graph engine, prompts, the
    graph engine's runs: (tokens, launch counts, keys captured, replays)
    each)})."""
    import numpy as np
    from repro_torch.serving.engine import ServingEngine
    rng = np.random.RandomState(0)
    base = [rng.randint(0, cfg.vocab_size, (MAIN["prompt"],))
            .astype(np.int32) for _ in range(8)]
    out, engines = {}, {}
    keys = ("decode_steps", "spec_steps", "prefill_batches", "tokens_emitted")
    for cell in GRAPH_CELLS:
        prompts = _shared_prompts(cfg) if cell == "paged_shared" else base
        sampled = cell.endswith("sampled")
        temps = [SAMPLED_TEMP * (i % 2) for i in range(8)] if sampled \
            else None
        make = lambda graphs: ServingEngine(
            cfg, params, batch_slots=4, max_len=MAIN["max_len"],
            scan_steps=8, graphs=graphs, **_cell_kw(cell))
        eager, graph = make(False), make(True)
        wants = [_serve_on(torch, eager, prompts, MAIN["new_tokens"], temps)
                 for _ in range(2 if sampled else 1)]
        runs, got_runs, graph_runs = [], [], []
        for i, run in enumerate(("warm-up and capture", "replay")):
            want, w_counts, w_st, _ = wants[i if sampled else 0]
            captured0 = len(graph._compiled.captured)
            replays0 = graph._compiled.replays
            got, counts, st_, _ = _serve_on(torch, graph, prompts,
                                            MAIN["new_tokens"], temps)
            graph_runs.append((got, counts, graph._compiled.captured[
                captured0:], graph._compiled.replays - replays0))
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            if bad:
                raise AssertionError(f"graphs {tag} {cell} ({run}): tokens "
                                     "differ from the eager engine's on "
                                     f"requests {bad}")
            if counts != w_counts:
                raise AssertionError(f"graphs {tag} {cell} ({run}): launch "
                                     f"counts {counts}, eager {w_counts}")
            if any(st_[k] != w_st[k] for k in keys):
                raise AssertionError(f"graphs {tag} {cell} ({run}): stats "
                                     f"{st_} vs eager {w_st}")
            runs.append(len(graph._compiled.captured) - captured0)
            got_runs.append(got)
        if runs[1]:
            raise AssertionError(f"graphs {tag} {cell}: {runs[1]} captures "
                                 "in the replay run")
        out[cell] = {"tokens_bitwise_equal_eager": True,
                     "launch_counts_equal_eager": True, **_graph_stats(graph)}
        if sampled:
            fresh = sum(got_runs[0][i] != got_runs[1][i]
                        for i in range(1, 8, 2))
            if not fresh:
                raise AssertionError(f"graphs {tag} {cell}: the replay run's "
                                     "sampled requests repeat the first "
                                     "run's tokens")
            out[cell]["sampled_requests_differing_between_runs"] = fresh
            out[cell]["sampled_keys"] = sorted(
                {k for k in graph._compiled.captured if k[-1] is False})
            if not out[cell]["sampled_keys"]:
                raise AssertionError(f"graphs {tag} {cell}: no key of the "
                                     "full sampler was captured")
        engines[cell] = (eager, graph, prompts, graph_runs)
        log(f"graphs {tag} {cell}: " + json.dumps(out[cell]))
    out["sampled_key_replays"] = sampler_replays(torch, cfg.vocab_size)
    return out, engines


def _mixed_stream(cfg, cell):
    """Phase 21's mixed stream, from seed 2: 12 requests of 8-40 new
    tokens. "chunked": random prompts of 80-640 tokens. "paged_shared":
    three system prompts of 96-448 tokens, four requests each (in order),
    each with its own 8-64-token suffix. (prompts, new tokens)."""
    import numpy as np
    rng = np.random.RandomState(2)
    news = [int(x) for x in rng.randint(8, 41, 12)]
    if cell == "chunked":
        return [rng.randint(0, cfg.vocab_size, (int(n),)).astype(np.int32)
                for n in rng.randint(80, 641, 12)], news
    prompts = []
    for n in rng.randint(96, 449, 3):
        sys_p = rng.randint(0, cfg.vocab_size, (int(n),))
        prompts += [np.concatenate([sys_p, rng.randint(
            0, cfg.vocab_size, (int(m),))]).astype(np.int32)
            for m in rng.randint(8, 65, 4)]
    return prompts, news


def graph_mixed_stream(torch, cfg, params):
    """Phase 21, bf16: a stream whose chunk keys rarely repeat (mixed
    prompt lengths; mixed system-prompt lengths behind shared prefixes),
    on fresh engines in turns: eager, graphs (the stream, then the stream
    again), graphs (the same), eager. Every run's greedy tokens, launch
    counts and step counts must equal the first eager run's. Prints each
    run's wall, prefill and decode seconds, and the graph engines'
    captures, drops, capture seconds, pool and chunk-buffer sizes."""
    from repro_torch.serving.engine import ServingEngine
    out = {}
    keys = ("decode_steps", "spec_steps", "prefill_batches", "tokens_emitted")
    for cell in ("chunked", "paged_shared"):
        prompts, news = _mixed_stream(cfg, cell)
        runs, want = [], None
        for mode in ("eager", "graphs", "graphs", "eager"):
            eng = ServingEngine(cfg, params, batch_slots=4,
                                max_len=MAIN["max_len"], scan_steps=8,
                                graphs=mode == "graphs", **_cell_kw(cell))
            for rep in ("first", "again") if mode == "graphs" else ("first",):
                captured0 = len(eng._compiled.captured)
                got, counts, st_, wall = _serve_on(torch, eng, prompts, news)
                if want is None:
                    want = (got, counts, st_)
                elif (got != want[0] or counts != want[1]
                      or any(st_[k] != want[2][k] for k in keys)):
                    raise AssertionError(
                        f"mixed stream {cell} ({mode}, {rep}): tokens, "
                        "launch counts or step counts differ from eager's")
                row = {"mode": mode, "pass": rep, "wall_s": wall,
                       "prefill_s": st_["prefill_s"],
                       "decode_s": st_["decode_s"],
                       "prefill_batches": st_["prefill_batches"],
                       "decode_steps": st_["decode_steps"]}
                if mode == "graphs":
                    row.update(_graph_stats(eng), captured_in_pass=len(
                        eng._compiled.captured) - captured0,
                        chunk_keys=len({k for k in eng._compiled.captured
                                        if k[0] == "chunk"}))
                runs.append(row)
        wall = {m: [r["wall_s"] for r in runs
                    if r["mode"] == m and r["pass"] == "first"]
                for m in ("eager", "graphs")}
        out[cell] = {"runs": runs,
                     "first_pass_eager_over_graphs":
                     sum(wall["eager"]) / sum(wall["graphs"])}
        log(f"graphs mixed stream {cell} (bf16): " + json.dumps(out[cell]))
    return out


def graph_turns(torch, engines):
    """Phase 21's times, bf16: eager and graph engines (warmed by the
    gates) serve the first 4 of their cell's requests, one admission
    batch, in turns (eager, graphs, graphs, eager, twice): decode ms a
    step in the sequential and paged cells, verify ms a step in the
    speculative cell, prefill ms a batch in the chunked cell (host clock,
    ending in the block's or batch's host sync)."""
    metric = {"default": ("decode_s", "decode_steps"),
              "speculative": ("decode_s", "decode_steps"),
              "chunked": ("prefill_s", "prefill_batches"),
              "paged_default": ("decode_s", "decode_steps")}
    out = {}
    for cell, (num, den) in metric.items():
        eager, graph, prompts, _ = engines[cell]
        t = {"eager": [], "graphs": []}
        for mode in ("eager", "graphs", "graphs", "eager") * 2:
            eng = eager if mode == "eager" else graph
            st_ = _serve_on(torch, eng, prompts[:4], MAIN["new_tokens"])[2]
            t[mode].append(st_[num] * 1e3 / st_[den])
        t["eager_over_graphs"] = sum(t["eager"]) / sum(t["graphs"])
        out[f"{cell} ms a {'batch' if cell == 'chunked' else 'step'}"] = t
    log("graphs vs eager, in turns (bf16): " + json.dumps(out))
    return out


# ------------------------------------------------------------ phase 22 ---

# the serve cells whose metrics-on graph runs are held to phase 21's
# metrics-off graph runs
TELEMETRY_CELLS = ("default", "speculative", "chunked", "paged_default",
                   "paged_shared")
# phase 5's fused-decode shape for kernelprof.profile_decode: 4 slots, 8 kv
# heads of 4 queries, D=64, the 261-row ring of window 256 + 4 globals
PROFILE_SHAPE = dict(b=MAIN["b"], h_kv=MAIN["hkv"],
                     group=MAIN["hq"] // MAIN["hkv"], t=1, d=MAIN["d"],
                     window=MAIN["window"], num_global=MAIN["num_global"],
                     cap=MAIN["window"] + 1 + MAIN["num_global"])


def _latency_ms(records):
    """p50 / p95 / p99 (ms) and count of TTFT, TPOT and queue delay over
    tracer records."""
    from repro_torch.telemetry.tracer import Tracer
    out = {}
    for name in ("ttft", "tpot", "queue_delay"):
        q = Tracer.percentiles([v for r in records
                                if (v := getattr(r, name)) is not None])
        out[name] = {k: v if k == "count" else v * 1e3 for k, v in q.items()}
    return out


def telemetry(torch, cfg, params, engines):
    """Phase 22, bf16: in each of TELEMETRY_CELLS a graph engine with
    metrics=True (same seed) serves phase 21's requests twice, as phase
    21's metrics-off graph engine did (`engines`, from graph_gates): each
    run's greedy tokens bitwise the metrics-off run's, every launch counter
    equal, the same keys captured and the same replays. The device counters
    must equal the host oracle (tokens and pos: tokens emitted; drafts:
    the host's draft counts; steps: decode steps; nothing quarantined),
    and the Chrome trace and Prometheus text must pass the port's
    validators. The census is on for the sequential cell's first run: the
    fused decode kernel must record its geometry. Then, per cell, TTFT,
    TPOT and queue-delay percentiles of the replay run; metrics-on against
    metrics-off decode and verify ms a step in turns (warmed engines, 4
    runs each, untraced); and one kernelprof.profile_decode row at
    PROFILE_SHAPE. Returns (summary by cell, turns, profile row, census)."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.telemetry import kernelprof as KP
    from repro_torch.telemetry import validate as V
    t_phase = time.perf_counter()
    out, on_engines, census = {}, {}, []
    for cell in TELEMETRY_CELLS:
        off, prompts, off_runs = engines[cell][1:]
        eng = ServingEngine(cfg, params, batch_slots=4,
                            max_len=MAIN["max_len"], scan_steps=8,
                            graphs=True, metrics=True, **_cell_kw(cell))
        for i, (want, w_counts, w_keys, w_replays) in enumerate(off_runs):
            captured0, replays0 = (len(eng._compiled.captured),
                                   eng._compiled.replays)
            KP.enable_census(cell == "default" and i == 0)
            try:
                got, counts, _, _ = _serve_on(torch, eng, prompts,
                                              MAIN["new_tokens"])
            finally:
                KP.enable_census(False)
            census += KP.consume_census()
            keys = eng._compiled.captured[captured0:]
            replays = eng._compiled.replays - replays0
            if got != want:
                bad = [j for j, (a, b) in enumerate(zip(got, want)) if a != b]
                raise AssertionError(f"telemetry {cell} run {i}: metrics-on "
                                     "tokens differ from metrics-off on "
                                     f"requests {bad}")
            if (counts, keys, replays) != (w_counts, w_keys, w_replays):
                raise AssertionError(
                    f"telemetry {cell} run {i}: launches {counts}, captured "
                    f"{keys}, replays {replays}; metrics-off {w_counts}, "
                    f"{w_keys}, {w_replays}")
        st, dev = eng.stats, eng.device_metrics()
        oracle = {"tokens": st["tokens_emitted"], "pos": st["tokens_emitted"],
                  "drafts_proposed": st["draft_proposed"],
                  "drafts_accepted": st["draft_accepted"],
                  "steps": st["decode_steps"], "quarantined": 0}
        if any(dev[k] != v for k, v in oracle.items()):
            raise AssertionError(f"telemetry {cell}: device counters {dev}, "
                                 f"host oracle {oracle}")
        problems = (V.validate_chrome_trace(eng.chrome_trace())
                    + V.validate_prometheus(eng.metrics_text()))
        if problems:
            raise AssertionError(f"telemetry {cell} exports: {problems}")
        out[cell] = {
            "tokens_bitwise_metrics_off": True,
            "launches_captures_replays_equal_metrics_off": True,
            "device_counters": dev, "exports_valid": True,
            "latency_ms_replay_run": _latency_ms(
                list(eng.tracer.records)[-len(prompts):]),
            "latency_ms_first_run": _latency_ms(
                list(eng.tracer.records)[:len(prompts)])}
        on_engines[cell] = eng
        log(f"telemetry {cell}: " + json.dumps(out[cell]))
    if not any(r["op"] == "swat_decode" for r in census):
        raise AssertionError(f"telemetry census: no swat_decode record in "
                             f"{census}")
    log("telemetry census (sequential cell, first run): "
        + json.dumps(census))
    turns = {}
    for cell, unit in (("default", "decode"), ("speculative", "verify")):
        off, prompts = engines[cell][1], engines[cell][2][:4]
        t = {"metrics_off": [], "metrics_on": []}
        for mode in ("metrics_off", "metrics_on", "metrics_on",
                     "metrics_off") * 2:
            eng = on_engines[cell] if mode == "metrics_on" else off
            st_ = _serve_on(torch, eng, prompts, MAIN["new_tokens"])[2]
            t[mode].append(st_["decode_s"] * 1e3 / st_["decode_steps"])
        t["on_over_off"] = sum(t["metrics_on"]) / sum(t["metrics_off"])
        turns[f"{unit} ms a step"] = t
    log("telemetry metrics on vs off, in turns (bf16): " + json.dumps(turns))
    (row,) = KP.profile_decode([PROFILE_SHAPE], impl="kernel",
                               device="cuda", iters=30)
    log("telemetry profile_decode (kernel): " + json.dumps(row))
    log(f"telemetry phase: {time.perf_counter() - t_phase:.1f}s")
    return out, turns, row, census


# ------------------------------------------------------------ phase 23 ---

def _resilience_gate(name, res, clean, poisoned_rid, kept=None,
                     bitwise=None):
    """One chaos run's outcome against the clean run's tokens: only
    `poisoned_rid` ends "poisoned", with `kept` tokens (or any clean
    prefix of at least one token), every other request ends ok, and the
    requests in `bitwise` (default: all of them) hold the clean tokens
    bitwise."""
    statuses = {r.rid: r.status for r in res}
    want = {r.rid: "poisoned" if r.rid == poisoned_rid else "ok"
            for r in res}
    if statuses != want:
        raise AssertionError(f"{name}: statuses {statuses}")
    bad = res[poisoned_rid].tokens
    if (kept is not None and len(bad) != kept) or not bad \
            or bad != clean[poisoned_rid][:len(bad)]:
        raise AssertionError(f"{name}: the poisoned request kept {len(bad)} "
                             f"tokens, not a clean prefix of {kept}")
    rids = [r.rid for r in res if r.rid != poisoned_rid]
    if bitwise is not None:
        rids = [i for i in rids if i in bitwise]
    diff = [i for i in rids if res[i].tokens != clean[i]]
    if diff:
        raise AssertionError(f"{name}: healthy requests {diff} differ from "
                             "the clean run's tokens")
    return len(bad)


def resilience(torch, cfg, params, engines, card):
    """Phase 23, bf16, the serve cell of phase 21 (8 requests on 4 slots,
    prompt 512, 64 new tokens, graphs): the resilience slice on the card,
    held to phase 21's clean graph runs (`engines`, from graph_gates).

      * plan off: a FaultPlan() engine's two runs equal the plan-less
        graph engine's: tokens bitwise, launch counts, keys captured,
        replays;
      * logit poison: NaN on slot 1 at token 3 (sequential) and +Inf
        (speculative, k=4): the poisoned request keeps exactly the clean
        run's first 3 tokens, the others are bitwise the clean run's; each
        engine serves twice (the second run's fault fires again, now inside
        replayed graphs); kernel #1 launches once a layer and step, #2 as
        in phase 3;
      * corrupt drafts on slot 0: the clean speculative run's tokens,
        bitwise, on every request;
      * cache poison on slot 1 at token 3, contiguous and paged with a
        shared prefix: only that request is poisoned; its prefix sharers
        stay ok and bitwise;
      * the step down: decode_impl="pallas" with fail_pallas_dispatch,
        sequential and speculative: one kernel_fallbacks, one
        pallas_fallback event, one warning, decode_impl "ref", no fused
        decode launch, kernel #2's launches as usual, tokens bitwise a
        decode_impl="ref" engine's; the flag cleared in a finally;
      * backpressure and deadlines: max_pending=4 rejects 4 of 8 ("queue
        overflow"); a deadline already past expires in the queue with no
        tokens; a deadline of the warm prefill batch plus 4 decode blocks
        ends its live request with 0 < tokens < 64; stats and the bus
        agree.

    Then the cost of a logit-fault plan's select and countdown (decode and
    verify ms a step, plan against no plan, in turns of 4, untraced), the
    degraded engines' decode and verify steps against the kernel
    engines', the capture time after the step down, and the degraded
    run's TTFT and TPOT. Returns a summary."""
    import warnings
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_decode as SD
    from repro_torch.serving import faults as F
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.faults import FaultPlan
    t_phase = time.perf_counter()
    if "pallas_fallback" in [e["kind"] for e in F.consume_events()]:
        raise AssertionError("resilience: a pallas_fallback event before "
                             "phase 23")
    n_new, layers = MAIN["new_tokens"], cfg.num_layers
    passes = 2 if cfg.attention.num_global else 1
    clean = {c: engines[c][3][1][0] for c in ("default", "speculative",
                                                 "paged_shared")}
    prompts = {c: engines[c][2] for c in clean}
    out = {}

    def make(cell, **kw):
        return ServingEngine(cfg, params, batch_slots=4,
                             max_len=MAIN["max_len"], scan_steps=8,
                             graphs=True, **_cell_kw(cell), **kw)

    def reqs(cell, **kw):
        return [Request(rid=i, prompt=p, max_new_tokens=n_new, **kw)
                for i, p in enumerate(prompts[cell])]

    def launches(st_):
        return {"swat_decode": layers * st_["decode_steps"],
                "swat_attention_fwd": layers * passes
                * st_["prefill_batches"]}

    # plan off is production
    eng = make("default", faults=FaultPlan())
    for i, (want, w_counts, w_keys, w_replays) in enumerate(
            engines["default"][3]):
        c0, r0 = len(eng._compiled.captured), eng._compiled.replays
        got, counts, _, _ = _serve_on(torch, eng, prompts["default"], n_new)
        got_ = (got, counts, eng._compiled.captured[c0:],
                eng._compiled.replays - r0)
        if got_ != (want, w_counts, w_keys, w_replays):
            raise AssertionError(f"resilience plan off run {i}: tokens, "
                                 "launches, keys or replays differ from the "
                                 "plan-less graph engine's")
    out["plan_off_equals_no_plan"] = True

    # logit poison, sequential and speculative, each served twice
    plan_engines = {}
    for cell, kind in (("default", "nan"), ("speculative", "inf")):
        eng = make(cell, faults=FaultPlan(poison_logits=((1, 3, kind),)))
        runs = []
        for i in range(2):
            # each run's slot-1 occupant is the entry's first target; in
            # the second run every key of its first block is captured, so
            # the fault fires inside a replayed graph
            eng._faults_fired.clear()
            c0, r0 = len(eng._compiled.captured), eng._compiled.replays
            SD.LAUNCHES.reset()
            SA.LAUNCHES.reset()
            res, _, st_, _ = _run_requests(torch, eng, reqs(cell))
            got = {"swat_decode": SD.LAUNCHES.n,
                   "swat_attention_fwd": SA.LAUNCHES.n}
            if got != launches(st_):
                raise AssertionError(f"resilience {cell} poison: launches "
                                     f"{got}, expected {launches(st_)}")
            kept = _resilience_gate(f"resilience {cell} {kind} run {i}", res,
                                    clean[cell], 1, kept=3)
            if st_["quarantined"] != 1:
                raise AssertionError(f"resilience {cell}: quarantined "
                                     f"{st_['quarantined']}")
            runs.append({"kept": kept, "launches": got,
                         "captured": len(eng._compiled.captured) - c0,
                         "replays": eng._compiled.replays - r0})
        if not runs[1]["replays"]:
            raise AssertionError(f"resilience {cell}: no replay in the "
                                 "second run")
        no_step_down(eng, f"resilience {cell} poison")
        plan_engines[cell] = eng
        out[f"logit_poison_{cell}"] = runs

    # corrupt drafts
    eng = make("speculative", faults=FaultPlan(corrupt_draft_slots=(0,)))
    res, _, st_, _ = _run_requests(torch, eng, reqs("speculative"))
    diff = [r.rid for r in res
            if r.status != "ok" or r.tokens != clean["speculative"][r.rid]]
    if diff or not eng._compiled.replays:
        raise AssertionError(f"resilience corrupt drafts: requests {diff} "
                             "differ from the clean speculative run's")
    out["corrupt_drafts"] = {"tokens_bitwise_clean": True,
                             "draft_accepted": st_["draft_accepted"],
                             "replays": eng._compiled.replays}

    # cache poison: contiguous, and paged with a shared prefix (rids 0-3
    # are admitted together and share their prefix blocks)
    for cell in ("default", "paged_shared"):
        eng = make(cell, faults=FaultPlan(poison_cache=((1, 3),)))
        res, _, st_, _ = _run_requests(torch, eng, reqs(cell))
        kept = _resilience_gate(
            f"resilience cache poison {cell}", res, clean[cell], 1,
            bitwise=(0, 2, 3) if cell == "paged_shared" else None)
        out[f"cache_poison_{cell}"] = {
            "kept": kept, "prefill_prefix_shared":
            st_["prefill_prefix_shared"],
            "later_requests_bitwise": sum(
                res[i].tokens == clean[cell][i] for i in range(4, 8))}
        no_step_down(eng, f"resilience cache poison {cell}")
    kinds = [e["kind"] for e in F.consume_events()]
    if "pallas_fallback" in kinds:
        raise AssertionError("resilience: a step down before the step-down "
                             "cell")

    # the step down, sequential and speculative
    degraded = {}
    for cell in ("default", "speculative"):
        ref = make(cell, decode_impl="ref")
        want, _, _, _ = _run_requests(torch, ref, reqs(cell))
        no_step_down(ref, f"resilience ref {cell}", impl="ref")
        F.consume_events()
        try:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                eng = make(cell, decode_impl="pallas",
                           faults=FaultPlan(fail_pallas_dispatch=True))
                SD.LAUNCHES.reset()
                SA.LAUNCHES.reset()
                records0 = len(eng.tracer.records)
                res, _, st_, wall = _run_requests(torch, eng, reqs(cell))
        finally:
            F.clear_kernel_failure()
        got = {"swat_decode": SD.LAUNCHES.n,
               "swat_attention_fwd": SA.LAUNCHES.n}
        kinds = [e["kind"] for e in F.consume_events()]
        warned = [x for x in w if issubclass(x.category, RuntimeWarning)
                  and "plain version" in str(x.message)]
        diff = [r.rid for r in res
                if r.status != "ok" or r.tokens != want[r.rid].tokens]
        if (eng.stats["kernel_fallbacks"] != 1 or eng.decode_impl != "ref"
                or kinds.count("pallas_fallback") != 1 or len(warned) != 1
                or got["swat_decode"] != 0
                or got["swat_attention_fwd"]
                != launches(st_)["swat_attention_fwd"] or diff):
            raise AssertionError(
                f"resilience step down {cell}: kernel_fallbacks "
                f"{eng.stats['kernel_fallbacks']}, decode_impl "
                f"{eng.decode_impl!r}, events {kinds}, {len(warned)} "
                f"warnings, launches {got}, requests {diff} differ from the "
                "ref engine's")
        degraded[cell] = eng
        out[f"step_down_{cell}"] = {
            "kernel_fallbacks": 1, "pallas_fallback_events": 1,
            "warnings": 1, "decode_impl": eng.decode_impl,
            "launches": got, "tokens_bitwise_ref_engine": True,
            "capture_s_after_step_down": eng._compiled.capture_s,
            "graphs_captured_after_step_down": len(eng._compiled.captured),
            "wall_s": wall,
            "latency_ms": _latency_ms(list(eng.tracer.records)[records0:])}

    # backpressure and deadlines, on a warm block time
    warm = plan_engines["default"]
    st_ = _serve_on(torch, warm, prompts["default"][:4], n_new)[2]
    block_s = st_["decode_s"] / st_["decode_steps"] * 8
    live_deadline = st_["prefill_s"] / st_["prefill_batches"] + 4 * block_s
    eng = make("default", max_pending=4)
    rq = reqs("default")
    rq[2] = Request(rid=2, prompt=rq[2].prompt, max_new_tokens=n_new,
                    deadline=0.0)
    rq[3] = Request(rid=3, prompt=rq[3].prompt, max_new_tokens=n_new,
                    deadline=live_deadline)
    res, _, st_, _ = _run_requests(torch, eng, rq)
    kinds = [e["kind"] for e in F.consume_events()]
    statuses = [r.status for r in res]
    over = [r.rid for r in res if "queue overflow" in r.reason]
    if (statuses != ["ok", "ok", "deadline", "deadline"] + ["rejected"] * 4
            or over != [4, 5, 6, 7] or res[2].tokens
            or not 0 < len(res[3].tokens) < n_new
            or st_["rejected"] != 4 or kinds.count("request_rejected") != 4
            or st_["deadline"] != 2
            or kinds.count("deadline_expired") != 2):
        raise AssertionError(
            f"resilience deadlines: statuses {statuses}, overflow {over}, "
            f"tokens {[len(r.tokens) for r in res]}, stats rejected "
            f"{st_['rejected']} deadline {st_['deadline']}, events {kinds}")
    no_step_down(eng, "resilience deadlines")
    out["deadlines"] = {"statuses": statuses,
                        "live_deadline_ms": live_deadline * 1e3,
                        "live_request_tokens": len(res[3].tokens),
                        "bus_agrees_with_stats": True}

    # costs, in turns of 4 (untraced; engines warmed on the 4 prompts)
    turns = {}
    for cell, unit in (("default", "decode"), ("speculative", "verify")):
        kernel = engines[cell][1]
        pairs = (("fault plan", plan_engines[cell], "no plan"),
                 ("degraded", degraded[cell], "kernel"))
        for a_name, a, b_name in pairs:
            for e in (a, kernel):
                _serve_on(torch, e, prompts[cell][:4], n_new, healthy=False)
            t = {a_name: [], b_name: []}
            for name in (b_name, a_name, a_name, b_name) * 2:
                st_ = _serve_on(torch, a if name == a_name else kernel,
                                prompts[cell][:4], n_new, healthy=False)[2]
                t[name].append(st_["decode_s"] * 1e3 / st_["decode_steps"])
            t[f"{a_name}_over_{b_name}"] = sum(t[a_name]) / sum(t[b_name])
            turns[f"{unit} ms a step, {a_name} vs {b_name}"] = t
        no_step_down(kernel, f"resilience turns {cell}")
        no_step_down(plan_engines[cell], f"resilience turns {cell}")
    out["turns"] = turns
    for name, t in turns.items():
        log(f"resilience {name} (bf16, in turns; {card}): {json.dumps(t)}")
    for cell in ("default", "speculative"):
        sd = out[f"step_down_{cell}"]
        lat = sd["latency_ms"]
        log(f"resilience degraded {cell} run ({card}): capture after the "
            f"step down {sd['capture_s_after_step_down']:.3f} s over "
            f"{sd['graphs_captured_after_step_down']} graphs; ttft p50 "
            f"{lat['ttft']['p50']:.3f} p95 {lat['ttft']['p95']:.3f} ms, "
            f"tpot p50 {lat['tpot']['p50']:.3f} p95 "
            f"{lat['tpot']['p95']:.3f} ms")
    if "pallas_fallback" in [e["kind"] for e in F.consume_events()]:
        raise AssertionError("resilience: a step down in the timed turns")
    log(f"resilience phase: {time.perf_counter() - t_phase:.1f}s")
    return out


# ------------------------------------------------------------ phase 24 ---

# granite-moe-1b-a400m + SWAT at full width and depth (24 layers, d_model
# 1024, 16 q over 8 kv heads: group 2, head dim 64, 32 experts top-8 of
# width 512, tied 49155-row vocab), phase 3's window and globals; its
# kernel shapes at phase 3's 4 slots
GRANITE = dict(b=MAIN["b"], hq=16, hkv=8, d=64)
MOE_CELLS = ("default", "chunked", "speculative")


def granite_cfg(dtype_name="bfloat16"):
    import dataclasses
    from repro_torch.configs import get_config, with_swat
    cfg = with_swat(get_config("granite-moe-1b-a400m"),
                    window=MAIN["window"], num_global=MAIN["num_global"])
    return dataclasses.replace(cfg, dtype=dtype_name)


def moe_kernels(torch, spec, shape=GRANITE, tag="granite", chunk=True):
    """Kernels #1 and #2 at a model's attention shape (granite-moe's by
    default: 4 slots, 16 q over 8 kv heads, D=64; phase 25: jamba's 64 q
    over 8 kv heads, D=128), bf16 and fp32: the fused decode at T=1 and
    at T=5 on a lookahead ring (wrapped), caches bitwise its plain
    version's and outputs within TOL, one launch a call; the banded
    forward on the L=512 band (O within TOL, LSE within 1e-3, on its
    route; both passes composed by ops.swat_attention against the plain
    path) and, with `chunk` (a chunkable model), on a prefill chunk at
    pos0 448 (`_check_chunk_case`). Returns the largest error of each
    check."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_decode as SD
    gen = torch.Generator(device="cuda").manual_seed(24)
    b, hq, hkv, d = (shape[k] for k in ("b", "hq", "hkv", "d"))
    l, errs = MAIN["prompt"], {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for t in (1, SPEC_K + 1):
            q, kc, vc, nk, nv, pos, nn, cap = _ring_inputs(
                torch, gen, dtype, b, hq // hkv, hkv, t, d,
                [600, 261, 1037, 5000])
            want, kw, vw = SD.swat_decode_fused_plain(
                q, kc, vc, nk, nv, pos, nn, spec, ring_cap=cap)
            n0 = SD.LAUNCHES.n
            got = SD.swat_decode_fused(q, kc, vc, nk, nv, pos, nn, spec,
                                       ring_cap=cap)
            torch.cuda.synchronize()
            name = f"{tag} swat_decode {dn} T={t} group {hq // hkv}"
            if SD.LAUNCHES.n - n0 != 1:
                raise AssertionError(f"{name}: {SD.LAUNCHES.n - n0} launches")
            if not (torch.equal(kc, kw) and torch.equal(vc, vw)):
                raise AssertionError(f"{name}: caches not bitwise equal to "
                                     "the plain version")
            errs[f"decode {dn} T={t}"] = max(
                check_close(name, got[i, :, :int(nn[i])],
                            want[i, :, :int(nn[i])], dn) for i in range(b))
        mk = lambda *s: torch.randn(*s, generator=gen,
                                    device="cuda").to(dtype)
        q, k, v = mk(b, hq, l, d), mk(b, hkv, l, d), mk(b, hkv, l, d)
        pat = ops.get_pattern(spec, l, l, 128, 128)
        want, wl = SA.banded_plain(q, k, v, spec, pat, d ** -0.5,
                                   return_lse=True)
        before = route_counts()
        got, gl = SA.swat_attention_fwd(q, k, v, spec, pattern=pat,
                                        return_lse=True)
        torch.cuda.synchronize()
        name = f"{tag} swat_attention_fwd {dn} L={l}"
        check_route(name, before, "fwd", expected_route(dtype, d, "fwd"))
        err = check_close(name, got, want, dn)
        check_close(name + " lse", gl, wl, dn, atol=1e-3, rtol=1e-4)
        got = ops.swat_attention(q, k, v, spec, impl="kernel")
        want = ops.swat_attention(q, k, v, spec, impl="banded")
        torch.cuda.synchronize()
        errs[f"band {dn}"] = max(err, check_close(
            name + " both passes", got, want, dn))
        if chunk:
            cap = MAIN["window"] + 1 + MAIN["num_global"]
            errs[f"chunk {dn}"] = _check_chunk_case(
                torch, gen, dtype, (f"{tag} pos0=448", spec, b, hq, hkv, d,
                                    CHUNK, 448, cap, 320))
    log(f"{tag} kernels (#1 at group {hq // hkv}, D={d}, T=1 and T=5; #2 on "
        "the L=512 band" + (" and a chunk at pos0 448" if chunk else "")
        + "; bf16 and fp32): caches bitwise, within tolerance, each launch "
        f"counted on its route: {json.dumps(errs)}")
    return errs


def _kept_tokens(torch, ids, e, cap):
    """(T,) bool: tokens none of whose k routed slots the sort dispatch
    drops (rank within the expert, in the stable sort's order, below
    cap)."""
    import torch.nn.functional as F
    flat = ids.reshape(-1)
    rank = (F.one_hot(flat, e).cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    return (rank < cap).reshape(ids.shape).all(-1)


def moe_layer(torch, cfg, params):
    """The port's moe_ffn on the card against the same function on the CPU
    and against moe_ffn_dense_ref on the card (tokens the sort dispatch
    keeps whole): the serving shape ("dense", 4 slots, T=1 and T=512) and
    the training shape ("sort" with its aux loss, B=4, L=2048), bf16 and
    fp32, layer 0's router with experts drawn at the fan-in of their
    contraction (outputs O(1), where the reference's elementwise
    tolerances apply); then layer 0's own experts (the JAX package's
    draw, fan-in E: outputs of |y| ~ 20-70, where one bf16 ulp is up to
    0.5) at the serving shapes, the error measured against the output's
    RMS (MOE_RMS_LIMIT). Inputs are unit-RMS rows, as the layer's norm
    gives it."""
    import dataclasses
    from repro_torch.core import moe as M
    spec, d, f, e = cfg.moe, cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    gen = torch.Generator(device="cuda").manual_seed(25)
    own = params["blocks"][0]["l0"]["moe"]
    unit = {"router": own["router"],
            "w1": torch.randn(e, d, f, generator=gen, device="cuda")
            * d ** -0.5,
            "w3": torch.randn(e, d, f, generator=gen, device="cuda")
            * d ** -0.5,
            "w2": torch.randn(e, f, d, generator=gen, device="cuda")
            * f ** -0.5}
    shapes = (("decode", "dense", GRANITE["b"], 1),
              ("prefill", "dense", GRANITE["b"], MAIN["prompt"]),
              ("train", "sort", TRAIN["b"], TRAIN["seq"]))
    out = {}
    for wname, weights, dtypes, cases in (
            ("fan-in experts", unit, (torch.bfloat16, torch.float32),
             shapes),
            ("layer 0's experts", own, (torch.bfloat16,), shapes[:2])):
        for dtype in dtypes:
            dn = str(dtype).split(".")[-1]
            w = {k: v if k == "router" else v.to(dtype)
                 for k, v in weights.items()}
            wc = {k: v.cpu() for k, v in w.items()}
            for tag, disp, bb, ll in cases:
                x = torch.randn(bb, ll, d, generator=gen, device="cuda")
                x = (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))
                     ).to(dtype)
                aux = disp == "sort"
                got, ga = M.moe_ffn(w, x, spec, dispatch=disp,
                                    return_aux=aux)
                want, wa = M.moe_ffn(wc, x.cpu(), spec, dispatch=disp,
                                     return_aux=aux)
                name = f"moe_ffn {wname} {dn} {tag} ({disp})"
                row = {}
                if wname == "layer 0's experts":
                    rms = float(want.float().pow(2).mean().sqrt())
                    row["cpu_max_abs_err"] = max_err(got.cpu(), want)
                    row["out_rms"] = rms
                    row["cpu_err_over_rms"] = row["cpu_max_abs_err"] / rms
                    # the controls: 7 significant bits instead of bf16's
                    # 8, and top-(k-1) routing
                    m, ex = torch.frexp(got.float())
                    short = torch.ldexp(torch.round(m * 128) / 128, ex)
                    row["one_bit_short_over_rms"] = max_err(
                        short.cpu(), want) / rms
                    fewer, _ = M.moe_ffn(w, x, dataclasses.replace(
                        spec, top_k=spec.top_k - 1), dispatch=disp,
                        return_aux=False)
                    row["top_k_minus_1_over_rms"] = max_err(
                        fewer.cpu(), want) / rms
                    row["limit"] = MOE_RMS_LIMIT
                    if not (row["cpu_err_over_rms"] <= MOE_RMS_LIMIT
                            < row["top_k_minus_1_over_rms"]):
                        raise AssertionError(f"{name}: {row}")
                    out[name] = row
                    continue
                row["cpu"] = check_close(name + " vs CPU", got.cpu(), want,
                                         dn)
                if aux:
                    row["aux"] = float(ga)
                    check_close(name + " aux vs CPU", ga.cpu(), wa,
                                "float32")
                xf = x.reshape(-1, d)
                _, _, ids = M._route(w, xf, spec.top_k)
                t = xf.shape[0]
                cap = int(max(spec.top_k, min(t, round(
                    t * spec.top_k * 1.25 / e)))) if aux else t
                kept = _kept_tokens(torch, ids, e, cap)
                ref = M.moe_ffn_dense_ref(w, x, spec).reshape(-1, d)
                row["tokens_kept"] = int(kept.sum())
                row["tokens"] = t
                row["ref"] = check_close(name + " vs dense ref",
                                         got.reshape(-1, d)[kept],
                                         ref[kept], dn)
                out[name] = row
            del wc
    torch.cuda.synchronize()
    log("granite moe_ffn on the card: " + json.dumps(out))
    return out


def _moe_counter_index():
    from repro_torch.kernels import _build
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_decode as SD
    return {k: _build._COUNTERS.index(c) for k, c in (
        ("swat_decode", SD.LAUNCHES), ("swat_decode_plain",
                                       SD.PLAIN_LAUNCHES),
        ("swat_attention_fwd", SA.LAUNCHES),
        ("fwd_tc", SA.ROUTE_LAUNCHES["tc"]),
        ("fwd_simt", SA.ROUTE_LAUNCHES["simt"]))}


def moe_serve(torch, cfg, params):
    """Phase 3's cell and phase 21's chunked (64) and speculative (k=4)
    cells on granite-moe + SWAT, bf16: an eager engine (graphs=False)
    serves the 8 requests once and a graph engine twice (its first run
    captures, its second only replays). Each graph run's tokens bitwise
    the eager run's, every launch counter and step count equal; on the
    replay run #1 launches once per layer and decode or verify step and
    #2 as phase 3's formula gives (`_fwd_launches_per_batch`), every
    forward launch on the tensor-core route and no plain decode launch;
    every engine takes no step down. Then the warm graph engine of each
    cell serves the first 4 requests three times (decode or verify ms a
    step, prefill ms a batch). Returns {cell: summary}."""
    import numpy as np
    from repro_torch.serving.engine import ServingEngine
    idx = _moe_counter_index()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (MAIN["prompt"],))
               .astype(np.int32) for _ in range(8)]
    keys = ("decode_steps", "spec_steps", "prefill_batches", "tokens_emitted")
    layers, g = cfg.num_layers, cfg.attention.num_global
    out = {}
    for cell in MOE_CELLS:
        make = lambda graphs: ServingEngine(
            cfg, params, batch_slots=4, max_len=MAIN["max_len"],
            scan_steps=8, graphs=graphs, **_cell_kw(cell))
        eager, graph = make(False), make(True)
        want, w_counts, w_st, w_wall = _serve_on(torch, eager, prompts,
                                                 MAIN["new_tokens"])
        if any(len(t) != MAIN["new_tokens"] for t in want):
            raise AssertionError(f"granite {cell}: token counts "
                                 f"{[len(t) for t in want]}")
        runs = []
        for run in ("capture", "replay"):
            captured0 = len(graph._compiled.captured)
            got, counts, st, wall = _serve_on(torch, graph, prompts,
                                              MAIN["new_tokens"])
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            if bad:
                raise AssertionError(f"granite {cell} ({run}): graph tokens "
                                     f"differ from eager on requests {bad}")
            if counts != w_counts or any(st[k] != w_st[k] for k in keys):
                raise AssertionError(f"granite {cell} ({run}): launches "
                                     f"{counts} / eager {w_counts}, stats "
                                     f"{st} / eager {w_st}")
            runs.append((len(graph._compiled.captured) - captured0, st,
                         wall))
        if runs[1][0]:
            raise AssertionError(f"granite {cell}: {runs[1][0]} captures in "
                                 "the replay run")
        st = runs[1][1]
        launches = {k: w_counts[idx[k]] for k in ("swat_decode",
                                                  "swat_attention_fwd")}
        expected = {"swat_decode": layers * st["decode_steps"],
                    "swat_attention_fwd": layers * _fwd_launches_per_batch(
                        graph, MAIN["prompt"], g) * st["prefill_batches"]}
        if (launches != expected or w_counts[idx["swat_decode_plain"]]
                or w_counts[idx["fwd_simt"]]
                or w_counts[idx["fwd_tc"]] != launches["swat_attention_fwd"]):
            raise AssertionError(
                f"granite {cell}: launches {launches}, expected {expected} "
                f"(plain decode {w_counts[idx['swat_decode_plain']]}, "
                f"SIMT forward {w_counts[idx['fwd_simt']]})")
        latency = _latency_ms(list(graph.tracer.records)[-len(prompts):])
        warm = [_serve_on(torch, graph, prompts[:4], MAIN["new_tokens"])[2]
                for _ in range(3)]
        n_tok = sum(len(t) for t in want)
        out[cell] = {
            "tokens_bitwise_eager": True, "launches": launches,
            "graphs_captured": len(graph._compiled.captured),
            "eager_decode_ms_per_step": w_st["decode_s"] * 1e3
            / w_st["decode_steps"],
            "replay_run_decode_ms_per_step": st["decode_s"] * 1e3
            / st["decode_steps"],
            "replay_run_prefill_ms_per_batch": st["prefill_s"] * 1e3
            / st["prefill_batches"],
            "replay_run_tok_per_s": n_tok / runs[1][2],
            "warm_decode_ms_per_step": [s_["decode_s"] * 1e3
                                        / s_["decode_steps"] for s_ in warm],
            "warm_prefill_ms_per_batch": [s_["prefill_s"] * 1e3
                                          / s_["prefill_batches"]
                                          for s_ in warm],
            "tokens_per_step_per_slot": st["tokens_emitted"]
            / (st["decode_steps"] * 4),
            "spec_steps": st["spec_steps"],
            "draft_proposed": st["draft_proposed"],
            "draft_accepted": st["draft_accepted"],
            "latency_ms_replay_run": latency}
        log(f"granite serve {cell} (bf16): " + json.dumps(out[cell]))
    return out


def _moe_trace(torch, cfg, params):
    """An eager decode block (graphs=False: a replayed graph links no
    kernel to the op that launched it) traced with the port's moe_ffn
    inside a profiler range: the device time a decode step by kernel
    category, and the time of the kernels that the ops inside the range
    launched (the router, top-k, gates and the experts' products), against
    all kernels linked to an op in the decode blocks. One fused decode
    launch a layer and step and no plain one (the wrappers' counters)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core import moe as M
    from repro_torch.kernels import swat_decode as SD
    from repro_torch.serving.engine import Request, ServingEngine
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, (MAIN["prompt"],))
               for _ in range(4)]
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=MAIN["max_len"],
                        scan_steps=8, graphs=False)
    reqs = lambda: [Request(rid=i, prompt=p, max_new_tokens=9)
                    for i, p in enumerate(prompts)]
    eng.run(reqs())
    ffn = M.moe_ffn

    def named(*a, **kw):
        with record_function("moe_ffn"):
            return ffn(*a, **kw)

    steps0 = eng.stats["decode_steps"]
    launches0 = (SD.LAUNCHES.n, SD.PLAIN_LAUNCHES.n)
    torch.cuda.synchronize()
    M.moe_ffn = named
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.run(reqs())
            torch.cuda.synchronize()
    finally:
        M.moe_ffn = ffn
    no_step_down(eng, "granite trace")
    steps = eng.stats["decode_steps"] - steps0
    fused_n = SD.LAUNCHES.n - launches0[0]
    if fused_n != cfg.num_layers * steps or SD.PLAIN_LAUNCHES.n != \
            launches0[1]:
        raise AssertionError(f"granite trace: {fused_n} fused decode "
                             f"launches in {steps} steps of "
                             f"{cfg.num_layers} layers")
    dt = torch.autograd.DeviceType
    ev = prof.events()
    blocks = [e.time_range for e in ev if e.name == "engine.decode_block"
              and e.device_type == dt.CPU]
    inside = lambda r: any(b.start <= r.start <= b.end for b in blocks)
    # the profiler ranges appear on the device too: they are not kernels
    kernels = [e for e in ev if e.device_type == dt.CUDA
               and e.name != "moe_ffn" and not e.name.startswith("engine.")
               and inside(e.time_range)]
    ranges = [e for e in ev if e.name == "moe_ffn"
              and e.device_type == dt.CPU and inside(e.time_range)]
    ops = [e for e in ev if e.device_type == dt.CPU and e.name != "moe_ffn"
           and inside(e.time_range)]
    moe_us = sum(k.duration for e in ops
                 if any(r.thread == e.thread
                        and r.time_range.start <= e.time_range.start
                        and e.time_range.end <= r.time_range.end
                        for r in ranges)
                 for k in e.kernels)
    linked_us = sum(k.duration for e in ops for k in e.kernels)
    per = max(1, steps)
    out = {"eager_decode_steps": steps, "fused_decode_launches": fused_n,
           "moe_ranges": len(ranges)}
    if not kernels or not linked_us:
        out["device_time"] = "not measured (no kernel traced in the blocks)"
        return out
    by_cat = {}
    for e in kernels:
        name = e.name.lower()
        cat = next((c for c, keys in _CATEGORIES
                    if any(k in name for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + e.time_range.elapsed_us() / 1e3
    out.update({
        "kernels_per_step": len(kernels) / per,
        "device_ms_per_step_by_category": {
            k: v / per for k, v in sorted(by_cat.items())},
        "moe_ffn_device_ms_per_step": moe_us / 1e3 / per,
        "op_linked_device_ms_per_step": linked_us / 1e3 / per,
        "moe_share_of_linked": moe_us / linked_us})
    return out


def moe_fp32(torch):
    """fp32 at full width and depth: the kernel engine (graphs) serves
    phase 3's cell, and the plain path (model.prefill and
    model.decode_step, impl "banded") runs the same two admission waves of
    4 greedily; every request's 64 tokens must be equal. Then phase 4's
    kernel-vs-plain gate (`end_to_end`) on the same model."""
    import numpy as np
    from repro_torch.core import model as Mod
    from repro_torch.serving.engine import ServingEngine
    cfg = granite_cfg("float32")
    params = Mod.init_model(cfg, seed=0, device="cuda")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (MAIN["prompt"],))
               .astype(np.int32) for _ in range(8)]
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=MAIN["max_len"],
                        scan_steps=8)
    got = _serve_on(torch, eng, prompts, MAIN["new_tokens"])[0]
    want = []
    for w in range(2):
        tok = torch.as_tensor(np.stack(prompts[4 * w:4 * w + 4]),
                              device="cuda")
        logits, caches = Mod.prefill(params, cfg, {"tokens": tok},
                                     MAIN["max_len"], impl="banded")
        nxt = logits[:, 0].argmax(-1)
        toks = [nxt]
        for _ in range(MAIN["new_tokens"] - 1):
            logits, caches = Mod.decode_step(params, cfg,
                                             {"tokens": nxt[:, None]},
                                             caches, impl="banded")
            nxt = logits[:, 0].argmax(-1)
            toks.append(nxt)
        want += torch.stack(toks, 1).tolist()
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    out = {"layers": cfg.num_layers, "requests": len(prompts),
           "tokens_equal": not bad, "requests_differing": bad}
    log("granite fp32 kernel engine vs plain path: " + json.dumps(out))
    if bad:
        first = [next(j for j, (a, b) in enumerate(zip(got[i], want[i]))
                      if a != b) for i in bad]
        raise AssertionError(f"granite fp32: kernel engine tokens differ "
                             f"from the plain path's on requests {bad} "
                             f"from steps {first}")
    # phase 4's gate at full depth in fp32
    out["e2e"] = end_to_end(torch, cfg, params, got)
    del params, eng
    torch.cuda.empty_cache()
    return out


def moe_train(torch, cfg):
    """Two AdamW steps of granite-moe + SWAT at full width and depth
    (`train`: B=4, L=2048, sort dispatch with the aux loss, remat "nothing"
    as in phase 8, launches as phase 8 counts them). Then the kernel path
    against the plain path: on the trained bf16 params at full depth the
    loss, |dloss| <= TRAIN_LOSS_BOUND; in fp32 at full width and 4 layers
    (as phase 9) |dloss| <= TRAIN_LOSS_BOUND and every leaf's relative
    gradient error, experts and routers included, <= TRAIN_GRAD_BOUND.
    (bf16 gradients are not compared here: the random experts' gain makes
    two plain versions' bf16 gradients differ as much as the kernel
    path's; the bf16 dQ and dK/dV kernels at granite's heads are held
    against their plain version in phase 7.) Returns (summary, launches,
    the two comparisons)."""
    import dataclasses
    from repro_torch.core import model as Mod
    summary, launches, (params, opt, _, batch) = train(torch, cfg, n=2)
    del opt
    with torch.no_grad():
        bf = [float(Mod.loss_fn(params, cfg, batch, impl=impl)[1]["loss"])
              for impl in ("kernel", "banded")]
    e2e = {"bf16 loss kernel/banded": {"loss": bf[0],
                                       "loss_diff": abs(bf[0] - bf[1])}}
    del params
    torch.cuda.empty_cache()
    cfg4 = dataclasses.replace(cfg, dtype="float32", num_layers=4)
    p4 = Mod.init_model(cfg4, seed=0, device="cuda")
    b4 = _train_batches(torch, cfg4, 1)[0]
    e2e["fp32 4 layers kernel/banded"] = f4 = _grad_gap(
        p4, *(_loss_grads(torch, p4, cfg4, b4, impl)
              for impl in ("kernel", "banded")))
    del p4
    torch.cuda.empty_cache()
    log("granite train kernel vs plain: " + json.dumps(e2e))
    if not (e2e["bf16 loss kernel/banded"]["loss_diff"] <= TRAIN_LOSS_BOUND
            and f4["loss_diff"] <= TRAIN_LOSS_BOUND
            and f4["max_leaf_rel_grad_err"] <= TRAIN_GRAD_BOUND):
        raise AssertionError(f"granite train kernel vs plain: {e2e}")
    return summary, launches, e2e


def moe(torch, card, llama_turns):
    """Phase 24: granite-moe-1b-a400m + SWAT on the card (see the module
    docstring). Returns a summary with each path's launch counts."""
    from repro_torch import tree
    from repro_torch.core import model as Mod
    from repro_torch.core import moe as M
    t_phase = time.perf_counter()
    split = {}

    def lap(name):
        split[name] = time.perf_counter() - t_phase - sum(split.values())

    cfg = granite_cfg()
    spec = cfg.attention
    kerr = moe_kernels(torch, spec)
    lap("kernels")
    params = Mod.init_model(cfg, seed=0, device="cuda")
    layer = moe_layer(torch, cfg, params)
    lap("moe_ffn")
    cells = moe_serve(torch, cfg, params)
    lap("serve cells")
    trace = _moe_trace(torch, cfg, params)
    lap("trace")
    # the decode step's byte bound: every weight read once (the dense
    # dispatch reads all experts), the rings' K and V rows, the logits out
    cap = MAIN["window"] + 1 + MAIN["num_global"]
    w_bytes = sum(p.numel() * p.element_size() for p in tree.leaves(params))
    kv_bytes = (cfg.num_layers * GRANITE["b"] * GRANITE["hkv"] * cap
                * GRANITE["d"] * 2 * 2)
    step_bound_ms = (w_bytes + kv_bytes + GRANITE["b"] * cfg.vocab_size * 4
                     ) / HBM_BYTES_PER_S * 1e3
    own = params["blocks"][0]["l0"]["moe"]
    xd = torch.randn(GRANITE["b"], 1, cfg.d_model, device="cuda").to(
        torch.bfloat16)
    moe_ms = time_ms(torch, lambda: M.moe_ffn(own, xd, cfg.moe,
                                              dispatch="dense",
                                              return_aux=False))
    moe_bound = bound(sum(own[k].numel() * own[k].element_size()
                          for k in own), 0)
    times = {"decode": time_decode(torch, spec, shape=GRANITE),
             "verify": time_decode(torch, spec, t=SPEC_K + 1,
                                   shape=GRANITE),
             "band": time_banded(torch, spec, shape=GRANITE)}
    del params
    torch.cuda.empty_cache()
    lap("times")
    fp32 = moe_fp32(torch)
    lap("fp32")
    tr, _, tr_e2e = moe_train(torch, cfg)
    lap("train")
    times["backward"] = time_backward(torch, spec, shape=GRANITE)
    lap("backward times")
    graph_ms = cells["default"]["warm_decode_ms_per_step"]
    llama_ms = llama_turns["default ms a step"]["graphs"]
    out = {"kernel_errors": kerr, "moe_layer": layer, "cells": cells,
           "trace": trace, "fp32": fp32, "train": tr,
           "train_e2e": tr_e2e,
           "times": times, "step_bound_ms": step_bound_ms,
           "phase_s": time.perf_counter() - t_phase, "phase_split_s": split}
    lat = cells["default"]["latency_ms_replay_run"]
    log(f"granite decode ms a step with graphs (warm, 4 slots; {card}): "
        f"{graph_ms}, byte bound {step_bound_ms:.4f} ms ({w_bytes / 1e9:.3f}"
        f" GB of weights, {kv_bytes / 1e6:.1f} MB of rings); llama phase 21 "
        f"graphs {llama_ms}")
    log(f"granite traced eager decode step, MoE named ({card}): "
        + json.dumps(trace))
    log(f"granite moe_ffn at the decode shape (dense, 4 x 1 tokens, bf16; "
        f"{card}): {moe_ms:.5f} ms a layer, bound {moe_bound[0]:.5f} ms "
        f"({moe_bound[1]})")
    log(f"granite prefill ms a batch (graphs, warm; {card}): "
        f"{cells['default']['warm_prefill_ms_per_batch']}; TTFT p50 "
        f"{lat['ttft']['p50']:.3f} p95 {lat['ttft']['p95']:.3f} ms, TPOT "
        f"p50 {lat['tpot']['p50']:.3f} p95 {lat['tpot']['p95']:.3f} ms")
    log(f"granite train step ms ({card}): {tr['step_ms']}, "
        f"{tr['tokens_per_s_after_step_1']:.1f} tok/s at step 2, "
        f"{tr['model_flop_share']:.4f} of the bf16 peak on active params")
    for name, (k_ms, p_ms, l_ms, b_, o_) in (
            ("#1 fused decode T=1", times["decode"]),
            ("#1 fused decode T=5", times["verify"]),
            ("#2 forward L=512 band", times["band"])):
        b_ms, b_by = bound(b_, o_)
        log(f"granite {name} ({card}): kernel {k_ms:.5f} ms, plain "
            f"{p_ms:.4f}, SDPA {l_ms:.4f}, bound {b_ms:.6f} ({b_by})")
    bt = times["backward"]
    for key in ("dq", "dkv", "combine"):
        k_ms, p_ms, l_ms, b_, o_ = bt[key]
        b_ms, b_by = bound(b_, o_)
        log(f"granite {key} L=2048 ({card}): kernel {k_ms:.5f} ms, plain "
            f"{p_ms:.4f}, library {l_ms}, bound {b_ms:.6f} ({b_by})")
    log(f"granite phase: {out['phase_s']:.1f}s, split "
        f"{json.dumps(split)}")
    return out


# ------------------------------------------------------------ phase 25 ---

# mamba2-1.3b at full width and depth (48 layers, d_model 2048, d_inner
# 4096, 64 SSM heads of 64, state 128, conv 4, chunk 256, tied vocab
# 50280), and jamba-1.5-large + SWAT (phase 3's window and globals) at its
# published widths (d_model 8192, 64 q over 8 kv heads of 128, d_ff 24576,
# d_inner 16384, 256 SSM heads, untied vocab 65536) cut to one super-block
# (8 of 72 layers: 7 mamba, 1 attention) and 2 of 16 experts (top-2 kept);
# jamba's kernel shapes at phase 3's 4 slots
JAMBA = dict(b=MAIN["b"], hq=64, hkv=8, d=128)
JAMBA_CUT = dict(num_layers=8, num_experts=2)
# the SSD gate at the published shape, fp32: outputs within
# tests/test_ssm.py's tolerance
SSD = dict(b=2, l=2048, h=64, p=64, s=128, chunk=256)
SSD_TOL = dict(atol=2e-4, rtol=1e-3)
# ssd_chunked's gradients against autograd through ssd_scan_ref, fp32:
# max |error| of each input's gradient over that gradient's largest
# magnitude. The H100 read 1.3e-6..3.1e-6 (fp32 summation order over 2048
# steps); the limit is ~30x that
SSD_GRAD_REL = 1e-4
# mamba2, fp32, full depth: prefill + 8 teacher-forced decode steps (the
# recurrence) against forward_logits (the chunked SSD) at the same
# positions, max |dlogit| (logit spread ~0.9). The H100 read 5.8e-5; a
# state left running past `lengths` read 5.94, and must read above it
MAMBA_RECUR_BOUND = 1e-3
# jamba fp32, kernel path against the plain path, max |dlogit| (logit
# spread ~1.8): both accumulate in fp32 and differ in summation order in
# the one attention layer; the H100 read 4.3e-6, the limit is ~25x that
JAMBA_FP32_LOGIT_BOUND = 1e-4


def mamba2_cfg(dtype_name="bfloat16"):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mamba2-1.3b"), dtype=dtype_name)


def jamba_cfg(dtype_name="bfloat16"):
    import dataclasses
    from repro_torch.configs import get_config, with_swat
    cfg = with_swat(get_config("jamba-1.5-large"), window=MAIN["window"],
                    num_global=MAIN["num_global"])
    return dataclasses.replace(
        cfg, dtype=dtype_name, num_layers=JAMBA_CUT["num_layers"],
        moe=dataclasses.replace(cfg.moe,
                                num_experts=JAMBA_CUT["num_experts"]))


def attn_layers(cfg):
    """Attention layers in the stack (each launches #1 a decode step)."""
    return cfg.num_super_blocks * sum(
        not k.startswith("mamba") for k in cfg.layer_pattern)


def ssd_gate(torch):
    """ssd_chunked against ssd_scan_ref at the published shape (B=2,
    L=2048, 64 heads of 64, state 128, one group, chunk 256), fp32, dt from
    init_mamba's range (log-uniform in [1e-3, 0.1]) and a = -exp(a_log) of
    init_mamba (-1 .. -16): outputs within SSD_TOL; the gradients of
    <y, r> (r a random cotangent) in x, dt, B and C finite and within
    SSD_GRAD_REL of autograd through the recurrence (each input's max
    |error| over its gradient's largest magnitude). Also reads the
    largest above-diagonal decay sum of a chunk (exp overflows above 88:
    the JAX formulation's backward then gives NaN)."""
    import math
    from repro_torch.core import ssm as S
    gen = torch.Generator(device="cuda").manual_seed(251)
    b, l, h, p, s = (SSD[k] for k in ("b", "l", "h", "p", "s"))
    mk = lambda *sh: torch.randn(*sh, generator=gen, device="cuda")
    x, bm, cm = mk(b, l, h, p), mk(b, l, 1, s), mk(b, l, 1, s)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt = torch.exp(torch.rand(b, l, h, generator=gen, device="cuda")
                   * (hi - lo) + lo)
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    d = torch.ones(h, device="cuda")
    r = mk(b, l, h, p)
    out = {}
    grads = []
    for name, fn in (("chunked", lambda *t: S.ssd_chunked(
            *t, chunk=SSD["chunk"])), ("scan", S.ssd_scan_ref)):
        ins = [t.clone().requires_grad_(True) for t in (x, dt, bm, cm)]
        y = fn(ins[0], ins[1], a, ins[2], ins[3], d)
        (y * r).sum().backward()
        grads.append((y.detach(), [t.grad for t in ins]))
        del y, ins
    (yc, gc), (ys, gs) = grads
    torch.cuda.synchronize()
    out["max_abs_err"] = max_err(yc, ys)
    if not torch.allclose(yc, ys, **SSD_TOL):
        raise AssertionError(f"ssd_chunked vs ssd_scan_ref: max abs err "
                             f"{out['max_abs_err']} outside {SSD_TOL}")
    rel = {}
    for name, g1, g2 in zip(("x", "dt", "b", "c"), gc, gs):
        if not bool(torch.isfinite(g1).all()):
            raise AssertionError(f"ssd_chunked: non-finite d{name}")
        rel[name] = max_err(g1, g2) / float(g2.abs().max())
    out["grad_rel_err"] = rel
    out["grad_rel_bound"] = SSD_GRAD_REL
    cum = torch.cumsum((dt * a).reshape(b, l // SSD["chunk"], SSD["chunk"],
                                        h), dim=2)
    out["max_chunk_decay_sum"] = float(-(cum[:, :, -1] - cum[:, :, 0]).min())
    log("phase 25 SSD at the published shape (fp32): " + json.dumps(out))
    if max(rel.values()) > SSD_GRAD_REL:
        raise AssertionError(f"ssd_chunked gradients vs the recurrence: "
                             f"{rel} above {SSD_GRAD_REL}")
    del grads, gc, gs, yc, ys
    torch.cuda.empty_cache()
    return out


def mamba_recurrence(torch):
    """mamba2-1.3b, fp32, full depth: a 2-row batch of 512-token prompts,
    row 1 right-padded (its real length 389), prefilled with `lengths`,
    then 8 teacher-forced decode steps (the recurrent path), against
    forward_logits over each row's real prompt plus those 8 tokens (the
    chunked SSD) at the same 9 positions: max |dlogit| <= MAMBA_RECUR_BOUND.
    The control: the same batch prefilled without `lengths`, so row 1's
    state runs on over its 123 pad positions, whose 8 decode steps must
    read above the bound."""
    import numpy as np
    from repro_torch.core import model as Mod
    cfg = mamba2_cfg("float32")
    params = Mod.init_model(cfg, seed=0, device="cuda")
    rng = np.random.RandomState(25)
    lens = [MAIN["prompt"], 389]
    prompt = torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                         (2, MAIN["prompt"])), device="cuda")
    forced = torch.as_tensor(rng.randint(0, cfg.vocab_size, (2, 8)),
                             device="cuda")

    def recurrent(lengths):
        logits, caches = Mod.prefill(params, cfg, {"tokens": prompt},
                                     MAIN["max_len"], lengths=lengths)
        out = [logits[:, 0]]
        for j in range(8):
            lg, caches = Mod.decode_step(params, cfg,
                                         {"tokens": forced[:, j:j + 1]},
                                         caches)
            out.append(lg[:, 0])
        return torch.stack(out, 1)                       # (2, 9, V)

    rec = recurrent(torch.tensor(lens, dtype=torch.int32, device="cuda"))
    par = []
    for row, n in enumerate(lens):
        seq = torch.cat([prompt[row, :n], forced[row]])[None]
        par.append(Mod.forward_logits(params, cfg, {"tokens": seq})[0,
                                                                     n - 1:])
    par = torch.stack(par)
    broken = recurrent(None)
    torch.cuda.synchronize()
    out = {"max_abs_logit_diff": max_err(rec, par),
           "per_row": [max_err(rec[i], par[i]) for i in range(2)],
           "logit_spread": float(par.std()),
           "greedy_equal": bool((rec.argmax(-1) == par.argmax(-1)).all()),
           "unfrozen_state_control": max_err(broken[1, 1:], par[1, 1:]),
           "bound": MAMBA_RECUR_BOUND}
    log("phase 25 mamba2 recurrent vs parallel (fp32, 48 layers): "
        + json.dumps(out))
    del params
    torch.cuda.empty_cache()
    if not (out["max_abs_logit_diff"] <= MAMBA_RECUR_BOUND
            < out["unfrozen_state_control"]):
        raise AssertionError(f"mamba2 recurrent vs parallel: {out}")
    return out


def _counters():
    from repro_torch.kernels import _build
    return _build.launch_counts()


def mamba_serve(torch, cfg, params, tag):
    """Phase 3's cell (8 requests, 4 slots, prompt 512, 64 new tokens,
    max_len 1024, scan_steps 8, greedy), bf16: an eager engine
    (graphs=False) once, a graph engine twice (capture, then replay) and,
    for an attention-free model, a paged graph engine: graph and paged
    tokens bitwise the eager run's, every launch counter and step count
    equal, no capture on the replay run, zero steps down. Then
    the warm graph engine serves the first 4 requests three times (decode
    ms a step, prefill ms a batch). Returns a summary."""
    import numpy as np
    from repro_torch.serving.engine import ServingEngine
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (MAIN["prompt"],))
               .astype(np.int32) for _ in range(8)]
    keys = ("decode_steps", "prefill_batches", "tokens_emitted")
    make = lambda **kw: ServingEngine(cfg, params, batch_slots=4,
                                      max_len=MAIN["max_len"], scan_steps=8,
                                      **kw)
    eager = make(graphs=False)
    want, w_counts, w_st, _ = _serve_on(torch, eager, prompts,
                                        MAIN["new_tokens"])
    if any(len(t) != MAIN["new_tokens"] for t in want):
        raise AssertionError(f"{tag}: token counts {[len(t) for t in want]}")
    graph = make(graphs=True)
    runs = []
    for run in ("capture", "replay"):
        captured0 = len(graph._compiled.captured)
        torch.cuda.reset_peak_memory_stats()
        got, counts, st, wall = _serve_on(torch, graph, prompts,
                                          MAIN["new_tokens"])
        if got != want or counts != w_counts or any(
                st[k] != w_st[k] for k in keys):
            raise AssertionError(f"{tag} ({run}): graph run differs from "
                                 f"eager (tokens equal {got == want}, "
                                 f"launches {counts} / {w_counts})")
        runs.append((len(graph._compiled.captured) - captured0, st, wall,
                     torch.cuda.max_memory_allocated() / 1e9))
    if runs[1][0]:
        raise AssertionError(f"{tag}: {runs[1][0]} captures in the replay "
                             "run")
    out = {"tokens_bitwise_eager": True, "launches": w_counts,
           "graphs_captured": len(graph._compiled.captured),
           "eager_decode_ms_per_step": w_st["decode_s"] * 1e3
           / w_st["decode_steps"],
           "replay_run_decode_ms_per_step": runs[1][1]["decode_s"] * 1e3
           / runs[1][1]["decode_steps"],
           "replay_run_prefill_ms_per_batch": runs[1][1]["prefill_s"] * 1e3
           / runs[1][1]["prefill_batches"],
           "replay_run_tok_per_s": sum(map(len, want)) / runs[1][2],
           "decode_steps": runs[1][1]["decode_steps"],
           "prefill_batches": runs[1][1]["prefill_batches"],
           "peak_mem_gb": runs[1][3],
           "latency_ms_replay_run": _latency_ms(
               list(graph.tracer.records)[-len(prompts):])}
    if attn_layers(cfg) == 0:
        paged = make(kv_layout="paged")
        got = _serve_on(torch, paged, prompts, MAIN["new_tokens"])[0]
        if got != want:
            raise AssertionError(f"{tag}: paged tokens differ from the "
                                 "contiguous engine's")
        out["paged_tokens_bitwise"] = True
        out["paged_layout_positions"] = len(paged._paged.layout)
        del paged
    warm = [_serve_on(torch, graph, prompts[:4], MAIN["new_tokens"])[2]
            for _ in range(3)]
    out["warm_decode_ms_per_step"] = [w["decode_s"] * 1e3
                                      / w["decode_steps"] for w in warm]
    out["warm_prefill_ms_per_batch"] = [w["prefill_s"] * 1e3
                                        / w["prefill_batches"] for w in warm]
    log(f"phase 25 {tag} serve (bf16): " + json.dumps(out))
    return out, want


def mamba_trace(torch, cfg, params):
    """An eager mamba2 decode block (graphs=False, decode_impl="pallas":
    the kernel impl, which an attention-free model never reaches) traced
    with `ssm.ssm_update` (the recurrence's state update) and
    `ssm.mamba_decode` in named profiler ranges: device time a step by
    kernel category, the time of the kernels the ops inside each range
    launched, and no SWAT kernel launched (the wrappers' counters) or
    traced."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core import ssm as S
    from repro_torch.serving.engine import Request, ServingEngine
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, (MAIN["prompt"],))
               for _ in range(4)]
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=MAIN["max_len"],
                        scan_steps=8, graphs=False, decode_impl="pallas")
    reqs = lambda: [Request(rid=i, prompt=p, max_new_tokens=9)
                    for i, p in enumerate(prompts)]
    eng.run(reqs())
    names = ("ssm_update", "mamba_decode")
    orig = {n: getattr(S, n) for n in names}

    def named(n):
        def fn(*a, **kw):
            with record_function(n):
                return orig[n](*a, **kw)
        return fn

    steps0 = eng.stats["decode_steps"]
    counts0 = _counters()
    torch.cuda.synchronize()
    for n in names:
        setattr(S, n, named(n))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.run(reqs())
            torch.cuda.synchronize()
    finally:
        for n in names:
            setattr(S, n, orig[n])
    no_step_down(eng, "mamba2 trace", impl="pallas")
    launched = [a - b for a, b in zip(_counters(), counts0)]
    steps = eng.stats["decode_steps"] - steps0
    dt = torch.autograd.DeviceType
    ev = prof.events()
    blocks = [e.time_range for e in ev if e.name == "engine.decode_block"
              and e.device_type == dt.CPU]
    inside = lambda r: any(b.start <= r.start <= b.end for b in blocks)
    kernels = [e for e in ev if e.device_type == dt.CUDA
               and e.name not in names and not e.name.startswith("engine.")
               and inside(e.time_range)]
    swat = sorted({e.name[:60] for e in kernels
                   if any(k in e.name for _, ks in _CATEGORIES[:6]
                          for k in ks)})
    if any(launched) or swat:
        raise AssertionError(f"mamba2 trace: SWAT kernels launched "
                             f"{launched} / traced {swat}")
    ops = [e for e in ev if e.device_type == dt.CPU and e.name not in names
           and inside(e.time_range)]

    def range_us(name):
        rs = [e for e in ev if e.name == name and e.device_type == dt.CPU
              and inside(e.time_range)]
        return sum(k.duration for e in ops
                   if any(r.thread == e.thread
                          and r.time_range.start <= e.time_range.start
                          and e.time_range.end <= r.time_range.end
                          for r in rs) for k in e.kernels), len(rs)

    per = max(1, steps)
    out = {"eager_decode_steps": steps, "swat_launches": sum(launched)}
    linked = sum(k.duration for e in ops for k in e.kernels)
    if not kernels or not linked:
        out["device_time"] = "not measured (no kernel traced in the blocks)"
        return out
    by_cat = {}
    for e in kernels:
        name = e.name.lower()
        cat = next((c for c, keys in _CATEGORIES
                    if any(k in name for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + e.time_range.elapsed_us() / 1e3
    upd_us, n_upd = range_us("ssm_update")
    mix_us, n_mix = range_us("mamba_decode")
    out.update({
        "kernels_per_step": len(kernels) / per,
        "device_ms_per_step_by_category": {
            k: v / per for k, v in sorted(by_cat.items())},
        "ssm_update_device_ms_per_step": upd_us / 1e3 / per,
        "ssm_update_calls_per_step": n_upd / per,
        "mamba_decode_device_ms_per_step": mix_us / 1e3 / per,
        "op_linked_device_ms_per_step": linked / 1e3 / per,
        "ssm_update_share_of_linked": upd_us / linked})
    return out


def jamba_serve_checks(torch, cfg, params, summary):
    """jamba's launch counts from `mamba_serve`'s runs (#1 once per
    attention layer and decode step, #2 twice per attention layer and
    single-shot prefill batch as in phase 3: the band pass and the
    global-row pass, every forward launch on the tensor-core route, no
    plain decode launch), then one engine under fail_pallas_dispatch:
    every request ok with 64 tokens, kernel_fallbacks 1, readmitted 0,
    failed 0 (the armed failure raises at decode_step's entry, before the
    mamba layers l0-l3 write their state)."""
    import numpy as np
    from repro_torch.serving import faults as F
    from repro_torch.serving.engine import Request, ServingEngine
    idx = _moe_counter_index()
    counts, layers = summary["launches"], attn_layers(cfg)
    launches = {k: counts[idx[k]] for k in ("swat_decode",
                                            "swat_attention_fwd")}
    passes = 2 if cfg.attention.num_global else 1   # band + global rows
    expected = {"swat_decode": layers * summary["decode_steps"],
                "swat_attention_fwd": layers * passes
                * summary["prefill_batches"]}
    if (launches != expected or counts[idx["swat_decode_plain"]]
            or counts[idx["fwd_simt"]]
            or counts[idx["fwd_tc"]] != launches["swat_attention_fwd"]):
        raise AssertionError(f"jamba launches {launches}, expected "
                             f"{expected} (plain decode "
                             f"{counts[idx['swat_decode_plain']]}, SIMT "
                             f"forward {counts[idx['fwd_simt']]})")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (MAIN["prompt"],))
               .astype(np.int32) for _ in range(8)]
    F.consume_events()
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=MAIN["max_len"],
                        scan_steps=8,
                        faults=F.FaultPlan(fail_pallas_dispatch=True))
    try:
        res = eng.run([Request(rid=i, prompt=p,
                               max_new_tokens=MAIN["new_tokens"])
                       for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
    finally:
        F.clear_kernel_failure()
        events = [e["kind"] for e in F.consume_events()]
    fault = {"statuses": sorted({r.status for r in res}),
             "tokens": sorted({len(r.tokens) for r in res}),
             **{k: eng.stats[k] for k in ("kernel_fallbacks", "readmitted",
                                          "failed")},
             "decode_impl_after": eng.decode_impl, "events": events}
    log("phase 25 jamba fail_pallas_dispatch: " + json.dumps(fault))
    if (fault["statuses"] != ["ok"] or fault["tokens"] != [MAIN["new_tokens"]]
            or fault["kernel_fallbacks"] != 1 or fault["readmitted"]
            or fault["failed"] or events.count("pallas_fallback") != 1):
        raise AssertionError(f"jamba under fail_pallas_dispatch: {fault}")
    del eng
    return launches, fault


def jamba_fp32(torch):
    """jamba (the phase's cut) in fp32, the kernel path against the plain
    path (impl "banded"): phase 3's first four prompts prefilled, then 8
    decode steps teacher-forced on the kernel path's greedy tokens; greedy
    tokens equal at all 9 positions, max |dlogit| <=
    JAMBA_FP32_LOGIT_BOUND."""
    import numpy as np
    from repro_torch.core import model as Mod
    cfg = jamba_cfg("float32")
    params = Mod.init_model(cfg, seed=0, device="cuda")
    rng = np.random.RandomState(0)
    tok = torch.as_tensor(np.stack([rng.randint(0, cfg.vocab_size,
                                                (MAIN["prompt"],))
                                    for _ in range(4)]), device="cuda")
    lk, ck = Mod.prefill(params, cfg, {"tokens": tok}, MAIN["max_len"],
                         impl="kernel")
    lp, cp = Mod.prefill(params, cfg, {"tokens": tok}, MAIN["max_len"],
                         impl="banded")
    diffs, equal = [max_err(lk, lp)], [bool((lk.argmax(-1)
                                             == lp.argmax(-1)).all())]
    nxt = lk[:, 0].argmax(-1)
    for _ in range(8):
        batch = {"tokens": nxt[:, None]}
        lk, _ = Mod.decode_step(params, cfg, batch, ck, impl="kernel")
        lp, _ = Mod.decode_step(params, cfg, batch, cp, impl="banded")
        diffs.append(max_err(lk, lp))
        equal.append(bool((lk.argmax(-1) == lp.argmax(-1)).all()))
        nxt = lk[:, 0].argmax(-1)
    torch.cuda.synchronize()
    out = {"max_abs_logit_diff": max(diffs), "per_position": diffs,
           "greedy_equal": all(equal), "logit_spread": float(lk.std()),
           "bound": JAMBA_FP32_LOGIT_BOUND}
    log("phase 25 jamba fp32 kernel vs plain path: " + json.dumps(out))
    del params, ck, cp
    torch.cuda.empty_cache()
    if not (out["greedy_equal"]
            and out["max_abs_logit_diff"] <= JAMBA_FP32_LOGIT_BOUND):
        raise AssertionError(f"jamba fp32 kernel vs plain path: {out}")
    return out


def _step_bound_ms(cfg, params, slots=MAIN["b"]):
    """A decode step's byte bound: every weight read once but the embedding
    table (its rows only, unless tied to the head), each mamba layer's
    state read and written, each attention layer's K and V ring rows read,
    the fp32 logits written. Returns (ms, weight bytes, state bytes)."""
    from repro_torch import tree
    w = sum(p.numel() * p.element_size() for p in tree.leaves(params))
    if not cfg.tie_embeddings:
        w -= params["embed"].numel() * params["embed"].element_size()
    spec = cfg.ssm
    mamba = cfg.num_layers - attn_layers(cfg)
    state = 2 * mamba * slots * (
        spec.num_heads(cfg.d_model) * spec.head_dim * spec.state_dim * 4
        + (spec.conv_width - 1) * (spec.d_inner(cfg.d_model)
                                   + 2 * spec.num_groups * spec.state_dim)
        * 2)
    cap = MAIN["window"] + 1 + MAIN["num_global"]
    rings = (attn_layers(cfg) * slots * cfg.num_kv_heads * cap
             * cfg.resolved_head_dim * 2 * 2)
    total = w + state + rings + slots * cfg.vocab_size * 4
    return total / HBM_BYTES_PER_S * 1e3, w, state


def mamba(torch, card, llama_turns):
    """Phase 25: mamba2-1.3b and jamba-1.5-large + SWAT on the card (see
    the module docstring). Returns a summary with jamba's launch counts."""
    from repro_torch import tree
    from repro_torch.core import model as Mod
    t_phase = time.perf_counter()
    split = {}

    def lap(name):
        split[name] = time.perf_counter() - t_phase - sum(split.values())

    ssd = ssd_gate(torch)
    lap("ssd")
    recur = mamba_recurrence(torch)
    lap("recurrence")
    cfg = mamba2_cfg()
    params = Mod.init_model(cfg, seed=0, device="cuda")
    m_serve, _ = mamba_serve(torch, cfg, params, "mamba2")
    m_trace = mamba_trace(torch, cfg, params)
    m_bound = _step_bound_ms(cfg, params)
    del params
    torch.cuda.empty_cache()
    lap("mamba2 serve")
    tr, _, (params, opt, _, _) = train(torch, cfg, n=2)
    if not all(bool(torch.isfinite(p).all()) for p in tree.leaves(params)):
        raise AssertionError("mamba2 train: non-finite params after two "
                             "steps")
    del params, opt
    torch.cuda.empty_cache()
    lap("mamba2 train")
    jcfg = jamba_cfg()
    spec = jcfg.attention
    kerr = moe_kernels(torch, spec, shape=JAMBA, tag="jamba", chunk=False)
    times = {"decode": time_decode(torch, spec, shape=JAMBA),
             "band": time_banded(torch, spec, shape=JAMBA)}
    lap("jamba kernels")
    params = Mod.init_model(jcfg, seed=0, device="cuda")
    j_serve, _ = mamba_serve(torch, jcfg, params, "jamba")
    j_launch, j_fault = jamba_serve_checks(torch, jcfg, params, j_serve)
    j_bound = _step_bound_ms(jcfg, params)
    del params
    torch.cuda.empty_cache()
    lap("jamba serve")
    j32 = jamba_fp32(torch)
    lap("jamba fp32")
    llama_ms = llama_turns["default ms a step"]["graphs"]
    out = {"ssd": ssd, "recurrence": recur, "mamba2_serve": m_serve,
           "mamba2_trace": m_trace, "mamba2_train": tr,
           "jamba_kernel_errors": kerr, "jamba_serve": j_serve,
           "jamba_launches": j_launch, "jamba_fault": j_fault,
           "jamba_fp32": j32, "times": times,
           "mamba2_step_bound_ms": m_bound[0], "jamba_step_bound_ms":
           j_bound[0], "phase_s": time.perf_counter() - t_phase,
           "phase_split_s": split}
    for tag, s_, (b_ms, w_b, st_b) in (("mamba2", m_serve, m_bound),
                                       ("jamba", j_serve, j_bound)):
        lat = s_["latency_ms_replay_run"]
        log(f"phase 25 {tag} decode ms a step with graphs (warm, 4 slots; "
            f"{card}): {s_['warm_decode_ms_per_step']}, byte bound "
            f"{b_ms:.4f} ms ({w_b / 1e9:.3f} GB of weights, {st_b / 1e9:.3f}"
            f" GB of state read and written); llama phase 21 graphs "
            f"{llama_ms}")
        log(f"phase 25 {tag} prefill ms a batch (graphs, warm; {card}): "
            f"{s_['warm_prefill_ms_per_batch']}; TTFT p50 "
            f"{lat['ttft']['p50']:.3f} p95 {lat['ttft']['p95']:.3f} ms, TPOT"
            f" p50 {lat['tpot']['p50']:.3f} p95 {lat['tpot']['p95']:.3f} ms;"
            f" peak {s_['peak_mem_gb']:.2f} GB")
    log(f"phase 25 mamba2 traced eager decode step, SSM update named "
        f"({card}): " + json.dumps(m_trace))
    log(f"phase 25 mamba2 train step ms ({card}): {tr['step_ms']}, "
        f"{tr['tokens_per_s_after_step_1']:.1f} tok/s at step 2, "
        f"{tr['model_flop_share']:.4f} of the bf16 peak, peak "
        f"{tr['peak_mem_gb']:.2f} GB")
    for name, (k_ms, p_ms, l_ms, b_, o_) in (
            ("#1 fused decode T=1", times["decode"]),
            ("#2 forward L=512 band", times["band"])):
        b_ms, b_by = bound(b_, o_)
        log(f"phase 25 jamba {name} ({card}): kernel {k_ms:.5f} ms, plain "
            f"{p_ms:.4f}, SDPA {l_ms:.4f}, bound {b_ms:.6f} ({b_by})")
    log(f"phase 25: {out['phase_s']:.1f}s, split {json.dumps(split)}")
    return out


# ------------------------------------------------------------ phase 26 ---

# the .item() control runs in a process of its own: a refused capture may
# leave the CUDA context unusable for the phases after this one
ITEM_CONTROL = r"""
import json, sys, torch
from repro_torch.analysis import rules as R, tracer as T
from repro_torch.serving.engine import capture_graph
x = torch.arange(8.0, device="cuda")
def body():
    return x.sum().item()
tr = T.trace(T.EntryPoint(name="item", family="item", body=body,
                          tags=frozenset({"decode_hot_path"})))
found = [(f.rule, f.severity, f.details["op"]) for f in R.check_host_sync(tr)]
try:
    capture_graph(body, {}, torch.Generator(device="cuda"))
    refused = None
except RuntimeError as e:
    refused = str(e).strip().splitlines()[0][:200]
print(json.dumps({"findings": found, "capture_error": refused}))
"""


def _warn_counts(report):
    """{label: {rule: warnings}} of a swatlint report."""
    out = {}
    for label, eng in report["engines"].items():
        c = out.setdefault(label, {})
        for f in eng["findings"]:
            if f["severity"] == "warn":
                c[f["rule"]] = c.get(f["rule"], 0) + 1
    return out


def _captured_keys(eng, entries):
    """Every graph-keyed entry of a report was captured and replayed by the
    engine that served it."""
    keyed = {n: e for n, e in entries.items()
             if e["family"] in ("scan", "spec_scan", "prefill_chunk")}
    bad = [n for n, e in keyed.items() if e["captured"] is not True]
    if bad or not keyed or not eng._compiled.replays:
        raise AssertionError(f"swatlint: keys not captured and replayed: "
                             f"{bad} (replays {eng._compiled.replays})")
    return len(keyed)


def swatlint(torch, cfg, params, card):
    """Phase 26 (after phase 3, on its params): the port's swatlint on the
    card.

      (a) the smoke matrix (`launch/analyze.py`'s six single-device
          engines, decode_impl "pallas" on the fused #1 and the chunk
          route's #2) against the committed ANALYSIS_torch.json: zero
          errors, no warning or lowering count above the baseline's (the
          per-engine warning counts printed beside the baseline's), every
          graph key of the report captured and replayed by its engine;
      (b) full width: llama3.2-1b + SWAT, bf16, 4 slots, decode_impl
          "pallas", prefill_chunk 64, graphs, metrics=True, and its
          speculative (k=4) twin: zero errors, host_sync and telemetry
          clean on every scan, spec_scan and prefill_chunk entry; each
          scan[n] entry launches #1 n x layers times and no plain decode
          kernel, each spec_scan[n] entry layers times a verify step, each
          prefill_chunk entry #2 for pass A and pass B a layer (the chunk
          [64, 128): globals precede it), all on the tensor-core route; the
          dtype_promotion findings printed with their call sites;
      (c) negative controls: a body that calls .item() on a CUDA tensor
          gives a host_sync ERROR, and capture_graph refuses it (in a
          process of its own); a body that rebinds a carry gives a
          donation ERROR; on the hot path, a tensor built from a list on
          the card and a copy_ from pageable host memory each give a
          host_sync ERROR, and the engine's staging (pinned memory,
          non_blocking, `ServingEngine._upload`) gives none.

    Writes the card's report to the kernels' build directory (outside the
    tree git commits) and returns its summary; the phase's wall time is
    printed beside the card."""
    from repro_torch.analysis import baselines, report as Rep
    from repro_torch.analysis import rules as R, tracer as T
    from repro_torch.kernels import _build
    from repro_torch.launch import analyze as A
    from repro_torch.serving.drafter import NGramDrafter
    from repro_torch.serving.engine import ServingEngine
    t0 = time.perf_counter()

    # (a) the smoke matrix's single-device labels against the committed
    # baseline (the mesh labels: phase 30)
    labels = [x for x in A.MATRIX if x not in A.MESHES]
    base = A.restrict(baselines.load(), labels)
    smoke, engines = A.analyze_matrix(labels, "cuda", base, log=log)
    violations = baselines.diff(smoke, base)
    stale = baselines.is_stale(smoke, base)
    card_w, base_w = _warn_counts(smoke), _warn_counts(base)
    for label in labels:
        log(f"swatlint (a) {label}: card warnings {card_w[label]}, baseline "
            f"{base_w.get(label, {})}; lowerings "
            f"{smoke['engines'][label]['lowerings']}")
    if violations or stale:
        raise AssertionError(f"swatlint (a): {violations + stale}")
    keyed = sum(_captured_keys(engines[label],
                               smoke["engines"][label]["entries"])
                for label in labels)
    del engines

    # (b) full width, sequential and speculative
    layers = cfg.num_layers
    full = {}
    for tag, kw in (("sequential", {}),
                    ("speculative", {"speculative": SPEC_K,
                                     "draft": NGramDrafter(**DRAFT)})):
        eng = ServingEngine(cfg, params, batch_slots=4,
                            max_len=MAIN["max_len"], scan_steps=8,
                            decode_impl="pallas", prefill_chunk=CHUNK,
                            metrics=True, **kw)
        rep = Rep.analyze_engine(eng, label=f"full_{tag}", chunk_len=CHUNK,
                                 prefill_len=CHUNK)
        if eng.stats["kernel_fallbacks"] or eng.decode_impl != "pallas":
            raise AssertionError(f"swatlint (b) {tag}: stepped down")
        if rep["summary"]["errors"]:
            raise AssertionError(f"swatlint (b) {tag}: errors "
                                 f"{[f for f in rep['findings'] if f['severity'] == 'error']}")
        for name, e in rep["entries"].items():
            fam = e["family"]
            if fam in ("scan", "spec_scan", "prefill_chunk"):
                dirty = [f for f in rep["findings"] if f["entry"] == name
                         and f["rule"] in ("host_sync", "telemetry")]
                if dirty:
                    raise AssertionError(f"swatlint (b) {name}: {dirty}")
            got = e["launches"]
            if fam in ("scan", "spec_scan"):
                steps = int(name.split("n=")[1].split(",")[0])
                want = {"swat_decode_fused": steps * layers}
            elif fam == "prefill_chunk":
                want = {"swat_attention_fwd": 2 * layers,
                        "swat_attention_fwd.tc": 2 * layers}
            else:
                continue
            if got != want:
                raise AssertionError(f"swatlint (b) {name}: launches {got}, "
                                     f"expected {want}")
        _captured_keys(eng, rep["entries"])
        dtype = [(f["entry"], f["details"]["site"], f["details"]["count"])
                 for f in rep["findings"] if f["rule"] == "dtype_promotion"]
        full[tag] = {"entries": rep["summary"]["entries"],
                     "errors": rep["summary"]["errors"],
                     "warnings": rep["summary"]["warnings"],
                     "warnings_by_rule_and_site": sorted(
                         {(f["rule"], f["details"].get("site"))
                          for f in rep["findings"]
                          if f["severity"] == "warn"}),
                     "lowerings": rep["lowerings"],
                     "dtype_promotion": dtype,
                     "launches": {n: e["launches"]
                                  for n, e in rep["entries"].items()},
                     "uploads": {n: e["uploads"]
                                 for n, e in rep["entries"].items()
                                 if e["uploads"]}}
        smoke["engines"][f"full_{tag}"] = rep
        log(f"swatlint (b) {tag}: {json.dumps(full[tag])}")
        log(f"swatlint (b) {tag} dtype_promotion findings: {dtype or 'none'}")
        del eng

    # (c) negative controls
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", ITEM_CONTROL], env=env,
                         capture_output=True, text=True, timeout=300)
    if out.returncode:
        raise AssertionError(f"swatlint (c): the .item() control failed: "
                             f"{out.stderr[-2000:]}")
    item = json.loads(out.stdout.strip().splitlines()[-1])
    if [f[:2] for f in item["findings"]] != [["host_sync", "error"]] or \
            not item["capture_error"]:
        raise AssertionError(f"swatlint (c): the rule and the card disagree "
                             f"on .item(): {item}")
    state = {"c": torch.zeros((512, 512), device="cuda")}

    def rebind():
        state["c"] = state["c"] + 1.0
    tr = T.trace(T.EntryPoint(name="rebind", family="rebind", body=rebind,
                              carries=lambda: {"c": state["c"]}))
    rebound = [(f.rule, f.severity) for f in R.check_donation(tr)]
    if rebound != [("donation", "error")]:
        raise AssertionError(f"swatlint (c): rebound carry gave {rebound}")
    host = torch.arange(4)
    dst = torch.zeros(4, dtype=torch.long, device="cuda")

    def blocking():
        torch.as_tensor([1, 2, 3, 4], device="cuda")
        dst.copy_(host)

    def staged():
        dst.copy_(host.pin_memory().to("cuda", non_blocking=True))
    uploads = {}
    for tag, body in (("blocking", blocking), ("staged", staged)):
        tr = T.trace(T.EntryPoint(name=tag, family=tag, body=body,
                                  tags=frozenset({"decode_hot_path"})))
        uploads[tag] = sorted([f.severity, f.details["op"]]
                              for f in R.check_host_sync(tr))
    if uploads != {"blocking": [["error", "aten::copy_"],
                                ["error", "aten::lift_fresh"]],
                   "staged": []}:
        raise AssertionError(f"swatlint (c): uploads gave {uploads}")

    path = _build.BUILD_DIR / "ANALYSIS_torch.cuda.json"
    baselines.save(smoke, str(path))
    wall = time.perf_counter() - t0
    summary = {"smoke": {"summary": smoke["summary"], "keys_captured": keyed,
                         "warnings": card_w},
               "full": full, "item_control": item,
               "rebind_control": rebound, "upload_control": uploads,
               "report": str(path),
               "wall_s": wall}
    log(f"swatlint (phase 26; {card}): wall {wall:.1f}s, smoke errors "
        f"{smoke['summary']['errors']}, {keyed} graph keys captured and "
        "replayed")
    return summary


def mesh_lint(torch, card):
    """Phase 30 (a) and (b): swatlint's mesh labels on the card against
    the committed baseline, and the slot-axis all-gather control. Returns
    its summary."""
    import dataclasses
    from repro_torch.analysis import baselines
    from repro_torch.analysis import rules as R, tracer as T
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import analyze as A
    t0 = time.perf_counter()
    labels = A.MESH_LABELS
    base = A.restrict(baselines.load(), labels)
    rep, engines = A.analyze_matrix(labels, "cuda", base, log=log)
    violations = baselines.diff(rep, base) + baselines.is_stale(rep, base)
    if violations:
        raise AssertionError(f"mesh lint (a): {violations}")
    layers = get_smoke_config("llama3p2_1b").num_layers
    out = {}
    for label in labels:
        eng = rep["engines"][label]
        keyed = _captured_keys(engines[label], eng["entries"])
        if A.MESHES[label] == "4x1":
            for name, e in eng["entries"].items():
                if "decode_hot_path" in e["tags"] and e["collectives"]:
                    raise AssertionError(f"mesh lint (a) {label} {name}: "
                                         f"collectives {e['collectives']}")
                if e["family"] != "scan":
                    continue
                n = int(name.split("n=")[1].split(",")[0])
                want = {"swat_decode_fused": n * layers}
                if e["launches"] != want or e["shards"] != 4:
                    raise AssertionError(
                        f"mesh lint (a) {label} {name}: launches a shard "
                        f"{e['launches']} over {e['shards']} shards, "
                        f"expected {want} over 4")
        jax = A.jax_families(label)
        out[label] = {
            "errors": eng["summary"]["errors"],
            "warnings": _warn_counts(rep)[label],
            "baseline_warnings": _warn_counts(base).get(label, {}),
            "keys_captured": keyed,
            "families": {f: {"port": c, "port_wire_bytes": w,
                             "jax": jax.get(f, ({}, 0.0))[0],
                             "jax_wire_bytes": jax.get(f, ({}, 0.0))[1]}
                         for f, (c, w) in
                         A.family_collectives(eng).items()}}

    # (b) an all-gather over the slot axis in a 4x1 decode body
    eng = engines["slot_parallel_4x1"]
    scan = [p for p in T.engine_entry_points(eng) if p.family == "scan"][-1]
    mp = eng._mp

    def leaky():
        scan.body()
        mp.gather_slots(mp.local_rows(eng._dev["tok"], eng._lo))
    tr = T.trace(dataclasses.replace(scan, body=leaky), capture=False)
    caught = [(f.rule, f.severity) for f in R.check_collectives(
        tr, R.budget_for(tr))]
    if caught != [("collectives", "error")]:
        raise AssertionError(f"mesh lint (b): the slot-axis all-gather gave "
                             f"{caught}")
    del engines
    wall = time.perf_counter() - t0
    log(f"mesh lint (phase 30 a-b; {card}): wall {wall:.1f}s, "
        f"{rep['summary']}, control {caught} (record {tr.record})")
    return {"labels": out, "summary": rep["summary"],
            "control": {"findings": caught, "record": tr.record},
            "wall_s": wall}


def paper_baseline(torch, card):
    """Phase 30 (c): the sliding-chunks baseline against kernel #2 at the
    paper's model's attention, and their times. Returns the rows."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import patterns
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_attention as SA
    t0 = time.perf_counter()
    cfg = get_config("longformer-paper")
    spec = dataclasses.replace(cfg.attention, num_global=0)
    h, d = cfg.num_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(30)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for length in PAPER["lengths"]:
            q, k, v = (torch.randn(PAPER["b"], h, length, d, generator=gen,
                                   device="cuda").to(dtype)
                       for _ in range(3))
            pat = ops.get_pattern(spec, length, length, 128, 128)
            with torch.no_grad():
                before = route_counts()
                kern = ops.swat_attention(q, k, v, spec, impl="kernel")
                torch.cuda.synchronize()
                check_route(f"paper #2 {dn} L={length}", before, "fwd",
                            expected_route(dtype, d, "fwd"))
                plain = SA.banded_plain(q, k, v, spec, pat, d ** -0.5)
                chunks = ops.swat_attention(q, k, v, spec,
                                            impl="sliding_chunks")
                torch.cuda.synchronize()
            name = f"paper L={length} {dn}"
            err_plain = check_close(f"{name} #2 vs plain", kern, plain, dn)
            err = check_close(f"{name} sliding_chunks vs #2", chunks, kern,
                              dn)
            if chunks.dtype != dtype:
                raise AssertionError(f"{name}: sliding_chunks returned "
                                     f"{chunks.dtype}")
            del plain, chunks
            with torch.no_grad():
                k_ms = time_ms(torch, lambda: ops.swat_attention(
                    q, k, v, spec, impl="kernel"), iters=PAPER["iters"])
                c_ms = time_ms(torch, lambda: ops.swat_attention(
                    q, k, v, spec, impl="sliding_chunks"),
                    iters=PAPER["iters"])
            row = {"dtype": dn, "L": length, "heads": h, "d": d,
                   "window": spec.window, "kernel_ms": k_ms,
                   "sliding_chunks_ms": c_ms,
                   "ratio": c_ms / k_ms,
                   "flops_ratio": patterns.sliding_chunks_flops_ratio(
                       length, spec.window),
                   "err_vs_kernel": err, "kernel_err_vs_plain": err_plain}
            log(f"paper baseline ({card}): L={length} {dn}: kernel #2 "
                f"{k_ms:.4f} ms, sliding_chunks {c_ms:.4f} ms, ratio "
                f"{row['ratio']:.2f}x (redundant-FLOP share "
                f"{row['flops_ratio']:.3f}); max err vs #2 {err:.3g}")
            rows.append(row)
            del q, k, v
    torch.cuda.empty_cache()
    log(f"paper baseline (phase 30 c; {card}): wall "
        f"{time.perf_counter() - t0:.1f}s")
    return rows


# ------------------------------------------------------------ phase 31 ---

# phase 31 (a): whisper-tiny + SWAT on a 2x2 mesh, greedy decode steps
MESH_WHISPER_STEPS = 20
# phase 31 (c): the dry-run's three steps at the card's shapes (mode,
# seq_len, global batch), timed over DRYRUN_ITERS calls after a warm-up;
# a measured time under DRYRUN_COMPUTE_FLOOR x the counted FLOPs' time at
# the bf16 peak would mean the counter counted FLOPs the card did not do
DRYRUN_CELLS = (("train", 2048, 4), ("prefill", 512, 4), ("decode", 1024, 4))
DRYRUN_ITERS = 5
DRYRUN_COMPUTE_FLOOR = 0.9


def _whisper_mesh_run(torch, cfg, plan, ps, batch, steps, forced=None):
    """The mesh's prefill of every clip, then `steps` greedy decode steps
    (fed `forced[i]` when given): (tokens (steps+1, B), per-step logits)."""
    from repro_torch.core import model as Mod
    n = batch["tokens"].shape[0]
    per = n // plan.groups if plan.splits(n) else n
    rows = [{k: v[plan.group(c) * per:][:per] if plan.splits(n) else v
             for k, v in batch.items()} for c in plan.coords]
    lgs, pc = Mod.prefill(ps, cfg, rows, WHISPER["max_len"], plan=plan)
    caches = plan.caches_from_prefill(pc)
    logits = [plan.join_rows(lgs)[:, 0]]
    toks = [logits[0].argmax(-1)]
    for i in range(steps):
        feed = toks[-1] if forced is None else forced[i]
        out, _ = Mod.decode_step(ps, cfg, [{"tokens": r} for r in
                                           plan.local_rows(feed[:, None], 0)],
                                 caches, plan=plan)
        logits.append(plan.join_rows(out)[:, 0])
        toks.append(logits[-1].argmax(-1))
    return torch.stack(toks), logits


def mesh_whisper(torch):
    """(a) whisper-tiny + SWAT(128, 4), bf16, full width, on a 2x2
    LocalMesh: the encoder on each shard's clips, the decoder's Megatron
    heads, the cross K/V cut by the cache table; prefill 8 clips and 20
    greedy steps against the single-device run (greedy agreement and the
    teacher-forced logits), each shard launching #1, #2 and #3 what the
    single-device run launches."""
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_decode as SD
    from repro_torch.launch import mesh as ML
    steps = MESH_WHISPER_STEPS
    cfg, params, batch = whisper_setup(torch, "bfloat16")
    counters = {"swat_attention_fwd": SA.LAUNCHES,
                "swat_decode_fused": SD.LAUNCHES,
                "swat_decode_plain": SD.PLAIN_LAUNCHES}

    def counted(fn):
        for c in counters.values():
            c.reset()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.n for k, c in counters.items()}

    (one_toks, one_logits, _), one_n = counted(lambda: whisper_run(
        torch, cfg, params, batch, None, steps, keep_logits=True))
    mesh = ML.LocalMesh((2, 2), ("data", "model"))
    plan = TP.MeshPlan(cfg, mesh, params, slots=WHISPER["clips"],
                       max_len=WHISPER["max_len"], lookahead=0, paged=False,
                       enc_len=WHISPER["frames"])
    ps = plan.place_params(params)
    before = route_counts()
    (toks, _), mesh_n = counted(lambda: _whisper_mesh_run(
        torch, cfg, plan, ps, batch, steps))
    check_route("whisper 2x2", before, "fwd", "tc",
                n=mesh_n["swat_attention_fwd"])
    _, forced = _whisper_mesh_run(torch, cfg, plan, ps, batch, steps,
                                  forced=one_toks[:-1])
    gap = max(max_err(a, b) for a, b in zip(forced, one_logits))
    agree = float((toks == one_toks).float().mean())
    shards = len(plan.coords)
    out = {"mesh": "2x2", "clips": WHISPER["clips"], "steps": steps,
           "plan": {k: str(v) for k, v in plan.describe().items()},
           "greedy_agreement": agree, "agree_bound": AGREE_BOUND,
           "max_abs_logit_diff_teacher_forced": gap,
           "logit_bound": LOGIT_BOUND,
           "launches_per_shard": {k: v / shards for k, v in mesh_n.items()},
           "single_device_launches": one_n}
    log("phase 31 (a) whisper 2x2: " + json.dumps(out))
    if {k: v / shards for k, v in mesh_n.items()} != one_n:
        raise AssertionError(f"whisper 2x2: each shard must launch what one "
                             f"device launches: {out}")
    if not (agree >= AGREE_BOUND and gap <= LOGIT_BOUND):
        raise AssertionError(f"whisper 2x2 against one device: {out}")
    return out


def mesh_profiles_train(torch, cfg):
    """(b) one train step's loss and gradients under the cp profile (2-D
    FSDP params, the sequence over 'model', the window layers' halo
    exchange on kernels #2 / #4 / #5) and the fsdp one (the batch over
    both axes) on 2x2, llama3.2-1b + SWAT cut to 4 layers, phase 8's batch,
    against the plain single-device step (phase 9's gates); then one AdamW
    step each through `steps.make_train_step(act_sharding=)`."""
    import dataclasses
    from repro_torch.core import model as Mod
    from repro_torch.distributed import sharding as Sh
    from repro_torch.launch import mesh as ML
    from repro_torch.launch import steps as St
    from repro_torch.optim import adamw
    cfg4 = dataclasses.replace(cfg, num_layers=TRAIN["e2e_layers"])
    params = Mod.init_model(cfg4, seed=0, device="cuda")
    batch = _train_batches(torch, cfg4, 1)[0]
    plain = _loss_grads(torch, params, cfg4, batch, "banded")
    out = {}
    for profile in ("cp", "fsdp"):
        mesh = ML.LocalMesh((2, 2), ("data", "model"))
        step = St.make_train_step(
            cfg4, adamw.AdamWConfig(lr=TRAIN["lr"]),
            act_sharding=Sh.NamedSharding(
                mesh, Sh.activation_spec(mesh, True, profile), profile))
        placed = step.plan.place({"params": params,
                                  "opt": adamw.init_opt_state(params)})
        ps = [s["params"] for s in placed]
        with mesh.recording() as record:
            got, n, ms = _counted(torch, lambda: _mesh_loss_grads(
                torch, step.plan, cfg4, ps, batch))
        res = {"profile": profile, **_grad_gap(params, got, plain),
               "loss_bound": TRAIN_LOSS_BOUND,
               "grad_bound": TRAIN_GRAD_BOUND,
               "launches_per_shard": {k: v / 4 for k, v in n.items()},
               "host_ms": ms, "p2p": sum(k == "p2p" for k, _, _ in record)}
        _, _, res["adamw_step_host_ms"] = _counted(torch, lambda: step(
            ps, [s["opt"] for s in placed], batch))
        out[profile] = res
        log(f"phase 31 (b) {profile} 2x2: " + json.dumps(res))
        del placed, ps
        _gates(res, f"{profile} 2x2 train step against the plain step")
        if not all(n[k] >= 4 * cfg4.num_layers for k in (
                "swat_attention_fwd", "swat_attention_dq",
                "swat_attention_dkv")):
            raise AssertionError(f"{profile} 2x2: a shard launched no "
                                 f"attention kernel of a layer: {res}")
        if (res["p2p"] > 0) != (profile == "cp"):
            raise AssertionError(f"{profile} 2x2: halo shifts {res['p2p']}")
    return out


def dryrun_vs_card(torch, cfg):
    """(c) the dry-run's count against the card: each of the three steps
    of llama3.2-1b + SWAT(256, 4) at the card's shapes, traced on the meta
    device over a 1x1 mesh (`launch.dryrun.trace_cell`: counted FLOPs,
    bytes and memory), then the same step built on the card with the
    kernels and timed (CUDA events, mean of DRYRUN_ITERS after a warm-up),
    its peak memory beside the predicted argument + temp bytes. Gates: the
    argument bytes equal exactly; the time at least DRYRUN_COMPUTE_FLOOR x
    compute_s."""
    from repro_torch.analysis.collectives import record_stats
    from repro_torch.core.types import ShapeConfig
    from repro_torch.distributed import roofline as R
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as ML
    rows = []
    for mode, seq, b in DRYRUN_CELLS:
        shape = ShapeConfig(f"card_{mode}", seq, b, mode)
        mesh = ML.LocalMesh((1, 1), ("data", "model"))
        tr = D.trace_cell(cfg, shape, mesh, impl="kernel")
        roof = R.roofline_terms(tr.cost, record_stats(tr.record),
                                D.model_flops_per_device(cfg, shape, 1))
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        cell = D.build_cell(cfg, shape, ML.LocalMesh((1, 1), ("data",
                                                              "model")),
                            impl=None, device="cuda")
        arg = D.argument_bytes(cell)
        cell.run()                                    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(DRYRUN_ITERS):
            cell.run()
        e.record()
        e.synchronize()
        ms = s.elapsed_time(e) / DRYRUN_ITERS
        peak = torch.cuda.max_memory_allocated() - base
        row = {"mode": mode, "seq_len": seq, "batch": b, "trace_s":
               tr.trace_s, "measured_ms": ms,
               "compute_ms": roof.compute_s * 1e3,
               "memory_ms": roof.memory_s * 1e3,
               "measured_over_bound": ms / (roof.bound_s * 1e3),
               "flops": roof.flops, "bytes": roof.bytes_accessed,
               "model_flops": roof.model_flops,
               "predicted_argument_bytes":
                   tr.memory["argument_size_in_bytes"],
               "card_argument_bytes": arg,
               "predicted_argument_plus_temp_bytes":
                   tr.memory["argument_size_in_bytes"]
                   + tr.memory["temp_size_in_bytes"],
               "card_peak_bytes": peak}
        rows.append(row)
        log("phase 31 (c) dry-run vs card: " + json.dumps(row))
        del cell
        torch.cuda.empty_cache()
        if arg != tr.memory["argument_size_in_bytes"]:
            raise AssertionError(f"dry-run {mode}: predicted argument bytes "
                                 f"differ from the card's: {row}")
        if not ms >= DRYRUN_COMPUTE_FLOOR * row["compute_ms"]:
            raise AssertionError(f"dry-run {mode}: the card ran faster than "
                                 f"the counted FLOPs allow: {row}")
    return rows


def mesh_gaps_and_dryrun(torch, cfg, card):
    """Phase 31: (a) whisper on a mesh, (b) the cp and fsdp train profiles,
    (c) the dry-run against the card."""
    t0 = time.perf_counter()
    out = {"whisper_2x2": mesh_whisper(torch)}
    torch.cuda.empty_cache()
    out["profiles"] = mesh_profiles_train(torch, cfg)
    torch.cuda.empty_cache()
    out["dryrun_vs_card"] = dryrun_vs_card(torch, cfg)
    out["wall_s"] = time.perf_counter() - t0
    log(f"mesh gaps and dry-run (phase 31; {card}): wall "
        f"{out['wall_s']:.1f}s")
    return out


def ptxas_report(out):
    """(kernel, registers, spill-store bytes) for every entry function in
    the `nvcc -Xptxas -v` output of one source; kernel reads like
    attention_fwd_tc_kernel<bf16,64>."""
    import re
    rows, name, spill = [], None, 0
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+kernel)(I(\w*?)EE|E)", m.group(1))
            name = m.group(1)[-40:]
            if k:
                targs = k.group(3) or ""
                dt = ("bf16" if "bfloat16" in targs else
                      "fp32" if targs.startswith("f") else "")
                dd = re.search(r"Li(\d+)E", targs + "E")
                name = k.group(1) + (
                    f"<{','.join(x for x in (dt, dd and dd.group(1)) if x)}>"
                    if targs else "")
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


def bound(bytes_, ops_, dtype_name="bfloat16"):
    tb = bytes_ / HBM_BYTES_PER_S * 1e3
    to = ops_ / PEAK_OPS[dtype_name] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# --------------------------------------------------------------- main ----

def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import repro_torch  # noqa: F401  (pins TF32 off)
    from repro_torch.configs import get_config, with_swat
    from repro_torch.core import model as Mod
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    card = card_line()
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    spilled = []
    for stem, out in sorted(_build.BUILD_LOG.items()):
        for kernel, regs, spill in ptxas_report(out):
            log(f"ptxas {stem} {kernel}: {regs} registers, {spill} bytes "
                "spilled")
            if spill and kernel.startswith(NO_SPILL):
                spilled.append(kernel)
    if spilled:
        raise AssertionError(f"ptxas: register spills in {spilled}")

    cfg = with_swat(get_config("llama3.2-1b"), window=MAIN["window"],
                    num_global=MAIN["num_global"])
    spec = cfg.attention
    dec_err = check_decode(torch, spec)
    fwd_err = check_banded(torch, spec)

    params = Mod.init_model(cfg, seed=0, device="cuda")
    summary, tokens = serve(torch, cfg, params)
    e2e = end_to_end(torch, cfg, params, tokens)

    dk, dp, dl, db, do = time_decode(torch, spec)
    fk, fp, fl, fb, fo = time_banded(torch, spec)
    trace = trace_decode(torch, cfg, params)
    unembed = time_unembed(torch, params, cfg)
    db_ms, db_by = bound(db, do)
    fb_ms, fb_by = bound(fb, fo)

    # this slice's path: chunked prefill and speculative decoding
    chunk_err = check_chunk(torch, spec)
    ck = time_chunk(torch, spec)
    ck32 = time_chunk(torch, spec, "float32")
    vk = time_decode(torch, spec, t=SPEC_K + 1)
    cells, cell_gates, cell_tokens = serve_slice(torch, cfg, params)
    trace_chunked = trace_decode(torch, cfg, params, span="engine.prefill",
                                 n_new=2, **_cell_kw("chunked"))
    trace_single = trace_decode(torch, cfg, params, span="engine.prefill",
                                n_new=2)
    trace_spec = trace_decode(torch, cfg, params, **_cell_kw("speculative"))

    # this slice's path: the paged layout and prefix sharing
    pg_err, pg_times, pg_route_ms = time_decode_paged(torch, spec)
    pcells, pgates = serve_paged(torch, cfg, params, tokens,
                                 cell_tokens["speculative"])
    trace_paged = trace_decode(torch, cfg, params, **_cell_kw("paged_default"))
    trace_shared = trace_decode(torch, cfg, params, span="engine.prefill",
                                n_new=2, prompts=_shared_prompts(cfg)[:4],
                                **_cell_kw("paged_shared"))
    trace_unshared = trace_decode(torch, cfg, params, span="engine.prefill",
                                  n_new=2, prompts=_shared_prompts(cfg)[:4],
                                  **_cell_kw("paged_chunked"))
    # phase 21: compiled dispatch against eager dispatch
    ggates, gengines = graph_gates(torch, cfg, params, "bf16")
    gturns = graph_turns(torch, gengines)
    gmixed = graph_mixed_stream(torch, cfg, params)
    gtraces = {
        "decode": trace_decode(torch, cfg, params, graphs=False),
        "verify": trace_decode(torch, cfg, params, graphs=False,
                               **_cell_kw("speculative")),
        "chunked prefill": trace_decode(torch, cfg, params,
                                        span="engine.prefill", n_new=2,
                                        graphs=False, **_cell_kw("chunked")),
        "paged decode": trace_decode(torch, cfg, params, graphs=False,
                                     **_cell_kw("paged_default"))}
    # phase 22: telemetry on the graph engines of phase 21's cells
    tel, tel_turns, tel_prof, tel_census = telemetry(torch, cfg, params,
                                                     gengines)
    tel_trace = trace_decode(torch, cfg, params, metrics=True)
    # phase 23: resilience on phase 21's cell
    res23 = resilience(torch, cfg, params, gengines, card)
    # phase 26: swatlint on the card, on phase 3's params
    lint26 = swatlint(torch, cfg, params, card)
    del gengines
    del params
    cells32 = serve_slice_fp32(torch, cfg)
    # phase 24: granite-moe-1b-a400m + SWAT, served and trained
    moe24 = moe(torch, card, gturns)
    moe_launch = {k: v["launches"] for k, v in moe24["cells"].items()}
    # phase 25: mamba2-1.3b and jamba-1.5-large + SWAT, served and trained
    mamba25 = mamba(torch, card, gturns)
    jamba_launch = mamba25["jamba_launches"]

    dq_err, dkv_err, combine_err = check_backward(torch, spec)
    tr, tr_launches, tr_state = train(torch, cfg)
    if not tr["losses"][-1] < tr["losses"][0]:
        raise AssertionError(f"train: loss did not fall: {tr['losses']}")
    bt = time_backward(torch, spec)
    ft = time_forward_train(torch, spec)
    ttrace = trace_train_step(torch, tr_state)
    # phase 27: context parallelism and the pipeline, on phase 8's params
    cp27 = context_pipeline(torch, cfg, tr_state, card)
    # phase 29: training on a mesh, on phase 8's state (consumed here)
    holder = {"state": tr_state}
    del tr_state
    mesh29 = train_mesh(torch, cfg, holder, tr, card)
    mesh_launch = mesh29["llama_2x2"]["launches"]
    # phase 28: serving on a mesh, on phase 3's cell
    mesh28 = serve_mesh(torch, cfg, tokens, card)
    # phase 30: swatlint on a mesh, and the paper's sliding-chunks baseline
    t30 = time.perf_counter()
    lint30 = mesh_lint(torch, card)
    paper30 = paper_baseline(torch, card)
    lint30["wall_s_phase"] = time.perf_counter() - t30
    # phase 31: whisper and the cp / fsdp train profiles on a mesh, and the
    # dry-run's count against the card
    gaps31 = mesh_gaps_and_dryrun(torch, cfg, card)
    tr_e2e = train_end_to_end(torch, cfg)
    resume = resume_drill(torch)

    plain_err = check_decode_plain(torch)
    sweep = sweep_plain_splits(torch)
    g2_errs, g2_times = check_gemma2(torch)
    wh, wh_e2e, wh_times = whisper(torch)
    pk, pp, pl, pb, po = time_decode_plain(torch)
    pb_ms, pb_by = bound(pb, po)
    kernels = [
        {"name": "swat_decode_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/swat_decode.cu",
         "replaces": "src/repro/kernels/swat_decode.py:116",
         "launches": summary["launches"]["swat_decode"]
         + moe_launch["default"]["swat_decode"]
         + jamba_launch["swat_decode"],
         "max_abs_err": dec_err[1], "ms": dk, "plain_ms": dp,
         "bound_ms": db_ms, "bound_by": db_by, "library_ms": dl},
        {"name": "swat_attention_fwd_tc", "route": "cuda",
         "source": "src/repro_torch/csrc/swat_attention_fwd.cu",
         "replaces": "src/repro/kernels/swat_attention.py:64",
         "launches": summary["launches"]["swat_attention_fwd"]
         + moe_launch["default"]["swat_attention_fwd"]
         + jamba_launch["swat_attention_fwd"]
         + mesh_launch["swat_attention_fwd"],
         "max_abs_err": fwd_err, "ms": fk, "plain_ms": fp,
         "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": fl},
        {"name": "swat_decode_plain", "route": "cuda",
         "source": "src/repro_torch/csrc/swat_decode.cu",
         "replaces": "src/repro/kernels/swat_decode.py:368",
         "launches": wh["launches"]["swat_decode_plain"],
         "max_abs_err": plain_err, "ms": pk, "plain_ms": pp,
         "bound_ms": pb_ms, "bound_by": pb_by, "library_ms": pl},
    ]
    # this slice's launch configurations: the verify step's T = k+1 rows,
    # and pass A of a prefill chunk with offsets (bf16 on the tensor-core
    # kernel, fp32 on the SIMT one)
    vb_ms, vb_by = bound(vk[3], vk[4])
    kernels.append(
        {"name": "swat_decode_fused (verify step, T=5)", "route": "cuda",
         "source": "src/repro_torch/csrc/swat_decode.cu",
         "replaces": "src/repro/kernels/swat_decode.py:116",
         "launches": cells["speculative"]["launches"]["swat_decode"]
         + moe_launch["speculative"]["swat_decode"],
         "max_abs_err": dec_err[SPEC_K + 1], "ms": vk[0], "plain_ms": vk[1],
         "bound_ms": vb_ms, "bound_by": vb_by, "library_ms": vk[2]})
    for name, times, launches, dn in (
            ("swat_attention_fwd_tc (prefill chunk, offsets)", ck,
             cells["chunked"]["launches"]["swat_attention_fwd"]
             + moe_launch["chunked"]["swat_attention_fwd"], "bfloat16"),
            ("swat_attention_fwd (SIMT, fp32 prefill chunk, offsets)", ck32,
             cells32["chunked"]["launches"]["swat_attention_fwd"],
             "float32")):
        b_ms, b_by = bound(times[3], times[4], dn)
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/swat_attention_fwd.cu",
             "replaces": "src/repro/kernels/swat_attention.py:64",
             "launches": launches, "max_abs_err": chunk_err[dn],
             "ms": times[0], "plain_ms": times[1], "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": times[2]})
    # the combine has no single PyTorch call that computes it (library null)
    for name, key, err, counted in (
            ("swat_attention_dq_tc", "dq", dq_err, "swat_attention_dq"),
            ("swat_attention_dkv_tc", "dkv", dkv_err, "swat_attention_dkv"),
            ("swat_attention_dkv_combine", "combine", combine_err,
             "swat_attention_dkv_combine")):
        ms, p_ms, l_ms, bytes_, ops_ = bt[key]
        b_ms, b_by = bound(bytes_, ops_)
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/swat_attention_bwd.cu",
             "replaces": ("src/repro/kernels/swat_backward.py:51"
                          if key == "dq" else
                          "src/repro/kernels/swat_backward.py:93"),
             "launches": tr_launches[counted]
             + moe24["train"]["launches"][counted]
             + mesh_launch[counted], "max_abs_err": err,
             "ms": ms,
             "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": l_ms})
    # phase 27: the CP band pass (kernels #2, #4 and #5 with offsets) at
    # the CP train step's shard shape; launches from that step
    for name, key, src, rep in (
            ("swat_attention_fwd_tc (CP band pass, offsets)", "fwd",
             "swat_attention_fwd.cu", "swat_attention.py:64"),
            ("swat_attention_dq_tc (CP band pass, offsets)", "dq",
             "swat_attention_bwd.cu", "swat_backward.py:51"),
            ("swat_attention_dkv_tc (CP band pass, offsets)", "dkv",
             "swat_attention_bwd.cu", "swat_backward.py:93")):
        ms, p_ms, l_ms, bytes_, ops_, err = cp27["band_times"][key]
        b_ms, b_by = bound(bytes_, ops_)
        kernels.append(
            {"name": name, "route": "cuda",
             "source": f"src/repro_torch/csrc/{src}",
             "replaces": f"src/repro/kernels/{rep}",
             "launches": cp27["train"]["launches"][
                 f"swat_attention_{key}"],
             "max_abs_err": err, "ms": ms, "plain_ms": p_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms})
    pb_ms_, pb_by_ = bound(pg_times[3], pg_times[4])
    kernels.append(
        {"name": "swat_decode_fused (paged view)", "route": "cuda",
         "source": "src/repro_torch/csrc/swat_decode.cu",
         "replaces": "src/repro/kernels/swat_decode.py:116",
         "launches": pcells["paged_default"]["launches"]["swat_decode"],
         "max_abs_err": pg_err, "ms": pg_times[0], "plain_ms": pg_times[1],
         "bound_ms": pb_ms_, "bound_by": pb_by_, "library_ms": pg_times[2]})
    log(f"serve summary: {json.dumps(summary)}")
    log(f"serve cells (bf16): {json.dumps(cells)}")
    log(f"serve cell gates (bf16): {json.dumps(cell_gates)}")
    log(f"serve cells (fp32): {json.dumps(cells32)}")
    log("chunked / single-shot prefill ms a batch (bf16): "
        f"{cells['chunked']['prefill_ms_per_batch'] / summary['prefill_ms_per_batch']:.3f}")
    log(f"trace chunked prefill: {json.dumps(trace_chunked)}")
    log(f"trace single-shot prefill: {json.dumps(trace_single)}")
    log(f"trace verify block: {json.dumps(trace_spec)}")
    log(f"chunk pass A (pos0 448, bf16): kernel {ck[0]:.4f} ms, plain "
        f"{ck[1]:.4f}, SDPA {ck[2]:.4f}; whole chunk route {ck[5]:.4f} ms, "
        f"plain chunk attention {ck[6]:.4f}")
    log(f"chunk pass A (pos0 448, fp32): kernel {ck32[0]:.4f} ms, plain "
        f"{ck32[1]:.4f}, SDPA {ck32[2]:.4f}; whole chunk route "
        f"{ck32[5]:.4f} ms, plain chunk attention {ck32[6]:.4f}")
    log(f"fused decode at T={SPEC_K + 1}: kernel {vk[0]:.5f} ms, plain "
        f"{vk[1]:.4f}, SDPA {vk[2]:.4f}, bound {vb_ms:.6f} ({vb_by}); "
        f"T=1 {dk:.5f} ms")
    log(f"serve paged cells (bf16): {json.dumps(pcells)}")
    log(f"serve paged gates (bf16): {json.dumps(pgates)}")
    log(f"trace paged decode: {json.dumps(trace_paged)}")
    log(f"trace shared-prefix prefill: {json.dumps(trace_shared)}")
    log(f"trace unshared paged chunked prefill: {json.dumps(trace_unshared)}")
    log(f"fused decode on the paged view: kernel {pg_times[0]:.5f} ms, "
        f"plain {pg_times[1]:.4f}, SDPA {pg_times[2]:.4f}, bound "
        f"{pb_ms_:.6f} ({pb_by_}); whole paged route (gather, kernel, "
        f"scatter) {pg_route_ms:.5f} ms")
    ratio = (pcells["decode_ms_per_step_in_turns"]["paged_over_contiguous"],
             pcells["prefill_ms_per_batch_in_turns"]["shared_over_unshared"])
    log(f"paged / contiguous decode ms a step (bf16, in turns): "
        f"{ratio[0]:.3f}; shared / unshared prefill ms a batch (warmed "
        f"engines, in turns): {ratio[1]:.3f}")
    log(f"graphs gates (bf16): {json.dumps(ggates)}")
    log(f"graphs gates (fp32): {json.dumps(cells32['graphs'])}")
    log(f"graphs vs eager in turns (bf16): {json.dumps(gturns)}")
    log(f"graphs mixed stream (bf16): {json.dumps(gmixed)}")
    for name, (g, e) in {"decode": (trace, gtraces["decode"]),
                         "verify": (trace_spec, gtraces["verify"]),
                         "chunked prefill": (trace_chunked,
                                             gtraces["chunked prefill"]),
                         "paged decode": (trace_paged,
                                          gtraces["paged decode"])}.items():
        unit = "batch" if name == "chunked prefill" else "step"
        log(f"graphs vs eager trace, {name}: " + json.dumps({
            mode: {k: t.get(k) for k in (
                "span_busy_share", "run_busy_share", f"kernels_per_{unit}",
                "fused_decode_kernels_per_step", "span_host_ms",
                "span_device_busy_ms", "captured_in_traced_run")}
            for mode, t in (("graphs", g), ("eager", e))}))
    log(f"telemetry cells (bf16): {json.dumps(tel)}")
    for cell, v in tel.items():
        lat = v["latency_ms_replay_run"]
        log(f"telemetry latency {cell} (bf16, replay run, ms): " + "; ".join(
            f"{m} p50 {lat[m]['p50']:.3f} p95 {lat[m]['p95']:.3f} p99 "
            f"{lat[m]['p99']:.3f}" for m in ("ttft", "tpot", "queue_delay")))
    log(f"telemetry metrics on vs off in turns (bf16): "
        f"{json.dumps(tel_turns)}")
    log("telemetry trace, decode step with metrics on vs off (graphs): "
        + json.dumps({k: {"metrics_on": tel_trace.get(k),
                          "metrics_off": trace.get(k)}
                      for k in ("kernels_per_step",
                                "fused_decode_kernels_per_step",
                                "span_busy_share", "span_host_ms",
                                "span_device_busy_ms", "decode_steps")}))
    log(f"telemetry profile_decode at phase 5's shape: kernel p50 "
        f"{tel_prof['p50_us'] / 1e3:.5f} ms, bound {tel_prof['bound_ms']:.6f}"
        f" ms ({tel_prof['bound_by']}), {tel_prof['bound_share'] * 100:.2f}% "
        f"of the bound; phase 5 (L2 flushed) {dk:.5f} ms")
    log(f"resilience (bf16; {card}): {json.dumps(res23)}")
    log(f"swatlint (phase 26; {card}): {json.dumps(lint26)}")
    log(f"granite-moe (phase 24; {card}): {json.dumps(moe24)}")
    log(f"mamba2 and jamba (phase 25; {card}): {json.dumps(mamba25)}")
    log(f"context parallelism and pipeline (phase 27; {card}): "
        f"{json.dumps(cp27)}")
    log(f"serving on a mesh (phase 28; {card}): {json.dumps(mesh28)}")
    log(f"training on a mesh (phase 29; {card}): {json.dumps(mesh29)}")
    log(f"mesh lint (phase 30; {card}): {json.dumps(lint30)}")
    log(f"paper baseline (phase 30; {card}): {json.dumps(paper30)}")
    log(f"mesh gaps and dry-run (phase 31; {card}): {json.dumps(gaps31)}")
    log(f"e2e: {json.dumps(e2e)}")
    log(f"trace: {json.dumps(trace)}")
    log(f"unembed: {json.dumps(unembed)}")
    log(f"train summary: {json.dumps(tr)}")
    log(f"train trace: {json.dumps(ttrace)}")
    log(f"forward at L=2048: {json.dumps(ft)}")
    log(f"dK/dV at L=2048: tensor-core launch + combine "
        f"{bt['dkv_total_ms']:.4f} ms")
    log(f"train e2e: {json.dumps(tr_e2e)}")
    log(f"resume: {json.dumps(resume)}")
    log(f"plain decode split sweep: {json.dumps(sweep)}")
    log(f"gemma2 D=256 errors (bf16): {json.dumps(g2_errs)}")
    log(f"gemma2 D=256 times: {json.dumps(g2_times)}")
    log(f"whisper: {json.dumps(wh)}")
    log(f"whisper e2e: {json.dumps(wh_e2e)}")
    log(f"whisper times: {json.dumps(wh_times)}")
    log(f"plain decode at the cross shape: kernel {pk:.4f} ms, plain "
        f"{pp:.4f} ms, SDPA {pl:.4f} ms, bound {pb_ms:.5f} ms ({pb_by})")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
