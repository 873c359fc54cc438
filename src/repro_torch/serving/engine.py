"""Continuous-batching serving engine (the port of the JAX package's
`serving/engine.py` in its single-device mode).

  * a static batch of slots with PER-SLOT ring write positions: slots at
    different depths share one batched kernel call per layer,
  * batched, padded prefill: the scheduler packs the pending prompts that
    fit into one call (per-row `lengths` mask the padding), and the primed
    caches are copied into the admitted slots. With `prefill_chunk`, the
    padded batch walks the prompt in lockstep chunks (`model.prefill_chunk`)
    so attention scores stay (chunk, ring + chunk) whatever the prompt
    length; each chunk carries every row's last-real-token logits,
  * block decode: `scan_steps` decode steps per host sync. Tokens, the
    active/budget/poisoned flags and the caches stay on the device through
    a block (caches updated in place); the host reads the block's tokens
    once at its end,
  * speculative decoding (`speculative=k`): each verify step proposes k
    tokens per slot with the n-gram drafter, runs them and the pending
    token through one T = k+1 `decode_step` on a ring with k lookahead
    rows, keeps the longest verified prefix plus the model's next token,
    and rolls every ring pointer back over the rejected rows. Greedy rows
    give exactly the sequential engine's tokens. An acceptance ladder
    (`spec_min_acceptance`) turns speculation off when drafts stop landing
    and probes to turn it back on,
  * per-slot temperature / top-k sampling, and the `finite_rows` guard:
    a slot whose logits go non-finite is quarantined (status "poisoned"),
    every other slot untouched,
  * the paged KV layout (`kv_layout="paged"`): one block pool per layer
    with per-slot block tables kept by `serving/paged.py`'s PagedManager.
    Prefill stays contiguous and is paginated into the slots' blocks at
    admission; every decode or verify block first copies-on-write the
    shared blocks it will write and pushes the host tables. With
    `share_prefix`, a batch whose prompts share a prefix prefills it once
    on one row, copies that row to every row, walks only the suffixes in
    chunks, and block-shares the prefix pages the suffixes never write.

Blocks stop at the earliest slot completion, so the generator advances in
the same order whatever `scan_steps` is and block decode is token-for-token
stepwise decode.

Compiled dispatch (`graphs`, the JAX engine's `_Compiled` jit cache): on the
card, each hot path is captured once per shape as a CUDA graph and
replayed, so the host launches one graph where it launched hundreds of
kernels. A sequential decode block is keyed by (n, slots, greedy-only), a
verify step by (slots, greedy-only) and replayed up to n times, a prefill
chunk by (rows, pos0, chunk length). A key's first use runs eagerly (the
warm-up: kernel builds, pattern uploads, cuBLAS set-up), its second use
captures and replays it, and every later use replays. Decode and verify
keys are bounded by `scan_steps`; chunk keys grow with every new prompt or
prefix length, so at most CHUNK_GRAPHS chunk graphs are kept and the least
recently used is dropped (its key is captured again at its next use).
Every carry a graph reads and writes (the caches and their steps, the
staged per-slot vectors, the drafter history, the chunked-prefill caches
and logits) is updated in place, so its storage is fixed for the engine's
lifetime; on the CPU the engine runs the same functions eagerly.
Copy-on-write, table pushes, admission and the one host read a block (or
verify step) stay between replays, where the JAX engine has them too. A
capture or replay that fails raises; nothing falls back to eager.

Telemetry (`repro_torch.telemetry`, the JAX engine's swatscope hooks): with
`metrics=True` the decode and verify bodies update int32 device counters in
place (captured and replayed with the rest of the body; tokens unchanged),
read only by `device_metrics()`. Every engine keeps a `Tracer` of request
lifecycles and block spans (TTFT, TPOT, queue delay), fed by host hooks
between dispatches and by the degradation-event bus, and exports
`metrics_text()`, `chrome_trace()` and `snapshot()`. While a torch
profiler is active, each admission batch runs inside an "engine.prefill"
span and each decode or verify block inside an "engine.decode_block"
span, whose child spans name the phases ("engine.prefill.upload", ...,
"engine.decode_block.retire"; `telemetry.tracer.span`); none goes inside
a captured body. Each phase boundary the engine accounts for is read
once, on the tracer's clock: `stats["prefill_s"]` and `stats["decode_s"]`
take the times the tracer's hooks recorded (`Tracer.last`).

Resilience (the JAX engine's chaos layer, `serving/faults.py`): a
`FaultPlan` puts NaN or +Inf into chosen slots' logits inside the decode
and verify bodies (a per-slot countdown in place beside the staged vectors
and one masked `where`, captured and replayed with the body; an engine
with no logit or draft faults captures exactly the production bodies),
corrupts drafts, or writes NaN over a slot's K cache between blocks; the
guard quarantines the slot and every other slot stays bitwise. `run()`
sheds requests beyond `max_pending`, expires `Request.deadline`s at block
boundaries, and readmits failed requests up to `Request.max_retries`
times. The one step down is `_kernel_fallback`: a `KernelDispatchError`
out of a decode or verify block switches the engine to the plain decode
version for good, counted in `stats["kernel_fallbacks"]`, put on the
event bus and warned once. A failure armed after a key was captured does
not raise: its replays run no Python (as a JAX jit-cache hit is not
traced again).

Meshes (`mesh=`, `profile=`; the JAX engine's mesh-sharded serving): the
params are placed once at construction by `param_sharding_serving`, the
caches by `cache_sharding` (the paged pool slot-local, PagedManager's
"local" mode), and every model call runs the model's forward with
`distributed/tensor_parallel.py`'s plan over the mesh's local shards. The engine's per-slot vectors,
token blocks, drafter history and device counters hold the slots of its
local shards (`decode_batch_sharding`): every slot on a LocalMesh, the
rank's slot group on a ProcessMesh. The samplers draw the whole slot
batch's noise and keep their rows, so a slot-parallel mesh gives the
single-device engine's tokens, sampled rows included. On a ProcessMesh each
host sync all-gathers the blocks over the slot axes, so every rank's
scheduler runs on the same state; the decode and verify bodies themselves
run no collective over the slot axes. The scheduler keeps prefill batches
a multiple of the slot axes' size (`slot_quantum`).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
import warnings
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import layers as L
from repro_torch.core import model as Mod
from repro_torch.core.types import ModelConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import _build
from repro_torch.serving import faults as F
from repro_torch.serving import sampling
from repro_torch.serving.drafter import NGramDrafter, get_drafter
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.paged import PagedManager
from repro_torch.serving.scheduler import (PrefillPlan, Scheduler,
                                           normalize_prompt)
from repro_torch.telemetry import events as TEV
from repro_torch.telemetry import metrics as MX
from repro_torch.telemetry.tracer import Tracer, prometheus_text, span

# the Result status taxonomy (the JAX engine's):
#   ok        full budget served (or prompt-only request)
#   rejected  never admitted: malformed / oversized / out-of-vocab prompt,
#             or queue overflow
#   poisoned  quarantined mid-decode: non-finite logits in the slot's row;
#             tokens holds everything emitted BEFORE the poison
#   deadline  the request's deadline expired (partial tokens kept)
#   failed    a kernel dispatch failed after the block wrote the caches
STATUSES = ("ok", "rejected", "poisoned", "deadline", "failed")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # any int spelling; normalized to (L,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    # seconds from run()'s start; None: no deadline. Checked at block
    # boundaries, so it resolves to one block; an expired request keeps
    # what it has
    deadline: Optional[float] = None
    # readmissions after a "failed" slot (a kernel dispatch failure after
    # the caches were written): each retry restarts from the prompt, the
    # dead slot's tokens are dropped
    max_retries: int = 0

    def __post_init__(self):
        # a ragged prompt that cannot normalize is kept as-is: the
        # scheduler rejects it per request instead of raising here
        try:
            self.prompt = normalize_prompt(self.prompt)
        except (ValueError, TypeError):
            pass


@dataclasses.dataclass
class Result:
    rid: int
    tokens: List[int]
    status: str = "ok"           # one of STATUSES
    reason: str = ""             # detail for status != ok
    retries: int = 0             # readmissions used (see max_retries)

    @property
    def ok(self) -> bool:
        return self.status == "ok"


# decode_impl (the JAX engine's names) -> the `impl` of `model.decode_step`
_DECODE_IMPLS = {None: None, "pallas": "kernel", "ref": "ref"}

# chunk graphs an engine keeps: a chunk's key holds its pos0, which a
# traced pos0 would remove (ROADMAP item 6d)
CHUNK_GRAPHS = 64


def capture_graph(body, shared: Dict, generator: torch.Generator):
    """Capture `body()` into a CUDA graph. Every graph of an engine
    captures on one side stream and allocates from one memory pool, kept
    in `shared` (made at its first capture). The engine's generator is
    registered with the graph, so each replay draws fresh noise and
    advances it as an eager call would. The capture records and runs
    nothing; the caller replays the graph to run it. Returns (the graph,
    the bytes the pool grew by while capturing it)."""
    if not shared:
        shared.update(pool=torch.cuda.graph_pool_handle(),
                      stream=torch.cuda.Stream())
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    with torch.cuda.graph(graph, pool=shared["pool"],
                          stream=shared["stream"]):
        reserved = torch.cuda.memory_reserved()
        body()
        grown = torch.cuda.memory_reserved() - reserved
    return graph, grown


class _Compiled:
    """The engine's captured CUDA graphs, one per key (the counterpart of
    the JAX engine's `_Compiled` jit cache). `run(key, body)` runs body()
    eagerly at the key's first use (the warm-up), captures it at the
    second and replays it then and at every later use; with `enabled`
    False (CPU params, or graphs=False) it always runs body() eagerly.
    At most CHUNK_GRAPHS chunk graphs (key[0] == "chunk") are kept, the
    least recently used dropped. The launch counters count what ran: the
    launches the wrappers counted during a capture are taken back and
    added at every replay."""

    def __init__(self, enabled: bool, generator: torch.Generator):
        self.enabled = enabled
        self.generator = generator
        self._seen = set()
        self._graphs: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()       # least recently used first
        self._shared: Dict = {}             # capture_graph's pool, stream
        self.captured: List[tuple] = []     # keys, in capture order
        self.capture_s = 0.0                # host time spent capturing
        self.pool_bytes = 0                 # the shared pool's size
        self.replays = 0
        self.evicted = 0                    # chunk graphs dropped

    def run(self, key: tuple, body) -> None:
        if not self.enabled:
            body()
            return
        entry = self._graphs.get(key)
        if entry is None:
            if key not in self._seen:
                self._seen.add(key)
                body()
                return
            if key[0] == "chunk":
                self._make_room()
            entry = self._graphs[key] = self._capture(key, body)
        self._graphs.move_to_end(key)
        graph, deltas = entry
        try:
            graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph replay of {key} failed: {e}") \
                from e
        _build.add_launches(deltas)
        self.replays += 1

    def _make_room(self) -> None:
        """Drop the least recently used chunk graphs until one more fits
        under CHUNK_GRAPHS."""
        held = [k for k in self._graphs if k[0] == "chunk"]
        for k in held[:max(0, len(held) - CHUNK_GRAPHS + 1)]:
            del self._graphs[k]
            self.evicted += 1

    def _capture(self, key: tuple, body) -> tuple:
        t0 = time.perf_counter()
        before = _build.launch_counts()
        try:
            graph, grown = capture_graph(body, self._shared, self.generator)
        except F.KernelDispatchError:
            raise                    # the engine's step down handles it
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture of {key} failed: {e}") \
                from e
        finally:
            after = _build.launch_counts()
            _build.set_launch_counts(before)
        self.captured.append(key)
        self.capture_s += time.perf_counter() - t0
        self.pool_bytes += grown
        return graph, [a - b for a, b in zip(after, before)]


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 8,
                 max_len: int = 4096, seed: int = 0, scan_steps: int = 8,
                 batch_prefill: bool = True, prefill_chunk: int = 0,
                 max_prefill_tokens: int = 8192, pad_to: int = 16,
                 top_k: int = 0, tokens_per_step: int = 1,
                 speculative: int = 0, draft: Optional[NGramDrafter] = None,
                 max_prompt_len: Optional[int] = None,
                 spec_min_acceptance: float = 0.0,
                 spec_acceptance_window: int = 4,
                 spec_retry_blocks: int = 8,
                 spec_resume_acceptance: Optional[float] = None,
                 kv_layout: str = "contiguous", share_prefix: bool = False,
                 share_min_prefix: int = 16,
                 decode_impl: Optional[str] = None,
                 graphs: Optional[bool] = None, mesh=None,
                 profile: str = "tp", faults=None,
                 max_pending: Optional[int] = None, metrics: bool = False,
                 trace_capacity: int = 4096):
        """Runs on the device that holds `params` (see `model.init_model` /
        `interop.params_from_jax`): the CUDA kernels on a card, their plain
        versions for CPU params. scan_steps: decode steps per host sync;
        batch_prefill=False admits one prompt per prefill call;
        max_prompt_len: reject longer prompts (status "rejected").

        prefill_chunk: sequence-axis prefill chunk (0 = single-shot); set to
        0 for configs `model.prefill_chunkable` refuses. A batch no longer
        than one chunk prefills single-shot.

        tokens_per_step: ring lookahead for multi-token decode steps: the
        caches carry T-1 extra ring rows. Tokens are unchanged (the
        positional window mask hides the extra depth).

        speculative: draft tokens per verify step (0 = sequential decode),
        proposed by `draft` (default: NGramDrafter). Raises tokens_per_step
        to at least speculative+1, the lookahead rows the rollback needs.
        Acceptance counts accumulate in `stats` / `acceptance_rate`.

        spec_min_acceptance: when the draft acceptance rate over the last
        `spec_acceptance_window` speculative blocks falls below it, decode
        sequentially (same greedy tokens); after `spec_retry_blocks`
        sequential blocks, probe one speculative block and resume if its
        rate reaches `spec_resume_acceptance` (default: the same
        threshold). 0.0 (default) disables the ladder.

        kv_layout: "contiguous" (per-slot ring caches) or "paged" (block
        pools and tables; tokens identical). share_prefix (paged, and
        prefill_chunk > 0): an admission batch of >= 2 prompts sharing at
        least `share_min_prefix` leading tokens prefills them once and
        shares their blocks.

        decode_impl: the decode and verify steps' attention. None: the
        device's default (the fused CUDA kernel on the card, its plain
        version on the CPU); "pallas" (the JAX engine's name): the kernel,
        and a ValueError for CPU params; "ref": the plain versions.

        graphs: replay decode blocks, verify steps and prefill chunks as
        captured CUDA graphs (see the module docstring). None: on CUDA
        params, eagerly on CPU ones; False: eagerly on the card too (the
        counterpart of running the JAX engine under jax.disable_jit, and
        the eager reference graphs are held to); True on CPU params raises
        ValueError.

        metrics: keep device-resident telemetry counters
        (`telemetry.metrics`), updated in place by every decode and verify
        step and read only by `device_metrics()` / `metrics_text()`, never
        inside a block. metrics=False (default) engines run and capture
        exactly the bodies they ran without telemetry; metrics=True tokens
        are bitwise identical.

        trace_capacity: ring-buffer depth of the always-on host-side
        `self.tracer` (request lifecycle spans, decode-block spans,
        degradation events): memory stays O(trace_capacity), however long
        the engine serves.

        faults: a `serving.faults.FaultPlan` (the chaos layer). Logit
        faults add a countdown vector and one masked select to the decode
        and verify bodies, corrupt_draft_slots one select to the verify
        body; None or FaultPlan() keeps the production bodies. The guard
        (quarantine of non-finite rows) is always in them.
        max_pending: `run()` rejects requests beyond this queue depth
        (status "rejected", "queue overflow") instead of queueing them.

        mesh: a `launch.mesh` LocalMesh or ProcessMesh, or a "DxM" string
        (`parse_mesh`; a ProcessMesh when a torch.distributed group is
        initialised). params are the whole model on every process; the
        engine keeps its shards. profile: the param rule table, "tp"
        (default), "cp" or "fsdp" (see the module docstring)."""
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"kv_layout={kv_layout!r}: 'contiguous' or "
                             "'paged'")
        if decode_impl not in _DECODE_IMPLS:
            raise ValueError(f"decode_impl={decode_impl!r}: one of "
                             f"{sorted(_DECODE_IMPLS, key=str)}")
        self.speculative = max(0, speculative)
        if self.speculative and not Mod.speculative_supported(cfg):
            raise ValueError(
                f"{cfg.name}: speculative decoding needs rotary positions "
                "and attention-only layers (no mamba or encoder-decoder "
                "state to roll back)")
        if cfg.encoder_decoder:
            raise NotImplementedError(
                f"{cfg.name}: the engine serves decoder-only models, as the "
                "JAX engine does; drive encoder-decoder models through "
                "model.prefill / model.decode_step")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.mesh = (None if mesh is None
                     else TP.resolve_mesh(mesh, self.device))
        self.profile = profile
        if decode_impl == "pallas" and self.device.type != "cuda":
            raise ValueError("decode_impl='pallas' runs the CUDA decode "
                             f"kernel; the params are on {self.device}")
        if graphs and self.device.type != "cuda":
            raise ValueError("graphs=True replays CUDA graphs; the params "
                             f"are on {self.device}")
        self.decode_impl = decode_impl
        self._impl = _DECODE_IMPLS[decode_impl]
        self.slots = batch_slots
        self.max_len = max_len
        self.scan_steps = max(1, scan_steps)
        self.batch_prefill = batch_prefill
        self.prefill_chunk = (prefill_chunk if Mod.prefill_chunkable(cfg)
                              else 0)
        self.top_k = top_k
        self.tokens_per_step = max(1, tokens_per_step, self.speculative + 1)
        self.lookahead = self.tokens_per_step - 1
        self.drafter = get_drafter(draft) if self.speculative else None
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._compiled = _Compiled(
            self.device.type == "cuda" if graphs is None else bool(graphs),
            self.generator)
        # the mesh plan (None on one device) and the slots [_lo, _lo +
        # _nloc) that this process's shards hold
        self._mp: Optional[TP.MeshPlan] = None
        self._lo, self._nloc = 0, batch_slots
        quantum = 1
        if self.mesh is not None:
            self._mp = TP.MeshPlan(cfg, self.mesh, params, slots=batch_slots,
                                   max_len=max_len, lookahead=self.lookahead,
                                   paged=kv_layout == "paged",
                                   profile=profile)
            self.shard_params = self._mp.place_params(params)
            lo, hi = self._mp.local_slots()
            self._lo, self._nloc = lo, hi - lo
            quantum = self._mp.slot_quantum()
        self.scheduler = Scheduler(
            max_prefill_tokens=max_prefill_tokens, pad_to=pad_to,
            slot_quantum=quantum, max_prompt_len=max_prompt_len,
            vocab_size=cfg.vocab_size)
        self.kv_layout = kv_layout
        self.share_prefix = bool(share_prefix) and kv_layout == "paged"
        self.share_min_prefix = max(1, share_min_prefix)
        self._paged: Optional[PagedManager] = None
        if kv_layout == "paged":
            self._paged = PagedManager(
                Mod.paged_layout(cfg, max_len, self.lookahead), batch_slots,
                mode="shared" if self.mesh is None else "local")
        # one device: `caches`; a mesh: `shard_caches`, one cache tree per
        # local shard (coordinate), and `caches` None
        self.caches = self.shard_caches = None
        if self._mp is None:
            self.caches = Mod.init_caches(cfg, batch_slots, max_len,
                                          lookahead=self.lookahead,
                                          paged=kv_layout == "paged",
                                          device=self.device)
        else:
            self.shard_caches = self._mp.init_caches(self.device)
        # next ring-write token position per slot (the paged COW plan)
        self._slot_pos = np.zeros((batch_slots,), np.int64)
        self.slot_free = [True] * batch_slots
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_out: List[List[int]] = [[] for _ in range(batch_slots)]
        self.slot_last = np.zeros((batch_slots,), np.int32)
        self.slot_budget = np.zeros((batch_slots,), np.int32)
        self.slot_temp = np.zeros((batch_slots,), np.float32)
        nloc = self._nloc
        if self.drafter is not None:
            # drafter history: device-resident, rows written at admission
            self.slot_hist, self.slot_hcnt = self.drafter.init_state(
                nloc, self.device)
        dev = self.device
        # the per-slot decode vectors on the device (the local slots):
        # static buffers that the host mirrors are copied into after an
        # admission (`_stage`) and that every block updates in place
        self._dev: Dict[str, torch.Tensor] = dict(
            tok=torch.zeros((nloc,), dtype=torch.int32, device=dev),
            active=torch.zeros((nloc,), dtype=torch.bool, device=dev),
            budget=torch.zeros((nloc,), dtype=torch.int32, device=dev),
            temps=torch.zeros((nloc,), dtype=torch.float32, device=dev),
            poisoned=torch.zeros((nloc,), dtype=torch.bool, device=dev))
        # device metrics (metrics=True): static counters beside the staged
        # vectors, never reset by a restage, updated in place by every
        # captured body and read only by device_metrics()
        self.metrics = bool(metrics)
        self.ring_mod = MX.ring_modulus(cfg, max_len, self.lookahead)
        self._mx = MX.init_metrics(nloc, dev) if self.metrics else None
        # host-side lifecycle tracer (always on: O(1) Python per hook, no
        # device work) and its subscription to the degradation-event bus
        self.tracer = Tracer(capacity=trace_capacity)
        TEV.BUS.subscribe(self.tracer.on_bus_event)
        self._stale = True       # host mirrors changed since the last stage
        self._anyt = False       # any live slot samples (temperature > 0)
        # each block's tokens and emit flags: (scan_steps, slots) for
        # sequential blocks, (scan_steps, slots, k+1) for verify blocks,
        # whose steps write row `_sidx` and flag in `_flip` that a slot's
        # `active` changed since the block began (`_active0`)
        t = self.speculative + 1
        self._toks = torch.zeros((self.scan_steps, nloc, t),
                                 dtype=torch.int32, device=dev)
        self._emit = torch.zeros((self.scan_steps, nloc, t),
                                 dtype=torch.bool, device=dev)
        self._sidx = torch.zeros((1,), dtype=torch.long, device=dev)
        self._flip = torch.zeros((), dtype=torch.bool, device=dev)
        self._active0 = torch.zeros((nloc,), dtype=torch.bool, device=dev)
        # chaos (faults): the per-slot countdown `fin` is a staged vector,
        # restaged with the others and decremented in place by the bodies;
        # the poison value per slot (NaN, or +Inf) and the draft corruption
        # mask are made once
        self.faults = faults if faults is not None else FaultPlan()
        self._bad_val = self._draft_mask = None
        here = slice(self._lo, self._lo + nloc)
        if self.faults.has_logit_faults:
            self._dev["fin"] = torch.zeros((nloc,), dtype=torch.int32,
                                           device=dev)
            self._bad_val = torch.as_tensor(
                np.where(self.faults.inf_mask(batch_slots), np.inf, np.nan)
                .astype(np.float32)[here], device=dev)
        if self.faults.corrupt_draft_slots and self.speculative:
            self._draft_mask = torch.as_tensor(
                self.faults.draft_mask(batch_slots)[here], device=dev)[:, None]
            self._draft_bad = torch.full(
                (nloc, self.speculative), cfg.vocab_size + 1337,
                dtype=torch.int32, device=dev)
        self._faults_fired: set = set()      # slots whose logit fault fired
        self._cache_poison_applied: set = set()
        self._fallback_warned = False
        self.max_pending = max_pending
        self._run_t0: Optional[float] = None   # run()'s start (deadlines)
        self._retry_counts: Dict[int, int] = {}
        self._readmit: List[Request] = []
        # chunked prefill's caches, last logits, chunk tokens and lengths:
        # one persistent set of batch_slots rows (one per local shard on a
        # mesh), made at the first chunked batch; a batch of n rows runs in
        # its first n rows
        self._chunk_buf: Optional[List[Dict]] = None
        self.spec_min_acceptance = float(spec_min_acceptance)
        self.spec_resume_acceptance = float(
            spec_min_acceptance if spec_resume_acceptance is None
            else spec_resume_acceptance)
        self.spec_retry_blocks = spec_retry_blocks
        self._acc_window: Deque[Tuple[int, int]] = collections.deque(
            maxlen=max(1, spec_acceptance_window))
        self._spec_off = False            # acceptance-ladder state
        self._blocks_since_spec = 0
        self._hist_stale = False          # drafter history behind slot_out
        self._completed: List[Result] = []
        # tracer-clock time of the work that ends in a host sync: a prefill
        # batch ends with its first sampled tokens, a decode block with its
        # token read-back. decode_steps counts executed steps of either
        # kind; spec_steps the verify steps among them, draft_proposed /
        # draft_accepted the drafts offered and kept. tokens_emitted counts
        # decode work (a failed attempt's tokens included), tokens_delivered
        # the tokens of final Results, once a request. The resilience
        # counters mirror the degradation-event bus
        self.stats = {"tokens_emitted": 0, "tokens_delivered": 0,
                      "quarantined": 0, "rejected": 0, "deadline": 0,
                      "failed": 0, "kernel_fallbacks": 0, "readmitted": 0,
                      "prefill_tokens_computed": 0, "prefill_batches": 0,
                      "prefill_s": 0.0, "decode_steps": 0, "decode_s": 0.0,
                      "spec_steps": 0, "draft_proposed": 0,
                      "draft_accepted": 0, "spec_autodisable": 0,
                      "spec_resume": 0, "prefill_prefix_shared": 0,
                      "cow_moves": 0}
        if self.faults.fail_pallas_dispatch:
            F.install_kernel_failure()

    @property
    def graphs(self) -> bool:
        """Whether the engine replays captured CUDA graphs."""
        return self._compiled.enabled

    @property
    def acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the verifier kept."""
        p = self.stats["draft_proposed"]
        return self.stats["draft_accepted"] / p if p else 0.0

    # ---------------------------------------------------- observability --
    def device_metrics(self, per_slot: bool = False) -> Dict[str, object]:
        """Read the device-resident counters: an explicit host sync between
        blocks (the one place the device counters reach the host). Returns
        int totals, or the raw (slots,) int32 vectors (and the step count)
        as numpy with per_slot=True. Empty when metrics=False."""
        if self._mx is None:
            return {}
        host = {k: (self._gather_slots(v) if v.dim() else v).cpu().numpy()
                for k, v in self._mx.items()}
        if per_slot:
            return host
        return {k: int(v.sum()) if v.ndim else int(v)
                for k, v in host.items()}

    def metrics_text(self) -> str:
        """Prometheus text exposition of host stats + device counters +
        tracer latency quantiles (one scrape endpoint's worth)."""
        counters = dict(self.stats)
        counters.update({f"device_{k}": v
                         for k, v in self.device_metrics().items()})
        counters.update(self.paged_stats())
        doc = {f"device_{k}": f"{v} (device-resident counter)"
               for k, v in MX.COUNTER_DOC.items()}
        return prometheus_text(counters, self.tracer.latency_summary(),
                               doc=doc)

    def chrome_trace(self) -> dict:
        """Chrome-trace JSON of the tracer's retained window (load in
        chrome://tracing / Perfetto)."""
        return self.tracer.chrome_trace(metadata={
            "model": self.cfg.name, "slots": self.slots,
            "decode_impl": self.decode_impl,
            "speculative": self.speculative, "kv_layout": self.kv_layout,
            "metrics": self.metrics})

    def snapshot(self) -> Dict[str, object]:
        """One observability snapshot (`scope census` prints it): host
        stats, device counters, latency quantiles, pool occupancy."""
        return {"stats": dict(self.stats),
                "device": self.device_metrics(),
                "latency": self.tracer.latency_summary(),
                "paged": self.paged_stats(),
                "ring_modulus": self.ring_mod,
                "dropped_trace_records": self.tracer.dropped_requests}

    # ---------------------------------------------------------- results --
    # non-ok statuses: the stats counter each bumps and the bus event each
    # records
    _STATUS_COUNTER = {"rejected": "rejected", "poisoned": "quarantined",
                       "deadline": "deadline", "failed": "failed"}
    _STATUS_EVENT = {"rejected": "request_rejected",
                     "poisoned": "slot_quarantined",
                     "deadline": "deadline_expired",
                     "failed": "request_failed"}

    def _finish(self, rid: int, tokens: List[int], status: str,
                reason: str = "") -> Result:
        """Finalize one request into `_completed` (the one result store, so
        an exception mid-run loses no finished work) and mirror a non-ok
        status to `stats` and the event bus."""
        res = Result(rid, tokens, status=status, reason=reason,
                     retries=self._retry_counts.get(rid, 0))
        self._completed.append(res)
        self.stats["tokens_delivered"] += len(tokens)
        self.tracer.on_finish(rid, status, len(tokens))
        if status != "ok":
            self.stats[self._STATUS_COUNTER[status]] += 1
            TEV.record_event(self._STATUS_EVENT[status], rid=rid,
                             reason=reason)
        return res

    def take_completed(self) -> List[Result]:
        """Drain finished Results (rid order)."""
        out, self._completed = self._completed, []
        return sorted(out, key=lambda r: r.rid)

    def _drain_rejections(self):
        for req, reason in self.scheduler.take_rejected():
            self._finish(req.rid, [], "rejected", reason)

    def _free_slot(self, s: int):
        self.slot_free[s] = True
        self.slot_req[s] = None
        self.slot_budget[s] = 0
        self._slot_pos[s] = 0
        if self._paged is not None:
            # release the blocks and park the table on the slot's scratch
            # block; the park reaches the device before the next decode
            # block (`_paged_sync`) or with the next admission's table push
            self._paged.free(s)

    def _expire_deadlines(self, pending: Deque[Request]):
        """Finalize the requests whose deadline (seconds since run()'s
        start) has passed: queued ones with no tokens, live ones with what
        they emitted. Block-boundary resolution."""
        if self._run_t0 is None:
            return
        elapsed = time.monotonic() - self._run_t0
        if any(r.deadline is not None for r in pending):
            keep = []
            for r in pending:
                if r.deadline is not None and elapsed > r.deadline:
                    self._finish(r.rid, [], "deadline",
                                 f"deadline {r.deadline}s expired in queue")
                else:
                    keep.append(r)
            pending.clear()
            pending.extend(keep)
        for s in range(self.slots):
            req = self.slot_req[s]
            if (req is not None and req.deadline is not None
                    and elapsed > req.deadline):
                self._finish(req.rid, self.slot_out[s], "deadline",
                             f"deadline {req.deadline}s expired mid-decode")
                self._free_slot(s)
                self._stale = True    # a live slot left: restage

    # ---------------------------------------------------------- prefill --
    def _prefill_into(self, plan: PrefillPlan, slots: List[int]):
        self.tracer.on_admit([r.rid for r in plan.requests])
        with span("engine.prefill"):
            self._prefill_batch(plan, slots, self.tracer.last)

    @torch.no_grad()
    def prefill_logits(self, tokens: torch.Tensor, lengths: torch.Tensor,
                       prefix: int = 0):
        """Prefill a padded batch (n, L) into contiguous caches:
        single-shot, or in `prefill_chunk` lockstep chunks when the batch
        is longer than one. With `prefix` > 0 (every row's first `prefix`
        tokens equal; needs prefill_chunk), the prefix is prefilled once,
        single-shot on one row, its caches and last logits are copied to
        the n rows, and the chunks walk [prefix, L). Returns (each row's
        last-real-token logits (n, V) fp32, the caches). A chunk unembeds
        only the (n, 1, D) rows whose last real token it holds.

        Single-shot prefill returns fresh tensors. A chunked batch (n <=
        batch_slots) runs in the first n rows of the engine's persistent
        set (zeroed in place first, so the rings match fresh caches), each
        chunk keyed (n, pos0, chunk length) for compiled dispatch; the
        returned logits and caches are views of that set, valid until the
        next chunked batch.

        On a mesh the rows split over the slot groups when they divide
        them (`MeshPlan.splits`; else every group prefills them all), and
        each shard runs the plan on its rows. The caches are then a list,
        one plan-local tree per local shard of the rows it prefilled
        (`_mesh_insert` gathers them); the logits are every row's, as the
        host reads them: one shard per slot group joined on a LocalMesh,
        all-gathered over the slot axes on a ProcessMesh
        (`_gather_slots`). So the prefill itself issues no collective over
        the slot axes, as the JAX engine's prefill runs none."""
        mp = self._mp
        n, l_pad = tokens.shape
        split = mp is not None and mp.splits(n)
        per = n // mp.groups if split else n
        if mp is None:
            plan, params, toks, lens = (Mod.ONE_DEVICE, [self.params],
                                        [tokens], [lengths])
        else:
            plan, params = mp, self.shard_params
            starts = [mp.group(c) * per if split else 0 for c in mp.coords]
            toks = [tokens[a:a + per] for a in starts]
            lens = [lengths[a:a + per] for a in starts]
        c = self.prefill_chunk
        if not prefix and (not c or l_pad <= c):
            lgs, caches = Mod.prefill(params, self.cfg,
                                      [{"tokens": t} for t in toks],
                                      self.max_len, lengths=lens,
                                      lookahead=self.lookahead, plan=plan)
            lgs = [x[:, 0] for x in lgs]
        else:
            bufs = self._chunk_rows(per)
            if prefix:
                one = [torch.full((1,), prefix, dtype=torch.int32,
                                  device=self.device) for _ in toks]
                firsts, pcaches = Mod.prefill(
                    params, self.cfg,
                    [{"tokens": t[:1, :prefix]} for t in toks],
                    self.max_len, lengths=one, lookahead=self.lookahead,
                    plan=plan)
                for buf, lg, pc in zip(bufs, firsts, pcaches):
                    for full, first in zip(buf["caches"], pc):
                        for name, layer in full.items():
                            for leaf, t in layer.items():
                                t.copy_(first[name][leaf].expand_as(t))
                    buf["last"].copy_(lg[:, 0].expand_as(buf["last"]))
            else:
                for buf in bufs:
                    for layer in (x for blk in buf["caches"]
                                  for x in blk.values()):
                        for t in layer.values():
                            t.zero_()
                    buf["last"].zero_()
            for buf, ln in zip(bufs, lens):
                buf["lens"].copy_(ln)
            for p in range(prefix, l_pad, c):
                t = min(c, l_pad - p)
                for buf, tk in zip(bufs, toks):
                    buf["tok"][:, :t].copy_(tk[:, p:p + t])
                self._compiled.run(("chunk", n, p, t), functools.partial(
                    self._chunk_body, bufs, p, t))
            lgs = [buf["last"] for buf in bufs]
            caches = [buf["caches"] for buf in bufs]
        if mp is None:
            return lgs[0], caches[0]
        if split:
            return self._gather_slots(mp.join_rows(lgs)), caches
        return lgs[0], caches

    def _chunk_rows(self, n: int) -> List[Dict]:
        """Views of the first n rows of the persistent chunked-prefill set
        (batch_slots rows, made at its first use): one set, or on a mesh
        one per local shard in its plan-local layout. The views of one n
        always start at the same addresses, which is what a chunk's graph
        replays."""
        if n > self.slots:
            raise ValueError(f"a chunked prefill batch holds at most "
                             f"batch_slots={self.slots} rows, not {n}")
        if self._chunk_buf is None:
            dev, b = self.device, self.slots
            trees = ([Mod.init_caches(self.cfg, b, self.max_len,
                                      lookahead=self.lookahead, device=dev)]
                     if self._mp is None else self._mp.chunk_caches(b, dev))
            self._chunk_buf = [dict(
                caches=tree,
                last=torch.zeros((b, self.cfg.vocab_size),
                                 dtype=torch.float32, device=dev),
                tok=torch.zeros((b, self.prefill_chunk), dtype=torch.long,
                                device=dev),
                lens=torch.zeros((b,), dtype=torch.int32, device=dev))
                for tree in trees]
        return [dict(caches=[{name: {leaf: t[:n] for leaf, t in layer.items()}
                              for name, layer in blk.items()}
                             for blk in full["caches"]],
                     **{k: full[k][:n] for k in ("last", "tok", "lens")})
                for full in self._chunk_buf]

    def _chunk_body(self, bufs: List[Dict], p: int, t: int) -> None:
        """One prefill chunk (tokens [p, p+t) of each set's rows) into the
        sets' caches, and each row's last-real-token logits into its set's
        "last" where the chunk holds that token. bufs: `_chunk_rows`'s
        sets; on a mesh the model runs the mesh's plan over them."""
        if self._mp is None:
            params, plan = [self.params], Mod.ONE_DEVICE
        else:
            params, plan = self.shard_params, self._mp
        xs = Mod.prefill_chunk(
            params, self.cfg, [{"tokens": b["tok"][:, :t]} for b in bufs],
            [b["caches"] for b in bufs], p, [b["lens"] for b in bufs],
            lookahead=self.lookahead, plan=plan)
        sel, hits = [], []
        for x, b in zip(xs, bufs):
            tpos = b["lens"].long() - 1 - p
            hits.append((tpos >= 0) & (tpos < t))
            rows = torch.arange(x.shape[0], device=x.device)
            sel.append(x[rows, tpos.clamp(0, t - 1)][:, None])
        for lg, hit, b in zip(plan.unembed(params, self.cfg, sel), hits,
                              bufs):
            lg = lg[:, 0]
            b["last"].copy_(torch.where(hit[:, None], lg, b["last"]))

    def _mesh_insert(self, caches, slots: List[int]) -> None:
        """Admission on the mesh: `prefill_logits`'s per-shard rows,
        all-gathered over the slot axes when the prefill split them, so
        that every shard holds every row; then each shard copies the rows
        of the slots it holds, cut to its layout, and a paged layer writes
        them through the slots' table rows into its slot-local pools."""
        mp = self._mp
        if mp.splits(len(slots)):
            caches = _map_shards(mp.gather_slots, caches)
        tables = self._paged.tables if self._paged is not None else {}
        for shard, rows, coord in zip(self.shard_caches, caches, mp.coords):
            lo, hi = mp.slot_range(coord)
            sel = [(r, s - lo) for r, s in enumerate(slots) if lo <= s < hi]
            if not sel:
                continue
            src, dst = (self._upload(np.asarray(x, np.int64))
                        for x in zip(*sel))
            for full, one in zip(shard, rows):
                for name, fc in full.items():
                    i = int(name[1:])
                    oc = {k: v.index_select(0, src)
                          for k, v in one[name].items()}
                    if i in tables:
                        nbp = fc["pk"].shape[1]
                        # global ids of the slot-local pool viewed flat
                        ids = self._upload(
                            tables[i][[slots[r] for r, _ in sel]]
                            + np.asarray([s for _, s in sel])[:, None] * nbp)
                        for kv in ("k", "v"):
                            pool = fc["p" + kv]
                            L.paged_scatter(
                                pool.view(-1, *pool.shape[2:]), ids,
                                mp.prefill_cut(i, kv, oc[kv], coord))
                        fc["step"].index_copy_(0, dst, oc["step"])
                        continue
                    for leaf, t in fc.items():
                        t.index_copy_(0, dst, mp.prefill_cut(
                            i, leaf, oc[leaf], coord).to(t.dtype))
        if tables:
            self._push_tables()

    @torch.no_grad()
    def _prefill_batch(self, plan: PrefillPlan, slots: List[int],
                       t0: float):
        """One admission batch, inside the "engine.prefill" span, in phases:
        upload, model (the prefill; counts real and padded prompt tokens),
        insert (the rows into the slots), read (the sampler and the
        batch's host sync), hooks, retire. t0: the batch's admission time
        on the tracer's clock."""
        dev = self.device
        n, l_pad = plan.tokens.shape
        with span("engine.prefill.upload"):
            tokens = torch.as_tensor(plan.tokens, device=dev)
            lengths = torch.as_tensor(plan.lengths, device=dev)
            host_temps = np.asarray([r.temperature for r in plan.requests],
                                    np.float32)
            temps = torch.as_tensor(host_temps, device=dev)
            idx = torch.as_tensor(slots, dtype=torch.long, device=dev)
        prefix = 0
        if (self.share_prefix and n >= 2 and self.prefill_chunk
                and plan.prefix_len >= self.share_min_prefix):
            prefix = int(plan.prefix_len)
        with span("engine.prefill.model",
                  real_tokens=int(plan.lengths.sum()),
                  padded_tokens=n * l_pad):
            logits, caches = self.prefill_logits(tokens, lengths, prefix)
        with span("engine.prefill.insert"):
            if self._paged is not None:
                # shareability is judged against every position prefill
                # wrote: padded rows carry masked garbage up to l_pad, so
                # each row's write span is [prefix, l_pad)
                self._paged.admit(slots, [l_pad] * n, prefix_len=prefix)
            if self._mp is not None:
                self._mesh_insert(caches, slots)
            elif self._paged is not None:
                self._insert_paged(caches, slots, idx)
            else:
                self._insert(caches, idx)
        with span("engine.prefill.read"):
            first = sampling.sample(
                self.generator, logits, temps, self.top_k,
                any_sampling=bool((host_temps > 0).any()))
            first = first.cpu().numpy()        # the batch's host sync
        with span("engine.prefill.hooks"):
            self.tracer.on_first_token([r.rid for r in plan.requests])
        self.stats["prefill_s"] += self.tracer.last - t0
        with span("engine.prefill.retire"):
            self._retire_prefill(plan, slots, prefix, first)

    def _retire_prefill(self, plan: PrefillPlan, slots: List[int],
                        prefix: int, first: np.ndarray) -> None:
        """After an admission batch's host sync: count it, and put each
        request in its slot with its first token (or finish it there)."""
        self.stats["prefill_batches"] += 1
        self.stats["prefill_tokens_computed"] += (
            prefix + int(np.maximum(plan.lengths - prefix, 0).sum()))
        self.stats["prefill_prefix_shared"] += int(prefix > 0)
        self._slot_pos[slots] = plan.lengths
        if self.drafter is not None:
            # drafter context: the prompt plus the first sampled token (the
            # history ends at slot_last, the pending token)
            self._seed_history(slots, [np.concatenate([r.prompt, [f]])
                                       for r, f in zip(plan.requests, first)])
        for i, (req, s) in enumerate(zip(plan.requests, slots)):
            self.slot_out[s] = [int(first[i])]
            self.slot_last[s] = int(first[i])
            self.slot_temp[s] = req.temperature
            budget = req.max_new_tokens - 1
            if budget <= 0:
                self._finish(req.rid, self.slot_out[s], "ok")
                self._free_slot(s)
            else:
                self.slot_free[s] = False
                self.slot_req[s] = req
                self.slot_budget[s] = budget
        self._stale = True        # host mirrors changed; restage on device

    def _insert(self, caches, idx: torch.Tensor):
        """Contiguous admission (the JAX engine's `insert`): copy the n
        freshly prefilled rows of every cache leaf into the slots `idx`, in
        place."""
        for full, one in zip(self.caches, caches):
            for name, layer in full.items():
                for leaf, t in layer.items():
                    t.index_copy_(0, idx, one[name][leaf].to(t.dtype))

    def _insert_paged(self, caches, slots: List[int], idx: torch.Tensor):
        """Paged admission (the JAX engine's `insert_paged`): write the n
        freshly prefilled contiguous rows through their slots' table rows
        into the pools (`layers.paged_scatter`), set the rows' steps, copy
        every unpaged layer's leaves (a mamba layer's conv window and SSM
        state) into the slots' rows, and push the host tables.
        Shared-prefix rows point at the same block ids; those duplicate
        writes carry bitwise-equal content (the shareable-block invariant
        of `PagedManager.admit`), so whichever lands is exact."""
        tables = self._paged.tables
        rows = {i: self._upload(host[slots]) for i, host in tables.items()}
        for full, one in zip(self.caches, caches):
            for name, fc in full.items():
                oc = one[name]
                i = int(name[1:])
                if i not in tables:
                    for leaf, t in fc.items():
                        t.index_copy_(0, idx, oc[leaf].to(t.dtype))
                    continue
                L.paged_scatter(fc["pk"], rows[i], oc["k"])
                L.paged_scatter(fc["pv"], rows[i], oc["v"])
                fc["step"].index_copy_(0, idx, oc["step"])
        self._push_tables()

    def _upload(self, host, dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
        """A host array on the engine's device without a host wait. A
        blocking host-to-device copy synchronizes the stream, so on the
        card the array is staged in pinned memory and copied with
        non_blocking; the caching host allocator keeps the pinned block
        until the copy has run."""
        t = torch.as_tensor(host, dtype=dtype)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _push_tables(self):
        """Copy the host table mirror into the one device table of each
        layer position (shared by every super-block)."""
        pm = self._paged
        for i, host in pm.tables.items():
            if self._mp is None:
                self.caches[0][f"l{i}"]["table"].copy_(self._upload(host))
                continue
            for shard, coord in zip(self.shard_caches, self._mp.coords):
                lo, hi = self._mp.slot_range(coord)
                shard[0][f"l{i}"]["table"].copy_(self._upload(host[lo:hi]))
        pm.dirty = False

    def _paged_sync(self, n: int):
        """Before a decode or verify block of n steps: plan copy-on-write
        for every ring row the block can write ([pos, pos + n * T) per
        live slot; the block writes every row, dead ones included, so the
        span is the whole block's) and flush it."""
        positions = {s: int(self._slot_pos[s]) for s in range(self.slots)
                     if not self.slot_free[s]}
        self._paged_flush(self._paged.cow_moves(positions,
                                                n * self.tokens_per_step))

    def _paged_flush(self, moves: Dict[int, List[Tuple[int, int]]]):
        """Copy the moved blocks ({layer position: [(src, dst), ...]}) in
        every super-block's pools, and push the tables when anything
        changed."""
        pm = self._paged
        count = sum(len(v) for v in moves.values())
        if not count and not pm.dirty:
            return
        self.stats["cow_moves"] += count
        for i, mv in moves.items():
            if not mv:
                continue
            src, dst = (self._upload(x, torch.long) for x in zip(*mv))
            # dst ids are freshly allocated: no move reads another's
            # destination
            for blk in self.caches:
                for pkey in ("pk", "pv"):
                    pool = blk[f"l{i}"][pkey]
                    pool.index_copy_(0, dst, pool.index_select(0, src))
        self._push_tables()

    def paged_stats(self) -> Dict[str, int]:
        """Block-pool occupancy summed over layer positions (shared-prefix
        dedup shows up here); {} for the contiguous layout."""
        if self._paged is None:
            return {}
        return {"blocks_in_use": self._paged.blocks_in_use(),
                "blocks_total": self._paged.blocks_total()}

    def _seed_history(self, slots: List[int], seqs) -> None:
        """Write the drafter history rows of `slots` from host token
        sequences (one host-to-device copy)."""
        pairs = [(s - self._lo, q) for s, q in zip(slots, seqs)
                 if self._lo <= s < self._lo + self._nloc]
        if not pairs:
            return
        slots, seqs = zip(*pairs)
        rows, cnts = zip(*(self.drafter.seed_row(q) for q in seqs))
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        self.slot_hist[idx] = torch.as_tensor(np.stack(rows),
                                              device=self.device)
        self.slot_hcnt[idx] = torch.as_tensor(np.asarray(cnts, np.int32),
                                              device=self.device)

    def _admit(self, pending: Deque[Request]):
        while pending:
            free = [s for s in range(self.slots) if self.slot_free[s]]
            if not free:
                break
            width = len(free) if self.batch_prefill else 1
            plan = self.scheduler.plan(pending, width)
            if plan is None:
                break
            self._prefill_into(plan, free[:len(plan.requests)])
        self._drain_rejections()

    # ----------------------------------------------------------- decode --
    def _spec_mode(self) -> Tuple[bool, bool]:
        """(run this block speculatively?, is it a probe?) under the
        acceptance ladder. A disabled engine decodes sequentially and
        probes one speculative block every `spec_retry_blocks` blocks."""
        if not self.speculative:
            return False, False
        if not self._spec_off:
            return True, False
        self._blocks_since_spec += 1
        if self.spec_retry_blocks and \
                self._blocks_since_spec >= self.spec_retry_blocks:
            return True, True
        return False, False

    def _spec_ladder_update(self, prop: int, acc: int, probe: bool):
        """Feed one speculative block's acceptance into the ladder."""
        if self.spec_min_acceptance <= 0:
            return
        if probe:
            rate = acc / prop if prop else 0.0
            if rate >= self.spec_resume_acceptance:
                self._spec_off = False
                self.stats["spec_resume"] += 1
                TEV.record_event("spec_resume", rate=rate)
                self._acc_window.clear()
            else:
                self._blocks_since_spec = 0    # stay off; probe again later
            return
        self._acc_window.append((prop, acc))
        wp = sum(p for p, _ in self._acc_window)
        wa = sum(a for _, a in self._acc_window)
        if wp >= 2 * self.speculative and wa / wp < self.spec_min_acceptance:
            self._spec_off = True
            self._blocks_since_spec = 0
            self._acc_window.clear()
            self.stats["spec_autodisable"] += 1
            TEV.record_event("spec_autodisable", rate=wa / wp)

    def _reseed_history(self, live: List[int]):
        """Sequential blocks emit tokens the drafter never observed:
        rebuild each live slot's history (prompt + full output) before the
        next speculative block."""
        self._seed_history(live, [np.concatenate([self.slot_req[s].prompt,
                                                  self.slot_out[s]])
                                  for s in live])
        self._hist_stale = False

    def _apply_cache_poisons(self) -> None:
        """Chaos: write NaN over a slot's K caches, in place, once it has
        emitted its trigger count (corruption the guard did not see born).
        The next step's attention carries it into the slot's logits, where
        the guard quarantines the slot."""
        if not self.faults.poison_cache:
            return
        done = [len(self.slot_out[s]) if not self.slot_free[s] else -1
                for s in range(self.slots)]
        for s in self.faults.cache_poisons_due(self.slots, done,
                                               self._cache_poison_applied):
            self._cache_poison_applied.add(s)
            if self._paged is not None and self._mp is None:
                # the slot must own its blocks before they are NaN-ed: a
                # shared prefix block would poison every sharer
                self._paged_flush(self._paged.force_private(s))
            for tree, row in self._slot_homes(s):
                if self._paged is not None:
                    _poison_slot_k_paged(tree, self._paged.tables, s, row)
                else:
                    _poison_slot_k(tree, row)
            TEV.record_event("cache_poisoned", slot=s)

    def _slot_homes(self, slot: int) -> List[Tuple[list, int]]:
        """(cache tree, row) of every local cache tree that holds a slot:
        the one device's at the slot itself, or on a mesh each shard of
        the slot's group at its row there."""
        if self._mp is None:
            return [(self.caches, slot)]
        homes = []
        for tree, coord in zip(self.shard_caches, self._mp.coords):
            lo, hi = self._mp.slot_range(coord)
            if lo <= slot < hi:
                homes.append((tree, slot - lo))
        return homes

    def _cache_trees(self) -> List[list]:
        """The cache trees this process holds: one, or one per shard."""
        return [self.caches] if self._mp is None else self.shard_caches

    def _cache_versions(self) -> Tuple[int, ...]:
        """The version counters of every cache tensor: PyTorch bumps one at
        each in-place write (the decode kernel's raw writes come with its
        layer's `step.add_`), so a change says a block wrote the caches."""
        return tuple(t._version for tree in self._cache_trees()
                     for blk in tree for layer in blk.values()
                     for t in layer.values())

    def _kernel_fallback(self, err: Exception, n: int,
                         lost: bool) -> List[Result]:
        """The one step down: a decode kernel dispatch failed, so this
        engine decodes with the plain version from now on. Counted in
        `stats["kernel_fallbacks"]`, recorded as `pallas_fallback`, warned
        once. The captured graphs are dropped (their keys do not hold the
        impl, so a replay would keep the kernel); the device counters stay.

        lost=False: the raise came before the block wrote anything (the
        injected failure raises at `model.decode_step`'s entry, before its
        first layer, in a key's eager first use), so the block is run
        again on the plain version. lost=True: the block had written the
        caches (the JAX engine's consumed donation): each live request is
        readmitted if it has retries left (`Request.max_retries`) or
        finalized "failed", the paged manager is reset and the caches
        re-initialised in place."""
        self.stats["kernel_fallbacks"] += 1
        TEV.record_event("pallas_fallback", error=str(err))
        if not self._fallback_warned:
            self._fallback_warned = True
            warnings.warn("decode kernel (decode_impl='pallas') dispatch "
                          "failed; this engine now decodes with the plain "
                          f"version ({err})", RuntimeWarning, stacklevel=3)
        self.decode_impl, self._impl = "ref", "ref"
        self._compiled = _Compiled(self._compiled.enabled, self.generator)
        if not lost:
            return self._decode_block(n)
        done = []
        for s in range(self.slots):
            req = self.slot_req[s]
            if req is None:
                continue
            used = self._retry_counts.get(req.rid, 0)
            if used < req.max_retries:
                # a retry restarts from the prompt through the queue
                self._retry_counts[req.rid] = used + 1
                self.stats["readmitted"] += 1
                TEV.record_event("request_readmitted", rid=req.rid,
                                 retry=used + 1)
                self._readmit.append(req)
            else:
                done.append(self._finish(
                    req.rid, self.slot_out[s], "failed",
                    "kernel dispatch failed after cache donation"))
            self._free_slot(s)
        if self._paged is not None:
            self._paged.reset()
        fresh = ([Mod.init_caches(self.cfg, self.slots, self.max_len,
                                  lookahead=self.lookahead,
                                  paged=self._paged is not None,
                                  device=self.device)]
                 if self._mp is None else self._mp.init_caches(self.device))
        for tree, new_tree in zip(self._cache_trees(), fresh):
            for blk, new in zip(tree, new_tree):
                for name, layer in blk.items():
                    for leaf, t in layer.items():
                        t.copy_(new[name][leaf])
        self._stale = True
        return done

    def _decode_block(self, n: int) -> List[Result]:
        """Run n decode steps on the device (one host sync), then retire
        finished and quarantined slots; a speculative engine runs up to n
        verify steps instead, each emitting 1..speculative+1 tokens a slot.
        A `KernelDispatchError` out of the block steps the engine down
        (`_kernel_fallback`); nothing else is caught. The block runs inside
        the span "engine.decode_block" ("engine.prefill" for admission),
        whose children name its phases: stage, launch (a replay, an eager
        body or a capture), read (the host waits for the block and copies
        its outputs back), hooks (the tracer), retire. A span records only
        while a torch profiler is active."""
        if not 1 <= n <= self.scan_steps:
            raise ValueError(f"a block runs 1..scan_steps={self.scan_steps} "
                             f"steps, not {n}")
        live = [s for s in range(self.slots) if not self.slot_free[s]]
        if not live:
            return []
        self._apply_cache_poisons()
        use_spec, probe = self._spec_mode()
        if use_spec and self._hist_stale:
            self._reseed_history(live)
        if self._paged is not None:
            self._paged_sync(n)
        mark = self._cache_versions()
        try:
            with span("engine.decode_block"):
                if use_spec:
                    return self._verify_steps(n, live, probe)
                if self.speculative:
                    self._hist_stale = True     # drafter history lags output
                return self._decode_steps(n, live)
        except F.KernelDispatchError as err:
            return self._kernel_fallback(
                err, n, lost=self._cache_versions() != mark)

    def _stage(self) -> None:
        """Copy the host mirrors into the static per-slot decode vectors
        after an admission (between blocks the device copies are reused
        verbatim), and decide the sampler's branch: `_anyt`, whether any
        live slot samples, as the JAX engine computes it when it
        restages."""
        if not self._stale:
            return
        active = np.asarray([not f for f in self.slot_free], bool)
        d = self._dev
        here = slice(self._lo, self._lo + self._nloc)
        for name, host in (("tok", self.slot_last), ("active", active),
                           ("budget", self.slot_budget),
                           ("temps", self.slot_temp)):
            d[name].copy_(torch.from_numpy(np.ascontiguousarray(host[here])))
        d["poisoned"].zero_()
        if "fin" in d:
            done = [len(self.slot_out[s]) if not self.slot_free[s] else 0
                    for s in range(self.slots)]
            d["fin"].copy_(torch.from_numpy(np.ascontiguousarray(
                self.faults.logit_countdown(
                    self.slots, done, fired=self._faults_fired)[here])))
        self._anyt = bool(np.any((self.slot_temp > 0) & active))
        self._stale = False

    @torch.no_grad()
    def _decode_steps(self, n: int, live: List[int]) -> List[Result]:
        t0 = self.tracer.clock()
        with span("engine.decode_block.stage"):
            self._stage()
        greedy = not self._anyt
        with span("engine.decode_block.launch"):
            self._compiled.run(("decode", n, self.slots, greedy),
                               functools.partial(self._decode_body, n,
                                                 greedy))
        with span("engine.decode_block.read"):
            read = self._read_block(live, n, self._toks[:n, :, 0],
                                    self._emit[:n, :, 0])
        with span("engine.decode_block.hooks"):
            self.tracer.on_block("seq", n, t0, int(read[1].sum()))
        self.stats["decode_s"] += self.tracer.last - t0
        with span("engine.decode_block.retire"):
            return self._retire(live, *read)

    def _decode_body(self, n: int, greedy: bool) -> None:
        """n sequential decode steps on the static vectors: tokens and emit
        flags into rows [0, n) of the block buffers, the carries written
        back in place."""
        d = self._dev
        tok, active, budget, poisoned = (d["tok"], d["active"], d["budget"],
                                         d["poisoned"])
        fin = d.get("fin")
        for i in range(n):
            lg = self._model_step(tok[:, None])[:, 0]
            if fin is not None:
                # chaos countdown: at a slot's trigger step its whole
                # logits row becomes NaN / +Inf, no other row touched
                lg = torch.where((active & (fin == 0))[:, None],
                                 self._bad_val[:, None], lg)
            nxt = sampling.sample(self.generator, lg, d["temps"], self.top_k,
                                  any_sampling=not greedy,
                                  rows=self._sample_rows(1))
            # numerical guard: a non-finite row is QUARANTINED — not
            # emitted, budget untouched, slot deactivated
            bad = active & ~sampling.finite_rows(lg)
            ok = active & ~bad
            nxt = torch.where(ok, nxt, tok)
            budget = budget - ok.to(torch.int32)
            poisoned = poisoned | bad
            active = ok & (budget > 0)
            if fin is not None:
                fin = fin - ok.to(torch.int32)
            if self._mx is not None:
                MX.seq_update_(self._mx, ok, bad, self.ring_mod)
            self._toks[i, :, 0].copy_(nxt)
            self._emit[i, :, 0].copy_(ok)
            tok = nxt
        for name, val in (("tok", tok), ("active", active),
                          ("budget", budget), ("poisoned", poisoned)):
            d[name].copy_(val)
        if fin is not None:
            d["fin"].copy_(fin)

    def _model_step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One `decode_step` of the local slots' tokens (nloc, T): fp32
        logits (nloc, T, V). On a mesh every shard runs the plan on its
        slot group's rows, and one shard per local group gives the
        rows."""
        if self._mp is None:
            return Mod.decode_step(self.params, self.cfg, {"tokens": tokens},
                                   self.caches, impl=self._impl,
                                   lookahead=self.lookahead)[0]
        mp = self._mp
        logits, _ = Mod.decode_step(
            self.shard_params, self.cfg,
            [{"tokens": t} for t in mp.local_rows(tokens, self._lo)],
            self.shard_caches, impl=self._impl, lookahead=self.lookahead,
            plan=mp)
        return mp.join_rows(logits)

    def _sample_rows(self, t: int) -> Optional[Tuple[int, int]]:
        """`sampling.sample`'s rows for the local slots' (nloc * t) rows:
        None when they are the whole slot batch."""
        if self._nloc == self.slots:
            return None
        return self._lo * t, self.slots * t

    def _gather_slots(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """A local-slot tensor with every slot's rows along dim: an
        all-gather over the slot axes on a ProcessMesh, x itself when the
        process holds every slot."""
        if self._nloc == self.slots:
            return x
        y = x.to(torch.uint8) if x.dtype == torch.bool else x
        y = self._mp.gather_slots([y], dim)[0]
        return y.bool() if x.dtype == torch.bool else y

    def _any_flip(self) -> bool:
        """The verify block's early exit: whether any slot's active flag
        flipped, over every slot group (one host read)."""
        if self._nloc == self.slots:
            return bool(self._flip)
        f = [self._flip.to(torch.int32).reshape(1)]
        for a in self._mp.slot_axes:
            f = self.mesh.pmax(f, a)
        return bool(f[0])

    def _rollback(self, back: torch.Tensor) -> None:
        """Every ring `step` of the local slots -= back (nloc,)."""
        if self._mp is None:
            for blk in self.caches:
                for layer in blk.values():
                    layer["step"].sub_(back)
            return
        for shard, coord in zip(self.shard_caches, self._mp.coords):
            lo, hi = self._mp.slot_range(coord)
            part = back[lo - self._lo:hi - self._lo]
            for blk in shard:
                for layer in blk.values():
                    layer["step"].sub_(part)

    @torch.no_grad()
    def _verify_steps(self, n: int, live: List[int],
                      probe: bool) -> List[Result]:
        """Up to n draft/verify/accept steps. Each feeds (B, T = k+1) tokens,
        the slot's pending token and k drafts, through one `decode_step`
        on the k-row lookahead ring, then:

          accept   logits[:, j] is the model's next-token choice given
                   x[:, :j+1], so draft x[:, j+1] is kept iff it equals
                   ver[:, j]; acc is the all-match prefix and the slot emits
                   e = min(acc+1, budget) tokens (acc drafts and the model's
                   token after them). A slot about to consume a non-finite
                   position emits the clean prefix before it and is
                   quarantined; an inactive slot takes e = 0.
          rollback the step advanced every ring `step` by T; step -= T - e
                   keeps exactly the rows a sequential engine would hold.
                   The T - e rejected rows are dead: the lookahead rows mean
                   no in-window token was evicted, and the next step's
                   insert starts at step and overwrites them before any
                   read.

        Like the JAX engine's while_loop, the block ends as soon as any
        slot's `active` flips, so a freed slot refills at once and
        `spec_steps` counts as in JAX. That test is one host read of one
        bool per verify step, the only host sync inside the block; each
        step is one compiled dispatch, keyed (slots, greedy-only). Its
        spans: stage, then a launch and a read (the flag) a step, then the
        block's read, which also counts the drafts."""
        t0 = self.tracer.clock()
        with span("engine.decode_block.stage"):
            self._stage()
            self._verify_begin()
        greedy = not self._anyt
        body = functools.partial(self._verify_body, greedy)
        steps = 0
        while steps < n:
            with span("engine.decode_block.launch"):
                self._compiled.run(("verify", self.slots, greedy), body)
            steps += 1
            with span("engine.decode_block.read"):
                if self._any_flip():                 # one host read
                    break
        with span("engine.decode_block.read"):
            read = self._read_block(live, steps, self._toks[:steps],
                                    self._emit[:steps])
            emit_np = read[1]
            k = self.speculative
            counts = emit_np.sum(axis=-1)                      # (n, slots)
            ran = counts >= 1
            prop = k * int(ran.sum())
            accepted = int((counts[ran] - 1).sum())
            self.stats["spec_steps"] += steps
            self.stats["draft_proposed"] += prop
            self.stats["draft_accepted"] += accepted
            self._spec_ladder_update(prop, accepted, probe)
        with span("engine.decode_block.hooks"):
            self.tracer.on_block("spec", n, t0, int(emit_np.sum()))
        self.stats["decode_s"] += self.tracer.last - t0
        with span("engine.decode_block.retire"):
            return self._retire(live, *read)

    def _verify_begin(self) -> None:
        """The verify block's set-up: rows of the block buffers from 0, and
        the active flags the block starts from (`_flip` compares with
        them)."""
        self._sidx.zero_()
        self._active0.copy_(self._dev["active"])

    def _verify_body(self, greedy: bool) -> None:
        """One verify step on the static vectors and the drafter history:
        tokens and emit flags into row `_sidx` of the block buffers (then
        `_sidx` += 1), `_flip` set when a slot's active flag differs from
        the block's start, every carry written back in place."""
        d = self._dev
        k = self.speculative
        t = k + 1
        tok, active, budget, poisoned = (d["tok"], d["active"], d["budget"],
                                         d["poisoned"])
        hist, hcnt = self.slot_hist, self.slot_hcnt
        fin = d.get("fin")
        drafts = self.drafter.propose(hist, hcnt, k)
        if self._draft_mask is not None:
            # chaos: out-of-vocab proposals, which sanitize must clip
            drafts = torch.where(self._draft_mask, self._draft_bad, drafts)
        drafts = self.drafter.sanitize(drafts, self.cfg.vocab_size)
        x = torch.cat([tok[:, None], drafts], dim=1)
        logits = self._model_step(x)
        if fin is not None:
            # poison the one window position the countdown lands on, so a
            # poisoned request keeps exactly its trigger index of tokens,
            # as in the sequential body
            win = torch.arange(t, device=x.device)
            hitpos = ((active & (fin >= 0) & (fin < t))[:, None]
                      & (win[None, :] == fin[:, None]))
            logits = torch.where(hitpos[:, :, None],
                                 self._bad_val[:, None, None], logits)
        # every verify position in one sampling call
        nloc = self._nloc
        ver = sampling.sample(
            self.generator, logits.reshape(nloc * t, -1),
            d["temps"].repeat_interleave(t), self.top_k,
            any_sampling=not greedy,
            rows=self._sample_rows(t)).reshape(nloc, t)
        finpos = torch.isfinite(logits).all(dim=-1)              # (B, T)
        first_bad = torch.where(
            finpos.all(dim=1), t,
            finpos.to(torch.int32).argmin(dim=1)).to(torch.int32)
        match = (drafts == ver[:, :k]).to(torch.int32)
        acc = match.cumprod(dim=1).sum(dim=1, dtype=torch.int32)
        e_clean = torch.minimum(acc + 1, budget)
        bad = active & (first_bad < e_clean)
        ok = active & ~bad
        e = torch.where(active, torch.where(bad, first_bad, e_clean),
                        0).to(torch.int32)
        if self._mx is not None:
            MX.spec_update_(self._mx, e, bad, k, self.ring_mod)
        self._rollback(t - e)
        newlast = ver.gather(1, (e - 1).clamp(min=0).long()[:, None])[:, 0]
        new_hist, new_hcnt = self.drafter.observe(hist, hcnt, ver, e)
        pos = torch.arange(t, device=ver.device)
        self._toks.index_copy_(0, self._sidx, ver[None])
        self._emit.index_copy_(0, self._sidx,
                               (pos[None, :] < e[:, None])[None])
        self._sidx.add_(1)
        budget = budget - e
        active = ok & (budget > 0)
        self._flip.copy_((active != self._active0).any())
        for name, val in (("tok", torch.where(ok, newlast, tok)),
                          ("active", active), ("budget", budget),
                          ("poisoned", poisoned | bad)):
            d[name].copy_(val)
        hist.copy_(new_hist)
        hcnt.copy_(new_hcnt)
        if fin is not None:
            d["fin"].copy_(fin - e)

    def _read_block(self, live: List[int], steps: int, toks: torch.Tensor,
                    emit: torch.Tensor
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The block's one host sync: read its tokens, emit flags and the
        carried slot vectors back, and count the block in `stats`. Returns
        (tokens, emit flags, poisoned flags) as numpy."""
        d = self._dev
        toks_np = self._gather_slots(toks, 1).cpu().numpy()
        emit_np = self._gather_slots(emit, 1).cpu().numpy()
        self.slot_last = self._gather_slots(d["tok"]).cpu().numpy().astype(
            np.int32)
        self.slot_budget = self._gather_slots(d["budget"]).cpu().numpy(
        ).astype(np.int32)
        poisoned_np = self._gather_slots(d["poisoned"]).cpu().numpy()
        self.stats["decode_steps"] += steps
        self.stats["tokens_emitted"] += int(emit_np.sum())
        # advance the ring-write position mirror: a sequential step writes
        # one row a slot; a verify step nets its e emitted rows after the
        # rollback
        self._slot_pos[live] += (emit_np.sum(axis=(0, 2))[live]
                                 if emit_np.ndim == 3 else steps)
        return toks_np, emit_np, poisoned_np

    def _retire(self, live: List[int], toks_np: np.ndarray,
                emit_np: np.ndarray, poisoned_np: np.ndarray
                ) -> List[Result]:
        """After `_read_block`: extend each live slot's output
        (chronologically: row-major over step and verify position) and
        retire finished and quarantined slots. Returns the retired slots'
        Results."""
        done: List[Result] = []
        for s in live:
            self.slot_out[s].extend(
                int(x) for x in toks_np[:, s][emit_np[:, s]])
            if poisoned_np[s]:
                # a fault entry targets one occupant, not the slot's later
                # tenants
                self._faults_fired.add(s)
                done.append(self._finish(
                    self.slot_req[s].rid, self.slot_out[s], "poisoned",
                    "non-finite logits; slot quarantined"))
                self._free_slot(s)
            elif self.slot_budget[s] <= 0:
                done.append(self._finish(
                    self.slot_req[s].rid, self.slot_out[s], "ok"))
                self._free_slot(s)
        return done

    def step(self) -> List[Result]:
        """One decode (or verify) step for every live slot."""
        return self._decode_block(1)

    def _block_len(self) -> int:
        """Largest block that can't overshoot any live slot: stop at the
        earliest completion so slots free (and refill) at block boundaries
        and the random stream is the same for every scan_steps setting.
        Speculative blocks take the same floor: a verify step emits 1..T
        tokens, so b steps always suffice, and the budget clamp and the
        early exit make any length safe; sizing by ceil(b/T) would assume
        full acceptance and collapse blocks near a slot's end to one step,
        a host round trip each."""
        live_budgets = [int(self.slot_budget[s]) for s in range(self.slots)
                        if not self.slot_free[s]]
        if not live_budgets:
            return 0
        return max(1, min(self.scan_steps, min(live_budgets)))

    # -------------------------------------------------------------- run --
    def run(self, requests: List[Request]) -> List[Result]:
        """Serve a batch to completion; one Result per request, rid order.
        Finished requests land in `self._completed` as they finalize, so
        after an exception `take_completed()` recovers them.

        Beyond `max_pending` queued requests the tail is rejected up front
        ("queue overflow"); `Request.deadline`s count from here and are
        enforced at block boundaries; readmitted requests rejoin the tail
        of the queue."""
        self._run_t0 = time.monotonic()
        pending: Deque[Request] = collections.deque()
        for r in requests:
            self.tracer.on_submit(r.rid)
            if self.max_pending is not None and \
                    len(pending) >= self.max_pending:
                self._finish(r.rid, [], "rejected",
                             f"queue overflow (max_pending="
                             f"{self.max_pending})")
            else:
                pending.append(r)
        try:
            while pending or self._readmit or not all(self.slot_free):
                if self._readmit:
                    pending.extend(self._readmit)
                    self._readmit = []
                self._expire_deadlines(pending)
                self._admit(pending)
                n = self._block_len()
                if n:
                    self._decode_block(n)
        finally:
            self._drain_rejections()
            self._run_t0 = None
        return self.take_completed()


def _map_shards(fn, trees: List[list]) -> List[list]:
    """fn over each cache leaf's list of per-shard tensors (a mesh
    collective), for per-shard cache trees of one structure."""
    out = [[{name: {} for name in blk} for blk in tree] for tree in trees]
    for b, blk in enumerate(trees[0]):
        for name, layer in blk.items():
            for leaf in layer:
                for o, x in zip(out, fn([t[b][name][leaf] for t in trees])):
                    o[b][name][leaf] = x
    return out


def _poison_slot_k(caches, slot: int) -> None:
    """NaN over one slot's K caches in every layer and super-block, in
    place (the storage the captured graphs read)."""
    for blk in caches:
        for layer in blk.values():
            if "k" in layer:
                layer["k"][slot] = float("nan")


def _poison_slot_k_paged(caches, tables: Dict[int, np.ndarray],
                         slot: int, row: int) -> None:
    """Paged twin of `_poison_slot_k`: NaN over the K pool blocks of the
    slot's host table row (`tables`, the PagedManager's mirror, which the
    caller made private to the slot and pushed). A slot-local pool (B,
    nb+1, H, page, D) holds the slot at `row`, its ids local to it."""
    for i, host in tables.items():
        ids = torch.as_tensor(host[slot], dtype=torch.long,
                              device=caches[0][f"l{i}"]["pk"].device)
        for blk in caches:
            pool = blk[f"l{i}"]["pk"]
            (pool[row] if pool.dim() == 5 else pool).index_fill_(
                0, ids, float("nan"))


def ring_cache_bytes(cfg: ModelConfig, batch: int, context: int) -> int:
    """Decode-cache bytes (the paper's Fig. 3 memory comparison): PHYSICAL
    ring rows (`cache_allocation`) of K and V for every attention layer,
    and for every mamba layer its fixed state, whatever the context: the
    fp32 SSM state (H, P, S) and the K-1 conv inputs. Ring rows and conv
    inputs count at the model dtype's itemsize (the JAX function counts 2
    bytes for them at every dtype: equal on bf16 configs)."""
    from repro_torch.core.layers import cache_allocation
    itemsize = 2 if cfg.dtype == "bfloat16" else 4
    total = 0
    for i, kind in enumerate(cfg.layer_pattern):
        if kind.startswith("mamba"):
            spec = cfg.ssm
            h = spec.num_heads(cfg.d_model)
            total += batch * (h * spec.head_dim * spec.state_dim * 4
                              + (spec.conv_width - 1)
                              * (spec.d_inner(cfg.d_model)
                                 + 2 * spec.num_groups * spec.state_dim)
                              * itemsize)
            continue
        acfg = Mod.attn_cfg(cfg, kind, index=i)
        cap = cache_allocation(acfg, context)
        total += 2 * batch * acfg.num_kv_heads * cap * acfg.head_dim * itemsize
    return total * cfg.num_super_blocks
