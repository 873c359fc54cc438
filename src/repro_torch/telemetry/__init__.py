"""swatscope for the port: observability for the serving stack, held to
the JAX package's `repro.telemetry` (whose modules it copies or ports).

Telemetry must never change what the hot path computes or how it runs:

  device   `metrics.py`: int32 counters (tokens emitted, drafts proposed /
           accepted, guard-quarantine trips, ring wraps) in static tensors
           that the decode and verify bodies update in place, so captured
           CUDA graphs replay them; read only at
           `ServingEngine.device_metrics()`. Tokens are bitwise those of a
           metrics-off engine.
  host     `tracer.py` + `events.py`: a ring-buffered Tracer of per-request
           lifecycle spans (submit -> admitted -> first token -> decode
           blocks -> done/degraded) with TTFT / TPOT / queue delay, fed by
           the degradation-event bus. Exports Chrome-trace JSON and
           Prometheus text (`ServingEngine.chrome_trace()`,
           `ServingEngine.metrics_text()`).
  phases   `tracer.py` `span()`: the engine's "engine.prefill" and
           "engine.decode_block" ranges and their child phases (upload,
           model, insert, read, hooks, retire; stage, launch, read, hooks,
           retire) and the train step's "train.forward", "train.backward"
           and "train.optimizer". They record only while a torch profiler
           is active: a `record_function` range each, and a record in a
           bounded ring (`peek_spans()` / `consume_spans()`) with the
           prefill's token counts and the train phases' device ms (CUDA
           events). With no profiler a span is one boolean test.
  kernel   `kernelprof.py`: an opt-in dispatch census, the analytic
           banded-decode cost with its H100 bound, and a latency sampler.

`validate.py` schema-checks the exports; `repro_torch.launch.scope` is the
command line.
"""
from repro_torch.telemetry import events, kernelprof, metrics, tracer, validate
from repro_torch.telemetry.events import (consume_events, peek_events,
                                          record_event)
from repro_torch.telemetry.metrics import (COUNTER_DOC, init_metrics,
                                           ring_modulus, seq_update_,
                                           spec_update_)
from repro_torch.telemetry.tracer import Tracer

__all__ = [
    "events", "kernelprof", "metrics", "tracer", "validate",
    "record_event", "consume_events", "peek_events",
    "COUNTER_DOC", "init_metrics", "ring_modulus",
    "seq_update_", "spec_update_", "Tracer",
]
