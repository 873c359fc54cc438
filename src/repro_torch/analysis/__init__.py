"""swatlint for the port: the six rule families over the serving engine's
bodies (the port of the JAX package's `analysis/`).

Runs every entry point the engine serves (the bodies it captures as CUDA
graphs on the card, and the eager ones between them) once under a
recording dispatch mode, restores the engine, and checks the op log: carries
updated in place, no host sync inside a captured block, no collectives on
one device, no bf16->fp32 copies feeding matmuls, device counters kept
int32 and in place, and a pinned count of graph keys per family.

CLI: `python -m repro_torch.launch.analyze` (--check / --write). Committed
baseline: ANALYSIS_torch.json at the repo root (ANALYSIS.json is the JAX
package's).
"""
from repro_torch.analysis.rules import (ERROR, WARN, Finding,  # noqa: F401
                                        audit_recompiles, check_donation,
                                        check_dtype_promotion,
                                        check_host_sync, check_collectives,
                                        check_telemetry, lowering_counts)
from repro_torch.analysis.tracer import (EntryPoint, LeafInfo,  # noqa: F401
                                         TracedEntry, engine_entry_points,
                                         trace)
from repro_torch.analysis.report import (analyze_engine,  # noqa: F401
                                         analyze_entry_points, merge_reports)
from repro_torch.analysis import baselines  # noqa: F401
