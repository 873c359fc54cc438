"""The readers of the program's phase spans (`bench/span_readers.py` and
the eight metrics that use it) on synthetic traced windows and span-ring
contents, against values worked out by hand; each reads None on an
untraced run, and where the program lacks the spans or the ring."""
import pytest

from bench import harness as H
from repro_torch.telemetry import tracer as TR
from conftest import ROOT

NEW = ("block_gap_ms.decode", "step_bubble_ms.decode",
       "prefill_gap_ms.decode", "prefill_gap_ms.prefill",
       "prefill_pad_pct.prefill", "fwd_ms.train", "bwd_ms.train",
       "opt_ms.train")


def reader(name):
    return H.load_module(ROOT / "bench" / "metrics" / f"{name}.py",
                         "test_metric_" + name.replace(".", "_")).read


def reading(spans, ops, work=None, traced=True):
    td = H.TraceData(1.0, ops, spans, work or {}, {}) if traced else None
    return H.Reading(window_s=1.0, setup_s=1.0, work=work or {}, records={},
                     trace=td)


def _block(a):
    """One decode block at a s: stage 10 ms, launch 10, read 60, hooks 10,
    retire 10."""
    cuts = [a + x for x in (0.0, 0.01, 0.02, 0.08, 0.09, 0.10)]
    names = ("stage", "launch", "read", "hooks", "retire")
    out = {"engine.decode_block": [(cuts[0], cuts[-1])]}
    for name, s, e in zip(names, cuts, cuts[1:]):
        out[f"engine.decode_block.{name}"] = [(s, e)]
    return out


def decode_trace(children=True):
    spans = {}
    for blk in (_block(0.0), _block(0.2)):
        for k, v in blk.items():
            spans.setdefault(k, []).extend(v)
    spans["engine.prefill"] = [(0.4, 0.6)]
    cuts = (0.4, 0.42, 0.5, 0.52, 0.58, 0.59, 0.6)
    for name, s, e in zip(("upload", "model", "insert", "read", "hooks",
                           "retire"), cuts, cuts[1:]):
        spans[f"engine.prefill.{name}"] = [(s, e)]
    if not children:
        spans = {k: v for k, v in spans.items()
                 if k in ("engine.decode_block", "engine.prefill")}
    ops = [("k1", 0.015, 0.05), ("k2", 0.052, 0.085), ("k3", 0.215, 0.27),
           ("Memcpy DtoH", 0.272, 0.275), ("gemm", 0.43, 0.55)]
    return spans, ops


def test_decode_block_gap_and_step_bubble():
    spans, ops = decode_trace()
    r = reading(spans, ops, {"decode_steps": 6})
    # host phases [0, .02] [.08, .10] [.2, .22] [.28, .30]: 80 ms, of which
    # k1, k2 and k3 cover 5 ms each: 65 ms idle over 2 blocks
    assert reader("block_gap_ms.decode")(r) == pytest.approx(32.5)
    # the reads (120 ms) hold 111 ms of k1, k2, k3 and the copy: 9 ms idle
    # over 6 steps
    assert reader("step_bubble_ms.decode")(r) == pytest.approx(1.5)


@pytest.mark.parametrize("name", ["prefill_gap_ms.decode",
                                  "prefill_gap_ms.prefill"])
def test_prefill_gap(name):
    spans, ops = decode_trace()
    # the phases cover [0.4, 0.6]; the gemm runs 120 ms of it: 80 ms idle
    # in one admission batch
    assert reader(name)(reading(spans, ops)) == pytest.approx(80.0)


def _ring(monkeypatch, recs):
    full = [{"counts": {}, "device_ms": None, **r} for r in recs]
    monkeypatch.setattr(TR, "peek_spans", lambda: full)


def test_prefill_pad_pct(monkeypatch):
    spans, ops = decode_trace()
    _ring(monkeypatch, [
        {"name": "engine.prefill.model",
         "counts": {"real_tokens": 100, "padded_tokens": 128}},
        {"name": "engine.prefill.upload"},
        {"name": "engine.prefill.model",
         "counts": {"real_tokens": 300, "padded_tokens": 320}}])
    # (448 - 400) / 400
    assert reader("prefill_pad_pct.prefill")(reading(spans, ops)) == \
        pytest.approx(12.0)


def test_train_phase_device_ms(monkeypatch):
    _ring(monkeypatch, [
        {"name": "train.forward", "device_ms": 10.0},
        {"name": "train.backward", "device_ms": 30.0},
        {"name": "train.optimizer", "device_ms": 5.0},
        {"name": "train.forward", "device_ms": 12.0},
        {"name": "train.backward", "device_ms": 34.0},
        {"name": "train.optimizer"}])          # no events: left out
    r = reading({}, [("k", 0.0, 0.5)], {"train_steps": 2})
    assert reader("fwd_ms.train")(r) == pytest.approx(11.0)
    assert reader("bwd_ms.train")(r) == pytest.approx(32.0)
    assert reader("opt_ms.train")(r) == pytest.approx(5.0)


@pytest.mark.parametrize("name", NEW)
def test_none_untraced_and_without_the_programs_spans(name, monkeypatch):
    spans, ops = decode_trace()
    _ring(monkeypatch, [
        {"name": "engine.prefill.model",
         "counts": {"real_tokens": 10, "padded_tokens": 16}},
        {"name": "train.forward", "device_ms": 1.0},
        {"name": "train.backward", "device_ms": 1.0},
        {"name": "train.optimizer", "device_ms": 1.0}])
    read = reader(name)
    assert read(reading(spans, ops, {"decode_steps": 6})) is not None
    assert read(reading(spans, ops, traced=False)) is None
    # no device operation in the traced window (a run off the card)
    assert read(reading(spans, [], {"decode_steps": 6})) is None
    # a program with only the two parent ranges and no span ring
    bare, _ = decode_trace(children=False)
    monkeypatch.delattr(TR, "peek_spans")
    assert read(reading(bare, ops, {"decode_steps": 6})) is None
