"""The traffic generator and the counts of useful work."""
import numpy as np
import pytest

from bench import harness as H
from bench import weights as Wt
from bench.traffic import generate
from bench.work import Shape
from conftest import ROOT

SEEDS = (5, 2**31 + 11)


def _cell(name):
    return H.load_json(ROOT / "bench" / "cells" / f"{name}.json")


def _shape(name):
    return Shape.from_config(H.load_json(ROOT / "bench" / "configs"
                                         / f"{name}.json"))


@pytest.mark.parametrize("cell", ["granite-8b-swat.decode-long",
                                  "granite-8b-swat.prefill-long"])
def test_serve_traffic_same_per_seed_same_sizes_across_seeds(cell):
    tr = _cell(cell)["traffic"]
    a, b, c = (generate.serve_requests(tr, s, 49152)
               for s in (SEEDS[0], SEEDS[0], SEEDS[1]))
    assert all(np.array_equal(x.tokens, y.tokens)
               and x.max_new_tokens == y.max_new_tokens
               for x, y in zip(a, b))
    assert any(not np.array_equal(x.tokens[:8], y.tokens[:8])
               for x, y in zip(a, c))
    lo, hi = tr["prompt_len"]
    cyc = tr["cycle"]
    for reqs in (a, c):
        lens = [len(r.tokens) for r in reqs]
        assert lo <= min(lens) and max(lens) <= hi
        # every cycle of `cycle` requests holds the same sizes
        first = sorted(lens[:cyc])
        for i in range(0, len(lens) - cyc + 1, cyc):
            assert sorted(lens[i:i + cyc]) == first
    assert sorted(len(r.tokens) for r in a) == sorted(len(r.tokens)
                                                      for r in c)
    assert [len(r.tokens) for r in a] != [len(r.tokens) for r in c]


def test_train_batches_same_per_seed_differ_across_seeds():
    tr = dict(_cell("granite-moe-swat.train-16k")["traffic"], seq_len=256)
    f1, f2, f3 = (generate.train_batches(tr, s, 49155)
                  for s in (SEEDS[0], SEEDS[0], SEEDS[1]))
    assert np.array_equal(f1(0)["tokens"], f2(0)["tokens"])
    assert not np.array_equal(f1(0)["tokens"], f3(0)["tokens"])
    assert not np.array_equal(f1(0)["tokens"], f1(1)["tokens"])
    assert f1(0)["tokens"].shape == (tr["batch"], 256)


def test_decode_step_reads_26_4_gb_at_32_full_rings():
    s = _shape("granite-8b-swat")
    params = 36 * (4096 * (32 + 16) * 128 + 32 * 128 * 4096
                   + 3 * 4096 * 14336) + 49152 * 4096 + 73 * 4096
    assert s.params == params
    assert s.ring_cap == 2177
    rings = 2177 * (2 * 8 * 128 * 2) * 36 * 32          # 10.27 GB
    w = s.decode_step([2177] * 32)
    hand = 2 * (params - 73 * 4096) + 4 * 73 * 4096 + rings + 32 * 49152 * 4
    assert w["bytes"] == hand
    assert w["bytes"] == pytest.approx(26.4e9, rel=0.01)
    assert w["least_s"] == pytest.approx(hand / 3.35e12)


def test_train_token_is_3_2_gflop():
    s = _shape("granite-moe-swat")
    n = 16384
    active = 24 * (1024 * (16 + 16) * 64 + 16 * 64 * 1024
                   + 8 * 3 * 1024 * 512 + 1024 * 32)
    cols = sum(min(i, 2048) + 1 + min(128, max(0, i - 2048))
               for i in range(n))
    fwd = 2 * (active + 1024 * 49155) * n + 24 * 4 * 16 * 64 * cols
    w = s.train_step([n, n])
    assert s.cols(n) == cols
    assert w["flops"] == pytest.approx(3 * 2 * fwd)
    assert w["flops"] / (2 * n) == pytest.approx(3.2e9, rel=0.02)


def test_prefill_token_is_16_8_gflop():
    s = _shape("granite-8b-swat")
    n = 4096
    dense = 36 * (4096 * (32 + 16) * 128 + 32 * 128 * 4096
                  + 3 * 4096 * 14336)
    cols = sum(min(i, 2048) + 1 + min(128, max(0, i - 2048))
               for i in range(n))
    hand = 2 * dense * n + 36 * 4 * 32 * 128 * cols + 2 * 4096 * 49152
    w = s.prefill([n])
    assert w["flops"] == pytest.approx(hand)
    assert w["flops"] / n == pytest.approx(16.8e9, rel=0.02)


@pytest.mark.parametrize("n", [1, 5, 2048, 2049, 2177, 2178, 2300, 9000])
def test_cols_counts_the_mask(n):
    s = _shape("granite-8b-swat")
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    mask = (j <= i) & ((j >= i - 2048) | (j < 128)) if n < 3000 else None
    want = int(mask.sum()) if mask is not None else sum(
        min(k, 2048) + 1 + min(128, max(0, k - 2048)) for k in range(n))
    assert s.cols(n) == want


def test_weights_follow_the_seed_and_the_ports_layout():
    import torch
    from repro_torch.core import model as Mod
    from conftest import tiny_config
    from bench import serving as S
    c = tiny_config("granite-moe-swat")
    s = Shape.from_config(c)
    a, b, d = (Wt.make(s, x, "cpu") for x in (3, 3, 4))
    la, lb, ld = (Wt.leaves(x) for x in (a, b, d))
    port = Wt.leaves(Mod.init_model(S.port_config(c, check=False),
                                     device="cpu"))
    assert [(k, v.shape, v.dtype) for k, v in la] == [
        (k, v.shape, v.dtype) for k, v in port]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    assert not torch.equal(la[0][1], ld[0][1])
    std = dict(la)["blocks.0.l0.mixer.wq"].float().std()
    assert float(std) == pytest.approx(64 ** -0.5, rel=0.1)
    assert s.params == sum(v.numel() for _, v in la)
