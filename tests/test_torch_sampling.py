"""The port's sampling holds the properties the JAX sampling tests pin
(its random draws cannot equal JAX's): greedy rows are the raw argmax at
every top_k, one slot's temperature never perturbs another slot, a fixed
generator state reproduces, and top_k=1 sampling is greedy."""
import numpy as np
import torch

from repro_torch.serving import sampling

torch.set_num_threads(1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_sample_determinism_across_batch_and_topk():
    rng = np.random.RandomState(17)
    v = 64
    for b in (1, 2, 5, 8):
        logits = torch.from_numpy(rng.randn(b, v).astype(np.float32))
        want_greedy = logits.argmax(-1).to(torch.int32)
        for top_k in (0, 1, 4, v, v + 9):
            cold = sampling.sample(_gen(31 + b), logits, torch.zeros(b),
                                   top_k)
            assert torch.equal(cold, want_greedy), (b, top_k)
            for j in range(b):                 # heat ONE slot at a time
                temps = torch.zeros(b)
                temps[j] = 3.0
                hot = sampling.sample(_gen(31 + b), logits, temps, top_k)
                again = sampling.sample(_gen(31 + b), logits, temps, top_k)
                assert torch.equal(hot, again)
                others = torch.arange(b) != j
                assert torch.equal(hot[others], cold[others]), (b, top_k, j)
            if top_k == 1:
                hot_all = sampling.sample(_gen(31 + b), logits,
                                          torch.full((b,), 2.0), top_k=1)
                assert torch.equal(hot_all, want_greedy)


def test_sampling_isolated_across_slots():
    """Same generator state, different temperature vectors: greedy rows are
    unchanged and the generator advances by the same amount, so the NEXT
    draw is identical too."""
    rng = np.random.RandomState(8)
    logits = torch.from_numpy(rng.randn(3, 256).astype(np.float32))
    ga, gb = _gen(5), _gen(5)
    a = sampling.sample(ga, logits, torch.tensor([0.0, 0.0, 0.0]))
    b = sampling.sample(gb, logits, torch.tensor([0.0, 4.0, 0.0]))
    assert a[0] == b[0] and a[2] == b[2]
    assert torch.equal(ga.get_state(), gb.get_state())
    hot = torch.tensor([4.0, 4.0, 4.0])
    draws = {int(sampling.sample(_gen(s), logits, hot)[1]) for s in range(20)}
    assert len(draws) > 1, "temperature 4 must actually sample"


def test_sampled_distribution_follows_temperature():
    """Gumbel-max draws follow softmax(logits / T): empirical frequencies
    over 4000 draws within 0.03 of the probabilities."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    gen = _gen(0)
    counts = np.zeros(4)
    for _ in range(4000):
        counts[int(sampling.sample(gen, logits, torch.tensor([1.5]))[0])] += 1
    want = torch.softmax(logits[0] / 1.5, -1).numpy()
    np.testing.assert_allclose(counts / counts.sum(), want, atol=0.03)


def test_finite_rows():
    x = torch.zeros(3, 5)
    x[1, 2] = float("nan")
    x[2, 0] = float("inf")
    assert sampling.finite_rows(x).tolist() == [True, False, False]
