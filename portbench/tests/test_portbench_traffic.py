"""The seeded traffic repeats exactly, and every seed gets the same amount of work."""

import socket

import numpy as np
import torch

from portbench import harness
from portbench.traffic import client, generator

SEED = 2**31 + 99


def test_chain_labels_repeat_and_cover_every_class():
    t = harness.load("traffic", "gen_dpmpp20_r4")
    a = generator.chain_labels(t, 27, SEED, 3)
    assert np.array_equal(a, generator.chain_labels(t, 27, SEED, 3))
    assert not np.array_equal(a, generator.chain_labels(t, 27, SEED, 4))
    assert len(a) == 108 and np.array_equal(np.bincount(a), np.full(27, 4))


def test_x_T_repeats():
    def draw(chain):
        g = torch.Generator().manual_seed(generator.chain_seed(SEED, chain))
        return torch.randn((4, 8, 8, 4), generator=g)

    assert torch.equal(draw(5), draw(5)) and not torch.equal(draw(5), draw(6))


def test_arrivals_repeat_with_a_fixed_count():
    t = harness.load("traffic", "serve_open_b54")
    a, la = generator.arrivals(t, 30.0, 27, SEED)
    b, lb = generator.arrivals(t, 30.0, 27, SEED)
    c, _ = generator.arrivals(t, 30.0, 27, SEED + 1)
    assert np.array_equal(a, b) and np.array_equal(la, lb) and not np.array_equal(a, c)
    assert len(a) == len(c) == round(t["rate_per_s"] * 30.0)
    assert np.all(np.diff(a) >= 0) and a[0] >= 0 and a[-1] <= 30.0


def test_every_seed_gets_the_same_gaps_in_another_order():
    """The arrivals of two seeds are one pattern on the circle of the window, turned."""
    t = harness.load("traffic", "serve_open_b54")

    def circular_gaps(seed):
        a, _ = generator.arrivals(t, 30.0, 27, seed)
        return np.diff(np.append(a, a[0] + 30.0))

    g1, g2 = circular_gaps(SEED), circular_gaps(SEED + 7)
    turn = next(k for k in range(len(g1)) if np.allclose(np.roll(g1, -k), g2, atol=1e-9))
    assert np.allclose(np.roll(g1, -turn), g2, atol=1e-9)


def test_refused_request_fails_with_its_wait():
    """A request whose connection is refused fails, and is timed from its due time."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]  # nothing listens there once the socket is closed
    out = client.run_schedule({"host": "127.0.0.1", "port": port, "offsets": [0.0, 0.05], "labels": [0, 1],
                               "keep": [0], "limit_after_s": 5.0})
    assert [r["ok"] for r in out] == [False, False]
    assert all(0.0 <= r["latency_s"] < 5.0 and "error" in r for r in out)


def test_corpus_and_batches_repeat():
    x, y = generator.corpus(16, 32, 27, SEED, "cpu", chunk=8)
    x2, y2 = generator.corpus(16, 32, 27, SEED, "cpu", chunk=8)
    assert x.dtype == torch.uint8 and x.shape == (16, 32, 32, 1)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    order = generator.epoch_order(70, 8, SEED, 3)
    assert np.array_equal(order, generator.epoch_order(70, 8, SEED, 3)) and len(order) == 3 * 64
    assert len(set(order[:64])) == 64  # an epoch reads a row at most once


def test_train_draws_repeat():
    a = generator.TrainDraws(SEED, "cpu", 1000, 0.1)((4, 8, 8, 4))
    b = generator.TrainDraws(SEED, "cpu", 1000, 0.1)((4, 8, 8, 4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["t"].min() >= 1 and a["t"].max() < 1000
