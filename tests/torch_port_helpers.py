"""Shared helpers of the tests/test_torch_*.py parity tests (not collected)."""

from __future__ import annotations

import jax
import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module's torch ops on one thread (import this fixture into it).

    The suite runs in several worker processes at once; torch's default of
    one intra-op thread per core then makes their OpenMP threads spin
    against each other: two CPU training tests took 279 s with eight threads
    and 7.6 s with one, beside six busy processes on eight cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_flax_variables(module, *init_args, seed: int = 0) -> dict:
    """Random variables for a flax module, as nested dicts of numpy arrays.

    Shapes come from tracing ``module.init`` (no compile); values from a
    numpy seed: kernels normal(0, 1/√fan_in), biases and norm offsets
    normal(0, 0.1) so that every bias mapping of the bridge is exercised,
    norm scales 1 + normal(0, 0.1), embeddings normal(0, 1), a codebook
    uniform(-1/M, 1/M) with ema_weight equal to it, BatchNorm running means
    normal(0, 0.1) and variances uniform(0.5, 1.5).
    """
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)

    def fill(tree, collection):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = fill(leaf, collection)
                continue
            shape = leaf.shape
            if collection == "codebook":
                continue
            if name == "kernel":
                v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
            elif name == "bias":
                v = 0.1 * rng.standard_normal(shape)
            elif name == "scale":
                v = 1.0 + 0.1 * rng.standard_normal(shape)
            elif name == "var":  # BatchNorm's running variance
                v = rng.uniform(0.5, 1.5, shape)
            elif name == "mean":  # BatchNorm's running mean
                v = 0.1 * rng.standard_normal(shape)
            else:
                v = rng.standard_normal(shape)
            out[name] = v.astype(np.float32)
        if collection == "codebook" and "embedding" in tree:
            m, _ = tree["embedding"].shape
            emb = rng.uniform(-1.0 / m, 1.0 / m, tree["embedding"].shape).astype(np.float32)
            out.update(embedding=emb, ema_weight=emb.copy(),
                       ema_count=np.zeros(tree["ema_count"].shape, np.float32))
        return out

    return {col: fill(tree, col) for col, tree in shapes.items()}
