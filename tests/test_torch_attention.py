"""The port's attention wrapper against the JAX Pallas kernel (interpret mode).

On the CPU the wrapper computes its plain PyTorch version; the CUDA kernel
itself is checked on the card by chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectrogramgenai_tpu.ops.attention import fused_attention as jax_fused_attention  # noqa: E402
from spectrogramgenai_tpu_torch.ops.attention import (  # noqa: E402
    attention_reference,
    fused_attention,
)

INTERPRET = jax.default_backend() != "tpu"


def _qkv(rng, shape, scale=1.0):
    return [(rng.standard_normal(shape) * scale).astype(np.float32) for _ in range(3)]


def _jax(q, k, v, **kw):
    return np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          interpret=INTERPRET, **kw))


@pytest.mark.parametrize("shape", [(2, 4, 1024, 16), (1, 4, 1024, 32)])
def test_matches_jax_kernel(shape):
    q, k, v = _qkv(np.random.default_rng(0), shape)
    want = _jax(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    # f32 throughout; 2e-5 is the JAX package's own kernel-vs-einsum tolerance
    np.testing.assert_allclose(attention_reference(tq, tk, tv).numpy(), want, atol=2e-5)
    np.testing.assert_allclose(fused_attention(tq, tk, tv).numpy(), want, atol=2e-5)


def test_underflow_row_no_nan():
    # scores = -d·10⁴/√d on every key: a plain exp underflows to 0/0
    n, d = 256, 16
    q = np.full((1, 1, n, d), 100.0, np.float32)
    k = np.full((1, 1, n, d), -100.0, np.float32)
    v = np.ones((1, 1, n, d), np.float32)
    got = fused_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, 1.0, atol=1e-3)  # uniform probs over constant V rows
    np.testing.assert_allclose(got, _jax(q, k, v, q_block=128), atol=1e-3)


def test_large_logits_exact():
    # logits far past any clipping window: a max-subtracted softmax stays exact
    q, k, v = _qkv(np.random.default_rng(7), (1, 2, 256, 16))
    q, k = q * 30.0, k * 30.0
    got = fused_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax(q, k, v, q_block=128), atol=5e-5)  # the JAX test's bound


@pytest.mark.parametrize("case, exc", [
    ("head_dim_24", ValueError),
    ("head_dim_128", ValueError),
    ("float16", TypeError),
    ("float64", TypeError),
    ("mixed_dtypes", TypeError),
    ("n_not_multiple_of_block", ValueError),
    ("non_contiguous", ValueError),
    ("shape_mismatch", ValueError),
])
def test_wrapper_rejects_unsupported_inputs(case, exc):
    # validation runs before the device dispatch, so CPU tensors show it
    q = torch.zeros(1, 2, 256, 16)
    k = v = q
    if case == "head_dim_24":
        q = k = v = torch.zeros(1, 2, 256, 24)
    elif case == "head_dim_128":
        q = k = v = torch.zeros(1, 2, 256, 128)
    elif case == "float16":
        q = k = v = q.half()
    elif case == "float64":
        q = k = v = q.double()
    elif case == "mixed_dtypes":
        k = q.bfloat16()
    elif case == "n_not_multiple_of_block":
        q = k = v = torch.zeros(1, 2, 320, 16)
    elif case == "non_contiguous":
        q = torch.zeros(1, 256, 2, 16).transpose(1, 2)
    elif case == "shape_mismatch":
        k = v = torch.zeros(1, 2, 512, 16)
    with pytest.raises(exc):
        fused_attention(q, k, v)


def test_cpu_path_launches_no_kernel():
    before = fused_attention.launches
    x = torch.randn(1, 1, 128, 16, generator=torch.Generator().manual_seed(0))
    out = fused_attention(x, x, x)
    assert fused_attention.launches == before
    torch.testing.assert_close(out, attention_reference(x, x, x), rtol=0, atol=0)


def test_bfloat16_on_cpu_keeps_dtype():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 256, 32, generator=g) for _ in range(3))
    out = fused_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert out.dtype == torch.bfloat16
    want = attention_reference(q.bfloat16().float(), k.bfloat16().float(), v.bfloat16().float())
    # only the output is rounded to bf16 (2⁻⁸ relative on O(1) values)
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), atol=1e-2)
