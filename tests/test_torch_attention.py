"""The port's attention wrapper against the JAX Pallas kernel (interpret mode).

On the CPU the wrapper computes its plain PyTorch version; the CUDA kernels
themselves are checked on the card by chip_smoke.py and
tests/test_torch_cuda.py. Here the tensor-core forward's two rounding plans
are checked without a card, through their plain emulation in
tests/torch_attention_helpers.py: serving (P as one bf16, the denominator summed
from those values: the JAX kernel's plan) and the residuals that training
saves (P as bf16 hi + lo, the denominator and lse from the f32 P).
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
    tensor_core_route,
)
import torch_attention_helpers as plans  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: E402, F401

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


def test_route_is_fixed_by_type_and_head_dim():
    assert [d for d in (2, 4, 8, 16, 32, 64) if tensor_core_route(torch.bfloat16, d)] == [16, 32, 64]
    assert not any(tensor_core_route(torch.float32, d) for d in (2, 4, 8, 16, 32, 64))


# ------------------------------------- the tensor-core forward's rounding, on the CPU


def _bf16_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16() for _ in range(4)]


def _exact64(q, k, v):
    q, k, v = q.double(), k.double(), v.double()
    return torch.softmax(q @ k.mT / np.sqrt(q.shape[-1]), dim=-1) @ v


@pytest.mark.parametrize("d", [16, 32])  # sa_4 / sa_5 and sa_0
def test_serving_rounding_plan_matches_jax_kernel_and_float64(d):
    q, k, v, _ = _bf16_inputs(20 + d, (1, 2, 256, d))
    got = plans.forward(q, k, v, residuals=False)
    assert got.dtype == torch.bfloat16
    got = got.double()
    want_jax = np.asarray(jax_fused_attention(*(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
                                              interpret=INTERPRET), np.float64)
    exact = _exact64(q, k, v)
    # both round P to one bf16 (the plan after its row max, JAX before) and
    # their outputs to bf16: one bf16 step (2⁻⁹ of values in [0.5, 1)) apart
    assert np.abs(got.numpy() - want_jax).max() <= 2 ** -8
    # what is left against float64 is the output's bf16 rounding and P's,
    # averaged over 256 keys (readings 1.6e-3 and 1.5e-3)
    assert (got - exact).abs().max().item() <= 2e-3


@pytest.mark.parametrize("d", [16, 32])
def test_residual_rounding_plan_meets_the_plain_residuals(d):
    q, k, v, _ = _bf16_inputs(30 + d, (1, 2, 512, d))
    out, lse, o32 = plans.forward(q, k, v, residuals=True)
    _, lse_p, o32_p = attention_reference(q, k, v, residuals=True)
    # chip_smoke.py's tolerance for the kernel: f32 sums in another order;
    # hi + lo leaves P's rounding at 2⁻¹⁷ (readings ≤ 9.9e-7)
    assert (lse - lse_p).abs().max().item() <= 1e-4 and (o32 - o32_p).abs().max().item() <= 1e-4
    assert torch.equal(o32.bfloat16(), out)
    # one bf16 P, as in serving, would move O₃₂ by ~2⁻⁹ of a term: 5.5e-4 / 5.3e-4 here
    assert (plans.one_bf16_residuals(q, k, v)[1] - o32_p).abs().max().item() > 1e-4


@pytest.mark.parametrize("d", [16, 32])
def test_residual_rounding_plan_keeps_the_backward_in_tolerance_at_large_logits(d):
    # a key component of 200: logits up to ~165 (see test_torch_attention_bwd.py).
    # An error in O₃₂ shifts c = rowsum(dO∘O₃₂) and every dS of the row with it,
    # which loses Σ_j dS_ij = 0, and the key component multiplies what is left
    q, k, v, do = _bf16_inputs(40 + d, (1, 2, 512, d))
    k = (k.float() + torch.tensor([200.0] + [0.0] * (d - 1))).bfloat16()
    exact = plans.exact64(q, k, v, do)
    lse, o32 = plans.forward(q, k, v, residuals=True)[1:]
    for name, g, e in zip(("dq", "dk", "dv"), plans.backward(q, k, v, do, lse, o32, pairs=True), exact):
        assert plans.row_rel_err(g, e) <= 5e-3, name  # chip_smoke.py's BWD_TOL["bfloat16"] (readings ≤ 3.0e-3)
    # with the one-bf16 O₃₂ the backward's dQ reads 0.31 (d 16) and 0.18 (d 32) per row
    dq = plans.backward(q, k, v, do, *plans.one_bf16_residuals(q, k, v), pairs=True)[0]
    assert plans.row_rel_err(dq, exact[0]) > 0.05
