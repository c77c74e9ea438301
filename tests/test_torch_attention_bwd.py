"""The port's attention VJP against ``jax.grad`` through the Pallas backward (interpret mode).

On the CPU the autograd Function's backward computes its plain version,
``attention_bwd_reference``; the CUDA kernels (``csrc/attention_bwd.cu``) are
checked against it on the card by chip_smoke.py and tests/test_torch_cuda.py.
Here the bf16 kernels' design is checked without a card: the identities that
let them read the forward's residuals (the row log-sum-exp and the f32
output) in place of a statistics pass, and a plain emulation of their
rounding (P and dS as bf16 hi + lo pairs, f32 sums). Errors are per row, each
normalised by that row's own norm: dQ by query row, dK and dV by key row.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectrogramgenai_tpu.ops.attention import fused_attention as jax_fused_attention  # noqa: E402
from spectrogramgenai_tpu_torch.ops.attention import (  # noqa: E402
    LOG2E,
    attention_bwd_reference,
    attention_reference,
    fused_attention,
    fused_attention_bwd,
    fused_attention_residuals,
)
from torch_port_helpers import one_torch_thread  # noqa: E402, F401

INTERPRET = jax.default_backend() != "tpu"


def row_rel_err(got, want) -> float:
    """max over rows of |got − want| / |want|, norms over the head dim."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)).max())


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(4))


def _port_grads(q, k, v, do):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    fused_attention(tq, tk, tv).backward(torch.from_numpy(do))
    return tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()


def _exact64(q, k, v, do):
    q, k, v, do = (np.asarray(x, np.float64) for x in (q, k, v, do))
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = q @ np.swapaxes(k, -1, -2) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    dp = do @ np.swapaxes(v, -1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdims=True))
    return ds @ k * scale, np.swapaxes(ds, -1, -2) @ q * scale, np.swapaxes(p, -1, -2) @ do


@pytest.mark.parametrize("shape", [(2, 4, 256, 16), (1, 2, 512, 32), (2, 1, 256, 4)])
def test_grads_match_jax_pallas_backward(shape):
    q, k, v, do = _inputs(0, shape)
    _, vjp = jax.vjp(lambda a, b, c: jax_fused_attention(a, b, c, q_block=128, interpret=INTERPRET),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got = _port_grads(q, k, v, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        # f32 sums in another order and JAX's unshifted exp (its fast path)
        # against the port's max-subtracted one
        assert row_rel_err(g, w) <= 1e-5, name


def test_plain_vjp_matches_autograd_of_the_plain_forward():
    q, k, v, do = _inputs(1, (2, 2, 256, 16))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    attention_reference(tq, tk, tv).backward(torch.from_numpy(do))
    got = attention_bwd_reference(*map(torch.from_numpy, (q, k, v, do)))
    for g, w in zip(got, (tq.grad, tk.grad, tv.grad)):
        assert row_rel_err(g.numpy(), w.numpy()) <= 1e-5


def test_large_logits_against_float64():
    # a component shared by every key adds q_i0·200/√d to each logit of row
    # i: logits up to ~165, past the TPU kernel's exp clip window (±75) and
    # exp's f32 range (88), while P keeps an O(1) spread. The max-subtracted
    # softmax stays exact; what is left is the f32 rounding of the logits
    # themselves (~|s|·2⁻²⁴·√d), 5.0e-5 per row on this input
    q, k, v, do = _inputs(2, (1, 2, 256, 16))
    k[..., 0] += 200.0
    got = _port_grads(q, k, v, do)
    want = _exact64(q, k, v, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(g).all()
        assert row_rel_err(g, w) <= 1e-4, name


def test_underflow_row_has_no_nan():
    # every score −d·10⁴/√d: an unshifted exp underflows to 0/0. Constant V
    # rows make dP constant along the row, so dS, dQ and dK are 0; dV is the
    # mean of dO over the (uniformly weighted) queries
    n, d = 256, 16
    q = np.full((1, 1, n, d), 100.0, np.float32)
    k = np.full((1, 1, n, d), -100.0, np.float32)
    v = np.ones((1, 1, n, d), np.float32)
    do = np.random.default_rng(3).standard_normal((1, 1, n, d)).astype(np.float32)
    dq, dk, dv = _port_grads(q, k, v, do)
    assert np.isfinite(dq).all() and np.isfinite(dk).all() and np.isfinite(dv).all()
    # dS is the rounding of dP − c (~2⁻²⁴·|dP|), carried into dQ and dK by |k| = |q| = 100
    np.testing.assert_allclose(dq, 0.0, atol=1e-4)
    np.testing.assert_allclose(dk, 0.0, atol=1e-4)
    np.testing.assert_allclose(dv, np.broadcast_to(do.mean(axis=2, keepdims=True), dv.shape), atol=1e-5)


def test_cpu_backward_launches_no_kernel_and_keeps_dtype():
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(1, 2, 256, 32, generator=g).bfloat16().requires_grad_() for _ in range(3))
    before = (fused_attention.launches, fused_attention_bwd.launches)
    out = fused_attention(q, k, v)
    assert out.grad_fn is not None
    out.float().sum().backward()
    assert (fused_attention.launches, fused_attention_bwd.launches) == before
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16
    want = attention_bwd_reference(q.detach(), k.detach(), v.detach(), torch.ones_like(q))
    for g_, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(g_, w, rtol=0, atol=0)


def test_no_autograd_node_in_inference_mode():
    x = torch.randn(1, 1, 128, 16, requires_grad=True)
    with torch.inference_mode():
        assert fused_attention(x, x, x).grad_fn is None
    with torch.no_grad():
        assert fused_attention(x, x, x).grad_fn is None


@pytest.mark.parametrize("case", ["shape", "dtype", "non_contiguous"])
def test_backward_rejects_a_bad_output_gradient(case):
    q = torch.zeros(1, 2, 256, 16)
    do = {"shape": torch.zeros(1, 2, 128, 16), "dtype": torch.zeros(1, 2, 256, 16).bfloat16(),
          "non_contiguous": torch.zeros(1, 256, 2, 16).transpose(1, 2)}[case]
    with pytest.raises(ValueError):
        fused_attention_bwd(q, q, q, do)


# ------------------------------------------- the bf16 kernels' design, on the CPU

BWD_TOL_BF16 = 5e-3  # chip_smoke.py's BWD_TOL["bfloat16"]: per row against float64


def _residual_identities(seed, shape):
    q, k, v, do = (torch.from_numpy(x).double() for x in _inputs(seed, shape))
    out, lse, o32 = attention_reference(q, k, v, residuals=True)
    s = (q @ k.mT) / np.sqrt(shape[-1])
    p = torch.softmax(s, dim=-1)
    dp = do @ v.mT
    return p, torch.exp2(s * LOG2E - lse[..., None]), (dp * p).sum(-1), (do * o32).sum(-1), dp


@pytest.mark.parametrize("shape", [(1, 2, 256, 16), (1, 2, 256, 32)])
def test_c_from_the_f32_output_is_rowsum_dp_p(shape):
    # c = rowsum(dP∘P) = Σ_j P_ij (dO_i·v_j) = dO_i·(Σ_j P_ij v_j) = rowsum(dO∘O)
    p, _, c_dp, c_out, dp = _residual_identities(5, shape)
    scale = (dp.abs() * p).sum(-1)  # the size of the terms summed
    assert ((c_dp - c_out).abs() / scale).max().item() <= 1e-6


@pytest.mark.parametrize("shape", [(1, 2, 256, 16), (1, 2, 256, 32)])
def test_p_from_the_saved_lse_is_the_softmax(shape):
    p, p_lse, *_ = _residual_identities(6, shape)
    assert ((p_lse - p).abs() / p).max().item() <= 1e-6


def test_residuals_of_the_plain_forward_are_float32_and_its_output():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _inputs(7, (1, 2, 256, 16))[:3])
    out, lse, o32 = fused_attention_residuals(q, k, v)  # CPU: the plain version
    assert out.dtype == torch.bfloat16 and lse.dtype == o32.dtype == torch.float32
    assert lse.shape == q.shape[:3] and o32.shape == q.shape
    assert torch.equal(out, attention_reference(q, k, v)) and torch.equal(o32.bfloat16(), out)
    s = q.double() @ k.double().mT / 4.0
    assert (lse.double() - torch.logsumexp(s, -1) * LOG2E).abs().max().item() <= 1e-5


def _split(x):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def mma_rounding_plan(q, k, v, do):
    """The bf16 backward kernels' arithmetic in plain PyTorch: f32 sums of
    exact bf16 products; the score rounded as (q·k)·log2(e)/√d; P from the
    saved lse; c from the f32 output; P and dS as bf16 hi + lo pairs."""
    d = q.shape[-1]
    scale = np.float32(1.0 / np.sqrt(np.float32(d)))
    scale_log2 = torch.tensor(LOG2E * scale, dtype=torch.float32)
    _, lse, o32 = attention_reference(q, k, v, residuals=True)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp2((qf @ kf.mT) * scale_log2 - lse[..., None])
    c = (dof * o32).sum(-1, keepdim=True)
    ds = p * (dof @ vf.mT - c)
    (p_hi, p_lo), (ds_hi, ds_lo) = _split(p), _split(ds)
    dv = p_hi.mT @ dof + p_lo.mT @ dof
    dq = (ds_hi @ kf + ds_lo @ kf) * scale
    dk = (ds_hi.mT @ qf + ds_lo.mT @ qf) * scale
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("d", [32, 16])  # the head dims of sa_0 and of sa_4 / sa_5
@pytest.mark.parametrize("large_logits", [False, True])
def test_rounding_plan_meets_the_bf16_tolerance_and_jax(d, large_logits):
    q, k, v, do = (x.astype(np.float32) for x in _inputs(8 + d, (1, 2, 256, d)))
    if large_logits:  # Σ_j dS_ij = 0 must survive the rounding of dS (see test_large_logits_against_float64)
        k[..., 0] += 200.0
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    got = mma_rounding_plan(tq, tk, tv, tdo)
    exact = _exact64(*(x.float().numpy() for x in (tq, tk, tv, tdo)))
    bf = [x.float().numpy() for x in (tq, tk, tv, tdo)]
    _, vjp = jax.vjp(lambda a, b, c: jax_fused_attention(a, b, c, q_block=128, interpret=INTERPRET),
                     *(jnp.asarray(x, jnp.bfloat16) for x in bf[:3]))
    want_jax = [np.asarray(g, np.float32) for g in vjp(jnp.asarray(bf[3], jnp.bfloat16))]
    for name, g, e, j in zip(("dq", "dk", "dv"), got, exact, want_jax):
        g = g.float().numpy()
        # the bf16 rounding of the output alone reads up to ~3.3e-3 per row
        assert row_rel_err(g, e) <= BWD_TOL_BF16, name
        # JAX rounds P̃ and dS to one bf16 each: 4.8e-3 – 6.5e-3 per row of its
        # own against float64 here, and 0.17 – 0.32 for dQ of a large-logit
        # head (its Σ_j dS_ij = 0 is lost to that rounding), so it is the
        # reference for ordinary logits only
        if not large_logits:
            assert row_rel_err(g, j) <= 2e-2, name
    if large_logits:  # the reference's own dQ: its single-bf16 dS loses Σ_j dS_ij = 0
        assert row_rel_err(want_jax[0], exact[0]) > 0.1


def test_bf16_backward_takes_residuals_of_the_right_shape():
    q = torch.zeros(1, 2, 256, 16).bfloat16()
    lse, o32 = torch.zeros(1, 2, 256), torch.zeros(1, 2, 256, 16)
    with pytest.raises(ValueError, match="together"):
        fused_attention_bwd(q, q, q, q, lse=lse)
    with pytest.raises(ValueError, match="lse"):
        fused_attention_bwd(q, q, q, q, lse[..., :128].contiguous(), o32)
    with pytest.raises(ValueError, match="o32"):
        fused_attention_bwd(q, q, q, q, lse, o32.bfloat16())
    assert all(g.dtype == torch.bfloat16 for g in fused_attention_bwd(q, q, q, q, lse, o32))
