"""The port's latent-DDPM train step against the JAX ``DiffusionTask``, on the CPU.

A small latent config: 128×128 images → 32×32×4 latents, UNet width 0.25
without the deep conv pair, VQ-VAE hidden 32 with 32 codes, 50 noise steps,
batch 4, float32. The one SA site with N ≥ 1024 (sa_5: N = 1024, d = 4) is
forced through the port's fused path, so its backward is the autograd
Function's (``attention_bwd_reference`` on the CPU); the JAX task runs its
einsum path there. Weights cross with ``bridge.state_dict_from_flax``; t,
noise and the label-keep flag are rebuilt from the JAX step's key splits and
injected into the port.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from spectrogramgenai_tpu.core import config as jc  # noqa: E402
from spectrogramgenai_tpu.core.ema import ema_init as jax_ema_init  # noqa: E402
from spectrogramgenai_tpu.core.ema import ema_update as jax_ema_update  # noqa: E402
from spectrogramgenai_tpu.core.mesh import MeshSpec, create_mesh  # noqa: E402
from spectrogramgenai_tpu.models.vqvae import VQVAE as JaxVQVAE  # noqa: E402
from spectrogramgenai_tpu.train.diffusion_task import DiffusionTask as JaxTask  # noqa: E402
from spectrogramgenai_tpu.train.state import new_train_state  # noqa: E402
from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from spectrogramgenai_tpu_torch.core import config as tc  # noqa: E402
from spectrogramgenai_tpu_torch.core.ema import ema_init, ema_update  # noqa: E402
from spectrogramgenai_tpu_torch.models.layers import SpatialSelfAttention  # noqa: E402
from spectrogramgenai_tpu_torch.models.vqvae import VQVAE  # noqa: E402
from spectrogramgenai_tpu_torch.ops.attention import fused_attention  # noqa: E402
from spectrogramgenai_tpu_torch.train.common import make_adamw_onecycle, onecycle_lr  # noqa: E402
from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask  # noqa: E402
from torch_port_helpers import one_torch_thread, random_flax_variables  # noqa: E402, F401

CFG_KW = dict(img_size=128, latent=True, num_classes=3, noise_steps=50, width_mult=0.25,
              remove_deep_conv=True, vq_hidden_dim=32, vq_n_embeddings=32, compute_dtype="float32",
              ema_start=2, ema_beta=0.9)
TOTAL_STEPS = 10
BATCH = 4


def _jax_task(grad_accum: int):
    jvq = JaxVQVAE(hidden_dim=32, n_embeddings=32)
    vq_vars = random_flax_variables(jvq, jnp.zeros((1, 128, 128, 1)), seed=1)
    mesh = create_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
    jt = JaxTask(jc.DDPMConfig(**CFG_KW, grad_accum=grad_accum), mesh, total_steps=TOTAL_STEPS,
                 vq_variables=vq_vars, vqvae=jvq)
    params = random_flax_variables(jt.model, jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)),
                                   jnp.zeros((1,), jnp.int32), jnp.ones((1,)), seed=3)["params"]
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = new_train_state(params, jt.tx, jax.random.PRNGKey(5), ema_params=jax_ema_init(params))
    return jt, vq_vars, state


def _port_task(vq_vars, params, grad_accum: int):
    vq_sd = state_dict_from_flax(VQVAE(hidden_dim=32, n_embeddings=32), vq_vars)
    task = DiffusionTask(tc.DDPMConfig(**CFG_KW, grad_accum=grad_accum), "cpu", vq_params=vq_sd,
                         total_steps=TOTAL_STEPS)
    for m in task.model.modules():
        if isinstance(m, SpatialSelfAttention):
            m.fused = True  # the CUDA route, on the CPU: forward and VJP plain versions
    state = task.init_state(0, params=state_dict_from_flax(task.model, {"params": params}))
    return task, state


def _draws(jt, jstate, k: int):
    """The t, noise and keep flags the JAX step draws (its key splits, repeated)."""
    _, step_key = jax.random.split(jstate.rng)
    keys = [step_key] if k == 1 else list(jax.random.split(step_key, k))
    n = BATCH // k
    ts, noises, keeps = [], [], []
    for key in keys:
        k_t, k_noise, k_drop = jax.random.split(key, 3)
        ts.append(np.asarray(jax.random.randint(k_t, (n,), 1, jt.schedule.noise_steps)))
        noises.append(np.asarray(jax.random.normal(k_noise, (n, 32, 32, 4), jnp.float32)))
        keeps.append(float(jax.random.uniform(k_drop, ()) >= jt.cfg.label_drop))
    return (torch.from_numpy(np.concatenate(ts)), torch.from_numpy(np.concatenate(noises)),
            torch.tensor(keeps))


def _batches(steps: int):
    rng = np.random.default_rng(7)
    return [(rng.uniform(0, 1, (BATCH, 128, 128, 1)).astype(np.float32),
             rng.integers(0, 3, BATCH).astype(np.int32)) for _ in range(steps)]


def _run_both(grad_accum: int, steps: int):
    jt, vq_vars, jstate = _jax_task(grad_accum)
    task, state = _port_task(vq_vars, jstate.params, grad_accum)
    jstep = jax.jit(functools.partial(jt._train_step, encoded=False))
    launches = fused_attention.launches
    losses, keeps = [], []
    for images, labels in _batches(steps):
        t, noise, keep = _draws(jt, jstate, grad_accum)
        keeps.extend(keep.tolist())
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels))
        state, m = task.train_step(state, torch.from_numpy(images), torch.from_numpy(labels).long(),
                                   t=t, noise=noise, keep=keep)
        losses.append((float(m["train_mse"]), float(jm["train_mse"])))
    assert fused_attention.launches == launches  # the CPU route launches no kernel
    return task, state, jt, jstate, losses, keeps


def _assert_state_close(task, state, jstate, rtol, atol):
    for name, want_tree in (("params", jstate.params), ("ema_params", jstate.ema_params)):
        want = state_dict_from_flax(task.model, {"params": want_tree})
        got = getattr(state, name)
        for key, w in want.items():
            np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=rtol, atol=atol, err_msg=f"{name}.{key}")


@pytest.fixture(scope="module")
def three_steps():
    return _run_both(grad_accum=1, steps=3)


def test_three_train_steps_match_jax(three_steps):
    task, state, _, jstate, losses, _ = three_steps
    assert state.step == int(jstate.step) == 3
    for got, want in losses:
        # f32 sums in another order (convolutions, the attention VJP): 2.4e-6 measured
        assert abs(got - want) <= 1e-5 * abs(want)
    # AdamW divides each gradient element by its own running RMS, so an
    # element whose gradient cancels to near 0 carries its rounding into a
    # step of up to ~lr. The three lrs sum to 5.4e-3, the most a weight can
    # move; 5e-5 is 1 % of that (measured: 1.65e-5 on one weight of 4,608)
    _assert_state_close(task, state, jstate, rtol=1e-4, atol=5e-5)
    # the module is the refreshed working copy of the masters
    for k, v in task.model.state_dict().items():
        torch.testing.assert_close(v, state.params[k], rtol=0, atol=0)


def test_ema_before_and_after_ema_start(three_steps):
    # ema_start = 2: steps 0 and 1 copy the params, step 2 blends with β = 0.9;
    # the blend is checked against the JAX state in test_three_train_steps_match_jax
    task, state, *_ = three_steps
    for k in state.params:
        assert not torch.equal(state.ema_params[k], state.params[k])


def test_grad_accum_two_microbatches_match_jax():
    task, state, _, jstate, losses, keeps = _run_both(grad_accum=2, steps=1)
    assert state.step == int(jstate.step) == 1 and len(keeps) == 2
    got, want = losses[0]
    assert abs(got - want) <= 2e-5 * abs(want)
    _assert_state_close(task, state, jstate, rtol=1e-4, atol=5e-5)


def test_first_step_gradients_match_jax():
    from spectrogramgenai_tpu.diffusion.ddpm import diffusion_loss as jax_diffusion_loss
    from spectrogramgenai_tpu_torch.diffusion.ddpm import diffusion_loss
    from spectrogramgenai_tpu_torch.train.common import microbatch_accumulate

    jt, vq_vars, jstate = _jax_task(1)
    task, state = _port_task(vq_vars, jstate.params, 1)
    (images, labels), = _batches(1)
    t, noise, keep = _draws(jt, jstate, 1)
    _, step_key = jax.random.split(jstate.rng)
    x = jt._encode(jnp.asarray(images))
    want = state_dict_from_flax(task.model, {"params": jax.jit(jax.grad(
        lambda p: jax_diffusion_loss(jt._apply, p, jt.schedule, x, jnp.asarray(labels), step_key,
                                     jt.cfg.label_drop)))(jstate.params)})
    module = dict(task.model.named_parameters())
    xt = task.encode(torch.from_numpy(images))
    _, grads, _ = microbatch_accumulate(
        lambda mb: (diffusion_loss(task.model, task.schedule, xt, torch.from_numpy(labels).long(), t=t,
                                   noise=noise, keep=keep[0]), {}), [{}], [module[n] for n in state.params])
    scale = max(w.norm().item() for w in want.values())
    for name, g in zip(state.params, grads):
        w = want[name]
        if w.norm().item() <= 1e-6 * scale:
            # the key biases: softmax is shift-invariant, so their true
            # gradient is 0 and both sides hold rounding noise (~1e-10)
            assert g.norm().item() <= 1e-6 * scale, name
        else:
            # per tensor, relative to its own norm (measured median 4.8e-6)
            assert (g - w).norm().item() <= 1e-4 * w.norm().item(), name


def test_ema_update_matches_jax():
    rng = np.random.default_rng(0)
    e = {"a": rng.standard_normal((3, 5)).astype(np.float32), "b": rng.standard_normal(7).astype(np.float32)}
    p = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in e.items()}
    for step in (0, 9, 10, 11):
        want = jax_ema_update({k: jnp.asarray(v) for k, v in e.items()}, {k: jnp.asarray(v) for k, v in p.items()},
                              step, beta=0.995, step_start=10)
        got = ema_update({k: torch.from_numpy(v.copy()) for k, v in e.items()},
                         {k: torch.from_numpy(v) for k, v in p.items()}, step, beta=0.995, step_start=10)
        for k in e:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    init = ema_init({"a": torch.ones(2)})
    assert init["a"].data_ptr() != torch.ones(2).data_ptr() and torch.equal(init["a"], torch.ones(2))


@pytest.mark.parametrize("total_steps", [4, 10, 37, 1000])
def test_lr_schedule_matches_optax(total_steps):
    want = optax.cosine_onecycle_schedule(transition_steps=total_steps, peak_value=5e-3, pct_start=0.3,
                                          div_factor=25.0, final_div_factor=1e4)
    for step in range(total_steps + 3):
        # optax evaluates in float32: near the end, cos(π·pct) + 1 cancels
        # (1.3e-5 relative at step 985 of 1000), hence an atol of 1e-6·peak
        np.testing.assert_allclose(onecycle_lr(step, total_steps, 5e-3), float(want(step)), rtol=1e-5,
                                   atol=5e-9, err_msg=f"step {step}")


@pytest.mark.parametrize("total_steps", [1, 2, 3])
def test_lr_schedule_skips_an_empty_warmup(total_steps):
    # optax returns NaN here (its warm-up phase has int(0.3·total) = 0 steps
    # and it divides 0 by 0); the port starts at the peak and anneals
    lrs = [onecycle_lr(step, total_steps, 5e-3) for step in range(total_steps + 2)]
    assert lrs[0] == pytest.approx(5e-3) and lrs[-1] == pytest.approx(5e-3 / 25 / 1e4)
    assert all(np.isfinite(lrs)) and lrs == sorted(lrs, reverse=True)


def test_adamw_matches_optax_step_by_step():
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((4, 6)).astype(np.float32), "b": rng.standard_normal(6).astype(np.float32)}
    tx = optax.adamw(optax.cosine_onecycle_schedule(transition_steps=8, peak_value=5e-3), b1=0.9, b2=0.999,
                     eps=1e-5, weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt, lr = make_adamw_onecycle(list(tp.values()), 5e-3, 8, eps=1e-5)
    for step in range(8):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        updates, opt_state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.param_groups[0]["lr"] = lr(step)
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {k}")
