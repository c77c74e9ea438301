"""The port's ACGAN (models, spectral norm, train step, CLI) against the JAX package, on the CPU.

Float32 throughout. Weights, BatchNorm statistics and spectral norm's ``u``
and σ cross with ``bridge.state_dict_from_flax``; the random flax variables
give ``u`` normal(0, 1) entries, as flax initialises it. The two packages'
random streams differ, so the train step takes the JAX step's fake labels
and noise, made from its own keys. The step's generator is a 2-block one
(64×64) on both sides, swapped into each task as ``tests/test_tasks.py``
swaps ``img_size``; the discriminator is built for 64×64. One step runs
plain, one with ``grad_accum=2``, the acoustic-index head and a denoiser
together. The full
4-block generator is compared once, at batch 1.

RMSprop's first update is lr·g/(√(0.01·g²) + eps) ≈ 10·lr·sign(g) whatever
|g| is, so a gradient element at rounding level can flip its sign between
the packages and move its parameter by 2·10·lr = 0.04. The step's
gradients are compared through RMSprop's ν = 0.01·g² per tensor, the
statistics at a tolerance, and the updated parameters only where |g| is
well above rounding.
"""

import functools
import inspect
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectrogramgenai_tpu.cli import train_acgan as jcli  # noqa: E402
from spectrogramgenai_tpu.core import config as jc  # noqa: E402
from spectrogramgenai_tpu.core.mesh import MeshSpec, create_mesh  # noqa: E402
from spectrogramgenai_tpu.models import denoiser as jd  # noqa: E402
from spectrogramgenai_tpu.models import gan as jg  # noqa: E402
from spectrogramgenai_tpu.train import acgan_task as jtask  # noqa: E402
from spectrogramgenai_tpu_torch.audio.export import encode_png_rgb  # noqa: E402
from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from spectrogramgenai_tpu_torch.cli import train_acgan as tcli  # noqa: E402
from spectrogramgenai_tpu_torch.core import config as tc  # noqa: E402
from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from spectrogramgenai_tpu_torch.models import denoiser as td  # noqa: E402
from spectrogramgenai_tpu_torch.models import gan as tg  # noqa: E402
from spectrogramgenai_tpu_torch.train import acgan_task as ttask  # noqa: E402
from torch_port_helpers import one_torch_thread, random_flax_variables  # noqa: E402, F401

N_CLASSES, N_IND, SIZE = 5, 11, 64
# float32 forwards: convolutions summed in another order
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
STAT_RTOL, STAT_ATOL = 1e-4, 1e-6
# a step's gradient per tensor, relative to its norm. Both nets are piecewise
# linear (ReLU, LeakyReLU, max): a pre-activation within float32 rounding of 0
# takes another slope in the other package and moves the gradients of the
# layers before it as a whole. One such flip read 2.1e-3 (the discriminator's
# first conv, in the second microbatch of a plain grad_accum=2 step of this
# file's weights; XLA's jitted and op-by-op runs of the JAX step differ by
# 1.8e-3 the same way on the first),
# while without a flip the port reads ≤ 3e-6 from the JAX step and its own
# float32 step ≤ 1.6e-6 from float64 (test_step_gradients_match_float64)
GRAD_TOL = 5e-3
LR = 0.002


def _variables(module, *args, seed: int = 0, **kw) -> dict:
    """Random flax variables of ``module.init(…, **kw)``."""
    return random_flax_variables(types.SimpleNamespace(init=functools.partial(module.init, **kw)), *args, seed=seed)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got: torch.Tensor, want, rtol=FWD_RTOL, atol=FWD_ATOL, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _port(module: torch.nn.Module, variables: dict) -> torch.nn.Module:
    module.load_state_dict(state_dict_from_flax(module, variables))
    return module


# -- the models ---------------------------------------------------------------------

@pytest.mark.parametrize("num_blocks, batch", [(2, 3), (4, 1)])
def test_generator_matches_jax(num_blocks, batch):
    noise = 64 + N_CLASSES
    jgen = jg.Generator(noise_dim=noise, num_blocks=num_blocks)
    variables = _variables(jgen, jnp.zeros((1, noise)), train=False)
    tgen = _port(tg.Generator(noise_dim=noise, num_blocks=num_blocks), variables)
    z = np.random.default_rng(1).standard_normal((batch, noise)).astype(np.float32)
    side = 16 * 2**num_blocks
    want = jgen.apply(variables, jnp.asarray(z), train=False)
    got = tgen(torch.from_numpy(z), train=False)
    assert got.shape == (batch, side, side, 1) and got.dtype == torch.float32
    _close(got, want)
    if num_blocks == 4:
        return
    # train mode: batch statistics; bn1 (applied twice) takes two EMA updates in sequence
    want, updated = jgen.apply(variables, jnp.asarray(z), train=True, mutable=["batch_stats"])
    got = tgen(torch.from_numpy(z), train=True)
    _close(got, want)
    stats = state_dict_from_flax(tgen, {"params": variables["params"], **_np(updated)})
    for k, v in tgen.state_dict().items():
        if "running" in k:
            _close(v, stats[k], STAT_RTOL, STAT_ATOL, k)
    calls = []
    tgen.block_0.bn1.register_forward_hook(lambda *_: calls.append(1))
    tgen(torch.from_numpy(z), train=True)
    assert len(calls) == 2  # bn1 runs twice a forward, so its statistics take two updates


@pytest.mark.parametrize("n_ind", [None, N_IND])
def test_discriminator_matches_jax(n_ind):
    jdis = jg.Discriminator(n_classes=N_CLASSES, n_ind=n_ind)
    variables = _variables(jdis, jnp.zeros((1, SIZE, SIZE, 1)), train=False)
    tdis = _port(tg.Discriminator(n_classes=N_CLASSES, n_ind=n_ind, img_size=SIZE), variables)
    x = np.random.default_rng(2).uniform(-1, 1, (3, SIZE, SIZE, 1)).astype(np.float32)
    for train in (False, True):
        want, updated = jdis.apply(variables, jnp.asarray(x), train=train, mutable=["batch_stats"])
        got = tdis(torch.from_numpy(x), train=train)
        assert len(got) == (3 if n_ind else 2)
        for g, w in zip(got, want):
            _close(g, w)
        stats = state_dict_from_flax(tdis, {"params": variables["params"], **_np(updated)})
        for k, v in tdis.state_dict().items():
            if k.endswith((".u", ".sigma")):
                _close(v, stats[k], STAT_RTOL, STAT_ATOL, k)
        if not train:  # update_stats=False leaves u and σ as they were
            before = state_dict_from_flax(tdis, variables)
            assert all(torch.equal(v, before[k]) for k, v in tdis.state_dict().items() if k.endswith(".u"))


def test_cbam_matches_jax():
    jcbam = jg.CBAM(32)
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 32)).astype(np.float32)
    variables = _variables(jcbam, jnp.zeros((1, 8, 8, 32)))
    tcbam = _port(tg.CBAM(32), variables)
    got = tcbam(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, jcbam.apply(variables, jnp.asarray(x)))


class _SpectralNormed(fnn.Module):
    """A flax layer ``c`` under ``nn.SpectralNorm``, as the discriminator wraps its layers."""

    layer: str

    @fnn.compact
    def __call__(self, x, update_stats: bool):
        c = fnn.Conv(6, (3, 3), strides=2, padding=1, name="c") if self.layer == "conv" else fnn.Dense(7, name="c")
        return fnn.SpectralNorm(c)(x, update_stats=update_stats)


def _spectral_normed_pair(layer: str, seed: int):
    """The flax module, its random variables, the port's layer holding them, and an input."""
    jmod = _SpectralNormed(layer)
    holder = torch.nn.Module()
    if layer == "conv":
        holder.c = tg.SpectralNormConv2d(4, 6, 3, stride=2, padding=1)
        x = np.random.default_rng(seed).standard_normal((2, 9, 9, 4)).astype(np.float32)
    else:
        holder.c = tg.SpectralNormLinear(12, 7)
        x = np.random.default_rng(seed).standard_normal((3, 12)).astype(np.float32)
    variables = _variables(jmod, jnp.asarray(x), seed=seed, update_stats=False)
    return jmod, variables, _port(holder, variables).c, x


@pytest.mark.parametrize("update_stats", [True, False])
@pytest.mark.parametrize("layer", ["conv", "dense"])
def test_spectral_norm_matches_flax(layer, update_stats):
    # two calls in a row: with update_stats the second starts from the first's u
    jmod, variables, tmod, x = _spectral_normed_pair(layer, seed=4)
    nchw = layer == "conv"
    u0 = tmod.u.clone()
    for _ in range(2):
        want, updated = jmod.apply(variables, jnp.asarray(x), update_stats, mutable=["batch_stats"])
        xt = torch.from_numpy(x)
        got = tmod(xt.permute(0, 3, 1, 2) if nchw else xt, update_stats)
        _close(got.permute(0, 2, 3, 1) if nchw else got, want)
        variables = {"params": variables["params"], **_np(updated)}
        stats = variables["batch_stats"]["SpectralNorm_0"]
        _close(tmod.u, stats["c/kernel/u"], STAT_RTOL, STAT_ATOL, "u")
        _close(tmod.sigma, stats["c/kernel/sigma"], STAT_RTOL, STAT_ATOL, "sigma")
    assert torch.equal(tmod.u, u0) != update_stats
    if update_stats:  # unit norm once updated
        assert abs(float(tmod.u.norm()) - 1.0) < 1e-5


@pytest.mark.parametrize("layer", ["conv", "dense"])
def test_spectral_norm_gradient_flows_through_sigma_only(layer):
    # d(W/σ)/dW with σ = v·W·uᵀ and u, v held: flax's gradient; the bias's too
    jmod, variables, tmod, x = _spectral_normed_pair(layer, seed=5)

    def loss(params):
        return jnp.sum(jmod.apply({**variables, "params": params}, jnp.asarray(x), False) ** 2)

    want = state_dict_from_flax(_wrap(tmod), {"params": jax.grad(loss)(variables["params"]),
                                              "batch_stats": variables["batch_stats"]})
    xt = torch.from_numpy(x)
    tmod(xt.permute(0, 3, 1, 2) if layer == "conv" else xt, False).square().sum().backward()
    _close(tmod.weight.grad, want["c.weight"], 1e-4, 1e-5, "weight")
    _close(tmod.bias.grad, want["c.bias"], 1e-4, 1e-5, "bias")


def _wrap(layer: torch.nn.Module) -> torch.nn.Module:
    holder = torch.nn.Module()
    holder.c = layer
    return holder


def test_bridge_fills_every_gan_tensor():
    jdis = jg.Discriminator(n_classes=N_CLASSES, n_ind=N_IND)
    variables = _variables(jdis, jnp.zeros((1, SIZE, SIZE, 1)), train=False)
    tdis = tg.Discriminator(n_classes=N_CLASSES, n_ind=N_IND, img_size=SIZE)
    sd = state_dict_from_flax(tdis, variables)
    assert set(sd) == set(tdis.state_dict())
    np.testing.assert_array_equal(sd["layer_ai.u"].numpy(), variables["batch_stats"]["SpectralNorm_6"]["layer_ai/kernel/u"])
    np.testing.assert_array_equal(sd["block_1_conv.weight"].numpy(),
                                  variables["params"]["block_1_conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["layer_c.weight"].numpy(), variables["params"]["layer_c"]["kernel"].T)
    del variables["batch_stats"]["SpectralNorm_3"]
    with pytest.raises(KeyError, match="block_3_conv"):
        state_dict_from_flax(tdis, variables)


def test_build_noise_bce_nll_match_jax():
    rng = np.random.default_rng(6)
    labels, a_ind = rng.integers(0, N_CLASSES, 6), rng.standard_normal((6, N_IND)).astype(np.float32)
    normal = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (6, 64 + N_CLASSES)))
    want = jg.build_noise(jax.random.PRNGKey(3), 6, 64, N_CLASSES, jnp.asarray(labels), jnp.asarray(a_ind))
    got = tg.build_noise(torch.from_numpy(labels), 64, N_CLASSES, torch.from_numpy(a_ind),
                         normal=torch.from_numpy(normal))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pred = np.concatenate([rng.uniform(0, 1, (5, 1)), [[0.0], [1.0], [1e-9]]]).astype(np.float32)
    target = rng.integers(0, 2, (8, 1)).astype(np.float32)
    np.testing.assert_allclose(ttask.bce(torch.from_numpy(pred), torch.from_numpy(target)).item(),
                               float(jtask.bce(jnp.asarray(pred), jnp.asarray(target))), rtol=1e-6)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.standard_normal((8, N_CLASSES))), -1))
    lab = rng.integers(0, N_CLASSES, 8)
    np.testing.assert_allclose(ttask.nll(torch.from_numpy(logp), torch.from_numpy(lab)).item(),
                               float(jtask.nll(jnp.asarray(logp), jnp.asarray(lab))), rtol=1e-6)


# -- the train step -----------------------------------------------------------------

def _denoiser_pair():
    """A small JAX denoiser (d_model 32, 1 layer) at 64×64 and the port's with its weights."""
    jden = jd.TransformerDenoiser(num_layers=1, d_model=32)
    variables = _variables(jden, jnp.zeros((1, SIZE, SIZE, 1)), seed=9)
    tden = _port(td.TransformerDenoiser(num_layers=1, d_model=32), variables)
    return (lambda x: jden.apply(variables, x)), (lambda x: tden(x))


def _step_both(grad_accum: int = 1, use_aind: bool = False, denoiser: bool = False, batch: int = 2):
    """One ACGAN step of each package from the same weights, batch, fake labels and noise."""
    mesh = create_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
    kw = dict(num_classes=N_CLASSES, compute_dtype="float32", grad_accum=grad_accum, use_aind=use_aind)
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (batch, SIZE, SIZE, 1)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, batch).astype(np.int32)
    a_ind = rng.standard_normal((batch, N_IND)).astype(np.float32) if use_aind else None
    jden, tden = _denoiser_pair() if denoiser else (None, None)

    jt = jtask.ACGANTask(jc.ACGANConfig(**kw, data=jc.DataConfig(img_size=SIZE)), mesh, denoiser_apply=jden)
    jt.generator = jg.Generator(noise_dim=jt.total_noise, num_blocks=2)  # 64×64
    g_vars = _variables(jt.generator, jnp.zeros((1, jt.total_noise)), seed=1, train=False)
    d_vars = _variables(jt.discriminator, jnp.zeros((1, SIZE, SIZE, 1)), seed=2, train=False)
    rng_key = jax.random.PRNGKey(0)
    jstate = jtask.GANTrainState(step=jnp.zeros((), jnp.int32), g_params=g_vars["params"],
                                 g_stats=g_vars["batch_stats"], g_opt=jt.g_tx.init(g_vars["params"]),
                                 d_params=d_vars["params"], d_stats=d_vars["batch_stats"],
                                 d_opt=jt.d_tx.init(d_vars["params"]), rng=rng_key)
    # the step's fake labels and noise, drawn as the JAX step draws them
    _, k_noise, k_labels = jax.random.split(rng_key, 3)
    if grad_accum > 1:
        k_noise, k_labels = jax.random.split(k_noise, grad_accum), jax.random.split(k_labels, grad_accum)
    else:
        k_noise, k_labels = [k_noise], [k_labels]
    n = batch // grad_accum
    fake_labels, z = [], []
    for i, (kn, kl) in enumerate(zip(k_noise, k_labels)):
        fl = jax.random.randint(kl, (n,), 0, N_CLASSES)
        fake_labels.append(np.asarray(fl))
        z.append(np.asarray(jt.build_noise(kn, fl, None if a_ind is None else jnp.asarray(a_ind[i * n:(i + 1) * n]))))
    args = (jnp.asarray(images), jnp.asarray(labels)) + ((jnp.asarray(a_ind),) if use_aind else ())
    jstate, jmetrics = _np(jax.jit(jt._train_step)(jstate, *args))

    tt = ttask.ACGANTask(tc.ACGANConfig(**kw, data=tc.DataConfig(img_size=SIZE)), "cpu", denoiser_apply=tden)
    tt.generator = tg.Generator(noise_dim=tt.total_noise, num_blocks=2)
    state = tt.init_state(0, state_dict_from_flax(tt.generator, g_vars), state_dict_from_flax(tt.discriminator, d_vars))
    initial = {**{f"g.{k}": v.clone() for k, v in state.g_params.items()},
               **{f"d.{k}": v.clone() for k, v in state.d_params.items()}}
    state, metrics = tt.train_step(state, torch.from_numpy(images), torch.from_numpy(labels),
                                   None if a_ind is None else torch.from_numpy(a_ind),
                                   z=torch.from_numpy(np.concatenate(z)),
                                   fake_labels=torch.from_numpy(np.concatenate(fake_labels)))
    return jt, jstate, jmetrics, tt, state, metrics, initial


def _check_player(module, params, stats, opt, jparams, jstats, jnu, initial):
    want = state_dict_from_flax(module, {"params": jparams, "batch_stats": jstats})
    for k, v in stats.items():
        _close(v, want[k], STAT_RTOL, STAT_ATOL, k)
    jg_abs = {k: torch.sqrt(v / 0.01) for k, v in state_dict_from_flax(
        module, {"params": jnu, "batch_stats": jstats}).items() if k in params}
    scale = max(float(g.max()) for g in jg_abs.values())
    for k, p in params.items():
        g = torch.sqrt(opt.state[p]["square_avg"] / 0.01)  # |g|, from RMSprop's ν after one update
        gj = jg_abs[k]
        # relative to the tensor's norm, plus float32 rounding of the largest
        # gradient on each element: a conv bias ahead of a train-mode
        # BatchNorm has a true gradient of 0 (the batch mean takes it out)
        assert float((g - gj).norm()) <= GRAD_TOL * float(gj.norm()) + 1e-6 * scale * g.numel() ** 0.5, k
        # the update lr·g/(0.1·|g| + 1e-8) is ≈ ±10·lr: equal where |g| is well
        # above eps and the two |g| agree to 1 %, at most 2·10·lr apart elsewhere
        sure = (gj > max(1e-3 * float(gj.max()), 1e-4)) & ((g - gj).abs() <= 0.01 * gj)
        _close(p[sure], want[k].numpy()[sure.numpy()], 1e-5, 1e-6, k)
        assert float((p - want[k]).abs().max()) <= 20 * LR + 1e-5, k
        assert not torch.equal(p, initial[k]), k


@pytest.mark.parametrize("grad_accum, use_aind, denoiser", [(1, False, False), (2, True, True)])
def test_train_step_matches_jax(grad_accum, use_aind, denoiser):
    jt, jstate, jmetrics, tt, state, metrics, initial = _step_both(grad_accum, use_aind, denoiser)
    assert state.step == int(jstate.step) == 1
    for k in ("loss_G", "loss_D"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    assert float(metrics["d_acc"]) == float(jmetrics["d_acc"])
    _check_player(tt.generator, state.g_params, state.g_stats, state.g_opt, jstate.g_params, jstate.g_stats,
                  jstate.g_opt[0].nu, {k[2:]: v for k, v in initial.items() if k.startswith("g.")})
    _check_player(tt.discriminator, state.d_params, state.d_stats, state.d_opt, jstate.d_params, jstate.d_stats,
                  jstate.d_opt[0].nu, {k[2:]: v for k, v in initial.items() if k.startswith("d.")})
    # the working copy is the masters; u has unit norm after the step
    for k, v in tt.generator.named_parameters():
        assert torch.equal(v, state.g_params[k]), k
    for k, v in state.d_stats.items():
        if k.endswith(".u"):
            assert abs(float(v.norm()) - 1.0) < 1e-5, k


def test_step_gradients_match_float64():
    # the port's float32 microbatch gradients against the same computation in float64
    g_vars = _variables(jg.Generator(noise_dim=64 + N_CLASSES, num_blocks=2), jnp.zeros((1, 64 + N_CLASSES)), seed=1,
                        train=False)
    d_vars = _variables(jg.Discriminator(n_classes=N_CLASSES), jnp.zeros((1, SIZE, SIZE, 1)), seed=2, train=False)
    rng = np.random.default_rng(11)
    mb = {"im": torch.from_numpy(rng.uniform(0, 1, (1, SIZE, SIZE, 1)).astype(np.float32)),
          "la": torch.tensor([2]), "fl": torch.tensor([4]),
          "z": torch.from_numpy(rng.standard_normal((1, 64 + N_CLASSES)).astype(np.float32))}
    grads = []
    for dtype in (torch.float32, torch.float64):
        task = ttask.ACGANTask(tc.ACGANConfig(num_classes=N_CLASSES, compute_dtype="float32",
                                              data=tc.DataConfig(img_size=SIZE)), "cpu")
        task.generator = _port(tg.Generator(noise_dim=64 + N_CLASSES, num_blocks=2), g_vars).to(dtype)
        task.discriminator = _port(tg.Discriminator(n_classes=N_CLASSES, img_size=SIZE), d_vars).to(dtype)
        g, d, _ = task._micro_grads({k: v.to(dtype) if v.is_floating_point() else v for k, v in mb.items()},
                                    list(task.generator.parameters()), list(task.discriminator.parameters()))
        grads.append(g + d)
    scale = max(float(g.abs().max()) for g in grads[1])
    for g32, g64 in zip(*grads):
        err = float((g32.double() - g64).norm())
        assert err <= 1e-5 * float(g64.norm()) + 1e-7 * scale * g64.numel() ** 0.5, err


def test_generate_and_state_round_trip():
    cfg = tc.ACGANConfig(num_classes=N_CLASSES, compute_dtype="float32", data=tc.DataConfig(batch_size=2,
                                                                                           img_size=SIZE))
    task = ttask.ACGANTask(cfg, "cpu")
    task.generator = tg.Generator(noise_dim=task.total_noise, num_blocks=2)
    state = task.init_state(0)
    rng = np.random.default_rng(8)
    images = torch.from_numpy(rng.uniform(0, 1, (2, SIZE, SIZE, 1)).astype(np.float32))
    state, m = task.train_step(state, images, torch.tensor([0, 3]))
    assert 0.0 <= float(m["d_acc"]) <= 1.0 and np.isfinite(float(m["loss_G"]))
    saved = state.state_dict()
    again = ttask.ACGANTask(cfg, "cpu")
    again.generator = tg.Generator(noise_dim=task.total_noise, num_blocks=2)
    restored = again.load_state(again.init_state(1), saved)
    assert restored.step == 1 and torch.equal(restored.generator.get_state(), state.generator.get_state())
    for name in ("g_params", "g_stats", "d_params", "d_stats"):
        got, want = getattr(restored, name), getattr(state, name)
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want), name
    assert set(restored.state_dict()["g_opt"]) == set(saved["g_opt"])
    z = again.build_noise(torch.tensor([1, 2]), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.generate(restored, z), task.generate(state, z), rtol=0, atol=0)


# -- the reference's faults, followed by the port --------------------------------------

def test_num_blocks_does_not_reach_the_generator():
    mesh = create_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
    jt = jtask.ACGANTask(jc.ACGANConfig(num_blocks=2), mesh)
    tt = ttask.ACGANTask(tc.ACGANConfig(num_blocks=2), "cpu")
    assert jt.generator.num_blocks == tt.generator.num_blocks == 4


class _StubTask:
    """An ACGANTask stand-in for the CLI's control flow: records what it is
    given, counts its steps, and trains nothing."""

    made: list = []

    def __init__(self, cfg, device, denoiser_apply=None):
        self.cfg, self.denoiser_apply = cfg, denoiser_apply
        _StubTask.made.append(self)

    def init_state(self):
        return types.SimpleNamespace(step=0, state_dict=lambda: {"step": torch.tensor(0)})

    def build_noise(self, labels, generator=None):
        return torch.zeros(len(labels), 1)

    def train_step(self, state, images, labels, a_ind=None):
        state.step += 1
        return state, {"loss_G": torch.tensor(1.0), "loss_D": torch.tensor(1.0), "d_acc": torch.tensor(0.5)}

    def generate(self, state, z):
        return torch.zeros(len(z), 4, 4, 1)


def _stub_cli_run(tmp_path, monkeypatch, argv):
    monkeypatch.setattr(ttask, "ACGANTask", _StubTask)
    monkeypatch.chdir(tmp_path)
    _image_folder(tmp_path / "datasets" / "train", per_class=2, size=4)
    _StubTask.made = []
    tcli.main(["--data.dataset_path", "datasets", "--data.img_size", "4", "--data.batch_size", "2",
               "--num_classes", "3", "--device", "cpu", *argv])
    return _StubTask.made[0]


def test_acgan_cli_passes_no_denoiser(tmp_path, monkeypatch):
    # the JAX CLI builds ACGANTask(cfg, mesh): --use_denoiser reaches the config and nothing else
    task = _stub_cli_run(tmp_path, monkeypatch, ["--epochs", "2", "--use_denoiser", "true"])
    assert task.cfg.use_denoiser and task.denoiser_apply is None
    assert "ACGANTask(cfg, mesh)" in inspect.getsource(jcli.run)


def test_acgan_cli_trains_epochs_minus_one(tmp_path, monkeypatch):
    # range(st_epochs + 1, cfg.epochs), as the JAX CLI runs it: epochs 1 … 4 of --epochs 5
    _stub_cli_run(tmp_path, monkeypatch, ["--epochs", "5"])
    with open("results/acgan/training_results.csv") as f:
        assert [line.split(",")[0] for line in f.read().splitlines()[1:]] == ["1", "2", "3", "4"]
    assert CheckpointManager("models/acgan").all_steps() == [4]  # the last epoch; 10 is never reached
    assert "range(st_epochs + 1, cfg.epochs)" in inspect.getsource(jcli.run)


# -- the CLI ------------------------------------------------------------------------

def _image_folder(root, classes=("ant", "bee", "cat"), per_class: int = 2, size: int = SIZE):
    rng = np.random.default_rng(10)
    for c in classes:
        os.makedirs(root / c, exist_ok=True)
        for i in range(per_class):
            (root / c / f"{i}.png").write_bytes(encode_png_rgb(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)))


def test_train_acgan_cli_runs_and_resumes(tmp_path, monkeypatch, capsys):
    # a 1-block generator (32×32): the CLI's task builds the 4-block one whatever num_blocks says
    monkeypatch.setattr(ttask, "Generator", functools.partial(tg.Generator, num_blocks=1))
    monkeypatch.chdir(tmp_path)
    _image_folder(tmp_path / "datasets" / "train", per_class=1, size=32)
    common = ["--data.dataset_path", "datasets", "--data.img_size", "32", "--data.batch_size", "2",
              "--num_classes", "3", "--compute_dtype", "float32", "--sample_every", "1", "--device", "cpu",
              "--use_denoiser", "true"]
    task, state = tcli.main(["--epochs", "11", *common])
    # epochs 1 … 10 (range(st_epochs + 1, epochs), as the JAX CLI runs them), one step of 2 of the 3 images each
    assert state.step == 10 and task.denoiser_apply is None
    with open("results/acgan/training_results.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == "Epoch,Loss_D,Loss_G,Loss_A" and [int(x.split(",")[0]) for x in lines[1:]] == list(range(1, 11))
    assert all(np.isfinite(float(v)) for x in lines[1:] for v in x.split(",")[1:])
    assert os.path.exists("results/acgan/fake_samples_epoch_010.png")
    ckpt = CheckpointManager("models/acgan")
    assert ckpt.all_steps() == [10]  # every 10 epochs and the last (10)
    out = capsys.readouterr().out
    assert "[10/11][0] Loss_D" in out and "epoch 10: 1 steps in" in out

    task2, state2 = tcli.main(["--epochs", "12", "--st_epochs", "14", *common])  # rounds down to 10
    assert "resumed ACGAN from epoch 10 (step 10)" in capsys.readouterr().out
    assert state2.step == 11 and CheckpointManager("models/acgan").all_steps() == [10, 11]
    # manifest mode reads its specdata.npz (tests/test_torch_data_leftovers.py trains from one)
    with pytest.raises(FileNotFoundError, match="specdata.npz"):
        tcli.main(["--manifest", "specdata.npz", *common])
