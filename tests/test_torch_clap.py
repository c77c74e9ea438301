"""The port's CLAP audio tower and its mel front end against the JAX package, on the CPU.

The NumPy pieces (the bicubic matrix, the relative-position index, the shift
mask, ``quantize_int16``, ``repeatpad``) are held exactly equal to JAX's.
``clap_logmel`` (the exact mel kernel's plain version on the CPU, float64)
against JAX's float32 ``rfft`` within 1e-3 dB (reading 7.2e-5 dB on 10-s
tone-plus-noise clips). The tower with random JAX weights carried across by
``bridge.py``, float32: at the tiny config of ``tests/test_clap_golden.py``
within 2e-6 relative L2 (readings 2.1e-7 and 2.5e-7), and at the HTSAT-tiny
defaults (28 M parameters, 1001 frames) at batch 1 within 5e-6 (reading
6.1e-7). A LayerNorm eps of flax's 1e-6 in place of CLAP's 1e-5 reads 5.6e-6
and 1.1e-5 on the tiny tower, and a token of variance ~1e-6 (where that eps
decides the output) is held to the same 2e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from flax import serialization  # noqa: E402

from spectrogramgenai_tpu.eval import clap as jclap  # noqa: E402
from spectrogramgenai_tpu_torch.bridge import flax_from_state_dict, state_dict_from_flax  # noqa: E402
from spectrogramgenai_tpu_torch.eval import clap as tclap  # noqa: E402
from torch_port_helpers import one_torch_thread, random_flax_variables  # noqa: E402, F401

TINY = dict(num_mel_bins=16, spec_size=64, patch_size=4, patch_stride=4, patch_embeds_hidden_size=8,
            depths=(2, 2), num_attention_heads=(2, 4), window_size=4, projection_dim=8)
TINY_TOL, FULL_TOL, DB_TOL = 2e-6, 5e-6, 1e-3


def _rel(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(want))


def _features(rng, batch: int, frames: int, mels: int) -> np.ndarray:
    return (rng.normal(size=(batch, 1, frames, mels)) * 5 - 20).astype(np.float32)


def _clips(rng, lengths) -> list[np.ndarray]:
    """Tone-plus-noise clips at 48 kHz."""
    out = []
    for n in lengths:
        t = np.arange(n) / 48000
        out.append((0.5 * np.sin(2 * np.pi * rng.uniform(200, 9000) * t)
                    + 0.05 * rng.standard_normal(n)).astype(np.float32))
    return out


@pytest.mark.parametrize("n_in, n_out", [(1001, 1024), (200, 256), (7, 16), (1, 5), (5, 1), (64, 64)])
def test_bicubic_matrix_equals_jax_and_torch_interpolate(n_in, n_out):
    m = tclap.bicubic_align_corners_matrix(n_in, n_out)
    np.testing.assert_array_equal(m, jclap.bicubic_align_corners_matrix(n_in, n_out))
    if n_in > 1 and n_out > 1:
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 1, n_in, 3)).astype(np.float32))
        want = F.interpolate(x, size=(n_out, 3), mode="bicubic", align_corners=True)[0, 0].numpy()
        # torch takes the source coordinate i·(n_in − 1)/(n_out − 1) in float32 (ulp 6e-5 near 1000),
        # so its cubic weights move by ~1e-4 (reading 6.6e-5 on unit-normal data); the matrix is float64's
        np.testing.assert_allclose(m @ x[0, 0].numpy(), want, rtol=0, atol=5e-4)


@pytest.mark.parametrize("h, w, ws, shift", [(64, 64, 8, 4), (8, 8, 4, 2), (16, 8, 4, 2), (32, 32, 8, 4)])
def test_window_index_and_shift_mask_equal_jax(h, w, ws, shift):
    np.testing.assert_array_equal(tclap._relative_position_index(ws), jclap._relative_position_index(ws))
    np.testing.assert_array_equal(tclap._shift_attn_mask(h, w, ws, shift), jclap._shift_attn_mask(h, w, ws, shift))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, h, w, 3)).astype(np.float32))
    windows = tclap._window_partition(x, ws)
    np.testing.assert_array_equal(windows.numpy(), np.asarray(jclap._window_partition(jnp.asarray(x.numpy()), ws)))
    assert torch.equal(tclap._window_reverse(windows, ws, h, w), x)


def test_quantize_and_repeatpad_equal_jax():
    rng = np.random.default_rng(2)
    wav = np.concatenate([rng.uniform(-1.5, 1.5, 5000), [-1.0, 1.0, 0.99999, -0.99999, 0.0]]).astype(np.float32)
    np.testing.assert_array_equal(tclap.quantize_int16(wav), jclap.quantize_int16(wav))
    # truncation toward zero: 0.7 of a step rounds to 0 on both signs
    assert tclap.quantize_int16(np.float32([0.7, -0.7]) / 32767).tolist() == [0.0, 0.0]
    for n, max_samples in ((3000, 10000), (10000, 10000), (12000, 10000), (3, 10), (7, 10)):
        np.testing.assert_array_equal(tclap.repeatpad(wav[:n], max_samples), jclap.repeatpad(wav[:n], max_samples))


def test_clap_logmel_matches_jax():
    rng = np.random.default_rng(4)
    wavs = _clips(rng, (96000, 480000, 600000)) + [(1e-3 * rng.standard_normal(48000)).astype(np.float32)]
    want = np.asarray(jclap.clap_input_features(wavs))
    got = tclap.clap_input_features(wavs, device="cpu").numpy()
    # 10 s at 48 kHz, reflect-padded by 512: 1 + (481,024 − 1024) // 480 frames
    assert got.shape == want.shape == (4, 1, 1 + (480000 + 1024 - 1024) // 480, 64) == (4, 1, 1001, 64)
    assert np.abs(got - want).max() <= DB_TOL


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = jclap.ClapAudioTowerConfig(**TINY), tclap.ClapAudioTowerConfig(**TINY)
    variables = random_flax_variables(jclap.ClapAudioTower(jcfg), jnp.zeros((1, 1, 256, 16)), seed=0)
    return jcfg, tcfg, variables


@pytest.mark.parametrize("frames", [200, 256])  # bicubic resize to 256, and none
def test_tiny_tower_matches_jax(tiny, frames):
    jcfg, tcfg, variables = tiny
    feats = _features(np.random.default_rng(3), 2, frames, 16)
    want = np.asarray(jclap.ClapAudioTower(jcfg).apply(variables, jnp.asarray(feats)))
    with torch.no_grad():
        got = tclap.build_clap(variables, "cpu", tcfg)(torch.from_numpy(feats)).numpy()
    assert got.shape == (2, 8) and _rel(got, want) <= TINY_TOL


def test_tiny_tower_layer_norm_eps_matches_jax(tiny):
    # a patch embed scaled by 1e-3 with no bias gives the first LayerNorm tokens of
    # variance ~1e-6, so its eps (1e-5 in CLAP, not flax's 1e-6) decides their scale
    jcfg, tcfg, variables = tiny
    params = dict(variables["params"])
    proj = params["patch_embed_proj"]
    params["patch_embed_proj"] = {"kernel": proj["kernel"] * 1e-3, "bias": np.zeros_like(proj["bias"])}
    variables = {**variables, "params": params}
    feats = _features(np.random.default_rng(7), 2, 256, 16)
    want = np.asarray(jclap.ClapAudioTower(jcfg).apply(variables, jnp.asarray(feats)))
    model = tclap.build_clap(variables, "cpu", tcfg)
    norms = [m for m in model.modules() if isinstance(m, torch.nn.LayerNorm)]  # embed, 4 blocks × 2, merge, final
    assert len(norms) == 11 and all(m.eps == jcfg.layer_norm_eps == 1e-5 for m in norms)
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    assert _rel(got, want) <= TINY_TOL


def test_tower_bridge_round_trip_and_flax_file(tiny, tmp_path):
    _, tcfg, variables = tiny
    module = tclap.ClapAudioTower(tcfg)
    sd = state_dict_from_flax(module, variables)
    tree = flax_from_state_dict(module, sd)
    again = state_dict_from_flax(module, tree)
    assert set(again) == set(sd) and all(torch.equal(again[k], sd[k]) for k in sd)
    path = tmp_path / "clap_audio.msgpack"
    path.write_bytes(serialization.to_bytes(variables))
    loaded = tclap.build_clap(tclap.load_clap_params(str(path)), "cpu", tcfg).state_dict()
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)


def test_clap_embeddings_match_jax_and_are_unit_norm(tiny):
    # the tiny tower takes ≤ 256 frames: clips of up to 1 s (101 frames)
    jcfg, tcfg, variables = tiny
    jcfg, tcfg = (type(c)(**{**TINY, "max_length_s": 1}) for c in (jcfg, tcfg))
    wavs = _clips(np.random.default_rng(5), (48000, 30000, 70000))
    want = jclap.clap_embeddings(wavs, variables, jcfg, batch=2)
    got = tclap.clap_embeddings(wavs, variables, tcfg, batch=2, device="cpu")
    assert got.shape == (3, 8) and _rel(got, want) <= TINY_TOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-6)
    raw = tclap.clap_embeddings(wavs, variables, tcfg, device="cpu", normalize=False)
    np.testing.assert_allclose(got, raw / np.linalg.norm(raw, axis=1, keepdims=True), rtol=1e-6)


def test_htsat_tiny_tower_matches_jax():
    # the real HTSAT-tiny defaults at the real input shape (1001 frames → 1024), batch 1
    feats = _features(np.random.default_rng(6), 1, 1001, 64)
    variables = random_flax_variables(jclap.ClapAudioTower(), jnp.asarray(feats), seed=1)
    want = np.asarray(jax.jit(jclap.ClapAudioTower().apply)(variables, jnp.asarray(feats)))
    model = tclap.build_clap(variables, "cpu")
    assert sum(p.numel() for p in model.parameters()) > 27e6
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    assert got.shape == (1, 512) and _rel(got, want) <= FULL_TOL
