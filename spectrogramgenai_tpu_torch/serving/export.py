"""Sampler export: a self-contained artifact of a trained DDPM sampler
(``spectrogramgenai_tpu/serving/export.py``).

The artifact is a zip of ``manifest.json`` and, for each platform it was
exported for (``cuda``, ``cpu``), two ``torch.export`` programs (``.pt2``)
with the weights baked in:

  * ``eps_<platform>.pt2``: the UNet's ε forward ``(x, t, labels, cond_mask)
    → ε`` at the one batch the chain calls it with (2·num_labels with
    classifier-free guidance, num_labels without), every shape static;
  * ``decode_<platform>.pt2``: the chain's output → uint8 images (clamp,
    codebook quantize and VQ decode in latent mode, then ``to_uint8``).

:class:`ExportedSampler` runs the sampler of the manifest
(``diffusion/ddpm.py``) with the loaded ε program as its model, the schedule
rebuilt from the manifest and a ``torch.Generator`` seeded with the call's
seed on the artifact's device: ``sampler(seed, labels) → uint8 images``,
equal to ``DiffusionTask.sample`` with a generator seeded the same
(``sample_latents`` and ``decode`` are its two halves). A chain
of any length (the 999-step DDPM too) is one small program called per step,
and its per-step noise is drawn as the eager chain draws it. Loading imports
no model code: ``ops/attention.py`` registers the operator
``spectrogramgenai_tpu_torch::attention_fwd`` that the ε program calls at
each fused attention site, so on the card it launches the same kernel as
eager serving.

The manifest carries every key of the JAX package's manifest, plus what the
runtime needs (``format``, the schedule's betas, the sample shape, the
compute dtype). The JAX package's StableHLO artifacts are not read here.
"""

from __future__ import annotations

import copy
import io
import json
import warnings
import zipfile

import numpy as np
import torch

# registers spectrogramgenai_tpu_torch::attention_fwd, which the ε programs call
import spectrogramgenai_tpu_torch.ops.attention  # noqa: F401
from spectrogramgenai_tpu_torch.diffusion.ddpm import (
    DiffusionSchedule,
    ddim_sample,
    ddpm_sample,
    dpmpp_sample,
    to_uint8,
)

_MANIFEST = "manifest.json"
FORMAT = "torch.export"
FORMAT_VERSION = 1
PLATFORMS = ("cuda", "cpu")


class _Decode(torch.nn.Module):
    """Chain output (n, S, S, C) float32 → uint8 images (n, H, W, 1), as ``DiffusionTask.decode``."""

    def __init__(self, vqvae: torch.nn.Module | None):
        super().__init__()
        self.vqvae = vqvae

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.vqvae is not None:
            x = self.vqvae.decode_quantized(torch.clamp(x, -1.0, 1.0))
        return to_uint8(x)


def _export(module: torch.nn.Module, args: tuple) -> bytes:
    with torch.no_grad():  # not inference mode: its tensors cannot be traced into a program
        program = torch.export.export(module, args, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_sampler(task, *, num_labels: int, use_ema: bool = False, sampler: str = "ddpm",
                   num_steps: int = 50, cfg_scale: float | None = None,
                   platforms: list[str] | None = None) -> bytes:
    """Serialize ``task``'s sampler (its weights baked in) to artifact bytes.

    ``num_labels`` fixes the label batch (requests pad into it, as serving
    does). ``use_ema`` records in the manifest whether the task holds the
    EMA weights (``cli.common.load_task`` loads them so). ``platforms``
    (``cuda``, ``cpu``) defaults to the device the task runs on; a
    platform's programs are traced from a copy of the model on it.
    """
    if sampler not in ("ddpm", "ddim", "dpmpp"):
        raise ValueError(f"unknown sampler {sampler!r}")
    cfg = task.cfg
    cfg_scale = cfg.cfg_scale if cfg_scale is None else cfg_scale
    platforms = list(platforms or [task.device.type])
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f"unknown platform {p!r} (one of {PLATFORMS})")
    shape = (task.sample_size, task.sample_size, task.channels)
    rows = 2 * num_labels if cfg_scale > 0 else num_labels
    payload = {}
    for p in platforms:
        dev = torch.device(p)
        same = task.device.type == p
        model = task.model if same else copy.deepcopy(task.model).to(dev)
        vqvae = task.vqvae if same or task.vqvae is None else copy.deepcopy(task.vqvae).to(dev)
        eps_args = (torch.zeros(rows, *shape, device=dev), torch.zeros(rows, device=dev),
                    torch.zeros(rows, dtype=torch.long, device=dev), torch.ones(rows, device=dev))
        payload[f"eps_{p}.pt2"] = _export(model, eps_args)
        payload[f"decode_{p}.pt2"] = _export(_Decode(vqvae), (torch.zeros(num_labels, *shape, device=dev),))

    manifest = {
        "format_version": FORMAT_VERSION,
        "platforms": platforms,
        "num_labels": num_labels,
        "sampler": sampler,
        "num_steps": num_steps,
        "cfg_scale": cfg_scale,
        "use_ema": use_ema,
        "img_size": cfg.img_size,
        "latent": cfg.latent,
        "num_classes": cfg.num_classes,
        "noise_steps": task.schedule.noise_steps,
        "format": FORMAT,
        "beta_start": task.schedule.beta_start,
        "beta_end": task.schedule.beta_end,
        "sample_shape": list(shape),
        "compute_dtype": cfg.compute_dtype,
    }
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr(_MANIFEST, json.dumps(manifest, indent=2), compress_type=zipfile.ZIP_DEFLATED)
        for name, blob in payload.items():  # the weights do not compress
            z.writestr(name, blob, compress_type=zipfile.ZIP_STORED)
    return buf.getvalue()


class ExportedSampler:
    """A loaded artifact: ``sampler(seed, labels) → uint8 images`` on ``device``.

    ``device`` defaults to the card and raises without one; pass ``"cpu"``
    for the CPU. The artifact must hold programs for that device's platform:
    a program is never moved between devices.
    """

    def __init__(self, blob: bytes, device: torch.device | str | None = None):
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            self.manifest = json.loads(z.read(_MANIFEST))
            fmt = self.manifest.get("format")
            if fmt != FORMAT:
                what = "a StableHLO artifact of the JAX package" if fmt is None else f"format {fmt!r}"
                raise ValueError(f"artifact is {what}; this runtime reads {FORMAT!r} artifacts "
                                 "(export it with spectrogramgenai_tpu_torch.cli.export_model)")
            if self.manifest["format_version"] > FORMAT_VERSION:
                raise ValueError(f"artifact format {self.manifest['format_version']} is newer "
                                 f"than this runtime ({FORMAT_VERSION})")
            self.device = torch.device("cuda" if device is None else device)
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available (pass device='cpu' to run the artifact on the CPU)")
            platform = self.device.type
            if platform not in self.manifest["platforms"]:
                raise ValueError(f"artifact has no program for {platform!r} "
                                 f"(exported for {self.manifest['platforms']})")
            self._eps = self._load(z, f"eps_{platform}.pt2")
            self._decode = self._load(z, f"decode_{platform}.pt2")
        m = self.manifest
        self.schedule = DiffusionSchedule(m["noise_steps"], m["beta_start"], m["beta_end"])

    @staticmethod
    def _load(z: zipfile.ZipFile, name: str):
        with warnings.catch_warnings():  # the weights are read from the zip's bytes and never written
            warnings.filterwarnings("ignore", message="The given buffer is not writable")
            return torch.export.load(io.BytesIO(z.read(name))).module()

    @property
    def num_labels(self) -> int:
        return self.manifest["num_labels"]

    @torch.inference_mode()
    def sample_latents(self, seed: int, labels: np.ndarray, *, x_T: torch.Tensor | None = None,
                       noise: torch.Tensor | None = None) -> torch.Tensor:
        """The reverse chain alone, as ``DiffusionTask.sample_latents``:
        (num_labels, S, S, C) float32 on the device, before any clamp. The
        chain's generator is seeded with ``seed``; ``x_T`` (the starting
        noise) and ``noise`` (the ddpm chain's per-step noise) are for tests,
        as in ``diffusion/ddpm.py``. Labels must have exactly num_labels
        entries."""
        labels = np.asarray(labels)
        if labels.shape != (self.num_labels,):
            raise ValueError(f"artifact compiled for {self.num_labels} labels, got shape {labels.shape}")
        m = self.manifest
        if noise is not None and m["sampler"] != "ddpm":
            raise ValueError(f"per-step noise is for the ddpm chain; this artifact runs {m['sampler']!r}")
        y = torch.as_tensor(labels, dtype=torch.long, device=self.device)
        kw = dict(generator=torch.Generator(device=self.device).manual_seed(int(seed)), x_T=x_T,
                  cfg_scale=m["cfg_scale"])
        shape = tuple(m["sample_shape"])
        if m["sampler"] == "ddim":
            return ddim_sample(self._eps, self.schedule, y, shape, num_steps=m["num_steps"], **kw)
        if m["sampler"] == "dpmpp":
            return dpmpp_sample(self._eps, self.schedule, y, shape, num_steps=m["num_steps"], **kw)
        return ddpm_sample(self._eps, self.schedule, y, shape, noise=noise, **kw)

    @torch.inference_mode()
    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """Chain output → uint8 images (num_labels, H, W, 1) on the device, as ``DiffusionTask.decode``."""
        return self._decode(x)

    def __call__(self, seed: int, labels: np.ndarray, *, x_T: torch.Tensor | None = None,
                 noise: torch.Tensor | None = None) -> np.ndarray:
        """(num_labels, H, W, 1) uint8 images from a chain seeded with ``seed``."""
        return self.decode(self.sample_latents(seed, labels, x_T=x_T, noise=noise)).cpu().numpy()


def save_artifact(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def load_artifact(path: str, device: torch.device | str | None = None) -> ExportedSampler:
    with open(path, "rb") as f:
        return ExportedSampler(f.read(), device=device)
