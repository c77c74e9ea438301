"""Plain PyTorch reference of the latent-DDPM UNet and the VQ-VAE.

Written from the published architecture (gibbona1/SpectrogramGenAI
``src/diff_modules.py``: ``UNet_conditional``, ``VQVAE``; arXiv 2412.01530)
with the flax conventions the port states: GELU is the tanh approximation,
GroupNorm has one group and LayerNorm and GroupNorm use eps 1e-6, the
bilinear ×2 upsample aligns corners. It imports no module of the system
under test: the parameters are a plain dict of tensors keyed by the names
that :func:`unet_leaves` and :func:`vqvae_leaves` list, which the benchmark
fills from its seed and hands to both sides.

Every function computes in float32. With ``prec="fp8"`` each input and each
weight of a convolution, dense layer and attention product is rounded to
float8 e4m3 with a per-tensor scale first (the control of the comparison).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

F8_MAX = 448.0  # the largest finite float8 e4m3fn


def rounded(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` (float32) rounded to ``prec`` and back: "fp32" is the identity.
    Under autograd the rounding passes the gradient straight through."""
    if prec == "fp32":
        return x
    if prec != "fp8":
        raise ValueError(f"unknown precision {prec!r}")
    with torch.no_grad():
        scale = x.abs().amax().clamp_min(1e-30) / F8_MAX
        r = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (r - x).detach() if x.requires_grad else r


# ---------------------------------------------------------------------------
# Parameter lists: (name, shape, init) with init one of
# ("normal", std), ("zeros",), ("ones",), ("uniform", low, high).
# ---------------------------------------------------------------------------

def _conv(name, cin, cout, k, bias, out):
    out.append((f"{name}.weight", (cout, cin, k, k), ("normal", 1.0 / math.sqrt(cin * k * k))))
    if bias:
        out.append((f"{name}.bias", (cout,), ("zeros",)))


def _dense(name, cin, cout, out):
    out.append((f"{name}.weight", (cout, cin), ("normal", 1.0 / math.sqrt(cin))))
    out.append((f"{name}.bias", (cout,), ("zeros",)))


def _norm(name, c, out):
    out.append((f"{name}.weight", (c,), ("ones",)))
    out.append((f"{name}.bias", (c,), ("zeros",)))


def _double_conv(name, cin, cout, mid, out):
    _conv(f"{name}.Conv_0", cin, mid, 3, False, out)
    _norm(f"{name}.GroupNorm_0", mid, out)
    _conv(f"{name}.Conv_1", mid, cout, 3, False, out)
    _norm(f"{name}.GroupNorm_1", cout, out)


def unet_widths(cfg: dict) -> dict[str, int]:
    def w(c):
        return max(8, int(c * cfg.get("width_mult", 1.0)))
    return {c: w(c) for c in (64, 128, 256, 512)}


def unet_leaves(cfg: dict) -> list[tuple[str, tuple[int, ...], tuple]]:
    """The UNet's parameters for a config (``latent_dim`` channels in and out)."""
    w, td, out = unet_widths(cfg), cfg["time_dim"], []
    c = cfg["latent_dim"] if cfg.get("latent", True) else cfg["c_in"]
    _double_conv("DoubleConv_0", c, w[64], w[64], out)
    for name, cin, cout, sa in (("Down_0", w[64], w[128], "sa_0"), ("Down_1", w[128], w[256], "sa_1"),
                                ("Down_2", w[256], w[256], "sa_2")):
        _double_conv(f"{name}.DoubleConv_0", cin, cin, cin, out)
        _double_conv(f"{name}.DoubleConv_1", cin, cout, cout, out)
        _dense(f"{name}.TimeEmbedProject_0.Dense_0", td, cout, out)
        _attention_leaves(sa, cout, out)
    deep = _deep(cfg, w)
    for i, (cin, cout) in enumerate(deep, start=1):
        _double_conv(f"DoubleConv_{i}", cin, cout, cout, out)
    for name, cin, cout, sa in (("Up_0", w[512], w[128], "sa_3"), ("Up_1", w[256], w[64], "sa_4"),
                                ("Up_2", w[128], w[64], "sa_5")):
        _double_conv(f"{name}.DoubleConv_0", cin, cin, cin, out)
        _double_conv(f"{name}.DoubleConv_1", cin, cout, cin // 2, out)
        _dense(f"{name}.TimeEmbedProject_0.Dense_0", td, cout, out)
        _attention_leaves(sa, cout, out)
    _conv("outc", w[64], c, 1, True, out)
    out.append(("label_emb.weight", (cfg["num_classes"], td), ("normal", 1.0 / math.sqrt(td))))
    return out


def _deep(cfg, w):
    if cfg.get("remove_deep_conv", False):
        return [(w[256], w[256]), (w[256], w[256])]
    return [(w[256], w[512]), (w[512], w[512]), (w[512], w[256])]


def _attention_leaves(name, c, out):
    _norm(f"{name}.LayerNorm_0", c, out)
    for part in ("query", "key", "value", "out"):
        _dense(f"{name}.{part}", c, c, out)
    _norm(f"{name}.LayerNorm_1", c, out)
    _dense(f"{name}.Dense_0", c, c, out)
    _dense(f"{name}.Dense_1", c, c, out)


def vqvae_leaves(hidden: int, latent: int, codes: int, code_range: float | None = None):
    """The VQ-VAE's parameters and codebook buffers. The codebook is drawn
    U(-r, r) with r = 1/codes (the published init) or ``code_range``."""
    out = []
    for name, cin, cout, k in (("encoder.Conv_0", 1, hidden, 4), ("encoder.Conv_1", hidden, hidden, 4),
                               ("encoder.Conv_2", hidden, hidden, 3), ("encoder.Conv_3", hidden, hidden, 1),
                               ("encoder.Conv_4", hidden, latent, 1), ("decoder.Conv_0", latent, hidden, 1),
                               ("decoder.Conv_1", hidden, hidden, 1), ("decoder.Conv_2", hidden, hidden, 3)):
        _conv(name, cin, cout, k, True, out)
    for name, cin, cout in (("decoder.ConvTranspose_0", hidden, hidden), ("decoder.ConvTranspose_1", hidden, 1)):
        out.append((f"{name}.weight", (cin, cout, 2, 2), ("normal", 1.0 / math.sqrt(cin * 4))))
        out.append((f"{name}.bias", (cout,), ("zeros",)))
    r = 1.0 / codes if code_range is None else code_range
    out.append(("codebook.embedding", (codes, latent), ("uniform", -r, r)))
    out.append(("codebook.ema_count", (codes,), ("zeros",)))
    out.append(("codebook.ema_weight", (codes, latent), ("same", "codebook.embedding")))
    return out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def conv(x, w, b=None, stride=1, padding=0, prec="fp32"):
    return F.conv2d(rounded(x, prec), rounded(w, prec), b, stride=stride, padding=padding)


def dense(x, P, name, prec="fp32"):
    return rounded(x, prec) @ rounded(P[f"{name}.weight"], prec).T + P[f"{name}.bias"]


def gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def group_norm(x, P, name, eps=1e-6):
    """One group over (C, H, W) of each sample."""
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    return y * P[f"{name}.weight"][None, :, None, None] + P[f"{name}.bias"][None, :, None, None]


def layer_norm(x, P, name, eps=1e-6):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * P[f"{name}.weight"] + P[f"{name}.bias"]


def double_conv(x, P, name, residual=False, prec="fp32"):
    y = gelu(group_norm(conv(x, P[f"{name}.Conv_0.weight"], padding=1, prec=prec), P, f"{name}.GroupNorm_0"))
    y = group_norm(conv(y, P[f"{name}.Conv_1.weight"], padding=1, prec=prec), P, f"{name}.GroupNorm_1")
    return gelu(x + y) if residual else y


def _attention_block(q, k, v, prec):
    s = rounded(q, prec) @ rounded(k, prec).transpose(-1, -2) / math.sqrt(q.shape[-1])
    return rounded(torch.softmax(s, dim=-1), prec) @ rounded(v, prec)


def attention(q, k, v, prec="fp32", block_elems=2 ** 28):
    """softmax(q·kᵀ/√d)·v over (B, H, N, D), a few rows of B at a time so
    that the (N, N) scores stay under ``block_elems`` elements; under
    autograd each block is recomputed in the backward instead of kept."""
    b, h, n, d = q.shape
    rows = max(1, block_elems // (h * n * n))
    out = []
    for i in range(0, b, rows):
        blk = (q[i:i + rows], k[i:i + rows], v[i:i + rows])
        if torch.is_grad_enabled() and q.requires_grad:
            out.append(torch.utils.checkpoint.checkpoint(_attention_block, *blk, prec, use_reentrant=False))
        else:
            out.append(_attention_block(*blk, prec))
    return torch.cat(out)


def self_attention(x, P, name, heads=4, prec="fp32"):
    b, c, hh, ww = x.shape
    n, hd = hh * ww, c // heads
    tok = x.flatten(2).transpose(1, 2)
    ln = layer_norm(tok, P, f"{name}.LayerNorm_0")
    q, k, v = (dense(ln, P, f"{name}.{part}", prec).view(b, n, heads, hd).transpose(1, 2)
               for part in ("query", "key", "value"))
    ctx = attention(q, k, v, prec).transpose(1, 2).reshape(b, n, c)
    tok = tok + dense(ctx, P, f"{name}.out", prec)
    tok = tok + dense(gelu(dense(layer_norm(tok, P, f"{name}.LayerNorm_1"), P, f"{name}.Dense_0", prec)),
                      P, f"{name}.Dense_1", prec)
    return tok.transpose(1, 2).reshape(b, c, hh, ww)


def time_embedding(t, channels):
    half = channels // 2
    freq = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float64, device=t.device) * 2.0 / channels))
    ang = t.double()[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


def unet(P, cfg, x, t, y, cond_mask, prec="fp32"):
    """ε prediction: x (B, H, W, C) float32, t (B,) float, y (B,) int64 labels,
    cond_mask (B,) 0/1 (0: the label embedding is left out) → (B, H, W, C)."""
    temb = time_embedding(t, cfg["time_dim"]) + P["label_emb.weight"][y] * cond_mask.float()[:, None]
    silu_t = F.silu(temb)

    def proj(h, name):
        return h + dense(silu_t, P, f"{name}.TimeEmbedProject_0.Dense_0", prec)[:, :, None, None]

    def down(h, name):
        h = F.max_pool2d(h, 2)
        h = double_conv(double_conv(h, P, f"{name}.DoubleConv_0", True, prec), P, f"{name}.DoubleConv_1",
                        prec=prec)
        return proj(h, name)

    def up(h, skip, name):
        h = torch.cat([skip, F.interpolate(h, scale_factor=2, mode="bilinear", align_corners=True)], dim=1)
        h = double_conv(double_conv(h, P, f"{name}.DoubleConv_0", True, prec), P, f"{name}.DoubleConv_1",
                        prec=prec)
        return proj(h, name)

    h = x.float().permute(0, 3, 1, 2)
    x1 = double_conv(h, P, "DoubleConv_0", prec=prec)
    x2 = self_attention(down(x1, "Down_0"), P, "sa_0", prec=prec)
    x3 = self_attention(down(x2, "Down_1"), P, "sa_1", prec=prec)
    x4 = self_attention(down(x3, "Down_2"), P, "sa_2", prec=prec)
    for i in range(1, len(_deep(cfg, unet_widths(cfg))) + 1):
        x4 = double_conv(x4, P, f"DoubleConv_{i}", prec=prec)
    h = self_attention(up(x4, x3, "Up_0"), P, "sa_3", prec=prec)
    h = self_attention(up(h, x2, "Up_1"), P, "sa_4", prec=prec)
    h = self_attention(up(h, x1, "Up_2"), P, "sa_5", prec=prec)
    return conv(h, P["outc.weight"], P["outc.bias"], prec=prec).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# VQ-VAE
# ---------------------------------------------------------------------------

def vq_encode(P, x, prec="fp32"):
    """NHWC image in [-1, 1] → NHWC float32 latent (unquantised)."""
    h = x.float().permute(0, 3, 1, 2)
    h = conv(h, P["encoder.Conv_0.weight"], P["encoder.Conv_0.bias"], stride=2, padding=1, prec=prec)
    h = F.relu(conv(h, P["encoder.Conv_1.weight"], P["encoder.Conv_1.bias"], stride=2, padding=1, prec=prec))
    h = F.relu(conv(h, P["encoder.Conv_2.weight"], P["encoder.Conv_2.bias"], padding=1, prec=prec) + h)
    h = conv(h, P["encoder.Conv_3.weight"], P["encoder.Conv_3.bias"], prec=prec) + h
    return conv(h, P["encoder.Conv_4.weight"], P["encoder.Conv_4.bias"], prec=prec).permute(0, 2, 3, 1)


def vq_decode(P, z, prec="fp32"):
    """NHWC latent → NHWC float32 image."""
    h = conv(z.permute(0, 3, 1, 2), P["decoder.Conv_0.weight"], P["decoder.Conv_0.bias"], prec=prec)
    h = F.relu(conv(h, P["decoder.Conv_1.weight"], P["decoder.Conv_1.bias"], prec=prec) + h)
    h = F.relu(conv(h, P["decoder.Conv_2.weight"], P["decoder.Conv_2.bias"], padding=1, prec=prec) + h)
    for name in ("decoder.ConvTranspose_0", "decoder.ConvTranspose_1"):
        h = F.conv_transpose2d(rounded(h, prec), rounded(P[f"{name}.weight"], prec), P[f"{name}.bias"], stride=2)
    return h.permute(0, 2, 3, 1)


def nearest_code(z_flat, embedding):
    """Index of the nearest codebook entry by squared euclidean distance (float64)."""
    e = embedding.double()
    z = z_flat.double()
    d2 = z.square().sum(1, keepdim=True) - 2.0 * z @ e.T + e.square().sum(1)[None, :]
    return torch.argmin(d2, dim=1)


def renorm(x):
    """Per-sample min/max rescale of a [0, 1] image batch to [-1, 1]."""
    dims = tuple(range(1, x.dim()))
    lo, hi = x.amin(dim=dims, keepdim=True), x.amax(dim=dims, keepdim=True)
    return 2.0 * ((x - lo) / (hi - lo) - 0.5)
