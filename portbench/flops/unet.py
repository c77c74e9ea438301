"""Operations of the latent DDPM's UNet, counted from the configuration's
widths (the matrix products: convolutions, dense layers, the attention
products, the ×2 upsample as two matrix products, the label lookup left
out; norms and pointwise work are not counted)."""

from __future__ import annotations


def _w(cfg: dict, c: int) -> int:
    return max(8, int(c * cfg.get("width_mult", 1.0)))


def _conv(cin, cout, k, hw):
    return 2.0 * cin * cout * k * k * hw


def _double_conv(cin, cout, mid, hw):
    return _conv(cin, mid, 3, hw) + _conv(mid, cout, 3, hw)


def _attention(c, n, heads=4):
    """Four dense layers for q, k, v and out, two of the MLP, and QKᵀ and PV."""
    return 6 * 2.0 * c * c * n + 4.0 * n * n * c


def sites(cfg: dict, size: int) -> list[tuple[str, int, int]]:
    """(name, channels, tokens) of the six self-attention sites at a ``size`` input."""
    w = lambda c: _w(cfg, c)  # noqa: E731
    return [("sa_0", w(128), (size // 2) ** 2), ("sa_1", w(256), (size // 4) ** 2), ("sa_2", w(256), (size // 8) ** 2),
            ("sa_3", w(128), (size // 4) ** 2), ("sa_4", w(64), (size // 2) ** 2), ("sa_5", w(64), size ** 2)]


def forward(cfg: dict, size: int) -> float:
    """FLOPs of one row's forward at a (size, size, latent_dim) input."""
    w = lambda c: _w(cfg, c)  # noqa: E731
    c_in, td = cfg["latent_dim"], cfg["time_dim"]
    hw = size * size
    f = _double_conv(c_in, w(64), w(64), hw)
    for cin, cout, r in ((w(64), w(128), 2), (w(128), w(256), 4), (w(256), w(256), 8)):
        f += _double_conv(cin, cin, cin, hw // r ** 2) + _double_conv(cin, cout, cout, hw // r ** 2)
        f += 2.0 * td * cout
    deep = ([(w(256), w(256))] * 2 if cfg.get("remove_deep_conv") else
            [(w(256), w(512)), (w(512), w(512)), (w(512), w(256))])
    for cin, cout in deep:
        f += _double_conv(cin, cout, cout, hw // 64)
    for cin, cout, r, below, ch in ((w(512), w(128), 4, 8, w(256)), (w(256), w(64), 2, 4, w(128)),
                                    (w(128), w(64), 1, 2, w(64))):
        h_in = size // below
        h_out = size // r
        f += 2.0 * h_out * h_in * ch * h_in + 2.0 * h_out * h_in * ch * h_out  # upsample rows, then columns
        f += _double_conv(cin, cin, cin, h_out ** 2) + _double_conv(cin, cout, cin // 2, h_out ** 2)
        f += 2.0 * td * cout
    f += sum(_attention(c, n) for _, c, n in sites(cfg, size))
    return f + _conv(w(64), c_in, 1, hw)
