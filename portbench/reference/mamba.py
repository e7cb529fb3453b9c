"""The Mamba (S6) mixer: RMSNorm, in-projection, depthwise causal
convolution, the selective scan in float32, the gate and the
out-projection."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.ops import mm, rms


def _dims(spec):
    m = spec["mamba"]
    return m["expand"] * spec["d_model"], m["d_state"], m["d_conv"], \
        m["dt_rank"]


def _inputs(p, xa, spec, prec):
    d_in, N, _, R = _dims(spec)
    dbc = mm(xa, p["mix.x_proj"], prec)
    dt_in, Bc, Cc = torch.split(dbc, [R, N, N], dim=-1)
    dt = F.softplus(mm(dt_in, p["mix.dt_w"], prec) + p["mix.dt_bias"].float())
    return dt, Bc, Cc


CHUNK = 64  # positions a chunk of the scan


def scan(dt, u, A, Bc, Cc, chunk: int = CHUNK):
    """h_t = exp(dt_t A) h_{t-1} + u_t B_t and y_t = h_t . C_t from h_0 = 0,
    in float32: dt, u [B, S, d_in], A [d_in, N], Bc, Cc [B, S, N] ->
    (y [B, S, d_in], h_S [B, d_in, N]). The sequence is cut into chunks of
    ``chunk`` positions (the last padded with dt = u = 0, which keeps h):
    each chunk's end from a zero start, at once for all chunks; then the
    start of each chunk, one after the other, through the chunk's decay
    exp(A sum dt); then every chunk again step by step from its start."""
    Bsz, S, d_in = dt.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def cut(t):
        t = F.pad(t, (0, 0, 0, pad))
        return t.view(Bsz, nc, chunk, t.shape[-1])

    dt, u, Bc, Cc = cut(dt), cut(u), cut(Bc), cut(Cc)

    def run(h, y=None):
        for t in range(chunk):
            h = torch.exp(dt[:, :, t, :, None] * A) * h \
                + u[:, :, t, :, None] * Bc[:, :, t, None, :]
            if y is not None:
                y[:, :, t] = (h * Cc[:, :, t, None, :]).sum(-1)
        return h

    end = run(dt.new_zeros(Bsz, nc, d_in, A.shape[-1]))
    decay = torch.exp(dt.sum(2)[..., None] * A)
    start = torch.zeros_like(end)
    for c in range(1, nc):
        start[:, c] = decay[:, c - 1] * start[:, c - 1] + end[:, c - 1]
    y = dt.new_empty(Bsz, nc, chunk, d_in)
    h = run(start, y)
    return y.view(Bsz, nc * chunk, d_in)[:, :S], h[:, -1]


def seq(p, x, spec, prec):
    """x [B, S, D] -> (y, {"conv": the last d_conv - 1 inputs of the
    convolution [B, d_conv - 1, d_in], "ssm": the last state [B, d_in,
    N]})."""
    B, S, _ = x.shape
    d_in, N, d_conv, _ = _dims(spec)
    h = rms(x, p["mix.ln"], spec["norm_eps"])
    xz = mm(h, p["mix.in_proj"], prec)
    xp, z = xz[..., :d_in], xz[..., d_in:]
    w = p["mix.conv_w"].float()
    xpad = torch.cat([xp.new_zeros(B, d_conv - 1, d_in), xp], dim=1)
    xc = sum(xpad[:, i:i + S] * w[i] for i in range(d_conv))
    xa = F.silu(xc)
    dt, Bc, Cc = _inputs(p, xa, spec, prec)
    A = -torch.exp(p["mix.a_log"].float())
    ys, hs = scan(dt, dt * xa, A, Bc, Cc)
    y = (ys + xa * p["mix.d_skip"].float()) * F.silu(z)
    return mm(y, p["mix.out_proj"], prec), \
        {"conv": xpad[:, S:], "ssm": hs}

