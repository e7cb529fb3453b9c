"""Plain PyTorch version of the fused closed-loop kernel; port of
`repro.kernels.closed_loop.ref`.

It is the CPU path of `ops.closed_loop_sim` and the version the CUDA
kernel (`csrc/closed_loop.cu`) is held against on the card. It
transcribes the static-plant, fixed-gain-PI closed loop: plant dynamics
(Eq. 3 + heteroscedastic noise + exogenous drops), heartbeat synthesis
and the Eq. 1 window median, the Eq. 4 PI update with anti-windup
clamping, early-exit-by-mask freezing, and the online summary reductions
(count/moments/histograms). Every arithmetic op appears in the order of
the reference's `step`, line for line.

Randomness is an input: a ``(T, 5, B)`` tensor of unit normals and
uniforms per run — channels: progress noise z, power noise z, drop
enter u, drop exit u, heartbeat z (see `ops.draw_noise`). Heartbeat
counts are rounded Gaussians (`heartbeat_count`), the kernel path's
stand-in for a Poisson draw.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.plant import PROFILE_FIELDS
from repro_torch.core.plane import GAIN_FIELDS

# Column indices into the packed rows (shared with the CUDA source).
F = {name: i for i, name in enumerate(PROFILE_FIELDS)}
G = {name: i for i, name in enumerate(GAIN_FIELDS)}

# Noise channels (axis 1 of the (T, 5, B) noise tensor).
NZ_PROG, NZ_POW, NU_ENTER, NU_EXIT, NZ_HB = range(5)
N_NOISE = 5

# Online-summary histogram resolution.
PROG_BINS = 64
CAP_BINS = 32
PROG_HIST_SPAN = 1.5

TRACE_KEYS = ("t", "progress", "pcap", "power", "energy", "work", "valid")


def heartbeat_count(lam, z):
    """Heartbeat count from a unit normal: round(lam + sqrt(lam) z),
    floored at 0 — the kernel path's Poisson stand-in (matches mean and
    variance; exact for lam = 0)."""
    return torch.clamp(torch.floor(lam + torch.sqrt(lam) * z + 0.5),
                       min=0.0)


def window_median(n, anchor_gap, has_anchor, dt):
    """Closed-form Eq. 1 median for n evenly spaced beats in one period
    (count already float). The window's rate multiset is {rate_first}
    + (n-1) x {n/dt}, the first interval reaching back `anchor_gap`
    before the window; with no anchor it is (n-1) x {n/dt}."""
    nf = torch.clamp(n, min=1.0)
    r = n / dt
    first_int = anchor_gap + 0.5 * dt / nf
    r_first = 1.0 / torch.clamp(first_int, min=1e-9)
    zero = torch.zeros_like(r)
    with_anchor = torch.where(n >= 3, r,
                              torch.where(n == 2, 0.5 * (r + r_first),
                                          torch.where(n == 1, r_first,
                                                      zero)))
    no_anchor = torch.where(n >= 2, r, zero)
    return torch.where(has_anchor, with_anchor, no_anchor)


def hist_index(x, lo, hi, nbins):
    """Bin index of x in [lo, hi) split into nbins (truncate, then clip)."""
    return torch.clamp(((x - lo) / (hi - lo) * nbins).to(torch.int32),
                       0, nbins - 1)


def init_state(prof, gains) -> Dict[str, torch.Tensor]:
    """Fresh per-run carry from packed (B, 14) profile and (B, 9) gain
    rows, as a dict of (B,) tensors plus the two (B, BINS) histograms."""
    B = prof.shape[0]
    z = torch.zeros((B,), dtype=torch.float32, device=prof.device)
    pcap0 = prof[:, F["pcap_max"]]
    # plant_init: progress_l0 = K_L * pcap_linearize(pcap_max)
    pl0 = -torch.exp(-prof[:, F["alpha"]]
                     * (prof[:, F["a"]] * pcap0 + prof[:, F["b"]]
                        - prof[:, F["beta"]]))
    # pi_init: prev_pcap_l anchored at the GAIN transform's pcap_max
    gl0 = -torch.exp(-gains[:, G["alpha"]]
                     * (gains[:, G["a"]] * gains[:, G["pcap_max"]]
                        + gains[:, G["b"]] - gains[:, G["beta"]]))
    return {
        "progress_l": prof[:, F["K_L"]] * pl0,
        "dropped": z,
        "energy": z,
        "work": z,
        "prev_error": z,
        "prev_pcap_l": gl0,
        "pcap": pcap0,
        "anchor_gap": z,
        "has_anchor": z,
        "t": z,
        "steps": z,
        "done": z,
        "count": z,
        "progress_sum": z,
        "progress_sq_sum": z,
        "power_sum": z,
        "progress_hist": torch.zeros((B, PROG_BINS), dtype=torch.float32,
                                     device=prof.device),
        "pcap_hist": torch.zeros((B, CAP_BINS), dtype=torch.float32,
                                 device=prof.device),
    }


def _hist_add(hist, idx, acc):
    """hist + acc * one_hot(idx): acc added to each run's own bin."""
    return hist.scatter_add(1, idx.to(torch.int64)[:, None], acc[:, None])


def step(prof, gains, c, noise_s, total_work, max_time, dt, summary_from):
    """One fused control period over a batch of runs. ``noise_s`` is this
    step's (5, B) noise slab; the scalars are 0-dim float32 tensors.
    Returns (new_carry, trace_row) with (B,) leaves."""
    p = lambda name: prof[:, F[name]]
    g = lambda name: gains[:, G[name]]
    z_prog, z_pow, u_enter, u_exit, z_hb = (noise_s[i] for i in
                                            range(N_NOISE))
    done = c["done"]
    live = 1.0 - done
    stopped = done > 0

    # ---- plant_step (Eq. 3 + noise + drops) -------------------------------
    pcap_app = torch.clamp(c["pcap"], p("pcap_min"), p("pcap_max"))
    pl = -torch.exp(-p("alpha") * (p("a") * pcap_app + p("b") - p("beta")))
    w = dt / (dt + p("tau"))
    new_pl = p("K_L") * w * pl + (1.0 - w) * c["progress_l"]
    enter = (u_enter < p("drop_prob")).to(torch.float32)
    exit_ = (u_exit < p("drop_exit_prob")).to(torch.float32)
    dropped = torch.where(c["dropped"] > 0, 1.0 - exit_, enter)
    clean = new_pl + p("K_L")
    meas_noise = (p("noise_scale") * torch.sqrt(p("n_sockets")) * z_prog)
    progress_m = torch.clamp(
        torch.where(dropped > 0, p("drop_level"), clean) + meas_noise,
        min=0.0)
    power_true = p("a") * pcap_app + p("b")
    power_m = power_true + p("power_noise") * z_pow
    energy = c["energy"] + power_true * dt
    work = c["work"] + progress_m * dt
    t = c["t"] + dt

    # ---- heartbeat synthesis + Eq. 1 window median ------------------------
    n = heartbeat_count(torch.clamp(progress_m, min=0.0) * dt, z_hb)
    progress = window_median(n, c["anchor_gap"], c["has_anchor"] > 0, dt)
    anchor_gap = torch.where(n > 0, 0.5 * dt / torch.clamp(n, min=1.0),
                             c["anchor_gap"] + dt)
    has_anchor = torch.maximum(c["has_anchor"], (n > 0).to(torch.float32))

    # ---- Eq. 4 PI with anti-windup clamp ----------------------------------
    error = g("setpoint") - progress
    pcap_l = ((g("k_i") * dt + g("k_p")) * error
              - g("k_p") * c["prev_error"] + c["prev_pcap_l"])
    glin = lambda cap: -torch.exp(-g("alpha") * (g("a") * cap + g("b")
                                                 - g("beta")))
    lo_l, hi_l = glin(g("pcap_min")), glin(g("pcap_max"))
    # Eq. 2 image is negative and increasing in pcap: lo_l < hi_l
    pcap_l = torch.clamp(pcap_l, lo_l, hi_l)
    power_cmd = g("beta") - torch.log(-pcap_l) / g("alpha")
    pcap_cmd = (power_cmd - g("b")) / g("a")

    # ---- early-exit-by-mask freeze ----------------------------------------
    frz = lambda new, old: torch.where(stopped, old, new)
    new_pl = frz(new_pl, c["progress_l"])
    dropped = frz(dropped, c["dropped"])
    energy = frz(energy, c["energy"])
    work = frz(work, c["work"])
    prev_error = frz(error, c["prev_error"])
    prev_pcap_l = frz(pcap_l, c["prev_pcap_l"])
    pcap_cmd = frz(pcap_cmd, c["pcap"])
    anchor_gap = frz(anchor_gap, c["anchor_gap"])
    has_anchor = frz(has_anchor, c["has_anchor"])
    t = frz(t, c["t"])
    zero = torch.zeros_like(progress)
    progress = torch.where(stopped, zero, progress)
    power_out = torch.where(stopped, zero, power_m)

    # ---- online summary reductions ----------------------------------------
    acc = live * (c["steps"] >= summary_from).to(torch.float32)
    pidx = hist_index(progress, 0.0, PROG_HIST_SPAN * p("K_L"), PROG_BINS)
    cidx = hist_index(pcap_cmd, p("pcap_min"), p("pcap_max"), CAP_BINS)
    prog_hist = _hist_add(c["progress_hist"], pidx, acc)
    pcap_hist = _hist_add(c["pcap_hist"], cidx, acc)

    new_done = torch.maximum(done, torch.maximum(
        (work >= total_work).to(torch.float32),
        (t >= max_time - 1e-6).to(torch.float32)))
    out = {"t": t, "progress": progress, "pcap": pcap_cmd,
           "power": power_out, "energy": energy, "work": work,
           "valid": live}
    new = {"progress_l": new_pl, "dropped": dropped, "energy": energy,
           "work": work, "prev_error": prev_error,
           "prev_pcap_l": prev_pcap_l, "pcap": pcap_cmd,
           "anchor_gap": anchor_gap, "has_anchor": has_anchor, "t": t,
           "steps": c["steps"] + live, "done": new_done,
           "count": c["count"] + acc,
           "progress_sum": c["progress_sum"] + acc * progress,
           "progress_sq_sum": c["progress_sq_sum"]
           + acc * progress * progress,
           "power_sum": c["power_sum"] + acc * power_out,
           "progress_hist": prog_hist, "pcap_hist": pcap_hist}
    return new, out


def closed_loop_ref(prof, gains, noise, total_work, max_time,
                    dt=1.0, summary_from=0.0, collect: bool = True
                    ) -> Tuple[Optional[dict], dict]:
    """prof (B, 14), gains (B, 9), noise (T, 5, B) -> (traces, final).

    Traces (collect=True) are (T, B) per key in `TRACE_KEYS`; `final` is
    the full carry dict of (B,) leaves plus the (B, BINS) histograms.
    Runs on the device of ``prof``; rows may be float32 or bfloat16 and
    are computed in float32.
    """
    dev = prof.device
    prof = prof.to(torch.float32)
    gains = gains.to(device=dev, dtype=torch.float32)
    noise = noise.to(device=dev, dtype=torch.float32)
    sc = lambda x: torch.tensor(float(x), dtype=torch.float32, device=dev)
    tw, mt, dt, sf = (sc(total_work), sc(max_time), sc(dt),
                      sc(summary_from))
    c = init_state(prof, gains)
    rows = []
    for s in range(noise.shape[0]):
        c, out = step(prof, gains, c, noise[s], tw, mt, dt, sf)
        if collect:
            rows.append(out)
    traces = ({k: torch.stack([r[k] for r in rows]) for k in TRACE_KEYS}
              if collect else None)
    return traces, c
