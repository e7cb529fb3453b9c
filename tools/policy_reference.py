#!/usr/bin/env python3
"""The port's policies against the JAX reference on the CPU, at the sizes
of the reference's `benchmarks/policy_faceoff.py --full`.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/policy_reference.py

Needs both packages (torch and jax), no card. Two readings:

1. The face-off pipeline (gros, dahu, yeti x eps 0.1; PI traces of 8
   seeds, work 2,000, 1,024 s; fitted Q with 100 iterations; a race of
   PI, offline RL and duty-cycle x 30 seeds, summary mode, warm-up 30)
   run by the reference's own functions (its `sweep` on the scan engine,
   `build_dataset`, `fit_offline_rl`; nothing written to BENCH_sim.json),
   then by the port on the CPU from its own harvest and from the
   reference's dataset. Prints each policy's mean simulated time, mean
   energy and median progress over the setpoint per profile, and the
   fitted weights. These are simulated seconds and joules, not timings.
2. Fitted Q-iteration's float32 agreement: four datasets of 4,000
   transitions from `default_rng(11)`, at gamma 0 and 0.9, the port's
   `_fqi` on the CPU against the reference's; prints max |w - w_ref| /
   max |w_ref| and max |Q - Q_ref| / max |Q_ref| on a grid of 121 states
   (the bars of `tests/test_torch_policies.py::test_fitted_q_matches_
   reference` rest on these), and whether the greedy actions agree.
"""
from __future__ import annotations

import numpy as np

PROFS, EPS = ("gros", "dahu", "yeti"), 0.1
KW = dict(total_work=2000.0, max_time=1024.0)
NAMES = ("pi", "offline_rl", "dutycycle")


def _print_race(tag, res, profiles, quantile):
    for a, name in enumerate(NAMES):
        for p, prof in enumerate(PROFS):
            sp = (1.0 - EPS) * profiles[prof].progress_max
            med = quantile(np.asarray(res.summary["progress_hist"])[p, 0, a],
                           np.asarray(res.summary["progress_edges"])[p],
                           0.5)
            print(f"{tag} {name} {prof}: time "
                  f"{np.asarray(res.exec_time)[p, 0, a].mean():.4f} s, "
                  f"energy {np.asarray(res.energy)[p, 0, a].mean():.1f} J,"
                  f" median progress / setpoint {np.median(med) / sp:.4f},"
                  f" completed "
                  f"{np.asarray(res.completed)[p, 0, a].mean():.2f}")


def faceoff():
    from repro.core import policies as jpol
    from repro.core import sim as jsim
    from repro.core.plant import PROFILES as JPROFILES
    from repro_torch.core import policies as pol
    from repro_torch.core import sim
    from repro_torch.core.plant import PROFILES

    def race(sweep, policies, profiles, quantile, tag, **kw):
        res = sweep(PROFS, [EPS], range(30), **KW, policies=policies,
                    collect_traces=False, summary_warmup=30, **kw)
        _print_race(tag, res, profiles, quantile)

    har = jsim.sweep(PROFS, [EPS], range(8), **KW)
    parts = [jpol.build_dataset({k: np.asarray(v)[i]
                                 for k, v in har.traces.items()},
                                JPROFILES[p], EPS)
             for i, p in enumerate(PROFS)]
    ref_ds = {k: np.concatenate([d[k] for d in parts]) for k in parts[0]}
    ref_rl = jpol.fit_offline_rl(ref_ds, n_iters=100)
    print(f"reference: {len(ref_ds['s'])} transitions, w = "
          + ", ".join(f"{w:.4f}" for w in ref_rl.weights))
    race(jsim.sweep, [jpol.PIPolicy(), ref_rl, jpol.DutyCyclePolicy()],
         JPROFILES, jsim.hist_quantile, "reference")

    har = sim.sweep(PROFS, [EPS], range(8), **KW, backend="scan",
                    device="cpu")
    parts = [pol.build_dataset({k: v[i] for k, v in har.traces.items()},
                               PROFILES[p], EPS)
             for i, p in enumerate(PROFS)]
    ds = {k: np.concatenate([d[k] for d in parts]) for k in parts[0]}
    for tag, data in (("port", ds), ("port on the reference's dataset",
                                     ref_ds)):
        rl = pol.fit_offline_rl(data, n_iters=100, device="cpu")
        print(f"{tag}: {len(data['s'])} transitions, w = "
              + ", ".join(f"{w:.4f}" for w in rl.weights))
        race(sim.sweep, [pol.PIPolicy(), rl, pol.DutyCyclePolicy()],
             PROFILES, sim.hist_quantile, tag, device="cpu")


def _q(w, s):
    us = np.linspace(0.0, 1.0, 9)
    S, U = np.meshgrid(s, us, indexing="ij")
    f = np.stack([np.ones_like(S), S, S * S, U, U * U, S * U], -1)
    return f @ np.asarray(w, np.float64)


def fitted_q():
    import jax.numpy as jnp
    import torch
    from repro.core.policies import offline_rl as JRL
    from repro_torch.core.policies import offline_rl as RL

    rng = np.random.default_rng(11)
    n, grid = 4000, np.linspace(0.3, 1.5, 121)
    worst_w = worst_q = 0.0
    agree = True
    for _ in range(4):
        s = rng.uniform(0.4, 1.4, n).astype(np.float32)
        a = rng.uniform(0.0, 1.0, n).astype(np.float32)
        s2 = np.clip(s + rng.normal(0, 0.1, n), 0.3, 1.5).astype(
            np.float32)
        r = (-(a - 0.7) ** 2 - 3 * np.maximum(0, 1 - s2)).astype(
            np.float32)
        for gamma in (0.0, 0.9):
            w_ref = np.asarray(JRL._fqi(*(jnp.asarray(x) for x in
                                          (s, a, r, s2)),
                                        jnp.float32(gamma),
                                        jnp.float32(1e-3), 50))
            w = RL._fqi(*(torch.from_numpy(x) for x in (s, a, r, s2)),
                        gamma, 1e-3, 50).numpy()
            q, q_ref = _q(w, grid), _q(w_ref, grid)
            worst_w = max(worst_w, np.abs(w - w_ref).max()
                          / np.abs(w_ref).max())
            worst_q = max(worst_q, np.abs(q - q_ref).max()
                          / np.abs(q_ref).max())
            agree &= bool((q.argmax(-1) == q_ref.argmax(-1)).all())
    print(f"fitted Q over 4 datasets x gamma (0, 0.9): max |w - w_ref| / "
          f"max |w_ref| {worst_w:.3e}, max |Q - Q_ref| / max |Q_ref| "
          f"{worst_q:.3e}; greedy actions equal on every grid state: "
          f"{agree}")


if __name__ == "__main__":
    fitted_q()
    faceoff()
