"""Progress signal from heartbeats (paper Eq. 1); port of
`repro.core.signals`.

Applications emit heartbeats at times t_k. The progress metric at
control period t_i is the median of instantaneous heart rates over
[t_{i-1}, t_i):

    progress(t_i) = median_k 1 / (t_k - t_{k-1})

The median makes the signal robust to stragglers/outliers (paper §4.2).
Here: the tenant-batched ring-buffer store (`TenantHeartbeatStore`, one
numpy pass rates every tenant's window at once) and the single-tenant
`HeartbeatAggregator` over it (the NRM's sensor), both host numpy code
copied from the reference, so their float64 answers are the reference's
bit for bit; the batch version over one window of beat times
(`progress_from_times`) and the beat synthesizer the tests and examples
feed it (`synth_heartbeats`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.obs import metrics as obs_metrics


class TenantHeartbeatStore:
    """Tenant-batched online Eq. 1: N ring buffers, one vectorized pass.

    Beats from any mix of tenants land via `ingest(tenant_ids, times,
    works)`; `progress_all(t_i)` reduces every tenant's half-open window
    [last_emit, t_i) to its median heart-rate in one numpy sweep
    (prefix masks + row-sorted median — no Python loop over tenants).
    Per-tenant semantics are exactly those of the scalar
    `HeartbeatAggregator` they generalize: beats older than a tenant's
    last emit fold into its anchor (the newest pre-window beat, which
    gives the window's first beat an interval), ring overflow evicts the
    oldest beats with the newest evicted beat anchoring the survivors,
    and emitting consumes the window (the newest rated beat becomes the
    next anchor). Buffers are plain numpy so the whole store pickles
    into a plane snapshot.
    """

    def __init__(self, n_tenants: int, max_beats: int = 256):
        if n_tenants < 1 or max_beats < 1:
            raise ValueError("need n_tenants >= 1 and max_beats >= 1")
        self._t = np.zeros((int(n_tenants), int(max_beats)), np.float64)
        self._w = np.zeros((int(n_tenants), int(max_beats)), np.float64)
        self._n = np.zeros(int(n_tenants), np.int64)
        self._anchor = np.full(int(n_tenants), np.nan)     # nan = none
        self._last_emit = np.full(int(n_tenants), np.nan)  # nan = none
        self._drops = np.zeros(int(n_tenants), np.int64)   # rejected beats

    @property
    def n_tenants(self) -> int:
        return self._t.shape[0]

    @property
    def max_beats(self) -> int:
        return self._t.shape[1]

    def counts(self) -> np.ndarray:
        """Buffered (un-emitted) beats per tenant."""
        return self._n.copy()

    def drops(self) -> np.ndarray:
        """Per-tenant count of beats rejected at ingest (non-finite
        time/work or negative work — corrupt telemetry that would
        otherwise poison the Eq. 1 median or the rate's numerator)."""
        return self._drops.copy()

    def clear_row(self, i: int) -> None:
        """Reset one tenant's buffer/anchor/emit clock (tenant churn)."""
        self._n[i] = 0
        self._anchor[i] = np.nan
        self._last_emit[i] = np.nan
        self._drops[i] = 0

    def ingest(self, tenant_ids, times, works=None) -> None:
        """Append a batch of beats, any tenant mix, one vectorized copy.

        Within each tenant the supplied times must be non-decreasing and
        not precede that tenant's already-buffered beats (the same
        contract as calling `HeartbeatAggregator.beat` in a loop); the
        batch order is preserved per tenant (stable grouping). Beats
        older than a tenant's last emit fold into its anchor exactly
        like the scalar `beat` does.
        """
        ids = np.asarray(tenant_ids, np.int64).reshape(-1)
        t = np.asarray(times, np.float64).reshape(-1)
        w = (np.ones_like(t) if works is None
             else np.ascontiguousarray(np.broadcast_to(
                 np.asarray(works, np.float64), t.shape)))
        if ids.shape != t.shape:
            raise ValueError("tenant_ids and times must match in length")
        if not len(t):
            return
        obs_metrics.get_registry().counter(
            "heartbeat_beats_ingested_total",
            "beats submitted to the tenant store (pre-sanitization)"
            ).inc(len(t))
        N, B = self._t.shape
        if len(ids) and (ids.min() < 0 or ids.max() >= N):
            raise IndexError("tenant id out of range")
        # ingest-time sanitization: a NaN/inf time would corrupt the
        # ring's ordering invariant, a non-finite or negative work would
        # poison the rate numerator; both are dropped here (counted per
        # tenant) so one sick workload can't contaminate the window
        bad = ~np.isfinite(t) | ~np.isfinite(w) | (w < 0)
        if bad.any():
            np.add.at(self._drops, ids[bad], 1)
            obs_metrics.get_registry().counter(
                "heartbeat_ingest_drops_total",
                "beats rejected at ingest (non-finite time/work)"
                ).inc(int(bad.sum()))
            ids, t, w = ids[~bad], t[~bad], w[~bad]
            if not len(t):
                return
        order = np.argsort(ids, kind="stable")  # group, keep beat order
        ids, t, w = ids[order], t[order], w[order]
        # late beats: their window is already emitted. They are dropped,
        # but the newest late beat still anchors an *empty* row (it is
        # the predecessor the next rated beat pairs with).
        late = t < self._last_emit[ids]  # nan (never emitted) -> False
        if late.any():
            fold = np.full(N, -np.inf)
            np.maximum.at(fold, ids[late], t[late])
            anc = np.where(np.isnan(self._anchor), -np.inf, self._anchor)
            upd = (self._n == 0) & (fold > anc)
            self._anchor[upd] = fold[upd]
            keep = ~late
            ids, t, w = ids[keep], t[keep], w[keep]
            if not len(t):
                return
        n = self._n.copy()
        c = np.bincount(ids, minlength=N)       # batch beats per tenant
        seg_start = np.concatenate(([0], np.cumsum(c)[:-1]))
        # tenants whose batch alone fills the ring: every buffered beat
        # is older than the batch, so drop them all (newest buffered
        # beat anchors), then keep only the ring-sized batch tail (the
        # newest cut beat anchors the survivors instead).
        full = c >= B
        cut = np.where(full, c - B, 0)
        if full.any():
            had = full & (n > 0)
            if had.any():
                rows = np.nonzero(had)[0]
                self._anchor[rows] = self._t[rows, n[rows] - 1]
                n[rows] = 0
            has_cut = cut > 0
            if has_cut.any():
                rows = np.nonzero(has_cut)[0]
                self._anchor[rows] = t[seg_start[rows] + cut[rows] - 1]
        keep_c = c - cut
        # partial overflow: evict the oldest buffered beats to make room
        # (the newest evicted beat becomes the anchor), shift rows left
        evict = np.maximum(0, n + keep_c - B)
        if evict.any():
            rows = np.nonzero(evict > 0)[0]
            self._anchor[rows] = self._t[rows, evict[rows] - 1]
            idx = np.minimum(np.arange(B)[None, :] + evict[rows, None],
                             B - 1)
            self._t[rows] = np.take_along_axis(self._t[rows], idx, 1)
            self._w[rows] = np.take_along_axis(self._w[rows], idx, 1)
            n[rows] -= evict[rows]
        # flat scatter: each kept beat lands after its row's buffered
        # prefix, preserving the within-tenant batch order
        rank = np.arange(len(t)) - seg_start[ids]
        kept = rank >= cut[ids]
        dst = ids * B + n[ids] + (rank - cut[ids])
        self._t.reshape(-1)[dst[kept]] = t[kept]
        self._w.reshape(-1)[dst[kept]] = w[kept]
        self._n = n + keep_c

    def progress_all(self, t_i) -> np.ndarray:
        """Median heart-rate of each tenant's [last_emit, t_i) window —
        paper Eq. 1 for all tenants in one vectorized pass.

        `t_i` broadcasts to one emit time per tenant. Intervals are
        between consecutive arrivals; the window's first beat pairs with
        the anchor (which may precede the window), so a single beat per
        control period still yields a rate. Half-open window: a beat on
        the edge belongs to the NEXT window. Emitting consumes the
        window per tenant (rated beats leave the buffer, the newest is
        retained as that tenant's next anchor); tenants with an empty
        window report 0.0 and keep their buffer untouched.
        """
        N, B = self._t.shape
        t_i = np.ascontiguousarray(np.broadcast_to(
            np.asarray(t_i, np.float64), (N,)))
        col = np.arange(B)[None, :]
        valid = col < self._n[:, None]
        in_win = valid & (self._t < t_i[:, None])  # sorted -> a prefix
        k = in_win.sum(axis=1)
        prev = np.empty_like(self._t)
        prev[:, 1:] = self._t[:, :-1]
        prev[:, 0] = self._anchor                  # nan when unanchored
        with np.errstate(invalid="ignore", divide="ignore",
                         over="ignore"):
            dts = self._t - prev
            ok = in_win & (dts > 0)                # nan prev -> False
            rates = np.where(ok, self._w / np.where(ok, dts, 1.0),
                             np.inf)
        m = ok.sum(axis=1)
        srt = np.sort(rates, axis=1)               # valid first, inf pad
        lo = np.maximum((m - 1) // 2, 0)
        hi = np.where(m > 0, m // 2, 0)
        med = 0.5 * (np.take_along_axis(srt, lo[:, None], 1)[:, 0]
                     + np.take_along_axis(srt, hi[:, None], 1)[:, 0])
        out = np.where(m > 0, med, 0.0)
        # consume each non-empty window: newest rated beat -> anchor,
        # shift the survivors to the row head
        rows = k > 0
        last = self._t[np.arange(N), np.maximum(k - 1, 0)]
        self._anchor = np.where(rows, last, self._anchor)
        idx = np.minimum(col + k[:, None], B - 1)  # k==0 rows: identity
        self._t = np.take_along_axis(self._t, idx, 1)
        self._w = np.take_along_axis(self._w, idx, 1)
        self._n = self._n - k
        self._last_emit = t_i.copy()               # unconditional
        return out

    def state_dict(self) -> dict:
        """JSON-serializable snapshot of every tenant's in-flight window."""
        n = self._n
        return {
            "max_beats": int(self.max_beats),
            "t": [self._t[i, :n[i]].tolist() for i in range(self.n_tenants)],
            "w": [self._w[i, :n[i]].tolist() for i in range(self.n_tenants)],
            "anchor": [None if np.isnan(a) else float(a)
                       for a in self._anchor],
            "last_emit": [None if np.isnan(e) else float(e)
                          for e in self._last_emit],
            "drops": self._drops.tolist(),
        }

    def load_state_dict(self, state: dict) -> None:
        if len(state["t"]) != self.n_tenants:
            raise ValueError(
                f"snapshot holds {len(state['t'])} tenants, store has "
                f"{self.n_tenants}")
        self._t[:] = 0.0
        self._w[:] = 0.0
        for i, (ts, ws) in enumerate(zip(state["t"], state["w"])):
            n = len(ts)
            if n > self.max_beats:
                raise ValueError("snapshot row exceeds ring capacity")
            self._t[i, :n] = ts
            self._w[i, :n] = ws
            self._n[i] = n
        self._anchor[:] = [np.nan if a is None else a
                           for a in state["anchor"]]
        self._last_emit[:] = [np.nan if e is None else e
                              for e in state["last_emit"]]
        # older snapshots predate the drop counter
        self._drops[:] = state.get("drops", [0] * self.n_tenants)


_ZERO_ID = np.zeros(1, np.int64)


class HeartbeatAggregator:
    """Online Eq. 1 for one tenant: collect beats, emit the median
    heart-rate per period.

    A thin one-row view over `TenantHeartbeatStore` — the NRM's runtime
    path and the control plane's batched ingestion are literally the
    same code. Beats land in the store's numpy ring buffer; `progress`
    reduces the window with the store's vectorized sweep; beats older
    than the last emit fold into the anchor (the newest pre-window beat
    that gives the window's first beat an interval). `beat_many` ingests
    a whole batch of beats in one append — the buffered path for
    workloads that report per-step (or per-device) beats in bulk."""

    def __init__(self, max_beats: int = 4096):
        self._store = TenantHeartbeatStore(1, max_beats=max_beats)

    def __len__(self) -> int:
        return int(self._store._n[0])

    @property
    def drops(self) -> int:
        """Beats rejected at ingest (non-finite time/work, negative
        work)."""
        return int(self._store._drops[0])

    @property
    def _anchor(self) -> Optional[float]:
        a = self._store._anchor[0]
        return None if np.isnan(a) else float(a)

    @property
    def _last_emit(self) -> Optional[float]:
        e = self._store._last_emit[0]
        return None if np.isnan(e) else float(e)

    def beat(self, t: float, work: float = 1.0) -> None:
        # `work` scales the rate: a beat covering w units at interval dt
        # contributes w/dt (generalizes the paper's unit-work loop beat).
        self._store.ingest(_ZERO_ID, [t], [work])

    def beat_many(self, times, works=None) -> None:
        """Batched ingestion: append `times` (and optional per-beat
        `works`) in one vectorized copy. Times must be non-decreasing
        and not precede already-buffered beats (same contract as calling
        `beat` in a loop; beats older than the last emit are folded into
        the anchor exactly like `beat` does)."""
        times = np.asarray(times, np.float64).reshape(-1)
        self._store.ingest(np.zeros(len(times), np.int64), times, works)

    def progress(self, t_i: float) -> float:
        """Median heart-rate of beats in [last_emit, t_i) — paper Eq. 1.

        Half-open window; emitting consumes the window (beats before t_i
        leave the buffer, the newest is retained as the next anchor)."""
        return float(self._store.progress_all(t_i)[0])

    def state_dict(self) -> dict:
        """JSON-serializable snapshot of the in-flight window (buffered
        beats + anchor + emit clock), for NRM checkpoint round-trips."""
        s = self._store.state_dict()
        return {"max_beats": s["max_beats"], "t": s["t"][0],
                "w": s["w"][0], "anchor": s["anchor"][0],
                "last_emit": s["last_emit"][0], "drops": s["drops"][0]}

    def load_state_dict(self, state: dict) -> None:
        self._store.load_state_dict({
            "max_beats": state["max_beats"], "t": [state["t"]],
            "w": [state["w"]], "anchor": [state["anchor"]],
            "last_emit": [state["last_emit"]],
            "drops": [state.get("drops", 0)]})


def median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis of a float tensor (a 1-D tensor gives a
    0-dim one), the two middle values averaged for an even length
    (``(lo + hi) * 0.5``, as ``jnp.median`` computes it; `torch.median`
    would return the lower one). NaN where a row is empty or holds a NaN.
    The sort is exact, so each row's answer does not depend on the other
    rows of the batch."""
    n = x.shape[-1]
    if n == 0:
        return torch.full(x.shape[:-1], float("nan"), dtype=x.dtype,
                          device=x.device)
    s = torch.sort(x, dim=-1).values
    mid = (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(-1),
                       torch.full_like(mid, float("nan")), mid)


def progress_from_times(beat_times: Union[Sequence[float], torch.Tensor],
                        device: Union[None, str, torch.device] = None
                        ) -> torch.Tensor:
    """Batch Eq. 1 over a full window of beat times: the median heart rate,
    a float32 0-dim tensor on ``device`` (default: the times' device if
    they are a tensor, else CUDA, raising without one)."""
    if device is None and isinstance(beat_times, torch.Tensor):
        dev = beat_times.device
    else:
        dev = resolve_device(device)
    t = torch.as_tensor(beat_times, dtype=torch.float32, device=dev)
    dts = torch.diff(t)
    rates = torch.where(dts > 0, 1.0 / torch.clamp(dts, min=1e-9),
                        torch.zeros_like(dts))
    return median(rates)


def synth_heartbeats(rng: np.random.Generator, rate_hz: float,
                     duration: float, jitter: float = 0.1) -> List[float]:
    """Synthesize beat times at a given rate with lognormal jitter."""
    t, out = 0.0, []
    if rate_hz <= 0:
        return out
    mean_dt = 1.0 / rate_hz
    while t < duration:
        t += mean_dt * float(rng.lognormal(0.0, jitter))
        out.append(t)
    return out
