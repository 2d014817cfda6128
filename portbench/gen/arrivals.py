"""Arrival schedules, read from a traffic mix. ``poisson_schedule`` is a
copy of the program's `serve/loadgen.py` (sound arithmetic), kept here so
that a change to the program cannot move it. ``burst_schedule`` keeps that
module's rates but draws each phase of a period on its own: the program's
draws the gap that crosses into a burst at the floor rate, which starts
each burst late by that gap (1 / 56 s on average at 1,120/s, factor 4,
duty 0.25: 7% of a quarter-second burst)."""

from __future__ import annotations

import numpy as np

from portbench.gen import sub_seed


def poisson_schedule(qps: float, n: int, *, seed: int = 0, start: float = 0.0) -> np.ndarray:
    """``n`` arrival times of a Poisson process at ``qps`` (seeded)."""
    if qps <= 0:
        raise ValueError("qps must be positive")
    rng = np.random.default_rng(seed)
    return start + np.cumsum(rng.exponential(1.0 / qps, size=n))


def burst_schedule(qps: float, n: int, *, seed: int = 0, start: float = 0.0,
                   burst_factor: float = 4.0, duty: float = 0.25,
                   period_s: float = 1.0) -> np.ndarray:
    """The first ``n`` arrivals of a Poisson process whose rate is ``qps *
    burst_factor`` for the ``duty`` share of each ``period_s`` and a floor
    rate the rest, keeping the mean near ``qps`` when ``burst_factor * duty
    <= 1``. Each phase draws its count (Poisson at its rate times its
    length) and then that many times, uniform in it, so a longer draw of one
    seed begins with the shorter one."""
    if qps <= 0:
        raise ValueError("qps must be positive")
    if not 0.0 < duty < 1.0:
        raise ValueError(f"duty must be in (0,1): {duty}")
    if burst_factor < 1.0:
        raise ValueError(f"burst_factor must be >= 1: {burst_factor}")
    rng = np.random.default_rng(seed)
    high = qps * burst_factor
    low = max(qps * (1.0 - burst_factor * duty) / (1.0 - duty), qps * 0.05)
    phases = ((high, 0.0, duty * period_s), (low, duty * period_s, period_s))
    out, have, k = [], 0, 0
    while have < n:
        for rate, a, b in phases:
            t = np.sort(rng.uniform(a, b, rng.poisson(rate * (b - a))))
            out.append(start + k * period_s + t)
            have += len(t)
        k += 1
    return np.concatenate(out)[:n]


def schedule(mix: dict, seconds: float, seed: int) -> np.ndarray:
    """Due times in ``[0, seconds)`` of the mix's ``arrivals`` at ``rate_qps``
    (``poisson``, or ``burst`` with ``burst_factor``, ``duty``, ``period_s``)."""
    rate = float(mix["rate_qps"])
    s = sub_seed(seed, "arrivals")
    n = int(rate * seconds * 1.5) + 64
    while True:  # a longer draw of one seed begins with the shorter one
        if mix["arrivals"] == "poisson":
            t = poisson_schedule(rate, n, seed=s)
        elif mix["arrivals"] == "burst":
            t = burst_schedule(rate, n, seed=s, burst_factor=mix["burst_factor"],
                               duty=mix["duty"], period_s=mix.get("period_s", 1.0))
        else:
            raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
        if t[-1] >= seconds:
            return t[t < seconds]
        n *= 2
