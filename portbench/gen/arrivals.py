"""Arrival schedules, read from a traffic mix. ``poisson_schedule`` and
``burst_schedule`` are copies of the program's `serve/loadgen.py` (sound
arithmetic), kept here so that a change to the program cannot move them."""

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
    """Bursty arrivals: a Poisson process whose rate is ``qps *
    burst_factor`` for the ``duty`` share of each ``period_s`` and a floor
    rate the rest, keeping the mean near ``qps`` when ``burst_factor * duty
    <= 1``."""
    if qps <= 0:
        raise ValueError("qps must be positive")
    if not 0.0 < duty < 1.0:
        raise ValueError(f"duty must be in (0,1): {duty}")
    if burst_factor < 1.0:
        raise ValueError(f"burst_factor must be >= 1: {burst_factor}")
    rng = np.random.default_rng(seed)
    high = qps * burst_factor
    low = max(qps * (1.0 - burst_factor * duty) / (1.0 - duty), qps * 0.05)
    out = np.empty(n)
    t = start
    for i in range(n):
        rate = high if (t % period_s) < duty * period_s else low
        t += rng.exponential(1.0 / rate)
        out[i] = t
    return out


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
