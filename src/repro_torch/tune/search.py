"""Async model-based knob search — AMBS over the legal TuningConfig space.

The port's copy of `repro.tune.search` (pure Python): given the same space,
seed and a deterministic measure it runs the reference's sequence of
trials. The shape of deephyper's asynchronous model-based search, sized for
a knob space of dozens of points rather than millions: a *candidate
generator* samples legal configs from a declared discrete space
(shape/divisibility constraints applied at generation time, so no
measurement budget is ever spent on a config the job would reject), a
*cheap surrogate* fitted on the trials so far ranks the unmeasured
candidates, and an async evaluation loop keeps ``workers`` measurements in
flight, refitting and re-ranking each time one lands — the budget flows
toward the promising region of the space instead of being spread uniformly.

The surrogate is a distance-weighted nearest-neighbor predictor over the
knobs' *value indices* (each knob's values are an ordered scale; normalized
index distance is a sane metric on block sizes and batch buckets alike).
That is deliberately the cheapest model that still ranks: with budgets of
8–64 trials a fitted GP/forest is noise, and the predictor must cost
microseconds because it reranks after every trial.

Determinism: the generator and the ranking tie-breaks are seeded, and with
``workers=1`` (the default — measurements contend for the same card, so
parallel trials pollute each other) the whole search is a reproducible
function of (space, seed, measured times).

The search times nothing itself: ``measure`` does, and must wait for the
device before it stops its clock. `repro_torch.tune.targets` binds the scan
space to `cluster.run_sharded_scan_job` and checks every trial's bytes.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import random
from typing import Callable, Sequence

from repro_torch.tune.config import DEFAULT, TuningConfig


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable dimension: the TuningConfig field and its legal values,
    ordered (the surrogate's distance metric is index distance on this
    scale)."""

    name: str
    values: tuple

    def __post_init__(self):
        if not self.values:
            raise ValueError(f"knob {self.name!r} has no values")


@dataclasses.dataclass(frozen=True)
class KnobSpace:
    """A legal sub-space of TuningConfig for one workload kind.

    ``constraint`` rejects structurally-illegal combinations (a chunk that
    doesn't divide the shard) at candidate-generation time. ``base`` carries
    the knobs this space does *not* search (a serve space leaves the scan
    knobs at their defaults).
    """

    kind: str
    knobs: tuple[Knob, ...]
    constraint: Callable[[TuningConfig], bool] | None = None
    base: TuningConfig = DEFAULT

    def config(self, assignment: dict) -> TuningConfig:
        return self.base.replace(**assignment)

    def is_legal(self, cfg: TuningConfig) -> bool:
        return self.constraint is None or bool(self.constraint(cfg))

    def size(self) -> int:
        n = 1
        for k in self.knobs:
            n *= len(k.values)
        return n

    def candidates(self, *, max_candidates: int = 4096, seed: int = 0) -> list[TuningConfig]:
        """All legal configs (small spaces) or a seeded uniform sample
        (large ones), with the space's base — the default configuration —
        always candidate #0: the search can then never report a winner
        worse than the default, because the default is *in* the tournament.
        """
        rng = random.Random(seed)
        names = [k.name for k in self.knobs]
        out: list[TuningConfig] = []
        seen: set[tuple] = set()

        def admit(combo) -> None:
            cfg = self.config(dict(zip(names, combo)))
            key = tuple(sorted(cfg.describe().items(), key=lambda kv: kv[0]))
            if key in seen:
                return
            if not self.is_legal(cfg):
                return
            seen.add(key)
            out.append(cfg)

        base_combo = tuple(
            getattr(self.base, k.name) for k in self.knobs
        )
        admit(base_combo)  # the default-config oracle rides in every pool
        if self.size() <= max_candidates:
            for combo in itertools.product(*(k.values for k in self.knobs)):
                admit(combo)
        else:
            tries = 0
            while len(out) < max_candidates and tries < max_candidates * 20:
                admit(tuple(rng.choice(k.values) for k in self.knobs))
                tries += 1
        return out


@dataclasses.dataclass
class Trial:
    """One measured candidate. ``score`` is the figure of merit (higher is
    better — docs/s, qps); failed measurements keep the error and rank last."""

    config: TuningConfig
    score: float
    wall_s: float = 0.0
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.error is None


class Surrogate:
    """Distance-weighted k-NN score predictor on normalized knob indices.

    ``fit`` is O(trials); ``predict`` is O(trials · knobs). Unseen regions
    predict the observed mean, so exploration never starves: a candidate far
    from every measurement ranks around average, above the known-bad tail.
    """

    def __init__(self, space: KnobSpace, k: int = 3):
        self.space = space
        self.k = max(1, k)
        self._index = {
            knob.name: {v: i for i, v in enumerate(knob.values)}
            for knob in space.knobs
        }
        self._points: list[tuple[tuple[float, ...], float]] = []
        self._mean = 0.0

    def _encode(self, cfg: TuningConfig) -> tuple[float, ...]:
        coords = []
        for knob in self.space.knobs:
            idx = self._index[knob.name]
            v = getattr(cfg, knob.name)
            denom = max(1, len(knob.values) - 1)
            coords.append(idx.get(v, 0) / denom)
        return tuple(coords)

    def fit(self, trials: Sequence[Trial]) -> None:
        ok = [t for t in trials if t.ok]
        self._points = [(self._encode(t.config), t.score) for t in ok]
        self._mean = sum(s for _, s in self._points) / len(self._points) if ok else 0.0

    def predict(self, cfg: TuningConfig) -> float:
        if not self._points:
            return 0.0
        x = self._encode(cfg)
        dists = sorted(
            (sum(abs(a - b) for a, b in zip(x, p)), s) for p, s in self._points
        )[: self.k]
        num = den = 0.0
        for d, s in dists:
            w = 1.0 / (1e-6 + d)
            num += w * s
            den += w
        blend = num / den
        # shrink toward the mean with distance: far candidates are guesses
        nearest = dists[0][0]
        trust = 1.0 / (1.0 + nearest * len(self.space.knobs))
        return trust * blend + (1.0 - trust) * self._mean


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """The tournament outcome: best (incl. the default), every trial, and
    the default's own measurement for the default-vs-tuned curve."""

    space: KnobSpace
    best: Trial
    default: Trial
    trials: tuple[Trial, ...]

    @property
    def speedup_x(self) -> float:
        if not self.default.ok or self.default.score <= 0:
            return 1.0
        return self.best.score / self.default.score

    def describe(self) -> dict:
        return {
            "kind": self.space.kind,
            "n_trials": len(self.trials),
            "space_size": self.space.size(),
            "default": {
                "config_hash": self.default.config.config_hash(),
                "score": self.default.score,
            },
            "best": {
                "config_hash": self.best.config.config_hash(),
                "overrides": self.best.config.overrides(),
                "score": self.best.score,
            },
            "speedup_x": self.speedup_x,
            "trials": [
                {
                    "overrides": t.config.overrides(),
                    "score": t.score,
                    "wall_s": t.wall_s,
                    "error": t.error,
                }
                for t in self.trials
            ],
        }


def search(
    space: KnobSpace,
    measure: Callable[[TuningConfig], float],
    *,
    budget: int = 16,
    seed: int = 0,
    init_random: int = 3,
    workers: int = 1,
    log: Callable[[str], None] | None = None,
) -> SearchResult:
    """Run the AMBS loop: measure the default + ``init_random`` seeded
    picks, then keep ``workers`` measurements in flight, each next candidate
    being the surrogate's argmax over the unmeasured pool (refit on every
    completion). ``measure(config)`` returns the figure of merit (higher is
    better) and may raise — a failed trial scores ``-inf`` and teaches the
    surrogate to avoid its region.

    The default config is always trial #0, so ``result.best`` is ≥ the
    default *by construction within this measurement session* — autotuning
    can surface "nothing beats the defaults here" (speedup 1.0) but never a
    recorded regression.
    """
    if budget < 1:
        raise ValueError(f"budget must be >= 1, got {budget}")
    pool = space.candidates(seed=seed)
    rng = random.Random(seed + 1)
    surrogate = Surrogate(space)
    trials: list[Trial] = []
    measured: set[str] = set()

    def run_one(cfg: TuningConfig) -> Trial:
        import time

        t0 = time.perf_counter()
        try:
            score = float(measure(cfg))
        except Exception as e:  # noqa: BLE001 — an illegal-at-runtime config is data
            return Trial(
                config=cfg, score=float("-inf"),
                wall_s=time.perf_counter() - t0, error=f"{type(e).__name__}: {e}",
            )
        return Trial(config=cfg, score=score, wall_s=time.perf_counter() - t0)

    def next_candidate() -> TuningConfig | None:
        remaining = [c for c in pool if c.config_hash() not in measured]
        if not remaining:
            return None
        n_done = len([t for t in trials if t.ok])
        if len(measured) < 1 + init_random or n_done == 0:
            # bootstrap: the default first, then seeded exploration
            if pool[0].config_hash() not in measured:
                return pool[0]
            return rng.choice(remaining)
        surrogate.fit(trials)
        return max(remaining, key=lambda c: (surrogate.predict(c), c.config_hash()))

    budget = min(budget, len(pool))
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
        in_flight: dict = {}
        launched = 0
        while launched < budget and len(in_flight) < max(1, workers):
            cand = next_candidate()
            if cand is None:
                break
            measured.add(cand.config_hash())
            in_flight[ex.submit(run_one, cand)] = cand
            launched += 1
        while in_flight:
            done, _ = concurrent.futures.wait(
                in_flight, return_when=concurrent.futures.FIRST_COMPLETED
            )
            for fut in done:
                in_flight.pop(fut)
                trial = fut.result()
                trials.append(trial)
                if log is not None:
                    tag = f"{trial.score:.1f}" if trial.ok else trial.error
                    log(f"[tune:{space.kind}] {trial.config.overrides() or 'default'} -> {tag}")
                if launched < budget:
                    cand = next_candidate()
                    if cand is not None:
                        measured.add(cand.config_hash())
                        in_flight[ex.submit(run_one, cand)] = cand
                        launched += 1

    # trials land in completion order; the default is identified by content,
    # not position (async workers may finish out of launch order)
    default_hash = pool[0].config_hash()
    default_trial = next(
        t for t in trials if t.config.config_hash() == default_hash
    )
    ok = [t for t in trials if t.ok]
    if not ok:
        raise RuntimeError(
            f"every {space.kind} trial failed; first error: {trials[0].error}"
        )
    best = max(ok, key=lambda t: (t.score, t is default_trial))
    return SearchResult(
        space=space, best=best, default=default_trial, trials=tuple(trials)
    )
