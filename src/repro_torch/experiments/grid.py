"""Experiment declaration: scorer grids + the named-experiment registry.

A *grid* is the cartesian product of parameter values over one base scorer
(``bm25 × {k1} × {b}``); an *experiment* is a set of grids plus the collection
shape and scan-job knobs. Expansion produces plain ``scoring.Scorer`` objects,
so the whole grid rides the multi-scorer single-pass scan
(`scan.search_local_multi`) — the paper's economics (claim C1/C2: one corpus
stream amortized over a batch) applied to the *model* axis instead of the
query axis.
"""

from __future__ import annotations

import dataclasses
import itertools

from repro_torch.core import scoring


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Parameter grid over one base scorer; empty ``params`` = the base."""

    base: str
    params: tuple[tuple[str, tuple], ...] = ()  # (param name, values)

    def expand(self) -> list[scoring.Scorer]:
        if not self.params:
            return [scoring.make_variant(self.base)]
        names = [n for n, _ in self.params]
        values = [v for _, v in self.params]
        return [
            scoring.make_variant(self.base, **dict(zip(names, combo)))
            for combo in itertools.product(*values)
        ]


def parse_grid(spec: str) -> GridSpec:
    """Parse ``"bm25:k1=0.9|1.2,b=0.4|0.75"`` CLI syntax into a GridSpec."""
    base, _, params_s = spec.partition(":")
    if not base:
        raise ValueError(f"empty scorer in grid spec {spec!r}")
    scoring.get_scorer(base)  # fail fast on unknown scorers
    params = []
    if params_s:
        for item in params_s.split(","):
            name, _, vals = item.partition("=")
            if not vals:
                raise ValueError(f"malformed grid param {item!r} in {spec!r}")
            parsed = []
            for v in vals.split("|"):
                if v in ("true", "false"):
                    parsed.append(v == "true")
                else:
                    parsed.append(int(v) if v.lstrip("+-").isdigit() else float(v))
            params.append((name, tuple(parsed)))
    return GridSpec(base=base, params=tuple(params))


def expand_grids(grids: tuple[GridSpec, ...]) -> list[scoring.Scorer]:
    """Flatten grids to a model stack, rejecting duplicates and mixed kinds."""
    scorers: list[scoring.Scorer] = []
    seen = set()
    for g in grids:
        for s in g.expand():
            if s.name in seen:
                raise ValueError(f"duplicate scorer variant {s.name!r} in grid")
            seen.add(s.name)
            scorers.append(s)
    kinds = {s.kind for s in scorers}
    if len(kinds) > 1:
        raise ValueError(
            f"an experiment scans one corpus representation; got kinds {sorted(kinds)}"
        )
    return scorers


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """A named, fully-declared experiment: grids + collection + job knobs."""

    name: str
    grids: tuple[GridSpec, ...]
    n_docs: int = 8192
    n_queries: int = 64
    vocab: int = 8192
    max_doc_len: int = 64
    k: int = 20
    chunk_size: int = 512
    segment_chunks: int = 4  # chunks per checkpoint segment
    n_shards: int = 1  # corpus scan shards (repro_torch.cluster sharded job)
    use_kernel: bool = False  # accepted for the reference's specs; the device picks the path
    eval_ks: tuple[int, ...] = (5, 10, 20)
    baseline: str | None = None  # variant name significance is tested against

    def scorers(self) -> list[scoring.Scorer]:
        return expand_grids(self.grids)


EXPERIMENTS: dict[str, ExperimentSpec] = {}


def register_experiment(spec: ExperimentSpec) -> ExperimentSpec:
    if spec.name in EXPERIMENTS:
        raise ValueError(f"experiment {spec.name!r} already registered")
    EXPERIMENTS[spec.name] = spec
    return spec


def get_experiment(name: str) -> ExperimentSpec:
    try:
        return EXPERIMENTS[name]
    except KeyError:
        raise KeyError(
            f"unknown experiment {name!r}; available: {sorted(EXPERIMENTS)}"
        ) from None


# -- built-in experiments ---------------------------------------------------

register_experiment(
    ExperimentSpec(
        name="smoke",
        # 2 models, tiny corpus: the CI smoke grid (seconds on a CPU host)
        grids=(GridSpec("ql_lm"), GridSpec("bm25")),
        n_docs=512,
        n_queries=16,
        vocab=2048,
        k=10,
        chunk_size=128,
        segment_chunks=2,
        eval_ks=(5, 10),
        baseline="ql_lm",
    )
)

register_experiment(
    ExperimentSpec(
        name="bm25-grid",
        # the classic Okapi parameter sweep: 2×2 grid + the paper's QL LM
        grids=(
            GridSpec("bm25", (("k1", (0.9, 1.2)), ("b", (0.4, 0.75)))),
            GridSpec("ql_lm"),
        ),
        baseline="ql_lm",
    )
)

register_experiment(
    ExperimentSpec(
        name="lm-grid",
        # the paper's own model family: smoothing × length-prior ablation
        grids=(
            GridSpec(
                "ql_lm",
                (("lam", (0.05, 0.15, 0.5)), ("length_prior", (True, False))),
            ),
        ),
        baseline="ql_lm(lam=0.15,length_prior=True)",
    )
)
