"""Experiment driver of the port: declare a grid, run the lifecycle, print the report.

    # a registered experiment (see repro_torch/experiments/grid.py), on the card
    PYTHONPATH=src python -m repro_torch.launch.experiment --experiment bm25-grid

    # the same on the CPU (the kernels' plain PyTorch versions)
    PYTHONPATH=src python -m repro_torch.launch.experiment --experiment smoke --device cpu

    # or an ad-hoc grid: base:param=v1|v2,... (repeatable)
    PYTHONPATH=src python -m repro_torch.launch.experiment \
        --grid "bm25:k1=0.9|1.2,b=0.4|0.75" --grid ql_lm --n-docs 4096

The lifecycle is prepare → scan job → run files → eval (see
`repro_torch.experiments.runner`). The scan job checkpoints per corpus
segment under ``<out>/ckpt`` — kill the process mid-run and re-invoke with
the same ``--out`` to resume bit-identically. ``--token-pack
auto|8|16|bitpack`` packs the corpus segments (`repro_torch.core.packing`);
the run files are the unpacked run's.

Chaos testing goes through the reliability layer: ``--fault-spec`` (or
``--fault``) injects deterministic faults (repeatable;
``crash:shard=1,segment=0``, ``straggler:shard=2,delay=0.01``,
``writer_error:shard=0,segment=1``, ``dead_worker:worker=0``),
``--fault-seed`` derives a whole seeded schedule, and
``--max-retries``/``--speculative`` turn on checkpoint-resumed retries and
speculative re-execution. Run files are byte-identical to the fault-free
run under any schedule. (``--fail-at-segment`` is the deprecated
single-crash alias.)

Same flags as `repro.launch.experiment` plus ``--device`` (default
``cuda``); ``--pipeline`` (the overlapped executor) is the default, as
there. Not in this slice, and refused with a message: ``--tune``,
``--tune-cache`` and ``--bench``.
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch import tune
from repro_torch.cluster import FaultSchedule, build_schedule
from repro_torch.experiments import grid as exp_grid
from repro_torch.experiments import runner


def _spec_from_args(args) -> exp_grid.ExperimentSpec:
    if args.experiment:
        if args.grid:
            raise SystemExit(
                "--experiment and --grid are mutually exclusive; add the grid "
                "to the registry (repro_torch/experiments/grid.py) or run it ad-hoc"
            )
        spec = exp_grid.get_experiment(args.experiment)
    else:
        if not args.grid:
            raise SystemExit("need --experiment or at least one --grid")
        spec = exp_grid.ExperimentSpec(
            name="adhoc", grids=tuple(exp_grid.parse_grid(g) for g in args.grid)
        )
    overrides = {
        k: v
        for k, v in (
            ("n_docs", args.n_docs),
            ("n_queries", args.n_queries),
            ("k", args.k),
            ("chunk_size", args.chunk_size),
            ("segment_chunks", args.segment_chunks),
            ("n_shards", args.n_shards),
            ("use_kernel", args.use_kernel or None),
        )
        if v is not None
    }
    # (a small --k is fine: run_experiment clamps eval_ks to the run depth)
    return dataclasses.replace(spec, **overrides) if overrides else spec


def print_report(report: dict) -> None:
    job = report["job"]
    resumed = f", resumed from segment {job['resumed_from']}" if job["resumed_from"] else ""
    shards = f", {job['n_shards']} shards" if job.get("n_shards", 1) > 1 else ""
    print(
        f"== experiment {report['experiment']}: {len(report['models'])} models, "
        f"one pass over {report['n_docs']} docs × {report['n_queries']} queries "
        f"({job['segments_total']} checkpointed segments{shards}{resumed}) =="
    )
    sched = job.get("scheduler")
    if sched and (
        sched["retries"] or sched["steals"] or sched["speculative_launched"]
        or sched["dead_workers"] or job.get("faults_fired")
    ):
        fired = job.get("faults_fired") or []
        print(
            f"   reliability: {len(fired)} faults fired, "
            f"{sched['retries']} retries, {sched['steals']} steals, "
            f"{sched['speculative_launched']} speculative "
            f"({sched['speculative_won']} won), "
            f"dead workers {list(sched['dead_workers'])}"
        )
    t = job.get("tuning")
    if t and (t.get("source") != "default" or t.get("overrides")):
        hit = ", cache hit" if t.get("cache_hit") else ""
        print(
            f"   tuning: {t['config_hash']} ({t['source']}{hit}) "
            f"overrides={t.get('overrides') or {}}"
        )
    o = job.get("obs")
    if o:
        print(f"   trace: {o['n_events']} events -> {o['trace']}")
        for label, names in o.get("phases", {}).items():
            parts = ", ".join(
                f"{name} ×{agg['count']} {agg['total_s'] * 1e3:.1f}ms"
                for name, agg in names.items()
            )
            print(f"     {label}: {parts}")
    metric_names = list(next(iter(report["metrics"].values())))
    header = "model".ljust(34) + "".join(m.rjust(10) for m in metric_names)
    print(header)
    for model, agg in report["metrics"].items():
        sig = report["significance"].get(model)
        star = " *" if sig and sig["p_value"] < 0.05 else ""
        print(
            model.ljust(34)
            + "".join(f"{agg[m]:10.4f}" for m in metric_names)
            + star
        )
    base = report["baseline"]
    print(f"(* = p<0.05 vs baseline {base}, paired randomization on AP)")
    for model, sig in report["significance"].items():
        print(f"  {model}: ΔAP={sig['diff']:+.4f}  p={sig['p_value']:.4f}")


def _refuse(args) -> None:
    """Flags whose machinery waits for a later slice of the port."""
    pending = [
        ("--tune", args.tune, "autotune"),
        ("--tune-cache", args.tune_cache is not None, "autotune"),
        ("--bench", args.bench, "benchmark"),
    ]
    for flag, given, slice_name in pending:
        if given:
            raise SystemExit(f"{flag} waits for the {slice_name} slice of the port")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--experiment", default=None,
                    help=f"registered experiment: {sorted(exp_grid.EXPERIMENTS)}")
    ap.add_argument("--grid", action="append", default=[],
                    help='ad-hoc grid "base:param=v1|v2,..." (repeatable)')
    ap.add_argument("--out", default="results/experiments",
                    help="artifact dir (runs/, qrels.txt, ckpt/, report.json)")
    ap.add_argument("--device", default=None,
                    help="where the corpus lives and the scan runs (default: "
                         "cuda; cpu runs the kernels' plain PyTorch versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-docs", type=int, default=None)
    ap.add_argument("--n-queries", type=int, default=None)
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--chunk-size", type=int, default=None)
    ap.add_argument("--segment-chunks", type=int, default=None,
                    help="corpus chunks per checkpoint segment")
    ap.add_argument("--n-shards", type=int, default=None,
                    help="corpus scan shards, on the run's device (run files "
                         "are byte-identical at every shard count)")
    ap.add_argument("--fail-at-shard", type=int, default=0,
                    help="shard the injected failure fires on (testing)")
    ap.add_argument("--pipeline", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="overlapped scan executor: concurrent shards, "
                         "double-buffered segment prefetch, async checkpoints "
                         "(--no-pipeline = synchronous reference executor; "
                         "artifacts are byte-identical either way)")
    ap.add_argument("--max-workers", type=int, default=None,
                    help="cap the concurrent-shard thread pool (default: one "
                         "worker per device; two on one card run on two "
                         "CUDA streams)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="accepted for the reference's command lines; changes "
                         "nothing (on cuda the scan always runs the CUDA "
                         "kernel, on cpu its plain version)")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore existing segment checkpoints")
    ap.add_argument("--fail-at-segment", type=int, default=None,
                    help="deprecated alias: one crash after this segment "
                         "commits on --fail-at-shard (use --fault-spec)")
    ap.add_argument("--fault-spec", "--fault", action="append", default=[],
                    help='inject a fault "kind:key=val,..." (repeatable), e.g. '
                         '"crash:shard=1,segment=0,phase=pre_commit", '
                         '"straggler:shard=2,delay=0.01", '
                         '"writer_error:shard=0,segment=1", '
                         '"dead_worker:worker=0"')
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="derive a whole seeded chaos schedule (crashes × "
                         "stragglers × writer errors) from this seed")
    ap.add_argument("--max-retries", type=int, default=0,
                    help="re-run a failed shard from its last committed "
                         "segment checkpoint up to this many times")
    ap.add_argument("--speculative", action="store_true",
                    help="speculatively re-execute the slowest in-flight "
                         "shard when the work queue drains")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace_event JSON here (the JSONL "
                         "event log lands next to it). Default: "
                         "<out>/trace.json unless --no-trace")
    ap.add_argument("--no-trace", action="store_true",
                    help="disable tracing (metrics-only run)")
    ap.add_argument("--tune", action="store_true",
                    help="autotune winner cache (autotune slice)")
    ap.add_argument("--tune-cache", default=None,
                    help="autotune winner-cache path (autotune slice)")
    ap.add_argument("--tuning-config", default=None,
                    help="run under an explicit TuningConfig JSON file "
                         "(flat knob dict, see repro_torch.tune.save)")
    ap.add_argument("--token-pack", default=None,
                    choices=["none", "auto", "8", "16", "bitpack"],
                    help="packed corpus segments (core.packing): store scan "
                         "tokens at this width and decode on the consumer — "
                         "fewer bytes staged/streamed, run files byte-"
                         "identical to the unpacked run. Overrides the "
                         "tuning config's token_pack knob")
    ap.add_argument("--bench", action="store_true",
                    help="models-per-pass amortization curve (benchmark slice)")
    args = ap.parse_args(argv)
    if args.token_pack is not None and args.tune:
        raise SystemExit("--token-pack and --tune are mutually exclusive "
                         "(the cached winner already fixes token_pack)")
    _refuse(args)

    spec = _spec_from_args(args)
    out_dir = args.out if args.experiment is None else f"{args.out}/{spec.name}"
    trace_out = None
    if not args.no_trace:
        trace_out = args.trace_out or f"{out_dir}/trace.json"
    elif args.trace_out:
        raise SystemExit("--trace-out and --no-trace are mutually exclusive")

    faults = build_schedule(args.fault_spec) if args.fault_spec else None
    if args.fault_seed is not None:
        # schedule geometry from the job's own: segments per shard
        shard_rows = spec.n_docs // max(1, spec.n_shards)
        n_segments = max(1, shard_rows // (spec.chunk_size * spec.segment_chunks))
        seeded = FaultSchedule.random(
            args.fault_seed, n_shards=spec.n_shards, n_segments=n_segments
        )
        if faults is None:
            faults = seeded
        else:
            for s in seeded.specs:
                faults.add(s)
    tuning = tune.load(args.tuning_config) if args.tuning_config else None
    if args.token_pack is not None:
        base = tuning if tuning is not None else tune.TuningConfig()
        tuning = base.replace(token_pack=args.token_pack)

    coll = runner.prepare_collection(spec, seed=args.seed, device=args.device)
    report = runner.run_experiment(
        spec,
        out_dir=out_dir,
        seed=args.seed,
        resume=not args.no_resume,
        fail_at_segment=args.fail_at_segment,
        fail_at_shard=args.fail_at_shard,
        collection=coll,
        pipelined=args.pipeline,
        max_workers=args.max_workers,
        faults=faults,
        max_retries=args.max_retries,
        speculative=args.speculative,
        trace_out=trace_out,
        tuning=tuning,
        device=args.device,
    )
    print_report(report)
    print(f"wrote {out_dir}/report.json")


if __name__ == "__main__":
    main()
