"""Dry-run: build every (architecture × input shape) cell on a mesh of
``meta`` devices, run its step under the op counter, and record whether it
fits the card and what bounds it (the port's copy of `repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all                 # one H100
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 16x16

The reference lowers and compiles each cell for 512 placeholder host
devices and parses the HLO; the port runs each cell's step on ``meta``
tensors (shapes, no data) under `launch.opcount.OpCounter`, which sees
every op, so no compile, no device-count flag and no process a cell is
needed: ``--all`` runs the cells one after another in this process, or
spread over ``--workers`` processes. The
meshes are ``1`` (one H100, the default), ``16x16`` and ``2x16x16``. No
kernel launches and nothing is allocated on a card.

Each cell's JSON goes to ``results/dryrun_torch/<mesh>/<arch>__<shape>.json``:
the counter's per-device figures (``hlo``, keyed as the reference's parse),
the peak live bytes against the card's memory (``memory.fits_h100``), the
build and count seconds, and for a cell the port cannot build yet ``ok:
false`` with the error, as the reference records a failed cell and carries
on. ``--all`` skips cells already ``ok`` on disk unless ``--force``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch")

# one H100 SXM's HBM3, the data sheet's 80 GB as 80e9 bytes (the card
# reports 79.1 GiB, 8.5e10 bytes: this limit errs on the small side)
HBM_PER_CARD = 80 * 10**9


def run_cell(arch: str, shape: str, mesh_name: str = "1") -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch import opcount
    from repro_torch.launch.cells import build_cell, meta_mesh
    from repro_torch.obs import counting

    before = dict(ops.LAUNCHES)
    mesh = meta_mesh(mesh_name)
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_name, "n_devices": mesh.size,
                 "ok": False}
    t0 = time.time()
    cell = build_cell(arch, shape, mesh)
    t_build = time.time()
    with opcount.OpCounter(mesh.size) as counter:
        counter.track(cell.abstract_inputs)
        cell.fn(*cell.abstract_inputs)
    t_count = time.time()
    hlo = counter.result()
    args = sum(counting.tensor_bytes(t) for t in counting.tensors_of(cell.abstract_inputs))
    rec["memory"] = {"argument_bytes": args / mesh.size, "peak_bytes": hlo["peak_bytes"],
                     "fits_h100": hlo["peak_bytes"] <= HBM_PER_CARD}
    rec["hlo"] = hlo
    rec["note"] = cell.note
    rec["timing_s"] = {"build": t_build - t0, "count": t_count - t_build}
    # kernel launches in this run (none: a meta tensor launches nothing)
    rec["launches"] = {k: ops.LAUNCHES[k] - before[k] for k in before}
    rec["ok"] = True
    return rec


def result_path(arch: str, shape: str, mesh_name: str = "1") -> str:
    d = os.path.join(RESULTS_DIR, mesh_name)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{shape}.json")


def run_and_save(arch: str, shape: str, mesh_name: str = "1") -> dict:
    path = result_path(arch, shape, mesh_name)
    t0 = time.time()
    try:
        rec = run_cell(arch, shape, mesh_name)
    except Exception as e:  # noqa: BLE001 — recorded, the sweep goes on
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "ok": False,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:],
               "timing_s": {"build_and_count": time.time() - t0}}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _heavy_first(cell: tuple[str, str]) -> int:
    """Sort key putting the cells that run longest first (a training step
    and a full graph on a mesh run the most ops), so parallel workers end
    together."""
    from repro_torch.configs import shapes_for

    return 0 if shapes_for(cell[0])[cell[1]].kind in ("train", "full_graph") else 1


def sweep(meshes=("1",), *, force: bool = False, include_mirex: bool = True,
          quiet: bool = False, workers: int = 1) -> list[dict]:
    """Every cell on each mesh of ``meshes`` (skipping cached successes
    unless ``force``); returns each run's record. ``workers > 1`` runs the
    cells in that many processes, heaviest first (host work only: an op on
    ``meta`` takes 50–800 µs on one core, and the GNN's full-graph training
    steps on the 16x16 mesh run each of 256 shards' bodies, about a minute
    each on one core)."""
    from repro_torch.configs import all_cells

    todo, recs = [], []
    for mesh_name in meshes:
        for arch, shape in all_cells(include_mirex=include_mirex):
            path = result_path(arch, shape, mesh_name)
            if not force and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        if not quiet:
                            print(f"[cached] {mesh_name} {arch} × {shape}")
                        continue
            todo.append((arch, shape, mesh_name))

    def report(rec, seconds):
        recs.append(rec)
        if not quiet:
            print(f"[{'ok' if rec['ok'] else 'FAIL':6s}] {rec['mesh']} {rec['arch']} × "
                  f"{rec['shape']}  ({seconds:.1f}s)", flush=True)

    t0 = time.time()
    if workers > 1:
        import concurrent.futures
        import multiprocessing

        todo.sort(key=lambda c: _heavy_first(c[:2]))
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            futures = [pool.submit(run_and_save, *cell) for cell in todo]
            for fut in concurrent.futures.as_completed(futures):
                report(fut.result(), time.time() - t0)
        recs.sort(key=lambda r: todo.index((r["arch"], r["shape"], r["mesh"])))
    else:
        for cell in todo:
            t1 = time.time()
            report(run_and_save(*cell), time.time() - t1)
    return recs


def orchestrate(mesh_name: str = "1", *, force: bool = False, include_mirex: bool = True,
                quiet: bool = False, workers: int = 1) -> list:
    """Run every cell on one mesh (skipping cached successes); returns the
    failures as ``(arch, shape, error)``."""
    failures = [(r["arch"], r["shape"], r["error"])
                for r in sweep((mesh_name,), force=force, include_mirex=include_mirex,
                               quiet=quiet, workers=workers) if not r["ok"]]
    if failures and not quiet:
        print(f"\n{len(failures)} FAILURES:")
        for a, s, e in failures:
            print(f"  {a} × {s}: {e}")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="1", choices=("1", "16x16", "2x16x16"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes for --all (host work on meta; default 1)")
    args = ap.parse_args(argv)
    if args.all:
        fails = orchestrate(args.mesh, force=args.force, workers=args.workers)
        sys.exit(1 if fails else 0)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    rec = run_and_save(args.arch, args.shape, args.mesh)
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"}, indent=1))
    if rec["ok"]:
        print(f"memory per device: {rec['memory']['peak_bytes'] / 2**30:.2f} GiB "
              f"(fits the H100's 80 GB: {rec['memory']['fits_h100']})")
    sys.exit(0 if rec["ok"] else 1)


if __name__ == "__main__":
    main()
