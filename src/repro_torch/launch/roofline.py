"""Roofline of one H100 for every (arch × shape) cell, from the dry-run's
JSONs (the port's copy of `repro.launch.roofline`).

    compute    = Σ_class counted FLOPs_per_device[class] / peak[class]
    memory     = counted HBM bytes_per_device / HBM rate
    collective = Σ_kind ring traffic(kind) / link rate(group)

The counts come from `launch.opcount` (every op a cell's step runs on
``meta`` tensors, the kernels at their own costs), not from an HLO parse.
Ring formulas per collective kind with the recorded group size n, as the
reference's: all-reduce 2(n-1)/n·B, all-gather (n-1)/n·B_out,
reduce-scatter (n-1)·B_out, all-to-all (n-1)/n·B, collective-permute B.

MODEL_FLOPS is the *useful* work, with the reference's arithmetic: 6·N·T
for LM training, 2·N·T for inference, analytic per-family formulas
otherwise. The MODEL/counted ratio shows remat's recompute and padding.

The peaks are one H100 SXM's (700 W), each from its data sheet:

* bf16 / fp16 dense tensor cores 989e12 FLOP/s, TF32 495e12 (NVIDIA H100
  Tensor Core GPU data sheet, SXM column, without sparsity);
* FP32 on the CUDA cores: 128 FMAs a clock an SM for compute capability
  9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput), 2
  operations each, × 132 SMs × 1.98 GHz boost;
* ``other`` (integer ops; the lexical kernel's lookups and compares): the
  INT32 rate, 64 a clock an SM (same table) × 132 × 1.98 GHz;
* HBM3 3.35e12 B/s (data sheet);
* NVLink 450 GB/s a direction a card (900 GB/s total, data sheet) within a
  group of up to 8 cards (one HGX board); beyond, a 400 Gb/s NIC a card
  (50 GB/s).

Usage: ``PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh 1]``
writes ``results/roofline_torch_<mesh>.md`` and ``.json``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

PEAKS = {
    "bf16": 989e12,
    "tf32": 495e12,
    "f32": 128 * 2 * 132 * 1.98e9,
    "other": 64 * 132 * 1.98e9,
}
HBM_BW = 3.35e12
NVLINK_BW = 450e9
NVLINK_GROUP = 8
NIC_BW = 50e9

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results")


def link_bw(group: int) -> float:
    """Bytes a second a card sends to a group of ``group`` cards."""
    return NVLINK_BW if group <= NVLINK_GROUP else NIC_BW


def collective_time(hlo: dict) -> float:
    t = 0.0
    groups = hlo.get("collective_group_sizes", {})
    for kind, bytes_ in hlo.get("collective_bytes", {}).items():
        n = max(groups.get(kind, 2), 2)
        if kind == "all-reduce":
            eff = 2 * (n - 1) / n * bytes_
        elif kind == "all-gather":
            eff = (n - 1) / n * bytes_
        elif kind == "reduce-scatter":
            eff = (n - 1) * bytes_  # recorded bytes are the scattered output
        elif kind == "all-to-all":
            eff = (n - 1) / n * bytes_
        else:  # collective-permute
            eff = bytes_
        t += eff / link_bw(n)
    return t


def compute_time(hlo: dict) -> float:
    """Each dtype class's FLOPs at its own peak."""
    by_class = hlo.get("flops_by_class") or {"bf16": hlo["flops"]}
    return sum(n / PEAKS[c] for c, n in by_class.items())


def bound(hlo: dict) -> dict:
    """The three terms of one count, the largest (the bound) and its name."""
    terms = {"compute": compute_time(hlo), "memory": hlo["bytes_accessed"] / HBM_BW,
             "collective": collective_time(hlo)}
    dom = max(terms, key=terms.get)
    return {"compute_s": terms["compute"], "memory_s": terms["memory"],
            "collective_s": terms["collective"], "bound_s": terms[dom], "bottleneck": dom}


# ---------------------------------------------------------------------------
# MODEL_FLOPS (useful work) per family
# ---------------------------------------------------------------------------

def _lm_model_flops(arch: str, shape: str, n_devices: int) -> float:
    from repro_torch.configs import get_config, shapes_for

    cfg = get_config(arch)
    spec = shapes_for(arch)[shape]
    b, s = spec.dims["global_batch"], spec.dims["seq_len"]
    n_active = cfg.active_param_count()
    l, h, hd = cfg.n_layers, cfg.n_heads, cfg.hd
    if spec.kind == "train":
        tokens = b * s
        attn = 12 * l * b * s * s * h * hd  # fwd 4·L·B·S²·H·hd, ×3 fwd+bwd
        return (6 * n_active * tokens + attn) / n_devices
    if spec.kind == "prefill":
        tokens = b * s
        attn = 4 * l * b * s * s * h * hd / 2  # causal half
        return (2 * n_active * tokens + attn) / n_devices
    # decode: one token over an S-long cache
    attn = 4 * l * b * s * h * hd
    return (2 * n_active * b + attn) / n_devices


def _gnn_model_flops(arch: str, shape: str, n_devices: int) -> float:
    from repro_torch.configs import get_config, shapes_for

    cfg = get_config(arch)
    spec = shapes_for(arch)[shape]
    d = cfg.d_hidden
    a = (1 + len(cfg.aggregators) * len(cfg.scalers)) * d
    dims = spec.dims
    if spec.kind == "full_graph":
        n, e, f = dims["n_nodes"], dims["n_edges"], dims["d_feat"]
        per_layer = 2 * e * (2 * d * d) + 2 * n * (a * d)
        fwd = 2 * n * f * d + cfg.n_layers * per_layer + 2 * n * d * dims["n_classes"]
        return 3 * fwd / n_devices  # train step
    if spec.kind == "minibatch":
        bsz = dims["batch_nodes"]
        k1, k2 = dims["fanout"]
        f = dims["d_feat"]
        n_tree = bsz * (1 + k1 + k1 * k2)
        fwd = 2 * n_tree * f * d + 2 * (bsz * k1 * k2 + bsz * k1) * 2 * d * d \
            + 2 * (bsz + bsz * k1) * a * d
        return 3 * fwd / n_devices
    bsz, n, e, f = dims["batch"], dims["n_nodes"], dims["n_edges"], dims["d_feat"]
    per_layer = 2 * e * 2 * d * d + 2 * n * a * d
    fwd = bsz * (2 * n * f * d + cfg.n_layers * per_layer)
    return 3 * fwd / n_devices


def _recsys_model_flops(arch: str, shape: str, n_devices: int) -> float:
    from repro_torch.configs import get_config, shapes_for

    cfg = get_config(arch)
    spec = shapes_for(arch)[shape]
    d = cfg.embed_dim
    dims = spec.dims

    def fwd_per_example() -> float:
        if cfg.variant == "fm":
            return 4.0 * cfg.n_sparse * d
        if cfg.variant == "dcn-v2":
            x0 = cfg.n_dense + cfg.n_sparse * d
            cross = cfg.n_cross_layers * 2 * x0 * x0
            mlp_dims = (x0, *cfg.mlp_dims, 1)
            mlp = sum(2 * a * b for a, b in zip(mlp_dims[:-1], mlp_dims[1:]))
            return cross + mlp
        if cfg.variant == "mind":
            l = cfg.seq_len
            return 2 * l * d * d + cfg.capsule_iters * 4 * l * cfg.n_interests * d
        # sasrec
        l = cfg.seq_len
        per_blk = 8 * l * d * d + 4 * l * l * d + 16 * l * d * d
        return cfg.n_blocks * per_blk

    if spec.kind == "rec_train":
        return 3 * dims["batch"] * fwd_per_example() / n_devices
    if spec.kind == "rec_serve":
        return dims["batch"] * fwd_per_example() / n_devices
    # retrieval: per-candidate score
    n_c = dims["n_candidates"]
    if cfg.variant == "dcn-v2":
        return n_c * fwd_per_example() / n_devices
    if cfg.variant == "mind":
        return 2.0 * n_c * cfg.n_interests * d / n_devices
    return 2.0 * n_c * d / n_devices


def _mirex_model_flops(arch: str, shape: str, n_devices: int) -> float:
    from repro_torch.configs import get_config, shapes_for

    cfg = get_config(arch)
    spec = shapes_for(arch)[shape]
    dims = spec.dims
    if spec.kind == "dense_scan":
        return 2.0 * dims["n_queries"] * dims["n_docs"] * dims["dim"] / n_devices
    # lexical scan: 1 "op" per (query-term, doc-token) comparison
    return (
        dims["n_queries"] * cfg.max_q_len * dims["n_docs"] * dims["doc_len"] / n_devices
    )


def model_flops(arch: str, shape: str, n_devices: int) -> float:
    from repro_torch.configs import family

    return {
        "lm": _lm_model_flops,
        "gnn": _gnn_model_flops,
        "recsys": _recsys_model_flops,
        "mirex": _mirex_model_flops,
    }[family(arch)](arch, shape, n_devices)


# ---------------------------------------------------------------------------

FIX_HINTS = {
    "compute": "raise the useful-FLOP share (MODEL/counted): a lighter remat policy, fused "
               "CUDA kernels that drop recompute and masked-block waste, bf16 products on "
               "the tensor cores",
    "memory": "fuse the streaming hot loop into one CUDA kernel that keeps its working set "
              "in shared memory and registers (on this cell most bytes are re-read "
              "activations and float32 elementwise passes)",
    "collective": "shrink or overlap the dominant collective: bf16 payloads, reduce-scatter "
                  "in place of all-reduce, groups within one NVLink board, overlap with "
                  "compute on a second stream",
}


def analyze(mesh: str = "1") -> list[dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(RESULTS, "dryrun_torch", mesh, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if not r.get("ok"):
            continue
        hlo = r["hlo"]
        b = bound(hlo)
        mf = model_flops(r["arch"], r["shape"], r["n_devices"])
        rows.append({
            "arch": r["arch"],
            "shape": r["shape"],
            "mesh": mesh,
            **b,
            "model_flops_per_dev": mf,
            "counted_flops_per_dev": hlo["flops"],
            "useful_ratio": mf / hlo["flops"] if hlo["flops"] else float("nan"),
            "roofline_fraction": mf / PEAKS["bf16"] / b["bound_s"] if b["bound_s"] > 0 else 0.0,
            "peak_gb": r["memory"]["peak_bytes"] / 1e9,
            "fits_h100": r["memory"]["fits_h100"],
            "hint": FIX_HINTS[b["bottleneck"]],
        })
    return rows


def emit(rows: list[dict], mesh: str) -> str:
    os.makedirs(RESULTS, exist_ok=True)
    with open(os.path.join(RESULTS, f"roofline_torch_{mesh}.json"), "w") as f:
        json.dump(rows, f, indent=1)
    lines = [
        f"### Roofline — {mesh} mesh (per device; one H100 SXM: 989 TF/s bf16, "
        f"3.35 TB/s HBM, NVLink 450 GB/s to 8 cards, 50 GB/s beyond)",
        "",
        "| arch | shape | compute (s) | memory (s) | collective (s) | bottleneck | "
        "MODEL/counted | roofline frac | peak GB (fits 80 GB) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | **{r['bottleneck']}** | {r['useful_ratio']:.2f} "
            f"| {r['roofline_fraction']:.2%} | {r['peak_gb']:.1f} "
            f"({'yes' if r['fits_h100'] else 'no'}) |"
        )
    md = "\n".join(lines) + "\n"
    with open(os.path.join(RESULTS, f"roofline_torch_{mesh}.md"), "w") as f:
        f.write(md)
    return md


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1", choices=("1", "16x16", "2x16x16"))
    args = ap.parse_args(argv)
    print(emit(analyze(args.mesh), args.mesh))


if __name__ == "__main__":
    main()
