"""Fault-tolerant training driver (the port's copy of `repro.launch.train`).

    # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b --steps 20
    # on the CPU (the kernels' plain PyTorch versions)
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch fm --steps 10

The reference's contract:

* step checkpoints (atomic rename commits, `repro_torch.checkpoint`), in the
  reference's layout: ``{"params", "opt", "ef"}``, so either package resumes
  the other's;
* restart-safe data: a batch is a pure function of the step
  (`repro_torch.data.loader.ShardedBatchLoader`), so a resumed run gives the
  uninterrupted run's bytes;
* failure injection: ``--fail-at-step N`` raises before step ``N``;
* optional error-feedback gradient compression (``--grad-compress
  {topk,sign}``, `repro_torch.optim.compress`).

It trains any LM arch (the reduced config by default; ``--full`` takes the
published one) and the recsys archs on any mesh (``mesh=``; the reference's
``(1, 1)`` by default). On a larger mesh the loader cuts each batch into
the ``dp`` shards' rows on their devices; the step gathers them onto the
first shard's device, where the forward runs, and the LM loss runs each
``dp`` and ``tp`` shard's part (`models.transformer.make_loss_fn`).
``--grad-compress`` follows the reference's layout: its compressor's
``shard_map`` takes the gradient and the residual replicated, so every
``dp`` shard compresses the same global gradient with the same residual,
and their mean is that one part: the port compresses it once, and ``ef``
stays one tree in the checkpoint's layout. A step reads the host once:
``float(metrics["loss"])``. TF32 stays off (PyTorch's default), so float32
runs on the card hold to the CPU's. `train` does not train the GNN (nor
does the reference's): its steps are :func:`make_train_step` over
:func:`build_gnn`'s loss at ``GNN_LR``, as the reference's cells build
them.

Same flags as `repro.launch.train` plus ``--device`` (default ``cuda``;
without a card and without ``--device cpu`` it raises instead of running on
the CPU).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import GNNConfig, RecsysConfig, TransformerConfig
from repro_torch.data import synthetic
from repro_torch.data.loader import ShardedBatchLoader
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import all_gather_parts, rules_for_mesh
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import compress
from repro_torch.optim.adamw import (
    adamw_init, adamw_update, cosine_schedule, tree_leaves, tree_map,
)


def build_lm(cfg: TransformerConfig, mesh, rules, *, batch: int, seq: int, seed: int):
    ctx = tfm.make_context(cfg, mesh, rules, tokens_per_shard=batch * seq)
    loss_fn = tfm.make_loss_fn(ctx, chunk=min(256, seq))

    def make_batch(step: int):
        return synthetic.make_lm_batch(
            batch=batch, seq_len=seq, vocab=cfg.vocab, seed=seed, chunk=step
        )

    def init(generator, device):
        return tfm.init_params(cfg, generator, device=device)

    return loss_fn, make_batch, init


def build_recsys(cfg: RecsysConfig, mesh, rules, *, batch: int, seed: int):
    def loss_fn(params, b):
        loss = recsys_lib.train_logits(params, b, cfg)
        return loss, {"loss": loss}

    if cfg.variant in ("fm", "dcn-v2"):
        def make_batch(step: int):
            return synthetic.make_recsys_batch(
                batch=batch, n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
                vocab_per_field=cfg.vocab_per_field, seed=seed, chunk=step,
            )
    else:
        def make_batch(step: int):
            return synthetic.make_item_sequences(
                batch=batch, seq_len=max(cfg.seq_len, 12), n_items=cfg.n_items,
                seed=seed, chunk=step,
            )

    def init(generator, device):
        return recsys_lib.init_params(cfg, generator, device=device)

    return loss_fn, make_batch, init


# the cells' schedule (the reference's `launch/cells.py:68`)
GNN_LR = cosine_schedule(3e-4, warmup=100, total=10_000)


def build_gnn(cfg: GNNConfig, kind: str, mesh=None, rules=None):
    """The loss of a GNN cell, ``loss_fn(params, batch) -> (loss, {"loss"})``,
    as the reference's cells build it (`launch/cells.py:201-236`) for the
    shape kinds of `configs.shapes.GNN_SHAPES`:

    * ``"full_graph"``: ``make_sharded_full_graph(mesh, rules, cfg)``
      (bucketed) over ``x [N, F]``, bucketed ``src`` / ``dst``, ``labels [N]``;
    * ``"minibatch"``: ``forward_sampled`` over ``seed_x``, ``hop1_x``,
      ``hop2_x`` (`data.sampler.sample_batch`'s), ``labels [B]``;
    * ``"batched_graphs"``: ``forward_batched_graphs`` over ``x [B, N, F]``,
      ``src`` / ``dst [B, E]``, ``labels [B]``.
    """
    if kind == "full_graph":
        fwd = gnn_lib.make_sharded_full_graph(mesh, rules, cfg)

        def logits(params, b):
            return fwd(params, b["x"], b["src"], b["dst"])
    elif kind == "minibatch":
        def logits(params, b):
            return gnn_lib.forward_sampled(params, b["seed_x"], b["hop1_x"], b["hop2_x"], cfg)
    elif kind == "batched_graphs":
        def logits(params, b):
            return gnn_lib.forward_batched_graphs(params, b["x"], b["src"], b["dst"], cfg)
    else:
        raise ValueError(f"unknown GNN shape kind {kind!r}")

    def loss_fn(params, b):
        loss = gnn_lib.xent_loss(logits(params, b), b["labels"])
        return loss, {"loss": loss}

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)`` with
    respect to every parameter leaf (a leaf the loss does not reach gets
    zeros), as ``jax.value_and_grad(..., has_aux=True)``."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    it = iter(grads)
    tree = _rebuild(params, it)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), tree


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def accumulated_grad(loss_fn, params, batch, accum_steps: int):
    """:func:`value_and_grad` over ``accum_steps`` microbatches (each leaf
    of ``batch`` cut on its first dim), as the reference's scan: the
    gradients summed in the parameters' dtype, then divided in float32;
    the metrics averaged."""
    if accum_steps == 1:
        return value_and_grad(loss_fn, params, batch)
    total, history = None, []
    for i in range(accum_steps):
        micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps, *v.shape[1:])[i]
                 for k, v in batch.items()}
        (_, m), g = value_and_grad(loss_fn, params, micro)
        total = g if total is None else tree_map(lambda a, b: a + b.to(a.dtype), total, g)
        history.append(m)
    grads = tree_map(lambda g: (g.float() / accum_steps).to(g.dtype), total)
    metrics = {k: torch.stack([m[k] for m in history]).mean() for k in history[0]}
    return (metrics["loss"], metrics), grads


def make_train_step(loss_fn, schedule, grad_compress: str | None = None,
                    accum_steps: int = 1):
    """``step(params, opt, ef, batch) -> (params, opt, ef, metrics)``: the
    gradient (over ``accum_steps`` microbatches, :func:`accumulated_grad`),
    the compressed reduction when asked for, the AdamW update (parameters
    and moments updated in place)."""
    compressor = {
        None: None,
        "topk": lambda g, ef: compress.topk_allreduce(g, ef, ("data",), frac=0.05),
        "sign": lambda g, ef: compress.sign_allreduce(g, ef, ("data",)),
    }[grad_compress]

    def train_step(params, opt, ef, b):
        (_, metrics), g = accumulated_grad(loss_fn, params, b, accum_steps)
        if compressor is not None:
            g, ef = compressor(g, ef)
        params, opt, gnorm = adamw_update(g, opt, params, lr=schedule)
        return params, opt, ef, {**metrics, "gnorm": gnorm}

    return train_step


def gathered_batch(loader: ShardedBatchLoader, step: int) -> dict:
    """Step ``step``'s batch: the ``dp`` shards' rows (`ShardedBatchLoader`)
    joined in shard order on the first shard's device (an all-gather; no
    copy for one shard)."""
    shards = loader.shards(step)
    return {k: all_gather_parts([sh[k] for sh in shards], 0) for k in shards[0]}


def train(
    arch: str | TransformerConfig | RecsysConfig = "h2o-danube-1.8b",
    *,
    steps: int = 20,
    batch: int = 8,
    seq: int = 64,
    ckpt_dir: str | None = None,
    ckpt_every: int = 5,
    resume: bool = True,
    fail_at_step: int | None = None,
    reduced: bool = True,
    mesh=None,
    lr: float = 1e-3,
    grad_compress: str | None = None,
    seed: int = 0,
    device=None,
) -> dict:
    """Train ``arch`` for ``steps`` steps on ``device`` (default ``cuda``):
    a registry name (its reduced config unless ``reduced=False``) or a
    config object, trained as given. Returns ``{"history", "params", "opt", "ef", "final_loss"}``: each
    history entry ``{"step", "loss", "dt"}`` (``dt`` the step's host seconds,
    ending at the loss's read)."""
    device = resolve_device(device)
    if isinstance(arch, str):
        cfg = reduced_config(arch) if reduced else get_config(arch)
    else:
        cfg = arch
    mesh = mesh or make_test_mesh(1, 1, device=device)
    device = mesh.devices.flat[0]
    rules = rules_for_mesh(mesh)

    if isinstance(cfg, TransformerConfig):
        loss_fn, make_batch, init = build_lm(cfg, mesh, rules, batch=batch, seq=seq, seed=seed)
    elif isinstance(cfg, RecsysConfig):
        loss_fn, make_batch, init = build_recsys(cfg, mesh, rules, batch=batch, seed=seed)
    else:
        raise ValueError(f"train driver supports lm/recsys archs, got {cfg.name}")

    schedule = cosine_schedule(lr, warmup=max(steps // 10, 1), total=steps)
    train_step = make_train_step(loss_fn, schedule, grad_compress)

    def fresh():
        params = init(torch.Generator(device=device).manual_seed(seed), device)
        opt = adamw_init(params, getattr(torch, getattr(cfg, "opt_dtype", "float32")))
        ef = (compress.ef_init(params) if grad_compress
              else torch.zeros((), dtype=torch.float32, device=device))
        return params, opt, ef

    loader = ShardedBatchLoader(mesh, rules.dp, make_batch)
    start_step = 0
    params, opt, ef = fresh()
    if ckpt_dir and resume:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            tree = ckpt.restore(ckpt_dir, latest, {"params": params, "opt": opt, "ef": ef},
                                device=device)
            params, opt, ef = tree["params"], tree["opt"], tree["ef"]
            start_step = latest

    history = []
    try:
        for step in range(start_step, steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            b = gathered_batch(loader, step)
            t0 = time.time()
            params, opt, ef, metrics = train_step(params, opt, ef, b)
            loss = float(metrics["loss"])
            history.append({"step": step, "loss": loss, "dt": time.time() - t0})
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                ckpt.save(ckpt_dir, step + 1, {"params": params, "opt": opt, "ef": ef})
    finally:
        loader.close()
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, {"params": params, "opt": opt, "ef": ef})
    params = tree_map(lambda p: p.detach().requires_grad_(False), params)
    return {"history": history, "params": params, "opt": opt, "ef": ef,
            "final_loss": history[-1]["loss"] if history else None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--grad-compress", choices=("topk", "sign"), default=None)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    out = train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, fail_at_step=args.fail_at_step,
        reduced=not args.full, grad_compress=args.grad_compress, device=args.device,
    )
    for h in out["history"][-5:]:
        print(f"step {h['step']:4d}  loss {h['loss']:.4f}  {h['dt']*1e3:.0f} ms")
    return out


if __name__ == "__main__":
    main()
