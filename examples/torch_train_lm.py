"""End-to-end driver on the PyTorch port: train a small LM with
checkpoint/restart, then decode from the trained weights.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300              # on the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20  # plain versions

The same run as ``examples/train_lm.py``: the gemma2-2b *architecture
family* scaled down (the same local/global attention, soft caps, GeGLU;
float32, head_dim 64, attention soft cap 50, window 128; ``--wide`` is the
~130M config), trained by `repro_torch.launch.train` with the cosine
schedule, step checkpoints and deterministic data, then 16 greedy tokens
through `make_serve_step`. Kill it mid-run and run the command again: it
resumes from its latest checkpoint. ``--fail-at-step N`` injects that
failure itself and then resumes in the same process. On the card the
training steps run the flash attention kernel's float32 route and the
decode the flash decode kernel.
"""

import argparse
import dataclasses
import json
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import rules_for_mesh
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.train import train
from repro_torch.models import transformer as tfm

_BASE = get_config("gemma2-2b")


def cfg_100m(wide: bool = False):
    """wide=True is the ~130M config (12 layers, d 768); the default is the
    same family at ~32M, so a few hundred steps finish in minutes on a host."""
    if wide:
        return dataclasses.replace(
            _BASE,
            n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
            d_ff=3072, vocab=16384, sliding_window=256,
            dtype="float32", remat_chunk=1, grad_accum=1, opt_dtype="float32",
            q_block=64,
        )
    return dataclasses.replace(
        _BASE,
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab=8192, sliding_window=128,
        dtype="float32", remat_chunk=1, grad_accum=1, opt_dtype="float32",
        q_block=64,
    )


def train_with_restart(cfg, dev, *, steps: int, ckpt_dir: str, ckpt_every: int,
                       fail_at_step: int | None = None) -> tuple[dict, int | None]:
    """Train ``cfg`` through the driver; an injected failure is followed by
    the resume from the latest checkpoint. -> (the driver's result, the step
    the resume started from or None)."""
    kw = dict(steps=steps, batch=8, seq=256, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
              lr=3e-3, seed=0, device=dev)
    try:
        return train(cfg, fail_at_step=fail_at_step, **kw), None
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
        print(f"{e}: resuming")
        out = train(cfg, **kw)
        return out, out["history"][0]["step"] if out["history"] else steps


def decode(cfg, params, dev, n: int = 16, feed=None) -> tuple[list[int], list[torch.Tensor]]:
    """``n`` greedy tokens from token 1 through `make_serve_step` (a
    64-slot cache); step ``i`` takes ``feed[i - 1]`` instead of its own
    previous argmax when ``feed`` is given. -> (the tokens, each step's
    logits)."""
    mesh = make_test_mesh(1, 1, device=dev)
    ctx = tfm.make_context(cfg, mesh, rules_for_mesh(mesh), tokens_per_shard=1)
    serve = tfm.make_serve_step(ctx, batch=1)
    cache = tfm.init_cache(cfg, 1, 64, device=dev)
    tok = torch.tensor([1], dtype=torch.int32, device=dev)
    t = torch.zeros((), dtype=torch.int32, device=dev)
    tokens, logits_seen = [], []
    with torch.no_grad():
        for i in range(n):
            logits, cache = serve(params, cache, tok, t)
            logits_seen.append(logits)
            tokens.append(int(torch.argmax(logits, -1)[0]))
            nxt = tokens[-1] if feed is None else feed[i]
            tok = torch.tensor([nxt], dtype=torch.int32, device=dev)
            t.add_(1)
    return tokens, logits_seen


def main(argv=None) -> dict:
    """Train, resume, decode. -> the printed summary, plus ``"params"``,
    the trained weights (not printed)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_100m_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--wide", action="store_true", help="the ~130M config")
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs the kernels' plain PyTorch versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = cfg_100m(args.wide)
    print(f"training {cfg.name}-100m: {cfg.param_count() / 1e6:.0f}M params, "
          f"{args.steps} steps on {dev}")
    out, resumed_from = train_with_restart(cfg, dev, steps=args.steps, ckpt_dir=args.ckpt_dir,
                                           ckpt_every=args.ckpt_every,
                                           fail_at_step=args.fail_at_step)
    hist = out["history"]
    for h in hist[:: max(len(hist) // 10, 1)]:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}")
    if hist:
        print(f"final loss: {out['final_loss']:.4f} (from {hist[0]['loss']:.4f})")

    print("== decode 16 tokens from the trained model ==")
    out_toks, _ = decode(cfg, out["params"], dev)
    print(f"greedy tokens: {out_toks}")
    summary = {"steps": len(hist), "resumed_from": resumed_from,
               "first_loss": hist[0]["loss"] if hist else None,
               "final_loss": out["final_loss"], "greedy_tokens": out_toks}
    print(json.dumps(summary))
    return {**summary, "params": out["params"]}


if __name__ == "__main__":
    main()
