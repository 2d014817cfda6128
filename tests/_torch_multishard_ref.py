"""The JAX reference's multi-shard functions on four faked host devices, for
the port's multi-shard parity tests (run as a script, in a process of its
own: the device count is fixed when JAX starts). Importing it imports no JAX
and sets nothing: the tests read its constants.

    python tests/_torch_multishard_ref.py {loss|decode|train} OUT.npz

Each mesh is ``jax.make_mesh(shape, ("data", "model"))`` with ``Auto`` axes
entered by ``jax.set_mesh`` (the reference's ``make_test_mesh`` builds
``Explicit`` axes, under which its LM functions fail on this JAX). Every
input comes from a seed, as the tests make them; the parameters each case
starts from are written beside the results, so the port starts from the
same numbers.
"""

import os
import sys

import numpy as np

MESHES = ((2, 2), (4, 1), (1, 4))
# (arch, MoE mode of the loss's context)
LOSS_CASES = (("gemma2-2b", "train"), ("h2o-danube-1.8b", "train"),
              ("qwen3-moe-30b-a3b", "train"), ("qwen3-moe-30b-a3b", "seq"))
LOSS_B, LOSS_S, LOSS_CHUNK = 4, 32, 16
DECODE_ARCHS = ("gemma2-2b", "h2o-danube-1.8b", "qwen3-moe-30b-a3b")
# 32 slots: 8 a shard on 4 shards, 16 on 2. t = 0 (no cached position), 5
# (inside the first shard), 8 and 16 (a shard's first slot), 13 (the
# reduced window of 8 spans two shards), 31 (the last slot)
DECODE_SLOTS, DECODE_TS = 32, (0, 5, 8, 13, 16, 31)
TRAIN_STEPS, TRAIN_B, TRAIN_S = 3, 8, 32
TRAIN_CASES = tuple((mesh, arch, comp) for mesh in MESHES
                    for arch, comp in (("h2o-danube-1.8b", None), ("h2o-danube-1.8b", "topk"),
                                       ("h2o-danube-1.8b", "sign"), ("fm", None)))


def make_mesh(shape):
    import jax

    return jax.make_mesh(shape, ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)


def mesh_key(shape) -> str:
    return "x".join(map(str, shape))


def lm_params(cfg, seed=0):
    """The reference's init with every norm scale perturbed (the gemma ones
    init at 0), as the port's LM tests make them."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as tfm

    params = tfm.init_params(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    for name in ("attn_norm", "ffn_norm"):
        params["layers"][name] = jnp.asarray(
            rng.normal(0.5, 0.1, params["layers"][name].shape).astype(np.float32))
    params["final_norm"] = jnp.asarray(
        rng.normal(0.5, 0.1, params["final_norm"].shape).astype(np.float32))
    return params


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, np.asarray(tree))]


def decode_cache(cfg, batch: int, seed: int = 11) -> dict:
    shape = (cfg.n_layers, batch, DECODE_SLOTS, cfg.n_kv_heads, cfg.hd)
    rng = np.random.default_rng(seed)
    return {n: rng.normal(0, 1, shape).astype(np.float32) for n in ("k", "v")}


def run_loss(out: dict) -> None:
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.data import synthetic
    from repro.distributed.sharding import rules_for_mesh
    from repro.models import transformer as tfm

    for arch, mode in LOSS_CASES:
        cfg = configs.reduced_config(arch)
        params = lm_params(cfg)
        for name, x in leaves(params):
            out[f"params/{arch}{name}"] = x
        batch = synthetic.make_lm_batch(batch=LOSS_B, seq_len=LOSS_S, vocab=cfg.vocab, seed=3)
        for shape in MESHES:
            mesh = make_mesh(shape)
            with jax.set_mesh(mesh):
                ctx = tfm.make_context(cfg, mesh, rules_for_mesh(mesh),
                                       tokens_per_shard=LOSS_B * LOSS_S, moe_mode=mode)
                fn = jax.jit(jax.value_and_grad(tfm.make_loss_fn(ctx, chunk=LOSS_CHUNK),
                                                has_aux=True))
                (_, metrics), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
            key = f"{arch}/{mode}/{mesh_key(shape)}"
            out[f"loss/{key}"] = np.asarray(metrics["loss"])
            out[f"aux/{key}"] = np.asarray(metrics["aux"])
            for name, g in leaves(grads):
                out[f"grad/{key}{name}"] = g


def run_decode(out: dict) -> None:
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.distributed.sharding import rules_for_mesh
    from repro.models import transformer as tfm

    for arch in DECODE_ARCHS:
        cfg = configs.reduced_config(arch)
        params = lm_params(cfg)
        for name, x in leaves(params):
            out[f"params/{arch}{name}"] = x
        for batch in (1, 4):
            first = np.random.default_rng(batch).integers(0, cfg.vocab, batch).astype(np.int32)
            for shape in MESHES:
                mesh = make_mesh(shape)
                with jax.set_mesh(mesh):
                    ctx = tfm.make_context(cfg, mesh, rules_for_mesh(mesh),
                                           tokens_per_shard=batch,
                                           moe_mode="train" if batch > 1 else "replicated")
                    step = jax.jit(tfm.make_serve_step(ctx, batch=batch))
                    cache = {k: jnp.asarray(v) for k, v in decode_cache(cfg, batch).items()}
                    tok = jnp.asarray(first)
                    key = f"{arch}/{batch}/{mesh_key(shape)}"
                    for i, t in enumerate(DECODE_TS):
                        out[f"fed/{key}/{i}"] = np.asarray(tok)
                        logits, cache = step(params, cache, tok, jnp.asarray(t, jnp.int32))
                        out[f"logits/{key}/{i}"] = np.asarray(logits)
                        tok = jnp.argmax(logits, -1).astype(jnp.int32)
                    out[f"cache/{key}"] = np.asarray(cache["k"])


def run_train(out: dict) -> None:
    import jax

    from repro import configs
    from repro.launch import train as train_lib
    from repro.models import recsys
    from repro.models import transformer as tfm

    for shape, arch, comp in TRAIN_CASES:
        cfg = configs.reduced_config(arch)
        init = (recsys.init_params(cfg, jax.random.key(0)) if arch == "fm"
                else tfm.init_params(cfg, jax.random.key(0)))
        for name, x in leaves(init):
            out[f"params/{arch}{name}"] = x
        res = train_lib.train(arch, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                              mesh=make_mesh(shape), grad_compress=comp)
        key = f"{arch}/{comp}/{mesh_key(shape)}"
        out[f"losses/{key}"] = np.asarray([h["loss"] for h in res["history"]])
        for name, x in leaves(res["params"]):
            out[f"final/{key}{name}"] = x


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    what, path = sys.argv[1], sys.argv[2]
    results: dict = {}
    {"loss": run_loss, "decode": run_decode, "train": run_train}[what](results)
    np.savez(path, **results)
    print("ok", len(results))
