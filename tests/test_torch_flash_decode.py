"""Split-KV flash decode of the port against the JAX reference's kernel.

On the CPU the port's `ops.flash_decode` runs its plain PyTorch version;
the reference's `ops.flash_decode` runs its Pallas kernel in interpret
mode and `repro.kernels.ref` holds its oracle. Same numpy inputs, made from
a seed, through all three: the reference's sweep (`tests/test_kernels.py`)
within float32 3e-4 / 3e-5, plus soft caps, bfloat16 (3e-2), gemma2-2b's
head_dim 256 and h2o-danube's 80 under two block sizes. The CUDA kernel
itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` (and by ``chip_smoke.py``).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro_torch import convert
from repro_torch.kernels import flash_decode, ops, ref

F32_TOL = {"rtol": 3e-4, "atol": 3e-5}
BF16_TOL = {"rtol": 3e-2, "atol": 3e-2}


def _rand(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _all(q, kc, vc, t, *, block_s, **kw):
    mine = ops.flash_decode(*(convert.vectors_from_numpy(x) for x in (q, kc, vc)), t,
                            block_s=block_s, **kw)
    pallas = ref_ops.flash_decode(*(jnp.asarray(x) for x in (q, kc, vc)), jnp.asarray(t),
                                  block_s=block_s, **kw)
    oracle = ref_oracles.flash_decode_ref(*(jnp.asarray(x) for x in (q, kc, vc)), t, **kw)
    return (mine.float().numpy(), np.asarray(pallas, np.float32), np.asarray(oracle, np.float32))


@pytest.mark.parametrize("s,kv,g,t", [(512, 2, 2, 300), (1024, 4, 1, 1023), (512, 1, 8, 0)])
@pytest.mark.parametrize("window", [None, 128])
def test_flash_decode_sweep_matches_reference(s, kv, g, t, window):
    rng = np.random.default_rng(0)
    b, hd = 2, 32
    q = _rand(rng, (b, kv * g, hd), "float32")
    kc = _rand(rng, (b, s, kv, hd), "float32")
    vc = _rand(rng, (b, s, kv, hd), "float32")
    mine, pallas, oracle = _all(q, kc, vc, t, window=window, block_s=128)
    np.testing.assert_allclose(mine, pallas, **F32_TOL)
    np.testing.assert_allclose(mine, oracle, **F32_TOL)


@pytest.mark.parametrize("hd,kv,g", [(256, 4, 2), (80, 8, 4)])
@pytest.mark.parametrize("block_s", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_model_head_dims_caps_and_blocks(hd, kv, g, block_s, dtype):
    rng = np.random.default_rng(hd + block_s)
    s, t = 512, 400
    q = _rand(rng, (2, kv * g, hd), dtype)
    kc = _rand(rng, (2, s, kv, hd), dtype)
    vc = _rand(rng, (2, s, kv, hd), dtype)
    mine, pallas, oracle = _all(q, kc, vc, t, window=200, cap=50.0, block_s=block_s)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(mine, pallas, **tol)
    np.testing.assert_allclose(mine, oracle, **tol)


def test_flash_decode_positions_and_cache_length():
    """The port reads only positions <= t, so a cache whose length is not a
    multiple of block_s is fine; t outside the cache raises."""
    rng = np.random.default_rng(1)
    q = torch.tensor(_rand(rng, (2, 4, 32), "float32"))
    kc = torch.tensor(_rand(rng, (2, 40, 2, 32), "float32"))
    vc = torch.tensor(_rand(rng, (2, 40, 2, 32), "float32"))
    got = ops.flash_decode(q, kc, vc, 37, window=8, cap=30.0)
    want = ref_oracles.flash_decode_ref(jnp.asarray(q.numpy()), jnp.asarray(kc.numpy()),
                                        jnp.asarray(vc.numpy()), 37, window=8, cap=30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # what lies past t never matters
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, 38:] = 1e4
    vc2[:, 38:] = float("nan")
    assert torch.equal(ops.flash_decode(q, kc2, vc2, torch.tensor(37), window=8, cap=30.0), got)
    for t in (40, -1):
        with pytest.raises(ValueError, match="outside a cache"):
            ops.flash_decode(q, kc, vc, t)
    assert flash_decode.allowed_range(37, 8) == (30, 37)
    assert flash_decode.allowed_range(5, 8) == (0, 5)
    assert flash_decode.allowed_range(5, None) == (0, 5)
    assert ref.flash_decode_ref is flash_decode.flash_decode_ref


def test_flash_decode_wrapper_and_kernel_checks():
    q = torch.zeros((2, 4, 32))
    kc = torch.zeros((2, 64, 2, 32))
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_decode(q.to(torch.bfloat16), kc, kc, 3)
    with pytest.raises(ValueError, match="KV dividing"):
        ops.flash_decode(torch.zeros((2, 5, 32)), kc, kc, 3)
    before = dict(ops.LAUNCHES)
    # meta tensors launch nothing: an output of q's shape and dtype, no data
    for t in (3, torch.tensor(3, dtype=torch.int32, device="meta")):
        out = ops.flash_decode(q.to("meta"), kc.to("meta"), kc.to("meta"), t)
        assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    with pytest.raises(ValueError, match="outside a cache"):
        ops.flash_decode(q.to("meta"), kc.to("meta"), kc.to("meta"), 64)
    assert ops.LAUNCHES == before
    ops.flash_decode(q, kc, kc, 3)
    assert ops.LAUNCHES == before  # the CPU path launches nothing
    flash_decode.check_geometry(torch.bfloat16, 8, 4, 256, 512)  # gemma2-2b
    flash_decode.check_geometry(torch.bfloat16, 32, 8, 80, 512)  # h2o-danube
    with pytest.raises(ValueError, match="query heads per KV head"):
        flash_decode.check_geometry(torch.float32, 32, 2, 64, 512)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_decode.check_geometry(torch.bfloat16, 8, 4, 36, 512)
    # the split size no longer sizes shared memory; it must be whole rounds
    flash_decode.check_geometry(torch.float32, 64, 8, 256, 1 << 14)
    with pytest.raises(ValueError, match="block_s"):
        flash_decode.check_geometry(torch.float32, 64, 8, 256, 1000)


SPLIT_EDGE = flash_decode.split_plan(512, None, 2 * 2, 132, 128)[0]  # a split edge on an H100


@pytest.mark.parametrize("t", [0, SPLIT_EDGE - 1, SPLIT_EDGE, 511])
@pytest.mark.parametrize("window", [None, 5, SPLIT_EDGE + 3])
def test_flash_decode_scalar_tensor_t_matches_host_int_and_reference(t, window):
    """``t`` as a 0-d int32 tensor: the same result as the host int, and the
    reference's Pallas kernel given ``jnp.int32(t)`` (interpret mode) and
    oracle within float32's 3e-4 / 3e-5, at 0, both sides of a split edge
    and the last slot, windows narrower than one split and across one."""
    rng = np.random.default_rng(t + 7 * (window or 0))
    b, s, kv, g, hd = 2, 512, 2, 2, 32
    q = _rand(rng, (b, kv * g, hd), "float32")
    kc = _rand(rng, (b, s, kv, hd), "float32")
    vc = _rand(rng, (b, s, kv, hd), "float32")
    args = [convert.vectors_from_numpy(x) for x in (q, kc, vc)]
    mine = ops.flash_decode(*args, torch.tensor(t, dtype=torch.int32), window=window, cap=30.0)
    host = ops.flash_decode(*args, t, window=window, cap=30.0)
    assert torch.equal(mine, host)
    pallas = ref_ops.flash_decode(*(jnp.asarray(x) for x in (q, kc, vc)), jnp.int32(t),
                                  window=window, cap=30.0, block_s=128)
    oracle = ref_oracles.flash_decode_ref(*(jnp.asarray(x) for x in (q, kc, vc)), t,
                                          window=window, cap=30.0)
    np.testing.assert_allclose(mine.numpy(), np.asarray(pallas), **F32_TOL)
    np.testing.assert_allclose(mine.numpy(), np.asarray(oracle), **F32_TOL)


@pytest.mark.parametrize("s,window,pairs,n_sm,max_block", [
    (8704, None, 16, 132, 512), (8704, 4096, 16, 132, 512), (1100, None, 8, 132, 512),
    (1100, 512, 8, 132, 256), (512, 128, 4, 132, 128), (40, 8, 4, 132, 512),
    (700, 300, 16, 132, 256), (300, 1, 2, 132, 512), (5000, None, 1, 132, 16),
])
def test_flash_decode_split_plan_covers_the_allowed_range_once(s, window, pairs, n_sm,
                                                               max_block):
    """For every t of the cache, the launch's splits take [lo, t] exactly
    once, and the ones that hold positions are the first n_active (those
    the last CTA merges), with n_active <= n_splits; the plan aims at a few
    CTAs per SM and never passes max_block unless MAX_SPLITS forces it."""
    block, n = flash_decode.split_plan(s, window, pairs, n_sm, max_block)
    assert block % flash_decode.SPLIT_ALIGN == 0 and 1 <= n <= flash_decode.MAX_SPLITS
    floor = -(-s // flash_decode.MAX_SPLITS)  # positions per split MAX_SPLITS forces
    assert block <= max(max_block, -(-floor // flash_decode.SPLIT_ALIGN) * flash_decode.SPLIT_ALIGN)
    for t in range(s):
        lo, _ = flash_decode.allowed_range(t, window)
        ranges = flash_decode.split_ranges(t, window, block, n)
        full = [(a, e) for a, e in ranges if e > a]
        n_active = t // block - lo // block + 1
        assert ranges[:n_active] == full and len(full) == n_active <= n, t
        covered = [p for a, e in full for p in range(a, e)]
        assert covered == list(range(lo, t + 1)), t


def test_flash_decode_shared_memory_budget():
    """The rings (4 warps x 3 stages x 4 positions of K and V), reused for the
    warps' states and the last CTA's split weights: 48 KiB at gemma2-2b's
    bfloat16 head_dim 256, 96 KiB in float32, under the kernel's 128 KiB
    permission (the H100 allows 227 KiB) at every G <= 8 and head_dim <= 256."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert flash_decode.smem_bytes(2, 256, bf16, 33) == 48 * 1024
    assert flash_decode.smem_bytes(2, 256, f32, 33) == 96 * 1024
    assert flash_decode.smem_bytes(8, 32, bf16, 1024) == 4 * (1024 * 8 + 8)  # the weights
    for g in range(1, flash_decode.MAX_G + 1):
        for dtype in (bf16, f32):
            need = flash_decode.smem_bytes(g, 256, dtype, flash_decode.MAX_SPLITS)
            assert need <= flash_decode.SMEM_LIMIT


def test_flash_decode_t_must_be_an_integer():
    q = torch.zeros((2, 4, 32))
    kc = torch.zeros((2, 64, 2, 32))
    for bad in (torch.tensor(3.0), torch.tensor([3, 4]), torch.tensor(True)):
        with pytest.raises(TypeError, match="t must be"):
            ops.flash_decode(q, kc, kc, bad)
    for t in (torch.tensor(64, dtype=torch.int32), torch.tensor([-1])):
        with pytest.raises(ValueError, match="outside a cache"):
            ops.flash_decode(q, kc, kc, t)

