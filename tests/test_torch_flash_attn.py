"""Flash attention of the port against the JAX reference's kernel.

On the CPU the port's `ops.flash_attention` runs its plain PyTorch version;
the reference's `ops.flash_attention` runs its Pallas kernel in interpret
mode, as the reference's own tests run it, and `repro.kernels.ref` holds
its full-matrix oracle. Same numpy inputs, made from a seed, through all
three: the reference's sweep (`tests/test_kernels.py`) within its own
tolerances, float32 3e-4 / 3e-5 and bfloat16 3e-2, plus gemma2-2b's
head_dim 256 and h2o-danube's 80 under two block geometries. The CUDA
kernel itself is held against the plain version on the card by
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
from repro_torch.kernels import flash_attn, ops, ref

F32_TOL = {"rtol": 3e-4, "atol": 3e-5}
BF16_TOL = {"rtol": 3e-2, "atol": 3e-2}


def _rand(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _both(q, k, v, **kw):
    """(port on the CPU, reference Pallas kernel, reference oracle), as float32 numpy."""
    mine = ops.flash_attention(*(convert.vectors_from_numpy(x) for x in (q, k, v)), **kw)
    blocks = {n: kw.pop(n) for n in ("block_q", "block_k") if n in kw}
    pallas = ref_ops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), **kw, **blocks)
    oracle = ref_oracles.flash_attention_ref(*(jnp.asarray(x) for x in (q, k, v)), **kw)
    return (mine.float().numpy(), np.asarray(pallas, np.float32), np.asarray(oracle, np.float32))


@pytest.mark.parametrize("s,h,kv,hd", [(128, 4, 4, 32), (256, 4, 2, 64), (256, 8, 1, 32)])
@pytest.mark.parametrize("window,cap", [(None, None), (64, None), (None, 30.0), (32, 50.0)])
def test_flash_attention_sweep_matches_reference(s, h, kv, hd, window, cap):
    rng = np.random.default_rng(0)
    b = 2
    q = _rand(rng, (b, s, h, hd), "float32")
    k = _rand(rng, (b, s, kv, hd), "float32")
    v = _rand(rng, (b, s, kv, hd), "float32")
    mine, pallas, oracle = _both(q, k, v, causal=True, window=window, cap=cap,
                                 block_q=64, block_k=64)
    np.testing.assert_allclose(mine, pallas, **F32_TOL)
    np.testing.assert_allclose(mine, oracle, **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_dtypes_match_reference(dtype):
    rng = np.random.default_rng(0)
    q = _rand(rng, (1, 128, 4, 32), dtype)
    k = _rand(rng, (1, 128, 2, 32), dtype)
    v = _rand(rng, (1, 128, 2, 32), dtype)
    mine, pallas, oracle = _both(q, k, v, block_q=64, block_k=64)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(mine, pallas, **tol)
    np.testing.assert_allclose(mine, oracle, **tol)


@pytest.mark.parametrize("hd,h,kv", [(256, 8, 4), (80, 8, 2)])
@pytest.mark.parametrize("blocks", [(64, 64), (128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_model_head_dims_and_blocks(hd, h, kv, blocks, dtype):
    rng = np.random.default_rng(hd + blocks[0])
    s = 256
    q = _rand(rng, (1, s, h, hd), dtype)
    k = _rand(rng, (1, s, kv, hd), dtype)
    v = _rand(rng, (1, s, kv, hd), dtype)
    mine, pallas, oracle = _both(q, k, v, causal=True, window=96, cap=50.0,
                                 block_q=blocks[0], block_k=blocks[1])
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(mine, pallas, **tol)
    np.testing.assert_allclose(mine, oracle, **tol)


def test_flash_attention_not_causal_and_plain_version_exports():
    rng = np.random.default_rng(3)
    q = _rand(rng, (2, 128, 4, 32), "float32")
    k = _rand(rng, (2, 128, 2, 32), "float32")
    v = _rand(rng, (2, 128, 2, 32), "float32")
    mine, pallas, oracle = _both(q, k, v, causal=False, window=40, block_q=64, block_k=64)
    np.testing.assert_allclose(mine, pallas, **F32_TOL)
    np.testing.assert_allclose(mine, oracle, **F32_TOL)
    assert ref.flash_attention_ref is flash_attn.flash_attention_ref
    # the plain version's row chunk only bounds memory: a longer sequence
    # than one chunk gives the same rows as the reference's oracle
    q2 = _rand(rng, (1, flash_attn.ROW_CHUNK * 2, 2, 16), "float32")
    k2 = _rand(rng, (1, flash_attn.ROW_CHUNK * 2, 1, 16), "float32")
    got = flash_attn.flash_attention_ref(torch.tensor(q2), torch.tensor(k2), torch.tensor(k2),
                                         window=300, cap=20.0)
    want = ref_oracles.flash_attention_ref(jnp.asarray(q2), jnp.asarray(k2), jnp.asarray(k2),
                                           window=300, cap=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_flash_attention_wrapper_checks():
    q = torch.zeros((1, 128, 4, 32))
    k = torch.zeros((1, 128, 2, 32))
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q, k.to(torch.bfloat16), k)
    with pytest.raises(ValueError, match="not divisible"):
        ops.flash_attention(q, k, k, block_q=96, block_k=64)
    with pytest.raises(ValueError, match="KV dividing H"):
        ops.flash_attention(q, torch.zeros((1, 128, 3, 32)), torch.zeros((1, 128, 3, 32)))
    before = dict(ops.LAUNCHES)
    # meta tensors launch nothing: an output of q's shape and dtype, no data
    out = ops.flash_attention(*(t.to("meta") for t in (q, k, k)), block_q=64, block_k=64)
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    with pytest.raises(ValueError, match="not divisible"):
        ops.flash_attention(*(t.to("meta") for t in (q, k, k)), block_q=96, block_k=64)
    assert ops.LAUNCHES == before
    ops.flash_attention(q, k, k, block_q=64, block_k=64)
    assert ops.LAUNCHES == before  # the CPU path launches nothing


def test_flash_attention_kernel_geometry_checks():
    bf16, f32 = torch.bfloat16, torch.float32
    flash_attn.check_geometry(bf16, 8192, 256, 128, 128)  # the default tile at gemma2-2b
    assert flash_attn.smem_bytes(128, 128, 256) == 202_752 <= flash_attn.SMEM_LIMIT
    flash_attn.check_geometry(bf16, 256, 80, 64, 64)
    flash_attn.check_geometry(f32, 256, 256, 128, 128)
    # the mma.sync route (head_dim 32 / 80) still tiles by block_q x block_k
    with pytest.raises(ValueError, match="shared memory"):
        flash_attn.check_geometry(bf16, 1024, 80, 128, 1024)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attn.check_geometry(bf16, 256, 96, 64, 64)
    with pytest.raises(ValueError, match="multiple of 64"):
        flash_attn.check_geometry(bf16, 256, 32, 64, 32)
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_attn.check_geometry(bf16, 256, 80, 256, 64)
    with pytest.raises(ValueError, match="multiple of 4"):
        flash_attn.check_geometry(f32, 256, 18, 64, 64)
    # the wgmma route's tile is its own: block_q / block_k only divide S
    flash_attn.check_geometry(bf16, 256, 64, 64, 32)
    flash_attn.check_geometry(bf16, 512, 256, 128, 256)
    with pytest.raises(ValueError, match="not divisible"):
        flash_attn.check_geometry(bf16, 200, 128, 64, 64)


@pytest.mark.parametrize("hd,want", [(64, "wgmma"), (128, "wgmma"), (256, "wgmma"),
                                     (32, "mma"), (80, "mma")])
def test_flash_attention_route_by_head_dim_alone(hd, want):
    """bfloat16 picks its kernel by head_dim alone; float32 always takes the
    CUDA-core kernel; a head_dim no route is built for raises."""
    assert flash_attn.route(torch.bfloat16, hd) == want
    assert flash_attn.route(torch.float32, hd) == "f32"
    assert flash_attn.BF16_HEAD_DIMS == (32, 64, 80, 128, 256)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attn.route(torch.bfloat16, hd + 8)
    with pytest.raises(TypeError, match="dtype"):
        flash_attn.route(torch.float16, hd)


def test_flash_attention_wgmma_shared_memory_budget():
    """Q for 128 rows, two stages of K and V, 9 mbarriers and 1024 bytes of
    alignment slack, under the 232,448 bytes a block may use: 192 KiB of
    tiles at head_dim 256 (64-key tiles), 160 KiB at 128 and 80 KiB at 64
    (128-key tiles)."""
    assert [flash_attn.wgmma_block_k(hd) for hd in (64, 128, 256)] == [128, 128, 64]
    tiles = {64: 80 * 1024, 128: 160 * 1024, 256: 192 * 1024}
    for hd, want in tiles.items():
        assert flash_attn.wgmma_smem_bytes(hd) == want + 9 * 8 + 1024 <= flash_attn.SMEM_LIMIT


@pytest.mark.parametrize("hd,s,causal,window", [(64, 128, False, 70), (128, 64, True, None),
                                                (256, 128, True, 100)])
def test_flash_attention_wgmma_route_shapes_match_reference(hd, s, causal, window):
    """Shapes the wgmma route meets on the card (one 128-row block, S under
    one block, no causal mask, windows across its 64- and 128-key tiles):
    the plain version against the reference, bfloat16."""
    rng = np.random.default_rng(hd + s)
    q = _rand(rng, (1, s, 4, hd), "bfloat16")
    k = _rand(rng, (1, s, 2, hd), "bfloat16")
    v = _rand(rng, (1, s, 2, hd), "bfloat16")
    mine, pallas, oracle = _both(q, k, v, causal=causal, window=window, cap=50.0,
                                 block_q=64, block_k=64)
    np.testing.assert_allclose(mine, pallas, **BF16_TOL)
    np.testing.assert_allclose(mine, oracle, **BF16_TOL)
