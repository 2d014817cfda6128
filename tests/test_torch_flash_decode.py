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
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.flash_decode(q.to("meta"), kc.to("meta"), kc.to("meta"), 3)
    before = dict(ops.LAUNCHES)
    ops.flash_decode(q, kc, kc, 3)
    assert ops.LAUNCHES == before  # the CPU path launches nothing
    flash_decode.check_geometry(torch.bfloat16, 8, 4, 256, 512)  # gemma2-2b
    flash_decode.check_geometry(torch.bfloat16, 32, 8, 80, 512)  # h2o-danube
    with pytest.raises(ValueError, match="query heads per KV head"):
        flash_decode.check_geometry(torch.float32, 32, 2, 64, 512)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_decode.check_geometry(torch.bfloat16, 8, 4, 36, 512)
    with pytest.raises(ValueError, match="shared memory"):
        flash_decode.check_geometry(torch.float32, 64, 8, 256, 1 << 14)
