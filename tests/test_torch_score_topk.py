"""The dense score + top-k of the port against the JAX reference's kernel.

On the CPU the port's `ops.score_topk` runs its plain PyTorch version; the
reference's `ops.score_topk` runs its Pallas kernel in interpret mode, as
the reference's own tests run it. Same numpy inputs, made from a seed,
through both: float32 scores within 1e-5 and bfloat16 within 2e-2 (the
reference's own tolerances, `tests/test_kernels.py`), ids equal except at
float near-ties (`_torch_parity`; the reference ranking is taken 8 places
deeper so that a near-tie across the k-th place shows). On integer-valued
inputs every product and sum is exact, and ids and score bits must be
equal. The CUDA kernel itself is held against the plain version on the
card by ``tests/test_torch_cuda.py`` (and by ``chip_smoke.py``).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_parity import assert_rankings_close
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro_torch import convert
from repro_torch.kernels import _build, ops, ref, score_topk

DEEPER = 8


def _rand(seed, shape, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _ref_kernel(q, d, k, block_d, merge="bitonic"):
    s, i = ref_ops.score_topk(jnp.asarray(q), jnp.asarray(d), k=k, block_d=block_d, merge=merge)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("nq,nd,dim", [(8, 256, 64), (16, 512, 128), (128, 1024, 256)])
@pytest.mark.parametrize("k", [5, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel(nq, nd, dim, k, dtype):
    q = _rand(nq * 7 + k, (nq, dim), dtype)
    d = _rand(nd * 3 + k, (nd, dim), dtype)
    tq, td = convert.vectors_from_numpy(q), convert.vectors_from_numpy(d)
    assert tq.dtype == td.dtype == getattr(torch, dtype)
    s, i = ops.score_topk(tq, td, k=k, block_d=128)
    assert s.dtype == torch.float32 and i.dtype == torch.int32 and s.shape == (nq, k)
    tol = 1e-5 if dtype == "float32" else 2e-2
    ws, wi = _ref_kernel(q, d, k + DEEPER, 128)
    assert_rankings_close(s, i, ws, wi, what=f"kernel {dtype}", tol=tol)
    # and the reference's unblocked oracle (lax.top_k over all scores)
    os_, oi = ref_oracles.score_topk_ref(jnp.asarray(q), jnp.asarray(d), k=k + DEEPER)
    assert_rankings_close(s, i, np.asarray(os_), np.asarray(oi), what=f"oracle {dtype}", tol=tol)
    # the re-export is the same function
    rs, ri = ref.score_topk_ref(tq, td, k=k, block_d=128)
    assert torch.equal(rs, s) and torch.equal(ri, i)


def test_concat_merge_equals_bitonic():
    q, d = _rand(1, (16, 64), "float32"), _rand(2, (512, 64), "float32")
    tq, td = torch.tensor(q), torch.tensor(d)
    s1, i1 = ops.score_topk(tq, td, k=12, block_d=64, merge="bitonic")
    s2, i2 = ops.score_topk(tq, td, k=12, block_d=64, merge="concat")
    assert torch.equal(i1, i2) and torch.equal(s1.view(torch.int32), s2.view(torch.int32))
    ws, wi = _ref_kernel(q, d, 12, 64, merge="concat")
    assert_rankings_close(s2, i2, ws, wi, what="concat")
    with pytest.raises(ValueError, match="unknown merge"):
        ops.score_topk(tq, td, k=12, block_d=64, merge="heap")


@pytest.mark.parametrize("nd,block_d,k", [(256, 64, 100), (64, 64, 100), (128, 32, 128)])
def test_k_above_block_and_corpus_leaves_sentinels(nd, block_d, k):
    q, d = _rand(3, (5, 32), "float32"), _rand(4, (nd, 32), "float32")
    s, i = ops.score_topk(torch.tensor(q), torch.tensor(d), k=k, block_d=block_d)
    ws, wi = _ref_kernel(q, d, k, block_d)
    assert_rankings_close(s, i, ws, wi, what=f"k={k} n_d={nd}")
    n_real = min(k, nd)
    assert (i[:, :n_real] >= 0).all() and torch.isfinite(s[:, :n_real]).all()
    assert (i[:, n_real:] == -1).all() and torch.isneginf(s[:, n_real:]).all()


def test_zero_query_rows_tie_toward_smaller_ids():
    """Pad rows of a served block are zero vectors: every document scores
    +-0.0, ties break toward the smaller id, and -0.0 equals +0.0."""
    q = _rand(5, (6, 64), "float32")
    q[[1, 4]] = 0.0
    d = _rand(6, (256, 64), "float32")
    s, i = ops.score_topk(torch.tensor(q), torch.tensor(d), k=20, block_d=64)
    ws, wi = _ref_kernel(q, d, 20 + DEEPER, 64)
    assert_rankings_close(s, i, ws, wi, what="zero rows")
    for row in (1, 4):
        assert torch.equal(i[row], torch.arange(20, dtype=torch.int32))
        assert (s[row] == 0.0).all()
        np.testing.assert_array_equal(i[row].numpy(), wi[row, :20])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_integer_valued_inputs_are_exact(dtype):
    """Entries in -3..3: every product and partial sum is an exact float32
    integer, so the ranking is the same to the bit, ties included."""
    rng = np.random.default_rng(7)
    q = rng.integers(-3, 4, size=(24, 64)).astype(np.float32)
    d = rng.integers(-3, 4, size=(512, 64)).astype(np.float32)
    if dtype == "bfloat16":
        q, d = q.astype(ml_dtypes.bfloat16), d.astype(ml_dtypes.bfloat16)
    s, i = ops.score_topk(convert.vectors_from_numpy(q), convert.vectors_from_numpy(d),
                          k=40, block_d=128)
    ws, wi = _ref_kernel(q, d, 40, 128)
    np.testing.assert_array_equal(i.numpy(), wi)
    np.testing.assert_array_equal(s.numpy().view(np.int32), ws.view(np.int32))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    q, d = torch.tensor(_rand(8, (4, 32), "float32")), torch.tensor(_rand(9, (128, 32), "float32"))
    before = dict(ops.LAUNCHES)
    got = ops.score_topk(q, d, k=7, block_d=32)
    want = score_topk.score_topk_ref(q, d, k=7, block_d=32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ops.LAUNCHES == before
    # block_d defaults to the active tuning's dense_block_d, else 1024
    from repro_torch import tune

    with tune.use(tune.TuningConfig(dense_block_d=64)):
        assert torch.equal(ops.score_topk(q, d, k=7)[1], want[1])
    with pytest.raises(ValueError, match="divisible"):
        ops.score_topk(q, d, k=7)  # 128 rows, block 1024


def test_wrapper_checks_its_arguments():
    q = torch.zeros((2, 8))
    d = torch.zeros((16, 8))
    with pytest.raises(TypeError, match="dtype"):
        ops.score_topk(q, d.to(torch.bfloat16), k=2, block_d=8)
    with pytest.raises(TypeError, match="dtype"):
        ops.score_topk(q.double(), d.double(), k=2, block_d=8)
    with pytest.raises(ValueError, match="contiguous"):
        ops.score_topk(q, torch.zeros((8, 16)).T, k=2, block_d=8)
    with pytest.raises(ValueError, match="divisible"):
        ops.score_topk(q, d, k=2, block_d=3)
    with pytest.raises(ValueError, match=r"\[n_q, dim\]"):
        ops.score_topk(q, torch.zeros((16, 4)), k=2, block_d=8)


def test_launch_geometry():
    geo = score_topk.launch_geometry(64, 256, 1 << 24, 1000, 16_384, 4)
    # 64 queries: one group, so one pass over the corpus; 32 x 4 rows a tile
    assert geo["n_groups"] == 1 and geo["group"] == 64 and geo["n_qp"] == 64
    assert geo["k_pad"] == 1024 and geo["tile_docs"] == 128 and geo["cap"] == 256
    assert geo["smem"] <= score_topk.SMEM_LIMIT and geo["stages"] >= 2
    assert geo["split_rows"] % 16_384 == 0 and geo["n_splits"] * geo["split_rows"] >= 1 << 24
    # one wave: as many CTAs as fit the card's 132 SMs at once, no more
    assert 0.9 * 132 <= geo["n_groups"] * geo["n_splits"] <= 132
    # every serving bucket in one group, within the shared memory, at any k
    for n_q in (8, 64, 128):
        for elem in (4, 2):
            for k in (1, 1000, score_topk.MAX_K):
                g = score_topk.launch_geometry(n_q, 256, 1 << 24, k, 16_384, elem)
                assert g["n_groups"] == 1 and g["smem"] <= score_topk.SMEM_LIMIT, (n_q, elem, k)
                assert g["n_qp"] == n_q and g["tile_docs"] * g["n_qp"] == 32 * 8 * min(32, n_q)
    # a block not a power of two pads to one (zero rows, scored and never kept)
    assert score_topk.launch_geometry(13, 256, 1 << 16, 1000, 1024, 4)["n_qp"] == 16
    # more than 128 queries: groups evened out, 200 = 2 x 100
    two = score_topk.launch_geometry(200, 256, 1 << 20, 1000, 1024, 4)
    assert (two["n_groups"], two["group"], two["n_qp"]) == (2, 100, 128)
    assert two["n_groups"] * two["n_splits"] <= 132
    with pytest.raises(ValueError, match="at most k"):
        score_topk.launch_geometry(1, 64, 64, score_topk.MAX_K + 1, 64, 4)
    with pytest.raises(ValueError, match="128 bytes"):
        score_topk.launch_geometry(1, 48, 64, 5, 64, 2)
    with pytest.raises(ValueError, match="do not fit"):
        score_topk.launch_geometry(1, 8192, 64, 8192, 64, 4)
    # a corpus of many small blocks still takes one split per SM
    assert score_topk.launch_geometry(1, 64, 1 << 20, 5, 8, 4)["n_splits"] == 132


def test_tf32_split_three_products():
    """The kernel's float32 scores are three TF32 products of a hi/lo split:
    within 1e-5 of the float32 product on normalised dim-256 rows, and equal
    to it wherever the values fit TF32 (integer-valued and bfloat16 rows)."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((16, 256)).astype(np.float32)
    d = rng.standard_normal((512, 256)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tq, td = torch.tensor(q), torch.tensor(d)
    hi, lo = score_topk.tf32_split(td)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((hi + lo - td).abs() <= 2.0**-21 * td.abs()).all()
    exact = torch.tensor(q.astype(np.float64) @ d.astype(np.float64).T)
    three = score_topk.split_tf32_dot(tq, td)
    assert (three.double() - exact).abs().max() <= 1e-5
    assert (three - tq @ td.T).abs().max() <= 1e-5
    # one TF32 product alone is not float32-accurate at these shapes
    assert (score_topk.tf32_split(tq)[0] @ hi.T - tq @ td.T).abs().max() > 1e-5
    # round to nearest, ties away from zero (cvt.rna)
    x = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-11 - 2.0**-23, 3.0])
    assert score_topk.tf32_split(x)[0].tolist() == [1 + 2.0**-10, -(1 + 2.0**-10), 1.0, 3.0]
    for rows in (rng.integers(-3, 4, size=(24, 256)).astype(np.float32),
                 rng.standard_normal((24, 256)).astype(ml_dtypes.bfloat16).astype(np.float32)):
        t = torch.tensor(rows)
        hi, lo = score_topk.tf32_split(t)
        assert torch.equal(hi, t) and not lo.any()
        assert torch.equal(score_topk.split_tf32_dot(t[:8], t), t[:8] @ t.T)


def test_threshold_key_order():
    """The kernels' 64-bit (score, id) key orders as (score desc, id asc)
    after ``sort_key``: ties break by id, -0.0 equals +0.0, -inf ranks last
    and an empty slot (-inf, -1) ahead of every real (-inf, id)."""
    from repro_torch.core.topk import sort_key

    rng = np.random.default_rng(13)
    pool = np.array([0.0, -0.0, 1.5, -1.5, 2.0**-130, -(2.0**-130), np.inf, -np.inf, 3.25e38,
                     -3.25e38, 1.0, 1.0 + 2.0**-23], dtype=np.float32)
    s = torch.tensor(rng.choice(pool, size=400))
    i = torch.tensor(rng.permutation(1 << 20)[:400], dtype=torch.int32)
    s[:3], i[:3] = float("-inf"), torch.tensor([-1, 0, 5], dtype=torch.int32)
    key = score_topk.pack_key(s, i)
    assert key.dtype == torch.int64 and len(set(key.tolist())) == len(key)
    by_key = torch.argsort(key, descending=True).tolist()
    want = sorted(range(len(s)), key=lambda j: (-float(sort_key(s[j])), int(i[j])))
    assert by_key == want
    assert score_topk.EMPTY_KEY == int(key[0])
    neg_inf = torch.isneginf(s)
    assert int(neg_inf.sum()) > 3 and (key[neg_inf][1:] < key[0]).all()
    assert (key[~neg_inf] > key[0]).all()
    # -0.0 and +0.0 share the score part of the key
    z = score_topk.pack_key(torch.tensor([0.0, -0.0]), torch.tensor([7, 7]))
    assert z[0] == z[1]


def test_vectors_from_numpy_carries_bf16_bits():
    x = _rand(10, (5, 16), "bfloat16")
    t = convert.vectors_from_numpy(x)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), x.view(np.int16))
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        convert.vectors_from_numpy(np.zeros((2, 2), np.float64))


def test_library_name_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edited shared header must rebuild every kernel that may include it."""
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "b.cu").write_text("// no include\n")
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.library_path(n) for n in ("a", "b")}
    assert before["a"] == _build.library_path("a")  # stable for the same bytes
    (tmp_path / "common.cuh").write_text("// v2\n")
    after = {n: _build.library_path(n) for n in ("a", "b")}
    assert all(after[n] != before[n] for n in ("a", "b"))
    (tmp_path / "extra.cuh").write_text("// new header\n")
    assert _build.library_path("a") != after["a"]
    assert _build.library_path("a").name.startswith("liba-")


def test_library_name_hashes_each_sources_flags(tmp_path, monkeypatch):
    """A change of one source's flags rebuilds that library and no other;
    the bit-exact lexical scan keeps --fmad=false; the dense kernel (tensor
    cores, nothing to contract) and the flash kernels may contract into FMAs."""
    assert "--fmad=false" in _build.flags("lexical_scan")
    for name in ("score_topk", "flash_attn", "flash_decode"):
        assert "--fmad=false" not in _build.flags(name)
        assert _build.flags(name)[: len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
    for name in ("a", "b"):
        (tmp_path / f"{name}.cu").write_text("// the same bytes\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setitem(_build.SOURCE_FLAGS, "a", ())
    monkeypatch.setitem(_build.SOURCE_FLAGS, "b", ())
    before = {n: _build.library_path(n) for n in ("a", "b")}
    monkeypatch.setitem(_build.SOURCE_FLAGS, "a", ("--fmad=false",))
    assert _build.library_path("a") != before["a"]
    assert _build.library_path("b") == before["b"]



@pytest.mark.parametrize("name", ["score_topk", "lexical_scan", "flash_attn", "flash_decode"])
def test_launch_signature_matches_source(name):
    """The ctypes parameter list of each kernel's C entry point is the one
    its source declares (a pointer for each ``void*``, a float for each
    ``float``, an int for each ``int``): ctypes cannot check it, and a short
    list fails only on the card."""
    import importlib
    import re

    src = (_build.CSRC / f"{name}.cu").read_text()
    params = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)', src).group(1)
    kinds = "".join("p" if "*" in p else "f" if "float" in p else "i" for p in params.split(","))
    module = importlib.import_module(f"repro_torch.kernels.{name}")
    assert kinds == module.LAUNCH_ARGS
    assert (module._launch.name, module._launch.spec) == (name, module.LAUNCH_ARGS)


def test_build_entry_types_calls_and_raises(monkeypatch):
    """`_build.Entry` types the entry point from its spec and its error
    string, passes the device's current stream after the arguments, and
    raises with the kernel's own error string on a nonzero return."""
    import ctypes
    from types import SimpleNamespace

    class Fn:
        def __init__(self, result):
            self.result, self.calls = result, []

        def __call__(self, *args):
            self.calls.append(args)
            return self.result(*args)

    rc = [0]
    lib = SimpleNamespace(k_launch=Fn(lambda *a: rc[0]),
                          k_error_string=Fn(lambda code: b"an illegal address"))
    loads = []
    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or lib)
    streams = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: streams.append(dev) or SimpleNamespace(cuda_stream=0xBEEF))
    entry = _build.Entry("k", "pifp")
    entry("cuda:1", 16, 3, 0.5)
    assert loads == ["k"] and streams == ["cuda:1"]
    assert lib.k_launch.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p]
    assert lib.k_launch.restype is ctypes.c_int
    assert lib.k_error_string.argtypes == [ctypes.c_int]
    assert lib.k_error_string.restype is ctypes.c_char_p
    assert lib.k_launch.calls == [(16, 3, 0.5, 0xBEEF)]
    rc[0] = 700
    with pytest.raises(RuntimeError, match=r"^k launch failed: CUDA error 700 "
                                           r"\(an illegal address\)$"):
        entry("cuda:1", 16, 3, 0.5)
    assert lib.k_error_string.calls == [(700,)]
    assert loads == ["k"]  # loaded and typed once
