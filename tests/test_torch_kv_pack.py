"""The port's KV-page pack/unpack against the reference's, on the CPU.

On CPU tensors the port's wrappers run their plain versions (`pool[idx]`
and `pool[idx] = buf`); the Hopper kernels are held against those plain
versions on the card by `chip_smoke.py`. The reference's wrappers run
their Pallas kernels in interpret mode here. Pools and indices are made
with numpy from a seed and cross as the same values; bf16 is compared
through its 16-bit patterns. The bar is the reference's own: bit-exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kv_pack import kv_pack as ref_kv_pack
from repro.kernels.kv_pack import kv_unpack as ref_kv_unpack
from repro_torch.kernels.kv_pack import kv_pack, kv_pack_ref, kv_unpack, kv_unpack_ref
from repro_torch.kernels.kv_pack import kernel as kv_kernel

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the reference's kernel-test shapes (tests/test_kernels.py), and a ragged row
SHAPES = [(32, 16, 128, 8), (64, 8, 256, 64), (40, 5, 3, 9)]


def _pool(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _indices(seed, pages, n):
    return np.random.default_rng(seed).permutation(pages)[:n].astype(np.int32)


def _bits(x) -> np.ndarray:
    """The raw bit patterns of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pages,page,dim,n", SHAPES)
def test_pack_matches_reference_kernel(dtype, pages, page, dim, n):
    jpool, tpool = _pool(0, (pages, page, dim), dtype)
    idx = _indices(1, pages, n)
    want = ref_kv_pack(jpool, jnp.asarray(idx))
    before = kv_kernel.pack_launches
    got = kv_pack(tpool, torch.from_numpy(idx))
    assert kv_kernel.pack_launches == before  # the CPU path launches nothing
    assert got.dtype == tpool.dtype and tuple(got.shape) == (n, page, dim)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pages,page,dim,n", SHAPES)
def test_unpack_matches_reference_kernel(dtype, pages, page, dim, n):
    jpool, tpool = _pool(2, (pages, page, dim), dtype)
    jbuf, tbuf = _pool(3, (n, page, dim), dtype)
    idx = _indices(4, pages, n)
    want = ref_kv_unpack(jpool.copy(), jbuf, jnp.asarray(idx))
    before = kv_kernel.unpack_launches
    got = kv_unpack(tpool, tbuf, torch.from_numpy(idx))
    assert kv_kernel.unpack_launches == before
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_roundtrip_matches_reference(dtype):
    """The reference's round trip: pack four pages, unpack them into zeros."""
    jpool, tpool = _pool(5, (16, 8, 128), dtype)
    idx = np.array([3, 7, 1, 9], np.int32)
    jrest = ref_kv_unpack(jnp.zeros_like(jpool), ref_kv_pack(jpool, jnp.asarray(idx)),
                          jnp.asarray(idx))
    trest = kv_unpack(torch.zeros_like(tpool), kv_pack(tpool, idx), idx)
    np.testing.assert_array_equal(_bits(trest), _bits(jrest))
    np.testing.assert_array_equal(_bits(trest[idx]), _bits(tpool[idx]))


@pytest.mark.parametrize("n", [1, 64])
def test_single_page_and_full_reversal(n):
    """n=1, and every page of the pool in reverse order."""
    jpool, tpool = _pool(6, (64, 8, 256), "float32")
    idx = np.arange(63, 63 - n, -1, dtype=np.int32)
    np.testing.assert_array_equal(_bits(kv_pack(tpool, idx)),
                                  _bits(ref_kv_pack(jpool, jnp.asarray(idx))))
    if n == 64:
        assert torch.equal(kv_pack(tpool, idx), tpool.flip(0))


def test_unpack_writes_in_place():
    """`kv_unpack` updates the pool it is given and returns that tensor;
    pages it does not name keep their bytes."""
    _, pool = _pool(7, (32, 16, 128), "bfloat16")
    _, buf = _pool(8, (8, 16, 128), "bfloat16")
    idx = _indices(9, 32, 8)
    before = pool.clone()
    ptr = pool.data_ptr()
    out = kv_unpack(pool, buf, idx)
    assert out is pool and out.data_ptr() == ptr
    assert torch.equal(pool[idx], buf)
    rest = np.setdiff1d(np.arange(32), idx)
    np.testing.assert_array_equal(_bits(pool[rest]), _bits(before[rest]))


@pytest.mark.parametrize("kind", ["int32", "int64", "numpy", "list"])
def test_index_forms_agree(kind):
    _, pool = _pool(10, (16, 4, 8), "float32")
    idx = [5, 0, 11, 3]
    forms = {"int32": torch.tensor(idx, dtype=torch.int32),
             "int64": torch.tensor(idx, dtype=torch.int64),
             "numpy": np.asarray(idx, np.int64), "list": idx}
    assert torch.equal(kv_pack(pool, forms[kind]), pool[torch.tensor(idx)])


@pytest.mark.parametrize("bad,err", [([1, 4, 1], ValueError), ([0, 16], IndexError),
                                     ([-1, 2], IndexError)])
def test_repeated_and_out_of_range_indices_raise(bad, err):
    """A page named twice raises ValueError and an index outside the pool
    raises IndexError, for pack and unpack alike, before anything moves."""
    _, pool = _pool(11, (16, 4, 8), "float32")
    _, buf = _pool(12, (len(bad), 4, 8), "float32")
    before = pool.clone()
    with pytest.raises(err):
        kv_pack(pool, bad)
    with pytest.raises(err):
        kv_unpack(pool, buf, np.asarray(bad))
    assert torch.equal(pool, before)


def test_empty_index_list():
    _, pool = _pool(13, (8, 4, 8), "float32")
    assert tuple(kv_pack(pool, []).shape) == (0, 4, 8)
    assert kv_unpack(pool, pool[:0], []) is pool


def test_kernel_entry_refuses_cpu_tensors():
    """The kernel's own entry takes CUDA tensors only; the CPU path is the
    wrapper's, never a fallback."""
    _, pool = _pool(14, (8, 4, 8), "float32")
    idx = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kv_kernel.kv_pack(pool, idx)
    with pytest.raises(ValueError, match="CUDA"):
        kv_kernel.kv_unpack(pool, pool[:2].clone(), idx)


def test_twins_are_registered():
    assert kv_kernel.__torch_twins__ == {"kv_pack": kv_pack_ref, "kv_unpack": kv_unpack_ref}
