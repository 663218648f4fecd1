"""The port's flash attention against the reference's, on the CPU.

On CPU tensors the port's wrapper runs its plain version; the Hopper
kernel itself is held against that plain version on the card by
`chip_smoke.py`. Tolerances are the reference's own kernel bar
(tests/test_kernels.py): 2e-3 in float32, 2e-2 in bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash_attention
from repro.kernels.flash_attention import flash_attention_ref as ref_plain
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel

TOL = {"float32": dict(rtol=2e-3, atol=2e-3), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SHAPES = [
    (1, 128, 4, 4, 64),  # MHA
    (2, 256, 8, 2, 64),  # GQA 4:1
    (1, 128, 4, 1, 128),  # MQA, wide head
    (1, 200, 4, 2, 64),  # not a block multiple
]


def _inputs(seed, B, S, H, K, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), dtype=np.float32),
            rng.standard_normal((B, S, K, D), dtype=np.float32),
            rng.standard_normal((B, S, K, D), dtype=np.float32))


def _both(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,D", SHAPES)
def test_plain_matches_reference(dtype, B, S, H, K, D):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(0, B, S, H, K, D), dtype)
    want = ref_plain(jq, jk, jv, causal=True)
    got = flash_attention_ref(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == (B, S, H, D)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("window", [16, 64])
def test_plain_sliding_window_matches_reference(window):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, 1, 256, 4, 2, 64), "float32")
    want = ref_plain(jq, jk, jv, causal=True, window=window)
    got = flash_attention_ref(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("B,S,H,K,D", [(1, 200, 4, 2, 64), (2, 128, 8, 2, 64)])
def test_wrapper_on_cpu_matches_reference_kernel(B, S, H, K, D):
    """The port's public wrapper on CPU tensors against the reference's
    Pallas kernel in interpret mode, S=200 taking its padding path."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, B, S, H, K, D), "float32")
    want = ref_flash_attention(jq, jk, jv, causal=True, block_q=64, block_k=64)
    before = fa_kernel.launches
    got = flash_attention(tq, tk, tv, causal=True, block_q=64, block_k=64)
    assert fa_kernel.launches == before  # the plain version launches nothing
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_kernel_entry_refuses_cpu_tensors():
    """No plain-version fallback hides behind the kernel's entry point."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 64, 4, 2, 64))
    before = fa_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_bshd(q, k, v)
    assert fa_kernel.launches == before


def test_twin_registry_names_the_plain_version():
    assert fa_kernel.__torch_twins__ == {"flash_attention": flash_attention_ref}
