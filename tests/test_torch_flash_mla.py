"""Flash attention at MLA's head dims: q/k 192 and v 128 (DeepSeek-V3's
prefill, 128 heads), the kernel's third built pair.

On the CPU: the plain version takes v with a head dim of its own and
matches attention written out here; the binding sends (192, 128) to one
launch as it is and pads dims that fit no built pair to the smallest that
holds them (the launch emulated). The tests marked `card` hold the Hopper
kernel against the plain version at 512, 2,048 and 8,192 tokens with 128
heads, in bf16 and f32, at the reference's kernel bar (2e-3 in float32,
2e-2 in bfloat16, per element against the plain version's magnitude, as
`chip_smoke.py` gates), with v a strided view of a per-head [k_nope | v]
projection as the model passes it: `python -m pytest -m card
tests/test_torch_flash_mla.py` on a card.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel

TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
HEADS_A_BLOCK = 16  # heads of the plain version's float32 scores at a time


def _inputs(B, S, H, D, Dv, dtype, device, seed=0):
    """q, k (B, S, H, D) and v (B, S, H, Dv), v the second half of a per-head
    [k_nope | v] projection (a strided view), as MLA's prefill makes it."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g, device=device).to(dtype)
    k = torch.randn(B, S, H, D, generator=g, device=device).to(dtype)
    kv = torch.randn(B, S, H, 128 + Dv, generator=g, device=device).to(dtype)
    return q, k, kv[..., 128:]


def _plain_by_heads(q, k, v):
    """The plain version a block of heads at a time (heads are independent
    when K = H), so 8,192 tokens' float32 scores fit beside the inputs."""
    return torch.cat([flash_attention_ref(q[:, :, h:h + HEADS_A_BLOCK],
                                          k[:, :, h:h + HEADS_A_BLOCK],
                                          v[:, :, h:h + HEADS_A_BLOCK])
                      for h in range(0, q.shape[2], HEADS_A_BLOCK)], dim=2)


def test_plain_version_takes_its_own_v_head_dim():
    q, k, v = _inputs(2, 70, 4, 48, 32, torch.float32, "cpu")
    scores = torch.einsum("bshd,bthd->bhst", q, k) / 48 ** 0.5
    scores = scores.masked_fill(~torch.ones(70, 70, dtype=torch.bool).tril(), float("-inf"))
    want = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, -1), v)
    got = flash_attention(q, k, v, causal=True)
    assert got.shape == (2, 70, 4, 32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dims,pair", [((192, 128), (192, 128)), ((48, 32), (64, 64)),
                                       ((128, 128), (128, 128)), ((160, 96), (192, 128))])
def test_the_binding_pads_to_the_smallest_built_pair(monkeypatch, dims, pair):
    """(192, 128) goes to one launch as it is; other dims that fit a built
    pair go in zero-padded to it, with the true D's softmax scale, and come
    out as their first Dv columns."""
    calls = []

    def emulated_launch(q, k, v, *, causal, window, scale_dim):
        calls.append((q.shape[-1], v.shape[-1], scale_dim))
        assert (k[..., scale_dim:] == 0).all()
        return flash_attention_ref(q * (q.shape[-1] / scale_dim) ** 0.5, k, v, causal=causal,
                                   window=window)

    monkeypatch.setattr(fa_kernel, "_launch", emulated_launch)
    D, Dv = dims
    q, k, v = _inputs(1, 96, 4, D, Dv, torch.float32, "cpu", seed=1)
    got = fa_kernel.flash_attention_bshd(q, k, v, causal=True)
    assert calls == [(*pair, D)]
    assert got.shape == (1, 96, 4, Dv)
    torch.testing.assert_close(got, flash_attention_ref(q, k, v), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="head_dim"):
        fa_kernel.padded_head_dims(256, 128)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("S", [512, 2048, 8192])
def test_the_kernel_matches_its_plain_version_on_a_card(S, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    q, k, v = _inputs(1, S, 128, 192, 128, dtype, "cuda", seed=S)
    before = fa_kernel.launches
    with torch.no_grad():
        out = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert fa_kernel.launches == before + 1
        want = _plain_by_heads(q, k, v)
    assert out.shape == (1, S, 128, 128) and out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    err = (out.float() - want.float()).abs()
    tol = TOL[dtype]
    assert bool((err <= tol + tol * want.float().abs()).all()), err.max().item()
