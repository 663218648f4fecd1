"""The port's flash attention against the reference's, on the CPU.

On CPU tensors the port's wrapper runs its plain version; the Hopper
kernel itself is held against that plain version on the card by
`chip_smoke.py`. Tolerances are the reference's own kernel bar
(tests/test_kernels.py): 2e-3 in float32, 2e-2 in bfloat16.

The bf16 kernel rounds in places the plain version does not, so this file
also keeps a plain-torch emulation of its rounding points
(`bf16_kernel_emulation`, never on the main path) and holds it against the
reference, and rehearses `chip_smoke.py`'s bf16 serving gate with it.
"""
import importlib.util
from pathlib import Path

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


# the bf16 kernel's new edge cases: S not a multiple of its 64-key tile with
# D = 128 (two column halves), and a window inside one kv tile
BF16_EDGE = [((1, 200, 4, 1, 128), 0), ((1, 256, 4, 2, 64), 16)]
KV_TILE = 64  # keys per kv tile of the bf16 kernel (csrc/flash_attention.cu)


def bf16_kernel_emulation(q, k, v, *, causal=True, window=0, block_k=KV_TILE):
    """The bf16 kernel's arithmetic in plain torch: bf16 q, k, v; fp32
    scores (a bf16 x bf16 product is exact in fp32); an fp32 online softmax
    over kv tiles of `block_k` keys, exp taken as exp2 with the scale folded
    into log2(e); P rounded to bf16 before P V, which accumulates in fp32;
    the final divide in fp32; rows with no live key zero. q (B,S,H,D), k/v
    (B,S,K,D) -> (B,S,H,D) in q's dtype."""
    B, S, H, D = q.shape
    K = k.shape[2]
    qf = q.reshape(B, S, K, H // K, D).float()
    kf, vf = k.float(), v.float()
    sl2e = D ** -0.5 * 1.4426950408889634
    qpos = torch.arange(S)[:, None]
    m = torch.full((B, K, H // K, S), -torch.inf)
    l = torch.zeros((B, K, H // K, S))
    acc = torch.zeros((B, K, H // K, S, D))
    for k0 in range(0, S, block_k):
        kpos = torch.arange(k0, min(k0 + block_k, S))[None, :]
        live = torch.ones((S, kpos.shape[1]), dtype=torch.bool)
        if causal:
            live &= kpos <= qpos
        if window > 0:
            live &= kpos > qpos - window
        s = torch.einsum("bskgd,btkd->bkgst", qf, kf[:, k0:k0 + block_k])
        s = torch.where(live, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_ref = torch.where(m_new == -torch.inf, 0.0, m_new)
        corr = torch.where(m_new == m, 1.0, torch.exp2((m - m_ref) * sl2e))
        p = torch.exp2(s * sl2e - (m_ref * sl2e)[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.bfloat16().float(), vf[:, k0:k0 + block_k])
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


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


@pytest.mark.parametrize("B,S,H,K,D,window",
                         [shape + (0,) for shape in SHAPES]
                         + [(1, 256, 4, 2, 64, 64)] + [shape + (w,) for shape, w in BF16_EDGE])
def test_bf16_kernel_emulation_matches_reference(B, S, H, K, D, window):
    """The bf16 kernel's rounding points (bf16 P among them) stay within the
    reference's 2e-2 bf16 bar of its plain version."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(4, B, S, H, K, D), "bfloat16")
    want = ref_plain(jq, jk, jv, causal=True, window=window)
    got = bf16_kernel_emulation(tq, tk, tv, causal=True, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, D)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["bfloat16"])


@pytest.mark.parametrize("B,S,H,K,D,window", [(1, 200, 4, 2, 64, 0), (1, 256, 4, 2, 64, 16)])
def test_bf16_kernel_emulation_matches_reference_kernel(B, S, H, K, D, window):
    """... and of the reference's Pallas kernel, run in interpret mode."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(5, B, S, H, K, D), "bfloat16")
    want = ref_flash_attention(jq, jk, jv, causal=True, window=window, block_q=64, block_k=64)
    got = bf16_kernel_emulation(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["bfloat16"])


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bf16_serving_gate_rehearsed_with_the_emulation(monkeypatch):
    """chip_smoke.py's serve_bf16 gate at smoke size on the CPU: the kernel
    prefill (here the emulation of the bf16 kernel) lies no further from an
    f32 evaluation of the same bf16 weights than BF16_GATE times the plain
    bf16 prefill does, and both distances are finite and nonzero."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import init_params, prefill_forward

    cs = _chip_smoke()
    calls = []

    def kernel(q, k, v, *, causal=True, window=0, block_q=128, block_k=128):
        calls.append(q.dtype)
        return bf16_kernel_emulation(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(ops, "flash_attention", kernel)
    cfg = get_smoke_config("qwen2-0.5b").with_(use_pallas=True, remat="none")
    params = init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                         device="cpu")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    logits, _ = prefill_forward(cfg, params, prompts)
    assert calls == [torch.bfloat16] * cfg.num_layers
    kernel_dist, plain_dist = cs.prefill_distances(cfg, params, prompts, logits)
    assert len(calls) == cfg.num_layers  # the yardstick and the plain prefill skip the kernel
    assert np.isfinite(kernel_dist) and np.isfinite(plain_dist) and plain_dist > 0
    assert kernel_dist <= cs.BF16_GATE * plain_dist, (kernel_dist, plain_dist)


@pytest.mark.parametrize("D,width", [(56, 64), (80, 128)])
def test_padded_head_dim_through_the_binding(monkeypatch, D, width):
    """A head dim the kernels are not built for (qwen2-0.5b-smoke's 56, and
    80) goes in zero-padded to the next built width with the true D's
    softmax scale, and comes out as its first D columns: the binding's path
    with the launch emulated, against the reference's Pallas kernel in
    interpret mode at D itself."""
    calls = []

    def emulated_launch(q, k, v, *, causal, window, scale_dim):
        calls.append((q.shape[-1], scale_dim))
        assert (k[..., scale_dim:] == 0).all() and (v[..., scale_dim:] == 0).all()
        # the plain version scales by the padded width's 1/sqrt: rescale q
        # so that the scores take the true D's scale
        return flash_attention_ref(q * (q.shape[-1] / scale_dim) ** 0.5, k, v, causal=causal,
                                   window=window)

    monkeypatch.setattr(fa_kernel, "_launch", emulated_launch)
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(6, 1, 200, 4, 2, D), "float32")
    got = fa_kernel.flash_attention_bshd(tq, tk, tv, causal=True)
    assert calls == [(width, D)]
    assert got.shape == (1, 200, 4, D) and got.is_contiguous()
    want = ref_flash_attention(jq, jk, jv, causal=True, block_q=64, block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    np.testing.assert_allclose(_np(got), _np(flash_attention_ref(tq, tk, tv)), **TOL["float32"])


def test_head_dims_the_kernel_takes():
    assert [fa_kernel.padded_head_dim(d) for d in (1, 56, 64, 65, 80, 128)] == [
        64, 64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match="head_dim"):
        fa_kernel.padded_head_dim(129)
