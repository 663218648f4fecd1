"""A decode call's steps replayed from one CUDA graph (`serving.greedy_decode`)
and the device position that makes the step capturable.

On the CPU: `cache_update` with a 0-d tensor position writes the same slot
and bytes and returns the same valid mask as an int position's host slicing
did (a slot in range, one clamped past the end, a ring wrapped); `decode_step` with a tensor
position gives the int position's logits and cache bit for bit on the
qwen2, mamba2, granite and deepseek-v3 smoke configurations (deepseek's
latent cache and absorbed step) and on the other families a
card serves (hymba's ring wrapping, the capacity-bound MoE, the
encoder-decoder); and `greedy_decode` runs every step eagerly, which its
`serving.decode` span counts.

The tests marked `card` run the graph on an NVIDIA card and skip without
one (`python -m pytest -m card tests/test_torch_decode_graph.py`): replayed
tokens and decode-written cache entries equal the eager loop's (also with
the Mamba2 layers' decode-step kernels captured in the graph), the
counters say one eager step and n_new - 2 replays (none for a one-step
call), a call leaves no device memory allocated or reserved, and a `decode_step`
patched in `repro_torch.serving.disagg` is the step that the graph replays.
"""
import pytest
import torch
import torch.nn.functional as F

import repro_torch.serving.disagg as disagg
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssm_step import kernel as ssm_step_kernel
from repro_torch.models import decode_step, init_params, prefill_forward
from repro_torch.models.attention import cache_update
from repro_torch.obs import spans
from repro_torch.serving import greedy_decode

# the benchmark's four configurations, then every other family a card serves in
# `chip_smoke.py`: hymba with a window of 8, so that a 12-token prompt's ring
# wraps while it decodes, the capacity-bound MoE and the encoder-decoder
ARCHS = ["qwen2-0.5b", "mamba2-370m", "granite-4.0-h-small", "deepseek-v3"]
FAMILIES = ARCHS + ["hymba-1.5b", "qwen3-moe-235b-a22b", "seamless-m4t-medium"]
# the families with Mamba2 layers, whose steps the decode-step kernels take
# with `use_pallas` on a card
SSM_FAMILIES = ["mamba2-370m", "granite-4.0-h-small", "hymba-1.5b"]
WINDOW = {"hymba-1.5b": 8}
PROMPT = 12


@pytest.fixture
def recorder():
    rec = spans.attach()
    yield rec
    spans.detach()


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _served(arch: str, device, extra: int, batch: int = 2, dtype=torch.float32,
            use_pallas: bool = False):
    """The smoke configuration's params, a prompt's last logits and its
    decode cache with room for `extra` more positions (a window's ring as
    prefill leaves it)."""
    cfg = get_smoke_config(arch).with_(remat="none", sliding_window=WINDOW.get(arch, 0),
                                       use_pallas=use_pallas)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, dtype, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, PROMPT), generator=gen, device=device)
    kw = {}
    if cfg.is_encdec:
        kw["enc_frames"] = torch.randn(batch, 4, cfg.d_model, generator=gen, device=device).to(dtype)
    with torch.no_grad():
        logits, kv = prefill_forward(cfg, params, tokens, **kw)
    pad = cfg.sliding_window == 0
    cache = {n: F.pad(t, (0, 0, 0, 0, 0, extra)) if pad and n in ("k", "v") else t
             for n, t in kv.items()}
    return cfg, params, logits, cache


def _copy(cache):
    return {n: t.clone() for n, t in cache.items()}


def _int_update(k, v, k_new, v_new, pos: int, window: int):
    """The update as an int position made it, sliced on the host: the slot
    clamped to the last (a ring's slot pos % W), every slot live past W."""
    W = k.shape[1]
    slot = min(pos % W if window > 0 else pos, W - 1)
    k[:, slot:slot + 1], v[:, slot:slot + 1] = k_new, v_new
    valid = torch.ones(W, dtype=torch.bool) if pos >= W else torch.arange(W) <= pos
    return k, v, valid


@pytest.mark.parametrize("window,pos", [(0, 3), (0, 8), (0, 11), (4, 2), (4, 3), (4, 4), (4, 9)],
                         ids=["in_range", "last", "clamped", "ring", "ring_last", "ring_wrap",
                              "ring_wrap_twice"])
def test_cache_update_with_a_tensor_position_equals_the_int(window, pos):
    W = window or 9
    gen = torch.Generator().manual_seed(pos)
    k, v = (torch.randn(2, W, 3, 8, generator=gen) for _ in range(2))
    k_new, v_new = (torch.randn(2, 1, 3, 8, generator=gen) for _ in range(2))
    k_int, v_int, valid_int = _int_update(k.clone(), v.clone(), k_new, v_new, pos, window)
    for p in (torch.tensor(pos), pos):  # a device position, and an int made one
        k_dev, v_dev, valid_dev = cache_update(k.clone(), v.clone(), k_new, v_new, p, window=window)
        assert torch.equal(k_dev, k_int) and torch.equal(v_dev, v_int)
        assert valid_dev.dtype == valid_int.dtype and torch.equal(valid_dev, valid_int)
    assert int(valid_int.sum()) == min(pos + 1, W)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_with_a_tensor_position_equals_the_int(arch):
    cfg, params, logits, cache = _served(arch, "cpu", extra=4)
    by_int, by_tensor = _copy(cache), _copy(cache)
    tok = logits.argmax(-1)[:, None]
    with torch.no_grad():
        for i in range(3):
            want, by_int = decode_step(cfg, params, by_int, tok, PROMPT + i)
            got, by_tensor = decode_step(cfg, params, by_tensor, tok, torch.tensor(PROMPT + i))
            assert torch.equal(got, want)
            for name in cache:
                assert torch.equal(by_tensor[name], by_int[name]), name
            tok = want.argmax(-1)[:, None]


@pytest.mark.parametrize("n_new", [2, 5])
def test_greedy_decode_runs_every_step_eagerly_on_the_cpu(recorder, n_new):
    cfg, params, logits, cache = _served("qwen2-0.5b", "cpu", extra=n_new)
    with recorder.request(keep=True) as root:
        with torch.no_grad():
            greedy_decode(cfg, params, cache, logits, PROMPT, n_new)
    got = recorder.take(root.request)
    decode = next(s for s in got if s.name == "serving.decode")
    assert decode.counters == {"graph_steps": 0, "eager_steps": n_new - 1}
    steps = [s for s in got if s.name == "model.decode_step"]
    assert len(steps) == n_new - 1 and all(s.parent == decode.id for s in steps)


def _eager_loop(cfg, params, cache, logits, n_new):
    """The decode loop before the graph: int positions, one step at a time."""
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    out = [tok]
    for i in range(n_new - 1):
        step, cache = decode_step(cfg, params, cache, tok, PROMPT + i)
        tok = step.argmax(-1)[:, None].to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1).cpu().numpy()


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch,use_pallas", [(a, False) for a in FAMILIES]
                         + [(a, True) for a in SSM_FAMILIES],
                         ids=FAMILIES + [f"{a}-kernels" for a in SSM_FAMILIES])
def test_replayed_steps_equal_the_eager_loop_on_a_card(recorder, arch, use_pallas, dtype):
    """With `use_pallas`, the Mamba2 layers' decode-step kernels (ctypes
    launches on the current stream) run inside the captured graph."""
    dev = _card()
    n_new = 7
    cfg, params, logits, cache = _served(arch, dev, extra=n_new, dtype=dtype,
                                         use_pallas=use_pallas)
    launches = ssm_step_kernel.launches
    eager, graphed = _copy(cache), _copy(cache)
    with torch.no_grad():
        want = _eager_loop(cfg, params, eager, logits, n_new)
        with recorder.request(keep=True) as root:
            got = greedy_decode(cfg, params, graphed, logits, PROMPT, n_new)
    assert (got == want).all(), (got, want)
    for name in cache:  # the prompt's entries and the decode-written ones
        assert torch.equal(graphed[name], eager[name]), name
    spans_ = recorder.take(root.request)
    decode = next(s for s in spans_ if s.name == "serving.decode")
    assert decode.counters == {"graph_steps": n_new - 2, "eager_steps": 1}
    # the eager step and the capture; replays open no span
    steps = [s for s in spans_ if s.name == "model.decode_step"]
    assert len(steps) == 2
    layers = sum(t == "mamba" for t in cfg.layer_types) if cfg.layer_types else cfg.num_layers
    kernel_layers = layers if use_pallas else 0
    assert [s.counters["ssm_kernel_layers"] for s in steps] == [kernel_layers] * 2
    # the eager loop's n_new - 1 steps, then the graph's eager step and capture
    assert ssm_step_kernel.launches - launches == kernel_layers * (n_new + 1)

    with recorder.request(keep=True) as root:
        with torch.no_grad():
            one = greedy_decode(cfg, params, _copy(cache), logits, PROMPT, 2)
    assert (one == want[:, :2]).all()
    decode = next(s for s in recorder.take(root.request) if s.name == "serving.decode")
    assert decode.counters == {"graph_steps": 0, "eager_steps": 1}


@pytest.mark.card
def test_a_call_leaves_no_device_memory_allocated_on_a_card():
    """After the first call (the side stream's workspace, the card's decode
    pool) a call allocates nothing that outlives it, and reserves no more:
    every call's graph reuses the one pool."""
    dev = _card()
    cfg, params, logits, cache = _served("mamba2-370m", dev, extra=6)
    with torch.no_grad():
        greedy_decode(cfg, params, _copy(cache), logits, PROMPT, 6)
        for _ in range(3):
            work = _copy(cache)
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
            greedy_decode(cfg, params, work, logits, PROMPT, 6)
            torch.cuda.synchronize(dev)
            assert (torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)) == before


@pytest.mark.card
def test_the_graph_replays_the_step_patched_into_serving(monkeypatch):
    """A step that forces token 3 after the real one: every replayed token
    is 3, so the graph holds the patched step, called once eagerly and
    once under capture."""
    dev = _card()
    n_new = 6
    cfg, params, logits, cache = _served("qwen2-0.5b", dev, extra=n_new)
    step, calls = disagg.decode_step, []

    def forced(cfg, params, cache, token, pos):
        calls.append(pos)
        out, cache = step(cfg, params, cache, token, pos)
        bump = torch.zeros_like(out)
        bump[:, 3] = 1e30
        return out + bump, cache

    monkeypatch.setattr(disagg, "decode_step", forced)
    with torch.no_grad():
        got = greedy_decode(cfg, params, cache, logits, PROMPT, n_new)
    assert (got[:, 1:] == 3).all(), got
    assert len(calls) == 2 and all(isinstance(p, torch.Tensor) for p in calls)
