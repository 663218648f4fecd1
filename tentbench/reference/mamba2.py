"""Plain float32 Mamba2 (arXiv:2405.21060; `mamba_ssm`'s `Mamba2` mixer in a
`MixerModel`): pre-norm blocks of one mixer each, in_proj to (z, x, B, C,
dt), a depthwise causal conv of width d_conv with SiLU over (x, B, C), the
SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t +
D x_t with one group of B and C shared by all heads, the gated RMS norm
norm(y * silu(z)), out_proj; a final RMS norm and the embedding tied to the
output head.

The recurrence is computed in its quadratic (attention-like) form over the
whole sequence, with the decay exponents summed in float64: a different
algorithm from a chunked scan. It imports nothing of the program. The
configuration file's keys are the source's (`config.json`) and the
`Mamba2` layer's; the weights are laid out as the program takes them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Precision, normal, rms_norm, uniform

# elements of one block of the float64 decay exponents
SEG_BUDGET = 60_000_000
# the chunk the program's SSD kernel runs, its largest: the configuration's
# chunk_size (256) is a departure of the program, which has no option for it
PORT_CHUNK = 128


def dims(conf: dict) -> dict:
    D, N = conf["d_model"], conf["d_state"]
    di = conf["expand"] * D
    nh = di // conf["headdim"]
    pad = conf.get("pad_vocab_size_multiple", 1)
    return {"L": conf["n_layer"], "D": D, "di": di, "N": N, "nh": nh, "hd": conf["headdim"],
            "k": conf["d_conv"], "conv_dim": di + 2 * N, "V": -(-conf["vocab_size"] // pad) * pad}


def port_config(conf: dict) -> dict:
    """The program's model settings for this configuration."""
    d = dims(conf)
    return {"name": conf["name"], "arch_type": "ssm", "num_layers": d["L"], "d_model": d["D"],
            "num_heads": 0, "num_kv_heads": 0, "d_ff": 0, "vocab_size": d["V"],
            "ssm_state": d["N"], "ssm_expand": conf["expand"], "ssm_headdim": d["hd"],
            "ssm_conv": d["k"], "ssm_chunk": PORT_CHUNK,
            "tie_embeddings": bool(conf["tie_embeddings"]), "norm_eps": float(conf["norm_epsilon"])}


def make_params(conf: dict, gen: torch.Generator, dtype) -> dict:
    """Random weights on the generator's device, one draw a leaf, after
    `mamba_ssm`'s initialisation where it has one: A = -U(1, 16) per head,
    dt_bias the inverse softplus of a log-uniform dt in [0.001, 0.1], conv
    weights U(-1/2, 1/2) (fan-in d_conv); matrices Normal(0, fan_in**-0.5),
    the embedding Normal(0, 0.02), D, norm scales Normal(1, 0.1) and the conv
    bias Normal(0, 0.02), so that no leaf is the identity."""
    if not conf["tie_embeddings"] or conf["ngroups"] != 1:
        raise ValueError("this reference ties the embedding and has one group of B, C")
    d = dims(conf)
    L, D, di, N, nh, k, cd, V = (d[x] for x in ("L", "D", "di", "N", "nh", "k", "conv_dim", "V"))
    dt = torch.exp(uniform(gen, (L, nh), math.log(1e-3), math.log(0.1), torch.float32))
    layers = {
        "ln1": normal(gen, (L, D), 0.1, dtype, 1.0),
        "ssm_in": normal(gen, (L, D, 2 * di + 2 * N + nh), D ** -0.5, dtype),
        "ssm_conv_w": uniform(gen, (L, k, cd), -0.5, 0.5, dtype),
        "ssm_conv_b": normal(gen, (L, cd), 0.02, dtype),
        "ssm_dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(dtype),
        "ssm_A_log": torch.log(uniform(gen, (L, nh), 1.0, 16.0, torch.float32)).to(dtype),
        "ssm_D": normal(gen, (L, nh), 0.1, dtype, 1.0),
        "ssm_norm": normal(gen, (L, di), 0.1, dtype, 1.0),
        "ssm_out": normal(gen, (L, di, D), di ** -0.5, dtype),
    }
    return {"embed": normal(gen, (V, D), 0.02, dtype),
            "final_norm": normal(gen, (D,), 0.1, dtype, 1.0), "layers": layers}


def _ssd(xdt, a, Bm, Cm, prec: Precision, ends):
    """y_t = sum_{s <= t} exp(sum_{s < r <= t} a_r) (C_t . B_s) xdt_s and the
    states h_p = sum_{s <= p} exp(sum_{s < r <= p} a_r) xdt_s B_s^T at each p
    of `ends`. xdt (B, T, nh, hd), a (B, T, nh), Bm/Cm (B, T, N)."""
    Bsz, T, nh, hd = xdt.shape
    cum = a.double().cumsum(1)
    y = torch.empty_like(xdt)
    xq = prec.q(xdt)
    block = max(16, min(512, SEG_BUDGET // max(1, Bsz * T * nh)))
    for t0 in range(0, T, block):
        t1 = min(T, t0 + block)
        seg = cum[:, t0:t1, None, :] - cum[:, None, :t1, :]  # (B, q, s, nh)
        causal = torch.arange(t1, device=a.device)[None, :] <= torch.arange(t0, t1, device=a.device)[:, None]
        decay = torch.where(causal[None, :, :, None], seg, float("-inf")).exp().float()
        cb = prec.mm(Cm[:, t0:t1], Bm[:, :t1].transpose(1, 2))  # (B, q, s)
        m = prec.q(decay * cb[..., None])
        y[:, t0:t1] = torch.einsum("bqsh,bshp->bqhp", m, xq[:, :t1])
        del seg, decay, m
    states = []
    for p in ends:
        w = (cum[:, p:p + 1] - cum[:, :p + 1]).exp().float()  # (B, p+1, nh)
        lhs = (w[..., None] * xdt[:, :p + 1]).permute(0, 2, 3, 1)  # (B, nh, hd, s)
        st = prec.mm(lhs.reshape(Bsz, nh * hd, p + 1), Bm[:, :p + 1])
        states.append(prec.q(st.view(Bsz, nh, hd, -1)))
    return y, states


def forward(conf: dict, params: dict, tokens: torch.Tensor, split: int,
            prec: Precision = Precision()):
    """tokens (B, T): a prompt of `split` tokens and the tokens served after
    it. Returns the logits (B, T - split + 1, V) at positions split - 1 ..
    T - 1, the decode state as prefill of the prompt leaves it and as the
    decode steps leave it after position T - 1: "ssm_state" (L, B, nh, hd,
    N) and "conv_buf" (L, B, d_conv - 1, conv_dim), the conv's last inputs."""
    d = dims(conf)
    eps = float(conf["norm_epsilon"])
    B, T = tokens.shape
    di, N, nh, hd, k = d["di"], d["N"], d["nh"], d["hd"], d["k"]
    if split < k - 1:
        raise ValueError(f"a prompt of {split} tokens is shorter than the conv's state")
    emb = params["embed"]
    x = emb[tokens].float()
    ends = (split - 1, T - 1)
    caches = [{"ssm_state": [], "conv_buf": []} for _ in ends]
    for i in range(d["L"]):
        w = {n: t[i].float() for n, t in params["layers"].items()}
        h = rms_norm(x, w["ln1"], eps)
        zxbcdt = prec.mm(h, w["ssm_in"])
        z, raw, dt = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N], zxbcdt[..., 2 * di + 2 * N:]
        conv = w["ssm_conv_b"].expand_as(raw).clone()
        for j in range(k):
            shift = k - 1 - j
            conv[:, shift:] += raw[:, :T - shift] * w["ssm_conv_w"][j]
        conv = F.silu(conv)
        xs = conv[..., :di].reshape(B, T, nh, hd)
        Bm, Cm = conv[..., di:di + N], conv[..., di + N:]
        dt = F.softplus(dt + w["ssm_dt_bias"])
        a = dt * -torch.exp(w["ssm_A_log"])
        y, states = _ssd(xs * dt[..., None], a, Bm, Cm, prec, ends)
        for cache, e, st in zip(caches, ends, states):
            cache["ssm_state"].append(st)
            cache["conv_buf"].append(prec.q(raw[:, e - (k - 2):e + 1]))
        y = y + xs * w["ssm_D"][:, None]
        y = rms_norm(y.reshape(B, T, di) * F.silu(z), w["ssm_norm"], eps)
        x = x + prec.mm(y, w["ssm_out"])
    xl = rms_norm(x[:, split - 1:], params["final_norm"].float(), eps)
    logits = prec.mm(xl, emb.float().T)
    shipped, decoded = ({n: torch.stack(v) for n, v in cache.items()} for cache in caches)
    return logits, shipped, decoded


def program_caches(shipped: dict, cache: dict, split: int, end: int):
    """The program's counterparts of `forward`'s caches: the shipped state
    as it is, and the decode cache's state after the decode steps."""
    return ({"ssm_state": shipped["ssm_state"], "conv_buf": shipped["conv_buf"]},
            {"ssm_state": cache["ssm_state"], "conv_buf": cache["conv_buf"]})


def flops(conf: dict, batch: int, prompt_len: int, n_new: int) -> float:
    """Model FLOPs of one call: prefill of the prompt (logits of its last
    position only) and n_new - 1 decode steps, 2 a multiply-add. The SSD
    of prefill is counted in the chunked form the program runs (`PORT_CHUNK`), each
    product once over its causal half; a decode step's state update and
    read-out are 2 products of nh x hd x N."""
    d = dims(conf)
    L, D, di, N, nh, hd, k, cd, V = (d[x] for x in ("L", "D", "di", "N", "nh", "hd", "k",
                                                   "conv_dim", "V"))
    lin = 2 * D * (2 * di + 2 * N + nh) + 2 * di * D + 2 * k * cd
    S, chunk = prompt_len, PORT_CHUNK
    pairs = sum(n * (n + 1) / 2 for n in (min(chunk, S - t0) for t0 in range(0, S, chunk)))
    ssd = 2 * N * pairs + nh * (2 * hd * pairs + 4.0 * S * hd * N)
    total = L * (S * lin + ssd) + 2 * D * V
    total += (n_new - 1) * (L * (lin + 4 * nh * hd * N) + 2 * D * V)
    return float(batch * total)
