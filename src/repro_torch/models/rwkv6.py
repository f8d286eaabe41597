"""RWKV-6 ("Finch") blocks (reference ``src/repro/models/rwkv6.py``):
attention-free time mixing with data-dependent decay, and the RWKV
channel-mix FFN.

The WKV recurrence per head (head dim N):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (S in R^{N x N})
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with per-token, per-channel decay ``w_t = exp(-exp(w0 + lora_w(x_t)))``.
``_wkv_scan`` runs it as a plain eager loop over time and ``_wkv_chunked``
as the chunked-parallel form (a loop over chunks), both in float32; decode
carries ``S`` (float32) and the token-shift vectors: no KV cache. The
per-head output norm is an RMSNorm kernel launch over rows of N.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import checks
from repro_torch.models.common import make_param, rms_norm


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    num_heads: int                 # head_dim = d_model // num_heads
    d_ff: int
    lora_rank_decay: int = 64
    lora_rank_mix: int = 32
    chunk: int = 0                 # 0 = stepwise scan; >0 = chunked WKV

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def init_time_mix(generator: torch.Generator, cfg: RWKV6Config,
                  dtype: torch.dtype = torch.float32
                  ) -> Dict[str, torch.nn.Parameter]:
    d, rk = cfg.d_model, cfg.lora_rank_mix

    def param(shape, axes, **kw):
        return make_param(shape, generator, dtype=dtype, axes=axes, **kw)

    return {
        # data-dependent interpolation (ddlerp) between x_t and x_{t-1}
        "maa_x": param((d,), (None,), init="zeros"),
        "maa": param((5, d), (None, None), init="zeros"),
        "mix_a": param((d, 5 * rk), ("embed", None), scale=0.01),
        "mix_b": param((5, rk, d), (None, None, "embed"), scale=0.01),
        # projections
        "w_r": param((d, d), ("embed", "heads")),
        "w_k": param((d, d), ("embed", "heads")),
        "w_v": param((d, d), ("embed", "heads")),
        "w_g": param((d, d), ("embed", "heads")),
        "w_o": param((d, d), ("heads", "embed")),
        # data-dependent decay (the Finch mechanism)
        "decay_base": param((d,), (None,), init="zeros"),
        "decay_a": param((d, cfg.lora_rank_decay), ("embed", None),
                         scale=0.01),
        "decay_b": param((cfg.lora_rank_decay, d), (None, "embed"),
                         scale=0.01),
        # per-channel bonus u
        "bonus": param((d,), (None,), init="zeros"),
        # output group-norm gain (per head)
        "ln_out": param((d,), (None,), init="ones"),
    }


def _ddlerp(params, x: torch.Tensor, sx: torch.Tensor) -> List[torch.Tensor]:
    """RWKV-6 data-dependent token-shift interpolation: x, sx ``[B, S, D]``
    (the current and the previous token) -> the five mixed streams (w, k,
    v, r, g)."""
    rk = params["mix_b"].shape[1]
    diff = sx - x
    xxx = x + diff * params["maa_x"]
    lora = torch.tanh(xxx @ params["mix_a"])
    lora = lora.reshape(*lora.shape[:-1], 5, rk)
    delta = torch.einsum("bsfr,frd->bsfd", lora, params["mix_b"])
    return [x + diff * (params["maa"][i] + delta[..., i, :])
            for i in range(5)]


def _wkv_scan(r, k, v, w, u, state):
    """The WKV recurrence step by step. r, k, v, w ``[B, S, H, N]`` (w the
    decay in (0, 1)); u ``[H, N]``; state ``[B, H, N, N]`` or None (zeros).
    Returns (out ``[B, S, H, N]`` in r's dtype, the final state float32)."""
    b, s, h, n = r.shape
    f32 = torch.float32
    r32, k32, v32, w32 = (t.to(f32) for t in (r, k, v, w))
    if state is None:
        state = torch.zeros((b, h, n, n), dtype=f32, device=r.device)
    u4 = u.to(f32)[None, :, :, None]
    outs = []
    with checks.time_loop(s) as trips:   # s, or 1 under a cost count
        for t in range(trips):
            kv = k32[:, t, :, :, None] * v32[:, t, :, None, :]  # [B,H,N,N]
            new = w32[:, t, :, :, None] * state + kv
            # the one trip a cost count runs stands for every trip but the
            # first: its output reads the state the decay has updated, so
            # that its backward reaches w as theirs do
            outs.append(torch.matmul(r32[:, t, :, None, :],
                                     (state if trips == s else new)
                                     + u4 * kv)[..., 0, :])
            state = new
    out = (torch.stack(outs, dim=1) if trips == s
           else outs[0][:, None].expand(b, s, h, n))
    return out.to(r.dtype), state


def _wkv_chunked(r, k, v, w, u, state, chunk: int):
    """Chunked-parallel WKV (the GLA / RWKV-6 chunked form), equal to the
    stepwise recurrence: one state update per chunk, and the interactions
    inside a chunk as causal ``[Tc, Tc]`` products. Decay products are kept
    in log space from the chunk start and clamped at -60, as the reference
    does."""
    b, s, h, n = r.shape
    tc = min(chunk, s)
    if s % tc:
        raise ValueError(f"S={s} is not a multiple of the chunk {tc}")
    nc = s // tc
    f32 = torch.float32
    if state is None:
        state = torch.zeros((b, h, n, n), dtype=f32, device=r.device)
    rc, kc, vc, wc = (t.to(f32).reshape(b, nc, tc, h, n)
                      for t in (r, k, v, w))
    u = u.to(f32)
    mask = torch.tril(torch.ones((tc, tc), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    outs = []
    for c in range(nc):
        r_, k_, v_, w_ = rc[:, c], kc[:, c], vc[:, c], wc[:, c]
        logw = torch.log(torch.clamp(w_, min=1e-38))          # <= 0
        a = torch.cumsum(logw, dim=1)
        a_prev = torch.clamp(a - logw, min=-60.0)
        a_cl = torch.clamp(a, min=-60.0)
        a_end = a[:, -1:]                                     # [B,1,H,N]
        # cross-chunk: o_t += (r_t * exp(a_{t-1})) @ S0
        r_dec = r_ * torch.exp(a_prev)
        o = torch.einsum("bthn,bhnm->bthm", r_dec, state)
        # intra-chunk, strictly causal
        k_dec = k_ * torch.exp(-a_cl)
        scores = torch.einsum("bthn,bihn->bhti", r_dec, k_dec)
        scores = torch.where(mask[None, None], scores, 0.0)
        o = o + torch.einsum("bhti,bihm->bthm", scores, v_)
        # the diagonal bonus r_t (u k_t) v_t
        o = o + (r_ * u[None, None] * k_).sum(-1)[..., None] * v_
        # the state for the next chunk
        k_rem = k_ * torch.exp(torch.clamp(a_end - a, min=-60.0))
        state = (torch.exp(torch.clamp(a_end[:, 0], min=-60.0))[..., None]
                 * state + torch.einsum("bihn,bihm->bhnm", k_rem, v_))
        outs.append(o)
    out = torch.stack(outs, dim=1).reshape(b, s, h, n)
    return out.to(r.dtype), state


def _shifted(x: torch.Tensor, state: Optional[dict]) -> torch.Tensor:
    """The previous token's stream: the carried shift vector for decode,
    else x moved one step right behind a zero row."""
    if state is not None:
        return state["shift"][:, None, :].to(x.dtype)
    # a zero row, then every row but the last: F.pad's values, from ops
    # that DTensor's sharding rules cover (its propagation of
    # constant_pad_nd raised IndexError on torch 2.11)
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def time_mix(params, x: torch.Tensor, cfg: RWKV6Config,
             state: Optional[dict] = None
             ) -> Tuple[torch.Tensor, dict]:
    """RWKV-6 time mixing. state = ``{"shift": [B, D], "wkv": [B, H, N,
    N]}`` for decode, None for prefill (the shift starts at zeros). Returns
    (out, the new state)."""
    b, s, d = x.shape
    h, n = cfg.num_heads, cfg.head_dim
    sx = _shifted(x, state)
    wkv_state = None if state is None else state["wkv"]
    xw, xk, xv, xr, xg = _ddlerp(params, x, sx)
    r = (xr @ params["w_r"]).reshape(b, s, h, n)
    k = (xk @ params["w_k"]).reshape(b, s, h, n)
    v = (xv @ params["w_v"]).reshape(b, s, h, n)
    g = F.silu(xg @ params["w_g"])
    # data-dependent decay in (0, 1): exp(-exp(.))
    decay_logit = params["decay_base"] + torch.tanh(
        xw @ params["decay_a"]) @ params["decay_b"]
    w = torch.exp(-torch.exp(decay_logit.to(torch.float32))).reshape(
        b, s, h, n)
    u = params["bonus"].reshape(h, n)
    if cfg.chunk > 0 and s > 1 and s % min(cfg.chunk, s) == 0:
        out, wkv_state = _wkv_chunked(r, k, v, w, u, wkv_state, cfg.chunk)
    else:
        out, wkv_state = checks.partitioned("wkv_scan", _wkv_scan, r, k, v,
                                            w, u, wkv_state)
    # the per-head group norm: one RMSNorm launch over B * S * H rows of N
    out = rms_norm(out, torch.ones((n,), dtype=out.dtype, device=out.device))
    out = out.reshape(b, s, d) * params["ln_out"]
    out = (out * g) @ params["w_o"]
    return out, {"shift": x[:, -1, :], "wkv": wkv_state}


def init_channel_mix(generator: torch.Generator, cfg: RWKV6Config,
                     dtype: torch.dtype = torch.float32
                     ) -> Dict[str, torch.nn.Parameter]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "maa_k": make_param((d,), generator, init="zeros", dtype=dtype,
                            axes=(None,)),
        "maa_r": make_param((d,), generator, init="zeros", dtype=dtype,
                            axes=(None,)),
        "w_k": make_param((d, f), generator, dtype=dtype,
                          axes=("embed", "mlp")),
        "w_v": make_param((f, d), generator, dtype=dtype,
                          axes=("mlp", "embed")),
        "w_r": make_param((d, d), generator, dtype=dtype,
                          axes=("embed", "embed_out")),
    }


def channel_mix(params, x: torch.Tensor, cfg: RWKV6Config,
                state: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """RWKV channel mixing (squared-ReLU FFN with token shift and an r
    gate). state = ``{"shift": [B, D]}`` for decode."""
    diff = _shifted(x, state) - x
    xk = x + diff * params["maa_k"]
    xr = x + diff * params["maa_r"]
    k = torch.square(torch.relu(xk @ params["w_k"]))
    out = torch.sigmoid(xr @ params["w_r"]) * (k @ params["w_v"])
    return out, {"shift": x[:, -1, :]}
