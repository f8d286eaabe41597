"""Mamba-1 selective SSM block (reference ``src/repro/models/mamba.py``),
for the Jamba hybrid.

Per token t, with input-dependent (selective) dt, B and C:

    h_t = exp(A * dt_t) * h_{t-1} + dt_t * B_t * x_t     (h in R^{d_in x N})
    y_t = C_t . h_t + D * x_t

The time loop is a plain eager Python loop over the sequence (the reference
runs ``lax.scan``), in float32; decode carries ``h`` (float32) and the
depthwise-conv window: an O(1) state. No kernel of the port takes this
recurrence, and the reference leaves it to XLA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import checks
from repro_torch.models.common import _frozen, make_param


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # defaults to ceil(d_model / 16)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def init_mamba(generator: torch.Generator, cfg: MambaConfig,
               dtype: torch.dtype = torch.float32
               ) -> Dict[str, torch.nn.Parameter]:
    """The reference's tree; ``a_log`` is the fixed S4D-real
    initialisation ``log(1..N)`` for every channel, not a draw."""
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.rank
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=generator.device)).expand(di, n)
    return {
        "w_in": make_param((d, 2 * di), generator, dtype=dtype,
                           axes=("embed", "mlp")),
        "conv_w": make_param((cfg.d_conv, di), generator,
                             scale=1.0 / math.sqrt(cfg.d_conv), dtype=dtype,
                             axes=(None, "mlp")),
        "conv_b": make_param((di,), generator, init="zeros", dtype=dtype,
                             axes=("mlp",)),
        "w_x_dbc": make_param((di, r + 2 * n), generator, dtype=dtype,
                              axes=("mlp", None)),
        "w_dt": make_param((r, di), generator, dtype=dtype,
                           axes=(None, "mlp")),
        "dt_bias": make_param((di,), generator, init="zeros", dtype=dtype,
                              axes=("mlp",)),
        "a_log": _frozen(a_log.to(dtype).contiguous(), (di, n),
                         ("mlp", None)),
        "d_skip": make_param((di,), generator, init="ones", dtype=dtype,
                             axes=("mlp",)),
        "w_out": make_param((di, d), generator, dtype=dtype,
                            axes=("mlp", "embed")),
    }


def _selective_scan(x, dt, b_t, c_t, a, d_skip, h0):
    """x, dt ``[B, S, Di]``; b_t, c_t ``[B, S, N]``; a ``[Di, N]``; h0
    ``[B, Di, N]`` or None (zeros). Returns (y ``[B, S, Di]`` float32, the
    final h float32)."""
    bsz, s, di = x.shape
    n = b_t.shape[-1]
    f32 = torch.float32
    x32, dt32 = x.to(f32), dt.to(f32)
    b32, c32 = b_t.to(f32), c_t.to(f32)
    h = (torch.zeros((bsz, di, n), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    dtx = dt32 * x32
    ys = []
    with checks.time_loop(s) as trips:   # s, or 1 under a cost count
        for t in range(trips):
            da = torch.exp(dt32[:, t, :, None] * a[None])     # [B, Di, N]
            h = da * h + dtx[:, t, :, None] * b32[:, t, None, :]
            ys.append(torch.bmm(h, c32[:, t, :, None])[..., 0])  # [B, Di]
    y = (torch.stack(ys, dim=1) if trips == s
         else ys[0][:, None, :].expand(bsz, s, di)) + x32 * d_skip
    return y, h


def _causal_conv(x, w, b, window: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. x ``[B, S, Di]``, w ``[K, Di]``; window
    ``[B, K-1, Di]`` is the carried left context for decode, None -> zero
    padding (prefill). Returns (out, the new window)."""
    k = w.shape[0]
    if window is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = window.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                           # [B, S+K-1, Di]
    s = x.shape[1]
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i]
    return out + b, xp[:, -(k - 1):, :]


def mamba(params, x: torch.Tensor, cfg: MambaConfig,
          state: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """Mamba block forward. state = ``{"h": [B, Di, N], "conv": [B, K-1,
    Di]}`` or None; returns (out, the new state)."""
    xs, z = (x @ params["w_in"]).chunk(2, dim=-1)             # [B,S,Di] each
    conv_state = state["conv"] if state is not None else None
    h0 = state["h"] if state is not None else None
    xs, new_conv = _causal_conv(xs, params["conv_w"], params["conv_b"],
                                conv_state)
    xs = F.silu(xs)
    r, n = cfg.rank, cfg.d_state
    dt_r, b_t, c_t = (xs @ params["w_x_dbc"]).split([r, n, n], dim=-1)
    dt = F.softplus(dt_r @ params["w_dt"] + params["dt_bias"])
    a = -torch.exp(params["a_log"].to(torch.float32))         # [Di, N]
    y, h_final = _selective_scan(xs, dt, b_t, c_t, a, params["d_skip"], h0)
    out = (y.to(x.dtype) * F.silu(z)) @ params["w_out"]
    return out, {"h": h_final, "conv": new_conv}
