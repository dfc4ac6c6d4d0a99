"""State-space sequence mixers: RWKV6 ("Finch") time-mix and a Mamba-style
selective-SSM head bank (used by Hymba's hybrid layers).

RWKV6 recurrence (per head, head dim ``n``):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t            (state: n x n)
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with **data-dependent decay** w_t = exp(-exp(w0 + lora(x_t))).

Mamba head (simplified mamba-1 used by Hymba):
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t ;  y_t = C_t . h_t + D x_t

Routes of the prompt-length mixers (``impl``):

* ``"xla"`` — the reference's default math (its name for its plain-JAX
  route): :func:`mamba_scan`'s per-token loop, and
  :func:`rwkv_time_mix_chunked`'s chunkwise einsums, which fall back to the
  recurrence when ``t % chunk``.
* ``"cuda"`` — the kernels: :func:`mamba_scan` sends the scan through
  ``repro_torch.kernels.mamba.ops.selective_scan`` (the reference's
  ``"pallas"`` route, here at any T);
  :func:`rwkv_time_mix_chunked` sends the WKV core through
  ``repro_torch.kernels.rwkv6.ops.wkv6_heads``, any T.  On CPU tensors the
  ops take their plain versions.

Decode goes through the ops as well: :func:`rwkv_time_mix_recurrent` calls
``wkv6_heads``, and ``models/transformer.py``'s decode step calls
:func:`mamba_scan` with ``impl="cuda"`` at T = 1, so on the card every
decode step launches the kernels and on the CPU it runs the reference's
per-token math.  The ``"xla"`` routes stay plain tensor code on any device.
Initializers draw from a ``torch.Generator`` on its device with the
reference's distributions; ``lead`` stacks layers.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba.ops import selective_scan
from repro_torch.kernels.mamba.ref import selective_scan_ref
from repro_torch.kernels.rwkv6.ops import wkv6_heads
from repro_torch.kernels.rwkv6.ref import wkv6_heads_ref
from repro_torch.models.layers import dense_init_on, normal_on
from repro_torch.models.sharding import local_map_channels, matmul, reshape, shard

IMPLS = ("xla", "cuda")

Lead = Tuple[int, ...]


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown mixer impl {impl!r}; have {IMPLS}")


def _full(lead: Lead, shape: Tuple[int, ...], value: float, dtype: torch.dtype,
          gen: torch.Generator) -> torch.Tensor:
    return torch.full(lead + shape, value, dtype=dtype, device=gen.device)


# ===========================================================================
# RWKV6
# ===========================================================================


class RWKVState(NamedTuple):
    """Recurrent state for one rwkv layer."""

    wkv: torch.Tensor        # (B, H, n, n) matrix state
    shift_tm: torch.Tensor   # (B, d) previous token (time-mix token shift)
    shift_cm: torch.Tensor   # (B, d) previous token (channel-mix token shift)


def rwkv_dims(cfg: ModelConfig) -> Tuple[int, int]:
    n = cfg.ssm.state_size                 # head dim (64 for rwkv6-3b)
    h = cfg.d_model // n
    return h, n


def init_rwkv_time_mix(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                       lead: Lead = ()) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    lora = max(32, d // 32)
    f32 = torch.float32
    return {
        "wr": dense_init_on(gen, d, d, dtype, lead),
        "wk": dense_init_on(gen, d, d, dtype, lead),
        "wv": dense_init_on(gen, d, d, dtype, lead),
        "wg": dense_init_on(gen, d, d, dtype, lead),
        "wo": dense_init_on(gen, d, d, dtype, lead),
        # token-shift interpolation weights per projection (r,k,v,g,w)
        "mu": _full(lead, (5, d), 0.5, dtype, gen),
        # data-dependent decay: w0 + (tanh(x A) B)
        "w0": _full(lead, (d,), -6.0, f32, gen),
        "w_lora_a": dense_init_on(gen, d, lora, f32, lead),
        "w_lora_b": normal_on(gen, (lora, d), 0.01, f32, lead),
        # per-channel bonus
        "u": normal_on(gen, (d,), 0.1, f32, lead),
        "ln_x_scale": _full(lead, (d,), 1.0, f32, gen),   # per-head group norm
    }


def _rwkv_projections(p: Dict, x: torch.Tensor, x_prev: torch.Tensor):
    """Token-shifted projections. x: (B,T,d); x_prev: (B,T,d) shifted input."""
    def lerp(i):
        return x + (x_prev - x) * p["mu"][i]

    r = lerp(0) @ p["wr"]
    k = lerp(1) @ p["wk"]
    v = lerp(2) @ p["wv"]
    g = F.silu(lerp(3) @ p["wg"])
    xw = lerp(4).float()
    logw = -torch.exp(p["w0"] + torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"])  # <= 0
    return r, k, v, g, logw


def _group_norm(x: torch.Tensor, scale: torch.Tensor, h: int, n: int) -> torch.Tensor:
    """Per-head RMS norm of the wkv output. x: (..., d)."""
    shp = x.shape
    xh = reshape(x, *shp[:-1], h, n).float()
    xh = xh * torch.rsqrt(torch.mean(torch.square(xh), -1, keepdim=True) + 1e-6)
    return (reshape(xh, *shp) * scale).to(x.dtype)


def _shifted(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """(B,T,d) -> the previous token of each position, ``last`` before t=0."""
    return torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _rwkv_out(p: Dict, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    h, n = rwkv_dims(cfg)
    y = _group_norm(y, p["ln_x_scale"], h, n) * g
    return y.to(x.dtype) @ p["wo"]


def _rwkv_time_mix_heads(p: Dict, x: torch.Tensor, state: RWKVState,
                         cfg: ModelConfig, wkv) -> Tuple[torch.Tensor, RWKVState]:
    """The time mix with its WKV core ``wkv`` (a function of r, k, v, logw
    in the (B, T, H, n) layout, u (H, n) and the state)."""
    b, t, d = x.shape
    h, n = rwkv_dims(cfg)
    r, k, v, g, logw = _embed_layout(*_rwkv_projections(p, x, _shifted(x, state.shift_tm)))
    heads = [reshape(a, b, t, h, n).float() for a in (r, k, v, logw)]
    # on a mesh the WKV core runs on each rank's batch rows and heads
    y, s_fin = local_map_channels(wkv, heads + [p["u"].reshape(h, n), state.wkv],
                                  [(0, 2)] * 4 + [(None, 0), (0, 1)], [(0, 2), (0, 1)])
    out = _rwkv_out(p, x, reshape(y, b, t, d), g, cfg)
    return shard(out, "batch", "seq", "embed"), RWKVState(s_fin, x[:, -1], state.shift_cm)


def _embed_layout(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The projections on the logical ``embed`` layout before their split
    into heads (the reference constrains ``r``; a DTensor cannot split a
    dimension sharded over more ranks than it has heads, so all five)."""
    return tuple(shard(a, "batch", "seq", "embed") for a in xs)


def rwkv_time_mix_recurrent(p: Dict, x: torch.Tensor, state: RWKVState,
                            cfg: ModelConfig, impl: str = "cuda"
                            ) -> Tuple[torch.Tensor, RWKVState]:
    """Decode path: the per-token recurrence through the rwkv6 op (the
    kernel on the card, its plain version on the CPU), or under
    ``impl="xla"`` its plain version on any device. x: (B,T,d)."""
    _check_impl(impl)
    wkv = wkv6_heads if impl == "cuda" else wkv6_heads_ref
    return _rwkv_time_mix_heads(p, x, state, cfg, wkv)


def rwkv_time_mix_chunked(p: Dict, x: torch.Tensor, state: RWKVState,
                          cfg: ModelConfig, chunk: int = 64, impl: str = "xla"
                          ) -> Tuple[torch.Tensor, RWKVState]:
    """Prefill.  ``impl="xla"``: the reference's chunkwise-parallel form
    (intra-chunk via masked products, inter-chunk via a loop carrying the
    (B,H,n,n) state), or the plain recurrence when ``t % chunk``.
    ``impl="cuda"``: the WKV core through the rwkv6 op, on the projections
    in place."""
    _check_impl(impl)
    b, t, d = x.shape
    h, n = rwkv_dims(cfg)
    if impl == "cuda":
        return _rwkv_time_mix_heads(p, x, state, cfg, wkv6_heads)
    if t % chunk:
        return _rwkv_time_mix_heads(p, x, state, cfg, wkv6_heads_ref)
    r, k, v, g, logw = _embed_layout(*_rwkv_projections(p, x, _shifted(x, state.shift_tm)))
    heads = [reshape(a, b, t, h, n) for a in (r, k, v, logw)]
    # on a mesh the chunked core runs on each rank's batch rows and heads
    y, S = local_map_channels(functools.partial(_wkv_chunked, chunk=chunk),
                              heads + [p["u"].reshape(h, n), state.wkv],
                              [(0, 2)] * 4 + [(None, 0), (0, 1)], [(0, 2), (0, 1)])
    out = _rwkv_out(p, x, reshape(y, b, t, d), g, cfg)
    return shard(out, "batch", "seq", "embed"), RWKVState(S, x[:, -1], state.shift_cm)


def _wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                 u: torch.Tensor, S: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's chunkwise WKV: r/k/v/logw (B, T, H, n), u (H, n),
    the state S (B, H, n, n) -> (y (B, T, H, n), S)."""
    b, t, h, n = r.shape
    nc = t // chunk
    # (B, nc, L, H, n)
    rh = r.reshape(b, nc, chunk, h, n).float()
    kh = k.reshape(b, nc, chunk, h, n).float()
    vh = v.reshape(b, nc, chunk, h, n).float()
    lw = logw.reshape(b, nc, chunk, h, n)

    # cumulative log-decay inside each chunk: cum[t] = sum_{u<=t} logw_u
    cum = torch.cumsum(lw, dim=2)                      # (B,nc,L,H,n)
    total = cum[:, :, -1]                              # (B,nc,H,n)

    # intra-chunk pairwise scores: score[t,s] = sum_i r_t k_s exp(cum[t-1]-cum[s])
    cum_prev = cum - lw                                # exclusive cumsum
    r_f = rh * torch.exp(cum_prev)
    k_f = kh * torch.exp(-cum)
    scores = torch.einsum("bclhn,bcmhn->bchlm", r_f, k_f)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    scores = scores * mask
    # diagonal bonus term: u * r_t k_t
    diag = torch.einsum("bclhn,bclhn->bchl", rh * u, kh)
    y_intra = torch.einsum("bchlm,bcmhn->bclhn", scores, vh)
    y_intra = y_intra + diag.permute(0, 1, 3, 2)[..., None] * vh  # (B,nc,L,H,n)

    # chunk-boundary contributions: a loop over chunks carrying S
    k_state = kh * torch.exp(total[:, :, None] - cum)  # decayed to chunk end
    y_cross = []
    for c in range(nc):
        y_cross.append(torch.einsum("blhi,bhij->blhj", r_f[:, c], S))
        S = torch.exp(total[:, c])[..., None] * S + torch.einsum(
            "blhi,blhj->bhij", k_state[:, c], vh[:, c])
    y = y_intra + torch.stack(y_cross, 1)
    return y.reshape(b, t, h, n), S


def init_rwkv_channel_mix(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                          lead: Lead = ()) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wk": dense_init_on(gen, d, f, dtype, lead),
        "wv": dense_init_on(gen, f, d, dtype, lead),
        "wr": dense_init_on(gen, d, d, dtype, lead),
        "mu": _full(lead, (2, d), 0.5, dtype, gen),
    }


def rwkv_channel_mix(p: Dict, x: torch.Tensor, x_prev_last: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared-relu channel mix with token shift. Returns (out, new last x)."""
    x_prev = _shifted(x, x_prev_last)
    xk = x + (x_prev - x) * p["mu"][0]
    xr = x + (x_prev - x) * p["mu"][1]
    k = torch.square(F.relu(matmul(xk, p["wk"])))
    out = torch.sigmoid(matmul(xr, p["wr"])) * matmul(k, p["wv"])
    return shard(out, "batch", "seq", "embed"), x[:, -1]


def init_rwkv_state(cfg: ModelConfig, batch: int, device: torch.device,
                    lead: Lead = ()) -> RWKVState:
    h, n = rwkv_dims(cfg)
    dt = getattr(torch, cfg.dtype)
    return RWKVState(
        wkv=torch.zeros(lead + (batch, h, n, n), dtype=torch.float32, device=device),
        shift_tm=torch.zeros(lead + (batch, cfg.d_model), dtype=dt, device=device),
        shift_cm=torch.zeros(lead + (batch, cfg.d_model), dtype=dt, device=device),
    )


# ===========================================================================
# Mamba head bank (Hymba)
# ===========================================================================


class MambaState(NamedTuple):
    h: torch.Tensor       # (B, inner, state)
    conv: torch.Tensor    # (B, conv_width - 1, inner) rolling conv input buffer


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    inner = cfg.d_model
    state = cfg.ssm.state_size
    dt_rank = cfg.ssm.dt_rank or max(1, cfg.d_model // 16)
    return inner, state, dt_rank


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               lead: Lead = ()) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    inner, state, dt_rank = mamba_dims(cfg)
    cw = cfg.ssm.conv_width
    f32 = torch.float32
    log_a = torch.log(torch.arange(1, state + 1, dtype=f32, device=gen.device))
    return {
        "in_x": dense_init_on(gen, d, inner, dtype, lead),
        "in_z": dense_init_on(gen, d, inner, dtype, lead),
        "conv": normal_on(gen, (cw, inner), 0.1, dtype, lead),
        "x_proj": dense_init_on(gen, inner, dt_rank + 2 * state, dtype, lead),
        "dt_proj": dense_init_on(gen, dt_rank, inner, f32, lead),
        "dt_bias": _full(lead, (inner,), -4.6, f32, gen),    # softplus -> dt ~ 0.01
        "log_a": log_a.expand(lead + (inner, state)).contiguous(),  # A = -exp(log_a)
        "d_skip": _full(lead, (inner,), 1.0, f32, gen),
        "out": dense_init_on(gen, inner, d, dtype, lead),
    }


def _mamba_preproc(p: Dict, x: torch.Tensor, conv_buf: torch.Tensor, cfg: ModelConfig):
    """Shared projection + causal conv. x: (B,T,d).  B and C come back as
    column slices of one fp32 copy of ``x_proj``'s output (strided views),
    the reference's ``astype(float32)`` of each split."""
    inner, state, dt_rank = mamba_dims(cfg)
    cw = cfg.ssm.conv_width
    t = x.shape[1]
    xi = x @ p["in_x"]                                   # (B,T,inner)
    z = F.silu(x @ p["in_z"])
    # causal depthwise conv over time with carried buffer, fp32 sums
    xc = torch.cat([conv_buf.to(xi.dtype), xi], dim=1)  # (B, T+cw-1, inner)
    w = p["conv"].float()
    acc = xc[:, 0:t].float() * w[0]
    for c in range(1, cw):
        acc = acc + xc[:, c:c + t].float() * w[c]
    xi = F.silu(acc.to(xi.dtype))
    new_buf = xc[:, xc.shape[1] - (cw - 1):]
    proj = (xi @ p["x_proj"]).float()
    dt_in, B, C = torch.split(proj, [dt_rank, state, state], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"])
    return xi, z, dt, B, C, new_buf


def mamba_scan(p: Dict, x: torch.Tensor, st: MambaState, cfg: ModelConfig,
               impl: str = "xla") -> Tuple[torch.Tensor, MambaState]:
    """Selective scan over time. x: (B,T,d) -> (B,T,d).

    ``impl="cuda"`` sends the scan through the mamba op, the hand-written
    CUDA kernel with the state in registers: the counterpart of the
    reference's ``impl="pallas"`` (its VMEM-resident TPU kernel, which the
    reference takes only when T > 1), at any T, decode included.
    ``"xla"`` (the default) is the per-token loop.
    """
    _check_impl(impl)
    xi, z, dt, B, C, new_buf = _mamba_preproc(p, x, st.conv, cfg)
    A = -torch.exp(p["log_a"])                           # (inner, state)
    scan = selective_scan if impl == "cuda" else selective_scan_ref
    # on a mesh the scan runs on each rank's batch rows and channels
    y, h_fin = local_map_channels(scan, (xi.float(), dt, B, C, A, st.h),
                                  [(0, 2), (0, 2), (0, None), (0, None), (None, 0), (0, 1)],
                                  [(0, 2), (0, 1)])
    y = y + p["d_skip"] * xi.float()
    out = (y.to(x.dtype) * z) @ p["out"]
    return shard(out, "batch", "seq", "embed"), MambaState(h_fin, new_buf)


def init_mamba_state(cfg: ModelConfig, batch: int, device: torch.device,
                     lead: Lead = ()) -> MambaState:
    inner, state, _ = mamba_dims(cfg)
    cw = cfg.ssm.conv_width
    return MambaState(
        h=torch.zeros(lead + (batch, inner, state), dtype=torch.float32, device=device),
        conv=torch.zeros(lead + (batch, cw - 1, inner), dtype=getattr(torch, cfg.dtype),
                         device=device),
    )
