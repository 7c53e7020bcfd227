"""Mamba-2 SSD (state-space duality) mixer, as in the reference
(``repro.models.ssm``): the chunked algorithm (quadratic within a chunk,
linear across chunks) for a whole sequence, and the O(1)-state decode
step.

Pruning (paper §5.2.4): the in/out projections are block-prunable FC
layers; the depthwise conv1d and the small SSD parameters (A, D, dt bias)
are never pruned.

Sparse serving: both projections go through ``layers.linear``, so once
``serve.compile.compile_model`` installs a ``core.packed.PackedLayout``
next to ``in_proj`` / ``out_proj`` they run on the BCS kernel (kernel 1)
in the full-sequence mixer and in the decode step alike.  The in_proj
covers the z (gate), xBC and dt streams in one product, so packing it
sparsifies all three.  ``_dims`` reads the geometry from the dense weight
or from the layout, so ``keep_dense=False`` serving works.  The SSD scan,
the conv1d, softplus and the gating stay plain torch (the reference leaves
them to XLA); the scan runs in fp32, as the reference's does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def ssm_init(d_model, d_state, generator, headdim=64, expand=2,
             conv_width=4, n=None, dtype=torch.bfloat16, device="cpu"):
    """One mixer's params (each leaf with a leading ``n`` layer dim when
    ``n`` is given).  in_proj, conv and out_proj are drawn from
    ``generator`` in that order; A_log = log(linspace(1, 16, H)), D = 1
    and dt_bias = 0 stay fp32 whatever ``dtype``."""
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    conv_dim = d_inner + 2 * d_state                 # n_groups == 1
    proj_out = 2 * d_inner + 2 * d_state + n_heads
    lead = () if n is None else (n,)
    kw = dict(dtype=dtype, device=device)

    def f32(t):
        return t.expand(lead + t.shape).contiguous()
    return {
        "in_proj": L.linear_init(d_model, proj_out, generator, n, **kw),
        "conv": L.conv1d_init(conv_dim, conv_width, generator, n, **kw),
        "A_log": f32(torch.log(torch.linspace(1.0, 16.0, n_heads,
                                              device=device))),
        "D": f32(torch.ones(n_heads, device=device)),
        "dt_bias": f32(torch.zeros(n_heads, device=device)),
        "norm": {"scale": torch.ones(lead + (d_inner,), **kw)},
        "out_proj": L.linear_init(d_inner, d_model, generator, n, **kw),
    }


def _proj_kn(p):
    """(K, N) of a projection node, from the dense weight or, once
    ``compile_model(keep_dense=False)`` dropped "w", from the packed
    layout's shape (the same by construction)."""
    w = p.get("w")
    return tuple(w.shape[-2:]) if w is not None else tuple(p["packed"].shape)


def _dims(params):
    """(d_inner, heads, headdim, d_state) of one mixer."""
    d_inner = _proj_kn(params["out_proj"])[0]
    n_heads = params["A_log"].shape[-1]
    conv_dim = params["conv"]["w"].shape[-1]
    return d_inner, n_heads, d_inner // n_heads, (conv_dim - d_inner) // 2


def _segsum(x):
    """(..., Q) -> (..., Q, Q) lower-triangular segment sums (log-decay):
    cs[i] - cs[j] on and below the diagonal, -inf above (so exp gives
    exact zeros there)."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, torch.full_like(diff, -torch.inf))


def _ssd_scan(xh, dt, A, Bm, Cm, chunk=64):
    """Chunked SSD.  xh (B, S, H, P); dt (B, S, H) after softplus; A (H,)
    negative; Bm, Cm (B, S, H, N) (groups already broadcast).  Returns
    y (B, S, H, P) and the final state (B, H, P, N), both fp32.

    The reference's three- and four-operand einsums are written as
    pairwise products, in this order:
      y_diag = ((C @ B^T) * Ldec) @ (x dt)    per chunk and head
      states = (x dt * decay)^T @ B           per chunk and head
      y_off  = (C @ h_prev^T) * exp(cumsum)   per chunk and head
    """
    Bsz, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"ssd scan: sequence length {S} is not a multiple "
                         f"of the chunk {chunk}")
    c = S // chunk

    def r(t, *tail):              # (B, S, ...) -> (B, c, chunk, ...) fp32
        return t.reshape(Bsz, c, chunk, *tail).float()

    xc, dtc = r(xh, H, Pd), r(dt, H)
    # (B, c, H, Q, N): heads ahead of positions for the per-head products
    Bc = r(Bm, H, N).permute(0, 1, 3, 2, 4)
    Cc = r(Cm, H, N).permute(0, 1, 3, 2, 4)

    dA = (dtc * A).permute(0, 1, 3, 2)               # (B, c, H, Q)
    dA_cs = torch.cumsum(dA, dim=-1)
    Ldec = torch.exp(_segsum(dA))                    # (B, c, H, Q, Q)
    xdt = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)   # (B, c, H, Q, P)

    scores = torch.matmul(Cc, Bc.transpose(-1, -2)) * Ldec   # (.., Q, K)
    y_diag = torch.matmul(scores, xdt)                        # (.., Q, P)

    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)         # (B, c, H, Q)
    states = torch.matmul((xdt * decay_states[..., None]).transpose(-1, -2),
                          Bc)                                 # (.., P, N)
    chunk_decay = torch.exp(dA_cs[..., -1])                   # (B, c, H)

    # the inter-chunk recurrence, emitting the state ENTERING each chunk
    h = torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=xh.device)
    prev = []
    for i in range(c):
        prev.append(h)
        h = h * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                    # (B,c,H,P,N)

    state_decay = torch.exp(dA_cs)                            # (B, c, H, Q)
    y_off = torch.matmul(Cc, prev_states.transpose(-1, -2)) \
        * state_decay[..., None]                              # (.., Q, P)
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, Pd)
    return y, h


def _split(zxbcdt, d_inner, N):
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * N,
                                zxbcdt.shape[-1] - 2 * d_inner - 2 * N],
                       dim=-1)


def ssm(params, x, *, masks=None, chunk=64, dist=None):
    """Full-sequence mamba2 mixer.  x (B, S, D) -> (B, S, D), and the
    decode state {h: (B, H, P, N) fp32, conv: (B, width - 1, conv_dim)}:
    conv holds the last pre-conv inputs (zero-padded in front when S <
    width - 1), so a following decode step sees the exact causal window."""
    m = masks or {}
    Bsz, S, _ = x.shape
    d_inner, H, Pd, N = _dims(params)
    width = params["conv"]["w"].shape[0]
    zxbcdt = L.linear(params["in_proj"], x, m.get("in_proj"))
    z, xbc, dt = _split(zxbcdt, d_inner, N)
    conv_tail = xbc[:, max(S - (width - 1), 0):, :]
    if S < width - 1:
        conv_tail = F.pad(conv_tail, (0, 0, width - 1 - S, 0))
    xbc = F.silu(L.causal_conv1d(params["conv"], xbc))
    xh, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    xh = xh.reshape(Bsz, S, H, Pd)
    Bm = Bm[:, :, None, :].expand(Bsz, S, H, N)
    Cm = Cm[:, :, None, :].expand(Bsz, S, H, N)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    if dist is None:
        y, h_last = _ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk)
    else:
        # heads are independent through the scan: each rank scans its own
        # (``Dist.local_map``; DTensor cannot run the chunk loop)
        xh = dist.shard_heads(xh)
        y, h_last = dist.local_map(
            lambda *a: _ssd_scan(*a, chunk=chunk), (2, 2, 0, 2, 2),
            (2, 1))(xh, dt, A, Bm, Cm)
    y = y + xh.float() * params["D"][:, None]
    y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    y = L.rmsnorm(params["norm"], y * F.silu(z))
    out = L.linear(params["out_proj"], y, m.get("out_proj"))
    return out, {"h": h_last, "conv": conv_tail.contiguous()}


def ssm_decode(params, x, state, *, masks=None, dist=None):
    """One-token decode.  x (B, 1, D); state {h: (B, H, P, N) fp32,
    conv: (B, width - 1, conv_dim)}.  Returns ((B, 1, D), new state).
    ``dist`` is accepted and unused, as in the reference."""
    m = masks or {}
    Bsz = x.shape[0]
    d_inner, H, Pd, N = _dims(params)
    zxbcdt = L.linear(params["in_proj"], x[:, 0, :], m.get("in_proj"))
    z, xbc, dt = _split(zxbcdt, d_inner, N)
    conv_state, xbc = L.conv1d_step(params["conv"], state["conv"], xbc)
    xbc = F.silu(xbc)
    xh, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    xh = xh.reshape(Bsz, H, Pd).float()
    dt = F.softplus(dt.float() + params["dt_bias"])              # (B, H)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A)                                       # (B, H)
    Bf, Cf = Bm.float(), Cm.float()
    # the reference's "bh,bhp,bn->bhpn": (dt x) first, then the outer
    # product with B
    h = state["h"] * dA[..., None, None] + (
        (dt[..., None] * xh)[..., None] * Bf[:, None, None, :])
    y = torch.matmul(h, Cf[:, None, :, None])[..., 0] \
        + xh * params["D"][:, None]
    y = y.reshape(Bsz, d_inner).to(x.dtype)
    y = L.rmsnorm(params["norm"], y * F.silu(z))
    out = L.linear(params["out_proj"], y, m.get("out_proj"))
    return out[:, None, :], {"h": h, "conv": conv_state}


def ssm_state_init(params, batch, dtype=torch.bfloat16):
    """A zero decode state for one mixer."""
    d_inner, H, Pd, N = _dims(params)
    width, conv_dim = params["conv"]["w"].shape[-2:]
    dev = params["A_log"].device
    return {"h": torch.zeros((batch, H, Pd, N), dtype=torch.float32,
                             device=dev),
            "conv": torch.zeros((batch, width - 1, conv_dim), dtype=dtype,
                                device=dev)}
