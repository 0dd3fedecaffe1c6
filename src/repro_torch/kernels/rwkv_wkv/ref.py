"""Plain PyTorch version of the chunked RWKV-6 wkv kernel: the per-token
recurrence of the JAX oracle ``repro.kernels.rwkv_wkv.ref.wkv_ref``

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),

in the model's per-head layout, with the final state returned beside y.
The CPU tests use it, ``chip_smoke.py`` holds the kernel against it on the
card (the two sum in different orders: within 2e-4), and the model's
sequential path (every decode step, and any S the kernel is not routed
for) is this function from a carried state.

``wkv_chunked`` mirrors the kernel's decomposition in plain PyTorch (the
CPU tests hold it against ``wkv_ref`` and the JAX Pallas kernel; nothing on
the main path calls it): per chunk of 16, the record the kernel's pre-pass
forms once (q = r e^{bprev}, kd = k e^{b_last - b}, the tile with the
pairwise decay e^{min(bprev_t - b_i, 0)} below the diagonal and the bonus
on it, e^{b_last}), then the walk y = q S + A v, S <- e^{b_last} S + kd^T
v."""
from __future__ import annotations

import torch

from ..floatsd_matmul.ref import no_tf32

__all__ = ["wkv_ref", "wkv_chunked", "CHUNK"]

CHUNK = 16  # the kernel's chunk length


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
            s0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, w [B, S, H, K], v [B, S, H, V], u [H, K] or [B, H, K], s0
    [B, H, K, V] (None: zeros) -> (y [B, S, H, V], s_fin [B, H, K, V]),
    every product and sum in f32."""
    f = lambda t: t.to(torch.float32)  # noqa: E731
    b, s, h, kk = r.shape
    vv = v.shape[-1]
    st = (torch.zeros((b, h, kk, vv), dtype=torch.float32, device=r.device)
          if s0 is None else f(s0))
    uu = f(u)[..., None]
    y = torch.empty((b, s, h, vv), dtype=torch.float32, device=r.device)
    with no_tf32():
        for t in range(s):
            kv = f(k[:, t])[..., :, None] * f(v[:, t])[..., None, :]
            y[:, t] = torch.einsum("bhk,bhkv->bhv", f(r[:, t]), torch.addcmul(st, uu, kv))
            st = torch.addcmul(kv, st, f(w[:, t])[..., None])
    return y, st


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                chunk: int = CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's chunked form from a zero state, same arguments and
    results as ``wkv_ref`` (a short last chunk: r = k = v = 0, w = 1 past S),
    every product and sum in f32."""
    f = lambda t: t.to(torch.float32)  # noqa: E731
    b, s, h, kk = r.shape
    vv = v.shape[-1]
    n = -(-s // chunk)
    pad = n * chunk - s

    def chunks(t, fill):  # [B, S, H, X] -> [B, H, n, chunk, X]
        t = torch.nn.functional.pad(f(t), (0, 0, 0, 0, 0, pad), value=fill)
        return t.reshape(b, n, chunk, h, -1).permute(0, 3, 1, 2, 4)

    rc, kc, vc, wc = chunks(r, 0.0), chunks(k, 0.0), chunks(v, 0.0), chunks(w, 1.0)
    uu = f(u).expand(b, h, kk)[:, :, None, None, :]  # [B, H, 1, 1, K]
    with no_tf32():
        lw = torch.log(torch.clamp(wc, min=1e-38))
        bb = torch.cumsum(lw, dim=-2)  # inclusive, within the chunk
        bprev = bb - lw
        blast = bb[..., -1:, :]
        q = rc * torch.exp(bprev)
        kd = kc * torch.exp(blast - bb)
        # the tile [.., t, i]: sum_k r_tk k_ik e^{min(bprev_tk - b_ik, 0)} below the diagonal, the bonus on it
        decay = torch.exp(torch.clamp(bprev[..., :, None, :] - bb[..., None, :, :], max=0.0))
        tile = (rc[..., :, None, :] * kc[..., None, :, :] * decay).sum(-1)
        tri = torch.ones(chunk, chunk, dtype=torch.bool).tril(-1)
        tile = torch.where(tri, tile, 0.0) + torch.diag_embed((rc * uu * kc).sum(-1))
        st = torch.zeros((b, h, kk, vv), dtype=torch.float32, device=r.device)
        ys = []
        for c in range(n):
            ys.append(q[:, :, c] @ st + tile[:, :, c] @ vc[:, :, c])
            st = torch.exp(blast[:, :, c])[..., 0, :, None] * st + kd[:, :, c].transpose(-1, -2) @ vc[:, :, c]
        y = torch.stack(ys, dim=2).reshape(b, h, n * chunk, vv)[:, :, :s].permute(0, 2, 1, 3)
    return y.contiguous(), st
