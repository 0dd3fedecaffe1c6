"""Plain PyTorch version of the chunked RWKV-6 wkv kernel: the per-token
recurrence of the JAX oracle ``repro.kernels.rwkv_wkv.ref.wkv_ref``

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),

in the model's per-head layout, with the final state returned beside y.
The CPU tests use it, ``chip_smoke.py`` holds the kernel against it on the
card (the two sum in different orders: within 2e-4), and the model's
sequential path (every decode step, and any S the kernel is not routed
for) is this function from a carried state."""
from __future__ import annotations

import torch

from ..floatsd_matmul.ref import no_tf32

__all__ = ["wkv_ref"]


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
