"""Rotary position embeddings.

Counterpart of ``repro.nn.rotary``: ``rope_freqs`` and ``apply_rope``
(rotate-half RoPE, computed in f32, cast back to the input dtype).
``apply_mrope`` (Qwen2-VL's multimodal RoPE) comes with the ``vlm`` family
(``ROADMAP.md`` Queue 1 item 8)."""
from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope", "apply_mrope"]


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """The D/2 rotation frequencies theta^(-2i/D), f32."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def _rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, head_dim: int,
               theta: float = 10000.0):
    """q, k [B, S, H, D]; positions [B, S] int -> the rotated (q, k)."""
    freqs = rope_freqs(head_dim, theta, q.device)
    ang = positions[..., None].to(torch.float32) * freqs  # [B, S, D/2]
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    return (_rotate(q.to(torch.float32), sin, cos).to(q.dtype),
            _rotate(k.to(torch.float32), sin, cos).to(k.dtype))


def apply_mrope(*args, **kwargs):
    raise NotImplementedError(
        "M-RoPE is not ported: it comes with the vlm family (qwen2_vl_2b, ROADMAP.md Queue 1 item 8)")
