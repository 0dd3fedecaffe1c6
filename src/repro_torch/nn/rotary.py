"""Rotary position embeddings.

Counterpart of ``repro.nn.rotary``: ``rope_freqs``, ``apply_rope``
(rotate-half RoPE) and ``apply_mrope`` (Qwen2-VL's multimodal RoPE: each
frequency channel turned by the t, h or w id of its section), computed in
f32 and cast back to the input dtype."""
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


def apply_mrope(q: torch.Tensor, k: torch.Tensor, positions3: torch.Tensor, head_dim: int,
                sections=(16, 24, 24), theta: float = 10000.0):
    """q, k [B, S, H, D]; positions3 [B, S, 3] int, the (t, h, w) ids ->
    the rotated (q, k). The D/2 frequency channels fall into ``sections``
    (counts in D/2 units, in t, h, w order), each turned by its own id; with
    t == h == w this is ``apply_rope``."""
    assert sum(sections) == head_dim // 2, (sections, head_dim)
    freqs = rope_freqs(head_dim, theta, q.device)
    sec_id = torch.repeat_interleave(torch.arange(3, device=q.device),
                                     torch.tensor(sections, device=q.device))  # [D/2] in {0, 1, 2}
    pos = torch.gather(positions3.to(torch.float32), -1,
                       sec_id.expand(*positions3.shape[:2], head_dim // 2))  # [B, S, D/2]
    ang = pos * freqs
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    return (_rotate(q.to(torch.float32), sin, cos).to(q.dtype),
            _rotate(k.to(torch.float32), sin, cos).to(k.dtype))
