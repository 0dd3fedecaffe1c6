"""Plain PyTorch versions of the flash-attention forward kernel.

Two functions of the same attention (scores ``q . k^T * D^-1/2`` in f32,
causal ``j <= i`` and sliding-window ``i - j < window`` masks at -1e30,
softmax, times v):

  * ``flash_attention_ref``: the oracle, a port of
    ``repro.kernels.flash_attention.ref.flash_attention_ref``. It
    materialises the scores of q, k, v [BH, S, D] (contiguous positions)
    and multiplies by v in f32. The kernel is held against it, and it
    against the JAX oracle.
  * ``flash_attention_chunked``: the model's online softmax, a port of
    ``repro.nn.attention._flash_fwd`` on q [B, Sq, Kh, G, D] and k, v
    [B, Skv, Kh, D] with explicit positions: ``chunk`` query rows against
    ``kv_chunk`` keys at a time (each the largest divisor of its length
    not above the request, as the reference splits), a running max, sum
    and numerator in f32, p and v rounded to bf16 before their product
    (exact in f32), f32 sums, and ``acc / max(l, 1e-30)``.
    ``flash_attention_gqa`` runs it on the model layout (q [B, Sq, H,
    D], k, v [B, Skv, Kh, D], positions from 0): what
    ``dispatch.flash_attention`` computes for a CPU tensor or
    ``backend="ref"``, so on the CPU the model computes what the JAX model
    computes.

The kernel's f32 scores, in plain PyTorch (nothing on the main path calls
them; the CPU tests hold them against f64 and the JAX oracle):

  * ``split_pieces``: x = hi + mid + lo, three bf16 values by truncation,
    as the kernel splits q * scale and k;
  * ``piece_scores``: q . k from the six products of the pieces whose
    weight reaches 2^-16 (each exact), summed in f32 in the kernel's order,
    the five smaller first, then hi . hi;
  * ``flash_attention_pieces``: ``flash_attention_ref`` on those scores,
    with p and v rounded to bf16 before their product, as the kernel.

Every product here is f32 with TF32 off.
"""
from __future__ import annotations

import torch

from ..floatsd_matmul.ref import no_tf32

__all__ = ["NEG_INF", "softmax_scale", "flash_attention_ref", "flash_attention_chunked",
           "flash_attention_gqa", "split_pieces", "PIECE_PRODUCTS", "piece_scores", "flash_attention_pieces"]

NEG_INF = -1e30


def softmax_scale(d: int) -> float:
    """D^-1/2 as the reference model forms it: an f32 square root, then an
    f32 reciprocal (a Python float holding that f32 value)."""
    return float(1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32)))


def _mask(qp: torch.Tensor, kp: torch.Tensor, causal: bool, window: int | None) -> torch.Tensor:
    """[..., Sq] and [..., Skv] positions -> [..., Sq, Skv] admitted pairs."""
    mask = torch.ones(qp.shape + kp.shape[-1:], dtype=torch.bool, device=qp.device)
    if causal:
        mask &= kp[..., None, :] <= qp[..., :, None]
    if window is not None:
        mask &= qp[..., :, None] - kp[..., None, :] < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """q [BH, Sq, D], k, v [BH, Skv, D] -> [BH, Sq, D] in q's dtype."""
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    qpos = torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    with no_tf32():
        s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32) * scale, k.to(torch.float32))
        s = torch.where(_mask(qpos, kpos, causal, window)[None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)


def _split(n: int, chunk: int) -> int:
    """The number of chunks: the largest count not above n // chunk (at
    least 1) that divides n."""
    c = max(1, n // chunk)
    while n % c:
        c -= 1
    return c


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def flash_attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                            k_pos: torch.Tensor, *, causal: bool = True, window: int | None = None,
                            chunk: int = 1024, kv_chunk: int = 512) -> torch.Tensor:
    """q [B, Sq, Kh, G, D], k, v [B, Skv, Kh, D], q_pos [B, Sq], k_pos
    [B, Skv] -> [B, Sq, Kh, G, D] in q's dtype."""
    b, sq, kh, g, d = q.shape
    skv = k.shape[1]
    scale = softmax_scale(d)
    nq, nk = _split(sq, chunk), _split(skv, kv_chunk)
    qc, kc = sq // nq, skv // nk
    out = torch.empty((b, sq, kh, g, d), dtype=torch.float32, device=q.device)
    with no_tf32():
        for i in range(nq):
            qf = q[:, i * qc:(i + 1) * qc].to(torch.float32) * scale
            qp = q_pos[:, i * qc:(i + 1) * qc]
            m = torch.full((b, kh, g, qc), NEG_INF, dtype=torch.float32, device=q.device)
            l = torch.zeros((b, kh, g, qc), dtype=torch.float32, device=q.device)
            acc = torch.zeros((b, kh, g, qc, d), dtype=torch.float32, device=q.device)
            for j in range(nk):
                kj = k[:, j * kc:(j + 1) * kc].to(torch.float32)
                vj = v[:, j * kc:(j + 1) * kc]
                s = torch.einsum("bqkgd,bckd->bkgqc", qf, kj)
                mask = _mask(qp, k_pos[:, j * kc:(j + 1) * kc], causal, window)  # [B, qc, kc]
                s = torch.where(mask[:, None, None], s, NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None] + torch.einsum("bkgqc,bckd->bkgqd", _bf16(p), _bf16(vj))
                m = m_new
            o = acc / torch.clamp(l, min=1e-30)[..., None]  # [B, Kh, G, qc, D]
            out[:, i * qc:(i + 1) * qc] = o.permute(0, 3, 1, 2, 4)
    return out.to(q.dtype)


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, chunk: int = 1024, kv_chunk: int = 512) -> torch.Tensor:
    """The model layout: q [B, Sq, H, D], k, v [B, Skv, Kh, D] (query head
    h reads KV head h // (H / Kh)), positions from 0 -> [B, Sq, H, D]."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    q_pos = torch.arange(sq, device=q.device).expand(b, sq)
    k_pos = torch.arange(skv, device=q.device).expand(b, skv)
    out = flash_attention_chunked(q.reshape(b, sq, kh, h // kh, d), k, v, q_pos, k_pos, causal=causal,
                                  window=window, chunk=chunk, kv_chunk=kv_chunk)
    return out.reshape(b, sq, h, d)


def split_pieces(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 x -> (hi, mid, lo), bf16 values (as f32) with hi + mid + lo == x
    wherever lo stays a normal f32 (|x| above about 2^-100): hi is x with
    its low 16 bits cleared, mid the same of r = x - hi, lo = r - mid (both
    differences exact). A non-finite x goes whole into hi."""
    x = x.to(torch.float32).contiguous()
    top = torch.tensor(-65536, dtype=torch.int32)  # 0xFFFF0000

    def trunc(t):
        return (t.view(torch.int32) & top).view(torch.float32)

    finite = torch.isfinite(x)
    hi = torch.where(finite, trunc(x), x)
    r = torch.where(finite, x - hi, torch.zeros_like(x))
    mid = trunc(r)
    return hi, mid, r - mid


#: the six products (q piece, k piece) whose weight reaches 2^-16, in the
#: kernel's order: the five smaller ones, then hi . hi
PIECE_PRODUCTS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def piece_scores(q: torch.Tensor, k: torch.Tensor, products=PIECE_PRODUCTS) -> torch.Tensor:
    """[..., Sq, D] x [..., Skv, D] -> [..., Sq, Skv]: q . k from the
    products of their pieces, each product's sum over d taken in f64 (the
    products are exact) and the products added in f32 in the given order."""
    qp, kp = split_pieces(q), split_pieces(k)
    out = None
    for a, c in products:
        part = torch.einsum("...qd,...kd->...qk", qp[a].double(), kp[c].double()).float()
        out = part if out is None else out + part
    return out


def flash_attention_pieces(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                           window: int | None = None, products=PIECE_PRODUCTS) -> torch.Tensor:
    """The oracle's attention, q [BH, Sq, D], k, v [BH, Skv, D] -> [BH, Sq,
    D] in q's dtype, on ``piece_scores`` of q * scale and k, with p and v
    rounded to bf16 before their product, as the kernel forms them."""
    d = q.shape[-1]
    qpos = torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    with no_tf32():
        s = piece_scores(q.to(torch.float32) * softmax_scale(d), k.to(torch.float32), products)
        s = torch.where(_mask(qpos, kpos, causal, window)[None], s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        o = torch.einsum("bqk,bkd->bqd", _bf16(p), _bf16(v.to(torch.float32))) / p.sum(dim=-1, keepdim=True)
        return o.to(q.dtype)
