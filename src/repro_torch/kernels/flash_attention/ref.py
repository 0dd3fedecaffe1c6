"""Plain PyTorch versions of the flash-attention forward kernel.

Two functions of the same attention (scores ``q . k^T * D^-1/2`` in f32,
causal ``j <= max(i, prefix - 1)`` and sliding-window ``i - j < window``
masks at -1e30, softmax, times v):

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
    D], k, v [B, Skv, Kh, D], positions from 0, a causal ``prefix``): what
    ``dispatch.flash_attention`` computes for a CPU tensor or
    ``backend="ref"``, so on the CPU the model computes what the JAX model
    computes. With ``return_lse`` both also give each row's log-sum-exp
    m + log(max(l, 1e-30)), the residual of the backward.
  * ``flash_bwd``: the training path's backward, a port of the reference
    model's ``_flash_bwd`` (its chunks and bf16 roundings) on the saved o
    and lse, on CPU tensors and on the card alike (no kernel of it yet).

The kernel's f32 scores, in plain PyTorch (nothing on the main path calls
them; the CPU tests hold them against f64 and the JAX oracle):

  * ``split_pieces``: x = hi + mid + lo, three bf16 values by truncation,
    as the kernel splits q * scale and k;
  * ``piece_scores``: q . k from the six products of the pieces whose
    weight reaches 2^-16 (each exact), summed in f32 in the kernel's order,
    the five smaller first, then hi . hi;
  * ``flash_attention_pieces``: ``flash_attention_ref`` on those scores,
    with p and v rounded to bf16 before their product, as the kernel.

The causal ``prefix`` P (0 but for Qwen2-VL's patch prefill): the first P
positions see one another whole, and every later position sees them, as the
reference's position mask does (``repro.nn.attention``: key t <= query t)
on its M-RoPE t ids: 0 for the P patches, i - P + side for text position
i, side = floor(sqrt(P)) >= 1 (``repro.models.lm._positions``). Zero
wherever a window is set (no config has both).

Every product here is f32 with TF32 off.
"""
from __future__ import annotations

import torch

from ..floatsd_matmul.ref import no_tf32

__all__ = ["NEG_INF", "softmax_scale", "check_prefix", "flash_attention_ref", "flash_attention_chunked",
           "flash_attention_gqa", "flash_bwd", "split_pieces", "PIECE_PRODUCTS", "piece_scores", "flash_attention_pieces"]

NEG_INF = -1e30


def softmax_scale(d: int) -> float:
    """D^-1/2 as the reference model forms it: an f32 square root, then an
    f32 reciprocal (a Python float holding that f32 value)."""
    return float(1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32)))


def check_prefix(prefix: int, window: int | None) -> None:
    """A causal prefix is >= 0, and 0 under a window."""
    if prefix < 0 or (prefix and window is not None):
        raise ValueError(f"flash_attention: prefix must be >= 0, and 0 under a window; got prefix {prefix}, "
                         f"window {window}")


def _mask(qp: torch.Tensor, kp: torch.Tensor, causal: bool, window: int | None, prefix: int = 0) -> torch.Tensor:
    """[..., Sq] and [..., Skv] positions -> [..., Sq, Skv] admitted pairs."""
    mask = torch.ones(qp.shape + kp.shape[-1:], dtype=torch.bool, device=qp.device)
    if causal:
        mask &= kp[..., None, :] <= (torch.clamp(qp, min=prefix - 1) if prefix else qp)[..., :, None]
    if window is not None:
        mask &= qp[..., :, None] - kp[..., None, :] < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                        window: int | None = None, prefix: int = 0) -> torch.Tensor:
    """q [BH, Sq, D], k, v [BH, Skv, D] -> [BH, Sq, D] in q's dtype."""
    check_prefix(prefix, window)
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    qpos = torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    with no_tf32():
        s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32) * scale, k.to(torch.float32))
        s = torch.where(_mask(qpos, kpos, causal, window, prefix)[None], s, NEG_INF)
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
                            chunk: int = 1024, kv_chunk: int = 512, prefix: int = 0, return_lse: bool = False):
    """q [B, Sq, Kh, G, D], k, v [B, Skv, Kh, D], q_pos [B, Sq], k_pos
    [B, Skv] -> [B, Sq, Kh, G, D] in q's dtype; with ``return_lse`` also
    each row's log-sum-exp m + log(max(l, 1e-30)), f32 [B, Kh, G, Sq], the
    residual the reference's custom VJP saves."""
    check_prefix(prefix, window)
    b, sq, kh, g, d = q.shape
    skv = k.shape[1]
    scale = softmax_scale(d)
    nq, nk = _split(sq, chunk), _split(skv, kv_chunk)
    qc, kc = sq // nq, skv // nk
    out = torch.empty((b, sq, kh, g, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, kh, g, sq), dtype=torch.float32, device=q.device) if return_lse else None
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
                mask = _mask(qp, k_pos[:, j * kc:(j + 1) * kc], causal, window, prefix)  # [B, qc, kc]
                s = torch.where(mask[:, None, None], s, NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None] + torch.einsum("bkgqc,bckd->bkgqd", _bf16(p), _bf16(vj))
                m = m_new
            o = acc / torch.clamp(l, min=1e-30)[..., None]  # [B, Kh, G, qc, D]
            out[:, i * qc:(i + 1) * qc] = o.permute(0, 3, 1, 2, 4)
            if lse is not None:
                lse[..., i * qc:(i + 1) * qc] = m + torch.log(torch.clamp(l, min=1e-30))
    return (out.to(q.dtype), lse) if return_lse else out.to(q.dtype)


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, chunk: int = 1024, kv_chunk: int = 512,
                        prefix: int = 0, return_lse: bool = False):
    """The model layout: q [B, Sq, H, D], k, v [B, Skv, Kh, D] (query head
    h reads KV head h // (H / Kh)), positions from 0, a causal ``prefix``
    -> [B, Sq, H, D]; with ``return_lse`` also each row's log-sum-exp, f32
    [B, H, Sq] (the kernel's layout)."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    q_pos = torch.arange(sq, device=q.device).expand(b, sq)
    k_pos = torch.arange(skv, device=q.device).expand(b, skv)
    out = flash_attention_chunked(q.reshape(b, sq, kh, h // kh, d), k, v, q_pos, k_pos, causal=causal,
                                  window=window, chunk=chunk, kv_chunk=kv_chunk, prefix=prefix,
                                  return_lse=return_lse)
    if return_lse:
        return out[0].reshape(b, sq, h, d), out[1].reshape(b, h, sq)
    return out.reshape(b, sq, h, d)


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
              do: torch.Tensor, *, causal: bool = True, window: int | None = None, prefix: int = 0,
              chunk: int = 1024, kv_chunk: int = 512):
    """The attention's backward, a port of the reference's ``_flash_bwd``
    (``repro.nn.attention``) on the model layout: q, o, do [B, Sq, H, D],
    k, v [B, Skv, Kh, D], lse [B, H, Sq] f32 (the forward's) -> (dq, dk,
    dv) in q's, k's and v's dtypes. The score tiles are recomputed per
    chunk of ``chunk`` query rows and ``kv_chunk`` keys (the reference's
    split, each the largest divisor of its length not above the request):
    p = exp(s - lse), dv = p^T do, dp = do v^T, ds = p (dp - delta) scale
    with delta = rowsum(do o), dq = ds k, dk = ds^T q. p, ds, do, k and q
    are rounded to bf16 before their products (dp takes do and v in f32),
    every sum is f32, dk and dv accumulate over the query chunks in order.
    The mask is the forward's (positions from 0, the causal ``prefix``, the
    window). A tile whose every pair the mask rejects adds exactly zero
    (its p is 0) unless a row of its chunk admits no key at all, so it is
    skipped, decided on the host from the positions."""
    check_prefix(prefix, window)
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = softmax_scale(d)
    nq, nk = _split(sq, chunk), _split(skv, kv_chunk)
    qc, kc = sq // nq, skv // nk
    dev = q.device
    q5, o5, do5 = (t.reshape(b, sq, kh, g, d) for t in (q, o, do))
    lse5 = lse.reshape(b, kh, g, sq)
    dq = torch.empty((b, sq, kh, g, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, skv, kh, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, skv, kh, d), dtype=torch.float32, device=dev)
    q_pos, k_pos = torch.arange(sq, device=dev), torch.arange(skv, device=dev)
    host_q, host_k = torch.arange(sq), torch.arange(skv)
    with no_tf32():
        delta = torch.einsum("bqkgd,bqkgd->bkgq", do5.to(torch.float32), o5.to(torch.float32))
        for i in range(nq):
            rows = slice(i * qc, (i + 1) * qc)
            qi = q5[:, rows].to(torch.float32)
            qf, qb = qi * scale, _bf16(qi)
            dof = do5[:, rows].to(torch.float32)
            dob = _bf16(dof)
            lse_c, delta_c = lse5[..., rows, None], delta[..., rows, None]
            # a row of the chunk with no admitted key at all (Sq > Skv under a window) spreads p over every key
            lonely = window is not None and (i + 1) * qc - 1 >= skv - 1 + window
            dq_c = torch.zeros((b, qc, kh, g, d), dtype=torch.float32, device=dev)
            for j in range(nk):
                keys = slice(j * kc, (j + 1) * kc)
                if not lonely and not _mask(host_q[rows], host_k[keys], causal, window, prefix).any():
                    continue
                kj = k[:, keys].to(torch.float32)
                s = torch.einsum("bqkgd,bckd->bkgqc", qf, kj)
                s = torch.where(_mask(q_pos[rows], k_pos[keys], causal, window, prefix), s, NEG_INF)
                p = torch.exp(s - lse_c)
                dv[:, keys] += torch.einsum("bkgqc,bqkgd->bckd", _bf16(p), dob)
                dp = torch.einsum("bqkgd,bckd->bkgqc", dof, v[:, keys].to(torch.float32))
                dsb = _bf16(p * (dp - delta_c) * scale)
                dq_c = dq_c + torch.einsum("bkgqc,bckd->bqkgd", dsb, _bf16(kj))
                dk[:, keys] += torch.einsum("bkgqc,bqkgd->bckd", dsb, qb)
            dq[:, rows] = dq_c
    return dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
