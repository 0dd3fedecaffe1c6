"""Wrapper of the flash-attention forward kernel (``flash_attention.cu``).

Takes the plain version for tensors on the CPU and launches the CUDA kernel
for tensors on the card; there is no fallback between the two. A call on
the card is two device kernels, the K/V pre-pass (``flash_split_kv``) and
the forward (``flash_fwd_kernel``), and counts as one launch:
``flash_attention.launches`` counts wrapper calls that launched them.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import check_prefix, flash_attention_gqa, softmax_scale

__all__ = ["flash_attention", "D_MAX"]

D_MAX = 128  # the kernel's largest head size
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library():
    lib = _build.load("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_scratch_bytes.argtypes = [i, i, i, i, i]
        lib.flash_attention_scratch_bytes.restype = ll
        lib.flash_attention_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ll, ll, ll, ll, ll, ll, ll, ll, ll,
                                               ctypes.c_float, i, ll, i, i, p]
        lib.flash_attention_launch.restype = i
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None, prefix: int = 0, return_lse: bool = False):
    """Attention over contiguous positions from 0 in the model layout: q
    [B, Sq, H, D], k, v [B, Skv, Kh, D] (query head h reads KV head h // (H
    / Kh)), f32 or bf16, each read in place (last axis contiguous) ->
    contiguous [B, Sq, H, D] in q's dtype. A causal row i admits the keys j
    <= max(i, prefix - 1). ``return_lse``: (o, each row's log-sum-exp, f32
    [B, H, Sq]), the backward's residual; o is the same bits either way."""
    check_prefix(prefix, window)
    if q.device.type == "cpu":
        return flash_attention_gqa(q, k, v, causal=causal, window=window, prefix=prefix, return_lse=return_lse)
    ts = (q, k, v)
    if any(t.device != q.device for t in ts) or q.device.type != "cuda":
        raise ValueError(f"flash_attention: needs every tensor on one card, got {[str(t.device) for t in ts]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: needs q, k, v all f32 or all bf16, got {[t.dtype for t in ts]}")
    if any(t.dim() != 4 for t in ts):
        raise ValueError(f"flash_attention: q must be [B, Sq, H, D] and k, v [B, Skv, Kh, D], got "
                         f"{[tuple(t.shape) for t in ts]}")
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if k.shape != (b, skv, kh, d) or v.shape != k.shape or kh < 1 or h % kh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree "
                         "(KV heads must divide the query heads)")
    if not 1 <= d <= D_MAX or b * h > 65535:
        raise ValueError(f"flash_attention: needs 1 <= D <= {D_MAX} and B * H <= 65535; got D {d}, B * H {b * h}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be None or >= 1, got {window}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in ts)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_lse else None
    if o.numel() == 0:
        return (o, lse) if return_lse else o
    if skv == 0:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    lib, dtype = _library(), _DTYPES[q.dtype]
    # the pre-pass's K pieces and bf16 V (see flash_attention.cu)
    scratch = torch.empty(lib.flash_attention_scratch_bytes(b, skv, kh, d, dtype), dtype=torch.uint8,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                         None if lse is None else lse.data_ptr(), scratch.data_ptr(),
                                         b, sq, skv, h, kh, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                         softmax_scale(d), int(causal), -1 if window is None else int(window),
                                         int(prefix), dtype, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0


def library_smem_bytes(d: int, dtype: torch.dtype) -> int:
    """The library's dynamic shared memory of the forward kernel at head size
    D, which ``cost.py`` mirrors."""
    fn = _build.load("flash_attention").flash_attention_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    return int(fn(d, _DTYPES[dtype]))


def library_scratch_bytes(b: int, skv: int, kh: int, d: int, dtype: torch.dtype) -> int:
    """The library's K/V scratch bytes of a call, which
    ``cost.scratch_bytes`` mirrors."""
    return int(_library().flash_attention_scratch_bytes(b, skv, kh, d, _DTYPES[dtype]))
