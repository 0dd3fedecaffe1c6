"""Wrapper of the chunked RWKV-6 wkv kernel (``rwkv_wkv.cu``).

Takes the plain version for tensors on the CPU and launches the CUDA kernel
for tensors on the card; there is no fallback between the two. A call on
the card is two device kernels, the chunk pre-pass (``wkv_chunk_prep``) and
the state walk (``rwkv_wkv_kernel``), and counts as one launch:
``rwkv_wkv.launches`` counts wrapper calls that launched them.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import CHUNK, wkv_ref

__all__ = ["rwkv_wkv", "CHUNK", "K_MAX"]

K_MAX = 128  # the kernel's largest head size K


def _library():
    lib = _build.load("rwkv_wkv")
    if lib.rwkv_wkv_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rwkv_wkv_scratch_bytes.argtypes = [i, i, i, i]
        lib.rwkv_wkv_scratch_bytes.restype = ll
        lib.rwkv_wkv_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, ll, p]
        lib.rwkv_wkv_launch.restype = i
    return lib


def rwkv_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The wkv recurrence from a zero state: r, k, w [B, S, H, K], v [B, S,
    H, V], u [H, K] or [B, H, K] -> (y [B, S, H, V], s_fin [B, H, K, V]),
    f32 in and out."""
    if r.device.type == "cpu":
        return wkv_ref(r, k, v, w, u)
    ts = (r, k, v, w, u)
    if any(t.device != r.device for t in ts) or r.device.type != "cuda":
        raise ValueError(f"rwkv_wkv: needs every tensor on one card, got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"rwkv_wkv: needs f32 tensors, got {[t.dtype for t in ts]}")
    if r.dim() != 4:
        raise ValueError(f"rwkv_wkv: r must be [B, S, H, K], got {tuple(r.shape)}")
    b, s, h, kk = r.shape
    vv = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape or v.shape != (b, s, h, vv):
        raise ValueError(f"rwkv_wkv: r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"w {tuple(w.shape)} disagree")
    if u.shape not in ((h, kk), (b, h, kk)):
        raise ValueError(f"rwkv_wkv: u {tuple(u.shape)} is neither [H, K] nor [B, H, K]")
    if not 1 <= kk <= K_MAX or vv < 1 or b * h > 65535:
        raise ValueError(f"rwkv_wkv: needs 1 <= K <= {K_MAX}, V >= 1, B * H <= 65535; got K {kk}, "
                         f"V {vv}, B * H {b * h}")
    r, k, v, w = (t.contiguous() for t in (r, k, v, w))
    u3 = u.expand(b, h, kk) if u.dim() == 2 else u
    if u3.stride(2) != 1 or u3.stride(1) != kk:
        u3 = u3.contiguous()
    y = torch.empty((b, s, h, vv), dtype=torch.float32, device=r.device)
    s_fin = torch.zeros((b, h, kk, vv), dtype=torch.float32, device=r.device)
    if b * h == 0 or s == 0:
        return y, s_fin
    lib = _library()
    # each chunk's decays and tile, formed once by the pre-pass (see rwkv_wkv.cu)
    scratch = torch.empty(lib.rwkv_wkv_scratch_bytes(b, h, s, kk), dtype=torch.uint8, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rwkv_wkv_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u3.data_ptr(),
                                  y.data_ptr(), s_fin.data_ptr(), scratch.data_ptr(), b, h, s, kk, vv, u3.stride(0),
                                  stream)
    if err != 0:
        raise RuntimeError(f"rwkv_wkv launch failed: cudaError {err}")
    rwkv_wkv.launches += 1
    return y, s_fin


rwkv_wkv.launches = 0


def library_smem_bytes(k: int, walk: bool) -> int:
    """The library's dynamic shared memory of the pre-pass, or of the walk,
    at head size K, which ``cost.py`` mirrors."""
    fn = _build.load("rwkv_wkv").rwkv_wkv_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    return int(fn(k, int(walk)))


def library_scratch_bytes(b: int, h: int, s: int, k: int) -> int:
    """The library's record bytes of a call, which ``cost.scratch_bytes`` mirrors."""
    return int(_library().rwkv_wkv_scratch_bytes(b, h, s, k))
