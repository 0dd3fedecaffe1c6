"""Wrappers of the FloatSD8 matmul kernels: ``floatsd_matmul`` and its
``matmul_dx`` use (``floatsd_matmul.cu``, the latter on the codes read in
place as [out, contraction]), and ``matmul_dw`` (``floatsd_matmul_dw.cu``).

``plan(M, N, K, ordered)`` (defined beside the plain versions, which sum in
its order) picks ``floatsd_matmul.cu``'s route and its split of K from the
shapes and the caller's ``ordered`` request; the wrapper passes both to the
kernel as launch arguments, so the CUDA source holds no copy of the rule.

Each takes its plain version for tensors on the CPU and launches its CUDA
kernel for tensors on the card; there is no fallback between the two. Each
counts its own launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ...core.floatsd import EXP_LEVELS
from .ref import Plan, floatsd_matmul_ref, matmul_dw_ref, matmul_dx_ref, plan

__all__ = ["floatsd_matmul", "matmul_dx", "matmul_dw", "clamp_bias", "plan", "Plan", "use_partials"]

ROUTES = {"A": 0, "B": 1}  # the kernel's route argument


def use_partials(p: Plan, m: int, k: int) -> bool:
    """Whether a split K's chunk sums go through partials [splits, M, N] f32,
    which the kernel's second pass adds in order: always on route B; on
    route A while they stay within 2 x K x N bytes (twice FloatSD8's codes),
    beyond which a block adds its own chunks, in the same order."""
    return p.splits > 1 and (p.route == "B" or p.splits * m * 4 <= 2 * k)


def clamp_bias(bias) -> int:
    """The per-tensor bias as a host int, clamped as ``floatsd.decode``
    clamps it (every exponent e + bias, e in [0, 7], stays normal)."""
    return max(-126, min(127 - (EXP_LEVELS - 1), int(bias)))


def _launcher():
    fn = _build.load("floatsd_matmul").floatsd_matmul_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = i
    return fn


def _dw_launcher():
    fn = _build.load("floatsd_matmul_dw").matmul_dw_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p]
        fn.restype = i
    return fn


def floatsd_matmul(x: torch.Tensor, codes: torch.Tensor, bias, *, transposed: bool = False,
                   ordered: bool = False) -> torch.Tensor:
    """x [M, K] f32 @ decode(codes) -> y [M, N] f32, with codes uint8 [K, N]
    or, when ``transposed``, [N, K] (read in place). ``ordered`` takes route
    A at any M: the plain version's bits on exact products."""
    if x.device.type == "cpu":
        return floatsd_matmul_ref(x, codes, bias, transposed=transposed, ordered=ordered)
    return _launch(x, codes, bias, transposed, ordered, floatsd_matmul)


def matmul_dx(g: torch.Tensor, codes: torch.Tensor, bias, *, ordered: bool = False) -> torch.Tensor:
    """g [M, N] f32 @ decode(codes [K, N])^T -> [M, K] f32: the forward
    kernel on the codes read in place as [out = K, contraction = N]."""
    if g.device.type == "cpu":
        return matmul_dx_ref(g, codes, bias, ordered=ordered)
    return _launch(g, codes, bias, True, ordered, matmul_dx)


def _launch(x: torch.Tensor, codes: torch.Tensor, bias, transposed: bool, ordered: bool,
            owner) -> torch.Tensor:
    """Launch floatsd_matmul.cu; counts the launch on ``owner``."""
    if x.device.type != "cuda" or codes.device != x.device:
        raise ValueError(f"floatsd_matmul: x on {x.device}, codes on {codes.device}")
    if x.dtype != torch.float32 or codes.dtype != torch.uint8:
        raise ValueError(f"floatsd_matmul: needs f32 x and uint8 codes, got {x.dtype}, {codes.dtype}")
    if x.dim() != 2 or codes.dim() != 2 or not (x.is_contiguous() and codes.is_contiguous()):
        raise ValueError("floatsd_matmul: needs contiguous 2-D x and codes")
    m, k = x.shape
    n, k2 = codes.shape if transposed else codes.shape[::-1]
    if k != k2:
        raise ValueError(f"floatsd_matmul: x {tuple(x.shape)} vs codes {tuple(codes.shape)}")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    p = plan(m, n, k, ordered)
    part = torch.empty((p.splits, m, n), dtype=torch.float32, device=x.device) if use_partials(p, m, k) else None
    # route B's pre-pass: x's three bf16 pieces (rows padded to 8) and the
    # nonzero pieces of each 128 x 64 tile
    pieces = flags = None
    if p.route == "B":
        pieces = torch.empty((3, m, -(-k // 8) * 8), dtype=torch.bfloat16, device=x.device)
        flags = torch.empty((-(-m // 128), -(-k // 64)), dtype=torch.int32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(
            x.data_ptr(), codes.data_ptr(), clamp_bias(bias), y.data_ptr(), ptr(part), ptr(pieces),
            ptr(flags), m, n, k, int(transposed), ROUTES[p.route], p.splits, p.chunk, stream,
        )
    if err != 0:
        raise RuntimeError(f"floatsd_matmul launch failed: cudaError {err}")
    owner.launches += 1
    return y


def matmul_dw(x: torch.Tensor, g: torch.Tensor, *, quant: bool = True) -> torch.Tensor:
    """x [M, K] f32 ^T @ g [M, N] f32 -> dw [K, N] f32, snapped to the FP8
    e5m2 grid at the flush unless ``quant=False``."""
    if x.device.type == "cpu":
        return matmul_dw_ref(x, g, quant)
    if x.device.type != "cuda" or g.device != x.device:
        raise ValueError(f"matmul_dw: x on {x.device}, g on {g.device}")
    if x.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"matmul_dw: needs f32 x and g, got {x.dtype}, {g.dtype}")
    if x.dim() != 2 or g.dim() != 2 or not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("matmul_dw: needs contiguous 2-D x and g")
    (m, k), (m2, n) = x.shape, g.shape
    if m != m2:
        raise ValueError(f"matmul_dw: x {tuple(x.shape)} vs g {tuple(g.shape)}")
    dw = torch.empty((k, n), dtype=torch.float32, device=x.device)
    if k == 0 or n == 0:
        return dw
    if m == 0:
        return dw.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _dw_launcher()(x.data_ptr(), g.data_ptr(), dw.data_ptr(), m, k, n, int(quant), stream)
    if err != 0:
        raise RuntimeError(f"matmul_dw launch failed: cudaError {err}")
    matmul_dw.launches += 1
    return dw


floatsd_matmul.launches = 0
matmul_dx.launches = 0
matmul_dw.launches = 0


def _query(lib: str, name: str, n_args: int):
    fn = getattr(_build.load(lib), name)
    fn.argtypes, fn.restype = [ctypes.c_int] * n_args, ctypes.c_longlong
    return fn


def library_smem_bytes(m: int, route: str) -> int:
    """The library's dynamic shared memory of the main kernel at M rows on
    ``route`` ("A" or "B"), which ``cost.py`` mirrors."""
    return int(_query("floatsd_matmul", "floatsd_matmul_smem_bytes", 2)(m, ROUTES[route]))


def library_dw_smem_bytes() -> int:
    """The dw library's dynamic shared memory, which ``cost.py`` mirrors."""
    return int(_query("floatsd_matmul_dw", "matmul_dw_smem_bytes", 0)())
