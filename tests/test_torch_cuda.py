"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: the kernels have no CPU mode, so these skip without an
NVIDIA GPU. This file imports neither JAX nor the JAX package, so it runs
on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: floatsd_matmul |y - y_plain| <= 1e-5 * (|x| @ |W|)
elementwise (f32 sums in another order); lstm_cell bit for bit (the kernel
rounds exactly where the plain version rounds).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import floatsd  # noqa: E402
from repro_torch.kernels import dispatch as kd  # noqa: E402
from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul  # noqa: E402
from repro_torch.kernels.floatsd_matmul.ref import floatsd_matmul_ref  # noqa: E402
from repro_torch.kernels.lstm_cell.ops import lstm_cell  # noqa: E402
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref  # noqa: E402

MATMUL_SHAPES = [(3, 100, 130), (8, 128, 256), (1, 64, 33), (24, 256, 512), (8, 1024, 4096)]
CELL_SHAPES = [(5, 200), (8, 1024), (1, 33)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
@pytest.mark.parametrize("transposed", [False, True])
def test_floatsd_matmul_kernel_matches_plain(dev, m, k, n, transposed):
    g = _gen(dev, m + k + n)
    x = torch.randn((m, k), device=dev, generator=g)
    w = torch.randn((n, k) if transposed else (k, n), device=dev, generator=g) * 0.05
    codes, bias = floatsd.encode(w)
    n0 = floatsd_matmul.launches
    got = floatsd_matmul(x, codes, int(bias), transposed=transposed)
    want = floatsd_matmul_ref(x, codes, int(bias), transposed=transposed)
    wd = floatsd.decode(codes, bias).double().abs()
    bound = 1e-5 * (x.double().abs() @ (wd.t() if transposed else wd))
    torch.cuda.synchronize()
    assert floatsd_matmul.launches == n0 + 1
    assert bool(((got.double() - want.double()).abs() <= bound + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h", CELL_SHAPES)
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("c_dtype", [torch.float16, torch.float32])
def test_lstm_cell_kernel_matches_plain_bitwise(dev, b, h, quantized, c_dtype):
    g = _gen(dev, b * h)
    z = torch.randn((b, 4 * h), device=dev, generator=g) * 2
    c = torch.randn((b, h), device=dev, generator=g).to(c_dtype)
    n0 = lstm_cell.launches
    h_k, c_k = lstm_cell(z, c, quantized=quantized, c_dtype=c_dtype)
    h_r, c_r = lstm_cell_ref(z, c, quantized, c_dtype=c_dtype)
    torch.cuda.synchronize()
    assert lstm_cell.launches == n0 + 1
    assert torch.equal(h_k, h_r) and torch.equal(c_k, c_r)


@pytest.mark.cuda
def test_dispatch_routes_cuda_tensors_to_the_kernels(dev):
    kd.STATS.reset()
    x = torch.randn((4, 64), device=dev)
    codes, bias = floatsd.encode(torch.randn((64, 32), device=dev))
    kd.matmul(x, codes, int(bias))
    kd.lstm_cell(torch.randn((4, 128), device=dev), torch.zeros((4, 32), device=dev, dtype=torch.float16))
    kd.matmul(x, codes, int(bias), backend="ref")
    torch.cuda.synchronize()
    assert kd.STATS.count("floatsd_matmul", "cuda") == 1 and kd.STATS.count("lstm_cell", "cuda") == 1
    assert kd.STATS.count("floatsd_matmul", "ref") == 1
