"""Tensor parallelism's local shapes on the card: the flash-attention
kernel at the heads a rank holds, and a rank's share of a dense cell run
for real under a fake process group.

Marked ``cuda``: these skip without an NVIDIA GPU. This file imports
neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_tp.py

Tolerances: flash_attention against its chunked plain version on the
same inputs within rtol 3e-2, atol 2e-2 on bf16 (the kernel's bound in
``tests/test_torch_cuda.py``). Under a fake group every collective leaves
its output as it was, so the rank-local cell checks shapes and launches,
never values.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import dispatch as kd  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_gqa  # noqa: E402
from repro_torch.launch.mesh import fake_group, make_host_mesh  # noqa: E402
from repro_torch.launch.specs import build_cell, piece_shape  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.optim.train_state import init_state  # noqa: E402

BF16_TOL = (2e-2, 3e-2)  # atol, rtol


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(2, 4096), (1, 8192)])
def test_flash_attention_at_a_ranks_heads_matches_the_plain_version(dev, b, s):
    """h2o_danube3_4b on a "model" axis of 16: 2 query heads over the one
    KV head of 120 they read, window 4096."""
    g = torch.Generator(device=dev).manual_seed(s)
    q = (torch.randn((b, s, 2, 120), device=dev, generator=g) * 2.0).bfloat16()
    k, v = (torch.randn((b, s, 1, 120), device=dev, generator=g).bfloat16() for _ in range(2))
    launches = flash_attention.launches
    o = flash_attention(q, k, v, causal=True, window=4096)
    assert flash_attention.launches == launches + 1
    want = flash_attention_gqa(q, k, v, causal=True, window=4096)
    atol, rtol = BF16_TOL
    assert int(((o.float() - want.float()).abs() > atol + rtol * want.float().abs()).sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_a_ranks_share_of_a_dense_cell_runs_on_the_kernels_under_a_fake_group(dev, shape):
    """The reduced h2o_danube3_4b's cell on a fake (2, 2) ("data", "model")
    group, rank 0, on the card: every flash_attention call on the kernel
    with the rank's 2 of 4 query heads, the outputs' shapes its pieces'."""
    cfg = get_config("h2o_danube3_4b").reduced()
    g = torch.Generator(device=dev).manual_seed(0)
    kd.STATS.reset()
    with fake_group(4):
        mesh = make_host_mesh((2, 2), ("data", "model"), "cpu")
        cell = build_cell("h2o_danube3_4b", shape, mesh, cfg=cfg)
        psh, pmeta = ((cell.in_shardings[0].params, cell.args[0].params) if cell.kind == "train"
                      else (cell.in_shardings[0], cell.args[0]))
        params = tree_map(lambda sh, x: torch.randn(piece_shape(sh, x.shape), generator=g, device=dev) * 0.02,
                          psh, pmeta, is_leaf=lambda v: isinstance(v, shd.NamedSharding))
        bshape = piece_shape(cell.in_shardings[1]["tokens"], cell.args[1]["tokens"].shape)
        batch = {k: torch.randint(0, cfg.vocab, bshape, generator=g, device=dev) for k in ("tokens", "labels")}
        first = init_state(params, adam(), cell.policy) if cell.kind == "train" else params
        out = cell.fn(first, batch)
        torch.cuda.synchronize()
    n = cfg.n_layers * (2 if cell.kind == "train" else 1)
    assert kd.STATS.snapshot() == {("flash_attention", "cuda"): n}
    if cell.kind == "train":
        assert tuple(out[0].params["embed"]["table"].shape) == (256, 64)  # vocab over "model", embed over "data"
    else:
        assert tuple(out.shape) == (bshape[0], bshape[1], cfg.vocab_padded() // 2)
