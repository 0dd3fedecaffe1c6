"""The port's step analysis (``repro_torch.launch.step_analysis``), the
counterpart of ``tests/test_hlo_analysis.py``'s five cases: a matmul's
FLOPs, a loop's multiple, an elementwise chain's buffers, an all-reduce's
wire bytes over a group of 8, nested loops; and a dispatched kernel site
counted by its cost model, not by its plain version's operations.

Every count is exact (the trace runs on fake tensors: shapes alone).
"""
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import dispatch as kd  # noqa: E402
from repro_torch.kernels.flash_attention import cost as fa_cost  # noqa: E402
from repro_torch.launch.mesh import fake_group, make_host_mesh  # noqa: E402
from repro_torch.launch.step_analysis import analyze  # noqa: E402


def _args(*shapes):
    return lambda: tuple(torch.empty(s) for s in shapes)


def test_matmul_counts_2mkn():
    m, k, n = 64, 128, 32
    cost, out = analyze(lambda a, b: a @ b, make_args=_args((m, k), (k, n)))
    assert out.shape == (m, n)
    assert cost.dot_flops == cost.flops == 2.0 * m * k * n
    assert cost.bytes_accessed == 4 * (m * k + k * n + m * n)
    assert cost.collective_bytes == 0 and cost.collective_count == 0


def test_a_loop_of_eight_matmuls_counts_8x():
    k = 64

    def loop(w, x):
        for i in range(8):
            x = x @ w[i]
        return x

    cost, _ = analyze(loop, make_args=_args((8, k, k), (4, k)))
    assert cost.dot_flops == 8 * 2.0 * 4 * k * k


def test_an_elementwise_chain_counts_its_real_buffers():
    """Eager: each of the 30 operations reads its input and writes its
    output once (no fusion)."""
    n = 1 << 16

    def chain(x):
        for _ in range(10):
            x = torch.tanh(x) * 1.5 + 0.1
        return x

    cost, _ = analyze(chain, make_args=_args((n,)))
    assert cost.bytes_accessed == 30 * 2 * n * 4
    assert cost.flops == 30 * n and cost.dot_flops == 0
    assert cost.bytes_by_op == {"elementwise": 30 * 2 * n * 4, "collective": 0.0}


def test_an_all_reduce_over_eight_ranks_counts_2_n_minus_1_over_n_of_its_bytes():
    with fake_group(8):
        mesh = make_host_mesh((8,), ("data",), "cpu")
        cost, _ = analyze(lambda x: shd.all_reduce(x, ("data",), mesh), make_args=_args((8, 128)))
    nbytes = 8 * 128 * 4
    assert cost.collective_count == 1
    assert cost.collective_bytes == 2.0 * 7 / 8 * nbytes
    assert cost.collective_breakdown == {"all_reduce": 2.0 * 7 / 8 * nbytes}
    assert cost.collective_by_axis == {"data": 2.0 * 7 / 8 * nbytes}
    assert cost.collective_raw == nbytes


def test_nested_loops_multiply():
    k = 32

    def nested(w, x):
        for i in range(4):
            for j in range(8):
                x = x @ w[i, j]
        return x

    cost, _ = analyze(nested, make_args=_args((4, 8, k, k), (2, k)))
    assert cost.dot_flops == 32 * 2.0 * 2 * k * k


def test_a_kernel_site_counts_its_cost_model_not_its_plain_version():
    b, s, h, kh, d = 2, 256, 4, 2, 32
    cost, out = analyze(lambda q, k, v: kd.flash_attention(q, k, v, causal=True, window=64),
                        make_args=_args((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    want = fa_cost.flash_attention_cost(b, s, s, h, kh, d, backend="ref", causal=True, window=64, elem_bytes=4)
    assert out.shape == (b, s, h, d)
    assert cost.kernel_sites == {"flash_attention/ref": 1}
    assert cost.flops == want.flops and cost.bytes_accessed == want.hbm_read_bytes + want.hbm_write_bytes
    assert cost.n_ops == 0  # none of the chunked plain version's operations


def test_a_tensor_held_only_by_an_unreachable_cycle_is_not_live():
    """Each product is dropped inside a reference cycle: the peak of live
    bytes is one product, not the four that wait for Python's collector."""
    n = 1 << 16

    def cycles(x):
        for _ in range(4):
            holder = [x * 2.0]
            holder.append(holder)
            del holder
        return x + 1.0

    cost, _ = analyze(cycles, make_args=_args((n,)))
    assert cost.peak_bytes == 4 * n



def _hoist_then_tanh(codes, x):
    kd.hoist_packed(kd.PackedTensor(codes, 0))  # resolves a backend, runs no site
    return torch.tanh(x)


def _failed_site_then_tanh(codes, x):
    with pytest.raises(RuntimeError, match="the backend failed"):
        kd.matmul(x, codes, 0)
    return torch.tanh(x)


@pytest.mark.parametrize("fn", [_hoist_then_tanh, _failed_site_then_tanh], ids=["hoist", "raising-site"])
def test_operations_after_a_resolution_outside_a_site_are_counted(fn, monkeypatch):
    """A weight hoist resolves a backend without a kernel site, and a
    site's backend can raise: neither leaves the trace inside a site, so
    the operation after it is counted."""

    def fail(*args, **kwargs):
        raise RuntimeError("the backend failed")

    monkeypatch.setattr(kd, "split_matmul", fail)
    cost, _ = analyze(fn, make_args=lambda: (torch.empty((8, 16), dtype=torch.uint8), torch.empty((4, 8))))
    assert cost.detail.get("tanh.default") == 2 * 4 * 8 * 4
    assert cost.kernel_sites == {}
