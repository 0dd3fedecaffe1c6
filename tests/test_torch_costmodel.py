"""The port's kernel cost ledger (``obs/costmodel.py``, ``kernels/*/cost.py``,
the dispatch layer's ``COST_SPECS``, ``STATS`` and ``LEDGER``) against the
JAX package's, on the CPU.

Checked:
  * every op the dispatch records has a CostSpec with notes, and every
    recorded Decision carries a Cost;
  * on the ref backend, the predicted read + write bytes of each call equal
    the bytes (``nbytes``) of the tensors handed to the plain version plus
    its outputs, tolerance 0, for the ten ops, the hoisted (``dense=``) paths,
    ``packed_einsum`` and the training path's dense product;
  * each ref Cost equals the JAX cost function's, field by field (the
    port's ``smem_bytes`` against the reference's ``vmem_bytes``, both 0 on
    ref), at the same dimensions and the byte widths of the port's operands.
    Where the port's operands differ, the test states the difference:
      - the FloatSD8 bias is a host int in the port (0 bytes of device
        memory), a 4-byte device scalar in the reference;
      - ``dispatch.matmul`` casts x to f32 before either backend, so its
        x bytes are 4 whatever x's dtype;
      - ``rwkv_wkv`` also returns the final state [B, H, K, V] f32, and
        may take u [H, K] shared by the batch;
      - ``flash_attention`` reads K and V at their KV heads (grouped query
        attention), where the reference's [BH, S, D] layout has one per
        query head;
  * ``merge_costs``, ``rows``, ``table``, ``to_json`` and ``emit_counters``
    give the reference's output on the same stats, with ``smem_bytes`` in
    place of ``vmem_bytes``;
  * the cuda models on hand-worked cases: route A with and without the
    split-K partials, route B's pre-pass pieces, the dw tiles, and the
    mirrors of the kernels' scratch and shared-memory sizes;
  * the MACs equal ``benchmarks/table7_mac.py``'s per time step.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

from repro.kernels import dispatch as jkd  # noqa: E402
from repro.kernels.flash_attention import cost as j_fa  # noqa: E402
from repro.kernels.floatsd4_matmul import cost as j_fm4  # noqa: E402
from repro.kernels.floatsd_matmul import cost as j_fm  # noqa: E402
from repro.kernels.floatsd_quantize import cost as j_fq  # noqa: E402
from repro.kernels.lstm_cell import cost as j_lc  # noqa: E402
from repro.kernels.qsigmoid import cost as j_qs  # noqa: E402
from repro.kernels.rwkv_wkv import cost as j_rw  # noqa: E402
from repro.obs import costmodel as j_costmodel  # noqa: E402
from repro.obs.trace import Tracer as JTracer  # noqa: E402
from repro_torch.core import floatsd  # noqa: E402
from repro_torch.kernels import dispatch as kd  # noqa: E402
from repro_torch.kernels.flash_attention import cost as fa  # noqa: E402
from repro_torch.kernels.floatsd4_matmul import cost as fm4  # noqa: E402
from repro_torch.kernels.floatsd_matmul import cost as fm  # noqa: E402
from repro_torch.kernels.floatsd_quantize import cost as fq  # noqa: E402
from repro_torch.kernels.lstm_cell import cost as lc  # noqa: E402
from repro_torch.kernels.qsigmoid import cost as qs  # noqa: E402
from repro_torch.kernels.rwkv_wkv import cost as rw  # noqa: E402
from repro_torch.obs import costmodel  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OPS = ("floatsd_matmul", "floatsd_matmul_dx", "floatsd_matmul_dw", "lstm_cell", "lstm_cell_grad",
       "floatsd4_matmul", "floatsd_quantize", "qsigmoid", "rwkv_wkv", "flash_attention")
FIELDS = ("flops", "macs", "hbm_read_bytes", "hbm_write_bytes", "pad_waste_flops", "pad_waste_bytes")


def _table7():
    spec = importlib.util.spec_from_file_location("table7_mac", ROOT / "benchmarks" / "table7_mac.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def t(shape, scale=1.0, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)


def packed(k, n, seed=0):
    codes, bias = floatsd.encode(t((k, n), 0.05, seed))
    return kd.PackedTensor(codes, int(bias))


def as_fields(c, vmem: bool = False) -> dict:
    d = {f: getattr(c, f) for f in FIELDS}
    d["smem_bytes"] = c.vmem_bytes if vmem else c.smem_bytes
    return d


# ---------------------------------------------------------------------------
# one call of each op (and path) on the plain versions
# ---------------------------------------------------------------------------

def _mm():
    p = packed(37, 19)
    kd.matmul(t((5, 37), 0.5), p.codes, p.bias)


def _mm_bf16():  # x is cast to f32 before the plain version: 4 bytes an element
    p = packed(37, 19)
    kd.matmul(t((2, 3, 37), 0.5, dtype=torch.bfloat16), p.codes, p.bias)


def _mm_transposed():
    p = packed(19, 37)
    kd.matmul(t((5, 37), 0.5), p.codes, p.bias, transposed=True)


def _mm_dense():  # the hoisted decode: the plain version reads f32 weights, no codes
    kd.packed_einsum("...d,df->...f", t((5, 37), 0.5), kd.hoist_packed(packed(37, 19)))


def _einsum_head():  # the tied head: w stored [V, D], contracted on its second axis
    kd.packed_einsum("...d,vd->...v", t((2, 3, 37), 0.5), packed(41, 37))


def _mm4():
    kd.matmul4(t((5, 37), 0.5), kd.pack4(t((37, 19), 0.05)))


def _mm4_transposed():
    kd.packed_einsum("...d,vd->...v", t((5, 37), 0.5), kd.pack4(t((41, 37), 0.05)))


def _mm4_plane():  # layer 2 of a stacked [3, 37, 19] leaf: its code-byte and exponent planes
    kd.matmul4(t((5, 37), 0.5), kd.layer_view4(kd.pack4(t((3, 37, 19), 0.05)), 2))


def _mm4_plane_experts():  # a stacked MoE layer's planes [E, K, N], one call an expert
    kd.packed_einsum("gecd,edh->gech", t((1, 2, 3, 37), 0.5), kd.layer_view4(kd.pack4(t((3, 2, 37, 19), 0.05)), 1))


def _mm4_dense():
    kd.packed_einsum("...d,df->...f", t((5, 37), 0.5), kd.hoist_packed(kd.pack4(t((37, 19), 0.05))))


def _dx():
    p = packed(37, 19)
    kd.matmul_dx(t((5, 19), 0.5), p.codes, p.bias)


def _dx_dense():
    p = kd.hoist_train(t((37, 19), 0.05))
    kd.matmul_dx(t((5, 19), 0.5), p.codes, p.bias, dense=p.dense)


def _dw():
    kd.matmul_dw(t((5, 37), 0.5), t((5, 19), 0.5, 1))


def _dw_raw():
    kd.matmul_dw(t((2, 3, 37), 0.5), t((2, 3, 19), 0.5, 1), quant=False)


def _cell():
    kd.lstm_cell(t((3, 280), 1.5), t((3, 70), 0.8, 1, torch.float16))


def _cell_f32():
    kd.lstm_cell(t((3, 280), 1.5), t((3, 70), 0.8, 1), c_dtype=torch.float32)


def _cell_grad():  # the plain version reads the fp16 cell state as its f32 copy
    kd.lstm_cell_grad(t((3, 280), 1.5), t((3, 70), 0.8, 1, torch.float16), t((3, 70), 0.1, 2),
                      t((3, 70), 0.1, 3))


def _quantize():
    kd.quantize(t((37, 19), 0.05))


def _quantize_fp16():
    kd.quantize(t((1001,), 0.05, dtype=torch.float16))


def _qsig():
    kd.qsigmoid(t((7, 33), 4.0))


def _qsig_bf16():
    kd.qsigmoid(t((7, 33), 4.0, dtype=torch.bfloat16))


def _wkv():
    b, s, h, k = 2, 21, 3, 8
    w = torch.exp(-torch.exp(t((b, s, h, k), 0.3, 4) - 2))
    kd.rwkv_wkv(t((b, s, h, k)), t((b, s, h, k), seed=1), t((b, s, h, 6), seed=2), w, t((h, k), 0.1, 3))


def _wkv_batched_u():
    b, s, h, k = 2, 21, 3, 8
    w = torch.exp(-torch.exp(t((b, s, h, k), 0.3, 4) - 2))
    kd.rwkv_wkv(t((b, s, h, k)), t((b, s, h, k), seed=1), t((b, s, h, 6), seed=2), w, t((b, h, k), 0.1, 3))


def _flash():
    kd.flash_attention(t((2, 23, 4, 8)), t((2, 23, 2, 8), seed=1), t((2, 23, 2, 8), seed=2), window=9)


def _flash_bf16():
    kd.flash_attention(*(t(s, seed=i, dtype=torch.bfloat16) for i, s in
                         enumerate([(1, 17, 2, 8), (1, 17, 1, 8), (1, 17, 1, 8)])), causal=False)


def _train_dense():  # the training path's dense product and its dx (reason train:hoisted-dense)
    x = t((4, 37), 0.5).requires_grad_()
    wq = t((37, 19), 0.05).requires_grad_()
    kd.train_matmul(x, wq, wq).sum().backward()


CASES = {
    "floatsd_matmul": (_mm, ["floatsd_matmul"]),
    "floatsd_matmul-bf16-x": (_mm_bf16, ["floatsd_matmul"]),
    "floatsd_matmul-transposed": (_mm_transposed, ["floatsd_matmul"]),
    "floatsd_matmul-dense": (_mm_dense, ["floatsd_matmul"]),
    "packed_einsum-head": (_einsum_head, ["floatsd_matmul"]),
    "floatsd4_matmul": (_mm4, ["floatsd4_matmul"]),
    "floatsd4_matmul-transposed": (_mm4_transposed, ["floatsd4_matmul"]),
    "floatsd4_matmul-dense": (_mm4_dense, ["floatsd4_matmul"]),
    "floatsd4_matmul-plane": (_mm4_plane, ["floatsd4_matmul"]),
    "floatsd4_matmul-plane-experts": (_mm4_plane_experts, ["floatsd4_matmul"]),
    "floatsd_matmul_dx": (_dx, ["floatsd_matmul_dx"]),
    "floatsd_matmul_dx-dense": (_dx_dense, ["floatsd_matmul_dx"]),
    "floatsd_matmul_dw": (_dw, ["floatsd_matmul_dw"]),
    "floatsd_matmul_dw-raw": (_dw_raw, ["floatsd_matmul_dw"]),
    "lstm_cell": (_cell, ["lstm_cell"]),
    "lstm_cell-f32-state": (_cell_f32, ["lstm_cell"]),
    "lstm_cell_grad": (_cell_grad, ["lstm_cell_grad"]),
    "floatsd_quantize": (_quantize, ["floatsd_quantize"]),
    "floatsd_quantize-fp16": (_quantize_fp16, ["floatsd_quantize"]),
    "qsigmoid": (_qsig, ["qsigmoid"]),
    "qsigmoid-bf16": (_qsig_bf16, ["qsigmoid"]),
    "rwkv_wkv": (_wkv, ["rwkv_wkv"]),
    "rwkv_wkv-batched-u": (_wkv_batched_u, ["rwkv_wkv"]),
    "flash_attention": (_flash, ["flash_attention"]),
    "flash_attention-bf16": (_flash_bf16, ["flash_attention"]),
    "train_matmul-dense": (_train_dense, ["floatsd_matmul", "floatsd_matmul_dx", "floatsd_matmul_dw"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ref_predicted_bytes_equal_touched_bytes_exactly(case):
    run, ops = CASES[case]
    kd.STATS.reset()
    run()
    rows = {r["op"]: r for r in kd.LEDGER.rows()}
    assert sorted(rows) == sorted(ops)
    for op, r in rows.items():
        assert r["backend"] == "ref" and r["calls"] >= 1
        assert r["touched_bytes"] > 0
        assert r["hbm_bytes"] == r["touched_bytes"], (op, r["hbm_bytes"], r["touched_bytes"])
        assert r["bytes_rel_err"] == 0.0
        assert r["smem_bytes"] == 0 and r["pad_waste_bytes"] == 0


def test_every_recorded_op_has_a_cost_spec_and_every_decision_a_cost():
    kd.STATS.reset()
    for run, _ in CASES.values():
        run()
    recorded = {op for op, _ in kd.STATS.snapshot()}
    assert recorded == set(OPS) == set(kd.COST_SPECS)
    for op in OPS:
        spec = kd.COST_SPECS[op]
        assert spec.op == op and callable(spec.fn) and len(spec.notes) > 20
        assert isinstance(kd.STATS.last[op].cost, costmodel.Cost)
    # a Decision compares on what was decided, the cost aside
    d = kd.STATS.last["qsigmoid"]
    assert d == kd.Decision("qsigmoid", "ref", "cpu tensor") and d.cost.flops > 0


# ---------------------------------------------------------------------------
# the ref models against the JAX cost functions
# ---------------------------------------------------------------------------

MM_SHAPES = [(1, 1, 1), (5, 37, 19), (8, 1024, 4096), (64, 1024, 33280), (3072, 1024, 4096)]


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
def test_matmul_ref_costs_equal_the_reference(m, k, n):
    # forward: the reference charges its 4-byte device bias, the port's bias is a host int
    j = j_fm.matmul_fwd_cost(m, k, n, backend="ref", x_bytes=4)
    p = fm.matmul_fwd_cost(m, k, n, backend="ref")
    assert as_fields(p) == {**as_fields(j, vmem=True), "hbm_read_bytes": j.hbm_read_bytes - 4}
    assert as_fields(p) == as_fields(j_fm.matmul_like_cost(m, k, n, backend="ref", bias_bytes=0), vmem=True)
    # the hoisted decode: f32 weights, no codes, no decode work
    assert as_fields(fm.matmul_fwd_cost(m, k, n, backend="ref", dense=True)) == as_fields(
        j_fm.matmul_like_cost(m, k, n, backend="ref", b_bytes=4, bias_bytes=0, decode=False), vmem=True)
    # dx (contraction over n), likewise less the bias
    j = j_fm.matmul_dx_cost(m, n, k, backend="ref")
    assert as_fields(fm.matmul_dx_cost(m, n, k, backend="ref")) == {
        **as_fields(j, vmem=True), "hbm_read_bytes": j.hbm_read_bytes - 4}
    # dw: both packages charge no bias; with and without the FP8 snap
    for quant in (True, False):
        assert as_fields(fm.matmul_dw_cost(k, m, n, backend="ref", quant=quant)) == as_fields(
            j_fm.matmul_dw_cost(k, m, n, backend="ref", quant=quant), vmem=True)
    # FloatSD4 at the stored bytes of both layouts
    for wt in (None, 17 * n + 3 * n):
        assert as_fields(fm4.matmul4_fwd_cost(m, k, n, backend="ref", wt_nbytes=wt)) == as_fields(
            j_fm4.matmul4_fwd_cost(m, k, n, backend="ref", wt_nbytes=wt), vmem=True)


@pytest.mark.parametrize("b,h", [(1, 1), (3, 70), (8, 1024), (64, 1023)])
@pytest.mark.parametrize("widths", [(4, 2, 4, 2), (4, 4, 4, 4), (2, 2, 4, 2)])
def test_cell_ref_costs_equal_the_reference(b, h, widths):
    z, cin, hout, cout = widths
    assert as_fields(lc.lstm_cell_cost(b, h, backend="ref", z_bytes=z, c_in_bytes=cin, h_out_bytes=hout,
                                       c_out_bytes=cout)) == as_fields(
        j_lc.lstm_cell_cost(b, h, backend="ref", z_bytes=z, c_in_bytes=cin, h_out_bytes=hout, c_out_bytes=cout),
        vmem=True)
    assert as_fields(lc.lstm_cell_grad_cost(b, h, backend="ref", z_bytes=z, c_in_bytes=cin)) == as_fields(
        j_lc.lstm_cell_grad_cost(b, h, backend="ref", z_bytes=z, c_in_bytes=cin), vmem=True)


@pytest.mark.parametrize("n", [1, 1001, 4 * 2**20])
@pytest.mark.parametrize("elem", [4, 2])
def test_elementwise_ref_costs_equal_the_reference(n, elem):
    assert as_fields(fq.quantize_cost(n, backend="ref", x_bytes=elem)) == as_fields(
        j_fq.quantize_cost(n, backend="ref", x_bytes=elem), vmem=True)
    assert as_fields(qs.qsigmoid_cost(n, backend="ref", x_bytes=elem, y_bytes=elem)) == as_fields(
        j_qs.qsigmoid_cost(n, backend="ref", x_bytes=elem, y_bytes=elem), vmem=True)


@pytest.mark.parametrize("b,s,h,k,v", [(1, 1, 1, 1, 1), (2, 21, 3, 8, 6), (2, 1024, 40, 64, 64)])
def test_wkv_ref_cost_equals_the_reference_plus_the_final_state(b, s, h, k, v):
    j = j_rw.wkv_cost(b * h, s, k, v, backend="ref", elem_bytes=4)
    state = b * h * k * v * 4  # the port also returns the final state
    want = {**as_fields(j, vmem=True), "hbm_write_bytes": j.hbm_write_bytes + state}
    assert as_fields(rw.wkv_cost(b, s, h, k, v, backend="ref", u_batched=True)) == want
    # u [H, K] shared by the batch: B - 1 fewer copies of it read
    shared = rw.wkv_cost(b, s, h, k, v, backend="ref", u_batched=False)
    assert as_fields(shared) == {**want, "hbm_read_bytes": j.hbm_read_bytes - (b - 1) * h * k * 4}


@pytest.mark.parametrize("b,s,h,kh,d,causal,window,elem", [
    (1, 1, 1, 1, 1, True, None, 4), (2, 23, 4, 2, 8, True, 9, 4), (1, 17, 2, 1, 8, False, None, 2),
    (2, 1024, 32, 8, 120, True, 4096, 4), (1, 300, 4, 4, 64, True, 100, 2)])
def test_flash_ref_cost_equals_the_reference_at_the_kv_heads(b, s, h, kh, d, causal, window, elem):
    j = j_fa.flash_attention_cost(b * h, s, s, d, backend="ref", causal=causal, window=window, elem_bytes=elem)
    p = fa.flash_attention_cost(b, s, s, h, kh, d, backend="ref", causal=causal, window=window, elem_bytes=elem)
    # K and V read at their Kh heads, not once per query head
    gqa = 2 * b * (h - kh) * s * d * elem
    assert as_fields(p) == {**as_fields(j, vmem=True), "hbm_read_bytes": j.hbm_read_bytes - gqa}


@pytest.mark.parametrize("d,h,batch", [(256, 256, 1), (200, 650, 16), (28, 128, 4), (1024, 1024, 8)])
def test_macs_reproduce_table7_per_timestep(d, h, batch):
    per = _table7().per_timestep_macs(d, h, batch=batch)
    gemm = (fm.matmul_fwd_cost(batch, d, 4 * h, backend="ref").macs
            + fm.matmul_fwd_cost(batch, h, 4 * h, backend="ref").macs)
    assert gemm == per["gemm"]
    assert lc.lstm_cell_cost(batch, h, backend="ref").macs == per["elementwise"]
    # the kernels issue the same MACs (nothing is padded in the contraction)
    assert fm.matmul_fwd_cost(batch, d, 4 * h, backend="cuda").macs == batch * d * 4 * h
    assert lc.lstm_cell_cost(batch, h, backend="cuda").macs == per["elementwise"]


# ---------------------------------------------------------------------------
# the ledger against the reference's on the same stats
# ---------------------------------------------------------------------------

COSTS = [  # (op, backend, Cost fields, touched bytes, timed seconds)
    ("floatsd_matmul", "ref", dict(flops=122880, macs=49152, hbm_read_bytes=8192, hbm_write_bytes=3072), 11264, 0.0),
    ("floatsd_matmul", "ref", dict(flops=10, macs=5, hbm_read_bytes=100, hbm_write_bytes=50), 150, 0.0),
    ("floatsd_matmul", "cuda", dict(flops=83886080, macs=33554432, hbm_read_bytes=6291456, hbm_write_bytes=1179648,
                                    smem_bytes=36864, pad_waste_flops=12), 4325376, 2.5e-5),
    ("lstm_cell", "cuda", dict(flops=1064960, macs=24576, hbm_read_bytes=147456, hbm_write_bytes=49152,
                               smem_bytes=1156), 196608, 1.2e-5),
    ("qsigmoid", "ref", dict(flops=43, hbm_read_bytes=4, hbm_write_bytes=4), 9, 0.0),
]


def _fill(stats, decision, cost_cls, smem_field):
    for op, backend, fields, touched, secs in COSTS:
        f = dict(fields)
        if "smem_bytes" in f:
            f[smem_field] = f.pop("smem_bytes")
        stats.record(decision(op, backend, cost_cls(**f)))
        stats.add_touched(op, backend, touched)
        if secs:
            stats.add_time(op, backend, secs, calls=2)


def _ledgers():
    pst = kd.DispatchStats()
    _fill(pst, lambda op, be, c: kd.Decision(op, be, "test", c), costmodel.Cost, "smem_bytes")
    jst = jkd.DispatchStats()
    _fill(jst, lambda op, be, c: jkd.Decision(op, be, False, False, "test", c), j_costmodel.Cost, "vmem_bytes")
    return costmodel.CostLedger(pst), j_costmodel.CostLedger(jst)


def _vmem(r: dict) -> dict:
    r = dict(r)
    r["vmem_bytes"] = r.pop("smem_bytes")
    return r


def test_ledger_rows_table_and_json_equal_the_reference():
    port, ref = _ledgers()
    assert [_vmem(r) for r in port.rows()] == ref.rows()
    assert port.table().replace("SMEM KB", "VMEM KB") == ref.table()
    pj = json.loads(json.dumps(port.to_json(meta={"who": "test"})))
    jj = json.loads(json.dumps(ref.to_json(meta={"who": "test"})))
    assert {**pj, "rows": [_vmem(r) for r in pj["rows"]]} == jj
    empty = costmodel.CostLedger(kd.DispatchStats())
    assert empty.table() == j_costmodel.CostLedger(jkd.DispatchStats()).table()


def test_ledger_emit_counters_equal_the_reference():
    port, ref = _ledgers()
    tr, jtr = Tracer(), JTracer()
    assert port.emit_counters(tr) == 0 == ref.emit_counters(jtr)  # disabled tracers
    tr.enable()
    jtr.enable()
    assert port.emit_counters(tr) == ref.emit_counters(jtr) == 3
    strip = lambda evs: [(e["name"], e["cat"], e["ph"], e["args"]) for e in evs]  # noqa: E731
    assert strip(tr.events()) == strip(jtr.events())


def test_merge_costs_equal_the_reference():
    a = dict(flops=10, macs=5, hbm_read_bytes=100, hbm_write_bytes=50)
    b = dict(flops=1, macs=1, hbm_read_bytes=1, hbm_write_bytes=1, pad_waste_bytes=7, pad_waste_flops=3)
    m = costmodel.Cost(**a, smem_bytes=1000) + costmodel.Cost(**b, smem_bytes=2000)
    jm = j_costmodel.merge_costs(j_costmodel.Cost(**a, vmem_bytes=1000), j_costmodel.Cost(**b, vmem_bytes=2000))
    assert as_fields(m) == as_fields(jm, vmem=True) and m.smem_bytes == 2000  # a peak, not a sum
    d, jd = m.to_dict(), jm.to_dict()
    jd["smem_bytes"] = jd.pop("vmem_bytes")
    assert d == jd
    assert costmodel.merge_costs(costmodel.ZERO_COST, m) == m


# ---------------------------------------------------------------------------
# the cuda models on hand-worked cases
# ---------------------------------------------------------------------------


def test_route_a_with_the_split_k_partials():
    # [8, 1024] @ [1024, 4096]: plan gives route A, 8 chunks of 128 k; the
    # partials (8 x 8 x 4096 f32) stay within 2 x K bytes a row: used
    p = fm.plan(8, 4096, 1024)
    assert (p.route, p.splits, p.chunk) == ("A", 8, 128)
    c = fm.matmul_fwd_cost(8, 1024, 4096, backend="cuda")
    x_reads = 32 * 8 * 1024 * 4  # once per 128-column block
    codes = 1024 * 4096  # one row block (MT 8)
    partials = 8 * 8 * 4096 * 4
    assert c.hbm_read_bytes == x_reads + codes + partials == 6_291_456
    assert c.hbm_write_bytes == partials + 8 * 4096 * 4 == 1_179_648
    assert c.macs == 8 * 1024 * 4096 and c.flops == 2 * c.macs + 4 * codes
    assert c.smem_bytes == 1024 + (64 * 128 + 64 * 12) * 4 == 36_864
    assert c.pad_waste_flops == 0 and c.pad_waste_bytes == 0
    # a ragged M: the row tile of 8 computes 5 rows past the matrix, the last column block 106 columns
    r = fm.matmul_fwd_cost(3, 100, 150, backend="cuda")
    assert fm.plan(3, 150, 100).splits == 1
    assert r.hbm_read_bytes == 2 * 3 * 100 * 4 + 100 * 150 and r.hbm_write_bytes == 3 * 150 * 4
    assert r.pad_waste_flops == 2 * 100 * (8 * 256 - 3 * 150)


def test_route_a_without_the_partials():
    # the fused BPTT's recompute, [3072, 1024] @ [1024, 4096] on the ordered
    # route: 8 chunks, but partials of 8 x 3072 rows would outgrow the codes,
    # so each block adds its own chunks
    p = fm.plan(3072, 4096, 1024, ordered=True)
    assert (p.route, p.splits) == ("A", 8) and not fm.use_partials(p, 3072, 1024)
    c = fm.matmul_fwd_cost(3072, 1024, 4096, backend="cuda", ordered=True)
    assert c.hbm_read_bytes == 32 * 3072 * 1024 * 4 + 48 * 1024 * 4096  # 48 row blocks of 64
    assert c.hbm_write_bytes == 3072 * 4096 * 4
    assert c.smem_bytes == 1024 + (64 * 128 + 64 * 68) * 4
    # matmul_dx on the codes [1024, 4096] read as [out, contraction]: the forward's model at (c, n) = (n, k)
    assert fm.matmul_dx_cost(64, 4096, 1024, backend="cuda") == fm.routed_cost(64, 4096, 1024)


def test_route_b_pieces_flags_and_partials():
    # [128, 1024] @ [1024, 4096]: route B, 2 chunks of 512 k (32 tiles leave SMs idle)
    p = fm.plan(128, 4096, 1024)
    assert (p.route, p.splits, p.chunk) == ("B", 2, 512)
    c = fm.matmul_fwd_cost(128, 1024, 4096, backend="cuda")
    pieces = 3 * 128 * 1024 * 2  # [3, M, ceil8(K)] bf16
    flags = 1 * 16 * 4  # [ceil(M/128), ceil(K/64)] int32
    partials = 2 * 128 * 4096 * 4
    assert c.hbm_read_bytes == 128 * 1024 * 4 + 32 * (pieces + flags) + 1024 * 4096 + partials == 34_080_768
    assert c.hbm_write_bytes == pieces + flags + partials + 128 * 4096 * 4 == 7_077_952
    assert c.smem_bytes == 512 + fm.B_SMEM == 227_840 <= 232_448  # the H100's per-block limit
    # a ragged K pads the pieces' rows to 8
    r = fm.routed_cost(100, 1001, 300)
    assert fm.plan(100, 300, 1001).route == "B"
    assert r.hbm_write_bytes - 100 * 300 * 4 == 3 * 100 * 1008 * 2 + 16 * 4


def test_floatsd4_and_dw_tiles():
    c = fm4.matmul4_fwd_cost(8, 1024, 4096, backend="cuda")
    w = 512 * 4096 + 32 * 4096  # nibble codes + group exponents
    assert c.hbm_read_bytes == 32 * 8 * 1024 * 4 + w + 8 * 8 * 4096 * 4
    assert c.smem_bytes == 64 + (64 * 128 + 64 * 12) * 4
    assert c.flops == 2 * 8 * 1024 * 4096 + 5 * 1024 * 4096
    # a stacked leaf's layer: its code-byte and exponent planes, K x N bytes each
    p = fm4.matmul4_fwd_cost(8, 1024, 4096, backend="cuda", plane=True)
    assert p.hbm_read_bytes == 32 * 8 * 1024 * 4 + 2 * 1024 * 4096 + 8 * 8 * 4096 * 4
    assert p.smem_bytes == c.smem_bytes and p.flops == c.flops
    r = fm4.matmul4_fwd_cost(8, 1024, 4096, backend="ref", plane=True)
    assert r.hbm_read_bytes == 8 * 1024 * 4 + 2 * 1024 * 4096 and r.hbm_write_bytes == 8 * 4096 * 4
    # route A at M 128 too (FloatSD4 has no route B)
    assert fm4.matmul4_fwd_cost(128, 1024, 4096, backend="cuda").smem_bytes == 64 + (64 * 128 + 64 * 68) * 4
    d = fm.matmul_dw_cost(1024, 3072, 4096, backend="cuda")
    assert d.hbm_read_bytes == 32 * 3072 * 1024 * 4 + 8 * 3072 * 4096 * 4
    assert d.hbm_write_bytes == 1024 * 4096 * 4 and d.smem_bytes == 49_152 and d.pad_waste_flops == 0
    assert fm.matmul_dw_cost(200, 3072, 1200, backend="cuda").pad_waste_flops == 2 * 3072 * (256 * 1280 - 200 * 1200)


def test_elementwise_cuda_models_are_one_pass_with_their_tables():
    for quant in (True, False):
        c = lc.lstm_cell_cost(64, 1024, backend="cuda", quantized=quant)
        r = lc.lstm_cell_cost(64, 1024, backend="ref", quantized=quant)
        assert as_fields(c) == {**as_fields(r), "smem_bytes": 4 * 289 if quant else 0}
    assert fq.quantize_cost(100, backend="cuda").smem_bytes == 4 * 209 == 836
    assert qs.qsigmoid_cost(100, backend="cuda").smem_bytes == 1156


def test_scratch_and_shared_memory_mirrors():
    # rwkv_wkv.cu: 4 B H ceil(S/16) (2 16 KT + 16 16 + KT) bytes, KT = K padded to 64 or 128
    assert rw.scratch_bytes(2, 40, 1024, 64) == 4 * 2 * 40 * 64 * (2 * 16 * 64 + 256 + 64) == 48_496_640
    assert rw.scratch_bytes(1, 1, 17, 65) == 4 * 2 * (2 * 16 * 128 + 256 + 128)
    assert rw.prep_smem(64) == 4 * (6 * 16 * 68 + 128) and rw.walk_smem(64) == 16 * (2368 + 256)
    c = rw.wkv_cost(2, 1024, 40, 64, 64, backend="cuda")
    scratch = rw.scratch_bytes(2, 40, 1024, 64)
    assert c.hbm_write_bytes == scratch + 2 * 1024 * 40 * 64 * 4 + 2 * 40 * 64 * 64 * 4
    assert c.hbm_read_bytes == (3 * 2 * 1024 * 40 * 64 * 4 + 64 * 80 * 64 * 4 + 4 * scratch
                                + 2 * 1024 * 40 * 64 * 4)  # u once per pre-pass block; records once per V slice
    assert c.smem_bytes == max(rw.prep_smem(64), rw.walk_smem(64)) and c.pad_waste_flops == 0
    # flash_attention.cu: 2 B Kh (P + 1) ceil8(Skv) DP bytes, P = 3 on f32, 1 on bf16
    assert fa.scratch_bytes(2, 1024, 8, 120, 4) == 2 * 2 * 8 * 4 * 1024 * 128 == 16_777_216
    assert fa.scratch_bytes(1, 17, 1, 8, 2) == 2 * 2 * 24 * 64
    assert fa.fwd_smem(120, 4) == 2 * (3 * 128 + 2 * 4 * 64) * 128 == 229_376
    assert fa.fwd_smem(64, 2) == 2 * (128 + 2 * 2 * 64) * 64


def test_flash_visited_tiles_follow_the_kernel():
    # causal at S 256: query block 0 (rows 0-127) loads keys 0-127, block 1 all 256;
    # each warpgroup of 64 rows computes the 64-key tiles up to its last row
    pairs, keys = fa.visited_pairs(256, 256, True, None)
    assert keys == 128 + 256
    assert pairs == 64 * 64 * (1 + 2 + 3 + 4)
    c = fa.flash_attention_cost(1, 256, 256, 2, 1, 64, backend="cuda")
    admitted = fa.attend_pairs(256, 256, True, None)
    assert c.macs == 2 * 2 * pairs * 64
    assert c.pad_waste_flops == 2 * (4 * 64 + 6) * (pairs - admitted)
    assert c.hbm_read_bytes == 2 * 256 * 64 * 4 + 2 * 256 * 64 * 4 + 2 * keys * 4 * 64 * 2
    # no mask: every tile of every block (the last tile's keys up to ceil8(201))
    assert fa.visited_pairs(201, 201, False, None) == (2 * 2 * 64 * 64 * 4, 2 * 208)
    # a window starts a block's tiles at the 64-key tile of the first key its
    # first row admits: blocks 2 and 3 skip one and two tiles
    _, keys = fa.visited_pairs(512, 512, True, 100)
    assert keys == 128 + 256 + (384 - 128) + (512 - 256)
