"""The port's dry run (``repro_torch.launch``: ``specs``, ``dryrun``,
``reanalyze``, ``fix_useful``) against the reference's.

  * ``ARCH_IDS``, ``SHAPES``, ``shape_spec`` and ``ArchConfig.skips``
    equal the reference's for every arch ID and shape;
  * ``count_active_params`` on the port's meta-device parameters equals
    the reference's on ``jax.eval_shape``'s, for all eleven archs at full
    size;
  * ``batch_specs``'s shapes, dtypes and logical trees and ``opt_specs``'s
    logical trees equal the reference's, leaf for leaf;
  * ``run_cell`` on reduced configs over a fake (2, 2) ("data", "model")
    group: a dense cell of each kind is ``ok`` with the reference's record
    keys and non-zero FLOPs, bytes and collective bytes; a skipped cell
    carries the reference's reason; a cell of a family without ported
    tensor parallelism records ``error`` naming its family;
  * ``reanalyze`` rebuilds a record's derived fields from its saved trace,
    and ``fix_useful`` its parameter counts and useful ratio, equal to the
    record's own.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.launch import dryrun, fix_useful, reanalyze, specs  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.nn.module import SHAPES_ONLY  # noqa: E402


def _jax_count_active_params():
    """The reference's ``count_active_params``; importing its module sets
    ``XLA_FLAGS`` for 512 host devices, which is put back at once (JAX in
    this process may not have started its backend yet)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import count_active_params
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return count_active_params


#: the keys of the reference's ``ok`` record (``repro/launch/dryrun.py``)
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "policy", "status", "lower_s", "compile_s", "kind", "n_devices", "memory",
    "xla_cost_analysis", "hlo_flops", "hlo_dot_flops", "hlo_bytes", "collective_wire_bytes",
    "collective_raw_bytes", "collective_breakdown", "collective_count", "unknown_while", "params_total",
    "params_active", "model_flops_per_device", "useful_flops_ratio", "roofline", "roofline_flash", "bytes_by_op",
    "top_bytes_instrs",
}
REDUCED = get_config("h2o_danube3_4b").reduced()


def test_arch_ids_shapes_and_skips_equal_the_reference():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS and tbase.SHAPES == jbase.SHAPES
    for arch in jbase.ARCH_IDS:
        jc, tc = jbase.get_config(arch), get_config(arch)
        assert tc.supports_long == jc.supports_long, arch
        for shape in jbase.SHAPES:
            assert tbase.shape_spec(shape) == jbase.shape_spec(shape)
            assert tc.skips(shape) == jc.skips(shape), (arch, shape)


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_count_active_params_equals_the_reference(arch):
    jcfg = jbase.get_config(arch)
    jshape = jax.eval_shape(lambda k: jbuild(jcfg).init(k), jax.random.PRNGKey(0))
    want = _jax_count_active_params()(jcfg, jshape)
    params = build(get_config(arch)).init(SHAPES_ONLY)
    assert dryrun.count_active_params(get_config(arch), params) == want


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: type(x) is tuple)


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "whisper_large_v3", "qwen2_vl_2b", "kimi_k2_1t_a32b"])
def test_batch_and_opt_specs_equal_the_reference(arch):
    jcfg, tcfg = jbase.get_config(arch), get_config(arch)
    for shape in jbase.SHAPES:
        jb, js = jspecs.batch_specs(jcfg, shape, jget_policy("floatsd8_tpu"))
        tb, ts = specs.batch_specs(tcfg, shape, get_policy("floatsd8_tpu"))
        assert ts == js
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tb.items()} == {
            k: (tuple(v.shape), jnp.dtype(v.dtype).name) for k, v in jb.items()}
    jp, tp = jbuild(jcfg).specs(), build(tcfg).specs()
    for name in ("adam", "adafactor", "sgd"):
        jo, to = jspecs.opt_specs(name, jp), specs.opt_specs(name, tp)
        assert type(to).__name__ == type(jo).__name__
        assert _leaves(to) == _leaves(jo)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The reduced h2o_danube3_4b's three kinds of cell on a fake (2, 2)
    mesh, the train cell's trace saved."""
    trace_dir = str(tmp_path_factory.mktemp("trace"))
    old = dryrun.TRACE_DIR
    dryrun.TRACE_DIR = trace_dir
    try:
        out = {shape: dryrun.run_cell("h2o_danube3_4b", shape, mesh_shape=(2, 2), cfg=REDUCED, verbose=False,
                                      save_trace=shape == "train_4k")
               for shape in ("train_4k", "prefill_32k", "decode_32k")}
    finally:
        dryrun.TRACE_DIR = old
    return out, trace_dir


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_run_cell_on_a_fake_2x2_mesh_gives_the_reference_record(cells, shape):
    rec = cells[0][shape]
    assert rec["status"] == "ok", rec.get("traceback")
    assert REFERENCE_KEYS <= set(rec)
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0 and rec["collective_wire_bytes"] > 0
    assert rec["n_devices"] == 4 and rec["mesh"] == "2x2" and rec["kind"] == tbase.SHAPES[shape][2]
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes"}
    assert set(rec["collective_by_axis"]) == {"data", "model"}
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert (rec["remat"], rec["attn_chunk"]) == ("full", 1024)  # what the port runs
    sites = rec["kernel_sites"]
    assert sites == ({} if shape == "decode_32k" else {"flash_attention/ref": 2 * REDUCED.n_layers
                                                        if shape == "train_4k" else REDUCED.n_layers})


def test_skipped_and_untp_cells_record_their_reasons():
    skip = dryrun.run_cell("stablelm_3b", "long_500k", verbose=False)
    assert skip["status"] == "skipped" and skip["reason"] == jbase.get_config("stablelm_3b").skips("long_500k")
    rec = dryrun.run_cell("rwkv6_3b", "train_4k", mesh_shape=(2, 2), cfg=get_config("rwkv6_3b").reduced(),
                          verbose=False)
    assert rec["status"] == "error" and "NotImplementedError" in rec["error"] and "ssm family" in rec["error"]


@pytest.mark.parametrize("flag", [["--remat", "dots"], ["--remat", "none"], ["--attn-chunk", "512"]])
def test_cli_refuses_a_remat_or_chunk_the_port_does_not_run(flag, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "h2o_danube3_4b", "--shape", "train_4k", "--out", str(tmp_path), *flag])
    assert e.value.code == 2 and "invalid choice" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_reanalyze_and_fix_useful_round_trip_a_record(cells, monkeypatch):
    rec, trace_dir = cells[0]["train_4k"], cells[1]
    broken = {**rec, "roofline": None, "hlo_flops": 0.0, "useful_flops_ratio": None, "bytes_by_op": {}}
    assert reanalyze.reanalyze_record(broken, trace_dir)
    assert broken == rec
    monkeypatch.setattr(fix_useful, "get_config", lambda arch: REDUCED)
    broken = {**rec, "params_active": 0, "model_flops_per_device": 0.0, "useful_flops_ratio": None}
    assert fix_useful.fix_record(broken)
    assert broken == rec
    assert not reanalyze.reanalyze_record(dict(rec, status="error"), trace_dir)
