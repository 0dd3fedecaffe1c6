"""The port's sharding rules, logical-axis trees and FP8 gradient mean
against the JAX package, in one process on the CPU.

  * every model's ``specs()`` and ``cache_specs()`` tree equals the
    reference's, leaf for leaf (tuples of logical names; a NamedTuple
    compared by its class name and fields), for the full and the reduced
    config of each zoo config (Whisper included) and the paper's four LSTM
    models at both widths;
  * ``logical_to_spec`` equals the reference's ``PartitionSpec`` on
    device-less meshes of (1, 1), (2, 2), (4, 1) ("data", "model") and
    (2, 2, 4) ("pod", "data", "model") for every leaf of every reduced
    config at its shape, every activation name at several batch sizes, and
    the divisibility drops;
  * ``fp8_psum`` over a world of one rank (gloo on an in-memory store, one
    group for the module) equals the saturating e5m2 round trip of x at
    the exact power-of-two scale, bit for bit; its scale is 2^floor(log2
    q) exactly at and one ulp beside every power of two q, where the
    reference's formula is counted where it is not (XLA's f32 log2 and
    exp2 on the CPU); the 4-rank cases are in ``test_torch_mesh_train.py``;
  * the rest (``use_mesh``, ``constrain``, the MoE's groups, the loss
    share, a sharding's pieces, ``to_global``, the elastic restore's
    pieces, the state's shardings) by their definitions.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import lstm_models as jlstm  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import to_global  # noqa: E402
from repro_torch.distributed import checkpointing  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import HW, make_host_mesh  # noqa: E402
from repro_torch.models import build, lstm_models  # noqa: E402
from repro_torch.models.lm import cross_entropy  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.optim.grad_compress import _po2_scale, fp8_psum, pod_compressed_mean  # noqa: E402
from repro_torch.optim.train_state import init_state, state_shardings  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from sharding_cases import exact_psum, flat_payloads, jax_psum, psum_payloads  # noqa: E402

ZOO = ["dbrx_132b", "granite_20b", "h2o_danube3_4b", "jamba_v01_52b", "kimi_k2_1t_a32b", "lstm_wikitext2",
       "phi4_mini_3p8b", "qwen2_vl_2b", "rwkv6_3b", "stablelm_3b", "whisper_large_v3"]
LSTM = [("UDPOSTagger", {}), ("SNLIClassifier", {}), ("Multi30KSeq2Seq", {}), ("WikiText2LM", {}),
        ("UDPOSTagger", dict(vocab=2000, emb=64, hidden=96)),
        ("SNLIClassifier", dict(vocab=4000, emb=96, proj=64, hidden=96)),
        ("Multi30KSeq2Seq", dict(src_vocab=2000, tgt_vocab=2000, emb=96, hidden=128)),
        ("WikiText2LM", dict(vocab=4000, emb=192, hidden=192, n_layers=2))]
MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")), ((4, 1), ("data", "model")),
          ((2, 2, 4), ("pod", "data", "model"))]


def _norm(tree):
    """A spec tree as plain data: dicts, NamedTuples as (name, fields), tuple leaves."""
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return (type(tree).__name__, tuple(_norm(getattr(tree, f)) for f in tree._fields))
    assert type(tree) is tuple, tree
    return tuple(tree)


def _configs(arch, full):
    c, jc = get_config(arch), jget_config(arch)
    return (c, jc) if full else (c.reduced(), jc.reduced())


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ZOO)
def test_zoo_specs_equal_the_reference(arch, full):
    c, jc = _configs(arch, full)
    model, jmodel = build(c), jbuild(jc)
    assert _norm(model.specs()) == _norm(jmodel.specs())
    if hasattr(jmodel, "cache_specs"):
        assert _norm(model.cache_specs()) == _norm(jmodel.cache_specs())


@pytest.mark.parametrize("name,kw", LSTM, ids=[f"{n}-{'reduced' if kw else 'full'}" for n, kw in LSTM])
def test_lstm_model_specs_equal_the_reference(name, kw):
    assert _norm(getattr(lstm_models, name)(**kw).specs()) == _norm(getattr(jlstm, name)(**kw).specs())


def _leaves(specs, shapes, prefix=""):
    if isinstance(specs, dict):
        for k in specs:
            yield from _leaves(specs[k], shapes[k], f"{prefix}/{k}")
    else:
        yield prefix, specs, tuple(shapes.shape)


@pytest.fixture(scope="module")
def reduced_leaves():
    out = []
    for arch in ZOO:
        model = build(get_config(arch).reduced())
        out += [(arch + k, s, shape) for k, s, shape in
                _leaves(model.specs(), model.init(torch.Generator().manual_seed(0)))]
    return out


ACTS = [("batch", "seq", "act_embed"), ("batch", "seq", "vocab"), ("batch", None, None),
        ("batch", "expert", None, None), ("batch", "seq", "act_kv_heads", None), ("batch", "act_mlp", None),
        ("batch", "act_heads", None, None), ("layers", "batch", "seq", "act_kv_heads", None),
        ("batch", "seq_shard", "expert_cap")]


@pytest.mark.parametrize("shape,axes", MESHES, ids=["x".join(map(str, s)) for s, _ in MESHES])
def test_logical_to_spec_matches_the_reference(reduced_leaves, shape, axes):
    mesh, jmesh = shd.MeshShape(shape, axes), jax.sharding.AbstractMesh(shape, axes)
    for key, logical, dims in reduced_leaves:
        assert shd.logical_to_spec(logical, dims, mesh) == tuple(jshd.logical_to_spec(logical, dims, jmesh)), key
        assert shd.logical_to_spec(logical, None, mesh) == tuple(jshd.logical_to_spec(logical, None, jmesh)), key
    for logical in ACTS:
        for b in (1, 2, 3, 8, 16):
            dims = (b,) + (4,) * (len(logical) - 1)
            assert shd.logical_to_spec(logical, dims, mesh) == tuple(jshd.logical_to_spec(logical, dims, jmesh))


def test_logical_to_spec_drops_what_the_mesh_cannot_take():
    mesh = shd.MeshShape((2, 2, 4), ("pod", "data", "model"))
    assert shd.logical_to_spec(("batch", "seq"), (8, 3), mesh) == (("pod", "data"), None)
    assert shd.logical_to_spec(("batch", "seq"), (6, 3), mesh) == (None, None)  # 6 % 4
    assert shd.logical_to_spec(("embed", "kv_heads"), (64, 1), mesh) == ("data", None)  # granite's kv_heads=1
    two = shd.MeshShape((2, 2), ("data", "model"))
    assert shd.logical_to_spec(("batch",), (8,), two) == ("data",)  # no pod on one pod
    assert shd.logical_to_spec(("embed", "vocab"), (5, 8), two) == (None, "model")
    # no mesh: the rules' axes, nothing dropped, as the reference's
    assert shd.logical_to_spec(("embed", "batch"), (5, 3)) == ("data", ("pod", "data"))
    assert tuple(jshd.logical_to_spec(("embed", "batch"), (5, 3))) == ("data", ("pod", "data"))


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = shd.MeshShape((2, 2, 4), ("pod", "data", "model"))
    assert shd.logical_to_placements(("batch", "seq", "vocab"), (8, 3, 16), mesh) == [Shard(0), Shard(0), Shard(2)]
    assert shd.logical_to_placements(("embed", None), (6, 2), mesh) == [Replicate(), Shard(0), Replicate()]
    with pytest.raises(ValueError):
        shd.logical_to_placements(("heads", "mlp"), (8, 8), mesh)  # two dims on one axis


def test_use_mesh_nests_and_is_per_thread():
    a, b = shd.MeshShape((2, 1), ("data", "model")), shd.MeshShape((4, 1), ("data", "model"))
    assert shd.active_mesh() is None
    with shd.use_mesh(a, rules={"embed": None}):
        assert shd.active_mesh() is a and shd.logical_to_spec(("embed",), (8,)) == (None,)
        with shd.use_mesh(b):  # inherits the override
            assert shd.active_mesh() is b and shd.logical_to_spec(("embed",), (8,)) == (None,)
        with shd.use_mesh(b, rules={"mlp": "data"}):  # explicit rules start from the defaults
            assert shd.logical_to_spec(("embed", "mlp"), (8, 8)) == ("data", "data")
        seen = []
        t = threading.Thread(target=lambda: seen.append(shd.active_mesh()))
        t.start()
        t.join()
        assert seen == [None] and shd.active_mesh() is a
    assert shd.active_mesh() is None and shd.logical_to_spec(("embed",), (8,), a) == ("data",)


def test_constrain_checks_and_passes_through():
    x = torch.ones(4, 3, 2)
    assert shd.constrain(x, ("batch", "seq", "act_heads")) is x  # no mesh
    with shd.use_mesh(shd.MeshShape((4, 1), ("data", "model"))):
        assert shd.constrain(x, ("batch", "seq", "act_heads")) is x
        with pytest.raises(ValueError):
            shd.constrain(x, ("batch", "seq"))
    with shd.use_mesh(shd.MeshShape((2, 2), ("data", "model"))):
        assert shd.constrain(x, ("batch", "seq", "act_embed")) is x
        with pytest.raises(NotImplementedError):
            shd.constrain(x, ("batch", "seq", "act_heads"))


def test_moe_groups_and_loss_shares_under_a_mesh():
    moe = build(get_config("dbrx_132b").reduced())._moe()
    assert moe._groups(96) == 16 and moe._groups(24) == 8
    assert dataclasses.replace(moe, dispatch_groups=2)._groups(96) == 2
    logits = torch.randn(4, 6, 10, generator=torch.Generator().manual_seed(0))
    labels = torch.randint(0, 10, (4, 6), generator=torch.Generator().manual_seed(1))
    whole = cross_entropy(logits, labels)
    for n in (1, 2, 4):
        with shd.use_mesh(shd.MeshShape((n, 1), ("data", "model"))):
            assert moe._groups(96 // n) == 1 and shd.batch_ranks() == n
            assert torch.equal(cross_entropy(logits, labels), whole / n)
    with shd.use_mesh(shd.MeshShape((2, 2, 1), ("pod", "data", "model"))):
        assert shd.batch_axes() == ("pod", "data") and shd.batch_ranks() == 4 and moe._groups(24) == 1


@dataclasses.dataclass
class _Coord:
    """A mesh's shape and this rank's coordinates, with no process group:
    what ``NamedSharding.shard`` and ``to_global`` read."""

    shape: tuple
    mesh_dim_names: tuple
    coords: dict

    def get_local_rank(self, name):
        return self.coords[name]


def _meshes(shape, axes):
    for idx in np.ndindex(*shape):
        yield _Coord(shape, axes, dict(zip(axes, idx)))


def test_pieces_tile_the_tensor_rank_major():
    full = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    shape, axes = (2, 2, 2), ("pod", "data", "model")
    spec = (("pod", "data"), None, "model")
    pieces = {tuple(m.coords.values()): shd.NamedSharding(m, spec).shard(full) for m in _meshes(shape, axes)}
    for (p, d, mo), piece in pieces.items():
        assert torch.equal(piece, full[(2 * p + d) * 2:(2 * p + d + 1) * 2, :, mo * 2:(mo + 1) * 2])
    rep = shd.NamedSharding(_Coord(shape, axes, {"pod": 1, "data": 0, "model": 1}), (None, None, None))
    assert rep.shard(full) is full


def test_to_global_keeps_this_ranks_rows():
    batch = {"tokens": np.arange(8 * 3).reshape(8, 3), "labels": np.arange(8)}
    rows = [to_global(batch, m)["labels"] for m in _meshes((2, 2, 1), ("pod", "data", "model"))]
    assert [r.tolist() for r in rows] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert to_global(batch, None) is batch
    with pytest.raises(ValueError):
        to_global({"x": np.zeros((6, 2))}, _Coord((4, 1), ("data", "model"), {"data": 0, "model": 0}))


def test_state_shardings_follow_the_parameters():
    model = lstm_models.WikiText2LM(vocab=256, emb=16, hidden=16, n_layers=2)
    state = init_state(model.init(torch.Generator().manual_seed(0)), adam(), get_policy("floatsd8_table6"))
    sh = state_shardings(model.specs(), state, shd.MeshShape((4, 1), ("data", "model")))
    assert sh.params["embed"]["table"].spec == ("model", "data") and sh.params["lstm1"]["wh"].spec == (None, "model")
    for moments in (sh.opt_state.mu, sh.opt_state.nu):
        assert moments is sh.params
    assert sh.opt_state.count.spec == () and sh.step.spec == () and sh.scale.scale.spec == ()


def test_elastic_restore_cuts_each_ranks_piece(tmp_path):
    tree = {"w": torch.arange(48, dtype=torch.float32).reshape(8, 6), "s": torch.tensor(3)}
    checkpointing.save(str(tmp_path), tree, 7)
    for n in (1, 2, 4):
        got = []
        for m in _meshes((n, 1), ("data", "model")):
            sh = {"w": shd.NamedSharding(m, ("data", None)), "s": shd.NamedSharding(m, ())}
            template = {"w": torch.zeros(8 // n, 6), "s": torch.tensor(0)}
            part, step = checkpointing.restore(str(tmp_path), template, shardings=sh)
            assert step == 7 and int(part["s"]) == 3
            got.append(part["w"])
        assert torch.equal(torch.cat(got), tree["w"])
    with pytest.raises(ValueError):
        checkpointing.restore(str(tmp_path), {"w": torch.zeros(8, 6), "s": torch.tensor(0)},
                              shardings={"w": shd.NamedSharding(_Coord((2, 1), ("data", "model"),
                                                                       {"data": 1, "model": 0}), ("data", None)),
                                         "s": shd.NamedSharding(None, ())})


# ---------------------------------------------------------------------------
# a world of one rank
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_host_mesh_over_the_group(world1):
    mesh = make_host_mesh((1, 1), ("data", "model"))
    assert mesh.mesh_dim_names == ("data", "model") and shd.axis_sizes(mesh) == {"data": 1, "model": 1}
    assert mesh.device_type == "cpu"
    with pytest.raises(ValueError):
        make_host_mesh((2, 1), ("data", "model"))
    assert HW.PEAK_FLOPS_BF16 == 989e12 and HW.HBM_BW == 3.35e12


PAYLOADS1 = flat_payloads(psum_payloads(1))


@pytest.mark.parametrize("name,x", PAYLOADS1, ids=[n for n, _ in PAYLOADS1])
def test_fp8_psum_at_one_rank_is_the_saturating_round_trip(world1, name, x):
    got = fp8_psum(torch.from_numpy(x[0])).numpy()
    assert np.array_equal(got.view(np.uint32), exact_psum(x).view(np.uint32))
    if not name.startswith("critical"):  # there the reference's scale misses the power of two
        assert np.array_equal(got.view(np.uint32), jax_psum(x).view(np.uint32))


def test_pod_compressed_mean_without_a_pod_leaves_the_tree(world1):
    grads = {"a": torch.randn(4, 3), "b": [torch.randn(2)]}
    assert pod_compressed_mean(grads, make_host_mesh((1, 1), ("data", "model"))) is grads
    assert pod_compressed_mean(grads, make_host_mesh((1, 1, 1), ("pod", "data", "model"))) is grads


def test_po2_scale_is_exact_at_and_beside_every_power_of_two():
    """The port's scale against 2^floor(log2 q) in float64, for amaxes
    making q = 28672 / amax a power of two, one ulp below and above it, and
    amax itself at and beside a power of two; the reference's formula is
    counted where it misses."""
    amaxes = []
    for k in range(-30, 41):
        p = np.float32(2.0 ** k)
        for a in (np.float32(28672) / p, p):
            amaxes += [a, np.nextafter(a, np.float32(0)), np.nextafter(a, np.float32(np.inf))]
    amaxes = np.array(amaxes, np.float32)
    got = np.array([float(_po2_scale(torch.tensor([a]))) for a in amaxes], np.float32)
    q = np.float32(28672) / amaxes
    want = (2.0 ** np.floor(np.log2(q.astype(np.float64)))).astype(np.float32)
    assert np.array_equal(got, want)
    ref = np.asarray(jax.jit(jax.vmap(lambda a: jgc._po2_scale(a[None])))(jnp.asarray(amaxes)))
    assert 0 < (ref != want).sum() < amaxes.size


def test_the_remat_recompute_routes_as_the_forward_on_any_thread():
    """The reduced dbrx's loss under a one-rank mesh (one routing group),
    its backward run on another thread, as autograd runs a CUDA backward
    and its checkpoint recomputes: the recompute must route one group too,
    and the gradients equal those of a backward on this thread."""
    model = build(get_config("dbrx_132b").reduced())
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, model.cfg.vocab, (2, 16), generator=g) for k in ("tokens", "labels")}
    pol = get_policy("fp32")

    def grads(thread: bool):
        p = {k: v for k, v in params.items()}
        leaves = [t.requires_grad_() for t in _tensors(p)]
        with shd.use_mesh(shd.MeshShape((1, 1), ("data", "model"))):
            loss = model.loss(p, batch, pol)
        out, err = [], []

        def run():
            try:
                out.extend(torch.autograd.grad(loss, leaves, allow_unused=True))
            except Exception as e:  # reported below
                err.append(e)

        if thread:
            t = threading.Thread(target=run)
            t.start()
            t.join()
        else:
            run()
        assert not err, err
        return out

    for a, b in zip(grads(True), grads(False)):
        assert (a is None and b is None) or torch.equal(a, b)


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]
