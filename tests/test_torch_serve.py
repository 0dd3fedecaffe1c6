"""The port's serving slice against the JAX package, at a tiny size.

Model: WikiText2LM with vocab 512, emb = hidden = 64, 2 layers, policy
floatsd8_table6; parameters made with numpy from a seed and handed to both
packages (``repro_torch.bridge`` carries them across). Engines: 3 lanes,
chunk 4.

Tolerances:
  * packed codes and biases: byte-identical to ``repro.serving.pack_tree``;
  * one decode_step: logits within 1e-5 relative + 1e-5 absolute; states
    under the lstm_cell flip rule of test_torch_kernels.py (at most 0.1%
    of elements, |dh| <= 2^-3);
  * greedy tokens: equal over the margin-decisive prefix of the JAX
    single-lane reference rollout (the ``_reference_rollout`` rule of
    tests/test_serving.py), with the margin floor raised to 1e-4 because
    two frameworks sum in different orders (logits agree to ~1e-6); at
    least half of all tokens must be decisive.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.distributed import checkpointing  # noqa: E402
from repro.models.lstm_models import WikiText2LM as JLM  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.serving import pack_tree as jpack_tree  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import dispatch as tkd  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import WikiText2LM as TLM  # noqa: E402
from repro_torch.nn.lstm import LSTMState  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Request, Scheduler, ServeEngine, StatePool, masked_reset, pack_tree, synthetic_prompts,
    unpack_tree,
)
from repro_torch.core import floatsd as tfsd  # noqa: E402

V, D, LANES, CHUNK, MAX_NEW = 512, 64, 3, 4, 6
MARGIN_FLOOR = 1e-4
JPOL = jget_policy("floatsd8_table6")
TPOL = tget_policy("floatsd8_table6")


def np_params(seed=0):
    """Seeded numpy parameters in the reference layout; weights scaled up
    from the init so that greedy margins are decisive."""
    rng = np.random.default_rng(seed)
    s = 3.0 / np.sqrt(D)
    p = {"embed": {"table": (rng.standard_normal((V, D)) * 0.5).astype(np.float32)}}
    for i in range(2):
        b = np.zeros(4 * D, np.float32)
        b[D:2 * D] = 1.0
        p[f"lstm{i}"] = {
            "wx": rng.uniform(-s, s, (D, 4 * D)).astype(np.float32),
            "wh": rng.uniform(-s, s, (D, 4 * D)).astype(np.float32),
            "b": b,
        }
    return p


def prompts(seed=1, n=6):
    return synthetic_prompts(n, V, np.random.default_rng(seed), lo=2, hi=11)


def _reference_rollout(step, init, prompt, max_new):
    """Single-lane greedy rollout -> (tokens, n_decisive), as in
    tests/test_serving.py."""
    states, logits = init, None
    for t in prompt:
        logits, states = step(int(t), states)
    out, n_decisive, decisive = [], 0, True
    for _ in range(max_new):
        top2 = np.sort(logits)[-2:]
        decisive = decisive and (top2[1] - top2[0]) > MARGIN_FLOOR
        nxt = int(logits.argmax())
        out.append(nxt)
        n_decisive += int(decisive)
        logits, states = step(nxt, states)
    return out, n_decisive


@pytest.fixture(scope="module")
def jax_side():
    """JAX params, reference rollouts and JAX ServeEngine streams."""
    params = jax.tree_util.tree_map(jnp.asarray, np_params())
    model = JLM(vocab=V, emb=D, hidden=D)
    packed = jpack_tree(params)
    serve_pol = JPOL.replace(weight_quant="none")
    ones = jnp.ones((1,), jnp.int32)
    fn = jax.jit(lambda p, t, s: model.decode_step(p, t, s, serve_pol, lengths=ones))

    def step(tok, states):
        lg, st = fn(packed, jnp.asarray([[tok]], jnp.int32), states)
        return np.asarray(lg[0, -1, :]), st

    refs = [_reference_rollout(step, model.init_cache(1, JPOL), p, MAX_NEW) for p in prompts()]
    eng = JEngine(model, params, JPOL, lanes=LANES, chunk=CHUNK)
    reqs = eng.submit_all([p.copy() for p in prompts()], max_new=MAX_NEW)
    eng.run()
    streams = [r.out for r in sorted(reqs, key=lambda r: r.rid)]
    return dict(params=params, packed=packed, refs=refs, streams=streams)


def _serve_port(params, chunk=CHUNK, **kw):
    eng = ServeEngine(TLM(vocab=V, emb=D, hidden=D), params, TPOL, lanes=LANES, chunk=chunk, **kw)
    reqs = eng.submit_all([p.copy() for p in prompts()], max_new=MAX_NEW)
    m = eng.run()
    return [r.out for r in sorted(reqs, key=lambda r: r.rid)], m, reqs


def _assert_decisive_agreement(streams, refs):
    assert sum(n for _, n in refs) >= MAX_NEW * len(refs) // 2
    for rid, (out, (ref, n)) in enumerate(zip(streams, refs)):
        assert len(out) == MAX_NEW
        assert out[:n] == ref[:n], (rid, out, ref, n)


@pytest.mark.parametrize("source", ["numpy", "jax_init"])
def test_pack_tree_byte_identical_to_jax(jax_side, source):
    """Seeded numpy params, and the JAX model's own init, carried across
    the bridge: the port's codes and biases equal the reference's."""
    if source == "numpy":
        params, want = np_params(), jax_side["packed"]
    else:
        jp = JLM(vocab=V, emb=D, hidden=D).init(jax.random.PRNGKey(3))
        params, want = jax.tree_util.tree_map(np.asarray, jp), jpack_tree(jp)
    packed = pack_tree(bridge.from_jax_params(params, "cpu"))
    for name, leaf in [("embed", "table"), ("lstm0", "wx"), ("lstm0", "wh"),
                       ("lstm1", "wx"), ("lstm1", "wh")]:
        t, j = packed[name][leaf], want[name][leaf]
        assert t.codes.dtype == torch.uint8
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
        assert t.bias == int(j.bias)
    np.testing.assert_array_equal(packed["lstm1"]["b"].numpy(), np.asarray(params["lstm1"]["b"]))
    # decode-at-use view: unpack(pack(w)) is the fake-quant of w, bit for bit
    dense = unpack_tree(packed)
    for name, leaf in [("embed", "table"), ("lstm0", "wx")]:
        q, _ = tfsd.quantize(torch.from_numpy(np.array(params[name][leaf])))
        assert torch.equal(dense[name][leaf], q)


def test_decode_step_matches_jax(jax_side):
    tm, jm = TLM(vocab=V, emb=D, hidden=D), JLM(vocab=V, emb=D, hidden=D)
    toks = np.random.default_rng(2).integers(0, V, (LANES, CHUNK)).astype(np.int32)
    lens = np.array([4, 2, 1], np.int32)
    lg_j, st_j = jm.decode_step(jax_side["packed"], jnp.asarray(toks), jm.init_cache(LANES, JPOL),
                                JPOL.replace(weight_quant="none"), lengths=jnp.asarray(lens))
    tp = pack_tree(bridge.from_jax_params(np_params(), "cpu"))
    lg_t, st_t = tm.decode_step(tp, torch.from_numpy(toks), tm.init_cache(LANES, TPOL, "cpu"),
                                TPOL.replace(weight_quant="none"), lengths=torch.from_numpy(lens))
    assert lg_t.shape == (LANES, CHUNK, V) and lg_t.dtype == torch.float32
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=1e-5, atol=1e-5)
    for sj, st in zip(st_j, st_t):
        assert st.c.dtype == torch.float16
        for a, b in ((sj.h, st.h), (sj.c, st.c)):
            a, b = np.asarray(a, np.float32), b.float().numpy()
            assert (a != b).mean() <= 1e-3 and np.all(np.abs(a - b) <= 2.0**-3)


def test_engine_tokens_match_jax_over_decisive_prefix(jax_side):
    tkd.STATS.reset()
    streams, m, reqs = _serve_port(bridge.from_jax_params(np_params(), "cpu"))
    _assert_decisive_agreement(streams, jax_side["refs"])
    _assert_decisive_agreement(jax_side["streams"], jax_side["refs"])
    assert all(r.status == "done" for r in reqs) and m.emitted == MAX_NEW * len(reqs)
    assert m.prefill_steps > 0 and m.decode_steps > 0
    # on the CPU every site ran the plain versions, and every call was recorded
    assert tkd.STATS.count("lstm_cell", "ref") > 0 and tkd.STATS.count("floatsd_matmul", "ref") > 0
    assert tkd.STATS.count(backend="cuda") == 0


def test_chunked_prefill_same_tokens_fewer_steps(jax_side):
    params = bridge.from_jax_params(np_params(), "cpu")
    s1, m1, _ = _serve_port(params, chunk=1)
    s4, m4, _ = _serve_port(params, chunk=CHUNK)
    _assert_decisive_agreement(s1, jax_side["refs"])
    _assert_decisive_agreement(s4, jax_side["refs"])
    assert m4.steps < m1.steps


def test_jax_checkpoint_serves_from_the_port(jax_side, tmp_path):
    checkpointing.save(str(tmp_path), jax_side["params"], step=7)
    params = bridge.load_jax_checkpoint(str(tmp_path), device="cpu")
    assert sorted(params) == ["embed", "lstm0", "lstm1"]
    np.testing.assert_array_equal(params["lstm0"]["wh"].numpy(), np_params()["lstm0"]["wh"])
    streams, _, _ = _serve_port(params)
    _assert_decisive_agreement(streams, jax_side["refs"])
    # a flat "a/b" dict, and a saved train state (".params/..." keys beside
    # the optimizer's), read as the nested params
    table = np_params()["embed"]["table"]
    for flat in ({"embed/table": table}, {".params/embed/table": table, ".opt_state/0/mu": table}):
        got = bridge.from_jax_params(flat, "cpu")
        assert list(got) == ["embed"] and torch.equal(got["embed"]["table"], torch.from_numpy(table))


def test_checkpoint_hash_mismatch_raises(jax_side, tmp_path):
    d = checkpointing.save(str(tmp_path), jax_side["params"], step=1)
    with open(f"{d}/arrays.npz", "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02")
    with pytest.raises(ValueError, match="content_hash"):
        bridge.load_jax_checkpoint(d, device="cpu")


def test_nonfinite_logits_retire_lanes_and_nonfinite_weights_refuse_to_pack():
    p = bridge.from_jax_params(np_params(), "cpu")
    p["lstm1"]["b"] = torch.full_like(p["lstm1"]["b"], float("nan"))
    _, m, reqs = _serve_port(p)
    assert all(r.status == "numeric_error" for r in reqs) and m.numeric_errors == len(reqs)
    p["lstm1"]["wx"][0, 0] = float("inf")
    with pytest.raises(ValueError, match="nonfinite"):
        pack_tree(p)


def test_cancel_queued_and_active_requests():
    eng = ServeEngine(TLM(vocab=V, emb=D, hidden=D), bridge.from_jax_params(np_params(), "cpu"),
                      TPOL, lanes=2, chunk=CHUNK)
    reqs = eng.submit_all([p.copy() for p in prompts(n=4)], max_new=MAX_NEW)
    eng.step_once()
    assert eng.cancel(reqs[3].rid) and eng.cancel(reqs[0].rid)
    assert not eng.cancel(reqs[0].rid) and not eng.cancel(999)
    m = eng.run()
    assert [r.status for r in reqs] == ["cancelled", "done", "done", "cancelled"]
    assert m.cancelled == 2 and m.retired == 2


def test_state_pool_masked_reset_extract_inject():
    pool = StatePool.for_model(TLM(vocab=V, emb=D, hidden=D), 3, TPOL, "cpu")
    pool.swap([LSTMState(torch.ones(3, D), torch.ones(3, D, dtype=torch.float16)) for _ in range(2)])
    out = masked_reset(pool.caches, torch.tensor([0, 1, 0]))
    assert float(out[0].h[1].abs().sum()) == 0 and float(out[1].c[0].sum()) == D
    snap = pool.extract(2)
    pool.reset(np.array([0, 0, 1]))
    assert float(pool.caches[0].h[2].abs().sum()) == 0
    pool.inject(2, snap)
    assert torch.equal(pool.caches[1].c[2], torch.ones(D, dtype=torch.float16))
    with pytest.raises(ValueError):
        pool.inject(2, [LSTMState(torch.ones(D + 1), torch.ones(D))] * 2)


def test_scheduler_fifo_and_sjf():
    lens = [5, 2, 9, 1, 2]
    for policy, want in (("fifo", [0, 1, 2, 3, 4]), ("sjf", [3, 1, 4, 0, 2])):
        s = Scheduler(policy)
        for i, n in enumerate(lens):
            s.submit(Request(rid=i, prompt=np.arange(n), max_new=1))
        assert s.remove(99) is None
        assert [s.pop().rid for _ in lens] == want and s.pop() is None
    with pytest.raises(ValueError):
        Scheduler("edf")


def test_cli_serves_reduced_model_on_cpu(capsys):
    tserve.main(["--device", "cpu", "--requests", "3", "--batch", "2", "--max-new", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("weights: ") and "MiB packed FloatSD8" in out[0]
    assert out[1].startswith("served 3 requests, 6 tokens")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"
