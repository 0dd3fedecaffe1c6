"""The port's UDPOS tagger, SNLI classifier and Multi30K seq2seq (and the
WikiText-2 LM with its ``proj``, emb != hidden) against the JAX
package's, on the CPU, at a tiny size (vocab 64, width 16, B 4,
S 6), from one JAX init carried over by ``repro_torch.bridge``: one scaled
backward under floatsd8_table6 (the fused quantized BPTT) and the task's
metric with no gradient.

Tolerances: the loss within 1e-6 relative; every fp16 master gradient
within cosine 0.9999 and 0.1% relative L2 of JAX's (FP8 dW snapping and
f32 sums in another order may flip an element by one FP8 step); the
task's metric on an eval batch within 1e-5 relative. The trajectories
are in ``test_torch_task_train.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import lstm_models as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import lstm_models as TM  # noqa: E402
from repro_torch.optim import train_state as tts  # noqa: E402

JT6, TT6 = jget_policy("floatsd8_table6"), tget_policy("floatsd8_table6")
DATA = dict(batch=4, seq=6, vocab=64)
# task -> (model class name, widths, metric)
TASKS = {
    "udpos": ("UDPOSTagger", dict(vocab=64, emb=12, hidden=16), "accuracy"),
    "snli": ("SNLIClassifier", dict(vocab=64, emb=12, proj=10, hidden=16), "accuracy"),
    "multi30k": ("Multi30KSeq2Seq", dict(src_vocab=64, tgt_vocab=64, emb=12, hidden=16), "perplexity"),
    # emb != hidden: the LM's bias-free proj before the tied head
    "wikitext2": ("WikiText2LM", dict(vocab=64, emb=12, hidden=16, n_layers=2), "perplexity"),
}


def _models(task):
    name, kw, _ = TASKS[task]
    return getattr(JM, name)(**kw), getattr(TM, name)(**kw)


def _flat_j(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("task", list(TASKS))
def test_model_loss_gradients_and_metric_match_jax(task):
    jm, tm = _models(task)
    params_np = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    gen = getattr(jsyn, task)(**DATA)
    batch, ev = next(gen.batches), next(gen.eval_batches)
    pol_j = JT6.replace(grad_quant="fp8_kernel")
    master = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float16), params_np)
    l_j, g_j = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, pol_j) * 1024.0))(master)
    p = bridge.from_jax_params(params_np, "cpu")
    p = tree_map(lambda t: t.to(torch.float16).requires_grad_(), p)
    l_t = tm.loss(p, tts.batch_to_device(batch, "cpu"), TT6.replace(grad_quant="fp8_kernel")) * 1024.0
    l_t.backward()
    assert abs(l_t.item() - float(l_j)) <= 1e-6 * abs(float(l_j))
    for key, want in _flat_j(g_j).items():
        node = p
        for part in key.split("/"):
            node = node[part]
        assert node.grad.dtype == torch.float16, key
        a, c = np.asarray(want, np.float32).ravel(), node.grad.float().numpy().ravel()
        assert np.linalg.norm(a) > 0, key
        assert np.dot(a, c) / (np.linalg.norm(a) * np.linalg.norm(c)) > 0.9999, key
        assert np.linalg.norm(a - c) <= 1e-3 * np.linalg.norm(a), key
    # the task's metric on a held-out batch, no gradient: the inference scan
    metric = TASKS[task][2]
    want = float(jax.jit(lambda p, b: getattr(jm, metric)(p, b, JT6))(
        master, {k: jnp.asarray(v) for k, v in ev.items()}))
    with torch.no_grad():
        got = float(getattr(tm, metric)(tree_map(lambda t: t.detach(), p),
                                        tts.batch_to_device(ev, "cpu"), TT6))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
