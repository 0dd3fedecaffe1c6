"""The port imports neither JAX nor the JAX package (``repro``): every
module of ``repro_torch`` imports in a fresh interpreter where both are
blocked, and no source of the port (nor ``chip_smoke.py``, nor a script of
``benchmarks_torch/``) names them in an import statement."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "repro")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of them now raises ImportError
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
loaded = [k for k, v in sys.modules.items() if v is not None and k.split(".")[0] in {BLOCKED!r}]
assert not loaded, loaded
print(len(names))
"""


def test_every_port_module_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 30  # the walk found the whole package


def _imported(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_port_source_imports_jax_or_repro():
    sources = [*(ROOT / "src" / "repro_torch").rglob("*.py"), *(ROOT / "benchmarks_torch").glob("*.py"),
               ROOT / "chip_smoke.py"]
    assert len(sources) > 30
    bad = {str(p.relative_to(ROOT)): _imported(p) & set(BLOCKED) for p in sources}
    assert not {k: v for k, v in bad.items() if v}


def test_walk_reaches_the_floatsd4_and_elementwise_kernel_modules():
    """The blocked import above walks these modules too (the FloatSD4
    serving path and the quantize / qsigmoid entry points)."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    for kernel in ("floatsd4_matmul", "floatsd_quantize", "qsigmoid"):
        assert {f"repro_torch.kernels.{kernel}.ops", f"repro_torch.kernels.{kernel}.ref"} <= names
    assert "repro_torch.core.floatsd4" in names


def test_walk_reaches_the_rwkv_zoo_modules():
    """The blocked import above walks the RWKV-6 serving slice too: its
    kernel, the zoo's modules, the model and its config."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {"repro_torch.kernels.rwkv_wkv.ops", "repro_torch.kernels.rwkv_wkv.ref"} <= names
    assert {f"repro_torch.nn.{m}" for m in ("module", "norms", "rwkv", "transformer")} <= names
    assert {"repro_torch.models.lm", "repro_torch.configs.rwkv6_3b"} <= names


def test_walk_reaches_the_dense_modules():
    """The blocked import above walks the dense slice too: the attention
    kernel, the attention, RoPE and FFN modules, and the four dense
    configs."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {"repro_torch.kernels.flash_attention.ops", "repro_torch.kernels.flash_attention.ref"} <= names
    assert {f"repro_torch.nn.{m}" for m in ("attention", "rotary", "ffn", "linear")} <= names
    assert {f"repro_torch.configs.{c}" for c in ("h2o_danube3_4b", "stablelm_3b", "phi4_mini_3p8b",
                                                 "granite_20b")} <= names


def test_walk_reaches_the_training_runtime_modules():
    """The blocked import above walks the training runtime too: telemetry,
    checkpointing, fault tolerance and the input pipeline."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {"repro_torch.obs", "repro_torch.obs.telemetry", "repro_torch.distributed",
            "repro_torch.distributed.checkpointing", "repro_torch.distributed.fault_tolerance",
            "repro_torch.data.pipeline"} <= names


def test_walk_reaches_the_serving_frontend_modules():
    """The blocked import above walks the serving frontend too: the fault
    switchboard, the tracer, the prefix cache and the router."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {"repro_torch.faults", "repro_torch.obs.trace", "repro_torch.serving.frontend",
            "repro_torch.serving.frontend.prefix_cache",
            "repro_torch.serving.frontend.router"} <= names


def test_walk_reaches_the_http_and_cost_ledger_modules():
    """The blocked import above walks the HTTP/SSE service and the kernel
    cost ledger too: the protocol, server, client and Prometheus modules,
    ``obs.costmodel`` and each kernel package's ``cost`` module."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {f"repro_torch.serving.http.{m}" for m in ("protocol", "server", "client", "prometheus")} <= names
    assert "repro_torch.obs.costmodel" in names
    assert {f"repro_torch.kernels.{k}.cost" for k in ("floatsd_matmul", "floatsd4_matmul", "lstm_cell",
                                                      "floatsd_quantize", "qsigmoid", "rwkv_wkv",
                                                      "flash_attention")} <= names
