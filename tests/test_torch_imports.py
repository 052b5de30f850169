"""The port stands alone: no module of ``distlearn_tpu_torch``, not
``chip_smoke.py`` and not the rank body of the two-rank test imports JAX or
the JAX package, and an entry point called
without a device on a machine with no GPU raises instead of running on the
CPU."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "distlearn_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_worker.py",
     ROOT / "tests" / "torch_lm_dist_worker.py",
     ROOT / "tests" / "torch_scan_dist_worker.py",
     ROOT / "tests" / "torch_optim_dist_worker.py",
     ROOT / "tests" / "torch_mesh_worker.py",
     ROOT / "tests" / "torch_lint_worker.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "distlearn_tpu")


def test_port_sources_found():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "distlearn_tpu_torch/train/trainer.py" in names
    assert "distlearn_tpu_torch/ops/fused_update.py" in names
    for mod in ("utils/logging.py", "utils/flags.py", "obs/__init__.py",
                "obs/core.py", "obs/trace.py", "comm/__init__.py",
                "comm/errors.py", "comm/wire.py", "comm/native.py",
                "comm/transport.py", "ops/wire_kernels.py",
                "parallel/async_ea.py", "examples/easgd.py",
                "models/transformer.py", "parallel/sequence.py",
                "ops/flash_attention.py", "obs/export.py",
                "serve/__init__.py", "serve/kv_cache.py",
                "serve/speculate.py", "serve/prefix_cache.py",
                "serve/engine.py", "serve/scheduler.py",
                "serve/client.py", "serve/server.py",
                "utils/checkpoint.py", "examples/lm.py",
                "examples/lm_client.py", "train/lm.py",
                "utils/profiling.py", "train/graphs.py",
                "data/device_dataset.py", "data/prefetch.py",
                "examples/common.py", "examples/mnist.py",
                "examples/mnist_ea.py", "examples/cifar10.py",
                "graft_entry.py", "comm/backend.py", "comm/tree.py",
                "comm/ring.py", "comm/faults.py", "ops/wire_native.py",
                "ops/staging.py", "parallel/host_algorithms.py",
                "parallel/init.py", "examples/client_remote.py",
                "parallel/ha.py", "models/resnet.py", "train/optim.py",
                "examples/resnet50.py", "examples/sync_backends.py",
                "parallel/mesh.py", "parallel/tp.py", "parallel/ep.py",
                "models/convert.py", "parallel/pp.py", "obs/agg.py",
                "tools/__init__.py", "tools/chaos.py", "tools/autoscaler.py",
                "tools/diststat.py", "tools/tracecat.py",
                "tools/ea_convergence.py", "tools/profile_resnet.py",
                "tools/analyze_trace.py", "tools/distlint.py",
                "lint/__init__.py", "lint/core.py", "lint/protocol.py",
                "lint/races.py", "lint/model.py", "lint/conformance.py",
                "lint/spmd.py", "lint/cost.py", "lint/budget.py",
                "lint/registry.py"):
        assert f"distlearn_tpu_torch/{mod}" in names, mod
    assert "chip_smoke.py" in names and (ROOT / "chip_smoke.py").exists()
    assert (ROOT / "distlearn_tpu_torch/ops/csrc/flash_attention.cu").exists()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_gpu(no_gpu):
    from distlearn_tpu_torch.utils.platform import resolve_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_gpu(no_gpu):
    from distlearn_tpu_torch.models import cifar_convnet, mnist_cnn, resnet50
    from distlearn_tpu_torch.parallel.mesh import init_mesh
    for make in (cifar_convnet, mnist_cnn, resnet50):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make().init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_mesh(store=dist.HashStore())
    assert not dist.is_initialized()


def test_serving_entry_points_raise_without_gpu(no_gpu):
    from distlearn_tpu_torch.examples import lm
    from distlearn_tpu_torch.models.transformer import transformer_lm
    from distlearn_tpu_torch.serve import DecodeEngine
    model = transformer_lm(vocab=16, dim=16, depth=1, heads=2, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    params, _ = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(params)
    assert DecodeEngine(params, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.main(["--steps", "0", "--serve", "1", "--dim", "16"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.main(["--steps", "3"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.main(["--steps", "3", "--dp", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.main(["--steps", "3", "--tp", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.main(["--steps", "3", "--pp", "2"])


def test_lm_training_entry_points_raise_without_gpu(no_gpu, tmp_path):
    """LM training and its profiler run on the card unless the CPU is asked
    for: the LM state's init, the trace context, and the mesh the step
    builders take."""
    from distlearn_tpu_torch.models.transformer import transformer_lm
    from distlearn_tpu_torch.parallel.mesh import MeshTree, init_mesh
    from distlearn_tpu_torch.train import lm as train_lm
    from distlearn_tpu_torch.utils.profiling import trace
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with trace(str(tmp_path / "cuda")):
            pass
    with trace(str(tmp_path / "cpu"), device="cpu"):
        torch.ones(2).sum()
    assert (tmp_path / "cpu" / "trace.json").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_mesh(store=dist.HashStore())
    tree = init_mesh(store=dist.HashStore(), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MeshTree()
        model = transformer_lm(vocab=16, dim=16, depth=1, heads=2,
                               max_len=16)
        st = train_lm.init_lm_ea_state(model, tree, 0)
        assert st.params["embed"].device.type == "cpu"
    finally:
        dist.destroy_process_group()


def test_host_layer_entry_points_raise_without_gpu(no_gpu):
    """The process-per-node example and the process-group bootstrap run on
    the card unless the CPU is asked for."""
    from distlearn_tpu_torch.examples import client_remote
    from distlearn_tpu_torch.parallel.init import initialize
    with pytest.raises(RuntimeError, match="no CUDA device"):
        client_remote.main(["--numNodes", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize("127.0.0.1:1", 1, 0)
    assert not dist.is_initialized()


def test_async_fleet_entry_points_raise_without_gpu(no_gpu):
    """The concurrent and striped AsyncEA roles, a joiner and an HA
    standby run on the card unless the CPU is asked for; a concurrent
    standby on the CPU builds (no client is awaited) and closes."""
    from distlearn_tpu_torch.parallel.async_ea import (
        AsyncEAClient, AsyncEAServer, AsyncEAServerConcurrent)
    from tests.net_util import reserve_port_window
    port = reserve_port_window(8)
    for cls in (AsyncEAServer, AsyncEAServerConcurrent):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls("127.0.0.1", port, 1, shards=4, standby=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsyncEAClient.join("127.0.0.1", port, {"w": torch.zeros(2)}, 1, 0.5)
    srv = AsyncEAServerConcurrent("127.0.0.1", port, 1, shards=4,
                                  standby=True, device="cpu")
    assert srv.device.type == "cpu" and srv.evicted == {1}
    srv.close()


def _from_root_tools(mod: str) -> bool:
    """A module of the root ``tools/`` directory (imported by name once
    ``tools/`` is on ``sys.path``)."""
    return mod.split(".")[0] in {p.stem for p in (ROOT / "tools").glob("*.py")}


def test_port_tools_import_nothing_of_the_root_tools():
    """``distlearn_tpu_torch/tools`` reaches the port only: no module of
    the root ``tools/`` (JAX's copies), no ``sys.path`` edits."""
    for path in sorted((ROOT / "distlearn_tpu_torch" / "tools").glob("*.py")):
        mods = list(_imported_modules(path))
        assert not [m for m in mods if _from_root_tools(m)], path.name
        assert "sys.path" not in path.read_text(), path.name


def test_tool_entry_points_raise_without_gpu(no_gpu, tmp_path):
    """The port's tools run their roles and models on the card unless the
    CPU is asked for."""
    from distlearn_tpu_torch.tools import chaos, ea_convergence, profile_resnet
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.run_parity(rounds=4, kills=(1,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.run_churn(rounds=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.run_scenario("zipf_mix", rounds=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ea_convergence.run_algo("sgd", 2, 0.1, 1, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_resnet.main([str(tmp_path)])
    assert not dist.is_initialized()
