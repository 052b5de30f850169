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
    [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_worker.py"]


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
                "parallel/async_ea.py", "examples/easgd.py"):
        assert f"distlearn_tpu_torch/{mod}" in names, mod
    assert "chip_smoke.py" in names and (ROOT / "chip_smoke.py").exists()


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
    from distlearn_tpu_torch.models import cifar_convnet, mnist_cnn
    from distlearn_tpu_torch.parallel.mesh import init_mesh
    for make in (cifar_convnet, mnist_cnn):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make().init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_mesh(store=dist.HashStore())
    assert not dist.is_initialized()
