"""Kernel B1 (the fused SGD update, ``dl_fused_sgd_f32``) run on the CPU.

``distlearn_tpu_torch/ops/csrc/fused_update.cu`` compiles here with g++ as
host C++ over ``tests/torch_cuda_emu.h`` (each thread of a block a thread,
the streaming load and store hints plain accesses), as
tests/test_torch_wire_kernels.py does for the wire kernels.  The emulated
kernel is held bit for bit against ``sgd_plain`` (two rounded operations,
the arithmetic the card repeats) and within the JAX suite's own tolerance
of the JAX package's ``fused_sgd`` in interpret mode (XLA's CPU backend
contracts ``p - lr*g`` into a fused multiply-add,
tests/test_torch_fused_update.py), at an aligned bucket, a view one
element in (no 16-byte alignment: the scalar path) and ragged lengths,
one launch reported per call.
What this cannot show: that nvcc takes the source, and the card's speed
(``chip_smoke.py`` phase 3).  Skipped where no g++ is."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from distlearn_tpu.ops import fused_update as jfu  # noqa: E402
from distlearn_tpu_torch.ops import fused_update as fu  # noqa: E402

SOURCE = Path(fu.__file__).resolve().parent / "csrc" / "fused_update.cu"
SHIM = Path(__file__).resolve().parent / "torch_cuda_emu.h"
#: elements one block takes (1 float4 x 128 threads)
CHUNK = 4 * 128
# the JAX suite's tolerance for this kernel (tests/test_torch_fused_update.py)
RTOL, ATOL = 1e-6, 1e-7


def host_source(cu: str) -> str:
    """The CUDA source as host C++ over the shim: each ``<<<grid, block,
    0, stream>>>`` launch becomes the shim's ``emu_launch``."""
    assert cu.count("#include <cuda_runtime.h>") == 1
    text = cu.replace("#include <cuda_runtime.h>", f'#include "{SHIM.name}"')
    text, n = re.subn(r"(\w+)\s*<<<(.+?), (\w+), 0,\s*"
                      r"(\w+)>>>\(", r"emu_launch(\1, dim3(\2), \3, ", text,
                      flags=re.S)
    assert n == 3, n
    return text


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernel")
    d = tmp_path_factory.mktemp("fused_emu")
    src = d / "fused_emu.cpp"
    src.write_text(host_source(SOURCE.read_text()))
    so = d / "libfused_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", f"-I{SHIM.parent}", "-o", str(so), str(src)],
                   check=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for name, sig in fu._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = sig, ctypes.c_int
    return lib


def _operands(n, seed, off):
    """p and g of n elements, ``off`` elements into their buffers."""
    rng = np.random.default_rng([n, seed])
    p = torch.empty(n + 1)[off:off + n]
    g = torch.empty(n + 1)[off:off + n]
    p.copy_(torch.from_numpy(rng.standard_normal(n).astype(np.float32)))
    g.copy_(torch.from_numpy(rng.standard_normal(n).astype(np.float32)))
    return p, g


def _jax_fused_sgd(p, g, lr):
    """The JAX package's kernel in interpret mode, on the operands padded
    to its 1024-element tile."""
    n = p.numel()
    pad = -n % 1024
    pj = np.pad(p.numpy(), (0, pad))
    gj = np.pad(g.numpy(), (0, pad))
    return np.asarray(jfu.fused_sgd(jnp.asarray(pj), jnp.asarray(gj), lr))[:n]


def _bits(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("off", [0, 1], ids=["aligned", "one_in"])
@pytest.mark.parametrize("n", [1, 3, 4, 4 * CHUNK - 1, 4 * CHUNK,
                               4 * CHUNK + 5, 2 * CHUNK + CHUNK // 2 + 3,
                               7 * 1024])
def test_emulated_fused_sgd_bitwise_vs_plain_and_jax(emu, n, off):
    """One launch reported per call; the output bit for bit ``sgd_plain``
    and within the JAX suite's tolerance of its Pallas kernel.  The lengths
    cover one float4, a whole number of chunks, a last chunk that ends in
    whole float4s and one that ends in a half-used block plus a scalar
    tail."""
    lr = 0.1
    p, g = _operands(n, 0, off)
    out = torch.full((n,), float("nan"))
    rc = emu.dl_fused_sgd_f32(out.data_ptr(), p.data_ptr(), g.data_ptr(), n,
                              fu.cast_scalar(lr, torch.float32), None)
    assert rc == 1
    np.testing.assert_array_equal(_bits(out), _bits(fu.sgd_plain(p, g, lr)))
    np.testing.assert_allclose(out.numpy(), _jax_fused_sgd(p, g, lr),
                               rtol=RTOL, atol=ATOL)


def test_emulated_fused_sgd_no_launch_when_empty(emu):
    assert emu.dl_fused_sgd_f32(None, None, None, 0, 0.1, None) == 0
