"""The hand-written CUDA chess_hvp kernel against its plain PyTorch version,
on the card (rtol 5e-3, atol 5e-3 * (1 + max|want|), the reference's
kernel tolerance).  Needs a CUDA card and nvcc; skips without a card.
Imports nothing of JAX, so it runs where only the port is installed:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import testfns  # noqa: E402
from repro_torch.kernels import chess_hvp as ck  # noqa: E402
from repro_torch.kernels.ops import kernel_form  # noqa: E402

# the CPU sweep's shapes (ragged n, ragged m, csize > n) and the main
# path's width at both auto chunk sizes, plus csize = 64, the widest
SHAPES = [(16, 8, 2), (8, 16, 4), (8, 8, 8), (24, 12, 3), (8, 10, 4),
          (8, 9, 2), (5, 8, 2), (13, 7, 3), (4, 6, 16), (256, 64, 4),
          (256, 64, 8), (3, 64, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a "
                    "and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("function",
                         ["rosenbrock", "ackley", "fletcher_powell"])
def test_cuda_kernel_matches_plain(cuda, function, symmetric):
    for m, n, csize in SHAPES:
        rng = np.random.RandomState(zlib.crc32(f"{function}{m}{n}".encode()))
        A = torch.from_numpy(rng.uniform(-2, 2, (m, n)).astype(np.float32))
        V = torch.from_numpy(rng.randn(m, n).astype(np.float32))
        A, V = A.to(cuda), V.to(cuda)
        kf, consts, device_fn = kernel_form(testfns.FUNCTIONS[function](n))
        consts = tuple(c.to(cuda) for c in consts)
        before = ck.chess_hvp_cuda.launches
        got = ck.chess_hvp_cuda(kf, A, V, csize, consts=consts,
                                device_fn=device_fn, symmetric=symmetric)
        torch.cuda.synchronize()
        assert ck.chess_hvp_cuda.launches == before + 1
        want = ck.chess_hvp_plain(kf, A, V, csize, consts,
                                  symmetric).cpu().numpy()
        np.testing.assert_allclose(
            got.cpu().numpy(), want, rtol=5e-3,
            atol=5e-3 * (1 + np.abs(want).max()),
            err_msg=f"m={m} n={n} csize={csize}")


@pytest.mark.cuda
def test_cuda_wrapper_refusals(cuda):
    A = torch.zeros(2, 8, device=cuda)
    kf, consts, device_fn = kernel_form(testfns.rosenbrock)
    with pytest.raises(ValueError, match="device form"):
        ck.chess_hvp_cuda(kf, A, A, 2, device_fn=None)
    with pytest.raises(ValueError, match="64 lanes"):
        ck.chess_hvp_cuda(kf, A, A, 65, device_fn=device_fn)
    with pytest.raises(ValueError, match="contiguous"):
        At = torch.zeros(8, 2, device=cuda).T
        ck.chess_hvp_cuda(kf, At, At, 2, device_fn=device_fn)
    with pytest.raises(TypeError):
        ck.chess_hvp_cuda(kf, A.half(), A.half(), 2, device_fn=device_fn)
