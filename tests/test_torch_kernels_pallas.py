"""chess_hvp_plain against the TPU kernel itself: the JAX package's
``chess_hvp_pallas`` in interpret mode on the sweeps of tests/test_kernels.py.  Both sides do the same fp32 arithmetic in a different
summation order, so the bound is the fp32 one of tests/test_kernels.py's
symmetric-vs-vmap_l2 check: rtol 1e-5, atol 1e-5 * (1 + max|want|).

With bfloat16 A and V both compute in float32 and return bfloat16, but the
Pallas kernel rounds its output block to bfloat16 after every cell's add
(it accumulates in A.dtype), while the port rounds once.  Up to 8 cells add
into a row on these sweeps, each rounding off up to half a bfloat16 ulp
(2^-9) of the running sum, so the bound is rtol 2e-2, atol 2e-2 *
(1 + max|want|); the largest gap measured on the sweeps is 7.4e-3 *
(1 + max|want|).  It is within the reference's bfloat16 bound of 1e-1."""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.chess_hvp import chess_hvp_pallas  # noqa: E402
from repro.kernels.ops import _fn_and_consts  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from repro_torch.kernels.chess_hvp import chess_hvp_plain  # noqa: E402
from repro_torch.kernels.ops import kernel_form  # noqa: E402

# (m, n, csize, blk_m, symmetric): the sweeps of tests/test_kernels.py --
# test_chess_hvp_sweep (full schedule) and test_chess_hvp_v2_sweep (ragged n,
# ragged m, csize > n; both schedules)
CASES = ([(16, 8, 2, 8, False), (8, 16, 4, 4, False), (8, 8, 8, 8, False),
          (24, 12, 3, 8, False)]
         + [shape + (sym,) for shape in [(8, 10, 4, 8), (8, 9, 2, 4),
                                         (5, 8, 2, 8), (13, 7, 3, 4),
                                         (4, 6, 16, 8)]
            for sym in (False, True)])


DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,n,csize,blk_m,symmetric", CASES)
@pytest.mark.parametrize("function",
                         ["rosenbrock", "ackley", "fletcher_powell"])
def test_plain_matches_pallas_kernel(function, m, n, csize, blk_m, symmetric,
                                     dtype):
    tdt, jdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(zlib.crc32(f"{function}{m}{n}".encode()))
    A = rng.uniform(-2, 2, (m, n)).astype(np.float32)
    V = rng.randn(m, n).astype(np.float32)
    kf, consts, _ = kernel_form(testfns.FUNCTIONS[function](n))
    got = chess_hvp_plain(kf, torch.from_numpy(A).to(tdt),
                          torch.from_numpy(V).to(tdt), csize, consts,
                          symmetric)
    assert got.dtype == tdt
    jkf, jconsts = _fn_and_consts(function, n)
    want = np.asarray(chess_hvp_pallas(
        jkf, jnp.asarray(A, jdt), jnp.asarray(V, jdt), csize, consts=jconsts,
        blk_m=blk_m, symmetric=symmetric, interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * (1 + np.abs(want).max()))
