"""chess_hvp_plain against the TPU kernel itself: the JAX package's
``chess_hvp_pallas`` in interpret mode on the sweeps of tests/test_kernels.py.  Both sides do the same fp32 arithmetic in a different
summation order, so the bound is the fp32 one of tests/test_kernels.py's
symmetric-vs-vmap_l2 check: rtol 1e-5, atol 1e-5 * (1 + max|want|)."""

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


@pytest.mark.parametrize("m,n,csize,blk_m,symmetric", CASES)
@pytest.mark.parametrize("function",
                         ["rosenbrock", "ackley", "fletcher_powell"])
def test_plain_matches_pallas_kernel(function, m, n, csize, blk_m, symmetric):
    rng = np.random.RandomState(zlib.crc32(f"{function}{m}{n}".encode()))
    A = rng.uniform(-2, 2, (m, n)).astype(np.float32)
    V = rng.randn(m, n).astype(np.float32)
    kf, consts, _ = kernel_form(testfns.FUNCTIONS[function](n))
    got = chess_hvp_plain(kf, torch.from_numpy(A), torch.from_numpy(V), csize,
                          consts, symmetric).numpy()
    jkf, jconsts = _fn_and_consts(function, n)
    want = np.asarray(chess_hvp_pallas(
        jkf, jnp.asarray(A), jnp.asarray(V), csize, consts=jconsts,
        blk_m=blk_m, symmetric=symmetric, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * (1 + np.abs(want).max()))
