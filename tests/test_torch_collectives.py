"""repro_torch.parallel.collectives against the reference's checks
(tests/test_distributed.py::test_hierarchical_grad_sync_compression and
test_int8_quantization_unbiased are the templates, at their tolerances).

The sync runs in one spawn of 8 gloo rank processes on a ("pod", "data") =
(2, 4) mesh (tests/torch_dist_ranks.py): rank (pod, data) holds row
pod * 4 + data of g, and every rank must end with the mean row."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.parallel import dequantize_int8, quantize_int8  # noqa: E402
from torch_dist_ranks import spawn  # noqa: E402


def test_hierarchical_grad_sync_compression(tmp_path):
    rng = np.random.RandomState(0)
    g = rng.randn(8, 64).astype(np.float32)
    ranks = spawn("collectives", 8, tmp_path, {"g": g}, timeout=120)
    assert sorted(info["row"] for _, info in ranks) == list(range(8))
    want = g.mean(0, keepdims=True)
    for got, _ in ranks:
        exact = got["none"]
        np.testing.assert_allclose(exact, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["bf16"], exact, rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(got["int8"], exact, rtol=0.15,
                                   atol=0.1 * np.abs(exact).max())


def test_int8_quantization_unbiased():
    x = torch.linspace(-3.0, 3.0, 64)
    outs = []
    for i in range(512):
        q, s = quantize_int8(x, torch.Generator().manual_seed(i))
        assert q.dtype == torch.int8
        outs.append(dequantize_int8(q, s).numpy())
    mean = np.stack(outs).mean(0)
    np.testing.assert_allclose(mean, x.numpy(), atol=6e-3)
