"""End-to-end behaviour of the port (counterpart of tests/test_system.py's
test_lm_overfits_single_batch): a reduced LM actually LEARNS under both
optimizers -- the loss drops on a repeated batch -- with SophiaH's
CHESSFAD-chunked curvature refresh inside the step."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import make_batch  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.optim import adamw, sophia_h  # noqa: E402
from repro_torch.optim.schedule import constant  # noqa: E402
from repro_torch.training import TrainState, make_train_step  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    # the small model runs many times slower when several test workers'
    # thread pools share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("optname", ["adamw", "sophia_h"])
def test_lm_overfits_single_batch(optname):
    cfg = get_config("minitron-4b", reduced=True)
    if optname == "adamw":
        opt = adamw(constant(3e-3), weight_decay=0.0)
    else:
        opt = sophia_h(constant(3e-3), weight_decay=0.0, hess_every=5,
                       n_probes=2, csize=2)
    params = init_params(cfg, 0, device="cpu")
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int64), 1)
    step = make_train_step(cfg, None, opt)
    batch = make_batch(cfg, 4, 32, device="cpu")
    losses = []
    for _ in range(30):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] - 0.5, losses[::6]
    assert np.isfinite(losses).all()
