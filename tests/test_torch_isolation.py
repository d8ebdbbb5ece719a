"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the ``repro`` package, and the chip smoke script refuses to
run (and prints no result) without a CUDA card or outside the repository."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(extra)
    return env


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch, repro_torch.engine, repro_torch.kernels.ops\n"
        "import repro_torch.convert, repro_torch.kernels.build\n"
        "import repro_torch.obs, repro_torch.serving\n"
        "import repro_torch.launch.serve\n"
        "from repro_torch.serving import frontend, scheduler, dispatch\n"
        "from repro_torch.engine import service, autotune\n"
        "import repro_torch.engine.autotune\n"
        "from repro_torch import engine\n"
        "from repro_torch.core import testfns\n"
        "import repro_torch.configs, repro_torch.models\n"
        "from repro_torch.configs import base, h2o_danube_1_8b\n"
        "from repro_torch.models import (attention, common, model, params,\n"
        "                                targets, transformer)\n"
        "from repro_torch.models import decode_engine, kv_quant\n"
        "from repro_torch.models import moe, moe_sharded, ssm\n"
        "from repro_torch.core import curvature\n"
        "from repro_torch.engine import pytree\n"
        "import repro_torch.hostarray, repro_torch.optim\n"
        "from repro_torch.optim import newton_cg, optimizers, schedule\n"
        "import repro_torch.data, repro_torch.checkpoint\n"
        "from repro_torch.data import synthetic\n"
        "from repro_torch.checkpoint import checkpoint\n"
        "import repro_torch.training, repro_torch.launch.train\n"
        "from repro_torch.training import loop, steps\n"
        "from repro_torch.core import distributed, funclock\n"
        "import repro_torch.parallel\n"
        "from repro_torch.parallel import collectives\n"
        "from repro_torch.launch import dryrun, hlo_analysis, mesh, roofline\n"
        "from repro_torch.parallel import sharding\n"
        "from repro_torch.training import pipeline\n"
        "from repro_torch.engine import get_backend\n"
        "assert get_backend('sharded').requires_mesh\n"
        "assert get_backend('sharded_rows').requires_mesh\n"
        "p = engine.plan(testfns.rosenbrock, 8, device='cpu')\n"
        "assert p.backend_for('batched_hvp') == 'vmap_l2'\n"
        "cfg = repro_torch.configs.get_config('h2o-danube-1.8b', True)\n"
        "assert cfg.num_params() > 0\n"
        "from repro_torch.configs import whisper_base, internvl2_1b\n"
        "from repro_torch.models.params import init_params\n"
        "for name in ('whisper-base', 'internvl2-1b'):\n"
        "    c = repro_torch.configs.get_config(name, True)\n"
        "    b = model.make_batch(c, 1, 12, 0, device='cpu')\n"
        "    model.loss_fn(init_params(c, 0, device='cpu'), c, b)\n"
        "q = engine.plan(lambda t: (t['x'] ** 4).sum(), None, "
        "device='cpu')\n"
        "assert q.backend_for('diag') == 'pytree_fwdrev'\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_port_imports_jax_or_repro():
    # the rank processes of the multi-rank tests run the port alone too
    files = sorted(PORT.rglob("*.py")) + [SMOKE,
                                          ROOT / "tests" / "torch_dist_ranks.py"]
    assert len(files) > 10
    for new in (("engine", "autotune.py"), ("core", "curvature.py"),
                ("models", "model.py"), ("models", "targets.py"),
                ("configs", "base.py"), ("configs", "h2o_danube_1_8b.py"),
                ("hostarray.py",), ("optim", "optimizers.py"),
                ("optim", "newton_cg.py"), ("optim", "schedule.py"),
                ("data", "synthetic.py"), ("checkpoint", "checkpoint.py"),
                ("training", "steps.py"), ("training", "loop.py"),
                ("launch", "train.py"), ("core", "distributed.py"),
                ("core", "funclock.py"), ("parallel", "__init__.py"),
                ("parallel", "collectives.py"), ("launch", "mesh.py"),
                ("launch", "hlo_analysis.py"), ("launch", "roofline.py"),
                ("launch", "dryrun.py"),
                ("parallel", "sharding.py"), ("training", "pipeline.py"),
                ("models", "kv_quant.py"), ("models", "decode_engine.py"),
                ("models", "transformer.py"), ("models", "moe_sharded.py"),
                ("configs", "whisper_base.py"),
                ("configs", "internvl2_1b.py")):
        assert PORT.joinpath(*new) in files
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, str(SMOKE)], cwd=ROOT,
                         env=_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
