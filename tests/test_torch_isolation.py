"""The port stands alone: ``repro_torch``, its example scripts
(``examples_torch/``) and ``chip_smoke.py`` import neither JAX nor the
``repro`` package; the chip smoke script refuses to run (and prints no
result) without a CUDA card or outside the repository, and each example
script, without a card and without ``--device cpu``, fails with the
engine's no-CUDA-device error and prints nothing."""

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
EXAMPLES = ROOT / "examples_torch"
SCRIPTS = ("quickstart", "hvp_service", "lm_curvature", "serve_lm",
           "train_lm")


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
    files += sorted(EXAMPLES.glob("*.py"))
    assert len(files) > 10
    for name in SCRIPTS:
        assert EXAMPLES / f"{name}.py" in files
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
                ("configs", "internvl2_1b.py"),
                ("kernels", "trace.py"), ("kernels", "codegen.py")):
        assert PORT.joinpath(*new) in files
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_fails_without_a_card(name):
    out = subprocess.run([sys.executable, str(EXAMPLES / f"{name}.py")],
                         cwd=ROOT, env=_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "RuntimeError: plan(): no CUDA device is available" in out.stderr


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


def test_code_generator_writes_only_under_the_build_dir(tmp_path,
                                                        monkeypatch):
    """trace.py and codegen.py write no file; build.py writes a generated
    source, its log and its library under ``build.BUILD_DIR`` and nowhere
    else (a stand-in nvcc writes the library here: there is none)."""
    import torch

    from repro_torch.core import hmath as hm
    from repro_torch.kernels import build, trace
    for name in ("trace.py", "codegen.py"):
        text = (PORT / "kernels" / name).read_text()
        for call in ("open(", "write_text", "write_bytes", "mkdir",
                     "os.replace", "unlink", "shutil."):
            assert call not in text, (name, call)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 1 ]; do [ \"$1\" = -o ] && "
                    "out=$2; shift; done\n: > \"$out\"\n")
    nvcc.chmod(0o755)
    out = tmp_path / "build"
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    src = sorted((p, p.stat().st_mtime_ns) for p in ROOT.joinpath(
        "src").rglob("*") if p.is_file() and "__pycache__" not in p.parts)

    def f(x):
        return hm.sin(x * x).sum(0)
    form = trace.traced_form(f, (), 6)
    (so,) = build.build_generated([form.source])
    assert so.exists() and so.parent == out
    assert sorted(p.name for p in out.iterdir()) == sorted(
        p.name for p in build.generated_paths(form.source))
    assert build.build_generated([form.source]) == [so]   # built once
    assert sorted((p, p.stat().st_mtime_ns) for p in ROOT.joinpath(
        "src").rglob("*") if p.is_file()
        and "__pycache__" not in p.parts) == src
    assert torch.is_tensor(form.constants((), "cpu"))
