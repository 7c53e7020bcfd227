"""The port stands alone: it imports neither jax nor anything of the JAX
package, and ``chip_smoke.py`` refuses to run (and prints no result)
where there is no card or no port beside it."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                       re.MULTILINE)


def _port_modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    mods = list(_port_modules())
    for m in ("repro_torch.kernels.bsr_matmul", "repro_torch.models.convnet",
              "repro_torch.core.regularity",
              "repro_torch.core.latency_model",
              "repro_torch.core.mapper_rule",
              "repro_torch.core.mapper_search",
              "repro_torch.configs.kimi_k2_1t_a32b",
              "repro_torch.serve.scheduler", "repro_torch.serve.kvcache",
              "repro_torch.optim.adamw", "repro_torch.data.pipeline",
              "repro_torch.core.pruner", "repro_torch.distributed.elastic",
              "repro_torch.launch.train", "repro_torch.train.trainer",
              "repro_torch.core.validate", "repro_torch.serve.artifacts",
              "repro_torch.testing.faults",
              "repro_torch.distributed.checkpoint",
              "repro_torch.core.fusion", "repro_torch.core.autotune",
              "repro_torch.configs.seamless_m4t_large_v2",
              "repro_torch.configs.llama_3p2_vision_90b",
              "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
              "repro_torch.testing.dist_ranks", "repro_torch.launch.dryrun",
              "repro_torch.core.roofline",
              "repro_torch.launch.roofline_report"):
        assert m in mods
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PKG.rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_no_source_imports_jax_or_repro(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), path


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_card_or_port(where, tmp_path):
    """On this GPU-less machine, and from a directory holding only the
    script, ``chip_smoke.py`` exits non-zero and never claims success."""
    import torch
    if where == "checkout" and torch.cuda.is_available():
        pytest.skip("this machine has a card")
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
