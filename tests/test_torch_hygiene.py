"""The PyTorch port stands on its own: no module of ``src/repro_torch``,
no example twin (``examples/torch_*.py``) and nothing in
``chip_smoke.py`` imports JAX, ``ml_dtypes``, the JAX package or its
``benchmarks``, every port module imports with JAX made unimportable, and
``chip_smoke.py`` refuses to run without a CUDA device (or without the
package beside it) before doing any work."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "examples").glob("torch_*.py")))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    """Nor ``ml_dtypes``, which the card's machine lacks: bf16 goes through
    torch (``distributed/checkpoint.py`` stores its raw bits)."""
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax",
                                  "ml_dtypes", "benchmarks")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_walk_covers_every_subpackage():
    """Every subpackage of the port has its modules in the import walk —
    the energy layer (``costmodel``, ``telemetry``), the launcher, the
    fleet and its fault and checkpoint primitives among them."""
    subpackages = {p.parent for p in PORT.rglob("__init__.py")}
    assert subpackages <= {p.parent for p in FILES}
    for name in ("costmodel", "telemetry", "launch", "fleet", "distributed"):
        assert PORT / name in subpackages


def test_every_port_module_imports_without_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= len(modules)


def _run_smoke(script: Path, cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_a_card():
    out = _run_smoke(ROOT / "chip_smoke.py", ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
    assert "[build]" not in out.stdout          # stopped before any work


def test_chip_smoke_refuses_alone_in_a_directory(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", script)
    out = _run_smoke(script, tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


KERNELS = ("featurize", "linucb", "moe_gating", "flash_attention", "rwkv6",
           "mamba2", "decode_attention")


def test_every_cuda_source_is_built_and_names_its_tpu_kernel():
    """Each ``csrc/*.cu`` is in the build's source list (so a checkout
    builds it), and each says which Pallas kernel it replaces."""
    from repro_torch.kernels import build
    csrc = PORT / "kernels" / "csrc"
    assert sorted(build.SOURCES) == sorted(p.name for p in csrc.glob("*.cu"))
    for name in KERNELS:
        src = (csrc / f"{name}.cu").read_text()
        assert f"src/repro/kernels/{name}/kernel.py" in src
        assert (ROOT / "src" / "repro" / "kernels" / name / "kernel.py").exists()
        assert f"{name}_launch" in build._SIGNATURES


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_packages_have_wrapper_launcher_and_plain_version(name):
    import importlib
    pkg = PORT / "kernels" / name
    assert {"kernel.py", "ops.py", "ref.py"} <= {p.name for p in
                                                 pkg.glob("*.py")}
    ops = importlib.import_module(f"repro_torch.kernels.{name}.ops")
    assert ops.launches == 0 or isinstance(ops.launches, int)
