"""The port imports neither JAX nor the reference package.

Parses every module of `src/repro_torch/` (the `launch/` and
`analysis/` packages and `optim/lbfgs.py` included), `chip_smoke.py`,
`tools/torch_breakdown.py`, `tools/same_timer.py`, `tools/streamed_ab.py`,
`tools/mesh_dist_rank.py` (the process mesh's rank program) and
`tools/audit_torch.py` (the port's audit CLI) with `ast`
and fails on any import of `jax` or `repro` (other than `repro_torch`),
at any depth: inside functions too.
"""
import ast
import pathlib

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "torch_breakdown.py",
    ROOT / "tools" / "same_timer.py", ROOT / "tools" / "streamed_ab.py",
    ROOT / "tools" / "mesh_dist_rank.py", ROOT / "tools" / "audit_torch.py"]


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_new_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"src/repro_torch/launch/glm.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/launch/steps.py",
            "src/repro_torch/configs/base.py",
            "src/repro_torch/configs/recurrentgemma_2b.py",
            "src/repro_torch/configs/smollm_360m.py",
            "src/repro_torch/models/layers.py",
            "src/repro_torch/models/attention.py",
            "src/repro_torch/models/recurrent.py",
            "src/repro_torch/models/lm.py",
            "src/repro_torch/kernels/flash_attention.py",
            "src/repro_torch/kernels/rglru.py",
            "src/repro_torch/kernels/ref.py",
            "src/repro_torch/checkpoint/manager.py",
            "src/repro_torch/api/estimators.py",
            "src/repro_torch/api/callbacks.py",
            "src/repro_torch/api/deprecation.py",
            "src/repro_torch/core/cocoa.py",
            "src/repro_torch/core/planner.py",
            "src/repro_torch/resilience/faultinject.py",
            "src/repro_torch/resilience/journal.py",
            "src/repro_torch/resilience/feed.py",
            "src/repro_torch/resilience/health.py",
            "src/repro_torch/data/cache.py",
            "src/repro_torch/core/engine.py",
            "src/repro_torch/optim/lbfgs.py",
            "src/repro_torch/analysis/__init__.py",
            "src/repro_torch/analysis/rules.py",
            "src/repro_torch/analysis/config.py",
            "src/repro_torch/analysis/lint.py",
            "src/repro_torch/analysis/budget.py",
            "src/repro_torch/analysis/trace.py",
            "src/repro_torch/analysis/selftest.py",
            "src/repro_torch/analysis/runner.py",
            "tools/mesh_dist_rank.py", "tools/audit_torch.py"} <= names


def test_every_kernel_source_is_registered():
    from repro_torch.kernels.contracts import KERNEL_CONTRACTS
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    registered = {c["source"].split("/")[-1]
                  for c in KERNEL_CONTRACTS.values()}
    assert registered == {p.name for p in csrc.glob("*.cu")}
