"""Audit orchestrator: trace matrix + lint + shared-memory budget sweep.

`run_audit` is what ``tools/audit_torch.py`` and `chip_smoke.py`'s
audit phase call: it runs the requested layers and returns an
`AuditReport` whose `ok` is the gate, serialized in the reference's
JSON schema (`report.to_json()`).  The lint layer imports nothing but
the stdlib and the registry's references; the budget layer imports the
planner; only the trace layer needs a device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

from .rules import RULES, Finding

__all__ = ["AuditReport", "run_audit", "REPORT_VERSION", "LAYERS"]

REPORT_VERSION = 1
LAYERS = ("trace", "lint", "budget")


@dataclasses.dataclass
class AuditReport:
    """Everything one audit run determined."""
    findings: list[Finding]
    cases: list[str]                  # trace cases and gate paths run
    layers: tuple[str, ...]
    plans_swept: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        return {
            "version": REPORT_VERSION,
            "ok": self.ok,
            "layers": list(self.layers),
            "cases": list(self.cases),
            "plans_swept": self.plans_swept,
            "findings": [f.to_json() for f in self.findings],
            "rules": {rid: dataclasses.asdict(r)
                      for rid, r in RULES.items()},
        }


def run_audit(*, layers: Optional[Iterable[str]] = None,
              workloads: Optional[list[str]] = None, device=None,
              world: int = 4, log=None) -> AuditReport:
    """Run the requested layers (default: all) over the live tree.

    ``device`` is where the trace layer runs (None: the card; a missing
    GPU raises); given one, the budget sweep also covers its detected
    topology (`Topology.detect`: on the card its L2 and opt-in).
    ``workloads`` restricts the trace matrix to named registry entries,
    ``world`` is its gloo ranks (4, or 2 with the smaller meshes);
    ``log`` gets progress lines.
    """
    want = tuple(layers) if layers is not None else LAYERS
    unknown = set(want) - set(LAYERS)
    if unknown:
        raise ValueError(f"unknown audit layers: {sorted(unknown)}; "
                         f"choose from {LAYERS}")

    findings: list[Finding] = []
    cases: list[str] = []
    plans_swept = 0

    if "trace" in want:
        from . import trace
        if log:
            log("[trace] registry x role x route matrix on gloo ranks, "
                "deterministic paths under the deterministic mode")
        got, cases = trace.run_trace(
            workloads, device=device or "cuda", world=world, log=log)
        findings += got

    if "lint" in want:
        from . import lint
        if log:
            log("[lint] AST rules over live sources")
        findings += lint.run_lint()

    if "budget" in want:
        from . import budget
        detected = None
        if device is not None:
            from repro_torch.core.planner import Topology
            detected = Topology.detect(device=device)
        if log:
            log("[budget] shared-memory sweep over registry x topologies")
        got, plans_swept = budget.run_budget_audit(log=log,
                                                   detected=detected)
        findings += got

    return AuditReport(findings=findings, cases=cases, layers=want,
                       plans_swept=plans_swept)
