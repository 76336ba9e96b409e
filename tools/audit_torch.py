"""Determinism and shared-memory invariant auditor of the PyTorch port.

Runs the static-analysis layers of `repro_torch.analysis` over the live
tree and exits nonzero on any finding:

* ``trace``  — the registry workload x model role x route matrix on a
  world of gloo ranks through the real epoch builders, with the
  torch.distributed collectives recorded (TORCH-SUM-EXCHANGE), and the
  deterministic single-process paths run twice under
  ``torch.use_deterministic_algorithms(True)`` (TORCH-NONDET-OP);
* ``lint``   — stdlib AST rules (kernel contract registry, collective
  markers, unseeded RNG, CSR entry altitudes, swallowed exceptions);
* ``budget`` — the planner's candidate geometries against the kernels'
  own shared-memory models (SMEM-PLAN-BUDGET).

``--selftest`` also runs the mutation self-tests of the chosen layers
(one injected bug per rule ID; each must be detected).  Usage::

    PYTHONPATH=src python tools/audit_torch.py [--report AUDIT.json]
        [--selftest] [--layers trace,lint,budget] [--workloads a,b]
        [--device cuda|cpu] [--world 4|2] [--quiet]

The trace layer and its self-tests run on ``--device`` (the card by
default; ``cpu`` runs the kernels' plain versions); the lint and budget
layers need no device, and given one the budget sweep also covers its
detected topology.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main(argv: list[str] | None = None) -> int:
    """CLI entry point; returns a process exit status."""
    from repro_torch.analysis import runner

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--report", metavar="PATH",
                    help="write the JSON report here")
    ap.add_argument("--selftest", action="store_true",
                    help="also run the chosen layers' mutation self-tests")
    ap.add_argument("--layers", default=",".join(runner.LAYERS),
                    help="comma-separated subset of "
                         f"{','.join(runner.LAYERS)}")
    ap.add_argument("--workloads", default="",
                    help="comma-separated registry names (default: all)")
    ap.add_argument("--device", default=None,
                    help="where the trace layer runs (default: cuda)")
    ap.add_argument("--world", type=int, default=4, choices=(2, 4),
                    help="gloo ranks of the trace matrix")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-case progress lines")
    args = ap.parse_args(argv)

    log = (lambda s: None) if args.quiet else print
    layers = [s for s in args.layers.split(",") if s]
    workloads = [s for s in args.workloads.split(",") if s] or None

    report = runner.run_audit(layers=layers, workloads=workloads,
                              device=args.device, world=args.world, log=log)
    for f in report.findings:
        print(f"FINDING: {f}", file=sys.stderr)

    failures: list[str] = []
    if args.selftest:
        from repro_torch.analysis import selftest
        log("[selftest] mutation checks, one per rule ID")
        failures = selftest.run_selftests(
            layers, device=args.device or "cuda", log=log)
        for msg in failures:
            print(f"SELFTEST FAILURE: {msg}", file=sys.stderr)

    if args.report:
        doc = report.to_json()
        if args.selftest:
            doc["selftest_failures"] = failures
        Path(args.report).write_text(json.dumps(doc, indent=2) + "\n")
        log(f"report written to {args.report}")

    print(f"audit: {len(report.cases)} traced case(s), "
          f"{report.plans_swept} plan(s) swept, "
          f"{len(report.findings)} finding(s)"
          + (f", {len(failures)} selftest failure(s)"
             if args.selftest else ""))
    return 1 if (report.findings or failures) else 0


if __name__ == "__main__":
    raise SystemExit(main())
