"""Static analysis of the port's determinism and shared-memory contracts.

Three layers, one report:

* **trace** (`trace`): run the registry-workload x route matrix on a
  process mesh of gloo ranks through the real epoch builders, with the
  `torch.distributed` collectives recorded, and the deterministic
  single-process paths twice under
  ``torch.use_deterministic_algorithms(True)`` with their aten ops
  recorded (TORCH-SUM-EXCHANGE, TORCH-NONDET-OP);
* **lint** (`lint`): AST rules that ruff cannot express (kernel-contract
  registration, collective markers, unseeded RNG, CSR entry altitudes,
  swallowed exceptions);
* **budget** (`budget`): a sweep proving that no plan the planner can
  emit routes to a kernel over the card's shared-memory budget.

`runner.run_audit` runs them and emits the machine-readable report;
`selftest.run_selftests` mutates each invariant and proves the matching
detector fires.  Front door: ``tools/audit_torch.py``.

This ``__init__`` stays import-light: `rules` and `config` are stdlib
only, as `lint` is, so docs tooling reads the registry without torch.
"""
from . import config, rules           # noqa: F401  (stdlib only)
from .rules import RULES, Finding, Rule  # noqa: F401
