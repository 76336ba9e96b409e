"""Run another checkout's `chip_smoke.py` or `tools/torch_breakdown.py`
with this checkout's kernel timer, `chip_smoke.cuda_ms`.

    python3 tools/same_timer.py OTHER/chip_smoke.py
    python3 tools/same_timer.py OTHER/chip_smoke.py --only check_tp_pair
    python3 tools/same_timer.py OTHER/tools/torch_breakdown.py --paths sharded

So that the kernel times of two trees (a commit and its parent, say,
the parent unpacked by `git archive` into a git-ignored directory) are
read under one measurement where the trees' timers differ.  The other
tree runs as it is, on its own sources and its own kernel build; only
its `chip_smoke.cuda_ms` is replaced.  With ``--only NAME`` the other
`chip_smoke.py` runs its one function NAME on cuda:0 (a check phase
that takes the device, say `check_tp_pair`, which builds what it
launches) instead of its whole `main`.  Prints one JSON line naming the
timer before the script's own output.  Needs one CUDA GPU and nvcc.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import runpy
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod            # dataclasses look the module up
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    target = pathlib.Path(sys.argv[1]).resolve()
    other = (target.parent if target.name == "chip_smoke.py"
             else target.parents[1])
    path = list(sys.path)
    timer = _load(HERE / "chip_smoke.py", "_timer_chip_smoke").cuda_ms
    sys.path[:] = path                 # this tree's src leaves the path
    cs = _load(other / "chip_smoke.py", "chip_smoke")
    cs.cuda_ms = timer
    print(json.dumps({"phase": "same_timer", "script": str(target),
                      "timer": f"{HERE / 'chip_smoke.py'}:cuda_ms"}),
          flush=True)
    sys.argv = [str(target)] + sys.argv[2:]
    if target.name == "chip_smoke.py" and sys.argv[1:2] == ["--only"]:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("same_timer --only: no CUDA device")
        getattr(cs, sys.argv[2])(torch.device("cuda"))
    elif target.name == "chip_smoke.py":
        cs.main()
    else:
        runpy.run_path(str(target), run_name="__main__")


if __name__ == "__main__":
    main()
