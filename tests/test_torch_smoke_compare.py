"""`tools/smoke_compare.py`: which numbers of a `chip_smoke.py` log are
gap readings, and that a change in one, or in an LM serving line, is
reported.  No device; CPU seconds: under 1."""
import importlib.util
import json
import pathlib

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
spec = importlib.util.spec_from_file_location(
    "smoke_compare", ROOT / "tools" / "smoke_compare.py")
sc = importlib.util.module_from_spec(spec)
spec.loader.exec_module(sc)

LINES = [
    {"phase": "dense", "epoch": 1, "seconds": 1.01, "gap": 4.37e-3},
    {"phase": "streamed", "path": "dense", "gap": 0.0527,
     "twin_gap": 0.0527, "gap_rel_diff": 4.5e-7, "gap_seconds": 2.05,
     "twin_gap_seconds": 1.1, "seconds_with_gap": 3.0},
    {"phase": "estimator", "path": "sparse", "gaps": [8.4e-3, 5.3e-4]},
    {"phase": "mesh", "sim_equals_mesh_gap": True,
     "runs": [{"gap_after_2": 1e-4}]},
    {"phase": "lm", "step": "prefill", "config": "smollm-360m",
     "launches": {"flash_attention": 32}, "ids_row0": [1, 2, 3]},
]


def _write(path, lines, tail="not json"):
    path.write_text("\n".join([json.dumps(d) for d in lines] + [tail]))
    return str(path)


def test_gap_readings_leave_out_times_ratios_and_flags():
    got = sc.gap_readings(LINES)
    assert [(k, v) for _, _, k, v in got] == [
        ("gap", 4.37e-3), ("gap", 0.0527), ("twin_gap", 0.0527),
        ("gaps", 8.4e-3), ("gaps", 5.3e-4), ("gap_after_2", 1e-4)]


@pytest.mark.parametrize("change, rc", [
    (None, 0),
    (lambda ls: ls[0].update(gap=4.38e-3), 1),
    (lambda ls: ls[1].update(gap_seconds=9.9), 0),       # a time moves
    (lambda ls: ls[4].update(ids_row0=[1, 2, 4]), 1),
])
def test_main_reports_what_moved(tmp_path, capsys, change, rc):
    new = json.loads(json.dumps(LINES))
    if change is not None:
        change(new)
    code = sc.main(_write(tmp_path / "new.log", new),
                   _write(tmp_path / "old.log", LINES))
    out = json.loads(capsys.readouterr().out)
    assert code == rc and out["gap_readings"] == [6, 6]
    assert out["lm_serving_lines"] == [1, 1]
