"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

At first use every source registered in `contracts.KERNEL_CONTRACTS` is
compiled by its own `nvcc` process, all started together, into a shared
library with a plain C interface under ``build/repro_torch_kernels/``
at the root of the checkout (``$REPRO_TORCH_BUILD_DIR`` overrides).
A library's file name carries a hash of its source, the headers beside
it and its flags, so an edited kernel is never served from a stale
build.  A failed build raises with the compiler's output.  Nothing here
runs at import time: the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

from .contracts import KERNEL_CONTRACTS, NVCC_FLAGS

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: per-source compiler output (ptxas register/shared-memory report)
build_log: dict[str, str] = {}


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set $CUDA_HOME): the CUDA "
                           "kernels are compiled at first use")
    return found


def _sources() -> dict[str, tuple[str, ...]]:
    """stem -> extra nvcc flags, for every registered source."""
    out = {}
    for c in KERNEL_CONTRACTS.values():
        out[pathlib.Path(c["source"]).stem] = tuple(c["nvcc_extra"])
    return out


def _lib_path(stem: str, extra: tuple[str, ...]) -> pathlib.Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS + extra).encode())
    return build_dir() / f"lib{stem}-{h.hexdigest()[:12]}.so"


def unbuilt() -> list[str]:
    """The registered sources that have no current build (a process that
    must not compile, such as a rank of a process mesh whose parent
    built the kernels, checks that this is empty)."""
    return [stem for stem, extra in _sources().items()
            if not _lib_path(stem, extra).exists()]


def build_all() -> None:
    """Compile every registered source that has no current build, in
    parallel."""
    todo = {stem: _sources()[stem] for stem in unbuilt()}
    if not todo:
        return
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for stem, extra in todo.items():
        out = _lib_path(stem, extra)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def ptxas_report(log: str) -> list[dict]:
    """One entry per compiled kernel instantiation of an `nvcc -Xptxas -v`
    log: its (demangled) name, registers, spill stores and loads in
    bytes, and ptxas's performance notes and warnings about it (a note
    that names its function goes to that function's entry, wherever in
    the log it stands)."""
    out: dict[str, dict] = {}
    cur = None
    notes = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {
                "function": m.group(1), "registers": None,
                "spill_stores": None, "spill_loads": None, "notes": []})
            continue
        if "warning" in line or "(C7" in line:
            notes.append((line.split(":", 1)[-1].strip(), cur))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    for note, at in notes:
        named = [e for name, e in out.items() if f"'{name}'" in note]
        for e in named or ([at] if at is not None else []):
            e["notes"].append(note)
    entries = list(out.values())
    filt = shutil.which("c++filt")
    if filt and entries:
        names = subprocess.run([filt], input="\n".join(
            e["function"] for e in entries), capture_output=True, text=True)
        if names.returncode == 0:
            for e, n in zip(entries, names.stdout.splitlines()):
                e["function"] = n
    return entries


def sass(stem: str) -> str:
    """The SASS of the built library of `csrc/<stem>.cu` (`cuobjdump
    -sass`, from nvcc's toolkit), building first."""
    lib = _lib_path(stem, _sources()[stem])
    if not lib.exists():
        build_all()
    tool = pathlib.Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout


def load(stem: str) -> ctypes.CDLL:
    """The loaded shared library of `csrc/<stem>.cu`, building first."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_lib_path(stem, _sources()[stem])))
            _libs[stem] = lib
        return lib
