"""Time the kernels' build: each source's ``nvcc`` and the build's wall, for
one or more checkouts in turns, and, with ``--per-horizon``, one ``nvcc`` a
horizon of serve's cart-pole (``ops/csrc/horizons.cuh``), to choose the
split of the ``horizons_*.cu`` sources.

    python mpc_rs_tpu_torch/runtime/profile_build.py --root _cmp/parent --label parent \\
        --root . --label change --turns 2 --per-horizon --out logs/profile_build.jsonl

A turn builds every checkout once, in the order given (the second turn in
the reverse order, so two turns run A, B, B, A): every source of the
checkout's ``ops/build.py`` (``SOURCES``, its flags) compiled by its own
``nvcc``, as many at once and in the order its ``build.build`` runs them
(``compile_width()``; all at once where it has none), then linked, into a
scratch directory (the checkout's ``_build/`` is not touched). For each
source: the wall from its start to its ``nvcc``'s exit, and the CPU seconds
of that ``nvcc`` and its children (user + system, ``os.wait4``), which vary
less than the wall when the sources share the host's cores. With
``--per-horizon`` each N of ``--horizons`` (default 9-40) is compiled alone
from a one-line source that instantiates that horizon, ``--jobs`` at a
time. One JSON line a build and a horizon, with the host's core count and
``nvidia-smi``'s name and power limit. Needs ``nvcc``; imports no torch.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path


def load_build(root: Path, tag: str):
    """The checkout's ``ops/build.py`` as a module of its own name (it imports
    only the standard library), so two checkouts load side by side."""
    path = root / "mpc_rs_tpu_torch" / "ops" / "build.py"
    spec = importlib.util.spec_from_file_location(f"_build_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jobs(jobs: list[tuple[str, list[str]]], log_dir: Path, width: int) -> dict[str, dict]:
    """Run (name, argv) jobs ``width`` at a time; {name: {wall_s, cpu_s, rc}},
    the wall from the job's start to its exit. Each job is reaped here by
    ``os.wait4`` (its rusage), its Popen kept until then so that the
    subprocess module does not reap it first."""
    out, pending, running = {}, list(jobs), {}
    t0 = time.perf_counter()
    while pending or running:
        while pending and len(running) < width:
            name, argv = pending.pop(0)
            with open(log_dir / f"{name}.log", "w") as f:
                proc = subprocess.Popen(argv, stdout=f, stderr=subprocess.STDOUT)
            running[proc.pid] = (name, time.perf_counter(), proc)
        pid, status, ru = os.wait4(-1, 0)
        if pid not in running:
            continue
        name, start, proc = running.pop(pid)
        proc.returncode = os.waitstatus_to_exitcode(status)
        out[name] = {"wall_s": time.perf_counter() - start, "cpu_s": ru.ru_utime + ru.ru_stime,
                     "rc": proc.returncode, "from_start_s": time.perf_counter() - t0}
    return out


def build_once(root: Path, label: str, scratch: Path) -> dict:
    """Every source of the checkout, all at once, then the link."""
    b = load_build(root, label)
    nvcc = b.find_nvcc()
    work = Path(tempfile.mkdtemp(dir=scratch, prefix=f"{label}_"))
    jobs = [(Path(src).stem, [nvcc, *b.NVCC_FLAGS, "-c", "-o", str(work / f"{Path(src).stem}.o"),
                              str(b.CSRC / src)]) for src in b.SOURCES]
    # the checkout's own rule: compile_width() at a time, in SOURCES order,
    # where its build.py has one; else every source at once
    width = b.compile_width() if hasattr(b, "compile_width") else len(jobs)
    t0 = time.perf_counter()
    sources = run_jobs(jobs, work, width)
    compile_s = time.perf_counter() - t0
    failed = {name: (work / f"{name}.log").read_text()[-3000:] for name, r in sources.items() if r["rc"]}
    link_s = None
    if not failed:
        t1 = time.perf_counter()
        proc = subprocess.run([nvcc, *b.NVCC_FLAGS[:2], "-shared", "-o", str(work / "lib.so"),
                               *(str(work / f"{name}.o") for name, _ in jobs)], capture_output=True, text=True)
        link_s = time.perf_counter() - t1
        if proc.returncode:
            failed["link"] = proc.stdout + proc.stderr
    wall = time.perf_counter() - t0
    shutil.rmtree(work, ignore_errors=True)
    return {"kind": "build", "label": label, "root": str(root), "width": width, "sources": sources,
            "compile_wall_s": compile_s,
            "link_s": link_s, "wall_s": wall, "cpu_s": sum(r["cpu_s"] for r in sources.values()),
            "slowest": max(sources, key=lambda s: sources[s]["wall_s"]), "failed": failed}


def per_horizon(root: Path, horizons: list[int], width: int, scratch: Path) -> list[dict]:
    """One nvcc a horizon: a source holding ``MPC_SERVE_HORIZON(N)`` alone."""
    b = load_build(root, "horizons")
    nvcc = b.find_nvcc()
    work = Path(tempfile.mkdtemp(dir=scratch, prefix="horizon_"))
    jobs = []
    for n in horizons:
        src = work / f"n{n}.cu"
        src.write_text(f'#include "{b.CSRC / "horizons.cuh"}"\n\nMPC_SERVE_HORIZON({n})\n')
        jobs.append((f"n{n}", [nvcc, *b.NVCC_FLAGS, "-c", "-o", str(work / f"n{n}.o"), str(src)]))
    res = run_jobs(jobs, work, width)
    rows = [{"kind": "horizon", "n": n, "jobs": width, **res[f"n{n}"]} for n in horizons]
    shutil.rmtree(work, ignore_errors=True)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", type=Path, required=True, help="a checkout (repeat)")
    ap.add_argument("--label", action="append", required=True, help="a label a --root, in order")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--per-horizon", action="store_true")
    ap.add_argument("--horizons", default="9-40", help="first-last")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if len(args.root) != len(args.label):
        raise SystemExit("give one --label a --root")
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "not measured"
    host = {"cpus": os.cpu_count(), "nvidia_smi": smi}
    scratch = Path(tempfile.mkdtemp(prefix="profile_build_"))
    lines = []
    try:
        order = list(zip(args.root, args.label))
        for turn in range(args.turns):
            for root, label in order if turn % 2 == 0 else order[::-1]:
                lines.append({**build_once(root.resolve(), label, scratch), "turn": turn, **host})
                print(json.dumps(lines[-1]), flush=True)
        if args.per_horizon:
            first, last = (int(v) for v in args.horizons.split("-"))
            for row in per_horizon(args.root[-1].resolve(), list(range(first, last + 1)), args.jobs, scratch):
                lines.append({**row, **host})
                print(json.dumps(lines[-1]), flush=True)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(ln) + "\n" for ln in lines))


if __name__ == "__main__":
    main()
