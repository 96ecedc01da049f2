"""Counts the SASS instructions of tune's sweep kernel's rollout loop in a
``cuobjdump -sass`` listing of the port's library (run manually; prints
one JSON line). PERF.md §6 keeps the counts and what they say.

    cuobjdump -sass mpc_rs_tpu_torch/_build/<library>.so > sweep.sass   # on the card's machine
    python tests/sweep_sass_count.py sweep.sass

The loop is found by its shape in the compiler's output (``inner_loop_sass``),
so a later compiler or kernel may need the walk adjusted: read the listing
beside its result.
"""

from __future__ import annotations

import json
import re
import sys
from collections import Counter
from pathlib import Path

# mppi_sweep_kernel(CartPoleNonlinearT<false>, SweepArgs): one kernel, not a template
SWEEP_RE = re.compile(r"mpc17mppi_sweep_kernelE")
SASS_PRED_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);")
PHILOX_M0 = ("0xd2511f53", "-0x2daee0ad")  # Philox's first multiplier, unsigned or signed


def sass_class(op: str) -> str:
    """The issue class of a SASS opcode: the FP32 pipe, the special function
    unit (MUFU), integer, shared or global memory, shuffles and barriers,
    or control."""
    if op.startswith(("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK", "FSET")):
        return "fp32"
    if op.startswith("MUFU"):
        return "mufu"
    if op.startswith(("LDS", "STS")):
        return "shared"
    if op.startswith(("LDG", "STG", "LD.", "ST.", "LDL", "STL", "ATOM", "RED")):
        return "memory"
    if op.startswith(("SHFL", "BAR", "MEMBAR", "FENCE")):
        return "sync"
    if op.startswith(("BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL", "WARPSYNC", "NOP", "BPT")):
        return "control"
    return "integer"


def _skips_a_slow_path(body: list[tuple]) -> bool:
    """Whether a forward branch over ``body`` skips a slow path: the range
    holds the sincosf reduction's table loads (LDG.E.CONSTANT) or a
    division's or sqrtf's call, and no special-function unit instruction
    and no shared memory access (which the guarded steps and the second
    box-muller pair hold)."""
    ops = [op for _, _, op, _ in body]
    return (any(o.startswith(("LDG.E.CONSTANT", "CALL")) for o in ops)
            and not any(o.startswith(("MUFU", "LDS", "STS")) for o in ops))


def inner_loop_sass(sass: str) -> dict:
    """The sweep kernel's rollout loop in ``cuobjdump -sass`` text: the
    smallest loop (a backward branch's target to the branch) that holds
    Philox's first multiplier and no barrier, one iteration a Philox call,
    four rollout-steps. Its static count, and the instructions a full call
    of box-muller noise issues on its fast path: walked from the loop head
    to the back edge, taking the branch past the external noise's loads and
    past each slow path (``_skips_a_slow_path``: sincosf's large-argument
    reduction, the divisions' and sqrtf's special cases, which the states
    of a rollout do not reach) and falling through the others. The path is
    split at its first shared load (u_n[t] of the first step) into the
    sampling (the Philox call, two box-muller pairs) and the four steps,
    each counted by issue class."""
    func = next((f for f in sass.split("Function : ")[1:] if SWEEP_RE.search(f.split()[0])), None)
    if func is None:
        return {}
    ins = [(int(a, 16), bool(p), op, rest) for a, p, op, rest in SASS_PRED_LINE.findall(func)]
    index = {a: i for i, (a, _, _, _) in enumerate(ins)}

    def target(i):
        m = re.search(r"0x([0-9a-f]+)", ins[i][3])
        return index.get(int(m.group(1), 16)) if m else None

    loops = []
    for i, (_, _, op, _) in enumerate(ins):
        j = target(i) if op.startswith("BRA") else None
        if j is not None and j < i:
            body = ins[j:i + 1]
            if (not any(o.startswith("BAR") for _, _, o, _ in body)
                    and any(c in r for _, _, _, r in body for c in PHILOX_M0)):
                loops.append((i - j + 1, j, i))
    if not loops:
        return {}
    size, head, back = min(loops)
    path, i = [], head
    while head <= i <= back:
        path.append(ins[i])
        _, pred, op, _ = ins[i]
        j = target(i) if op.startswith("BRA") else None
        if i == back or j is None:
            i += 1
        elif not pred:
            i = j
        elif j > i and (_skips_a_slow_path(ins[i + 1:j])
                        or any(o == "LDG.E" for _, _, o, _ in ins[i + 1:j])):  # past the external noise's loads
            i = j
        else:
            i += 1
    first_lds = next(k for k, (_, _, op, _) in enumerate(path) if op.startswith("LDS"))

    def classes(part):
        return dict(Counter(sass_class(op) for _, _, op, _ in part))

    sampling, steps = path[:first_lds], path[first_lds:]
    return {"loop_instructions": size, "path_instructions": len(path), "path_per_rollout_step": len(path) / 4,
            "sampling": len(sampling), "sampling_by_class": classes(sampling),
            "steps": len(steps), "steps_by_class": classes(steps),
            "steps_mufu": dict(Counter(op for _, _, op, _ in steps if op.startswith("MUFU"))),
            "steps_fchk": sum(op.startswith("FCHK") for _, _, op, _ in steps),
            "sampling_mufu": dict(Counter(op for _, _, op, _ in sampling if op.startswith("MUFU")))}


if __name__ == "__main__":
    print(json.dumps(inner_loop_sass(Path(sys.argv[1]).read_text())))
