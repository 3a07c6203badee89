"""The winding-number kernel's inner loop in SASS, and its time at one
training item's shape.

    python surs_tpu_torch/probes/winding_sass.py [--root DIR] [--listing PATH]

builds ``surs_tpu_torch/csrc/winding_number.cu`` of the checkout at DIR
(default: this one) with the port's build (``ops/cuda_build.py``), reads
``winding_number_kernel``'s SASS with ``cuobjdump -sass`` and finds its
inner loop: of the innermost backward branches whose body holds the
special function unit's instructions (MUFU), the one with the most. It
counts the instructions one iteration issues on its common path (a
branch over a call to an IEEE slow path is taken) and the pairs an
iteration handles (three square roots a pair), so their quotient is the
instructions a point-triangle pair issues. From that count, the least
time at full issue: 132 SMs x 4 warp instructions a clock, 32 pairs a
warp instruction, at the card's maximum SM clock and at the clock
nvidia-smi reads while the kernel runs. Then the kernel is timed (CUDA
events, median of 5 after 2 warm-ups) at 25,500 seeded points against
327,680 and 20,480 seeded triangles, the training item's HR and LR sizes
(the time does not depend on the coordinates: no loop ends early), with
ptxas' registers and spills where this run built the library. Prints
one JSON line beside the card's name and power limit; ``--listing``
writes the loop's SASS to a file. Run it as a file, as ``--root``
imports that checkout's package; ``chip_smoke.py``'s phase
``containment`` takes :func:`sass_loop` from here. Needs a CUDA device
and the CUDA toolkit's ``cuobjdump``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from typing import Optional

import numpy as np

KERNEL = "winding_number_kernel"
POINTS, TRIS = 25_500, (327_680, 20_480)
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def cuobjdump() -> Optional[str]:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "cuobjdump"),
                 "/usr/local/cuda/bin/cuobjdump",
                 shutil.which("cuobjdump") or ""):
        if cand and os.path.isfile(cand):
            return cand
    return None


def function_sass(sass: str, kernel: str = KERNEL):
    """[(address, predicated, opcode, operands)] of the function
    ``kernel``."""
    out, inside = [], False
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            # an extern "C" name, or a mangled one (length-prefixed)
            name = m.group(1)
            inside = name == kernel or f"{len(kernel)}{kernel}" in name
            continue
        if inside:
            m = _INSN.search(ln)
            if m:
                out.append((int(m.group(1), 16), bool(m.group(2)),
                            m.group(3), m.group(4).strip()))
    return out


def _common_path(body):
    """The instructions one iteration of the loop ``body`` issues on its
    common path: a predicated forward branch is taken where it jumps over
    a call (a slow path: IEEE square roots and divisions call theirs),
    else it falls through; predicated instructions issue either way."""
    at = {a: i for i, (a, *_) in enumerate(body)}
    path, i = [], 0
    while i < len(body) and len(path) <= 4 * len(body):
        addr, pred, op, args = body[i]
        path.append(body[i])
        if op.startswith("BRA") and i < len(body) - 1:
            tgt = at.get(int(_TARGET.search(args).group(1), 16))
            if tgt is None:
                raise ValueError(f"branch out of the loop at {addr:x}")
            nxt = next((o for _, _, o, _ in body[i + 1:]
                        if o.startswith(("BRA", "CALL", "EXIT"))), "")
            if not pred or nxt.startswith("CALL"):
                i = tgt
                continue
        i += 1
    return path


def sass_loop(sass: str, kernel: str = KERNEL) -> dict:
    """The inner loop of ``kernel`` in ``sass`` (cuobjdump -sass text):
    the instructions of its body and of its common path (NOPs left out),
    pairs an iteration (three square roots a pair: MUFU.RSQ in an IEEE
    square root, MUFU.SQRT in an approximate one), instructions a pair on
    the common path, its opcode histogram and the body's listing;
    {"error": ...} when no loop is found."""
    insns = [x for x in function_sass(sass, kernel)
             if not x[2].startswith("NOP")]
    if not insns:
        return {"error": f"no function {kernel} in the SASS"}
    at = {a: i for i, (a, *_) in enumerate(insns)}
    loops = []
    for i, (addr, _, op, args) in enumerate(insns):
        m = _TARGET.search(args)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            lo = at.get(int(m.group(1), 16))
            if lo is not None:
                n_mufu = sum(o.startswith("MUFU")
                             for _, _, o, _ in insns[lo:i + 1])
                if n_mufu:
                    loops.append((lo, i, n_mufu))
    # the innermost loops (around no other loop with MUFU), and of those
    # the one with the most MUFU: the unrolled main loop, not its
    # remainder, nor the tile loop around both
    inner = [(lo, hi, n) for lo, hi, n in loops
             if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                        for a, b, _ in loops)]
    if not inner:
        return {"error": f"no loop with MUFU in {kernel}"}
    lo, hi, _ = max(inner, key=lambda x: (x[2], x[0] - x[1]))
    body = insns[lo:hi + 1]
    path = _common_path(body)
    roots = sum(op in ("MUFU.RSQ", "MUFU.SQRT") for _, _, op, _ in path)
    if roots == 0 or roots % 3:
        return {"error": f"{roots} square roots on the loop's path"}
    pairs = roots // 3
    return {"kernel": kernel, "body_instructions": len(body),
            "path_instructions": len(path), "pairs_per_iteration": pairs,
            "per_pair": len(path) / pairs,
            "mufu": dict(Counter(op for _, _, op, _ in path
                                 if op.startswith("MUFU"))),
            "histogram": dict(Counter(op.split(".")[0]
                                      for _, _, op, _ in path
                                      ).most_common()),
            "listing": [f"{a:05x} {'@ ' if p else ''}{op} {args}"
                        for a, p, op, args in body]}


def library_sass(lib_path) -> str:
    tool = cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump not found: it comes with the CUDA "
                           "toolkit")
    return subprocess.run([tool, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def issue_ms(per_pair: float, pairs: float, sms: int,
             clock_mhz: float) -> float:
    """Milliseconds at full issue: ``pairs`` x ``per_pair`` instructions,
    32 pairs a warp instruction, 4 warp instructions a clock an SM."""
    return per_pair * pairs / 32 / (sms * 4 * clock_mhz * 1e6) * 1e3


def sm_clock_under_load(fn, launches: int = 60) -> list:
    """SM clock samples (MHz; nvidia-smi every 50 ms for half a second)
    taken while the card works through ``launches`` calls of ``fn``,
    enqueued before the sampler starts."""
    import torch
    for _ in range(launches):
        fn()
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    time.sleep(0.5)
    proc.terminate()
    out = proc.communicate(timeout=30)[0]
    torch.cuda.synchronize()
    return [float(x) for x in out.split()]


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--listing", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from surs_tpu_torch.ops import containment, cuda_build
    if not os.path.abspath(containment.__file__).startswith(root + os.sep):
        raise RuntimeError(f"surs_tpu_torch imported from outside {root}: "
                           "run this file as a script")
    if not torch.cuda.is_available():
        print("winding_sass: no CUDA device", file=sys.stderr)
        return 1
    lib = cuda_build.build(["winding_number"])["winding_number"]
    loop = sass_loop(library_sass(lib))
    # ptxas' report of the kernel where this call built it
    log = cuda_build.BUILD_LOG.get("winding_number", (0.0, ""))[1]
    m = re.search(KERNEL + r".*?(\d+) bytes spill stores.*?Used (\d+) "
                  r"registers", log, re.S)
    loop["registers"] = int(m.group(2)) if m else None
    loop["spill_stores"] = int(m.group(1)) if m else None
    listing = loop.pop("listing", None)
    if args.listing and listing:
        with open(args.listing, "w") as f:
            f.write("\n".join(listing) + "\n")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    pts = torch.from_numpy(rng.uniform(-1, 1, (POINTS, 3)).astype(
        np.float32)).to(dev)
    rec = {"probe": "winding_sass", "root": root, "sass": loop,
           "card": _smi("name,power.limit"),
           "clock_max_mhz": float(_smi("clocks.max.sm").split()[0])}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    total = 0.0
    for n in TRIS:
        tris = torch.from_numpy(rng.normal(0, 1, (n, 3, 3)).astype(
            np.float32)).to(dev)
        for _ in range(2):
            containment.winding_number(pts, tris)
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            containment.winding_number(pts, tris)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        rec[f"ms_{n}"] = float(np.median(times))
        total += rec[f"ms_{n}"]
        if n == TRIS[0]:
            rec["clock_load_mhz"] = sm_clock_under_load(
                lambda: containment.winding_number(pts, tris))
    rec["ms_item"] = total
    if "per_pair" in loop:
        for name, clock in (("", rec["clock_max_mhz"]),
                            ("_load_clock", float(np.median(
                                rec["clock_load_mhz"] or [np.nan])))):
            rec[f"issue_ms_item{name}"] = issue_ms(
                loop["per_pair"], POINTS * sum(TRIS), sms, clock)
            rec[f"issue_share{name}"] = rec[f"issue_ms_item{name}"] / total
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
