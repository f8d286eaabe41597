"""Time the training path's two backward kernels of two checkouts on one
card, in turns (A, B, B, A): each turn is a fresh process that builds the
checkout's kernels into its own ``build/kernels/`` and runs that
checkout's ``chip_smoke.run_bwd_cases`` at its ``_train_kernel_cases``
(bfloat16 and float32, each case held against its plain version and run
twice bitwise, then timed by CUDA-graph replay). Prints one JSON line a
(kernel, case) the two checkouts share, with each turn's ``ms``; ``--out``
keeps these and each turn's whole record. Needs a card; imports no JAX.

    git archive HEAD^ | tar -x -C build/parent   # the parent, say
    python tools/bwd_kernel_ab.py --a build/parent --b . --out build/ab.jsonl
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TURN = r"""
import json, sys, time
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.kernels import build
build.build(list(cs.BWD_KERNELS))
torch.backends.cuda.matmul.allow_tf32 = False
configs = {a: get_config(a) for a in cs.LM_ARCHS}
gen = torch.Generator(device="cuda").manual_seed(13)
t0 = time.perf_counter()
errs, timings = cs.run_bwd_cases(cs._train_kernel_cases(configs),
                                 torch.device("cuda"), gen)
print(json.dumps({"root": root, "card": cs.smi("name,power.limit"),
                  "seconds": time.perf_counter() - t0, "errs": errs,
                  "timings": timings}))
"""


def turn(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", TURN, root],
                         capture_output=True, text=True, check=False)
    if out.returncode != 0:
        raise SystemExit(f"turn on {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="the first checkout's root")
    ap.add_argument("--b", required=True, help="the second checkout's root")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    roots = [str(Path(r).resolve()) for r in (args.a, args.b)]
    turns = [turn(r) for r in (roots[0], roots[1], roots[1], roots[0])]
    lines = [json.dumps(t) for t in turns]
    names = ("a", "b", "b", "a")
    shared = {}
    for name, t in zip(names, turns):
        for kernel, cases in t["timings"].items():
            for label, row in cases.items():
                shared.setdefault((kernel, label), {}).setdefault(
                    name, []).append(row["ms"])
    for (kernel, label), ms in shared.items():
        if len(ms) == 2:
            lines.append(json.dumps({"kernel": kernel, "case": label,
                                     "a_ms": ms["a"], "b_ms": ms["b"],
                                     "card": turns[0]["card"]}))
    for line in lines[len(turns):]:
        print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
