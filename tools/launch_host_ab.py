"""Time the host side of the seven kernels' wrappers of two checkouts on
one card, in turns (A, B, B, A), at the shapes the main paths give them:
SmolLM-135M's decode step at B = 1 (rmsnorm, decode attention, the exit
head), its prompt of 128 (flash attention), its train step of 8 x 256
(the two backward kernels) and a scheduler round over a 90-candidate
lattice (the stability score). Each turn is a fresh process that builds
the checkout's kernels into its own ``build/kernels/``; each wrapper call
is timed alone on the host clock (``perf_counter`` around the call, the
stream synchronised outside it, so the device's work never backs the
queue up), after a warm-up that fills every per-shape cache. Prints one
JSON line a case with each checkout's median microseconds; ``--out``
keeps these and each turn's whole record. Needs a card; imports no JAX.

    git archive HEAD^ | tar -x -C build/parent   # the parent, say
    python tools/launch_host_ab.py --a build/parent --b . --out build/h.jsonl
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TURN = r"""
import json, sys, time
root, calls = sys.argv[1], int(sys.argv[2])
sys.path[:0] = [root, root + "/src"]
import numpy as np
import torch
import chip_smoke as cs
from repro_torch.kernels import build, checks
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.exit_head.ops import exit_head
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd)
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd
from repro_torch.kernels.stability_score.ops import stability_scores
build.build(list(cs.KERNELS) + list(cs.BWD_KERNELS))
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(7)
bf = torch.bfloat16
def r(*shape, dtype=bf):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)
D, H, KH, HD, V = 576, 9, 3, 64, 49152      # SmolLM-135M
cases = {
    "rmsnorm/decode [1, 576]": (rmsnorm, (r(1, D), r(D)), {}),
    "rmsnorm/prompt [128, 576]": (rmsnorm, (r(128, D), r(D)), {}),
    "decode_attention/B1 S160": (decode_attention, (
        r(1, H, HD), r(1, KH, 160, HD), r(1, KH, 160, HD),
        torch.full((1,), 129, dtype=torch.int32, device=dev)), {}),
    "exit_head/decode [1, 576] x 49152": (exit_head, (
        r(1, D), r(D), r(D, V)), {}),
    "flash_attention/prompt B1 S128": (flash_attention, (
        r(1, H, 128, HD), r(1, KH, 128, HD), r(1, KH, 128, HD)), {}),
    "flash_attention_bwd/train B8 S256": (flash_attention_bwd, (
        r(8, H, 256, HD), r(8, KH, 256, HD), r(8, KH, 256, HD),
        r(8, H, 256, HD), r(8, H, 256, HD)), {}),
    "rmsnorm_bwd/train [2048, 576]": (rmsnorm_bwd, (
        r(2048, D), r(D), r(2048, D)), {}),
    "stability_score/round N90 M3 Q64": (stability_scores, (
        torch.rand((3, 64), generator=gen, device=dev) * 0.1,
        torch.ones((3, 64), device=dev),
        torch.rand((90,), generator=gen, device=dev) * 0.02,
        torch.randint(1, 11, (90,), generator=gen, device=dev,
                      dtype=torch.int32),
        torch.randint(0, 3, (90,), generator=gen, device=dev,
                      dtype=torch.int32)), {"tau": 0.05}),
}
def host_us(fn, args, kw):
    per = []
    with torch.no_grad():
        for i in range(calls + 50):
            t = time.perf_counter()
            fn(*args, **kw)
            dt = time.perf_counter() - t
            torch.cuda.synchronize()
            if i >= 50:
                per.append(dt)
    per = np.array(per) * 1e6
    return {"median_us": float(np.median(per)), "mean_us": float(per.mean()),
            "p90_us": float(np.percentile(per, 90))}
out = {name: host_us(*case) for name, case in cases.items()}
if hasattr(checks, "launching"):
    args = dict(t=1, d=D, v=V, dtype=1, aligned=1)
    out["checks.launching/exit_head"] = host_us(
        lambda: checks.launching("exit_head", (("n_sm", 132),
                                               ("per_sm", 1)), **args),
        (), {})
    out["checks.launching/stability_score"] = host_us(
        lambda: checks.launching("stability_score", n=90, m=3, q=64), (), {})
print(json.dumps({"root": root, "card": cs.smi("name,power.limit"),
                  "calls": calls, "torch": torch.__version__,
                  "timings": out}))
"""


def turn(root: str, calls: int) -> dict:
    out = subprocess.run([sys.executable, "-c", TURN, root, str(calls)],
                         capture_output=True, text=True, check=False)
    if out.returncode != 0:
        raise SystemExit(f"turn on {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="the first checkout's root")
    ap.add_argument("--b", required=True, help="the second checkout's root")
    ap.add_argument("--calls", type=int, default=2000,
                    help="timed calls a case and turn")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    roots = [str(Path(r).resolve()) for r in (args.a, args.b)]
    turns = [turn(r, args.calls)
             for r in (roots[0], roots[1], roots[1], roots[0])]
    lines = [json.dumps(t) for t in turns]
    shared = {}
    for name, t in zip(("a", "b", "b", "a"), turns):
        for case, row in t["timings"].items():
            shared.setdefault(case, {}).setdefault(name, []).append(
                row["median_us"])
    for case, us in shared.items():
        lines.append(json.dumps({"case": case, "a_median_us": us.get("a"),
                                 "b_median_us": us.get("b"),
                                 "card": turns[0]["card"]}))
    for line in lines[len(turns):]:
        print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
