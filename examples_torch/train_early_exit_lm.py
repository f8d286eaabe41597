"""End-to-end training example of the port: joint early-exit LM training
with checkpoint/restart (reference ``examples/train_early_exit_lm.py``).
Defaults to a CPU-sized model; ``--full`` trains the real smollm-135m
config (the ~100M-class model), same code path. The run is on the card
unless ``--device cpu`` is given.

  PYTHONPATH=src python examples_torch/train_early_exit_lm.py --steps 200 \
      --device cpu
  PYTHONPATH=src python examples_torch/train_early_exit_lm.py --full --steps 300
"""

import argparse
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="train the full smollm-135m config")
    ap.add_argument("--checkpoint-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    cmd = [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", "smollm-135m",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "64",
        "--checkpoint-dir", args.checkpoint_dir,
        "--checkpoint-every", "50",
    ]
    if not args.full:
        cmd.append("--smoke")
    if args.device is not None:
        cmd += ["--device", args.device]
    print("+", " ".join(cmd))
    raise SystemExit(subprocess.call(cmd))


if __name__ == "__main__":
    main()
