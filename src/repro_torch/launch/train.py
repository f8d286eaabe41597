"""Training entry point of the port (reference ``src/repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --smoke --steps 100 --batch 8 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 30 --batch 8 --seq 256 --checkpoint-dir /tmp/ck   # the card

The reference's flags, plus ``--device`` (default: the card). The loop is
the reference's: weights from ``build_model(cfg, generator)`` seeded with
``--seed``, float32 masters (``runtime.trainer.master_values``), the cosine
schedule with 20 warm-up steps, ``pick_optimizer_for``, the synthetic
stream, a log line every ``--log-every`` steps, a checkpoint of
``{"values", "opt"}`` at every ``--checkpoint-every``-th step, at the last
step and on preemption (``PreemptionGuard``: SIGTERM), and ``--resume``
from the latest committed step. One difference: on resume the stream is
advanced past the batches the interrupted run already took (the reference
starts it again at its first batch), so that a resumed run sees the batches
an uninterrupted run would, and ends where it would.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import synthetic_lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import cosine_schedule
from repro_torch.runtime.checkpoint import Checkpointer
from repro_torch.runtime.fault_tolerance import PreemptionGuard
from repro_torch.runtime.trainer import (
    make_train_step,
    master_values,
    pick_optimizer_for,
)

WARMUP = 20


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def train(args: argparse.Namespace,
          guard: Optional[PreemptionGuard] = None,
          on_step: Optional[Callable[[int, dict], None]] = None) -> dict:
    """The training loop of ``args`` (``parser()``'s flags). ``guard``
    defaults to a ``PreemptionGuard`` that installs a SIGTERM handler;
    ``on_step(step, metrics)`` runs after every step, before the checkpoint
    and the guard are looked at. Returns ``{"values", "opt_state",
    "start_step", "end_step", "losses"}`` (end_step: the steps done, the
    next step to run; losses: the float of every logged step's loss)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    values = master_values(model)
    n_params = sum(v.numel() for v in values.values())
    n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"arch={cfg.arch_id} params={n_params/1e6:.1f}M "
          f"exits={cfg.exits} devices={n_devices}", flush=True)

    opt = pick_optimizer_for(cfg, lr=cosine_schedule(args.lr, WARMUP,
                                                      args.steps))
    opt_state = opt.init(values)
    step_fn = make_train_step(model, opt, grad_accum=args.grad_accum)

    ck = None
    start_step = 0
    if args.checkpoint_dir:
        ck = Checkpointer(args.checkpoint_dir)
        if args.resume and ck.latest_step() is not None:
            start_step, state, _ = ck.restore(
                template={"values": values, "opt": opt_state})
            values, opt_state = state["values"], state["opt"]
            print(f"resumed from step {start_step}", flush=True)

    if guard is None:
        guard = PreemptionGuard(install_sigterm=True)
    batches = synthetic_lm_batches(
        vocab=cfg.vocab_size, batch=args.batch, seq=args.seq,
        seed=args.seed, encdec=cfg.family == "encdec",
        d_model=cfg.d_model, src_len=max(cfg.frontend_seq, 8),
        vision=cfg.frontend == "vision", device=device)
    for _ in range(start_step):  # the batches the interrupted run took
        next(batches)

    losses: List[float] = []
    step = start_step - 1
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = next(batches)
        values, opt_state, metrics = step_fn(values, opt_state, batch, step)
        if on_step is not None:
            on_step(step, metrics)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            per_exit = [
                float(metrics[k]) for k in sorted(metrics)
                if k.startswith("nll_exit")
            ]
            dt = (time.time() - t0) / max(step - start_step + 1, 1)
            print(f"step {step:5d} loss={loss:.4f} "
                  f"exits={['%.3f' % e for e in per_exit]} "
                  f"gnorm={float(metrics['grad_norm']):.3f} {dt:.2f}s/step",
                  flush=True)
        if ck and (step % args.checkpoint_every == 0 or
                   step == args.steps - 1 or guard.should_stop()):
            ck.save(step + 1, {"values": values, "opt": opt_state},
                    extra={"loss": float(metrics["loss"])})
        if guard.should_stop():
            print("preemption requested: checkpointed and exiting cleanly",
                  flush=True)
            break
    if ck:
        ck.wait()
    print("done", flush=True)
    return {"values": values, "opt_state": opt_state,
            "start_step": start_step, "end_step": step + 1,
            "losses": losses}


def main(argv: Optional[List[str]] = None) -> None:
    train(parser().parse_args(argv))


if __name__ == "__main__":
    main()
