"""Fault-tolerance walkthrough of the port (reference
``examples/elastic_failover.py``): checkpoint -> simulated preemption ->
elastic restore. Trains a tiny early-exit LM, checkpoints asynchronously,
"kills" the run mid-flight, rebuilds the device mesh with
``ElasticMesh.build``, then restores from the last committed step and
verifies training continues bit-exactly from the checkpoint. The run is on
the card unless ``--device cpu`` is given.

  PYTHONPATH=src python examples_torch/elastic_failover.py --device cpu
"""

import argparse
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data import synthetic_memorization_corpus
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import release_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.runtime.checkpoint import Checkpointer
from repro_torch.runtime.fault_tolerance import ElasticMesh, PreemptionGuard
from repro_torch.runtime.trainer import make_train_step, master_values


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("smollm-135m", smoke=True)
    gen = torch.Generator(device=device).manual_seed(0)
    model = build_model(cfg, generator=gen, device=device)
    values = master_values(model)
    opt = AdamW(lr=3e-3, weight_decay=0.0)
    opt_state = opt.init(values)
    step_fn = make_train_step(model, opt)
    batch = synthetic_memorization_corpus(cfg.vocab_size, device=device)

    with tempfile.TemporaryDirectory() as root:
        ck = Checkpointer(root, keep=2)
        guard = PreemptionGuard()

        print("== phase 1: train 30 steps, checkpoint every 10 ==")
        losses = []
        for step in range(30):
            values, opt_state, metrics = step_fn(values, opt_state, batch,
                                                 step)
            losses.append(float(metrics["loss"]))
            if (step + 1) % 10 == 0:
                ck.save(step + 1, {"values": values, "opt": opt_state})
            if step == 24:
                guard.request_stop()  # preemption notice arrives
            if guard.should_stop():
                ck.save(step + 1, {"values": values, "opt": opt_state})
                print(f"preempted at step {step + 1}: drained + checkpointed "
                      f"(loss {losses[-1]:.4f})")
                break
        ck.wait()

        print(f"committed checkpoints: {ck.committed_steps()}")

        print("== phase 2: elastic restart ==")
        em = ElasticMesh(model_axis=1)
        mesh, accum = em.build(device=device)
        print(f"rebuilt mesh over {mesh.size()} device(s), "
              f"grad-accum multiplier {accum}")
        step0, state, _ = ck.restore(
            template={"values": values, "opt": opt_state})
        values2, opt2 = state["values"], state["opt"]
        print(f"restored step {step0}")

        # continue; the restored run must match an uninterrupted one
        v_a, o_a = values, opt_state
        v_b, o_b = values2, opt2
        for step in range(step0, step0 + 5):
            v_a, o_a, m_a = step_fn(v_a, o_a, batch, step)
            v_b, o_b, m_b = step_fn(v_b, o_b, batch, step)
        diff = max(float((v_a[k] - v_b[k]).abs().max()) for k in v_a)
        print(f"post-restore divergence vs uninterrupted run: {diff:.2e}")
        assert diff < 1e-6
        print("restart is bit-faithful: OK")
    release_mesh()


if __name__ == "__main__":
    main()
