"""The ``cuda`` scoring round before and after it staged its inputs, step
by step, on the fig4 snapshots that ``chip_smoke.py`` records.

Before: fresh host arrays, two copies from pageable memory, an ``[M, Q]``
tau fill, the checked wrapper and ``.cpu()``, as ``CudaScoringBackend``
ran a round until it held a pinned staging buffer. After: that backend's
pack, upload, launch and fetch (``chip_smoke.staged_round_split``). Both
run on each snapshot in turn, over two passes (the first warms up); the
second pass's means, in us, are printed as one JSON line.

Run from the repository root on a machine with a CUDA card:

    python3 tools/scoring_round_split.py

It builds the kernels and serves the fig4 knee for 3 s as ``chip_smoke.py``
does (its phases 1 and 5), then times the two rounds.
"""

import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke  # noqa: E402


def unstaged_round(w, mask, lat, bat, queue, tau, clip, device):
    """One round (scalar SLO) without held buffers; returns the host-clock
    seconds of each step."""
    import torch

    from repro_torch.kernels.stability_score.ops import stability_scores

    m, q = w.shape
    n, mq = len(queue), w.size
    t0 = time.perf_counter()
    floats = np.empty(2 * mq + n, np.float32)
    floats[:mq] = w.ravel()
    floats[mq:2 * mq] = mask.ravel()
    floats[-n:] = lat
    ints = np.empty(2 * n, np.int32)
    ints[:n] = bat
    ints[n:] = queue
    t1 = time.perf_counter()
    f_dev = torch.from_numpy(floats).to(device)
    i_dev = torch.from_numpy(ints).to(device)
    t2 = time.perf_counter()
    tau_mat = torch.full((m, q), float(np.float32(tau)), dtype=torch.float32,
                         device=device)
    t3 = time.perf_counter()
    out = stability_scores(
        f_dev[:mq].view(m, q), f_dev[mq:2 * mq].view(m, q), f_dev[-n:],
        i_dev[:n], i_dev[n:], tau=tau_mat, clip=float(np.float32(clip)))
    t4 = time.perf_counter()
    out.cpu().numpy()
    t5 = time.perf_counter()
    return dict(pack=t1 - t0, h2d=t2 - t1, tau_fill=t3 - t2, launch=t4 - t3,
                d2h_sync=t5 - t4)


def split_rounds(sched, sample):
    backend, slo, clip = sched.scoring, sched.config.slo, sched.config.clip
    rounds = smoke.fig4_rounds(sched, sample)
    for _ in range(2):  # the first pass warms both up
        staged, unstaged = [], []
        for r in rounds:
            staged.append(smoke.staged_round_split(backend, *r, slo, clip))
            unstaged.append(unstaged_round(*r, slo, clip, backend.device))
    smoke.emit("scoring_round_split", snapshots=len(rounds),
               staged_us=smoke.mean_split_us(staged),
               unstaged_us=smoke.mean_split_us(unstaged))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scoring_round_split: no CUDA device is available",
              file=sys.stderr)
        return 1
    from repro_torch.configs import FULL
    from repro_torch.runtime.server import serve_resnets

    smoke.phase_device_and_build()
    served = serve_resnets(FULL, device="cuda", seed=0, max_batch=10)
    smoke.phase_serving(served, "cuda", scoring_round=split_rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
