"""A configuration's deployment, made from the seed: the weights, the
prompt pools and the port's served models.

Weights are drawn on the device by the benchmark, in the type they are
served in, in a few large calls: one flat buffer per model filled from a
``torch.Generator`` on the device, then cut into each parameter's shape
(shapes from the port's ``models/common.py::abstract_params`` on
``meta``) and scaled by its fan-in (norm gains are ones). Every tensor
starts on 512 bytes, as an allocation of its own would, so that the
kernels take the paths they take on any weights. The port gets them
through ``models/common.py::set_params``; the reference reads the same
tensors.

Each model has a pool of prompts (and frame embeddings for the
encoder-decoder) drawn on the device; its ``data_fn`` hands each quantum
the next B of them, so served rows differ from quantum to quantum. Its
``forward_fn`` is the port's ``exit_decision``, wrapped so that the
window's outputs are kept with the rows they answer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import build_model
from repro_torch.models.common import abstract_params, set_params
from repro_torch.models.transformer import LMConfig
from repro_torch.runtime.server import ServedModel

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ALIGN = 512        # bytes: where every parameter starts
CHUNK = 1 << 28    # elements a draw


def derive_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one purpose of run ``seed``."""
    state = np.random.SeedSequence([seed % (1 << 64), *tags])
    lo, hi = state.generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def lm_config(lm: dict) -> LMConfig:
    fields = dict(lm)
    fields["dtype"] = DTYPES[fields["dtype"]]
    fields["exits"] = tuple(fields["exits"])
    return LMConfig(**fields)


def draw_weights(cfg: LMConfig, gen: torch.Generator,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``cfg``'s model, by state-dict path."""
    shapes, _ = abstract_params(lambda dev: build_model(cfg, device=dev))
    el = torch.tensor([], dtype=cfg.dtype).element_size()
    step = ALIGN // el
    offsets, total = {}, 0
    for name, meta in shapes.items():
        offsets[name] = total
        total += -(-meta.numel() // step) * step
    flat = torch.empty(total, dtype=cfg.dtype, device=device)
    for a in range(0, total, CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen)
    weights = {}
    for name, meta in shapes.items():
        w = flat[offsets[name]:offsets[name] + meta.numel()].view(meta.shape)
        if w.ndim == 1:
            w.fill_(1.0)
        else:
            fan_in = w.shape[-1] if name == "embed" else w.shape[0]
            w.mul_(1.0 / math.sqrt(fan_in))
        weights[name] = w
    return weights


class PromptPool:
    """``n`` prompts of ``prompt_len`` tokens (and ``frontend_seq`` frame
    embeddings for the encoder-decoder), handed out B at a time in turn."""

    def __init__(self, cfg: LMConfig, n: int, prompt_len: int,
                 gen: torch.Generator, device: torch.device):
        self.n = n
        self.tokens = torch.randint(0, cfg.vocab_size, (n, prompt_len),
                                    generator=gen, device=device)
        self.src = None
        if cfg.family == "encdec":
            self.src = torch.randn((n, cfg.frontend_seq, cfg.d_model),
                                   generator=gen, device=device,
                                   dtype=cfg.dtype)
        self.cursor = 0
        self.last = (0, 0)

    def rows(self, start: int, b: int) -> dict:
        batch = {"tokens": self.tokens[start:start + b]}
        if self.src is not None:
            batch["src_embeds"] = self.src[start:start + b]
        return batch

    def next(self, b: int) -> dict:
        if self.cursor + b > self.n:
            self.cursor = 0
        start, self.cursor = self.cursor, self.cursor + b
        self.last = (start, b)
        return self.rows(start, b)


@dataclasses.dataclass
class Quantum:
    """One served quantum of the window: model, exit, the pool rows it
    answered and the port's (token, max logit, logsumexp)."""

    model: int
    exit_idx: int
    start: int
    batch: int
    out: tuple


class Recorder:
    """What the window produced, kept while ``on``; ``fault`` (tests only)
    alters a quantum's outputs where they are produced."""

    def __init__(self):
        self.on = False
        self.quanta: List[Quantum] = []
        self.fault: Optional[Callable] = None


@dataclasses.dataclass
class Deployment:
    lms: List[dict]              # each model's configuration, as in the file
    weights: List[Dict[str, torch.Tensor]]
    pools: List[PromptPool]
    served: List[ServedModel]
    recorder: Recorder


def build(config: dict, seed: int, device: torch.device) -> Deployment:
    """The configuration's models from ``seed``: weights, pools and the
    port's served models, in the file's order."""
    rec = Recorder()
    lms, weights, pools, served = [], [], [], []
    for m, spec in enumerate(config["models"]):
        cfg = lm_config(spec["lm"])
        gen = torch.Generator(device=device)
        gen.manual_seed(derive_seed(seed, 1, m))
        w = draw_weights(cfg, gen, device)
        gen.manual_seed(derive_seed(seed, 2, m))
        pool = PromptPool(cfg, config["pool"], config["prompt_len"], gen,
                          device)
        model = build_model(cfg, device="meta")
        set_params(model, w)
        model.eval()
        served.append(ServedModel(
            name=spec["name"], values=model,
            forward_fn=_forward(m, pool, rec), data_fn=pool.next,
            num_exits=cfg.num_exits))
        lms.append(spec["lm"])
        weights.append(w)
        pools.append(pool)
    return Deployment(lms, weights, pools, served, rec)


def _forward(m: int, pool: PromptPool, rec: Recorder):
    def forward(model, batch, exit_idx):
        out = model.exit_decision(batch, exit_idx)
        if rec.fault is not None:
            out = rec.fault(m, exit_idx, out)
        if rec.on:
            rec.quanta.append(Quantum(m, exit_idx, *pool.last, out))
        return out
    return forward
