"""Asynchronous, atomic checkpointing of the port (reference
``src/repro/runtime/checkpoint.py``), with the reference's layout:

    <root>/step_000000123/
        manifest.json        # key paths, shapes, dtypes, step, extra
        leaf_00000.npy ...   # one file per leaf (the full array)
    <root>/step_000000123.COMMITTED   # atomic commit marker (written last)

* **atomic commit**: a step is written under ``step_....tmp``, renamed, and
  only then marked committed; readers consume committed steps only, so a
  preempted writer never corrupts the restore path;
* **async save**: ``save`` copies every leaf to host numpy before it
  returns and hands the writing to a worker thread; ``wait`` blocks until
  the queue is written and raises the worker's error;
* ``keep`` committed steps are kept, older ones removed.

A tree is a nested dict of tensors (or numpy arrays). Its leaves are
flattened in sorted-key order at every level, as ``jax.tree.flatten`` orders
a dict, so the reference and the port write the same ``leaf_%05d.npy`` files
for the same tree; the manifest keeps the reference's fields, with
``treedef`` the list of the leaves' key paths in place of the reference's
serialized JAX tree structure. numpy has no bfloat16, so a bfloat16 leaf is
stored as its uint16 bits, with ``"bfloat16"`` in ``dtypes``, and restored
from them. ``timestamp=None`` leaves ``time`` out of the manifest, so
identical trees give byte-identical directories.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]

_COMMIT_SUFFIX = ".COMMITTED"


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:09d}")


def flatten(tree: Tree, prefix: Tuple[str, ...] = ()
            ) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(key path, leaf)] of a nested dict, keys sorted at every level."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.extend(flatten(value, prefix + (key,)))
        else:
            out.append((prefix + (key,), value))
    return out


def _unflatten(pairs) -> Tree:
    tree: Tree = {}
    for path, leaf in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(a host copy as numpy, its dtype's name); bfloat16 as uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.array(leaf, copy=True)
    return np.ascontiguousarray(a), str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class Checkpointer:
    def __init__(self, root: str, keep: int = 3, async_save: bool = True):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        os.makedirs(root, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        if async_save:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # -- write path ---------------------------------------------------------

    def save(self, step: int, tree: Tree, extra: Optional[dict] = None,
             timestamp: Optional[float] = None):
        """Snapshot to host numpy, then persist (on the worker thread when
        ``async_save``). Returns after the snapshot: the caller may change
        or free the tensors at once.

        ``timestamp`` is caller-injected wall time for the manifest's
        ``time`` field; the default ``None`` omits the field, so identical
        trees give byte-identical checkpoints."""
        host = [(path, *_to_host(leaf)) for path, leaf in flatten(tree)]
        if self.async_save:
            self._q.put((step, host, extra or {}, timestamp))
        else:
            self._write(step, host, extra or {}, timestamp)

    def wait(self):
        """Block until all queued saves are durable (tests / shutdown);
        raise the worker's error, if it had one."""
        self._q.join()
        if self._last_error:
            raise self._last_error

    def _drain(self):
        while True:
            step, host, extra, timestamp = self._q.get()
            try:
                self._write(step, host, extra, timestamp)
            except BaseException as e:  # surfaced on wait()
                self._last_error = e
            finally:
                self._q.task_done()

    def _write(self, step: int, host, extra: dict,
               timestamp: Optional[float] = None):
        d = _step_dir(self.root, step)
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "treedef": [list(path) for path, _, _ in host],
            "num_leaves": len(host),
            "shapes": [list(a.shape) for _, a, _ in host],
            "dtypes": [dtype for _, _, dtype in host],
            "extra": extra,
        }
        if timestamp is not None:
            manifest["time"] = float(timestamp)
        for i, (_, a, _) in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), a,
                    allow_pickle=False)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        with open(d + _COMMIT_SUFFIX, "w") as f:
            f.write(str(step))
        self._gc()

    def _gc(self):
        steps = self.committed_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(_step_dir(self.root, s), ignore_errors=True)
            try:
                os.remove(_step_dir(self.root, s) + _COMMIT_SUFFIX)
            except FileNotFoundError:
                pass

    # -- read path -----------------------------------------------------------

    def committed_steps(self) -> "list[int]":
        out = []
        for name in os.listdir(self.root):
            if name.endswith(_COMMIT_SUFFIX):
                out.append(int(name[len("step_"):-len(_COMMIT_SUFFIX)]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, template: Tree = None
                ) -> "tuple[int, Tree, dict]":
        """Load a committed checkpoint.

        Args:
          step: specific step (default: latest committed).
          template: optional nested dict with the expected structure; its
            key paths must be the checkpoint's, and each leaf comes back on
            the device of the template's tensor leaf (else on the CPU). A
            checkpoint the reference wrote (its ``treedef`` a serialized
            JAX structure) needs one, as the reference's restore does.
        Returns (step, tree of tensors, extra).
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoints under {self.root}")
        d = _step_dir(self.root, step)
        if not os.path.exists(d + _COMMIT_SUFFIX):
            raise FileNotFoundError(f"checkpoint step {step} not committed")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        treedef = manifest["treedef"]
        if isinstance(treedef, str):  # the reference's serialized structure
            if template is None:
                raise ValueError("restoring the reference's checkpoint "
                                 "requires a template")
            paths = [p for p, _ in flatten(template)]
        else:
            paths = [tuple(p) for p in treedef]
        leaves = [
            _from_host(np.load(os.path.join(d, f"leaf_{i:05d}.npy")), dtype)
            for i, dtype in zip(range(manifest["num_leaves"]),
                                manifest["dtypes"])
        ]
        if template is not None:
            expect = flatten(template)
            if [p for p, _ in expect] != paths:
                raise ValueError(
                    f"checkpoint step {step} holds {len(paths)} leaves whose "
                    f"key paths differ from the template's {len(expect)}")
            leaves = [leaf.to(t.device) if isinstance(t, torch.Tensor)
                      else leaf for leaf, (_, t) in zip(leaves, expect)]
        return step, _unflatten(zip(paths, leaves)), manifest.get("extra", {})
