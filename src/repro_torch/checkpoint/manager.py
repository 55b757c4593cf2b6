"""Checkpointing: tree save/restore with an async writer, on torch.

Mirrors ``repro/checkpoint/manager.py``.  Each checkpoint is a directory
``step_XXXXXXXX`` of npz groups (one per top-level state key) beside a
``manifest.json`` (step, time, groups, extra keys), published with an
atomic rename; the newest ``keep`` are kept.  Leaves are tensors, numpy
arrays or scalars; a bfloat16 tensor is stored as its uint16 bits under a
``::bf16`` tag, since numpy has no bfloat16.

The async writer moves the write off the training thread; the snapshot to
host memory is taken on the caller's thread, so training may go on
mutating its tensors.  ``wait()`` joins before the next save.

``restore`` returns torch tensors on ``device`` (the CPU by default).  The
reference's ``shardings`` (a restore onto a mesh) has no counterpart until
the port has a mesh (ROADMAP.md list 1b item 7), and is refused.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

_BF16_TAG = "::bf16"   # numpy can't store bfloat16; persist as uint16 views


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    key = prefix.rstrip("/")
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            out[key + _BF16_TAG] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[key] = t.numpy().copy()
    else:
        out[key] = np.array(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray], device) -> Any:
    tree: dict[str, Any] = {}
    for key, val in flat.items():
        if key.endswith(_BF16_TAG):
            key = key[: -len(_BF16_TAG)]
            t = torch.from_numpy(val.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(val))
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.to(device)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ---------------- save ----------------

    def save(self, step: int, state: dict[str, Any],
             extra: dict | None = None) -> None:
        """state: {'params': tree, 'opt_state': tree, ...}."""
        self.wait()
        flat = {name: _flatten(tree, f"{name}/")
                for name, tree in state.items()}

        def write():
            path = os.path.join(self.directory, f"step_{step:08d}")
            tmp = path + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            for name, group in flat.items():
                np.savez(os.path.join(tmp, f"{name}.npz"), **group)
            manifest = {"step": step, "time": time.time(),
                        "groups": sorted(flat), **(extra or {})}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=2)
            os.replace(tmp, path)      # atomic publish
            self._gc()

        if self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------- restore ----------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None,
                shardings: dict[str, Any] | None = None,
                device: str | torch.device = "cpu") -> dict[str, Any]:
        """Returns {'step': int, group_name: tree of tensors on device}."""
        if shardings:
            raise NotImplementedError(
                "restore(shardings=...) places leaves on a device mesh, which "
                "the port does not have yet: ROADMAP.md list 1b item 7")
        if step is None:
            step = self.latest_step()
        assert step is not None, f"no checkpoints in {self.directory}"
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        out: dict[str, Any] = {"step": manifest["step"]}
        for name in manifest["groups"]:
            with np.load(os.path.join(path, f"{name}.npz")) as z:
                flat = {k: z[k] for k in z.files}
            out[name] = _unflatten(flat, device)[name]
        return out
