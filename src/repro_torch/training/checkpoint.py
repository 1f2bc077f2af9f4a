"""Atomic, async checkpointing in the reference's on-disk layout.

Counterpart of ``repro/training/checkpoint.py``.  One directory per step,
``step_%08d``, written as ``<dir>.tmp`` and renamed into place; one
``.npy`` per leaf, bfloat16 stored as a ``uint16`` view (numpy has no
bfloat16); ``manifest.json`` holding the step and each leaf's name, file,
shape and dtype.  ``CheckpointManager`` saves on a background thread
after copying every leaf to the host, so the train loop waits only for
the copy (and for the previous save, at the next one), and keeps the
``keep`` newest steps.

A tree is a ``TrainState`` (its leaves ``params/<name>``, ``mu/<name>``,
``nu/<name>``, ``count`` and ``step``), a dict of trees, or a leaf: a
tensor (a DTensor too) or a numpy array.  Leaves are stored whole: a
DTensor is gathered first, so a checkpoint holds no trace of the mesh it
was saved from.  Restoring builds a new tree like the given one, each
leaf on the device given (the like leaf's, by default) in the like
leaf's dtype, and where the like leaf is a DTensor, placed on its mesh
with its placements: the counterpart of the reference's
``restore_checkpoint(..., shardings=)``, onto a mesh of any shape.

``convert.read_reference_checkpoint`` reads a directory the reference
wrote, whose leaf names follow its stacked parameter tree.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

# numpy cannot hold bfloat16: such leaves round-trip as a 16-bit view
_EXOTIC = {"bfloat16": np.uint16}


def leaves(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/c": leaf} of a tree, in its own order."""
    if hasattr(tree, "tree"):
        tree = tree.tree()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _rebuild(like, leaves: Dict[str, Any], prefix: str = ""):
    if hasattr(like, "tree"):
        return like.from_tree(_rebuild(like.tree(), leaves, prefix))
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    return leaves[prefix[:-1]]


def _whole(leaf):
    """A DTensor leaf gathered whole; any other leaf as it is."""
    return leaf.full_tensor() if hasattr(leaf, "full_tensor") else leaf


def to_numpy(leaf) -> np.ndarray:
    """A leaf on the host as numpy; bfloat16 as its uint16 view."""
    if isinstance(leaf, np.ndarray):
        return leaf
    t = _whole(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(leaf) -> str:
    if isinstance(leaf, np.ndarray):
        return str(leaf.dtype)
    return str(leaf.dtype).removeprefix("torch.")


def from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored leaf as a CPU tensor of its recorded ``dtype``."""
    if dtype in _EXOTIC:
        return torch.from_numpy(arr.view(np.int16)).view(
            getattr(torch, dtype))
    return torch.from_numpy(arr)


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Atomic synchronous save; returns the final path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for name, leaf in leaves(tree).items():
        dtype = _dtype_name(leaf)
        arr = to_numpy(leaf)
        fname = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"name": name, "file": fname, "shape": list(arr.shape),
             "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def step_path(directory: str, step: Optional[int] = None) -> str:
    """The directory of ``step``, or of the latest one."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return os.path.join(directory, f"step_{step:08d}")


def read_manifest(path: str) -> Dict[str, tuple]:
    """{leaf name: (numpy array, manifest entry)} of one step directory;
    a bfloat16 leaf's array is its uint16 view (``from_numpy``)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return {e["name"]: (np.load(os.path.join(path, e["file"])), e)
            for e in manifest["leaves"]}


def restore_checkpoint(directory: str, like: Any, step: Optional[int] = None,
                       *, device=None) -> Any:
    """A new tree like ``like`` from the checkpoint of ``step`` (default:
    the latest), each leaf on ``device`` (default: the like leaf's)."""
    stored = read_manifest(step_path(directory, step))
    out = {}
    for name, leaf in leaves(like).items():
        arr, entry = stored[name]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"{name}: checkpoint shape {arr.shape} != {tuple(leaf.shape)}")
        t = from_numpy(arr, entry["dtype"])
        if isinstance(leaf, np.ndarray):
            out[name] = t.numpy().astype(leaf.dtype)
            continue
        t = t.to(device=device or leaf.device, dtype=leaf.dtype)
        if hasattr(leaf, "device_mesh"):
            from torch.distributed.tensor import distribute_tensor
            t = distribute_tensor(t, leaf.device_mesh, leaf.placements)
        out[name] = t
    return _rebuild(like, out)


class CheckpointManager:
    """Async manager with retention of the ``keep`` newest steps."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any) -> None:
        """Copies every leaf to the host now (the train step may overwrite
        the tensors next), then writes them, on a thread when async."""
        self.wait()
        host = {name: np.array(leaf) if isinstance(leaf, np.ndarray) else
                _whole(leaf).detach().to("cpu", copy=True)
                for name, leaf in leaves(tree).items()}
        if self.async_save:
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(step, host)

    def _save_and_gc(self, step: int, host) -> None:
        save_checkpoint(self.directory, step, host)
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore(self, like: Any, step: Optional[int] = None, *,
                device=None) -> Any:
        self.wait()
        return restore_checkpoint(self.directory, like, step, device=device)

    @property
    def latest(self) -> Optional[int]:
        """The newest step on disk, once the save in flight is written:
        the supervisor restarts from ``latest`` and then restores it, and
        the two must name the same step (the reference's manager reads the
        directory at once, so a restart during an async save can restore
        a newer step than the one it reports)."""
        self.wait()
        return latest_step(self.directory)
