"""Fault-tolerant checkpointing (the port of ``repro.checkpoint.checkpointer``,
same file layout and manifest, so a checkpoint either package wrote restores
into the other's state):

  * atomic: write to .tmp_step-dir, fsync the manifest, os.replace -> step-dir;
  * manifest with a per-array digest, so a torn write or same-size bit
    corruption is detected and the restore falls back to the previous valid
    step;
  * async: a background thread writes (the tensors are first copied to the
    host through numpy on the calling thread, so training can proceed);
  * arrays are saved whole under their tree paths (``params/layers/wq/w``,
    ``opt/mu/...``, ``step``: dict keys, NamedTuple field names, list
    indices), so a restore works onto any layout;
  * the pipeline cursor and the degree live in the manifest's ``extra``;
  * on a mesh (``mesh=``, training a ``TrainState`` of this rank's shards)
    every rank gathers each leaf to its global shape
    (``dist.sharding.gather_train_state``) and rank 0 alone writes, in the
    one-device format, so a mesh checkpoint restores at 1x1 and in the
    reference; every rank then waits at a barrier.  A restore reads the
    global leaves and slices them for this rank.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import named_leaves, tree_leaves, tree_unflatten


def _host(x) -> np.ndarray:
    """A leaf as a host numpy array (tensors copied off the device)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype here; checkpoint f32")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten_with_paths(tree) -> dict[str, np.ndarray]:
    return {name: _host(v) for name, v in named_leaves(tree)}


def _check_array(name: str, arr: np.ndarray, meta: dict) -> None:
    """Verify one loaded array against its manifest entry: shape AND the
    content digest stamped at save time — same-size bit corruption (a bad
    sector, a torn concurrent write) fails here, not at some NaN three
    thousand train steps later."""
    if list(arr.shape) != meta["shape"]:
        raise ValueError(f"checkpoint array {name!r}: shape {list(arr.shape)}"
                         f" != manifest {meta['shape']}")
    digest = hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]
    if digest != meta["digest"]:
        raise ValueError(f"checkpoint array {name!r}: content digest "
                         f"{digest} != manifest {meta['digest']} (corrupt)")


def _wide(mesh) -> bool:
    return mesh is not None and math.prod(mesh.shape) > 1


class Checkpointer:
    """``mesh``: the :class:`~repro_torch.dist.meshctx.Mesh` of a sharded
    ``TrainState`` (None or one rank: the one-device checkpointer)."""

    def __init__(self, directory: str | Path, keep: int = 3, mesh=None):
        self.dir = Path(directory)
        self.mesh = mesh if _wide(mesh) else None
        if self.mesh is None or self.mesh.rank == 0:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save

    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = True) -> None:
        """Snapshot `tree` (host copy taken synchronously), write async
        unless blocking.  On a mesh: gathered, written by rank 0, then a
        barrier of every rank (collective)."""
        if self.mesh is not None:
            import torch.distributed as dist

            from repro_torch.dist.sharding import gather_train_state

            tree = gather_train_state(tree, self.mesh)
            if self.mesh.rank == 0:
                self._save(step, tree, extra, blocking)
            del tree
            dist.barrier()
            return
        self._save(step, tree, extra, blocking)

    def _save(self, step: int, tree: Any, extra: Optional[dict], blocking: bool) -> None:
        arrays = _flatten_with_paths(tree)
        extra = dict(extra or {})
        self.wait()  # one in-flight save at a time
        if blocking:
            self._write(step, arrays, extra)
        else:
            self._thread = threading.Thread(
                target=self._write_guard, args=(step, arrays, extra),
                daemon=True)
            self._thread.start()

    def _write_guard(self, step, arrays, extra):
        try:
            self._write(step, arrays, extra)
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def _write(self, step: int, arrays: dict[str, np.ndarray], extra: dict):
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f".tmp_step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "extra": extra,
                    "arrays": {}}
        for name, arr in arrays.items():
            fname = hashlib.sha1(name.encode()).hexdigest()[:16] + ".npy"
            np.save(tmp / fname, arr)
            manifest["arrays"][name] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "digest": hashlib.sha1(arr.tobytes()).hexdigest()[:16],
            }
        mf = tmp / "manifest.json"
        with open(mf, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic publish
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # ---------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for d in self.dir.glob("step_*"):
            if (d / "manifest.json").exists():
                try:
                    out.append(int(d.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_valid_step(self) -> Optional[int]:
        """Newest step whose manifest digests verify (torn-write defense)."""
        for s in reversed(self.all_steps()):
            if self._verify(s):
                return s
        return None

    def _verify(self, step: int) -> bool:
        d = self.dir / f"step_{step:010d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
            for name, meta in manifest["arrays"].items():
                arr = np.load(d / meta["file"])
                _check_array(name, arr, meta)
            return True
        except Exception:
            return False

    def restore(self, step: int, like: Any) -> tuple[Any, dict]:
        """Restore into the structure of `like` (tensors, meta tensors or
        arrays; on a mesh this rank's shards) as numpy arrays.  Returns
        (tree, extra).  Every loaded array is verified against its
        manifest digest — a truncated or bit-corrupted checkpoint raises
        instead of loading silently (``restore_latest`` skips it)."""
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = []
        for name, ref in named_leaves(like):
            meta = manifest["arrays"].get(name)
            if meta is None:
                raise KeyError(f"checkpoint missing array {name!r}")
            arr = np.load(d / meta["file"])
            _check_array(name, arr, meta)
            leaves.append(arr)
        tree = tree_unflatten(like, leaves)
        if self.mesh is not None:
            from repro_torch.dist.sharding import shard_train_state
            from repro_torch.tree import tree_map

            tree = tree_map(lambda a: a.numpy(), shard_train_state(
                tree_map(torch.from_numpy, tree), self.mesh))
        for (name, ref), arr in zip(named_leaves(like), tree_leaves(tree)):
            if hasattr(ref, "shape") and tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"shape mismatch for {name}: ckpt {arr.shape} vs {ref.shape}")
        return tree, manifest.get("extra", {})

    def restore_latest(self, like: Any) -> Optional[tuple[int, Any, dict]]:
        """The newest step that restores into ``like`` with every digest
        verified, as (step, tree, extra); a torn, corrupt or mismatched
        step falls back to the one before (each array is read and verified
        once); None when no step restores."""
        for s in reversed(self.all_steps()):
            try:
                tree, extra = self.restore(s, like)
            except (OSError, ValueError, KeyError):
                continue
            return s, tree, extra
        return None
