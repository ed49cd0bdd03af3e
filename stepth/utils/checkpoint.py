"""Checkpoint / resume (SURVEY.md §5: the reference's only persistence is
image-file save/load — reference src/depth_image.rs:65-74,
src/mask_image.rs:197-199; mapping state snapshotting is greenfield).

Orbax-backed when available, with a NumPy ``.npz`` fallback so checkpointing
never becomes a hard dependency. State is any pytree of arrays — typically a
:class:`stepth.fusion.ba.BAState`, keyframe pose array, or fused map.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import jax
import numpy as np

try:  # orbax is baked into the image; guard anyway
    import orbax.checkpoint as ocp

    _HAVE_ORBAX = True
except Exception:  # pragma: no cover
    _HAVE_ORBAX = False


def save(path: str, state: Any, metadata: Optional[Dict] = None) -> None:
    """Save a pytree checkpoint at ``path`` (directory for orbax, ``.npz``
    file for the fallback)."""
    if _HAVE_ORBAX and not path.endswith(".npz"):
        ckptr = ocp.PyTreeCheckpointer()
        ckptr.save(os.path.abspath(path), jax.device_get(state), force=True)
        if metadata:
            with open(os.path.join(path, "stepth_meta.json"), "w") as f:
                json.dump(metadata, f)
        return
    leaves, treedef = jax.tree.flatten(state)
    arrays = {f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        repr(treedef).encode(), dtype=np.uint8
    )
    if metadata:
        arrays["__meta__"] = np.frombuffer(json.dumps(metadata).encode(), np.uint8)
    # Atomic publish: a process killed mid-save (the failure mode
    # solve_resumable/supervise defend against) must never leave a truncated
    # npz at the final path — write to a temp file in the same directory and
    # os.replace() onto the target (atomic on POSIX).
    npz_path = path if path.endswith(".npz") else path + ".npz"
    tmp_path = npz_path + f".tmp.{os.getpid()}"
    try:
        np.savez(tmp_path, **arrays)
        # np.savez appends .npz when missing; our tmp name doesn't end in it.
        written = tmp_path if os.path.exists(tmp_path) else tmp_path + ".npz"
        os.replace(written, npz_path)
    finally:
        for stale in (tmp_path, tmp_path + ".npz"):
            if os.path.exists(stale):
                os.remove(stale)


def restore(path: str, like: Any = None) -> Any:
    """Restore a checkpoint. For the ``.npz`` fallback a ``like`` pytree with
    the same structure is required (treedefs aren't portable as text)."""
    if _HAVE_ORBAX and os.path.isdir(path):
        ckptr = ocp.PyTreeCheckpointer()
        restored = ckptr.restore(os.path.abspath(path))
        if like is not None:
            leaves = jax.tree.leaves(restored)
            return jax.tree.unflatten(jax.tree.structure(like), leaves)
        return restored
    npz_path = path if path.endswith(".npz") else path + ".npz"
    data = np.load(npz_path)
    if like is None:
        raise ValueError("npz restore requires a `like` pytree for structure")
    n = len(jax.tree.leaves(like))
    leaves = [data[f"leaf_{i}"] for i in range(n)]
    return jax.tree.unflatten(jax.tree.structure(like), leaves)


def metadata(path: str) -> Optional[Dict]:
    """Read checkpoint metadata, or None if absent.

    An unreadable/corrupt checkpoint (e.g. truncated by a crash predating the
    atomic-save path) is treated as absent rather than raising — the resume
    loop must restart from scratch, not brick on every relaunch.
    """
    try:
        meta_file = os.path.join(path, "stepth_meta.json")
        if os.path.isdir(path) and os.path.exists(meta_file):
            with open(meta_file) as f:
                return json.load(f)
        npz_path = path if path.endswith(".npz") else path + ".npz"
        if os.path.exists(npz_path):
            data = np.load(npz_path)
            if "__meta__" in data:
                return json.loads(bytes(data["__meta__"]).decode())
    except Exception:
        return None
    return None
