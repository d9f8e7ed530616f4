"""Checkpoint / resume for solver-state PyTrees.

The reference has no persistence; its resumable state IS the warm start
(``previous_solution_`` kept across ``Step`` calls,
``/root/reference/optimization/optimization.hpp:83-89,107``), externally
settable via ``SetPreviousSolution``/``Reset``. Here that state is an
explicit PyTree (``MPCState``, plant state, whole batched/sharded sweeps),
so checkpointing is a generic save/load of array leaves keyed by tree path —
a 100k-scenario receding-horizon sweep resumes exactly where it stopped.
"""

from __future__ import annotations

import os
from typing import Any

import jax
import numpy as np

__all__ = [
    "save_state",
    "load_state",
    "save_state_orbax",
    "load_state_orbax",
]

_SEP = "/"


def _leaf_key(path) -> str:
    parts = []
    for p in path:
        if isinstance(p, jax.tree_util.GetAttrKey):
            parts.append(p.name)
        elif isinstance(p, jax.tree_util.DictKey):
            parts.append(str(p.key))
        elif isinstance(p, jax.tree_util.SequenceKey):
            parts.append(str(p.idx))
        elif isinstance(p, jax.tree_util.FlattenedIndexKey):
            parts.append(str(p.key))
        else:
            parts.append(str(p))
    return _SEP.join(parts) if parts else "_root"


def _npz_path(path: str) -> str:
    # np.savez silently appends .npz to extensionless paths; normalize on
    # both save and load so the round trip works for any path string.
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, tree: Any) -> None:
    """Persist a PyTree of arrays to ``.npz``, keyed by tree path.

    Sharded arrays are gathered to host; callers on multi-host meshes should
    save per-process shards or use orbax for async distributed checkpoints.
    """
    path = _npz_path(path)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    payload = {}
    for p, leaf in leaves:
        key = _leaf_key(p)
        if key in payload:
            raise ValueError(f"duplicate checkpoint key {key!r}")
        payload[key] = np.asarray(leaf)
    np.savez(path, **payload)


def load_state(path: str, like: Any) -> Any:
    """Restore a PyTree saved by :func:`save_state` into the structure (and
    dtypes/shardings left to the caller) of ``like``."""
    with np.load(_npz_path(path)) as data:
        paths_and_leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
        leaves = []
        for p, ref_leaf in paths_and_leaves:
            key = _leaf_key(p)
            if key not in data:
                raise KeyError(
                    f"checkpoint {path} missing leaf {key!r}; "
                    f"has {sorted(data.keys())}"
                )
            value = data[key]
            ref = np.asarray(ref_leaf)
            if value.shape != ref.shape:
                raise ValueError(
                    f"leaf {key!r} shape {value.shape} != expected {ref.shape}"
                )
            leaves.append(value.astype(ref.dtype))
        return jax.tree_util.tree_unflatten(treedef, leaves)


# --------------------------------------------------------------------- orbax
# The backend for sharded sweeps: saving writes one shard per host (no
# gather of the full array through one host), and
# restoring places each leaf directly onto the devices/sharding of the
# ``like`` tree. ``save_state`` / ``load_state`` above stay the
# dependency-light single-host path.

def save_state_orbax(path: str, tree: Any, *, async_save: bool = False):
    """Persist a PyTree checkpoint with orbax.

    ``path`` is a directory (created by orbax; must not already contain a
    checkpoint). With ``async_save=True`` the write happens in the
    background — the returned checkpointer exposes ``wait_until_finished()``
    and MUST be waited on (or closed) before process exit; the receding-
    horizon loop keeps solving while the previous warm-start snapshot
    drains to disk.
    """
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    if async_save:
        ckptr = ocp.AsyncCheckpointer(ocp.StandardCheckpointHandler())
        ckptr.save(path, args=ocp.args.StandardSave(tree))
        return ckptr
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, tree)
    ckptr.close()
    return None


def load_state_orbax(path: str, like: Any) -> Any:
    """Restore a PyTree saved by :func:`save_state_orbax`.

    ``like`` supplies the structure AND placement: leaves that are sharded
    ``jax.Array``s are restored shard-by-shard onto their mesh, so a
    100k-scenario sweep resumes without ever materializing host-side.
    """
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    abstract = jax.tree.map(ocp.utils.to_shape_dtype_struct, like)
    with ocp.StandardCheckpointer() as ckptr:
        return ckptr.restore(path, abstract)
