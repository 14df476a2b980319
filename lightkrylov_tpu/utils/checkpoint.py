"""Checkpoint / resume of Krylov factorization state.

The reference has *algorithmic* restart capability (``kstart/kend``
incremental factorizations + Krylov-Schur compression) but never serializes
state; its only persistence is ``.npy`` spectrum dumps
(reference: SURVEY.md §5 — "orbax-style checkpoint of (basis, H, counters)
is a cheap upgrade").  This module provides that upgrade: save/load of any
pytree-of-arrays state (basis buffers, Hessenberg, counters, RNG keys) to a
single ``.npz`` file, plus an optional Orbax backend for sharded multi-host
state.

A factorization checkpoint is just ``{"X": X, "H": H, "k": k}``; resuming is
``arnoldi(A, X, H, kstart=k+1)`` — the incremental semantics the solvers
already use.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "save_checkpoint_orbax",
           "load_checkpoint_orbax"]


def _flatten_with_paths(tree):
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    keys = ["/".join(str(k) for k in path) for path, _ in flat]
    leaves = [leaf for _, leaf in flat]
    return keys, leaves, treedef


def save_checkpoint(state, path: str) -> None:
    """Serialize a pytree of arrays/scalars to ``path`` (.npz).

    Device fetches go through :func:`~lightkrylov_tpu.utils.linalg.to_host`
    (complex leaves are split re/im inside one jitted call)."""
    from .linalg import to_host

    keys, leaves, _ = _flatten_with_paths(state)
    arrays = {f"{i:04d}|{k}": to_host(l)
              for i, (k, l) in enumerate(zip(keys, leaves))}
    np.savez(path, **arrays)


def load_checkpoint(state_template, path: str):
    """Restore a pytree saved by :func:`save_checkpoint`; ``state_template``
    supplies the tree structure (and target shardings if its leaves carry
    ``NamedSharding``)."""
    data = np.load(path)
    keys, leaves, treedef = _flatten_with_paths(state_template)
    ordered = [data[k] for k in sorted(data.files)]
    if len(ordered) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(ordered)} leaves, template has {len(leaves)}")
    new_leaves = []
    for tmpl, arr in zip(leaves, ordered):
        arr = jnp.asarray(arr)
        if hasattr(tmpl, "sharding") and hasattr(tmpl.sharding, "mesh"):
            arr = jax.device_put(arr, tmpl.sharding)
        new_leaves.append(arr)
    return jax.tree_util.tree_unflatten(treedef, new_leaves)


def save_checkpoint_orbax(state, path: str) -> None:
    """Orbax backend for multi-host sharded state (optional dependency)."""
    import orbax.checkpoint as ocp

    ckpt = ocp.StandardCheckpointer()
    ckpt.save(path, state, force=True)
    ckpt.wait_until_finished()


def load_checkpoint_orbax(state_template, path: str):
    import orbax.checkpoint as ocp

    ckpt = ocp.StandardCheckpointer()
    return ckpt.restore(path, state_template)
