"""Pytree checkpoints (counterpart of the ``save_pytree``/``load_pytree``
half of ``jeicyboodsp_tpu/models/serialization.py``; the GMM struct layouts
are not ported yet).

The npz layout is the JAX package's: one ``leaf_{i}`` per leaf, in the
order ``jax.tree_util.tree_flatten`` gives a dict (its keys sorted, nested
dicts likewise), and a ``__treedef__`` entry (the tree's repr as bytes)
that loading ignores.  So a checkpoint written by either package loads in
the other.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree):
    """(leaves, repr) of a tree of dicts and leaves, in ``tree_flatten``'s
    order (keys sorted) and with its ``PyTreeDef`` spelling."""
    if not isinstance(tree, dict):
        return [tree], "*"
    keys = sorted(tree)
    parts = [_flatten(tree[k]) for k in keys]
    body = ", ".join(f"{k!r}: {r}" for k, (_, r) in zip(keys, parts))
    return [leaf for p, _ in parts for leaf in p], "{" + body + "}"


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if not isinstance(like, dict):
        return next(leaves)
    return {k: _unflatten(like[k], leaves) for k in sorted(like)}


def _numpy(leaf):
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def save_pytree(path: str, tree, **extras) -> None:
    """Flatten a tree of dicts of tensors (or arrays) into an npz checkpoint.
    ``extras`` are saved beside the leaves under their own names (a
    streaming run's ``block`` and ``out_bytes``)."""
    leaves, spelled = _flatten(tree)
    np.savez(
        path,
        __treedef__=np.frombuffer(f"PyTreeDef({spelled})".encode(), dtype=np.uint8),
        **{f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(leaves)},
        **{k: np.asarray(v) for k, v in extras.items()},
    )


def load_pytree(source, like):
    """Restore into the structure of ``like`` from a checkpoint path or an
    opened npz: each leaf a tensor on the device of ``like``'s leaf in its
    place (the CPU where that leaf is not a tensor).  A leaf whose count,
    shape or dtype differs from ``like``'s raises ``ValueError``: a state
    saved in another precision is refused, not promoted."""
    data = source if isinstance(source, np.lib.npyio.NpzFile) else np.load(source)
    want = _flatten(like)[0]
    n = len([k for k in data.files if k.startswith("leaf_")])
    if n != len(want):
        raise ValueError(f"{n} leaves for a structure of {len(want)}")
    leaves = []
    for i, ref in enumerate(want):
        a = torch.from_numpy(np.array(data[f"leaf_{i}"]))
        ref = ref if isinstance(ref, torch.Tensor) else torch.from_numpy(np.asarray(ref))
        if a.dtype != ref.dtype or a.shape != ref.shape:
            raise ValueError(f"leaf_{i} is {a.dtype} {tuple(a.shape)}, the state wants "
                             f"{ref.dtype} {tuple(ref.shape)}")
        leaves.append(a.to(ref.device))
    return _unflatten(like, iter(leaves))
