"""Model files (counterpart of ``jeicyboodsp_tpu/models/serialization.py``):
the reference's struct layouts, and pytree checkpoints.

The reference persists trained GMMs by ``fwrite`` of raw C structs
(``GMMAlgorithm_Train_Auto_ver2.cpp:160``) and reads them back with other
layouts:

- the trainer writes ``GMMParameter`` with ``PCA_LEN 8``: 8096 bytes a class;
- the classifier reads ``GMMParameter`` with ``PCA_LEN 4``: 6560 bytes a class
  (``GMMAlgorithm_Test_Auto_ver2.cpp:22``), so class i is read from byte
  offset i * 6560 of a file whose records are 8096 bytes, and every class
  after the first is misaligned;
- Viterbi reads ``HMMParameter``: 6 PCA-4 GMMs and the 6 x 6 transitions
  (``Viterbi_version1.cpp:37-40``).

The three layouts are numpy copies of the JAX module's, byte for byte, with
the misaligned read (:func:`read_as_test_layout`), so a model file written by
either package reads in the other.

The pytree checkpoints' npz layout is the JAX package's: one ``leaf_{i}``
per leaf, in the order ``jax.tree_util.tree_flatten`` gives a dict (its keys
sorted, nested dicts likewise), and a ``__treedef__`` entry (the tree's repr
as bytes) that loading ignores.  So a checkpoint written by either package
loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

FEATURE_LEN = 12
NUM_OF_MIXTURE = 4
NUM_OF_STATE = 6

TRAIN_PCA = 8
TEST_PCA = 4

TRAIN_STRUCT_BYTES = 8 * (4 + 4 * 12 + 4 * 12 * 12 + 4 * 12 * TRAIN_PCA)  # 8096
TEST_STRUCT_BYTES = 8 * (4 + 4 * 12 + 4 * 12 * 12 + 4 * 12 * TEST_PCA)  # 6560
HMM_STRUCT_BYTES = NUM_OF_STATE * TEST_STRUCT_BYTES + 8 * NUM_OF_STATE * NUM_OF_STATE


def pack_gmm(alpha, mean, cov, eigvec) -> bytes:
    """Serialize one GMMParameter struct; eigvec's last dim (8 or 4) sets
    the layout."""
    return b"".join(np.asarray(a, "<f8").tobytes() for a in (alpha, mean, cov, eigvec))


def unpack_gmm(data: bytes, pca_len: int):
    """Deserialize one GMMParameter struct of the given PCA layout."""
    a = np.frombuffer(data, "<f8")
    alpha = a[:4].copy()
    mean = a[4:52].reshape(4, 12).copy()
    cov = a[52:628].reshape(4, 12, 12).copy()
    ev = a[628:628 + 4 * 12 * pca_len].reshape(4, 12, pca_len).copy()
    return alpha, mean, cov, ev


def write_train_model(path: str, classes: list) -> None:
    """classes: list of (alpha, mean, cov, eigvec8) tuples (trainer output)."""
    with open(path, "wb") as f:
        for alpha, mean, cov, ev in classes:
            if np.shape(ev)[-1] != TRAIN_PCA:
                raise ValueError(f"eigvec of {np.shape(ev)}: the train layout holds {TRAIN_PCA}")
            f.write(pack_gmm(alpha, mean, cov, ev))


def read_as_test_layout(path: str, num_classes: int):
    """Read a model file exactly as the PCA-4 classifier does: fixed 6560-byte
    strides, whatever wrote the file, zeros past its end (fread past EOF).
    On a train-layout file this is the reference's train -> test mismatch."""
    with open(path, "rb") as f:
        data = f.read()
    return [unpack_gmm(data[i * TEST_STRUCT_BYTES:(i + 1) * TEST_STRUCT_BYTES]
                       .ljust(TEST_STRUCT_BYTES, b"\0"), TEST_PCA)
            for i in range(num_classes)]


def read_train_layout(path: str, num_classes: int):
    with open(path, "rb") as f:
        data = f.read()
    return [unpack_gmm(data[i * TRAIN_STRUCT_BYTES:(i + 1) * TRAIN_STRUCT_BYTES], TRAIN_PCA)
            for i in range(num_classes)]


def train_to_test_params(alpha, mean, cov, eigvec8):
    """The ALIGNED conversion the reference intended: keep the top-4 PCA
    dims of the trainer's top-8 export."""
    return alpha, mean, cov, eigvec8[:, :, :TEST_PCA]


def pack_hmm(states, trans) -> bytes:
    """states: 6 x (alpha, mean, cov, eigvec4); trans: (6, 6)."""
    for *_, ev in states:
        if np.shape(ev)[-1] != TEST_PCA:
            raise ValueError(f"eigvec of {np.shape(ev)}: the HMM layout holds {TEST_PCA}")
    return b"".join(pack_gmm(*s) for s in states) + np.asarray(trans, "<f8").tobytes()


def unpack_hmm(data: bytes):
    """-> (6 x (alpha, mean, cov, eigvec4), trans (6, 6))."""
    states = [unpack_gmm(data[i * TEST_STRUCT_BYTES:(i + 1) * TEST_STRUCT_BYTES], TEST_PCA)
              for i in range(NUM_OF_STATE)]
    trans = np.frombuffer(data[NUM_OF_STATE * TEST_STRUCT_BYTES:][:8 * 36], "<f8")
    return states, trans.reshape(6, 6).copy()


# ---------------------------------------------------------------------------
# pytree checkpoints
# ---------------------------------------------------------------------------


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
