"""Weight carry-over from the JAX reference.

The reference saves a parameter tree as one ``npz`` holding arrays
``a0..aN`` and a JSON ``manifest`` with each array's ``/``-joined tree path
(``blocks/attn/qkv/kernel``), dtype, shape, and a SHA-256 checksum over the
first 4096 bytes of every array. The port keeps the reference's parameter
layout, so carrying weights across is a rename: the paths become the nested
dict keys.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

#: numpy dtypes the port reads (the reference's parameter and carrier types)
_DTYPES = {"float32", "float16", "int8", "uint8", "int32", "int64"}


def flatten_paths(tree: dict, prefix: str = "") -> dict:
    """Nested dict → ``{"a/b/c": leaf}`` in sorted key order (the order of
    the reference's pytree flattening)."""
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(tree[k], dict):
            out.update(flatten_paths(tree[k], path))
        else:
            out[path] = tree[k]
    return out


def unflatten_paths(flat: dict) -> dict:
    """``{"a/b/c": leaf}`` → nested dict."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"path {path!r} runs through a leaf")
        if last in node:
            raise ValueError(f"duplicate path {path!r}")
        node[last] = leaf
    return tree


def params_from_numpy(flat: dict, device="cpu") -> dict:
    """The port's parameter dict from ``{path: np.ndarray}`` (reference
    paths, ``/``-joined). Arrays are copied onto ``device``."""
    out = {}
    for path, arr in flat.items():
        arr = np.asarray(arr)
        if arr.dtype.name not in _DTYPES:
            raise TypeError(f"{path}: dtype {arr.dtype} is not supported")
        out[path] = torch.from_numpy(np.array(arr, copy=True)).to(device)
    return unflatten_paths(out)


def _checksum(arrays) -> str:
    """The reference's checksum: SHA-256 over each array's first 4096
    bytes, in manifest order."""
    return hashlib.sha256(
        b"".join(np.ascontiguousarray(a).tobytes()[:4096]
                 for a in arrays)).hexdigest()


def load_reference_npz(path: str) -> tuple[dict, dict]:
    """Read a reference checkpoint file. Returns ``({tree path: array},
    manifest)``; raises ``IOError`` when the checksum, shapes or dtypes
    disagree with the manifest."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        arrays = [z[f"a{i}"] for i in range(len(manifest["paths"]))]
    if _checksum(arrays) != manifest["checksum"]:
        raise IOError(f"{path}: checksum mismatch")
    for p, a, dt, shape in zip(manifest["paths"], arrays, manifest["dtypes"],
                               manifest["shapes"]):
        if str(a.dtype) != dt or list(a.shape) != list(shape):
            raise IOError(f"{path}: {p} is {a.dtype}{list(a.shape)}, "
                          f"manifest says {dt}{shape}")
    return dict(zip(manifest["paths"], arrays)), manifest
