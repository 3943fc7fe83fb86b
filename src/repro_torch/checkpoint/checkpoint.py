"""Checkpoints in the JAX reference's format, read and written.

The reference saves a tree as one ``npz`` holding arrays ``a0..aN`` and a
JSON ``manifest`` with each array's ``/``-joined tree path
(``blocks/attn/qkv/kernel``), dtype, shape, the caller's ``extra`` and a
SHA-256 checksum over the first 4096 bytes of every array. The port keeps
the reference's parameter layout, so carrying weights across is a rename:
the paths become the nested dict keys. :func:`save` / :func:`restore` /
:func:`latest_step` / :func:`retain` write and read training checkpoints
(``step_XXXXXXXX.shard0.npz``, atomic by rename, newest valid first) in the
same format, so each package restores the other's.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import zipfile
from typing import Any, Optional

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


def _head(a: np.ndarray) -> bytes:
    """The first 4096 bytes of ``a`` in C order (what the reference's
    ``np.ascontiguousarray(a).tobytes()[:4096]`` gives, without a copy of
    the whole array)."""
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)[:4096].tobytes()


def _checksum(arrays) -> str:
    """The reference's checksum: SHA-256 over each array's first 4096
    bytes, in manifest order."""
    return hashlib.sha256(b"".join(_head(a) for a in arrays)).hexdigest()


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


# ---------------------------------------------------------------------------
# training checkpoints (the reference's checkpoint.save / restore / retain)
# ---------------------------------------------------------------------------

def _as_numpy(leaf) -> np.ndarray:
    """A tree leaf (tensor, array or number) as a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: dict, *, shard_id: int = 0,
         extra: Optional[dict] = None) -> str:
    """Atomically save ``tree`` (nested dicts of tensors) with the
    JSON-serializable ``extra``: write ``<final>.tmp``, then rename. The
    file is the reference's ``np.savez`` layout (``a0.npy`` … and
    ``manifest.npy`` in one stored zip), written one leaf at a time, so
    that the host holds one leaf, not the tree."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = flatten_paths(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}.shard{shard_id}.npz")
    tmp = final + ".tmp"
    heads, dtypes, shapes = [], [], []
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, leaf in enumerate(flat.values()):
            a = _as_numpy(leaf)
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, a, allow_pickle=False)
            heads.append(_head(a))
            dtypes.append(str(a.dtype))
            shapes.append(list(a.shape))
            del a
        manifest = {"step": int(step), "paths": list(flat), "dtypes": dtypes,
                    "shapes": shapes, "extra": extra or {},
                    "checksum": hashlib.sha256(b"".join(heads)).hexdigest()}
        with zf.open("manifest.npy", "w") as f:
            np.lib.format.write_array(f, np.asarray(json.dumps(manifest)),
                                      allow_pickle=False)
    os.replace(tmp, final)
    return final


def _ckpt_files(ckpt_dir: str, shard_id: int = 0) -> list:
    """Sorted ``(step, path)`` of the checkpoint files in ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return []
    pat = re.compile(rf"step_(\d+)\.shard{shard_id}\.npz$")
    out = []
    for fn in os.listdir(ckpt_dir):
        m = pat.match(fn)
        if m:
            out.append((int(m.group(1)), os.path.join(ckpt_dir, fn)))
    return sorted(out)


def latest_step(ckpt_dir: str, shard_id: int = 0) -> Optional[int]:
    """The newest checkpoint step in ``ckpt_dir`` (None when empty)."""
    files = _ckpt_files(ckpt_dir, shard_id)
    return files[-1][0] if files else None


def restore(ckpt_dir: str, tree_like: dict, step: Optional[int] = None, *,
            shard_id: int = 0) -> tuple[Any, dict, int]:
    """Restore into the structure of ``tree_like``, newest valid checkpoint
    first: a file with a bad checksum, missing arrays, arrays other than
    its manifest says, or another tree structure is skipped with a
    message. Each leaf comes back as a tensor of the saved dtype on the
    device of ``tree_like``'s leaf at its path; arrays are read one at a
    time. Returns ``(tree, extra, step)``."""
    files = _ckpt_files(ckpt_dir, shard_id)
    if step is not None:
        files = [f for f in files if f[0] == step]
    like = flatten_paths(tree_like)
    for s, path in reversed(files):
        try:
            with np.load(path, allow_pickle=False) as z:
                manifest = json.loads(str(z["manifest"]))
                if manifest["paths"] != list(like):
                    raise IOError("tree structure mismatch")
                out, heads = {}, []
                for i, (p, dt, shape) in enumerate(zip(
                        manifest["paths"], manifest["dtypes"],
                        manifest["shapes"])):
                    a = z[f"a{i}"]
                    if str(a.dtype) != dt or list(a.shape) != list(shape):
                        raise IOError(f"{p} is {a.dtype}{list(a.shape)}, "
                                      f"manifest says {dt}{shape}")
                    heads.append(_head(a))
                    dev = like[p].device if isinstance(
                        like[p], torch.Tensor) else "cpu"
                    out[p] = torch.from_numpy(a).to(dev)
            if hashlib.sha256(b"".join(heads)).hexdigest() != \
                    manifest["checksum"]:
                raise IOError("checksum mismatch")
            return unflatten_paths(out), manifest["extra"], s
        except Exception as e:  # noqa: BLE001 (skip-and-continue)
            print(f"[ckpt] skipping {path}: {e}")
    raise FileNotFoundError(f"no valid checkpoint in {ckpt_dir}")


def retain(ckpt_dir: str, keep: int = 3, keep_every: int = 0,
           shard_id: int = 0) -> None:
    """Delete old checkpoints, keeping the newest ``keep`` and every
    ``keep_every``-th step."""
    files = _ckpt_files(ckpt_dir, shard_id)
    if len(files) <= keep:
        return
    for s, path in files[:-keep]:
        if keep_every and s % keep_every == 0:
            continue
        os.remove(path)
