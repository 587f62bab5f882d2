"""Tree checkpointing: npz payload + json manifest, atomic, step-indexed.

PyTorch counterpart of ``repro.checkpoint.checkpoint``, with the same files:
``ckpt_<step>.npz`` holds every leaf of a state tree by its path, keyed as
the JAX package keys it (``jax.tree_util.keystr`` with every character
outside ``[A-Za-z0-9_.-]`` made ``_``: a dict entry ``['name']`` gives
``_name_``, a NamedTuple field ``.mu``, a list item ``[0]``), and
``ckpt_<step>.json`` the manifest ``{"step", "keys", "extra"}``. A tree is
nested dicts, lists, tuples and NamedTuples (``OptState``,
``ExchangeState``) of tensors or arrays; None is an empty subtree, as in
JAX, and dicts are walked in sorted key order. Leaves are written one at a
time, so the host holds one leaf's copy at once (the payload is the same
zip of ``.npy`` members that ``np.savez`` writes). bfloat16 leaves, which
numpy has no type for, are stored as their 16 bits (uint16) and restored
bit for bit. Restore rebuilds the structure of a reference tree,
checking every leaf's shape and dtype, on the caller's device. Atomicity via
write-to-tmp + rename, the manifest before the payload.
"""

from __future__ import annotations

import json
import pathlib
import re
import tempfile
import zipfile
from typing import Any, Callable

import numpy as np
import torch

PyTree = Any

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_leaves(fn: Callable[[str, Any], Any], tree: PyTree, path: str = "") -> PyTree:
    """``tree`` with every leaf replaced by ``fn(payload key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k], f"{path}[{k!r}]") for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_leaves(fn, getattr(tree, f), f"{path}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, f"{path}[{i}]") for i, v in enumerate(tree))
    return fn(_SAFE.sub("_", path), tree)


def _leaves_with_keys(tree: PyTree) -> list[tuple[str, Any]]:
    """(payload key, leaf) pairs in the JAX package's order."""
    out: list = []
    _map_leaves(lambda key, leaf: out.append((key, leaf)), tree)
    return out


def _numpy(value) -> np.ndarray:
    """A host array of ``value``; bfloat16 as its bits (uint16)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
            return t.cpu().numpy().view(np.uint16)
        return t.cpu().numpy()
    return np.asarray(value)


def save_checkpoint(directory: str | pathlib.Path, step: int, tree: PyTree,
                    extra: dict | None = None) -> pathlib.Path:
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    keys = []
    with tempfile.NamedTemporaryFile(dir=directory, suffix=".tmp", delete=False) as f:
        tmp = pathlib.Path(f.name)
        with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
            for key, leaf in _leaves_with_keys(tree):
                if key in keys:
                    raise ValueError(f"two leaves share the payload key {key!r}")
                keys.append(key)
                with zf.open(f"{key}.npy", "w", force_zip64=True) as member:
                    np.lib.format.write_array(member, _numpy(leaf), allow_pickle=False)
    manifest = {
        "step": int(step),
        "keys": sorted(keys),
        "extra": extra or {},
    }
    final = directory / f"ckpt_{step:08d}.npz"
    # Manifest first, then payload: a reader that can see the .npz must also
    # see a complete .json. Both renames are atomic within the directory.
    with tempfile.NamedTemporaryFile("w", dir=directory, suffix=".tmp",
                                     delete=False) as f:
        f.write(json.dumps(manifest))
        tmp_json = pathlib.Path(f.name)
    tmp_json.rename(directory / f"ckpt_{step:08d}.json")
    tmp.rename(final)
    return final


def latest_step(directory: str | pathlib.Path) -> int | None:
    directory = pathlib.Path(directory)
    steps = [int(p.stem.split("_")[1]) for p in directory.glob("ckpt_*.npz")]
    return max(steps) if steps else None


def _ref_dtype(ref) -> tuple[torch.dtype, np.dtype]:
    """(torch dtype to restore, numpy dtype stored) of a reference leaf."""
    if isinstance(ref, torch.Tensor):
        if ref.dtype == torch.bfloat16:
            return torch.bfloat16, np.dtype(np.uint16)
        return ref.dtype, torch.empty((), dtype=ref.dtype).numpy().dtype
    arr = np.asarray(ref)
    return torch.from_numpy(np.zeros((), arr.dtype)).dtype, arr.dtype


def load_checkpoint(directory: str | pathlib.Path, reference: PyTree,
                    step: int | None = None, *,
                    device: str | torch.device = "cpu") -> tuple[PyTree, dict]:
    """Restore into the structure of ``reference`` (its leaves, tensors or
    arrays, give each leaf's shape and dtype); returns ``(tree of tensors on
    device, extra)``. The payload may hold more leaves than the reference."""
    directory = pathlib.Path(directory)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    manifest = json.loads((directory / f"ckpt_{step:08d}.json").read_text())
    with np.load(directory / f"ckpt_{step:08d}.npz") as data:
        def restore(k: str, ref) -> torch.Tensor:
            if k not in data:
                raise KeyError(f"checkpoint missing leaf {k}")
            arr = data[k]
            shape = tuple(ref.shape) if hasattr(ref, "shape") else np.shape(ref)
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"shape mismatch for {k}: {arr.shape} vs {shape}")
            want, stored = _ref_dtype(ref)
            if arr.dtype.itemsize == stored.itemsize and arr.dtype.kind == "V":
                arr = arr.view(stored)  # bfloat16 as the JAX package writes it
            if arr.dtype != stored:
                raise ValueError(f"dtype mismatch for {k}: {arr.dtype} vs {stored}")
            t = torch.from_numpy(np.asarray(arr, order="C"))
            if want == torch.bfloat16:
                t = t.view(torch.int16).view(torch.bfloat16)
            return t.to(device)

        tree = _map_leaves(restore, reference)
    return tree, manifest.get("extra", {})
