"""State checkpointing: npz payload + json manifest, atomic, step-indexed.

PyTorch counterpart of ``repro.checkpoint.checkpoint``, with the same files:
``ckpt_<step>.npz`` holds every entry of a flat ``{name: tensor}`` state by
its name (the JAX package's tree-path key of a dict entry, ``_name_``),
``ckpt_<step>.json`` the manifest ``{"step", "keys", "extra"}``. Tensors are
saved as numpy arrays and restored against a reference state
(shape-checked, cast to the reference's dtype) on the caller's device.
Atomicity via write-to-tmp + rename, the manifest before the payload.
"""

from __future__ import annotations

import json
import pathlib
import re
import tempfile

import numpy as np
import torch

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def _key(name: str) -> str:
    """The payload key of state entry ``name`` (a dict path, as in JAX)."""
    return _SAFE.sub("_", f"[{name!r}]")


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_checkpoint(directory: str | pathlib.Path, step: int, state: dict,
                    extra: dict | None = None) -> pathlib.Path:
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    payload = {_key(name): _numpy(v) for name, v in state.items()}
    manifest = {
        "step": int(step),
        "keys": sorted(payload),
        "extra": extra or {},
    }
    final = directory / f"ckpt_{step:08d}.npz"
    with tempfile.NamedTemporaryFile(dir=directory, suffix=".tmp", delete=False) as f:
        np.savez(f, **payload)
        tmp = pathlib.Path(f.name)
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


def load_checkpoint(directory: str | pathlib.Path, reference: dict,
                    step: int | None = None, *,
                    device: str | torch.device = "cpu") -> tuple[dict, dict]:
    """Restore the entries of ``reference`` (name -> tensor or array giving
    shape and dtype); returns ``(state of tensors on device, extra)``."""
    directory = pathlib.Path(directory)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    data = np.load(directory / f"ckpt_{step:08d}.npz")
    manifest = json.loads((directory / f"ckpt_{step:08d}.json").read_text())
    state = {}
    for name, ref in reference.items():
        k = _key(name)
        if k not in data:
            raise KeyError(f"checkpoint missing leaf {k}")
        arr = data[k]
        want = _numpy(ref)
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch for {k}: {arr.shape} vs {want.shape}")
        state[name] = torch.from_numpy(np.ascontiguousarray(arr.astype(want.dtype))).to(device)
    return state, manifest.get("extra", {})
