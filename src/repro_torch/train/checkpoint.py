"""Checkpoints in the JAX package's on-disk format (port of
``repro.train.checkpoint``), so that a checkpoint written by either
framework restores in the other.

A checkpoint of step ``s`` is the directory ``step_{s:010d}`` holding one
``.npy`` file per leaf of the state tree (the leaf's ``.``-joined key path
is its name) and ``manifest.json``: ``{"step", "extra", "leaves": {name:
{"file", "shape", "dtype"}}}``.  bfloat16 is stored as its ``uint16`` view
and the float8 types as ``uint8`` views, each with its logical dtype in the
manifest (the reference's ``ml_dtypes`` types; here through ``torch``
views).  A save writes into a temporary directory and publishes it with one
atomic ``os.rename``, so a crash mid-save never corrupts the latest
checkpoint; the manager keeps the newest ``keep``.  ``extra`` carries the
data pipeline's cursor (``{"data_serial": n}``) for exactly-once resume.

The reference's ``restore(shardings=...)`` places leaves on a mesh; the
port has no mesh yet, and ``restore(device=...)`` puts every leaf on one
device (the card unless the caller says ``"cpu"``).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

from .. import default_device
from ..tree import flatten, unflatten

# logical dtype -> (torch dtype, the unsigned view stored in the .npy file)
_VIEW_OF = {
    "bfloat16": (torch.bfloat16, torch.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8),
}
_LOGICAL = {torch_dt: name for name, (torch_dt, _) in _VIEW_OF.items()}


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the array written to disk, the logical dtype name)."""
    t = t.detach().to("cpu")
    if t.dtype in _LOGICAL:
        name = _LOGICAL[t.dtype]
        return t.view(_VIEW_OF[name][1]).numpy(), name
    host = t.numpy()
    return host, str(host.dtype)


def _from_host(host: np.ndarray, logical: str) -> torch.Tensor:
    t = torch.from_numpy(host)
    return t.view(_VIEW_OF[logical][0]) if logical in _VIEW_OF else t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: dict, extra: Optional[dict] = None) -> str:
        """state: nested dict of tensors on any device.  extra: JSON-serializable
        metadata (e.g. {"data_serial": 12345}, the ordered stream's replay
        cursor).  Returns the published directory."""
        flat = flatten(state)
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_save_")
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for name, t in flat.items():
            host, logical = _to_host(t)
            fname = name.replace("/", "_") + ".npy"
            np.save(os.path.join(tmp, fname), host)
            manifest["leaves"][name] = {
                "file": fname,
                "shape": list(host.shape),
                "dtype": logical,
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(self.directory, f"step_{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"))

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_"):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device=None) -> tuple[int, dict, dict]:
        """Returns (step, state, extra), every leaf a new tensor on
        ``device`` (``None``: the card; raises without one)."""
        dev = default_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        for name, meta in manifest["leaves"].items():
            host = np.load(os.path.join(path, meta["file"]))
            flat[name] = _from_host(host, meta["dtype"]).to(dev)
        return manifest["step"], unflatten(flat), manifest["extra"]


__all__ = ["CheckpointManager"]
