"""Checkpoint store: npz snapshots of a state tree with a JSON manifest
(torch twin of ``repro.checkpoint.store``, on the same files).

Elasticity is the point (paper §6): params and optimizer state are
replicated, so a checkpoint written at w workers restores bit-identically
at any w' — the restart only changes the batch and the LR (eq. 7).

The files are the reference's: ``ckpt_{step:010d}.npz`` keyed by the
``/``-joined paths of the state tree (``params/...`` and ``opt/mu/...`` f32,
``step`` int32, ``epoch`` f32) beside a ``ckpt_{step:010d}.json`` manifest,
so a checkpoint of either package restores in the other. ``restore`` copies
into the template's tensors in place: a FlatTree's leaves stay views of
its flat buffer.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from repro_torch.models.spec import flatten


def _flatten(tree: dict) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in flatten(tree).items()}


def _fill(template: dict, flat: dict[str, np.ndarray]) -> dict:
    """Copy each array of ``flat`` into the template's tensor at its path;
    returns when the copies are done."""
    leaves = flatten(template)
    for key, leaf in leaves.items():
        if key not in flat:
            raise KeyError(f"checkpoint missing {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint {key!r}: shape {arr.shape}, "
                             f"state wants {tuple(leaf.shape)}")
        with torch.no_grad():
            leaf.copy_(torch.as_tensor(arr))
    for dev in {leaf.device for leaf in leaves.values() if leaf.is_cuda}:
        torch.cuda.synchronize(dev)
    return template


class CheckpointStore:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:010d}.npz")

    def _meta_path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:010d}.json")

    def save(self, step: int, state: dict, meta: dict | None = None
             ) -> float:
        """Write a checkpoint; returns wall seconds spent.

        Both the array file and the manifest sidecar go through a
        tmp-file + ``os.replace`` dance, so a crash mid-write leaves
        either the previous snapshot or a stray tmp file — never a
        half-written ``ckpt_*`` that a later restore would trust.
        """
        t0 = time.perf_counter()
        flat = _flatten(state)
        tmp = os.path.join(self.dir, f".tmp_ckpt_{step:010d}.npz")
        np.savez(tmp[:-4], **flat)  # np.savez appends .npz itself
        os.replace(tmp, self._path(step))
        manifest = {"step": step, "meta": meta or {},
                    "time": time.time()}
        mtmp = self._meta_path(step) + ".tmp"
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, self._meta_path(step))
        return time.perf_counter() - t0

    def steps(self) -> list[int]:
        out = []
        for fn in os.listdir(self.dir):
            if fn.startswith("ckpt_") and fn.endswith(".npz"):
                try:
                    out.append(int(fn[5:-4]))
                except ValueError:  # stray/foreign file, not a snapshot
                    continue
        return sorted(out)

    def _load_arrays(self, step: int) -> dict[str, np.ndarray]:
        with np.load(self._path(step)) as z:
            return {k: z[k] for k in z.files}

    def _load_meta(self, step: int) -> dict:
        """Manifest meta, or {} when the sidecar is missing/corrupt —
        the arrays are the checkpoint; the sidecar is advisory."""
        try:
            with open(self._meta_path(step)) as f:
                return json.load(f)["meta"]
        except (OSError, ValueError, KeyError):
            return {}

    def latest_step(self) -> int | None:
        """Newest step whose array file is readable; snapshots truncated
        by a crash mid-write (pre-atomic-rename layouts, torn disks) are
        skipped rather than returned as restore targets."""
        for step in reversed(self.steps()):
            try:
                with np.load(self._path(step)) as z:
                    len(z.files)
                return step
            except Exception:
                continue
        return None

    def restore(self, template: dict, step: int | None = None
                ) -> tuple[dict, dict, float]:
        """-> (state, meta, seconds); ``state`` is ``template``, filled in
        place.

        With ``step=None`` the newest *readable* snapshot wins: a
        corrupt/truncated ``.npz`` is skipped and the next older one is
        tried, so a torn write costs one checkpoint interval of
        progress, not the whole run.  An explicit ``step`` is trusted —
        corruption there raises.
        """
        t0 = time.perf_counter()
        if step is not None:
            state = _fill(template, self._load_arrays(step))
            return state, self._load_meta(step), time.perf_counter() - t0
        candidates = self.steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        for s in reversed(candidates):
            try:
                flat = self._load_arrays(s)
            except Exception:
                continue  # torn snapshot: fall back to the next older
            state = _fill(template, flat)
            return state, self._load_meta(s), time.perf_counter() - t0
        raise FileNotFoundError(f"no readable checkpoint in {self.dir}")
