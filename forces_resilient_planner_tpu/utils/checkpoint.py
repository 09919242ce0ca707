"""Checkpoint / resume for sweep jobs and warm-start caches.

The reference has no persistence (SURVEY.md section 5: all state ephemeral;
the only warm start is the in-memory previous MPC solution).  Long-running
Monte-Carlo sweeps here checkpoint batch state so multi-hour jobs survive
preemption.  Format: one npz of the pytree's leaves + a JSON sidecar.
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np


def save(path: str | Path, state, metadata: dict | None = None):
    """Save a pytree of arrays + metadata.  Returns the npz path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves, treedef = jax.tree.flatten(state)
    np.savez_compressed(
        path.with_suffix(".npz"),
        **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)},
    )
    path.with_suffix(".meta.json").write_text(
        json.dumps(
            {
                "format": "npz",
                "treedef": str(treedef),
                "n_leaves": len(leaves),
                **(metadata or {}),
            }
        )
    )
    return path.with_suffix(".npz")


def load(path: str | Path, like=None):
    """Load a checkpoint.  `like`: an example pytree giving the structure
    (leaves come back as a list without it)."""
    path = Path(path)
    npz_path = path if path.suffix == ".npz" else path.with_suffix(".npz")
    data = np.load(npz_path)
    leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    if like is None:
        return leaves
    treedef = jax.tree.structure(like)
    return jax.tree.unflatten(treedef, leaves)


class SweepCheckpointer:
    """Chunked Monte-Carlo sweeps with resume (BASELINE config 5 jobs)."""

    def __init__(self, directory: str | Path, chunk_results=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def done_chunks(self) -> set[int]:
        return {
            int(p.stem.split("_")[1])
            for p in self.dir.glob("chunk_*.npz")
        }

    def save_chunk(self, idx: int, result):
        save(self.dir / f"chunk_{idx}", result)

    def load_chunk(self, idx: int, like=None):
        return load(self.dir / f"chunk_{idx}", like=like)
