"""Train-state checkpoints on local disk.

The port's counterpart of ``equss_tpu/core/checkpoint.py`` (Orbax there),
with the same interface: ``CheckpointManager(directory, max_to_keep=2)``,
``save(step, state, *, metadata=None, wait=False)``, ``restore(step=None,
template=None)``, ``latest_step()`` and ``close()``.

A step is the directory ``<directory>/<step>`` holding ``state.pt`` (one
``torch.save`` of the state with every tensor copied to the CPU) and,
with metadata, ``metadata.json``.  A save writes into a hidden temporary
directory and renames it into place (``os.replace``), so a save that
fails or is interrupted leaves no step behind that would restore, and the
steps before it as they were.  Only the newest ``max_to_keep`` steps are
kept.  Loads use ``torch.load(..., weights_only=True)``: a checkpoint
holds tensors, numbers, strings and containers, nothing that runs code.
Saves finish before ``save`` returns, so ``wait`` has nothing to wait for.
On several processes (``parallel/mesh.py``) every rank calls ``save``:
rank 0 writes and the others wait at a barrier until it has, so each
rank may then ``restore`` the step.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from equss_tpu_torch.parallel import mesh

STATE_FILE = "state.pt"
METADATA_FILE = "metadata.json"


def _to_cpu(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor detached and on the CPU."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _structure(tree: Any, prefix: str = "") -> List[str]:
    """The dotted paths of ``tree``'s dict keys, for the template check."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _structure(v, f"{prefix}{k}.")]
    return [prefix.rstrip(".")]


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 2) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        """The steps that would restore, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.isfile(os.path.join(self.directory, name, STATE_FILE)))

    def save(self, step: int, state: Dict[str, Any], *,
             metadata: Optional[Dict[str, Any]] = None, wait: bool = False) -> None:
        if mesh.rank() == 0:
            self._write(step, state, metadata)
        mesh.barrier()

    def _write(self, step: int, state: Dict[str, Any],
               metadata: Optional[Dict[str, Any]]) -> None:
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            torch.save(_to_cpu(state), os.path.join(tmp, STATE_FILE))
            if metadata:
                with open(os.path.join(tmp, METADATA_FILE), "w") as f:
                    json.dump(metadata, f)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def restore(self, step: Optional[int] = None,
                template: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The state saved at ``step`` (the latest when None), on the CPU.
        With a ``template`` its dict structure must match the saved one."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint in {self.directory}")
        path = os.path.join(self._step_dir(step), STATE_FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"No checkpoint for step {step} in {self.directory}")
        state = torch.load(path, map_location="cpu", weights_only=True)
        if template is not None and sorted(_structure(template)) != sorted(_structure(state)):
            raise ValueError(f"checkpoint {path} does not match the template's structure")
        return state

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        pass
