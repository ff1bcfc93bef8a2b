"""Checkpointing: step-atomic, device-agnostic, async-capable, hash-verified.

The port of ``repro.checkpoint.manager``, with its files:

Layout:  <dir>/step_<N>/
            manifest.json        (step, flat keys, shapes, dtypes, sha256s,
                                  data cursor)
            arrays.npz           (flat key -> ndarray)
         <dir>/LATEST            (atomic pointer file)

so a checkpoint either package writes restores in the other (every leaf
of a train state is fp32 or int32). Arrays are saved as host copies and
placed on the ``device`` that ``restore`` is given, or, leaf by leaf, on
the mesh device of the ``shardings`` it is given (a sharding plan's
records, checked to split evenly: the elastic restore onto a new mesh).

Async mode ships the host copy off-thread so the train loop only blocks
on the device-to-host copy, not on disk I/O.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

SEP = "/"


def _flatten(tree, prefix=()) -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
    else:
        out[SEP.join(prefix)] = tree
    return out


def _unflatten(flat: dict[str, Any]) -> dict:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def _host(v) -> np.ndarray:
    """A host copy of a leaf: the caller may update the tensor in place
    while an async save writes the copy."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True).numpy()
    return np.array(v, copy=True)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = False

    def __post_init__(self):
        Path(self.directory).mkdir(parents=True, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: dict, extra: dict | None = None) -> str:
        """state: tree of tensors or arrays. Returns the checkpoint path."""
        host = {k: _host(v) for k, v in _flatten(state).items()}
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {})
            )
            self._thread.start()
            return str(Path(self.directory) / f"step_{step}")
        return self._write(step, host, extra or {})

    def _write(self, step: int, host: dict[str, np.ndarray], extra: dict) -> str:
        final = Path(self.directory) / f"step_{step}"
        tmp = Path(
            tempfile.mkdtemp(prefix=f".step_{step}_", dir=self.directory)
        )
        manifest = {
            "step": step,
            "extra": extra,
            "arrays": {
                k: {
                    "shape": list(v.shape),
                    "dtype": str(v.dtype),
                    "sha256": _sha(v),
                }
                for k, v in host.items()
            },
        }
        np.savez(tmp / "arrays.npz", **host)
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)                       # atomic publish
        latest = Path(self.directory) / "LATEST"
        tmp_latest = latest.with_suffix(".tmp")
        tmp_latest.write_text(str(step))
        os.replace(tmp_latest, latest)
        self._gc()
        return str(final)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(Path(self.directory) / f"step_{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for p in Path(self.directory).glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_", 1)[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        latest = Path(self.directory) / "LATEST"
        if latest.exists():
            s = int(latest.read_text().strip())
            if (Path(self.directory) / f"step_{s}" / "manifest.json").exists():
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, device=None,
                verify: bool = True, shardings=None) -> tuple[int, dict, dict]:
        """Returns (step, state, extra): the state a tree of tensors on
        ``device``, or on the host when it is None (the reference's
        restore without shardings). ``shardings``: an optional tree of
        ``launch.policy.NamedSharding`` records (a plan's, for a possibly
        different mesh); each leaf it names goes to its mesh's device,
        global, after a check that every dim it shards splits evenly."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = Path(self.directory) / f"step_{step}"
        manifest = json.loads((path / "manifest.json").read_text())
        with np.load(path / "arrays.npz") as z:
            host = {k: z[k] for k in z.files}
        if verify:
            for k, meta in manifest["arrays"].items():
                if _sha(host[k]) != meta["sha256"]:
                    raise IOError(f"checkpoint corruption in {k} at step {step}")
        flat_shardings = _flatten(shardings) if shardings is not None else {}
        placed = {}
        for k, v in host.items():
            t = torch.from_numpy(v)
            s = flat_shardings.get(k)
            if s is not None:
                s.apply(t)                 # raises unless the blocks split evenly
                t = t.to(s.mesh.device)
            elif device is not None:
                t = t.to(device)
            placed[k] = t
        return step, _unflatten(placed), manifest["extra"]
