"""Checkpoint manager: atomic, async, retention-limited, with an optional
guaranteed-error-bounded lossy codec for the float32 bulk (counterpart of
`repro.checkpoint.manager`: the paper's technique on the storage path).

  * atomic publish: write to <dir>/tmp-<step>/ then os.rename to
    step-<step>: a reader never sees a torn checkpoint.
  * async save: `save` copies every leaf to host memory of its own (a
    CPU leaf too, since a step may update the state in place), the
    files are written on a worker thread; `wait()` joins before the next
    save.
  * retention: keep the newest `keep` checkpoints.
  * restore picks the highest complete step; partial directories (no
    manifest) are skipped.

The leaves are the tree's in the reference's order (`repro_torch.tree`),
one file each, `leaf-NNNNN.npy` byte for byte as the reference writes it
for the same tree (bfloat16 leaves as the reference's '<V2' records of
the raw bits).  Lossy mode serializes float32 leaves of more than 1024
values through `core.serializer` (ABS, inline exact outliers): a restored
value is within eb of the saved one.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from .. import tree as T
from ..core.config import QuantizerConfig
from ..core.pipeline import resolve_device
from ..core.serializer import deserialize, serialize

_MANIFEST = "manifest.json"
_BF16_DESCR = "<V2"      # how numpy records the reference's bfloat16


def _to_host(x) -> np.ndarray:
    """A copy of a leaf as numpy, shared with nothing: bfloat16 as its
    uint16 bits."""
    t = torch.as_tensor(x).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _save_leaf(path: str, arr: np.ndarray, bf16: bool) -> None:
    if not bf16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def _from_host(arr: np.ndarray, dtype: str, dev) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.array(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr.astype(dtype)).to(dev)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 lossy: QuantizerConfig | None = None):
        self.dir = directory
        self.keep = keep
        self.lossy = lossy
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree, blocking: bool = False):
        """Snapshot `tree` (a tree of tensors) at `step`."""
        self.wait()
        leaves, treedef = T.flatten(tree)
        bf16 = [torch.as_tensor(x).dtype == torch.bfloat16 for x in leaves]
        host = [_to_host(x) for x in leaves]       # the snapshot

        def _work():
            tmp = os.path.join(self.dir, f"tmp-{step}")
            final = os.path.join(self.dir, f"step-{step:012d}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "n_leaves": len(host),
                        "treedef": repr(treedef),
                        "lossy": bool(self.lossy), "leaves": []}
            for i, (leaf, is_bf16) in enumerate(zip(host, bf16)):
                path = os.path.join(tmp, f"leaf-{i:05d}.npy")
                entry = {"dtype": "bfloat16" if is_bf16 else str(leaf.dtype),
                         "shape": list(leaf.shape)}
                if (self.lossy is not None and leaf.dtype == np.float32
                        and leaf.size > 1024):
                    stream = serialize(leaf.reshape(-1), self.lossy)
                    with open(path + ".lc", "wb") as f:
                        f.write(stream)
                    entry["codec"] = "lc"
                else:
                    _save_leaf(path, leaf, is_bf16)
                    entry["codec"] = "raw"
                manifest["leaves"].append(entry)
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f)
            os.rename(tmp, final)                    # atomic publish
            self._retain()

        if blocking:
            _work()
        else:
            self._thread = threading.Thread(target=_work, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _retain(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:012d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if not name.startswith("step-"):
                continue
            if os.path.exists(os.path.join(self.dir, name, _MANIFEST)):
                out.append(int(name.split("-")[1]))
        return out

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None, *, device=None):
        """Restore into the structure of `template` (a tree of tensors,
        e.g. on the "meta" device).  The leaves go to `device`, by default
        the template's; a meta template needs `device` (the card unless
        the caller passes "cpu").  Returns (tree, step) or (None, None)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        t_leaves, treedef = T.flatten(template)
        if device is None:
            device = t_leaves[0].device if t_leaves else "cpu"
            if torch.device(device).type == "meta":
                raise ValueError("a template on the meta device needs "
                                 "device=")
        dev = resolve_device(device)
        d = os.path.join(self.dir, f"step-{step:012d}")
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
        if len(t_leaves) != manifest["n_leaves"]:
            raise ValueError(f"the template has {len(t_leaves)} leaves, the "
                             f"checkpoint {manifest['n_leaves']}")
        leaves = []
        for i, entry in enumerate(manifest["leaves"]):
            path = os.path.join(d, f"leaf-{i:05d}.npy")
            if entry["codec"] == "lc":
                with open(path + ".lc", "rb") as f:
                    arr, _ = deserialize(f.read())
                arr = arr.reshape(entry["shape"])
            else:
                arr = np.load(path)
            leaves.append(_from_host(arr, entry["dtype"], dev))
        return T.unflatten(treedef, leaves), step
