"""Checkpointing with manifests, integrity hashes and async writes.

Mirrors :mod:`repro.checkpoint.manager`, with the same layout per step::

    <dir>/step_<N>/manifest.json     {step, extra, leaves: shape, dtype, sha256}
    <dir>/step_<N>/arrays.npz        one entry per leaf (its "/"-joined key)
    <dir>/step_<N>/COMMITTED         written last: a crash mid-write leaves no
                                     COMMITTED marker, so restore skips it

A tree is a nested dict whose leaves are tensors; its keys are
joined with "/", so the trainer's leaves are ``params/<state-dict name>``,
``opt/m/<name>``, ``opt/v/<name>`` and ``opt/step``.  NumPy has no
bfloat16: a bf16 tensor is stored as its raw 16-bit words with
``"bfloat16"`` in the manifest, so a restore gives the same bits.  The
hash covers the stored bytes.  :meth:`CheckpointManager.save` copies the
tree to host memory synchronously and writes it on a background thread;
one write is in flight at a time, and a failed write raises on the next
:meth:`wait`.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager"]

_BF16 = "bfloat16"


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flatten(v, f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _unflatten_like(like, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    return leaves[prefix[:-1]]


def _to_host(x) -> Tuple[np.ndarray, str]:
    """(stored array, manifest dtype) of one leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(
                np.uint16), _BF16
        a = x.numpy()
    else:
        a = np.asarray(x)
    return a, str(a.dtype)


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A stored array back as a tensor on ``device`` (bf16 from its raw
    words)."""
    if dtype == _BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        """Snapshot ``tree`` (host copy, synchronous) and write it (async)."""
        self.wait()   # one write in flight at a time
        host = {k: _to_host(v) for k, v in _flatten(tree)}

        def write():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        if self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self._raise_pending()

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, str]],
               extra: Dict) -> None:
        path = os.path.join(self.dir, f"step_{step:08d}")
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: a for k, (a, _dt) in host.items()})
        manifest = {
            "step": step,
            "extra": extra,
            "leaves": {k: {"shape": list(a.shape), "dtype": dt,
                           "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
                       for k, (a, dt) in host.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, name)
            if (name.startswith("step_")
                    and os.path.exists(os.path.join(full, "COMMITTED"))):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any,
                device_put: Optional[Callable[[str, torch.Tensor],
                                              Any]] = None,
                verify: bool = True) -> Any:
        """Restore into the structure of ``like``: each leaf comes back on
        the device of ``like``'s leaf, in the stored dtype, or as
        ``device_put(key, leaf)`` of the leaf on the CPU when given (the
        caller's own placement, as a reshard).  With ``verify`` a leaf
        whose bytes do not hash to the manifest's sha256 raises
        ``IOError``."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        manifest = self.manifest(step)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            flat = _flatten(like)
            missing = [k for k, _ in flat if k not in data]
            if missing:
                raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
            leaves = {}
            for k, lk in flat:
                arr = data[k]
                meta = manifest["leaves"][k]
                if verify and hashlib.sha256(arr.tobytes()).hexdigest() != \
                        meta["sha256"]:
                    raise IOError(f"checksum mismatch for {k}")
                if device_put is None:
                    leaves[k] = _from_host(arr, meta["dtype"], lk.device)
                else:
                    leaves[k] = device_put(k, _from_host(arr, meta["dtype"],
                                                         "cpu"))
        return _unflatten_like(like, leaves)

    def manifest(self, step: int) -> Dict:
        with open(os.path.join(self.dir, f"step_{step:08d}",
                               "manifest.json")) as f:
            return json.load(f)
