"""Checkpoints of the whole train state with exact resume to the step.

Counterpart of `clip_dplm_tpu/train/checkpoint.py` (Orbax there, `torch.save`
here). A checkpoint holds what the JAX package's holds, in the port's form
(`arrays_only`): the parameters by their flax scope paths joined with dots
(`tower_a.layers_0.kernel`; Dense kernels (out, in)), the optimizer's
state: the fused AdamW's `count`, `mu`, `nu` (in their stored dtype: bf16
under `optim.moment_dtype=bfloat16`; only the trained leaves where LoRA masks
the frozen ones) and `prev_norm`, or under `optim.fused_update=false` the
optax chain's `count`, `mu` and `nu` (train/state.py::AdamWChain), the
`step`, the integer dropout `key`, and
with `contrastive.use_cache` the hard-negative `cache`, `cache_ptr` and
`cache_len`. Restoring it and taking the next steps gives the same bytes as
never stopping: a step's dropout seeds are hashed from (key, step).

Each step is one file, `ckpt_<step>.pt`, written under a temporary name,
synced and moved into place with `os.replace`, so a kill during a write never
leaves a half-written latest step. The newest `keep` steps stay (Orbax's
`max_to_keep`), and a save at or below the latest step is skipped, as
Orbax's is. Files hold only tensors, ints and dicts, and load with
`torch.load(weights_only=True)` onto the state's device.

`restore` is strict, as Orbax's `StandardRestore`: a missing or extra leaf,
or a leaf whose shape, dtype or type differs, raises and names it (a cached
checkpoint restored into an uncached state; a LoRA state, whose frozen
leaves have no moments, restored into a full one). The JAX package's
fallback for a checkpoint written under another `train.rng_impl` has no
counterpart: the port's key is one integer and `train.rng_impl` is not
ported.

With `async_save`, `save` copies every tensor into host memory on the
current CUDA stream (pinned buffers, kept for the next save), records an
event, and returns; a writer thread waits on the event, then writes the
file. The fused AdamW updates parameters and moments in place, and the next
step's updates are queued on the same stream after the copy, so the file
holds the state of the step that was saved, not a torn mix. `wait`,
`latest_step`, `restore` and the next `save` wait for a write in flight.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
from typing import Any, Dict, List, Optional

import torch

_FILE = re.compile(r"^ckpt_(\d+)\.pt$")


def arrays_only(state) -> Dict[str, Any]:
    """The saved leaves of a TrainState as a nested dict of its live
    tensors and ints (the cache's three only with a cache)."""
    opt = state.opt_state
    tree = {"step": state.step, "key": state.key,
            "params": dict(state.model.named_parameters()),
            "opt_state": {f.name: getattr(opt, f.name) for f in dataclasses.fields(opt)}}
    if state.cache is not None:
        tree.update(cache=state.cache, cache_ptr=state.cache_ptr, cache_len=state.cache_len)
    return tree


def _check(saved, live, path: str) -> None:
    """Raise unless `saved` has the leaves of `live`, no more, each of the
    same type, and every tensor of the same shape and dtype."""
    where = path or "the checkpoint"
    if isinstance(live, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"{where}: a {type(saved).__name__} where the state has a subtree")
        missing = sorted(set(live) - set(saved))
        extra = sorted(set(saved) - set(live))
        if missing or extra:
            raise KeyError(f"{where}: leaves missing from the checkpoint "
                           f"{[f'{path}.{k}'.lstrip('.') for k in missing]}, leaves the state "
                           f"lacks {[f'{path}.{k}'.lstrip('.') for k in extra]}")
        for k in live:
            _check(saved[k], live[k], f"{path}.{k}".lstrip("."))
    elif isinstance(live, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"{where}: a {type(saved).__name__} where the state has a tensor")
        if saved.shape != live.shape or saved.dtype != live.dtype:
            raise ValueError(f"{where}: the checkpoint's {tuple(saved.shape)} {saved.dtype} does "
                             f"not fit the state's {tuple(live.shape)} {live.dtype}")
    elif type(saved) is not type(live):
        raise ValueError(f"{where}: a {type(saved).__name__} where the state has a "
                         f"{type(live).__name__}")


@torch.no_grad()
def _copy_into(saved, live) -> None:
    if isinstance(live, dict):
        for k in live:
            _copy_into(saved[k], live[k])
    elif isinstance(live, torch.Tensor):
        live.copy_(saved)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep, self.async_save = keep, async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._host: Dict[str, torch.Tensor] = {}  # pinned buffers by leaf path

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def _steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_FILE.match, os.listdir(self.directory)) if m)

    def all_steps(self) -> List[int]:
        self.wait()
        return self._steps()

    def _snapshot(self, tree, path: str = ""):
        """A copy of `tree` in host memory; CUDA tensors copied without a
        wait on the current stream into pinned buffers."""
        if isinstance(tree, dict):
            return {k: self._snapshot(v, f"{path}.{k}") for k, v in tree.items()}
        if not isinstance(tree, torch.Tensor):
            return tree
        t = tree.detach()
        if not t.is_cuda:
            return t.clone()
        buf = self._host.get(path)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._host[path] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t, non_blocking=True)

    def _write(self, snapshot, event, step: int) -> None:
        try:
            if event is not None:
                event.synchronize()
            tmp = os.path.join(self.directory, f".ckpt_{step}.pt.tmp")
            with open(tmp, "wb") as f:
                torch.save(snapshot, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(step))
            for old in self._steps()[:-self.keep] if self.keep > 0 else []:
                os.remove(self._path(old))
        except BaseException as err:  # raised again by wait()
            self._error = err

    def save(self, state, step: int) -> bool:
        """Save `state` as `step`; False (nothing written) when the latest
        step is at or past it."""
        self.wait()
        steps = self._steps()
        if steps and steps[-1] >= step:
            return False
        tree = arrays_only(state)
        snapshot = self._snapshot(tree)
        event = None
        if next(state.model.parameters()).is_cuda:
            event = torch.cuda.Event()
            event.record()
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=(snapshot, event, step),
                                            name=f"checkpoint-{step}")
            self._thread.start()
        else:
            self._write(snapshot, event, step)
            self.wait()
        return True

    def wait(self) -> None:
        """Block until a write in flight is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"writing a checkpoint under {self.directory} failed") from err

    def close(self) -> None:
        self.wait()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state, step: Optional[int] = None):
        """Load `step` (the latest when None) into `state` in place, onto
        its device, and return it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        self.wait()
        device = next(state.model.parameters()).device
        saved = torch.load(self._path(step), map_location=device, weights_only=True)
        live = arrays_only(state)
        _check(saved, live, "")
        _copy_into(saved, live)
        state.step, state.key = saved["step"], saved["key"]
        state.opt_state.count = saved["opt_state"]["count"]
        return state
