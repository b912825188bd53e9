"""Atomic, restartable checkpoints (counterpart of ``repro/checkpoint/ckpt.py``).

The reference's layout: one directory ``step_XXXXXXXX`` per step holding a
flat ``arrays.npz`` of every leaf under its tree path (``params/layers/
attn/wqkv``, ``opt/m/...``, ``opt/step``) and a JSON manifest (``step``,
``keys``, ``extra``, ``quant``, ``format``). Writes go to ``<dir>/tmp.<step>``
then ``os.replace()``: a partial write can never be mistaken for a complete
checkpoint.

Trees are nested dicts of tensors; an ``AdamWState`` (a NamedTuple) flattens
to its fields ``step``, ``m``, ``v``, and a ``QuantizedTensor`` to its
``qvalues`` and ``scales``, as the reference's pytrees do. The manifest's
``quant`` records each quantized leaf's format and group size, and restore
refuses a tree whose declared formats disagree (packed int4 read as int8
rows would be shape-valid and numerically garbage).

NumPy has no bfloat16 (nor float8), so such a leaf is stored as its bit
pattern (bf16 and fp16 as uint16, fp8 as uint8) and the manifest's
``dtypes`` records its torch dtype: restore gives the same bits back. (The
reference saves a bf16 leaf through ``ml_dtypes`` as a 2-byte void array
that its own restore cannot cast.) An f32 checkpoint the reference wrote
has no ``dtypes`` entry and restores as its arrays say.

Placed trees (DTensor leaves, ``dist/sharding.distribute``) save as the
reference's global arrays do: every rank gathers each leaf (a collective,
in ``tensor_items`` order), rank 0 alone writes, and all ranks leave
``save`` together. ``restore`` reads the full arrays and places each as
the ``like`` leaf is placed, on whatever mesh that is now: a checkpoint of
a 2 x 2 run restores onto 1 x 2 (the reference's elastic restart).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.quant import QuantizedTensor
from repro_torch.core.tree import tensor_items, tensor_map_with_path
from repro_torch.dist.sharding import gather_leaf, place_like

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"

# torch dtypes stored by bit pattern -> (the numpy type of the pattern, name)
_BITS = {torch.bfloat16: (np.uint16, "bfloat16"), torch.float16: (np.uint16, "float16"),
         torch.float8_e4m3fn: (np.uint8, "float8_e4m3fn")}
_BY_NAME = {name: dt for dt, (_, name) in _BITS.items()}


def _to_numpy(leaf) -> tuple[np.ndarray, str | None]:
    """A leaf as a numpy array, and the torch dtype name where it is stored
    by bit pattern."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), None
    t = leaf.detach().cpu().contiguous()
    if t.dtype in _BITS:
        bits, name = _BITS[t.dtype]
        return t.view(torch.int16 if bits == np.uint16 else torch.uint8).numpy().view(bits), name
    return t.numpy(), None


def _quant_meta(tree) -> dict:
    """{tree path: {"fmt", "group_size"}} for every QuantizedTensor leaf."""
    return {path: {"fmt": leaf.fmt, "group_size": leaf.group_size}
            for path, leaf in tensor_items(tree, quant=True) if isinstance(leaf, QuantizedTensor)}


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def save(directory: str, step: int, tree, extra: dict | None = None) -> str:
    """Atomically write checkpoint for ``step``. Returns the final path.
    With DTensor leaves every rank must call it (each leaf is gathered);
    rank 0 writes."""
    final = os.path.join(directory, f"step_{step:08d}")
    full = [(key, gather_leaf(leaf)) for key, leaf in tensor_items(tree)]
    if _rank() != 0:
        _barrier()
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes = {}, {}
    for key, leaf in full:
        arrays[key], name = _to_numpy(leaf)
        if name:
            dtypes[key] = name
    np.savez(os.path.join(tmp, ARRAYS), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "extra": extra or {},
        "quant": _quant_meta(tree),
        "format": 1,
        "dtypes": dtypes,
    }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _barrier()
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
            os.path.join(directory, name, MANIFEST)
        ):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _restore_leaf(key: str, arr: np.ndarray, saved_dtype: str | None, like) -> torch.Tensor:
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs {tuple(like.shape)}")
    if saved_dtype is not None:
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16 if arr.dtype == np.uint16 else np.uint8))
        t = bits.view(_BY_NAME[saved_dtype])
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    device = like.device if like.device.type != "meta" else torch.device("cpu")
    return t.to(device=device, dtype=like.dtype)


def restore(directory: str, like, step: int | None = None):
    """Restore into the structure of ``like`` (a tree of tensors, meta
    tensors included, shaped as the checkpoint's). Leaves come back with
    ``like``'s dtypes, on its leaves' devices (the CPU for meta leaves),
    placed as its DTensor leaves are. Returns (tree, step, extra)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    arrays = np.load(os.path.join(path, ARRAYS))
    saved_dtypes = manifest.get("dtypes", {})

    saved_q = manifest.get("quant")
    if saved_q is not None:
        for key, meta in _quant_meta(like).items():
            got = saved_q.get(key)
            if got is not None and got != meta:
                raise ValueError(
                    f"quantization mismatch for {key}: checkpoint has "
                    f"{got}, restore target expects {meta} — requantize "
                    "instead of reinterpreting packed qvalues"
                )

    tree = tensor_map_with_path(lambda key, node: place_like(
        _restore_leaf(key, arrays[key], saved_dtypes.get(key), node), node), like)
    return tree, manifest["step"], manifest["extra"]


def retain(directory: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` complete checkpoints (rank 0)."""
    if _rank() != 0 or not os.path.isdir(directory):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(directory) if n.startswith("step_")
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)
