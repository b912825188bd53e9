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
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.core.quant import QuantizedTensor

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"

# torch dtypes stored by bit pattern -> (the numpy type of the pattern, name)
_BITS = {torch.bfloat16: (np.uint16, "bfloat16"), torch.float16: (np.uint16, "float16"),
         torch.float8_e4m3fn: (np.uint8, "float8_e4m3fn")}
_BY_NAME = {name: dt for dt, (_, name) in _BITS.items()}


def _items(tree, prefix: str = "", quant: bool = False) -> list[tuple[str, object]]:
    """(path, leaf) in the reference's flatten order: dict keys sorted,
    NamedTuple fields and QuantizedTensor children in their own order
    (``quant`` keeps QuantizedTensor leaves whole)."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return [it for k in sorted(tree) for it in _items(tree[k], join(k), quant)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [it for k in tree._fields for it in _items(getattr(tree, k), join(k), quant)]
    if isinstance(tree, QuantizedTensor) and not quant:
        return [(join("qvalues"), tree.qvalues), (join("scales"), tree.scales)]
    return [(prefix, tree)]


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
            for path, leaf in _items(tree, quant=True) if isinstance(leaf, QuantizedTensor)}


def save(directory: str, step: int, tree, extra: dict | None = None) -> str:
    """Atomically write checkpoint for ``step``. Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f"tmp.{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes = {}, {}
    for key, leaf in _items(tree):
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
    ``like``'s dtypes, on its leaves' devices (the CPU for meta leaves).
    Returns (tree, step, extra)."""
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

    def build(node, prefix: str):
        def join(k):
            return f"{prefix}/{k}" if prefix else str(k)

        if isinstance(node, dict):
            return {k: build(v, join(k)) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(getattr(node, k), join(k)) for k in node._fields))
        if isinstance(node, QuantizedTensor):
            return QuantizedTensor(build(node.qvalues, join("qvalues")),
                                   build(node.scales, join("scales")), node.group_size, node.fmt)
        return _restore_leaf(prefix, arrays[prefix], saved_dtypes.get(prefix), node)

    return build(like, ""), manifest["step"], manifest["extra"]


def retain(directory: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` complete checkpoints."""
    if not os.path.isdir(directory):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(directory) if n.startswith("step_")
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)
