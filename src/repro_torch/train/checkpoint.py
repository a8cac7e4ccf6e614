"""Checkpointing: CRC-verified, atomic, async, keep-k — plus GBATC-compressed
checkpoints with guaranteed per-block error bounds.

Port of the JAX package's ``train/checkpoint.py``, with its on-disk layout,
so a checkpoint written by either package restores in the other:

  <root>/step_<N>/
    manifest.json    # step, {key: shape, dtype, crc32}
    arrays.npz       # flat {key -> array}
  <root>/LATEST      # atomic pointer (written last)

Keys are the reference's: nested dict keys joined by ``/``, sorted at every
level. A dotted parameter name of the port (``layers.attn.wq``) is a path
of its own, so ``{"params": {"layers.attn.wq": w}}`` is stored under
``params/layers/attn/wq``, as the reference stores its nested tree.

Leaves: a tensor is stored as its numpy array; a bf16 tensor as its raw
2-byte words in a ``|V2`` array under manifest dtype ``"bfloat16"`` (what
``np.savez`` makes of the reference's bf16 leaves; no ``ml_dtypes``
needed), read back as bf16 through the manifest; a Python int (the
optimizer's step) as an int32 scalar, the reference's type. Restore puts
each array where the template has a leaf: a tensor on the template
tensor's device, an int as an int, anything else as the stored array.

GBATC mode (:func:`compress_state_bytes`) applies the paper's guarantee to
weights: each tensor is cut into 256-long blocks, "reconstructed" by the
reference's int8 block quantiser (numpy, so the codes are its codes bit
for bit), and the PCA-residual correction (Algorithm 1, the guarantee
engine, whose projection and select kernels run at D = 256 on the card)
tops every block up to the requested relative l2 bound. Codes are
Huffman + zstd coded.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import entropy, gae
from repro_torch.device import DeviceLike

BF16 = "bfloat16"


# ---------------------------------------------------------------------------
# tree <-> flat dict
# ---------------------------------------------------------------------------
def _is_bf16(a: np.ndarray) -> bool:
    """A bf16 leaf as numpy holds it: raw 2-byte words (``|V2``, what
    ``np.savez`` stores for the reference's bf16) or ``ml_dtypes``'
    bfloat16, as JAX hands it out."""
    return a.dtype.name == BF16 or (a.dtype.kind == "V" and a.dtype.itemsize == 2)


def _to_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    if isinstance(leaf, (bool, int)) and not isinstance(leaf, np.generic):
        return np.asarray(leaf, np.int32)
    a = np.asarray(leaf)
    return a.view("V2") if _is_bf16(a) else a


def _leaves(tree, path=()):
    """(path, leaf) pairs; a dotted key is a path of its own."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + tuple(str(k).split(".")))
    else:
        yield path, tree


def flatten_tree(tree) -> dict[str, np.ndarray]:
    """``{"a/b/c": array}`` in the reference's order (sorted at every
    level); bf16 leaves as ``|V2`` arrays."""
    return {"/".join(path): _to_array(leaf)
            for path, leaf in sorted(_leaves(tree), key=lambda pl: pl[0])}


def _from_array(a: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        if _is_bf16(a):
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        return t.to(like.device)
    if isinstance(like, (bool, int)) and not isinstance(like, np.generic):
        return int(a)
    return a


def unflatten_to(tree_like, flat: dict[str, np.ndarray]):
    """The template's structure with every leaf read from ``flat``."""
    def rec(node, path):
        if isinstance(node, dict):
            return {k: rec(v, path + tuple(str(k).split("."))) for k, v in node.items()}
        return _from_array(flat["/".join(path)], node)

    return rec(tree_like, ())


def _crc32(a: np.ndarray) -> int:
    """CRC32 of the array's bytes, without a copy of a contiguous array."""
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


# ---------------------------------------------------------------------------
# GBATC weight compression (guaranteed)
# ---------------------------------------------------------------------------
_BLOCK_D = 256


def _as_f32(x: np.ndarray) -> np.ndarray:
    if _is_bf16(x):
        bits = np.ascontiguousarray(x).view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)
    return x.astype(np.float32)


def _as_dtype_of(y: np.ndarray, like: np.ndarray) -> np.ndarray:
    """fp32 ``y`` in ``like``'s dtype (bf16: rounded to nearest even)."""
    if _is_bf16(like):
        t = torch.from_numpy(np.ascontiguousarray(y)).to(torch.bfloat16)
        return t.view(torch.int16).numpy().view(like.dtype)
    return y.astype(like.dtype)


def _compress_array(x: np.ndarray, tau_rel: float,
                    device: DeviceLike) -> tuple[np.ndarray, int]:
    """Guaranteed lossy compression of one tensor.

    Stage 1 ("AE reconstruction" analogue): int8 block quantization — the
    integer codes are Huffman+zstd coded, per-64 scales stored fp32.
    Stage 2: Algorithm 1 tops every 256-block up to
    ||block - rec||_2 <= tau_rel * rms * sqrt(D).
    Returns (reconstructed tensor, exact compressed bytes)."""
    flat = _as_f32(x).reshape(-1)
    pad = (-flat.size) % _BLOCK_D
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, _BLOCK_D)

    qmax = 127.0
    xb = blocks.reshape(-1, 64)
    scales = np.maximum(np.abs(xb).max(axis=1, keepdims=True), 1e-30) / qmax
    codes = np.clip(np.rint(xb / scales), -128, 127).astype(np.int64)
    rec = (codes * scales).reshape(-1, _BLOCK_D).astype(np.float32)

    rms = float(np.sqrt(np.mean(blocks**2))) or 1.0
    tau = tau_rel * rms * np.sqrt(_BLOCK_D)
    corrected, art = gae.guarantee(blocks, rec, tau, device=device)

    stream = entropy.zstd_bytes(entropy.huffman_encode(codes.reshape(-1)))
    nbytes = len(stream) + scales.size * 4 + art.total_bytes() + 32
    out = corrected.reshape(-1)
    if pad:
        out = out[:-pad]
    return _as_dtype_of(out.reshape(x.shape), x), nbytes


def compress_state_bytes(flat: dict[str, np.ndarray], tau_rel: float = 1e-3,
                         device: DeviceLike = None):
    """Compress a flat checkpoint dict with guaranteed error bounds; the
    guarantee engine runs on ``device`` (``None``: the GPU).

    Returns (reconstructed flat dict, total compressed bytes, report).
    Integer leaves and leaves under 1024 values are kept as they are. A
    leaf comes back in its own dtype, so a bf16 leaf is rounded to bf16
    after the correction (as the reference does)."""
    out = {}
    total = 0
    raw = 0
    for k, v in flat.items():
        raw += v.nbytes
        if v.size < 4 * _BLOCK_D or v.dtype.kind in "iu":
            out[k] = v
            total += v.nbytes
            continue
        out[k], nbytes = _compress_array(v, tau_rel, device)
        total += nbytes
    return out, total, {"raw_bytes": raw, "compressed_bytes": total,
                        "ratio": raw / max(total, 1)}


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CheckpointManager:
    root: str
    keep: int = 3
    async_write: bool = True

    def __post_init__(self):
        os.makedirs(self.root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ---- save -----------------------------------------------------------
    def save(self, step: int, tree, *, wait: bool = False) -> str:
        """Copy ``tree`` to the host now and write it (in a thread when
        ``async_write``, one write in flight at a time)."""
        flat = flatten_tree(tree)
        if self._thread is not None:
            self._thread.join()  # one in-flight write at a time

        def write():
            tmp = os.path.join(self.root, f".tmp_step_{step}")
            final = os.path.join(self.root, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {
                "step": step,
                "arrays": {
                    k: {
                        "shape": list(v.shape),
                        "dtype": BF16 if _is_bf16(v) else str(v.dtype),
                        "crc32": _crc32(v),
                    }
                    for k, v in flat.items()
                },
            }
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            with open(os.path.join(self.root, ".LATEST_tmp"), "w") as f:
                f.write(str(step))
            os.replace(os.path.join(self.root, ".LATEST_tmp"),
                       os.path.join(self.root, "LATEST"))
            self._gc()

        if self.async_write and not wait:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
        return os.path.join(self.root, f"step_{step}")

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                          ignore_errors=True)

    # ---- restore -----------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.root, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def restore(self, tree_like, step: Optional[int] = None) -> tuple[Any, int]:
        """Load, CRC-verify and place on ``tree_like``'s devices; returns
        (tree, step)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        d = os.path.join(self.root, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        for k, meta in manifest["arrays"].items():
            if _crc32(flat[k]) != meta["crc32"]:
                raise IOError(f"checkpoint corruption in {k} (crc mismatch)")
            if _is_bf16(flat[k]) != (meta["dtype"] == BF16):
                raise IOError(f"checkpoint array {k} is {flat[k].dtype}, the "
                              f"manifest says {meta['dtype']}")
        return unflatten_to(tree_like, flat), step
