"""Carry teacher and student weights into the port.

The port keeps the reference's parameter pytree: nested dicts (and a list
under 'layers') of {'w', 'b'} or weight-normed {'v', 'g', 'b'} leaves with
conv kernels shaped [filter_length, in, out].  Only the leaves change, from
numpy arrays to float32 tensors.

The committed golden format (``tests/golden/tiny_*/params.npz``) stores
each leaf under its pytree key path, e.g. ``['layers'][0]['dilated']['w']``.
Large leaves are stored int8 with a per-last-axis scale as a pair of keys
``<path>#q`` (int8) and ``<path>#s`` (f32); the value is q * s in f32.
``save_npz`` writes plain f32 keys only (the training export).

``to_jax_params`` is the inverse of ``from_jax_params``: the port's params,
gradients or EMA as the same nesting of float32 numpy arrays, the JAX
package's layout.
"""

import os
import re

import numpy as np
import torch

_KEY_PART = re.compile(r"\[(?:'([^']*)'|(\d+))\]")


def _to_tensor(a, device):
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def from_jax_params(tree, device="cuda"):
    """Nested dicts / lists / tuples of numpy arrays -> the same nesting of
    float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, device) for v in tree]
    return _to_tensor(tree, device)


def to_jax_params(tree):
    """Nested dicts / lists of tensors -> the same nesting of float32 numpy
    arrays on the host."""
    if isinstance(tree, dict):
        return {k: to_jax_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_jax_params(v) for v in tree]
    return tree.detach().to("cpu", torch.float32).numpy()


def flatten(tree, prefix: str = "") -> dict:
    """Nested dicts / lists -> {key path: leaf}, paths like
    ``['layers'][0]['dilated']['w']``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}['{k}']"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def save_npz(path: str, tree):
    """Write a parameter pytree as a golden-format params.npz of plain f32
    keys (a temporary file renamed into place)."""
    flat = flatten(to_jax_params(tree))
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def dequantize_npz(stored: dict) -> dict:
    """{key path: array} with '#q'/'#s' pairs folded into f32 arrays."""
    out = {}
    for k, a in stored.items():
        if k.endswith("#q"):
            scale = stored[k[:-2] + "#s"]
            out[k[:-2]] = a.astype(np.float32) * scale.astype(np.float32)
        elif not k.endswith("#s"):
            out[k] = a
    return out


def _parse_path(key: str):
    parts, pos = [], 0
    for m in _KEY_PART.finditer(key):
        if m.start() != pos:
            raise ValueError(f"malformed key path {key!r}")
        parts.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
        pos = m.end()
    if pos != len(key) or not parts:
        raise ValueError(f"malformed key path {key!r}")
    return parts


def _listify(node):
    """Dicts whose keys are all ints 0..n-1 become lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"sparse list indices {sorted(node)}")
        return [node[i] for i in range(len(node))]
    return node


def unflatten(flat: dict):
    """{key path: array} -> nested dicts / lists of arrays."""
    root = {}
    for key, a in flat.items():
        parts = _parse_path(key)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return _listify(root)


def load_npz(path: str, device="cuda"):
    """Read a golden-format params.npz into the port's parameter pytree."""
    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}
    return from_jax_params(unflatten(dequantize_npz(stored)), device)
