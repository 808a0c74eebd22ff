"""JAX variables -> the port's state_dict.

Port of ``maunet_tpu/interop/torch_export.py`` (``_params_to_torch_arrays``
and ``variables_to_state_dict``, torch_export.py:28-82) that needs no JAX: it
takes the ``{"params", "batch_stats"}`` tree as nested dicts of numpy arrays
(``np.asarray`` of each leaf) and applies the same key and layout mapping:
conv HWIO -> OIHW, dense (in, out) -> (out, in), LSTM (in, 4H) -> (4H, in),
BN ``scale`` -> ``weight``, ``mean``/``var`` -> ``running_mean``/
``running_var``, ``fc0``/``fc2`` -> ``fc.0``/``fc.2``, all under ``model.``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _param_key_and_value(path: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    parts = path.split(".")
    leaf, scope = parts[-1], ".".join(parts[:-1])
    if leaf == "kernel" and arr.ndim == 4:      # conv HWIO -> OIHW
        key, val = scope + ".weight", arr.transpose(3, 2, 0, 1)
    elif leaf == "kernel":                       # dense (in, out) -> (out, in)
        key, val = scope + ".weight", arr.T
    elif leaf in ("w_ih", "w_hh"):               # LSTM (in, 4H) -> (4H, in)
        key, val = scope + f".lstm.weight_{leaf[2:]}_l0", arr.T
    elif leaf in ("b_ih", "b_hh"):
        key, val = scope + f".lstm.bias_{leaf[2:]}_l0", arr
    elif leaf == "scale":                        # BN gamma
        key, val = scope + ".weight", arr
    elif leaf == "bias":
        key, val = scope + ".bias", arr
    else:
        raise ValueError(f"Unrecognized param leaf: {path}")
    # MetadataEncoder fc0/fc2 -> torch Sequential fc.0/fc.2
    key = key.replace(".fc0.", ".fc.0.").replace(".fc2.", ".fc.2.")
    return "model." + key, val


def variables_from_flat(flat: Mapping[str, np.ndarray]) -> dict[str, dict]:
    """``{"params", "batch_stats"}`` nested dicts from a flat mapping with
    slash-separated keys (``"params/conv0_0/conv1/kernel"``), the layout in
    which ``tests/fixtures/golden_*.npz`` store a JAX variable tree."""
    tree: dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key in flat:
        scope, *path = key.split("/")
        if scope not in tree or not path:
            continue
        node = tree[scope]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(flat[key])
    return tree


def state_dict_from_jax(variables: dict[str, Any]) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` nested dicts of numpy arrays -> state_dict
    of :class:`maunet_tpu_torch.models.factory.UrbanPredictor`."""
    sd: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(variables["params"]).items():
        key, val = _param_key_and_value(path, arr)
        sd[key] = torch.from_numpy(np.array(val, dtype=np.float32, copy=True))
    for path, arr in _flatten(variables.get("batch_stats", {})).items():
        parts = path.split(".")
        leaf = {"mean": "running_mean", "var": "running_var"}[parts[-1]]
        scope = "model." + ".".join(parts[:-1])
        sd[f"{scope}.{leaf}"] = torch.from_numpy(
            np.array(arr, dtype=np.float32, copy=True))
        sd.setdefault(f"{scope}.num_batches_tracked",
                      torch.tensor(0, dtype=torch.int64))
    return sd
