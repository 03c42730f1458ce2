"""Reading a checkpoint that the JAX package's orbax `Checkpointer`
(bm2f_tpu/train/checkpoint.py) wrote, without orbax, which imports JAX.

The layout (orbax-checkpoint 0.11, `StandardSave`): a directory per step,
`<step>/default/_METADATA` a JSON file whose `tree_metadata` lists every
leaf's key path, and the arrays zarr v2 inside an OCDBT key-value store in
`<step>/default`, each under its keys joined by dots ("params.a.kernel").
The arrays are read with `tensorstore` (its zarr format over the `ocdbt`
kvstore), which this module imports only when it reads; without it,
reading raises an ImportError that names it. Where tensorstore is missing,
convert the checkpoint elsewhere with `python -m
bm2f_tpu_torch.tools.convert_orbax` and load the port's checkpoint it
writes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

ITEM = "default"
METADATA = "_METADATA"
_DICT_KEY, _SEQUENCE_KEY = 2, 1


def orbax_steps(directory) -> list:
    """The steps of an orbax checkpoint directory, oldest first (empty when
    it is not one)."""
    d = Path(directory)
    if not d.is_dir():
        return []
    return sorted(int(p.name) for p in d.iterdir()
                  if p.name.isdigit() and (p / ITEM / METADATA).is_file())


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading an orbax checkpoint needs the 'tensorstore' package, which "
            "is not installed; convert the checkpoint where it is with `python -m "
            "bm2f_tpu_torch.tools.convert_orbax <orbax_dir> <port_checkpoint_dir>` "
            "and load the port's checkpoint") from e
    return tensorstore


def read_orbax(directory, step: Optional[int] = None) -> Dict[str, Any]:
    """The whole tree of `step` (the latest when None) as nested dicts of
    numpy arrays: dict keys as they were, sequence indices as int keys.
    Leaves orbax stored no array for (empty tuples, None) are left out."""
    steps = orbax_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no orbax checkpoint in {directory}")
    step = steps[-1] if step is None else step
    item = (Path(directory) / str(step) / ITEM).resolve()
    meta = json.loads((item / METADATA).read_text())
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{item}: only OCDBT-backed zarr v2 checkpoints are read "
                         f"(use_ocdbt={meta.get('use_ocdbt')}, "
                         f"use_zarr3={meta.get('use_zarr3')})")
    ts = _tensorstore()
    tree: Dict[Any, Any] = {}
    for entry in meta["tree_metadata"].values():
        if entry["value_metadata"].get("skip_deserialize", False):
            continue
        keys = [k["key"] if k["key_type"] == _DICT_KEY else int(k["key"])
                for k in entry["key_metadata"]]
        spec = {"driver": "zarr",
                "kvstore": {"driver": "ocdbt", "base": f"file://{item}/",
                            "path": ".".join(str(k) for k in keys)}}
        array = np.asarray(ts.open(spec, open=True).result().read().result())
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = array
    return tree


def read_orbax_variables(directory, step: Optional[int] = None) -> Dict[str, Any]:
    """The model variables ({"params"[, "frozen"]}) of a checkpoint holding a
    whole TrainState or bare variables, as `Checkpointer.restore_variables`
    (bm2f_tpu/train/checkpoint.py:45-63) takes both."""
    raw = read_orbax(directory, step)
    if "params" not in raw:
        raise KeyError(f"orbax checkpoint {directory} has no 'params' (keys: {list(raw)})")
    variables = {"params": raw["params"]}
    if raw.get("frozen"):
        variables["frozen"] = raw["frozen"]
    return variables
