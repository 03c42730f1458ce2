"""The reference's backbones, one plain-PyTorch file each, found by the
name a configuration gives (`arch.backbone.name`, `<name>.py` here). A
file imports nothing of the system under test and exposes:

- `PORT_NAME`: the port's `model.backbone.name`;
- `PORT_KEYS`: its sizes and settings (the keys of `arch.backbone`) ->
  the port's config paths, which the harness holds equal at set-up;
- `param_specs(sizes)`: (name, shape, kind) of its weights, under
  `backbone.`, named as the port's `state_dict` names them;
- `channels(sizes)`: the channels of `res2`..`res5`;
- `forward(x, P, sizes)`: normalised (B, 3, H, W) in, {"res2".."res5"}
  out, at strides 4, 8, 16, 32;

and optionally:
- `KINDS`: its own weight kinds -> standard deviation; the seeded weights
  draw them as N(0, std^2) with the other random kinds, in spec order. A
  kind of the head's (`HEAD_KINDS`) may not be among them.

Which weights train and take weight decay follows their names
(`reference/optim.py`), for every backbone alike.
"""

from __future__ import annotations

import hashlib
import importlib.util
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent
# the weight kinds that the seeded weights draw or set by themselves
HEAD_KINDS = ("fan_in", "class", "embed", "one", "zero", "ring")

_loaded: Dict[Path, ModuleType] = {}


def load(name: str, base: Path = HERE) -> ModuleType:
    """The backbone file `<base>/<name>.py`, run once a process and kept in
    `sys.modules` (as dataclasses and pickle look a module up there)."""
    path = (Path(base) / f"{name}.py").resolve()
    if path in _loaded:
        return _loaded[path]
    if not path.is_file():
        raise FileNotFoundError(f"no backbone {name!r}: looked for {path}")
    tag = hashlib.sha256(str(path).encode()).hexdigest()[:12]
    spec = importlib.util.spec_from_file_location(f"port_bench_backbone_{name}_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
        clash = sorted(set(getattr(mod, "KINDS", {})) & set(HEAD_KINDS))
        if clash:
            raise ValueError(f"backbone {path}: KINDS reuses the head's kinds {clash}")
    except BaseException:
        del sys.modules[spec.name]
        raise
    _loaded[path] = mod
    return mod
