"""Weights into the port.

- `load_d2_state_dict`: a detectron2 Mask2Former checkpoint (.pkl / .pth, or
  a dict) as the port's `state_dict`. The port names its modules as
  detectron2 does, so this only folds FrozenBN and renames the legacy
  `static_query`.
- `jax_variables_to_state_dict`: the JAX package's {"params", "frozen"}
  variable tree (as numpy arrays) as the port's `state_dict` — the exact
  inverse of the JAX package's `utils/convert_weights.py`:
  HWIO -> OIHW, (in, out) -> (out, in), packed in_proj (C, 3C) -> (3C, C),
  scan-stacked layers unstacked, and 0-indexed `adapter_{i}`/`layer_{i}` to
  detectron2's `adapter_{i+1}`/`layer_{i+1}`.
"""

from __future__ import annotations

import pickle
import re
from typing import Any, Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch

BN_EPS = 1e-5
# d2 meta-architecture buffers that are not part of the network
_NON_NETWORK = ("criterion.", "pixel_mean", "pixel_std")


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        sd = data.get("model", data)
    else:
        data = torch.load(path, map_location="cpu", weights_only=False)
        sd = data.get("model", data.get("state_dict", data))
        sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
    return {k: np.asarray(v) for k, v in sd.items()}


def load_d2_state_dict(path_or_sd: Union[str, Mapping[str, Any]]) -> Dict[str, torch.Tensor]:
    """detectron2 checkpoint -> port `state_dict` (FrozenBN folded with
    eps 1e-5 into `scale`/`bias`; `static_query` renamed `query_feat`)."""
    sd = (load_state_dict(path_or_sd) if isinstance(path_or_sd, str)
          else {k: np.asarray(v) for k, v in path_or_sd.items()})
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k.startswith(_NON_NETWORK) or k.endswith("num_batches_tracked"):
            continue
        out[k.replace("static_query", "query_feat")] = v
    for k in [k for k in out if k.startswith("backbone.") and ".norm." in k
              and k.endswith(".weight")]:
        prefix = k[: -len(".weight")]
        w, b = out.pop(k), out.pop(f"{prefix}.bias")
        mean = out.pop(f"{prefix}.running_mean", None)
        var = out.pop(f"{prefix}.running_var", None)
        if mean is None:  # already-folded caffe weights
            scale, bias = w, b
        else:
            scale = w / np.sqrt(var + BN_EPS)
            bias = b - mean * scale
        out[f"{prefix}.scale"], out[f"{prefix}.bias"] = scale, bias
    return {k: torch.tensor(np.asarray(v, dtype=np.float32))
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# JAX variable tree -> port state_dict
# ---------------------------------------------------------------------------

_PD = "sem_seg_head/pixel_decoder"
_PR = "sem_seg_head/predictor"
_SUB = {"cross_attn": "transformer_cross_attention_layers",
        "self_attn": "transformer_self_attention_layers",
        "ffn": "transformer_ffn_layers"}

# (JAX module path regex, port module path) for unstacked modules
_MODULE_RULES = [
    (r"backbone/stem_conv1/conv", "backbone.stem.conv1"),
    (r"backbone/stem_conv1/norm", "backbone.stem.conv1.norm"),
    (r"backbone/res(\d)_block(\d+)/(\w+)/conv", r"backbone.res\1.\2.\3"),
    (r"backbone/res(\d)_block(\d+)/(\w+)/norm", r"backbone.res\1.\2.\3.norm"),
    (rf"{_PD}/input_proj_(\d+)_conv", r"sem_seg_head.pixel_decoder.input_proj.\1.0"),
    (rf"{_PD}/input_proj_(\d+)_norm", r"sem_seg_head.pixel_decoder.input_proj.\1.1"),
    (rf"{_PD}/mask_features", "sem_seg_head.pixel_decoder.mask_features"),
    (rf"{_PD}/(adapter|layer)_(\d+)_conv", lambda m: (
        f"sem_seg_head.pixel_decoder.{m[1]}_{int(m[2]) + 1}")),
    (rf"{_PD}/(adapter|layer)_(\d+)_norm", lambda m: (
        f"sem_seg_head.pixel_decoder.{m[1]}_{int(m[2]) + 1}.norm")),
    (rf"{_PR}/(decoder_norm|class_embed)", r"sem_seg_head.predictor.\1"),
    (rf"{_PR}/mask_embed/layers_(\d+)", r"sem_seg_head.predictor.mask_embed.layers.\1"),
    (rf"{_PR}/input_proj_(\d+)", r"sem_seg_head.predictor.input_proj.\1"),
    (rf"{_PR}/(cross_attn|self_attn|ffn)_(\d+)/(.+)", lambda m: (
        f"sem_seg_head.predictor.{_SUB[m[1]]}.{m[2]}.{m[3].replace('/', '.')}")),
]
# parameters held directly by a module: JAX path -> port key
_DIRECT = {
    f"{_PD}/level_embed": "sem_seg_head.pixel_decoder.transformer.level_embed",
    f"{_PR}/query_feat": "sem_seg_head.predictor.query_feat.weight",
    f"{_PR}/query_embed": "sem_seg_head.predictor.query_embed.weight",
    f"{_PR}/level_embed": "sem_seg_head.predictor.level_embed.weight",
}


def _flatten(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def _leaf(name: str, value: np.ndarray, frozen: bool) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if value.ndim == 4:  # HWIO -> OIHW
            return "weight", value.transpose(3, 2, 0, 1)
        return "weight", value.T
    if name == "in_proj_weight":
        return name, value.T
    if name == "scale" and not frozen:  # LayerNorm / GroupNorm
        return "weight", value
    return name, value


def _module(path: str) -> str:
    for pattern, repl in _MODULE_RULES:
        m = re.fullmatch(pattern, path)
        if m:
            return repl(m) if callable(repl) else m.expand(repl)
    raise KeyError(f"no port counterpart for JAX module {path!r}")


def _convert_leaf(path: str, value: np.ndarray, frozen: bool,
                  n_levels: int) -> Iterator[Tuple[str, np.ndarray]]:
    if path in _DIRECT:
        yield _DIRECT[path], value
        return
    mod, _, name = path.rpartition("/")
    enc = re.fullmatch(rf"{_PD}/encoder_layers/(.+)", mod)
    rnd = re.fullmatch(rf"{_PR}/rounds/(cross_attn|self_attn|ffn)_(\d+)(/.+)?", mod)
    if enc:  # (n_layers, ...) -> transformer.encoder.layers.{i}
        for i, v in enumerate(value):
            key, v = _leaf(name, v, frozen)
            yield (f"sem_seg_head.pixel_decoder.transformer.encoder.layers.{i}."
                   f"{enc[1].replace('/', '.')}.{key}"), v
    elif rnd:  # (n_rounds, ...) -> layer n_levels * r + pos
        rest = (rnd[3] or "").replace("/", ".")
        for r, v in enumerate(value):
            key, v = _leaf(name, v, frozen)
            i = n_levels * r + int(rnd[2])
            yield f"sem_seg_head.predictor.{_SUB[rnd[1]]}.{i}{rest}.{key}", v
    else:
        key, v = _leaf(name, value, frozen)
        yield f"{_module(mod)}.{key}", v


def jax_tree_to_numpy(variables: Mapping, n_levels: int = 3) -> Dict[str, np.ndarray]:
    """Every leaf of a JAX {"params", "frozen"} tree under its port key, in
    the port's layout; no check against a model."""
    if n_levels != 3:  # the JAX converter's round layout assumes 3 levels
        raise ValueError(f"num_feature_levels must be 3, got {n_levels}")
    unknown = set(variables) - {"params", "frozen"}
    if unknown:
        raise KeyError(f"unknown variable collections {sorted(unknown)}")
    out: Dict[str, np.ndarray] = {}
    for coll, frozen in (("params", False), ("frozen", True)):
        for path, value in _flatten(variables.get(coll, {})):
            for key, v in _convert_leaf(path, value, frozen, n_levels):
                if key in out:
                    raise KeyError(f"two JAX leaves map to {key!r}")
                out[key] = v
    return out


def jax_variables_to_state_dict(variables: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX {"params", "frozen"} tree (numpy leaves) -> port `state_dict` for
    the model `build_model(cfg)` builds. Raises on a leaf that maps nowhere,
    a port key no leaf fills, or a shape mismatch."""
    from bm2f_tpu_torch.models.maskformer import MaskFormer

    model_cfg = getattr(cfg, "model", cfg)
    out = jax_tree_to_numpy(variables, model_cfg.decoder.num_feature_levels)
    with torch.device("meta"):
        expected = {k: tuple(v.shape) for k, v in MaskFormer(model_cfg).state_dict().items()}
    missing = sorted(set(expected) - set(out))
    extra = sorted(set(out) - set(expected))
    if missing or extra:
        raise KeyError(f"JAX tree does not match the port: missing {missing[:8]} "
                       f"({len(missing)}), left over {extra[:8]} ({len(extra)})")
    for k, shape in expected.items():
        if tuple(out[k].shape) != shape:
            raise ValueError(f"{k}: JAX gives {tuple(out[k].shape)}, port wants {shape}")
    return {k: torch.tensor(np.asarray(v, dtype=np.float32))
            for k, v in out.items()}
