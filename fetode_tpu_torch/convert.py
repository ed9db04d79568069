"""Parameter conversion between the JAX package and the port.

The JAX package keeps a KAN stack's parameters as a list of dicts of
arrays, one per layer (``{"_buffers": {"grid"}, "base_weight",
"spline_weight", "spline_scaler", "ferro": {"k", "ec", "ps", "bias",
"coef"}, "logistic": {...}}``), and pickles them as numpy arrays into a
serving bundle's ``params.pkl`` (``fetode_tpu/serve.py:267-268``).  The
port keeps the same tensors in a ``KAN`` module, whose ``state_dict``
keys are ``layers.<i>.<name>`` with the grid as ``layers.<i>.grid``.

The ECG models' parameters are one dict tree in the JAX package
(``encoder_w``, ``field_mixer: {a, b}``, ``fc1: {k, ec, ps, bias, coef}``
...) and one module in the port whose ``state_dict`` keys are the dotted
paths of that tree (``field_mixer.a``, ``fc1.k``); the 'mlp' field's
``kan`` layer list maps as a KAN stack does, to ``kan.layers.<i>.<name>``
with the grid as ``kan.layers.<i>.grid``: ``ecg_params_from_numpy`` /
``ecg_params_to_numpy`` / ``ecg_grads_to_numpy``.  The Kuramoto
classifier's tree (``K``, ``omega``, ``head``: one KAN layer with its
grid under ``_buffers``) maps the same way
(``kuramoto_params_{from,to}_numpy``, ``kuramoto_grads_to_numpy``).

A conditional denoiser's tree (``encoder``: the conv dict or the node
dict with its ``field`` MLP list; ``net``: an MLP or KAN layer list) maps
to ``encoder.<key>`` / ``encoder.field.<i>.w`` and ``net.<i>.w`` or
``net.layers.<i>.<name>`` (``cond_diffusion_params_{from,to}_numpy``,
``cond_diffusion_grads_to_numpy``).  The symbolic net's ``{"l1", "l2"}``
dict of ferro layers maps to ``l1.<name>`` / ``l2.<name>``
(``symbolic_params_{from,to}_numpy``, ``symbolic_grads_to_numpy``).

Everything converts to float32 unless asked otherwise: the JAX package's
tests run with x64 on, and the port works in float32 throughout.
``grads_to_numpy`` maps a module's gradients onto the JAX tree, so tests
compare gradients leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def _flatten(prefix: str, node: Dict[str, Any], out: Dict[str, Any]) -> None:
    for name, value in node.items():
        if isinstance(value, dict):
            # "_buffers" holds the knot grid; the port keeps it on the layer.
            sub = prefix if name == "_buffers" else f"{prefix}{name}."
            _flatten(sub, value, out)
        else:
            out[prefix + name] = value


def params_from_numpy(tree: List[Dict[str, Any]], device=None,
                      dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The JAX param list -> a ``state_dict`` for the port's ``KAN``, in
    ``dtype`` (float64 keeps the bits of a float64 tree).

    Use as ``kan.load_state_dict(params_from_numpy(tree, device))``.
    """
    flat: Dict[str, Any] = {}
    for i, layer in enumerate(tree):
        _flatten(f"layers.{i}.", layer, flat)
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in flat.items()}


def params_to_numpy(params, dtype=np.float32) -> List[Dict[str, Any]]:
    """The inverse: a ``KAN`` (or its ``state_dict``) -> the JAX param list
    of numpy arrays of ``dtype``."""
    state = params.state_dict() if hasattr(params, "state_dict") else params
    layers: Dict[int, Dict[str, Any]] = {}
    for key, value in state.items():
        _, idx, *path = key.split(".")
        node = layers.setdefault(int(idx), {})
        if path == ["grid"]:
            path = ["_buffers", "grid"]
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = value.detach().cpu().numpy().astype(dtype)
    return [layers[i] for i in sorted(layers)]


def grads_to_numpy(params, dtype=np.float32) -> List[Dict[str, Any]]:
    """A ``KAN``'s ``.grad``s -> the JAX package's gradient tree (the layout
    of ``params_to_numpy``).  The knot grid, a buffer, gets zeros, as the
    JAX package's discrete-adjoint kernel reports for it; so does a
    parameter without a gradient."""
    grads = {name: p.grad for name, p in params.named_parameters()}
    return params_to_numpy({
        key: torch.zeros_like(value) if grads.get(key) is None
        else grads[key] for key, value in params.state_dict().items()},
        dtype)


def ecg_params_from_numpy(tree: Dict[str, Any], device=None,
                          dtype=np.float32) -> Dict[str, torch.Tensor]:
    """An ECG model's JAX param tree -> a ``state_dict`` for its port
    module (``models/ecg.py``); a KAN layer list (``kan``) maps to
    ``kan.layers.<i>.<name>``."""
    flat: Dict[str, Any] = {}
    _flatten("", {k: v for k, v in tree.items() if k != "kan"}, flat)
    for i, layer in enumerate(tree.get("kan", [])):
        _flatten(f"kan.layers.{i}.", layer, flat)
    return {k: torch.as_tensor(np.array(v, dtype=dtype), device=device)
            for k, v in flat.items()}


def _nest(flat: Dict[str, torch.Tensor], dtype) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    kan: Dict[int, Dict[str, Any]] = {}
    for key, value in flat.items():
        *path, leaf = key.split(".")
        node = tree
        if path[:2] == ["kan", "layers"]:         # a KAN layer list
            node, path = kan.setdefault(int(path[2]), {}), path[3:]
            if leaf == "grid":
                path = ["_buffers"]
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value.detach().cpu().numpy().astype(dtype)
    if kan:
        tree["kan"] = [kan[i] for i in sorted(kan)]
    return tree


def ecg_params_to_numpy(module, dtype=np.float32) -> Dict[str, Any]:
    """The inverse: an ECG port module -> the JAX param tree."""
    return _nest(module.state_dict(), dtype)


def _grads_or_zeros(module, buffers: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """A module's ``.grad``s under its ``state_dict`` keys: zeros for a
    parameter without a gradient and, with ``buffers``, for every buffer
    (a KAN grid)."""
    grads = {name: p.grad for name, p in module.named_parameters()}
    names = module.state_dict() if buffers else dict(
        module.named_parameters())
    return {key: torch.zeros_like(value) if grads.get(key) is None
            else grads[key] for key, value in names.items()}


def ecg_grads_to_numpy(module, dtype=np.float32) -> Dict[str, Any]:
    """An ECG port module's ``.grad``s -> the JAX gradient tree; a
    parameter without a gradient and a KAN grid (a buffer) get zeros."""
    return _nest(_grads_or_zeros(module, buffers=True), dtype)


def _is_kan(layers: List[Any]) -> bool:
    return bool(layers) and isinstance(layers[0], dict) \
        and "base_weight" in layers[0]


def forecast_params_from_numpy(tree: Dict[str, Any], device=None,
                               dtype=np.float32) -> Dict[str, torch.Tensor]:
    """A forecaster's JAX param tree (``encoder``, ``dynamics``,
    ``decoder`` | ``eps_head``, each a list of layers) -> a ``state_dict``
    for its port module (``models/forecasting.py``).  An MLP layer i maps
    to ``<part>.<i>.w`` / ``.b``; a KAN encoder's to
    ``encoder.layers.<i>.<name>``, its grid to ``encoder.layers.<i>.grid``;
    the kanrnn encoder's dict to its dotted paths (``encoder.cell.
    input_basis.a``, ``encoder.to_latent_w``).  A bare layer list (one
    MLP) maps to ``<i>.w`` / ``.b``."""
    if isinstance(tree, list):
        tree = {"": tree}
    flat: Dict[str, Any] = {}
    for part, layers in tree.items():
        head = f"{part}." if part else ""
        if isinstance(layers, dict):              # the kanrnn encoder
            _flatten(head, layers, flat)
            continue
        sub = f"{head}layers." if _is_kan(layers) else head
        for i, layer in enumerate(layers):
            _flatten(f"{sub}{i}.", layer, flat)
    return {k: torch.as_tensor(np.array(v, dtype=dtype), device=device)
            for k, v in flat.items()}


def _is_layer_index(name: str) -> bool:
    return name.isdigit() or name == "layers"


def _forecast_nest(flat: Dict[str, torch.Tensor], dtype) -> Dict[str, Any]:
    tree: Dict[str, Dict[int, Dict[str, Any]]] = {}
    rnn = {key: value for key, value in flat.items()       # kanrnn encoder
           if not _is_layer_index(key.split(".")[1])}
    for key, value in flat.items():
        if key in rnn:
            continue
        path = key.split(".")
        if path[1] == "layers":                   # a KAN encoder
            path = [path[0]] + path[2:]
        part, idx, *rest = path
        node = tree.setdefault(part, {}).setdefault(int(idx), {})
        if rest == ["grid"]:
            rest = ["_buffers", "grid"]
        for name in rest[:-1]:
            node = node.setdefault(name, {})
        node[rest[-1]] = value.detach().cpu().numpy().astype(dtype)
    out: Dict[str, Any] = {part: [layers[i] for i in sorted(layers)]
                           for part, layers in tree.items()}
    out.update(_nest(rnn, dtype))
    return out


def forecast_params_to_numpy(module, dtype=np.float32) -> Dict[str, Any]:
    """The inverse: a forecaster's port module -> the JAX param tree."""
    return _forecast_nest(module.state_dict(), dtype)


def forecast_grads_to_numpy(module, dtype=np.float32) -> Dict[str, Any]:
    """A forecaster's ``.grad``s -> the JAX gradient tree; a KAN grid (a
    buffer) and a parameter without a gradient get zeros."""
    return _forecast_nest(_grads_or_zeros(module, buffers=True), dtype)


# The Kuramoto classifier's JAX param tree (``K``, ``omega``, ``head``: one
# KAN layer) -> a ``state_dict`` for ``models/kuramoto.py: KuramotoKAN``
# (``K``, ``omega``, ``head.<name>``, the grid as ``head.grid``): the ECG
# models' dotted mapping.
kuramoto_params_from_numpy = ecg_params_from_numpy


def _kuramoto_nest(flat: Dict[str, torch.Tensor], dtype) -> Dict[str, Any]:
    tree = _nest(flat, dtype)
    head = tree["head"]
    head["_buffers"] = {"grid": head.pop("grid")}
    return tree


def kuramoto_params_to_numpy(module, dtype=np.float32) -> Dict[str, Any]:
    """The inverse: a ``KuramotoKAN`` -> the JAX param tree."""
    return _kuramoto_nest(module.state_dict(), dtype)


def kuramoto_grads_to_numpy(module, dtype=np.float32) -> Dict[str, Any]:
    """A ``KuramotoKAN``'s ``.grad``s -> the JAX gradient tree; the knot
    grid (a buffer) and a parameter without a gradient get zeros."""
    return _kuramoto_nest(_grads_or_zeros(module, buffers=True), dtype)


# ------------------------------------------------- conditional diffusion


def _net_prefix(layers: List[Any]) -> str:
    return "net.layers." if _is_kan(layers) else "net."


def cond_diffusion_params_from_numpy(tree: Dict[str, Any], device=None,
                                     dtype=np.float32
                                     ) -> Dict[str, torch.Tensor]:
    """A conditional denoiser's JAX param tree (``cond_denoiser_init``) ->
    a ``state_dict`` for its port module (``models/cond_diffusion.py``):
    either encoder, the MLP, KAN or KANFET net (its ferro tensors
    included)."""
    flat: Dict[str, Any] = {}
    enc = dict(tree["encoder"])
    for i, layer in enumerate(enc.pop("field", [])):
        _flatten(f"encoder.field.{i}.", layer, flat)
    _flatten("encoder.", enc, flat)
    for i, layer in enumerate(tree["net"]):
        _flatten(f"{_net_prefix(tree['net'])}{i}.", layer, flat)
    return {k: torch.as_tensor(np.array(v, dtype=dtype), device=device)
            for k, v in flat.items()}


def _cond_diffusion_nest(flat: Dict[str, torch.Tensor],
                         dtype) -> Dict[str, Any]:
    enc: Dict[str, Any] = {}
    field: Dict[int, Dict[str, Any]] = {}
    net: Dict[int, Dict[str, Any]] = {}
    for key, value in flat.items():
        part, *path = key.split(".")
        if part == "encoder" and path[0] == "field":
            node, path = field.setdefault(int(path[1]), {}), path[2:]
        elif part == "encoder":
            node = enc
        else:
            if path[0] == "layers":
                path = path[1:]
            node, path = net.setdefault(int(path[0]), {}), path[1:]
            if path == ["grid"]:
                path = ["_buffers", "grid"]
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = value.detach().cpu().numpy().astype(dtype)
    if field:
        enc["field"] = [field[i] for i in sorted(field)]
    return {"encoder": enc, "net": [net[i] for i in sorted(net)]}


def cond_diffusion_params_to_numpy(module, dtype=np.float32
                                   ) -> Dict[str, Any]:
    """The inverse: a conditional denoiser's port module -> the JAX param
    tree."""
    return _cond_diffusion_nest(module.state_dict(), dtype)


def cond_diffusion_grads_to_numpy(module, dtype=np.float32
                                  ) -> Dict[str, Any]:
    """A conditional denoiser's ``.grad``s -> the JAX gradient tree; a KAN
    grid (a buffer) and a parameter without a gradient get zeros."""
    return _cond_diffusion_nest(_grads_or_zeros(module, buffers=True), dtype)


# -------------------------------------------------- symbolic regression


def symbolic_params_from_numpy(tree: Dict[str, Any], device=None,
                               dtype=np.float32) -> Dict[str, torch.Tensor]:
    """The symbolic net's JAX param dict (``{"l1": {k, ec, ps, bias, coef},
    "l2": {...}}``) -> a ``state_dict`` for its port module
    (``models/symbolic.py: SymbolicNet``), keys ``l1.k`` ..."""
    flat: Dict[str, Any] = {}
    _flatten("", tree, flat)
    return {k: torch.as_tensor(np.array(v, dtype=dtype), device=device)
            for k, v in flat.items()}


def symbolic_params_to_numpy(module, dtype=np.float32) -> Dict[str, Any]:
    """The inverse: a ``SymbolicNet`` -> the JAX param dict."""
    return _nest(module.state_dict(), dtype)


def symbolic_grads_to_numpy(module, dtype=np.float32) -> Dict[str, Any]:
    """A ``SymbolicNet``'s ``.grad``s -> the JAX gradient dict; a parameter
    without a gradient gets zeros."""
    return _nest(_grads_or_zeros(module), dtype)


def predprey_head_params_from_numpy(tree: Dict[str, Any], device=None,
                                    dtype=torch.float32
                                    ) -> Dict[str, torch.Tensor]:
    """The head variant's JAX param dict (``predprey_head_init``: ``kan``,
    a KAN layer list, and ``head``, an MLP layer list) -> a ``state_dict``
    for the port's ``models/predprey.py: predprey_head_init``, keys
    ``kan.layers.<i>.<name>`` and ``head.<i>.w`` / ``head.<i>.b``."""
    out = {f"kan.{k}": v
           for k, v in params_from_numpy(tree["kan"], device, dtype).items()}
    for i, layer in enumerate(tree["head"]):
        for name, value in layer.items():
            out[f"head.{i}.{name}"] = torch.tensor(np.asarray(value),
                                                   dtype=dtype, device=device)
    return out


# The RNN variant's tree (``cell: {input_basis, hidden_basis}``, ``head:
# {basis, output}``) maps by its dotted paths, as the ECG models' trees do.
predprey_rnn_params_from_numpy = ecg_params_from_numpy
