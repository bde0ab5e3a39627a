"""Checkpoints: the port's full train state, and the JAX package's
``.msgpack`` checkpoints read without JAX, flax or msgpack.

Counterpart of ``moleculesde_tpu/utils/checkpoints.py``.  The JAX package
writes flax's ``msgpack_serialize`` of

- ``{"params": ..., "batch_stats": ...}`` keyed by component
  (``model_complete{,_final}.msgpack``, :func:`load_pretrain_checkpoint`);
- ``{"state": {"params", "batch_stats", "opt_state", "step"}, "extra"}``
  (``train_state.msgpack``, :func:`load_train_state`).

:func:`msgpack_restore` decodes the subset of msgpack that flax writes in
plain Python: maps, arrays, str and bin of every width, ints, floats, nil
and bool, and flax's ext types 1 (an ndarray) and 3 (a numpy scalar), each a
msgpack array ``(shape, dtype name, C-order bytes)``.  ``bfloat16`` leaves
are read as uint16 and viewed as ``torch.bfloat16`` (numpy has no bfloat16);
every other leaf is a numpy array or scalar.  Ext type 2 (a complex scalar)
and flax's ``__msgpack_chunked_array__`` leaves (arrays over 1 GiB) are
refused by name.

The port's own full state is a ``.pt`` (:func:`save_train_state`) of
:meth:`PretrainState.state_dict` and ``extra``; :func:`load_train_state`
reads either format by suffix.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from moleculesde_tpu_torch.convert import load_flax_pretrain
from moleculesde_tpu_torch.pretrain.train_state import GROUP_2D, GROUP_3D, PretrainState

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """A msgpack decoder over one bytes object (the subset flax writes)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (needs {n} more)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def value(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        lengths = {0: "B", 1: "H", 2: "I"}
        if 0xC4 <= b <= 0xC6:   # bin 8 / 16 / 32
            return bytes(self.take(self.unpack(lengths[b - 0xC4])))
        if 0xD9 <= b <= 0xDB:   # str 8 / 16 / 32
            return str(self.take(self.unpack(lengths[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack("H" if b == 0xDC else "I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack("H" if b == 0xDE else "I"))
        if 0xD4 <= b <= 0xD8:   # fixext 1 / 2 / 4 / 8 / 16
            code = self.unpack("b")
            return _ext(code, bytes(self.take(1 << (b - 0xD4))))
        if 0xC7 <= b <= 0xC9:   # ext 8 / 16 / 32
            n = self.unpack(lengths[b - 0xC7])
            code = self.unpack("b")
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at byte {self.pos - 1}")

    def array(self, n: int) -> List[Any]:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ndarray(payload: bytes):
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, C-order bytes);
    bfloat16 as a torch tensor, anything else a numpy array."""
    shape, name, buf = _Reader(payload).value()
    shape = tuple(shape)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        flat = np.frombuffer(buf, dtype=np.uint16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, payload: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr if torch.is_tensor(arr) else arr[()]
    if code == EXT_COMPLEX:
        raise ValueError("msgpack: complex scalars (flax ext type 2) are not read")
    raise ValueError(f"msgpack: unknown ext type {code}")


def _refuse_chunked(tree: Any, path: str = "") -> None:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError(f"msgpack: {path or 'the root'} is a __msgpack_chunked_array__ "
                             f"(an array over 1 GiB split by flax): not read")
        for k, v in tree.items():
            _refuse_chunked(v, f"{path}/{k}")


def msgpack_restore(data: bytes) -> Any:
    """Decode flax's ``msgpack_serialize`` output (see the module's
    docstring for the subset read)."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the value")
    _refuse_chunked(tree)
    return tree


def _read_msgpack(path: str) -> Any:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def load_pretrain_checkpoint(path: str, component: Optional[str] = None):
    """A JAX ``model_complete*.msgpack``: (params, batch_stats) keyed by
    component, or one component's pair (``batch_stats`` {} where it has
    none), as the JAX package's function of the same name returns them."""
    payload = _read_msgpack(path)
    params, batch_stats = payload["params"], payload.get("batch_stats", {})
    if component is not None:
        return params.get(component), batch_stats.get(component, {})
    return params, batch_stats


def load_components(path: str, components: Mapping[str, nn.Module]) -> None:
    """Load the named components (``{"model_2D": module, ...}``) in place
    from a pretraining checkpoint: the port's ``.pt`` or a JAX
    ``.msgpack``, by suffix.  Every key and shape must match."""
    if path.endswith(".msgpack"):
        params, batch_stats = load_pretrain_checkpoint(path)
        missing = sorted(set(components) - set(params))
        if missing:
            raise KeyError(f"{path} has no component {missing}")
        load_flax_pretrain(components, params, batch_stats)
        return
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for name, module in components.items():
        module.load_state_dict(ckpt[name])


def save_train_state(path: str, state: PretrainState, extra: Optional[Dict] = None) -> str:
    """The port's full-state ``.pt``: :meth:`PretrainState.state_dict` and
    ``extra`` (JAX's ``save_train_state`` writes ``{"epoch": epochs}``)."""
    torch.save({"state": state.state_dict(), "extra": dict(extra or {})}, path)
    return path


def load_train_state(path: str, state: PretrainState) -> Tuple[PretrainState, Dict]:
    """Restore ``state`` in place from the port's ``.pt`` or from a JAX
    ``train_state.msgpack`` (by suffix); returns ``(state, extra)`` as JAX's
    function does.  ``state`` must be built at the checkpoint's widths."""
    if path.endswith(".msgpack"):
        payload = _read_msgpack(path)
        load_jax_train_state(state, payload["state"])
        return state, payload.get("extra", {})
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.load_state_dict(payload["state"])
    return state, payload.get("extra", {})


def _sorted_leaves(tree: Mapping[str, Any], prefix: str = ""):
    """(dotted path, leaf) in ``jax.tree_util``'s order: keys sorted at
    every level."""
    for k in sorted(tree):
        v, key = tree[k], f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _sorted_leaves(v, key)
        else:
            yield key, v


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.array(x))


def load_jax_train_state(state: PretrainState, jax_state: Mapping[str, Any]) -> None:
    """Load a JAX ``PretrainState`` dict (``params``, ``batch_stats``,
    ``opt_state`` = {mu, nu, count, lr_scale}, ``step``) into ``state``.

    JAX's Adam keeps its moments as flat vectors raveled by
    ``jax.flatten_util.ravel_pytree`` over the params, components and keys
    sorted; they are cut back into the port's per-parameter ``exp_avg`` /
    ``exp_avg_sq``, ``count`` becomes each parameter's Adam step and
    ``step`` the state's.  As JAX's ``from_state_dict`` does, the
    checkpoint's ``lr_scale`` wins over the current flags: each group's lr
    becomes the optimizer's base lr (``cfg.lr``) times the checkpoint's
    scale for the group, which must be one value within the group.  The
    generator keeps its own state (JAX stores no random state)."""
    params, batch_stats = jax_state["params"], jax_state.get("batch_stats", {})
    if set(params) != set(state.models):
        raise KeyError(f"checkpoint params have components {sorted(params)}, "
                       f"not {sorted(state.models)}")
    load_flax_pretrain(state.models, params, batch_stats)   # checks keys and shapes
    named = {f"{comp}.{n}": p for comp, m in state.models.items()
             for n, p in m.named_parameters()}
    keys = [k for k, _ in _sorted_leaves(params)]
    if sorted(keys) != sorted(named):
        raise KeyError(f"the checkpoint's params are not the models' parameters: "
                       f"{sorted(set(keys) ^ set(named))}")
    opt = jax_state["opt_state"]
    mu, nu, scale = (_as_tensor(opt[k]).reshape(-1).float() for k in ("mu", "nu", "lr_scale"))
    total = sum(p.numel() for p in named.values())
    for name, vec in (("mu", mu), ("nu", nu), ("lr_scale", scale)):
        if vec.numel() != total:
            raise ValueError(f"opt_state.{name} holds {vec.numel()} values, the params {total}")
    step = torch.tensor(float(np.asarray(opt["count"])), dtype=torch.float32)
    group_of = {c: gi for gi, names in enumerate((GROUP_2D, GROUP_3D)) for c in names}
    group_scale: Dict[int, set] = {}
    offset = 0
    for key in keys:
        p = named[key]
        sl = slice(offset, offset + p.numel())
        offset = sl.stop
        state.optimizer.state[p] = {
            "step": step.clone(),
            "exp_avg": mu[sl].reshape(p.shape).to(p.device, p.dtype, copy=True),
            "exp_avg_sq": nu[sl].reshape(p.shape).to(p.device, p.dtype, copy=True)}
        group_scale.setdefault(group_of[key.split(".", 1)[0]], set()).update(
            torch.unique(scale[sl]).tolist())
    base_lr = state.optimizer.defaults["lr"]   # cfg.lr (make_optimizer)
    for gi, group in enumerate(state.optimizer.param_groups):
        if len(group_scale[gi]) != 1:
            raise ValueError(f"lr_scale is not constant within LR group {gi}: "
                             f"{sorted(group_scale[gi])}")
        group["lr"] = base_lr * group_scale[gi].pop()
    state.step = int(np.asarray(jax_state["step"]))
