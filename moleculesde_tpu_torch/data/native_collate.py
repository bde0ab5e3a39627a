"""Padded collation in C++ (``native/collate.cpp``), bound through ctypes.

Counterpart of ``moleculesde_tpu/data/native_collate.py::native_pad_graphs``
over the port's own copy of the C++ source.  :func:`native_pad_graphs`
fills the same :class:`~moleculesde_tpu_torch.core.batch.GraphBatch`, bit
for bit, as the numpy :func:`~moleculesde_tpu_torch.core.batch.pad_graphs`;
the padded :class:`~moleculesde_tpu_torch.data.loader.GraphLoader` takes it
by default.  The C call releases the GIL, so ``ThreadedLoader``'s threads
collate in parallel.

The library is built with ``g++`` and the JAX package's flags
(``native/Makefile``) at first use, into
``build/native/libcollate-<hash>.so`` at the root of the checkout; the hash
covers the source, the flags and the host's CPU model and feature flags
(``-march=native`` code runs only on such a CPU).  Unlike the JAX package,
a failed build raises with the compiler's message instead of falling back
to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from moleculesde_tpu_torch.core.batch import NUM_ATOM_FEATURES, NUM_BOND_FEATURES, GraphBatch

SOURCE = Path(__file__).resolve().parent.parent / "native" / "collate.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
BUILD_TIMEOUT_S = 300

_LIB: Optional[ctypes.CDLL] = None


def _cpu_model() -> str:
    """The host CPU's model name and feature flags (what ``-march=native``
    reads), as ``/proc/cpuinfo`` gives them for its first processor."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
    except OSError:
        return ""
    return "".join(lines[:2])


def library_path() -> Path:
    key = (SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
           + f"{platform.machine()} {_cpu_model()}".encode())
    return BUILD_DIR / f"libcollate-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; raise with g++'s output if
    the build fails.  Concurrent builds write to their own temporary file
    and rename it into place."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native collation build failed ({' '.join(cmd)}): {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native collation build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The collation library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        i32, i64, f32, u8 = (ctypes.POINTER(t) for t in (
            ctypes.c_int32, ctypes.c_int64, ctypes.c_float, ctypes.c_uint8))
        # inputs, sizes, outputs: native/collate.cpp::collate_graphs
        lib.collate_graphs.argtypes = (
            [i32, f32, i64, i32, i32, i64, i32, i32, i64] + [ctypes.c_int64] * 8
            + [i32, u8, f32, i32, i32, i32, u8, i32, i32, i32, u8])
        lib.collate_graphs.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def native_pad_graphs(graphs: Sequence[Dict], n_max: int, e_max: int,
                      ext_e_max: Optional[int] = None,
                      num_graphs: Optional[int] = None, num_tasks: Optional[int] = None,
                      with_forces: bool = False) -> GraphBatch:
    """:func:`~moleculesde_tpu_torch.core.batch.pad_graphs` in C++: the same
    arguments, the same batch (CPU tensors).  The labels ``y`` and
    ``forces`` are filled in numpy after the C call, as in the JAX
    package."""
    lib = load()
    b = num_graphs if num_graphs is not None else len(graphs)
    if len(graphs) > b:
        raise ValueError(f"{len(graphs)} graphs do not fit num_graphs={b}")
    if ext_e_max is None:
        ext_e_max = e_max

    # the graphs' arrays concatenated, with [B + 1] offsets
    atom_list, pos_list, ei_list, ef_list, xi_list, xa_list = [], [], [], [], [], []
    a_off, e_off, x_off = [0], [0], [0]
    for g in graphs:
        af = np.asarray(g["atom_feats"], dtype=np.int32)
        if af.ndim == 1:   # atomic-number-only graphs
            full = np.zeros((af.shape[0], NUM_ATOM_FEATURES), dtype=np.int32)
            full[:, 0] = af
            af = full
        atom_list.append(af)
        a_off.append(a_off[-1] + af.shape[0])
        p = g.get("positions")
        pos_list.append(np.asarray(p, dtype=np.float32) if p is not None
                        else np.zeros((af.shape[0], 3), dtype=np.float32))
        ei = _i32(g.get("edge_index", np.zeros((2, 0)))).reshape(2, -1)
        ef = _i32(g.get("edge_feats", np.zeros((ei.shape[1], NUM_BOND_FEATURES))))
        ei_list.append(ei)
        ef_list.append(ef.reshape(-1, NUM_BOND_FEATURES))
        e_off.append(e_off[-1] + ei.shape[1])
        if g.get("ext_edge_index") is not None:
            xi = _i32(g["ext_edge_index"]).reshape(2, -1)
            xa = _i32(g.get("ext_edge_attr", np.zeros(xi.shape[1])))
        else:   # no extended graph: the bond graph, labelled bond type + 1
            xi = ei
            xa = (ef[:, 0] + 1).astype(np.int32) if ef.size else np.zeros((0,), np.int32)
        xi_list.append(xi)
        xa_list.append(xa)
        x_off.append(x_off[-1] + xi.shape[1])
    for off in (a_off, e_off, x_off):   # empty trailing graphs
        off.extend([off[-1]] * (b + 1 - len(off)))

    atom_cat = np.concatenate(atom_list) if atom_list else np.zeros(
        (0, NUM_ATOM_FEATURES), np.int32)
    pos_cat = np.concatenate(pos_list) if pos_list else np.zeros((0, 3), np.float32)
    ei_cat = np.ascontiguousarray(np.concatenate(ei_list, axis=1) if ei_list
                                  else np.zeros((2, 0), np.int32))
    ef_cat = np.ascontiguousarray(np.concatenate(ef_list) if ef_list
                                  else np.zeros((0, NUM_BOND_FEATURES), np.int32))
    xi_cat = np.ascontiguousarray(np.concatenate(xi_list, axis=1) if xi_list
                                  else np.zeros((2, 0), np.int32))
    xa_cat = np.ascontiguousarray(np.concatenate(xa_list) if xa_list
                                  else np.zeros((0,), np.int32))
    a_off, e_off, x_off = (np.asarray(o, dtype=np.int64) for o in (a_off, e_off, x_off))

    out = {
        "atom_feats": np.zeros((b * n_max, NUM_ATOM_FEATURES), np.int32),
        "node_mask": np.zeros((b * n_max,), np.uint8),
        "positions": np.zeros((b * n_max, 3), np.float32),
        "edge_src": np.zeros((b * e_max,), np.int32),
        "edge_dst": np.zeros((b * e_max,), np.int32),
        "edge_feats": np.zeros((b * e_max, NUM_BOND_FEATURES), np.int32),
        "edge_mask": np.zeros((b * e_max,), np.uint8),
        "ext_src": np.zeros((b * ext_e_max,), np.int32),
        "ext_dst": np.zeros((b * ext_e_max,), np.int32),
        "ext_attr": np.zeros((b * ext_e_max,), np.int32),
        "ext_mask": np.zeros((b * ext_e_max,), np.uint8)}
    i32, i64, f32, u8 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float, ctypes.c_uint8
    out_types = {"positions": f32, "node_mask": u8, "edge_mask": u8, "ext_mask": u8}
    rc = lib.collate_graphs(
        _ptr(atom_cat, i32), _ptr(pos_cat, f32), _ptr(a_off, i64),
        _ptr(ei_cat, i32), _ptr(ef_cat, i32), _ptr(e_off, i64),
        _ptr(xi_cat, i32), _ptr(xa_cat, i32), _ptr(x_off, i64),
        b, n_max, e_max, ext_e_max, NUM_ATOM_FEATURES, NUM_BOND_FEATURES,
        ei_cat.shape[1], xi_cat.shape[1],
        *(_ptr(arr, out_types.get(name, i32)) for name, arr in out.items()))
    if rc != 0:
        raise RuntimeError(f"native collation failed (return code {rc})")
    for name in ("node_mask", "edge_mask", "ext_mask"):
        out[name] = out[name].view(np.bool_)
    if num_tasks is not None:
        out["y"] = np.zeros((b, num_tasks), np.float32)
        for i, g in enumerate(graphs):
            if g.get("y") is not None:
                out["y"][i] = np.asarray(g["y"], np.float32).reshape(-1)[:num_tasks]
    if with_forces:
        out["forces"] = np.zeros((b * n_max, 3), np.float32)
        for i, g in enumerate(graphs):
            if g.get("forces") is not None:
                f = np.asarray(g["forces"], np.float32)
                n = min(f.shape[0], n_max)
                out["forces"][i * n_max:i * n_max + n] = f[:n]
    return GraphBatch(**{k: torch.from_numpy(v) for k, v in out.items()},
                      num_graphs=b, n_max=n_max)
