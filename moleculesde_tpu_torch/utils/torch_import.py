"""Import the reference's PyTorch checkpoints into the port's modules.

Counterpart of ``moleculesde_tpu/utils/torch_import.py``.  The reference
releases its pretraining checkpoints as ``model_complete.pth``: a dict of
four component state dicts (reference examples/pretrain_MoleculeSDE.py:
72-103).  Each ``import_*`` function maps one component onto the flax-shaped
tree of the JAX package -- nested dicts of numpy arrays, Linear weights
``[out, in]`` transposed to ``[in, out]`` kernels, BatchNorm running
statistics in a ``batch_stats`` tree -- the same tree as the JAX package's
function of that name.  The port keeps flax's names and layout
(``convert.py``), so the tree loads into a port module with
:func:`~moleculesde_tpu_torch.convert.load_flax_variables`, every key
used; :func:`load_imported` loads :func:`import_pretrain_checkpoint`'s
components through :func:`~moleculesde_tpu_torch.convert.load_flax_pretrain`.

- ``model_2D``: GIN (reference Geom3D/models/molecule_gnn_model.py:132-197)
  -> ``GNN2D`` params and batch_stats (:func:`import_gin`);
- ``model_3D``: SchNet (reference Geom3D/models/schnet.py:16-135) ->
  ``SchNet`` params (:func:`import_schnet`), or PaiNN (reference
  Geom3D/models/painn.py:117-269) -> ``PaiNN`` params
  (:func:`import_painn`);
- ``SDE_2Dto3D_model``: SDEModel2Dto3D_01-04 -> params and batch_stats
  (:func:`import_sde_2dto3d`);
- ``SDE_3Dto2D_model``: SDEModel3Dto2D_node_adj_dense -> params
  (:func:`import_sde_3dto2d`).

One departure from the JAX package: :func:`import_pretrain_checkpoint`
tells SchNet from PaiNN by ``lin1.weight``, a key only SchNet has.  The
JAX package takes any ``interactions.*`` key for SchNet, which PaiNN's
keys are too, and raises ``KeyError`` on a PaiNN ``model_3D``.

Only plain tensors are read (``torch.load(weights_only=True)``): no PyG
is needed.  No CLI reads a ``.pth``; this is a library entry, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from moleculesde_tpu_torch.convert import load_flax_pretrain


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """The payload of a ``.pth`` (tensors and plain containers only)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _lin(sd, prefix) -> Dict[str, np.ndarray]:
    """A torch Linear ``[out, in]`` -> a flax Dense ``{"kernel": [in, out],
    "bias"}`` (no bias where the Linear has none)."""
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _bn(sd, prefix) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """A torch BatchNorm -> (params {scale, bias}, batch_stats {mean, var})."""
    params = {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}
    stats = {"mean": _np(sd[f"{prefix}.running_mean"]),
             "var": _np(sd[f"{prefix}.running_var"])}
    return params, stats


def _mlp(sd, prefix, n_layers) -> Dict[str, Any]:
    """The reference's MultiLayerPerceptron (layers/common.py:5-40, keys
    ``<prefix>.layers.{i}``) -> an MLP's ``{Dense_i}`` tree."""
    return {f"Dense_{i}": _lin(sd, f"{prefix}.layers.{i}") for i in range(n_layers)}


def _gat_layer(sd, prefix) -> Dict[str, Any]:
    """The reference's GATLayer (equivariant_scorenetwork.py:13-40: PyG's
    TransformerConv, an FFN and two LayerNorms) -> a DenseGATLayer tree;
    PyG's bias-free ``lin_edge`` gets a zero bias."""
    out: Dict[str, Any] = {}
    for lin in ("lin_query", "lin_key", "lin_value", "lin_edge", "lin_skip"):
        p = _lin(sd, f"{prefix}.MHA.{lin}")
        if "bias" not in p:
            p["bias"] = np.zeros((p["kernel"].shape[1],), np.float32)
        out[lin] = p
    out["Dense_0"] = _lin(sd, f"{prefix}.FFN.0")
    out["Dense_1"] = _lin(sd, f"{prefix}.FFN.3")
    for i in (0, 1):
        out[f"LayerNorm_{i}"] = {"scale": _np(sd[f"{prefix}.norm{i + 1}.weight"]),
                                 "bias": _np(sd[f"{prefix}.norm{i + 1}.bias"])}
    return out


def import_gin(sd: Mapping[str, Any], num_layers: int = 5):
    """The reference's GNN (GIN) state dict -> (params, batch_stats) of
    ``GNN2D``."""
    params: Dict[str, Any] = {"AtomEncoder_0": {
        f"atom_embedding_{i}": {
            "embedding": _np(sd[f"atom_encoder.atom_embedding_list.{i}.weight"])}
        for i in range(9)}}
    stats: Dict[str, Any] = {}
    for l in range(num_layers):
        conv: Dict[str, Any] = {"BondEncoder_0": {
            f"bond_embedding_{i}": {
                "embedding": _np(sd[f"gnns.{l}.bond_encoder.bond_embedding_list.{i}.weight"])}
            for i in range(3)}}
        conv["Dense_0"] = _lin(sd, f"gnns.{l}.mlp.0")
        conv["MaskedBatchNorm_0"], bn_stats = _bn(sd, f"gnns.{l}.mlp.1")
        conv["Dense_1"] = _lin(sd, f"gnns.{l}.mlp.3")
        conv["eps"] = _np(sd[f"gnns.{l}.eps"])
        params[f"GINConv_{l}"] = conv
        stats[f"GINConv_{l}"] = {"MaskedBatchNorm_0": bn_stats}
        params[f"MaskedBatchNorm_{l}"], stats[f"MaskedBatchNorm_{l}"] = _bn(
            sd, f"batch_norms.{l}")
    return params, stats


def import_schnet(sd: Mapping[str, Any], num_interactions: int = 6):
    """The reference's SchNet state dict -> params of ``SchNet`` (no batch
    statistics); ``atomref`` (Embedding(100, 1), reference schnet.py:66-70)
    maps where the file has it, for a SchNet built with ``use_atomref``."""
    params: Dict[str, Any] = {"Embed_0": {"embedding": _np(sd["embedding.weight"])},
                              "Dense_0": _lin(sd, "lin1"), "Dense_1": _lin(sd, "lin2")}
    for k in range(num_interactions):
        params[f"SchNetInteraction_{k}"] = {
            "Dense_0": _lin(sd, f"interactions.{k}.mlp.0"),
            "Dense_1": _lin(sd, f"interactions.{k}.mlp.2"),
            "Dense_2": _lin(sd, f"interactions.{k}.conv.lin1"),
            "Dense_3": _lin(sd, f"interactions.{k}.conv.lin2"),
            "Dense_4": _lin(sd, f"interactions.{k}.lin")}
    if "atomref.weight" in sd:
        params["atomref"] = {"embedding": _np(sd["atomref.weight"])}
    return params


def import_painn(sd: Mapping[str, Any], n_interactions: int = 3):
    """The reference's PaiNN state dict -> params of ``PaiNN``: embedding
    -> Embed_0, filter_net -> filter_net,
    ``interactions.{i}.interatomic_context_net.{0,1}`` ->
    PaiNNInteraction_{i}.Dense_{0,1}, ``mixing.{i}.mu_channel_mix``
    (bias-free) -> PaiNNMixing_{i}.Dense_0 and
    ``mixing.{i}.intraatomic_context_net.{0,1}`` -> PaiNNMixing_{i}.Dense_{1,2}."""
    params: Dict[str, Any] = {"Embed_0": {"embedding": _np(sd["embedding.weight"])},
                              "filter_net": _lin(sd, "filter_net")}
    for i in range(n_interactions):
        params[f"PaiNNInteraction_{i}"] = {
            f"Dense_{j}": _lin(sd, f"interactions.{i}.interatomic_context_net.{j}")
            for j in (0, 1)}
        params[f"PaiNNMixing_{i}"] = {
            "Dense_0": _lin(sd, f"mixing.{i}.mu_channel_mix"),
            "Dense_1": _lin(sd, f"mixing.{i}.intraatomic_context_net.0"),
            "Dense_2": _lin(sd, f"mixing.{i}.intraatomic_context_net.1")}
    return params


def import_sde_2dto3d(sd: Mapping[str, Any], variant: int = 1, num_layers: int = 2,
                      num_convs: int = 2):
    """The reference's SDEModel2Dto3D_0{variant} state dict
    (SDE_model_2D_to_3D.py) -> (params, batch_stats) of ``SDEModel2Dto3D``.

    The pair Linear over ``concat(h_row, h_col)`` keeps its ``[2 emb, out]``
    kernel (variants 1-3 as a Dense, variant 4 as the raw kernel and bias);
    its BatchNorm1d becomes PairMaskedBatchNorm (variants 1-2); the basis
    MLP's first Linear splits into ``basis_node`` (rows :H, per node) and
    ``basis_edge`` (rows H:) halves."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    if variant in (1, 2):
        params["edge_2D_emb_0"] = _lin(sd, "edge_2D_emb.0")
        params["edge_2D_emb_bn"], stats["edge_2D_emb_bn"] = _bn(sd, "edge_2D_emb.1")
        params["edge_2D_emb_1"] = _lin(sd, "edge_2D_emb.3")
    elif variant == 3:
        params["edge_2D_emb"] = _lin(sd, "edge_2D_emb")
    else:
        lin = _lin(sd, "edge_2D_emb")
        params["edge_2D_emb_kernel"], params["edge_2D_emb_bias"] = lin["kernel"], lin["bias"]
    if variant in (3, 4):
        params["edge_emb"] = {"embedding": _np(sd["edge_emb.weight"])}
    params["coff_fourier_W"] = _np(sd["coff_gaussian_fourier.W"])
    params["coff_mlp"] = _lin(sd, "coff_mlp")
    params["project"] = _mlp(sd, "project", 2)
    if variant == 2:
        params["dist_fourier_W"] = _np(sd["dist_gaussian_fourier.W"])
        params["input_mlp"] = _mlp(sd, "input_mlp", 1)
    params["node_emb"] = _mlp(sd, "node_emb", 1)

    net: Dict[str, Any] = {}
    for m in range(num_layers):
        for c in range(num_convs):
            net[f"DenseGATLayer_{m * num_convs + c}"] = _gat_layer(
                sd, f"score_network.gnn_layers.{m}.{c}")
        w0 = _np(sd[f"score_network.basis_mlp_modules.{m}.0.weight"]).T
        h = w0.shape[0] // 2
        net[f"basis_node_{m}"] = {"kernel": w0[:h]}
        net[f"basis_edge_{m}"] = {"kernel": w0[h:],
                                  "bias": _np(sd[f"score_network.basis_mlp_modules.{m}.0.bias"])}
        net[f"basis_out_{m}"] = _lin(sd, f"score_network.basis_mlp_modules.{m}.2")
    params["score_network"] = net
    return params, stats


def import_sde_3dto2d(sd: Mapping[str, Any], num_layers: int = 4, num_linears: int = 3,
                      c_init: int = 2, c_hid: int = 8):
    """The reference's SDEModel3Dto2D_node_adj_dense state dict
    (SDE_model_3D_to_2D_node_adj_dense.py, invariant_scorenetwork_dense.py,
    layers/edge_network_dense.py) -> params of ``SDEModel3Dto2D``.

    The per-channel EdgeLayer banks (one module per adjacency channel) are
    stacked on a leading channel axis, as ``StackedEdgeLayers`` holds them;
    NodeNetwork_dense's ``weight`` is already ``[in, out]``
    (node_network_dense.py:33 ``matmul(x, self.weight)``) and maps without a
    transpose."""
    def node_net(prefix):
        out = {"kernel": _np(sd[f"{prefix}.weight"])}
        if f"{prefix}.bias" in sd:
            out["bias"] = _np(sd[f"{prefix}.bias"])
        return out

    edge: Dict[str, Any] = {}
    for i in range(num_layers):
        channels = range(c_init if i == 0 else c_hid)
        pre = f"edge_score_network.layers.{i}"
        attn: Dict[str, Any] = {}
        for fn, ours in (("func_q", "q"), ("func_k", "k")):
            for li in range(2):
                keys = [f"{pre}.attn.{c}.{fn}.layers.{li}" for c in channels]
                attn[f"{ours}_kernel_{li}"] = np.stack([_np(sd[f"{k}.weight"]).T for k in keys])
                attn[f"{ours}_bias_{li}"] = np.stack([_np(sd[f"{k}.bias"]) for k in keys])
        vs = [node_net(f"{pre}.attn.{c}.func_v") for c in channels]
        attn["v_kernel"] = np.stack([v["kernel"] for v in vs])
        attn["v_bias"] = np.stack([v.get("bias", np.zeros(v["kernel"].shape[1], np.float32))
                                   for v in vs])
        edge[f"layer_{i}"] = {"attn": attn,
                              "multi_channel": _mlp(sd, f"{pre}.multi_channel", 2),
                              "mlp": _mlp(sd, f"{pre}.mlp", num_linears)}
    edge["final"] = _mlp(sd, "edge_score_network.final", 3)
    node: Dict[str, Any] = {f"layer_{i}": {"Dense_0": node_net(f"node_score_network.layers.{i}")}
                            for i in range(num_layers)}
    node["final"] = _mlp(sd, "node_score_network.final", 3)
    return {"embedding_3D": _lin(sd, "embedding_3D"), "embedding_X": _lin(sd, "embedding_X"),
            "edge_score_network": edge, "node_score_network": node}


def import_pretrain_checkpoint(path: str, num_gin_layers: int = 5,
                               num_schnet_interactions: int = 6,
                               num_painn_interactions: int = 3,
                               sde_2dto3d_variant: int = 1):
    """Read a reference ``model_complete.pth`` (reference
    pretrain_MoleculeSDE.py:72-103) and import every component it holds:
    ``{"model_2D": (params, stats), "model_3D": params,
    "SDE_2Dto3D_model": (params, stats), "SDE_3Dto2D_model": params}``.
    ``model_3D`` is SchNet where it has ``lin1.weight`` (only SchNet has
    it), else PaiNN."""
    payload = load_torch_state_dict(path)
    out: Dict[str, Any] = {}
    if "model_2D" in payload:
        out["model_2D"] = import_gin(payload["model_2D"], num_gin_layers)
    if "model_3D" in payload:
        sd3 = payload["model_3D"]
        out["model_3D"] = (import_schnet(sd3, num_schnet_interactions) if "lin1.weight" in sd3
                           else import_painn(sd3, num_painn_interactions))
    if "SDE_2Dto3D_model" in payload:
        out["SDE_2Dto3D_model"] = import_sde_2dto3d(payload["SDE_2Dto3D_model"],
                                                    variant=sde_2dto3d_variant)
    if "SDE_3Dto2D_model" in payload:
        out["SDE_3Dto2D_model"] = import_sde_3dto2d(payload["SDE_3Dto2D_model"])
    return out


def load_imported(models: Mapping[str, nn.Module], imported: Mapping[str, Any]
                  ) -> Mapping[str, nn.Module]:
    """Copy :func:`import_pretrain_checkpoint`'s components into the port's
    modules of the same names, in place; every key and shape must match
    (:func:`~moleculesde_tpu_torch.convert.load_flax_pretrain`).  Returns
    ``models``."""
    params = {k: v[0] if isinstance(v, tuple) else v for k, v in imported.items()}
    stats = {k: v[1] for k, v in imported.items() if isinstance(v, tuple)}
    load_flax_pretrain({k: models[k] for k in imported}, params, stats)
    return models
