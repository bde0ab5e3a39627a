"""Port parity: the importer of the reference's ``.pth`` checkpoints
(moleculesde_tpu_torch/utils/torch_import.py) against the JAX package's
(moleculesde_tpu/utils/torch_import.py).

- One synthetic reference state dict per component and variant (GIN,
  SchNet with and without ``atomref``, PaiNN, SDEModel2Dto3D_01-04,
  SDEModel3Dto2D), drawn from a seeded numpy generator (Linear weights
  scaled by 1 / sqrt(fan_in), positive running variances, so that nothing
  overflows), handed over as numpy arrays and as a saved ``.pth``: both
  packages' ``import_*`` give the same tree, leaf for leaf (the same paths,
  ``np.array_equal``, float32).
- The imported tree loads into the port's module (every key used) and into
  the JAX module; their outputs on the same batch agree in f32 to the
  existing parity bars: encoders 1e-5 of the largest value, the 2D->3D loss
  1e-5 relative, the 3D->2D scores 1e-5.
- ``import_pretrain_checkpoint`` on a four-component ``model_complete.pth``
  equals JAX's and loads into the port's pretraining models; with a PaiNN
  ``model_3D`` JAX's raises ``KeyError`` (it takes any ``interactions.*``
  key for SchNet) where the port's imports it as JAX's ``import_painn``
  does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.models import GNN2D as JaxGNN2D
from moleculesde_tpu.models import PaiNN as JaxPaiNN
from moleculesde_tpu.models import SchNet as JaxSchNet
from moleculesde_tpu.models import SDEModel2Dto3D as JaxSDEModel2Dto3D
from moleculesde_tpu.models import SDEModel3Dto2D as JaxSDEModel3Dto2D
from moleculesde_tpu.utils import torch_import as jax_import
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.models.gnn2d import GNN2D
from moleculesde_tpu_torch.models.painn import PaiNN
from moleculesde_tpu_torch.models.schnet import SchNet
from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D
from moleculesde_tpu_torch.models.score_3d2d import SDEModel3Dto2D
from moleculesde_tpu_torch.pretrain.train_state import PretrainConfig, build_models
from moleculesde_tpu_torch.utils import torch_import as port_import

from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    both_batches, CPU, graphs, ieee_f32, rel_err, t)

EMB, H = 16, 8
SCHNET = dict(hidden_channels=EMB, num_filters=EMB, num_interactions=2, num_gaussians=11,
              cutoff=5.0)
PAINN = dict(n_atom_basis=EMB, n_interactions=2, n_rbf=8, cutoff=5.0)
SDE32 = dict(dim3d=8, nhid=4, num_layers=2, num_linears=2, c_init=2, c_hid=3, c_final=2,
             adim=4, num_heads=2)


class _Draw:
    """Seeded reference tensors: Linear weights ``[out, in]`` N(0, 1 /
    in), biases and norms N(0, 0.1) around 0 / 1, embeddings N(0, 0.5),
    running variances in [0.5, 1.5)."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.sd = {}

    def _put(self, key, a):
        self.sd[key] = np.asarray(a, np.float32)

    def lin(self, prefix, out, inp, bias=True):
        self._put(f"{prefix}.weight", self.rng.normal(size=(out, inp)) / np.sqrt(inp))
        if bias:
            self._put(f"{prefix}.bias", 0.1 * self.rng.normal(size=out))

    def norm(self, prefix, dim, running=True):
        self._put(f"{prefix}.weight", 1.0 + 0.1 * self.rng.normal(size=dim))
        self._put(f"{prefix}.bias", 0.1 * self.rng.normal(size=dim))
        if running:
            self._put(f"{prefix}.running_mean", 0.1 * self.rng.normal(size=dim))
            self._put(f"{prefix}.running_var", 0.5 + self.rng.random(dim))

    def emb(self, key, rows, dim):
        self._put(key, 0.5 * self.rng.normal(size=(rows, dim)))

    def raw(self, key, shape, scale=1.0):
        self._put(key, scale * self.rng.normal(size=shape))


def fake_gin(seed, num_layers=2, emb=EMB):
    d = _Draw(seed)
    for i, rows in enumerate([119, 4, 12, 12, 10, 6, 6, 2, 2]):
        d.emb(f"atom_encoder.atom_embedding_list.{i}.weight", rows, emb)
    for l in range(num_layers):
        for i, rows in enumerate([5, 6, 2]):
            d.emb(f"gnns.{l}.bond_encoder.bond_embedding_list.{i}.weight", rows, emb)
        d.lin(f"gnns.{l}.mlp.0", 2 * emb, emb)
        d.norm(f"gnns.{l}.mlp.1", 2 * emb)
        d.lin(f"gnns.{l}.mlp.3", emb, 2 * emb)
        d.raw(f"gnns.{l}.eps", (1,), 0.1)
        d.norm(f"batch_norms.{l}", emb)
    return d.sd


def fake_schnet(seed, atomref=False, w=SCHNET):
    d = _Draw(seed)
    hid, fil, g = w["hidden_channels"], w["num_filters"], w["num_gaussians"]
    d.emb("embedding.weight", 119, hid)
    d.lin("lin1", hid, hid)
    d.lin("lin2", hid, hid)
    for k in range(w["num_interactions"]):
        d.lin(f"interactions.{k}.mlp.0", fil, g)
        d.lin(f"interactions.{k}.mlp.2", fil, fil)
        d.lin(f"interactions.{k}.conv.lin1", fil, hid, bias=False)
        d.lin(f"interactions.{k}.conv.lin2", hid, fil)
        d.lin(f"interactions.{k}.lin", hid, hid)
    if atomref:
        d.raw("atomref.weight", (100, 1), 0.5)
    return d.sd


def fake_painn(seed, w=PAINN):
    d = _Draw(seed)
    f, n_int = w["n_atom_basis"], w["n_interactions"]
    d.emb("embedding.weight", 119, f)
    d.lin("filter_net", n_int * 3 * f, w["n_rbf"])
    for i in range(n_int):
        d.lin(f"interactions.{i}.interatomic_context_net.0", f, f)
        d.lin(f"interactions.{i}.interatomic_context_net.1", 3 * f, f)
        d.lin(f"mixing.{i}.mu_channel_mix", 2 * f, f, bias=False)
        d.lin(f"mixing.{i}.intraatomic_context_net.0", f, 2 * f)
        d.lin(f"mixing.{i}.intraatomic_context_net.1", 3 * f, f)
    return d.sd


def fake_sde_2dto3d(seed, variant, emb=EMB, h=H, coff=128):
    d = _Draw(seed)
    if variant in (1, 2):
        d.lin("edge_2D_emb.0", emb, 2 * emb)
        d.norm("edge_2D_emb.1", emb)
        d.sd["edge_2D_emb.1.num_batches_tracked"] = np.asarray(7)   # dropped, as in JAX
        d.lin("edge_2D_emb.3", h, emb)
    else:
        d.lin("edge_2D_emb", h, 2 * emb)
        d.emb("edge_emb.weight", 100, h)
    if variant == 2:
        d.raw("dist_gaussian_fourier.W", (h,))
        d.lin("input_mlp.layers.0", h, 2 * h)
    d.raw("coff_gaussian_fourier.W", (h,))
    d.lin("coff_mlp", h, 4 * h)
    d.lin("project.layers.0", h, 2 * h + 2)
    d.lin("project.layers.1", h, h)
    d.lin("node_emb.layers.0", h, emb)
    for m in range(2):
        for c in range(2):
            pre = f"score_network.gnn_layers.{m}.{c}"
            for lin in ("lin_query", "lin_key", "lin_value", "lin_skip"):
                d.lin(f"{pre}.MHA.{lin}", h, h)
            d.lin(f"{pre}.MHA.lin_edge", h, h, bias=False)     # PyG: no bias
            d.lin(f"{pre}.FFN.0", h, h)
            d.lin(f"{pre}.FFN.3", h, h)
            d.norm(f"{pre}.norm1", h, running=False)
            d.norm(f"{pre}.norm2", h, running=False)
        d.lin(f"score_network.basis_mlp_modules.{m}.0", coff, 2 * h)
        d.lin(f"score_network.basis_mlp_modules.{m}.2", 3, coff)
    return d.sd


def fake_sde_3dto2d(seed, dim3d=8, nhid=4, num_layers=2, num_linears=2, c_init=2, c_hid=3,
                    c_final=2, adim=4, nout=119):
    """The JAX package's test layout (tests/test_torch_import.py), seeded:
    per-channel q / k MLPs, NodeNetwork_dense values ``[in, out]``."""
    d = _Draw(seed)
    d.lin("embedding_3D", dim3d, dim3d)
    d.lin("embedding_X", dim3d, nout)
    for i in range(num_layers):
        a2 = 2 * (nhid if i == 0 else adim)
        f_in = dim3d if i == 0 else nhid
        c_in = c_init if i == 0 else c_hid
        c_out = c_final if i == num_layers - 1 else c_hid
        pre = f"edge_score_network.layers.{i}"
        for c in range(c_in):
            for fn in ("func_q", "func_k"):
                d.lin(f"{pre}.attn.{c}.{fn}.layers.0", a2, f_in)
                d.lin(f"{pre}.attn.{c}.{fn}.layers.1", a2, a2)
            d.raw(f"{pre}.attn.{c}.func_v.weight", (f_in, nhid), 1 / np.sqrt(f_in))
            d.raw(f"{pre}.attn.{c}.func_v.bias", (nhid,), 0.1)
        hidden = 2 * max(c_in, c_out)
        for li, (o, i_) in enumerate([(hidden, c_in * nhid), (nhid, hidden)]):
            d.lin(f"{pre}.multi_channel.layers.{li}", o, i_)
        dims = [2 * c_in] + [hidden] * (num_linears - 1) + [c_out]
        for li in range(num_linears):
            d.lin(f"{pre}.mlp.layers.{li}", dims[li + 1], dims[li])
    fdim = c_hid * (num_layers - 1) + c_final + c_init
    for li, (o, i_) in enumerate([(2 * fdim, fdim), (2 * fdim, 2 * fdim), (1, 2 * fdim)]):
        d.lin(f"edge_score_network.final.layers.{li}", o, i_)
    for i in range(num_layers):
        f_in = dim3d if i == 0 else nhid
        d.raw(f"node_score_network.layers.{i}.weight", (f_in, nhid), 1 / np.sqrt(f_in))
        d.raw(f"node_score_network.layers.{i}.bias", (nhid,), 0.1)
    nf = dim3d + num_layers * nhid
    for li, (o, i_) in enumerate([(2 * nf, nf), (2 * nf, 2 * nf), (nout, 2 * nf)]):
        d.lin(f"node_score_network.final.layers.{li}", o, i_)
    return d.sd


# component -> (fake state dict, import call for a module of either package)
COMPONENTS = {
    "gin": (lambda: fake_gin(1), lambda m, sd: m.import_gin(sd, num_layers=2)),
    "schnet": (lambda: fake_schnet(2), lambda m, sd: m.import_schnet(sd, num_interactions=2)),
    "schnet_atomref": (lambda: fake_schnet(3, atomref=True),
                       lambda m, sd: m.import_schnet(sd, num_interactions=2)),
    "painn": (lambda: fake_painn(4), lambda m, sd: m.import_painn(sd, n_interactions=2)),
    **{f"sde_2dto3d_v{v}": (lambda v=v: fake_sde_2dto3d(10 + v, v),
                            lambda m, sd, v=v: m.import_sde_2dto3d(sd, variant=v))
       for v in (1, 2, 3, 4)},
    "sde_3dto2d": (lambda: fake_sde_3dto2d(5),
                   lambda m, sd: m.import_sde_3dto2d(sd, num_layers=2, num_linears=2, c_init=2,
                                                     c_hid=3)),
}


def _assert_same_tree(mine, ref):
    mine_flat, ref_flat = _raw_leaves(mine), _raw_leaves(ref)
    assert sorted(mine_flat) == sorted(ref_flat)
    for key, a in mine_flat.items():
        b = ref_flat[key]
        assert a.dtype == np.float32 and b.dtype == np.float32, key
        assert np.array_equal(a, b), key


def _raw_leaves(tree, prefix="") -> dict:
    """Every leaf as given (no cast), by path."""
    if isinstance(tree, tuple):
        return {**_raw_leaves(tree[0], "params"), **_raw_leaves(tree[1], "batch_stats")}
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_raw_leaves(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _load(module, tree):
    params, stats = tree if isinstance(tree, tuple) else (tree, {})
    return load_flax_variables(module, {"params": params, "batch_stats": stats})


@pytest.mark.parametrize("source", ["numpy", "pth"])
@pytest.mark.parametrize("component", sorted(COMPONENTS))
def test_port_import_equals_jax_import(component, source, tmp_path):
    fake, call = COMPONENTS[component]
    sd = fake()
    if source == "pth":
        path = str(tmp_path / "component.pth")
        torch.save({"sd": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
        sd_port = port_import.load_torch_state_dict(path)["sd"]
        sd_jax = jax_import.load_torch_state_dict(path)["sd"]
        assert all(torch.is_tensor(v) for v in sd_port.values())
    else:
        sd_port = sd_jax = sd
    _assert_same_tree(call(port_import, sd_port), call(jax_import, sd_jax))


@pytest.fixture(scope="module")
def batches():
    return both_batches(graphs(seed=51, count=3, n_max=8), n_max=8)


def _encoder_pair(name, tree):
    """(JAX output fn, port output fn, the port module) of an encoder."""
    if name == "gin":
        jm = JaxGNN2D(num_layers=2, emb_dim=EMB)
        tm = _load(GNN2D(num_layers=2, emb_dim=EMB, device=CPU), tree)
        return (lambda jb: jm.apply({"params": tree[0], "batch_stats": tree[1]}, jb,
                                    deterministic=True, use_running_average=True),
                lambda tb: tm(tb, use_running_average=True), tm)
    if name.startswith("schnet"):
        ref = name == "schnet_atomref"
        jm = JaxSchNet(**SCHNET, use_atomref=ref, readout="add", agg="reduce")
        tm = _load(SchNet(**SCHNET, use_atomref=ref, readout="add", device=CPU), tree)
    else:
        jm = JaxPaiNN(**PAINN)
        tm = _load(PaiNN(**PAINN, device=CPU), tree)
    return (lambda jb: jm.apply({"params": tree}, jb.atomic_numbers, jb.positions,
                                jb.node_mask, jb.num_graphs, jb.n_max),
            lambda tb: tm.encode_batch(tb), tm)


@pytest.mark.parametrize("name", ["gin", "schnet", "schnet_atomref", "painn"])
def test_encoder_from_imported_tree_matches_jax(batches, name):
    """Encoder outputs from the imported tree, f32, 1e-5 of the largest
    value; SchNet's ``atomref`` moves the output (it is read)."""
    jb, tb = batches
    fake, call = COMPONENTS[name]
    tree = call(port_import, fake())
    jax_fn, port_fn, tm = _encoder_pair(name, tree)
    ref = jax.jit(jax_fn)(jb)
    with torch.no_grad():
        out = port_fn(tb)
    for mine, theirs in zip(out if isinstance(out, tuple) else (out,),
                            ref if isinstance(ref, tuple) else (ref,)):
        assert np.isfinite(mine.numpy()).all()
        assert rel_err(mine.numpy(), theirs) < 1e-5
    if name == "schnet_atomref":
        tm.atomref = None
        with torch.no_grad():
            assert rel_err(tm.encode_batch(tb)[1].numpy(), ref[1]) > 1e-3


@pytest.mark.parametrize("variant", [1, 2, 3, 4])
def test_sde_2dto3d_loss_from_imported_tree_matches_jax(batches, variant):
    """The 2D->3D loss (training-mode pair BatchNorm, dropout off) from the
    imported tree on the replayed draws, f32, 1e-5 relative."""
    jb, tb = batches
    fake, call = COMPONENTS[f"sde_2dto3d_v{variant}"]
    params, stats = call(port_import, fake())
    node_2d = np.random.default_rng(7).normal(size=(jb.num_nodes, EMB)).astype(np.float32)
    jm = JaxSDEModel2Dto3D(emb_dim=EMB, hidden_dim=H, variant=variant, pair_impl="xla",
                           score_dtype="float32")
    key = jax.random.PRNGKey(3)
    loss_j = jax.jit(lambda n2d: jm.apply(
        {"params": params, "batch_stats": stats}, n2d, jb, key, 0.0, deterministic=True,
        use_running_average=False, mutable=["batch_stats"],
        method=JaxSDEModel2Dto3D.loss)[0]["position"])(jnp.asarray(node_2d))
    k_noise, k_t = jax.random.split(key)
    draws = {"pos_noise": t(jax.random.normal(k_noise, jb.positions.shape)),
             "half": t(jax.random.randint(k_t, (jb.num_graphs // 2 + 1,), 0, 1000)).long()}
    tm = _load(SDEModel2Dto3D(emb_dim=EMB, hidden_dim=H, variant=variant, device=CPU),
               (params, stats))
    with torch.no_grad():
        loss_t = tm.loss(t(node_2d), tb, deterministic=True, use_running_average=False,
                         draws=draws)
    assert np.isfinite(loss_t.item())
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))


def test_sde_3dto2d_scores_from_imported_tree_match_jax(batches):
    """Both 3D->2D scores at a noisy state from the imported tree, f32,
    1e-5 of the largest value."""
    jb, tb = batches
    fake, call = COMPONENTS["sde_3dto2d"]
    params = call(port_import, fake())
    rng = np.random.default_rng(8)
    b, n = jb.num_graphs, jb.n_max
    flags = (np.arange(n)[None] < np.asarray(jb.node_mask).reshape(b, n).sum(1)[:, None])
    flags = flags.astype(np.float32)
    adj = rng.normal(size=(b, n, n)).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2 * flags[:, :, None] * flags[:, None, :]
    args = [rng.normal(size=(b, n, SDE32["dim3d"])).astype(np.float32),
            rng.normal(size=(b, n, 119)).astype(np.float32) * flags[:, :, None], adj, flags,
            rng.uniform(0.1, 1.0, size=(b,)).astype(np.float32)]
    jm = JaxSDEModel3Dto2D(**SDE32, bf16_attn=False)
    ref = jax.jit(lambda *a: jm.apply({"params": params}, *a, method=JaxSDEModel3Dto2D.scores)
                  )(*[jnp.asarray(a) for a in args])
    tm = _load(SDEModel3Dto2D(**SDE32, bf16_attn=False, device=CPU), params)
    with torch.no_grad():
        out = tm.scores(*(t(a) for a in args))
    for mine, theirs in zip(out, ref):
        assert np.isfinite(mine.numpy()).all()
        assert rel_err(mine.numpy(), theirs) < 1e-5


def _write_checkpoint(path, model_3d):
    """A reference ``model_complete.pth`` at the tiny pretraining widths:
    GIN 2 x 16, SchNet or PaiNN, SDEModel2Dto3D_01 (hidden 16) and the
    reference's 3D->2D defaults (4 layers, 3 linears, c_init 2, c_hid 8)."""
    sd3 = (fake_schnet(22, w=dict(SCHNET, num_filters=8)) if model_3d == "SchNet"
           else fake_painn(23, w=dict(PAINN, n_rbf=20)))
    payload = {"model_2D": fake_gin(21),
               "model_3D": sd3,
               "SDE_2Dto3D_model": fake_sde_2dto3d(24, 1, h=16),
               "SDE_3Dto2D_model": fake_sde_3dto2d(25, dim3d=EMB, nhid=16, num_layers=4,
                                                   num_linears=3, c_init=2, c_hid=8,
                                                   c_final=4, adim=16)}
    torch.save({name: {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
                for name, sd in payload.items()}, path)
    return payload


@pytest.mark.parametrize("model_3d", ["SchNet", "PaiNN"])
def test_import_pretrain_checkpoint_loads_into_the_port(model_3d, tmp_path):
    """The four components of a ``model_complete.pth``: the port's tree
    equals JAX's (SchNet) or JAX's ``import_painn`` (PaiNN, where JAX's
    entry point raises KeyError); every component loads into the
    pretraining models, every key used, and equals its ``.pth`` tensor under
    the mapping."""
    path = str(tmp_path / "model_complete.pth")
    payload = _write_checkpoint(path, model_3d)
    kw = dict(num_gin_layers=2, num_schnet_interactions=2, num_painn_interactions=2)
    mine = port_import.import_pretrain_checkpoint(path, **kw)
    if model_3d == "SchNet":
        ref = jax_import.import_pretrain_checkpoint(path, **kw)
        assert sorted(mine) == sorted(ref)
        for name in mine:
            _assert_same_tree(mine[name], ref[name])
    else:
        with pytest.raises(KeyError, match="lin1.weight"):
            jax_import.import_pretrain_checkpoint(path, **kw)
        _assert_same_tree(mine["model_3D"], jax_import.import_painn(
            jax_import.load_torch_state_dict(path)["model_3D"], n_interactions=2))
    cfg = PretrainConfig(emb_dim=EMB, num_layer=2, schnet_num_filters=8,
                         schnet_num_interactions=2, schnet_num_gaussians=11,
                         hidden_dim_2dto3d=16, model_3d=model_3d, painn_n_interactions=2)
    models = port_import.load_imported(build_models(cfg, CPU), mine)
    state = models["model_2D"].state_dict()
    np.testing.assert_array_equal(state["GINConv_1.Dense_0.kernel"].numpy(),
                                  payload["model_2D"]["gnns.1.mlp.0.weight"].T)
    np.testing.assert_array_equal(state["GINConv_1.MaskedBatchNorm_0.var"].numpy(),
                                  payload["model_2D"]["gnns.1.mlp.1.running_var"])
    edge = models["SDE_3Dto2D_model"].state_dict()
    np.testing.assert_array_equal(          # stacked channels, [in, out] as given
        edge["edge_score_network.layer_1.attn.v_kernel"][5].numpy(),
        payload["SDE_3Dto2D_model"]["edge_score_network.layers.1.attn.5.func_v.weight"])
