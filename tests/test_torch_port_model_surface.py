"""The rest of the model surface through the port's CLIs: ``--gnn_type``
(GIN, GCN, GAT, GraphSAGE), ``--JK`` and ``--SDE_2Dto3D_model``
(SDEModel2Dto3D_01..04) in pretraining, the 2D->3D sampler and the
MoleculeNet finetune, on the CPU at tiny sizes.

- One pretraining step with GAT, JK "sum" and SDEModel2Dto3D_04 against
  the JAX step on the same weights and draws, f32, dropout off: the loss
  terms to 1e-5 relative, every gradient leaf to 1e-4 of its largest value
  (floored at 1e-2) and the updated BatchNorm statistics to 1e-5
  (tests/test_torch_port_pretrain.py's bars).  GAT's ``bias`` sits in front
  of a training-mode BatchNorm, so its gradient is zero in exact arithmetic
  and rounding noise on both sides: it is held to 1e-6 of the step's
  largest gradient.
- Each encoder, JK mode and 2D->3D score model drives each CLI that
  selects it: finite losses, conformers and AUCs in [0, 1].
- JK "concat" raises before any step in pretraining and in the sampler,
  where the JAX CLIs fail on the shapes; MoleculeNet runs it, as JAX does.
"""

import numpy as np
import pytest

from moleculesde_tpu_torch.examples import finetune_moleculenet as mnet_cli
from moleculesde_tpu_torch.examples import pretrain as cli
from moleculesde_tpu_torch.examples import sample_2d_to_3d as sample_cli
from moleculesde_tpu_torch.models.gnn2d import GATConv, GCNConv, GINConv, GraphSAGEConv

from test_torch_port_pretrain import TINY_FLAGS, check_whole_step, make_step_pair
from torch_port_common import CPU, ieee_f32  # noqa: F401 (ieee_f32: autouse)

SAMPLE_TINY = ["--device", "cpu", "--dataset", "synthetic", "--end", "1",
               "--num_repeat_SDE_inference", "2",
               "--n_max", "8", "--emb_dim", "16", "--num_layer", "2",
               "--num_diffusion_timesteps_2Dto3D_inference", "2", "--steps_pos", "1"]
MNET_TINY = ["--device", "cpu", "--n_max", "8", "--emb_dim", "16", "--num_layer", "2",
             "--batch_size", "8", "--epochs", "1", "--dataset", "synthetic",
             "--synthetic_molecules", "40"]
# each 2D encoder once, with the JK modes and 2D->3D score models spread
# over them (a drive per combination, not per flag, to keep the suite short)
MODEL_FLAGS = [["--gnn_type", "GCN", "--JK", "max", "--SDE_2Dto3D_model", "SDEModel2Dto3D_03"],
               ["--gnn_type", "GAT", "--JK", "sum", "--SDE_2Dto3D_model", "SDEModel2Dto3D_04"],
               ["--gnn_type", "GraphSAGE", "--SDE_2Dto3D_model", "SDEModel2Dto3D_02"]]
IDS = ["gcn_max_v3", "gat_sum_v4", "graphsage_v2"]
CONVS = {"GIN": GINConv, "GCN": GCNConv, "GAT": GATConv, "GraphSAGE": GraphSAGEConv}


def test_pretrain_step_gat_jk_sum_v4_matches_jax():
    check_whole_step(make_step_pair(gnn_type="GAT", jk="sum", sde_2dto3d_variant=4),
                     zero_grad=r"^model_2D\.GATConv_\d+\.bias$")


@pytest.mark.parametrize("flags", MODEL_FLAGS, ids=IDS)
def test_pretrain_cli_trains_with_model_flag(flags):
    history = cli.main(TINY_FLAGS + ["--epochs", "1"] + flags)
    assert len(history) == 1 and np.isfinite(list(history[0].values())).all()


@pytest.mark.parametrize("flags", MODEL_FLAGS, ids=IDS)
def test_sample_2d_to_3d_cli_runs_model_flag(flags):
    args = sample_cli.get_parser().parse_args(SAMPLE_TINY + flags)
    model_2d, sde_model = sample_cli.build_models(args, CPU)
    assert isinstance(getattr(model_2d, f"{args.gnn_type}Conv_0"), CONVS[args.gnn_type])
    assert model_2d.jk == args.JK
    assert sde_model.variant == sample_cli.MODEL_2DTO3D_VARIANTS[args.SDE_2Dto3D_model]
    res = sample_cli.main(SAMPLE_TINY + flags)
    assert res[0]["pos_gen"].shape[0] == 2 and np.isfinite(res[0]["pos_gen"]).all()


def test_jk_concat_raises_before_any_step_where_jax_fails():
    with pytest.raises(ValueError, match="concat"):
        cli.main(TINY_FLAGS + ["--epochs", "1", "--JK", "concat"])
    with pytest.raises(ValueError, match="concat"):
        sample_cli.main(SAMPLE_TINY + ["--JK", "concat"])


@pytest.mark.parametrize("flags", [["--gnn_type", "GCN", "--JK", "concat"],
                                   ["--gnn_type", "GAT", "--JK", "max"],
                                   ["--gnn_type", "GraphSAGE", "--JK", "sum"],
                                   ["--JK", "concat"]],
                         ids=["gcn_concat", "gat_max", "graphsage_sum", "gin_concat"])
def test_moleculenet_cli_runs_model_flag(flags):
    args = mnet_cli.parse_args(MNET_TINY + flags)
    model = mnet_cli.build_model(args, 3, CPU)
    assert isinstance(getattr(model.gnn, f"{args.gnn_type}Conv_1"), CONVS[args.gnn_type])
    assert model.graph_pred_linear.kernel.shape[0] == model.gnn.out_dim == (
        48 if args.JK == "concat" else 16)
    best_val, best_test = mnet_cli.main(MNET_TINY + flags)
    assert 0.0 <= best_val <= 1.0 and 0.0 <= best_test <= 1.0
