"""Pretraining configuration, the four models, the optimizer and the state
a run resumes from.

Counterpart of ``moleculesde_tpu/pretrain/train_state.py`` (reference
examples/pretrain_MoleculeSDE.py): the components {model_2D, model_3D,
SDE_2Dto3D_model, SDE_3Dto2D_model}, the SDE presets, and Adam with the 2D
and 3D learning-rate groups.  The port's parameters live in the modules and
its batch statistics in their buffers; :class:`PretrainState` gathers them
with the optimizer, the step generator and the step count, which is what
JAX's ``PretrainState`` holds (its random stream is a key folded with the
step; the port's is the generator's state).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from moleculesde_tpu_torch.models.gnn2d import GNN2D
from moleculesde_tpu_torch.models.painn import PaiNN
from moleculesde_tpu_torch.models.schnet import SchNet
from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D
from moleculesde_tpu_torch.models.score_3d2d import SDEModel3Dto2D
from moleculesde_tpu_torch.sde.base import SDE_PRESETS_2DTO3D, SDE_PRESETS_3DTO2D

GROUP_2D = ("model_2D", "SDE_2Dto3D_model")
GROUP_3D = ("model_3D", "SDE_3Dto2D_model")


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    """The JAX ``PretrainConfig``'s fields that the port's pretraining step
    reads, with the same names and defaults."""

    # 2D GNN (reference config.py:82-88)
    emb_dim: int = 300
    num_layer: int = 5
    jk: str = "last"
    dropout_ratio: float = 0.5
    gnn_type: str = "GIN"
    # 3D model (config.py:10-18, 66-78)
    model_3d: str = "SchNet"
    schnet_num_filters: int = 128
    schnet_num_interactions: int = 6
    schnet_num_gaussians: int = 51
    schnet_cutoff: float = 10.0
    schnet_readout: str = "mean"
    painn_radius_cutoff: float = 5.0
    painn_n_interactions: int = 3
    painn_n_rbf: int = 20
    painn_readout: str = "add"
    # SDE selection (config.py:107-114; presets resolved at build time)
    sde_type_2dto3d: str = "VE"
    sde_type_3dto2d: str = "VE"
    sde_2dto3d_variant: int = 1
    sde_3dto2d_variant: int = 1
    hidden_dim_2dto3d: int = 32
    # loss mixing (config.py:111-124)
    coeff_contrastive: float = 1.0
    coeff_generative_2dto3d: float = 1.0
    coeff_generative_3dto2d: float = 1.0
    anneal_power: float = 0.0
    use_extend_graph: bool = True
    noise_on_one_hot: bool = True
    # mixed precision, the CLI's --train_precision: "bfloat16" runs the pair
    # block, the 2D->3D score, SchNet, GIN and the 3D->2D attention in bf16
    # (the JAX config's five precision fields, all set from that one flag);
    # params, optimizer, losses and BatchNorm stay f32
    train_precision: str = "bfloat16"
    # CFConv, the JAX names: "auto" / "pallas" = the fused K2 pair (no
    # gradient to positions), "pallas_rbf" = K5 (the smearing built in the
    # kernel from the distances), "xla" = eager PyTorch
    schnet_cfconv: str = "auto"
    # microbatching (train_step.py): batches of more than ``microbatch``
    # molecules (0: off) run in B / microbatch chunks under
    # ``microbatch_scope`` "step" (gradient accumulation over the whole
    # loss) or "score" / "splice" (only the two score losses chunked; one
    # code path here, see train_step.py)
    microbatch: int = 0
    microbatch_scope: str = "step"
    # 3D->2D attention bank (SDEModel3Dto2D.attn_impl): "auto" = the eager
    # form (JAX's off-TPU default), "pallas" = the map kernel K7, "fused" =
    # the q/k-net and map kernel K8
    attn_impl_3dto2d: str = "auto"
    # contrastive (config.py:98-103)
    cl_similarity_metric: str = "EBM_node_dot_prod"
    T: float = 0.1
    cl_neg_samples: int = 1
    normalize: bool = False
    # optimizer (config.py:47-49, 88, 92)
    lr: float = 1e-4
    decay: float = 0.0
    gnn_2d_lr_scale: float = 1.0
    gnn_3d_lr_scale: float = 1.0

    @property
    def bf16(self) -> bool:
        if self.train_precision not in ("bfloat16", "float32"):
            raise ValueError(f"unknown train_precision {self.train_precision}")
        return self.train_precision == "bfloat16"

    @property
    def reduce_mean(self) -> bool:
        # reference pretrain_MoleculeSDE.py:305-308
        return self.noise_on_one_hot


def build_models(cfg: PretrainConfig, device: str | torch.device = "cuda",
                 generator: Optional[torch.Generator] = None,
                 impl: str = "auto", pair_cm_direct: bool = False) -> Dict[str, nn.Module]:
    """The four components at ``cfg``'s widths, initialized in order from
    ``generator`` (default: seed 0) on ``device``.  ``impl`` selects every
    kernel wrapper's implementation ("auto": the kernels on a CUDA device,
    the plain versions on the CPU; "plain" or "kernel" forces one).
    ``pair_cm_direct`` gives the 2D->3D model the channel-major pair kernel
    (``SDEModel2Dto3D(pair_cm_direct=True)``; not a config field, as in
    JAX).  JK "concat" raises a ``ValueError``: its
    ``emb_dim * (num_layer + 1)``-wide 2D node representations meet the
    ``emb_dim``-wide 3D ones in the contrastive loss, where the JAX
    package's step fails on the shapes."""
    if cfg.jk == "concat":
        raise ValueError(
            f"JK 'concat' gives {cfg.emb_dim * (cfg.num_layer + 1)}-wide 2D node "
            f"representations, which the contrastive loss pairs with {cfg.emb_dim}-wide 3D "
            f"ones: pretraining takes JK last, max or sum (the JAX package's step fails on "
            f"these shapes)")
    if cfg.schnet_cfconv not in ("auto", "xla", "pallas", "pallas_rbf"):
        raise ValueError(f"unknown schnet_cfconv {cfg.schnet_cfconv}")
    gen = generator or torch.Generator().manual_seed(0)
    compute_dtype = "bfloat16" if cfg.bf16 else None
    model_2d = GNN2D(num_layers=cfg.num_layer, emb_dim=cfg.emb_dim, jk=cfg.jk,
                     drop_ratio=cfg.dropout_ratio, gnn_type=cfg.gnn_type,
                     compute_dtype=compute_dtype,
                     msg_impl=impl, device=device, generator=gen)
    if cfg.model_3d == "SchNet":
        model_3d = SchNet(hidden_channels=cfg.emb_dim, num_filters=cfg.schnet_num_filters,
                          num_interactions=cfg.schnet_num_interactions,
                          num_gaussians=cfg.schnet_num_gaussians, cutoff=cfg.schnet_cutoff,
                          readout=cfg.schnet_readout, compute_dtype=compute_dtype,
                          cfconv=cfg.schnet_cfconv, impl=impl, device=device, generator=gen)
    elif cfg.model_3d == "PaiNN":
        model_3d = PaiNN(n_atom_basis=cfg.emb_dim, n_interactions=cfg.painn_n_interactions,
                         n_rbf=cfg.painn_n_rbf, cutoff=cfg.painn_radius_cutoff,
                         readout=cfg.painn_readout, compute_dtype=compute_dtype,
                         device=device, generator=gen)
    else:
        raise NotImplementedError(f"Model {cfg.model_3d} not included.")
    t23, bmin23, bmax23, n23 = SDE_PRESETS_2DTO3D[cfg.sde_type_2dto3d]
    sde_2dto3d = SDEModel2Dto3D(
        emb_dim=cfg.emb_dim, hidden_dim=cfg.hidden_dim_2dto3d,
        variant=cfg.sde_2dto3d_variant, sde_type=t23, beta_min=bmin23,
        beta_max=bmax23, num_diffusion_timesteps=n23,
        use_extend_graph=cfg.use_extend_graph, score_dtype=cfg.train_precision,
        bf16_pairs=cfg.bf16, pair_impl=impl, pair_cm_direct=pair_cm_direct,
        device=device, generator=gen)
    t32, bmin32, bmax32, n32 = SDE_PRESETS_3DTO2D[cfg.sde_type_3dto2d]
    # dense-net widths hard-coded by the reference's pretraining script
    # (pretrain_MoleculeSDE.py:309-315)
    sde_3dto2d = SDEModel3Dto2D(
        dim3d=cfg.emb_dim, c_init=2, c_hid=8, c_final=4, num_heads=4, adim=16,
        nhid=16, num_layers=4, num_linears=3, variant=cfg.sde_3dto2d_variant,
        sde_type=t32, beta_min=bmin32, beta_max=bmax32,
        num_diffusion_timesteps=n32, noise_on_one_hot=cfg.noise_on_one_hot,
        bf16_attn=cfg.bf16, attn_impl=cfg.attn_impl_3dto2d, kernel_impl=impl,
        device=device, generator=gen)
    return {"model_2D": model_2d, "model_3D": model_3d,
            "SDE_2Dto3D_model": sde_2dto3d, "SDE_3Dto2D_model": sde_3dto2d}


class PretrainAdam(torch.optim.Adam):
    """``torch.optim.Adam`` that, under weight decay, also steps the frozen
    parameters (``requires_grad=False``, the Fourier weights) as the JAX
    package's flattened Adam does: they get no gradient from autograd (JAX's
    ``stop_gradient``), so each is given a zero ``.grad`` before the step and
    the L2 term ``0 + decay * p`` moves it.  ``torch.optim.Adam`` would skip
    a parameter whose ``.grad`` is None."""

    def step(self, closure=None):
        for group in self.param_groups:
            if group["weight_decay"]:
                for p in group["params"]:
                    if p.grad is None and not p.requires_grad:
                        p.grad = torch.zeros_like(p)
        return super().step(closure)


def make_optimizer(models: Dict[str, nn.Module], cfg: PretrainConfig
                   ) -> torch.optim.Adam:
    """Adam with the reference's two LR groups (pretrain_MoleculeSDE.py:
    331-337): the 2D scale for {model_2D, SDE_2Dto3D_model}, the 3D scale
    for the rest.

    ``torch.optim.Adam`` is the JAX package's flattened Adam exactly: its
    ``weight_decay`` adds ``decay * p`` to the gradient (L2, not AdamW),
    and its step ``lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``
    is ``lr * m_hat / (sqrt(v_hat) + eps)`` with eps outside the square
    root; b1 0.9, b2 0.999, eps 1e-8.  Every parameter is in its group,
    the frozen Fourier weights too: the JAX package ravels them into its
    Adam with zero gradients, so at ``decay`` > 0 its L2 term moves them
    (:class:`PretrainAdam`); at ``decay`` 0 they stay put.  The reference
    keeps them frozen (``requires_grad=False``) under any decay."""
    groups = []
    for names, scale in ((GROUP_2D, cfg.gnn_2d_lr_scale), (GROUP_3D, cfg.gnn_3d_lr_scale)):
        params = [p for n in names for p in models[n].parameters()]
        groups.append({"params": params, "lr": cfg.lr * scale})
    return PretrainAdam(groups, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                        weight_decay=cfg.decay)


@dataclasses.dataclass
class PretrainState:
    """Everything a pretraining run resumes from: the four models (weights
    and batch statistics), Adam (moments, step, the groups' lr), the step
    generator (dropout masks and every loss draw) and the number of steps
    taken.  ``state_dict()`` holds CPU tensors and plain values only."""

    models: Dict[str, nn.Module]
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        def cpu(v):
            if torch.is_tensor(v):
                return v.detach().cpu().clone()
            return {k: cpu(x) for k, x in v.items()} if isinstance(v, dict) else v

        return {"models": {name: cpu(m.state_dict()) for name, m in self.models.items()},
                "optimizer": cpu(self.optimizer.state_dict()),
                "generator": self.generator.get_state(), "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore a :meth:`state_dict` into models and an optimizer built at
        the same widths; every component, key and shape must match."""
        if set(state["models"]) != set(self.models):
            raise KeyError(f"state has components {sorted(state['models'])}, "
                           f"not {sorted(self.models)}")
        for name, module in self.models.items():
            module.load_state_dict(state["models"][name])
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"])
        self.step = int(state["step"])


def create_pretrain_state(cfg: PretrainConfig, device: str | torch.device = "cuda",
                          seed: int = 0) -> PretrainState:
    """The four models at ``cfg``'s widths with weights drawn from ``seed``,
    their Adam and a step generator on ``device`` seeded with ``seed``, at
    step 0."""
    models = build_models(cfg, device, torch.Generator().manual_seed(seed))
    return PretrainState(models, make_optimizer(models, cfg),
                         torch.Generator(device=device).manual_seed(seed))
