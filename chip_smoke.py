"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, then drives the ported paths
at full width -- 2D->3D conformer generation through the sampler CLI (the
channel-major chain, the fused chain and the pair_cm_direct chain), 3D->2D
graph generation through its CLI (three forms of the attention bank), and
pretraining steps through the pretraining CLI's functions (padded ingest
with K2; the JAX CLI's default compact ingest with K5; the three
microbatch scopes; PaiNN; the default path at n_max 64 and 128, also with
the K7 and K8 attention banks; the CLI's ``main`` on size buckets, with the
native collation and a resume from its train state), and the three
finetune CLIs (MoleculeNet with K1, QM9 with K2, MD17 with none), then the
rest of the model surface (SDEModel2Dto3D variants 3 and 4 in the sampler
and pretraining, GCN / GAT / GraphSAGE and the JK modes in pretraining and
MoleculeNet), then the pretraining and both sampler CLIs on a PCQM4Mv2
packed cache the script writes, then data parallelism (a 1-rank NCCL
group, two gloo ranks sharing the card), then the utilities (the
reference's ``.pth`` checkpoints imported, the NaN guard, the profiler
trace, matrix-product FLOPs), then the fused 2D->3D score at other
widths (the 2D->3D model 64 and 128 wide) -- and checks what comes out.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit; build every kernel (one nvcc per source);
     no spill in K6's four-chunk instantiations or in K7's forward and backward;
     the CFConv forward's and backward's SASS and every bf16 instantiation
     of K6 and of the pair block's forward and backward (K3 and K4) hold
     HMMA (their tensor-core products), counted per kernel function, and
     the pair block's f32 instantiations none; so does K8's backward (its
     weight gradients on mma.sync in bf16 mode); K6's layered plan
     (``csrc/score_layered.cu``) holds HMMA in the bf16 front, GAT and basis
     passes and none in f32 mode, and its registers and spills are printed;
  2. kernel phases on the operands each path gives each kernel, in f32 and
     bf16 mode: K1 (GIN message block), K3 (pair block) and K4 (its
     channel-major form) forward on the sampler's operands; K1, K2 (CFConv),
     K3 and K4 forward and backward on the pretraining step's (the
     backward's cotangent is a seeded normal draw of the output's shape);
     K6 (the fused score evaluation), variants 1 and 2, on the fused chain's.
     Each is held against its plain version (output and every gradient),
     and so is its ``matmul_flops`` (the wrapper's report from the operand
     shapes against the plain version's products), as integers; so are
     K4's, K6's, K7's and K8's in phases 4, 6 and 13; CUDA-event medians
     of kernel and plain times and the card's bound for the same work;
     two runs of K1's, K3's and K4's forward and backward on the
     pretraining step's operands, bit for bit;
  3. sampler path: the sampler CLI at full width (GIN 5 x 300,
     SDEModel2Dto3D variant 1, VE, hidden 32, bf16 score) on 8 synthetic
     molecules x 8 repeats (B=64, n_max 32), 20 PC steps with 1 corrector
     step each (the CLI's default is 100 corrector steps: depth cut for the
     smoke run), random weights from the seed.  Launch counts are read
     around that run; then the conditioning is compared with an all-plain
     build of the same weights, and the chain is timed;
  4. fused chain: K6's launch plan per n_max (cluster size) and K6 against
     its plain version also on the chain's operands at ``--n_max 64`` and
     ``--n_max 128`` (B=64, variants 1 and 2, bf16 2e-2 and f32 1e-4 of max
     |plain|), every K6 phase two launches bit for bit; at ``--n_max 129``
     (B=64) too, past the cluster plan, in the layered plan (the cluster
     plan forced there refused, naming its limit); 3 f32 PC steps of the fused chain at
     n_max 128 against the channel-major chain on the same weights and
     draws (K6 6 launches); the same chain at n_max 32 with ``fused=True``
     (launches K1 5, K3 1, K6 40), conformers/s against the channel-major
     chain in turns, wall and device-busy time under the profiler beside
     the earlier kernel's, and 5 f32 steps against the channel-major chain
     on the same weights and draws (atol 2e-4, rtol 1e-3);
  5. pair_cm_direct chain: K4 forward once, K3 never; K4's edge features
     against K3's;
  6. 3D->2D chain: the sampler CLI's models at full width (SchNet 6 x 128,
     eager CFConv; SDEModel3Dto2D variant 1, VE, bf16 bank) on B=128
     synthetic molecules, n_max 32, 20 PC steps x 2 corrector steps (CLI
     default 100: depth cut).  K7 (attention-map bank) and K8 (q/k nets and
     map bank), forward and backward, against their plain versions on the
     chain's edge-layer 0 and 1 operands in bf16 (3e-3 of max |plain|; K7's
     f32 maps 1e-4) and f32 (1e-4, operands from the q / k nets in f32),
     each kernel two runs bit for bit, and all four again on the chain's
     operands at ``--n_max 64``, B=128 (both layers and modes, the same
     bars, bit for bit); then one counted
     chain per form of the bank ("auto" through the CLI's main: no bank
     kernel; "pallas": K7 240; "fused": K8 240), graphs/s in turns, and 3
     f32 steps of the K7 and K8 chains against the "auto" chain on the same
     weights and draws (atol 2e-4, rtol 1e-3); the "fused" chain's wall and
     device-busy time under the profiler beside the earlier kernel's;
  7. training path: the pretraining CLI's models at full width (defaults:
     GIN 5 x 300, SchNet 6 x 128, both SDE models, InfoNCE, bf16) on B=128
     synthetic molecules, n_max 32; one warm-up step, then five timed steps
     with the launch counts read around them (5 / 5 / 6 / 6 / 1 / 1 per
     step); every metric finite; then one step's loss terms, gradient
     norms per component and the kernels' own gradient leaves, one by one,
     against an all-plain build of the same weights and draws;
  8. pair_cm_direct training: two steps (K4 forward and backward once per
     step, K3 never), then one step's losses and K4's gradient leaves
     against the K3 build of the same weights and draws;
  9. bank training: two steps each with ``attn_impl_3dto2d`` "pallas" (K7
     forward and backward 4 per step) and "fused" (K8, 4 and 4), then one
     step's losses (1e-3) and the edge network's q / k gradient leaves (5e-2
     relative L2) of each against the "auto" build;
 10. compact path: the pretraining CLI at the JAX CLI's defaults (compact
     ingest, the extended graph built on the card) with ``--schnet_cfconv
     pallas_rbf``, B=128: the first batch expanded on the card against the
     padded collation of the same molecules; K5 (CFConv with the Gaussian
     smearing built in the kernel) forward and backward against its plain
     version on SchNet interaction 0's operands, bf16 and f32; one warm-up
     and five timed steps with the launch counts per step (K1 5 / 5, K5 6 /
     6, K3 1 / 1, K2 none), every metric finite; one step against an
     all-plain build as in 7;
 11. microbatch: B=256 in two chunks of 128 on the compact K5 path, two
     steps per scope with their launch counts ("step" K1 10 / 10, K5 12 / 12,
     K3 2 / 2; "score" and "splice", one code path, K1 5 / 5, K5 6 / 6, K3
     2 / 2), every metric finite;
 12. PaiNN: two steps with ``--model_3d PaiNN`` at full width (emb 300, 3
     interactions, 20 radial functions), K1 5 / 5 and K3 1 / 1 per step,
     every metric finite, step ms printed;
 13. n_max 64 and 128: the JAX CLI's default path (compact ingest, K2) at
     ``--n_max 64``, B=128, then at ``--n_max 128``, B=32 (the CLI's B=128
     cut to 32): K2 and K5 forward and backward against their plain
     versions on its operands (bf16 and f32, the bars of 7), two forward
     and two backward runs of each bit for bit and K5's forward and
     backward equal to K2's on the same smearing; K1 forward and backward
     on GIN layer 0's operands and K3 and K4 on the edge embedding's
     against their plain versions at the bars of 7, two runs of K1's,
     K3's and K4's forward and backward bit for bit in both modes; K3 and
     K4 forward also at N = 256, B = 2 (past the first forward's N <= 160)
     on seeded operands against their plain versions; two steps with K1 5 /
     5, K2 6 / 6, K3 1 / 1 per step, every metric finite; a third step's
     wall and device-busy time under the profiler and the peak device
     memory; one step against an all-plain build as in 7; then two steps
     each with ``attn_impl_3dto2d`` "pallas" and "fused" (K7 or K8 4 / 4,
     K1 5 / 5, K2 6 / 6, K3 1 / 1 per step, every metric finite), a third
     "fused" step profiled (wall, device busy, peak memory), and one
     step's losses (1e-3) and q / k gradient leaves of each against the
     "auto" build, as in 9.  At n_max 128 also K7 and K8, forward and
     backward, on the 3D->2D chain's edge-layer operands at B=32 as in 6,
     and both at N = 256, B = 2 on seeded operands (K8 at F = 16, C = 8),
     K7 also at N = 600, B = 1, C = 8 (past its old backward's N <= 518),
     each kernel two runs bit for bit.
 14. buckets: the port's C++ collator against its numpy collation on a
     B=128, n_max 32 batch, bit for bit, host ms per batch of each; the
     pretraining CLI's ``main`` at the JAX CLI's defaults plus ``--n_max
     128 --buckets 16 32 64 128 --batch_size 32 --synthetic_molecules 512
     --epochs 1`` (about 15 steps over four buckets, padded batches), every
     step K1 5 / 5, K2 6 / 6, K3 1 / 1, every metric finite, ``metrics.csv``
     and ``train_state.pt`` written; on the 16-atom bucket's first batch K1,
     K2, K3 and K4 forward and backward against their plain versions (bf16
     and f32, the bars of 7, two runs bit for bit), K7 and K8 at N = 16, B
     = 32 on seeded operands (the bars of 6) and one f32 step against an
     all-plain f32 build as in 7 (the bf16 step's differences printed, with
     no bar); ``train_state.pt`` loaded into a fresh state, one step
     on that batch by it and by the run's own state, bit for bit; one epoch
     of the same 512 molecules at ``--n_max 128`` without buckets (compact
     ingest) and with them, in turns, molecules/s.
 15. finetunes: each finetune CLI's ``main`` at its defaults on synthetic
     molecules, cut to 512 molecules and 2 epochs, with the launch counts
     read around it and per step and evaluation batch: MoleculeNet (GIN 5 x
     300, dropout 0.5, mean pool, B=128, 3 tasks, n_max 32; K1 5 / 5 per
     step, 5 per evaluation batch, f32), QM9 (SchNet 6 x 128 x 51, hidden
     300, B=128, ``--split random``; K2 6 / 6 per step, 6 per evaluation
     batch, f32), MD17 with SchNet (eager CFConv) and with PaiNN (B=32; no
     kernel launch at all); every metric finite, every AUC in [0, 1], the
     outputs written.  On each CLI's first training batch K1 (MoleculeNet)
     and K2 (QM9) forward and backward against their plain versions in f32
     (7's bar, 1e-4), two runs of each bit for bit, and one step's loss and
     gradient norm per component against an all-plain build (1e-4); MD17's
     forces against central differences of the energy in f64 on three
     coordinates (1e-5); the molecules/s of two training epochs of each;
     the pretraining CLI's ``model_complete.pt`` (its defaults, 128
     molecules, one epoch) into the MoleculeNet and QM9 CLIs, every loaded
     parameter equal to the checkpoint's, one epoch of each.
 16. model surface: the sampler CLI's ``main`` with ``--SDE_2Dto3D_model
     SDEModel2Dto3D_03``, then ``_04`` (the setting of 3 otherwise: bf16
     score, B=64, n_max 32, 20 PC x 1 corrector step), launches K1 5, K3 0,
     K4 0; each variant's K6 (kernel variant 1 on its own conditioning)
     against its plain version on the fused chain's operands, bf16 and f32
     (4's bars), two launches bit for bit; the counted fused chain (K1 5,
     K6 40), conformers/s of both chains in turns and 5 f32 steps of the
     fused chain against the channel-major chain (atol 2e-4, rtol 1e-3).
     The pretraining CLI's models at its defaults (compact ingest, K2) plus
     ``--SDE_2Dto3D_model SDEModel2Dto3D_04 --JK sum``, B=128, n_max 32:
     two steps with K1 5 / 5, K2 6 / 6, K3 0 / 0 per step, every metric
     finite, one step against an all-plain build as in 7; one step each
     with ``--gnn_type GCN``, ``GAT`` and ``GraphSAGE`` and
     SDEModel2Dto3D_03 (K1 0 / 0, K2 6 / 6), every metric finite.  The
     MoleculeNet CLI's ``main`` with ``--JK concat`` (K1 5 / 5 a step, 5
     per evaluation batch, f32) and with ``--gnn_type GAT`` (no kernel),
     512 molecules and 1 epoch each, every AUC in [0, 1].
 17. packed data: 4096 synthetic molecules of 4-48 atoms from seed 42
     (1448 past 32) with a ``y``, written as ``load_pcqm4mv2`` caches them
     (``<tmp>/PCQM4Mv2/packed_ext1_n4096``, and the first 4 / 128 for the
     samplers' ``--end``), so no RDKit is needed; ``PackedGraphs.load``
     seconds.  The pretraining CLI's ``main`` with ``--dataset PCQM4Mv2
     --input_data_dir <tmp> --max_molecules 4096 --epochs 1``, otherwise at
     its defaults (compact ingest, full width, B=128, n_max 32; 32 steps),
     then with ``--buckets 16 32 64`` (padded) and with ``--n_max 0`` (the
     suggested 64): the loader holds the memory-mapped ``PackedGraphs`` (a
     ``PackedSubset`` per bucket), every step K1 5 / 5, K2 6 / 6, K3 1 / 1,
     every metric finite, ``model_complete_final.pt`` written.  One B=128
     batch of molecules of 32 atoms or fewer by ``collate_compact_packed``
     and by ``collate_compact`` of the same molecules as dicts: every
     tensor equal, one step's loss terms and gradient norms on each bit for
     bit, host ms per batch of each; one epoch of the cache with and
     without buckets in turns, molecules/s.  The 2D->3D sampler CLI on the
     cache (``--end 4 --num_repeat_SDE_inference 2``, 20 PC x 1 corrector
     step: the CLI's 100 corrector steps cut; ``--n_max 64`` where a
     molecule has more than 32 atoms, after the default has refused it by
     name), K1 5 and K3 1 a chain, finite COV / MAT for every molecule; the
     3D->2D sampler CLI on it (``--end 128``, 20 PC x 2 corrector steps), no
     kernel, finite graphs.
  18. data parallelism (``parallel/``) at the pretraining CLI's defaults
     (compact, K2, B=128, n_max 32): ``--num_devices 2`` refused on the one
     card, naming 1 visible card; a 1-rank NCCL group (``env://``) whose
     step launches K1 5 / 5, K2 6 / 6, K3 1 / 1 and whose loss terms,
     gradient norms and running statistics equal the step with no group to
     1e-5; two gloo ranks sharing the card (NCCL refuses two ranks on one
     device; the collectives stage through host memory), 64 graphs each,
     against the one-process step on the global batch: loss terms,
     gradient norms before Adam and running statistics, f32 1e-4, bf16
     1e-2 (``DP_PRECISIONS``), each bar checked to sit below two planted
     faults' readings (BatchNorm statistics per rank, gradients summed
     over the ranks), beside the all-plain build's readings and one
     process's bf16 against f32; each rank's launches as above;
     the 2D->3D chain of phase 3 in f32 on the two ranks (32 clones each)
     against one process (atol 2e-4, rtol 1e-3; K1 5, K3 1 a rank); the
     shared-card step's and gradient all-reduce's wall ms, labelled as two
     ranks on one card, not scaling.
  19. the utilities: two ``model_complete.pth`` in the reference's key
     layout at the pretraining CLI's widths (GIN 5 x 300, SchNet 6 x 128
     filters x 51 Gaussians or PaiNN 3 x 300, SDEModel2Dto3D_01,
     SDEModel3Dto2D variant 1; seeded weights at PyTorch's initializers'
     scale, Linear weights U(+-1 / sqrt(fan_in)), positive running
     variances) imported by
     ``utils/torch_import.py::import_pretrain_checkpoint`` and loaded into
     the CLI's models on the card, every parameter and buffer equal to its
     ``.pth`` tensor under the mapping (``reference_leaf``, stated from the
     port's side), each 3D encoder's output finite.  From the SchNet
     import: the sampler CLI's chain of 3 (K1 5, K3 1 counted), its
     conditioning against the all-plain build at phase 3's bars; one step
     at the CLI's defaults (compact, bf16, B=128) against the all-plain
     build at phase 7's bars; the same step from a third checkpoint drawn
     at a wider scale (``_RefDraw``'s "wide": a CL loss near 700), held
     against the all-plain bf16 step, and, with the all-plain bf16 step,
     against the all-plain f32 step (the witnesses), its f32 kernels
     against the all-plain f32 step, at the bars ``WIDE_BARS`` set from
     those readings and two planted faults of K1; ``matmul_flops`` of that step (forward and
     backward) with the kernels (their reports) and all-plain, equal
     integers; two steps under the NaN guard of ``--debug_nans`` and two
     without (K1 5 / 5, K2 6 / 6, K3 1 / 1 each), and one of each at
     ``--ingest padded``, metrics, parameters, statistics and Adam's state
     bit for bit, wall ms of each; a NaN planted in
     ``model_2D.GINConv_0.Dense_0`` raising ``FloatingPointError`` that
     names it, after K1 ran; the CLI's ``main`` with ``--profile_dir`` and
     ``--debug_nans`` on 256 molecules (one epoch of 2 steps): its trace
     holds the CUDA events of K1, K2 and K3, forward and backward, as many
     as the steps launched;
 20. every N the JAX kernels take (``large_plans_path``): K1 in its ranges
     plan (N = 2048, B = 2, E = 4 N, D = 13, F = 300; D = 40 at N = 128),
     K3 and K4's backward in the tiled plan (N = 2048, B = 1, H = 32; N =
     1024, B = 2, H = 64, two passes of h) and K8 in its tiled plan on the
     3D->2D chain's edge layer 1 and 0 operands at n_max 512 and 1024, B =
     2, each against its plain version in bf16 and f32 at the bars of the
     phases above, ``matmul_flops`` equal, two runs bit for bit, timed
     beside its bound; K8's backward at N = 256, B = 2 in both plans in
     turns (the same dqk bits); then the JAX CLI's default pretraining
     path at ``--n_max 1024``, B = 2: K1, K3 and K4 on its operands, two
     steps (K1 5 / 5, K2 6 / 6, K3 1 / 1 a step), a profiled step and its
     peak memory, one step against an all-plain build, two "fused" bank
     steps (K8 4 / 4 a step, a profiled third), one held against the same
     step with K8's plain version in bf16 and the "auto" build in f32 (at
     this N the bf16 step's q / k leaves are ill conditioned: the "auto"
     form, which rounds its logits and tanh to bf16, lies ~3x their size
     from the f32 step, and so does K8's; the two are held within 1.25x of
     each other's distance there), and two ``pair_cm_direct`` steps and
     one against the all-plain ``pair_cm_direct`` build; and the
     2D->3D sampler chain at ``--n_max 1024``, B = 2 (K1 5, K3 1), its
     conditioning against the all-plain build at phase 3's bars.
 21. the last shapes the JAX kernels take (``last_shapes_path``): K6 in its
     layered plan on the sampler CLI's models and one synthetic molecule at
     n_max 129, 256, 1024 (B = 2) and 2048 (B = 1), variants 1 and 2, bf16
     and f32 at phase 4's bars, two launches bit for bit, the plan's scratch
     printed; the layered plan forced at n_max 32, 64 and 128 (B = 64)
     against the plain version, beside the cluster plan's bits; K7 in its
     grouped plan at A = 320, 512, 1024 (ds = A / 8) and A = 140 (ds = 4,
     H = 35), N = 32 (B C = 16) and 600, forward and backward at phase 6's
     bars, two runs bit for bit, and at A = 32 the forward in 2 / 4 / 8
     slices and the grouped backward equal to the block plans' bits; the
     fused 2D->3D chain at ``--n_max 1024``, B = 2 (K1 5, K3 1, K6 40 in
     bf16; wall, device-busy ms and peak GiB; padded rows exactly 0; 3 f32
     steps against the channel-major chain); SDEModel3Dto2D with ``adim
     256, num_heads 4`` (K7 at A = 512, H = 8) and SchNet at the 3D->2D
     CLI's widths: the bf16 chain of 20 x 2 steps (K7 240), the f32 chain
     against K7's plain version (atol 2e-4, rtol 1e-3), the SDE loss and
     its backward in f32 and bf16 against K7's plain version (K7 4 / 4).
 22. K6 at every width the JAX kernel takes (``widths_path``): the fused
     2D->3D chain at the sampler CLI's widths with the 2D->3D model 64 and
     then 128 wide (``build_models``' ``hidden_dim``; B=64, n_max 32, bf16,
     20 x 1 steps: K1 5, K3 1, K6 40 in the layered plan, positions finite,
     padded rows 0, wall ms), K6 on each chain's operands against its plain
     version (variants 1 and 2, bf16 and f32 at phase 4's bars, two
     launches bit for bit) and 3 f32 steps against the channel-major chain;
     K6 alone over ``benchmarks/k6_widths.py``'s grid (hidden 8-128, 1-8
     heads, basis widths 32-256, (L, C) = (2, 2), (1, 3), (3, 2), n_max
     8-1024), variants 1 and 2, f32 1e-5 and bf16 2e-2 of max |plain|, two
     launches bit for bit, and at hidden 128, n_max 1024, B = 2 timed beside
     its bound.
The line before the last lists every kernel as JSON (the ones before it
phase 22's, 21's, 19's, 18's, 17's, 15's and 14's figures);
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time

import torch

from moleculesde_tpu_torch.benchmarks.profile_sampler_3d2d import bank_operands
from moleculesde_tpu_torch.benchmarks.timing import device_ms, median_ms, profiled_ms
from moleculesde_tpu_torch.ops import gin_messages as gin_ops
from moleculesde_tpu_torch.ops import pair_block as pair_ops
from moleculesde_tpu_torch.ops.attn_bank import (
    attn_map_bank_bwd_plain, attn_map_bank_kernel, attn_map_bank_kernel_bwd,
    attn_map_bank_plain)
from moleculesde_tpu_torch.ops.attn_bank import plan as k7_plan
from moleculesde_tpu_torch.ops.attn_qk_bank import (
    attn_qk_bank, attn_qk_bank_bwd, attn_qk_bank_bwd_plain)
from moleculesde_tpu_torch.ops.cfconv import (
    fused_cfconv, fused_cfconv_bwd, fused_cfconv_bwd_plain, fused_cfconv_rbf,
    fused_cfconv_rbf_bwd, fused_cfconv_rbf_bwd_plain)
from moleculesde_tpu_torch.ops.gin_messages import (
    gin_messages, gin_messages_bwd, gin_messages_bwd_plain, gin_messages_plain)
from moleculesde_tpu_torch.ops.pair_block import (
    pair_relu_project, pair_relu_project_bwd, pair_relu_project_bwd_plain,
    pair_relu_project_cm, pair_relu_project_cm_bwd, pair_relu_project_cm_bwd_plain,
    pair_relu_project_cm_plain, pair_relu_project_plain)
from moleculesde_tpu_torch.ops.score_kernel import (
    KERNEL_N_MAX, score_eval_fused, score_eval_fused_plain, score_param_layout, score_plan)
from moleculesde_tpu_torch.utils.flops import matmul_flops

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12         # H100 SXM, CUDA cores
PEAK_BF16_FLOPS = 989e12       # H100 SXM, dense tensor cores


class PhaseError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


# (name, result dict, kernel call, plain call, calls a graph) of every timed
# kernel, for device_time_phase
_DEVICE_RUNS = []


def device_time_phase():
    """Last phase: the device time of every timed kernel and of its plain
    version, into their results.  It runs after every chain and step is
    timed, so that the graphs' memory pools touch no other number."""
    saved = [c.launches for c in _counters()]
    with torch.no_grad():
        for name, result, run_k, run_p, reps in _DEVICE_RUNS:
            result["device_ms"] = device_ms(run_k, reps=reps)
            result["plain_device_ms"] = device_ms(run_p, reps=reps)
            print(f"{name}: device_ms={result['device_ms']:.4f} plain_device_ms="
                  f"{result['plain_device_ms']:.4f} bound_ms={result['bound_ms']:.4f} "
                  f"(CUDA-graph replay, time per call)", flush=True)
    for c, n in zip(_counters(), saved):
        c.launches = n


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k1_cost(x, src, dst, table, bwd: bool = False):
    """(bytes, operations) K1 must move and do on these operands: the
    embedding, add, relu and sum over the valid edges forward; the
    embedding, relu mask, dx and dtable backward."""
    b, n, f = x.shape
    e, d = src.shape[1], table.shape[0]
    valid_edges = int(((dst >= 0) & (dst < n)).sum())
    if bwd:
        return (4 * (3 * b * n * f + 2 * b * e + b * e * d + 2 * d * f),
                valid_edges * f * (4 * d + 3))
    return (4 * (2 * b * n * f + 2 * b * e + b * e * d + d * f),
            valid_edges * f * (2 * d + 3))


def k2_cost(ea, env, x, w1, bwd: bool = False):
    """(bytes, operations) of K2: ea at its own width (bf16 on the
    pretraining path), both only for the pairs inside the cutoff (env !=
    0), the only ones whose filter the output needs; env for every pair."""
    gdim, f = w1.shape
    pairs = int((env != 0).sum())
    weights = gdim * f + f * f + 2 * f
    ea_bytes = pairs * gdim * ea.element_size()
    if bwd:
        return (ea_bytes + 4 * (env.numel() + 3 * x.numel() + 2 * weights),
                pairs * (4 * gdim * f + 6 * f * f + 10 * f))
    return (ea_bytes + 4 * (env.numel() + 2 * x.numel() + weights),
            pairs * (2 * gdim * f + 2 * f * f + 4 * f))


def k5_cost(env, x, w1, bwd: bool = False):
    """(bytes, operations) of K5: K2's work on the pairs inside the cutoff
    plus their smearing (a subtraction, two products and an exp per
    Gaussian), reading those pairs' f32 distances where K2 reads ea."""
    gdim, f = w1.shape
    pairs = int((env != 0).sum())
    weights = gdim * f + f * f + 2 * f
    smear = pairs * gdim * 4
    if bwd:
        return (4 * (pairs + env.numel() + 3 * x.numel() + 2 * weights),
                pairs * (4 * gdim * f + 6 * f * f + 10 * f) + smear)
    return (4 * (pairs + env.numel() + 2 * x.numel() + weights),
            pairs * (2 * gdim * f + 2 * f * f + 4 * f) + smear)


def k3_cost(a, w, bwd: bool = False):
    """(bytes, operations) of K3: add, relu, product and bias forward; the
    two products, the relu mask and the sums backward."""
    b, n, cdim = a.shape
    h = w.shape[1]
    if bwd:
        return (4 * (4 * b * n * cdim + 2 * cdim * h + h + b * n * n * h),
                b * n * n * (4 * cdim * h + 3 * cdim + h))
    return (4 * (2 * b * n * cdim + cdim * h + h + b * n * n * h),
            b * n * n * (2 * cdim + 2 * cdim * h + h))


def k4_cost(a, w, bwd: bool = False):
    """(bytes, operations) of K4: K3 without the bias (read, added, or its
    gradient summed)."""
    b, n, cdim = a.shape
    h = w.shape[1]
    if bwd:
        return (4 * (4 * b * n * cdim + 2 * cdim * h + b * n * n * h),
                b * n * n * (4 * cdim * h + 3 * cdim))
    return (4 * (2 * b * n * cdim + cdim * h + b * n * n * h),
            b * n * n * (2 * cdim + 2 * cdim * h))


def k6_cost(b: int, n: int, variant: int, h: int = 32, coff_dim: int = 128,
            num_layers: int = 2, num_convs: int = 2):
    """(bytes, operations) of one K6 evaluation: inputs read
    once (pos, node_attr, edge_attr_2d and the mask in f32, as the wrapper
    hands them over, and the packed weights), the output written once; the
    multiply-adds of every product (2 operations each) without the TPU's
    selector products, plus the elementwise work per pair."""
    nn_ = n * n
    total_w = score_param_layout(variant, h, coff_dim, num_layers, num_convs)[1]
    nbytes = 4 * (b * n * 3 + b * n * h + b * nn_ * h + b * nn_ + total_w + b * n * 3)
    per_pair = 2 * (4 * h * h) + 2 * h * h + h * h                   # embeds, project
    if variant == 2:
        per_pair += 2 * h * h
    per_layer_pair = h * h + 3 * h                                    # e2, logits, message
    per_module_pair = h * coff_dim + coff_dim * 3 + 3 * coff_dim
    per_node = (num_layers * num_convs * (6 * h * h) + num_layers * h * coff_dim)
    macs = b * (nn_ * (per_pair + num_layers * num_convs * per_layer_pair
                       + num_layers * per_module_pair) + n * per_node)
    return nbytes, 2 * macs


def k7_cost(q, ds: int, bwd: bool = False):
    """(bytes, operations) of K7 on q, k [B, C, N, A] at their own width:
    the logits' multiply-adds, tanh, scale and head sum forward; the
    recomputed logits, du and the dq / dk products backward (g read, dq /
    dk written at q's width)."""
    b, c, n, a = q.shape
    h, e = a // ds, q.element_size()
    if bwd:
        return (4 * e * q.numel() + 4 * b * c * n * n, b * c * n * n * (6 * a + 5 * h))
    return 2 * e * q.numel() + 4 * b * c * n * n, b * c * n * n * (2 * a + 3 * h + 1)


def k8_cost(qk, ws, ds: int, bwd: bool = False):
    """(bytes, operations) of K8: qk at the width the kernel reads (bf16 in
    bf16 mode), the f32 weights, the maps; the q / k nets' and the logits'
    multiply-adds and the tanh forward, and backward the recomputation plus
    the map's du / dq / dk, each net's dt1, dW2, dW1 and dqk products (g
    read, dqk and the weight gradients written)."""
    b, n, f = qk.shape
    c, _, a = ws[0].shape
    h = a // ds
    w_bytes = 4 * sum(w.numel() for w in ws)
    qk_bytes = qk.numel() * qk.element_size()
    nets = 2 * (2 * n * f * a + 2 * n * a * a + 3 * n * a)
    fwd_ops = b * c * (nets + n * n * (2 * a + 3 * h + 1))
    if not bwd:
        return qk_bytes + w_bytes + 4 * b * c * n * n, fwd_ops
    back = 2 * (4 * n * a * a + 4 * n * f * a + 5 * n * a) + n * n * (4 * a + 5 * h)
    return (2 * qk_bytes + 2 * w_bytes + 4 * b * c * n * n, fwd_ops + b * c * back)


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _counters():
    return (gin_messages, gin_messages_bwd, fused_cfconv, fused_cfconv_bwd,
            fused_cfconv_rbf, fused_cfconv_rbf_bwd, pair_relu_project, pair_relu_project_bwd, pair_relu_project_cm,
            pair_relu_project_cm_bwd, score_eval_fused, attn_map_bank_kernel,
            attn_map_bank_kernel_bwd, attn_qk_bank, attn_qk_bank_bwd)


def _timed(run, reps: int = 30):
    """CUDA-event median of ``reps`` runs of ``run``; launch counts are left
    as they were."""
    saved = [c.launches for c in _counters()]
    ms = median_ms(run, warmup=min(5, reps), reps=reps)
    for c, n in zip(_counters(), saved):
        c.launches = n
    return ms


def compare(name, run_k, run_p, tol_rel, floor: float = 1.0):
    """Outputs of a kernel run and of its plain version on the same
    operands; raise if any output disagrees beyond ``tol_rel`` of
    max(``floor``, its largest plain value).  Returns the largest absolute
    error and the largest error relative to that scale."""
    saved = [c.launches for c in _counters()]
    outs_k, outs_p = _tuple(run_k()), _tuple(run_p())
    same_flops(name, run_k, run_p)
    torch.cuda.synchronize()
    for c, n in zip(_counters(), saved):
        c.launches = n
    worst = worst_rel = 0.0
    for i, (k, p) in enumerate(zip(outs_k, outs_p)):
        k, p = k.float(), p.float()
        check(bool(torch.isfinite(k).all()), f"{name}: non-finite output {i}")
        err = (k - p).abs().max().item()
        scale = max(floor, p.abs().max().item())
        check(err <= tol_rel * scale, f"{name}: output {i} disagrees with the plain "
              f"version ({err:.3e} > {tol_rel:g} x {scale:.3g})")
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / scale)
    return worst, worst_rel


# {kernel counter: comparisons whose matmul_flops matched}, read by main
FLOPS_CHECKED = {}


def same_flops(name, run_k, run_p) -> int:
    """``matmul_flops`` of a kernel call (the wrapper's report from the
    operand shapes, and any product around the launch) equals that of its
    plain version, as integers; returns the count.  Launch counts move:
    the caller restores them."""
    before = [c.launches for c in _counters()]
    flops_k = matmul_flops(run_k)
    launched = [c.__name__ for c, n in zip(_counters(), before) if c.launches > n]
    flops_p = matmul_flops(run_p)
    check(bool(launched), f"{name}: the kernel call launched no kernel")
    check(flops_k == flops_p, f"{name}: matmul_flops {flops_k} with the kernel, "
          f"{flops_p} with the plain version")
    for kernel in launched:
        FLOPS_CHECKED[kernel] = FLOPS_CHECKED.get(kernel, 0) + 1
    return flops_k


def same_bits(name, run):
    """Two runs of a kernel call give the same bits in every output (launch
    counts are left as they were)."""
    saved = [c.launches for c in _counters()]
    first, second = _tuple(run()), _tuple(run())
    torch.cuda.synchronize()
    for c, n in zip(_counters(), saved):
        c.launches = n
    check(all(torch.equal(u, v) for u, v in zip(first, second)), f"{name}: two runs differ")


# CUDA-event runs and calls a graph of a timed kernel; phase 20's large
# shapes take LARGE_REPS, whose plain versions move gigabytes a call
REPS = {"reps": 30, "device_reps": 10}
LARGE_REPS = {"reps": 5, "device_reps": 2}


def report(name, err, tol_rel, run_k, run_p, nbytes, ops, peak_ops, floor=1.0, reps=None):
    """Time the kernel call ``run_k`` and the plain call ``run_p`` (CUDA-event
    medians now, device times in :func:`device_time_phase`) and print them
    beside the bound."""
    reps = reps or REPS
    kernel_ms, plain_ms = _timed(run_k, reps["reps"]), _timed(run_p, reps["reps"])
    bound_ms, bound_by = bound(nbytes, ops, peak_ops)
    print(f"{name}: max_abs_err={err:.3e} (tolerance {tol_rel:g} x max({floor:g}, |plain|)) "
          f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
    out = {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    _DEVICE_RUNS.append((name, out, run_k, run_p, reps["device_reps"]))
    return out


def kernel_phase(name, wrapper, plain, args, bf16, tol_rel, nbytes, ops, peak_ops):
    """A forward-only kernel wrapper against its plain version."""
    run_k = lambda: wrapper(*args, bf16=bf16, impl="kernel")  # noqa: E731
    run_p = lambda: plain(*args, bf16=bf16)  # noqa: E731
    err, _ = compare(name, run_k, run_p, tol_rel)
    return report(name, err, tol_rel, run_k, run_p, nbytes, ops, peak_ops)


def grad_phase(name, fwd, bwd, bwd_plain, diff, g, bf16, tol_rel, fwd_cost,
               bwd_cost, peak_ops, floor: float = 1.0, reps=None):
    """A kernel pair under autograd against the plain pair: the output and
    the gradient of every differentiable operand (``diff``), then the
    forward and backward wrappers timed on their own.  ``fwd(*diff)``,
    ``bwd(*diff, g)`` and ``bwd_plain(*diff, g)`` close over the other
    operands.  Returns (forward result, backward result)."""

    def through_autograd(impl):
        leaves = [t.detach().clone().requires_grad_(True) for t in diff]
        out = fwd(*leaves, bf16=bf16, impl=impl)
        return (out.detach(),) + torch.autograd.grad(out, leaves, g)

    err, rel = compare(name, lambda: through_autograd("kernel"),
                       lambda: through_autograd("plain"), tol_rel, floor)
    with torch.no_grad():
        out = (report(name + " fwd", err, tol_rel,
                      lambda: fwd(*diff, bf16=bf16, impl="kernel"),
                      lambda: fwd(*diff, bf16=bf16, impl="plain"), *fwd_cost, peak_ops, floor,
                      reps),
               report(name + " bwd", err, tol_rel,
                      lambda: bwd(*diff, g, bf16=bf16, impl="kernel"),
                      lambda: bwd_plain(*diff, g, bf16=bf16), *bwd_cost, peak_ops, floor,
                      reps))
    for r in out:
        r["max_rel_err"] = rel
    return out


def sampler_kernel_phases(k1_args, k3_args):
    x, src, dst, boh, table = k1_args
    valid_edges = int(((dst >= 0) & (dst < x.shape[1])).sum())
    k1 = k1_cost(x, src, dst, table)
    a, c, w, bias = k3_args
    k3 = k3_cost(a, w)
    k4 = k4_cost(a, w)
    print(f"sampler K1 operands: x {tuple(x.shape)}, edges {tuple(src.shape)} "
          f"({valid_edges} valid), table {tuple(table.shape)}", flush=True)
    print(f"sampler K3 operands: a, c {tuple(a.shape)}, W {tuple(w.shape)}", flush=True)
    results = {}
    for bf16 in (False, True):
        sfx = "[bf16]" if bf16 else ""
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
        # f32: the same sums in another order; bf16: the same roundings, plus
        # at most one bf16 ulp where an f32 sum sits on a rounding boundary
        results["gin_messages" + sfx] = kernel_phase(
            "sampler K1 gin_messages" + sfx, gin_messages, gin_messages_plain, k1_args,
            bf16, 1e-2 if bf16 else 1e-5, *k1, peak)
        results["pair_relu_project" + sfx] = kernel_phase(
            "sampler K3 pair_relu_project" + sfx, pair_relu_project,
            pair_relu_project_plain, k3_args, bf16, 1e-3 if bf16 else 1e-5,
            *k3, peak)
        # K4 on the same operands (the pair_cm_direct chain), without bias
        results["pair_relu_project_cm" + sfx] = kernel_phase(
            "sampler K4 pair_relu_project_cm" + sfx, pair_relu_project_cm,
            pair_relu_project_cm_plain, (a, c, w), bf16, 1e-3 if bf16 else 1e-5,
            *k4, peak)
    return results


def k6_phases(models, node_2d, batch, dev, label: str = "", reps=None):
    """K6 against its plain version on the fused chain's operands: the
    feature-layout conditioning of each variant's model and prior
    positions, in f32 and bf16 mode; the error relative to max |plain|;
    two launches of each bit for bit.  ``label`` tags the results of
    another n_max than the chain's; ``reps`` as report's."""
    results = {}
    b, n = batch.num_graphs, batch.n_max
    h = next(iter(models.values())).hidden_dim
    for bf16 in (True, False):
        print(f"K6 plan at n_max {n}, B={b}, hidden {h}, {'bf16' if bf16 else 'f32'}: "
              f"{score_plan(n, bf16, b=b, h=h)} (cluster = blocks per molecule; layered: "
              "8 destinations a block, scratch bytes of device memory)", flush=True)
    for variant, model in models.items():
        with torch.no_grad():
            cond = model.precompute_conditioning(node_2d, batch, layout="feature")
            gen = torch.Generator(device=dev).manual_seed(3)
            pos = (model.sde_pos.prior_sampling(tuple(batch.positions.shape), gen, dev)
                   * batch.node_mask[:, None]).reshape(b, n, 3)
            # the wrapper's f32 operands, made once so the timings hold the
            # kernel alone
            args = (pos, cond["node_attr"].float(), cond["edge_attr_2d"].float(),
                    cond["pair_mask"].float(), model.packed_score_params())
        print(f"K6 operands (variant {variant}): pos {tuple(pos.shape)}, edge_attr_2d "
              f"{tuple(args[2].shape)}, {int(cond['pair_mask'].sum())} valid pairs, "
              f"{args[4].numel()} packed weights", flush=True)
        # variants 3 and 4 run as kernel variant 1 (their edge features
        # enter as variant 1's do)
        kv = model.kernel_variant
        nbytes, ops = k6_cost(b, n, kv, model.hidden_dim)
        for bf16 in (False, True):
            name = f"score_eval_fused[v{variant}]" + ("[bf16]" if bf16 else "") + label
            # f32: sums in another order and a warp-shuffle softmax; bf16:
            # the same roundings, plus one bf16 ulp where an f32 value taken
            # in another order lands on the other side of a boundary
            tol = 2e-2 if bf16 else 1e-4
            with torch.no_grad():
                # defaults bind this iteration's operands: the device-time
                # phase calls these after the loops have moved on
                run_k = lambda a=args, v=kv, b=bf16: score_eval_fused(  # noqa: E731
                    *a, variant=v, bf16=b, impl="kernel")
                run_p = lambda a=args, v=kv, b=bf16: score_eval_fused_plain(  # noqa: E731
                    *a, variant=v, bf16=b)
                err, rel = compare("K6 " + name, run_k, run_p, tol, floor=0.0)
                results[name] = report("K6 " + name, err, tol, run_k, run_p,
                                       nbytes, ops, PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS,
                                       floor=0.0, reps=reps)
                results[name]["max_rel_err"] = rel
                same_bits("K6 " + name, run_k)
                print(f"K6 {name}: max_rel_err={rel:.3e} (of max |plain|); two launches bit "
                      "for bit", flush=True)
    return results


def k6_large_n_phases(dev):
    """K6 past n_max 32: the fused chain's models and operands at ``--n_max
    64``, ``--n_max 128`` and ``--n_max 129`` (B=64, molecules of 4-64, 4-128
    and 4-129 atoms; the same weights), variants 1 and 2, bf16 and f32 at
    the chain's bars, two launches bit for bit: n_max 129, past the cluster
    plan (which refused it before), runs in the layered plan, and the
    cluster plan forced there still raises, naming its limit; then the
    fused chain at n_max 128 in f32 against the channel-major chain
    (fused_f32_steps)."""
    from moleculesde_tpu_torch.benchmarks.profile_sampler import PATH_ARGS
    from moleculesde_tpu_torch.examples import sample_2d_to_3d as cli

    results = {}
    for n_max in (64, 128, KERNEL_N_MAX + 1):
        size = ["--n_max", str(n_max)]
        args = cli.get_parser().parse_args(PATH_ARGS + size)
        batch = cli.make_batch(cli.load_graphs(args), args, dev)
        model_2d, sde_model = cli.build_models(args, dev)
        args_v2 = cli.get_parser().parse_args(PATH_ARGS + size + ["--SDE_2Dto3D_model",
                                                                  "SDEModel2Dto3D_02"])
        with torch.no_grad():
            node_2d = model_2d(batch, use_running_average=True)
        print(f"K6 at n_max {n_max}: B={batch.num_graphs}, molecules of "
              f"{int(batch.node_mask.reshape(batch.num_graphs, -1).sum(1).min())}-"
              f"{int(batch.node_mask.reshape(batch.num_graphs, -1).sum(1).max())} atoms",
              flush=True)
        results.update(k6_phases({1: sde_model, 2: cli.build_models(args_v2, dev)[1]},
                                 node_2d, batch, dev, f"[n{n_max}]"))
    past = KERNEL_N_MAX + 1
    for bf16 in (True, False):
        check(score_plan(past, bf16)["plan"] == "layered", f"K6 n_max {past}: not layered")
        try:
            score_plan(past, bf16, plan="cluster")
        except ValueError as e:
            check(f"n_max <= {KERNEL_N_MAX}" in str(e), f"K6 n_max {past} refusal: {e}")
            print(f"K6 at n_max {past} ({'bf16' if bf16 else 'f32'}), the cluster plan forced: "
                  f"refused: {e}", flush=True)
        else:
            raise PhaseError(f"K6's cluster plan takes n_max {past}, past its limit")
    results["chain_n128_k6_launches"] = fused_f32_steps(dev, ["--n_max", "128"], 3, "n_max 128")
    return results


def fused_f32_steps(dev, extra_args, steps: int, label: str, hidden: int = 32) -> int:
    """``steps`` f32 PC steps (1 corrector step each) of the fused chain
    against the channel-major chain on the same weights and draws (atol
    2e-4, rtol 1e-3), the sampler CLI's models at ``extra_args`` (the 2D->3D
    model ``hidden`` wide); returns the fused run's K6 launches (2 per
    step), checked."""
    from moleculesde_tpu_torch.benchmarks.profile_sampler import PATH_ARGS
    from moleculesde_tpu_torch.examples import sample_2d_to_3d as cli
    from moleculesde_tpu_torch.sampling.pc import sample_positions_pc

    args32 = cli.get_parser().parse_args(PATH_ARGS + extra_args +
                                         ["--sampler_precision", "float32"])
    batch = cli.make_batch(cli.load_graphs(args32), args32, dev)
    model_2d32, sde32 = cli.build_models(args32, dev, hidden_dim=hidden)
    gen = torch.Generator(device=dev).manual_seed(11)
    shape = tuple(batch.positions.shape)
    draws = {"prior": sde32.sde_pos.prior_sampling(shape, gen, dev),
             "noise_p": torch.randn((steps,) + shape, generator=gen, device=dev),
             "noise_c": torch.randn((steps, 1) + shape, generator=gen, device=dev)}
    saved = [c.launches for c in _counters()]
    with torch.no_grad():
        node32 = model_2d32(batch, use_running_average=True)
        reset_counts()
        out_f = sample_positions_pc(sde32, node32, batch, n_steps=steps, fused=True, **draws)
        torch.cuda.synchronize()
        k6 = score_eval_fused.launches
        out_c = sample_positions_pc(sde32, node32, batch, n_steps=steps, **draws)
        torch.cuda.synchronize()
    for c, n in zip(_counters(), saved):
        c.launches = n
    check(k6 == 2 * steps, f"fused chain ({label}): K6 launched {k6} times, not {2 * steps}")
    check(bool(torch.isfinite(out_f).all()), f"fused chain ({label}): non-finite positions")
    excess = ((out_f - out_c).abs() - (2e-4 + 1e-3 * out_c.abs())).max().item()
    print(f"fused vs channel-major chain ({label}, B={batch.num_graphs}), f32, {steps} steps: "
          f"K6 launches {k6}; max_abs_err={(out_f - out_c).abs().max().item():.3e} (tolerance "
          f"atol 2e-4 + rtol 1e-3; largest excess {excess:.3e})", flush=True)
    check(excess <= 0.0, f"the f32 fused chain ({label}) disagrees with the channel-major chain")
    return k6


def training_operands(models, batch):
    """The operands the pretraining step hands K1 (GIN layer 0), K2 (SchNet
    interaction 0; ea in bf16, as the bf16 step hands it over) and K3 (the
    2D->3D edge embedding), from the models' current weights and the batch."""
    m2d, m3d, m23 = models["model_2D"], models["model_3D"], models["SDE_2Dto3D_model"]
    b, n = batch.num_graphs, batch.n_max
    x0 = m2d.AtomEncoder_0(batch.atom_feats)
    k1 = m2d.GINConv_0.message_inputs(x0, batch)
    ea, cos_env, pair_mask, _ = m3d.geometry(batch.positions, batch.node_mask, b, n)
    ea = ea.contiguous()
    env = (cos_env * pair_mask.to(cos_env.dtype)).contiguous()
    inter = m3d.SchNetInteraction_0
    h0 = m3d.Embed_0.embedding[batch.atomic_numbers.long()].reshape(b, n, -1)
    k2 = (ea, env, inter.Dense_2(h0).float().contiguous(), inter.Dense_0.kernel,
          inter.Dense_0.bias, inter.Dense_1.kernel, inter.Dense_1.bias)
    node_2d = m2d(batch, use_running_average=True)
    mask23, _ = m23._pair_mask_attr(batch)
    k3 = m23.pair_block_inputs(node_2d, batch, mask23, use_running_average=True)
    return tuple(t.detach() for t in k1), tuple(t.detach() for t in k2), \
        tuple(t.detach() for t in k3)


def training_kernel_phases(k1, k2, k3, label: str = "training"):
    gen = torch.Generator(device=k1[0].device).manual_seed(7)
    x, src, dst, boh, table = k1
    b, n, _ = x.shape
    valid_edges = int(((dst >= 0) & (dst < n)).sum())
    g1 = torch.randn(x.shape, generator=gen, device=x.device)
    ea_bf16, env, x2, w1, b1, w2, b2 = k2
    g2 = torch.randn(x2.shape, generator=gen, device=x2.device)
    a, c, w, bias = k3
    g3 = torch.randn((b, n, n, w.shape[1]), generator=gen, device=a.device)
    g4 = torch.randn((b, w.shape[1], n * n), generator=gen, device=a.device)
    print(f"{label} K1 operands: x {tuple(x.shape)}, edges {tuple(src.shape)} "
          f"({valid_edges} valid); K2: ea {tuple(ea_bf16.shape)} {ea_bf16.dtype}, "
          f"x {tuple(x2.shape)} ({int((env != 0).sum())} pairs in the cutoff); "
          f"K3: a, c {tuple(a.shape)}, W {tuple(w.shape)}", flush=True)
    results = {}
    for bf16 in (True, False):   # bf16 is the path's mode
        sfx = "" if bf16 else "[f32]"
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
        ea = ea_bf16 if bf16 else ea_bf16.float()
        # tolerances: f32 the same sums in another order (batch-wide weight
        # sums of up to 1.3e5 terms); bf16 as the card-only kernel tests
        results["gin_messages" + sfx], results["gin_messages_bwd" + sfx] = grad_phase(
            f"{label} K1 gin_messages" + sfx,
            lambda x_, t_, **kw: gin_messages(x_, src, dst, boh, t_, **kw),
            lambda x_, t_, g_, **kw: gin_messages_bwd(x_, src, dst, boh, t_, g_, **kw),
            lambda x_, t_, g_, **kw: gin_messages_bwd_plain(x_, src, dst, boh, t_, g_, **kw),
            (x, table), g1, bf16, 1e-2 if bf16 else 1e-4,
            k1_cost(x, src, dst, table), k1_cost(x, src, dst, table, bwd=True), peak)
        results["fused_cfconv" + sfx], results["fused_cfconv_bwd" + sfx] = grad_phase(
            f"{label} K2 fused_cfconv" + sfx,
            lambda *t, ea=ea, **kw: fused_cfconv(ea, env, *t, **kw),   # this mode's ea
            lambda *t, ea=ea, **kw: fused_cfconv_bwd(ea, env, *t, **kw),
            lambda *t, ea=ea, **kw: fused_cfconv_bwd_plain(ea, env, *t, **kw),
            (x2, w1, b1, w2, b2), g2, bf16, 2e-2 if bf16 else 1e-4,
            k2_cost(ea, env, x2, w1), k2_cost(ea, env, x2, w1, bwd=True), peak)
        results["pair_relu_project" + sfx], results["pair_relu_project_bwd" + sfx] = \
            grad_phase(f"{label} K3 pair_relu_project" + sfx, pair_relu_project,
                       lambda a_, c_, w_, b_, g_, **kw: pair_relu_project_bwd(
                           a_, c_, w_, g_, **kw),
                       lambda a_, c_, w_, b_, g_, **kw: pair_relu_project_bwd_plain(
                           a_, c_, w_, g_, **kw),
                       (a, c, w, bias), g3, bf16, 1e-3 if bf16 else 1e-4,
                       k3_cost(a, w), k3_cost(a, w, bwd=True), peak)
        # K4 (the pair_cm_direct step) on the same operands; its cotangent is
        # channel-major, and the bias is added outside the kernel
        results["pair_relu_project_cm" + sfx], results["pair_relu_project_cm_bwd" + sfx] = \
            grad_phase(f"{label} K4 pair_relu_project_cm" + sfx, pair_relu_project_cm,
                       pair_relu_project_cm_bwd, pair_relu_project_cm_bwd_plain,
                       (a, c, w), g4, bf16, 1e-3 if bf16 else 1e-4,
                       k4_cost(a, w), k4_cost(a, w, bwd=True), peak)
    gin_pair_same_bits(label, k1, g1, k3, g3, g4)
    return results


def reset_counts():
    for c in _counters():
        c.launches = 0


def read_counts():
    return {c.__name__: c.launches for c in _counters()}


def expect(**counts):
    """Every counter, at 0 unless given."""
    return {c.__name__: counts.get(c.__name__, 0) for c in _counters()}


def sampler_path(dev):
    """Phase 3: returns the launch counts of the counted CLI run."""
    from moleculesde_tpu_torch.benchmarks.profile_sampler import (
        CORRECTOR_STEPS, N_STEPS, PATH_ARGS)
    from moleculesde_tpu_torch.examples import sample_2d_to_3d as cli

    args = cli.get_parser().parse_args(PATH_ARGS)
    graphs = cli.load_graphs(args)
    n_max = args.n_max
    batch = cli.make_batch(graphs, args, dev)
    model_2d, sde_model = cli.build_models(args, dev)
    with torch.no_grad():
        x0 = model_2d.AtomEncoder_0(batch.atom_feats)
        k1_args = model_2d.GINConv_0.message_inputs(x0, batch)
        node_2d = model_2d(batch, use_running_average=True)
        pair_mask, _ = sde_model._pair_mask_attr(batch)
        k3_args = sde_model.pair_block_inputs(node_2d, batch, pair_mask)
        results = sampler_kernel_phases(k1_args, k3_args)

    reset_counts()
    t0 = time.perf_counter()
    cli_results = cli.main(PATH_ARGS)
    torch.cuda.synchronize()
    first_run_s = time.perf_counter() - t0
    launches = read_counts()
    print(f"sampler path launches: {launches} (expected 5 and 1 per chain); first run "
          f"{first_run_s:.2f} s", flush=True)
    check(launches == expect(gin_messages=args.num_layer, pair_relu_project=1),
          f"sampler path launch counts {launches}")
    check(len(cli_results) == len(graphs), "CLI returned too few molecules")
    for r in cli_results:
        check(r["pos_gen"].shape == (args.num_repeat_SDE_inference,
                                     r["atom_feats"].shape[0], 3), "pos_gen shape")
        check(bool(torch.isfinite(torch.as_tensor(r["pos_gen"])).all()),
              "non-finite conformer")

    # the same chain again through the CLI's functions: full positions, timed
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pos = cli.generate(model_2d, sde_model, batch, gen, args)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    mask = batch.node_mask
    check(tuple(pos.shape) == (batch.num_nodes, 3), "positions shape")
    check(bool(torch.isfinite(pos).all()), "non-finite positions")
    check(bool((pos[~mask] == 0).all()), "padded rows are not exactly 0")
    ref = torch.as_tensor(cli_results[0]["pos_gen"])
    n0 = ref.shape[1]
    first = pos.reshape(-1, args.num_repeat_SDE_inference, n_max, 3)[0, :, :n0].cpu()
    rerun_err = (first - ref).abs().max().item()
    print(f"rerun vs CLI run, molecule 0: max_abs_err={rerun_err:.3e}", flush=True)
    check(rerun_err <= 1e-3 * max(1.0, ref.abs().max().item()), "rerun disagrees")

    # conditioning against an all-plain build of the same weights
    with torch.no_grad():
        plain_2d, plain_sde = cli.build_models(args, dev, msg_impl="plain",
                                               pair_impl="plain")
        cond_k = sde_model.precompute_conditioning(node_2d, batch, layout="channel")
        node_p = plain_2d(batch, use_running_average=True)
        cond_p = plain_sde.precompute_conditioning(node_p, batch, layout="channel")
    node_err = (node_2d - node_p).abs().max().item()
    edge_err = (cond_k["edge_attr_2d"].float() - cond_p["edge_attr_2d"].float()
                ).abs().max().item()
    node_scale = max(1.0, node_p.abs().max().item())
    edge_scale = max(1.0, cond_p["edge_attr_2d"].float().abs().max().item())
    # node_2d: f32 through 5 layers, sums in another order -> 1e-4 relative;
    # edge_attr_2d is stored in bf16: one bf16 ulp (2^-8) of the largest value
    print(f"conditioning vs plain: node_2d max_abs_err={node_err:.3e} "
          f"(tolerance {1e-4 * node_scale:.3e}); edge_attr_2d max_abs_err="
          f"{edge_err:.3e} (tolerance {2 ** -8 * edge_scale:.3e})", flush=True)
    check(node_err <= 1e-4 * node_scale, "node_2d disagrees with the plain path")
    check(edge_err <= 2 ** -8 * edge_scale, "edge_attr_2d disagrees with the plain path")

    b_conf = batch.num_graphs
    print(f"sampler path: B={b_conf} conformers, n_max {n_max}, {N_STEPS} PC steps x "
          f"{CORRECTOR_STEPS} corrector step (CLI default 100; depth cut), chain "
          f"(GIN + conditioning + PC chain) wall_ms={chain_s * 1e3:.2f} "
          f"pc_steps_per_s={N_STEPS / chain_s:.2f} "
          f"conformers_per_s={b_conf / chain_s:.2f}", flush=True)
    return results, launches


def fused_chain_path(dev):
    """Phase 4: the sampler with ``fused=True`` at the same full width, bf16
    score: K6 against its plain version (variants 1 and 2; also at n_max 64
    and 128, with 3 f32 steps of the n_max 128 chain), the counted chain
    (K1 5, K3 1, K6 40), conformers/s against the channel-major chain in
    turns, and 5 f32 steps against the channel-major chain on the same
    weights and draws.  Returns (K6 results, launch counts)."""
    from moleculesde_tpu_torch.benchmarks.profile_sampler import (
        CORRECTOR_STEPS, N_STEPS, PATH_ARGS)
    from moleculesde_tpu_torch.examples import sample_2d_to_3d as cli

    args = cli.get_parser().parse_args(PATH_ARGS)
    batch = cli.make_batch(cli.load_graphs(args), args, dev)
    model_2d, sde_model = cli.build_models(args, dev)
    args_v2 = cli.get_parser().parse_args(PATH_ARGS + ["--SDE_2Dto3D_model",
                                                       "SDEModel2Dto3D_02"])
    with torch.no_grad():
        node_2d = model_2d(batch, use_running_average=True)
    results = k6_phases({1: sde_model, 2: cli.build_models(args_v2, dev)[1]}, node_2d,
                        batch, dev)
    results.update(k6_large_n_phases(dev))

    evals = N_STEPS * (CORRECTOR_STEPS + 1)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    reset_counts()
    pos = cli.generate(model_2d, sde_model, batch, gen, args, fused=True)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"fused chain launches: {launches} (expected K1 {args.num_layer}, K3 1, K6 {evals})",
          flush=True)
    check(launches == expect(gin_messages=args.num_layer, pair_relu_project=1,
                             score_eval_fused=evals), f"fused chain launch counts {launches}")
    mask = batch.node_mask
    check(tuple(pos.shape) == (batch.num_nodes, 3), "fused chain: positions shape")
    check(bool(torch.isfinite(pos).all()), "fused chain: non-finite positions")
    check(bool((pos[~mask] == 0).all()), "fused chain: padded rows are not exactly 0")

    # conformers/s of the two chains, in turns on the same card
    walls = {"channel": [], "fused": []}
    for name in ("channel", "fused", "fused", "channel"):
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.generate(model_2d, sde_model, batch, gen, args, fused=name == "fused")
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    b_conf = batch.num_graphs
    for name, ws in walls.items():
        print(f"{name} chain (GIN + conditioning + {N_STEPS} PC steps, B={b_conf}, bf16): "
              f"wall_ms={' / '.join(f'{w * 1e3:.2f}' for w in ws)} conformers_per_s="
              f"{' / '.join(f'{b_conf / w:.2f}' for w in ws)} pc_steps_per_s="
              f"{' / '.join(f'{N_STEPS / w:.2f}' for w in ws)}", flush=True)
    saved = [c.launches for c in _counters()]
    for _ in range(2):   # the second reading after a warm profiler
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        wall, busy = profiled_ms(lambda: cli.generate(model_2d, sde_model, batch, gen, args,
                                                      fused=True))
    for c, n in zip(_counters(), saved):
        c.launches = n
    print(f"fused chain under the profiler: wall_ms={wall:.2f} device_busy_ms={busy:.2f}; with "
          "the one-block-per-molecule K6 (PERF.md section 5, H100, 700 W): wall 29.54-36.94 "
          "ms, device busy 21.37 ms, K6 17.9 ms of it", flush=True)

    # 5 f32 steps, fused against channel-major, same weights and draws
    fused_f32_steps(dev, [], 5, f"n_max {batch.n_max}")
    return results, launches, walls


def pair_cm_direct_chain(dev):
    """Phase 5: one chain with ``SDEModel2Dto3D(pair_cm_direct=True)``: K4
    forward once, K3 never; its f32 edge features against K3's on the same
    weights.  Returns the launch counts."""
    from moleculesde_tpu_torch.benchmarks.profile_sampler import PATH_ARGS
    from moleculesde_tpu_torch.examples import sample_2d_to_3d as cli

    args = cli.get_parser().parse_args(PATH_ARGS)
    batch = cli.make_batch(cli.load_graphs(args), args, dev)
    model_2d, sde_cm = cli.build_models(args, dev, pair_cm_direct=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    reset_counts()
    pos = cli.generate(model_2d, sde_cm, batch, gen, args)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"pair_cm_direct chain launches: {launches} (expected K1 {args.num_layer}, K4 1, "
          "K3 0)", flush=True)
    check(launches == expect(gin_messages=args.num_layer, pair_relu_project_cm=1),
          f"pair_cm_direct chain launch counts {launches}")
    check(bool(torch.isfinite(pos).all()), "pair_cm_direct chain: non-finite positions")
    with torch.no_grad():
        node_2d = model_2d(batch, use_running_average=True)
        saved = [c.launches for c in _counters()]
        k4 = sde_cm.precompute_conditioning(node_2d, batch, layout="channel")["edge_attr_2d"]
        k3 = sde_cm.precompute_conditioning(node_2d, batch, layout="feature")["edge_attr_2d"]
        for c, n in zip(_counters(), saved):
            c.launches = n
    b, n = batch.num_graphs, batch.n_max
    k3 = k3.reshape(b, n * n, -1).transpose(1, 2)
    err = (k4 - k3).abs().max().item()
    scale = max(1.0, k3.abs().max().item())
    # both f32 (the sampler's pair block): the same sums in another order
    print(f"pair_cm_direct edge_attr_2d (K4, f32) vs K3's transposed: max_abs_err={err:.3e} "
          f"(tolerance {1e-5 * scale:.3e})", flush=True)
    check(k4.dtype == torch.float32 and err <= 1e-5 * scale,
          "K4's edge features disagree with K3's")
    return launches


def qk_bank_phase(name, qk, ws, g, ds, bf16, tol, reps=None):
    """K8 under autograd against its plain pair: the maps and dqk by the
    largest error over max |plain|, the eight weight gradients by relative
    L2; then the forward and backward wrappers timed on their own, on the
    operands as the wrapper hands them to the kernel."""

    def through_autograd(impl):
        leaves = [t.detach().clone().requires_grad_(True) for t in [qk] + list(ws)]
        out = attn_qk_bank(*leaves, ds, bf16=bf16, impl=impl)
        return (out.detach(),) + torch.autograd.grad(out, leaves, g)

    saved = [c.launches for c in _counters()]
    outs_k, outs_p = through_autograd("kernel"), through_autograd("plain")
    same_flops(name, lambda: through_autograd("kernel"), lambda: through_autograd("plain"))
    torch.cuda.synchronize()
    for c, n in zip(_counters(), saved):
        c.launches = n
    worst = worst_rel = 0.0
    for i, (k, p) in enumerate(zip(outs_k, outs_p)):
        k, p = k.float(), p.float()
        check(bool(torch.isfinite(k).all()), f"{name}: non-finite output {i}")
        rel = ((k - p).abs().max() / p.abs().max() if i < 2
               else (k - p).norm() / p.norm()).item()
        check(rel <= tol, f"{name}: output {i} disagrees with the plain version "
              f"({rel:.3e} > {tol:g})")
        worst = max(worst, (k - p).abs().max().item())
        worst_rel = max(worst_rel, rel)
    qd = qk.to(torch.bfloat16 if bf16 else torch.float32)
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    with torch.no_grad():
        same_bits(name + " fwd", lambda: attn_qk_bank(qd, *ws, ds, bf16=bf16, impl="kernel"))
        same_bits(name + " bwd",
                  lambda: attn_qk_bank_bwd(qd, *ws, g, ds, bf16=bf16, impl="kernel"))
        out = (report(name + " fwd", worst, tol,
                      lambda: attn_qk_bank(qd, *ws, ds, bf16=bf16, impl="kernel"),
                      lambda: attn_qk_bank(qd, *ws, ds, bf16=bf16, impl="plain"),
                      *k8_cost(qd, ws, ds), peak, 0.0, reps),
               report(name + " bwd", worst, tol,
                      lambda: attn_qk_bank_bwd(qd, *ws, g, ds, bf16=bf16, impl="kernel"),
                      lambda: attn_qk_bank_bwd_plain(qd, *ws, g, ds, bf16=bf16),
                      *k8_cost(qd, ws, ds, True), peak, 0.0, reps))
    for r in out:
        r["max_rel_err"] = worst_rel
    print(f"{name}: largest relative error {worst_rel:.3e} (maps and dqk of max |plain|, "
          f"weight gradients relative L2; tolerance {tol:g})", flush=True)
    return out


def bank_kernel_phases(layers, size: str = "", reps=None):
    """K7 and K8 (where an operand set has ``qk``), forward and backward,
    against their plain versions on the
    chain's layer-0 and layer-1 operands (``layers``, from bank_operands),
    in bf16 (the chain's mode) and f32 (on the f32 q / k nets' outputs),
    each kernel also two runs bit for bit; ``size`` ends the results' keys
    ("" at n_max 32, "[n64]", ...).  Errors relative to max |plain|: f32
    1e-4 (sums in another order); bf16 3e-3, about three times the largest
    reading (the same roundings; dq, dk and dqk are bf16 outputs, and K8's
    q and k are rounded to bf16, where an f32 sum in another order can flip
    one rounding).  K7's bf16 maps round nothing after their bf16
    operands, so they are also held at the f32 bar: a kernel that rounded
    its logits or tanh to bf16 fails there."""
    results = {}
    for li, ops in enumerate(layers):
        q, k, qk, ws, ds = ops["q"], ops["k"], ops.get("qk"), ops.get("ws"), ops["ds"]
        gen = torch.Generator(device=q.device).manual_seed(9 + li)
        g = torch.randn(q.shape[:3] + (q.shape[2],), generator=gen, device=q.device)
        print(f"bank operands{size}, edge layer {li}: q, k {tuple(q.shape)} {q.dtype}"
              + ("" if qk is None else f", qk {tuple(qk.shape)}, W1 {tuple(ws[0].shape)}")
              + f", ds {ds}", flush=True)
        for bf16 in (True, False):
            sfx = f"[L{li}]" + ("" if bf16 else "[f32]") + size
            tol = 3e-3 if bf16 else 1e-4
            peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
            qm, km = (q, k) if bf16 else (ops["q32"], ops["k32"])
            if bf16:
                _, rel = compare("K7 attn_map_bank" + sfx + " maps",
                                 lambda: attn_map_bank_kernel(qm, km, ds, bf16=True,
                                                              impl="kernel"),
                                 lambda: attn_map_bank_plain(qm, km, ds, bf16=True), 1e-4)
                print(f"K7 attn_map_bank{sfx} maps: relative error {rel:.3e} "
                      "(tolerance 1e-4, f32 maps of bf16 operands)", flush=True)
            fwd, bwd = grad_phase(
                "K7 attn_map_bank" + sfx,
                lambda q_, k_, ds=ds, **kw: attn_map_bank_kernel(q_, k_, ds, **kw),
                lambda q_, k_, g_, ds=ds, **kw: attn_map_bank_kernel_bwd(q_, k_, g_, ds, **kw),
                lambda q_, k_, g_, ds=ds, **kw: attn_map_bank_bwd_plain(q_, k_, g_, ds, **kw),
                (qm, km), g, bf16, tol, k7_cost(qm, ds), k7_cost(qm, ds, True), peak, 0.0,
                reps)
            with torch.no_grad():
                same_bits("K7 attn_map_bank fwd" + sfx, lambda: attn_map_bank_kernel(
                    qm, km, ds, bf16=bf16, impl="kernel"))
                same_bits("K7 attn_map_bank bwd" + sfx, lambda: attn_map_bank_kernel_bwd(
                    qm, km, g, ds, bf16=bf16, impl="kernel"))
            results["attn_map_bank" + sfx], results["attn_map_bank_bwd" + sfx] = fwd, bwd
            if qk is not None:
                results["attn_qk_bank" + sfx], results["attn_qk_bank_bwd" + sfx] = (
                    qk_bank_phase("K8 attn_qk_bank" + sfx, qk, ws, g, ds, bf16, tol))
    return results


def bank_large_n_phases(dev, n_max: int, batch_size: int):
    """K7 and K8, forward and backward, past N = 32: the 3D->2D chain's
    models (the same weights) and edge-layer 0 (C=2, F=300) and 1 (C=8,
    F=16) operands at ``--n_max n_max``, B=``batch_size``, held as
    bank_kernel_phases holds them at n_max 32 (bf16 and f32, the same
    bars, two runs of each kernel bit for bit)."""
    from moleculesde_tpu_torch.benchmarks.profile_sampler_3d2d import chain_bank_operands

    return bank_kernel_phases(chain_bank_operands(dev, n_max, batch_size), f"[n{n_max}]")


def bank_seeded_phases(dev, b: int, n: int, seed: int, size: str):
    """K7 and K8, forward and backward, on seeded operands at the chain's
    edge layers 1-3 widths (C = 8, A = 32, ds = 4; K8's F = 16, the width
    its forward takes at N = 256), B = ``b``, N = ``n``: bank_kernel_phases
    on them, keys ending in ``size``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    c, a, f = 8, 32, 16
    q32, k32 = (0.8 * torch.randn(b, c, n, a, device=dev, generator=gen) for _ in range(2))
    shapes = [(c, f, a), (c, a), (c, a, a), (c, a)] * 2
    ws = [torch.randn(sh, device=dev, generator=gen) / (sh[-2] ** 0.5 if len(sh) == 3 else 4.0)
          for sh in shapes]
    qk = torch.randn(b, n, f, device=dev, generator=gen)
    ops = {"q": q32.bfloat16(), "k": k32.bfloat16(), "q32": q32, "k32": k32, "qk": qk,
           "ws": ws, "ds": 4}
    return bank_kernel_phases([ops], size)


def bank_n256_phases(dev):
    """K7 and K8, forward and backward, at N = 256, B = 2 on seeded
    operands (bank_seeded_phases), keys ending in [n256]."""
    return bank_seeded_phases(dev, 2, 256, 17, "[n256]")


def k7_n600_phases(dev):
    """K7, forward and backward, at N = 600, B = 1, C = 8 (A = 32, ds = 4),
    past the old backward's N <= 518 (19 row tiles, dk summed over them), on
    seeded operands: bank_kernel_phases without K8 (whose plans stop at
    N = 334 / 266), keys ending in [n600]."""
    gen = torch.Generator(device=dev).manual_seed(19)
    q32, k32 = (0.8 * torch.randn(1, 8, 600, 32, device=dev, generator=gen) for _ in range(2))
    ops = {"q": q32.bfloat16(), "k": k32.bfloat16(), "q32": q32, "k32": k32, "ds": 4}
    return bank_kernel_phases([ops], "[n600]")


def chain_3d2d_path(dev):
    """Phase 6: 3D->2D graph generation at full width in three forms of one
    chain (the bank's ``attn_impl``: "auto", "pallas" = K7, "fused" = K8):
    the bank kernels against their plain versions on the chain's operands,
    one counted chain per form (the "auto" one through the CLI's main),
    graphs/s in turns, and 3 f32 steps of the K7 and K8 chains against the
    "auto" chain on the same weights and draws.  Returns (kernel results,
    {form: launch counts})."""
    from moleculesde_tpu_torch.benchmarks.profile_sampler_3d2d import (
        BATCH, CORRECTOR_STEPS, EDGE_EVALS, FORMS, N_STEPS, PATH_ARGS, path_batch)
    from moleculesde_tpu_torch.examples import sample_3d_to_2d as cli
    from moleculesde_tpu_torch.sampling.pc import sample_graph_pc

    args = cli.get_parser().parse_args(PATH_ARGS)
    batch = path_batch(args, dev)
    models = {form: cli.build_models(args, dev, attn_impl=form) for form in FORMS}
    results = bank_kernel_phases(bank_operands(*models["auto"], batch, dev))
    results.update(bank_large_n_phases(dev, 64, 128))
    layers = models["auto"][1].edge_score_network.num_layers
    b, n, c = batch.num_graphs, batch.n_max, models["auto"][1].num_class_x
    flags = batch.node_mask.reshape(b, n)
    launches = {}
    for form in FORMS:
        reset_counts()
        if form == "auto":     # the CLI as a user runs it
            res = cli.main(PATH_ARGS)
            check(len(res) == 1 and res[0]["x_gen"].shape == (b, n, c)
                  and res[0]["adj_gen"].shape == (b, n, n), "3D->2D CLI result shapes")
            adj_mean = torch.as_tensor(res[0]["adj_gen"])
            x_mean = torch.as_tensor(res[0]["x_gen"])
        else:
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            _, _, x_mean, adj_mean = cli.generate(*models[form], batch, gen, args)
        torch.cuda.synchronize()
        launches[form] = read_counts()
        want = {"pallas": {"attn_map_bank_kernel": EDGE_EVALS * layers},
                "fused": {"attn_qk_bank": EDGE_EVALS * layers}}.get(form, {})
        print(f"3D->2D chain [{form}] launches: {launches[form]} (expected {want or 'none'})",
              flush=True)
        check(launches[form] == expect(**want), f"3D->2D {form} chain launch counts")
        check(bool(torch.isfinite(x_mean).all() and torch.isfinite(adj_mean).all()),
              f"3D->2D {form} chain: non-finite graphs")
        pad = ~flags.cpu().bool()
        check(bool((adj_mean.cpu()[pad] == 0).all()), f"3D->2D {form} chain: padded rows")

    walls = {form: [] for form in FORMS}
    for form in FORMS + FORMS[::-1]:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.generate(*models[form], batch, gen, args)
        torch.cuda.synchronize()
        walls[form].append(time.perf_counter() - t0)
    for form, ws_ in walls.items():
        print(f"3D->2D chain [{form}] (SchNet + {N_STEPS} PC steps x {CORRECTOR_STEPS} "
              f"corrector steps, B={BATCH}, bf16 bank): wall_ms="
              f"{' / '.join(f'{w * 1e3:.2f}' for w in ws_)} graphs_per_s="
              f"{' / '.join(f'{BATCH / w:.2f}' for w in ws_)} pc_steps_per_s="
              f"{' / '.join(f'{N_STEPS / w:.2f}' for w in ws_)}", flush=True)
    saved = [cnt.launches for cnt in _counters()]
    for _ in range(2):   # the second reading after a warm profiler
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        wall, busy = profiled_ms(lambda: cli.generate(*models["fused"], batch, gen, args))
    for cnt, v in zip(_counters(), saved):
        cnt.launches = v
    print(f"3D->2D chain [fused] under the profiler: wall_ms={wall:.2f} device_busy_ms="
          f"{busy:.2f}; with the one-block-per-graph K8 (PERF.md section 5, H100, 700 W): wall "
          "398.46-559.91 ms, device busy 108.26 ms, K8 24.5 ms of it", flush=True)

    # 3 f32 steps: K7 and K8 chains against the eager bank, same weights and draws
    steps = 3
    enc = models["auto"][0]
    gen = torch.Generator(device=dev).manual_seed(13)
    per_step = (1 + CORRECTOR_STEPS) * (b * n * c + b * n * n)
    draws = {"x_prior": torch.randn((b, n, c), generator=gen, device=dev),
             "adj_prior": torch.randn((b, n, n), generator=gen, device=dev),
             "noise": torch.randn((steps, per_step), generator=gen, device=dev)}
    saved = [cnt.launches for cnt in _counters()]
    with torch.no_grad():
        _, node_3d = enc.encode_batch(batch)
        outs = {form: sample_graph_pc(cli.build_models(args, dev, attn_impl=form,
                                                       bf16_attn=False)[1],
                                      node_3d, batch, n_steps=steps,
                                      corrector_steps=CORRECTOR_STEPS, **draws)
                for form in FORMS}
    torch.cuda.synchronize()
    for cnt, v in zip(_counters(), saved):
        cnt.launches = v
    for form in ("pallas", "fused"):
        for idx, name in ((2, "x_mean"), (3, "adj_mean")):
            mine, ref = outs[form][idx], outs["auto"][idx]
            excess = ((mine - ref).abs() - (2e-4 + 1e-3 * ref.abs())).max().item()
            print(f"3D->2D {form} vs auto chain, f32, {steps} steps: {name} max_abs_err="
                  f"{(mine - ref).abs().max().item():.3e} (tolerance atol 2e-4 + rtol 1e-3; "
                  f"largest excess {excess:.3e})", flush=True)
            check(excess <= 0.0, f"the f32 {form} chain's {name} disagrees with the auto chain")
    return results, launches


# the gradient leaves the kernels write or feed first: K1's bond tables,
# K2's filter net, K3's W and bias and the pair halves' Linear and BatchNorm.
# Left out: edge_2D_emb_0.bias, whose gradient is zero in exact arithmetic
# (the training-mode BatchNorm after it removes any shift), so that both
# builds hold only rounding noise there
KERNEL_LEAVES = (("model_2D", ".BondEncoder_0."),
                 ("model_3D", ".Dense_0."), ("model_3D", ".Dense_1."),
                 ("SDE_2Dto3D_model", "edge_2D_emb_"))
ZERO_GRAD_LEAVES = ("SDE_2Dto3D_model.edge_2D_emb_0.bias",)
# the SDE_2Dto3D_model leaves of KERNEL_LEAVES that each 2D->3D variant
# has, named outright so that a renamed or dropped leaf fails the check:
# variants 1 and 2 have K3's pair block, variant 4 its kernel and bias;
# variant 3's ``edge_2D_emb.*`` feeds no kernel and is not one of them
_PAIR_BLOCK_LEAVES = ("edge_2D_emb_0.kernel", "edge_2D_emb_bn.scale", "edge_2D_emb_bn.bias",
                      "edge_2D_emb_1.kernel", "edge_2D_emb_1.bias")
PAIR_LEAVES = {1: _PAIR_BLOCK_LEAVES, 2: _PAIR_BLOCK_LEAVES, 3: (),
               4: ("edge_2D_emb_kernel", "edge_2D_emb_bias")}


def _grad_norms(models):
    return {name: torch.sqrt(sum((p.grad.float() ** 2).sum() for p in m.parameters()
                                 if p.grad is not None)).item()
            for name, m in models.items()}


def _kernel_leaf_grads(models):
    """{component.name: gradient} of the leaves in KERNEL_LEAVES."""
    out = {}
    for comp, part in KERNEL_LEAVES:
        for name, p in models[comp].named_parameters():
            key = f"{comp}.{name}"
            if (part in name and key not in ZERO_GRAD_LEAVES
                    and (comp != "model_3D" or "SchNetInteraction_" in name)):
                out[key] = p.grad.detach().float().clone()
    return out


def one_step(dev, cfg, models, batch, seed: int):
    """One step's (loss terms, component gradient norms, KERNEL_LEAVES
    gradients) on ``models``, dropout masks and loss draws from ``seed``;
    the models' state is left as it was."""
    from moleculesde_tpu_torch.data.compact import CompactBatch, expand_on_device
    from moleculesde_tpu_torch.pretrain.train_step import draw_losses, pretrain_loss

    if isinstance(batch, CompactBatch):
        batch = expand_on_device(batch)
    saved = {n: {k: v.clone() for k, v in m.state_dict().items()} for n, m in models.items()}
    g = torch.Generator(device=dev).manual_seed(seed)
    for m in models.values():
        m.zero_grad(set_to_none=True)
    total, mets = pretrain_loss(models, cfg, batch, g, draws=draw_losses(models, cfg, batch, g))
    total.backward()
    out = ({k: v.item() for k, v in mets.items()}, _grad_norms(models),
           _kernel_leaf_grads(models))
    for n, m in models.items():
        m.load_state_dict(saved[n])
        m.zero_grad(set_to_none=True)
    return out


def step_pair(dev, cfg, models, batch, seed: int):
    """:func:`one_step` on ``models`` and on an all-plain build of the same
    weights, batch statistics and draws; the launch counts are left as
    they were."""
    from moleculesde_tpu_torch.pretrain.train_state import build_models

    plain = build_models(cfg, dev, impl="plain")
    for name in models:
        plain[name].load_state_dict(models[name].state_dict())
    saved_counts = [c.launches for c in _counters()]
    out = [one_step(dev, cfg, ms, batch, seed) for ms in (models, plain)]
    for c, n in zip(_counters(), saved_counts):
        c.launches = n
    return out[0], out[1]


def step_against_plain(dev, cfg, models, batch, seed: int, label: str) -> float:
    """One step's loss terms, component gradient norms and the kernels' own
    gradient leaves (KERNEL_LEAVES) against an all-plain build of the same
    weights, batch statistics and draws (:func:`step_pair`).  Returns the
    leaves' bar."""
    from moleculesde_tpu_torch.pretrain.train_step import METRICS

    (mk, gk, lk), (mp, gp, lp) = step_pair(dev, cfg, models, batch, seed)
    # bf16 step: both builds round at the same places; sums in another order
    # move a rounded value by one bf16 ulp now and then.  Three runs read at
    # most 1.2e-4 on loss terms and gradient norms: 1e-3 is about 10x that
    tol = 1e-3
    for k in METRICS:
        err = abs(mk[k] - mp[k]) / max(1e-6, abs(mp[k]))
        print(f"{label} vs plain step: {k} {mk[k]:.6f} vs {mp[k]:.6f} rel {err:.2e} "
              f"(tolerance {tol:g})", flush=True)
        check(err <= tol, f"{label}: {k} disagrees with the all-plain step")
    for name in gk:
        err = abs(gk[name] - gp[name]) / max(1e-12, gp[name])
        print(f"{label} vs plain step: |grad {name}| {gk[name]:.6e} vs {gp[name]:.6e} "
              f"rel {err:.2e} (tolerance {tol:g})", flush=True)
        check(err <= tol, f"{label}: gradient norm of {name} disagrees with the all-plain step")
    # the kernels' own leaves one by one: |g_kernel - g_plain| / |g_plain|
    # (L2), so a dropped or wrong weight gradient (error ~1) cannot hide in a
    # component's norm.  Readings reach 8.3e-3 (the bond tables: a sum over
    # all edges of bf16-rounded cotangents, with cancellation): 5e-2 is
    # about 6x that
    leaf_tol = 5e-2
    pair = PAIR_LEAVES[cfg.sde_2dto3d_variant]
    check(sorted(lk) == sorted(lp) and len(lk) == (
        3 * cfg.num_layer + 4 * cfg.schnet_num_interactions + len(pair))
        and sorted(k.removeprefix("SDE_2Dto3D_model.") for k in lk
                   if k.startswith("SDE_2Dto3D_model.")) == sorted(pair),
        f"kernel leaves {sorted(lk)}")
    errs = {k: ((lk[k] - lp[k]).norm() / lp[k].norm().clamp(min=1e-30)).item() for k in lk}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    print(f"{label} vs plain step: {len(errs)} kernel leaves, relative L2 errors "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst[:6]) + f" ... (tolerance {leaf_tol:g})",
          flush=True)
    for k, v in worst:
        check(v <= leaf_tol, f"{label}: gradient of {k} disagrees with the all-plain step "
              f"({v:.3e})")
    return leaf_tol


def training_path(dev):
    """Phase 7 (and the training kernel phases): returns (kernel results,
    launch counts of the five timed steps)."""
    from moleculesde_tpu_torch.benchmarks.profile_pretrain import (
        BATCH, PATH_ARGS, parse_path, path_batches)
    from moleculesde_tpu_torch.examples import pretrain as cli
    from moleculesde_tpu_torch.pretrain.train_step import METRICS, pretrain_step

    args = parse_path(PATH_ARGS)
    batches = path_batches(args, dev)
    cfg, models, optimizer, gen = cli.setup(args, dev)
    with torch.no_grad():
        operands = training_operands(models, batches[0])
    results = training_kernel_phases(*operands)

    steps = 5
    check(len(batches) >= steps + 1, f"only {len(batches)} batches")
    metrics = pretrain_step(models, optimizer, cfg, batches[0], gen)   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    history = [pretrain_step(models, optimizer, cfg, batch, gen)
               for batch in batches[1:steps + 1]]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = read_counts()
    per_step = {k: v / steps for k, v in launches.items()}
    expected = expect(gin_messages=cfg.num_layer, gin_messages_bwd=cfg.num_layer,
                      fused_cfconv=cfg.schnet_num_interactions,
                      fused_cfconv_bwd=cfg.schnet_num_interactions,
                      pair_relu_project=1, pair_relu_project_bwd=1)
    print(f"training path launches over {steps} steps: {launches} (per step {per_step}; "
          f"expected {expected})", flush=True)
    check(per_step == expected, f"training path launch counts {launches}")
    for m in [metrics] + history:
        vals = {k: float(m[k]) for k in METRICS}
        check(all(math.isfinite(v) for v in vals.values()), f"non-finite metrics {vals}")
    print("training metrics, last step: " + ", ".join(
        f"{k}={float(history[-1][k]):.5f}" for k in METRICS), flush=True)
    print(f"training path: B={BATCH} molecules, n_max {args.n_max}, bf16, {steps} steps "
          f"step_ms={step_ms:.2f} molecules_per_s={BATCH / step_ms * 1e3:.2f}", flush=True)

    leaf_tol = step_against_plain(dev, cfg, models, batches[steps], args.seed + 1, "kernel")
    cm_launches = pair_cm_direct_steps(dev, args, cfg, models, batches, leaf_tol)
    bank_launches = bank_training_steps(dev, args, cfg, models, batches, leaf_tol)
    return results, launches, cm_launches, bank_launches


def pair_cm_direct_steps(dev, args, cfg, models, batches, leaf_tol, reference: str = "K3"):
    """Phase 8: two pretraining steps with ``pair_cm_direct=True`` on the
    trained weights (K4 forward and backward once per step, K3 never), then
    one step's losses and K4's own gradient leaves against the K3 build of
    the same weights and draws (``reference`` "plain": against the
    all-plain ``pair_cm_direct`` build, K4's plain version rounding where
    K4 rounds, before the add, which K3 does not).  Returns the launch
    counts of the two steps."""
    from moleculesde_tpu_torch.pretrain.train_state import build_models, make_optimizer
    from moleculesde_tpu_torch.pretrain.train_step import (
        METRICS, draw_losses, pretrain_loss, pretrain_step)

    def copy(pair_cm_direct, impl="auto"):
        ms = build_models(cfg, dev, impl=impl, pair_cm_direct=pair_cm_direct)
        for name in models:
            ms[name].load_state_dict(models[name].state_dict())
        return ms

    cm = copy(True)
    optimizer = make_optimizer(cm, cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    steps = 2
    reset_counts()
    history = [pretrain_step(cm, optimizer, cfg, batch, gen) for batch in batches[1:steps + 1]]
    torch.cuda.synchronize()
    launches = read_counts()
    expected = expect(gin_messages=steps * cfg.num_layer, gin_messages_bwd=steps * cfg.num_layer,
                      fused_cfconv=steps * cfg.schnet_num_interactions,
                      fused_cfconv_bwd=steps * cfg.schnet_num_interactions,
                      pair_relu_project_cm=steps, pair_relu_project_cm_bwd=steps)
    print(f"pair_cm_direct training launches over {steps} steps: {launches} (expected "
          f"{expected})", flush=True)
    check(launches == expected, f"pair_cm_direct training launch counts {launches}")
    for m in history:
        vals = {k: float(m[k]) for k in METRICS}
        check(all(math.isfinite(v) for v in vals.values()), f"non-finite metrics {vals}")

    batch = batches[steps + 1]
    out = {}
    saved = [c.launches for c in _counters()]
    ref = "K3" if reference == "K3" else "all-plain K4"
    for label, ms in ((ref, copy(False) if reference == "K3" else copy(True, "plain")),
                      ("K4", copy(True))):
        g = torch.Generator(device=dev).manual_seed(args.seed + 3)
        total, mets = pretrain_loss(ms, cfg, batch, g, draws=draw_losses(ms, cfg, batch, g))
        total.backward()
        leaves = {n: p.grad.detach().float().clone()
                  for n, p in ms["SDE_2Dto3D_model"].named_parameters()
                  if n.startswith("edge_2D_emb_") and f"SDE_2Dto3D_model.{n}" not in
                  ZERO_GRAD_LEAVES}
        out[label] = ({k: v.item() for k, v in mets.items()}, leaves)
    for c, n in zip(_counters(), saved):
        c.launches = n
    (m3, l3), (m4, l4) = out[ref], out["K4"]
    tol = 1e-3
    for k in METRICS:
        err = abs(m4[k] - m3[k]) / max(1e-6, abs(m3[k]))
        print(f"K4 vs {ref} step: {k} {m4[k]:.6f} vs {m3[k]:.6f} rel {err:.2e} (tolerance "
              f"{tol:g})", flush=True)
        check(err <= tol, f"{k} of the pair_cm_direct step disagrees with the {ref} step")
    check(sorted(l4) == sorted(l3) and len(l4) == 5, f"K4 leaves {sorted(l4)}")
    for k in sorted(l4):
        err = ((l4[k] - l3[k]).norm() / l3[k].norm().clamp(min=1e-30)).item()
        print(f"K4 vs {ref} step: grad {k} relative L2 {err:.2e} (tolerance {leaf_tol:g})",
              flush=True)
        check(err <= leaf_tol, f"gradient of {k} disagrees with the {ref} step ({err:.3e})")
    return launches


def bank_training_steps(dev, args, cfg, models, batches, leaf_tol, label: str = "",
                        profile: bool = False):
    """Phase 9 (and 13 at n_max 64 and 128): two pretraining steps each
    with ``attn_impl_3dto2d="pallas"`` (K7 forward and backward once per
    edge layer) and ``"fused"`` (K8) on the trained weights, K1-K3 as
    before; with ``profile``, a third "fused" step under the profiler (wall
    and device-busy ms) and the peak device memory of the three; then one
    step's losses and the edge network's q / k gradient leaves of each
    against the ``"auto"`` build of the same weights and draws.  Returns
    {form: launch counts of its two steps}."""
    import dataclasses

    from moleculesde_tpu_torch.pretrain.train_state import build_models, make_optimizer
    from moleculesde_tpu_torch.pretrain.train_step import (
        METRICS, draw_losses, pretrain_loss, pretrain_step)

    def copy(impl):
        ms = build_models(dataclasses.replace(cfg, attn_impl_3dto2d=impl), dev)
        for name in models:
            ms[name].load_state_dict(models[name].state_dict())
        return ms

    steps = 2
    layers = models["SDE_3Dto2D_model"].edge_score_network.num_layers
    launches = {}
    for impl, fwd, bwd in (("pallas", attn_map_bank_kernel, attn_map_bank_kernel_bwd),
                           ("fused", attn_qk_bank, attn_qk_bank_bwd)):
        ms = copy(impl)
        optimizer = make_optimizer(ms, cfg)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        history = [pretrain_step(ms, optimizer, cfg, batch, gen)
                   for batch in batches[1:steps + 1]]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        launches[impl] = read_counts()
        expected = expect(
            gin_messages=steps * cfg.num_layer, gin_messages_bwd=steps * cfg.num_layer,
            fused_cfconv=steps * cfg.schnet_num_interactions,
            fused_cfconv_bwd=steps * cfg.schnet_num_interactions,
            pair_relu_project=steps, pair_relu_project_bwd=steps,
            **{fwd.__name__: steps * layers, bwd.__name__: steps * layers})
        print(f"{label}{impl} bank training launches over {steps} steps: {launches[impl]} "
              f"(expected {expected}); step_ms={step_ms:.2f} (first steps of a new build)",
              flush=True)
        check(launches[impl] == expected, f"{label}{impl} bank training launch counts")
        for m in history:
            vals = {k: float(m[k]) for k in METRICS}
            check(all(math.isfinite(v) for v in vals.values()),
                  f"{label}{impl} bank: non-finite metrics {vals}")
        if profile and impl == "fused":
            saved = [c.launches for c in _counters()]
            wall, busy = profiled_ms(lambda: pretrain_step(ms, optimizer, cfg, batches[0], gen))
            for c, n in zip(_counters(), saved):
                c.launches = n
            print(f"{label}fused bank training, a third step under the profiler: wall_ms="
                  f"{wall:.2f} device_busy_ms={busy:.2f}; max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB over the three steps",
                  flush=True)
        del ms, optimizer

    batch = batches[steps + 1]
    out = {}
    saved = [c.launches for c in _counters()]
    for impl in ("auto", "pallas", "fused"):
        ms = copy(impl)
        g = torch.Generator(device=dev).manual_seed(args.seed + 5)
        total, mets = pretrain_loss(ms, cfg, batch, g, draws=draw_losses(ms, cfg, batch, g))
        total.backward()
        leaves = {n: p.grad.detach().float().clone()
                  for n, p in ms["SDE_3Dto2D_model"].edge_score_network.named_parameters()
                  if ".attn.q_" in n or ".attn.k_" in n}
        out[impl] = ({k: v.item() for k, v in mets.items()}, leaves)
    for c, n in zip(_counters(), saved):
        c.launches = n
    # the XLA bank rounds the logits and tanh to bf16, K7 / K8 keep them in
    # f32 (and K8 the q / k nets' bias adds and tanh): the losses move by
    # rounding noise, the q / k leaves as PR 2's kernel-owned leaves
    tol = 1e-3
    (ma, la) = out["auto"]
    for impl in ("pallas", "fused"):
        mi, li = out[impl]
        for k in METRICS:
            err = abs(mi[k] - ma[k]) / max(1e-6, abs(ma[k]))
            print(f"{label}{impl} vs auto bank step: {k} {mi[k]:.6f} vs {ma[k]:.6f} rel "
                  f"{err:.2e} (tolerance {tol:g})", flush=True)
            check(err <= tol, f"{label}{k} of the {impl} bank step disagrees with the auto step")
        check(sorted(li) == sorted(la) and len(li) == 8 * layers, f"{impl} leaves {sorted(li)}")
        errs = {k: ((li[k] - la[k]).norm() / la[k].norm().clamp(min=1e-30)).item() for k in li}
        worst = sorted(errs.items(), key=lambda kv: -kv[1])
        print(f"{label}{impl} vs auto bank step: {len(errs)} q / k leaves, relative L2 errors "
              + ", ".join(f"{k} {v:.2e}" for k, v in worst[:4])
              + f" ... (tolerance {leaf_tol:g})", flush=True)
        for k, v in worst:
            check(v <= leaf_tol, f"{label}gradient of {k} of the {impl} step disagrees "
                  f"({v:.3e})")
    return launches


def compact_kernel_phases(models, batch):
    """K5 forward and backward against its plain version on the compact
    path's SchNet interaction-0 operands (distances from the expanded
    batch), bf16 (the path's mode) and f32, at K2's bars."""
    from moleculesde_tpu_torch.data.compact import expand_on_device

    m3d = models["model_3D"]
    with torch.no_grad():
        eb = expand_on_device(batch)
        b, n = eb.num_graphs, eb.n_max
        _, cos_env, pair_mask, dist = m3d.geometry(eb.positions, eb.node_mask, b, n)
        env = (cos_env * pair_mask.to(cos_env.dtype)).contiguous()
        inter = m3d.SchNetInteraction_0
        h0 = m3d.Embed_0.embedding[eb.atomic_numbers.long()].reshape(b, n, -1)
        x = inter.Dense_2(h0).float().contiguous()
        dist = dist.contiguous()
    params = tuple(t.detach() for t in (inter.Dense_0.kernel, inter.Dense_0.bias,
                                        inter.Dense_1.kernel, inter.Dense_1.bias))
    kw = dict(start=0.0, stop=m3d.cutoff, num_gaussians=m3d.num_gaussians)
    g = torch.randn(x.shape, generator=torch.Generator(device=x.device).manual_seed(7),
                    device=x.device)
    print(f"compact K5 operands: dist {tuple(dist.shape)}, x {tuple(x.shape)}, "
          f"G {m3d.num_gaussians} ({int((env != 0).sum())} pairs in the cutoff)", flush=True)
    results = {}
    for bf16 in (True, False):   # bf16 is the path's mode
        sfx = "" if bf16 else "[f32]"
        results["fused_cfconv_rbf" + sfx], results["fused_cfconv_rbf_bwd" + sfx] = grad_phase(
            "compact K5 fused_cfconv_rbf" + sfx,
            lambda *t, **k: fused_cfconv_rbf(dist, env, *t, **kw, **k),
            lambda *t, **k: fused_cfconv_rbf_bwd(dist, env, *t, **kw, **k),
            lambda *t, **k: fused_cfconv_rbf_bwd_plain(dist, env, *t, **kw, **k),
            (x,) + params, g, bf16, 2e-2 if bf16 else 1e-4,
            k5_cost(env, x, params[0]), k5_cost(env, x, params[0], bwd=True),
            PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)
    return results


def check_expansion(dev, args, compact_batch):
    """The first compact batch, expanded on the card, against the padded
    collation of the same molecules (the padded loader's first batch, same
    seed): every list field equal, and the dense extended graph equal to
    the scatter of the host-built extended lists."""
    import argparse

    from moleculesde_tpu_torch.benchmarks.profile_pretrain import path_batches
    from moleculesde_tpu_torch.core.batch import dense_scatter
    from moleculesde_tpu_torch.data.compact import expand_on_device

    padded_args = argparse.Namespace(**{**vars(args), "ingest": "padded"})
    gb = path_batches(padded_args, dev)[0]
    eb = expand_on_device(compact_batch)
    for f in ("atom_feats", "node_mask", "positions", "edge_src", "edge_dst", "edge_feats",
              "edge_mask"):
        check(torch.equal(getattr(eb, f), getattr(gb, f)), f"expanded {f} differs from padded")
    b, n = gb.num_graphs, gb.n_max
    mask = dense_scatter(gb.ext_src, gb.ext_dst, gb.ext_mask, torch.ones_like(gb.ext_mask), b, n)
    attr = dense_scatter(gb.ext_src, gb.ext_dst, gb.ext_mask, gb.ext_attr, b, n)
    check(torch.equal(eb.ext_dense_mask, mask) and torch.equal(eb.ext_dense_attr, attr),
          "expanded extended graph differs from the padded path's")
    print(f"compact expansion: B={b} batch equal to its padded collation "
          f"({int(mask.sum())} extended edges)", flush=True)


def compact_training_path(dev):
    """Phase 10: the pretraining CLI at the JAX CLI's defaults (compact
    ingest) with ``--schnet_cfconv pallas_rbf``, B=128: K5 phases, the
    expansion against the padded collation, one warm-up and five timed
    steps with the launch counts per step (K1 5 / 5, K5 6 / 6, K3 1 / 1, K2
    none), then one step against an all-plain build.  Returns (K5 results,
    launch counts of the five steps)."""
    from moleculesde_tpu_torch.benchmarks.profile_pretrain import (
        COMPACT_ARGS, parse_path, path_batches)
    from moleculesde_tpu_torch.data.compact import CompactBatch
    from moleculesde_tpu_torch.examples import pretrain as cli
    from moleculesde_tpu_torch.pretrain.train_step import METRICS, pretrain_step

    args = parse_path(COMPACT_ARGS)
    batches = path_batches(args, dev)
    check(args.ingest == "compact" and isinstance(batches[0], CompactBatch),
          "the CLI's default ingest is not compact")
    check_expansion(dev, args, batches[0])
    cfg, models, optimizer, gen = cli.setup(args, dev)
    results = compact_kernel_phases(models, batches[0])

    steps = 5
    metrics = pretrain_step(models, optimizer, cfg, batches[0], gen)   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    history = [pretrain_step(models, optimizer, cfg, batch, gen)
               for batch in batches[1:steps + 1]]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = read_counts()
    per_step = {k: v / steps for k, v in launches.items()}
    expected = expect(gin_messages=cfg.num_layer, gin_messages_bwd=cfg.num_layer,
                      fused_cfconv_rbf=cfg.schnet_num_interactions,
                      fused_cfconv_rbf_bwd=cfg.schnet_num_interactions,
                      pair_relu_project=1, pair_relu_project_bwd=1)
    print(f"compact path launches over {steps} steps: {launches} (per step {per_step}; "
          f"expected {expected})", flush=True)
    check(per_step == expected, f"compact path launch counts {launches}")
    for m in [metrics] + history:
        vals = {k: float(m[k]) for k in METRICS}
        check(all(math.isfinite(v) for v in vals.values()), f"non-finite metrics {vals}")
    print(f"compact path: B={args.batch_size} molecules, n_max {args.n_max}, bf16, K5, "
          f"{steps} steps step_ms={step_ms:.2f} molecules_per_s="
          f"{args.batch_size / step_ms * 1e3:.2f}", flush=True)
    step_against_plain(dev, cfg, models, batches[steps], args.seed + 6, "compact K5")
    return results, launches


def large_n_kernel_phases(models, batch, label):
    """K2 and K5, forward and backward, against their plain versions on
    SchNet interaction 0's operands of ``batch`` (expanded on the card), in
    bf16 (the path's mode) and f32 at the main path's bars; then two
    forward and two backward runs of each, bit for bit, and K5's forward
    and backward against K2's fed the same smearing, bit for bit."""
    from moleculesde_tpu_torch.data.compact import expand_on_device
    from moleculesde_tpu_torch.ops.cfconv import smear

    m3d = models["model_3D"]
    with torch.no_grad():
        eb = expand_on_device(batch)
        b, n = eb.num_graphs, eb.n_max
        ea, cos_env, pair_mask, dist = m3d.geometry(eb.positions, eb.node_mask, b, n)
        env = (cos_env * pair_mask.to(cos_env.dtype)).contiguous()
        ea, dist = ea.contiguous(), dist.contiguous()
        inter = m3d.SchNetInteraction_0
        h0 = m3d.Embed_0.embedding[eb.atomic_numbers.long()].reshape(b, n, -1)
        x = inter.Dense_2(h0).float().contiguous()
    params = (x,) + tuple(t.detach() for t in (inter.Dense_0.kernel, inter.Dense_0.bias,
                                                inter.Dense_1.kernel, inter.Dense_1.bias))
    kw = dict(start=0.0, stop=m3d.cutoff, num_gaussians=m3d.num_gaussians)
    g = torch.randn(x.shape, generator=torch.Generator(device=x.device).manual_seed(7),
                    device=x.device)
    print(f"{label} CFConv operands: ea {tuple(ea.shape)} {ea.dtype}, x {tuple(x.shape)} "
          f"({int((env != 0).sum())} pairs in the cutoff)", flush=True)
    results = {}
    for bf16 in (True, False):   # bf16 is the path's mode
        sfx = "" if bf16 else "[f32]"
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
        ea_m = ea if bf16 else ea.float()
        results["fused_cfconv" + sfx], results["fused_cfconv_bwd" + sfx] = grad_phase(
            f"{label} K2 fused_cfconv" + sfx,
            lambda *t, ea=ea_m, **k: fused_cfconv(ea, env, *t, **k),
            lambda *t, ea=ea_m, **k: fused_cfconv_bwd(ea, env, *t, **k),
            lambda *t, ea=ea_m, **k: fused_cfconv_bwd_plain(ea, env, *t, **k),
            params, g, bf16, 2e-2 if bf16 else 1e-4,
            k2_cost(ea_m, env, x, params[1]), k2_cost(ea_m, env, x, params[1], bwd=True), peak)
        results["fused_cfconv_rbf" + sfx], results["fused_cfconv_rbf_bwd" + sfx] = grad_phase(
            f"{label} K5 fused_cfconv_rbf" + sfx,
            lambda *t, **k: fused_cfconv_rbf(dist, env, *t, **kw, **k),
            lambda *t, **k: fused_cfconv_rbf_bwd(dist, env, *t, **kw, **k),
            lambda *t, **k: fused_cfconv_rbf_bwd_plain(dist, env, *t, **kw, **k),
            params, g, bf16, 2e-2 if bf16 else 1e-4,
            k5_cost(env, x, params[1]), k5_cost(env, x, params[1], bwd=True), peak)
    saved = [c.launches for c in _counters()]
    with torch.no_grad():
        ea_k5 = smear(dist, bf16=True, **kw).contiguous()   # K5's smearing, in bf16
        for what, run in (
                ("K2 forward", lambda: (fused_cfconv(ea, env, *params, bf16=True),)),
                ("K5 forward", lambda: (fused_cfconv_rbf(dist, env, *params, bf16=True, **kw),)),
                ("K2 backward", lambda: fused_cfconv_bwd(ea, env, *params, g, bf16=True)),
                ("K5 backward",
                 lambda: fused_cfconv_rbf_bwd(dist, env, *params, g, bf16=True, **kw))):
            first, second = run(), run()
            check(all(torch.equal(u, v) for u, v in zip(first, second)),
                  f"{label} {what}: two runs differ")
        check(torch.equal(fused_cfconv_rbf(dist, env, *params, bf16=True, **kw),
                          fused_cfconv(ea_k5, env, *params, bf16=True)),
              f"{label}: K5's forward differs from K2's on the same smearing")
        k5 = fused_cfconv_rbf_bwd(dist, env, *params, g, bf16=True, **kw)
        k2 = fused_cfconv_bwd(ea_k5, env, *params, g, bf16=True)
        check(all(torch.equal(u, v) for u, v in zip(k5, k2)),
              f"{label}: K5's backward differs from K2's on the same smearing")
    for c, k in zip(_counters(), saved):
        c.launches = k
    print(f"{label}: K2 and K5 forward and backward bit-identical over two runs; K5 == K2 "
          f"on the same smearing, forward and backward, bit for bit", flush=True)
    return results


def gin_pair_same_bits(label, k1, g1, k3, g3, g4):
    """Two runs of K1's, K3's and K4's forward and backward give the same
    bits, in bf16 and f32 (launch counts left as they were)."""
    x, src, dst, boh, table = k1
    a, c, w = k3[:3]
    bias = k3[3] if len(k3) > 3 else None
    with torch.no_grad():
        for bf16 in (True, False):
            sfx = "" if bf16 else "[f32]"
            same_bits(f"{label} K1 forward" + sfx, lambda: gin_messages(
                x, src, dst, boh, table, bf16=bf16, impl="kernel"))
            same_bits(f"{label} K1 backward" + sfx, lambda: gin_messages_bwd(
                x, src, dst, boh, table, g1, bf16=bf16, impl="kernel"))
            same_bits(f"{label} K3 forward" + sfx, lambda: pair_relu_project(
                a, c, w, bias, bf16=bf16, impl="kernel"))
            same_bits(f"{label} K4 forward" + sfx, lambda: pair_relu_project_cm(
                a, c, w, bf16=bf16, impl="kernel"))
            same_bits(f"{label} K3 backward" + sfx, lambda: pair_relu_project_bwd(
                a, c, w, g3, bf16=bf16, impl="kernel"))
            same_bits(f"{label} K4 backward" + sfx, lambda: pair_relu_project_cm_bwd(
                a, c, w, g4, bf16=bf16, impl="kernel"))
    print(f"{label}: K1, K3 and K4 forward and backward bit-identical over two runs, bf16 "
          f"and f32", flush=True)


def large_n_gin_pair_phases(models, batch, label, reps=None):
    """K1, K3 and K4, forward and backward, against their plain versions on
    GIN layer 0's and the 2D->3D edge embedding's operands of ``batch``
    (expanded on the card), in bf16 (the path's mode) and f32 at the
    training phase's bars; then two runs of K1's forward and backward and
    of K3's and K4's backward, bit for bit, in both modes."""
    from moleculesde_tpu_torch.data.compact import expand_on_device

    with torch.no_grad():
        k1, _, k3 = training_operands(models, expand_on_device(batch))
    x, src, dst, boh, table = k1
    a, c, w, bias = k3
    b, n, _ = x.shape
    h = w.shape[1]
    gen = torch.Generator(device=x.device).manual_seed(7)
    g1 = torch.randn(x.shape, generator=gen, device=x.device)
    g3 = torch.randn((b, n, n, h), generator=gen, device=a.device)
    g4 = torch.randn((b, h, n * n), generator=gen, device=a.device)
    valid_edges = int(((dst >= 0) & (dst < n)).sum())
    print(f"{label} K1 operands: x {tuple(x.shape)}, edges {tuple(src.shape)} ({valid_edges} "
          f"valid); K3 / K4: a, c {tuple(a.shape)}, W {tuple(w.shape)}", flush=True)
    results = {}
    for bf16 in (True, False):   # bf16 is the path's mode
        sfx = "" if bf16 else "[f32]"
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
        results["gin_messages" + sfx], results["gin_messages_bwd" + sfx] = grad_phase(
            f"{label} K1 gin_messages" + sfx,
            lambda x_, t_, **kw: gin_messages(x_, src, dst, boh, t_, **kw),
            lambda x_, t_, g_, **kw: gin_messages_bwd(x_, src, dst, boh, t_, g_, **kw),
            lambda x_, t_, g_, **kw: gin_messages_bwd_plain(x_, src, dst, boh, t_, g_, **kw),
            (x, table), g1, bf16, 1e-2 if bf16 else 1e-4,
            k1_cost(x, src, dst, table), k1_cost(x, src, dst, table, bwd=True), peak,
            reps=reps)
        results["pair_relu_project" + sfx], results["pair_relu_project_bwd" + sfx] = \
            grad_phase(f"{label} K3 pair_relu_project" + sfx, pair_relu_project,
                       lambda a_, c_, w_, b_, g_, **kw: pair_relu_project_bwd(
                           a_, c_, w_, g_, **kw),
                       lambda a_, c_, w_, b_, g_, **kw: pair_relu_project_bwd_plain(
                           a_, c_, w_, g_, **kw),
                       (a, c, w, bias), g3, bf16, 1e-3 if bf16 else 1e-4,
                       k3_cost(a, w), k3_cost(a, w, bwd=True), peak, reps=reps)
        results["pair_relu_project_cm" + sfx], results["pair_relu_project_cm_bwd" + sfx] = \
            grad_phase(f"{label} K4 pair_relu_project_cm" + sfx, pair_relu_project_cm,
                       pair_relu_project_cm_bwd, pair_relu_project_cm_bwd_plain,
                       (a, c, w), g4, bf16, 1e-3 if bf16 else 1e-4,
                       k4_cost(a, w), k4_cost(a, w, bwd=True), peak, reps=reps)
    gin_pair_same_bits(label, k1, g1, (a, c, w), g3, g4)
    return results


def pair_fwd_n256_phases(dev):
    """K3 and K4 forward at N = 256, B = 2 (C = 300, H = 32, seeded normal
    operands; the first forward took N <= 160) against their plain versions
    in bf16 and f32 at the bars of 7, timed beside their bounds."""
    gen = torch.Generator(device=dev).manual_seed(13)
    a, c = (torch.randn(2, 256, 300, device=dev, generator=gen) for _ in range(2))
    w = torch.randn(300, 32, device=dev, generator=gen) / 300 ** 0.5
    bias = torch.randn(32, device=dev, generator=gen)
    results = {}
    for bf16 in (True, False):
        sfx = "" if bf16 else "[f32]"
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
        tol = 1e-3 if bf16 else 1e-5
        for name, wrapper, plain, args, cost in (
                ("pair_relu_project", pair_relu_project, pair_relu_project_plain,
                 (a, c, w, bias), k3_cost(a, w)),
                ("pair_relu_project_cm", pair_relu_project_cm, pair_relu_project_cm_plain,
                 (a, c, w), k4_cost(a, w))):
            run_k = lambda f=wrapper, t=args, m=bf16: f(*t, bf16=m, impl="kernel")  # noqa: E731
            run_p = lambda f=plain, t=args, m=bf16: f(*t, bf16=m)  # noqa: E731
            label = f"N=256 B=2 {'K4' if 'cm' in name else 'K3'} {name}" + sfx
            err, rel = compare(label, run_k, run_p, tol)
            results[name + sfx] = report(label, err, tol, run_k, run_p, *cost, peak)
            results[name + sfx]["max_rel_err"] = rel
    return results


def large_n_steps(dev, args, cfg, models, optimizer, gen, batches, label, seed):
    """Two pretraining steps on ``batches[:2]`` with the launch counts per
    step (K1 5 / 5, K2 6 / 6, K3 1 / 1), every metric finite; a third
    under the profiler (wall and device-busy ms) and the peak device memory
    of the three; then one step against an all-plain build on
    ``batches[3]``.  Returns (the launch counts of the two steps, the
    leaves' bar of that comparison)."""
    from moleculesde_tpu_torch.pretrain.train_step import METRICS, pretrain_step

    steps = 2
    check(len(batches) >= steps + 2, f"{label}: only {len(batches)} batches")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for batch in batches[:steps]:
        t0 = time.perf_counter()
        metrics = pretrain_step(models, optimizer, cfg, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(metrics[k]) for k in METRICS}
        check(all(math.isfinite(v) for v in vals.values()), f"{label} non-finite metrics {vals}")
    launches = read_counts()
    expected = expect(gin_messages=steps * cfg.num_layer, gin_messages_bwd=steps * cfg.num_layer,
                      fused_cfconv=steps * cfg.schnet_num_interactions,
                      fused_cfconv_bwd=steps * cfg.schnet_num_interactions,
                      pair_relu_project=steps, pair_relu_project_bwd=steps)
    print(f"{label} training: B={args.batch_size}, K2 path; launches {launches} (expected "
          f"{expected}); step_ms={times[0]:.2f}, {times[1]:.2f} (first steps of a new build)",
          flush=True)
    check(launches == expected, f"{label} training launch counts")
    saved = [c.launches for c in _counters()]
    wall, busy = profiled_ms(lambda: pretrain_step(models, optimizer, cfg, batches[steps], gen))
    for c, k in zip(_counters(), saved):
        c.launches = k
    print(f"{label} training, third step under the profiler: wall_ms={wall:.2f} "
          f"device_busy_ms={busy:.2f}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB over the three steps",
          flush=True)
    return launches, step_against_plain(dev, cfg, models, batches[steps + 1], seed, label)


def large_n_path(dev):
    """Phase 13: the JAX CLI's default path (compact ingest, K2) at
    ``--n_max 64``, B=128: K2 / K5, K1, K3 and K4 phases on its operands,
    two steps with the launch counts per step (K1 5 / 5, K2 6 / 6, K3 1 /
    1), every metric finite, one profiled step, one step against an
    all-plain build, then two steps each with the "pallas" (K7) and "fused"
    (K8) bank (K7 / K8 4 / 4 a step, one profiled "fused" step) against the
    "auto" build; then the same at ``--n_max 128``, B=32 (cut from the
    CLI's 128), where K7 and K8 are also held against their plain versions
    on the 3D->2D chain's edge-layer operands; then K3 / K4 forward and K7 /
    K8 at N = 256, B = 2, and K7 at N = 600, B = 1.  Returns ({"n_max_64":
    ..., "n_max_128": ..., "n_256_b_2": ..., "n_600_b_1": ...} kernel
    results, {run name: launch counts})."""
    from moleculesde_tpu_torch.benchmarks.profile_pretrain import (
        COMMON_ARGS, parse_path, path_batches)
    from moleculesde_tpu_torch.examples import pretrain as cli

    results, launches = {}, {}
    for n_max, extra in ((64, []), (128, ["--batch_size", "32"])):
        label = f"n_max {n_max}"
        args = parse_path(COMMON_ARGS + ["--n_max", str(n_max)] + extra, batches=4)
        batches = path_batches(args, dev)
        cfg, models, optimizer, gen = cli.setup(args, dev)
        check(cfg.schnet_cfconv == "auto" and args.ingest == "compact",
              f"the {label} steps are not on the CLI's default path")
        res = large_n_kernel_phases(models, batches[0], label)
        res.update(large_n_gin_pair_phases(models, batches[0], label))
        if n_max == 128:
            res.update(bank_large_n_phases(dev, n_max, args.batch_size))
        results[f"n_max_{n_max}"] = res
        counts, leaf_tol = large_n_steps(dev, args, cfg, models, optimizer, gen, batches,
                                         label, args.seed + 7)
        launches[f"pretrain_n_max_{n_max}_2_steps"] = counts
        for form, counts in bank_training_steps(dev, args, cfg, models, batches, leaf_tol,
                                                label=label + " ", profile=True).items():
            launches[f"pretrain_n_max_{n_max}_{form}_bank_2_steps"] = counts
        del models, optimizer, batches
    results["n_256_b_2"] = pair_fwd_n256_phases(dev)
    results["n_256_b_2"].update(bank_n256_phases(dev))
    results["n_600_b_1"] = k7_n600_phases(dev)
    return results, launches


def microbatch_steps(dev):
    """Phase 11: B=256 in two chunks of 128 on the compact K5 path, two
    steps per scope (the second timed), launch counts per step: "step" K1
    10 / 10, K5 12 / 12, K3 2 / 2; "score" and "splice" (one code path) K1
    5 / 5, K5 6 / 6, K3 2 / 2.  Returns {scope: launch counts}."""
    import argparse

    from moleculesde_tpu_torch.benchmarks.profile_pretrain import (
        COMPACT_ARGS, parse_path, path_batches)
    from moleculesde_tpu_torch.examples import pretrain as cli
    from moleculesde_tpu_torch.pretrain.train_step import METRICS, SCOPES, pretrain_step

    base = parse_path(COMPACT_ARGS + ["--batch_size", "256", "--microbatch", "128"], batches=2)
    batches = path_batches(base, dev)
    layers, inters = base.num_layer, base.SchNet_num_interactions
    per_step = {
        "step": dict(gin_messages=2 * layers, gin_messages_bwd=2 * layers,
                     fused_cfconv_rbf=2 * inters, fused_cfconv_rbf_bwd=2 * inters,
                     pair_relu_project=2, pair_relu_project_bwd=2),
        "score": dict(gin_messages=layers, gin_messages_bwd=layers, fused_cfconv_rbf=inters,
                      fused_cfconv_rbf_bwd=inters, pair_relu_project=2,
                      pair_relu_project_bwd=2)}
    per_step["splice"] = per_step["score"]
    launches = {}
    for scope in SCOPES:
        args = argparse.Namespace(**{**vars(base), "microbatch_scope": scope})
        cfg, models, optimizer, gen = cli.setup(args, dev)
        reset_counts()
        times = []
        for b in batches:
            t0 = time.perf_counter()
            metrics = pretrain_step(models, optimizer, cfg, b, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            vals = {k: float(metrics[k]) for k in METRICS}
            check(all(math.isfinite(v) for v in vals.values()), f"non-finite metrics {vals}")
        launches[scope] = read_counts()
        expected = expect(**{k: len(batches) * v for k, v in per_step[scope].items()})
        print(f"microbatch {scope}: B=256 in 2 chunks, launches over {len(batches)} steps "
              f"{launches[scope]} (expected {expected}); step_ms={times[0]:.2f} (first step "
              f"of a new build), {times[1]:.2f}", flush=True)
        check(launches[scope] == expected, f"microbatch {scope} launch counts")

    return launches


def painn_steps(dev):
    """Phase 12: two steps with ``--model_3d PaiNN`` at full width (emb 300,
    3 interactions, 20 radial functions) on the compact path: launches K1 5
    / 5 and K3 1 / 1 per step, no CFConv kernel; every metric finite.
    Returns the launch counts."""
    from moleculesde_tpu_torch.benchmarks.profile_pretrain import (
        COMMON_ARGS, parse_path, path_batches)
    from moleculesde_tpu_torch.examples import pretrain as cli
    from moleculesde_tpu_torch.pretrain.train_step import METRICS, pretrain_step

    args = parse_path(COMMON_ARGS + ["--model_3d", "PaiNN"], batches=2)
    batches = path_batches(args, dev)
    cfg, models, optimizer, gen = cli.setup(args, dev)
    steps = 2
    reset_counts()
    times = []
    for batch in batches[:steps]:
        t0 = time.perf_counter()
        metrics = pretrain_step(models, optimizer, cfg, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(metrics[k]) for k in METRICS}
        check(all(math.isfinite(v) for v in vals.values()), f"PaiNN non-finite metrics {vals}")
    launches = read_counts()
    expected = expect(gin_messages=steps * cfg.num_layer, gin_messages_bwd=steps * cfg.num_layer,
                      pair_relu_project=steps, pair_relu_project_bwd=steps)
    print(f"PaiNN training: B={args.batch_size}, emb {cfg.emb_dim}, "
          f"{cfg.painn_n_interactions} interactions, {cfg.painn_n_rbf} RBF; launches "
          f"{launches} (expected {expected}); step_ms={times[0]:.2f}, {times[1]:.2f} (first "
          f"steps of a new build)", flush=True)
    check(launches == expected, "PaiNN training launch counts")
    return launches


def native_collation_phase(card: str):
    """Phase 14.1: the port's C++ collator against its numpy collation on
    one B=128, n_max 32 batch of the padded path's synthetic molecules (the
    host graphs of phase 7), bit for bit; host ms per batch of each, median
    of 20 after 3, printed with the card's name and power limit."""
    import statistics

    from moleculesde_tpu_torch.benchmarks.profile_pretrain import PATH_ARGS, parse_path
    from moleculesde_tpu_torch.core.batch import pad_graphs
    from moleculesde_tpu_torch.data.native_collate import native_pad_graphs
    from moleculesde_tpu_torch.examples import pretrain as cli

    args = parse_path(PATH_ARGS, batches=1)
    graphs = cli.load_graphs(args)[:args.batch_size]
    kw = dict(n_max=args.n_max, e_max=args.e_max_factor * args.n_max,
              ext_e_max=args.n_max * args.n_max, num_graphs=args.batch_size)
    mine, ref = native_pad_graphs(graphs, **kw), pad_graphs(graphs, **kw)
    for f in dataclasses.fields(ref):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        check(torch.equal(a, b) if torch.is_tensor(b) else a == b,
              f"native collation: {f.name} differs from the numpy collation")
    times = {}
    for name, fn in (("native", native_pad_graphs), ("numpy", pad_graphs)):
        for _ in range(3):
            fn(graphs, **kw)
        runs = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn(graphs, **kw)
            runs.append((time.perf_counter() - t0) * 1e3)
        times[name] = statistics.median(runs)
    print(f"native collation: B={args.batch_size}, n_max {args.n_max}, bit for bit with the "
          f"numpy collation; host ms per batch native {times['native']:.4f} numpy "
          f"{times['numpy']:.4f} (median of 20; {card})", flush=True)
    return times


def _states_equal(a, b, what: str) -> None:
    """Every weight, buffer and Adam state tensor of two (models, optimizer)
    pairs equal bit for bit."""
    (ma, oa), (mb, ob) = a, b
    for comp in ma:
        for (k, u), (k2, v) in zip(ma[comp].state_dict().items(),
                                   mb[comp].state_dict().items()):
            check(k == k2 and torch.equal(u, v), f"{what}: {comp}.{k} differs")
    sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
    check(sa.keys() == sb.keys(), f"{what}: Adam holds state for other parameters")
    for i in sa:
        for k in sa[i]:
            check(torch.equal(sa[i][k].cpu(), sb[i][k].cpu()), f"{what}: Adam {k} of {i} differs")


# phase 14's run: the JAX CLI's defaults plus these
BUCKET_FLAGS = ["--n_max", "128", "--buckets", "16", "32", "64", "128", "--batch_size", "32",
                "--dataset", "synthetic", "--synthetic_molecules", "512", "--epochs", "1"]


def _without(flags, name: str) -> list:
    """``flags`` without the flag ``name`` and its values."""
    out, skip = [], False
    for f in flags:
        if f.startswith("--"):
            skip = f == name
        if not skip:
            out.append(f)
    return out


def bucketed_cli_path(dev, card: str):
    """Phase 14: native collation (14.1); the pretraining CLI's ``main`` at
    the JAX CLI's defaults plus ``--n_max 128 --buckets 16 32 64 128
    --batch_size 32 --synthetic_molecules 512 --epochs 1`` with its outputs
    in a temporary directory, the counts set to 0 just before and read just
    after, every step K1 5 / 5, K2 6 / 6, K3 1 / 1, its batches per bucket,
    every metric finite, ``metrics.csv`` and ``train_state.pt`` written
    (14.2); on the 16-atom bucket's first batch K1, K2, K3 and K4 forward
    and backward against their plain versions on the step's operands (bf16
    and f32, phase 7's bars, two runs bit for bit), K7 / K8 at N = 16, B =
    32 on seeded operands (phase 6's bars) and one f32 step against an
    all-plain f32 build (14.3; the bf16 step's differences printed); the
    run's ``train_state.pt`` loaded into a fresh ``create_pretrain_state``,
    one step on that batch by it and by the run's own state, bit for bit
    (14.4); one epoch of the same
    molecules at ``--n_max 128`` without and with buckets, in turns,
    molecules/s (14.5).  Returns (kernel results, the run's launch counts,
    {"collate_ms": ..., "molecules_per_s": ...})."""
    import collections
    import os
    import tempfile

    from moleculesde_tpu_torch.data.loader import device_prefetch
    from moleculesde_tpu_torch.examples import pretrain as cli
    from moleculesde_tpu_torch.pretrain.train_state import build_models, create_pretrain_state
    from moleculesde_tpu_torch.pretrain.train_step import METRICS
    from moleculesde_tpu_torch.utils.checkpoints import load_train_state

    collate_ms = native_collation_phase(card)
    flags = BUCKET_FLAGS
    steps, real_step = [], cli.pretrain_step

    def recorded_step(models, optimizer, cfg, batch, generator, *rest):
        before = read_counts()
        out = real_step(models, optimizer, cfg, batch, generator, *rest)
        after = read_counts()
        steps.append({"n_max": batch.n_max, "batch": batch, "metrics": out,
                      "counts": {k: after[k] - before[k] for k in after},
                      "state": (models, optimizer, generator, cfg)})
        return out

    with tempfile.TemporaryDirectory() as out_dir:
        cli.pretrain_step = recorded_step
        try:
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            history = cli.main(flags + ["--output_model_dir", out_dir])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
        finally:
            cli.pretrain_step = real_step
        args = cli.get_parser().parse_args(flags)
        models, optimizer, gen, cfg = steps[-1]["state"]
        per_bucket = collections.Counter(st["n_max"] for st in steps)
        per_step = expect(gin_messages=cfg.num_layer, gin_messages_bwd=cfg.num_layer,
                          fused_cfconv=cfg.schnet_num_interactions,
                          fused_cfconv_bwd=cfg.schnet_num_interactions,
                          pair_relu_project=1, pair_relu_project_bwd=1)
        print(f"bucketed CLI run: {len(steps)} steps in {wall:.2f} s (first steps of each "
              f"shape included), batches per bucket {dict(sorted(per_bucket.items()))}; "
              f"launches {launches}", flush=True)
        check(sorted(per_bucket) == sorted(args.buckets), f"buckets run {sorted(per_bucket)}")
        check(all(st["counts"] == per_step for st in steps), "bucketed CLI run: a step's "
              f"launch counts differ from {per_step}")
        check(launches == {k: v * len(steps) for k, v in per_step.items()},
              f"bucketed CLI run launch counts {launches}")
        for st in steps:
            vals = {k: float(st["metrics"][k]) for k in METRICS}
            check(all(math.isfinite(v) for v in vals.values()),
                  f"bucketed CLI run, n_max {st['n_max']}: non-finite metrics {vals}")
        check(all(math.isfinite(v) for h in history for v in h.values()), "non-finite epoch")
        for name in ("metrics.csv", "train_state.pt", "model_complete_final.pt"):
            check(os.path.exists(os.path.join(out_dir, name)), f"the CLI wrote no {name}")
        with open(os.path.join(out_dir, "metrics.csv")) as f:
            rows = f.read().splitlines()
        check(rows[0] == "step,wall_time,CL_loss,CL_acc,SDE_loss_2Dto3D,SDE_loss_3Dto2D"
              and len(rows) == 2, f"metrics.csv holds {rows}")

        # 14.3: n_max 16 on the card, on the run's weights
        batch16 = next(st["batch"] for st in steps if st["n_max"] == 16)
        with torch.no_grad():
            k1, k2, k3 = training_operands(models, batch16)
        results = training_kernel_phases(k1, k2, k3, label="n_max 16")
        ea, env, *params = k2
        g2 = torch.randn(params[0].shape, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(7))
        with torch.no_grad():
            same_bits("n_max 16 K2 forward", lambda: fused_cfconv(ea, env, *params, bf16=True,
                                                                   impl="kernel"))
            same_bits("n_max 16 K2 backward", lambda: fused_cfconv_bwd(
                ea, env, *params, g2, bf16=True, impl="kernel"))
        results.update(bank_seeded_phases(dev, args.batch_size, 16, 23, "[n16]"))
        saved = [c.launches for c in _counters()]
        # the step against plain in f32, with 7's bars: in bf16 the 3D->2D
        # model, which runs no kernel, moves its gradient norm past the bf16
        # bar of 1e-3 at n_max 16 from one-ulp differences in SchNet's output
        # (K2 against its plain version), where the f32 step agrees to ~1e-6.
        # The bf16 step's differences are printed at three seeds, with no bar
        cfg32 = dataclasses.replace(cfg, train_precision="float32")
        models32 = build_models(cfg32, dev)
        for name, m in models32.items():
            m.load_state_dict(models[name].state_dict())
        step_against_plain(dev, cfg32, models32, batch16, args.seed + 8, "n_max 16 bucket f32")
        del models32
        for seed in range(args.seed + 8, args.seed + 11):
            (mk, gk, _), (mp, gp, _) = step_pair(dev, cfg, models, batch16, seed)
            print(f"n_max 16 bucket bf16 vs plain step, seed {seed} (no bar): " + ", ".join(
                [f"{k} rel {abs(mk[k] - mp[k]) / max(1e-6, abs(mp[k])):.2e}" for k in METRICS]
                + [f"|grad {k}| rel {abs(gk[k] - gp[k]) / max(1e-12, gp[k]):.2e}"
                   for k in gk]), flush=True)

        # 14.4: resume from the run's train_state.pt, one step each, bit for bit
        fresh = create_pretrain_state(cfg, dev, args.seed + 1)
        fresh, extra = load_train_state(os.path.join(out_dir, "train_state.pt"), fresh)
        check(fresh.step == len(steps) and extra == {"epoch": 1},
              f"train_state.pt: step {fresh.step}, extra {extra}")
        _states_equal((models, optimizer), (fresh.models, fresh.optimizer), "resumed state")
        check(torch.equal(gen.get_state(), fresh.generator.get_state()),
              "resumed state: the step generator differs")
        real_step(models, optimizer, cfg, batch16, gen)
        real_step(fresh.models, fresh.optimizer, cfg, batch16, fresh.generator)
        torch.cuda.synchronize()
        _states_equal((models, optimizer), (fresh.models, fresh.optimizer),
                      "a step after the resume")
        print("resume: train_state.pt loaded into a fresh create_pretrain_state; one step "
              "on the n_max 16 batch by it and by the run's own state: every weight, buffer "
              "and Adam moment bit for bit", flush=True)
        del fresh

    # 14.5: one epoch of the same molecules without and with buckets, in turns
    graphs = cli.load_graphs(args)
    one = cli.get_parser().parse_args(_without(flags, "--buckets"))
    loaders = {"one padding": cli.make_loader(graphs, one),
               "buckets": cli.make_loader(graphs, args)}
    state = create_pretrain_state(cfg, dev, args.seed)
    rates = {name: [] for name in loaders}
    for name in ("one padding", "buckets", "buckets", "one padding"):
        torch.cuda.synchronize()
        t0, molecules = time.perf_counter(), 0
        for batch, n_real in device_prefetch(loaders[name], dev):
            real_step(state.models, state.optimizer, cfg, batch, state.generator)
            molecules += n_real
        torch.cuda.synchronize()
        rates[name].append(molecules / (time.perf_counter() - t0))
        kind = f"{one.ingest} batches" if name == "one padding" else "padded batches"
        print(f"epoch of {len(graphs)} molecules, {name} ({kind}): {molecules} trained, "
              f"molecules_per_s={rates[name][-1]:.2f}", flush=True)
    for c, k in zip(_counters(), saved):
        c.launches = k
    print(f"buckets against one padding at n_max {args.n_max}, B={args.batch_size} ({card}): "
          + ", ".join(f"{k} molecules_per_s {v[0]:.2f} / {v[1]:.2f}" for k, v in rates.items()),
          flush=True)
    return results, launches, {"collate_ms_per_batch": collate_ms,
                               "molecules_per_s": rates, "batches_per_bucket": dict(per_bucket)}


# phase 15's runs: the finetune CLIs at their defaults on synthetic data, cut
# in data and epochs only
FINETUNE_FLAGS = {
    "moleculenet": ["--dataset", "synthetic", "--synthetic_molecules", "512", "--epochs", "2"],
    "qm9": ["--dataset", "synthetic", "--synthetic_molecules", "512", "--split", "random",
            "--epochs", "2"],
    "md17": ["--dataset", "synthetic", "--synthetic_molecules", "512", "--batch_size", "32",
             "--epochs", "2"]}


def _recorded_cli(cli, step_name: str, eval_name: str):
    """Wrap the CLI module's step and evaluation functions so that each call
    records its launch counts (and the step its model and batch); returns
    (records, restore)."""
    records = {"steps": [], "evals": []}
    originals = {name: getattr(cli, name) for name in (step_name, eval_name)}

    def wrap(name, kind):
        def run(model, *rest, **kw):
            before = read_counts()
            out = originals[name](model, *rest, **kw)
            after = read_counts()
            records[kind].append({"counts": {k: after[k] - before[k] for k in after},
                                  "model": model, "batch": rest[1] if kind == "steps"
                                  else rest[0]})
            return out
        return run

    setattr(cli, step_name, wrap(step_name, "steps"))
    setattr(cli, eval_name, wrap(eval_name, "evals"))

    def restore():
        for name, fn in originals.items():
            setattr(cli, name, fn)
    return records, restore


def _finetune_run(cli, flags, step_name, eval_name, out_dir):
    """``cli.main`` with the launch counts set to 0 just before and read just
    after; returns (result, launches, records, wall s)."""
    records, restore = _recorded_cli(cli, step_name, eval_name)
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        result = cli.main(flags + ["--output_model_dir", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        restore()
    return result, launches, records, wall


def _check_finetune_counts(label, launches, records, per_step, per_eval):
    check(records["steps"] and records["evals"], f"{label}: no step or no evaluation ran")
    check(all(r["counts"] == per_step for r in records["steps"]),
          f"{label}: a step's launch counts differ from {per_step}")
    check(all(r["counts"] == per_eval for r in records["evals"]),
          f"{label}: an evaluation batch's launch counts differ from {per_eval}")
    total = {k: per_step[k] * len(records["steps"]) + per_eval[k] * len(records["evals"])
             for k in per_step}
    check(launches == total, f"{label}: launch counts {launches}, expected {total}")
    print(f"{label}: {len(records['steps'])} steps, {len(records['evals'])} evaluation "
          f"batches; launches {({k: v for k, v in launches.items() if v})} (per step "
          f"{({k: v for k, v in per_step.items() if v})}, per evaluation batch "
          f"{({k: v for k, v in per_eval.items() if v})})", flush=True)


def _grad_norms_by_child(model):
    return {name: torch.sqrt(sum((p.grad.double() ** 2).sum() for p in m.parameters()
                                 if p.grad is not None)).item()
            for name, m in model.named_children()}


def finetune_step_against_plain(label, model, plain, loss_of, tol: float = 1e-4):
    """One f32 finetune step's loss and per-component gradient norms on
    ``model`` (kernels) and ``plain`` (an all-plain build of the same
    weights and statistics; dropout from the same seed); the models' state
    and the launch counts are left as they were."""
    plain.load_state_dict(model.state_dict())
    saved_counts = [c.launches for c in _counters()]
    out = {}
    for kind, m in (("kernel", model), ("plain", plain)):
        saved = {k: v.clone() for k, v in m.state_dict().items()}
        m.zero_grad(set_to_none=True)
        loss = loss_of(m)
        loss.backward()
        out[kind] = (loss.item(), _grad_norms_by_child(m))
        m.load_state_dict(saved)
        m.zero_grad(set_to_none=True)
    for c, n in zip(_counters(), saved_counts):
        c.launches = n
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    err = abs(lk - lp) / max(1e-6, abs(lp))
    print(f"{label} vs plain step (f32): loss {lk:.6f} vs {lp:.6f} rel {err:.2e} "
          f"(tolerance {tol:g})", flush=True)
    check(err <= tol, f"{label}: the loss disagrees with the all-plain step")
    for name in gk:
        err = abs(gk[name] - gp[name]) / max(1e-12, gp[name])
        print(f"{label} vs plain step (f32): |grad {name}| {gk[name]:.6e} vs {gp[name]:.6e} "
              f"rel {err:.2e} (tolerance {tol:g})", flush=True)
        check(err <= tol, f"{label}: gradient norm of {name} disagrees with the all-plain step")


def finetune_kernel_phases(label, k1=None, k2=None):
    """K1 (GIN layer 0's operands) or K2 (SchNet interaction 0's) forward
    and backward against their plain versions in f32, phase 7's f32 bar
    (1e-4), then two runs of each direction bit for bit."""
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(7)
    if k1 is not None:
        x, src, dst, boh, table = k1
        g1 = torch.randn(x.shape, generator=gen, device=x.device)
        print(f"{label} K1 operands: x {tuple(x.shape)}, edges {tuple(src.shape)} "
              f"({int(((dst >= 0) & (dst < x.shape[1])).sum())} valid)", flush=True)
        results["gin_messages"], results["gin_messages_bwd"] = grad_phase(
            f"{label} K1 gin_messages[f32]",
            lambda x_, t_, **kw: gin_messages(x_, src, dst, boh, t_, **kw),
            lambda x_, t_, g_, **kw: gin_messages_bwd(x_, src, dst, boh, t_, g_, **kw),
            lambda x_, t_, g_, **kw: gin_messages_bwd_plain(x_, src, dst, boh, t_, g_, **kw),
            (x, table), g1, False, 1e-4, k1_cost(x, src, dst, table),
            k1_cost(x, src, dst, table, bwd=True), PEAK_F32_FLOPS)
        with torch.no_grad():
            same_bits(f"{label} K1 forward", lambda: gin_messages(x, src, dst, boh, table,
                                                                 impl="kernel"))
            same_bits(f"{label} K1 backward", lambda: gin_messages_bwd(
                x, src, dst, boh, table, g1, impl="kernel"))
    if k2 is not None:
        ea, env, x2, w1, b1, w2, b2 = k2
        g2 = torch.randn(x2.shape, generator=gen, device=x2.device)
        print(f"{label} K2 operands: ea {tuple(ea.shape)} {ea.dtype}, x {tuple(x2.shape)} "
              f"({int((env != 0).sum())} pairs in the cutoff)", flush=True)
        results["fused_cfconv"], results["fused_cfconv_bwd"] = grad_phase(
            f"{label} K2 fused_cfconv[f32]",
            lambda *t_, **kw: fused_cfconv(ea, env, *t_, **kw),
            lambda *t_, **kw: fused_cfconv_bwd(ea, env, *t_, **kw),
            lambda *t_, **kw: fused_cfconv_bwd_plain(ea, env, *t_, **kw),
            (x2, w1, b1, w2, b2), g2, False, 1e-4, k2_cost(ea, env, x2, w1),
            k2_cost(ea, env, x2, w1, bwd=True), PEAK_F32_FLOPS)
        with torch.no_grad():
            same_bits(f"{label} K2 forward", lambda: fused_cfconv(ea, env, x2, w1, b1, w2, b2,
                                                                 impl="kernel"))
            same_bits(f"{label} K2 backward", lambda: fused_cfconv_bwd(
                ea, env, x2, w1, b1, w2, b2, g2, impl="kernel"))
    return results


def _epochs_in_turns(label, card, run_epoch, molecules: int):
    """Two training epochs timed on the host clock (synchronized); prints
    molecules/s of each."""
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_epoch()
        torch.cuda.synchronize()
        rates.append(molecules / (time.perf_counter() - t0))
    print(f"{label}: training epoch of {molecules} molecules, molecules_per_s "
          f"{rates[0]:.2f} / {rates[1]:.2f} ({card})", flush=True)
    return rates


def _metrics_rows(out_dir):
    import csv
    import os

    with open(os.path.join(out_dir, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def moleculenet_finetune(dev, card, out_dir):
    """15.1: returns (K1 results, launches, molecules/s)."""
    import os

    from moleculesde_tpu_torch.examples import finetune_moleculenet as cli
    from moleculesde_tpu_torch.finetune.classification import classification_loss

    flags = FINETUNE_FLAGS["moleculenet"]
    (best_val, best_test), launches, rec, wall = _finetune_run(
        cli, flags, "classification_step", "classification_eval", out_dir)
    args = cli.parse_args(flags)
    _check_finetune_counts("MoleculeNet finetune", launches, rec,
                           expect(gin_messages=args.num_layer,
                                  gin_messages_bwd=args.num_layer),
                           expect(gin_messages=args.num_layer))
    rows = _metrics_rows(out_dir)
    aucs = [float(r[k]) for r in rows for k in ("train_auc", "val_auc", "test_auc")]
    check(len(rows) == args.epochs and all(math.isfinite(float(r["loss"])) for r in rows),
          f"MoleculeNet metrics.csv {rows}")
    check(all(0.0 <= a <= 1.0 for a in aucs + [best_val, best_test]), f"AUCs {aucs}")
    for name in ("model_complete.pt", "model_complete_final.pt", "evaluation_best.npz"):
        check(os.path.exists(os.path.join(out_dir, name)), f"MoleculeNet CLI wrote no {name}")
    print(f"MoleculeNet finetune CLI (GIN {args.num_layer} x {args.emb_dim}, dropout "
          f"{args.dropout_ratio}, {args.graph_pooling} pool, B={args.batch_size}, n_max "
          f"{args.n_max}): {wall:.2f} s; best val AUC {best_val:.4f}, test {best_test:.4f}",
          flush=True)

    model, batch = rec["steps"][0]["model"], rec["steps"][0]["batch"]
    with torch.no_grad():
        x0 = model.gnn.AtomEncoder_0(batch.atom_feats)
        k1 = tuple(t.detach() for t in model.gnn.GINConv_0.message_inputs(x0, batch))
    results = finetune_kernel_phases("MoleculeNet", k1=k1)
    plain = cli.build_model(args, model.graph_pred_linear.kernel.shape[1], dev,
                            msg_impl="plain")
    gm = torch.ones(batch.num_graphs, dtype=torch.bool, device=dev)
    finetune_step_against_plain(
        "MoleculeNet", model, plain, lambda m: classification_loss(
            m, batch, gm, torch.Generator(device=dev).manual_seed(args.seed + 1)))
    del plain

    graphs, num_tasks, (train_idx, _, _) = cli.load_data(args)
    loader = cli.make_loader(graphs, train_idx, args, args.n_max, True, num_tasks=num_tasks)
    optimizer = cli.make_optimizer(model, args.lr, args.decay)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    sched = lambda step: args.lr  # noqa: E731
    rates = _epochs_in_turns("MoleculeNet finetune", card, lambda: cli.train_epoch(
        model, optimizer, loader, dev, sched, 0, gen), len(loader) * args.batch_size)
    return results, launches, rates


def qm9_finetune(dev, card, out_dir):
    """15.2: returns (K2 results, launches, molecules/s)."""
    import os

    from moleculesde_tpu_torch.examples import finetune_qm9 as cli
    from moleculesde_tpu_torch.finetune.regression import regression_loss

    flags = FINETUNE_FLAGS["qm9"]
    (best_val, best_test), launches, rec, wall = _finetune_run(
        cli, flags, "regression_step", "regression_eval", out_dir)
    args = cli.parse_args(flags)
    n = args.SchNet_num_interactions
    _check_finetune_counts("QM9 finetune", launches, rec,
                           expect(fused_cfconv=n, fused_cfconv_bwd=n), expect(fused_cfconv=n))
    rows = _metrics_rows(out_dir)
    check(len(rows) == args.epochs and all(math.isfinite(float(r[k])) for r in rows
                                           for k in ("loss", "val_mae", "test_mae"))
          and math.isfinite(best_val) and math.isfinite(best_test),
          f"QM9 metrics.csv {rows}")
    for name in ("model_complete.pt", "model_complete_final.pt", "evaluation_best.npz"):
        check(os.path.exists(os.path.join(out_dir, name)), f"QM9 CLI wrote no {name}")
    print(f"QM9 finetune CLI (SchNet {n} x {args.SchNet_num_filters} x "
          f"{args.SchNet_num_gaussians}, hidden {args.emb_dim}, B={args.batch_size}, n_max "
          f"{args.n_max}, split {args.split}): {wall:.2f} s; best val MAE {best_val:.4f}, "
          f"test {best_test:.4f}", flush=True)

    model, batch = rec["steps"][0]["model"], rec["steps"][0]["batch"]
    enc = model.encoder
    with torch.no_grad():
        b, nm = batch.num_graphs, batch.n_max
        ea, cos_env, pair_mask, _ = enc.geometry(batch.positions, batch.node_mask, b, nm)
        inter = enc.SchNetInteraction_0
        h0 = enc.Embed_0.embedding[batch.atomic_numbers.long()].reshape(b, nm, -1)
        k2 = tuple(t.detach().contiguous() for t in (
            ea, cos_env * pair_mask.to(cos_env.dtype), inter.Dense_2(h0).float(),
            inter.Dense_0.kernel, inter.Dense_0.bias, inter.Dense_1.kernel,
            inter.Dense_1.bias))
    results = finetune_kernel_phases("QM9", k2=k2)
    plain = cli.build_model(args, dev, impl="plain")
    gm = torch.ones(batch.num_graphs, dtype=torch.bool, device=dev)
    finetune_step_against_plain("QM9", model, plain, lambda m: regression_loss(
        m, batch, batch.y[:, 0], gm, args.loss))
    del plain

    graphs = cli.load_data(args)
    train_idx = cli.split(args, len(graphs))[0]
    loader = cli.make_loader(graphs, train_idx, args, args.n_max, True, num_tasks=1)
    optimizer = cli.make_optimizer(model, args.lr, args.decay)
    rates = _epochs_in_turns("QM9 finetune", card, lambda: cli.train_epoch(
        model, optimizer, loader, dev, lambda step: args.lr, 0, 0.0, 1.0, args.loss),
        len(loader) * args.batch_size)
    return results, launches, rates


def md17_finetune(dev, card, out_dir, model_3d: str):
    """15.3: the MD17 CLI with ``model_3d``: no kernel launch, forces
    against central differences of the energy in f64; returns (launches,
    molecules/s)."""
    import copy
    import os

    from moleculesde_tpu_torch.examples import finetune_md17 as cli
    from moleculesde_tpu_torch.finetune.md17 import energy_and_forces

    flags = FINETUNE_FLAGS["md17"] + ["--model_3d", model_3d]
    (e_mae, f_mae), launches, rec, wall = _finetune_run(cli, flags, "md17_step", "md17_eval",
                                                        out_dir)
    args = cli.parse_args(flags)
    label = f"MD17 finetune ({model_3d})"
    _check_finetune_counts(label, launches, rec, expect(), expect())
    rows = _metrics_rows(out_dir)
    check(len(rows) == args.epochs and all(math.isfinite(float(v)) for r in rows
                                           for k, v in r.items() if k != "step")
          and math.isfinite(e_mae) and math.isfinite(f_mae), f"{label} metrics.csv {rows}")
    print(f"{label} CLI (emb {args.emb_dim}, B={args.batch_size}): {wall:.2f} s; best test "
          f"E MAE {e_mae:.4f}, F MAE {f_mae:.4f}", flush=True)

    # -dE/dpos against central differences of E, in f64, on three coordinates
    model, batch = rec["steps"][0]["model"], rec["steps"][0]["batch"]
    m64 = copy.deepcopy(model).double()
    b64 = dataclasses.replace(batch, positions=batch.positions.double())
    _, forces = energy_and_forces(m64, b64, create_graph=False)
    h, worst = 1e-4, 0.0
    real = torch.nonzero(b64.node_mask).flatten().tolist()
    for atom, axis in ((real[0], 0), (real[len(real) // 2], 1), (real[-1], 2)):
        shifted = []
        for sign in (1.0, -1.0):
            pos = b64.positions.clone()
            pos[atom, axis] += sign * h
            with torch.no_grad():
                shifted.append(m64(dataclasses.replace(b64, positions=pos)).sum().item())
        fd = -(shifted[0] - shifted[1]) / (2 * h)
        err = abs(forces[atom, axis].item() - fd) / max(1e-3, abs(fd))
        worst = max(worst, err)
        print(f"{label}: atom {atom} axis {axis}: force {forces[atom, axis].item():.8e}, "
              f"central difference {fd:.8e}, rel {err:.2e} (tolerance 1e-5, f64, h {h:g})",
              flush=True)
    check(worst <= 1e-5, f"{label}: forces are not -dE/dpos ({worst:.3e})")
    check(not forces[~b64.node_mask].any(), f"{label}: a padded atom has a force")
    del m64

    graphs = cli.load_data(args)
    train_idx = cli.md17_split(len(graphs), seed=args.seed)[0]
    loader = cli.make_loader(graphs, train_idx, args, args.n_max, True, num_tasks=1,
                             with_forces=True)
    optimizer = cli.make_optimizer(model, args.lr, args.decay)
    saved = [c.launches for c in _counters()]
    rates = _epochs_in_turns(label, card, lambda: cli.train_epoch(
        model, optimizer, loader, dev, lambda step: args.lr, 0, 0.0, 1.0, args),
        len(loader) * args.batch_size)
    check([c.launches for c in _counters()] == saved, f"{label}: a kernel was launched")
    return launches, rates


def pretrain_handoff(dev, out_dir):
    """15.4: the pretraining CLI's model_complete.pt (its defaults, one epoch
    of 128 synthetic molecules) into the MoleculeNet and QM9 CLIs: the
    finetune encoders' parameters equal the checkpoint's components, and
    each CLI runs an epoch from it."""
    import os

    from moleculesde_tpu_torch.convert import load_checkpoint
    from moleculesde_tpu_torch.examples import finetune_moleculenet as mnet
    from moleculesde_tpu_torch.examples import finetune_qm9 as qm9
    from moleculesde_tpu_torch.examples import pretrain

    pre_dir = os.path.join(out_dir, "pretrain")
    pretrain.main(["--dataset", "synthetic", "--synthetic_molecules", "128", "--batch_size", "64",
                   "--epochs", "1",
                   "--output_model_dir", pre_dir])
    path = os.path.join(pre_dir, "model_complete.pt")
    ckpt = load_checkpoint(path)
    for cli, component, small in ((mnet, "model_2D", FINETUNE_FLAGS["moleculenet"]),
                                  (qm9, "model_3D", FINETUNE_FLAGS["qm9"])):
        flags = _without(_without(small, "--synthetic_molecules"), "--epochs") + [
            "--synthetic_molecules", "160", "--epochs", "1", "--input_model_file", path]
        args = cli.parse_args(flags)
        model = cli.build_model(args, 3, dev) if cli is mnet else cli.build_model(args, dev)
        part = model.gnn if cli is mnet else model.encoder
        for name, p in part.named_parameters():
            check(torch.equal(p.detach().cpu(), ckpt[component][name]),
                  f"handoff: {component}.{name} differs from the checkpoint")
        cli.main(flags)
        print(f"pretrain -> finetune handoff: the pretraining CLI's model_complete.pt "
              f"{component} ({sum(1 for _ in part.parameters())} tensors) loaded into the "
              f"{cli.__name__.rsplit('.', 1)[-1]} CLI, every parameter equal; one epoch run",
              flush=True)


def finetune_path(dev, card):
    """Phase 15: returns ({"moleculenet": K1 results, "qm9": K2 results},
    {run: launch counts}, {finetune: molecules/s})."""
    import tempfile

    results, launches, rates = {}, {}, {}
    with tempfile.TemporaryDirectory() as out_dir:
        results["moleculenet"], launches["finetune_moleculenet"], rates["moleculenet"] = \
            moleculenet_finetune(dev, card, out_dir + "/mnet")
        results["qm9"], launches["finetune_qm9"], rates["qm9"] = qm9_finetune(
            dev, card, out_dir + "/qm9")
        for model_3d in ("SchNet", "PaiNN"):
            launches[f"finetune_md17_{model_3d.lower()}"], rates[f"md17_{model_3d.lower()}"] = \
                md17_finetune(dev, card, out_dir + f"/md17_{model_3d}", model_3d)
        pretrain_handoff(dev, out_dir)
    return results, launches, rates


# phase 16's runs: the other 2D->3D score models and 2D encoders
SURFACE_PRETRAIN_FLAGS = ["--SDE_2Dto3D_model", "SDEModel2Dto3D_04", "--JK", "sum"]
SURFACE_GNN_TYPES = ("GCN", "GAT", "GraphSAGE")


def surface_sampler(dev, card, variant: int):
    """16.1 for one variant: the sampler CLI's ``main`` (K1 5, K3 0, K4 0),
    K6 on the fused chain's operands against its plain version (kernel
    variant 1, bf16 and f32), the counted fused chain (K6 40), conformers/s
    of both chains and 5 f32 steps of the fused chain against the
    channel-major chain.  Returns (K6 results, {run: launch counts})."""
    from moleculesde_tpu_torch.benchmarks.profile_sampler import (
        CORRECTOR_STEPS, N_STEPS, PATH_ARGS)
    from moleculesde_tpu_torch.examples import sample_2d_to_3d as cli

    flags = ["--SDE_2Dto3D_model", f"SDEModel2Dto3D_0{variant}"]
    args = cli.get_parser().parse_args(PATH_ARGS + flags)
    runs = {}
    reset_counts()
    cli_results = cli.main(PATH_ARGS + flags)
    torch.cuda.synchronize()
    runs[f"sample_2d_to_3d_v{variant}"] = launches = read_counts()
    print(f"sampler CLI, SDEModel2Dto3D_0{variant}: launches {launches} (expected K1 "
          f"{args.num_layer}, K3 0, K4 0)", flush=True)
    check(launches == expect(gin_messages=args.num_layer),
          f"sampler v{variant} launch counts {launches}")
    for r in cli_results:
        check(r["pos_gen"].shape == (args.num_repeat_SDE_inference,
                                     r["atom_feats"].shape[0], 3), "pos_gen shape")
        check(bool(torch.isfinite(torch.as_tensor(r["pos_gen"])).all()),
              f"v{variant}: non-finite conformer")

    batch = cli.make_batch(cli.load_graphs(args), args, dev)
    model_2d, sde_model = cli.build_models(args, dev)
    check(sde_model.kernel_variant == 1, f"v{variant} runs K6 as variant 1")
    with torch.no_grad():
        node_2d = model_2d(batch, use_running_average=True)
    results = k6_phases({variant: sde_model}, node_2d, batch, dev)

    evals = N_STEPS * (CORRECTOR_STEPS + 1)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    reset_counts()
    pos = cli.generate(model_2d, sde_model, batch, gen, args, fused=True)
    torch.cuda.synchronize()
    runs[f"sample_2d_to_3d_v{variant}_fused"] = launches = read_counts()
    print(f"fused chain, SDEModel2Dto3D_0{variant}: launches {launches} (expected K1 "
          f"{args.num_layer}, K6 {evals})", flush=True)
    check(launches == expect(gin_messages=args.num_layer, score_eval_fused=evals),
          f"fused chain v{variant} launch counts {launches}")
    check(bool(torch.isfinite(pos).all()), f"fused chain v{variant}: non-finite positions")
    check(bool((pos[~batch.node_mask] == 0).all()), f"fused chain v{variant}: padded rows")

    walls = {"channel": [], "fused": []}
    saved = [c.launches for c in _counters()]
    for name in ("channel", "fused", "fused", "channel"):
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.generate(model_2d, sde_model, batch, gen, args, fused=name == "fused")
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    for c, n in zip(_counters(), saved):
        c.launches = n
    b_conf = batch.num_graphs
    for name, ws in walls.items():
        print(f"SDEModel2Dto3D_0{variant} {name} chain (GIN + conditioning + {N_STEPS} PC "
              f"steps, B={b_conf}, bf16): wall_ms={' / '.join(f'{w * 1e3:.2f}' for w in ws)} "
              f"conformers_per_s={' / '.join(f'{b_conf / w:.2f}' for w in ws)} ({card})",
              flush=True)
    fused_f32_steps(dev, flags, 5, f"SDEModel2Dto3D_0{variant}, n_max {batch.n_max}")
    return results, runs


def _finite_metrics(label, metrics):
    from moleculesde_tpu_torch.pretrain.train_step import METRICS

    vals = {k: float(metrics[k]) for k in METRICS}
    check(all(math.isfinite(v) for v in vals.values()), f"{label}: non-finite metrics {vals}")
    return vals


def surface_pretraining(dev, card):
    """16.2: the pretraining CLI's models at its defaults plus
    SURFACE_PRETRAIN_FLAGS, two counted steps (K1 5 / 5, K2 6 / 6, K3 0 / 0
    a step), one step against an all-plain build; then one step with each
    of SURFACE_GNN_TYPES and SDEModel2Dto3D_03 (no K1, K2 6 / 6).  Returns
    {run: launch counts}."""
    from moleculesde_tpu_torch.benchmarks.profile_pretrain import (
        BATCH, COMMON_ARGS, parse_path, path_batches)
    from moleculesde_tpu_torch.examples import pretrain as cli
    from moleculesde_tpu_torch.pretrain.train_step import pretrain_step

    args = parse_path(COMMON_ARGS + SURFACE_PRETRAIN_FLAGS, batches=3)
    batches = path_batches(args, dev)
    cfg, models, optimizer, gen = cli.setup(args, dev)
    runs = {}
    steps = 2
    reset_counts()
    t0 = time.perf_counter()
    history = [pretrain_step(models, optimizer, cfg, b, gen) for b in batches[:steps]]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    runs["pretrain_v4_jk_sum_2_steps"] = launches = read_counts()
    expected = expect(gin_messages=cfg.num_layer, gin_messages_bwd=cfg.num_layer,
                      fused_cfconv=cfg.schnet_num_interactions,
                      fused_cfconv_bwd=cfg.schnet_num_interactions)
    per_step = {k: v / steps for k, v in launches.items()}
    print(f"pretraining, SDEModel2Dto3D_04 + JK sum (compact ingest, B={BATCH}, n_max "
          f"{args.n_max}, bf16): launches per step {per_step} (expected {expected}); "
          f"step_ms={wall:.2f} incl. the first step ({card})", flush=True)
    check(per_step == expected, f"v4 / JK sum launch counts {launches}")
    for i, m in enumerate(history):
        vals = _finite_metrics("v4 / JK sum", m)
        print(f"v4 / JK sum step {i}: " + ", ".join(f"{k}={v:.5f}" for k, v in vals.items()),
              flush=True)
    step_against_plain(dev, cfg, models, batches[steps], args.seed + 1, "v4 / JK sum")
    del models, optimizer

    for gnn_type in SURFACE_GNN_TYPES:
        flags = ["--gnn_type", gnn_type, "--SDE_2Dto3D_model", "SDEModel2Dto3D_03"]
        args_t = parse_path(COMMON_ARGS + flags, batches=3)
        cfg_t, models_t, opt_t, gen_t = cli.setup(args_t, dev)
        check(isinstance(getattr(models_t["model_2D"], f"{gnn_type}Conv_0"), torch.nn.Module),
              f"{gnn_type} encoder built")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = pretrain_step(models_t, opt_t, cfg_t, batches[0], gen_t)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        runs[f"pretrain_{gnn_type.lower()}_v3_1_step"] = launches = read_counts()
        expected = expect(fused_cfconv=cfg_t.schnet_num_interactions,
                          fused_cfconv_bwd=cfg_t.schnet_num_interactions)
        vals = _finite_metrics(gnn_type, metrics)
        print(f"pretraining, --gnn_type {gnn_type} + SDEModel2Dto3D_03: launches {launches} "
              f"(expected {expected}); first step_ms={wall:.2f} ({card}); "
              + ", ".join(f"{k}={v:.5f}" for k, v in vals.items()), flush=True)
        check(launches == expected, f"{gnn_type} / v3 launch counts {launches}")
        del models_t, opt_t
    return runs


def surface_moleculenet(dev, card, out_dir):
    """16.3: the MoleculeNet CLI's ``main`` with ``--JK concat`` (K1 5 / 5 a
    step, 5 per evaluation batch, f32) and with ``--gnn_type GAT`` (no
    kernel), 512 molecules, 1 epoch each, every AUC in [0, 1].  Returns
    {run: launch counts}."""
    from moleculesde_tpu_torch.examples import finetune_moleculenet as cli

    runs = {}
    base = ["--dataset", "synthetic", "--synthetic_molecules", "512", "--epochs", "1"]
    for name, flags in (("jk_concat", ["--JK", "concat"]), ("gat", ["--gnn_type", "GAT"])):
        args = cli.parse_args(base + flags)
        k1 = args.num_layer if args.gnn_type == "GIN" else 0
        (best_val, best_test), launches, rec, wall = _finetune_run(
            cli, base + flags, "classification_step", "classification_eval",
            f"{out_dir}/{name}")
        _check_finetune_counts(f"MoleculeNet {name}", launches, rec,
                               expect(gin_messages=k1, gin_messages_bwd=k1),
                               expect(gin_messages=k1))
        model = rec["steps"][0]["model"]
        check(model.graph_pred_linear.kernel.shape[0] == model.gnn.out_dim,
              f"MoleculeNet {name}: head width")
        rows = _metrics_rows(f"{out_dir}/{name}")
        aucs = [float(r[k]) for r in rows for k in ("train_auc", "val_auc", "test_auc")]
        check(all(0.0 <= a <= 1.0 for a in aucs + [best_val, best_test]),
              f"MoleculeNet {name}: AUCs {aucs}")
        print(f"MoleculeNet CLI {' '.join(flags)} ({args.gnn_type} {args.num_layer} x "
              f"{args.emb_dim}, head {model.gnn.out_dim} wide, B={args.batch_size}): "
              f"{wall:.2f} s; best val AUC {best_val:.4f}, test {best_test:.4f} ({card})",
              flush=True)
        runs[f"finetune_moleculenet_{name}"] = launches
    return runs


def model_surface_path(dev, card):
    """Phase 16: returns (K6 results of variants 3 and 4, {run: launch
    counts})."""
    import tempfile

    results, runs = {}, {}
    for variant in (3, 4):
        res, r = surface_sampler(dev, card, variant)
        results.update(res)
        runs.update(r)
    runs.update(surface_pretraining(dev, card))
    with tempfile.TemporaryDirectory() as out_dir:
        runs.update(surface_moleculenet(dev, card, out_dir))
    return results, runs


# phase 17: the CLIs on a PCQM4Mv2-layout packed cache the script writes
PACKED_MOLECULES = 4096
PACKED_ATOMS = (4, 48)   # some past --n_max 32, so the packed collation clips
PACKED_SAMPLER_END = {"2d_to_3d": 4, "3d_to_2d": 128}


def write_packed_cache(root: str, seed: int):
    """17.1: PACKED_MOLECULES synthetic molecules of 4-48 atoms drawn from
    ``seed`` (the extended graph built on the host, as ``load_pcqm4mv2``
    stores it at the default ``--use_extend_graph``), each with a gap as
    ``y`` [1], packed as ``load_pcqm4mv2`` would cache them under ``root``:
    all of them as ``packed_ext1_n4096`` and, for the samplers' ``--end``,
    the first 4 and 128 as ``packed_ext1_n4`` / ``_n128``.  Returns the
    molecules as dicts and the seconds the write took."""
    import os

    import numpy as np

    from moleculesde_tpu_torch.data.packed import PackedGraphs
    from moleculesde_tpu_torch.data.synthetic import random_molecule

    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(PACKED_MOLECULES):
        g = random_molecule(rng, int(rng.integers(PACKED_ATOMS[0], PACKED_ATOMS[1] + 1)))
        g["y"] = np.array([rng.uniform(1.0, 10.0)], dtype=np.float32)
        graphs.append(g)
    t0 = time.perf_counter()
    for n in (PACKED_MOLECULES, *PACKED_SAMPLER_END.values()):
        PackedGraphs.from_graphs(graphs[:n]).save(os.path.join(root, f"packed_ext1_n{n}"))
    return graphs, time.perf_counter() - t0


def packed_cli_run(label: str, flags, out_dir: str):
    """17.2: the pretraining CLI's ``main`` on ``flags``, the counts set to
    0 just before and read just after: the dataset it loads is the
    memory-mapped ``PackedGraphs`` and every loader holds it or a
    ``PackedSubset`` of it, every step launches K1 5 / 5, K2 6 / 6, K3 1 /
    1, every metric finite, ``model_complete_final.pt`` written.  Returns
    (launch counts, {steps, batches per n_max, wall s})."""
    import collections
    import os

    import numpy as np

    from moleculesde_tpu_torch.data.packed import PackedGraphs, PackedSubset
    from moleculesde_tpu_torch.examples import pretrain as cli

    steps, made = [], []
    real_step, real_make = cli.pretrain_step, cli.make_loader

    def recorded_step(models, optimizer, cfg, batch, generator, *rest):
        before = read_counts()
        out = real_step(models, optimizer, cfg, batch, generator, *rest)
        after = read_counts()
        steps.append({"n_max": batch.n_max, "metrics": out, "cfg": cfg,
                      "counts": {k: after[k] - before[k] for k in after}})
        return out

    def recorded_loader(graphs, args):
        loader = real_make(graphs, args)
        made.append((graphs, loader))
        return loader

    cli.pretrain_step, cli.make_loader = recorded_step, recorded_loader
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        history = cli.main(flags + ["--output_model_dir", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        cli.pretrain_step, cli.make_loader = real_step, real_make
    (graphs, loader), = made
    check(isinstance(graphs, PackedGraphs) and isinstance(graphs.arrays["atom_feats"], np.memmap),
          f"{label}: the CLI loaded {type(graphs).__name__}, not the memory-mapped cache")
    held = [ld.graphs for ld in getattr(loader, "loaders", [loader]) if ld is not None]
    check(all(isinstance(h, (PackedGraphs, PackedSubset)) for h in held),
          f"{label}: a loader holds {[type(h).__name__ for h in held]}")
    cfg = steps[-1]["cfg"]
    per_step = expect(gin_messages=cfg.num_layer, gin_messages_bwd=cfg.num_layer,
                      fused_cfconv=cfg.schnet_num_interactions,
                      fused_cfconv_bwd=cfg.schnet_num_interactions,
                      pair_relu_project=1, pair_relu_project_bwd=1)
    per_n_max = dict(sorted(collections.Counter(st["n_max"] for st in steps).items()))
    print(f"{label}: {len(steps)} steps, batches per n_max {per_n_max}, {wall:.2f} s (first "
          f"steps of each shape included); launches {launches}", flush=True)
    check(all(st["counts"] == per_step for st in steps),
          f"{label}: a step's launch counts differ from {per_step}")
    check(launches == {k: v * len(steps) for k, v in per_step.items()},
          f"{label}: launch counts {launches}")
    for st in steps:
        _finite_metrics(f"{label}, n_max {st['n_max']}", st["metrics"])
    check(all(math.isfinite(v) for h in history for v in h.values()), f"{label}: epoch")
    check(os.path.exists(os.path.join(out_dir, "model_complete_final.pt")),
          f"{label}: no model_complete_final.pt")
    return launches, {"steps": len(steps), "batches_per_n_max": per_n_max, "wall_s": wall}


def packed_collation_phase(dev, card, cache, graphs, cfg, models, seed: int):
    """17.3: one B=128 batch of the cache's molecules of 32 atoms or fewer,
    gathered by ``collate_compact_packed`` off the cache and collated by
    ``collate_compact`` from the same molecules as dicts: every tensor
    equal, and one step's loss terms and gradient norms on each equal bit
    for bit; host ms per batch of each (median of 20 after 3)."""
    import statistics

    import numpy as np

    from moleculesde_tpu_torch.data.compact import collate_compact, collate_compact_packed

    idx = np.flatnonzero(cache.num_atoms <= 32)[:128]
    kw = dict(n_max=32, e_max=128, num_graphs=128)
    dicts = [graphs[i] for i in idx]
    pb, lb = collate_compact_packed(cache, idx, **kw), collate_compact(dicts, **kw)
    for f in dataclasses.fields(lb):
        a, b = getattr(pb, f.name), getattr(lb, f.name)
        check(torch.equal(a, b) if torch.is_tensor(b) else a == b,
              f"packed collation: {f.name} differs from the dicts' collation")
    terms = [one_step(dev, cfg, models, b.to(dev), seed)[:2] for b in (pb, lb)]
    check(terms[0] == terms[1], f"a step on the packed batch {terms[0]} and on the dicts' "
                                f"batch {terms[1]} differ")
    times = {}
    for name, run in (("packed", lambda: collate_compact_packed(cache, idx, **kw)),
                      ("dicts", lambda: collate_compact(dicts, **kw))):
        for _ in range(3):
            run()
        ms = []
        for _ in range(20):
            t0 = time.perf_counter()
            run()
            ms.append((time.perf_counter() - t0) * 1e3)
        times[name] = statistics.median(ms)
    print(f"packed collation: B=128, n_max 32, equal to the dicts' collation in every "
          f"tensor; one step on each, loss terms and gradient norms bit for bit "
          f"({', '.join(f'{k}={v:.6f}' for k, v in terms[0][0].items())}); host ms per "
          f"batch collate_compact_packed {times['packed']:.4f}, collate_compact of dicts "
          f"{times['dicts']:.4f} (median of 20; {card})", flush=True)
    return times


def packed_samplers(dev, data: str, cache):
    """17.5: the 2D->3D sampler CLI's ``main`` on the cache (``--end 4
    --num_repeat_SDE_inference 2``; 20 PC steps, the CLI's, x 1 corrector
    step, its default 100 cut), one chain a molecule, K1 5 and K3 1 a
    chain, finite COV / MAT for each molecule (at the cache's 48 atoms past
    ``--n_max 32``, the default first raises naming ``--n_max`` and the run
    takes ``--n_max 64``); the 3D->2D sampler CLI's ``main`` (``--end
    128``, one B=128 batch, n_max 32, 20 PC x 2 corrector steps, its
    default 100 cut), no kernel, finite graphs.  Returns {run: launch
    counts}."""
    import numpy as np

    from moleculesde_tpu_torch.examples import sample_2d_to_3d as s2d
    from moleculesde_tpu_torch.examples import sample_3d_to_2d as s3d

    end = PACKED_SAMPLER_END["2d_to_3d"]
    flags = ["--dataset", "PCQM4Mv2", "--input_data_dir", data, "--end", str(end),
             "--num_repeat_SDE_inference", "2", "--steps_pos", "1"]
    largest = int(cache.num_atoms[:end].max())
    if largest > 32:
        try:
            s2d.main(flags)
            raised = ""
        except ValueError as e:
            raised = str(e)
        check("--n_max 32" in raised, f"2D->3D sampler at --n_max 32 on a {largest}-atom "
                                      f"molecule: {raised or 'no error'}")
        flags += ["--n_max", "64"]
    args = s2d.get_parser().parse_args(flags)
    runs = {}
    reset_counts()
    t0 = time.perf_counter()
    res = s2d.main(flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs["sample_2d_to_3d_packed"] = launches = read_counts()
    check(launches == expect(gin_messages=args.num_layer * end, pair_relu_project=end),
          f"2D->3D sampler on the cache: launch counts {launches}")
    check(len(res) == end, f"2D->3D sampler on the cache: {len(res)} molecules")
    for i, r in enumerate(res):
        n = int(cache.num_atoms[i])
        check(r["pos_gen"].shape == (2, n, 3) and bool(np.isfinite(r["pos_gen"]).all()),
              f"2D->3D sampler on the cache, molecule {i}: conformers")
        check(0.0 <= r["cov"] <= 1.0 and math.isfinite(r["mat"]),
              f"2D->3D sampler on the cache, molecule {i}: COV {r['cov']} MAT {r['mat']}")
    print(f"2D->3D sampler CLI on the cache (--n_max {args.n_max}, {end} chains of 2 "
          f"conformers, 20 PC x 1 corrector step): {wall:.2f} s, launches {launches}; atoms "
          + ", ".join(f"{len(r['atom_feats'])} COV={r['cov']:.3f} MAT={r['mat']:.3f}"
                      for r in res), flush=True)

    end = PACKED_SAMPLER_END["3d_to_2d"]
    flags = ["--dataset", "PCQM4Mv2", "--input_data_dir", data, "--end", str(end),
             "--steps_pos", "2"]
    reset_counts()
    t0 = time.perf_counter()
    res = s3d.main(flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs["sample_3d_to_2d_packed"] = launches = read_counts()
    check(launches == expect(), f"3D->2D sampler on the cache: launch counts {launches}")
    check(len(res) == 1 and res[0]["x_gen"].shape == (end, 32, 119)
          and bool(np.isfinite(res[0]["x_gen"]).all() and np.isfinite(res[0]["adj_gen"]).all()),
          "3D->2D sampler on the cache: graphs")
    print(f"3D->2D sampler CLI on the cache (B={end}, n_max 32, 20 PC x 2 corrector steps, "
          f"{int((cache.num_atoms[:end] > 32).sum())} molecules cut to 32 atoms): {wall:.2f} "
          f"s, no kernel", flush=True)
    return runs


def packed_path(dev, card):
    """Phase 17: the cache (17.1), the pretraining CLI's ``main`` on it at
    its defaults (``--dataset PCQM4Mv2 --max_molecules 4096 --epochs 1``:
    compact ingest, B=128, n_max 32), with ``--buckets 16 32 64`` and with
    ``--n_max 0`` (17.2), packed against dicts' collation (17.3), the
    cache's load seconds and one epoch of it with and without buckets, in
    turns, molecules/s (17.4), both samplers (17.5).  Returns ({run: launch
    counts}, figures)."""
    import os
    import statistics
    import tempfile

    from moleculesde_tpu_torch.data.loader import device_prefetch
    from moleculesde_tpu_torch.data.packed import PackedGraphs
    from moleculesde_tpu_torch.examples import pretrain as cli
    from moleculesde_tpu_torch.pretrain.train_state import create_pretrain_state

    runs, figures = {}, {}
    with tempfile.TemporaryDirectory() as data:
        root = os.path.join(data, "PCQM4Mv2")
        graphs, write_s = write_packed_cache(root, seed=42)
        cache_dir = os.path.join(root, f"packed_ext1_n{PACKED_MOLECULES}")
        loads = []
        for _ in range(5):
            t0 = time.perf_counter()
            cache = PackedGraphs.load(cache_dir)
            loads.append(time.perf_counter() - t0)
        figures["load_s"] = statistics.median(loads)
        print(f"packed cache: {PACKED_MOLECULES} molecules of {PACKED_ATOMS[0]}-"
              f"{PACKED_ATOMS[1]} atoms ({int((cache.num_atoms > 32).sum())} past 32), "
              f"{cache.nbytes() / 1e6:.2f} MB of flat arrays written in {write_s:.3f} s; "
              f"PackedGraphs.load {figures['load_s']:.6f} s (median of 5, memory-mapped, "
              f"warm; {card})", flush=True)

        base = ["--dataset", "PCQM4Mv2", "--input_data_dir", data, "--max_molecules",
                str(PACKED_MOLECULES), "--epochs", "1"]
        variants = {"pretrain_packed_cli": [], "pretrain_packed_buckets_cli":
                    ["--buckets", "16", "32", "64"], "pretrain_packed_n_max_0_cli":
                    ["--n_max", "0"]}
        figures["cli"] = {}
        for name, extra in variants.items():
            runs[name], figures["cli"][name] = packed_cli_run(
                name, base + extra, os.path.join(data, "out", name))

        args = cli.get_parser().parse_args(base)
        cfg = cli.config_from_args(args)
        state = create_pretrain_state(cfg, dev, args.seed)
        figures["collate_ms_per_batch"] = packed_collation_phase(
            dev, card, cache, graphs, cfg, state.models, args.seed + 17)

        loaders = {"packed": cli.make_loader(cache, args), "buckets": cli.make_loader(
            cache, cli.get_parser().parse_args(base + variants["pretrain_packed_buckets_cli"]))}
        rates = {name: [] for name in loaders}
        for name in ("packed", "buckets", "buckets", "packed"):
            torch.cuda.synchronize()
            t0, molecules = time.perf_counter(), 0
            for batch, n_real in device_prefetch(loaders[name], dev):
                cli.pretrain_step(state.models, state.optimizer, cfg, batch, state.generator)
                molecules += n_real
            torch.cuda.synchronize()
            rates[name].append(molecules / (time.perf_counter() - t0))
            print(f"epoch of the cache, {name}: {molecules} trained, molecules_per_s="
                  f"{rates[name][-1]:.2f}", flush=True)
        figures["molecules_per_s"] = rates
        print(f"packed epochs in turns ({card}): " + ", ".join(
            f"{k} molecules_per_s {v[0]:.2f} / {v[1]:.2f}" for k, v in rates.items()), flush=True)
        del state
        runs.update(packed_samplers(dev, data, cache))
    return runs, figures


# phase 18: data parallelism (parallel/): a 1-rank NCCL group, and two gloo
# ranks that share the card (NCCL refuses two ranks on one device)
DP_DEADLINE_S = 300
# (precision, seed, bar) of the two ranks against one process: loss terms
# and gradient norms relative, running statistics.  Each bar sits between
# the honest reading and the planted faults' (DP_FAULTS), which the phase
# measures and checks on every run.  Readings on an H100 (PERF.md, PR 20):
# bf16 3.9e-3 (model_2D's gradient norm), and the all-plain build 3.7e-3,
# so no kernel makes it; f32 1.4e-6 to 1.5e-5 (seeds 8 and 7), while one
# process, kernels against the all-plain build, moves the BatchNorm-heavy
# GIN's gradient leaves by up to 3.6e-3 in f32 (sums in another order,
# amplified by the BatchNorm backward's cancellation).  The faults read
# 1e-1 to 1 in both.  Both precisions draw from one seed, so the
# one-process bf16 step can be read against the f32 one (printed).
DP_PRECISIONS = (("bfloat16", 7, 1e-2), ("float32", 7, 1e-4))


@contextlib.contextmanager
def local_batch_norm():
    """A planted fault for the bars' witness: every BatchNorm (node and
    pair) takes its statistics from the rank's own graphs, the global sums
    dropped, as a data-parallel run without synchronized BatchNorm does."""
    import types

    from moleculesde_tpu_torch.models import layers
    from moleculesde_tpu_torch.ops import pair_block

    saved = layers.dp, pair_block.dp
    local = types.SimpleNamespace(**{k: getattr(saved[0], k) for k in dir(saved[0])
                                     if not k.startswith("__")})
    local.global_sum = lambda x: x
    layers.dp = pair_block.dp = local
    try:
        yield
    finally:
        layers.dp, pair_block.dp = saved


@contextlib.contextmanager
def summed_grads():
    """A planted fault for the bars' witness: the world-size factor dropped
    (parameter gradients summed over the ranks, not averaged)."""
    from moleculesde_tpu_torch.parallel import collectives as dp

    average = dp.average_grads

    def summed(params):
        params = list(params)
        average(params)
        for p in params:
            if p.grad is not None:
                p.grad.mul_(dp.world_size())

    dp.average_grads = summed
    try:
        yield
    finally:
        dp.average_grads = average


DP_FAULTS = {"BatchNorm statistics per rank": local_batch_norm,
             "gradients summed over the ranks": summed_grads}


def plain_copy(cfg, models, dev):
    """An all-plain build (no kernel) of ``models``' weights and statistics."""
    from moleculesde_tpu_torch.pretrain.train_state import build_models

    plain = build_models(cfg, dev, impl="plain")
    for name in models:
        plain[name].load_state_dict(models[name].state_dict())
    return plain


def dp_setup(dev, precision: str):
    """(cfg, models, optimizer, the first global batch on the host) at the
    pretraining CLI's defaults (compact ingest, K2, B=128, n_max 32) in
    ``precision``, weights from the seed."""
    from moleculesde_tpu_torch.benchmarks.profile_pretrain import COMMON_ARGS, parse_path
    from moleculesde_tpu_torch.examples import pretrain as cli

    args = parse_path(COMMON_ARGS + ["--train_precision", precision], batches=1)
    cfg, models, optimizer, _ = cli.setup(args, dev)
    batch, _ = next(iter(cli.make_loader(cli.load_graphs(args), args)))
    return cfg, models, optimizer, batch


def dp_grads(dev, cfg, models, batch, seed: int):
    """One step's (loss terms, component gradient norms before Adam, running
    statistics) under the active group (gradients averaged over its ranks),
    masks and draws from ``seed``; the models' state is left as it was."""
    from moleculesde_tpu_torch.parallel import collectives as dp
    from moleculesde_tpu_torch.pretrain.train_step import pretrain_grads

    saved = {n: {k: v.clone() for k, v in m.state_dict().items()} for n, m in models.items()}
    for m in models.values():
        m.zero_grad(set_to_none=True)
    metrics = pretrain_grads(models, cfg, batch, torch.Generator(device=dev).manual_seed(seed))
    dp.average_grads(p for m in models.values() for p in m.parameters())
    stats = {f"{c}.{n}": b.detach().float().cpu().clone() for c, m in models.items()
             for n, b in m.named_buffers()}
    stats.update({f"grad {c}.{n}": p.grad.detach().float().cpu().clone()
                  for c, m in models.items() for n, p in m.named_parameters()
                  if p.grad is not None})
    out = ({k: float(v.detach()) for k, v in metrics.items()}, _grad_norms(models), stats)
    for n, m in models.items():
        m.load_state_dict(saved[n])
        m.zero_grad(set_to_none=True)
    return out


def dp_errors(mine, ref) -> dict:
    """Loss terms and gradient norms relative, running statistics relative to
    max(1, their largest value)."""
    from moleculesde_tpu_torch.pretrain.train_step import METRICS

    (mk, gk, sk), (mr, gr, sr) = mine, ref
    errs = {f"loss {k}": abs(mk[k] - mr[k]) / max(1e-6, abs(mr[k])) for k in METRICS}
    errs.update({f"|grad {n}|": abs(gk[n] - gr[n]) / max(1e-12, gr[n]) for n in gr})
    errs.update({f"stat {k}": (sk[k] - v).abs().max().item() / max(1.0, v.abs().max().item())
                 for k, v in sr.items() if not k.startswith("grad ")})
    return errs


def dp_reading(label, mine, ref) -> float:
    """Print the worst values of :func:`dp_errors` and the gradient leaves
    that carry the norm, relative L2 (the biases in front of a BatchNorm
    hold rounding noise, zero in exact arithmetic); returns the worst."""
    _, _, sr = ref
    _, _, sk = mine
    top = max(v.norm().item() for k, v in sr.items() if k.startswith("grad "))
    leaves = {k: ((sk[k] - v).norm() / v.norm()).item() for k, v in sr.items()
              if k.startswith("grad ") and v.norm().item() >= 1e-3 * top}
    print(f"{label}: gradient leaves within 1e-3 of the largest, relative L2, worst "
          + ", ".join(
        f"{k[5:]} {v:.2e} (|g| {sr[k].norm().item():.3e})"
        for k, v in sorted(leaves.items(), key=lambda kv: -kv[1])[:6]), flush=True)
    worst = sorted(dp_errors(mine, ref).items(), key=lambda kv: -kv[1])
    print(f"{label}: {len(worst)} values, worst " + ", ".join(
        f"{k} {v:.2e}" for k, v in worst[:4]), flush=True)
    return worst[0][1]


def dp_against(label, mine, ref, tol: float) -> float:
    """:func:`dp_reading`, each value held to ``tol``; returns the worst."""
    worst = dp_reading(f"{label} (tolerance {tol:g})", mine, ref)
    for k, v in dp_errors(mine, ref).items():
        check(v <= tol, f"{label}: {k} off by {v:.3e}")
    return worst


def dp_chain_args():
    """The sampler CLI's chain of phase 3 (B=64 clones, 20 PC x 1 corrector
    step) in f32."""
    from moleculesde_tpu_torch.benchmarks.profile_sampler import PATH_ARGS
    from moleculesde_tpu_torch.examples import sample_2d_to_3d as s2d

    return s2d.get_parser().parse_args(PATH_ARGS + ["--sampler_precision", "float32"])


def dp_chain(dev):
    """The 2D->3D chain through the sampler CLI's functions (the rank's
    block under a group): (positions, launch counts)."""
    from moleculesde_tpu_torch.examples import sample_2d_to_3d as s2d

    args = dp_chain_args()
    batch = s2d.make_batch(s2d.load_graphs(args), args, dev)
    model_2d, sde_model = s2d.build_models(args, dev)
    reset_counts()
    pos = s2d.generate(model_2d, sde_model, batch, torch.Generator(device=dev).manual_seed(
        args.seed), args)
    torch.cuda.synchronize()
    return pos, read_counts()


def _every_rank(counts: dict) -> list:
    """Each rank's launch counts (gathered from every rank)."""
    from moleculesde_tpu_torch.parallel import collectives as dp

    names = sorted(counts)
    rows = dp.all_gather_rows(torch.tensor([[counts[k] for k in names]]))
    return [dict(zip(names, map(int, row))) for row in rows.tolist()]


def _dp_shared_rank(group, dev):
    """One of two gloo ranks on the card: the step of each precision on the
    rank's block of the global batch (and each rank's launches), the
    bf16 step's and the gradient all-reduce's wall ms, the chain's
    positions (gathered) and launches."""
    from moleculesde_tpu_torch.parallel import collectives as dp
    from moleculesde_tpu_torch.parallel import mesh

    full_f32()   # a spawned process starts with torch's defaults
    out = {}
    for precision, seed, _ in DP_PRECISIONS:
        cfg, models, optimizer, batch = dp_setup(dev, precision)
        block = mesh.rank_block(batch, group.rank, group.world).to(dev)
        reset_counts()
        res = dp_grads(dev, cfg, models, block, seed)
        torch.cuda.synchronize()
        out[precision] = (res, _every_rank(read_counts()))
        # the bars' witnesses: the all-plain build, and the planted faults
        out[f"plain {precision}"] = dp_grads(dev, cfg, plain_copy(cfg, models, dev), block, seed)
        for fault, planted in DP_FAULTS.items():
            with planted():
                out[f"{fault} {precision}"] = dp_grads(dev, cfg, models, block, seed)
        if precision != "bfloat16":
            continue
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = [p for m in models.values() for p in m.parameters()]
        step_ms, reduce_ms = [], []
        for i in range(5):   # 2 warm-up steps, then 3 timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mesh.pretrain_step(models, optimizer, cfg, block, group, gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dp.average_grads(params)   # the step's all-reduce once more, alone
            torch.cuda.synchronize()
            if i >= 2:
                step_ms.append((t1 - t0) * 1e3)
                reduce_ms.append((time.perf_counter() - t1) * 1e3)
        out["step_ms"], out["all_reduce_ms"] = step_ms, reduce_ms
    pos, counts = dp_chain(dev)
    out["chain"] = (dp.all_gather_rows(pos).cpu(), _every_rank(counts))
    return out


def data_parallel_path(dev, card: str):
    """Phase 18: data parallelism at the pretraining CLI's defaults: the
    refusal of 2 ranks on the one card; a 1-rank NCCL group's step (launch
    counts K1 5 / 5, K2 6 / 6, K3 1 / 1) and its loss terms, gradient norms
    and running statistics against the step with no group (1e-5); two gloo
    ranks sharing the card on the two blocks of the global batch (B=128, 64
    a rank) against the one-process step, bf16 1e-2 and f32 1e-4, each bar
    checked to sit below the readings of two planted faults (DP_FAULTS),
    with the all-plain build's readings beside them, each rank's launches,
    the step's and the all-reduce's wall ms; the 2D->3D
    chain on the two ranks against the one-process chain (f32, atol 2e-4 /
    rtol 1e-3, K1 5 and K3 1 a rank).  The bars: ``DP_PRECISIONS``.
    Returns (launch counts by run, the printed figures)."""
    import os

    from moleculesde_tpu_torch.examples import pretrain as cli
    from moleculesde_tpu_torch.parallel import collectives as dp
    from moleculesde_tpu_torch.parallel import mesh

    try:
        cli.main(["--dataset", "synthetic", "--num_devices", "2"])
        check(False, "--num_devices 2 ran on one card")
    except ValueError as e:
        print(f"--num_devices 2 on one card: {e}", flush=True)
        check("1 is visible" in str(e), f"the refusal does not name 1 visible card: {e}")

    refs, runs = {}, {}
    for precision, seed, _ in DP_PRECISIONS:
        cfg, models, optimizer, batch = dp_setup(dev, precision)
        refs[precision] = dp_grads(dev, cfg, models, batch.to(dev), seed)
        refs[f"plain {precision}"] = dp_grads(dev, cfg, plain_copy(cfg, models, dev),
                                              batch.to(dev), seed)
    # a 1-rank NCCL group through parallel/ (env://, as a launcher sets it)
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(mesh.free_port()),
           "WORLD_SIZE": "1", "RANK": "0"}
    os.environ.update(env)
    try:
        mesh.initialize_distributed(device=dev)
        group = mesh.current_group()
        check(group.backend == "nccl" and group.world == 1, f"group {group}")
        cfg, models, optimizer, batch = dp_setup(dev, "bfloat16")
        batch = batch.to(dev)
        with dp.data_parallel(group):
            seed = DP_PRECISIONS[0][1]
            dp_against("1-rank NCCL group vs no group, bf16",
                       dp_grads(dev, cfg, models, batch, seed), refs["bfloat16"], 1e-5)
            reset_counts()
            metrics = mesh.pretrain_step(models, optimizer, cfg, batch, group,
                                         torch.Generator(device=dev).manual_seed(seed))
            torch.cuda.synchronize()
        runs["pretrain_data_parallel_nccl_1_rank"] = launches = read_counts()
        expected = expect(gin_messages=5, gin_messages_bwd=5, fused_cfconv=6,
                          fused_cfconv_bwd=6, pair_relu_project=1, pair_relu_project_bwd=1)
        print(f"1-rank NCCL step launches {launches}", flush=True)
        check(launches == expected, f"1-rank NCCL step launches {launches}")
        check(all(math.isfinite(float(v)) for v in metrics.values()), f"metrics {metrics}")
    finally:
        torch.distributed.destroy_process_group()
        for k in env:
            os.environ.pop(k)

    t0 = time.perf_counter()
    shared = mesh.spawn(_dp_shared_rank, 2, dev, backend="gloo", same_card=True,
                        deadline_s=DP_DEADLINE_S)
    spawn_s = time.perf_counter() - t0
    # each bar sits between the honest reading and the planted faults'
    faults = {}
    for precision, _, _ in DP_PRECISIONS:
        for fault in DP_FAULTS:
            faults[fault, precision] = dp_reading(
                f"planted fault ({fault}), 2 gloo ranks vs one process, {precision}",
                shared[f"{fault} {precision}"], refs[precision])
        dp_reading(f"all-plain build, 2 gloo ranks vs one process, {precision}",
                   shared[f"plain {precision}"], refs[f"plain {precision}"])
        dp_reading(f"one process, kernels vs all-plain build, {precision}", refs[precision],
                   refs[f"plain {precision}"])
    dp_reading("one process, bfloat16 vs float32 (same weights and draws)", refs["bfloat16"],
               refs["float32"])
    for precision, _, tol in DP_PRECISIONS:
        for fault in DP_FAULTS:
            check(faults[fault, precision] > tol, f"the {precision} bar {tol:g} does not catch "
                  f"{fault} ({faults[fault, precision]:.3e})")
    for precision, _, tol in DP_PRECISIONS:
        res, counts = shared[precision]
        dp_against(f"2 gloo ranks on one card vs one process, {precision}", res,
                   refs[precision], tol)
        for r, c in enumerate(counts):
            runs[f"pretrain_data_parallel_gloo_{precision}_rank{r}"] = c
            check(c == expected, f"rank {r}'s {precision} step launches {c}")
    pos_ref, _ = dp_chain(dev)
    pos, counts = shared["chain"]
    err = (pos - pos_ref.cpu()).abs()
    bar = 2e-4 + 1e-3 * pos_ref.cpu().abs()
    print(f"2D->3D chain, 2 gloo ranks on one card vs one process: max_abs_err "
          f"{err.max().item():.3e}, worst err / bar {(err / bar).max().item():.3f}", flush=True)
    check(bool((err <= bar).all()), "the two ranks' chain disagrees with one process")
    for r, c in enumerate(counts):
        runs[f"sample_2d_to_3d_data_parallel_rank{r}"] = c
        check(c == expect(gin_messages=5, pair_relu_project=1), f"rank {r}'s chain launches {c}")
    figures = {"label": "two ranks sharing one card over gloo (host-staged collectives); "
                        "not scaling", "global_batch": 128, "per_rank": 64,
               "step_ms": shared["step_ms"], "all_reduce_ms": shared["all_reduce_ms"],
               "spawn_and_run_s": spawn_s, "card": card}
    print(f"data parallel, two ranks sharing one card over gloo (not scaling): bf16 step "
          f"wall_ms {shared['step_ms']} (B=128, 64 a rank), gradient all-reduce wall_ms "
          f"{shared['all_reduce_ms']}; spawn and run {spawn_s:.1f} s", flush=True)
    return runs, figures


# phase 19: the utilities -- the reference's .pth checkpoints imported at the
# CLI's full widths (utils/torch_import.py), a 2D->3D chain and pretraining
# steps from the imported weights, the NaN guard (utils/debug_nans.py), the
# pretraining CLI's --profile_dir trace and matmul_flops with the kernels'
# reports (utils/flops.py)

# the __global__ functions of K1, K2 and K3 (csrc/gin_messages.cu, cfconv.cu,
# pair_block.cu) that the profiled epoch must show, and their launches a step
TRACED_KERNELS = {"gin_messages_fwd_kernel": 5, "gin_messages_bwd_kernel": 5,
                  "cfconv_fwd_kernel": 6, "cfconv_bwd_kernel": 6,
                  "pair_relu_project_fwd_kernel": 1, "pair_relu_project_bwd_kernel": 1}
UTIL_MOLECULES = 256        # the profiled epoch: two steps of B=128


class _RefDraw:
    """Tensors of the reference's state-dict layout from a seeded generator,
    at one of two scales.  ``"init"``, PyTorch's own initializers: Linear
    weights and biases U(+-1 / sqrt(fan_in)), embeddings xavier-uniform,
    norm scales 1 + U(+-0.05), shifts, running means and GIN's eps
    U(+-0.05), running variances in [0.75, 1.25).  ``"wide"``, nearer the
    spread of trained weights: Linear weights N(0, 1 / fan_in), biases,
    shifts, running means and eps N(0, 0.1^2), embeddings N(0, 0.25^2),
    norm scales 1 + N(0, 0.1^2), running variances in [0.5, 1.5).  (Std-1
    weights overflow PaiNN.)"""

    def __init__(self, seed: int, scale: str):
        self.g = torch.Generator().manual_seed(seed)
        self.sd = {}
        self.wide = scale == "wide"

    def _d(self, shape, s):
        """N(0, s^2) at the wide scale, U(+-s) at the initializers'."""
        if self.wide:
            return torch.randn(shape, generator=self.g) * s
        return (torch.rand(shape, generator=self.g) * 2 - 1) * s

    def lin(self, prefix, out, inp, bias=True):
        self.sd[f"{prefix}.weight"] = self._d((out, inp), inp ** -0.5)
        if bias:
            self.bias(f"{prefix}.bias", out, inp)

    def bias(self, key, dim, inp):
        self.sd[key] = self._d((dim,), 0.1 if self.wide else inp ** -0.5)

    def norm(self, prefix, dim, running=True):
        s = 0.1 if self.wide else 0.05
        self.sd[f"{prefix}.weight"] = 1.0 + self._d((dim,), s)
        self.sd[f"{prefix}.bias"] = self._d((dim,), s)
        if running:
            self.sd[f"{prefix}.running_mean"] = self._d((dim,), s)
            self.sd[f"{prefix}.running_var"] = (
                0.5 + torch.rand(dim, generator=self.g) if self.wide
                else 1.0 + self._d((dim,), 0.25))
            self.sd[f"{prefix}.num_batches_tracked"] = torch.tensor(1000)

    def emb(self, key, rows, dim):
        self.sd[key] = self._d((rows, dim), 0.25 if self.wide else (6.0 / (rows + dim)) ** 0.5)

    def eps(self, key):
        self.sd[key] = self._d((1,), 0.1 if self.wide else 0.05)

    def raw(self, key, shape, s):
        self.sd[key] = self._d(shape, s)


def reference_components(seed: int, model_3d: str, emb: int = 300, scale: str = "init"):
    """A ``model_complete.pth`` payload in the reference's key layout at the
    pretraining CLI's defaults: GIN 5 x ``emb``, SchNet 6 interactions x
    128 filters x 51 Gaussians (or PaiNN 3 x ``emb``, 20 radial functions),
    SDEModel2Dto3D_01 (hidden 32, basis 128) and SDEModel3Dto2D variant 1
    (nhid 16, 4 layers of 3 linears, channels 2 / 8 / 4, attention 16),
    drawn at ``scale`` (:class:`_RefDraw`)."""
    gin = _RefDraw(seed, scale)
    for i, rows in enumerate([119, 4, 12, 12, 10, 6, 6, 2, 2]):
        gin.emb(f"atom_encoder.atom_embedding_list.{i}.weight", rows, emb)
    for l in range(5):
        for i, rows in enumerate([5, 6, 2]):
            gin.emb(f"gnns.{l}.bond_encoder.bond_embedding_list.{i}.weight", rows, emb)
        gin.lin(f"gnns.{l}.mlp.0", 2 * emb, emb)
        gin.norm(f"gnns.{l}.mlp.1", 2 * emb)
        gin.lin(f"gnns.{l}.mlp.3", emb, 2 * emb)
        gin.eps(f"gnns.{l}.eps")
        gin.norm(f"batch_norms.{l}", emb)
    enc = _RefDraw(seed + 1, scale)
    enc.emb("embedding.weight", 119, emb)
    if model_3d == "SchNet":
        enc.lin("lin1", emb, emb)
        enc.lin("lin2", emb, emb)
        for k in range(6):
            enc.lin(f"interactions.{k}.mlp.0", 128, 51)
            enc.lin(f"interactions.{k}.mlp.2", 128, 128)
            enc.lin(f"interactions.{k}.conv.lin1", 128, emb, bias=False)
            enc.lin(f"interactions.{k}.conv.lin2", emb, 128)
            enc.lin(f"interactions.{k}.lin", emb, emb)
    else:
        enc.lin("filter_net", 3 * 3 * emb, 20)
        for i in range(3):
            enc.lin(f"interactions.{i}.interatomic_context_net.0", emb, emb)
            enc.lin(f"interactions.{i}.interatomic_context_net.1", 3 * emb, emb)
            enc.lin(f"mixing.{i}.mu_channel_mix", 2 * emb, emb, bias=False)
            enc.lin(f"mixing.{i}.intraatomic_context_net.0", emb, 2 * emb)
            enc.lin(f"mixing.{i}.intraatomic_context_net.1", 3 * emb, emb)
    h, coff = 32, 128
    s23 = _RefDraw(seed + 2, scale)
    s23.lin("edge_2D_emb.0", emb, 2 * emb)
    s23.norm("edge_2D_emb.1", emb)
    s23.lin("edge_2D_emb.3", h, emb)
    s23.sd["coff_gaussian_fourier.W"] = torch.randn(h, generator=s23.g)   # frozen N(0, 1)
    s23.lin("coff_mlp", h, 4 * h)
    s23.lin("project.layers.0", h, 2 * h + 2)
    s23.lin("project.layers.1", h, h)
    s23.lin("node_emb.layers.0", h, emb)
    for m in range(2):
        for c in range(2):
            pre = f"score_network.gnn_layers.{m}.{c}"
            for lin in ("lin_query", "lin_key", "lin_value", "lin_skip"):
                s23.lin(f"{pre}.MHA.{lin}", h, h)
            s23.lin(f"{pre}.MHA.lin_edge", h, h, bias=False)
            s23.lin(f"{pre}.FFN.0", h, h)
            s23.lin(f"{pre}.FFN.3", h, h)
            s23.norm(f"{pre}.norm1", h, running=False)
            s23.norm(f"{pre}.norm2", h, running=False)
        s23.lin(f"score_network.basis_mlp_modules.{m}.0", coff, 2 * h)
        s23.lin(f"score_network.basis_mlp_modules.{m}.2", 3, coff)
    s32 = _RefDraw(seed + 3, scale)
    nhid, adim, c_init, c_hid, c_final, layers = 16, 16, 2, 8, 4, 4
    s32.lin("embedding_3D", emb, emb)
    s32.lin("embedding_X", emb, 119)
    for i in range(layers):
        a2, f_in = 2 * (nhid if i == 0 else adim), emb if i == 0 else nhid
        c_in, c_out = (c_init if i == 0 else c_hid), (c_final if i == layers - 1 else c_hid)
        pre = f"edge_score_network.layers.{i}"
        for c in range(c_in):
            for fn in ("func_q", "func_k"):
                s32.lin(f"{pre}.attn.{c}.{fn}.layers.0", a2, f_in)
                s32.lin(f"{pre}.attn.{c}.{fn}.layers.1", a2, a2)
            s32.raw(f"{pre}.attn.{c}.func_v.weight", (f_in, nhid), f_in ** -0.5)   # [in, out]
            s32.bias(f"{pre}.attn.{c}.func_v.bias", nhid, f_in)
        hid = 2 * max(c_in, c_out)
        s32.lin(f"{pre}.multi_channel.layers.0", hid, c_in * nhid)
        s32.lin(f"{pre}.multi_channel.layers.1", nhid, hid)
        dims = [2 * c_in, hid, hid, c_out]
        for li in range(3):
            s32.lin(f"{pre}.mlp.layers.{li}", dims[li + 1], dims[li])
    fdim = c_hid * (layers - 1) + c_final + c_init
    for li, (o, i_) in enumerate([(2 * fdim, fdim), (2 * fdim, 2 * fdim), (1, 2 * fdim)]):
        s32.lin(f"edge_score_network.final.layers.{li}", o, i_)
    for i in range(layers):
        f_in = emb if i == 0 else nhid
        s32.raw(f"node_score_network.layers.{i}.weight", (f_in, nhid), f_in ** -0.5)
        s32.bias(f"node_score_network.layers.{i}.bias", nhid, f_in)
    nf = emb + layers * nhid
    for li, (o, i_) in enumerate([(2 * nf, nf), (2 * nf, 2 * nf), (119, 2 * nf)]):
        s32.lin(f"node_score_network.final.layers.{li}", o, i_)
    return {"model_2D": gin.sd, "model_3D": enc.sd, "SDE_2Dto3D_model": s23.sd,
            "SDE_3Dto2D_model": s32.sd}


def _idx(part: str) -> int:
    return int(part.rsplit("_", 1)[1])


def reference_leaf(sd, comp: str, key: str) -> torch.Tensor:
    """The value the port's parameter or buffer ``key`` of component
    ``comp`` takes from the reference state dict ``sd``, stated from the
    port's side (utils/torch_import.py states it from the reference's):
    Dense kernels are transposed Linear weights, norms take weight / bias /
    running statistics, the 3D->2D bank stacks its channels, the basis MLP's
    first Linear splits in two."""
    *path, leaf = key.split(".")

    def dense(prefix):
        return sd[f"{prefix}.weight"].t() if leaf == "kernel" else sd[f"{prefix}.bias"]

    def norm(prefix):
        names = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                 "var": "running_var"}
        return sd[f"{prefix}.{names[leaf]}"]

    if comp == "model_2D":
        if path[0] == "AtomEncoder_0":
            return sd[f"atom_encoder.atom_embedding_list.{_idx(path[1])}.weight"]
        if path[0].startswith("MaskedBatchNorm_"):
            return norm(f"batch_norms.{_idx(path[0])}")
        pre = f"gnns.{_idx(path[0])}"
        if leaf == "eps":
            return sd[f"{pre}.eps"]
        if path[1] == "BondEncoder_0":
            return sd[f"{pre}.bond_encoder.bond_embedding_list.{_idx(path[2])}.weight"]
        if path[1] == "MaskedBatchNorm_0":
            return norm(f"{pre}.mlp.1")
        return dense(f"{pre}.mlp.{(0, 3)[_idx(path[1])]}")
    if comp == "model_3D":
        if path[0] == "Embed_0":
            return sd["embedding.weight"]
        if path[0] == "filter_net":
            return dense("filter_net")
        if path[0] in ("Dense_0", "Dense_1"):
            return dense(f"lin{_idx(path[0]) + 1}")
        k, j = _idx(path[0]), _idx(path[1])
        if path[0].startswith("SchNetInteraction_"):
            part = ("mlp.0", "mlp.2", "conv.lin1", "conv.lin2", "lin")[j]
            return dense(f"interactions.{k}.{part}")
        if path[0].startswith("PaiNNInteraction_"):
            return dense(f"interactions.{k}.interatomic_context_net.{j}")
        part = ("mu_channel_mix", "intraatomic_context_net.0", "intraatomic_context_net.1")[j]
        return dense(f"mixing.{k}.{part}")
    if comp == "SDE_2Dto3D_model":
        if path == [] and leaf == "coff_fourier_W":
            return sd["coff_gaussian_fourier.W"]
        if path[0] in ("edge_2D_emb_0", "edge_2D_emb_1"):
            return dense(f"edge_2D_emb.{(0, 3)[_idx(path[0])]}")
        if path[0] == "edge_2D_emb_bn":
            return norm("edge_2D_emb.1")
        if path[0] == "coff_mlp":
            return dense("coff_mlp")
        if path[0] in ("project", "node_emb"):
            return dense(f"{path[0]}.layers.{_idx(path[1])}")
        if path[1].startswith("DenseGATLayer_"):
            j = _idx(path[1])
            pre = f"score_network.gnn_layers.{j // 2}.{j % 2}"
            if path[2].startswith("lin_"):
                if path[2] == "lin_edge" and leaf == "bias":   # PyG's lin_edge: no bias
                    return torch.zeros_like(sd[f"{pre}.MHA.lin_edge.weight"][:, 0])
                return dense(f"{pre}.MHA.{path[2]}")
            if path[2].startswith("LayerNorm_"):
                part = "weight" if leaf == "scale" else "bias"
                return sd[f"{pre}.norm{_idx(path[2]) + 1}.{part}"]
            return dense(f"{pre}.FFN.{(0, 3)[_idx(path[2])]}")
        m = _idx(path[1])
        pre = f"score_network.basis_mlp_modules.{m}"
        w0 = sd[f"{pre}.0.weight"].t()
        if path[1].startswith("basis_node_"):
            return w0[:w0.shape[0] // 2]
        if path[1].startswith("basis_edge_"):
            return w0[w0.shape[0] // 2:] if leaf == "kernel" else sd[f"{pre}.0.bias"]
        return dense(f"{pre}.2")
    # SDE_3Dto2D_model
    if path[0] in ("embedding_3D", "embedding_X"):
        return dense(path[0])
    net = path[0]
    if path[1] == "final":
        return dense(f"{net}.final.layers.{_idx(path[2])}")
    i = _idx(path[1])
    pre = f"{net}.layers.{i}"
    if net == "node_score_network":          # NodeNetwork_dense: [in, out] as stored
        return sd[f"{pre}.{'weight' if leaf == 'kernel' else 'bias'}"]
    if path[2] in ("multi_channel", "mlp"):
        return dense(f"{pre}.{path[2]}.layers.{_idx(path[3])}")
    channels = range(sum(1 for k in sd if k.startswith(f"{pre}.attn.")
                         and k.endswith(".func_v.bias")))
    if leaf.startswith("v_"):
        part = "weight" if leaf == "v_kernel" else "bias"
        return torch.stack([sd[f"{pre}.attn.{c}.func_v.{part}"] for c in channels])
    net_name, kind, layer = leaf.split("_")        # q_kernel_0, k_bias_1
    parts = [sd[f"{pre}.attn.{c}.func_{net_name}.layers.{layer}."
                f"{'weight' if kind == 'kernel' else 'bias'}"] for c in channels]
    return torch.stack([p.t() for p in parts] if kind == "kernel" else parts)


def check_imported(models, payload, dev, label: str, card: str) -> int:
    """Every parameter and buffer of ``models`` against its reference tensor
    (:func:`reference_leaf`), on the card, bit for bit; returns the count."""
    checked = 0
    for comp, module in models.items():
        for key, value in module.state_dict().items():
            ref = reference_leaf(payload[comp], comp, key).to(dev, value.dtype)
            check(tuple(ref.shape) == tuple(value.shape) and torch.equal(value, ref),
                  f"{label}: {comp}.{key} is not its reference tensor under the mapping")
            checked += 1
    print(f"{label}: {checked} parameters and buffers equal their .pth tensors under the "
          f"mapping, on {value.device} ({card})", flush=True)
    return checked


def step_errors(mine, ref) -> dict:
    """:func:`one_step` results against each other: loss terms, CL_acc and
    component gradient norms relative, the kernels' gradient leaves
    relative L2."""
    (mk, gk, lk), (mr, gr, lr) = mine, ref
    errs = {f"{'metric' if k == 'CL_acc' else 'loss'} {k}": abs(mk[k] - mr[k])
            / max(1e-6, abs(mr[k])) for k in mr}
    errs.update({f"|grad {n}|": abs(gk[n] - gr[n]) / max(1e-12, gr[n]) for n in gr})
    errs.update({f"leaf {k}": ((lk[k] - v).norm() / v.norm().clamp(min=1e-30)).item()
                 for k, v in lr.items()})
    return errs


# loss terms, CL_acc, component gradient norms, the kernels' gradient leaves
STEP_KINDS = ("loss", "metric", "|grad", "leaf")


def step_reading(label, mine, ref, card: str) -> dict:
    """Print the worst value of each kind of :func:`step_errors`; return
    {kind: (worst value's name, its error)}."""
    errs = step_errors(mine, ref)
    worst = {kind: max(((k, v) for k, v in errs.items() if k.startswith(kind)),
                       key=lambda kv: kv[1]) for kind in STEP_KINDS}
    print(f"{label}: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.values()) + f" ({card})",
          flush=True)
    return worst


@contextlib.contextmanager
def k1_misses_last_graph(direction: str):
    """A planted fault for the wide checkpoint's bar: K1's forward (or
    backward) leaves out the last graph, as a grid one block row short
    would (its output rows, or its node gradient rows, are zero)."""
    from moleculesde_tpu_torch.ops import gin_messages as k1

    name = "_launch" if direction == "forward" else "_launch_bwd"
    launch = getattr(k1, name)

    def short(*args, **kwargs):
        out = launch(*args, **kwargs)
        (out if direction == "forward" else out[0])[-1].zero_()
        return out

    setattr(k1, name, short)
    try:
        yield
    finally:
        setattr(k1, name, launch)


WIDE_FAULTS = {"K1's forward misses the last graph": lambda: k1_misses_last_graph("forward"),
               "K1's backward misses the last graph": lambda: k1_misses_last_graph("backward")}
# The wide checkpoint's bars, by kind of value (STEP_KINDS).  Its bf16
# step is ill-conditioned (CL loss ~700): the kernels' step and the
# all-plain step sit equally far from the all-plain f32 step (on an H100:
# gradient norms 1.37e-2 and 1.65e-2, leaves 1.60e-1 and 1.59e-1), while
# they differ from each other by 2.72e-3 on model_2D's norm, past phase
# 7's 1e-3, and in f32 by 4.3e-7 to 2.0e-6 (norms) and 3.4e-4 to 5.5e-4
# (leaves) over three runs: rounding, not a kernel fault (PERF.md).  So
# each step is also held to the f32 step's distance (WIDE_WITNESS_RATIO),
# the f32 kernels to the f32 bars,
# which sit below both planted faults' readings (backward: norms 1.12e-5,
# leaves 1.11e-2), and the bf16 kernels to bars above the honest reading
# and below the forward fault's (loss 3.05e-3, norms 1.31e-2); in bf16
# the backward fault (norms 2.31e-3, leaves 1.48e-2) hides in the
# rounding, and only the f32 bars catch it.
WIDE_BARS = {"bf16": {"loss": 1e-3, "metric": 1e-3, "|grad": 5e-3, "leaf": 5e-2},
             "f32": {"loss": 1e-5, "metric": 1e-3, "|grad": 5e-6, "leaf": 5e-3}}
WIDE_WITNESS_RATIO = 1.25


def wide_checkpoint_step(dev, args, batch, path: str, card: str) -> dict:
    """The step from the wide checkpoint (:class:`_RefDraw`): the kernels'
    bf16 step against the all-plain bf16 step; both, and the kernels' f32
    step, against the all-plain f32 step on the same weights and draws
    (the witnesses); the planted faults (``WIDE_FAULTS``) against the
    all-plain bf16 step.  Launch counts are left as they were.  Returns
    {reading: {value: error}}."""
    from moleculesde_tpu_torch.benchmarks.profile_pretrain import COMMON_ARGS, parse_path
    from moleculesde_tpu_torch.examples import pretrain as cli
    from moleculesde_tpu_torch.utils.torch_import import (
        import_pretrain_checkpoint, load_imported)

    imported = import_pretrain_checkpoint(path)
    cfg, models, _, _ = cli.setup(args, dev)
    load_imported(models, imported)
    args32 = parse_path(COMMON_ARGS + ["--train_precision", "float32"], batches=1)
    cfg32, models32, _, _ = cli.setup(args32, dev)
    load_imported(models32, imported)
    saved = [c.launches for c in _counters()]
    steps = {"kernels bf16": one_step(dev, cfg, models, batch, args.seed),
             "plain bf16": one_step(dev, cfg, plain_copy(cfg, models, dev), batch, args.seed),
             "kernels f32": one_step(dev, cfg32, models32, batch, args.seed),
             "plain f32": one_step(dev, cfg32, plain_copy(cfg32, models32, dev), batch,
                                   args.seed)}
    for fault, planted in WIDE_FAULTS.items():
        with planted():
            steps[fault] = one_step(dev, cfg, models, batch, args.seed)
            steps[fault + ", f32"] = one_step(dev, cfg32, models32, batch, args.seed)
    for c, n in zip(_counters(), saved):
        c.launches = n
    print(f"wide checkpoint: loss {steps['plain f32'][0]['loss']:.6f} (f32), CL_loss "
          f"{steps['plain f32'][0]['CL_loss']:.6f}, |grad model_2D| "
          f"{steps['plain f32'][1]['model_2D']:.6e} ({card})", flush=True)
    readings = {}
    for mine, ref in (("kernels bf16", "plain bf16"), ("kernels bf16", "plain f32"),
                      ("plain bf16", "plain f32"), ("kernels f32", "plain f32"),
                      *((fault, "plain bf16") for fault in WIDE_FAULTS),
                      *((fault + ", f32", "plain f32") for fault in WIDE_FAULTS)):
        readings[f"{mine} vs {ref}"] = step_reading(f"wide checkpoint, {mine} vs {ref}",
                                                    steps[mine], steps[ref], card)

    def caught(reading, bars):
        return any(reading[kind][1] > bars[kind] for kind in STEP_KINDS)

    for precision in ("bf16", "f32"):
        bars = WIDE_BARS[precision]
        label = f"kernels {precision} vs plain {precision}"
        for kind, (name, err) in readings[label].items():
            check(err <= bars[kind], f"wide checkpoint, {label}: {name} off by {err:.3e} "
                  f"(bar {bars[kind]:g})")
    for kind in STEP_KINDS:
        mine = readings["kernels bf16 vs plain f32"][kind][1]
        ref = readings["plain bf16 vs plain f32"][kind][1]
        check(mine <= WIDE_WITNESS_RATIO * ref, f"wide checkpoint: the kernels' bf16 step sits "
              f"farther from the f32 step than the all-plain bf16 step ({kind} {mine:.3e} "
              f"against {ref:.3e})")
    for fault in WIDE_FAULTS:
        check(caught(readings[f"{fault}, f32 vs plain f32"], WIDE_BARS["f32"]),
              f"the wide checkpoint's f32 bars do not catch {fault}")
    check(caught(readings["K1's forward misses the last graph vs plain bf16"],
                 WIDE_BARS["bf16"]), "the wide checkpoint's bf16 bars do not catch K1's "
          "forward missing the last graph")
    print(f"wide checkpoint: within the bars {WIDE_BARS} and {WIDE_WITNESS_RATIO}x the all-plain "
          f"bf16 step's distance from f32; the f32 bars catch both planted faults, the bf16 "
          f"bars the forward one ({card})", flush=True)
    return readings


def utilities_path(dev, card: str):
    """Phase 19 (module docstring); returns ({run: launch counts}, figures)."""
    import os
    import tempfile

    from moleculesde_tpu_torch.benchmarks.profile_pretrain import COMMON_ARGS, parse_path
    from moleculesde_tpu_torch.benchmarks.profile_pretrain import PATH_ARGS as PADDED_ARGS
    from moleculesde_tpu_torch.benchmarks.profile_sampler import PATH_ARGS as SAMPLER_ARGS
    from moleculesde_tpu_torch.examples import pretrain as cli
    from moleculesde_tpu_torch.examples import sample_2d_to_3d as s2d
    from moleculesde_tpu_torch.pretrain.train_step import METRICS, pretrain_step
    from moleculesde_tpu_torch.utils.debug_nans import NanGuard
    from moleculesde_tpu_torch.utils.torch_import import (
        import_pretrain_checkpoint, load_imported)

    t_phase = time.perf_counter()
    runs, figures = {}, {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) reference-layout checkpoints, (b) imported and checked on the card
        imported = {}
        for model_3d in ("SchNet", "PaiNN"):
            path = os.path.join(tmp, f"model_complete_{model_3d}.pth")
            payload = reference_components(19, model_3d)
            torch.save(payload, path)
            t0 = time.perf_counter()
            imported[model_3d] = import_pretrain_checkpoint(path)
            args = parse_path(COMMON_ARGS + ["--model_3d", model_3d], batches=1)
            _, models, _, _ = cli.setup(args, dev)
            load_imported(models, imported[model_3d])
            figures[f"import_and_load_s_{model_3d}"] = time.perf_counter() - t0
            check_imported(models, payload, dev, f"model_complete.pth with {model_3d}", card)
            print(f"import_pretrain_checkpoint and load, {model_3d}: "
                  f"{figures[f'import_and_load_s_{model_3d}']:.3f} s ({card})", flush=True)
            batch, _ = next(iter(cli.make_loader(cli.load_graphs(args), args)))
            with torch.no_grad():
                from moleculesde_tpu_torch.data.compact import expand_on_device
                pooled, latent = models["model_3D"].encode_batch(expand_on_device(batch.to(dev)))
            check(bool(torch.isfinite(pooled).all() and torch.isfinite(latent).all()),
                  f"{model_3d} from the imported weights gives non-finite outputs")
            del models

        # (c1) a 2D->3D chain at the sampler CLI's defaults from the import
        sargs = s2d.get_parser().parse_args(SAMPLER_ARGS)
        batch = s2d.make_batch(s2d.load_graphs(sargs), sargs, dev)
        chain, plain = ({"model_2D": m2, "SDE_2Dto3D_model": m23} for m2, m23 in (
            s2d.build_models(sargs, dev),
            s2d.build_models(sargs, dev, msg_impl="plain", pair_impl="plain")))
        for ms in (chain, plain):
            load_imported(ms, {k: imported["SchNet"][k] for k in ms})
        reset_counts()
        pos = s2d.generate(chain["model_2D"], chain["SDE_2Dto3D_model"], batch,
                           torch.Generator(device=dev).manual_seed(sargs.seed), sargs)
        torch.cuda.synchronize()
        runs["sample_2d_to_3d_imported"] = launches = read_counts()
        print(f"2D->3D chain from the imported weights: launches {launches} ({card})",
              flush=True)
        check(launches == expect(gin_messages=5, pair_relu_project=1),
              f"imported chain launches {launches}")
        check(bool(torch.isfinite(pos).all()), "the imported chain's positions are not finite")
        with torch.no_grad():
            conds = []
            for ms in (chain, plain):
                node = ms["model_2D"](batch, use_running_average=True)
                conds.append((node, ms["SDE_2Dto3D_model"].precompute_conditioning(
                    node, batch, layout="channel")["edge_attr_2d"].float()))
        (node_k, edge_k), (node_p, edge_p) = conds
        node_err = (node_k - node_p).abs().max().item()
        edge_err = (edge_k - edge_p).abs().max().item()
        node_bar = 1e-4 * max(1.0, node_p.abs().max().item())
        edge_bar = 2 ** -8 * max(1.0, edge_p.abs().max().item())
        print(f"imported chain's conditioning vs the all-plain build: node_2d max_abs_err "
              f"{node_err:.3e} (bar {node_bar:.3e}), edge_attr_2d {edge_err:.3e} (bar "
              f"{edge_bar:.3e}; phase 3's bars; {card})", flush=True)
        check(node_err <= node_bar and edge_err <= edge_bar,
              "the imported chain's conditioning disagrees with the all-plain build")
        del chain, plain

        # (c2) pretraining steps at the CLI's defaults from the import
        args = parse_path(COMMON_ARGS, batches=1)
        batch = next(iter(cli.make_loader(cli.load_graphs(args), args)))[0].to(dev)

        def imported_state(a=args):
            cfg, models, optimizer, _ = cli.setup(a, dev)
            return cfg, load_imported(models, imported["SchNet"]), optimizer

        cfg, models, _ = imported_state()
        step_against_plain(dev, cfg, models, batch, args.seed, "imported weights")
        # the same step from the wide checkpoint, with its witnesses
        wide = os.path.join(tmp, "model_complete_wide.pth")
        torch.save(reference_components(19, "SchNet", scale="wide"), wide)
        readings = wide_checkpoint_step(dev, args, batch, wide, card)
        figures["wide_checkpoint"] = readings
        # (e) matmul FLOPs of the step, kernels (their reports) and all-plain
        plain = plain_copy(cfg, models, dev)
        flops = {name: matmul_flops(one_step, dev, cfg, ms, batch, args.seed)
                 for name, ms in (("kernels", models), ("plain", plain))}
        figures["step_matmul_flops"] = flops
        print(f"matmul_flops of one step (forward and backward, B={args.batch_size}, compact, "
              f"bf16): kernels {flops['kernels']}, all-plain {flops['plain']} ({card})",
              flush=True)
        check(flops["kernels"] == flops["plain"], f"matmul_flops differ: {flops}")
        del models, plain

        # the NaN guard at the CLI's default compact ingest (2 steps) and at
        # --ingest padded (1 step): an honest step fires nothing, bit for bit
        padded = parse_path(PADDED_ARGS, batches=1)
        for ingest, a, b, steps in (
                ("compact", args, batch, 2),
                ("padded", padded,
                 next(iter(cli.make_loader(cli.load_graphs(padded), padded)))[0].to(dev), 1)):
            (cfg, ma, oa), (_, mb, ob) = imported_state(a), imported_state(a)
            step_ms = {"unguarded": [], "guarded": []}
            for i in range(steps):
                for name, ms, opt in (("unguarded", ma, oa), ("guarded", mb, ob)):
                    gen = torch.Generator(device=dev).manual_seed(a.seed + i)
                    reset_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with NanGuard(ms, opt) if name == "guarded" else contextlib.nullcontext():
                        metrics = pretrain_step(ms, opt, cfg, b, gen)
                        vals = torch.stack([metrics[k] for k in METRICS]).tolist()
                    torch.cuda.synchronize()
                    step_ms[name].append((time.perf_counter() - t0) * 1e3)
                    key = "" if ingest == "compact" else "_padded"
                    runs[f"pretrain_imported{key}_{name}_step_{i}"] = counts = read_counts()
                    check(counts == expect(gin_messages=5, gin_messages_bwd=5, fused_cfconv=6,
                                           fused_cfconv_bwd=6, pair_relu_project=1,
                                           pair_relu_project_bwd=1),
                          f"{ingest} {name} step launches {counts}")
                    check(all(math.isfinite(v) for v in vals), f"{ingest} {name} metrics {vals}")
                    if name == "unguarded":
                        ref = vals
                    else:
                        check(vals == ref, f"the guarded {ingest} step's metrics {vals} != {ref}")
                _states_equal((ma, oa), (mb, ob), f"{ingest} step {i}, guarded vs unguarded")
            figures["step_ms" + ("" if ingest == "compact" else "_padded")] = step_ms
            print(f"{ingest} step from the imported weights, guarded by --debug_nans's NanGuard "
                  f"vs not: metrics, parameters, statistics and Adam's state bit for bit over "
                  f"{steps} step(s); wall_ms unguarded {step_ms['unguarded']}, guarded "
                  f"{step_ms['guarded']} ({card})", flush=True)
        del ma, mb, oa, ob

        cfg, mc, oc = imported_state()
        with torch.no_grad():
            mc["model_2D"].GINConv_0.Dense_0.kernel[7, 11] = float("nan")
        reset_counts()
        try:
            with NanGuard(mc, oc):
                pretrain_step(mc, oc, cfg, batch, torch.Generator(device=dev).manual_seed(1))
            check(False, "a NaN planted in model_2D.GINConv_0.Dense_0 raised nothing")
        except FloatingPointError as e:
            counts = read_counts()
            print(f"planted NaN: FloatingPointError({e}); launches before it {counts} "
                  f"({card})", flush=True)
            check("model_2D.GINConv_0.Dense_0" in str(e), f"the error does not name the "
                  f"module: {e}")
            check(counts["gin_messages"] >= 1, "K1 did not run before the planted NaN")
        del mc, oc

        # (d) the CLI's first epoch under --profile_dir (and --debug_nans)
        prof_dir = os.path.join(tmp, "profile")
        flags = COMMON_ARGS + ["--synthetic_molecules", str(UTIL_MOLECULES),
                               "--profile_dir", prof_dir, "--debug_nans"]
        reset_counts()
        t0 = time.perf_counter()
        cli.main(flags)
        figures["profiled_epoch_s"] = time.perf_counter() - t0
        runs["pretrain_cli_profiled"] = read_counts()
        trace = os.path.join(prof_dir, "trace_rank0.json")
        figures["trace_mb"] = os.path.getsize(trace) / 1e6
        with open(trace) as fh:
            events = [e for e in json.load(fh)["traceEvents"] if e.get("cat") == "kernel"]
        steps = UTIL_MOLECULES // args.batch_size
        seen = {}
        for name in TRACED_KERNELS:
            mine = [e for e in events if name in e.get("name", "")]
            seen[name] = {"events": len(mine), "device_ms": sum(e.get("dur", 0) for e in mine)
                          / 1e3}
        figures["trace"] = seen
        print(f"--profile_dir trace of epoch 1 ({steps} steps, {figures['trace_mb']:.1f} MB, "
              f"{len(events)} CUDA kernel events; {card}): " + ", ".join(
                  f"{k} {v['events']} ({v['device_ms']:.3f} ms)" for k, v in seen.items()),
              flush=True)
        for name, per_step in TRACED_KERNELS.items():
            check(seen[name]["events"] == per_step * steps,
                  f"the trace holds {seen[name]['events']} events of {name}, expected "
                  f"{per_step * steps}")
    figures["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 19: {figures['phase_s']:.1f} s ({card})", flush=True)
    return runs, figures



# phase 20: every N the JAX kernels take -- K1's ranges plan, K3 / K4's
# tiled backward and K8's tiled plan, each past the plan it keeps inside its
# old limits, alone and on the pretraining and sampler paths at --n_max 1024

def seeded_gin_operands(dev, b, n, e, d, f, seed):
    """K1 operands of molecule-like graphs: in each graph a random count of
    atoms in [N / 2, N] joined by its live edges (half to all of E), the
    rest of the edge slots masked to the sentinel N; a few out-of-range src
    and dst besides; one-hot rows at density 1 / 4."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    src = torch.full((b, e), n, dtype=torch.int32, device=dev)
    dst = torch.full((b, e), n, dtype=torch.int32, device=dev)
    for i in range(b):
        atoms = int(torch.randint(n // 2, n + 1, (1,), generator=gen, device=dev))
        live = int(torch.randint(e // 2, e + 1, (1,), generator=gen, device=dev))
        src[i, :live] = torch.randint(0, atoms, (live,), generator=gen, device=dev,
                                      dtype=torch.int32)
        dst[i, :live] = torch.randint(0, atoms, (live,), generator=gen, device=dev,
                                      dtype=torch.int32)
    src[:, 5::37] = -3
    dst[:, 9::41] = n + 7
    x = torch.randn(b, n, f, device=dev, generator=gen)
    boh = (torch.rand(b, e, d, device=dev, generator=gen) < 0.25).float()
    table = 0.5 * torch.randn(d, f, device=dev, generator=gen)
    return (x, src, dst, boh, table), torch.randn(b, n, f, device=dev, generator=gen)


def large_gin_phases(dev):
    """K1 forward and backward in the ranges plan on seeded operands at N =
    2048, B = 2 (E = 4 N, D = 13, F = 300) and at D = 40 (two 32-column
    slices; N = 128, B = 32), against the plain versions at the training
    phase's bars in bf16 and f32, and two runs of each bit for bit."""
    return {size: _large_gin_phase(dev, size, shape)
            for size, shape in (("n_2048_b_2", (2, 2048, 8192, 13, 300)),
                                ("n_128_d_40", (32, 128, 512, 40, 300)))}


def _large_gin_phase(dev, size, shape):
    """large_gin_phases at one shape (its own scope: the timed calls close
    over this shape's operands until device_time_phase)."""
    (x, src, dst, boh, table), g1 = seeded_gin_operands(dev, *shape, seed=23)
    b, n, e, d, f = shape
    for plan in (gin_ops.fwd_plan(n, e, d, f, b), gin_ops.bwd_plan(n, e, d, f, b)):
        check(plan["plan"] == "ranges", f"K1 at {size}: the {plan['plan']} plan")
    res = {}
    for bf16 in (True, False):
        sfx = "" if bf16 else "[f32]"
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
        res["gin_messages" + sfx], res["gin_messages_bwd" + sfx] = grad_phase(
            f"{size} K1 gin_messages" + sfx,
            lambda x_, t_, **kw: gin_messages(x_, src, dst, boh, t_, **kw),
            lambda x_, t_, g_, **kw: gin_messages_bwd(x_, src, dst, boh, t_, g_, **kw),
            lambda x_, t_, g_, **kw: gin_messages_bwd_plain(x_, src, dst, boh, t_, g_,
                                                            **kw),
            (x, table), g1, bf16, 1e-2 if bf16 else 1e-4,
            k1_cost(x, src, dst, table), k1_cost(x, src, dst, table, bwd=True), peak,
            reps=LARGE_REPS)
        with torch.no_grad():
            same_bits(f"{size} K1 forward" + sfx, lambda: gin_messages(
                x, src, dst, boh, table, bf16=bf16, impl="kernel"))
            same_bits(f"{size} K1 backward" + sfx, lambda: gin_messages_bwd(
                x, src, dst, boh, table, g1, bf16=bf16, impl="kernel"))
    return res


def large_pair_bwd_phases(dev):
    """K3 and K4's backward in the tiled plan on seeded operands (C = 300)
    at N = 2048, B = 1, H = 32 (16 row tiles) and N = 1024, B = 2, H = 64 (16
    row tiles, two passes of h), against the plain versions at the training
    phase's bars in bf16 and f32, and two runs of each bit for bit."""
    return {size: _large_pair_bwd_phase(dev, size, shape)
            for size, shape in (("n_2048_b_1", (1, 2048, 300, 32)),
                                ("n_1024_h_64", (2, 1024, 300, 64)))}


def _large_pair_bwd_phase(dev, size, shape):
    """large_pair_bwd_phases at one shape, in its own scope."""
    b, n, c, h = shape
    plan = pair_ops.bwd_plan(n, c, h, b)
    check(plan["tiles"] > 1, f"K3 / K4 backward at {size}: plan {plan}")
    gen = torch.Generator(device=dev).manual_seed(29)
    a, cc = (torch.randn(b, n, c, device=dev, generator=gen) for _ in range(2))
    w = torch.randn(c, h, device=dev, generator=gen) / c ** 0.5
    g3 = torch.randn(b, n, n, h, device=dev, generator=gen)
    g4 = g3.reshape(b, n * n, h).transpose(1, 2).contiguous()
    res = {}
    for bf16 in (True, False):
        sfx = "" if bf16 else "[f32]"
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
        for name, bwd, plain, g, cost in (
                ("pair_relu_project_bwd", pair_relu_project_bwd, pair_relu_project_bwd_plain,
                 g3, k3_cost(a, w, bwd=True)),
                ("pair_relu_project_cm_bwd", pair_relu_project_cm_bwd,
                 pair_relu_project_cm_bwd_plain, g4, k4_cost(a, w, bwd=True))):
            label = f"{size} {'K4' if 'cm' in name else 'K3'} {name}" + sfx
            run_k = lambda f_=bwd, g_=g, m=bf16: f_(a, cc, w, g_, bf16=m,  # noqa: E731
                                                    impl="kernel")
            run_p = lambda f_=plain, g_=g, m=bf16: f_(a, cc, w, g_, bf16=m)  # noqa: E731
            tol = 1e-3 if bf16 else 1e-4
            err, rel = compare(label, run_k, run_p, tol)
            res[name + sfx] = report(label, err, tol, run_k, run_p, *cost, peak,
                                     reps=LARGE_REPS)
            res[name + sfx]["max_rel_err"] = rel
            with torch.no_grad():
                same_bits(label, run_k)
    return res


def large_qk_bank_phases(dev):
    """K8 forward and backward in the tiled plan on the 3D->2D chain's edge
    layer 1 (C = 8, F = 16) and 0 (C = 2, F = 300) operands at --n_max 512
    and 1024, B = 2 (qk_bank_phase: against the plain pair under autograd,
    bf16 3e-3 and f32 1e-4 of max |plain|, two runs bit for bit); then its
    backward at N = 256, B = 2 (seeded edge layer 1 operands, where the
    block plan still runs) in both plans, in turns."""
    from moleculesde_tpu_torch.benchmarks.profile_sampler_3d2d import chain_bank_operands
    from moleculesde_tpu_torch.ops import attn_qk_bank as k8

    results = {}
    for n in (512, 1024):
        for li, ops in enumerate(chain_bank_operands(dev, n, 2)):
            qk, ws, ds = ops["qk"], ops["ws"], ops["ds"]
            c, f, a = ws[0].shape[0], qk.shape[2], ws[0].shape[2]
            for bwd in (False, True):
                check(k8.plan_of(n, f, c, a, a // ds, bwd, 2) == "tiled",
                      f"K8 at N={n}: not the tiled plan")
            gen = torch.Generator(device=dev).manual_seed(31 + li)
            g = torch.randn(2, c, n, n, generator=gen, device=dev)
            print(f"bank operands [n{n}], edge layer {li}: qk {tuple(qk.shape)}, W1 "
                  f"{tuple(ws[0].shape)}, ds {ds}", flush=True)
            for bf16 in (True, False):
                sfx = f"[L{li}]" + ("" if bf16 else "[f32]") + f"[n{n}]"
                results["attn_qk_bank" + sfx], results["attn_qk_bank_bwd" + sfx] = (
                    qk_bank_phase("K8 attn_qk_bank" + sfx, qk, ws, g, ds, bf16,
                                  3e-3 if bf16 else 1e-4, reps=LARGE_REPS))
    gen = torch.Generator(device=dev).manual_seed(17)
    c, a, f = 8, 32, 16
    ws = [torch.randn(sh, device=dev, generator=gen) / (sh[-2] ** 0.5 if len(sh) == 3 else 4.0)
          for sh in [(c, f, a), (c, a), (c, a, a), (c, a)] * 2]
    qk = torch.randn(2, 256, f, device=dev, generator=gen).bfloat16()
    g = torch.randn(2, c, 256, 256, device=dev, generator=gen)
    runs = {plan: (lambda p=plan: k8._launch_bwd(qk, ws, g, 4, True, plan=p))
            for plan in ("block", "tiled")}
    times = {"block": [], "tiled": []}
    saved = [k.launches for k in _counters()]
    with torch.no_grad():
        for plan in ("block", "tiled", "tiled", "block"):
            times[plan].append(device_ms(runs[plan]))
        outs = {plan: run() for plan, run in runs.items()}
    for k, n_ in zip(_counters(), saved):
        k.launches = n_
    check(torch.equal(outs["block"][0], outs["tiled"][0]),
          "K8 backward at N = 256: the tiled plan's dqk differs from the block plan's")
    results["n_256_b_2_bwd_plans"] = {"block_device_ms": times["block"],
                                     "tiled_device_ms": times["tiled"]}
    print(f"K8 backward N=256 B=2 bf16 (edge layer 1 widths, seeded), device_ms in turns "
          f"block / tiled / tiled / block: {times['block'][0]:.4f} / {times['tiled'][0]:.4f} / "
          f"{times['tiled'][1]:.4f} / {times['block'][1]:.4f}; the wrapper takes the "
          f"{k8.plan_of(256, f, c, a, 8, True, 2)} plan there; dqk bit for bit", flush=True)
    return results


def sampler_chain_n1024(dev):
    """The 2D->3D sampler chain at --n_max 1024, B = 2 (one molecule x 2
    repeats, the sampler CLI's widths, 20 PC steps x 1 corrector step): K1
    forward 5 (the ranges plan) and K3 forward 1, positions finite with the
    padded rows exactly 0; its conditioning against an all-plain build of
    the same weights at phase 3's bars."""
    from moleculesde_tpu_torch.benchmarks.profile_sampler import PATH_ARGS
    from moleculesde_tpu_torch.examples import sample_2d_to_3d as cli

    args = cli.get_parser().parse_args(PATH_ARGS + [
        "--n_max", "1024", "--end", "1", "--sample_mols_per_batch", "1",
        "--num_repeat_SDE_inference", "2"])
    batch = cli.make_batch(cli.load_graphs(args)[:1], args, dev)
    model_2d, sde_model = cli.build_models(args, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    reset_counts()
    t0 = time.perf_counter()
    pos = cli.generate(model_2d, sde_model, batch, gen, args)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    launches = read_counts()
    print(f"n_max 1024 sampler chain (B={batch.num_graphs}): launches {launches}; wall_ms="
          f"{chain_s * 1e3:.2f}", flush=True)
    check(launches == expect(gin_messages=args.num_layer, pair_relu_project=1),
          f"n_max 1024 sampler chain launch counts {launches}")
    check(tuple(pos.shape) == (batch.num_nodes, 3) and bool(torch.isfinite(pos).all()),
          "n_max 1024 sampler chain: positions")
    check(bool((pos[~batch.node_mask] == 0).all()), "n_max 1024: padded rows are not 0")
    saved = [k.launches for k in _counters()]
    with torch.no_grad():
        node_2d = model_2d(batch, use_running_average=True)
        plain_2d, plain_sde = cli.build_models(args, dev, msg_impl="plain", pair_impl="plain")
        cond_k = sde_model.precompute_conditioning(node_2d, batch, layout="channel")
        node_p = plain_2d(batch, use_running_average=True)
        cond_p = plain_sde.precompute_conditioning(node_p, batch, layout="channel")
    for k, n_ in zip(_counters(), saved):
        k.launches = n_
    node_err = (node_2d - node_p).abs().max().item()
    edge_err = (cond_k["edge_attr_2d"].float() - cond_p["edge_attr_2d"].float()
                ).abs().max().item()
    node_scale = max(1.0, node_p.abs().max().item())
    edge_scale = max(1.0, cond_p["edge_attr_2d"].float().abs().max().item())
    print(f"n_max 1024 conditioning vs plain: node_2d max_abs_err={node_err:.3e} (tolerance "
          f"{1e-4 * node_scale:.3e}); edge_attr_2d max_abs_err={edge_err:.3e} (tolerance "
          f"{2 ** -8 * edge_scale:.3e})", flush=True)
    check(node_err <= 1e-4 * node_scale, "n_max 1024: node_2d disagrees with the plain path")
    check(edge_err <= 2 ** -8 * edge_scale,
          "n_max 1024: edge_attr_2d disagrees with the plain path")
    return launches


def _bank_step(dev, cfg, models, batch, seed: int, impl: str = "fused", precision=None,
               bank_impl: str = "auto"):
    """One step's loss terms and the 3D->2D edge network's q / k gradient
    leaves on a copy of ``models`` with the ``impl`` bank, in ``precision``
    (the config's by default); ``bank_impl`` "plain" gives the 3D->2D
    model (whose only kernels are the bank's) the plain versions, the
    other components keeping their kernels."""
    from moleculesde_tpu_torch.pretrain.train_state import build_models
    from moleculesde_tpu_torch.pretrain.train_step import draw_losses, pretrain_loss

    cfg_ = dataclasses.replace(cfg, attn_impl_3dto2d=impl,
                               train_precision=precision or cfg.train_precision)
    ms = build_models(cfg_, dev)
    if bank_impl != "auto":
        ms["SDE_3Dto2D_model"] = build_models(cfg_, dev, impl=bank_impl)["SDE_3Dto2D_model"]
    for name in models:
        ms[name].load_state_dict(models[name].state_dict())
    g = torch.Generator(device=dev).manual_seed(seed)
    total, mets = pretrain_loss(ms, cfg_, batch, g, draws=draw_losses(ms, cfg_, batch, g))
    total.backward()
    return ({k: v.item() for k, v in mets.items()},
            {n: p.grad.detach().float().clone()
             for n, p in ms["SDE_3Dto2D_model"].edge_score_network.named_parameters()
             if ".attn.q_" in n or ".attn.k_" in n})


def _bank_reading(label, mine, ref, leaf_tol, tol: float = 1e-3) -> float:
    """Loss terms (relative, ``tol``) and q / k leaves (relative L2,
    ``leaf_tol``) of two bank steps, checked; returns the worst leaf."""
    (mm, lm), (mr, lr) = mine, ref
    for k in mm:
        err = abs(mm[k] - mr[k]) / max(1e-6, abs(mr[k]))
        check(err <= tol, f"{label}: {k} {mm[k]:.6f} vs {mr[k]:.6f} ({err:.2e} > {tol:g})")
    check(sorted(lm) == sorted(lr), f"{label}: leaves {sorted(lm)}")
    errs = {k: ((lm[k] - lr[k]).norm() / lr[k].norm().clamp(min=1e-30)).item() for k in lm}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    print(f"{label}: loss terms within {tol:g}; {len(errs)} q / k leaves, relative L2 "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst[:3]) + f" ... (tolerance {leaf_tol:g})",
          flush=True)
    for k, v in worst:
        check(v <= leaf_tol, f"{label}: gradient of {k} disagrees ({v:.3e})")
    return worst[0][1]


def fused_bank_steps(dev, args, cfg, models, batches, leaf_tol, label: str) -> dict:
    """Two pretraining steps with the "fused" bank (K8 forward and backward
    once per edge layer, K1-K3 as before), a third under the profiler and
    the peak memory; then one step against its reference builds at phase
    13's bars (losses 1e-3, q / k leaves ``leaf_tol``): in bf16 against the
    same step with K8's plain version (which rounds where the kernel
    rounds; the other components keep their kernels), in f32 against the
    "auto" build.  At this N the bf16 step's q / k leaves are ill
    conditioned: the "auto" form (which rounds its logits and tanh to
    bf16), or plain versions of K1-K3 upstream, move them by more than
    their own size, so those bf16 steps are no reference for K8's; the
    bf16 steps of both forms are held to lie within 1.25x of each other's
    distance from the f32 "auto" step.  Returns the launch counts of the
    two steps."""
    from moleculesde_tpu_torch.pretrain.train_state import build_models, make_optimizer
    from moleculesde_tpu_torch.pretrain.train_step import METRICS, pretrain_step

    steps = 2
    layers = models["SDE_3Dto2D_model"].edge_score_network.num_layers
    ms = build_models(dataclasses.replace(cfg, attn_impl_3dto2d="fused"), dev)
    for name in models:
        ms[name].load_state_dict(models[name].state_dict())
    optimizer = make_optimizer(ms, cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    history = [pretrain_step(ms, optimizer, cfg, batch, gen) for batch in batches[1:steps + 1]]
    torch.cuda.synchronize()
    launches = read_counts()
    expected = expect(
        gin_messages=steps * cfg.num_layer, gin_messages_bwd=steps * cfg.num_layer,
        fused_cfconv=steps * cfg.schnet_num_interactions,
        fused_cfconv_bwd=steps * cfg.schnet_num_interactions,
        pair_relu_project=steps, pair_relu_project_bwd=steps,
        attn_qk_bank=steps * layers, attn_qk_bank_bwd=steps * layers)
    print(f"{label} fused bank training launches over {steps} steps: {launches} (expected "
          f"{expected})", flush=True)
    check(launches == expected, f"{label} fused bank training launch counts")
    for m in history:
        vals = {k: float(m[k]) for k in METRICS}
        check(all(math.isfinite(v) for v in vals.values()),
              f"{label} fused bank: non-finite metrics {vals}")
    saved = [c.launches for c in _counters()]
    wall, busy = profiled_ms(lambda: pretrain_step(ms, optimizer, cfg, batches[0], gen))
    print(f"{label} fused bank training, a third step under the profiler: wall_ms={wall:.2f} "
          f"device_busy_ms={busy:.2f}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB over the three steps",
          flush=True)
    del ms, optimizer
    batch, seed = batches[steps + 1], args.seed + 5
    run = functools.partial(_bank_step, dev, cfg, models, batch, seed)
    fused = run()
    _bank_reading(f"{label} fused bank step vs the same step with K8's plain version (bf16)",
                  fused, run(bank_impl="plain"), leaf_tol)
    auto_f32 = run("auto", "float32")
    _bank_reading(f"{label} fused bank step vs the auto build (f32)", run(precision="float32"),
                  auto_f32, leaf_tol)
    auto = run("auto")
    to_f32 = {}
    for name, step in (("fused", fused), ("auto", auto)):
        (_, lm), (_, lr) = step, auto_f32
        to_f32[name] = max(((lm[k] - lr[k]).norm() / lr[k].norm().clamp(min=1e-30)).item()
                           for k in lm)
    (_, lf), (_, la) = fused, auto
    fused_auto = max(((lf[k] - la[k]).norm() / la[k].norm().clamp(min=1e-30)).item()
                     for k in lf)
    print(f"{label} bf16 bank steps, worst q / k leaf from the f32 auto step: fused "
          f"{to_f32['fused']:.3e}, auto {to_f32['auto']:.3e} (each within 1.25x of the "
          f"other); fused vs auto in bf16 {fused_auto:.3e}", flush=True)
    check(to_f32["fused"] <= 1.25 * to_f32["auto"] and to_f32["auto"] <= 1.25 * to_f32["fused"],
          f"{label}: the fused bf16 step's distance from f32 {to_f32['fused']:.3e} is not within "
          f"1.25x of the auto bf16 step's {to_f32['auto']:.3e}")
    for c, n in zip(_counters(), saved):
        c.launches = n
    return launches


def large_plans_path(dev):
    """Phase 20: K1, K3 / K4's backward and K8 past the limits of the plans
    they keep inside them.  The kernels alone (large_gin_phases,
    large_pair_bwd_phases, large_qk_bank_phases); the JAX CLI's default
    pretraining path (compact ingest, K2) at --n_max 1024, B = 2: K1, K3
    and K4 on its operands (phase 13's large_n_gin_pair_phases), two steps
    (K1 5 / 5, K2 6 / 6, K3 1 / 1 a step), a profiled step and its peak
    memory, one step against an all-plain build, two steps with the
    "fused" bank (K8 4 / 4 a step) and one against its reference builds
    (fused_bank_steps), two ``pair_cm_direct`` steps (K4's backward) and
    one against the all-plain ``pair_cm_direct`` build (K4 rounds a and c
    before the add, K3 after: at this N the two forms' 2D->3D losses part
    by ~3e-3); the
    2D->3D sampler chain at --n_max 1024.  Returns ({size: kernel
    results}, K8's results, {run name: launch counts})."""
    from moleculesde_tpu_torch.benchmarks.profile_pretrain import (
        COMMON_ARGS, parse_path, path_batches)
    from moleculesde_tpu_torch.examples import pretrain as cli

    t0 = time.perf_counter()
    results = {**large_gin_phases(dev), **large_pair_bwd_phases(dev)}
    k8_results = large_qk_bank_phases(dev)
    print(f"phase 20 kernels alone: {time.perf_counter() - t0:.1f} s", flush=True)
    label = "n_max 1024"
    args = parse_path(COMMON_ARGS + ["--n_max", "1024", "--batch_size", "2"], batches=4)
    batches = path_batches(args, dev)
    cfg, models, optimizer, gen = cli.setup(args, dev)
    check(cfg.schnet_cfconv == "auto" and args.ingest == "compact",
          f"the {label} steps are not on the CLI's default path")
    results["n_1024_b_2"] = large_n_gin_pair_phases(models, batches[0], label, reps=LARGE_REPS)
    launches = {}
    counts, leaf_tol = large_n_steps(dev, args, cfg, models, optimizer, gen, batches, label,
                                     args.seed + 7)
    launches["pretrain_n_max_1024_2_steps"] = counts
    launches["pretrain_n_max_1024_fused_bank_2_steps"] = fused_bank_steps(
        dev, args, cfg, models, batches, leaf_tol, label)
    launches["pretrain_n_max_1024_pair_cm_direct_2_steps"] = pair_cm_direct_steps(
        dev, args, cfg, models, batches, leaf_tol, reference="plain")
    del models, optimizer, batches
    launches["sample_2d_to_3d_n_max_1024"] = sampler_chain_n1024(dev)
    print(f"phase 20: {time.perf_counter() - t0:.1f} s", flush=True)
    return results, k8_results, launches


# phase 21: the last shapes the JAX kernels take -- K6's layered plan past
# n_max 128 and K7's grouped plan past a block's shared memory, alone and on
# the fused 2D->3D chain at --n_max 1024 and the 3D->2D bank at adim 256

# (n_max, B) of K6's layered plan alone, on the sampler CLI's molecules
LAYERED_K6 = ((129, 2), (256, 2), (1024, 2), (2048, 1))
# (A, ds) of K7 alone at B C = 16: adim 160 / 256 / 512 of the 3D->2D
# model (H = 8) and 35 heads of 4, each past one block plan
GROUPED_K7 = ((320, 40), (512, 64), (1024, 128), (140, 4))
WIDE_ADIM = 256


def one_molecule(n_max: int, b: int) -> list:
    """Flags past the sampler CLI's PATH_ARGS: ``--n_max n_max`` and one
    synthetic molecule (of 4 to n_max atoms) cloned ``b`` times."""
    return ["--n_max", str(n_max), "--end", "1", "--sample_mols_per_batch", "1",
            "--num_repeat_SDE_inference", str(b)]


def sampler_n_args(n_max: int, b: int) -> list:
    from moleculesde_tpu_torch.benchmarks.profile_sampler import PATH_ARGS

    return PATH_ARGS + one_molecule(n_max, b)


def k6_layered_phases(dev):
    """K6 in the layered plan against its plain version at LAYERED_K6 on the
    sampler CLI's models and molecules (variants 1 and 2, bf16 2e-2 and f32
    1e-4 of max |plain|, two launches bit for bit; k6_phases), then the
    layered plan forced at n_max 32, 64 and 128 (B=64, the chain's
    operands of phases 4 and 13) against the plain version at the same
    bars, beside the cluster plan's bits there."""
    from moleculesde_tpu_torch.benchmarks.profile_sampler import PATH_ARGS
    from moleculesde_tpu_torch.examples import sample_2d_to_3d as cli

    results = {}
    for n_max, b in LAYERED_K6:
        args = cli.get_parser().parse_args(sampler_n_args(n_max, b))
        batch = cli.make_batch(cli.load_graphs(args), args, dev)
        model_2d, sde_model = cli.build_models(args, dev)
        args_v2 = cli.get_parser().parse_args(sampler_n_args(n_max, b) + [
            "--SDE_2Dto3D_model", "SDEModel2Dto3D_02"])
        with torch.no_grad():
            node_2d = model_2d(batch, use_running_average=True)
        atoms = int(batch.node_mask.sum()) // b
        print(f"K6 layered at n_max {n_max}: B={b}, a molecule of {atoms} atoms; scratch "
              f"{score_plan(n_max, True, b=b)['scratch']} B (bf16) / "
              f"{score_plan(n_max, False, b=b)['scratch']} B (f32)", flush=True)
        results.update(k6_phases({1: sde_model, 2: cli.build_models(args_v2, dev)[1]},
                                 node_2d, batch, dev, f"[n{n_max}]", reps=LARGE_REPS))
        del model_2d, sde_model, node_2d, batch
    for n_max in (32, 64, 128):
        args = cli.get_parser().parse_args(PATH_ARGS + ["--n_max", str(n_max)])
        batch = cli.make_batch(cli.load_graphs(args), args, dev)
        model_2d, model = cli.build_models(args, dev)
        b, n = batch.num_graphs, batch.n_max
        with torch.no_grad():
            node_2d = model_2d(batch, use_running_average=True)
            cond = model.precompute_conditioning(node_2d, batch, layout="feature")
            gen = torch.Generator(device=dev).manual_seed(3)
            pos = (model.sde_pos.prior_sampling(tuple(batch.positions.shape), gen, dev)
                   * batch.node_mask[:, None]).reshape(b, n, 3)
            ops = (pos, cond["node_attr"].float(), cond["edge_attr_2d"].float(),
                   cond["pair_mask"].float(), model.packed_score_params())
            for bf16 in (True, False):
                name = f"K6 layered plan forced at n_max {n_max} (B={b}, v1" + (
                    ", bf16)" if bf16 else ", f32)")
                tol = 2e-2 if bf16 else 1e-4
                run_l = lambda b_=bf16: score_eval_fused(*ops, bf16=b_, impl="kernel",  # noqa: E731
                                                        plan="layered")
                run_c = lambda b_=bf16: score_eval_fused(*ops, bf16=b_, impl="kernel",  # noqa: E731
                                                        plan="cluster")
                _, rel = compare(name, run_l, lambda b_=bf16: score_eval_fused_plain(
                    *ops, bf16=b_), tol, floor=0.0)
                same_bits(name, run_l)
                saved = [c.launches for c in _counters()]
                layered, cluster = run_l(), run_c()
                for c, v in zip(_counters(), saved):
                    c.launches = v
                diff = (layered - cluster).abs().max().item()
                print(f"{name}: max_rel_err={rel:.3e} (tolerance {tol:g} of max |plain|); "
                      f"bits equal to the cluster plan's: {torch.equal(layered, cluster)} "
                      f"(largest difference {diff:.3e})", flush=True)
                results[f"forced_layered[n{n_max}]" + ("[bf16]" if bf16 else "")] = {
                    "max_rel_err": rel, "same_bits_as_cluster": torch.equal(layered, cluster)}
    return results


def fused_chain_n1024(dev):
    """The fused 2D->3D chain (``sample_positions_pc(..., fused=True)``
    through the sampler CLI's ``generate``) at --n_max 1024, B = 2, the
    CLI's widths in bf16, 20 PC steps x 1 corrector step: K1 5, K3 1, K6 40
    (the layered plan), positions finite and padded rows exactly 0; wall
    ms, device-busy ms under the profiler and peak GiB; then 3 f32 steps
    against the channel-major chain on the same weights and draws
    (fused_f32_steps: atol 2e-4, rtol 1e-3).  Returns (launch counts,
    figures, the f32 check's K6 launches)."""
    from moleculesde_tpu_torch.examples import sample_2d_to_3d as cli

    args = cli.get_parser().parse_args(sampler_n_args(1024, 2))
    batch = cli.make_batch(cli.load_graphs(args), args, dev)
    model_2d, sde_model = cli.build_models(args, dev)
    evals = args.num_diffusion_timesteps_2Dto3D_inference * (args.steps_pos + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    reset_counts()
    t0 = time.perf_counter()
    pos = cli.generate(model_2d, sde_model, batch, gen, args, fused=True)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"fused chain at n_max 1024 (B={batch.num_graphs}, a molecule of "
          f"{int(batch.node_mask.sum()) // batch.num_graphs} atoms, bf16): launches {launches} "
          f"(expected K1 {args.num_layer}, K3 1, K6 {evals}); first run wall_ms={first_ms:.2f}, "
          f"peak {peak:.3f} GiB", flush=True)
    check(launches == expect(gin_messages=args.num_layer, pair_relu_project=1,
                             score_eval_fused=evals), f"n_max 1024 fused chain counts {launches}")
    check(tuple(pos.shape) == (batch.num_nodes, 3) and bool(torch.isfinite(pos).all()),
          "n_max 1024 fused chain: positions")
    check(bool((pos[~batch.node_mask] == 0).all()),
          "n_max 1024 fused chain: padded rows are not exactly 0")
    saved = [c.launches for c in _counters()]
    walls, busys = [], []
    for _ in range(2):   # the second reading after a warm profiler
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        wall, busy = profiled_ms(lambda: cli.generate(model_2d, sde_model, batch, gen, args,
                                                      fused=True))
        walls.append(wall)
        busys.append(busy)
    for c, v in zip(_counters(), saved):
        c.launches = v
    print(f"fused chain at n_max 1024 under the profiler: wall_ms="
          f"{' / '.join(f'{w:.2f}' for w in walls)} device_busy_ms="
          f"{' / '.join(f'{w:.2f}' for w in busys)}", flush=True)
    del model_2d, sde_model, batch, pos
    k6 = fused_f32_steps(dev, one_molecule(1024, 2), 3, "n_max 1024")
    return launches, {"first_wall_ms": first_ms, "wall_ms": walls, "device_busy_ms": busys,
                      "peak_gib": peak}, k6


def wide_3d2d_models(args, dev, kernel_impl: str, bf16_attn: bool = True):
    """(SchNet, SDEModel3Dto2D variant 1) as the 3D->2D sampler CLI builds
    them from ``args`` (``build_models``'s widths and draws), but with
    ``adim=WIDE_ADIM`` (q / k 512 wide, ds 64, H = 8 at edge layers 1-3)
    and K7 as the bank (``attn_impl="pallas"``; ``kernel_impl`` "plain"
    gives K7's plain version)."""
    from moleculesde_tpu_torch.examples import sample_3d_to_2d as cli

    t32, bmin, bmax, n_steps = cli.SDE_PRESETS_3DTO2D[args.SDE_type_3Dto2D]
    gen = torch.Generator().manual_seed(args.seed)
    encoder = cli.SchNet(hidden_channels=args.emb_dim, num_filters=args.SchNet_num_filters,
                         num_interactions=args.SchNet_num_interactions,
                         num_gaussians=args.SchNet_num_gaussians, cutoff=args.SchNet_cutoff,
                         readout=args.SchNet_readout, cfconv="xla", device=dev, generator=gen)
    model = cli.SDEModel3Dto2D(
        dim3d=args.emb_dim, c_init=2, c_hid=8, c_final=4, num_heads=4, adim=WIDE_ADIM, nhid=16,
        num_layers=4, num_linears=3, variant=cli.MODEL_3DTO2D_VARIANTS[args.SDE_3Dto2D_model],
        bf16_attn=bf16_attn, attn_impl="pallas", kernel_impl=kernel_impl, sde_type=t32,
        beta_min=bmin, beta_max=bmax, num_diffusion_timesteps=n_steps,
        noise_on_one_hot=args.noise_on_one_hot, device=dev, generator=gen)
    return encoder, model


def wide_bank_path(dev):
    """The 3D->2D bank at adim 256: the sampler CLI's models and batch
    (SchNet 6 x 128, B=128, n_max 32) with SDEModel3Dto2D's ``adim=256,
    num_heads=4`` and K7 as the bank.  The bf16 chain of 20 PC x 2
    corrector steps (K7 forward 4 an edge-network evaluation, the grouped
    forward at layers 1-3) finite with padded rows 0, its wall ms; the same
    chain in f32 against the one with K7's plain version, same weights and
    draws (atol 2e-4, rtol 1e-3); the 3D->2D SDE loss and its backward on
    the batch (K7 forward and backward 4 each) against K7's plain version:
    loss terms (f32 1e-5, bf16 1e-3 relative), the gradient of the 3D
    representation and of every q / k net leaf (relative L2, f32 1e-4, bf16
    5e-2).  Returns ({run: launch counts}, figures)."""
    from moleculesde_tpu_torch.benchmarks.profile_sampler_3d2d import (
        CORRECTOR_STEPS, EDGE_EVALS, N_STEPS, PATH_ARGS, path_batch)
    from moleculesde_tpu_torch.examples import sample_3d_to_2d as cli
    from moleculesde_tpu_torch.sampling.pc import sample_graph_pc

    args = cli.get_parser().parse_args(PATH_ARGS)
    batch = path_batch(args, dev)
    encoder, model = wide_3d2d_models(args, dev, "auto")
    layers = model.edge_score_network.num_layers
    b, n, c = batch.num_graphs, batch.n_max, model.num_class_x
    launches, figures = {}, {}
    reset_counts()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, x_mean, adj_mean = cli.generate(encoder, model, batch, gen, args)
    torch.cuda.synchronize()
    figures["chain_wall_ms"] = (time.perf_counter() - t0) * 1e3
    launches["sample_3d_to_2d_pallas_adim_256"] = read_counts()
    print(f"3D->2D chain at adim {WIDE_ADIM} (K7 at A = {2 * WIDE_ADIM}, B={b}, {N_STEPS} x "
          f"{CORRECTOR_STEPS} steps, bf16): launches "
          f"{launches['sample_3d_to_2d_pallas_adim_256']}, wall_ms="
          f"{figures['chain_wall_ms']:.2f}", flush=True)
    check(launches["sample_3d_to_2d_pallas_adim_256"] == expect(
        attn_map_bank_kernel=EDGE_EVALS * layers), "adim 256 chain launch counts")
    pad = ~batch.node_mask.reshape(b, n).cpu()
    check(bool(torch.isfinite(x_mean).all() and torch.isfinite(adj_mean).all()),
          "adim 256 chain: non-finite graphs")
    check(bool((adj_mean.cpu()[pad] == 0).all()), "adim 256 chain: padded rows")

    # the f32 chain, K7 against its plain version on the same weights and draws
    gen = torch.Generator(device=dev).manual_seed(13)
    per_step = (1 + CORRECTOR_STEPS) * (b * n * c + b * n * n)
    draws = {"x_prior": torch.randn((b, n, c), generator=gen, device=dev),
             "adj_prior": torch.randn((b, n, n), generator=gen, device=dev),
             "noise": torch.randn((N_STEPS, per_step), generator=gen, device=dev)}
    outs = {}
    saved = [cnt.launches for cnt in _counters()]
    with torch.no_grad():
        _, node_3d = encoder.encode_batch(batch)
        for impl in ("auto", "plain"):
            m32 = wide_3d2d_models(args, dev, impl, bf16_attn=False)[1]
            outs[impl] = sample_graph_pc(m32, node_3d, batch, n_steps=N_STEPS,
                                         corrector_steps=CORRECTOR_STEPS, **draws)
    torch.cuda.synchronize()
    for cnt, v in zip(_counters(), saved):
        cnt.launches = v
    for idx, name in ((2, "x_mean"), (3, "adj_mean")):
        mine, ref = outs["auto"][idx], outs["plain"][idx]
        excess = ((mine - ref).abs() - (2e-4 + 1e-3 * ref.abs())).max().item()
        figures[f"chain_f32_{name}_max_abs_err"] = (mine - ref).abs().max().item()
        print(f"3D->2D chain at adim {WIDE_ADIM}, f32, {N_STEPS} x {CORRECTOR_STEPS} steps, "
              f"K7 against its plain version: {name} max_abs_err="
              f"{figures[f'chain_f32_{name}_max_abs_err']:.3e} (tolerance atol 2e-4 + rtol "
              f"1e-3; largest excess {excess:.3e})", flush=True)
        check(excess <= 0.0, f"adim 256 f32 chain: {name} disagrees with K7's plain version")

    # the SDE loss and its backward, K7 against its plain version
    for bf16_attn, tol_loss, tol_grad in ((False, 1e-5, 1e-4), (True, 1e-3, 5e-2)):
        mode = "bf16" if bf16_attn else "f32"
        with torch.no_grad():
            _, node_3d = encoder.encode_batch(batch)
        draws = wide_3d2d_models(args, dev, "plain", bf16_attn)[1].draw(
            batch, torch.Generator(device=dev).manual_seed(31))
        got = {}
        for impl in ("auto", "plain"):
            m = wide_3d2d_models(args, dev, impl, bf16_attn)[1]
            n3d = node_3d.detach().clone().requires_grad_(True)
            reset_counts()
            lx, ladj = m.loss(n3d, batch, draws=draws)
            (0.5 * (lx + ladj)).backward()
            torch.cuda.synchronize()
            if impl == "auto":
                launches[f"loss_3d_to_2d_pallas_adim_256_{mode}"] = read_counts()
            leaves = {name: p.grad for name, p in m.named_parameters()
                      if ".q_" in name or ".k_" in name}
            check(len(leaves) > 0 and all(v is not None for v in leaves.values()),
                  "adim 256 loss: the q / k nets' gradient leaves")
            got[impl] = (lx.item(), ladj.item(), n3d.grad, leaves)
        counts = launches[f"loss_3d_to_2d_pallas_adim_256_{mode}"]
        check(counts == expect(attn_map_bank_kernel=layers, attn_map_bank_kernel_bwd=layers),
              f"adim 256 loss ({mode}) launch counts {counts}")
        (lx_k, la_k, g_k, leaves_k), (lx_p, la_p, g_p, leaves_p) = got["auto"], got["plain"]
        loss_err = max(abs(lx_k - lx_p) / abs(lx_p), abs(la_k - la_p) / abs(la_p))
        rel = lambda u, v: ((u - v).norm() / v.norm()).item()  # noqa: E731
        grad_err = max([rel(g_k, g_p)] + [rel(leaves_k[k], leaves_p[k]) for k in leaves_p])
        figures[f"loss_{mode}"] = {"loss_rel_err": loss_err, "grad_rel_l2": grad_err,
                                   "losses": [lx_k, la_k]}
        print(f"3D->2D loss at adim {WIDE_ADIM} ({mode}), K7 forward / backward {counts}: "
              f"loss terms {lx_k:.6f} / {la_k:.6f}, against K7's plain version {loss_err:.3e} "
              f"(tolerance {tol_loss:g}); the 3D representation's and {len(leaves_p)} q / k "
              f"leaves' gradients {grad_err:.3e} relative L2 (tolerance {tol_grad:g})",
              flush=True)
        check(loss_err <= tol_loss, f"adim 256 loss ({mode}) disagrees with K7's plain version")
        check(grad_err <= tol_grad,
              f"adim 256 gradients ({mode}) disagree with K7's plain version")
    return launches, figures


def k7_grouped_phases(dev):
    """K7, forward and backward, at GROUPED_K7 on seeded operands (B C =
    2 x 8 at N = 32, 1 x 16 at N = 600), against the plain versions at
    bank_kernel_phases's bars (bf16 3e-3, its maps also 1e-4; f32 1e-4),
    each kernel two runs bit for bit; then the groups forced at the
    chain's A = 32 (2, 4 and 8 forward slices, the grouped backward) on the
    chain-width seeded operands at N = 32 and 600: the block plans' bits."""
    results = {}
    for a, ds in GROUPED_K7:
        for n, b, c in ((32, 2, 8), (600, 1, 16)):
            gen = torch.Generator(device=dev).manual_seed(a + n)
            q32, k32 = (0.8 * torch.randn(b, c, n, a, device=dev, generator=gen)
                        for _ in range(2))
            ops = {"q": q32.bfloat16(), "k": k32.bfloat16(), "q32": q32, "k32": k32, "ds": ds}
            for bwd in (False, True):
                print(f"K7 plan at A={a}, ds={ds}, N={n}, {'backward' if bwd else 'forward'}: "
                      f"(rows, shared bytes, groups) = {k7_plan(n, a, a // ds, bwd, bc=b * c)}",
                      flush=True)
            results.update(bank_kernel_phases([ops], f"[a{a}][n{n}]", reps=LARGE_REPS))
    for n, b in ((32, 16), (600, 1)):
        gen = torch.Generator(device=dev).manual_seed(23 + n)
        q32, k32 = (0.8 * torch.randn(b, 8, n, 32, device=dev, generator=gen) for _ in range(2))
        g = torch.randn(b, 8, n, n, device=dev, generator=gen)
        for q, k, bf16 in ((q32.bfloat16(), k32.bfloat16(), True), (q32, k32, False)):
            with torch.no_grad():
                saved = [cnt.launches for cnt in _counters()]
                fwd = attn_map_bank_kernel(q, k, 4, bf16=bf16, impl="kernel", groups=1)
                bwd = attn_map_bank_kernel_bwd(q, k, g, 4, bf16=bf16, impl="kernel", groups=1)
                for groups in (2, 4, 8):
                    check(torch.equal(fwd, attn_map_bank_kernel(
                        q, k, 4, bf16=bf16, impl="kernel", groups=groups)),
                        f"K7 forward in {groups} slices at N={n}: not the block plan's bits")
                    other = attn_map_bank_kernel_bwd(q, k, g, 4, bf16=bf16, impl="kernel",
                                                     groups=groups)
                    check(all(torch.equal(u, v) for u, v in zip(bwd, other)),
                          f"K7 grouped backward at N={n}: not the block plan's bits")
                torch.cuda.synchronize()
                for cnt, v in zip(_counters(), saved):
                    cnt.launches = v
            print(f"K7 at A=32, N={n}, B C={b * 8} ({'bf16' if bf16 else 'f32'}): the forward "
                  "in 2, 4 and 8 slices and the grouped backward give the block plans' bits",
                  flush=True)
    return results


def last_shapes_path(dev):
    """Phase 21: K6's layered plan alone (k6_layered_phases) and on the fused
    chain at --n_max 1024 (fused_chain_n1024); K7's grouped plan alone
    (k7_grouped_phases) and on the 3D->2D bank at adim 256
    (wide_bank_path).  Returns (kernel results, {run: launch counts},
    figures)."""
    t0 = time.perf_counter()
    results = {**k6_layered_phases(dev), **k7_grouped_phases(dev)}
    print(f"phase 21 kernels alone: {time.perf_counter() - t0:.1f} s", flush=True)
    chain_launches, chain_figures, k6_f32 = fused_chain_n1024(dev)
    bank_launches, bank_figures = wide_bank_path(dev)
    launches = {"sample_2d_to_3d_fused_n_max_1024": chain_launches, **bank_launches}
    figures = {"fused_chain_n_max_1024": {**chain_figures, "f32_3_steps_k6_launches": k6_f32},
               "bank_adim_256": bank_figures, "seconds": time.perf_counter() - t0}
    print(f"phase 21: {figures['seconds']:.1f} s", flush=True)
    return results, launches, figures


# phase 22: K6 at every width the JAX kernel takes -- the fused 2D->3D chain
# with the 2D->3D model 64 and 128 wide, and K6 alone over k6_widths' grid

WIDE_HIDDEN = (64, 128)


def wide_fused_chain(dev, hidden: int):
    """The fused 2D->3D chain (``sample_positions_pc(..., fused=True)``
    through the sampler CLI's ``generate``) at the CLI's widths (GIN 5 x 300,
    SDEModel2Dto3D_01, VE, bf16 score, B=64, n_max 32, 20 PC x 1 corrector
    step) with the 2D->3D model ``hidden`` wide (``build_models``'
    ``hidden_dim``; the CLI's is 32): K1 5, K3 1, K6 40 (the layered plan),
    positions finite and padded rows exactly 0, wall ms of a second run; K6
    against its plain version on the chain's operands, variants 1 and 2,
    bf16 and f32 at phase 4's bars (k6_phases); 3 f32 steps against the
    channel-major chain (fused_f32_steps).  Returns (kernel results, launch
    counts, figures)."""
    from moleculesde_tpu_torch.benchmarks.profile_sampler import PATH_ARGS
    from moleculesde_tpu_torch.examples import sample_2d_to_3d as cli

    args = cli.get_parser().parse_args(PATH_ARGS)
    batch = cli.make_batch(cli.load_graphs(args), args, dev)
    model_2d, sde_model = cli.build_models(args, dev, hidden_dim=hidden)
    evals = args.num_diffusion_timesteps_2Dto3D_inference * (args.steps_pos + 1)
    for bf16 in (True, False):
        plan = score_plan(batch.n_max, bf16, b=batch.num_graphs, h=hidden)
        check(plan["plan"] == "layered", f"K6 at hidden {hidden}: plan {plan}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    reset_counts()
    pos = cli.generate(model_2d, sde_model, batch, gen, args, fused=True)
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches == expect(gin_messages=args.num_layer, pair_relu_project=1,
                             score_eval_fused=evals),
          f"hidden {hidden} fused chain counts {launches}")
    check(tuple(pos.shape) == (batch.num_nodes, 3) and bool(torch.isfinite(pos).all()),
          f"hidden {hidden} fused chain: positions")
    check(bool((pos[~batch.node_mask] == 0).all()),
          f"hidden {hidden} fused chain: padded rows are not exactly 0")
    saved = [c.launches for c in _counters()]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    cli.generate(model_2d, sde_model, batch, gen, args, fused=True)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    for c, v in zip(_counters(), saved):
        c.launches = v
    print(f"fused chain with the 2D->3D model {hidden} wide (B={batch.num_graphs}, n_max "
          f"{batch.n_max}, bf16, 20 x 1): launches {launches} (expected K1 {args.num_layer}, "
          f"K3 1, K6 {evals}); wall_ms={wall:.2f} (second run)", flush=True)
    args_v2 = cli.get_parser().parse_args(PATH_ARGS + ["--SDE_2Dto3D_model",
                                                       "SDEModel2Dto3D_02"])
    with torch.no_grad():
        node_2d = model_2d(batch, use_running_average=True)
    results = k6_phases({1: sde_model, 2: cli.build_models(args_v2, dev, hidden_dim=hidden)[1]},
                        node_2d, batch, dev, f"[h{hidden}]")
    del model_2d, sde_model, batch, pos, node_2d
    k6 = fused_f32_steps(dev, [], 3, f"hidden {hidden}", hidden=hidden)
    return results, launches, {"wall_ms": wall, "f32_3_steps_k6_launches": k6}


def k6_width_grid(dev):
    """K6 alone at every case of ``benchmarks/k6_widths.py``'s WIDTH_GRID
    (hidden 8-128, 1-8 heads, basis widths 32-256, (L, C) = (2, 2), (1, 3),
    (3, 2), n_max 8-1024), variants 1 and 2, bf16 and f32 at f32 1e-5 and
    bf16 2e-2 of max |plain|, two launches bit for bit; the case at hidden
    128, n_max 1024, B = 2 also timed beside its bound (report, LARGE_REPS)
    and its matmul_flops held to the plain version's.  Returns {name:
    result}."""
    from moleculesde_tpu_torch.benchmarks.k6_widths import (
        TOL, WIDTH_GRID, case_name, check_case, width_operands)

    results, worst = {}, {False: 0.0, True: 0.0}
    for case in WIDTH_GRID:
        for variant in (1, 2):
            for bf16 in (False, True):
                name = case_name(case, variant, bf16)
                saved = [c.launches for c in _counters()]
                r = check_case(dev, case, variant, bf16)
                for c, v in zip(_counters(), saved):
                    c.launches = v
                worst[bf16] = max(worst[bf16], r["max_rel_err"])
                print(f"{name}: plan {r['plan']} max_rel_err={r['max_rel_err']:.3e} (tolerance "
                      f"{TOL[bf16]:g} of max |plain|) same_bits={r['same_bits']}", flush=True)
                check(r["plan"] == "layered" and r["ok"], f"{name}: {r}")
    h, heads, cd, layers, convs, n, b = WIDTH_GRID[-1]
    ops = width_operands(dev, b, n, h, cd, layers, convs, 1, seed=h + n + 1)
    nbytes, flops = k6_cost(b, n, 1, h, cd, layers, convs)
    for bf16 in (True, False):
        name = "score_eval_fused[v1]" + ("[bf16]" if bf16 else "") + f"[h{h}][n{n}]"
        kw = dict(bf16=bf16, num_layers=layers, num_convs=convs, n_head=heads)
        with torch.no_grad():
            run_k = lambda kw=kw: score_eval_fused(*ops, impl="kernel", **kw)  # noqa: E731
            run_p = lambda kw=kw: score_eval_fused_plain(*ops, coff_dim=cd, **kw)  # noqa: E731
            err, rel = compare("K6 " + name, run_k, run_p, TOL[bf16], floor=0.0)
            results[name] = report("K6 " + name, err, TOL[bf16], run_k, run_p, nbytes, flops,
                                   PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS, floor=0.0,
                                   reps=LARGE_REPS)
            results[name]["max_rel_err"] = rel
    results["grid"] = {"cases": len(WIDTH_GRID) * 4, "worst_rel_err_f32": worst[False],
                       "worst_rel_err_bf16": worst[True]}
    return results


def widths_path(dev):
    """Phase 22: the fused chain with the 2D->3D model 64 and 128 wide
    (wide_fused_chain) and K6 alone over the width grid (k6_width_grid).
    Returns (kernel results, {run: launch counts}, figures)."""
    t0 = time.perf_counter()
    results, launches, figures = {}, {}, {}
    for hidden in WIDE_HIDDEN:
        res, counts, figs = wide_fused_chain(dev, hidden)
        results.update(res)
        launches[f"sample_2d_to_3d_fused_hidden_{hidden}"] = counts
        figures[f"fused_chain_hidden_{hidden}"] = figs
    results.update(k6_width_grid(dev))
    figures["seconds"] = time.perf_counter() - t0
    print(f"phase 22: {figures['seconds']:.1f} s", flush=True)
    return results, launches, figures


def _hmma_per_function(build, source: str) -> dict:
    """{kernel function: HMMA instructions} of a built library's SASS
    (``cuobjdump -sass``, split at its ``Function :`` headers)."""
    import shutil
    from pathlib import Path

    cuobjdump = shutil.which("cuobjdump") or str(Path(build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(build._library_path(source))],
                          capture_output=True, text=True, timeout=300).stdout
    per_function, current = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            current = ln.split("Function :", 1)[1].strip()
            per_function[current] = 0
        elif current is not None and "HMMA" in ln:
            per_function[current] += 1
    return per_function


def ptxas_functions(report: str) -> dict:
    """{kernel function: (registers, spill store bytes, spill load bytes)}
    from nvcc's ``-Xptxas -v`` report of one source."""
    import re

    out, current = {}, None
    for ln in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", ln)
        if m:
            current = m.group(1)
            out.setdefault(current, [0, 0, 0])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and current:
            out[current][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", ln)
        if m and current:
            out[current][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def no_spills(reports: dict) -> None:
    """K6's four-chunk instantiations (n_max 65-128, both modes) and K7's
    block forward and backward (both input types each) hold everything in
    registers: no spill.  (K7's sliced forward and K6's layered passes,
    which run only past the old plans, are printed with the rest.)"""
    for source, pick, count in (
            ("score_eval", lambda f: "score_eval_kernel" in f and "Li4E" in f, 2),
            ("attn_bank", lambda f: "attn_map_bank_fwd_kernel" in f and "Lb0E" in f, 2),
            ("attn_bank", lambda f: "attn_map_bank_bwd_kernel" in f, 2)):
        fns = {f: v for f, v in ptxas_functions(reports[source]).items() if pick(f)}
        print(f"{source}: registers / spill stores / spill loads {fns}", flush=True)
        check(len(fns) == count,
              f"{source}: the instantiations were not found in the nvcc report")
        check(all(v[1] == 0 and v[2] == 0 for v in fns.values()), f"{source} spills: {fns}")
    layered = {f: v for f, v in ptxas_functions(reports["score_layered"]).items()
               if any(k in f for k in ("front", "gat", "basis", "node", "weights"))}
    print(f"score_layered: registers / spill stores / spill loads {layered}", flush=True)
    check(len(layered) == 10, f"score_layered: the passes were not found in the nvcc report "
                              f"({sorted(layered)})")


def tensor_core_note(build) -> None:
    """The bf16 products of the CFConv kernels, of K6 (both plans), of the
    pair block's forward and backward (K3 and K4) and K8's backward weight
    gradients run on the tensor cores: each source issues mma.sync through
    ``hopper.cuh``'s ``mma_bf16``, and the built libraries' SASS holds HMMA
    in the CFConv forward's and backward's functions, in every bf16
    instantiation of K6 (``score_eval_kernel<true, S>`` and the layered
    plan's front, GAT and basis passes), of the pair
    block's two directions (``pair_relu_project_{fwd,bwd}_kernel<CM, true,
    ...>``) and of K8's backward (``attn_qk_bank_bwd_kernel<T, true>``), and
    in none of their f32 instantiations."""
    check("mma.sync.aligned.m16n8k16" in (build.CSRC_DIR / "hopper.cuh").read_text(),
          "hopper.cuh issues no mma.sync")
    for source in ("cfconv.cu", "score_eval.cu", "score_layered.cu", "pair_block.cu"):
        check("mma_bf16(" in (build.CSRC_DIR / source).read_text(),
              f"{source} issues no mma.sync (hopper.cuh's mma_bf16)")
    per_function = _hmma_per_function(build, "cfconv")
    counts = {}
    for kernel in ("cfconv_fwd_kernel", "cfconv_bwd_kernel"):
        fns = {name: k for name, k in per_function.items() if kernel in name}
        counts[kernel] = sum(fns.values())
        print(f"cfconv SASS: {kernel}: {counts[kernel]} HMMA over {len(fns)} functions "
              f"({sum(k > 0 for k in fns.values())} with HMMA: the bf16-mode "
              f"instantiations)", flush=True)
    check(counts["cfconv_fwd_kernel"] > 0, "the CFConv forward's SASS holds no HMMA instruction")
    check(counts["cfconv_bwd_kernel"] > 0, "the CFConv backward's SASS holds no HMMA instruction")
    per_function = _hmma_per_function(build, "score_eval")
    k6 = {name: k for name, k in per_function.items() if "score_eval_kernel" in name}
    bf16_fns = {name: k for name, k in k6.items() if "score_eval_kernelILb1E" in name}
    print(f"score_eval SASS: {sum(k6.values())} HMMA over {len(k6)} functions; the bf16 "
          f"instantiations: {sorted(bf16_fns.values())}", flush=True)
    check(len(bf16_fns) == 3 and all(k > 0 for k in bf16_fns.values()),
          f"a bf16 instantiation of K6 holds no HMMA instruction ({bf16_fns})")
    check(sum(k6.values()) == sum(bf16_fns.values()), "K6's f32 mode issues HMMA")
    layered = {}   # K6's layered plan: HMMA of each pass in each mode
    for name, k in _hmma_per_function(build, "score_layered").items():
        for kernel in ("layered_front_kernel", "layered_gat_kernel", "layered_basis_kernel"):
            if kernel in name:
                layered[(kernel, "bf16" if "ILb1E" in name else "f32")] = k
    print(f"score_layered SASS: HMMA per pass and mode {layered}", flush=True)
    check(len(layered) == 6, f"K6's layered passes not found in the SASS ({layered})")
    check(all(k > 0 for (_, mode), k in layered.items() if mode == "bf16"),
          "a bf16 pass of K6's layered plan holds no HMMA instruction")
    check(sum(k for (_, mode), k in layered.items() if mode == "f32") == 0,
          "an f32 pass of K6's layered plan issues HMMA")
    per_function = _hmma_per_function(build, "pair_block")
    for kernel, what in (("pair_relu_project_bwd_kernel", "backward"),
                         ("pair_relu_project_fwd_kernel", "forward")):
        pair = {}   # HMMA of each (K3 / K4, mode), over its instantiations (chunk, TS)
        for name, k in per_function.items():
            if kernel in name:
                for flags, label in (("ILb0ELb1E", "K3 bf16"), ("ILb1ELb1E", "K4 bf16"),
                                     ("ILb0ELb0E", "K3 f32"), ("ILb1ELb0E", "K4 f32")):
                    if flags in name:
                        pair.setdefault(label, []).append(k)
        print(f"pair_block SASS: {what} HMMA per instantiation {pair}", flush=True)
        check(len(pair) == 4, f"the pair block's {what} instantiations not found ({pair})")
        check(all(k > 0 for k in pair["K3 bf16"] + pair["K4 bf16"]),
              f"a bf16 instantiation of the pair block's {what} holds no HMMA instruction")
        check(sum(pair["K3 f32"] + pair["K4 f32"]) == 0,
              f"an f32 instantiation of the pair block's {what} issues HMMA")
    k8 = {name: k for name, k in _hmma_per_function(build, "attn_qk_bank").items()
          if "attn_qk_bank_bwd_kernel" in name}
    modes = {"bf16": [k for name, k in k8.items() if "Lb1E" in name],
             "f32": [k for name, k in k8.items() if "Lb0E" in name]}
    print(f"attn_qk_bank SASS: K8 backward HMMA per instantiation {modes}", flush=True)
    check(len(modes["bf16"]) == 4 and len(modes["f32"]) == 4,
          f"K8 backward's instantiations not found ({k8})")
    check(all(k > 0 for k in modes["bf16"]),
          "a bf16 instantiation of K8's backward holds no HMMA instruction")
    check(sum(modes["f32"]) == 0, "an f32 instantiation of K8's backward issues HMMA")


def full_f32() -> None:
    """f32 products in full f32 (no TF32), for the plain versions and the
    references; every process of the script (the ranks that it spawns too)
    sets it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from moleculesde_tpu_torch.kernels import build

    full_f32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
            f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card, flush=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # 1. build every kernel, one nvcc per source, in parallel
    t0 = time.perf_counter()
    reports = build.build()
    for name, report_ in reports.items():
        regs = [ln.strip() for ln in report_.splitlines() if "registers" in ln or "spill" in ln]
        print(f"built {name}: {'; '.join(regs)}", flush=True)
    print(f"kernel build {time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("score_eval", "score_layered", "attn_bank"):   # built before: again for the report
        if name not in reports:
            build._library_path(name).unlink()
            reports.update(build.build([name]))
    no_spills(reports)
    tensor_core_note(build)

    def done(what):
        print(f"[{time.perf_counter() - t0:.1f} s] {what} done", flush=True)

    sampler_results, sampler_launches = sampler_path(dev)
    fused_results, fused_launches, _ = fused_chain_path(dev)
    cm_chain_launches = pair_cm_direct_chain(dev)
    done("2D->3D chains (phases 2-5)")
    bank_results, chain_3d2d_launches = chain_3d2d_path(dev)
    done("3D->2D chain (phase 6)")
    train_results, train_launches, cm_train_launches, bank_train_launches = training_path(dev)
    k5_results, compact_launches = compact_training_path(dev)
    train_results.update(k5_results)
    microbatch_launches = microbatch_steps(dev)
    painn_launches = painn_steps(dev)
    done("pretraining at n_max 32 (phases 7-12)")
    large_n_results, large_n_launches = large_n_path(dev)
    done("n_max 64 / 128 (phase 13)")
    bucket_results, bucket_launches, bucket_figures = bucketed_cli_path(dev, card)
    large_n_results["n_max_16"] = bucket_results
    done("buckets, resume and native collation (phase 14)")
    finetune_results, finetune_launches, finetune_rates = finetune_path(dev, card)
    done("finetunes (phase 15)")
    surface_results, surface_launches = model_surface_path(dev, card)
    done("model surface (phase 16)")
    packed_launches, packed_figures = packed_path(dev, card)
    done("the CLIs on a packed cache (phase 17)")
    dp_launches, dp_figures = data_parallel_path(dev, card)
    done("data parallelism (phase 18)")
    util_launches, util_figures = utilities_path(dev, card)
    done("the utilities (phase 19)")
    large_plan_results, k8_large, large_plan_launches = large_plans_path(dev)
    large_n_results.update(large_plan_results)
    done("every N the JAX kernels take (phase 20)")
    last_results, last_launches, last_figures = last_shapes_path(dev)
    done("the last shapes the JAX kernels take (phase 21)")
    wide_results, wide_launches, wide_figures = widths_path(dev)
    done("K6 at every width the JAX kernel takes (phase 22)")
    device_time_phase()
    done("device times")
    print(f"matmul_flops with the kernel equal to its plain version's, comparisons by kernel: "
          f"{json.dumps(FLOPS_CHECKED)}", flush=True)
    check(sorted(FLOPS_CHECKED) == sorted(c.__name__ for c in _counters()),
          f"kernels whose FLOP report no comparison read: "
          f"{sorted(set(c.__name__ for c in _counters()) - set(FLOPS_CHECKED))}")

    runs = {"sample_2d_to_3d": sampler_launches, "sample_2d_to_3d_fused": fused_launches,
            "sample_2d_to_3d_pair_cm_direct": cm_chain_launches,
            **{"sample_3d_to_2d" + ("" if form == "auto" else "_" + form): counts
               for form, counts in chain_3d2d_launches.items()},
            "pretrain_5_steps": train_launches,
            "pretrain_pair_cm_direct_2_steps": cm_train_launches,
            **{f"pretrain_{form}_bank_2_steps": counts
               for form, counts in bank_train_launches.items()},
            "pretrain_compact_5_steps": compact_launches,
            **{f"pretrain_microbatch_{scope}_2_steps": counts
               for scope, counts in microbatch_launches.items()},
            "pretrain_painn_2_steps": painn_launches,
            **large_n_launches, "pretrain_buckets_cli": bucket_launches, **finetune_launches,
            **surface_launches, **packed_launches, **dp_launches, **util_launches,
            **large_plan_launches, **last_launches, **wide_launches}
    keys = ("max_abs_err", "ms", "plain_ms", "device_ms", "plain_device_ms", "bound_ms",
            "bound_by")
    k6_keys = keys + ("max_rel_err",)
    kernels = []
    for name, source, replaces, main_path in (
            ("gin_messages", "gin_messages.cu", "gin_messages.py:128", "pretrain_5_steps"),
            ("gin_messages_bwd", "gin_messages.cu", "gin_messages.py:144", "pretrain_5_steps"),
            ("fused_cfconv", "cfconv.cu", "cfconv.py:212", "pretrain_5_steps"),
            ("fused_cfconv_bwd", "cfconv.cu", "cfconv.py:228", "pretrain_5_steps"),
            ("fused_cfconv_rbf", "cfconv.cu", "cfconv.py:212", "pretrain_compact_5_steps"),
            ("fused_cfconv_rbf_bwd", "cfconv.cu", "cfconv.py:228", "pretrain_compact_5_steps"),
            ("pair_relu_project", "pair_block.cu", "pair_block.py:170", "pretrain_5_steps"),
            ("pair_relu_project_bwd", "pair_block.cu", "pair_block.py:193", "pretrain_5_steps"),
            ("pair_relu_project_cm", "pair_block.cu", "pair_block.py:337",
             "pretrain_pair_cm_direct_2_steps"),
            ("pair_relu_project_cm_bwd", "pair_block.cu", "pair_block.py:361",
             "pretrain_pair_cm_direct_2_steps"),
            ("score_eval_fused", "score_eval.cu", "score_kernel.py:388",
             "sample_2d_to_3d_fused")):
        if name == "score_eval_fused":   # the fused chain's mode: variant 1, bf16
            r, f32 = fused_results["score_eval_fused[v1][bf16]"], fused_results[
                "score_eval_fused[v1]"]
            extra = {"max_rel_err": r["max_rel_err"],
                     "variant_2": {mode: {k: fused_results["score_eval_fused[v2]" + sfx][k]
                                          for k in k6_keys}
                                   for mode, sfx in (("f32", ""), ("bf16", "[bf16]"))},
                     **{f"n_max_{n}": {f"v{v}": {mode: {k: fused_results[
                         f"score_eval_fused[v{v}]" + sfx + f"[n{n}]"][k] for k in k6_keys}
                         for mode, sfx in (("f32", ""), ("bf16", "[bf16]"))} for v in (1, 2)}
                        for n in (64, 128, KERNEL_N_MAX + 1)},
                     # the layered plan (phase 21): n_max 1024 at B = 2 here,
                     # every shape of LAYERED_K6 beside it
                     "n_max_1024": {f"v{v}": {mode: {k: last_results[
                         f"score_eval_fused[v{v}]" + sfx + "[n1024]"][k] for k in k6_keys}
                         for mode, sfx in (("f32", ""), ("bf16", "[bf16]"))} for v in (1, 2)},
                     "layered_plan": {f"n_max_{n}_b_{b}": {f"v{v}": {mode: {k: last_results[
                         f"score_eval_fused[v{v}]" + sfx + f"[n{n}]"][k] for k in k6_keys}
                         for mode, sfx in (("f32", ""), ("bf16", "[bf16]"))} for v in (1, 2)}
                         for n, b in LAYERED_K6},
                     "layered_forced_at_n_max_32_64_128": {
                         k: v for k, v in last_results.items() if k.startswith("forced_layered")},
                     "chain_n_max_1024_bf16": {
                         "launches": last_launches["sample_2d_to_3d_fused_n_max_1024"][
                             "score_eval_fused"],
                         **last_figures["fused_chain_n_max_1024"]},
                     "chain_n_max_128_f32_3_steps": {
                         "launches": fused_results["chain_n128_k6_launches"]},
                     "cluster_by_n_max": {n: score_plan(n, True)["cluster"]
                                          for n in (32, 64, 128)},
                     # the layered plan at other widths (phase 22): the fused
                     # chain with the 2D->3D model 64 and 128 wide, K6 alone at
                     # hidden 128, n_max 1024, B = 2 and over the width grid
                     **{f"hidden_{h}": {
                         "chain_launches": wide_launches[f"sample_2d_to_3d_fused_hidden_{h}"][
                             "score_eval_fused"],
                         **wide_figures[f"fused_chain_hidden_{h}"],
                         **{f"v{v}": {mode: {k: wide_results[
                             f"score_eval_fused[v{v}]" + sfx + f"[h{h}]"][k] for k in k6_keys}
                             for mode, sfx in (("f32", ""), ("bf16", "[bf16]"))}
                            for v in (1, 2)}} for h in WIDE_HIDDEN},
                     "hidden_128_n_max_1024_b_2": {mode: {k: wide_results[
                         "score_eval_fused[v1]" + sfx + "[h128][n1024]"][k] for k in k6_keys}
                         for mode, sfx in (("f32", ""), ("bf16", "[bf16]"))},
                     "width_grid": wide_results["grid"],
                     # SDEModel2Dto3D_03 / _04's fused chains: kernel variant 1
                     # on their own conditioning
                     **{f"sde_v{v}": {mode: {k: surface_results[
                         f"score_eval_fused[v{v}]" + sfx][k] for k in k6_keys}
                         for mode, sfx in (("f32", ""), ("bf16", "[bf16]"))}
                        for v in (3, 4)}}
        else:
            r, f32 = train_results[name], train_results[name + "[f32]"]
            # past n_max 32, bf16 and f32: K1, K2 / K5, K3 / K4 at n_max 64 and 128
            extra = {size: {mode: {k: res[name + sfx][k] for k in keys + ("max_rel_err",)}
                            for mode, sfx in (("bf16", ""), ("f32", "[f32]"))}
                     for size, res in large_n_results.items() if name in res}
            for finetune, res in finetune_results.items():   # f32, the finetune's operands
                if name in res:
                    extra[f"finetune_{finetune}_f32"] = {k: res[name][k]
                                                         for k in keys + ("max_rel_err",)}
            if name in sampler_results:
                extra["sampler_operands"] = {
                    mode: {k: sampler_results[name + sfx][k] for k in keys}
                    for mode, sfx in (("f32", ""), ("bf16", "[bf16]"))}
        if name == "score_eval_fused":   # the layered plan's own source beside it
            extra["layered_source"] = "moleculesde_tpu_torch/csrc/score_layered.cu"
        kernels.append({
            "name": name, "route": "cuda", "source": "moleculesde_tpu_torch/csrc/" + source,
            "replaces": "moleculesde_tpu/ops/" + replaces,
            "launches": runs[main_path][name], "main_path": main_path,
            "launches_by_path": {path: counts[name] for path, counts in runs.items()},
            **{k: r[k] for k in keys}, "library_ms": None, "mode": "bf16",
            "f32": {k: f32[k] for k in (k6_keys if "max_rel_err" in f32 else keys)},
            **extra})
    # the bank kernels: edge layer 1's operands (C = 8, as layers 1-3) in bf16
    # at the top, layer 0's (C = 2; K8 F = emb_dim) and f32 mode beside them
    bank_all = {**bank_results, **large_n_results["n_max_128"],
                **large_n_results["n_256_b_2"], **large_n_results["n_600_b_1"],
                **bucket_results, **k8_large}
    for name, counter, source, replaces, main_path in (
            ("attn_map_bank", attn_map_bank_kernel, "attn_bank.cu",
             "rejected/attn_bank.py:138", "sample_3d_to_2d_pallas"),
            ("attn_map_bank_bwd", attn_map_bank_kernel_bwd, "attn_bank.cu",
             "rejected/attn_bank.py:157", "pretrain_pallas_bank_2_steps"),
            ("attn_qk_bank", attn_qk_bank, "attn_qk_bank.cu",
             "rejected/attn_qk_bank.py:209", "sample_3d_to_2d_fused"),
            ("attn_qk_bank_bwd", attn_qk_bank_bwd, "attn_qk_bank.cu",
             "rejected/attn_qk_bank.py:232", "pretrain_fused_bank_2_steps")):
        res = lambda sfx: {k: bank_all[name + sfx][k]  # noqa: E731
                           for k in keys + ("max_rel_err",)}
        # past N = 32: the chain's operands at n_max 64 (B=128) and 128 (B=32),
        # seeded ones at N = 256, B = 2
        extra = {f"n_max_{n}": {f"layer_{li}": {"bf16": res(f"[L{li}][n{n}]"),
                                                "f32": res(f"[L{li}][f32][n{n}]")}
                                for li in (1, 0)} for n in (64, 128)}
        extra["n_256_b_2"] = {"bf16": res("[L0][n256]"), "f32": res("[L0][f32][n256]")}
        extra["n_16_b_32"] = {"bf16": res("[L0][n16]"), "f32": res("[L0][f32][n16]")}
        if name.startswith("attn_map_bank"):   # K7 past the old backward's N <= 518
            extra["n_600_b_1"] = {"bf16": res("[L0][n600]"), "f32": res("[L0][f32][n600]")}
            # the grouped plan (phase 21): A = 512 here, every A of GROUPED_K7
            # beside it, B C = 16 at N = 32 and 600
            last = lambda sfx: {k: last_results[name + sfx][k]  # noqa: E731
                                for k in keys + ("max_rel_err",)}
            extra["a_512"] = {f"n_{n}": {"bf16": last(f"[L0][a512][n{n}]"),
                                         "f32": last(f"[L0][f32][a512][n{n}]")}
                              for n in (32, 600)}
            extra["grouped_plan"] = {f"a_{a}_ds_{ds}": {
                f"n_{n}": {"bf16": last(f"[L0][a{a}][n{n}]"),
                           "f32": last(f"[L0][f32][a{a}][n{n}]")} for n in (32, 600)}
                for a, ds in GROUPED_K7}
        else:   # K8's tiled plan on the chain's operands at n_max 512 / 1024, B = 2
            extra.update({f"n_{n}_b_2": {f"layer_{li}": {"bf16": res(f"[L{li}][n{n}]"),
                                                        "f32": res(f"[L{li}][f32][n{n}]")}
                                         for li in (1, 0)} for n in (512, 1024)})
            if name == "attn_qk_bank_bwd":
                extra["n_256_b_2_bwd_plans"] = k8_large["n_256_b_2_bwd_plans"]
        kernels.append({
            "name": name, "route": "cuda", "source": "moleculesde_tpu_torch/csrc/" + source,
            "replaces": "moleculesde_tpu/ops/" + replaces,
            "launches": runs[main_path][counter.__name__], "main_path": main_path,
            "launches_by_path": {path: counts[counter.__name__]
                                 for path, counts in runs.items()},
            **res("[L1]"), "library_ms": None, "mode": "bf16", "operands": "edge layer 1",
            "f32": res("[L1][f32]"), "layer_0": {"bf16": res("[L0]"), "f32": res("[L0][f32]")},
            **extra})
    print(json.dumps({"widths": wide_figures, "card": card}))
    print(json.dumps({"last_shapes": last_figures, "card": card}))
    print(json.dumps({"utilities": util_figures}))
    print(json.dumps({"data_parallel": dp_figures}))
    print(json.dumps({"pretrain_buckets_cli": bucket_figures}))
    print(json.dumps({"pretrain_packed": packed_figures, "card": card}))
    print(json.dumps({"finetune_molecules_per_s": finetune_rates, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
