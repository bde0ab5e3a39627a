"""Port parity: data parallelism (moleculesde_tpu_torch.parallel) in the
pretraining step, against the port's one-process run and the JAX package's
sharded step.

Two gloo ranks on the CPU (``torch_port_parallel_worker.py``, started once
for the module) run each case on the blocks of a global batch of 8 graphs;
this process runs the same case on the whole batch.  The JAX steps come
first, so that they compile while the ranks run.

- Against the one-process run, f32, dropout on (GIN 0.5 and the score
  network's fixed 0.1): the padded step (InfoNCE), the compact step
  (EBM_dot_prod) and the padded step with EBM_node_dot_prod (the
  microbatched steps: test_torch_port_parallel_microbatch.py).  Loss terms
  agree to 1e-5 relative and the running statistics to 1e-5; every
  gradient leaf before Adam agrees to 1e-5 of its largest value or to 1e-6
  of the step's largest gradient, whichever is larger: the leaves whose
  gradient is small by cancellation (GIN's ``eps``, and the ones that are
  zero in exact arithmetic) hold rounding noise of the other summation
  order at that scale, the floor the port's JAX parity tests hold the
  zero leaves to (``check_whole_step``).
  The same bars hold ``dual_cl`` of each metric (inputs' gradients), the
  masked BatchNorms and dropout's masks.
- Against JAX's ``make_sharded_pretrain_step`` on a 2-device mesh, dropout
  off on both sides and JAX's draws replayed: the padded step with Adam
  (``check_jax_step``, which the microbatched file shares), loss terms rtol 1e-3
  (JAX's own bar in tests/test_parallel.py), the parameters after the
  update as ``assert_params_after_step`` holds them and the statistics to
  1e-4; ``dual_cl`` of each metric under ``sharded_jit``, 1e-5.
- The collectives' values and gradients (the gradient convention of
  ``parallel/collectives.py``), ``replicate``, ``shard_for_process``
  against JAX's on lists and packed datasets, ``rank_block`` and a loader
  with ``block=`` against the collation of the rank's molecules, and the
  shard-aligned ``split_microbatches`` against JAX's.
"""

import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.core.batch import pad_graphs as jax_pad_graphs
from moleculesde_tpu.data.packed import PackedGraphs as JaxPackedGraphs
from moleculesde_tpu.parallel import make_mesh, make_sharded_pretrain_step, replicate
from moleculesde_tpu.parallel import shard_batch, sharded_jit
from moleculesde_tpu.parallel import shard_for_process as jax_shard_for_process
from moleculesde_tpu.pretrain.contrastive import dual_cl as jax_dual_cl
from moleculesde_tpu.pretrain.train_state import PretrainConfig as JaxPretrainConfig
from moleculesde_tpu.pretrain.train_state import PretrainState
from moleculesde_tpu.pretrain.train_state import build_models as jax_build_models
from moleculesde_tpu.pretrain.train_state import make_optimizer as jax_make_optimizer
from moleculesde_tpu.pretrain.train_step import split_microbatches as jax_split_microbatches
from moleculesde_tpu_torch.core.batch import pad_graphs
from moleculesde_tpu_torch.data.compact import collate_compact
from moleculesde_tpu_torch.data.loader import GraphLoader
from moleculesde_tpu_torch.data.packed import PackedGraphs
from moleculesde_tpu_torch.parallel import mesh
from moleculesde_tpu_torch.pretrain.train_state import create_pretrain_state
from moleculesde_tpu_torch.pretrain.train_step import METRICS, split_microbatches

import torch_port_parallel_worker as w
from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    assert_params_after_step, flat_tree, ieee_f32, jax_score_dropout_off, t)

WORKER = Path(__file__).with_name("torch_port_parallel_worker.py")
ONE_PROCESS = ["pre_padded_infonce", "pre_compact_ebm", "pre_padded_ebm_node",
               "contrastive", "batchnorm"]
CASES = ONE_PROCESS + ["collectives", "replicate", "pre_jax"]
JAX_STEP_KEY = 9
# XLA's CPU backend without its costly optimizations: the JAX steps compile
# in about two thirds of the time, and their numbers move by rounding only
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def flax_tree(modules, buffers=False):
    """The port modules' parameters (or buffers) as flax's nested dicts."""
    out = {}
    for comp, module in modules.items():
        named = module.named_buffers() if buffers else module.named_parameters()
        for name, v in named:
            node = out.setdefault(comp, {})
            *path, leaf = name.split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v.detach().numpy().copy()
    return out


def replay(k_23, k_32, b, prefix=""):
    """The two score losses' draws of ``b`` graphs from JAX's keys, flat."""
    n = w.N_MAX
    k_noise, k_t = jax.random.split(k_23)
    k_t3, k_adj, k_x = jax.random.split(k_32, 3)
    return {prefix + "pos_noise": jax.random.normal(k_noise, (b * n, 3)),
            prefix + "half_23": jax.random.randint(k_t, (b // 2 + 1,), 0, 1000),
            prefix + "half_32": jax.random.randint(k_t3, (b // 2 + 1,), 0, 1000),
            prefix + "z_adj": jax.random.normal(k_adj, (b, n, n)),
            prefix + "z_x": jax.random.normal(k_x, (b, n, 119))}


@jax.jit
def jax_draws():
    """JAX's draws of the cases held against JAX (make_pretrain_step: the
    step key folded with step 0, split in four; a "score" chunk i folds i
    into the score keys), and dual_cl's two shifts, in one program."""
    _, _, k_23, k_32 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(JAX_STEP_KEY), 0), 4)
    chunks = {}
    for i in range(2):
        chunks.update(replay(jax.random.fold_in(k_23, i), jax.random.fold_in(k_32, i), 4, f"c{i}."))
    shifts = jnp.stack([jax.random.randint(k, (), 1, 16)
                        for k in jax.random.split(jax.random.PRNGKey(4))])
    return replay(k_23, k_32, w.B), chunks, shifts


def write_draws(out: Path) -> None:
    step, chunks, shifts = jax.device_get(jax_draws())
    np.savez(out / "draws_pre_jax.npz", **step)
    np.savez(out / "draws_pre_jax_microbatch.npz", **chunks)
    np.savez(out / "draws_contrastive.npz", shifts=shifts)


def start_workers(out: Path, cases):
    port = mesh.free_port()
    return [subprocess.Popen([sys.executable, str(WORKER), str(r), str(w.WORLD), str(port),
                              str(out), *cases], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True) for r in range(w.WORLD)]


def join_workers(procs, timeout=240):
    t0 = time.time()
    for p in procs:
        try:
            _, err = p.communicate(timeout=max(1, timeout - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-4000:]


def module_ranks(tmp_path_factory, name, cases, draws):
    """A module fixture's body: ``draws(out)`` writes the JAX draws, two
    workers start on ``cases`` and run beside the module's tests; yields
    (out, get), ``get(case)`` [rank 0's arrays, rank 1's arrays], which
    waits for the workers the first time."""
    out = tmp_path_factory.mktemp(name)
    draws(out)
    procs = start_workers(out, cases)
    results = {}

    def get(case):
        if not results:
            join_workers(procs)
            results.update({c: [dict(np.load(out / f"{c}.r{r}.npz")) for r in range(w.WORLD)]
                            for c in cases})
        return results[case]

    yield out, get
    for p in procs:
        p.kill()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    yield from module_ranks(tmp_path_factory, "parallel", CASES, write_draws)


def stitched(per_rank, key):
    """A per-molecule output of the two ranks as the global batch's."""
    return np.concatenate([r[key] for r in per_rank])


def check_one_process(one, per_rank):
    """The bars of the module docstring; replicated keys must also be equal
    on both ranks."""
    grads = [k for k in one if k.startswith("g")
             and k.split(":")[0] in ("g", "g0.5", "g0.0")]
    scale = max([float(np.abs(one[k]).max()) for k in grads] + [1e-12])
    for key, ref in one.items():
        mine = per_rank[0][key]
        if key in grads:
            np.testing.assert_array_equal(mine, per_rank[1][key], err_msg=key)
            err = np.abs(mine - ref).max()
            assert err <= max(1e-5 * np.abs(ref).max(), 1e-6 * scale), (key, err, scale)
        elif mine.shape == ref.shape and mine.ndim == 0 or key.startswith(("m:", "b:")):
            np.testing.assert_array_equal(mine, per_rank[1][key], err_msg=key)
            np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-6, err_msg=key)
        else:
            mine = stitched(per_rank, key)
            err = np.abs(mine - ref).max()
            assert err <= 1e-5 * max(np.abs(ref).max(), 1.0), (key, err)


def jax_step(microbatch, scope):
    """JAX's sharded step from the port's initial weights: (metrics, new
    params, new batch stats)."""
    cfg_t = w.pretrain_config(microbatch=microbatch, scope=scope, dropout_ratio=0.0)
    models_t = create_pretrain_state(cfg_t, "cpu", w.SEED).models
    params, stats = flax_tree(models_t), flax_tree(
        {k: m for k, m in models_t.items() if len(list(m.buffers()))}, buffers=True)
    with jax_score_dropout_off():
        cfg = JaxPretrainConfig(**w.TINY, dropout_ratio=0.0, bf16_pairs=False,
                                cl_similarity_metric=cfg_t.cl_similarity_metric,
                                score_dtype_2dto3d="float32", schnet_bf16=False,
                                gnn2d_bf16=False, bf16_attn_3dto2d=False,
                                microbatch=microbatch, microbatch_scope=scope)
        models = jax_build_models(cfg)
        state = PretrainState(params=params, batch_stats=stats,
                              opt_state=jax_make_optimizer(cfg).init(params),
                              step=jnp.zeros((), jnp.int32))
        jb = jax_pad_graphs(w.graphs(61), n_max=w.N_MAX, e_max=4 * w.N_MAX,
                            ext_e_max=w.N_MAX ** 2)
        m2 = make_mesh(2)
        args = (replicate(state, m2), shard_batch(jb, m2), jax.random.PRNGKey(JAX_STEP_KEY),
                jnp.asarray(1.0))
        step = make_sharded_pretrain_step(models, cfg, m2).lower(*args).compile(FAST_COMPILE)
        new, metrics = step(*args)
    return jax.device_get((metrics, new.params, new.batch_stats)), models_t


def test_two_ranks_match_jax_sharded_step(ranks):
    check_jax_step(ranks, "pre_jax", 0, "step")


def check_jax_step(ranks, case, microbatch, scope):
    """The two ranks' data-parallel step (``case``) against JAX's sharded
    step: the bars of the module docstring."""
    _, get = ranks
    (metrics, new_params, new_stats), models = jax_step(microbatch, scope)
    r0, r1 = get(case)
    for k in METRICS:
        np.testing.assert_allclose(r0[f"m:{k}"], float(metrics[k]), rtol=1e-3, err_msg=k)
    with torch.no_grad():
        for comp, module in models.items():
            for name, p in module.named_parameters():
                np.testing.assert_array_equal(r0[f"p:{comp}.{name}"], r1[f"p:{comp}.{name}"])
                p.copy_(torch.as_tensor(r0[f"p:{comp}.{name}"]))
    assert_params_after_step(models, new_params, 1e-4)
    for key, ref in flat_tree(new_stats).items():
        np.testing.assert_allclose(r0[f"b:{key}"], ref, rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("case", ONE_PROCESS)
def test_two_ranks_match_one_process(ranks, case):
    out, get = ranks
    check_one_process(w.CASES[case](str(out)), get(case))


def test_collectives_values_and_gradients(ranks):
    """Rank r holds x = arange(6).reshape(3, 2) + 10 r: the sum over ranks
    and its gradient (2 * W, each rank computing the same global loss), the
    gathered rows and the gradient of their squares (2 x * W), the global
    mean and a masked mean."""
    _, get = ranks
    xs = [np.arange(6.0).reshape(3, 2) + 10 * r for r in range(2)]
    allx = np.concatenate(xs)
    for r, res in enumerate(get("collectives")):
        assert res["sum"] == 2 * allx.sum()
        np.testing.assert_array_equal(res["g_sum"], np.full((3, 2), 4.0))
        np.testing.assert_array_equal(res["gathered"], allx)
        np.testing.assert_array_equal(res["g_gather"], 2 * xs[r] * 2)
        assert res["mean"] == allx.mean()
        assert res["masked"] == allx[allx > 3].mean()


def test_replicate_makes_ranks_equal(ranks):
    _, get = ranks
    r0, r1 = get("replicate")
    differ = [k for k in r0 if k.startswith("before.") and not np.array_equal(r0[k], r1[k])]
    assert differ       # differently seeded before
    for k in r0:
        if not k.startswith("before."):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
            if k.startswith("p:"):
                np.testing.assert_array_equal(r0[k], r0[f"before.{k}"], err_msg=k)


@pytest.mark.parametrize("metric", ["InfoNCE_dot_prod", "EBM_dot_prod", "EBM_node_dot_prod"])
def test_contrastive_matches_jax_sharded(ranks, metric):
    _, get = ranks
    x, y, mask = w.cl_inputs()
    key = jax.random.PRNGKey(4)

    def fn(x_, y_, m_):
        def loss(a, b):
            return jax_dual_cl(a, b, key, metric=metric, T=0.1, mask=m_)
        (l, acc), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(x_, y_)
        return l, acc, g[0], g[1]

    l, acc, gx, gy = sharded_jit(fn, make_mesh(2), ("data", "data", "data"),
                                 ("repl", "repl", "data", "data"))(x, y, mask)
    per_rank = get("contrastive")
    k = f"{metric}.jax"
    np.testing.assert_allclose(per_rank[0][f"loss:{k}"], float(l), rtol=1e-5)
    np.testing.assert_allclose(per_rank[0][f"acc:{k}"], float(acc), atol=1e-6)
    for name, ref in (("gx", gx), ("gy", gy)):
        mine = stitched(per_rank, f"{name}:{k}")
        assert np.abs(mine - np.asarray(ref)).max() <= 1e-5 * np.abs(np.asarray(ref)).max()


@pytest.mark.parametrize("packed", [False, True], ids=["list", "packed"])
def test_shard_for_process_matches_jax(packed):
    gs = w.graphs(91, count=11)
    for count in (2, 3):
        for index in range(count):
            for equalize in (True, False):
                if packed:
                    mine = mesh.shard_for_process(PackedGraphs.from_graphs(gs), index, count,
                                                  equalize)
                    ref = jax_shard_for_process(JaxPackedGraphs.from_graphs(gs), index, count,
                                                equalize)
                    assert list(mine.indices) == list(ref.indices)
                    continue
                mine = mesh.shard_for_process(gs, index, count, equalize)
                ref = jax_shard_for_process(gs, index, count, equalize)
                assert [id(g) for g in mine] == [id(g) for g in ref]
    assert len(mesh.shard_for_process(gs, 1, 2)) == 5


@pytest.mark.parametrize("compact", [False, True], ids=["padded", "compact"])
def test_rank_block_is_the_collation_of_the_ranks_molecules(compact):
    gs = w.graphs(93, count=6)
    kw = dict(n_max=w.N_MAX, e_max=4 * w.N_MAX)
    if compact:
        whole, parts = collate_compact(gs, **kw), [collate_compact(gs[r * 3:(r + 1) * 3], **kw)
                                                    for r in range(2)]
    else:
        whole = pad_graphs(gs, **kw, ext_e_max=w.N_MAX ** 2)
        parts = [pad_graphs(gs[r * 3:(r + 1) * 3], **kw, ext_e_max=w.N_MAX ** 2)
                 for r in range(2)]
    for r in range(2):
        block, ref = mesh.rank_block(whole, r, 2), parts[r]
        assert block.num_graphs == ref.num_graphs == 3
        for name, v in vars(ref).items():
            if torch.is_tensor(v):
                torch.testing.assert_close(getattr(block, name), v, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("rotation", [False, True], ids=["plain", "rotation"])
def test_loader_block_is_the_ranks_share_of_each_batch(rotation):
    """A loader with ``block=(r, 2)`` visits the one-process loader's
    batches and collates rank r's block of each, the padded tail and the
    rotations of the whole batch included."""
    gs = w.graphs(95, count=11)
    kw = dict(batch_size=4, n_max=w.N_MAX, shuffle=not rotation, drop_last=False, seed=3,
              rotation_transform=rotation)
    one = list(GraphLoader(gs, **kw))
    ranks = [list(GraphLoader(gs, **kw, block=(r, 2))) for r in range(2)]
    assert len(one) == len(ranks[0]) == len(ranks[1]) == 3
    for i, (batch, n_real) in enumerate(one):
        for r in range(2):
            block, n = ranks[r][i]
            assert n == max(0, min(2, n_real - 2 * r))
            ref = mesh.rank_block(batch, r, 2)
            for name, v in vars(ref).items():
                if torch.is_tensor(v):
                    torch.testing.assert_close(getattr(block, name), v, msg=name)
    with pytest.raises(ValueError, match="does not split"):
        GraphLoader(gs, batch_size=3, n_max=w.N_MAX, block=(0, 2))


def test_shard_aligned_chunks_match_jax():
    gs = w.graphs(97)
    jb = jax_pad_graphs(gs, n_max=w.N_MAX, e_max=4 * w.N_MAX, ext_e_max=w.N_MAX ** 2)
    tb = pad_graphs(gs, n_max=w.N_MAX, e_max=4 * w.N_MAX, ext_e_max=w.N_MAX ** 2)
    theirs = jax_split_microbatches(jb, 2, shards=2)
    for i, chunk in enumerate(split_microbatches(tb, 2, shards=2)):
        for name, v in vars(chunk).items():
            if torch.is_tensor(v):
                np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(theirs, name)[i]),
                                              err_msg=name)
    with pytest.raises(ValueError, match="multiple of the number of ranks"):
        mesh.check_microbatch(3, 2)


def test_without_a_group_nothing_changes():
    """The collectives are the identity in one process, and the group's
    backend follows the device."""
    from moleculesde_tpu_torch.parallel import collectives as dp

    x = torch.arange(6.0).reshape(3, 2)
    assert dp.active() is None and dp.world_size() == 1
    assert dp.global_sum(x) is x and dp.all_gather_rows(x) is x and dp.block(x) is x
    assert dp.global_mean(x) == x.mean()
    assert mesh.backend_for("cpu") == "gloo" and mesh.backend_for("cuda") == "nccl"
    assert mesh.initialize_distributed(num_processes=1) == 1
    assert dp.DataGroup(0, 2, "gloo").staged and not dp.DataGroup(0, 2, "nccl").staged
