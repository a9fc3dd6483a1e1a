"""The port's sharded node axis against the JAX package, on CPU ranks in a
gloo group (`tests/torch_dist_worker.py`, one worker run per world size):

* `resolve_auto_impl(mesh=...)` picks "shard" on a sharded node axis,
  `circulant_mix_op` keeps it where the rule covers the layout, and
  `node_shard_info` names the data axes;
* exact gossip (tests/shard_worker.py's shape, N = 16, D = 4096, ring,
  R = 3) is bit for bit the port's plain per-round path on each rank's
  rows, and within 1e-6 relative of `gossip_mix_ref`; HIGHD's mix (n = 10,
  d = 3072, ring R = 8) likewise, on the even split of 2 ranks and the
  uneven one of 4 (3, 3, 2, 2 rows);
* the quantized wire with per-node statistics: sign and int8 bit for bit
  against the port's plain per-node version
  (`ref.gossip_mix_quant_ref(per_node=True)`; int8_stoch too, its noise
  being the rank's own fold of the key), and against the reference's:
  sign within 1e-6 relative (the two frameworks sum a tile's |x| in
  another order, so a scale can differ in its last bit), int8 within
  1e-5, int8_stoch (other noise, by design) within one quantization step;
* the fused xi + gossip rule within 1e-5 relative of
  `gossip_mix_ref(vmap(krasulina_xi_ref))`;
* a layout the rule does not cover (a reach that would wrap onto a
  shard's own rows) gathers and stays correct; the consensus error and the exact average reduce over
  ranks;
* the governed PCA driver on 2 ranks against the JAX driver (no mesh) at
  tests/test_torch_driver.py's sizes and tolerance, with the same plan
  history on every rank.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AveragingConfig as JAveragingConfig
from repro.configs.base import GovernorConfig as JGovernorConfig
from repro.configs.base import StreamConfig as JStreamConfig
from repro.configs.paper_pca import FIG7 as JFIG7
from repro.configs.paper_pca import PCARunConfig as JPCARunConfig
from repro.core import averaging as javeraging
from repro.core import krasulina as jkras
from repro.core import mixing as jmixing
from repro.core import problems as jproblems
from repro.data.synthetic import make_pca_host_sampler as jhost_sampler
from repro.data.synthetic import make_pca_stream as jmake_pca_stream
from repro.kernels import ref as jref
from repro.train.driver import EngineConfig as JEngineConfig
from repro.train.driver import StreamingDriver as JStreamingDriver
from repro_torch import dist as rdist
from repro_torch.core import mixing
from repro_torch.kernels import ops
from repro_torch.launch import mesh as meshlib
from torch_dist_worker import (D, DRIVER_CASES, HIGHD_D, HIGHD_N, HIGHD_R, N,
                               R, SMALL_N, FakeClock, decisions, spawn)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("shard_inputs") / "inputs.npz"
    data = dict(
        x=rng.standard_normal((N, D)).astype(np.float32),
        xh=rng.standard_normal((HIGHD_N, HIGHD_D)).astype(np.float32),
        w=rng.standard_normal((N, 256)).astype(np.float32),
        z=rng.standard_normal((N, 16, 256)).astype(np.float32),
        xs=rng.standard_normal((6, D)).astype(np.float32),
        ta=rng.standard_normal((N, 12, 16)).astype(np.float32),
        tb=rng.standard_normal((N, 48)).astype(np.float32))
    np.savez(path, **data)
    yield path, data
    shutil.rmtree(path.parent, ignore_errors=True)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, inputs, tmp_path_factory):
    path, data = inputs
    world = request.param
    tmp = tmp_path_factory.mktemp(f"rules{world}")
    res = spawn("rules", world, tmp, path)
    shutil.rmtree(tmp, ignore_errors=True)
    return world, res, data


def _stitch(res, key, rows_key="rows"):
    """The whole node axis from every rank's rows."""
    parts = sorted((r[rows_key][0], r[key]) for r in res)
    return np.concatenate([p for _, p in parts])


SCHED = tuple(jmixing.schedule("ring", N, 0.5))


def test_auto_resolves_to_shard_rule(ranks):
    _, res, _ = ranks
    for r in res:
        assert r["auto_impl"] == "shard" and r["op_impl"] == "shard"
        assert r["shard_info"] == (("data",), "data")
        for q in ("sign", "int8", "int8_stoch"):
            assert r[f"{q}_impl"] == "shard"


def test_exact_gossip_bit_for_bit_and_matches_reference(ranks):
    _, res, data = ranks
    for r in res:
        np.testing.assert_array_equal(r["exact"], r["plain"])
    want = np.asarray(jref.gossip_mix_ref(jnp.asarray(data["x"]), SCHED, R))
    assert _rel(_stitch(res, "exact"), want) < 1e-6


def test_highd_mix_on_every_split(ranks):
    """n = 10 rows take the rule on every split, bit for bit: even over 2
    ranks, uneven over 4 (3, 3, 2, 2 rows: a hop spans shards of
    different lengths)."""
    world, res, data = ranks
    for r in res:
        assert r["highd_impl"] == "shard"
        np.testing.assert_array_equal(r["highd"], r["highd_plain"])
    want = np.asarray(jref.gossip_mix_ref(
        jnp.asarray(data["xh"]),
        tuple(jmixing.schedule("ring", HIGHD_N)), HIGHD_R))
    assert _rel(_stitch(res, "highd", "highd_rows"), want) < 1e-5


def test_quantized_node_stats_wire(ranks):
    _, res, data = ranks
    x = jnp.asarray(data["x"])
    for quant in ("sign", "int8", "int8_stoch"):
        key = jax.random.PRNGKey(0) if quant == "int8_stoch" else None
        want = np.asarray(jref.gossip_mix_quant_ref(
            x, SCHED, R, quant, block_d=512, key=key, per_node=True))
        got = _stitch(res, quant)
        if quant != "int8_stoch":
            for r in res:
                np.testing.assert_array_equal(r[quant], r[f"{quant}_plain"])
        if quant == "sign":
            assert _rel(got, want) < 1e-6
        elif quant == "int8":
            assert _rel(got, want) < 1e-5
        else:  # independent noise: bounded by the quantization step
            assert _rel(got, want) < 0.05


def test_krasulina_xi_gossip_shard_matches_per_round_oracle(ranks):
    _, res, data = ranks
    xi = jax.vmap(jref.krasulina_xi_ref)(jnp.asarray(data["w"]),
                                         jnp.asarray(data["z"]))
    want = np.asarray(jref.gossip_mix_ref(xi, SCHED, R))
    assert _rel(_stitch(res, "xi_gossip"), want) < 1e-5


def test_uncovered_layout_gathers_and_stays_correct(ranks):
    world, res, data = ranks
    n = SMALL_N
    want = np.asarray(jref.gossip_mix_ref(
        jnp.asarray(data["xs"][:n]),
        tuple(jmixing.schedule("circulant2", n)), R))
    for r in res:
        assert r["small_impl"] == "roll"
    np.testing.assert_allclose(_stitch(res, "small", "small_rows"), want,
                               rtol=1e-5, atol=1e-6)


def test_node_axis_reductions_over_ranks(ranks):
    _, res, data = ranks
    tree = {"a": jnp.asarray(data["ta"]), "b": jnp.asarray(data["tb"])}
    want = float(javeraging.consensus_error(tree))
    for r in res:
        np.testing.assert_allclose(r["consensus_err"], want, rtol=1e-5)
    for k in ("a", "b"):
        mean = data["t" + k].mean(0, keepdims=True)
        got = np.concatenate([r["exact_avg"][k] for r in sorted(
            res, key=lambda r: r["rows"])])
        np.testing.assert_allclose(got, np.broadcast_to(mean, got.shape),
                                   rtol=1e-5, atol=1e-6)


def test_mesh_constructors_and_rows():
    """One process: the host mesh is (1, 1) and unsharded; a mesh that does
    not cover the group and the production mesh (256 ranks) are refused,
    and a model axis where it does not execute (ROADMAP.md's model-axis
    deviations); rows split in contiguous runs."""
    host = meshlib.make_host_mesh()
    assert host.shape == {"data": 1, "model": 1} and host.rank == 0
    assert not rdist.is_sharded(host) and rdist.n_data_nodes(host) == 1
    with pytest.raises(ValueError, match="ranks"):
        meshlib.make_mesh((2, 1), ("data", "model"))
    with pytest.raises(ValueError, match="256 ranks"):
        meshlib.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        meshlib.make_production_mesh(multi_pod=True)
    with pytest.raises(NotImplementedError,
                       match="the model axis's deviations"):
        rdist.check_mesh(rdist.Mesh((2, 2), ("data", "model")), "the PCA path")
    # over one node shard each model index mixes its own columns locally
    op = mixing.circulant_mix_op(mixing.schedule("ring", 4), 4, 1,
                                 mesh=rdist.Mesh((1, 2), ("data", "model")),
                                 device="cpu")
    assert op.mesh is None and op.impl == "matmul"
    four = [rdist.Mesh((4, 1), ("data", "model"), rank=r) for r in range(4)]
    assert [rdist.row_range(m, 10) for m in four] == [
        (0, 3), (3, 6), (6, 8), (8, 10)]
    assert [rdist.n_local(m, 16) for m in four] == [4] * 4
    pods = rdist.Mesh((2, 2, 1), ("pod", "data", "model"))
    assert rdist.data_axes(pods) == ("pod", "data")
    assert rdist.n_data_nodes(pods) == 4
    # a ring spanning two mesh axes is not covered: the op gathers
    assert ops.node_shard_info(pods, 8, mixing.schedule("ring", 8)) is None
    assert ops.node_shard_info(four[0], 16, SCHED) == (("data",), "data")
    # uneven splits are covered; a reach that wraps onto a shard's own
    # rows is not
    assert ops.node_shard_info(four[0], 6, None) == (("data",), "data")
    assert ops.node_shard_info(four[0], 6, mixing.schedule("ring", 6)) == (
        ("data",), "data")
    assert ops.node_shard_info(four[0], 5, mixing.schedule(
        "circulant2", 5)) is None
    assert mixing.resolve_auto_impl("cpu", four[0]) == "shard"
    assert mixing.resolve_auto_impl("cpu", host) == "matmul"


TWO = [rdist.Mesh((2, 1), ("data", "model"), rank=r) for r in range(2)]


@pytest.mark.parametrize("B,n_nodes,why", [
    (6, 2, None), (12, 4, None), (5, 2, "samples"), (6, 3, "nodes")],
    ids=["even", "two-nodes-a-rank", "uneven-batch", "uneven-nodes"])
def test_exact_mode_batch_splits_evenly_over_ranks(B, n_nodes, why):
    """The exact mode on 2 ranks: each rank keeps its nodes' runs, equal
    shares that cover the batch once; a B or a node count that does not
    split evenly raises at the splitter, the driver and the trainer's
    builder (the reference's P(None, dp) refuses it) rather than train on
    part of the batch or weight the ranks unequally."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import AveragingConfig, RunConfig, SHAPES
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.train import trainer
    from repro_torch.train.driver import StreamingDriver

    batch = {"x": np.arange(2 * B).reshape(1, B, 2)}
    run = RunConfig(model=reduced(get_config("granite-8b")),
                    shape=SHAPES["train_4k"],
                    averaging=AveragingConfig(mode="exact"))
    sample = lambda rng, n: {"x": np.zeros((n, 2), np.float32)}
    if why is None:
        parts = [shard_batch(batch, m, n_nodes, node_axis=False)["x"]
                 for m in TWO]
        assert [p.shape[1] for p in parts] == [B // 2] * 2
        np.testing.assert_array_equal(np.concatenate(parts, 1), batch["x"])
        assert callable(trainer.superstep_builder(
            run, TWO[0], n_nodes=n_nodes, device="cpu")(B))
        return
    for m in TWO:
        with pytest.raises(ValueError, match=why):
            shard_batch(batch, m, n_nodes, node_axis=False)
        with pytest.raises(ValueError, match=why):
            trainer.superstep_builder(run, m, n_nodes=n_nodes,
                                      device="cpu")(B)
        with pytest.raises(ValueError, match=why):
            StreamingDriver(run, m, None, sample, batch=B, n_nodes=n_nodes,
                            device="cpu")


def test_sharded_refusals_and_rule_coverage():
    """On a sharded node axis the hierarchical mode and error feedback
    build (the trainer's steps and the planner's wire); the hierarchical
    mode takes its pods from the mesh's "pod" axis and refuses pods that
    the mesh does not hold; error feedback, the quantized wires and the
    hierarchical mode build over a model axis too
    (tests/test_torch_model_axis_wires.py runs them); and the shard rules
    refuse a layout that `node_shard_info` does not cover (a ring over two
    mesh axes), which `core.mixing`'s op gathers instead."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import AveragingConfig, RunConfig, SHAPES
    from repro_torch.core import averaging
    from repro_torch.core.packing import tree_map
    from repro_torch.launch import dryrun
    from repro_torch.models import registry
    from repro_torch.models.common import MetaGenerator
    from repro_torch.train import trainer

    hier = AveragingConfig(mode="hierarchical", rounds=2)
    run = RunConfig(model=reduced(get_config("granite-8b")),
                    shape=SHAPES["train_4k"], averaging=hier)
    assert callable(trainer.build_train_step(run, TWO[0], device="cpu"))
    assert callable(trainer.superstep_builder(run, TWO[0], device="cpu"))
    tree = {"a": torch.zeros(1, 8)}
    # two pods over a mesh of one pod: refused before any message
    for fn in (averaging.average_gradients, averaging.average_and_error):
        with pytest.raises(ValueError, match="pod"):
            fn(tree, hier, n_nodes=2, pods=2, mesh=TWO[0], device="cpu")
    params = registry.init_params(MetaGenerator(), run.model, torch.float32)
    pod_mesh = rdist.Mesh((2, 2, 1), ("pod", "data", "model"))
    plan = dryrun.node_axis_collectives(
        run, tree_map(lambda t: t[None], params), pod_mesh, 4)
    assert plan["reduce-scatter.count"] and plan["all-gather.count"]
    # error feedback builds and is planned on a split axis
    ef = dataclasses.replace(run, averaging=AveragingConfig(
        mode="gossip", rounds=2, quantization="int8",
        error_feedback="grads"))
    assert callable(trainer.superstep_builder(ef, TWO[0], device="cpu"))
    plan = dryrun.node_axis_collectives(ef, tree_map(lambda t: t[None],
                                                     params), TWO[0], 2)
    assert plan["collective-permute.count"] and plan["all-reduce.count"]
    # over a model axis they build too (a model whose heads, KV heads,
    # FFN and vocab the axis divides)
    model2 = rdist.Mesh((2, 2), ("data", "model"))
    tp = dataclasses.replace(run, model=dataclasses.replace(
        reduced(get_config("granite-8b"), d_model=512), num_kv_heads=2))
    trainer.check_supported(dataclasses.replace(
        tp, averaging=AveragingConfig(mode="gossip", rounds=2)))
    ef_exact = dataclasses.replace(ef.averaging, quantization="none")
    for avg in (ef_exact, ef.averaging,
                AveragingConfig(mode="gossip", rounds=2, quantization="sign"),
                hier):
        trainer.check_supported(dataclasses.replace(tp, averaging=avg))
        assert dryrun.model_axis_refusal(tp.shape.mode, model2) is None
    pods = rdist.Mesh((2, 2, 1), ("pod", "data", "model"))
    sched = mixing.schedule("ring", 8)
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="do not cover"):
        ops.sharded_gossip_mix(x, sched, 1, pods)
    with pytest.raises(ValueError, match="do not cover"):
        ops.sharded_quant_gossip_mix(x, sched, 1, "sign", pods)
    with pytest.raises(ValueError, match="do not cover"):
        ops.sharded_krasulina_xi_gossip(x, torch.zeros(2, 3, 4), sched, 1,
                                        pods)


# ---------------------------------------------------------------------------
# The governed PCA driver on 2 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    js = jmake_pca_stream(JFIG7)
    w0 = np.random.default_rng(0).standard_normal(JFIG7.dim).astype(
        np.float32)
    w0 /= np.linalg.norm(w0)
    path = tmp_path_factory.mktemp("driver") / "stream.npz"
    np.savez(path, cov=np.asarray(js.cov), sqrt_cov=np.asarray(js.sqrt_cov),
             top=np.asarray(js.top_eigvec), lambda1=js.lambda1,
             eigengap=js.eigengap, w0=w0)
    res = spawn("driver", 2, path.parent, path)
    shutil.rmtree(path.parent, ignore_errors=True)
    ref = {}
    for mode, dt, buckets in DRIVER_CASES:
        avg = JAveragingConfig(mode=mode, rounds=2)
        cfg = JPCARunConfig(averaging=avg, stream=JStreamConfig(
            streaming_rate=1e3, processing_rate=1e6, comms_rate=1e6))
        build = jkras.krasulina_superstep_builder(
            avg, 4, lambda t: 10.0 / t,
            metric=lambda w: jproblems.sin2_error(w, js.top_eigvec))
        with JStreamingDriver(
                cfg, None, jkras.init_krasulina_state(jnp.asarray(w0), avg, 4),
                jhost_sampler(js), superstep_builder=build, n_nodes=4,
                batch=100, seed=3, clock=FakeClock(dt),
                engine=JEngineConfig(superstep=2, prefetch_depth=0,
                                     warmup_supersteps=0,
                                     governor=JGovernorConfig(
                                         buckets=buckets))) as drv:
            state, hist = drv.run(5)
        ref[(mode, dt)] = (decisions(hist), np.asarray(state.w),
                           int(state.t))
    return res, ref


@pytest.mark.parametrize("mode,dt,buckets", DRIVER_CASES,
                         ids=["gossip-slow-mu", "gossip-fast-buckets",
                              "exact-slow-mu"])
def test_sharded_driver_matches_reference(driver_runs, mode, dt, buckets):
    res, ref = driver_runs
    want_dec, want_w, want_t = ref[(mode, dt)]
    runs = [r[(mode, dt)] for r in res]
    for run in runs:  # rank 0's plan on every rank, the reference's plan
        assert run["decisions"] == want_dec
        assert run["t"] == want_t and run["n_nodes"] == 4
        assert run["metric"] == runs[0]["metric"]
    if dt > 1:
        assert want_dec[-1][1] > 0  # the slow clock made it discard
    elif buckets:
        assert any(d[4] is not None for d in want_dec)  # B moved
    got = (np.concatenate([r["w"] for r in runs]) if mode == "gossip"
           else runs[0]["w"])
    np.testing.assert_allclose(got, want_w, rtol=1e-4, atol=1e-5)
