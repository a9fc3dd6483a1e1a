"""The port's train-to-serve publisher (`repro_torch.serve.publisher`) and
the trainer's `publish_extract` against the JAX package's, on the CPU.

* the publisher cases of tests/test_serve.py on the port: monotone versions
  and the double buffer, a masked extract and staleness, the budget
  governor, the minimum interval and `reset_stats`, `configure`, and an
  engine that polls only newer versions;
* `publish_extract` against the reference's with one node masked out, f32
  and bf16, N = 3, 4, 5: exactly equal (the f32 accumulation lands on the
  same bits on the CPU);
* the publisher attached to the `StreamingDriver` on a reduced granite-8b
  (N = 2, gossip): each superstep publishes the node mean of the live
  state, a `ContinuousBatchingEngine` polls it through three versions and
  every request completes with all its tokens, its versions monotone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import registry as jreg
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import AveragingConfig, RunConfig, SHAPES
from repro_torch.core.packing import tree_leaves
from repro_torch.data.lm import MarkovTokenStream
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.publisher import SnapshotPublisher
from repro_torch.train import trainer
from repro_torch.train.driver import EngineConfig, StreamingDriver

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("granite-8b"))
    jp = jreg.init_params(jax.random.PRNGKey(0),
                          jreduced(jget_config("granite-8b")), jnp.float32)
    return cfg, convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")


def test_publisher_versions_monotone_and_double_buffered():
    pub = SnapshotPublisher(overhead_budget=0.0)  # ungoverned
    assert pub.snapshot() is None and pub.version == 0
    tree = {"w": torch.arange(4.0)}
    s1 = pub.publish(tree, 1)
    s2 = pub.publish({"w": tree["w"] + 1}, 2)
    s3 = pub.publish({"w": tree["w"] + 2}, 3)
    assert (s1.version, s2.version, s3.version) == (1, 2, 3)
    assert pub.snapshot() is s3
    assert pub._back is s2  # predecessor stays live (double buffer)
    np.testing.assert_array_equal(s3.params["w"].numpy(), np.arange(4.0) + 2)
    # published leaves are fresh memory, not aliases of the source tree
    assert s1.params["w"].data_ptr() != tree["w"].data_ptr()
    tree["w"].add_(100.0)  # an in-place update after the publish
    np.testing.assert_array_equal(s1.params["w"].numpy(), np.arange(4.0))


def test_publisher_extract_and_staleness():
    def extract(tree, mask):
        w = mask / mask.sum()
        return {k: torch.tensordot(w, p, dims=1) for k, p in tree.items()}

    pub = SnapshotPublisher(overhead_budget=0.0, extract=extract, block=True)
    tree = {"w": torch.tensor([[1.0, 1.0], [3.0, 3.0], [100.0, 100.0]])}
    mask = torch.tensor([1.0, 1.0, 0.0])  # node 2 inactive
    snap = pub.publish(tree, superstep=4, aux=mask)
    np.testing.assert_allclose(snap.params["w"].numpy(), [2.0, 2.0])
    st = pub.staleness(7)
    assert st["supersteps"] == 3 and st["wall_s"] >= 0.0
    assert pub.staleness(4)["supersteps"] == 0


def test_publisher_budget_governor_skips_and_recovers():
    t = [0.0]
    pub = SnapshotPublisher(overhead_budget=0.5, clock=lambda: t[0])
    tree = {"w": torch.ones(2)}

    def publish_at(now, step):
        t[0] = now
        return pub.maybe_publish(tree, step)

    assert publish_at(0.0, 0) is not None  # first publish unconditional
    pub.stats.cost_ewma_s = 1.0  # pretend publishes cost 1 s
    assert publish_at(1.0, 1) is None  # 1.0 > 0.5 * 1.0 elapsed: skip
    assert pub.stats.skipped_budget == 1
    assert publish_at(3.0, 2) is not None  # 1.0 <= 0.5 * 3.0: allowed
    assert pub.version == 2


def test_publisher_min_interval_and_reset_stats():
    t = [0.0]
    pub = SnapshotPublisher(overhead_budget=0.0, min_interval_s=10.0,
                            clock=lambda: t[0])
    tree = {"w": torch.ones(2)}
    assert pub.maybe_publish(tree, 0) is not None
    t[0] = 5.0
    assert pub.maybe_publish(tree, 1) is None  # inside min interval
    assert pub.stats.skipped_interval == 1
    t[0] = 11.0
    assert pub.maybe_publish(tree, 2) is not None
    pub.stats.cost_ewma_s = 0.25
    pub.reset_stats()
    assert pub.stats.publishes == 0 and pub.stats.cost_ewma_s == 0.25
    pub.reset_stats(keep_ewma=False)
    assert pub.stats.cost_ewma_s is None


def test_publisher_configure_is_idempotent_and_versions_survive():
    first = lambda tree: tree
    second = lambda tree: None
    pub = SnapshotPublisher()
    pub.configure(extract=first)
    pub.configure(extract=second)  # ignored: an extract is already installed
    assert pub._extract is first
    pub.load_state_dict({"version": 5, "cost_ewma_s": 0.5})
    assert pub.version == 5 and pub.publish({"w": torch.ones(1)}, 0).version == 6
    with pytest.raises(ValueError, match="backwards"):
        pub.load_state_dict({"version": 2})
    for kw in ({"overhead_budget": -1.0}, {"alpha": 0.0}):
        with pytest.raises(ValueError):
            SnapshotPublisher(**kw)


def test_engine_poll_adopts_only_newer_versions(setup):
    cfg, params = setup
    pub = SnapshotPublisher(overhead_budget=0.0)
    eng = ContinuousBatchingEngine(cfg, params, slots=1, max_len=16)
    assert not eng.poll(pub)  # nothing published yet
    pub.publish(params, 1)
    assert eng.poll(pub) and eng.version == 1
    assert not eng.poll(pub)  # same version: no swap
    assert eng.swaps == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [3, 4, 5])
def test_publish_extract_matches_reference(dtype, n):
    """Node 1 masked out; a leaf without the node axis passes through; exact
    mode publishes the params as they are."""
    rng = np.random.default_rng(n)
    p = rng.standard_normal((n, 33, 65)).astype(np.float32)
    other = rng.standard_normal((7,)).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[1] = 0.0
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jstate = jtrainer.TrainState({"a": jnp.asarray(p).astype(jd),
                                  "b": jnp.asarray(other)}, ())
    tstate = trainer.TrainState({"a": torch.from_numpy(p).to(td),
                                 "b": torch.from_numpy(other)}, ())
    want = jtrainer.publish_extract(n)(jstate, jnp.asarray(mask))
    got = trainer.publish_extract(n)(tstate, torch.from_numpy(mask))
    assert got["a"].dtype == td and tuple(got["a"].shape) == (33, 65)
    np.testing.assert_array_equal(got["a"].float().numpy(),
                                  np.asarray(want["a"].astype(jnp.float32)))
    assert got["b"] is tstate.params["b"]
    assert trainer.publish_extract(None)(tstate) is tstate.params


def test_driver_publishes_and_engine_serves_three_versions():
    """`StreamingDriver(publisher=...)`: every superstep publishes the node
    mean of the live state (the driver's [N] mask, every node active); an
    engine polls between supersteps and keeps serving across the swaps."""
    cfg = reduced(get_config("granite-8b"))
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"],
                    averaging=AveragingConfig("gossip", 1), optimizer="adam",
                    learning_rate=1e-3, param_dtype="float32")
    n = 2
    state = trainer.replicate_for_nodes(
        trainer.init_state(run, torch.Generator().manual_seed(0)), n)
    data = MarkovTokenStream(cfg.vocab_size, seed=0)

    def sample(rng, k):
        toks = data.sample(rng, k, 17)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    pub = SnapshotPublisher(overhead_budget=0.0)
    eng = None
    rids = []
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (6, 5))
    with StreamingDriver(run, None, state, sample, batch=4, n_nodes=n,
                         publisher=pub, device="cpu",
                         engine=EngineConfig(superstep=1, prefetch_depth=1,
                                             replan_every=0)) as drv:
        for step in range(3):
            state, hist = drv.run(1)
            assert hist[-1]["published_version"] == step + 1
            snap = pub.snapshot()
            mean = [t.mean(0) for t in tree_leaves(state.params)]
            for got, want in zip(tree_leaves(snap.params), mean, strict=True):
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
            if eng is None:
                eng = ContinuousBatchingEngine(cfg, snap.params, slots=2,
                                               max_len=16)
            assert eng.poll(pub) and eng.version == step + 1
            rids += [eng.submit(p, 4) for p in prompts[2 * step:2 * step + 2]]
            eng.step()
            eng.step()
    eng.drain()
    assert eng.version == pub.version == 3 and eng.swaps == 3
    done = [eng.result(r) for r in rids]
    assert all(len(r.tokens) == 4 and r.versions == sorted(r.versions)
               for r in done)
    assert any(len(set(r.versions)) > 1 for r in done)  # served across a swap
