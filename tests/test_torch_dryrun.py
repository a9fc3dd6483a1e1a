"""The port's planner on the CPU: meta footprints of the kernels
(`repro_torch.kernels.ops`), the shape-only init (`models/common.py`
`MetaGenerator`), and the dry-run (`repro_torch.launch.dryrun`) and sweep
(`repro_torch.launch.sweep`) at the reduced size of
tests/test_dryrun_small.py (reduced configs, 256 tokens x 8 sequences).

* A meta tensor through each `ops` wrapper comes back empty in the plain
  version's shape and dtype, counts no launch and hands the kernel's
  operation count to `ops.meta_hooks`; the flash footprint's count is the
  mask's kept pairs (`attention_pairs`, against a dense mask).
* The meta init has the CPU init's shapes and dtypes, and the CPU draws
  are the formula they were.
* A record has the reference's keys; its argument bytes on a 1 x 1 mesh
  are the real CPU state's (and serve state's) bytes exactly; its counted
  FLOPs lie between `roofline.model_flops_for` and twice
  `roofline.analytic_hw_flops`; a model axis is planned (its collectives,
  the unsplit temporaries' flag); a full-width plan allocates nothing;
  the ssm, hybrid and encoder-decoder families' train rounds are planned.
* The planned node-axis messages against what CPU ranks send:
  tests/test_torch_trainer_dist.py (it reuses that file's worker run).
* The sweep's combos are the reference's plus the one-card pass, and one
  reduced combo runs in a subprocess.
"""
import dataclasses
import json
import math
import resource

import pytest
import torch
from torch.utils._pytree import tree_flatten

from repro.launch import sweep as jsweep
from repro_torch import roofline
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import AveragingConfig, RunConfig, SHAPES
from repro_torch.core.packing import tree_leaves
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun, sweep
from repro_torch.models import common, registry
from repro_torch.models.common import MetaGenerator
from repro_torch.serve import engine
from repro_torch.train import trainer

torch.set_num_threads(1)

META = torch.device("meta")
ONE = dryrun.parse_mesh("1x1")
KEYS = {"arch", "shape", "trips", "microbatches", "mesh", "averaging",
        "rounds", "mode", "params", "active_params", "window_override",
        "ring_cache", "master_weights", "memory", "cost", "collectives"}


def _tiny(shape_name):
    return dataclasses.replace(SHAPES[shape_name], seq_len=256,
                               global_batch=8)


def _plan(arch, shape_name, mesh=ONE, **kw):
    return dryrun.plan(arch, shape_name, mesh, cfg=reduced(get_config(arch)),
                       shape=_tiny(shape_name), **kw)


# ---------------------------------------------------------------------------
# the kernels' meta footprints
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _cpu(t):
    return torch.randn(t.shape, generator=torch.Generator().manual_seed(0)
                       ).to(t.dtype)


def test_meta_footprints_count_no_launch():
    sched = ((0, 0.5), (1, 0.25), (-1, 0.25))
    seen = []
    hook = lambda name, flops: seen.append((name, flops))
    ops.meta_hooks.append(hook)
    ops.reset_launches()
    try:
        x = _meta(4, 1000, dtype=torch.bfloat16)
        w, z = _meta(3, 64), _meta(3, 10, 64)
        q = _meta(2, 4, 40, 64, dtype=torch.bfloat16)
        kv = _meta(2, 4, 56, 64, dtype=torch.bfloat16)
        calls = {
            "gossip_mix": (lambda a: ops.gossip_mix(a, sched, 2), (x,),
                           lambda a: ref.gossip_mix_ref(a, sched, 2)),
            "gossip_mix_quant": (
                lambda a: ops.quant_gossip_mix(a, sched, 2, "int8",
                                               block_d=256), (x,),
                lambda a: ref.gossip_mix_quant_ref(a, sched, 2, "int8",
                                                   block_d=256)),
            "krasulina_xi": (ops.krasulina_xi, (w, z), ref.krasulina_xi_ref),
            "krasulina_xi_gossip": (
                lambda a, b: ops.krasulina_xi_gossip(a, b, sched, 2), (w, z),
                lambda a, b: ref.krasulina_xi_gossip_ref(a, b, sched, 2)),
            "flash_attention": (
                lambda a, b, c: ops.attention(a, b, c, causal=True, window=16),
                (q, kv, kv),
                lambda a, b, c: ref.attention_ref(a, b, c, causal=True,
                                                  window=16)),
        }
        for name, (fn, args, plain) in calls.items():
            out = fn(*args)
            want = plain(*[_cpu(a) for a in args])
            assert out.device.type == "meta"
            assert out.shape == want.shape and out.dtype == want.dtype, name
        assert [n for n, _ in seen] == list(calls)
        flops = dict(seen)
        assert flops["gossip_mix"] == 2 * 2 * 3 * x.numel()
        assert flops["krasulina_xi"] == 4 * z.numel()
        pairs = ops.attention_pairs(40, 56, causal=True, window=16)
        assert flops["flash_attention"] == 4 * 2 * 4 * 64 * pairs
        assert all(v == 0 for v in ops.launches.values())
        assert all(v == 0 for v in ops.flash_launches.values())
        assert all(not c for c in ops.node_launches.values())
    finally:
        ops.meta_hooks.remove(hook)


@pytest.mark.parametrize("sq,sk,causal,window,chunk", [
    (40, 40, True, 0, 0), (40, 56, True, 16, 0), (56, 40, True, 0, 0),
    (33, 70, False, 0, 0), (64, 64, True, 0, 16), (70, 70, True, 9, 16),
    (10, 5, False, 4, 0)])
def test_attention_pairs_count_the_mask(sq, sk, causal, window, chunk):
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    if chunk:
        mask &= (kp // chunk) == (qp // chunk)
    assert ops.attention_pairs(sq, sk, causal=causal, window=window,
                               chunk=chunk) == int(mask.sum())


def test_meta_attention_refuses_a_gradient_as_the_card_does():
    q = _meta(1, 2, 8, 64).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.attention(q, _meta(1, 2, 8, 64), _meta(1, 2, 8, 64))


def test_mixed_meta_and_cpu_is_refused():
    with pytest.raises(ValueError, match="devices"):
        ops.krasulina_xi(_meta(64), torch.zeros(10, 64))


# ---------------------------------------------------------------------------
# the shape-only init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-8b", "minicpm3-4b",
                                  "qwen2-moe-a2.7b", "mamba2-2.7b",
                                  "recurrentgemma-9b", "seamless-m4t-medium"])
def test_meta_init_matches_the_cpu_init(arch):
    cfg = reduced(get_config(arch))
    for dtype in (torch.float32, torch.bfloat16):
        cpu = tree_leaves(registry.init_params(torch.Generator().manual_seed(0),
                                               cfg, dtype))
        meta = tree_leaves(registry.init_params(MetaGenerator(), cfg, dtype))
        assert [(t.shape, t.dtype) for t in meta] == [(t.shape, t.dtype)
                                                      for t in cpu]
        assert all(t.device.type == "meta" for t in meta)


def test_cpu_draws_are_unchanged():
    """`dense_init` and `embed_init` on a CPU generator: N(0, 1) in f32 from
    the generator, scaled, cast, as before the meta path."""
    got = common.dense_init(torch.Generator().manual_seed(3), (64, 32),
                            torch.bfloat16, scale=2.0)
    want = (torch.randn((64, 32), generator=torch.Generator().manual_seed(3),
                        dtype=torch.float32).mul_(2.0 / math.sqrt(64))
            .to(torch.bfloat16))
    assert torch.equal(got, want)
    got = common.embed_init(torch.Generator().manual_seed(4), (10, 8),
                            torch.float32)
    want = torch.randn((10, 8), generator=torch.Generator().manual_seed(4),
                       dtype=torch.float32).mul_(0.02)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape_name", [
    ("granite-8b", "train_4k"), ("llama4-scout-17b-a16e", "train_4k"),
    ("granite-8b", "prefill_32k"), ("qwen2-moe-a2.7b", "decode_32k"),
    ("seamless-m4t-medium", "prefill_32k"), ("recurrentgemma-9b",
                                              "train_4k")])
def test_record_keys_and_flops(arch, shape_name):
    rec = _plan(arch, shape_name, microbatches=1)
    assert KEYS <= set(rec)
    assert set(rec["memory"]) >= {"argument_gib", "output_gib", "temp_gib",
                                  "alias_gib", "peak_gib"}
    assert set(rec["cost"]) == {"flops", "bytes"}
    assert rec["collectives"]["hbm_bytes_est"] > 0
    assert rec["mesh"] == "1x1" and rec["temp_unsplit_over_model"] is False
    cfg, shape = reduced(get_config(arch)), _tiny(shape_name)
    lo = roofline.model_flops_for(rec, shape=shape)
    hi = 2 * roofline.analytic_hw_flops(rec, cfg=cfg, shape=shape)
    assert lo <= rec["cost"]["flops"] <= hi
    m = rec["memory"]
    assert m["peak_gib"] == pytest.approx(
        m["argument_gib"] + m["output_gib"] + m["temp_gib"] - m["alias_gib"])


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("averaging,n_nodes", [("exact", None),
                                               ("gossip", 4)])
def test_argument_bytes_are_the_cpu_state(averaging, n_nodes):
    """On a 1 x 1 mesh the arguments are the whole state (bf16 parameters,
    f32 masters and moments; 4 nodes' copies in the gossip mode) and the
    batch of int64 ids, to the byte."""
    cfg = reduced(get_config("granite-8b"))
    shape = _tiny("train_4k")
    rec = dryrun.plan("granite-8b", "train_4k", ONE, cfg=cfg, shape=shape,
                      averaging=averaging, rounds=2, n_nodes=n_nodes,
                      microbatches=1)
    run = RunConfig(model=cfg, shape=shape,
                    averaging=AveragingConfig(averaging, 2),
                    param_dtype="bfloat16", master_weights=True)
    state = trainer.init_state(run, torch.Generator().manual_seed(0))
    if n_nodes:
        state = trainer.replicate_for_nodes(state, n_nodes)
    batch = registry.synth_batch(torch.Generator().manual_seed(0), cfg, 8,
                                 256)
    assert rec["master_weights"] is True and rec["n_nodes"] == (n_nodes or 1)
    assert rec["memory"]["argument_gib"] * 2**30 == _nbytes(state) + \
        _nbytes(batch)
    assert rec["memory"]["alias_gib"] * 2**30 == _nbytes(state)
    assert rec["collectives"] == {"hbm_bytes_est":
                                  rec["collectives"]["hbm_bytes_est"]}


@pytest.mark.parametrize("arch,layers,seq", [
    ("mamba2-2.7b", 2, 128), ("recurrentgemma-9b", 5, 160),
    ("seamless-m4t-medium", 2, 64)])
def test_last_families_train_rounds_are_planned(arch, layers, seq):
    """A gossip round of the ssm, hybrid and encoder-decoder families is
    traced, not refused: 4 nodes in bf16 with f32 masters at the reduced
    sizes the trainer is held at (tests/test_torch_family_trainer.py), its
    arguments the mixed-dtype state (the SSD's and the RG-LRU's f32
    leaves) and the batch (seamless's frames included) to the byte, and no
    launch counted."""
    cfg = reduced(get_config(arch), layers=layers)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                                global_batch=8)
    ops.reset_launches()
    rec = dryrun.plan(arch, "train_4k", ONE, cfg=cfg, shape=shape,
                      averaging="gossip", rounds=2, n_nodes=4)
    assert "model_axis_refused" not in rec and rec["n_nodes"] == 4
    assert rec["master_weights"] is True and rec["cost"]["flops"] > 0
    assert not any(ops.launches.values())
    run = RunConfig(model=cfg, shape=shape,
                    averaging=AveragingConfig("gossip", 2),
                    param_dtype="bfloat16", master_weights=True)
    state = trainer.replicate_for_nodes(
        trainer.init_state(run, torch.Generator().manual_seed(0)), 4)
    dtypes = {t.dtype for t in tree_leaves(state.params)}
    assert dtypes == ({torch.bfloat16} if cfg.is_encdec
                      else {torch.bfloat16, torch.float32})
    batch = dryrun._tokens_long(registry.input_specs(cfg, shape))
    assert ("frames" in batch) == cfg.is_encdec
    assert rec["memory"]["argument_gib"] * 2**30 == _nbytes(state) + \
        _nbytes(batch)


def test_prefill_argument_bytes_are_the_cpu_serve_state():
    cfg = reduced(get_config("granite-8b"))
    rec = _plan("granite-8b", "prefill_32k")
    params = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                  torch.bfloat16)
    st = engine.init_serve(cfg, 8, 256, torch.bfloat16, device="cpu")
    batch = registry.synth_batch(torch.Generator().manual_seed(0), cfg, 8,
                                 256, mode="prefill")
    assert rec["memory"]["argument_gib"] * 2**30 == (
        _nbytes(params) + _nbytes(batch) + _nbytes(st.cache)
        + _nbytes(st.last_tokens))
    assert rec["memory"]["alias_gib"] * 2**30 == _nbytes(st.cache)


def test_model_axis_is_planned_not_executed():
    """On a {data 4, model 2} mesh serving keeps the model axis planned
    (ROADMAP.md queue 1 item 7; every train step executes there): a
    reduced mamba2-2.7b prefill, forward only, places its parameters over
    the model axis and its batch and cache over the data axes, so its
    arguments shrink; the temporaries are the unsplit bound (flagged), and
    the Megatron split's activation all-reduces are planned: two per
    layer forward, of the rank's tokens in bf16."""
    cfg = reduced(get_config("mamba2-2.7b"))
    kw = dict(cfg=cfg, shape=_tiny("prefill_32k"))
    one = dryrun.plan("mamba2-2.7b", "prefill_32k", ONE, **kw)
    rec = dryrun.plan("mamba2-2.7b", "prefill_32k",
                      dryrun.parse_mesh("4x2"), **kw)
    assert rec["temp_unsplit_over_model"] is True
    assert rec["model_axis_refused"] == dryrun.SERVING_REFUSAL
    assert "planned, not executed" in rec["model_axis_refused"]
    assert "collectives_model" not in rec
    assert rec["memory"]["argument_gib"] < one["memory"]["argument_gib"] / 2
    planned = rec["collectives_planned"]
    assert planned["all-reduce.count"] == 2 * cfg.num_layers
    tokens = 8 // 4 * 256
    assert planned["all-reduce"] == 2 * cfg.num_layers * tokens * \
        cfg.d_model * 2


def test_model_axis_executes_for_the_dense_family():
    """reduced granite-8b at d_model 512 (8 heads, 2 KV heads) on {data 4,
    model 2}: the step is traced as each rank runs it, so nothing is
    planned or unsplit; the model axis's f32 all-reduces come from the
    trace: per layer the row splits' two forward, the one remat
    recomputes (the FFN's reduction ends the layer, so its recompute
    stops before it) and the column splits' two backward, plus the vocab
    split's four (the embedding, the loss's max and sums, the
    unembedding's backward); the exact mode's data axis all-gathers and
    reduce-scatters every leaf (ZeRO-1) and reduces the metrics once."""
    cfg = reduced(get_config("granite-8b"), d_model=512)
    mesh = dryrun.parse_mesh("4x2")
    shape = _tiny("train_4k")
    rec = dryrun.plan("granite-8b", "train_4k", mesh, cfg=cfg, shape=shape,
                      microbatches=1)
    assert rec["temp_unsplit_over_model"] is False
    assert rec["collectives_planned"] == {} and "model_axis_refused" not in rec
    model = rec["collectives_model"]
    assert model["all-reduce.count"] == 5 * cfg.num_layers + 4
    tokens = shape.global_batch // 4 * shape.seq_len
    act = 4 * tokens * cfg.d_model  # one f32 activation
    assert model["all-reduce"] == (5 * cfg.num_layers + 2) * act + 4 * (
        tokens + 2 * tokens)
    n_leaves = len(tree_leaves(registry.init_params(MetaGenerator(), cfg)))
    coll = rec["collectives"]
    assert coll["all-gather.count"] == coll["reduce-scatter.count"] == \
        n_leaves
    assert coll["all-reduce.count"] == model["all-reduce.count"] + 1
    assert rec["staged_bytes"] == dryrun.staged_bytes(coll)
    # the arguments are the ZeRO-1 blocks: a quarter of the model shard's
    one = dryrun.plan("granite-8b", "train_4k", ONE, cfg=cfg, shape=shape,
                      microbatches=1)
    state = (one["memory"]["argument_gib"] - rec["memory"]["argument_gib"])
    assert state > 0 and rec["memory"]["peak_gib"] < one["memory"]["peak_gib"]


def test_refused_families_keep_the_model_axis_planned():
    """What stays planned keeps both flags and says why: a reduced
    recurrentgemma-9b prefill on a model axis of 2, forward only (its
    RG-LRU and local-attention layers execute there in training:
    tests/test_torch_model_axis_families.py)."""
    rec = _plan("recurrentgemma-9b", "prefill_32k", dryrun.parse_mesh("4x2"))
    assert rec["temp_unsplit_over_model"] is True
    cfg = reduced(get_config("recurrentgemma-9b"))
    assert rec["collectives_planned"]["all-reduce.count"] == \
        2 * cfg.num_layers
    assert rec["model_axis_refused"] == dryrun.SERVING_REFUSAL
    assert "collectives_model" not in rec
    train = _plan("recurrentgemma-9b", "train_4k", dryrun.parse_mesh("4x2"),
                  microbatches=1)
    assert train["temp_unsplit_over_model"] is False
    assert "model_axis_refused" not in train


def test_full_width_plan_allocates_nothing():
    """granite-8b's decode_32k on one card at full width: hundreds of GiB
    planned, on meta tensors only."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rec = dryrun.run_dryrun("granite-8b", "decode_32k", mesh=ONE,
                            print_analysis=False)
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert rec["memory"]["argument_gib"] > 100 and not rec["fits"]
    assert grown * 1024 < 2**30
    lo, hi = roofline.model_flops_for(rec), 2 * roofline.analytic_hw_flops(
        rec)
    assert lo <= rec["cost"]["flops"] <= hi


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def test_combos_are_the_references_plus_one_card():
    key = lambda c: (c["arch"], c["shape"], c["tag"], c["multi_pod"],
                     c["averaging"], c.get("rounds", 1))
    want = [key(c) for c in jsweep.combos("all")]
    got = [key(c) for c in sweep.combos("all")]
    assert got[:len(want)] == want
    onecard = list(sweep.combos("onecard"))
    assert got[len(want):] == [key(c) for c in onecard]
    assert len(onecard) == 40 and all(c["mesh"] == "1x1" for c in onecard)
    assert [key(c) for c in sweep.combos("baselines")] == [
        key(c) for c in jsweep.combos("baselines")]


def test_run_combo_one_reduced_combo(tmp_path):
    c = {"arch": "granite-8b", "shape": "train_4k", "multi_pod": False,
         "mesh": "1x1", "averaging": "gossip", "rounds": 2, "tag": "onecard",
         "reduced": True}
    out = tmp_path / "rec.json"
    r = sweep.run_combo(c, timeout=300, out=str(out))
    assert r["ok"], r["err"]
    rec = json.loads(out.read_text())
    assert KEYS <= set(rec) and rec["mesh"] == "1x1"
    assert rec["averaging"] == "gossip" and rec["n_nodes"] == 1
    assert roofline.analyze(rec, cfg=reduced(get_config("granite-8b")),
                            shape=_tiny("train_4k")).step_time_s > 0


def test_parse_mesh():
    assert dryrun.parse_mesh("2x16x16").shape == {"pod": 2, "data": 16,
                                                 "model": 16}
    assert dryrun.mesh_name(dryrun.parse_mesh("4x1")) == "4x1"
    with pytest.raises(ValueError, match="DxM"):
        dryrun.parse_mesh("8")
