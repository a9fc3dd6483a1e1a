"""The port's sharding rules (`repro_torch.launch.sharding`) against the
JAX package's (`repro.launch.sharding`), on the duck-typed meshes of
tests/test_sharding.py.

* Every case of tests/test_sharding.py, the same leaves through both rule
  sets: the port's placement equals `tuple(P)` of the reference's.
* All ten archs' full parameter trees (the reference's by
  `jax.eval_shape`, the port's on the meta device) on {data 16, model 16},
  {pod 2, data 16, model 16} and {data 4, model 2}: `param_specs` and
  `zero1_specs` leaf by leaf (a per-layer leaf of the port takes the
  reference's stacked placement without its stack dim), and the bytes one
  rank holds. The one deviation (ROADMAP.md queue 1): where the
  reference's ZeRO rule puts the data axes on the stack dim, the port's
  per-layer leaf stays replicated; the leaves where that happens are
  pinned here.
* `activation_rules`, `kv_rules`, `batch_specs` and `cache_specs` for the
  four SHAPES, caches leaf by leaf.
* `local_shape` and `local_bytes`, and the abstract mesh.
"""
import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import sharding as jsh
from repro.models import registry as jregistry
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.dist import check_mesh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import registry
from repro_torch.models.common import MetaGenerator
from repro_torch.models.transformer import build_plan

torch.set_num_threads(1)


class FakeMesh:
    """Duck-typed mesh: only .shape and axis_names are consulted by the
    rules (tests/test_sharding.py's)."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
POD = FakeMesh({"pod": 2, "data": 16, "model": 16})
SMALL = FakeMesh({"data": 4, "model": 2})
MESHES = {"16x16": MESH, "2x16x16": POD, "4x2": SMALL}


def _jleaf(shape):
    return jax.ShapeDtypeStruct(shape, jnp.bfloat16)


def _tleaf(shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def _norm(spec):
    """A placement with each one-name axis tuple as that name, as the
    installed jax's `PartitionSpec` stores it."""
    return tuple(d[0] if isinstance(d, tuple) and len(d) == 1 else d
                 for d in spec)


def _flat_ref(specs):
    """{path: tuple(P)} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(getattr(e, "key", getattr(e, "idx", None)) for e in p):
            _norm(tuple(s)) for p, s in flat}


def _flat_port(tree, path=()):
    """{path: leaf} of a port tree, or {path: placement} of a placement
    tree (a plain tuple is a placement; layers are lists)."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat_port(tree[key], path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flat_port(x, path + (i,)).items()}
    return {path: _norm(tree) if isinstance(tree, tuple) else tree}


# ---------------------------------------------------------------------------
# tests/test_sharding.py's cases, through both rule sets
# ---------------------------------------------------------------------------

CASES = {
    "basic_name_specs": ("param", {"wq": (4096, 4096),
                                   "w_down": (14336, 4096),
                                   "scale": (4096,)}, MESH, {}),
    "stacked_layers_lead_padding": ("param", {"wq": (36, 4096, 4096)}, MESH,
                                    {}),
    "vocab_fallback": ("param", {"embed": (50280, 2560)}, MESH, {}),
    "vocab_divides": ("param", {"embed": (49152, 4096)}, MESH, {}),
    "moe_expert_fallback": ("param", {"we_gate": (24, 60, 2048, 1408)}, MESH,
                            {}),
    "moe_expert_parallel": ("param", {"we_gate": (12, 16, 5120, 8192)}, MESH,
                            {}),
    "node_axes_prepended": ("param", {"wq": (16, 4096, 4096)}, MESH,
                            {"node_axes": ("data",)}),
    "zero1_dp_on_divisible_dim": ("zero1", {"wq": (36, 4096, 4096)}, MESH,
                                  {}),
    "zero1_nothing_divides": ("zero1", {"lam": (37,)}, MESH, {}),
    "multipod_dp_is_pod_and_data": ("zero1", {"wq": (4096, 4096)}, POD, {}),
}

WANT = {  # tests/test_sharding.py's expected placements, as tuples (`_norm`)
    "basic_name_specs": {("wq",): (None, "model"),
                         ("w_down",): ("model", None), ("scale",): (None,)},
    "stacked_layers_lead_padding": {("wq",): (None, None, "model")},
    "vocab_fallback": {("embed",): (None, "model")},
    "vocab_divides": {("embed",): ("model", None)},
    "moe_expert_fallback": {("we_gate",): (None, None, None, "model")},
    "moe_expert_parallel": {("we_gate",): (None, "model", None, None)},
    "node_axes_prepended": {("wq",): ("data", None, "model")},
    "zero1_dp_on_divisible_dim": {("wq",): (None, "data", "model")},
    "zero1_nothing_divides": {("lam",): (None,)},
    "multipod_dp_is_pod_and_data": {("wq",): (("pod", "data"), "model")},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_cases(case):
    kind, shapes, mesh, kw = CASES[case]
    jfn = jsh.param_specs if kind == "param" else jsh.zero1_specs
    tfn = tsh.param_specs if kind == "param" else tsh.zero1_specs
    ref = _flat_ref(jfn({k: _jleaf(v) for k, v in shapes.items()}, mesh,
                        **kw))
    got = _flat_port(tfn({k: _tleaf(v) for k, v in shapes.items()}, mesh,
                         **kw))
    assert got == ref == WANT[case]


@pytest.mark.parametrize("shape_name,key,kv", [
    ("decode_32k", "kv", (40, 128, 32768, 4, 128)),
    ("long_500k", "kv", (36, 1, 524288, 8, 128)),
    ("decode_32k", "ssd", None)])
def test_reference_cache_cases(shape_name, key, kv):
    """tests/test_sharding.py's cache cases: the reference's stacked
    leaves, and the port's per-layer leaves (their placement without the
    stack dim)."""
    if key == "kv":
        jcache = {"layers": [{"k": _jleaf(kv), "v": _jleaf(kv)}]}
        tcache = [{"k": _tleaf(kv[1:]), "v": _tleaf(kv[1:])}]
    else:
        jcache = {"layers": [{"h": _jleaf((64, 128, 80, 64, 128)),
                              "conv": _jleaf((64, 128, 3, 5376))}]}
        tcache = [{"h": _tleaf((128, 80, 64, 128)),
                   "conv": _tleaf((128, 3, 5376))}]
    ref = _flat_ref(jsh.cache_specs(jcache, MESH, JSHAPES[shape_name]))
    got = _flat_port(tsh.cache_specs(tcache, MESH, SHAPES[shape_name]))
    for (_, i, name), spec in ref.items():
        assert spec[0] is None
        assert got[(i, name)] == spec[1:], name
    if shape_name == "long_500k":
        assert got[(0, "k")] == (None, "data", None, "model")
    elif key == "kv":
        assert got[(0, "k")] == ("data", "model", None, None)
    else:
        assert got[(0, "h")] == ("data", "model", None, None)
        assert got[(0, "conv")] == ("data", None, "model")


# ---------------------------------------------------------------------------
# all ten archs' full trees
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _trees(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jparams = jax.eval_shape(lambda k: jregistry.init_params(
        k, jcfg, jnp.bfloat16), jax.random.PRNGKey(0))
    params = registry.init_params(MetaGenerator(), cfg, torch.bfloat16)
    return jcfg, cfg, jparams, params


def _ref_path(path, cfg):
    """(the reference's path, stacked) of a port leaf path."""
    if path[0] == "blocks":
        period, n_rep, _ = build_plan(cfg)
        n = len(period)
        i = path[1]
        if i < n * n_rep:
            return ("layers", i % n) + path[2:], True
        return ("tail", i - n * n_rep) + path[2:], False
    if path[0] in ("encoder", "decoder"):
        return (path[0],) + path[2:], True
    return path, False


def _local(shape, spec, mesh, itemsize):
    return math.prod(tsh.local_shape(tuple(shape), spec, mesh)) * itemsize


# leaves whose reference ZeRO placement takes the stack dim (ROADMAP.md
# queue 1, deviations): the port's per-layer leaf stays replicated over the
# data axes there, and its rank holds more bytes
_SSD = ("layers", 0, "attn")
_RG = [("layers", i, "attn") for i in (0, 1)]
ZERO_STACK_DIM = {
    # 1-dim leaves whose one dim the model axis takes: conv_b, norm_scale
    ("mamba2-2.7b", "16x16"): {_SSD + ("conv_b",), _SSD + ("norm_scale",)},
    ("mamba2-2.7b", "4x2"): {_SSD + ("conv_b",), _SSD + ("norm_scale",)},
    # and 80 heads do not split over 32 data ranks: A_log, D, dt_bias
    ("mamba2-2.7b", "2x16x16"): {_SSD + (k,) for k in (
        "conv_b", "norm_scale", "A_log", "D", "dt_bias")},
    # 12 repeats of the period split over 4 data ranks, not over 16 or 32
    ("recurrentgemma-9b", "4x2"): {p + (k,) for p in _RG
                                   for k in ("conv_b", "lam")},
}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_trees_match_reference(arch):
    jcfg, cfg, jparams, params = _trees(arch)
    jleaves = {p: leaf for p, leaf in _flat_ref_leaves(jparams).items()}
    tleaves = _flat_port(params)
    # every reference leaf (and layer of a stack) has exactly one port leaf
    covered = {}
    for path, leaf in tleaves.items():
        rpath, stacked = _ref_path(path, cfg)
        jl = jleaves[rpath]
        assert tuple(leaf.shape) == (jl.shape[1:] if stacked else jl.shape)
        assert str(leaf.dtype).removeprefix("torch.") == str(jl.dtype)
        covered[rpath] = covered.get(rpath, 0) + 1
    assert set(covered) == set(jleaves)
    for rpath, n in covered.items():
        assert n == (jleaves[rpath].shape[0] if _ref_path_stacked(rpath)
                     else 1)
    n_stacked = None if cfg.is_encdec else tsh.stacked_layers(cfg)
    for mesh_name, mesh in MESHES.items():
        for kind in ("param", "zero1"):
            if kind == "param":
                ref = _flat_ref(jsh.param_specs(jparams, mesh))
                got = _flat_port(tsh.param_specs(params, mesh))
            else:
                ref = _flat_ref(jsh.zero1_specs(jparams, mesh))
                got = _flat_port(tsh.zero1_specs(params, mesh,
                                                 n_stacked=n_stacked))
            deviating = set()
            port_bytes = 0
            for path, spec in got.items():
                rpath, stacked = _ref_path(path, cfg)
                want = ref[rpath]
                if stacked:
                    if want[0] is not None:
                        deviating.add(rpath)
                    want = want[1:]
                assert spec == want, (mesh_name, kind, path, spec, want)
                leaf = tleaves[path]
                port_bytes += _local(leaf.shape, spec, mesh,
                                     leaf.element_size())
            ref_bytes = sum(_local(jl.shape, ref[p], mesh, jl.dtype.itemsize)
                            for p, jl in jleaves.items())
            expected = set() if kind == "param" else ZERO_STACK_DIM.get(
                (arch, mesh_name), set())
            assert deviating == expected, (mesh_name, kind, deviating)
            extra = 0
            for p in deviating:  # replicated over dp here, split there
                jl = jleaves[p]
                whole = _local(jl.shape, (None,) + ref[p][1:], mesh,
                               jl.dtype.itemsize)
                extra += whole - _local(jl.shape, ref[p], mesh,
                                        jl.dtype.itemsize)
            assert port_bytes == ref_bytes + extra, (mesh_name, kind)
            assert tsh.local_bytes(params, tsh.zero1_specs(
                params, mesh, n_stacked=n_stacked) if kind == "zero1"
                else tsh.param_specs(params, mesh), mesh) == port_bytes


def _flat_ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(getattr(e, "key", getattr(e, "idx", None)) for e in p):
            leaf for p, leaf in flat}


def _ref_path_stacked(rpath):
    return rpath[0] in ("layers", "encoder", "decoder")


def test_zero1_stack_dim_deviation_is_the_reference_rule():
    """The pinned deviation in its smallest form: mamba2-2.7b's stacked
    [64, 80] A_log on 32 data ranks; the reference splits the 64 layers
    (80 % 32 != 0), the port's per-layer [80] leaf cannot, and a rank
    holds 32x the reference's bytes of it."""
    ref = jsh.zero1_specs({"layers": [{"A_log": _jleaf((64, 80))}]}, POD)
    assert tuple(ref["layers"][0]["A_log"]) == (("pod", "data"), None)
    got = tsh.zero1_specs({"blocks": [{"A_log": _tleaf((80,))}] * 64}, POD)
    assert all(g["A_log"] == (None,) for g in got["blocks"])
    rank_ref = _local((64, 80), (("pod", "data"), None), POD, 2)
    rank_port = 64 * _local((80,), (None,), POD, 2)
    assert rank_port == 32 * rank_ref


# ---------------------------------------------------------------------------
# activation, KV, batch and cache rules for the four shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_rules_for_shapes_match_reference(shape_name):
    for mesh_name, mesh in MESHES.items():
        for node_axis in (False, True):
            ref = jsh.activation_rules(mesh, JSHAPES[shape_name], node_axis)
            got = tsh.activation_rules(mesh, SHAPES[shape_name], node_axis)
            assert {k: _norm(v) for k, v in got.items()} == {
                k: _norm(tuple(v)) for k, v in ref.items()}
        for kv_heads in (0, 1, 4, 8, 16, 32):
            ref = jsh.kv_rules(mesh, JSHAPES[shape_name], kv_heads)
            got = tsh.kv_rules(mesh, SHAPES[shape_name], kv_heads)
            assert {k: _norm(v) for k, v in got.items()} == {
                k: _norm(tuple(v)) for k, v in ref.items()}, kv_heads
        for arch in ("granite-8b", "seamless-m4t-medium", "chameleon-34b"):
            jb = jregistry.input_specs(jget_config(arch), JSHAPES[shape_name])
            tb = registry.input_specs(get_config(arch), SHAPES[shape_name])
            for node_axis in (False, True):
                ref = _flat_ref(jsh.batch_specs(jb, mesh, JSHAPES[shape_name],
                                                node_axis=node_axis))
                got = _flat_port(tsh.batch_specs(tb, mesh, SHAPES[shape_name],
                                                 node_axis=node_axis))
                assert got == ref, (mesh_name, arch)


CACHE_ARCHS = ("granite-8b", "minicpm3-4b", "mamba2-2.7b", "recurrentgemma-9b",
               "seamless-m4t-medium", "starcoder2-15b")


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_specs_match_reference(shape_name):
    """Every leaf of six families' caches at the shape's batch and length
    (the reference's stacked leaves; the port's per-layer ones)."""
    shape, jshape = SHAPES[shape_name], JSHAPES[shape_name]
    for arch in CACHE_ARCHS:
        jcfg, cfg = jget_config(arch), get_config(arch)
        wo = 8192 if shape_name == "long_500k" and arch in (
            "granite-8b", "minicpm3-4b", "seamless-m4t-medium") else 0
        jcache = jax.eval_shape(lambda: jregistry.init_cache(
            jcfg, jshape.global_batch, jshape.seq_len, jnp.bfloat16,
            window_override=wo))
        tcache = registry.init_cache(cfg, shape.global_batch, shape.seq_len,
                                     torch.bfloat16, window_override=wo,
                                     device="meta")
        jleaves = _flat_ref_leaves(jcache)
        tleaves = _flat_port(tcache)
        for mesh_name, mesh in MESHES.items():
            ref = _flat_ref(jsh.cache_specs(jcache, mesh, jshape))
            got = _flat_port(tsh.cache_specs(tcache, mesh, shape))
            seen = set()
            for path, spec in got.items():
                rpath, stacked = _cache_ref_path(path, cfg, wo)
                want = ref[rpath]
                jl = jleaves[rpath]
                assert tuple(tleaves[path].shape) == (
                    jl.shape[1:] if stacked else jl.shape)
                if stacked:
                    assert want[0] is None
                    want = want[1:]
                assert spec == want, (arch, mesh_name, path, spec, want)
                seen.add(rpath)
            assert seen == set(ref), (arch, mesh_name)


def _cache_ref_path(path, cfg, wo):
    if cfg.is_encdec:
        if path[0] == "decoder":
            return ("decoder", "self") + path[2:], True
        return path, False
    period, n_rep, _ = build_plan(cfg, wo)
    n = len(period)
    i = path[0]
    if i < n * n_rep:
        return ("layers", i % n) + path[1:], True
    return ("tail", i - n * n_rep) + path[1:], False


# ---------------------------------------------------------------------------
# local blocks and the abstract mesh
# ---------------------------------------------------------------------------


def test_local_shape_and_bytes():
    assert tsh.local_shape((4096, 4096), (None, "model"), MESH) == (4096, 256)
    assert tsh.local_shape((36, 4096, 4096), (None, ("data",), "model"),
                           MESH) == (36, 256, 256)
    assert tsh.local_shape((4096, 4096), (("pod", "data"), "model"),
                           POD) == (128, 256)
    assert tsh.local_shape((8, 3), (), MESH) == (8, 3)
    tree = {"a": torch.empty((64, 32), dtype=torch.bfloat16, device="meta"),
            "b": [torch.empty((10,), dtype=torch.float32, device="meta")],
            "n": 3}
    specs = {"a": (("data",), "model"), "b": [(None,)], "n": ()}
    assert tsh.local_bytes(tree, specs, SMALL) == 16 * 16 * 2 + 10 * 4


def test_abstract_mesh_plans_what_no_group_executes():
    for shape, axes in ((( 16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model")),
                        ((1, 1), ("data", "model"))):
        mesh = tmesh.abstract_mesh(shape, axes)
        assert mesh.shape == dict(zip(axes, shape))
        assert mesh.axis_names == axes and mesh.group is None
    assert tmesh.production_shape(True) == ((2, 16, 16),
                                            ("pod", "data", "model"))
    mesh = tmesh.abstract_mesh(*tmesh.production_shape())
    specs = tsh.zero1_specs({"wq": _tleaf((4096, 4096))}, mesh)
    assert specs["wq"] == (("data",), "model")  # the port keeps the tuple
    with pytest.raises(NotImplementedError, match="planned, not executed"):
        check_mesh(mesh, "the PCA path")
    with pytest.raises(ValueError, match="differ in rank"):
        tmesh.abstract_mesh((2, 2), ("data",))
