"""The port's planning tables against the JAX package's: `input_specs`
(`repro_torch.models.registry`) and the roofline's formulas
(`repro_torch.roofline`), for every arch x shape; and the H100 roofline
over a dry-run record.

* `input_specs` gives the reference's shapes and dtypes (meta tensors).
* `model_flops_for` and `analytic_hw_flops` equal the reference's (rel
  1e-12) on the same records, the 500k window override included; the
  dry-run's `TRAIN_MICROBATCHES` and `WINDOWED_FOR_500K` are the
  reference's, read from its source (`repro.launch.dryrun` is not
  imported: it sets XLA_FLAGS for 512 host devices when imported, which
  would change every later JAX test in the process).
* `analyze` reads chips from the record's mesh and charges the card's
  peaks (989.4 TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s NVLink a direction);
  `load_artifacts`, `table` and `main` print the planned table.
"""
import ast
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from repro import roofline as jroofline
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.models import registry as jregistry
from repro_torch import roofline
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun
from repro_torch.models import registry

REF_DRYRUN = os.path.join(os.path.dirname(__file__), "..", "src", "repro",
                          "launch", "dryrun.py")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    for name in SHAPES:
        want = jregistry.input_specs(jcfg, JSHAPES[name])
        got = registry.input_specs(cfg, SHAPES[name])
        assert set(got) == set(want), (arch, name)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (arch, name, k)
            assert np.dtype(want[k].dtype).name == {
                "int32": "int32", "bfloat16": "bfloat16"}[
                str(v.dtype).removeprefix("torch.")], (arch, name, k)
    assert jnp.dtype(want["tokens"].dtype) == jnp.int32


def _record(arch, shape_name):
    cfg = get_config(arch)
    return {"arch": arch, "shape": shape_name,
            "mode": SHAPES[shape_name].mode,
            "active_params": cfg.active_param_count(),
            "window_override": dryrun.window_override_for(arch, shape_name)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_flop_formulas_match_reference(arch):
    for shape_name in SHAPES:
        rec = _record(arch, shape_name)
        assert rec["active_params"] == jget_config(arch).active_param_count()
        for port, ref in ((roofline.model_flops_for, jroofline.model_flops_for),
                          (roofline.analytic_hw_flops,
                           jroofline.analytic_hw_flops)):
            np.testing.assert_allclose(port(dict(rec)), ref(dict(rec)),
                                       rtol=1e-12, err_msg=shape_name)


def test_dryrun_tables_are_the_references():
    """`TRAIN_MICROBATCHES` and `WINDOWED_FOR_500K` as the reference's
    module assigns them (read from its source)."""
    tree = ast.parse(open(REF_DRYRUN).read())
    ref = {t.id: ast.literal_eval(node.value) for node in tree.body
           if isinstance(node, ast.Assign) for t in node.targets
           if isinstance(t, ast.Name) and t.id in ("TRAIN_MICROBATCHES",
                                                   "WINDOWED_FOR_500K")}
    assert ref == {"TRAIN_MICROBATCHES": dryrun.TRAIN_MICROBATCHES,
                   "WINDOWED_FOR_500K": dryrun.WINDOWED_FOR_500K}


def _fake_rec(mesh="16x16", mode="train"):
    shape = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}[mode]
    rec = _record("granite-8b", shape)
    rec.update(mesh=mesh, trips={"scale": 1}, microbatches=1,
               cost={"flops": 4e15, "bytes": 1e12},
               memory={"peak_gib": 40.0},
               collectives={"all-reduce": 1e9, "all-reduce.count": 3,
                            "collective-permute": 2e9,
                            "hbm_bytes_est": 6.7e12},
               collectives_planned={"all-reduce": 5e8})
    return rec


def test_analyze_charges_the_h100():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989.4e12, 3.35e12, 450e9)
    assert "H100" in roofline.CARD and "700 W" in roofline.CARD
    rec = _fake_rec()
    r = roofline.analyze(rec)
    assert r.chips == 256
    assert r.compute_s == pytest.approx(
        roofline.analytic_hw_flops(rec) / 256 / 989.4e12)
    assert r.memory_s == pytest.approx(6.7e12 / 16 / 3.35e12)
    assert r.collective_s == pytest.approx((2 * 1.5e9 + 2e9) / 450e9)
    assert r.step_time_s == max(r.compute_s, r.memory_s, r.collective_s)
    assert r.mfu == pytest.approx(
        roofline.model_flops_for(rec) / (r.step_time_s * 256 * 989.4e12))
    assert r.useful_ratio == pytest.approx(
        roofline.model_flops_for(rec) / (4e15 * 16))
    pod = roofline.analyze(_fake_rec("2x16x16"))
    assert pod.chips == 512 and pod.compute_s == pytest.approx(
        r.compute_s / 2)
    one = roofline.analyze(_fake_rec("1x1", "prefill"))
    assert one.chips == 1 and one.memory_s == pytest.approx(6.7e12 / 3.35e12)
    assert one.dominant == "compute"


def test_analyze_takes_an_executed_model_axis_per_rank():
    """A record whose model axis executes (`temp_unsplit_over_model`
    false) is one rank's trace: its HBM estimate is not split again and
    its FLOPs count every chip."""
    rec = _fake_rec()
    planned = roofline.analyze(dict(rec, temp_unsplit_over_model=True))
    executed = roofline.analyze(dict(rec, temp_unsplit_over_model=False))
    assert planned.memory_s == pytest.approx(6.7e12 / 16 / 3.35e12)
    assert executed.memory_s == pytest.approx(6.7e12 / 3.35e12)
    assert executed.useful_ratio == pytest.approx(
        roofline.model_flops_for(rec) / (4e15 * 256))


def test_table_and_main_read_artifacts(tmp_path, monkeypatch, capsys):
    for i, mesh in enumerate(("16x16", "1x1")):
        (tmp_path / f"r{i}.json").write_text(json.dumps(_fake_rec(mesh)))
    (tmp_path / "_sweep_log.json").write_text("[]")
    recs = roofline.load_artifacts(str(tmp_path / "*.json"))
    assert [r["mesh"] for r in recs] == ["16x16", "1x1"]
    text = roofline.table([roofline.analyze(r) for r in recs])
    assert text.splitlines()[0].split()[:3] == ["arch", "shape", "mesh"]
    assert len(text.splitlines()) == 4
    monkeypatch.chdir(tmp_path)
    (tmp_path / "artifacts" / "dryrun_torch").mkdir(parents=True)
    (tmp_path / "artifacts" / "dryrun_torch" / "a.json").write_text(
        json.dumps(_fake_rec("1x1")))
    roofline.main()
    out = capsys.readouterr().out
    assert "989.4 TFLOP/s" in out and "granite-8b" in out
