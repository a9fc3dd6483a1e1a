"""The port's configs have the reference's fields and defaults, dataclass for
dataclass, so the two packages cannot drift."""
import dataclasses
import inspect

import pytest

import repro.configs.base as jbase
import repro.configs.paper_pca as jpca
import repro_torch.configs.base as tbase
import repro_torch.configs.paper_pca as tpca


def _dataclasses(mod):
    return sorted(name for name, obj in vars(mod).items()
                  if inspect.isclass(obj) and dataclasses.is_dataclass(obj)
                  and obj.__module__ == mod.__name__)


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = dataclasses.asdict(f.default_factory()) \
                if dataclasses.is_dataclass(f.default_factory) \
                else f.default_factory()
        else:
            out[f.name] = dataclasses.MISSING
    return out


def _type_name(t):
    """Annotation as written (a string under postponed evaluation, else the
    class's own name, which differs between the packages only by module)."""
    return t if isinstance(t, str) else getattr(t, "__name__", str(t))


def _comparable(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@pytest.mark.parametrize("mods", [(jbase, tbase), (jpca, tpca)],
                         ids=["base", "paper_pca"])
def test_same_dataclasses_fields_and_defaults(mods):
    jmod, tmod = mods
    names = _dataclasses(jmod)
    assert names == _dataclasses(tmod)
    assert names  # the scan found the configs
    for name in names:
        jcls, tcls = getattr(jmod, name), getattr(tmod, name)
        jf = [(f.name, _type_name(f.type)) for f in dataclasses.fields(jcls)]
        tf = [(f.name, _type_name(f.type)) for f in dataclasses.fields(tcls)]
        assert jf == tf, name
        jd = {k: _comparable(v) for k, v in _defaults(jcls).items()}
        td = {k: _comparable(v) for k, v in _defaults(tcls).items()}
        assert jd == td, name
        assert (jcls.__dataclass_params__.frozen
                == tcls.__dataclass_params__.frozen), name


def test_paper_pca_instances_match():
    for name in ("FIG7", "HIGHD"):
        assert (dataclasses.asdict(getattr(tpca, name))
                == dataclasses.asdict(getattr(jpca, name)))
    assert (dataclasses.asdict(tpca.PCARunConfig())
            == dataclasses.asdict(jpca.PCARunConfig()))
