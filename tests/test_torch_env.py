"""The port's launcher environment (`repro_torch.launch.env`) against the
JAX package's (`repro.launch.env`) on the same env dicts: the cases of
tests/test_env.py that have a counterpart (the tcmalloc threshold and
LD_PRELOAD, user choices kept, the --no-env-tuning escape hatch, `apply`
reporting its changes, `find_tcmalloc`). The XLA step marker and
TF_CPP_MIN_LOG_LEVEL have none: the port leaves them out.

`--compilation-cache-dir DIR` is the directory the kernel libraries build
into (`kernels._cuda.build_dir`); nothing is built on the CPU. Both
launchers take `--no-env-tuning`, and the module imports no torch.
"""
import os
import subprocess
import sys

import pytest
import torch

from repro.launch import env as jenv
from repro_torch.kernels import _cuda, ops
from repro_torch.launch import env
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train

torch.set_num_threads(1)

NOT_PORTED = ("TF_CPP_MIN_LOG_LEVEL", "XLA_FLAGS")

ENVS = [
    {},
    {"TF_CPP_MIN_LOG_LEVEL": "0",
     "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "1",
     "LD_PRELOAD": "/usr/local/lib/libcustom.so"},
    {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "7"},
    {"LD_PRELOAD": ""},
]


def _ported(changes):
    return {k: v for k, v in changes.items() if k not in NOT_PORTED}


@pytest.mark.parametrize("base", ENVS, ids=["empty", "user", "threshold",
                                            "empty-preload"])
def test_tuned_env_matches_reference(base):
    before = dict(base)
    out = env.tuned_env(base)
    assert base == before  # pure: the input dict is never mutated
    assert out == _ported(jenv.tuned_env(dict(base), tpu=False))
    assert out == _ported(jenv.tuned_env(dict(base), tpu=True))
    if "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD" not in base:
        assert out["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == \
            env.TCMALLOC_REPORT_THRESHOLD == jenv.TCMALLOC_REPORT_THRESHOLD
    if base.get("LD_PRELOAD"):
        assert "LD_PRELOAD" not in out  # a user preload wins


def test_wants_tuning_escape_hatch():
    for argv in (["prog", "--arch", "granite-8b"], ["prog", "--no-env-tuning"]):
        assert env.wants_tuning(argv) == jenv.wants_tuning(argv)
    assert not env.wants_tuning(["prog", "--no-env-tuning"])
    assert env.apply_from_argv(["prog", "--no-env-tuning"]) == {}


def test_apply_mutates_target_and_reports_changes():
    target, jtarget = {}, {}
    changes = env.apply(target)
    assert changes == _ported(jenv.apply(jtarget))
    assert changes and all(target[k] == v for k, v in changes.items())
    # a second apply is a no-op on the tuned dict (except LD_PRELOAD, which
    # depends on whether the machine ships tcmalloc)
    assert {k: v for k, v in env.apply(target).items()
            if k != "LD_PRELOAD"} == {}


def test_find_tcmalloc_matches_reference():
    tc = env.find_tcmalloc()
    assert tc == jenv.find_tcmalloc()
    assert env.TCMALLOC_PATHS == jenv.TCMALLOC_PATHS
    assert tc is None or os.path.exists(tc)


def test_compilation_cache_dir_is_the_kernel_build_dir(monkeypatch,
                                                       tmp_path):
    """The flag is peeked as the reference peeks it, independent of the
    escape hatch; it points `_cuda.build_dir()` (and every library path)
    at DIR. Nothing is built on the CPU: a wrapper given CPU tensors runs
    the plain version, and the directory is never made."""
    for argv in (["prog", "--arch", "x"],
                 ["prog", "--compilation-cache-dir", "/tmp/cc"],
                 ["prog", "--compilation-cache-dir=/tmp/cc2"],
                 ["prog", "--compilation-cache-dir"]):
        assert (env.compilation_cache_dir_from_argv(argv)
                == jenv.compilation_cache_dir_from_argv(argv))
    monkeypatch.delenv(env.KERNEL_BUILD_ENV, raising=False)
    assert _cuda.build_dir() == _cuda.BUILD_DIR
    cache = tmp_path / "kernels"
    changes = env.apply_from_argv(
        ["prog", "--no-env-tuning", "--compilation-cache-dir", str(cache)])
    assert changes == env.compilation_cache_env(str(cache)) == {
        env.KERNEL_BUILD_ENV: str(cache)}
    assert env.KERNEL_BUILD_ENV == _cuda.BUILD_DIR_ENV
    assert _cuda.build_dir() == cache
    assert _cuda.library_path("gossip_mix").parent == cache
    x = torch.randn(4, 8)
    ops.gossip_mix(x, ((0, 0.5), (1, 0.5)), 2)
    assert ops.launches["gossip_mix"] == 0 and not cache.exists()
    monkeypatch.delenv(env.KERNEL_BUILD_ENV)


def test_env_module_imports_no_torch():
    code = ("import sys; from repro_torch.launch import env; "
            "env.apply_from_argv(['prog']); "
            "print('torch' in sys.modules)")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=src),
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_launchers_take_no_env_tuning(capsys, tmp_path):
    launch_train.main(["--arch", "granite-8b", "--reduced", "--device", "cpu",
                       "--steps", "2", "--superstep", "2", "--batch", "4",
                       "--seq", "8", "--no-env-tuning",
                       "--compilation-cache-dir", str(tmp_path / "cc")])
    out = capsys.readouterr().out
    assert "plan: B=4" in out and out.count("\nround") + out.startswith(
        "round") == 1
    launch_serve.main(["--arch", "granite-8b", "--reduced", "--device", "cpu",
                       "--batch", "1", "--prompt-len", "8", "--gen", "2",
                       "--no-env-tuning"])
    assert "sample token ids:" in capsys.readouterr().out
    assert not (tmp_path / "cc").exists()  # nothing built on the CPU
