"""Guards of the port's boundaries: `src/repro_torch` and `chip_smoke.py`
never import jax or the JAX package (checked by a source scan and by an
import with both blocked in `sys.modules`, which also must start no nvcc),
the port's test files import no triton, and the port's layout mirrors
`src/repro` module by module."""
import os
import re
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)",
                       re.MULTILINE)


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _port_modules():
    mods = []
    for path in _port_sources()[1:]:
        rel = os.path.relpath(path, os.path.join(ROOT, "src"))[:-3]
        mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return mods


def test_source_scan_finds_no_jax_or_reference_import():
    sources = _port_sources()
    assert len(sources) > 15
    bad = []
    for path in sources:
        with open(path, encoding="utf-8") as f:
            for m in FORBIDDEN.finditer(f.read()):
                bad.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
    assert not bad, "\n".join(bad)


def test_port_imports_with_jax_and_reference_blocked():
    """A fresh interpreter where `import jax` and `import repro` fail imports
    every port module and chip_smoke.py (without running it) — and starts no
    process (no nvcc) and loads no kernel library while doing so."""
    code = (
        "import importlib, importlib.util, subprocess, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "def no_process(*a, **k):\n"
        "    raise AssertionError('a process was started at import')\n"
        "subprocess.Popen = subprocess.run = no_process\n"
        f"for mod in {_port_modules()!r}:\n"
        "    importlib.import_module(mod)\n"
        "spec = importlib.util.spec_from_file_location(\n"
        f"    'chip_smoke', {os.path.join(ROOT, 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not importlib.import_module('repro_torch.kernels._cuda')._entry\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_tests_import_no_triton():
    tests = [f for f in os.listdir(os.path.dirname(__file__))
             if f.startswith("test_torch_") and f.endswith(".py")]
    assert len(tests) >= 6
    for name in tests:
        with open(os.path.join(os.path.dirname(__file__), name),
                  encoding="utf-8") as f:
            text = f.read()
        assert not re.search(r"^\s*(?:import|from)\s+triton", text, re.M), name


def test_layout_mirrors_reference():
    """Every port module has its counterpart in `src/repro` (the port-only
    modules excepted), so a reader can find each reference. `dist` is the
    port's own: the reference's kernels take `jax.sharding.Mesh` and its
    collectives, where the port's take its mesh and messages."""
    own = {"repro_torch.device", "repro_torch.convert",
           "repro_torch.kernels._cuda", "repro_torch.dist"}
    missing = []
    for mod in _port_modules():
        if mod in own:
            continue
        rel = mod.replace("repro_torch", "repro", 1).replace(".", os.sep)
        if not (os.path.exists(os.path.join(ROOT, "src", rel + ".py"))
                or os.path.isdir(os.path.join(ROOT, "src", rel))):
            missing.append(mod)
    assert not missing, missing
