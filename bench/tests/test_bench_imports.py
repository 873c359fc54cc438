"""No module of the JAX stack or the JAX package in a run, and a
reference that imports nothing of the program."""
import subprocess
import sys
import textwrap

from bench import harness as H
from conftest import ROOT


def _modules_after(imports: str) -> set:
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
        {imports}
        print("\\n".join(sorted(sys.modules)))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(out.stdout.split())


def test_top_level_names_are_compared_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "jaxtyping_like",
                 "reprox"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not [m for m in H.forbidden_modules()
                if m.startswith(("repro_torch", "jaxtyping", "reprox"))]
    for name in ("repro", "repro.core", "jax", "jaxlib.xla", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
        assert name in H.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)


def test_the_harness_and_drivers_load_no_jax():
    mods = _modules_after(
        "from bench import harness, serving, work, weights, readers\n"
        "        from bench.traffic import generate\n"
        "        from bench.reference import lm, compare\n"
        "        import importlib.util, pathlib\n"
        "        for p in pathlib.Path('bench/drivers').glob('*.py'):\n"
        "            harness.load_module(p, 'd_' + p.stem)\n"
        "        for p in pathlib.Path('bench/metrics').glob('*.py'):\n"
        "            harness.load_module(p, 'm_' + p.stem.replace('.', '_'))\n"
        "        import repro_torch.serving.engine, repro_torch.launch.steps")
    bad = {m for m in mods if m.split(".", 1)[0] in H.FORBIDDEN}
    assert not bad, bad


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules_after("from bench.reference import lm, compare")
    assert not {m for m in mods if m.split(".", 1)[0]
                in H.FORBIDDEN + ("repro_torch",)}
