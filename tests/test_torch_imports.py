"""Every module of the port imports nothing of JAX, flax, msgpack or the JAX
package: checked in a fresh interpreter, whose sys.modules starts free of
them (tests/conftest.py imports jax into this one)."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "acousticswarms_speech_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "acousticswarms_speech_tpu")


def test_new_modules_import_no_jax():
    """Every module that pkgutil.walk_packages finds in the port."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"forbidden = {FORBIDDEN!r}\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in forbidden]\n"
        f"pkg = importlib.import_module({PACKAGE!r})\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                               pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in forbidden)\n"
        "print('modules:', len(names), sorted(names))\n"
        "print('bad:', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "bad: []" in proc.stdout
    for name in ("parallel.mesh", "parallel.ranks", "parallel.dryrun",
                 "pipeline.joint", "ops.roll_kernel", "training.train",
                 "scripts.precompute_geometry", "scripts.export_release",
                 "scripts.export_if_better",
                 "scripts.seed_checkpoint_from_release", "scripts.quickstart",
                 "scripts.replay_nms", "scripts.tune_thresholds",
                 "scripts.analyze_probe", "scripts.analyze_retention",
                 "scripts.retune_release", "scripts.probe_sep_batch",
                 "scripts.run_eval_suite", "scripts.bench"):
        assert f"'{PACKAGE}.{name}'" in proc.stdout, name


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's import lines name nothing of JAX or the JAX package
    (it runs only with a card, so it is read, not run, here)."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        lines = [ln.strip() for ln in f]
    imports = [ln for ln in lines if ln.startswith(("import ", "from "))]
    assert imports
    for ln in imports:
        root = ln.split()[1].split(".")[0]
        assert root not in FORBIDDEN, ln
