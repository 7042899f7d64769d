"""The modules of the port's third slice import nothing of JAX, flax,
msgpack or the JAX package: checked in a fresh interpreter, whose
sys.modules starts free of them (tests/conftest.py imports jax into this
one)."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_MODULES = [
    "acousticswarms_speech_tpu_torch.data.roomsim",
    "acousticswarms_speech_tpu_torch.data.voicegen",
    "acousticswarms_speech_tpu_torch.data.generate_dataset",
    "acousticswarms_speech_tpu_torch.data.vctk_split",
    "acousticswarms_speech_tpu_torch.data.generate_srp_sample",
    "acousticswarms_speech_tpu_torch.data.mine_range",
    "acousticswarms_speech_tpu_torch.dsp.music",
    "acousticswarms_speech_tpu_torch.dsp.tops",
    "acousticswarms_speech_tpu_torch.utils.oracle_masks",
    "acousticswarms_speech_tpu_torch.models.convert",
    "acousticswarms_speech_tpu_torch.runtime.native",
    "acousticswarms_speech_tpu_torch.pipeline.monitor",
    "acousticswarms_speech_tpu_torch.pipeline.mic_array",
    "acousticswarms_speech_tpu_torch.training.datasets",
]
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "acousticswarms_speech_tpu")


def test_new_modules_import_no_jax():
    code = (
        "import importlib, sys\n"
        f"forbidden = {FORBIDDEN!r}\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in forbidden]\n"
        f"for name in {NEW_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in forbidden)\n"
        "print('bad:', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "bad: []" in proc.stdout


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
