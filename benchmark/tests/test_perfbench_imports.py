"""What the benchmark loads: never JAX nor the JAX package, and the plain
reference nothing of the port.  Top-level names are compared whole: the
port's name begins with the JAX package's."""
import ast
import os
import subprocess
import sys

from benchmark import harness

JAX_SIDE = ("jax", "jaxlib", "flax", "acousticswarms_speech_tpu")
PORT = "acousticswarms_speech_tpu_torch"


def _loaded_after(imports: str) -> set[str]:
    """Top-level names in sys.modules of a fresh interpreter after
    `imports`."""
    code = (f"import sys; {imports}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": harness.ROOT})
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    loaded = _loaded_after(
        "import benchmark.run, benchmark.harness, benchmark.flops; "
        "from acousticswarms_speech_tpu_torch.pipeline.joint import "
        "JointPipeline")
    assert PORT in loaded
    assert not loaded & set(JAX_SIDE)


def test_reference_and_traffic_load_nothing_of_the_port():
    loaded = _loaded_after(
        "import benchmark.reference.pipeline, benchmark.reference.weights, "
        "benchmark.traffic.generator, benchmark.nets, benchmark.check, "
        "benchmark.flops, benchmark.trace")
    assert not loaded & set(JAX_SIDE + (PORT,))


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "acousticswarms_speech_tpu_torch_x",
                        sys)
    assert "acousticswarms_speech_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "acousticswarms_speech_tpu.constants",
                        sys)
    assert "acousticswarms_speech_tpu" in harness.forbidden_modules()


def test_reference_sources_import_nothing_of_the_port():
    """Every import of the reference's and the traffic's sources is
    relative or of the standard library, NumPy, SciPy or torch."""
    allowed = {"__future__", "dataclasses", "hashlib", "itertools", "json",
               "math", "os", "struct", "typing", "numpy", "scipy", "torch"}
    for sub in ("reference", "traffic"):
        folder = os.path.join(harness.BENCH_DIR, sub)
        for name in os.listdir(folder):
            if not name.endswith(".py"):
                continue
            with open(os.path.join(folder, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops = [a.name.split(".")[0] for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    tops = [node.module.split(".")[0]]
                else:
                    continue
                assert set(tops) <= allowed, (sub, name, tops)
