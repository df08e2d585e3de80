"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port (top-level module names compared
whole: the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys

from benchmark import core

FORBIDDEN = {"jax", "jaxlib", "flax", "sdrmodem_tpu"}


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(folder):
    return [p for p in folder.rglob("*.py") if "__pycache__" not in p.parts]


def test_no_module_imports_jax_or_the_jax_package():
    for p in sources(core.BENCH):
        assert not imported(p) & FORBIDDEN, p


def test_the_reference_imports_nothing_of_the_port():
    for p in sources(core.BENCH / "reference") + [core.BENCH / "check.py", core.BENCH / "gen.py",
                                                   core.BENCH / "costs.py"]:
        assert "sdrmodem_tpu_torch" not in imported(p), p


def test_whole_names_are_compared():
    assert core.forbidden_modules() == [] or set(core.forbidden_modules()) <= FORBIDDEN
    sys.modules.setdefault("sdrmodem_tpu_torch_lookalike", sys)
    try:
        assert "sdrmodem_tpu" not in core.forbidden_modules()
    finally:
        sys.modules.pop("sdrmodem_tpu_torch_lookalike", None)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.run, benchmark.check, benchmark.gen, benchmark.tracing;"
            "import sdrmodem_tpu_torch.server.session, sdrmodem_tpu_torch.dsp.pipeline;"
            "from benchmark import core;"
            "[core.driver(k) for k in ('step', 'group')];"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % FORBIDDEN)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=core.ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
