"""Nothing the harness runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's); the reference imports nothing of the measured package."""

import subprocess
import sys

from benchmark import spec

CHECK = """
import sys
sys.path.insert(0, {root!r})
{body}
tops = {{m.split('.', 1)[0] for m in sys.modules}}
print(sorted(tops & {{'jax', 'jaxlib', 'flax', 'tcdiff_tpu', 'tcdiff_torch'}}))
"""


def _loaded(body: str) -> str:
    out = subprocess.run([sys.executable, "-c", CHECK.format(root=spec.ROOT, body=body)], capture_output=True,
                         text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_the_reference_imports_nothing_of_the_program():
    assert _loaded("import benchmark.reference.model, benchmark.reference.diffusion, benchmark.weights, "
                   "benchmark.compare, benchmark.flops") == "[]"


def test_a_run_loads_the_port_and_neither_jax_nor_the_jax_package():
    body = ("sys.path.insert(0, {tests!r})\nfrom _tiny import line, tiny_run\n"
            "assert line(tiny_run('sample.g3.b128'))['correct']\n"
            "from benchmark import spec\n[spec.readers(spec.load(c)) for c in ('sample.g3.b128', 'train.g4.b256')]"
            ).format(tests=spec.os.path.join(spec.HERE, "tests"))
    assert _loaded(body) == "['tcdiff_torch']"
