import json
import subprocess
import sys

from decode_bench.harness.imports import forbidden_modules
from decode_bench.harness.streams import REPO_DIR


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["p265_tpu_torch", "p265_tpu_torch.pipeline",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["p265_tpu", "p265_tpu_torch"]) == ["p265_tpu"]
    assert forbidden_modules(["p265_tpu.kernels.mc"]) == ["p265_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client",
                              "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_a_cpu_run_of_the_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, json; sys.path.insert(0, %r);"
            "from decode_bench.tests.helpers import tiny_cell;"
            "from decode_bench.harness.cell import run_rank;"
            "r = run_rank(tiny_cell(), 3, 0.5, False, 'cpu');"
            "print(json.dumps([r['forbidden_modules'], sorted({m.split('.')[0]"
            " for m in sys.modules})]))" % REPO_DIR)
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True).stdout
    found, top = json.loads(out.splitlines()[-1])
    assert found == []
    assert "p265_tpu_torch" in top and not {"jax", "p265_tpu"} & set(top)
