"""Nothing of the benchmark pulls in ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``recman_tpu`` (whole top-level names: ``recman_tpu_torch``
is another package), and the references import nothing of the port."""

from __future__ import annotations

import subprocess
import sys

from perfbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "recman_tpu")


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(spec.ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_no_module_pulls_in_jax_or_the_jax_package():
    mods = sorted(p.relative_to(spec.ROOT).with_suffix("").as_posix().replace("/", ".")
                  for p in spec.HERE.rglob("*.py") if "tests" not in p.parts)
    code = "\n".join(f"import {m}" for m in mods)
    code += "\nfrom perfbench import program\nprogram.model(__import__('perfbench.spec').spec"
    code += ".config('xdeepfm_bench_criteo'))\nimport recman_tpu_torch.serving, "
    code += "recman_tpu_torch.training"
    loaded = _loaded(code)
    assert "recman_tpu_torch" in loaded and not loaded & set(FORBIDDEN)


def test_references_import_nothing_of_the_port():
    code = ("import perfbench.reference.steps, perfbench.reference.xdeepfm, "
            "perfbench.reference.dlrm, perfbench.reference.common, perfbench.gen")
    loaded = _loaded(code)
    assert "recman_tpu_torch" not in loaded and not loaded & set(FORBIDDEN)
