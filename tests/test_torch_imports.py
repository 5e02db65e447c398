"""The port imports no JAX: every module of clip_dplm_tpu_torch imports in a
fresh interpreter without pulling jax, flax, optax or yaml into sys.modules."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import clip_dplm_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in ("jax", "flax", "optax", "yaml", "clip_dplm_tpu")
                if m in sys.modules)
print(len(names), names, leaked)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, rest = out.stdout.split(" ", 1)
    names, leaked = rest.rsplit("] ", 1)
    assert int(n) >= 28, out.stdout  # every module was found and imported
    for mod in ("models.token_towers", "models.tf_clip", "data.collate", "ops.short_attention",
                "ops.tiny_attention", "experiments.bench", "experiments.registry",
                "train.metrics", "models.protein_clip", "models.guided_generation",
                "experiments.generate", "models.lora", "models.t5", "models.rnabert",
                "utils.pretrained", "experiments.embed"):
        assert f"'clip_dplm_tpu_torch.{mod}'" in names, mod
    assert leaked.strip() == "[]", out.stdout
