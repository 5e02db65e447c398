"""The port imports no JAX: every module of clip_dplm_tpu_torch, and
chip_smoke.py, imports in a fresh interpreter without pulling jax, flax,
optax, orbax, yaml, the JAX package, scikit-learn or matplotlib into
sys.modules (the card's machine has neither of the last two), and no import
statement of theirs (at the top or inside a function) names jax, flax,
optax, orbax or the JAX package (utils/pretrained.py reads a JAX-written
block-YAML config through PyYAML where it is installed, inside the function
that needs it)."""

import glob
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import clip_dplm_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in ("jax", "flax", "optax", "orbax", "yaml", "clip_dplm_tpu",
                           "sklearn", "matplotlib") if m in sys.modules)
print(len(names), names, leaked)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, rest = out.stdout.split(" ", 1)
    names, leaked = rest.rsplit("] ", 1)
    assert int(n) >= 40, out.stdout  # every module was found and imported
    for mod in ("models.token_towers", "models.tf_clip", "data.collate", "ops.short_attention",
                "ops.tiny_attention", "experiments.bench", "experiments.registry",
                "train.metrics", "models.protein_clip", "models.guided_generation",
                "experiments.generate", "models.lora", "models.t5", "models.rnabert",
                "utils.pretrained", "experiments.embed", "ops.segment", "models.gnn",
                "models.tong_encoders", "ops.sinkhorn", "models.flows", "ops.integrate",
                "models.triple_flow_model", "data.cells", "data.multimodal", "models.icnn",
                "models.esm_projections", "data.gene_embeddings", "train.checkpoint",
                "train.preemption", "utils.logging", "experiments.evaluate",
                "ops.loss_variants", "models.classifiers", "train.analysis",
                "experiments.analyze", "experiments.visualize", "experiments.sweep",
                "utils.visualization", "utils.system", "types", "data.prefetch",
                "native.bindings", "utils.precision"):
        assert f"'clip_dplm_tpu_torch.{mod}'" in names, mod
    assert leaked.strip() == "[]", out.stdout


def test_no_import_statement_names_jax():
    banned = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|clip_dplm_tpu)(\.|\s|$)",
                        re.M)
    files = glob.glob(os.path.join(REPO, "clip_dplm_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) >= 40
    for path in files:
        with open(path) as f:
            hits = banned.findall(f.read())
        assert not hits, (path, hits)
