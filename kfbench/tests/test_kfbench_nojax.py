"""No run of the benchmark loads JAX or the JAX package: a fresh
interpreter imports what the command imports for every cell, with the
traced run's modules, every traffic kind and every per-layer reader, and
no loaded module's top-level name (the part before the first dot,
compared whole) is one of FORBIDDEN; and no file of kfbench/ imports one
of them."""

import json
import re
import subprocess
import sys

from .conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "kinfu_tpu", "chip_smoke")

PROBE = r"""
import sys, json
sys.path.insert(0, {root!r})
import torch
import torch.profiler
import kfbench.run
from kfbench import harness, trace, work, gen, control
from kfbench.reference import compare, kinfu
import kinfu_tpu_torch
from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.pipeline.session import KinFuSession
from kinfu_tpu_torch.pipeline.streaming import make_streaming_step_fn
bench = json.load(open({bench!r}))
for w in bench["workloads"]:
    e = harness.load_cell(w["name"])
    mix = e["mix"]
    gen.kind("scene", mix["scene"]["kind"])
    gen.kind("camera", mix["camera"]["kind"])
    for s in mix.get("sensor", []):
        gen.kind("sensor", s["kind"])
    for m in e["per_layer"]:
        harness.read_metric(m["name"], {{}})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_command_loads_no_jax():
    code = PROBE.format(root=str(ROOT), bench=str(ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "kinfu_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))


def test_no_file_imports_jax():
    pat = re.compile(r"^\s*(?:import|from)\s+(" + "|".join(FORBIDDEN) + r")(?![\w])", re.M)
    dyn = re.compile(r"import_module\(\s*['\"](" + "|".join(FORBIDDEN) + r")(?![\w])")
    hits = []
    for path in (ROOT / "kfbench").rglob("*.py"):
        text = path.read_text()
        hits += [f"{path}: {m.group(0).strip()}" for m in pat.finditer(text)]
        hits += [f"{path}: {m.group(0)}" for m in dyn.finditer(text)]
    assert not hits, hits
    assert "chips" in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]
