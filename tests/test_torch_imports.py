"""The port imports torch and numpy only: importing every module of
``vlsfr_tpu_torch`` in a fresh interpreter loads no JAX-family module and
nothing of ``vlsfr_tpu``, builds nothing, creates no process group and
needs no card."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, json, pkgutil, sys
import torch.distributed as dist
import vlsfr_tpu_torch
names = ["vlsfr_tpu_torch"]
for m in pkgutil.walk_packages(vlsfr_tpu_torch.__path__, "vlsfr_tpu_torch."):
    names.append(m.name)
for n in names:
    importlib.import_module(n)
banned = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "vlsfr_tpu"))
print(json.dumps({"modules": names, "banned": banned, "group": dist.is_initialized()}))
"""


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["banned"] == []
    assert res["group"] is False  # importing creates no process group
    for want in ("vlsfr_tpu_torch.ops.twin_margin", "vlsfr_tpu_torch.core.ffc",
                 "vlsfr_tpu_torch.train.trainer", "vlsfr_tpu_torch.train.cli",
                 "vlsfr_tpu_torch.models.from_jax", "vlsfr_tpu_torch.data.pipeline",
                 "vlsfr_tpu_torch.ops.margin_stream", "vlsfr_tpu_torch.parallel.partial_fc",
                 "vlsfr_tpu_torch.train.softmax_head", "vlsfr_tpu_torch.train.sparse_classifier",
                 "vlsfr_tpu_torch.parallel.distributed", "vlsfr_tpu_torch.parallel.mesh",
                 "vlsfr_tpu_torch.parallel._shard_common",
                 "vlsfr_tpu_torch.parallel.sharded_quad", "vlsfr_tpu_torch.parallel.sharded_twin",
                 "vlsfr_tpu_torch.parallel.sharded_margin",
                 "vlsfr_tpu_torch.parallel.sharded_fused",
                 "vlsfr_tpu_torch.parallel.sharded_sparse", "vlsfr_tpu_torch.ops.conv3x3",
                 "vlsfr_tpu_torch.tools.bench_conv", "vlsfr_tpu_torch.tools.probe_int8_mxu"):
        assert want in res["modules"]


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's module scope and helpers pull in nothing of JAX."""
    code = ("import importlib.util, json, sys; "
            "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py'); "
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
            "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'vlsfr_tpu'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
