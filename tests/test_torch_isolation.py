"""The port and chip_smoke.py import neither JAX nor the JAX package.

Every module of geoformer_tpu_torch and chip_smoke (whose work runs only
under ``if __name__ == "__main__":``) is imported in a fresh interpreter,
which then lists what it loaded.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import geoformer_tpu_torch
names = ["geoformer_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(geoformer_tpu_torch.__path__, "geoformer_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "geoformer_tpu", "tools",
                                    "__graft_entry__"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    expected = {"geoformer_tpu_torch.config", "geoformer_tpu_torch.engine",
                "geoformer_tpu_torch.weights", "geoformer_tpu_torch.ops.voxelize",
                "geoformer_tpu_torch.ops.sparse_conv", "geoformer_tpu_torch.ops.fps",
                "geoformer_tpu_torch.ops.ball_query", "geoformer_tpu_torch.ops.radius_graph",
                "geoformer_tpu_torch.ops.geodesic", "geoformer_tpu_torch.ops.nms",
                "geoformer_tpu_torch.models.blocks", "geoformer_tpu_torch.models.unet",
                "geoformer_tpu_torch.models.aggregator",
                "geoformer_tpu_torch.models.pos_embedding",
                "geoformer_tpu_torch.models.decoder", "geoformer_tpu_torch.models.dynamic_conv",
                "geoformer_tpu_torch.models.geoformer", "geoformer_tpu_torch.kernels.fps",
                "geoformer_tpu_torch.kernels.knn_select"}
    assert expected <= set(res["modules"])


def test_chip_smoke_refuses_without_cuda_or_package(tmp_path):
    """chip_smoke.py exits non-zero and prints no ``ok`` line when there is
    no card, or when it stands alone in a directory."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    for cwd, script in ((REPO, "chip_smoke.py"), (str(tmp_path), "chip_smoke.py")):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        if cwd == REPO:
            env["CUDA_VISIBLE_DEVICES"] = ""  # hide any card: the script must refuse
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
