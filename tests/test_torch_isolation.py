"""The port and chip_smoke.py import neither JAX nor the JAX package.

Every module of geoformer_tpu_torch (its ``cli``, ``data``, ``evaluation``,
``losses``, ``parallel``, ``tools`` and ``utils`` subpackages included) and chip_smoke (whose work runs
only under ``if __name__ == "__main__":``) is imported in a fresh
interpreter, which then lists what it loaded. The port's entry points run on
the card: without one, and without a device named, they raise.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

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
                                    "__graft_entry__", "test", "test_fs"))
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
                "geoformer_tpu_torch.kernels.knn_select",
                "geoformer_tpu_torch.kernels.row_gather",
                "geoformer_tpu_torch.models.geoformer_fs", "geoformer_tpu_torch.synthetic",
                "geoformer_tpu_torch.cli.test", "geoformer_tpu_torch.cli.test_fs",
                "geoformer_tpu_torch.data.augment", "geoformer_tpu_torch.data.collate",
                "geoformer_tpu_torch.data.scannet", "geoformer_tpu_torch.data.episodic",
                "geoformer_tpu_torch.evaluation.gt", "geoformer_tpu_torch.evaluation.predictions",
                "geoformer_tpu_torch.evaluation.scannet_eval",
                "geoformer_tpu_torch.tools.gather_probe", "geoformer_tpu_torch.utils.logger",
                "geoformer_tpu_torch.cli.train", "geoformer_tpu_torch.cli.train_fs",
                "geoformer_tpu_torch.losses.matcher", "geoformer_tpu_torch.losses.criterion",
                "geoformer_tpu_torch.losses.criterion_fs",
                "geoformer_tpu_torch.parallel.dist", "geoformer_tpu_torch.parallel.train_state",
                "geoformer_tpu_torch.utils.checkpoint", "geoformer_tpu_torch.utils.meters",
                "geoformer_tpu_torch.utils.prefetch", "geoformer_tpu_torch.utils.scheduler",
                "geoformer_tpu_torch.utils.tracking", "geoformer_tpu_torch.ops.knn",
                "geoformer_tpu_torch.ops.interpolate", "geoformer_tpu_torch.ops.segment_ops",
                "geoformer_tpu_torch.ops.cluster", "geoformer_tpu_torch.native",
                "geoformer_tpu_torch.utils.visualize",
                "geoformer_tpu_torch.tools.convert_reference_checkpoint",
                "geoformer_tpu_torch.cli.bench", "geoformer_tpu_torch.tools.train_bench"}
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


@pytest.mark.parametrize("module", ["cli.test", "cli.test_fs", "cli.train", "cli.train_fs",
                                    "tools.gather_probe"])
def test_entry_points_raise_without_a_card(module):
    """No --device and no CUDA: the drivers and the probe raise before they
    touch a file; they never move to the CPU on their own."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry points run on it")
    main = importlib.import_module(f"geoformer_tpu_torch.{module}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", "missing.yaml", "--pretrain", "missing.ckpt"]
             if module.startswith("cli") else [])
