"""Hygiene of the port package: it never imports JAX, flax, orbax or the JAX
package (vitslam_tpu), every module imports on its own (and without OpenCV,
PyYAML, matplotlib or msgpack, which the machine with the card lacks), and
the weight loader is strict."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from vitslam_tpu_torch.io.from_jax import load_jax_params, port_name  # noqa: E402
from vitslam_tpu_torch.nn.layers import Mlp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "vitslam_tpu_torch", "vitslam_tpu_torch.geometry", "vitslam_tpu_torch.geometry.solvers",
    "vitslam_tpu_torch.nn", "vitslam_tpu_torch.nn.layers", "vitslam_tpu_torch.ops",
    "vitslam_tpu_torch.ops.fused_attention", "vitslam_tpu_torch.ops.flash_attention",
    "vitslam_tpu_torch.ops.cuda_build", "vitslam_tpu_torch.models",
    "vitslam_tpu_torch.models.point_aligned", "vitslam_tpu_torch.models.pose_aligned",
    "vitslam_tpu_torch.slam", "vitslam_tpu_torch.io", "vitslam_tpu_torch.profile_slice",
    "vitslam_tpu_torch.geometry.projection", "vitslam_tpu_torch.slam.chunking",
    "vitslam_tpu_torch.slam.gt_alignment", "vitslam_tpu_torch.utils",
    "vitslam_tpu_torch.utils.synthetic", "vitslam_tpu_torch.train",
    "vitslam_tpu_torch.train.losses", "vitslam_tpu_torch.train.optim",
    "vitslam_tpu_torch.train.train_step", "vitslam_tpu_torch.train.trainer",
    "vitslam_tpu_torch.train.logging_utils", "vitslam_tpu_torch.train.config",
    "vitslam_tpu_torch.io.checkpoint",
    "vitslam_tpu_torch.ops.mlp_tail", "vitslam_tpu_torch.ops.knn", "vitslam_tpu_torch.eval",
    "vitslam_tpu_torch.eval.icp", "vitslam_tpu_torch.eval.trajectory",
    "vitslam_tpu_torch.eval.reconstruction", "vitslam_tpu_torch.eval.prepare",
    "vitslam_tpu_torch.eval.orchestrator", "vitslam_tpu_torch.viz", "vitslam_tpu_torch.viz.plots",
    "vitslam_tpu_torch.config", "vitslam_tpu_torch.config.loader", "vitslam_tpu_torch.data",
    "vitslam_tpu_torch.data.preprocess", "vitslam_tpu_torch.data.base",
    "vitslam_tpu_torch.data.dynamic", "vitslam_tpu_torch.data.vkitti", "vitslam_tpu_torch.cli",
    "vitslam_tpu_torch.compare_rates", "vitslam_tpu_torch.parallel",
    "vitslam_tpu_torch.parallel.mesh", "vitslam_tpu_torch.parallel.spawn",
    "vitslam_tpu_torch.parallel.seq", "vitslam_tpu_torch.io.flax_msgpack",
    "vitslam_tpu_torch.io.from_jax", "vitslam_tpu_torch.data.kitti_odometry",
    "vitslam_tpu_torch.data.waymo", "vitslam_tpu_torch.ops.transfer",
    "vitslam_tpu_torch.ops.attention", "vitslam_tpu_torch.ops.quant",
    "vitslam_tpu_torch.models.track_head", "vitslam_tpu_torch.utils.debug",
    "vitslam_tpu_torch.utils.profiling", "vitslam_tpu_torch.viz.viser_viz",
    "vitslam_tpu_torch.io.sharded_ckpt", "vitslam_tpu_torch.native",
    "vitslam_tpu_torch.native.bindings", "vitslam_tpu_torch.parallel.pod_worker",
    "vitslam_tpu_torch.parallel.dryrun", "chip_smoke",
]
# installed here, absent on the machine with the card: the package must
# import without them (they are imported where a file is read or a plot
# made; the reference's checkpoints are read without msgpack)
HOST_ONLY = ("cv2", "yaml", "matplotlib", "msgpack")


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_alone_without_jax_or_flax(module):
    code = (f"import sys, {module}\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'flax', 'orbax', 'vitslam_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_package_imports_without_cv2_yaml_or_matplotlib():
    block = "".join(f"sys.modules[{m!r}] = None\n" for m in HOST_ONLY)
    code = ("import sys\n" + block + "import " + ", ".join(
        m for m in MODULES if m.startswith("vitslam_tpu_torch")) + "\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_names_and_strict_loading():
    assert port_name("params.core.aggregator.patch_embed.blocks.3.block.attn.qkv.kernel") \
        == "core.aggregator.patch_embed.blocks.3.attn.qkv.weight"
    assert port_name("params.core.aggregator.layers.7.frame_block.attn.q_norm.scale") \
        == "core.aggregator.layers.7.frame_block.attn.q_norm.weight"
    m = Mlp(3, 4, 2)
    flat = {"params.fc1.kernel": torch.ones(4, 3).numpy(), "params.fc1.bias": torch.ones(4).numpy(),
            "params.fc2.kernel": torch.ones(2, 4).numpy()}
    with pytest.raises(KeyError):  # fc2.bias unfilled
        load_jax_params(m, flat)
    assert load_jax_params(m, flat, strict=False) == ["fc2.bias"]
    with pytest.raises(KeyError):  # a key with no parameter
        load_jax_params(m, dict(flat, **{"params.fc2.bias": torch.ones(2).numpy(),
                                         "params.extra": torch.ones(1).numpy()}))
    with pytest.raises(ValueError):  # wrong shape
        load_jax_params(m, dict(flat, **{"params.fc2.bias": torch.ones(3).numpy()}))
