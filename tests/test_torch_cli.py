"""Port parity for the entry point of the test mode (config/loader.py,
data/*, cli.py, Trainer.validate / test): every shipped config composes and
instantiates as in vitslam_tpu, with the port's classes; the VKITTI reader
reads the byte-level fixture as the reference does; and the CLI's test mode
(and the trainer's validate / test) on the fixture gives the reference's
metric keys and values, both packages holding the same weights, the port's
model on the CPU."""
import functools
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

import jax.numpy as jnp  # noqa: E402

from vitslam_tpu import cli as jcli  # noqa: E402
from vitslam_tpu.config import loader as jloader  # noqa: E402
from vitslam_tpu.data.base import CommonConfig as JCommon  # noqa: E402
from vitslam_tpu.data.dynamic import DynamicDataset as JDynamic  # noqa: E402
from vitslam_tpu.data.vkitti import VKittiDataset as JVKitti  # noqa: E402
from vitslam_tpu.slam import ChunkedPipeline as JPipeline  # noqa: E402
from vitslam_tpu.train import trainer as jtrainer  # noqa: E402
from vitslam_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from vitslam_tpu.utils.fixtures import write_vkitti_fixture  # noqa: E402
from vitslam_tpu_torch import cli  # noqa: E402
from vitslam_tpu_torch.config import loader  # noqa: E402
from vitslam_tpu_torch.data import CommonConfig, DynamicDataset, VKittiDataset  # noqa: E402
from vitslam_tpu_torch.nn import layers as tl  # noqa: E402
from vitslam_tpu_torch.train.trainer import Trainer  # noqa: E402

from torch_weights import jax_variables, shared_jax_cache  # noqa: E402,F401

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.splitext(os.path.basename(p))[0]
                 for p in glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
# fp32 through the whole model, GT alignment, ICP and the metrics on both
# sides: relative agreement per metric value
RTOL = 1e-4


def _port_class(obj) -> str:
    return f"{type(obj).__module__}.{type(obj).__qualname__}"


@pytest.mark.parametrize("name", CONFIGS)
def test_compose_and_instantiate_match_jax(name):
    """compose (defaults, interpolation, overrides before interpolation)
    gives the reference's dict; the loss, the metrics and the model
    instantiate as the port's classes of the same module paths."""
    overrides = ["seed_value=7", "img_size=140"]
    cfg = loader.compose(name, os.path.join(ROOT, "configs"), overrides=overrides)
    assert cfg == jloader.compose(name, os.path.join(ROOT, "configs"), overrides=overrides)
    if "model" not in cfg:
        return
    for key in ("loss", "metrics"):
        if key in cfg:
            got, want = loader.instantiate(cfg[key]), jloader.instantiate(cfg[key])
            assert _port_class(got) == _port_class(want).replace("vitslam_tpu.",
                                                                 "vitslam_tpu_torch.", 1)
    m = cfg["metrics"]
    got = loader.instantiate(m)
    assert (got.chunk_width, got.num_overlap) == (m["chunk_width"][0], m["overlap"][0])
    assert [type(x).__name__ for x in got.trajectory_metrics] == \
        [n["_target_"].rsplit(".", 1)[1] for n in m.get("trajectory_metrics") or []]
    # the full-width model, built without memory on the meta device
    model = loader.instantiate(cfg["model"], device=torch.device("meta"))
    assert _port_class(model) == cfg["model"]["_target_"].replace("vitslam_tpu.",
                                                                  "vitslam_tpu_torch.", 1)
    assert sum(p.numel() for p in model.parameters()) > 10 ** 9


def test_loader_dtypes_targets_and_overrides():
    node = {"_target_": "vitslam_tpu.nn.layers.LayerNorm", "dim": 4, "dtype": "bfloat16"}
    assert loader.instantiate(node).dtype == torch.bfloat16
    head = loader.instantiate({"_target_": "vitslam_tpu.models.track_head.TrackHead",
                               "device": torch.device("meta")})
    assert _port_class(head) == "vitslam_tpu_torch.models.track_head.TrackHead"
    with pytest.raises(NotImplementedError, match="not ported"):
        loader.instantiate({"_target_": "vitslam_tpu.io.orbax_ckpt.OrbaxCheckpointer"})
    with pytest.raises(ValueError, match="malformed override"):
        loader.compose("test_featureAlignedVGGT_vkitti", os.path.join(ROOT, "configs"),
                       overrides=["no_equals_sign"])
    cfg = {"a": [{"b": 1}]}
    loader.set_dotted(cfg, "a.0.b", "[1, 2]")
    assert cfg == {"a": [{"b": [1, 2]}]}


N_FRAMES = 5  # chunks of 3 at overlap 1: two full chunks


@pytest.fixture(scope="module")
def vkitti(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vkitti"))
    write_vkitti_fixture(root, n_frames=N_FRAMES, hw=(28, 42))
    return root


def test_vkitti_reader_and_loader_match_jax(vkitti):
    """The fixture's frames, depths, cameras and derived points, read by
    both readers: a whole sequence, a sampled training window, and the
    dynamic batcher's first batches."""
    kw = dict(img_size=28, patch_size=14, fix_aspect_ratio=0.7, training=True,
              inside_random=False, chunk_subsampling=(1, 2))
    ds = VKittiDataset(CommonConfig(**kw), split="train", VKitti_DIR=vkitti,
                       sequence_ids=["01"], settings=["clone"])
    jds = JVKitti(JCommon(**kw), split="train", VKitti_DIR=vkitti, sequence_ids=["01"],
                  settings=["clone"])
    assert ds.sequence_list == jds.sequence_list and ds.seq_frame_num == jds.seq_frame_num
    assert ds.get_seq_name(0) == jds.get_seq_name(0)

    def same(a, b):
        assert a.keys() == b.keys()
        for k in b:
            if isinstance(b[k], np.ndarray):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5, err_msg=k)
            else:
                assert a[k] == b[k], k

    same(ds.get_data(0, -1, None, np.arange(N_FRAMES)),
         jds.get_data(0, -1, None, np.arange(N_FRAMES)))
    same(ds.get_data(0, 3, rng=np.random.default_rng(2)),
         jds.get_data(0, 3, rng=np.random.default_rng(2)))
    dyn = DynamicDataset([ds], img_nums=[2, 4], max_img_per_gpu=8, steps_per_epoch=2)
    jdyn = JDynamic([jds], img_nums=[2, 4], max_img_per_gpu=8, steps_per_epoch=2)
    for a, b in zip(dyn.get_loader(epoch=3), jdyn.get_loader(epoch=3)):
        same(a, b)


def _tiny_cfg(root, log_dir, img_size=28, aspect=0.7, embed=32):
    """The tiny config of tests/test_config_io.py::TestRunModelIntegration
    in test mode, its validation batch the whole 5-frame sequence."""
    common = {"_target_": "vitslam_tpu.data.base.CommonConfig", "img_size": img_size,
              "patch_size": 14, "fix_aspect_ratio": aspect, "training": False,
              "inside_random": True, "chunk_subsampling": [1, 1]}
    data = {"_target_": "vitslam_tpu.data.dynamic.DynamicDataset",
            "max_img_per_gpu": N_FRAMES, "img_nums": [N_FRAMES, N_FRAMES],
            "dataset_configs_or_datasets": [{
                "_target_": "vitslam_tpu.data.vkitti.VKittiDataset", "split": "test",
                "VKitti_DIR": root, "sequence_ids": ["01"], "settings": ["clone"],
                "common_conf": common}]}
    return {
        "exp_name": "tiny_it", "img_size": img_size, "patch_size": 14, "seed_value": 0,
        "max_steps": 2, "val_epoch_freq": 1000, "num_overlap": [1, 1],
        "chunk_width": [3, 3], "sample_mode": "chunk_overlap",
        "gt_alignment_type": "sim3_from_points", "mode": "test",
        "logging": {"log_dir": log_dir, "log_freq": 1},
        "checkpoint": {"save_dir": log_dir + "/ckpt", "save_freq": 2,
                       "resume_from_checkpoint": False},
        "optim": {"frozen_module_names": ["*aggregator*", "*camera_head*", "*depth_head*"]},
        "loss": {"_target_": "vitslam_tpu.train.losses.MultitaskLoss",
                 "cameraPose": {"weight": 1.0, "loss_type": "l1"},
                 "perChunkReg": {"weight": 5.0}},
        "metrics": {
            "_target_": "vitslam_tpu.eval.orchestrator.Metrics", "mode": "test",
            "overlap": [1, 1], "chunk_width": [3, 3],
            # sim3_from_points (here and for the validation batch above):
            # with random weights and a pose- or depth-scale alignment the
            # predicted cloud can sit far from the GT cloud, every point
            # then matches the same GT point, and the first Kabsch step
            # solves a zero covariance (singular values ~1e-12) whose
            # rotation is rounding noise in either package; a cloud
            # registered onto the GT points keeps ICP well posed
            "full_seq_sample_mode": "chunk_overlap", "gt_alignment_type": "sim3_from_points",
            "use_random_sequences": True, "max_points_for_icp_full_seq": 2000,
            "trajectory_metrics": [
                {"_target_": "vitslam_tpu.eval.trajectory.AbsoluteTrajectoryError"},
                {"_target_": "vitslam_tpu.eval.trajectory.RelativePoseError"}],
            "reconstruction_metrics": [
                {"_target_": "vitslam_tpu.eval.reconstruction.ChamferDistanceMetrics"}]},
        "model": {"_target_": "vitslam_tpu.models.feature_aligned.FeatureAlignedVGGT",
                  "img_size": img_size, "patch_size": 14, "embed_dim": embed, "depth": 2,
                  "num_heads": 4, "patch_embed_depth": 1,
                  "intermediate_layers": [0, 1, 1, 1], "num_memory_tokens": 4,
                  "align_embed_dim": 32, "align_dec_dim": 16, "dtype": "float32"},
        "data": {"test": data},
    }


def _two_stage_reference(mp, metrics) -> None:
    """Run the reference trainer's inference on its two-stage driver
    (``encode_batch=2``), which compiles the backbone once where the
    sequential driver compiles it twice (the first chunk without state,
    then with); the same outputs (tests/test_torch_large_chunk.py holds the
    port to it the same way). Its ``metrics`` draw no plots: an empty log
    dir, which the trainer leaves as it is, gives no image path; the values
    are the same and only the port's plots are checked."""
    mp.setattr(jtrainer, "ChunkedPipeline", functools.partial(JPipeline, encode_batch=2))
    mp.setattr(metrics, "log_dir", "")


def _write_cfg(cfg_dir, cfg) -> str:
    cfg_dir = str(cfg_dir)
    os.makedirs(cfg_dir, exist_ok=True)
    with open(os.path.join(cfg_dir, "tiny.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg_dir


@pytest.fixture(scope="module")
def reference(vkitti, tmp_path_factory):
    """The reference's Trainer.validate(0) on the tiny config, holding the
    port model's (seeded) weights: its losses, its batch metrics and its
    full-sequence metrics, the ``seq_metrics/`` keys, which are what the
    reference's test mode (Trainer.test: compute_full_sequence_metrics on
    the same weights and the only sequence) returns."""
    tmp = tmp_path_factory.mktemp("reference")
    cfg_dir = _write_cfg(tmp / "cfg", _tiny_cfg(vkitti, str(tmp / "logs")))
    port_model = cli.build_from_config(loader.compose("tiny", cfg_dir), device="cpu")[0]
    cfg = jloader.compose("tiny", cfg_dir)
    cfg["model"]["dtype"] = jnp.float32
    model, loss, metrics, _, val_data, _ = jcli.build_from_config(cfg)
    first = val_data.datasets[0].get_data(0, -1, None, np.arange(3))
    images = jnp.asarray(first["images"][None])
    params = jax_variables(lambda rng: model.init(rng, images, 1), port_model)
    trainer = JTrainer(cfg, model, loss, val_data=val_data, metrics=metrics, params=params)
    trainer.init_state(None)
    with pytest.MonkeyPatch.context() as mp:
        _two_stage_reference(mp, metrics)
        return cfg_dir, trainer.validate(0), params


def _same_metrics(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=1e-6, err_msg=k)


def _seq(metrics: dict) -> dict:
    return {k: v for k, v in metrics.items() if k.startswith("seq_metrics/")}


def test_cli_test_mode_matches_jax(reference, tmp_path, capsys):
    """``python -m vitslam_tpu_torch.cli --config tiny --device cpu`` in
    test mode: ATE, RPE, Chamfer after ICP and the alignment diagnostics of
    the sampled sequence, against the reference on the same weights."""
    cfg_dir, want, _ = reference
    got = cli.main(["--config", "tiny", "--config-dir", cfg_dir, "--device", "cpu",
                    "--set", f"logging.log_dir={tmp_path}"])
    assert "seq_metrics/ate_rmse" in got and "seq_metrics/chamfer_distance_rmse" in got
    assert str(got) in capsys.readouterr().out
    assert os.path.exists(tmp_path / "tiny_it/version_0/seq_traj_ate.png")
    _same_metrics(got, _seq(want))


def test_trainer_validate_and_test_match_jax(reference, tmp_path):
    """Trainer.validate (the batch through the pipeline at a width drawn
    from the metrics' range, its losses, the batch metrics and the
    full-sequence metrics) and Trainer.test against the reference's
    trainer, same weights."""
    cfg_dir, want, _ = reference
    cfg = loader.compose("tiny", cfg_dir, overrides=[f"logging.log_dir={tmp_path}"])
    model, loss, metrics, _, val_data = cli.build_from_config(cfg, device="cpu")
    trainer = Trainer(cfg, model, loss, val_data=val_data, metrics=metrics)
    got = trainer.validate(0)
    assert "ate_rmse" in got and "objective" in got and "seq_metrics/ate_rmse" in got
    _same_metrics(got, want)
    _same_metrics(trainer.test(), _seq(want))
    with open(os.path.join(trainer.logger.log_dir, "metrics.csv")) as f:
        header = f.readline()
    assert "val/ate_rmse" in header and "seq_metrics/ate_rmse" in header
    assert Trainer(cfg, model, loss).validate(0) == {}


def test_cli_test_mode_from_a_reference_checkpoint(reference, tmp_path, monkeypatch):
    """The test mode with ``model_checkpoint_path`` a head checkpoint the
    reference wrote (vitslam_tpu's save_checkpoint, flax msgpack) over a
    ``from_pretrained`` whole-model checkpoint of the reference under its
    ``model`` key, whose own head is wrong: the port model, seeded from
    another seed before the load, gives the reference's metrics on the
    reference's weights (RTOL)."""
    import jax

    from vitslam_tpu.io.checkpoint import save_checkpoint as jax_save

    cfg_dir, want, params = reference
    head = params["params"]["alignment_head"]
    jax_save(str(tmp_path / "head.ckpt"), {"params": {"alignment_head": head}})
    wrong = jax.tree.map(lambda x: 2.0 * np.asarray(x) + 0.5, head)
    jax_save(str(tmp_path / "base.ckpt"),
             {"model": {"params": dict(params["params"], alignment_head=wrong)}})
    real = tl.init_weights
    monkeypatch.setattr(tl, "init_weights",
                        lambda model, g: real(model, torch.Generator().manual_seed(1234)))
    got = cli.main(["--config", "tiny", "--config-dir", cfg_dir, "--device", "cpu",
                    "--set", f"logging.log_dir={tmp_path}",
                    "--set", f"checkpoint.model_checkpoint_path={tmp_path / 'head.ckpt'}",
                    "--set", f"checkpoint.from_pretrained={tmp_path / 'base.ckpt'}"])
    _same_metrics(got, _seq(want))


# the kittiOd / Waymo fixtures: 9 frames, 2 chunks of 5 at overlap 1
READER_FRAMES = 9


@pytest.mark.parametrize("name", ["test_featureAlignedVGGT_kittiOd",
                                  "test_featureAlignedVGGT_waymo"])
def test_cli_test_mode_of_the_kittiod_and_waymo_configs_matches_jax(name, tmp_path,
                                                                     monkeypatch):
    """The shipped kittiOd and Waymo test configs, at the tiny width of
    test_cli_test_mode_matches_jax and pointed at the JAX package's
    fixtures of those datasets: compose + instantiate (the port's readers)
    and ``python -m vitslam_tpu_torch.cli --device cpu`` in test mode give
    the metrics of the reference's Trainer.test on the same weights
    (RTOL), the reference reading on its numpy paths as the port does."""
    import vitslam_tpu.native as jnative
    from vitslam_tpu.utils.fixtures import write_kitti_odometry_fixture, write_waymo_fixture

    monkeypatch.setattr(jnative, "lidar_splat_depth_native", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "depth_to_points_native", lambda *a, **k: None)
    root = str(tmp_path / "data")
    if name.endswith("kittiOd"):
        write_kitti_odometry_fixture(root, seq="00", n_frames=READER_FRAMES, hw=(56, 84))
        data = [f"kittiod_dir={root}"]
    else:
        write_waymo_fixture(root, split="validation", n_frames=READER_FRAMES, hw=(56, 84),
                            n_lidar=2000)
        # the config's Chamfer after ICP at _tiny_cfg's settings: registered
        # by sim3_from_points (with the point head), since under the
        # config's scale_from_poses the random-weight cloud shrinks to ~1%
        # of the GT's, every point matches the same GT point and ICP's
        # first Kabsch step solves a zero covariance whose rotation is
        # rounding noise in either package (Chamfer 5.7% apart); and ICP
        # capped at 2,000 points, without which accuracy_rmse is 4.5e-4
        # apart (fp32 differences of ~1e-6 flip a nearest neighbour or
        # the confidence quantile's cut over the sparse LiDAR points)
        data = [f"waymo_dir={root}", "gt_alignment_type=sim3_from_points",
                "model.enable_point=true", "metrics.max_points_for_icp_full_seq=2000"]
    overrides = data + [
        "img_size=56", "model.embed_dim=32", "model.depth=2", "model.num_heads=4",
        "model.patch_embed_depth=1", "model.intermediate_layers=[0,1,1,1]",
        "model.align_embed_dim=32", "model.align_dec_dim=16", "model.num_memory_tokens=4",
        "data.test.dataset_configs_or_datasets.0.common_conf.fix_aspect_ratio=0.5",
        f"logging.log_dir={tmp_path / 'logs'}"]
    configs = os.path.join(ROOT, "configs")
    cfg = loader.compose(name, configs, overrides=overrides + ["model.dtype=float32"])
    port_model, _, _, _, val_data = cli.build_from_config(cfg, device="cpu")
    reader = val_data.datasets[0]
    assert type(reader).__module__.startswith("vitslam_tpu_torch.data.")
    assert reader.seq_frame_num == [READER_FRAMES]

    jcfg = jloader.compose(name, configs, overrides=overrides)
    jcfg["model"]["dtype"] = jnp.float32
    model, loss, metrics, _, jval, _ = jcli.build_from_config(jcfg)
    images = jnp.zeros((1, 5, 3, 28, 56), jnp.float32)
    params = jax_variables(lambda rng: model.init(rng, images, 1), port_model)
    _two_stage_reference(monkeypatch, metrics)
    want = JTrainer(jcfg, model, loss, val_data=jval, metrics=metrics, params=params).test()

    got = cli.main(["--config", name, "--config-dir", configs, "--device", "cpu"]
                   + [a for o in overrides + ["model.dtype=float32"] for a in ("--set", o)])
    assert len(got) > 3 and all(k.split("/")[0].endswith("_00") or "seq0000" in k
                                for k in got)
    _same_metrics(got, want)


def test_cli_fused_tails_from_the_env(tmp_path, monkeypatch):
    """The CLI reads VITSLAM_MLP_TAIL=1 once and builds the backbone with
    both tail sites; at 182 x 364 frames (343 tokens, chunks of 3) every
    backbone block has >= 1,024 rows and both tails engage. The trajectory
    metrics and diagnostics agree with the same run with the tails off
    within rel 1e-4 (fp32: the fused LayerNorm's centered variance and the
    folded LayerScale round differently; test_torch_tail_model.py holds the
    tails to the reference's). The Chamfer values are only held finite:
    30 ICP iterations over the random-weight clouds turn those 1e-6
    differences into a nearest-neighbour flip and percent-level changes."""
    root = str(tmp_path / "vkitti")
    write_vkitti_fixture(root, n_frames=N_FRAMES, hw=(182, 364))
    cfg_dir = _write_cfg(tmp_path / "cfg", _tiny_cfg(root, str(tmp_path / "logs"),
                                                     img_size=364, aspect=0.5, embed=64))
    argv = ["--config", "tiny", "--config-dir", cfg_dir, "--device", "cpu"]
    off = cli.main(argv)
    monkeypatch.setenv("VITSLAM_MLP_TAIL", "1")
    assert cli.mlp_tail_from_env() == "both"
    sites = []
    real = tl.mlp_tail
    monkeypatch.setattr(tl, "mlp_tail", lambda *a, **k: sites.append(k["ln"]) or real(*a, **k))
    got = cli.main(argv)
    # 2 chunks x (1 patch-embed + 2 x 2 aggregator blocks) x 2 sites
    assert sorted(sites) == sorted([False, True] * 2 * 5)
    assert got.keys() == off.keys()
    chamfer = [k for k in off if "chamfer" in k or "accuracy" in k or "completion" in k]
    assert len(chamfer) == 3 and all(np.isfinite(got[k]) for k in chamfer)
    _same_metrics({k: v for k, v in got.items() if k not in chamfer},
                  {k: v for k, v in off.items() if k not in chamfer})


def test_cli_refuses_what_is_not_ported(vkitti, tmp_path):
    cfg_dir = _write_cfg(tmp_path / "cfg", _tiny_cfg(vkitti, str(tmp_path / "logs")))
    # model shards need a gang whose size they divide (one process: 1 rank)
    with pytest.raises(ValueError, match="does not divide the 1 rank"):
        cli.main(["--config", "tiny", "--config-dir", cfg_dir, "--device", "cpu",
                  "--set", "num_model_shards=2"])
    # several nodes are ported; they need the rendezvous address and the
    # node's index
    with pytest.raises(ValueError, match="--coordinator"):
        cli.main(["--config", "tiny", "--config-dir", cfg_dir, "--device", "cpu",
                  "--num_nodes", "2"])
    assert cli.mlp_tail_from_env({}) == "off"
    assert cli.mlp_tail_from_env({"VITSLAM_MLP_TAIL": "proj"}) == "proj"
