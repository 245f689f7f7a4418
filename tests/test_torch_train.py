"""Port parity for the training slice (vitslam_tpu_torch/train, io/checkpoint),
mirroring tests/test_train.py: the warmup weights, the loss formulas, freezing
by pattern, the learning-rate schedule, the chunk-shape sampling, two train
steps of the tiny model in both AlignmentHead modes against the JAX
make_train_step from the same weights, gradient accumulation against
optax.MultiSteps, checkpoint resume and a short Trainer.fit, all on the CPU
in fp32.

Random draws: both sides get the same numbers. The relative-pose loss's
large offset is fixed in its config (``large_offset``); the frame dropout's
uniforms come from a seeded torch.Generator in the port, and the JAX
reference's jax.random.uniform is patched to return those same numbers."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from torch_weights import jax_variables, seeded, shared_jax_cache  # noqa: E402,F401
from vitslam_tpu import train as jtrain  # noqa: E402
from vitslam_tpu.io.torch_convert import export_torch_style  # noqa: E402
from vitslam_tpu.models import FeatureAlignedVGGT as JaxModel  # noqa: E402
from vitslam_tpu.slam import chunk_batch, generate_chunks, merge_chunk_outputs  # noqa: E402
from vitslam_tpu.train.trainer import sample_chunk_shapes as jsample  # noqa: E402
from vitslam_tpu_torch import train as ttrain  # noqa: E402
from vitslam_tpu_torch.io import checkpoint as tckpt  # noqa: E402
from vitslam_tpu_torch.io.from_jax import port_name  # noqa: E402
from vitslam_tpu_torch.models import FeatureAlignedVGGT  # noqa: E402
from vitslam_tpu_torch.utils import make_synthetic_batch  # noqa: E402

torch.set_num_threads(2)
H, W = 28, 42
FREEZE = ["*aggregator*", "*camera_head*", "*depth_head*"]
LARGE_OFFSET = 5
LOSS_CFG = dict(
    cameraPose={"weight": 1.0, "loss_type": "l1"},
    cameraPoseRel={"weight": 0.5, "loss_type": "l1", "large_offset": LARGE_OFFSET},
    depth={"weight": 0.1, "valid_range": 0.98},
    perFrameReg={"weight": 5.0, "warmup_percent": 0.1, "warmup_type": "linear"},
    perChunkReg={"weight": 5.0},
    total_steps=100,
)
# tiny_model_kwargs with an AlignmentHead of width 64: its 8 heads are then
# 8 wide. At test_train.py's widths (32 and 16) the decoder's heads are 2
# wide, where the per-head LayerNorm's E[x^2] - E[x]^2 cancels to a few
# digits and the gradients through it agree only to ~25% between any two
# fp32 implementations (measured here); at 8 wide they agree to ~1e-5.
TINY = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=4,
            patch_embed_depth=1, intermediate_layers=(0, 1, 1, 1), num_memory_tokens=4,
            align_embed_dim=64, align_dec_dim=64)
# the dropout seed: its (2, 2) uniforms keep some non-overlap frames and drop others
DROP_SEED = 0
# fp32 through the tiny model on both sides in another summation order:
# relative error per loss and relative L2 error per gradient leaf
RTOL = 1e-4


def _rel(got, want) -> float:
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)) if b.any() \
        else float(np.abs(a).max(initial=0.0))


class TestWarmup:
    @pytest.mark.parametrize("cfg", [
        {"weight": 2.0},
        {"weight": 1.0, "warmup_percent": 0.5, "warmup_type": "linear"},
        {"weight": 1.0, "warmup_percent": 0.2, "warmup_start_percent": 0.5,
         "warmup_type": "linear"},
        {"weight": 0.5, "warmup_percent": 0.3, "warmup_start_weight": 0.1},  # exp
    ])
    def test_warmup_matches_jax(self, cfg):
        for step in (0, 10, 25, 49, 50, 55, 60, 70, 80, 100):
            got = ttrain.compute_warmup_weight(cfg, step, 100)
            want = float(jtrain.compute_warmup_weight(cfg, step, 100))
            assert abs(got - want) <= 1e-6, (step, got, want)

    def test_linear_warmup(self):
        cfg = {"weight": 1.0, "warmup_percent": 0.5, "warmup_type": "linear"}
        assert ttrain.compute_warmup_weight(cfg, 0, 100) == 0.0
        assert ttrain.compute_warmup_weight(cfg, 25, 100) == pytest.approx(0.5)
        assert ttrain.compute_warmup_weight(cfg, 80, 100) == 1.0


def _perfect(batch):
    from vitslam_tpu_torch.geometry import extri_intri_to_pose_encoding

    pe = extri_intri_to_pose_encoding(torch.tensor(batch["extrinsics"]),
                                      torch.tensor(batch["intrinsics"]), (H, W))
    S = pe.shape[1]
    return {"pose_enc": pe, "depth": torch.tensor(batch["depths"])[..., None],
            "depth_conf": torch.ones((1, S, H, W)),
            "frame_se3_enc": torch.tensor([[[0, 0, 0, 0, 0, 0, 1.0]] * (S - 1)]),
            "chunk_sim3_enc": torch.tensor([[[0, 0, 0, 0, 0, 0, 1.0, 1.0]]])}


class TestLossFormulas:
    @pytest.mark.parametrize("variant", ["perfect", "offsets", "depth_x2", "noisy"])
    @pytest.mark.parametrize("step", [3, 100])
    def test_losses_match_jax(self, variant, step):
        batch = make_synthetic_batch(B=1, N=8, H=H, W=W)
        preds = _perfect(batch)
        rng = np.random.default_rng(1)
        if variant == "offsets":
            preds["frame_se3_enc"] = torch.tensor([[[1.0, 0, 0, 0, 0, 0, 1]] * 7])
            preds["chunk_sim3_enc"] = torch.tensor([[[0, 0, 0, 0, 0, 0, 1.0, 2.0]]])
        elif variant == "depth_x2":
            preds["depth"] = preds["depth"] * 2.0
        elif variant == "noisy":
            for k in ("pose_enc", "depth", "frame_se3_enc", "chunk_sim3_enc"):
                noise = rng.normal(0, 0.1, preds[k].shape).astype(np.float32)
                preds[k] = preds[k] * torch.tensor(1 + noise)
            preds["depth_conf"] = torch.tensor(rng.uniform(0.5, 2, (1, 8, H, W)),
                                               dtype=torch.float32)
        got = ttrain.MultitaskLoss(**LOSS_CFG)(preds, batch, step)
        want = jtrain.MultitaskLoss(**LOSS_CFG)({k: jnp.asarray(v.numpy()) for k, v in
                                                 preds.items()}, batch, step)
        assert got.keys() == want.keys()
        for k in want:
            assert _rel(got[k].item(), float(want[k])) <= RTOL or \
                abs(got[k].item() - float(want[k])) <= 1e-6, (k, got[k].item(), float(want[k]))
        if variant == "perfect" and step == 100:
            assert got["loss_camera"].item() < 1e-4
            assert got["loss_depth"].item() < 1e-4
            assert got["loss_per_frame_reg"].item() < 1e-5
            assert got["loss_per_chunk_reg"].item() < 1e-5
        if variant == "offsets":
            assert got["loss_per_frame_reg"].item() == pytest.approx(1.0, abs=1e-5)
            assert got["loss_per_chunk_reg"].item() == pytest.approx(np.log(2.0) ** 2, abs=1e-5)

    def test_random_large_offset_comes_from_the_generator(self):
        batch = make_synthetic_batch(B=1, N=8, H=H, W=W)
        cfg = dict(LOSS_CFG, cameraPoseRel={"weight": 0.5, "loss_type": "l1"})
        loss = ttrain.MultitaskLoss(**cfg)
        preds = _perfect(batch)
        preds["pose_enc"] = preds["pose_enc"] * 1.1
        a = loss(preds, batch, 100, torch.Generator().manual_seed(3))
        b = loss(preds, batch, 100, torch.Generator().manual_seed(3))
        assert a["loss_camera_rel"].item() == b["loss_camera_rel"].item()
        offsets = {int(torch.randint(4, 8, (), generator=torch.Generator().manual_seed(s)))
                   for s in range(20)}
        assert offsets == {4, 5, 6, 7}


def test_freezing_selects_the_jax_partition():
    model = FeatureAlignedVGGT(**TINY, dtype=torch.float32)
    jmodel = JaxModel(**TINY, dtype=jnp.float32)
    params = jax_variables(lambda r: jmodel.init(r, jnp.zeros((1, 4, 3, H, W)), 1),
                           seeded(model))
    jt, jf = jtrain.partition_params(params["params"], FREEZE)
    names = lambda tree: {port_name(k) for k in export_torch_style(tree)}  # noqa: E731
    trainable, frozen = ttrain.partition_params(model, FREEZE)
    assert set(trainable) == names({"params": jt}) and set(frozen) == names({"params": jf})
    assert all(n.startswith(("alignment_head.", "core.point_head.")) for n in trainable)
    got = ttrain.freeze_params(model, FREEZE)
    assert set(got) == set(trainable)
    assert not any(p.requires_grad for p in frozen.values())
    assert all(p.requires_grad for p in trainable.values())


def test_train_config_copy_matches_the_yaml():
    """train/config.py's copy of the shipped training config's train keys
    (for callers that parse no YAML) equals the file."""
    import os

    import yaml

    from vitslam_tpu_torch.train.config import VKITTI_TRAIN_CFG

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "train_featureAlignedVGGT_vkitti.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["loss"].pop("_target_")
    for key, value in VKITTI_TRAIN_CFG.items():
        assert cfg[key] == value, key


@pytest.mark.parametrize("kw", [dict(max_lr=1e-3, min_lr=1e-8, total_steps=100),
                                dict(max_lr=5e-5, min_lr=1e-8, total_steps=70000,
                                     warmup_percent=0.05)])
def test_lr_schedule_matches_optax(kw):
    tx, jschedule = jtrain.build_optimizer(**kw)
    schedule = ttrain.warmup_cosine_schedule(kw["max_lr"], kw["min_lr"], kw["total_steps"],
                                             kw.get("warmup_percent", 0.05))
    total = kw["total_steps"]
    for step in sorted({0, 1, 2, 3, 4, 5, 6, 7, 50, total // 20, total // 20 + 1, total // 2,
                        total - 1, total, total + 10}):
        want = float(jschedule(step))
        assert abs(schedule(step) - want) <= 1e-6 * kw["max_lr"], (step, schedule(step), want)


@pytest.mark.parametrize("S,buckets", [(40, None), (12, None), (40, [[5, 1], [10, 2], [20, 5]]),
                                       (12, [[5, 1], [10, 2], [20, 5]])])
def test_sample_chunk_shapes_matches_jax(S, buckets):
    a, b = np.random.default_rng(42 * 70000), np.random.default_rng(42 * 70000)
    for _ in range(30):
        assert ttrain.sample_chunk_shapes(a, S, [3, 20], [1, 5], buckets) == \
            jsample(b, S, [3, 20], [1, 5], buckets)


def _optax_tree_step(tx, opt_state, params, grads):
    updates, opt_state = tx.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state


def test_gradient_accumulation_matches_optax_multisteps():
    """accum_steps=2: the mean of 2 micro-steps' gradients, clipped, through
    AdamW; the schedule counts applied updates; the parameters stay put on
    the first micro-step of each pair. One gradient is large enough to be
    clipped."""
    rng = np.random.default_rng(5)
    p0 = {"w": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * (5.0 if i == 2 else 0.1)
              for k, v in p0.items()} for i in range(8)]
    kw = dict(max_lr=0.1, min_lr=1e-4, total_steps=20, warmup_percent=0.1, weight_decay=0.05,
              grad_clip_norm=1.0, accum_steps=2)
    tx, _ = jtrain.build_optimizer(**kw)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jparams)
    params = {k: torch.tensor(v) for k, v in p0.items()}
    opt, _ = ttrain.build_optimizer(params, **kw)
    for i, g in enumerate(grads):
        before = {k: v.clone() for k, v in params.items()}
        applied = opt.step({k: torch.tensor(v) for k, v in g.items()})
        jparams, opt_state = _optax_tree_step(tx, opt_state, jparams,
                                              {k: jnp.asarray(v) for k, v in g.items()})
        assert applied == (i % 2 == 1)
        for k in params:
            if not applied:
                assert torch.equal(params[k], before[k])
            np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-7)
    assert opt.count == 4


def _generator():
    return torch.Generator().manual_seed(DROP_SEED)


@pytest.fixture
def same_dropout(monkeypatch):
    """The JAX head's dropout uniforms := the port's first draw from
    _generator() (the (B, S - 1 - overlap) = (2, 2) draw of chunk 2)."""
    u = torch.rand((2, 2), generator=_generator()).numpy()
    assert (u <= 0.2).any() and (u > 0.2).any()

    def uniform(key, shape=(), *args, **kwargs):
        assert tuple(shape) == u.shape, shape
        return jnp.asarray(u)

    monkeypatch.setattr(jax.random, "uniform", uniform)


@pytest.mark.parametrize("temporal", [True, False])
def test_two_train_steps_match_jax(temporal, same_dropout):
    """Two steps of the tiny model from the same weights: the objective and
    every loss of both steps (rel 1e-4), the step-1 gradient of every
    trainable tensor (rel-L2 <= 1e-4; exact zeros where JAX's are zero),
    grad_norm, the trainable tensors after step 2 and their change over
    the run (rel-L2 <= 1e-4 and 1e-3: the step-2 update is lr 2e-4 times
    Adam's normalised direction), and the frozen tensors bit-identical.
    Chunk 2 (4 frames, overlap 1) runs the frame dropout."""
    kw = dict(TINY, temporal_attention=temporal)
    batch = make_synthetic_batch(B=2, N=7, H=H, W=W)
    indices = generate_chunks(7, "chunk_overlap", 4, 1)
    chunks_np = chunk_batch(batch, indices)
    merged_np = merge_chunk_outputs(chunks_np, 0)
    model = seeded(FeatureAlignedVGGT(**kw, dtype=torch.float32), seed=1)
    # the alignment token's 1e-6 init leaves the first frame block's
    # LayerNorm a near-constant row, which amplifies the token's gradient
    # ~1e6-fold into fp32 noise; a 0.02 token keeps the comparison about
    # the port, not that cancellation
    with torch.no_grad():
        model.alignment_head.per_frame_alignment_token.normal_(
            0.0, 0.02, generator=torch.Generator().manual_seed(5))
    jmodel = JaxModel(**kw, dtype=jnp.float32)
    params = jax_variables(lambda r: jmodel.init(r, jnp.asarray(batch["images"][:, :4]), 1), model)

    jloss = jtrain.MultitaskLoss(**LOSS_CFG)
    tx, _ = jtrain.build_optimizer(max_lr=1e-3, total_steps=100)
    jt, jf = jtrain.partition_params(params["params"], FREEZE)
    jstate = jtrain.TrainState(trainable=jt, frozen=jf, opt_state=tx.init(jt),
                               step=jnp.asarray(0))
    jchunks = tuple({k: jnp.asarray(v) for k, v in c.items()} for c in chunks_np)
    jmerged = {k: jnp.asarray(v) for k, v in merged_np.items()}
    step_fn = jtrain.make_train_step(jmodel, jloss, tx, num_overlap=1, donate=False)
    js1, jm1 = step_fn(jstate, jchunks, jmerged, jax.random.PRNGKey(1))
    js2, jm2 = step_fn(js1, jchunks, jmerged, jax.random.PRNGKey(2))
    # the step-1 gradient, read back from Adam's first moment after step 1:
    # mu = (1 - b1) * g clipped to global norm 1 (the step jits its gradient
    # inside; a second jax.grad trace would double the test's compile time),
    # in numpy: eager JAX would compile the two ops for every leaf's shape
    unclip = max(float(jm1["grad_norm"]), 1.0)
    jgrads = jax.tree.map(lambda m: np.asarray(m) / 0.1 * unclip, js1.opt_state[1][0].mu)

    loss = ttrain.MultitaskLoss(**LOSS_CFG)
    trainable = ttrain.freeze_params(model, FREEZE)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if n not in trainable}
    start = {n: p.detach().clone() for n, p in trainable.items()}
    chunks = tuple({k: torch.tensor(v) for k, v in c.items()} for c in chunks_np)
    merged = {k: torch.tensor(v) for k, v in merged_np.items()}
    opt, _ = ttrain.build_optimizer(trainable, max_lr=1e-3, total_steps=100)
    state = ttrain.TrainState(trainable=trainable, optimizer=opt)
    tstep = ttrain.make_train_step(model, loss, 1)
    state, m1 = tstep(state, chunks, merged, _generator())
    # the port's step-1 gradient, read back from Adam's first moment as the
    # reference's is (a separate loss_and_grads call would run the forward
    # and backward a third time)
    unclip = max(float(m1["grad_norm"]), 1.0)
    grads = {n: m / 0.1 * unclip for n, m in opt.mu.items()}
    state, m2 = tstep(state, chunks, merged, _generator())
    assert state.step == 2

    for got, want in ((m1, jm1), (m2, jm2)):
        keys = {k for k, v in want.items() if jnp.ndim(v) == 0} - (
            set() if "grad_norm" in got else {"grad_norm"})
        assert set(got) == keys, (set(got), keys)
        for k in keys:
            assert _rel(got[k].item(), float(want[k])) <= RTOL, (k, got[k].item(), float(want[k]))
    jg = {port_name(k): v for k, v in export_torch_style({"params": jgrads}).items()}
    assert set(jg) == set(grads)
    errs = {n: _rel(grads[n].numpy(), jg[n]) for n in grads}
    assert max(errs.values()) <= RTOL, sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    assert sum(float(np.abs(v).sum()) > 0 for v in jg.values()) > len(jg) // 2

    after = {port_name(k): v for k, v in export_torch_style({"params": js2.trainable}).items()}
    for n, p in trainable.items():
        assert _rel(p.detach().numpy(), after[n]) <= RTOL, n
    moved = np.concatenate([(p.detach() - start[n]).numpy().ravel() for n, p in trainable.items()])
    jmoved = np.concatenate([(after[n] - start[n].numpy()).ravel() for n in trainable])
    assert np.abs(moved).max() > 0 and _rel(moved, jmoved) <= 10 * RTOL
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p.detach(), frozen[n]), n


class _Loader:
    """A train_data stand-in: one synthetic batch per epoch."""

    def get_loader(self, epoch):
        yield make_synthetic_batch(B=1, N=7, H=H, W=W, seed=epoch)


def _cfg(tmp_path, max_steps):
    return dict(exp_name="tiny", max_steps=max_steps, chunk_width=[3, 4], num_overlap=[1, 1],
                val_epoch_freq=1000, seed_value=42,
                logging=dict(log_dir=str(tmp_path / "logs"), log_freq=1),
                checkpoint=dict(save_dir=str(tmp_path / "ckpt"), save_freq=1,
                                resume_from_checkpoint=True),
                optim=dict(frozen_module_names=FREEZE,
                           options=dict(lr=dict(max_value=1e-3, min_value=1e-8,
                                                linear_steps=0.3))))


def test_checkpoint_resume_and_fit(tmp_path, monkeypatch):
    """Trainer.fit writes the CSV log and <exp>_step<k>.ckpt files and
    updates the _latest link; a run cut before its clean finish leaves the
    link, and a new Trainer resumes from it to the same trainable tensors,
    optimizer state and step; a clean finish removes the link. The orbax
    backend does the same with sharded step directories."""
    import os

    model = seeded(FeatureAlignedVGGT(**TINY, dtype=torch.float32), seed=2)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = ttrain.Trainer(_cfg(tmp_path, 3), model, ttrain.MultitaskLoss(**LOSS_CFG),
                             train_data=_Loader())
    monkeypatch.setattr(trainer.ckpt, "finish", lambda: None)  # the run is cut here
    state = trainer.fit()
    assert state.step == 3 and state.optimizer.count == 3
    rows = (tmp_path / "logs" / "tiny" / "version_0" / "metrics.csv").read_text().splitlines()
    assert len(rows) == 4 and "objective" in rows[0] and "grad_norm" in rows[0]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["_latest_checkpoints", "tiny_step1.ckpt",
                                                     "tiny_step2.ckpt", "tiny_step3.ckpt"]
    assert os.path.realpath(trainer.ckpt.latest_link).endswith("tiny_step3.ckpt")

    fresh = FeatureAlignedVGGT(**TINY, dtype=torch.float32)
    fresh.load_state_dict(init)
    again = ttrain.Trainer(_cfg(tmp_path, 3), fresh, ttrain.MultitaskLoss(**LOSS_CFG),
                           train_data=_Loader())
    resumed = again.init_state()
    assert resumed.step == 3 and resumed.optimizer.count == 3
    for n, p in state.trainable.items():
        assert torch.equal(resumed.trainable[n].detach(), p.detach()), n
        assert torch.equal(resumed.optimizer.mu[n], state.optimizer.mu[n])
        assert torch.equal(resumed.optimizer.nu[n], state.optimizer.nu[n])
    # fit() resumes by itself when it starts without a state (the reference
    # starts at step 0 when the state was made before fit); nothing is left
    # to run, and the clean finish removes the link
    third = FeatureAlignedVGGT(**TINY, dtype=torch.float32)
    third.load_state_dict(init)
    last = ttrain.Trainer(_cfg(tmp_path, 3), third, ttrain.MultitaskLoss(**LOSS_CFG),
                          train_data=_Loader())
    assert last.fit().step == 3
    assert not os.path.lexists(again.ckpt.latest_link)

    # a dangling link is removed, not followed
    os.symlink(str(tmp_path / "gone.ckpt"), again.ckpt.latest_link)
    assert again.ckpt.resume_path() is None and not os.path.lexists(again.ckpt.latest_link)

    # three-tier load: the trainable tensors from a step checkpoint, the
    # rest from a fallback state dict; strict without a fallback
    tckpt.save_checkpoint(str(tmp_path / "base.ckpt"), init)
    target = FeatureAlignedVGGT(**TINY, dtype=torch.float32)
    step3 = str(tmp_path / "ckpt" / "tiny_step3.ckpt")
    assert tckpt.load_model_params(step3, target, fallback_path=str(tmp_path / "base.ckpt")) == []
    for n, p in target.named_parameters():
        want = state.trainable[n] if n in state.trainable else init[n]
        assert torch.equal(p.detach(), want.detach()), n
    with pytest.raises(KeyError):
        tckpt.load_model_params(step3, target)
    with pytest.raises(ValueError):  # the test mode needs val_data and metrics
        again.test()
    # several devices need a gang of ranks (tests/test_torch_parallel.py);
    # so do model shards (one process is a world of 1, which 2 does not
    # divide; the gang runs in tests/test_torch_tensor_parallel.py)
    with pytest.raises(RuntimeError, match="gang"):
        ttrain.Trainer(dict(_cfg(tmp_path, 1), num_devices=2), fresh,
                       ttrain.MultitaskLoss(**LOSS_CFG))
    with pytest.raises(ValueError, match="does not divide the 1 rank"):
        ttrain.Trainer(dict(_cfg(tmp_path, 1), num_model_shards=2), fresh,
                       ttrain.MultitaskLoss(**LOSS_CFG))
    # the orbax backend: sharded checkpoints (io/sharded_ckpt.py), here in
    # one process: a step directory and the link, resumed from
    sharded = dict(_cfg(tmp_path / "sharded", 1), checkpoint=dict(
        save_dir=str(tmp_path / "sharded" / "ckpt"), save_freq=1, backend="orbax",
        resume_from_checkpoint=True))
    orbax = ttrain.Trainer(sharded, fresh, ttrain.MultitaskLoss(**LOSS_CFG),
                           train_data=_Loader())
    monkeypatch.setattr(orbax.ckpt, "finish", lambda: None)
    saved = {n: p.detach().clone() for n, p in orbax.fit().trainable.items()}
    assert sorted(os.listdir(tmp_path / "sharded" / "ckpt")) == ["_latest_checkpoints",
                                                                 "tiny_step1.orbax"]
    fourth = FeatureAlignedVGGT(**TINY, dtype=torch.float32)
    fourth.load_state_dict(init)
    back = ttrain.Trainer(sharded, fourth, ttrain.MultitaskLoss(**LOSS_CFG)).init_state()
    assert back.step == 1 and back.optimizer.count == 1
    assert all(torch.equal(back.trainable[n].detach(), saved[n]) for n in saved)
