"""Resuming a train state the JAX package saved (vitslam_tpu/train:
TrainState with optax's AdamW state, written as flax msgpack by
vitslam_tpu/io/checkpoint.py::save_checkpoint) in the port:
``io.checkpoint.load_checkpoint`` reads it into the port's layout
(``io.from_jax.train_state_from_jax``: kernels transposed, scanned layers
split, the moments and the accumulated gradients like their parameters),
``Trainer.restore`` / ``init_state`` load it, and one more optimizer step
with the same gradients on both sides agrees.

Tolerances: the loaded tensors and counters are the saved ones bit for bit;
after one more step, fp32 AdamW arithmetic in another order on each side:
relative L2 error 1e-6 per parameter, and over each moment (mu, nu) as a
whole (an entry of mu where b1 mu and (1 - b1) g cancel keeps only the
absolute error of its terms)."""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from torch_weights import jax_variables, seeded  # noqa: E402
from vitslam_tpu import train as jtrain  # noqa: E402
from vitslam_tpu.io import checkpoint as jckpt  # noqa: E402
from vitslam_tpu.io.torch_convert import export_torch_style  # noqa: E402
from vitslam_tpu.models import FeatureAlignedVGGT as JaxModel  # noqa: E402
from vitslam_tpu_torch import train as ttrain  # noqa: E402
from vitslam_tpu_torch.io import checkpoint as tckpt  # noqa: E402
from vitslam_tpu_torch.io.from_jax import port_name  # noqa: E402
from vitslam_tpu_torch.models import FeatureAlignedVGGT  # noqa: E402

RTOL = 1e-6
H, W = 28, 42
TINY = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=4,
            patch_embed_depth=1, intermediate_layers=(0, 1, 1, 1), num_memory_tokens=4,
            align_embed_dim=64, align_dec_dim=64)
# the aggregator's scanned layers trainable, the rest frozen: their moments
# take the per-layer split of the stacked (L, ...) leaves and the kernels'
# transpose, as their parameters do, and the frozen tree still holds every
# other layout (and keeps the jitted optax update small)
FREEZE = ["*alignment_head*", "*camera_head*", "*depth_head*", "*patch_embed*"]
LOSS_CFG = dict(cameraPose={"weight": 1.0, "loss_type": "l1"}, total_steps=100)
OPT = dict(max_lr=1e-3, total_steps=100)


def _rel(got, want) -> float:
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)) if b.any() \
        else float(np.abs(a).max(initial=0.0))


def _port(tree) -> dict:
    """port name -> numpy array of a JAX parameter-shaped tree."""
    return {port_name(k): np.asarray(v) for k, v in export_torch_style(tree).items()}


def _grads(trainable, seed: int):
    """Random gradients shaped as ``trainable``; large enough that the
    global-norm clip acts."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), trainable)


@functools.lru_cache(maxsize=None)
def _optimizer(accum: int):
    """The JAX optimizer, its jitted init and its jitted update, (gradients,
    state, params) -> (params, state), once per accumulation count."""
    tx, _ = jtrain.build_optimizer(**OPT, accum_steps=accum)

    def update(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    return tx, jax.jit(tx.init), jax.jit(update)


@functools.lru_cache(maxsize=1)
def _weights():
    """The seeded port model's weights and the JAX variables holding them."""
    model = seeded(FeatureAlignedVGGT(**TINY, dtype=torch.float32), seed=3)
    jm = JaxModel(**TINY, dtype=jnp.float32)
    images = jnp.zeros((1, 4, 3, H, W), jnp.float32)
    return model.state_dict(), jax_variables(lambda r: jm.init(r, images, 1), model)


def _model():
    model = FeatureAlignedVGGT(**TINY, dtype=torch.float32)
    model.load_state_dict(_weights()[0])
    return model


@functools.lru_cache(maxsize=None)
def _jax_state(accum: int, steps: int):
    """A JAX TrainState of the tiny model's variables after ``steps`` optax
    updates with the gradients of ``_grads``."""
    _, init, update = _optimizer(accum)
    trainable, frozen = jtrain.partition_params(_weights()[1]["params"], FREEZE)
    opt_state = init(trainable)
    for i in range(steps):
        trainable, opt_state = update(_grads(trainable, i), opt_state, trainable)
    return jtrain.TrainState(trainable=trainable, frozen=frozen, opt_state=opt_state,
                             step=jnp.asarray(steps))


def _cfg(root, accum: int, resume: bool = False) -> dict:
    return dict(exp_name="tiny", max_steps=OPT["total_steps"], accum_steps=accum,
                logging=dict(log_dir=os.path.join(root, "logs")),
                checkpoint=dict(save_dir=os.path.join(root, "ckpt"),
                                resume_from_checkpoint=resume),
                optim=dict(frozen_module_names=FREEZE,
                           options=dict(lr=dict(max_value=OPT["max_lr"]))))


def _jax_moments(opt_state, accum: int):
    inner = opt_state.inner_opt_state if accum > 1 else opt_state
    return inner[1][0]


def _check_loaded(trainer, state, accum: int):
    """The trainer holds the JAX state's tensors and counters bit for bit."""
    params = dict(trainer.model.named_parameters())
    for group in (state.trainable, state.frozen):
        for n, v in _port(group).items():
            assert np.array_equal(params[n].detach().numpy(), v), n
    opt = trainer.state.optimizer
    adam = _jax_moments(state.opt_state, accum)
    assert opt.count == int(adam.count) and trainer.state.step == int(state.step)
    for mine, theirs in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
        theirs = _port(theirs)
        assert set(mine) == set(theirs) == set(trainer.state.trainable)
        assert all(np.array_equal(mine[n].numpy(), theirs[n]) for n in mine)
    if accum > 1:
        assert opt.mini_step == int(state.opt_state.mini_step) == 1
        acc = _port(state.opt_state.acc_grads)
        assert all(np.array_equal(opt.acc[n].numpy(), acc[n]) for n in opt.acc)
        assert any(np.abs(a).sum() > 0 for a in acc.values())


@pytest.mark.parametrize("accum,steps", [(1, 2), (2, 3)], ids=["adamw", "multisteps"])
def test_resume_reference_train_state(accum, steps, tmp_path):
    """A JAX TrainState after two optax steps (accum 1), or after three
    micro-steps of MultiSteps(2) (one update applied, one gradient
    accumulated), loads into the port's Trainer bit for bit; one more step
    with the same gradients on both sides (under accum 2, the one that
    applies the accumulated update) gives parameters and moments within
    rel 1e-6."""
    state = _jax_state(accum, steps)
    path = jckpt.save_checkpoint(str(tmp_path / "ref.ckpt"), state)
    assert tckpt.checkpoint_format(path) == "flax"

    trainer = ttrain.Trainer(_cfg(str(tmp_path), accum), _model(),
                             ttrain.MultitaskLoss(**LOSS_CFG))
    trainer.init_state()
    trainer.restore(tckpt.load_checkpoint(path))
    _check_loaded(trainer, state, accum)

    g = _grads(state.trainable, 99)
    after, opt_state = _optimizer(accum)[2](g, state.opt_state, state.trainable)
    want = _port(after)
    applied = trainer.state.optimizer.step({n: torch.tensor(v) for n, v in _port(g).items()})
    assert applied
    for n, p in trainer.state.trainable.items():
        assert _rel(p.detach(), want[n]) <= RTOL, n
    adam = _jax_moments(opt_state, accum)
    opt = trainer.state.optimizer
    for mine, theirs in ((opt.mu, _port(adam.mu)), (opt.nu, _port(adam.nu))):
        names = sorted(mine)
        assert _rel(np.concatenate([mine[n].numpy().ravel() for n in names]),
                    np.concatenate([theirs[n].ravel() for n in names])) <= RTOL
    assert opt.count == int(adam.count)


def test_trainer_resumes_from_a_reference_latest_link(tmp_path):
    """A Trainer with resume_from_checkpoint resumes from the _latest link
    the JAX package's CheckpointManager wrote (same save_dir and exp_name):
    its step, optimizer and tensors are the saved ones."""
    state = _jax_state(1, 2)
    mgr = jckpt.CheckpointManager(str(tmp_path / "ckpt"), "tiny")
    mgr.save(2, state)
    assert os.path.islink(mgr.latest_link)
    trainer = ttrain.Trainer(_cfg(str(tmp_path), 1, resume=True), _model(),
                             ttrain.MultitaskLoss(**LOSS_CFG))
    trainer.init_state()
    assert trainer.state.step == 2
    _check_loaded(trainer, state, 1)


def test_unplaceable_leaves_raise(tmp_path):
    """A leaf the port cannot place, accumulated gradients a trainer
    without accumulation cannot keep, or an optimizer state of another
    structure, is a KeyError naming it, never skipped."""
    state = _jax_state(1, 2)
    extra = dict(state.trainable, stray={"kernel": jnp.ones((2, 2))})
    odd = jtrain.TrainState(trainable=extra, frozen=state.frozen, opt_state=state.opt_state,
                            step=state.step)
    path = jckpt.save_checkpoint(str(tmp_path / "odd.ckpt"), odd)
    trainer = ttrain.Trainer(_cfg(str(tmp_path), 1), _model(), ttrain.MultitaskLoss(**LOSS_CFG))
    trainer.init_state()
    with pytest.raises(KeyError, match="stray.weight"):
        trainer.restore(tckpt.load_checkpoint(path))
    multi = _jax_state(2, 3)  # MultiSteps: accumulated gradients a trainer of accum 1 lacks
    path = jckpt.save_checkpoint(str(tmp_path / "multi.ckpt"), multi)
    with pytest.raises(KeyError, match="acc"):
        trainer.restore(tckpt.load_checkpoint(path))
    sgd = jtrain.TrainState(trainable=state.trainable, frozen=state.frozen,
                            opt_state=optax.sgd(0.1).init(state.trainable), step=state.step)
    path = jckpt.save_checkpoint(str(tmp_path / "sgd.ckpt"), sgd)
    with pytest.raises(KeyError, match="opt_state"):
        tckpt.load_checkpoint(path)
