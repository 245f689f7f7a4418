"""Tensor parallelism of the port (vitslam_tpu_torch/parallel/mesh.py::
shard_params_model and its users) and the sharded checkpoint
(io/sharded_ckpt.py) on the CPU: gloo gangs launched through
``parallel.spawn_gang``, held against the port's single-process paths
(which tests/test_torch_train.py holds to the JAX package), and the layout
held to the JAX package's ``model_partition_spec``.

Three gangs and the pod dry run (``python -m vitslam_tpu_torch.parallel.dryrun
4``), launched together by a module fixture; each scenario's tests read
what its ranks saved. The file is its own worker:

    python tests/test_torch_tensor_parallel.py <scenario> <rank> <port> <world> <outdir>

* "tp2": 2 ranks, one node, mesh (data 1, model 2): the forward before and
  after sharding, two train steps, the sharded checkpoint through its
  manager (saved at model 2, restored at model 2 and at data 2);
* "fit2": 2 ranks, one node: a Trainer with ``num_model_shards: 2`` and
  either checkpoint backend, its resume, and its refusals;
* "tp4": 4 ranks, two nodes of two (LOCAL_WORLD_SIZE 2), mesh (data 2,
  model 2): data across the nodes, model within; two train steps on a
  2-sample batch, one sample a data rank.

Tolerances: fp32 on both sides. A sharded step adds the same terms in
another order (the data group's gradient sum, the norm's partial sums):
the objective within rel 1e-5, each gathered gradient within rel-L2 1e-5
(the JAX package's 2 x 2 step agrees with its unsharded one to 1e-5,
tests/test_train.py), the trainable tensors after two AdamW steps within
1e-4 (tests/test_torch_parallel.py's ADAM_RTOL), the sharded global norm
within 1e-6. The forward of a sharded model is the unsharded one bit for
bit (the gathers only move values); the checkpoints round-trip bit for bit.
"""
import copy
import functools
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vitslam_tpu_torch import parallel  # noqa: E402
from vitslam_tpu_torch.io import ShardedCheckpointManager, as_dtensors, load_sharded  # noqa: E402
from vitslam_tpu_torch.models import FeatureAlignedVGGT  # noqa: E402
from vitslam_tpu_torch.nn import layers as tl  # noqa: E402
from vitslam_tpu_torch.slam import ChunkedPipeline, chunk_batch, generate_chunks  # noqa: E402
from vitslam_tpu_torch.slam import merge_chunk_outputs  # noqa: E402
from vitslam_tpu_torch.train import MultitaskLoss, Trainer, TrainState  # noqa: E402
from vitslam_tpu_torch.train import build_optimizer, freeze_params  # noqa: E402
from vitslam_tpu_torch.train import loss_and_grads, make_train_step  # noqa: E402
from vitslam_tpu_torch.utils import make_synthetic_batch  # noqa: E402

RTOL = 1e-5
ADAM_RTOL = 1e-4
NORM_RTOL = 1e-6
H, W = 28, 42
# tests/test_torch_parallel.py's tiny model: the head 64 wide (8-wide heads)
TINY = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=4,
            patch_embed_depth=1, intermediate_layers=(0, 1, 1, 1), num_memory_tokens=4,
            align_embed_dim=64, align_dec_dim=64, enable_point=False)
FREEZE = ["*aggregator*", "*camera_head*", "*depth_head*"]
LOSS_CFG = dict(
    cameraPose={"weight": 1.0, "loss_type": "l1"},
    cameraPoseRel={"weight": 0.5, "loss_type": "l1", "large_offset": 5},
    depth={"weight": 0.1, "valid_range": 0.98},
    perFrameReg={"weight": 5.0, "warmup_percent": 0.1, "warmup_type": "linear"},
    perChunkReg={"weight": 5.0},
    total_steps=100,
)
GANGS = {"tp2": (2, 2), "tp4": (4, 2), "fit2": (2, 2)}  # scenario -> (world, LOCAL_WORLD_SIZE)


def _rel(got, want) -> float:
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)) if b.any() \
        else float(np.abs(a).max(initial=0.0))


@functools.lru_cache(maxsize=1)
def _feature_weights():
    model = tl.init_weights(FeatureAlignedVGGT(**TINY, dtype=torch.float32),
                            torch.Generator().manual_seed(1)).eval()
    with torch.no_grad():  # a 0.02 token, as tests/test_torch_train.py
        model.alignment_head.per_frame_alignment_token.normal_(
            0.0, 0.02, generator=torch.Generator().manual_seed(5))
    return model


def _feature_model():
    return copy.deepcopy(_feature_weights())


def _train_batch(B):
    batch = make_synthetic_batch(B=B, N=7, H=H, W=W, seed=11)
    batch["point_masks"][-1, :, :, W // 3:] = 0.0
    return batch


def _train_case(B):
    """The B-sample batch chunked at width 4 / overlap 1 (chunk 2 runs the
    frame dropout): the chunk batches (numpy) and the merged GT."""
    chunks_np = chunk_batch(_train_batch(B), generate_chunks(7, "chunk_overlap", 4, 1))
    merged = {k: torch.tensor(v) for k, v in merge_chunk_outputs(chunks_np, 0).items()}
    return chunks_np, merged


def _train(model, chunks_np, merged, mesh=None, shards=None, steps=2):
    """loss_and_grads at step 0 (its gradients gathered whole, and their
    global norm), then ``steps`` train steps; the trainable tensors after
    them, whole."""
    full = (lambda n, t: t) if shards is None else shards.full  # noqa: E731
    data_group = None if mesh is None else mesh.group("data")
    if mesh is not None and len(merged["images"]) % mesh.size("data") == 0:
        chunks_np = [parallel.shard_batch(c, mesh) for c in chunks_np]
    chunks = tuple({k: torch.tensor(v) for k, v in c.items()} for c in chunks_np)
    loss = MultitaskLoss(**LOSS_CFG)
    trainable = freeze_params(model, FREEZE)
    opt, _ = build_optimizer(trainable, max_lr=1e-3, total_steps=100, shards=shards)
    losses0, grads = loss_and_grads(model, loss, trainable, chunks, merged, 0, 1,
                                    generator=torch.Generator().manual_seed(0),
                                    data_group=data_group)
    norm = float(opt.grad_norm(grads))
    state = TrainState(trainable=trainable, optimizer=opt)
    step = make_train_step(model, loss, 1, data_group=data_group)
    metrics = []
    for _ in range(steps):
        state, m = step(state, chunks, merged, torch.Generator().manual_seed(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(losses0={k: float(v) for k, v in losses0.items()}, norm=norm, metrics=metrics,
                grads={n: full(n, g).clone() for n, g in grads.items()},
                after={n: full(n, p.detach()).clone() for n, p in trainable.items()},
                state=state)


def _serve(model):
    pred, _ = ChunkedPipeline(model).run_sequence(
        {"images": make_synthetic_batch(B=1, N=7, H=H, W=W, seed=3)["images"]},
        chunk_width=4, num_overlap=1)
    return pred


class _TrainData:
    def get_loader(self, epoch):
        yield _train_batch(2)


def _fit_cfg(root, backend="orbax", **extra):
    return dict(exp_name="tiny", max_steps=2, chunk_width=[3, 4], num_overlap=[1, 1],
                val_epoch_freq=1000, seed_value=42,
                logging=dict(log_dir=os.path.join(root, "logs"), log_freq=1),
                checkpoint=dict(save_dir=os.path.join(root, "ckpt"), save_freq=1,
                                resume_from_checkpoint=True, backend=backend),
                optim=dict(frozen_module_names=FREEZE,
                           options=dict(lr=dict(max_value=1e-3, min_value=1e-8,
                                                linear_steps=0.3))), **extra)


def _whole(trainer) -> dict:
    return {n: trainer.whole(n, p.detach()).clone() for n, p in trainer.state.trainable.items()}


# --- the workers -----------------------------------------------------------------

def _checkpoints(rank, out, outdir, mesh, shards, state):
    """The sharded checkpoint manager at model 2: keep pruning, a restore
    through the link into a fresh manager, a restore at data 2, finish()
    and a dangling link."""
    opt = state.optimizer
    tree = lambda: {"trainable": as_dtensors({n: p.detach() for n, p in  # noqa: E731
                                              state.trainable.items()}, shards),
                    "optimizer": {"count": opt.count, "mu": as_dtensors(opt.mu, shards)},
                    "step": state.step}
    root = os.path.join(outdir, "ckpts")
    mgr = ShardedCheckpointManager(root, "exp", save_freq=500, keep=2)
    out["skipped"] = mgr.maybe_save(499, tree) is None
    out["paths"] = [mgr.maybe_save(s, tree) for s in (500, 1000, 1500)]
    parallel.sync_global_devices()
    out["dirs"] = sorted(os.listdir(root))
    out["link"] = os.path.realpath(mgr.latest_link)
    again = ShardedCheckpointManager(root, "exp", save_freq=500, keep=2)
    template = {"trainable": as_dtensors({n: torch.zeros_like(p) for n, p in
                                          state.trainable.items()}, shards),
                "optimizer": {"count": 0, "mu": as_dtensors(
                    {n: torch.zeros_like(t) for n, t in opt.mu.items()}, shards)},
                "step": 0}
    got = again.restore(template)
    out["restored_equal"] = (
        got["step"] == state.step and got["optimizer"]["count"] == opt.count
        and all(torch.equal(got["trainable"][n].to_local() if n in shards.dims
                            else got["trainable"][n], p.detach())
                for n, p in state.trainable.items())
        and all(torch.equal(got["optimizer"]["mu"][n].to_local() if n in shards.dims
                            else got["optimizer"]["mu"][n], t) for n, t in opt.mu.items()))
    # the same directory read at data 2: every rank the whole tensors
    whole = {n: torch.zeros_like(shards.full(n, p.detach())) for n, p in state.trainable.items()}
    load_sharded(out["link"], {"trainable": whole})
    out["data2_equal"] = all(torch.equal(whole[n], shards.full(n, p.detach()))
                             for n, p in state.trainable.items())
    out["whole"] = {"trainable": {n: shards.full(n, p.detach()) for n, p in
                                  state.trainable.items()},
                    "mu": {n: shards.full(n, t) for n, t in opt.mu.items()},
                    "count": opt.count, "step": state.step}
    again.finish()
    parallel.sync_global_devices()
    out["after_finish"] = again.resume_path()
    if rank == 0:
        os.symlink(os.path.join(root, "gone.orbax"), again.latest_link)
    parallel.sync_global_devices()
    out["dangling"] = again.resume_path()
    parallel.sync_global_devices()
    out["dangling_removed"] = not os.path.lexists(again.latest_link)


def _fit_and_resume(root, backend):
    """Trainer(num_model_shards=2) fit for 2 steps, cut before its clean
    finish, then a fresh Trainer resumed from its link."""
    trainer = Trainer(_fit_cfg(root, backend, num_model_shards=2), _feature_model(),
                      MultitaskLoss(**LOSS_CFG), train_data=_TrainData())
    trainer.ckpt.finish = lambda: None  # the run is cut here: its link stays
    trainer.fit()
    again = Trainer(_fit_cfg(root, backend, num_model_shards=2), _feature_model(),
                    MultitaskLoss(**LOSS_CFG), train_data=_TrainData())
    state = again.init_state()
    return trainer, dict(step=state.step, count=state.optimizer.count, trainable=_whole(again))


def _trainer(rank, out, outdir):
    """Trainer(num_model_shards=2): fit and resume with the orbax backend
    and with the msgpack one (whole tensors, rank 0's file), and the
    refusals."""
    root = os.path.join(outdir, "fit")
    trainer, out["resumed"] = _fit_and_resume(root, "orbax")
    out["fit"] = _whole(trainer)
    out["fit_mesh"] = dict(trainer.mesh.shape)
    out["fit_dirs"] = sorted(os.listdir(os.path.join(root, "ckpt")))
    _, out["msgpack_resumed"] = _fit_and_resume(os.path.join(outdir, "fit_msgpack"), "msgpack")
    refused = {}
    try:
        Trainer(_fit_cfg(root, num_model_shards=3), _feature_model(), MultitaskLoss(**LOSS_CFG))
    except ValueError as e:
        refused["divide"] = str(e)
    os.environ["LOCAL_WORLD_SIZE"] = "1"  # one rank a node: a model group would span two
    try:
        Trainer(_fit_cfg(root, num_model_shards=2), _feature_model(), MultitaskLoss(**LOSS_CFG))
    except ValueError as e:
        refused["nodes"] = str(e)
    finally:
        os.environ["LOCAL_WORLD_SIZE"] = "2"
    out["refused"] = refused


def _worker_tp2(rank, out, outdir):
    model = _feature_model()
    before = _serve(model)
    mesh = parallel.make_mesh(n_data=1, n_model=2)
    shards = parallel.shard_params_model(model, mesh)
    out["dims"] = dict(shards.dims)
    out["shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    after = _serve(model)
    out["forward_equal"] = {k: torch.equal(before[k], after[k]) for k in before}
    out["forward"] = after
    train = _train(model, *_train_case(2), mesh, shards)
    _checkpoints(rank, out, outdir, mesh, shards, train.pop("state"))
    out["train"] = train


def _worker_tp4(rank, out, outdir):
    mesh = parallel.make_mesh(n_data=2, n_model=2)
    model = _feature_model()
    shards = parallel.shard_params_model(model, mesh)
    out["coords"] = dict(mesh.coords)
    out["node"] = parallel.node_index()
    train = _train(model, *_train_case(2), mesh, shards)
    train.pop("state")
    out["train"] = train


WORKERS = {"tp2": _worker_tp2, "tp4": _worker_tp4, "fit2": _trainer}


def _worker_main(scenario, rank, port, world, outdir):
    torch.set_num_threads(1)
    parallel.init_distributed("gloo", f"localhost:{port}", world, rank)
    try:
        out: dict = {}
        WORKERS[scenario](rank, out, outdir)
        torch.save(out, os.path.join(outdir, f"{scenario}_{rank}.pt"))
    finally:
        dist.destroy_process_group()
    print(f"worker {rank}: OK")


# --- the tests -----------------------------------------------------------------

def _gang(outdir, scenario):
    world, per_node = GANGS[scenario]
    argv = lambda rank, port: [sys.executable, os.path.abspath(__file__), scenario,  # noqa: E731
                               str(rank), str(port), str(world), outdir]
    env = parallel.clean_env({"PYTHONPATH": ROOT, "LOCAL_WORLD_SIZE": str(per_node)})
    outs, _ = parallel.spawn_gang(argv, world, timeout=300, retries=2, cwd=ROOT, env=env)
    assert all(f"worker {r}: OK" in o for r, o in enumerate(outs)), outs
    return [dict(torch.load(os.path.join(outdir, f"{scenario}_{r}.pt"), weights_only=False),
                 dir=outdir) for r in range(world)]


def _dryrun() -> str:
    """``python -m vitslam_tpu_torch.parallel.dryrun 4`` on the CPU; its
    output."""
    proc = subprocess.run([sys.executable, "-m", "vitslam_tpu_torch.parallel.dryrun", "4"],
                          cwd=ROOT, env=parallel.clean_env({"PYTHONPATH": ROOT}),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Both gangs and the dry run, started together at first use."""
    outdirs = {name: str(tmp_path_factory.mktemp(name)) for name in WORKERS}
    with ThreadPoolExecutor(len(WORKERS) + 1) as pool:
        futures = {name: pool.submit(_gang, outdirs[name], name) for name in WORKERS}
        futures["dryrun"] = pool.submit(_dryrun)
        yield futures
        for f in futures.values():
            f.exception()


@pytest.fixture(scope="module")
def tp2(gangs):
    return gangs["tp2"].result()


@pytest.fixture(scope="module")
def tp4(gangs):
    return gangs["tp4"].result()


@pytest.fixture(scope="module")
def fit2(gangs):
    return gangs["fit2"].result()


def _split_dims(tree: dict, n_model: int) -> dict:
    """port name -> the dim the JAX package splits, in the port's layout:
    each JAX leaf that ``model_partition_spec`` splits is filled with its
    index along the split dim, exported with the port's layout map
    (transposes, per-layer splits), and the dim along which each port
    tensor varies is read back."""
    from vitslam_tpu.parallel.mesh import model_partition_spec as jspec
    from vitslam_tpu_torch.io.from_jax import export_flat, flatten_tree, port_name

    marked = {}
    for path, leaf in flatten_tree(tree).items():
        spec = tuple(jspec(leaf, n_model))
        if "model" in spec:
            d = spec.index("model")
            shape = [1] * leaf.ndim
            shape[d] = leaf.shape[d]
            leaf = np.broadcast_to(np.arange(leaf.shape[d], dtype=np.float32).reshape(shape),
                                   leaf.shape)
        else:
            leaf = np.zeros(leaf.shape, np.float32)
        marked[path] = leaf
    out = {}
    for key, t in export_flat(marked).items():
        t = np.asarray(t)
        varying = [d for d in range(t.ndim) if t.shape[d] > 1 and np.ptp(t, axis=d).any()]
        out[port_name(key)] = varying[0] if varying else None
    return out


def test_layout_matches_jax_partition_spec(tp2):
    """(1) Every parameter of the tiny FeatureAlignedVGGT: sharded or not,
    and along which dim, as the JAX package's model_partition_spec on its
    JAX leaf mapped by port_name (kernels transposed, scanned layers
    split). The one difference, listed: the JAX package stacks the
    per-layer vectors of its scanned layers into (L, C) leaves and splits
    them; the port keeps them per layer, 1-D, and replicated."""
    import jax
    import jax.numpy as jnp

    from vitslam_tpu.models import FeatureAlignedVGGT as JaxModel

    jm = JaxModel(**TINY, dtype=jnp.float32)
    images = jnp.zeros((1, 4, 3, H, W), jnp.float32)
    shapes = jax.eval_shape(lambda r: jm.init(r, images, 1), jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = _split_dims(tree, 2)
    got, local = tp2[0]["dims"], tp2[0]["shapes"]
    assert set(want) == set(local)
    stacked_vectors = {n for n, d in want.items() if d is not None and len(local[n]) == 1}
    assert stacked_vectors and all(".layers." in n or ".blocks." in n for n in stacked_vectors)
    assert {n: d for n, d in want.items() if d is not None and n not in stacked_vectors} == got
    full = {n: p.shape for n, p in _feature_weights().named_parameters()}
    for n, shape in local.items():
        expect = list(full[n])
        if n in got:
            expect[got[n]] //= 2
        assert list(shape) == expect, n
    assert any(n.startswith("core.aggregator.layers.") for n in got)
    assert any(n.startswith("alignment_head.") for n in got)


def test_sharded_forward_equals_one_process(tp2):
    """(2) The forward of the sharded model (ChunkedPipeline, 2 chunks)
    bit for bit the same model's before sharding, on both ranks."""
    for out in tp2:
        assert out["forward_equal"] and all(out["forward_equal"].values()), out["forward_equal"]
        assert all(torch.equal(out["forward"][k], tp2[0]["forward"][k]) for k in out["forward"])


@pytest.fixture(scope="module")
def reference():
    return _train(_feature_model(), *_train_case(2))


@pytest.mark.parametrize("scenario", ["tp2", "tp4"], ids=["1x2", "2x2"])
def test_tp_step_matches_one_process(gangs, reference, scenario):
    """(2) The sharded step at (data 1, model 2) and (data 2, model 2, two
    nodes): every loss at step 0 and the metrics of two steps within rel
    1e-5, every gathered gradient within rel-L2 1e-5, the sharded global
    norm within 1e-6, the trainable tensors after two AdamW steps within
    1e-4, bit-identical on every rank."""
    outs = gangs[scenario].result()
    for out in outs:
        got = out["train"]
        for k, v in reference["losses0"].items():
            assert _rel(got["losses0"][k], v) <= RTOL, (k, got["losses0"][k], v)
        for gm, wm in zip(got["metrics"], reference["metrics"]):
            for k, v in wm.items():
                assert _rel(gm[k], v) <= RTOL, (k, gm[k], v)
        errs = {n: _rel(g, reference["grads"][n]) for n, g in got["grads"].items()}
        assert set(errs) == set(reference["grads"])
        assert max(errs.values()) <= RTOL, sorted(errs.items(), key=lambda kv: -kv[1])[:5]
        assert abs(got["norm"] - reference["norm"]) <= NORM_RTOL * reference["norm"]
        assert max(_rel(a, reference["after"][n]) for n, a in got["after"].items()) <= ADAM_RTOL
        assert all(torch.equal(a, outs[0]["train"]["after"][n]) for n, a in got["after"].items())


def test_tp4_lays_data_across_nodes_and_model_within(tp4):
    assert [(o["coords"]["data"], o["coords"]["model"], o["node"]) for o in tp4] == \
        [(0, 0, 0), (0, 1, 0), (1, 0, 1), (1, 1, 1)]


def test_sharded_checkpoint_round_trips(tp2):
    """(3) The manager at model 2: keep pruning (3 saves, keep 2), a fresh
    manager restores through the link bit-equal at model 2, the same
    directory loads bit-equal at data 2 (every rank the whole tensors) and
    in this process at model 1; finish() removes the link, a dangling link
    is removed and not followed."""
    for out in tp2:
        assert out["skipped"] and out["paths"][0].endswith("exp_step500.orbax")
        assert out["dirs"] == ["_latest_checkpoints", "exp_step1000.orbax", "exp_step1500.orbax"]
        assert out["link"].endswith("exp_step1500.orbax")
        assert out["restored_equal"] and out["data2_equal"]
        assert out["after_finish"] is None and out["dangling"] is None
        assert out["dangling_removed"]
    whole = tp2[0]["whole"]
    template = {"trainable": {n: torch.zeros_like(t) for n, t in whole["trainable"].items()},
                "optimizer": {"count": 0, "mu": {n: torch.zeros_like(t)
                                                 for n, t in whole["mu"].items()}},
                "step": 0}
    got = load_sharded(tp2[0]["link"], template)
    assert got["step"] == whole["step"] == 2 and got["optimizer"]["count"] == whole["count"]
    for n, t in whole["trainable"].items():
        assert torch.equal(got["trainable"][n], t), n
        assert torch.equal(got["optimizer"]["mu"][n], whole["mu"][n]), n


def test_trainer_with_model_shards(fit2, tmp_path):
    """The Trainer with num_model_shards: 2 in a 2-rank gang: a (1, 2) mesh,
    two fit steps whose trainable tensors match a single-process fit's
    (ADAM_RTOL); with the orbax backend sharded step checkpoints, with the
    msgpack one the single-process file (whole tensors); a resume through
    either link to the same tensors and step; it refuses a shard count that
    does not divide the gang and a model group across nodes."""
    want = Trainer(_fit_cfg(str(tmp_path)), _feature_model(), MultitaskLoss(**LOSS_CFG),
                   train_data=_TrainData())
    want.fit()
    want = _whole(want)
    # the msgpack backend under model shards writes the whole tensors on
    # rank 0: the file a single process writes (its step 2 within ADAM_RTOL)
    alone = Trainer(_fit_cfg(str(tmp_path / "alone"), "msgpack"), _feature_model(),
                    MultitaskLoss(**LOSS_CFG), train_data=_TrainData())
    alone.fit()
    mine = torch.load(os.path.join(fit2[0]["dir"], "fit_msgpack", "ckpt", "tiny_step2.ckpt"),
                      weights_only=True)
    theirs = torch.load(str(tmp_path / "alone" / "ckpt" / "tiny_step2.ckpt"), weights_only=True)
    assert mine.keys() == theirs.keys() and mine["step"] == theirs["step"] == 2
    assert mine["trainable"].keys() == theirs["trainable"].keys()
    for n, t in theirs["trainable"].items():
        assert mine["trainable"][n].shape == t.shape and _rel(mine["trainable"][n], t) <= ADAM_RTOL
        assert mine["optimizer"]["mu"][n].shape == t.shape
    for out in fit2:
        assert out["fit_mesh"] == {"data": 1, "model": 2}
        assert out["fit_dirs"] == ["_latest_checkpoints", "tiny_step1.orbax", "tiny_step2.orbax"]
        assert max(_rel(out["fit"][n], want[n]) for n in want) <= ADAM_RTOL
        for resumed in (out["resumed"], out["msgpack_resumed"]):
            assert resumed["step"] == 2 and resumed["count"] == 2
            assert all(torch.equal(resumed["trainable"][n], out["fit"][n]) for n in want)
        assert "does not divide the 2 rank(s)" in out["refused"]["divide"]
        assert "within one node" in out["refused"]["nodes"]


def test_pod_dryrun_on_the_cpu(gangs):
    """The pod-topology dry run (vitslam_tpu_torch/parallel/dryrun.py, the
    counterpart of __graft_entry__.py::dryrun_multichip) over 4 CPU ranks:
    a (2, 2) sharded train step, the sequence-parallel encode against the
    unsharded one, and the 2-node pod (pod_worker: data across the nodes,
    model within), whose ranks print the same objectives; those equal the
    same two steps of the same model in one process (rel 1e-5)."""
    from vitslam_tpu_torch.parallel import pod_worker

    out = gangs["dryrun"].result()
    assert out.count("dryrun_multichip ok") == 2 and "DONE" in out
    assert "train step mesh=(2x2)" in out and "sequence-parallel encode over (1x4)" in out
    pod = [float(v) for v in re.search(r"objectives \[([^]]*)\] on every rank", out)
           .group(1).replace("'", "").split(",")]
    chunks, merged = pod_worker.train_case(2, "cpu")
    want = pod_worker.train_steps(pod_worker.small_model("cpu"), chunks, merged, 2)
    assert len(pod) == 2 and all(abs(a - b) <= RTOL * abs(b) for a, b in zip(pod, want))


if __name__ == "__main__":
    _worker_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
