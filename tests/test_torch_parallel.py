"""The port's distributed layer (vitslam_tpu_torch/parallel and its users) on
the CPU: gangs of 2 gloo ranks, launched through the port's own
``parallel.spawn_gang``, against the port's single-process paths (which the
other test_torch_* files hold to the JAX package), plus one layer-level
parity with the JAX package's sequence-parallel attention under shard_map.

Each scenario runs one gang; a module-scoped fixture launches it once and
its tests read what the ranks saved. The file is its own worker:

    python tests/test_torch_parallel.py <scenario> <rank> <port> <world> <outdir>

joins a gloo gang at localhost:<port>, runs the scenario and saves the
rank's results to <outdir>/<scenario>_<rank>.pt. The worker imports no JAX.

Tolerances: fp32 on both sides; a gathered or sharded computation adds the
same terms in another order (the data-parallel gradient is a sum of the
ranks' parts), so relative L2 error <= 1e-5 per tensor.
"""
import copy
import functools
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vitslam_tpu_torch import parallel  # noqa: E402
from vitslam_tpu_torch.eval import AbsoluteTrajectoryError, Metrics  # noqa: E402
from vitslam_tpu_torch.models import FeatureAlignedVGGT, PointAlignedVGGT  # noqa: E402
from vitslam_tpu_torch.models.aggregator import expand_frame_tokens  # noqa: E402
from vitslam_tpu_torch.nn import layers as tl  # noqa: E402
from vitslam_tpu_torch.nn.rope import patch_grid_positions, rope_cache_2d  # noqa: E402
from vitslam_tpu_torch.slam import ChunkedPipeline, chunk_batch, generate_chunks  # noqa: E402
from vitslam_tpu_torch.slam import merge_chunk_outputs  # noqa: E402
from vitslam_tpu_torch.train import MultitaskLoss, Trainer, build_optimizer  # noqa: E402
from vitslam_tpu_torch.train import TrainState, freeze_params, loss_and_grads  # noqa: E402
from vitslam_tpu_torch.train import make_train_step  # noqa: E402
from vitslam_tpu_torch.utils import make_synthetic_batch  # noqa: E402

WORLD = 2
RTOL = 1e-5
# trainable tensors after two AdamW steps: Adam moves each entry by about lr
# times the sign of its (normalised) gradient, so an entry whose gradient is
# near zero moves by up to lr on a 1e-7 difference in that gradient
# (tests/test_torch_train.py holds the same comparison to 1e-4)
ADAM_RTOL = 1e-4
H, W = 28, 42
BACKBONE = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=4,
                patch_embed_depth=1, intermediate_layers=(0, 1, 1, 1))
# the head at width 64 (8-wide heads), as tests/test_torch_train.py: at
# narrower heads the per-head LayerNorm's gradients cancel to a few digits;
# no point head (as the shipped training config), to keep the DPT decode cheap
TINY = dict(BACKBONE, num_memory_tokens=4, align_embed_dim=64, align_dec_dim=64,
            enable_point=False)
FREEZE = ["*aggregator*", "*camera_head*", "*depth_head*"]
LOSS_CFG = dict(
    cameraPose={"weight": 1.0, "loss_type": "l1"},
    cameraPoseRel={"weight": 0.5, "loss_type": "l1", "large_offset": 5},
    depth={"weight": 0.1, "valid_range": 0.98},
    perFrameReg={"weight": 5.0, "warmup_percent": 0.1, "warmup_type": "linear"},
    perChunkReg={"weight": 5.0},
    total_steps=100,
)
SP_KEYS = ("points_raw", "points_conf", "pose_enc_raw")
GATHER_ROWS = 3


def _rel(got, want) -> float:
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)) if b.any() \
        else float(np.abs(a).max(initial=0.0))


def _seeded(model, seed):
    return tl.init_weights(model, torch.Generator().manual_seed(seed)).eval()


# --- the models and data both sides build -----------------------------------

def _point_model(seq_group=None):
    return _seeded(PointAlignedVGGT(**BACKBONE, dtype=torch.float32, seq_group=seq_group), 3)


def _sp_images():
    return torch.tensor(make_synthetic_batch(B=1, N=4, H=H, W=W, seed=7)["images"])


@functools.lru_cache(maxsize=1)
def _feature_weights():
    model = _seeded(FeatureAlignedVGGT(**TINY, dtype=torch.float32), 1)
    # a 0.02 alignment token, as tests/test_torch_train.py (the 1e-6 init
    # amplifies its gradient into fp32 noise)
    with torch.no_grad():
        model.alignment_head.per_frame_alignment_token.normal_(
            0.0, 0.02, generator=torch.Generator().manual_seed(5))
    return model


def _feature_model():
    """A fresh copy of the seeded feature-aligned model (drawing the weights
    costs seconds on the CPU; copying them does not)."""
    return copy.deepcopy(_feature_weights())


def _serve_batch():
    return {"images": make_synthetic_batch(B=1, N=8, H=H, W=W, seed=3)["images"]}


def _train_batch(B):
    """B samples whose point masks differ in size per sample (so an average
    of per-rank losses is not the global loss)."""
    batch = make_synthetic_batch(B=B, N=7, H=H, W=W, seed=11)
    batch["point_masks"][1, :, :, W // 3:] = 0.0
    return batch


def _train_case(B):
    """The B-sample batch chunked at width 4 / overlap 1: chunk 2 runs the
    frame dropout."""
    batch = _train_batch(B)
    chunks_np = chunk_batch(batch, generate_chunks(7, "chunk_overlap", 4, 1))
    merged = {k: torch.tensor(v) for k, v in merge_chunk_outputs(chunks_np, 0).items()}
    return chunks_np, merged


def _generator():
    return torch.Generator().manual_seed(0)


def _train(chunks, merged, data_group=None, steps=2):
    """loss_and_grads at step 0, then ``steps`` train steps; returns the
    losses, the gradients and the metrics of each step and the trainable
    tensors after them."""
    model = _feature_model()
    loss = MultitaskLoss(**LOSS_CFG)
    trainable = freeze_params(model, FREEZE)
    losses0, grads = loss_and_grads(model, loss, trainable, chunks, merged, 0, 1,
                                    generator=_generator(), data_group=data_group)
    opt, _ = build_optimizer(trainable, max_lr=1e-3, total_steps=100)
    state = TrainState(trainable=trainable, optimizer=opt)
    step = make_train_step(model, loss, 1, data_group=data_group)
    metrics = []
    for _ in range(steps):
        state, m = step(state, chunks, merged, _generator())
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(losses0={k: float(v) for k, v in losses0.items()},
                grads={k: v.clone() for k, v in grads.items()}, metrics=metrics,
                after={n: p.detach().clone() for n, p in trainable.items()})


class _TrainData:
    """train_data for the Trainer: the 2-sample batch every step."""

    def get_loader(self, epoch):
        yield _train_batch(2)


def _fit(root):
    """Trainer.fit, 2 steps over the 2-sample batch at a random width in
    [3, 4], logging and checkpointing under ``root``; returns the trainable
    tensors after it and the path of this process's CSV log."""
    cfg = dict(exp_name="tiny", max_steps=2, chunk_width=[3, 4], num_overlap=[1, 1],
               val_epoch_freq=1000, seed_value=42,
               logging=dict(log_dir=os.path.join(root, "logs"), log_freq=1),
               checkpoint=dict(save_dir=os.path.join(root, "ckpt"), save_freq=1),
               optim=dict(frozen_module_names=FREEZE,
                          options=dict(lr=dict(max_value=1e-3, min_value=1e-8,
                                               linear_steps=0.3))))
    trainer = Trainer(cfg, _feature_model(), MultitaskLoss(**LOSS_CFG), train_data=_TrainData())
    state = trainer.fit()
    return ({n: p.detach().clone() for n, p in state.trainable.items()},
            trainer.logger.path)


def _attention_case():
    """A qk-normed 2-D RoPE attention (the aggregator's global block) at a
    tiny width, its weights perturbed from the initialisers, and its input:
    x (1, 96, 32) over an 8 x 12 token grid (48 tokens a rank)."""
    C, h = 32, 4
    model = _seeded(tl.Attention(C, h, qk_norm=True, rope="2d"), 4)
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    x = np.random.default_rng(8).normal(size=(1, 96, C)).astype(np.float32)
    grid = patch_grid_positions(1, 8, 12, 0, "cpu")
    return model, x, grid


# --- the worker ----------------------------------------------------------------

def _worker_sp(rank, out, outdir):
    mesh = parallel.make_mesh(n_data=1, n_model=WORLD)
    group = mesh.group("model")
    model = _point_model(group)
    with torch.no_grad():
        raw = parallel.sequence_parallel_encode(model, _sp_images(), group)
        full = parallel.gather_sequence(raw, group)
    S_local = raw["points_raw"].shape[1]
    tokens = expand_frame_tokens(model.core.aggregator.camera_token, 1, S_local,
                                 rank * S_local)
    try:
        parallel.sequence_parallel_encode(model, _sp_images()[:, :3], group)
        refused = ""
    except ValueError as e:
        refused = str(e)
    out.update(local={k: v for k, v in raw.items()}, full=dict(full), tokens=tokens,
               refused=refused)


def _worker_serve(rank, out, outdir):
    mesh = parallel.make_mesh()
    model = _feature_model()
    pred, _ = ChunkedPipeline(model, encode_batch=2, mesh=mesh).run_sequence(
        _serve_batch(), chunk_width=4, num_overlap=2)
    out.update(pred=pred)
    try:
        ChunkedPipeline(model, encode_batch=3, mesh=mesh)
        out["refused"] = ""
    except ValueError as e:
        out["refused"] = str(e)


def _worker_train(rank, out, outdir):
    mesh = parallel.make_mesh()
    for B in (2, 3):
        chunks_np, merged = _train_case(B)
        if B % WORLD == 0:
            chunks_np = [parallel.shard_batch(c, mesh) for c in chunks_np]
        chunks = tuple({k: torch.tensor(v) for k, v in c.items()} for c in chunks_np)
        out[B] = _train(chunks, merged, mesh.group("data"))
    out["fit"], log = _fit(os.path.join(outdir, "fit"))
    out["logged"] = log is not None and os.path.exists(log)


def _worker_gather(rank, out, outdir):
    rows = np.arange(GATHER_ROWS + rank, dtype=np.float32) + 100.0 * rank
    out["rows"] = parallel.allgather_rows(rows)
    metric = Metrics(trajectory_metrics=[AbsoluteTrajectoryError()]).trajectory_metrics[0]
    out["hooked"] = metric._gather is parallel.allgather_rows
    out["metric_rows"] = metric._cat([rows.reshape(-1, 1)])
    out["meshes"] = {}
    for n_data, n_model in ((2, 1), (1, 2)):
        mesh = parallel.make_mesh(n_data, n_model)
        out["meshes"][(n_data, n_model)] = dict(
            coords=dict(mesh.coords),
            data=dist.get_world_size(mesh.group("data")),
            model=dist.get_world_size(mesh.group("model")),
            rows=parallel.shard_batch({"x": np.arange(4)}, mesh)["x"].tolist())
    out["node"] = parallel.node_index()
    t = torch.full((2,), float(rank))
    parallel.replicate({"t": t}, parallel.make_mesh())
    out["replicated"] = t


def _worker_layer(rank, out, outdir):
    model, x, grid = _attention_case()
    group = dist.group.WORLD
    model.seq_group = group
    n = x.shape[1] // WORLD
    cos, sin, nsplit = rope_cache_2d(grid, 8)
    sl = slice(rank * n, (rank + 1) * n)
    xl = torch.tensor(x[:, sl]).requires_grad_()
    y = model(xl, (cos[:, sl], sin[:, sl], nsplit))
    # a different function of the output on every rank: the gradient of
    # the sum over ranks reaches this rank's x through the gathered k and v
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(9 + rank))
    (y * w).sum().backward()
    out.update(y=y.detach(), dx=xl.grad)


WORKERS = {"sp": _worker_sp, "serve": _worker_serve, "train": _worker_train,
           "gather": _worker_gather, "layer": _worker_layer}


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
    argv = lambda rank, port: [sys.executable, os.path.abspath(__file__), scenario,  # noqa: E731
                               str(rank), str(port), str(WORLD), outdir]
    # both ranks on one node, as the CLI's launcher starts them
    env = parallel.clean_env({"PYTHONPATH": ROOT, "LOCAL_WORLD_SIZE": str(WORLD)})
    outs, _ = parallel.spawn_gang(argv, WORLD, timeout=300, retries=2, cwd=ROOT, env=env)
    assert all(f"worker {r}: OK" in o for r, o in enumerate(outs)), outs
    return [dict(torch.load(os.path.join(outdir, f"{scenario}_{r}.pt"), weights_only=False),
                 dir=outdir) for r in range(WORLD)]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Every scenario's gang, launched together at first use (each waits on
    its ranks, so they overlap their start-up); a scenario's fixture waits
    for its own."""
    # the output directories first: tmp_path_factory is not thread-safe
    outdirs = {name: str(tmp_path_factory.mktemp(name)) for name in WORKERS}
    with ThreadPoolExecutor(len(WORKERS)) as pool:
        futures = {name: pool.submit(_gang, outdirs[name], name) for name in WORKERS}
        yield futures
        for f in futures.values():  # every gang's outcome is read
            f.exception()


@pytest.fixture(scope="module")
def sp(gangs):
    return gangs["sp"].result()


@pytest.fixture(scope="module")
def serve(gangs):
    return gangs["serve"].result()


@pytest.fixture(scope="module")
def train(gangs):
    return gangs["train"].result()


@pytest.fixture(scope="module")
def gather(gangs):
    return gangs["gather"].result()


@pytest.fixture(scope="module")
def layer(gangs):
    return gangs["layer"].result()


def test_attention_seq_group_matches_jax_seq_axis(gangs):
    """(h) The port's Attention(seq_group) at 2 ranks against the JAX
    package's Attention(seq_axis) under shard_map on 2 of the 8 virtual CPU
    devices, the same weights and inputs, fp32. (First in the file: its JAX
    compile overlaps the gangs' runs.)"""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from torch_weights import jax_variables
    from vitslam_tpu.nn import layers as jl
    from vitslam_tpu.nn import rope as jr

    model, x, grid = _attention_case()
    jpos = jr.rope_cache_2d(jnp.asarray(grid.numpy()), 8)
    plain = jl.Attention(32, 4, qk_norm=True, rope="2d")
    variables = jax_variables(lambda r: plain.init(r, jnp.asarray(x), jpos), model)
    jm = jl.Attention(32, 4, qk_norm=True, rope="2d", seq_axis="sp")
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("sp",))
    fn = jax.shard_map(lambda v, xs, c, s: jm.apply(v, xs, (c, s, jpos[2])), mesh=mesh,
                       in_specs=(P(), P(None, "sp"), P(None, "sp"), P(None, "sp")),
                       out_specs=P(None, "sp"), check_vma=False)
    want = np.asarray(fn(variables, jnp.asarray(x), jpos[0], jpos[1]))
    got = torch.cat([out["y"] for out in gangs["layer"].result()], dim=1)
    assert _rel(got, want) <= RTOL


@pytest.fixture(scope="module")
def sp_reference():
    with torch.no_grad():
        return _point_model().encode_chunks(_sp_images())


@pytest.mark.parametrize("key", SP_KEYS)
def test_sp_encode_matches_unsharded(gangs, sp_reference, sp, key):
    """(a) Sequence-parallel encode at 2 ranks: each rank's local frames and
    the gathered outputs against the single-process encode."""
    want = sp_reference[key]
    s = want.shape[1] // WORLD
    for r, out in enumerate(sp):
        assert _rel(out["local"][key], want[:, r * s:(r + 1) * s]) <= RTOL, (key, r)
        assert torch.equal(out["full"][key], sp[0]["full"][key])
    assert _rel(sp[0]["full"][key], want) <= RTOL, key


def test_sp_first_frame_token_variant(sp):
    """(b) Only global frame 0 takes the first-frame token variant: rank 0's
    local frame 0, none of rank 1's frames."""
    param = _point_model().core.aggregator.camera_token.detach()
    first, later = param[0, :, :], param[1, :, :]
    t0, t1 = sp[0]["tokens"], sp[1]["tokens"]
    assert torch.equal(t0[0], first) and torch.equal(t0[1], later)
    assert all(torch.equal(t, later) for t in t1)


def test_sp_first_frame_token_variant_matches_jax():
    """(b) expand_frame_tokens with a frame offset against the JAX
    package's (eager jnp, no compile)."""
    import jax.numpy as jnp

    from vitslam_tpu.models.aggregator import expand_frame_tokens as jexpand

    param = np.stack([np.full((1, 4), 1.0), np.full((1, 4), 2.0)]).astype(np.float32)
    for offset in (0, 2):
        got = expand_frame_tokens(torch.tensor(param), 1, 2, offset).numpy()
        np.testing.assert_array_equal(got, np.asarray(jexpand(jnp.asarray(param), 1, 2,
                                                              frame_offset=offset)))


def test_sp_rejects_indivisible(sp):
    """(c) S % n != 0 raises, asking for the chunk to be padded."""
    for out in sp:
        assert "pad the chunk" in out["refused"], out["refused"]


@pytest.fixture(scope="module")
def serve_reference():
    want, _ = ChunkedPipeline(_feature_model(), encode_batch=2).run_sequence(
        _serve_batch(), chunk_width=4, num_overlap=2)
    return want


@pytest.mark.parametrize("key", ["pose_enc", "depth", "depth_conf", "chunk_sim3_enc",
                                 "frame_se3_enc", "memory_tokens"])
def test_chunk_parallel_serving_matches_single_process(serve_reference, serve, key):
    """(d) ChunkedPipeline(mesh) at encode_batch=2 over 2 ranks, 3 chunks
    (the tail group padded), against the single-process encode_batch=2 run;
    the ranks' predictions are identical."""
    want = serve_reference
    assert want["chunk_sim3_enc"].shape[1] == 3
    assert torch.equal(serve[0]["pred"][key], serve[1]["pred"][key]), key
    assert _rel(serve[0]["pred"][key], want[key]) <= RTOL, key


def test_chunk_parallel_serving_needs_encode_batch_multiple(serve):
    for out in serve:
        assert "multiple of the 'data' mesh axis" in out["refused"], out["refused"]


@pytest.fixture(scope="module")
def train_reference():
    ref = {}
    for B in (2, 3):
        chunks_np, merged = _train_case(B)
        chunks = tuple({k: torch.tensor(v) for k, v in c.items()} for c in chunks_np)
        ref[B] = _train(chunks, merged)
    return ref


@pytest.mark.parametrize("B", [2, 3], ids=["sharded", "replicated"])
def test_dp_objective_matches_full_batch(gangs, train_reference, train, B):
    """(e) Data-parallel steps at global batch 2 (one row a rank) and 3 (not
    divisible: every rank holds the batch) against single-process
    full-batch steps: every loss at step 0, the metrics of two steps."""
    want = train_reference[B]
    for out in train:
        got = out[B]
        for k, v in want["losses0"].items():
            assert _rel(got["losses0"][k], v) <= RTOL, (k, got["losses0"][k], v)
        for gm, wm in zip(got["metrics"], want["metrics"]):
            for k, v in wm.items():
                assert _rel(gm[k], v) <= RTOL, (k, gm[k], v)


@pytest.mark.parametrize("B", [2, 3], ids=["sharded", "replicated"])
def test_dp_gradients_match_full_batch(train_reference, train, B):
    """(e) The gradient of every trainable tensor equals the single-process
    full-batch gradient: the loss is the global batch's."""
    want = train_reference[B]["grads"]
    for out in train:
        errs = {n: _rel(g, want[n]) for n, g in out[B]["grads"].items()}
        assert set(errs) == set(want)
        assert max(errs.values()) <= RTOL, sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    assert sum(bool(g.abs().sum() > 0) for g in want.values()) > len(want) // 2


@pytest.mark.parametrize("B", [2, 3], ids=["sharded", "replicated"])
def test_dp_trainable_tensors_bit_identical_across_ranks(train_reference, train, B):
    """(e) After two steps the trainable tensors are bit-identical on both
    ranks, and match the single-process steps (ADAM_RTOL)."""
    a, b = train[0][B]["after"], train[1][B]["after"]
    assert all(torch.equal(a[n], b[n]) for n in a)
    want = train_reference[B]["after"]
    assert max(_rel(a[n], want[n]) for n in a) <= ADAM_RTOL


def test_dp_trainer_fit(train, tmp_path):
    """(e) Trainer.fit in the gang: the ranks lay out a data mesh, draw the
    same chunk widths (one node's seed), shard the batch and end with
    bit-identical trainable tensors that match a single-process fit; only
    rank 0 logs and writes checkpoints."""
    a, b = train[0]["fit"], train[1]["fit"]
    assert all(torch.equal(a[n], b[n]) for n in a)
    want, _ = _fit(str(tmp_path))
    assert max(_rel(a[n], want[n]) for n in a) <= ADAM_RTOL
    assert [out["logged"] for out in train] == [True, False]
    ckpt = os.path.join(train[0]["dir"], "fit", "ckpt")
    assert sorted(f for f in os.listdir(ckpt) if f.endswith(".ckpt")) == \
        ["tiny_step1.ckpt", "tiny_step2.ckpt"]


def test_dp_case_tells_global_from_averaged_losses(train_reference):
    """(e) The sharded case's per-sample masks differ in size, so the mean of
    the two ranks' own objectives is not the global objective: a data-
    parallel step that averaged per-rank losses would fail the tests above."""
    chunks_np, merged = _train_case(2)
    model = _feature_model()
    loss = MultitaskLoss(**LOSS_CFG)
    trainable = freeze_params(model, FREEZE)
    per_rank = []
    for r in range(WORLD):
        rows = slice(r, r + 1)
        chunks = tuple({k: torch.tensor(v[rows]) for k, v in c.items()} for c in chunks_np)
        mine = {k: v[rows] for k, v in merged.items()}
        losses, _ = loss_and_grads(model, loss, trainable, chunks, mine, 0, 1,
                                   generator=_generator())
        per_rank.append(float(losses["objective"]))
    global_obj = train_reference[2]["losses0"]["objective"]
    assert _rel(np.mean(per_rank), global_obj) > 100 * RTOL, (per_rank, global_obj)


def test_metric_gather_concatenates_in_rank_order(gather):
    """(f) Host metric states of uneven length, concatenated over the ranks
    in rank order (allgather_rows, and through the Metric hook Metrics
    installs in a gang)."""
    want = np.concatenate([np.arange(GATHER_ROWS + r, dtype=np.float32) + 100.0 * r
                           for r in range(WORLD)])
    for out in gather:
        np.testing.assert_array_equal(out["rows"], want)
        assert out["hooked"]
        np.testing.assert_array_equal(out["metric_rows"].reshape(-1), want)


def test_mesh_lays_ranks_out_as_the_jax_mesh(gather):
    """make_mesh: rank r at (r // n_model, r % n_model), one group per axis;
    shard_batch gives the data index's rows; node_index is 0 on one node;
    replicate broadcasts the first rank's values."""
    for r, out in enumerate(gather):
        m = out["meshes"]
        assert m[(2, 1)] == dict(coords={"data": r, "model": 0}, data=2, model=1,
                                 rows=[2 * r, 2 * r + 1])
        assert m[(1, 2)] == dict(coords={"data": 0, "model": r}, data=1, model=2,
                                 rows=[0, 1, 2, 3])
        assert out["node"] == 0
        assert torch.equal(out["replicated"], torch.zeros(2))


@pytest.mark.parametrize("shape", [(64, 32), (33, 32), (2, 1, 64), (2, 1, 3), (64,),
                                   (8, 3, 14, 14), (4, 2)])
def test_model_partition_spec_matches_jax(shape):
    """The tensor-parallel layout rule on the port's (out, in) weights is
    the JAX package's on its (in, out) kernels."""
    from vitslam_tpu.parallel.mesh import model_partition_spec as jspec

    jshape = shape[::-1] if len(shape) == 2 else shape
    want = tuple(jspec(np.zeros(jshape), 2))
    got = parallel.model_partition_spec(shape, 2)
    assert got == (want[::-1] if len(shape) == 2 else want)


def test_attention_seq_group_gradient_matches_single_process(layer):
    """The sequence-parallel attention's backward: the gathered k and v
    carry the sum of every rank's gradient back to this rank's x."""
    model, x, grid = _attention_case()
    cos, sin, nsplit = rope_cache_2d(grid, 8)
    xt = torch.tensor(x).requires_grad_()
    y = model(xt, (cos, sin, nsplit))
    n = x.shape[1] // WORLD
    w = torch.cat([torch.randn((1, n, 32), generator=torch.Generator().manual_seed(9 + r))
                   for r in range(WORLD)], dim=1)
    (y * w).sum().backward()
    assert _rel(torch.cat([out["y"] for out in layer], dim=1), y.detach()) <= RTOL
    assert _rel(torch.cat([out["dx"] for out in layer], dim=1), xt.grad) <= RTOL


class TestSpawnHarness:
    """The gang launcher: success, a failing worker, a retry on a fresh port
    after a rendezvous failure (the JAX package's and torch's own), and a
    failed rank ending its gang without waiting out the timeout."""

    def test_gang_success_and_failure(self, tmp_path):
        ok = tmp_path / "ok.py"
        ok.write_text("import sys; print(f'worker {sys.argv[1]}: OK')\n")
        outs, port = parallel.spawn_gang(
            lambda pid, p: parallel.python_worker_argv(str(ok), pid, p), 2, timeout=60,
            retries=1)
        assert port > 0
        for i, o in enumerate(outs):
            assert f"worker {i}: OK" in o

        bad = tmp_path / "bad.py"
        bad.write_text("import sys; print('boom'); sys.exit(3)\n")
        with pytest.raises(RuntimeError, match="boom"):
            parallel.spawn_gang(lambda pid, p: parallel.python_worker_argv(str(bad), pid, p),
                                2, timeout=60, retries=0)

    @pytest.mark.parametrize("message", [
        "print('Address already in use'); sys.exit(1)",
        # torch's TCPStore raises its rendezvous errors with a traceback
        "raise RuntimeError('DistNetworkError: The server socket has failed to listen on any "
        "local network address. port: 1, useIpv6: false, code: -98, name: EADDRINUSE')",
    ], ids=["jax", "torch"])
    def test_rendezvous_failure_retries_with_fresh_port(self, tmp_path, message):
        w = tmp_path / "flaky.py"
        marker = tmp_path / "first_port"
        w.write_text(
            "import sys, os\n"
            f"m = {str(marker)!r}\n"
            "if not os.path.exists(m):\n"
            "    open(m, 'w').write(sys.argv[2])\n"
            "if open(m).read() == sys.argv[2]:\n"
            f"    {message}\n"
            "print(f'worker {sys.argv[1]}: OK after retry')\n")
        outs, _ = parallel.spawn_gang(
            lambda pid, p: parallel.python_worker_argv(str(w), pid, p), 2, timeout=60,
            retries=2)
        assert all("OK after retry" in o for o in outs)

    def test_failed_rank_ends_the_gang(self, tmp_path, monkeypatch):
        from vitslam_tpu_torch.parallel import spawn

        monkeypatch.setattr(spawn, "GRACE_SECONDS", 1.0)
        w = tmp_path / "hang.py"
        w.write_text("import sys, time\n"
                     "if sys.argv[1] == '0':\n"
                     "    raise AssertionError('rank 0 failed')\n"
                     "time.sleep(60)\n")
        import time

        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 0 failed"):
            parallel.spawn_gang(lambda pid, p: parallel.python_worker_argv(str(w), pid, p), 2,
                                timeout=60, retries=2)
        assert time.monotonic() - t0 < 30


class TestCliLaunch:
    """The CLI's several-rank launch, without running the ranks."""

    def test_multi_node_needs_coordinator_and_process_id(self):
        from vitslam_tpu_torch import cli

        with pytest.raises(ValueError, match="--coordinator"):
            cli.main(["--config", "x", "--num_nodes", "2", "--num_devices", "2"])

    def test_launcher_starts_one_rank_per_device(self, monkeypatch):
        from vitslam_tpu_torch import cli

        seen = {}

        def fake_gang(argv_for, n, **kw):
            seen.update(n=n, argv=[argv_for(i, 1234) for i in range(n)], **kw)
            return ["done"] * n, 1234

        monkeypatch.setattr(parallel, "spawn_gang", fake_gang)
        cli.main(["--config", "x", "--device", "cpu", "--num_devices", "2"])
        assert seen["n"] == 2 and seen["retries"] == 2
        assert seen["env"]["LOCAL_WORLD_SIZE"] == "2"
        for i, argv in enumerate(seen["argv"]):
            assert argv[1:3] == ["-m", "vitslam_tpu_torch.cli"]
            assert argv[-4:] == ["--local_rank", str(i), "--coordinator", "localhost:1234"]
        seen.clear()
        cli.main(["--config", "x", "--num_nodes", "2", "--num_devices", "4",
                  "--coordinator", "host0:29500", "--process_id", "1"])
        assert seen["n"] == 4 and seen["retries"] == 0
        assert seen["argv"][3][-2:] == ["--coordinator", "host0:29500"]


if __name__ == "__main__":
    _worker_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
