"""Reading the JAX package's ``checkpoint.backend: orbax`` saves in the port
(vitslam_tpu/io/orbax_ckpt.py writes them with orbax's PyTreeCheckpointer
on tensorstore's OCDBT store, each array zarr v2 with zstd chunks):
``io/ocdbt.py`` against tensorstore, ``io/orbax_format.py::read_orbax``
against the JAX package's ``load_sharded`` (one device, two devices, two
processes), a port Trainer resumed from a JAX-written ``_latest`` link
against the msgpack route, the port's own DCP saves, and the committed
fixture (tests/data/torch_orbax/) that chip_smoke.py reads on the card.

Tolerances: none; every tensor and counter bit for bit.

The fixture is written by ``PYTHONPATH=. python tests/test_torch_orbax.py
--write-fixture`` (orbax's file names are not deterministic, so the tests
compare decoded trees, never files).
"""
import functools
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_train_state as tts  # noqa: E402
from torch_weights import jax_variables, seeded, shared_jax_cache  # noqa: E402,F401
from vitslam_tpu import train as jtrain  # noqa: E402
from vitslam_tpu.io import checkpoint as jckpt  # noqa: E402
from vitslam_tpu.io import orbax_ckpt  # noqa: E402
from vitslam_tpu.models import FeatureAlignedVGGT as JaxModel  # noqa: E402
from vitslam_tpu_torch import train as ttrain  # noqa: E402
from vitslam_tpu_torch.io import checkpoint as tckpt  # noqa: E402
from vitslam_tpu_torch.io.ocdbt import OcdbtError, OcdbtReader  # noqa: E402
from vitslam_tpu_torch.io.orbax_format import orbax_nbytes, read_orbax  # noqa: E402
from vitslam_tpu_torch.io.sharded_ckpt import ShardedCheckpointManager  # noqa: E402
from vitslam_tpu_torch.models import FeatureAlignedVGGT  # noqa: E402
from vitslam_tpu_torch.native import bindings  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_orbax")
# narrow enough that the MultiSteps(2) train state (246k elements) and the
# normals frame stay under the fixture's 2 MiB
NARROW = dict(img_size=28, patch_size=14, embed_dim=16, depth=2, num_heads=4,
              patch_embed_depth=1, intermediate_layers=[0, 1, 1, 1], num_memory_tokens=4,
              align_embed_dim=32, align_dec_dim=16, enable_depth=False, enable_point=False)
EXP = "narrow"
NORMALS = dict(seed=0, count=262144, level=1)


def _narrow_model() -> FeatureAlignedVGGT:
    model = FeatureAlignedVGGT(**NARROW, dtype=torch.float32)
    model.load_state_dict(_weights()[0])
    return model


@functools.lru_cache(maxsize=1)
def _weights():
    """The seeded narrow port model's weights, rounded to bf16 precision (as
    weights read from a bf16 release are; their zero low halves let zstd
    find matches, which also keeps the fixture small), and the JAX
    variables holding them."""
    model = seeded(FeatureAlignedVGGT(**NARROW, dtype=torch.float32), seed=3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    jm = JaxModel(**dict(NARROW, intermediate_layers=tuple(NARROW["intermediate_layers"])),
                  dtype=jnp.float32)
    images = jnp.zeros((1, 4, 3, 28, 28), jnp.float32)
    return model.state_dict(), jax_variables(lambda r: jm.init(r, images, 1), model)


@functools.lru_cache(maxsize=None)
def _jax_state(accum: int, steps: int):
    """A JAX TrainState of the narrow model after ``steps`` optax updates
    (``test_torch_train_state``'s optimizer and gradients)."""
    _, init, update = tts._optimizer(accum)
    trainable, frozen = jtrain.partition_params(_weights()[1]["params"], tts.FREEZE)
    opt_state = init(trainable)
    for i in range(steps):
        trainable, opt_state = update(tts._grads(trainable, i), opt_state, trainable)
    return jtrain.TrainState(trainable=trainable, frozen=frozen, opt_state=opt_state,
                             step=jnp.asarray(steps))


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _raw(v) -> tuple:
    """(shape, dtype name, bytes) of a leaf of either side."""
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), str(v.dtype).removeprefix("torch."), \
            v.contiguous().view(torch.int16).numpy().tobytes()
    a = np.asarray(v)
    return a.shape, str(a.dtype), a.tobytes()


def jax_leaves(tree) -> dict:
    """path ('/'-joined) -> leaf of a JAX pytree."""
    return {"/".join(_key(k) for k in kp): v
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_leaves(tree, prefix: str = "") -> dict:
    """path -> leaf of a tree read by read_orbax (empty dicts have none)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(port_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def leaf_hashes(leaves: dict) -> dict:
    out = {}
    for path, v in sorted(leaves.items()):
        shape, dtype, raw = _raw(v)
        out[path] = dict(shape=list(shape), dtype=dtype, sha256=hashlib.sha256(raw).hexdigest())
    return out


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    bad = [p for p in want if _raw(got[p]) != _raw(want[p])]
    assert not bad, bad[:5]


def _save(state, root: str) -> str:
    mgr = orbax_ckpt.ShardedCheckpointManager(root, EXP)
    mgr.save(int(state.step), state)
    return mgr.latest_link


def write_fixture(root: str = FIXTURE) -> None:
    """The committed fixture: the narrow MultiSteps(2) TrainState after 3
    micro-steps saved by the JAX package's ShardedCheckpointManager (with
    its _latest link made relative), the leaves' hashes as load_sharded
    restores them, and a zstd level-1 frame of seeded fp32 normals."""
    import zstandard

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    state = _jax_state(2, 3)
    link = _save(state, os.path.join(root, "run"))  # not ckpt/, which .gitignore lists
    target = os.path.basename(os.path.realpath(link))
    os.remove(link)
    os.symlink(os.path.join("..", target), link)
    restored = orbax_ckpt.load_sharded(os.path.realpath(link), state)
    normals = np.random.default_rng(NORMALS["seed"]).standard_normal(NORMALS["count"],
                                                                   dtype=np.float32)
    with open(os.path.join(root, "normals.zst"), "wb") as f:
        f.write(zstandard.ZstdCompressor(level=NORMALS["level"]).compress(normals.tobytes()))
    meta = dict(exp_name=EXP, step=3, accum_steps=2, model=NARROW, freeze=tts.FREEZE,
                checkpoint=f"run/{target}", link=f"run/_latest_checkpoints/{EXP}.orbax",
                normals=dict(NORMALS, sha256=hashlib.sha256(normals.tobytes()).hexdigest()),
                leaves=leaf_hashes(jax_leaves(restored)))
    with open(os.path.join(root, "fixture.json"), "w") as f:
        json.dump(meta, f, sort_keys=True, separators=(",", ":"))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """accum -> (the JAX TrainState, its orbax _latest link)."""
    root = tmp_path_factory.mktemp("orbax")
    return {accum: (s, _save(s, str(root / str(accum) / "ckpt")))
            for accum, s in ((1, _jax_state(1, 2)), (2, _jax_state(2, 3)))}


@pytest.mark.parametrize("accum", [1, 2], ids=["adamw", "multisteps"])
def test_read_orbax_equals_load_sharded(accum, saved):
    """Every leaf of read_orbax is load_sharded's, bit for bit; the empty
    optax states come back as {} as from the msgpack reader, so the train
    state reads into the same layout as through msgpack."""
    state, link = saved[accum]
    tree = read_orbax(link)
    _same(port_leaves(tree), jax_leaves(orbax_ckpt.load_sharded(os.path.realpath(link), state)))
    assert tree["opt_state"]["inner_opt_state" if accum > 1 else "0"] is not None
    assert tckpt.checkpoint_format(link) == "orbax"


def test_two_device_save_reads_the_same(saved, tmp_path):
    """A save from a two-device mesh, its arrays chunked by shard, reads as
    load_sharded restores it and as the one-device save."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    state, one = saved[2]
    mesh = Mesh(np.array(jax.devices()[:2]), ("d",))

    def put(x):
        split = x.ndim > 0 and x.shape[0] % 2 == 0
        return jax.device_put(x, NamedSharding(mesh, PartitionSpec("d") if split
                                               else PartitionSpec()))

    sharded = jax.tree.map(put, state)
    link = _save(sharded, str(tmp_path))
    kv = OcdbtReader(os.path.realpath(link))
    assert any(k.endswith("/1.0") for k in kv.keys())  # a second shard's chunk
    got = port_leaves(read_orbax(link))
    _same(got, jax_leaves(orbax_ckpt.load_sharded(os.path.realpath(link), sharded)))
    _same(got, port_leaves(read_orbax(one)))


def _run_dir(link: str) -> str:
    """The directory whose ckpt/ holds the save of ``link``."""
    return os.path.dirname(os.path.dirname(os.path.dirname(link)))


def _train_cfg(root: str, accum: int, backend: str) -> dict:
    cfg = tts._cfg(root, accum, resume=True)
    cfg["checkpoint"]["backend"] = backend
    cfg["exp_name"] = EXP
    return cfg


def _resumed(root: str, accum: int, backend: str):
    trainer = ttrain.Trainer(_train_cfg(root, accum, backend), _narrow_model(),
                             ttrain.MultitaskLoss(**tts.LOSS_CFG))
    trainer.init_state()
    return trainer


def _same_trainer(a, b):
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    oa, ob = a.state.optimizer, b.state.optimizer
    assert (oa.count, oa.mini_step, a.state.step) == (ob.count, ob.mini_step, b.state.step)
    for key in ("mu", "nu", "acc"):
        x, y = getattr(oa, key), getattr(ob, key)
        assert (x is None) == (y is None)
        assert x is None or all(torch.equal(x[n], y[n]) for n in x)


@pytest.mark.parametrize("accum", [1, 2], ids=["adamw", "multisteps"])
def test_trainer_resumes_from_a_jax_orbax_latest_link(accum, saved, tmp_path):
    """A port Trainer under checkpoint.backend orbax, resume on, whose
    save_dir / exp_name are a JAX run's, holds the tensors, moments,
    accumulated gradients, counts and step that the msgpack route gives."""
    state, link = saved[accum]
    shutil.copytree(_run_dir(link), tmp_path / "orbax", symlinks=True)
    jckpt.CheckpointManager(str(tmp_path / "msgpack" / "ckpt"), EXP).save(int(state.step), state)
    from_orbax = _resumed(str(tmp_path / "orbax"), accum, "orbax")
    assert from_orbax.state.step == int(state.step)
    _same_trainer(from_orbax, _resumed(str(tmp_path / "msgpack"), accum, "msgpack"))


def test_a_port_dcp_directory_still_resumes(saved, tmp_path):
    """The port's own sharded save (DCP) under the same names resumes as
    before: a trainer resumed from the JAX save, saved by the port and
    resumed again, holds the same state."""
    state, link = saved[2]
    shutil.copytree(_run_dir(link), tmp_path / "jax", symlinks=True)
    first = _resumed(str(tmp_path / "jax"), 2, "orbax")
    port = ttrain.Trainer(_train_cfg(str(tmp_path / "port"), 2, "orbax"), first.model,
                          ttrain.MultitaskLoss(**tts.LOSS_CFG))
    port.state = first.state
    path = port.ckpt.save(7, port.sharded_state_dict())
    assert tckpt.checkpoint_format(path) == "dcp"
    again = _resumed(str(tmp_path / "port"), 2, "orbax")
    assert again.state.step == first.state.step
    _same_trainer(again, first)


def test_sharded_manager_refuses_a_jax_orbax_directory(saved, tmp_path):
    """ShardedCheckpointManager.restore loads DCP directories only: a JAX
    orbax resume target raises, naming Trainer.restore, and leaves the
    template as it was."""
    _, link = saved[2]
    shutil.copytree(_run_dir(link), tmp_path / "jax", symlinks=True)
    mgr = ShardedCheckpointManager(str(tmp_path / "jax" / "ckpt"), EXP)
    template = {"step": 0}
    with pytest.raises(ValueError, match="Trainer.restore"):
        mgr.restore(template)
    assert template == {"step": 0}


def test_committed_fixture_matches_the_jax_restore():
    """The committed fixture: its leaves' hashes are rebuilt from the JAX
    package's restore and from read_orbax, through the relative _latest
    link; its normals frame decodes bit-equal to the regenerated draw; it
    stays under 2 MiB."""
    with open(os.path.join(FIXTURE, "fixture.json")) as f:
        meta = json.load(f)
    link = os.path.join(FIXTURE, meta["link"])
    assert os.path.islink(link) and not os.path.isabs(os.readlink(link))
    template = _jax_state(meta["accum_steps"], meta["step"])
    restored = orbax_ckpt.load_sharded(os.path.realpath(link), template)
    assert leaf_hashes(jax_leaves(restored)) == meta["leaves"]
    assert leaf_hashes(port_leaves(read_orbax(link))) == meta["leaves"]
    n = meta["normals"]
    want = np.random.default_rng(n["seed"]).standard_normal(n["count"], dtype=np.float32)
    got = np.empty(n["count"], np.float32)
    with open(os.path.join(FIXTURE, "normals.zst"), "rb") as f:
        bindings.zstd_decompress_into(f.read(), got.view(np.uint8))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    size = sum(os.path.getsize(os.path.join(d, x)) for d, _, xs in os.walk(FIXTURE) for x in xs)
    assert size <= 2 * 2 ** 20, size


def test_dtypes_chunks_and_scalars(tmp_path):
    """Every dtype the reader takes, a chunked array with padded edge
    chunks, 0-d arrays, numpy scalars and skipped leaves, each as orbax's
    own restore gives it (bf16 as a torch.bfloat16 tensor)."""
    import orbax.checkpoint as ocp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    rng = np.random.default_rng(0)
    mesh = Mesh(np.array(jax.devices()[:2]), ("d",))
    tree = {
        "f4": rng.standard_normal((3, 5)).astype(np.float32),
        "f2": rng.standard_normal(7).astype(np.float16),
        "i4": rng.integers(-9, 9, (2, 2)).astype(np.int32),
        "i8": rng.integers(-9, 9, 3).astype(np.int64),
        "u1": rng.integers(0, 255, 4).astype(np.uint8),
        "b1": rng.random(5) > 0.5,
        "bf16": jnp.asarray(rng.standard_normal((6, 4)), jnp.bfloat16),
        "split": jax.device_put(jnp.arange(30, dtype=jnp.float32).reshape(10, 3),
                                NamedSharding(mesh, PartitionSpec("d"))),
        "zero_d": jnp.asarray(2.5, jnp.float32),
        "scalar": np.int32(7),
        "seq": [np.ones(2, np.float32), {"deep": np.zeros((1, 1), np.float32)}],
        "none": None,
        "empty": (),
    }
    ocp.PyTreeCheckpointer().save(str(tmp_path / "ck"), tree)
    back = ocp.PyTreeCheckpointer().restore(str(tmp_path / "ck"))
    got = read_orbax(str(tmp_path / "ck"))
    assert got["none"] == {} and got["empty"] == {} and isinstance(got["bf16"], torch.Tensor)
    assert got["bf16"].dtype == torch.bfloat16 and sorted(got["seq"]) == ["0", "1"]
    _same(port_leaves(got), jax_leaves(back))


@pytest.mark.parametrize("config", [
    {"max_decoded_node_bytes": 512, "max_inline_value_bytes": 64},
    {"compression": None, "max_inline_value_bytes": 0},
    {"version_tree_arity_log2": 1},
], ids=["three-level-tree", "uncompressed", "versions-in-nodes"])
def test_ocdbt_reader_equals_tensorstore(config, tmp_path):
    """Keys and values of the newest version, through interior nodes,
    indirect values in shared data files, uncompressed nodes and a version
    tree whose older versions moved into nodes, over several commits, as
    tensorstore reads them."""
    ts = pytest.importorskip("tensorstore")
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/", "config": config}
    kv = ts.KvStore.open(spec).result()
    rng = np.random.default_rng(1)
    for commit in range(5):
        txn = ts.Transaction()
        for i in range(commit * 60, commit * 60 + 60):
            key = f"k{i % 170:04d}/{'x' * (i % 5)}"
            kv.with_transaction(txn)[key] = rng.integers(0, 256, int(rng.integers(0, 300)),
                                                         np.uint8).tobytes()
        txn.commit_async().result()
    kv.delete_range(ts.KvStore.KeyRange("k0100", "k0110")).result()
    reader = OcdbtReader(str(tmp_path))
    want = {k.decode(): kv.read(k).result().value for k in kv.list().result()}
    assert dict(reader.items()) == want and reader.keys() == sorted(want)
    with pytest.raises(KeyError):
        reader.read("k0105/")


def test_corrupt_stores_raise(saved, tmp_path):
    """A node or manifest that fails its CRC-32C, and an array whose zarr
    metadata asks for what the reader does not take, raise naming it."""
    _, link = saved[1]
    ck = tmp_path / "ck"
    shutil.copytree(os.path.realpath(link), ck)
    node = next(p for p in (ck / "d").iterdir())
    raw = bytearray(node.read_bytes())
    raw[len(raw) // 2] ^= 4
    node.write_bytes(bytes(raw))
    with pytest.raises(OcdbtError, match="CRC-32C"):
        read_orbax(str(ck))
    ts = pytest.importorskip("tensorstore")
    bad = tmp_path / "bad"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{bad}/"}).result()
    kv["w/.zarray"] = json.dumps(dict(zarr_format=2, shape=[2], chunks=[2], dtype="<f4",
                                      compressor={"id": "blosc"}, fill_value=None,
                                      filters=None, order="C")).encode()
    (bad / "_METADATA").write_text(json.dumps({"tree_metadata": {"('w',)": {
        "key_metadata": [{"key": "w", "key_type": 2}],
        "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}},
        "use_ocdbt": True, "use_zarr3": False}))
    with pytest.raises(ValueError, match="'w'.*blosc"):
        read_orbax(str(bad))


def test_no_native_decoder_raises_naming_the_reason(saved, monkeypatch, tmp_path):
    """VITSLAM_NATIVE=0, or no g++ to build the decoder, makes an orbax
    read raise NativeUnavailable naming the reason; nothing falls back."""
    _, link = saved[1]
    monkeypatch.setenv("VITSLAM_NATIVE", "0")
    with pytest.raises(bindings.NativeUnavailable, match="VITSLAM_NATIVE=0"):
        read_orbax(link)
    monkeypatch.delenv("VITSLAM_NATIVE")
    monkeypatch.setattr(bindings, "_libs", {})
    monkeypatch.setattr(bindings, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(bindings.NativeUnavailable, match="g\\+\\+ is not on PATH"):
        read_orbax(link)


# one of two JAX processes saving one tree: an array split over the
# processes (chunks large enough to be stored apart from the nodes), a
# replicated one and a scalar; run as python -c with argv pid, port, out
MP_WORKER = """
import sys
import jax
import numpy as np
pid, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(coordinator_address=f"localhost:{port}", num_processes=2,
                           process_id=pid)
import orbax.checkpoint as ocp
from jax.sharding import Mesh, NamedSharding, PartitionSpec
rng = np.random.default_rng(4)
full, rep = rng.standard_normal((64, 48), np.float32), rng.standard_normal(700, np.float32)
mesh = Mesh(np.array(jax.devices()), ("d",))
tree = {"w": jax.make_array_from_callback(full.shape, NamedSharding(mesh, PartitionSpec("d")),
                                          lambda i: full[i]),
        "r": jax.make_array_from_callback(rep.shape, NamedSharding(mesh, PartitionSpec()),
                                          lambda i: rep[i]),
        "s": np.int32(3)}
ocp.PyTreeCheckpointer().save(out, tree)
jax.distributed.shutdown()
"""


def test_two_process_save_reads_through_the_root(tmp_path):
    """Two JAX processes (jax.distributed on the CPU) save one tree: the
    root's nodes reference the values the processes wrote under
    ocdbt.process_<i>/, and read_orbax, following the root, gives the whole
    arrays."""
    from vitslam_tpu_torch.parallel.spawn import free_port

    port, out = free_port(), str(tmp_path / "ck")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, "-c", MP_WORKER, str(i), str(port), out],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for i in range(2)]
    logs = [p.communicate(timeout=120)[0].decode(errors="replace") for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-2000:] for log in logs)
    kv = OcdbtReader(out)
    refs = [v for v in kv._entries().values() if not isinstance(v, bytes)]
    assert {r[0].split("/")[0] for r in refs} == {"ocdbt.process_0", "ocdbt.process_1"}
    rng = np.random.default_rng(4)
    full, rep = rng.standard_normal((64, 48), np.float32), rng.standard_normal(700, np.float32)
    got = read_orbax(out)
    assert np.array_equal(got["w"], full) and np.array_equal(got["r"], rep)
    assert int(got["s"]) == 3


# one read in a fresh process that imports the port only: wall seconds and
# the peak resident set above the process's after its imports
READ_ONE = """
import json, sys, time
from vitslam_tpu_torch.io.checkpoint import load_checkpoint
from vitslam_tpu_torch.io.orbax_format import read_orbax
from vitslam_tpu_torch.native import bindings
def hwm_mb():  # VmHWM: a fork's ru_maxrss would carry the parent's peak over exec
    return next(int(l.split()[1]) for l in open('/proc/self/status')
                if l.startswith('VmHWM')) / 1024
bindings._zstd()
base = hwm_mb()
t0 = time.perf_counter()
(read_orbax if sys.argv[1] == 'read_orbax' else load_checkpoint)(sys.argv[2])
s = time.perf_counter() - t0
print(json.dumps(dict(s=s, base_rss_mb=base, peak_rss_mb=hwm_mb(), extra_rss_mb=hwm_mb() - base)))
"""


def time_reads(root: str, repeats: int = 3) -> dict:
    """The TINY MultiSteps(2) train state of test_torch_train_state.py
    (136.5M fp32 elements) saved by the JAX package in both formats under
    ``root``, then read by the port, each read in a fresh process:
    ``read_orbax`` and ``load_checkpoint`` of the orbax directory against
    ``load_checkpoint`` of the msgpack file, with seconds, MB/s of fp32
    state and peak RSS, beside the zstd decoder's rate on the 1 MiB normals
    frame. The files are read from the page cache (just written)."""
    state = tts._jax_state(2, 3)
    nbytes = sum(np.asarray(x).nbytes for x in jax.tree.leaves(state))
    mgr = orbax_ckpt.ShardedCheckpointManager(os.path.join(root, "orbax"), "tiny")
    mgr.save(3, state)
    msgpack = jckpt.save_checkpoint(os.path.join(root, "tiny.ckpt"), state)
    del state
    with open(os.path.join(FIXTURE, "normals.zst"), "rb") as f:
        frame = f.read()
    out = np.empty(NORMALS["count"], np.float32)
    bindings.zstd_decompress_into(frame, out.view(np.uint8))
    times = []
    for _ in range(25):
        t0 = time.perf_counter()
        bindings.zstd_decompress_into(frame, out.view(np.uint8))
        times.append(time.perf_counter() - t0)
    env = dict(os.environ, PYTHONPATH=ROOT)
    runs = {}
    for name, fn, path in (("orbax read_orbax", "read_orbax", mgr.latest_link),
                           ("orbax load_checkpoint", "load_checkpoint", mgr.latest_link),
                           ("msgpack load_checkpoint", "load_checkpoint", msgpack)):
        got = [json.loads(subprocess.run([sys.executable, "-c", READ_ONE, fn, path], env=env,
                                         check=True, capture_output=True, text=True).stdout)
               for _ in range(repeats)]
        runs[name] = dict(s=[g["s"] for g in got], mb_per_s=[nbytes / 1e6 / g["s"] for g in got],
                          extra_rss_mb=[g["extra_rss_mb"] for g in got])
    return dict(state_bytes=nbytes, orbax_bytes=orbax_nbytes(mgr.latest_link),
                msgpack_bytes=os.path.getsize(msgpack),
                zstd_normals_mb_per_s=out.nbytes / 1e6 / sorted(times)[len(times) // 2],
                cpu_count=os.cpu_count(), reads=runs)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["--write-fixture"]:
        write_fixture()
    elif sys.argv[1:2] == ["--time-reads"] and len(sys.argv) == 3:
        print(json.dumps(time_reads(sys.argv[2]), indent=1))
    else:
        raise SystemExit("usage: test_torch_orbax.py --write-fixture | --time-reads DIR")
