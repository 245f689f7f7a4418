"""Port parity for reading the JAX package's checkpoints
(vitslam_tpu_torch/io/{flax_msgpack,from_jax,checkpoint}.py): files that
vitslam_tpu/io/checkpoint.py::save_checkpoint writes inside the test are
read by the port's msgpack reader bit for bit as flax's
``msgpack_restore`` reads them (a tiny model's variables, a tree with a
bf16 leaf, numpy scalars and an int step, and flax's chunked leaves), the
port's ``export_torch_style`` gives the JAX package's, and
``load_model_params`` fills a port model from a reference head checkpoint
over a reference, or port, fallback exactly as ``load_jax_params`` of the
exported tree does."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.serialization as fs  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_weights import jax_variables, seeded, shared_jax_cache  # noqa: E402,F401
from vitslam_tpu.io.checkpoint import save_checkpoint as jax_save  # noqa: E402
from vitslam_tpu.io.torch_convert import export_torch_style as jax_export  # noqa: E402
from vitslam_tpu.models import FeatureAlignedVGGT as JaxModel  # noqa: E402
from vitslam_tpu_torch.io import checkpoint as tckpt  # noqa: E402
from vitslam_tpu_torch.io.flax_msgpack import loads, read_flax_msgpack  # noqa: E402
from vitslam_tpu_torch.io.from_jax import export_torch_style, load_jax_params  # noqa: E402
from vitslam_tpu_torch.models import FeatureAlignedVGGT  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=4,
            patch_embed_depth=1, intermediate_layers=(0, 1, 1, 1), num_memory_tokens=4,
            align_embed_dim=64, align_dec_dim=64)


def _variables(seed: int) -> dict:
    """The JAX variable tree (numpy leaves) of the tiny model holding the
    port's weights drawn from ``seed``."""
    jmodel = JaxModel(**TINY, dtype=jnp.float32)
    init = lambda r: jmodel.init(r, jnp.zeros((1, 2, 3, 28, 42)), 1)  # noqa: E731
    model = seeded(FeatureAlignedVGGT(**TINY, dtype=torch.float32, device="cpu"), seed)
    return fs.to_state_dict(jax_variables(init, model))


@pytest.fixture(scope="module")
def trees():
    """Two weight sets of one tiny model: the head's and the base's."""
    return _variables(3), _variables(4)


def _same_tree(got, want, path=""):
    """Bit-equal trees: the port's bf16 tensors against flax's bf16 arrays."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        assert got.view(torch.uint16).numpy().tobytes() == want.view(np.uint16).tobytes(), path
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


def _mixed_tree():
    """Leaves save_checkpoint takes (it writes each as an ndarray)."""
    rng = np.random.default_rng(0)
    return {"params": {"w": rng.normal(size=(3, 50)).astype(np.float32),
                       "b16": jnp.asarray(rng.normal(size=(4, 60)), jnp.bfloat16),
                       "i": np.arange(7, dtype=np.int32), "d": rng.normal(size=(20,)),
                       "empty": np.zeros((0, 3), np.float32)},
            "scalar": np.float32(0.25), "step": 12, "flag": True}


@pytest.mark.parametrize("case", ["tiny_params", "mixed", "chunked"])
def test_reader_matches_msgpack_restore(case, trees, tmp_path, monkeypatch):
    """Bit for bit against flax.serialization.msgpack_restore on the bytes
    save_checkpoint wrote; "chunked" lowers flax's MAX_CHUNK_SIZE so that
    every leaf above 64 bytes (fp32, fp64 and bf16 alike) is written in
    chunks."""
    tree = trees[0] if case == "tiny_params" else _mixed_tree()
    if case == "chunked":
        monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    path = jax_save(str(tmp_path / "ref.ckpt"), tree)
    with open(path, "rb") as f:
        data = f.read()
    if case == "chunked":
        assert data.count(b"__msgpack_chunked_array__") == 3
    want = fs.msgpack_restore(data)
    got = read_flax_msgpack(path)
    _same_tree(got, want)
    assert tckpt.checkpoint_format(path) == "flax"
    _same_tree(tckpt.load_checkpoint(path), want)


def test_reader_reads_flax_native_types():
    """What flax's to_bytes writes for leaves that are not arrays: numpy
    scalars (ext 3, bf16 too), Python ints of every width, floats, bools,
    None, str, bytes, complex (ext 2) and lists."""
    tree = {"s32": np.float32(0.25), "s16": jnp.asarray(1.5, jnp.bfloat16)[()],
            "ints": [0, 127, 128, -1, -33, 255, 256, 65536, -70000, 2 ** 40, -2 ** 40],
            "lr": 3e-4, "flag": True, "off": False, "none": None, "name": "x" * 40,
            "long": "y" * 300, "raw": b"\x00\x01", "c": 1 - 2j,
            "nested": {str(i): i for i in range(20)}}
    data = fs.to_bytes(tree)
    _same_tree(loads(bytearray(data)), fs.msgpack_restore(data))


def test_reader_refuses_what_flax_does_not_write():
    data = fs.to_bytes({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="byte offset 0"):
        loads(bytearray(b"\xc1"))
    with pytest.raises(ValueError, match="truncated"):
        loads(bytearray(data[:-1]))
    with pytest.raises(ValueError, match="trailing bytes"):
        loads(bytearray(data + b"\x00"))
    with pytest.raises(ValueError, match="ext type 5 at byte offset 3"):
        loads(bytearray(b"\x81\xa1a\xd4\x05\x00"))
    with pytest.raises(ValueError, match="unknown dtype"):
        loads(bytearray(b"\x81\xa1a\xc7\x09\x01" + b"\x93\x90\xa4nope\xc4\x00"))


def test_export_torch_style_matches_jax(trees):
    got, want = export_torch_style(trees[0]), jax_export(trees[0])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k


def _expected(tree) -> dict:
    """name -> tensor of a port model filled by load_jax_params."""
    model = FeatureAlignedVGGT(**TINY, dtype=torch.float32, device="cpu")
    load_jax_params(model, jax_export(tree))
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _loaded(path, fallback=None, **kw) -> dict:
    model = FeatureAlignedVGGT(**TINY, dtype=torch.float32, device="cpu")
    assert tckpt.load_model_params(path, model, fallback_path=fallback, **kw) == []
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _bit_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for n in want:
        assert torch.equal(got[n], want[n]), n


def test_load_model_params_from_reference_checkpoints(trees, tmp_path, monkeypatch):
    """A head checkpoint of the reference (its AlignmentHead's variables,
    bf16, written in chunks) over the reference's whole-model fallback
    under a leading ``model`` key, then over a torch.save fallback of the
    same base weights, then a port head over the reference's fallback:
    every parameter bit-equal to load_jax_params of the tree each tier
    should give; without a fallback the head file alone fails the strict
    check."""
    head, base = trees
    head16 = {"params": {"alignment_head": jax.tree.map(
        lambda x: jnp.asarray(x, jnp.bfloat16), head["params"]["alignment_head"])}}
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 4096)
    head_path = jax_save(str(tmp_path / "head.ckpt"), head16)
    base_path = jax_save(str(tmp_path / "base.ckpt"), {"model": base})
    with open(head_path, "rb") as f:
        assert b"__msgpack_chunked_array__" in f.read()
    want_tree = {"params": dict(base["params"], alignment_head=jax.tree.map(
        lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32),
        head["params"]["alignment_head"]))}
    want = _expected(want_tree)
    _bit_equal(_loaded(head_path, base_path), want)

    port_base = str(tmp_path / "base_port.ckpt")
    tckpt.save_checkpoint(port_base, {f"model.{k}": v for k, v in _expected(base).items()})
    assert tckpt.checkpoint_format(port_base) == "torch"
    _bit_equal(_loaded(head_path, port_base), want)

    port_head = str(tmp_path / "head_port.ckpt")
    tckpt.save_checkpoint(port_head, {k: v for k, v in want.items()
                                      if k.startswith("alignment_head.")})
    _bit_equal(_loaded(port_head, base_path), want)

    target = FeatureAlignedVGGT(**TINY, dtype=torch.float32, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        tckpt.load_model_params(head_path, target)
    assert tckpt.load_model_params(base_path, target) == []  # whole model, strict
    _bit_equal({n: p.detach() for n, p in target.named_parameters()}, _expected(base))
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"\x00\x01\x02\x03")
    with pytest.raises(ValueError, match="neither"):
        tckpt.load_model_params(str(bad), target)


def test_reading_needs_no_msgpack_flax_or_jax(trees, tmp_path):
    """The reference's checkpoint read into a port model in a process
    where msgpack, flax and jax cannot be imported (the machine with the
    card has none of them)."""
    path = jax_save(str(tmp_path / "base.ckpt"), {"model": trees[1]})
    out = tmp_path / "sums.pt"
    code = ("import sys\n"
            "for m in ('msgpack', 'flax', 'jax'):\n"
            "    sys.modules[m] = None\n"
            "import torch\n"
            "from vitslam_tpu_torch.io.checkpoint import load_model_params\n"
            "from vitslam_tpu_torch.models import FeatureAlignedVGGT\n"
            f"model = FeatureAlignedVGGT(**{TINY!r}, dtype=torch.float32, device='cpu')\n"
            f"assert load_model_params({path!r}, model) == []\n"
            f"torch.save(dict(model.named_parameters()), {str(out)!r})\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    _bit_equal({n: p.detach() for n, p in torch.load(out).items()}, _expected(trees[1]))


def test_chip_smoke_writes_the_reference_format(trees, tmp_path):
    """chip_smoke.py writes the reference's format itself (the machine with
    the card has no flax): its tree of a port model and its msgpack bytes,
    read back by flax.serialization.msgpack_restore, are the JAX variable
    tree holding the same weights, bit for bit; the port reads them back."""
    import chip_smoke

    model = seeded(FeatureAlignedVGGT(**TINY, dtype=torch.float32, device="cpu"), 3)
    path = str(tmp_path / "w.ckpt")
    size = chip_smoke.write_flax_checkpoint(path, {"model": chip_smoke.flax_tree(model)})
    with open(path, "rb") as f:
        data = f.read()
    assert size == len(data)
    _same_tree(fs.msgpack_restore(data), {"model": trees[0]})
    _bit_equal(_loaded(path), {n: p.detach() for n, p in model.named_parameters()})
