"""Port parity for loading a public VGGT-1B checkpoint without JAX
(vitslam_tpu_torch/io/{safetensors,from_vggt}.py and
vitslam_tpu_torch/convert_vggt_checkpoint.py) against the JAX package's
converter (scripts/convert_vggt_checkpoint.py over
vitslam_tpu/io/torch_convert.py::import_torch_style), with the JAX tests'
independent list of the VGGT-1B keys (tests/test_converter.py):

(a) at full flagship size (on the meta device, with the track head at its
    updater depth 6) the port's rules take every key of the VGGT-1B
    surface, less the documented drops, onto distinct parameters, key for
    key as the JAX rules name them, and chip_smoke.py's inverse map gives
    each key back;
(b) the real-layout state dict of a tiny model (``_tiny_model_and_sd``'s
    construction: tests/test_converter.py's ``to_vggt_name`` and
    ``inverse_transform_value`` over the JAX package's export, with the
    port's seeded weights moved into the JAX tree by ``jax.eval_shape``,
    not a JAX init), saved as ``.pt`` and as ``.safetensors``, converted by
    the port's CLI (the ``.safetensors`` file in a child with jax, flax
    and safetensors blocked) and loaded by ``load_model_params``: every
    mapped parameter bit-equal to the JAX converter's, the parameters left
    at init the JAX converter's ``missing`` (and the port's CPU preset at
    the converter's seed);
(c) one tiny fp32 forward of the converted port model against the JAX
    converter's model;
(d) the safetensors reader: every dtype, ``__metadata__``, malformed
    headers, the safetensors package's own files;
(e) the CLI's flags: the track head kept or dropped, ``--strict``,
    unmatched keys, the point- and pose-aligned presets; the parameters
    left unfilled drawn alone, the rest of the model left on meta;
and the track head's DPT resize layers against torch's ConvTranspose2d.
"""
import contextlib
import copy
import io
import json
import shutil
import struct
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.serialization as fs  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import test_converter as jconv  # noqa: E402
from torch_weights import jax_variables, seeded, shared_jax_cache  # noqa: E402,F401
from vitslam_tpu import models as jm  # noqa: E402
from vitslam_tpu.io.torch_convert import export_torch_style as jax_export  # noqa: E402
from vitslam_tpu.io.torch_convert import import_torch_style  # noqa: E402
from vitslam_tpu_torch import convert_vggt_checkpoint as cvt  # noqa: E402
from vitslam_tpu_torch import models as tm  # noqa: E402
from vitslam_tpu_torch.io import from_vggt, load_model_params, read_safetensors  # noqa: E402
from vitslam_tpu_torch.io.from_jax import export_torch_style, load_jax_params  # noqa: E402
from vitslam_tpu_torch.io.from_jax import port_name  # noqa: E402
from vitslam_tpu_torch.io.safetensors import DTYPES, read_metadata  # noqa: E402
from vitslam_tpu_torch.models.dpt_head import StridedUpsample  # noqa: E402
from vitslam_tpu_torch.nn.layers import init_weights  # noqa: E402

torch.set_num_threads(2)

# tests/test_converter.py's tiny model (``_tiny_model_and_sd``)
TINY = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=4,
            patch_embed_depth=1, intermediate_layers=(0, 1, 1, 1), num_memory_tokens=4,
            align_embed_dim=32, align_dec_dim=16)
# the preset keywords of the tiny model's point- and pose-aligned variants,
# which have no AlignmentHead
CORE = {k: v for k, v in TINY.items() if not k.startswith(("align_", "num_memory"))}
# the same fp32 layers on both sides, summed in other orders: relative L2
# error per output of the converted models' core forward
FORWARD_RTOL = 1e-4
DROPS = jconv.EXPECTED_DROPS | jconv.TRACK_EXPECTED_DROPS


def _rel(got, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _tiny_port(seed=None, **kw):
    model = tm.FeatureAlignedVGGT(**TINY, **kw, dtype=torch.float32, device="cpu")
    return model if seed is None else seeded(model, seed)


def _convert(src, out, *args, overrides=TINY):
    """The port's CLI in this process on a tiny preset: (its summary, its
    printed lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cvt.main(["--torch-ckpt", str(src), "--out", str(out), *args], overrides) == 0
    lines = buf.getvalue().splitlines()
    return json.loads(lines[-1]), lines


def _jax_route(sd: dict, variables):
    """The JAX converter on a real-layout state dict: translate_key,
    transform_value, import_torch_style into ``variables``' tree; returns
    (its variables, its ``missing``)."""
    mapped = {}
    for k, v in sd.items():
        nk = jconv.translate_key(k)
        if nk is not None:
            mapped[nk] = jconv.transform_value(k, np.asarray(v))
    return import_torch_style(mapped, variables, strict=False)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny model's real-layout VGGT-1B state dict (no AlignmentHead,
    the documented drops added), the JAX converter's result on it, and the
    dict written as ``.pt`` (under ``state_dict`` with ``model.`` keys)
    and ``.safetensors``."""
    jmodel = jm.FeatureAlignedVGGT(**TINY, dtype=jnp.float32)
    init = lambda r: jmodel.init(r, jnp.zeros((1, 2, 3, 28, 42)), 1)  # noqa: E731
    source = _tiny_port(seed=3)
    variables = jax_variables(init, source)
    full = {jconv.to_vggt_name(k): jconv.inverse_transform_value(jconv.to_vggt_name(k), v)
            for k, v in jax_export(variables).items()}
    sd = {k: v for k, v in full.items() if not k.startswith("alignment_head.")}
    rng = np.random.default_rng(0)
    for k in sorted(jconv.EXPECTED_DROPS):  # in the real checkpoint, dropped by both
        sd[k] = rng.normal(size=(1, 32)).astype(np.float32)
    restored, missing = _jax_route(sd, variables)
    want = _tiny_port()
    load_jax_params(want, export_torch_style(fs.to_state_dict(restored)))
    d = tmp_path_factory.mktemp("vggt")
    files = {"pt": d / "model.pt", "safetensors": d / "model.safetensors"}
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    torch.save({"state_dict": {"model." + k: v for k, v in tensors.items()}}, files["pt"])
    chip_smoke.write_safetensors(str(files["safetensors"]), tensors)
    yield SimpleNamespace(jmodel=jmodel, source=source, sd=sd, full=full, restored=restored,
                           missing=missing, want=want, files=files, dir=d)
    shutil.rmtree(d)


@pytest.fixture(autouse=True)
def _drop_files(request):
    """The tiny model's files are ~0.2-0.4 GB each: a test's go when it ends."""
    path = request.getfixturevalue("tmp_path") if "tmp_path" in request.fixturenames else None
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


# ---------------------------------------------------------------------------
# (a) the key surface at full size
# ---------------------------------------------------------------------------

def test_rules_cover_the_vggt1b_surface_at_flagship_size():
    """Every key of VGGT-1B (track head at depth 6) but the documented
    drops lands on its own port parameter, as the JAX rules name it; every
    parameter outside the AlignmentHead is hit once; chip_smoke.py's
    inverse map gives the key back."""
    model = tm.flagship(device="meta", enable_track=True)
    params = dict(model.named_parameters())
    keys = jconv.expected_vggt_keys(24, 24) + jconv.expected_track_keys(depth=6)
    assert len(keys) == len(set(keys))
    hits, dropped = {}, set()
    for k in keys:
        assert from_vggt.translate_key(k) == jconv.translate_key(k), k
        flax = from_vggt.translate_key(k)
        if flax is None:
            dropped.add(k)
            continue
        name = port_name(flax)
        assert name in params, (k, name)
        assert chip_smoke.vggt_key(name) == k
        hits.setdefault(name, []).append(k)
    assert dropped == DROPS
    assert all(len(v) == 1 for v in hits.values()), [v for v in hits.values() if len(v) > 1]
    assert sorted(n for n in params if n not in hits) == \
        sorted(n for n in params if n.startswith("alignment_head."))
    # unknown keys are named by no rule, the drops by one
    for k in ("aggregator.bogus", "depth_head.scratch.bogus.weight", "track_head.bogus"):
        assert from_vggt._rule_name(k) == (False, None) and jconv.translate_key(k) is None
    assert all(from_vggt._rule_name(k) == (True, None) for k in DROPS)


def test_inverse_map_matches_the_jax_tests_at_tiny_size(tiny):
    """chip_smoke.py's port name -> upstream key and layout against
    tests/test_converter.py's ``to_vggt_name`` / ``inverse_transform_value``."""
    mine = chip_smoke.vggt_state_dict(tiny.source.named_parameters(), alignment_head=True)
    assert mine.keys() == tiny.full.keys()
    for k, v in mine.items():
        assert np.array_equal(v.numpy(), tiny.full[k]), k


# ---------------------------------------------------------------------------
# (b) bit for bit against the JAX converter
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def init0():
    """The tiny model's parameters as the port's CPU init draws them at the
    converter's default seed."""
    return dict(_tiny_port(seed=0).named_parameters())


@pytest.fixture(scope="module")
def converted(tiny):
    """Each of the tiny model's files converted with ``--no-track``: the
    ``.pt`` by the CLI in this process, the ``.safetensors`` by
    chip_smoke.py's ``run_converter`` (a child with jax, flax, safetensors
    and vitslam_tpu blocked). fmt -> (output path, summary, printed lines)."""
    out = {fmt: tiny.dir / f"{fmt}_port.ckpt" for fmt in tiny.files}
    summary, lines = _convert(tiny.files["pt"], out["pt"], "--no-track")
    child, _, child_lines = chip_smoke.run_converter(
        str(tiny.files["safetensors"]), str(out["safetensors"]), "--no-track", overrides=TINY)
    return {"pt": (out["pt"], summary, lines),
            "safetensors": (out["safetensors"], child, child_lines)}


@pytest.mark.parametrize("fmt", ["pt", "safetensors"])
def test_converter_matches_jax_bit_for_bit(tiny, init0, converted, fmt):
    out, summary, lines = converted[fmt]
    assert summary["unmatched"] == 0 and summary["dropped"] == len(jconv.EXPECTED_DROPS)
    assert summary["rss_sampled_max_bytes"] >= summary["rss_start_bytes"] > 0
    got = _tiny_port()
    assert load_model_params(str(out), got) == []  # strict, no fallback
    at_init = {port_name(m) for m in tiny.missing}
    assert at_init and all(n.startswith("alignment_head.") for n in at_init)
    assert summary["left_at_init"] == len(at_init)
    want = dict(tiny.want.named_parameters())
    for name, p in got.named_parameters():
        ref = init0[name] if name in at_init else want[name]
        assert torch.equal(p, ref), name
    assert any("left at the port's init" in line for line in lines)


def test_reader_equals_the_pt_route(tiny, converted):
    """The safetensors file reads as the .pt file loads, tensor for tensor,
    and the two conversions write the same file."""
    a = from_vggt.load_vggt_state_dict(str(tiny.files["safetensors"]))
    b = from_vggt.load_vggt_state_dict(str(tiny.files["pt"]))
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    x, y = (torch.load(converted[fmt][0], weights_only=True) for fmt in ("pt", "safetensors"))
    assert list(x) == list(y) and all(torch.equal(x[k], y[k]) for k in x)


# ---------------------------------------------------------------------------
# (c) the converted models' forward
# ---------------------------------------------------------------------------

def test_converted_forward_matches_jax(tiny, converted):
    model = _tiny_port()
    load_model_params(str(converted["pt"][0]), model)
    x = (np.arange(1 * 2 * 3 * 28 * 42, dtype=np.float32).reshape(1, 2, 3, 28, 42) % 97) / 97.0
    want = jax.jit(lambda v, x: tiny.jmodel.apply(v, x, method=lambda m, x: m.core(x)))(
        tiny.restored, jnp.asarray(x))
    with torch.no_grad():
        got = model.core(torch.from_numpy(x))
    assert got.keys() == want.keys()
    errs = {}
    for k in want:
        g, w = (got[k][-1], want[k][-1]) if isinstance(want[k], list) else (got[k], want[k])
        errs[k] = _rel(g, w)
    assert all(e <= FORWARD_RTOL for e in errs.values()), errs


# ---------------------------------------------------------------------------
# the track head: its DPT resize layers are ConvTranspose2d weights too
# ---------------------------------------------------------------------------

TRACK_KW = dict(dim_in=32, patch_size=14, features=8, stride=2, iters=1, corr_levels=2,
                corr_radius=1, hidden_size=16, updater_depth=2)


def test_track_head_matches_jax_but_its_resize_layers():
    """A tiny track head's real-layout keys through both converters: every
    weight bit-equal, but the feature extractor's resize_layers.0/1, which
    the JAX script loads with in and out channels exchanged; the port's
    equal the written ones."""
    jhead = jm.TrackHead(**TRACK_KW, dtype=jnp.float32)
    source = seeded(tm.TrackHead(**TRACK_KW, dtype=torch.float32, device="cpu"), 5)
    taps = [jnp.zeros((1, 2, 5 + 6, 32))] * 4
    init = lambda r: jhead.init(r, taps, jnp.zeros((1, 2, 3, 28, 42)), 5,  # noqa: E731
                                jnp.asarray([[[3.0, 4.0], [10.0, 6.0]]]))
    variables = jax_variables(init, source)
    sd = chip_smoke.vggt_state_dict(source.named_parameters(prefix="core.track_head"))
    mapped = {jconv.translate_key(k).replace("params.core.track_head.", "params.", 1):
              jconv.transform_value(k, v.numpy()) for k, v in sd.items()}
    restored, missing = import_torch_style(mapped, variables, strict=False)
    assert missing == []
    jax_port = seeded(tm.TrackHead(**TRACK_KW, dtype=torch.float32, device="cpu"), 6)
    load_jax_params(jax_port, export_torch_style(fs.to_state_dict(restored)))
    got = seeded(tm.TrackHead(**TRACK_KW, dtype=torch.float32, device="cpu"), 7)
    dropped, unmatched, unfilled = from_vggt.vggt_into(
        _Prefixed(got), sd, strict=True)
    assert (dropped, unmatched, unfilled) == ([], [], [])
    swapped = {f"feature_extractor.resize_layer_{i}.weight" for i in (0, 1)}
    want, theirs = dict(source.named_parameters()), dict(jax_port.named_parameters())
    for name, p in got.named_parameters():
        assert torch.equal(p, want[name]), name
        if name in swapped:
            assert torch.equal(theirs[name], p.transpose(0, 1)), name
        else:
            assert torch.equal(theirs[name], p), name


class _Prefixed(torch.nn.Module):
    """A module as the ``core.track_head`` of a whole model."""

    def __init__(self, head):
        super().__init__()
        self.core = torch.nn.Module()
        self.core.track_head = head


@pytest.mark.parametrize("head", ["depth_head", "point_head", "track_head.feature_extractor"])
def test_resize_layer_rule_matches_torch_convtranspose(head):
    """torch's ConvTranspose2d(k=s) as the oracle of every DPT head's
    resize_layers.0 rule on the port's StridedUpsample."""
    rng = torch.Generator().manual_seed(0)
    cin, cout, k = 6, 5, 4
    layer = torch.nn.ConvTranspose2d(cin, cout, k, stride=k)
    x = torch.randn(2, cin, 3, 3, generator=rng)
    mod = StridedUpsample(cin, cout, k, dtype=torch.float32)
    with torch.no_grad():
        mod.weight.copy_(from_vggt.transform_value(f"{head}.resize_layers.0.weight",
                                                   layer.weight))
        mod.bias.copy_(layer.bias)
        torch.testing.assert_close(mod(x), layer(x))


# ---------------------------------------------------------------------------
# (d) the reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16", "F64", "I64", "I32", "I8", "U8",
                                   "BOOL"])
def test_reader_reads_every_dtype(tmp_path, dtype):
    td = DTYPES[dtype]
    g = torch.Generator().manual_seed(1)
    if td.is_floating_point:
        make = lambda *s: torch.randn(s, generator=g).to(td)  # noqa: E731
    elif td == torch.bool:
        make = lambda *s: torch.randint(0, 2, s, generator=g).bool()  # noqa: E731
    else:
        make = lambda *s: torch.randint(-100 if td.is_signed else 0, 100, s,  # noqa: E731
                                        generator=g).to(td)
    tensors = {"a": make(3, 5), "scalar": make(), "empty": make(0, 4), "b": make(7)}
    path = tmp_path / "x.safetensors"
    chip_smoke.write_safetensors(str(path), tensors)
    got = read_safetensors(str(path))
    assert list(got) == list(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == td and got[k].shape == t.shape and torch.equal(got[k], t), k


def test_reader_metadata_and_the_safetensors_package(tmp_path):
    """``__metadata__`` is read apart from the tensors; files the
    safetensors package writes read equal, and it reads chip_smoke.py's."""
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(2)
    tensors = {"w": torch.randn(4, 6, generator=g), "h": torch.randn(3, generator=g).half(),
               "i": torch.arange(5)}
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.safetensors"
    bare = tmp_path / "bare.safetensors"
    meta = {"format": "pt", "note": "x"}
    assert chip_smoke.write_safetensors(str(ours), tensors, meta) == ours.stat().st_size
    chip_smoke.write_safetensors(str(bare), tensors)
    st.save_file(tensors, str(theirs), metadata={"format": "pt"})
    assert read_metadata(str(ours)) == meta
    assert read_metadata(str(theirs)) == {"format": "pt"}
    assert read_metadata(str(bare)) == {}
    for path in (ours, theirs, bare):
        got = read_safetensors(str(path))
        assert sorted(got) == sorted(tensors)
        assert all(torch.equal(got[k], tensors[k]) for k in tensors)
    for path in (ours, bare):
        back = st.load_file(str(path))
        assert all(torch.equal(back[k], tensors[k]) for k in tensors)


def _malformed(path, case):
    t = torch.arange(6, dtype=torch.float32)
    entry = lambda dt="F32", shape=(6,), offs=(0, 24): {  # noqa: E731
        "dtype": dt, "shape": list(shape), "data_offsets": list(offs)}
    if case == "short file":
        path.write_bytes(b"\x10\x00\x00")
        return
    if case == "header past the end":
        path.write_bytes(struct.pack("<Q", 1000) + b"{}")
        return
    if case == "not json":
        path.write_bytes(struct.pack("<Q", 8) + b"{nojson}")
        return
    data = t.numpy().tobytes()
    header = {"overlap": {"a": entry(), "b": entry(shape=(2,), offs=(16, 24))},
              "gap": {"a": entry(shape=(4,), offs=(0, 16)), "b": entry(shape=(1,),
                                                                      offs=(20, 24))},
              "past the end": {"a": entry(shape=(8,), offs=(0, 32))},
              "unknown dtype": {"a": entry(dt="F8_E4M3", shape=(24,))},
              "size and shape differ": {"a": entry(shape=(5,))},
              "trailing bytes": {"a": entry(shape=(5,), offs=(0, 20))}}[case]
    text = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(text)) + text + data)


@pytest.mark.parametrize("case, match", [
    ("short file", "shorter than"), ("header past the end", "runs past the end"),
    ("not json", "not JSON"), ("overlap", "overlaps"), ("gap", "leaves a gap"),
    ("past the end", "past its end"), ("unknown dtype", "unknown dtype"),
    ("size and shape differ", "bytes for shape"), ("trailing bytes", "data section")])
def test_reader_refuses_a_malformed_file(tmp_path, case, match):
    path = tmp_path / "bad.safetensors"
    _malformed(path, case)
    with pytest.raises(ValueError, match=match):
        read_safetensors(str(path))


# ---------------------------------------------------------------------------
# (e) the CLI's flags
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def with_track(tiny):
    """A tiny model with the track head (the VGGT-1B head widths) in the
    upstream layout, with its AlignmentHead (a FeatureAlignedVGGT
    checkpoint), written as ``.pt``."""
    source = _tiny_port(seed=4, enable_track=True)
    sd = chip_smoke.vggt_state_dict(source.named_parameters(), alignment_head=True)
    path = tiny.dir / "with_track.pt"
    torch.save(sd, path)
    return SimpleNamespace(source=source, sd=sd, path=path)


def _tracked(n: str) -> bool:
    return n.startswith("track_head.")


@pytest.mark.parametrize("case", ["track", "no_track", "point_aligned", "pose_aligned"])
def test_cli_models_and_track(with_track, tmp_path, case):
    """The track head's weights kept (default) or dropped (--no-track); the
    point- and pose-aligned presets take the keys of the heads they build
    and drop the rest (the depth head, the point head) and the AlignmentHead;
    every parameter bit-equal to the written model's."""
    args = {"track": [], "no_track": ["--no-track"],
            "point_aligned": ["--model", "point_aligned"],
            "pose_aligned": ["--model", "pose_aligned"]}[case]
    out = tmp_path / "out.ckpt"
    summary, _ = _convert(with_track.path, out, *args,
                          overrides=TINY if case in ("track", "no_track") else CORE)
    if case in ("track", "no_track"):
        model = _tiny_port(enable_track=case == "track")
        dropped = [k for k in with_track.sd if _tracked(k)] if case == "no_track" else []
    else:
        preset = {"point_aligned": tm.flagship_point_aligned,
                  "pose_aligned": tm.flagship_pose_aligned}[case]
        model = preset(device="meta", enable_track=True, dtype=torch.float32, **CORE)
        model.to_empty(device="cpu")
        gone = "depth_head." if case == "point_aligned" else "point_head."
        dropped = [k for k in with_track.sd if k.startswith((gone, "alignment_head."))]
    assert summary["dropped"] == len(dropped) and summary["unmatched"] == 0
    assert summary["left_at_init"] == 0
    assert load_model_params(str(out), model) == []
    want = dict(with_track.source.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(p, want[name]), name
    saved = torch.load(out, weights_only=True)
    assert any(n.startswith("core.track_head.") for n in saved) == (case != "no_track")


def test_parameters_left_unfilled_are_drawn_alone():
    """Parameters no source key fills (the camera head's, say) leave the
    meta device alone, drawn as ``init_weights`` draws their module alone
    at the converter's seed; a parent's init still reaches an unfilled
    child (the track head's flow head, zeroed by its updateformer)."""
    meta = tm.FeatureAlignedVGGT(**TINY, enable_track=True, dtype=torch.float32, device="meta")
    head = copy.deepcopy(meta.core.camera_head).to_empty(device="cpu")
    want = dict(init_weights(head, torch.Generator().manual_seed(0)).named_parameters(
        prefix="core.camera_head"))
    drawn = cvt.seeded_missing(meta, list(want), 0)
    assert drawn.keys() == want.keys() and all(torch.equal(drawn[n], want[n]) for n in want)
    flow = [f"core.track_head.tracker.updateformer.flow_head.{leaf}" for leaf in ("weight",
                                                                              "bias")]
    drawn.update(cvt.seeded_missing(meta, flow, 0))
    assert all(not drawn[n].any() for n in flow)
    assert all(p.is_meta != (n in drawn) for n, p in meta.named_parameters())


def test_cli_strict_and_unmatched_keys(with_track, tmp_path):
    """--strict passes on a file that fills every parameter, keys no rule
    names listed and not loaded; it raises naming the parameter of a
    removed key; a shape that differs raises naming its key."""
    out = tmp_path / "out.ckpt"
    summary, _ = _convert(with_track.path, out, "--strict")
    assert summary["left_at_init"] == 0
    sd = dict(with_track.sd)
    sd["aggregator.bogus"] = torch.zeros(3)
    sd["depth_head.scratch.bogus.weight"] = torch.zeros(3)
    src = tmp_path / "edited.pt"
    torch.save(sd, src)
    summary, lines = _convert(src, out, "--strict")
    assert summary["unmatched"] == 2 and summary["left_at_init"] == 0
    assert any("aggregator.bogus" in line for line in lines)
    del sd["aggregator.camera_token"]
    torch.save(sd, src)
    with pytest.raises(KeyError, match=r"core\.aggregator\.camera_token"):
        _convert(src, out, "--strict")
    sd["aggregator.camera_token"] = torch.zeros(1, 2, 9, 32)
    torch.save(sd, src)
    with pytest.raises(ValueError, match=r"aggregator\.camera_token"):
        _convert(src, out)
