"""CPU checks of what surrounds the Hopper K4 (flash backward) and K5 (fused
block tail) kernels, which run only on the card: K5's launch schedule
(``ops.mlp_tail.k5_schedule``, the mirror of ``csrc/mlp_tail.cu``'s choice)
at every M the port routes through K5, with its refusals; K4's tensor maps
for the folded q and for the strided dO views autograd hands over; the ctypes bindings of every kernel
library against the C signatures in ``csrc/``; and the profiler's kernel
families (``profile_slice``)."""
import ctypes
import importlib
import re

import pytest

torch = pytest.importorskip("torch")

from vitslam_tpu_torch.ops import cuda_build  # noqa: E402
from vitslam_tpu_torch.ops.mlp_tail import KERNEL_MAX_SMEM, k5_schedule  # noqa: E402

H100_SMS = 132
from vitslam_tpu_torch.profile_slice import _family, kernel_families  # noqa: E402

fa = importlib.import_module("vitslam_tpu_torch.ops.flash_attention")


# ---- K5: the launch schedule ----

@pytest.mark.parametrize("ln", [False, True])
def test_k5_schedule_fills_the_card_at_5_1(ln):
    """M = 5 x 412 (a 5/1 chunk), C 1,024: 64 x 256 tiles, 33 x 4 = 132
    CTAs, one wave on the H100's 132 SMs; with the LayerNorm a cluster of 4
    CTAs spans a row."""
    for F, gelu in ((4096, True), (1024, False)):  # the mlp and proj sites
        sched = k5_schedule(2060, F, 1024, gelu, ln, H100_SMS)
        assert sched["tile"] == (64, 256) and sched["grid"] == (33, 4)
        assert sched["ctas"] == 132 and sched["waves"] == 1
        # a consumer, a producer and (with the gelu) a gelu warpgroup
        assert sched["threads"] == (384 if gelu else 256) and sched["stages"] == 5
        assert sched["cluster"] == (4 if ln else 1)
        assert sched["smem_bytes"] <= KERNEL_MAX_SMEM


@pytest.mark.parametrize("ln", [False, True])
def test_k5_schedule_at_75_30(ln):
    """M = 75 x 412: 128 x 256 tiles (two consumer warpgroups sharing the W
    slices), 242 x 4 = 968 CTAs in 8 waves of one CTA per SM."""
    sched = k5_schedule(30900, 4096, 1024, not ln, ln, H100_SMS)
    assert sched["tile"] == (128, 256) and sched["grid"] == (242, 4)
    assert sched["ctas"] == 968 and sched["waves"] == 8
    assert sched["threads"] == 384 and sched["stages"] == 4
    assert sched["cluster"] == (4 if ln else 1)
    assert sched["smem_bytes"] <= KERNEL_MAX_SMEM


@pytest.mark.parametrize("M,row_tiles", [(1, 1), (63, 1), (64, 1), (65, 2), (4224, 66),
                                         (4225, 34)])
def test_k5_schedule_rows(M, row_tiles):
    """Ragged M rounds up to whole tiles; 64-row tiles while they need at
    most two waves (4,224 rows x 4 column tiles = 264 CTAs), 128-row tiles
    beyond."""
    assert k5_schedule(M, 64, 1024, True, False, H100_SMS)["grid"] == (row_tiles, 4)


def test_k5_schedule_refusals():
    """What is left to refuse: a LayerNorm over more than 16 CTAs of 256
    columns (C above 4,096), no rows, an empty width. The widths refused
    before (F not a multiple of 64, C not of 256, C 2,304 with the
    LayerNorm) are scheduled (test_k5_schedule_at_any_width)."""
    with pytest.raises(ValueError, match="C <= 4096, got C 4104"):
        k5_schedule(100, 64, 4104, False, True, H100_SMS)
    with pytest.raises(ValueError, match="at least one row"):
        k5_schedule(0, 64, 256, False, False, H100_SMS)
    with pytest.raises(ValueError, match="at least one row"):
        k5_schedule(10, 0, 256, False, False, H100_SMS)
    # no LayerNorm: no cluster, whatever the width
    assert k5_schedule(100, 64, 8192, False, False, H100_SMS)["cluster"] == 1


@pytest.mark.parametrize("M,F,C,ln,grid,cluster,k_slices,padded", [
    (300, 256, 64, False, (5, 1), 1, 4, (256, 64)),          # one clipped column tile
    (1305, 384, 384, True, (21, 2), 2, 6, (384, 384)),       # the small preset's proj site
    (1305, 1536, 384, False, (21, 2), 1, 24, (1536, 384)),   # its mlp site: all 24 slices
    (256, 1024, 4096, True, (4, 16), 16, 16, (1024, 4096)),  # a non-portable cluster of 16
    (100, 200, 100, True, (2, 1), 1, 4, (200, 104)),         # C zero-padded to 104
    (70, 12, 1000, True, (2, 4), 4, 1, (16, 1000)),          # F below one slice, padded
])
def test_k5_schedule_at_any_width(M, F, C, ln, grid, cluster, k_slices, padded):
    """Widths that are not multiples of the tiles: the last column tile is
    clipped at C, the last K slice zero-filled past F (so F 1,536 takes 24
    slices, where the reference's kernel sums 16), widths that are not
    multiples of 8 padded first, and with the LayerNorm one CTA of the
    cluster per 256 columns."""
    sched = k5_schedule(M, F, C, False, ln, H100_SMS)
    assert (sched["grid"], sched["cluster"]) == (grid, cluster)
    assert (sched["k_slices"], sched["padded"]) == (k_slices, padded)
    assert sched["smem_bytes"] <= KERNEL_MAX_SMEM


# ---- K4: tensor maps ----

def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("dh,rows", [(128, 64), (64, 128)])
def test_k4_query_maps(dh, rows):
    """The folded q (contiguous scratch) and dO stream in tiles of
    bwd_query_tile(D) rows; K and V keep the 128-row boxes."""
    assert fa.bwd_query_tile(dh) == rows
    B, H, N = 1, 8, 10738
    qs = _bf16(B, H, N, dh)
    geo = fa.tma_geometry(qs, fa.bwd_query_tile(dh))
    assert geo["box"] == (64, rows, 1, 1)
    # B 1: the batch dim takes the row stride
    assert geo["strides"] == (dh * 2, N * dh * 2, dh * 2)
    k = _bf16(B, N, H, dh).transpose(1, 2)  # the head's (B, H, N, D) view of (B, N, H, D)
    assert fa.tma_geometry(k)["box"] == (64, 128, 1, 1)


def _wrapper_keeps(dout: torch.Tensor) -> bool:
    """flash_attention_backward's rule for the dO it passes on as it is."""
    return not (dout.stride(-1) != 1 or dout.data_ptr() % 16
                or any(s % 8 for s in dout.stride()[:3]))


@pytest.mark.parametrize("make", [
    lambda: _bf16(1, 1100, 8, 128).transpose(1, 2),           # the forward output's layout
    lambda: _bf16(1, 8, 1100, 128),                            # contiguous
    lambda: _bf16(2, 1100, 3 * 4 * 64)[..., :256].reshape(2, 1100, 4, 64).transpose(1, 2),
    lambda: _bf16(1, 8, 128, 1100).transpose(-1, -2),          # strided head dim
    lambda: _bf16(1, 900, 8 * 128 + 4)[..., :1024].reshape(1, 900, 8, 128).transpose(1, 2),
])
def test_k4_dout_layouts(make):
    """Every dO layout the wrapper passes on unchanged is one TMA takes at
    K4's query tile; the others it copies to contiguous first."""
    dout = make()
    if _wrapper_keeps(dout):
        assert fa.tma_geometry(dout, fa.bwd_query_tile(dout.shape[-1]))["dims"][0] == \
            dout.shape[-1]
    else:
        with pytest.raises(ValueError):
            fa.tma_geometry(dout, fa.bwd_query_tile(dout.shape[-1]))
        assert fa.tma_geometry(dout.contiguous())["dims"][1] == dout.shape[2]


@pytest.mark.parametrize("nq,padded", [(1, 128), (128, 128), (129, 256), (2060, 2176),
                                       (10738, 10752)])
def test_k4_padded_rows(nq, padded):
    assert fa.bwd_padded_rows(nq) == padded


def test_k4_cpu_runs_the_plain_version():
    """On CPU tensors the wrapper is the plain version, and counts nothing."""
    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn(1, 2, 33, 64, generator=g) for _ in range(4))
    out, lse = fa.flash_attention_plain(q, k, v, with_lse=True)
    before = fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(q, k, v, out, lse, dout)
    want = fa.flash_attention_backward_plain(q, k, v, out, lse, dout)
    assert fa.flash_attention_backward.launches == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ---- the ctypes bindings against the C signatures ----

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float, "long long": ctypes.c_longlong}


def _c_signature(source: str, fn: str) -> list:
    m = re.search(r'extern "C" int ' + fn + r"\((.*?)\)\s*\{", source, re.S)
    assert m, fn
    types = []
    for param in m.group(1).split(","):
        decl = " ".join(param.split())
        ctype = re.sub(r"\s*\w+$", "", decl).replace(" *", "*")
        types.append(_C_TYPES[ctype])
    return types


@pytest.mark.parametrize("name", sorted(cuda_build.ENTRY_POINTS))
def test_ctypes_argtypes_match_the_c_entry_points(name):
    """A pointer bound as an int would be cut to 32 bits: every entry
    point's argtypes are its C parameters, in order."""
    source = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
    for fn, argtypes in cuda_build.ENTRY_POINTS[name].items():
        assert _c_signature(source, fn) == argtypes, fn


# ---- the profiler's kernel families (repair of M1) ----

MUL_NOCAST = ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<"
              "at::native::BinaryFunctor<float, float, float, at::native::binary_internal::"
              "MulFunctor<float> > >(at::TensorIteratorBase&, at::native::BinaryFunctor<float, "
              "float, float, at::native::binary_internal::MulFunctor<float> > const&)::"
              "{lambda(int)#1}>(int, at::native::gpu_kernel_impl_nocast<at::native::"
              "BinaryFunctor<float, float, float, at::native::binary_internal::MulFunctor<float>"
              " > >(at::TensorIteratorBase&, at::native::BinaryFunctor<float, float, float, "
              "at::native::binary_internal::MulFunctor<float> > const&)::{lambda(int)#1})")
CAST = ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda("
        "at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()() "
        "const::{lambda(float)#1}, std::array<char*, 2ul>, 4, TrivialOffsetCalculator<1, unsigned "
        "int>, TrivialOffsetCalculator<1, unsigned int>, at::native::memory::LoadWithCast<1>, "
        "at::native::memory::StoreWithCast<1> >(int, at::native::direct_copy_kernel_cuda("
        "at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()() "
        "const::{lambda(float)#1}, std::array<char*, 2ul>, TrivialOffsetCalculator<1, unsigned "
        "int>, TrivialOffsetCalculator<1, unsigned int>, at::native::memory::LoadWithCast<1>, "
        "at::native::memory::StoreWithCast<1>)")


@pytest.mark.parametrize("name,family", [
    (MUL_NOCAST, "elementwise"),
    (CAST, "copy / cast"),
    ("nvjet_tst_256x64_64x5_2x1_v_bz_TNT", "gemm (cuBLAS)"),
    ("Memset (Device)", "copy / cast"),
    ("void (anonymous namespace)::flash_bwd_kernel<128>((anonymous namespace)::BwdParams)",
     "K4 flash backward (prep, main, dq)"),
    ("void (anonymous namespace)::flash_bwd_prep_kernel<64>((anonymous namespace)::PrepParams)",
     "K4 flash backward (prep, main, dq)"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<128>((anonymous namespace)::DqParams)",
     "K4 flash backward (prep, main, dq)"),
    ("void (anonymous namespace)::mlp_tail_kernel<1, true, false>((anonymous namespace)::"
     "TailParams)", "K5 mlp_tail"),
    ("void (anonymous namespace)::flash_attention_kernel<64, true>(vitslam::sm90::FwdParams)",
     "K2/K3 flash_attention"),
])
def test_profile_families_by_name(name, family):
    assert _family(name) == family


def test_profile_families_by_launching_op():
    """With the trace's link from kernel to aten op, a strided elementwise
    loop counts as a copy only under a copy op, and a reduction by its op."""
    assert _family(MUL_NOCAST, "aten::copy_") == "copy / cast"
    assert _family(MUL_NOCAST, "aten::mul") == "elementwise"
    assert _family("void at::native::reduce_kernel<512, 1>", "aten::mean") == \
        "reduction (mean/norm)"
    assert _family(CAST, "aten::add") == "elementwise"
    assert _family("nvjet_tst_256x64_64x5_2x1_v_bz_TNT", "aten::mm") == "gemm (cuBLAS)"


def test_kernel_families_from_a_trace():
    """kernel_families joins kernel events to their cpu_op by External id."""
    events = [
        {"cat": "cpu_op", "name": "aten::mul", "args": {"External id": 7}},
        {"cat": "cpu_op", "name": "aten::copy_", "args": {"External id": 8}},
        {"cat": "kernel", "name": MUL_NOCAST, "dur": 30.0, "args": {"External id": 7}},
        {"cat": "kernel", "name": MUL_NOCAST, "dur": 10.0, "args": {"External id": 8}},
        {"cat": "kernel", "name": "nvjet_tst_x", "dur": 5.0, "args": {"External id": 9}},
    ]
    fam, by_name, kernels = kernel_families(events)
    assert len(kernels) == 3
    assert fam["elementwise"] == pytest.approx(30e-6)
    assert fam["copy / cast"] == pytest.approx(10e-6)
    assert fam["gemm (cuBLAS)"] == pytest.approx(5e-6)
